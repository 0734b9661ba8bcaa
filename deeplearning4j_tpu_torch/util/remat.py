"""Backward rematerialization for the containers' differentiated loss.

Counterpart of deeplearning4j_tpu/util/remat.py: ``check_remat_mode`` (the
same modes and message) and ``remat_loss``, which wraps the loss in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` where the
JAX package wraps it in ``jax.checkpoint``: the forward keeps none of its
activations, and the backward runs the forward again to rebuild them
(for the LSTM kernels: the training forward launches a second time, in
the backward, and K3 reads its reserve).

The recompute must draw the forward's random numbers. The network's draws
come from its own ``torch.Generator`` (``exec.executor.
network_generator``), whose state ``torch.utils.checkpoint`` does not
save or restore (it handles the default CPU and CUDA generators only), and
inside a captured CUDA graph a generator's state cannot be read or set at
all. So the wrapped loss hands the forward a ``nn.dropout.SameDraws`` over
the generator: the forward draws through it and keeps its draws, the
recompute replays them in order. The gradient is then the one without
remat, on the CPU and inside a captured graph alike; the kept draws are
the memory remat does not save.

The recompute must not write layer state a second time: the loss takes
the state to write as the keyword ``state``, and the recompute gets None
(BatchNormalization's train-mode output reads batch statistics only, so
it is the same).

``'save_convs'`` and ``'selective'`` keep the outputs the JAX package
tags ``conv_out`` (a convolution layer's, before its bias and
activation) and recompute the rest: a selective checkpoint whose policy
saves every ``aten.convolution`` result. The port's convolution layers
add their bias inside the call, so the saved tensor is the output with
its bias, which the backward needs all the same.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deeplearning4j_tpu_torch.nn.dropout import SameDraws

_MODES = (False, True, "full", "save_convs", "selective")


def check_remat_mode(mode):
    """Fail fast on an invalid mode (the builder calls this, so a typo
    surfaces at configuration time, not at the first train step)."""
    if mode not in _MODES:
        raise ValueError(
            f"unknown remat mode {mode!r} "
            "(False | True | 'full' | 'save_convs' | 'selective')")
    return mode


def _save_convs(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.aten.convolution.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_loss(loss_fn, mode):
    """``loss_fn`` wrapped per the configured remat ``mode``: False ->
    unchanged; 'save_convs' / 'selective' -> rematerialized but for the
    convolutions' outputs; any other mode -> rematerialized whole.
    ``loss_fn`` takes its generator as the keyword ``gen`` and the layer
    state it writes as ``state``."""
    if not check_remat_mode(mode):
        return loss_fn
    extra = {}
    if mode in ("save_convs", "selective"):
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_convs)

    def rematerialized(*args, gen=None, state=None, **kw):
        draws = None if gen is None else SameDraws(gen)
        calls = []

        def run(*a):
            if calls and draws is not None:
                draws.replay()           # the recompute: the same draws
            st = None if calls else state    # written once, not again
            calls.append(1)
            return loss_fn(*a, gen=draws, state=st, **kw)

        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra)

    return rematerialized
