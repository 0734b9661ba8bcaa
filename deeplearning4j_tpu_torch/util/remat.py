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

``'save_convs'`` and ``'selective'`` save only the outputs the JAX package
tags ``conv_out``. The port has no convolution layer yet, so nothing is
tagged and they recompute everything, as ``True`` / ``'full'`` do.
"""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

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


def remat_loss(loss_fn, mode):
    """``loss_fn`` wrapped per the configured remat ``mode``: False ->
    unchanged; any other mode -> rematerialized. ``loss_fn`` takes its
    generator as the keyword ``gen``."""
    if not check_remat_mode(mode):
        return loss_fn

    def rematerialized(*args, gen=None, **kw):
        draws = None if gen is None else SameDraws(gen)
        calls = []

        def run(*a):
            if calls and draws is not None:
                draws.replay()           # the recompute: the same draws
            calls.append(1)
            return loss_fn(*a, gen=draws, **kw)

        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return rematerialized
