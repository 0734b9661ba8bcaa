"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis.

Counterpart of deeplearning4j_tpu/parallel/pipeline.py:
``stack_stage_params``, ``shard_stages``, ``pipeline_forward``,
``split_microbatches`` and ``PipelineParallel`` (``fit_batch``,
``forward``), with the JAX package's errors. The model is S uniform
stages (one tree structure a stage); ``stage_fn(params, x)`` takes one
stage's dict of tensors and returns a tensor of x's shape.

- Stage parameters are stacked on a leading axis; ``shard_stages`` puts
  stage s on the ``pipe`` axis's slot s: slot s holds its own stage's
  tensors.
- A batch is split into M microbatches, and the schedule runs JAX's
  M + S - 1 ticks. At tick t, stage s takes microbatch t - s: stage 0
  from the input, a later stage from the handoff buffer that stage s - 1
  filled at tick t - 1 (the handoff to the next slot is a copy), and the
  last stage's tick-t result is microbatch t - (S - 1)'s output.
- On one card a stage runs at tick t only when 0 <= t - s < M. The JAX
  schedule also computes its bubble ticks, on padding whose results
  never reach the outputs or the gradients, so the outputs are the same
  and a forward is exactly S * M stage calls.
- Autograd runs through the schedule (the stage calls and the handoff
  copies), so the gradient of a loss over ``pipeline_forward`` is the
  stacked per-stage gradient, and ``PipelineParallel``'s SGD step updates
  every stage at once (GPipe's synchronous update).

The slots of the axis share one rank's card (exec/mesh.py); a pipeline
across cards waits (ROADMAP item 7).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import resolve_device

Stages = Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]


def _tensor(a, device):
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    return torch.from_numpy(np.array(a)).to(resolve_device(device))


def stack_stage_params(per_stage_params, *, device=None):
    """[stage0 dict, stage1 dict, ...] -> one dict whose leaves carry a
    leading stage axis. numpy leaves (the JAX package's stages read back
    with ``np.asarray``) become tensors on ``device`` (default: the
    card); tensors stay on theirs unless ``device`` is given."""
    keys = list(per_stage_params[0])
    for p in per_stage_params[1:]:
        if list(p) != keys:
            raise ValueError("stages must share one tree structure; got "
                             f"{keys} and {list(p)}")
    return {k: torch.stack([_tensor(p[k], device)
                            for p in per_stage_params]) for k in keys}


def shard_stages(stacked, mesh, axis: str = "pipe") -> List[Dict]:
    """Stage s of the stacked tree on the ``axis`` slot s: a list of one
    dict a slot, each leaf the slot's stage (a view of the stacked leaf,
    so gradients reach it)."""
    slots = mesh.axis_slots(axis)
    n = next(iter(stacked.values())).shape[0]
    if n != len(slots):
        raise ValueError(
            f"{n} stages but the '{axis}' mesh axis has {len(slots)} devices "
            "— each device holds exactly one stage")
    out = []
    for s, slot in enumerate(slots):
        for k, a in stacked.items():
            if a.device.type != slot.device.type:
                raise ValueError(f"stage leaf {k!r} is on {a.device}, slot "
                                 f"{s} on {slot.device}")
        out.append({k: a[s] for k, a in stacked.items()})
    return out


def _per_stage(params: Stages) -> List[Dict]:
    if isinstance(params, dict):
        n = next(iter(params.values())).shape[0]
        return [{k: a[s] for k, a in params.items()} for s in range(n)]
    return list(params)


def pipeline_forward(stage_fn: Callable, stacked_params, x_microbatches,
                     mesh, axis: str = "pipe"):
    """Run the pipelined forward.

    ``stage_fn(params, x) -> y`` with y.shape == x.shape (uniform
    stages); ``stacked_params``: the stacked dict (leaves (S, ...)) or
    ``shard_stages``' list of per-slot dicts; ``x_microbatches``: (M, mb,
    ...). Returns (M, mb, ...): the last stage's output per microbatch.
    """
    slots = mesh.axis_slots(axis)
    S = len(slots)
    stages = _per_stage(stacked_params)
    if len(stages) != S:
        raise ValueError(
            f"{len(stages)} stages but the '{axis}' mesh axis has {S} "
            "devices — each device holds exactly one stage")
    xs = x_microbatches
    M = xs.shape[0]
    buf: List = [None] * S          # handoff buffers, filled by stage s
    outs: List = [None] * M
    for t in range(M + S - 1):
        new = [None] * S
        for s in range(S):
            mb = t - s
            if not 0 <= mb < M:
                continue               # a bubble: JAX's result is unused
            x_in = xs[mb] if s == 0 else buf[s - 1]
            y = stage_fn(stages[s], x_in)
            if s == S - 1:
                outs[mb] = y
            else:
                new[s] = y.to(slots[s + 1].device, copy=True)
        buf = new
    return torch.stack(outs)


def split_microbatches(x, num_microbatches: int):
    """(B, ...) -> (M, B/M, ...)."""
    B = x.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible into "
                         f"{num_microbatches} microbatches")
    return x.reshape((num_microbatches, B // num_microbatches)
                     + tuple(x.shape[1:]))


class PipelineParallel:
    """Minimal GPipe trainer over uniform stages.

    ``stage_fn(stage_params, x) -> y`` (same shape); ``loss_fn(y,
    targets)`` -> scalar mean loss. ``fit_batch`` runs the schedule, the
    backward through it and one SGD update of every stage. ``device``:
    where numpy stages go (default: the card)."""

    def __init__(self, stage_fn, loss_fn, per_stage_params, mesh,
                 axis: str = "pipe", learning_rate: float = 1e-2,
                 num_microbatches: int = None, *, device=None):
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.axis = axis
        self.lr = learning_rate
        S = len(mesh.axis_slots(axis))
        self.num_microbatches = num_microbatches or S
        if len(per_stage_params) != S:
            raise ValueError(
                f"{len(per_stage_params)} stages but the '{axis}' mesh axis "
                f"has {S} devices")
        self.params = {k: v.detach().clone() for k, v in stack_stage_params(
            per_stage_params, device=device).items()}
        self._stages = shard_stages(self.params, mesh, axis)

    def _as(self, x):
        dev = next(iter(self.params.values())).device
        return _tensor(x, dev)

    def fit_batch(self, x, y):
        """One step on batch (x, y): the loss before the update (a 0-dim
        tensor)."""
        xs = split_microbatches(self._as(x), self.num_microbatches)
        ys = split_microbatches(self._as(y), self.num_microbatches)
        leaves = {k: v.detach().requires_grad_() for k, v in
                  self.params.items()}
        with torch.enable_grad():
            outs = pipeline_forward(self.stage_fn, leaves, xs, self.mesh,
                                    self.axis)
            loss = self.loss_fn(outs.reshape((-1,) + tuple(outs.shape[2:])),
                                ys.reshape((-1,) + tuple(ys.shape[2:])))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for p, g in zip(self.params.values(), grads):
                p.sub_(self.lr * g)
        return loss.detach()

    def forward(self, x):
        with torch.no_grad():
            xs = split_microbatches(self._as(x), self.num_microbatches)
            outs = pipeline_forward(self.stage_fn, self._stages, xs,
                                    self.mesh, self.axis)
        return outs.reshape((-1,) + tuple(outs.shape[2:]))
