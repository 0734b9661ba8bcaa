"""Expert parallelism: a capacity-based top-1 mixture of experts over a
mesh axis.

Counterpart of deeplearning4j_tpu/parallel/expert_parallel.py:
``init_moe_params``, ``shard_moe_params``, ``moe_ffw`` and
``moe_ffw_dense_reference``, with the JAX formulas. Top-1 gating builds
static-shaped dispatch and combine tensors (tokens x experts x
capacity): ``C = max(1, int(capacity_factor * T / E))``, the router's
argmax takes the first maximum, a token past its expert's capacity is
dropped (its output 0), the expert FFN is a GELU (the tanh approximation,
``jax.nn.gelu``'s default) between two dense maps, and the Switch
auxiliary loss is ``E * sum(fraction of tokens * mean probability)`` per
expert.

``shard_moe_params`` puts E/n experts on each slot of the ``expert``
axis (the router replicated): the expert-major leaves become a list of
one shard a slot. ``moe_ffw`` over sharded parameters runs each slot's
experts on its own (E/n, C, D) rows; the dispatch and the combine are the
all-to-all, done as indexing between the slots (each slot takes its
experts' rows of the dispatched tensor, and the slots' outputs are
joined in slot order). No hand kernel runs here: the einsums and the
GELU FFNs are ``torch.einsum`` / ``torch.matmul``, as the JAX package
leaves them to XLA. The slots of the axis share one rank's card
(exec/mesh.py); experts across cards wait (ROADMAP item 7).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import resolve_device

_EXPERT_LEAVES = ("W1", "b1", "W2", "b2")


def init_moe_params(rng, d_model: int, d_hidden: int, n_experts: int,
                    dtype=torch.float32, *, device=None) -> Dict:
    """Router ``Wg`` (D, E), expert maps ``W1`` (E, D, H), ``W2`` (E, H,
    D) drawn normal and scaled by 1/sqrt(fan-in), zero biases, from
    ``rng`` (a ``torch.Generator`` or an int seed) on the CPU, then moved
    to ``device`` (default: the card)."""
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    dev = resolve_device(device)
    s_in, s_h = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_hidden)
    E, D, H = n_experts, d_model, d_hidden

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=dtype)
                * scale).to(dev)
    return {"Wg": normal((D, E), s_in), "W1": normal((E, D, H), s_in),
            "b1": torch.zeros((E, H), dtype=dtype, device=dev),
            "W2": normal((E, H, D), s_h),
            "b2": torch.zeros((E, D), dtype=dtype, device=dev)}


def moe_params_from_numpy(arrays, device=None) -> Dict:
    """The JAX package's MoE dict read back with ``np.asarray`` -> the
    port's, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in arrays.items()}


def shard_moe_params(params, mesh, axis: str = "expert") -> Dict:
    """Expert-major leaves split on their leading (expert) dim over the
    ``axis`` slots -- a list of one contiguous shard a slot, in slot
    order -- and the router replicated."""
    slots = mesh.axis_slots(axis)
    n = len(slots)
    E = params["Wg"].shape[-1]
    if E % n:
        raise ValueError(f"{E} experts do not divide over the {n} slots of "
                         f"the {axis!r} axis")
    out = {}
    for k, a in params.items():
        if k == "Wg":
            out[k] = a
        else:
            out[k] = [c.to(s.device).contiguous().clone()
                      for c, s in zip(a.chunk(n, 0), slots)]
    return out


def _one_hot(idx, n: int, dtype):
    """jax.nn.one_hot: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _experts(W1, b1, W2, b2, xe):
    """The FFNs of the experts of one slot over their (E_s, C, D) rows."""
    h = F.gelu(torch.einsum("ecd,edh->ech", xe, W1) + b1[:, None, :],
               approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, W2) + b2[:, None, :]


def moe_ffw(params, x, capacity_factor: float = 1.25):
    """Top-1 routed expert feed-forward.

    x: (T, D) tokens. Returns (y, aux_loss): y (T, D) and the Switch
    load-balancing penalty. ``params`` as ``init_moe_params`` gives them,
    or sharded by ``shard_moe_params`` (each slot then runs its own
    experts)."""
    T, D = x.shape
    E = params["Wg"].shape[-1]
    C = max(1, int(capacity_factor * T / E))

    logits = x @ params["Wg"]                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)                    # (T,)
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]

    onehot = _one_hot(expert, E, x.dtype)                   # (T, E)
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot      # (T, E)
    keep = onehot * (pos < C).to(x.dtype)                   # capacity drop
    pos_c = _one_hot(pos.to(torch.int32), C, x.dtype)       # (T, E, C)
    dispatch = keep[..., None] * pos_c                      # (T, E, C)
    combine = dispatch * gate[:, None, None]

    xe = torch.einsum("tec,td->ecd", dispatch, x)           # (E, C, D)
    if isinstance(params["W1"], (list, tuple)):
        ye, e0 = [], 0
        for W1, b1, W2, b2 in zip(*(params[k] for k in _EXPERT_LEAVES)):
            e1 = e0 + W1.shape[0]
            ye.append(_experts(W1, b1, W2, b2,
                               xe[e0:e1].to(W1.device)).to(x.device))
            e0 = e1
        ye = torch.cat(ye, dim=0)
    else:
        ye = _experts(*(params[k] for k in _EXPERT_LEAVES), xe)
    y = torch.einsum("tec,ecd->td", combine, ye)            # (T, D)

    frac_tokens = onehot.mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux


def moe_ffw_dense_reference(params, x):
    """Every token through its argmax expert with NO capacity limit: the
    unsharded oracle (equals ``moe_ffw`` when capacity is ample)."""
    def full(k):
        a = params[k]
        return torch.cat(list(a), 0) if isinstance(a, (list, tuple)) else a
    probs = torch.softmax(x @ params["Wg"], dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    W1, b1 = full("W1")[expert], full("b1")[expert]
    W2, b2 = full("W2")[expert], full("b2")[expert]
    h = F.gelu(torch.einsum("td,tdh->th", x, W1) + b1, approximate="tanh")
    y = torch.einsum("th,thd->td", h, W2) + b2
    return y * gate[:, None]
