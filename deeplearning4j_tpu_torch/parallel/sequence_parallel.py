"""Sequence parallelism: ring attention over a mesh axis.

Counterpart of deeplearning4j_tpu/parallel/sequence_parallel.py:
``ring_attention(q, k, v, mesh, axis="seq", causal=False)`` and
``SequenceParallelAttention(layer, mesh, axis)``. The sequence axis of
(B, T, H, Dh) queries, keys and values is split over the axis's slots:
slot ``my`` holds the (B, T/n, H, Dh) block ``my`` of each, and the key /
value blocks pass around the ring, so that at step r slot ``my`` attends
to block ``src = (my - r) mod n``. The result is exact full attention.

On the card (a head dim ``ops.head_dim_supported`` takes; any dtype, cast
to float32 around the ring as ``scaled_dot_product_attention`` casts
around K5) every visible (query block, key block) pair is one launch of K5
(``ops.flash_attention_fwd``) over the (B*H, T/n, Dh) blocks: causal on
the diagonal (``src == my``), plain below it (``src < my``, or always
without causality), and no launch above it under causality. K5 returns
each block's output and log-sum-exp, and the blocks merge by them:
``lse = logsumexp_b(lse_b)``, ``o = sum_b exp(lse_b - lse) o_b`` (a row
whose every block is masked keeps lse -inf and o 0). Under autograd
``RingAttention``'s backward launches, for each launched pair, K6
(``ops.flash_attention_dq``: the pair's dq contribution, from the MERGED
o and lse) and K7 (``ops.flash_attention_dkv``: the pair's dk and dv
contributions, summed into the key block's gradient). So a causal ring of
n blocks launches n(n+1)/2 of each kernel, a plain one n^2.

The plain version is the JAX function's streaming recurrence, with its
-inf guards, in torch (``_ring_plain``); autograd differentiates it. The
CPU runs it, and so does the card for a head dim ``ops.head_dim_supported``
refuses, decided by that screen before any launch.

The blocks of one ring live on its slots' device (exec/mesh.py: the slots
of a model-parallel axis share one rank's card), so "passing a block on"
is reading the next slot's tensor; a ring across cards waits (ROADMAP
item 7).
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch import ops


def _ring_plain(q, k, v, n: int, causal: bool) -> torch.Tensor:
    """The JAX recurrence (``_ring_attention_local`` on every slot) over
    (B, T, H, Dh) tensors split in ``n`` sequence blocks: each query block
    carries its running max, denominator and output over the key blocks
    in ring order, -inf guarded; returns (B, T, H, Dh)."""
    B, T, H, Dh = q.shape
    Tl = T // n
    scale = 1.0 / math.sqrt(Dh)
    outs = []
    ar = torch.arange(Tl, device=q.device)
    for my in range(n):
        qb = q[:, my * Tl:(my + 1) * Tl]
        m = torch.full((B, H, Tl), float("-inf"), dtype=q.dtype,
                       device=q.device)
        l = torch.zeros((B, H, Tl), dtype=q.dtype, device=q.device)
        o = torch.zeros((B, H, Tl, Dh), dtype=q.dtype, device=q.device)
        for r in range(n):
            src = (my - r) % n
            kb = k[:, src * Tl:(src + 1) * Tl]
            vb = v[:, src * Tl:(src + 1) * Tl]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            if causal:
                keep = (my * Tl + ar)[:, None] >= (src * Tl + ar)[None, :]
                s = s.masked_fill(~keep, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               torch.zeros_like(m))
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
            m = m_new
        out = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1)


def _pairs(n: int, causal: bool):
    """(my, src, causal launch) of every launched block pair, in ring
    order: slot ``my`` meets ``src = my - r`` at step r."""
    out = []
    for my in range(n):
        for r in range(n):
            src = (my - r) % n
            if causal and src > my:
                continue
            out.append((my, src, causal and src == my))
    return out


def _merge(parts):
    """(o, lse) of one query block from its blocks' (o_b, lse_b): the
    log-sum-exp of the lse_b and the o_b weighted by exp(lse_b - lse);
    a row whose every lse_b is -inf keeps lse -inf and o 0."""
    lses = torch.stack([p[1] for p in parts])
    lse = torch.logsumexp(lses, dim=0)
    safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    w = torch.exp(lses - safe)
    o = (w.unsqueeze(-1) * torch.stack([p[0] for p in parts])).sum(0)
    return o, lse


def _blocks(a, n):
    """(BH, T, Dh) as (n, BH, T/n, Dh), one contiguous copy: block i is
    the contiguous ``[i]``."""
    BH, T, Dh = a.shape
    return a.reshape(BH, n, T // n, Dh).transpose(0, 1).contiguous()


def _unblock(a):
    """(n, BH, Tl, Dh) back to (BH, n * Tl, Dh)."""
    n, BH, Tl, Dh = a.shape
    return a.transpose(0, 1).reshape(BH, n * Tl, Dh)


class RingAttention(torch.autograd.Function):
    """Ring attention over (BH, T, Dh) float32 tensors split in ``n``
    sequence blocks: K5 per launched block pair, merged by log-sum-exp;
    backward K6 and K7 per launched pair from the merged o and lse. On CPU
    tensors the kernel wrappers run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, n, causal):
        qs, ks, vs = _blocks(q, n), _blocks(k, n), _blocks(v, n)
        by_q = [[] for _ in range(n)]
        for my, src, c in _pairs(n, causal):
            by_q[my].append(ops.flash_attention_fwd(qs[my], ks[src],
                                                    vs[src], c))
        merged = [_merge(parts) for parts in by_q]
        o = torch.stack([m[0] for m in merged])
        lse = torch.stack([m[1] for m in merged])
        ctx.n, ctx.causal = n, causal
        ctx.save_for_backward(qs, ks, vs, o, lse)
        return _unblock(o)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        n, causal = ctx.n, ctx.causal
        qs, ks, vs, os_, lses = ctx.saved_tensors
        dos = _blocks(do, n)
        dq, dk, dv = (torch.zeros_like(qs) for _ in range(3))
        for my, src, c in _pairs(n, causal):
            dqp, delta = ops.flash_attention_dq(qs[my], ks[src], vs[src],
                                                os_[my], lses[my], dos[my],
                                                c)
            dkp, dvp = ops.flash_attention_dkv(qs[my], ks[src], vs[src],
                                               lses[my], delta, dos[my], c)
            dq[my] += dqp
            dk[src] += dkp
            dv[src] += dvp
        return _unblock(dq), _unblock(dk), _unblock(dv), None, None


def _kernel_route(q) -> bool:
    """Whether the ring runs on the kernels: an input on the card whose
    head dim the kernels take (the screen, never a caught failure)."""
    return q.device.type == "cuda" and ops.head_dim_supported(q.shape[-1])


def ring_attention(q, k, v, mesh, axis: str = "seq", causal: bool = False):
    """Exact attention with the sequence axis split over ``mesh[axis]``'s
    slots. q / k / v: (B, T, H, Dh), T divisible by the axis size. Returns
    (B, T, H, Dh)."""
    slots = mesh.axis_slots(axis)
    n = len(slots)
    B, T, H, Dh = q.shape
    if T % n:
        raise ValueError(f"sequence length {T} does not divide over the "
                         f"{n} slots of the {axis!r} axis")
    for s in slots:
        if s.device.type != q.device.type:
            raise ValueError(f"slot {s} is not on the tensors' device "
                             f"{q.device}")
    if not _kernel_route(q):
        return _ring_plain(q, k, v, n, causal)

    def fold(a):    # (B, T, H, Dh) -> (B*H, T, Dh) float32
        return a.permute(0, 2, 1, 3).reshape(B * H, T, Dh).float() \
            .contiguous()
    o = RingAttention.apply(fold(q), fold(k), fold(v), n, causal)
    return o.reshape(B, H, T, Dh).permute(0, 2, 1, 3).to(q.dtype)


class SequenceParallelAttention:
    """A MultiHeadAttention layer's projections applied locally (sequence
    blocks through the same GEMMs) and its attention through the ring:
    the long-context execution path of the layer. ``params`` are the
    layer's (``Wq`` ... ``bo``)."""

    def __init__(self, layer, mesh, axis: str = "seq"):
        self.layer = layer
        self.mesh = mesh
        self.axis = axis
        mesh.axis_slots(axis)

    def __call__(self, params, x):
        B, T, C = x.shape
        q, k, v = self.layer._project(params, x)
        o = ring_attention(q, k, v, self.mesh, self.axis,
                           causal=self.layer.causal)
        o = o.reshape(B, T, self.layer.n_out) @ params["Wo"]
        if self.layer.has_bias:
            o = o + params["bo"]
        return o
