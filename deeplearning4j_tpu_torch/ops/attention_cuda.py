"""Flash attention for Hopper: the forward (K5) and the backward (K6, K7),
the autograd function that joins them, and their plain PyTorch versions.

Counterpart of deeplearning4j_tpu/ops/flash_attention.py:
- ``flash_attention_fwd`` (csrc/flash_attn_fwd.cu) replaces ``_fwd_kernel``
  (reached through ``_fa_fwd_call``): blocked online-softmax attention over
  (BH, T, Dh) float32 q, k, v with an optional causal mask, returning o and
  the per-row log-sum-exp lse (BH, T);
- ``flash_attention_dq`` and ``flash_attention_dkv`` (csrc/flash_attn_bwd.cu)
  replace ``_dq_kernel`` (K6) and ``_dkv_kernel`` (K7), reached through
  ``_fa_bwd``; ``flash_attention_bwd`` runs the two in order: dq, then dk
  and dv, recomputed tile by tile from q, k, v, o, lse and the output's
  gradient. K6 also writes delta = rowsum(do * o), which the JAX package
  computes outside its kernels, for K7;
- ``FlashAttention``, the custom VJP: its forward runs K5 and saves q, k,
  v, o and lse, its backward runs K6 and K7. ``flash_attention`` goes
  through it whenever autograd records, and returns K5's o alone
  otherwise (serving: one K5 launch, nothing saved).

Unlike the TPU kernels the CUDA ones take every T (they mask the ragged
tail themselves); Dh may be any multiple of 8 (``ops.head_dim_supported``;
past 128 the kernels split the head dim into 128-column chunks across
blocks). On CPU tensors the
wrappers, and so the autograd function, run the plain versions: an einsum
and a softmax, and the backward's recompute formulas.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import build

_VP, _INT = ctypes.c_void_p, ctypes.c_int
ENTRIES = {"flash_attn_fwd": [_VP] * 5 + [_INT] * 5 + [_VP]}
BWD_ENTRIES = {"flash_attn_dq": [_VP] * 8 + [_INT] * 5 + [_VP],
               "flash_attn_dkv": [_VP] * 8 + [_INT] * 5 + [_VP]}


def _causal_keep(T, device) -> torch.Tensor:
    return torch.ones(T, T, dtype=torch.bool, device=device).tril()


def flash_attention_fwd_plain(q, k, v, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5, in the inputs' type: (o, lse), o
    (BH, T, Dh) and lse (BH, T)."""
    s = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.einsum("bts,bsd->btd", torch.softmax(s, dim=-1), v), lse


def _recompute(q, k, v, lse, do, causal):
    """The backward's recomputed probabilities p and dp = do v^T."""
    s = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(q.shape[-1])
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(q.shape[1], q.device), 0.0)
    return p, torch.einsum("btd,bsd->bts", do, v)


def flash_attention_dq_plain(q, k, v, o, lse, do, causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6, in the inputs' type: (dq, delta), delta
    = rowsum(do * o) (BH, T)."""
    p, dp = _recompute(q, k, v, lse, do, causal)
    delta = (do * o).sum(-1)
    ds = p * (dp - delta[..., None]) / math.sqrt(q.shape[-1])
    return torch.einsum("bts,bsd->btd", ds, k), delta


def flash_attention_dkv_plain(q, k, v, lse, delta, do, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7, in the inputs' type: (dk, dv)."""
    p, dp = _recompute(q, k, v, lse, do, causal)
    ds = p * (dp - delta[..., None]) / math.sqrt(q.shape[-1])
    return (torch.einsum("bts,btd->bsd", ds, q),
            torch.einsum("bts,btd->bsd", p, do))


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K6 then K7: (dq, dk, dv) from the
    probabilities recomputed with the forward's lse, as the kernels do."""
    dq, delta = flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    return (dq,) + flash_attention_dkv_plain(q, k, v, lse, delta, do, causal)


def _check(named):
    """Every tensor of ``named`` (name -> tensor) float32, of the first
    one's (BH, T, Dh) shape and on its device."""
    first = next(iter(named.values()))
    shape = tuple(first.shape)
    if len(shape) != 3:
        raise ValueError(f"flash_attention: tensors must be (BH, T, Dh), got "
                         f"{shape}")
    for name, t in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention: {name} must share one (BH, "
                             f"T, Dh) shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, the "
                            "kernel takes float32")
        if t.device != first.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"not {first.device}")


def _on_card(named) -> bool:
    """False for CPU tensors (plain version); for CUDA ones check what the
    kernels take and return True."""
    dev = next(iter(named.values())).device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    Dh = next(iter(named.values())).shape[-1]
    if not ops.head_dim_supported(Dh):
        raise ValueError(f"flash_attention: head dim {Dh} is not a positive "
                         "multiple of 8")
    for name, t in named.items():
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    return True


def _launch(stem, entries, error_fn, entry, device, *args) -> None:
    lib = build.load(stem, entries, error_fn)
    rc = getattr(lib, entry)(*args, device.index or 0,
                             torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel failed: "
                           + getattr(lib, error_fn)(rc).decode())
    BH, T, Dh, causal = args[-4:]
    ops.count_launch(entry, *work(entry, BH, T, Dh, causal))


def work(entry: str, BH: int, T: int, Dh: int, causal: bool):
    """(operations, bytes) of one launch of ``entry`` over (BH, T, Dh)
    float32 tensors: the (query, key) pairs the mask keeps, two products
    each forward (q.k, p.v), three for dq and four for dk and dv; every
    input read once and every output written once."""
    pairs = BH * (T * (T + 1) // 2 if causal else T * T)
    vec, row = BH * T * Dh, BH * T
    if entry == "flash_attn_fwd":
        return 4.0 * Dh * pairs, 4.0 * (3 * vec + vec + row)
    if entry == "flash_attn_dq":
        return 6.0 * Dh * pairs, 4.0 * (5 * vec + row + vec + row)
    return 8.0 * Dh * pairs, 4.0 * (4 * vec + 2 * row + 2 * vec)


def flash_attention_fwd(q, k, v, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (o, lse) of softmax(q k^T / sqrt(Dh)) v over (BH, T, Dh) float32
    tensors, keys after the query masked when ``causal``. Records no
    autograd graph on the card: differentiate through ``flash_attention``."""
    named = {"q": q, "k": k, "v": v}
    _check(named)
    if not _on_card(named):
        return flash_attention_fwd_plain(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention_fwd records no autograd graph on "
                         "the card; differentiate through flash_attention")
    BH, T, Dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    _launch("flash_attn_fwd", ENTRIES, "flash_attn_error", "flash_attn_fwd",
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), BH, T, Dh, int(bool(causal)))
    return o, lse


def _check_rows(named, q):
    """Each of ``named`` (name -> tensor) float32 (BH, T) on q's device."""
    for name, t in named.items():
        if (tuple(t.shape) != tuple(q.shape[:2]) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"flash_attention: {name} must be float32 of "
                             f"shape {tuple(q.shape[:2])} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def flash_attention_dq(q, k, v, o, lse, do, causal: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: (dq, delta) of ``flash_attention`` at (q, k, v), from its output
    o, its log-sum-exp lse (BH, T) and the output's gradient ``do``, all
    float32; delta = rowsum(do * o) (BH, T) is what K7 reads."""
    named = {"q": q, "k": k, "v": v, "o": o, "do": do}
    _check(named)
    _check_rows({"lse": lse}, q)
    if not _on_card({**named, "lse": lse}):
        return flash_attention_dq_plain(q, k, v, o, lse, do, causal)
    BH, T, Dh = q.shape
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    _launch("flash_attn_bwd", BWD_ENTRIES, "flash_attn_bwd_error",
            "flash_attn_dq", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), delta.data_ptr(), BH, T, Dh, int(bool(causal)))
    return dq, delta


def flash_attention_dkv(q, k, v, lse, delta, do, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: (dk, dv) from the same inputs as K6 and the delta it wrote."""
    named = {"q": q, "k": k, "v": v, "do": do}
    _check(named)
    _check_rows({"lse": lse, "delta": delta}, q)
    if not _on_card({**named, "lse": lse, "delta": delta}):
        return flash_attention_dkv_plain(q, k, v, lse, delta, do, causal)
    BH, T, Dh = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch("flash_attn_bwd", BWD_ENTRIES, "flash_attn_bwd_error",
            "flash_attn_dkv", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), BH, T, Dh, int(bool(causal)))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False
                        ) -> Tuple[torch.Tensor, ...]:
    """K6 then K7: (dq, dk, dv) of ``flash_attention`` at (q, k, v). Two
    launches on the current stream; delta (BH, T), which K6 writes for K7,
    is the only scratch."""
    dq, delta = flash_attention_dq(q, k, v, o, lse, do, causal)
    return (dq,) + flash_attention_dkv(q, k, v, lse, delta, do, causal)


class FlashAttention(torch.autograd.Function):
    """The custom VJP of ``flash_attention``: K5 forward (q, k, v, o and lse
    saved), K6 and K7 backward. On CPU tensors both run the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        # the layer's permute and reshape hand back a strided gradient
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh)) v over (BH, T, Dh) float32 tensors: K5's o,
    through ``FlashAttention`` (backward K6 and K7) when autograd records."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention_fwd(q, k, v, causal)[0]


