"""Flash attention forward (K5) for Hopper and its plain PyTorch version.

Counterpart of deeplearning4j_tpu/ops/flash_attention.py:
``flash_attention_fwd`` (csrc/flash_attn_fwd.cu) replaces ``_fwd_kernel``
(reached through ``_fa_fwd_call``): blocked online-softmax attention over
(BH, T, Dh) float32 q, k, v with an optional causal mask, returning o and
the per-row log-sum-exp (BH, T) that the backward kernels of the training
slice will read. ``flash_attention`` returns o alone. The backward kernels
(``_dq_kernel``, ``_dkv_kernel``; K6, K7) are not ported yet, so a CUDA
call that autograd would record raises instead of differentiating
anything else.

Unlike the TPU kernel the CUDA one takes every T (it masks the ragged
tail itself); Dh must be a multiple of 8 up to 128. On a CPU tensor the
wrapper runs the plain version, an einsum and a softmax.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import build

_VP, _INT = ctypes.c_void_p, ctypes.c_int
ENTRIES = {"flash_attn_fwd": [_VP] * 5 + [_INT] * 5 + [_VP]}


def flash_attention_fwd_plain(q, k, v, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 in float32: (o, lse), o (BH, T, Dh) and
    lse (BH, T)."""
    q, k, v = q.float(), k.float(), v.float()
    s = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(q.shape[-1])
    if causal:
        T = q.shape[1]
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.einsum("bts,bsd->btd", torch.softmax(s, dim=-1), v), lse


def _check(q, k, v):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must share one (BH, T, "
                         f"Dh) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, the "
                            "kernel takes float32")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"not {q.device}")


def flash_attention_fwd(q, k, v, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (o, lse) of softmax(q k^T / sqrt(Dh)) v over (BH, T, Dh) float32
    tensors, keys after the query masked when ``causal``."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA has no backward yet: its kernels (K6 "
            "_dq_kernel, K7 _dkv_kernel) come with the TinyTransformer "
            "training slice; run inference under torch.no_grad()")
    BH, T, Dh = q.shape
    if Dh % 8 != 0 or not 8 <= Dh <= 128:
        raise ValueError(f"flash_attention: head dim {Dh} is not a multiple "
                         "of 8 in [8, 128]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=dev)
    lib = build.load("flash_attn_fwd", ENTRIES, "flash_attn_error")
    rc = lib.flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), BH, T, Dh,
                            int(bool(causal)), dev.index or 0,
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attn_fwd kernel failed: "
                           + lib.flash_attn_error(rc).decode())
    ops.count_launch("flash_attn_fwd")
    return o, lse


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """K5's output alone: (BH, T, Dh) float32."""
    return flash_attention_fwd(q, k, v, causal)[0]
