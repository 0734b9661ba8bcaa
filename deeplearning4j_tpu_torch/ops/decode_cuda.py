"""Flash decode step over a dense KV cache (K8) and over a paged block pool
(K9) for Hopper, with their plain PyTorch versions.

Counterpart of deeplearning4j_tpu/ops/flash_decode.py, one source
(csrc/flash_decode.cu) with two entry points:

- ``flash_decode_step(q, kc, vc, pos)`` replaces ``_decode_kernel``: q
  (B, H, Dh) against the cache (B, C, H, Dh) at positions 0..pos[b].
- ``flash_decode_step_paged(q, pk, pv, pos, block_tables)`` replaces
  ``_paged_kernel``: the same over a pool (NB, bs, H, Dh) whose blocks the
  (B, MB) int32 page tables name; the logical capacity is MB * bs.

Both take q float32 and a cache or pool in float32 or bfloat16 (K and V
of one type: a bf16-compute model's decode state), and return (B, H, Dh)
float32, for any head dim that is a multiple of 8
(``ops.head_dim_supported``). A bfloat16 cache is read in its own type
and widened in the kernel's registers, never copied to float32 (on a
paged engine that copy would be the whole pool a step). On the card each (b, h) pair (each (b, h,
128-column chunk) past Dh 128) is a thread-block cluster of S blocks that
split the live keys 0..pos[b] between them in contiguous ranges (whole
pages for K9; as many blocks as get a full round of keys each) and merge
their softmax triples through distributed shared memory in rank order; S
comes from the shape alone (B H chunks, the capacity, the SM count), never
from ``pos``, which the kernels read on the card only, so a decode step can
be captured in a CUDA graph and replayed after ``pos`` and the page tables
change in place. ``last_plan(name)``
reports the plan of the latest launch. The kernels read the cache and the
pool in place and only the live rows (the TPU wrappers' cast and transpose
copies of the whole cache are not carried over). On CPU tensors the
wrappers run the plain versions: the masked softmax of the attention
layer's dense decode step, and for K9 a gather of the pages followed by
K8's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import build

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_PLAN = ctypes.POINTER(ctypes.c_int)
ENTRIES = {"flash_decode": [_VP] * 5 + [_INT] * 6 + [_VP, _PLAN],
           "flash_decode_paged": [_VP] * 6 + [_INT] * 7 + [_VP, _PLAN],
           "flash_decode_empty": [_INT] * 8 + [_VP, _PLAN]}
# the cache types the kernels read (widened to float32 in registers)
CACHE_DTYPES = (torch.float32, torch.bfloat16)
# what every entry point reports of its launch
_PLAN_KEYS = ("cluster_size", "clusters", "threads", "min_keys_per_block")
_LAST_PLAN: Dict[str, dict] = {}


def flash_decode_step_plain(q, kc, vc, pos) -> torch.Tensor:
    """Plain PyTorch version of K8: softmax over c <= pos[b] of
    q . k_c / sqrt(Dh), times v (the layer's ``_finish_step`` math), in
    float32: a bfloat16 cache is widened first, exactly, as the kernel
    widens its rows."""
    C = kc.shape[1]
    s = torch.einsum("bhd,bchd->bhc", q.float(), kc.float()) \
        / math.sqrt(q.shape[-1])
    live = (torch.arange(C, device=q.device)[None, :]
            <= pos.to(q.device).long()[:, None])
    s = s.masked_fill(~live[:, None, :], float("-inf"))
    return torch.einsum("bhc,bchd->bhd", torch.softmax(s, dim=-1),
                        vc.float())


def gather_pages(pool, block_tables) -> torch.Tensor:
    """The logical (B, MB * bs, H, Dh) cache a page table describes."""
    B, MB = block_tables.shape
    return pool[block_tables.long()].reshape(B, MB * pool.shape[1],
                                             *pool.shape[2:])


def flash_decode_step_paged_plain(q, pk, pv, pos, block_tables
                                  ) -> torch.Tensor:
    """Plain PyTorch version of K9: gather the pages, then K8's plain
    version."""
    return flash_decode_step_plain(q, gather_pages(pk, block_tables),
                                   gather_pages(pv, block_tables), pos)


def _check(name, q, caches, pos, tables=None):
    B, H, Dh = q.shape
    if q.dtype != torch.float32:
        raise TypeError(f"{name}: q is {q.dtype}, the kernel takes float32")
    kinds = {t.dtype for t in caches.values()}
    for key, t in caches.items():
        if t.dtype not in CACHE_DTYPES:
            raise TypeError(f"{name}: {key} is {t.dtype}, the kernel takes "
                            "a float32 or bfloat16 cache")
    if len(kinds) != 1:
        raise TypeError(f"{name}: K and V must share one dtype, got "
                        + ", ".join(f"{k} {t.dtype}"
                                    for k, t in caches.items()))
    for key, t in list(caches.items()) + [("pos", pos)] + (
            [] if tables is None else [("block_tables", tables)]):
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not "
                             f"{q.device}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"{name}: pos must be ({B},), got "
                         f"{tuple(pos.shape)}")


def _on_card(name, q, tensors) -> bool:
    """False for CPU tensors (plain version); for CUDA ones check what the
    kernel takes and return True."""
    dev = q.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    Dh = q.shape[-1]
    if not ops.head_dim_supported(Dh):
        raise ValueError(f"{name}: head dim {Dh} is not a positive multiple "
                         "of 8")
    for key, t in tensors.items():
        if key in ("pos", "block_tables") and t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return True


def last_plan(name: str) -> dict:
    """Plan of the kernel's latest launch (``flash_decode`` or
    ``flash_decode_paged``): blocks per cluster (S), clusters (B H
    chunks), threads per block, and the keys a block takes at least (one
    round of its lane groups) before the live keys spread to one more of
    the S blocks."""
    return dict(_LAST_PLAN.get(name, {}))


def _call(entry, *args) -> dict:
    lib = build.load("flash_decode", ENTRIES, "flash_decode_error")
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = getattr(lib, entry)(*args, plan)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel failed: "
                           + lib.flash_decode_error(rc).decode())
    return dict(zip(_PLAN_KEYS, plan))


def _launch(entry, *args) -> None:
    _LAST_PLAN[entry] = _call(entry, *args)
    ops.count_launch(entry)


def launch_floor(name: str, B: int, H: int, Dh: int, C: int, bs: int = 0,
                 device=None, dtype=torch.float32) -> dict:
    """A measurement aid: launch an empty kernel on the grid and cluster
    shape that ``name`` (``flash_decode``, or ``flash_decode_paged`` with
    block size bs) would launch at this shape and cache ``dtype``, on the
    current stream. It touches no memory and counts as no launch of the
    kernel. Returns the plan."""
    dev = torch.device("cuda" if device is None else device)
    return _call("flash_decode_empty", int(name == "flash_decode_paged"), B,
                 H, Dh, C, bs, int(dtype == torch.bfloat16), dev.index or 0,
                 torch.cuda.current_stream(dev).cuda_stream)


def flash_decode_step(q, kc, vc, pos) -> torch.Tensor:
    """K8: one decode step of every (batch, head) row over a dense cache.
    q (B, H, Dh) float32; kc, vc (B, C, H, Dh) float32 or bfloat16 with
    position pos[b] already written; pos (B,) int32. Returns (B, H, Dh)
    float32."""
    B, H, Dh = q.shape
    if kc.dim() != 4 or kc.shape != vc.shape or kc.shape[0] != B \
            or kc.shape[2:] != q.shape[1:]:
        raise ValueError(f"flash_decode_step: bad shapes q {tuple(q.shape)}, "
                         f"kc {tuple(kc.shape)}, vc {tuple(vc.shape)}")
    _check("flash_decode_step", q, {"kc": kc, "vc": vc}, pos)
    if not _on_card("flash_decode_step", q,
                    {"q": q, "kc": kc, "vc": vc, "pos": pos}):
        return flash_decode_step_plain(q, kc, vc, pos)
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    _launch("flash_decode", q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            pos.data_ptr(), out.data_ptr(), B, H, Dh, kc.shape[1],
            int(kc.dtype == torch.bfloat16), q.device.index or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    return out


def flash_decode_step_paged(q, pk, pv, pos, block_tables) -> torch.Tensor:
    """K9: ``flash_decode_step`` over a block pool. pk, pv (NB, bs, H, Dh)
    float32 or bfloat16; block_tables (B, MB) int32, every entry a pool
    block; pos (B,) int32 below MB * bs. Returns (B, H, Dh) float32."""
    B, H, Dh = q.shape
    if pk.dim() != 4 or pk.shape != pv.shape or pk.shape[2:] != q.shape[1:] \
            or block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"flash_decode_step_paged: bad shapes q "
                         f"{tuple(q.shape)}, pool {tuple(pk.shape)} / "
                         f"{tuple(pv.shape)}, block_tables "
                         f"{tuple(block_tables.shape)}")
    _check("flash_decode_step_paged", q, {"pk": pk, "pv": pv}, pos,
           block_tables)
    if not _on_card("flash_decode_step_paged", q,
                    {"q": q, "pk": pk, "pv": pv, "pos": pos,
                     "block_tables": block_tables}):
        return flash_decode_step_paged_plain(q, pk, pv, pos, block_tables)
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    _launch("flash_decode_paged", q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
            pos.data_ptr(), block_tables.data_ptr(), out.data_ptr(), B, H,
            Dh, pk.shape[1], block_tables.shape[1],
            int(pk.dtype == torch.bfloat16), q.device.index or 0,
            torch.cuda.current_stream(q.device).cuda_stream)
    return out
