"""Fused LSTM forward kernels for Hopper, their plain PyTorch versions, and
the build that compiles them.

Counterpart of deeplearning4j_tpu/ops/lstm_pallas.py, inference mode:

- ``fused_lstm_sequence`` (K1, csrc/lstm_fwd.cu) replaces
  ``_fwd_inference_kernel``: one LSTM over precomputed gate inputs.
- ``fused_lstm2_sequence`` (K4, csrc/lstm2_fwd.cu) replaces
  ``_fwd2_kernel`` with ``save_reserve=False``: two stacked LSTMs on a
  wavefront.

Both keep the JAX package's contract: IFOG gate order,
``z = gate_in_t + h_{t-1} @ RW``, cell math in float32, float32 or bfloat16
streams (for bfloat16, h is rounded to bfloat16 before the product and the
sum stays float32), outputs in the stream dtype. The input projection
``x @ W + b`` stays outside, as a ``torch.matmul`` in the layer.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version beside it, a Python time loop over the same float32
math. The kernels are built with ``nvcc`` into ``build/torch_kernels/`` at
first use (one process per source, all started together) and loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch import ops

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("lstm_fwd.cu", "lstm2_fwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()
_LAST_PLAN: Dict[str, dict] = {}
_PLAN_KEYS = ("units_per_block", "unit_blocks", "batch_blocks", "threads",
              "h_slice", "shared_bytes")


# ------------------------------------------------------------------ build

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    """Build output named by a digest of the sources and flags, so an edit
    to either never loads a stale library."""
    h = hashlib.sha256()
    for name in (source, "lstm_common.cuh"):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_kernels() -> Dict[str, dict]:
    """Compile every kernel source that has no current build, one ``nvcc``
    per source, all started together. Returns, per source stem, the
    library path, the build seconds (0 when it was already built) and what
    ``ptxas -v`` reported (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, procs = {}, {}
    for src in SOURCES:
        stem, out = Path(src).stem, _lib_path(src)
        if out.exists():
            info[stem] = {"path": str(out), "seconds": 0.0, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for stem, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{log}")
            continue
        os.replace(tmp, out)
        info[stem] = {"path": str(out), "seconds": time.perf_counter() - t0,
                      "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return info


def _lib(stem: str) -> ctypes.CDLL:
    with _LIBS_LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(build_kernels()[stem]["path"])
            vp, i = ctypes.c_void_p, ctypes.c_int
            plan = ctypes.POINTER(ctypes.c_int)
            if stem == "lstm_fwd":
                lib.lstm_fwd.argtypes = [vp] * 7 + [i] * 5 + [vp, plan]
                lib.lstm_fwd.restype = i
            else:
                lib.lstm2_fwd.argtypes = ([ctypes.POINTER(vp)] * 2 + [vp] * 3
                                          + [i] * 5 + [vp, plan])
                lib.lstm2_fwd.restype = i
            lib.lstm_error.argtypes = [i]
            lib.lstm_error.restype = ctypes.c_char_p
            _LIBS[stem] = lib
        return lib


def last_plan(name: str) -> dict:
    """Grid of the kernel's latest launch (units per block, blocks across
    units and batch, threads, depth of a staged h slice, shared bytes)."""
    return dict(_LAST_PLAN.get(name, {}))


def _check(name, dtype, device, **tensors):
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: stream dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, streams are {dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _launch(name: str, fn, *args) -> None:
    plan = (ctypes.c_int * len(_PLAN_KEYS))()
    rc = fn(*args, plan)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed: "
                           f"{_lib(name).lstm_error(rc).decode()}")
    _LAST_PLAN[name] = dict(zip(_PLAN_KEYS, plan))
    ops.count_launch(name)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------ plain math

def _cell(z, c, H):
    """Float32 cell math (lstm_pallas._cell_math): sigmoid over [i|f|o],
    tanh over g. Returns (h, c)."""
    sp = torch.sigmoid(z[:, :3 * H])
    g = torch.tanh(z[:, 3 * H:])
    c = sp[:, H:2 * H] * c + sp[:, :H] * g
    return sp[:, 2 * H:3 * H] * torch.tanh(c), c


def _gate_product(h, w, dt):
    """h @ W with h rounded to the stream dtype and a float32 sum (the
    products of two bfloat16 values are exact in float32)."""
    return h.to(dt).float() @ w.float()


def lstm_sequence_plain(gate_in, rw, h0, c0) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K1 on the same contract."""
    dt, H = gate_in.dtype, h0.shape[-1]
    h, c = h0.float(), c0.float()
    hs = torch.empty(gate_in.shape[:2] + (H,), dtype=dt, device=gate_in.device)
    for t in range(gate_in.shape[0]):
        h, c = _cell(gate_in[t].float() + _gate_product(h, rw, dt), c, H)
        hs[t] = h.to(dt)
    return hs, c.to(dt)


def lstm2_sequence_plain(gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02
                         ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K4: the two layers step by step, layer 2
    reading layer 1's h of the same step."""
    dt, H = gate_in1.dtype, h01.shape[-1]
    h1, c1, h2, c2 = h01.float(), c01.float(), h02.float(), c02.float()
    b2f = b2.float()
    hs2 = torch.empty(gate_in1.shape[:2] + (H,), dtype=dt,
                      device=gate_in1.device)
    for t in range(gate_in1.shape[0]):
        h1, c1 = _cell(gate_in1[t].float() + _gate_product(h1, rw1, dt), c1, H)
        z2 = _gate_product(h1, w2, dt) + b2f + _gate_product(h2, rw2, dt)
        h2, c2 = _cell(z2, c2, H)
        hs2[t] = h2.to(dt)
    return hs2, h1.to(dt), c1.to(dt), c2.to(dt)


# --------------------------------------------------------------- wrappers

def fused_lstm_sequence(gate_in, rw, h0, c0) -> Tuple[torch.Tensor, ...]:
    """One LSTM over precomputed gate inputs (K1).

    gate_in: (T, B, 4H) = x @ W + b, IFOG order; rw: (H, 4H); h0, c0:
    (B, H); one stream dtype, float32 or bfloat16. Returns (hs, c_last):
    hs (T, B, H) and the final cell state (B, H)."""
    T, B, G = gate_in.shape
    H = G // 4
    if G != 4 * H or T < 1 or tuple(rw.shape) != (H, G) \
            or tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
        raise ValueError(f"fused_lstm_sequence: bad shapes gate_in "
                         f"{tuple(gate_in.shape)}, rw {tuple(rw.shape)}, h0 "
                         f"{tuple(h0.shape)}, c0 {tuple(c0.shape)}")
    dev, dt = gate_in.device, gate_in.dtype
    _check("fused_lstm_sequence", dt, dev, gate_in=gate_in, rw=rw, h0=h0,
           c0=c0)
    if dev.type == "cpu":
        return lstm_sequence_plain(gate_in, rw, h0, c0)
    if dev.type != "cuda":
        raise ValueError(f"fused_lstm_sequence: unsupported device {dev}")
    lib = _lib("lstm_fwd")
    hs = torch.empty((T, B, H), dtype=dt, device=dev)
    cT = torch.empty((B, H), dtype=dt, device=dev)
    c_s = torch.empty((B, H), dtype=torch.float32, device=dev)
    _launch("lstm_fwd", lib.lstm_fwd, gate_in.data_ptr(), rw.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), hs.data_ptr(), cT.data_ptr(),
            c_s.data_ptr(), T, B, H, _DTYPE_CODE[dt], dev.index or 0,
            _stream(dev))
    return hs, cT


def fused_lstm2_sequence(gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02
                         ) -> Tuple[torch.Tensor, ...]:
    """Two stacked LSTMs over precomputed layer-1 gate inputs (K4).

    gate_in1: (T, B, 4H) = x @ W1 + b1; rw1, w2, rw2: (H, 4H); b2: (4H,);
    four (B, H) carries. Returns (hs2, h1T, c1T, c2T): the layer-2 hidden
    sequence (T, B, H) and the final states (h2T = hs2[-1])."""
    T, B, G = gate_in1.shape
    H = G // 4
    mats = {"rw1": rw1, "w2": w2, "rw2": rw2}
    carries = {"h01": h01, "c01": c01, "h02": h02, "c02": c02}
    if G != 4 * H or T < 1 or tuple(b2.shape) != (G,) \
            or any(tuple(m.shape) != (H, G) for m in mats.values()) \
            or any(tuple(c.shape) != (B, H) for c in carries.values()):
        raise ValueError(f"fused_lstm2_sequence: bad shapes gate_in1 "
                         f"{tuple(gate_in1.shape)}, b2 {tuple(b2.shape)}, "
                         f"{ {k: tuple(v.shape) for k, v in mats.items()} }, "
                         f"{ {k: tuple(v.shape) for k, v in carries.items()} }")
    dev, dt = gate_in1.device, gate_in1.dtype
    _check("fused_lstm2_sequence", dt, dev, gate_in1=gate_in1, b2=b2,
           **mats, **carries)
    if dev.type == "cpu":
        return lstm2_sequence_plain(gate_in1, rw1, w2, b2, rw2, h01, c01,
                                    h02, c02)
    if dev.type != "cuda":
        raise ValueError(f"fused_lstm2_sequence: unsupported device {dev}")
    lib = _lib("lstm2_fwd")
    hs2 = torch.empty((T, B, H), dtype=dt, device=dev)
    finals = [torch.empty((B, H), dtype=dt, device=dev) for _ in range(3)]
    h1buf = torch.empty((2, B, H), dtype=dt, device=dev)
    c_s = [torch.empty((B, H), dtype=torch.float32, device=dev)
           for _ in range(2)]
    ins = [gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02]
    outs = [hs2] + finals
    in_ptrs = (ctypes.c_void_p * 9)(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in outs])
    _launch("lstm2_fwd", lib.lstm2_fwd, in_ptrs, out_ptrs, h1buf.data_ptr(),
            c_s[0].data_ptr(), c_s[1].data_ptr(), T, B, H, _DTYPE_CODE[dt],
            dev.index or 0, _stream(dev))
    return tuple(outs)
