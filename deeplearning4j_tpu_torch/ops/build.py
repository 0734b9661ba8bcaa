"""Build and load the port's hand-written CUDA kernels.

Every source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/torch_kernels/`` (one process per source, all started together),
and loaded with ``ctypes``. Each entry point returns an int error code
(0, a ``cudaError_t``, or a negative code of its own that the library's
error function turns into text). Nothing here runs when the package is
imported: the CPU tests import every module and have no ``nvcc``.
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
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("lstm_fwd.cu", "lstm2_fwd.cu", "lstm_bwd.cu", "flash_attn_fwd.cu",
           "flash_attn_bwd.cu", "flash_decode.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    """Build output named by a digest of the source, every header beside
    it and the flags, so an edit to any of them never loads a stale
    library."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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


def load(stem: str, entries: Dict[str, Sequence], error_fn: str
         ) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu`` (building every source
    first if needed), with ``entries`` (name -> ctypes argtypes, each
    returning int) and its ``error_fn(int) -> const char*`` typed."""
    with _LIBS_LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(build_kernels()[stem]["path"])
            for name, argtypes in entries.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            err = getattr(lib, error_fn)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _LIBS[stem] = lib
        return lib
