"""Build and load the port's hand-written CUDA kernels.

Every source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/torch_kernels/`` (one process per source, all started together),
and loaded with ``ctypes``. Each entry point returns an int error code
(0, a ``cudaError_t``, or a negative code of its own that the library's
error function turns into text). Nothing here runs when the package is
imported: the CPU tests import every module and have no ``nvcc``.

The built libraries travel in AOT artifacts (exec/aot.py):
``export_libraries`` hands each one over with its digest name, sha256 and
the ``nvcc --version`` line, and ``install_libraries`` writes artifact
members into ``BUILD_DIR`` (sha256 checked, only under a name the current
sources give, by temp file, fsync and rename), after which
``build_kernels`` finds them and starts no ``nvcc``. Both writers are
atomic, so replicas starting at once on an empty build directory may
build or install side by side. ``nvcc_runs()`` counts the ``nvcc``
processes this process started.
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
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("lstm_fwd.cu", "lstm2_fwd.cu", "lstm_bwd.cu", "flash_attn_fwd.cu",
           "flash_attn_bwd.cu", "flash_decode.cu")
# every warning is an error: a call from host-device code to a host-only
# function, for one, is only a warning, and the kernel built with it wrote
# nothing on the card
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-Werror", "all-warnings")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()
_NVCC_RUNS: List[str] = []      # the sources this process ran nvcc for


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
        _NVCC_RUNS.append(src)
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


def nvcc_runs() -> List[str]:
    """The sources this process started ``nvcc`` for, in order."""
    return list(_NVCC_RUNS)


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its build), or "" without
    ``nvcc``."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return ""
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def current_names() -> Dict[str, str]:
    """Library file name -> source stem, for the current sources."""
    return {_lib_path(src).name: Path(src).stem for src in SOURCES}


def export_libraries() -> List[dict]:
    """Every current library already built, as artifact members:
    ``{"name", "stem", "sha256", "nvcc", "data"}`` (the name is the
    digest name ``_lib_path`` gives, so a source edit makes it a
    stranger; ``nvcc`` is ``nvcc_version()``)."""
    out, nvcc = [], None
    for name, stem in sorted(current_names().items()):
        path = BUILD_DIR / name
        if path.exists():
            if nvcc is None:
                nvcc = nvcc_version()
            data = path.read_bytes()
            out.append({"name": name, "stem": stem,
                        "sha256": hashlib.sha256(data).hexdigest(),
                        "nvcc": nvcc, "data": data})
    return out


def install_libraries(members: Sequence[dict]) -> dict:
    """Write artifact members into ``BUILD_DIR``. A member is installed
    only when its bytes' sha256 equals the one it declares and its name is
    one the current sources give; any other is refused and counted as an
    AOT miss (``corrupt`` for the digest, ``key`` for the name), and its
    source builds as before. A library already in place is left as it is.
    Returns ``{"installed", "present", "refused"}`` (names; refused as
    ``(name, reason)``)."""
    from deeplearning4j_tpu_torch.exec.aot import note_miss, write_atomic
    names = current_names()
    report = {"installed": [], "present": [], "refused": []}
    for m in members:
        name = os.path.basename(str(m.get("name", "")))
        data = m.get("data") or b""
        if name not in names or name != m.get("name"):
            reason = "key"
        elif hashlib.sha256(data).hexdigest() != m.get("sha256"):
            reason = "corrupt"
        else:
            reason = None
        if reason is not None:
            note_miss(reason)
            report["refused"].append((m.get("name"), reason))
            continue
        path = BUILD_DIR / name
        if path.exists():
            report["present"].append(name)
            continue
        write_atomic(path, data)
        report["installed"].append(name)
    return report


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
