"""The port's own native (C++) runtime piece: the ETL record readers and
the async batcher (recordreader.cpp).

Counterpart of deeplearning4j_tpu/native/__init__.py. The source is the
port's own copy; ``g++`` compiles it at first use into ``build/native/``
under a name that carries the source's sha256 and the flags (by temp file
and rename, so processes building at once never load a torn library), and
``ctypes`` loads it with the same signatures as the JAX package's.

``get_lib()`` returns the loaded library, or None when
``DL4J_TPU_NO_NATIVE`` is set or the build failed; a build that started
and failed is not swallowed: ``build_error()`` holds g++'s output and
``build_info()`` the library's path and the seconds g++ took (0 when an
earlier process built it).
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
from typing import Optional

_SRC = Path(__file__).resolve().parent / "recordreader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_tried = False
_lock = threading.Lock()
_info: dict = {"path": None, "seconds": 0.0, "error": None}


def _disabled() -> bool:
    return os.environ.get("DL4J_TPU_NO_NATIVE", "").lower() in (
        "1", "true", "yes", "on")


def lib_path() -> Path:
    """The library's build name: a digest of the source and the flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"librecordreader-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    out = lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        _info["error"] = "g++ not found: the record readers cannot be built"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}.so")
    cmd = [gxx, *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        _info["error"] = f"g++ failed to run: {e!r}"
        return None
    if proc.returncode != 0:
        _info["error"] = (f"g++ exited {proc.returncode}:\n"
                          f"{proc.stderr or proc.stdout}")
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    _info["seconds"] = time.perf_counter() - t0
    return out


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    c = ctypes
    lib.idx_load.argtypes = [
        c.c_char_p, c.c_char_p, c.c_int,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.POINTER(c.c_float), c.POINTER(c.c_float)]
    lib.idx_load.restype = c.c_int
    lib.csv_dims.argtypes = [c.c_char_p, c.c_int, c.c_char,
                             c.POINTER(c.c_int64), c.POINTER(c.c_int64)]
    lib.csv_dims.restype = c.c_int
    lib.csv_load.argtypes = [c.c_char_p, c.c_int, c.c_char,
                             c.c_int64, c.c_int, c.c_int,
                             c.POINTER(c.c_float), c.POINTER(c.c_float)]
    lib.csv_load.restype = c.c_int
    lib.batcher_create.argtypes = [
        c.POINTER(c.c_float), c.POINTER(c.c_float),
        c.c_int64, c.c_int64, c.c_int64, c.c_int64,
        c.c_int, c.c_uint64, c.c_int]
    lib.batcher_create.restype = c.c_void_p
    lib.batcher_next.argtypes = [c.c_void_p, c.POINTER(c.c_float),
                                 c.POINTER(c.c_float)]
    lib.batcher_next.restype = c.c_int64
    lib.batcher_reset.argtypes = [c.c_void_p]
    lib.batcher_destroy.argtypes = [c.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (disabled, or the build failed:
    see ``build_error()``)."""
    global _lib, _tried
    if _disabled():
        return None
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            so = _build()
            if so is not None:
                _lib = _bind(so)
                _info["path"] = str(so)
    return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """g++'s output when the build started and failed, else None."""
    return _info["error"]


def build_info() -> dict:
    """The loaded library's path, g++'s seconds in this process (0 when it
    was already built) and the build error, if any."""
    return dict(_info)
