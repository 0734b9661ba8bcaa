"""On-demand device profiling around live traffic and training.

Counterpart of deeplearning4j_tpu/monitor/profiling.py, on
``torch.profiler`` (CPU activity, and CUDA activity where a card is
present: CUPTI records every kernel, those replayed from CUDA graphs and
the hand-written ones launched through ctypes among them). Each session
writes one Chrome trace (``trace_<pid>_<n>.json``) into its directory.

- ``POST /admin/profile {"seconds": S, "dir": D}`` on the inference
  server calls :func:`start_profile`: a thread starts the profiler, keeps
  it on for ``S`` seconds of live traffic, stops it and writes the trace.
  One session at a time per process (the server answers 409 meanwhile).
  A profiler that cannot start raises ``RuntimeError`` (the server's 503
  ``profiler_unavailable``); the directory is made only when a trace is
  written into it.
- ``DL4JTPU_PROFILE=/dir python train.py`` wraps each ``fit()`` call of
  both containers in :func:`profile_scope`.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager

import torch

__all__ = ["start_profile", "profile_status", "profile_scope",
           "PROFILE_ENV"]

PROFILE_ENV = "DL4JTPU_PROFILE"

_lock = threading.Lock()
_active = None        # {"dir", "seconds", "started_at"} while running
_last = None          # the last finished session: {"dir", "trace"|"error"}
_n = itertools.count()


def _profiler(all_threads=False):
    """A ``torch.profiler.profile`` over CPU and (with a card) CUDA
    activity; ``all_threads``: the operations of every thread, not only
    the starting one's (live traffic runs on the server's threads), where
    this PyTorch offers it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    config = None
    if all_threads:
        try:
            config = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except (AttributeError, TypeError):
            config = None
    return torch.profiler.profile(activities=acts,
                                  experimental_config=config)


def _export(prof, log_dir) -> str:
    """Write ``prof``'s Chrome trace into ``log_dir`` (made here if
    missing, and removed again if the write fails there)."""
    made = not os.path.isdir(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_n)}.json")
    try:
        prof.export_chrome_trace(path)
    except BaseException:
        if made and not os.listdir(log_dir):
            os.rmdir(log_dir)
        raise
    return path


def profile_status() -> dict:
    """``{"profiling": True, "dir", "seconds", "started_at"}`` while a
    session runs, else ``{"profiling": False}``; ``last`` names the last
    finished session's trace (or its error)."""
    with _lock:
        out = ({"profiling": False} if _active is None
               else {"profiling": True, **_active})
        if _last is not None:
            out["last"] = dict(_last)
        return out


def start_profile(log_dir: str, seconds: float = 5.0) -> dict:
    """Profile the next ``seconds`` of this process into ``log_dir``.

    Returns the session descriptor once the profiler runs (the stop and
    the export run on the session's thread). Raises ``ValueError`` for a
    bad argument and ``RuntimeError`` if a session is already running or
    the profiler cannot start."""
    seconds = float(seconds)
    if not (0.0 < seconds <= 600.0):
        raise ValueError(f"seconds must be in (0, 600], got {seconds}")
    if not log_dir:
        raise ValueError("dir is required")
    global _active
    with _lock:
        if _active is not None:
            raise RuntimeError("a profiling session is already running")
        _active = {"dir": str(log_dir), "seconds": seconds,
                   "started_at": time.time()}
    started = threading.Event()
    failure = []

    def session():
        global _active, _last
        try:
            prof = _profiler(all_threads=True)
            prof.start()
        except Exception as e:  # noqa: BLE001 -- reported to the caller
            failure.append(e)
            with _lock:
                _active = None
            started.set()
            return
        started.set()
        time.sleep(seconds)
        try:
            prof.stop()
            last = {"dir": str(log_dir), "trace": _export(prof, log_dir)}
        except Exception as e:  # noqa: BLE001 -- kept for profile_status
            last = {"dir": str(log_dir), "error": f"{type(e).__name__}: {e}"}
        with _lock:
            _last = last
            _active = None

    threading.Thread(target=session, name="profile-session",
                     daemon=True).start()
    started.wait()
    if failure:
        raise RuntimeError(f"profiler unavailable: {failure[0]}")
    return {"profiling": str(log_dir), "seconds": seconds}


@contextmanager
def profile_scope(env: str = PROFILE_ENV):
    """Profile the block into the directory ``$DL4JTPU_PROFILE`` names (one
    Chrome trace); a plain pass-through when it is unset or the profiler
    cannot start."""
    log_dir = os.environ.get(env, "").strip()
    if not log_dir:
        yield
        return
    try:
        prof = _profiler()
        prof.start()
    except Exception:  # noqa: BLE001 -- profiling never stops a fit
        yield
        return
    try:
        yield
    finally:
        prof.stop()
        _export(prof, log_dir)
