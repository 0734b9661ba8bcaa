"""Low-overhead span tracing exported as Chrome trace-event JSON.

Counterpart of the part of deeplearning4j_tpu/monitor/tracing.py that the
fit path uses: ``Tracer`` with ``span``, ``enable``, ``events``, ``clear``
and ``export``, the process-wide ``trace``, and ``DL4JTPU_TRACE``. Spans
are nestable named intervals recorded per thread as ``B``/``E`` events;
load an exported file into Perfetto (https://ui.perfetto.dev) or
``chrome://tracing`` and each ``train_step`` span nests its ``wait``,
``fetch``, ``h2d``, ``stack``, ``step`` and ``callback`` children.

A span reads the host clock only: it never synchronizes the card, so a
span around device work measures its dispatch, not its execution.

Tracing is off by default; a disabled tracer's ``span()`` returns one
shared no-op context manager. Enable it in code (``trace.enable()``) or
from the environment::

    DL4JTPU_TRACE=1                 # collect; export manually
    DL4JTPU_TRACE=/tmp/step.json    # collect, and export at exit

Trace contexts (the fleet's ``x-trace-context``), instant events and
process names wait for the serving fleet's modules.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["Tracer", "trace", "get_tracer"]


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_args")

    def __init__(self, tr, name, args):
        self._tr = tr
        self._name = name
        self._args = args

    def _event(self, ph):
        tr = self._tr
        return {"ph": ph, "name": self._name, "pid": tr._pid,
                "tid": threading.get_ident(),
                "ts": (tr._epoch + time.perf_counter()) * 1e6}

    def __enter__(self):
        ev = self._event("B")
        if self._args:
            ev["args"] = self._args
        self._tr._events.append(ev)
        return self

    def __exit__(self, *exc):
        self._tr._events.append(self._event("E"))
        return False


class Tracer:
    """Ring-buffered span recorder: at most ``capacity`` events are kept
    (the oldest are dropped). Timestamps are wall-clock microseconds
    (``time.time()`` anchored once, advanced by ``perf_counter``)."""

    def __init__(self, capacity: int = 200_000, enabled: bool = False):
        self._capacity = int(capacity)
        self._events = deque(maxlen=self._capacity)
        self._enabled = bool(enabled)
        self._pid = os.getpid()
        self._epoch = time.time() - time.perf_counter()
        self._argless = {}

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True) -> "Tracer":
        self._enabled = bool(on)
        return self

    def clear(self) -> "Tracer":
        # rebind rather than .clear(): a concurrent append lands in the
        # old deque instead of racing the wipe
        self._events = deque(maxlen=self._capacity)
        return self

    def span(self, name: str, **args):
        """``with trace.span("step"): ...``: nest freely; a disabled tracer
        returns a shared no-op."""
        if not self._enabled:
            return _NULL_SPAN
        if not args:
            # argless spans (the hot-path kind) are immutable: one
            # instance per name
            s = self._argless.get(name)
            if s is None:
                s = self._argless[name] = _Span(self, name, None)
            return s
        return _Span(self, name, args)

    def events(self) -> list:
        return list(self._events)

    def export(self, path: Optional[str] = None) -> dict:
        """The Chrome trace-event document, written to ``path`` as JSON
        when given. Events are sorted by timestamp, and an ``E`` whose
        ``B`` fell off the ring is dropped (Perfetto would close the wrong
        span with it); a ``B`` still open is kept."""
        events = sorted(self._events, key=lambda e: e["ts"])
        kept, depth = [], {}
        for ev in events:
            key = (ev["pid"], ev["tid"])
            if ev["ph"] == "B":
                depth[key] = depth.get(key, 0) + 1
            elif ev["ph"] == "E":
                if depth.get(key, 0) <= 0:
                    continue
                depth[key] -= 1
            kept.append(ev)
        doc = {"traceEvents": kept, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


# the process-wide tracer every instrumented path records into
trace = Tracer()


def get_tracer() -> Tracer:
    return trace


_env = os.environ.get("DL4JTPU_TRACE", "")
if _env and _env.lower() not in ("0", "false", "off", "no"):
    trace.enable(True)
    if os.sep in _env or _env.endswith(".json"):
        atexit.register(trace.export, _env)
