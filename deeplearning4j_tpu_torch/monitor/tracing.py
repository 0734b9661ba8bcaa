"""Low-overhead span tracing exported as Chrome trace-event JSON.

Counterpart of deeplearning4j_tpu/monitor/tracing.py. Spans are nestable
named intervals recorded per thread as ``B``/``E`` events; load an
exported file into Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``: each ``train_step`` span nests its ``wait``,
``fetch``, ``h2d``, ``stack``, ``step`` and ``callback`` children, and the
serving path shows ``http_request``, ``enqueue``, ``bucket``, ``pad``,
``device``, ``readback`` and the decode engine's ``decode_prefill``,
``decode_step``, ``spec_draft`` and ``spec_verify``.

A span reads the host clock only: it never synchronizes the card, so a
span around device work (a graph replay among it) measures its dispatch,
not its execution.

Fleet tracing: timestamps are anchored to the unix epoch, so spans of
several processes merge onto one timeline (``monitor/collect.py``). A
:class:`TraceContext` rides the ``x-trace-context`` HTTP header; while one
is installed (thread-local), every span records its ``trace_id`` and
``parent``.

Tracing is off by default; a disabled tracer's ``span()`` returns one
shared no-op context manager. Enable it in code (``trace.enable()``) or
from the environment::

    DL4JTPU_TRACE=1                 # collect; export manually
    DL4JTPU_TRACE=/tmp/step.json    # collect, and export at exit
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = [
    "Tracer", "trace", "get_tracer",
    "TraceContext", "set_context", "get_context", "trace_context",
]


# ------------------------------------------------------------- context
class TraceContext:
    """Dapper-style trace identity carried across process boundaries.

    ``trace_id`` names the whole request tree (the router mints it from
    the request id); ``parent`` names the span that caused this process
    to do work (e.g. the router attempt ``req-...#a1``). Serialized as
    the ``x-trace-context`` header: ``trace_id`` or ``trace_id;parent``.
    """

    __slots__ = ("trace_id", "parent")

    def __init__(self, trace_id: str, parent: str = ""):
        self.trace_id = trace_id
        self.parent = parent

    def child(self, parent: str) -> "TraceContext":
        return TraceContext(self.trace_id, parent)

    def to_header(self) -> str:
        return f"{self.trace_id};{self.parent}" if self.parent else self.trace_id

    @classmethod
    def from_header(cls, value) -> Optional["TraceContext"]:
        if not value:
            return None
        value = value.strip()
        if not value:
            return None
        trace_id, _, parent = value.partition(";")
        return cls(trace_id, parent)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"TraceContext({self.trace_id!r}, parent={self.parent!r})"


_CTX = threading.local()


def set_context(ctx: Optional[TraceContext]) -> None:
    """Install ``ctx`` as this thread's current trace context."""
    _CTX.ctx = ctx


def get_context() -> Optional[TraceContext]:
    return getattr(_CTX, "ctx", None)


class _CtxScope:
    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_CTX, "ctx", None)
        _CTX.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _CTX.ctx = self._prev
        return False


def trace_context(ctx: Optional[TraceContext]) -> _CtxScope:
    """``with trace_context(ctx): ...`` — install for a scope, restoring
    the previous context on exit (re-entrant, per-thread)."""
    return _CtxScope(ctx)


# ---------------------------------------------------------------- spans
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

    def __enter__(self):
        tr = self._tr
        ev = {"ph": "B", "name": self._name, "pid": tr._pid,
              "tid": threading.get_ident(),
              "ts": (tr._epoch + time.perf_counter()) * 1e6}
        args = self._args
        ctx = getattr(_CTX, "ctx", None)
        if ctx is not None:
            # never mutate self._args: argless spans are cached + shared
            args = dict(args) if args else {}
            args["trace_id"] = ctx.trace_id
            if ctx.parent:
                args["parent"] = ctx.parent
        if args:
            ev["args"] = args
        tr._events.append(ev)
        return self

    def __exit__(self, *exc):
        tr = self._tr
        tr._events.append(
            {"ph": "E", "name": self._name, "pid": tr._pid,
             "tid": threading.get_ident(),
             "ts": (tr._epoch + time.perf_counter()) * 1e6})
        return False


class Tracer:
    """Ring-buffered span recorder.

    ``capacity`` bounds memory: a deque(maxlen) of event dicts — at the
    default 200k events (~100k spans) a steady-state training loop keeps
    the most recent few thousand steps, which is what a stall
    investigation actually looks at.

    Timestamps are wall-clock microseconds (``time.time()`` anchored
    once, advanced by ``perf_counter`` so they stay monotonic within the
    process): every process shares the epoch, which is what lets
    ``monitor/collect.py`` merge ring buffers from N processes onto one
    Perfetto timeline."""

    def __init__(self, capacity: int = 200_000, enabled: bool = False):
        self._capacity = int(capacity)
        self._events = deque(maxlen=self._capacity)
        self._enabled = bool(enabled)
        self._pid = os.getpid()
        # wall-clock anchor: ts = (_epoch + perf_counter()) seconds
        self._epoch = time.time() - time.perf_counter()
        self._process_name = ""
        self._argless = {}

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, on: bool = True) -> "Tracer":
        self._enabled = bool(on)
        return self

    def set_process_name(self, name: str) -> "Tracer":
        """Name this process's track in merged fleet traces (emitted as a
        Chrome ``process_name`` metadata event on export)."""
        self._process_name = str(name)
        return self

    @property
    def process_name(self) -> str:
        return self._process_name

    def clear(self) -> "Tracer":
        # rebind rather than .clear(): a concurrent span/instant append
        # lands harmlessly in the old deque instead of racing the wipe
        self._events = deque(maxlen=self._capacity)
        return self

    def span(self, name: str, **args):
        """``with trace.span("step"): ...`` — nest freely; disabled
        tracing returns a shared no-op (near-zero cost)."""
        if not self._enabled:
            return _NULL_SPAN
        if not args:
            # argless spans (the hot-path kind) are immutable: cache one
            # instance per name instead of allocating per call
            s = self._argless.get(name)
            if s is None:
                s = self._argless[name] = _Span(self, name, None)
            return s
        return _Span(self, name, args)

    def instant(self, name: str, **args):
        """Point-in-time marker (Chrome ``i`` event)."""
        if not self._enabled:
            return
        ev = {"ph": "i", "name": name, "pid": self._pid,
              "tid": threading.get_ident(), "s": "t",
              "ts": (self._epoch + time.perf_counter()) * 1e6}
        ctx = getattr(_CTX, "ctx", None)
        if ctx is not None:
            args = dict(args) if args else {}
            args["trace_id"] = ctx.trace_id
        if args:
            ev["args"] = args
        self._events.append(ev)

    def events(self) -> list:
        return list(self._events)

    def export(self, path: Optional[str] = None) -> dict:
        """The Chrome trace-event document; written to ``path`` as JSON
        when given.

        Events are sorted by timestamp, and ``E`` events whose matching
        ``B`` fell off the ring (a wrap keeps the end of a span whose
        begin was dropped) are removed — an unbalanced ``E`` makes
        Perfetto close the *wrong* enclosing span, mis-nesting the whole
        track. A ``B`` without an ``E`` (span still open) is fine and is
        kept."""
        events = sorted(self._events, key=lambda e: e["ts"])
        kept, depth = [], {}
        for ev in events:
            ph = ev["ph"]
            if ph == "B":
                key = (ev["pid"], ev["tid"])
                depth[key] = depth.get(key, 0) + 1
            elif ph == "E":
                key = (ev["pid"], ev["tid"])
                d = depth.get(key, 0)
                if d <= 0:
                    continue  # orphan E: its B was dropped by the ring
                depth[key] = d - 1
            kept.append(ev)
        meta = []
        if self._process_name:
            meta.append({"ph": "M", "name": "process_name",
                         "pid": self._pid, "tid": 0,
                         "args": {"name": self._process_name}})
        doc = {"traceEvents": meta + kept, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


# ---------------------------------------------------------------- default
# The process-wide tracer every instrumented path records into (the span
# analog of metrics.get_registry()).
trace = Tracer()


def get_tracer() -> Tracer:
    return trace


_env = os.environ.get("DL4JTPU_TRACE", "")
if _env and _env.lower() not in ("0", "false", "off", "no"):
    trace.enable(True)
    if os.sep in _env or _env.endswith(".json"):
        atexit.register(trace.export, _env)
