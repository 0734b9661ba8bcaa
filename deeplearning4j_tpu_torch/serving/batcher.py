"""Dynamic micro-batching: coalesce concurrent requests into one forward.

Counterpart of deeplearning4j_tpu/serving/batcher.py, with its registry
cells and its request journal (its trace spans are not ported). A bounded
queue is drained by one worker under a max-latency / max-batch policy;
requests whose rows share one shape merge, and each is answered with its
slice of the merged result. Every exit of a request -- served, shed,
expired, stopped or failed -- leaves exactly one terminal record in
``self.journal`` (``ok``, ``shed``, ``deadline`` or ``error``), a served
one with the merged call's phases (queue, bucket, pad, device, readback).

Overload protection:

- the queue is bounded; ``submit(block=False)`` sheds load at once with
  ``ServerOverloadedError`` (HTTP 429 upstairs), and blocking submits give
  up after ``submit_timeout`` seconds;
- a request may carry a deadline; an expired request is answered with
  ``DeadlineExceededError`` at pop and again right before dispatch, so it
  never rides a forward;
- ``stop()`` drains: new submits fail with ``BatcherStoppedError``, the
  worker flushes what is queued, and every Future settles.
"""

from __future__ import annotations

import inspect
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.monitor.metrics import (
    DEFAULT_LATENCY_BUCKETS, get_registry)
from deeplearning4j_tpu_torch.monitor.reqlog import RequestLog, new_record
from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, DeadlineExceededError, ServerOverloadedError)


class MicroBatcher:
    """Merge concurrent ``submit()`` batches into single engine calls.

    ``engine``: anything with ``predict_host``. ``max_batch``: merged rows
    per call. ``max_latency_ms``: how long the worker waits for
    co-travellers after the first request of a batch arrives.
    ``journal_capacity``: the records the request journal keeps."""

    _ids = itertools.count()

    def __init__(self, engine, max_batch: int = 256,
                 max_latency_ms: float = 2.0, max_queue: int = 1024,
                 submit_timeout: Optional[float] = 30.0,
                 journal_capacity: int = 512):
        self.engine = engine
        self.journal = RequestLog(journal_capacity)
        # phases need predict_host(phases=); anything else still serves
        try:
            self._phases_ok = "phases" in inspect.signature(
                engine.predict_host).parameters
        except (AttributeError, TypeError, ValueError):
            self._phases_ok = False
        self.max_batch = int(max_batch)
        self.max_latency_ms = float(max_latency_ms)
        self.max_queue = int(max_queue)
        self.submit_timeout = submit_timeout
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        # gates every enqueue AND the stopping-flag flip: a submit never
        # slips into the queue after stop() started rejecting
        self._state_lock = threading.Lock()
        # the serving counters live in the process-wide registry, so
        # /stats and /metrics read the same cells
        self.id = f"batcher{next(MicroBatcher._ids)}"
        reg = get_registry()
        lab = {"batcher": self.id}
        self._m_requests = reg.counter(
            "dl4jtpu_serving_requests_total",
            "Requests answered by the micro-batcher.",
            ("batcher",)).labels(**lab)
        self._m_rows = reg.counter(
            "dl4jtpu_serving_rows_total",
            "Rows answered by the micro-batcher.", ("batcher",)).labels(**lab)
        self._m_device_calls = reg.counter(
            "dl4jtpu_serving_device_calls_total",
            "Merged device calls issued (avg merge = requests / calls).",
            ("batcher",)).labels(**lab)
        rejected = reg.counter(
            "dl4jtpu_serving_rejected_total",
            "Requests shed instead of served. reason: queue_full (429) | "
            "stopped (503) | deadline (504, answered before any device "
            "call).", ("batcher", "reason"))
        self._m_rejected = {r: rejected.labels(batcher=self.id, reason=r)
                            for r in ("queue_full", "stopped", "deadline")}
        self._m_latency = reg.histogram(
            "dl4jtpu_serving_request_latency_seconds",
            "End-to-end request latency: submit() to future resolution "
            "(queueing + merge wait + device call + readback).",
            ("batcher",), buckets=DEFAULT_LATENCY_BUCKETS).labels(**lab)
        self._m_queue = reg.histogram(
            "dl4jtpu_predict_queue_seconds",
            "Time a /predict request waited in the micro-batch queue: "
            "submit() to dispatch of its merged device call.",
            ("batcher",), buckets=DEFAULT_LATENCY_BUCKETS).labels(**lab)
        reg.gauge(
            "dl4jtpu_serving_queue_depth",
            "Requests waiting in the micro-batch queue right now.",
            ("batcher",)).labels(**lab).set_function(self._q.qsize)

    def _reject(self, item, reason, outcome, now=None):
        self._m_rejected[reason].inc()
        self._journal_terminal(item, outcome, now=now)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            return self
        self._stopping.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Graceful drain: stop accepting, flush what is queued, join."""
        with self._state_lock:
            self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        with self._state_lock:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if not item[1].done():
                    self._reject(item, "stopped", "error")
                    item[1].set_exception(
                        BatcherStoppedError("micro-batcher stopped"))

    @property
    def stopping(self) -> bool:
        return self._stopping.is_set()

    # -------------------------------------------------------------- serving
    def submit(self, x, deadline_ms: Optional[float] = None,
               block: bool = True, request_id: Optional[str] = None,
               tenant: str = "default", priority: str = "normal") -> Future:
        """Queue a request batch (n, features...); returns a Future whose
        result is the (n, ...) output slice as numpy. ``request_id``,
        ``tenant`` and ``priority`` identify it in the journal."""
        x = np.asarray(x)
        t0 = time.perf_counter()
        expires = None if deadline_ms is None else t0 + deadline_ms / 1000.0
        fut: Future = Future()
        meta = {"rid": request_id, "tenant": tenant, "priority": priority}
        item = (x, fut, t0, expires, meta)
        give_up_at = (None if self.submit_timeout is None
                      else t0 + self.submit_timeout)
        while True:
            with self._state_lock:
                if self._stopping.is_set():
                    self._reject(item, "stopped", "error")
                    raise BatcherStoppedError(
                        "micro-batcher is draining/stopped; submit() rejected")
                if self._thread is None:
                    self.start()
                try:
                    self._q.put_nowait(item)
                    return fut
                except queue.Full:
                    pass
            if not block or (give_up_at is not None
                             and time.perf_counter() >= give_up_at):
                self._reject(item, "queue_full", "shed")
                raise ServerOverloadedError(
                    f"serving queue full ({self.max_queue} waiting); "
                    "load shed")
            time.sleep(0.002)

    def _journal_terminal(self, item, outcome, now: Optional[float] = None,
                          **extra) -> None:
        """Append the ONE terminal record of a request."""
        x, _, t0, _, meta = item
        now = time.perf_counter() if now is None else now
        rec = new_record(
            meta["rid"], "predict", outcome=outcome, tenant=meta["tenant"],
            priority=meta["priority"], batcher=self.id,
            rows=int(x.shape[0]), wall_seconds=now - t0)
        rec.update(extra)
        self.journal.append(rec)

    # --------------------------------------------------------------- worker
    def _expired(self, item, now) -> bool:
        expires = item[3]
        if expires is None or now < expires:
            return False
        if not item[1].done():
            self._reject(item, "deadline", "deadline", now=now)
            item[1].set_exception(DeadlineExceededError(
                "request deadline expired before dispatch "
                f"({(now - item[2]) * 1e3:.1f} ms in queue)"))
        return True

    def _worker(self):
        held = None     # a request of another row shape than the last batch
        while True:
            if held is not None:
                first, held = held, None
            else:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    if self._stopping.is_set():
                        return
                    continue
            if self._expired(first, time.perf_counter()):
                continue
            batch = [first]
            total = first[0].shape[0]
            wait_until = time.perf_counter() + self.max_latency_ms / 1000.0
            while total < self.max_batch:
                remaining = wait_until - time.perf_counter()
                try:
                    item = (self._q.get_nowait() if remaining <= 0
                            else self._q.get(timeout=remaining))
                except queue.Empty:
                    break
                if self._expired(item, time.perf_counter()):
                    continue
                if item[0].shape[1:] != first[0].shape[1:]:
                    # rows of another shape (say, a sequence of another
                    # length) cannot be concatenated: it heads the next batch
                    held = item
                    break
                batch.append(item)
                total += item[0].shape[0]
                if remaining <= 0:
                    break
            now = time.perf_counter()
            batch = [it for it in batch if not self._expired(it, now)]
            if not batch:
                continue
            total = sum(it[0].shape[0] for it in batch)
            # the queue phase ends here for every rider of the call
            for it in batch:
                self._m_queue.observe(now - it[2], exemplar=it[4]["rid"])
            try:
                merged = (batch[0][0] if len(batch) == 1
                          else np.concatenate([b[0] for b in batch]))
                # the merged call's phases, shared by its riders' records
                ph = {} if self._phases_ok else None
                out = (self.engine.predict_host(merged, phases=ph)
                       if ph is not None else self.engine.predict_host(merged))
                done = time.perf_counter()
                ofs = 0
                for item in batch:
                    x, fut, t0, _, meta = item
                    fut.set_result(out[ofs:ofs + x.shape[0]])
                    ofs += x.shape[0]
                    self._m_latency.observe(done - t0, exemplar=meta["rid"])
                    self._journal_terminal(
                        item, "ok", now=done,
                        phases=dict({"queue": now - t0}, **(ph or {})),
                        batch=len(batch))
                self._m_requests.inc(len(batch))
                self._m_rows.inc(total)
                self._m_device_calls.inc()
            except Exception as e:  # noqa: BLE001 -- answer every caller
                for item in batch:
                    if not item[1].done():
                        self._journal_terminal(item, "error")
                        item[1].set_exception(e)

    # ---------------------------------------------------------------- stats
    def _slo_stats(self) -> dict:
        """Percentiles and each bucket's last exemplar (a request id)."""
        def block(h):
            p50, p99 = h.percentile(0.5), h.percentile(0.99)
            return {"count": int(h.count),
                    "p50_ms": None if p50 is None else round(p50 * 1e3, 4),
                    "p99_ms": None if p99 is None else round(p99 * 1e3, 4),
                    "exemplars": [
                        ["+Inf" if b == float("inf") else b, rid, v]
                        for b, rid, v in h.exemplars()]}
        return {"queue": block(self._m_queue),
                "latency": block(self._m_latency)}

    def stats(self) -> dict:
        requests = int(self._m_requests.value)
        calls = int(self._m_device_calls.value)
        p50 = self._m_latency.percentile(0.5)
        p99 = self._m_latency.percentile(0.99)
        return {"id": self.id,
                "requests": requests, "rows": int(self._m_rows.value),
                "device_calls": calls,
                "avg_merge": requests / calls if calls else 0.0,
                "queue_depth": self._q.qsize(),
                "queue_capacity": self.max_queue,
                "rejected": {k: int(c.value)
                             for k, c in self._m_rejected.items()},
                "state": "draining" if self.stopping else "serving",
                "latency_p50_ms": None if p50 is None else p50 * 1e3,
                "latency_p99_ms": None if p99 is None else p99 * 1e3,
                "slo": self._slo_stats(),
                "journal": {"capacity": self.journal.capacity,
                            "records": len(self.journal),
                            "total": self.journal.total,
                            "dropped": self.journal.dropped},
                "max_batch": self.max_batch,
                "max_latency_ms": self.max_latency_ms}
