"""Dynamic micro-batching: coalesce concurrent requests into one forward.

Counterpart of deeplearning4j_tpu/serving/batcher.py (without its metrics
registry, traces and request journal, which are not ported yet). A bounded
queue is drained by one worker under a max-latency / max-batch policy;
requests whose rows share one shape merge, and each is answered with its
slice of the merged result.

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

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, DeadlineExceededError, ServerOverloadedError)


class MicroBatcher:
    """Merge concurrent ``submit()`` batches into single engine calls.

    ``engine``: anything with ``predict_host``. ``max_batch``: merged rows
    per call. ``max_latency_ms``: how long the worker waits for
    co-travellers after the first request of a batch arrives."""

    def __init__(self, engine, max_batch: int = 256,
                 max_latency_ms: float = 2.0, max_queue: int = 1024,
                 submit_timeout: Optional[float] = 30.0):
        self.engine = engine
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
        self._stats_lock = threading.Lock()
        self._counts = dict.fromkeys(("requests", "rows", "device_calls",
                                      "queue_full", "stopped", "deadline"), 0)
        self._latencies = []

    def _count(self, **kw):
        with self._stats_lock:
            for k, v in kw.items():
                self._counts[k] += v

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
                    self._count(stopped=1)
                    item[1].set_exception(
                        BatcherStoppedError("micro-batcher stopped"))

    @property
    def stopping(self) -> bool:
        return self._stopping.is_set()

    # -------------------------------------------------------------- serving
    def submit(self, x, deadline_ms: Optional[float] = None,
               block: bool = True) -> Future:
        """Queue a request batch (n, features...); returns a Future whose
        result is the (n, ...) output slice as numpy."""
        x = np.asarray(x)
        t0 = time.perf_counter()
        expires = None if deadline_ms is None else t0 + deadline_ms / 1000.0
        fut: Future = Future()
        item = (x, fut, t0, expires)
        give_up_at = (None if self.submit_timeout is None
                      else t0 + self.submit_timeout)
        while True:
            with self._state_lock:
                if self._stopping.is_set():
                    self._count(stopped=1)
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
                self._count(queue_full=1)
                raise ServerOverloadedError(
                    f"serving queue full ({self.max_queue} waiting); "
                    "load shed")
            time.sleep(0.002)

    # --------------------------------------------------------------- worker
    def _expired(self, item, now) -> bool:
        expires = item[3]
        if expires is None or now < expires:
            return False
        if not item[1].done():
            self._count(deadline=1)
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
            try:
                merged = (batch[0][0] if len(batch) == 1
                          else np.concatenate([b[0] for b in batch]))
                out = self.engine.predict_host(merged)
                done = time.perf_counter()
                ofs = 0
                for x, fut, t0, _ in batch:
                    fut.set_result(out[ofs:ofs + x.shape[0]])
                    ofs += x.shape[0]
                    with self._stats_lock:
                        self._latencies.append(done - t0)
                        del self._latencies[:-4096]
                self._count(requests=len(batch), rows=total, device_calls=1)
            except Exception as e:  # noqa: BLE001 -- answer every caller
                for item in batch:
                    if not item[1].done():
                        item[1].set_exception(e)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._latencies)
            c = dict(self._counts)
        out = {"requests": c["requests"], "rows": c["rows"],
               "device_calls": c["device_calls"],
               "avg_merge": (c["requests"] / c["device_calls"]
                             if c["device_calls"] else 0.0),
               "rejected": {k: c[k] for k in ("queue_full", "stopped",
                                              "deadline")}}
        out.update({
            "queue_depth": self._q.qsize(),
            "queue_capacity": self.max_queue,
            "state": "draining" if self.stopping else "serving",
            "latency_p50_ms": lat[len(lat) // 2] * 1e3 if lat else None,
            "latency_p99_ms": (lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                               * 1e3 if lat else None),
            "max_batch": self.max_batch,
            "max_latency_ms": self.max_latency_ms})
        return out
