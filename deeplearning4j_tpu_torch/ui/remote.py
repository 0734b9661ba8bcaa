"""Async remote stats transport: train in one process, watch the UI in
another, without ever blocking the train loop on the network.

Counterpart of deeplearning4j_tpu/ui/remote.py (parity surface: the
reference's WebReporter, a background thread draining a queue of UI
POSTs). The wire format lives in one place, the synchronous
``RemoteUIStatsStorageRouter`` (ui/storage.py), which ``WebReporter``
wraps with a bounded queue, a drain thread and retry through
``resilience.retry``. It is shaped like a StatsStorage, so every UI
listener that writes through that interface becomes remote:

    reporter = WebReporter("http://ui-host:9000")
    net.add_listeners(StatsListener(reporter, frequency=10),
                      ConvolutionalIterationListener(reporter))

A full queue drops records (counted in ``dropped``) and a down collector
never blocks ``fit``.
"""

from __future__ import annotations

import queue
import threading
import time

from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call
from deeplearning4j_tpu_torch.ui.storage import RemoteUIStatsStorageRouter


class WebReporter:
    """StatsStorage-shaped async wrapper around RemoteUIStatsStorageRouter.

    Deliveries drain on a background thread through a bounded queue
    (WebReporter.java semantics): a slow or down collector never stalls
    training; on overflow or exhausted retries, records are counted in
    ``dropped`` instead of blocking."""

    def __init__(self, base_url: str, queue_size: int = 256,
                 retries: int = 3, timeout: float = 2.0):
        self._router = RemoteUIStatsStorageRouter(base_url, timeout=timeout)
        self.retries = retries
        # UI delivery is best-effort: retry EVERY failure (the old loop's
        # semantics) but now with backoff, through the shared primitive —
        # attempts land in dl4jtpu_retry_attempts_total{component="ui_remote"}
        self._policy = RetryPolicy(max_attempts=retries, base_delay=0.02,
                                   max_delay=0.5, classify=lambda e: True)
        self.dropped = 0
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._pending = 0                    # enqueued but not yet settled
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    # ---------------------------------------------- StatsStorage interface
    def put_static_info(self, session_id: str, info: dict):
        self._enqueue(("put_static_info", (session_id, info)))

    def put_update(self, report):
        self._enqueue(("put_update", (report,)))

    # ------------------------------------------------------------ plumbing
    def _enqueue(self, item):
        with self._lock:
            try:
                self._q.put_nowait(item)
                self._pending += 1
            except queue.Full:
                self.dropped += 1    # never stall the training loop

    def _drain(self):
        while not self._closed.is_set():
            try:
                method, args = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            ok = False
            try:
                retry_call(getattr(self._router, method), *args,
                           policy=self._policy, component="ui_remote",
                           give_up=self._closed.is_set)
                ok = True
            except Exception:   # noqa: BLE001 — exhausted/aborted: drop
                pass
            with self._lock:
                self._pending -= 1
                if not ok:
                    self.dropped += 1

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every enqueued record is SETTLED (delivered or given
        up after retries) — not merely dequeued; a single in-flight record
        may spend up to retries*timeout in delivery attempts. Returns True
        when everything settled, False on timeout (records still pending)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.02)
        return False

    def close(self):
        """Flush, stop the worker, and account for records still QUEUED:
        they count in ``dropped`` (dropped == 0 after close() means every
        record was delivered). A record the worker is mid-delivery on is
        left to the worker's own settle accounting (it may yet succeed) —
        close() never touches it, so nothing is ever counted twice."""
        self.flush()
        self._closed.set()
        self._worker.join(timeout=2.0)
        drained = 0
        while True:
            try:
                self._q.get_nowait()
                drained += 1
            except queue.Empty:
                break
        with self._lock:
            self._pending -= drained
            self.dropped += drained
