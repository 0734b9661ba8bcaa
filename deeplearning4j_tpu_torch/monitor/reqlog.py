"""The request journal: one terminal record per request.

Counterpart of deeplearning4j_tpu/monitor/reqlog.py, the same records and
the same ring. Every request appends ONE record at its terminal outcome --
completions and rejections alike (shed, deadline, stopped) -- carrying its
whole lifecycle: identity, outcome, phase attribution, token and KV
accounting. A percentile that got worse then links, through a histogram
bucket's exemplar, to a concrete record.

The ring is a ``deque(maxlen=capacity)``: appends are O(1), the oldest
record goes first, and ``total`` keeps counting, so ``dropped = total -
len`` shows that the journal wrapped. ``tail(n)`` (newest last) is what
``GET /requests?n=`` serves, the /predict and /generate rings merged.

Records are plain dicts (JSON-ready). ``new_record`` stamps the common
identity fields; writers add their own:

- ``source="decode"``: ``phases`` {queue, prefill, decode, verify},
  ``tokens_in`` / ``tokens_out``, ``spec`` {drafted, accepted}, ``kv``
  {peak_blocks, prefix_hit_depth, host_restores}.
- ``source="predict"``: ``phases`` {queue, bucket, pad, device,
  readback}, ``rows``, ``batch``.

``trace_id`` stays None in the port: the tracer's trace contexts are not
ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["RequestLog", "new_record"]

#: terminal outcomes a record may carry (informational, not enforced)
OUTCOMES = ("ok", "eos", "max_new", "shed", "deadline", "error",
            "failed_over", "hedge_win")


def new_record(request_id: Optional[str], source: str, **fields) -> dict:
    """A journal record with the common identity fields stamped. ``ts`` is
    wall-clock epoch seconds at terminal time, so records of different
    processes merge onto one timeline."""
    rec = {"request_id": request_id,
           "source": source,
           "ts": time.time(),
           "trace_id": None,
           "outcome": None,
           "tenant": "default",
           "priority": "normal",
           "wall_seconds": None}
    rec.update(fields)
    return rec


class RequestLog:
    """Bounded, thread-safe ring of terminal request records; when full,
    the oldest record is dropped."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(int(capacity), 1)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0

    def append(self, record: dict) -> dict:
        with self._lock:
            self._total += 1
            self._ring.append(record)
        return record

    def tail(self, n: Optional[int] = None) -> List[dict]:
        """The newest ``n`` records, oldest first (all when ``n`` is None;
        ``n <= 0`` gives [])."""
        with self._lock:
            recs = list(self._ring)
        if n is None:
            return recs
        n = int(n)
        return recs[-n:] if n > 0 else []

    def find(self, request_id: str) -> Optional[dict]:
        """The newest record of ``request_id``, or None."""
        with self._lock:
            recs = list(self._ring)
        for rec in reversed(recs):
            if rec.get("request_id") == request_id:
                return rec
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total(self) -> int:
        """Records ever appended, dropped ones included."""
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._total - len(self._ring)

    def clear(self) -> "RequestLog":
        with self._lock:
            self._ring.clear()
            self._total = 0
        return self

    def snapshot(self, n: Optional[int] = None) -> dict:
        """The ring's accounting and its newest ``n`` records."""
        with self._lock:
            recs = list(self._ring)
            total = self._total
        dropped = total - len(recs)
        if n is not None:
            n = int(n)
            recs = recs[-n:] if n > 0 else []
        return {"capacity": self.capacity,
                "total": total,
                "dropped": dropped,
                "records": recs}
