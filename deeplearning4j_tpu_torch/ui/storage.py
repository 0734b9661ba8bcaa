"""Stats storage: pub/sub persistence for training metrics.

Counterpart of the part of deeplearning4j_tpu/ui/storage.py that
``StatsListener`` writes to: ``StatsReport`` (one iteration's record and
its binary form, byte for byte the JAX package's: a fixed header and
length-prefixed sections packed with ``struct``, so a record or a
``FileStatsStorage`` log written by either package reads in the other),
the ``StatsStorage`` interface with its listeners, ``InMemoryStatsStorage``
and ``FileStatsStorage`` (an append-only log of framed records), and
``RemoteUIStatsStorageRouter``, which POSTs records to a remote
``UIServer``'s /remote route in the same JSON as the JAX package's.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Callable

_MAGIC = b"DLTS"
_VERSION = 1


@dataclass
class StatsReport:
    """One iteration's stats (parity: SbeStatsReport fields the UI uses)."""
    session_id: str
    worker_id: str = "worker_0"
    timestamp: float = 0.0
    iteration: int = 0
    epoch: int = 0
    score: float = float("nan")
    # performance
    iteration_time_ms: float = 0.0
    samples_per_sec: float = 0.0
    batches_per_sec: float = 0.0
    # memory (bytes)
    mem_rss: int = 0
    mem_jvm_equiv: int = 0          # host process heap proxy
    # per-param-group summaries: name -> {"mean":…, "std":…, "norm":…}
    param_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    update_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    activation_mean_mag: float = float("nan")
    learning_rates: Dict[str, float] = field(default_factory=dict)

    # ------------------------------------------------------------- binary
    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        sid = self.session_id.encode()
        wid = self.worker_id.encode()
        buf.write(struct.pack("<4sBHH", _MAGIC, _VERSION, len(sid), len(wid)))
        buf.write(sid)
        buf.write(wid)
        buf.write(struct.pack("<diid", self.timestamp, self.iteration,
                              self.epoch, self.score))
        buf.write(struct.pack("<dddqq", self.iteration_time_ms,
                              self.samples_per_sec, self.batches_per_sec,
                              self.mem_rss, self.mem_jvm_equiv))
        buf.write(struct.pack("<d", self.activation_mean_mag))
        blob = json.dumps({"p": self.param_stats, "u": self.update_stats,
                           "lr": self.learning_rates}).encode()
        buf.write(struct.pack("<I", len(blob)))
        buf.write(blob)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "StatsReport":
        buf = io.BytesIO(data)
        magic, ver, ls, lw = struct.unpack("<4sBHH", buf.read(9))
        if magic != _MAGIC:
            raise ValueError("not a StatsReport record")
        if ver != _VERSION:
            raise ValueError(f"unsupported StatsReport version {ver}")
        sid = buf.read(ls).decode()
        wid = buf.read(lw).decode()
        ts, it, ep, score = struct.unpack("<diid", buf.read(24))
        itms, sps, bps, rss, heap = struct.unpack("<dddqq", buf.read(40))
        (amm,) = struct.unpack("<d", buf.read(8))
        (ln,) = struct.unpack("<I", buf.read(4))
        extra = json.loads(buf.read(ln).decode())
        return StatsReport(session_id=sid, worker_id=wid, timestamp=ts,
                           iteration=it, epoch=ep, score=score,
                           iteration_time_ms=itms, samples_per_sec=sps,
                           batches_per_sec=bps, mem_rss=rss,
                           mem_jvm_equiv=heap, activation_mean_mag=amm,
                           param_stats=extra["p"], update_stats=extra["u"],
                           learning_rates=extra["lr"])

    def to_json(self) -> dict:
        return {
            "sessionId": self.session_id, "workerId": self.worker_id,
            "timestamp": self.timestamp, "iteration": self.iteration,
            "epoch": self.epoch, "score": self.score,
            "iterationTimeMs": self.iteration_time_ms,
            "samplesPerSec": self.samples_per_sec,
            "batchesPerSec": self.batches_per_sec,
            "memRss": self.mem_rss,
            "activationMeanMag": self.activation_mean_mag,
            "paramStats": self.param_stats, "updateStats": self.update_stats,
            "learningRates": self.learning_rates,
        }


class StatsStorage:
    """Interface + pub/sub (parity: StatsStorage.java +
    StatsStorageListener). put_update routes to storage AND notifies
    listeners (the UI subscribes for live charts)."""

    def __init__(self):
        self._listeners: List[Callable[[StatsReport], None]] = []
        self._static: Dict[str, dict] = {}
        self._lock = threading.Lock()

    # router side --------------------------------------------------------
    def put_static_info(self, session_id: str, info: dict):
        with self._lock:
            self._static[session_id] = info

    def put_update(self, report: StatsReport):
        self._store(report)
        for l in list(self._listeners):
            l(report)

    # reader side --------------------------------------------------------
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def get_all_updates(self, session_id: str) -> List[StatsReport]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str) -> Optional[StatsReport]:
        ups = self.get_all_updates(session_id)
        return ups[-1] if ups else None

    def get_static_info(self, session_id: str) -> Optional[dict]:
        return self._static.get(session_id)

    def register_stats_listener(self, fn: Callable[[StatsReport], None]):
        self._listeners.append(fn)

    def _store(self, report: StatsReport):
        raise NotImplementedError

    def close(self):
        pass


class InMemoryStatsStorage(StatsStorage):
    """Parity: ui-model storage InMemoryStatsStorage."""

    def __init__(self):
        super().__init__()
        self._updates: Dict[str, List[StatsReport]] = {}

    def _store(self, report: StatsReport):
        with self._lock:
            self._updates.setdefault(report.session_id, []).append(report)

    def list_session_ids(self):
        with self._lock:
            return sorted(self._updates)

    def get_all_updates(self, session_id):
        with self._lock:
            return list(self._updates.get(session_id, []))


class FileStatsStorage(StatsStorage):
    """Append-only framed binary log (parity: the MapDB-backed
    FileStatsStorage — same role: persist a run, reopen later in the UI).
    Frame = <u32 length><record bytes>."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._cache: Dict[str, List[StatsReport]] = {}
        if os.path.exists(path):
            self._load()
        self._fh = open(path, "ab")

    def _load(self):
        with open(self.path, "rb") as fh:
            while True:
                hdr = fh.read(4)
                if len(hdr) < 4:
                    break
                (n,) = struct.unpack("<I", hdr)
                rec = fh.read(n)
                if len(rec) < n:
                    break  # truncated tail (crash mid-write) — ignore
                r = StatsReport.from_bytes(rec)
                self._cache.setdefault(r.session_id, []).append(r)

    def _store(self, report: StatsReport):
        data = report.to_bytes()
        with self._lock:
            self._fh.write(struct.pack("<I", len(data)))
            self._fh.write(data)
            self._fh.flush()
            self._cache.setdefault(report.session_id, []).append(report)

    def list_session_ids(self):
        with self._lock:
            return sorted(self._cache)

    def get_all_updates(self, session_id):
        with self._lock:
            return list(self._cache.get(session_id, []))

    def close(self):
        self._fh.close()


class RemoteUIStatsStorageRouter:
    """POSTs records to a remote UIServer's /remote endpoint (parity:
    core api/storage/impl/RemoteUIStatsStorageRouter.java +
    RemoteReceiverModule on the server side)."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url.rstrip("/") + "/remote"
        self.timeout = timeout

    def put_static_info(self, session_id: str, info: dict):
        self._post({"type": "static", "sessionId": session_id, "info": info})

    def put_update(self, report: StatsReport):
        self._post({"type": "update",
                    "record": report.to_bytes().hex()})

    def _post(self, payload: dict):
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            resp.read()
