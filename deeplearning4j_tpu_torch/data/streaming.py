"""Streaming ingest: continuous record feeds -> bounded buffer -> DataSets.

Counterpart of deeplearning4j_tpu/data/streaming.py (dl4j-streaming's
ingest routes): any producer thread calls ``push(...)``; training pulls
batched ``DataSet``s of host arrays through the iterator protocol, so the
stream composes with ``AsyncDataSetIterator`` and ``fit`` like any other
iterator. The buffer is bounded: ``push`` blocks (or times out) when
training falls behind.

``encode_record`` / ``decode_record`` are the JAX package's wire format,
byte for byte: one JSON line ``{"features": {"shape", "dtype", "data"},
"labels": {...}}`` with base64 payloads of the arrays' C-order bytes, so a
record either package encodes decodes in the other.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator
from deeplearning4j_tpu_torch.resilience.errors import StreamStalledError


def encode_record(features: np.ndarray, labels: np.ndarray) -> str:
    """One (features, labels) record → JSON line (base64 payloads) — the
    wire format role of NDArrayPubSubRoute's serialized NDArray messages."""
    def enc(a):
        a = np.asarray(a)
        return {"shape": list(a.shape), "dtype": str(a.dtype),
                "data": base64.b64encode(a.tobytes()).decode()}
    return json.dumps({"features": enc(features), "labels": enc(labels)})


def decode_record(line: str):
    def dec(o):
        raw = base64.b64decode(o["data"])
        return np.frombuffer(raw, dtype=np.dtype(o["dtype"])).reshape(
            o["shape"]).copy()
    obj = json.loads(line)
    return dec(obj["features"]), dec(obj["labels"])


class StreamingDataSetIterator(DataSetIterator):
    """Bounded-buffer bridge from producer threads to the training loop.

    Producers call ``push(features, labels)`` (single records or pre-batched
    arrays), ``push_dataset(ds)``, or ``push_encoded(line)``; the training
    side iterates ``DataSet``s of ``batch_size`` examples. ``end()`` closes
    the stream: consumers drain the buffer (a final partial batch included
    unless ``drop_remainder``) and then see ``StopIteration``.

    ``reset()`` is a no-op — a stream has no beginning to rewind to (the
    reference's Kafka consumer has the same semantics: offsets only move
    forward). Wrap with ``AsyncDataSetIterator`` for device-side prefetch,
    or pass straight to ``fit``.
    """

    def __init__(self, batch_size: int, buffer_records: int = 1024,
                 drop_remainder: bool = False,
                 push_timeout: Optional[float] = None,
                 stall_timeout: Optional[float] = None):
        self.batch_size = int(batch_size)
        self.drop_remainder = drop_remainder
        self.push_timeout = push_timeout
        # stall detection: a producer that dies WITHOUT calling end() would
        # otherwise block the training loop forever in __next__; after this
        # many silent seconds the consumer gets StreamStalledError instead
        self.stall_timeout = stall_timeout
        self._q: queue.Queue = queue.Queue(maxsize=buffer_records)
        self._closed = threading.Event()
        self._pending_f: list = []       # consumer-side partial batch
        self._pending_l: list = []
        self._n_pending = 0

    # ------------------------------------------------------------- producer
    def push(self, features, labels, batched: bool = False):
        """Enqueue one record (``features`` has the single-example shape) or,
        with ``batched=True``, a pre-batched block whose leading axis is the
        example axis. Blocks when the buffer is full (backpressure); raises
        ``queue.Full`` after ``push_timeout`` seconds if one was set, and
        ``RuntimeError`` if the stream was already closed."""
        if self._closed.is_set():
            raise RuntimeError("push() after end(): stream is closed")
        f, l = np.asarray(features), np.asarray(labels)
        if not batched:
            f, l = f[None], l[None]
        self._q.put((f, l), timeout=self.push_timeout)

    def push_dataset(self, ds: DataSet):
        self.push(ds.features, ds.labels, batched=True)

    def push_encoded(self, line: str):
        """Enqueue one wire-format record (see ``encode_record``)."""
        self.push(*decode_record(line))

    def end(self):
        """Close the stream; consumers drain what's buffered, then stop."""
        self._closed.set()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    # ------------------------------------------------------------- consumer
    def reset(self):
        pass     # forward-only, like a bus consumer's offset

    def _take(self, block: bool):
        try:
            f, l = self._q.get(timeout=0.05) if block else \
                self._q.get_nowait()
        except queue.Empty:
            return False
        self._pending_f.append(f)
        self._pending_l.append(l)
        self._n_pending += f.shape[0]
        return True

    def _pop_batch(self, n):
        f = np.concatenate(self._pending_f)
        l = np.concatenate(self._pending_l)
        out = DataSet(f[:n], l[:n])
        rest_f, rest_l = f[n:], l[n:]
        self._pending_f = [rest_f] if len(rest_f) else []
        self._pending_l = [rest_l] if len(rest_l) else []
        self._n_pending = int(rest_f.shape[0]) if len(rest_f) else 0
        return out

    def __next__(self) -> DataSet:
        last_data = time.monotonic()
        while True:
            if self._n_pending >= self.batch_size:
                return self._emit(self._pop_batch(self.batch_size))
            got = self._take(block=True)
            if got:
                last_data = time.monotonic()
                continue
            if (self.stall_timeout is not None
                    and not self._closed.is_set()
                    and time.monotonic() - last_data > self.stall_timeout):
                raise StreamStalledError(
                    f"stream open but silent for over {self.stall_timeout}s "
                    f"— producer likely died without calling end()")
            if self._closed.is_set() and self._q.empty():
                # drain any races, then flush the partial tail
                while self._take(block=False):
                    pass
                if self._n_pending >= self.batch_size:
                    return self._emit(self._pop_batch(self.batch_size))
                if self._n_pending and not self.drop_remainder:
                    return self._emit(self._pop_batch(self._n_pending))
                raise StopIteration

    def __iter__(self):
        return self
