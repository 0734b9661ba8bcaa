"""Kafka pub/sub route for NDArray streams (optional-dependency adapter).

Counterpart of deeplearning4j_tpu/data/kafka.py (dl4j-streaming's
NDArrayPubSubRoute): the broker sits behind a three-method client protocol
(``BrokerClient``: send, poll, flush), so the route is broker-agnostic and
testable without a broker. ``InMemoryBroker`` implements it in-process;
``default_client()`` builds a ``kafka-python`` client when that optional
package is installed and otherwise raises the JAX package's
``ImportError``. The wire format is data/streaming.py's
``encode_record`` / ``decode_record``; undecodable records are skipped and
counted (``dl4jtpu_stream_corrupt_records_total{topic}``).
"""

from __future__ import annotations

import logging
import queue
import threading
from collections import defaultdict
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.data.streaming import (
    StreamingDataSetIterator, decode_record, encode_record)
from deeplearning4j_tpu_torch.resilience.errors import RetriesExhaustedError
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call

log = logging.getLogger(__name__)

# broker polls back off under the shared primitive; unbounded attempts —
# a consumer pump outlives broker rebalances, give_up (the stop flag) is
# what ends it
_POLL_POLICY = RetryPolicy(max_attempts=None, base_delay=0.05, max_delay=2.0)
_SEND_POLICY = RetryPolicy(max_attempts=5, base_delay=0.05, max_delay=1.0)


def _corrupt_counter():
    from deeplearning4j_tpu_torch.monitor import get_registry
    return get_registry().counter(
        "dl4jtpu_stream_corrupt_records_total",
        "Undecodable records skipped by streaming consumers.", ("topic",))


class BrokerClient:
    """Minimal broker protocol: durable enough for the route, small enough
    to fake. Implementations must be thread-safe."""

    def send(self, topic: str, value: bytes) -> None:
        raise NotImplementedError

    def poll(self, topic: str, timeout: float = 0.1) -> List[bytes]:
        """Return available messages for ``topic`` (possibly empty)."""
        raise NotImplementedError

    def flush(self) -> None:
        """Force out any batched sends (no-op for synchronous brokers)."""

    def close(self) -> None:
        pass


class InMemoryBroker(BrokerClient):
    """In-process fake broker: per-topic FIFO queues. Used by the contract
    tests and by single-process pipelines that want the route shape without
    a broker deployment."""

    def __init__(self):
        self._topics: Dict[str, queue.Queue] = defaultdict(queue.Queue)
        self._lock = threading.Lock()

    def _q(self, topic: str) -> queue.Queue:
        with self._lock:
            return self._topics[topic]

    def send(self, topic: str, value: bytes) -> None:
        self._q(topic).put(bytes(value))

    def poll(self, topic: str, timeout: float = 0.1) -> List[bytes]:
        q = self._q(topic)
        out: List[bytes] = []
        try:
            out.append(q.get(timeout=timeout))
            while True:
                out.append(q.get_nowait())
        except queue.Empty:
            pass
        return out

    def pending(self, topic: str) -> int:
        """Undelivered message count (approximate, like consumer lag)."""
        return self._q(topic).qsize()


class KafkaPythonClient(BrokerClient):
    """Adapter over the optional ``kafka-python`` package.

    Offset semantics: WITHOUT ``group_id`` each consumer starts at
    ``auto_offset_reset='earliest'`` and commits nothing, so every new
    process REPLAYS the topic from the beginning — the right default for
    re-runnable training streams, but it means duplicates across restarts.
    WITH ``group_id`` offsets are auto-committed to the broker and a
    restarted process resumes where the group left off (at-least-once).

    Sends are batched by the producer (``linger``/batch settings apply);
    call ``flush()`` — or ``close()``, which flushes — at durability points
    instead of paying a broker round-trip per message.
    """

    def __init__(self, bootstrap_servers: str = "localhost:9092",
                 group_id: Optional[str] = None, **kw):
        import kafka  # optional dependency; ImportError is the gate
        self._producer = kafka.KafkaProducer(
            bootstrap_servers=bootstrap_servers, **kw)
        self._consumers: Dict[str, "kafka.KafkaConsumer"] = {}
        self._bootstrap = bootstrap_servers
        self._group = group_id
        self._kw = kw

    def send(self, topic: str, value: bytes) -> None:
        self._producer.send(topic, value)   # batched; flush() to force out

    def flush(self) -> None:
        self._producer.flush()

    def poll(self, topic: str, timeout: float = 0.1) -> List[bytes]:
        import kafka
        c = self._consumers.get(topic)
        if c is None:
            c = kafka.KafkaConsumer(topic,
                                    bootstrap_servers=self._bootstrap,
                                    group_id=self._group,
                                    enable_auto_commit=self._group is not None,
                                    auto_offset_reset="earliest", **self._kw)
            self._consumers[topic] = c
        recs = c.poll(timeout_ms=int(timeout * 1000))
        return [r.value for batch in recs.values() for r in batch]

    def close(self) -> None:
        self._producer.flush()
        self._producer.close()
        for c in self._consumers.values():
            c.close()


def default_client(bootstrap_servers: Optional[str] = None,
                   group_id: Optional[str] = None) -> BrokerClient:
    """A real Kafka client when ``kafka-python`` is installed, else a clear
    error naming the optional dependency (this image is air-gapped).
    Broker-connection failures are wrapped in the same actionable style so
    'package installed but no broker running' doesn't surface as a bare
    NoBrokersAvailable deep in kafka internals."""
    servers = bootstrap_servers or "localhost:9092"
    try:
        return KafkaPythonClient(servers, group_id=group_id)
    except ImportError as e:
        raise ImportError(
            "Kafka transport needs the optional 'kafka-python' package "
            "(pip install kafka-python), or pass any BrokerClient — e.g. "
            "InMemoryBroker for in-process use.") from e
    except Exception as e:  # noqa: BLE001 — NoBrokersAvailable et al.
        raise ConnectionError(
            f"kafka-python is installed but no broker answered at "
            f"{servers} ({type(e).__name__}: {e}); start a broker, pass "
            "bootstrap_servers=, or use InMemoryBroker for in-process "
            "pipelines.") from e


class NDArrayPublisher:
    """Producer half of the route (parity: NDArrayPublisher)."""

    def __init__(self, client: BrokerClient, topic: str):
        self.client = client
        self.topic = topic

    def publish(self, features, labels) -> None:
        payload = encode_record(features, labels).encode()
        retry_call(self.client.send, self.topic, payload,
                   policy=_SEND_POLICY, component="kafka_producer")

    def flush(self) -> None:
        """Durability point: force out batched sends (see
        KafkaPythonClient — ``send`` no longer flushes per message)."""
        self.client.flush()


class NDArrayPubSubRoute:
    """Consumer half: a background thread polls the topic and pumps decoded
    records into a StreamingDataSetIterator (parity: the Camel route wiring
    NDArrayConsumer → training iterator; backpressure comes from the
    iterator's bounded buffer — when training falls behind, the pump blocks,
    which is the role consumer lag plays in the reference)."""

    def __init__(self, client: BrokerClient, topic: str, batch_size: int,
                 buffer_records: int = 1024,
                 stall_timeout: Optional[float] = None):
        self.client = client
        self.topic = topic
        # finite push timeout so a backpressure-blocked pump re-checks the
        # stop flag instead of blocking in the buffer forever;
        # stall_timeout lets a consumer surface StreamStalledError when the
        # topic goes silent (online trainers degrade health, not crash)
        self.iterator = StreamingDataSetIterator(
            batch_size, buffer_records=buffer_records, push_timeout=0.5,
            stall_timeout=stall_timeout)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "NDArrayPubSubRoute":
        """Start the pump. ``stop(end_stream=False)`` pauses and start()
        resumes; after a terminal ``stop()`` (stream ended) the route
        cannot be restarted — create a new one."""
        if self._thread is not None:
            return self
        if self.iterator.closed:
            raise RuntimeError(
                "route stream was ended; create a new NDArrayPubSubRoute")
        self._stop.clear()

        def pump():
            import queue as _queue
            corrupt = _corrupt_counter().labels(topic=self.topic)
            while not self._stop.is_set():
                try:
                    # transient broker failures (rebalances, connection
                    # resets) back off under the shared retry primitive;
                    # the stop flag aborts the loop promptly via give_up
                    msgs = retry_call(self.client.poll, self.topic,
                                      timeout=0.1, policy=_POLL_POLICY,
                                      component="kafka_consumer",
                                      give_up=self._stop.is_set)
                except RetriesExhaustedError:
                    return              # stop() raced a backoff
                except Exception as e:  # noqa: BLE001 — fatal poll error
                    log.error("kafka pump for topic %r stopping on fatal "
                              "poll error: %s: %s",
                              self.topic, type(e).__name__, e)
                    return
                for msg in msgs:
                    try:
                        f, l = decode_record(msg.decode())  # decode ONCE
                    except Exception:   # noqa: BLE001 — poison message
                        # a corrupt record must not kill the stream: skip
                        # it, count it, keep consuming
                        corrupt.inc()
                        continue
                    while True:                # backpressure with stop checks
                        try:
                            self.iterator.push(f, l)
                            break
                        except _queue.Full:
                            if self._stop.is_set():
                                return
                        except RuntimeError:
                            # stream ended under us (stop() raced a blocked
                            # push): this pump is done; remaining polled
                            # messages are part of the shutdown discard
                            return

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()
        return self

    def stop(self, end_stream: bool = True) -> None:
        """Stop pumping; with ``end_stream`` also close the iterator so
        consumers drain the buffer and see StopIteration. Messages the pump
        had polled but not yet pushed when a blocked shutdown races are
        discarded — shutdown is not a durability point (ack/commit
        semantics belong to the broker client)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if end_stream:
            self.iterator.end()
