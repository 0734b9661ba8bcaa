"""The port's streaming ingest (data/streaming.py, data/kafka.py) on the
CPU: the JAX package's tests/test_streaming.py cases, the wire format held
byte for byte against the JAX package's in both directions, and the Kafka
route over the in-process broker (corrupt records skipped and counted,
the optional client's import error)."""

import queue
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.data import streaming as jstream

from deeplearning4j_tpu_torch import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch.data import (DataSet, StreamingDataSetIterator,
                                           decode_record, encode_record)
from deeplearning4j_tpu_torch.data import kafka
from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator
from deeplearning4j_tpu_torch.monitor import get_registry
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer


def test_two_thread_stream_batches_and_tail():
    it = StreamingDataSetIterator(batch_size=8, buffer_records=64)
    n = 35   # 4 full batches + tail of 3

    def producer():
        rs = np.random.RandomState(0)
        for i in range(n):
            it.push(rs.rand(4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[i % 3])
            if i % 10 == 0:
                time.sleep(0.002)      # interleave with the consumer
        it.end()

    t = threading.Thread(target=producer)
    t.start()
    sizes, total = [], 0
    for ds in it:
        assert ds.features.shape[1:] == (4,)
        assert ds.labels.shape[1:] == (3,)
        sizes.append(ds.num_examples())
        total += ds.num_examples()
    t.join()
    assert total == n
    assert sizes == [8, 8, 8, 8, 3]


def test_stream_prebatched_blocks_and_drop_remainder():
    it = StreamingDataSetIterator(batch_size=4, drop_remainder=True)
    it.push(np.ones((6, 2), np.float32), np.ones((6, 1), np.float32),
            batched=True)
    it.end()
    out = list(it)
    assert len(out) == 1 and out[0].num_examples() == 4


def test_stream_backpressure_and_closed_push():
    it = StreamingDataSetIterator(batch_size=2, buffer_records=2,
                                  push_timeout=0.05)
    it.push(np.zeros(2), np.zeros(1))
    it.push(np.zeros(2), np.zeros(1))
    with pytest.raises(queue.Full):     # bounded buffer pushes back
        it.push(np.zeros(2), np.zeros(1))
    it.end()
    with pytest.raises(RuntimeError):
        it.push(np.zeros(2), np.zeros(1))
    assert next(it).num_examples() == 2


def test_wire_codec_roundtrip():
    f = np.random.RandomState(1).rand(5, 7).astype(np.float32)
    l = np.asarray([1, 0, 2], np.int32)
    f2, l2 = decode_record(encode_record(f, l))
    np.testing.assert_array_equal(f, f2)
    np.testing.assert_array_equal(l, l2)
    assert f2.dtype == f.dtype and l2.dtype == l.dtype


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8",
                                   "bool"])
def test_wire_format_is_the_jax_packages_both_ways(dtype):
    rs = np.random.RandomState(2)
    f = (rs.rand(3, 4, 2) * 9).astype(dtype)
    l = (rs.rand(3) * 5).astype(dtype)
    assert encode_record(f, l) == jstream.encode_record(f, l)
    for enc, dec in ((encode_record, jstream.decode_record),
                     (jstream.encode_record, decode_record)):
        f2, l2 = dec(enc(f, l))
        assert f2.dtype == f.dtype and f2.shape == f.shape
        assert f2.tobytes() == f.tobytes() and l2.tobytes() == l.tobytes()


def test_stream_feeds_fit_through_async_prefetch():
    """Producer thread -> streaming iterator -> async prefetch -> fit."""
    conf = (NeuralNetConfiguration.builder().seed(1)
            .list()
            .layer(DenseLayer(n_in=6, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=2, activation="softmax",
                               loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    it = StreamingDataSetIterator(batch_size=16)

    def producer():
        rs = np.random.RandomState(2)
        for _ in range(8):
            x = rs.rand(16, 6).astype(np.float32)
            y = np.eye(2, dtype=np.float32)[(x.sum(1) > 3).astype(int)]
            it.push(x, y, batched=True)
        it.end()

    t = threading.Thread(target=producer)
    t.start()
    net.fit(AsyncDataSetIterator(it, queue_size=2))
    t.join()
    assert net.iteration == 8
    assert np.isfinite(net.get_score())


def _corrupt(topic):
    fam = get_registry().get("dl4jtpu_stream_corrupt_records_total")
    if fam is None:
        return 0.0
    return sum(c.value for k, c in fam.children() if k == (topic,))


def test_kafka_route_skips_corrupt_records_and_keeps_order():
    broker = kafka.InMemoryBroker()
    pub = kafka.NDArrayPublisher(broker, "ingest")
    rs = np.random.RandomState(3)
    xs = rs.rand(6, 4).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 6)]
    for i in range(3):
        pub.publish(xs[i], ys[i])
    broker.send("ingest", b"{not a record")
    for i in range(3, 6):
        pub.publish(xs[i], ys[i])
    pub.flush()
    before = _corrupt("ingest")
    route = kafka.NDArrayPubSubRoute(broker, "ingest", batch_size=3).start()
    try:
        a, b = next(route.iterator), next(route.iterator)
    finally:
        route.stop()
    np.testing.assert_array_equal(np.concatenate([a.features, b.features]),
                                  xs)
    np.testing.assert_array_equal(np.concatenate([a.labels, b.labels]), ys)
    assert _corrupt("ingest") == before + 1
    assert isinstance(a, DataSet) and broker.pending("ingest") == 0
    with pytest.raises(StopIteration):      # stop() ended the stream
        next(route.iterator)
    with pytest.raises(RuntimeError, match="create a new"):
        route.start()


def test_default_client_names_the_optional_dependency():
    try:
        import kafka as _kafka  # noqa: F401
        pytest.skip("kafka-python is installed here")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="kafka-python"):
        kafka.default_client()
