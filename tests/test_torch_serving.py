"""The port's serving path (bucketed engine, micro-batcher, decode engine,
HTTP server and client) held against the JAX package's, on the CPU.

A small 2 x LSTM(8) char model is built in the JAX package and its weights
carried across as numpy arrays; /predict answers agree within 1e-5
(float32, another summation order), greedy /generate tokens exactly.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.serving.client import InferenceClient as JaxClient
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.engine import bucket_for as jax_bucket_for
from deeplearning4j_tpu.serving.engine import \
    bucket_ladder as jax_bucket_ladder
from deeplearning4j_tpu.serving.server import InferenceServer as JaxServer

from deeplearning4j_tpu_torch import MultiLayerNetwork, params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, DeadlineExceededError, RetriesExhaustedError,
    ServerOverloadedError)
from deeplearning4j_tpu_torch.serving import (DecodeEngine, InferenceClient,
                                              InferenceServer, MicroBatcher,
                                              bucket_for, bucket_ladder)
from deeplearning4j_tpu_torch.serving.decode import (generate_naive,
                                                     oracle_token)

V, H = 6, 8


@pytest.fixture(scope="module")
def nets():
    conf = (JaxNNC.builder().seed(7).weight_init("xavier").list()
            .layer(JaxLSTM(n_out=H, activation="tanh"))
            .layer(JaxLSTM(n_out=H, activation="tanh"))
            .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V)).build())
    jnet = JaxMLN(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                            device="cpu")
    net.set_params(params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params],
        device="cpu"))
    return jnet, net


def _x(B, T=5, seed=0):
    r = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[r.randint(0, V, (B, T))]


@pytest.fixture
def server(nets):
    _, net = nets
    srv = InferenceServer(net, port=0, max_latency_ms=5.0,
                          decode_engine=DecodeEngine(net, slots=3,
                                                     max_len=40)).start()
    yield srv, InferenceClient(f"http://127.0.0.1:{srv.port}")
    srv.stop()


def test_bucket_ladder_matches_jax():
    for mb in (1, 7, 64, 1024):
        assert bucket_ladder(mb) == jax_bucket_ladder(mb)
        for n in range(1, mb + 1, max(1, mb // 13)):
            assert bucket_for(n, mb) == jax_bucket_for(n, mb)


def test_bucketed_equals_unbucketed(nets):
    _, net = nets
    eng = net.serving_engine()
    for B in (1, 3, 5, 9):
        x = _x(B, seed=B)
        np.testing.assert_array_equal(net.output(x).numpy(),
                                      net.output(x, bucketed=False).numpy())
    st = eng.stats()
    assert {4, 8, 16} <= set(st["buckets_used"]) and st["pad_rows"] > 0


def test_oversize_batches_chunk_through_the_top_bucket(nets):
    _, net = nets
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    eng = InferenceEngine(net, max_batch=4)
    x = _x(11, seed=3)
    np.testing.assert_array_equal(eng.predict_host(x),
                                  net.output(x, bucketed=False).numpy())
    assert eng.stats()["device_calls"] == 3


def test_micro_batcher_coalesces_concurrent_requests(nets):
    _, net = nets
    b = MicroBatcher(net.serving_engine(), max_latency_ms=200.0).start()
    try:
        xs = [_x(n, seed=10 + n) for n in (1, 2, 3, 4)]
        futs = [b.submit(x) for x in xs]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        b.stop()
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(out, net.output(x, bucketed=False).numpy(),
                                   atol=1e-6, rtol=0)
    st = b.stats()
    assert st["requests"] == 4 and st["device_calls"] < 4


def test_micro_batcher_merges_only_requests_of_one_length(nets):
    """Sequences of another length cannot share a forward: each batch holds
    one row shape, and every request still gets its own answer."""
    _, net = nets
    eng = net.serving_engine()
    b = MicroBatcher(eng, max_latency_ms=200.0).start()
    calls0 = eng.stats()["device_calls"]
    try:
        xs = [_x(n, T=t, seed=20 + n)
              for n, t in zip((1, 2, 3, 4), (5, 5, 9, 9))]
        futs = [b.submit(x) for x in xs]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        b.stop()
    for x, out in zip(xs, outs):
        assert out.shape == (x.shape[0], x.shape[1], V)
        np.testing.assert_allclose(out, net.output(x, bucketed=False).numpy(),
                                   atol=1e-6, rtol=0)
    assert 2 <= eng.stats()["device_calls"] - calls0 < 4


class _GatedEngine:
    """An engine whose forward waits for a gate: requests pile up behind it."""

    def __init__(self):
        self.entered = threading.Event()
        self.gate = threading.Event()

    def predict_host(self, x):
        self.entered.set()
        self.gate.wait(10)
        return np.asarray(x) * 2


def _wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "condition not reached"
        time.sleep(0.005)


def test_full_queue_sheds_with_429_and_deadlines_expire():
    eng = _GatedEngine()
    b = MicroBatcher(eng, max_batch=1, max_latency_ms=0.0, max_queue=1)
    first = b.submit(np.ones((1, 2)))
    assert eng.entered.wait(10)            # the worker holds `first`
    late = b.submit(np.ones((1, 2)), deadline_ms=1.0)
    with pytest.raises(ServerOverloadedError):
        b.submit(np.ones((1, 2)), block=False)
    time.sleep(0.01)
    eng.gate.set()
    np.testing.assert_array_equal(first.result(timeout=10), np.full((1, 2), 2))
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=10)
    b.stop()
    with pytest.raises(BatcherStoppedError):
        b.submit(np.ones((1, 2)))
    assert b.stats()["rejected"] == {"queue_full": 1, "stopped": 1,
                                     "deadline": 1}


def test_http_429_on_a_full_queue(nets):
    _, net = nets
    eng = _GatedEngine()
    srv = InferenceServer(net, port=0, engine=eng, max_batch=1,
                          max_latency_ms=0.0, max_queue=1).start()
    url = f"http://127.0.0.1:{srv.port}"
    x = _x(1)
    results = []
    try:
        held = threading.Thread(
            target=lambda: results.append(InferenceClient(url).predict(x)))
        held.start()
        assert eng.entered.wait(10)        # first request inside the engine
        queued = threading.Thread(
            target=lambda: results.append(InferenceClient(url).predict(x)))
        queued.start()
        _wait_for(lambda: srv.batcher.stats()["queue_depth"] == 1)
        # one attempt: the 429 surfaces as the JAX client's exhausted
        # retry, caused by the typed overload error
        with pytest.raises(RetriesExhaustedError) as ei:
            InferenceClient(url, retries=1).predict(x)
        assert isinstance(ei.value.__cause__, ServerOverloadedError)
        eng.gate.set()
        held.join(10)
        queued.join(10)
    finally:
        eng.gate.set()
        srv.stop()
    assert len(results) == 2 and not held.is_alive()


def test_http_predict_matches_the_jax_server(nets, server):
    jnet, _ = nets
    srv, cli = server
    jsrv = JaxServer(jnet, port=0, max_latency_ms=5.0).start()
    try:
        x = _x(3, T=6, seed=4)
        want = JaxClient(f"http://127.0.0.1:{jsrv.port}").predict(x)
    finally:
        jsrv.stop()
    got = cli.predict(x)
    assert got.shape == want.shape == (3, 6, V)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        cli.predict(np.ones((2, 6, V + 1), np.float32))   # 400: bad width
    assert cli.health()["status"] == "ok"


def test_greedy_generate_matches_the_jax_decode_engine(nets, server):
    jnet, net = nets
    _, cli = server
    prompts = [[1, 2, 3], [5], [0, 4, 4, 2, 1]]
    jeng = JaxDecode(jnet, slots=2, max_len=40).start()
    try:
        want = [jeng.generate(p, max_new_tokens=12)["tokens"]
                for p in prompts]
    finally:
        jeng.stop()
    got = [cli.generate(p, max_new_tokens=12)["tokens"] for p in prompts]
    assert got == want
    assert got[0] == generate_naive(net, prompts[0], 12, 40)["tokens"]


def test_sampled_generate_is_the_same_under_any_arrival_schedule(server):
    srv, cli = server
    eng = srv.decode_engine
    req = dict(max_new_tokens=10, seed=11, temperature=2.0, top_k=5)
    alone = cli.generate([2, 3], **req)["tokens"]
    futs = [eng.submit([i % V, 1], max_new_tokens=8, seed=i,
                       temperature=1.0) for i in range(5)]
    time.sleep(0.01)
    busy = cli.generate([2, 3], **req)["tokens"]
    for f in futs:
        f.result(timeout=30)
    assert busy == alone
    others = {tuple(cli.generate([2, 3], **dict(req, seed=s))["tokens"])
              for s in range(12, 16)}
    assert others - {tuple(alone)}                     # the seed matters
    with pytest.raises(ValueError):
        cli.generate([V], max_new_tokens=2)                # id out of range


def test_oracle_token_rules():
    logits = np.log(np.array([0.1, 0.5, 0.15, 0.25], np.float32))
    assert oracle_token(logits, 0, 0, 0.0, 0) == 1
    draws = [oracle_token(logits, 3, p, 1.0, 2) for p in range(400)]
    assert set(draws) == {1, 3}                        # top-2 only
    assert 0.55 < draws.count(1) / 400 < 0.8           # 0.5 / 0.75
    assert draws == [oracle_token(logits, 3, p, 1.0, 2) for p in range(400)]
