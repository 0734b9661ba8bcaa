"""The bucketed engine's contract -- its own weights and hot swap, the
measured ladders, ``warmup``, ``predict_stream`` -- and the server's
``/warmup`` and ``/admin/swap``, held against the JAX package on the CPU.

- ``bucket_for``, ``autotune_ladder`` and ``prune_ladder`` are host code
  and must equal the JAX package's exactly on seeded histograms, ladders
  and costs; an engine's autotune over the same served sizes too.
- Outputs: bucketed = unbucketed bit for bit in the port (one forward
  either way), the port's engine against the JAX engine within 1e-5 (a
  float32 forward's summation order), TinyTransformer /predict within
  1e-4 (as tests/test_torch_transformer.py).
- Over HTTP both servers answer the same statuses and error types, the
  version travels in ``x-model-version``, and a refused swap leaves both
  engines serving what they served.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.serving.engine import InferenceEngine as JaxEngine
from deeplearning4j_tpu.serving.engine import \
    autotune_ladder as jax_autotune
from deeplearning4j_tpu.serving.engine import bucket_for as jax_bucket_for
from deeplearning4j_tpu.serving.engine import prune_ladder as jax_prune
from deeplearning4j_tpu.serving.server import InferenceServer as JaxServer
from deeplearning4j_tpu.util import model_serializer as jax_ser

from deeplearning4j_tpu_torch.monitor import get_registry
from deeplearning4j_tpu_torch.quant import leaves_by_path
from deeplearning4j_tpu_torch.resilience.errors import WeightSwapError
from deeplearning4j_tpu_torch.serving import (DecodeEngine, InferenceEngine,
                                              InferenceServer)
from deeplearning4j_tpu_torch.serving.decode import generate_naive
from deeplearning4j_tpu_torch.serving.engine import (autotune_ladder,
                                                     bucket_for,
                                                     prune_ladder)
from deeplearning4j_tpu_torch.serving.wire import (ndarray_from_b64,
                                                   ndarray_to_b64)
from test_torch_kv_prefix import MAXLEN, V, jax_lstm, jax_transformer
from test_torch_regularised_training import port_of

OUT_TOL = 1e-5
PRED_TOL = 1e-4
T = 6


def _x(B, seed=0, t=T):
    r = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[r.randint(0, V, (B, t))]


def _hist(rng, max_batch):
    sizes = rng.integers(1, 2 * max_batch, rng.integers(1, 12))
    return {int(s): int(rng.integers(1, 50)) for s in sizes}


# ------------------------------------------------------------ host code

@pytest.mark.parametrize("seed", range(12))
def test_autotune_ladder_matches_jax(seed):
    rng = np.random.default_rng(seed)
    max_batch = int(rng.choice([16, 64, 100, 256]))
    min_bucket = int(rng.choice([1, 2, 4]))
    max_rungs = [None, 2, 3, 5][seed % 4]
    counts = _hist(rng, max_batch)
    got = autotune_ladder(counts, max_batch, max_rungs, min_bucket)
    assert got == jax_autotune(counts, max_batch, max_rungs, min_bucket)
    assert got[-1] == max_batch
    for n in range(1, max_batch + 1):
        assert bucket_for(n, max_batch, min_bucket, got) == \
            jax_bucket_for(n, max_batch, min_bucket, got)
    assert autotune_ladder({}, max_batch) == jax_autotune({}, max_batch)


@pytest.mark.parametrize("seed", range(12))
def test_prune_ladder_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    max_batch = int(rng.choice([16, 64, 128]))
    counts = _hist(rng, max_batch)
    ladder = autotune_ladder(counts, max_batch)
    costs = {b: {"compile_s": float(rng.uniform(0, 0.05)),
                 "run_s": float(rng.uniform(0, 0.01))}
             for b in ladder if rng.uniform() < 0.9}
    if ladder[0] in costs and seed % 3 == 0:
        costs[ladder[0]]["run_s"] = 0.0      # unusable: kept
    got = prune_ladder(ladder, counts, costs)
    assert got == jax_prune(ladder, counts, costs)
    assert got[-1] == ladder[-1]


# ------------------------------------------------------------ the engine

@pytest.fixture(scope="module")
def lstm():
    jnet = jax_lstm()
    return jnet, port_of(jnet)


def test_oversize_batches_chunk_and_the_tail_rebuckets(lstm):
    """19 rows through max_batch 8: two top-rung chunks and a tail of 3
    that buckets to 4 (1 pad row, not 5), as the JAX engine does."""
    jnet, net = lstm
    eng, jeng = InferenceEngine(net, 8), JaxEngine(jnet, 8)
    x = _x(19, seed=3)
    got = eng.predict_host(x)
    np.testing.assert_array_equal(got, net.output(x, bucketed=False).numpy())
    np.testing.assert_allclose(got, jeng.predict_host(x), atol=OUT_TOL,
                               rtol=0)
    st, jst = eng.stats(), jeng.stats()
    assert st["buckets_used"] == [4, 8] and st["device_calls"] == 3
    assert (st["rows"], st["pad_rows"]) == (jst["rows"], jst["pad_rows"]) \
        == (19, 1)


def test_warmup_runs_the_ladder_and_serving_adds_no_program(lstm):
    jnet, net = lstm
    eng, jeng = InferenceEngine(net, 16), JaxEngine(jnet, 16)
    ladder = eng.warmup((T, V), max_batch=8)
    assert ladder == jeng.warmup((T, V), max_batch=8) == [1, 2, 4, 8]
    assert sorted(eng.rung_costs) == ladder
    assert all(c["compile_s"] >= 0 and c["run_s"] > 0
               for c in eng.rung_costs.values())
    assert eng.trace_count == jeng.trace_count == len(ladder)
    assert eng.warmup_seconds > 0 and eng._size_counts == {}
    # the CPU runs every rung eagerly: no graph
    assert eng.captures == 0
    for n in (1, 3, 7, 5, 2, 8):
        np.testing.assert_array_equal(eng.predict_host(_x(n, seed=n)),
                                      net.output(_x(n, seed=n),
                                                 bucketed=False).numpy())
    assert eng.trace_count == len(ladder)
    assert eng._size_counts == {1: 1, 3: 1, 7: 1, 5: 1, 2: 1, 8: 1}
    # a shape off the ladder (another T) runs, and counts as a program
    eng.predict_host(_x(2, t=T + 1))
    assert eng.trace_count == len(ladder) + 1
    st = eng.stats()
    for key in ("precision", "weight_bytes", "bucket_ladder",
                "model_version", "compiled_programs", "rung_costs",
                "ladder_autotuned", "warmup_seconds"):
        assert key in st and key in jeng.stats()
    with pytest.raises(ValueError, match="single-input"):
        eng.warmup([(T, V), (T, V)])


def test_autotune_from_served_traffic_matches_jax(lstm):
    jnet, net = lstm
    eng, jeng = InferenceEngine(net, 32), JaxEngine(jnet, 32)
    eng.warmup((T, V), max_batch=4)
    sizes = [3, 3, 3, 5, 5, 12, 12, 12, 12, 20, 1, 3]
    for i, n in enumerate(sizes):
        eng.predict_host(_x(n, seed=i))
        jeng.predict_host(_x(n, seed=i))
    assert eng.autotune(apply=False) == jeng.autotune(apply=False)
    jeng.rung_costs = {b: dict(c) for b, c in eng.rung_costs.items()}
    assert eng.autotune(max_rungs=3, prune=True) == \
        jeng.autotune(max_rungs=3, prune=True)
    st = eng.stats()
    assert st["ladder_autotuned"] and st["bucket_ladder"] == eng.ladder
    gauge = get_registry().get("dl4jtpu_serving_bucket_rungs")
    assert {k: c.value for k, c in gauge.children()}[(eng.id,)] == \
        len(eng.ladder)
    # the next warmup runs the autotuned ladder
    assert eng.warmup((T, V)) == eng.ladder
    x = _x(12, seed=99)
    np.testing.assert_array_equal(eng.predict_host(x),
                                  net.output(x, bucketed=False).numpy())


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_predict_stream_equals_predict(lstm, depth):
    _, net = lstm
    eng = InferenceEngine(net, 8)
    batches = [_x(n, seed=n) for n in (1, 5, 8, 11, 2)]
    got = list(eng.predict_stream(iter(batches), depth=depth))
    assert len(got) == len(batches)
    for x, y in zip(batches, got):
        np.testing.assert_array_equal(y, eng.predict_host(x))


def test_a_fresh_engine_follows_fit_until_a_swap():
    jnet = jax_lstm(seed=11)
    net = port_of(jnet)
    eng = InferenceEngine(net, 8)
    x = _x(3, seed=1)
    y0 = eng.predict_host(x)
    xs, ys = _x(4, seed=2), _x(4, seed=3)
    net.fit(xs, ys)
    y1 = eng.predict_host(x)
    assert not np.array_equal(y0, y1)
    np.testing.assert_array_equal(y1, net.output(x, bucketed=False).numpy())
    assert not eng._weights_set.owned          # the model's tensors, no copy
    cand = [{k: v.numpy().copy() for k, v in p.items()}
            for p in port_of(jax_lstm(seed=5)).params]
    assert eng.swap_weights(cand, version=7) == 7
    leaf = eng._weights_set.params[0]["W"]     # its own set from the swap
    assert leaf.data_ptr() != net.params[0]["W"].data_ptr()
    ptr = leaf.data_ptr()
    y2 = eng.predict_host(x)
    net.fit(xs, ys)                            # the model moves on ...
    np.testing.assert_array_equal(eng.predict_host(x), y2)   # ... serving not
    want = port_of(jax_lstm(seed=5)).output(x, bucketed=False).numpy()
    np.testing.assert_array_equal(y2, want)
    reg = get_registry()
    version = {k: c.value for k, c in
               reg.get("dl4jtpu_model_version").children()}
    assert version[(eng.id,)] == 7.0
    bad = [dict(p) for p in cand]
    bad[0]["W"] = bad[0]["W"][:, :3]
    with pytest.raises(WeightSwapError, match="expected"):
        eng.swap_weights(bad)
    np.testing.assert_array_equal(eng.predict_host(x), y2)
    assert eng.model_version == 7
    swaps = {k: c.value for k, c in
             reg.get("dl4jtpu_model_swaps_total").children()}
    assert swaps[(eng.id,)] == 1.0
    assert eng.swap_weights(cand) == 8
    assert leaf.data_ptr() == ptr              # written in place
    np.testing.assert_array_equal(eng.predict_host(x), y2)


def _reordered(tree):
    """The tree's leaves as numpy arrays, every dict's keys reversed."""
    if isinstance(tree, list):
        return [_reordered(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _reordered(tree[k]) for k in reversed(list(tree))}
    return tree.detach().cpu().numpy().copy()


def _candidate(net, form):
    """A swap candidate holding ``net``'s weights with the leaves in
    another order: ``reordered`` keeps the model's structure with every
    dict's keys reversed, ``flat`` is one ``{path: array}`` dict in that
    order (paths as ``leaves_by_path``'s: ``0/W``, ``b0_attn/Wq``)."""
    tree = _reordered(net.params)
    return tree if form == "reordered" else leaves_by_path(tree)


@pytest.mark.parametrize("form", ["reordered", "flat"])
@pytest.mark.parametrize("model", ["lstm", "transformer"])
def test_a_swap_matches_leaves_by_path(model, form):
    """A candidate whose leaves come in another order, or in another
    structure with the same paths, passes the gate, and both engines then
    serve exactly what fresh engines over the candidate's weights serve:
    each leaf lands in the tensor of its own path, whatever its shape
    shares with others (TinyTransformer's d x d projections)."""
    make = (jax_lstm if model == "lstm"
            else (lambda seed=7: jax_transformer(seed=seed, n_heads=2)))
    net, new = port_of(make()), port_of(make(seed=5))
    x = _x(3, seed=4)
    for precision in ("f32", "int8"):
        eng = InferenceEngine(net, 4, precision=precision)
        eng.predict_host(x)
        eng.swap_weights(_candidate(new, form))
        want = InferenceEngine(new, 4, precision=precision).predict_host(x)
        np.testing.assert_array_equal(eng.predict_host(x), want)
    dec = DecodeEngine(net, slots=2, max_len=MAXLEN)
    dec.swap_weights(_candidate(new, form))
    fresh = DecodeEngine(new, slots=2, max_len=MAXLEN)
    got = []
    for eng in (dec, fresh):
        eng.start()
        try:
            got.append(eng.generate([1, 2, 3], max_new_tokens=6)["tokens"])
        finally:
            eng.stop()
    assert got[0] == got[1]


def test_output_engine_copies_no_weights():
    """The engine behind ``model.output()`` reads the model's own tensors
    (as the JAX engine reads ``model.params``): no second copy of the
    weights and no copy after a fit step; ``set_params`` rebinding them is
    followed too."""
    net = port_of(jax_lstm())
    x = _x(3, seed=1)
    net.output(x)
    eng = net.serving_engine()
    assert not eng._weights_set.owned
    other = port_of(jax_lstm(seed=5))
    net.set_params([{k: v.clone() for k, v in p.items()}
                    for p in other.params])
    np.testing.assert_array_equal(net.output(x).numpy(),
                                  other.output(x, bucketed=False).numpy())
    assert not eng._weights_set.owned


# ---------------------------------------------------------------- HTTP

def _http(url, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            body, status, hdrs = r.read().decode(), r.status, r.headers
    except urllib.error.HTTPError as e:
        body, status, hdrs = e.read().decode(), e.code, e.headers
    return status, json.loads(body), dict(hdrs)


def _predict(url, x):
    status, body, hdrs = _http(url, "/predict",
                               {"ndarray": ndarray_to_b64(x)})
    assert status == 200, body
    return ndarray_from_b64(body["ndarray"]), hdrs["x-model-version"]


def test_http_warmup_and_admin_swap(tmp_path):
    """Both packages' servers, TinyTransformer with a dense decode engine:
    /warmup's buckets; /admin/swap of a zip the JAX package wrote (200,
    the version in ``x-model-version``, /predict and greedy /generate
    then those of the zip's weights); a zip of another width (409
    ``weight_mismatch``, serving unchanged); a missing checkpoint or a
    bad version (400 ``bad_request``), an absent file (400
    ``bad_checkpoint``)."""
    jnet, jnew = jax_transformer(n_heads=2), jax_transformer(seed=5,
                                                             n_heads=2)
    net = port_of(jnet)
    good, wrong = tmp_path / "new.zip", tmp_path / "wide.zip"
    jax_ser.write_model(jnew, good)
    jax_ser.write_model(jax_transformer(d_model=16, n_heads=2), wrong)
    srv = InferenceServer(net, port=0, decode_engine=DecodeEngine(
        net, slots=2, max_len=MAXLEN)).start()
    jsrv = JaxServer(jnet, port=0).start()
    urls = [f"http://127.0.0.1:{s.port}" for s in (srv, jsrv)]
    x = _x(3, seed=4)
    try:
        answers = [_http(u, "/warmup", {"input_shape": [T, V],
                                        "max_batch": 4}) for u in urls]
        for status, body, _ in answers:
            assert status == 200 and body["buckets"] == [1, 2, 4]
            assert body["seconds"] > 0
        before = [_predict(u, x) for u in urls]
        assert [v for _, v in before] == ["0", "0"]
        np.testing.assert_allclose(before[0][0], before[1][0], atol=PRED_TOL,
                                   rtol=0)
        programs = srv.engine.trace_count
        for u in urls:
            status, body, _ = _http(u, "/admin/swap",
                                    {"checkpoint": str(good)})
            assert status == 200, body
            assert body["swapped"] is True and body["version"] == 1
            assert body["checkpoint"] == str(good)
        after = [_predict(u, x) for u in urls]
        assert [v for _, v in after] == ["1", "1"]
        assert srv.engine.trace_count == programs
        want = port_of(jnew).output(x, bucketed=False).numpy()
        np.testing.assert_allclose(after[0][0], want, atol=OUT_TOL, rtol=0)
        np.testing.assert_allclose(after[0][0], after[1][0], atol=PRED_TOL,
                                   rtol=0)
        status, body, hdrs = _http(urls[0], "/generate",
                                   {"tokens": [1, 2, 3],
                                    "max_new_tokens": 6})
        assert status == 200 and hdrs["x-model-version"] == "1"
        assert body["tokens"] == generate_naive(port_of(jnew), [1, 2, 3], 6,
                                                MAXLEN)["tokens"]
        for payload, code, kind in (
                ({"checkpoint": str(wrong)}, 409, "weight_mismatch"),
                ({}, 400, "bad_request"),
                ({"checkpoint": str(good), "version": "v2"}, 400,
                 "bad_request"),
                ({"checkpoint": str(tmp_path / "absent.zip")}, 400,
                 "bad_checkpoint")):
            for u in urls:
                status, body, _ = _http(u, "/admin/swap", payload)
                assert (status, body["error"]["type"]) == (code, kind), body
        unchanged = _predict(urls[0], x)
        np.testing.assert_array_equal(unchanged[0], after[0][0])
        assert unchanged[1] == "1"
        assert srv.decode_engine.model_version == 1
        for u in urls:
            status, body, _ = _http(u, "/warmup", {"max_batch": 2})
            assert (status, body["error"]["type"]) == (400, "bad_request")
    finally:
        srv.stop()
        jsrv.stop()


def test_a_swap_waits_for_a_running_warmup(monkeypatch):
    """``InferenceServer.swap_weights`` does device work (the candidate's
    copy to the card, its quantization) on the caller's thread, and a
    capture is global: a swap that arrives while ``/warmup`` runs starts
    only once the warm-up has returned."""
    net = port_of(jax_lstm())
    srv = InferenceServer(net, port=0, decode_engine=DecodeEngine(
        net, slots=2, max_len=MAXLEN)).start()
    entered, release, order = threading.Event(), threading.Event(), []
    warmup, decode_swap = srv.engine.warmup, srv.decode_engine.swap_weights

    def slow_warmup(*a, **k):
        entered.set()
        release.wait(60)
        order.append("warmup")
        return warmup(*a, **k)

    def swap(*a, **k):
        order.append("swap")
        return decode_swap(*a, **k)
    monkeypatch.setattr(srv.engine, "warmup", slow_warmup)
    monkeypatch.setattr(srv.decode_engine, "swap_weights", swap)
    cand = _candidate(port_of(jax_lstm(seed=5)), "reordered")
    threads = [threading.Thread(target=srv.warmup, args=((T, V), 2)),
               threading.Thread(target=srv.swap_weights, args=(cand,))]
    try:
        threads[0].start()
        assert entered.wait(60)
        threads[1].start()
        time.sleep(0.3)
        assert order == []                  # the swap waits its turn
        release.set()
        for t in threads:
            t.join(120)
        assert order == ["warmup", "swap"]
        assert srv.engine.model_version == 1
    finally:
        release.set()
        srv.stop()


def test_load_weights_reads_only_the_arrays(tmp_path):
    """``load_weights`` returns numpy arrays in the model's tree, whatever
    the zip's configuration says; arrays that do not cover the model
    raise WeightSwapError, as in the JAX package."""
    from deeplearning4j_tpu_torch.util import model_serializer
    jnet = jax_lstm(seed=3)
    net = port_of(jax_lstm())
    path = tmp_path / "m.zip"
    jax_ser.write_model(jnet, path)
    params, state = model_serializer.load_weights(net, path)
    jparams, _ = jax_ser.load_weights(jnet, path)
    assert [sorted(p) for p in params] == [sorted(p) for p in net.params]
    for p, jp in zip(params, jparams):
        for k, v in p.items():
            assert isinstance(v, np.ndarray)
            np.testing.assert_array_equal(v, np.asarray(jp[k]))
    other = port_of(jax_transformer(n_heads=2))
    with pytest.raises(WeightSwapError, match="not swap-compatible"):
        model_serializer.load_weights(other, path)
    from deeplearning4j_tpu.resilience.errors import \
        WeightSwapError as JaxWeightSwapError
    with pytest.raises(JaxWeightSwapError, match="not swap-compatible"):
        jax_ser.load_weights(jax_transformer(n_heads=2), path)
