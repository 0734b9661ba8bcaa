"""The port's observability (monitor/ and exec/programs.py) held against
the JAX package's, on the CPU.

- Trace contexts: the same ``x-trace-context`` header parses to the same
  ``TraceContext`` in both packages; spans record the installed context
  on the wall-clock epoch; ``merge_docs`` and ``flight_counter_events``
  give equal documents on the same inputs (numpy-seeded timestamps).
- ``BurnRateSLO`` under one fake clock and the same counters gives the
  same ``SLOState`` sequence in both packages.
- The server, over HTTP, as the JAX tests (test_fleet_observability.py,
  test_flight.py) ask of the JAX server: ``/programs`` lists the engines'
  programs with their cost, and reading it adds no program;
  ``/trace`` holds the request's spans (``http_request``, ``enqueue``,
  ``bucket``, ``pad``, ``device``, ``readback``, ``decode_step``) with the
  header's trace id, which the ``/requests`` records carry too;
  ``/admin/profile`` answers 400, 200, 409 and leaves a trace;
  ``DL4JTPU_PROFILE`` profiles ``fit``; ``/train/diagnostics`` and 404;
  ``/healthz`` degrades on a fast burn and on a non-finite training run;
  an engine fault answers 500 and is counted.
- ``collect_fleet_trace`` and ``collect_requests`` merge two in-process
  servers.
- The program registry: the containers' train steps register on the CPU
  with no capture, ``register_program`` counts a product's operations,
  and the kernels' work arithmetic is ``chip_smoke.py``'s ``bound`` /
  ``attn_bound``.

The model is the JAX tests' TinyTransformer at small size (2 blocks of
d_model 32, 4 heads, max_len 64, 13 symbols), carried across with
``port_of``.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.monitor import collect as jcollect
from deeplearning4j_tpu.monitor import slo as jslo
from deeplearning4j_tpu.monitor import tracing as jtracing

from deeplearning4j_tpu_torch.exec import get_executor, get_programs
from deeplearning4j_tpu_torch.monitor import (BurnRateSLO, FlightRecorder,
                                              TraceContext,
                                              collect_fleet_trace,
                                              collect_requests,
                                              flight_counter_events,
                                              get_registry, merge_docs,
                                              profiling, trace,
                                              trace_context)
from deeplearning4j_tpu_torch.ops import attention_cuda, decode_cuda, lstm_cuda
from deeplearning4j_tpu_torch.serving import (DecodeEngine, InferenceClient,
                                              InferenceServer)
from test_torch_kv_migrate import jax_tiny
from test_torch_regularised_training import batch, lstm_conf, port_of

V = 13


@pytest.fixture(scope="module")
def tiny():
    return port_of(jax_tiny())


@pytest.fixture
def traced():
    trace.clear()
    trace.enable(True)
    yield trace
    trace.enable(False)
    trace.clear()


def _get(url, path, headers=None):
    req = urllib.request.Request(url + path, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read().decode())


def _post(url, path, payload, headers=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


# ---------------------------------------------------------------- tracing

@pytest.mark.parametrize("header", ["req-1", "req-1;req-1#a2", "  t;p  ",
                                    "", None, ";p", "a;b;c"])
def test_trace_context_header_parses_as_in_jax(header):
    ours = TraceContext.from_header(header)
    theirs = jtracing.TraceContext.from_header(header)
    if theirs is None:
        assert ours is None
        return
    assert (ours.trace_id, ours.parent) == (theirs.trace_id, theirs.parent)
    assert ours.to_header() == theirs.to_header()
    child = ours.child("p2")
    assert (child.trace_id, child.parent) == (ours.trace_id, "p2")


def test_spans_record_the_context_on_the_wall_clock(traced):
    traced.set_process_name("replica-a")
    t0 = time.time() * 1e6
    with trace_context(TraceContext("tid-9", "att-1")):
        with traced.span("outer"):
            with traced.span("inner", k=1):
                traced.instant("mark", n=2)
    with traced.span("outer"):
        pass
    evs = traced.events()
    assert [e["ph"] for e in evs] == ["B", "B", "i", "E", "E", "B", "E"]
    assert all(abs(e["ts"] - t0) < 5e6 for e in evs)
    assert evs[0]["args"] == {"trace_id": "tid-9", "parent": "att-1"}
    assert evs[1]["args"] == {"k": 1, "trace_id": "tid-9",
                              "parent": "att-1"}
    assert evs[2]["args"] == {"n": 2, "trace_id": "tid-9"}
    assert "args" not in evs[5]          # the context never leaks out
    meta = traced.export()["traceEvents"][0]
    assert meta["name"] == "process_name" and \
        meta["args"] == {"name": "replica-a"}
    assert traced.process_name == "replica-a"
    traced.set_process_name("")


def _docs(seed):
    r = np.random.RandomState(seed)
    docs = []
    for pid in (11, 22):
        evs = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": f"p{pid}"}}] * 2
        for k in range(4):
            ts = float(r.randint(1_000_000, 9_000_000))
            evs.append({"ph": "B", "name": f"s{k}", "pid": pid, "tid": 1,
                        "ts": ts})
            evs.append({"ph": "E", "name": f"s{k}", "pid": pid, "tid": 1,
                        "ts": ts + 5.0})
        docs.append({"traceEvents": evs})
    return docs


@pytest.mark.parametrize("rebase", [True, False])
def test_merge_docs_equals_jax(rebase):
    assert merge_docs(_docs(3), rebase=rebase) == \
        jcollect.merge_docs(_docs(3), rebase=rebase)


def test_flight_counter_events_equal_jax():
    r = np.random.RandomState(5)
    diag = {"cols": ["grad_norm", "update_norm"],
            "records": [{"time": 1.7e9 + i, "layers": {
                "0:LSTM": {"grad_norm": float(r.rand()),
                           "update_norm": float(r.rand())}}}
                for i in range(3)]}
    assert flight_counter_events(diag, pid="t") == \
        jcollect.flight_counter_events(diag, pid="t")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _slo_script(cls):
    clk, counts = _Clock(), {"bad": 0.0, "total": 0.0}
    slo = cls("t", lambda: counts["bad"], lambda: counts["total"],
              objective=0.99, short_s=300.0, long_s=3600.0, min_events=20,
              clock=clk, min_tick_s=0.0)
    out = [slo.evaluate().as_dict()]
    for t, bad, total, tick in [(30, 5, 5, False), (60, 0, 100, False),
                                (120, 80, 100, False), (200, 0, 30, True),
                                (380, 0, 30, True), (430, 0, 0, False)]:
        counts["bad"] += bad
        counts["total"] += total
        clk.t = float(t)
        if tick:
            slo.tick()
        else:
            out.append(slo.evaluate().as_dict())
    return out


def test_burn_rate_slo_gives_the_jax_state_sequence():
    ours = _slo_script(BurnRateSLO)
    assert ours == _slo_script(jslo.BurnRateSLO)
    assert [s["fast_burn"] for s in ours] == [False, False, False, True,
                                              False]
    assert 'dl4jtpu_slo_burn_rate{slo="t",window="short"}' in \
        get_registry().render()


# ----------------------------------------------------------------- server

@pytest.fixture
def served(tiny):
    srv = InferenceServer(tiny, port=0, decode_engine=DecodeEngine(
        tiny, 2, 64)).start()
    yield srv, f"http://127.0.0.1:{srv.port}"
    srv.stop()


def _x(n=2, t=6, seed=0):
    r = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[r.randint(0, V, (n, t))]


def test_programs_list_the_engines_programs_and_add_none(served):
    srv, url = served
    cli = InferenceClient(url)
    cli.predict(_x(3))
    cli.generate([1, 2, 3], 4)
    counts = (srv.engine.trace_count, srv.decode_engine.trace_count)
    st, body = _get(url, "/programs")
    assert st == 200
    assert counts == (srv.engine.trace_count, srv.decode_engine.trace_count)
    mine = {(p["caller"], p["key"]): p for p in body["programs"]}
    assert (srv.engine.id, "b4") in mine           # 3 rows -> rung 4
    assert (srv.decode_engine.id, "step") in mine
    for rec in (mine[(srv.engine.id, "b4")],
                mine[(srv.decode_engine.id, "step")]):
        assert set(rec) >= {"caller", "key", "flops", "bytes",
                            "memory_bytes", "compile_seconds", "launches"}
        assert rec["flops"] > 0 and rec["bytes"] > 0
        assert rec["compile_seconds"] > 0
        assert rec["memory_bytes"] is None          # eager off the card
        assert rec["launches"] == {}                # plain versions
    text = get_registry().render()
    assert (f'dl4jtpu_program_flops{{caller="{srv.engine.id}",key="b4"}}'
            in text)


def test_trace_and_journal_carry_the_header_trace_id(served, traced):
    srv, url = served
    from deeplearning4j_tpu_torch.serving.wire import ndarray_to_b64
    hdr = {"x-trace-context": "fleet-42;router#a1"}
    st, _ = _post(url, "/predict", {"ndarray": ndarray_to_b64(_x())}, hdr)
    assert st == 200
    st, _ = _post(url, "/generate", {"tokens": [1, 2, 3],
                                     "max_new_tokens": 3},
                  {"x-trace-context": "fleet-43"})
    assert st == 200
    st, doc = _get(url, "/trace")
    spans = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "B":
            spans.setdefault(e["args"].get("trace_id"), set()).add(e["name"])
    assert {"http_request", "enqueue", "bucket", "pad", "device",
            "readback"} <= spans["fleet-42"]
    assert {"http_request", "decode_step"} <= spans["fleet-43"]
    st, doc = _get(url, "/requests")
    ids = {(r["source"], r["trace_id"]) for r in doc["records"]}
    assert ("predict", "fleet-42") in ids and ("decode", "fleet-43") in ids


def test_admin_profile_answers_as_the_jax_server(served, tmp_path):
    srv, url = served
    assert _post(url, "/admin/profile", {})[0] == 400
    assert _post(url, "/admin/profile",
                 {"dir": str(tmp_path / "p"), "seconds": -1})[0] == 400
    assert not (tmp_path / "p").exists()
    out = str(tmp_path / "capture")
    st, body = _post(url, "/admin/profile", {"dir": out, "seconds": 0.5})
    assert st == 200 and body["profiling"] == out
    st, body = _post(url, "/admin/profile", {"dir": out, "seconds": 0.5})
    assert st == 409 and body["error"]["type"] == "profile_busy"
    InferenceClient(url).predict(_x())
    deadline = time.monotonic() + 30.0
    while profiling.profile_status()["profiling"]:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    last = profiling.profile_status()["last"]
    assert last["dir"] == out and os.path.dirname(last["trace"]) == out
    assert "traceEvents" in json.load(open(last["trace"]))


def test_profile_env_profiles_fit(tmp_path, monkeypatch):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JaxMLN
    net = port_of(JaxMLN(lstm_conf("plain")).init())
    monkeypatch.setenv("DL4JTPU_PROFILE", str(tmp_path / "fit"))
    net.fit(*batch(0))
    (path,) = (tmp_path / "fit").iterdir()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_train_diagnostics_healthz_and_404(tiny, tmp_path):
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JaxMLN
    net = port_of(JaxMLN(lstm_conf("plain")).init())
    rec = FlightRecorder(sample_every=1)
    net.attach_flight_recorder(rec)
    x, y = batch(2)
    for _ in range(3):
        net.fit(x, y)
    srv = InferenceServer(net, port=0, flight_recorder=rec).start()
    bare = InferenceServer(tiny, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        st, doc = _get(url, "/train/diagnostics")
        assert st == 200
        assert doc["layers"] == ["0:LSTM", "1:LSTM", "2:RnnOutputLayer"]
        assert [r["iteration"] for r in doc["records"]] == [0, 1, 2]
        assert _get(url, "/healthz")[1] == {"status": "ok"}
        bad = x.copy()
        bad[0, 0, 0] = np.nan
        net.fit(bad, y)
        st, h = _get(url, "/healthz")
        assert h["reason"] == "train_non_finite"
        assert h["first_non_finite"] == {"layer": "0:LSTM", "iteration": 3}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"http://127.0.0.1:{bare.port}", "/train/diagnostics")
        assert e.value.code == 404
    finally:
        srv.stop()
        bare.stop()


def test_healthz_degrades_on_fast_burn_and_recovers(served):
    srv, url = served
    clk, counts = _Clock(), {"bad": 0.0, "total": 0.0}
    srv.slo = BurnRateSLO(f"availability:{srv.id}", lambda: counts["bad"],
                          lambda: counts["total"], objective=0.99,
                          clock=clk, min_tick_s=0.0)
    srv.slo.evaluate()
    counts["bad"] += 60
    counts["total"] += 100
    clk.t = 60.0
    st, body = _get(url, "/healthz")
    assert st == 200 and body["reason"] == "slo_fast_burn"
    assert body["slo"]["name"] == f"availability:{srv.id}"
    counts["total"] += 40
    clk.t = 200.0
    srv.slo.tick()
    clk.t = 430.0
    assert _get(url, "/healthz") == (200, {"status": "ok"})


def test_engine_fault_answers_500_and_counts_it(served, monkeypatch):
    srv, url = served
    from deeplearning4j_tpu_torch.serving.wire import ndarray_to_b64

    def boom(*a, **k):
        raise RuntimeError("device lost")
    monkeypatch.setattr(srv.engine, "predict_host", boom)
    c0 = srv._m_engine_errors.value
    st, body = _post(url, "/predict", {"ndarray": ndarray_to_b64(_x())})
    assert st == 500 and body["error"]["type"] == "internal"
    assert srv.last_error == "RuntimeError: device lost"
    assert srv._m_engine_errors.value == c0 + 1
    # the handler counts the response after sending it
    cell = srv._m_responses.labels(server=srv.id, path="/predict",
                                   **{"class": "5xx"})
    deadline = time.monotonic() + 10.0
    while cell.value < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    text = get_registry().render()
    assert (f'dl4jtpu_http_responses_total{{server="{srv.id}",'
            f'path="/predict",class="5xx"}} 1') in text


def test_collectors_merge_two_in_process_servers(tiny, traced):
    a = InferenceServer(tiny, port=0).start()
    rec = FlightRecorder()
    rec.layer_names = ["l0"]
    rec.record(0, np.ones((1, 5), np.float32))
    b = InferenceServer(tiny, port=0, flight_recorder=rec).start()
    try:
        ua, ub = (f"http://127.0.0.1:{s.port}" for s in (a, b))
        InferenceClient(ua).predict(_x())
        InferenceClient(ub).predict(_x(1))
        doc = collect_fleet_trace(ua, extra_urls=[ub])
        assert doc["collectedFrom"] == [ua, ub]
        names = {e.get("name") for e in doc["traceEvents"]}
        assert {"http_request", "device", "train/grad_norm"} <= names
        assert min(e["ts"] for e in doc["traceEvents"] if "ts" in e) == 0
        reqs = collect_requests(ua, extra_urls=[ub])
        assert reqs["collectedFrom"] == [ua, ub]
        assert len(reqs["requests"]) == 2
        assert all(len(r["attempts"]) == 1 for r in reqs["requests"])
    finally:
        a.stop()
        b.stop()


# ------------------------------------------------------------ programs

def test_train_steps_register_without_a_capture():
    from deeplearning4j_tpu.models.multi_layer_network import \
        MultiLayerNetwork as JaxMLN
    net = port_of(JaxMLN(lstm_conf("plain")).init())
    x, y = batch(0)
    net.fit(x, y)
    net.fit(x, y)
    grads, _ = net.compute_gradient_and_score(x, y)
    net.apply_external_updates(grads)
    keys = {p["key"] for p in get_programs().entries()
            if p["caller"] == net._prog_caller}
    assert keys == {f"train_step_b{x.shape[0]}", "apply_updates"}
    assert net._capture_count == 0
    rec = get_programs().get(net._prog_caller, f"train_step_b{x.shape[0]}")
    assert rec["flops"] > 0 and rec["kernel_flops"] == 0


def test_register_program_counts_a_product():
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    rec = get_executor().register_program("test", "mm", torch.mm, (a, b))
    assert rec["flops"] == 2 * 4 * 8 * 3
    assert rec["bytes"] == 4 * (4 * 8 + 8 * 3 + 4 * 3)
    assert get_programs().get("test", "mm") is rec


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_fwd_train",
                                    "lstm2_fwd", "lstm2_fwd_train",
                                    "lstm_bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_kernel_work_is_the_smoke_bound(kernel, dtype):
    import chip_smoke as cs
    flops, nbytes = lstm_cuda.work(kernel, 64, 32, 256,
                                   2 if dtype == "bfloat16" else 4)
    want = max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.PEAK_FLOPS[dtype])
    assert cs.bound(kernel, 64, 32, 256, dtype)[0] == \
        pytest.approx(want * 1e3, rel=1e-12)


@pytest.mark.parametrize("kernel", ["flash_attn_fwd", "flash_attn_dq",
                                    "flash_attn_dkv", "flash_decode",
                                    "flash_decode_paged"])
def test_attention_kernel_work_is_the_smoke_bound(kernel):
    import chip_smoke as cs
    B, H, Dh, C, bs = 8, 4, 32, 64, 16
    if kernel.startswith("flash_attn"):
        c = {"q": torch.zeros(B * H, C, Dh), "causal": True}
        flops, nbytes = attention_cuda.work(kernel, B * H, C, Dh, True)
    else:
        # a program's shapes fix the capacity: every row at its last
        # position
        c = {"q": torch.zeros(B, H, Dh), "pos": torch.full((B,), C - 1),
             "kc": torch.zeros(B, C, H, Dh),
             "pk": torch.zeros(B * C // bs, bs, H, Dh)}
        if kernel == "flash_decode":
            del c["pk"]
        MB = C // bs
        flops, nbytes = decode_cuda.work(
            B, H, Dh, B * C, 4, B * MB if kernel.endswith("paged") else 0)
    want = max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.PEAK_FLOPS["float32"])
    assert cs.attn_bound(kernel, c)[0] == pytest.approx(want * 1e3,
                                                        rel=1e-12)
