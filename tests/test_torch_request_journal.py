"""The request journal in the port (``monitor/reqlog.py``, the batcher's
and the decode engine's terminal records and SLO histograms, the server's
request ids, ``/requests``, ``/metrics`` and ``/healthz``'s pool signal)
held against the JAX package's, on the CPU.

The model is the JAX tests' own TinyTransformer (13-token vocabulary,
d_model 32, 4 heads, 2 blocks, kv_block_size 8), carried across as numpy
arrays; the batcher's record tests use an identity engine.
Pinned here:

- ``RequestLog`` and ``new_record`` answer as the JAX ones (``ts`` set
  aside);
- every exit of a request leaves exactly one record with the JAX
  package's outcome and field set: ``ok``, ``shed``, ``deadline`` and
  ``error`` in the batcher, ``max_new``, ``eos``, ``shed`` and ``error``
  in the decode engine (wall values set aside);
- ``stats()`` of the engine and the batcher have the JAX key sets;
- over HTTP: a minted or echoed ``x-request-id`` on every response and in
  the journal, ``x-tenant`` / ``x-priority`` carried, ``?n=`` and its 400,
  the 429's one ``shed`` record, ``/predict``'s phases, a wrapped
  journal's accounting, ``/healthz`` reading ``kv_pool_exhausted`` with
  the pool's occupancy, ``/metrics`` rendering the new series, and a p99
  exemplar that resolves to a record.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest

from deeplearning4j_tpu.monitor.reqlog import RequestLog as JaxLog
from deeplearning4j_tpu.monitor.reqlog import new_record as jax_new_record
from deeplearning4j_tpu.serving.batcher import MicroBatcher as JaxBatcher
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode

from deeplearning4j_tpu_torch.monitor import RequestLog, new_record
from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, DeadlineExceededError)
from deeplearning4j_tpu_torch.serving import (DecodeEngine, InferenceClient,
                                              InferenceServer, MicroBatcher)
from deeplearning4j_tpu_torch.serving.decode import _Request
from deeplearning4j_tpu_torch.serving.wire import ndarray_to_b64
from test_torch_kv_migrate import jax_tiny
from test_torch_regularised_training import port_of

V, MAXLEN, BS = 13, 64, 8
X = np.arange(12, dtype=np.float32).reshape(3, 4) / 10.0


@pytest.fixture(scope="module")
def tiny():
    jnet = jax_tiny()
    return jnet, port_of(jnet)


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, V, size=n))) for n in sizes]


def _kw(**kw):
    return dict(dict(slots=2, max_len=MAXLEN, kv="paged", kv_block_size=BS,
                     prefix_cache=True, chunk_tokens=8), **kw)


def _walls(rec):
    """A record with its clock values set aside: ``ts``, the walls, the
    phases' durations (their names kept)."""
    out = {k: v for k, v in rec.items()
           if k not in ("ts", "wall_seconds", "ttft_seconds",
                        "first_prefill_chunk_seconds", "engine", "batcher")}
    if "phases" in out:
        out["phases"] = sorted(out["phases"])
    return out


# --------------------------------------------------------------- the ring

def _ring_script(Log, record):
    log = Log(capacity=4)
    out = []
    for i in range(10):
        log.append(record(f"r{i}", "predict", outcome="ok", rows=i))
    out.append((len(log), log.total, log.dropped))
    out.append([r["request_id"] for r in log.tail(10)])
    out.append([r["request_id"] for r in log.tail(2)])
    out.append((log.tail(0), log.tail(-1)))
    out.append((log.find("r9")["rows"], log.find("r0")))
    snap = log.snapshot(2)
    out.append({k: v for k, v in snap.items() if k != "records"})
    out.append([_walls(r) for r in snap["records"]])
    out.append(_walls(record(None, "decode")))
    out.append((Log(0).capacity, len(log.clear()), log.total))
    return out


def test_the_ring_and_its_records_answer_as_the_jax_ones():
    assert _ring_script(RequestLog, new_record) == \
        _ring_script(JaxLog, jax_new_record)
    rec = new_record(None, "decode")
    assert abs(rec["ts"] - time.time()) < 5.0 and rec["trace_id"] is None


# -------------------------------------------------------------- the batcher

class _Identity:
    """``predict_host`` without ``phases=``: the batcher still serves,
    unphased."""

    def predict_host(self, x):
        return np.asarray(x)


def _batcher_exits(Batcher):
    """Every exit of a request through one batcher class; each journal's
    records, clocks set aside."""
    mb = Batcher(_Identity(), max_queue=1, journal_capacity=8)
    mb._thread = threading.current_thread()      # a worker that never drains
    mb.submit(X, request_id="fills-queue")
    with pytest.raises(Exception, match="queue full"):
        mb.submit(X, block=False, request_id="gets-shed", tenant="acme")
    mb2 = Batcher(_Identity(), journal_capacity=8).start()
    mb2.stop()
    with pytest.raises(Exception):
        mb2.submit(X, request_id="too-late")
    mb3 = Batcher(_Identity(), journal_capacity=8).start()
    try:
        with pytest.raises(Exception):
            mb3.submit(X, deadline_ms=0.0, request_id="expired").result(10)
        assert mb3.submit(X, request_id="served",
                          priority="batch").result(10).shape == X.shape
    finally:
        mb3.stop()
    return [[_walls(r) for r in m.journal.tail()] for m in (mb, mb2, mb3)]


def test_batcher_exits_leave_the_jax_records():
    mine, theirs = _batcher_exits(MicroBatcher), _batcher_exits(JaxBatcher)
    assert mine == theirs
    assert [[r["outcome"] for r in j] for j in mine] == \
        [["shed"], ["error"], ["deadline", "ok"]]
    mb = MicroBatcher(_Identity(), journal_capacity=8).start()
    try:
        with pytest.raises(DeadlineExceededError):
            mb.submit(X, deadline_ms=0.0).result(10)
    finally:
        mb.stop()
    with pytest.raises(BatcherStoppedError):
        mb.submit(X)
    st = mb.stats()
    assert st["rejected"] == {"queue_full": 0, "stopped": 1, "deadline": 1}
    assert st["journal"] == {"capacity": 8, "records": 2, "total": 2,
                             "dropped": 0}


def test_batcher_stats_keys_are_the_jax_ones():
    mine = MicroBatcher(_Identity()).stats()
    theirs = JaxBatcher(_Identity()).stats()
    assert sorted(mine) == sorted(theirs)
    assert sorted(mine["slo"]) == sorted(theirs["slo"])
    assert sorted(mine["slo"]["queue"]) == sorted(theirs["slo"]["queue"])


# ------------------------------------------------------- the decode engine

def _decode_records(eng, prompts):
    eng.start()
    try:
        for i, p in enumerate(prompts):
            eng.generate(p, max_new_tokens=4, request_id=f"g{i}",
                         tenant="acme" if i % 2 else "default",
                         priority="batch")
        saved, eng.max_queue = eng.max_queue, 0
        with pytest.raises(Exception):
            eng.submit(prompts[0], max_new_tokens=2, request_id="shed-me")
        eng.max_queue = saved
        return eng.journal.tail(), eng.stats()
    finally:
        eng.stop()


def test_decode_records_and_stats_keys_are_the_jax_engines(tiny):
    jnet, net = tiny
    stem = _prompts([16], seed=1)[0]
    prompts = [stem + p for p in _prompts((4, 9, 4), seed=2)] + [stem[:3]]
    kw = _kw(host_kv_bytes=1 << 20)
    mine, st = _decode_records(DecodeEngine(net, **kw), prompts)
    theirs, jst = _decode_records(JaxDecode(jnet, **kw), prompts)
    assert [_walls(r) for r in mine] == [_walls(r) for r in theirs]
    assert [r["outcome"] for r in mine] == ["max_new"] * 4 + ["shed"]
    # the last prompt's 3 tokens reuse 2 by copy-on-write
    assert [r["kv"]["prefix_hit_depth"] for r in mine[:4]] == [0, 16, 16, 2]
    for rec in mine[:4]:
        ph = rec["phases"]
        assert abs(ph["queue"] + ph["prefill"] + ph["decode"]
                   - rec["wall_seconds"]) < 1e-6
        assert 0 <= rec["ttft_seconds"] <= rec["wall_seconds"]
    assert sorted(st) == sorted(jst)
    assert sorted(st["kv"]) == sorted(jst["kv"])
    assert sorted(st["slo"]) == sorted(jst["slo"]) == ["itl", "queue", "ttft"]
    assert st["slo"]["ttft"]["count"] == 4 and st["slo"]["itl"]["count"] == 12
    assert st["journal"] == {"capacity": 512, "records": 5, "total": 5,
                             "dropped": 0}
    assert st["weight_bytes"] == jst["weight_bytes"]


def test_eos_and_stop_leave_their_outcomes(tiny):
    _, net = tiny
    prompt = _prompts([12], seed=8)[0]
    eng = DecodeEngine(net, **_kw()).start()
    try:
        toks = eng.generate(prompt, max_new_tokens=6)["tokens"]
    finally:
        eng.stop()
    eos = DecodeEngine(net, eos_id=toks[2], **_kw()).start()
    try:
        assert eos.generate(prompt, max_new_tokens=6, request_id="e")[
            "tokens"] == toks[:toks.index(toks[2]) + 1]
    finally:
        eos.stop()
    assert eos.journal.find("e")["outcome"] == "eos"
    idle = DecodeEngine(net, **_kw())
    with idle._cv:
        idle._queue.append(_Request(prompt, 4, 0, 0.0, 0, Future(),
                                    rid="queued"))
    idle.stop()
    rec = idle.journal.find("queued")
    assert rec["outcome"] == "error" and "prefill" not in rec["phases"]


# ------------------------------------------------------------------ HTTP

def _post(url, path, payload, headers=None):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        body = r.read().decode()
        return r.status, body, dict(r.headers)


@pytest.fixture
def served(tiny):
    _, net = tiny
    eng = DecodeEngine(net, **_kw(host_kv_bytes=1 << 20))
    srv = InferenceServer(net, port=0, decode_engine=eng).start()
    yield srv, f"http://127.0.0.1:{srv.port}"
    srv.stop()


def test_request_ids_are_minted_echoed_and_journaled(served):
    srv, url = served
    gen = {"tokens": _prompts([20])[0], "max_new_tokens": 4}
    st, _, hdrs = _post(url, "/generate", gen)
    minted = hdrs["x-request-id"]
    assert st == 200 and minted.startswith(f"req-{srv._rid_prefix}-")
    assert hdrs["x-model-version"] == "0"
    st, _, hdrs = _post(url, "/generate", gen,
                        {"x-request-id": "my-rid-7", "x-tenant": "acme",
                         "x-priority": "batch"})
    assert st == 200 and hdrs["x-request-id"] == "my-rid-7"
    st, _, hdrs = _post(url, "/generate", gen)
    assert hdrs["x-request-id"] not in (minted, "my-rid-7")
    st, body, _ = _get(url, "/requests")
    doc = json.loads(body)
    assert doc["server"] == srv.id and doc["total"] == 3
    by_rid = {r["request_id"]: r for r in doc["records"]}
    assert minted in by_rid and hdrs["x-request-id"] in by_rid
    rec = by_rid["my-rid-7"]
    assert (rec["source"], rec["outcome"], rec["tenant"],
            rec["priority"]) == ("decode", "max_new", "acme", "batch")
    assert sorted(rec["phases"]) == ["decode", "prefill", "queue"]
    assert sorted(rec["kv"]) == ["host_restores", "peak_blocks",
                                 "prefix_hit_depth"]
    assert rec["kv"]["prefix_hit_depth"] == 16        # the first's chain
    st, body, _ = _get(url, "/requests?n=1")
    assert len(json.loads(body)["records"]) == 1
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url, "/requests?n=junk")
    assert e.value.code == 400
    st, body, hdrs = _post(url, "/nope", {}, {"x-request-id": "lost"})
    assert st == 404 and body["error"]["request_id"] == "lost"
    assert hdrs["x-request-id"] == "lost"


def test_a_full_decode_queue_answers_429_with_one_shed_record(served):
    srv, url = served
    eng = srv.decode_engine
    before = eng.journal.total
    eng.max_queue = 0
    try:
        st, body, hdrs = _post(url, "/generate",
                               {"tokens": [1, 2], "max_new_tokens": 2},
                               {"x-request-id": "shed-me"})
    finally:
        eng.max_queue = 256
    assert st == 429 and hdrs["x-request-id"] == "shed-me"
    assert body["error"]["request_id"] == "shed-me"
    assert eng.journal.total == before + 1
    rec = eng.journal.find("shed-me")
    assert rec["outcome"] == "shed" and rec["tokens_out"] == 0


def test_predict_records_carry_the_merged_calls_phases(tiny):
    _, net = tiny
    srv = InferenceServer(net, port=0, journal_capacity=8).start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        x = np.eye(V, dtype=np.float32)[np.arange(6) % V][None]
        st, _, hdrs = _post(url, "/predict", {"ndarray": ndarray_to_b64(x)},
                            {"x-request-id": "pred-1", "x-tenant": "acme",
                             "x-priority": "batch"})
        assert st == 200 and hdrs["x-request-id"] == "pred-1"
        assert hdrs["x-model-version"] == "0"
        rec = srv.batcher.journal.find("pred-1")
        assert (rec["source"], rec["outcome"], rec["tenant"],
                rec["priority"], rec["rows"]) == ("predict", "ok", "acme",
                                                  "batch", 1)
        assert sorted(rec["phases"]) == ["bucket", "device", "pad",
                                         "queue", "readback"]
        assert all(v >= 0 for v in rec["phases"].values())
        cli = InferenceClient(url)
        for _ in range(10):
            cli.predict(x)
        doc = json.loads(_get(url, "/requests")[1])
        assert len(doc["records"]) == 8
        assert doc["total"] - doc["dropped"] == 8 and doc["total"] == 11
    finally:
        srv.stop()


def test_healthz_reads_the_exhausted_pool_while_the_head_waits(tiny):
    """Two requests of 6 blocks each on a pool of 8: the second waits at
    the head of the queue while the first decodes (its first tick held
    at a gate), and /healthz says so with the pool's occupancy."""
    _, net = tiny
    eng = DecodeEngine(net, **_kw(kv_blocks=9))
    gate, tick = threading.Event(), eng._tick

    def gated(live):
        gate.wait(30)
        return tick(live)
    eng._tick = gated
    a = eng.submit(_prompts([20], seed=1)[0], max_new_tokens=24)
    b = eng.submit(_prompts([20], seed=2)[0], max_new_tokens=24)
    srv = InferenceServer(net, port=0, decode_engine=eng).start()
    cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
    try:
        deadline = time.time() + 30
        while not eng.kv_exhausted and time.time() < deadline:
            time.sleep(0.01)
        h = cli.health()
        assert (h["status"], h["reason"]) == ("degraded", "kv_pool_exhausted")
        assert h["kv"] == eng.kv_pool_info()
        assert (h["kv"]["blocks_in_use"], h["kv"]["blocks"]) == (6, 8)
        gate.set()
        a.result(60)
        b.result(60)
        assert cli.health() == {"status": "ok"}
        assert eng.stats()["kv"]["exhausted_events"] == 1
    finally:
        gate.set()
        srv.stop()


def test_metrics_render_and_a_p99_exemplar_resolves(served):
    srv, url = served
    for i, p in enumerate(_prompts((20, 20, 12), seed=4)):
        assert _post(url, "/generate", {"tokens": p, "max_new_tokens": 3},
                     {"x-request-id": f"m{i}"})[0] == 200
    st, text, hdrs = _get(url, "/metrics")
    assert st == 200 and hdrs["Content-Type"].startswith("text/plain")
    for series in ("dl4jtpu_decode_ttft_seconds_bucket",
                   "dl4jtpu_decode_itl_seconds_count",
                   "dl4jtpu_decode_queue_seconds_sum",
                   "dl4jtpu_kv_host_tier_blocks",
                   "dl4jtpu_kv_host_tier_bytes",
                   "dl4jtpu_kv_migrate_exports_total",
                   "dl4jtpu_kv_host_restores_total",
                   "dl4jtpu_serving_requests_total"):
        assert f'{series}{{' in text, series
    assert f'engine="{srv.decode_engine.id}"' in text
    slo = srv.stats()["decode"]["slo"]["ttft"]
    p99 = slo["p99_ms"] / 1e3
    rid, _ = srv.decode_engine._m_ttft.exemplar_for(p99)
    doc = json.loads(_get(url, "/requests")[1])
    assert rid in {r["request_id"] for r in doc["records"]}
    assert slo["exemplars"][-1][1] in {"m0", "m1", "m2"}
