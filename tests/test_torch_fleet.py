"""The routed serving tier (serving/router.py, replica.py, autoscale.py)
against the JAX package's, on the CPU.

- ``RetryBudget``, the router's per-replica health state machine
  (healthy -> suspect -> ejected -> recovering -> healthy, driven by
  passive failures, successes and probes under a fake clock) and
  ``Autoscaler.evaluate_once`` (a stub router and fleet, a fake clock)
  reach the JAX package's states and decisions on one scripted event
  sequence.
- The port's ``Router`` in front of port ``InProcessReplica``s serving the
  JAX ``mlp`` and ``tinyattn`` weights (through the JAX checkpoint zip):
  ``/predict`` within 1e-5 of JAX ``build_model(...).output``, greedy
  ``/generate`` tokens equal to the JAX engine's; failover while one
  replica's ``/chaos`` injects 503s; a fast 503
  ``retry_budget_exhausted`` when the budget is spent; a hedged
  ``/predict``; a rolling restart with parity; fleet trace collection
  through the router; scale from zero through ``hold_for_capacity_s``.
- One subprocess replica (``mlp``, ``--device cpu``): start, SIGKILL while
  the router fails over, restart on the same port.
"""

import json
import os
import time

import numpy as np
import pytest

from deeplearning4j_tpu.serving import autoscale as jscale
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.replica import build_model as jax_model
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.monitor import trace
from deeplearning4j_tpu_torch.monitor.collect import collect_fleet_trace
from deeplearning4j_tpu_torch.serving import (Autoscaler, InferenceClient,
                                              InProcessReplica,
                                              ReplicaProcess, RetryBudget,
                                              Router)
from deeplearning4j_tpu_torch.serving import autoscale as pscale
from deeplearning4j_tpu_torch.serving import router as prouter

X = np.arange(12, dtype=np.float32).reshape(3, 4) / 10.0
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


class FakeTime:
    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    """The JAX replicas' models and their checkpoint zips."""
    d = tmp_path_factory.mktemp("jax_zips")
    out = {}
    for name in ("mlp", "tinyattn"):
        jnet = jax_model(name)
        path = str(d / f"{name}.zip")
        write_model(jnet, path)
        out[name] = (jnet, path)
    return out


def _replica(name, zips, **kw):
    rep = InProcessReplica(model=name, device="cpu", **kw).start()
    rep.srv.swap_checkpoint(zips[name][1])
    return rep


def _chaos(url, **cfg):
    c = InferenceClient(url, retries=1)
    try:
        st, body, _ = c.post_raw("/chaos", json.dumps(cfg).encode())
        assert st == 200, body
        return json.loads(body)["chaos"]
    finally:
        c.close()


# ------------------------------------------------ state machines vs JAX

def test_retry_budget_matches_jax():
    script = "sssssssdddddsssdddddddddddddddddddddddssssss"
    got, want = [], []
    for mod, out in ((prouter, got), (jrouter, want)):
        b = mod.RetryBudget(ratio=0.25, initial=3.0, cap=4.0)
        for ev in script:
            if ev == "d":
                b.deposit()
                out.append(round(b.balance, 9))
            else:
                out.append(b.try_spend())
    assert got == want
    assert True in got and False in got


def _health_script(mod, ft):
    r = mod.Router(["http://127.0.0.1:9", "http://127.0.0.1:10"],
                   probe_interval=None, eject_after=2,
                   probe_backoff_base=1.0, probe_backoff_max=8.0,
                   clock=ft.clock, sleep=ft.sleep)
    a, b = r.replicas.values()
    answers = []

    def health():
        v = answers.pop(0)
        if isinstance(v, Exception):
            raise v
        return {"status": v}
    a.probe_client.health = health
    b.probe_client.health = lambda: {"status": "ok"}
    r.prefix_affinity = False
    trail = []

    def snap(tag):
        trail.append((tag, a.state, a.consecutive_failures, a.backoff,
                      a.ejected_until, a.draining, a.degraded,
                      r.health_info()["status"]))
    script = [("fail", "5xx"), ("fail", "timeout"), ("probe", "ok"),
              ("tick", 0.5), ("probe", ConnectionError()), ("tick", 1.0),
              ("probe", "ok"), ("fail", "connect"), ("tick", 2.5),
              ("probe", "degraded"), ("probe", "ok"), ("success", None),
              ("fail", "draining"), ("probe", "draining"), ("probe", "ok"),
              ("fail", "5xx"), ("success", None)]
    for ev, arg in script:
        if ev == "fail":
            r._note_failure(a, arg)
        elif ev == "success":
            r._note_success(a)
        elif ev == "tick":
            ft.t += arg
        else:
            answers.append(arg)
            r.probe_once()
        snap(ev)
    stats = {k: v for k, v in r.stats()["replicas"][a.url].items()}
    r.stop()
    return trail, stats


def test_health_state_machine_matches_jax():
    got = _health_script(prouter, FakeTime())
    want = _health_script(jrouter, FakeTime())
    assert got == want
    states = [t[1] for t in got[0]]
    assert {"suspect", "ejected", "recovering", "healthy"} <= set(states)


class _StubRep:
    def __init__(self):
        self.outstanding = 0
        self.admin_down = False


class _StubSLO:
    def __init__(self):
        self.fast_burn = False

    def evaluate(self):
        return self


class _StubRouter:
    def __init__(self):
        self.replicas, self.slo, self.log = {}, _StubSLO(), []

    def add_upstream(self, url):
        self.replicas[url] = _StubRep()
        self.log.append(("add", url))

    def remove_upstream(self, url, drain_timeout=30.0):
        self.replicas.pop(url, None)
        self.log.append(("remove", url))
        return True


class _StubHandle:
    n = 0

    def __init__(self, log):
        _StubHandle.n += 1
        self.url = f"http://stub:{_StubHandle.n}"
        self.log = log

    def start(self):
        self.log.append(("start", self.url))
        return self

    def wait_ready(self, timeout=None):
        return self

    def stop(self):
        self.log.append(("stop", self.url))


def _scale_script(mod):
    _StubHandle.n = 0
    ft, router = FakeTime(), _StubRouter()
    sc = mod.Autoscaler(router, lambda: _StubHandle(router.log),
                        min_replicas=0, max_replicas=3,
                        scale_up_outstanding=4.0,
                        scale_down_outstanding=1.0, idle_grace_s=5.0,
                        cooldown_s=2.0, clock=ft.clock, sleep=ft.sleep)
    out = []
    # (seconds later, outstanding per live replica, fast burn, wake)
    script = [(0, 0, False, False), (1, 0, False, True),
              (1, 9, False, False), (1, 9, False, False),
              (2, 9, False, False), (2, 5, True, False),
              (2, 0, False, False), (3, 0, False, False),
              (3, 0, False, False), (6, 0, False, False),
              (1, 0, False, False), (7, 0, False, False),
              (7, 0, False, False), (7, 0, False, True),
              (1, 0, False, True)]
    for dt, load, burn, wake in script:
        ft.t += dt
        for rep in router.replicas.values():
            rep.outstanding = load
        router.slo.fast_burn = burn
        if wake:
            sc.wake()
        out.append((sc.evaluate_once(), sc.replica_count,
                    sc.signals()["outstanding_per_replica"]))
    return out, router.log


def test_autoscaler_decisions_match_jax():
    got, want = _scale_script(pscale), _scale_script(jscale)
    assert got == want
    decisions = [d for d, _, _ in got[0]]
    assert "up" in decisions and "down" in decisions


# ------------------------------------------------ the tier on the CPU

def test_router_serves_jax_weights_with_parity(zips):
    from deeplearning4j_tpu_torch.exec.programs import get_programs
    reps = [_replica("mlp", zips), _replica("tinyattn", zips)]
    mlp_router = Router([reps[0].url], probe_interval=None).start()
    tiny_router = Router([reps[1].url], probe_interval=None).start()
    try:
        want = np.asarray(zips["mlp"][0].output(X))
        cli = InferenceClient(f"http://127.0.0.1:{mlp_router.port}")
        for _ in range(3):
            assert np.max(np.abs(cli.predict(X) - want)) < 1e-5
        jt = zips["tinyattn"][0]
        x = np.eye(16, dtype=np.float32)[np.array([PROMPT, PROMPT[::-1]])]
        tcli = InferenceClient(f"http://127.0.0.1:{tiny_router.port}")
        assert np.max(np.abs(tcli.predict(x) - np.asarray(jt.output(x)))) \
            < 1e-5
        jeng = JaxDecode(jt, slots=4, max_len=64).start()
        try:
            jtok = jeng.generate(PROMPT, 12)["tokens"]
        finally:
            jeng.stop()
        assert tcli.generate(PROMPT, 12)["tokens"] == jtok
        assert get_programs().get(reps[1].srv.decode_engine.id, "step")
        cli.close()
        tcli.close()
    finally:
        mlp_router.stop()
        tiny_router.stop()
        for r in reps:
            r.stop()


def test_failover_budget_and_hedge(zips):
    reps = [_replica("mlp", zips, chaos=True) for _ in range(2)]
    router = Router([r.url for r in reps], probe_interval=None,
                    eject_after=100, hedge=False,
                    retry_budget=RetryBudget(ratio=1.0, initial=20.0,
                                             cap=50.0)).start()
    want = np.asarray(zips["mlp"][0].output(X))
    cli = InferenceClient(f"http://127.0.0.1:{router.port}", retries=1)
    try:
        _chaos(reps[0].url, fail_next=100, error_code=503)
        for _ in range(8):
            assert np.max(np.abs(cli.predict(X) - want)) < 1e-5
        st = router.stats()["replicas"][reps[0].url]
        assert st["draining"] is True        # 503 pulls without ejection
        # both failing and the budget spent: a fast 503 at the router
        _chaos(reps[1].url, fail_next=100, error_code=500)
        router.budget = RetryBudget(ratio=0.0, initial=0.0)
        t0 = time.perf_counter()
        status, body, rid, _ = router.handle(
            "/predict", json.dumps({"ndarray": {
                "shape": [1, 4], "dtype": "float32",
                "data": ""}}).encode())
        assert time.perf_counter() - t0 < 5.0
        err = json.loads(body)["error"]
        assert (status, err["type"]) == (503, "retry_budget_exhausted")
        assert err["request_id"] == rid
        for r in reps:
            _chaos(r.url, fail_next=0)
        # hedging: the slow replica loses to the hedge
        router.budget = RetryBudget(ratio=1.0, initial=20.0)
        router.hedge_enabled, router.hedge_delay_ms = True, 20.0
        for r in reps:
            rs = router.replicas[r.url]
            rs.draining, rs.state = False, "healthy"
        _chaos(reps[0].url, latency_ms=400.0)
        _chaos(reps[1].url, latency_ms=0.0)
        router._pick = (lambda exclude, hint=None, want_prefill=False,
                        _p=router._pick, _r=router.replicas[reps[0].url]:
                        _r if _r.url not in exclude else _p(exclude))
        status, body, rid, _ = router.handle(
            "/predict", json.dumps({"ndarray": _b64(X)}).encode())
        assert status == 200
        rec = router.journal.snapshot()["records"][-1]
        assert rec["hedged"] and rec["outcome"] == "hedge_win"
        assert rec["hedge_winner"].endswith("#a1")
    finally:
        cli.close()
        router.stop()
        for r in reps:
            r.stop()


def _b64(x):
    from deeplearning4j_tpu_torch.serving.wire import ndarray_to_b64
    return ndarray_to_b64(x)


def test_rolling_restart_and_fleet_trace(zips):
    reps = [_replica("mlp", zips) for _ in range(2)]
    router = Router([r.url for r in reps], probe_interval=None).start()
    url = f"http://127.0.0.1:{router.port}"
    cli = InferenceClient(url)
    want = np.asarray(zips["mlp"][0].output(X))
    try:
        def restarter(u):
            rep = next(r for r in reps if r.url == u)
            rep.restart()
            rep.srv.swap_checkpoint(zips["mlp"][1])
        router.rolling_restart(restarter, warmup_shape=[4],
                               warmup_max_batch=4)
        states = {u: s["state"] for u, s in
                  router.stats()["replicas"].items()}
        assert set(states.values()) == {"healthy"}
        for _ in range(4):
            assert np.max(np.abs(cli.predict(X) - want)) < 1e-5
        trace.enable(True)
        try:
            st, _, hdrs = cli.post_raw("/predict", json.dumps(
                {"ndarray": _b64(X)}).encode(),
                headers={"x-request-id": "fleet-1"})
            assert st == 200
            doc = collect_fleet_trace(url)
        finally:
            trace.enable(False)
        names = {(e.get("name"), (e.get("args") or {}).get("trace_id"))
                 for e in doc["traceEvents"] if e.get("ph") == "B"}
        for span in ("route", "attempt", "http_request", "device"):
            assert (span, "fleet-1") in names, span
    finally:
        cli.close()
        router.stop()
        for r in reps:
            r.stop()


def test_scale_from_zero_holds_then_serves(zips):
    from deeplearning4j_tpu_torch.monitor import get_registry
    router = Router([], probe_interval=None, hold_for_capacity_s=60.0)
    spawned = []

    def spawn():
        spawned.append(InProcessReplica(model="mlp", device="cpu"))
        return spawned[-1]
    scaler = Autoscaler(router, spawn, min_replicas=0, max_replicas=1,
                        idle_grace_s=0.0, cooldown_s=0.0, interval_s=0.05)
    router.wake_hook = scaler.wake
    router.start()
    scaler.start()
    cli = InferenceClient(f"http://127.0.0.1:{router.port}")
    try:
        t0 = time.perf_counter()
        out = cli.predict(X)
        held = time.perf_counter() - t0
        assert out.shape == (3, 3) and held < 60.0
        # one replica came up for the held request (it may already be
        # draining: the grace period is 0)
        assert len(spawned) == 1
        holds = get_registry().get("dl4jtpu_router_capacity_holds_total")
        assert [c.value for k, c in holds.children()
                if k == (router.id, "served")] == [1.0]
        # idle: the fleet drains back to zero
        deadline = time.monotonic() + 30.0
        while scaler.replica_count and time.monotonic() < deadline:
            time.sleep(0.05)
        assert scaler.replica_count == 0 and not router.replicas
    finally:
        cli.close()
        scaler.stop()
        router.stop()


def test_subprocess_replica_killed_and_restarted(zips, tmp_path):
    """The one test that spawns: an ``mlp`` replica on the CPU beside an
    in-process one; SIGKILL mid-traffic fails over, restart reuses the
    port and serves the checkpoint's weights again. Every wait is
    bounded (``wait_ready``'s timeout, the clients' 30 s)."""
    inproc = _replica("mlp", zips)
    proc = ReplicaProcess(str(tmp_path), model="mlp", device="cpu",
                          checkpoint=zips["mlp"][1], name="cpu0")
    try:
        proc.start().wait_ready(timeout=180)
        assert proc.ready_seconds is not None
        router = Router([inproc.url, proc.url], probe_interval=None,
                        hedge=False).start()
        cli = InferenceClient(f"http://127.0.0.1:{router.port}")
        want = np.asarray(zips["mlp"][0].output(X))
        try:
            for _ in range(4):
                assert np.max(np.abs(cli.predict(X) - want)) < 1e-5
            port = proc.port
            proc.kill()
            for _ in range(6):
                assert np.max(np.abs(cli.predict(X) - want)) < 1e-5
            proc.start().wait_ready(timeout=180)
            assert proc.port == port
            direct = InferenceClient(proc.url)
            assert np.max(np.abs(direct.predict(X) - want)) < 1e-5
            direct.close()
        finally:
            cli.close()
            router.stop()
        log = open(proc.log_path).read()
        assert log.count("REPLICA_READY") == 2
        assert "REPLICA_SWAPPED" in log and "nvcc_runs=[]" in log
    finally:
        proc.stop()
        inproc.stop()


def test_replica_refuses_cuda_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from deeplearning4j_tpu_torch.serving.replica import main
    port_file = str(tmp_path / "r.port")
    assert main(["--model", "mlp", "--port-file", port_file]) != 0
    assert not os.path.exists(port_file)
