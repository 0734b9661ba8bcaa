"""The retry primitive, the fault injectors and the client's retries
against the JAX package's, on the CPU.

- ``retry_call``: the same delays, attempts, outcomes and errors as the
  JAX package's under one seeded RNG and one fake clock (success after
  transient failures, exhausted attempts, a spent deadline, a fatal
  error, ``give_up``), and the same ``dl4jtpu_retry_*`` series.
- ``default_classifier``: the same verdict for every kind of error.
- ``resilience.faults``: ``ServerFaultInjector``'s ``configure`` /
  ``describe`` and its injection pattern; ``FlakyIterator``,
  ``FlakyEngine``, ``FlakyBroker``, ``CrashAfter``, ``WorkerChaos``;
  ``BlackholeProxy`` forwarding, then starving a socket.
- ``InferenceClient``: 429 retried with backoff, 503 / 504 / 400 raised
  as their typed errors after one attempt; the requests a stub server
  sees are the JAX client's.
"""

import collections
import http.server
import json
import random
import socket
import threading
import urllib.error

import numpy as np
import pytest

from deeplearning4j_tpu.resilience import errors as jerr
from deeplearning4j_tpu.resilience import faults as jfaults
from deeplearning4j_tpu.resilience import retry as jretry
from deeplearning4j_tpu.serving.client import InferenceClient as JaxClient

from deeplearning4j_tpu_torch.resilience import errors as perr
from deeplearning4j_tpu_torch.resilience import faults as pfaults
from deeplearning4j_tpu_torch.resilience import retry as pretry
from deeplearning4j_tpu_torch.serving.client import InferenceClient

Record = collections.namedtuple("Record", "key value")
PKGS = {"jax": (jretry, jerr, jfaults), "port": (pretry, perr, pfaults)}


class FakeTime:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _run(pkg, script, policy_kw, give_up_after=None):
    """Drive ``retry_call`` through ``script`` (errors by kind, or
    "ok"); returns the sleeps, the calls and the outcome."""
    retry, err, _ = PKGS[pkg]
    kinds = {"transient": lambda: err.TransientError("flap"),
             "conn": lambda: ConnectionResetError("reset"),
             "overload": lambda: err.ServerOverloadedError("429"),
             "fatal": lambda: err.FatalError("auth"),
             "value": lambda: ValueError("bad")}
    ft, calls = FakeTime(), []

    def fn(x):
        calls.append(x)
        step = script[min(len(calls), len(script)) - 1]
        ft.t += 0.01                          # each attempt takes 10 ms
        if step == "ok":
            return x * 2
        raise kinds[step]()
    give_up = None
    if give_up_after is not None:
        def give_up():
            return len(calls) >= give_up_after
    try:
        out = retry.retry_call(fn, 21, policy=retry.RetryPolicy(**policy_kw),
                               component=f"parity_{pkg}", give_up=give_up,
                               sleep=ft.sleep, clock=ft.clock,
                               rng=random.Random(1234))
        result = ("ok", out)
    except BaseException as e:  # noqa: BLE001 -- compared by kind
        result = (type(e).__name__, getattr(e, "attempts", None),
                  type(e.__cause__).__name__ if e.__cause__ else None)
    return ft.sleeps, len(calls), result


CASES = {
    "recovers": (["conn", "transient", "overload", "ok"], {}),
    "exhausted": (["conn"], dict(max_attempts=4, base_delay=0.1)),
    "deadline": (["transient"], dict(max_attempts=None, deadline=1.0,
                                     base_delay=0.2, max_delay=0.7)),
    "fatal": (["conn", "fatal"], {}),
    "value": (["value"], {}),
    "give_up": (["conn"], dict(max_attempts=None)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_retry_call_matches_jax(case):
    script, kw = CASES[case]
    gu = 3 if case == "give_up" else None
    got = _run("port", script, kw, gu)
    want = _run("jax", script, kw, gu)
    assert got == want
    # the metric series carry the same counts under the JAX names
    from deeplearning4j_tpu.monitor import get_registry as jreg
    from deeplearning4j_tpu_torch.monitor import get_registry as preg

    def counts(reg, pkg):
        fam = reg().get("dl4jtpu_retry_attempts_total")
        return sorted((k[1], c.value) for k, c in fam.children()
                      if k[0] == f"parity_{pkg}")
    assert counts(preg, "port") == counts(jreg, "jax")


def _errors(err):
    def http(code):
        return urllib.error.HTTPError("http://x", code, "m", None, None)
    return [err.TransientError(), err.FatalError(),
            err.ServerOverloadedError(), err.DeadlineExceededError(),
            err.BatcherStoppedError(), err.RetriesExhaustedError("x"),
            err.InjectedFaultError("x", 503), http(429), http(500),
            http(502), http(503), http(504), http(400),
            ConnectionResetError(), ConnectionRefusedError(),
            TimeoutError(), socket.timeout(), BrokenPipeError(),
            urllib.error.URLError("down"), ValueError(), KeyError("k"),
            FileNotFoundError(), RuntimeError()]


def test_default_classifier_gives_the_jax_verdicts():
    got = [pretry.default_classifier(e) for e in _errors(perr)]
    want = [jretry.default_classifier(e) for e in _errors(jerr)]
    assert got == want
    assert sum(got) == 12          # the transient ones among them


def test_retryable_decorator_and_error_types():
    calls = []

    @pretry.retryable(pretry.RetryPolicy(max_attempts=3, base_delay=0.001,
                                         max_delay=0.002), component="deco")
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise perr.TransientError("again")
        return "done"
    assert flaky() == "done" and len(calls) == 3
    e = perr.InjectedFaultError("x", code="503")
    assert e.code == 503 and isinstance(e, RuntimeError)
    assert issubclass(perr.StreamStalledError, TimeoutError)
    assert issubclass(perr.RetryBudgetExhaustedError, RuntimeError)


def _inject_pattern(faults, err, cfgs):
    inj = faults.ServerFaultInjector(fail_rate=0.25)
    seen = []
    for i, cfg in enumerate(cfgs):
        if cfg:
            inj.configure(**cfg)
        try:
            inj.maybe_inject("/predict")
            seen.append(None)
        except err.InjectedFaultError as e:
            seen.append(e.code)
    return seen, inj.describe()


def test_server_fault_injector_matches_jax():
    cfgs = [None] * 6 + [{"fail_next": 3, "error_code": 503}] \
        + [None] * 5 + [{"fail_rate": 0.0, "status": 502, "latency_ms": 0}] \
        + [None] * 3 + [{"fail_next": 1}]
    got = _inject_pattern(pfaults, perr, cfgs)
    want = _inject_pattern(jfaults, jerr, cfgs)
    assert got == want
    seen, desc = got
    assert seen[3] == 500 and seen[6:9] == [503, 503, 503]
    assert desc["injected_faults"] == sum(c is not None for c in seen)


def test_flaky_wrappers_match_jax():
    def drive(faults):
        out = []
        it = faults.FlakyIterator(iter(range(5)), errors={
            1: ValueError("one")})
        for _ in range(5):
            try:
                out.append(next(it))
            except (ValueError, StopIteration) as e:
                out.append(type(e).__name__)

        class Eng:
            def predict_host(self, x):
                return x * 2

            def predict(self, x):
                return x + 1
        eng = faults.FlakyEngine(Eng(), fail_calls={0: RuntimeError("x")})
        x = np.ones((3, 2))
        try:
            eng.predict_host(x)
        except RuntimeError:
            out.append("failed")
        out.append(eng.predict_host(x).sum())
        out.append((eng.calls, eng.rows_seen))

        class Broker:
            def poll(self):
                return [Record(b"k", b"v")]

            def send(self, m):
                return m
        br = faults.FlakyBroker(Broker(), fail_polls={0: OSError("p")},
                                corrupt_at={1})
        try:
            br.poll()
        except OSError:
            out.append("poll failed")
        out.append(br.poll())
        out.append(br.send("m"))
        crash = faults.CrashAfter(3)
        crash.iteration_done(None, 2, 0)
        try:
            crash.iteration_done(None, 3, 0)
        except faults.SimulatedCrash:
            out.append("crashed")
        out.append(crash.fired)
        wc = faults.WorkerChaos.parse("slow_ms=5, die_at_step=9")
        out.append((wc.slow_ms, wc.die_at_step))
        with pytest.raises(ValueError, match="unknown worker-chaos key"):
            faults.WorkerChaos.parse("nap=1")
        return out
    assert drive(pfaults) == drive(jfaults)
    assert issubclass(pfaults.SimulatedCrash, BaseException)
    assert not issubclass(pfaults.SimulatedCrash, Exception)


class _Echo(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        self.server.seen.append(json.loads(body.decode())["tokens"])
        script = self.server.script
        code = script.pop(0) if script else 200
        out = (json.dumps({"tokens": [7]}) if code == 200 else json.dumps(
            {"error": {"type": "t", "message": f"status {code}"}})).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)


def _stub(script):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    srv.seen, srv.script = [], list(script)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.mark.parametrize("script,raises", [
    ([429, 429], None), ([429, 429, 429, 429], "ServerOverloadedError"),
    ([503], "BatcherStoppedError"), ([504], "DeadlineExceededError"),
    ([400], "ValueError"), ([409], "ValueError"),
    ([500], "RuntimeError")])
def test_client_classifies_and_retries_as_jax(script, raises):
    def drive(cls):
        srv = _stub(script)
        cli = cls(f"http://127.0.0.1:{srv.server_address[1]}", retries=3)
        cli.retry_policy = type(cli.retry_policy)(
            max_attempts=3, base_delay=0.001, max_delay=0.002)
        try:
            out = cli.generate([1, 2], 1)
            got = ("ok", out["tokens"])
        except Exception as e:  # noqa: BLE001 -- compared by kind
            cause = e.__cause__
            got = (type(e).__name__,
                   type(cause).__name__ if cause is not None else None)
        finally:
            cli.close()
            srv.shutdown()
            srv.server_close()
        return got, len(srv.seen)
    got, want = drive(InferenceClient), drive(JaxClient)
    assert got == want
    if raises == "ServerOverloadedError":
        assert got == (("RetriesExhaustedError", raises), 3)
    elif raises is None:
        assert got == (("ok", [7]), 3)
    else:
        assert got == ((raises, None), 1)


def test_client_post_raw_returns_status_as_data():
    srv = _stub([503])
    cli = InferenceClient(f"http://127.0.0.1:{srv.server_address[1]}")
    try:
        st, body, hdrs = cli.post_raw("/generate", json.dumps(
            {"tokens": [3]}).encode(), headers={"x-request-id": "r1"})
        assert st == 503 and json.loads(body)["error"]["message"] == \
            "status 503"
        assert hdrs["Content-Type"] == "application/json"
        st, _, _ = cli.post_raw("/generate", b'{"tokens": [4]}')
        assert st == 200 and srv.seen == [[3], [4]]
    finally:
        cli.close()
        srv.shutdown()
        srv.server_close()


def test_blackhole_proxy_forwards_then_starves():
    srv = _stub([])
    proxy = pfaults.BlackholeProxy(srv.server_address[1]).start()
    try:
        cli = InferenceClient(f"http://127.0.0.1:{proxy.port}",
                              timeout=0.5, retries=1)
        assert cli.generate([1], 1)["tokens"] == [7]
        cli.close()
        proxy.blackhole(True)
        with pytest.raises(perr.RetriesExhaustedError) as ei:
            cli.generate([2], 1)
        assert isinstance(ei.value.__cause__, TimeoutError)
        cli.close()
        proxy.blackhole(False)
        assert cli.generate([3], 1)["tokens"] == [7]
        cli.close()
    finally:
        proxy.stop()
        srv.shutdown()
        srv.server_close()
