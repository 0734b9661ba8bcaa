"""Fault injection for tests and chaos runs.

Counterpart of deeplearning4j_tpu/resilience/faults.py. Everything here
exists to prove the resilience layer's claims, not to ship in a training
loop:

- ``CrashAfter``: an iteration listener that raises ``SimulatedCrash``
  once the iteration counter crosses a threshold (an in-process stand-in
  for SIGKILL).
- ``FlakyIterator``: wraps a DataSetIterator and raises a scripted error
  on chosen ``next()`` calls.
- ``FlakyBroker``: wraps a kafka-like client; scripted poll / send
  failures and corrupt records.
- ``FlakyEngine``: wraps an inference engine; scripted delays and
  failures for the serving storm tests.
- ``ServerFaultInjector``: chaos at a replica server -- injected latency
  and 5xx on /predict and /generate, reconfigured live over ``POST
  /chaos``.
- ``BlackholeProxy``: a TCP forwarder in front of a replica that can
  black-hole its socket (connects succeed, requests hang until the
  client's timeout).
- ``kill_replica`` / ``kill_worker``: SIGKILL a replica or training-worker
  process.
- ``WorkerChaos``: in-worker chaos parsed from ``DL4JTPU_WORKER_CHAOS``:
  a per-step slowdown and / or a self-SIGKILL at a given step.

The wrappers are duck-typed: they need nothing of what they wrap but the
methods they forward. ``SimulatedCrash`` subclasses BaseException so that
no ``except Exception`` between a fit loop and a test can swallow it.
"""

from __future__ import annotations

import os
import signal
import socket
import threading
import time
from typing import Dict, Optional

from deeplearning4j_tpu_torch.resilience.errors import InjectedFaultError

__all__ = ["SimulatedCrash", "CrashAfter", "FlakyIterator", "FlakyBroker",
           "FlakyEngine", "ServerFaultInjector", "BlackholeProxy",
           "kill_replica", "kill_worker", "WorkerChaos"]


class SimulatedCrash(BaseException):
    """An injected process death. BaseException so no ``except Exception``
    handler between the fit loop and the test can eat it."""


class CrashAfter:
    """IterationListener that crashes the fit once ``iteration >= at_iteration``.

    Order it BEFORE any CheckpointListener in the listeners list so the
    crash fires before the same iteration gets checkpointed -- the resumed
    run then genuinely re-trains from an older step.
    """

    def __init__(self, at_iteration: int):
        self.at_iteration = at_iteration
        self.fired = False

    def iteration_done(self, model, iteration: int, epoch: int):
        if iteration >= self.at_iteration and not self.fired:
            self.fired = True
            raise SimulatedCrash(
                f"injected crash at iteration {iteration} (epoch {epoch})")

    def on_epoch_end(self, model):
        pass


class FlakyIterator:
    """Wrap a DataSetIterator; raise ``errors[n]`` on the n-th ``next()``
    call (0-based, counted across resets). Everything else delegates."""

    def __init__(self, base, errors: Optional[Dict[int, BaseException]] = None):
        self._base = base
        self._errors = dict(errors or {})
        self.calls = 0

    def __iter__(self):
        iter(self._base)
        return self

    def __next__(self):
        n = self.calls
        self.calls += 1
        exc = self._errors.pop(n, None)
        if exc is not None:
            raise exc
        return next(self._base)

    def reset(self):
        self._base.reset()

    def __getattr__(self, name):
        return getattr(self._base, name)


class FlakyBroker:
    """Wrap a kafka-like client: scripted failures on poll/send plus
    optional corrupt records injected into poll results.

    ``fail_polls`` / ``fail_sends``: {call_index: exception} (0-based).
    ``corrupt_at``: poll call indices whose records get their payloads
    replaced with garbage bytes (undecodable by ``decode_record``).
    """

    def __init__(self, base, fail_polls: Optional[Dict[int, BaseException]] = None,
                 fail_sends: Optional[Dict[int, BaseException]] = None,
                 corrupt_at: Optional[set] = None):
        self._base = base
        self._fail_polls = dict(fail_polls or {})
        self._fail_sends = dict(fail_sends or {})
        self._corrupt_at = set(corrupt_at or ())
        self.poll_calls = 0
        self.send_calls = 0

    def poll(self, *args, **kwargs):
        n = self.poll_calls
        self.poll_calls += 1
        exc = self._fail_polls.pop(n, None)
        if exc is not None:
            raise exc
        records = self._base.poll(*args, **kwargs)
        if n in self._corrupt_at and records:
            records = [type(r)(*[b"\x00garbage" if isinstance(v, bytes) else v
                                 for v in r]) if isinstance(r, tuple)
                       else b"\x00garbage" for r in records]
        return records

    def send(self, *args, **kwargs):
        n = self.send_calls
        self.send_calls += 1
        exc = self._fail_sends.pop(n, None)
        if exc is not None:
            raise exc
        return self._base.send(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._base, name)


class FlakyEngine:
    """Wrap an inference engine for serving storm tests.

    ``delay``: seconds to sleep inside every ``predict`` (makes the
    micro-batcher queue fill so 429/deadline paths are reachable).
    ``fail_calls``: {call_index: exception} raised instead of predicting.
    ``gate``: optional threading.Event -- when set, predict blocks on it
    before running, letting a test hold the device "busy" deterministically.
    """

    def __init__(self, base, delay: float = 0.0,
                 fail_calls: Optional[Dict[int, BaseException]] = None,
                 gate: Optional[threading.Event] = None):
        self._base = base
        self.delay = delay
        self._fail_calls = dict(fail_calls or {})
        self.gate = gate
        self.calls = 0
        self.rows_seen = 0

    def _intercept(self, x):
        n = self.calls
        self.calls += 1
        if self.gate is not None:
            self.gate.wait()
        if self.delay > 0:
            time.sleep(self.delay)
        exc = self._fail_calls.pop(n, None)
        if exc is not None:
            raise exc
        try:
            self.rows_seen += int(x.shape[0])
        except Exception:
            pass

    def predict_host(self, x, *args, **kwargs):
        """The micro-batcher's entry point."""
        self._intercept(x)
        return self._base.predict_host(x, *args, **kwargs)

    def predict(self, x, *args, **kwargs):
        self._intercept(x)
        return self._base.predict(x, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._base, name)


class ServerFaultInjector:
    """Replica-server chaos: latency and 5xx injection on /predict and
    /generate, reconfigurable at runtime (the server exposes it at
    ``POST /chaos`` when constructed with one of these).

    ``latency_ms``: sleep inside every handled request (brownout).
    ``fail_next``: deterministically fail the next N requests.
    ``fail_rate``: additionally fail this fraction of requests, decided by
    a seeded counter (every ``round(1/rate)``-th request) so a chaos run is
    reproducible -- no RNG, no flaky tests.
    ``error_code``: status for injected failures (500 by default; 503
    exercises the router's draining-vs-fault classification).
    """

    def __init__(self, latency_ms: float = 0.0, fail_next: int = 0,
                 fail_rate: float = 0.0, error_code: int = 500):
        self._lock = threading.Lock()
        self.configure(latency_ms=latency_ms, fail_next=fail_next,
                       fail_rate=fail_rate, error_code=error_code)
        self.injected_faults = 0
        self.requests_seen = 0

    def configure(self, latency_ms=None, fail_next=None, fail_rate=None,
                  error_code=None, **_ignored):
        with self._lock:
            if latency_ms is not None:
                self.latency_ms = float(latency_ms)
            if fail_next is not None:
                self.fail_next = int(fail_next)
            if fail_rate is not None:
                self.fail_rate = float(fail_rate)
            if error_code is not None:
                self.error_code = int(error_code)

    def describe(self) -> dict:
        return {"latency_ms": self.latency_ms, "fail_next": self.fail_next,
                "fail_rate": self.fail_rate, "error_code": self.error_code,
                "injected_faults": self.injected_faults,
                "requests_seen": self.requests_seen}

    def maybe_inject(self, path: str = "") -> None:
        with self._lock:
            self.requests_seen += 1
            n = self.requests_seen
            latency = self.latency_ms
            fail = False
            if self.fail_next > 0:
                self.fail_next -= 1
                fail = True
            elif self.fail_rate > 0:
                every = max(1, round(1.0 / self.fail_rate))
                fail = (n % every) == 0
            if fail:
                self.injected_faults += 1
                code = self.error_code
        if latency > 0:
            time.sleep(latency / 1000.0)
        if fail:
            raise InjectedFaultError(
                f"chaos-injected fault on {path or 'request'} #{n}",
                code=code)


class BlackholeProxy:
    """TCP proxy that can stop forwarding on command.

    Route a replica's traffic through ``proxy = BlackholeProxy(replica_port)
    .start()`` and point the router at ``proxy.port``. In ``blackhole``
    mode, new connections are ACCEPTED and then starved -- no bytes flow
    either way -- so the router sees hangs-until-timeout, the slow-failure
    mode that only deadline-aware health checking catches (a dead process
    at least refuses connections fast).
    """

    def __init__(self, target_port: int, target_host: str = "127.0.0.1",
                 port: int = 0):
        self.target = (target_host, int(target_port))
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", port))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._blackholed = threading.Event()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._open: list = []
        self._lock = threading.Lock()

    def start(self) -> "BlackholeProxy":
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        return self

    def blackhole(self, on: bool = True) -> None:
        """Starve the socket: existing connections stall mid-stream, new
        ones accept and then hang. ``on=False`` restores forwarding for
        NEW connections (stalled ones stay stalled, like a real partition
        healing under old flows)."""
        if on:
            self._blackholed.set()
        else:
            self._blackholed.clear()

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns, self._open = self._open, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                client, _ = self._listener.accept()
            except OSError:
                return
            with self._lock:
                self._open.append(client)
            if self._blackholed.is_set():
                continue        # accepted, never serviced: the black hole
            try:
                upstream = socket.create_connection(self.target, timeout=10)
            except OSError:
                client.close()
                continue
            with self._lock:
                self._open.append(upstream)
            for a, b in ((client, upstream), (upstream, client)):
                threading.Thread(target=self._pump, args=(a, b),
                                 daemon=True).start()

    def _pump(self, src, dst):
        try:
            while not self._stopped.is_set():
                data = src.recv(65536)
                if not data or self._blackholed.is_set():
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass


def kill_replica(proc) -> None:
    """SIGKILL a replica process (a ``subprocess.Popen`` or anything with
    ``.pid``): no drain, no atexit, no flushed sockets -- the genuine crash
    the failover path must absorb."""
    os.kill(proc.pid, signal.SIGKILL)


def kill_worker(proc) -> None:
    """SIGKILL a training worker (a ``subprocess.Popen``, a
    ``cluster.WorkerProcess``, or anything with ``.pid``). Same primitive as
    ``kill_replica``, named for the elastic-training soak: the coordinator
    must detect the silence via lease expiry -- there is no exit hook."""
    os.kill(int(getattr(proc, "pid")), signal.SIGKILL)


class WorkerChaos:
    """Scripted in-worker chaos for elastic training.

    ``slow_ms``: sleep this long inside every training step (the straggler
    a lease-based detector must NOT evict while heartbeats keep flowing).
    ``die_at_step``: the worker SIGKILLs ITSELF when about to execute this
    step -- deterministic mid-fit death with no cross-process kill race.

    Spec string (the ``DL4JTPU_WORKER_CHAOS`` env var the cluster manager
    plants per worker): comma-separated ``key=value``, e.g.
    ``"die_at_step=5"`` or ``"slow_ms=200,die_at_step=9"``.
    """

    def __init__(self, slow_ms: float = 0.0,
                 die_at_step: Optional[int] = None):
        self.slow_ms = float(slow_ms)
        self.die_at_step = None if die_at_step is None else int(die_at_step)

    @classmethod
    def parse(cls, spec: str) -> "WorkerChaos":
        kw = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            key = key.strip()
            if key not in ("slow_ms", "die_at_step"):
                raise ValueError(f"unknown worker-chaos key {key!r} in "
                                 f"{spec!r} (want slow_ms/die_at_step)")
            kw[key] = float(val) if key == "slow_ms" else int(val)
        return cls(**kw)

    @classmethod
    def from_env(cls, var: str = "DL4JTPU_WORKER_CHAOS") -> "WorkerChaos":
        return cls.parse(os.environ.get(var, ""))

    def on_step(self, step: int) -> None:
        """Call at the top of every training step. May never return."""
        if self.die_at_step is not None and step >= self.die_at_step:
            os.kill(os.getpid(), signal.SIGKILL)
        if self.slow_ms > 0:
            time.sleep(self.slow_ms / 1000.0)
