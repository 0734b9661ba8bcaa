"""Failover router: the replica tier in front of N inference servers.

Counterpart of deeplearning4j_tpu/serving/router.py, with its names,
signatures and metric names. The router is host code over the package's
keep-alive ``InferenceClient``: it runs no CUDA work of its own, so in a
process that also holds in-process replicas it never captures or
launches anything on the card. It owns four things:

- **A health model per replica.** Periodic ``GET /healthz`` probes plus
  passive signals from real traffic (connect errors, timeouts, 5xx,
  deadline misses) drive a per-replica state machine::

      healthy -> suspect -> ejected -> recovering -> healthy
                    ^__________________|  (a failure while recovering
                                           re-ejects with doubled backoff)

  Ejected replicas are re-probed on an exponential backoff; a successful
  probe re-admits them as ``recovering`` (routable), and the first real
  success heals them. A replica reporting ``draining`` is pulled without
  an ejection penalty; ``degraded`` de-prioritizes it.
- **Failover with a shared retry budget** (``RetryBudget``): a failed
  attempt fails over to another replica only while the token bucket has
  balance; once it is spent the client gets a fast 503
  ``retry_budget_exhausted``. Hedges spend the same budget.
- **Hedged ``/predict``**: when the primary attempt has not answered
  after a p95-based delay, a second copy goes to another replica; the
  first answer wins and the loser is cancelled (its socket closed).
- **Least-outstanding balancing** with per-tenant quotas (``x-tenant``)
  and priority shedding (``x-priority``: low | normal | high), prefix
  affinity for ``/generate`` (the replicas' advertised KV chain heads,
  hashed here with ``serving.kv.prefix.chain_hashes``) and role
  preference.

``rolling_restart`` drains one replica at a time, restarts it through the
caller's hook and re-admits it after ``/healthz`` answers ok (and a warmup
probe, when given). ``add_upstream`` / ``remove_upstream`` are the
autoscaler's edges; ``hold_for_capacity_s`` with ``wake_hook`` holds a
request while a scale-to-zero tier brings a replica up. The router's own
spans (``route``, ``attempt``) and its request journal ride the port's
``monitor``.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch.monitor import get_registry, trace
from deeplearning4j_tpu_torch.monitor import tracing
from deeplearning4j_tpu_torch.monitor.reqlog import RequestLog, new_record
from deeplearning4j_tpu_torch.monitor.slo import BurnRateSLO
from deeplearning4j_tpu_torch.serving.client import InferenceClient
from deeplearning4j_tpu_torch.serving.kv.prefix import chain_hashes

__all__ = ["Router", "RetryBudget", "ReplicaState"]


class ReplicaState:
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    EJECTED = "ejected"
    RECOVERING = "recovering"


# numeric encoding for the per-replica state gauge (alerting rules compare
# against these; admin_down is reported on top via its own gauge)
_STATE_VALUE = {ReplicaState.HEALTHY: 0, ReplicaState.SUSPECT: 1,
                ReplicaState.EJECTED: 2, ReplicaState.RECOVERING: 3}

# upstream statuses that mean "this replica failed the request" -- eligible
# for failover to a different replica. 504 is NOT here: the request's own
# deadline is spent, retrying delivers a late answer nobody awaits.
_FAILOVER_STATUSES = (429, 500, 502, 503)


class RetryBudget:
    """Token bucket bounding retries+hedges to a fraction of live traffic.

    Every incoming request deposits ``ratio`` tokens (capped at ``cap``);
    every failover attempt or hedge withdraws one. Under a full brownout
    the budget drains in ~``initial`` retries and then refills at
    ``ratio`` per request -- so retry load is at most ``ratio`` of offered
    load in steady state, which is what keeps a brownout from becoming a
    self-inflicted storm."""

    def __init__(self, ratio: float = 0.1, initial: float = 5.0,
                 cap: float = 20.0):
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._balance = min(float(initial), self.cap)
        self._lock = threading.Lock()
        reg = get_registry()
        self._m_spent = reg.counter(
            "dl4jtpu_router_retry_budget_spent_total",
            "Failover/hedge attempts paid for from the shared retry "
            "budget.")
        self._m_denied = reg.counter(
            "dl4jtpu_router_retry_budget_denied_total",
            "Failover/hedge attempts refused because the retry budget was "
            "spent (the request then fails fast instead of retrying).")
        reg.gauge(
            "dl4jtpu_router_retry_budget_balance",
            "Current retry-budget token balance.").set_function(
                lambda: self._balance)

    def deposit(self) -> None:
        with self._lock:
            self._balance = min(self.cap, self._balance + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._balance >= 1.0:
                self._balance -= 1.0
                spent = True
            else:
                spent = False
        (self._m_spent if spent else self._m_denied).inc()
        return spent

    @property
    def balance(self) -> float:
        return self._balance


class _Replica:
    """Router-side record for one upstream: health state + live counters."""

    def __init__(self, url: str, timeout: float):
        self.url = url.rstrip("/")
        # retries=1: the router owns failover -- the client must surface
        # every upstream failure instead of retrying it in place
        self.client = InferenceClient(self.url, timeout=timeout, retries=1)
        self.probe_client = InferenceClient(self.url,
                                            timeout=min(timeout, 5.0),
                                            retries=1)
        self.state = ReplicaState.HEALTHY
        self.consecutive_failures = 0
        self.outstanding = 0
        self.degraded = False
        self.draining = False
        self.admin_down = False            # rolling restart holds this
        self.ejected_until = 0.0
        self.backoff = 0.0
        self.lock = threading.Lock()
        # disaggregation state learned from /stats (refresh_affinity):
        # the replica's declared role and its advertised KV chain heads --
        # the prefix-affinity routing signal. Stale values only cost a
        # fallback to plain least-outstanding, never correctness.
        self.role = "mixed"
        self.chain_heads: frozenset = frozenset()
        self.kv_block_size: Optional[int] = None

    def routable(self) -> bool:
        return (self.state != ReplicaState.EJECTED
                and not self.admin_down and not self.draining)


class _Attempt:
    """One upstream try of one request (primary, failover, or hedge)."""

    __slots__ = ("replica", "rid", "cancelled", "conn")

    def __init__(self, replica: _Replica, rid: str):
        self.replica = replica
        self.rid = rid
        self.cancelled = threading.Event()
        self.conn = None

    def cancel(self):
        """Best-effort: close the in-flight socket so the losing half of a
        hedged pair stops consuming its replica, and flag the attempt so
        the resulting socket error is discarded instead of counting as a
        passive failure (we caused it)."""
        self.cancelled.set()
        conn = self.conn
        if conn is not None and conn.sock is not None:
            try:
                conn.sock.close()
            except OSError:
                pass


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _reply(self, status: int, body: bytes, rid: Optional[str] = None,
               extra_headers=None):
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if rid:
            self.send_header("x-request-id", rid)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        router = self.server.router
        path = urlparse(self.path).path
        if path == "/healthz":
            info = router.health_info()
            self._reply(503 if info["status"] == "draining" else 200,
                        json.dumps(info).encode())
        elif path == "/stats":
            self._reply(200, json.dumps(router.stats()).encode())
        elif path == "/trace":
            # the router process's span ring buffer; merged with every
            # replica's by monitor/collect.collect_fleet_trace
            self._reply(200, json.dumps(trace.export()).encode())
        elif path == "/requests":
            # the router's wide-event annotation journal; merged with
            # every replica's by monitor/collect.collect_requests
            q = parse_qs(urlparse(self.path).query)
            n = q.get("n", [None])[0]
            try:
                n = None if n is None else int(n)
            except ValueError:
                self._reply(400, json.dumps(
                    {"error": {"type": "bad_request",
                               "message": f"n must be an integer, "
                                          f"got {n!r}"}}).encode())
                return
            self._reply(200,
                        json.dumps(router.journal.snapshot(n)).encode())
        elif path == "/metrics":
            data = get_registry().render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._reply(404, json.dumps(
                {"error": {"type": "not_found",
                           "message": f"no such path: {path}"}}).encode())

    def do_POST(self):
        router = self.server.router
        path = urlparse(self.path).path
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if path not in ("/predict", "/generate", "/warmup"):
            self._reply(404, json.dumps(
                {"error": {"type": "not_found",
                           "message": f"no such path: {path}"}}).encode())
            return
        status, out, rid, extra = router.handle(
            path, body,
            tenant=self.headers.get("x-tenant", "default"),
            priority=self.headers.get("x-priority", "normal"),
            request_id=self.headers.get("x-request-id"))
        self._reply(status, out, rid, extra)


class Router:
    """HTTP failover router over N replica InferenceServers.

        router = Router(["http://127.0.0.1:9301", ...], port=0).start()
        out = InferenceClient(f"http://127.0.0.1:{router.port}").predict(x)

    The knobs are the JAX package's (module docstring).
    ``clock``/``sleep`` are injectable for the health model ONLY (probe
    cadence, ejection backoff) so tests drive state transitions without
    real waiting; the request path uses wall time.
    """

    _ids = itertools.count()

    def __init__(self, upstreams: Sequence[str], port: int = 0,
                 host: str = "127.0.0.1",
                 probe_interval: float = 1.0,
                 eject_after: int = 3,
                 probe_backoff_base: float = 0.5,
                 probe_backoff_max: float = 30.0,
                 retry_budget: Optional[RetryBudget] = None,
                 hedge: bool = True,
                 hedge_delay_ms: Optional[float] = None,
                 hedge_floor_ms: float = 10.0,
                 default_deadline_ms: Optional[float] = None,
                 upstream_timeout: float = 30.0,
                 tenant_quota: Optional[int] = None,
                 max_outstanding: Optional[int] = None,
                 hold_for_capacity_s: float = 0.0,
                 wake_hook: Optional[Callable[[], None]] = None,
                 prefix_affinity: bool = True,
                 affinity_max_chain: int = 32,
                 affinity_slack: int = 2,
                 journal_capacity: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if not upstreams and hold_for_capacity_s <= 0:
            # scale-to-zero tiers (hold_for_capacity_s > 0) may boot with
            # an empty replica set: the autoscaler adds the first replica
            # when the wake hook fires
            raise ValueError("router needs at least one upstream replica")
        self.id = f"router{next(Router._ids)}"
        self._clock = clock
        self._sleep = sleep
        # None disables the probe thread: tests with fake clocks call
        # probe_once() by hand instead of racing a background sweep
        self.probe_interval = (None if probe_interval is None
                               else float(probe_interval))
        self.eject_after = int(eject_after)
        self.probe_backoff_base = float(probe_backoff_base)
        self.probe_backoff_max = float(probe_backoff_max)
        self.budget = retry_budget or RetryBudget()
        self.hedge_enabled = bool(hedge)
        self.hedge_delay_ms = hedge_delay_ms
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.default_deadline_ms = default_deadline_ms
        self.upstream_timeout = float(upstream_timeout)
        self.tenant_quota = tenant_quota
        self.max_outstanding = max_outstanding
        self.hold_for_capacity_s = float(hold_for_capacity_s)
        self.wake_hook = wake_hook
        # prefix-affinity routing (disaggregation):
        # /generate primaries prefer the replica already advertising this
        # prompt's KV chain heads -- bounded by ``affinity_slack`` extra
        # outstanding requests so affinity never starves load balancing,
        # and always layered BENEATH the health state machine.
        self.prefix_affinity = bool(prefix_affinity)
        self.affinity_max_chain = int(affinity_max_chain)
        self.affinity_slack = int(affinity_slack)
        self._replicas: Dict[str, _Replica] = {}
        # router-side wide events: one annotation record per routed
        # request (attempts, hedge winner, affinity hit) that the fleet
        # collector joins to the replica records by base request id
        self.journal = RequestLog(journal_capacity)
        self._lock = threading.Lock()
        self._rr = itertools.count()
        self._rid_counter = itertools.count(1)
        self._rid_prefix = f"{os.getpid():x}"
        self._tenant_outstanding: Dict[str, int] = {}
        self._total_outstanding = 0
        self._pool = ThreadPoolExecutor(max_workers=32,
                                        thread_name_prefix=self.id)
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._httpd = None
        self.port: Optional[int] = None
        self._host = host
        self._port_req = port

        reg = get_registry()
        self._m_requests = reg.counter(
            "dl4jtpu_router_requests_total",
            "Requests handled by the router. outcome: ok | failed_over "
            "(ok after >=1 failover) | hedge_win | shed | error.",
            ("router", "path", "outcome"))
        self._m_attempts = reg.counter(
            "dl4jtpu_router_upstream_attempts_total",
            "Individual upstream tries (primary + failover + hedge).",
            ("router", "replica"))
        self._m_failures = reg.counter(
            "dl4jtpu_router_upstream_failures_total",
            "Passive failure signals per replica. kind: connect | timeout "
            "| 5xx | overloaded | draining | deadline_miss | probe.",
            ("router", "replica", "kind"))
        self._m_ejections = reg.counter(
            "dl4jtpu_router_ejections_total",
            "Replica ejections (consecutive passive failures crossed the "
            "threshold, or a recovering replica failed again).",
            ("router", "replica"))
        self._m_readmissions = reg.counter(
            "dl4jtpu_router_readmissions_total",
            "Replicas re-admitted to rotation: a probe succeeded after "
            "ejection, or a rolling restart completed its health gate.",
            ("router", "replica"))
        self._m_hedges = reg.counter(
            "dl4jtpu_router_hedges_total",
            "Hedged /predict attempts. outcome: fired | won (hedge beat "
            "the primary) | cancelled (primary won, hedge discarded).",
            ("router", "outcome"))
        self._m_sheds = reg.counter(
            "dl4jtpu_router_sheds_total",
            "Requests shed at the router before any upstream attempt. "
            "reason: tenant_quota | priority | no_replicas | deadline.",
            ("router", "reason"))
        self._m_holds = reg.counter(
            "dl4jtpu_router_capacity_holds_total",
            "Requests held at the router because no replica was routable "
            "(scale-to-zero wake path). outcome: served (capacity arrived "
            "within hold_for_capacity_s) | timeout (shed after the hold).",
            ("router", "outcome"))
        self._m_probes = reg.counter(
            "dl4jtpu_router_probes_total",
            "Active /healthz probes. result: ok | degraded | draining | "
            "error.", ("router", "replica", "result"))
        self._m_affinity = reg.counter(
            "dl4jtpu_router_affinity_requests_total",
            "Prefix-affinity decisions on /generate primary picks. "
            "outcome: hit (routed to a replica advertising the prompt's "
            "chain heads) | miss (no eligible replica covered the prefix; "
            "fell back to least-outstanding).", ("router", "outcome"))
        self._m_aff_refreshes = reg.counter(
            "dl4jtpu_router_affinity_refreshes_total",
            "Per-replica chain-head/role refreshes pulled from /stats "
            "(piggybacked on the probe sweep).", ("router",))
        self._m_latency = reg.histogram(
            "dl4jtpu_router_upstream_latency_seconds",
            "Latency of successful upstream attempts (feeds the p95 hedge "
            "delay).", ("router", "path"))
        self._m_state = reg.gauge(
            "dl4jtpu_router_replica_state",
            "Replica health state: 0 healthy, 1 suspect, 2 ejected, "
            "3 recovering.", ("router", "replica"))
        self._m_admin = reg.gauge(
            "dl4jtpu_router_replica_admin_down",
            "1 while a replica is administratively held out of rotation "
            "(rolling restart).", ("router", "replica"))
        self._m_outstanding = reg.gauge(
            "dl4jtpu_router_replica_outstanding",
            "In-flight upstream requests per replica (the "
            "least-outstanding balancing signal).", ("router", "replica"))
        # availability SLO over routed /predict + /generate: only the
        # ``error`` outcome (every replica failed / budget spent / router
        # deadline) burns budget -- sheds are policy, failovers and hedge
        # wins answered the client fine. Shares the router's injectable
        # clock so fake-clock tests drive the burn windows directly.
        sli, bad = [], []
        for p in ("/predict", "/generate"):
            for oc in ("ok", "failed_over", "hedge_win", "shed", "error"):
                child = self._m_requests.labels(router=self.id, path=p,
                                                outcome=oc)
                sli.append(child)
                if oc == "error":
                    bad.append(child)
        self.slo = BurnRateSLO(
            f"router_availability:{self.id}",
            bad_fn=lambda: sum(c.value for c in bad),
            total_fn=lambda: sum(c.value for c in sli),
            objective=0.99, clock=clock)
        for url in upstreams:
            self._add_replica(url)

    # ----------------------------------------------------------- replica set
    def _add_replica(self, url: str) -> None:
        rep = _Replica(url, timeout=self.upstream_timeout)
        self._replicas[rep.url] = rep
        lab = {"router": self.id, "replica": rep.url}
        self._m_state.labels(**lab).set_function(
            lambda r=rep: _STATE_VALUE[r.state])
        self._m_admin.labels(**lab).set_function(
            lambda r=rep: 1.0 if r.admin_down else 0.0)
        self._m_outstanding.labels(**lab).set_function(
            lambda r=rep: float(r.outstanding))

    @property
    def replicas(self) -> Dict[str, _Replica]:
        return self._replicas

    def add_upstream(self, url: str) -> None:
        """Admit a replica into rotation at runtime (the autoscaler's
        scale-up path -- callers gate on the replica being warm/healthy
        BEFORE adding it; the router starts routing immediately).
        Re-adding a known URL resets its health state."""
        with self._lock:
            self._add_replica(url)

    def remove_upstream(self, url: str, drain_timeout: float = 30.0) -> bool:
        """Drain + remove a replica from rotation (the autoscaler's
        scale-down path): ``admin_down`` diverts new traffic, in-flight
        requests get ``drain_timeout`` to finish, then the record and its
        clients go away. Returns False for an unknown URL. Stopping the
        actual process is the caller's job -- the router only routes."""
        url = url.rstrip("/")
        with self._lock:
            rep = self._replicas.get(url)
        if rep is None:
            return False
        rep.admin_down = True
        deadline = time.monotonic() + drain_timeout
        while rep.outstanding > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        with self._lock:
            self._replicas.pop(url, None)
        for c in (rep.client, rep.probe_client):
            try:
                c.close()
            except Exception:   # noqa: BLE001 -- removal must not raise
                pass
        return True

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "Router":
        self._stop.clear()
        if self.probe_interval is not None and (
                self._probe_thread is None
                or not self._probe_thread.is_alive()):
            self._probe_thread = threading.Thread(target=self._probe_loop,
                                                  daemon=True)
            self._probe_thread.start()
        self._httpd = ThreadingHTTPServer((self._host, self._port_req),
                                          _RouterHandler)
        self._httpd.router = self
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self._pool.shutdown(wait=False)

    # ---------------------------------------------------------- health model
    def _note_failure(self, rep: _Replica, kind: str) -> None:
        self._m_failures.labels(router=self.id, replica=rep.url,
                                kind=kind).inc()
        if kind == "draining":
            # the replica asked to be pulled -- no ejection penalty, the
            # probe loop re-admits it the moment /healthz stops draining
            rep.draining = True
            return
        with rep.lock:
            rep.consecutive_failures += 1
            if rep.state == ReplicaState.RECOVERING:
                self._eject_locked(rep)          # relapse: doubled backoff
            elif rep.state == ReplicaState.HEALTHY:
                rep.state = ReplicaState.SUSPECT
            if (rep.state == ReplicaState.SUSPECT
                    and rep.consecutive_failures >= self.eject_after):
                self._eject_locked(rep)

    def _eject_locked(self, rep: _Replica) -> None:
        rep.state = ReplicaState.EJECTED
        rep.backoff = min(self.probe_backoff_max,
                          max(self.probe_backoff_base, rep.backoff * 2.0))
        rep.ejected_until = self._clock() + rep.backoff
        self._m_ejections.labels(router=self.id, replica=rep.url).inc()

    def _note_success(self, rep: _Replica) -> None:
        with rep.lock:
            rep.consecutive_failures = 0
            rep.draining = False
            if rep.state != ReplicaState.HEALTHY:
                # a real request succeeded -- stronger evidence than any
                # probe, so it heals even an ejected replica (the panic
                # path below can route to one)
                rep.state = ReplicaState.HEALTHY
                rep.backoff = 0.0

    def probe_once(self) -> None:
        """One active probe sweep (the loop calls this every
        ``probe_interval``; tests call it directly under a fake clock)."""
        alive = []
        for rep in list(self._replicas.values()):
            if rep.admin_down:
                continue
            if (rep.state == ReplicaState.EJECTED
                    and self._clock() < rep.ejected_until):
                continue                         # still backing off
            try:
                info = rep.probe_client.health()
            except Exception:   # noqa: BLE001 -- dead replica: any error
                self._m_probes.labels(router=self.id, replica=rep.url,
                                      result="error").inc()
                self._note_failure(rep, "probe")
                continue
            status = info.get("status")
            self._m_probes.labels(router=self.id, replica=rep.url,
                                  result=status or "error").inc()
            if status == "draining":
                rep.draining = True
                continue
            rep.draining = False
            rep.degraded = (status == "degraded")
            if status in ("ok", "degraded"):
                alive.append(rep)
                with rep.lock:
                    if rep.state == ReplicaState.EJECTED:
                        # re-admit provisionally; the first real success
                        # (or the next probe-sweep success) heals it fully
                        rep.state = ReplicaState.RECOVERING
                        rep.consecutive_failures = 0
                        self._m_readmissions.labels(
                            router=self.id, replica=rep.url).inc()
                    elif rep.state == ReplicaState.RECOVERING:
                        rep.state = ReplicaState.HEALTHY
                        rep.backoff = 0.0
            else:
                self._note_failure(rep, "probe")
        self.refresh_affinity(alive)

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:   # noqa: BLE001 -- probes must never die
                pass
            self._sleep(self.probe_interval)

    # ------------------------------------------------------- prefix affinity
    def refresh_affinity(self, replicas=None) -> None:
        """Pull each replica's declared role and advertised KV chain heads
        from ``/stats`` (the bounded digest DecodeEngine.stats publishes).
        Rides the probe sweep; tests and benches call it directly. A
        replica whose stats call fails keeps its last-known heads --
        staleness only costs a fallback to least-outstanding."""
        if not self.prefix_affinity:
            return
        if replicas is None:
            replicas = [r for r in self._replicas.values()
                        if not r.admin_down
                        and r.state != ReplicaState.EJECTED]
        for rep in replicas:
            try:
                st = rep.probe_client.stats()
            except Exception:   # noqa: BLE001 -- stale heads beat no heads
                continue
            rep.role = str(st.get("role") or "mixed")
            kv = (st.get("decode") or {}).get("kv") or {}
            rep.chain_heads = frozenset(
                str(h) for h in (kv.get("chain_heads") or []))
            rep.kv_block_size = kv.get("block_size")
            self._m_aff_refreshes.labels(router=self.id).inc()

    def _affinity_hint(self, path: str, body: bytes) -> Optional[dict]:
        """Score replicas by how deep their advertised chain heads cover
        this prompt's rolling block-hash chain (the same blake2b chain the
        replicas' PrefixCache publishes, computed router-side). Returns
        ``{url: depth}`` with depth >= 1 for covering replicas, ``{}``
        when nobody covers any prefix (counts as a miss), or None when
        affinity cannot apply -- disabled, non-/generate, no advertised
        heads, unparseable body -- which bypasses the hit/miss counter."""
        if not self.prefix_affinity or path != "/generate":
            return None
        with self._lock:
            reps = [(r.url, r.chain_heads, r.kv_block_size)
                    for r in self._replicas.values() if r.chain_heads]
        if not reps:
            return None
        try:
            payload = json.loads(body.decode())
            toks = tuple(int(t) for t in payload["tokens"])
        except Exception:   # noqa: BLE001 -- replicas answer 400 for junk
            return None
        if not toks:
            return None
        by_bs: Dict[int, List[str]] = {}
        hint: Dict[str, int] = {}
        for url, heads, bs in reps:
            try:
                bs = int(bs)
            except (TypeError, ValueError):
                continue
            if bs <= 0:
                continue
            if bs not in by_bs:
                by_bs[bs] = chain_hashes(toks, bs,
                                         limit=self.affinity_max_chain)
            depth = 0
            for h in by_bs[bs]:
                if h not in heads:
                    break           # a chain hit commits the WHOLE prefix
                depth += 1
            if depth:
                hint[url] = depth
        return hint

    # -------------------------------------------------------------- selection
    def _pick(self, exclude, hint=None,
              want_prefill: bool = False) -> Optional[_Replica]:
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.routable() and r.url not in exclude]
            if not cands:
                # panic routing (fail-open): when the health model has
                # ejected every replica, sending traffic to a maybe-dead
                # one beats a certain 503 -- and a success heals it
                cands = [r for r in self._replicas.values()
                         if not r.admin_down and r.url not in exclude]
            if not cands:
                return None
            # degraded replicas (decode_saturated, queue_pressure) only
            # take traffic when every healthy one is excluded/ejected
            fresh = [r for r in cands if not r.degraded]
            pool = fresh or cands
            least = min(r.outstanding for r in pool)
            if hint:
                # prefix affinity: prefer the replica already holding the
                # deepest prefix of this prompt's chain -- but never one
                # more than ``affinity_slack`` requests busier than the
                # least-loaded candidate. Affinity is a tiebreak UNDER
                # the health/load model, never an override of it.
                aff = [r for r in pool if hint.get(r.url)
                       and r.outstanding <= least + self.affinity_slack]
                if aff:
                    deepest = max(hint[r.url] for r in aff)
                    aff = [r for r in aff if hint[r.url] == deepest]
                    least_a = min(r.outstanding for r in aff)
                    best = [r for r in aff if r.outstanding == least_a]
                    return best[next(self._rr) % len(best)]
            if want_prefill:
                # disaggregated fleet, fresh prompt (no affinity winner):
                # steer the cold prefill away from decode-dedicated
                # replicas when any other kind is available
                pref = [r for r in pool if r.role != "decode"]
                if pref:
                    pool = pref
                    least = min(r.outstanding for r in pool)
            best = [r for r in pool if r.outstanding == least]
            return best[next(self._rr) % len(best)]   # round-robin the tie

    def _hold_for_capacity(self, tried) -> Optional[_Replica]:
        """Scale-to-zero path: with no routable replica, poke the wake hook
        (the autoscaler's kick) and hold the request up to
        ``hold_for_capacity_s`` for capacity to appear -- an AOT-restoring
        replica arrives in well under a second, so a short hold converts a
        certain 503 into a served request."""
        if self.hold_for_capacity_s <= 0:
            return None
        if self.wake_hook is not None:
            try:
                self.wake_hook()
            except Exception:   # noqa: BLE001 -- a broken hook must not 500
                pass
        deadline = time.perf_counter() + self.hold_for_capacity_s
        while time.perf_counter() < deadline:
            time.sleep(0.05)
            rep = self._pick(tried)
            if rep is not None:
                self._m_holds.labels(router=self.id, outcome="served").inc()
                return rep
        self._m_holds.labels(router=self.id, outcome="timeout").inc()
        return None

    # -------------------------------------------------------------- requests
    def _mint_rid(self, supplied: Optional[str]) -> str:
        if supplied:
            return supplied
        return f"req-{self._rid_prefix}-{next(self._rid_counter):06d}"

    def _err(self, status: int, err_type: str, message: str, rid: str):
        return status, json.dumps(
            {"error": {"type": err_type, "message": message,
                       "request_id": rid}}).encode(), rid, {}

    def _hedge_delay_s(self) -> float:
        if self.hedge_delay_ms is not None:
            return self.hedge_delay_ms / 1000.0
        hist = self._m_latency.labels(router=self.id, path="/predict")
        p95 = hist.percentile(0.95) if hist.count >= 20 else None
        floor = self.hedge_floor_ms / 1000.0
        return max(floor, p95) if p95 is not None else floor

    def _admit(self, tenant: str, priority: str, rid: str):
        """Quota + priority gate. Returns an error triple to send, or None
        to admit (caller must _release)."""
        with self._lock:
            if self.max_outstanding is not None:
                # priority shedding: low gives up headroom first, high may
                # ride into the overflow band -- all before any quota math
                n = self._total_outstanding
                cap = self.max_outstanding
                limit = {"low": 0.75 * cap, "high": 1.5 * cap}.get(
                    priority, float(cap))
                if n >= limit:
                    self._m_sheds.labels(router=self.id,
                                         reason="priority").inc()
                    return self._err(
                        429, "overloaded",
                        f"router at capacity ({n} outstanding); "
                        f"{priority}-priority load shed", rid)
            if self.tenant_quota is not None:
                if self._tenant_outstanding.get(tenant, 0) \
                        >= self.tenant_quota:
                    self._m_sheds.labels(router=self.id,
                                         reason="tenant_quota").inc()
                    return self._err(
                        429, "tenant_quota",
                        f"tenant {tenant!r} at quota "
                        f"({self.tenant_quota} outstanding)", rid)
            self._tenant_outstanding[tenant] = \
                self._tenant_outstanding.get(tenant, 0) + 1
            self._total_outstanding += 1
        return None

    def _release(self, tenant: str) -> None:
        with self._lock:
            self._tenant_outstanding[tenant] = max(
                0, self._tenant_outstanding.get(tenant, 1) - 1)
            self._total_outstanding = max(0, self._total_outstanding - 1)

    def handle(self, path: str, body: bytes, tenant: str = "default",
               priority: str = "normal",
               request_id: Optional[str] = None):
        """Route one request; returns ``(status, body_bytes, request_id,
        extra_headers)`` -- ``extra_headers`` passes upstream metadata
        (``x-model-version``, the replica's hot-swap weight version) through
        to the client. Exposed directly (not just via HTTP) so tests can
        drive the router without sockets where sockets add nothing."""
        rid = self._mint_rid(request_id)
        t_start = time.perf_counter()
        self.budget.deposit()
        shed = self._admit(tenant, priority, rid)
        if shed is not None:
            # wide event even for a request that never reached an
            # upstream: a shed MUST be attributable in the journal
            self.journal.append(new_record(
                rid, "router", trace_id=rid, outcome="shed",
                tenant=tenant, priority=priority, router=self.id,
                path=path, status=shed[0], attempts=0, attempt_rids=[],
                hedged=False, hedge_winner=None, affinity_hit=None,
                replica=None,
                wall_seconds=time.perf_counter() - t_start))
            return shed
        # the fleet trace root: trace_id = the router-minted request id.
        # Every span below (route here, attempt per upstream try, and --
        # via the x-trace-context header -- the winning replica's whole
        # handler/engine chain) carries this id.
        ctx = tracing.TraceContext(rid)
        try:
            with tracing.trace_context(ctx), \
                    trace.span("route", path=path):
                expires = self._expiry(body)
                hedge = self.hedge_enabled and path == "/predict"
                hint = self._affinity_hint(path, body)
                return self._forward(path, body, rid, expires, hedge,
                                     hint=hint, tenant=tenant,
                                     priority=priority, t_start=t_start)
        finally:
            self._release(tenant)

    def _expiry(self, body: bytes) -> Optional[float]:
        deadline_ms = self.default_deadline_ms
        try:
            payload = json.loads(body.decode())
            if isinstance(payload, dict) and "deadline_ms" in payload:
                deadline_ms = float(payload["deadline_ms"])
        except Exception:   # noqa: BLE001 -- replicas answer 400 for junk
            pass
        if deadline_ms is None:
            return None
        return time.perf_counter() + deadline_ms / 1000.0

    # ------------------------------------------------------------ forwarding
    def _run_attempt(self, att: _Attempt, path: str, body: bytes,
                     results: "queue.Queue",
                     ctx: Optional[tracing.TraceContext] = None) -> None:
        rep = att.replica
        with rep.lock:
            rep.outstanding += 1
        self._m_attempts.labels(router=self.id, replica=rep.url).inc()
        # the attempt id (rid#aN) becomes the replica-side parent span id,
        # riding the x-trace-context header next to x-request-id
        actx = ctx.child(att.rid) if ctx is not None else None
        req_headers = {"x-request-id": att.rid}
        if actx is not None:
            req_headers["x-trace-context"] = actx.to_header()
        t0 = time.perf_counter()
        try:
            with tracing.trace_context(actx), \
                    trace.span("attempt", rid=att.rid, replica=rep.url):
                att.conn = rep.client._conn()
                status, data, hdrs = rep.client.post_raw(
                    path, body, headers=req_headers,
                    give_up=att.cancelled.is_set)
            results.put((att, status, data, hdrs, None,
                         time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 -- classified by the waiter
            results.put((att, None, None, None, e,
                         time.perf_counter() - t0))
        finally:
            with rep.lock:
                rep.outstanding -= 1

    def _classify_failure(self, status, exc) -> str:
        if exc is not None:
            if isinstance(exc, TimeoutError):
                return "timeout"
            return "connect"
        if status == 429:
            return "overloaded"
        if status == 503:
            return "draining"
        return "5xx"

    def _forward(self, path: str, body: bytes, rid: str,
                 expires: Optional[float], hedge: bool, hint=None,
                 tenant: str = "default", priority: str = "normal",
                 t_start: Optional[float] = None):
        results: "queue.Queue" = queue.Queue()
        live: List[_Attempt] = []
        tried = set()
        n_attempt = itertools.count()
        t_start = time.perf_counter() if t_start is None else t_start
        attempt_rids: List[str] = []
        aff_hit: Optional[bool] = None
        hedged = False

        ctx = tracing.get_context()

        def launch(rep: _Replica) -> None:
            att = _Attempt(rep, f"{rid}#a{next(n_attempt)}")
            attempt_rids.append(att.rid)
            tried.add(rep.url)
            live.append(att)
            self._pool.submit(self._run_attempt, att, path, body, results,
                              ctx)

        def outcome(tag: str):
            self._m_requests.labels(router=self.id, path=path,
                                    outcome=tag).inc()

        def journal(tag: str, status, replica=None, winner=None):
            # the router's half of the wide event: per-attempt fan-out the
            # replica journals can't see, joined fleet-wide by base rid
            self.journal.append(new_record(
                rid, "router", trace_id=rid, outcome=tag, tenant=tenant,
                priority=priority, router=self.id, path=path,
                status=None if status is None else int(status),
                attempts=len(attempt_rids),
                attempt_rids=list(attempt_rids), hedged=hedged,
                hedge_winner=winner, affinity_hit=aff_hit,
                replica=replica,
                wall_seconds=time.perf_counter() - t_start))

        want_prefill = self.prefix_affinity and path == "/generate"
        primary = self._pick(tried, hint=hint, want_prefill=want_prefill)
        if primary is None:
            # scale-to-zero: hold the request briefly while the autoscaler
            # wakes a replica (AOT restore makes this a sub-second wait)
            primary = self._hold_for_capacity(tried)
        if primary is None:
            outcome("shed")
            self._m_sheds.labels(router=self.id, reason="no_replicas").inc()
            journal("shed", 503)
            return self._err(503, "no_healthy_replicas",
                             "no routable replica", rid)
        if hint is not None:
            # counted on the primary pick only -- failover/hedge picks are
            # health decisions, not affinity decisions
            aff_hit = bool(hint.get(primary.url))
            self._m_affinity.labels(
                router=self.id,
                outcome="hit" if aff_hit else "miss").inc()
        launch(primary)
        hedge_at = (time.perf_counter() + self._hedge_delay_s()
                    if hedge else None)
        failed_over = False
        hedged = False

        while True:
            now = time.perf_counter()
            if expires is not None and now >= expires:
                for att in live:
                    att.cancel()
                outcome("error")
                self._m_sheds.labels(router=self.id, reason="deadline").inc()
                journal("deadline", 504)
                return self._err(504, "deadline_exceeded",
                                 "request deadline expired at the router",
                                 rid)
            timeout = None
            if expires is not None:
                timeout = expires - now
            if hedge_at is not None:
                timeout = min(timeout, hedge_at - now) \
                    if timeout is not None else hedge_at - now
            try:
                att, status, data, hdrs, exc, dt = results.get(
                    timeout=max(0.001, timeout) if timeout is not None
                    else None)
            except queue.Empty:
                if hedge_at is not None and time.perf_counter() >= hedge_at:
                    hedge_at = None
                    rep2 = self._pick(tried)
                    if rep2 is not None and self.budget.try_spend():
                        hedged = True
                        self._m_hedges.labels(router=self.id,
                                              outcome="fired").inc()
                        launch(rep2)
                continue

            live.remove(att)
            if att.cancelled.is_set():
                continue                    # the loser we cancelled
            rep = att.replica
            is_failure = (exc is not None or status is None
                          or status in _FAILOVER_STATUSES)
            if not is_failure:
                if status == 504:
                    # the replica spent the request's deadline: passive
                    # signal, but the answer goes back as-is (no retry)
                    self._note_failure(rep, "deadline_miss")
                else:
                    self._note_success(rep)
                    self._m_latency.labels(router=self.id,
                                           path=path).observe(dt)
                for other in live:
                    other.cancel()
                    self._m_hedges.labels(router=self.id,
                                          outcome="cancelled").inc()
                if hedged and not att.rid.endswith("#a0"):
                    self._m_hedges.labels(router=self.id,
                                          outcome="won").inc()
                    tag = "hedge_win"
                elif failed_over:
                    tag = "failed_over"
                else:
                    tag = "ok"
                outcome(tag)
                journal(tag, status, replica=rep.url,
                        winner=att.rid if tag == "hedge_win" else None)
                extra = {}
                mv = next((v for k, v in (hdrs or {}).items()
                           if k.lower() == "x-model-version"), None)
                if mv is not None:
                    extra["x-model-version"] = mv
                return status, data, rid, extra

            self._note_failure(rep, self._classify_failure(status, exc))
            if live:
                continue                    # a sibling attempt may still win
            if expires is not None and time.perf_counter() >= expires:
                continue                    # top of loop answers 504
            nxt = self._pick(tried)
            if nxt is None:
                outcome("error")
                journal("error", 502)
                return self._err(
                    502, "upstream_failed",
                    "every routable replica failed this request "
                    f"(last: {exc or status})", rid)
            if not self.budget.try_spend():
                outcome("error")
                journal("error", 503)
                return self._err(
                    503, "retry_budget_exhausted",
                    "upstream failed and the shared retry budget is "
                    "spent; failing fast instead of retrying", rid)
            failed_over = True
            launch(nxt)

    # -------------------------------------------------------- rolling restart
    def rolling_restart(self, restarter: Callable[[str], None],
                        drain_timeout: float = 30.0,
                        ready_timeout: float = 180.0,
                        warmup_shape=None,
                        warmup_max_batch: Optional[int] = None) -> None:
        """Zero-downtime deploy: one replica at a time --

        1. hold it out of rotation (``admin_down``; new traffic avoids it),
        2. wait for its in-flight requests to finish,
        3. ``restarter(url)`` stops + restarts the actual process (the
           replica's own graceful ``stop()`` drains its queues),
        4. re-admit only after ``/healthz`` answers ok AND (when
           ``warmup_shape`` is given) a warmup probe recompiled its bucket
           ladder -- a replica is never handed traffic it would cold-compile
           against.
        """
        for url, rep in list(self._replicas.items()):
            rep.admin_down = True
            try:
                deadline = time.monotonic() + drain_timeout
                while rep.outstanding > 0 and time.monotonic() < deadline:
                    time.sleep(0.01)
                restarter(url)
                self._await_ready(rep, ready_timeout, warmup_shape,
                                  warmup_max_batch)
            finally:
                rep.admin_down = False
            with rep.lock:
                rep.state = ReplicaState.HEALTHY
                rep.consecutive_failures = 0
                rep.backoff = 0.0
                rep.draining = False
            self._m_readmissions.labels(router=self.id, replica=url).inc()

    def _await_ready(self, rep: _Replica, ready_timeout: float,
                     warmup_shape, warmup_max_batch) -> None:
        deadline = time.monotonic() + ready_timeout
        while True:
            try:
                if rep.probe_client.health().get("status") == "ok":
                    break
            except Exception:   # noqa: BLE001 -- still restarting
                pass
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"replica {rep.url} did not become healthy within "
                    f"{ready_timeout}s after restart")
            time.sleep(0.05)
        if warmup_shape is not None:
            rep.client.close()      # the pre-restart socket is stale
            rep.client.warmup(warmup_shape, max_batch=warmup_max_batch)

    # ------------------------------------------------------------------ info
    def health_info(self) -> dict:
        with self._lock:
            snapshot = list(self._replicas.items())
        states = {url: r.state for url, r in snapshot}
        routable = sum(1 for _, r in snapshot if r.routable())
        if self._stop.is_set():
            return {"status": "draining"}
        if routable == 0:
            return {"status": "degraded", "reason": "no_routable_replicas"}
        if routable < len(states):
            return {"status": "degraded", "reason": "replicas_out"}
        try:
            slo = self.slo.evaluate()
        except Exception:       # noqa: BLE001 -- SLO math can't break health
            slo = None
        if slo is not None and slo.fast_burn:
            return {"status": "degraded", "reason": "slo_fast_burn",
                    "slo": slo.as_dict()}
        return {"status": "ok"}

    def stats(self) -> dict:
        reps = {}
        with self._lock:
            snapshot = list(self._replicas.items())
        for url, r in snapshot:
            reps[url] = {"state": r.state,
                         "outstanding": r.outstanding,
                         "consecutive_failures": r.consecutive_failures,
                         "degraded": r.degraded,
                         "draining": r.draining,
                         "admin_down": r.admin_down,
                         "probe_backoff_s": r.backoff,
                         "role": r.role,
                         "affinity_heads": len(r.chain_heads)}
        return {"id": self.id,
                "replicas": reps,
                "retry_budget_balance": round(self.budget.balance, 3),
                "hedge_delay_ms": round(self._hedge_delay_s() * 1e3, 2),
                "total_outstanding": self._total_outstanding,
                "tenants": dict(self._tenant_outstanding),
                "journal": {"capacity": self.journal.capacity,
                            "records": len(self.journal),
                            "total": self.journal.total,
                            "dropped": self.journal.dropped}}
