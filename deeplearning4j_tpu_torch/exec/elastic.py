"""Elastic training coordination: leases, generations, fenced recovery.

Counterpart of deeplearning4j_tpu/exec/elastic.py, line for line: the
coordination plane that makes the N-process cluster (exec/cluster.py)
survive worker death. It is pure host logic over numpy and never touches
a tensor or the card. One ``ElasticCoordinator`` owns the membership
truth:

- **Heartbeat leases.** Every worker renews a lease; a missed lease walks
  the router health-state-machine idiom: ``live -> suspect ->`` evicted.
  All timing flows through an injectable clock, so tests drive the whole
  matrix with a fake clock and zero sleeps.
- **Generation-numbered membership.** Every committed membership is a
  *generation*. Any change -- eviction, a replacement joining, a rejoin
  after a healed partition -- proposes generation ``g+1``; members must
  roll back to the checkpoint anchor and ``sync`` to the proposal before
  it commits. Contributions stamped with a dead generation are fenced
  (rejected + counted), so a partitioned straggler can never corrupt a
  step it no longer participates in.
- **Checkpoint-anchored recovery.** Rank 0 reports every atomic
  checkpoint save as the *anchor*; recovery means everyone restores the
  anchor and resumes from its step. Because the checkpoint restores bit
  for bit and batches/reduction order are deterministic, a killed-and-
  recovered run re-trains into the exact trajectory of an unkilled one.
- **Graceful degradation.** After an eviction the coordinator waits
  ``replacement_grace`` seconds for a replacement; if none joins, it
  commits the new generation at N-1 (ranks compacted, batch re-sharded)
  -- throughput drops, correctness doesn't. A later join re-forms at N.
- **Control plane only (by default).** Gradient bytes travel the
  peer-to-peer chunk-pipelined chain (``exec/comms.py``,
  ``data_plane="chain"``): the coordinator hands each committed
  generation's rank -> (host, port) endpoint map to the members and never
  sees a gradient. The star reducer is kept behind ``data_plane="star"``
  as the parity oracle and bench baseline: each member posts
  ``loss||grads`` pre-scaled by its shard rows; the coordinator sums in
  rank order (fixed float association: bitwise reproducible) and divides
  by the total rows -- the exact arithmetic the chain reproduces hop by
  hop. The worker's ``DL4JTPU_CLUSTER_BACKEND=torch`` probe switches to a
  gloo all-gather summed in the same rank order instead.

``CoordinatorServer`` wraps the state machine in the same stdlib
ThreadingHTTPServer transport the serving tier uses; workers talk to it
through the shared retry primitive (``component="cluster"``). The
metrics are the JAX package's names in the port's registry
(``monitor.get_registry``).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ElasticCoordinator", "CoordinatorServer", "Member",
           "FencedError", "EvictedError", "ClusterFullError",
           "LIVE", "SUSPECT"]

LIVE = "live"
SUSPECT = "suspect"

# how many reduced steps stay cached for idempotent re-reads after a
# worker's HTTP timeout made it re-POST an already-reduced contribution
_REDUCED_KEEP = 8


class FencedError(Exception):
    """Contribution stamped with a dead generation (or posted while a
    reform is in flight): rejected, counted, the worker must roll back to
    the anchor and sync to the proposed generation."""

    def __init__(self, msg: str, proposal: Optional[int] = None,
                 anchor: Optional[dict] = None):
        super().__init__(msg)
        self.proposal = proposal
        self.anchor = anchor or {}


class EvictedError(Exception):
    """The worker is no longer a member (lease expired, or it left): its
    process should exit; a *replacement* joins in its place."""


class ClusterFullError(Exception):
    """A join beyond ``world_size`` — the supervisor overspawned."""


@dataclass
class Member:
    worker_id: str
    joined_at: float
    last_hb: float
    state: str = LIVE
    rank: Optional[int] = None          # assigned at generation commit
    synced_gen: int = 0                 # highest proposal this member ack'd
    steps_done: int = 0
    data_port: int = 0                  # peer data-plane listener (comms.py)


@dataclass
class _Barrier:
    """One allreduce step's contributions (keyed by (generation, step))."""

    contrib: Dict[int, tuple] = field(default_factory=dict)  # rank → (rows, vec)
    fenced: bool = False


class ElasticCoordinator:
    """Membership + lease + generation + reduction state machine.

    Pure logic: no sockets, no threads of its own, every timestamp from
    the injected ``clock`` — tests/test_torch_elastic.py drives the whole
    suspect/evict/rejoin/degrade matrix with a fake clock. The HTTP plane
    (``CoordinatorServer``) and the in-process adapter call the same
    methods.
    """

    def __init__(self, world_size: int, *, total_steps: int = 8,
                 global_batch: int = 32, model: str = "mlp", seed: int = 42,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 4,
                 aot: bool = True,
                 hb_interval: float = 0.25, suspect_after: float = 1.5,
                 evict_after: float = 4.0, replacement_grace: float = 8.0,
                 data_plane: str = "chain", codec: str = "dense",
                 bucket_mb: float = 4.0, threshold: float = 1e-3,
                 min_threshold: float = 1e-5, threshold_step: float = 1e-5,
                 capacity_fraction: float = 0.1,
                 clock=time.monotonic):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if data_plane not in ("chain", "star"):
            raise ValueError(f"data_plane must be chain|star, "
                             f"got {data_plane!r}")
        if codec not in ("dense", "threshold"):
            raise ValueError(f"codec must be dense|threshold, got {codec!r}")
        self.target_world = int(world_size)
        self.total_steps = int(total_steps)
        self.global_batch = int(global_batch)
        self.model = model
        self.seed = int(seed)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self.aot = bool(aot)
        self.hb_interval = float(hb_interval)
        self.suspect_after = float(suspect_after)
        self.evict_after = float(evict_after)
        self.replacement_grace = float(replacement_grace)
        self.data_plane = data_plane
        self.codec = codec
        self.bucket_mb = float(bucket_mb)
        self.threshold = float(threshold)
        self.min_threshold = float(min_threshold)
        self.threshold_step = float(threshold_step)
        self.capacity_fraction = float(capacity_fraction)
        self._clock = clock

        self.generation = 0                 # last COMMITTED generation
        self.world = 0                      # committed member count
        self.proposal: Optional[int] = 1    # pending generation (1 = forming)
        self._grace_deadline: Optional[float] = None
        self._evict_t: Optional[float] = None   # start of current recovery
        self.last_recovery_wall: Optional[float] = None
        self.phase = "forming"              # forming | running | done
        self.anchor: dict = {"step": 0, "path": None}

        self._members: Dict[str, Member] = {}
        self._barriers: Dict[tuple, _Barrier] = {}
        self._reduced: Dict[tuple, np.ndarray] = {}
        self._results: Dict[str, dict] = {}
        self.events: List[dict] = []        # supervisor-facing journal
        self._joins = 0
        self.reduced_steps = 0

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._metrics_init()

    # ------------------------------------------------------------- metrics
    def _metrics_init(self):
        from deeplearning4j_tpu_torch.monitor import get_registry
        reg = get_registry()
        self._g_workers = reg.gauge(
            "dl4jtpu_cluster_workers",
            "Cluster members by lease state (evicted members leave the "
            "table, so live+suspect is current membership).", ("state",))
        self._g_generation = reg.gauge(
            "dl4jtpu_cluster_generation",
            "Committed membership generation; stale-generation "
            "contributions are fenced.")
        self._g_world = reg.gauge(
            "dl4jtpu_cluster_world_size",
            "Members in the committed generation (target-N, or N-1 while "
            "degraded after an unreplaced eviction).")
        self._c_hb = reg.counter(
            "dl4jtpu_cluster_heartbeats_total",
            "Heartbeat lease renewals accepted by the coordinator.")
        self._c_evict = reg.counter(
            "dl4jtpu_cluster_evictions_total",
            "Members evicted from the cluster, by reason.", ("reason",))
        self._c_rejoin = reg.counter(
            "dl4jtpu_cluster_rejoins_total",
            "Joins after initial formation: replacements for evicted "
            "workers and healed partitions coming back.")
        self._c_fenced = reg.counter(
            "dl4jtpu_cluster_fenced_contributions_total",
            "RPCs rejected for carrying a dead generation (or landing "
            "mid-reform), by rpc kind.", ("rpc",))
        self._c_recover = reg.counter(
            "dl4jtpu_cluster_recoveries_total",
            "Eviction-triggered reforms committed: 'replaced' back at "
            "target N, 'degraded' at N-1 after the grace window.",
            ("outcome",))
        self._c_steps = reg.counter(
            "dl4jtpu_cluster_steps_total",
            "Gradient allreduce steps reduced across the cluster.")
        self._h_reduce = reg.histogram(
            "dl4jtpu_cluster_allreduce_seconds",
            "Wall seconds a contribution waited at the allreduce barrier "
            "(first contribution in to reduction out).",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))

    def _publish_gauges(self):
        live = sum(1 for m in self._members.values() if m.state == LIVE)
        sus = sum(1 for m in self._members.values() if m.state == SUSPECT)
        self._g_workers.labels(state=LIVE).set(live)
        self._g_workers.labels(state=SUSPECT).set(sus)
        self._g_generation.set(self.generation)
        self._g_world.set(self.world)

    # ----------------------------------------------------------- membership
    def config(self) -> dict:
        """Static job config a joining worker needs before first sync."""
        return {"model": self.model, "seed": self.seed,
                "total_steps": self.total_steps,
                "global_batch": self.global_batch,
                "ckpt_dir": self.ckpt_dir, "ckpt_every": self.ckpt_every,
                "aot": self.aot,
                "hb_interval": self.hb_interval,
                "suspect_after": self.suspect_after,
                "evict_after": self.evict_after,
                "replacement_grace": self.replacement_grace,
                "data_plane": self.data_plane, "codec": self.codec,
                "bucket_mb": self.bucket_mb,
                "threshold": self.threshold,
                "min_threshold": self.min_threshold,
                "threshold_step": self.threshold_step,
                "capacity_fraction": self.capacity_fraction}

    def join(self, worker_id: str, data_port: int = 0) -> dict:
        """Register a worker. Initial joins assemble generation 1; any
        join after that (replacement / healed partition) counts as a
        rejoin and proposes a new generation everyone must sync to.
        ``data_port`` is the worker's peer data-plane listener — published
        to every member in the committed membership view so the chain can
        dial rank-adjacent neighbors directly."""
        with self._lock:
            now = self._clock()
            if (worker_id not in self._members
                    and len(self._members) >= self.target_world):
                raise ClusterFullError(
                    f"cluster already has {len(self._members)} members "
                    f"(target {self.target_world})")
            rejoin = self.generation > 0
            self._members[worker_id] = Member(worker_id=worker_id,
                                              joined_at=now, last_hb=now,
                                              data_port=int(data_port))
            self._joins += 1
            if rejoin:
                self._c_rejoin.inc()
                self._propose(now, reason=f"join:{worker_id}")
            self.events.append({"type": "join", "worker_id": worker_id,
                                "rejoin": rejoin, "t": now})
            self._publish_gauges()
            return {"ok": True, "proposal": self.proposal,
                    "config": self.config()}

    def leave(self, worker_id: str) -> None:
        """Graceful departure (drain): evict without a lease expiry."""
        with self._lock:
            if worker_id in self._members:
                self._evict(worker_id, reason="left")

    def sync(self, worker_id: str, generation: int) -> dict:
        """Worker acks a proposed generation (after rolling back to the
        anchor). Returns ``{"status": "wait"}`` until the proposal
        commits, then the committed membership view."""
        with self._lock:
            m = self._members.get(worker_id)
            if m is None:
                raise EvictedError(f"{worker_id} is not a member")
            m.last_hb = self._clock()       # syncing proves liveness
            if self.proposal is not None and generation == self.proposal:
                m.synced_gen = generation
                self._try_commit(self._clock())
            if self.proposal is None and generation == self.generation:
                return self._membership_view(worker_id)
            return {"status": "wait",
                    "proposal": self.proposal or self.generation}

    def _membership_view(self, worker_id: str) -> dict:
        m = self._members[worker_id]
        return {"status": "go", "generation": self.generation,
                "rank": m.rank, "world": self.world,
                "anchor": dict(self.anchor), "phase": self.phase,
                "endpoints": {str(o.rank): ["127.0.0.1", o.data_port]
                              for o in self._members.values()
                              if o.rank is not None}}

    def _propose(self, now: float, reason: str, evicted: bool = False):
        """Open (or refresh) a reform: next generation, members must
        re-sync. Fences every in-flight barrier."""
        self.proposal = self.generation + 1
        if evicted and len(self._members) < self.target_world:
            self._grace_deadline = now + self.replacement_grace
        elif len(self._members) >= self.target_world:
            self._grace_deadline = None
        self.events.append({"type": "reform_proposed",
                            "proposal": self.proposal, "reason": reason,
                            "t": now})
        for key, b in self._barriers.items():
            if not b.fenced:
                b.fenced = True
        self._cond.notify_all()

    def _try_commit(self, now: float):
        if self.proposal is None or not self._members:
            return
        if any(m.synced_gen != self.proposal
               for m in self._members.values()):
            return
        full = len(self._members) >= self.target_world
        grace_over = (self._grace_deadline is not None
                      and now >= self._grace_deadline)
        if not full and not grace_over:
            return
        # commit: survivors keep their ranks when the world is full
        # (replacements fill the holes — shard mapping matches an unkilled
        # run, the bitwise-parity soak pins this); a degraded commit
        # compacts ranks by previous order so 0..W-1 stays contiguous
        members = list(self._members.values())
        if full:
            taken = {m.rank for m in members
                     if m.rank is not None and m.rank < self.target_world}
            free = [r for r in range(self.target_world) if r not in taken]
            seen = set()
            for m in sorted(members, key=lambda m: m.joined_at):
                if m.rank is None or m.rank in seen or m.rank >= self.target_world:
                    m.rank = free.pop(0)
                seen.add(m.rank)
        else:
            order = sorted(members,
                           key=lambda m: (m.rank if m.rank is not None
                                          else 1 << 30, m.joined_at))
            for r, m in enumerate(order):
                m.rank = r
        self.generation = self.proposal
        self.world = len(members)
        self.proposal = None
        self._grace_deadline = None
        self._barriers.clear()
        self._reduced.clear()
        if self._evict_t is not None:
            self.last_recovery_wall = now - self._evict_t
            self._c_recover.labels(
                outcome="replaced" if full else "degraded").inc()
            self._evict_t = None
        self.phase = "running"
        self.events.append({"type": "generation_committed",
                            "generation": self.generation,
                            "world": self.world, "t": now,
                            "ranks": {m.worker_id: m.rank
                                      for m in members}})
        self._publish_gauges()
        self._cond.notify_all()

    # ---------------------------------------------------------- lease clock
    def heartbeat(self, worker_id: str, generation: int = 0,
                  step: int = 0) -> dict:
        with self._lock:
            m = self._members.get(worker_id)
            if m is None:
                raise EvictedError(f"{worker_id} is not a member")
            m.last_hb = self._clock()
            if m.state == SUSPECT:
                m.state = LIVE          # a heartbeat heals suspicion
            m.steps_done = max(m.steps_done, int(step))
            self._advance_reduced()
            self._c_hb.inc()
            self._publish_gauges()
            directive = "none"
            if self.proposal is not None and m.synced_gen != self.proposal:
                directive = "rollback"
            elif generation and generation != self.generation:
                directive = "rollback"
            return {"generation": self.generation,
                    "proposal": self.proposal, "directive": directive,
                    "anchor": dict(self.anchor), "phase": self.phase}

    def tick(self, now: Optional[float] = None) -> None:
        """Advance the failure detector: lease ages walk live → suspect →
        evicted, and an expired grace window commits a degraded world."""
        with self._lock:
            now = self._clock() if now is None else now
            for wid in list(self._members):
                m = self._members[wid]
                age = now - m.last_hb
                if age >= self.evict_after:
                    self._evict(wid, reason="lease_expired", now=now)
                elif age >= self.suspect_after and m.state == LIVE:
                    m.state = SUSPECT
                    self.events.append({"type": "suspect",
                                        "worker_id": wid, "t": now})
            self._try_commit(now)
            self._publish_gauges()

    def _evict(self, worker_id: str, reason: str,
               now: Optional[float] = None):
        now = self._clock() if now is None else now
        m = self._members.pop(worker_id)
        self._c_evict.labels(reason=reason).inc()
        if self._evict_t is None:
            self._evict_t = now
        self.events.append({"type": "evicted", "worker_id": worker_id,
                            "rank": m.rank, "reason": reason, "t": now})
        # the dead member may have been the only one yet to post a result;
        # without this re-check the finished survivors would wait in a
        # reform nobody can commit and the job would never reach "done"
        self._maybe_done()
        if self.phase != "done":
            if self._members:
                self._propose(now, reason=f"evict:{worker_id}", evicted=True)
            else:
                self.proposal = self.generation + 1
                self._grace_deadline = None
        self._publish_gauges()
        self._cond.notify_all()

    # ------------------------------------------------------------ allreduce
    def _fence(self, rpc: str, msg: str):
        self._c_fenced.labels(rpc=rpc).inc()
        raise FencedError(msg, proposal=self.proposal,
                          anchor=dict(self.anchor))

    def contribute(self, worker_id: str, generation: int, step: int,
                   rows: int, vec: np.ndarray) -> None:
        """Post one member's pre-scaled ``loss‖grads`` vector for ``step``.
        Idempotent per (generation, step, rank): a retry after an HTTP
        timeout re-registers the same contribution."""
        with self._lock:
            m = self._members.get(worker_id)
            if m is None:
                raise EvictedError(f"{worker_id} is not a member")
            if generation != self.generation or self.proposal is not None:
                self._fence("allreduce",
                            f"stale generation {generation} "
                            f"(current {self.generation}, "
                            f"proposal {self.proposal})")
            key = (generation, step)
            if key in self._reduced:
                return                  # already reduced: reader path serves it
            b = self._barriers.setdefault(key, _Barrier())
            b.contrib[m.rank] = (int(rows), np.asarray(vec, np.float32))
            m.steps_done = max(m.steps_done, step)
            if len(b.contrib) >= self.world:
                total = None
                rows_sum = 0
                for r in sorted(b.contrib):     # rank order: deterministic
                    n, v = b.contrib[r]
                    rows_sum += n
                    total = v.copy() if total is None else total + v
                self._reduced[key] = (total / np.float32(rows_sum))
                while len(self._reduced) > _REDUCED_KEEP:
                    del self._reduced[min(self._reduced)]
                del self._barriers[key]
                self.reduced_steps = max(self.reduced_steps, step + 1)
                self._c_steps.inc()
            self._cond.notify_all()

    def wait_reduced(self, worker_id: str, generation: int, step: int,
                     timeout: float = 60.0) -> np.ndarray:
        """Block until ``step``'s reduction is ready (or the barrier is
        fenced by a membership change). Real-clock timeout: this is the
        HTTP handler's wait, not the failure detector's."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        with self._lock:
            while True:
                key = (generation, step)
                if key in self._reduced:
                    self._h_reduce.observe(time.monotonic() - t0)
                    return self._reduced[key]
                if worker_id not in self._members:
                    raise EvictedError(f"{worker_id} evicted mid-barrier")
                if generation != self.generation or self.proposal is not None:
                    self._fence("allreduce",
                                f"barrier fenced at generation {generation}")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"allreduce step {step} gen {generation}: barrier "
                        f"incomplete after {timeout}s")
                self._cond.wait(timeout=min(remaining, 0.1))

    # ----------------------------------------------------- anchor / results
    def anchor_report(self, worker_id: str, generation: int, step: int,
                      path: Optional[str]) -> dict:
        """Rank 0 reports an atomic checkpoint at ``step`` — the recovery
        anchor every rollback restores."""
        with self._lock:
            if worker_id not in self._members:
                raise EvictedError(f"{worker_id} is not a member")
            if generation != self.generation or self.proposal is not None:
                self._fence("anchor", f"anchor from dead generation "
                                      f"{generation}")
            self.anchor = {"step": int(step), "path": path}
            self.events.append({"type": "anchor", "step": int(step),
                                "path": path, "t": self._clock()})
            return dict(self.anchor)

    def _advance_reduced(self) -> None:
        """On the peer-to-peer data plane the coordinator never sees a
        gradient, so reduced progress is inferred from reported steps: the
        chain is lockstep — a member can only be at step s+1 once step s
        reduced across everyone — so min(steps_done) is the fully-reduced
        floor. Monotone (max) because members report anchor-rolled-back
        steps during reforms. The star path still advances the counter
        directly at each barrier; this floor can never outrun it."""
        if not self._members:
            return
        floor = min(m.steps_done for m in self._members.values())
        if floor > self.reduced_steps:
            self._c_steps.inc(floor - self.reduced_steps)
            self.reduced_steps = floor

    def result(self, worker_id: str, payload: dict) -> None:
        with self._lock:
            self._results[worker_id] = dict(payload)
            m = self._members.get(worker_id)
            if m is not None:
                m.steps_done = max(m.steps_done,
                                   int(payload.get("steps") or 0))
                self._advance_reduced()
            self._maybe_done()

    def _maybe_done(self):
        """Every live member has posted its result → the job is done.
        Checked after results AND after evictions, because either event
        can be the one that completes the condition."""
        live = set(self._members)
        if live and live <= set(self._results):
            self.phase = "done"
            self._cond.notify_all()

    def results(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._results)

    def state(self) -> dict:
        with self._lock:
            return {
                "phase": self.phase, "generation": self.generation,
                "proposal": self.proposal, "world": self.world,
                "target_world": self.target_world,
                "anchor": dict(self.anchor),
                "reduced_steps": self.reduced_steps,
                "last_recovery_wall": self.last_recovery_wall,
                "members": {wid: {"rank": m.rank, "state": m.state,
                                  "synced_gen": m.synced_gen,
                                  "steps_done": m.steps_done}
                            for wid, m in self._members.items()},
                "results": dict(self._results),
                "events": list(self.events),
            }


# --------------------------------------------------------------------------
# HTTP plane
# --------------------------------------------------------------------------

def _mk_handler(coord: ElasticCoordinator):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):       # quiet: the events journal is the log
            pass

        def _json(self, code: int, doc: dict):
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0) or 0)
            return self.rfile.read(n) if n else b""

        def do_GET(self):
            if self.path.split("?")[0] == "/state":
                self._json(200, coord.state())
            else:
                self._json(404, {"error": "not_found"})

        def do_POST(self):  # noqa: C901 — one dispatch table, kept flat
            path = self.path.split("?")[0]
            try:
                if path == "/allreduce":
                    h = self.headers
                    wid = h.get("X-Worker", "")
                    gen = int(h.get("X-Gen", 0))
                    step = int(h.get("X-Step", 0))
                    rows = int(h.get("X-Rows", 0))
                    vec = np.frombuffer(self._read_body(), dtype=np.float32)
                    coord.contribute(wid, gen, step, rows, vec)
                    out = coord.wait_reduced(wid, gen, step)
                    self._bytes(200, out.astype(np.float32).tobytes())
                    return
                doc = json.loads(self._read_body() or b"{}")
                if path == "/join":
                    self._json(200, coord.join(
                        doc["worker_id"],
                        int(doc.get("data_port", 0) or 0)))
                elif path == "/sync":
                    self._json(200, coord.sync(doc["worker_id"],
                                               int(doc["generation"])))
                elif path == "/heartbeat":
                    self._json(200, coord.heartbeat(
                        doc["worker_id"], int(doc.get("generation", 0)),
                        int(doc.get("step", 0))))
                elif path == "/anchor":
                    self._json(200, coord.anchor_report(
                        doc["worker_id"], int(doc["generation"]),
                        int(doc["step"]), doc.get("path")))
                elif path == "/leave":
                    coord.leave(doc["worker_id"])
                    self._json(200, {"ok": True})
                elif path == "/result":
                    coord.result(doc["worker_id"], doc.get("result", {}))
                    self._json(200, {"ok": True})
                else:
                    self._json(404, {"error": "not_found"})
            except FencedError as e:
                self._json(409, {"error": "stale_generation",
                                 "message": str(e),
                                 "proposal": e.proposal,
                                 "anchor": e.anchor})
            except EvictedError as e:
                self._json(410, {"error": "evicted", "message": str(e)})
            except ClusterFullError as e:
                self._json(409, {"error": "cluster_full",
                                 "message": str(e)})
            except TimeoutError as e:
                self._json(503, {"error": "barrier_timeout",
                                 "message": str(e)})
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": "bad_request",
                                 "message": str(e)})

    return Handler


class CoordinatorServer:
    """The coordinator's HTTP face + its failure-detector clock thread.

    ``tick_interval=None`` disables the background ticker (tests that
    drive ``coord.tick`` with a fake clock run the server purely as
    transport)."""

    def __init__(self, coord: ElasticCoordinator, port: int = 0,
                 tick_interval: Optional[float] = 0.1):
        self.coord = coord
        self.tick_interval = tick_interval
        from http.server import ThreadingHTTPServer
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                          _mk_handler(coord))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "CoordinatorServer":
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="coord-http", daemon=True)
        t.start()
        self._threads.append(t)
        if self.tick_interval:
            tt = threading.Thread(target=self._tick_loop, name="coord-tick",
                                  daemon=True)
            tt.start()
            self._threads.append(tt)
        return self

    def _tick_loop(self):
        while not self._stop.wait(self.tick_interval):
            try:
                self.coord.tick()
            except Exception:   # noqa: BLE001 — the detector must not die
                pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
