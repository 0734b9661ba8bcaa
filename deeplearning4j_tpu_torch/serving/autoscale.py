"""Signal-driven fleet autoscaling over the routed serving tier.

Counterpart of deeplearning4j_tpu/serving/autoscale.py, with its names
and metric names. The ``Autoscaler`` is a control loop over signals the
tier already exports -- the router's per-replica outstanding counts, its
burn-rate SLO (monitor/slo.py) and the program registry's
``compile_seconds`` -- acting through the router's two runtime edges:

- scale up: spawn a replica (``ReplicaProcess(aot=artifact)``: the AOT
  artifact installs the kernel libraries and restores the programs'
  recipes, so a new replica starts no ``nvcc`` and runs no cost pass),
  gate on ``wait_ready()`` (a healthy /healthz) and an optional warmup
  probe, and only then ``router.add_upstream``: a replica never takes
  traffic before it can serve it;
- scale down: the least-loaded replica leaves through
  ``router.remove_upstream`` (drained), then its process stops.

Scale-to-zero: with ``min_replicas=0`` an idle fleet drains completely;
the router's ``hold_for_capacity_s`` and ``wake_hook`` (wired to
``Autoscaler.wake``) hold the next request while a replica comes up.
One scale event an evaluation, a cooldown between events and an idle
grace period before shrinking. Tests drive ``evaluate_once()`` with an
injected clock; the thread only calls it on a cadence and on ``wake()``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from deeplearning4j_tpu_torch.monitor import get_registry

__all__ = ["Autoscaler"]


class Autoscaler:
    """Grow/shrink a router's replica set from load + SLO signals.

    Parameters
    ----------
    router: the ``Router`` to act on (uses ``add_upstream`` /
        ``remove_upstream`` / ``replicas`` / ``slo``).
    spawn: zero-arg factory returning an UNstarted replica handle with
        the ``ReplicaProcess`` shape (``start() -> wait_ready() -> .url``,
        ``stop()``). Production passes
        ``lambda: ReplicaProcess(workdir, aot=artifact, ...)``; tests
        pass ``InProcessReplica`` factories.
    min_replicas / max_replicas: fleet bounds. ``min_replicas=0``
        enables scale-to-zero (pair the router with
        ``hold_for_capacity_s`` + this scaler's ``wake``).
    scale_up_outstanding: average outstanding requests per replica above
        which the fleet grows (the queueing signal).
    scale_down_outstanding: average below which a replica is a
        candidate to drain, once idle for ``idle_grace_s``.
    idle_grace_s: how long the shrink condition must hold continuously.
    cooldown_s: minimum time between scale events (wake-from-zero is
        exempt -- it is the emergency path).
    warmup_probe: optional ``handle -> bool`` extra admission gate run
        after ``wait_ready``; a False/raising probe stops the replica
        instead of admitting it.
    ready_timeout_s: passed to ``wait_ready``.
    clock / sleep: injectable time (tests drive a fake clock through
        ``evaluate_once``).
    """

    def __init__(self, router, spawn: Callable[[], object],
                 min_replicas: int = 1, max_replicas: int = 4,
                 scale_up_outstanding: float = 8.0,
                 scale_down_outstanding: float = 1.0,
                 idle_grace_s: float = 30.0,
                 cooldown_s: float = 10.0,
                 interval_s: float = 1.0,
                 warmup_probe: Optional[Callable[[object], bool]] = None,
                 ready_timeout_s: float = 180.0,
                 drain_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 name: str = "autoscaler"):
        if min_replicas < 0 or max_replicas < max(1, min_replicas):
            raise ValueError(
                f"need 0 <= min_replicas <= max_replicas (and max >= 1), "
                f"got {min_replicas}/{max_replicas}")
        self.router = router
        self.spawn = spawn
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_outstanding = float(scale_up_outstanding)
        self.scale_down_outstanding = float(scale_down_outstanding)
        self.idle_grace_s = float(idle_grace_s)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self.warmup_probe = warmup_probe
        self.ready_timeout_s = float(ready_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.id = name
        self._clock = clock
        self._sleep = sleep
        self._fleet: Dict[str, object] = {}     # url -> replica handle
        self._lock = threading.Lock()
        self._last_event = -float("inf")
        self._idle_since: Optional[float] = None
        self._kick = threading.Event()
        self._wake_pending = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        reg = get_registry()
        self._m_replicas = reg.gauge(
            "dl4jtpu_autoscaler_replicas",
            "Replicas the autoscaler currently owns (admitted to the "
            "router or mid-admission).", ("scaler",))
        self._m_replicas.labels(scaler=self.id).set_function(
            lambda: float(len(self._fleet)))
        self._m_events = reg.counter(
            "dl4jtpu_autoscaler_scale_events_total",
            "Fleet resize decisions that completed, by direction "
            "(up: replica admitted after ready+probe gates; down: "
            "replica drained and stopped).", ("scaler", "direction"))
        self._m_wakeups = reg.counter(
            "dl4jtpu_autoscaler_wakeups_total",
            "wake() calls (the router's scale-to-zero hold path poking "
            "the scaler to bring up capacity NOW).", ("scaler",))

    # ---------------------------------------------------------------- fleet
    @property
    def replica_count(self) -> int:
        return len(self._fleet)

    def adopt(self, handle) -> None:
        """Track an already-running, already-admitted replica (the boot
        fleet) so scale-down can drain it later."""
        with self._lock:
            self._fleet[handle.url] = handle

    # -------------------------------------------------------------- signals
    def signals(self) -> dict:
        """The decision inputs, as one readable dict (also what the
        autoscale bench row records)."""
        reps = self.router.replicas
        outs = [r.outstanding for r in list(reps.values())
                if not r.admin_down]
        n = max(1, len(outs))
        try:
            slo = self.router.slo.evaluate()
            fast_burn = bool(slo.fast_burn)
        except Exception:   # noqa: BLE001 -- SLO math can't break scaling
            fast_burn = False
        # program-cost signal: total registered program cost approximates
        # how expensive a cold replica is, i.e. how early to scale up
        try:
            from deeplearning4j_tpu_torch.exec.programs import get_programs
            compile_cost_s = sum(
                (e.get("compile_seconds") or 0.0)
                for e in get_programs().entries())
        except Exception:   # noqa: BLE001
            compile_cost_s = 0.0
        return {"replicas": len(self._fleet),
                "routable": len(outs),
                "outstanding_total": float(sum(outs)),
                "outstanding_per_replica": float(sum(outs)) / n,
                "fast_burn": fast_burn,
                "compile_cost_s": compile_cost_s}

    # ------------------------------------------------------------ decisions
    def evaluate_once(self) -> Optional[str]:
        """One control-loop pass. Returns "up"/"down" when a scale event
        completed, None otherwise. Thread-safe; the loop thread and tests
        share this entry."""
        with self._lock:
            now = self._clock()
            wake = self._wake_pending
            self._wake_pending = False

            if wake and not self._fleet:
                # scale-from-zero: bypass the cooldown -- a request is
                # being held at the router right now
                return self._scale_up(now)

            sig = self.signals()
            in_cooldown = now - self._last_event < self.cooldown_s

            want_up = (sig["fast_burn"]
                       or sig["outstanding_per_replica"]
                       >= self.scale_up_outstanding
                       or len(self._fleet) < self.min_replicas)
            if want_up and not in_cooldown \
                    and len(self._fleet) < self.max_replicas:
                self._idle_since = None
                return self._scale_up(now)

            calm = (not sig["fast_burn"]
                    and sig["outstanding_per_replica"]
                    <= self.scale_down_outstanding)
            if calm and len(self._fleet) > self.min_replicas:
                if self._idle_since is None:
                    self._idle_since = now
                elif (now - self._idle_since >= self.idle_grace_s
                      and not in_cooldown):
                    return self._scale_down(now)
            else:
                self._idle_since = None
            return None

    def _scale_up(self, now: float) -> Optional[str]:
        handle = self.spawn()
        try:
            handle.start()
            handle.wait_ready(timeout=self.ready_timeout_s)
            if self.warmup_probe is not None \
                    and not self.warmup_probe(handle):
                raise RuntimeError("warmup probe rejected the replica")
        except Exception:   # noqa: BLE001 -- a failed boot must not leak
            try:
                handle.stop()
            except Exception:   # noqa: BLE001
                pass
            return None
        self.router.add_upstream(handle.url)
        self._fleet[handle.url] = handle
        self._last_event = self._clock()
        self._m_events.labels(scaler=self.id, direction="up").inc()
        return "up"

    def _scale_down(self, now: float) -> Optional[str]:
        reps = self.router.replicas
        # least outstanding first; ties retire the NEWEST member (LIFO over
        # the insertion-ordered fleet) so the longest-lived replica survives
        cands = [(reps[url].outstanding if url in reps else 0, -i, url)
                 for i, url in enumerate(self._fleet)]
        if not cands:
            return None
        _, _, url = min(cands)
        handle = self._fleet.pop(url)
        self.router.remove_upstream(url, drain_timeout=self.drain_timeout_s)
        try:
            handle.stop()
        except Exception:   # noqa: BLE001 -- already-dead replica is fine
            pass
        self._last_event = self._clock()
        self._idle_since = None
        self._m_events.labels(scaler=self.id, direction="down").inc()
        return "down"

    # ----------------------------------------------------------------- wake
    def wake(self) -> None:
        """The router's scale-to-zero hook: a request arrived with no
        routable replica. Kicks the loop immediately (and flags the
        cooldown-exempt scale-from-zero path)."""
        self._m_wakeups.labels(scaler=self.id).inc()
        self._wake_pending = True
        self._kick.set()

    # ----------------------------------------------------------------- loop
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name=f"{self.id}-loop", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(timeout=self.interval_s)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.evaluate_once()
            except Exception:   # noqa: BLE001 -- the loop must survive
                pass

    def stop(self, stop_fleet: bool = True) -> None:
        """Stop the loop; with ``stop_fleet`` also drain + stop every
        owned replica (test teardown)."""
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if stop_fleet:
            with self._lock:
                fleet = dict(self._fleet)
                self._fleet.clear()
            for url, handle in fleet.items():
                try:
                    self.router.remove_upstream(url, drain_timeout=5.0)
                except Exception:   # noqa: BLE001
                    pass
                try:
                    handle.stop()
                except Exception:   # noqa: BLE001
                    pass
