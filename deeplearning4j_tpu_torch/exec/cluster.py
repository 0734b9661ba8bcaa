"""Elastic N-process training cluster: supervisor + subprocess workers.

Counterpart of deeplearning4j_tpu/exec/cluster.py, with its constructor
plus the keyword-only ``device`` its workers train on (the card unless
``"cpu"``). ``ClusterManager`` is the parent-side control plane for a
real multi-process data-parallel job on one machine:

    mgr = ClusterManager(workdir, workers=4, total_steps=12)
    result = mgr.run()          # spawn, supervise, auto-replace, collect

It runs the ``ElasticCoordinator`` (exec/elastic.py) in-process -- the
supervisor reads membership truth off the object directly, no RPC, and
runs no CUDA work -- and spawns one ``python -m
deeplearning4j_tpu_torch.exec.worker --device ...`` per seat through the
``host_device_env`` pattern (each child gets its own environment; the
parent's state is untouched). On one card the workers share it, one CUDA
context each. Supervision is the elastic story's other half: when the
coordinator evicts a seat (lease expired, partitioned link, graceful
leave), the manager spawns a REPLACEMENT worker into the same job -- the
job itself never restarts (surviving pids unchanged, spawn count == N +
kills). Every process it starts is stopped on any exit of ``run``.

Chaos is declarative: ``chaos={1: "die_at_step=5"}`` plants a scripted
self-SIGKILL in worker 1's env (``resilience.faults.WorkerChaos``), and
``partition=[2]`` routes worker 2's coordinator link through a
``BlackholeProxy`` the test can starve -- the worker keeps running but its
heartbeats vanish, the partition the lease detector exists for.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.exec.elastic import (CoordinatorServer,
                                                   ElasticCoordinator)
from deeplearning4j_tpu_torch.exec.mesh import host_device_env

__all__ = ["WorkerProcess", "ClusterManager"]


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


class WorkerProcess:
    """Parent-side handle for one subprocess worker (the ReplicaProcess
    idiom: port-file handshake, log-to-file, SIGTERM drain, SIGKILL).

    The port-file carries the child's PID once it has JOINED the
    coordinator — the spawn handshake ``wait_joined`` blocks on.
    """

    def __init__(self, workdir: str, coordinator_url: str, worker_id: str,
                 rank: int, devices: int = 1, chaos: Optional[str] = None,
                 env: Optional[dict] = None, *, device: str = "cuda"):
        self.workdir = workdir
        self.coordinator_url = coordinator_url
        self.worker_id = worker_id
        self.rank = rank
        self.devices = devices
        self.chaos = chaos
        self.extra_env = env
        self.device = str(device)
        self.proc: Optional[subprocess.Popen] = None
        self.spawned_at: Optional[float] = None
        self._log = os.path.join(workdir, f"{worker_id}.log")
        self._port_file = os.path.join(workdir, f"{worker_id}.port")

    @property
    def pid(self) -> Optional[int]:
        return None if self.proc is None else self.proc.pid

    def start(self) -> "WorkerProcess":
        if os.path.exists(self._port_file):
            os.unlink(self._port_file)
        cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.exec.worker",
               "--coordinator", self.coordinator_url,
               "--worker-id", self.worker_id,
               "--rank", str(self.rank),
               "--port-file", self._port_file,
               "--device", self.device]
        env = host_device_env(self.devices)
        env["PYTHONPATH"] = (_repo_root() + os.pathsep
                             + env.get("PYTHONPATH", ""))
        if self.chaos:
            env["DL4JTPU_WORKER_CHAOS"] = self.chaos
        else:
            env.pop("DL4JTPU_WORKER_CHAOS", None)
        if self.extra_env:
            env.update(self.extra_env)
        # log to a FILE: a full stdout pipe would deadlock a worker nobody
        # reads, and the post-mortem wants the log anyway. The child owns
        # its inherited fd after the spawn, so the parent's handle closes
        # immediately — replacements must not leak descriptors in the
        # supervisor for the life of the run.
        self.spawned_at = time.monotonic()
        with open(self._log, "ab") as logf:
            self.proc = subprocess.Popen(cmd, stdout=logf,
                                         stderr=subprocess.STDOUT, env=env,
                                         cwd=self.workdir)
        return self

    def wait_joined(self, timeout: float = 120.0) -> "WorkerProcess":
        deadline = time.monotonic() + timeout
        while True:
            if os.path.exists(self._port_file):
                with open(self._port_file) as f:
                    if f.read().strip():
                        return self
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"worker {self.worker_id} exited "
                    f"rc={self.proc.returncode} before joining; "
                    f"see {self._log}")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"worker {self.worker_id} never joined; see {self._log}")
            time.sleep(0.05)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self, timeout: float = 30.0) -> None:
        """SIGTERM → wait → SIGKILL."""
        if self.proc is None or self.proc.poll() is not None:
            return
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def kill(self) -> None:
        """SIGKILL, no drain — the crash the lease detector must catch."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def log_text(self) -> str:
        try:
            with open(self._log, "r", errors="replace") as f:
                return f.read()
        except OSError:
            return ""


class ClusterManager:
    """Spawn, supervise and auto-replace the worker fleet for one job.

    ``chaos``: {spawn_index: WorkerChaos spec string} — planted only in
    the ORIGINAL worker at that seat, never in its replacement (a scripted
    death must not re-kill the seat forever).
    ``replace``: auto-spawn a replacement when a seat is evicted (up to
    ``max_replacements``); False lets the grace window expire into an N-1
    degraded commit instead.
    ``partition``: spawn these seats with their coordinator link routed
    through a ``BlackholeProxy`` — ``mgr.partition_worker("w2")`` then
    starves the link (heartbeats vanish, the worker process lives), the
    exact failure the lease detector exists for.
    """

    def __init__(self, workdir: str, workers: int = 2, *,
                 devices_per_worker: int = 1, total_steps: int = 8,
                 global_batch: int = 32, model: str = "mlp", seed: int = 42,
                 ckpt_every: int = 4, aot: bool = True,
                 hb_interval: float = 0.25, suspect_after: float = 1.5,
                 evict_after: float = 4.0, replacement_grace: float = 8.0,
                 replace: bool = True, max_replacements: int = 4,
                 chaos: Optional[Dict[int, str]] = None,
                 partition: Optional[List[int]] = None,
                 data_plane: str = "chain", codec: str = "dense",
                 bucket_mb: float = 4.0, threshold: float = 1e-3,
                 min_threshold: float = 1e-5, threshold_step: float = 1e-5,
                 capacity_fraction: float = 0.1, device: str = "cuda"):
        self.workdir = os.fspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.workers = int(workers)
        self.devices_per_worker = int(devices_per_worker)
        self.replace = replace
        self.max_replacements = int(max_replacements)
        self.chaos = dict(chaos or {})
        self.device = str(device)
        self.ckpt_dir = os.path.join(self.workdir, "ckpt")
        self.coord = ElasticCoordinator(
            workers, total_steps=total_steps, global_batch=global_batch,
            model=model, seed=seed, ckpt_dir=self.ckpt_dir,
            ckpt_every=ckpt_every, aot=aot, hb_interval=hb_interval,
            suspect_after=suspect_after, evict_after=evict_after,
            replacement_grace=replacement_grace, data_plane=data_plane,
            codec=codec, bucket_mb=bucket_mb, threshold=threshold,
            min_threshold=min_threshold, threshold_step=threshold_step,
            capacity_fraction=capacity_fraction)
        self.server = CoordinatorServer(self.coord,
                                        tick_interval=hb_interval / 2)
        self.procs: Dict[str, WorkerProcess] = {}
        self.proxies: Dict[str, object] = {}
        self._partition = set(partition or ())
        self.spawn_count = 0
        self.replacements = 0
        self._events_seen = 0

    @property
    def url(self) -> str:
        return self.server.url

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ClusterManager":
        self.server.start()
        for i in range(self.workers):
            self._spawn(f"w{i}", rank=i, chaos=self.chaos.get(i),
                        proxied=i in self._partition)
        return self

    def _spawn(self, worker_id: str, rank: int,
               chaos: Optional[str] = None,
               proxied: bool = False) -> WorkerProcess:
        url = self.url
        if proxied:
            from deeplearning4j_tpu_torch.resilience.faults import \
                BlackholeProxy
            proxy = BlackholeProxy(self.server.port).start()
            self.proxies[worker_id] = proxy
            url = f"http://127.0.0.1:{proxy.port}"
        wp = WorkerProcess(self.workdir, url, worker_id, rank,
                           devices=self.devices_per_worker, chaos=chaos,
                           device=self.device)
        self.procs[worker_id] = wp.start()
        self.spawn_count += 1
        return wp

    def partition_worker(self, worker_id: str, on: bool = True) -> None:
        """Starve (or heal) a proxied worker's coordinator link. The
        worker must have been spawned with its seat in ``partition``."""
        self.proxies[worker_id].blackhole(on)

    def _supervise_once(self) -> None:
        """Drain new coordinator events; replace evicted seats. The
        replacement id is ``<seat>r<n>`` so logs and spill files name the
        lineage."""
        with self.coord._lock:
            events = self.coord.events[self._events_seen:]
            self._events_seen += len(events)
            done = self.coord.phase == "done"
        for ev in events:
            # a finished job needs no replacement — the eviction that
            # completed it (last non-reporter died) must not spawn one
            if done or ev["type"] != "evicted" or not self.replace:
                continue
            if self.replacements >= self.max_replacements:
                continue
            dead = ev["worker_id"]
            seat = dead.split("r")[0]
            self.replacements += 1
            wid = f"{seat}r{self.replacements}"
            # never inherit the dead worker's chaos: a scripted death
            # would re-kill every replacement at the same step
            self._spawn(wid, rank=ev.get("rank") or 0, chaos=None)

    def run(self, timeout: float = 300.0) -> dict:
        """Start (if needed), supervise to completion, stop, report."""
        if not self.procs:
            self.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                self._supervise_once()
                state = self.coord.state()
                if state["phase"] == "done":
                    break
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"cluster did not finish in {timeout}s: "
                        f"phase={state['phase']} "
                        f"reduced={state['reduced_steps']} "
                        f"members={list(state['members'])}")
                if (not any(p.alive() for p in self.procs.values())
                        and state["phase"] != "done"):
                    logs = {w: p.log_text()[-2000:]
                            for w, p in self.procs.items()}
                    codes = {w: p.proc.returncode
                             for w, p in self.procs.items() if p.proc}
                    raise RuntimeError(
                        f"every worker exited before the job finished: "
                        f"{codes}\n{logs}")
                time.sleep(0.05)
            # drain: workers exit on their own once they observe the done
            # phase — waiting here lets them return rc=0 instead of eating
            # the teardown SIGTERM (the soak asserts survivors' exit codes)
            drain = time.monotonic() + 15.0
            while (any(p.alive() for p in self.procs.values())
                   and time.monotonic() < drain):
                time.sleep(0.05)
            return self.result()
        finally:
            self.stop()

    def result(self) -> dict:
        state = self.coord.state()
        from deeplearning4j_tpu_torch.resilience.checkpoint import \
            latest_checkpoint
        return {
            "results": state["results"],
            "generation": state["generation"],
            "world": state["world"],
            "reduced_steps": state["reduced_steps"],
            "last_recovery_wall": state["last_recovery_wall"],
            "spawns": self.spawn_count,
            "replacements": self.replacements,
            "checkpoint": latest_checkpoint(self.ckpt_dir),
            "events": state["events"],
        }

    def stop(self) -> None:
        for p in self.procs.values():
            try:
                p.stop(timeout=10)
            except Exception:   # noqa: BLE001 — teardown must finish
                try:
                    p.kill()
                except Exception:   # noqa: BLE001
                    pass
        for proxy in self.proxies.values():
            try:
                proxy.stop()
            except Exception:   # noqa: BLE001
                pass
        self.server.stop()

    # -- chaos hooks (the tests' remote control) ---------------------------
    def worker(self, worker_id: str) -> WorkerProcess:
        return self.procs[worker_id]

    def kill_worker(self, worker_id: str) -> None:
        from deeplearning4j_tpu_torch.resilience.faults import kill_worker
        kill_worker(self.procs[worker_id])
