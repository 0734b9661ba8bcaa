"""Elastic data-parallel training worker (one process, one cluster member).

Counterpart of deeplearning4j_tpu/exec/worker.py, with its names, flags,
exit codes, log lines and environment, plus the device:

    python -m deeplearning4j_tpu_torch.exec.worker --coordinator URL \\
        --worker-id w0 --port-file /run/w0.port --device cuda

joins the ElasticCoordinator (exec/elastic.py), builds the deterministic
job model on its device (the card unless ``--device cpu``; asked for the
card on a machine without one it exits 5 before it joins), and trains
lockstep data-parallel steps until ``total_steps``:

- **Deterministic shards.** Every worker materializes the SAME global
  batch from ``(seed, step)`` (``synth_batch``, the JAX package's numpy
  byte for byte) and takes its committed-rank slice
  (``parallel.distributed.local_batch_slice``) -- re-sharding after an
  elastic reform is just a different slice of the same bytes.
- **Programs.** ``dp_programs(net)`` gives the two programs every data
  plane shares, each an ``exec.ResidentProgram`` over the network's
  resident tensors, captured as a CUDA graph per signature on the card:
  the gradient program (the container's ``_gradients``; one signature,
  so one graph, per shard row count) writes ``[loss, flat grads]`` into
  one float32 vector, in the JAX package's ``tree_leaves`` order, read
  back once a step into pinned memory; the update program runs the
  container's ``_dp_apply_updates`` over the flat mean vector, which is
  copied into its resident input (``copy_``, never rebound), so
  normalization and clipping see the reduced gradient. For ``charlstm``
  the gradient program launches the LSTM's training forward and backward
  kernels once each.
- **Reduction.** The vector, pre-scaled by the shard's row count, is
  mean-reduced on the host over the pluggable data plane: the
  chunk-pipelined peer-to-peer chain by default (``exec/comms.py``), the
  coordinator's star with ``data_plane="star"``, and with
  ``DL4JTPU_CLUSTER_BACKEND=torch`` (and ``DL4JTPU_TORCH_COORD`` the
  rendezvous ``host:port``) a gloo all-gather of the vectors summed in
  the same rank order. All three are the same float32 arithmetic, so the
  dense planes and ``single_process_reference`` agree bit for bit. No
  thread but the main one touches the card: the heartbeat thread and
  the chain's threads see host numpy only.
- **Elasticity.** A heartbeat thread renews the lease; any fenced RPC or
  rollback directive sends the worker to ``_resync``: restore the anchor
  checkpoint in place (``restore_into``), ack the proposed generation,
  resume at the anchor step under the committed (rank, world).
  Replacements walk the same path from scratch -- join, restore the
  anchor and the recipes of the checkpoint's companion AOT artifact
  (``CLUSTER_AOT restored=n``; a restore skips the cost pass, still
  captures, and must reproduce the recipe's launches), continue -- which
  is why a killed-and-replaced run finishes bit for bit equal to an
  unkilled one.
- **Chaos.** ``resilience.faults.WorkerChaos`` (env
  ``DL4JTPU_WORKER_CHAOS``) injects per-step slowdowns and scripted
  self-SIGKILL.

Exit codes: 0 done, 3 evicted (a replacement took the seat), 4 cluster
full, 5 fatal config/setup error.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import sys
import threading
import time
from typing import Dict, Optional
from urllib.parse import urlparse

import numpy as np
import torch

from deeplearning4j_tpu_torch.exec.comms import (ChainComms,
                                                 CommsAbortedError,
                                                 CommsError,
                                                 record_star_bytes)
from deeplearning4j_tpu_torch.exec.elastic import (ClusterFullError,
                                                   EvictedError, FencedError)
from deeplearning4j_tpu_torch.resilience.errors import TransientError
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call

__all__ = ["CoordClient", "ElasticWorker", "synth_batch", "params_digest",
           "single_process_reference", "main"]

# one bundle-validity envelope for the cluster's train programs (grad is
# shape-specialized per shard-row count, update is shape-stable)
_AOT_PRECISION = "cluster-f32"

_RPC_POLICY = RetryPolicy(max_attempts=6, base_delay=0.05, max_delay=1.0)
# the allreduce blocks server-side until the barrier fills; retries are
# idempotent (the coordinator caches reduced steps), so ride out stragglers
# with an overall deadline instead of an attempt cap
_REDUCE_POLICY = RetryPolicy(max_attempts=None, base_delay=0.1,
                             max_delay=1.0, deadline=240.0)


def synth_batch(model: str, seed: int, step: int, n: int):
    """The deterministic GLOBAL batch for ``step`` -- a pure function of
    ``(model, seed, step)`` so every member (including a replacement that
    joined five generations later) slices identical bytes."""
    rng = np.random.default_rng([int(seed), int(step), 0xE1A])
    if model in ("mlp", "widemlp"):
        x = rng.standard_normal((n, 4)).astype(np.float32)
        labels = rng.integers(0, 3, size=n)
        y = np.zeros((n, 3), np.float32)
        y[np.arange(n), labels] = 1.0
        return x, y
    if model == "charlstm":
        from deeplearning4j_tpu_torch.serving.replica import CHAR_VOCAB
        T = 16
        toks = rng.integers(0, CHAR_VOCAB, (n, T + 1))
        x = np.zeros((n, T, CHAR_VOCAB), np.float32)
        y = np.zeros((n, T, CHAR_VOCAB), np.float32)
        ar = np.arange(T)
        for i in range(n):   # next-token prediction on synthetic streams
            x[i, ar, toks[i, :-1]] = 1.0
            y[i, ar, toks[i, 1:]] = 1.0
        return x, y
    raise ValueError(f"no synthetic batch source for model {model!r} "
                     "(elastic cluster jobs: mlp | widemlp | charlstm)")


def _tree_leaves(tree) -> list:
    """The JAX package's ``tree_leaves`` order: lists and tuples in order,
    dicts by sorted key."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    return [tree]


def params_digest(params) -> str:
    """Order-stable hash of every parameter leaf's bytes (tensors read
    back from their device) -- the bitwise fit-parity witness compared
    across killed and unkilled runs."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in _tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.detach().cpu().contiguous().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
        else:
            h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()


# --------------------------------------------------------------------------
# the two programs
# --------------------------------------------------------------------------

def _leaf_order(params) -> list:
    """(member, name) of every parameter in ``tree_leaves`` order."""
    members = (sorted(params) if isinstance(params, dict)
               else range(len(params)))
    return [(m, k) for m in members for k in sorted(params[m])]


def _copy_tree(dst, src) -> None:
    for d, s in zip(_tree_leaves(dst), _tree_leaves(src)):
        d.copy_(s)


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _clone_tree(t) for k, t in tree.items()}
    return tree


class _Pinned:
    """A float32 host buffer for one vector, pinned on a card, with an
    event so a copy out of it (or into it) has run before the host reads
    or refills it."""

    def __init__(self, n: int, device: torch.device):
        card = device.type == "cuda"
        self.tensor = torch.zeros(n, dtype=torch.float32, pin_memory=card)
        self.array = self.tensor.numpy()
        self._event = torch.cuda.Event() if card else None

    def read(self, t: torch.Tensor) -> np.ndarray:
        """``t`` copied back: one copy into pinned memory, one event wait."""
        self.tensor.copy_(t, non_blocking=self._event is not None)
        if self._event is not None:
            self._event.record()
            self._event.synchronize()
        return self.array.copy()

    def stage(self, vec: np.ndarray, dst: torch.Tensor) -> None:
        """``vec`` into ``dst`` in place, through this buffer."""
        if self._event is not None:
            self._event.synchronize()
        np.copyto(self.array, vec)
        dst.copy_(self.tensor, non_blocking=self._event is not None)
        if self._event is not None:
            self._event.record()


# the programs' caller in the program registry (and the AOT restores'
# ``engine`` label)
_CALLER = "cluster"


class GradProgram:
    """``vec, new_state = grad(x, y, rng)``: the loss and gradients of the
    rows ``(x, y)`` (host arrays) at the network's resident parameters, as
    one host float32 vector ``[loss, flat grads]`` in ``tree_leaves``
    order, and the new layer state (a resident tree the program writes,
    from the network's state it reads). ``rng``: the step's seed
    (``exec.executor.step_seed``) for a network that draws."""

    def __init__(self, net):
        from deeplearning4j_tpu_torch.exec.executor import ResidentProgram
        self.net = net
        self.order = _leaf_order(net.params)
        self.new_state = _clone_tree(net.state)
        self.n = 1 + sum(net.params[m][k].numel() for m, k in self.order)
        # a CUDA generator is registered with no resident program's
        # graph: a network that draws runs its gradient program eagerly
        self.program = ResidentProgram(
            net._executor, self._fn, "cluster:grad",
            capture=net._gen is None, caller=_CALLER,
            key_of=lambda staged: f"cluster:grad:b{staged[0].shape[0]}")
        self._out = _Pinned(self.n, net.device)

    def _fn(self, resident, x, y):
        _, state, new_state = resident
        _copy_tree(new_state, state)
        net = self.net
        if isinstance(net.params, dict):
            loss, grads, _ = net._gradients([x], [y], gen=net._gen,
                                            state=new_state)
        else:
            loss, grads, _ = net._gradients(x, y, gen=net._gen,
                                            state=new_state)
        return torch.cat([loss.reshape(1).float()]
                         + [grads[m][k].reshape(-1).float()
                            for m, k in self.order])

    def staged(self, x, y):
        return (torch.from_numpy(np.ascontiguousarray(x, np.float32)),
                torch.from_numpy(np.ascontiguousarray(y, np.float32)))

    def example(self, rows: int, model: str):
        """Staged arrays of ``rows`` rows of ``model``'s batch: what a
        recipe for that row count is expected at."""
        x, y = synth_batch(model, 0, 0, rows)
        return self.staged(x, y)

    def __call__(self, x, y, rng: Optional[int] = None):
        net = self.net
        if net._gen is not None and rng is not None:
            net._gen.manual_seed(int(rng))
        vec = self.program((net.params, net.state, self.new_state),
                           *self.staged(x, y))
        return self._out.read(vec), self.new_state


class UpdateProgram:
    """``upd(flat_mean)``: the container's update (``_dp_apply_updates``:
    normalization, the fused flat update, constraints) over the flat mean
    gradient, in place into the resident parameters and updater state,
    with the fused update's scalars staged before and its counts advanced
    after (``models.fitting.FitContract._run``'s order)."""

    def __init__(self, net, order):
        from deeplearning4j_tpu_torch.exec.executor import ResidentProgram
        self.net = net
        self.order = order
        n = sum(net.params[m][k].numel() for m, k in order)
        self.mean = torch.zeros(n, dtype=torch.float32, device=net.device)
        self._host = _Pinned(n, net.device)
        # the per-member loop (fused update off) rebinds the parameters:
        # it runs eagerly, outside any program
        self.program = None if net._fused is None else ResidentProgram(
            net._executor, self._fn, "cluster:update", caller=_CALLER)

    def _grads(self):
        """The per-member gradients as views of the resident mean."""
        net = self.net
        out = {m: {} for m in (net.params if isinstance(net.params, dict)
                               else range(len(net.params)))}
        off = 0
        for m, k in self.order:
            p = net.params[m][k]
            out[m][k] = self.mean[off:off + p.numel()].view(p.shape) \
                .to(p.dtype)
            off += p.numel()
        return out if isinstance(net.params, dict) else list(out.values())

    def _fn(self, resident):
        self.net._dp_apply_updates(self._grads())

    def __call__(self, flat_mean: np.ndarray) -> None:
        from deeplearning4j_tpu_torch.parallel.wrapper import _resident
        net = self.net
        self._host.stage(np.asarray(flat_mean, np.float32), self.mean)
        if self.program is None:
            net._dp_apply_updates(self._grads())
            return
        opt = net._staged()
        net._fused.stage(opt)
        self.program((_resident(net), self.mean, net._fused.scalars))
        net._fused.advance(opt)


def dp_programs(net):
    """The two programs every data plane shares (``GradProgram``,
    ``UpdateProgram``), registered in the program registry as
    ``("cluster", "cluster:grad:b{rows}")`` and ``("cluster",
    "cluster:update")`` (the AOT recipes' keys). Flatten and unflatten are
    pure layout, so the arithmetic -- and the bitwise parity contract
    between chain, star and the single-process oracle -- is the
    container's own."""
    grad = GradProgram(net)
    return grad, UpdateProgram(net, grad.order)


def single_process_reference(model: str = "mlp", seed: int = 42,
                             total_steps: int = 8, global_batch: int = 32,
                             world: int = 2, *, device="cuda") -> dict:
    """The cluster's exact arithmetic replayed in ONE process on
    ``device``: per-rank shard gradients from the same captured program at
    the same shard shapes, each times ``float32(rows)`` summed in rank
    order on the host, divided by ``float32(total rows)``, one shared
    update. This is the single-process oracle the dense data planes (chain
    AND star) must match BITWISE -- a literal big-batch fit is only
    tolerance-close, because the batch reduction associates floats
    differently than the shard-wise rank-ordered sum."""
    from deeplearning4j_tpu_torch.exec.executor import step_seed
    from deeplearning4j_tpu_torch.parallel.distributed import \
        local_batch_slice
    from deeplearning4j_tpu_torch.serving.replica import build_model
    net = build_model(model, device=device)
    grad, upd = dp_programs(net)
    reduced = None
    for step in range(int(total_steps)):
        x, y = synth_batch(model, seed, step, int(global_batch))
        rng = step_seed(int(seed), step)
        total, rows_sum, new_state = None, 0, None
        for r in range(int(world)):
            sl = local_batch_slice(int(global_batch), rank=r, world=world)
            rows = sl.stop - sl.start
            out, new_state = grad(x[sl], y[sl], rng)
            vec = out * np.float32(rows)
            total = vec.copy() if total is None else total + vec
            rows_sum += rows
        reduced = total / np.float32(rows_sum)
        upd(np.asarray(reduced[1:], np.float32))
        _copy_tree(net.state, new_state)
        net.iteration = step + 1
    return {"params_digest": params_digest(net.params),
            "final_loss": float(reduced[0]) if reduced is not None else None,
            "steps": int(total_steps)}


# --------------------------------------------------------------------------
# coordinator client
# --------------------------------------------------------------------------

# socket-level failures meaning "the keep-alive connection died", not "the
# coordinator answered an error" -- eligible for the in-call reconnect (the
# serving/client.py idiom; IncompleteRead covers a drop mid-response)
_CONN_ERRORS = (http.client.RemoteDisconnected,
                http.client.CannotSendRequest,
                http.client.BadStatusLine,
                http.client.IncompleteRead,
                ConnectionError, BrokenPipeError, OSError)


class CoordClient:
    """HTTP adapter to the ElasticCoordinator: every RPC goes through the
    shared retry primitive (``component="cluster"``), and coordinator
    verdicts come back as the elastic exceptions (409 stale_generation ->
    FencedError, 410 -> EvictedError) so the worker's control flow never
    parses status codes.

    Transport is one persistent keep-alive ``http.client.HTTPConnection``
    per thread (the train loop and the heartbeat thread each own one --
    connections are not thread-safe), the serving/client.py idiom: a
    dropped socket reconnects ONCE within the call before the retry
    policy sees an error."""

    def __init__(self, base_url: str, worker_id: str, timeout: float = 5.0):
        self.base = base_url.rstrip("/")
        parsed = urlparse(self.base)
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 80
        self.worker_id = worker_id
        self.timeout = timeout
        self._local = threading.local()

    # -- transport ---------------------------------------------------------
    def _conn(self, timeout: float) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(self.host, self.port,
                                           timeout=timeout)
            self._local.conn = c
        else:
            c.timeout = timeout
            if c.sock is not None:
                c.sock.settimeout(timeout)
        return c

    def close(self) -> None:
        """Drop this thread's persistent connection; the next RPC redials."""
        c = getattr(self._local, "conn", None)
        if c is not None:
            try:
                c.close()
            except Exception:   # noqa: BLE001 -- already-dead socket
                pass
            self._local.conn = None

    def _roundtrip(self, method: str, path: str, body: Optional[bytes],
                   headers: Dict[str, str], timeout: float):
        # attempt 0 may find a keep-alive socket the coordinator already
        # reaped; reconnect once within the call -- a second failure is a
        # real connection problem for the retry policy
        for attempt in (0, 1):
            conn = self._conn(timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except TimeoutError:
                self.close()
                raise
            except _CONN_ERRORS as e:
                self.close()
                if attempt:
                    # surface as retryable: the classifier treats a bare
                    # OSError as fatal, but a dead coordinator socket is
                    # exactly what the retry budget exists for
                    raise TransientError(
                        f"coordinator connection failed: {e!r}") from e

    def _raise_mapped(self, status: int, data: bytes):
        try:
            doc = json.loads(data.decode() or "{}")
        except Exception:   # noqa: BLE001 -- unparseable body
            doc = {}
        kind = doc.get("error")
        msg = doc.get("message", f"HTTP {status}")
        if kind == "stale_generation":
            raise FencedError(msg, proposal=doc.get("proposal"),
                              anchor=doc.get("anchor"))
        if kind == "evicted":
            raise EvictedError(msg)
        if kind == "cluster_full":
            raise ClusterFullError(msg)
        if kind == "barrier_timeout":
            raise TransientError(msg)
        if status in (429, 502, 503, 504):
            raise TransientError(msg)
        raise RuntimeError(f"coordinator HTTP {status}: {msg}")

    def _post_once(self, path: str, body: bytes, headers: Dict[str, str],
                   timeout: float) -> bytes:
        status, data = self._roundtrip("POST", path, body, headers, timeout)
        if status >= 400:
            self._raise_mapped(status, data)
        return data

    def _rpc(self, path: str, doc: dict, *, policy=_RPC_POLICY,
             timeout: Optional[float] = None) -> dict:
        body = json.dumps(doc).encode()
        out = retry_call(self._post_once, path, body,
                         {"Content-Type": "application/json"},
                         timeout or self.timeout,
                         policy=policy, component="cluster")
        return json.loads(out or b"{}")

    # -- RPCs --------------------------------------------------------------
    def join(self, data_port: int = 0) -> dict:
        return self._rpc("/join", {"worker_id": self.worker_id,
                                   "data_port": int(data_port)})

    def sync(self, generation: int) -> dict:
        return self._rpc("/sync", {"worker_id": self.worker_id,
                                   "generation": int(generation)})

    def heartbeat(self, generation: int, step: int) -> dict:
        return self._rpc("/heartbeat", {"worker_id": self.worker_id,
                                        "generation": int(generation),
                                        "step": int(step)})

    def anchor(self, generation: int, step: int,
               path: Optional[str]) -> dict:
        return self._rpc("/anchor", {"worker_id": self.worker_id,
                                     "generation": int(generation),
                                     "step": int(step), "path": path})

    def result(self, payload: dict) -> None:
        self._rpc("/result", {"worker_id": self.worker_id,
                              "result": payload})

    def leave(self) -> None:
        self._rpc("/leave", {"worker_id": self.worker_id})

    def state(self) -> dict:
        status, data = self._roundtrip("GET", "/state", None, {},
                                       self.timeout)
        if status >= 400:
            self._raise_mapped(status, data)
        return json.loads(data)

    def allreduce(self, generation: int, step: int, rows: int,
                  vec: np.ndarray) -> np.ndarray:
        """Post this member's pre-scaled vector; block until the reduced
        one comes back. Socket timeout > the coordinator's barrier wait so
        the server, not the client, decides a barrier is stuck."""
        headers = {"Content-Type": "application/octet-stream",
                   "X-Worker": self.worker_id,
                   "X-Gen": str(int(generation)),
                   "X-Step": str(int(step)), "X-Rows": str(int(rows))}
        body = np.ascontiguousarray(vec, dtype=np.float32).tobytes()
        out = retry_call(self._post_once, "/allreduce", body, headers, 75.0,
                         policy=_REDUCE_POLICY, component="cluster")
        return np.frombuffer(out, dtype=np.float32)


# --------------------------------------------------------------------------
# worker
# --------------------------------------------------------------------------

class _LeaseBox:
    """What the heartbeat thread learned last, for the train loop to poll
    between steps (lock-guarded; the two threads share nothing else)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.generation = 0
        self.step = 0
        self.directive = "none"
        self.proposal: Optional[int] = None
        self.coord_gen = 0          # coordinator's committed generation
        self.evicted = False        # as stamped on the last heartbeat

    def snapshot(self):
        with self._lock:
            return (self.directive, self.proposal, self.evicted)

    def snapshot_full(self):
        with self._lock:
            return (self.directive, self.proposal, self.coord_gen,
                    self.evicted)

    def set_progress(self, generation: int, step: int):
        with self._lock:
            self.generation, self.step = generation, step

    def absorb(self, resp: dict):
        with self._lock:
            self.directive = resp.get("directive", "none")
            self.proposal = resp.get("proposal")
            self.coord_gen = int(resp.get("generation") or 0)

    def mark_evicted(self):
        with self._lock:
            self.evicted = True


class ElasticWorker:
    """One cluster member's whole lifecycle: join -> sync -> train ->
    result, on ``device`` (the card unless ``"cpu"``; resolved here, so a
    worker asked for a card that is missing raises before it joins).

    The worker is deliberately plain -- everything interesting about
    elasticity lives in how it reacts to FencedError (resync at the
    anchor) and EvictedError (exit; the seat belongs to a replacement
    now).
    """

    def __init__(self, coordinator: str, worker_id: str,
                 port_file: Optional[str] = None, *, device="cuda"):
        from deeplearning4j_tpu_torch.ops import resolve_device
        self.device = resolve_device(device)
        self.client = CoordClient(coordinator, worker_id)
        self.worker_id = worker_id
        self.port_file = port_file
        self.box = _LeaseBox()
        self.cfg: dict = {}
        self.net = None
        self.generation = 0
        self.rank: Optional[int] = None
        self.world = 0
        self.anchor: dict = {"step": 0, "path": None}
        self.step = 0
        self.last_loss: Optional[float] = None
        self.aot_restored = 0
        self.rejoined = False
        self._grad = None           # GradProgram
        self._upd = None            # UpdateProgram
        self._cm = None
        self._stop_hb = threading.Event()
        self._use_torch_collectives = False
        # data plane (exec/comms.py): the listener must exist before join
        # so its port can ride the join RPC; the codec/bucket policy is
        # adopted from the coordinator's config after join
        self.comms: Optional[ChainComms] = ChainComms()
        self._plane = "chain"
        self._comm_seconds = 0.0
        self._step_seconds = 0.0
        self._steps_run = 0
        self._grad_calls = 0            # a torn step's gradients count too
        self._step_ms: list = []        # each step's wall ms, comm ms
        self._comm_ms: list = []
        self._first_step_at: Optional[float] = None
        self._star_sent = 0
        self._star_recv = 0

    # -- logging -----------------------------------------------------------
    def _log(self, msg: str):
        print(f"CLUSTER[{self.worker_id}] {msg}", flush=True)

    # -- heartbeat thread --------------------------------------------------
    def _hb_loop(self):
        interval = float(self.cfg.get("hb_interval", 0.25))
        while not self._stop_hb.wait(interval):
            try:
                resp = self.client.heartbeat(self.generation, self.step)
                self.box.absorb(resp)
            except EvictedError:
                self.box.mark_evicted()
                return
            except Exception:   # noqa: BLE001 -- next beat retries
                pass

    # -- membership --------------------------------------------------------
    def _abort_check(self) -> bool:
        """Should a blocked data-plane wait give up? Yes once the lease
        layer has seen a rollback directive or our own eviction -- the
        membership changed, the current exchange can never complete."""
        directive, proposal, evicted = self.box.snapshot()
        if evicted:
            return True
        return (directive == "rollback"
                and not self._stale_rollback(proposal))

    def _stale_rollback(self, proposal: Optional[int]) -> bool:
        """A heartbeat response computed DURING a reform can land after
        that reform committed and we already resynced -- its rollback
        directive targets a generation we are already in. Acting on it
        would tear down a healthy chain (peers mid-step would see EOF), so
        directives that do not point PAST our committed generation are
        ignored; the next heartbeat clears them."""
        _, _, coord_gen, _ = self.box.snapshot_full()
        return max(proposal or 0, coord_gen) <= self.generation

    def _await_reform(self, why: str) -> Optional[int]:
        """The data plane failed (peer died / chain torn): the coordinator
        is the membership arbiter, so park until the lease detector turns
        the failure into a reform proposal -- or into our own eviction."""
        cfg = self.cfg
        deadline = time.monotonic() + (float(cfg.get("evict_after", 4.0))
                                       + float(cfg.get("replacement_grace",
                                                       8.0)) + 60.0)
        interval = float(cfg.get("hb_interval", 0.25))
        self._log(f"data plane failed ({why}); awaiting reform")
        while time.monotonic() < deadline:
            directive, proposal, coord_gen, evicted = \
                self.box.snapshot_full()
            if evicted:
                raise EvictedError(f"{self.worker_id} evicted while "
                                   "awaiting reform")
            if (directive == "rollback"
                    and not self._stale_rollback(proposal)):
                return proposal
            time.sleep(interval / 2)
        raise CommsError(f"data plane failed ({why}) and no reform "
                         "proposal arrived")

    def _resync(self, proposal: Optional[int]) -> None:
        """Ack ``proposal`` (or whatever supersedes it) until a generation
        commits, then roll back to its anchor, adopt its (rank, world) and
        rebuild the data plane. This is THE recovery path: initial
        formation, post-eviction reform, degraded commit and replacement
        onboarding all land here."""
        target = proposal or self.generation or 1
        interval = float(self.cfg.get("hb_interval", 0.25))
        while True:
            if self.box.snapshot()[2]:
                raise EvictedError(f"{self.worker_id} evicted during sync")
            resp = self.client.sync(target)
            if resp.get("status") != "go":
                target = resp.get("proposal") or target
                time.sleep(interval / 2)
                continue
            reconfigure = (int(resp["generation"]) != self.generation
                           or (self.comms is not None
                               and self.comms.generation
                               != int(resp["generation"])))
            self.generation = int(resp["generation"])
            self.rank = int(resp["rank"])
            self.world = int(resp["world"])
            self.anchor = dict(resp.get("anchor") or
                               {"step": 0, "path": None})
            # rank-tag this process for flight-recorder spills and re-stamp
            # the elastic topology + generation fence
            # (parallel/distributed.py: no group, the topology only)
            os.environ["DL4JTPU_RANK"] = str(self.rank)
            os.environ["DL4JTPU_WORLD"] = str(self.world)
            from deeplearning4j_tpu_torch.parallel import distributed as dist
            dist.initialize(process_id=self.rank, num_processes=self.world,
                            generation=self.generation)
            self._restore_anchor()
            self.step = int(self.anchor.get("step") or 0)
            self.box.set_progress(self.generation, self.step)
            # clear any directive a pre-commit heartbeat left behind; a
            # stale one only costs a harmless replay from the anchor
            # (reduced steps are cached, so replayed contributions read the
            # same vectors)
            self.box.absorb({"directive": "none", "proposal": None,
                             "generation": self.generation})
            self._log(f"generation={self.generation} rank={self.rank} "
                      f"world={self.world} anchor_step={self.step}")
            if self._plane != "chain" or self.comms is None or not reconfigure:
                return
            # rebuild the peer chain from the committed view's endpoints;
            # configure() also resets the threshold codec on a generation
            # change -- a stale pre-reform residual must never survive into
            # the new membership
            eps = {int(r): (hp[0], int(hp[1]))
                   for r, hp in (resp.get("endpoints") or {}).items()}
            try:
                self.comms.configure(self.generation, self.rank, self.world,
                                     eps, should_abort=self._abort_check)
                return
            except CommsAbortedError:
                # another reform started while we formed -- resync to it
                target = self.box.snapshot()[1] or target
                continue
            except CommsError as e:
                # a peer died between commit and chain formation: the lease
                # detector will turn that into the next proposal
                target = self._await_reform(f"chain formation: {e}") or target
                continue

    def _restore_anchor(self) -> None:
        path = self.anchor.get("path")
        if path and os.path.exists(path):
            from deeplearning4j_tpu_torch.util.model_serializer import \
                restore_into
            # in place: the programs' graphs read these tensors by address
            restore_into(self.net, path)
            self._maybe_restore_aot(path)
            return
        # no anchor yet: restart step 0 on the deterministic seed-built
        # model. A survivor rolling back here (eviction before the first
        # checkpoint) has already applied updates, so resetting the step
        # counter alone would replay steps 0..k onto advanced params while
        # a replacement starts from the fresh seed build -- rebuild from
        # seed so every member re-enters step 0 bitwise identical.
        if self.net is not None and self.net.iteration != 0:
            from deeplearning4j_tpu_torch.serving.replica import build_model
            self.net = build_model(self.cfg["model"], device=self.device)
            self._build_programs()
        self.net.iteration = 0

    # -- programs ----------------------------------------------------------
    def _build_programs(self) -> None:
        self._grad, self._upd = dp_programs(self.net)

    def _model_sig(self) -> str:
        from deeplearning4j_tpu_torch.exec.aot import model_signature
        return model_signature(self.net.params, self.net.opt_state)

    def _maybe_restore_aot(self, ckpt_path: str) -> None:
        """A replacement restores the anchored checkpoint's companion AOT
        artifact: each recipe whose signature its programs have not met
        yet is expected there, so that signature's first call is a
        restore (no cost pass; the capture's launches checked against the
        recipe) instead of a trace."""
        if not self.cfg.get("aot", True):
            return
        from deeplearning4j_tpu_torch.exec.aot import (companion_path,
                                                       open_bundle)
        bundle, reason = open_bundle(companion_path(ckpt_path),
                                     self._model_sig(), _AOT_PRECISION,
                                     device=self.device)
        if bundle is None:
            self._log(f"CLUSTER_AOT miss reason={reason}")
            return
        restored = 0
        for key in sorted(bundle.keys()):
            if key == "cluster:update":
                prog, staged = self._upd.program, ()
            elif key.startswith("cluster:grad:b"):
                prog = self._grad.program
                staged = self._grad.example(int(key.rsplit("b", 1)[1]),
                                            self.cfg["model"])
            else:
                continue
            if prog is None or prog.knows(staged):
                continue
            recipe = bundle.recipe(key)
            if recipe is not None:
                prog.expect(staged, recipe)
                restored += 1
        self._log(f"CLUSTER_AOT restored={restored}")

    def _export_aot(self, ckpt_path: str) -> None:
        """Rank 0 rides an AOT artifact alongside every anchor checkpoint:
        the recipe of the gradient program at every shard width it ran and
        of the update program."""
        from deeplearning4j_tpu_torch.exec.aot import (AotBundle,
                                                       companion_path,
                                                       env_fingerprint)
        try:
            bundle = AotBundle(self._model_sig(), _AOT_PRECISION,
                               env=env_fingerprint(self.device))
            for prog in (self._grad.program, self._upd.program):
                if prog is None:
                    continue
                for key, (rec, layout) in prog.recipes().items():
                    bundle.add_recipe(key, rec, layout)
            bundle.save(companion_path(ckpt_path))
        except Exception as e:    # noqa: BLE001 -- AOT is an accelerant,
            self._log(f"CLUSTER_AOT export failed: {e}")  # never a blocker

    # -- collectives -------------------------------------------------------
    def _probe_torch_collectives(self) -> bool:
        """``DL4JTPU_CLUSTER_BACKEND=torch``: form a gloo group over the
        host (rendezvous at ``DL4JTPU_TORCH_COORD``, ``host:port``) and
        verify a cross-process all-gather works; the vectors then go
        through it, summed in rank order on the host. A group cannot
        re-form after a membership change, so any reform drops back to
        the loopback-TCP data plane, as does a failed probe."""
        if os.environ.get("DL4JTPU_CLUSTER_BACKEND") != "torch":
            return False
        addr = os.environ.get("DL4JTPU_TORCH_COORD")
        if not addr:
            return False
        try:
            import torch.distributed as tdist

            from deeplearning4j_tpu_torch.parallel import distributed as dist
            dist.initialize(addr, self.world, self.rank, backend="gloo",
                            device="cpu")
            if tdist.get_world_size() != self.world:
                return False
            probe = [torch.zeros(1) for _ in range(self.world)]
            tdist.all_gather(probe, torch.tensor([float(self.rank)]))
            return [float(p) for p in probe] == [float(r) for r in
                                                  range(self.world)]
        except Exception as e:    # noqa: BLE001 -- documented fallback
            self._log(f"torch collectives unavailable ({e!r}); "
                      "using loopback-TCP allreduce")
            return False

    def _reduce(self, rows: int, vec: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        try:
            if self._use_torch_collectives:
                import torch.distributed as tdist
                t = torch.from_numpy(vec)
                gathered = [torch.empty_like(t) for _ in range(self.world)]
                tdist.all_gather(gathered, t)
                rows_all = [torch.zeros(1) for _ in range(self.world)]
                tdist.all_gather(rows_all, torch.tensor([float(rows)]))
                total = gathered[0].numpy().copy()
                for g in gathered[1:]:      # rank order: bitwise
                    total = total + g.numpy()
                return total / np.float32(sum(int(r) for r in rows_all))
            if self._plane == "chain" and self.comms is not None:
                return self.comms.allreduce(self.step, vec, rows,
                                            should_abort=self._abort_check)
            out = self.client.allreduce(self.generation, self.step, rows,
                                        vec)
            self._star_sent += vec.nbytes
            self._star_recv += out.nbytes
            record_star_bytes(vec.nbytes, out.nbytes)
            return out
        finally:
            self._comm_seconds += time.perf_counter() - t0

    # -- training ----------------------------------------------------------
    def _train_step(self, chaos) -> None:
        from deeplearning4j_tpu_torch.exec.executor import step_seed
        from deeplearning4j_tpu_torch.parallel.distributed import \
            local_batch_slice
        t_step = time.perf_counter()
        net, cfg, step = self.net, self.cfg, self.step
        chaos.on_step(step)
        if self._first_step_at is None:
            self._first_step_at = time.time()
        gb = int(cfg["global_batch"])
        x, y = synth_batch(cfg["model"], cfg["seed"], step, gb)
        sl = local_batch_slice(gb, rank=self.rank, world=self.world)
        rows = sl.stop - sl.start
        rng = step_seed(int(cfg["seed"]), step)
        self._grad_calls += 1
        vec, new_state = self._grad(x[sl], y[sl], rng)
        comm0 = self._comm_seconds
        reduced = self._reduce(rows, vec * np.float32(rows))
        self._comm_ms.append((self._comm_seconds - comm0) * 1e3)
        self.last_loss = float(reduced[0])
        flat_mean = np.asarray(reduced[1:], np.float32)
        if os.environ.get("DL4JTPU_CLUSTER_TRACE"):
            self._log(f"TRACE-IN step={step} "
                      f"p={params_digest(net.params)[:8]} "
                      f"o={params_digest(net.opt_state)[:8]} "
                      f"g={params_digest(flat_mean)[:8]}")
        self._upd(flat_mean)
        _copy_tree(net.state, new_state)
        net.iteration = step + 1
        self.step = step + 1
        self._steps_run += 1
        self.box.set_progress(self.generation, self.step)
        self._step_seconds += time.perf_counter() - t_step
        self._step_ms.append((time.perf_counter() - t_step) * 1e3)
        if os.environ.get("DL4JTPU_CLUSTER_TRACE"):
            rd = hashlib.blake2b(
                np.ascontiguousarray(reduced).tobytes(),
                digest_size=8).hexdigest()
            self._log(f"TRACE step={step} gen={self.generation} "
                      f"rows={rows} loss={self.last_loss!r} "
                      f"reduced={rd} opt={params_digest(net.opt_state)} "
                      f"digest={params_digest(net.params)}")
        self._maybe_checkpoint()

    def _maybe_checkpoint(self) -> None:
        cfg, step = self.cfg, self.step
        every = int(cfg.get("ckpt_every") or 0)
        final = step >= int(cfg["total_steps"])
        if self.rank != 0 or not cfg.get("ckpt_dir"):
            return
        if not final and (not every or step % every != 0):
            return
        if self._cm is None:
            from deeplearning4j_tpu_torch.resilience.checkpoint import \
                CheckpointManager
            self._cm = CheckpointManager(cfg["ckpt_dir"], keep_last=3)
        path = self._cm.save(self.net)
        if cfg.get("aot", True):
            self._export_aot(path)
        self._cm.set_anchor(self.net.iteration)
        self.client.anchor(self.generation, step, path)
        self.anchor = {"step": step, "path": path}
        self._log(f"anchor step={step} path={os.path.basename(path)}")

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> int:
        from deeplearning4j_tpu_torch.resilience.faults import WorkerChaos
        try:
            joined = self.client.join(data_port=self.comms.data_port)
        except ClusterFullError as e:
            self._log(f"join rejected: {e}")
            return 4
        self.cfg = joined["config"]
        self.rejoined = bool(joined.get("proposal", 1) > 1)
        self._plane = str(self.cfg.get("data_plane", "chain"))
        if self._plane == "chain":
            self.comms.set_policy(
                str(self.cfg.get("codec", "dense")),
                float(self.cfg.get("bucket_mb", 4.0)),
                {k: float(self.cfg[k]) for k in
                 ("threshold", "min_threshold", "threshold_step",
                  "capacity_fraction") if k in self.cfg})
        else:
            # star: gradient bytes go through the coordinator; no peer
            # listener needed
            self.comms.close()
            self.comms = None
        if self.port_file:
            tmp = self.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{os.getpid()}\n")
            os.replace(tmp, self.port_file)

        # lease alive BEFORE the expensive part: building the model and
        # loading the kernels can outlast evict_after on a contended host
        # (N workers starting at once), and a worker evicted mid-build
        # never even reaches its first step
        hb = threading.Thread(target=self._hb_loop, name="cluster-hb",
                              daemon=True)
        hb.start()

        from deeplearning4j_tpu_torch.serving.replica import build_model
        self.net = build_model(self.cfg["model"], device=self.device)
        self._build_programs()
        chaos = WorkerChaos.from_env()
        try:
            self._resync(joined.get("proposal"))
            self._use_torch_collectives = self._probe_torch_collectives()
            total = int(self.cfg["total_steps"])
            while self.step < total:
                directive, proposal, evicted = self.box.snapshot()
                if evicted:
                    raise EvictedError(f"{self.worker_id} lease lost")
                if directive == "rollback":
                    if self._stale_rollback(proposal):
                        # late echo of a reform we already synced past --
                        # acting on it would tear down a healthy chain
                        self.box.absorb({"directive": "none",
                                         "proposal": None,
                                         "generation": self.generation})
                        continue
                    self._use_torch_collectives = False
                    self._resync(proposal)
                    continue
                try:
                    self._train_step(chaos)
                except FencedError as e:
                    self._log(f"fenced at step {self.step}: {e}")
                    self._use_torch_collectives = False
                    self._resync(e.proposal)
                except CommsError as e:
                    # the peer chain tore mid-step (a SIGKILLed neighbor,
                    # or our abort on a rollback directive): wait for the
                    # coordinator's verdict, then walk the normal resync
                    proposal = self._await_reform(f"step {self.step}: {e}")
                    self._use_torch_collectives = False
                    self._resync(proposal)
            self._finish()
            return 0
        except EvictedError as e:
            self._log(f"evicted: {e}")
            return 3
        finally:
            self._stop_hb.set()
            if self.comms is not None:
                self.comms.close()

    def _finish(self) -> None:
        from deeplearning4j_tpu_torch import ops
        comms = {"data_plane": self._plane,
                 "torch_collectives": self._use_torch_collectives,
                 "codec": (self.comms.codec if self.comms is not None
                           else "dense"),
                 "comm_seconds": round(self._comm_seconds, 4),
                 "step_seconds": round(self._step_seconds, 4)}
        if self.comms is not None:
            comms["bytes_sent"] = self.comms.bytes_sent
            comms["bytes_recv"] = self.comms.bytes_recv
            comms["compression_ratio"] = self.comms.last.get(
                "compression_ratio", 1.0)
            comms["residual_resets"] = (
                self.comms.codec_state.resets
                if self.comms.codec_state is not None else 0)
        else:
            comms["bytes_sent"] = self._star_sent
            comms["bytes_recv"] = self._star_recv
            comms["compression_ratio"] = 1.0
        programs = [p for p in (self._grad.program, self._upd.program)
                    if p is not None]
        payload = {"worker_id": self.worker_id, "rank": self.rank,
                   "world": self.world, "generation": self.generation,
                   "steps": self.step, "iteration": self.net.iteration,
                   "final_loss": self.last_loss,
                   "params_digest": params_digest(self.net.params),
                   "aot_restored": sum(p.restores for p in programs),
                   "aot_rejected": sum(p.rejected for p in programs),
                   "rejoined": self.rejoined,
                   "comms": comms,
                   # the port's additions: where it ran, what it launched
                   "device": str(self.device),
                   "steps_run": self._steps_run,
                   "grad_calls": self._grad_calls,
                   "step_ms": self._step_ms, "comm_ms": self._comm_ms,
                   "first_step_at": self._first_step_at,
                   "launches": ops.launch_counts()}
        self.client.result(payload)
        self._log(f"done digest={payload['params_digest']} "
                  f"loss={self.last_loss}")
        # hold the lease until every live member reported, so a slightly
        # slower peer is not evicted into a pointless terminal reform
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                if self.client.state().get("phase") == "done":
                    return
            except Exception:   # noqa: BLE001 -- the coordinator left
                return
            time.sleep(0.1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="elastic DP training worker")
    p.add_argument("--coordinator", required=True,
                   help="ElasticCoordinator base URL")
    p.add_argument("--worker-id", required=True)
    p.add_argument("--rank", type=int, default=None,
                   help="informational spawn rank (committed rank is "
                        "assigned by the coordinator at each generation)")
    p.add_argument("--port-file", default=None,
                   help="written with this worker's pid after a "
                        "successful join (the spawn handshake)")
    p.add_argument("--device", default="cuda",
                   help="where the model trains: cuda (default) or cpu; "
                        "cuda without a card exits 5 before joining")
    args = p.parse_args(argv)
    try:
        return ElasticWorker(args.coordinator, args.worker_id,
                             port_file=args.port_file,
                             device=args.device).run()
    except (ClusterFullError,) as e:
        print(f"CLUSTER[{args.worker_id}] fatal: {e}", flush=True)
        return 4
    except Exception as e:      # noqa: BLE001 -- setup/config failures
        import traceback
        traceback.print_exc()
        print(f"CLUSTER[{args.worker_id}] fatal: {e}", flush=True)
        return 5


if __name__ == "__main__":
    sys.exit(main())
