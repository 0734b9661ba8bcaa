"""Training flight recorder: per-layer telemetry from inside the captured
train step, and the black box.

Counterpart of deeplearning4j_tpu/monitor/flight.py, with the same
columns, anomaly rules, diagnostics document and spill format (a spill
written here is read by the JAX package's ``FlightRecorder.restore`` and
the reverse). The telemetry is one small ``(L, 5)`` float32 tensor a
sampled step -- per layer the gradient norm, the update norm, the
parameter norm, the update:param mean-magnitude ratio and a non-finite
flag -- computed on the card inside the train step from the parameters
before and after the update and the gradients (``compute_telemetry``).

How the port's step differs from the JAX one:

- The fused update writes the parameters in place, so the sampled step
  copies them first (inside the step, before the update): ``u`` is
  ``f32(new) - f32(old)`` of the rounded values, as in JAX, in bfloat16
  too.
- A CUDA graph cannot branch on ``it % K``. A container with a recorder
  captures a sampled step (with the telemetry) beside its plain one and
  the host picks between them with ``sampled(iteration)``; the plain step
  is the recorder-off graph. A network that trained before the recorder
  was attached captures one graph more per signature, whatever K is.
- A replay's outputs are static buffers the next replay overwrites, so
  ``record`` copies each sampled row into a pinned host slot at once,
  without blocking, behind an event. A read (``latest``, ``records``,
  ``diagnostics``, a spill) waits on the events; recording drains only
  the copies that have run, and waits for the oldest only when 32 are
  pending. No step synchronizes the host.

Host side, the :class:`FlightRecorder` keeps a bounded ring of recent step
records with crash-safe periodic spill (atomic temp+fsync+rename), so a
killed or NaN-diverged run leaves a readable last-N-steps black box naming
the first layer that went non-finite. An :class:`AnomalyDetector` watches
the drained records (grad-norm spike against an EMA, update:param ratio
out of the ``[1e-4, 1e-1]`` band, dead updates) and raises structured
warnings that surface through ``health_info()``, the
``dl4jtpu_train_layer_*`` gauges, ``GET /train/diagnostics`` and the
Perfetto counter tracks of ``monitor/collect.py``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

# Column order of the per-layer telemetry row. ``update_ratio`` is the
# update:param mean-magnitude ratio; ``non_finite`` is 1.0 when any
# gradient or updated parameter of the layer is inf/nan.
STAT_COLS = ("grad_norm", "update_norm", "param_norm", "update_ratio",
             "non_finite")
N_COLS = len(STAT_COLS)

_RATIO_EPS = 1e-12


def rank_tagged_path(path: str) -> str:
    """Tag a spill filename with this process's cluster rank
    (``DL4JTPU_RANK``): ``x.json`` -> ``x.rank2.json``, so the spills of
    several workers in one directory name their worker and do not clobber
    each other. No-op when the variable is unset or the tag is present."""
    rank = os.environ.get("DL4JTPU_RANK", "")
    if not rank:
        return path
    base, ext = os.path.splitext(path)
    if base.endswith(f".rank{rank}"):
        return path
    return f"{base}.rank{rank}{ext}"


def _leaves(tree) -> list:
    """Tensors of a layer's params subtree (a flat path dict, or nested
    dicts and lists), in order."""
    out = []
    if isinstance(tree, dict):
        for v in tree.values():
            out.extend(_leaves(v))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            out.extend(_leaves(v))
    elif tree is not None:
        out.append(tree)
    return out


_LAYOUTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _layout(counts, numels, device):
    """The gather index (L, max leaves; padding points past the last leaf,
    at a zero column) and each layer's ``eps * max(n, 1)`` for layers of
    ``counts`` leaves holding ``numels`` values, on ``device``, made once
    (a host-to-device copy: never inside a captured step, see
    ``prepare_telemetry``)."""
    key = (str(device), tuple(counts), tuple(numels))
    hit = _LAYOUTS.get(key)
    if hit is None:
        n, width = sum(counts), max(max(counts, default=0), 1)
        idx = np.full((len(counts), width), n, np.int64)
        start = 0
        for i, c in enumerate(counts):
            idx[i, :c] = np.arange(start, start + c)
            start += c
        eps_n = np.array([_RATIO_EPS * max(m, 1) for m in numels],
                         np.float32)
        hit = _LAYOUTS[key] = (torch.from_numpy(idx).to(device),
                               torch.from_numpy(eps_n).to(device))
    return hit


def _structure(triples):
    groups = [(_leaves(o), _leaves(nw), _leaves(g)) for o, nw, g in triples]
    counts = [len(nw) for _, nw, _ in groups]
    numels = [sum(t.numel() for t in nw) for _, nw, _ in groups]
    device = next((t.device for _, nw, _ in groups for t in nw),
                  torch.device("cpu"))
    return groups, counts, numels, device


def prepare_telemetry(model, params=None) -> None:
    """Make the telemetry's constants for a container's parameters (or
    ``params``, per-member dicts keyed like them: a tensor-parallel
    form's shard leaves), in its rows' order, on their device: the
    containers call it when a recorder is attached, and before a
    tensor-parallel fit, outside any captured step."""
    p = model.params if params is None else params
    groups = p if isinstance(p, list) else [
        p[n] for n in (_graph_order(model.conf, p)
                       if isinstance(model.params, dict) else sorted(p))]
    _layout(*_structure([(g, g, g) for g in groups])[1:])


def compute_telemetry(triples) -> torch.Tensor:
    """``(L, 5)`` float32 telemetry for a list of per-layer
    ``(old_params, new_params, grads)`` subtree triples, on their device:
    per-leaf norms of all layers in a few multi-tensor launches, then each
    layer's row from its own leaves (a gather, so a non-finite layer
    leaves the others' rows finite); zeros for a paramless layer. Reads no
    host value, so it runs inside a captured step."""
    groups, counts, numels, device = _structure(triples)
    L = len(groups)
    nw = [t.float() for _, leaves, _ in groups for t in leaves]
    if not nw:
        return torch.zeros((L, N_COLS), dtype=torch.float32, device=device)
    od = [t.float() for leaves, _, _ in groups for t in leaves]
    gs = [t.float() for _, _, leaves in groups for t in leaves]
    u = torch._foreach_sub(nw, od)
    inf = float("inf")
    # per leaf: |g|_2 |u|_2 |p|_2 |u|_1 |p|_1 |g|_inf |p|_inf
    per_leaf = torch.stack([torch.stack(torch._foreach_norm(ts, o))
                            for ts, o in ((gs, 2), (u, 2), (nw, 2), (u, 1),
                                          (nw, 1), (gs, inf), (nw, inf))])
    idx, eps_n = _layout(counts, numels, device)
    padded = torch.cat([per_leaf, per_leaf.new_zeros((7, 1))], dim=1)
    per_layer = padded[:, idx]                      # (7, L, max leaves)
    l2 = per_layer[:3].square().sum(-1).sqrt()      # grad, update, param
    l1 = per_layer[3:5].sum(-1)
    # the largest magnitude is finite exactly when every value is
    finite = torch.isfinite(per_layer[5:]).all(-1).all(0)
    ratio = l1[0] / (l1[1] + eps_n)
    return torch.stack([l2[0], l2[1], l2[2], ratio, 1.0 - finite.float()],
                       dim=1)


def step_telemetry(triples, it, sample_every: int) -> torch.Tensor:
    """``compute_telemetry`` at a sampled iteration (``it % K == 0``), a
    zero block elsewhere: the function the JAX step computes with
    ``lax.cond``. The containers pick the sampled or the plain graph on
    the host instead (module docstring)."""
    k = max(int(sample_every), 1)
    if int(it) % k == 0:
        return compute_telemetry(triples)
    device = _structure(triples)[3]
    return torch.zeros((len(triples), N_COLS), dtype=torch.float32,
                       device=device)


def layer_names(model) -> List[str]:
    """Display names for ALL layer groups of a container, index-aligned
    with the telemetry rows (paramless layers keep their slot so row i is
    always layer i). MultiLayerNetwork: ``"{i}:{LayerType}"``;
    ComputationGraph: the layer node's name."""
    if hasattr(model, "layers") and isinstance(
            getattr(model, "params", None), list):
        return [f"{i}:{type(l).__name__}"
                for i, l in enumerate(model.layers)]
    return [str(k) for k in _graph_order(model.conf, model.params)]


def _graph_order(conf, params):
    """A graph's layer nodes in topological order (its parameter dict may
    hold them in another, e.g. sorted after a load)."""
    order = getattr(conf, "layer_nodes", None)
    return list(order()) if order is not None else list(params.keys())


def telemetry_triples(old_params, new_params, grads, conf=None):
    """Per-layer (old, new, grad) subtree triples in the container's
    layer order (list index for MultiLayerNetwork; for ComputationGraph
    the topological order of ``conf``, else the dict's)."""
    if isinstance(new_params, list):
        return [(old_params[i], new_params[i], grads[i])
                for i in range(len(new_params))]
    return [(old_params[k], new_params[k], grads[k])
            for k in _graph_order(conf, new_params)]


def snapshot(params):
    """A copy of a container's parameters (list or dict of per-layer
    dicts): the "old" side of the telemetry, taken inside the sampled step
    before the update writes the parameters in place (one multi-tensor
    multiply by 1, which keeps every value and sign)."""
    groups = params if isinstance(params, list) else list(params.values())
    flat = [v.detach() for p in groups for v in p.values()]
    copies = iter(torch._foreach_mul(flat, 1.0) if flat else [])
    out = [{k: next(copies) for k in p} for p in groups]
    return out if isinstance(params, list) else dict(zip(params, out))


# ---------------------------------------------------------------- detector
class AnomalyDetector:
    """Structured training-anomaly state machine over drained records
    (the JAX package's rules, unchanged).

    Kinds raised (each a dict ``{"kind", "layer", "iteration", "value",
    "detail"}``):

    - ``non_finite``   — the in-trace flag fired for a layer (inf/nan in
      its grads or updated params). Degrades ``health_info()``.
    - ``grad_spike``   — grad-norm > ``spike_factor`` × its per-layer EMA
      (EMA folds in accepted observations only, after ``warmup`` of
      them). Degrades ``health_info()`` while active.
    - ``ratio_high`` / ``ratio_low`` — update:param mean-magnitude ratio
      outside ``ratio_band`` (default ``[1e-4, 1e-1]``). Warning only.
    - ``dead_update``  — zero update-norm for ``dead_steps`` consecutive
      sampled records on a layer that has params. Warning only.

    Anomalies are "active" while raised within the last
    ``active_window`` observed records.
    """

    DEGRADING = ("non_finite", "grad_spike")

    def __init__(self, layer_names: Sequence[str],
                 param_mask: Optional[Sequence[bool]] = None, *,
                 spike_factor: float = 10.0, ema_alpha: float = 0.3,
                 warmup: int = 3, ratio_band: Tuple[float, float] = (1e-4, 1e-1),
                 dead_steps: int = 3, active_window: int = 5,
                 max_anomalies: int = 256):
        self.layer_names = list(layer_names)
        L = len(self.layer_names)
        self.param_mask = (list(param_mask) if param_mask is not None
                           else [True] * L)
        self.spike_factor = float(spike_factor)
        self.ema_alpha = float(ema_alpha)
        self.warmup = int(warmup)
        self.ratio_band = (float(ratio_band[0]), float(ratio_band[1]))
        self.dead_steps = int(dead_steps)
        self.active_window = int(active_window)
        self._ema = [None] * L          # per-layer grad-norm EMA
        self._accepted = [0] * L        # observations folded into the EMA
        self._dead_run = [0] * L        # consecutive zero-update records
        self._observed = 0              # total records observed
        self.anomalies: deque = deque(maxlen=max_anomalies)
        self.first_non_finite: Optional[Dict[str, Any]] = None

    def observe(self, iteration: int, stats: np.ndarray) -> List[Dict]:
        """Feed one drained ``(L, 5)`` record; returns anomalies raised."""
        raised: List[Dict] = []
        self._observed += 1

        def _raise(kind, i, value, detail):
            a = {"kind": kind, "layer": self.layer_names[i],
                 "iteration": int(iteration), "value": float(value),
                 "detail": detail, "_seq": self._observed}
            self.anomalies.append(a)
            raised.append(a)
            log.warning("training anomaly %s layer=%s it=%d value=%g (%s)",
                        kind, a["layer"], iteration, a["value"], detail)

        lo, hi = self.ratio_band
        for i in range(len(self.layer_names)):
            if not self.param_mask[i]:
                continue
            gn, un, pn, ratio, nf = (float(stats[i, c]) for c in range(N_COLS))
            if nf > 0.0 or not all(np.isfinite(v) for v in (gn, un, pn)):
                _raise("non_finite", i, 1.0,
                       "inf/nan in layer grads or updated params")
                if self.first_non_finite is None:
                    self.first_non_finite = {
                        "layer": self.layer_names[i],
                        "iteration": int(iteration)}
                continue
            # grad-norm spike vs EMA (EMA folds in non-spike records only,
            # so one spike doesn't mask the next)
            ema = self._ema[i]
            if (ema is not None and self._accepted[i] >= self.warmup
                    and gn > self.spike_factor * max(ema, _RATIO_EPS)):
                _raise("grad_spike", i, gn,
                       f"grad-norm {gn:.3g} > {self.spike_factor:g}x "
                       f"EMA {ema:.3g}")
            else:
                a = self.ema_alpha
                self._ema[i] = gn if ema is None else (1 - a) * ema + a * gn
                self._accepted[i] += 1
            # dead-update: zero update-norm N sampled records in a row
            if un == 0.0:
                self._dead_run[i] += 1
                if self._dead_run[i] == self.dead_steps:
                    _raise("dead_update", i, 0.0,
                           f"zero update-norm for {self.dead_steps} "
                           "consecutive sampled steps")
            else:
                self._dead_run[i] = 0
                # ratio band only judged on live layers with real updates
                if ratio > hi:
                    _raise("ratio_high", i, ratio,
                           f"update:param ratio {ratio:.3g} > {hi:g}")
                elif ratio < lo:
                    _raise("ratio_low", i, ratio,
                           f"update:param ratio {ratio:.3g} < {lo:g}")
        return raised

    def active(self) -> List[Dict]:
        """Anomalies raised within the last ``active_window`` records."""
        floor = self._observed - self.active_window
        return [dict((k, v) for k, v in a.items() if k != "_seq")
                for a in self.anomalies if a["_seq"] > floor]

    def health_info(self) -> Optional[Dict[str, Any]]:
        """Non-None degraded dict while a degrading anomaly is active (or
        a non-finite was ever seen — that run's params are gone for good).
        Composes with ``InferenceServer``'s ``health_hook`` chain."""
        active = self.active()
        bad = [a for a in active if a["kind"] in self.DEGRADING]
        if self.first_non_finite is not None:
            return {"status": "degraded", "reason": "train_non_finite",
                    "first_non_finite": dict(self.first_non_finite),
                    "active_anomalies": len(active)}
        if bad:
            return {"status": "degraded", "reason": "train_anomaly",
                    "kinds": sorted({a["kind"] for a in bad}),
                    "active_anomalies": len(active)}
        return None


# ---------------------------------------------------------------- recorder
class _Slots:
    """Pinned host slots a sampled row (or a block of rows) is copied into
    behind an event, reused once drained."""

    def __init__(self):
        self._free: Dict[tuple, list] = {}

    def stage(self, stats):
        """A host copy of ``stats`` under way: (host tensor or array,
        event or None). A card tensor is copied into a pinned slot without
        blocking; anything else is copied at once."""
        if isinstance(stats, torch.Tensor) and stats.is_cuda:
            shape = tuple(stats.shape)
            free = self._free.setdefault(shape, [])
            slot = free.pop() if free else torch.empty(
                shape, dtype=torch.float32, pin_memory=True)
            slot.copy_(stats.detach(), non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(stats.device))
            return slot, done
        if isinstance(stats, torch.Tensor):
            return stats.detach().float().cpu().clone(), None
        return np.array(stats, dtype=np.float32), None

    @staticmethod
    def ready(done) -> bool:
        """Whether the copy behind ``done`` has run (no wait)."""
        return done is None or done.query()

    def read(self, host, done) -> np.ndarray:
        """The staged values as numpy (waits for the copy); the slot goes
        back to the pool."""
        if done is None:
            return np.asarray(host, dtype=np.float32)
        done.synchronize()
        arr = host.numpy().copy()
        self._free.setdefault(tuple(host.shape), []).append(host)
        return arr


class FlightRecorder:
    """Bounded ring of recent train-step telemetry records, the black box.

    Attach with ``model.attach_flight_recorder(rec)``: the container runs
    its sampled step at every sampled iteration and hands the ``(L, 5)``
    row to :meth:`record` (``record_scan`` takes a stacked ``(n, L, 5)``
    block). Each row is copied to the host at once without blocking (a
    pinned slot behind an event on the card) and drained LAZILY -- on
    read, on spill, or once a small pending bound is hit -- so the train
    loop never waits on telemetry.

    ``spill_path`` enables the crash-safe black box: every
    ``spill_every`` drained records (and IMMEDIATELY when a layer goes
    non-finite) the ring is written whole via atomic temp+fsync+rename,
    so a kill between spills loses at most ``spill_every`` records and a
    NaN-diverged run always leaves the record naming the first non-finite
    layer. :meth:`restore` reads it back.
    """

    SPILL_VERSION = 1
    _PENDING_BOUND = 8

    def __init__(self, *, capacity: int = 256, sample_every: int = 1,
                 spill_path: Optional[str] = None, spill_every: int = 50,
                 detector: Optional[AnomalyDetector] = None):
        if int(sample_every) < 1:
            raise ValueError("sample_every must be >= 1")
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self.spill_path = spill_path
        self.spill_every = int(spill_every)
        self.layer_names: List[str] = []
        self.detector = detector
        self._ring: deque = deque(maxlen=self.capacity)
        self._pending: deque = deque()
        self._slots = _Slots()
        self._lock = threading.RLock()
        self._since_spill = 0
        self._spills = 0
        self._gauges = None           # lazy metric children, built on bind
        self._m_anom = None
        self._m_spills = None
        self._m_records = None

    # ------------------------------------------------------------- binding
    def bind(self, model) -> "FlightRecorder":
        """Learn the model's layer-group names (index-aligned with the
        telemetry rows) and build the detector and metric children."""
        self.layer_names = layer_names(model)
        groups = (model.params if isinstance(model.params, list)
                  else [model.params[k] for k in self.layer_names])
        mask = [bool(_leaves(p)) for p in groups]
        if self.detector is None:
            self.detector = AnomalyDetector(self.layer_names, mask)
        self._build_metrics()
        return self

    def _build_metrics(self):
        from deeplearning4j_tpu_torch.monitor.metrics import get_registry
        reg = get_registry()
        fams = {
            "grad_norm": reg.gauge(
                "dl4jtpu_train_layer_grad_norm",
                "Per-layer gradient L2 norm from the train step's "
                "telemetry (latest sampled step)", ["layer"]),
            "update_norm": reg.gauge(
                "dl4jtpu_train_layer_update_norm",
                "Per-layer parameter-update L2 norm (latest sampled step)",
                ["layer"]),
            "param_norm": reg.gauge(
                "dl4jtpu_train_layer_param_norm",
                "Per-layer parameter L2 norm after the update "
                "(latest sampled step)", ["layer"]),
            "update_ratio": reg.gauge(
                "dl4jtpu_train_layer_update_ratio",
                "Per-layer update:param mean-magnitude ratio "
                "(latest sampled step)", ["layer"]),
            "non_finite": reg.gauge(
                "dl4jtpu_train_layer_non_finite",
                "1 when the layer's grads or updated params contained "
                "inf/nan at the latest sampled step", ["layer"]),
        }
        self._gauges = {
            col: [fams[col].labels(layer=n) for n in self.layer_names]
            for col in fams}
        self._m_anom = reg.counter(
            "dl4jtpu_train_anomalies_total",
            "Training anomalies raised by the flight recorder's detector",
            ["kind"])
        self._m_spills = reg.counter(
            "dl4jtpu_train_flight_spills_total",
            "Flight-recorder ring spills written (atomic temp+rename)")
        self._m_records = reg.gauge(
            "dl4jtpu_train_flight_records",
            "Telemetry records currently held in the flight-recorder ring")

    # ------------------------------------------------------------ recording
    def sampled(self, iteration: int) -> bool:
        """Whether ``iteration`` is sampled: ``iteration % K == 0``."""
        return int(iteration) % self.sample_every == 0

    def record(self, iteration: int, stats) -> None:
        """Queue one step's ``(L, 5)`` telemetry: copied to the host at
        once, without blocking. Unsampled iterations are ignored."""
        if not self.sampled(iteration):
            return
        with self._lock:
            host, done = self._slots.stage(stats)
            self._pending.append((int(iteration), time.time(), host, done,
                                  None))
            self._drain_some()

    def record_scan(self, it0: int, block) -> None:
        """Queue a block: ``block`` is the stacked ``(n_steps, L, 5)``
        telemetry of iterations ``it0..it0+n-1``, copied whole and sliced
        at drain time."""
        n = int(block.shape[0])
        sampled = [i for i in range(n) if self.sampled(it0 + i)]
        if not sampled:
            return
        with self._lock:
            host, done = self._slots.stage(block)
            self._pending.append((int(it0), time.time(), host, done,
                                  sampled))
            self._drain_some()

    def _drain_some(self) -> None:
        """Past the pending bound, drain the copies that have run; wait for
        the oldest only past four times the bound (the train loop never
        waits on the step it just launched)."""
        if len(self._pending) >= self._PENDING_BOUND:
            self._drain(block=len(self._pending) >= 4 * self._PENDING_BOUND)

    def _drain(self, block: bool = True) -> None:
        """Read the pending copies (with ``block=False`` only those that
        have run), feed the detector, refresh gauges, spill if due. Called
        under the lock."""
        while self._pending:
            if not block and not self._slots.ready(self._pending[0][3]):
                break
            it0, ts, host, done, scan_idx = self._pending.popleft()
            arr = self._slots.read(host, done)
            rows = ([(it0, arr)] if scan_idx is None
                    else [(it0 + i, arr[i]) for i in scan_idx])
            for it, a in rows:
                rec = {"iteration": int(it), "time": float(ts),
                       "stats": a}
                self._ring.append(rec)
                self._since_spill += 1
                raised = (self.detector.observe(it, a)
                          if self.detector is not None else [])
                if self._m_anom is not None:
                    for an in raised:
                        self._m_anom.labels(kind=an["kind"]).inc()
                nonfinite = any(an["kind"] == "non_finite" for an in raised)
                if self.spill_path and (
                        nonfinite
                        or (self.spill_every
                            and self._since_spill >= self.spill_every)):
                    self._spill_locked()
        if self._ring and self._gauges is not None:
            last = self._ring[-1]["stats"]
            L = min(len(self.layer_names), last.shape[0])
            for c, col in enumerate(STAT_COLS):
                for i in range(L):
                    self._gauges[col][i].set(float(last[i, c]))
        if self._m_records is not None:
            self._m_records.set(len(self._ring))

    # --------------------------------------------------------------- reads
    def drain(self) -> None:
        with self._lock:
            self._drain()

    def latest(self) -> Optional[Dict[str, Any]]:
        """Most recent drained record (``{"iteration", "time", "stats"}``
        with ``stats`` a ``(L, 5)`` numpy array) or None."""
        with self._lock:
            self._drain()
            return self._ring[-1] if self._ring else None

    def records(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            self._drain()
            out = list(self._ring)
        return out[-last:] if last else out

    def first_non_finite(self) -> Optional[Dict[str, Any]]:
        """``{"layer", "iteration"}`` of the first layer that went
        non-finite, or None while training is healthy."""
        with self._lock:
            self._drain()
            if self.detector is None:
                return None
            fnf = self.detector.first_non_finite
            return dict(fnf) if fnf else None

    def anomalies(self) -> List[Dict[str, Any]]:
        with self._lock:
            self._drain()
            return self.detector.active() if self.detector else []

    def health_info(self) -> Optional[Dict[str, Any]]:
        """Degraded dict while a degrading anomaly is active; None when
        healthy. Shaped for ``InferenceServer(health_hook=...)``."""
        with self._lock:
            self._drain()
            return (self.detector.health_info()
                    if self.detector is not None else None)

    def diagnostics(self, last: int = 32) -> Dict[str, Any]:
        """The ``GET /train/diagnostics`` document: recent records (layer
        stats keyed by name), active anomalies, first non-finite layer."""
        with self._lock:
            self._drain()
            recs = list(self._ring)[-last:]
            doc = {
                "layers": list(self.layer_names),
                "cols": list(STAT_COLS),
                "sample_every": self.sample_every,
                "capacity": self.capacity,
                "records": [self._rec_doc(r) for r in recs],
                "anomalies": self.detector.active() if self.detector else [],
                "first_non_finite": (dict(self.detector.first_non_finite)
                                     if self.detector is not None
                                     and self.detector.first_non_finite
                                     else None),
                "spills": self._spills,
            }
        return doc

    def _rec_doc(self, rec) -> Dict[str, Any]:
        stats = rec["stats"]
        return {
            "iteration": rec["iteration"], "time": rec["time"],
            "layers": {
                name: {col: _jsonf(stats[i, c])
                       for c, col in enumerate(STAT_COLS)}
                for i, name in enumerate(self.layer_names)
                if i < stats.shape[0]}}

    # --------------------------------------------------------------- spill
    def spill(self, path: Optional[str] = None) -> str:
        """Write the ring (+ anomaly state) to ``path`` (default
        ``spill_path``) via atomic temp+fsync+rename."""
        with self._lock:
            self._drain()
            return self._spill_locked(path)

    def _spill_locked(self, path: Optional[str] = None) -> str:
        path = path or self.spill_path
        if not path:
            raise ValueError("no spill path configured")
        path = rank_tagged_path(path)
        doc = {
            "version": self.SPILL_VERSION,
            "layer_names": list(self.layer_names),
            "cols": list(STAT_COLS),
            "sample_every": self.sample_every,
            "records": [{"iteration": r["iteration"], "time": r["time"],
                         "stats": [[_jsonf(v) for v in row]
                                   for row in np.asarray(r["stats"])]}
                        for r in self._ring],
            "anomalies": [dict((k, v) for k, v in a.items() if k != "_seq")
                          for a in (self.detector.anomalies
                                    if self.detector else [])],
            "first_non_finite": (dict(self.detector.first_non_finite)
                                 if self.detector is not None
                                 and self.detector.first_non_finite
                                 else None),
        }
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
        try:
            with open(tmp, "w") as fh:
                json.dump(doc, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._since_spill = 0
        self._spills += 1
        if self._m_spills is not None:
            self._m_spills.inc()
        return path

    @staticmethod
    def restore(path: str) -> Dict[str, Any]:
        """Read a spilled flight record back (the post-mortem reader).
        Returns the spill document with ``stats`` as numpy arrays."""
        with open(path) as fh:
            doc = json.load(fh)
        for r in doc.get("records", []):
            r["stats"] = np.asarray(r["stats"], dtype=np.float32)
        return doc


def _jsonf(v) -> float:
    """JSON-safe float: inf/nan are not valid JSON numbers; nan is 0 (the
    non_finite column still carries the flag), inf a clamped sentinel."""
    v = float(v)
    if np.isnan(v):
        return 0.0          # the non_finite column still carries the flag
    if np.isinf(v):
        return 1e308 if v > 0 else -1e308
    return v
