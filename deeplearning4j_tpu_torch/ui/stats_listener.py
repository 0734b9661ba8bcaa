"""StatsListener -- collects per-iteration training stats into a
StatsStorage.

Counterpart of deeplearning4j_tpu/ui/stats_listener.py (parity: ui-model
stats/BaseStatsListener.java:286): score, timing, batches per second,
memory, per-layer parameter and update summaries, learning rates; an
initial static report carries the model's information (configuration
JSON, parameter counts). With a flight recorder attached
(``model.attach_flight_recorder``) the per-layer statistics are the
recorder's latest ``(L, 5)`` row, computed inside the captured train step
(monitor/flight.py), so no parameter crosses to the host; without one
(or with ``numpy_stats=True``, the parity oracle) every parameter is read
to the host and the update is its difference from the last report's copy,
as in JAX (``map_tree`` where JAX uses ``jax.tree_util.tree_map``). The
step time is read from the registry's ``dl4jtpu_train_step_seconds``
histogram, the series ``/metrics`` scrapes.
"""

from __future__ import annotations

import resource
import time
import uuid
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import host_array
from deeplearning4j_tpu_torch.monitor.metrics import get_registry
from deeplearning4j_tpu_torch.nn.layers.base import map_tree
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.ui.storage import StatsReport


def _stat(a) -> dict:
    a = np.asarray(a, dtype=np.float32)
    return {
        "mean": float(a.mean()), "std": float(a.std()),
        "min": float(a.min()), "max": float(a.max()),
        "norm": float(np.sqrt((a.astype(np.float64) ** 2).sum())),
        "meanmag": float(np.abs(a).mean()),   # the model-page ratio chart
    }                                         # uses mean magnitudes


def _named_groups(model, tree):
    """Yield (display_name, param_dict) per layer -- 'i:Type' for the
    sequential container, the vertex name for graphs."""
    if isinstance(tree, list):                # MultiLayerNetwork
        for i, (layer, p) in enumerate(zip(model.layers, tree)):
            if p:
                yield f"{i}:{type(layer).__name__}", p
    elif isinstance(tree, dict):              # ComputationGraph
        for name, p in tree.items():
            if p:
                yield name, p


def _summary(model, tree) -> dict:
    out = {}
    for gname, p in _named_groups(model, tree):
        for k, leaf in p.items():
            a = np.asarray(leaf)
            if a.size:
                out[f"{gname}/{k}"] = _stat(a)
    return out


class StatsListener(IterationListener):
    """``numpy_stats=True`` forces the full-tree host path even when the
    model has a flight recorder attached -- the parity oracle for tests,
    not a production mode: it reads every parameter to the host and keeps
    a host copy between iterations to compute update deltas. With a
    recorder attached the default path reads the recorder's ``(L, 5)``
    row instead."""

    def __init__(self, storage, frequency: int = 1,
                 session_id: Optional[str] = None,
                 collect_param_stats: bool = True,
                 numpy_stats: bool = False):
        self.storage = storage
        self.frequency = max(1, frequency)
        self.session_id = session_id or f"session_{uuid.uuid4().hex[:10]}"
        self.collect_param_stats = collect_param_stats
        self.numpy_stats = numpy_stats
        self._last_time = None
        self._last_params = None
        self._static_sent = False
        self._last_step = None        # (sum, count) of the step histogram

    def _send_static(self, model):
        if hasattr(model, "layers"):                  # MultiLayerNetwork
            layer_names = [type(l).__name__ for l in model.layers]
        else:                                         # ComputationGraph
            layer_names = [f"{n}:{type(model.conf.nodes[n].layer).__name__}"
                           for n in model.conf.topological_order
                           if model.conf.nodes[n].kind == "layer"]
        info = {
            "model": type(model).__name__,
            "numParams": int(model.num_params()),
            "numLayers": len(layer_names),
            "layers": layer_names,
        }
        try:
            info["configJson"] = model.conf.to_json()
        except Exception:
            pass
        self.storage.put_static_info(self.session_id, info)
        self._static_sent = True

    def _step_time_ms(self):
        """Mean ms/step since the last report, from the registry's
        ``dl4jtpu_train_step_seconds`` histogram; None when the family is
        absent or no step landed in the window."""
        fam = get_registry().get("dl4jtpu_train_step_seconds")
        if fam is None:
            return None
        s = c = 0.0
        for _, child in fam.children():
            s += child.sum
            c += child.count
        prev = self._last_step or (0.0, 0.0)
        self._last_step = (s, c)
        ds, dc = s - prev[0], c - prev[1]
        return (ds / dc) * 1e3 if dc > 0 else None

    def iteration_done(self, model, iteration, epoch):
        if not self._static_sent:
            self._send_static(model)
        if iteration % self.frequency != 0:
            return
        now = time.time()
        dt_ms = self._step_time_ms() or 0.0
        if not dt_ms and self._last_time is not None:
            dt_ms = (now - self._last_time) * 1e3   # wall-clock fallback
        self._last_time = now

        r = StatsReport(session_id=self.session_id, timestamp=now,
                        iteration=iteration, epoch=epoch,
                        score=float(model.get_score()),
                        iteration_time_ms=dt_ms)
        if dt_ms > 0:
            r.batches_per_sec = 1e3 / dt_ms
        r.mem_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

        if self.collect_param_stats and model.params is not None:
            rec = getattr(model, "_flight", None)
            if rec is not None and not self.numpy_stats:
                self._recorder_stats(r, rec)
            else:
                host = map_tree(host_array, model.params)
                r.param_stats = _summary(model, host)
                if self._last_params is not None:
                    delta = map_tree(lambda a, b: a - b, host,
                                     self._last_params)
                    r.update_stats = _summary(model, delta)
                self._last_params = host

        gc = model.conf.global_conf
        upd = getattr(gc, "updater", None)
        if upd is not None and hasattr(upd, "learning_rate"):
            r.learning_rates = {"global": float(upd.learning_rate)}
        self.storage.put_update(r)

    def _recorder_stats(self, r, rec):
        """Per-layer stats from the flight recorder's latest record: the
        norms and the update:param ratio, keyed by the recorder's layer
        names."""
        from deeplearning4j_tpu_torch.monitor.flight import STAT_COLS
        latest = rec.latest()
        if latest is None:
            return
        stats, col = latest["stats"], {c: i for i, c in enumerate(STAT_COLS)}
        mask = rec.detector.param_mask if rec.detector is not None else None
        r.param_stats, r.update_stats = {}, {}
        for i, name in enumerate(rec.layer_names):
            if i >= stats.shape[0] or (mask is not None and not mask[i]):
                continue              # paramless layers keep no chart row
            r.param_stats[name] = {
                "norm": float(stats[i, col["param_norm"]]),
            }
            r.update_stats[name] = {
                "norm": float(stats[i, col["update_norm"]]),
                "grad_norm": float(stats[i, col["grad_norm"]]),
                "ratio": float(stats[i, col["update_ratio"]]),
                "non_finite": float(stats[i, col["non_finite"]]),
            }
