"""Promotion gate: shadow evaluation of candidates against the incumbent.

Counterpart of deeplearning4j_tpu/online/gate.py. A candidate checkpoint
earns promotion by clearing TWO independent bars:

1. **Held-out quality** -- accuracy on a fixed eval set (``argmax`` of
   the scores on axis 1 against that of the labels) must beat the
   incumbent's by at least ``min_improvement`` (negative values allow
   regressions, useful for bootstrap and for tests that force a bad
   promotion through to exercise rollback). On a recurrent net's
   (batch, time, classes) output axis 1 is the time axis, as in JAX: the
   score then is the share of (row, class) pairs whose most likely step
   matches the labels'.
2. **Shadow agreement** -- replayed over a bounded mirror of recent LIVE
   /predict traffic (``TrafficMirror``, fed by InferenceServer's
   ``request_mirror`` tap), the candidate's argmax decisions may disagree
   with the incumbent's on at most ``max_shadow_disagreement`` of
   examples.

Predict functions may return numpy arrays or tensors (read to the host).
Every decision lands in metrics under the JAX package's names: quality
gauges for both models, the shadow-disagreement gauge, and a
promote/reject counter.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import host_array

__all__ = ["TrafficMirror", "GateDecision", "PromotionGate"]

PredictFn = Callable[[np.ndarray], np.ndarray]


class TrafficMirror:
    """Bounded, thread-safe tap of live request features.

    ``record`` is handed to ``InferenceServer(request_mirror=...)`` and
    runs on the serving request path, so it must be cheap and can never
    raise usefully — it copies the batch into a deque of at most
    ``capacity`` recent batches and drops the oldest beyond that. The gate
    replays a snapshot at decision time.
    """

    def __init__(self, capacity: int = 64):
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.seen = 0

    def record(self, features) -> None:
        arr = np.array(features, copy=True)
        with self._lock:
            self._buf.append(arr)
            self.seen += 1

    def batches(self) -> List[np.ndarray]:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)


@dataclass(frozen=True)
class GateDecision:
    promote: bool
    candidate_quality: float
    incumbent_quality: float
    shadow_disagreement: float   # NaN when no mirrored traffic to replay
    reason: str

    def as_dict(self) -> dict:
        return {"promote": self.promote,
                "candidate_quality": self.candidate_quality,
                "incumbent_quality": self.incumbent_quality,
                "shadow_disagreement": self.shadow_disagreement,
                "reason": self.reason}


class PromotionGate:
    """Decide promote/hold for a candidate model against the incumbent."""

    def __init__(self, eval_x, eval_y, min_improvement: float = 0.0,
                 max_shadow_disagreement: float = 1.0):
        self.set_eval_set(eval_x, eval_y)
        self.min_improvement = float(min_improvement)
        self.max_shadow_disagreement = float(max_shadow_disagreement)
        from deeplearning4j_tpu_torch.monitor import get_registry
        reg = get_registry()
        self._m_quality = reg.gauge(
            "dl4jtpu_online_quality",
            "Held-out eval accuracy at the last gate decision, for the "
            "candidate and the incumbent.", ("model",))
        self._m_disagree = reg.gauge(
            "dl4jtpu_online_shadow_disagreement",
            "Fraction of mirrored live requests where candidate and "
            "incumbent argmax decisions differed at the last gate "
            "decision.")
        self._m_decisions = reg.counter(
            "dl4jtpu_online_gate_decisions_total",
            "Promotion-gate outcomes.", ("decision",))

    def set_eval_set(self, eval_x, eval_y) -> None:
        """Swap the held-out set — drift-aware loops re-point the gate at
        current-phase data so quality is judged on today's distribution."""
        self.eval_x = np.asarray(eval_x)
        self.eval_y = np.asarray(eval_y)
        if self.eval_x.shape[0] != self.eval_y.shape[0]:
            raise ValueError(
                f"eval set mismatch: {self.eval_x.shape[0]} examples vs "
                f"{self.eval_y.shape[0]} labels")

    # -- scoring -----------------------------------------------------------

    def evaluate(self, predict_fn: PredictFn) -> float:
        """Accuracy of ``predict_fn`` (features → class scores) on the
        held-out set."""
        scores = host_array(predict_fn(self.eval_x))
        return float(np.mean(np.argmax(scores, axis=1)
                             == np.argmax(self.eval_y, axis=1)))

    def shadow_disagreement(self, candidate_fn: PredictFn,
                            incumbent_fn: PredictFn,
                            mirror: Optional[TrafficMirror]) -> float:
        """Fraction of mirrored live examples where the two models decide
        differently. NaN when there is nothing to replay (a cold mirror
        never blocks promotion — the eval-set bar still applies)."""
        batches = mirror.batches() if mirror is not None else []
        if not batches:
            return float("nan")
        x = np.concatenate(batches, axis=0)
        cand = np.argmax(host_array(candidate_fn(x)), axis=1)
        inc = np.argmax(host_array(incumbent_fn(x)), axis=1)
        return float(np.mean(cand != inc))

    # -- the decision ------------------------------------------------------

    def decide(self, candidate_fn: PredictFn,
               incumbent_fn: Optional[PredictFn],
               mirror: Optional[TrafficMirror] = None) -> GateDecision:
        """Score both models; promote iff the candidate clears the quality
        bar AND shadow disagreement stays under the ceiling. With no
        incumbent (bootstrap) the candidate wins by default."""
        cq = self.evaluate(candidate_fn)
        self._m_quality.labels(model="candidate").set(cq)
        if incumbent_fn is None:
            self._m_decisions.labels(decision="promote").inc()
            return GateDecision(True, cq, float("nan"), float("nan"),
                                "bootstrap: no incumbent")
        iq = self.evaluate(incumbent_fn)
        self._m_quality.labels(model="incumbent").set(iq)
        dis = self.shadow_disagreement(candidate_fn, incumbent_fn, mirror)
        if not np.isnan(dis):
            self._m_disagree.set(dis)

        if cq < iq + self.min_improvement:
            decision, reason = False, (
                f"quality bar missed: candidate {cq:.4f} < incumbent "
                f"{iq:.4f} + min_improvement {self.min_improvement:+.4f}")
        elif (not np.isnan(dis)) and dis > self.max_shadow_disagreement:
            decision, reason = False, (
                f"shadow disagreement {dis:.4f} over ceiling "
                f"{self.max_shadow_disagreement:.4f} "
                f"({sum(b.shape[0] for b in mirror.batches())} mirrored "
                f"examples)")
        else:
            decision, reason = True, (
                f"candidate {cq:.4f} vs incumbent {iq:.4f}, "
                f"shadow disagreement "
                f"{'n/a' if np.isnan(dis) else format(dis, '.4f')}")
        self._m_decisions.labels(
            decision="promote" if decision else "reject").inc()
        return GateDecision(decision, cq, iq, dis, reason)
