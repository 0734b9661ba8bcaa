"""Synthetic drifting classification stream for the online-learning loop.

Counterpart of deeplearning4j_tpu/online/stream.py, with the same numpy
draws: a task where (a) a model trained on phase 0 measurably degrades on
phase k>0, (b) fine-tuning on phase-k data measurably recovers, and (c)
everything is bit-reproducible across runs and across the two packages.
``DriftingProblem`` labels ``argmax(x @ W(phase))`` with a weight matrix
that slides with the phase index, shaped to match the serving tier's
4-feature / 3-class mlp replica (serving/replica.py build_model("mlp")).
"""

from __future__ import annotations

import numpy as np

__all__ = ["DriftingProblem"]


class DriftingProblem:
    """Deterministic drifting-label generator.

    ``W(phase) = W0 + phase * drift * Wd`` — phase 0 is the base task;
    each later phase rotates the decision boundary by a ``drift``-sized
    step, enough that a stale model's accuracy drops visibly but a few
    fine-tune batches recover it. All draws come from seeded
    ``default_rng`` streams keyed on (seed, phase, batch seed), so two
    processes generating the same coordinates see identical bytes —
    publishers and eval-set builders never have to share state.
    """

    def __init__(self, n_features: int = 4, n_classes: int = 3,
                 drift: float = 0.6, seed: int = 7):
        self.n_features = int(n_features)
        self.n_classes = int(n_classes)
        self.drift = float(drift)
        self.seed = int(seed)
        rng = np.random.default_rng(self.seed)
        self._w0 = rng.normal(size=(self.n_features, self.n_classes))
        self._wd = rng.normal(size=(self.n_features, self.n_classes))

    def weights(self, phase: int) -> np.ndarray:
        return self._w0 + float(phase) * self.drift * self._wd

    def batch(self, n: int, phase: int = 0, seed: int = 0):
        """``n`` examples of phase ``phase``: float32 features, one-hot
        float32 labels. Distinct ``seed`` values give independent batches;
        the same triple always gives identical arrays."""
        rng = np.random.default_rng((self.seed, int(phase), int(seed)))
        x = rng.normal(size=(int(n), self.n_features)).astype(np.float32)
        idx = np.argmax(x @ self.weights(phase), axis=1)
        y = np.zeros((int(n), self.n_classes), dtype=np.float32)
        y[np.arange(int(n)), idx] = 1.0
        return x, y

    # eval sets use a seed band far above any training batch counter so a
    # long soak can never train on its own held-out data
    _EVAL_SEED = 10 ** 6

    def eval_set(self, n: int = 256, phase: int = 0):
        """The held-out set the PromotionGate scores on — fixed per phase,
        disjoint from every training batch by seed construction."""
        return self.batch(n, phase=phase, seed=self._EVAL_SEED)

    def publish(self, publisher, n: int, phase: int = 0,
                seed: int = 0) -> int:
        """Publish ``n`` single-example records of phase ``phase`` through
        an ``NDArrayPublisher`` (the pub/sub pump re-batches on the consumer
        side — data/kafka.py pushes records unbatched). Returns ``n``."""
        x, y = self.batch(n, phase=phase, seed=seed)
        for i in range(x.shape[0]):
            publisher.publish(x[i], y[i])
        publisher.flush()
        return int(n)
