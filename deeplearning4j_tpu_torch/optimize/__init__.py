"""Training listeners (see listeners.py)."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CheckpointListener, CollectScoresIterationListener, EvaluativeListener,
    IterationListener, PerformanceListener, ScoreIterationListener,
    TimeIterationListener)
