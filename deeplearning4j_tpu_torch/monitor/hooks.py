"""Instrumentation glue between the containers and the registry.

Counterpart of deeplearning4j_tpu/monitor/hooks.py. ``TrainMonitor``
caches one container's metric children (the ``dl4jtpu_train_*``
families), so the per-call record is attribute access and locked float
adds. Both containers hold one lazily; ``record()`` runs once a
``_fit_batch`` and once a ``fit_scan`` call (models/fitting.py).

The score is stored into its gauge as the device scalar: its host read
happens at scrape time, never in the train loop. A "compile event" is a
train call that captured a new CUDA graph; such a call's seconds go to
``dl4jtpu_train_compile_seconds_total`` instead of the step histogram.
"""

from __future__ import annotations

import time

from deeplearning4j_tpu_torch.monitor.metrics import (
    DEFAULT_STEP_BUCKETS, get_registry)

__all__ = ["TrainMonitor"]


class TrainMonitor:
    """Cached metric children for one model container instance."""

    def __init__(self, model_kind: str):
        reg = get_registry()
        lab = {"model": model_kind}
        self.steps = reg.counter(
            "dl4jtpu_train_steps_total",
            "Train steps executed (fit_scan counts every step).",
            ("model",)).labels(**lab)
        self.examples = reg.counter(
            "dl4jtpu_train_examples_total",
            "Examples consumed by train steps (examples/sec via rate()).",
            ("model",)).labels(**lab)
        self.score = reg.gauge(
            "dl4jtpu_train_score",
            "Loss of the most recent train step (device scalar, host-read "
            "lazily at scrape).", ("model",)).labels(**lab)
        self.compile_events = reg.counter(
            "dl4jtpu_train_compile_events_total",
            "Train calls that captured a new CUDA graph.",
            ("model",)).labels(**lab)
        self.compile_seconds = reg.counter(
            "dl4jtpu_train_compile_seconds_total",
            "Wall seconds of train calls that captured a new CUDA graph "
            "(the capture and that call's own step).",
            ("model",)).labels(**lab)
        hist = reg.histogram(
            "dl4jtpu_train_step_seconds",
            "Host seconds per train call (asynchronous on the card: the "
            "dispatch; capturing calls are excluded -- they land in "
            "dl4jtpu_train_compile_seconds_total).",
            ("model", "path"), buckets=DEFAULT_STEP_BUCKETS)
        self._hist = {"batch": hist.labels(model=model_kind, path="batch"),
                      "scan": hist.labels(model=model_kind, path="scan")}

    def record(self, *, seconds: float, steps: int, examples: int,
               score, compiled: int, path: str) -> None:
        """One train call: ``steps`` steps over ``examples`` rows took
        ``seconds`` on the host; ``compiled`` new graphs captured."""
        self.steps.inc(steps)
        self.examples.inc(examples)
        self.score.set(score)
        if compiled:
            self.compile_events.inc(compiled)
            self.compile_seconds.inc(seconds)
        else:
            self._hist[path].observe(seconds)

    def timed(self):
        """Start-of-call timestamp (symmetry helper)."""
        return time.perf_counter()
