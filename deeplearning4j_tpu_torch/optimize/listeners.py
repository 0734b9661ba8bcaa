"""Training listeners.

Counterpart of deeplearning4j_tpu/optimize/listeners.py: the listener SPI
(``iteration_done(model, iteration, epoch)``, ``on_epoch_end(model)``),
``ScoreIterationListener``, ``PerformanceListener``,
``CollectScoresIterationListener``, ``EvaluativeListener``,
``TimeIterationListener`` and the ``CheckpointListener`` shim over
``resilience.checkpoint``, with the same log lines (logger
``deeplearning4j_tpu``) and gauge names. The containers call them as the
JAX ones do: once after every ``fit`` batch (a truncated-BPTT batch once)
and once after every ``fit_scan`` chunk, then ``on_epoch_end``.

``model.get_score()`` reads the device (a host sync on the card), so no
listener calls it on a step it does not log: the score and performance
listeners ask for it only when their line is due and the logger would
emit it, and ``CollectScoresIterationListener`` keeps the model's score
tensor and reads it when ``scores`` is read.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

log = logging.getLogger("deeplearning4j_tpu")


class IterationListener:
    """Listener SPI (parity: optimize/api/IterationListener)."""

    def iteration_done(self, model, iteration: int, epoch: int):
        pass

    def on_epoch_end(self, model):
        pass


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations (parity: ScoreIterationListener),
    through the ``deeplearning4j_tpu`` logger only."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, epoch):
        if (iteration % self.print_iterations == 0
                and log.isEnabledFor(logging.INFO)):
            log.info("Score at iteration %d is %s", iteration,
                     model.get_score())


class PerformanceListener(IterationListener):
    """Throughput reporting (parity: PerformanceListener: batches/sec,
    samples/sec over the last report window, the score and the last
    step's host time). ``registry`` (default: the process-wide one)
    receives the ``dl4jtpu_listener_batches_per_sec`` and
    ``dl4jtpu_listener_samples_per_sec`` gauges at each report."""

    def __init__(self, frequency: int = 10, report_batch: bool = True,
                 registry=None):
        self.frequency = max(1, frequency)
        self.report_batch = report_batch
        self._last_time = None
        self._last_iter = None
        if registry is None:
            from deeplearning4j_tpu_torch.monitor.metrics import get_registry
            registry = get_registry()
        self._g_batches = registry.gauge(
            "dl4jtpu_listener_batches_per_sec",
            "Wall-clock batches/sec over the listener's last report window.")
        self._g_samples = registry.gauge(
            "dl4jtpu_listener_samples_per_sec",
            "Wall-clock examples/sec over the listener's last report window.")

    @staticmethod
    def _batch_rows(model):
        x = getattr(model, "_last_input", None)
        if isinstance(x, (list, tuple)):       # ComputationGraph inputs
            x = x[0] if x else None
        try:
            return int(x.shape[0])
        except (AttributeError, IndexError, TypeError):
            return None

    def iteration_done(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            if dt > 0 and iters > 0:
                batch_sec = iters / dt
                self._g_batches.set(batch_sec)
                rows = self._batch_rows(model)
                msg = f"iteration {iteration}: {batch_sec:.1f} batches/sec"
                if rows:
                    self._g_samples.set(batch_sec * rows)
                    msg += f", {batch_sec * rows:.0f} samples/sec"
                if log.isEnabledFor(logging.INFO):
                    msg += f", score {model.get_score():.5f}"
                    fit_t = getattr(model, "_last_fit_time", None)
                    if fit_t:
                        msg += f", last step {fit_t * 1e3:.1f} ms"
                    log.info(msg)
            self._last_time = now
            self._last_iter = iteration
        elif self._last_time is None:
            self._last_time = now
            self._last_iter = iteration


class CollectScoresIterationListener(IterationListener):
    """Accumulate (iteration, score) pairs (parity:
    CollectScoresIterationListener). The model's score is kept as it is
    (a device scalar on the card) and read when ``scores`` is read."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self._scores: List[tuple] = []

    @property
    def scores(self) -> List[tuple]:
        return [(it, float(s)) for it, s in self._scores]

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self._scores.append((iteration, model._score))


class EvaluativeListener(IterationListener):
    """Periodic evaluation on a held-out set (parity: EvaluativeListener),
    every ``frequency`` iterations or, with ``invocation="epoch"``, at
    every epoch's end."""

    def __init__(self, test_data, frequency: int = 100,
                 invocation: str = "iteration"):
        self.test_data = test_data
        self.frequency = max(1, frequency)
        self.invocation = invocation
        self.evaluations: List[tuple] = []

    def _run(self, model, tag):
        ev = model.evaluate(self.test_data)
        self.evaluations.append((tag, ev))
        log.info("Evaluation at %s: accuracy %.4f f1 %.4f",
                 tag, ev.accuracy(), ev.f1())

    def iteration_done(self, model, iteration, epoch):
        if self.invocation == "iteration" and iteration % self.frequency == 0:
            self._run(model, f"iteration {iteration}")

    def on_epoch_end(self, model):
        if self.invocation == "epoch":
            self._run(model, f"epoch {model.epoch}")


class CheckpointListener(IterationListener):
    """Periodic model checkpoints under the parity name: a shim over
    ``resilience.checkpoint.CheckpointListener`` (atomic saves, the
    manifest, rotation to ``keep_last``, ``keep_every`` pins)."""

    def __init__(self, directory: str,
                 every_n_iterations: Optional[int] = None,
                 every_n_epochs: Optional[int] = None, keep_last: int = 3,
                 keep_every: Optional[int] = None):
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            CheckpointListener as _Resilient)
        self._impl = _Resilient(directory,
                                every_n_iterations=every_n_iterations,
                                every_n_epochs=every_n_epochs,
                                keep_last=keep_last, keep_every=keep_every)
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.keep_last = keep_last

    @property
    def manager(self):
        return self._impl.manager

    @property
    def last_saved_path(self):
        return self._impl.last_saved_path

    def iteration_done(self, model, iteration, epoch):
        self._impl.iteration_done(model, iteration, epoch)

    def on_epoch_end(self, model):
        self._impl.on_epoch_end(model)


class TimeIterationListener(IterationListener):
    """Elapsed time and ETA logging (parity: TimeIterationListener)."""

    def __init__(self, total_iterations: int, frequency: int = 50):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self._start = time.perf_counter()

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.perf_counter() - self._start
            rate = iteration / elapsed
            remaining = (self.total - iteration) / rate if rate > 0 else 0
            log.info("iteration %d/%d, elapsed %.0fs, ETA %.0fs",
                     iteration, self.total, elapsed, remaining)
