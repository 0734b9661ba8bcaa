"""Early stopping.

Counterpart of deeplearning4j_tpu/earlystopping/early_stopping.py:
``EarlyStoppingConfiguration``, the epoch and iteration termination
conditions, the score calculators, the model savers
(``LocalFileModelSaver`` / ``InMemoryModelSaver``) and
``EarlyStoppingTrainer.fit`` (per epoch: train, score, track the best,
save, check the conditions; an ``EarlyStoppingResult``), with the JAX
package's call sequence.

A batch trains through the container's ``_fit_batch``, its captured train
step on the card (for the TextGenerationLSTM recipe net one K4-train and
two K3 a step), and the iteration conditions read ``get_score()`` after
it, a host read of the step's loss, as in JAX. The savers write the
checkpoint zip (util/model_serializer.py); a saved model reads back on the
device of the network it was saved from.
"""

from __future__ import annotations

import io
import math
import pathlib
import time
from dataclasses import dataclass, field
from typing import Any, List

from deeplearning4j_tpu_torch.data.dataset import DataSet

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult", "EarlyStoppingTrainer",
    "MaxEpochsTerminationCondition", "MaxTimeTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition",
    "DataSetLossCalculator", "ClassificationScoreCalculator",
    "LocalFileModelSaver", "InMemoryModelSaver",
]


# ------------------------------------------------------- termination conditions

class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) improvement."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement=0.0):
        self.max_no_improve = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._best = math.inf
        self._since = 0

    def initialize(self):
        self._best = math.inf
        self._since = 0

    def terminate(self, epoch, score):
        if score < self._best - self.min_improvement:
            self._best = score
            self._since = 0
        else:
            self._since += 1
        return self._since >= self.max_no_improve


class MaxTimeTerminationCondition(IterationTerminationCondition,
                                  EpochTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self):
        self._start = time.perf_counter()

    def terminate(self, *args):
        if self._start is None:
            self._start = time.perf_counter()
        return (time.perf_counter() - self._start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if score exceeds a bound (divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score):
        return last_score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score):
        return math.isnan(last_score) or math.isinf(last_score)


# ------------------------------------------------------------ score calculators

class DataSetLossCalculator:
    """Average model loss over a dataset iterator (``score`` of each batch
    weighted by its rows)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for ds in self.iterator:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / n if (self.average and n) else total


class ClassificationScoreCalculator:
    """1 - accuracy (so lower is better, matching the loss convention)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        ev = model.evaluate(self.iterator)
        return 1.0 - ev.accuracy()


# -------------------------------------------------------------------- savers

def _restore(source, device):
    from deeplearning4j_tpu_torch.util.model_serializer import guess_model
    return guess_model(source, device=device)


class InMemoryModelSaver:
    """The best and latest models as checkpoint zips in memory."""

    def __init__(self):
        self._best = None
        self._latest = None
        self._device = None

    @staticmethod
    def _zip(model) -> bytes:
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        buf = io.BytesIO()
        write_model(model, buf)
        return buf.getvalue()

    def save_best_model(self, model, score):
        self._best, self._device = self._zip(model), model.device

    def save_latest_model(self, model, score):
        self._latest, self._device = self._zip(model), model.device

    def get_best_model(self):
        return None if self._best is None else _restore(
            io.BytesIO(self._best), self._device)

    def get_latest_model(self):
        return None if self._latest is None else _restore(
            io.BytesIO(self._latest), self._device)


class LocalFileModelSaver:
    """``bestModel.zip`` and ``latestModel.zip`` in ``directory``; they
    read back on the device of the last network saved (the card before
    any save)."""

    def __init__(self, directory: str):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._device = None

    def save_best_model(self, model, score):
        model.save(str(self.dir / "bestModel.zip"))
        self._device = model.device

    def save_latest_model(self, model, score):
        model.save(str(self.dir / "latestModel.zip"))
        self._device = model.device

    def get_best_model(self):
        p = self.dir / "bestModel.zip"
        return _restore(str(p), self._device) if p.exists() else None

    def get_latest_model(self):
        p = self.dir / "latestModel.zip"
        return _restore(str(p), self._device) if p.exists() else None


# ------------------------------------------------------------- config + result

@dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any = None
    epoch_termination_conditions: List[EpochTerminationCondition] = field(
        default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = \
        field(default_factory=list)
    model_saver: Any = None
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1


@dataclass
class EarlyStoppingResult:
    termination_reason: str = ""
    termination_details: str = ""
    score_vs_epoch: dict = field(default_factory=dict)
    best_model_epoch: int = -1
    best_model_score: float = math.inf
    total_epochs: int = 0
    best_model: Any = None


class EarlyStoppingTrainer:
    """The JAX package's fit loop (module docstring)."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_data):
        self.config = config
        self.model = model
        self.train_data = train_data

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        result = EarlyStoppingResult()
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()

        epoch = 0
        while True:
            if hasattr(self.train_data, "reset"):
                self.train_data.reset()
            aborted = False
            for batch in self.train_data:
                if isinstance(batch, tuple):
                    batch = DataSet(*batch)
                self.model._fit_batch(batch)
                last = self.model.get_score()
                for c in cfg.iteration_termination_conditions:
                    if c.terminate(last):
                        result.termination_reason = "IterationTerminationCondition"
                        result.termination_details = type(c).__name__
                        aborted = True
                        break
                if aborted:
                    break
            if aborted:
                break

            if cfg.score_calculator is not None and \
                    epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
                result.score_vs_epoch[epoch] = score
                if score < result.best_model_score:
                    result.best_model_score = score
                    result.best_model_epoch = epoch
                    if cfg.model_saver is not None:
                        cfg.model_saver.save_best_model(self.model, score)
                if cfg.save_last_model and cfg.model_saver is not None:
                    cfg.model_saver.save_latest_model(self.model, score)
            else:
                score = self.model.get_score()

            stop = False
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, score):
                    result.termination_reason = "EpochTerminationCondition"
                    result.termination_details = type(c).__name__
                    stop = True
                    break
            epoch += 1
            if stop:
                break

        result.total_epochs = epoch
        if cfg.model_saver is not None:
            result.best_model = cfg.model_saver.get_best_model()
        if result.best_model is None:
            result.best_model = self.model
        return result
