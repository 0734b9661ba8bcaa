"""Early stopping (see early_stopping.py)."""

from deeplearning4j_tpu_torch.earlystopping.early_stopping import (  # noqa: F401
    ClassificationScoreCalculator, DataSetLossCalculator,
    EarlyStoppingConfiguration, EarlyStoppingResult, EarlyStoppingTrainer,
    InMemoryModelSaver, InvalidScoreIterationTerminationCondition,
    LocalFileModelSaver, MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition, MaxTimeTerminationCondition,
    ScoreImprovementEpochTerminationCondition)

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult", "EarlyStoppingTrainer",
    "MaxEpochsTerminationCondition", "MaxTimeTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition",
    "DataSetLossCalculator", "ClassificationScoreCalculator",
    "LocalFileModelSaver", "InMemoryModelSaver",
]
