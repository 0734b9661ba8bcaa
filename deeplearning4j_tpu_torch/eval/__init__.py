"""Evaluation metrics."""

from deeplearning4j_tpu_torch.eval.calibration import (  # noqa: F401
    EvaluationCalibration, Histogram, ReliabilityDiagram)
from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ROC, Evaluation, EvaluationBinary, RegressionEvaluation, ROCMultiClass)
