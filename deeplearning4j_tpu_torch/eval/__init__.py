"""Evaluation metrics."""

from deeplearning4j_tpu_torch.eval.evaluation import Evaluation  # noqa: F401
