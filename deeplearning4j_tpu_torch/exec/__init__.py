"""The execution core: the training-precision policy and captured steps
(see executor.py)."""

from deeplearning4j_tpu_torch.exec.executor import (  # noqa: F401
    CapturedStep, Executor, StepGraphs, get_executor, set_executor)
