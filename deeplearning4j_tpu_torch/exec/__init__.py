"""The execution core: the training-precision policy, captured steps and
programs over resident state (see executor.py)."""

from deeplearning4j_tpu_torch.exec.executor import (  # noqa: F401
    CapturedStep, Executor, HostResult, HostStage, Layout, ResidentProgram,
    StepGraphs, get_executor, set_executor)
