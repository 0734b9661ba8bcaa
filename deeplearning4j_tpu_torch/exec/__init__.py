"""The execution core: the training-precision policy, captured steps and
programs over resident state (see executor.py), and the program registry
(programs.py)."""

from deeplearning4j_tpu_torch.exec.executor import (  # noqa: F401
    CapturedStep, Executor, HostResult, HostStage, Layout, ResidentProgram,
    StepGraphs, get_executor, set_executor)
from deeplearning4j_tpu_torch.exec.programs import (  # noqa: F401
    ProgramRegistry, get_programs, is_registering)
from deeplearning4j_tpu_torch.exec.aot import (  # noqa: F401
    MISS_REASONS, AotBundle, companion_path, install_kernels,
    model_signature, open_bundle)
