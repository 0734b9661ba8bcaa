"""The execution core: the training-precision policy, captured steps and
programs over resident state, the placement rule (``param_spec`` and the
spec vocabulary; see executor.py), the program registry (programs.py) and
the mesh of slots with its ``data`` and ``model`` axes (mesh.py)."""

from deeplearning4j_tpu_torch.exec.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, build_mesh, default_mesh, host_device_env,
    set_default_mesh)

from deeplearning4j_tpu_torch.exec.executor import (  # noqa: F401
    AUX, BATCH, OPT, PARAMS, REPL, SLOTS, STATE, STEP_BATCH, CapturedStep,
    Executor, HostResult, HostStage, Layout, ResidentProgram, StepGraphs,
    get_executor, param_spec, set_executor)
from deeplearning4j_tpu_torch.exec.programs import (  # noqa: F401
    ProgramRegistry, get_programs, is_registering)
from deeplearning4j_tpu_torch.exec.aot import (  # noqa: F401
    MISS_REASONS, AotBundle, companion_path, install_kernels,
    model_signature, open_bundle)
