"""Fault tolerance: typed errors and crash-safe checkpoints (see
checkpoint.py). Retry policies and fault injection are not ported yet."""

from deeplearning4j_tpu_torch.resilience.checkpoint import (  # noqa: F401
    Checkpoint, CheckpointListener, CheckpointManager, latest_checkpoint)
from deeplearning4j_tpu_torch.resilience.errors import (  # noqa: F401
    CorruptCheckpointError, WeightSwapError)
