"""Fault tolerance: crash-safe checkpoints, the shared retry primitive and
typed errors (see checkpoint.py, retry.py, errors.py).

``faults`` (fault injection for tests and chaos runs) is not imported
here, as in the JAX package: ``from deeplearning4j_tpu_torch.resilience
import faults`` where failures are injected.
"""

from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError,
    CorruptCheckpointError,
    DeadlineExceededError,
    FatalError,
    InjectedFaultError,
    RetriesExhaustedError,
    RetryBudgetExhaustedError,
    ServerOverloadedError,
    StreamStalledError,
    TransientError,
    WeightSwapError,
)
from deeplearning4j_tpu_torch.resilience.retry import (
    DEFAULT_POLICY,
    RetryPolicy,
    default_classifier,
    retry_call,
    retryable,
)
from deeplearning4j_tpu_torch.resilience.checkpoint import (
    Checkpoint,
    CheckpointListener,
    CheckpointManager,
    latest_checkpoint,
)

__all__ = [
    "BatcherStoppedError",
    "Checkpoint",
    "CheckpointListener",
    "CheckpointManager",
    "CorruptCheckpointError",
    "DEFAULT_POLICY",
    "DeadlineExceededError",
    "FatalError",
    "InjectedFaultError",
    "RetriesExhaustedError",
    "RetryBudgetExhaustedError",
    "RetryPolicy",
    "ServerOverloadedError",
    "StreamStalledError",
    "TransientError",
    "default_classifier",
    "latest_checkpoint",
    "retry_call",
    "retryable",
]
