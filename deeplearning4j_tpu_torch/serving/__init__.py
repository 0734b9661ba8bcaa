"""Serving: the bucketed engine, the micro-batcher, the decode engine, the
HTTP server and client, and the replicated tier above them (``router``,
``replica``, ``autoscale``). Counterpart of deeplearning4j_tpu/serving/,
with its ``__all__``."""

from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher  # noqa: F401
from deeplearning4j_tpu_torch.serving.client import InferenceClient  # noqa: F401
from deeplearning4j_tpu_torch.serving.decode import (  # noqa: F401
    DecodeEngine, generate_naive)
from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine, autotune_ladder, bucket_for, bucket_ladder,
    prune_ladder)
from deeplearning4j_tpu_torch.serving.kv import (  # noqa: F401
    BlockPool, HostKVTier, KVMigrateError, PoolExhaustedError, PrefixCache)
from deeplearning4j_tpu_torch.serving.server import InferenceServer  # noqa: F401
from deeplearning4j_tpu_torch.serving.router import (  # noqa: F401
    RetryBudget, Router)
from deeplearning4j_tpu_torch.serving.replica import (  # noqa: F401
    InProcessReplica, ReplicaProcess)
from deeplearning4j_tpu_torch.serving.autoscale import Autoscaler  # noqa: F401

__all__ = [
    "InferenceEngine", "MicroBatcher", "InferenceServer", "InferenceClient",
    "DecodeEngine", "generate_naive", "bucket_ladder", "bucket_for",
    "BlockPool", "PoolExhaustedError", "PrefixCache", "HostKVTier",
    "KVMigrateError",
    "Router", "RetryBudget", "ReplicaProcess", "InProcessReplica",
    "Autoscaler",
]
