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
