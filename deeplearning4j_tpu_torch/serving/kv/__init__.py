"""Paged KV cache for the decode engine (see kv/pool.py)."""

from deeplearning4j_tpu_torch.serving.kv.pool import (  # noqa: F401
    POOL_KEYS, SCRATCH_BLOCK, BlockPool, PoolExhaustedError, blocks_for_span,
    is_pool_path, map_slot_leaves)
