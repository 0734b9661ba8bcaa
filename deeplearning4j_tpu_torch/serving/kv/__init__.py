"""Paged KV cache for the decode engine: the block pool (kv/pool.py), the
prefix cache (kv/prefix.py), chunked-prefill planning (kv/prefill.py), the
migration wire format (kv/migrate.py) and the host tier evicted blocks
spill to (kv/hosttier.py)."""

from deeplearning4j_tpu_torch.serving.kv.hosttier import (  # noqa: F401
    HostKVTier)
from deeplearning4j_tpu_torch.serving.kv.migrate import (  # noqa: F401
    KVMigrateError, pack_chain, unpack_chain)
from deeplearning4j_tpu_torch.serving.kv.pool import (  # noqa: F401
    POOL_KEYS, SCRATCH_BLOCK, BlockPool, PoolExhaustedError, is_pool_path,
    map_pool_leaves, map_slot_leaves)
from deeplearning4j_tpu_torch.serving.kv.prefill import (  # noqa: F401
    blocks_for_span, plan_chunks)
from deeplearning4j_tpu_torch.serving.kv.prefix import (  # noqa: F401
    PrefixCache, chain_hashes)
