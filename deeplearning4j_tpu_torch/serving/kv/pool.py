"""KV block pool: allocation, refcounts and eviction (the host side of
paged KV).

Counterpart of deeplearning4j_tpu/serving/kv/pool.py, with its
``dl4jtpu_kv_pool_*`` series under the owning engine's label
(``engine=``). The attention layers
keep their KV in ``(num_blocks, block_size, H, Dh)`` pool tensors on the
device (decode state keys ``pk``/``pv``), shared by every slot; each
slot's page table row names the pool blocks that hold its logical blocks.
This module decides which physical block backs which logical block of
which request. Only the engine's scheduler thread allocates and frees, so
the bookkeeping is plain lists. A block is in one of three states:

- free: on the free list, its content garbage;
- referenced: refcount >= 1 (a live slot, or a pending copy-on-write
  source);
- cached: refcount 0, its content a prefix-cache entry (kv/prefix.py),
  on the evictable LRU until a later hit revives it or an allocation
  evicts it.

Block 0 is reserved as the scratch block: inactive slots have all-zero
page-table rows, so their writes land in block 0 and never in a live
request's block; ``alloc`` never hands it out.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional


SCRATCH_BLOCK = 0

# decode-state dict keys that hold pool tensors (shared across slots)
# rather than per-slot state: the engine's per-slot wipe and freeze must
# never touch them; block ownership isolates the slots instead
POOL_KEYS = ("pk", "pv")


def is_pool_path(path, keys=POOL_KEYS) -> bool:
    """True when a path of dict keys / list indices addresses a pool leaf
    (a key in ``keys`` anywhere along it)."""
    return any(isinstance(e, str) and e in keys for e in path)


def map_slot_leaves(fn, tree, *rest, keys=POOL_KEYS, path=()):
    """``fn`` over the per-slot tensor leaves of a decode-state tree (dicts,
    lists and tuples of tensors; None passes through), with matching
    leaves of the ``rest`` trees as extra arguments; leaves under any of
    ``keys`` pass through from ``tree`` untouched."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_slot_leaves(fn, v, *[r[k] for r in rest], keys=keys,
                                   path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_slot_leaves(fn, v, *[r[i] for r in rest], keys=keys,
                            path=path + (i,))
            for i, v in enumerate(tree))
    return tree if is_pool_path(path, keys) else fn(tree, *rest)


def map_pool_leaves(fn, tree, keys=POOL_KEYS, path=()):
    """``fn`` over the pool leaves of a decode-state tree only (the
    engine's copy-on-write); per-slot leaves pass through untouched."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_pool_leaves(fn, v, keys=keys, path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_pool_leaves(fn, v, keys=keys, path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(tree) if is_pool_path(path, keys) else tree


class PoolExhaustedError(Exception):
    """No free or evictable block: admission waits for a release. Carries
    the pool's occupancy when it was raised."""

    def __init__(self, msg: str, need: int = 0, free: int = 0,
                 in_use: int = 0, cached: int = 0):
        super().__init__(msg)
        self.need = int(need)
        self.free = int(free)
        self.in_use = int(in_use)
        self.cached = int(cached)


class BlockPool:
    """Refcounted allocator over ``num_blocks`` physical KV blocks of
    ``block_size`` positions each, block 0 reserved as scratch. ``alloc``
    is all-or-nothing: it evicts least recently cached blocks as needed,
    and raises PoolExhaustedError with no side effect when it cannot
    serve the request."""

    def __init__(self, num_blocks: int, block_size: int,
                 engine: str = "kv"):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks={num_blocks}: need at least 2 (block 0 is the "
                f"reserved scratch block)")
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._ref = [0] * self.num_blocks
        self._ref[SCRATCH_BLOCK] = 1          # pinned forever
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._evictable: "OrderedDict[int, bool]" = OrderedDict()  # LRU
        self._cached = set()                  # blocks holding cache content
        # the prefix cache's hook, called with a block as it is evicted
        self.on_evict: Optional[Callable[[int], None]] = None
        self.high_water = 0
        from deeplearning4j_tpu_torch.monitor.metrics import get_registry
        reg = get_registry()
        lab = {"engine": engine}
        self._m_blocks = reg.gauge(
            "dl4jtpu_kv_pool_blocks",
            "Usable KV blocks in the pool (capacity minus the reserved "
            "scratch block).", ("engine",)).labels(**lab)
        self._m_free = reg.gauge(
            "dl4jtpu_kv_pool_blocks_free",
            "KV blocks allocatable right now (free list plus evictable "
            "prefix-cache blocks).", ("engine",)).labels(**lab)
        self._m_evictions = reg.counter(
            "dl4jtpu_kv_pool_evictions_total",
            "Prefix-cache blocks evicted (LRU) to satisfy an allocation.",
            ("engine",)).labels(**lab)
        self._m_high_water = reg.gauge(
            "dl4jtpu_kv_pool_high_water",
            "Most KV blocks ever simultaneously referenced by live "
            "requests (pressure signal: high_water near usable means the "
            "pool, not the cache, is the bottleneck).",
            ("engine",)).labels(**lab)
        self._m_blocks.set(float(self.usable))
        self._m_free.set(float(self.free_count))

    @property
    def usable(self) -> int:
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        """Blocks allocatable without waiting (free and evictable)."""
        return len(self._free) + len(self._evictable)

    @property
    def in_use(self) -> int:
        """Blocks with a live reference, scratch excluded."""
        return sum(1 for b in range(1, self.num_blocks) if self._ref[b] > 0)

    @property
    def cached_count(self) -> int:
        return len(self._cached)

    def refcount(self, bid: int) -> int:
        return self._ref[bid]

    def is_cached(self, bid: int) -> bool:
        return bid in self._cached

    def alloc(self, n: int) -> List[int]:
        """Claim ``n`` blocks at refcount 1, evicting the least recently
        cached blocks when the free list runs short; or raise
        PoolExhaustedError and claim none."""
        if n > self.free_count:
            raise PoolExhaustedError(
                f"need {n} blocks, {self.free_count} allocatable "
                f"({len(self._free)} free + {len(self._evictable)} "
                f"evictable)", need=n, free=self.free_count,
                in_use=self.in_use, cached=self.cached_count)
        out = []
        for _ in range(n):
            if not self._free:
                self._evict_one()
            bid = self._free.pop()
            self._ref[bid] = 1
            out.append(bid)
        self._m_free.set(float(self.free_count))
        self._note_high_water()
        return out

    def incref(self, bid: int) -> None:
        if bid == SCRATCH_BLOCK:
            raise ValueError("scratch block cannot be claimed")
        if self._ref[bid] == 0:
            # a prefix hit revives a cached (evictable) block
            if bid not in self._evictable:
                raise ValueError(f"block {bid} is free; alloc() it instead")
            del self._evictable[bid]
        self._ref[bid] += 1
        self._m_free.set(float(self.free_count))
        self._note_high_water()

    def decref(self, bid: int) -> None:
        if bid == SCRATCH_BLOCK:
            raise ValueError("scratch block is never released")
        if self._ref[bid] <= 0:
            raise ValueError(f"block {bid} already free")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            if bid in self._cached:
                self._evictable[bid] = True   # the LRU's newest end
            else:
                self._free.append(bid)
        self._m_free.set(float(self.free_count))

    def _note_high_water(self) -> None:
        n = self.in_use
        if n > self.high_water:
            self.high_water = n
            self._m_high_water.set(float(n))

    # ---------------------------------------------------------- prefix cache
    def mark_cached(self, bid: int) -> None:
        """Flag a block's content as a prefix-cache entry: when its last
        reference drops it becomes evictable instead of free."""
        self._cached.add(bid)

    def _evict_one(self) -> None:
        bid, _ = self._evictable.popitem(last=False)   # least recent
        self._cached.discard(bid)
        if self.on_evict is not None:
            self.on_evict(bid)
        self._free.append(bid)
        self._m_evictions.inc()

    def flush_cached(self) -> int:
        """Drop every cache entry no one references; returns the blocks
        freed."""
        n = 0
        while self._evictable:
            self._evict_one()
            n += 1
        self._m_free.set(float(self.free_count))
        return n
