"""KV block pool: allocation and refcounts (the host side of paged KV).

Counterpart of deeplearning4j_tpu/serving/kv/pool.py without its prefix
cache and eviction (not ported yet). The attention layers keep their KV in
``(num_blocks, block_size, H, Dh)`` pool tensors on the device (decode
state keys ``pk``/``pv``), shared by every slot; each slot's page table
row names the pool blocks that hold its logical blocks. This module
decides which physical block backs which logical block of which request.
Only the engine's scheduler thread allocates and frees, so the
bookkeeping is plain lists.

Block 0 is reserved as the scratch block: inactive slots have all-zero
page-table rows, so their writes land in block 0 and never in a live
request's block; ``alloc`` never hands it out.
"""

from __future__ import annotations

from typing import List

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


def blocks_for_span(span: int, block_size: int) -> int:
    """Physical blocks needed to hold KV for positions ``[0, span)``."""
    return -(-int(span) // int(block_size))


class PoolExhaustedError(Exception):
    """No free block: admission waits for a release."""


class BlockPool:
    """Refcounted allocator over ``num_blocks`` physical KV blocks of
    ``block_size`` positions each, block 0 reserved as scratch. ``alloc``
    is all-or-nothing."""

    def __init__(self, num_blocks: int, block_size: int):
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
        self.high_water = 0

    @property
    def usable(self) -> int:
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Blocks with a live reference, scratch excluded."""
        return self.usable - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Claim ``n`` blocks at refcount 1, or raise PoolExhaustedError
        and claim none."""
        if n > len(self._free):
            raise PoolExhaustedError(
                f"need {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for bid in out:
            self._ref[bid] = 1
        self.high_water = max(self.high_water, self.in_use)
        return out

    def incref(self, bid: int) -> None:
        if bid == SCRATCH_BLOCK:
            raise ValueError("scratch block cannot be claimed")
        if self._ref[bid] == 0:
            raise ValueError(f"block {bid} is free; alloc() it instead")
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        if bid == SCRATCH_BLOCK:
            raise ValueError("scratch block is never released")
        if self._ref[bid] <= 0:
            raise ValueError(f"block {bid} already free")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
