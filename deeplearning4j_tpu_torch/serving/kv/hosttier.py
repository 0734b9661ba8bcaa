"""Host-memory KV tier: evicted prefix blocks spill to host RAM.

Counterpart of deeplearning4j_tpu/serving/kv/hosttier.py. The pool on the
card is small -- ``slots * max_len / kv_block_size + 1`` blocks -- so a
long tail of prompts churns the prefix cache: every eviction throws away a
block whose prefill will be paid again on the chain's next hit. The tier
turns eviction into demotion. When the pool evicts a cached block, the
engine gathers its ``(block_size, H, Dh)`` rows of every pool leaf into
host numpy arrays and parks them here under the block's CHAIN HASH, the
key the prefix cache uses, so an entry commits the whole token prefix
before it. On a later ``PrefixCache.match`` miss the cache takes a second
chance against the tier: a fresh pool block is claimed at once, and the
host-to-card copy waits for the engine's next tick (as a pending
copy-on-write does), so the match never moves data and no new program is
captured.

The tier is an LRU under a byte budget. It holds host memory only, no
card tensors and no refcounts, so dropping an entry is always safe: the
worst case is a cold prefill, what would have happened without the tier.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.monitor.metrics import get_registry


class HostTierEntry:
    """One spilled block: its chain identity and its rows per leaf."""

    __slots__ = ("parent", "tokens", "rows", "nbytes")

    def __init__(self, parent: bytes, tokens: Tuple[int, ...],
                 rows: Dict[str, np.ndarray]):
        self.parent = parent
        self.tokens = tokens
        self.rows = rows
        self.nbytes = int(sum(a.nbytes for a in rows.values()))


class HostKVTier:
    """LRU of spilled prefix blocks under a byte budget, keyed by chain
    hash."""

    def __init__(self, byte_budget: int, engine: str = "kv"):
        if byte_budget < 1:
            raise ValueError(f"byte_budget={byte_budget} must be >= 1")
        self.byte_budget = int(byte_budget)
        self._entries: "OrderedDict[bytes, HostTierEntry]" = OrderedDict()
        self._bytes = 0

        reg = get_registry()
        lab = {"engine": engine}
        self._m_blocks = reg.gauge(
            "dl4jtpu_kv_host_tier_blocks",
            "Prefix blocks currently held in the host-memory KV tier.",
            ("engine",)).labels(**lab)
        self._m_bytes = reg.gauge(
            "dl4jtpu_kv_host_tier_bytes",
            "Host memory held by spilled KV blocks (byte-budgeted LRU).",
            ("engine",)).labels(**lab)
        self._m_spills = reg.counter(
            "dl4jtpu_kv_host_spills_total",
            "Evicted prefix blocks demoted to the host tier instead of "
            "dropped.", ("engine",)).labels(**lab)
        self._m_drops = reg.counter(
            "dl4jtpu_kv_host_drops_total",
            "Host-tier entries discarded for good (LRU under the byte "
            "budget, or oversized spills).", ("engine",)).labels(**lab)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def has(self, chain_hash: bytes) -> bool:
        return chain_hash in self._entries

    def put(self, chain_hash: bytes, parent: bytes,
            tokens: Sequence[int], rows: Dict[str, np.ndarray]) -> bool:
        """Spill one evicted block. Idempotent per chain hash (spilling a
        restored block again refreshes its LRU place; the content is the
        same by construction of the hash). Returns False when the entry
        alone exceeds the whole budget and was dropped."""
        old = self._entries.pop(chain_hash, None)
        if old is not None:
            self._bytes -= old.nbytes
        entry = HostTierEntry(parent, tuple(int(t) for t in tokens),
                              {k: np.ascontiguousarray(a)
                               for k, a in rows.items()})
        if entry.nbytes > self.byte_budget:
            self._m_drops.inc()
            self._gauges()
            return False
        while self._entries and self._bytes + entry.nbytes > self.byte_budget:
            _, lru = self._entries.popitem(last=False)
            self._bytes -= lru.nbytes
            self._m_drops.inc()
        self._entries[chain_hash] = entry
        self._bytes += entry.nbytes
        if old is None:
            self._m_spills.inc()
        self._gauges()
        return True

    def get(self, chain_hash: bytes) -> Optional[HostTierEntry]:
        """LRU-touching lookup. The entry STAYS: a restore does not consume
        it, so a restored block evicted again spills for free; entries
        leave only under the budget or through ``purge``."""
        entry = self._entries.get(chain_hash)
        if entry is not None:
            self._entries.move_to_end(chain_hash)
        return entry

    def purge(self) -> int:
        """Drop everything (a weight swap: spilled KV was computed under
        the old weights). Returns the entries dropped."""
        n = len(self._entries)
        if n:
            self._m_drops.inc(float(n))
        self._entries.clear()
        self._bytes = 0
        self._gauges()
        return n

    def stats(self) -> dict:
        return {"blocks": len(self._entries), "bytes": self._bytes,
                "byte_budget": self.byte_budget,
                "spills": int(self._m_spills.value),
                "drops": int(self._m_drops.value)}

    def _gauges(self) -> None:
        self._m_blocks.set(float(len(self._entries)))
        self._m_bytes.set(float(self._bytes))
