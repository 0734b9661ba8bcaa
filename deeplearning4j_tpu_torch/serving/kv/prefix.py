"""Prefix cache: finished prompts' full KV blocks, keyed by chains of
token hashes, shared read-only with a copy-on-write at the first block
that diverges.

Counterpart of deeplearning4j_tpu/serving/kv/prefix.py, the same chain
hashes byte for byte (blake2b, 16 bytes, over the parent hash and the
block's token ids), so both packages key one prompt alike. When a request
finishes, each pool block whose positions hold prompt tokens only is
published under the hash of the token chain from position 0 to its end. A
later request walks its own chain block by block and claims every hit
(refcount + 1), skipping its prefill. A block's key commits the whole
prefix before it, so a hit holds exactly the rows this request's own
prefill would write under the same weights.

Where the chain breaks, a cached sibling may still share the first tokens
of the next block: that block is claimed by copy-on-write (the engine
copies it into a fresh block on the device and the request overwrites it
from the first divergent position), so shared content is never written.

With a host tier (``tier=``, kv/hosttier.py) an evicted block is spilled
to host memory instead of lost, and a chain that breaks on the card takes
a second chance there: the engine claims a fresh block for the hit and
copies its rows back before the next program reads it. Single-threaded
like the pool.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.serving.kv.pool import BlockPool

_ROOT = b"kv-prefix-root"


def _chain_hash(parent: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(b"|")
    h.update(b",".join(str(int(t)).encode() for t in tokens))
    return h.digest()


def chain_hashes(tokens: Sequence[int], block_size: int,
                 limit: Optional[int] = None) -> List[str]:
    """Hex chain hashes of the claimable full blocks of ``tokens``:
    ``(len - 1) // block_size`` of them (``match``'s cap), at most
    ``limit``."""
    n = (len(tokens) - 1) // block_size
    if limit is not None:
        n = min(n, limit)
    out: List[str] = []
    h = _ROOT
    for j in range(n):
        h = _chain_hash(h, tokens[j * block_size:(j + 1) * block_size])
        out.append(h.hex())
    return out


class PrefixCache:
    """Hash-chain index over cached pool blocks. ``match`` claims a
    prompt's longest cached chain and its best copy-on-write candidate;
    ``insert`` publishes a finished request's full prompt blocks; the
    pool's eviction calls ``_drop`` so the index never names a recycled
    block, spilling it to the host tier first when one is attached."""

    def __init__(self, pool: BlockPool, tier=None):
        self.pool = pool
        self._by_hash: Dict[bytes, int] = {}        # chain hash -> block
        self._by_bid: Dict[int, bytes] = {}
        # parent hash -> [(block, tokens)]: copy-on-write candidates for
        # the block after a matched chain
        self._children: Dict[bytes, List[Tuple[int, Tuple[int, ...]]]] = {}
        self._child_of: Dict[int, bytes] = {}
        # the host tier and the engine's data movers: spill_fn(hash,
        # parent, tokens, block) gathers an evicted block's rows into the
        # tier; restore_fn(hash, tokens) claims a fresh block for a tier
        # hit (its id, or None when the pool cannot spare one) and queues
        # the copy back onto the card
        self.tier = tier
        self.spill_fn = None
        self.restore_fn = None
        self._spill_enabled = True
        pool.on_evict = self._drop

    def __len__(self) -> int:
        return len(self._by_hash)

    def match(self, prompt: Sequence[int]
              ) -> Tuple[List[int], Optional[Tuple[int, int]], int]:
        """Claim the longest cached chain for ``prompt``. Returns
        ``(shared, cow, skip)``: the claimed blocks covering positions
        ``[0, len(shared) * block_size)``; ``(src, n_match)``, a claimed
        partial candidate for the next block, or None; and the prompt
        positions whose prefill is skipped, at most ``len(prompt) - 1``
        (the last prompt token must run through a step to give the first
        output). A block missing on the card but held by the host tier is
        restored: claimed fresh (refcount 1, the claim this request holds),
        indexed and marked cached."""
        bs = self.pool.block_size
        plen = len(prompt)
        shared: List[int] = []
        h = _ROOT
        for j in range((plen - 1) // bs):
            toks = prompt[j * bs:(j + 1) * bs]
            nxt = _chain_hash(h, toks)
            bid = self._by_hash.get(nxt)
            if bid is None:
                # second chance: the chain may go on in the host tier; on
                # a pool too short for even one block it ends as a miss
                if (self.tier is not None and self.restore_fn is not None
                        and self.tier.has(nxt)):
                    bid = self.restore_fn(nxt, tuple(int(t) for t in toks))
                    if bid is not None:
                        self._index(nxt, bid, toks, h)
                        self.pool.mark_cached(bid)
                        shared.append(bid)
                        h = nxt
                        continue
                break
            self.pool.incref(bid)
            shared.append(bid)
            h = nxt
        skip = len(shared) * bs
        cow: Optional[Tuple[int, int]] = None
        want = prompt[skip:min(plen - 1, skip + bs)]
        if want:
            best = 0
            for bid, toks in self._children.get(h, ()):
                n = 0
                for a, b in zip(want, toks):
                    if a != b:
                        break
                    n += 1
                if n > best:
                    best, cow = n, (bid, n)
            if cow is not None:
                self.pool.incref(cow[0])
        return shared, cow, skip + (cow[1] if cow else 0)

    def insert(self, prompt: Sequence[int], blocks: Sequence[int]) -> int:
        """Publish a finished request's full prompt blocks (block ``j``
        when positions ``[j * bs, (j + 1) * bs)`` are all prompt tokens).
        The first writer wins: a chain already published keeps its block.
        Returns the entries added."""
        bs = self.pool.block_size
        added = 0
        h = _ROOT
        for j in range(len(prompt) // bs):
            toks = prompt[j * bs:(j + 1) * bs]
            nxt = _chain_hash(h, toks)
            if nxt not in self._by_hash and blocks[j] not in self._by_bid:
                self._index(nxt, blocks[j], toks, h)
                self.pool.mark_cached(blocks[j])
                added += 1
            h = nxt
        return added

    def _index(self, chain_hash: bytes, bid: int, tokens: Sequence[int],
               parent: bytes) -> None:
        self._by_hash[chain_hash] = bid
        self._by_bid[bid] = chain_hash
        self._children.setdefault(parent, []).append(
            (bid, tuple(int(t) for t in tokens)))
        self._child_of[bid] = parent

    def chain_heads(self, limit: Optional[int] = 64) -> List[str]:
        """The published chain hashes (hex, newest last), at most
        ``limit``: what a replica advertises for prefix-affinity
        routing."""
        heads = [h.hex() for h in self._by_hash]
        return heads[-limit:] if limit is not None else heads

    def _drop(self, bid: int) -> None:
        """The pool's eviction hook: forget every entry for ``bid``,
        spilling the block to the host tier first when one is attached."""
        h = self._by_bid.pop(bid, None)
        parent = self._child_of.pop(bid, None)
        tok = None
        if parent is not None:
            kids = self._children.get(parent, ())
            tok = next((t for b, t in kids if b == bid), None)
            kids = [(b, t) for b, t in kids if b != bid]
            if kids:
                self._children[parent] = kids
            else:
                self._children.pop(parent, None)
        if h is not None:
            self._by_hash.pop(h, None)
            if (self._spill_enabled and self.tier is not None
                    and self.spill_fn is not None and tok is not None):
                self.spill_fn(h, parent, tok, bid)

    def clear(self) -> int:
        """Drop every entry no one references (a weight swap: cached KV
        was computed under the old weights); returns the blocks freed. The
        host tier is purged and spilling is off during the flush, which
        would otherwise demote the stale blocks into it."""
        if self.tier is not None:
            self.tier.purge()
        self._spill_enabled = False
        try:
            return self.pool.flush_cached()
        finally:
            self._spill_enabled = True
