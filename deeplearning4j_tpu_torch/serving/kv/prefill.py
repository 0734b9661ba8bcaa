"""Chunked prefill planning.

Counterpart of deeplearning4j_tpu/serving/kv/prefill.py. A paged engine
with ``chunk_tokens`` feeds each slot that is still consuming its prompt
up to ``chunk_tokens`` positions a scheduler iteration, in one
``(S, chunk_tokens)`` call beside the slots that decode; rows past a
slot's count are padding whose KV writes land in the scratch block.
"""

from __future__ import annotations

from typing import List, Tuple


def plan_chunks(start: int, end: int, chunk_tokens: int
                ) -> List[Tuple[int, int]]:
    """Prefill positions ``[start, end)`` as ``(start, n)`` chunks of at
    most ``chunk_tokens``: one slot's feed, an iteration a chunk."""
    if chunk_tokens < 1:
        raise ValueError(f"chunk_tokens={chunk_tokens} must be >= 1")
    out = []
    p = int(start)
    while p < end:
        n = min(chunk_tokens, end - p)
        out.append((p, n))
        p += n
    return out


def blocks_for_span(span: int, block_size: int) -> int:
    """Physical blocks needed to hold KV for positions ``[0, span)``."""
    return -(-int(span) // int(block_size))
