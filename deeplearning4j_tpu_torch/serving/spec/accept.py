"""The engine's one sampling rule, and the linear acceptance rule of
speculative decoding.

Counterpart of deeplearning4j_tpu/serving/spec/accept.py. ``oracle_token``
is a pure function of (distribution, request seed, position): the plain
decode step, the speculative verify, the draft and ``generate_naive`` all
call it, so the token a verify accepts at a position is by construction
the token the plain engine emits there. A drafted token is accepted when
it equals the oracle token computed from the target's distribution at
its position; the first mismatch emits the oracle token itself, so a
verify advances a stream by at least one token.

The rule runs on the host, over log-probabilities copied from the card;
the JAX package runs it inside its programs.
"""

from __future__ import annotations

import numpy as np
import torch


def _stream_seed(seed: int, pos: int) -> int:
    """A 32-bit generator seed from (seed, pos): the CPU generator keeps
    only the low 32 bits of its seed, so the pair is mixed (splitmix64)
    before it is folded."""
    x = (((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return (x ^ (x >> 32)) & 0xFFFFFFFF


def oracle_token(logits: np.ndarray, seed: int, pos: int, temp: float,
                 top_k: int) -> int:
    """The engine's sampling rule for ONE distribution row.

    ``logits``: (V,) log-probabilities. Top-k filter, then the argmax when
    ``temp == 0``; otherwise a Gumbel-max draw from ``logits / temp`` with
    noise from a ``torch.Generator`` seeded by (seed, pos). The JAX package
    draws from ``jax.random``, whose bits this package cannot reproduce:
    greedy tokens agree between the packages, sampled ones only in
    distribution."""
    V = logits.shape[-1]
    k = V if top_k <= 0 else min(max(int(top_k), 1), V)
    thr = np.sort(logits)[::-1][k - 1]
    filt = np.where(logits >= thr, logits, -np.inf)
    if temp <= 0:
        return int(np.argmax(filt))
    return int(np.argmax(filt / float(temp) + gumbel_noise(seed, pos, V)))


def gumbel_noise(seed: int, pos: int, V: int) -> np.ndarray:
    """The (V,) float64 Gumbel noise of the draw at (seed, pos)."""
    gen = torch.Generator().manual_seed(_stream_seed(seed, pos))
    u = torch.rand(V, generator=gen, dtype=torch.float64).numpy()
    return -np.log(-np.log(np.clip(u, 1e-300, 1.0 - 1e-16)))


def accept_length(oracle, draft, n_in):
    """Leading-match acceptance over a k-token draft window.

    ``oracle``/``draft``: (..., k) token ids, the target's oracle tokens
    and the draft's proposals for the same positions; ``n_in``: (...,)
    valid draft positions (0 = an inert row). Returns ``(accepted,
    emitted)``: the longest prefix where every drafted token equals its
    oracle token (at most ``n_in``), and ``min(accepted + 1, n_in)``, the
    accepted prefix plus the correction token at the first mismatch."""
    oracle, draft = np.asarray(oracle), np.asarray(draft)
    n_in = np.asarray(n_in)
    k = draft.shape[-1]
    valid = np.arange(k) < n_in[..., None]
    m = ((oracle == draft) & valid).astype(np.int64)
    accepted = np.cumprod(m, axis=-1).sum(axis=-1)
    emitted = np.minimum(accepted + 1, n_in)
    return accepted, emitted
