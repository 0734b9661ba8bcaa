"""The engine's one sampling rule, and the linear acceptance rule of
speculative decoding.

Counterpart of deeplearning4j_tpu/serving/spec/accept.py.
``oracle_tokens`` is a pure function of (distribution, request seed,
position): the plain decode step, the speculative verify, the draft and
``generate_naive`` all call it, so the token a verify accepts at a
position is by construction the token the plain engine emits there. A
drafted token is accepted when it equals the oracle token computed from
the target's distribution at its position; the first mismatch emits the
oracle token itself, so a verify advances a stream by at least one token.

The rule is tensor code that runs inside the engine's programs, on the
card: the top-k filter, the argmax (ties to the lowest id), and under a
temperature a Gumbel-max draw whose noise is counter-based -- a 32-bit
integer hash of (seed, position, token id) in int64 tensor arithmetic,
every intermediate masked to 32 bits and every product below 2**63, so a
CPU and a card give the same bits and nothing draws from a
``torch.Generator``. The JAX package draws from ``jax.random``, whose bits
this package does not reproduce: greedy tokens agree between the
packages, sampled ones only in distribution.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31: a product with a 32-bit value stays below
# 2**63 in int64
_MUL1, _MUL2 = 0x7FEB352D, 0x31848BAB
_GOLDEN = 0x9E3779B9


def _mix32(x):
    """A 32-bit finaliser over int64 values in [0, 2**32) (tensors or
    numpy arrays alike)."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 16)


def draw_bits(seed, pos, tok):
    """The 32-bit hash of (seed, position, token id), broadcast over its
    int64 arguments."""
    h = _mix32((seed + _GOLDEN) & _M32)
    h = _mix32(h ^ (pos & _M32))
    return _mix32(h ^ (tok & _M32))


def uniform_from_bits(h):
    """The uniform float32 of a hash: its top 23 bits ``k`` as ``(2 k + 1)
    / 2**24``, exact in float32 and never 0 or 1."""
    return ((h >> 9) * 2 + 1).to(torch.float32) * (2.0 ** -24)


def gumbel(seeds, pos, V):
    """(S, V) float32 Gumbel noise of the draws at (seeds[s], pos[s]) over
    token ids 0..V-1; ``seeds`` and ``pos`` (S,) integer tensors."""
    tok = torch.arange(V, dtype=torch.int64, device=seeds.device)
    u = uniform_from_bits(draw_bits(seeds.long()[:, None] & _M32,
                                    pos.long()[:, None], tok[None, :]))
    return -torch.log(-torch.log(u))


def oracle_tokens(logits, seed, pos, temp, top_k):
    """The sampling rule for S rows (the JAX package's ``vmap`` of
    ``oracle_token``, with its keyword names): ``logits`` (S, V)
    log-probabilities, ``seed`` / ``pos`` / ``top_k`` (S,) integer tensors
    (seeds as their low 32 bits), ``temp`` (S,) float. The top-k filter
    (JAX's threshold: keep every value at least the k-th largest), then
    the argmax of the filtered row, ties to the lowest id, where ``temp ==
    0``, else the argmax of ``filtered / temp`` plus the draw's Gumbel
    noise. Returns (S,) int64."""
    S, V = logits.shape
    logits = logits.float()
    top_k = top_k.long()
    k = torch.where(top_k > 0, top_k.clamp(1, V), V)
    thr = torch.sort(logits, dim=1, descending=True).values.gather(
        1, (k - 1)[:, None])
    filt = torch.where(logits >= thr, logits, float("-inf"))
    greedy = torch.argmax(filt, dim=1)
    temp = temp.float()
    safe_t = torch.where(temp > 0, temp, 1.0)
    sampled = torch.argmax(filt / safe_t[:, None] + gumbel(seed, pos, V),
                           dim=1)
    return torch.where(temp > 0, sampled, greedy)


def oracle_token(logits, seed: int, pos: int, temp: float,
                 top_k: int) -> int:
    """The rule for ONE row: ``logits`` (V,) log-probabilities (numpy or a
    tensor, on any device)."""
    logits = torch.as_tensor(logits)
    dev = logits.device

    def one(v, dt):
        return torch.tensor([v], dtype=dt, device=dev)
    return int(oracle_tokens(logits[None], one(int(seed) & _M32, torch.int64),
                             one(int(pos), torch.int64),
                             one(float(temp), torch.float32),
                             one(int(top_k), torch.int64))[0])


def gumbel_noise(seed: int, pos: int, V: int) -> np.ndarray:
    """The (V,) float32 Gumbel noise of the draw at (seed, pos)."""
    return gumbel(torch.tensor([int(seed) & _M32]), torch.tensor([int(pos)]),
                  V)[0].numpy()


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
