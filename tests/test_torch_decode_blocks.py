"""A torch model, on the CPU, of how the flash decode kernels K8 and K9
(csrc/flash_decode.cu) split and merge their work on the card, held
against the port's plain versions and the JAX package's Pallas kernels.

On the card each (b, h) pair -- each (b, h, 128-column chunk) past head
dim 128 -- is a thread-block cluster of S blocks. The live keys 0..p (p =
pos[b] clamped to 0..C-1) go to as many of the S blocks as get at least
kmin keys each (a round of the block's lane groups), in contiguous equal
ranges -- for K9 in whole pages; the other blocks get empty ranges. A
block forms its (max, denominator, accumulator) triple over its range
(empty ranges give (-inf, 0, 0)); each block then merges its share of the
chunk's output columns from the S triples in rank order 0..S-1, skipping
empty ones. The model below runs that arithmetic in float32 -- the ranges
from pos, the per-block triples, the rank-order merge and K9's
page-aligned ranges read through the page table -- for S in {1, 2, 16}
and kmin in {1, 16}, at positions 0, bs - 1, bs, C - 1 and past C, and
head dims 8, 32, 136 and 256. Change it whenever the kernel's arithmetic
changes.

Tolerance 1e-5: the same float32 function summed in another order (the
model's block triples against the plain version's one softmax, and against
the Pallas kernels run in interpret mode, as the JAX package's own tests
run them). The JAX kernels read past the cache for a position past C, so
that case is held against the plain versions alone.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.flash_decode import (
    flash_decode_step as jax_decode,
    flash_decode_step_paged as jax_decode_paged)
from deeplearning4j_tpu_torch.ops import decode_cuda

TOL = 1e-5
H, C, BS = 2, 64, 16              # capacity 64 = 4 pages of 16
POS = (0, BS - 1, BS, C - 1, C + 9)
CHUNK = 128                       # head-dim columns a block accumulates


def _cdiv(a, b):
    return -(-a // b)


def block_range(p, rank, S, kmin, bs=None):
    """The kernel's ``block_range``: keys [lo, hi) of block ``rank`` over
    the live keys 0..p, spread over as many of the S blocks as get kmin
    keys each, in whole pages of bs keys for K9."""
    n = p + 1
    unit = bs or 1
    units = _cdiv(n, unit)
    used = min(S, _cdiv(units, _cdiv(kmin, unit)))
    per = _cdiv(units, used) * unit
    lo = min(n, rank * per)
    return lo, min(n, lo + per)


def _triple(q, k, v, scale):
    """One block's (max, denominator, accumulator) over its keys k, v
    (n, Dh); (-inf, 0, 0) for an empty range."""
    if k.shape[0] == 0:
        return (torch.tensor(float("-inf")), torch.tensor(0.0),
                torch.zeros(v.shape[-1]))
    s = (k @ q) * scale
    m = s.max()
    e = torch.exp(s - m)
    return m, e.sum(), e @ v


def _merge(triples):
    """Rank order 0..S-1, a block whose range is empty adding nothing."""
    M = max(m for m, _, _ in triples)
    L, O = torch.tensor(0.0), 0.0
    for m, l, o in triples:
        if l > 0:
            x = torch.exp(m - M)
            L = L + l * x
            O = O + o * x
    return O / L


def model_decode(q, pos, keys, S, kmin, bs=None):
    """K8 (bs None) or K9 as the kernel splits it, with a capacity of C
    keys: ``keys(b, h, lo, hi)`` returns the rows [lo, hi) of k and v of
    stream b, head h."""
    B, Hn, Dh = q.shape
    scale = 1.0 / np.sqrt(Dh)
    out = torch.empty(B, Hn, Dh)
    for b in range(B):
        p = min(max(int(pos[b]), 0), C - 1)
        for h in range(Hn):
            for c0 in range(0, Dh, CHUNK):         # the chunks past Dh 128
                cols = slice(c0, min(Dh, c0 + CHUNK))
                triples = []
                for rank in range(S):
                    lo, hi = block_range(p, rank, S, kmin, bs)
                    k, v = keys(b, h, lo, hi)
                    triples.append(_triple(q[b, h], k, v[:, cols], scale))
                out[b, h, cols] = _merge(triples)
    return out


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _dense_case(Dh):
    B = len(POS)
    return (_rand((B, H, Dh), 1), _rand((B, C, H, Dh), 2),
            _rand((B, C, H, Dh), 3), np.array(POS, np.int32))


def _paged_case(Dh):
    B, MB = len(POS), C // BS
    NB = B * MB + 1
    tables = (np.random.RandomState(4).permutation(NB - 1)[:B * MB] + 1) \
        .reshape(B, MB).astype(np.int32)
    return (_rand((B, H, Dh), 5), _rand((NB, BS, H, Dh), 6),
            _rand((NB, BS, H, Dh), 7), np.array(POS, np.int32), tables)


@functools.lru_cache(maxsize=None)
def _jax_reference(Dh, paged):
    """The Pallas kernel in interpret mode over the streams whose position
    lies in the cache (rows 0..3 of the case)."""
    live = slice(0, len(POS) - 1)
    if paged:
        q, pk, pv, pos, tables = _paged_case(Dh)
        return np.asarray(jax_decode_paged(
            jnp.asarray(q[live]), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(pos[live]), jnp.asarray(tables[live]),
            interpret=True))
    q, kc, vc, pos = _dense_case(Dh)
    return np.asarray(jax_decode(*(jnp.asarray(a[live])
                                   for a in (q, kc, vc, pos)),
                                 interpret=True))


@pytest.mark.parametrize("kmin", [1, 16, 64])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("paged", [False, True])
def test_block_ranges_split_the_live_keys(S, paged, kmin):
    """At every position the ranges of ranks 0..S-1 tile 0..p in order and
    K9's start on page boundaries. Only the first min(S, ceil(units /
    ceil(kmin / unit))) ranks take keys (units: keys, or pages of bs keys
    for K9), at most ceil(units / that) units each; at kmin 1 that is the
    plain equal split over all S blocks."""
    bs = BS if paged else None
    unit = bs or 1
    for p in range(C):
        units = _cdiv(p + 1, unit)
        used = min(S, _cdiv(units, _cdiv(kmin, unit)))
        if kmin == 1:
            assert used == min(S, units)
        end = 0
        for rank in range(S):
            lo, hi = block_range(p, rank, S, kmin, bs)
            assert lo == end and lo <= hi <= p + 1
            end = hi
            assert lo % unit == 0 or lo == hi
            assert hi - lo <= _cdiv(units, used) * unit
            if rank >= used:
                assert lo == hi
        assert end == p + 1


@pytest.mark.parametrize("kmin", [1, 16])
@pytest.mark.parametrize("Dh", [8, 32, 136, 256])
@pytest.mark.parametrize("S", [1, 2, 16])
def test_k8_model_matches_plain_and_pallas(S, Dh, kmin):
    q, kc, vc, pos = _dense_case(Dh)
    tq, tk, tv = map(torch.tensor, (q, kc, vc))

    def keys(b, h, lo, hi):
        return tk[b, lo:hi, h], tv[b, lo:hi, h]
    got = model_decode(tq, pos, keys, S, kmin)
    want = decode_cuda.flash_decode_step_plain(tq, tk, tv, torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(got[:-1].numpy(), _jax_reference(Dh, False),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kmin", [1, 16])
@pytest.mark.parametrize("Dh", [8, 32, 136, 256])
@pytest.mark.parametrize("S", [1, 2, 16])
def test_k9_model_matches_plain_and_pallas(S, Dh, kmin):
    """K9's ranges are whole pages, read through the page table."""
    q, pk, pv, pos, tables = _paged_case(Dh)
    tq, tk, tv = map(torch.tensor, (q, pk, pv))

    def keys(b, h, lo, hi):
        rows = range(lo, hi)
        idx = [(int(tables[b, j // BS]), j % BS) for j in rows]
        k = torch.stack([tk[i, r, h] for i, r in idx]) if idx else \
            torch.zeros(0, Dh)
        v = torch.stack([tv[i, r, h] for i, r in idx]) if idx else \
            torch.zeros(0, Dh)
        return k, v
    got = model_decode(tq, pos, keys, S, kmin, BS)
    want = decode_cuda.flash_decode_step_paged_plain(
        tq, tk, tv, torch.tensor(pos), torch.tensor(tables))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(got[:-1].numpy(), _jax_reference(Dh, True),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("S", [2, 16])
def test_empty_blocks_add_nothing(S):
    """At position 0 every block but rank 0 has an empty range; its triple
    (-inf, 0, 0) must leave the merge at exactly rank 0's result."""
    Dh = 8
    q, kc, vc, _ = _dense_case(Dh)
    tq, tk, tv = map(torch.tensor, (q, kc, vc))
    ranges = [block_range(0, r, S, 1) for r in range(S)]
    assert ranges[0] == (0, 1) and all(lo == hi for lo, hi in ranges[1:])
    triples = [_triple(tq[0, 0], tk[0, lo:hi, 0], tv[0, lo:hi, 0],
                       1.0 / np.sqrt(Dh)) for lo, hi in ranges]
    assert torch.equal(_merge(triples), _merge(triples[:1]))
    np.testing.assert_allclose(_merge(triples).numpy(), vc[0, 0, 0],
                               rtol=0, atol=TOL)
