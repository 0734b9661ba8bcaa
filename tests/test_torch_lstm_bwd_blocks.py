"""The decomposition K3's cluster route (csrc/lstm_bwd.cu) computes, on the
CPU: a torch model of its arithmetic held against the port's plain version
``lstm_backward_plain`` and the JAX package's ``_scan_bwd``.

The kernel splits the hidden units of a cluster of ``cs`` blocks into
slices of u = ceil(H / cs) units (the last slices ragged, or empty). A
block owns the four gate columns of its units, so it forms dz_t for those
columns itself and, from them alone, the partial product
``dz_t[:, own cols] @ RW[:, own cols]^T`` over all H outputs. The cs
partials of each unit are then summed in rank order (the reduce-scatter
through distributed shared memory) to give dh_rec. For bfloat16 streams dz
is rounded to bfloat16 before the product and the sums stay float32.

Tolerances, relative to the largest magnitude of the reference:

- float32 1e-5: the same math, the contraction summed in another order
  (within a block's columns, then across blocks); each sum has at most 4H
  terms of float32 rounding, about 1e-6 of the largest value after T steps.
- bfloat16 3e-2, the card tests' tolerance: dz is rounded to bfloat16 in
  both, but the two float32 sums differ in order, so a value near a
  rounding boundary can round to neighbouring bfloat16 values (one ulp is
  2^-8, about 4e-3 relative) and the difference is carried through the
  later steps.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.lstm_pallas import _scan_bwd
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import lstm_cuda

T = 5
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def unit_slices(H, cs):
    """(j0, nj) of each block of a cluster: u = ceil(H / cs) units each, the
    last slices ragged or empty."""
    u = -(-H // cs)
    return [(k * u, max(0, min(u, H - k * u))) for k in range(cs)]


def cluster_backward_model(gates, tc, cprev, rw, dhs, dcT, cs):
    """K3's cluster-route arithmetic in torch: returns dz (T, B, 4H) in the
    stream dtype and dh0, dc0 (B, H) in float32."""
    Tn, B, G = gates.shape
    H = G // 4
    rwf = rw.float()
    cols = [[g * H + j0 + jj for g in range(4) for jj in range(nj)]
            for j0, nj in unit_slices(H, cs)]
    dz = torch.empty_like(gates)
    dh_rec = torch.zeros((B, H))
    dc = dcT.float()
    for t in reversed(range(Tn)):
        gt = gates[t].float()
        i, f, o, g = (gt[:, k * H:(k + 1) * H] for k in range(4))
        tct, cp = tc[t].float(), cprev[t].float()
        dh = dhs[t].float() + dh_rec
        do = dh * tct
        dc = dc + dh * o * (1.0 - tct * tct)
        di, dg, df = dc * g, dc * i, dc * cp
        dz[t] = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                           do * o * (1.0 - o), dg * (1.0 - g * g)], dim=-1)
        zr = dz[t].float()                      # rounded to the stream dtype
        # each block's partial over its own columns, summed in rank order
        dh_rec = torch.zeros((B, H))
        for c in cols:
            if c:
                dh_rec = dh_rec + zr[:, c] @ rwf[:, c].t()
        dc = dc * f
    return dz, dh_rec, dc


def _inputs(B, H, dtype, seed=0):
    r = np.random.RandomState(seed + 7 * B + H)
    s = 1.0 / np.sqrt(H)

    def rnd(*shape, scale):
        return torch.tensor(r.randn(*shape) * scale,
                            dtype=torch.float32).to(dtype)
    gate_in, rw = rnd(T, B, 4 * H, scale=0.5), rnd(H, 4 * H, scale=s)
    h0, c0 = rnd(B, H, scale=0.5), rnd(B, H, scale=0.5)
    dhs, dcT = rnd(T, B, H, scale=0.5), rnd(B, H, scale=0.5)
    _, tc, cprev, gates, _ = lstm_cuda.lstm_sequence_train_plain(gate_in, rw,
                                                                 h0, c0)
    return gates, tc, cprev, rw, dhs, dcT


@functools.lru_cache(maxsize=None)
def _references(B, H, dtype):
    """The inputs, the port's plain version and the JAX scan on them."""
    args = _inputs(B, H, dtype)
    plain = lstm_cuda.lstm_backward_plain(*args)
    jargs = [jnp.asarray(a.float().numpy(), JDT[dtype]) for a in args]
    jax_out = [torch.tensor(np.asarray(jnp.asarray(o, jnp.float32)))
               for o in _scan_bwd(*jargs)]
    return args, plain, jax_out


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("H,cs", [(40, 16), (40, 8), (256, 16), (300, 16),
                                  (300, 8), (7, 16)])
def test_unit_slices_cover_every_unit_once(H, cs):
    owned = [j0 + jj for j0, nj in unit_slices(H, cs) for jj in range(nj)]
    assert owned == list(range(H))
    assert all(nj <= -(-H // cs) for _, nj in unit_slices(H, cs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 3, 32])
@pytest.mark.parametrize("H", [40, 256, 300])
@pytest.mark.parametrize("cs", [8, 16])
def test_cluster_decomposition_matches_plain_and_jax(cs, H, B, dtype):
    args, plain, jax_out = _references(B, H, dtype)
    got = cluster_backward_model(*args, cs=cs)
    assert got[0].dtype == dtype and got[0].shape == (T, B, 4 * H)
    assert got[1].dtype == got[2].dtype == torch.float32
    for g, p, j in zip(got, plain, jax_out):
        assert _rel_err(g, p) <= TOL[dtype]
        assert _rel_err(g, j) <= TOL[dtype]


@pytest.mark.parametrize("B,H", [(3, 40), (1, 256), (32, 432), (2, 433)])
def test_cpu_tensors_take_the_plain_version_whatever_the_route(B, H):
    """On CPU tensors the wrapper runs the plain version and launches
    nothing, whichever route the shape would take on the card (on an H100
    the cluster route up to H=432, the grid-wide one past it)."""
    args = _inputs(B, H, torch.float32)
    ops.reset_launch_counts()
    got = ops.fused_lstm_backward(*args)
    assert ops.launch_counts() == {}
    for g, p in zip(got, lstm_cuda.lstm_backward_plain(*args)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,rows", [(32, 8), (3, 1)])
def test_clusters_own_their_rows_alone(B, rows, dtype):
    """Clusters share nothing: each owns `rows` batch rows, and running the
    model cluster by cluster gives what it gives over the whole batch.
    Tolerance: float32 1e-6, bfloat16 one ulp of the largest value (2^-8)
    relative to it -- the rows' arithmetic is the same, but the CPU's
    matrix product may block a batch of another size differently, which
    moves the last bit of a float32 sum, and in bfloat16 a dz on a rounding
    boundary by one ulp."""
    args = _inputs(B, 40, dtype)
    whole = cluster_backward_model(*args, cs=16)
    parts = [cluster_backward_model(
        *[a[:, r:r + rows] if a.dim() == 3 else a for a in args[:5]],
        args[5][r:r + rows], cs=16) for r in range(0, B, rows)]
    split = (torch.cat([p[0] for p in parts], dim=1),
             torch.cat([p[1] for p in parts]),
             torch.cat([p[2] for p in parts]))
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    for g, w in zip(split, whole):
        assert _rel_err(g, w) <= tol
