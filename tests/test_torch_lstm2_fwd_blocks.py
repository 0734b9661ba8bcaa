"""The decomposition the cluster route of K4 and K4-train (csrc/lstm2_fwd.cu)
computes, on the CPU: a torch model of its arithmetic held against the
port's plain version ``lstm2_sequence_train_plain`` and the JAX package's
``fused_lstm2_sequence`` forward (``_fused2_fwd``, the Pallas kernel in
interpret mode), from the same numpy inputs.

The kernel splits the hidden units of a cluster of ``cs`` blocks into
slices of u = ceil(H / cs) units (the last slices ragged, or empty). A
block owns the four gate columns of its units in RW1, W2 and RW2, so from
the full rows of h1_{s-1} and h2_{s-2} -- every block's slices, gathered
after one cluster barrier -- it forms its own columns of the three
products and updates its own units' cells; there is no sum across blocks.
Iteration s runs layer-1 step s and layer-2 step s - 1 (the wavefront), so
T + 1 iterations cover both layers. Each cluster owns its batch rows alone.
For bfloat16 streams h is rounded to bfloat16 before the products and the
sums stay float32.

Tolerances, absolute (every output lies within a few units of zero), as
``tests/test_torch_lstm_ops.py`` gives them: float32 1e-5, the same math
with the contraction summed in another order; bfloat16 2e-2, since a value
near a rounding boundary can round to neighbouring bfloat16 values (one ulp
is about 4e-3 at |h| < 1) and the difference is carried through later
steps.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops.lstm_pallas import _fused2_fwd
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import lstm_cuda

T = 5
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["float32", "bfloat16"])


def unit_slices(H, cs):
    """(j0, nj) of each block of a cluster: u = ceil(H / cs) units each, the
    last slices ragged or empty."""
    u = -(-H // cs)
    return [(k * u, max(0, min(u, H - k * u))) for k in range(cs)]


def _cluster(args, cs, outs, rows, trace):
    """One cluster's rows `rows` of every output, iteration by iteration."""
    gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02 = args
    dt, H = gate_in1.dtype, h01.shape[-1]
    hs2, h1T, c1T, c2T, hs1, tc1, cp1, g1, tc2, cp2, g2 = outs
    mats = [m.float() for m in (rw1, w2, rw2)]
    blocks = [(j0, nj, [g * H + j0 + jj for g in range(4) for jj in range(nj)])
              for j0, nj in unit_slices(H, cs) if nj]
    # each block's slices of h1 and h2 (as the products read them) and its
    # cells' c, float32
    h1 = [h01[rows, j0:j0 + nj].float() for j0, nj, _ in blocks]
    h2 = [h02[rows, j0:j0 + nj].float() for j0, nj, _ in blocks]
    c1 = [c01[rows, j0:j0 + nj].float() for j0, nj, _ in blocks]
    c2 = [c02[rows, j0:j0 + nj].float() for j0, nj, _ in blocks]
    for s in range(T + 1):
        # the all-gather: the full rows of h1_{s-1} and h2_{s-2}
        h1g, h2g = torch.cat(h1, dim=1), torch.cat(h2, dim=1)
        for b, (j0, nj, cols) in enumerate(blocks):
            units = slice(j0, j0 + nj)
            z1 = h1g @ mats[0][:, cols]
            z2 = h1g @ mats[1][:, cols] + h2g @ mats[2][:, cols]
            if s < T:
                trace.append((s, 1, s))
                cp1[s, rows, units] = c1[b].to(dt)
                h, c1[b], tc, g = lstm_cuda._cell_train(
                    gate_in1[s, rows][:, cols].float() + z1, c1[b], nj)
                hs1[s, rows, units], tc1[s, rows, units] = h.to(dt), tc.to(dt)
                g1[s, rows.start:rows.stop, cols] = g.to(dt)
                h1[b] = h.to(dt).float()
            if s >= 1:
                trace.append((s, 2, s - 1))
                cp2[s - 1, rows, units] = c2[b].to(dt)
                h, c2[b], tc, g = lstm_cuda._cell_train(
                    z2 + b2[cols].float(), c2[b], nj)
                hs2[s - 1, rows, units], tc2[s - 1, rows, units] = (h.to(dt),
                                                                   tc.to(dt))
                g2[s - 1, rows.start:rows.stop, cols] = g.to(dt)
                h2[b] = h.to(dt).float()
    for b, (j0, nj, _) in enumerate(blocks):
        units = slice(j0, j0 + nj)
        h1T[rows, units], c1T[rows, units] = h1[b].to(dt), c1[b].to(dt)
        c2T[rows, units] = c2[b].to(dt)


def cluster_forward_model(gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02,
                          cs, rows=None, trace=None):
    """K4-train's cluster-route arithmetic in torch, clusters of `rows`
    batch rows (all of them by default). Returns what
    ``lstm2_sequence_train_plain`` returns: (hs2, h1T, c1T, c2T, hs1, tc1,
    cp1, g1, tc2, cp2, g2) in the stream dtype. `trace`, when given,
    collects (iteration, layer, step) for every layer step, in order."""
    args = (gate_in1, rw1, w2, b2, rw2, h01, c01, h02, c02)
    dt, B, H = gate_in1.dtype, h01.shape[0], h01.shape[-1]
    seq = [torch.full((T, B, H), float("nan"), dtype=dt) for _ in range(6)]
    fin = [torch.full((B, H), float("nan"), dtype=dt) for _ in range(3)]
    gates = [torch.full((T, B, 4 * H), float("nan"), dtype=dt)
             for _ in range(2)]
    hs2, hs1, tc1, cp1, tc2, cp2 = seq
    outs = (hs2, *fin, hs1, tc1, cp1, gates[0], tc2, cp2, gates[1])
    rows = rows or B
    for r0 in range(0, B, rows):
        _cluster(args, cs, outs, slice(r0, min(B, r0 + rows)),
                 [] if trace is None else trace)
    return outs


def _inputs(B, H, dtype, seed=0):
    r = np.random.RandomState(seed + 7 * B + H)
    s = 1.0 / np.sqrt(H)
    shapes = [((T, B, 4 * H), 0.5), ((H, 4 * H), s), ((H, 4 * H), s),
              ((4 * H,), 0.1), ((H, 4 * H), s)] + [((B, H), 0.5)] * 4
    return [np.asarray(r.randn(*shp) * sc, dtype=np.float32)
            for shp, sc in shapes]


def _torch_args(arrays, dtype):
    return [torch.tensor(a).to(dtype) for a in arrays]


@functools.lru_cache(maxsize=None)
def _references(B, H, dtype):
    """The inputs, the port's plain version and the JAX forward (the Pallas
    kernel interpreted) on them, both in the plain version's output order."""
    arrays = _inputs(B, H, dtype)
    args = _torch_args(arrays, dtype)
    plain = lstm_cuda.lstm2_sequence_train_plain(*args)
    out, res = _fused2_fwd(*[jnp.asarray(a, JDT[dtype]) for a in arrays],
                           True)
    # res: rw1, w2, rw2, h01, c01, h02, c02, hs1, tc1, cp1, g1, hs2, tc2,
    # cp2, g2
    jax_out = [torch.tensor(np.asarray(jnp.asarray(o, jnp.float32)))
               for o in list(out) + list(res[7:11]) + list(res[12:15])]
    return args, plain, jax_out


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("H,cs", [(40, 16), (40, 8), (256, 16), (300, 16),
                                  (300, 8), (7, 16), (257, 16)])
def test_unit_slices_cover_every_unit_once(H, cs):
    slices = unit_slices(H, cs)
    owned = [j0 + jj for j0, nj in slices for jj in range(nj)]
    assert owned == list(range(H))
    assert len(slices) == cs
    assert all(0 <= nj <= -(-H // cs) for _, nj in slices)


@DTYPES
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("H", [40, 256, 300])
@pytest.mark.parametrize("cs", [8, 16])
def test_cluster_decomposition_matches_plain_and_jax(cs, H, B, dtype):
    """Every output of the training mode (the inference mode's four are its
    first four), ragged and empty unit slices at H=40 and H=300."""
    args, plain, jax_out = _references(B, H, dtype)
    got = cluster_forward_model(*args, cs=cs)
    assert len(got) == len(plain) == len(jax_out) == 11
    for g, p, j in zip(got, plain, jax_out):
        assert g.dtype == dtype and g.shape == p.shape == j.shape
        assert _max_err(g, p) <= TOL[dtype]
        assert _max_err(g, j) <= TOL[dtype]


def test_wavefront_order():
    """T + 1 iterations: iteration s runs layer-1 step s and layer-2 step
    s - 1 (iteration 0 layer 1 alone, iteration T layer 2 alone), so every
    step reads only what the iteration before wrote and one barrier per
    iteration orders both layers."""
    trace = []
    cluster_forward_model(*_torch_args(_inputs(3, 40, torch.float32),
                                       torch.float32), cs=16, trace=trace)
    blocks = sum(1 for _, nj in unit_slices(40, 16) if nj)
    assert trace[0] == (0, 1, 0) and trace[-1] == (T, 2, T - 1)
    for s in range(T + 1):
        steps = sorted({(layer, step) for it, layer, step in trace
                        if it == s})
        want = ([(1, s)] if s < T else []) + ([(2, s - 1)] if s else [])
        assert steps == want
        assert sum(1 for it, _, _ in trace if it == s) == len(want) * blocks


@DTYPES
@pytest.mark.parametrize("B,rows", [(32, 8), (16, 4), (3, 1), (33, 8)])
def test_clusters_own_their_rows_alone(B, rows, dtype):
    """Clusters share nothing: each owns `rows` batch rows (the last one
    fewer when rows do not divide B), and running the model cluster by
    cluster gives what it gives over the whole batch. Tolerance: float32
    1e-6, bfloat16 one ulp of a value below 2 (2^-7) -- the
    rows' arithmetic is the same, but the CPU's matrix product may block a
    batch of another size differently, which moves the last bit of a
    float32 sum, and in bfloat16 an h on a rounding boundary by one ulp."""
    args = _torch_args(_inputs(B, 40, dtype), dtype)
    whole = cluster_forward_model(*args, cs=16)
    split = cluster_forward_model(*args, cs=16, rows=rows)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    for g, w in zip(split, whole):
        assert not torch.isnan(g.float()).any()
        assert _max_err(g, w) <= tol


@pytest.mark.parametrize("train", [False, True], ids=["k4", "k4_train"])
@pytest.mark.parametrize("B,H", [(3, 40), (1, 256), (32, 256), (2, 257),
                                 (5, 300)])
def test_cpu_tensors_take_the_plain_version_whatever_the_route(B, H, train):
    """On CPU tensors the wrappers run the plain version and launch nothing,
    whichever route the shape would take on the card (on an H100 the
    cluster route up to H=256, the grid-wide one past it)."""
    args = _torch_args(_inputs(B, H, torch.float32), torch.float32)
    wrapper = (ops.fused_lstm2_sequence_train if train
               else ops.fused_lstm2_sequence)
    plain = lstm_cuda.lstm2_sequence_train_plain(*args)
    ops.reset_launch_counts()
    got = wrapper(*args)
    assert ops.launch_counts() == {}
    assert len(got) == (11 if train else 4)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
