"""The decomposition the cluster route of K1 and K2 (csrc/lstm_fwd.cu, the
one-layer kernel of csrc/lstm_fwd_cluster.cuh) computes, on the CPU: a
torch model of its arithmetic held against the port's plain version
``lstm_sequence_train_plain`` and the JAX package's ``_fwd_call`` (the
Pallas kernels in interpret mode, ``save_reserve=True`` and ``False``),
from the same numpy inputs with non-zero initial carries.

The kernel splits the hidden units of a cluster of ``cs`` blocks into
slices of u = ceil(H / cs) units (the last slices ragged, or empty). A
block owns the four gate columns of its units in RW, so from the full rows
of h_{t-1} -- every block's slice, rounded to the stream dtype and gathered
after one cluster barrier -- it forms its own z columns and updates its
own units' cells; there is no sum across blocks. Within a block a product
tile is one unit and RT rows (all of a cluster's rows up to 8): 16 lanes
each sum every 16th k of the contraction, and a fold of shuffles adds the
16 lanes' sums in a fixed order, leaving the four gates of one row on the
lanes that own its cell. Each cluster owns its batch rows alone. For
bfloat16 streams h is rounded to bfloat16 before the product and the sums
stay float32.

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

from deeplearning4j_tpu.ops.lstm_pallas import _fwd_call
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import lstm_cuda

T = 5
KS = 16              # lanes that split one product tile's contraction
CLUSTERS = 7         # 16-block clusters an H100 runs at once (the plan's)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["float32", "bfloat16"])


def unit_slices(H, cs):
    """(j0, nj) of each block of a cluster: u = ceil(H / cs) units each, the
    last slices ragged or empty."""
    u = -(-H // cs)
    return [(k * u, max(0, min(u, H - k * u))) for k in range(cs)]


def pow2ceil(n):
    return 1 << (n - 1).bit_length()


def fold(P):
    """The kernel's fold over the KS lanes (dim -2) of N values each (dim
    -1): while more than four remain, lanes M apart (M = 8, 4, ...) keep
    the lower half (bit M clear) or the upper half (set) of their sums with
    the partner's; past that, each adds the partner's four. Returns (...,
    KS, 4)."""
    lanes = torch.arange(KS)
    M = KS // 2
    while M:
        Q = P[..., lanes ^ M, :]
        N = P.shape[-1]
        if N > 4:
            hi = ((lanes & M) != 0)[:, None]
            P = torch.where(hi, P[..., N // 2:] + Q[..., N // 2:],
                            P[..., :N // 2] + Q[..., :N // 2])
        else:
            P = P + Q
        M //= 2
    return P


def tile_product(h, w, rt):
    """z = h @ w for one unit-slice of a block, as the kernel's product
    tiles form it: h (rows, H) float32, w (H, nj, 4) the block's gate
    columns. Each tile of rt rows (zero rows up to a power of two, RP) and
    one unit: lane ks sums k = ks, ks + 16, ... into RP x 4 values; the
    fold leaves row q's four gates on lane q * (16 / RP). Returns (rows,
    nj, 4)."""
    rows, H = h.shape
    hp = -(-H // KS) * KS
    rp = pow2ceil(rt)
    spread = KS // rp
    hpad = torch.zeros((-(-rows // rt) * rt, hp))
    hpad[:rows, :H] = h
    wpad = torch.zeros((hp, w.shape[1], 4))
    wpad[:H] = w
    w3 = wpad.reshape(hp // KS, KS, w.shape[1], 4)
    out = []
    for r0 in range(0, rows, rt):
        tile = torch.zeros((rp, hp))
        tile[:rt] = hpad[r0:r0 + rt]
        lanes = torch.einsum("ris,isjg->jsrg", tile.reshape(rp, hp // KS, KS),
                             w3).reshape(w.shape[1], KS, 4 * rp)
        folded = fold(lanes)                       # (nj, KS, 4)
        out.append(folded[:, ::spread][:, :rt].transpose(0, 1))
    return torch.cat(out)[:rows]


def _cluster(args, cs, outs, rows, rt):
    """One cluster's rows `rows` of every output, step by step."""
    gate_in, rw, h0, c0 = args
    dt, H = gate_in.dtype, h0.shape[-1]
    hs, tcs, cprev, gates, cT = outs
    blocks = [(j0, nj, [g * H + j0 + jj for g in range(4) for jj in range(nj)])
              for j0, nj in unit_slices(H, cs) if nj]
    wf = rw.float()
    # each block's gate columns as the kernel keeps them: w[k, jj, gate]
    cols_w = [wf[:, cols].reshape(H, 4, nj).transpose(1, 2)
              for _, nj, cols in blocks]
    # each block's slice of h (as the products read it) and its cells' c
    h = [h0[rows, j0:j0 + nj].float() for j0, nj, _ in blocks]
    c = [c0[rows, j0:j0 + nj].float() for j0, nj, _ in blocks]
    for t in range(T):
        hg = torch.cat(h, dim=1)           # the all-gather: full rows of h
        for b, (j0, nj, cols) in enumerate(blocks):
            units = slice(j0, j0 + nj)
            z = tile_product(hg, cols_w[b], rt)       # (rows, nj, 4)
            z = z.transpose(1, 2).reshape(-1, 4 * nj)  # gate-major columns
            cprev[t, rows, units] = c[b].to(dt)
            hb, c[b], tc, g = lstm_cuda._cell_train(
                gate_in[t, rows][:, cols].float() + z, c[b], nj)
            hs[t, rows, units], tcs[t, rows, units] = hb.to(dt), tc.to(dt)
            gates[t, rows.start:rows.stop, cols] = g.to(dt)
            h[b] = hb.to(dt).float()
    for b, (j0, nj, _) in enumerate(blocks):
        cT[rows, j0:j0 + nj] = c[b].to(dt)


def cluster_forward_model(gate_in, rw, h0, c0, cs, rows=None):
    """K2's cluster-route arithmetic in torch, clusters of `rows` batch rows
    (by default as many as an H100's 7 clusters need) and product tiles of
    all of a cluster's rows up to 8. Returns what
    ``lstm_sequence_train_plain`` returns: (hs, tc, cprev, gates, cT) in the
    stream dtype (K1's outputs are hs and cT)."""
    dt, B, H = gate_in.dtype, h0.shape[0], h0.shape[-1]
    seq = [torch.full((T, B, H), float("nan"), dtype=dt) for _ in range(3)]
    gates = torch.full((T, B, 4 * H), float("nan"), dtype=dt)
    cT = torch.full((B, H), float("nan"), dtype=dt)
    outs = (seq[0], seq[1], seq[2], gates, cT)
    rows = rows or -(-B // CLUSTERS)
    for r0 in range(0, B, rows):
        _cluster((gate_in, rw, h0, c0), cs, outs,
                 slice(r0, min(B, r0 + rows)), min(rows, 8))
    return outs


def _inputs(B, H, seed=0):
    r = np.random.RandomState(seed + 7 * B + H)
    s = 1.0 / np.sqrt(H)
    shapes = [((T, B, 4 * H), 0.5), ((H, 4 * H), s), ((B, H), 0.5),
              ((B, H), 0.5)]
    return [np.asarray(r.randn(*shp) * sc, dtype=np.float32)
            for shp, sc in shapes]


def _torch_args(arrays, dtype):
    return [torch.tensor(a).to(dtype) for a in arrays]


def _to_torch(arrays):
    return [torch.tensor(np.asarray(jnp.asarray(a, jnp.float32)))
            for a in arrays]


@functools.lru_cache(maxsize=None)
def _references(B, H, dtype):
    """The inputs, the port's plain version and the JAX kernels interpreted
    on them: training mode (hs, tc, cprev, gates, cT) and inference mode
    (hs, cT)."""
    arrays = _inputs(B, H)
    args = _torch_args(arrays, dtype)
    plain = lstm_cuda.lstm_sequence_train_plain(*args)
    jargs = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    train = _to_torch(_fwd_call(*jargs, interpret=True, save_reserve=True))
    infer = _to_torch(_fwd_call(*jargs, interpret=True, save_reserve=False))
    return args, plain, train, infer


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("H,cs", [(40, 16), (40, 8), (256, 16), (300, 16),
                                  (300, 8), (7, 16), (432, 16), (433, 16)])
def test_unit_slices_cover_every_unit_once(H, cs):
    slices = unit_slices(H, cs)
    owned = [j0 + jj for j0, nj in slices for jj in range(nj)]
    assert owned == list(range(H))
    assert len(slices) == cs
    assert all(0 <= nj <= -(-H // cs) for _, nj in slices)


@pytest.mark.parametrize("rp", [1, 2, 4, 8, 16])
def test_fold_leaves_each_rows_sum_on_its_lanes(rp):
    """After the fold, lane ks holds the four gates of row ks // (16 / RP),
    summed over all 16 lanes (RP = 16 is the two-layer kernel's tile of
    8 rows x 2 layers)."""
    P = torch.randn(3, KS, 4 * rp, dtype=torch.float64)
    got = fold(P)
    want = P.sum(dim=1).reshape(3, rp, 4)
    spread = KS // rp
    for ks in range(KS):
        assert torch.allclose(got[:, ks], want[:, ks // spread], atol=1e-12)


@DTYPES
@pytest.mark.parametrize("B", [1, 15, 32])
@pytest.mark.parametrize("H", [40, 256, 300])
@pytest.mark.parametrize("cs", [8, 16])
def test_cluster_decomposition_matches_plain_and_jax(cs, H, B, dtype):
    """Every output of the training mode against the plain version and the
    interpreted Pallas ``_fwd_kernel``; hs and cT also against
    ``_fwd_inference_kernel`` (K1's outputs). Ragged and empty unit slices
    at H=40 and 300; tiles of 1, 3 and 5 rows (B=1, 15, 32 over the
    clusters an H100 runs at once)."""
    args, plain, train, infer = _references(B, H, dtype)
    got = cluster_forward_model(*args, cs=cs)
    assert len(got) == len(plain) == len(train) == 5
    for g, p, j in zip(got, plain, train):
        assert g.dtype == dtype and g.shape == p.shape == j.shape
        assert _max_err(g, p) <= TOL[dtype]
        assert _max_err(g, j) <= TOL[dtype]
    for g, j in zip((got[0], got[4]), infer):
        assert _max_err(g, j) <= TOL[dtype]


@DTYPES
@pytest.mark.parametrize("B,rows", [(32, 8), (16, 4), (3, 1), (33, 8),
                                    (15, 6)])
def test_clusters_own_their_rows_alone(B, rows, dtype):
    """Clusters share nothing: each owns `rows` batch rows (the last one
    fewer when rows do not divide B), and running the model cluster by
    cluster gives what it gives over the whole batch in one cluster of
    tiles of 8 rows. Tolerance: float32 1e-6, bfloat16 one ulp of a value
    below 2 (2^-7) -- each row's arithmetic is the same, but the CPU's
    product may block a batch of another size differently, which moves the
    last bit of a float32 sum, and in bfloat16 an h on a rounding boundary
    by one ulp."""
    args = _torch_args(_inputs(B, 40), dtype)
    whole = cluster_forward_model(*args, cs=16, rows=B)
    split = cluster_forward_model(*args, cs=16, rows=rows)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    for g, w in zip(split, whole):
        assert not torch.isnan(g.float()).any()
        assert _max_err(g, w) <= tol


@pytest.mark.parametrize("train", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("B,H", [(15, 256), (32, 256), (1, 40), (15, 300),
                                 (32, 432), (32, 433), (2, 1056)])
def test_cpu_tensors_take_the_plain_version_whatever_the_route(B, H, train):
    """On CPU tensors the wrappers run the plain version and launch nothing,
    whichever route the shape would take on the card (on an H100 the
    cluster route up to H=432, the grid-wide one past it, up to 1056)."""
    args = _torch_args(_inputs(B, H), torch.float32)
    wrapper = (ops.fused_lstm_sequence_train if train
               else ops.fused_lstm_sequence)
    plain = lstm_cuda.lstm_sequence_train_plain(*args)
    ops.reset_launch_counts()
    got = wrapper(*args)
    assert ops.launch_counts() == {}
    want = plain if train else (plain[0], plain[4])
    assert len(got) == len(want)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
