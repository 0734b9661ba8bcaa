"""The port's LSTM training ops -- K2 (training forward), K3 (backward),
K4-train (stacked training forward) and their autograd functions -- held
against the JAX package's, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; they are
compared with the JAX scan references (``_scan_fwd(save_reserve=True)``,
``_scan_bwd``) and with the Pallas kernels run in interpret mode
(``_fwd_call``, ``_bwd_call``, ``_fused2_fwd``), from the same numpy inputs.
Gradients of ``FusedLSTM``/``FusedLSTM2`` are compared with ``jax.grad`` of
the JAX custom-VJP ops, and with an independent oracle: torch autograd
through the layer's own ``_cell`` loop in float64.

Tolerances, absolute, on values of order 1: float32 1e-5 (same math in
another summation order); bfloat16 streams 2e-2 (one bfloat16 rounding is
~4e-3 at |x| < 1 and the packages may round a value on opposite sides).
Gradients are compared relative to the largest magnitude of the reference:
float32 1e-5, bfloat16 3e-2, float32 against the float64 oracle 1e-5.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.ops.lstm_pallas import (_bwd_call, _fused2_fwd,
                                                _fwd_call, _scan_bwd,
                                                _scan_fwd,
                                                fused_lstm2_sequence as jk4,
                                                fused_lstm_sequence as jk1)
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.nn.layers import LSTM
from deeplearning4j_tpu_torch.ops import lstm_cuda

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 3e-2)}
GRID = [(1, 2, 8), (6, 3, 16)]
K1_ARGS = ("gate_in", "rw1", "h01", "c01")
K4_ARGS = ("gate_in", "rw1", "w2", "b2", "rw2", "h01", "c01", "h02", "c02")


@pytest.fixture
def jax_kernels_interpreted():
    jops.set_helpers_enabled(True, interpret=True)
    yield
    jops.set_helpers_enabled(None)


def _case(T, B, H, seed=0):
    r = np.random.RandomState(seed + 100 * T + 10 * B + H)
    s = 1.0 / np.sqrt(H)
    f = np.float32
    return {"gate_in": (r.randn(T, B, 4 * H) * 0.5).astype(f),
            "rw1": (r.randn(H, 4 * H) * s).astype(f),
            "w2": (r.randn(H, 4 * H) * s).astype(f),
            "b2": (r.randn(4 * H) * 0.1).astype(f),
            "rw2": (r.randn(H, 4 * H) * s).astype(f),
            "h01": (r.randn(B, H) * 0.5).astype(f),
            "c01": (r.randn(B, H) * 0.5).astype(f),
            "h02": (r.randn(B, H) * 0.5).astype(f),
            "c02": (r.randn(B, H) * 0.5).astype(f),
            "dhs": (r.randn(T, B, H) * 0.5).astype(f),
            "dcT": (r.randn(B, H) * 0.5).astype(f),
            "dh1T": (r.randn(B, H) * 0.5).astype(f),
            "dc1T": (r.randn(B, H) * 0.5).astype(f)}


def _t(a, dt):
    return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(dt)


def _close(port, ref, tol):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(port.float().detach().numpy(), ref, rtol=0,
                               atol=tol)


def _close_rel(port, ref, tol):
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    got = port.double().detach().numpy()
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, \
        (np.abs(got - ref).max(), scale)


# ------------------------------------------------------------ forwards

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,B,H", GRID)
def test_k2_plain_matches_jax_scan(T, B, H, dtype):
    tdt, jdt, tol, _ = DTYPES[dtype]
    c = _case(T, B, H)
    got = ops.fused_lstm_sequence_train(*[_t(c[k], tdt) for k in K1_ARGS])
    want = _scan_fwd(*[jnp.asarray(c[k], jdt) for k in K1_ARGS],
                     save_reserve=True)
    assert [g.dtype for g in got] == [tdt] * 5
    for g, w in zip(got, want):          # hs, tc, cprev, gates, cT
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, tol)
    # the training forward computes the inference forward's outputs
    hs, cT = ops.fused_lstm_sequence(*[_t(c[k], tdt) for k in K1_ARGS])
    assert torch.equal(hs, got[0]) and torch.equal(cT, got[4])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k2_plain_matches_interpreted_pallas_kernel(
        dtype, jax_kernels_interpreted):
    tdt, jdt, tol, _ = DTYPES[dtype]
    c = _case(6, 3, 16, seed=1)
    got = ops.fused_lstm_sequence_train(*[_t(c[k], tdt) for k in K1_ARGS])
    want = _fwd_call(*[jnp.asarray(c[k], jdt) for k in K1_ARGS],
                     interpret=True, save_reserve=True)
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.mark.parametrize("T,B,H,dtype", [(1, 2, 8, "float32"),
                                         (5, 3, 16, "bfloat16")])
def test_k4_train_plain_matches_interpreted_pallas_unshifted(
        T, B, H, dtype, jax_kernels_interpreted):
    """Against ``_fused2_fwd``: the TPU kernel's shifted layer-2 slots after
    its un-shift and epilogue, i.e. every reserve on unshifted time."""
    tdt, jdt, tol, _ = DTYPES[dtype]
    c = _case(T, B, H, seed=2)
    got = ops.fused_lstm2_sequence_train(*[_t(c[k], tdt) for k in K4_ARGS])
    outs, res = _fused2_fwd(*[jnp.asarray(c[k], jdt) for k in K4_ARGS], True)
    hs1, tc1, cp1, g1, hs2, tc2, cp2, g2 = res[7:]
    want = tuple(outs) + (hs1, tc1, cp1, g1, tc2, cp2, g2)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == tdt
        _close(g, w, tol)
    inference = ops.fused_lstm2_sequence(*[_t(c[k], tdt) for k in K4_ARGS])
    for a, b in zip(inference, got[:4]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- backward

def _reserves(c, tdt, jdt):
    """The same reserve space on both sides: the JAX scan forward's, cast
    across, plus the cotangents in the stream dtype."""
    hs, tc, cprev, gates, _ = _scan_fwd(
        *[jnp.asarray(c[k], jdt) for k in K1_ARGS], save_reserve=True)
    j = (gates, tc, cprev, jnp.asarray(c["rw1"], jdt),
         jnp.asarray(c["dhs"], jdt), jnp.asarray(c["dcT"], jdt))
    return j, [_t(a, tdt) for a in j]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,B,H", GRID)
def test_k3_plain_matches_jax_scan_bwd(T, B, H, dtype):
    tdt, jdt, tol, gtol = DTYPES[dtype]
    j, p = _reserves(_case(T, B, H, seed=3), tdt, jdt)
    dz, dh0, dc0 = ops.fused_lstm_backward(*p)
    wdz, wdh0, wdc0 = _scan_bwd(*j)
    assert dz.dtype == tdt and dh0.dtype == dc0.dtype == torch.float32
    assert tuple(dz.shape) == (T, B, 4 * H)
    _close(dz, wdz, tol)
    _close_rel(dh0, wdh0, gtol)
    _close_rel(dc0, wdc0, gtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k3_plain_matches_interpreted_pallas_kernel(
        dtype, jax_kernels_interpreted):
    tdt, jdt, tol, gtol = DTYPES[dtype]
    j, p = _reserves(_case(6, 3, 16, seed=4), tdt, jdt)
    got = ops.fused_lstm_backward(*p)
    want = _bwd_call(*j, interpret=True)
    _close(got[0], want[0], tol)
    _close_rel(got[1], want[1], gtol)
    _close_rel(got[2], want[2], gtol)


# ------------------------------------------------------------ gradients

def _loss_weights(T, B, H, seed):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32)
            for s in ((T, B, H), (B, H), (B, H), (B, H))]


@pytest.mark.parametrize("T,B,H,dtype", [(1, 2, 8, "bfloat16"),
                                         (6, 3, 16, "float32")])
def test_fused_lstm_gradients_match_jax_grad(T, B, H, dtype,
                                             jax_kernels_interpreted):
    tdt, jdt, _, gtol = DTYPES[dtype]
    c = _case(T, B, H, seed=5)
    wh, wc, _, _ = _loss_weights(T, B, H, 6)

    def jloss(*a):
        hs, cT = jk1(*a, True)
        return (jnp.sum(hs.astype(jnp.float32) * wh)
                + jnp.sum(cT.astype(jnp.float32) * wc))
    jargs = [jnp.asarray(c[k], jdt) for k in K1_ARGS]
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)

    targs = [_t(c[k], tdt).requires_grad_() for k in K1_ARGS]
    hs, cT = ops.FusedLSTM.apply(*targs)
    ((hs.float() * torch.tensor(wh)).sum()
     + (cT.float() * torch.tensor(wc)).sum()).backward()
    for a, g in zip(targs, jgrads):
        assert a.grad.dtype == tdt
        _close_rel(a.grad, g, gtol)


def test_fused_lstm2_gradients_match_jax_grad(jax_kernels_interpreted):
    """bfloat16 streams; the float32 pair's gradients are held against JAX
    autodiff by every fit test of tests/test_torch_training.py."""
    T, B, H = 5, 3, 16
    tdt, jdt, _, gtol = DTYPES["bfloat16"]
    c = _case(T, B, H, seed=7)
    wh, w1, wc1, wc2 = _loss_weights(T, B, H, 8)

    def jloss(*a):
        hs2, h1T, c1T, c2T = jk4(*a, True)
        f = jnp.float32
        return (jnp.sum(hs2.astype(f) * wh) + jnp.sum(h1T.astype(f) * w1)
                + jnp.sum(c1T.astype(f) * wc1) + jnp.sum(c2T.astype(f) * wc2))
    jargs = [jnp.asarray(c[k], jdt) for k in K4_ARGS]
    jgrads = jax.grad(jloss, argnums=tuple(range(9)))(*jargs)

    targs = [_t(c[k], tdt).requires_grad_() for k in K4_ARGS]
    outs = ops.FusedLSTM2.apply(*targs)
    sum((o.float() * torch.tensor(w)).sum()
        for o, w in zip(outs, (wh, w1, wc1, wc2))).backward()
    for name, a, g in zip(K4_ARGS, targs, jgrads):
        assert a.grad.dtype == tdt, name
        _close_rel(a.grad, g, gtol)


def test_fused_lstm_gradients_match_float64_autograd_of_the_cell_loop():
    """The independent oracle: torch autograd through ``LSTM._cell`` (the
    layer's own step) in float64."""
    T, B, H = 6, 3, 16
    c = _case(T, B, H, seed=9)
    wh, wc, _, _ = _loss_weights(T, B, H, 10)
    layer = LSTM(n_in=4, n_out=H, activation="tanh")

    x64 = [torch.tensor(c[k], dtype=torch.float64, requires_grad=True)
           for k in K1_ARGS]
    gi, rw, h, cc = x64
    hs = []
    for t in range(T):
        h, cc = layer._cell({"RW": rw}, gi[t], h, cc)
        hs.append(h)
    ((torch.stack(hs) * torch.tensor(wh, dtype=torch.float64)).sum()
     + (cc * torch.tensor(wc, dtype=torch.float64)).sum()).backward()

    x32 = [torch.tensor(c[k], requires_grad=True) for k in K1_ARGS]
    hs32, cT32 = ops.FusedLSTM.apply(*x32)
    ((hs32 * torch.tensor(wh)).sum() + (cT32 * torch.tensor(wc)).sum()
     ).backward()
    for a, b in zip(x32, x64):
        ref = b.grad.numpy()
        err = np.abs(a.grad.double().numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), err


def test_autograd_picks_the_training_kernels_only_when_recording():
    c = {k: torch.tensor(v) for k, v in _case(4, 2, 8).items()}
    args = [c[k] for k in K1_ARGS]
    with torch.no_grad():
        out = ops.lstm_sequence(*[a.requires_grad_() for a in args])
    assert out[0].grad_fn is None
    out = ops.lstm_sequence(*args)
    assert type(out[0].grad_fn).__name__ == "FusedLSTMBackward"
    out2 = ops.lstm2_sequence(*[c[k].requires_grad_() for k in K4_ARGS])
    assert type(out2[0].grad_fn).__name__ == "FusedLSTM2Backward"
    frozen = [c[k].detach() for k in K1_ARGS]
    assert ops.lstm_sequence(*frozen)[0].grad_fn is None


def test_cpu_training_ops_launch_nothing():
    c = {k: torch.tensor(v) for k, v in _case(3, 2, 8).items()}
    ops.reset_launch_counts()
    hs, tc, cp, g, _ = ops.fused_lstm_sequence_train(
        *[c[k] for k in K1_ARGS])
    ops.fused_lstm_backward(g, tc, cp, c["rw1"], c["dhs"], c["dcT"])
    ops.fused_lstm2_sequence_train(*[c[k] for k in K4_ARGS])
    assert ops.launch_counts() == {}


@pytest.mark.parametrize("bad", ["dtype_mix", "shape", "float64"])
def test_training_wrappers_reject_what_the_kernels_do_not_take(bad):
    c = {k: torch.tensor(v) for k, v in _case(3, 2, 8).items()}
    hs, tc, cp, g, _ = ops.fused_lstm_sequence_train(
        *[c[k] for k in K1_ARGS])
    bwd = {"gates": g, "tc": tc, "cprev": cp, "rw": c["rw1"],
           "dhs": c["dhs"], "dcT": c["dcT"]}
    if bad == "dtype_mix":
        c["rw1"] = c["rw1"].to(torch.bfloat16)
        bwd["dhs"] = bwd["dhs"].to(torch.bfloat16)
        err = TypeError
    elif bad == "shape":
        c["rw1"] = c["rw1"][:, :-1]
        bwd["tc"] = bwd["tc"][:-1]
        err = ValueError
    else:
        c = {k: v.double() for k, v in c.items()}
        bwd = {k: v.double() for k, v in bwd.items()}
        err = TypeError
    with pytest.raises(err):
        ops.fused_lstm_sequence_train(*[c[k] for k in K1_ARGS])
    with pytest.raises(err):
        ops.fused_lstm2_sequence_train(*[c[k] for k in K4_ARGS])
    with pytest.raises(err):
        ops.fused_lstm_backward(*bwd.values())
