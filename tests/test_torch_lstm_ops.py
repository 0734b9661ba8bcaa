"""The port's fused LSTM ops (K1 single layer, K4 stacked wavefront) held
against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
compared with the JAX kernels in Pallas interpret mode and with the JAX
scan forward (``_scan_fwd``), from the same numpy inputs. Tolerances:
float32 1e-5 (same math, different summation order); bfloat16 streams
2e-2 (one bfloat16 rounding of h or of an output is ~4e-3 at |h| < 1, and
the two packages may round a value on opposite sides).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.ops.lstm_pallas import (_scan_fwd,
                                                fused_lstm2_sequence as jk4,
                                                fused_lstm_sequence as jk1)
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import lstm_cuda

F32_TOL, BF16_TOL = 1e-5, 2e-2
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}
GRID = [(t, b, h) for t in (1, 5, 8) for b in (1, 3) for h in (8, 32)]


@pytest.fixture
def jax_kernels_interpreted():
    jops.set_helpers_enabled(True, interpret=True)
    yield
    jops.set_helpers_enabled(None)


def _case(T, B, H, seed=0):
    r = np.random.RandomState(seed + 100 * T + 10 * B + H)
    s = 1.0 / np.sqrt(H)
    return {"gate_in": (r.randn(T, B, 4 * H) * 0.5).astype(np.float32),
            "rw1": (r.randn(H, 4 * H) * s).astype(np.float32),
            "w2": (r.randn(H, 4 * H) * s).astype(np.float32),
            "b2": (r.randn(4 * H) * 0.1).astype(np.float32),
            "rw2": (r.randn(H, 4 * H) * s).astype(np.float32),
            "h01": (r.randn(B, H) * 0.5).astype(np.float32),
            "c01": (r.randn(B, H) * 0.5).astype(np.float32),
            "h02": (r.randn(B, H) * 0.5).astype(np.float32),
            "c02": (r.randn(B, H) * 0.5).astype(np.float32)}


def _t(a, dt, device="cpu"):
    return torch.tensor(a).to(dt).to(device)


def _close(port, ref, tol):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(port.float().cpu().numpy(), ref, rtol=0,
                               atol=tol)


K1_ARGS = ("gate_in", "rw1", "h01", "c01")
K4_ARGS = ("gate_in", "rw1", "w2", "b2", "rw2", "h01", "c01", "h02", "c02")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,B,H", GRID)
def test_k1_plain_matches_jax_scan(T, B, H, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    c = _case(T, B, H)
    hs, cT = ops.fused_lstm_sequence(*[_t(c[k], tdt) for k in K1_ARGS])
    ref_hs, ref_cT = _scan_fwd(*[jnp.asarray(c[k], jdt) for k in K1_ARGS],
                               save_reserve=False)
    assert hs.dtype == tdt and tuple(hs.shape) == (T, B, H)
    _close(hs, ref_hs, tol)
    _close(cT, ref_cT, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,B,H", GRID)
def test_k4_plain_matches_jax_scan_layers(T, B, H, dtype):
    """K4 against two JAX scan layers on the stacked op's contract: layer 2
    sees layer 1's stream-dtype h through a float32 product, as in the
    wavefront kernel (the layer-2 gate input is kept in float32)."""
    tdt, jdt, tol = DTYPES[dtype]
    c = _case(T, B, H)
    hs2, h1T, c1T, c2T = ops.fused_lstm2_sequence(
        *[_t(c[k], tdt) for k in K4_ARGS])
    j = {k: jnp.asarray(v, jdt) for k, v in c.items()}
    hs1, c1_ref = _scan_fwd(j["gate_in"], j["rw1"], j["h01"], j["c01"],
                            save_reserve=False)
    gi2 = (hs1.astype(jnp.float32) @ j["w2"].astype(jnp.float32)
           + j["b2"].astype(jnp.float32))
    hs2_ref, c2_ref = _scan_fwd(gi2, j["rw2"], j["h02"], j["c02"],
                                save_reserve=False)
    _close(hs2, hs2_ref, tol)
    _close(h1T, hs1[-1], tol)
    _close(c1T, c1_ref, tol)
    _close(c2T, c2_ref, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,B,H", [(5, 3, 8), (8, 1, 32)])
def test_k1_plain_matches_interpreted_pallas_kernel(
        T, B, H, dtype, jax_kernels_interpreted):
    tdt, jdt, tol = DTYPES[dtype]
    c = _case(T, B, H, seed=1)
    hs, cT = ops.fused_lstm_sequence(*[_t(c[k], tdt) for k in K1_ARGS])
    ref_hs, ref_cT = jk1(*[jnp.asarray(c[k], jdt) for k in K1_ARGS],
                         jops.interpret_mode())
    _close(hs, ref_hs, tol)
    _close(cT, ref_cT, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,B,H", [(5, 3, 8), (8, 1, 32)])
def test_k4_plain_matches_interpreted_pallas_kernel(
        T, B, H, dtype, jax_kernels_interpreted):
    tdt, jdt, tol = DTYPES[dtype]
    c = _case(T, B, H, seed=2)
    port = ops.fused_lstm2_sequence(*[_t(c[k], tdt) for k in K4_ARGS])
    ref = jk4(*[jnp.asarray(c[k], jdt) for k in K4_ARGS],
              jops.interpret_mode())
    for p, r in zip(port, ref):
        _close(p, r, tol)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    c = _case(4, 2, 8)
    ops.reset_launch_counts()
    out = ops.fused_lstm_sequence(*[_t(c[k], torch.float32) for k in K1_ARGS])
    ref = lstm_cuda.lstm_sequence_plain(*[_t(c[k], torch.float32)
                                          for k in K1_ARGS])
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    ops.fused_lstm2_sequence(*[_t(c[k], torch.float32) for k in K4_ARGS])
    assert ops.launch_counts() == {}


@pytest.mark.parametrize("bad", ["dtype_mix", "shape", "float64", "empty"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    c = {k: _t(v, torch.float32) for k, v in _case(3, 2, 8).items()}
    if bad == "dtype_mix":
        c["rw1"] = c["rw1"].to(torch.bfloat16)
        err = TypeError
    elif bad == "shape":
        c["rw1"] = c["rw1"][:, :-1]
        err = ValueError
    elif bad == "float64":
        c = {k: v.double() for k, v in c.items()}
        err = TypeError
    else:
        c["gate_in"] = c["gate_in"][:0]
        err = ValueError
    with pytest.raises(err):
        ops.fused_lstm_sequence(*[c[k] for k in K1_ARGS])
    with pytest.raises(err):
        ops.fused_lstm2_sequence(*[c[k] for k in K4_ARGS])
