"""The port's ring attention (parallel/sequence_parallel.py) against the
JAX package's, on the CPU.

- ``ring_attention`` over a ``("seq",)`` mesh of 2 and 8 slots, causal
  and not, against JAX's ``ring_attention`` on the forced host devices
  and against full attention, within 1e-5 (the JAX tests' bar).
- ``RingAttention`` (the kernels' path: K5 per visible block pair merged
  by log-sum-exp, K6 + K7 per pair in the backward; here through the
  kernel wrappers' plain versions) against ``torch.autograd`` through the
  plain recurrence: outputs within 1e-5, gradients within 1e-5 of max
  |grad|; and the pairs it launches: n(n+1)/2 causal, n^2 plain.
- ``SequenceParallelAttention`` over a ``MultiHeadAttention`` layer
  against the layer's own forward and gradients (1e-5 / 1e-5 of max
  |grad|) and JAX's wrapper (1e-5).
- The screen that sends an input to the plain recurrence, and the
  errors.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from deeplearning4j_tpu.nn.layers.attention import \
    MultiHeadAttention as JaxMHA
from deeplearning4j_tpu.parallel.sequence_parallel import (
    SequenceParallelAttention as JaxSPA, ring_attention as jax_ring)

from deeplearning4j_tpu_torch.nn.layers.attention import (
    MultiHeadAttention, scaled_dot_product_attention)
from deeplearning4j_tpu_torch.parallel import sequence_parallel as sp
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    RingAttention, SequenceParallelAttention, ring_attention)
from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh

TOL = 1e-5


def qkv(B=2, T=16, H=2, Dh=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, Dh).astype(np.float32) for _ in range(3)]


def seq_mesh(n):
    return default_mesh(n, "seq", device="cpu")


@pytest.mark.mesh8
@pytest.mark.parametrize("n,T,causal,seed", [(8, 16, False, 0),
                                             (8, 24, True, 3),
                                             (2, 12, True, 5),
                                             (2, 12, False, 6)])
def test_ring_attention_matches_jax_and_full(n, T, causal, seed):
    q, k, v = qkv(T=T, seed=seed)
    jm = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    want = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jm, causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ring_attention(tq, tk, tv, seq_mesh(n), causal=causal)
    assert got.shape == (2, T, 2, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    full = scaled_dot_product_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=TOL)


def fold(a):
    B, T, H, Dh = a.shape
    return torch.from_numpy(a).permute(0, 2, 1, 3).reshape(
        B * H, T, Dh).contiguous().requires_grad_()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_autograd_function_matches_the_plain_recurrence(n, causal):
    q, k, v = qkv(T=32, seed=n)
    fq, fk, fv = fold(q), fold(k), fold(v)
    o = RingAttention.apply(fq, fk, fv, n, causal)
    do = torch.from_numpy(np.random.RandomState(9).randn(
        *o.shape).astype(np.float32))
    g = torch.autograd.grad(o, (fq, fk, fv), do)
    pq, pk, pv = fold(q), fold(k), fold(v)

    def unfold(a):
        return a.reshape(2, 2, 32, 8).permute(0, 2, 1, 3)
    ref = sp._ring_plain(unfold(pq), unfold(pk), unfold(pv), n, causal)
    ref = ref.permute(0, 2, 1, 3).reshape(4, 32, 8)
    gr = torch.autograd.grad(ref, (pq, pk, pv), do)
    np.testing.assert_allclose(o.detach().numpy(), ref.detach().numpy(),
                               atol=TOL)
    for a, b in zip(g, gr):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL * scale)


@pytest.mark.parametrize("n,causal,pairs", [(4, True, 10), (4, False, 16),
                                            (3, True, 6), (2, False, 4)])
def test_ring_launches_one_kernel_per_visible_pair(monkeypatch, n, causal,
                                                   pairs):
    """K5 once per (query block, key block) pair the mask leaves visible
    (the diagonal causal, below it plain, none above it), and K6 and K7
    once each per such pair in the backward."""
    seen = {"fwd": [], "dq": [], "dkv": []}
    for name, key in (("flash_attention_fwd", "fwd"),
                      ("flash_attention_dq", "dq"),
                      ("flash_attention_dkv", "dkv")):
        real = getattr(sp.ops, name)

        def spy(*a, _real=real, _key=key):
            seen[_key].append(bool(a[-1]))
            return _real(*a)
        monkeypatch.setattr(sp.ops, name, spy)
    q, k, v = qkv(T=12 * n // 2 * 2, seed=1)
    fq, fk, fv = fold(q), fold(k), fold(v)
    o = RingAttention.apply(fq, fk, fv, n, causal)
    o.sum().backward()
    for key in seen:
        assert len(seen[key]) == pairs, key
        assert sum(seen[key]) == (n if causal else 0)


def test_the_screen_sends_other_inputs_to_the_recurrence(monkeypatch):
    """The CPU and a head dim that is not a multiple of 8 run the plain
    recurrence, decided by the screen before any launch; the dtype is not
    part of the screen."""
    calls = []
    monkeypatch.setattr(sp.RingAttention, "apply",
                        lambda *a: calls.append(a))
    q, k, v = qkv(T=8, Dh=12)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = ring_attention(*t, seq_mesh(2), causal=True)
    assert out.shape == (2, 8, 2, 12) and calls == []
    assert not sp._kernel_route(t[0])
    assert not sp._kernel_route(torch.zeros(1, 8, 1, 8,
                                            dtype=torch.float64))
    monkeypatch.setattr(sp.ops, "head_dim_supported", lambda d: d % 8 == 0)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        for dh in (8, 12):      # a stand-in for a tensor on the card
            on_card = SimpleNamespace(device=torch.device("cuda"),
                                      dtype=dtype, shape=(1, 8, 1, dh))
            assert sp._kernel_route(on_card) == (dh == 8)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_other_dtypes_ride_the_kernels_in_float32(monkeypatch, dtype):
    """On the kernel route an input of another dtype is folded to float32
    for ``RingAttention`` (as ``scaled_dot_product_attention`` casts
    around K5) and comes back in its own dtype, equal to the float32
    ring's result cast back."""
    seen = []
    real = sp.RingAttention.apply

    def spy(*a):
        seen.append(a[0].dtype)
        return real(*a)
    monkeypatch.setattr(sp, "_kernel_route", lambda q: True)
    monkeypatch.setattr(sp.RingAttention, "apply", spy)
    q, k, v = qkv(T=16, seed=4)
    t32 = [torch.from_numpy(a) for a in (q, k, v)]
    want = ring_attention(*t32, seq_mesh(4), causal=True)
    got = ring_attention(*(a.to(dtype) for a in t32), seq_mesh(4),
                         causal=True)
    assert seen == [torch.float32, torch.float32] and got.dtype == dtype
    ref = ring_attention(*(a.to(dtype).float() for a in t32), seq_mesh(4),
                         causal=True)
    torch.testing.assert_close(got, ref.to(dtype), rtol=0, atol=0)
    assert float((got.float() - want).abs().max()) < (
        1e-6 if dtype == torch.float64 else 5e-2)


@pytest.mark.mesh8
@pytest.mark.parametrize("causal", [True, False])
def test_sequence_parallel_attention_matches_the_layer_and_jax(causal):
    """Over a 4-slot ring: the output against the layer's own forward
    (one flash call over the whole sequence) and JAX's wrapper, the
    input and weight gradients against the layer's."""
    layer = MultiHeadAttention(n_in=16, n_out=16, n_heads=2, causal=causal)
    params = layer.init(torch.Generator().manual_seed(3))
    x = np.random.RandomState(2).randn(2, 16, 16).astype(np.float32)
    jl = JaxMHA(n_in=16, n_out=16, n_heads=2, causal=causal)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jm = JaxMesh(np.array(jax.devices()[:4]), ("seq",))
    want = np.asarray(JaxSPA(jl, jm)(jp, jnp.asarray(x)))
    spa = SequenceParallelAttention(layer, seq_mesh(4))

    def grads(fn):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y = fn(p, xt)
        g = torch.autograd.grad((y * y).sum(), [xt, p["Wq"], p["Wo"],
                                                p["bv"]])
        return y.detach(), g
    y, g = grads(spa)
    y_ref, g_ref = grads(lambda p, xt: layer.apply(p, xt))
    np.testing.assert_allclose(y.numpy(), want, atol=TOL)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=TOL)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=TOL * float(b.abs().max()))


def test_ring_errors():
    q, k, v = (torch.from_numpy(a) for a in qkv(T=10))
    with pytest.raises(ValueError, match="does not divide"):
        ring_attention(q, k, v, seq_mesh(4))
    with pytest.raises(ValueError, match="no 'seq'"):
        ring_attention(q, k, v, default_mesh(2, "data", device="cpu"))
    with pytest.raises(ValueError, match="no 'ring'"):
        SequenceParallelAttention(MultiHeadAttention(n_in=8, n_heads=2),
                                  seq_mesh(2), "ring")
