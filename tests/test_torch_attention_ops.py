"""The port's attention ops -- K5 flash attention forward, K6 and K7 its
backward (dq; dk and dv), K8 flash decode over a dense cache, K9 flash
decode over a paged pool -- held against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
compared with the JAX kernels in Pallas interpret mode (the way the JAX
package's own tests run them) and, at a ragged length the Pallas kernel
does not take, with the JAX layer's einsum path, from the same numpy
inputs. Tolerance 1e-4 on attention outputs, log-sum-exps and gradients:
the same float32 math, but the online softmax of the kernels and the full
softmax of the plain versions sum in different orders. The backward's
plain version is also held against autograd through the plain forward
(1e-5, float32, at a ragged length too) and checked by
``torch.autograd.gradcheck`` in float64 (its default tolerances).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py. The arithmetic
the backward kernels run on the card's tensor cores (3xTF32 products) is
emulated here in numpy and held against float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.nn.layers.attention import \
    scaled_dot_product_attention as jax_sdpa
from deeplearning4j_tpu.ops.flash_attention import (_fa_fwd_call,
                                                     flash_attention as
                                                     jax_flash_attention)
from deeplearning4j_tpu.ops.flash_decode import (
    flash_decode_step as jax_decode,
    flash_decode_step_paged as jax_decode_paged)
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import attention_cuda, decode_cuda

TOL = 1e-4


@pytest.fixture
def jax_kernels_interpreted():
    jops.set_helpers_enabled(True, interpret=True)
    yield
    jops.set_helpers_enabled(None)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Dh", [8, 32, 136, 256, 520])
@pytest.mark.parametrize("T", [8, 16, 64])
@pytest.mark.parametrize("BH", [1, 3])
def test_k5_plain_matches_interpreted_pallas_kernel(BH, T, Dh, causal,
                                                    jax_kernels_interpreted):
    q, k, v = (_rand((BH, T, Dh), s) for s in (1, 2, 3))
    o, lse = ops.flash_attention_fwd(*map(torch.tensor, (q, k, v)), causal)
    ref_o, ref_lse = _fa_fwd_call(*map(jnp.asarray, (q, k, v)), causal,
                                  jops.interpret_mode())
    assert tuple(o.shape) == (BH, T, Dh) and tuple(lse.shape) == (BH, T)
    _close(o, ref_o)
    _close(lse, np.asarray(ref_lse)[..., 0])
    _close(ops.flash_attention(*map(torch.tensor, (q, k, v)), causal), ref_o)


@pytest.mark.parametrize("causal", [False, True])
def test_k5_plain_matches_the_einsum_path_at_a_ragged_length(causal):
    """T = 13 is no multiple of the Pallas kernel's blocks, so the JAX layer
    takes its einsum path there; the CUDA kernel takes any T."""
    B, T, H, Dh = 2, 13, 3, 8
    q, k, v = (_rand((B, T, H, Dh), s) for s in (4, 5, 6))
    ref = jax_sdpa(*map(jnp.asarray, (q, k, v)), causal=causal)

    def fold(a):
        return torch.tensor(a).permute(0, 2, 1, 3).reshape(B * H, T, Dh)
    o = ops.flash_attention(fold(q), fold(k), fold(v), causal)
    _close(o.reshape(B, H, T, Dh).permute(0, 2, 1, 3), ref)


@pytest.mark.parametrize("Dh", [8, 16, 136, 256, 520])
def test_k8_plain_matches_interpreted_pallas_kernel(Dh,
                                                    jax_kernels_interpreted):
    """pos at the first row, in the middle and at the last row."""
    B, H, C = 3, 2, 64
    q = _rand((B, H, Dh), 7)
    kc, vc = _rand((B, C, H, Dh), 8), _rand((B, C, H, Dh), 9)
    pos = np.array([0, 31, C - 1], np.int32)
    out = ops.flash_decode_step(*map(torch.tensor, (q, kc, vc, pos)))
    ref = jax_decode(*map(jnp.asarray, (q, kc, vc, pos)),
                     interpret=jops.interpret_mode())
    assert tuple(out.shape) == (B, H, Dh)
    _close(out, ref)


def _paged_case(B=3, H=2, Dh=8, bs=8, MB=4, seed=10):
    NB = B * MB + 1
    r = np.random.RandomState(seed)
    q = _rand((B, H, Dh), seed)
    pk, pv = _rand((NB, bs, H, Dh), seed + 1), _rand((NB, bs, H, Dh),
                                                      seed + 2)
    tables = (r.permutation(NB - 1)[:B * MB] + 1).reshape(B, MB)
    pos = np.array([0, 13, MB * bs - 1], np.int32)[:B]
    return q, pk, pv, pos, tables.astype(np.int32)


@pytest.mark.parametrize("Dh", [8, 16, 136, 256, 520])
def test_k9_plain_matches_interpreted_pallas_kernel(Dh,
                                                    jax_kernels_interpreted):
    """Shuffled page tables over a pool with a scratch block 0."""
    case = _paged_case(Dh=Dh)
    out = ops.flash_decode_step_paged(*map(torch.tensor, case))
    ref = jax_decode_paged(*map(jnp.asarray, case),
                           interpret=jops.interpret_mode())
    _close(out, ref)


def test_head_dim_screen_matches_the_jax_screens():
    """``ops.head_dim_supported``, the head-dim screen the kernel wrappers
    and the attention layer both call, takes exactly the head dims the JAX
    package's three flash screens take where their VMEM budgets hold (T,
    C = 64, blocks of 8): the multiples of 8."""
    from deeplearning4j_tpu.ops.flash_attention import supported as fa
    from deeplearning4j_tpu.ops.flash_decode import (supported as dec,
                                                     supported_paged as paged)
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    for Dh in range(1, 601):
        port = ops.head_dim_supported(Dh)
        assert [fa(64, Dh), dec(64, Dh), paged(8, Dh)] == [port] * 3, Dh
        layer = MultiHeadAttention(n_in=2 * Dh, n_heads=2)
        assert layer.head_dim == Dh and layer.flash_supported() == port
    assert sum(map(ops.head_dim_supported, range(1, 601))) == 75


def test_k9_plain_is_k8_plain_on_the_gathered_cache():
    q, pk, pv, pos, tables = map(torch.tensor, _paged_case())
    kc = decode_cuda.gather_pages(pk, tables)
    vc = decode_cuda.gather_pages(pv, tables)
    assert tuple(kc.shape) == (3, 32, 2, 8)
    assert torch.equal(kc[1, 8:16], pk[tables[1, 1].long()])
    assert torch.equal(
        ops.flash_decode_step_paged(q, pk, pv, pos, tables),
        decode_cuda.flash_decode_step_plain(q, kc, vc, pos))


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    q = torch.tensor(_rand((2, 8, 8), 0))
    o, lse = ops.flash_attention_fwd(q, q, q, True)
    ref = attention_cuda.flash_attention_fwd_plain(q, q, q, True)
    assert torch.equal(o, ref[0]) and torch.equal(lse, ref[1])
    ops.flash_decode_step_paged(*map(torch.tensor, _paged_case()))
    assert ops.launch_counts() == {}


def test_cpu_plain_attention_differentiates():
    """Autograd through ``FlashAttention`` on the CPU: its backward runs the
    plain K6/K7, and one tensor fed as q, k and v gets the sum of the
    three gradients."""
    q = torch.tensor(_rand((2, 5, 8), 1), requires_grad=True)
    ops.flash_attention(q, q, q, True).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    ref = q.detach().clone().requires_grad_()
    attention_cuda.flash_attention_fwd_plain(ref, ref, ref, True)[0] \
        .sum().backward()
    _close(q.grad, ref.grad.numpy(), tol=1e-5)


def _bwd_case(BH, T, Dh, causal, seed=20):
    q, k, v, do = (torch.tensor(_rand((BH, T, Dh), seed + s))
                   for s in range(4))
    o, lse = attention_cuda.flash_attention_fwd_plain(q, k, v, causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Dh", [8, 32, 136, 256, 520])
@pytest.mark.parametrize("T", [8, 16, 64])
@pytest.mark.parametrize("BH", [1, 3])
def test_k6_k7_plain_matches_interpreted_pallas_backward(
        BH, T, Dh, causal, jax_kernels_interpreted):
    """``jax.vjp`` of the JAX package's flash_attention runs _fa_bwd: K6
    and K7 interpreted."""
    q, k, v, o, lse, do = _bwd_case(BH, T, Dh, causal)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash_attention(a, b, c, causal,
                                            jops.interpret_mode()),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for got, ref in zip(grads, vjp(jnp.asarray(do.numpy()))):
        assert tuple(got.shape) == (BH, T, Dh)
        _close(got, ref)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [13, 64])
def test_k6_k7_plain_matches_autograd_of_the_plain_forward(T, causal):
    """T = 13 is no multiple of the Pallas kernel's blocks (the CUDA kernels
    take it, masking the ragged tail)."""
    q, k, v, _, _, do = _bwd_case(3, T, 8, causal, seed=30)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = attention_cuda.flash_attention_fwd_plain(*leaves, causal)
    ref = torch.autograd.grad(o, leaves, do)
    got = ops.flash_attention_bwd(q, k, v, o.detach(), lse.detach(), do,
                                  causal)
    for g, r in zip(got, ref):
        _close(g, r.numpy(), tol=1e-5)


class _PlainPair(torch.autograd.Function):
    """K5's and K6/K7's plain versions as one function, in any float type
    (the wrappers take float32 only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = attention_cuda.flash_attention_fwd_plain(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return attention_cuda.flash_attention_bwd_plain(
            *ctx.saved_tensors, do, ctx.causal) + (None,)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_pair_passes_gradcheck_in_float64(causal):
    r = np.random.RandomState(40)
    q, k, v = (torch.tensor(r.randn(2, 7, 8), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: _PlainPair.apply(a, b, c, causal), (q, k, v))


def test_flash_attention_function_on_cpu_launches_nothing():
    """Under grad ``flash_attention`` records ``FlashAttention``; on CPU
    tensors its forward and backward are the plain versions, bit for bit,
    and no kernel is counted."""
    q, k, v, o, lse, do = _bwd_case(2, 16, 8, True, seed=50)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, True)
    assert out.grad_fn is not None \
        and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), o)
    out.backward(do)
    want = attention_cuda.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    True)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        assert ops.flash_attention(*leaves, True).grad_fn is None
    assert ops.launch_counts() == {}


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest at 10
    mantissa bits, ties away from zero (the float32 bit pattern is
    sign-magnitude, so adding half of the dropped range rounds the
    magnitude)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def _tf32_matmul(a, b, split):
    """A float32 product on TF32 tensor cores: one product of the rounded
    operands, or with ``split`` the 3xTF32 sum small*big + big*small +
    big*big (big = tf32(x), small = tf32(x - big)) the backward kernels
    use. The products of TF32 values are exact in float32; the sums are
    float32."""
    ab, bb = _tf32(a), _tf32(b)
    if not split:
        return ab @ bb
    return (_tf32(a - ab) @ bb + ab @ _tf32(b - bb)) + ab @ bb


def _tf32_backward_error(T, causal, split, BH=4, Dh=32, seed=60):
    """K6 and K7's arithmetic (s = q k^T, dp = do v^T, dq = ds k, dk = ds^T
    q, dv = p^T do through ``_tf32_matmul``; exp, delta and the rest in
    float32, from a float32 lse) against the float64 gradients, relative to
    the largest of them."""
    r = np.random.RandomState(seed)
    q, k, v, do = (r.randn(BH, T, Dh).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(Dh)
    keep = np.tril(np.ones((T, T), bool)) if causal else np.ones((T, T),
                                                                  bool)
    Q, K, V, DO = (a.astype(np.float64) for a in (q, k, v, do))
    s = np.where(keep, Q @ K.transpose(0, 2, 1) * scale, -np.inf)
    m = s.max(-1, keepdims=True)
    lse = np.log(np.exp(s - m).sum(-1)) + m[..., 0]
    p = np.exp(s - lse[..., None])
    o = p @ V
    ds = p * (DO @ V.transpose(0, 2, 1) - (DO * o).sum(-1)[..., None])
    want = (ds @ K * scale, ds.transpose(0, 2, 1) @ Q * scale,
            p.transpose(0, 2, 1) @ DO)

    o32, sc = o.astype(np.float32), np.float32(scale)
    delta = (do * o32).sum(-1, dtype=np.float32)
    s32 = _tf32_matmul(q, k.transpose(0, 2, 1), split) * sc
    p32 = np.where(keep, np.exp(s32 - lse.astype(np.float32)[..., None]),
                   np.float32(0))
    dp32 = _tf32_matmul(do, v.transpose(0, 2, 1), split)
    ds32 = p32 * (dp32 - delta[..., None])
    got = (_tf32_matmul(ds32, k, split) * sc,
           _tf32_matmul(ds32.transpose(0, 2, 1), q, split) * sc,
           _tf32_matmul(p32.transpose(0, 2, 1), do, split))
    largest = max(np.abs(w).max() for w in want)
    return max(np.abs(g - w).max() for g, w in zip(got, want)) / largest


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [64, 512])
def test_3xtf32_products_keep_the_backward_float32_accurate(T, causal):
    """The precision argument of csrc/flash_attn_bwd.cu, checked where there
    is no card: with every product split 3xTF32, dq, dk and dv stay within
    1e-5 of the float64 result, relative to the largest gradient, well
    inside the kernels' 1e-4 bar; a single TF32 product per pair does not
    stay within 1e-4 (about 4-9e-4 here), so the split is what the bar
    needs. The emulation sums in float32 rounded to nearest: it leaves out
    the tensor cores' truncating accumulation, which the kernels answer
    with their split accumulators and which chip_smoke.py's card-against-
    CPU parameter bar at T=512 guards."""
    assert _tf32(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)
    assert _tf32(np.float32(-(1 + 2 ** -12))) == np.float32(-1)
    assert _tf32_backward_error(T, causal, split=True) <= 1e-5
    assert _tf32_backward_error(T, causal, split=False) > 1e-4


def _toward_zero(x):
    """float64 x rounded to float32 toward zero: how the tensor cores add a
    product to an accumulator, as modelled here (not to nearest, so the
    error keeps one sign)."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x),
                    np.nextafter(f, np.float32(0)), f)


def _tc_scores(q, k, steps, truncate=True):
    """q k^T as the attention kernels form it on the tensor cores: 3xTF32
    products of 8 columns (exact), the small ones summed in an accumulator
    of their own, the big ones ``steps`` 8-column steps at a time from zero
    and each partial sum added to the scores in float32."""
    qb, kb = _tf32(q), _tf32(k)
    qs, ks = _tf32(q - qb), _tf32(k - kb)

    def prod(a, b, c0):
        return np.einsum("btd,bsd->bts", a[..., c0:c0 + 8].astype(np.float64),
                         b[..., c0:c0 + 8].astype(np.float64))
    add = _toward_zero if truncate else (lambda x: x.astype(np.float32))
    shape = q.shape[:2] + k.shape[1:2]
    s, big, small = (np.zeros(shape, np.float32) for _ in range(3))
    for i, c0 in enumerate(range(0, q.shape[-1], 8)):
        small = add(small + prod(qs, kb, c0) + prod(qb, ks, c0))
        big = add(big + prod(qb, kb, c0))
        if (i + 1) % steps == 0:
            s, big = s + big, np.zeros(shape, np.float32)
    return s + big + small


@pytest.mark.parametrize("seed", [70, 71])
def test_partial_score_sums_keep_wide_heads_float32_accurate(seed):
    """The accumulation argument of csrc/flash_attn_fwd.cu (and of the
    column-chunk split in csrc/flash_attn_bwd.cu), checked where there is
    no card: at Dh 256 with scores of a few hundred, one truncating
    accumulator over the 32 steps of a row carries several times the error
    of the same products summed to nearest, while partial sums of
    SCORE_STEPS = 4 steps (32 columns) added in float32 carry no more than
    that."""
    r = np.random.RandomState(seed)
    q, k = ((r.randn(2, 16, 256) * 2.5).astype(np.float32) for _ in range(2))
    want = np.einsum("btd,bsd->bts", q.astype(np.float64),
                     k.astype(np.float64))

    def err(s):
        return np.abs(s - want).max()
    nearest = err(_tc_scores(q, k, 32, truncate=False))
    assert err(_tc_scores(q, k, 32)) > 3 * nearest
    assert err(_tc_scores(q, k, 4)) <= 1.25 * nearest


@pytest.mark.parametrize("bad", ["shape", "float64", "pos_shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    q = torch.tensor(_rand((2, 4, 8), 0))
    case = list(map(torch.tensor, _paged_case()))
    if bad == "shape":
        with pytest.raises(ValueError):
            ops.flash_attention(q, q[:, :3], q)
        with pytest.raises(ValueError):
            ops.flash_decode_step_paged(case[0][:, :1], *case[1:])
    elif bad == "float64":
        with pytest.raises(TypeError):
            ops.flash_attention(q.double(), q.double(), q.double())
        with pytest.raises(TypeError):
            ops.flash_attention(*(q.double().requires_grad_()
                                  for _ in range(3)))
        with pytest.raises(TypeError):
            ops.flash_attention_bwd(*(q.double() for _ in range(4)),
                                    q[..., 0].double(), q.double())
        with pytest.raises(TypeError):
            ops.flash_decode_step_paged(case[0], case[1].double(),
                                        *case[2:])
    else:
        with pytest.raises(ValueError):
            ops.flash_decode_step_paged(*case[:3], case[3][:2], case[4])
