"""The port's attention ops -- K5 flash attention forward, K8 flash decode
over a dense cache, K9 flash decode over a paged pool -- held against the
JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
compared with the JAX kernels in Pallas interpret mode (the way the JAX
package's own tests run them) and, at a ragged length the Pallas kernel
does not take, with the JAX layer's einsum path, from the same numpy
inputs. Tolerance 1e-4 on attention outputs and log-sum-exps: the same
float32 math, but the online softmax of the kernels and the full softmax
of the plain versions sum in different orders.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.nn.layers.attention import \
    scaled_dot_product_attention as jax_sdpa
from deeplearning4j_tpu.ops.flash_attention import _fa_fwd_call
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
@pytest.mark.parametrize("Dh", [8, 32])
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


@pytest.mark.parametrize("Dh", [8, 16])
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


@pytest.mark.parametrize("Dh", [8, 16])
def test_k9_plain_matches_interpreted_pallas_kernel(Dh,
                                                    jax_kernels_interpreted):
    """Shuffled page tables over a pool with a scratch block 0."""
    case = _paged_case(Dh=Dh)
    out = ops.flash_decode_step_paged(*map(torch.tensor, case))
    ref = jax_decode_paged(*map(jnp.asarray, case),
                           interpret=jops.interpret_mode())
    _close(out, ref)


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
    """Autograd through the plain version on the CPU (the CUDA wrapper
    raises under grad until the backward kernels are ported)."""
    q = torch.tensor(_rand((2, 5, 8), 1), requires_grad=True)
    ops.flash_attention(q, q, q, True).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


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
            ops.flash_decode_step_paged(case[0], case[1].double(),
                                        *case[2:])
    else:
        with pytest.raises(ValueError):
            ops.flash_decode_step_paged(*case[:3], case[3][:2], case[4])
