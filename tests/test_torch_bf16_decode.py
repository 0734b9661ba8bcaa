"""Decoding a bfloat16-compute model in the port (a graph whose
``compute_dtype`` is bfloat16 keeps its KV cache or block pool in
bfloat16), held against the JAX package on the CPU.

- K8 and K9 read such a cache in its own type; their plain versions widen
  it exactly (``.float()``), so they match the JAX kernels
  (``flash_decode_step`` and ``flash_decode_step_paged`` in interpret
  mode, which widen at the kernel's boundary) within 1e-5, the float32
  tolerance of a summation order.
- A bfloat16 TinyTransformer (2 blocks of d_model 32, 2 heads) decodes on
  the port's dense and paged engines: ``DecodeEngine(net).start()``
  serves, its decode state is bfloat16, and its greedy tokens equal the
  JAX engine's, except where the two first differ at a near-tie: the JAX
  model's top-2 probability gap at that step at most 0.02 (bfloat16 keeps
  8 bits; the frameworks round its products and sums at different
  places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.flash_decode import \
    flash_decode_step as jax_decode
from deeplearning4j_tpu.ops.flash_decode import \
    flash_decode_step_paged as jax_paged
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import decode_cuda
from deeplearning4j_tpu_torch.serving import DecodeEngine
from test_torch_kv_prefix import MAXLEN, V, prompts
from test_torch_regularised_training import port_of

PLAIN_TOL = 1e-5
TIE_MARGIN = 2e-2       # bfloat16 top-2 probability gap that may flip a token


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bf16_pair(a):
    """The same bfloat16 values in both packages: rounded by torch, handed
    to JAX as float32 (exact) and cast there (exact again)."""
    t = torch.tensor(a).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("B,H,Dh,C", [(2, 2, 16, 64), (3, 4, 32, 128),
                                      (1, 2, 8, 16), (4, 1, 128, 96)])
def test_plain_k8_on_bfloat16_caches_matches_jax(B, H, Dh, C):
    q = _rand((B, H, Dh), 0)
    kc, jkc = _bf16_pair(_rand((B, C, H, Dh), 1))
    vc, jvc = _bf16_pair(_rand((B, C, H, Dh), 2))
    pos = np.random.default_rng(3).integers(0, C, B).astype(np.int32)
    before = ops.launch_counts()
    got = ops.flash_decode_step(torch.tensor(q), kc, vc, torch.tensor(pos))
    assert ops.launch_counts() == before       # the CPU runs the plain one
    assert got.dtype == torch.float32
    want = jax_decode(jnp.asarray(q), jkc, jvc, jnp.asarray(pos),
                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_TOL, rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), decode_cuda.flash_decode_step_plain(
            torch.tensor(q), kc.float(), vc.float(),
            torch.tensor(pos)).numpy())


@pytest.mark.parametrize("B,H,Dh,bs,MB", [(2, 2, 16, 8, 4), (3, 4, 32, 16, 4),
                                          (1, 1, 8, 4, 5)])
def test_plain_k9_on_bfloat16_pools_matches_jax(B, H, Dh, bs, MB):
    NB = B * MB + 1
    q = _rand((B, H, Dh), 4)
    pk, jpk = _bf16_pair(_rand((NB, bs, H, Dh), 5))
    pv, jpv = _bf16_pair(_rand((NB, bs, H, Dh), 6))
    rng = np.random.default_rng(7)
    tables = (rng.permutation(NB - 1)[:B * MB] + 1).reshape(B, MB).astype(
        np.int32)
    pos = rng.integers(0, MB * bs, B).astype(np.int32)
    got = ops.flash_decode_step_paged(torch.tensor(q), pk, pv,
                                      torch.tensor(pos), torch.tensor(tables))
    want = jax_paged(jnp.asarray(q), jpk, jpv, jnp.asarray(pos),
                     jnp.asarray(tables), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PLAIN_TOL, rtol=0)


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    """float16 caches, K and V of two types, a bfloat16 query: refused
    before any launch, on every device."""
    q = torch.zeros(1, 1, 8)
    kc = torch.zeros(1, 4, 1, 8)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_decode_step(q, kc.half(), kc.half(), pos)
    with pytest.raises(TypeError, match="one dtype"):
        ops.flash_decode_step(q, kc.bfloat16(), kc, pos)
    with pytest.raises(TypeError, match="q is"):
        ops.flash_decode_step(q.bfloat16(), kc, kc, pos)


@pytest.fixture(scope="module")
def bf16_tiny():
    from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny
    jnet = JaxTiny(vocab_size=V, n_layers=2, d_model=32, n_heads=2,
                   max_len=MAXLEN, seed=7, compute_dtype="bfloat16").init()
    return jnet, port_of(jnet)


def _first_tie(jnet, prompt, got, want):
    """Where the port's tokens first leave the JAX engine's: the JAX
    model's top-2 probability gap at that step (0 when equal)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            seq = list(prompt) + list(want[:i])
            x = np.eye(V, dtype=np.float32)[seq][None]
            p = np.sort(np.asarray(jnet.output(x), np.float32)[0, -1])
            return float(p[-1] - p[-2])
    return 0.0


def test_a_bfloat16_engine_starts_and_serves(bf16_tiny):
    """Before the bfloat16 K8 / K9 the port's ``start()`` raised
    TypeError on such a model."""
    _, net = bf16_tiny
    eng = DecodeEngine(net).start()
    try:
        out = eng.generate([1, 2, 3], max_new_tokens=4, timeout=120)
        state = eng._dstate
    finally:
        eng.stop()
    assert len(out["tokens"]) == 4
    assert {state[n]["k"].dtype for n in ("b0_attn", "b1_attn")} == \
        {torch.bfloat16}


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_bfloat16_greedy_tokens_match_jax(bf16_tiny, kv):
    jnet, net = bf16_tiny
    ps = prompts((3, 9, 17, 30), seed=2)
    kw = dict(slots=4, max_len=MAXLEN, kv=kv, kv_block_size=16)
    eng = DecodeEngine(net, **kw).start()
    jeng = JaxDecode(jnet, **kw).start()
    try:
        futs = [eng.submit(p, max_new_tokens=12) for p in ps]
        got = [f.result(timeout=120)["tokens"] for f in futs]
        want = [jeng.generate(p, max_new_tokens=12)["tokens"] for p in ps]
        pool = eng._dstate["b0_attn"]["pk" if kv == "paged" else "k"]
    finally:
        eng.stop()
        jeng.stop()
    assert pool.dtype == torch.bfloat16
    for p, g, w in zip(ps, got, want):
        assert _first_tie(jnet, p, g, w) <= TIE_MARGIN, (p, g, w)
    assert eng.trace_count == 1
