"""The port's GPipe schedule (parallel/pipeline.py) against the JAX
package's, on the CPU.

The JAX side runs its ``("pipe",)`` mesh on four of the forced host
devices; the port's on four CPU slots. The same numpy-seeded stages
(stacked by ``stack_stage_params`` in both packages) and microbatches go
through both.

- ``pipeline_forward`` against JAX's and the sequential stages (8 and 2
  microbatches; 1e-5);
- its gradients against ``jax.grad`` through JAX's schedule (1e-4 of max
  |grad|, the JAX test's rtol);
- ``PipelineParallel``: five ``fit_batch`` steps, their losses and the
  stages after, against JAX's trainer (1e-5), and ``forward``;
- the schedule runs exactly S * M stage calls a forward (no bubble
  ticks), and a TinyTransformer-block stage (the chip phase's) against
  the sequential blocks;
- JAX's errors.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from deeplearning4j_tpu.parallel import pipeline as jpp

from deeplearning4j_tpu_torch.nn.layers.attention import \
    scaled_dot_product_attention
from deeplearning4j_tpu_torch.parallel.pipeline import (
    PipelineParallel, pipeline_forward, shard_stages, split_microbatches,
    stack_stage_params)
from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh

S, F = 4, 16
TOL = 1e-5


def jax_mesh():
    return JaxMesh(np.array(jax.devices()[:S]), ("pipe",))


def mesh():
    return default_mesh(S, "pipe", device="cpu")


def stages(seed=0):
    rs = np.random.RandomState(seed)
    return [{"W": (rs.randn(F, F) / np.sqrt(F)).astype(np.float32),
             "b": (rs.randn(F) * 0.1).astype(np.float32)}
            for _ in range(S)]


def jax_stage(p, x):
    return jnp.tanh(x @ p["W"] + p["b"])


def stage(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def jax_stacked(st):
    return jpp.stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                   for s in st])


@pytest.mark.mesh8
@pytest.mark.parametrize("M,mb,seed", [(8, 3, 1), (2, 5, 2)])
def test_forward_matches_jax_and_sequential(M, mb, seed):
    st = stages(seed)
    x = np.random.RandomState(seed).randn(M, mb, F).astype(np.float32)
    want = np.asarray(jpp.pipeline_forward(
        jax_stage, jpp.shard_stages(jax_stacked(st), jax_mesh()),
        jnp.asarray(x), jax_mesh()))
    stacked = stack_stage_params(st, device="cpu")
    got = pipeline_forward(stage, shard_stages(stacked, mesh()),
                           torch.from_numpy(x), mesh())
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-6)
    seq = torch.from_numpy(x).reshape(M * mb, F)
    for p in shard_stages(stacked, mesh()):
        seq = stage(p, seq)
    np.testing.assert_allclose(got.numpy(), seq.reshape(M, mb, F).numpy(),
                               rtol=TOL, atol=1e-6)
    # the stacked tree directly, as JAX's takes it
    again = pipeline_forward(stage, stacked, torch.from_numpy(x), mesh())
    assert torch.equal(again, got)


@pytest.mark.mesh8
def test_gradients_match_jax_grad_through_the_schedule():
    st = stages(3)
    rs = np.random.RandomState(4)
    x = rs.randn(4, 3, F).astype(np.float32)
    tgt = rs.randn(12, F).astype(np.float32)

    def jloss(params):
        out = jpp.pipeline_forward(jax_stage, params, jnp.asarray(x),
                                   jax_mesh())
        return jnp.mean((out.reshape(12, F) - tgt) ** 2)
    want = jax.grad(jloss)(jpp.shard_stages(jax_stacked(st), jax_mesh()))
    stacked = {k: v.requires_grad_() for k, v in
               stack_stage_params(st, device="cpu").items()}
    out = pipeline_forward(stage, shard_stages(stacked, mesh()),
                           torch.from_numpy(x), mesh())
    loss = ((out.reshape(12, F) - torch.from_numpy(tgt)) ** 2).mean()
    got = torch.autograd.grad(loss, [stacked["W"], stacked["b"]])
    for k, g in zip(("W", "b"), got):
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.mesh8
def test_trainer_matches_jax():
    st = stages(5)
    rs = np.random.RandomState(6)
    x = rs.randn(16, F).astype(np.float32)
    t = (np.tanh(rs.randn(16, F)) * 0.5).astype(np.float32)
    jst = [{k: jnp.asarray(v) for k, v in s.items()} for s in st]
    jtr = jpp.PipelineParallel(jax_stage, lambda y, tt: jnp.mean((y - tt)
                                                                 ** 2),
                               jst, jax_mesh(), learning_rate=0.2,
                               num_microbatches=4)
    tr = PipelineParallel(stage, lambda y, tt: ((y - tt) ** 2).mean(), st,
                          mesh(), learning_rate=0.2, num_microbatches=4,
                          device="cpu")
    for _ in range(5):
        want = float(jtr.fit_batch(x, t))
        got = float(tr.fit_batch(x, t))
        assert math.isclose(got, want, rel_tol=TOL), (got, want)
    for k in ("W", "b"):
        np.testing.assert_allclose(tr.params[k].numpy(),
                                   np.asarray(jtr.params[k]), rtol=TOL,
                                   atol=1e-6)
    np.testing.assert_allclose(tr.forward(x).numpy(),
                               np.asarray(jtr.forward(x)), rtol=TOL,
                               atol=1e-6)
    assert tr.forward(x).shape == (16, F)


def test_schedule_runs_each_stage_once_a_microbatch():
    """S * M stage calls a forward, stage s on microbatch t - s at tick t
    (0 <= t - s < M), never on a bubble."""
    calls = []

    def spy(p, x):
        calls.append(int(p["id"]))
        return x + p["id"]
    stacked = {"id": torch.arange(S, dtype=torch.float32)}
    xs = torch.zeros(6, 2, 3)
    out = pipeline_forward(spy, stacked, xs, mesh())
    assert len(calls) == S * 6 and sorted(set(calls)) == list(range(S))
    assert torch.equal(out, torch.full((6, 2, 3), float(sum(range(S)))))
    # the first ticks: stage 0 alone, then stages 0-1, 0-2
    assert calls[:6] == [0, 0, 1, 0, 1, 2]


def block_params(gen, D=16, Hf=64):
    def w(*shape):
        return torch.randn(shape, generator=gen) / math.sqrt(shape[0])
    return {"ln1_g": torch.ones(D), "ln1_b": torch.zeros(D),
            "Wq": w(D, D), "Wk": w(D, D), "Wv": w(D, D), "Wo": w(D, D),
            "bq": torch.zeros(D), "bk": torch.zeros(D), "bv": torch.zeros(D),
            "bo": torch.zeros(D), "ln2_g": torch.ones(D),
            "ln2_b": torch.zeros(D), "W1": w(D, Hf), "b1": torch.zeros(Hf),
            "W2": w(Hf, D), "b2": torch.zeros(D)}


def block(p, x, heads=2):
    """One pre-LN TinyTransformer block (ln1, causal attention, residual,
    ln2, ff1 gelu, ff2, residual)."""
    B, T, D = x.shape

    def ln(h, g, b):
        return torch.nn.functional.layer_norm(h, (D,), g, b, 1e-5)
    h = ln(x, p["ln1_g"], p["ln1_b"])
    q, k, v = ((h @ p[f"W{n}"] + p[f"b{n}"]).reshape(B, T, heads, -1)
               for n in "qkv")
    o = scaled_dot_product_attention(q, k, v, causal=True)
    x = x + o.reshape(B, T, D) @ p["Wo"] + p["bo"]
    h = ln(x, p["ln2_g"], p["ln2_b"])
    f = torch.nn.functional.gelu(h @ p["W1"] + p["b1"], approximate="tanh")
    return x + f @ p["W2"] + p["b2"]


def test_transformer_block_stages_match_the_sequential_blocks():
    gen = torch.Generator().manual_seed(0)
    st = [block_params(gen) for _ in range(S)]
    stacked = stack_stage_params(st)
    x = torch.randn(8, 8, 16, generator=gen)
    xs = split_microbatches(x, 4)
    got = pipeline_forward(block, shard_stages(stacked, mesh()), xs, mesh())
    want = x
    for p in st:
        want = block(p, want)
    np.testing.assert_allclose(got.reshape(8, 8, 16).numpy(), want.numpy(),
                               rtol=TOL, atol=1e-6)


def test_errors_match_jax():
    with pytest.raises(ValueError) as want:
        jpp.split_microbatches(np.zeros((10, 3)), 4)
    with pytest.raises(ValueError) as got:
        split_microbatches(torch.zeros(10, 3), 4)
    assert str(got.value) == str(want.value)
    stacked = stack_stage_params(stages()[:3], device="cpu")
    with pytest.raises(ValueError, match="3 stages but the 'pipe' mesh axis"
                       " has 4 devices"):
        pipeline_forward(stage, stacked, torch.zeros(2, 1, F), mesh())
    with pytest.raises(ValueError, match="3 stages"):
        shard_stages(stacked, mesh())
    with pytest.raises(ValueError, match="3 stages"):
        PipelineParallel(stage, None, stages()[:3], mesh(), device="cpu")
    with pytest.raises(ValueError, match="one tree structure"):
        stack_stage_params([{"W": np.zeros(2)}, {"V": np.zeros(2)}],
                           device="cpu")
