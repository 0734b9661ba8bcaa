"""The port's mixture of experts (parallel/expert_parallel.py) against the
JAX package's, on the CPU.

The JAX parameters (``init_moe_params`` from a PRNG key) are carried over
by ``moe_params_from_numpy``; tokens are numpy-seeded.

- ``moe_ffw``'s ``y`` and Switch ``aux`` against JAX's at a tight, the
  default and an ample capacity (1e-5), with the same dropped tokens;
- ``shard_moe_params`` over an ``("expert",)`` mesh of 4 slots: each
  slot runs its own experts; the sharded run against the unsharded one
  (1e-6) and JAX's sharded jit (1e-5);
- ``moe_ffw_dense_reference`` against JAX's and against ``moe_ffw`` at
  ample capacity (1e-5);
- SGD steps on loss + aux: gradients and parameters against ``jax.grad``
  (1e-5 of max |grad|);
- ``init_moe_params``' shapes and scales, and the errors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from deeplearning4j_tpu.parallel import expert_parallel as jep

from deeplearning4j_tpu_torch.parallel.expert_parallel import (
    init_moe_params, moe_ffw, moe_ffw_dense_reference, moe_params_from_numpy,
    shard_moe_params)
from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh

D, H, E = 8, 16, 4
TOL = 1e-5


def jax_params(seed=0):
    return jep.init_moe_params(jax.random.PRNGKey(seed), D, H, E)


def port(jp):
    return moe_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def tokens(n, seed):
    return np.random.RandomState(seed).randn(n, D).astype(np.float32)


def dropped(y):
    return np.all(np.asarray(y) == 0, axis=-1)


@pytest.mark.parametrize("cf,n,seed", [(0.25, 64, 2), (1.25, 32, 1),
                                       (4.0, 32, 1), (1.0, 48, 3)])
def test_moe_ffw_matches_jax(cf, n, seed):
    jp = jax_params(seed)
    x = tokens(n, seed)
    jy, jaux = jep.moe_ffw(jp, jnp.asarray(x), capacity_factor=cf)
    y, aux = moe_ffw(port(jp), torch.from_numpy(x), capacity_factor=cf)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    assert abs(float(aux) - float(jaux)) <= TOL * max(1.0, float(jaux))
    assert (dropped(y.numpy()) == dropped(jy)).all()
    if cf == 0.25:
        assert dropped(y.numpy()).any()


@pytest.mark.mesh8
def test_sharded_run_matches_unsharded_and_jax():
    jp = jax_params(3)
    x = tokens(32, 3)
    p = port(jp)
    sh = shard_moe_params(p, default_mesh(E, "expert", device="cpu"))
    assert sh["Wg"] is p["Wg"]
    assert [tuple(t.shape) for t in sh["W1"]] == [(1, D, H)] * E
    y_ref, aux_ref = moe_ffw(p, torch.from_numpy(x), capacity_factor=2.0)
    y, aux = moe_ffw(sh, torch.from_numpy(x), capacity_factor=2.0)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-6)
    assert float(aux) == float(aux_ref)
    jm = JaxMesh(np.array(jax.devices()[:E]), ("expert",))
    jsh = jep.shard_moe_params(jp, jm)
    with jax.sharding.use_mesh(jm) if hasattr(jax.sharding, "use_mesh") \
            else jm:
        jy, jaux = jax.jit(jep.moe_ffw, static_argnames="capacity_factor")(
            jsh, jnp.asarray(x), capacity_factor=2.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)
    # two experts a slot
    sh2 = shard_moe_params(p, default_mesh(2, "expert", device="cpu"))
    y2, _ = moe_ffw(sh2, torch.from_numpy(x), capacity_factor=2.0)
    np.testing.assert_allclose(y2.numpy(), y_ref.numpy(), atol=1e-6)


def test_dense_reference_matches_jax_and_ample_capacity():
    jp = jax_params(0)
    x = tokens(32, 1)
    want = np.asarray(jep.moe_ffw_dense_reference(jp, jnp.asarray(x)))
    p = port(jp)
    ref = moe_ffw_dense_reference(p, torch.from_numpy(x))
    np.testing.assert_allclose(ref.numpy(), want, atol=TOL)
    y, aux = moe_ffw(p, torch.from_numpy(x), capacity_factor=E * 1.0)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=TOL)
    assert float(aux) > 0
    sh = shard_moe_params(p, default_mesh(E, "expert", device="cpu"))
    np.testing.assert_allclose(moe_ffw_dense_reference(
        sh, torch.from_numpy(x)).numpy(), ref.numpy(), atol=1e-7)


def test_sgd_steps_on_loss_and_aux_match_jax():
    jp = jax_params(4)
    rs = np.random.RandomState(5)
    x = rs.randn(64, D).astype(np.float32)
    tgt = np.tanh(rs.randn(64, D)).astype(np.float32)

    def jloss(p):
        y, aux = jep.moe_ffw(p, jnp.asarray(x), capacity_factor=2.0)
        return jnp.mean((y - tgt) ** 2) + 0.01 * aux
    p = {k: v.clone() for k, v in port(jp).items()}
    sh = shard_moe_params(p, default_mesh(E, "expert", device="cpu"))
    for _ in range(3):
        jl, jg = jax.value_and_grad(jloss)(jp)
        leaves = {k: ([t.detach().requires_grad_() for t in v]
                      if isinstance(v, list) else v.detach().requires_grad_())
                  for k, v in sh.items()}
        y, aux = moe_ffw(leaves, torch.from_numpy(x), capacity_factor=2.0)
        loss = ((y - torch.from_numpy(tgt)) ** 2).mean() + 0.01 * aux
        flat = [t for v in leaves.values()
                for t in (v if isinstance(v, list) else [v])]
        grads = iter(torch.autograd.grad(loss, flat))
        assert abs(float(loss.detach()) - float(jl)) <= TOL * float(jl)
        for k, v in leaves.items():
            g = [next(grads) for _ in v] if isinstance(v, list) \
                else next(grads)
            full = torch.cat(g) if isinstance(g, list) else g
            want = np.asarray(jg[k])
            np.testing.assert_allclose(
                full.numpy(), want,
                atol=TOL * max(1e-3, float(np.abs(want).max())), err_msg=k)
            with torch.no_grad():
                for t, gg in (zip(sh[k], g) if isinstance(g, list)
                              else [(sh[k], g)]):
                    t.sub_(0.3 * gg)
        jp = jax.tree_util.tree_map(lambda a, b: a - 0.3 * b, jp, jg)
    for k in ("W1", "W2", "b1"):
        np.testing.assert_allclose(torch.cat(sh[k]).numpy(),
                                   np.asarray(jp[k]), atol=TOL)


def test_init_shapes_scales_and_errors():
    p = init_moe_params(0, 32, 64, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "Wg": (32, 8), "W1": (8, 32, 64), "b1": (8, 64),
        "W2": (8, 64, 32), "b2": (8, 32)}
    assert abs(float(p["W1"].std()) - 32 ** -0.5) < 0.02
    assert abs(float(p["W2"].std()) - 64 ** -0.5) < 0.02
    assert float(p["b1"].abs().sum()) == 0.0
    again = init_moe_params(torch.Generator().manual_seed(0), 32, 64, 8,
                            device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    with pytest.raises(ValueError, match="do not divide"):
        shard_moe_params(p, default_mesh(3, "expert", device="cpu"))
    with pytest.raises(ValueError, match="no 'expert'"):
        shard_moe_params(p, default_mesh(2, "data", device="cpu"))
