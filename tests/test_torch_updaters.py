"""The port's updaters, schedules, gradient normalization and losses held
against the JAX package's (optax) on the same numpy inputs, on the CPU.

Updaters run five steps on the same gradient sequence, which includes
gradients of ~1e-9 (where Adam's eps matters and a sign difference would
move a parameter by ~lr). Parameters and every state array must agree to
1e-6 absolute and relative: the formulas are the same float32 operations,
and only a square root, a power or a reciprocal square root may differ by
an ulp between XLA and PyTorch. The state must sit under the same
checkpoint keys. Losses agree to 1e-6 relative (float32 sums in another
order), and their gradients to 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.util.model_serializer import _flatten_pytree

from deeplearning4j_tpu_torch.nn import losses, updaters as upd

SCHEDULES = {
    "constant": {},
    "exponential": {"decay_rate": 0.7},
    "inverse": {"gamma": 0.5, "power": 0.75},
    "poly": {"max_iter": 4.0, "power": 2.0},
    "sigmoid": {"gamma": 0.9, "steps": 2.0},
    "step": {"decay_rate": 0.5, "steps": 2.0},
    "map": {"values": {1: 0.02, 3: 0.005}},
}
KINDS = sorted(upd.UPDATERS)


def _params_and_grads(seed=0, steps=5):
    r = np.random.RandomState(seed)
    p = {"W": r.randn(4, 6).astype(np.float32),
         "RW": r.randn(6, 6).astype(np.float32),
         "b": r.randn(6).astype(np.float32)}
    gs = []
    for s in range(steps):
        g = {k: (r.randn(*v.shape) * 0.3).astype(np.float32)
             for k, v in p.items()}
        g["W"][0, :3] = np.float32([1e-9, -1e-9, 0.0])   # eps regime
        g["b"][:2] *= np.float32(1e-4) * (s + 1)
        gs.append(g)
    return p, gs


def _both(kind, schedule=None, **kw):
    jcls, pcls = jupd.UPDATERS[kind], upd.UPDATERS[kind]
    js = None if schedule is None else jupd.Schedule(**schedule)
    ps = None if schedule is None else upd.Schedule(**schedule)
    return jcls(schedule=js, **kw), pcls(schedule=ps, **kw)


def _run(jtx, ptx, steps=5):
    p, gs = _params_and_grads(steps=steps)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jst, tst = jtx.init(jp), ptx.init(tp)
    for g in gs:
        u, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, u)
        tu, tst = ptx.update({k: torch.tensor(v) for k, v in g.items()}, tst,
                             tp)
        tp = {k: v + tu[k] for k, v in tp.items()}
    return jp, jst, tp, tst


def _assert_same(jp, jst, tp, tst):
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    flat = {k[2:]: v for k, v in _flatten_pytree([jst]).items()}
    assert sorted(flat) == sorted(tst)
    for k, v in flat.items():
        assert tst[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_allclose(tst[k].numpy(), v, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_every_updater_matches_optax(kind):
    jtx, ptx = _both(kind)
    _assert_same(*_run(jtx.to_optax(), ptx.transform()))


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("kind", ["Adam", "Nesterovs", "Sgd"])
def test_every_schedule_matches_optax(kind, schedule):
    sched = {"kind": schedule, "initial": 0.01, **SCHEDULES[schedule]}
    jtx, ptx = _both(kind, sched)
    _assert_same(*_run(jtx.to_optax(), ptx.transform()))


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_rates_match_jax(schedule):
    sched = {"kind": schedule, "initial": 0.01, **SCHEDULES[schedule]}
    jfn = jupd.Schedule(**sched).to_optax()
    mine = upd.Schedule(**sched)
    for it in range(6):
        want = jfn if not callable(jfn) else jfn(jnp.asarray(it, jnp.int32))
        np.testing.assert_allclose(mine.lr(it), float(want), rtol=1e-6)


@pytest.mark.parametrize("chain", [
    {"l2": 0.01}, {"grad_clip_value": 0.2}, {"grad_norm_threshold": 0.5},
    {"l2": 0.01, "grad_clip_value": 0.2, "grad_norm_threshold": 0.5}])
def test_gradient_transform_order_matches_optax(chain):
    """L2, then clip, then the global-norm clip, then the updater."""
    jtx, ptx = _both("Adam", learning_rate=0.01)
    _assert_same(*_run(jupd.make_gradient_transform(jtx, **chain),
                       upd.make_gradient_transform(ptx, **chain)))


def test_updater_json_round_trip_is_the_jax_document():
    for kind in KINDS:
        j, p = _both(kind, {"kind": "step", "initial": 0.1,
                            "decay_rate": 0.5, "steps": 3.0})
        assert p.to_dict() == j.to_dict()
        assert upd.Updater.from_dict(j.to_dict()) == p
    m = upd.Schedule(kind="map", values={2: 0.1})
    assert upd.Schedule.from_dict({**m.to_dict(),
                                   "values": {"2": 0.1}}) == m


@pytest.mark.parametrize("kind", [
    None, "None", "ClipElementWiseAbsoluteValue", "ClipL2PerLayer",
    "RenormalizeL2PerLayer", "ClipL2PerParamType",
    "RenormalizeL2PerParamType", "SomethingElse"])
def test_gradient_normalization_matches_jax(kind):
    _, gs = _params_and_grads(seed=3, steps=1)
    g = {k: v * 4 for k, v in gs[0].items()}
    want = jupd.normalize_layer_grad({k: jnp.asarray(v) for k, v in g.items()},
                                     kind, 0.5)
    got = upd.normalize_layer_grad({k: torch.tensor(v) for k, v in g.items()},
                                   kind, 0.5)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert upd.normalize_layer_grad({}, kind, 0.5) == {}


# ------------------------------------------------------------------ losses

def _loss_case(name, seed=0, B=5, C=4):
    r = np.random.RandomState(seed)
    pre = (r.randn(B, C) * 1.5).astype(np.float32)
    if name in ("mcxent", "negativeloglikelihood", "kldivergence",
                "kl_divergence"):
        lab = np.eye(C, dtype=np.float32)[r.randint(0, C, B)]
    elif name == "xent":
        lab = r.randint(0, 2, (B, C)).astype(np.float32)
    elif name in ("hinge", "squaredhinge"):
        lab = (r.randint(0, 2, (B, C)) * 2 - 1).astype(np.float32)
    else:
        lab = np.abs(r.randn(B, C)).astype(np.float32) + 0.1
    act = {"mcxent": "softmax", "negativeloglikelihood": "softmax",
           "kldivergence": "softmax", "kl_divergence": "softmax",
           "xent": "sigmoid", "poisson": "softplus",
           "meansquaredlogarithmicerror": "softplus",
           "msle": "softplus"}.get(name, "identity")
    mask = (r.rand(B) > 0.3).astype(np.float32)
    return lab, pre, act, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_every_loss_and_its_gradient_match_jax(name, masked):
    assert sorted(losses.LOSSES) == sorted(jlosses.LOSSES)
    lab, pre, act, mask = _loss_case(name)
    m = mask if masked else None
    jfn = jlosses.get_loss(name)

    def jl(p):
        return jfn(jnp.asarray(lab), p, act,
                   None if m is None else jnp.asarray(m))
    want, jgrad = jax.value_and_grad(jl)(jnp.asarray(pre))
    tp = torch.tensor(pre, requires_grad=True)
    got = losses.get_loss(name)(torch.tensor(lab), tp, act,
                                None if m is None else torch.tensor(m))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)


def test_unknown_loss_names_the_choices():
    with pytest.raises(ValueError, match="mcxent"):
        losses.get_loss("no-such-loss")
    assert losses.get_loss("Squared_Hinge") is losses.squared_hinge


def test_updater_dataclass_defaults_match_jax():
    for kind in KINDS:
        j, p = jupd.UPDATERS[kind](), upd.UPDATERS[kind]()
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
