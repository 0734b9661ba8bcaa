"""The port's fused flat update (nn/fused_update.py) on the CPU: against the
per-member loop it replaces (bitwise, for each of the ten updaters, with
and without a schedule), against the JAX package's ``build_fused_update``
on the same arrays (within 1e-6 of max|p|: one sqrt, power or reciprocal
square root may differ by an ulp between XLA and PyTorch), and its parts:
the flat buffers the per-layer dicts view, the staged step scalars (equal
to the host formula bitwise for counts 1..10^4), a launch count that does
not grow with the number of layers.

Each plan holds five members: two float32 layers and a bfloat16 layer
under one updater (two groups: one per dtype), a member without
parameters (passed through), and a member whose chain clips by the global
norm (``ClipByGlobalNorm`` reduces across its tensors, so it keeps
per-member math, as ``test_global_norm_clip_falls_back`` requires of the
JAX plan). Inputs are numpy-seeded.

Then the containers with the fused update on in both packages (the JAX
package's default): a 2 x LSTM(16) MultiLayerNetwork (Adam(1e-3), element
gradient clipping at 10, T=8; truncated BPTT in chunks of 3) and a small
TinyTransformer graph (d_model 32, 4 heads, T=16, Adam(3e-4), the JAX
flash kernels interpreted) against the JAX package's fit on every path,
at the parity tolerances of tests/test_torch_training.py and
tests/test_torch_graph_training.py (losses 1e-6 relative, parameters 2e-6;
the key bias ``bk``, which has no gradient, 2 x lr x steps); under the
bf16 train-precision policy of each package's ``Executor``, losses within
3e-2 and the stored parameters float32; a checkpoint written mid-training
resuming in the other package; ``apply_external_updates`` and the graph's
``fit_external`` against the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import exec as jex
from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import fused_update as jfu
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.util import model_serializer as jax_ser
from deeplearning4j_tpu.util.model_serializer import _flatten_pytree
from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny

from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork,
                                      params_from_numpy)
from deeplearning4j_tpu_torch import exec as ex
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import fused_update as fu
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.conf import (ComputationGraphConfiguration,
                                              MultiLayerConfiguration)

KINDS = sorted(upd.UPDATERS)
SCHEDULE = {"kind": "exponential", "initial": 0.01, "decay_rate": 0.7}
STEPS = 5


def _arrays(seed=0):
    """Members' parameters as numpy arrays (the bf16 member's rounded to
    bfloat16 values), and STEPS gradients for each."""
    r = np.random.RandomState(seed)
    shapes = {"l0": {"W": (4, 6), "b": (6,)}, "l1": {"W": (6, 5), "RW": (5, 5),
                                                     "b": (5,)},
              "l2": {"W": (3, 4), "b": (4,)}, "empty": {},
              "clip": {"W": (5, 3), "b": (3,)}}
    params = {m: {k: r.randn(*s).astype(np.float32) for k, s in p.items()}
              for m, p in shapes.items()}
    grads = [{m: {k: (r.randn(*v.shape) * 0.3).astype(np.float32)
                  for k, v in p.items()} for m, p in params.items()}
             for _ in range(STEPS)]
    return params, grads


def _updater(kind, schedule, pkg=upd):
    s = None if schedule is None else pkg.Schedule(**schedule)
    return pkg.UPDATERS[kind](schedule=s)


def _torch_members(params):
    """The port's members as tensors: ``l2`` in bfloat16, the rest in
    float32."""
    dtypes = {"l2": torch.bfloat16}
    return {m: {k: torch.tensor(v).to(dtypes.get(m, torch.float32))
                for k, v in p.items()} for m, p in params.items()}


def _plan_and_loop(kind, schedule, constraints=None):
    params, grads = _arrays()
    u = _updater(kind, schedule)
    transforms = {m: u.transform() for m in params}
    transforms["clip"] = upd.make_gradient_transform(u, grad_norm_threshold=0.5)
    keys = {m: (None if upd.reduces_across_leaves(t) else "same")
            for m, t in transforms.items()}
    fp, lp = _torch_members(params), _torch_members(params)
    fo = {m: transforms[m].init(p) for m, p in fp.items()}
    lo = {m: transforms[m].init(p) for m, p in lp.items()}
    plan = fu.build_fused_update(fp, fo, transforms, keys, constraints)
    return plan, transforms, (fp, fo), (lp, lo), grads


def _grads_like(g, p):
    return {m: {k: torch.tensor(v).to(p[m][k].dtype) for k, v in gm.items()}
            for m, gm in g.items()}


def _plan_step(plan, params, opt_state, grads):
    """One eager update through the plan: its host and device halves."""
    plan.stage(opt_state)
    plan.apply(params, opt_state, grads)
    plan.advance(opt_state)


def _loop_step(transforms, lp, lo, g, constraints=None):
    """The per-member loop: each member's own updater, add, constraints."""
    for m, p in lp.items():
        if not p:
            continue
        u, lo[m] = transforms[m].update(g[m], lo[m], p)
        new = {k: (v + u[k]).to(v.dtype) for k, v in p.items()}
        lp[m] = (constraints or {}).get(m, lambda q: q)(new)


def _assert_bitwise(a, b, what):
    assert sorted(a) == sorted(b), what
    for m in a:
        assert sorted(a[m]) == sorted(b[m]), (what, m)
        for k in a[m]:
            assert a[m][k].dtype == b[m][k].dtype, (what, m, k)
            assert torch.equal(a[m][k], b[m][k]), (what, m, k)


@pytest.mark.parametrize("schedule", [None, SCHEDULE],
                         ids=["constant", "exponential"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_plan_equals_the_per_member_loop_bitwise(kind, schedule):
    plan, transforms, (fp, fo), (lp, lo), grads = _plan_and_loop(kind,
                                                                 schedule)
    assert plan.fused_keys == ["l0", "l1", "l2"]
    assert [(g.members, g.dtype) for g in plan.groups] == [
        (["l0", "l1"], torch.float32), (["l2"], torch.bfloat16)]
    assert plan.fallback == ["clip"] and plan.passthrough == ["empty"]
    for s, g in enumerate(grads):
        _plan_step(plan, fp, fo, _grads_like(g, fp))
        _loop_step(transforms, lp, lo, _grads_like(g, lp))
        _assert_bitwise(fp, lp, f"params, step {s}")
        _assert_bitwise(fo, lo, f"updater state, step {s}")


@pytest.mark.parametrize("kind", KINDS)
def test_constraints_apply_per_member_after_the_flat_step(kind):
    def maxnorm(p):
        out = dict(p)
        n = torch.sqrt((p["W"] ** 2).sum(dim=0, keepdim=True))
        out["W"] = p["W"] * torch.clamp(n, 0, 0.5) / torch.clamp(n, min=1e-8)
        return out
    cons = {"l1": maxnorm, "clip": maxnorm}
    plan, transforms, (fp, fo), (lp, lo), grads = _plan_and_loop(
        kind, None, cons)
    for g in grads:
        _plan_step(plan, fp, fo, _grads_like(g, fp))
        _loop_step(transforms, lp, lo, _grads_like(g, lp), cons)
    _assert_bitwise(fp, lp, "params")
    _assert_bitwise(fo, lo, "updater state")
    assert float(torch.sqrt((fp["l1"]["W"] ** 2).sum(dim=0)).max()) <= 0.5 + 1e-6


@pytest.mark.parametrize("kind", KINDS)
def test_port_plan_matches_the_jax_plan(kind):
    """The port's plan and the JAX package's ``build_fused_update`` on the
    same float32 arrays, five steps: parameters within 1e-6 of max|p|,
    the state under the same optax key paths and as close."""
    params, grads = _arrays(1)
    params.pop("l2")                     # float32 members only
    jt = {m: _updater(kind, SCHEDULE, jupd).to_optax() for m in params}
    jt["clip"] = jupd.make_gradient_transform(
        _updater(kind, SCHEDULE, jupd), grad_norm_threshold=0.5)
    keys = {m: (None if m == "clip" else "same") for m in params}
    jp = {m: {k: jnp.asarray(v) for k, v in p.items()}
          for m, p in params.items()}
    jo = {m: jt[m].init(jp[m]) for m in params}
    jplan = jfu.build_fused_update(jp, jt, keys)

    u = _updater(kind, SCHEDULE)
    pt = {m: u.transform() for m in params}
    pt["clip"] = upd.make_gradient_transform(u, grad_norm_threshold=0.5)
    tp = {m: {k: torch.tensor(v) for k, v in p.items()}
          for m, p in params.items()}
    to = {m: pt[m].init(tp[m]) for m in params}
    plan = fu.build_fused_update(tp, to, pt, keys)
    assert plan.fused_keys == jplan.fused_keys == ["l0", "l1"]
    for g in grads:
        g.pop("l2")
        jp, jo = jplan.apply(jp, jo, {m: {k: jnp.asarray(v)
                                          for k, v in gm.items()}
                                      for m, gm in g.items()})
        _plan_step(plan, tp, to, _grads_like(g, tp))
    scale = max(float(np.abs(np.asarray(v)).max())
                for p in jp.values() for v in p.values())
    for m in params:
        for k in params[m]:
            err = np.abs(tp[m][k].numpy() - np.asarray(jp[m][k])).max()
            assert err <= 1e-6 * scale, (m, k, err)
        flat = {k[2:]: v for k, v in _flatten_pytree([jo[m]]).items()}
        assert sorted(flat) == sorted(to[m]), m
        for k, v in flat.items():
            np.testing.assert_allclose(to[m][k].numpy(), v, rtol=1e-5,
                                       atol=1e-6, err_msg=f"{m} {k}")


def test_members_view_the_flat_buffers():
    plan, transforms, (fp, fo), _, grads = _plan_and_loop("Adam", SCHEDULE)
    g0 = plan.groups[0]
    base, end = g0.flat.data_ptr(), g0.flat.data_ptr() + 4 * g0.flat.numel()
    for m in g0.members:
        for k, v in fp[m].items():
            assert base <= v.data_ptr() < end, (m, k)
        assert fo[m]["0/.count"].device.type == "cpu"
    assert sorted(g0.slots) == ["0/.mu", "0/.nu"]
    mu = g0.slots["0/.mu"]
    before = [fp[m][k].data_ptr() for m in g0.members for k in fp[m]]
    _plan_step(plan, fp, fo, _grads_like(grads[0], fp))
    # updated in place: the views still are the parameters, and the flat
    # moment holds each member's slice at the layout's offsets
    assert before == [fp[m][k].data_ptr() for m in g0.members for k in fp[m]]
    assert torch.equal(mu[:24], fo["l0"]["0/.mu/W"].reshape(-1))
    assert [int(fo[m]["0/.count"]) for m in ("l0", "l1", "l2")] \
        + [int(fo["clip"]["1/0/.count"])] == [1, 1, 1, 1]


@pytest.mark.parametrize("kind", ["Adam", "NAdam", "AdaMax", "AmsGrad"])
def test_staged_scalars_equal_the_host_formula_for_counts_to_ten_thousand(
        kind):
    """For counts 1..10^4 the buffer the device half reads holds exactly
    the host formula's float32 numbers (bias corrections at the new count,
    the schedule's rate at the stage's count), and the bias corrections
    agree with optax's (XLA's float32 power) within 2 ulp."""
    u = _updater(kind, SCHEDULE)
    t = u.transform()
    p = {"W": torch.zeros(3)}
    o = t.init(p)
    plan = fu.build_fused_update({"a": p}, {"a": o}, {"a": t}, {"a": "k"})
    counts = np.arange(1, 10001)
    staged = np.empty((len(counts), t.n_scalars), np.float32)
    for i, c in enumerate(counts):
        o["0/.count"] = torch.tensor(c - 1, dtype=torch.int32)
        o["1/.count"] = torch.tensor(c - 1, dtype=torch.int32)
        plan.stage({"a": o})
        staged[i] = plan.scalars[:t.n_scalars].numpy()
    f32 = np.float32
    b1 = f32(u.beta1)
    want = [f32(1) - np.power(b1, counts.astype(f32))]
    if kind != "AdaMax":
        want.append(f32(1) - np.power(f32(u.beta2), counts.astype(f32)))
    if kind == "NAdam":
        want.append(f32(1) - np.power(b1, (counts + 1).astype(f32)))
    want.append(-(f32(SCHEDULE["initial"]) * np.power(
        f32(SCHEDULE["decay_rate"]), (counts - 1).astype(f32))))
    for j, w in enumerate(want):
        assert staged[:, j].tobytes() == w.astype(f32).tobytes(), j
    for j, d in enumerate([u.beta1, u.beta2][:1 if kind == "AdaMax" else 2]):
        xla = np.asarray(1 - d ** jnp.asarray(counts, jnp.int32))
        np.testing.assert_allclose(staged[:, j], xla, rtol=0, atol=1.2e-7)


def _ops_in_apply(n_layers):
    """ATen operations other than views (each one a kernel on the card)
    that one fused update of ``n_layers`` Adam layers runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))
    r = np.random.RandomState(0)
    params = {i: {"W": torch.tensor(r.randn(4, 4).astype(np.float32)),
                  "b": torch.zeros(4)} for i in range(n_layers)}
    t = upd.Adam(1e-3).transform()
    opt = {i: t.init(p) for i, p in params.items()}
    plan = fu.build_fused_update(params, opt, {i: t for i in params},
                                 {i: "adam" for i in params})
    grads = {i: {k: torch.ones_like(v) for k, v in p.items()}
             for i, p in params.items()}
    with Count():
        plan.apply(params, opt, grads)
    return Count.n


def test_a_groups_update_is_a_fixed_number_of_operations():
    """One concatenation, the transform's elementwise operations and one
    copy per buffer, whatever the number of layers."""
    assert _ops_in_apply(2) == _ops_in_apply(6) <= 20


def test_switch_reads_the_environment(monkeypatch):
    fu.set_fused_update(None)
    monkeypatch.setenv("DL4JTPU_FUSED_UPDATE", "0")
    assert not fu.fused_update_enabled()
    monkeypatch.setenv("DL4JTPU_FUSED_UPDATE", "1")
    assert fu.fused_update_enabled()
    fu.set_fused_update(False)
    try:
        assert not fu.fused_update_enabled()
        assert jfu.fused_update_enabled()    # each package its own switch
    finally:
        fu.set_fused_update(None)


# ------------------------------------------------------- the containers

V, H, T, B = 9, 16, 8, 4
TV, TT, TB = 11, 16, 3
SMALL_TINY = dict(vocab_size=TV, n_layers=2, d_model=32, n_heads=4,
                  max_len=64)
P_TOL, LOSS_RTOL, ADAM_LR, BF16_TOL = 2e-6, 1e-6, 3e-4, 3e-2


@pytest.fixture
def fused_on_in_both():
    jfu.set_fused_update(True)
    fu.set_fused_update(True)
    yield
    jfu.set_fused_update(None)
    fu.set_fused_update(None)


@pytest.fixture
def jax_kernels_interpreted():
    jops.set_helpers_enabled(True, interpret=True)
    yield
    jops.set_helpers_enabled(None)


def _jax_lstm_conf(tbptt=None, seed=7):
    lb = (JaxNNC.builder().seed(seed).updater(jupd.Adam(1e-3))
          .weight_init("xavier")
          .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0)
          .list().layer(JaxLSTM(n_out=H, activation="tanh"))
          .layer(JaxLSTM(n_out=H, activation="tanh"))
          .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
          .set_input_type(JaxInputType.recurrent(V)))
    if tbptt:
        lb = lb.backprop_type("tbptt", tbptt, tbptt)
    return lb.build()


def _as_numpy(params):
    if isinstance(params, dict):
        return {n: {k: np.asarray(v) for k, v in p.items()}
                for n, p in params.items()}
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _pair(model, seed=7):
    """The JAX model (fused update on) and the port's from its JSON and its
    initial parameters."""
    if model == "graph":
        jnet = JaxCG(JaxTiny(seed=seed, **SMALL_TINY).conf()).init()
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            jnet.conf.to_json()), device="cpu")
    else:
        jnet = JaxMLN(_jax_lstm_conf(3 if model == "tbptt" else None,
                                     seed)).init()
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jnet.conf.to_json()), device="cpu")
    assert jnet._fused is not None
    net.set_params(params_from_numpy(_as_numpy(jnet.params), device="cpu"))
    assert net._fused is not None
    return jnet, net


def _data(model, seed, n):
    r = np.random.RandomState(seed)
    v, t, rows = (TV, TT, TB) if model == "graph" else (V, T, B)
    eye = np.eye(v, dtype=np.float32)
    return [(eye[r.randint(0, v, (rows, t))], eye[r.randint(0, v, (rows, t))])
            for _ in range(n)]


def _close(jnet, net, steps, tol=P_TOL):
    """Every parameter within ``tol``; a graph's ``bk`` within 2 lr steps."""
    jp = jnet.params if isinstance(jnet.params, dict) \
        else dict(enumerate(jnet.params))
    pp = net.params if isinstance(net.params, dict) \
        else dict(enumerate(net.params))
    for n, p in jp.items():
        assert sorted(p) == sorted(pp[n])
        for k, v in p.items():
            bound = 2 * ADAM_LR * steps if k == "bk" else tol
            np.testing.assert_allclose(pp[n][k].numpy(), np.asarray(v),
                                       rtol=0, atol=bound, err_msg=f"{n}/{k}")


def _fit_both(jnet, net, model, path, data):
    if path == "fit":
        for x, y in data:
            jnet.fit(x, y)
            net.fit(x, y)
            np.testing.assert_allclose(net.get_score(),
                                       float(jnet.get_score()),
                                       rtol=LOSS_RTOL)
    elif path == "iterator":
        x = np.concatenate([a for a, _ in data])
        y = np.concatenate([b for _, b in data])
        jnet.fit(JaxListIterator(JaxDataSet(x, y), 3, shuffle=True, seed=3),
                 epochs=2)
        net.fit(ListDataSetIterator(DataSet(x, y), 3, shuffle=True, seed=3),
                epochs=2)
    else:
        xs = np.stack([a for a, _ in data])
        ys = np.stack([b for _, b in data])
        jnet.fit_scan(jnp.asarray(xs), jnp.asarray(ys))
        net.fit_scan(xs, ys)
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=LOSS_RTOL)
    assert net.iteration == jnet.iteration


@pytest.mark.parametrize("model,path", [
    ("mln", "fit"), ("mln", "iterator"), ("mln", "fit_scan"),
    ("tbptt", "fit"), ("tbptt", "iterator"),
    ("graph", "fit"), ("graph", "iterator"), ("graph", "fit_scan")])
def test_fused_fit_matches_the_jax_fused_fit(model, path, fused_on_in_both,
                                             jax_kernels_interpreted):
    jnet, net = _pair(model)
    data = _data(model, 0, 3)
    _fit_both(jnet, net, model, path, data)
    _close(jnet, net, jnet.iteration)
    for n, state in (jnet.opt_state.items() if model == "graph"
                     else enumerate(jnet.opt_state)):
        flat = jax_ser._flatten_pytree(state)
        assert sorted(flat) == sorted(net.opt_state[n]), n


@pytest.mark.parametrize("model", ["mln", "graph"])
def test_bf16_policy_matches_the_jax_bf16_executor(model, fused_on_in_both,
                                                   jax_kernels_interpreted):
    jex.set_executor(jex.Executor(train_precision="bf16"))
    ex.set_executor(ex.Executor(train_precision="bf16"))
    try:
        jnet, net = _pair(model, seed=10)
        for x, y in _data(model, 5, 3):
            jnet.fit(x, y)
            net.fit(x, y)
            np.testing.assert_allclose(net.get_score(),
                                       float(jnet.get_score()),
                                       rtol=BF16_TOL)
    finally:
        jex.set_executor(None)
        ex.set_executor(None)
    params = net.params.values() if model == "graph" else net.params
    assert all(v.dtype == torch.float32 for p in params for v in p.values())


@pytest.mark.parametrize("model", ["mln", "tbptt", "graph"])
def test_mid_training_checkpoint_resumes_in_the_other_package(
        model, tmp_path, fused_on_in_both, jax_kernels_interpreted):
    jnet, net = _pair(model, seed=11)
    data = _data(model, 8, 3)
    for x, y in data[:2]:
        jnet.fit(x, y)
        net.fit(x, y)
    jpath, ppath = tmp_path / "jax.zip", tmp_path / "port.zip"
    jax_ser.write_model(jnet, str(jpath))
    net.save(ppath)
    cls = ComputationGraph if model == "graph" else MultiLayerNetwork
    from_jax = cls.load(jpath, device="cpu")
    restore = (jax_ser.restore_computation_graph if model == "graph"
               else jax_ser.restore_multi_layer_network)
    from_port = restore(str(ppath))
    assert from_jax._fused is not None and from_port._fused is not None
    x, y = data[2]
    for resumed, twin in ((from_jax, jnet), (from_port, net)):
        resumed.fit(x, y)
        twin.fit(x, y)
        np.testing.assert_allclose(float(resumed.get_score()),
                                   float(twin.get_score()), rtol=LOSS_RTOL)
    _close(jnet, from_jax, 3)
    _close(from_port, net, 3)


@pytest.mark.parametrize("model", ["mln", "graph"])
def test_external_updates_match_jax(model, fused_on_in_both):
    jnet, net = _pair(model, seed=12)
    r = np.random.RandomState(13)
    keys = jnet.params.keys() if model == "graph" \
        else range(len(jnet.params))
    for _ in range(3):
        g = {n: {k: (r.randn(*np.shape(v)) * 0.1).astype(np.float32)
                 for k, v in jnet.params[n].items()} for n in keys}
        if model == "graph":
            jnet.apply_external_updates({n: {k: jnp.asarray(v)
                                             for k, v in p.items()}
                                         for n, p in g.items()})
            net.apply_external_updates(g)
        else:
            jnet.apply_external_updates([{k: jnp.asarray(v)
                                          for k, v in g[i].items()}
                                         for i in keys])
            net.apply_external_updates([g[i] for i in keys])
    _close(jnet, net, 3)


def test_graph_fit_external_matches_jax(fused_on_in_both,
                                        jax_kernels_interpreted):
    jnet, net = _pair("graph", seed=14)
    r = np.random.RandomState(15)
    for x, _ in _data("graph", 16, 2):
        eps = (r.randn(TB, TT, TV) * 0.1).astype(np.float32)
        jgrads, _ = jnet.backprop_external([jnp.asarray(x)],
                                           [jnp.asarray(eps)])
        grads, _ = net.backprop_external([x], [eps])
        scale = max(float(np.abs(np.asarray(v)).max())
                    for p in jgrads.values() for v in p.values())
        for n, p in jgrads.items():
            for k, v in p.items():
                if k != "bk":
                    err = np.abs(grads[n][k].numpy() - np.asarray(v)).max()
                    assert err <= 1e-5 * scale, (n, k, err, scale)
        jnet.fit_external([jnp.asarray(x)], [jnp.asarray(eps)])
        net.fit_external([x], [eps])
    assert net.iteration == jnet.iteration == 2
    _close(jnet, net, 2)
