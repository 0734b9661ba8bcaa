"""The recurrent layers GravesLSTM, SimpleRnn, Bidirectional,
GravesBidirectionalLSTM and LastTimeStep in the port, held against the
JAX package's on the CPU.

Per layer (width 8 over a 5-wide input, T=6, B=4, with and without a
gapped feature mask with an all-zero row; Bidirectional in its four
modes): the forward to 1e-6 and the gradients of a fixed projection of it
to 1e-5 of their largest magnitude, every leaf of the nested parameter
dicts included. Per container (the S4 stack, Bidirectional(LSTM) concat ->
LastTimeStep(LSTM) -> OutputLayer, and the S7 stack,
GravesBidirectionalLSTM -> GravesLSTM -> SimpleRnn -> RnnOutputLayer, in a
MultiLayerNetwork and as a chain graph): three ``fit`` steps with and
without masks, losses 1e-6 relative and parameters 2e-6 (the Adam rule of
tests/test_torch_regularised_training.py). GravesLSTM's ``rnn_time_step``
in chunks equals its full forward; SimpleRnn's decode step token by token
equals its full forward, and its ``rnn_time_step`` (which, as the JAX
layer has no carried form, runs each call from a zero state) equals the
JAX package's; the decode steps of Bidirectional and LastTimeStep raise.
A Bidirectional network's zip, with its updater state under the nested
keys (``0/fwd/W``, ``0/0/.mu/fwd/W``), loads in the other package both
ways and resumes training there.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.layers.core import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.layers import rnn as jrnn
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.util import model_serializer as jax_ser

from deeplearning4j_tpu_torch import MultiLayerNetwork
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict

from test_torch_masks import masks
from test_torch_regularised_training import (LOSS_RTOL, batch, flat,
                                             params_close, port_of)

C, H, T, B, V = 5, 8, 6, 4, 9
OUT_TOL, GRAD_TOL = 1e-6, 1e-5


def _jax_layer(kind):
    lstm = dict(n_in=C, n_out=H, activation="tanh")
    if kind == "GravesLSTM":
        return jrnn.GravesLSTM(**lstm)
    if kind == "SimpleRnn":
        return jrnn.SimpleRnn(n_in=C, n_out=H, activation="tanh")
    if kind.startswith("Bidirectional"):
        return jrnn.Bidirectional(fwd=jrnn.LSTM(**lstm),
                                  mode=kind.split("-")[1])
    if kind == "GravesBidirectionalLSTM":
        return jrnn.GravesBidirectionalLSTM(n_in=C, n_out=H,
                                            activation="tanh")
    return jrnn.LastTimeStep(fwd=jrnn.LSTM(**lstm))


KINDS = ["GravesLSTM", "SimpleRnn", "Bidirectional-concat",
         "Bidirectional-add", "Bidirectional-mul", "Bidirectional-ave",
         "GravesBidirectionalLSTM", "LastTimeStep"]


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("kind", KINDS)
def test_layer_forward_and_gradients_match_jax(kind, masked):
    jl = _jax_layer(kind)
    layer = layer_from_dict(json.loads(json.dumps(jl.to_dict())))
    jp = jl.init(jax.random.PRNGKey(1))
    if kind == "GravesLSTM" or kind == "GravesBidirectionalLSTM":
        # nonzero peepholes, so the test sees them
        jp = jax.tree_util.tree_map_with_path(
            lambda p, a: a + 0.3 if p[-1].key == "pW" else a, jp)
    r = np.random.RandomState(2)
    x = r.randn(B, T, C).astype(np.float32)
    m = masks(2)[0] if masked else None
    jm = None if m is None else jnp.asarray(m)
    jy = np.asarray(jl.apply(jp, jnp.asarray(x), mask=jm)[0])
    p = _to_torch(jp)
    tm = None if m is None else torch.from_numpy(m)
    y = layer.apply(p, torch.from_numpy(x), mask=tm)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=OUT_TOL)
    w = r.randn(*jy.shape).astype(np.float32)
    jg = jax.grad(lambda q: (jl.apply(q, jnp.asarray(x), mask=jm)[0]
                             * w).sum())(jp)
    leaves = jax.tree_util.tree_map(lambda t: t.requires_grad_(), p)
    (layer.apply(leaves, torch.from_numpy(x), mask=tm)
     * torch.from_numpy(w)).sum().backward()
    want, got = flat(jg), flat(jax.tree_util.tree_map(
        lambda t: t.grad.numpy(), leaves))
    assert sorted(want) == sorted(got)
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= GRAD_TOL * scale, k


def _stack(kind, seed=4):
    b = JaxNNC.builder().seed(seed).updater(JaxAdam(1e-3)).list()
    if kind == "S4":
        b = (b.layer(jrnn.Bidirectional(fwd=JaxLSTM(n_out=H,
                                                    activation="tanh")))
             .layer(jrnn.LastTimeStep(fwd=JaxLSTM(n_out=H,
                                                  activation="tanh")))
             .layer(JaxOut(n_out=V, activation="softmax", loss="mcxent")))
    else:
        b = (b.layer(jrnn.GravesBidirectionalLSTM(n_out=H,
                                                  activation="tanh"))
             .layer(jrnn.GravesLSTM(n_out=H, activation="tanh"))
             .layer(jrnn.SimpleRnn(n_out=H, activation="tanh"))
             .layer(JaxRnnOut(n_out=V, activation="softmax",
                              loss="mcxent")))
    return b.set_input_type(JaxInputType.recurrent(V)).build()


def _graph_of(conf):
    """The same stack as a chain ComputationGraph (JAX)."""
    g = (JaxNNC.builder().seed(conf.global_conf.seed)
         .updater(JaxAdam(1e-3)).graph_builder().add_inputs("in")
         .set_input_types(JaxInputType.recurrent(V)))
    prev = "in"
    for i, l in enumerate(conf.layers):
        g.add_layer(f"l{i}", l, prev)
        prev = f"l{i}"
    return g.set_outputs(prev).build()


def _data(kind, seed=5):
    x, y = batch(seed)
    mf, ml = masks(seed)
    if kind == "S4":
        y, ml = y[:, -1], None
    return x, y, mf, ml


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("kind", ["S4", "S7"])
def test_three_fit_steps_match_jax(kind, container, masked):
    conf = _stack(kind)
    if container == "graph":
        jnet = JaxCG(_graph_of(conf)).init()
    else:
        jnet = JaxMLN(conf).init()
    net = port_of(jnet)
    x, y, mf, ml = _data(kind)
    if not masked:
        mf = ml = None

    def jloss(p):
        m = None if mf is None else jnp.asarray(mf)
        lm = None if ml is None else jnp.asarray(ml)
        if container == "graph":
            return jnet._loss(p, jnet.state, [jnp.asarray(x)],
                              [jnp.asarray(y)], None,
                              None if m is None else {"in": m},
                              None if lm is None else [lm])[0]
        return jnet._loss(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                          None, m, lm)[0]
    jg = jax.grad(jloss)(jnet.params)
    for _ in range(3):
        if container == "graph":
            jnet.fit(JaxMDS([x], [y], [mf], [ml]))
            net.fit(MultiDataSet([x], [y], [mf], [ml]))
        else:
            jnet.fit(JaxDataSet(x, y, mf, ml))
            net.fit(DataSet(x, y, mf, ml))
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=LOSS_RTOL)
    params_close(jnet, net, jg, 3)
    if container == "mln":
        got = net.output(x, mask=mf).numpy()
        want = np.asarray(jnet.output(
            jnp.asarray(x), mask=None if mf is None else jnp.asarray(mf)))
        np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)


def test_bidirectional_penalty_and_constraints_follow_jax():
    """Caveat R7: l1/l2 skip a Bidirectional layer's whole ``bwd``
    direction (its top-level key starts with "b") and its constraints
    never act (nested parameters), in both packages."""
    conf = _stack("S4")
    conf.global_conf.l1, conf.global_conf.l2 = 1e-3, 1e-2
    for layer in conf.layers:
        layer.l1, layer.l2 = 1e-3, 1e-2
        layer.constraints = ("maxnorm", 0.05)
    jnet = JaxMLN(conf).init()
    net = port_of(jnet)
    x, y, _, _ = _data("S4", seed=9)
    jl, jg = jax.value_and_grad(lambda p: jnet._loss(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), None, None,
        None)[0])(jnet.params)
    np.testing.assert_allclose(net.score(DataSet(x, y)), float(jl),
                               rtol=LOSS_RTOL)
    before = {k: v.clone() for k, v in net.params[0].items()}
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=LOSS_RTOL)
    params_close(jnet, net, jg, 3)
    # maxnorm 0.05 acted on the other layers' weights, not on layer 0's
    assert all(not torch.equal(before[k], net.params[0][k]) for k in before)
    norms = net.params[1]["W"].norm(dim=0)
    assert (norms <= 0.05 + 1e-6).all()
    assert (net.params[0]["fwd/W"].norm(dim=0) > 0.05).any()


def test_graves_rnn_time_step_in_chunks_equals_the_forward():
    jconf = (JaxNNC.builder().seed(6).list()
             .layer(jrnn.GravesLSTM(n_out=H, activation="tanh"))
             .layer(JaxRnnOut(n_out=V, activation="softmax"))
             .set_input_type(JaxInputType.recurrent(V)).build())
    jnet = JaxMLN(jconf).init()
    net = port_of(jnet)
    x, _ = batch(6)
    full = net.output(x, bucketed=False)
    parts = [net.rnn_time_step(x[:, :2]), net.rnn_time_step(x[:, 2:3]),
             net.rnn_time_step(x[:, 3:])]
    torch.testing.assert_close(torch.cat(parts, dim=1), full, rtol=0,
                               atol=OUT_TOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(
        jnet.output(jnp.asarray(x))), rtol=0, atol=OUT_TOL)


def test_simple_rnn_decode_step_and_rnn_time_step():
    jconf = (JaxNNC.builder().seed(7).list()
             .layer(jrnn.SimpleRnn(n_out=H, activation="tanh"))
             .layer(JaxRnnOut(n_out=V, activation="softmax"))
             .set_input_type(JaxInputType.recurrent(V)).build())
    jnet = JaxMLN(jconf).init()
    net = port_of(jnet)
    x, _ = batch(7)
    full = net.output(x, bucketed=False)
    state = net.init_decode_state(B)
    steps = []
    for t in range(T):
        y, state = net.decode_step(net.params, state,
                                   torch.from_numpy(x[:, t:t + 1]))
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=0,
                               atol=OUT_TOL)
    # no carried form in either package: each call from a zero state
    for chunk in (x[:, :2], x[:, 2:]):
        np.testing.assert_allclose(
            net.rnn_time_step(chunk).numpy(),
            np.asarray(jnet.rnn_time_step(jnp.asarray(chunk))), rtol=0,
            atol=OUT_TOL)


@pytest.mark.parametrize("kind", ["Bidirectional-concat", "LastTimeStep",
                                  "GravesBidirectionalLSTM"])
def test_whole_sequence_layers_cannot_decode(kind):
    layer = layer_from_dict(_jax_layer(kind).to_dict())
    p = layer.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Bidirectional|LastTimeStep"):
        layer.decode_step(p, None, torch.zeros(B, 1, C))


def test_bidirectional_zip_round_trips_both_ways(tmp_path):
    jnet = JaxMLN(_stack("S4")).init()
    net = port_of(jnet)
    x, y, _, _ = _data("S4", seed=8)
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
    jpath, ppath = tmp_path / "jax.zip", tmp_path / "port.zip"
    jax_ser.write_model(jnet, str(jpath))
    net.save(ppath)
    assert "fwd/RW" in net.params[0] and "bwd/b" in net.params[0]
    assert "0/.mu/fwd/W" in net.opt_state[0]
    assert sorted(jax_ser._flatten_pytree(jnet.opt_state[0])) == sorted(
        net.opt_state[0])
    from_jax = MultiLayerNetwork.load(jpath, device="cpu")
    from_port = jax_ser.restore_multi_layer_network(str(ppath))
    assert from_jax.iteration == from_port.iteration == 2
    for resumed, twin in ((from_jax, jnet), (from_port, net)):
        resumed.fit(DataSet(x, y) if resumed is from_jax
                    else JaxDataSet(x, y))
        twin.fit(DataSet(x, y) if twin is net else JaxDataSet(x, y))
    _, jg = jax.value_and_grad(lambda p: jnet._loss(
        p, jnet.state, jnp.asarray(x), jnp.asarray(y), None, None,
        None)[0])(jnet.params)
    params_close(jnet, from_jax, jg, 3)
    params_close(from_port, net, jg, 3)
