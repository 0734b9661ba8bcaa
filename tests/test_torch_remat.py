"""Backward rematerialization (``remat``) in the port on the CPU.

Every mode gives the gradient of no remat bit for bit, with dropout and
weight noise drawing (the recompute replays the forward's draws), in both
containers: 2 x LSTM(16) with global dropout 0.2 and DropConnect(0.8)
over vocab 9, T=8, as a MultiLayerNetwork and as a chain graph. With
remat the forward runs twice a step (forward and recompute), and three
fit steps end at the same bits as without it. A bad mode raises the JAX
package's message, from the builder as from ``check_remat_mode``, and the
mode travels in the configuration JSON both ways.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf.configuration import \
    MultiLayerConfiguration as JaxMLC
from deeplearning4j_tpu.util.remat import check_remat_mode as jax_check

from deeplearning4j_tpu_torch import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect
from deeplearning4j_tpu_torch.util.remat import check_remat_mode

from test_torch_training import H, V, _batch

MODES = [True, "full", "save_convs", "selective"]


def _builder(mode):
    return (NeuralNetConfiguration.builder().seed(7).updater(Adam(1e-3))
            .dropout(0.2).weight_noise(DropConnect(weight_retain_prob=0.8))
            .remat(mode))


def _layers():
    return [LSTM(n_out=H, activation="tanh"),
            LSTM(n_out=H, activation="tanh"),
            RnnOutputLayer(n_out=V, activation="softmax", loss="mcxent")]


def _net(container, mode):
    if container == "graph":
        g = _builder(mode).graph_builder().add_inputs("in").set_input_types(
            InputType.recurrent(V))
        prev = "in"
        for i, l in enumerate(_layers()):
            g.add_layer(f"l{i}", l, prev)
            prev = f"l{i}"
        return ComputationGraph(g.set_outputs(prev).build(),
                                device="cpu").init()
    lb = _builder(mode).list()
    for l in _layers():
        lb.layer(l)
    conf = lb.set_input_type(InputType.recurrent(V)).build()
    return MultiLayerNetwork(conf, device="cpu").init()


def _grads(net, x, y, seed=3):
    gen = torch.Generator().manual_seed(seed)
    if isinstance(net, ComputationGraph):
        loss, grads, _ = net._gradients([torch.from_numpy(x)],
                                        [torch.from_numpy(y)], gen=gen)
        return loss, [(n, k, g[k]) for n, g in sorted(grads.items())
                      for k in sorted(g)]
    loss, grads, _ = net._gradients(torch.from_numpy(x), torch.from_numpy(y),
                                    gen=gen)
    return loss, [(i, k, g[k]) for i, g in enumerate(grads)
                  for k in sorted(g)]


def _count_forwards(net):
    name = "_activations" if isinstance(net, ComputationGraph) \
        else "_forward"
    calls = []
    fn = getattr(net, name)
    setattr(net, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("container", ["mln", "graph"])
@pytest.mark.parametrize("mode", MODES, ids=[str(m) for m in MODES])
def test_every_mode_gives_the_gradient_of_no_remat(mode, container):
    plain, remat = _net(container, False), _net(container, mode)
    assert remat.conf.global_conf.remat == mode
    x, y = _batch(2)
    calls = _count_forwards(remat)
    loss, grads = _grads(remat, x, y)
    assert len(calls) == 2                 # the forward and its recompute
    want_loss, want = _grads(plain, x, y)
    assert torch.equal(loss, want_loss)
    assert [(i, k) for i, k, _ in grads] == [(i, k) for i, k, _ in want]
    for (i, k, g), (_, _, w) in zip(grads, want):
        assert torch.equal(g, w), (i, k)
    # the draws mattered: another seed gives another gradient
    assert not torch.equal(_grads(plain, x, y, seed=4)[1][0][2], want[0][2])


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_fit_with_remat_trains_the_same_bits(container):
    plain, remat = _net(container, False), _net(container, True)
    for step in range(3):
        x, y = _batch(10 + step)
        plain.fit(x, y)
        remat.fit(x, y)
        assert remat.get_score() == plain.get_score()
    items = (lambda n: sorted(n.params.items())) if container == "graph" \
        else (lambda n: enumerate(n.params))
    for (_, a), (_, b) in zip(items(remat), items(plain)):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_bad_mode_raises_the_jax_message():
    with pytest.raises(ValueError) as want:
        jax_check("partial")
    with pytest.raises(ValueError) as got:
        check_remat_mode("partial")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown remat mode 'partial'"):
        NeuralNetConfiguration.builder().remat("partial")
    for mode in [False] + MODES:
        assert check_remat_mode(mode) == jax_check(mode)


@pytest.mark.parametrize("mode", MODES, ids=[str(m) for m in MODES])
def test_the_mode_travels_in_the_json_both_ways(mode):
    lb = _builder(mode).list()
    for l in _layers():
        lb.layer(l)
    conf = lb.set_input_type(InputType.recurrent(V)).build()
    jconf = JaxMLC.from_json(conf.to_json())
    assert jconf.global_conf.remat == mode
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert back.global_conf.remat == mode
    np.testing.assert_equal(back.global_conf.l2, conf.global_conf.l2)
