"""Feature masks in the port, held against the JAX package on the CPU.

A feature mask (B, T) marks the real steps of a padded batch. Both
packages send a masked batch to the LSTM layer's own loop (the fused
screen takes ``mask is None``), which blends each step: where the mask is
0 the carry stays what it was. The MultiLayerNetwork passes the mask to
every layer until the activations lose their time axis; the graph only to
a layer whose first input is a network input (caveat R6). Masks here are
gapped (a zero inside a row) and include an all-zero row; label masks are
set beside them.

Held against the JAX package (2 x LSTM(8), RnnOutputLayer, Adam(1e-3),
T=6, B=4): three ``fit`` steps on a DataSet and on an iterator, truncated
BPTT with the masks sliced per chunk, ``score``, ``evaluate`` (which reads
no feature mask in either package, caveat R8) and ``output(x, mask=)``;
the graph's ``fit`` and ``score``. Tolerances: losses 1e-6 relative,
outputs 1e-6 absolute, parameters 2e-6 absolute (the Adam rule of
tests/test_torch_regularised_training.py). With a mask the LSTM screen
refuses before it asks for a launch plan, and the pair does not fuse. A
key-padding mask reaching MultiHeadAttention drops the masked keys'
scores, as the JAX layer's einsum path does, through the layer's own
attention (not K5): the output and one graph ``fit`` step agree with the
JAX package's at float32 rtol 1e-5 / atol 1e-6, causal or not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd

from deeplearning4j_tpu_torch import ComputationGraph, ops
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                           MultiDataSet)
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (LSTM, MultiHeadAttention,
                                                RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.layers.rnn import lstm_pair_fusable
from deeplearning4j_tpu_torch.ops import lstm_cuda

from test_torch_regularised_training import (LOSS_RTOL, B, H, T, V, batch,
                                             lstm_conf,
                                             params_close, port_of)

OUT_TOL = 1e-6


def masks(seed=0, n=B, t=T):
    """A feature mask with a gap inside row 0, an all-zero last row and
    ragged lengths between; the label mask beside it."""
    r = np.random.RandomState(seed)
    m = np.zeros((n, t), np.float32)
    for i, length in enumerate(r.randint(2, t + 1, n)):
        m[i, :length] = 1.0
    m[0, 1] = 0.0
    m[-1] = 0.0
    lm = m.copy()
    lm[-1, 0] = 1.0          # the label of a row whose inputs are all masked
    return m, lm


def _jax_masked_grads(jnet, x, y, mf, ml):
    def loss(p):
        return jnet._loss(p, jnet.state, jnp.asarray(x), jnp.asarray(y), None,
                          jnp.asarray(mf), jnp.asarray(ml))[0]
    return jax.grad(loss)(jnet.params)


@pytest.mark.parametrize("path", ["dataset", "iterator"])
def test_masked_fit_matches_jax(path):
    jnet = JaxMLN(lstm_conf(None)).init()
    net = port_of(jnet)
    x, y = batch(0)
    mf, ml = masks(0)
    jg = _jax_masked_grads(jnet, x, y, mf, ml)
    if path == "iterator":
        jnet.fit(JaxListIterator(JaxDataSet(x, y, mf, ml), B), epochs=3)
        net.fit(ListDataSetIterator(DataSet(x, y, mf, ml), B), epochs=3)
    else:
        for _ in range(3):
            jnet.fit(JaxDataSet(x, y, mf, ml))
            net.fit(DataSet(x, y, mf, ml))
            np.testing.assert_allclose(net.get_score(),
                                       float(jnet.get_score()),
                                       rtol=LOSS_RTOL)
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    params_close(jnet, net, jg, 3)


def test_masked_tbptt_matches_jax():
    jnet = JaxMLN(lstm_conf(None, tbptt=4)).init()
    net = port_of(jnet)
    x, y = batch(1)
    mf, ml = masks(1)
    jnet.fit(JaxDataSet(x, y, mf, ml))
    net.fit(DataSet(x, y, mf, ml))
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    params_close(jnet, net, _jax_masked_grads(jnet, x, y, mf, ml), 2)


def test_masked_score_evaluate_and_output_match_jax():
    jnet = JaxMLN(lstm_conf(None)).init()
    net = port_of(jnet)
    x, y = batch(2)
    mf, ml = masks(2)
    np.testing.assert_allclose(net.score(DataSet(x, y, mf, ml)),
                               jnet.score(JaxDataSet(x, y, mf, ml)),
                               rtol=LOSS_RTOL)
    assert abs(net.score(DataSet(x, y, mf, ml))
               - net.score(DataSet(x, y, None, ml))) > 1e-4
    for bucketed in (True, False):
        got = net.output(x, mask=mf, bucketed=bucketed).numpy()
        want = np.asarray(jnet.output(jnp.asarray(x), mask=jnp.asarray(mf),
                                      bucketed=bucketed))
        np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)
    # masked steps keep the carry: row 0's step 1 repeats step 0's state
    hidden = net._forward(net.params, torch.from_numpy(x), upto=2,
                          mask=torch.from_numpy(mf))[0]
    assert torch.equal(hidden[0, 1], hidden[0, 0])
    assert torch.equal(hidden[-1], torch.zeros_like(hidden[-1]))
    ev = net.evaluate(DataSet(x, y, mf, ml))
    jev = jnet.evaluate(JaxDataSet(x, y, mf, ml))
    np.testing.assert_array_equal(ev.confusion, jev.confusion)


def test_the_screens_refuse_a_masked_batch(monkeypatch):
    asked = []
    monkeypatch.setattr(lstm_cuda, "has_plan",
                        lambda *a: asked.append(a) or True)
    layer = LSTM(n_in=V, n_out=H, activation="tanh")
    params = layer.init(torch.Generator().manual_seed(0))
    m = torch.ones(B, T)
    for rec in (False, True):
        assert not layer.fused_supported(torch.float32, B, "cpu", rec, m)
        assert not lstm_pair_fusable(layer, LSTM(n_in=H, n_out=H,
                                                 activation="tanh"),
                                     params, params, torch.zeros(B, T, V), m)
    assert asked == []
    assert layer.fused_supported(torch.float32, B, "cpu", False)
    assert len(asked) == 1
    # the masked forward runs the layer's loop, not the kernel's plain
    # version: all-ones equals the unmasked (kernel) forward closely
    x = torch.randn(B, T, V, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(layer.apply(params, x, mask=m),
                               layer.apply(params, x), rtol=0, atol=1e-6)


def _graph_pair(seed=3):
    """A JAX graph input -> LSTM -> LSTM -> RnnOutputLayer and the port's:
    the feature mask reaches the first LSTM only."""
    g = (JaxNNC.builder().seed(seed).updater(JaxAdam(1e-3))
         .graph_builder().add_inputs("in")
         .set_input_types(JaxInputType.recurrent(V)))
    g.add_layer("l1", JaxLSTM(n_out=H, activation="tanh"), "in")
    g.add_layer("l2", JaxLSTM(n_out=H, activation="tanh"), "l1")
    g.add_layer("out", JaxRnnOut(n_out=V, activation="softmax",
                                 loss="mcxent"), "l2")
    jnet = JaxCG(g.set_outputs("out").build()).init()
    return jnet, port_of(jnet)


def test_graph_mask_reaches_only_input_fed_layers():
    jnet, net = _graph_pair()
    x, y = batch(4)
    mf, ml = masks(4)
    jm = {"in": jnp.asarray(mf)}

    def jloss(p):
        return jnet._loss(p, jnet.state, [jnp.asarray(x)], [jnp.asarray(y)],
                          None, jm, [jnp.asarray(ml)])[0]
    jl, jg = jax.value_and_grad(jloss)(jnet.params)
    np.testing.assert_allclose(
        net.score(MultiDataSet([x], [y], [mf], [ml])), float(jl),
        rtol=LOSS_RTOL)
    seen = {}
    for name in ("l1", "l2"):
        layer = net.conf.nodes[name].layer
        real = layer.apply

        def spy(p, x_, *, _n=name, _real=real, **kw):
            seen[_n] = kw.get("mask")
            return _real(p, x_, **kw)
        layer.apply = spy
    for _ in range(3):
        jnet.fit(JaxMDS([x], [y], [mf], [ml]))
        net.fit(DataSet(x, y, mf, ml))
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=LOSS_RTOL)
    assert seen["l1"] is not None and seen["l2"] is None
    params_close(jnet, net, jg, 3)


ATTN_RTOL, ATTN_ATOL = 1e-5, 1e-6


def _attention_graph(causal, heads=1, width=8):
    """A JAX graph with MultiHeadAttention on its input (so the feature
    mask reaches it: caveat R6) and the port's graph of its JSON and
    parameters."""
    from deeplearning4j_tpu.nn.layers import \
        MultiHeadAttention as JaxMHA
    g = (JaxNNC.builder().seed(4).updater(JaxSgd(0.1)).graph_builder()
         .add_inputs("in").set_input_types(JaxInputType.recurrent(width)))
    g.add_layer("attn", JaxMHA(n_out=width, n_heads=heads, causal=causal),
                "in")
    g.add_layer("out", JaxRnnOut(n_out=V, activation="softmax"), "attn")
    jnet = JaxCG(g.set_outputs("out").build()).init()
    return jnet, port_of(jnet)


def _attention_batch(seed, width=8):
    x, y = batch(seed)
    x = np.random.RandomState(seed).randn(B, T, width).astype(np.float32)
    mf, ml = masks(seed)
    mf[-1, :2] = 1.0        # no row without a key (NaN in both packages)
    return x, y, mf, ml


def _attention_step_matches(jnet, net, x, y, mf, ml):
    """One masked fit step (Sgd: the key bias ``bk`` has no gradient but
    rounding noise, which Sgd moves by lr x noise and Adam by up to lr)."""
    jnet.fit(JaxMDS([x], [y], [mf], [ml]))
    net.fit(MultiDataSet([x], [y], [mf], [ml]))
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=ATTN_RTOL)
    for n, p in jnet.params.items():
        for k, v in p.items():
            np.testing.assert_allclose(net.params[n][k].numpy(),
                                       np.asarray(v), rtol=ATTN_RTOL,
                                       atol=ATTN_ATOL, err_msg=f"{n}/{k}")


def test_a_mask_reaching_attention_raises():
    """Formerly the raise of a mask reaching attention; now the layer
    computes the JAX layer's masked attention: a masked graph fit step
    (with a head dim K5 takes, so the masked call leaves it for the
    layer's own attention) and the layer's masked output, against the
    JAX graph."""
    jnet, net = _attention_graph(causal=False)
    x, y, mf, ml = _attention_batch(7)
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    ops.flash_attention = spy
    try:
        _attention_step_matches(jnet, net, x, y, mf, ml)
        jlayer, layer = jnet.conf.nodes["attn"].layer, \
            net.conf.nodes["attn"].layer
        jy, _ = jlayer.apply(jnet.params["attn"], jnp.asarray(x), None,
                             mask=jnp.asarray(mf))
        got = layer.apply(net.params["attn"], torch.from_numpy(x),
                          mask=torch.from_numpy(mf))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(jy),
                                   rtol=ATTN_RTOL, atol=ATTN_ATOL)
        assert not calls            # the masked calls ran no K5
        net.fit(DataSet(x, y))      # the unmasked one runs K5
        assert calls
    finally:
        ops.flash_attention = real


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "non_causal"])
def test_masked_attention_matches_jax(causal):
    """A masked MultiHeadAttention (two heads of 8) through both
    packages' ``output(x, mask=)`` (a MultiLayerNetwork, whose mask
    reaches every layer) and one masked graph ``fit`` step."""
    from deeplearning4j_tpu.nn.layers import \
        MultiHeadAttention as JaxMHA
    x, y, mf, ml = _attention_batch(8, width=16)
    jconf = (JaxNNC.builder().seed(6).updater(JaxAdam(1e-3)).list()
             .layer(JaxMHA(n_out=16, n_heads=2, causal=causal))
             .layer(JaxRnnOut(n_out=V, activation="softmax"))
             .set_input_type(JaxInputType.recurrent(16)).build())
    jmln = JaxMLN(jconf).init()
    mln = port_of(jmln)
    np.testing.assert_allclose(
        mln.output(x, mask=mf).numpy(),
        np.asarray(jmln.output(x, mask=jnp.asarray(mf))),
        rtol=ATTN_RTOL, atol=ATTN_ATOL)
    jnet, net = _attention_graph(causal, heads=2, width=16)
    _attention_step_matches(jnet, net, x, y, mf, ml)


def test_an_all_ones_mask_trains_as_no_mask():
    """An all-ones mask sends the LSTM to its own loop, which must train
    as the kernel path (its plain versions here) does without a mask."""
    jnet = JaxMLN(lstm_conf(None)).init()
    masked, plain = port_of(jnet), port_of(jnet)
    x, y = batch(5)
    ones = np.ones((B, T), np.float32)
    for _ in range(3):
        masked.fit(DataSet(x, y, ones, ones))
        plain.fit(DataSet(x, y))
        np.testing.assert_allclose(masked.get_score(), plain.get_score(),
                                   rtol=LOSS_RTOL)
    for a, b in zip(masked.params, plain.params):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
