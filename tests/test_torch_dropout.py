"""Dropout and weight noise in the port (nn/dropout.py, nn/weightnoise.py)
held against the JAX package's on the CPU.

The port draws every random number through the seam of nn/dropout.py
(``uniform`` and ``normal``, in forward order). Here the seam hands out the
JAX package's own draws -- ``jax.random.uniform`` / ``jax.random.normal``
at the key the JAX function uses (a Bernoulli draw is ``uniform < keep``,
as ``jax.random.bernoulli`` is built) -- and each port function must equal
its JAX counterpart bit for bit: the four ``IDropout`` kinds and a float
drop probability on activations, ``DropConnect`` and ``WeightNoise``
(additive and multiplicative) on a nested parameter dict with biases in
and out (the JAX package folds each entry's index into the key, biases
included).

From the port's real generator: Dropout(0.5) keeps 0.5 +- 0.005 of 10^6
draws; GaussianDropout's multiplier has mean 1 and variance rate / (1 -
rate), GaussianNoise's noise mean 0 and variance stddev^2 (each within
1e-2); AlphaDropout keeps a standard normal's mean and variance within
1e-2. The same (seed, iteration) seeds the same draws, another iteration
others. The ``@dropout`` / ``@noise`` JSON round-trips and reads across
packages.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn import dropout as jdrop
from deeplearning4j_tpu.nn import weightnoise as jwn
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.configuration import \
    MultiLayerConfiguration as JaxMLC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.layers.rnn import Bidirectional as JaxBi

from deeplearning4j_tpu_torch.exec.executor import seed_generator, step_seed
from deeplearning4j_tpu_torch.nn import dropout as D
from deeplearning4j_tpu_torch.nn import weightnoise as W
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (LSTM, Bidirectional,
                                                DenseLayer, layer_from_dict)

SHAPE = (6, 5, 7)
N_STATS, KEEP_TOL, MOMENT_TOL = 1_000_000, 0.005, 1e-2


class JaxKeys:
    """A stand-in for the seam: each call takes the next JAX key of the
    queue and returns the JAX package's draw at it."""

    def __init__(self, keys=()):
        self.keys = list(keys)
        self.kinds = []

    def uniform(self, shape, dtype, device, gen):
        self.kinds.append("uniform")
        return torch.from_numpy(np.array(jax.random.uniform(
            self.keys.pop(0), shape, jnp.float32)))

    def normal(self, shape, dtype, device, gen):
        self.kinds.append("normal")
        jdt = {torch.float32: jnp.float32,
               torch.bfloat16: jnp.bfloat16}[dtype]
        a = np.array(jax.random.normal(self.keys.pop(0), shape, jdt)
                     .astype(jnp.float32))
        return torch.from_numpy(a).to(dtype)


@pytest.fixture
def seam(monkeypatch):
    feed = JaxKeys()
    monkeypatch.setattr(D, "uniform", feed.uniform)
    monkeypatch.setattr(D, "normal", feed.normal)
    return feed


# ---- the JAX containers' keys, in the port's draw order ---------------------
# (imported by the other test_torch_* files that feed the seam)
_NO_INPUT_DROPOUT = ("LossLayer", "RnnLossLayer", "LayerNormalization",
                     "PositionalEmbedding", "GravesBidirectionalLSTM")


def noise_keys(params, key, apply_to_bias):
    """The keys a JAX weight noise draws at over ``params``, in its
    traversal order (sorted keys, nested dicts recursed, each entry's
    index folded in, biases skipped unless ``apply_to_bias``)."""
    out = []
    for i, (k, v) in enumerate(sorted(params.items())):
        sub = jax.random.fold_in(key, i)
        if isinstance(v, dict):
            out += noise_keys(v, sub, apply_to_bias)
        elif apply_to_bias or not k.startswith("b"):
            out.append(sub)
    return out


def dropout_keys(layer, key, carried=False):
    """The key a JAX layer's input dropout draws at ([] when it draws
    none): a wrapper's inner layer draws once (Bidirectional's backward
    direction reuses the draw); ``carried`` layers (truncated BPTT's
    ``apply_with_carry``) draw none."""
    name = type(layer).__name__
    if name in ("Bidirectional", "LastTimeStep"):
        return dropout_keys(layer.fwd, key, carried)
    if name in _NO_INPUT_DROPOUT or (carried
                                     and hasattr(layer, "apply_with_carry")):
        return []
    d = layer.dropout
    if d is None or (not isinstance(d, jdrop.IDropout) and d <= 0.0):
        return []
    return [key]


def layer_keys(layer, params, lrng, carried=False):
    out = []
    if layer.weight_noise is not None:
        out += noise_keys(params, jax.random.fold_in(lrng, 0x5eed),
                          layer.weight_noise.apply_to_bias)
    return out + dropout_keys(layer, lrng, carried)


def mln_keys(jnet, it, carried=False):
    """The keys of a JAX MultiLayerNetwork's train step at iteration
    ``it``, in the port's draw order: each layer's weight noise, then its
    dropout; the output layer's in the loss."""
    rng = jax.random.fold_in(
        jax.random.PRNGKey(jnet.conf.global_conf.seed), it)
    return [k for i, l in enumerate(jnet.layers)
            for k in layer_keys(l, jnet.params[i], jax.random.fold_in(rng, i),
                                carried)]


def graph_keys(jnet, it):
    """The same for a JAX ComputationGraph: layer nodes in topological
    order (a node's key folds in its index there), the output layers'
    (folding in 10000 + output index) in the loss."""
    conf = jnet.conf
    rng = jax.random.fold_in(jax.random.PRNGKey(conf.global_conf.seed), it)
    outs = conf.network_outputs
    consumed = {i for n in conf.nodes.values() for i in n.inputs}
    keys = []
    for idx, name in enumerate(conf.topological_order):
        node = conf.nodes[name]
        if node.kind != "layer" or (name in outs and name not in consumed):
            continue
        keys += layer_keys(node.layer, jnet.params.get(name, {}),
                           jax.random.fold_in(rng, idx))
    for oi, name in enumerate(outs):
        keys += layer_keys(conf.nodes[name].layer, jnet.params.get(name, {}),
                           jax.random.fold_in(rng, 10000 + oi))
    return keys


def _x(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


KINDS = [
    ("float", 0.3, 0.3),
    ("Dropout", jdrop.Dropout(p=0.4), D.Dropout(p=0.4)),
    ("AlphaDropout", jdrop.AlphaDropout(p=0.2), D.AlphaDropout(p=0.2)),
    ("GaussianDropout", jdrop.GaussianDropout(rate=0.3),
     D.GaussianDropout(rate=0.3)),
    ("GaussianNoise", jdrop.GaussianNoise(stddev=0.5),
     D.GaussianNoise(stddev=0.5)),
]


@pytest.mark.parametrize("name,jd,pd", KINDS, ids=[k[0] for k in KINDS])
def test_each_dropout_kind_equals_jax_bit_for_bit(name, jd, pd, seam):
    key = jax.random.PRNGKey(11)
    x = _x(1)
    want = np.asarray(JaxDense(n_in=7, n_out=3, dropout=jd).maybe_dropout(
        jnp.asarray(x), train=True, rng=key))
    seam.keys = [key]
    layer = DenseLayer(n_in=7, n_out=3, dropout=pd)
    got = layer.maybe_dropout(torch.from_numpy(x), train=True,
                              gen=torch.Generator())
    np.testing.assert_array_equal(got.numpy(), want)
    assert not seam.keys
    # no draw at inference or without a generator
    for train, gen in ((False, torch.Generator()), (True, None)):
        assert torch.equal(layer.maybe_dropout(torch.from_numpy(x),
                                               train=train, gen=gen),
                           torch.from_numpy(x))
    assert seam.kinds == ["normal" if "Gaussian" in name else "uniform"]


def _nested(seed=2):
    r = np.random.RandomState(seed)
    inner = lambda: {"W": r.randn(5, 8).astype(np.float32),   # noqa: E731
                     "RW": r.randn(2, 8).astype(np.float32),
                     "b": r.randn(8).astype(np.float32)}
    return {"fwd": inner(), "bwd": inner(), "b0": r.randn(3).astype(
        np.float32), "pW": r.randn(6).astype(np.float32)}


NOISES = [
    ("DropConnect", lambda b: jwn.DropConnect(apply_to_bias=b,
                                              weight_retain_prob=0.7),
     lambda b: W.DropConnect(apply_to_bias=b, weight_retain_prob=0.7)),
    ("WeightNoise+", lambda b: jwn.WeightNoise(apply_to_bias=b, mean=0.1,
                                               stddev=0.2),
     lambda b: W.WeightNoise(apply_to_bias=b, mean=0.1, stddev=0.2)),
    ("WeightNoise*", lambda b: jwn.WeightNoise(apply_to_bias=b, mean=1.0,
                                               stddev=0.2, additive=False),
     lambda b: W.WeightNoise(apply_to_bias=b, mean=1.0, stddev=0.2,
                             additive=False)),
]


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("name,jn,pn", NOISES, ids=[n[0] for n in NOISES])
def test_weight_noise_on_a_nested_dict_equals_jax_bit_for_bit(name, jn, pn,
                                                              bias, seam):
    params = _nested()
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0x5eed)
    want = jn(bias).apply(jax.tree_util.tree_map(jnp.asarray, params), key)
    seam.keys = noise_keys(params, key, bias)
    n_draws = len(seam.keys)
    got = pn(bias).apply(jax.tree_util.tree_map(torch.from_numpy, params),
                         torch.Generator())
    assert not seam.keys and len(seam.kinds) == n_draws
    assert n_draws == (8 if bias else 5)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=str(path))
    if not bias:
        assert got["fwd"]["b"] is not None
        np.testing.assert_array_equal(got["fwd"]["b"].numpy(),
                                      params["fwd"]["b"])


def test_dropout_keep_share_from_the_generator():
    gen = torch.Generator().manual_seed(5)
    x = torch.ones(N_STATS)
    y = D.Dropout(p=0.5).apply(x, gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) <= KEEP_TOL
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}


def test_gaussian_kinds_moments_from_the_generator():
    gen = torch.Generator().manual_seed(6)
    ones = torch.ones(N_STATS)
    mult = D.GaussianDropout(rate=0.3).apply(ones, gen)
    assert abs(mult.mean().item() - 1.0) <= MOMENT_TOL
    assert abs(mult.var().item() - 0.3 / 0.7) <= MOMENT_TOL
    noise = D.GaussianNoise(stddev=0.5).apply(torch.zeros(N_STATS), gen)
    assert abs(noise.mean().item()) <= MOMENT_TOL
    assert abs(noise.var().item() - 0.25) <= MOMENT_TOL


def test_alpha_dropout_keeps_a_standard_normals_moments():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(N_STATS, generator=torch.Generator().manual_seed(8))
    y = D.AlphaDropout(p=0.1).apply(x, gen)
    assert abs(y.mean().item()) <= MOMENT_TOL
    assert abs(y.var().item() - 1.0) <= MOMENT_TOL


def test_same_seed_and_iteration_give_the_same_draws():
    a, b = torch.Generator(), torch.Generator()
    seed_generator(a, 123, 4)
    seed_generator(b, 123, 4)
    first = D.uniform((1000,), torch.float32, "cpu", a)
    assert torch.equal(first, D.uniform((1000,), torch.float32, "cpu", b))
    seed_generator(b, 123, 5)
    assert not torch.equal(first,
                           D.uniform((1000,), torch.float32, "cpu", b))
    seed_generator(b, 124, 4)
    assert not torch.equal(first,
                           D.uniform((1000,), torch.float32, "cpu", b))
    assert step_seed(123, 4) != step_seed(123, 5) != step_seed(124, 4)
    assert 0 <= step_seed(2 ** 70, 2 ** 65) < 2 ** 64
    seed_generator(None, 1, 1)       # a network that draws nothing


def test_same_draws_replays_the_first_pass():
    gen = torch.Generator().manual_seed(9)
    same = D.SameDraws(gen)
    first = D.drop(torch.ones(50), 0.5, same)
    again = D.drop(torch.ones(50), 0.5, same.replay())
    assert torch.equal(first, again)
    assert len(same.draws) == 1


@pytest.mark.parametrize("obj", [D.Dropout(p=0.25), D.AlphaDropout(p=0.1),
                                 D.GaussianDropout(rate=0.2),
                                 D.GaussianNoise(stddev=0.3),
                                 W.DropConnect(weight_retain_prob=0.9),
                                 W.WeightNoise(stddev=0.05, additive=False,
                                               apply_to_bias=True)],
                         ids=lambda o: type(o).__name__)
def test_serde_round_trips(obj):
    base = D.IDropout if isinstance(obj, D.IDropout) else W.IWeightNoise
    d = json.loads(json.dumps(obj.to_dict()))
    assert base.from_dict(d) == obj
    layer = LSTM(n_in=3, n_out=4, **({"dropout": obj}
                                     if isinstance(obj, D.IDropout)
                                     else {"weight_noise": obj}))
    back = layer_from_dict(json.loads(json.dumps(layer.to_dict())))
    assert back == layer


def test_a_configuration_written_by_the_jax_package_reads_in_the_port():
    jconf = (JaxNNC.builder().seed(3)
             .dropout(jdrop.GaussianDropout(rate=0.2))
             .weight_noise(jwn.DropConnect(weight_retain_prob=0.8))
             .list()
             .layer(JaxBi(fwd=JaxLSTM(n_out=4, dropout=0.3)))
             .layer(JaxLSTM(n_out=4, dropout=jdrop.AlphaDropout(p=0.1)))
             .layer(JaxRnnOut(n_out=5, activation="softmax"))
             .set_input_type(JaxInputType.recurrent(3)).build())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    g = conf.global_conf
    assert g.dropout == D.GaussianDropout(rate=0.2)
    assert g.weight_noise == W.DropConnect(weight_retain_prob=0.8)
    bi, l2, out = conf.layers
    assert isinstance(bi, Bidirectional) and bi.fwd.dropout == 0.3
    assert bi.dropout == D.GaussianDropout(rate=0.2)
    assert l2.dropout == D.AlphaDropout(p=0.1)
    assert out.weight_noise == W.DropConnect(weight_retain_prob=0.8)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    back = JaxMLC.from_json(conf.to_json())
    assert back.layers[1].dropout == jdrop.AlphaDropout(p=0.1)
    assert back.global_conf.weight_noise == jwn.DropConnect(
        weight_retain_prob=0.8)
