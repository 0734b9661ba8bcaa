"""Layerwise pretraining in the port (nn/layers/pretrain.py and
MultiLayerNetwork.pretrain) held against the JAX package's on the CPU.

The port draws through the seam of nn/dropout.py; here the seam hands out
the JAX step's draws at its keys (a Bernoulli sample is ``uniform < p``,
as ``jax.random.bernoulli`` draws it). The RBM's CD-k step (k = 1 and 3,
binary and Gaussian visible units) gives the JAX step's parameters and
reconstruction error within 1e-6; the gradient steps of an AutoEncoder
(corrupted) and a VariationalAutoencoder (reparameterised) within 1e-6 of
the largest parameter. ``pretrain`` over an RBM and an AutoEncoder, 2
epochs of 3 batches, gives the JAX network's parameters and score, with
each (layer, epoch, batch) drawing at the JAX key ``i * 100003 + ep * 1009
+ j``; a plain generator is read into a list first, a DataSet is one
batch. A VAE network's -ELBO falls over 2 epochs of the port's own draws,
and pretraining through a uint8-wire iterator with a ``device_side``
scaler equals pretraining on the scaled floats (the JAX package applies
no pre-processor there: caveat R11).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.layers.pretrain import \
    get_pretrain_step as jax_step_of
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator

from deeplearning4j_tpu_torch import MultiLayerNetwork, params_from_numpy
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.data.normalizers import \
    ImagePreProcessingScaler
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.base import flatten_params
from deeplearning4j_tpu_torch.nn.layers.pretrain import get_pretrain_step

from test_torch_dropout import seam  # noqa: F401

TOL = 1e-6
B, N_IN = 8, 12
LR = 0.05


def _x(n=B, d=N_IN, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, (n, d)).astype(
        np.float32)


def _port(jlayer):
    return layer_from_dict(jlayer.to_dict())


def _arrays(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tensors(p):
    return {k: torch.from_numpy(np.array(v))
            for k, v in flatten_params(_arrays(p)).items()}


def _close(got, want, what, scale=1.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    assert err <= TOL * scale, (what, err)


def rbm_keys(layer, rng):
    """The keys of one JAX CD-k step at ``rng``, in draw order: each of
    the k - 1 Gibbs steps' hidden sample (and, for binary visible units,
    its visible sample), then the k-th hidden sample."""
    keys, key = [], rng
    for _ in range(layer.k - 1):
        key, k1, k2 = jax.random.split(key, 3)
        keys += [k1, k2] if layer.visible_unit == "binary" else [k1]
    return keys + [jax.random.fold_in(rng, 7)]


def step_keys(layer, rng):
    """The keys one JAX pretrain step of ``layer`` draws at."""
    name = type(layer).__name__
    if name == "RBM":
        return rbm_keys(layer, rng)
    if name == "AutoEncoder" and layer.corruption_level <= 0:
        return []
    return [rng]


@pytest.mark.parametrize("k,visible", [(1, "binary"), (3, "binary"),
                                       (3, "gaussian")])
def test_rbm_cd_k_matches_jax(k, visible, seam):
    jlayer = jl.RBM(n_in=N_IN, n_out=7, k=k, visible_unit=visible)
    layer = _port(jlayer)
    jp = jlayer.init(jax.random.PRNGKey(1))
    x = _x()
    rng = jax.random.PRNGKey(42)
    jnew, jrec = jax.jit(jlayer.pretrain_step)(jp, jnp.asarray(x), rng,
                                               jnp.asarray(LR))
    seam.keys = rbm_keys(jlayer, rng)
    new, rec = layer.pretrain_step(_tensors(jp), torch.from_numpy(x),
                                   torch.Generator(), LR)
    assert not seam.keys
    assert seam.kinds == ["uniform"] * len(seam.kinds)
    _close(rec, jrec, "reconstruction error")
    for key in ("W", "b", "vb"):
        _close(new[key], jnew[key], key)
    # as a feed-forward layer: the propagation up
    _close(layer.apply(_tensors(jp), torch.from_numpy(x)),
           jlayer.apply(jp, jnp.asarray(x))[0], "propup")


@pytest.mark.parametrize("jlayer", [
    jl.AutoEncoder(n_in=N_IN, n_out=5, corruption_level=0.3),
    jl.VariationalAutoencoder(n_in=N_IN, n_out=3, encoder_layer_sizes=(6,),
                              decoder_layer_sizes=(6, 5))],
    ids=["AutoEncoder", "VariationalAutoencoder"])
def test_gradient_pretrain_step_matches_jax(jlayer, seam):
    layer = _port(jlayer)
    jp = jlayer.init(jax.random.PRNGKey(2))
    x = _x(seed=3)
    rng = jax.random.PRNGKey(9)
    jnew, jloss = jax.jit(jax_step_of(jlayer))(jp, jnp.asarray(x), rng,
                                               jnp.asarray(LR))
    seam.keys = [rng]
    new, loss = get_pretrain_step(layer)(_tensors(jp), torch.from_numpy(x),
                                         torch.Generator(), LR)
    assert not seam.keys
    _close(loss, jloss, "loss", scale=max(1.0, abs(float(jloss))))
    want = flatten_params(_arrays(jnew))
    assert set(new) == set(want)
    for key, v in want.items():
        _close(new[key], v, key, scale=max(1.0, float(np.abs(v).max())))


def _pretrain_conf():
    return (JaxNNC.builder().seed(17).activation("sigmoid").list()
            .layer(jl.RBM(n_out=9, k=2))
            .layer(jl.AutoEncoder(n_out=6, corruption_level=0.25))
            .layer(jl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.feed_forward(N_IN)).build())


def _data(n_batches=3, seed=4):
    x = _x(n_batches * B, seed=seed)
    y = np.eye(3, dtype=np.float32)[
        np.random.RandomState(seed).randint(0, 3, len(x))]
    return x, y


def _pair(conf):
    jnet = JaxMLN(conf).init()
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").set_params(params_from_numpy(_arrays(jnet.params),
                                                   device="cpu"))
    return jnet, net


def pretrain_keys(jnet, n_batches, epochs):
    """The JAX keys of ``pretrain`` in the port's draw order: layer by
    layer, epoch by epoch, batch by batch."""
    seed = jnet.conf.global_conf.seed
    keys = []
    for i, layer in enumerate(jnet.layers):
        if jax_step_of(layer) is None:
            continue
        for ep in range(epochs):
            for j in range(n_batches):
                rng = jax.random.fold_in(jax.random.PRNGKey(seed),
                                         i * 100003 + ep * 1009 + j)
                keys += step_keys(layer, rng)
    return keys


@pytest.mark.parametrize("form", ["iterator", "generator"])
def test_mln_pretrain_matches_jax(form, seam):
    x, y = _data()
    jnet, net = _pair(_pretrain_conf())
    jnet.pretrain(JaxListIterator(JaxDataSet(x, y), B), epochs=2, lr=LR)
    seam.keys = pretrain_keys(jnet, 3, 2)
    if form == "iterator":
        data = ListDataSetIterator(DataSet(x, y), B)
    else:
        data = (DataSet(x[i:i + B], y[i:i + B]) for i in range(0, len(x), B))
    start = {k: v.clone() for k, v in net.params[2].items()}
    net.pretrain(data, epochs=2, lr=LR)
    assert not seam.keys
    _close(net.get_score(), float(jnet._score), "score")
    for i, p in enumerate(jnet.params):
        for k, v in flatten_params(_arrays(p)).items():
            _close(net.params[i][k], v, f"{i}/{k}",
                   scale=max(1.0, float(np.abs(v).max())))
    # the output layer has no pretrain step
    assert all(torch.equal(net.params[2][k], start[k]) for k in start)


def test_pretrain_of_a_dataset_is_one_batch(seam):
    x, y = _data(1)
    jnet, net = _pair(_pretrain_conf())
    jnet.pretrain(JaxDataSet(x, y), epochs=1, lr=LR)
    seam.keys = pretrain_keys(jnet, 1, 1)
    net.pretrain(DataSet(x, y), epochs=1, lr=LR)
    assert not seam.keys
    for k, v in jnet.params[1].items():
        _close(net.params[1][k], np.asarray(v), k)


def test_vae_pretraining_lowers_the_elbo():
    """A VAE network's -ELBO (the pretrain score) falls over 2 epochs of
    the port's own draws; ``reconstruct`` and ``generate`` give values in
    [0, 1] of the input's width."""
    conf = (JaxNNC.builder().seed(3).list()
            .layer(jl.VariationalAutoencoder(
                n_out=4, encoder_layer_sizes=(16,),
                decoder_layer_sizes=(16,)))
            .layer(jl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.feed_forward(N_IN)).build())
    _, net = _pair(conf)
    x = (_x(64, seed=8) > 0.5).astype(np.float32)
    it = ListDataSetIterator(DataSet(x, np.zeros((64, 3), np.float32)), 16)
    vae = net.layers[0]
    from deeplearning4j_tpu_torch.nn.layers.base import nest_params
    xt = torch.from_numpy(x)

    def elbo():
        return float(vae.compute_score(nest_params(net.params[0]), xt))
    before = elbo()
    net.pretrain(it, epochs=2, lr=0.05)
    assert elbo() < before
    p = nest_params(net.params[0])
    rec = vae.reconstruct(p, xt)
    gen = vae.generate(p, torch.randn(5, 4, generator=torch.Generator()
                                      .manual_seed(0)))
    assert rec.shape == (64, N_IN) and gen.shape == (5, N_IN)
    assert all(((t >= 0) & (t <= 1)).all() for t in (rec, gen))


def test_pretrain_applies_a_device_side_scaler():
    """Through a uint8 iterator with a ``device_side`` scaler, the layers
    pretrain on the scaled pixels: as pretraining on the floats does."""
    x, y = _data(2, seed=6)
    raw = np.round(x * 255).astype(np.uint8)
    nets = [_pair(_pretrain_conf())[1] for _ in range(2)]
    wire = ListDataSetIterator(DataSet(raw, y), B)
    wire.set_pre_processor(ImagePreProcessingScaler(device_side=True))
    nets[0].pretrain(wire, epochs=1, lr=LR)
    nets[1].pretrain(ListDataSetIterator(
        DataSet(raw.astype(np.float32) / 255.0, y), B), epochs=1, lr=LR)
    for a, b in zip(*(n.params for n in nets)):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7)
