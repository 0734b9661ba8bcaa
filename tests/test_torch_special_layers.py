"""The special layers of the port (nn/layers/special.py) held against the
JAX package's on the CPU: AutoEncoder, VariationalAutoencoder,
CenterLossOutputLayer, Yolo2OutputLayer and FrozenLayer, and the
list-valued parameter trees the VAE brings.

Each layer is built in the JAX package and read by the port from its JSON
with the JAX layer's initial parameters (``params_from_numpy``); its
output, its score and the score's gradients agree at float32 rtol 1e-5 /
atol 1e-6, the port's draws (the denoising mask, the VAE's noise) being
the JAX layer's, handed out through the seam at the JAX key. Every layer
type the JAX package registers is one the port reads, and the JSON of
each new layer round-trips both ways. A network with FrozenLayers trains
as the JAX one does: the frozen parameters, their updater state (none)
and a frozen BatchNormalization's running statistics stay as they were,
the score equals JAX's. A zip the JAX package writes of a VAE network and
of a network with frozen layers restores into the port with the JAX
outputs (1e-5), and the port's zip restores into the JAX package.
"""

import json

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
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.util import model_serializer as jser

from deeplearning4j_tpu_torch import MultiLayerNetwork, params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import LAYER_REGISTRY, layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.base import (flatten_params,
                                                     nest_params)
from deeplearning4j_tpu_torch.util import model_serializer as pser

from test_torch_dropout import seam  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
B = 6


def _x(*shape, seed=0, low=None):
    r = np.random.RandomState(seed)
    if low is not None:
        return r.uniform(low, 1.0, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


def _onehot(n, c, seed=1):
    r = np.random.RandomState(seed)
    return np.eye(c, dtype=np.float32)[r.randint(0, c, n)]


def _port_layer(jlayer):
    return layer_from_dict(json.loads(json.dumps(jlayer.to_dict())))


def _jax_params(jlayer, seed=3):
    return jax.tree_util.tree_map(np.asarray,
                                  jlayer.init(jax.random.PRNGKey(seed)))


def _torch_tree(p):
    """A numpy parameter tree as the port's nested tensors."""
    return nest_params({k: torch.from_numpy(np.array(v)) for k, v in
                        flatten_params(p).items()})


def _close(got, want, what=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _grads_close(jlayer, layer, jp, x, labels, keys, seam, **kw):
    """The score and its gradients against JAX's, both at train time with
    the draws at ``keys``."""
    rng = keys[0] if keys else None

    def jscore(p):
        return jlayer.compute_score(p, jnp.asarray(x), labels, None,
                                    train=True, rng=rng, **kw)
    jloss, jgrads = jax.value_and_grad(jscore)(
        jax.tree_util.tree_map(jnp.asarray, jp))
    leaves = {k: v.requires_grad_(True) for k, v in
              flatten_params(_torch_tree(jp)).items()}
    seam.keys = list(keys)
    loss = layer.compute_score(nest_params(leaves), torch.from_numpy(x),
                               None if labels is None
                               else torch.from_numpy(labels), None,
                               train=True, gen=torch.Generator())
    assert not seam.keys
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _close(loss, jloss, "score")
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for (k, _), g in zip(leaves.items(), grads):
        _close(g, want[k], f"grad {k}")


# ---- list-valued parameter trees ---------------------------------------------
def test_list_trees_flatten_to_jax_key_paths():
    """A list in a parameter tree flattens by index (``enc/0/W``) and
    nests back to a list, as the JAX package's key paths run; ten or more
    entries keep their order."""
    tree = {"enc": [{"W": i, "b": -i} for i in range(12)], "xb": 5,
            "fwd": {"W": 1}}
    flat = flatten_params(tree)
    assert list(flat)[:3] == ["enc/0/W", "enc/0/b", "enc/1/W"]
    assert "enc/11/b" in flat and flat["fwd/W"] == 1
    assert nest_params(flat) == tree
    jvae = jl.VariationalAutoencoder(n_in=5, n_out=2,
                                     encoder_layer_sizes=(4, 3),
                                     decoder_layer_sizes=(3,))
    jp = jvae.init(jax.random.PRNGKey(0))
    paths = {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                      for e in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    port = params_from_numpy([_jax_params(jvae)], device="cpu")[0]
    assert set(port) == paths
    assert set(flatten_params(_port_layer(jvae).init(
        torch.Generator().manual_seed(0)))) == paths


def test_every_jax_layer_type_is_read():
    from deeplearning4j_tpu.nn.layers import LAYER_REGISTRY as JREG
    assert set(JREG) <= set(LAYER_REGISTRY)


NEW_LAYERS = [
    jl.AutoEncoder(n_in=7, n_out=4, corruption_level=0.25, l2=1e-3),
    jl.VariationalAutoencoder(n_in=7, n_out=3, encoder_layer_sizes=(5, 4),
                              decoder_layer_sizes=(4,), recon="gaussian"),
    jl.CenterLossOutputLayer(n_in=4, n_out=3, activation="softmax",
                             loss="mcxent", alpha=0.1, lambda_=0.5),
    jl.Yolo2OutputLayer(anchors=[[1.0, 2.0], [3.5, 1.25]], n_classes=3,
                        lambda_coord=4.0),
    jl.FrozenLayer(inner=jl.BatchNormalization(n_in=4, activation="relu")),
    jl.RBM(n_in=6, n_out=4, k=3, visible_unit="gaussian"),
]


@pytest.mark.parametrize("jlayer", NEW_LAYERS,
                         ids=[type(l).__name__ for l in NEW_LAYERS])
def test_json_round_trips_both_ways(jlayer):
    layer = _port_layer(jlayer)
    assert type(layer).__name__ == type(jlayer).__name__
    doc = json.dumps(jlayer.to_dict(), sort_keys=True)
    assert json.dumps(layer.to_dict(), sort_keys=True) == doc
    back = jl.layer_from_dict(json.loads(json.dumps(layer.to_dict())))
    assert json.dumps(back.to_dict(), sort_keys=True) == doc
    again = layer_from_dict(json.loads(doc))
    assert json.dumps(again.to_dict(), sort_keys=True) == doc


# ---- each layer against its JAX counterpart ----------------------------------
@pytest.mark.parametrize("corruption", [0.0, 0.3])
def test_autoencoder_matches_jax(corruption, seam):
    jlayer = jl.AutoEncoder(n_in=7, n_out=4, corruption_level=corruption)
    layer = _port_layer(jlayer)
    jp = _jax_params(jlayer)
    x = _x(B, 7, low=0.0)
    jy, _ = jlayer.apply(jp, jnp.asarray(x))
    _close(layer.apply(_torch_tree(jp), torch.from_numpy(x)), jy, "encode")
    keys = [jax.random.PRNGKey(11)] if corruption else []
    _grads_close(jlayer, layer, jp, x, None, keys, seam)


@pytest.mark.parametrize("recon", ["bernoulli", "gaussian"])
def test_vae_matches_jax(recon, seam):
    jlayer = jl.VariationalAutoencoder(n_in=7, n_out=3,
                                       encoder_layer_sizes=(5, 4),
                                       decoder_layer_sizes=(4, 6),
                                       recon=recon)
    layer = _port_layer(jlayer)
    jp = _jax_params(jlayer)
    tp = _torch_tree(jp)
    x = _x(B, 7, low=0.0)
    z = _x(B, 3, seed=5)
    _close(layer.apply(tp, torch.from_numpy(x)),
           jlayer.apply(jp, jnp.asarray(x))[0], "latent mean")
    _close(layer.reconstruct(tp, torch.from_numpy(x)),
           jlayer.reconstruct(jp, jnp.asarray(x)), "reconstruct")
    _close(layer.generate(tp, torch.from_numpy(z)),
           jlayer.generate(jp, jnp.asarray(z)), "generate")
    # the score without noise (inference) and with the JAX step's noise
    _close(layer.compute_score(tp, torch.from_numpy(x)),
           jlayer.compute_score(jp, jnp.asarray(x)), "score, no noise")
    _grads_close(jlayer, layer, jp, x, None, [jax.random.PRNGKey(4)], seam)


def test_center_loss_matches_jax(seam):
    jlayer = jl.CenterLossOutputLayer(n_in=4, n_out=3, activation="softmax",
                                      loss="mcxent", lambda_=0.5)
    layer = _port_layer(jlayer)
    jp = _jax_params(jlayer)
    # centers away from zero, so their gradient is not only the pull
    jp["centers"] = _x(3, 4, seed=9)
    assert set(layer.init(torch.Generator().manual_seed(0))) == set(jp)
    assert not layer.init(torch.Generator())["centers"].any()
    x, y = _x(B, 4), _onehot(B, 3)
    _close(layer.apply(_torch_tree(jp), torch.from_numpy(x)),
           jlayer.apply(jp, jnp.asarray(x))[0], "output")
    _grads_close(jlayer, layer, jp, x, y, [], seam)


def test_yolo2_matches_jax(seam):
    jlayer = jl.Yolo2OutputLayer(anchors=[[1.0, 2.0], [3.5, 1.25]],
                                 n_classes=3, lambda_coord=4.0)
    layer = _port_layer(jlayer)
    assert layer.anchors == ((1.0, 2.0), (3.5, 1.25))
    x = _x(B, 5, 4, 2 * 8)
    r = np.random.RandomState(2)
    lab = r.rand(B, 5, 4, 2, 8).astype(np.float32)
    lab[..., 4] = (lab[..., 4] > 0.6)
    lab[..., 5:] = np.eye(3, dtype=np.float32)[r.randint(0, 3, (B, 5, 4, 2))]
    lab = lab.reshape(B, 5, 4, 16)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = layer.compute_score({}, xt, torch.from_numpy(lab))
    (g,) = torch.autograd.grad(loss, [xt])
    jloss, jg = jax.value_and_grad(
        lambda a: jlayer.compute_score({}, a, jnp.asarray(lab)))(
        jnp.asarray(x))
    _close(loss, jloss, "loss")
    _close(g, jg, "dloss/dx")
    m = np.array([1, 0, 1, 1, 0, 1], np.float32)
    _close(layer.compute_score({}, torch.from_numpy(x), torch.from_numpy(lab),
                               torch.from_numpy(m)),
           jlayer.compute_score({}, jnp.asarray(x), jnp.asarray(lab),
                                jnp.asarray(m)), "masked loss")


def test_frozen_layer_matches_jax():
    """A frozen BatchNormalization runs in inference mode at train time
    (the running statistics, not the batch's), cuts the gradient and
    writes no state; a frozen output layer scores in inference mode."""
    jbn = jl.FrozenLayer(inner=jl.BatchNormalization(n_in=4,
                                                     activation="relu"))
    bn = _port_layer(jbn)
    jp = _jax_params(jbn)
    st = {"mean": _x(4, seed=3), "var": _x(4, seed=4, low=0.5)}
    x = _x(B, 4)
    jy, jst = jbn.apply(jp, jnp.asarray(x), st, train=True)
    state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    y = bn.apply(tp, torch.from_numpy(x), train=True, state=state)
    _close(y, jy, "frozen BN output")
    assert all(np.array_equal(state[k].numpy(), st[k]) for k in st)
    assert jst is st
    assert not y.requires_grad
    jout = jl.FrozenLayer(inner=jl.OutputLayer(n_in=4, n_out=3,
                                               activation="softmax",
                                               loss="mcxent"))
    out = _port_layer(jout)
    jp = _jax_params(jout)
    yl = _onehot(B, 3)
    _close(out.compute_score(_torch_tree(jp), torch.from_numpy(x),
                             torch.from_numpy(yl), train=True),
           jout.compute_score(jp, jnp.asarray(x), jnp.asarray(yl),
                              train=True), "frozen output score")


# ---- networks ---------------------------------------------------------------
def _frozen_conf():
    return (JaxNNC.builder().seed(7).updater(JaxAdam(1e-2)).l2(1e-3)
            .activation("tanh").list()
            .layer(jl.FrozenLayer(inner=jl.DenseLayer(n_out=6)))
            .layer(jl.FrozenLayer(inner=jl.BatchNormalization()))
            .layer(jl.DenseLayer(n_out=5))
            .layer(jl.BatchNormalization())
            .layer(jl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())


def _arrays(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return MultiLayerNetwork(conf, device="cpu").set_params(
        params_from_numpy(_arrays(jnet.params), device="cpu"),
        _arrays(jnet.state))


def _frozen_nets():
    jnet = JaxMLN(_frozen_conf()).init()
    # running statistics away from their start, so a frozen BN's reads show
    jnet.state[1] = {"mean": jnp.asarray(_x(6, seed=5)),
                     "var": jnp.asarray(_x(6, seed=6, low=0.5))}
    return jnet, _port_of(jnet)


def _nets_close(net, jnet, what):
    for i, p in enumerate(jnet.params):
        for k, v in flatten_params(_arrays(p)).items():
            _close(net.params[i][k], v, f"{what} {i}/{k}")
    for i, s in enumerate(jnet.state):
        for k, v in s.items():
            _close(net.state[i][k], v, f"{what} state {i}/{k}")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "loop"])
def test_frozen_layers_train_as_jax(fused):
    from deeplearning4j_tpu_torch.nn.fused_update import set_fused_update
    set_fused_update(fused)
    try:
        jnet, net = _frozen_nets()
    finally:
        set_fused_update(None)
    start = [{k: v.clone() for k, v in p.items()} for p in net.params]
    st0 = [{k: v.clone() for k, v in s.items()} for s in net.state]
    assert net.opt_state[0] == {} and net.opt_state[1] == {}
    assert net.opt_state[2]
    x, y = _x(8, 4, seed=2), _onehot(8, 3, seed=3)
    np.testing.assert_allclose(net.score(x=x, y=y), jnet.score(x=x, y=y),
                               rtol=RTOL)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=RTOL)
    for i in (0, 1):
        assert all(torch.equal(net.params[i][k], start[i][k])
                   for k in start[i])
        assert net.opt_state[i] == {}
    assert all(torch.equal(net.state[1][k], st0[1][k]) for k in st0[1])
    assert not torch.equal(net.state[3]["mean"], st0[3]["mean"])
    assert not torch.equal(net.params[2]["W"], start[2]["W"])
    _nets_close(net, jnet, "after 3 steps")
    _close(net.output(x), jnet.output(x), "output")
    np.testing.assert_allclose(net.score(x=x, y=y), jnet.score(x=x, y=y),
                               rtol=RTOL)


def test_frozen_network_zips_round_trip(tmp_path):
    jnet, _ = _frozen_nets()
    x, y = _x(8, 4, seed=2), _onehot(8, 3, seed=3)
    jnet.fit(x, y)
    jser.write_model(jnet, tmp_path / "jax.zip")
    net = pser.restore_multi_layer_network(tmp_path / "jax.zip",
                                           device="cpu")
    assert net.opt_state[0] == {} and net.opt_state[1] == {}
    _close(net.output(x), jnet.output(x), "restored output")
    _nets_close(net, jnet, "restored")
    # the restored updater state resumes: one more step on both
    jnet.fit(x, y)
    net.fit(x, y)
    _nets_close(net, jnet, "resumed")
    net.save(tmp_path / "port.zip")
    back = jser.restore_multi_layer_network(str(tmp_path / "port.zip"))
    _close(net.output(x), back.output(x), "JAX restore of the port's zip")
    want = jax.tree_util.tree_leaves(jnet.opt_state)
    got = jax.tree_util.tree_leaves(back.opt_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(np.asarray(a), b, "updater state")


def _vae_conf():
    return (JaxNNC.builder().seed(5).updater(JaxAdam(1e-2)).list()
            .layer(jl.VariationalAutoencoder(
                n_out=3, encoder_layer_sizes=(6, 5), decoder_layer_sizes=(5,),
                activation="tanh"))
            .layer(jl.OutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.feed_forward(7)).build())


def test_vae_network_zips_round_trip(tmp_path):
    jnet = JaxMLN(_vae_conf()).init()
    x, y = _x(6, 7, low=0.0), _onehot(6, 2)
    jnet.fit(x, y)
    jser.write_model(jnet, tmp_path / "jax.zip")
    net = pser.restore_multi_layer_network(tmp_path / "jax.zip",
                                           device="cpu")
    assert "enc/1/W" in net.params[0] and "0/.mu/enc/1/W" in net.opt_state[0]
    _close(net.output(x), jnet.output(x), "restored output")
    jnet.fit(x, y)
    net.fit(x, y)
    _nets_close(net, jnet, "resumed")
    net.save(tmp_path / "port.zip")
    back = jser.restore_multi_layer_network(str(tmp_path / "port.zip"))
    _close(net.output(x), back.output(x), "JAX restore of the port's zip")
    assert isinstance(back.params[0]["enc"], list)


@pytest.mark.parametrize("jlayer", [
    jl.AutoEncoder(n_in=7, n_out=4, l1=1e-2, l2=1e-3),
    jl.VariationalAutoencoder(n_in=7, n_out=3, encoder_layer_sizes=(5,),
                              decoder_layer_sizes=(4,), l1=1e-2, l2=1e-3),
    jl.CenterLossOutputLayer(n_in=4, n_out=3, l1=1e-2, l2=1e-3),
    jl.RBM(n_in=6, n_out=4, l1=1e-2, l2=1e-3)],
    ids=["AutoEncoder", "VariationalAutoencoder", "CenterLossOutputLayer",
         "RBM"])
def test_regularisation_skips_what_jax_skips(jlayer):
    """Caveat R10: only top-level keys starting with ``b`` (or naming a
    norm parameter) escape l1/l2, so ``vb``, ``xb``, ``zb_*``, the VAE's
    nested biases and ``centers`` are penalised, as in the JAX package."""
    layer = _port_layer(jlayer)
    # every parameter moved off zero, so a penalised bias counts
    jp = jax.tree_util.tree_map(lambda v: v + 0.5, _jax_params(jlayer))
    flat = {k: torch.from_numpy(np.array(v))
            for k, v in flatten_params(jp).items()}
    _close(layer.reg_loss(flat), jlayer.reg_loss(jp), "l1/l2")
