"""Training with dropout and weight noise in the port, held against the JAX
package on the CPU, with the JAX package's own draws fed through the
port's draw seam (see tests/test_torch_dropout.py: ``mln_keys`` /
``graph_keys`` give the keys of a JAX train step in the order the port
draws).

MultiLayerNetwork: the TextGenerationLSTM shape at small width (vocab 9,
2 x LSTM(8), softmax RnnOutputLayer, Adam(1e-3) and element-wise clipping
at 10, T=6, B=4) with dropout 0.5 on layer 1 only (S1: the pair still
fuses), a global dropout 0.2 (S2: layer 2's dropout breaks the pair), a
global DropConnect(0.8) (S3), and a global GaussianDropout with additive
WeightNoise; three steps of ``fit`` on arrays, on a DataSet, on an
iterator and of ``fit_scan``. ComputationGraph: TinyTransformer at small
width (d_model 32, 4 heads, 2 blocks, T=16) with dropout 0.1 on every
layer (S5) and with DropConnect; three ``fit`` steps. The reference
behaviour held: truncated BPTT runs its LSTM layers without dropout (their
``apply_with_carry`` drops nothing) but the output layer's dropout and
every weight noise still draw; Bidirectional gives both directions one
draw. With the real generator a checkpoint written mid-training resumes to
the parameters of an unbroken run, and the same seed repeats a run.

Tolerances are tests/test_torch_training.py's: losses 1e-6 relative,
step-1 gradients 1e-5 of their largest magnitude, parameters 2e-6
absolute. Adam divides a gradient by its root mean square plus eps
(1e-8), so an element whose gradient is below 10 x eps moves by a
fraction of lr that rounding in the gradient decides (dropout leaves such
elements: one had gradient 5.6e-10 in the JAX package and 5.4e-10 in the
port, and Adam moved the two by 5e-5 and 5e-5 - 2.3e-6); such elements,
and TinyTransformer's key bias ``bk`` (no gradient, see
tests/test_torch_graph_training.py), are held to 2 x lr x steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import dropout as jdrop
from deeplearning4j_tpu.nn import weightnoise as jwn
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.layers.core import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.layers.rnn import Bidirectional as JaxBi
from deeplearning4j_tpu.nn.layers.rnn import LastTimeStep as JaxLast
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny

from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork,
                                      params_from_numpy)
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import dropout as D
from deeplearning4j_tpu_torch.nn.conf import (ComputationGraphConfiguration,
                                              MultiLayerConfiguration)

from test_torch_dropout import JaxKeys, graph_keys, mln_keys

V, H, T, B = 9, 8, 6, 4
LR = 1e-3
LOSS_RTOL, GRAD_TOL, P_TOL = 1e-6, 1e-5, 2e-6
EPS_FLOOR = 1e-7          # 10 x Adam's eps: below it Adam moves by sign noise
TV, TD, TT, TB = 11, 32, 16, 3
SMALL_TINY = dict(vocab_size=TV, n_layers=2, d_model=TD, n_heads=4,
                  max_len=64)


@pytest.fixture
def seam(monkeypatch):
    feed = JaxKeys()
    monkeypatch.setattr(D, "uniform", feed.uniform)
    monkeypatch.setattr(D, "normal", feed.normal)
    return feed


def lstm_conf(kind, tbptt=None, seed=7):
    """The S rows at small width (JAX configuration)."""
    b = (JaxNNC.builder().seed(seed).updater(JaxAdam(LR))
         .weight_init("xavier")
         .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0))
    if kind == "S2":
        b = b.dropout(0.2)
    elif kind == "S3":
        b = b.weight_noise(jwn.DropConnect(weight_retain_prob=0.8))
    elif kind == "gaussian":
        b = b.dropout(jdrop.GaussianDropout(rate=0.2)).weight_noise(
            jwn.WeightNoise(stddev=0.05))
    lb = (b.list()
          .layer(JaxLSTM(n_out=H, activation="tanh",
                         dropout=0.5 if kind == "S1" else None))
          .layer(JaxLSTM(n_out=H, activation="tanh"))
          .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
          .set_input_type(JaxInputType.recurrent(V)))
    if tbptt:
        lb = lb.backprop_type("tbptt", tbptt, tbptt)
    return lb.build()


def port_of(jnet):
    """The port's network from the JAX network's JSON and parameters."""
    arrays = jax.tree_util.tree_map(np.asarray, jnet.params)
    if isinstance(jnet, JaxCG):
        conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
        return ComputationGraph(conf, device="cpu").set_params(
            params_from_numpy(arrays, device="cpu"))
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return MultiLayerNetwork(conf, device="cpu").set_params(
        params_from_numpy(arrays, device="cpu"))


def batch(seed, n=B, t=T, v=V):
    r = np.random.RandomState(seed)
    eye = np.eye(v, dtype=np.float32)
    return eye[r.randint(0, v, (n, t))], eye[r.randint(0, v, (n, t))]


def flat(tree):
    """A JAX parameter tree as {path: ndarray} (the port's path keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = np.asarray(leaf)
    return out


def port_flat(net):
    items = net.params.items() if isinstance(net.params, dict) \
        else enumerate(net.params)
    return {f"{i}/{k}": v.detach().numpy() for i, p in items
            for k, v in p.items()}


def params_close(jnet, net, grads, steps, lr=LR):
    """Every parameter within P_TOL, except elements whose step-1 JAX
    gradient is below EPS_FLOOR and key biases, within 2 x lr x steps."""
    want, got, g = flat(jnet.params), port_flat(net), flat(grads)
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        tol = np.where(np.abs(g[k]) < EPS_FLOOR, 2 * lr * steps, P_TOL)
        if k.endswith("/bk"):
            tol = np.full_like(w, 2 * lr * steps)
        err = np.abs(got[k] - w)
        assert (err <= tol).all(), (k, float(err.max()))


def jax_grads(jnet, x, y, it=0):
    """The JAX train step's loss and gradients at iteration ``it`` (with
    its draws), before any update."""
    rng = jax.random.fold_in(
        jax.random.PRNGKey(jnet.conf.global_conf.seed), it)
    if isinstance(jnet, JaxCG):
        def loss(p):
            return jnet._loss(p, jnet.state, [jnp.asarray(x)],
                              [jnp.asarray(y)], rng)[0]
    else:
        def loss(p):
            return jnet._loss(p, jnet.state, jnp.asarray(x), jnp.asarray(y),
                              rng, None, None)[0]
    return jax.value_and_grad(loss)(jnet.params)


def grads_close(jg, grads):
    want = flat(jg)
    items = grads.items() if isinstance(grads, dict) else enumerate(grads)
    got = {f"{i}/{k}": v.numpy() for i, p in items for k, v in p.items()}
    scale = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= GRAD_TOL * scale, k


@pytest.mark.parametrize("path", ["arrays", "dataset", "iterator", "scan"])
@pytest.mark.parametrize("kind", ["S1", "S2", "S3", "gaussian"])
def test_three_steps_with_dropout_and_weight_noise_match_jax(kind, path,
                                                             seam):
    jnet = JaxMLN(lstm_conf(kind)).init()
    net = port_of(jnet)
    x, y = batch(0)
    _, jg = jax_grads(jnet, x, y)
    seam.keys = mln_keys(jnet, 0)
    n_draws = len(seam.keys)
    assert n_draws == {"S1": 1, "S2": 3, "S3": 5, "gaussian": 8}[kind]
    if path == "scan":
        seam.keys = [k for it in range(3) for k in mln_keys(jnet, it)]
        jnet.fit_scan(np.stack([x] * 3), np.stack([y] * 3))
        net.fit_scan(np.stack([x] * 3), np.stack([y] * 3))
        assert not seam.keys
    elif path == "iterator":
        seam.keys = [k for it in range(3) for k in mln_keys(jnet, it)]
        jnet.fit(JaxListIterator(JaxDataSet(x, y), B), epochs=3)
        net.fit(ListDataSetIterator(DataSet(x, y), B), epochs=3)
        assert not seam.keys
    else:
        for _ in range(3):
            seam.keys = mln_keys(jnet, jnet.iteration)
            if path == "arrays":
                jnet.fit(x, y)
                net.fit(x, y)
            else:
                jnet.fit(JaxDataSet(x, y))
                net.fit(DataSet(x, y))
            assert not seam.keys
            np.testing.assert_allclose(net.get_score(),
                                       float(jnet.get_score()),
                                       rtol=LOSS_RTOL)
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    assert net.iteration == jnet.iteration == 3
    params_close(jnet, net, jg, 3)


@pytest.mark.parametrize("kind", ["S1", "S2", "S3"])
def test_step_one_gradients_under_the_jax_draws(kind, seam):
    jnet = JaxMLN(lstm_conf(kind)).init()
    net = port_of(jnet)
    x, y = batch(1)
    jl, jg = jax_grads(jnet, x, y)
    seam.keys = mln_keys(jnet, 0)
    loss, grads, _ = net._gradients(torch.from_numpy(x), torch.from_numpy(y),
                                    gen=torch.Generator())
    assert not seam.keys
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    grads_close(jg, grads)
    # without the generator: no draw, the noiseless loss
    jl0 = jnet._loss(jnet.params, jnet.state, jnp.asarray(x),
                     jnp.asarray(y), None, None, None)[0]
    np.testing.assert_allclose(net.score(DataSet(x, y)), float(jl0),
                               rtol=LOSS_RTOL)


def _tiny_pair(kind, seed=123):
    jconf = JaxTiny(seed=seed, **SMALL_TINY).conf()
    for node in jconf.nodes.values():
        if node.layer is None:
            continue
        if kind == "dropout":
            node.layer.dropout = 0.1
        else:
            node.layer.weight_noise = jwn.DropConnect(weight_retain_prob=0.9)
    jnet = JaxCG(jconf).init()
    return jnet, port_of(jnet)


@pytest.fixture
def jax_kernels_interpreted():
    jops.set_helpers_enabled(True, interpret=True)
    yield
    jops.set_helpers_enabled(None)


@pytest.mark.parametrize("kind", ["dropout", "weight_noise"])
def test_tiny_transformer_three_steps_match_jax(kind, seam,
                                                jax_kernels_interpreted):
    jnet, net = _tiny_pair(kind)
    x, y = batch(2, n=TB, t=TT, v=TV)
    _, jg = jax_grads(jnet, x, y)
    for _ in range(3):
        seam.keys = graph_keys(jnet, jnet.iteration)
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
        assert not seam.keys
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=LOSS_RTOL)
    params_close(jnet, net, jg, 3, lr=3e-4)


def test_tbptt_chunks_drop_nothing_in_the_lstm_layers(seam):
    """Caveat: ``apply_with_carry`` drops nothing, so under truncated BPTT
    only the output layer's dropout draws (the LSTM layers' 0.2 does not),
    every chunk at the batch's iteration (the same keys)."""
    jnet = JaxMLN(lstm_conf("S2", tbptt=3)).init()
    net = port_of(jnet)
    x, y = batch(3)
    keys = mln_keys(jnet, 0, carried=True)
    assert len(keys) == 1                       # the output layer's
    seam.keys = keys * 2                        # two chunks of 3
    jnet.fit(x, y)
    net.fit(x, y)
    assert not seam.keys
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    _, jg = jax_grads(jnet, x, y)
    params_close(jnet, net, jg, 2)


def test_bidirectional_directions_share_one_draw(seam):
    """Caveat: the JAX Bidirectional passes one key to both directions, so
    the backward direction's dropout mask is the forward direction's,
    applied to the time-reversed input: the port draws once and replays."""
    jconf = (JaxNNC.builder().seed(5).updater(JaxAdam(LR)).list()
             .layer(JaxBi(fwd=JaxLSTM(n_out=H, activation="tanh",
                                      dropout=0.4), mode="concat"))
             .layer(JaxLast(fwd=JaxLSTM(n_out=H, activation="tanh",
                                        dropout=0.3)))
             .layer(JaxOut(n_out=V, activation="softmax", loss="mcxent",
                           dropout=0.2))
             .set_input_type(JaxInputType.recurrent(V)).build())
    jnet = JaxMLN(jconf).init()
    net = port_of(jnet)
    x, y = batch(4)
    y = y[:, -1]
    _, jg = jax_grads(jnet, x, y)
    masks = []
    real = D.bernoulli

    def spy(keep, shape, device, gen):
        masks.append(real(keep, shape, device, gen))
        return masks[-1]
    D.bernoulli = spy
    try:
        for _ in range(3):
            seam.keys = mln_keys(jnet, jnet.iteration)
            assert len(seam.keys) == 3
            jnet.fit(JaxDataSet(x, y))
            net.fit(DataSet(x, y))
            assert not seam.keys
    finally:
        D.bernoulli = real
    # four masks a step (Bidirectional's two, LastTimeStep's, the output
    # layer's) from three draws: the two directions' masks are one
    assert len(masks) == 12
    for k in range(0, 12, 4):
        assert torch.equal(masks[k], masks[k + 1])
        assert not torch.equal(masks[k], masks[k + 4 if k < 8 else 0])
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    params_close(jnet, net, jg, 3)


@pytest.mark.parametrize("kind", ["S2", "S3"])
def test_checkpoint_resumes_the_same_draws(kind, tmp_path):
    """With the real generator: two steps, save, two more, against a net
    loaded from the save taking the same two steps; and the same seed
    repeats the whole run."""
    conf = MultiLayerConfiguration.from_json(lstm_conf(kind).to_json())
    batches = [batch(10 + k) for k in range(4)]

    def run(net, bs):
        for x, y in bs:
            net.fit(DataSet(x, y))
        return net
    first = run(MultiLayerNetwork(conf, device="cpu").init(), batches[:2])
    first.save(tmp_path / "mid.zip")
    run(first, batches[2:])
    resumed = run(MultiLayerNetwork.load(tmp_path / "mid.zip", device="cpu"),
                  batches[2:])
    again = run(MultiLayerNetwork(conf, device="cpu").init(), batches)
    for other in (resumed, again):
        assert other.iteration == first.iteration == 4
        for a, b in zip(first.params, other.params):
            for k in a:
                assert torch.equal(a[k], b[k]), k
    # a net that draws nothing (no dropout, no weight noise) has no
    # generator
    plain = MultiLayerConfiguration.from_json(lstm_conf(None).to_json())
    assert MultiLayerNetwork(plain, device="cpu")._gen is None
    assert first._gen is not None


def test_l1_gradient_at_zero_matches_jax():
    """F5: the l1 penalty's gradient at a parameter exactly 0 is 1 in the
    JAX package (``jnp.abs``); the port's matches it (torch's ``abs``
    would give 0), which a zero-initialised bias under a path key (a
    Bidirectional layer's ``fwd/b``) meets on its first step."""
    layer = JaxLSTM(n_in=3, n_out=2, l1=0.5, l2=0.25)
    w = np.array([[0.0, -1.5, 2.0, 0.0, 0.5, -0.0, 1.0, 0.0]] * 3,
                 np.float32)
    jg = jax.grad(lambda p: layer.reg_loss(p))({"W": jnp.asarray(w)})
    port = port_of(JaxMLN(lstm_conf(None)).init()).layers[0]
    port.l1, port.l2 = 0.5, 0.25
    t = torch.from_numpy(w).requires_grad_()
    port.reg_loss({"W": t, "fwd/W": t}).backward()
    np.testing.assert_array_equal(t.grad.numpy(), 2 * np.asarray(jg["W"]))
