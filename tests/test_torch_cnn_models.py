"""The convolutional zoo models in the port held against the JAX package
on the CPU: LeNet, SimpleCNN, AlexNet, VGG16, Darknet19 and ResNet50 (a
ComputationGraph, at ``width_mult`` 0.125), each at a small input size;
the bundled CNN zips; the commit points of the layer state.

Each model is built in the JAX package, read by the port from its JSON,
and given the JAX model's initial parameters and state: ``num_params``
and ``summary`` equal, ``output`` equal, one ``fit`` step (the model's
own updater, the port's dropout fed the JAX step's draws) with equal
loss, parameters and BatchNormalization state. Tolerances: loss rtol
1e-5; outputs, parameters and state rtol 1e-4 / atol 1e-5 (a deep stack
sums in another order). ResNet50 and Darknet19 run in float64 in both
packages (``jax.enable_x64``): their train-mode forward runs 53 and 18
batch normalizations over sigmoid or leaky-relu convolutions, which
multiply float32 rounding by up to ~1e3 (float32 at full width is phase
12 of chip_smoke.py's, at rtol 1e-3); the others in float32. An Adam
step moves every parameter by about lr x sign(gradient), so an element
whose gradient is below 1e-3 of its layer's largest (rounding may flip
its sign) is held to 2 x lr. ``lenet.zip`` and ``simplecnn.zip`` reproduce the manifest's
accuracy within 0.02, as tests/test_pretrained.py holds the JAX package;
``resnet50_cifar10.zip`` the same, marked slow as the JAX test is.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.zoo import resnet as jresnet
from deeplearning4j_tpu.zoo import simple as jsimple

from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork,
                                      params_from_numpy)
from deeplearning4j_tpu_torch.data.fetchers import (_synthetic_images,
                                                    load_cifar10, load_mnist)
from deeplearning4j_tpu_torch.nn.conf import (ComputationGraphConfiguration,
                                              MultiLayerConfiguration)
from deeplearning4j_tpu_torch.zoo import (LeNet, ResNet50, ResNet50Cifar,
                                          SimpleCNN, ZooModel)

from test_torch_dropout import graph_keys, mln_keys, seam  # noqa: F401

LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-5
SIGN_FLOOR = 1e-3
B, CLASSES = 2, 5

# (name, JAX zoo class, port zoo class, constructor keywords, batch, dtype)
MODELS = [
    ("lenet", jsimple.LeNet, LeNet, {}, B, "float32"),
    ("simplecnn", jsimple.SimpleCNN, SimpleCNN,
     dict(input_shape=(16, 16, 3)), 4, "float32"),
    ("alexnet", jsimple.AlexNet, None, dict(input_shape=(67, 67, 3)), B,
     "float32"),
    ("vgg16", jsimple.VGG16, None, dict(input_shape=(32, 32, 3)), B,
     "float32"),
    ("darknet19", jsimple.Darknet19, None, dict(input_shape=(64, 64, 3)), 4,
     "float64"),
    ("resnet50", jresnet.ResNet50, ResNet50,
     dict(input_shape=(64, 64, 3), width_mult=0.125), 4, "float64"),
]


def _arrays(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_of(jnet):
    """The port's network of the JAX network's JSON, parameters and
    state."""
    graph = hasattr(jnet.conf, "network_inputs")
    conf = (ComputationGraphConfiguration if graph
            else MultiLayerConfiguration).from_json(jnet.conf.to_json())
    net = (ComputationGraph if graph else MultiLayerNetwork)(conf,
                                                             device="cpu")
    return net.set_params(params_from_numpy(_arrays(jnet.params),
                                            device="cpu"),
                          _arrays(jnet.state))


def _batch(shape, seed=0, n=B, dtype=np.float32):
    r = np.random.RandomState(seed)
    x = r.rand(n, *shape).astype(dtype)
    y = np.eye(CLASSES, dtype=dtype)[r.randint(0, CLASSES, n)]
    return x, y


def _jax_net(jzoo, dtype):
    """The JAX zoo network at ``dtype`` (float64 inside
    ``jax.enable_x64``)."""
    conf = jzoo.conf()
    conf.global_conf.dtype = dtype
    cls = JaxCG if hasattr(conf, "network_inputs") else JaxMLN
    return cls(conf).init()


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _items(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _trees_close(got, want, what):
    for i, p in _items(want):
        for k, v in p.items():
            _close(got[i][k], v, f"{what} {i}/{k}")


def _params_close(net, jnet, lr):
    """Parameters within RTOL / ATOL; after an Adam step (``lr``) an
    element whose first moment (the gradient x 0.1) is below SIGN_FLOOR
    of its layer's largest within 2 x lr."""
    for i, p in _items(jnet.params):
        opt = net.opt_state[i]
        for k, v in p.items():
            got, want = net.params[i][k].numpy(), np.asarray(v)
            tol = ATOL + RTOL * np.abs(want)
            mu = opt.get(f"0/.mu/{k}")
            if lr is not None and mu is not None:
                mu = mu.abs().numpy()
                tol = np.where(mu < SIGN_FLOOR * mu.max(), 2 * lr, tol)
            err = np.abs(got - want)
            assert (err <= tol).all(), (f"{i}/{k}", float(err.max()))


@pytest.mark.parametrize("name,jcls,cls,kw,n,dtype", MODELS,
                         ids=[m[0] for m in MODELS])
def test_model_matches_jax(name, jcls, cls, kw, n, dtype, seam):
    with jax.enable_x64(dtype == "float64"):
        _model_matches_jax(jcls, cls, kw, n, dtype, seam)


def _model_matches_jax(jcls, cls, kw, n, dtype, seam):
    jzoo = jcls(num_classes=CLASSES, **kw)
    jnet = _jax_net(jzoo, dtype)
    net = port_of(jnet)
    if cls is not None:     # the port's zoo builds the same configuration
        assert cls(num_classes=CLASSES, **kw).conf().to_json() \
            == jzoo.conf().to_json()
    assert net.num_params() == jnet.num_params()
    assert net.summary() == jnet.summary()
    x, y = _batch(jzoo.input_shape, n=n, dtype=dtype)
    # the port reads float64 host arrays as float32 (the JAX package's
    # 32-bit default): a float64 model is given tensors
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    _close(net.output(x), jnet.output(x.numpy()), "output")
    # the port's dropout draws are the JAX step's (the seam)
    if hasattr(jnet.conf, "network_inputs"):
        seam.keys = graph_keys(jnet, 0)
        jnet.fit([x.numpy()], [y.numpy()])
    else:
        seam.keys = mln_keys(jnet, 0)
        jnet.fit(x.numpy(), y.numpy())
    net.fit(x, y)
    assert not seam.keys
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    upd = jnet.conf.global_conf.updater
    _params_close(net, jnet, upd.learning_rate
                  if type(upd).__name__ == "Adam" else None)
    _trees_close(net.state, jnet.state, "state")


def _bn_nets():
    jnet = jsimple.SimpleCNN(num_classes=CLASSES,
                             input_shape=(12, 12, 3)).init()
    return jnet, port_of(jnet)


def test_only_fit_commits_the_state():
    """output(train=True), score, compute_gradient_and_score,
    feed_forward(train=True) and evaluate write no state; a fit step
    writes the JAX step's, into the same tensors."""
    jnet, net = _bn_nets()
    x, y = _batch((12, 12, 3), seed=1, n=4)
    before = [{k: v.clone() for k, v in d.items()} for d in net.state]
    ptrs = [{k: v.data_ptr() for k, v in d.items()} for d in net.state]
    net.output(x, train=True)
    net.score(x=x, y=y)
    net.compute_gradient_and_score(x, y)
    net.feed_forward(x, train=True)
    net.evaluate(x, y)
    for b, d in zip(before, net.state):
        assert all(torch.equal(b[k], d[k]) for k in d)
    # the score runs batch statistics in both packages (train mode)
    np.testing.assert_allclose(net.score(x=x, y=y),
                               jnet.score(x=x, y=y), rtol=LOSS_RTOL)
    net.fit(x, y)
    jnet.fit(x, y)
    _trees_close(net.state, jnet.state, "state")
    assert [{k: v.data_ptr() for k, v in d.items()}
            for d in net.state] == ptrs
    assert any(not torch.equal(b["mean"], d["mean"])
               for b, d in zip(before, net.state) if d)


def _small_bn_graph():
    """A residual block as a graph: conv -> BatchNormalization -> add ->
    global pooling -> output."""
    from deeplearning4j_tpu.nn import layers as jl
    from deeplearning4j_tpu.nn.conf.configuration import \
        NeuralNetConfiguration as JaxNNC
    from deeplearning4j_tpu.nn.conf.graph_conf import ElementWiseVertex
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd
    g = (JaxNNC.builder().seed(2).updater(JaxSgd(0.1)).graph_builder()
         .add_inputs("in").set_input_types(JIT.convolutional(6, 6, 3)))
    g.add_layer("c", jl.ConvolutionLayer(n_out=3, kernel_size=3, padding=1,
                                         activation="identity"), "in")
    g.add_layer("bn", jl.BatchNormalization(activation="relu"), "c")
    g.add_vertex("add", ElementWiseVertex(op="add"), "bn", "in")
    g.add_layer("pool", jl.GlobalPoolingLayer(pooling_type="avg"), "add")
    g.add_layer("out", jl.OutputLayer(n_out=CLASSES, activation="softmax",
                                      loss="mcxent"), "pool")
    return JaxCG(g.set_outputs("out").build()).init()


def test_graph_commit_points_and_backprop_external():
    """output, score, compute_gradient_and_score and backprop_external
    write no state (backprop_external returns the JAX graph's new state);
    a fit step writes the JAX step's."""
    jnet = _small_bn_graph()
    net = port_of(jnet)
    x, y = _batch((6, 6, 3), seed=2, n=3)
    before = {n: {k: v.clone() for k, v in d.items()}
              for n, d in net.state.items()}
    net.output(x)
    net.score(inputs=[x], labels=[y])
    net.compute_gradient_and_score([x], [y])
    eps = np.random.RandomState(3).randn(3, CLASSES).astype(np.float32)
    grads, new_state = net.backprop_external([x], [eps])
    jgrads, jstate = jnet.backprop_external([x], [eps])
    for n, d in net.state.items():
        assert all(torch.equal(before[n][k], d[k]) for k in d)
    _trees_close(new_state, jstate, "backprop_external state")
    _trees_close(grads, jgrads, "backprop_external gradient")
    jnet.fit([x], [y])
    net.fit([x], [y])
    _trees_close(net.state, jnet.state, "state")
    assert not torch.equal(before["bn"]["mean"], net.state["bn"]["mean"])


def test_padded_rows_do_not_change_real_rows():
    """The bucketed engine pads 3 rows to 4 with zeros; BatchNormalization
    reads running statistics in inference, so the real rows equal the
    exact-shape forward."""
    _, net = _bn_nets()
    x, _ = _batch((12, 12, 3), seed=3, n=3)
    net.fit(*_batch((12, 12, 3), seed=4, n=4))      # non-trivial statistics
    got = net.output(x)
    assert net.serving_engine().stats()["pad_rows"] == 1
    torch.testing.assert_close(got, net.output(x, bucketed=False),
                               rtol=0, atol=0)


def test_clone_is_independent():
    _, net = _bn_nets()
    twin = net.clone()
    x, y = _batch((12, 12, 3), seed=5, n=4)
    torch.testing.assert_close(twin.output(x), net.output(x), rtol=0, atol=0)
    twin.fit(x, y)
    assert not torch.equal(twin.state[1]["mean"], net.state[1]["mean"])
    assert twin.state[1]["mean"].data_ptr() != net.state[1]["mean"].data_ptr()


def _manifest():
    return ZooModel.manifest()


def test_lenet_pretrained_reproduces_recorded_accuracy():
    entry = _manifest()["lenet"]
    net = LeNet(num_classes=10).init_pretrained(device="cpu")
    xte, yte = load_mnist(train=False, num_examples=entry["n_test"],
                          flatten=False)
    acc = float((net.output(xte).numpy().argmax(-1)
                 == yte.argmax(-1)).mean())
    assert abs(acc - entry["accuracy"]) < 0.02, (acc, entry["accuracy"])
    assert acc > 0.93


def test_simplecnn_pretrained_reproduces_recorded_accuracy():
    entry = _manifest()["simplecnn"]
    net = SimpleCNN(num_classes=entry["n_classes"]).init_pretrained(
        device="cpu")
    assert any(d for d in net.state)        # the zip's running statistics
    xte, yte = _synthetic_images(entry["n_test"], 48, 48, 3,
                                 entry["n_classes"], seed=entry["test_seed"])
    acc = float((net.output(xte).numpy().argmax(-1) == yte).mean())
    assert abs(acc - entry["accuracy"]) < 0.02, (acc, entry["accuracy"])
    assert acc > 0.9


@pytest.mark.slow
def test_resnet50_cifar_pretrained_reproduces_recorded_accuracy():
    entry = _manifest()["resnet50_cifar10"]
    net = ResNet50Cifar(num_classes=10).init_pretrained(device="cpu")
    assert isinstance(net, ComputationGraph)
    xte, yte = load_cifar10(train=False, num_examples=entry["n_test"])
    acc = float((net.output(xte).numpy().argmax(-1)
                 == yte.argmax(-1)).mean())
    assert abs(acc - entry["accuracy"]) < 0.02, (acc, entry["accuracy"])


def test_a_jax_zip_with_state_round_trips(tmp_path):
    """A zip the JAX package writes (its state in modelState.npz) restores
    in the port, and the port's zip restores in the JAX package."""
    from deeplearning4j_tpu.util import model_serializer as jser
    from deeplearning4j_tpu_torch.util import model_serializer as ser
    jnet, net = _bn_nets()
    x, y = _batch((12, 12, 3), seed=6, n=4)
    jnet.fit(x, y)
    jser.write_model(jnet, tmp_path / "j.zip")
    got = ser.guess_model(tmp_path / "j.zip", device="cpu")
    _trees_close(got.state, jnet.state, "state")
    _trees_close(got.params, jnet.params, "param")
    got.fit(x, y)
    ser.write_model(got, tmp_path / "p.zip")
    back = jser.restore_multi_layer_network(str(tmp_path / "p.zip"))
    _trees_close(got.state, back.state, "state back")
    meta = json.loads(__import__("zipfile").ZipFile(
        tmp_path / "p.zip").read("meta.json"))
    assert meta["kind"] == "MultiLayerNetwork"


@pytest.mark.parametrize("mode,runs", [(True, 2), ("save_convs", 1),
                                       ("selective", 1)])
def test_remat_save_convs_keeps_the_convolutions(mode, runs):
    """``remat='save_convs'`` / ``'selective'`` keep each convolution's
    output (the JAX package's ``conv_out`` tag) and recompute the rest:
    a fit step runs each forward convolution once, full remat twice; the
    gradient equals the one without remat bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                self.n += 1
            return func(*args, **(kwargs or {}))
    jnet = jsimple.LeNet(num_classes=CLASSES,
                         input_shape=(16, 16, 1)).init()
    plain, remat = port_of(jnet), port_of(jnet)
    remat.conf.global_conf.remat = mode
    x, y = _batch((16, 16, 1), n=3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    want = plain._gradients(xt, yt)[1]
    count = Count()
    with count:
        got = remat._gradients(xt, yt)[1]
    assert count.n == 2 * runs          # LeNet's two convolutions
    for a, b in zip(got, want):
        for k in a:
            assert torch.equal(a[k], b[k]), k
