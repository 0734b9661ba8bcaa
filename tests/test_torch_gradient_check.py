"""The port's numeric gradient checker on the layer configurations of the
JAX package's tests/test_gradients.py.

The JAX checker cannot run on this machine (its float64 scope fails
before it checks anything), so these cases have no JAX oracle: each
holds the port's autograd -- on the CPU, through every layer's plain
version -- against central finite differences in float64, at the JAX
suite's sizes, seeds and bars (max relative error 1e-3 where the absolute
error passes the checker's floor). One case hands the checker a
deliberately wrong gradient, which it must catch.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import MultiLayerNetwork, NeuralNetConfiguration
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.util.gradient_check import (
    gradient_check_fn, gradient_check_network)


def _builder(act="tanh"):
    return (NeuralNetConfiguration.builder().seed(12).updater(Sgd(0.1))
            .activation(act).weight_init("xavier"))


def _net(conf, seed=7, device="cpu"):
    return MultiLayerNetwork(conf, device=device).init(seed)


def _ydist(rng, kind, shape):
    n, c = shape
    if kind == "real":
        return rng.randn(n, c)
    if kind == "binary":
        return rng.randint(0, 2, (n, c)).astype(float)
    if kind == "onehot":
        return np.eye(c)[rng.randint(0, c, n)]
    if kind == "pm1":
        return rng.choice([-1.0, 1.0], (n, c))
    if kind == "count":
        return rng.randint(0, 5, (n, c)).astype(float)
    return rng.dirichlet(np.ones(c), n)


def case_dense_mlp():
    rng = np.random.RandomState(0)
    x, y = rng.randn(5, 4), np.eye(3)[rng.randint(0, 3, 5)]
    return (_builder().list()
            .layer(L.DenseLayer(n_out=6))
            .layer(L.DenseLayer(n_out=5, activation="sigmoid"))
            .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build()), x, y


def case_dense_l1_l2():
    rng = np.random.RandomState(1)
    x, y = rng.randn(4, 4), np.eye(3)[rng.randint(0, 3, 4)]
    return (_builder().l1(0.01).l2(0.02).list()
            .layer(L.DenseLayer(n_out=6))
            .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build()), x, y


LOSSES = [("mse", "identity", "real"), ("l1", "identity", "real"),
          ("xent", "sigmoid", "binary"), ("mcxent", "softmax", "onehot"),
          ("hinge", "identity", "pm1"), ("poisson", "softplus", "count"),
          ("kl_divergence", "softmax", "simplex")]


def case_loss(loss, out_act, ydist):
    def make():
        rng = np.random.RandomState(3)
        x = rng.randn(4, 3)
        y = _ydist(rng, ydist, (4, 2))
        return (_builder().list()
                .layer(L.DenseLayer(n_out=5))
                .layer(L.OutputLayer(n_out=2, activation=out_act, loss=loss))
                .set_input_type(InputType.feed_forward(3)).build()), x, y
    return make


def case_cnn():
    rng = np.random.RandomState(4)
    x, y = rng.randn(3, 8, 8, 2), np.eye(3)[rng.randint(0, 3, 3)]
    return (_builder("relu").list()
            .layer(L.ConvolutionLayer(n_out=3, kernel_size=3,
                                      activation="tanh"))
            .layer(L.SubsamplingLayer(pooling_type="avg", kernel_size=2,
                                      stride=2))
            .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 2)).build()), x, y


def case_batchnorm():
    rng = np.random.RandomState(5)
    x, y = rng.randn(6, 4), np.eye(2)[rng.randint(0, 2, 6)]
    return (_builder().list()
            .layer(L.DenseLayer(n_out=5))
            .layer(L.BatchNormalization())
            .layer(L.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build()), x, y


def _rnn(layer, n, t, f, c, seed):
    rng = np.random.RandomState(seed)
    x, y = rng.randn(n, t, f), np.eye(c)[rng.randint(0, c, (n, t))]
    return (_builder().list()
            .layer(layer)
            .layer(L.RnnOutputLayer(n_out=c, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(InputType.recurrent(f)).build()), x, y


def case_lstm():
    return _rnn(L.LSTM(n_out=6), 3, 5, 4, 2, 6)


def case_graves_lstm():
    return _rnn(L.GravesLSTM(n_out=5), 2, 4, 3, 2, 7)


def case_bidirectional():
    return _rnn(L.Bidirectional(fwd=L.LSTM(n_out=4), mode="concat"),
                2, 4, 3, 2, 8)


def case_stacked_lstm_pair():
    """The TextGenerationLSTM shape: two LSTMs that run as one pair."""
    rng = np.random.RandomState(14)
    x, y = rng.randn(2, 4, 5), np.eye(5)[rng.randint(0, 5, (2, 4))]
    return (_builder().list()
            .layer(L.LSTM(n_out=4)).layer(L.LSTM(n_out=4))
            .layer(L.RnnOutputLayer(n_out=5, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(InputType.recurrent(5)).build()), x, y


def case_simple_rnn_global_pooling():
    rng = np.random.RandomState(9)
    x, y = rng.randn(3, 5, 4), np.eye(3)[rng.randint(0, 3, 3)]
    return (_builder().list()
            .layer(L.SimpleRnn(n_out=5))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(4)).build()), x, y


def case_embedding():
    rng = np.random.RandomState(13)
    x = rng.randint(0, 7, (6, 1)).astype(np.float64)
    y = np.eye(3)[rng.randint(0, 3, 6)]
    return (_builder().list()
            .layer(L.EmbeddingLayer(n_in=7, n_out=4))
            .layer(L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(7)).build()), x, y


NETWORK_CASES = {
    "dense_mlp": case_dense_mlp, "dense_l1_l2": case_dense_l1_l2,
    **{f"loss_{l}": case_loss(l, a, d) for l, a, d in LOSSES},
    "cnn": case_cnn, "batchnorm": case_batchnorm, "lstm": case_lstm,
    "graves_lstm": case_graves_lstm, "bidirectional": case_bidirectional,
    "stacked_lstm_pair": case_stacked_lstm_pair,
    "simple_rnn_global_pooling": case_simple_rnn_global_pooling,
    "embedding": case_embedding,
}


def _masked_loss():
    """RNN loss with a labels and features mask (GradientCheckTestsMasking)."""
    rng = np.random.RandomState(10)
    x, y = rng.randn(3, 5, 4), np.eye(2)[rng.randint(0, 2, (3, 5))]
    mask = np.ones((3, 5))
    mask[0, 3:] = 0
    mask[2, 1:] = 0
    net = _net(_builder().list()
               .layer(L.LSTM(n_out=4))
               .layer(L.RnnOutputLayer(n_out=2, activation="softmax",
                                       loss="mcxent"))
               .set_input_type(InputType.recurrent(4)).build(), seed=3)
    x, y, m = (torch.as_tensor(a) for a in (x, y, mask))

    def loss_fn(params):
        return net._loss(params, x, y, m, None, m)[0]
    return loss_fn, net.params, 10


def _pretrain_loss(kind):
    def make():
        if kind == "vae":
            rng = np.random.RandomState(11)
            x = (rng.rand(4, 6) > 0.5).astype(float)
            layer = L.VariationalAutoencoder(
                n_in=6, n_out=3, encoder_layer_sizes=(8,),
                decoder_layer_sizes=(8,), activation="tanh",
                weight_init="xavier")
            seed, checks = 0, 8
        else:
            rng = np.random.RandomState(12)
            x = rng.rand(4, 5)
            layer = L.AutoEncoder(n_in=5, n_out=3, activation="sigmoid",
                                  weight_init="xavier", corruption_level=0.0)
            seed, checks = 1, 10
        params = layer.init(torch.Generator().manual_seed(seed),
                            torch.float64)
        xt = torch.as_tensor(x)

        def loss_fn(p):
            return layer.compute_score(p, xt, train=False, gen=None)
        return loss_fn, params, checks
    return make


def _f32_params(kind):
    """A float32 network's parameters handed to the checker, which copies
    them to float64 itself (the JAX suite's f32 case; in the port the
    inputs are float64, since torch does not promote a float32 input
    against float64 weights)."""
    def make():
        rng = np.random.RandomState(4)
        x = torch.as_tensor(rng.randn(2, 5, 3))
        y = torch.as_tensor(np.eye(2)[rng.randint(0, 2, (2, 5))])
        layer = L.SimpleRnn(n_out=5) if kind == "simple_rnn" \
            else L.LSTM(n_out=5)
        net = _net(_builder().list().layer(layer)
                   .layer(L.RnnOutputLayer(n_out=2, activation="softmax",
                                           loss="mcxent"))
                   .set_input_type(InputType.recurrent(3)).build())
        assert net.params[0]["W"].dtype == torch.float32

        def loss_fn(params):
            return net._loss(params, x, y)[0]
        return loss_fn, net.params, 6
    return make


FN_CASES = {"masking": _masked_loss, "vae": _pretrain_loss("vae"),
            "autoencoder": _pretrain_loss("autoencoder"),
            "f32_params_simple_rnn": _f32_params("simple_rnn"),
            "f32_params_lstm": _f32_params("lstm")}


@pytest.mark.parametrize("case", sorted(NETWORK_CASES) + sorted(FN_CASES))
def test_gradient_check(case):
    if case in NETWORK_CASES:
        conf, x, y = NETWORK_CASES[case]()
        fails, checked, worst = gradient_check_network(
            _net(conf), np.asarray(x), np.asarray(y),
            max_checks_per_array=12, max_rel_error=1e-3)
    else:
        loss_fn, params, checks = FN_CASES[case]()
        fails, checked, worst = gradient_check_fn(
            loss_fn, params, max_checks_per_array=checks)
    assert checked > 0
    assert fails == 0, \
        f"{fails}/{checked} gradient checks failed (worst rel {worst:.2e})"


def test_gradient_check_catches_a_wrong_gradient():
    """A loss whose autograd gradient is deliberately wrong (the backward
    of x**3 written as 2x) fails the check; the right one, from float32
    parameters the checker copies to float64, passes."""
    class WrongCube(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x ** 3

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            return g * 2 * x

    params = {"w": torch.linspace(0.5, 1.5, 6, dtype=torch.float32)}
    fails, checked, worst = gradient_check_fn(
        lambda p: WrongCube.apply(p["w"]).sum(), params)
    assert checked == 6 and fails == 6 and worst > 0.1
    fails, _, _ = gradient_check_fn(lambda p: (p["w"] ** 3).sum(), params)
    assert fails == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense_mlp", "stacked_lstm_pair"])
def test_gradient_check_runs_on_the_networks_card(case):
    """A network on the card is checked on the card, in float64: as many
    elements checked as on the CPU and none failing. No kernel takes
    float64, so nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the network under check lives "
                    "on it")
    conf, x, y = NETWORK_CASES[case]()
    got = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launch_counts()
        got[dev] = gradient_check_network(
            _net(conf, device=dev), np.asarray(x), np.asarray(y),
            max_checks_per_array=12, max_rel_error=1e-3)
        assert sum(ops.launch_counts().values()) == 0
    (f_cpu, n_cpu, _), (f_gpu, n_gpu, worst) = got["cpu"], got["cuda"]
    assert f_gpu == f_cpu == 0 and n_gpu == n_cpu > 0, worst
