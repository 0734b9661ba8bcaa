"""The port's network, configuration, layers and checkpoint format held
against the JAX package, on the CPU.

Weights cross between the packages as numpy arrays (``params_from_numpy``)
or through the shared checkpoint zip; inputs come from numpy seeds.
Tolerance 1e-5 at small width (float32, same math in another summation
order); 1e-4 on the bundled 2 x LSTM(256) model, whose 64-step recurrence
compounds the rounding differences.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.activations import ACTIVATIONS as JAX_ACTIVATIONS
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.updaters import Adam
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu.zoo.simple import TextGenerationLSTM as JaxTextGen

from deeplearning4j_tpu_torch import MultiLayerNetwork, params_from_numpy
from deeplearning4j_tpu_torch.nn.activations import ACTIVATIONS
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

V, H = 6, 8


def _jax_net(seed=3):
    conf = (JaxNNC.builder().seed(seed).updater(Adam(1e-3))
            .weight_init("xavier").list()
            .layer(JaxLSTM(n_out=H, activation="tanh"))
            .layer(JaxLSTM(n_out=H, activation="tanh"))
            .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V)).build())
    return JaxMLN(conf).init()


def _port_of(jnet):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    return net.set_params(params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params],
        device="cpu"))


def _x(B=3, T=7, seed=0):
    r = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[r.randint(0, V, (B, T))]


@pytest.fixture(scope="module")
def pair():
    jnet = _jax_net()
    return jnet, _port_of(jnet)


def test_output_matches_jax(pair):
    jnet, net = pair
    x = _x()
    want = np.asarray(jnet.output(x, bucketed=False))
    np.testing.assert_allclose(net.output(x, bucketed=False).numpy(), want,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(net.output(x).numpy(), want, atol=1e-5,
                               rtol=0)


def test_rnn_time_step_in_chunks_matches_jax(pair):
    jnet, net = pair
    x = _x(B=2, T=9, seed=1)
    jnet.rnn_clear_previous_state()
    net.rnn_clear_previous_state()
    for lo, hi in ((0, 4), (4, 5), (5, 9)):
        want = np.asarray(jnet.rnn_time_step(x[:, lo:hi]))
        got = net.rnn_time_step(x[:, lo:hi]).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the stored state is what chunks continue from: the whole-sequence
    # output agrees with the last chunk
    np.testing.assert_allclose(got, net.output(x).numpy()[:, 5:9],
                               atol=1e-5, rtol=0)
    net.rnn_clear_previous_state()
    np.testing.assert_allclose(net.rnn_time_step(x[:, 0]).numpy()[:, 0],
                               net.output(x[:, :1]).numpy()[:, 0],
                               atol=1e-6, rtol=0)


def test_decode_step_matches_jax(pair):
    jnet, net = pair
    x = _x(B=2, T=5, seed=2)
    jd = jnet.init_decode_state(2, 8)
    pd = net.init_decode_state(2)
    for t in range(5):
        jy, jd = jnet.decode_step(jnet.params, jnet.state, jd,
                                  jnp.asarray(x[:, t:t + 1]),
                                  jnp.full((2,), t, jnp.int32))
        py, pd = net.decode_step(net.params, pd, torch.tensor(x[:, t:t + 1]))
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose(py.numpy()[:, 0], net.output(x).numpy()[:, -1],
                               atol=1e-5, rtol=0)


def test_configuration_json_is_the_same_document():
    """The port builds the zoo model's configuration to the JAX package's
    JSON, and reads that JSON back to the same document."""
    jconf = JaxTextGen(total_unique_characters=51).conf()
    pconf = TextGenerationLSTM(total_unique_characters=51).conf()
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    again = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(again.to_json()) == json.loads(jconf.to_json())


@pytest.fixture(scope="module")
def textgen():
    mf = TextGenerationLSTM.manifest()["textgenlstm"]
    _, (xte, yte), vocab = corpus_windows(T=mf["seq_len"])
    jnet = JaxTextGen(total_unique_characters=len(vocab)).init_pretrained()
    net = TextGenerationLSTM(
        total_unique_characters=len(vocab)).init_pretrained(device="cpu")
    return mf, xte, yte, np.asarray(jnet.output(xte)), net


def test_bundled_textgenlstm_matches_jax(textgen):
    mf, xte, yte, want, net = textgen
    got = net.output(xte).numpy()
    assert got.shape == want.shape == (15, 64, 51)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.995
    acc = (got.argmax(-1) == yte.argmax(-1)).mean()
    jacc = (want.argmax(-1) == yte.argmax(-1)).mean()
    assert abs(acc - jacc) <= 0.005
    assert abs(acc - mf["accuracy"]) < 0.02


def test_checkpoint_written_by_the_port_loads_in_both(textgen, tmp_path):
    _, xte, _, want, net = textgen
    path = tmp_path / "textgen.zip"
    net.save(path)
    again = MultiLayerNetwork.load(path, device="cpu")
    for p, q in zip(net.params, again.params):
        assert p.keys() == q.keys()
        assert all(torch.equal(p[k], q[k]) for k in p)
    jnet = jax_serializer.restore_multi_layer_network(str(path))
    np.testing.assert_allclose(np.asarray(jnet.output(xte[:2])), want[:2],
                               atol=1e-6, rtol=0)


def test_checkpoint_missing_an_array_names_it(tmp_path):
    import io
    import zipfile
    from deeplearning4j_tpu_torch.zoo.zoo_model import BUNDLED_DIR
    bad = tmp_path / "bad.zip"
    with zipfile.ZipFile(BUNDLED_DIR / "textgenlstm.zip") as zin, \
            zipfile.ZipFile(bad, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "coefficients.npz":
                arrs = dict(np.load(io.BytesIO(data)))
                del arrs["1/RW"]
                buf = io.BytesIO()
                np.savez(buf, **arrs)
                data = buf.getvalue()
            zout.writestr(item, data)
    with pytest.raises(ValueError, match="1/RW"):
        MultiLayerNetwork.load(bad, device="cpu")


def test_init_is_a_function_of_the_seed():
    conf = TextGenerationLSTM(total_unique_characters=11).conf()
    a = MultiLayerNetwork(conf, device="cpu").init(seed=5)
    b = MultiLayerNetwork(conf, device="cpu").init(seed=5)
    c = MultiLayerNetwork(conf, device="cpu").init(seed=6)
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a.params, b.params)
               for k in p)
    assert not torch.equal(a.params[0]["W"], c.params[0]["W"])
    assert torch.all(a.params[0]["b"][256:512] == 1.0)   # forget-gate bias


def test_activations_match_jax():
    assert sorted(ACTIVATIONS) == sorted(JAX_ACTIVATIONS)
    x = np.random.RandomState(0).randn(4, 7).astype(np.float32) * 3
    for name, fn in ACTIVATIONS.items():
        got = fn(torch.tensor(x)).numpy()
        want = np.asarray(JAX_ACTIVATIONS[name](jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("scheme", [
    "zero", "ones", "identity", "normal", "lecun_normal", "lecun_uniform",
    "uniform", "xavier", "xavier_uniform", "xavier_fan_in", "xavier_legacy",
    "relu", "relu_uniform", "sigmoid_uniform", "var_scaling_normal_fan_in",
    "var_scaling_normal_fan_out", "var_scaling_normal_fan_avg",
    "var_scaling_uniform_fan_in", "var_scaling_uniform_fan_out",
    "var_scaling_uniform_fan_avg", "distribution"])
def test_weight_schemes_match_jax_in_distribution(scheme):
    """Same scheme, same spread as the JAX package's (the generators differ,
    so the numbers themselves do not)."""
    from deeplearning4j_tpu.nn.weights import init_weights as jax_init
    shape = (300, 300)
    dist = ("normal", 0.5, 2.0)
    got = init_weights(torch.Generator().manual_seed(0), shape, scheme,
                       dist).numpy()
    want = np.asarray(jax_init(jax.random.PRNGKey(0), shape, scheme, dist))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.mean(), want.mean(), atol=0.02)
    np.testing.assert_allclose(got.std(), want.std(), rtol=0.02, atol=1e-6)
    np.testing.assert_allclose(np.abs(got).max(), np.abs(want).max(),
                               rtol=0.25, atol=1e-6)
