"""The port's Keras HDF5 import held against the JAX package on the CPU.

Every model of the JAX suite (tests/test_keras_import.py), written into
``tmp_path`` with that suite's own h5py writer, and both committed Keras 3
goldens, are imported by both packages: the port's parameters and layer
state are bitwise the JAX package's (which are the file's arrays after the
layout rules), and ``output`` agrees within rtol 1e-5, atol 1e-6 (the
goldens within atol 1e-5 of Keras's own predictions, the JAX suite's
bar). More models cover the other weight rules: the Keras 1 per-gate LSTM
layout, the Theano kernel flip with the channels-first flatten permute,
and the 2-D layer translators.

An imported network trains from the imported weights: its parameters are
the views ``init()`` made into the fused update's flat buffers, so a
``fit`` step moves them as it moves the JAX package's (rtol 1e-4, atol
1e-5 after one Adam step; Adam's first step is about lr times the sign of
the gradient, which amplifies float32 noise where a gradient is near 0).

Launch routes (spies on the LSTM wrappers, whose plain versions run here):
two stacked sigmoid LSTMs are one K4 an inference call and one K4-train
plus two K3 a ``fit`` step; an LSTM that ``return_sequences=False`` turns
into ``LastTimeStep`` breaks the pair (two K1), as does a ``Dropout``
between them; ``hard_sigmoid`` gates launch nothing (the layer's own
loop).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from test_keras_import import _seq_cfg, _write_keras_h5  # noqa: E402
from test_torch_regularised_training import flat, port_flat  # noqa: E402

import deeplearning4j_tpu.modelimport as J  # noqa: E402
import deeplearning4j_tpu_torch.modelimport as P  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import keras_import as pk  # noqa
from deeplearning4j_tpu_torch.nn import layers as pl  # noqa: E402
from deeplearning4j_tpu_torch.ops import lstm_cuda  # noqa: E402

OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
_GOLD = os.path.join(os.path.dirname(__file__), "resources", "keras_golden")
ADAM = {"class_name": "Adam", "config": {"learning_rate": 0.01}}


def _rng(seed):
    return np.random.default_rng(seed)


def _f4(rng, *shape, scale=1.0):
    return rng.normal(size=shape, scale=scale).astype("f4")


def _lstm(name, units, rs=True, rec="sigmoid", **extra):
    cfg = {"name": name, "units": units, "activation": "tanh",
           "recurrent_activation": rec, "use_bias": True,
           "return_sequences": rs}
    cfg.update(extra)
    return {"class_name": "LSTM", "config": cfg}


def _lstm_weights(rng, name, n_in, H):
    return [(f"{name}/kernel:0", _f4(rng, n_in, 4 * H, scale=0.3)),
            (f"{name}/recurrent_kernel:0", _f4(rng, H, 4 * H, scale=0.3)),
            (f"{name}/bias:0", _f4(rng, 4 * H, scale=0.1))]


def _dense(name, units, act="linear", bias=True, **extra):
    cfg = {"name": name, "units": units, "activation": act,
           "use_bias": bias}
    cfg.update(extra)
    return {"class_name": "Dense", "config": cfg}


# ------------------------------------------------------------------ models
# each: rng -> (model config, {layer: [(weight name, array)]}, training
# config or None, input batch)

def m_mlp(rng):
    cfg = _seq_cfg([_dense("d1", 8, "relu", batch_input_shape=[None, 4]),
                    _dense("d2", 3, "softmax")])
    w = {"d1": [("d1/kernel:0", _f4(rng, 4, 8)), ("d1/bias:0", _f4(rng, 8))],
         "d2": [("d2/kernel:0", _f4(rng, 8, 3)), ("d2/bias:0", _f4(rng, 3))]}
    return cfg, w, {"loss": "categorical_crossentropy",
                    "optimizer_config": {}}, _f4(rng, 5, 4)


def m_convnet(rng):
    cfg = _seq_cfg([
        {"class_name": "Conv2D", "config": {
            "name": "c1", "filters": 4, "kernel_size": [3, 3],
            "strides": [1, 1], "padding": "same", "activation": "relu",
            "use_bias": True, "data_format": "channels_last",
            "batch_input_shape": [None, 8, 8, 2]}},
        {"class_name": "MaxPooling2D", "config": {
            "name": "p1", "pool_size": [2, 2], "strides": [2, 2],
            "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "fl"}},
        _dense("d1", 5)])
    w = {"c1": [("c1/kernel:0", _f4(rng, 3, 3, 2, 4, scale=0.5)),
                ("c1/bias:0", _f4(rng, 4))],
         "d1": [("d1/kernel:0", _f4(rng, 64, 5, scale=0.2)),
                ("d1/bias:0", _f4(rng, 5))]}
    return cfg, w, None, _f4(rng, 3, 8, 8, 2)


def m_lstm_seq(rng):
    cfg = _seq_cfg([_lstm("l1", 4, batch_input_shape=[None, 6, 3])])
    return cfg, {"l1": _lstm_weights(rng, "l1", 3, 4)}, None, \
        _f4(rng, 2, 6, 3)


def m_lstm_last(rng):
    cfg = _seq_cfg([_lstm("l1", 4, rs=False, batch_input_shape=[None, 5, 3]),
                    _dense("d1", 2, bias=False)])
    w = {"l1": _lstm_weights(rng, "l1", 3, 4),
         "d1": [("d1/kernel:0", _f4(rng, 4, 2, scale=0.5))]}
    return cfg, w, None, _f4(rng, 2, 5, 3)


def m_keras1_lstm(rng):
    """Keras 1: per-gate W_i, U_i, b_i in [i, c, f, o] order."""
    cfg = _seq_cfg([{"class_name": "LSTM", "config": {
        "name": "l1", "output_dim": 4, "activation": "tanh",
        "inner_activation": "sigmoid", "return_sequences": True,
        "batch_input_shape": [None, 5, 3]}}])
    w = []
    for g in "icfo":
        w += [(f"l1_W_{g}", _f4(rng, 3, 4, scale=0.3)),
              (f"l1_U_{g}", _f4(rng, 4, 4, scale=0.3)),
              (f"l1_b_{g}", _f4(rng, 4, scale=0.1))]
    return cfg, {"l1": w}, None, _f4(rng, 2, 5, 3)


def m_hard_sigmoid_lstm(rng):
    cfg = _seq_cfg([_lstm("l1", 4, rec="hard_sigmoid",
                          batch_input_shape=[None, 5, 3]),
                    _lstm("l2", 4, rec="hard_sigmoid", rs=False),
                    _dense("d1", 2)])
    w = {"l1": _lstm_weights(rng, "l1", 3, 4),
         "l2": _lstm_weights(rng, "l2", 4, 4),
         "d1": [("d1/kernel:0", _f4(rng, 4, 2)), ("d1/bias:0", _f4(rng, 2))]}
    return cfg, w, None, _f4(rng, 2, 5, 3)


def m_batchnorm(rng):
    cfg = _seq_cfg([
        _dense("d1", 2, bias=False, batch_input_shape=[None, 2]),
        {"class_name": "BatchNormalization", "config": {
            "name": "bn", "epsilon": 1e-3, "momentum": 0.99}}])
    w = {"d1": [("d1/kernel:0", np.eye(2, dtype="f4"))],
         "bn": [("bn/gamma:0", np.array([1.5, 0.5], "f4")),
                ("bn/beta:0", np.array([0.1, -0.2], "f4")),
                ("bn/moving_mean:0", np.array([0.3, -0.4], "f4")),
                ("bn/moving_variance:0", np.array([2.0, 0.5], "f4"))]}
    return cfg, w, None, np.array([[1.0, 1.0], [0.0, 2.0]], "f4")


def m_conv1d_pipeline(rng):
    cfg = _seq_cfg([
        {"class_name": "Conv1D", "config": {
            "name": "c1", "filters": 6, "kernel_size": [3], "strides": [1],
            "padding": "same", "activation": "relu", "use_bias": True,
            "batch_input_shape": [None, 8, 4]}},
        {"class_name": "ZeroPadding1D", "config": {"name": "zp",
                                                   "padding": [1, 1]}},
        {"class_name": "MaxPooling1D", "config": {
            "name": "p1", "pool_size": [2], "strides": [2],
            "padding": "valid"}},
        {"class_name": "UpSampling1D", "config": {"name": "u1", "size": 2}},
        {"class_name": "Flatten", "config": {"name": "f"}},
        _dense("d", 3, "softmax")])
    w = {"c1": [("c1/kernel:0", _f4(rng, 3, 4, 6)),
                ("c1/bias:0", _f4(rng, 6))],
         "d": [("d/kernel:0", _f4(rng, 60, 3)), ("d/bias:0", _f4(rng, 3))]}
    return cfg, w, None, _f4(rng, 2, 8, 4)


def m_atrous_lrn(rng):
    cfg = _seq_cfg([
        {"class_name": "AtrousConvolution2D", "config": {
            "name": "ac", "nb_filter": 4, "nb_row": 3, "nb_col": 3,
            "atrous_rate": [2, 2], "border_mode": "same",
            "activation": "relu", "bias": True,
            "batch_input_shape": [None, 8, 8, 2]}},
        {"class_name": "LRN2D", "config": {
            "name": "lrn", "alpha": 1e-4, "beta": 0.75, "k": 2, "n": 5}},
        {"class_name": "Flatten", "config": {"name": "f"}},
        _dense("d", 2, "softmax")])
    w = {"ac": [("ac/kernel:0", _f4(rng, 3, 3, 2, 4)),
                ("ac/bias:0", _f4(rng, 4))],
         "d": [("d/kernel:0", _f4(rng, 256, 2)), ("d/bias:0", _f4(rng, 2))]}
    return cfg, w, None, _f4(rng, 2, 8, 8, 2)


def m_theano_conv_flatten(rng):
    """Keras 1 on Theano, channels first: (out, in, kh, kw) kernels with
    flipped taps, and the Dense rows after the Flatten in (c, h, w)."""
    cfg = {"class_name": "Sequential", "keras_version": "1.2.2",
           "backend": "theano", "config": [
               {"class_name": "Convolution2D", "config": {
                   "name": "c1", "nb_filter": 3, "nb_row": 3, "nb_col": 3,
                   "border_mode": "valid", "activation": "relu",
                   "bias": True, "dim_ordering": "th",
                   "batch_input_shape": [None, 2, 6, 6]}},
               {"class_name": "Flatten", "config": {"name": "f"}},
               {"class_name": "Dense", "config": {
                   "name": "d", "output_dim": 4, "activation": "linear",
                   "bias": True}}]}
    w = {"c1": [("c1_W", _f4(rng, 3, 2, 3, 3)), ("c1_b", _f4(rng, 3))],
         "d": [("d_W", _f4(rng, 48, 4, scale=0.3)), ("d_b", _f4(rng, 4))]}
    return cfg, w, None, _f4(rng, 2, 6, 6, 2)


def m_layers_2d(rng):
    """The 2-D translators: ZeroPadding2D, DepthwiseConv2D (one input
    channel: ``test_depthwise_kernels``), Cropping2D, UpSampling2D,
    AveragePooling2D, LeakyReLU, Activation, Dropout,
    GlobalAveragePooling2D."""
    cfg = _seq_cfg([
        {"class_name": "ZeroPadding2D", "config": {
            "name": "zp", "padding": [[1, 1], [1, 1]],
            "batch_input_shape": [None, 6, 6, 1]}},
        {"class_name": "DepthwiseConv2D", "config": {
            "name": "dc", "kernel_size": [3, 3], "padding": "valid",
            "depth_multiplier": 2, "activation": "relu",
            "use_bias": True}},
        {"class_name": "Cropping2D", "config": {"name": "cr",
                                                "cropping": [[1, 0], [0, 1]]}},
        {"class_name": "UpSampling2D", "config": {"name": "up",
                                                  "size": [2, 2]}},
        {"class_name": "AveragePooling2D", "config": {
            "name": "ap", "pool_size": [2, 2], "padding": "same"}},
        {"class_name": "LeakyReLU", "config": {"name": "lr"}},
        {"class_name": "Activation", "config": {"name": "act",
                                                "activation": "tanh"}},
        {"class_name": "Dropout", "config": {"name": "do", "rate": 0.3}},
        {"class_name": "GlobalAveragePooling2D", "config": {"name": "gap"}},
        _dense("d", 3, "softmax")])
    w = {"dc": [("dc/depthwise_kernel:0", _f4(rng, 3, 3, 1, 2)),
                ("dc/bias:0", _f4(rng, 2))],
         "d": [("d/kernel:0", _f4(rng, 2, 3)), ("d/bias:0", _f4(rng, 3))]}
    return cfg, w, None, _f4(rng, 2, 6, 6, 1)


def m_simple_rnn(rng):
    cfg = _seq_cfg([
        {"class_name": "SimpleRNN", "config": {
            "name": "r", "units": 5, "activation": "tanh",
            "return_sequences": False, "batch_input_shape": [None, 4, 3]}},
        _dense("d", 2)])
    w = {"r": [("r/kernel:0", _f4(rng, 3, 5, scale=0.4)),
               ("r/recurrent_kernel:0", _f4(rng, 5, 5, scale=0.4)),
               ("r/bias:0", _f4(rng, 5, scale=0.1))],
         "d": [("d/kernel:0", _f4(rng, 5, 2)), ("d/bias:0", _f4(rng, 2))]}
    return cfg, w, None, _f4(rng, 2, 4, 3)


def m_functional_add(rng):
    cfg = {"class_name": "Model", "keras_version": "2.2.4",
           "backend": "tensorflow", "config": {
               "name": "m",
               "layers": [
                   {"class_name": "InputLayer", "name": "in",
                    "config": {"name": "in", "batch_input_shape": [None, 4]},
                    "inbound_nodes": []},
                   {"class_name": "Dense", "name": "a",
                    "config": {"name": "a", "units": 4, "activation": "relu",
                               "use_bias": False},
                    "inbound_nodes": [[["in", 0, 0, {}]]]},
                   {"class_name": "Dense", "name": "b",
                    "config": {"name": "b", "units": 4, "activation": "relu",
                               "use_bias": False},
                    "inbound_nodes": [[["in", 0, 0, {}]]]},
                   {"class_name": "Add", "name": "add",
                    "config": {"name": "add"},
                    "inbound_nodes": [[["a", 0, 0, {}], ["b", 0, 0, {}]]]},
                   {"class_name": "Concatenate", "name": "cat",
                    "config": {"name": "cat"},
                    "inbound_nodes": [[["add", 0, 0, {}], ["a", 0, 0, {}]]]},
                   {"class_name": "Dense", "name": "out",
                    "config": {"name": "out", "units": 2,
                               "activation": "softmax", "use_bias": True},
                    "inbound_nodes": [[["cat", 0, 0, {}]]]}],
               "input_layers": [["in", 0, 0]],
               "output_layers": [["out", 0, 0]]}}
    w = {"a": [("a/kernel:0", _f4(rng, 4, 4))],
         "b": [("b/kernel:0", _f4(rng, 4, 4))],
         "out": [("out/kernel:0", _f4(rng, 8, 2)),
                 ("out/bias:0", _f4(rng, 2))]}
    return cfg, w, {"loss": {"out": "categorical_crossentropy"},
                    "optimizer_config": ADAM}, _f4(rng, 3, 4)


MODELS = [m_mlp, m_convnet, m_lstm_seq, m_lstm_last, m_keras1_lstm,
          m_hard_sigmoid_lstm, m_batchnorm, m_conv1d_pipeline, m_atrous_lrn,
          m_theano_conv_flatten, m_layers_2d, m_simple_rnn, m_functional_add]


def _state_flat(net):
    items = net.state.items() if isinstance(net.state, dict) \
        else enumerate(net.state)
    return {f"{i}/{k}": v for i, s in items for k, v in s.items()}


def _layer_types(net):
    layers = getattr(net, "layers", None)
    if layers is None:
        layers = [net.conf.nodes[n].layer for n in net.conf.topo_sort()
                  if net.conf.nodes[n].kind == "layer"]
    return [type(l).__name__ for l in layers]


def _import_both(path):
    return (J.KerasModelImport.import_keras_model(path),
            P.KerasModelImport.import_keras_model(path, device="cpu"))


def _out(net, x):
    y = net.output(x)
    return (y[0] if isinstance(y, (list, tuple)) else y)


@pytest.mark.parametrize("model", MODELS, ids=lambda m: m.__name__[2:])
def test_import_matches_jax(tmp_path, model):
    cfg, weights, train, x = model(_rng(MODELS.index(model)))
    path = str(tmp_path / "m.h5")
    _write_keras_h5(path, cfg, weights, training_cfg=train)
    jnet, pnet = _import_both(path)
    assert _layer_types(jnet) == _layer_types(pnet)
    want, got = flat(jnet.params), port_flat(pnet)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jstate = flat(jnet.state)
    for k, v in _state_flat(pnet).items():
        np.testing.assert_array_equal(v.numpy(), jstate[k], err_msg=k)
    np.testing.assert_allclose(_out(pnet, x).numpy(),
                               np.asarray(_out(jnet, x)), OUT_RTOL, OUT_ATOL)


def test_parameters_are_the_files_arrays(tmp_path):
    """Dense kernels and biases land untouched; the LSTM's gate columns
    are the file's, reordered [i, f, c, o] -> [i, f, o, c]."""
    cfg, weights, train, x = m_lstm_last(_rng(0))
    path = str(tmp_path / "m.h5")
    _write_keras_h5(path, cfg, weights)
    net = P.import_keras_sequential_model_and_weights(path, device="cpu")
    K = weights["l1"][0][1]
    H = 4
    i, f, c, o = (K[:, k * H:(k + 1) * H] for k in range(4))
    np.testing.assert_array_equal(net.params[0]["W"].numpy(),
                                  np.concatenate([i, f, o, c], axis=1))
    np.testing.assert_array_equal(net.params[1]["W"].numpy(),
                                  weights["d1"][0][1])
    assert net.params[0]["W"].dtype == torch.float32


@pytest.mark.parametrize("name", ["keras_golden", "keras_golden_functional"])
def test_committed_goldens(name):
    path = os.path.join(_GOLD, f"{name}.h5")
    d = np.load(os.path.join(_GOLD, f"{name}_io.npz"))
    jnet, pnet = _import_both(path)
    out = _out(pnet, d["x"]).numpy()
    np.testing.assert_allclose(out, d["y"], atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(_out(jnet, d["x"])),
                               OUT_RTOL, OUT_ATOL)
    want, got = flat(jnet.params), port_flat(pnet)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------- training

V, H, T, B = 9, 8, 6, 4


def _char_model(rng, rec="sigmoid", rs2=True, dropout=False, optimizer=ADAM):
    """TextGenerationLSTM's shape at small width: 2 x LSTM(H) -> softmax."""
    layers = [_lstm("l1", H, rec=rec, batch_input_shape=[None, T, V])]
    if dropout:
        layers.append({"class_name": "Dropout",
                       "config": {"name": "do", "rate": 0.2}})
    layers += [_lstm("l2", H, rec=rec, rs=rs2), _dense("d", V, "softmax")]
    w = {"l1": _lstm_weights(rng, "l1", V, H),
         "l2": _lstm_weights(rng, "l2", H, H),
         "d": [("d/kernel:0", _f4(rng, H, V, scale=0.3)),
               ("d/bias:0", _f4(rng, V, scale=0.1))]}
    return _seq_cfg(layers), w, {"loss": "categorical_crossentropy",
                                 "optimizer_config": optimizer}


def _batch(rng, seq=True):
    x = _f4(rng, B, T, V)
    lab = rng.integers(0, V, (B, T) if seq else (B,))
    return x, np.eye(V, dtype="f4")[lab]


def test_fit_updates_the_imported_weights_in_place(tmp_path):
    rng = _rng(11)
    cfg, w, train = _char_model(rng)
    path = str(tmp_path / "char.h5")
    _write_keras_h5(path, cfg, w, training_cfg=train)
    jnet, pnet = _import_both(path)
    imported = {k: v.copy() for k, v in port_flat(pnet).items()}
    fresh = port_flat(P.import_keras_sequential_model_and_weights(
        path, device="cpu").init())
    x, y = _batch(rng)
    for _ in range(2):
        jnet.fit(x, y)
        pnet.fit(x, y)
    want, got = flat(jnet.params), port_flat(pnet)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], FIT_RTOL, FIT_ATOL,
                                   err_msg=k)
        assert not np.array_equal(got[k], imported[k]), k
        # an Adam step moves a weight by about lr: far from the init draws
        assert np.abs(got[k] - imported[k]).max() < 0.05, k
        assert np.abs(got[k] - fresh[k]).max() > 0.1, k
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), FIT_RTOL,
                               FIT_ATOL)
    assert pnet._params_version >= 2


def test_import_bumps_the_params_version_once_after_init(tmp_path):
    cfg, w, train = _char_model(_rng(1))
    path = str(tmp_path / "char.h5")
    _write_keras_h5(path, cfg, w, training_cfg=train)
    net = P.import_keras_sequential_model_and_weights(path, device="cpu")
    assert net._params_version == 2     # init() and the weights' copy


def _spy(monkeypatch):
    counts = {}
    for name in ("fused_lstm_sequence", "fused_lstm_sequence_train",
                 "fused_lstm2_sequence", "fused_lstm2_sequence_train",
                 "fused_lstm_backward"):
        real = getattr(lstm_cuda, name)

        def wrapped(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(lstm_cuda, name, wrapped)
    return counts


@pytest.mark.parametrize("case,out_calls,fit_calls", [
    ("pair", {"fused_lstm2_sequence": 1},
     {"fused_lstm2_sequence_train": 1, "fused_lstm_backward": 2}),
    ("last_time_step", {"fused_lstm_sequence": 2},
     {"fused_lstm_sequence_train": 2, "fused_lstm_backward": 2}),
    ("dropout_between", {"fused_lstm_sequence": 2},
     {"fused_lstm_sequence_train": 2, "fused_lstm_backward": 2}),
    ("hard_sigmoid", {}, {}),
])
def test_imported_lstm_launch_routes(tmp_path, monkeypatch, case, out_calls,
                                     fit_calls):
    rng = _rng(21)
    cfg, w, train = _char_model(
        rng, rec="hard_sigmoid" if case == "hard_sigmoid" else "sigmoid",
        rs2=case != "last_time_step", dropout=case == "dropout_between")
    path = str(tmp_path / "m.h5")
    _write_keras_h5(path, cfg, w, training_cfg=train)
    jnet, pnet = _import_both(path)
    if case == "last_time_step":
        assert isinstance(pnet.layers[1], pl.LastTimeStep)
    counts = _spy(monkeypatch)
    x, y = _batch(rng, seq=case != "last_time_step")
    out = pnet.output(x)
    assert counts == out_calls
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)),
                               OUT_RTOL, OUT_ATOL)
    counts.clear()
    pnet.fit(x, y)
    assert counts == fit_calls


# ---------------------------------------------------------- errors, h5py

def test_import_errors_match_jax(tmp_path):
    bad = str(tmp_path / "bad.h5")
    with h5py.File(bad, "w") as f:
        f.create_dataset("x", data=np.zeros(3))
    with pytest.raises(P.InvalidKerasConfigurationException):
        P.import_keras_sequential_model_and_weights(bad, device="cpu")
    unsup = str(tmp_path / "unsup.h5")
    _write_keras_h5(unsup, _seq_cfg([{"class_name": "Permute", "config": {
        "name": "r", "dims": [2, 1], "batch_input_shape": [None, 4, 3]}}]), {})
    with pytest.raises(P.UnsupportedKerasConfigurationException):
        P.import_keras_sequential_model_and_weights(unsup, device="cpu")
    cf = str(tmp_path / "cf_reshape.h5")
    _write_keras_h5(cf, _seq_cfg([
        {"class_name": "Conv2D", "config": {
            "name": "c", "filters": 2, "kernel_size": [3, 3],
            "data_format": "channels_first", "padding": "same",
            "batch_input_shape": [None, 2, 8, 8]}},
        {"class_name": "Reshape", "config": {
            "name": "r", "target_shape": [2, 32, 2]}}]), {})
    with pytest.raises(P.UnsupportedKerasConfigurationException):
        P.import_keras_sequential_model_and_weights(cf, device="cpu")
    fn = str(tmp_path / "fn.h5")
    cfg, w, _, _ = m_functional_add(_rng(0))
    _write_keras_h5(fn, cfg, w)
    with pytest.raises(P.InvalidKerasConfigurationException):
        P.import_keras_sequential_model_and_weights(fn, device="cpu")
    with pytest.raises(P.InvalidKerasConfigurationException):
        P.import_keras_model_and_weights(unsup, device="cpu")
    # a weight of the wrong shape names the layer and both shapes
    mlp_cfg, mlp_w, _, _ = m_mlp(_rng(0))
    mlp_w["d2"][0] = ("d2/kernel:0", np.zeros((8, 4), "f4"))
    wrong = str(tmp_path / "wrong.h5")
    _write_keras_h5(wrong, mlp_cfg, mlp_w)
    with pytest.raises(P.InvalidKerasConfigurationException,
                       match=r"\(8, 3\) vs h5 \(8, 4\)"):
        P.import_keras_sequential_model_and_weights(wrong, device="cpu")


def test_config_json_and_enforced_training_config(tmp_path):
    cfg, w, _, x = m_mlp(_rng(3))
    path = str(tmp_path / "weights.h5")
    _write_keras_h5(path, {"class_name": "Sequential", "config": []}, w)
    with h5py.File(path, "a") as f:
        del f.attrs["model_config"]
    jnet = J.import_keras_sequential_model_and_weights(
        path, config_json=json.dumps(cfg))
    pnet = P.import_keras_sequential_model_and_weights(
        path, config_json=json.dumps(cfg), device="cpu")
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), OUT_RTOL, OUT_ATOL)
    with pytest.raises(P.InvalidKerasConfigurationException):
        P.import_keras_sequential_model_and_weights(
            path, config_json=json.dumps(cfg), enforce_training_config=True,
            device="cpu")


def test_without_h5py_the_entry_points_raise_jax_import_error(
        tmp_path, monkeypatch):
    cfg, w, _, _ = m_mlp(_rng(0))
    path = str(tmp_path / "m.h5")
    _write_keras_h5(path, cfg, w)
    monkeypatch.setitem(sys.modules, "h5py", None)
    for jfn, pfn in (
            (J.import_keras_sequential_model_and_weights,
             P.import_keras_sequential_model_and_weights),
            (J.import_keras_model_and_weights,
             P.import_keras_model_and_weights),
            (J.KerasModelImport.import_keras_model,
             P.KerasModelImport.import_keras_model)):
        with pytest.raises(ImportError) as je:
            jfn(path)
        with pytest.raises(ImportError) as pe:
            pfn(path, device="cpu")
        assert type(pe.value) is type(je.value)
        assert str(pe.value) == str(je.value)


def test_package_imports_without_h5py():
    code = ("import sys; sys.modules['h5py'] = None; "
            "import deeplearning4j_tpu_torch.modelimport as m; "
            "print(sorted(m.__all__))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert "KerasModelImport" in out.stdout


class _Node(dict):
    """A group of a dict-backed stand-in for an open HDF5 file."""

    def __init__(self, attrs=None, **items):
        super().__init__(**items)
        self.attrs = dict(attrs or {})


def test_private_importers_read_any_mapping(tmp_path):
    """``_import_sequential`` / ``_import_graph`` read only attrs, ``in``,
    ``[]`` and ``np.asarray(node)``: a dict stand-in gives the import the
    h5py file gives."""
    for model, fn in ((m_lstm_last, pk._import_sequential),
                      (m_functional_add, pk._import_graph)):
        cfg, w, train, x = model(_rng(5))
        path = str(tmp_path / f"{model.__name__}.h5")
        _write_keras_h5(path, cfg, w, training_cfg=train)
        groups = {name: _Node({"weight_names": [n for n, _ in ws]},
                              **{n: a for n, a in ws})
                  for name, ws in w.items()}
        attrs = {"model_config": json.dumps(cfg)}
        if train is not None:
            attrs["training_config"] = json.dumps(train)
        stand_in = _Node(attrs, model_weights=_Node(**groups))
        via_dict = fn(stand_in, device="cpu")
        via_file = P.KerasModelImport.import_keras_model(path, device="cpu")
        a, b = port_flat(via_dict), port_flat(via_file)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", ["SeparableConv2D", "DepthwiseConv2D"])
@pytest.mark.parametrize("cin", [1, 2])
def test_depthwise_kernels(tmp_path, kind, cin):
    """SeparableConv2D / DepthwiseConv2D: the file's depthwise kernel (kh,
    kw, in, mult) goes in as it is, as in the JAX package, whose kernel is
    (kh, kw, 1, in * mult): one input channel imports, more are refused
    in both packages with the same shape error (ROADMAP queue 3, R12)."""
    rng = _rng(cin)
    conv = {"name": "sc", "kernel_size": [3, 3], "padding": "valid",
            "depth_multiplier": 2, "activation": "relu", "use_bias": True,
            "batch_input_shape": [None, 6, 6, cin]}
    w = {"sc": [("sc/depthwise_kernel:0", _f4(rng, 3, 3, cin, 2))]}
    if kind == "SeparableConv2D":
        conv["filters"] = n_out = 4
        w["sc"] += [("sc/pointwise_kernel:0", _f4(rng, 1, 1, 2 * cin, 4))]
    else:
        n_out = 2 * cin
    w["sc"] += [("sc/bias:0", _f4(rng, n_out))]
    w["d"] = [("d/kernel:0", _f4(rng, 16 * n_out, 2)),
              ("d/bias:0", _f4(rng, 2))]
    cfg = _seq_cfg([{"class_name": kind, "config": conv},
                    {"class_name": "Flatten", "config": {"name": "f"}},
                    _dense("d", 2)])
    path = str(tmp_path / "sc.h5")
    _write_keras_h5(path, cfg, w)
    if cin > 1:
        with pytest.raises(J.InvalidKerasConfigurationException) as je:
            J.import_keras_sequential_model_and_weights(path)
        with pytest.raises(P.InvalidKerasConfigurationException) as pe:
            P.import_keras_sequential_model_and_weights(path, device="cpu")
        assert str(pe.value) == str(je.value)
        return
    jnet, pnet = _import_both(path)
    x = _f4(rng, 2, 6, 6, 1)
    np.testing.assert_allclose(pnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), OUT_RTOL, OUT_ATOL)
    want, got = flat(jnet.params), port_flat(pnet)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
