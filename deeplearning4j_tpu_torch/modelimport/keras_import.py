"""Keras 1.x/2.x HDF5 -> deeplearning4j_tpu_torch import.

Counterpart of deeplearning4j_tpu/modelimport/keras_import.py (parity
surface: the reference's KerasModelImport.java:41, KerasModel.java,
KerasSequentialModel.java, layers/**, Hdf5Archive.java). The configuration
translation is the JAX package's, name for name; the importers build the
port's ordinary containers, so an imported recurrent model is served and
trained through the port's LSTM kernels (K4 for a stacked pair, K1 for a
single LSTM, K4-train and K3 under ``fit``) wherever its layers pass their
screens.

Weight layout, as in the JAX package:
- Keras TF-format conv kernels are (kh, kw, in, out), the port's HWIO;
  Dense kernels are (in, out), the port's.
- Keras LSTM gates are [i, f, c, o]; the port's fused (in, 4H) layout is
  [i, f, o, g]: columns are permuted once at import.
- Theano-format (channels_first) conv kernels (out, in, kh, kw) are
  flipped and transposed to HWIO; a Dense right after a Flatten of a
  channels-first map gets its rows permuted from (c, h, w) to (h, w, c).

The weights are copied INTO the tensors ``init()`` made: the fused update
plan (nn/fused_update.py) keeps each layer's parameters as views of one
flat buffer, and a captured step reads them by address, so a rebound
tensor would leave every later ``fit`` on the random ``init()`` draws.

Each public importer opens the file with h5py (imported on call, so the
package imports without it) and hands the open file to a private function
that reads only ``attrs``, ``in``, ``[]`` and ``np.asarray(node)``: any
object with that mapping interface is a file to it.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    GlobalConf, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertex, GraphBuilder, MergeVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, Convolution1DLayer, ConvolutionLayer,
    Cropping2D, DenseLayer, DepthwiseConvolution2D, DropoutLayer,
    EmbeddingSequenceLayer, FlattenLayer, GlobalPoolingLayer, LastTimeStep,
    LocalResponseNormalization, LSTM, OutputLayer, ReshapeLayer,
    SeparableConvolution2D, SimpleRnn, Subsampling1DLayer, SubsamplingLayer,
    Upsampling1D, Upsampling2D, ZeroPadding1DLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.models.multi_layer_network import \
    MultiLayerNetwork
from deeplearning4j_tpu_torch.models.computation_graph import \
    ComputationGraph

class InvalidKerasConfigurationException(ValueError):
    """Parity: keras/exceptions/InvalidKerasConfigurationException.java."""


class UnsupportedKerasConfigurationException(ValueError):
    """Parity: keras/exceptions/UnsupportedKerasConfigurationException.java."""


# ---------------------------------------------------------------------------
# name maps
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "relu": "relu", "softmax": "softmax", "sigmoid": "sigmoid",
    "tanh": "tanh", "linear": "identity", "elu": "elu", "selu": "selu",
    "softplus": "softplus", "softsign": "softsign",
    "hard_sigmoid": "hardsigmoid", "relu6": "relu6", "swish": "swish",
    "gelu": "gelu",
}

_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "hinge": "hinge", "squared_hinge": "squaredhinge",
    "kullback_leibler_divergence": "kldivergence",
    "poisson": "poisson", "cosine_proximity": "cosineproximity",
}


def _map_activation(name: str) -> str:
    if name not in _ACTIVATIONS:
        raise UnsupportedKerasConfigurationException(
            f"Unsupported Keras activation '{name}'")
    return _ACTIVATIONS[name]


def _map_optimizer(training_cfg: Optional[Dict]):
    """Keras optimizer_config → our Updater (parity: KerasModel training
    config import). Returns None when absent/unknown-safe."""
    from deeplearning4j_tpu_torch.nn import updaters as U
    if not training_cfg:
        return None
    oc = training_cfg.get("optimizer_config")
    if not oc:
        return None
    cls = str(oc.get("class_name", "")).lower()
    cfg = oc.get("config", {})
    lr = float(cfg.get("learning_rate", cfg.get("lr", 0.001)))
    if cls == "adam":
        return U.Adam(lr, beta1=float(cfg.get("beta_1", 0.9)),
                      beta2=float(cfg.get("beta_2", 0.999)))
    if cls == "sgd":
        mom = float(cfg.get("momentum", 0.0))
        return U.Nesterovs(lr, momentum=mom) if mom else U.Sgd(lr)
    if cls == "rmsprop":
        return U.RmsProp(lr, rms_decay=float(cfg.get("rho", 0.9)))
    if cls == "adagrad":
        return U.AdaGrad(lr)
    if cls == "adadelta":
        return U.AdaDelta(rho=float(cfg.get("rho", 0.95)))
    if cls == "adamax":
        return U.AdaMax(lr)
    if cls == "nadam":
        return U.NAdam(lr)
    return None


def _map_loss(loss) -> str:
    """Map a Keras training-config loss — string, list, or {output: loss}
    dict (multi-output compiles) — to our loss name."""
    if isinstance(loss, dict):
        loss = next(iter(loss.values()))
    if isinstance(loss, (list, tuple)):
        loss = loss[0]
    key = str(loss).lower()
    if key not in _LOSSES:
        raise UnsupportedKerasConfigurationException(
            f"Unsupported Keras loss '{loss}'")
    return _LOSSES[key]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def _single(v) -> int:
    """Scalar-or-singleton-list 1-D hyperparameter (Keras stores Conv1D
    kernel_size as [k])."""
    return int(v[0] if isinstance(v, (list, tuple)) else v)


# ---------------------------------------------------------------------------
# per-layer translators (parity: keras/layers/** KerasDense, KerasConvolution…)
# ---------------------------------------------------------------------------

def _conv_mode(cfg: Dict) -> str:
    border = cfg.get("padding", cfg.get("border_mode", "valid"))
    if border == "same":
        return "same"
    if border == "valid":
        return "truncate"
    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras padding mode '{border}'")


def _keras1_kernel(cfg: Dict) -> Tuple[int, int]:
    return (int(cfg["nb_row"]), int(cfg["nb_col"]))


def _translate_layer(class_name: str, cfg: Dict, keras_major: int):
    """One Keras layer config → (our Layer | 'flatten' | None-to-skip)."""
    act = cfg.get("activation")
    act = _map_activation(act) if act else None

    if class_name in ("Dense", "TimeDistributedDense"):
        units = int(cfg.get("units", cfg.get("output_dim", 0)))
        return DenseLayer(n_out=units, activation=act or "identity",
                          has_bias=bool(cfg.get("use_bias", cfg.get("bias", True))))
    if class_name == "Activation":
        return ActivationLayer(activation=act or "identity")
    if class_name in ("Dropout", "SpatialDropout2D", "SpatialDropout1D"):
        return DropoutLayer(dropout=float(cfg.get("rate", cfg.get("p", 0.0))))
    if class_name == "Flatten":
        return "flatten"
    if class_name == "Reshape":
        return ReshapeLayer(target_shape=tuple(cfg.get("target_shape", ())))
    if class_name in ("Permute", "RepeatVector", "Masking"):
        raise UnsupportedKerasConfigurationException(
            f"Keras layer '{class_name}' is not yet supported")
    if class_name in ("Conv2D", "Convolution2D", "AtrousConvolution2D"):
        # AtrousConvolution2D (Keras 1) is a dilated conv: atrous_rate maps
        # to dilation (parity: KerasAtrousConvolution2D.java)
        k = (_pair(cfg["kernel_size"]) if "kernel_size" in cfg
             else _keras1_kernel(cfg))
        dil = _pair(cfg.get("dilation_rate", cfg.get("atrous_rate", (1, 1))))
        return ConvolutionLayer(
            n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
            kernel_size=k,
            stride=_pair(cfg.get("strides", cfg.get("subsample", (1, 1)))),
            dilation=dil,
            convolution_mode=_conv_mode(cfg),
            activation=act or "identity",
            has_bias=bool(cfg.get("use_bias", cfg.get("bias", True))))
    if class_name in ("Conv1D", "Convolution1D", "AtrousConvolution1D"):
        border = cfg.get("padding", cfg.get("border_mode", "valid"))
        if border == "causal":
            raise UnsupportedKerasConfigurationException(
                "Keras Conv1D causal padding is not supported")
        return Convolution1DLayer(
            n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
            kernel_size=_single(cfg.get("kernel_size",
                                        cfg.get("filter_length", 3))),
            stride=_single(cfg.get("strides", cfg.get("subsample_length", 1))),
            dilation=_single(cfg.get("dilation_rate",
                                     cfg.get("atrous_rate", 1))),
            convolution_mode=_conv_mode(cfg),
            activation=act or "identity",
            has_bias=bool(cfg.get("use_bias", cfg.get("bias", True))))
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        p = _single(cfg.get("pool_size", cfg.get("pool_length", 2)))
        s = _single(cfg.get("strides", cfg.get("stride")) or p)
        return Subsampling1DLayer(
            pooling_type="max" if class_name.startswith("Max") else "avg",
            kernel_size=p, stride=s, convolution_mode=_conv_mode(cfg),
            avg_count_includes_padding=False)   # Keras/TF edge semantics
    if class_name == "UpSampling1D":
        return Upsampling1D(size=_single(cfg.get("size",
                                                 cfg.get("length", 2))))
    if class_name == "ZeroPadding1D":
        p = cfg.get("padding", 1)
        pad = ((int(p[0]), int(p[1])) if isinstance(p, (list, tuple))
               else (int(p), int(p)))
        return ZeroPadding1DLayer(padding=pad)
    if class_name in ("LRN", "LRN2D", "LocalResponseNormalization"):
        # Keras-contrib / Keras 0.x LRN (parity: KerasLRN.java)
        return LocalResponseNormalization(
            k=float(cfg.get("k", 2.0)), alpha=float(cfg.get("alpha", 1e-4)),
            beta=float(cfg.get("beta", 0.75)), n=int(cfg.get("n", 5)))
    if class_name == "SeparableConv2D":
        return SeparableConvolution2D(
            n_out=int(cfg.get("filters", 0)),
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", (1, 1))),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode=_conv_mode(cfg),
            activation=act or "identity",
            has_bias=bool(cfg.get("use_bias", True)))
    if class_name == "DepthwiseConv2D":
        return DepthwiseConvolution2D(
            kernel_size=_pair(cfg["kernel_size"]),
            stride=_pair(cfg.get("strides", (1, 1))),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode=_conv_mode(cfg),
            activation=act or "identity",
            has_bias=bool(cfg.get("use_bias", True)))
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        return SubsamplingLayer(
            pooling_type="max" if class_name.startswith("Max") else "avg",
            kernel_size=_pair(cfg.get("pool_size", (2, 2))),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", (2, 2))),
            convolution_mode=_conv_mode(cfg),
            avg_count_includes_padding=False)   # Keras/TF edge semantics
    if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
                      "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        return GlobalPoolingLayer(
            pooling_type="max" if "Max" in class_name else "avg")
    if class_name == "BatchNormalization":
        return BatchNormalization(
            activation="identity",
            eps=float(cfg.get("epsilon", 1e-3)),
            decay=float(cfg.get("momentum", 0.99)))
    if class_name == "LSTM":
        units = int(cfg.get("units", cfg.get("output_dim", 0)))
        rnn = LSTM(n_out=units, activation=act or "tanh",
                   gate_activation=_map_activation(
                       cfg.get("recurrent_activation",
                               cfg.get("inner_activation", "sigmoid"))))
        if not cfg.get("return_sequences", False):
            return LastTimeStep(fwd=rnn)
        return rnn
    if class_name == "SimpleRNN":
        units = int(cfg.get("units", cfg.get("output_dim", 0)))
        rnn = SimpleRnn(n_out=units, activation=act or "tanh")
        if not cfg.get("return_sequences", False):
            return LastTimeStep(fwd=rnn)
        return rnn
    if class_name == "Embedding":
        return EmbeddingSequenceLayer(
            activation="identity",
            n_in=int(cfg.get("input_dim", 0)),
            n_out=int(cfg.get("output_dim", 0)))
    if class_name == "ZeroPadding2D":
        p = cfg.get("padding", (1, 1))
        if isinstance(p, (list, tuple)) and p and isinstance(p[0], (list, tuple)):
            pad = (int(p[0][0]), int(p[0][1]), int(p[1][0]), int(p[1][1]))
        else:
            ph, pw = _pair(p)
            pad = (ph, ph, pw, pw)
        return ZeroPaddingLayer(padding=pad)
    if class_name == "UpSampling2D":
        return Upsampling2D(size=_pair(cfg.get("size", (2, 2))))
    if class_name == "Cropping2D":
        c = cfg.get("cropping", (0, 0))
        if isinstance(c, (list, tuple)) and c and isinstance(c[0], (list, tuple)):
            crop = (int(c[0][0]), int(c[0][1]), int(c[1][0]), int(c[1][1]))
        else:
            ch, cw = _pair(c)
            crop = (ch, ch, cw, cw)
        return Cropping2D(cropping=crop)
    if class_name == "LeakyReLU":
        return ActivationLayer(activation="leakyrelu")
    if class_name == "InputLayer":
        return None
    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras layer type '{class_name}'")


def _check_reshape(t, channels_first: bool):
    """A 3-D Reshape target in a channels_first model means (C, H, W) over
    NCHW data; our NHWC runtime cannot honor it with a plain reshape —
    refuse loudly instead of producing silently scrambled activations."""
    if isinstance(t, ReshapeLayer) and channels_first \
            and len(t.target_shape) == 3:
        raise UnsupportedKerasConfigurationException(
            "Reshape to a 3-D target in a channels_first model is not "
            "supported (NHWC runtime would scramble the layout)")
    return t


def _input_type_from_shape(shape, data_format: str) -> InputType:
    """batch_input_shape (excluding batch dim) → InputType. Rank decides the
    kind; ``None`` dims stay as wildcards (variable timesteps / image size),
    they are NOT dropped — [None, 5] is recurrent(5), not feed_forward(5)."""
    dims = list(shape)
    if len(dims) == 3:
        if data_format == "channels_first":
            c, h, w = dims
        else:
            h, w, c = dims
        if c is None:
            raise UnsupportedKerasConfigurationException(
                f"Convolutional input with unknown channel count: {shape}")
        return InputType.convolutional(int(h) if h else -1,
                                       int(w) if w else -1, int(c))
    if len(dims) == 2:
        if dims[1] is None:
            raise UnsupportedKerasConfigurationException(
                f"Recurrent input with unknown feature size: {shape}")
        return InputType.recurrent(int(dims[1]),
                                   int(dims[0]) if dims[0] else -1)
    if len(dims) == 1:
        if dims[0] is None:
            raise UnsupportedKerasConfigurationException(
                f"Cannot infer input width from {shape}")
        return InputType.feed_forward(int(dims[0]))
    raise UnsupportedKerasConfigurationException(
        f"Cannot infer input type from shape {shape}")



# ---------------------------------------------------------------------------
# weight translation
# ---------------------------------------------------------------------------

def _lstm_reorder(k: np.ndarray, H: int) -> np.ndarray:
    """Keras gate order [i,f,c,o] -> the port's [i,f,o,g] along the last
    axis."""
    i, f, c, o = (k[..., 0:H], k[..., H:2 * H], k[..., 2 * H:3 * H],
                  k[..., 3 * H:4 * H])
    return np.concatenate([i, f, o, c], axis=-1)


def _theano_conv_kernel(k: np.ndarray) -> np.ndarray:
    """(out, in, kh, kw) -> (kh, kw, in, out), with the 180 degree kernel
    flip Theano's conv (true convolution) implies against TF's
    cross-correlation (parity: KerasConvolution weight processing)."""
    k = k[:, :, ::-1, ::-1]
    return np.transpose(k, (2, 3, 1, 0))


def _copy_into(t: torch.Tensor, arr: np.ndarray) -> None:
    """Write ``arr`` into ``t`` in place, cast to ``t``'s dtype."""
    with torch.no_grad():
        t.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype))


def _set_layer_weights(layer, params: Dict[str, torch.Tensor],
                       state: Dict[str, torch.Tensor],
                       weights: List[np.ndarray], theano_kernels: bool,
                       flatten_permute: Optional[Tuple[int, int, int]]):
    """Copy Keras weight arrays into one layer's parameter tensors (and a
    BatchNormalization's running statistics into ``state``'s).
    ``theano_kernels``: conv kernels stored (out, in, kh, kw) with flipped
    taps (Keras 1 on the Theano backend), decided from the file's backend
    metadata, never from shape heuristics. ``flatten_permute`` = (h, w, c)
    of the conv output feeding a Dense through a Flatten under
    channels_first: rows need (c,h,w) -> (h,w,c) reordering."""
    if isinstance(layer, LastTimeStep):
        layer = layer.fwd

    def put(key, arr):
        if key not in params:
            raise InvalidKerasConfigurationException(
                f"Layer {layer.__class__.__name__} has no param '{key}'")
        if tuple(params[key].shape) != tuple(arr.shape):
            raise InvalidKerasConfigurationException(
                f"Shape mismatch for {layer.__class__.__name__}.{key}: "
                f"model {tuple(params[key].shape)} vs h5 {tuple(arr.shape)}")
        _copy_into(params[key], arr)

    name = layer.__class__.__name__
    if isinstance(layer, SeparableConvolution2D):
        put("dW", weights[0])
        put("pW", weights[1])
        if layer.has_bias and len(weights) > 2:
            put("b", weights[2])
    elif isinstance(layer, DepthwiseConvolution2D):
        dk = weights[0]  # keras: (kh, kw, in, mult) -- the port's too
        put("dW", dk) if "dW" in params else put("W", dk)
        if layer.has_bias and len(weights) > 1:
            put("b", weights[1])
    elif isinstance(layer, Convolution1DLayer):
        k = weights[0]
        if k.ndim == 4:          # keras1 stores (filter_length, 1, in, out)
            k = k[:, 0, :, :]
        put("W", k)
        if layer.has_bias and len(weights) > 1:
            put("b", weights[1])
    elif isinstance(layer, ConvolutionLayer):
        k = weights[0]
        if theano_kernels and k.ndim == 4:
            k = _theano_conv_kernel(k)
        put("W", k)
        if layer.has_bias and len(weights) > 1:
            put("b", weights[1])
    elif isinstance(layer, (DenseLayer, OutputLayer)):
        W = weights[0]
        if flatten_permute is not None:
            h, w, c = flatten_permute
            # rows currently ordered (c,h,w); reorder to the port's (h,w,c)
            W = (W.reshape(c, h, w, -1).transpose(1, 2, 0, 3)
                 .reshape(h * w * c, -1))
        put("W", W)
        if len(weights) > 1:
            put("b", weights[1])
    elif isinstance(layer, LSTM):
        H = layer.n_out
        if len(weights) == 3:        # keras2: kernel, recurrent, bias
            put("W", _lstm_reorder(weights[0], H))
            put("RW", _lstm_reorder(weights[1], H))
            put("b", _lstm_reorder(weights[2].reshape(-1), H))
        elif len(weights) == 12:     # keras1: per-gate W_i,U_i,b_i x [i,c,f,o]
            Wi, Ui, bi, Wc, Uc, bc, Wf, Uf, bf, Wo, Uo, bo = weights
            put("W", np.concatenate([Wi, Wf, Wo, Wc], axis=1))
            put("RW", np.concatenate([Ui, Uf, Uo, Uc], axis=1))
            put("b", np.concatenate([bi, bf, bo, bc]))
        else:
            raise UnsupportedKerasConfigurationException(
                f"Unexpected LSTM weight count {len(weights)}")
    elif isinstance(layer, SimpleRnn):
        put("W", weights[0])
        put("RW", weights[1])
        if len(weights) > 2:
            put("b", weights[2])
    elif isinstance(layer, BatchNormalization):
        # keras order: gamma, beta, moving_mean, moving_variance
        put("gamma", weights[0])
        put("beta", weights[1])
        _copy_into(state["mean"], weights[2])
        _copy_into(state["var"], weights[3])
    elif isinstance(layer, EmbeddingSequenceLayer):
        put("W", weights[0])
    elif weights:
        raise UnsupportedKerasConfigurationException(
            f"Don't know how to load weights into {name}")


# ---------------------------------------------------------------------------
# HDF5 reading (parity: Hdf5Archive.java)
# ---------------------------------------------------------------------------

def _h5_str(v) -> str:
    return v.decode("utf-8") if isinstance(v, bytes) else str(v)


def _read_configs(h5):
    model_config = h5.attrs.get("model_config")
    if model_config is None:
        raise InvalidKerasConfigurationException(
            "HDF5 file has no 'model_config' attribute (weights-only file? "
            "pass the config JSON separately)")
    training_config = h5.attrs.get("training_config")
    return (json.loads(_h5_str(model_config)),
            json.loads(_h5_str(training_config)) if training_config is not None
            else None)


def _weights_group(h5):
    return h5["model_weights"] if "model_weights" in h5 else h5


def _layer_weights(wg, layer_name: str) -> List[np.ndarray]:
    if layer_name not in wg:
        return []
    g = wg[layer_name]
    names = g.attrs.get("weight_names")
    if names is None:
        return []
    out = []
    for n in names:
        n = _h5_str(n)
        node = g[n] if n in g else wg[n]
        out.append(np.asarray(node))
    return out


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------

def _iter_seq_layers(model_cfg: Dict):
    """Yield (class_name, config, name) for a Sequential model, Keras 1&2."""
    cfg = model_cfg["config"]
    layer_list = cfg["layers"] if isinstance(cfg, dict) else cfg
    for ld in layer_list:
        lcfg = ld.get("config", {})
        yield ld["class_name"], lcfg, lcfg.get("name", ld.get("name"))


def import_keras_sequential_model_and_weights(
        model_h5_path: str, *, enforce_training_config: bool = False,
        config_json: Optional[str] = None,
        input_type: Optional[InputType] = None,
        device=None) -> MultiLayerNetwork:
    """Keras Sequential -> MultiLayerNetwork on ``device`` (default: the
    card) (parity: KerasModelImport.importKerasSequentialModelAndWeights)."""
    import h5py
    with h5py.File(model_h5_path, "r") as h5:
        return _import_sequential(
            h5, enforce_training_config=enforce_training_config,
            config_json=config_json, input_type=input_type, device=device)


def _import_sequential(h5, *, enforce_training_config: bool = False,
                       config_json: Optional[str] = None,
                       input_type: Optional[InputType] = None,
                       device=None) -> MultiLayerNetwork:
    """``import_keras_sequential_model_and_weights`` on an open file."""
    if config_json is not None:
        model_cfg = json.loads(config_json)
        training_cfg = None
    else:
        model_cfg, training_cfg = _read_configs(h5)
    if model_cfg["class_name"] != "Sequential":
        raise InvalidKerasConfigurationException(
            f"Not a Sequential model: {model_cfg['class_name']}")
    loss_name = None
    if training_cfg and training_cfg.get("loss"):
        loss_name = _map_loss(training_cfg["loss"])
    elif enforce_training_config:
        raise InvalidKerasConfigurationException(
            "enforce_training_config=True but model has no training config")

    entries = list(_iter_seq_layers(model_cfg))
    data_format = "channels_last"
    for _, lcfg, _ in entries:
        if lcfg.get("data_format") or lcfg.get("dim_ordering"):
            df = lcfg.get("data_format") or lcfg.get("dim_ordering")
            data_format = ("channels_first" if df in ("channels_first", "th")
                           else "channels_last")
            break
    channels_first = data_format == "channels_first"
    backend = _h5_str(model_cfg.get("backend", "") or "")
    theano_kernels = channels_first and backend != "tensorflow"

    if input_type is None:
        # Keras 1/2: batch_input_shape on the first real layer;
        # Keras 3 legacy h5: batch_shape on an explicit InputLayer
        shape = None
        for _, lcfg, _ in entries[:2]:
            shape = (lcfg.get("batch_input_shape")
                     or lcfg.get("batch_shape"))
            if shape is not None:
                break
        if shape is None:
            raise InvalidKerasConfigurationException(
                "First layer has no batch_input_shape; pass input_type=")
        input_type = _input_type_from_shape(shape[1:], data_format)

    # translate layers
    ours: List[Tuple[Any, str]] = []   # (layer, keras_name)
    flatten_pending = False
    flatten_after: Dict[int, bool] = {}
    for class_name, lcfg, name in entries:
        t = _check_reshape(_translate_layer(class_name, lcfg, 2),
                           channels_first)
        if t == "flatten":
            # a real layer: the port's Dense is time-distributed over
            # (B, T, C) sequence inputs, so Keras's flatten must flatten
            ours.append((FlattenLayer(), name))
            flatten_pending = True
            continue
        if t is None:
            continue
        if flatten_pending:
            flatten_after[len(ours)] = True
            flatten_pending = False
        ours.append((t, name))

    # last layer + loss -> OutputLayer (parity: KerasLoss handling)
    if loss_name is not None and isinstance(ours[-1][0], DenseLayer) \
            and not isinstance(ours[-1][0], OutputLayer):
        d = ours[-1][0]
        ours[-1] = (OutputLayer(n_out=d.n_out, activation=d.activation,
                                loss=loss_name, has_bias=d.has_bias),
                    ours[-1][1])

    bb = NeuralNetConfiguration.builder()
    upd = _map_optimizer(training_cfg)
    if upd is not None:
        bb.updater(upd)
    b = bb.list()
    for l, _ in ours:
        b.layer(l)
    conf = b.set_input_type(input_type).build()
    net = MultiLayerNetwork(conf, device=device).init()

    # load weights into the tensors init() made
    wg = _weights_group(h5)
    out_types = [input_type] + conf.output_types()
    for idx, (l, kname) in enumerate(ours):
        w = _layer_weights(wg, kname)
        if not w:
            continue
        fp = None
        if channels_first and flatten_after.get(idx):
            it = out_types[idx - 1]      # input of the FlattenLayer
            if it.kind == "cnn":
                fp = (it.height, it.width, it.channels)
        _set_layer_weights(net.layers[idx], net.params[idx], net.state[idx],
                           w, theano_kernels, fp)
    net._params_version += 1
    return net


def import_keras_model_and_weights(
        model_h5_path: str, *, input_type: Optional[InputType] = None,
        device=None) -> ComputationGraph:
    """Keras functional Model -> ComputationGraph on ``device`` (default:
    the card) (parity: KerasModelImport.importKerasModelAndWeights).
    Supports layer nodes plus Add/Subtract/Multiply/Average/Maximum/
    Concatenate merge layers."""
    import h5py
    with h5py.File(model_h5_path, "r") as h5:
        return _import_graph(h5, input_type=input_type, device=device)


def _import_graph(h5, *, input_type: Optional[InputType] = None,
                  device=None) -> ComputationGraph:
    """``import_keras_model_and_weights`` on an open file."""
    model_cfg, training_cfg = _read_configs(h5)
    if model_cfg["class_name"] not in ("Model", "Functional"):
        raise InvalidKerasConfigurationException(
            f"Not a functional model: {model_cfg['class_name']}")
    cfg = model_cfg["config"]
    layers = cfg["layers"]
    loss_name = None
    if training_cfg and training_cfg.get("loss"):
        loss_name = _map_loss(training_cfg["loss"])

    data_format = "channels_last"
    for ld in layers:
        df = ld.get("config", {}).get("data_format")
        if df:
            data_format = df
            break
    channels_first = data_format == "channels_first"
    backend = _h5_str(model_cfg.get("backend", "") or "")
    theano_kernels = channels_first and backend != "tensorflow"

    upd = _map_optimizer(training_cfg)
    gc = GlobalConf(updater=upd) if upd is not None else GlobalConf()
    gb = GraphBuilder(gc)
    input_names = []
    in_types = []
    translated: Dict[str, Any] = {}
    flatten_nodes: set = set()          # names of Flatten pass-throughs
    node_inputs: Dict[str, List[str]] = {}

    def _names(spec) -> List[str]:
        # Keras 2: [["name", 0, 0], ...]; Keras 3 single output:
        # ["name", 0, 0]
        if spec and isinstance(spec[0], str):
            return [spec[0]]
        return [o[0] for o in spec]

    output_names = _names(cfg["output_layers"])

    def inbound(ld) -> List[str]:
        nodes = ld.get("inbound_nodes", [])
        if not nodes:
            return []
        first = nodes[0]
        if isinstance(first, dict):
            # Keras 3: {"args": [KerasTensor | [KerasTensor...]], ...};
            # source layer names live in each tensor's keras_history
            names: List[str] = []

            def walk(o):
                if isinstance(o, dict):
                    if o.get("class_name") == "__keras_tensor__":
                        names.append(o["config"]["keras_history"][0])
                    else:
                        for v in o.values():
                            walk(v)
                elif isinstance(o, (list, tuple)):
                    for v in o:
                        walk(v)

            walk(first.get("args", []))
            return names
        return [n[0] for n in first]

    for ld in layers:
        cls, lcfg = ld["class_name"], ld.get("config", {})
        name = lcfg.get("name", ld.get("name"))
        ins = inbound(ld)
        if cls == "InputLayer":
            input_names.append(name)
            shape = (lcfg.get("batch_input_shape")
                     or lcfg.get("batch_shape"))   # keras 3
            if shape is not None:
                in_types.append(_input_type_from_shape(shape[1:],
                                                       data_format))
            continue
        node_inputs[name] = ins
        if cls in ("Add", "Subtract", "Multiply", "Average", "Maximum"):
            op = {"Add": "add", "Subtract": "subtract",
                  "Multiply": "product", "Average": "average",
                  "Maximum": "max"}[cls]
            gb.add_vertex(name, ElementWiseVertex(op=op), *ins)
            continue
        if cls == "Merge":             # Keras 1 merge with a mode config
            mode = lcfg.get("mode", "concat")
            ew = {"sum": "add", "mul": "product", "ave": "average",
                  "max": "max"}
            if mode in ew:
                gb.add_vertex(name, ElementWiseVertex(op=ew[mode]), *ins)
            elif mode == "concat":
                gb.add_vertex(name, MergeVertex(), *ins)
            else:
                raise UnsupportedKerasConfigurationException(
                    f"Unsupported Keras1 Merge mode '{mode}'")
            continue
        if cls == "Concatenate":
            gb.add_vertex(name, MergeVertex(), *ins)
            continue
        t = _check_reshape(_translate_layer(cls, lcfg, 2), channels_first)
        if t == "flatten":
            flatten_nodes.add(name)
            gb.add_layer(name, FlattenLayer(), *ins)
            continue
        if loss_name is not None and name in output_names \
                and isinstance(t, DenseLayer) \
                and not isinstance(t, OutputLayer):
            t = OutputLayer(n_out=t.n_out, activation=t.activation,
                            loss=loss_name, has_bias=t.has_bias)
        gb.add_layer(name, t, *ins)
        translated[name] = t

    gb.add_inputs(*input_names)
    if input_type is not None:
        in_types = [input_type]
    if in_types:
        gb.set_input_types(*in_types)
    gb.set_outputs(*output_names)
    conf = gb.build()
    net = ComputationGraph(conf, device=device).init()

    wg = _weights_group(h5)
    node_types = getattr(conf, "node_output_types", {})
    for name, l in translated.items():
        w = _layer_weights(wg, name)
        if not w:
            continue
        fp = None
        ins = node_inputs.get(name, [])
        if channels_first and ins and ins[0] in flatten_nodes:
            # Dense fed by a Flatten of a conv map: permute rows
            # (c,h,w) -> (h,w,c) exactly like the sequential path
            src = node_inputs.get(ins[0], [])
            it = node_types.get(src[0]) if src else None
            if it is not None and it.kind == "cnn":
                fp = (it.height, it.width, it.channels)
        _set_layer_weights(l, net.params[name], net.state[name], w,
                           theano_kernels, fp)
    net._params_version += 1
    return net


class KerasModelImport:
    """Static facade (parity: KerasModelImport.java:41)."""

    importKerasSequentialModelAndWeights = staticmethod(
        import_keras_sequential_model_and_weights)
    importKerasModelAndWeights = staticmethod(import_keras_model_and_weights)

    @staticmethod
    def import_keras_model(path: str, **kw):
        """Sniff Sequential vs functional and import accordingly
        (parity: util/ModelGuesser-style dispatch)."""
        import h5py
        with h5py.File(path, "r") as h5:
            model_cfg, _ = _read_configs(h5)
            if model_cfg["class_name"] == "Sequential":
                return _import_sequential(h5, **kw)
            return _import_graph(h5, **kw)
