"""Core feed-forward layers: DenseLayer, OutputLayer, LossLayer,
DropoutLayer, ActivationLayer, FlattenLayer, ReshapeLayer, EmbeddingLayer,
EmbeddingSequenceLayer, PReLULayer and ElementWiseMultiplicationLayer.

Counterpart of deeplearning4j_tpu/nn/layers/core.py (parameter keys ``W``
(n_in, n_out) and ``b``, as the reference's DefaultParamInitializer). The
output layers' ``compute_score`` is the loss ``fit`` differentiates. A
layer's dropout acts on its input at train time (``maybe_dropout``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, register_layer,
                                                     require_dims)
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.nn.weights import init_weights


@register_layer
@dataclass
class DenseLayer(Layer):
    """Fully connected layer: y = act(x @ W + b); on (B, T, C) input the
    product runs per timestep as one (B*T, C) GEMM."""
    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.flat_size() if input_type.kind != "rnn" \
                else input_type.size

    def output_type(self, input_type):
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out, input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)

    def init(self, gen, dtype=torch.float32, device=None):
        require_dims(self, n_in=self.n_in, n_out=self.n_out)
        p = {"W": init_weights(gen, (self.n_in, self.n_out),
                               self.weight_init or "xavier", self.dist, dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        if x.ndim >= 4 or (x.ndim == 3 and x.shape[-1] != self.n_in):
            x = x.reshape(x.shape[0], -1)  # implicit CNN->FF flatten
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self.activation or "identity")(y)


@register_layer
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head (parity: nn/conf/layers/OutputLayer.java). The
    container calls ``compute_score`` with labels during training."""
    loss: str = "mcxent"

    def compute_score(self, params, x, labels, mask=None, *, train=False,
                      gen=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        if x.ndim >= 4 or (x.ndim == 3 and x.shape[-1] != self.n_in):
            x = x.reshape(x.shape[0], -1)
        w = params["W"]
        # a lower-precision activation meets the stored weights in the wider
        # type, as jnp promotion does
        x = x.to(torch.promote_types(x.dtype, w.dtype))
        pre = x @ w
        if self.has_bias:
            pre = pre + params["b"]
        if pre.ndim == 3:  # (B, T, C) time-distributed loss
            B, T, C = pre.shape
            pre = pre.reshape(B * T, C)
            labels = labels.reshape(B * T, -1)
            if mask is not None:
                mask = mask.reshape(B * T)
        return get_loss(self.loss)(labels, pre, self.activation or "softmax",
                                   mask)


@register_layer
@dataclass
class LossLayer(Layer):
    """Loss-only head, no params (parity: nn/conf/layers/LossLayer.java)."""
    loss: str = "mcxent"

    def has_params(self):
        return False

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return get_activation(self.activation or "identity")(x)

    def compute_score(self, params, x, labels, mask=None, *, train=False,
                      gen=None):
        return get_loss(self.loss)(labels, x, self.activation or "identity",
                                   mask)


@register_layer
@dataclass
class DropoutLayer(Layer):
    """The layer's dropout alone (parity: nn/conf/layers/DropoutLayer)."""

    def has_params(self):
        return False

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return self.maybe_dropout(x, train=train, gen=gen)


@register_layer
@dataclass
class ActivationLayer(Layer):
    """The activation alone (relu unless one is set)."""

    def has_params(self):
        return False

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return get_activation(self.activation or "relu")(x)


@register_layer
@dataclass
class FlattenLayer(Layer):
    """Every non-batch axis flattened to (B, N); over a sequence input the
    flat width is size x T, so T must be static."""

    def has_params(self):
        return False

    def output_type(self, input_type):
        if input_type.kind == "rnn":
            t = input_type.timeseries_length
            if t is None or t <= 0:
                raise ValueError(
                    "FlattenLayer over a sequence input needs a static "
                    "timeseries length (flat width = size * T)")
            return InputType.feed_forward(input_type.size * t)
        return InputType.feed_forward(input_type.flat_size())

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return x.reshape(x.shape[0], -1)


@register_layer
@dataclass
class ReshapeLayer(Layer):
    """Activations reshaped to ``target_shape`` (batch axis excluded): rank
    1 is feed-forward, 2 recurrent (T, C), 3 convolutional (H, W, C); one
    ``-1`` is resolved from the input's flat size."""
    target_shape: tuple = ()

    def __post_init__(self):
        self.target_shape = tuple(int(d) for d in self.target_shape)
        if sum(1 for d in self.target_shape if d == -1) > 1:
            raise ValueError(
                f"Reshape target {self.target_shape} has more than one -1")

    def has_params(self):
        return False

    def _resolved(self, flat: int) -> tuple:
        s = self.target_shape
        if -1 not in s:
            return s
        known = 1
        for d in s:
            if d != -1:
                known *= d
        if known <= 0 or flat % known != 0:
            raise ValueError(
                f"Cannot infer -1 in reshape target {s} from flat size {flat}")
        return tuple(flat // known if d == -1 else d for d in s)

    def output_type(self, input_type):
        s = self.target_shape
        if -1 in s:
            flat = (input_type.size * input_type.timeseries_length
                    if input_type.kind == "rnn"
                    and input_type.timeseries_length > 0
                    else input_type.flat_size())
            s = self._resolved(flat)
        if len(s) == 1:
            return InputType.feed_forward(s[0])
        if len(s) == 2:
            return InputType.recurrent(s[1], s[0])
        if len(s) == 3:
            return InputType.convolutional(s[0], s[1], s[2])
        raise ValueError(f"Unsupported reshape target {s}")

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return x.reshape((x.shape[0],) + self.target_shape)


@register_layer
@dataclass
class EmbeddingLayer(Layer):
    """Index -> vector lookup over (B,) or (B, 1) indices (a gather)."""
    n_in: int = 0   # vocab size
    n_out: int = 0
    has_bias: bool = True

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, dtype=torch.float32, device=None):
        p = {"W": init_weights(gen, (self.n_in, self.n_out),
                               self.weight_init or "xavier", self.dist, dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init or 0.0),
                                dtype=dtype, device=device)
        return p

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        idx = x.long()   # a float input truncates, as astype(int32)
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self.activation or "identity")(y)


@register_layer
@dataclass
class EmbeddingSequenceLayer(Layer):
    """A sequence of indices to a sequence of vectors: (B, T) -> (B, T,
    E)."""
    n_in: int = 0
    n_out: int = 0
    has_bias: bool = False

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.size or input_type.flat_size()

    def output_type(self, input_type):
        t = input_type.timeseries_length if input_type.kind == "rnn" else -1
        return InputType.recurrent(self.n_out, t)

    def init(self, gen, dtype=torch.float32, device=None):
        p = {"W": init_weights(gen, (self.n_in, self.n_out),
                               self.weight_init or "xavier", self.dist, dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        idx = x.long()   # a float input truncates, as astype(int32)
        if idx.ndim == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self.activation or "identity")(y)


@register_layer
@dataclass
class PReLULayer(Layer):
    """Leaky ReLU with a learned slope per feature (``alpha``)."""
    n_in: int = 0

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.flat_size()

    def init(self, gen, dtype=torch.float32, device=None):
        return {"alpha": torch.zeros((self.n_in,), dtype=dtype,
                                     device=device)}

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        a = params["alpha"].reshape([1] * (x.ndim - 1) + [-1])
        return torch.where(x >= 0, x, a * x)


@register_layer
@dataclass
class ElementWiseMultiplicationLayer(Layer):
    """y = act(x * W + b), a learned scale and shift per feature."""
    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, input_type):
        if self.n_in == 0:
            self.n_in = input_type.flat_size()
        self.n_out = self.n_in

    def output_type(self, input_type):
        return InputType.feed_forward(self.n_out or self.n_in)

    def init(self, gen, dtype=torch.float32, device=None):
        return {"W": torch.ones((self.n_in,), dtype=dtype, device=device),
                "b": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        return get_activation(self.activation or "identity")(
            x * params["W"] + params["b"])
