"""Core feed-forward layers: DenseLayer, OutputLayer, LossLayer and
DropoutLayer.

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
