"""Core feed-forward layers: DenseLayer and OutputLayer.

Counterpart of deeplearning4j_tpu/nn/layers/core.py (parameter keys ``W``
(n_in, n_out) and ``b``, as the reference's DefaultParamInitializer).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, register_layer,
                                                     require_dims)
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

    def apply(self, params, x):
        if x.ndim >= 4 or (x.ndim == 3 and x.shape[-1] != self.n_in):
            x = x.reshape(x.shape[0], -1)  # implicit CNN->FF flatten
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self.activation or "identity")(y)


@register_layer
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head. The loss name is kept for the configuration; the
    port serves inference only."""
    loss: str = "mcxent"
