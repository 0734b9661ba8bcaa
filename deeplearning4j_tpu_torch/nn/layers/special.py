"""GlobalPoolingLayer.

Counterpart of the first class of deeplearning4j_tpu/nn/layers/special.py
(parity surface: the reference's GlobalPoolingLayer). The module's other
layers (AutoEncoder, VariationalAutoencoder, CenterLossOutputLayer,
Yolo2OutputLayer, FrozenLayer) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclass
class GlobalPoolingLayer(Layer):
    """Pool over time, (B, T, C) -> (B, C), or space, (B, H, W, C) -> (B,
    C): 'max', 'avg', 'sum' or 'pnorm'. A sequence's (B, T) mask drops
    its padded steps (an all-zero row: -inf under 'max', 0 otherwise)."""
    pooling_type: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True

    def has_params(self):
        return False

    def output_type(self, input_type):
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def apply(self, params, x, *, train=False, gen=None, mask=None):
        if x.ndim not in (3, 4):
            return x
        dims = (1,) if x.ndim == 3 else (1, 2)
        kind = self.pooling_type
        if mask is not None and x.ndim == 3:
            m = mask[..., None].to(x.dtype)
            if kind == "max":
                return torch.where(m > 0, x, float("-inf")).amax(dim=1)
            if kind == "sum":
                return (x * m).sum(dim=1)
            if kind == "avg":
                return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
            p = float(self.pnorm)
            return (x.abs() ** p * m).sum(dim=1) ** (1.0 / p)
        if kind == "max":
            return x.amax(dim=dims)
        if kind == "sum":
            return x.sum(dim=dims)
        if kind == "avg":
            return x.mean(dim=dims)
        p = float(self.pnorm)
        return (x.abs() ** p).sum(dim=dims) ** (1.0 / p)
