"""Activation functions.

Counterpart of deeplearning4j_tpu/nn/activations.py: an activation is a
name resolved to a function on tensors (parity surface: the reference's
nd4j Activation enum, selected per layer).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _softmax(x):
    return torch.softmax(x, dim=-1)


def _cube(x):
    return x ** 3


def _hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def _hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _rationaltanh(x):
    # 1.7159 * tanh(2x/3) approximation used by the reference's RationalTanh
    a = x * (2.0 / 3.0)
    return 1.7159 * torch.tanh(a)


def _rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "prelu": lambda x: F.leaky_relu(x, 0.01),  # alpha handled by PReLU layer when learned
    "elu": F.elu,
    "selu": torch.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": _rectifiedtanh,
    "sigmoid": torch.sigmoid,
    "hardsigmoid": _hardsigmoid,
    "hardtanh": _hardtanh,
    "softmax": _softmax,
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": _cube,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "thresholdedrelu": lambda x: torch.where(x > 1.0, x, torch.zeros_like(x)),
}


def get_activation(name):
    """Resolve an activation by name (case-insensitive) or pass a callable through."""
    if callable(name):
        return name
    key = str(name).lower().replace("_", "")
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(ACTIVATIONS)}"
        )
    return ACTIVATIONS[key]
