"""Weight initialisation schemes.

Counterpart of deeplearning4j_tpu/nn/weights.py (parity surface: the
reference's WeightInit enum). Each scheme draws from an explicit
``torch.Generator``, so a seed fixes the weights. The numbers differ from
the JAX package's for the same seed (different generators); carry weights
across with ``params_from_numpy`` or a checkpoint zip instead.
"""

from __future__ import annotations

import math

import torch


def _fans(shape, fan_in=None, fan_out=None):
    """fan_in/fan_out for a weight shape. Dense: (in, out). Conv (HWIO, the
    JAX package's layout): (h, w, in, out) -> fan_in = h*w*in,
    fan_out = h*w*out."""
    if fan_in is not None and fan_out is not None:
        return float(fan_in), float(fan_out)
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    if len(shape) == 2:
        return float(shape[0]), float(shape[1])
    receptive = 1
    for s in shape[:-2]:
        receptive *= s
    return float(receptive * shape[-2]), float(receptive * shape[-1])


def init_weights(gen: torch.Generator, shape, scheme="xavier", distribution=None,
                 dtype=torch.float32, fan_in=None, fan_out=None, device=None):
    """Initialize a weight tensor.

    scheme: one of the reference's WeightInit scheme names (case-insensitive).
    distribution: (kind, *args) used when scheme == 'distribution',
        e.g. ("normal", mean, std) or ("uniform", lo, hi).
    """
    scheme = str(scheme).lower()
    shape = tuple(shape)
    fi, fo = _fans(shape, fan_in, fan_out)
    n = fi + fo
    kw = {"dtype": dtype, "device": device}

    def normal():
        return torch.randn(shape, generator=gen, **kw)

    def uniform(lo, hi):
        return torch.rand(shape, generator=gen, **kw) * (hi - lo) + lo

    if scheme == "zero":
        return torch.zeros(shape, **kw)
    if scheme == "ones":
        return torch.ones(shape, **kw)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY weight init requires a square 2d shape")
        return torch.eye(shape[0], **kw)
    if scheme == "normal":
        return normal() / math.sqrt(fi)
    if scheme == "lecun_normal":
        return normal() * math.sqrt(1.0 / fi)
    if scheme == "lecun_uniform":
        b = 3.0 / math.sqrt(fi)
        return uniform(-b, b)
    if scheme == "uniform":
        a = math.sqrt(1.0 / fi)
        return uniform(-a, a)
    if scheme == "xavier":
        return normal() * math.sqrt(2.0 / n)
    if scheme == "xavier_uniform":
        b = math.sqrt(6.0 / n)
        return uniform(-b, b)
    if scheme == "xavier_fan_in":
        return normal() / math.sqrt(fi)
    if scheme == "xavier_legacy":
        return normal() / math.sqrt(shape[-2] + shape[-1])
    if scheme == "relu":
        return normal() * math.sqrt(2.0 / fi)
    if scheme == "relu_uniform":
        b = math.sqrt(6.0 / fi)
        return uniform(-b, b)
    if scheme == "sigmoid_uniform":
        b = 4.0 * math.sqrt(6.0 / n)
        return uniform(-b, b)
    if scheme in ("var_scaling_normal_fan_in", "varscalingnormalfanin"):
        return normal() * math.sqrt(1.0 / fi)
    if scheme in ("var_scaling_normal_fan_out", "varscalingnormalfanout"):
        return normal() * math.sqrt(1.0 / fo)
    if scheme in ("var_scaling_normal_fan_avg", "varscalingnormalfanavg"):
        return normal() * math.sqrt(2.0 / n)
    if scheme in ("var_scaling_uniform_fan_in", "varscalinguniformfanin"):
        b = 3.0 / math.sqrt(fi)
        return uniform(-b, b)
    if scheme in ("var_scaling_uniform_fan_out", "varscalinguniformfanout"):
        b = 3.0 / math.sqrt(fo)
        return uniform(-b, b)
    if scheme in ("var_scaling_uniform_fan_avg", "varscalinguniformfanavg"):
        b = 3.0 / math.sqrt(n / 2.0)
        return uniform(-b, b)
    if scheme == "distribution":
        if distribution is None:
            raise ValueError("scheme='distribution' requires a distribution tuple")
        kind = str(distribution[0]).lower()
        args = tuple(distribution[1:])
        if kind in ("normal", "gaussian"):
            mean, std = (args + (0.0, 1.0))[:2] if args else (0.0, 1.0)
            return mean + std * normal()
        if kind == "uniform":
            lo, hi = args if len(args) == 2 else (-1.0, 1.0)
            return uniform(lo, hi)
        if kind == "constant":
            return torch.full(shape, float(args[0]), **kw)
        if kind == "truncated_normal":
            mean, std = (args + (0.0, 1.0))[:2] if args else (0.0, 1.0)
            t = torch.empty(shape, **kw)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            return mean + std * t
        raise ValueError(f"Unknown distribution kind '{kind}'")
    raise ValueError(f"Unknown weight init scheme '{scheme}'")
