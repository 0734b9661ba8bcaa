"""Dropout family: standard, alpha, gaussian-multiplicative, gaussian-add.

Counterpart of deeplearning4j_tpu/nn/dropout.py (``IDropout``, ``Dropout``,
``AlphaDropout``, ``GaussianDropout``, ``GaussianNoise``, the same
``@dropout`` JSON tag and fields). A layer's ``dropout`` field takes a
float DROP probability (keep = 1 - p, not dl4j's retain probability) or
one of these objects; the containers apply it to a layer's input
activations at train time only.

Every random number the port draws goes through the two functions of the
draw seam below, ``uniform`` and ``normal``, called in forward order with
an explicit ``torch.Generator``. A Bernoulli draw is ``uniform(...) <
keep``, which is how ``jax.random.bernoulli`` is built, so handing out the
JAX package's uniforms at the JAX keys gives its masks bit for bit. The
seam exists so that a test can do that; nothing on the main path switches
it.

``SameDraws`` hands two passes the same draws: the first pass draws from
the generator and records, the second replays the record (Bidirectional
gives both directions the same dropout draw, as the JAX layer passes both
the same key).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import torch

_DROPOUT_REGISTRY = {}


# ---- the draw seam ----------------------------------------------------------
def uniform(shape, dtype, device, gen) -> torch.Tensor:
    """Uniform [0, 1) numbers of ``shape`` from ``gen``."""
    return torch.rand(shape, dtype=dtype, device=device, generator=gen)


def normal(shape, dtype, device, gen) -> torch.Tensor:
    """Standard normal numbers of ``shape`` from ``gen``."""
    return torch.randn(shape, dtype=dtype, device=device, generator=gen)


class SameDraws:
    """A generator stand-in for two passes that must see the same draws:
    until ``replay()`` every draw comes from ``gen`` through the seam and
    is kept; after it, the kept draws are handed out again in order."""

    def __init__(self, gen):
        self.gen = gen
        self.draws: List[torch.Tensor] = []
        self.next = None

    def replay(self) -> "SameDraws":
        self.next = 0
        return self

    def draw(self, kind, shape, dtype, device) -> torch.Tensor:
        if self.next is None:
            self.draws.append(draw(kind, shape, dtype, device, self.gen))
            return self.draws[-1]
        t = self.draws[self.next]
        self.next += 1
        return t


def draw(kind: str, shape, dtype, device, gen) -> torch.Tensor:
    """One draw of ``kind`` ("uniform" or "normal") through the seam, or
    from a ``SameDraws`` record."""
    if isinstance(gen, SameDraws):
        return gen.draw(kind, shape, dtype, device)
    fn = uniform if kind == "uniform" else normal
    return fn(tuple(shape), dtype, device, gen)


def bernoulli(keep: float, shape, device, gen) -> torch.Tensor:
    """True with probability ``keep``: a float32 uniform below ``keep``."""
    return draw("uniform", shape, torch.float32, device, gen) < keep


def drop(x: torch.Tensor, p: float, gen) -> torch.Tensor:
    """Standard inverted dropout of ``x`` with drop probability ``p``."""
    keep = 1.0 - p
    m = bernoulli(keep, x.shape, x.device, gen)
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


# ---- the dropout kinds ------------------------------------------------------
def _register(cls):
    _DROPOUT_REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class IDropout:
    """Base: ``apply(x, gen)`` -> noised activations (train time only; no
    rescaling at inference)."""

    def apply(self, x, gen):
        raise NotImplementedError

    def to_dict(self):
        return {"@dropout": type(self).__name__, **dataclasses.asdict(self)}

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = _DROPOUT_REGISTRY[d.pop("@dropout")]
        return cls(**d)


@_register
@dataclass
class Dropout(IDropout):
    """Standard inverted dropout."""
    p: float = 0.5

    def apply(self, x, gen):
        return drop(x, self.p, gen)


@_register
@dataclass
class AlphaDropout(IDropout):
    """Dropout that keeps a SELU net's mean and variance: dropped units go
    to alpha' = -scale * alpha, then an affine correction."""
    p: float = 0.05

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def apply(self, x, gen):
        keep = 1.0 - self.p
        ap = -self._SCALE * self._ALPHA
        a = (keep + ap * ap * keep * (1.0 - keep)) ** -0.5
        b = -a * ap * (1.0 - keep)
        m = bernoulli(keep, x.shape, x.device, gen)
        kept = torch.where(m, x, torch.full((), ap, dtype=x.dtype,
                                            device=x.device))
        return (a * kept + b).to(x.dtype)


@_register
@dataclass
class GaussianDropout(IDropout):
    """Multiplicative noise ~ N(1, rate / (1 - rate))."""
    rate: float = 0.5

    def apply(self, x, gen):
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + std * draw("normal", x.shape, x.dtype, x.device,
                                     gen))


@_register
@dataclass
class GaussianNoise(IDropout):
    """Additive noise ~ N(0, stddev)."""
    stddev: float = 0.1

    def apply(self, x, gen):
        return x + self.stddev * draw("normal", x.shape, x.dtype, x.device,
                                      gen)


def apply_dropout(d, x: torch.Tensor, gen) -> torch.Tensor:
    """``d`` (a float drop probability, an ``IDropout`` or None) on ``x``;
    a probability of 0 or less, or None, leaves ``x`` as it is."""
    if d is None:
        return x
    if isinstance(d, IDropout):
        return d.apply(x, gen)
    if d <= 0.0:
        return x
    return drop(x, d, gen)
