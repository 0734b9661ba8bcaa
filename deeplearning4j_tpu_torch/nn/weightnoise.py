"""Weight noise: DropConnect and gaussian weight noise.

Counterpart of deeplearning4j_tpu/nn/weightnoise.py (``IWeightNoise``,
``DropConnect``, ``WeightNoise``, the same ``@noise`` JSON tag and
fields). The containers apply a layer's weight noise to its parameters in
the train-time forward; the noised tensors exist only inside the step and
gradients flow through them to the stored parameters.

The traversal is the JAX package's: keys in sorted order, nested dicts
(Bidirectional's ``fwd`` / ``bwd``) recursed into, biases (keys starting
with ``b``) left alone unless ``apply_to_bias``. Where the JAX package
folds each entry's index into its key, here the draws come from one
generator in that order (through the seam of nn/dropout.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.dropout import bernoulli, draw

_NOISE_REGISTRY = {}


def _register(cls):
    _NOISE_REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class IWeightNoise:
    """Base: ``apply(params, gen)`` -> noised parameters."""
    apply_to_bias: bool = False

    def _noise_one(self, v, gen):
        raise NotImplementedError

    def apply(self, params: dict, gen) -> dict:
        out = {}
        for k, v in sorted(params.items()):
            if isinstance(v, dict):
                out[k] = self.apply(v, gen)
            elif not isinstance(v, torch.Tensor):
                out[k] = v
            elif not self.apply_to_bias and k.startswith("b"):
                out[k] = v
            else:
                out[k] = self._noise_one(v, gen)
        return out

    def to_dict(self):
        return {"@noise": type(self).__name__, **dataclasses.asdict(self)}

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = _NOISE_REGISTRY[d.pop("@noise")]
        return cls(**d)


@_register
@dataclass
class DropConnect(IWeightNoise):
    """A Bernoulli mask on the weights, kept with ``weight_retain_prob``
    and scaled up by it (the noiseless forward's expectation)."""
    weight_retain_prob: float = 0.5

    def _noise_one(self, v, gen):
        keep = bernoulli(self.weight_retain_prob, v.shape, v.device, gen)
        return torch.where(keep, v / self.weight_retain_prob,
                           torch.zeros_like(v))


@_register
@dataclass
class WeightNoise(IWeightNoise):
    """Gaussian noise n ~ N(mean, stddev) on the weights: ``w + n``
    (additive) or ``w * n``."""
    mean: float = 0.0
    stddev: float = 0.1
    additive: bool = True

    def _noise_one(self, v, gen):
        n = self.mean + self.stddev * draw("normal", v.shape, v.dtype,
                                           v.device, gen)
        return v + n if self.additive else v * n
