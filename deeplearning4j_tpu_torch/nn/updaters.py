"""Updaters (optimizer update rules), learning-rate schedules and gradient
normalization.

Counterpart of deeplearning4j_tpu/nn/updaters.py. The JAX package lowers
each updater to an optax ``GradientTransformation``; this module writes the
same optax formulas (optax 0.2: ``scale_by_adam``, ``trace``,
``scale_by_rss``, ``scale_by_rms``, ``scale_by_adadelta``,
``scale_by_adamax``, ``scale_by_amsgrad``, ``scale_by_learning_rate``,
``clip``, ``clip_by_global_norm``, ``add_decayed_weights``) as plain tensor
code. ``torch.optim`` is not used: its Nesterov, RMSProp and AdaGrad differ
from optax (where eps goes, AdaGrad's initial accumulator).

A transformation's state is a flat dict of tensors keyed by the path the
JAX package's checkpoint gives the optax state (``_flatten_pytree``): the
index in the optax chain, then the state field, then the parameter name,
e.g. ``0/.mu/W`` or ``1/.count``. Counts are int32 scalars on the host; the
moments live beside their parameters. So ``updaterState.npz`` reads and
writes under the same keys in both packages.

An update has a host half and a device half, so that a CUDA graph can
replay the device half. ``scalars(state)`` computes, on the host from the
counts, the float32 numbers an update reads that change with the count
(bias corrections, a schedule's rate); ``apply(g, state, params, sc)`` is
the device half, elementwise tensor code that reads those numbers from
``sc``, 0-dim float32 tensors on the parameters' device, and returns the
updates and the new parameter-shaped state slots; ``advance(state)`` adds
one to every count on the host. ``update`` runs all three.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
_F32 = np.float32


# ---------------------------------------------------------------- schedules

@dataclass(frozen=True)
class Schedule:
    """Learning-rate schedule. kind: constant|exponential|inverse|poly|sigmoid|
    step|map. Iteration-indexed (the optax schedule count), like the
    reference's LearningRatePolicy."""
    kind: str = "constant"
    initial: float = 1e-3
    decay_rate: float = 0.99
    power: float = 1.0
    steps: float = 1000.0
    gamma: float = 0.99
    max_iter: float = 10000.0
    values: Optional[Dict[int, float]] = None  # for 'map'

    def lr(self, it: int) -> float:
        """The rate at count ``it``, in float32 as the JAX schedule computes
        it from an int32 count."""
        k, x, a = self.kind, _F32(it), _F32(self.initial)
        with np.errstate(over="ignore"):
            if k == "constant":
                return float(a)
            if k == "exponential":
                return float(a * np.power(_F32(self.decay_rate), x))
            if k == "inverse":
                return float(a / np.power(_F32(1.0) + _F32(self.gamma) * x,
                                          _F32(self.power)))
            if k == "poly":
                frac = np.clip(x / _F32(self.max_iter), _F32(0), _F32(1))
                return float(a * np.power(_F32(1.0) - frac,
                                          _F32(self.power)))
            if k == "sigmoid":
                return float(a / (_F32(1.0) + np.exp(
                    -_F32(self.gamma) * (x - _F32(self.steps)))))
            if k == "step":
                return float(a * np.power(_F32(self.decay_rate),
                                          np.floor_divide(x, _F32(self.steps))))
            if k == "map":
                lr = a
                for b, v in sorted((self.values or {}).items()):
                    lr = _F32(v) if it >= b else lr
                return float(lr)
        raise ValueError(f"Unknown schedule kind {k}")

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        d = dict(d)
        if d.get("values") is not None:
            d["values"] = {int(k): v for k, v in d["values"].items()}
        return Schedule(**d)


# ----------------------------------------------------------- transformations

def _bias_correction(decay: float, count: int) -> float:
    """optax ``bias_correction``'s divisor ``1 - decay**count``, float32."""
    return float(_F32(1.0) - np.power(_F32(decay), _F32(count)))


def _int32(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


class Transform:
    """One optax transformation: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``, state keyed by
    ``.field`` or ``.field/param``; ``update`` is ``scalars`` (host),
    ``apply`` (device) and ``advance`` (host) in turn."""

    n_scalars = 0                  # count-derived scalars ``apply`` reads

    def init(self, params: Tensors) -> Tensors:
        return {}

    def scalars(self, state: Tensors) -> List[float]:
        """The ``n_scalars`` numbers of the next update, float32 values
        computed on the host from the counts in ``state``."""
        return []

    def advance(self, state: Tensors) -> Tensors:
        """``state`` after an update: every count one more (host only)."""
        return state

    def apply(self, g: Tensors, state: Tensors, params: Tensors,
              sc: List[torch.Tensor]) -> Tuple[Tensors, Tensors]:
        """The device half: (updates, new parameter-shaped state slots),
        reading the count-derived scalars from ``sc``."""
        raise NotImplementedError

    def update(self, g: Tensors, state: Tensors, params: Tensors
               ) -> Tuple[Tensors, Tensors]:
        dev = next(iter({**params, **g}.values())).device \
            if (g or params) else torch.device("cpu")
        sc = [torch.tensor(v, dtype=torch.float32, device=dev)
              for v in self.scalars(state)]
        u, slots = self.apply(g, state, params, sc)
        return u, self.advance({**state, **slots})


def _moments(names, params, fill=0.0):
    return {f"{n}/{k}": torch.full_like(v, fill) for n in names
            for k, v in params.items()}


def _sub(state, i):
    pre = f"{i}/"
    return {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}


class Chain(Transform):
    """optax.chain: stage i keeps its state under ``i/``."""

    def __init__(self, stages: List[Transform]):
        self.stages = stages

    @property
    def n_scalars(self):
        return sum(s.n_scalars for s in self.stages)

    def init(self, params):
        return {f"{i}/{k}": v for i, s in enumerate(self.stages)
                for k, v in s.init(params).items()}

    def scalars(self, state):
        return [v for i, s in enumerate(self.stages)
                for v in s.scalars(_sub(state, i))]

    def advance(self, state):
        return {f"{i}/{k}": v for i, s in enumerate(self.stages)
                for k, v in s.advance(_sub(state, i)).items()}

    def apply(self, g, state, params, sc):
        new, j = {}, 0
        for i, s in enumerate(self.stages):
            g, slots = s.apply(g, _sub(state, i), params,
                               sc[j:j + s.n_scalars])
            j += s.n_scalars
            new.update({f"{i}/{k}": v for k, v in slots.items()})
        return g, new


class Identity(Transform):
    """A stage that changes nothing; it holds the chain index of optax's
    stateless stages, so the stateful ones keep optax's key paths."""

    def apply(self, g, state, params, sc):
        return g, {}


class _Counted(Transform):
    """A stage with a ``.count`` in its state."""

    def advance(self, state):
        return {**state, ".count": _int32(int(state[".count"]) + 1)}


class ScaleByLearningRate(_Counted):
    """Multiply by -lr: a constant, or a schedule read at the stage's own
    count (``scale_by_schedule``)."""

    def __init__(self, lr: float, schedule: Optional[Schedule] = None):
        self.lr, self.schedule = lr, schedule
        self.n_scalars = 0 if schedule is None else 1

    def init(self, params):
        return {".count": _int32(0)} if self.schedule is not None else {}

    def scalars(self, state):
        if self.schedule is None:
            return []
        return [-self.schedule.lr(int(state[".count"]))]

    def advance(self, state):
        return state if self.schedule is None else super().advance(state)

    def apply(self, g, state, params, sc):
        if self.schedule is None:
            return {k: -self.lr * v for k, v in g.items()}, {}
        return {k: sc[0] * v for k, v in g.items()}, {}


class Trace(Transform):
    """``trace``: t = g + decay * t; Nesterov returns g + decay * t."""

    def __init__(self, decay: float, nesterov: bool):
        self.decay, self.nesterov = decay, nesterov

    def init(self, params):
        return _moments([".trace"], params)

    def apply(self, g, state, params, sc):
        d = self.decay
        t = {k: v + d * state[f".trace/{k}"] for k, v in g.items()}
        out = {k: v + d * t[k] for k, v in g.items()} if self.nesterov else t
        return out, {f".trace/{k}": v for k, v in t.items()}


class ScaleByAdam(_Counted):
    """``scale_by_adam`` (``nesterov`` for NAdam): bias-corrected moments,
    m / (sqrt(v) + eps). Scalars: the bias corrections of b1 and b2 at the
    new count n (and of b1 at n + 1 for NAdam)."""

    def __init__(self, b1, b2, eps, nesterov=False):
        self.b1, self.b2, self.eps, self.nesterov = b1, b2, eps, nesterov
        self.n_scalars = 3 if nesterov else 2

    def init(self, params):
        return {".count": _int32(0), **_moments([".mu", ".nu"], params)}

    def scalars(self, state):
        n = int(state[".count"]) + 1
        out = [_bias_correction(self.b1, n), _bias_correction(self.b2, n)]
        if self.nesterov:
            out.append(_bias_correction(self.b1, n + 1))
        return out

    def apply(self, g, state, params, sc):
        b1, b2 = self.b1, self.b2
        new, out = {}, {}
        for k, v in g.items():
            mu = (1 - b1) * v + b1 * state[f".mu/{k}"]
            nu = (1 - b2) * (v * v) + b2 * state[f".nu/{k}"]
            if self.nesterov:
                mu_hat = b1 * (mu / sc[2]) + (1 - b1) * (v / sc[0])
            else:
                mu_hat = mu / sc[0]
            nu_hat = nu / sc[1]
            out[k] = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            new[f".mu/{k}"], new[f".nu/{k}"] = mu, nu
        return out, new


class ScaleByAdamax(_Counted):
    """``scale_by_adamax``: m_hat / max(|g| + eps, b2 * u). Scalar: the
    bias correction of b1 at the new count."""

    n_scalars = 1

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {".count": _int32(0), **_moments([".mu", ".nu"], params)}

    def scalars(self, state):
        return [_bias_correction(self.b1, int(state[".count"]) + 1)]

    def apply(self, g, state, params, sc):
        b1, b2 = self.b1, self.b2
        new, out = {}, {}
        for k, v in g.items():
            mu = (1 - b1) * v + b1 * state[f".mu/{k}"]
            nu = torch.maximum(v.abs() + self.eps, b2 * state[f".nu/{k}"])
            out[k] = (mu / sc[0]) / nu
            new[f".mu/{k}"], new[f".nu/{k}"] = mu, nu
        return out, new


class ScaleByAmsgrad(_Counted):
    """``scale_by_amsgrad``: m_hat / (sqrt(max over time of v_hat) + eps).
    Scalars: the bias corrections of b1 and b2 at the new count."""

    n_scalars = 2

    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {".count": _int32(0),
                **_moments([".mu", ".nu", ".nu_max"], params)}

    def scalars(self, state):
        n = int(state[".count"]) + 1
        return [_bias_correction(self.b1, n), _bias_correction(self.b2, n)]

    def apply(self, g, state, params, sc):
        b1, b2 = self.b1, self.b2
        new, out = {}, {}
        for k, v in g.items():
            mu = (1 - b1) * v + b1 * state[f".mu/{k}"]
            nu = (1 - b2) * (v * v) + b2 * state[f".nu/{k}"]
            nu_max = torch.maximum(state[f".nu_max/{k}"], nu / sc[1])
            out[k] = (mu / sc[0]) / (torch.sqrt(nu_max) + self.eps)
            new[f".mu/{k}"], new[f".nu/{k}"] = mu, nu
            new[f".nu_max/{k}"] = nu_max
        return out, new


class ScaleByRss(Transform):
    """``scale_by_rss`` (AdaGrad): accumulators start at 0.1, and eps goes
    inside the root: g / sqrt(sum g^2 + eps)."""

    def __init__(self, initial: float, eps: float):
        self.initial, self.eps = initial, eps

    def init(self, params):
        return _moments([".sum_of_squares"], params, self.initial)

    def apply(self, g, state, params, sc):
        out, new = {}, {}
        for k, v in g.items():
            s = v * v + state[f".sum_of_squares/{k}"]
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                              torch.zeros_like(s))
            out[k], new[f".sum_of_squares/{k}"] = inv * v, s
        return out, new


class ScaleByRms(Transform):
    """``scale_by_rms`` (RMSProp): g / sqrt(v + eps), no bias correction."""

    def __init__(self, decay: float, eps: float):
        self.decay, self.eps = decay, eps

    def init(self, params):
        return _moments([".nu"], params)

    def apply(self, g, state, params, sc):
        d, out, new = self.decay, {}, {}
        for k, v in g.items():
            nu = (1 - d) * (v * v) + d * state[f".nu/{k}"]
            out[k], new[f".nu/{k}"] = torch.rsqrt(nu + self.eps) * v, nu
        return out, new


class ScaleByAdadelta(Transform):
    """``scale_by_adadelta``: sqrt(E[dx^2] + eps) / sqrt(E[g^2] + eps) * g."""

    def __init__(self, rho: float, eps: float):
        self.rho, self.eps = rho, eps

    def init(self, params):
        return _moments([".e_g", ".e_x"], params)

    def apply(self, g, state, params, sc):
        rho, eps, out, new = self.rho, self.eps, {}, {}
        for k, v in g.items():
            e_g = (1 - rho) * (v * v) + rho * state[f".e_g/{k}"]
            u = torch.sqrt(state[f".e_x/{k}"] + eps) / torch.sqrt(e_g + eps) * v
            new[f".e_g/{k}"] = e_g
            new[f".e_x/{k}"] = (1 - rho) * (u * u) + rho * state[f".e_x/{k}"]
            out[k] = u
        return out, new


class AddDecayedWeights(Transform):
    """``add_decayed_weights``: g + wd * p."""

    def __init__(self, wd: float):
        self.wd = wd

    def apply(self, g, state, params, sc):
        return {k: v + self.wd * params[k] for k, v in g.items()}, {}


class Clip(Transform):
    """``clip``: every element into [-d, d]."""

    def __init__(self, d: float):
        self.d = d

    def apply(self, g, state, params, sc):
        return {k: torch.clamp(v, -self.d, self.d) for k, v in g.items()}, {}


class ClipByGlobalNorm(Transform):
    """``clip_by_global_norm``: rescale to max_norm when the norm over all
    leaves is not below it. It reduces across leaves, so a chain holding
    it never runs over a concatenation (``reduces_across_leaves``)."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def apply(self, g, state, params, sc):
        if not g:
            return g, {}
        norm = torch.sqrt(sum((v * v).sum() for v in g.values()))
        keep = norm < self.max_norm
        return {k: torch.where(keep, v, (v / norm) * self.max_norm)
                for k, v in g.items()}, {}


def reduces_across_leaves(t: Transform) -> bool:
    """Whether ``t`` has a stage that reduces across parameters
    (``ClipByGlobalNorm``): its update is then not elementwise and must not
    run over a concatenation of several parameters."""
    if isinstance(t, ClipByGlobalNorm):
        return True
    return isinstance(t, Chain) and any(reduces_across_leaves(s)
                                        for s in t.stages)


# ---------------------------------------------------------------- updaters

@dataclass(frozen=True)
class Updater:
    """Base updater config; ``transform()`` builds the optax chain it
    stands for."""
    learning_rate: float = 1e-3
    schedule: Optional[Schedule] = None

    def transform(self) -> Transform:
        raise NotImplementedError

    def _lr(self) -> ScaleByLearningRate:
        s = self.schedule
        if s is not None and s.kind == "constant":
            # a constant schedule is a plain rate: no count in the state
            return ScaleByLearningRate(s.initial)
        return ScaleByLearningRate(self.learning_rate, s)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        if self.schedule is not None:
            d["schedule"] = self.schedule.to_dict()
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = UPDATERS[d.pop("@type")]
        if d.get("schedule") is not None:
            d["schedule"] = Schedule.from_dict(d["schedule"])
        return cls(**d)


@dataclass(frozen=True)
class Sgd(Updater):
    def transform(self):
        return Chain([Identity(), self._lr()])


@dataclass(frozen=True)
class Nesterovs(Updater):
    learning_rate: float = 0.1
    momentum: float = 0.9

    def transform(self):
        return Chain([Trace(self.momentum, nesterov=True), self._lr()])


@dataclass(frozen=True)
class Adam(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return Chain([ScaleByAdam(self.beta1, self.beta2, self.epsilon),
                      self._lr()])


@dataclass(frozen=True)
class AdaMax(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return Chain([ScaleByAdamax(self.beta1, self.beta2, self.epsilon),
                      self._lr()])


@dataclass(frozen=True)
class NAdam(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return Chain([ScaleByAdam(self.beta1, self.beta2, self.epsilon,
                                  nesterov=True), self._lr()])


@dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: float = 0.1
    epsilon: float = 1e-6

    def transform(self):
        return Chain([ScaleByRss(0.1, self.epsilon), self._lr()])


@dataclass(frozen=True)
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def transform(self):
        # the reference's AdaDelta has no learning rate (lr = 1); optax
        # chains a zero weight decay first
        return Chain([Identity(), ScaleByAdadelta(self.rho, self.epsilon),
                      ScaleByLearningRate(1.0)])


@dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: float = 0.1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def transform(self):
        return Chain([ScaleByRms(self.rms_decay, self.epsilon), self._lr(),
                      Identity()])


@dataclass(frozen=True)
class AmsGrad(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def transform(self):
        return Chain([ScaleByAmsgrad(self.beta1, self.beta2, self.epsilon),
                      self._lr()])


@dataclass(frozen=True)
class NoOp(Updater):
    """Updater NONE: the raw gradient is applied unmodified (params -= grad),
    matching the reference's NoOp pass-through semantics."""

    def transform(self):
        return Chain([Identity(), ScaleByLearningRate(1.0)])


UPDATERS = {c.__name__: c for c in
            [Sgd, Nesterovs, Adam, AdaMax, NAdam, AdaGrad, AdaDelta, RmsProp,
             AmsGrad, NoOp]}


def make_gradient_transform(updater: Updater,
                            grad_norm_threshold: Optional[float] = None,
                            grad_clip_value: Optional[float] = None,
                            l2: float = 0.0) -> Transform:
    """Compose weight decay / clipping / updater in the reference's order
    (BaseOptimizer.updateGradientAccordingToParams: L2 added to the
    gradient, then clipping, then the updater)."""
    chain: List[Transform] = []
    if l2 and l2 > 0:
        chain.append(AddDecayedWeights(l2))
    if grad_clip_value:
        chain.append(Clip(grad_clip_value))
    if grad_norm_threshold:
        chain.append(ClipByGlobalNorm(grad_norm_threshold))
    chain.append(updater.transform())
    return Chain(chain) if len(chain) > 1 else chain[0]


def normalize_layer_grad(g: Tensors, kind: Optional[str], thr: float
                         ) -> Tensors:
    """Gradient normalization for ONE layer's gradients (parity:
    GradientNormalization, applied per layer). Unknown kinds pass the
    gradient through, as in the JAX package."""
    if not g or not kind or kind == "None":
        return g
    if kind == "ClipElementWiseAbsoluteValue":
        return {k: torch.clamp(v, -thr, thr) for k, v in g.items()}
    if kind in ("ClipL2PerLayer", "RenormalizeL2PerLayer"):
        norm = torch.sqrt(sum((v ** 2).sum() for v in g.values()))
        return {k: v * _norm_scale(kind, norm, thr) for k, v in g.items()}
    if kind in ("ClipL2PerParamType", "RenormalizeL2PerParamType"):
        return {k: v * _norm_scale(kind, torch.sqrt((v ** 2).sum()), thr)
                for k, v in g.items()}
    return g


def _norm_scale(kind, norm, thr):
    floor = torch.clamp(norm, min=1e-12)
    if kind.startswith("Clip"):
        return torch.clamp(thr / floor, max=1.0)
    return 1.0 / floor
