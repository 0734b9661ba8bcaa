"""Layer base protocol, registry and JSON serde.

Counterpart of deeplearning4j_tpu/nn/layers/base.py, inference only. A
layer is a dataclass holding its configuration; its parameters are a plain
dict of tensors under the JAX package's keys (``W``, ``RW``, ``b``), so a
checkpoint's arrays load into either package. Updaters, dropout and weight
noise are kept as the JSON data they arrive as (training is not ported).

Protocol:
- ``set_n_in(input_type)`` -- infer input width.
- ``output_type(input_type)`` -- shape inference.
- ``init(gen, dtype, device)`` -- parameter dict ({} if parameterless).
- ``apply(params, x)`` -- the forward.
- ``init_decode_state`` / ``decode_step`` -- one token at a time.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


# fields every layer may inherit from the global configuration
INHERITABLE = ("activation", "weight_init", "updater", "l1", "l2", "dropout",
               "bias_init", "dist", "weight_noise")


@dataclass
class Layer:
    """Base layer config. ``None`` hyperparameters inherit the network-level
    defaults at build time."""
    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[tuple] = None            # for weight_init='distribution'
    bias_init: Optional[float] = None
    updater: Optional[dict] = None           # kept as data
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[Any] = None            # kept as data
    weight_noise: Optional[Any] = None       # kept as data
    constraints: Optional[tuple] = None

    # ---- config protocol -------------------------------------------------
    def apply_defaults(self, defaults: Dict[str, Any]):
        for f in INHERITABLE:
            if hasattr(self, f) and getattr(self, f) is None and f in defaults:
                setattr(self, f, defaults[f])

    def validate(self) -> None:
        """Fail fast on an unknown activation name at build time."""
        from deeplearning4j_tpu_torch.nn.activations import get_activation
        if getattr(self, "activation", None) is not None:
            get_activation(self.activation)

    def set_n_in(self, input_type: InputType) -> None:
        pass

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    # ---- runtime protocol ------------------------------------------------
    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, params, x):
        raise NotImplementedError

    def has_params(self) -> bool:
        return True

    # ---- incremental decode protocol --------------------------------------
    def init_decode_state(self, params, batch: int, dtype=torch.float32,
                          device=None):
        """Per-slot decode state for ``batch`` streams (None = stateless)."""
        return None

    def decode_step(self, params, dstate, x):
        """One token step on ``x`` (B, 1, F); returns (y, new_dstate)."""
        return self.apply(params, x), dstate

    # ---- serde -----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Layer):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            d[f.name] = v
        d["@type"] = type(self).__name__
        return d

    @classmethod
    def _from_dict_fields(cls, d):
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            if isinstance(v, dict) and "@type" in v and k != "updater":
                v = layer_from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)


def layer_from_dict(d: Dict[str, Any]) -> Layer:
    kind = d["@type"]
    if kind not in LAYER_REGISTRY:
        raise ValueError(f"layer type {kind!r} is not ported yet "
                         f"(ported: {sorted(LAYER_REGISTRY)})")
    return LAYER_REGISTRY[kind]._from_dict_fields(d)


def require_dims(layer, **dims):
    """Validate that inferred/declared dims are set before init."""
    for k, v in dims.items():
        if not v or v <= 0:
            raise ValueError(
                f"{type(layer).__name__}: {k}={v} is not set. Provide "
                f"set_input_type(...) on the ListBuilder or set {k} "
                f"explicitly on the layer.")
