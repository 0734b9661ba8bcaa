"""Network configuration: builder and JSON serde.

Counterpart of deeplearning4j_tpu/nn/conf/configuration.py for sequential
networks. The JSON is the same document, so a configuration saved by one
package reads in the other. Updaters, dropout objects and weight noise are
kept as the dicts the JSON holds; the port serves inference and does not
interpret them.

Usage:
    conf = (NeuralNetConfiguration.builder()
            .seed(123)
            .updater(updater_dict("Adam", 1e-3))
            .weight_init("xavier")
            .list()
            .layer(LSTM(n_out=256, activation="tanh"))
            .layer(RnnOutputLayer(n_out=51, activation="softmax"))
            .set_input_type(InputType.recurrent(51))
            .build())
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field as dc_field
from typing import Any, List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict

_UPDATER_DEFAULTS = {
    "Sgd": {},
    "Adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-08},
}


def updater_dict(kind: str, learning_rate: float) -> dict:
    """An updater as the JSON stores it (the JAX package's
    ``Updater.to_dict``), for the kinds the bundled models use."""
    return {"learning_rate": learning_rate, "schedule": None,
            **_UPDATER_DEFAULTS[kind], "@type": kind}


@dataclass
class GlobalConf:
    """Network-level defaults + training semantics (kept as data)."""
    seed: int = 12345
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    dist: Optional[tuple] = None
    bias_init: float = 0.0
    updater: dict = dc_field(default_factory=lambda: updater_dict("Sgd", 1e-3))
    l1: float = 0.0
    l2: float = 0.0
    dropout: Any = 0.0
    optimization_algo: str = "sgd"
    max_num_line_search_iterations: int = 5
    minimize: bool = True
    mini_batch: bool = True
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    remat: Any = False
    weight_noise: Optional[Any] = None

    def defaults_dict(self):
        return {"activation": self.activation, "weight_init": self.weight_init,
                "dist": self.dist, "bias_init": self.bias_init,
                "updater": self.updater, "l1": self.l1, "l2": self.l2,
                "dropout": self.dropout, "weight_noise": self.weight_noise}

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        d = dict(d)
        if d.get("dist") is not None:
            d["dist"] = tuple(d["dist"])
        return GlobalConf(**d)


class NeuralNetConfiguration:
    """Builder entry point (parity: NeuralNetConfiguration.builder())."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._g = GlobalConf()

    def seed(self, s):
        self._g.seed = int(s); return self

    def weight_init(self, w, dist=None):
        self._g.weight_init = w
        if dist is not None:
            self._g.dist = tuple(dist)
        return self

    def updater(self, u: dict):
        self._g.updater = dict(u); return self

    def gradient_normalization(self, kind, threshold=1.0):
        self._g.gradient_normalization = kind
        self._g.gradient_normalization_threshold = threshold
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self._g)


class ListBuilder:
    """Parity: NeuralNetConfiguration.ListBuilder -> MultiLayerConfiguration."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None

    def layer(self, l: Layer):
        self._layers.append(l)
        return self

    def set_input_type(self, it: InputType):
        self._input_type = it
        return self

    def build(self) -> "MultiLayerConfiguration":
        conf = MultiLayerConfiguration(
            global_conf=copy.deepcopy(self._g),
            layers=[copy.deepcopy(l) for l in self._layers],
            input_type=self._input_type)
        conf.finalize()
        return conf


@dataclass
class MultiLayerConfiguration:
    """Sequential net config (parity: MultiLayerConfiguration.java)."""
    global_conf: GlobalConf = dc_field(default_factory=GlobalConf)
    layers: List[Layer] = dc_field(default_factory=list)
    input_type: Optional[InputType] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    _finalized: bool = False

    def finalize(self):
        """Apply global defaults and run shape inference through the stack."""
        if self._finalized:
            return self
        defaults = self.global_conf.defaults_dict()
        it = self.input_type
        for l in self.layers:
            l.apply_defaults(defaults)
            l.validate()
            if it is not None:
                l.set_n_in(it)
                it = l.output_type(it)
        self._finalized = True
        return self

    def to_json(self) -> str:
        return json.dumps({
            "format": "deeplearning4j_tpu/MultiLayerConfiguration/v1",
            "global_conf": self.global_conf.to_dict(),
            "layers": [l.to_dict() for l in self.layers],
            "input_type": self.input_type.to_dict() if self.input_type else None,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "finalized": self._finalized,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        conf = MultiLayerConfiguration(
            global_conf=GlobalConf.from_dict(d["global_conf"]),
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            input_type=(InputType.from_dict(d["input_type"])
                        if d.get("input_type") else None),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )
        conf._finalized = d.get("finalized", False)
        if not conf._finalized:
            conf.finalize()
        return conf
