"""Network configuration: builder and JSON serde.

Counterpart of deeplearning4j_tpu/nn/conf/configuration.py: sequential
networks here, graphs through ``graph_builder()`` (nn/conf/graph_conf.py).
The JSON is the same document, so a configuration saved by one package
reads in the other. Updaters are ``nn.updaters.Updater`` objects
(interpreted by ``fit``); the global ``dropout`` (a drop probability or an
``nn.dropout.IDropout``) and ``weight_noise`` (an
``nn.weightnoise.IWeightNoise``) are inherited by every layer that sets
none, under the JSON's ``@dropout`` / ``@noise`` tags.

Usage:
    conf = (NeuralNetConfiguration.builder()
            .seed(123)
            .updater(Adam(1e-3))
            .weight_init("xavier")
            .list()
            .layer(LSTM(n_out=256, activation="tanh"))
            .layer(RnnOutputLayer(n_out=51, activation="softmax"))
            .set_input_type(InputType.recurrent(51))
            .backprop_type("tbptt", 16, 16)
            .build())
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field as dc_field
from typing import Any, List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.dropout import IDropout
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.updaters import Sgd, Updater
from deeplearning4j_tpu_torch.nn.weightnoise import IWeightNoise


@dataclass
class GlobalConf:
    """Network-level defaults + training semantics."""
    seed: int = 12345
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    dist: Optional[tuple] = None
    bias_init: float = 0.0
    updater: Updater = dc_field(default_factory=lambda: Sgd(1e-3))
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
        wn, do = self.weight_noise, self.dropout
        d = dataclasses.asdict(dataclasses.replace(
            self, updater=None, weight_noise=None,
            dropout=0.0 if isinstance(do, IDropout) else do))
        d["updater"] = self.updater.to_dict()
        if wn is not None:
            d["weight_noise"] = wn.to_dict()
        if isinstance(do, IDropout):
            d["dropout"] = do.to_dict()
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        d["updater"] = Updater.from_dict(d["updater"])
        if d.get("dist") is not None:
            d["dist"] = tuple(d["dist"])
        if d.get("weight_noise") is not None:
            d["weight_noise"] = IWeightNoise.from_dict(d["weight_noise"])
        if isinstance(d.get("dropout"), dict):
            d["dropout"] = IDropout.from_dict(d["dropout"])
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

    def activation(self, a):
        self._g.activation = a; return self

    def weight_init(self, w, dist=None):
        self._g.weight_init = w
        if dist is not None:
            self._g.dist = tuple(dist)
        return self

    def dist(self, *d):
        """Weights drawn from ``d`` (e.g. "normal", mean, std)."""
        self._g.dist = tuple(d)
        self._g.weight_init = "distribution"
        return self

    def bias_init(self, b):
        self._g.bias_init = float(b); return self

    def updater(self, u):
        """An ``Updater``, or its JSON dict."""
        self._g.updater = u if isinstance(u, Updater) else \
            Updater.from_dict(u)
        return self

    def learning_rate(self, lr):
        """Replaces the current updater's learning rate."""
        self._g.updater = dataclasses.replace(self._g.updater,
                                              learning_rate=lr)
        return self

    def l1(self, v):
        self._g.l1 = float(v); return self

    def l2(self, v):
        self._g.l2 = float(v); return self

    def optimization_algo(self, a):
        self._g.optimization_algo = str(a).lower(); return self

    def gradient_normalization(self, kind, threshold=1.0):
        self._g.gradient_normalization = kind
        self._g.gradient_normalization_threshold = threshold
        return self

    def dtype(self, dt):
        self._g.dtype = dt; return self

    def compute_dtype(self, dt):
        self._g.compute_dtype = dt; return self

    def dropout(self, v):
        """A float drop probability or an ``IDropout`` for every layer."""
        self._g.dropout = v if isinstance(v, IDropout) else float(v)
        return self

    def weight_noise(self, wn):
        """An ``IWeightNoise`` (DropConnect / WeightNoise) for every
        layer."""
        self._g.weight_noise = wn
        return self

    def remat(self, flag=True):
        """Rematerialize the forward in the backward (util/remat.py):
        False, True, 'full', 'save_convs' or 'selective'."""
        from deeplearning4j_tpu_torch.util.remat import check_remat_mode
        self._g.remat = check_remat_mode(flag)
        return self

    def mini_batch(self, v):
        self._g.mini_batch = bool(v); return self

    def minimize(self, v=True):
        self._g.minimize = bool(v); return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self._g)

    def graph_builder(self):
        """A ``GraphBuilder`` for a ComputationGraphConfiguration with
        these network-level defaults."""
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
        return GraphBuilder(self._g)


class ListBuilder:
    """Parity: NeuralNetConfiguration.ListBuilder -> MultiLayerConfiguration."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20

    def layer(self, *args):
        """layer(l), or layer(index, l) to place it at ``index``."""
        if len(args) == 2:
            idx, l = args
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = l
        else:
            self._layers.append(args[0])
        return self

    def set_input_type(self, it: InputType):
        self._input_type = it
        return self

    def backprop_type(self, t, tbptt_fwd=20, tbptt_bwd=20):
        """'standard' or 'tbptt' (truncated BPTT in chunks of tbptt_fwd
        steps)."""
        self._backprop_type = t
        self._tbptt_fwd, self._tbptt_bwd = tbptt_fwd, tbptt_bwd
        return self

    def t_bptt_length(self, n):
        self._backprop_type = "tbptt"
        self._tbptt_fwd = self._tbptt_bwd = n
        return self

    def build(self) -> "MultiLayerConfiguration":
        conf = MultiLayerConfiguration(
            global_conf=copy.deepcopy(self._g),
            layers=[copy.deepcopy(l) for l in self._layers if l is not None],
            input_type=self._input_type, backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_bwd)
        conf.finalize()
        return conf


@dataclass
class MultiLayerConfiguration:
    """Sequential net config (parity: MultiLayerConfiguration.java)."""
    global_conf: GlobalConf = dc_field(default_factory=GlobalConf)
    layers: List[Layer] = dc_field(default_factory=list)
    input_type: Optional[InputType] = None
    backprop_type: str = "standard"     # 'standard' | 'tbptt'
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

    def output_types(self) -> List[InputType]:
        """Each layer's output type, from the input type on."""
        it = self.input_type
        outs = []
        for l in self.layers:
            it = l.output_type(it)
            outs.append(it)
        return outs

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


def __getattr__(name):
    # ``from .configuration import ComputationGraphConfiguration``, as in
    # the JAX package (graph_conf imports this module).
    if name == "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration)
        return ComputationGraphConfiguration
    raise AttributeError(name)
