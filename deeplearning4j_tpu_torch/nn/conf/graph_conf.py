"""Computation-graph (DAG) configuration and graph vertices.

Counterpart of deeplearning4j_tpu/nn/conf/graph_conf.py (parity surface:
the reference's ComputationGraphConfiguration and GraphBuilder). A node is
a network input, a layer, or a parameterless vertex, with a list of input
names; the topological order is computed once at build. The JSON is the
JAX package's document, so a configuration saved by one package reads in
the other. Ported vertices: ``ElementWiseVertex``; reading a configuration
that holds another raises, naming it.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.configuration import GlobalConf
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict

VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class GraphVertex:
    """Parameterless function vertex: apply(inputs: list of tensors)."""

    def apply(self, inputs: List[Any]):
        raise NotImplementedError

    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        kind = d.pop("@type")
        if kind not in VERTEX_REGISTRY:
            raise ValueError(f"graph vertex type {kind!r} is not ported yet "
                             f"(ported: {sorted(VERTEX_REGISTRY)})")
        cls = VERTEX_REGISTRY[kind]
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in fields})


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """add | subtract | product | average | max."""
    op: str = "add"

    def apply(self, inputs):
        out = inputs[0]
        if self.op == "add":
            for x in inputs[1:]:
                out = out + x
        elif self.op == "subtract":
            out = inputs[0] - inputs[1]
        elif self.op == "product":
            for x in inputs[1:]:
                out = out * x
        elif self.op == "average":
            out = sum(inputs) / len(inputs)
        elif self.op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(self.op)
        return out


@dataclass
class _Node:
    name: str
    kind: str                     # 'input' | 'layer' | 'vertex'
    layer: Optional[Layer] = None
    vertex: Optional[GraphVertex] = None
    inputs: List[str] = dc_field(default_factory=list)


@dataclass
class ComputationGraphConfiguration:
    """DAG net config (parity: ComputationGraphConfiguration.java)."""
    global_conf: GlobalConf = dc_field(default_factory=GlobalConf)
    nodes: Dict[str, _Node] = dc_field(default_factory=dict)
    network_inputs: List[str] = dc_field(default_factory=list)
    network_outputs: List[str] = dc_field(default_factory=list)
    input_types: Optional[List[InputType]] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    topological_order: List[str] = dc_field(default_factory=list)

    def topo_sort(self):
        """Kahn's algorithm, ties broken by name (the JAX package's order,
        so both packages walk the graph alike)."""
        indeg = {n: 0 for n in self.nodes}
        children: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for name, node in self.nodes.items():
            for inp in node.inputs:
                if inp not in self.nodes:
                    raise ValueError(f"Vertex '{name}' references unknown "
                                     f"input '{inp}'")
                indeg[name] += 1
                children[inp].append(name)
        queue = [n for n, d in sorted(indeg.items()) if d == 0]
        order = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(self.nodes):
            cyc = [n for n, d in indeg.items() if d > 0]
            raise ValueError(f"Graph has a cycle involving {cyc}")
        self.topological_order = order
        return order

    def finalize(self):
        """Topological order, global defaults, and shape inference along
        it."""
        defaults = self.global_conf.defaults_dict()
        self.topo_sort()
        types: Dict[str, InputType] = {}
        if self.input_types:
            types.update(zip(self.network_inputs, self.input_types))
        for name in self.topological_order:
            node = self.nodes[name]
            if node.kind == "input":
                continue
            in_types = [types.get(i) for i in node.inputs]
            if node.kind == "layer":
                node.layer.apply_defaults(defaults)
                node.layer.validate()
                if in_types and in_types[0] is not None:
                    node.layer.set_n_in(in_types[0])
                    types[name] = node.layer.output_type(in_types[0])
            elif in_types and all(t is not None for t in in_types):
                types[name] = node.vertex.output_type(in_types)
        self.node_output_types = types
        return self

    def layer_nodes(self) -> List[str]:
        """Names of the layer nodes, in topological order."""
        return [n for n in self.topological_order
                if self.nodes[n].kind == "layer"]

    # serde ----------------------------------------------------------------
    def to_json(self):
        return json.dumps({
            "format": "deeplearning4j_tpu/ComputationGraphConfiguration/v1",
            "global_conf": self.global_conf.to_dict(),
            "nodes": [{
                "name": n.name, "kind": n.kind,
                "layer": n.layer.to_dict() if n.layer else None,
                "vertex": n.vertex.to_dict() if n.vertex else None,
                "inputs": n.inputs,
            } for n in self.nodes.values()],
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "input_types": ([t.to_dict() for t in self.input_types]
                            if self.input_types else None),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }, indent=2)

    @staticmethod
    def from_json(s):
        d = json.loads(s)
        conf = ComputationGraphConfiguration(
            global_conf=GlobalConf.from_dict(d["global_conf"]),
            network_inputs=d["network_inputs"],
            network_outputs=d["network_outputs"],
            input_types=([InputType.from_dict(t) for t in d["input_types"]]
                         if d.get("input_types") else None),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )
        for nd in d["nodes"]:
            conf.nodes[nd["name"]] = _Node(
                name=nd["name"], kind=nd["kind"],
                layer=layer_from_dict(nd["layer"]) if nd.get("layer")
                else None,
                vertex=GraphVertex.from_dict(nd["vertex"])
                if nd.get("vertex") else None,
                inputs=nd.get("inputs", []))
        return conf.finalize()


class GraphBuilder:
    """Parity: ComputationGraphConfiguration.GraphBuilder."""

    def __init__(self, g: GlobalConf):
        self._conf = ComputationGraphConfiguration(
            global_conf=copy.deepcopy(g))

    def add_inputs(self, *names):
        for n in names:
            self._conf.network_inputs.append(n)
            self._conf.nodes[n] = _Node(name=n, kind="input")
        return self

    def set_input_types(self, *types):
        self._conf.input_types = list(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str):
        layer = copy.deepcopy(layer)
        layer.name = name
        self._conf.nodes[name] = _Node(name=name, kind="layer", layer=layer,
                                       inputs=list(inputs))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str):
        self._conf.nodes[name] = _Node(name=name, kind="vertex",
                                       vertex=vertex, inputs=list(inputs))
        return self

    def set_outputs(self, *names):
        self._conf.network_outputs = list(names)
        return self

    def backprop_type(self, t, tbptt_fwd=20, tbptt_bwd=20):
        self._conf.backprop_type = t
        self._conf.tbptt_fwd_length = tbptt_fwd
        self._conf.tbptt_back_length = tbptt_bwd
        return self

    def build(self) -> ComputationGraphConfiguration:
        return self._conf.finalize()
