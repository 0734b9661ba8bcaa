"""ComputationGraph -- the DAG container, for inference and serving.

Counterpart of deeplearning4j_tpu/models/computation_graph.py: ``init``,
the forward along the topological order, ``output`` (bucketed),
``serving_engine``, ``init_decode_state`` / ``decode_step`` (dense and
paged KV caches), ``save`` and ``load``. Parameters are a dict node name ->
dict of tensors under the JAX package's keys; an updater state per layer
node (the JAX package's optax key paths, see nn/updaters.py) is kept so a
checkpoint round-trips. Not ported yet: training (``fit`` and the
backward of the attention kernel come with the training slice), masks,
carried recurrent state, chunked prefill and speculation.

The graph runs on CUDA unless constructed with ``device="cpu"``; without a
card and without that argument, construction raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.multi_layer_network import DTYPES
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.updaters import make_gradient_transform
from deeplearning4j_tpu_torch.ops import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


def _cast_floats(params: Params, dtype) -> Params:
    return {n: {k: (v.to(dtype) if v.is_floating_point() else v)
                for k, v in p.items()} for n, p in params.items()}


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.params: Optional[Params] = None
        self.opt_state: Optional[Params] = None
        self.iteration = 0
        self.epoch = 0
        self._epoch_batch = 0
        self._serving = None          # bucketed inference engine (lazy)

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None):
        """Initialize every layer node's parameters, in topological order,
        from ``seed`` (default: the configuration's) on a CPU
        ``torch.Generator``, so a seed gives the same weights on every
        device."""
        gc = self.conf.global_conf
        gen = torch.Generator().manual_seed(gc.seed if seed is None else seed)
        dtype = DTYPES[gc.dtype]
        self.params = {
            n: {k: v.to(self.device) for k, v in
                self.conf.nodes[n].layer.init(gen, dtype).items()}
            for n in self.conf.layer_nodes()}
        self._build_optimizer()
        return self

    def set_params(self, params: Params):
        """Install parameters (a dict node name -> dict of tensors, copied
        onto the graph's device) with a fresh updater state."""
        self.params = {n: {k: v.to(self.device) for k, v in p.items()}
                       for n, p in params.items()}
        self._build_optimizer()
        return self

    def _build_optimizer(self):
        gc = self.conf.global_conf
        self.opt_state = {}
        for n, p in self.params.items():
            l = self.conf.nodes[n].layer
            self.opt_state[n] = (make_gradient_transform(l.updater
                                                         or gc.updater)
                                 .init(p) if p else {})
        self._serving = None

    def _as_input(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x)).to(self.device)

    # ----------------------------------------------------------- forward core
    def _forward(self, params: Params, inputs):
        """Forward along the topological order. ``inputs``: one tensor, or
        a list with one per network input. Returns (output, activations):
        the network output (a list when there are several) and every
        node's activation by name."""
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        gc = self.conf.global_conf
        if gc.compute_dtype:
            cdt = DTYPES[gc.compute_dtype]
            inputs = [x.to(cdt) for x in inputs]
            params = _cast_floats(params, cdt)
        acts = dict(zip(self.conf.network_inputs, inputs))
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                continue
            ins = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(ins)
            else:
                acts[name] = node.layer.apply(params.get(name, {}), ins[0])
        outs = [acts[n] for n in self.conf.network_outputs]
        return (outs[0] if len(outs) == 1 else outs), acts

    # ------------------------------------------------------------- inference
    def serving_engine(self, **kw):
        """The shape-bucketed inference engine for this graph (lazy; keyword
        args are honored on first construction only)."""
        if self._serving is None:
            from deeplearning4j_tpu_torch.serving.engine import \
                InferenceEngine
            self._serving = InferenceEngine(self, **kw)
        return self._serving

    @torch.no_grad()
    def output(self, *inputs, bucketed: bool = True):
        """Inference on the network inputs (parity: ComputationGraph.output).
        A single-input graph's batch goes through the bucketed engine by
        default (see MultiLayerNetwork.output); ``bucketed=False`` runs the
        exact shape."""
        inputs = [self._as_input(x) for x in inputs]
        if bucketed and len(inputs) == 1:
            return self.serving_engine().predict(inputs[0])
        return self._forward(self.params, inputs)[0]

    # --------------------------------------------------- incremental decode
    def init_decode_state(self, batch: int, max_len: int = 256, kv=None):
        """Decode state keyed by layer-node name for ``batch`` streams:
        attention nodes hold a KV cache of ``max_len`` positions, or with
        ``kv`` ({"num_blocks", "block_size"}) their share of the block
        pool."""
        gc = self.conf.global_conf
        dt = DTYPES[gc.compute_dtype or gc.dtype]
        out = {}
        for name in self.conf.layer_nodes():
            layer, p = self.conf.nodes[name].layer, self.params.get(name, {})
            if kv is not None:
                out[name] = layer.init_paged_decode_state(
                    p, batch, max_len, kv["num_blocks"], kv["block_size"],
                    dt, self.device)
            else:
                out[name] = layer.init_decode_state(p, batch, max_len, dt,
                                                    self.device)
        return out

    @torch.no_grad()
    def decode_step(self, params: Params, dstate, x_t, pos,
                    block_tables=None):
        """One-token step along the topological order for single-input
        graphs: ``x_t`` (B, 1, F) at positions ``pos`` (B,); vertices such
        as residual adds apply to the (B, 1, F) slices unchanged.
        ``block_tables`` (B, max_blocks) routes attention nodes through the
        paged KV cache. Returns (y, new_dstate)."""
        if len(self.conf.network_inputs) != 1:
            raise ValueError(
                "incremental decode supports single-input graphs; got "
                f"inputs {self.conf.network_inputs}")
        gc = self.conf.global_conf
        if gc.compute_dtype:
            cdt = DTYPES[gc.compute_dtype]
            x_t = x_t.to(cdt)
            params = _cast_floats(params, cdt)
        acts = {self.conf.network_inputs[0]: x_t}
        new_d = dict(dstate)
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                continue
            ins = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(ins)
                continue
            p = params.get(name, {})
            if block_tables is None:
                y, new_d[name] = node.layer.decode_step(
                    p, dstate.get(name), ins[0], pos)
            else:
                y, new_d[name] = node.layer.decode_step_paged(
                    p, dstate.get(name), ins[0], pos, block_tables)
            acts[name] = y
        outs = [acts[n] for n in self.conf.network_outputs]
        return (outs[0] if len(outs) == 1 else outs), new_d

    # ------------------------------------------------------------- utilities
    def save(self, path, save_updater=True):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(self, path, save_updater)

    @staticmethod
    def load(path, device=None, load_updater=True) -> "ComputationGraph":
        from deeplearning4j_tpu_torch.util.model_serializer import \
            restore_computation_graph
        return restore_computation_graph(path, device=device,
                                         load_updater=load_updater)
