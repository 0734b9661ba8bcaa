"""ComputationGraph -- the DAG container, for inference, serving and
training.

Counterpart of deeplearning4j_tpu/models/computation_graph.py: ``init``,
the forward along the topological order, ``output`` (bucketed),
``serving_engine``, ``init_decode_state`` / ``decode_step`` (dense and
paged KV caches), training (``fit`` on arrays, a DataSet, a MultiDataSet
or an iterator, ``fit_scan``, ``score``, ``get_score``, ``evaluate``),
``save`` and ``load``. Parameters are a dict node name -> dict of tensors
under the JAX package's keys; the updater state is a dict node name ->
dict under the JAX package's optax key paths (see nn/updaters.py), so a
checkpoint round-trips with the JAX package mid-training.

A train step is the JAX package's per-node path (``_dp_apply_updates``
with the fused flat update off): the loss (every output node's score plus
every node's l1/l2), its gradient by autograd (attention through
``ops.FlashAttention``: K5 forward, K6 and K7 backward), per-node gradient
normalization, the node's updater (``layer.updater or gc.updater``), then
its constraints. Label masks weight the loss. Not ported yet: feature
masks, dropout, weight noise, truncated BPTT over a graph (carried
recurrent state), ``backprop_external`` / ``fit_external``, listeners,
checkpointing inside ``fit``, prefetch and the fused flat update; fitting
with one of the first four raises ``NotImplementedError`` naming it. Not
ported for inference: masks, carried recurrent state, chunked prefill and
speculation.

The graph runs on CUDA unless constructed with ``device="cpu"``; without a
card and without that argument, construction raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.multi_layer_network import DTYPES
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.updaters import (make_gradient_transform,
                                                  normalize_layer_grad)
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
        self._transforms = None       # per-node updater (None: no params)
        self.iteration = 0
        self.epoch = 0
        self._epoch_batch = 0         # batches consumed in the current epoch
        self._score = float("nan")    # last fit loss (tensor until read)
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
        """One gradient transformation per layer node with parameters, from
        the layer's own updater or the graph's; fresh state for each."""
        gc = self.conf.global_conf
        self._transforms = {
            n: (make_gradient_transform(self.conf.nodes[n].layer.updater
                                        or gc.updater) if p else None)
            for n, p in self.params.items()}
        self.opt_state = {n: t.init(self.params[n]) if t is not None else {}
                          for n, t in self._transforms.items()}
        self._serving = None

    def _as_input(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x)).to(self.device)

    # ----------------------------------------------------------- forward core
    def _forward(self, params: Params, inputs, skip=()):
        """Forward along the topological order. ``inputs``: one tensor, or
        a list with one per network input; nodes named in ``skip`` are not
        run. Returns (output, activations): the network output (a list
        when there are several) and every node's activation by name."""
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
            if node.kind == "input" or name in skip:
                continue
            ins = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(ins)
            else:
                acts[name] = node.layer.apply(params.get(name, {}), ins[0])
        outs = [acts.get(n) for n in self.conf.network_outputs]
        return (outs[0] if len(outs) == 1 else outs), acts

    # -------------------------------------------------------------- training
    def _loss(self, params: Params, inputs, labels, label_masks=None):
        """Every output node's score on the forward of the nodes before it,
        plus every node's l1/l2 penalty (the output layers themselves are
        not run: their score takes their input)."""
        outs = self.conf.network_outputs
        for name in outs:
            node = self.conf.nodes[name]
            if node.kind != "layer" or not hasattr(node.layer,
                                                   "compute_score"):
                raise ValueError(f"Output '{name}' is not a loss-bearing "
                                 "layer")
        consumed = {i for n in self.conf.nodes.values() for i in n.inputs}
        _, acts = self._forward(params, inputs,
                                skip={n for n in outs if n not in consumed})
        total = 0.0
        for oi, name in enumerate(outs):
            node = self.conf.nodes[name]
            lm = None if not label_masks else label_masks[oi]
            total = total + node.layer.compute_score(
                params.get(name, {}), acts[node.inputs[0]], labels[oi], lm)
        for name, p in params.items():
            total = total + self.conf.nodes[name].layer.reg_loss(p)
        if self.conf.global_conf.compute_dtype:
            total = total.float()
        return total

    def _check_trainable(self):
        blockers = sorted({b for n in self.conf.layer_nodes()
                           for b in self.conf.nodes[n].layer
                           .training_blockers()})
        if self.conf.backprop_type == "tbptt":
            blockers.append("truncated BPTT (tbptt) over a graph")
        if blockers:
            raise NotImplementedError(
                f"training with {', '.join(blockers)} is not ported to the "
                "PyTorch package yet")
        if self.params is None:
            raise ValueError("call init() or set_params() before fitting")

    def _gradients(self, inputs, labels, label_masks=None):
        """Loss and per-node gradients at the current parameters. Returns
        (loss, grads), grads keyed like the parameters."""
        leaves = {n: {k: v.detach().requires_grad_(v.is_floating_point())
                      for k, v in p.items()} for n, p in self.params.items()}
        with torch.enable_grad():
            loss = self._loss(leaves, inputs, labels, label_masks)
            flat = [v for p in leaves.values() for v in p.values()]
            got = torch.autograd.grad(loss, flat, allow_unused=True) \
                if flat else ()
        it = iter(got)
        grads = {}
        for n, p in leaves.items():
            g = {}
            for k, v in p.items():
                gk = next(it)
                g[k] = torch.zeros_like(v) if gk is None else gk
            grads[n] = g
        return loss.detach(), grads

    def _normalize_grads(self, grads):
        gc = self.conf.global_conf
        kind = gc.gradient_normalization
        if not kind or kind == "None":
            return grads
        thr = gc.gradient_normalization_threshold
        return {n: normalize_layer_grad(g, kind, thr)
                for n, g in grads.items()}

    @torch.no_grad()
    def _apply_updates(self, grads):
        """Normalize, run each node's updater, add, apply constraints."""
        grads = self._normalize_grads(grads)
        new_params, new_opt = {}, {}
        for n, p in self.params.items():
            t = self._transforms[n]
            if t is None:
                new_params[n], new_opt[n] = p, self.opt_state[n]
                continue
            u, new_opt[n] = t.update(grads[n], self.opt_state[n], p)
            new_params[n] = self.conf.nodes[n].layer.apply_constraints(
                {k: (v + u[k]).to(v.dtype) for k, v in p.items()})
        self.params, self.opt_state = new_params, new_opt

    def _train_step(self, inputs, labels, label_masks=None):
        loss, grads = self._gradients(inputs, labels, label_masks)
        self._apply_updates(grads)
        return loss

    def _batch(self, mds: MultiDataSet):
        """A MultiDataSet's (inputs, labels, label masks or None) on the
        graph's device."""
        if mds.features_masks and any(m is not None
                                      for m in mds.features_masks):
            raise NotImplementedError(
                "training with feature masks is not ported to the PyTorch "
                "package yet")
        label_masks = None
        if mds.labels_masks and any(m is not None for m in mds.labels_masks):
            label_masks = [None if m is None else self._as_input(m)
                           for m in mds.labels_masks]
        return ([self._as_input(f) for f in mds.features],
                [self._as_input(y) for y in mds.labels], label_masks)

    @staticmethod
    def _as_multi(data, labels=None) -> MultiDataSet:
        """Arrays (one, or a list per input/output), a DataSet, a
        MultiDataSet or an (inputs, labels) tuple as a MultiDataSet."""
        if labels is not None:
            return MultiDataSet(
                features=list(data) if isinstance(data, (list, tuple))
                else [data],
                labels=list(labels) if isinstance(labels, (list, tuple))
                else [labels])
        if isinstance(data, DataSet):
            return data.to_multi()
        if isinstance(data, MultiDataSet):
            return data
        return ComputationGraph._as_multi(*data)

    def compute_gradient_and_score(self, inputs, labels):
        """Gradients of the loss at the current parameters (per-node dicts,
        before normalization) and the loss, without an update (parity:
        computeGradientAndScore)."""
        self._check_trainable()
        loss, grads = self._gradients(*self._batch(self._as_multi(inputs,
                                                                  labels)))
        return grads, float(loss)

    def fit(self, data, labels=None, epochs=1):
        """fit(inputs, labels) | fit(DataSet | MultiDataSet) |
        fit(iterator, epochs=N) (parity: ComputationGraph.fit). Inputs and
        labels are one array each or a list per network input and output.
        An iterator is reset before each epoch, as in the JAX package;
        every batch is one train step."""
        self._check_trainable()
        if labels is not None or isinstance(data, (DataSet, MultiDataSet)):
            return self._fit_batch(self._as_multi(data, labels))
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            for batch in data:
                self._fit_batch(self._as_multi(batch))
            self.epoch += 1
            self._epoch_batch = 0
        return self

    def _fit_batch(self, mds: MultiDataSet):
        self._score = self._train_step(*self._batch(mds))
        self.iteration += 1
        self._epoch_batch += 1
        return self

    def fit_scan(self, inputs_steps, labels_steps):
        """``n`` train steps over a leading step axis: one array per network
        input and output (or a list of them), shaped (n_steps, batch,
        ...). The JAX package runs them as one compiled scan; here they are
        a loop with the same math."""
        if self.conf.backprop_type == "tbptt":
            raise ValueError(
                "fit_scan runs full-sequence backprop; a graph configured "
                "for truncated BPTT must use fit() (the tbptt chunking path)")
        self._check_trainable()
        if not isinstance(inputs_steps, (list, tuple)):
            inputs_steps = [inputs_steps]
        if not isinstance(labels_steps, (list, tuple)):
            labels_steps = [labels_steps]
        xs = [self._as_input(a) for a in inputs_steps]
        ys = [self._as_input(a) for a in labels_steps]
        n = int(xs[0].shape[0])
        for k in range(n):
            self._score = self._train_step([a[k] for a in xs],
                                           [a[k] for a in ys])
        self.iteration += n
        self._epoch_batch += n
        return self

    @torch.no_grad()
    def score(self, mds=None, inputs=None, labels=None) -> float:
        """Loss on a (Multi)DataSet or on inputs and labels, l1/l2 included
        (parity: score); label masks weight it."""
        mds = self._as_multi(inputs, labels) if mds is None \
            else self._as_multi(mds)
        return float(self._loss(self.params, *self._batch(mds)))

    def get_score(self) -> float:
        """The last fit's loss (a host read of the device scalar)."""
        self._score = float(self._score)
        return self._score

    def evaluate(self, data):
        """First-output classification evaluation (parity: evaluate) over a
        DataSet, a MultiDataSet or an iterator of them, each batch through
        the bucketed ``output``; the first output's label mask, where
        given, drops rows."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        ev = Evaluation()
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        elif hasattr(data, "reset"):
            data.reset()
        for batch in data:
            mds = self._as_multi(batch)
            if mds.features_masks and any(m is not None
                                          for m in mds.features_masks):
                raise NotImplementedError(
                    "feature masks are not ported to the PyTorch package yet")
            out = self.output(*mds.features)
            if isinstance(out, list):
                out = out[0]
            lm = mds.labels_masks[0] if mds.labels_masks else None
            ev.eval(np.asarray(mds.labels[0]), out.float().cpu().numpy(),
                    None if lm is None else np.asarray(lm))
        return ev

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
