"""ComputationGraph -- the DAG container, for inference, serving and
training.

Counterpart of deeplearning4j_tpu/models/computation_graph.py: ``init``,
the forward along the topological order, ``output`` (bucketed),
``serving_engine``, ``init_decode_state`` / ``decode_step`` (dense and
paged KV caches), ``prefill_chunk``, ``tree_chunk`` / ``tree_commit``
(chunked prefill and tree speculation), ``rnn_time_step`` /
``rnn_clear_previous_state``, training (``fit`` on arrays, a DataSet, a
MultiDataSet or an iterator, ``fit_scan``, truncated BPTT, ``score``,
``get_score``, ``evaluate``, ``apply_external_updates``,
``backprop_external``, ``fit_external``), listeners, ``save`` and
``load``. ``fit`` is the JAX package's whole
contract, shared with MultiLayerNetwork (models/fitting.py): streamed
chunks through ``fit_scan``, device prefetch, listeners, ``checkpoint=``
and ``resume_from=``. Parameters are a dict node name -> dict of tensors
under the JAX package's keys; the updater state is a dict node name ->
dict under the JAX package's optax key paths (see nn/updaters.py), so a
checkpoint round-trips with the JAX package mid-training.

A train step is the JAX package's default step (``_dp_apply_updates``
with the fused flat update on): the loss (every output node's score plus
every node's l1/l2), its gradient by autograd (attention through
``ops.FlashAttention``: K5 forward, K6 and K7 backward), per-node gradient
normalization, then the fused flat update (nn/fused_update.py, in place
into flat buffers the per-node dicts view) and the nodes' constraints;
with the fused update off, each node's updater (``layer.updater or
gc.updater``), the per-node loop it is held bitwise equal to. Label masks
weight the loss. Dropout and weight noise train as in the JAX graph, from
the graph's one generator seeded before every step (see
MultiLayerNetwork's module docstring); a feature mask reaches a layer only
where its first input is a network input, as in the JAX graph, on ``fit``
and ``score``. The fit-path forward of a float32 graph runs in bfloat16
under the executor's bf16 train-precision policy (exec/executor.py), the
loss in float32; stored parameters and updater state stay float32. On the
card ``fit`` and ``fit_scan`` run the step through CUDA graphs, one per
signature, as MultiLayerNetwork does (its module docstring), and
``apply_external_updates`` the fused update alone through its own; on the
CPU the same step runs eagerly. With ``remat`` configured the
differentiated loss is rematerialized (util/remat.py).

Carried recurrent state, as in the JAX graph: ``_forward(...,
carries=)`` takes a map node name -> carry (a missing entry is zero
state), runs every layer with ``apply_with_carry`` (the LSTMs) from its
carry, and returns the updated map. Truncated BPTT trains in chunks of
``tbptt_fwd_length`` steps with the map carried across chunks, entering
each step detached; ``rnn_time_step`` keeps it between calls. On the carry
path the recurrent layers drop nothing (their weight noise still applies,
caveat R5). ``output`` and ``evaluate`` take no feature mask, as the JAX
graph's do not.

Layer state (BatchNormalization's running statistics) is ``self.state``,
a dict node name -> dict of tensors, with MultiLayerNetwork's commit
points (its module docstring): a fit step writes it in place, nothing
else does; ``backprop_external`` returns the step's new state without
writing it. A ``device_side`` pre-processor runs on the card on every
network input (models/fitting.py).

The graph runs on CUDA unless constructed with ``device="cpu"``; without a
card and without that argument, construction raises.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.exec import get_executor
from deeplearning4j_tpu_torch.exec.executor import (network_generator,
                                                    seed_generator)
from deeplearning4j_tpu_torch.models.fitting import FitContract
from deeplearning4j_tpu_torch.monitor.flight import (compute_telemetry,
                                                     snapshot,
                                                     telemetry_triples)
from deeplearning4j_tpu_torch.models.multi_layer_network import (
    DTYPES, count_params, load_state, to_device, updater_plan)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import (flatten_params,
                                                     nest_params)
from deeplearning4j_tpu_torch.nn.updaters import normalize_layer_grad
from deeplearning4j_tpu_torch.ops import resolve_device
from deeplearning4j_tpu_torch.util.remat import remat_loss

Params = Dict[str, Dict[str, torch.Tensor]]


def _cast_floats(params: Params, dtype) -> Params:
    return {n: {k: (v.to(dtype) if v.is_floating_point() else v)
                for k, v in p.items()} for n, p in params.items()}


class ComputationGraph(FitContract):
    _prog_ids = itertools.count()

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.params: Optional[Params] = None
        self.state: Optional[Params] = None
        self.opt_state: Optional[Params] = None
        self._transforms = None       # per-node updater (None: no params)
        self._fused = None            # fused update plan (nn/fused_update.py)
        self._exec = None             # execution core (lazy; exec/executor.py)
        self._steps = None            # train step's CUDA graphs, by signature
        self._updates = None          # apply_external_updates' graphs
        self._steps_rec = None        # the sampled steps' graphs (flight)
        # the programs' caller in the program registry (exec/programs.py)
        self._prog_caller = f"cg{next(ComputationGraph._prog_ids)}"
        # the card runs steps through CUDA graphs; the eager step stays
        # callable (False) as the oracle the tests and chip_smoke.py use
        self._capture_steps = self.device.type == "cuda"
        # the train step's random draws (None when no layer draws)
        self._gen = network_generator(
            [conf.nodes[n].layer for n in conf.layer_nodes()], self.device)
        self.iteration = 0
        self.epoch = 0
        self._epoch_batch = 0         # batches consumed in the current epoch
        self._score = float("nan")    # last fit loss (tensor until read)
        self.listeners: List = []
        self._last_input = None       # last fit batch's inputs (listeners)
        self._last_fit_time = None    # host seconds of the last _fit_batch
        self._rnn_carries = None      # rnn_time_step's carry map
        self._serving = None          # bucketed inference engine (lazy)
        # bumped whenever the parameters change (an update, init, a load):
        # a decode engine copies them into its own set when it moves
        self._params_version = 0

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
            n: {k: v.to(self.device) for k, v in flatten_params(
                self.conf.nodes[n].layer.init(gen, dtype)).items()}
            for n in self.conf.layer_nodes()}
        self.state = self._init_state()
        self._build_optimizer()
        self._params_version += 1
        return self

    def _init_state(self) -> Params:
        dtype = DTYPES[self.conf.global_conf.dtype]
        return {n: self.conf.nodes[n].layer.init_state(dtype, self.device)
                for n in self.conf.layer_nodes()}

    def set_params(self, params: Params, state=None):
        """Install parameters (a dict node name -> dict of tensors, copied
        onto the graph's device; nested dicts flattened to path keys) with
        a fresh updater state, and ``state`` (a dict node name -> dict)
        copied into the graph's own state tensors when given."""
        self.params = {n: {k: v.to(self.device) for k, v in
                           flatten_params(p).items()}
                       for n, p in params.items()}
        if self.state is None:
            self.state = self._init_state()
        if state is not None:
            load_state(self.state, state)
        self._build_optimizer()
        self._params_version += 1
        return self

    @property
    def _executor(self):
        """The execution core this graph's steps run through (bound at
        first use, as in the JAX package)."""
        if self._exec is None:
            self._exec = get_executor()
        return self._exec

    def _build_optimizer(self):
        """One gradient transformation per layer node with parameters, from
        the layer's own updater or the graph's, fresh state for each, and
        the fused plan over them (when enabled); drops every captured
        graph."""
        gc = self.conf.global_conf
        layers = {n: self.conf.nodes[n].layer for n in self.params}
        self._transforms, self.opt_state, self._fused = updater_plan(
            self.params, {n: None if l.frozen else l.updater or gc.updater
                          for n, l in layers.items()},
            {n: l.apply_constraints for n, l in layers.items()})
        self._build_step_graphs()
        self._serving = None

    def _as_input(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    # ----------------------------------------------------------- forward core
    def _compute_dtype(self, train):
        """The forward's compute dtype: the model's own ``compute_dtype``
        when configured, else the executor's train-precision policy on the
        fit path of float32 graphs. None means no cast."""
        gc = self.conf.global_conf
        if gc.compute_dtype:
            return DTYPES[gc.compute_dtype]
        if train:
            dt = self._executor.train_dtype
            if dt is not None and DTYPES[gc.dtype] == torch.float32:
                return dt
        return None

    def _forward(self, params: Params, inputs, train=False, masks=None,
                 gen=None, carries=None, state=None):
        """The network output (a list when there are several) and the
        updated carry map (None without ``carries``); see
        ``_activations``."""
        acts, new_carries = self._activations(params, inputs, train=train,
                                              masks=masks, gen=gen,
                                              carries=carries, state=state)
        outs = [acts.get(n) for n in self.conf.network_outputs]
        return (outs[0] if len(outs) == 1 else outs), new_carries

    def _activations(self, params: Params, inputs, skip=(), train=False,
                     masks=None, gen=None, carries=None, state=None):
        """Forward along the topological order. ``inputs``: one tensor, or
        a list with one per network input; nodes named in ``skip`` are not
        run; ``masks`` maps a network input's name to its feature mask,
        which reaches the layers whose first input it is. With ``train``
        and a generator each layer's weight noise and dropout draw from
        ``gen`` in topological order. ``carries`` (a map node name ->
        carry) runs every layer that has ``apply_with_carry`` from its
        carry (zero state where the map has none). ``state`` (by node
        name) is read by the layers with state and, under ``train``,
        written in place; None means the graph's own in inference and no
        write under ``train``. A vertex with a ``mask_input``
        (LastTimeStepVertex) reads that network input's mask. Returns
        (activations, new carries): every node's activation by name, and
        the updated carry map (None without ``carries``)."""
        if state is None and not train:
            state = self.state
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        cdt = self._compute_dtype(train)
        if cdt is not None:
            inputs = [x.to(cdt) for x in inputs]
            params = _cast_floats(params, cdt)
        new_carries = None if carries is None else dict(carries)
        acts = dict(zip(self.conf.network_inputs, inputs))
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input" or name in skip:
                continue
            ins = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                v = node.vertex
                if getattr(v, "mask_input", None) is not None:
                    acts[name] = v.apply(ins, mask=masks.get(v.mask_input)
                                         if masks else None)
                else:
                    acts[name] = v.apply(ins)
                continue
            layer = node.layer
            mask = masks.get(node.inputs[0]) if masks else None
            p = nest_params(params.get(name, {}))
            if train and gen is not None and layer.weight_noise is not None:
                p = layer.weight_noise.apply(p, gen)
            if new_carries is not None and hasattr(layer, "apply_with_carry"):
                acts[name], new_carries[name] = layer.apply_with_carry(
                    p, ins[0], new_carries.get(name), mask=mask)
            else:
                # a frozen layer reads the graph's own state where the
                # step writes none
                st = self.state if state is None and layer.frozen else state
                kw = {} if not self.state or not self.state.get(name) else {
                    "state": None if st is None else st[name]}
                acts[name] = layer.apply(p, ins[0], train=train, gen=gen,
                                         mask=mask, **kw)
        return acts, new_carries

    # -------------------------------------------------------------- training
    def _loss(self, params: Params, inputs, labels, label_masks=None,
              masks=None, gen=None, carries=None, state=None):
        """Every output node's score on the forward of the nodes before it,
        plus every node's l1/l2 penalty (the output layers themselves are
        not run: their score takes their input, after their weight noise
        and with their dropout, which draw after the forward's). Returns
        (loss, new carries)."""
        outs = self.conf.network_outputs
        for name in outs:
            node = self.conf.nodes[name]
            if node.kind != "layer" or not hasattr(node.layer,
                                                   "compute_score"):
                raise ValueError(f"Output '{name}' is not a loss-bearing "
                                 "layer")
        consumed = {i for n in self.conf.nodes.values() for i in n.inputs}
        acts, new_carries = self._activations(
            params, inputs, skip={n for n in outs if n not in consumed},
            train=True, masks=masks, gen=gen, carries=carries, state=state)
        total = 0.0
        for oi, name in enumerate(outs):
            layer = self.conf.nodes[name].layer
            lm = None if not label_masks else label_masks[oi]
            p = nest_params(params.get(name, {}))
            if gen is not None and layer.weight_noise is not None:
                p = layer.weight_noise.apply(p, gen)
            total = total + layer.compute_score(
                p, acts[self.conf.nodes[name].inputs[0]], labels[oi], lm,
                train=True, gen=gen)
        total = total + self._reg_loss(params)
        if self._compute_dtype(True) is not None:
            total = total.float()
        return total, new_carries

    def _reg_loss(self, params: Params):
        """Every node's l1/l2 penalty (0.0 when none has one)."""
        total = 0.0
        for name, p in params.items():
            total = total + self.conf.nodes[name].layer.reg_loss(p)
        return total

    def _check_trainable(self):
        if self.params is None:
            raise ValueError("call init() or set_params() before fitting")

    def _leaves(self) -> Params:
        return {n: {k: v.detach().requires_grad_(v.is_floating_point())
                    for k, v in p.items()} for n, p in self.params.items()}

    @staticmethod
    def _grads_of(outputs, leaves: Params, grad_outputs=None) -> Params:
        """d(outputs)/d(leaves) keyed like the leaves, zeros where an
        output does not depend on a leaf."""
        flat = [v for p in leaves.values() for v in p.values()]
        got = torch.autograd.grad(outputs, flat, grad_outputs,
                                  allow_unused=True) if flat else ()
        it = iter(got)
        grads = {}
        for n, p in leaves.items():
            g = {}
            for k, v in p.items():
                gk = next(it)
                g[k] = torch.zeros_like(v) if gk is None else gk
            grads[n] = g
        return grads

    def _gradients(self, inputs, labels, label_masks=None, masks=None,
                   gen=None, carries=None, state=None, scale=None):
        """Loss and per-node gradients at the current parameters, the new
        layer state written into ``state`` (None: nowhere). Returns (loss,
        grads, new carries), grads keyed like the parameters, the carries
        detached. ``scale`` (a 0-dim tensor) multiplies the loss before
        the backward (parallel/wrapper.py)."""
        leaves = self._leaves()
        loss_fn = remat_loss(self._loss, self.conf.global_conf.remat)
        with torch.enable_grad():
            loss, new_carries = loss_fn(leaves, inputs, labels, label_masks,
                                        masks, gen=gen, carries=carries,
                                        state=state)
            if scale is not None:
                loss = loss * scale
            grads = self._grads_of(loss, leaves)
        if new_carries is not None:
            new_carries = {n: tuple(t.detach() for t in c)
                           for n, c in new_carries.items()}
        return loss.detach(), grads, new_carries

    def _normalize_grads(self, grads):
        gc = self.conf.global_conf
        kind = gc.gradient_normalization
        if not kind or kind == "None":
            return grads
        thr = gc.gradient_normalization_threshold
        return {n: normalize_layer_grad(g, kind, thr)
                for n, g in grads.items()}

    @torch.no_grad()
    def _dp_apply_updates(self, grads):
        """Normalize per node, then the fused plan (in place, reading the
        staged scalars: capturable) or, with the fused update off, each
        node's updater, add, constraints (the per-node loop, eager)."""
        grads = self._normalize_grads(grads)
        if self._fused is not None:
            self._fused.apply(self.params, self.opt_state, grads)
            return
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

    def _step(self, inputs, labels, label_masks=None, masks=None,
              carries=None, telemetry=False):
        """The device half of a train step (what a graph captures): loss,
        gradients, the update, the draws from the graph's generator.
        Returns (loss, new carries), and with ``telemetry`` the flight
        recorder's (L, 5) rows from the parameters copied before the
        update, those after it and the gradients."""
        old = snapshot(self.params) if telemetry else None
        loss, grads, new_carries = self._gradients(
            inputs, labels, label_masks, masks, self._gen, carries,
            self.state)
        self._dp_apply_updates(grads)
        if not telemetry:
            return loss, new_carries
        return loss, new_carries, compute_telemetry(
            telemetry_triples(old, self.params, grads, self.conf))

    def _staged(self):
        return self.opt_state

    def _train_step(self, inputs, labels, label_masks=None, masks=None,
                    carries=None, iteration=None):
        """One train step at ``iteration`` (default: the graph's), the
        generator seeded from it first; returns (loss, new carries) (on
        the card, a replay's static outputs, which its next replay
        overwrites)."""
        it = self.iteration if iteration is None else iteration
        if self._tp_live is not None:
            mfs = None if masks is None else [
                masks.get(n) for n in self.conf.network_inputs]
            return self._tp_step(it, inputs, labels, label_masks, mfs,
                                 carries)
        seed_generator(self._gen, self.conf.global_conf.seed, it)
        return self._sampled_or_plain(it, inputs, labels, label_masks,
                                      masks, carries)

    def apply_external_updates(self, grads):
        """One updater step from externally computed gradients (per-node
        dicts keyed like the parameters): normalization, the fused update,
        constraints; on the card through its own graphs (parity:
        apply_external_updates, the JAX package's donated update
        program)."""
        if self.params is None:
            raise ValueError("call init() or set_params() before updating")
        grads = {n: {k: self._as_input(v) for k, v in g.items()}
                 for n, g in grads.items()}
        self._run(self._updates, self._dp_apply_updates, grads)
        return self

    def backprop_external(self, inputs, epsilons):
        """Parameter gradients from externally supplied dL/d(output)
        epsilons, one per network output shaped like it (parity:
        backprop_external, ComputationGraph.calcBackpropGradients with
        external epsilons), the l1/l2 penalty's gradient included as fit()
        includes it, with the dropout and weight noise of a fit step at the
        graph's iteration. Returns (grads, new_state): the layer state
        after this forward, on copies (the graph's own is not written)."""
        self._check_trainable()
        inputs = [self._as_input(x) for x in (
            inputs if isinstance(inputs, (list, tuple)) else [inputs])]
        epsilons = [self._as_input(e) for e in (
            epsilons if isinstance(epsilons, (list, tuple)) else [epsilons])]
        leaves = self._leaves()
        new_state = {n: {k: v.clone() for k, v in d.items()}
                     for n, d in self.state.items()}
        seed_generator(self._gen, self.conf.global_conf.seed, self.iteration)
        with torch.enable_grad():
            outs, _ = self._forward(leaves, inputs, train=True, gen=self._gen,
                                    state=new_state)
            outs = list(outs) if isinstance(outs, list) else [outs]
            eps = [e.to(o.dtype) for e, o in zip(epsilons, outs)]
            reg = self._reg_loss(leaves)
            if isinstance(reg, torch.Tensor):
                outs.append(reg)
                eps.append(torch.ones_like(reg))
            grads = self._grads_of(outs, leaves, eps)
        return grads, new_state

    def fit_external(self, inputs, epsilons):
        """One updater step driven by external epsilons (the training half
        of the external-epsilons contract), through
        ``apply_external_updates``."""
        grads, _ = self.backprop_external(inputs, epsilons)
        self.apply_external_updates(grads)
        self.iteration += 1
        return self

    def _batch(self, mds: MultiDataSet):
        """A MultiDataSet's (inputs, labels, label masks or None, feature
        masks by network input name or None) on the graph's device."""
        masks = None
        if mds.features_masks and any(m is not None
                                      for m in mds.features_masks):
            masks = {n: self._as_input(m) for n, m in
                     zip(self.conf.network_inputs, mds.features_masks)
                     if m is not None}
        label_masks = None
        if mds.labels_masks and any(m is not None for m in mds.labels_masks):
            label_masks = [None if m is None else self._as_input(m)
                           for m in mds.labels_masks]
        return ([self._as_input(f) for f in mds.features],
                [self._as_input(y) for y in mds.labels], label_masks, masks)

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
        computeGradientAndScore); the layer state is not written."""
        self._check_trainable()
        loss, grads, _ = self._gradients(
            *self._batch(self._as_multi(inputs, labels)))
        return grads, float(loss)

    # ---- the fit contract's hooks (models/fitting.py)
    @classmethod
    def _direct_batch(cls, data, labels):
        if labels is not None or isinstance(data, (DataSet, MultiDataSet)):
            return cls._as_multi(data, labels)
        return None

    @classmethod
    def _stream_batch(cls, item):
        mds = cls._as_multi(item)
        has_mask = any(m is not None for m in (
            *(mds.features_masks or ()), *(mds.labels_masks or ())))
        return mds, mds.features, mds.labels, has_mask

    @staticmethod
    def _chunk_payload(xs, ys):
        return xs, ys

    def _fit_batch(self, mds: MultiDataSet):
        inputs, labels, label_masks, masks = self._batch(mds)
        self._last_input = inputs
        c0, t0 = self._capture_count, time.perf_counter()
        with self._tp_scope():
            if self.conf.backprop_type == "tbptt" and inputs[0].ndim == 3:
                self._fit_tbptt(inputs, labels, label_masks, masks)
            else:
                self._score = self._train_step(inputs, labels, label_masks,
                                               masks)[0].clone()
        # a tBPTT batch records its last chunk's telemetry
        self._flight_record(self.iteration)
        self._last_fit_time = time.perf_counter() - t0
        self.iteration += 1
        self._epoch_batch += 1
        self._mon.record(seconds=self._last_fit_time, steps=1,
                         examples=int(inputs[0].shape[0]),
                         score=self._score,
                         compiled=self._capture_count - c0, path="batch")
        self._fire_listeners()
        return self

    def _fit_tbptt(self, inputs, labels, label_masks, masks):
        """Truncated BPTT over the graph (parity: the JAX graph's
        ``_fit_tbptt``): one train step per chunk of ``tbptt_fwd_length``
        steps, every 3-D input, label and (B, T) mask sliced per chunk, the
        carry map carried across chunks and entering each step detached
        (the first chunk from zero state); every chunk is a step at the
        batch's iteration (the same draws); the score is the mean of the
        chunk losses."""
        T, L = inputs[0].shape[1], self.conf.tbptt_fwd_length
        carries, losses = {}, []
        for start in range(0, T, L):
            sl = slice(start, start + L)
            ins = [x[:, sl] if x.ndim == 3 else x for x in inputs]
            lbs = [y[:, sl] if y.ndim == 3 else y for y in labels]
            mks = None if masks is None else {
                n: (m[:, sl] if m.ndim >= 2 else m) for n, m in masks.items()}
            lms = None if label_masks is None else [
                None if m is None else (m[:, sl] if m.ndim >= 2 else m)
                for m in label_masks]
            loss, carries = self._train_step(ins, lbs, lms, mks, carries)
            losses.append(loss.clone())
        self._score = torch.stack(losses).mean()

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
        c0, t0 = self._capture_count, time.perf_counter()
        with self._tp_scope():
            for k in range(n):
                loss, _ = self._train_step([a[k] for a in xs],
                                           [a[k] for a in ys],
                                           iteration=self.iteration + k)
                self._flight_record(self.iteration + k)
                if k == n - 1:
                    self._score = loss.clone()
        self._last_input = [a[-1] for a in xs]
        self.iteration += n
        self._epoch_batch += n
        self._mon.record(seconds=time.perf_counter() - t0, steps=n,
                         examples=n * int(xs[0].shape[1]),
                         score=self._score,
                         compiled=self._capture_count - c0, path="scan")
        self._fire_listeners()
        return self

    @torch.no_grad()
    def score(self, mds=None, inputs=None, labels=None) -> float:
        """Loss on a (Multi)DataSet or on inputs and labels, l1/l2 included
        (parity: score); label masks weight it and feature masks reach the
        layers as in ``fit`` (the JAX graph's ``score`` reads neither:
        caveat R3); the layer state is not written."""
        mds = self._as_multi(inputs, labels) if mds is None \
            else self._as_multi(mds)
        return float(self._loss(self.params, *self._batch(mds))[0])

    def get_score(self) -> float:
        """The last fit's loss (a host read of the device scalar)."""
        self._score = float(self._score)
        return self._score

    def evaluate(self, data):
        """First-output classification evaluation (parity: evaluate) over a
        DataSet, a MultiDataSet or an iterator of them, each batch through
        the bucketed ``output``; the first output's label mask, where
        given, drops rows, and no feature mask is read, as in the JAX
        package; a ``device_side`` pre-processor on the iterator runs on
        the card."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        ev = Evaluation()
        dev_fn, host_pp = self._resolve_device_pp(data)
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        elif hasattr(data, "reset"):
            data.reset()
        for batch in data:
            if host_pp is not None and isinstance(batch, DataSet):
                batch = host_pp.pre_process(batch)
            mds = self._as_multi(batch)
            feats = mds.features
            if dev_fn is not None:
                feats = [dev_fn(self._as_input(f)) for f in feats]
            out = self.output(*feats)
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
    def output(self, *inputs, train: bool = False, bucketed: bool = True):
        """Inference on the network inputs (parity: ComputationGraph.output).
        ``train`` is taken for the JAX package's signature and ignored, as
        there. A single-input graph's batch goes through the bucketed
        engine by default (see MultiLayerNetwork.output);
        ``bucketed=False`` runs the exact shape."""
        inputs = [self._as_input(x) for x in inputs]
        if bucketed and len(inputs) == 1:
            return self.serving_engine().predict(inputs[0])
        return self._forward(self.params, inputs)[0]

    @torch.no_grad()
    def rnn_time_step(self, *inputs):
        """Stateful streaming inference (parity: rnnTimeStep): the
        recurrent layers resume from the carry map stored on the graph and
        leave theirs in it. A 2-D input (B, F) is one time step."""
        inputs = [self._as_input(x) for x in inputs]
        inputs = [x[:, None, :] if x.ndim == 2 else x for x in inputs]
        if self._rnn_carries is None:
            self._rnn_carries = {}
        out, self._rnn_carries = self._forward(self.params, inputs,
                                               carries=self._rnn_carries)
        return out

    def rnn_clear_previous_state(self):
        """Parity: rnnClearPreviousState."""
        self._rnn_carries = None

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
        new_d = dict(dstate)

        def run(name, layer, p, inp):
            if block_tables is None:
                y, new_d[name] = layer.decode_step(p, dstate.get(name), inp,
                                                   pos)
            else:
                y, new_d[name] = layer.decode_step_paged(
                    p, dstate.get(name), inp, pos, block_tables)
            return y
        return self._walk_decode(params, x_t, run), new_d

    def _walk_decode(self, params, x, layer_fn):
        """Route ``x`` (B, T, F) along the topological order as
        ``decode_step`` does: vertices apply to the slices, each layer node
        runs ``layer_fn(name, layer, params, input)``, which returns its
        output. Returns the network output."""
        if len(self.conf.network_inputs) != 1:
            raise ValueError(
                "incremental decode supports single-input graphs; got "
                f"inputs {self.conf.network_inputs}")
        cdt = self._compute_dtype(False)
        if cdt is not None:
            x = x.to(cdt)
            params = _cast_floats(params, cdt)
        acts = {self.conf.network_inputs[0]: x}
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                continue
            ins = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(ins)
                continue
            acts[name] = layer_fn(name, node.layer, params.get(name, {}),
                                  ins[0])
        outs = [acts[n] for n in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    @torch.no_grad()
    def prefill_chunk(self, params: Params, dstate, x, start, n,
                      block_tables=None, carry_stack=False):
        """A prefill chunk along the topological order: ``x`` (B, K, F) at
        positions ``start .. start+K-1``, ``n`` (B,) valid rows (Layer.
        prefill_chunk). With ``carry_stack`` also a dict of carry snapshot
        stacks by layer node."""
        new_d, stacks = dict(dstate), {}

        def run(name, layer, p, inp):
            out = layer.prefill_chunk(p, dstate.get(name), inp, start, n,
                                      block_tables=block_tables,
                                      carry_stack=carry_stack)
            new_d[name] = out[1]
            if carry_stack:
                stacks[name] = out[2]
            return out[0]
        y = self._walk_decode(params, x, run)
        return (y, new_d, stacks) if carry_stack else (y, new_d)

    @torch.no_grad()
    def tree_chunk(self, params: Params, dstate, x, pos0, tree, n,
                   block_tables=None):
        """Score a speculation token tree along the topological order:
        ``x`` (B, N, F) in ``tree`` order (Layer.tree_chunk). Returns
        ``(y, stacks, kv_windows)`` by layer node; ``dstate`` is not
        advanced."""
        stacks, wins = {}, {}

        def run(name, layer, p, inp):
            y, _, stacks[name], wins[name] = layer.tree_chunk(
                p, dstate.get(name), inp, pos0, tree, n,
                block_tables=block_tables)
            return y
        return self._walk_decode(params, x, run), stacks, wins

    @torch.no_grad()
    def tree_commit(self, dstate, kv_windows, path, pos0, commit_n,
                    block_tables=None):
        """Write the accepted root-path's KV (Layer.tree_commit); nodes
        without a KV window pass through."""
        new_d = dict(dstate)
        for name, win in kv_windows.items():
            if win is not None:
                new_d[name] = self.conf.nodes[name].layer.tree_commit(
                    None, dstate.get(name), win, path, pos0, commit_n,
                    block_tables=block_tables)
        return new_d

    # ------------------------------------------------------------- utilities
    def num_params(self) -> int:
        return count_params(self.params)

    def summary(self) -> str:
        """The JAX package's table: vertex, type, inputs, parameters."""
        lines = ["=" * 78,
                 f"{'Vertex':<28}{'Type':<26}{'Inputs':<14}{'Params':>10}",
                 "=" * 78]
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                lines.append(f"{name:<28}{'(input)':<26}{'':<14}{0:>10}")
                continue
            tname = type(node.layer if node.kind == "layer"
                         else node.vertex).__name__
            n = (count_params([self.params[name]])
                 if self.params and name in self.params else 0)
            ins = ",".join(node.inputs)[:13]
            lines.append(f"{name:<28}{tname:<26}{ins:<14}{n:>10,}")
        lines.append("=" * 78)
        lines.append(f"Total params: {self.num_params():,}")
        return "\n".join(lines)

    def save(self, path, save_updater=True, normalizer=None):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(self, path, save_updater, normalizer)

    @staticmethod
    def load(path, load_updater=True, *, device=None) -> "ComputationGraph":
        from deeplearning4j_tpu_torch.util.model_serializer import \
            restore_computation_graph
        return restore_computation_graph(path, load_updater, device=device)
