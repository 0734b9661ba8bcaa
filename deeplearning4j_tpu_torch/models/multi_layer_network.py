"""MultiLayerNetwork -- the sequential container.

Counterpart of deeplearning4j_tpu/models/multi_layer_network.py: ``init``,
the forward with stacked-LSTM pair fusion, ``output``, ``rnn_time_step`` /
``rnn_clear_previous_state``, ``init_decode_state`` / ``decode_step``,
``prefill_chunk``, ``tree_chunk`` / ``tree_commit``, training (``fit``
on arrays, a DataSet or an iterator, ``fit_scan``, truncated BPTT,
``compute_gradient_and_score``, ``score``, ``evaluate``,
``evaluate_regression``), greedy layerwise ``pretrain``, listeners,
``save`` and ``load``. ``fit`` is the JAX package's whole contract
(models/fitting.py): an iterator streams in chunks through
``fit_scan``, staged on the device ahead of the step (``prefetch``),
listeners fire once a batch or chunk, ``checkpoint=`` saves crash-safely
and ``resume_from=`` continues the same run. Parameters are a list of
per-layer dicts of tensors on the network's device, under the JAX
package's keys (a wrapper's nested parameters flattened to path keys,
``fwd/W``; see nn/layers/base.py); the updater state is a list of
per-layer dicts under the JAX package's optax key paths (see
nn/updaters.py); a frozen layer (nn/layers/special.py) has no updater and
no updater state.

Dropout, weight noise and feature masks train as in the JAX package: the
train-time forward applies each layer's weight noise to its parameters
(the output layer's in the loss) and its dropout to its input, drawing
from the network's one ``torch.Generator``, which the host seeds before
every step from ``(seed, iteration)`` (``exec.executor.seed_generator``,
the counterpart of ``fold_in(PRNGKey(seed), it)``); the chunks of a
truncated-BPTT batch share it, as in JAX. A feature mask reaches every
layer until the activations lose their time axis, on ``fit`` (arrays
excepted), truncated BPTT (sliced per chunk), ``score`` and
``output(x, mask=)``; ``evaluate`` reads none, as in the JAX package, and
``fit_scan`` takes none.

A train step is the JAX package's default step: the loss (output layer's
score plus l1/l2), its gradient by autograd (through the LSTM kernels'
``autograd.Function``s), per-layer gradient normalization, then the fused
flat update (nn/fused_update.py: one update per group of layers sharing
an updater and a dtype, in place into flat buffers that the per-layer
dicts view) and the layers' constraints. With the fused update switched
off (``set_fused_update(False)`` before the optimizer is built) each
layer runs its own updater (``l.updater or gc.updater``), the per-layer
loop the fused update is held bitwise equal to. The forward of a float32
network casts its parameters and inputs to bfloat16 under the executor's
bf16 train-precision policy (exec/executor.py), the loss returning to
float32; stored parameters and updater state stay float32.

Layer state (BatchNormalization's running statistics) is ``self.state``,
a list of per-layer dicts of tensors (``{}`` for a stateless layer),
float32 under the bf16 policy too. The commit points are the JAX
package's: a fit step (``fit``, ``fit_scan``, each truncated-BPTT chunk)
writes the new statistics into those tensors in place, inside the step
(and so inside its CUDA graph, which reads them by address);
``output``, ``score``, ``compute_gradient_and_score``, ``feed_forward``
and ``evaluate`` write nothing, under ``train=True`` too. Whatever loads
state (``set_params``, ``restore_into``, a resume, ``init_pretrained``)
copies into those tensors. A ``device_side`` pre-processor on the
iterator (data/normalizers.py) runs on the card after the copy: a uint8
image batch crosses the link at a byte a pixel (models/fitting.py).

On the card every fit path (``fit`` on arrays, a DataSet or an iterator,
``fit_scan``, truncated BPTT) runs the step through CUDA graphs, one per
signature (input shapes and dtypes, a label mask or not, carries or not),
the counterpart of the JAX package's jitted, donated train step: the
first step of a signature runs eagerly as the warm-up, the second is
captured, and from then on each step copies its batch into the graph's
static inputs, stages the count-derived updater scalars in one copy, and
replays; a graph's draws follow the seed the host set before the replay.
``apply_external_updates`` runs the fused update alone through its own
graphs. On the CPU the same step runs eagerly. With ``remat`` configured
the differentiated loss is rematerialized (util/remat.py): the forward
runs again in the backward, with the forward's draws.

The network runs on CUDA unless constructed with ``device="cpu"``; without
a card and without that argument, construction raises.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, host_tensor
from deeplearning4j_tpu_torch.exec import get_executor
from deeplearning4j_tpu_torch.exec.executor import (network_generator,
                                                    seed_generator)
from deeplearning4j_tpu_torch.models.fitting import FitContract
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.fused_update import (build_fused_update,
                                                      fused_update_enabled)
from deeplearning4j_tpu_torch.nn.layers.base import (flatten_params,
                                                     nest_params)
from deeplearning4j_tpu_torch.nn.layers.rnn import (apply_lstm_pair,
                                                    lstm_pair_fusable)
from deeplearning4j_tpu_torch.nn.updaters import (make_gradient_transform,
                                                  normalize_layer_grad,
                                                  reduces_across_leaves)
from deeplearning4j_tpu_torch.ops import resolve_device
from deeplearning4j_tpu_torch.util.remat import remat_loss

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def params_from_numpy(arrays, device=None):
    """Per-layer dicts of numpy arrays (e.g. the JAX package's params read
    back with ``np.asarray``) -> the port's parameters on ``device``: a
    list of them for a MultiLayerNetwork, a dict keyed by node name for a
    ComputationGraph."""
    dev = resolve_device(device)

    def conv(p: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.array(v)).to(dev)
                for k, v in flatten_params(p).items()}
    if isinstance(arrays, dict):
        return {n: conv(p) for n, p in arrays.items()}
    return [conv(p) for p in arrays]


def _cast_floats(params, dtype):
    return [{k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in p.items()} for p in params]


def to_device(x, device) -> torch.Tensor:
    """An array or tensor on ``device``; numpy data goes to a card through
    pinned memory without a host synchronization."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = host_tensor(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def load_state(dst, src):
    """Copy layer state ``src`` (per-layer dicts of tensors or arrays, in
    a list or by node name) into the tensors of ``dst`` in place: the
    state a captured step reads by address is never rebound."""
    items = dst.items() if isinstance(dst, dict) else enumerate(dst)
    with torch.no_grad():
        for i, d in items:
            for k, t in d.items():
                v = src[i][k]
                t.copy_(v if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.array(v)))


def count_params(tree) -> int:
    """Elements of every tensor in per-layer dicts (a list or by name)."""
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(int(v.numel()) for p in items for v in p.values())


def updater_plan(params, updaters, constraints):
    """A container's optimizer: (transforms, opt_state, fused plan or None)
    over ``params`` (a dict member -> dict of tensors) from each member's
    updater (``updaters[k]``; None for a frozen member, which, like a
    member without parameters, gets no transform and no state: the JAX
    package's ``optax.set_to_zero()``). The fused plan, when the switch is
    on, rebinds the members' dicts to views of its flat buffers; a chain
    that reduces across parameters keeps per-member math (group key
    None)."""
    transforms, group_keys = {}, {}
    for k, p in params.items():
        if not p or updaters[k] is None:
            transforms[k] = None
            continue
        transforms[k] = t = make_gradient_transform(updaters[k])
        group_keys[k] = None if reduces_across_leaves(t) else json.dumps(
            updaters[k].to_dict(), sort_keys=True)
    opt_state = {k: t.init(params[k]) if t is not None else {}
                 for k, t in transforms.items()}
    fused = None
    if fused_update_enabled():
        fused = build_fused_update(params, opt_state, transforms, group_keys,
                                   constraints)
    return transforms, opt_state, fused


class MultiLayerNetwork(FitContract):
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        conf.finalize()
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.params: Optional[List[Dict[str, torch.Tensor]]] = None
        self.state: Optional[List[Dict[str, torch.Tensor]]] = None
        self.opt_state: Optional[List[Dict[str, torch.Tensor]]] = None
        self._transforms = None       # per-layer updater (None: no params)
        self._fused = None            # fused update plan (nn/fused_update.py)
        self._exec = None             # execution core (lazy; exec/executor.py)
        self._steps = None            # train step's CUDA graphs, by signature
        self._updates = None          # apply_external_updates' graphs
        # the card runs steps through CUDA graphs; the eager step stays
        # callable (False) as the oracle the tests and chip_smoke.py use
        self._capture_steps = self.device.type == "cuda"
        # the train step's random draws (None when no layer has dropout
        # or weight noise)
        self._gen = network_generator(self.layers, self.device)
        self.iteration = 0
        self.epoch = 0
        self._epoch_batch = 0         # batches consumed in the current epoch
        self._score = float("nan")    # last fit loss (tensor until read)
        self.listeners: List = []
        self._last_input = None       # last fit batch (for listeners)
        self._last_fit_time = None    # host seconds of the last _fit_batch
        self._rnn_carries = None      # stored state for rnn_time_step
        self._serving = None          # bucketed inference engine (lazy)
        # bumped whenever the parameters change (an update, init, a load):
        # a decode engine copies them into its own set when it moves
        self._params_version = 0

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None):
        """Initialize parameters from ``seed`` (default: the configuration's)
        on a CPU ``torch.Generator``, so a seed gives the same weights on
        every device."""
        gc = self.conf.global_conf
        gen = torch.Generator().manual_seed(gc.seed if seed is None else seed)
        dtype = DTYPES[gc.dtype]
        self.params = [{k: v.to(self.device) for k, v in
                        flatten_params(l.init(gen, dtype)).items()}
                       for l in self.layers]
        self.state = [l.init_state(dtype, self.device) for l in self.layers]
        self._build_optimizer()
        self._params_version += 1
        return self

    def set_params(self, params: List[Dict[str, torch.Tensor]], state=None):
        """Install parameters (copied onto the network's device; nested
        dicts flattened to path keys) with a fresh updater state, and
        ``state`` (per-layer dicts) copied into the network's own state
        tensors when given."""
        self.params = [{k: v.to(self.device) for k, v in
                        flatten_params(p).items()} for p in params]
        if self.state is None:
            dtype = DTYPES[self.conf.global_conf.dtype]
            self.state = [l.init_state(dtype, self.device)
                          for l in self.layers]
        if state is not None:
            load_state(self.state, state)
        self._build_optimizer()
        self._params_version += 1
        return self

    @property
    def _executor(self):
        """The execution core this network's steps run through (bound at
        first use, as in the JAX package)."""
        if self._exec is None:
            self._exec = get_executor()
        return self._exec

    def _build_optimizer(self):
        """One gradient transformation per layer with parameters, from the
        layer's own updater or the network's, fresh state for each, and the
        fused plan over them (when enabled); drops every captured graph, as
        the JAX package drops its compiled steps."""
        gc = self.conf.global_conf
        n = len(self.layers)
        transforms, opt_state, self._fused = updater_plan(
            dict(enumerate(self.params)),
            {i: None if l.frozen else l.updater or gc.updater
             for i, l in enumerate(self.layers)},
            {i: l.apply_constraints for i, l in enumerate(self.layers)})
        self._transforms = [transforms[i] for i in range(n)]
        self.opt_state = [opt_state[i] for i in range(n)]
        self._steps = self._executor.steps(self._step, generator=self._gen)
        self._updates = self._executor.steps(self._dp_apply_updates)
        self._serving = None

    @property
    def _capture_count(self) -> int:
        """CUDA graphs captured since the optimizer was built (the JAX
        package's ``_compile_count``)."""
        return self._steps.captures + self._updates.captures

    def _as_input(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    # ----------------------------------------------------------- forward core
    def _compute_dtype(self, train):
        """The forward's compute dtype: the model's own ``compute_dtype``
        when configured, else the executor's train-precision policy on the
        fit path of float32 models. None means no cast."""
        gc = self.conf.global_conf
        if gc.compute_dtype:
            return DTYPES[gc.compute_dtype]
        if train:
            dt = self._executor.train_dtype
            if dt is not None and DTYPES[gc.dtype] == torch.float32:
                return dt
        return None

    def _forward(self, params, x, carries=None, upto=None, train=False,
                 mask=None, gen=None, state=None):
        """Forward through layers [0, upto). Returns (act, new_carries).
        Consecutive stacked LSTMs fuse into ONE wavefront kernel; the
        stateful-carry path (rnn_time_step, truncated BPTT) stays per
        layer. With ``train`` and a generator each layer's weight noise
        and dropout draw from ``gen`` in forward order; ``mask`` (B, T)
        reaches every layer until the activations are 2-D. ``state`` is
        the per-layer state the layers with state read and, under
        ``train``, write in place; None means the network's own in
        inference and no write under ``train``."""
        if state is None and not train:
            state = self.state
        cdt = self._compute_dtype(train)
        if cdt is not None:
            x = x.to(cdt)
            params = _cast_floats(params, cdt)
        n = len(self.layers) if upto is None else upto
        new_carries = list(carries) if carries is not None else None
        i = 0
        while i < n:
            l = self.layers[i]
            if (new_carries is None and i + 1 < n and x.ndim == 3
                    and lstm_pair_fusable(l, self.layers[i + 1], params[i],
                                          params[i + 1], x, mask)):
                x = apply_lstm_pair(l, self.layers[i + 1], params[i],
                                    params[i + 1], x, train=train, gen=gen)
                i += 2
                continue
            p = nest_params(params[i])
            if train and gen is not None and l.weight_noise is not None:
                p = l.weight_noise.apply(p, gen)
            if new_carries is not None and hasattr(l, "apply_with_carry"):
                x, new_carries[i] = l.apply_with_carry(p, x, new_carries[i],
                                                       mask=mask)
            else:
                x = l.apply(p, x, train=train, gen=gen, mask=mask,
                            **self._state_kw(state, i))
            if x.ndim == 2:
                mask = None    # the sequence collapsed to one row each
            i += 1
        return x, new_carries

    def _state_kw(self, state, i):
        """``apply``'s state argument for layer ``i``: only a layer that
        keeps state takes one; a frozen layer, which writes none, reads
        the network's own where ``state`` is None."""
        if not self.state or not self.state[i]:
            return {}
        if state is None and self.layers[i].frozen:
            state = self.state
        return {"state": None if state is None else state[i]}

    # -------------------------------------------------------------- training
    def _loss(self, params, x, y, mask_l=None, carries=None, mask_f=None,
              gen=None, state=None):
        """Output layer's score on the forward of the other layers, plus
        every layer's l1/l2 penalty; the layers write their new state into
        ``state`` (None: nowhere). Returns (loss, new_carries)."""
        out_layer = self.layers[-1]
        if not hasattr(out_layer, "compute_score"):
            raise ValueError(
                f"Last layer {type(out_layer).__name__} has no loss; use an "
                "OutputLayer/LossLayer variant")
        act, new_carries = self._forward(params, x, carries,
                                         upto=len(self.layers) - 1,
                                         train=True, mask=mask_f, gen=gen,
                                         state=state)
        p_out = nest_params(params[-1])
        if gen is not None and out_layer.weight_noise is not None:
            p_out = out_layer.weight_noise.apply(p_out, gen)
        loss = out_layer.compute_score(p_out, act, y, mask_l, train=True,
                                       gen=gen)
        for l, p in zip(self.layers, params):
            loss = loss + l.reg_loss(p)
        if self._compute_dtype(True) is not None:
            loss = loss.float()
        return loss, new_carries

    def _check_trainable(self):
        if self.params is None:
            raise ValueError("call init() or set_params() before fitting")

    def _gradients(self, x, y, mask_l=None, carries=None, mask_f=None,
                   gen=None, state=None):
        """Loss and per-layer gradients at the current parameters, the new
        layer state written into ``state`` (None: nowhere). Returns (loss,
        grads, new_carries), carries detached."""
        leaves = [{k: v.detach().requires_grad_(v.is_floating_point())
                   for k, v in p.items()} for p in self.params]
        loss_fn = remat_loss(self._loss, self.conf.global_conf.remat)
        with torch.enable_grad():
            loss, new_carries = loss_fn(leaves, x, y, mask_l, carries,
                                        mask_f, gen=gen, state=state)
            flat = [v for p in leaves for v in p.values()]
            got = torch.autograd.grad(loss, flat, allow_unused=True) \
                if flat else ()
        it = iter(got)
        grads = []
        for p in leaves:
            g = {}
            for k, v in p.items():
                gk = next(it)
                g[k] = torch.zeros_like(v) if gk is None else gk
            grads.append(g)
        if new_carries is not None:
            new_carries = [None if c is None else tuple(t.detach() for t in c)
                           for c in new_carries]
        return loss.detach(), grads, new_carries

    def _normalize_grads(self, grads):
        gc = self.conf.global_conf
        kind = gc.gradient_normalization
        if not kind or kind == "None":
            return grads
        thr = gc.gradient_normalization_threshold
        return [normalize_layer_grad(g, kind, thr) for g in grads]

    @torch.no_grad()
    def _dp_apply_updates(self, grads):
        """Normalize per layer, then the fused plan (in place, reading the
        staged scalars: capturable) or, with the fused update off, each
        layer's updater, add, constraints (the per-layer loop, eager)."""
        grads = self._normalize_grads(grads)
        if self._fused is not None:
            self._fused.apply(dict(enumerate(self.params)),
                              dict(enumerate(self.opt_state)),
                              dict(enumerate(grads)))
            return
        new_params, new_opt = [], []
        for l, t, p, o, g in zip(self.layers, self._transforms, self.params,
                                 self.opt_state, grads):
            if t is None:
                new_params.append(p)
                new_opt.append(o)
                continue
            u, o = t.update(g, o, p)
            new_params.append(l.apply_constraints(
                {k: (v + u[k]).to(v.dtype) for k, v in p.items()}))
            new_opt.append(o)
        self.params, self.opt_state = new_params, new_opt

    def _step(self, x, y, mask_l=None, carries=None, mask_f=None):
        """The device half of a train step (what a graph captures): loss,
        gradients, the update, the draws from the network's generator.
        Returns (loss, new_carries)."""
        loss, grads, new_carries = self._gradients(x, y, mask_l, carries,
                                                   mask_f, self._gen,
                                                   self.state)
        self._dp_apply_updates(grads)
        return loss, new_carries

    def _run(self, graphs, fn, *args):
        """``fn(*args)`` with the fused update's scalars staged before and
        its counts advanced after: through ``graphs`` on the card, eagerly
        on the CPU, with the fused update off, or for the eager oracle."""
        self._params_version += 1
        if self._fused is None:
            return fn(*args)
        opt = dict(enumerate(self.opt_state))
        self._fused.stage(opt)
        out = graphs(*args) if self._capture_steps else fn(*args)
        self._fused.advance(opt)
        return out

    def _train_step(self, x, y, mask_l=None, carries=None, mask_f=None,
                    iteration=None):
        """One train step at ``iteration`` (default: the network's), the
        generator seeded from it first; returns (loss, new_carries). On
        the card the loss and carries of a replay are the graph's static
        outputs, which its next replay overwrites."""
        seed_generator(self._gen, self.conf.global_conf.seed,
                       self.iteration if iteration is None else iteration)
        return self._run(self._steps, self._step, x, y, mask_l, carries,
                         mask_f)

    def apply_external_updates(self, grads):
        """One updater step from externally computed gradients (per-layer
        dicts keyed like the parameters): normalization, the fused update,
        constraints; on the card through its own graphs (parity:
        apply_external_updates, the JAX package's donated update
        program)."""
        if self.params is None:
            raise ValueError("call init() or set_params() before updating")
        grads = [{k: self._as_input(v) for k, v in g.items()} for g in grads]
        self._run(self._updates, self._dp_apply_updates, grads)
        return self

    def compute_gradient_and_score(self, x, y, labels_mask=None):
        """Gradients of the loss at the current parameters (per-layer
        dicts, before normalization) and the loss, without an update
        (parity: computeGradientAndScore): no dropout, no weight noise, the
        layer state untouched."""
        self._check_trainable()
        loss, grads, _ = self._gradients(
            self._as_input(x), self._as_input(y),
            None if labels_mask is None else self._as_input(labels_mask))
        return grads, float(loss)

    # ---- the fit contract's hooks (models/fitting.py)
    @staticmethod
    def _direct_batch(data, labels):
        if labels is not None:
            return DataSet(data, labels)
        return data if isinstance(data, DataSet) else None

    @staticmethod
    def _stream_batch(item):
        ds = item if isinstance(item, DataSet) else DataSet(*item)
        return (ds, [ds.features], [ds.labels],
                ds.features_mask is not None or ds.labels_mask is not None)

    @staticmethod
    def _chunk_payload(xs, ys):
        return xs[0], ys[0]

    def fit_scan(self, xs, ys):
        """``xs.shape[0]`` train steps over a leading step axis: xs (n_steps,
        batch, ...), ys (n_steps, batch, ...). The JAX package runs them as
        one compiled scan; here they are a loop with the same math."""
        if self.conf.backprop_type == "tbptt":
            raise ValueError(
                "fit_scan runs full-sequence backprop; a net configured for "
                "truncated BPTT must use fit() (the tbptt chunking path)")
        self._check_trainable()
        xs, ys = self._as_input(xs), self._as_input(ys)
        for k in range(xs.shape[0]):
            loss, _ = self._train_step(xs[k], ys[k],
                                       iteration=self.iteration + k)
            if k == xs.shape[0] - 1:
                self._score = loss.clone()
        self._last_input = xs[-1]
        self.iteration += int(xs.shape[0])
        self._epoch_batch += int(xs.shape[0])
        self._fire_listeners()
        return self

    def _fit_batch(self, ds: DataSet):
        x, y = self._as_input(ds.features), self._as_input(ds.labels)
        ml = None if ds.labels_mask is None else self._as_input(ds.labels_mask)
        mf = None if ds.features_mask is None \
            else self._as_input(ds.features_mask)
        self._last_input = x
        t0 = time.perf_counter()
        if self.conf.backprop_type == "tbptt" and x.ndim == 3:
            self._fit_tbptt(x, y, ml, mf)
        else:
            self._score = self._train_step(x, y, ml, mask_f=mf)[0].clone()
        self._last_fit_time = time.perf_counter() - t0
        self.iteration += 1
        self._epoch_batch += 1
        self._fire_listeners()
        return self

    def _fit_tbptt(self, x, y, ml, mf=None):
        """Truncated BPTT (parity: doTruncatedBPTT): one train step per
        chunk of tbptt_fwd_length steps, the RNN state carried across
        chunks and entering each detached, the masks sliced per chunk;
        every chunk is a step at the batch's iteration (the same draws);
        the score is the mean of the chunk losses."""
        T, L = x.shape[1], self.conf.tbptt_fwd_length
        carries = [None] * len(self.layers)
        losses = []
        for start in range(0, T, L):
            ys = y[:, start:start + L] if y.ndim == 3 else y
            mls = None if ml is None else ml[:, start:start + L]
            mfs = None if mf is None else mf[:, start:start + L]
            loss, carries = self._train_step(x[:, start:start + L], ys, mls,
                                             carries, mfs)
            losses.append(loss.clone())
        self._score = torch.stack(losses).mean()

    @torch.no_grad()
    def score(self, ds: Optional[DataSet] = None, x=None, y=None) -> float:
        """Loss on a dataset, l1/l2 included, its masks applied, no
        dropout or weight noise, the layer state untouched (parity:
        score)."""
        ml = mf = None
        if ds is not None:
            x, y = ds.features, ds.labels
            ml, mf = ds.labels_mask, ds.features_mask
        loss, _ = self._loss(self.params, self._as_input(x),
                             self._as_input(y),
                             None if ml is None else self._as_input(ml),
                             mask_f=None if mf is None
                             else self._as_input(mf))
        return float(loss)

    def get_score(self) -> float:
        """The last fit's loss (a host read of the device scalar)."""
        self._score = float(self._score)
        return self._score

    def _eval_stream(self, data, fn):
        """``fn(labels, outputs, labels_mask)`` over the batches of
        ``data`` (a DataSet, an iterator, reset first, or a list), each
        through the bucketed ``output``, with a ``device_side``
        pre-processor on the iterator run on the card."""
        dev_fn, host_pp = self._resolve_device_pp(data)
        if isinstance(data, DataSet):
            data = [data]
        elif hasattr(data, "reset"):
            data.reset()
        for ds in data:
            if not isinstance(ds, DataSet):
                ds = DataSet(*ds)
            if host_pp is not None:
                ds = host_pp.pre_process(ds)
            x = ds.features
            if dev_fn is not None:
                x = dev_fn(self._as_input(x))
            out = self.output(x)
            fn(np.asarray(ds.labels), out.float().cpu().numpy(),
               None if ds.labels_mask is None
               else np.asarray(ds.labels_mask))

    def evaluate(self, data, labels=None):
        """Classification evaluation (parity: evaluate): accuracy,
        precision, recall, F1 and the confusion matrix over the batches,
        each through the bucketed ``output``; as in the JAX package, a
        label mask drops rows, a feature mask is not read, and a
        ``device_side`` pre-processor on the iterator runs on the card."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        ev = Evaluation()
        self._eval_stream(data if labels is None else DataSet(data, labels),
                          ev.eval)
        return ev

    def evaluate_regression(self, data):
        """Per-column regression evaluation (parity: evaluateRegression):
        MSE, MAE, RMSE, R^2 and Pearson correlation over the batches of a
        DataSet or an iterator; masks are not read, as in the JAX
        package."""
        from deeplearning4j_tpu_torch.eval.evaluation import \
            RegressionEvaluation
        ev = RegressionEvaluation()
        self._eval_stream(data, lambda y, out, _lm: ev.eval(y, out))
        return ev

    # -------------------------------------------------------------- pretrain
    def pretrain(self, data, epochs: int = 1, lr: float = 0.01):
        """Greedy layerwise pretraining (parity: pretrain) of every layer
        that has a pretrain step (nn/layers/pretrain.py: RBM, AutoEncoder,
        VariationalAutoencoder), in order, each for ``epochs`` passes over
        ``data`` (a DataSet or an iterator of them; anything else is read
        into a list first, since it is passed over once per layer and
        epoch). A layer's input is the features through layers [0, i) in
        inference mode, flattened past two dimensions; its step at batch
        ``j`` of epoch ``ep`` draws from a generator seeded with ``i *
        100003 + ep * 1009 + j``, as the JAX package folds its key, and
        writes the layer's parameters in place. A ``device_side``
        pre-processor on the iterator runs on the card, as in ``fit`` (the
        JAX package's pretrain applies none: caveat R11). The last step's
        loss is the score."""
        from deeplearning4j_tpu_torch.nn.layers.pretrain import \
            get_pretrain_step
        self._check_trainable()
        if not isinstance(data, DataSet) and not hasattr(data, "reset"):
            data = list(data)
        dev_fn, host_pp = self._resolve_device_pp(data)
        seed = self.conf.global_conf.seed
        gen = torch.Generator(device=self.device)
        for i, layer in enumerate(self.layers):
            step = get_pretrain_step(layer)
            if step is None:
                continue
            for ep in range(epochs):
                if hasattr(data, "reset"):
                    data.reset()
                for j, ds in enumerate([data] if isinstance(data, DataSet)
                                       else data):
                    if not isinstance(ds, DataSet):
                        ds = DataSet(*ds)
                    if host_pp is not None:
                        ds = host_pp.pre_process(ds)
                    x = self._as_input(ds.features)
                    if dev_fn is not None:
                        x = dev_fn(x)
                    with torch.no_grad():
                        x = self._forward(self.params, x, upto=i)[0]
                    if x.ndim > 2:
                        x = x.reshape(x.shape[0], -1)
                    seed_generator(gen, seed, i * 100003 + ep * 1009 + j)
                    new, self._score = step(self.params[i], x, gen, lr)
                    with torch.no_grad():
                        for k, v in new.items():
                            self.params[i][k].copy_(v)
                    self._params_version += 1
        return self

    # ------------------------------------------------------------- inference
    def serving_engine(self, **kw):
        """The shape-bucketed inference engine for this net (lazy; keyword
        args are honored on first construction only)."""
        if self._serving is None:
            from deeplearning4j_tpu_torch.serving.engine import \
                InferenceEngine
            self._serving = InferenceEngine(self, **kw)
        return self._serving

    @torch.no_grad()
    def output(self, x, train: bool = False, mask=None,
               bucketed: bool = True) -> torch.Tensor:
        """Forward pass to network output (parity: output), ``mask`` the
        (B, T) feature mask. ``train`` is taken for the JAX package's
        signature and ignored: inference runs without dropout, as there.
        The default pads the batch up to a power-of-two bucket and slices
        the pad rows off (serving/engine.py); ``bucketed=False`` runs the
        exact shape."""
        x = self._as_input(x)
        mask = None if mask is None else self._as_input(mask)
        if bucketed:
            return self.serving_engine().predict(x, mask)
        return self._forward(self.params, x, mask=mask)[0]

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False):
        """Every layer's activation, the input first (parity:
        feedForward): one layer at a time, no cast, no pair fusion; under
        ``train`` with batch statistics and no state written."""
        x = self._as_input(x)
        acts = [x]
        for i, (l, p) in enumerate(zip(self.layers, self.params)):
            x = l.apply(nest_params(p), x, train=train,
                        **self._state_kw(None if train else self.state, i))
            acts.append(x)
        return acts

    @torch.no_grad()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful single/multi-step inference (parity: rnnTimeStep)."""
        x = self._as_input(x)
        if x.ndim == 2:
            x = x[:, None, :]
        if self._rnn_carries is None:
            self._rnn_carries = [None] * len(self.layers)
        act, self._rnn_carries = self._forward(self.params, x,
                                               carries=self._rnn_carries)
        return act

    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    # --------------------------------------------------- incremental decode
    def init_decode_state(self, batch: int, max_len: int = 0, kv=None):
        """Per-layer decode state for ``batch`` concurrent streams: the
        (h, c) carry of each recurrent layer, None for the others. ``kv``
        ({"num_blocks", "block_size"}) asks for the paged layout, which
        layers without a KV cache do not change."""
        gc = self.conf.global_conf
        dt = DTYPES[gc.compute_dtype or gc.dtype]
        if kv is not None:
            return [l.init_paged_decode_state(
                p, batch, max_len, kv["num_blocks"], kv["block_size"], dt,
                self.device) for l, p in zip(self.layers, self.params)]
        return [l.init_decode_state(p, batch, max_len, dt, self.device)
                for l, p in zip(self.layers, self.params)]

    @torch.no_grad()
    def decode_step(self, params, dstate, x_t, pos=None, block_tables=None):
        """One-token step through the stack: ``x_t`` (B, 1, F) at positions
        ``pos`` (B,); ``block_tables`` routes KV-cache layers through their
        paged step. Returns (y, new_dstate)."""
        cdt = self._compute_dtype(False)
        if cdt is not None:
            x_t = x_t.to(cdt)
            params = _cast_floats(params, cdt)
        x = x_t
        new_d = list(dstate)
        for i, l in enumerate(self.layers):
            if block_tables is None:
                x, new_d[i] = l.decode_step(params[i], dstate[i], x, pos)
            else:
                x, new_d[i] = l.decode_step_paged(params[i], dstate[i], x,
                                                  pos, block_tables)
        return x, new_d

    def _cast_decode(self, params, x):
        cdt = self._compute_dtype(False)
        if cdt is None:
            return params, x
        return _cast_floats(params, cdt), x.to(cdt)

    @torch.no_grad()
    def prefill_chunk(self, params, dstate, x, start, n, block_tables=None,
                      carry_stack=False):
        """A prefill chunk through the stack: ``x`` (B, K, F) at positions
        ``start .. start+K-1``, ``n`` (B,) valid rows (Layer.
        prefill_chunk). With ``carry_stack`` also each layer's carry
        snapshot stack (None where a layer keeps no carry)."""
        params, x = self._cast_decode(params, x)
        new_d = list(dstate)
        stacks = [None] * len(self.layers)
        for i, l in enumerate(self.layers):
            out = l.prefill_chunk(params[i], dstate[i], x, start, n,
                                  block_tables=block_tables,
                                  carry_stack=carry_stack)
            x, new_d[i] = out[0], out[1]
            if carry_stack:
                stacks[i] = out[2]
        return (x, new_d, stacks) if carry_stack else (x, new_d)

    @torch.no_grad()
    def tree_chunk(self, params, dstate, x, pos0, tree, n, block_tables=None):
        """Score a speculation token tree through the stack: ``x`` (B, N,
        F) in ``tree`` order (Layer.tree_chunk). Returns ``(y, stacks,
        kv_windows)``, per layer; ``dstate`` is not advanced."""
        params, x = self._cast_decode(params, x)
        stacks = [None] * len(self.layers)
        wins = [None] * len(self.layers)
        for i, l in enumerate(self.layers):
            x, _, stacks[i], wins[i] = l.tree_chunk(
                params[i], dstate[i], x, pos0, tree, n,
                block_tables=block_tables)
        return x, stacks, wins

    @torch.no_grad()
    def tree_commit(self, dstate, kv_windows, path, pos0, commit_n,
                    block_tables=None):
        """Write the accepted root-path's KV (Layer.tree_commit); layers
        without a KV window pass through."""
        new_d = list(dstate)
        for i, l in enumerate(self.layers):
            if kv_windows[i] is not None:
                new_d[i] = l.tree_commit(None, dstate[i], kv_windows[i],
                                         path, pos0, commit_n,
                                         block_tables=block_tables)
        return new_d

    # ------------------------------------------------------------- utilities
    def num_params(self) -> int:
        return count_params(self.params)

    def summary(self) -> str:
        """The JAX package's table: layer, type, parameters, total."""
        lines = ["=" * 70,
                 f"{'Layer':<30}{'Type':<25}{'Params':>12}", "=" * 70]
        for i, (l, p) in enumerate(zip(self.layers, self.params)):
            name = l.name or f"layer_{i}"
            lines.append(f"{name:<30}{type(l).__name__:<25}"
                         f"{count_params([p]):>12,}")
        lines.append("=" * 70)
        lines.append(f"Total params: {self.num_params():,}")
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """A network of the same configuration on the same device with
        copies of the parameters and state and a fresh updater state."""
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(self.conf.to_json()),
            device=self.device)
        if self.params is not None:
            net.set_params([{k: v.clone() for k, v in p.items()}
                            for p in self.params], self.state)
        return net

    def save(self, path, save_updater=True, normalizer=None):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(self, path, save_updater, normalizer)

    @staticmethod
    def load(path, load_updater=True, *, device=None) -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.util.model_serializer import \
            restore_multi_layer_network
        return restore_multi_layer_network(path, load_updater,
                                           device=device)
