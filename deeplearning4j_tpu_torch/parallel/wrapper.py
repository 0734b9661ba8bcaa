"""Data-parallel training over the mesh's slots.

Counterpart of deeplearning4j_tpu/parallel/wrapper.py: ``ParallelWrapper``
with the JAX constructor, ``fit``, ``fit_scan`` and their errors, and
``default_mesh(n_devices, axis)``. It takes either container
(MultiLayerNetwork or ComputationGraph) through the protocol both have:
``_gradients`` (the loss's gradients at the resident parameters),
``_step`` (one train step, captured as ``_steps``) and
``_dp_apply_updates`` (normalization, the fused flat update,
constraints).

A mesh slot is one replica (exec/mesh.py). Each rank of the process group
runs the slots the mesh gives it, all on that rank's one device, and is
fed ITS rows: the whole batch in a single process, its
``local_batch_slice`` of the global batch in a group of several.

**Sync mode** (``averaging_frequency=1``) computes what the JAX package's
sharded step computes: one step on the global batch.

- A batch whose rows do not split evenly over the rank's slots is padded
  by wrapping rows, and the pad rows get zero loss weight through the
  label mask (joined with the batch's own label mask), as JAX's
  ``_prepare`` / ``_dp_loss`` do; their rows still enter the forward
  (batch statistics), as they do in JAX.
- The slots of a rank share its device, so the rank computes its rows'
  gradients in ONE call of a gradient program (captured on the card, one
  CUDA graph per signature): the container's ``_gradients``, whose
  gradients are written into one flat buffer per dtype in the fused
  update's group order, the float32 buffer ending with the loss.
- In a process group the flat buffers are all-reduced (sum), one
  all-reduce per dtype, BETWEEN the captured gradient program and the
  captured update program: gloo reduces a card's tensors through the
  host and cannot be captured, and NCCL's all-reduce is kept at the same
  place. Each rank's loss is normalized over its own rows, so before the
  backward it is scaled by the rank's share of the global row count (its
  rows over all ranks' rows, per output, exchanged on the host group,
  parallel/distributed.py): the sum of the scaled gradients is the
  global batch's gradient, the l1/l2 gradient counted once. A graph with
  several outputs whose shares differ (label masks of different
  densities) is refused.
- A BatchNormalization layer computes global batch statistics across
  ranks (sums and squared deviations all-reduced inside the step, by
  differentiable all-reduces), as GSPMD does for the JAX step; such a
  step runs eagerly.
- The update program is the container's ``_dp_apply_updates`` over the
  reduced gradients, through the container's ``_run`` (the fused
  update's scalars staged, its counts advanced once): normalization and
  clipping see the reduced gradient, as in JAX.

Without a process group nothing is scaled or reduced, so a sync step of
an unpadded batch is the container's own step, bit for bit.

**Averaging mode** (``averaging_frequency=k>1``): the replicas diverge.
Each slot keeps its own parameters, layer state and updater state
(copies on the rank's device). A round: for each of k local steps, each
slot's copy is written into the container's resident buffers
(``copy_``, never rebinding: the captured step reads them by address),
the container's captured train step runs on the slot's rows with the
slot index folded into the step's seed (``exec.executor.slot_seed``, as
JAX folds ``axis_index``), and the buffers are copied back. The fused
update's scalars are staged once a local step, and its counts advanced
once, so slot j's step i reads count ``c0 + i`` for every j and the
round leaves ``c0 + k``, as JAX's pmean of equal counts does. Then the
parameters, layer state and updater state are averaged over the slots,
and over the ranks by an all-reduce divided by the slot count.

**TP x DP** (a 2-D ``(data, model)`` mesh, sync mode only, as in JAX):
the model axis lies within the rank's slots, so the rank's slots are
``data_slots`` data replicas of ``model_size`` model shards each. The
gradient program computes the rank's rows through the container's
tensor-parallel form (parallel/tensor_parallel.py): each model shard
computes with its own shards of the parameters (``param_spec``'s split;
``_param_sharding`` / ``_replicated``), its launches inside the one
captured program; the update program is the per-leaf update over the
shards, in place. ``net.params`` holds the gathered, full parameters
after every ``fit`` / ``fit_scan`` call.

``fit`` follows JAX: in sync mode runs of same-shape, mask-free batches
that divide over the slots are stacked and trained by ``fit_scan``
(listeners once a chunk), any other batch alone (listeners once a
batch); in averaging mode every k batches are a round.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.exec.executor import seed_generator, slot_seed
from deeplearning4j_tpu_torch.exec.mesh import Mesh, Slot
from deeplearning4j_tpu_torch.parallel.distributed import (
    host_group, process_device, topology)

_COUNT_SUFFIX = ".count"


def default_mesh(n_devices: Optional[int] = None, axis: str = "data",
                 device=None) -> Mesh:
    """``n_devices`` slots in all (default: one a rank), spread evenly
    over the ranks of the group, each rank's on ``device`` (default: the
    process's device)."""
    from deeplearning4j_tpu_torch.ops import resolve_device
    _, world = topology()
    dev = process_device() if device is None else resolve_device(device)
    n = world if n_devices is None else int(n_devices)
    if n < world or n % world:
        raise ValueError(f"{n} slots do not spread evenly over {world} "
                         "ranks")
    return Mesh([Slot(r, dev) for r in range(world)
                 for _ in range(n // world)], (axis,), (n,))


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def _members(tree):
    """(key, dict) pairs of a container's per-member tree (a list, or a
    dict by node name)."""
    return list(tree.items()) if isinstance(tree, dict) \
        else list(enumerate(tree))


def _counts(model):
    """The updater's host counts: {(member, key): tensor}."""
    return {(m, k): v for m, o in _members(model.opt_state)
            for k, v in o.items() if k.endswith(_COUNT_SUFFIX)}


def _restore_counts(model, counts) -> None:
    opt = dict(_members(model.opt_state))
    for (m, k), v in counts.items():
        opt[m][k] = v


def _resident(model) -> List[torch.Tensor]:
    """Every tensor of the model's parameters, updater state (counts
    excepted) and layer state, each storage once: the fused update's flat
    buffers where it has them."""
    out, skip = [], set()
    fused = model._fused
    if fused is not None:
        for g in fused.groups:
            out.append(g.flat)
            out.extend(g.slots.values())
        skip = set(fused.fused_keys)
    for m, p in _members(model.params):
        if m not in skip:
            out.extend(p.values())
    for m, o in _members(model.opt_state):
        if m not in skip:
            out.extend(v for k, v in o.items()
                       if not k.endswith(_COUNT_SUFFIX))
    for _, s in _members(model.state or []):
        out.extend(s.values())
    return out


class _GradLayout:
    """Where each gradient lies in the flat buffers the gradient program
    writes: one buffer per dtype, members in the fused update's group
    order (then the other members), the float32 buffer ending with the
    loss."""

    def __init__(self, params, fused=None):
        self.graph = isinstance(params, dict)
        members = dict(_members(params))
        order = []
        if fused is not None:
            order += [(m, n) for g in fused.groups for m, n in g.layout]
        seen = set(order)
        order += [(m, n) for m, p in members.items() for n in p
                  if (m, n) not in seen]
        self.keys = list(members)
        self.names = {m: list(p) for m, p in members.items()}
        self.buckets = {}                 # dtype -> [(member, name, shape)]
        for m, n in order:
            t = members[m][n]
            self.buckets.setdefault(t.dtype, []).append((m, n, t.shape))
        self.buckets.setdefault(torch.float32, [])
        self.dtypes = sorted(self.buckets, key=str)
        self.loss_at = self.dtypes.index(torch.float32)

    def flatten(self, grads, loss) -> tuple:
        g = dict(_members(grads))
        flats = []
        for dt in self.dtypes:
            parts = [g[m][n].reshape(-1).to(dt)
                     for m, n, _ in self.buckets[dt]]
            if dt == torch.float32:
                parts.append(loss.reshape(1).float())
            flats.append(torch.cat(parts) if len(parts) > 1 else parts[0]
                         .clone())
        return tuple(flats)

    def unflatten(self, flats):
        """The per-member gradients as views of ``flats``."""
        out = {m: {} for m in self.keys}
        for dt, flat in zip(self.dtypes, flats):
            off = 0
            for m, n, shape in self.buckets[dt]:
                k = int(np.prod(shape)) if len(shape) else 1
                out[m][n] = flat[off:off + k].view(shape)
                off += k
        out = {m: {n: out[m][n] for n in self.names[m]} for m in self.keys}
        return out if self.graph else [out[m] for m in self.keys]


def _loss_rows(y, m) -> float:
    """The rows a loss over labels ``y`` divides by (nn/losses.py): a
    time-distributed output's (b, t) pairs, else its examples; with a
    label mask, the rows it keeps."""
    if m is None:
        return float(y.shape[0] * (y.shape[1] if y.ndim == 3 else 1))
    m = np.asarray(m, np.float64)
    if y.ndim == 3 and m.ndim == 2:
        return float(m.sum())
    return float(m.reshape(m.shape[0], -1).max(axis=-1).sum())


def _global_batch_stats(x, dims):
    """BatchNormalization's batch mean and (biased) variance over the
    batches of every rank: differentiable all-reduces of the sums, the
    row count, then the squared deviations."""
    import torch.distributed.nn.functional as dfn
    count = x.numel() // x.shape[-1]
    tot = dfn.all_reduce(torch.cat([x.sum(dim=dims),
                                    x.new_tensor([float(count)])]))
    mean = tot[:-1] / tot[-1]
    var = dfn.all_reduce(((x - mean) ** 2).sum(dim=dims)) / tot[-1]
    return mean, var


class _Batch:
    """A batch as lists: features, labels, feature masks and label masks
    (None where absent), host arrays or tensors."""

    def __init__(self, xs, ys, mfs=None, mls=None):
        self.xs, self.ys = list(xs), list(ys)
        self.mfs = mfs if mfs and any(m is not None for m in mfs) else None
        self.mls = mls if mls and any(m is not None for m in mls) else None

    @property
    def rows(self) -> int:
        return int(self.xs[0].shape[0])

    def take(self, sl) -> "_Batch":
        def cut(lst):
            return None if lst is None else [None if a is None else a[sl]
                                             for a in lst]
        return _Batch(cut(self.xs), cut(self.ys), cut(self.mfs),
                      cut(self.mls))


def _wrap_rows(arr, n):
    """``arr`` (host array) with rows appended by wrapping, to ``n``."""
    arr = np.asarray(arr)
    b = arr.shape[0]
    if b >= n:
        return arr
    return np.concatenate([arr, arr[np.arange(n - b) % b]])


class ParallelWrapper:
    """Data-parallel trainer over a MultiLayerNetwork or ComputationGraph
    (parity: the JAX ``ParallelWrapper``).

        pw = ParallelWrapper(net, workers=8, averaging_frequency=1)
        pw.fit(iterator)

    ``workers``: the slots in all (default: one a rank of the process
    group); ``averaging_frequency`` 1: one synchronous step on the global
    batch; k > 1: k local steps on divergent replicas, then averaging."""

    def __init__(self, model, workers: Optional[int] = None,
                 averaging_frequency: int = 1, prefetch_buffer: int = 2,
                 mesh: Optional[Mesh] = None, model_axis: str = "model"):
        self.model = model
        self.mesh = mesh if mesh is not None else default_mesh(
            workers, device=model.device)
        if "data" not in self.mesh.axis_names:
            raise ValueError(
                f"ParallelWrapper mesh needs a 'data' axis, got "
                f"{self.mesh.axis_names}")
        self.n_devices = self.mesh.shape["data"]
        if (len(self.mesh.axis_names) > 1
                and model_axis not in self.mesh.axis_names):
            raise ValueError(
                f"mesh has axes {self.mesh.axis_names} but model_axis="
                f"{model_axis!r} matches none of them")
        self.model_axis = model_axis if model_axis in self.mesh.axis_names \
            else None
        if self.model_axis is not None and averaging_frequency != 1:
            raise ValueError(
                "tensor parallelism (2-D mesh) requires "
                "averaging_frequency=1 (per-step sync)")
        self.model_size = 1 if self.model_axis is None \
            else int(self.mesh.shape[self.model_axis])
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.prefetch_buffer = prefetch_buffer
        self.rank, self.world = topology()
        if self.mesh.ranks != list(range(self.world)):
            raise ValueError(f"the mesh's ranks {self.mesh.ranks} are not "
                             f"the group's {self.world}")
        self.slots = self.mesh.local_slots(self.rank)
        if not self.slots:
            raise ValueError(f"the mesh gives rank {self.rank} no slot")
        # the rank's data-parallel replicas: its slots over the model axis
        self.data_slots = len(self.slots) // self.model_size
        self._first_slot = self.mesh.slots.index(self.slots[0])
        for s in self.slots:
            if not _same_device(s.device, model.device):
                raise ValueError(f"slot {s} is not on the model's device "
                                 f"{model.device}")
        self._grad = self._upd = self._layout = self._built_for = None
        self._replicas = None
        self._tp = None                  # the tensor-parallel form
        self._dev_fn = None
        # the host seconds, calls and bytes of the gradient all-reduces,
        # and the host seconds of the row counts' exchange
        self.comm = {"calls": 0, "bytes": 0, "seconds": 0.0,
                     "host_seconds": 0.0}

    @property
    def _grouped(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    # ------------------------------------------------------------ placement
    def _param_sharding(self, leaf, path=""):
        """The TP spec of one weight leaf (``exec.param_spec``, the rule
        the executor applies on a mesh with a model axis); ``()``, the
        replicated spec, on a pure data-parallel mesh."""
        if self.model_axis is None:
            return ()
        from deeplearning4j_tpu_torch.exec import param_spec
        return param_spec(path, leaf, self.model_size, axis=self.model_axis)

    def _replicated(self, tree):
        """A container's parameter tree as its per-slot model shards: each
        leaf the list of its ``model_size`` shards by ``_param_sharding``
        (one tensor for every shard of a replicated leaf)."""
        from deeplearning4j_tpu_torch.exec.executor import (_map_tree,
                                                            split_leaf)
        return _map_tree(tree, lambda path, leaf: split_leaf(
            leaf, self._param_sharding(leaf, path), self.model_size))

    # ------------------------------------------------------------- batches
    def _batch(self, ds) -> _Batch:
        """A DataSet / MultiDataSet / (x, y) as the container's lists."""
        if not isinstance(ds, (DataSet, MultiDataSet)):
            ds = DataSet(*ds)
        if isinstance(self.model.params, dict):
            mds = ds.to_multi() if isinstance(ds, DataSet) else ds
            return _Batch(mds.features, mds.labels, mds.features_masks,
                          mds.labels_masks)
        if isinstance(ds, MultiDataSet):
            raise ValueError("a MultiLayerNetwork trains on DataSets")
        return _Batch([ds.features], [ds.labels], [ds.features_mask],
                      [ds.labels_mask])

    def _prepare(self, ds):
        """(batch padded to a slot multiple by wrapping rows, pad mask or
        None) of a DataSet; the pad mask joins the label masks."""
        b = ds if isinstance(ds, _Batch) else self._batch(ds)
        n = self.data_slots
        if b.rows % n == 0:
            return b, None
        total = b.rows + n - b.rows % n
        pm = np.concatenate([np.ones(b.rows, np.float32),
                             np.zeros(total - b.rows, np.float32)])
        pad = _Batch([_wrap_rows(a, total) for a in b.xs],
                     [_wrap_rows(a, total) for a in b.ys],
                     None if b.mfs is None else
                     [None if m is None else _wrap_rows(m, total)
                      for m in b.mfs],
                     None if b.mls is None else
                     [None if m is None else _wrap_rows(m, total)
                      for m in b.mls])
        return pad, pm

    @staticmethod
    def _join_pad(batch: _Batch, pm) -> Optional[list]:
        """The label masks with the pad mask joined (None: no mask)."""
        if pm is None:
            return batch.mls
        out = []
        for i, y in enumerate(batch.ys):
            p = np.broadcast_to(pm[:, None], y.shape[:2]) if y.ndim == 3 \
                else pm
            m = None if batch.mls is None else batch.mls[i]
            out.append(np.ascontiguousarray(p, np.float32) if m is None
                       else np.asarray(m, np.float32) * p)
        return out

    def _dev(self, a, feature=False):
        if a is None:
            return None
        t = self.model._as_input(a)
        if feature and self._dev_fn is not None:
            t = self._dev_fn(t)
        return t

    def _args(self, batch: _Batch, mls):
        """(xs, ys, mls, mfs) on the device."""
        return ([self._dev(a, True) for a in batch.xs],
                [self._dev(a) for a in batch.ys],
                None if mls is None else [self._dev(m) for m in mls],
                None if batch.mfs is None else
                [self._dev(m) for m in batch.mfs])

    def _masks_by_input(self, mfs):
        if mfs is None:
            return None
        return {n: m for n, m in zip(self.model.conf.network_inputs, mfs)
                if m is not None}

    # ------------------------------------------------------------ programs
    def _eager(self) -> bool:
        m = self.model
        return (m._fused is None or not m._capture_steps
                or (self._grouped and self._has_bn()))

    def _has_bn(self) -> bool:
        from deeplearning4j_tpu_torch.nn.layers.conv import \
            BatchNormalization
        layers = (self.model.layers if not isinstance(self.model.params,
                                                      dict)
                  else [n.layer for n in self.model.conf.nodes.values()
                        if n.kind == "layer"])
        return any(isinstance(l, BatchNormalization) for l in layers)

    def _loss_of(self, net, params, xs, ys, mls, mfs):
        """The container's loss through ``net`` (the tensor-parallel copy)
        at ``params``, the layer state written."""
        m = self.model
        if isinstance(m.params, dict):
            return net._loss(params, xs, ys, mls, self._masks_by_input(mfs),
                             gen=m._gen, state=m.state)[0]
        return net._loss(params, xs[0], ys[0],
                         None if mls is None else mls[0], None,
                         None if mfs is None else mfs[0], gen=m._gen,
                         state=m.state)[0]

    def _grad_fn(self, xs, ys, mls, mfs, scale):
        """The gradient program: the rank's loss and gradients at the
        resident parameters (the layer state written), flattened; under
        tensor parallelism each model shard's gradients at its shards."""
        m = self.model
        if self._tp is not None:
            loss, grads = self._tp.gradients(
                lambda net, p: self._loss_of(net, p, xs, ys, mls, mfs),
                scale)
            return self._layout.flatten(grads, loss)
        if isinstance(m.params, dict):
            loss, grads, _ = m._gradients(xs, ys, mls,
                                          self._masks_by_input(mfs), m._gen,
                                          None, m.state, scale)
        else:
            loss, grads, _ = m._gradients(
                xs[0], ys[0], None if mls is None else mls[0], None,
                None if mfs is None else mfs[0], m._gen, m.state, scale)
        return self._layout.flatten(grads, loss)

    def _upd_fn(self, flats):
        """The update program: the container's update over the reduced
        gradients (the loss slot left out)."""
        f32 = self._layout.loss_at
        flats = [f[:-1] if i == f32 else f for i, f in enumerate(flats)]
        grads = self._layout.unflatten(flats)
        if self._tp is not None:
            self._tp.apply_updates(grads)
        else:
            self.model._dp_apply_updates(grads)

    def _programs(self):
        """The gradient and update programs, built anew (with the slots'
        replicas) whenever the container rebuilt its optimizer, whose new
        buffers a captured graph of the old ones would not read."""
        m = self.model
        if self._grad is None or self._built_for is not m._steps:
            self._built_for = m._steps
            self._replicas = None
            if self.model_size > 1:
                from deeplearning4j_tpu_torch.parallel.tensor_parallel \
                    import TensorParallel
                self._tp = TensorParallel(m, self.model_size,
                                          self.model_axis)
                self._layout = _GradLayout(self._tp.params)
            else:
                self._layout = _GradLayout(m.params, m._fused)
            ex, caller = m._executor, m._prog_caller
            self._grad = ex.steps(self._grad_fn, generator=m._gen,
                                  caller=caller, name="dp_grad_b{B}")
            self._upd = ex.steps(self._upd_fn, caller=caller,
                                 name="dp_apply_updates")

    def _scale(self, batch: _Batch, mls):
        """This rank's share of the global rows (a 0-dim float32 tensor),
        or None outside a process group."""
        if not self._grouped:
            return None
        rows = [_loss_rows(y, None if mls is None else mls[i])
                for i, y in enumerate(batch.ys)]
        t = torch.tensor(rows, dtype=torch.float64)
        t0 = time.perf_counter()
        dist.all_reduce(t, group=host_group())
        self.comm["host_seconds"] += time.perf_counter() - t0
        shares = [r / max(tot, 1.0) for r, tot in zip(rows, t.tolist())]
        if max(shares) - min(shares) > 1e-12:
            raise NotImplementedError(
                "a synchronous step across ranks scales each rank's loss by "
                "one share of the global rows; this batch's outputs have "
                f"different shares {shares}")
        return torch.tensor(shares[0], dtype=torch.float32)

    def _sync_gradients(self, batch: _Batch, pm, iteration: int):
        """The gradient program on the rank's rows at ``iteration``,
        reduced over the group: the flat buffers (float32 last element:
        the loss)."""
        from deeplearning4j_tpu_torch.nn.layers.conv import \
            BatchNormalization
        self._programs()
        m = self.model
        mls = self._join_pad(batch, pm)
        scale = self._scale(batch, mls)
        xs, ys, dmls, mfs = self._args(batch, mls)
        if scale is not None:
            scale = scale.to(m.device)
        seed_generator(m._gen, m.conf.global_conf.seed, iteration)
        bn = self._grouped and self._has_bn()
        if bn:
            BatchNormalization.batch_stats = staticmethod(
                _global_batch_stats)
        try:
            flats = self._grad(xs, ys, dmls, mfs, scale, eager=self._eager())
        finally:
            if bn:
                BatchNormalization.batch_stats = None
        if self._grouped:
            t0 = time.perf_counter()
            for f in flats:
                dist.all_reduce(f)
                self.comm["bytes"] += f.numel() * f.element_size()
            self.comm["calls"] += len(flats)
            self.comm["seconds"] += time.perf_counter() - t0
        return flats

    def _sync_step(self, batch: _Batch, pm, iteration: int):
        """One synchronous step; returns the global loss (a device
        scalar)."""
        flats = self._sync_gradients(batch, pm, iteration)
        loss = flats[self._layout.loss_at][-1].clone()
        if self._tp is not None:
            m = self.model
            self._tp.stage()
            self._upd(flats, eager=not m._capture_steps)
            self._tp.advance()
        else:
            self.model._run(self._upd, self._upd_fn, flats)
        return loss

    def _tp_sync(self):
        """The tensor-parallel shards up to date with the container."""
        if self.model_size > 1:
            self._programs()
            self._tp.sync()

    def _tp_store(self):
        """The gathered, full parameters back in the container."""
        if self._tp is not None:
            self._tp.store()

    # ----------------------------------------------------------- averaging
    def _avg_round(self, rounds: List, it0: int):
        """k local steps of every slot (``rounds``: k prepared batches),
        then the average over the slots and ranks. Returns the mean loss
        (a device scalar)."""
        m = self.model
        S = len(self.slots)
        self._programs()
        res = _resident(m)
        if self._replicas is None:
            self._replicas = [[t.clone() for t in res] for _ in range(S)]
        with torch.no_grad():
            for rep in self._replicas:
                for d, t in zip(rep, res):
                    d.copy_(t)
        eager = m._fused is None or not m._capture_steps
        graph = isinstance(m.params, dict)
        losses = []
        for i, (batch, pm) in enumerate(rounds):
            counts0 = _counts(m)
            if m._fused is not None:
                m._fused.stage(m._staged())
            lb = batch.rows // S
            mls = self._join_pad(batch, pm)
            for j in range(S):
                sl = slice(j * lb, (j + 1) * lb)
                part = batch.take(sl)
                pml = None if mls is None else [None if a is None else a[sl]
                                               for a in mls]
                xs, ys, dmls, mfs = self._args(part, pml)
                _restore_counts(m, counts0)
                res = _resident(m)
                with torch.no_grad():
                    for t, s in zip(res, self._replicas[j]):
                        t.copy_(s)
                if m._gen is not None:
                    m._gen.manual_seed(slot_seed(
                        m.conf.global_conf.seed, it0 + i,
                        self._first_slot + j))
                m._params_version += 1
                if graph:
                    args = (xs, ys, dmls, self._masks_by_input(mfs), None)
                else:
                    args = (xs[0], ys[0], None if dmls is None else dmls[0],
                            None, None if mfs is None else mfs[0])
                loss = m._steps(*args, eager=eager)[0]
                losses.append(loss.reshape(1).float().clone())
                res = _resident(m)
                with torch.no_grad():
                    for s, t in zip(self._replicas[j], res):
                        s.copy_(t)
            if m._fused is not None:
                m._fused.advance(m._staged())
        return self._average(losses)

    @torch.no_grad()
    def _average(self, losses):
        """The slots' mean written into the model's resident tensors (and
        every replica), reduced over the group; the mean loss."""
        m = self.model
        res = _resident(m)
        total = float(self.n_devices)
        for idx, t in enumerate(res):
            reps = [rep[idx] for rep in self._replicas]
            if not t.is_floating_point():
                t.copy_(reps[0])
                continue
            acc = torch.stack([r.float() for r in reps]).sum(0)
            if self._grouped:
                dist.all_reduce(acc)
            t.copy_((acc / total).to(t.dtype))
        loss = torch.cat(losses).sum()
        if self._grouped:
            dist.all_reduce(loss)
        m._params_version += 1
        return loss / (total * (len(losses) // len(self.slots)))

    # ----------------------------------------------------------------- fit
    def _fire(self):
        model = self.model
        for lst in model.listeners:
            lst.iteration_done(model, model.iteration, model.epoch)

    def _fit_one(self, ds):
        model = self.model
        batch, pm = self._prepare(ds)
        self._tp_sync()
        try:
            model._score = self._sync_step(batch, pm, model.iteration)
        finally:
            self._tp_store()
        model.iteration += 1
        self._fire()

    def fit_scan(self, xs, ys):
        """Train ``n_steps`` minibatches stacked on a leading axis: ``xs``
        (n_steps, batch, ...) features and ``ys`` labels (a list of them
        for a graph's several inputs or outputs); ``batch`` (this rank's
        rows) must divide over the rank's slots. averaging_frequency=1
        runs the synchronous step on each; k > 1 needs ``n_steps % k ==
        0`` and averages every k local steps. Listeners fire once."""
        model = self.model
        if getattr(model.conf, "backprop_type", "standard") == "tbptt":
            raise ValueError(
                "fit_scan runs full-sequence backprop; a net configured for "
                "truncated BPTT must use fit() (the tbptt chunking path)")
        if model.params is None:
            model.init()
        xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
        ys = list(ys) if isinstance(ys, (list, tuple)) else [ys]
        n_steps, batch = int(xs[0].shape[0]), int(xs[0].shape[1])
        for leaf in (*xs, *ys):
            if tuple(leaf.shape[:2]) != (n_steps, batch):
                raise ValueError(
                    f"fit_scan leaves must share (n_steps, batch)="
                    f"{(n_steps, batch)}; got {tuple(leaf.shape[:2])}")
        if batch % self.data_slots != 0:
            raise ValueError(
                f"fit_scan batch {batch} must divide over {self.n_devices} "
                "devices; pad the batch or use fit() (which pads exactly)")
        k = self.averaging_frequency
        if k > 1 and n_steps % k != 0:
            raise ValueError(
                f"n_steps={n_steps} must be a multiple of "
                f"averaging_frequency={k} on the fit_scan path")
        steps = [_Batch([a[s] for a in xs], [a[s] for a in ys])
                 for s in range(n_steps)]
        it0 = model.iteration
        if k == 1:
            self._tp_sync()
            try:
                for s, b in enumerate(steps):
                    loss = self._sync_step(b, None, it0 + s)
            finally:
                self._tp_store()
        else:
            for r in range(0, n_steps, k):
                loss = self._avg_round([(b, None) for b in steps[r:r + k]],
                                       it0 + r)
        model.iteration += n_steps
        model._score = loss
        self._fire()
        return model

    def fit(self, data, epochs=1):
        """Train over the mesh. ``data``: an iterator (or list) of DataSets
        (MultiDataSets for a graph); in a process group each rank's own
        rows."""
        model = self.model
        if model.params is None:
            model.init()
        self._dev_fn, host_pp = model._resolve_device_pp(data)
        try:
            for _ in range(epochs):
                if hasattr(data, "reset"):
                    data.reset()
                if self.averaging_frequency == 1:
                    self._sync_epoch(data, host_pp)
                else:
                    self._avg_epoch(data, host_pp)
                model.epoch += 1
        finally:
            self._dev_fn = None
        return model

    def _sync_epoch(self, data, host_pp):
        """One epoch of sync mode: runs of same-shape, mask-free batches
        that divide over the slots are stacked into ``fit_scan`` chunks
        (the JAX wrapper's chunking), any other batch trains alone."""
        model = self.model
        chunkable = getattr(model.conf, "backprop_type",
                            "standard") != "tbptt"
        buf, shape = [], None

        def flush():
            nonlocal buf, shape
            if len(buf) == 1:
                self._fit_one(buf[0])
            elif buf:
                self.fit_scan(
                    [np.stack([np.asarray(b.xs[i]) for b in buf])
                     for i in range(len(buf[0].xs))],
                    [np.stack([np.asarray(b.ys[i]) for b in buf])
                     for i in range(len(buf[0].ys))])
            buf, shape = [], None

        for ds in data:
            if host_pp is not None:
                ds = host_pp.pre_process(
                    ds if isinstance(ds, (DataSet, MultiDataSet))
                    else DataSet(*ds))
            b = self._batch(ds)
            if (not chunkable or b.mfs is not None or b.mls is not None
                    or b.rows % self.data_slots != 0):
                flush()
                self._fit_one(b)
                continue
            key = tuple(np.shape(a) for a in (*b.xs, *b.ys))
            if shape is not None and key != shape:
                flush()
            shape = key
            buf.append(b)
            per = sum(np.asarray(a).nbytes for a in (*b.xs, *b.ys))
            if len(buf) >= max(1, min(64, (256 << 20) // max(1, per))):
                flush()
        flush()

    def _avg_epoch(self, data, host_pp):
        k = self.averaging_frequency
        micro = []
        for ds in data:
            if host_pp is not None:
                ds = host_pp.pre_process(
                    ds if isinstance(ds, (DataSet, MultiDataSet))
                    else DataSet(*ds))
            micro.append(ds)
            if len(micro) == k:
                self._fit_avg_chunk(micro)
                micro = []
        if micro:
            self._fit_avg_chunk(micro)

    def _fit_avg_chunk(self, micro: List):
        """One round over ``micro`` (up to k batches): each padded to a
        slot multiple, then by wrapping to the round's largest batch, the
        pad rows zero-weighted (the JAX wrapper's ``_fit_avg_chunk``)."""
        model = self.model
        prepared = [self._prepare(ds) for ds in micro]
        if any(b.mfs is not None or b.mls is not None for b, _ in prepared):
            raise NotImplementedError(
                "averaging_frequency > 1 does not support per-example masks; "
                "use averaging_frequency=1 (sync gradient allreduce), which "
                "handles masked data exactly")
        max_b = max(b.rows for b, _ in prepared)
        rounds = []
        for b, pm in prepared:
            if pm is None and b.rows == max_b:
                rounds.append((b, None))
                continue
            pm = np.ones(b.rows, np.float32) if pm is None else pm
            rounds.append((_Batch([_wrap_rows(a, max_b) for a in b.xs],
                                  [_wrap_rows(a, max_b) for a in b.ys]),
                           np.concatenate([pm, np.zeros(max_b - b.rows,
                                                        np.float32)])))
        if any(pm is not None for _, pm in rounds):
            rounds = [(b, np.ones(b.rows, np.float32) if pm is None else pm)
                      for b, pm in rounds]
        model._score = self._avg_round(rounds, model.iteration)
        model.iteration += len(micro)
        self._fire()
