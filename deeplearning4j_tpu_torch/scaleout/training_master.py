"""The TrainingMaster SPI and its two masters.

Counterpart of deeplearning4j_tpu/scaleout/training_master.py:
``TrainingStats``, ``TrainingMaster``, ``ParameterAveragingTrainingMaster``
and ``SharedTrainingMaster``.

- ``ParameterAveragingTrainingMaster`` re-cuts the data into global
  batches of ``batch_size_per_worker`` x the wrapper's slots and trains
  them through the port's ``ParallelWrapper`` (parallel/wrapper.py):
  frequency 1 is the synchronous step, frequency k the averaging rounds.
  In a process group each rank trains its ``local_batch_slice`` of every
  global batch.
- ``SharedTrainingMaster`` exchanges threshold-encoded updates
  (parallel/compression.py): each worker takes the learning rate times
  its gradient, adds its residual, sends sign x threshold for the entries
  that reach the threshold and keeps the rest as its residual. Without a
  mesh the workers are logical replicas, round-robin over the minibatches
  (``EncodedGradientsAccumulator``), as in JAX. With a mesh
  (``execute_training_collective``) every slot is a worker with its own
  residual and threshold (on the device, adapted without a host read):
  each global step, the slots compute their gradients at the shared
  parameters on their rows, the decoded messages are summed over the
  rank's slots and all-reduced over the ranks (JAX's ``psum`` in
  ``shard_map``), and every replica subtracts the same sum.

Parameters are exchanged as one float32 vector in the JAX package's
``ravel_pytree`` order (members in order, a graph's by sorted node name,
each member's keys sorted by path), written back into the network's
tensors in place.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.parallel.compression import (
    EncodedGradientsAccumulator, adapt_threshold_tensor, pytree_key,
    threshold_decode, threshold_encode)
from deeplearning4j_tpu_torch.parallel.distributed import (local_batch_slice,
                                                           topology)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper


class TrainingStats:
    """Wall-clock ms per phase name (parity: SparkTrainingStats)."""

    def __init__(self):
        self.timings: Dict[str, List[float]] = {}

    def time(self, key):
        stats = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *a):
                stats.timings.setdefault(key, []).append(
                    (time.perf_counter() - self.t0) * 1e3)

        return _Ctx()

    def summary(self) -> str:
        lines = []
        for k, v in sorted(self.timings.items()):
            lines.append(f"{k}: n={len(v)} total={sum(v):.1f}ms "
                         f"mean={np.mean(v):.2f}ms")
        return "\n".join(lines)


class TrainingMaster:
    """SPI (parity: TrainingMaster): how a dataset is partitioned over the
    workers and how their replicas are kept in sync."""

    def __init__(self):
        self.stats: Optional[TrainingStats] = None

    def set_collect_training_stats(self, flag: bool):
        self.stats = TrainingStats() if flag else None
        return self

    def get_training_stats(self) -> Optional[TrainingStats]:
        return self.stats

    def execute_training(self, net, data):
        raise NotImplementedError

    def _timed(self, key, fn):
        if self.stats is None:
            return fn()
        with self.stats.time(key):
            return fn()


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous parameter averaging (parity:
    ParameterAveragingTrainingMaster) through ``ParallelWrapper``."""

    def __init__(self, batch_size_per_worker: int = 16,
                 averaging_frequency: int = 1,
                 workers: Optional[int] = None,
                 mesh=None, repartition_data: bool = True):
        super().__init__()
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = averaging_frequency
        self.workers = workers
        self.mesh = mesh
        self.repartition_data = repartition_data
        self._pw: Optional[ParallelWrapper] = None

    def _wrapper(self, net):
        if self._pw is None or self._pw.model is not net:
            self._pw = ParallelWrapper(
                net, workers=self.workers, mesh=self.mesh,
                averaging_frequency=self.averaging_frequency)
        return self._pw

    def execute_training(self, net, data):
        pw = self._wrapper(net)
        if self.repartition_data and self.batch_size_per_worker:
            from deeplearning4j_tpu_torch.scaleout.cluster import repartition

            def cut():
                out = repartition(list(data),
                                  self.batch_size_per_worker * pw.n_devices)
                if pw.world > 1:
                    out = [b._rows(local_batch_slice(b.num_examples()))
                           for b in out]
                return out
            data = self._timed("repartition", cut)
        self._timed("fit", lambda: pw.fit(data))
        return net


def _order(net):
    """(member, key) of every parameter in ``ravel_pytree`` order."""
    items = (sorted(net.params.items(), key=lambda kv: pytree_key(kv[0]))
             if isinstance(net.params, dict)
             else list(enumerate(net.params)))
    return [(m, k) for m, p in items for k in sorted(p, key=pytree_key)]


def _vector(net, tree, order) -> torch.Tensor:
    t = dict(tree.items()) if isinstance(tree, dict) else dict(
        enumerate(tree))
    return torch.cat([t[m][k].reshape(-1).float() for m, k in order])


@torch.no_grad()
def _set_vector(net, vec, order) -> None:
    """Write ``vec`` into the network's parameter tensors in place."""
    p = dict(net.params.items()) if isinstance(net.params, dict) else dict(
        enumerate(net.params))
    off = 0
    for m, k in order:
        t = p[m][k]
        t.copy_(vec[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    net._params_version += 1


def _learning_rate(net, lr):
    if lr is not None:
        return lr
    return getattr(net.conf.global_conf.updater, "learning_rate", 0.01)


def _gradient(net, order, vec, features, labels):
    """(loss, gradient vector) of ``net``'s loss (l1/l2 included, no
    masks, no dropout, no state written) at parameters ``vec``."""
    _set_vector(net, vec, order)
    if isinstance(net.params, dict):
        loss, g, _ = net._gradients(
            [net._as_input(a) for a in features],
            [net._as_input(a) for a in labels])
    else:
        loss, g, _ = net._gradients(net._as_input(features[0]),
                                    net._as_input(labels[0]))
    return loss, _vector(net, g, order)


def _arrays(ds):
    """(features list, labels list) of a DataSet, MultiDataSet or
    (x, y)."""
    if isinstance(ds, MultiDataSet):
        return ds.features, ds.labels
    if not isinstance(ds, DataSet):
        ds = DataSet(*ds)
    return [ds.features], [ds.labels]


class SharedTrainingMaster(TrainingMaster):
    """Gradient sharing with threshold encoding (parity:
    SharedTrainingMaster with its WiredEncodingHandler; module
    docstring)."""

    def __init__(self, threshold: float = 1e-3, min_threshold: float = 1e-5,
                 threshold_step: float = 1e-5, shake_frequency: int = 0,
                 workers: int = 2, batch_size_per_worker: int = 16,
                 learning_rate: Optional[float] = None, mesh=None,
                 capacity_fraction: float = 0.05):
        super().__init__()
        self.threshold = threshold
        self.min_threshold = min_threshold
        self.threshold_step = threshold_step
        self.shake_frequency = shake_frequency
        self.workers = workers
        self.batch_size_per_worker = batch_size_per_worker
        self.learning_rate = learning_rate
        self.mesh = mesh
        self.capacity_fraction = capacity_fraction
        self._net = None
        self._acc: Optional[EncodedGradientsAccumulator] = None
        self._order = None
        self._residuals = None
        self._thresholds = None

    def _setup(self, net):
        self._net = net
        self._order = _order(net)
        n = int(_vector(net, net.params, self._order).numel())
        # the handlers' default capacity fraction, as in JAX
        self._acc = EncodedGradientsAccumulator(
            self.workers, n, threshold=self.threshold,
            min_threshold=self.min_threshold,
            threshold_step=self.threshold_step,
            shake_frequency=self.shake_frequency)

    # ------------------------------------------------- collective exchange
    def execute_training_collective(self, net, data):
        """Every mesh slot a worker (module docstring): the data re-cut
        into global batches of ``batch_size_per_worker`` x slots (a short
        last one dropped), slot g training rows [g b, (g + 1) b) of each."""
        from deeplearning4j_tpu_torch.scaleout.cluster import repartition
        mesh = self.mesh
        rank, _ = topology()
        local = mesh.local_slots(rank)
        first = mesh.slots.index(local[0])
        n_dev = mesh.devices.size
        if self._residuals is None or self._net is not net:
            self._net = net
            self._order = _order(net)
            n = int(_vector(net, net.params, self._order).numel())
            # per-slot Strom state, carried across calls
            self._residuals = torch.zeros((len(local), n),
                                          dtype=torch.float32,
                                          device=net.device)
            self._thresholds = torch.full((len(local),), float(
                self.threshold), dtype=torch.float32, device=net.device)
        order = self._order
        n = int(self._residuals.shape[1])
        capacity = max(1, min(n, int(n * self.capacity_fraction)))
        lr = _learning_rate(net, self.learning_rate)
        bpw = self.batch_size_per_worker
        batches = repartition([ds if isinstance(ds, DataSet)
                               else DataSet(*ds) for ds in data],
                              bpw * n_dev)
        full = [b for b in batches if b.features.shape[0] == bpw * n_dev]
        if not full:
            raise ValueError(
                f"not enough data for one global batch of {bpw * n_dev}")
        grouped = dist.is_available() and dist.is_initialized()
        vec = _vector(net, net.params, order)
        loss_sum = torch.zeros((), dtype=torch.float32, device=net.device)
        for b in full:
            total = torch.zeros(n, dtype=torch.float32, device=net.device)
            for j in range(len(local)):
                sl = slice((first + j) * bpw, (first + j + 1) * bpw)
                loss, g = _gradient(net, order, vec, [b.features[sl]],
                                    [b.labels[sl]])
                u = lr * g + self._residuals[j]
                thr = self._thresholds[j]
                idx, vals, count = threshold_encode(u, thr, capacity)
                msg = threshold_decode(idx, vals, n)
                self._residuals[j] = u - msg
                total += msg
                self._thresholds[j] = adapt_threshold_tensor(
                    thr, count, capacity, step=self.threshold_step,
                    min_threshold=self.min_threshold)
                loss_sum += loss.float()
            if grouped:
                dist.all_reduce(total)
            vec = vec - total
        thr_sum = self._thresholds.sum()
        if grouped:
            dist.all_reduce(loss_sum)
            dist.all_reduce(thr_sum)
        self.threshold = float(thr_sum) / n_dev        # summary only
        _set_vector(net, vec, order)
        net.iteration += len(full)
        net._score = loss_sum / (n_dev * len(full))
        return net

    def execute_training(self, net, data):
        """Logical workers, round-robin over the minibatches (module
        docstring); with a ``mesh``, ``execute_training_collective``."""
        if self.mesh is not None:
            return self.execute_training_collective(net, data)
        if self._acc is None or self._net is not net:
            self._setup(net)
        order = self._order
        lr = _learning_rate(net, self.learning_rate)
        if self.batch_size_per_worker:
            from deeplearning4j_tpu_torch.scaleout.cluster import repartition
            data = repartition(list(data), self.batch_size_per_worker)
        vec0 = _vector(net, net.params, order)
        replicas = [vec0] * self.workers
        w = 0
        losses = []
        for ds in data:
            xs, ys = _arrays(ds)
            loss, g = _gradient(net, order, replicas[w], xs, ys)
            losses.append(float(loss))
            self._acc.store_update(w, lr * g)
            # this worker's queue: every message lands once a replica
            replicas[w] = replicas[w] - self._acc.apply_update(w)
            w = (w + 1) % self.workers
            net.iteration += 1
        # flush the queues so every replica has every update, then the
        # average goes back to the network
        for w2 in range(self.workers):
            replicas[w2] = replicas[w2] - self._acc.apply_update(w2)
        _set_vector(net, sum(replicas) / self.workers, order)
        net._score = float(np.mean(losses)) if losses else float("nan")
        return net
