"""Device-resident input prefetch.

Counterpart of deeplearning4j_tpu/data/prefetcher.py: ``DevicePrefetcher``
keeps up to ``depth`` items of an upstream iterator already moved onto the
device ahead of their consumption, so the host-to-device copy of item k+1
is in flight while the step on item k runs. There is no thread, as in the
JAX package: the overlap comes from asynchronous copies.

On the card each numpy leaf goes through pinned host memory and is copied
with ``non_blocking=True`` on the executor's copy stream (one side
``torch.cuda.Stream`` per card, kept across epochs), after which an event
is recorded. ``__next__`` makes the consumer's current stream wait
on the item's event before it hands the item out (so a train step, or the
copy into a captured graph's static inputs, reads the finished copy) and
marks each tensor as used on that stream (``record_stream``), so the
allocator does not reuse its memory while the consumer's work on it is in
flight. On the CPU the leaves become CPU tensors and there is no stream.

Items may be DataSets, MultiDataSets, tuples, lists or dicts of arrays,
nested; every numpy leaf is staged and anything else rides through. The
optional ``timer`` (a ``util.timing.PipelineTimer``) receives each
staging's host time as the ``h2d`` stage.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import (DataSet, MultiDataSet,
                                                   host_tensor)
from deeplearning4j_tpu_torch.exec import get_executor
from deeplearning4j_tpu_torch.monitor.tracing import trace
from deeplearning4j_tpu_torch.ops import resolve_device


def _map_leaves(item, fn):
    """``item`` with ``fn`` applied to every numpy array leaf."""
    if isinstance(item, DataSet):
        return DataSet(*(_map_leaves(a, fn) for a in (
            item.features, item.labels, item.features_mask,
            item.labels_mask)))
    if isinstance(item, MultiDataSet):
        return MultiDataSet(*(_map_leaves(a, fn) for a in (
            item.features, item.labels, item.features_masks,
            item.labels_masks)))
    if isinstance(item, (tuple, list)):
        return type(item)(_map_leaves(x, fn) for x in item)
    if isinstance(item, dict):
        return {k: _map_leaves(v, fn) for k, v in item.items()}
    if isinstance(item, (np.ndarray, np.generic)):
        return fn(item)
    return item


def _tensors(item, out):
    if isinstance(item, torch.Tensor):
        out.append(item)
    elif isinstance(item, (DataSet, MultiDataSet)):
        _tensors(list(vars(item).values()), out)
    elif isinstance(item, (tuple, list)):
        for x in item:
            _tensors(x, out)
    elif isinstance(item, dict):
        _tensors(list(item.values()), out)
    return out


class DevicePrefetcher:
    """Iterator adapter that stages up to ``depth`` upstream items on
    ``device`` (default: the CUDA device, as the containers' entry points)
    ahead of consumption. ``__next__`` returns the oldest staged item and
    tops the buffer back up before returning, so the next item's copy is
    already queued when the caller runs its step. ``transform`` applies to
    each staged item (on the side stream on the card)."""

    def __init__(self, source, depth: int = 2, device=None, transform=None,
                 timer=None):
        self.source = source
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self.transform = transform
        self.timer = timer
        self._it = None
        self._buf = deque()
        self._exhausted = False
        self._stream = (get_executor().copy_stream(self.device)
                        if self.device.type == "cuda" else None)

    @property
    def buffered(self) -> int:
        """Items staged on the device now (>= 1 mid-stream is the overlap
        invariant)."""
        return len(self._buf)

    def __iter__(self):
        if hasattr(self.source, "reset"):
            self.source.reset()
        self._it = iter(self.source)
        self._buf.clear()
        self._exhausted = False
        return self

    def _stage(self, item):
        """(staged item, event or None): on the card the copies and the
        transform are queued on the side stream, and the event follows
        them."""
        if self._stream is None:
            staged = _map_leaves(item, host_tensor)
            if self.transform is not None:
                staged = self.transform(staged)
            return staged, None
        with torch.cuda.stream(self._stream):
            staged = _map_leaves(item, lambda a: host_tensor(a).pin_memory()
                                 .to(self.device, non_blocking=True))
            if self.transform is not None:
                staged = self.transform(staged)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _fill(self):
        while len(self._buf) < self.depth and not self._exhausted:
            try:
                item = next(self._it)
            except StopIteration:
                self._exhausted = True
                break
            t1 = time.perf_counter()
            with trace.span("h2d"):
                staged = self._stage(item)
            # upstream stages time themselves; only the staging is this
            # stage's own cost
            if self.timer is not None:
                self.timer.add("h2d", time.perf_counter() - t1)
            self._buf.append(staged)

    def __next__(self):
        if self._it is None:
            self.__iter__()
        if not self._buf:
            self._fill()
        if not self._buf:
            raise StopIteration
        item, event = self._buf.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _tensors(item, []):
                if t.is_cuda:
                    t.record_stream(consumer)
        # top up before returning: the next item's copy is queued before
        # the caller's step on this one
        self._fill()
        return item
