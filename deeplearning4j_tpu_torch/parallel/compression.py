"""Threshold-encoded sparse gradient compression.

Counterpart of deeplearning4j_tpu/parallel/compression.py (the
Strom-2015 scheme of the reference's EncodingHandler and
EncodedGradientsAccumulator): ``adapt_threshold`` and its tensor twin
``adapt_threshold_tensor``, ``threshold_encode`` / ``threshold_decode``,
``EncodingHandler`` and ``EncodedGradientsAccumulator``, as plain tensor
code on any device (the JAX package writes no Pallas kernel here).

A message has a fixed capacity: the top ``capacity`` entries of |g| that
reach the threshold, as (indices int32[capacity], values f32[capacity],
count), unused slots index -1 and value 0. The value sent is
sign * threshold, and the handler carries the rest as a residual added
to the next gradient.
"""

from __future__ import annotations

from typing import Optional

import torch


def adapt_threshold(threshold, count, capacity, *, step, min_threshold):
    """The EncodingHandler policy: saturated (count >= capacity) raises the
    threshold one step; sparse (count < capacity // 4) decays it one step
    toward the floor; otherwise unchanged."""
    if count >= capacity:
        return threshold + step
    if count < capacity // 4:
        return max(min_threshold, threshold - step)
    return threshold


def adapt_threshold_tensor(threshold, count, capacity, *, step,
                           min_threshold):
    """``adapt_threshold`` on tensors (``capacity`` a Python int), without
    a host read: the JAX package's ``adapt_threshold_jnp``."""
    step = torch.as_tensor(step, dtype=threshold.dtype,
                           device=threshold.device)
    floor = torch.as_tensor(min_threshold, dtype=threshold.dtype,
                            device=threshold.device)
    return torch.where(
        count >= capacity, threshold + step,
        torch.where(count < capacity // 4,
                    torch.maximum(floor, threshold - step), threshold))


def threshold_encode(grad, threshold, capacity):
    """Encode the entries with |g| >= threshold, at most ``capacity`` of
    them (largest first). Returns (indices int32[capacity], values
    f32[capacity], count int32)."""
    flat = grad.reshape(-1)
    v, idx = torch.topk(flat.abs(), int(capacity))
    keep = v >= threshold
    count = keep.sum(dtype=torch.int32)
    vals = torch.where(keep, torch.sign(flat[idx]) * threshold,
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    idx = torch.where(keep, idx, torch.full_like(idx, -1))
    return idx.to(torch.int32), vals.to(torch.float32), count


def threshold_decode(indices, values, n):
    """The dense f32[n] vector of an encoded message."""
    valid = indices >= 0
    safe = torch.where(valid, indices, torch.zeros_like(indices)).long()
    vals = torch.where(valid, values, torch.zeros_like(values))
    return torch.zeros(int(n), dtype=torch.float32,
                       device=values.device).index_add_(0, safe, vals)


def ravel(tree) -> torch.Tensor:
    """A tensor, or a container's per-member dicts (a list, or a dict by
    node name), as one float32 vector in the JAX package's pytree order
    (``ravel_pytree``: dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape(-1).float()
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


def pytree_key(key):
    """The sort key of a dict key in pytree order: a path key (``fwd/W``,
    the port's flattening of a nested dict) sorts as the nested dicts'
    keys do."""
    return tuple(str(key).split("/"))


def tree_leaves(tree):
    """The tensors of ``tree`` (nested lists and dicts) in pytree order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=pytree_key)
                for t in tree_leaves(tree[k])]
    return [t for sub in tree for t in tree_leaves(sub)]


class EncodingHandler:
    """Stateful encoder with the residual carry and the adaptive threshold
    (parity: EncodingHandler's threshold decay and periodic "shake")."""

    def __init__(self, threshold: float = 1e-3, min_threshold: float = 1e-5,
                 threshold_step: float = 1e-5, shake_frequency: int = 0,
                 capacity_fraction: float = 0.1):
        self.threshold = float(threshold)
        self.min_threshold = float(min_threshold)
        self.threshold_step = float(threshold_step)
        self.shake_frequency = int(shake_frequency)
        self.capacity_fraction = float(capacity_fraction)
        self.residual: Optional[torch.Tensor] = None
        self.iteration = 0

    def _capacity(self, n):
        return max(1, min(n, int(n * self.capacity_fraction)))

    def encode(self, grad):
        """``grad``: a tensor or a tree of them, raveled. Returns
        (indices, values, count); the unsent remainder stays as the
        residual."""
        flat = ravel(grad)
        if self.residual is not None:
            flat = flat + self.residual
        cap = self._capacity(flat.shape[0])
        idx, vals, count = threshold_encode(flat, self.threshold, cap)
        sent = threshold_decode(idx, vals, flat.shape[0])
        self.residual = flat - sent
        self._adapt(int(count), cap)
        self.iteration += 1
        return idx, vals, count

    def _adapt(self, count, cap):
        self.threshold = adapt_threshold(
            self.threshold, count, cap, step=self.threshold_step,
            min_threshold=self.min_threshold)
        if (self.shake_frequency and self.iteration > 0
                and self.iteration % self.shake_frequency == 0):
            self.threshold = max(self.min_threshold, self.threshold * 0.5)

    def reset(self):
        self.residual = None
        self.iteration = 0


class EncodedGradientsAccumulator:
    """In-process exchange of encoded updates between workers: each
    worker stores its message into every worker's queue, and each applies
    the sum of its queue (synchronous store-all, apply-all)."""

    def __init__(self, n_workers: int, n_params: int, **handler_kwargs):
        self.n_workers = n_workers
        self.n_params = n_params
        self.handlers = [EncodingHandler(**handler_kwargs)
                         for _ in range(n_workers)]
        self._pending = [[] for _ in range(n_workers)]

    def store_update(self, worker: int, grad):
        """Encode ``worker``'s gradient and queue it for every worker."""
        msg = self.handlers[worker].encode(grad)
        for w in range(self.n_workers):
            self._pending[w].append(msg)
        return msg

    def apply_update(self, worker: int):
        """The sum of ``worker``'s queued messages, decoded (a dense
        f32[n_params] vector); empties its queue."""
        dense = None
        for idx, vals, _ in self._pending[worker]:
            d = threshold_decode(idx, vals, self.n_params)
            dense = d if dense is None else dense + d
        self._pending[worker] = []
        if dense is None:
            dev = self.handlers[worker].residual
            dense = torch.zeros(self.n_params, dtype=torch.float32,
                                device=None if dev is None else dev.device)
        return dense
