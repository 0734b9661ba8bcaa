"""Shape-bucketed inference.

Counterpart of deeplearning4j_tpu/serving/engine.py. Every batch is padded
up to a power-of-two bucket, run, and the pad rows sliced off: inference
computes each output row from its own input row alone, so padding does
not change the answer. In the JAX package the ladder bounds the number of
compiled programs; here it bounds the batch shapes the kernels see, so a
traffic mix of odd request sizes becomes a few fixed launch shapes.
Batches above ``max_batch`` are chunked through the top bucket.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import host_tensor
from deeplearning4j_tpu_torch.resilience.errors import WeightSwapError


def input_type_of(model):
    """The model's declared input type: ``conf.input_types[0]`` for a
    ComputationGraph, ``conf.input_type`` for a MultiLayerNetwork (None
    when the configuration declares none)."""
    conf = model.conf
    if hasattr(conf, "network_inputs"):
        return conf.input_types[0] if conf.input_types else None
    return conf.input_type


def leaves_by_path(tree, prefix=""):
    """``{path: leaf}`` of a tree of dicts and lists of tensors or numpy
    arrays, paths as the checkpoint's (``0/W``; a nested ``{"fwd": {"W":
    w}}`` and a flat ``{"fwd/W": w}`` give the same ``0/fwd/W``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves_by_path(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _tree_signature(tree):
    """Flattened ``{path: (shape, dtype)}``: the swap compatibility key."""
    return {k: (tuple(v.shape), str(torch.as_tensor(v).dtype))
            for k, v in leaves_by_path(tree).items()}


def validate_swap(current, candidate, what: str = "params") -> None:
    """Reject a hot-swap candidate whose tree does not match the live
    weights array for array (path set, shapes, dtypes), before any engine
    state is touched: a rejected swap is a no-op."""
    cur, new = _tree_signature(current), _tree_signature(candidate)
    problems = []
    for key in sorted(set(cur) - set(new)):
        problems.append(f"missing array {key!r}")
    for key in sorted(set(new) - set(cur)):
        problems.append(f"unexpected array {key!r}")
    for key in sorted(set(cur) & set(new)):
        if cur[key] != new[key]:
            problems.append(
                f"{key!r} expected {cur[key][0]}/{cur[key][1]}, "
                f"got {new[key][0]}/{new[key][1]}")
    if problems:
        raise WeightSwapError(
            f"candidate {what} incompatible with live weights", problems)


def bucket_for(n: int, max_batch: int, min_bucket: int = 1) -> int:
    """Smallest power-of-two rung >= n (capped at max_batch)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    b = max(min_bucket, 1)
    while b < n:
        b <<= 1
    return min(b, max_batch)


def bucket_ladder(max_batch: int, min_bucket: int = 1) -> List[int]:
    """The full ladder [min_bucket, 2*min_bucket, ..., max_batch]."""
    out = []
    b = max(min_bucket, 1)
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(max_batch)
    return out


class InferenceEngine:
    """Bucketed inference over a MultiLayerNetwork or a single-input,
    single-output ComputationGraph (both take ``_forward(params, x)`` and
    return the output first). Parameters are read from the model at call
    time."""

    def __init__(self, model, max_batch: int = 1024):
        self.model = model
        self.max_batch = int(max_batch)
        self._lock = threading.Lock()
        self._rows = 0
        self._pad_rows = 0
        self._calls = 0
        self._buckets = set()

    def _dispatch(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        n = x.shape[0]
        if n > self.max_batch:
            return torch.cat([
                self._dispatch(x[i:i + self.max_batch],
                               None if mask is None
                               else mask[i:i + self.max_batch])
                for i in range(0, n, self.max_batch)])
        b = bucket_for(n, self.max_batch)
        if b > n:
            x = torch.cat([x, x.new_zeros((b - n,) + tuple(x.shape[1:]))])
            if mask is not None:
                mask = torch.cat([mask, mask.new_zeros(
                    (b - n,) + tuple(mask.shape[1:]))])
        kw = {} if mask is None else {"mask": mask}
        out, _ = self.model._forward(self.model.params, x, **kw)
        with self._lock:
            self._rows += n
            self._pad_rows += b - n
            self._calls += 1
            self._buckets.add(b)
        return out[:n]

    @torch.no_grad()
    def predict(self, x, mask=None) -> torch.Tensor:
        """Bucketed forward of one batch (``mask``: a MultiLayerNetwork's
        (B, T) feature mask, padded with zero rows); returns the output
        on the model's device, shaped like ``model.output(x,
        bucketed=False)``."""
        if not isinstance(x, torch.Tensor):
            x = host_tensor(x)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask)) if not isinstance(
                mask, torch.Tensor) else mask
            mask = mask.to(self.model.device)
        return self._dispatch(x.to(self.model.device), mask)

    def predict_host(self, x) -> np.ndarray:
        """``predict`` + host read (float32 numpy)."""
        return self.predict(x).float().cpu().numpy()

    def stats(self) -> dict:
        with self._lock:
            rows, pad = self._rows, self._pad_rows
            return {"max_batch": self.max_batch,
                    "bucket_ladder": bucket_ladder(self.max_batch),
                    "buckets_used": sorted(self._buckets),
                    "device_calls": self._calls,
                    "rows": rows,
                    "pad_rows": pad,
                    "pad_waste_frac": pad / (pad + rows) if rows else 0.0}
