"""Brute-force exact kNN on the device.

Counterpart of deeplearning4j_tpu/clustering/knn.py: one (Q, N) distance
matrix through one matrix product (``|a-b|^2 = |a|^2 + |b|^2 - 2 a.b``, or
``1 - cos`` for cosine), with the same expressions as the JAX package's,
then the k smallest per row. The corpus lives on ``device`` (the card
unless the caller asks for the CPU); queries go in row chunks that bound
the distance matrix's memory.

The order among equal distances is the JAX package's (``lax.top_k`` puts
the lower index first): each distance's order-preserving integer bits and
its column index form one int64 key, and the k smallest keys are taken,
so ties resolve by index on every device (``torch.topk`` on floats
promises no such order, and which of several tied candidates at the k-th
place it keeps).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import resolve_device

# distance-matrix elements per query chunk (int64 keys: 8 bytes each)
CHUNK_ELEMENTS = 1 << 27


def _distances(corpus, queries, metric):
    if metric == "cosine":
        c = corpus / torch.clamp(
            torch.linalg.vector_norm(corpus, dim=1, keepdim=True), min=1e-12)
        q = queries / torch.clamp(
            torch.linalg.vector_norm(queries, dim=1, keepdim=True),
            min=1e-12)
        return 1.0 - q @ c.T
    cn = (corpus ** 2).sum(1)
    qn = (queries ** 2).sum(1)
    d = qn[:, None] + cn[None, :] - 2.0 * (queries @ corpus.T)
    return torch.clamp(d, min=0.0)


def smallest_k(d: torch.Tensor, k: int):
    """The k smallest entries of each row of float32 ``d`` in ascending
    (value, column) order: (indices int64, values)."""
    d = d + 0.0                          # -0.0 -> +0.0: they compare equal
    bits = d.view(torch.int32)
    # negative floats: flip the magnitude bits so the integers order as
    # the floats do
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(d.shape[1], device=d.device, dtype=torch.int64)
    keys = (bits.to(torch.int64) << 32) | cols
    idx = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    idx = idx & 0xFFFFFFFF
    return idx, torch.gather(d, 1, idx)


class NearestNeighbors:
    def __init__(self, corpus, metric: str = "euclidean", device=None):
        self.device = resolve_device(device)
        self.corpus = torch.as_tensor(
            np.asarray(corpus, np.float32)).to(self.device)
        self.metric = metric

    def knn(self, queries, k: int):
        """queries: (Q, D) or (D,). Returns (indices (Q, k), distances (Q,
        k)) as host arrays; euclidean distances are true (sqrt'd)
        distances."""
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        qt = torch.as_tensor(q).to(self.device)
        rows = max(1, CHUNK_ELEMENTS // max(1, self.corpus.shape[0]))
        idx, dist = [], []
        with torch.no_grad():
            for s in range(0, qt.shape[0], rows):
                d = _distances(self.corpus, qt[s:s + rows], self.metric)
                i, v = smallest_k(d, k)
                idx.append(i.to(torch.int32))
                dist.append(v)
            idx = torch.cat(idx).cpu().numpy()
            d = torch.cat(dist).cpu().numpy()
        if self.metric != "cosine":
            d = np.sqrt(d)
        return (idx[0], d[0]) if single else (idx, d)
