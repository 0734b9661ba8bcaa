"""KMeans clustering.

Counterpart of deeplearning4j_tpu/clustering/kmeans.py (parity surface:
the reference's KMeansClustering). The k-means++ initialisation runs on
the host with numpy's ``RandomState``, as in the JAX package; each Lloyd
step runs on ``device`` (the card unless the caller asks for the CPU): the
same direct-difference distance as the JAX package's (not the expanded
norm form, which moves near-ties), ``argmin`` (the first minimum), a
one-hot centroid sum through one matrix product. The points go in row
chunks that bound the (rows, k, D) difference tensor. The convergence
test reads each step's cost on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import resolve_device

# elements of one chunk's (rows, k, D) difference tensor
CHUNK_ELEMENTS = 1 << 26


def _lloyd_step(points, centroids, k):
    n, dim = points.shape
    rows = max(1, CHUNK_ELEMENTS // max(1, k * dim))
    assign, dmin = [], []
    for s in range(0, n, rows):
        p = points[s:s + rows]
        d = ((p[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        m, a = d.min(1)               # a: the first minimum, as argmin
        assign.append(a)
        dmin.append(m)
    assign = torch.cat(assign)
    onehot = torch.nn.functional.one_hot(assign, k).to(points.dtype)
    counts = onehot.sum(0)
    sums = onehot.T @ points
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts[:, None], min=1.0),
                                centroids)
    cost = torch.cat(dmin).sum()
    return new_centroids, assign, cost


class KMeansClustering:
    """k-means with k-means++ init (parity: KMeansClustering.setup)."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-6,
                 seed: int = 123, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.assignments: Optional[np.ndarray] = None
        self.cost = float("inf")
        self.iterations = 0

    def _init_pp(self, pts, rng):
        """k-means++ (numpy's ``RandomState``, the JAX package's draws).
        Each point's squared distance to its nearest chosen centre is kept
        and lowered by the newest centre's only: the same values as the
        JAX package's recomputation over all chosen centres (a minimum is
        exact, each centre's row sums the same way), in O(n k D)."""
        n = len(pts)
        centroids = [pts[rng.randint(n)]]
        d2 = None
        for _ in range(1, self.k):
            new = ((pts - centroids[-1]) ** 2).sum(-1)
            d2 = new if d2 is None else np.minimum(d2, new)
            probs = d2 / max(d2.sum(), 1e-12)
            centroids.append(pts[rng.choice(n, p=probs)])
        return np.asarray(centroids, np.float32)

    def apply_to(self, points):
        pts = np.asarray(points, np.float32)
        rng = np.random.RandomState(self.seed)
        centroids = torch.as_tensor(self._init_pp(pts, rng)).to(self.device)
        pts_t = torch.as_tensor(pts).to(self.device)
        prev_cost = np.inf
        with torch.no_grad():
            for it in range(self.max_iterations):
                centroids, assign, cost = _lloyd_step(pts_t, centroids,
                                                      self.k)
                cost = float(cost)
                self.iterations = it + 1
                if abs(prev_cost - cost) < self.tol * max(abs(prev_cost),
                                                          1.0):
                    break
                prev_cost = cost
        self.centroids = centroids.cpu().numpy()
        self.assignments = assign.cpu().numpy()
        self.cost = cost
        return self

    def predict(self, points):
        pts = np.asarray(points, np.float32)
        d = ((pts[:, None, :] - self.centroids[None]) ** 2).sum(-1)
        return d.argmin(1)
