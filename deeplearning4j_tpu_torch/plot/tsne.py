"""t-SNE embedding.

Counterpart of deeplearning4j_tpu/plot/tsne.py (parity surface: the
reference's plot/Tsne and plot/BarnesHutTsne). ``Tsne`` is exact: the
pairwise distances, the perplexity search (a 50-step bisection of each
row's precision, all rows at once), the gradient and the momentum updates
run on ``device`` (the card unless the caller asks for the CPU) with the
JAX package's expressions. ``BarnesHutTsne`` computes its kNN graph and
``P`` on the device and runs its SpTree repulsion loop on the host, as the
JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import resolve_device


def _pairwise_sq_dists(x):
    n2 = (x ** 2).sum(1)
    d = n2[:, None] + n2[None, :] - 2.0 * (x @ x.T)
    return torch.clamp(d, min=0.0)


def _log_perplexity(perplexity: float, device) -> torch.Tensor:
    return torch.log(torch.tensor(perplexity, dtype=torch.float32,
                                  device=device))


def _perplexity_probs(d2, log_perp):
    """Binary-search each row's precision beta so the row's entropy is
    log(perplexity), all rows at once; 50 bisection steps."""
    n = d2.shape[0]
    d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * 1e12

    def row_probs(beta):
        p = torch.exp(-d2 * beta[:, None])
        psum = p.sum(1, keepdim=True)
        return p / torch.clamp(psum, min=1e-30)

    def entropy(beta):
        p = row_probs(beta)
        return -(p * torch.log(torch.clamp(p, min=1e-30))).sum(1)

    lo = torch.full((n,), -math.inf, device=d2.device)
    hi = torch.full((n,), math.inf, device=d2.device)
    beta = torch.ones((n,), device=d2.device)
    for _ in range(50):
        too_high = entropy(beta) > log_perp  # entropy too high: raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2,
                           torch.where(torch.isinf(lo), beta / 2,
                                       (lo + hi) / 2))
    return row_probs(beta)


def _tsne_grad(y, P):
    d2 = _pairwise_sq_dists(y)
    n = y.shape[0]
    q_num = 1.0 / (1.0 + d2)
    q_num = q_num * (1.0 - torch.eye(n, dtype=y.dtype, device=y.device))
    Q = q_num / torch.clamp(q_num.sum(), min=1e-30)
    PQ = (P - torch.clamp(Q, min=1e-30)) * q_num
    grad = 4.0 * ((torch.diag(PQ.sum(1)) - PQ) @ y)
    kl = (P * torch.log(torch.clamp(P, min=1e-30)
                        / torch.clamp(Q, min=1e-30))).sum()
    return grad, kl


class Tsne:
    """Exact t-SNE on the device (parity: plot/Tsne API)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 max_iter: int = 500, learning_rate: float = 200.0,
                 momentum: float = 0.8, early_exaggeration: float = 12.0,
                 exaggeration_iters: int = 100, seed: int = 123,
                 device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.seed = seed
        self.device = resolve_device(device)
        self.embedding: Optional[np.ndarray] = None
        self.kl: float = float("nan")

    def _p_matrix(self, x):
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
            P = _perplexity_probs(_pairwise_sq_dists(x),
                                  _log_perplexity(self.perplexity,
                                                  self.device))
            P = (P + P.T) / (2.0 * P.shape[0])
            return torch.clamp(P, min=1e-12)

    def fit(self, x):
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        P = self._p_matrix(x)
        rng = np.random.RandomState(self.seed)
        y = torch.as_tensor(rng.randn(n, self.n_components)
                            .astype(np.float32) * 1e-2).to(self.device)
        vel = torch.zeros_like(y)
        kl = None
        with torch.no_grad():
            for it in range(self.max_iter):
                Pc = P * self.early_exaggeration \
                    if it < self.exaggeration_iters else P
                grad, kl = _tsne_grad(y, Pc)
                mom = 0.5 if it < 20 else self.momentum
                vel = mom * vel - self.learning_rate * grad
                y = y + vel
                y = y - y.mean(0)
        self.embedding = y.cpu().numpy()
        self.kl = float("nan") if kl is None else float(kl)
        return self.embedding

    fit_transform = fit

    def plot(self, x=None):
        if self.embedding is None and x is not None:
            self.fit(x)
        return self.embedding


class BarnesHutTsne(Tsne):
    """Barnes-Hut approximate t-SNE (parity: plot/BarnesHutTsne). theta=0
    runs the exact device path."""

    def __init__(self, theta: float = 0.5, **kwargs):
        kwargs.setdefault("max_iter", 300)
        super().__init__(**kwargs)
        self.theta = theta

    def fit(self, x):
        if self.theta <= 0:
            return super().fit(x)
        from deeplearning4j_tpu_torch.clustering.trees import SpTree
        from deeplearning4j_tpu_torch.clustering.knn import NearestNeighbors

        x = np.asarray(x, np.float32)
        n = x.shape[0]
        k = min(n - 1, int(3 * self.perplexity))
        nn = NearestNeighbors(x, device=self.device)
        idx, _ = nn.knn(x, k + 1)
        # sparse P from the kNN graph (the perplexity search on the device)
        with torch.no_grad():
            xt = torch.as_tensor(x).to(self.device)
            Pcond = _perplexity_probs(
                _pairwise_sq_dists(xt),
                _log_perplexity(self.perplexity, self.device)).cpu().numpy()
        mask = np.zeros((n, n), bool)
        for i in range(n):
            mask[i, idx[i, 1:]] = True
        Pcond = Pcond * mask
        P = (Pcond + Pcond.T)
        P /= max(P.sum(), 1e-12)
        P = np.maximum(P, 1e-12)

        rng = np.random.RandomState(self.seed)
        y = rng.randn(n, self.n_components) * 1e-2
        vel = np.zeros_like(y)
        rows, cols = P.nonzero()
        pvals = P[rows, cols]
        for it in range(self.max_iter):
            ex = self.early_exaggeration if it < self.exaggeration_iters \
                else 1.0
            tree = SpTree(y)
            # attractive forces over the sparse edges
            diff = y[rows] - y[cols]
            q = 1.0 / (1.0 + (diff ** 2).sum(1))
            att = np.zeros_like(y)
            w = (ex * pvals * q)[:, None] * diff
            np.add.at(att, rows, w)
            # repulsive forces through Barnes-Hut
            rep = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                neg, sq = tree.compute_non_edge_forces(y[i], self.theta)
                rep[i] = neg
                sum_q += sq
            grad = 4.0 * (att - rep / max(sum_q, 1e-12))
            mom = 0.5 if it < 20 else self.momentum
            vel = mom * vel - self.learning_rate * grad
            y = y + vel
            y = y - y.mean(0)
        self.embedding = y.astype(np.float32)
        return self.embedding
