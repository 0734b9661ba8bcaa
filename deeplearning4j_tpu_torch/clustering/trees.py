"""Spatial trees: VPTree, KDTree, QuadTree, SpTree (Barnes-Hut).

Counterpart of deeplearning4j_tpu/clustering/trees.py (parity surface: the
reference's nearestneighbor-core VPTree, KDTree, QuadTree and SpTree). The
trees are host numpy in both packages, so this is the same code: exact kNN
on the card is the batched distance product of knn.py; the trees serve
``NearestNeighborsServer(use_device=False)`` and Barnes-Hut t-SNE's
repulsion (SpTree).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class VPTree:
    """Vantage-point tree over an (N, D) matrix (parity: VPTree.java).
    Metrics: 'euclidean' | 'cosine' (cosine converted to distance)."""

    def __init__(self, points: np.ndarray, distance: str = "euclidean",
                 leaf_size: int = 16, seed: int = 123):
        self.points = np.asarray(points, np.float64)
        self.distance = distance
        self.leaf_size = leaf_size
        self._rng = np.random.RandomState(seed)
        if distance == "cosine":
            norms = np.maximum(np.linalg.norm(self.points, axis=1,
                                              keepdims=True), 1e-12)
            self._normed = self.points / norms
        self.root = self._build(np.arange(len(self.points)))

    def _dist(self, idx_a: int, idx_many: np.ndarray) -> np.ndarray:
        if self.distance == "cosine":
            return 1.0 - self._normed[idx_many] @ self._normed[idx_a]
        diff = self.points[idx_many] - self.points[idx_a]
        return np.sqrt((diff ** 2).sum(-1))

    def _build(self, idx: np.ndarray):
        if len(idx) == 0:
            return None
        if len(idx) <= self.leaf_size:
            return {"leaf": idx}
        vp_pos = self._rng.randint(len(idx))
        vp = idx[vp_pos]
        rest = np.delete(idx, vp_pos)
        d = self._dist(vp, rest)
        median = np.median(d)
        inner = rest[d <= median]
        outer = rest[d > median]
        return {"vp": vp, "mu": median,
                "inner": self._build(inner), "outer": self._build(outer)}

    def _query_dist(self, q: np.ndarray, idx_many: np.ndarray) -> np.ndarray:
        if self.distance == "cosine":
            qn = q / max(np.linalg.norm(q), 1e-12)
            return 1.0 - self._normed[idx_many] @ qn
        diff = self.points[idx_many] - q
        return np.sqrt((diff ** 2).sum(-1))

    def knn(self, query, k: int) -> Tuple[List[int], List[float]]:
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance
        import heapq

        def consider(indices):
            for i, d in zip(indices, self._query_dist(q, np.asarray(indices))):
                if len(heap) < k:
                    heapq.heappush(heap, (-d, int(i)))
                elif -heap[0][0] > d:
                    heapq.heapreplace(heap, (-d, int(i)))

        def search(node):
            if node is None:
                return
            if "leaf" in node:
                if len(node["leaf"]):
                    consider(node["leaf"])
                return
            vp = node["vp"]
            consider([vp])
            d_vp = self._query_dist(q, np.asarray([vp]))[0]
            tau = -heap[0][0] if len(heap) == k else np.inf
            if d_vp <= node["mu"]:
                search(node["inner"])
                tau = -heap[0][0] if len(heap) == k else np.inf
                if d_vp + tau > node["mu"]:
                    search(node["outer"])
            else:
                search(node["outer"])
                tau = -heap[0][0] if len(heap) == k else np.inf
                if d_vp - tau <= node["mu"]:
                    search(node["inner"])

        search(self.root)
        pairs = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in pairs], [d for d, _ in pairs]


class KDTree:
    """Axis-split k-d tree (parity: kdtree/KDTree.java)."""

    def __init__(self, points: np.ndarray, leaf_size: int = 16):
        self.points = np.asarray(points, np.float64)
        self.root = self._build(np.arange(len(self.points)), 0)
        self.leaf_size = leaf_size

    def _build(self, idx, depth):
        if len(idx) == 0:
            return None
        if len(idx) <= 16:
            return {"leaf": idx}
        axis = depth % self.points.shape[1]
        vals = self.points[idx, axis]
        order = np.argsort(vals)
        mid = len(idx) // 2
        return {"axis": axis, "split": vals[order[mid]],
                "point": idx[order[mid]],
                "left": self._build(idx[order[:mid]], depth + 1),
                "right": self._build(idx[order[mid + 1:]], depth + 1)}

    def knn(self, query, k):
        q = np.asarray(query, np.float64)
        import heapq
        heap = []

        def consider(indices):
            d = np.sqrt(((self.points[np.asarray(indices)] - q) ** 2).sum(-1))
            for i, dd in zip(indices, d):
                if len(heap) < k:
                    heapq.heappush(heap, (-dd, int(i)))
                elif -heap[0][0] > dd:
                    heapq.heapreplace(heap, (-dd, int(i)))

        def search(node):
            if node is None:
                return
            if "leaf" in node:
                if len(node["leaf"]):
                    consider(node["leaf"])
                return
            consider([node["point"]])
            axis, split = node["axis"], node["split"]
            near, far = ((node["left"], node["right"]) if q[axis] <= split
                         else (node["right"], node["left"]))
            search(near)
            tau = -heap[0][0] if len(heap) == k else np.inf
            if abs(q[axis] - split) < tau:
                search(far)

        search(self.root)
        pairs = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in pairs], [d for d, _ in pairs]


class QuadTree:
    """2D quadtree (parity: quadtree/QuadTree.java) — used by 2D Barnes-Hut."""

    MAX_POINTS = 1

    def __init__(self, points: np.ndarray):
        pts = np.asarray(points, np.float64)
        assert pts.shape[1] == 2
        lo = pts.min(0)
        hi = pts.max(0)
        center = (lo + hi) / 2
        half = max((hi - lo).max() / 2, 1e-9)
        self.root = _QTNode(center, half)
        for i, p in enumerate(pts):
            self.root.insert(i, p)

    def depth(self):
        return self.root.depth()


class _QTNode:
    def __init__(self, center, half):
        self.center = np.asarray(center, np.float64)
        self.half = half
        self.idx = None
        self.point = None
        self.children = None
        self.count = 0
        self.mass_center = np.zeros(2)

    def insert(self, i, p):
        self.count += 1
        self.mass_center += (p - self.mass_center) / self.count
        if self.children is None and self.idx is None:
            self.idx, self.point = i, p
            return
        if self.children is None:
            self._split()
        self._child_for(p).insert(i, p)

    def _split(self):
        h = self.half / 2
        c = self.center
        self.children = [
            _QTNode(c + np.array([dx, dy]) * h, h)
            for dx in (-1, 1) for dy in (-1, 1)]
        if self.idx is not None:
            i, p = self.idx, self.point
            self.idx = self.point = None
            self._child_for(p).insert(i, p)

    def _child_for(self, p):
        ix = 0 if p[0] <= self.center[0] else 2
        iy = 0 if p[1] <= self.center[1] else 1
        return self.children[ix + iy]

    def depth(self):
        if self.children is None:
            return 1
        return 1 + max(c.depth() for c in self.children if c.count > 0)


class SpTree:
    """N-d Barnes-Hut tree with center-of-mass aggregation
    (parity: sptree/SpTree.java). Provides the non-edge-force estimation used
    by Barnes-Hut t-SNE."""

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)
        n, d = self.points.shape
        lo = self.points.min(0)
        hi = self.points.max(0)
        center = (lo + hi) / 2
        half = max((hi - lo).max() / 2, 1e-9)
        self.d = d
        self.root = _SpNode(center, half, d)
        for i, p in enumerate(self.points):
            self.root.insert(i, p)

    def compute_non_edge_forces(self, query: np.ndarray, theta: float = 0.5):
        """Returns (neg_force (d,), sum_q) for one embedded point — the
        Barnes-Hut approximation of the t-SNE repulsive term."""
        neg = np.zeros(self.d)
        sum_q = 0.0
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.count == 0:
                continue
            diff = query - node.mass_center
            dist2 = (diff ** 2).sum()
            if node.children is None or \
                    (node.half * 2) / max(np.sqrt(dist2), 1e-12) < theta:
                if node.is_self_leaf(query):
                    continue
                q = 1.0 / (1.0 + dist2)
                mult = node.count * q
                sum_q += mult
                neg += mult * q * diff
            else:
                stack.extend(c for c in node.children if c.count > 0)
        return neg, sum_q


class _SpNode:
    __slots__ = ("center", "half", "d", "idx", "point", "children", "count",
                 "mass_center")

    def __init__(self, center, half, d):
        self.center = np.asarray(center, np.float64)
        self.half = half
        self.d = d
        self.idx = None
        self.point = None
        self.children = None
        self.count = 0
        self.mass_center = np.zeros(d)

    def insert(self, i, p, depth=0):
        self.count += 1
        self.mass_center += (p - self.mass_center) / self.count
        if self.children is None and self.idx is None:
            self.idx, self.point = i, p
            return
        if self.children is None:
            if depth > 64 or np.allclose(self.point, p):
                return  # duplicate points: aggregate only
            self._split()
        self._child_for(p).insert(i, p, depth + 1)

    def _split(self):
        h = self.half / 2
        self.children = []
        for code in range(2 ** self.d):
            offset = np.array([1 if (code >> b) & 1 else -1
                               for b in range(self.d)]) * h
            self.children.append(_SpNode(self.center + offset, h, self.d))
        if self.idx is not None:
            i, p = self.idx, self.point
            self.idx = self.point = None
            self._child_for(p).insert(i, p)

    def _child_for(self, p):
        code = 0
        for b in range(self.d):
            if p[b] > self.center[b]:
                code |= (1 << b)
        return self.children[code]

    def is_self_leaf(self, q):
        return self.children is None and self.point is not None and \
            np.allclose(self.point, q)
