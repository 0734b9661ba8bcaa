"""Random-walk iterators over graphs.

Counterpart of deeplearning4j_tpu/graph/walks.py: the same host code,
name for name (it runs nothing on a device).

Parity surface: reference graph/iterator/RandomWalkIterator.java,
WeightedRandomWalkIterator.java, GraphWalkIterator.java and the parallel
providers (iterator/parallel/RandomWalkGraphIteratorProvider.java).

Design: instead of the reference's one-vertex-at-a-time walk objects
handed to worker threads, walks are generated **vectorized** — all walks for
a batch of start vertices advance one hop per numpy step using the padded
adjacency matrix — and streamed to the device trainer in batches. The
iterator API below still yields individual walks for parity/tests.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph, NoEdgeHandling, NoEdgesException


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex in order
    (parity: iterator/RandomWalkIterator.java — walk length semantics:
    ``walk_length`` hops, i.e. walk_length+1 vertices)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 mode: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
                 first_vertex: int = 0, last_vertex: Optional[int] = None):
        self.graph = graph
        self.walk_length = walk_length
        self.mode = mode
        self.first = first_vertex
        self.last = graph.num_vertices() if last_vertex is None else last_vertex
        self._rng = np.random.default_rng(seed)
        self._pos = self.first

    def __iter__(self) -> "RandomWalkIterator":
        return self

    def reset(self) -> None:
        self._pos = self.first

    def has_next(self) -> bool:
        return self._pos < self.last

    def __next__(self) -> List[int]:
        if self._pos >= self.last:
            raise StopIteration
        walk = [self._pos]
        cur = self._pos
        for _ in range(self.walk_length):
            cur = self.graph.random_neighbor(cur, self._rng, self.mode)
            walk.append(cur)
        self._pos += 1
        return walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional random walks
    (parity: iterator/WeightedRandomWalkIterator.java)."""

    def __next__(self) -> List[int]:
        if self._pos >= self.last:
            raise StopIteration
        walk = [self._pos]
        cur = self._pos
        for _ in range(self.walk_length):
            nbrs = self.graph.neighbors(cur)
            if not nbrs:
                if self.mode is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
                    raise NoEdgesException(f"vertex {cur} has no edges")
                walk.append(cur)
                continue
            w = np.asarray(self.graph.neighbor_weights(cur), np.float64)
            cur = nbrs[int(self._rng.choice(len(nbrs), p=w / w.sum()))]
            walk.append(cur)
        self._pos += 1
        return walk


class RandomWalkGraphIteratorProvider:
    """Split the vertex range into N sub-ranges, one iterator each (parity:
    iterator/parallel/RandomWalkGraphIteratorProvider.java). Here the
    "threads" are batch lanes, but the provider API is kept for parity."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 mode: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED):
        self.graph, self.walk_length, self.seed, self.mode = (
            graph, walk_length, seed, mode)

    def get_graph_walk_iterators(self, n: int) -> List[RandomWalkIterator]:
        V = self.graph.num_vertices()
        n = max(1, min(n, V))
        bounds = np.linspace(0, V, n + 1).astype(int)
        return [RandomWalkIterator(self.graph, self.walk_length,
                                   seed=self.seed + i, mode=self.mode,
                                   first_vertex=int(bounds[i]),
                                   last_vertex=int(bounds[i + 1]))
                for i in range(n)]


def generate_walks_batch(graph: Graph, starts: np.ndarray, walk_length: int,
                         rng: np.random.Generator,
                         weighted: bool = False,
                         mode: NoEdgeHandling =
                         NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED
                         ) -> np.ndarray:
    """Vectorized walk generation: (B,) start vertices → (B, walk_length+1)
    int32 walks, all lanes advancing one hop per step via the padded
    adjacency (degree-0 vertices self-loop, or raise under
    EXCEPTION_ON_DISCONNECTED). This is the hot path DeepWalk.fit uses."""
    adj, w, deg = graph.padded_adjacency()
    B = starts.shape[0]
    out = np.empty((B, walk_length + 1), np.int32)
    out[:, 0] = cur = starts.astype(np.int32)
    max_deg = adj.shape[1]
    for t in range(walk_length):
        if (mode is NoEdgeHandling.EXCEPTION_ON_DISCONNECTED
                and (deg[cur] == 0).any()):
            bad = int(cur[np.argmax(deg[cur] == 0)])
            raise NoEdgesException(f"vertex {bad} has no edges")
        if weighted:
            # per-lane categorical draw over normalized neighbour weights
            u = rng.random((B, 1))
            cdf = np.cumsum(w[cur], axis=1)
            k = (u > cdf).sum(axis=1).clip(max=max_deg - 1)
        else:
            d = np.maximum(deg[cur], 1)
            k = (rng.random(B) * d).astype(np.int64)
        cur = adj[cur, k]
        out[:, t + 1] = cur
    return out
