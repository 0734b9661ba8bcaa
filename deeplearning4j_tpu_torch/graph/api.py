"""In-memory graph structures.

Counterpart of deeplearning4j_tpu/graph/api.py: the same host code,
name for name (it runs nothing on a device).

Parity surface: reference deeplearning4j-graph/.../graph/api/IGraph.java,
graph/graph/Graph.java (adjacency-list graph, directed or undirected),
api/Edge.java, api/Vertex.java, api/NoEdgeHandling.java,
data/GraphLoader.java (delimited edge-list / weighted edge-list loaders).

The design keeps the graph itself as host-side numpy adjacency (graphs
here are metadata, not tensors); everything tensor-shaped (walk batches,
embedding tables) lives on device in :mod:`deepwalk`.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np


class NoEdgeHandling(Enum):
    """What a random walk does at a vertex with no outgoing edges
    (parity: api/NoEdgeHandling.java)."""
    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class NoEdgesException(RuntimeError):
    """Raised when a walk hits a degree-0 vertex under
    EXCEPTION_ON_DISCONNECTED (parity: exception/NoEdgesException.java)."""


@dataclass
class Vertex:
    """A vertex: integer index + arbitrary value (parity: api/Vertex.java)."""
    index: int
    value: Any = None


@dataclass
class Edge:
    """An edge, directed or not (parity: api/Edge.java)."""
    src: int
    dst: int
    value: Any = None
    directed: bool = False


class Graph:
    """Adjacency-list in-memory graph (parity: graph/graph/Graph.java).

    Supports directed and undirected edges, optional float edge weights
    (used by WeightedRandomWalkIterator), vertex values.
    """

    def __init__(self, n_vertices: int, *, allow_multiple_edges: bool = True,
                 vertices: Optional[Sequence[Any]] = None):
        if n_vertices <= 0:
            raise ValueError("n_vertices must be positive")
        self._n = n_vertices
        self._adj: List[List[int]] = [[] for _ in range(n_vertices)]
        self._weights: List[List[float]] = [[] for _ in range(n_vertices)]
        self._allow_multi = allow_multiple_edges
        self._vertices = [Vertex(i, vertices[i] if vertices else None)
                          for i in range(n_vertices)]
        self._padded_cache = None

    # -- structure ---------------------------------------------------------
    def num_vertices(self) -> int:
        return self._n

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def add_edge(self, src: int, dst: int, *, weight: float = 1.0,
                 directed: bool = False, value: Any = None) -> None:
        if not (0 <= src < self._n and 0 <= dst < self._n):
            raise IndexError(f"edge ({src},{dst}) out of range [0,{self._n})")
        if not self._allow_multi and dst in self._adj[src]:
            return
        self._padded_cache = None
        self._adj[src].append(dst)
        self._weights[src].append(float(weight))
        if not directed and src != dst:
            self._adj[dst].append(src)
            self._weights[dst].append(float(weight))

    def add_edges(self, edges: Iterable[Edge]) -> None:
        for e in edges:
            w = e.value if isinstance(e.value, (int, float)) else 1.0
            self.add_edge(e.src, e.dst, weight=w, directed=e.directed,
                          value=e.value)

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def degrees(self) -> np.ndarray:
        return np.array([len(a) for a in self._adj], dtype=np.int64)

    def neighbors(self, idx: int) -> List[int]:
        return list(self._adj[idx])

    def neighbor_weights(self, idx: int) -> List[float]:
        return list(self._weights[idx])

    # -- sampling ----------------------------------------------------------
    def random_neighbor(self, idx: int, rng: np.random.Generator,
                        mode: NoEdgeHandling =
                        NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED) -> int:
        nbrs = self._adj[idx]
        if not nbrs:
            if mode is NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED:
                return idx
            raise NoEdgesException(f"vertex {idx} has no edges")
        return nbrs[int(rng.integers(len(nbrs)))]

    # -- padded device view ------------------------------------------------
    def padded_adjacency(self):
        """(adj, weights, degree) dense padded arrays for vectorized walk
        generation: adj[v, k] = k-th neighbour of v (self-padded), weights
        normalized per row. Shapes (V, max_deg). Cached; invalidated by
        add_edge."""
        if self._padded_cache is not None:
            return self._padded_cache
        deg = self.degrees()
        max_deg = max(int(deg.max()), 1)
        adj = np.tile(np.arange(self._n, dtype=np.int32)[:, None], (1, max_deg))
        w = np.zeros((self._n, max_deg), np.float32)
        for v in range(self._n):
            k = len(self._adj[v])
            if k:
                adj[v, :k] = self._adj[v]
                w[v, :k] = self._weights[v]
                w[v] /= w[v, :k].sum()
            else:
                w[v, 0] = 1.0  # self loop
        self._padded_cache = (adj, w, deg)
        return self._padded_cache


def load_edge_list(path: str, n_vertices: int, *, delimiter: str = ",",
                   directed: bool = False, weighted: bool = False) -> Graph:
    """Build a Graph from a delimited edge-list file — lines of
    ``src,dst[,weight]`` (parity: data/GraphLoader.java
    loadUndirectedGraphEdgeListFile / WeightedEdgeLineProcessor.java).
    Lines starting with '#' or '//' are comments."""
    g = Graph(n_vertices)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            parts = line.split(delimiter)
            src, dst = int(parts[0]), int(parts[1])
            w = float(parts[2]) if (weighted and len(parts) > 2) else 1.0
            g.add_edge(src, dst, weight=w, directed=directed)
    return g
