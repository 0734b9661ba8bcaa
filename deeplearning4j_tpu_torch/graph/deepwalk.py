"""DeepWalk graph vectorization (Perozzi et al. 2014).

Counterpart of deeplearning4j_tpu/graph/deepwalk.py: the walks, pairs and
Huffman tree on the host with the JAX package's numpy draws in its order,
the tables on the device (the card unless ``device=`` says otherwise),
each pair batch one hierarchical-softmax step of the port's word2vec
(``nlp.word2vec._sg_hs_step``, in place through its accumulating
scatter-adds). Nothing is drawn on the device: the port trains on the JAX
package's batches.

Parity surface: reference graph/models/deepwalk/DeepWalk.java (builder:
vectorSize/windowSize/learningRate/seed; fit over random walks),
deepwalk/GraphHuffman.java (degree-weighted Huffman tree for hierarchical
softmax), models/embeddings/InMemoryGraphLookupTable.java (in/out vector
tables + sigmoid table) and GraphVectorsImpl.java (similarity / nearest).

The reference trains with per-pair scalar updates across a thread pool;
here walks are generated vectorized on the host
(:func:`walks.generate_walks_batch`), expanded into (center, target)
skip-gram pairs, and each batch is gather, sigmoid and scatter-add over the
embedding tables.
"""

from __future__ import annotations

import heapq
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.graph.api import Graph, NoEdgeHandling
from deeplearning4j_tpu_torch.graph.walks import generate_walks_batch
from deeplearning4j_tpu_torch.nlp.word2vec import _sg_hs_step
from deeplearning4j_tpu_torch.ops import resolve_device


class GraphHuffman:
    """Huffman tree over vertex degrees for hierarchical softmax
    (parity: graph/models/deepwalk/GraphHuffman.java — codes, code lengths
    and inner-node paths per leaf)."""

    def __init__(self, n_vertices: int, max_code_length: int = 64):
        self.n = n_vertices
        self.max_code_length = max_code_length
        self.codes: List[List[int]] = [[] for _ in range(n_vertices)]
        self.points: List[List[int]] = [[] for _ in range(n_vertices)]

    def build_tree(self, vertex_degrees: Sequence[int]) -> "GraphHuffman":
        n = self.n
        assert len(vertex_degrees) == n
        if n == 1:
            self.codes[0], self.points[0] = [0], [0]
            return self
        heap = [(int(d), i, i) for i, d in enumerate(vertex_degrees)]
        heapq.heapify(heap)
        children = {}
        next_id = n
        while len(heap) > 1:
            c1, _, id1 = heapq.heappop(heap)
            c2, _, id2 = heapq.heappop(heap)
            children[next_id] = (id1, id2)
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        stack = [(root, [], [])]
        while stack:
            node, code, path = stack.pop()
            if len(code) > self.max_code_length:
                raise RuntimeError(
                    f"code length exceeds {self.max_code_length} bits")
            if node < n:
                self.codes[node] = code
                # inner nodes numbered relative to leaf count, root first
                self.points[node] = [p - n for p in path]
                continue
            left, right = children[node]
            stack.append((left, code + [0], path + [node]))
            stack.append((right, code + [1], path + [node]))
        return self

    def get_code_length(self, v: int) -> int:
        return len(self.codes[v])

    def get_code(self, v: int) -> int:
        """Code as packed int, LSB = first branch (parity: getCode)."""
        out = 0
        for i, b in enumerate(self.codes[v]):
            out |= b << i
        return out

    def get_path_inner_node(self, v: int) -> List[int]:
        return list(self.points[v])

    def padded(self):
        """(points, codes, mask) padded (V, L) arrays for device HS steps."""
        L = max(1, max(len(c) for c in self.codes))
        pts = np.zeros((self.n, L), np.int32)
        cds = np.zeros((self.n, L), np.float32)
        msk = np.zeros((self.n, L), np.float32)
        for v in range(self.n):
            k = len(self.codes[v])
            pts[v, :k] = self.points[v]
            cds[v, :k] = self.codes[v]
            msk[v, :k] = 1.0
        return pts, cds, msk


class DeepWalk:
    """DeepWalk model (parity: graph/models/deepwalk/DeepWalk.java +
    GraphVectorsImpl similarity/nearest API; Builder pattern kept)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 learning_rate: float = 0.025, seed: int = 12345,
                 batch_size: int = 4096, walks_per_vertex: int = 1,
                 device=None):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.seed = seed
        self.batch_size = batch_size
        self.walks_per_vertex = walks_per_vertex
        self.device = resolve_device(device)
        self.syn0 = None     # (V, D) in-vectors (the embeddings)
        self.syn1 = None     # (V-1, D) inner-node vectors
        self._hs = None
        self._init_called = False

    # -- builder parity ----------------------------------------------------
    class Builder:
        def __init__(self):
            self._kw = {}

        def vector_size(self, d):
            self._kw["vector_size"] = d
            return self

        def window_size(self, w):
            self._kw["window_size"] = w
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def device(self, d):
            self._kw["device"] = d
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(**self._kw)

    # -- init --------------------------------------------------------------
    def initialize(self, graph_or_degrees) -> "DeepWalk":
        """Build the Huffman tree + lookup tables (parity: initialize)."""
        if isinstance(graph_or_degrees, Graph):
            degrees = graph_or_degrees.degrees()
        else:
            degrees = np.asarray(graph_or_degrees, np.int64)
        V = len(degrees)
        self._hs = GraphHuffman(V).build_tree(degrees)
        rng = np.random.default_rng(self.seed)
        scale = 0.5 / self.vector_size
        self.syn0 = torch.from_numpy(rng.uniform(
            -scale, scale, (V, self.vector_size)).astype(np.float32)).to(
                self.device)
        self.syn1 = torch.zeros((max(V - 1, 1), self.vector_size),
                                device=self.device)
        self._pts, self._cds, self._msk = self._hs.padded()
        self._init_called = True
        return self

    # -- training ----------------------------------------------------------
    def fit(self, graph: Graph, walk_length: int = 40, *,
            epochs: int = 1,
            mode: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED
            ) -> "DeepWalk":
        """Generate random walks over every vertex and train skip-gram HS
        (parity: DeepWalk.fit(IGraph, walkLength) — the reference fans walks
        across threads; here walk lanes are a vectorized batch and updates
        are one device step per pair-batch)."""
        if not self._init_called:
            self.initialize(graph)
        rng = np.random.default_rng(self.seed)
        V = graph.num_vertices()
        lr = self.learning_rate
        for _ in range(epochs):
            for _ in range(self.walks_per_vertex):
                starts = rng.permutation(V)
                for ofs in range(0, V, 1024):
                    walks = generate_walks_batch(
                        graph, starts[ofs:ofs + 1024], walk_length, rng,
                        mode=mode)
                    self._train_walks(walks, lr, rng)
        return self

    def fit_walks(self, walks: np.ndarray,
                  lr: Optional[float] = None) -> "DeepWalk":
        """Train directly on pre-generated (B, T) walks (parity:
        fit(GraphWalkIteratorProvider) — bring-your-own walk source)."""
        if not self._init_called:
            raise RuntimeError("DeepWalk not initialized (call initialize)")
        self._train_walks(np.asarray(walks, np.int32),
                          self.learning_rate if lr is None else lr,
                          np.random.default_rng(self.seed))
        return self

    def _train_walks(self, walks: np.ndarray, lr: float,
                     rng: np.random.Generator) -> None:
        B, T = walks.shape
        win = self.window_size
        centers, targets = [], []
        for i in range(T):
            lo, hi = max(0, i - win), min(T, i + win + 1)
            for j in range(lo, hi):
                if j == i:
                    continue
                centers.append(walks[:, i])
                targets.append(walks[:, j])
        centers = np.concatenate(centers)
        targets = np.concatenate(targets)
        order = rng.permutation(len(centers))
        centers, targets = centers[order], targets[order]
        bs = self.batch_size

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        for ofs in range(0, len(centers), bs):
            c = dev(centers[ofs:ofs + bs]).long()
            t = targets[ofs:ofs + bs]
            _sg_hs_step(self.syn0, self.syn1, c, dev(self._pts[t]).long(),
                        dev(self._cds[t]), dev(self._msk[t]), np.float32(lr),
                        normalize=True)

    # -- GraphVectors API --------------------------------------------------
    def get_vertex_vector(self, v: int) -> np.ndarray:
        return self.syn0[v].cpu().numpy()

    def num_vertices(self) -> int:
        return int(self.syn0.shape[0])

    def similarity(self, v1: int, v2: int) -> float:
        """Cosine similarity (parity: GraphVectorsImpl.similarity)."""
        a, b = self.get_vertex_vector(v1), self.get_vertex_vector(v2)
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    def vertices_nearest(self, v: int, top: int = 5) -> List[int]:
        e = self.syn0.cpu().numpy()
        q = e[v] / (np.linalg.norm(e[v]) + 1e-12)
        sims = (e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-12)) @ q
        sims[v] = -np.inf
        return list(np.argsort(-sims)[:top])

    # -- persistence (parity: models/loader/GraphVectorSerializer) ---------
    def save(self, path: str) -> None:
        np.savez(path if path.endswith(".npz") else path + ".npz",
                 syn0=self.syn0.cpu().numpy(), syn1=self.syn1.cpu().numpy(),
                 pts=self._pts, cds=self._cds, msk=self._msk,
                 meta=json.dumps({"vector_size": self.vector_size,
                                  "window_size": self.window_size,
                                  "learning_rate": self.learning_rate,
                                  "seed": self.seed,
                                  "batch_size": self.batch_size,
                                  "walks_per_vertex": self.walks_per_vertex}))

    @staticmethod
    def load(path: str, *, device=None) -> "DeepWalk":
        """A saved model with its tables on ``device`` (default: the
        card)."""
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        dw = DeepWalk(vector_size=meta["vector_size"],
                      window_size=meta["window_size"],
                      learning_rate=meta["learning_rate"],
                      seed=meta.get("seed", 12345),
                      batch_size=meta.get("batch_size", 4096),
                      walks_per_vertex=meta.get("walks_per_vertex", 1),
                      device=device)
        dw.syn0 = torch.from_numpy(z["syn0"]).to(dw.device)
        dw.syn1 = torch.from_numpy(z["syn1"]).to(dw.device)
        dw._pts, dw._cds, dw._msk = z["pts"], z["cds"], z["msk"]
        dw._init_called = True
        return dw
