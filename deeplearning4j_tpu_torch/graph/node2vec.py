"""node2vec: biased second-order random walks + skip-gram embeddings.

Counterpart of deeplearning4j_tpu/graph/node2vec.py. Where the JAX
package's ``Node2Vec.fit`` hands its walk iterator itself to
``fit_walks`` (and fails converting it to an array), the port hands it
the iterator's walks.

Parity: the reference ships node2vec inside deeplearning4j-nlp
(models/node2vec — SURVEY.md §2 #26 lists it with the embeddings family)
on top of the same SequenceVectors machinery DeepWalk uses. Here it reuses
the DeepWalk trainer (graph/deepwalk.py) with a (p, q)-biased walker
(Grover & Leskovec 2016): return parameter p penalizes revisiting the
previous node, in-out parameter q interpolates BFS (q>1) vs DFS (q<1)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk


class Node2VecWalkIterator:
    """Second-order biased walks. Yields one walk (list of vertex ids) per
    ``__next__``; one pass enumerates every vertex as a start (parity with
    RandomWalkIterator's epoch semantics)."""

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 0):
        self.graph = graph
        self.walk_length = walk_length
        self.p = float(p)
        self.q = float(q)
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self._order = self._rng.permutation(graph.num_vertices())
        self._pos = 0

    def reset(self):
        self._rng = np.random.RandomState(self.seed)
        self._order = self._rng.permutation(self.graph.num_vertices())
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def __iter__(self):
        return self

    def __next__(self) -> List[int]:
        if not self.has_next():
            raise StopIteration
        start = int(self._order[self._pos])
        self._pos += 1
        return self._walk(start)

    def _walk(self, start: int) -> List[int]:
        walk = [start]
        prev: Optional[int] = None
        cur = start
        for _ in range(self.walk_length - 1):
            nbrs = self.graph.neighbors(cur)
            if not nbrs:
                break
            if prev is None:
                nxt = nbrs[self._rng.randint(len(nbrs))]
            else:
                prev_nbrs = set(self.graph.neighbors(prev))
                w = np.empty(len(nbrs))
                for i, nb in enumerate(nbrs):
                    if nb == prev:
                        w[i] = 1.0 / self.p          # return
                    elif nb in prev_nbrs:
                        w[i] = 1.0                   # distance 1 from prev
                    else:
                        w[i] = 1.0 / self.q          # explore outward
                w /= w.sum()
                nxt = nbrs[self._rng.choice(len(nbrs), p=w)]
            walk.append(int(nxt))
            prev, cur = cur, int(nxt)
        return walk


class Node2Vec(DeepWalk):
    """DeepWalk trainer fed by (p, q)-biased walks.

        n2v = (Node2Vec.Builder().vector_size(64).window_size(5)
               .p(0.25).q(4.0).build())
        n2v.initialize(graph)
        n2v.fit(graph, walk_length=40)
    """

    def __init__(self, *args, p: float = 1.0, q: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.p = p
        self.q = q

    class Builder(DeepWalk.Builder):
        def __init__(self):
            super().__init__()
            self._p = 1.0
            self._q = 1.0

        def p(self, v):
            self._p = v
            return self

        def q(self, v):
            self._q = v
            return self

        def build(self):
            dw = super().build()
            n2v = Node2Vec(vector_size=dw.vector_size,
                           window_size=dw.window_size,
                           learning_rate=dw.learning_rate, seed=dw.seed,
                           p=self._p, q=self._q, device=dw.device)
            return n2v

    def fit(self, graph: Graph, walk_length: int = 40, epochs: int = 1):
        for ep in range(epochs):
            it = Node2VecWalkIterator(graph, walk_length, self.p, self.q,
                                      seed=self.seed + ep)
            self.fit_walks(np.asarray(list(it), np.int32))
        return self
