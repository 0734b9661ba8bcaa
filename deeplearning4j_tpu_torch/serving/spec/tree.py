"""Static token trees for tree speculation.

Counterpart of deeplearning4j_tpu/serving/spec/tree.py. The shape is the
caterpillar tree ``kvec = (k_1, .., k_D)``: the spine node at depth d-1
has ``k_d`` children, the draft's own token first (the spine
continuation) and ``k_d - 1`` alternatives with the spine token masked
out, so siblings are distinct and at most one can match the oracle. Side
nodes are leaves. A linear draft is the ``(1,) * k`` tree. The tables are
numpy, and so is the acceptance walk: here it runs on the host, over the
oracle tokens of every node.
"""

from __future__ import annotations

import numpy as np


def parse_kvec(text):
    """``"3,2,2"`` -> ``(3, 2, 2)``."""
    kvec = tuple(int(p) for p in str(text).split(",") if p.strip())
    if not kvec:
        raise ValueError(f"empty tree spec {text!r}")
    return kvec


class TreeSpec:
    """A flattened token tree. Node 0 is the root (the last emitted token,
    depth 0); depth-d nodes take the indices ``first[d-1] ..
    first[d-1]+k_d-1``, the spine child first, each a child of the
    depth-(d-1) spine node. Tables:

    - ``parent`` (N,): the parent node, -1 for the root;
    - ``depth`` (N,): 0..D;
    - ``spine`` (D+1,): the spine node at each depth;
    - ``first`` (D,): the first node of each depth group;
    - ``anc_at_depth`` (N, D+1): node n's ancestor-or-self at each depth,
      saturating to n past its own depth; row n is node n's root-path.
    """

    def __init__(self, kvec):
        kvec = tuple(int(k) for k in kvec)
        if not kvec or any(k < 1 for k in kvec):
            raise ValueError(
                f"tree kvec must be positive ints per depth, got {kvec}")
        self.kvec = kvec
        self.d = len(kvec)
        self.n_nodes = 1 + sum(kvec)
        parent, depth, spine, first = [-1], [0], [0], []
        nid = 1
        for dd, k in enumerate(kvec, start=1):
            first.append(nid)
            parent.extend([spine[dd - 1]] * k)
            depth.extend([dd] * k)
            spine.append(nid)
            nid += k
        self.parent = np.asarray(parent, np.int32)
        self.depth = np.asarray(depth, np.int32)
        self.spine = np.asarray(spine, np.int32)
        self.first = np.asarray(first, np.int32)
        aad = np.zeros((self.n_nodes, self.d + 1), np.int32)
        for n in range(self.n_nodes):
            chain, cur = [], n
            while cur >= 0:
                chain.append(cur)
                cur = int(self.parent[cur])
            chain = chain[::-1]
            aad[n, :len(chain)] = chain
            aad[n, len(chain):] = n
        self.anc_at_depth = aad

    def ancestor_matrix(self) -> np.ndarray:
        """(N, N) bool: ``anc[i, j]`` when node j is on node i's
        root-path (ancestor or self)."""
        N = self.n_nodes
        anc = np.zeros((N, N), bool)
        for i in range(N):
            anc[i, self.anc_at_depth[i, :self.depth[i] + 1]] = True
        return anc

    def walk(self, node_tokens, oracle, n_in):
        """The longest accepted root-path of every row. ``node_tokens`` /
        ``oracle`` (S, N): each node's drafted token and the oracle token
        the target gives AFTER that node's path; ``n_in`` (S,): the emit
        budget (0 = an inert row). A depth-d node extends the path when the
        path sits on the depth-(d-1) spine node and the node's token is
        the oracle token of the path node above it.

        Returns ``(a, emitted, spine_acc, path)``: the accepted depth (at
        most n_in - 1), the tokens to emit (a + 1, 0 for inert rows), the
        accepted prefix that followed the draft's own spine, and (S, D+1)
        the path's node at each depth (saturating past ``a``)."""
        node_tokens = np.asarray(node_tokens)
        oracle = np.asarray(oracle)
        n_in = np.asarray(n_in)
        S = node_tokens.shape[0]
        rows = np.arange(S)
        cur = np.zeros(S, np.int64)
        a = np.zeros(S, np.int64)
        ok = np.ones(S, bool)
        on_spine = np.ones(S, bool)
        spine_acc = np.zeros(S, np.int64)
        path = [cur]
        for dd in range(1, self.d + 1):
            f, kd = int(self.first[dd - 1]), self.kvec[dd - 1]
            want = oracle[rows, cur]
            m = node_tokens[:, f:f + kd] == want[:, None]
            hit = (m.any(axis=1) & ok & (cur == int(self.spine[dd - 1]))
                   & (dd < n_in))
            child = f + np.argmax(m, axis=1)
            cur = np.where(hit, child, cur)
            a = a + hit
            on_spine = on_spine & hit & (child == int(self.spine[dd]))
            spine_acc = spine_acc + on_spine
            ok = ok & hit
            path.append(cur)
        emitted = np.where(n_in > 0, a + 1, 0)
        return a, emitted, spine_acc, np.stack(path, axis=1)
