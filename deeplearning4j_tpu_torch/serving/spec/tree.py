"""Static token trees for tree speculation.

Counterpart of deeplearning4j_tpu/serving/spec/tree.py. The shape is the
caterpillar tree ``kvec = (k_1, .., k_D)``: the spine node at depth d-1
has ``k_d`` children, the draft's own token first (the spine
continuation) and ``k_d - 1`` alternatives with the spine token masked
out, so siblings are distinct and at most one can match the oracle. Side
nodes are leaves. A linear draft is the ``(1,) * k`` tree. The tables are
numpy on the host; ``tensors(device)`` holds them as device tensors, built
once per device (an engine builds its own at construction, so that no
program copies them in). The acceptance walk is tensor code, a static
loop over the depths, run inside the verify program as the JAX package
traces its walk into its own.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


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
        self._tensors = {}

    def tensors(self, device) -> SimpleNamespace:
        """The tables (``parent``, ``depth``, ``spine``, ``first``,
        ``anc_at_depth``) as int64 tensors on ``device``, built at the first
        call for that device and kept."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        t = self._tensors.get(key)
        if t is None:
            t = self._tensors[key] = SimpleNamespace(**{
                name: torch.as_tensor(getattr(self, name),
                                      device=device).long()
                for name in ("parent", "depth", "spine", "first",
                             "anc_at_depth")})
        return t

    def ancestor_matrix(self) -> np.ndarray:
        """(N, N) bool: ``anc[i, j]`` when node j is on node i's
        root-path (ancestor or self)."""
        N = self.n_nodes
        anc = np.zeros((N, N), bool)
        for i in range(N):
            anc[i, self.anc_at_depth[i, :self.depth[i] + 1]] = True
        return anc

    def walk(self, node_tokens, oracle, n_in):
        """The longest accepted root-path of every row, as tensors on the
        inputs' device (numpy inputs run on the CPU). ``node_tokens`` /
        ``oracle`` (S, N): each node's drafted token and the oracle token
        the target gives AFTER that node's path; ``n_in`` (S,): the emit
        budget (0 = an inert row). A depth-d node extends the path when the
        path sits on the depth-(d-1) spine node and the node's token is
        the oracle token of the path node above it.

        Returns ``(a, emitted, spine_acc, path)``: the accepted depth (at
        most n_in - 1), the tokens to emit (a + 1, 0 for inert rows), the
        accepted prefix that followed the draft's own spine, and (S, D+1)
        the path's node at each depth (saturating past ``a``)."""
        node_tokens = torch.as_tensor(node_tokens).long()
        dev = node_tokens.device
        oracle = torch.as_tensor(oracle, device=dev).long()
        n_in = torch.as_tensor(n_in, device=dev).long()
        S = node_tokens.shape[0]
        cur = torch.zeros(S, dtype=torch.int64, device=dev)
        a = torch.zeros_like(cur)
        ok = torch.ones(S, dtype=torch.bool, device=dev)
        on_spine = torch.ones_like(ok)
        spine_acc = torch.zeros_like(cur)
        path = [cur]
        for dd in range(1, self.d + 1):
            f, kd = int(self.first[dd - 1]), self.kvec[dd - 1]
            want = oracle.gather(1, cur[:, None])
            m = node_tokens[:, f:f + kd] == want
            hit = (m.any(dim=1) & ok & (cur == int(self.spine[dd - 1]))
                   & (dd < n_in))
            child = f + torch.argmax(m.long(), dim=1)
            cur = torch.where(hit, child, cur)
            a = a + hit.long()
            on_spine = on_spine & hit & (child == int(self.spine[dd]))
            spine_acc = spine_acc + on_spine.long()
            ok = ok & hit
            path.append(cur)
        emitted = torch.where(n_in > 0, a + 1, 0)
        return a, emitted, spine_acc, torch.stack(path, dim=1)
