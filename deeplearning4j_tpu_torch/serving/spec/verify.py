"""The verify half of speculative decoding: score every slot's drafted
token tree in one batched target call.

Counterpart of deeplearning4j_tpu/serving/spec/verify.py. Node n of a
slot's tree sits at position ``pos0 + depth(n)`` and sees the committed
cache plus its own root-path (``model.tree_chunk``; the attention is the
plain step's, K8, over each node's effective cache). The log-probabilities
of every node come back to the host, where the engine's sampling rule
gives the token the plain engine would emit after each node and the walk
(``TreeSpec.walk``) finds the longest accepted path. A second device call
then writes the accepted path's K/V (``model.tree_commit``: rejected nodes
are never written) and rolls carries back to the accepted node's snapshot
(rewind.py). The JAX package samples, walks and commits inside one
program; here the host's rule splits it in two.

Inert rows (``n_in == 0``): paged commits land in scratch block 0, dense
ones rewrite what they hold, and their carries are frozen.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.base import where_rows
from deeplearning4j_tpu_torch.serving.kv import map_slot_leaves
from deeplearning4j_tpu_torch.serving.spec.accept import oracle_token
from deeplearning4j_tpu_torch.serving.spec.rewind import rewound_state

_KV_KEYS = MultiHeadAttention.positional_state_keys


class SpecVerifier:
    """The verify for one DecodeEngine over its static ``tree``
    (``TreeSpec``); ``paged`` engines pass their page tables."""

    def __init__(self, model, slots, tree, vocab):
        self.model = model
        self.slots = int(slots)
        self.tree = tree
        self.vocab = int(vocab)
        self.calls = 0

    @torch.no_grad()
    def run(self, dstate, tokens, pos0, n_in, reset, seeds, temps, topk,
            btab=None):
        """One verify for all S slots. ``tokens`` (S, N): each slot's tree
        in ``TreeSpec`` order (node 0 = the last emitted token); ``n_in``
        (S,): the emit budget (0 = an inert row). Returns ``(emit,
        accepted, emitted, spine_acc, new_dstate)``: ``emit`` (S, D+1) the
        accepted path's oracle tokens, zero past ``emitted``."""
        m, tr, S = self.model, self.tree, self.slots
        dev = m.device
        n_in = np.asarray(n_in)
        live = n_in > 0
        reset_t = torch.as_tensor(np.asarray(reset, bool), device=dev)
        dstate = map_slot_leaves(
            lambda a: where_rows(reset_t, torch.zeros_like(a), a), dstate,
            keys=_KV_KEYS)
        x = torch.nn.functional.one_hot(
            torch.as_tensor(tokens, dtype=torch.long, device=dev),
            self.vocab).to(torch.float32)
        pos0_t = torch.as_tensor(pos0, dtype=torch.int32, device=dev)
        n_t = torch.as_tensor(n_in, dtype=torch.int32, device=dev)
        y, stacks, wins = m.tree_chunk(m.params, dstate, x, pos0_t, tr, n_t,
                                       block_tables=btab)
        logits = torch.log(y.float()).cpu().numpy()           # (S, N, V)
        oracle = np.zeros((S, tr.n_nodes), np.int64)
        for i in np.flatnonzero(live):
            for j in range(tr.n_nodes):
                oracle[i, j] = oracle_token(logits[i, j], seeds[i],
                                            pos0[i] + int(tr.depth[j]),
                                            temps[i], topk[i])
        accepted, emitted, spine_acc, path = tr.walk(tokens, oracle, n_in)
        rows = np.arange(S)
        node = path[rows, accepted]
        merged = rewound_state(m, dstate, stacks,
                               torch.as_tensor(node, device=dev),
                               torch.arange(S, device=dev))
        merged = m.tree_commit(merged, wins,
                               torch.as_tensor(path, device=dev), pos0_t,
                               torch.as_tensor(emitted, device=dev),
                               block_tables=btab)
        live_t = torch.as_tensor(live, device=dev)
        merged = map_slot_leaves(lambda a, b: where_rows(live_t, a, b),
                                 merged, dstate, keys=_KV_KEYS)
        emit = oracle[rows[:, None], path]
        emit = np.where(np.arange(tr.d + 1)[None, :] < emitted[:, None],
                        emit, 0)
        self.calls += 1
        return emit, accepted, emitted, spine_acc, merged
