"""The verify half of speculative decoding: score every slot's drafted
token tree in one batched target call.

Counterpart of deeplearning4j_tpu/serving/spec/verify.py. ONE program
(exec.ResidentProgram), as the JAX package's ``_impl`` is: the reset wipe;
the tree's node tokens, assembled on the card from the row's last token
and the draft's resident proposals; ``model.tree_chunk`` (node n sits at
position ``pos0 + depth(n)`` and sees the committed cache plus its own
root-path; the attention is the plain step's, K8, over each node's
effective cache); the engine's sampling rule (``oracle_tokens``) at every
node, the token the plain engine would emit after that node; the walk
(``TreeSpec.walk``) to the longest accepted path; the carries' rewind to
the accepted node's snapshot (rewind.py); ``model.tree_commit`` of the
accepted path's K/V (rejected nodes are never written); and the freeze of
inert rows. The new carries are written into the resident state. The
host reads one (S, D+4) int32 result: the accepted path's oracle tokens
(zero past ``emitted``), then ``accepted``, ``emitted`` and
``spine_acc``.

Inert rows (``n_in == 0``): paged commits land in scratch block 0, dense
ones rewrite what they hold, and their carries are frozen.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.quant import dequantize_tree
from deeplearning4j_tpu_torch.exec.executor import (HostResult, HostStage,
                                                    Layout, ResidentProgram)
from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.base import copy_into, where_rows
from deeplearning4j_tpu_torch.serving.kv import map_slot_leaves
from deeplearning4j_tpu_torch.serving.spec.accept import oracle_tokens
from deeplearning4j_tpu_torch.serving.spec.rewind import rewound_state

_KV_KEYS = MultiHeadAttention.positional_state_keys


class SpecVerifier:
    """The verify for one DecodeEngine over its static ``tree``
    (``TreeSpec``); ``max_blocks`` (paged engines) is the page tables'
    width."""

    def __init__(self, model, slots, tree, vocab, max_blocks=None):
        self.model = model
        self.slots = int(slots)
        self.tree = tree
        self.vocab = int(vocab)
        self.paged = max_blocks is not None
        self.calls = 0
        S = self.slots
        fields = dict(node0=(S,), pos0=(S,), n_in=(S,), reset=(S,),
                      seeds=((S,), np.uint32), temps=((S,), np.float32),
                      topk=(S,))
        if self.paged:
            fields["tables"] = (S, int(max_blocks))
        self.layout = Layout(**fields)
        self._program = self._stage = self._result = None
        self._resident = None

    @property
    def programs(self) -> int:
        """Programs of the verify (captured graphs on the card)."""
        return 0 if self._program is None else self._program.programs

    def build(self, executor, capture, resident):
        """The verify program over ``resident``: ``{"params", "state",
        "props", "sides"}``, the engine's parameter set and decode state
        and the draft's proposals."""
        dev = self.model.device
        self.tree.tensors(dev)
        self._resident = resident
        self._program = ResidentProgram(executor, self._run, "verify",
                                        capture=capture)
        self._stage = HostStage(self.layout, dev)
        self._result = HostResult((self.slots, self.tree.d + 4), dev)
        return self._program

    def stage(self):
        """The zeroed staged fields of the next call (numpy views)."""
        return self._stage.open()

    def run(self):
        """One verify of the staged rows. Returns host arrays ``(emit,
        accepted, emitted, spine_acc)``: ``emit`` (S, D+1) the accepted
        path's oracle tokens, zero past ``emitted``."""
        out = self._program(self._resident, self._stage.tensor)
        self._stage.sent()
        self.calls += 1
        r = self._result.read(out)
        D = self.tree.d
        return r[:, :D + 1], r[:, D + 1], r[:, D + 2], r[:, D + 3]

    def _node_tokens(self, node0, props, sides):
        """(S, N) in ``TreeSpec`` order: node 0 the row's last token, each
        depth's group the draft's own token, then its alternatives."""
        tr = self.tree
        cols = [node0[:, None]]
        for dd in range(1, tr.d + 1):
            kd = tr.kvec[dd - 1]
            cols.append(props[:, dd - 1:dd])
            if kd > 1:
                cols.append(sides[:, dd - 1, :kd - 1])
        return torch.cat(cols, dim=1)

    @torch.no_grad()
    def _run(self, res, buf):
        f = self.layout.unpack(buf)
        m, tr, S = self.model, self.tree, self.slots
        dev = buf.device
        # the identity on a float32 set; int8 / fp8 widen here, inside the
        # program
        params, dstate = dequantize_tree(res["params"]), res["state"]
        pos0, n_in = f["pos0"].long(), f["n_in"].long()
        reset, live = f["reset"] != 0, n_in > 0
        seeds, temps, topk = f["seeds"], f["temps"], f["topk"]
        tokens = torch.where(
            live[:, None],
            self._node_tokens(f["node0"].long(), res["props"], res["sides"]),
            0)
        btab = (torch.where(live[:, None], f["tables"], 0) if self.paged
                else None)
        d0 = map_slot_leaves(
            lambda a: where_rows(reset, torch.zeros_like(a), a), dstate,
            keys=_KV_KEYS)
        x = torch.nn.functional.one_hot(tokens, self.vocab).to(torch.float32)
        y, stacks, wins = m.tree_chunk(params, d0, x, pos0.to(torch.int32),
                                       tr, n_in.to(torch.int32),
                                       block_tables=btab)
        N, V = tr.n_nodes, y.shape[-1]
        posn = pos0[:, None] + tr.tensors(dev).depth[None, :]
        oracle = oracle_tokens(
            torch.log(y.float()).reshape(S * N, V),
            seeds.repeat_interleave(N), posn.reshape(-1),
            temps.repeat_interleave(N), topk.repeat_interleave(N)
        ).reshape(S, N)
        accepted, emitted, spine_acc, path = tr.walk(tokens, oracle, n_in)
        rows = torch.arange(S, device=dev)
        node = path.gather(1, accepted[:, None])[:, 0]
        merged = rewound_state(m, d0, stacks, node, rows)
        merged = m.tree_commit(merged, wins, path, pos0, emitted,
                               block_tables=btab)
        merged = map_slot_leaves(lambda a, b: where_rows(live, a, b),
                                 merged, d0, keys=_KV_KEYS)
        copy_into(dstate, merged)
        emit = oracle.gather(1, path)
        emit = torch.where(torch.arange(tr.d + 1, device=dev)[None, :]
                           < emitted[:, None], emit, 0)
        return torch.cat([emit, accepted[:, None], emitted[:, None],
                          spine_acc[:, None]], dim=1).to(torch.int32)
