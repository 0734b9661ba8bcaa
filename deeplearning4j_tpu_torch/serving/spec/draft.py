"""The draft half of speculative decoding: a model proposing a token tree
a scheduler tick.

Counterpart of deeplearning4j_tpu/serving/spec/draft.py. The draft's state
is slot-aligned with the owning engine's: slot i shadows slot i. One call
steps the draft model's ``decode_step`` over up to ``k`` positions for
all S slots at once: position t feeds ``given[:, t]`` while t < n_given
(prompt or correction tokens from the host), the draft's own previous
proposal after that, and proposes through the engine's sampling rule
(``oracle_token``) at the stream's (seed, position), so under sampling the
draft's draw shares the target's noise. Each position also yields
``side_k`` alternatives (the best other tokens, the proposal masked out)
for the tree's side branches.

Recurrent carries are snapshotted after every position in (S, k, ...)
stacks; the next call resumes each slot from stack entry ``sel``.
Attention KV is always dense here and positional: a row past its step
count, or a slot outside this call, writes at the position its stream
feeds next, which is rewritten before it is read.

The sampling rule runs on the host, so each position copies the (S, V)
log-probabilities from the card before the next can be fed; the JAX
package scans all k positions inside one program.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.layers.base import where_rows
from deeplearning4j_tpu_torch.serving.spec.accept import oracle_token
from deeplearning4j_tpu_torch.serving.spec.rewind import map_state
from deeplearning4j_tpu_torch.serving.spec.selfdraft import quant_not_ported


def side_tokens(logits: np.ndarray, prop: int, side_k: int) -> np.ndarray:
    """The ``side_k`` best tokens of one row other than ``prop``, best
    first, ties to the lower id."""
    masked = logits.astype(np.float64).copy()
    masked[prop] = -np.inf
    return np.argsort(-masked, kind="stable")[:side_k]


class DraftEngine:
    """Tree-draft proposer for one DecodeEngine. ``k``: positions a call
    (the tree's depth + 1, the extra one keeping a resume snapshot at full
    acceptance); ``side_k``: alternatives a position (0 for a linear
    draft). ``precision`` (int8/fp8 weights) is not ported and raises."""

    def __init__(self, model, slots, max_len, k, vocab, precision=None,
                 side_k=0):
        if precision is not None:
            raise quant_not_ported(f"draft_precision={precision!r}")
        self.model = model
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.k = int(k)
        self.side_k = int(side_k)
        self.vocab = int(vocab)
        self.calls = 0           # draft calls
        self.steps = 0           # batched decode steps of the draft model
        self._tree = None

    def ensure_state(self):
        """The draft's decode state (dense KV), every carry leaf widened to
        an (S, k, ...) snapshot stack."""
        if self._tree is None:
            base = self.model.init_decode_state(self.slots, self.max_len)
            self._tree = map_state(
                self.model, base,
                on_carry=lambda a: torch.zeros(
                    (a.shape[0], self.k) + tuple(a.shape[1:]),
                    dtype=a.dtype, device=a.device),
                on_positional=lambda a: a)

    @torch.no_grad()
    def step(self, given, n_given, n_steps, pos0, sel, reset, seeds, temps,
             topk):
        """One draft tick for all S slots (numpy (S,) arrays, ``given``
        (S, k)): slot i resumes its carries from snapshot ``sel[i]`` (after
        a zero wipe where ``reset``), feeds ``given[i, :n_given[i]]`` then
        its own proposals for ``n_steps[i]`` positions from ``pos0[i]`` (0
        = an inert slot, its snapshots unchanged; its KV writes go to
        ``pos0[i]``, the position it feeds next). Returns the (S, k) spine
        proposals and the (S, k, side_k) alternatives."""
        self.ensure_state()
        S, K, m = self.slots, self.k, self.model
        dev = m.device
        n_steps = np.asarray(n_steps)
        live_rows = torch.as_tensor(n_steps > 0, device=dev)
        reset_t = torch.as_tensor(np.asarray(reset, bool), device=dev)
        rows = torch.arange(S, device=dev)
        sel_t = torch.as_tensor(np.asarray(sel), device=dev).long()
        stacks0 = map_state(m, self._tree,
                            on_carry=lambda a: where_rows(
                                reset_t, torch.zeros_like(a), a),
                            on_positional=lambda a: a)
        d = map_state(m, stacks0, on_carry=lambda a: a[rows, sel_t],
                      on_positional=lambda a: a)
        props = np.zeros((S, K), np.int64)
        sides = np.zeros((S, K, self.side_k), np.int64)
        eye = torch.eye(self.vocab, dtype=torch.float32, device=dev)
        snaps = []
        prev = np.zeros(S, np.int64)
        for t in range(int(n_steps.max(initial=0))):
            tok = np.where(t < np.asarray(n_given), np.asarray(given)[:, t],
                           prev)
            pos = np.minimum(np.asarray(pos0) + np.minimum(t, n_steps),
                             self.max_len - 1)
            y, nd = m.decode_step(
                m.params, d, eye[torch.as_tensor(tok, device=dev)][:, None],
                torch.as_tensor(pos, dtype=torch.int32, device=dev))
            self.steps += 1
            live = t < n_steps
            live_t = torch.as_tensor(live, device=dev)
            d = map_state(m, nd,
                          on_carry=lambda a, b: where_rows(live_t, a, b),
                          on_positional=lambda a, b: a, rest=(d,))
            snaps.append(d)
            logits = torch.log(y[:, 0, :].float()).cpu().numpy()
            for i in np.flatnonzero(live):
                props[i, t] = oracle_token(logits[i], seeds[i], pos0[i] + t,
                                           temps[i], topk[i])
                if self.side_k:
                    sides[i, t] = side_tokens(logits[i], props[i, t],
                                              self.side_k)
            prev = props[:, t]
        if snaps:
            T = len(snaps)

            def restack(old, *snap):
                new = old.clone()
                new[:, :T] = torch.stack(snap, dim=1)
                return where_rows(live_rows, new, old)
            self._tree = map_state(m, stacks0, on_carry=restack,
                                   on_positional=lambda a, *s: a,
                                   rest=tuple(snaps))
        else:
            self._tree = stacks0
        self.calls += 1
        return props, sides

