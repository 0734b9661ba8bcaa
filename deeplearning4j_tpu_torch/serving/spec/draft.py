"""The draft half of speculative decoding: a model proposing a token tree
a scheduler tick.

Counterpart of deeplearning4j_tpu/serving/spec/draft.py. The draft's state
is slot-aligned with the owning engine's: slot i shadows slot i. One call
is ONE program (exec.ResidentProgram): it steps the draft model's
``decode_step`` over all ``k`` positions for all S slots, as the JAX
package's ``lax.scan`` does, whatever the rows ask for; position t feeds
``given[:, t]`` while t < n_given (prompt or correction tokens from the
host), the draft's own previous proposal after that, and proposes through
the engine's sampling rule (``oracle_tokens``, on the card) at the
stream's (seed, position), so under sampling the draft's draw shares the
target's noise. Positions at or past a row's step count are inert: its
carries stay frozen and its proposals are 0. Each position also yields
``side_k`` alternatives (the best other tokens, the proposal masked out,
a stable descending sort so ties go to the lower id) for the tree's side
branches. The proposals land in the resident ``props`` / ``sides``
tensors, which the verify program reads on the card: nothing comes back
to the host.

``precision`` (``draft_precision``, or the int8 / fp8 self-draft) keeps
the draft's own parameter set as int8 or fp8 codes and per-channel
scales (quant/), quantized from the float32 weights it drafts with and
dequantized inside the program; ``refresh`` writes a new float32 source
into that set in place (the owning engine calls it when its weights
move), so the captured program keeps its addresses.

Recurrent carries are snapshotted after every position in (S, k, ...)
stacks; the next call resumes each slot from stack entry ``sel``.
Attention KV is always dense here and positional: a row past its step
count, or a slot outside this call, writes at the position its stream
feeds next, which is rewritten before it is read.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.exec.executor import (HostStage, Layout,
                                                    ResidentProgram)
from deeplearning4j_tpu_torch.nn.layers.base import where_rows
from deeplearning4j_tpu_torch.quant import (copy_tree, dequantize_tree,
                                            quantize_tree,
                                            record_weight_bytes,
                                            resolve_precision, tree_bytes)
from deeplearning4j_tpu_torch.serving.spec.accept import oracle_tokens
from deeplearning4j_tpu_torch.serving.spec.rewind import map_state


def side_tokens(logits, props, side_k):
    """The ``side_k`` best tokens of each row of ``logits`` (S, V) other
    than ``props`` (S,), best first, ties to the lower id."""
    masked = logits.scatter(1, props[:, None], float("-inf"))
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    return order[:, :side_k]


class DraftEngine:
    """Tree-draft proposer for one DecodeEngine. ``k``: positions a call
    (the tree's depth + 1, the extra one keeping a resume snapshot at full
    acceptance); ``side_k``: alternatives a position (0 for a linear
    draft); ``params``: the parameter set the program reads (the draft
    model's own by default). ``precision`` (``"int8"`` / ``"fp8"``):
    the program reads a quantized copy of those parameters instead (of
    ``source``, their float32 form, when ``params`` is already an engine's
    quantized set); ``owner`` names the engine in the weight-bytes
    gauge."""

    def __init__(self, model, slots, max_len, k, vocab, precision=None,
                 side_k=0, params=None, source=None, owner="decode"):
        self.model = model
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.k = int(k)
        self.side_k = int(side_k)
        self.vocab = int(vocab)
        self.precision = (resolve_precision(precision)
                          if precision is not None else "f32")
        self.params = model.params if params is None else params
        if self.precision != "f32":
            self.params = quantize_tree(
                self.params if source is None else source, self.precision)
            record_weight_bytes(f"{owner}-draft", self.precision,
                                tree_bytes(self.params))
        self.calls = 0           # draft calls
        self.steps = 0           # batched decode steps of the draft model
        self._tree = None
        self.props = self.sides = None
        S, K = self.slots, self.k
        self.layout = Layout(given=(S, K), n_given=(S,), n_steps=(S,),
                             pos0=(S,), sel=(S,), reset=(S,),
                             seeds=((S,), np.uint32),
                             temps=((S,), np.float32), topk=(S,))
        self._program = self._stage = None

    @property
    def programs(self) -> int:
        """Programs of the draft (captured graphs on the card)."""
        return 0 if self._program is None else self._program.programs

    @property
    def weight_bytes(self) -> int:
        return tree_bytes(self.params)

    @torch.no_grad()
    def refresh(self, source) -> None:
        """Quantize ``source`` (the float32 weights this draft drafts
        with) into the draft's own set in place; a float32 draft shares
        its owner's tensors and has nothing to do."""
        if self.precision != "f32":
            copy_tree(self.params, quantize_tree(source, self.precision))

    def ensure_state(self):
        """The draft's decode state (dense KV), every carry leaf widened to
        an (S, k, ...) snapshot stack, and the resident proposals."""
        if self._tree is None:
            base = self.model.init_decode_state(self.slots, self.max_len)
            self._tree = map_state(
                self.model, base,
                on_carry=lambda a: torch.zeros(
                    (a.shape[0], self.k) + tuple(a.shape[1:]),
                    dtype=a.dtype, device=a.device),
                on_positional=lambda a: a)
            dev = self.model.device
            self.props = torch.zeros((self.slots, self.k), dtype=torch.int64,
                                     device=dev)
            self.sides = torch.zeros((self.slots, self.k, self.side_k),
                                     dtype=torch.int64, device=dev)

    def resident(self) -> dict:
        """What the draft program reads and writes by address."""
        return {"params": self.params, "state": self._tree,
                "props": self.props, "sides": self.sides}

    def build(self, executor, capture):
        """The draft program (``capture=False``: eager on the card)."""
        self.ensure_state()
        self._program = ResidentProgram(executor, self._run, "draft",
                                        capture=capture)
        self._stage = HostStage(self.layout, self.model.device)
        return self._program

    def step(self, given, n_given, n_steps, pos0, sel, reset, seeds, temps,
             topk):
        """One draft tick for all S slots (numpy (S,) arrays, ``given``
        (S, k)): slot i resumes its carries from snapshot ``sel[i]`` (after
        a zero wipe where ``reset``), feeds ``given[i, :n_given[i]]`` then
        its own proposals for ``n_steps[i]`` positions from ``pos0[i]`` (0
        = an inert slot, its snapshots unchanged; its KV writes go to
        ``pos0[i]``, the position it feeds next). Returns the resident
        (S, k) spine proposals and (S, k, side_k) alternatives, which the
        program just wrote on the device."""
        f = self._stage.open()
        for name, v in (("given", given), ("n_given", n_given),
                        ("n_steps", n_steps), ("pos0", pos0), ("sel", sel),
                        ("reset", reset), ("seeds", seeds),
                        ("temps", temps), ("topk", topk)):
            f[name][...] = v
        self._program(self.resident(), self._stage.tensor)
        self._stage.sent()
        self.calls += 1
        self.steps += self.k
        return self.props, self.sides

    @torch.no_grad()
    def _run(self, res, buf):
        """The program body: all ``k`` positions, then the snapshot stacks,
        proposals and alternatives written into the resident tensors."""
        f = self.layout.unpack(buf)
        S, K, m = self.slots, self.k, self.model
        dev = buf.device
        params = dequantize_tree(res["params"])
        given = f["given"].long()
        n_given, n_steps = f["n_given"].long(), f["n_steps"].long()
        pos0, sel = f["pos0"].long(), f["sel"].long()
        reset = f["reset"] != 0
        seeds, temps, topk = f["seeds"], f["temps"], f["topk"]
        live_rows = n_steps > 0
        rows = torch.arange(S, device=dev)
        stacks0 = map_state(m, res["state"],
                            on_carry=lambda a: where_rows(
                                reset, torch.zeros_like(a), a),
                            on_positional=lambda a: a)
        d = map_state(m, stacks0, on_carry=lambda a: a[rows, sel],
                      on_positional=lambda a: a)
        snaps, props, sides = [], [], []
        prev = torch.zeros(S, dtype=torch.int64, device=dev)
        for t in range(K):
            tok = torch.where(t < n_given, given[:, t], prev)
            pos = (pos0 + n_steps.clamp(max=t)).clamp(max=self.max_len - 1)
            x = torch.nn.functional.one_hot(tok, self.vocab).to(
                torch.float32)[:, None]
            y, nd = m.decode_step(params, d, x, pos.to(torch.int32))
            live = t < n_steps
            d = map_state(m, nd,
                          on_carry=lambda a, b: where_rows(live, a, b),
                          on_positional=lambda a, b: a, rest=(d,))
            snaps.append(d)
            logits = torch.log(y[:, 0, :].float())
            p = torch.where(live, oracle_tokens(logits, seeds, pos0 + t,
                                                temps, topk), 0)
            props.append(p)
            if self.side_k:
                sides.append(torch.where(
                    live[:, None], side_tokens(logits, p, self.side_k), 0))
            prev = p

        def restack(old, *snap):
            return where_rows(live_rows, torch.stack(snap, dim=1), old)
        map_state(m, stacks0, on_carry=restack,
                  on_positional=lambda a, *s: a, rest=tuple(snaps),
                  into=res["state"])
        res["props"].copy_(torch.stack(props, dim=1))
        if self.side_k:
            res["sides"].copy_(torch.stack(sides, dim=1))
