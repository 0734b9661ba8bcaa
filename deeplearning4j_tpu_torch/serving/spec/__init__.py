"""Speculative decoding: a draft proposes a token tree a tick, the target
verifies every node in one batched call, and the emitted stream stays the
plain engine's token for token (greedy and seeded sampling), because the
draft, the verify and the plain step share one sampling rule
(accept.py).

Counterpart of deeplearning4j_tpu/serving/spec/. Modules:

- ``accept.py`` -- the sampling rule ``oracle_tokens`` (tensor code, run
  inside the programs) and ``accept_length``;
- ``tree.py`` -- static tree shapes, their device tables and the
  acceptance walk;
- ``draft.py`` -- the draft program (spine and side proposals over all
  k positions, carry snapshot stacks for rewind);
- ``verify.py`` -- the verify program: the batched target ``tree_chunk``,
  the rule at every node, the walk, the carries' rewind and the accepted
  path's ``tree_commit``;
- ``rewind.py`` -- carry and positional decode state;
- ``selfdraft.py`` -- the target as its own draft (``int8`` / ``fp8``,
  ``early_exit:M``).

Wiring: ``DecodeEngine(spec=SpecConfig(...))``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from deeplearning4j_tpu_torch.serving.spec.accept import (accept_length,
                                                          oracle_token,
                                                          oracle_tokens)
from deeplearning4j_tpu_torch.serving.spec.draft import DraftEngine
from deeplearning4j_tpu_torch.serving.spec.tree import TreeSpec, parse_kvec
from deeplearning4j_tpu_torch.serving.spec.verify import SpecVerifier


@dataclass
class SpecConfig:
    """Speculative decoding settings for ``DecodeEngine(spec=...)``.

    ``draft_model``: a MultiLayerNetwork or ComputationGraph with the
    decode protocol over the target's vocabulary, or None with
    ``self_draft`` set. ``k``: spine length of the default linear tree
    (ignored when ``tree`` is given). ``tree``: branching factors per
    depth, e.g. ``(3, 2, 2)``. ``self_draft``: ``"int8"`` / ``"fp8"``
    (the target itself from a quantized copy of its weights) or
    ``"early_exit:M"`` (the target's first M layers and its readout).
    ``draft_precision``: ``"int8"`` / ``"fp8"`` quantize the draft's
    weights (quant/), dequantized inside the draft program."""

    draft_model: Any = None
    k: int = 4
    tree: Optional[Tuple[int, ...]] = None
    self_draft: Optional[str] = None
    draft_precision: Optional[str] = None

    def kvec(self) -> Tuple[int, ...]:
        """The tree's shape: ``tree``, or the linear ``(1,) * k``."""
        if self.tree is not None:
            return tuple(int(v) for v in self.tree)
        return (1,) * int(self.k)


__all__ = ["SpecConfig", "DraftEngine", "SpecVerifier", "TreeSpec",
           "parse_kvec", "accept_length", "oracle_token", "oracle_tokens"]
