"""Self-drafting: the target as its own draft, with no second checkpoint.

Counterpart of deeplearning4j_tpu/serving/spec/selfdraft.py. Two forms:

- ``self_draft="int8"`` / ``"fp8"``: the draft IS the target, run from a
  quantized copy of its weights (quant/, dequantized inside the draft
  program). It agrees with the float32 target almost always, so
  acceptance is near 1; it pays where the verify's one batched call
  costs less than the plain steps it replaces.
- ``self_draft="early_exit:M"``: a view of a MultiLayerNetwork target, its
  first M layers and its readout layer, the weights shared with the
  target (quantized too under ``draft_precision``).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork as _MLN)

SELF_DRAFT_QUANT = ("int8", "fp8")


def parse_self_draft(mode):
    """A ``self_draft`` mode as ``("quant", precision)`` or
    ``("early_exit", M)``."""
    if mode in SELF_DRAFT_QUANT:
        return ("quant", mode)
    if isinstance(mode, str) and mode.startswith("early_exit:"):
        try:
            m = int(mode.split(":", 1)[1])
        except ValueError:
            m = 0
        if m < 1:
            raise ValueError(
                f"self_draft {mode!r}: early_exit needs a positive layer "
                "count, e.g. 'early_exit:1'")
        return ("early_exit", m)
    raise ValueError(
        f"self_draft must be one of {SELF_DRAFT_QUANT} or 'early_exit:M', "
        f"got {mode!r}")


class EarlyExitDraft:
    """Layers ``0..M-1`` and the readout of a MultiLayerNetwork target,
    their parameters the target's own (``params`` reads them on every
    call). ``init_decode_state`` and ``decode_step`` are the
    MultiLayerNetwork's over the shortened stack."""

    def __init__(self, target, m):
        if hasattr(target.conf, "network_inputs"):
            raise ValueError(
                "early_exit self-drafting needs a MultiLayerNetwork "
                "target (a graph has no unique layer stack to truncate); "
                "use self_draft='int8'/'fp8' instead")
        m = int(m)
        if not 1 <= m <= len(target.layers) - 1:
            raise ValueError(
                f"early_exit:{m} out of range for a "
                f"{len(target.layers)}-layer target (need 1 <= M <= "
                f"{len(target.layers) - 1})")
        readout, last = target.layers[-1], target.layers[m - 1]
        n_mid = getattr(last, "n_out", None) or getattr(last, "n_in", None)
        n_ro = getattr(readout, "n_in", None)
        if n_mid and n_ro and n_mid != n_ro:
            raise ValueError(
                f"early_exit:{m}: layer {m - 1} outputs {n_mid} features "
                f"but the readout expects {n_ro} — early exit needs a "
                "width-compatible truncation point")
        self._target = target
        self.m = m
        self.conf = target.conf
        self.device = target.device
        self.layers = list(target.layers[:m]) + [readout]

    @property
    def params(self):
        t = self._target.params
        return [t[i] for i in range(self.m)] + [t[-1]]

    _compute_dtype = _MLN._compute_dtype
    _cast_decode = _MLN._cast_decode
    init_decode_state = _MLN.init_decode_state
    decode_step = _MLN.decode_step


def build_self_draft(target, spec):
    """``SpecConfig.self_draft`` resolved to ``(draft_model, precision)``
    for the DraftEngine: the target itself at int8 / fp8, or its early-
    exit view at ``draft_precision``."""
    kind, arg = parse_self_draft(spec.self_draft)
    if kind == "quant":
        if spec.draft_precision not in (None, arg):
            raise ValueError(
                f"self_draft={spec.self_draft!r} conflicts with "
                f"draft_precision={spec.draft_precision!r}")
        return target, arg
    return EarlyExitDraft(target, arg), spec.draft_precision
