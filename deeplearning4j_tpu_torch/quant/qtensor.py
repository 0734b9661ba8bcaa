"""Weight-only low-precision serving: per-channel symmetric quantization.

Counterpart of deeplearning4j_tpu/quant/qtensor.py. A weight is stored as
int8 (or fp8-e4m3) codes and one float32 scale per OUTPUT channel, the
last axis (``(n_in, n_out)`` dense, ``(kh, kw, cin, cout)`` conv, the
gate-stacked ``(n_in, 4 n_out)`` LSTM kernel): a per-last-axis scale
commutes with the matmul's contraction, so dequantizing before the
matmul is exact up to the rounding paid at quantize time.

- ``int8``: codes ``clip(round(w / scale), -127, 127)``, ``round`` half
  to even (``torch.round``, as ``jnp.round``), ``scale = amax / 127``.
- ``fp8``: ``(w / scale)`` cast to ``torch.float8_e4m3fn`` (round to
  nearest even; a quotient is at most 448 by construction), ``scale =
  amax / 448``.
- ``f32``: the identity. ``quantize_tree`` returns the tree itself, so the
  float32 serving path is untouched.

The scale is 1 for a channel whose amax is 0 (or NaN), so an all-zero
channel round-trips exactly. The codes are the JAX package's byte for
byte on the same float32 input (tests/test_torch_quant.py compares them,
fp8 through their bits).

What quantizes: float leaves with ``ndim >= 2`` whose path matches no
``exclude`` token. Paths are the JAX package's ``keystr`` of the same
leaf (``[0]['W']``, ``['b0_attn']['Wq']``, ``[1]['enc'][0]['W']``): the
port keeps a layer's nested parameters flat under ``/`` keys
(``enc/0/W``), which ``keystr`` splits back into the JAX path, so one
``exclude`` selects the same leaves in both packages.

Where the JAX package leaves the dequantization to XLA, which fuses
``codes.astype(f32) * scale`` into the consuming matmul, the port runs it
as plain tensor code inside each engine's program (a CUDA graph on the
card): the weights rest at their quantized width and widen to a float32
copy before the unchanged float32 math. A fused weight-only
dequant-GEMM is a later item (ROADMAP queue 2b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

PRECISIONS = ("f32", "int8", "fp8")

# fp8-e4m3 (fn variant): the largest finite magnitude
_FP8_MAX = 448.0
_CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def resolve_precision(precision: Optional[str]) -> str:
    """Normalize and validate a precision name (None -> 'f32')."""
    p = (precision or "f32").strip().lower()
    aliases = {"float32": "f32", "fp32": "f32", "none": "f32",
               "i8": "int8", "e4m3": "fp8", "fp8_e4m3": "fp8",
               "float8": "fp8"}
    p = aliases.get(p, p)
    if p not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r} (want one of {PRECISIONS})")
    return p


@dataclass(frozen=True)
class QTensor:
    """One quantized weight: ``codes`` (int8 or float8_e4m3fn, the
    weight's shape) and ``scale`` (float32, one per last-axis channel,
    broadcastable against the codes). ``dequantize`` rebuilds float32."""

    codes: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.codes.shape

    @property
    def dtype(self):
        return self.codes.dtype

    @property
    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scale.numel() * self.scale.element_size())


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def _f32(w) -> torch.Tensor:
    t = w if isinstance(w, torch.Tensor) else torch.as_tensor(np.asarray(w))
    return t.to(torch.float32)


def _channel_amax(w: torch.Tensor) -> torch.Tensor:
    """max|w| per last-axis channel, keepdims: one scale per output
    channel, broadcastable against ``w``."""
    if w.ndim < 2:
        return w.abs()
    return w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)


def quantize(w, precision: str) -> QTensor:
    """Per-channel symmetric quantization of one float array (on its
    device; numpy goes to the CPU)."""
    w = _f32(w)
    amax = _channel_amax(w)
    # a tensor divisor on amax's device: on the card PyTorch turns a
    # division by a Python number into a multiplication by its reciprocal,
    # which can round the scale one ulp away from amax / 127
    limit = {"int8": 127.0, "fp8": _FP8_MAX}.get(precision)
    if limit is None:
        raise ValueError(f"quantize() wants int8/fp8, got {precision!r}")
    scale = torch.where(amax > 0, amax / amax.new_full((), limit), 1.0)
    if precision == "int8":
        codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    else:
        codes = (w / scale).to(torch.float8_e4m3fn)
    return QTensor(codes, scale.to(torch.float32))


def dequantize(qt: QTensor) -> torch.Tensor:
    """The float32 reconstruction, ``codes * scale``."""
    return qt.codes.to(torch.float32) * qt.scale


def _key(k) -> str:
    """The JAX ``keystr`` segment(s) of one key of the port's trees: a
    list index ``[i]``, a dict key ``['k']``, and a flat ``a/0/b`` key as
    the nested path it stands for (``['a'][0]['b']``)."""
    if not isinstance(k, str):
        return f"[{k!r}]"
    if "/" not in k:
        return f"[{k!r}]"
    return "".join(f"[{p}]" if p.isdigit() else f"[{p!r}]"
                   for p in k.split("/"))


def _map(fn, tree, path=""):
    """``fn(path, leaf)`` over the leaves of a tree of dicts, lists and
    tuples (a QTensor is a leaf), rebuilt with the results."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + _key(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaves(tree):
    """``[(keystr path, leaf)]`` in tree order."""
    out = []
    _map(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def keystr(tree) -> list:
    """The JAX ``keystr`` paths of ``tree``'s leaves, in order."""
    return [p for p, _ in _leaves(tree)]


def _floating(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def _eligible(path: str, leaf, exclude: Sequence[str]) -> bool:
    if _is_q(leaf) or getattr(leaf, "ndim", 0) < 2:
        return False
    if not _floating(leaf):
        return False
    return not any(tok in path for tok in exclude)


def quantize_tree(tree, precision: str, exclude: Sequence[str] = ()):
    """Quantize every eligible leaf of a weight tree; 'f32' returns the
    tree itself (the same objects)."""
    precision = resolve_precision(precision)
    if precision == "f32":
        return tree
    return _map(lambda p, leaf: quantize(leaf, precision)
                if _eligible(p, leaf, exclude) else leaf, tree)


def dequantize_tree(tree):
    """Float32 leaves rebuilt from any QTensor; other leaves pass through
    (the same objects), so on an unquantized tree this is the identity."""
    return _map(lambda p, x: dequantize(x) if _is_q(x) else x, tree)


def leaves_by_path(tree, prefix="", split_qtensors=True):
    """``{path: leaf}`` of a tree of dicts and lists of tensors or numpy
    arrays, paths as the checkpoint's (``0/W``; a nested ``{"fwd": {"W":
    w}}`` and a flat ``{"fwd/W": w}`` give the same ``0/fwd/W``). A
    QTensor gives its codes and scale (``.../0``, ``.../1``), as the JAX
    package flattens one, or with ``split_qtensors=False`` one leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif _is_q(tree) and split_qtensors:
        items = enumerate((tree.codes, tree.scale))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaves_by_path(v, f"{prefix}/{k}" if prefix else str(k),
                                  split_qtensors))
    return out


def _shapes(leaf):
    if _is_q(leaf):
        return ("q", tuple(leaf.codes.shape), tuple(leaf.scale.shape))
    return tuple(leaf.shape)


def copy_tree(dst, src):
    """Write ``src`` into ``dst`` in place, each leaf into the one of the
    same PATH (``leaves_by_path``: the order of a dict's keys, and whether
    it is nested or flat, do not count): a QTensor by its codes and scale,
    a tensor by ``copy_``. Programs that read ``dst`` by address see the
    new values. Nothing is written unless the two path sets are equal and
    each pair has one shape (else ``ValueError``). Returns ``dst``."""
    dsts = leaves_by_path(dst, split_qtensors=False)
    srcs = leaves_by_path(src, split_qtensors=False)
    problems = ([f"missing {k!r}" for k in sorted(set(dsts) - set(srcs))]
                + [f"unexpected {k!r}" for k in sorted(set(srcs) - set(dsts))]
                + [f"{k!r}: {_shapes(srcs[k])} into {_shapes(d)}"
                   for k, d in sorted(dsts.items())
                   if k in srcs and _shapes(srcs[k]) != _shapes(d)])
    if problems:
        raise ValueError("copy_tree: " + "; ".join(problems))
    with torch.no_grad():
        for k, d in dsts.items():
            s = srcs[k]
            if _is_q(d):
                d.codes.copy_(s.codes)
                d.scale.copy_(s.scale)
            elif s is not d:
                d.copy_(torch.as_tensor(s))
    return dst


def _leaf_bytes(leaf) -> int:
    if _is_q(leaf):
        return leaf.nbytes
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def tree_bytes(tree) -> int:
    """Weight bytes of a (possibly quantized) tree: codes and scales for
    QTensor leaves, the array's bytes otherwise."""
    return int(sum(_leaf_bytes(leaf) for _, leaf in _leaves(tree)))


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, np.float32)


def quant_error_report(tree, qtree) -> dict:
    """Per-leaf max abs error of a quantized tree against its float32
    source, keyed by path, plus ``"max"`` (the worst leaf) and
    ``"rel_max"`` (the worst error over its leaf's amax)."""
    report, worst, worst_rel = {}, 0.0, 0.0
    flat = dict(_leaves(tree))
    for key, ql in _leaves(qtree):
        if not _is_q(ql):
            continue
        w = _numpy(flat[key])
        err = float(np.max(np.abs(w - _numpy(dequantize(ql)))))
        amax = float(np.max(np.abs(w)))
        report[key] = err
        worst = max(worst, err)
        if amax > 0:
            worst_rel = max(worst_rel, err / amax)
    report["max"] = worst
    report["rel_max"] = worst_rel
    return report


# ------------------------------------------------------------------ metrics
def record_weight_bytes(engine: str, precision: str, nbytes: int) -> None:
    """Publish ``dl4jtpu_weight_bytes{engine, precision}``: the serving
    engine's resident weight bytes (codes and scales when quantized)."""
    from deeplearning4j_tpu_torch.monitor import get_registry
    get_registry().gauge(
        "dl4jtpu_weight_bytes",
        "Device-resident serving weight bytes per engine and precision "
        "(codes + scales for quantized trees).",
        ("engine", "precision")).labels(
            engine=engine, precision=precision).set(float(nbytes))


def record_accuracy_delta(engine: str, delta: float) -> None:
    """Publish ``dl4jtpu_quant_accuracy_delta{engine}``: the quantized
    serving path's end-to-end accuracy less the float32 path's."""
    from deeplearning4j_tpu_torch.monitor import get_registry
    get_registry().gauge(
        "dl4jtpu_quant_accuracy_delta",
        "End-to-end eval accuracy delta of the quantized serving path vs "
        "f32 (0 when serving f32).", ("engine",)).labels(
            engine=engine).set(float(delta))
