"""Low-precision serving: weight-only int8 / fp8-e4m3 quantization.

Counterpart of deeplearning4j_tpu/quant/. ``qtensor.py`` owns the
mechanism; the policy is ``exec.Executor(precision=...)`` /
``DL4JTPU_PRECISION``, and the engines (serving/engine.py,
serving/decode.py, serving/spec/draft.py) quantize at load and swap time
and dequantize inside their programs.
"""

from deeplearning4j_tpu_torch.quant.qtensor import (  # noqa: F401
    PRECISIONS, QTensor, copy_tree, dequantize, dequantize_tree, keystr,
    leaves_by_path, quant_error_report, quantize, quantize_tree, record_accuracy_delta,
    record_weight_bytes, resolve_precision, tree_bytes)

__all__ = [
    "PRECISIONS", "QTensor", "quantize", "dequantize",
    "quantize_tree", "dequantize_tree", "tree_bytes",
    "quant_error_report", "resolve_precision",
    "record_weight_bytes", "record_accuracy_delta", "copy_tree", "keystr",
    "leaves_by_path",
]
