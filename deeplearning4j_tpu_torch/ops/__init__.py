"""Device helpers and per-kernel launch counters.

Counterpart of deeplearning4j_tpu/ops/__init__.py, without its helper
switch: in this package a kernel wrapper given a CUDA tensor launches its
hand-written kernel or raises, and nothing turns the kernels off. The CPU
runs each kernel's plain PyTorch version, chosen only because the tensors
lie on the CPU.

The launch counters let a run show that its main path went through the
kernels: a wrapper adds one to its kernel's count each time it launches
it, and nowhere else; a replayed CUDA graph adds the launches its capture
recorded (``add_launch_counts``, exec/executor.py).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

import torch

_COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is wanted and no card is present, so nothing
    quietly continues on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def count_launch(name: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last ``reset_launch_counts``."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset_launch_counts() -> None:
    with _COUNTS_LOCK:
        _COUNTS.clear()


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel -> launches) to the counters: a replayed CUDA
    graph adds the launches its capture recorded (exec/executor.py)."""
    with _COUNTS_LOCK:
        for name, n in counts.items():
            left = _COUNTS.get(name, 0) + n
            # a count taken back to 0 leaves no key, as if never launched
            if left:
                _COUNTS[name] = left
            else:
                _COUNTS.pop(name, None)


def head_dim_supported(head_dim: int) -> bool:
    """The head dims the attention kernels (K5-K9) take: the positive
    multiples of 8, the head-dim clause of the JAX package's flash screens
    (``ops/flash_attention.py::supported``, ``ops/flash_decode.py::
    supported`` and ``::supported_paged``). The attention layer screens with
    it, and the kernel wrappers refuse any other head dim on the card."""
    return head_dim > 0 and head_dim % 8 == 0


from deeplearning4j_tpu_torch.ops.lstm_cuda import (  # noqa: E402
    FusedLSTM, FusedLSTM2, fused_lstm2_sequence, fused_lstm2_sequence_train,
    fused_lstm_backward, fused_lstm_sequence, fused_lstm_sequence_train,
    lstm2_sequence, lstm_sequence)
from deeplearning4j_tpu_torch.ops.attention_cuda import (  # noqa: E402
    FlashAttention, flash_attention, flash_attention_bwd, flash_attention_dkv,
    flash_attention_dq, flash_attention_fwd)
from deeplearning4j_tpu_torch.ops.decode_cuda import (  # noqa: E402
    flash_decode_step, flash_decode_step_paged)

__all__ = ["resolve_device", "count_launch", "launch_counts",
           "reset_launch_counts", "add_launch_counts", "head_dim_supported",
           "fused_lstm_sequence",
           "fused_lstm_sequence_train", "fused_lstm_backward",
           "fused_lstm2_sequence", "fused_lstm2_sequence_train", "FusedLSTM",
           "FusedLSTM2", "lstm_sequence", "lstm2_sequence",
           "FlashAttention", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_dq", "flash_attention_dkv",
           "flash_decode_step",
           "flash_decode_step_paged"]
