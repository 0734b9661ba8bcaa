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

A wrapper also hands ``count_launch`` the work of the launch, reckoned
from its shapes: the operations its products and sums do and the bytes it
must move (each input read once, each output written once). A ctypes
launch is invisible to PyTorch's dispatcher, so the program registry
(exec/programs.py) adds this work to what it counts over the dispatcher.
``kernel_work`` accumulates at every host call of a wrapper (an eager
call, a warm-up, a capture), never at a replay.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import torch

_COUNTS: Dict[str, int] = {}
_WORK: Dict[str, Tuple[float, float]] = {}
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


def count_launch(name: str, flops: float = 0.0, nbytes: float = 0.0
                 ) -> None:
    """One launch of kernel ``name``, doing ``flops`` operations and
    moving ``nbytes`` bytes."""
    with _COUNTS_LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
        f, b = _WORK.get(name, (0.0, 0.0))
        _WORK[name] = (f + float(flops), b + float(nbytes))


def kernel_work() -> Dict[str, Tuple[float, float]]:
    """(operations, bytes) per kernel, summed over every host call of its
    wrapper in this process (never reset)."""
    with _COUNTS_LOCK:
        return dict(_WORK)


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

__all__ = ["resolve_device", "count_launch", "kernel_work", "launch_counts",
           "reset_launch_counts", "add_launch_counts", "head_dim_supported",
           "fused_lstm_sequence",
           "fused_lstm_sequence_train", "fused_lstm_backward",
           "fused_lstm2_sequence", "fused_lstm2_sequence_train", "FusedLSTM",
           "FusedLSTM2", "lstm_sequence", "lstm2_sequence",
           "FlashAttention", "flash_attention", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_dq", "flash_attention_dkv",
           "flash_decode_step",
           "flash_decode_step_paged"]
