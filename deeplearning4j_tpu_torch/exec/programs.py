"""Registry of the port's programs with their cost.

Counterpart of deeplearning4j_tpu/exec/programs.py. Every program the
port builds registers here, keyed by ``(caller, key)``: the containers'
train steps (``StepGraphs``: ``("mln0", "train_step_b32")``,
``("cg0", "apply_updates")``), the bucketed engine's rungs (``b{B}`` /
``b{B}_mask``) and the decode engine's ``step``, ``prefill``, ``cow``,
``draft`` and ``verify`` (``ResidentProgram``). A program is a CUDA graph
on the card and an eager function elsewhere; both register, once per
signature.

The JAX package reads XLA's ``cost_analysis`` and ``memory_analysis``.
The port has neither, so it reckons a record's numbers over the eager
warm-up call that precedes each capture (``Cost``):

- ``flops``: PyTorch's ``FlopCounterMode`` over the aten operations, plus
  the operations of the hand-written kernels, which their wrappers count
  from their shapes (``ops.count_launch``; a ctypes launch is invisible to
  the dispatcher). ``kernel_flops`` is the kernels' share.
- ``bytes``: each aten operation's input and output bytes (views move
  none), plus the kernels' bytes (``kernel_bytes``).
- ``memory_bytes``: the bytes the caching allocator holds in the captured
  graph's private pool; None for an eager program.
- ``compile_seconds``: the wall time of the warm-up plus the capture.
- ``launches``: the hand-kernel launches one call adds (a replay adds its
  capture's), kernel -> count.

Registering adds no capture, no replay and no call: the warm-up was going
to run anyway. The ``dl4jtpu_program_{flops,bytes,memory_bytes,
compile_seconds}`` gauges, labelled ``{caller, key}``, carry the numbers
to ``/metrics``, and ``GET /programs`` on the inference server serves the
table.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from deeplearning4j_tpu_torch import ops

__all__ = ["ProgramRegistry", "get_programs", "is_registering"]


_REGISTERING = threading.local()


def is_registering() -> bool:
    """True while this thread measures a program for registration (a
    ``record`` given a function to run): accounting side effects inside
    the measured body must not count it as a call."""
    return getattr(_REGISTERING, "on", False)


class _Registering:
    __slots__ = ()

    def __enter__(self):
        _REGISTERING.on = True
        return self

    def __exit__(self, *exc):
        _REGISTERING.on = False
        return False


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


class _ByteCounter(TorchDispatchMode):
    """Sums each aten operation's input and output bytes; a view moves
    none."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.nbytes += (_tensor_bytes(args) + _tensor_bytes(kwargs)
                            + _tensor_bytes(out))
        return out


class Cost:
    """``with Cost() as c: ...``: the operations, bytes, kernel launches
    and wall seconds of the block (the module docstring says how)."""

    def __enter__(self):
        self._flops = FlopCounterMode(display=False)
        self._bytes = _ByteCounter()
        self._work0 = ops.kernel_work()
        self._launch0 = ops.launch_counts()
        self._t0 = time.perf_counter()
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        self.seconds = time.perf_counter() - self._t0
        work = ops.kernel_work()
        self.kernel_flops = sum(f - self._work0.get(k, (0.0, 0.0))[0]
                                for k, (f, _) in work.items())
        self.kernel_bytes = sum(b - self._work0.get(k, (0.0, 0.0))[1]
                                for k, (_, b) in work.items())
        self.flops = float(self._flops.get_total_flops()) + self.kernel_flops
        self.bytes = float(self._bytes.nbytes) + self.kernel_bytes
        after = ops.launch_counts()
        self.launches = {k: n - self._launch0.get(k, 0)
                         for k, n in after.items()
                         if n != self._launch0.get(k, 0)}
        return False

    def fields(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes}


def graph_pool_bytes(graph) -> Optional[int]:
    """Bytes the caching allocator holds in ``graph``'s private memory
    pool, from its segment snapshot; None where the snapshot does not name
    each segment's pool."""
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == pool)


class ProgramRegistry:
    """Process-wide table of registered programs (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._programs = {}        # (caller, key) -> record dict
        self._gauges = None

    def _metric(self, record):
        if self._gauges is None:
            from deeplearning4j_tpu_torch.monitor.metrics import get_registry
            reg = get_registry()
            self._gauges = {
                "flops": reg.gauge(
                    "dl4jtpu_program_flops",
                    "Operations of one call of the registered program "
                    "(aten operations and hand-kernel launches)",
                    labelnames=("caller", "key")),
                "bytes": reg.gauge(
                    "dl4jtpu_program_bytes",
                    "Bytes one call of the registered program reads and "
                    "writes", labelnames=("caller", "key")),
                "memory_bytes": reg.gauge(
                    "dl4jtpu_program_memory_bytes",
                    "Bytes of the captured graph's private memory pool",
                    labelnames=("caller", "key")),
                "compile_seconds": reg.gauge(
                    "dl4jtpu_program_compile_seconds",
                    "Wall seconds of the program's warm-up and capture",
                    labelnames=("caller", "key")),
            }
        lbl = {"caller": record["caller"], "key": record["key"]}
        for field, fam in self._gauges.items():
            v = record.get(field)
            if v is not None:
                fam.labels(**lbl).set(v)

    def record(self, caller: str, key: str, fn=None, args=(),
               compile_seconds: Optional[float] = None, *,
               cost: Optional[Cost] = None, memory_bytes=None,
               launches=None, replace: bool = False) -> Optional[dict]:
        """Register program ``(caller, key)`` with ``cost`` (a ``Cost``
        taken over its warm-up); without one, ``fn(*args)`` is run once
        under a ``Cost`` (for side-effect-free functions only). A known
        key is not registered again (the existing record is returned)
        unless ``replace``: a capture's record replaces the eager one."""
        caller, key = str(caller), str(key)
        with self._lock:
            existing = self._programs.get((caller, key))
        if existing is not None and not replace:
            return existing
        if cost is None:
            if fn is None:
                return None
            with _Registering(), Cost() as cost:
                fn(*args)
        record = {
            "caller": caller, "key": key,
            **cost.fields(),
            "memory_bytes": memory_bytes,
            "compile_seconds": (compile_seconds if compile_seconds is not None
                                else cost.seconds),
            "launches": dict(cost.launches if launches is None
                             else launches),
        }
        with self._lock:
            if replace:
                self._programs[(caller, key)] = existing = record
            else:
                # lost a race: keep the first registration
                existing = self._programs.setdefault((caller, key), record)
        if existing is record:
            self._metric(record)
        return existing

    def get(self, caller: str, key: str) -> Optional[dict]:
        with self._lock:
            return self._programs.get((str(caller), str(key)))

    def last(self, caller: str) -> Optional[dict]:
        """Most recently registered program of ``caller``."""
        caller = str(caller)
        with self._lock:
            out = None
            for (c, _), rec in self._programs.items():
                if c == caller:
                    out = rec
            return out

    def entries(self) -> list:
        with self._lock:
            return [dict(rec) for rec in self._programs.values()]

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()


_programs = ProgramRegistry()


def get_programs() -> ProgramRegistry:
    """The process-wide program registry (analog of
    ``monitor.get_registry()``)."""
    return _programs
