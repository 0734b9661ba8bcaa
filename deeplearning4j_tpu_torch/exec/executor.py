"""The execution core of the port on one card: the training- and
serving-precision policies, and a train step turned into a captured CUDA
graph.

Counterpart of deeplearning4j_tpu/exec/executor.py: ``Executor`` with its
``train_precision`` policy (``DL4JTPU_TRAIN_PRECISION``, the same values
and the same ``ValueError``) and ``train_dtype``, its serving
``precision`` (``DL4JTPU_PRECISION``: ``f32``, ``int8`` or ``fp8``, with
quant/'s aliases and ``ValueError``) and ``prepare_params``, which every
engine built against the executor applies to its weights at load and
swap time, and ``get_executor`` / ``set_executor``. Where the JAX
package's ``Executor.jit`` turns a step into one compiled, donated
program, ``Executor.steps`` here turns it into
CUDA graphs, one per signature (the shapes and dtypes of its tensors and
which optional ones are present), each captured at fixed shapes and
replayed (``CapturedStep``); the step writes its results in place into
buffers that outlive it (the fused update's flat buffers), the
counterpart of donation.

The first call of a signature runs the step eagerly on the executor's
side stream, with host synchronization reported as an error: the warm-up
of PyTorch's whole-network capture recipe, and a real step. It builds the
kernels and fills their plan caches (``build.load``, ``lstm_cuda.has_plan``
and the C plan caches), which must not run inside a capture. The second
call captures the step and replays it; every later call copies its tensors
into the graph's static inputs and replays. Python's cyclic garbage is
collected before a capture and not during it: a dead network's graph
freed inside a capture would invalidate it. Nothing falls back: a capture
or replay that fails raises.

Random numbers under capture: a network whose layers draw (dropout,
weight noise) owns one ``torch.Generator`` on its device
(``network_generator``), which the host seeds before every step --
warm-up, capture, replay or eager -- from a 64-bit mix of the
configuration's seed and the step's iteration (``seed_generator``, the
counterpart of the JAX package's ``fold_in(PRNGKey(seed), it)``). A
captured step registers the generator with its graph, so a replay draws
from the seed the host just set: the draws of a step depend only on the
seed and the iteration, a replay equals the eager step, and a resumed
checkpoint repeats them. A draw from an unregistered CUDA generator
inside a capture raises; nothing catches it.

Kernel wrappers count their launches on the host (``ops.count_launch``),
which happens once, at capture, and never at replay. A captured step
records the counts its capture added, takes them back (nothing ran), and
adds them on every replay, so the counts stay the kernels that ran.

Programs over resident state (``ResidentProgram``, the decode engine's):
where a train step's graph copies its tensors into inputs of its own, a
decode program reads and writes RESIDENT tensors -- the KV cache or block
pool, the carries, the draft's snapshot stacks, the engine's parameter
set -- in place and by address, the counterpart of the JAX engine's
donated state (``donate_argnums``), and only its small STAGED inputs are
copied in: one packed int32 buffer (``Layout``), filled on the host in
pinned memory (``HostStage``) and copied to the card once a call. Results
come back the same way (``HostResult``): one copy into pinned memory and
one event wait. A call that passes a resident tensor at another address
(or shape, or dtype) raises. On the card the first call of a signature
runs eagerly (the warm-up above, a real call) and captures the graph
right after it; every later call replays. Elsewhere the same object runs
its function eagerly and only counts the signatures it has seen, so "one
program per signature" holds, and is tested, on a CPU too. A sealed
program (``seal()``) refuses a new signature: the decode engine captures
everything in ``warmup()``, on the caller's thread, before its loop
thread starts (a capture is global: another thread's CUDA work during it
fails it).

Meshes, sharding, routing tables and the program registry are not
ported.
"""

from __future__ import annotations

import gc
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import ops


class Executor:
    """One policy for the fit path's and the serving engines' precisions,
    and the capture of steps into CUDA graphs."""

    def __init__(self, *, precision: Optional[str] = None,
                 train_precision: Optional[str] = None):
        from deeplearning4j_tpu_torch.quant import resolve_precision
        # declarative SERVING precision: every engine built against this
        # executor (the bucketed forward, the decode programs, the drafts)
        # inherits it without per-caller code
        self.precision = resolve_precision(
            precision if precision is not None
            else os.environ.get("DL4JTPU_PRECISION"))
        # declarative TRAINING precision: 'bf16' casts activations and
        # params to bfloat16 in the fit-path forward of every float32
        # model built against this executor (loss and updater math stay
        # float32). Containers read it through the executor they bound.
        tp = (train_precision if train_precision is not None
              else os.environ.get("DL4JTPU_TRAIN_PRECISION")) or "f32"
        tp = tp.strip().lower()
        if tp not in ("f32", "float32", "bf16", "bfloat16"):
            raise ValueError(
                f"train_precision must be 'f32' or 'bf16', got {tp!r}")
        self.train_precision = "bf16" if tp in ("bf16", "bfloat16") else "f32"
        self._streams: Dict[int, torch.cuda.Stream] = {}
        self._copy_streams: Dict[int, torch.cuda.Stream] = {}

    @property
    def train_dtype(self):
        """The compute dtype the train-precision policy imposes on the fit
        path (None = storage dtype, i.e. no cast)."""
        return torch.bfloat16 if self.train_precision == "bf16" else None

    def prepare_params(self, tree, precision: Optional[str] = None):
        """Apply the serving-precision policy to a weight tree: per-channel
        weight-only quantization for 'int8' / 'fp8', the identity (the
        same objects) for 'f32'. Engines call this at load and swap time,
        never per request."""
        from deeplearning4j_tpu_torch.quant import quantize_tree
        return quantize_tree(tree, precision if precision is not None
                             else self.precision)

    def stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The side stream warm-ups and captures run on, one per card."""
        return self._side(self._streams, device)

    def copy_stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The side stream input prefetch copies run on, one per card and
        kept: the caching allocator keeps its blocks per stream, so a new
        stream each epoch would allocate its buffers anew."""
        return self._side(self._copy_streams, device)

    @staticmethod
    def _side(streams, device):
        i = device.index if device.index is not None \
            else torch.cuda.current_device()
        if i not in streams:
            streams[i] = torch.cuda.Stream(device=i)
        return streams[i]

    def steps(self, fn: Callable, generator=None) -> "StepGraphs":
        """``fn`` called through CUDA graphs, one per signature, each with
        ``generator`` (the generator ``fn`` draws from, or None)
        registered."""
        return StepGraphs(self, fn, generator)

    def warm_up(self, fn: Callable, device: torch.device):
        """``fn()`` eagerly on the side stream, any host synchronization an
        error; the caller's stream waits for it."""
        side, main = self.stream(device), torch.cuda.current_stream(device)
        side.wait_stream(main)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(side)
        return out

    def capture(self, fn: Callable, args: tuple, device: torch.device,
                generator=None) -> "CapturedStep":
        return CapturedStep(fn, args, self.stream(device), generator)


_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_seed(seed: int, iteration: int) -> int:
    """The 64-bit seed of the step at ``iteration`` of a network seeded
    with ``seed``: splitmix64 of splitmix64(seed) mixed with the
    iteration."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (iteration & _MASK64))


def seed_generator(gen: Optional[torch.Generator], seed: int,
                   iteration: int) -> None:
    """Seed ``gen`` (if any) for the step at ``iteration``: a host-side
    write, no device synchronization."""
    if gen is not None:
        gen.manual_seed(step_seed(seed, iteration))


def network_generator(layers, device: torch.device
                      ) -> Optional[torch.Generator]:
    """A network's generator on ``device``, or None when none of its
    ``layers`` draws random numbers."""
    if not any(l.draws_noise() for l in layers):
        return None
    return torch.Generator(device=device)


def _leaves(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _leaves(t, out)
    return out


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(t, it) for k, t in tree.items()}
    return tree


def signature(tree):
    """What a graph is fixed to: the nesting, and each tensor's shape,
    dtype and device (None where an optional argument is absent)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (list, tuple)):
        return tuple(signature(t) for t in tree)
    if isinstance(tree, dict):
        return tuple((k, signature(t)) for k, t in tree.items())
    return tree


class CapturedStep:
    """``fn(*args)`` captured at ``args``' shapes into one CUDA graph.
    Calling it copies the tensors of its arguments into the static inputs,
    replays, adds the launches its capture recorded, and returns the static
    outputs, which the next replay overwrites."""

    def __init__(self, fn: Callable, args: tuple, stream, generator=None):
        self.inputs = [t.detach().clone() for t in _leaves(args, [])]
        static = _rebuild(args, iter(self.inputs))
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = ops.launch_counts()
        # a CUDA graph freed inside a capture (a dead network's, collected
        # with its reference cycle) would free memory there and invalidate
        # the capture: collect before it, and not during it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.outputs = fn(*static)
        finally:
            if collecting:
                gc.enable()
        after = ops.launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        ops.add_launch_counts({k: -n for k, n in self.launches.items()})

    def __call__(self, *args) -> Any:
        for buf, t in zip(self.inputs, _leaves(args, [])):
            if t is not buf:
                buf.copy_(t, non_blocking=True)
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        return self.outputs


class StepGraphs:
    """A step function's CUDA graphs, one per signature: the first call of
    a signature runs the step eagerly (the warm-up), the second captures
    it, every call from then on replays it. ``captures`` counts the graphs
    captured, as the JAX containers' ``_compile_count`` counts programs."""

    def __init__(self, executor: Executor, fn: Callable, generator=None):
        self.executor, self.fn, self.generator = executor, fn, generator
        self.graphs: Dict[Any, CapturedStep] = {}
        self.warmed = set()
        self.captures = 0

    def __call__(self, *args):
        key = signature(args)
        graph = self.graphs.get(key)
        if graph is None:
            device = _leaves(args, [])[0].device
            if key not in self.warmed:
                self.warmed.add(key)
                return self.executor.warm_up(lambda: self.fn(*args), device)
            graph = self.graphs[key] = self.executor.capture(
                self.fn, args, device, self.generator)
            self.captures += 1
        return graph(*args)


class ResidentProgram:
    """``fn(resident, *staged)`` as a program over resident tensors (module
    docstring). ``resident``: a tree of tensors read and written in place,
    fixed by address at the first call; ``staged``: small tensors (on the
    host, or on the card), copied into the graph's inputs each call.
    ``programs`` counts the signatures seen (captured graphs on the card,
    eager programs elsewhere) and calls ``on_program`` for each;
    ``captures`` counts the CUDA graphs captured. ``capture=False`` runs
    every call eagerly (the eager seam a measurement compares with)."""

    def __init__(self, executor: Executor, fn: Callable, name: str,
                 capture: bool = True, on_program: Optional[Callable] = None):
        self.executor, self.fn, self.name = executor, fn, name
        self.capture = capture
        self.on_program = on_program
        self.graphs: Dict[Any, CapturedStep] = {}
        self.signatures = set()
        self.programs = 0
        self.captures = 0
        self.sealed = False
        self._resident = None

    def seal(self) -> None:
        """Refuse any signature not seen yet (no capture from now on)."""
        self.sealed = True

    def rebase(self) -> None:
        """Forget the resident tensors' addresses, so that the next call
        fixes them anew (an engine whose weights become its own); refused
        once a graph was captured over them."""
        if self.graphs:
            raise RuntimeError(f"program {self.name!r}: its captured graphs "
                               "read the resident tensors it was built over")
        self._resident = None

    def _device(self, resident) -> torch.device:
        leaves = _leaves(resident, [])
        addrs = [(t.data_ptr(), tuple(t.shape), t.dtype) for t in leaves]
        if self._resident is None:
            self._resident = addrs
        elif addrs != self._resident:
            raise ValueError(
                f"program {self.name!r}: a resident tensor is not the one "
                "the program was built over (another address, shape or "
                "dtype); resident state is written in place, never rebound")
        return leaves[0].device

    def __call__(self, resident, *staged, eager: bool = False):
        """Replay the signature's graph, else run ``fn``: captured where
        ``capture`` holds on the card, eagerly with ``eager`` (a signature
        met while no capture may happen)."""
        device = self._device(resident)
        key = signature(staged)
        if key not in self.signatures:
            if self.sealed:
                raise RuntimeError(
                    f"program {self.name!r}: new signature {key} after "
                    "warmup (no capture may happen while serving)")
            self.signatures.add(key)
            self.programs += 1
            if self.on_program is not None:
                self.on_program()
        graph = self.graphs.get(key)
        if graph is not None:
            return graph(*staged)
        staged = _rebuild(staged, iter(
            [t.to(device, non_blocking=True) for t in _leaves(staged, [])]))
        if device.type != "cuda" or not self.capture or eager:
            return self.fn(resident, *staged)
        out = self.executor.warm_up(lambda: self.fn(resident, *staged),
                                    device)
        self.graphs[key] = self.executor.capture(
            lambda *s: self.fn(resident, *s), staged, device)
        self.captures += 1
        return out


class Layout:
    """Named fields packed into one int32 buffer: ``fields`` maps a name to
    its shape, or to (shape, numpy dtype) with dtype int32 (the default),
    uint32 or float32. ``host(array)`` views a host buffer's fields as
    numpy arrays of their dtypes; ``unpack(tensor)`` views a device
    buffer's as tensors (a uint32 field as int32: mask it with
    ``& 0xFFFFFFFF`` after widening)."""

    def __init__(self, **fields):
        self.fields = {}
        off = 0
        for name, spec in fields.items():
            shape, dt = (spec if len(spec) == 2 and isinstance(spec[1], type)
                         else (spec, np.int32))
            shape = tuple(int(d) for d in shape)
            n = int(np.prod(shape))
            self.fields[name] = (off, n, shape, np.dtype(dt))
            off += n
        self.size = off

    def host(self, array: np.ndarray) -> Dict[str, np.ndarray]:
        return {name: array[o:o + n].view(dt).reshape(shape)
                for name, (o, n, shape, dt) in self.fields.items()}

    def unpack(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for name, (o, n, shape, dt) in self.fields.items():
            v = t[o:o + n].view(shape)
            out[name] = v.view(torch.float32) if dt == np.float32 else v
        return out


class HostStage:
    """The host buffer a program's staged inputs are packed into (a
    ``Layout``): pinned for a card, so its one copy to the device is
    asynchronous, with an event so that the host does not refill it
    before that copy has run."""

    def __init__(self, layout: Layout, device: torch.device):
        self.layout = layout
        pinned = device.type == "cuda"
        self.tensor = torch.zeros(layout.size, dtype=torch.int32,
                                  pin_memory=pinned)
        self._array = self.tensor.numpy()
        self._event = torch.cuda.Event() if pinned else None
        self._pending = False

    def open(self) -> Dict[str, np.ndarray]:
        """The zeroed fields, once the last copy out of them has run."""
        if self._pending:
            self._event.synchronize()
            self._pending = False
        self._array[:] = 0
        return self.layout.host(self._array)

    def sent(self) -> None:
        """Mark the copy of the buffer just enqueued on the current
        stream."""
        if self._event is not None:
            self._event.record()
            self._pending = True


class HostResult:
    """A program's result read back: one copy into pinned memory, then one
    event wait."""

    def __init__(self, shape, device: torch.device):
        pinned = device.type == "cuda"
        self.tensor = torch.zeros(shape, dtype=torch.int32,
                                  pin_memory=pinned)
        self._event = torch.cuda.Event() if pinned else None

    def read(self, t: torch.Tensor) -> np.ndarray:
        self.tensor.copy_(t, non_blocking=self._event is not None)
        if self._event is not None:
            self._event.record()
            self._event.synchronize()
        return self.tensor.numpy().copy()


# ------------------------------------------------------- process default
_default_executor: Optional[Executor] = None


def get_executor() -> Executor:
    global _default_executor
    if _default_executor is None:
        _default_executor = Executor()
    return _default_executor


def set_executor(ex: Optional[Executor]) -> None:
    global _default_executor
    _default_executor = ex
