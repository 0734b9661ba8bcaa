"""Shape-bucketed inference.

Counterpart of deeplearning4j_tpu/serving/engine.py. Every batch is padded
up to a rung of a bucket ladder (the power-of-two ladder, or one chosen
from measured traffic: ``autotune_ladder`` / ``prune_ladder``), run, and
the pad rows sliced off: inference computes each output row from its own
input row alone, so padding does not change the answer. Batches above
``max_batch`` are chunked through the top rung and the tail re-buckets.

- Weights (``ResidentWeights``, the decode engine's class too). A float32
  engine reads the model's own tensors, copying nothing, as the JAX
  engine reads ``model.params``, so it follows ``fit()``. Its first
  ``warmup()`` or ``swap_weights`` gives it its OWN resident set, which
  its programs read by address; until the first swap that set follows
  the model: before a call whose model parameters moved
  (``_params_version``, bumped by every update and load) the model's are
  copied into it in place. A quantized ``precision`` owns its set from
  the start. ``swap_weights`` validates the float32 candidate first
  (``WeightSwapError``, nothing touched), quantizes it after the gate
  under int8 / fp8, and writes codes, scales and tensors INTO the
  resident ones leaf by path (``copy_``), never rebinding them: a rebind
  would leave a captured rung reading stale weights.
- Tensor parallelism (the executor's mesh has a ``model`` axis:
  ``DL4JTPU_MESH=model=m``, ``set_default_mesh``): the set is the
  engine's own from the start, ONE resident shard set
  (parallel/tensor_parallel.py: every leaf ``param_spec`` splits as its
  ``m`` shards, ``W@0`` ...), which ``follow()`` and ``swap_weights``
  write in place, path by path. Each rung's program runs the model's
  tensor-parallel form: attention K5 once a shard over its H/m heads,
  ``Wo``'s row-split partials summed in shard order. Under int8 / fp8
  the whole float32 tree is quantized first, as the JAX executor
  quantizes before placement, and the codes and scales then split
  (``tensor_parallel.split_parts``): each shard dequantizes to its slice
  of the whole weight's dequantization, bit for bit.
- ``precision`` (``"f32"``, ``"int8"``, ``"fp8"``; default the executor's
  policy, ``DL4JTPU_PRECISION``): int8 / fp8 keep the weights as codes and
  per-channel scales (quant/) and dequantize inside the forward, plain
  tensor code (``codes.float() * scale``) before the unchanged float32
  math and its kernels (K4, K1, K5). The JAX package leaves that
  expansion to XLA's fusion; a fused dequant-GEMM is a later item.
- Programs. The forward is one ``exec.ResidentProgram`` over the resident
  weights, one signature a (rung, per-example shape, dtype, mask shape).
  ``warmup()`` captures each rung of the ladder as a CUDA graph on the
  card, on the caller's thread (a capture is global: nothing else may run
  CUDA work meanwhile -- the server runs it on the decode loop's thread
  with the /predict path held). A signature first met outside
  ``warmup()`` -- every call of an engine never warmed, or a shape off
  the ladder after it -- runs eagerly through the same kernels and counts
  as a program: a request never fails for want of a capture, and no
  capture happens while serving. ``trace_count`` counts the programs
  (signatures), ``captures`` the graphs. Off the card every signature runs
  eagerly and counts the same way.
- AOT artifacts (exec/aot.py): ``warmup(aot=path)`` restores each rung
  whose recipe the artifact holds under the JAX package's key
  (``_aot_key``) -- counted in ``aot_restores``, not ``trace_count`` --
  and traces and saves the rest.
- ``predict_stream`` overlaps the next dispatch with the read of the last
  one: each result is copied to pinned host memory on the executor's copy
  stream behind an event.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import host_tensor
from deeplearning4j_tpu_torch.exec.executor import (ResidentProgram,
                                                    get_executor)
from deeplearning4j_tpu_torch.monitor.metrics import get_registry
from deeplearning4j_tpu_torch.monitor.tracing import trace
from deeplearning4j_tpu_torch.nn.layers.base import copy_into, map_tree
from deeplearning4j_tpu_torch.quant import (copy_tree, dequantize_tree,
                                            leaves_by_path,
                                            record_weight_bytes,
                                            resolve_precision, tree_bytes)
from deeplearning4j_tpu_torch.resilience.errors import WeightSwapError


def input_type_of(model):
    """The model's declared input type: ``conf.input_types[0]`` for a
    ComputationGraph, ``conf.input_type`` for a MultiLayerNetwork (None
    when the configuration declares none)."""
    conf = model.conf
    if hasattr(conf, "network_inputs"):
        return conf.input_types[0] if conf.input_types else None
    return conf.input_type


def _tree_signature(tree):
    """Flattened ``{path: (shape, dtype)}``: the swap compatibility key."""
    return {k: (tuple(v.shape), str(torch.as_tensor(v).dtype))
            for k, v in leaves_by_path(tree).items()}


def tree_to(tree, device):
    """A tree of tensors or numpy arrays (a swap candidate: the trainer's
    tensors, a checkpoint's arrays) as tensors on ``device``."""
    def one(a):
        t = a if isinstance(a, torch.Tensor) else \
            torch.as_tensor(np.asarray(a))
        return t.to(device)
    return map_tree(one, tree)


def model_signature(*trees) -> str:
    """Hash of the shapes and dtypes of ``trees`` (values do not enter):
    the JAX package's ``exec.aot.model_signature``, blake2b over the same
    JSON (each tree's sorted ``[path, [shape, dtype]]`` pairs, dtype by
    numpy's name), so one configuration gets one signature in both
    packages. Empty dicts add nothing. The KV migration envelope's
    ``model_sig``."""
    sig = [sorted((k, (list(shape), dt.replace("torch.", "")))
                  for k, (shape, dt) in _tree_signature(t).items())
           for t in trees]
    blob = json.dumps(sig, sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def validate_swap(current, candidate, what: str = "params") -> None:
    """Reject a hot-swap candidate whose tree does not match the live
    weights array for array (path set, shapes, dtypes), before any engine
    state is touched: a rejected swap is a no-op."""
    _validate_sig(_tree_signature(current), _tree_signature(candidate), what)


def _validate_sig(cur, new, what: str = "params") -> None:
    """The signature half of ``validate_swap``: a quantized engine keeps
    the float32 signature of its weights and holds candidates, which
    arrive in float32, to it (they are quantized after the gate)."""
    problems = []
    for key in sorted(set(cur) - set(new)):
        problems.append(f"missing array {key!r}")
    for key in sorted(set(new) - set(cur)):
        problems.append(f"unexpected array {key!r}")
    for key in sorted(set(cur) & set(new)):
        if cur[key] != new[key]:
            problems.append(
                f"{key!r} expected {cur[key][0]}/{cur[key][1]}, "
                f"got {new[key][0]}/{new[key][1]}")
    if problems:
        raise WeightSwapError(
            f"candidate {what} incompatible with live weights", problems)


def _in_layout(template, tree):
    """``tree``'s leaves in ``template``'s structure, each taken from the
    leaf of the same path (``leaves_by_path``; the path sets are equal,
    as ``validate_swap`` checks)."""
    flat = leaves_by_path(tree)
    paths = iter([k for k, v in leaves_by_path(template).items()
                  if v is not None])      # map_tree passes None through
    return map_tree(lambda _: flat[next(paths)], template)


class ResidentWeights:
    """The weight set (parameters and layer state) an engine serves and
    its programs read by address: both engines' one state machine.

    - Under int8 / fp8 the set is the engine's own from the start: codes
      and per-channel scales quantized from the model's float32 parameters
      (``Executor.prepare_params``), and a copy of the layer state. Swap
      candidates, which arrive in float32, are held to the float32
      signature and quantized after the gate.
    - Under float32 the set is the model's own tensors, copied nowhere (the
      JAX engine reads ``model.params``), until ``own()`` clones them: the
      decode engine at construction, the bucketed engine at its first
      ``warmup()`` (before a capture fixes addresses) or swap. From then
      until the first swap, ``follow()`` copies the model's parameters and
      state into the clone in place whenever they moved
      (``_params_version``, bumped by every update, init and load).
    - ``write`` puts a prepared candidate INTO the resident tensors
      (``copy_tree``: leaf by path, in place), never rebinding them, so a
      captured program reads the new weights; the set then stops following
      the model.
    - On a mesh with a model axis the set is the engine's own from the
      start: the model's tensor-parallel form (``form``, built without
      training state) splits the parameters into one resident shard set,
      and ``follow`` and ``write`` split into it in place; the programs
      read it through ``form.view``. Candidates are held to the float32
      signature of the unsplit tree. Under int8 / fp8 the whole tree is
      quantized, then split (codes and scales).
    """

    def __init__(self, model, precision: str, executor, owner: str,
                 own: bool = False):
        self.model, self.precision = model, precision
        self.executor, self.owner = executor, owner
        self.params = self.state = None
        self.swapped = False
        self._seen = None
        self._sig = None        # float32 signature of a quantized set
        self.form = None        # the tensor-parallel form (a model axis)
        m = executor.model_size
        if m > 1:
            from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
                TensorParallel
            self.form = TensorParallel(model, m, train=False)
            own = True
        if own or (precision != "f32" and model.params is not None):
            self.own()

    @property
    def owned(self) -> bool:
        return self.params is not None

    @torch.no_grad()
    def own(self) -> None:
        """Make the set the engine's own (a no-op once it is)."""
        if self.params is not None:
            return
        m = self.model
        self._seen = getattr(m, "_params_version", 0)
        if self.form is not None:
            self._sig = _tree_signature(m.params)
            self.params = self.form.split(
                self.executor.prepare_params(m.params, self.precision))
            if self.precision != "f32":
                record_weight_bytes(self.owner, self.precision,
                                    tree_bytes(self.params))
        elif self.precision == "f32":
            self.params = map_tree(lambda t: t.detach().clone(), m.params)
        else:
            self._sig = _tree_signature(m.params)
            self.params = self.executor.prepare_params(m.params,
                                                       self.precision)
            record_weight_bytes(self.owner, self.precision,
                                tree_bytes(self.params))
        self.state = map_tree(lambda t: t.detach().clone(), m.state)

    @torch.no_grad()
    def follow(self) -> bool:
        """Copy the model's moved parameters (and state) into an owned,
        never swapped float32 set; True when it did."""
        v = getattr(self.model, "_params_version", 0)
        if (self.params is None or self.precision != "f32" or self.swapped
                or v == self._seen):
            return False
        if self.form is not None:
            self.form.split(self.model.params, into=self.params)
        else:
            copy_into(self.params, self.model.params)
        if self.state is not None:
            copy_into(self.state, self.model.state)
        self._seen = v
        return True

    def tree(self):
        """The (params, state) pair to read now, followed first."""
        if self.precision != "f32":
            self.own()
        self.follow()
        if self.params is None:
            return self.model.params, self.model.state
        return self.params, self.state

    @property
    def nbytes(self) -> int:
        """Resident weight bytes (codes and scales when quantized)."""
        return tree_bytes(self.params if self.params is not None
                          else self.model.params)

    def net(self, params):
        """The (model, parameters) a program computes with over the set's
        ``params``: the tensor-parallel form's copy of the model over
        their shard view, else the model over them dequantized in place
        of use (the identity on a float32 set)."""
        if self.form is not None:
            return self.form.shadow, self.form.view(dequantize_tree(params))
        return self.model, dequantize_tree(params)

    def unsplit(self):
        """The resident parameters in the model's own structure: a shard
        set gathered (codes and scales whole), else the set itself."""
        params = self.params if self.owned else self.model.params
        if self.form is None:
            return params
        g = self.form.gather(params)
        return g if self.form.graph else [g[i] for i in sorted(g)]

    def check(self, params, state=None, what: str = "params") -> None:
        """Raise ``WeightSwapError`` where the set would refuse the
        candidate (path set, shapes, dtypes; the float32 signature when
        quantized); touches nothing."""
        cur_p, cur_s = ((self.params, self.state) if self.owned
                        else (self.model.params, self.model.state))
        if self._sig is not None:
            _validate_sig(self._sig, _tree_signature(params), what)
        else:
            validate_swap(cur_p, params, what)
        if state is not None:
            validate_swap(cur_s if cur_s is not None else {}, state,
                          "state")

    def prepare(self, params, state=None):
        """A ``check``ed candidate as the set holds it: (params, state,
        float32 params), rebuilt in the model's own structure (leaves
        matched by path), tensors on the model's device, the params
        quantized under int8 / fp8."""
        dev, m = self.model.device, self.model
        f32 = tree_to(_in_layout(m.params, params), dev)
        new = (f32 if self.precision == "f32"
               else self.executor.prepare_params(f32, self.precision))
        if state is not None:
            state = tree_to(state if m.state is None
                            else _in_layout(m.state, state), dev)
        return new, state, f32

    @torch.no_grad()
    def write(self, prepared) -> None:
        """Copy a ``prepare``d candidate into the resident tensors."""
        params, state, _ = prepared
        self.own()
        if self.form is not None:
            self.form.split(params, into=self.params)
        else:
            copy_tree(self.params, params)
        if state is not None and self.state is not None:
            copy_tree(self.state, state)
        self.swapped = True
        if self.precision != "f32":
            record_weight_bytes(self.owner, self.precision,
                                tree_bytes(self.params))


def bucket_for(n: int, max_batch: int, min_bucket: int = 1,
               ladder: Optional[Sequence[int]] = None) -> int:
    """Smallest rung >= n: of ``ladder`` when given (sorted ascending,
    topped by max_batch, as ``autotune_ladder`` makes them), else of the
    power-of-two ladder capped at max_batch."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    if ladder:
        for b in ladder:
            if b >= n:
                return b
        return ladder[-1]
    b = max(min_bucket, 1)
    while b < n:
        b <<= 1
    return min(b, max_batch)


def bucket_ladder(max_batch: int, min_bucket: int = 1) -> List[int]:
    """The full ladder [min_bucket, 2*min_bucket, ..., max_batch]."""
    out = []
    b = max(min_bucket, 1)
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(max_batch)
    return out


def autotune_ladder(counts, max_batch: int, max_rungs: Optional[int] = None,
                    min_bucket: int = 1) -> List[int]:
    """Bucket rungs chosen from MEASURED traffic, the JAX package's
    dynamic program: ``counts`` maps an observed batch size to its request
    count; the candidates are the observed sizes and the power-of-two
    rungs; at most ``max_rungs`` of them (default: the power-of-two
    ladder's length) minimizing the total pad rows, ``max_batch`` always
    the top rung. The power-of-two ladder is a feasible choice, so the
    result never pads more, with never more rungs."""
    pow2 = bucket_ladder(max_batch, min_bucket)
    K = int(max_rungs) if max_rungs else len(pow2)
    lo = max(min_bucket, 1)
    # sizes above max_batch arrive chunked (the tail re-buckets), sizes
    # below min_bucket pad up to it
    sizes = {}
    for s, c in dict(counts).items():
        s = min(max(int(s), lo), max_batch)
        sizes[s] = sizes.get(s, 0) + int(c)
    if not sizes:
        return pow2
    cand = sorted(set(sizes) | set(pow2) | {max_batch})
    cand = [c for c in cand if lo <= c <= max_batch]

    def seg_cost(i: int, j: int) -> float:
        """Pad rows when the sizes in (cand[i], cand[j]] round to
        cand[j]."""
        lo_v = cand[i] if i >= 0 else 0
        r = cand[j]
        return float(sum(c * (r - s) for s, c in sizes.items()
                         if lo_v < s <= r))

    p = len(cand)
    INF = float("inf")
    dp = [[INF] * (K + 1) for _ in range(p)]
    back = [[None] * (K + 1) for _ in range(p)]
    for j in range(p):
        dp[j][1] = seg_cost(-1, j)
        for k in range(2, K + 1):
            for i in range(j):
                if dp[i][k - 1] == INF:
                    continue
                v = dp[i][k - 1] + seg_cost(i, j)
                if v < dp[j][k]:
                    dp[j][k] = v
                    back[j][k] = i
    top = p - 1                              # cand[top] == max_batch
    best_k = min(range(1, K + 1), key=lambda k: (dp[top][k], k))
    rungs, j, k = [cand[top]], top, best_k
    while k > 1 and back[j][k] is not None:
        j = back[j][k]
        k -= 1
        rungs.append(cand[j])
    return sorted(rungs)


def prune_ladder(ladder: Sequence[int], counts, rung_costs) -> List[int]:
    """Drop rungs whose measured one-time cost (``rung_costs[b]
    ["compile_s"]``, as ``warmup()`` records it: here the capture) exceeds
    the pad rows' run time they save on the observed traffic (valued at
    the rung's measured ``run_s`` a row); the top rung stays. The JAX
    package's rule, opt-in through ``autotune(prune=True)``."""
    ladder = sorted(ladder)
    sizes = {int(s): int(c) for s, c in dict(counts).items()}
    changed = True
    while changed and len(ladder) > 1:
        changed = False
        for idx in range(len(ladder) - 1):
            r, nxt = ladder[idx], ladder[idx + 1]
            cost = rung_costs.get(r, {})
            compile_s, run_s = cost.get("compile_s"), cost.get("run_s")
            if compile_s is None or run_s is None or run_s <= 0:
                continue
            lo = ladder[idx - 1] if idx > 0 else 0
            absorbed = sum(c for s, c in sizes.items() if lo < s <= r)
            extra_run_s = absorbed * (nxt - r) * (run_s / max(r, 1))
            if extra_run_s < compile_s:
                ladder.pop(idx)
                changed = True
                break
    return ladder


_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.float16): torch.float16}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype)]


class InferenceEngine:
    """Bucketed inference over a MultiLayerNetwork or a single-input
    ComputationGraph (module docstring: weights, precision, programs).

    ``InferenceEngine(model, max_batch=1024, min_bucket=1,
    precision=None)``, the JAX package's signature."""

    _ids = itertools.count()

    def __init__(self, model, max_batch: int = 1024, min_bucket: int = 1,
                 precision: Optional[str] = None):
        self.model = model
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        self._is_graph = hasattr(model.conf, "network_inputs")
        self._lock = threading.RLock()
        self._execu = getattr(model, "_executor", None) or get_executor()
        # explicit argument > the executor's declarative policy
        self.precision = (resolve_precision(precision)
                          if precision is not None
                          else self._execu.precision)
        self._version = 0
        self.warmup_seconds: Optional[float] = None
        # measurement-driven ladders: the per-size traffic histogram
        # (live dispatches only), warmup's per-rung costs, the active
        # ladder (None: the power-of-two default)
        self.ladder: Optional[List[int]] = None
        self.rung_costs: dict = {}
        self._size_counts: dict = {}
        self._in_warmup = False
        self._buckets = set()
        self._calls = 0
        # AOT-restored rungs: (bucket, masked) -> artifact key
        # (``warmup(aot=...)``); restores never touch trace_count
        self._aot: dict = {}
        self.id = f"engine{next(InferenceEngine._ids)}"
        reg = get_registry()
        lab = {"engine": self.id}
        self._m_compiled = reg.counter(
            "dl4jtpu_serving_compiled_programs_total",
            "Programs of the inference engine: one per bucket signature "
            "(a CUDA graph when warmup() captured it on the card).",
            ("engine",)).labels(**lab)
        self._m_rows = reg.counter(
            "dl4jtpu_serving_batch_rows_total",
            "Real (un-padded) rows executed through bucketed device calls.",
            ("engine",)).labels(**lab)
        self._m_pad_rows = reg.counter(
            "dl4jtpu_serving_pad_rows_total",
            "Padding rows added to round batches up to bucket sizes "
            "(pad-waste = pad / (pad + rows)).", ("engine",)).labels(**lab)
        self._m_version = reg.gauge(
            "dl4jtpu_model_version",
            "Version of the weights currently serving (0 = the model's "
            "initial weights; bumped by every hot swap).",
            ("engine",)).labels(**lab)
        self._m_swaps = reg.counter(
            "dl4jtpu_model_swaps_total",
            "Weight hot-swaps applied with zero new captures.",
            ("engine",)).labels(**lab)
        self._m_rungs = reg.gauge(
            "dl4jtpu_serving_bucket_rungs",
            "Rungs in the active bucket ladder (= programs the ladder "
            "needs; drops when autotune merges rungs).",
            ("engine",)).labels(**lab)
        self._m_version.set(0.0)
        self._m_rungs.set(float(len(bucket_ladder(self.max_batch,
                                                  self.min_bucket))))
        self._weights_set = ResidentWeights(model, self.precision,
                                            self._execu, self.id)
        # captures only inside warmup(); ``_program.capture = False``
        # before it keeps every rung eager on the card (the seam a
        # measurement compares the captured rungs with)
        self._program = ResidentProgram(
            self._execu, self._body, self.id,
            capture=model.device.type == "cuda",
            on_program=self._m_compiled.inc, caller=self.id,
            key_of=lambda staged: f"b{staged[0].shape[0]}"
            + ("_mask" if len(staged) > 1 else ""))

    # --------------------------------------------------------------- weights
    @property
    def trace_count(self) -> int:
        """Traced programs: the signatures this engine built from scratch,
        cost pass included (the registry counter ``/metrics`` reads). A
        program built from an AOT artifact's recipe is a restore
        (``aot_restores``) and does not count here; both capture on the
        card, which ``captures`` and the registry's ``compile_seconds``
        show."""
        return int(self._m_compiled.value)

    @property
    def aot_restores(self) -> int:
        """Programs restored from an AOT artifact (``warmup(aot=)``)."""
        return self._program.restores

    @property
    def captures(self) -> int:
        """CUDA graphs captured (by ``warmup()``, on the card)."""
        return self._program.captures

    @property
    def model_version(self) -> int:
        return self._version

    def _weights(self):
        """The (params, state) pair the programs read (module docstring:
        the model's tensors until the set is the engine's own)."""
        with self._lock:
            return self._weights_set.tree()

    def _own_weights(self) -> None:
        """Make the resident set the engine's own before a capture or a
        swap; the program then fixes the clone's addresses (the caller
        holds the lock)."""
        if not self._weights_set.owned:
            self._weights_set.own()
            self._program.rebase()

    def check_swap(self, params, state=None) -> None:
        """Raise ``WeightSwapError`` where ``swap_weights(params, state)``
        would refuse the candidate; touches nothing."""
        with self._lock:
            self._weights_set.check(params, state)

    def swap_weights(self, params, state=None,
                     version: Optional[int] = None) -> int:
        """Replace the serving weights with a same-shape tree, in place.

        The candidate (float32, the trainer's and the checkpoint's format;
        tensors or numpy arrays; its leaves matched by path) is validated
        first -- path set, shapes, dtypes, against the float32 signature
        under int8 / fp8 -- and a mismatch raises ``WeightSwapError`` with
        the engine untouched. Then it is quantized (int8 / fp8) and
        written into the resident tensors: the programs keep their
        addresses, so a swap captures nothing. Returns the new version
        (``version``, else previous + 1)."""
        with self._lock:
            self._weights_set.check(params, state)
            prepared = self._weights_set.prepare(params, state)
            self._own_weights()
            self._weights_set.write(prepared)
            self._version = (int(version) if version is not None
                             else self._version + 1)
            v = self._version
        self._m_version.set(float(v))
        self._m_swaps.inc()
        return v

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def _body(self, res, x, mask=None):
        """The forward over the resident weights, dequantized in place of
        use (the identity on a float32 set), through the tensor-parallel
        form over a shard set. Returns a list of outputs."""
        net, params = self._weights_set.net(res["params"])
        if self._is_graph:
            out, _ = net._forward(params, x, state=res["state"])
        else:
            out, _ = net._forward(params, x, mask=mask, state=res["state"])
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _dispatch(self, x: torch.Tensor, mask=None, phases=None) -> List:
        """One bucketed call: pad, run, slice. Returns the list of outputs
        (async on the card). ``phases``: a dict that ACCUMULATES wall
        seconds under ``bucket``, ``pad`` and ``device`` (the launch; the
        card runs on until the read). A batch above ``max_batch`` is
        chunked through the top rung; each chunk, the tail too, buckets
        on its own."""
        n = x.shape[0]
        if n > self.max_batch:
            pieces = [self._dispatch(
                x[i:i + self.max_batch],
                None if mask is None else mask[i:i + self.max_batch],
                phases) for i in range(0, n, self.max_batch)]
            return [torch.cat([p[j] for p in pieces])
                    for j in range(len(pieces[0]))]
        tp = time.perf_counter()

        def lap(key):
            nonlocal tp
            if phases is not None:
                t = time.perf_counter()
                phases[key] = phases.get(key, 0.0) + (t - tp)
                tp = t
        with self._lock:
            with trace.span("bucket", n=n):
                if not self._in_warmup:
                    self._size_counts[n] = self._size_counts.get(n, 0) + 1
                b = bucket_for(n, self.max_batch, self.min_bucket,
                               self.ladder)
            lap("bucket")
            with trace.span("pad", bucket=b):
                if b > n:
                    x = torch.cat([x, x.new_zeros((b - n,)
                                                  + tuple(x.shape[1:]))])
                    if mask is not None:
                        mask = torch.cat([mask, mask.new_zeros(
                            (b - n,) + tuple(mask.shape[1:]))])
            lap("pad")
            with trace.span("device", bucket=b):
                params, state = self._weights()
                if not self._weights_set.owned:
                    # the model's own tensors: init / set_params rebind them
                    self._program.rebase()
                staged = (x,) if mask is None else (x, mask)
                outs = self._program({"params": params, "state": state},
                                     *staged, eager=not self._in_warmup)
                # a captured rung's outputs are its static buffers, which
                # the next replay overwrites
                outs = [o[:n].clone() for o in outs]
            lap("device")
            self._calls += 1
            self._buckets.add(b)
        self._m_rows.inc(n)
        self._m_pad_rows.inc(b - n)
        return outs

    # ----------------------------------------------------------- public API
    def _inputs(self, x, mask):
        if not isinstance(x, torch.Tensor):
            x = host_tensor(x)
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask)) if not isinstance(
                mask, torch.Tensor) else mask
            mask = mask.to(self.model.device)
        return x.to(self.model.device), mask

    @torch.no_grad()
    def predict(self, x, mask=None, phases=None):
        """Bucketed forward of one batch (``mask``: a MultiLayerNetwork's
        (B, T) feature mask, padded with zero rows); returns the output on
        the model's device (a list for a multi-output graph), shaped like
        ``model.output(x, bucketed=False)``. ``phases``: see
        ``_dispatch``."""
        if isinstance(x, (list, tuple)):
            if len(x) != 1:
                raise ValueError("the bucketed engine serves single-input "
                                 f"models; got {len(x)} inputs")
            x = x[0]
        # the copy to the card under the lock too: warmup() captures while
        # holding it, and a copy from another thread would break that
        with self._lock:
            x, mask = self._inputs(x, mask)
            outs = self._dispatch(x, mask, phases)
        return outs[0] if len(outs) == 1 else outs

    def predict_host(self, x, mask=None, phases=None):
        """``predict`` + host read (numpy, float32; a list for a
        multi-output graph). With ``phases``, the read's wall seconds
        accumulate under ``readback``."""
        with self._lock:
            out = self.predict(x, mask, phases=phases)
            t0 = time.perf_counter()
            with trace.span("readback"):
                if isinstance(out, list):
                    out = [o.float().cpu().numpy() for o in out]
                else:
                    out = out.float().cpu().numpy()
        if phases is not None:
            phases["readback"] = (phases.get("readback", 0.0)
                                  + time.perf_counter() - t0)
        return out

    def predict_stream(self, batches, depth: int = 2):
        """Pipelined inference over an iterable of batches: up to
        ``depth`` results in flight, so the card runs batch k+1 while the
        host reads batch k. On the card each result is copied into pinned
        host memory on the executor's copy stream, behind an event.
        Yields numpy arrays (lists for a multi-output graph), in order."""
        dev = self.model.device
        pending = deque()

        def launch(out):
            outs = out if isinstance(out, list) else [out]
            if dev.type != "cuda":
                return outs, None
            copy = self._execu.copy_stream(dev)
            copy.wait_stream(torch.cuda.current_stream(dev))
            hosts = []
            with torch.cuda.stream(copy):
                for o in outs:
                    h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    h.copy_(o, non_blocking=True)
                    o.record_stream(copy)
                    hosts.append(h)
                done = torch.cuda.Event()
                done.record(copy)
            return hosts, done

        def read(item):
            hosts, done = item
            if done is not None:
                done.synchronize()
            arrs = [h.float().cpu().numpy() for h in hosts]
            return arrs if len(arrs) > 1 else arrs[0]

        for x in batches:
            pending.append(launch(self.predict(x)))
            while len(pending) >= max(depth, 1):
                yield read(pending.popleft())
        while pending:
            yield read(pending.popleft())

    # -------------------------------------------------------------- warmup
    def _aot_key(self, b: int, shapes, dtype,
                 mask_len: Optional[int] = None) -> str:
        """Artifact key of one ladder rung, the JAX package's string:
        bucket, per-example shapes, dtype (and the mask length of the
        masked variant)."""
        s = ";".join("x".join(str(d) for d in tuple(shp)) for shp in shapes)
        kind = "graph" if self._is_graph else "mln"
        name = (str(dtype).replace("torch.", "")
                if isinstance(dtype, torch.dtype) else np.dtype(dtype).name)
        key = f"engine:{kind}:b{b}:{s}:{name}"
        return key if mask_len is None else f"{key}:mask{mask_len}"

    def warmup(self, example_shape, dtype=np.float32, max_batch=None,
               with_mask_len: Optional[int] = None,
               aot: Optional[str] = None):
        """Run every rung of the active ladder (up to ``max_batch``) twice,
        so that on the card each is captured as a CUDA graph over the
        resident weights before the first request (off the card: run and
        counted). ``example_shape``: the per-example feature shape (or a
        one-element list of it); ``with_mask_len``: also the (B, T =
        with_mask_len) masked variant of each rung (MultiLayerNetwork).
        Records ``rung_costs[b] = {"compile_s", "run_s"}`` (the first
        dispatch's excess over the second: the capture; the second) and
        ``warmup_seconds``; warmup traffic stays out of the size
        histogram. Returns the rungs run. Call it while no other thread
        runs CUDA work (a capture is global).

        ``aot``: an AOT artifact's path (exec/aot.py). A rung whose recipe
        is there is restored (``_aot`` keeps its key): no cost pass, no
        count in ``trace_count``; on the card its kernel libraries are
        installed first. Any miss -- no file, another envelope or model,
        an unknown rung, a recipe whose launches or layout its capture
        does not reproduce -- traces the rung as without ``aot`` and
        merges its recipe (and, on the card, the kernel libraries) into
        the artifact."""
        shapes = (example_shape if isinstance(example_shape, list)
                  else [example_shape])
        if len(shapes) != 1:
            raise ValueError("the bucketed engine serves single-input "
                             f"models; got {len(shapes)} input shapes")
        shape = tuple(int(d) for d in shapes[0])
        cap = min(max_batch or self.max_batch, self.max_batch)
        ladder = [b for b in (self.ladder
                              or bucket_ladder(cap, self.min_bucket))
                  if b <= cap]
        dev, dt = self.model.device, _torch_dtype(dtype)
        bundle = None
        traced = {}                   # registry key -> artifact key
        if aot is not None:
            from deeplearning4j_tpu_torch.exec import aot as aot_mod
            sig = aot_mod.model_signature(*self._weights())
            bundle, _ = aot_mod.open_bundle(aot, sig, self.precision, dev)
            if bundle is None:
                bundle = aot_mod.AotBundle(
                    sig, self.precision, env=aot_mod.env_fingerprint(dev))
            elif dev.type == "cuda":
                bundle.install_libraries()

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def run(staged, key, rkey, slot):
            """Dispatch ``staged`` once, from the artifact's recipe when
            the rung is new to the program and the recipe is there."""
            if bundle is not None and not self._program.knows(staged):
                self._program.expect(staged, bundle.recipe(key))
                restores = self._program.restores
                self._dispatch(*staged)
                if self._program.restores > restores:
                    self._aot[slot] = key
                else:
                    traced[rkey] = key
            else:
                self._dispatch(*staged)
                if bundle is not None and slot not in self._aot:
                    traced[rkey] = key      # met before: saved as traced
            sync()
        t0 = time.perf_counter()
        with self._lock:
            self._own_weights()
            self._in_warmup = True
            try:
                for b in ladder:
                    zeros = torch.zeros((b,) + shape, dtype=dt, device=dev)
                    ta = time.perf_counter()
                    run((zeros,), self._aot_key(b, shapes, dtype), f"b{b}",
                        (b, False))
                    tb = time.perf_counter()
                    self._dispatch(zeros)
                    sync()
                    tc = time.perf_counter()
                    self.rung_costs[b] = {
                        "compile_s": max((tb - ta) - (tc - tb), 0.0),
                        "run_s": tc - tb}
                    if with_mask_len is not None and not self._is_graph:
                        m = torch.ones((b, int(with_mask_len)), dtype=dt,
                                       device=dev)
                        run((zeros, m), self._aot_key(b, shapes, dtype,
                                                      int(with_mask_len)),
                            f"b{b}_mask", (b, True))
            finally:
                self._in_warmup = False
        self.warmup_seconds = time.perf_counter() - t0
        if bundle is not None and traced:
            recipes = self._program.recipes()
            for rkey, key in traced.items():
                if rkey in recipes:
                    bundle.add_recipe(key, *recipes[rkey])
            if dev.type == "cuda" and not bundle.libraries:
                from deeplearning4j_tpu_torch.ops import build
                bundle.add_libraries(build.export_libraries())
            bundle.save(aot)
        return ladder

    def autotune(self, max_rungs: Optional[int] = None, apply: bool = True,
                 prune: bool = False, counts: Optional[dict] = None
                 ) -> List[int]:
        """The ladder re-derived from the traffic this engine served (or
        ``counts``): ``autotune_ladder``, then with ``prune`` (and
        ``warmup()``'s costs) ``prune_ladder``. ``apply=False`` only
        returns it. A new ladder's rungs run eagerly until the next
        ``warmup()`` captures them."""
        counts = dict(self._size_counts if counts is None else counts)
        ladder = autotune_ladder(counts, self.max_batch, max_rungs,
                                 self.min_bucket)
        if prune and self.rung_costs:
            ladder = prune_ladder(ladder, counts, self.rung_costs)
        if apply:
            self.ladder = ladder
            self._m_rungs.set(float(len(ladder)))
        return ladder

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        rows = int(self._m_rows.value)
        pad = int(self._m_pad_rows.value)
        with self._lock:
            return {"id": self.id,
                    "max_batch": self.max_batch,
                    "bucket_ladder": (list(self.ladder) if self.ladder
                                      else bucket_ladder(self.max_batch,
                                                         self.min_bucket)),
                    "ladder_autotuned": self.ladder is not None,
                    "rung_costs": {int(k): dict(v)
                                   for k, v in self.rung_costs.items()},
                    "precision": self.precision,
                    "weight_bytes": self._weights_set.nbytes,
                    "model_version": self._version,
                    "compiled_programs": self.trace_count,
                    "captures": self.captures,
                    "buckets_used": sorted(self._buckets),
                    "device_calls": self._calls,
                    "rows": rows,
                    "pad_rows": pad,
                    "pad_waste_frac": pad / (pad + rows) if rows else 0.0,
                    "warmup_seconds": self.warmup_seconds}
