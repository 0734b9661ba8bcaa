"""Incremental decoding with slot-based continuous batching.

Counterpart of deeplearning4j_tpu/serving/decode.py, over a
MultiLayerNetwork or a ComputationGraph, with dense or paged KV caches, the
prefix cache with copy-on-write and its host tier, chunked prefill,
speculative decoding, KV-chain migration (``kv_export`` / ``kv_import``),
the request journal with its SLO histograms, ``eos_id``, ``warmup()``,
``swap_weights`` and the int8 / fp8 serving precisions (AOT warm-up is
not ported yet). Decode state -- each recurrent layer's (h, c) carry,
each attention layer's KV cache -- stays on the device in ONE batched
state of S slots;
every step advances all active streams by one token at their positions,
new requests claim free slots between steps, and finished streams free
theirs.

- Programs. The plain step (dense or paged), the prefill chunk, the
  copy-on-write, the draft and the verify are each ONE program
  (``exec.ResidentProgram``): a function of the engine's RESIDENT tensors
  -- its parameter set, its decode state, the draft's stacks and
  proposals, read and written in place by address, the counterpart of the
  JAX engine's donated state -- and of one small staged int32 buffer of
  the call's inputs (tokens, positions, masks, seeds, temperatures, top-k,
  page tables), packed on the host in pinned memory and copied to the card
  once a call. On the card each program is a CUDA graph, captured in
  ``warmup()``, which ``start()`` calls on the caller's thread before the
  loop thread starts, so the loop never captures. ``trace_count`` counts
  the plain step's programs (``dl4jtpu_decode_compiled_programs_total``,
  exactly one per engine); ``dl4jtpu_kv_compiled_programs_total`` the
  prefill's and the copy-on-write's. A tick reads its results once: one
  copy into pinned memory and one event wait.
- Sampling is a pure function of (distribution, request seed, position):
  ``serving.spec.accept.oracle_tokens``, tensor code inside the programs,
  the one rule of the plain step, the draft, the verify and
  ``generate_naive``. Any arrival schedule gives the same text for the
  same seed.
- Per-slot carries are wiped when a slot is re-claimed (reset mask), so a
  slot never sees a previous request's carries, and inactive slots'
  carries are frozen by an active mask. KV caches are positional and
  written in place by the attention layers: no slot mask touches them. A
  dense row that is not fed this call writes at the position its stream
  feeds next (0 for an empty slot), which is rewritten before any read;
  a paged one has an all-zero page-table row and writes into the scratch
  block.
- ``kv="dense"``: each slot owns ``max_len`` cache rows. ``kv="paged"``:
  the attention layers keep one block pool (serving/kv/pool.py) and the
  engine keeps an (S, max_len / kv_block_size) int32 page table on the
  host, which reaches the card only inside a program's staged inputs; a
  request claims the blocks its prompt and completion need on admission
  (the queue head waits while the pool is short) and frees them when it
  finishes. ``prefix_cache`` (the default, as in the JAX package) shares
  finished prompts' full blocks with later requests (kv/prefix.py), a
  partial block by copy-on-write; ``chunk_tokens`` feeds prompts that many
  positions a tick in one ``prefill_chunk`` call beside the decoding
  slots.
- ``spec``: a ``serving.spec.SpecConfig``; each tick makes at most one
  draft call, one plain step for rows still consuming their prompt and
  one verify (serving/spec/).
- Weights: the programs read an engine-owned parameter set
  (``serving.engine.ResidentWeights``, the bucketed engine's too). Until
  the first ``swap_weights`` a float32 engine follows the model: before a
  tick whose model parameters moved (the containers' ``_params_version``,
  bumped by every update and load) the model's are copied into it in
  place. A swap copies the new weights into it, leaf by path, at a tick
  boundary with no live slot: no new capture. ``precision="int8"`` /
  ``"fp8"`` keeps the set as codes and per-channel scales (quant/),
  quantized once from the
  model (which it then no longer follows) and again after the gate of
  each swap, written into the same tensors; every program dequantizes
  inside its graph (plain tensor code before the unchanged float32 math,
  so K8 / K9 see the same float32 queries), and each (model, precision)
  pair costs one capture per program, as at float32. A quantized draft
  keeps its own quantized set, refreshed in place when the weights it
  drafts with move.
- KV as host bytes. The host tier's spills and restores and a chain's
  export and import move rows between the pool tensors and host numpy
  arrays: ``index_select`` and a read, ``index_copy_`` of a staged copy.
  The programs read the pool by address, so rows are written into the
  resident tensors in place and no program is added or captured. Every
  move runs on the loop thread (or inline when no loop runs) on the
  stream the programs replay on, so a gather reads after the last replay
  that wrote its rows and a scatter lands before the next replay reads
  them. An evicted block enters the tier at once, its rows read in one
  batch with the other evictions before anything writes to the pool (the
  top of the next tick, or a scatter): an eviction is host bookkeeping,
  not a device round trip. A restore claims its block at once and lands
  its rows after those reads, before any copy-on-write (whose source may
  be the restored block).
- The journal. Every request leaves one terminal record in
  ``self.journal`` (monitor/reqlog.py): ``eos`` or ``max_new``, ``shed``
  on a full queue, ``error`` when ``stop()`` or a failed tick leaves it
  unanswered; time to first token, inter-token latency and queue wait
  feed histograms whose exemplars are request ids. Host clocks only: no
  device synchronization is added.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.exec import get_executor
from deeplearning4j_tpu_torch.exec.executor import (HostResult, HostStage,
                                                    Layout, ResidentProgram)
from deeplearning4j_tpu_torch.monitor.metrics import get_registry
from deeplearning4j_tpu_torch.monitor.reqlog import RequestLog, new_record
from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.nn.layers.base import (copy_into, map_tree,
                                                     where_rows)
from deeplearning4j_tpu_torch.quant import dequantize_tree, resolve_precision
from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, ServerOverloadedError)
from deeplearning4j_tpu_torch.serving.engine import (ResidentWeights,
                                                     input_type_of,
                                                     model_signature,
                                                     validate_swap)
from deeplearning4j_tpu_torch.serving.kv import (BlockPool, HostKVTier,
                                                 KVMigrateError,
                                                 PoolExhaustedError,
                                                 PrefixCache,
                                                 blocks_for_span,
                                                 is_pool_path,
                                                 map_pool_leaves,
                                                 map_slot_leaves,
                                                 pack_chain, unpack_chain)
from deeplearning4j_tpu_torch.serving.kv.migrate import row_dtype
from deeplearning4j_tpu_torch.serving.kv.prefix import _ROOT, _chain_hash
from deeplearning4j_tpu_torch.serving.spec.accept import (  # noqa: F401
    oracle_token, oracle_tokens)

# decode-state keys the per-slot wipe and freeze skip (KV caches)
POSITIONAL_KEYS = MultiHeadAttention.positional_state_keys

# engine counters: stats() key -> (registry name, help)
_KV_COUNTERS = {
    "prefix_hits": ("dl4jtpu_kv_prefix_hits_total",
                    "Requests that reused at least one cached prefix block."),
    "prefix_tokens_saved": ("dl4jtpu_kv_prefix_tokens_saved_total",
                            "Prefill positions skipped by prefix-cache "
                            "reuse."),
    "cow_copies": ("dl4jtpu_kv_cow_copies_total",
                   "Copy-on-write block copies (partial prefix match "
                   "claimed then diverged into a private block)."),
    "prefill_chunks": ("dl4jtpu_kv_prefill_chunks_total",
                       "Chunked-prefill slot-chunks executed."),
    "prefill_tokens": ("dl4jtpu_kv_prefill_tokens_total",
                       "Prompt tokens prefilled through the chunked-prefill "
                       "call."),
    "exhausted_events": ("dl4jtpu_kv_pool_exhausted_total",
                         "Admissions stalled because the KV block pool "
                         "could not cover the request at the queue head."),
    "host_restores": ("dl4jtpu_kv_host_restores_total",
                      "Spilled prefix blocks promoted back from the host "
                      "tier on a second-chance match hit."),
    "migrate_exports": ("dl4jtpu_kv_migrate_exports_total",
                        "Block chains serialized for engine-to-engine KV "
                        "migration (/kv/export)."),
    "migrate_imports": ("dl4jtpu_kv_migrate_imports_total",
                        "Block chains restored from a migration payload "
                        "(/kv/import)."),
}
_SPEC_COUNTERS = {
    "drafted_tokens": ("dl4jtpu_spec_drafted_tokens_total",
                       "Tokens proposed by the speculative draft model."),
    "accepted_tokens": ("dl4jtpu_spec_accepted_tokens_total",
                        "Drafted tokens accepted by target verification "
                        "(exact-match against the sampling oracle)."),
}


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: not ported to the PyTorch package yet (ROADMAP queue 1 "
        "item 6)")


class _Request:
    """Host-side bookkeeping for one occupied slot."""

    __slots__ = ("prompt", "max_new", "seed", "temperature", "top_k",
                 "cursor", "generated", "future", "fresh", "kv_blocks",
                 "draft_cursor", "draft_sel", "draft_fresh", "rid",
                 "tenant", "priority", "trace_id", "t_start", "t_admit",
                 "t_prefill0", "t_first", "t_last", "verify_s", "drafted",
                 "accepted", "prefix_hit", "host_restores")

    def __init__(self, prompt, max_new, seed, temperature, top_k, future,
                 rid=None, tenant="default", priority="normal",
                 trace_id=None):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.seed = int(seed)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.cursor = 0          # next input position to feed
        self.generated: List[int] = []
        self.future = future
        self.fresh = True        # first call must wipe the slot's state
        self.kv_blocks: List[int] = []   # paged engines: claimed blocks
        # speculative engines: the draft's own progress through the stream
        self.draft_cursor = 0    # next position the draft feeds
        self.draft_sel = 0       # snapshot to resume the draft's carries at
        self.draft_fresh = True  # first draft call must wipe its state
        # the journal record's identity and host perf_counter stamps
        self.rid = rid
        self.tenant = tenant
        self.priority = priority
        self.trace_id = trace_id  # None: trace contexts are not ported
        self.t_start = time.perf_counter()
        self.t_admit = None      # slot claimed (the queue phase ends)
        self.t_prefill0 = None   # first prefill work dispatched
        self.t_first = None      # first token emitted
        self.t_last = None       # latest emission
        self.verify_s = 0.0      # spec: wall of its verify calls
        self.drafted = 0         # spec: tokens proposed for it
        self.accepted = 0        # spec: tokens accepted for it
        self.prefix_hit = 0      # paged: prompt positions reused
        self.host_restores = 0   # paged: blocks restored from the tier

    def token_at(self, p: int) -> int:
        """The stream's token at position ``p`` (prompt, then generated)."""
        n = len(self.prompt)
        return self.prompt[p] if p < n else self.generated[p - n]


class DecodeEngine:
    """Continuous-batching autoregressive decoder over a model (a
    MultiLayerNetwork or a single-input ComputationGraph) whose output
    layer emits per-token probabilities. Inputs are token ids; the engine
    one-hots them to the model's input width.

        eng = DecodeEngine(net, slots=8, max_len=256, kv="paged").start()
        toks = eng.generate([3, 1, 4], max_new_tokens=32)["tokens"]

    ``max_len``: positions per stream (prompt + generated). ``eos_id``: a
    token that ends its stream (emitted, then the slot is freed); None:
    length only. ``precision``: ``"f32"``, ``"int8"`` or ``"fp8"`` (None:
    the executor's policy, ``DL4JTPU_PRECISION``). ``kv``:
    ``"dense"`` or ``"paged"``; a paged engine takes ``kv_block_size``
    (positions per block, dividing ``max_len``), ``kv_blocks`` (pool size;
    the default, ``slots * max_len / kv_block_size + 1``, holds every slot
    at full length beside the scratch block), ``prefix_cache`` (needs a
    model whose only per-slot decode state is the paged KV cache: pass
    False for a recurrent model) and ``chunk_tokens``. ``spec``: a
    ``SpecConfig``. ``host_kv_bytes`` (paged with the prefix cache): the
    byte budget of a host tier that evicted prefix blocks spill to and are
    restored from (kv/hosttier.py). ``journal_capacity``: the records the
    request journal keeps.
    """

    _ids = itertools.count()

    def __init__(self, model, slots: int = 8, max_len: int = 256,
                 eos_id: Optional[int] = None, max_queue: int = 256,
                 precision: Optional[str] = None, kv: str = "dense",
                 kv_block_size: int = 16, kv_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 chunk_tokens: Optional[int] = None,
                 host_kv_bytes: Optional[int] = None, spec=None,
                 journal_capacity: int = 512):
        self.model = model
        self.id = f"decode{next(DecodeEngine._ids)}"
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.max_queue = int(max_queue)
        execu = getattr(model, "_executor", None) or get_executor()
        self.precision = (resolve_precision(precision)
                          if precision is not None else execu.precision)
        if kv not in ("dense", "paged"):
            raise ValueError(f"kv must be 'dense' or 'paged', got {kv!r}")
        if kv == "dense" and chunk_tokens is not None:
            raise ValueError("chunk_tokens requires kv='paged'")
        if kv == "paged" and self.max_len % int(kv_block_size) != 0:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of kv_block_size "
                f"({kv_block_size})")
        if chunk_tokens is not None and int(chunk_tokens) < 1:
            raise ValueError("chunk_tokens must be >= 1")
        if host_kv_bytes is not None and (kv != "paged" or not prefix_cache):
            raise ValueError(
                "host_kv_bytes requires kv='paged' with prefix_cache=True "
                "(the tier holds evicted prefix-cache blocks)")
        self.kv = kv
        self.kv_block_size = int(kv_block_size)
        self.chunk_tokens = (int(chunk_tokens) if chunk_tokens is not None
                             else None)
        self.vocab = input_type_of(model).size
        self.device = model.device
        # the engine-owned parameter set the programs read by address: a
        # float32 copy, or codes and scales under int8 / fp8 (with the
        # float32 signature swap candidates are held to)
        self._weights_set = ResidentWeights(model, self.precision, execu,
                                            self.id, own=True)
        self._params = self._weights_set.params
        self._pending_swap = None
        self._version = 0
        self._spec = spec
        self._draft = self._verifier = None
        self._draft_source = None
        self._pool: Optional[BlockPool] = None
        self._prefix: Optional[PrefixCache] = None
        self._tables: Optional[np.ndarray] = None
        self._max_blocks = None
        self._pending_cows: List[tuple] = []
        self._host_tier: Optional[HostKVTier] = None
        # block -> rows per leaf: tier restores claimed in a match whose
        # copy onto the card lands at the top of the next tick
        self._pending_restores: dict = {}
        # (block, rows to fill): evicted blocks already in the tier whose
        # rows are read in one batch before anything can overwrite them
        self._pending_spills: List[tuple] = []
        self._leaf_items = None     # (decode state, its pool leaves)
        # export / import closures run on the loop thread, the only one
        # that touches the pool tensors while the loop runs
        self._kv_ops: deque = deque()
        self._model_sig = None
        if kv == "paged":
            self._max_blocks = self.max_len // self.kv_block_size
            if kv_blocks is None:
                kv_blocks = self.slots * self._max_blocks + 1
            self._pool = BlockPool(int(kv_blocks), self.kv_block_size)
            self._tables = np.zeros((self.slots, self._max_blocks), np.int32)
            if prefix_cache:
                self._check_no_carries()
                self._prefix = PrefixCache(self._pool)
                if host_kv_bytes is not None:
                    self._host_tier = HostKVTier(int(host_kv_bytes),
                                                 engine=self.id)
                    self._prefix.tier = self._host_tier
                    self._prefix.spill_fn = self._spill_block
                    self._prefix.restore_fn = self._restore_block
        if spec is not None:
            self._build_spec(spec)
        self._dstate = None
        self._slot_reqs: List[Optional[_Request]] = [None] * self.slots
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._kv_blocked = False
        self._steps = 0
        self._tokens = 0
        self._requests = 0
        self._decode_seconds = 0.0
        self.warmup_seconds = None
        # programs: built by warmup(); captured on the card unless the
        # eager seam (False) is set first, the oracle a measurement
        # compares the captured engine with
        self._capture_programs = self.device.type == "cuda"
        self._programs = {}
        # the counters stats() reads, also published under the JAX
        # package's names
        self._n = Counter()
        reg = get_registry()
        lab = {"engine": self.id}
        counters = ({} if self._pool is None else dict(_KV_COUNTERS))
        if spec is not None:
            counters.update(_SPEC_COUNTERS)
        self._m = {key: reg.counter(name, help_, ("engine",)).labels(**lab)
                   for key, (name, help_) in counters.items()}
        self._m_compiled = reg.counter(
            "dl4jtpu_decode_compiled_programs_total",
            "Programs of the batched decode step: CUDA graphs captured on "
            "the card, signatures run elsewhere (design target: exactly "
            "one per model).", ("engine",)).labels(**lab)
        if self._pool is not None:
            self._m_kv_programs = reg.counter(
                "dl4jtpu_kv_compiled_programs_total",
                "Programs of the paged-KV side programs (chunked prefill + "
                "copy-on-write; design target: at most one each).",
                ("engine",)).labels(**lab)
        self._m_version = reg.gauge(
            "dl4jtpu_model_version",
            "Version of the weights currently serving (0 = the model's "
            "initial weights; bumped by every hot swap).",
            ("engine",)).labels(**lab)
        self._m_swaps = reg.counter(
            "dl4jtpu_model_swaps_total",
            "Weight hot-swaps applied with zero new captures.",
            ("engine",)).labels(**lab)
        self._m_version.set(0.0)
        # the request-lifecycle histograms (host stamps, ids as exemplars)
        self._m_ttft = reg.histogram(
            "dl4jtpu_decode_ttft_seconds",
            "Time-to-first-token: submit to first emitted token, queue "
            "wait included (the prefill-dominated serving SLO).",
            ("engine",)).labels(**lab)
        self._m_itl = reg.histogram(
            "dl4jtpu_decode_itl_seconds",
            "Inter-token latency: wall between consecutive emitted "
            "tokens; speculative runs contribute one sample per accepted "
            "token (run wall / run length).", ("engine",)).labels(**lab)
        self._m_queue = reg.histogram(
            "dl4jtpu_decode_queue_seconds",
            "Admission queue wait: submit to slot claim.",
            ("engine",)).labels(**lab)
        self.journal = RequestLog(journal_capacity)
        if self._pool is not None:
            self._m_migrate_rejects = reg.counter(
                "dl4jtpu_kv_migrate_rejects_total",
                "Migration payloads rejected before touching the pool "
                "(envelope mismatch, torn bytes, exhausted destination).",
                ("engine", "reason"))
        if spec is not None:
            self._m_spec_rate = reg.gauge(
                "dl4jtpu_spec_acceptance_rate",
                "Lifetime accepted/drafted ratio.", ("engine",)).labels(**lab)
            self._m_spec_depth = reg.histogram(
                "dl4jtpu_spec_accepted_depth",
                "Accepted tree depth per verify (0 = root correction only).",
                ("engine",), buckets=tuple(
                    float(d) for d in range(self._spec_tree.d + 1))
            ).labels(**lab)

    def _build_spec(self, spec):
        """Validate ``spec`` as the JAX engine does and build the draft
        and the verifier."""
        from deeplearning4j_tpu_torch.serving.spec import (DraftEngine,
                                                           SpecVerifier,
                                                           TreeSpec)
        from deeplearning4j_tpu_torch.serving.spec.selfdraft import \
            build_self_draft
        if int(spec.k) < 1:
            raise ValueError(f"spec.k must be >= 1, got {spec.k}")
        self._spec_tree = TreeSpec(spec.kvec())
        # draft positions a call: the spine's depth + 1 (the extra one
        # keeps a resume snapshot at full acceptance)
        self._spec_k = self._spec_tree.d + 1
        dm = spec.draft_model
        if (dm is None) == (spec.self_draft is None):
            raise ValueError(
                "spec needs exactly one of draft_model or self_draft "
                f"(got draft_model={dm!r}, "
                f"self_draft={spec.self_draft!r})")
        own = self._params
        # _draft_source: the float32 weights a quantized draft is made
        # (and refreshed) from, as a function of the target's float32 tree
        if spec.self_draft is not None:
            dm, dprec = build_self_draft(self.model, spec)
            if dm is self.model:
                # int8 / fp8: the target from its own quantized copy
                dparams, self._draft_source = None, (lambda t: t)
            else:
                # the target's first M layers and readout, in the
                # engine's set
                dparams = [own[i] for i in range(dm.m)] + [own[-1]]
                if dprec is not None:
                    self._draft_source = (
                        lambda t, m=dm.m: [t[i] for i in range(m)] + [t[-1]])
        elif input_type_of(dm).size != self.vocab:
            raise ValueError(
                f"draft model vocabulary ({input_type_of(dm).size}) must "
                f"match the target's ({self.vocab})")
        else:
            dprec = spec.draft_precision
            # the target as its own draft reads the engine's set too
            dparams = own if dm is self.model else None
            if dm is self.model and dprec is not None:
                self._draft_source = lambda t: t
        self._spec_tree.tensors(self.device)
        self._verifier = SpecVerifier(self.model, self.slots,
                                      self._spec_tree, self.vocab,
                                      max_blocks=self._max_blocks)
        source = (None if self._draft_source is None
                  else self._draft_source(self.model.params))
        self._draft = DraftEngine(dm, self.slots, self.max_len, self._spec_k,
                                  self.vocab, precision=dprec,
                                  side_k=max(self._spec_tree.kvec) - 1,
                                  params=dparams, source=source,
                                  owner=self.id)

    def _check_no_carries(self):
        """The prefix cache shares KV blocks between requests; a recurrent
        carry depends on every earlier token and cannot be shared."""
        probe = self.model.init_decode_state(
            1, self.max_len, kv={"num_blocks": 2,
                                 "block_size": self.kv_block_size})
        carries = []
        map_slot_leaves(carries.append, probe)
        if carries:
            raise ValueError(
                "prefix_cache=True requires a model whose only per-slot "
                "decode state is the paged KV cache; this model carries "
                f"recurrent state ({len(carries)} non-pool leaves). Pass "
                "prefix_cache=False.")

    def _inc(self, key, n=1):
        self._n[key] += n
        self._m[key].inc(n)

    @property
    def trace_count(self) -> int:
        """Programs of the plain step (one per engine)."""
        return int(self._m_compiled.value)

    @property
    def model_version(self) -> int:
        return self._version

    # ------------------------------------------------------------ programs
    def _ensure_state(self):
        if self._dstate is None:
            kv = (None if self._pool is None else
                  {"num_blocks": self._pool.num_blocks,
                   "block_size": self.kv_block_size})
            self._dstate = self.model.init_decode_state(self.slots,
                                                        self.max_len, kv=kv)
        if self._draft is not None:
            self._draft.ensure_state()

    def _resident(self) -> dict:
        return {"params": self._params, "state": self._dstate}

    def _build_programs(self):
        """Every program of the engine, each with its staged layout."""
        if self._programs:
            return
        S, ex, cap = self.slots, get_executor(), self._capture_programs
        dev = self.device
        fields = dict(tokens=(S,), pos=(S,), reset=(S,), active=(S,),
                      seeds=((S,), np.uint32), temps=((S,), np.float32),
                      topk=(S,))
        if self._pool is not None:
            fields["tables"] = (S, self._max_blocks)
        self._layouts = {"step": Layout(**fields)}
        progs = {"step": ResidentProgram(ex, self._step_body, "step", cap,
                                         self._m_compiled.inc)}
        if self.chunk_tokens is not None:
            self._layouts["prefill"] = Layout(
                tokens=(S, self.chunk_tokens), start=(S,), n=(S,),
                reset=(S,), tables=(S, self._max_blocks))
            progs["prefill"] = ResidentProgram(
                ex, self._prefill_body, "prefill", cap,
                self._m_kv_programs.inc)
        if self._prefix is not None:
            self._layouts["cow"] = Layout(src=(1,), dst=(1,))
            progs["cow"] = ResidentProgram(ex, self._cow_body, "cow", cap,
                                           self._m_kv_programs.inc)
        self._stages = {k: HostStage(l, dev) for k, l in self._layouts.items()}
        self._step_out = HostResult((S,), dev)
        if self._spec is not None:
            progs["draft"] = self._draft.build(ex, cap)
            progs["verify"] = self._verifier.build(
                ex, cap, dict(self._resident(), props=self._draft.props,
                              sides=self._draft.sides))
        self._programs = progs

    def program_stats(self) -> dict:
        """Per program: its signatures (``programs``), the CUDA graphs it
        captured, the kernel launches one replay adds, and the precision
        and bytes of the parameter set it reads (none for the
        copy-on-write)."""
        own = (self.precision, self._weights_set.nbytes)
        sets = {"cow": (self.precision, 0)}
        if self._draft is not None:
            sets["draft"] = (self._draft.precision, self._draft.weight_bytes)
        return {k: {"programs": p.programs, "captures": p.captures,
                    "launches": [dict(g.launches) for g in p.graphs.values()],
                    "precision": sets.get(k, own)[0],
                    "weight_bytes": sets.get(k, own)[1]}
                for k, p in self._programs.items()}

    @torch.no_grad()
    def _step_body(self, res, buf):
        """ONE plain step for all S slots; scheduling rides in as masks.
        Returns the oracle token of every active row, 0 elsewhere."""
        f = self._layouts["step"].unpack(buf)
        dstate = res["state"]
        reset, active = f["reset"] != 0, f["active"] != 0
        pos = f["pos"]
        d0 = map_slot_leaves(
            lambda a: where_rows(reset, torch.zeros_like(a), a), dstate,
            keys=POSITIONAL_KEYS)
        x = torch.nn.functional.one_hot(f["tokens"].long(), self.vocab).to(
            torch.float32)[:, None, :]
        kw = ({} if self._pool is None else
              {"block_tables": torch.where(active[:, None], f["tables"], 0)})
        # int8 / fp8 widen here, inside the program (the identity at f32)
        y, new_d = self.model.decode_step(dequantize_tree(res["params"]), d0,
                                          x, pos, **kw)
        copy_into(dstate, map_slot_leaves(
            lambda n, o: where_rows(active, n, o), new_d, d0,
            keys=POSITIONAL_KEYS))
        tok = oracle_tokens(torch.log(y[:, 0, :].float()), f["seeds"], pos,
                            f["temps"], f["topk"])
        return torch.where(active, tok, 0).to(torch.int32)

    @torch.no_grad()
    def _prefill_body(self, res, buf):
        """Chunked prefill for all S slots in ONE call: slot i feeds
        ``tokens[i, :n[i]]`` at positions ``start[i] ..``; ``n == 0`` rows
        are inert (KV writes into the scratch block, carries frozen)."""
        f = self._layouts["prefill"].unpack(buf)
        dstate = res["state"]
        reset, live = f["reset"] != 0, f["n"] > 0
        d0 = map_slot_leaves(
            lambda a: where_rows(reset, torch.zeros_like(a), a), dstate,
            keys=POSITIONAL_KEYS)
        x = torch.nn.functional.one_hot(f["tokens"].long(), self.vocab).to(
            torch.float32)
        _, new_d = self.model.prefill_chunk(dequantize_tree(res["params"]),
                                            d0, x, f["start"], f["n"],
                                            block_tables=f["tables"])
        copy_into(dstate, map_slot_leaves(
            lambda a, b: where_rows(live, a, b), new_d, d0,
            keys=POSITIONAL_KEYS))

    @torch.no_grad()
    def _cow_body(self, res, buf):
        """Copy-on-write: pool block ``src`` into ``dst`` across every pool
        leaf, in place."""
        f = self._layouts["cow"].unpack(buf)
        src, dst = f["src"].long(), f["dst"].long()
        map_pool_leaves(
            lambda a: a.index_copy_(0, dst, a.index_select(0, src)),
            res["state"])

    def _call(self, kind, fill):
        """Stage a call's inputs (``fill`` writes them into the zeroed
        fields) and run program ``kind``; returns its device output."""
        stage = self._stages[kind]
        fill(stage.open())
        out = self._programs[kind](self._resident(), stage.tensor)
        stage.sent()
        return out

    # ------------------------------------------------------------ lifecycle
    def warmup(self, aot: Optional[str] = None) -> float:
        """Run every program of the engine once, inertly, so that each is
        captured (on the card) before the first request: the plain step
        with every slot inactive, a prefill chunk with every ``n == 0``, a
        scratch self-copy, an all-inert draft and an all-inert verify, as
        the JAX engine's ``_warmup_run``. The inert calls write only where
        idle rows park (rewritten before any read); the state found is put
        back, so it is left bit for bit as it was. Then the programs are
        sealed: the loop thread never captures. Returns
        ``warmup_seconds``. ``aot`` (the JAX package's artifacts) is not
        ported."""
        if aot is not None:
            raise _unsupported(f"DecodeEngine.warmup(aot={aot!r})")
        self._ensure_state()
        if self._thread is not None and self._thread.is_alive():
            return self.warmup_seconds    # the loop thread owns the state
        self._build_programs()
        t0 = time.perf_counter()
        keep = [self._dstate]
        if self._draft is not None:
            keep += [self._draft._tree, self._draft.props, self._draft.sides]
        saved = [map_tree(lambda t: t.clone(), k) for k in keep]
        S = self.slots
        self._call("step", lambda f: None)
        if "prefill" in self._programs:
            self._call("prefill", lambda f: None)
        if "cow" in self._programs:
            self._call("cow", lambda f: None)
        if self._spec is not None:
            z = np.zeros(S, np.int64)
            self._draft.step(np.zeros((S, self._spec_k), np.int64), z, z, z,
                             z, z, z, np.zeros(S, np.float32), z)
            self._verifier.stage()
            self._verifier.run()
        for k, s in zip(keep, saved):
            copy_into(k, s)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for p in self._programs.values():
            p.seal()
        self.warmup_seconds = time.perf_counter() - t0
        return self.warmup_seconds

    def start(self) -> "DecodeEngine":
        if self._thread is None or not self._thread.is_alive():
            self.warmup()
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        err = BatcherStoppedError("decode engine stopped")
        with self._cv:
            while self._kv_ops:
                _fn, fut = self._kv_ops.popleft()
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(err)
            # restores claimed but not landed land now, so that restored
            # blocks hold their content across a restart
            self._land_restores()
            if self._pending_swap is not None:
                # a swap staged against a stopping engine still applies
                # (and unblocks its waiter): a restart serves the new
                # weights
                self._apply_swap_locked()
            pending = list(self._queue)
            self._queue.clear()
            live = [r for r in self._slot_reqs if r is not None]
            self._slot_reqs = [None] * self.slots
            if self._pool is not None:
                # aborted streams publish nothing (their KV is incomplete)
                for r in live:
                    for b in r.kv_blocks:
                        self._pool.decref(b)
                    r.kv_blocks = []
                for src, _dst in self._pending_cows:
                    self._pool.decref(src)
                self._pending_cows = []
                self._tables[:] = 0
                self._kv_blocked = False
        for r in pending + live:
            if not r.future.done():
                self._journal_terminal(r, "error")
                r.future.set_exception(err)

    @property
    def saturated(self) -> bool:
        """All S slots busy: a new request would queue behind them."""
        with self._cv:
            return all(r is not None for r in self._slot_reqs)

    @property
    def kv_exhausted(self) -> bool:
        """Paged engines: the request at the queue head could not claim
        its blocks at the last admission pass (clears as blocks return).
        /healthz reports ``degraded`` with the pool's occupancy."""
        if self._pool is None:
            return False
        with self._cv:
            return self._kv_blocked

    def kv_pool_info(self) -> Optional[dict]:
        """The pool's occupancy for /healthz and ``stats()`` (None for a
        dense engine), with the host tier's stats when one is attached."""
        if self._pool is None:
            return None
        info = {"blocks": self._pool.usable,
                "blocks_free": self._pool.free_count,
                "blocks_in_use": self._pool.in_use,
                "blocks_cached": self._pool.cached_count,
                "block_size": self.kv_block_size,
                "high_water": self._pool.high_water}
        if self._host_tier is not None:
            info["host_tier"] = self._host_tier.stats()
        return info

    # --------------------------------------------------------------- weights
    def swap_weights(self, params, state=None, version: Optional[int] = None,
                     timeout: Optional[float] = 60.0) -> int:
        """Stage a same-shape weight swap and wait for it to apply.

        The candidate is validated first (the same keys, shapes and
        dtypes as the engine's float32 parameters, else ``WeightSwapError``
        with the engine untouched; the port's decode models carry no
        ``state``, so a non-empty one is refused too), then quantized under
        int8 / fp8. Admission pauses, the live generations finish on the
        old weights, and the loop applies the swap at the first tick
        boundary with no live slot: the new weights are copied into the
        engine's parameter set in place (no new capture), a quantized
        draft's set is refreshed from them, the prefix cache is cleared
        (its KV was computed under the old weights), the version bumps
        (``version`` when given). Returns the new version."""
        self._weights_set.check(params, None, "decode params")
        if state:
            validate_swap({}, state, "decode state")
        prepared = self._weights_set.prepare(params)
        applied = threading.Event()
        with self._cv:
            self._pending_swap = (prepared, version, applied)
            self._cv.notify_all()
            if self._thread is None or not self._thread.is_alive():
                self._apply_swap_locked()   # no loop running: apply now
        if timeout is not None and not applied.wait(timeout):
            raise TimeoutError(
                f"decode weight swap not applied within {timeout}s "
                f"(in-flight generations still draining)")
        return self._version

    @torch.no_grad()
    def _apply_swap_locked(self) -> None:
        """Apply the staged swap (the caller holds ``self._cv``; no live
        slot)."""
        prepared, version, applied = self._pending_swap
        self._pending_swap = None
        self._weights_set.write(prepared)
        if self._draft_source is not None:
            self._draft.refresh(self._draft_source(prepared[2]))
        if self._prefix is not None:
            # the flush purges the host tier too; a restore still pending
            # for a block it freed has nowhere to land
            self._prefix.clear()
            self._pending_restores = {
                b: rows for b, rows in self._pending_restores.items()
                if self._pool.refcount(b) > 0}
        self._version = (int(version) if version is not None
                         else self._version + 1)
        self._m_version.set(float(self._version))
        self._m_swaps.inc()
        applied.set()

    @torch.no_grad()
    def _follow_model(self):
        """Until the first swap, a float32 engine copies the model's
        parameters into its set in place whenever they moved (and
        refreshes a quantized draft from them)."""
        if self._weights_set.follow() and self._draft_source is not None:
            self._draft.refresh(self._draft_source(self.model.params))

    # ------------------------------------------------------------ scheduler
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               seed: int = 0, temperature: float = 0.0,
               top_k: int = 0, request_id: Optional[str] = None,
               tenant: str = "default", priority: str = "normal") -> Future:
        """Enqueue one generation request; returns a Future resolving to
        ``{"tokens": [...], "prompt_len": int}``. ``request_id``,
        ``tenant`` and ``priority`` ride into the request's journal record
        (and the histograms' exemplars)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must contain at least one token id")
        if not all(0 <= t < self.vocab for t in prompt):
            raise ValueError(f"token ids must be in [0, {self.vocab})")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds engine capacity max_len={self.max_len}")
        if self._pool is not None:
            need = blocks_for_span(len(prompt) + int(max_new_tokens) - 1,
                                   self.kv_block_size)
            if need > self._pool.usable:
                raise ValueError(
                    f"request needs {need} KV blocks (block_size="
                    f"{self.kv_block_size}) but the pool holds "
                    f"{self._pool.usable}: it could never be admitted")
        if self._stop.is_set() and self._thread is not None:
            raise BatcherStoppedError("decode engine stopped")
        fut = Future()
        req = _Request(prompt, max_new_tokens, seed, temperature, top_k, fut,
                       rid=request_id, tenant=tenant, priority=priority)
        with self._cv:
            if len(self._queue) >= self.max_queue:
                # a rejected request leaves its one record too
                self._journal_terminal(req, "shed")
                raise ServerOverloadedError(
                    f"decode queue full ({self.max_queue})")
            self._queue.append(req)
            self._cv.notify_all()
        return fut

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 32,
                 seed: int = 0, temperature: float = 0.0, top_k: int = 0,
                 timeout: Optional[float] = None,
                 request_id: Optional[str] = None, tenant: str = "default",
                 priority: str = "normal") -> dict:
        """Blocking ``submit`` -- the call the HTTP endpoint makes."""
        return self.submit(prompt, max_new_tokens, seed, temperature,
                           top_k, request_id=request_id, tenant=tenant,
                           priority=priority).result(timeout=timeout)

    def _admit_locked(self):
        if self._pending_swap is not None:
            return          # admission pauses so that live slots drain
        blocked = False
        for i in range(self.slots):
            if not self._queue:
                break
            if self._slot_reqs[i] is not None:
                continue
            r = self._queue[0]
            if self._pool is not None:
                try:
                    self._claim_kv(r, i)
                except PoolExhaustedError:
                    # head-of-line blocking: the queue head admits as soon
                    # as a finishing request frees enough blocks
                    if not self._kv_blocked:
                        self._inc("exhausted_events")
                    blocked = True
                    break
            self._slot_reqs[i] = self._queue.popleft()
            r.t_admit = time.perf_counter()
            self._m_queue.observe(r.t_admit - r.t_start, exemplar=r.rid)
        if self._pool is not None:
            self._kv_blocked = blocked

    def _claim_kv(self, r, slot):
        """Claim the pool blocks for positions 0 .. prompt + max_new - 2
        (the last sampled token is returned, never fed back) and write the
        slot's page-table row. Prefix hits are claimed read-only and skip
        their prefill; a partial tail match is copied into the first fresh
        block (copy-on-write, before the slot's first call). All or
        nothing."""
        bs = self.kv_block_size
        need = blocks_for_span(len(r.prompt) + r.max_new - 1, bs)
        shared, cow, skip = [], None, 0
        if self._prefix is not None:
            # the match runs on the loop thread alone, so the counter's
            # move is this request's restores
            r0 = self._n["host_restores"]
            shared, cow, skip = self._prefix.match(r.prompt)
            r.host_restores = self._n["host_restores"] - r0
        try:
            fresh = self._pool.alloc(need - len(shared))
        except PoolExhaustedError:
            for b in shared:
                self._pool.decref(b)
            if cow is not None:
                self._pool.decref(cow[0])
            raise
        if cow is not None:
            self._pending_cows.append((cow[0], fresh[0]))
        if skip:
            self._inc("prefix_hits")
            self._inc("prefix_tokens_saved", skip)
        r.kv_blocks = shared + fresh
        r.cursor = skip
        r.prefix_hit = skip
        row = self._tables[slot]
        row[:] = 0
        row[:need] = r.kv_blocks

    def _release_kv(self, slot, r):
        """Return a finished request's blocks to the pool and clear its
        table row. The prompt's full blocks are published first, so blocks
        whose count drops to 0 park on the evictable LRU."""
        if self._pool is None or not r.kv_blocks:
            return
        if self._prefix is not None:
            self._prefix.insert(r.prompt, r.kv_blocks)
        for b in r.kv_blocks:
            self._pool.decref(b)
        r.kv_blocks = []
        self._tables[slot][:] = 0

    def _free_slot(self, slot, r):
        with self._cv:
            self._release_kv(slot, r)
            self._slot_reqs[slot] = None

    def _finish(self, slot, r, outcome):
        """A completed stream: its blocks (the peak, counted before they
        go) return, the slot frees, its record lands, its future
        resolves."""
        kv_peak = len(r.kv_blocks)
        self._free_slot(slot, r)
        self._requests += 1
        self._journal_terminal(r, outcome, kv_peak=kv_peak)
        r.future.set_result({"tokens": r.generated,
                             "prompt_len": len(r.prompt)})

    def _fail(self, live, err):
        """Fail the live requests of a tick whose call raised; their
        blocks return to the pool unpublished."""
        with self._cv:
            for i, r in live:
                if self._pool is not None:
                    for b in r.kv_blocks:
                        self._pool.decref(b)
                    r.kv_blocks = []
                    self._tables[i][:] = 0
                self._slot_reqs[i] = None
        for _, r in live:
            self._journal_terminal(r, "error")
            r.future.set_exception(err)

    def _emit(self, r, tok) -> Optional[str]:
        """Append one generated token; the stream's outcome when it is
        done (``eos`` at its ``eos_id``, ``max_new`` at its length), else
        None."""
        r.generated.append(tok)
        self._tokens += 1
        if self.eos_id is not None and tok == self.eos_id:
            return "eos"
        return "max_new" if len(r.generated) >= r.max_new else None

    def _stamp(self, r, now, n):
        """A run of ``n`` tokens emitted at ``now``: time to first token on
        the stream's first, one inter-token sample per other token (the
        run's wall spread over it)."""
        per = (now - (r.t_last if r.t_last is not None else r.t_start)) / n
        if r.t_first is None:
            r.t_first = now
            self._m_ttft.observe(now - r.t_start, exemplar=r.rid)
            n -= 1
        for _ in range(n):
            self._m_itl.observe(per, exemplar=r.rid)
        r.t_last = now

    def _loop(self):
        while not self._stop.is_set():
            with self._cv:
                self._drain_kv_ops_locked()
                if (self._pending_swap is not None
                        and all(r is None for r in self._slot_reqs)):
                    # a tick boundary with no live slot: every generation
                    # in flight ran end to end on the old weights
                    self._apply_swap_locked()
                self._admit_locked()
                live = [(i, r) for i, r in enumerate(self._slot_reqs)
                        if r is not None]
                if not live:
                    self._cv.wait(timeout=0.05)
                    continue
            try:
                self._tick(live)
            except Exception as e:  # noqa: BLE001 -- fail the live requests
                self._fail(live, e)

    def _tick(self, live):
        self._follow_model()
        if self._pending_restores or self._pending_spills:
            # before anything writes to the evicted blocks or reads the
            # restored ones, the copy-on-write below included (its source
            # may be a block just restored)
            with self._cv:
                self._land_restores()
        if self._pending_cows:
            # before the claimer's first call reads or overwrites the copy
            cows, self._pending_cows = self._pending_cows, []
            for src, dst in cows:
                def fill(f, src=src, dst=dst):
                    f["src"][0], f["dst"][0] = src, dst
                self._call("cow", fill)
                self._pool.decref(src)
                self._inc("cow_copies")
        if self.chunk_tokens is not None:
            pre = [(i, r) for i, r in live if r.cursor < len(r.prompt) - 1]
            if pre:
                self._prefill(pre)
            # slots whose prompt is consumed up to its last token step now
            live = [(i, r) for i, r in live if r.cursor >= len(r.prompt) - 1]
            if not live:
                return
        if self._spec is not None:
            self._tick_spec(live)
            return
        t0 = time.perf_counter()
        nt = self._step_out.read(self._step(live))
        now = time.perf_counter()
        self._decode_seconds += now - t0
        self._steps += 1
        done = []
        for i, r in live:
            r.cursor += 1
            if r.t_prefill0 is None:
                r.t_prefill0 = now           # a 1-token prompt's prefill
            if r.cursor < len(r.prompt):
                continue                     # still prefilling
            outcome = self._emit(r, int(nt[i]))
            self._stamp(r, now, 1)
            if outcome is not None:
                done.append((i, r, outcome))
        for i, r, outcome in done:
            self._finish(i, r, outcome)

    def _prefill(self, pre):
        """One chunk of every row in ``pre`` (rows still consuming their
        prompt), ``chunk_tokens`` positions at most."""
        K = self.chunk_tokens
        fed = [0]
        t_chunk = time.perf_counter()

        def fill(f):
            f["tables"][...] = self._tables
            for i, r in pre:
                if r.t_prefill0 is None:
                    r.t_prefill0 = t_chunk
                k = min(K, len(r.prompt) - 1 - r.cursor)
                f["tokens"][i, :k] = r.prompt[r.cursor:r.cursor + k]
                f["start"][i] = r.cursor
                f["n"][i] = k
                f["reset"][i] = r.fresh
                r.fresh = False
                r.cursor += k
                fed[0] += k
        self._call("prefill", fill)
        self._inc("prefill_chunks", len(pre))
        self._inc("prefill_tokens", fed[0])

    def _step(self, rows):
        """The plain step with ``rows`` active; returns its device output.
        Every other occupied slot is fed nothing and writes at its cursor,
        the position it feeds next."""
        def fill(f):
            for i, r in enumerate(self._slot_reqs):
                if r is not None:
                    f["pos"][i] = min(r.cursor, self.max_len - 1)
            for i, r in rows:
                f["active"][i] = 1
                f["reset"][i] = r.fresh
                r.fresh = False
                f["tokens"][i] = r.token_at(r.cursor)
                f["seeds"][i] = r.seed & 0xFFFFFFFF
                f["temps"][i] = r.temperature
                f["topk"][i] = r.top_k
            if self._pool is not None:
                f["tables"][...] = self._tables
        return self._call("step", fill)

    # ------------------------------------------------------- speculative tick
    def _tick_spec(self, live):
        """One speculative iteration: at most one draft call (prompt
        catch-up rows and ready rows share it), one plain step for rows
        still consuming their prompt (its tokens ignored), and one verify
        of every ready row's tree, whose result is the tick's one read. A
        row is ready once the draft has caught up with the target's
        cursor; catch-up feeds the known stream (prompt and generated),
        which also resyncs the draft after a side-branch acceptance left
        it behind."""
        S, K, tr = self.slots, self._spec_k, self._spec_tree
        catchup, ready, tpre = [], [], []
        for i, r in live:
            plen = len(r.prompt)
            known = plen + len(r.generated)
            if r.cursor < plen - 1:
                tpre.append((i, r))
            if r.draft_cursor < known - 1:
                catchup.append((i, r, known))
            elif r.cursor >= plen - 1 and r.draft_cursor == r.cursor:
                # the window may not outrun the request or the KV capacity
                n_in = min(K, r.max_new - len(r.generated),
                           self.max_len - r.cursor)
                if n_in > 0:
                    ready.append((i, r, n_in))
        if catchup or ready:
            given = np.zeros((S, K), np.int64)
            n_given = np.zeros(S, np.int64)
            n_steps = np.zeros(S, np.int64)
            dpos = np.zeros(S, np.int64)
            sel = np.zeros(S, np.int64)
            dreset = np.zeros(S, bool)
            dseeds = np.zeros(S, np.int64)
            dtemps = np.zeros(S, np.float32)
            dtopk = np.zeros(S, np.int64)
            for i, r in enumerate(self._slot_reqs):
                if r is not None:   # rows outside the call park here
                    dpos[i] = min(r.draft_cursor, self.max_len - 1)
            for i, r, known in catchup:
                m = min(K, known - 1 - r.draft_cursor)
                given[i, :m] = [r.token_at(p) for p in
                                range(r.draft_cursor, r.draft_cursor + m)]
                n_given[i] = n_steps[i] = m
                dpos[i] = r.draft_cursor
                sel[i] = r.draft_sel
                dreset[i] = r.draft_fresh
                r.draft_fresh = False
                r.draft_cursor += m
                r.draft_sel = m - 1
            for i, r, n_in in ready:
                given[i, 0] = r.token_at(r.cursor)
                n_given[i] = 1
                n_steps[i] = n_in
                dpos[i] = r.cursor
                sel[i] = r.draft_sel
                dreset[i] = r.draft_fresh
                r.draft_fresh = False
                dseeds[i] = r.seed & 0xFFFFFFFF
                dtemps[i] = r.temperature
                dtopk[i] = r.top_k
            self._draft.step(given, n_given, n_steps, dpos, sel, dreset,
                             dseeds, dtemps, dtopk)
        if tpre:
            t0 = time.perf_counter()
            self._step(tpre)
            now = time.perf_counter()
            self._decode_seconds += now - t0
            self._steps += 1
            for _, r in tpre:
                r.cursor += 1
                if r.t_prefill0 is None:
                    r.t_prefill0 = now
        if not ready:
            return
        f = self._verifier.stage()
        for i, r in enumerate(self._slot_reqs):
            if r is not None:
                f["pos0"][i] = min(r.cursor, self.max_len - 1)
        for i, r, n_in in ready:
            # node 0: the last emitted (or last prompt) token; the draft's
            # proposals fill the other nodes on the card
            f["node0"][i] = r.token_at(r.cursor)
            f["pos0"][i] = r.cursor
            f["n_in"][i] = n_in
            f["reset"][i] = r.fresh
            r.fresh = False
            f["seeds"][i] = r.seed & 0xFFFFFFFF
            f["temps"][i] = r.temperature
            f["topk"][i] = r.top_k
        if self._pool is not None:
            f["tables"][...] = self._tables
        t0 = time.perf_counter()
        etoks, acc, emit, sacc = self._verifier.run()
        now = time.perf_counter()
        self._decode_seconds += now - t0
        self._steps += 1
        done = []
        for i, r, n_in in ready:
            # judged proposals: depths 1..min(d, n_in - 1) and the bonus
            self._inc("drafted_tokens", min(tr.d, n_in))
            self._inc("accepted_tokens", int(acc[i]))
            r.drafted += min(tr.d, n_in)
            r.accepted += int(acc[i])
            r.verify_s += now - t0
            self._m_spec_depth.observe(float(acc[i]))
            p0, consumed, outcome = r.cursor, 0, None
            for j in range(int(emit[i])):
                consumed += 1
                # the accepted run is cut at its first eos_id
                outcome = self._emit(r, int(etoks[i, j]))
                if outcome is None and r.cursor + consumed >= self.max_len:
                    outcome = "max_new"
                if outcome is not None:
                    break
            if consumed:
                self._stamp(r, now, consumed)
            r.cursor += consumed
            # the draft's snapshots follow its own spine: resume from the
            # spine-consistent accepted prefix; a side-branch acceptance
            # leaves the draft short and catch-up replays the gap
            js = max(0, min(consumed - 1, int(sacc[i])))
            r.draft_cursor = p0 + js + 1
            r.draft_sel = js
            if outcome is not None:
                done.append((i, r, outcome))
        drafted = self._n["drafted_tokens"]
        self._m_spec_rate.set(self._n["accepted_tokens"] / drafted
                              if drafted else 0.0)
        for i, r, outcome in done:
            self._finish(i, r, outcome)

    # --------------------------------------------------------------- journal
    def _journal_terminal(self, r, outcome, kv_peak: int = 0):
        """Append the request's ONE terminal record (completions and
        rejections alike): host bookkeeping, no device work."""
        now = time.perf_counter()
        phases = {}
        if r.t_admit is not None:
            phases["queue"] = r.t_admit - r.t_start
            if r.t_first is not None:
                phases["prefill"] = r.t_first - r.t_admit
                phases["decode"] = (r.t_last or r.t_first) - r.t_first
        else:
            phases["queue"] = now - r.t_start
        if r.verify_s:
            phases["verify"] = r.verify_s
        rec = new_record(
            r.rid, "decode",
            trace_id=r.trace_id, outcome=outcome,
            tenant=r.tenant, priority=r.priority,
            engine=self.id, model_version=self._version,
            tokens_in=len(r.prompt), tokens_out=len(r.generated),
            wall_seconds=(r.t_last or now) - r.t_start,
            ttft_seconds=(r.t_first - r.t_start
                          if r.t_first is not None else None),
            first_prefill_chunk_seconds=(r.t_prefill0 - r.t_start
                                         if r.t_prefill0 is not None
                                         else None),
            phases=phases)
        if self._spec is not None:
            rec["spec"] = {"drafted": r.drafted, "accepted": r.accepted}
        if self._pool is not None:
            rec["kv"] = {"peak_blocks": kv_peak,
                         "prefix_hit_depth": r.prefix_hit,
                         "host_restores": r.host_restores}
        self.journal.append(rec)

    # ------------------------------------------------- KV rows on the host
    def _pool_leaf_items(self):
        """``[(key, leaf)]`` of the decode state's pool tensors, keyed by
        the JAX package's path strings (``jax.tree_util.keystr``:
        ``['b0_attn']['pk']``), the migration wire's leaf identity. The
        state is resident (never rebound), so the walk is made once."""
        if self._leaf_items is not None and \
                self._leaf_items[0] is self._dstate:
            return self._leaf_items[1]
        out = []

        def walk(t, path, keys):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}[{k!r}]", keys + (k,))
            elif isinstance(t, (list, tuple)):
                for i, v in enumerate(t):
                    walk(v, f"{path}[{i}]", keys + (i,))
            elif isinstance(t, torch.Tensor) and is_pool_path(keys):
                out.append((path, t))
        walk(self._dstate, "", ())
        self._leaf_items = (self._dstate, out)
        return out

    def _gather_rows(self, bids):
        """The given blocks of every pool leaf, read to the host in ONE
        copy (the leaves' bytes side by side): key -> ``(n, bs, H, Dh)``
        numpy array (bfloat16 as its uint16 words). On the programs'
        stream, so it reads after the replays that wrote them."""
        n = len(bids)
        idx = torch.as_tensor(list(bids), dtype=torch.long).to(self.device)
        items = self._pool_leaf_items()
        raw = torch.cat([leaf.index_select(0, idx).reshape(n, -1)
                         .view(torch.uint8) for _, leaf in items],
                        dim=1).cpu().numpy()
        out, ofs = {}, 0
        for key, leaf in items:
            dt = (np.dtype(np.uint16) if leaf.dtype == torch.bfloat16
                  else np.dtype(row_dtype(leaf)))
            width = leaf[0].numel() * dt.itemsize
            out[key] = raw[:, ofs:ofs + width].copy().view(dt).reshape(
                (n,) + tuple(leaf.shape[1:]))
            ofs += width
        return out

    def _flush_spills(self):
        """Read the rows of every block evicted since the last flush into
        the tier entries registered for them (one gather)."""
        if not self._pending_spills:
            return
        pend, self._pending_spills = self._pending_spills, []
        got = self._gather_rows([b for b, _ in pend])
        for j, (_, rows) in enumerate(pend):
            for key, row in rows.items():
                row[...] = got[key][j]

    @torch.no_grad()
    def _apply_host_rows(self, writes):
        """Write ``[(block, {leaf key: (bs, H, Dh) row})]`` into the pool
        leaves IN PLACE (the programs read them by address): one staged
        copy and one ``index_copy_`` a leaf. Rows still to be spilled are
        read first: a written block may be one just evicted."""
        self._flush_spills()
        if not writes:
            return
        idx = torch.as_tensor([b for b, _ in writes],
                              dtype=torch.long).to(self.device)
        for key, leaf in self._pool_leaf_items():
            rows = np.stack([r[key] for _, r in writes])
            t = (torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16)
                 if leaf.dtype == torch.bfloat16 else torch.from_numpy(rows))
            leaf.index_copy_(0, idx, t.to(self.device))

    def _land_restores(self):
        """Read the pending spills, then land every pending tier restore
        (loop thread, or no loop)."""
        pend, self._pending_restores = self._pending_restores, {}
        self._apply_host_rows(list(pend.items()))

    def _spill_block(self, chain_hash, parent, tokens, bid):
        """The prefix cache's eviction hook (loop thread, inside an
        allocation): demote the evicted block to the host tier. The entry
        is put now (the next match may restore it), its rows are read by
        ``_flush_spills`` before anything writes to the pool."""
        if self._pending_restores.pop(bid, None) is not None:
            # restored from the tier but never landed: the tier still
            # holds its content
            return
        rows = {key: np.empty(tuple(leaf.shape[1:]), np.uint16
                              if leaf.dtype == torch.bfloat16 else
                              np.dtype(row_dtype(leaf)))
                for key, leaf in self._pool_leaf_items()}
        self._host_tier.put(chain_hash, parent, tokens, rows)
        self._pending_spills.append((bid, rows))

    def _restore_block(self, chain_hash, tokens):
        """The prefix cache's second chance (loop thread, in a match):
        claim a fresh block for a tier hit and queue its rows for the next
        tick. Returns the block (refcount 1, the matching request's claim)
        or None when the pool cannot spare one (a plain miss)."""
        entry = self._host_tier.get(chain_hash)
        if entry is None:
            return None
        try:
            bid = self._pool.alloc(1)[0]
        except PoolExhaustedError:
            return None
        self._pending_restores[bid] = entry.rows
        self._inc("host_restores")
        return bid

    # ------------------------------------------------------------ migration
    def _drain_kv_ops_locked(self):
        """Run the queued export and import closures (the caller holds
        ``self._cv``; loop thread, between ticks)."""
        while self._kv_ops:
            fn, fut = self._kv_ops.popleft()
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn())
                except BaseException as e:  # noqa: BLE001 -- to the caller
                    fut.set_exception(e)

    def run_exclusive(self, fn, timeout: Optional[float] = 300.0):
        """``fn()`` on the loop thread between ticks, or inline when no
        loop runs: nothing of this engine runs CUDA work meanwhile (what a
        capture elsewhere needs; the server's ``/warmup``). Returns its
        result."""
        return self._run_kv_op(fn, timeout)

    def _run_kv_op(self, fn, timeout: Optional[float] = 60.0):
        """``fn()`` on the loop thread, or inline when no loop runs (the
        decode state made first); returns its result."""
        fut = Future()
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                self._kv_ops.append((fn, fut))
                self._cv.notify_all()
            else:
                self._ensure_state()
                if fut.set_running_or_notify_cancel():
                    try:
                        fut.set_result(fn())
                    except BaseException as e:  # noqa: BLE001
                        fut.set_exception(e)
        return fut.result(timeout=timeout)

    def _migrate_envelope(self) -> dict:
        """What a payload must match to land here: the serving weights'
        shapes and dtypes (``model_signature``, the JAX package's), the
        serving precision, the block size and the vocabulary."""
        if self._model_sig is None:
            self._model_sig = model_signature(
                self._params, getattr(self.model, "state", None) or {})
        return {"model_sig": self._model_sig,
                "precision": self.precision,
                "block_size": self.kv_block_size,
                "vocab": int(self.vocab)}

    def kv_export(self, prompt: Sequence[int]) -> dict:
        """The cached block chain covering ``prompt``'s full blocks as a
        migration payload (kv/migrate.py): the prefill engine's half of
        disaggregated serving. The chain must be published here already
        (its prefill ran to completion), else ``KVMigrateError(reason=
        'no_chain')``."""
        if self._prefix is None:
            raise ValueError(
                "kv_export requires kv='paged' with prefix_cache=True")
        toks = [int(t) for t in prompt]

        def op():
            self._land_restores()
            bs = self.kv_block_size
            bids, chain = [], []
            h = _ROOT
            for j in range(len(toks) // bs):
                blk = toks[j * bs:(j + 1) * bs]
                h = _chain_hash(h, blk)
                bid = self._prefix._by_hash.get(h)
                if bid is None:
                    break
                bids.append(bid)
                chain.extend(blk)
            if not bids:
                raise KVMigrateError(
                    "no cached chain covers this prompt's first block -- "
                    "run the prefill to completion here before exporting",
                    reason="no_chain")
            dtypes = {k: row_dtype(leaf)
                      for k, leaf in self._pool_leaf_items()}
            payload = pack_chain(self._gather_rows(bids), chain,
                                 self._migrate_envelope(), dtypes)
            self._inc("migrate_exports")
            return payload

        return self._run_kv_op(op)

    def kv_import(self, payload: dict) -> dict:
        """Restore a migrated chain into this engine's pool: the whole
        payload is validated against the local envelope first (a mismatch
        changes nothing), then fresh blocks are claimed, the rows written
        in place and the chain indexed in the prefix cache under the same
        hashes, so the continued decode is an ordinary prefix hit. The
        decode engine's half."""
        if self._prefix is None:
            raise ValueError(
                "kv_import requires kv='paged' with prefix_cache=True")

        def op():
            leaves = dict(self._pool_leaf_items())
            tokens, rows = unpack_chain(payload, self._migrate_envelope(),
                                        leaves)
            n = len(tokens) // self.kv_block_size
            try:
                bids = self._pool.alloc(n)
            except PoolExhaustedError as e:
                raise KVMigrateError(
                    f"destination pool cannot hold the chain: {e}",
                    reason="exhausted")
            self._apply_host_rows(
                [(bid, {k: rows[k][j] for k in rows})
                 for j, bid in enumerate(bids)])
            added = self._prefix.insert(tokens, bids)
            for b in bids:
                # indexed blocks park on the evictable LRU; a block whose
                # chain was already here goes straight back
                self._pool.decref(b)
            self._inc("migrate_imports")
            return {"imported_blocks": added,
                    "duplicate_blocks": n - added, "tokens": len(tokens)}

        try:
            return self._run_kv_op(op)
        except KVMigrateError as e:
            self._m_migrate_rejects.labels(
                engine=self.id, reason=e.reason).inc()
            raise

    # --------------------------------------------------------------- stats
    def _slo_stats(self) -> dict:
        """Percentiles of the request-lifecycle histograms and each
        bucket's last exemplar (a request id that resolves to its journal
        record)."""
        def block(h):
            out = {"count": int(h.count)}
            for q, key in ((0.5, "p50_ms"), (0.99, "p99_ms")):
                p = h.percentile(q)
                out[key] = round(p * 1e3, 4) if p is not None else None
            out["exemplars"] = [
                ["+Inf" if b == float("inf") else b, rid, v]
                for b, rid, v in h.exemplars()]
            return out
        return {"ttft": block(self._m_ttft),
                "itl": block(self._m_itl),
                "queue": block(self._m_queue)}

    def stats(self) -> dict:
        with self._cv:
            occupied = sum(r is not None for r in self._slot_reqs)
            queued = len(self._queue)
        kv = None
        if self._pool is not None:
            kv = dict(self.kv_pool_info(),
                      prefix_cache=self._prefix is not None,
                      chunk_tokens=self.chunk_tokens,
                      kv_programs=int(self._m_kv_programs.value))
            kv.update({k: int(self._n[k]) for k in _KV_COUNTERS})
            if self._host_tier is None:
                del kv["host_restores"]
            if self._prefix is not None:
                kv["chain_heads"] = self._prefix.chain_heads()
        spec = None
        if self._spec is not None:
            drafted = int(self._n["drafted_tokens"])
            accepted = int(self._n["accepted_tokens"])
            depth = self._m_spec_depth
            spec = {"k": self._spec_tree.d,
                    "tree": list(self._spec_tree.kvec),
                    "tree_nodes": self._spec_tree.n_nodes,
                    "self_draft": self._spec.self_draft,
                    "draft_precision": self._draft.precision,
                    "draft_weight_bytes": self._draft.weight_bytes,
                    "drafted_tokens": drafted,
                    "accepted_tokens": accepted,
                    "acceptance_rate": (accepted / drafted if drafted
                                        else 0.0),
                    "mean_accepted_depth": (depth.sum / depth.count
                                            if depth.count else 0.0),
                    "verify_programs": self._verifier.programs,
                    "draft_programs": self._draft.programs,
                    "verifies": self._verifier.calls,
                    "draft_calls": self._draft.calls,
                    "draft_steps": self._draft.steps}
        return {"id": self.id, "slots": self.slots, "max_len": self.max_len,
                "kv": kv, "spec": spec, "precision": self.precision,
                "weight_bytes": self._weights_set.nbytes,
                "model_version": self._version,
                "occupied_slots": occupied, "queued_requests": queued,
                "compiled_programs": self.trace_count,
                "steps": self._steps, "tokens": self._tokens,
                "requests": self._requests,
                "decode_seconds": self._decode_seconds,
                "tokens_per_second": (self._tokens / self._decode_seconds
                                      if self._decode_seconds else 0.0),
                "slo": self._slo_stats(),
                "journal": {"capacity": self.journal.capacity,
                            "records": len(self.journal),
                            "total": self.journal.total,
                            "dropped": self.journal.dropped},
                "warmup_seconds": self.warmup_seconds}


@torch.no_grad()
def generate_naive(model, prompt: Sequence[int], max_new_tokens: int,
                   max_len: int, seed: int = 0, temperature: float = 0.0,
                   top_k: int = 0) -> dict:
    """Baseline generator: re-runs the FULL prefix forward for every token
    (the model's own ``_forward``: the stacked-LSTM kernel, or the flash
    attention kernel) with the same sampling rule as DecodeEngine
    (``oracle_tokens``), so greedy outputs match the engine token for
    token. ``max_len`` bounds prompt plus new tokens, as in the JAX
    package."""
    toks = [int(t) for t in prompt]
    if len(toks) + max_new_tokens > max_len:
        raise ValueError("prompt + max_new_tokens exceeds max_len")
    vocab = input_type_of(model).size
    dev = model.device
    eye = torch.eye(vocab, dtype=torch.float32, device=dev)

    def one(v, dt):
        return torch.tensor([v], dtype=dt, device=dev)
    seed_t = one(int(seed) & 0xFFFFFFFF, torch.int64)
    temp_t = one(float(temperature), torch.float32)
    topk_t = one(int(top_k), torch.int64)
    out = []
    for _ in range(max_new_tokens):
        x = eye[torch.as_tensor(toks, device=dev)][None]
        probs, _ = model._forward(model.params, x)
        last = len(toks) - 1
        tok = int(oracle_tokens(torch.log(probs[0, last:last + 1].float()),
                                seed_t, one(last, torch.int64), temp_t,
                                topk_t)[0])
        out.append(tok)
        toks.append(tok)
    return {"tokens": out, "prompt_len": len(prompt)}
