"""Incremental decoding with slot-based continuous batching.

Counterpart of deeplearning4j_tpu/serving/decode.py, over a
MultiLayerNetwork or a ComputationGraph, with dense or paged KV caches
(the prefix cache, chunked prefill, speculation, AOT and hot swap are not
ported yet; asking for the first three raises ``NotImplementedError``).
Decode state -- each recurrent layer's (h, c) carry, each attention
layer's KV cache -- stays on the device in ONE batched state of S slots;
every step advances all active streams by one token at their positions,
new requests claim free slots between steps, and finished streams free
theirs.

- Per-slot carries are wiped inside the step when a slot is re-claimed
  (reset mask), so a slot never sees a previous request's carries, and
  inactive slots' carries are frozen by an active mask. KV caches are
  positional and written in place by the attention layers: no slot mask
  touches them (nn/layers/attention.py says why that is safe).
- ``kv="dense"``: each slot owns ``max_len`` cache rows. ``kv="paged"``:
  the attention layers keep one block pool (serving/kv/pool.py) and the
  engine keeps an (S, max_len / kv_block_size) int32 page table; a request
  claims the blocks its prompt and completion need on admission (the
  queue head waits while the pool is short) and frees them when it
  finishes.
- Sampling is a pure function of (distribution, request seed, position):
  see ``oracle_token``. Any arrival schedule gives the same text for the
  same seed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, ServerOverloadedError)
from deeplearning4j_tpu_torch.serving.engine import input_type_of
from deeplearning4j_tpu_torch.serving.kv import (BlockPool,
                                                 PoolExhaustedError,
                                                 blocks_for_span,
                                                 map_slot_leaves)

# decode-state keys the per-slot wipe and freeze skip (KV caches)
POSITIONAL_KEYS = MultiHeadAttention.positional_state_keys


def _stream_seed(seed: int, pos: int) -> int:
    """A 32-bit generator seed from (seed, pos): the CPU generator keeps
    only the low 32 bits of its seed, so the pair is mixed (splitmix64)
    before it is folded."""
    x = (((int(seed) & 0xFFFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return (x ^ (x >> 32)) & 0xFFFFFFFF


def oracle_token(logits: np.ndarray, seed: int, pos: int, temp: float,
                 top_k: int) -> int:
    """The engine's sampling rule for ONE distribution row
    (deeplearning4j_tpu/serving/spec/accept.py ``oracle_token``).

    ``logits``: (V,) log-probabilities. Top-k filter, then the argmax when
    ``temp == 0``; otherwise a Gumbel-max draw from ``logits / temp`` with
    noise from a ``torch.Generator`` seeded by (seed, pos). The JAX package
    draws from ``jax.random``, whose bits this package cannot reproduce:
    greedy tokens agree between the packages, sampled ones only in
    distribution."""
    V = logits.shape[-1]
    k = V if top_k <= 0 else min(max(int(top_k), 1), V)
    thr = np.sort(logits)[::-1][k - 1]
    filt = np.where(logits >= thr, logits, -np.inf)
    if temp <= 0:
        return int(np.argmax(filt))
    gen = torch.Generator().manual_seed(_stream_seed(seed, pos))
    u = torch.rand(V, generator=gen, dtype=torch.float64).numpy()
    gumbel = -np.log(-np.log(np.clip(u, 1e-300, 1.0 - 1e-16)))
    return int(np.argmax(filt / float(temp) + gumbel))


class _Request:
    """Host-side bookkeeping for one occupied slot."""

    __slots__ = ("prompt", "max_new", "seed", "temperature", "top_k",
                 "cursor", "generated", "future", "fresh", "kv_blocks",
                 "t_start", "t_first", "t_last")

    def __init__(self, prompt, max_new, seed, temperature, top_k, future):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.seed = int(seed)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.cursor = 0          # next input position to feed
        self.generated: List[int] = []
        self.future = future
        self.fresh = True        # first step must wipe the slot's state
        self.kv_blocks: List[int] = []   # paged engines: claimed blocks
        self.t_start = time.perf_counter()
        self.t_first = None
        self.t_last = None


class DecodeEngine:
    """Continuous-batching autoregressive decoder over a model (a
    MultiLayerNetwork or a single-input ComputationGraph) whose output
    layer emits per-token probabilities. Inputs are token ids; the engine
    one-hots them to the model's input width.

        eng = DecodeEngine(net, slots=8, max_len=256, kv="paged").start()
        toks = eng.generate([3, 1, 4], max_new_tokens=32)["tokens"]

    ``max_len``: positions per stream (prompt + generated). ``kv``:
    ``"dense"`` or ``"paged"``; a paged engine takes ``kv_block_size``
    (positions per block, dividing ``max_len``) and ``kv_blocks`` (pool
    size; the default, ``slots * max_len / kv_block_size + 1``, holds every
    slot at full length beside the scratch block).
    """

    def __init__(self, model, slots: int = 8, max_len: int = 256,
                 max_queue: int = 256, kv: str = "dense",
                 kv_block_size: int = 16, kv_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 chunk_tokens: Optional[int] = None, spec=None):
        for name, asked in (("prefix_cache", prefix_cache),
                            ("chunk_tokens", chunk_tokens is not None),
                            ("spec", spec is not None)):
            if asked:
                raise NotImplementedError(
                    f"DecodeEngine({name}=...) is not ported to the PyTorch "
                    "package yet")
        if kv not in ("dense", "paged"):
            raise ValueError(f"kv must be 'dense' or 'paged', got {kv!r}")
        self.model = model
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.max_queue = int(max_queue)
        self.vocab = input_type_of(model).size
        self.kv_block_size = int(kv_block_size)
        self._pool: Optional[BlockPool] = None
        self._tables: Optional[np.ndarray] = None
        if kv == "paged":
            if self.max_len % self.kv_block_size != 0:
                raise ValueError(
                    f"max_len ({max_len}) must be a multiple of "
                    f"kv_block_size ({kv_block_size})")
            max_blocks = self.max_len // self.kv_block_size
            if kv_blocks is None:
                kv_blocks = self.slots * max_blocks + 1
            self._pool = BlockPool(int(kv_blocks), self.kv_block_size)
            self._tables = np.zeros((self.slots, max_blocks), np.int32)
        self._dstate = None
        self._slot_reqs: List[Optional[_Request]] = [None] * self.slots
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._steps = 0
        self._tokens = 0
        self._requests = 0
        self._decode_seconds = 0.0

    # ------------------------------------------------------------- the step
    @torch.no_grad()
    def _step(self, tokens, pos, reset, active, seeds, temps, topk):
        """ONE iteration for all S slots; scheduling rides in as masks."""
        dev = self.model.device
        reset_t = torch.as_tensor(reset, device=dev)
        active_t = torch.as_tensor(active, device=dev)

        def where(mask, a, b):
            return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)),
                               a, b)

        dstate = map_slot_leaves(
            lambda a: where(reset_t, torch.zeros_like(a), a), self._dstate,
            keys=POSITIONAL_KEYS)
        x = torch.nn.functional.one_hot(
            torch.as_tensor(tokens, dtype=torch.long, device=dev),
            self.vocab).to(torch.float32)[:, None, :]
        pos_t = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        if self._pool is None:
            y, new_d = self.model.decode_step(self.model.params, dstate, x,
                                              pos_t)
        else:
            # inactive slots get an all-zero table row: their write lands in
            # the scratch block
            btab = np.where(active[:, None], self._tables, 0)
            y, new_d = self.model.decode_step(
                self.model.params, dstate, x, pos_t,
                block_tables=torch.as_tensor(btab, device=dev))
        self._dstate = map_slot_leaves(
            lambda n, o: where(active_t, n, o), new_d, dstate,
            keys=POSITIONAL_KEYS)
        logits = torch.log(y[:, 0, :].float()).cpu().numpy()
        return np.array([oracle_token(logits[i], seeds[i], pos[i], temps[i],
                                      topk[i]) if active[i] else 0
                         for i in range(self.slots)], np.int64)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "DecodeEngine":
        if self._dstate is None:
            kv = (None if self._pool is None else
                  {"num_blocks": self._pool.num_blocks,
                   "block_size": self.kv_block_size})
            self._dstate = self.model.init_decode_state(self.slots,
                                                        self.max_len, kv=kv)
        if self._thread is None or not self._thread.is_alive():
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
            pending = list(self._queue)
            for i, r in enumerate(self._slot_reqs):
                if r is not None:
                    self._release_kv(i, r)
                    pending.append(r)
            self._queue.clear()
            self._slot_reqs = [None] * self.slots
        for r in pending:
            if not r.future.done():
                r.future.set_exception(err)

    @property
    def saturated(self) -> bool:
        """All S slots busy: a new request would queue behind them."""
        with self._cv:
            return all(r is not None for r in self._slot_reqs)

    # ------------------------------------------------------------ scheduler
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               seed: int = 0, temperature: float = 0.0,
               top_k: int = 0) -> Future:
        """Enqueue one generation request; returns a Future resolving to
        ``{"tokens": [...], "prompt_len": int}``."""
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
        req = _Request(prompt, max_new_tokens, seed, temperature, top_k, fut)
        with self._cv:
            if len(self._queue) >= self.max_queue:
                raise ServerOverloadedError(
                    f"decode queue full ({self.max_queue})")
            self._queue.append(req)
            self._cv.notify_all()
        return fut

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 32,
                 seed: int = 0, temperature: float = 0.0, top_k: int = 0,
                 timeout: Optional[float] = None) -> dict:
        """Blocking ``submit`` -- the call the HTTP endpoint makes."""
        return self.submit(prompt, max_new_tokens, seed, temperature,
                           top_k).result(timeout=timeout)

    def _admit_locked(self):
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
                    break
            self._slot_reqs[i] = self._queue.popleft()

    def _claim_kv(self, r, slot):
        """Claim the pool blocks for positions 0 .. prompt + max_new - 2
        (the last sampled token is returned, never fed back) and write the
        slot's page-table row. All or nothing."""
        need = blocks_for_span(len(r.prompt) + r.max_new - 1,
                               self.kv_block_size)
        r.kv_blocks = self._pool.alloc(need)
        row = self._tables[slot]
        row[:] = 0
        row[:need] = r.kv_blocks

    def _release_kv(self, slot, r):
        """Return a request's blocks to the pool and clear its table row."""
        if self._pool is None or not r.kv_blocks:
            return
        for b in r.kv_blocks:
            self._pool.decref(b)
        r.kv_blocks = []
        self._tables[slot][:] = 0

    def _free_slot(self, slot, r):
        with self._cv:
            self._release_kv(slot, r)
            self._slot_reqs[slot] = None

    def _loop(self):
        S = self.slots
        while not self._stop.is_set():
            with self._cv:
                self._admit_locked()
                live = [(i, r) for i, r in enumerate(self._slot_reqs)
                        if r is not None]
                if not live:
                    self._cv.wait(timeout=0.05)
                    continue
            tokens = np.zeros(S, np.int64)
            pos = np.zeros(S, np.int64)
            reset = np.zeros(S, bool)
            active = np.zeros(S, bool)
            seeds = np.zeros(S, np.int64)
            temps = np.zeros(S, np.float32)
            topk = np.zeros(S, np.int64)
            for i, r in live:
                active[i] = True
                reset[i] = r.fresh
                r.fresh = False
                p = r.cursor
                tokens[i] = (r.prompt[p] if p < len(r.prompt)
                             else r.generated[-1])
                pos[i] = p
                seeds[i] = r.seed & 0xFFFFFFFF
                temps[i] = r.temperature
                topk[i] = r.top_k
            t0 = time.perf_counter()
            try:
                nt = self._step(tokens, pos, reset, active, seeds, temps,
                                topk)
            except Exception as e:  # noqa: BLE001 -- fail the live requests
                for i, r in live:
                    self._free_slot(i, r)
                for _, r in live:
                    r.future.set_exception(e)
                continue
            now = time.perf_counter()
            self._decode_seconds += now - t0
            self._steps += 1
            for i, r in live:
                r.cursor += 1
                if r.cursor < len(r.prompt):
                    continue                     # still prefilling
                tok = int(nt[i])
                r.generated.append(tok)
                self._tokens += 1
                if r.t_first is None:
                    r.t_first = now
                r.t_last = now
                if len(r.generated) >= r.max_new:
                    self._free_slot(i, r)
                    self._requests += 1
                    r.future.set_result({"tokens": r.generated,
                                         "prompt_len": len(r.prompt)})

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._cv:
            occupied = sum(r is not None for r in self._slot_reqs)
            queued = len(self._queue)
        kv = None
        if self._pool is not None:
            kv = {"block_size": self.kv_block_size,
                  "blocks": self._pool.usable,
                  "blocks_free": self._pool.free_count,
                  "blocks_in_use": self._pool.in_use,
                  "high_water": self._pool.high_water}
        return {"slots": self.slots, "max_len": self.max_len, "kv": kv,
                "occupied_slots": occupied, "queued_requests": queued,
                "steps": self._steps, "tokens": self._tokens,
                "requests": self._requests,
                "decode_seconds": self._decode_seconds,
                "tokens_per_second": (self._tokens / self._decode_seconds
                                      if self._decode_seconds else 0.0)}


@torch.no_grad()
def generate_naive(model, prompt: Sequence[int], max_new_tokens: int,
                   seed: int = 0, temperature: float = 0.0,
                   top_k: int = 0) -> dict:
    """Baseline generator: re-runs the FULL prefix forward for every token
    (the model's own ``_forward``: the stacked-LSTM kernel, or the flash
    attention kernel) with the same sampling rule as DecodeEngine, so
    greedy outputs match the engine token for token."""
    vocab = input_type_of(model).size
    toks = [int(t) for t in prompt]
    eye = torch.eye(vocab, dtype=torch.float32, device=model.device)
    out = []
    for _ in range(max_new_tokens):
        x = eye[torch.as_tensor(toks, device=model.device)][None]
        probs, _ = model._forward(model.params, x)
        last = len(toks) - 1
        logits = torch.log(probs[0, last].float()).cpu().numpy()
        tok = oracle_token(logits, seed, last, temperature, top_k)
        out.append(tok)
        toks.append(tok)
    return {"tokens": out, "prompt_len": len(prompt)}
