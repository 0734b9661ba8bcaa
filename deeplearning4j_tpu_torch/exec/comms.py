"""Peer-to-peer gradient data plane for the elastic cluster.

Counterpart of deeplearning4j_tpu/exec/comms.py, line for line, with the
same wire bytes. Everything here is host numpy: the gradient vector
reaches it already read back from the card, and no thread of this module
touches the card.

A star allreduce moves every step's FULL f32 gradient through the
coordinator -- each worker uploads D*4 bytes over HTTP, blocks at the
barrier, downloads D*4 bytes; coordinator bandwidth is 2*N*D*4 per step,
fully serialized with compute. This module demotes the coordinator to
CONTROL PLANE ONLY (membership, generations, fencing) and carries
gradient bytes over persistent peer-to-peer loopback TCP sockets instead:

- **Chunk-pipelined rank-ordered chain.** The flat ``loss||grads`` vector
  splits into fixed-size buckets (``bucket_mb``). Reduce messages flow
  rank 0 -> 1 -> ... -> N-1, each hop adding its OWN bucket to the
  arriving partial sum; rank N-1 divides by the accumulated row count and
  broadcast messages flow back N-1 -> ... -> 0. Because every element
  still accumulates in exact rank order -- the same float association as
  the star coordinator's sorted-rank loop -- the dense path is
  BITWISE-equal to the star allreduce and to the single-process reference
  replay (``exec.worker.single_process_reference``). The reduce and
  broadcast loops run on separate threads per member over full-duplex
  sockets, so bucket j+1 is on the wire while bucket j reduces and bucket
  j-1's mean already flows back.
- **Opt-in threshold wire codec** (``codec="threshold"``). Each worker
  compresses its OWN contribution once per step with the Strom-2015
  scheme shared with ``parallel.compression.EncodingHandler``
  (sign*threshold messages, error-feedback residual carry, adaptive
  threshold via ``parallel.compression.adapt_threshold``); the chain then
  transports the EXACT sparse partial sums -- per bucket, an int32-index
  + f32-value payload when that beats dense, dense fallback otherwise.
  The head bucket (loss) is always exact. Residuals are per worker and
  RESET on any generation change (``ThresholdCodec.reset``) so a stale
  pre-eviction residual can never leak into the new membership.
- **Elastic by construction.** Sockets are per-generation: every frame
  carries the generation, a stale or torn wire raises ``CommsError``, the
  worker parks for the coordinator's reform verdict and ``configure()``
  rebuilds the chain over the survivors' endpoints from the committed
  membership view.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ChainComms", "ThresholdCodec", "CommsError",
           "CommsAbortedError", "bucketize", "DEFAULT_BUCKET_MB"]

DEFAULT_BUCKET_MB = 4.0

_MAGIC = 0xD14C
_HELLO, _REDUCE, _BCAST = 1, 2, 3
_DENSE, _SPARSE = 0, 1
# magic u16 | kind u8 | wire u8 | generation i32 | step i32 | bucket i32 |
# rows i64 | payload nbytes u32  (little-endian, 24 bytes)
_HDR = struct.Struct("<HBBiiiqI")

# sockets poll at this granularity so ``should_abort`` (the worker's
# rollback/evicted lease state) interrupts a peer wait promptly
_POLL_S = 0.25


class CommsError(Exception):
    """The peer-to-peer data plane failed: a peer died mid-exchange, a
    socket tore, or a stale generation arrived on the wire. The member
    must wait for the coordinator's reform verdict and rebuild the chain
    (``ElasticWorker._await_reform``)."""


class CommsAbortedError(CommsError):
    """``should_abort()`` fired while blocked on a peer — the lease layer
    already knows about the membership change; stop waiting and resync."""


def bucketize(n: int, bucket_mb: float = DEFAULT_BUCKET_MB,
              head: int = 1) -> List[Tuple[int, int]]:
    """Split an ``n``-element f32 vector into ``[start, stop)`` buckets:
    one ``head``-element bucket (the loss — always dense and exact on the
    wire) followed by fixed-size body buckets of ``bucket_mb`` MB. A model
    smaller than one bucket gets a single ragged body bucket; the last
    body bucket is ragged whenever the body size doesn't divide."""
    if n < head:
        raise ValueError(f"vector of {n} elements cannot carry a "
                         f"{head}-element head bucket")
    per = max(1, int(float(bucket_mb) * 1024 * 1024) // 4)
    out = [(0, head)] if head else []
    for start in range(head, n, per):
        out.append((start, min(n, start + per)))
    return out


# --------------------------------------------------------------------------
# exact per-bucket wire encoding (sparse when it wins, dense fallback)
# --------------------------------------------------------------------------

def encode_bucket(vals: np.ndarray) -> Tuple[int, bytes]:
    """EXACT encoding of one bucket: sparse ``int32 idx ‖ f32 vals`` when
    8·nnz < 4·n, dense f32 bytes otherwise. Lossless either way — the
    lossy part of the threshold codec happens once per worker in
    ``ThresholdCodec.encode``; partial sums stay exact at every hop."""
    vals = np.ascontiguousarray(vals, np.float32)
    nz = np.flatnonzero(vals)
    if nz.size * 8 < vals.size * 4:
        return _SPARSE, (nz.astype(np.int32).tobytes()
                         + vals[nz].tobytes())
    return _DENSE, vals.tobytes()


def decode_bucket(wire: int, payload: bytes, n: int) -> np.ndarray:
    if wire == _DENSE:
        vals = np.frombuffer(payload, np.float32)
        if vals.size != n:
            raise CommsError(f"dense bucket size {vals.size} != {n}")
        return vals
    if len(payload) % 8:
        raise CommsError(f"sparse bucket payload {len(payload)}B not 8-aligned")
    k = len(payload) // 8
    idx = np.frombuffer(payload[:k * 4], np.int32)
    vals = np.frombuffer(payload[k * 4:], np.float32)
    if k and (idx.min() < 0 or idx.max() >= n):
        raise CommsError(f"sparse bucket index out of range for n={n}")
    out = np.zeros(n, np.float32)
    out[idx] = vals
    return out


# --------------------------------------------------------------------------
# threshold codec (worker-local lossy compression with residual carry)
# --------------------------------------------------------------------------

class ThresholdCodec:
    """Strom-2015 threshold compression for one worker's OWN contribution
    — the same semantics as ``parallel.compression.EncodingHandler``
    (residual error-feedback carry, sign·threshold messages, adaptive
    threshold via the shared ``adapt_threshold`` policy), in host numpy so
    the data plane never touches the device. ``encode`` returns a DENSE
    f32 message vector; the wire layer sparsifies it per bucket
    (``encode_bucket``). Bitwise-parity with EncodingHandler's decoded
    message / residual / threshold trajectory is pinned by
    tests/test_torch_comms.py."""

    def __init__(self, n: int, threshold: float = 1e-3,
                 min_threshold: float = 1e-5, threshold_step: float = 1e-5,
                 capacity_fraction: float = 0.1):
        self.n = int(n)
        self.initial_threshold = float(threshold)
        self.threshold = float(threshold)
        self.min_threshold = float(min_threshold)
        self.threshold_step = float(threshold_step)
        self.capacity_fraction = float(capacity_fraction)
        self.residual = np.zeros(self.n, np.float32)
        self.resets = 0
        self.last_count = 0

    @property
    def capacity(self) -> int:
        return max(1, min(self.n, int(self.n * self.capacity_fraction)))

    def encode(self, vec: np.ndarray) -> np.ndarray:
        from deeplearning4j_tpu_torch.parallel.compression import \
            adapt_threshold
        u = np.asarray(vec, np.float32) + self.residual
        cap = self.capacity
        thr = np.float32(self.threshold)
        mag = np.abs(u)
        sel = np.flatnonzero(mag >= thr)
        if sel.size > cap:
            # keep the ``cap`` largest magnitudes — the fixed-capacity
            # top-k the jit encoder uses (ties broken by magnitude order,
            # irrelevant on continuous gradients)
            sel = sel[np.argsort(mag[sel], kind="stable")[::-1][:cap]]
        msg = np.zeros(self.n, np.float32)
        msg[sel] = np.sign(u[sel]) * thr
        self.residual = u - msg
        self.last_count = int(sel.size)
        self.threshold = adapt_threshold(
            self.threshold, self.last_count, cap,
            step=self.threshold_step, min_threshold=self.min_threshold)
        return msg

    def reset(self) -> None:
        """Generation change: drop the error-feedback residual and restart
        the threshold walk. A residual accumulated under the dead
        membership encodes gradients of a trajectory the new generation
        rolled back — letting it leak would silently skew the first
        post-reform steps (fencing)."""
        self.residual[:] = 0.0
        self.threshold = self.initial_threshold
        self.resets += 1
        _metrics().resets.inc()


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

class _Metrics:
    def __init__(self):
        from deeplearning4j_tpu_torch.monitor import get_registry
        reg = get_registry()
        self.bytes = reg.counter(
            "dl4jtpu_cluster_comm_bytes_total",
            "Gradient data-plane bytes on the wire (headers + payload), by "
            "direction and configured codec; the star fallback counts its "
            "HTTP gradient payloads here too.", ("direction", "codec"))
        self.ratio = reg.gauge(
            "dl4jtpu_cluster_compression_ratio",
            "Dense-equivalent payload bytes / actual payload bytes for the "
            "last allreduce through this member (1.0 on the dense codec).")
        self.bucket = reg.histogram(
            "dl4jtpu_cluster_bucket_seconds",
            "Wall seconds one bucket spent at this member's reduce hop "
            "(receive partial + add own + forward).",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.02, 0.1, 0.5, 2.0))
        self.resets = reg.counter(
            "dl4jtpu_cluster_residual_resets_total",
            "Threshold-codec error-feedback residuals cleared on a "
            "generation change (stale-residual fencing at reform).")


_METRICS: Optional[_Metrics] = None
_METRICS_LOCK = threading.Lock()


def _metrics() -> _Metrics:
    global _METRICS
    if _METRICS is None:
        with _METRICS_LOCK:
            if _METRICS is None:
                _METRICS = _Metrics()
    return _METRICS


def record_star_bytes(sent: int, recv: int) -> None:
    """The star (coordinator HTTP) fallback reports its gradient payload
    bytes under the same metric family so dashboards compare planes."""
    m = _metrics()
    m.bytes.labels(direction="sent", codec="dense").inc(int(sent))
    m.bytes.labels(direction="recv", codec="dense").inc(int(recv))
    m.ratio.set(1.0)


# --------------------------------------------------------------------------
# chain transport
# --------------------------------------------------------------------------

class ChainComms:
    """One member's half of the chunk-pipelined rank-ordered chain.

    Lifecycle: construct once per worker process (opens the data-plane
    listener whose port rides the ``join`` RPC), ``configure()`` on every
    committed generation (tears down the old sockets, dials rank+1, awaits
    rank-1), ``allreduce()`` once per step. Sockets are PER-GENERATION:
    every frame carries the generation and any mismatch — or a torn/closed
    socket, i.e. a SIGKILLed peer — raises ``CommsError``; the worker then
    waits for the coordinator's reform and reconfigures over the
    survivors. ``close()`` on exit."""

    def __init__(self, codec: str = "dense",
                 bucket_mb: float = DEFAULT_BUCKET_MB,
                 codec_opts: Optional[dict] = None,
                 io_timeout: float = 120.0):
        self.codec = codec
        self.bucket_mb = float(bucket_mb)
        self.codec_opts = dict(codec_opts or {})
        self.io_timeout = float(io_timeout)
        self.codec_state: Optional[ThresholdCodec] = None

        self.generation = 0
        self.rank = 0
        self.world = 1
        self._prev: Optional[socket.socket] = None   # from rank-1
        self._next: Optional[socket.socket] = None   # to rank+1
        self._closed = False
        self._byte_lock = threading.Lock()   # reduce + bcast threads both count
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.last: dict = {}        # per-allreduce stats for bench/tools

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self.data_port = self._listener.getsockname()[1]
        self._pcond = threading.Condition()
        self._pending: Dict[Tuple[int, int], socket.socket] = {}
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="comms-accept", daemon=True)
        self._accept_thread.start()

    def set_policy(self, codec: str, bucket_mb: float,
                   codec_opts: Optional[dict] = None) -> None:
        """Adopt the job's codec config (known only after ``join`` returns
        the coordinator's config — the listener must exist before that)."""
        self.codec = codec
        self.bucket_mb = float(bucket_mb)
        if codec_opts:
            self.codec_opts = dict(codec_opts)

    # -- listener ----------------------------------------------------------
    def _accept_loop(self):
        while not self._closed:
            try:
                s, _ = self._listener.accept()
            except OSError:
                return
            try:
                s.settimeout(self.io_timeout)
                hdr = self._read_exact(s, _HDR.size)
                magic, kind, _, gen, rank, _, _, _ = _HDR.unpack(hdr)
                if magic != _MAGIC or kind != _HELLO:
                    s.close()
                    continue
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(_POLL_S)
            except Exception:   # noqa: BLE001 — a garbage dial, drop it
                s.close()
                continue
            with self._pcond:
                old = self._pending.pop((gen, rank), None)
                if old is not None:
                    old.close()
                self._pending[(gen, rank)] = s
                self._pcond.notify_all()

    @staticmethod
    def _read_exact(s: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise CommsError("peer closed during handshake")
            buf += chunk
        return bytes(buf)

    # -- (re)configuration -------------------------------------------------
    def configure(self, generation: int, rank: int, world: int,
                  endpoints: Dict[int, Tuple[str, int]], *,
                  should_abort: Optional[Callable[[], bool]] = None,
                  timeout: float = 60.0) -> None:
        """Rebuild the chain for a committed generation: close the old
        generation's sockets, dial rank+1's listener, await rank-1's dial.
        ``endpoints`` is the committed membership view's rank → (host,
        port) map. Raises CommsError if the peers never materialize —
        usually a peer died between commit and formation, which the lease
        detector will turn into another reform."""
        self._teardown_peers()
        if int(generation) != self.generation:
            # stale-residual fencing: error feedback accumulated under the
            # dead membership must not leak into the new one
            self.reset_codec()
        self.generation = int(generation)
        self.rank = int(rank)
        self.world = int(world)
        if self.world <= 1:
            return
        deadline = time.monotonic() + timeout
        if self.rank < self.world - 1:
            host, port = endpoints[self.rank + 1]
            self._next = self._dial(host, int(port), deadline, should_abort)
        if self.rank > 0:
            self._prev = self._await_accept(self.generation, self.rank - 1,
                                            deadline, should_abort)
        with self._pcond:     # drop sockets stranded by dead generations
            for key in [k for k in self._pending if k[0] < self.generation]:
                self._pending.pop(key).close()

    def _dial(self, host: str, port: int, deadline: float,
              should_abort) -> socket.socket:
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            if should_abort is not None and should_abort():
                raise CommsAbortedError("aborted dialing next rank")
            try:
                s = socket.create_connection((host, port), timeout=_POLL_S)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(_POLL_S)
                s.sendall(_HDR.pack(_MAGIC, _HELLO, 0, self.generation,
                                    self.rank, 0, 0, 0))
                return s
            except OSError as e:    # listener not up yet / race: retry
                last = e
                time.sleep(0.02)
        raise CommsError(f"could not reach rank {self.rank + 1} at "
                         f"{host}:{port} for generation {self.generation}: "
                         f"{last!r}")

    def _await_accept(self, gen: int, rank: int, deadline: float,
                      should_abort) -> socket.socket:
        with self._pcond:
            while True:
                s = self._pending.pop((gen, rank), None)
                if s is not None:
                    return s
                if should_abort is not None and should_abort():
                    raise CommsAbortedError("aborted awaiting prev rank")
                if time.monotonic() >= deadline:
                    raise CommsError(
                        f"rank {rank} never dialed in for generation {gen}")
                self._pcond.wait(timeout=_POLL_S)

    def _teardown_peers(self):
        for s in (self._prev, self._next):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._prev = self._next = None

    def close(self):
        self._closed = True
        self._teardown_peers()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._pcond:
            for s in self._pending.values():
                s.close()
            self._pending.clear()

    def reset_codec(self) -> None:
        if self.codec_state is not None:
            self.codec_state.reset()

    # -- framed I/O --------------------------------------------------------
    def _send(self, sock: socket.socket, kind: int, wire: int, step: int,
              bucket: int, rows: int, payload, should_abort=None) -> None:
        # Sockets run with a short poll timeout so a peer stuck in compute
        # (or dead) can't wedge us: loop the syscall by hand — sendall()
        # leaves the stream in an unknown state after a partial-write
        # timeout. sendmsg gathers header + payload without concatenating
        # them (a bucket-sized copy per hop at dense widths).
        nbytes = memoryview(payload).nbytes
        pending = [memoryview(_HDR.pack(_MAGIC, kind, wire, self.generation,
                                        step, bucket, rows, nbytes)).cast("B"),
                   memoryview(payload).cast("B")]
        deadline = time.monotonic() + self.io_timeout
        while pending:
            if should_abort is not None and should_abort():
                raise CommsAbortedError("aborted while sending to peer")
            if time.monotonic() >= deadline:
                raise CommsError(f"peer send timed out ({self.io_timeout}s)")
            try:
                done = sock.sendmsg(pending)
            except socket.timeout:
                continue
            except OSError as e:
                raise CommsError(f"send to peer failed: {e!r}") from None
            while done:
                if done >= len(pending[0]):
                    done -= len(pending[0])
                    pending.pop(0)
                else:
                    pending[0] = pending[0][done:]
                    done = 0
            pending = [v for v in pending if len(v)]
        n = _HDR.size + nbytes
        with self._byte_lock:
            self.bytes_sent += n
        _metrics().bytes.labels(direction="sent", codec=self.codec).inc(n)

    def _recv_exact(self, sock: socket.socket, n: int,
                    should_abort) -> bytearray:
        # recv_into a preallocated buffer: no chunk-list growth, no final
        # bytes() copy — callers treat the returned bytearray as frozen
        buf = bytearray(n)
        view, got = memoryview(buf), 0
        deadline = time.monotonic() + self.io_timeout
        while got < n:
            if should_abort is not None and should_abort():
                raise CommsAbortedError("aborted waiting on peer bytes")
            if time.monotonic() >= deadline:
                raise CommsError(f"peer read timed out ({self.io_timeout}s)")
            try:
                k = sock.recv_into(view[got:], min(1 << 20, n - got))
            except socket.timeout:
                continue
            except OSError as e:
                raise CommsError(f"recv from peer failed: {e!r}") from None
            if not k:
                raise CommsError("peer closed mid-message (died or reformed)")
            got += k
        return buf

    def _recv_msg(self, sock: socket.socket, kind: int, step: int,
                  bucket: int, should_abort):
        hdr = self._recv_exact(sock, _HDR.size, should_abort)
        magic, k, wire, gen, s, b, rows, nbytes = _HDR.unpack(hdr)
        if magic != _MAGIC or k != kind:
            raise CommsError(f"bad frame magic={magic:#x} kind={k}")
        if gen != self.generation:
            raise CommsError(f"wire generation {gen} != committed "
                             f"{self.generation} (reform in flight)")
        if s != step or b != bucket:
            raise CommsError(f"out-of-order frame step={s} bucket={b} "
                             f"(want step={step} bucket={bucket})")
        payload = self._recv_exact(sock, nbytes, should_abort)
        n = _HDR.size + nbytes
        with self._byte_lock:
            self.bytes_recv += n
        _metrics().bytes.labels(direction="recv", codec=self.codec).inc(n)
        return wire, rows, payload

    # -- the allreduce -----------------------------------------------------
    def allreduce(self, step: int, vec: np.ndarray, rows: int, *,
                  should_abort: Optional[Callable[[], bool]] = None
                  ) -> np.ndarray:
        """Mean-reduce ``vec`` (already pre-scaled by ``rows``) across the
        chain; every rank returns byte-identical output. Row counts
        accumulate through frame headers and rank N-1 performs the single
        ``total / float32(rows_sum)`` division — exactly the star
        coordinator's arithmetic, which is what keeps the dense path
        bitwise-equal to the star and to the single-process reference."""
        t0 = time.perf_counter()
        vec = np.ascontiguousarray(vec, np.float32)
        n = vec.shape[0]
        own = vec
        if self.codec == "threshold" and n > 1:
            if self.codec_state is None or self.codec_state.n != n - 1:
                self.codec_state = ThresholdCodec(n - 1, **self.codec_opts)
            # lossy once, on this worker's own contribution; the head
            # element (loss·rows) stays exact
            own = np.concatenate([vec[:1], self.codec_state.encode(vec[1:])])
        if self.world <= 1:
            out = own / np.float32(rows)
            self._stats(t0, 1, 0, 0, 0, 0)
            return out

        buckets = bucketize(n, self.bucket_mb)
        sparse_wire = self.codec == "threshold"
        mean_q: "queue.Queue" = queue.Queue()
        mean_parts: List[Optional[np.ndarray]] = [None] * len(buckets)
        errors: List[BaseException] = []
        # separate dict keys per thread: reduce and bcast account payload
        # bytes concurrently
        acct = {"r_pay": 0, "r_dense": 0, "b_pay": 0, "b_dense": 0}
        sent0, recv0 = self.bytes_sent, self.bytes_recv

        def abort() -> bool:
            return bool(errors) or (should_abort is not None
                                    and should_abort())

        def out_frame(vals: np.ndarray, side: str):
            if sparse_wire:
                wire, payload = encode_bucket(vals)
            else:
                # zero-copy wire view of the reduced bucket (the array
                # outlives the send: mean_parts / acc hold it)
                wire, payload = _DENSE, memoryview(
                    np.ascontiguousarray(vals, np.float32)).cast("B")
            acct[side + "_pay"] += len(payload)
            acct[side + "_dense"] += vals.size * 4
            return wire, payload

        def reduce_loop():
            for j, (a, b) in enumerate(buckets):
                tb = time.perf_counter()
                mine = own[a:b]
                if self.rank == 0:
                    acc, racc = mine, int(rows)
                else:
                    wire, rin, payload = self._recv_msg(
                        self._prev, _REDUCE, step, j, abort)
                    partial = decode_bucket(wire, payload, b - a)
                    acc = partial + mine        # ranks 0..r-1, then r: exact
                    racc = int(rin) + int(rows)  # rank-order association
                if self.rank < self.world - 1:
                    wire, payload = out_frame(acc, "r")
                    self._send(self._next, _REDUCE, wire, step, j, racc,
                               payload, abort)
                else:
                    mean_q.put((j, acc / np.float32(racc)))
                _metrics().bucket.observe(time.perf_counter() - tb)

        def bcast_loop():
            if self.rank == self.world - 1:
                for _ in buckets:
                    item = None
                    while item is None:
                        if abort():
                            raise CommsAbortedError("aborted at bcast head")
                        try:
                            item = mean_q.get(timeout=_POLL_S)
                        except queue.Empty:
                            continue
                    j, mean = item
                    wire, payload = out_frame(mean, "b")
                    self._send(self._prev, _BCAST, wire, step, j, 0, payload,
                               abort)
                    mean_parts[j] = mean
            else:
                for j, (a, b) in enumerate(buckets):
                    wire, _, payload = self._recv_msg(
                        self._next, _BCAST, step, j, abort)
                    if self.rank > 0:
                        self._send(self._prev, _BCAST, wire, step, j, 0,
                                   payload, abort)
                        acct["b_pay"] += len(payload)
                        acct["b_dense"] += (b - a) * 4
                    mean_parts[j] = decode_bucket(wire, payload, b - a)

        def guarded(fn):
            try:
                fn()
            except BaseException as e:   # noqa: BLE001 — rethrown below
                errors.append(e)

        t = threading.Thread(target=guarded, args=(reduce_loop,),
                             name="comms-reduce", daemon=True)
        t.start()
        guarded(bcast_loop)
        t.join()
        if errors:
            # a real peer failure outranks the abort it cascaded into the
            # other loop — surface the root cause
            for e in errors:
                if not isinstance(e, CommsAbortedError):
                    raise e
            raise errors[0]
        out = np.concatenate(mean_parts)
        self._stats(t0, len(buckets), self.bytes_sent - sent0,
                    self.bytes_recv - recv0,
                    acct["r_pay"] + acct["b_pay"],
                    acct["r_dense"] + acct["b_dense"])
        return out

    def _stats(self, t0: float, nbuckets: int, sent: int, recv: int,
               pay_sent: int, dense_sent: int) -> None:
        ratio = (dense_sent / pay_sent) if pay_sent else 1.0
        _metrics().ratio.set(ratio)
        self.last = {"wall_s": time.perf_counter() - t0,
                     "buckets": nbuckets, "bytes_sent": sent,
                     "bytes_recv": recv, "payload_sent": pay_sent,
                     "dense_equiv_sent": dense_sent,
                     "compression_ratio": ratio}
