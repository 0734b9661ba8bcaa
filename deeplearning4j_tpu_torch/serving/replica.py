"""Replica workers for the routed serving tier.

Counterpart of deeplearning4j_tpu/serving/replica.py. A *replica* is one
``InferenceServer`` (micro-batched /predict, optional DecodeEngine
/generate) that the ``Router`` fronts. This module supplies the three ways
a replica exists:

- ``main()``: the subprocess entry point
  (``python -m deeplearning4j_tpu_torch.serving.replica --model tinyattn
  ...``). It builds a deterministic model on ``--device`` (the card unless
  ``cpu`` is asked for; asked for ``cuda`` on a machine without a card it
  exits non-zero before it writes its port file), warms its engines up
  (from an AOT artifact with ``--aot``: the kernel libraries installed,
  the programs restored), serves, writes its bound port to
  ``--port-file`` and drains on SIGTERM. ``--chaos`` mounts the fault
  injector behind ``POST /chaos``.
- ``ReplicaProcess``: the parent-side handle (Popen, ``wait_ready()``,
  ``stop()`` by SIGTERM, ``kill()`` by SIGKILL, ``start()`` again on the
  same port). ``ready_seconds`` is spawn to the first healthy probe.
- ``InProcessReplica``: an in-process server with the same handle shape.

The models are the JAX package's five at their sizes, and
``tinytransformer``: the zoo's TinyTransformer at its default width over
the bundled corpus's vocabulary. Fixed seeds give every replica of a tier
the same weights, so failover parity is testable; ``--checkpoint`` swaps
a checkpoint zip's weights in (a JAX package's zip too).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["ReplicaProcess", "InProcessReplica", "build_model",
           "build_server", "main"]

# charlstm vocab: small, so one decode step is microseconds on the CPU
CHAR_VOCAB = 16
# the bundled corpus's vocabulary (zoo.corpus.corpus_ids)
TEXT_VOCAB = 51

MODELS = ("mlp", "widemlp", "charlstm", "charlstm-draft", "tinyattn",
          "tinytransformer")

# the /predict ladder a replica captures at start: per-example shape
WARM_SHAPES = {"mlp": (4,), "widemlp": (4,), "tinyattn": (64, CHAR_VOCAB),
               "tinytransformer": (64, TEXT_VOCAB)}
WARM_MAX_BATCH = 64


def build_model(name: str, device=None):
    """Deterministic models (fixed seeds: every replica of a tier has the
    same parameters) on ``device`` (the card unless ``"cpu"``)."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (LSTM, DenseLayer,
                                                    OutputLayer,
                                                    RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    if name in ("mlp", "widemlp"):
        widths = (16,) if name == "mlp" else (1024, 2048, 512)
        b = (NeuralNetConfiguration.builder().seed(42).updater(Adam(1e-2))
             .weight_init("xavier").list())
        for w in widths:
            b = b.layer(DenseLayer(n_out=w, activation="relu"))
        conf = (b.layer(OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent"))
                .set_input_type(InputType.feed_forward(4)).build())
        return MultiLayerNetwork(conf, device=device).init()
    if name in ("charlstm", "charlstm-draft"):
        # the draft: one narrow LSTM with its own seed, the same vocabulary
        seed, width = (42, 24) if name == "charlstm" else (17, 8)
        conf = (NeuralNetConfiguration.builder().seed(seed)
                .updater(Adam(1e-2)).weight_init("xavier").list()
                .layer(LSTM(n_out=width, activation="tanh"))
                .layer(RnnOutputLayer(n_out=CHAR_VOCAB, activation="softmax",
                                      loss="mcxent"))
                .set_input_type(InputType.recurrent(CHAR_VOCAB))
                .build())
        return MultiLayerNetwork(conf, device=device).init()
    if name == "tinyattn":
        # attention-only decode state: paged KV with the prefix cache
        from deeplearning4j_tpu_torch.zoo.simple import TinyTransformer
        return TinyTransformer(vocab_size=CHAR_VOCAB, n_layers=2,
                               d_model=32, n_heads=4, max_len=256,
                               seed=42).init(device=device)
    if name == "tinytransformer":
        from deeplearning4j_tpu_torch.zoo.simple import TinyTransformer
        return TinyTransformer(vocab_size=TEXT_VOCAB).init(device=device)
    raise ValueError(f"unknown replica model {name!r} "
                     f"({' | '.join(MODELS)})")


def build_server(model_name: str = "charlstm", port: int = 0,
                 slots: int = 4, max_len: int = 64, max_queue: int = 256,
                 max_latency_ms: float = 2.0, chaos: bool = False,
                 precision: Optional[str] = None, kv: str = "dense",
                 kv_block_size: int = 16, kv_blocks: Optional[int] = None,
                 prefix_cache: bool = False,
                 chunk_tokens: Optional[int] = None,
                 spec_draft: Optional[str] = None, spec_k: int = 4,
                 spec_tree: Optional[str] = None,
                 spec_self_draft: Optional[str] = None,
                 role: str = "mixed",
                 host_kv_bytes: Optional[int] = None,
                 journal_capacity: int = 512, device=None):
    """Assemble (but do not start) a replica's InferenceServer on
    ``device``: the JAX package's parameters, in its order. The
    recurrent and attention models serve /predict and /generate (a
    DecodeEngine: ``kv``, ``kv_block_size``, ``kv_blocks``,
    ``prefix_cache``, ``chunk_tokens``, ``host_kv_bytes``, and
    ``spec_draft`` / ``spec_self_draft`` with ``spec_k`` / ``spec_tree``
    for speculative decoding); the MLPs /predict only. ``chaos`` mounts
    a ``ServerFaultInjector`` behind ``POST /chaos``."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
    from deeplearning4j_tpu_torch.serving.server import InferenceServer
    net = build_model(model_name, device)
    eng = InferenceEngine(net, precision=precision)
    dec = None
    if model_name in ("charlstm", "tinyattn", "tinytransformer"):
        spec = None
        if spec_draft is not None or spec_self_draft is not None:
            from deeplearning4j_tpu_torch.serving.spec import (SpecConfig,
                                                               parse_kvec)
            spec = SpecConfig(
                (build_model(spec_draft, device)
                 if spec_draft is not None else None),
                k=spec_k,
                tree=(parse_kvec(spec_tree) if spec_tree is not None
                      else None),
                self_draft=spec_self_draft)
        dec = DecodeEngine(net, slots=slots, max_len=max_len,
                           max_queue=max_queue, precision=precision,
                           kv=kv, kv_block_size=kv_block_size,
                           kv_blocks=kv_blocks, prefix_cache=prefix_cache,
                           chunk_tokens=chunk_tokens,
                           host_kv_bytes=host_kv_bytes, spec=spec,
                           journal_capacity=journal_capacity)
    injector = None
    if chaos:
        from deeplearning4j_tpu_torch.resilience.faults import \
            ServerFaultInjector
        injector = ServerFaultInjector()
    return InferenceServer(net, port=port, max_latency_ms=max_latency_ms,
                           max_queue=max_queue, engine=eng,
                           decode_engine=dec, fault_injector=injector,
                           role=role, journal_capacity=journal_capacity)


def warm_server(srv, model_name: str, aot: Optional[str] = None) -> None:
    """Warm a built, not yet started server's engines up: the decode
    engine's programs and the /predict ladder (``WARM_SHAPES``), each from
    ``aot`` when given. Runs before any serving thread: a capture is
    global to the process."""
    if srv.decode_engine is not None:
        srv.decode_engine.warmup(aot=aot)
    shape = WARM_SHAPES.get(model_name)
    if shape is not None:
        srv.engine.warmup(shape, max_batch=WARM_MAX_BATCH, aot=aot)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        description="dl4jtpu serving replica worker (PyTorch)")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--port-file", default=None,
                        help="write the bound port here once listening")
    parser.add_argument("--model", default="charlstm",
                        choices=("mlp", "charlstm", "tinyattn",
                                 "tinytransformer"))
    parser.add_argument("--role", default="mixed",
                        choices=("prefill", "decode", "mixed"),
                        help="disaggregation role advertised in /stats")
    parser.add_argument("--host-kv-bytes", type=int, default=None,
                        help="host-memory KV tier byte budget (paged + "
                             "--prefix-cache only)")
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--max-len", type=int, default=64)
    parser.add_argument("--max-queue", type=int, default=256)
    parser.add_argument("--max-latency-ms", type=float, default=2.0)
    parser.add_argument("--journal-capacity", type=int, default=512,
                        help="request journal ring size per engine")
    parser.add_argument("--chaos", action="store_true",
                        help="mount POST /chaos (fault injection)")
    parser.add_argument("--warmup", action="store_true",
                        help="capture the programs before accepting "
                             "traffic")
    parser.add_argument("--aot", default=None,
                        help="AOT artifact path (exec/aot.py): install its "
                             "kernel libraries and restore its programs, "
                             "trace-and-save on any miss (implies warmup)")
    parser.add_argument("--checkpoint", default=None,
                        help="swap in the weights of this checkpoint zip "
                             "before accepting traffic")
    parser.add_argument("--precision", default=None,
                        choices=("f32", "int8", "fp8"),
                        help="serving precision for both engines")
    parser.add_argument("--trace", action="store_true",
                        help="enable span tracing (GET /trace)")
    parser.add_argument("--kv", default="dense", choices=("dense", "paged"))
    parser.add_argument("--kv-block-size", type=int, default=16)
    parser.add_argument("--kv-blocks", type=int, default=None)
    parser.add_argument("--prefix-cache", action="store_true")
    parser.add_argument("--chunk-tokens", type=int, default=None)
    parser.add_argument("--spec-draft", default=None,
                        choices=("charlstm-draft",))
    parser.add_argument("--spec-k", type=int, default=4)
    parser.add_argument("--spec-tree", default=None)
    parser.add_argument("--spec-self-draft", default=None)
    parser.add_argument("--device", default="cuda",
                        help="the device the replica serves on (cuda "
                             "unless cpu is asked for)")
    args = parser.parse_args(argv)
    t_main = time.perf_counter()

    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print(f"REPLICA_FAILED no CUDA device for --device {args.device}",
              file=sys.stderr, flush=True)
        return 3
    from deeplearning4j_tpu_torch.monitor import trace as _trace
    if args.trace:
        _trace.enable(True)
    if args.aot and args.device.startswith("cuda"):
        # before anything builds a kernel: the artifact's libraries
        from deeplearning4j_tpu_torch.exec import aot as aot_mod
        report = aot_mod.install_kernels(args.aot, args.device)
        print(f"REPLICA_KERNELS {report}", flush=True)

    srv = build_server(args.model, port=args.port, slots=args.slots,
                       max_len=args.max_len, max_queue=args.max_queue,
                       max_latency_ms=args.max_latency_ms, chaos=args.chaos,
                       precision=args.precision, kv=args.kv,
                       kv_block_size=args.kv_block_size,
                       kv_blocks=args.kv_blocks,
                       prefix_cache=args.prefix_cache,
                       chunk_tokens=args.chunk_tokens,
                       spec_draft=args.spec_draft, spec_k=args.spec_k,
                       spec_tree=args.spec_tree,
                       spec_self_draft=args.spec_self_draft,
                       role=args.role, host_kv_bytes=args.host_kv_bytes,
                       journal_capacity=args.journal_capacity,
                       device=args.device)
    t_built = time.perf_counter()
    # warm-up before the serve loops start, so the port-file handshake
    # means ready to serve (and no capture runs beside a serving thread)
    if args.warmup or args.aot:
        warm_server(srv, args.model, args.aot)
    t_warm = time.perf_counter()
    srv.start()
    if args.checkpoint:
        v = srv.swap_checkpoint(args.checkpoint)
        print(f"REPLICA_SWAPPED version={v} "
              f"checkpoint={args.checkpoint}", flush=True)

    stopping = []

    def _sigterm(signum, frame):
        # graceful drain: in-flight requests finish, then exit 0
        stopping.append(True)

    signal.signal(signal.SIGTERM, _sigterm)

    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(srv.port))
        os.replace(tmp, args.port_file)      # the parent never reads ""
    _trace.set_process_name(f"replica:{args.model}@{srv.port}")
    from deeplearning4j_tpu_torch.ops import build
    dec = srv.decode_engine
    print(f"REPLICA_READY port={srv.port} pid={os.getpid()} "
          f"model={args.model} device={args.device} "
          f"nvcc_runs={build.nvcc_runs()} "
          f"trace_count={srv.engine.trace_count}"
          f"+{0 if dec is None else dec.trace_count} "
          f"aot_restores={srv.engine.aot_restores}"
          f"+{0 if dec is None else dec.aot_restores} "
          f"seconds=build:{t_built - t_main:.3f},"
          f"warmup:{t_warm - t_built:.3f},"
          f"serve:{time.perf_counter() - t_warm:.3f}", flush=True)

    try:
        while not stopping:
            time.sleep(0.05)
    except KeyboardInterrupt:
        pass
    srv.stop()
    print("REPLICA_STOPPED", flush=True)
    return 0


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


class ReplicaProcess:
    """Parent-side handle for a subprocess replica.

        rep = ReplicaProcess(workdir, model="tinyattn").start().wait_ready()
        ... rep.url ...
        rep.kill()                 # SIGKILL: the crash the router absorbs
        rep.start().wait_ready()   # restart in place, same port

    The first ``start()`` lets the OS pick a port (read back through
    ``--port-file``); later starts reuse it, so the router's upstream URL
    stays valid across restarts. ``device`` is passed as ``--device``
    (the card unless ``"cpu"``); ``env`` is merged into the child's
    environment last (a ``PYTHONPATH`` there runs another tree's
    package)."""

    def __init__(self, workdir: str, model: str = "charlstm",
                 slots: int = 4, max_len: int = 64,
                 chaos: bool = True, warmup: bool = True,
                 name: str = "replica", checkpoint: Optional[str] = None,
                 precision: Optional[str] = None, trace: bool = False,
                 kv: str = "dense", kv_block_size: int = 16,
                 kv_blocks: Optional[int] = None, prefix_cache: bool = False,
                 chunk_tokens: Optional[int] = None,
                 spec_draft: Optional[str] = None, spec_k: int = 4,
                 spec_tree: Optional[str] = None,
                 spec_self_draft: Optional[str] = None,
                 role: str = "mixed",
                 host_kv_bytes: Optional[int] = None,
                 aot: Optional[str] = None,
                 env: Optional[dict] = None, device: str = "cuda"):
        self.workdir = workdir
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.chaos = chaos
        self.warmup = warmup
        self.name = name
        self.precision = precision
        self.kv = kv
        self.kv_block_size = kv_block_size
        self.kv_blocks = kv_blocks
        self.prefix_cache = prefix_cache
        self.chunk_tokens = chunk_tokens
        self.spec_draft = spec_draft
        self.spec_k = spec_k
        self.spec_tree = spec_tree
        self.spec_self_draft = spec_self_draft
        self.role = role
        self.host_kv_bytes = host_kv_bytes
        self.trace = trace
        # mutable: a rolling restart may point these at newer files
        self.checkpoint = checkpoint
        self.aot = aot
        self.extra_env = env
        self.device = str(device)
        # spawn -> port file -> first healthy probe, set by wait_ready()
        self.ready_seconds: Optional[float] = None
        self._t_spawn: Optional[float] = None
        self.port: Optional[int] = None
        self.proc: Optional[subprocess.Popen] = None
        self._log = os.path.join(workdir, f"{name}.log")
        self._port_file = os.path.join(workdir, f"{name}.port")

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def log_path(self) -> str:
        return self._log

    def start(self) -> "ReplicaProcess":
        if os.path.exists(self._port_file) and self.port is None:
            os.unlink(self._port_file)
        cmd = [sys.executable, "-m",
               "deeplearning4j_tpu_torch.serving.replica",
               "--model", self.model, "--slots", str(self.slots),
               "--max-len", str(self.max_len),
               "--port", str(self.port or 0),
               "--port-file", self._port_file, "--device", self.device]
        if self.chaos:
            cmd.append("--chaos")
        if self.warmup:
            cmd.append("--warmup")
        if self.checkpoint:
            cmd.extend(["--checkpoint", os.fspath(self.checkpoint)])
        if self.precision:
            cmd.extend(["--precision", self.precision])
        if self.trace:
            cmd.append("--trace")
        if self.kv != "dense":
            cmd.extend(["--kv", self.kv,
                        "--kv-block-size", str(self.kv_block_size)])
            if self.kv_blocks is not None:
                cmd.extend(["--kv-blocks", str(self.kv_blocks)])
            if self.prefix_cache:
                cmd.append("--prefix-cache")
            if self.chunk_tokens is not None:
                cmd.extend(["--chunk-tokens", str(self.chunk_tokens)])
            if self.host_kv_bytes is not None:
                cmd.extend(["--host-kv-bytes", str(self.host_kv_bytes)])
        if self.role != "mixed":
            cmd.extend(["--role", self.role])
        if self.spec_draft is not None:
            cmd.extend(["--spec-draft", self.spec_draft,
                        "--spec-k", str(self.spec_k)])
        if self.spec_tree is not None:
            cmd.extend(["--spec-tree", self.spec_tree])
        if self.spec_self_draft is not None:
            cmd.extend(["--spec-self-draft", self.spec_self_draft])
        if self.aot:
            cmd.extend(["--aot", os.fspath(self.aot)])
        env = dict(os.environ)
        env["PYTHONPATH"] = (_repo_root() + os.pathsep
                             + env.get("PYTHONPATH", ""))
        if self.extra_env:
            env.update(self.extra_env)
        # log to a file: a full stdout pipe would block a replica nobody
        # reads
        self._logf = open(self._log, "ab")
        self._t_spawn = time.monotonic()
        self.proc = subprocess.Popen(cmd, stdout=self._logf,
                                     stderr=subprocess.STDOUT, env=env,
                                     cwd=self.workdir)
        return self

    def wait_ready(self, timeout: float = 180.0) -> "ReplicaProcess":
        """Block until the replica's /healthz answers ok (the port-file
        handshake and the warm-up both behind it)."""
        from deeplearning4j_tpu_torch.serving.client import InferenceClient
        deadline = time.monotonic() + timeout
        while self.port is None:
            if os.path.exists(self._port_file):
                with open(self._port_file) as f:
                    text = f.read().strip()
                if text:
                    self.port = int(text)
                    break
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica {self.name} exited rc={self.proc.returncode} "
                    f"before binding; see {self._log}")
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"replica {self.name} never wrote {self._port_file}")
            time.sleep(0.05)
        cli = InferenceClient(self.url, timeout=5.0, retries=1)
        try:
            while True:
                try:
                    if cli.health().get("status") == "ok":
                        self._note_ready()
                        return self
                except Exception:   # noqa: BLE001 -- still booting
                    pass
                if self.proc is not None and self.proc.poll() is not None:
                    raise RuntimeError(
                        f"replica {self.name} exited rc="
                        f"{self.proc.returncode} during boot; "
                        f"see {self._log}")
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"replica {self.name} on port {self.port} never "
                        f"became healthy")
                time.sleep(0.05)
        finally:
            cli.close()

    def _note_ready(self) -> None:
        """Record spawn -> first healthy probe: the cold start the AOT
        artifact shrinks (``dl4jtpu_replica_ready_seconds``)."""
        if self._t_spawn is None:
            return
        self.ready_seconds = time.monotonic() - self._t_spawn
        self._t_spawn = None
        try:
            from deeplearning4j_tpu_torch.monitor import get_registry
            get_registry().histogram(
                "dl4jtpu_replica_ready_seconds",
                "Wall seconds from process spawn through the port-file "
                "handshake to the first healthy /healthz probe -- the "
                "cold-start the AOT artifact shrinks.",
                ("replica",)).labels(replica=self.name).observe(
                    self.ready_seconds)
        except Exception:   # noqa: BLE001 -- telemetry must not fail boot
            pass

    def stop(self, timeout: float = 30.0) -> None:
        """SIGTERM -> graceful drain -> exit 0."""
        if self.proc is None or self.proc.poll() is not None:
            self._close_log()
            return
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self._close_log()

    def kill(self) -> None:
        """SIGKILL: no drain, no flushed sockets -- the genuine crash."""
        if self.proc is None:
            return
        try:
            os.kill(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=10)
        self._close_log()

    def _close_log(self) -> None:
        logf = getattr(self, "_logf", None)
        if logf is not None:
            try:
                logf.close()
            except OSError:
                pass
            self._logf = None


class InProcessReplica:
    """Same handle shape as ReplicaProcess, backed by an in-process
    InferenceServer (router tests, where a subprocess adds only wall
    time). In-process replicas share the process-wide metrics registry
    with the router; their series stay apart by label.

    ``server_kw`` goes to ``build_server`` (``device`` among them).
    ``restart()`` stops the server (graceful
    drain) and starts a fresh one on the same port: the restarter
    ``Router.rolling_restart`` wants."""

    def __init__(self, model: str = "mlp", chaos: bool = True, **server_kw):
        self.model = model
        self.chaos = chaos
        self.server_kw = server_kw
        self.srv = None
        self.port: Optional[int] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def fault_injector(self):
        return self.srv.fault_injector if self.srv else None

    def start(self) -> "InProcessReplica":
        self.srv = build_server(self.model, port=self.port or 0,
                                chaos=self.chaos, **self.server_kw)
        if self.srv.decode_engine is not None:
            self.srv.decode_engine.start()
        self.srv.start()
        self.port = self.srv.port
        return self

    def wait_ready(self, timeout: float = 180.0) -> "InProcessReplica":
        """No-op for handle parity: start() returns already listening."""
        return self

    def stop(self) -> None:
        if self.srv is not None:
            srv, self.srv = self.srv, None
            srv.stop()

    def restart(self) -> None:
        self.stop()
        self.start()


if __name__ == "__main__":
    sys.exit(main())
