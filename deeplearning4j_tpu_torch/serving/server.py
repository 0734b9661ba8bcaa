"""HTTP inference endpoint over the micro-batched engine.

Counterpart of deeplearning4j_tpu/serving/server.py, with the same JSON +
base64 float32 wire format (serving/wire.py). Endpoints:

  POST /predict   {"ndarray": {shape, data}, "deadline_ms"?} -> {"ndarray": ...}
  POST /generate  {"tokens": [...], "max_new_tokens"?, "seed"?,
                   "temperature"?, "top_k"?}                -> {"tokens": [...]}
  POST /kv/export {"tokens": [...]}                         -> migration payload
  POST /kv/import <a /kv/export payload>                    -> {"imported_blocks", ...}
  POST /warmup    {"input_shape": [...], "max_batch"?}      -> {"buckets", "seconds"}
  POST /admin/swap {"checkpoint": path, "version"?}         -> {"swapped", "version", ...}
  POST /admin/profile {"dir": d, "seconds"?}                -> a timed torch.profiler session
  GET  /stats                                               -> engine+batcher stats
  GET  /metrics                                             -> Prometheus text
  GET  /requests?n=                                         -> the request journal
  GET  /healthz                                             -> {"status": ...}
  GET  /trace                                               -> the span ring (Chrome JSON)
  GET  /programs                                            -> the program registry
  GET  /train/diagnostics                                   -> the flight recorder's record

Every request carries an id: the client's ``x-request-id``, or one minted
here (``req-<pid hex>-<server id>-NNNNNN``), echoed on every response and
in error bodies and written into the journal with the ``x-tenant`` and
``x-priority`` headers. /predict, /generate and /kv/* answer with
``x-model-version``. Every error body is ``{"error": {"type", "message",
"request_id"}}`` and the status classifies it: 400 malformed payload (or a
bad ``seconds`` for /admin/profile), 404 unknown path, no decode engine,
/kv/* without a paged engine with a prefix cache, or
/train/diagnostics without a flight recorder, 409 a migration payload
rejected (``kv_migrate_rejected``, the pool untouched), a swap candidate
that does not match the serving weights (``weight_mismatch``, both engines
untouched) or a profiling session already running (``profile_busy``), 400
``bad_checkpoint`` for a checkpoint that cannot be read, 429 queue full,
503 draining or a profiler that cannot start (``profiler_unavailable``),
504 deadline expired, 500 engine fault.

Every request runs inside ``_observed``: the ``x-trace-context`` header's
trace context installed for the handler (so the ``http_request`` span,
the batcher's ``enqueue`` and the engines' spans carry its ``trace_id``,
as does the request's journal record), the per-path
``dl4jtpu_http_requests_total`` / ``dl4jtpu_http_request_seconds`` cells,
and ``note_response``, whose per-server status classes feed the
availability ``BurnRateSLO`` that ``/healthz`` reads.

``/warmup`` captures the bucketed engine's ladder (``InferenceEngine.
warmup``) on the decode loop's thread between its ticks, with the
/predict path held: a capture is global, and nothing else may run CUDA
work meanwhile. ``/admin/swap`` loads a checkpoint's arrays
(``util.model_serializer.load_weights``) and swaps both engines: the
decode engine stages first and applies at its next tick with no live
slot, then /predict cuts over; both write in place, so no capture
follows.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.monitor import profiling, tracing
from deeplearning4j_tpu_torch.monitor.metrics import get_registry
from deeplearning4j_tpu_torch.monitor.slo import BurnRateSLO
from deeplearning4j_tpu_torch.monitor.tracing import trace
from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, CorruptCheckpointError, DeadlineExceededError,
    ServerOverloadedError, WeightSwapError)
from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
from deeplearning4j_tpu_torch.serving.engine import (InferenceEngine,
                                                     input_type_of)
from deeplearning4j_tpu_torch.serving.kv import KVMigrateError
from deeplearning4j_tpu_torch.serving.wire import (ndarray_from_b64,
                                                   ndarray_to_b64)


_KNOWN_PATHS = ("/predict", "/generate", "/warmup", "/stats", "/metrics",
                "/healthz", "/chaos", "/admin/swap", "/trace", "/programs",
                "/admin/profile", "/train/diagnostics", "/kv/export",
                "/kv/import", "/requests")


def _http_metrics():
    reg = get_registry()
    return (reg.counter("dl4jtpu_http_requests_total",
                        "HTTP requests served by the inference server.",
                        ("path",)),
            reg.histogram("dl4jtpu_http_request_seconds",
                          "Wall seconds per HTTP request, handler-inclusive.",
                          ("path",)))


class BadRequestError(ValueError):
    """Client-side payload problem -> HTTP 400 (never 500)."""


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive: every response sets an exact Content-Length
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    @property
    def _rid(self):
        """The request's id: the client's ``x-request-id``, else one minted
        once per request (cached against this request's header object,
        which a keep-alive connection renews per request)."""
        rid = self.headers.get("x-request-id")
        if rid:
            return rid
        minted = getattr(self, "_rid_minted", None)
        if minted is None or minted[0] is not self.headers:
            minted = (self.headers, self.server.inference.mint_rid())
            self._rid_minted = minted
        return minted[1]

    def _send(self, data: bytes, content_type: str, code: int,
              extra_headers=None):
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("x-request-id", self._rid)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _json(self, obj, code=200, extra_headers=None):
        self._send(json.dumps(obj).encode(), "application/json", code,
                   extra_headers)

    def _error(self, code: int, err_type: str, message: str):
        self._json({"error": {"type": err_type, "message": message,
                              "request_id": self._rid}}, code)

    def _identity(self) -> dict:
        return {"request_id": self._rid,
                "tenant": self.headers.get("x-tenant", "default"),
                "priority": self.headers.get("x-priority", "normal")}

    def _observed(self, path, fn):
        """``fn()`` as one observed request: the ``x-trace-context``
        header's context installed, the ``http_request`` span, the
        per-path counter and histogram (unknown paths share one series)
        and ``note_response``."""
        counter, hist = _http_metrics()
        label = path if path in _KNOWN_PATHS else "other"
        ctx = tracing.TraceContext.from_header(
            self.headers.get("x-trace-context"))
        self._status = 200
        t0 = time.perf_counter()
        try:
            with tracing.trace_context(ctx):
                with trace.span("http_request", path=label,
                                request_id=self._rid):
                    fn()
        finally:
            counter.labels(path=label).inc()
            hist.labels(path=label).observe(time.perf_counter() - t0)
            self.server.inference.note_response(label, self._status)

    def do_GET(self):
        srv = self.server.inference
        url = urlparse(self.path)
        path = url.path

        def handle():
            if path == "/stats":
                self._json(srv.stats())
            elif path == "/healthz":
                info = srv.health_info()
                self._json(info,
                           503 if info["status"] == "draining" else 200)
            elif path == "/metrics":
                self._send(get_registry().render().encode(),
                           "text/plain; version=0.0.4; charset=utf-8", 200)
            elif path == "/trace":
                # this process's span ring as one Chrome trace document
                self._json(trace.export())
            elif path == "/requests":
                n = parse_qs(url.query).get("n", [None])[0]
                try:
                    n = None if n is None else int(n)
                except ValueError:
                    self._error(400, "bad_request",
                                f"n must be an integer, got {n!r}")
                    return
                self._json(srv.request_journal(n))
            elif path == "/programs":
                from deeplearning4j_tpu_torch.exec.programs import \
                    get_programs
                self._json({"programs": get_programs().entries()})
            elif path == "/train/diagnostics":
                if srv.flight_recorder is None:
                    self._error(404, "not_found",
                                "no flight recorder attached to this server")
                else:
                    self._json(srv.flight_recorder.diagnostics())
            else:
                self._error(404, "not_found", f"no such path: {path}")

        self._observed(path, handle)

    def do_POST(self):
        srv = self.server.inference
        path = urlparse(self.path).path
        n = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(n).decode())
            if not isinstance(payload, dict):
                raise ValueError("payload must be a JSON object")
        except Exception as e:  # noqa: BLE001 -- client sent junk
            self._error(400, "bad_request", f"bad json: {e}")
            return
        self._observed(path, lambda: self._post(srv, path, payload))

    def _post(self, srv, path, payload):
        try:
            if path == "/predict":
                self._predict(srv, payload)
            elif path == "/generate":
                self._generate(srv, payload)
            elif path == "/kv/export":
                self._kv_export(srv, payload)
            elif path == "/kv/import":
                self._kv_import(srv, payload)
            elif path == "/admin/swap":
                self._admin_swap(srv, payload)
            elif path == "/admin/profile":
                self._admin_profile(payload)
            elif path == "/warmup":
                self._warmup(srv, payload)
            else:
                self._error(404, "not_found", f"no such path: {path}")
        except BadRequestError as e:
            self._error(400, "bad_request", str(e))
        except WeightSwapError as e:
            # validation refused the candidate: neither engine was touched
            self._error(409, "weight_mismatch", str(e))
        except KVMigrateError as e:
            # validation rejected the payload before the pool was touched
            self._error(409, "kv_migrate_rejected", str(e))
        except (CorruptCheckpointError, FileNotFoundError) as e:
            self._error(400, "bad_checkpoint", str(e))
        except ServerOverloadedError as e:
            self._error(429, "overloaded", str(e))
        except BatcherStoppedError as e:
            self._error(503, "draining", str(e))
        except DeadlineExceededError as e:
            self._error(504, "deadline_exceeded", str(e))
        except Exception as e:  # noqa: BLE001 -- engine fault: 500
            srv.note_engine_error(e)
            self._error(500, "internal", srv.last_error)

    def _admin_profile(self, payload):
        """POST /admin/profile {"dir": path, "seconds"?: float}: profile
        the next seconds of live traffic (monitor/profiling.py); one
        session at a time per process."""
        if profiling.profile_status()["profiling"]:
            self._error(409, "profile_busy",
                        "a profiling session is already running")
            return
        try:
            out = profiling.start_profile(
                payload.get("dir", ""),
                seconds=float(payload.get("seconds", 5.0)))
        except (TypeError, ValueError) as e:
            raise BadRequestError(str(e)) from None
        except RuntimeError as e:
            self._error(503, "profiler_unavailable", str(e))
            return
        self._json(out)

    def _predict(self, srv, payload):
        try:
            x = ndarray_from_b64(payload["ndarray"])
        except KeyError:
            raise BadRequestError("payload missing 'ndarray'") from None
        except Exception as e:  # noqa: BLE001 -- undecodable client bytes
            raise BadRequestError(f"undecodable ndarray: {e}") from None
        deadline_ms = payload.get("deadline_ms", srv.request_timeout_ms)
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
            except (TypeError, ValueError):
                raise BadRequestError(
                    f"deadline_ms must be a number, got "
                    f"{payload.get('deadline_ms')!r}") from None
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        srv.validate_features(x)
        if srv.request_mirror is not None:
            try:
                # a best-effort tap on real traffic: never fails a request
                srv.request_mirror(x)
            except Exception:  # noqa: BLE001
                pass
        # block=False: a full queue answers 429 now instead of parking the
        # handler thread on backpressure
        out = srv.batcher.submit(x, deadline_ms=deadline_ms, block=False,
                                 **self._identity()).result()
        self._json({"ndarray": ndarray_to_b64(out[0] if squeeze else out)},
                   extra_headers={
                       "x-model-version": str(
                           getattr(srv.engine, "model_version", 0))})

    def _warmup(self, srv, payload):
        """POST /warmup {"input_shape": per-example shape, "max_batch"?}:
        the bucketed engine's ladder run (captured on the card)."""
        try:
            shape = payload["input_shape"]
        except KeyError:
            raise BadRequestError("payload missing 'input_shape'") from None
        if not isinstance(shape, list) or not shape:
            raise BadRequestError(
                f"input_shape must be a non-empty list, got {shape!r}")
        shapes = ([tuple(s) for s in shape] if isinstance(shape[0], list)
                  else tuple(shape))
        try:
            buckets = srv.warmup(shapes, max_batch=payload.get("max_batch"))
        except (TypeError, ValueError) as e:
            raise BadRequestError(str(e)) from None
        self._json({"buckets": buckets,
                    "seconds": srv.engine.warmup_seconds})

    def _admin_swap(self, srv, payload):
        """POST /admin/swap {"checkpoint": path, "version"?: int}: load a
        checkpoint's weights and hot-swap them into both engines."""
        try:
            ck = payload["checkpoint"]
        except KeyError:
            raise BadRequestError("payload missing 'checkpoint'") from None
        version = payload.get("version")
        if version is not None:
            try:
                version = int(version)
            except (TypeError, ValueError):
                raise BadRequestError(
                    f"version must be an int, got {version!r}") from None
        v = srv.swap_checkpoint(ck, version=version)
        self._json({"swapped": True, "version": v,
                    "checkpoint": str(ck),
                    "compiled_programs": srv.engine.trace_count})

    def _kv_gate(self, srv):
        """The decode engine, when it is paged with a prefix cache (the
        chain index is what migrates); else a 404 and None."""
        dec = srv.decode_engine
        if dec is None or getattr(dec, "_prefix", None) is None:
            self._error(404, "not_found",
                        "KV migration requires a paged decode engine with "
                        "prefix_cache on this server")
            return None
        return dec

    def _kv_export(self, srv, payload):
        dec = self._kv_gate(srv)
        if dec is None:
            return
        tokens = payload.get("tokens")
        if (not isinstance(tokens, list)
                or not all(isinstance(t, int) for t in tokens)):
            raise BadRequestError("'tokens' must be a list of token ids")
        self._json(dec.kv_export(tokens), extra_headers={
            "x-model-version": str(dec.model_version)})

    def _kv_import(self, srv, payload):
        dec = self._kv_gate(srv)
        if dec is None:
            return
        self._json(dec.kv_import(payload), extra_headers={
            "x-model-version": str(dec.model_version)})

    def _generate(self, srv, payload):
        if srv.decode_engine is None:
            self._error(404, "not_found",
                        "no decode engine configured on this server")
            return
        tokens = payload.get("tokens")
        if (not isinstance(tokens, list)
                or not all(isinstance(t, int) for t in tokens)):
            raise BadRequestError("'tokens' must be a list of token ids")
        try:
            out = srv.decode_engine.generate(
                tokens,
                max_new_tokens=int(payload.get("max_new_tokens", 32)),
                seed=int(payload.get("seed", 0)),
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)), **self._identity())
        except ValueError as e:     # capacity / id-range problems -> 400
            raise BadRequestError(str(e)) from None
        self._json(out, extra_headers={
            "x-model-version": str(srv.decode_engine.model_version)})


class InferenceServer:
    """Serve a MultiLayerNetwork or a ComputationGraph over HTTP through
    bucketed micro-batching.

        srv = InferenceServer(net, port=0, decode_engine=eng).start()
        out = InferenceClient(f"http://127.0.0.1:{srv.port}").predict(x)

    The parameters are the JAX server's, in its order. ``max_queue``:
    bound on queued requests (beyond it: HTTP 429).
    ``request_timeout_ms``: the deadline of a /predict that sends no
    ``deadline_ms`` (None: none). ``health_hook``: ``() -> {"status":
    ...} | None``, merged into /healthz. ``request_mirror``: ``(features)
    -> None``, a best-effort tap on /predict traffic. ``flight_recorder``:
    a ``monitor.flight.FlightRecorder`` served at ``GET
    /train/diagnostics`` (404 without one), whose degrading anomalies
    degrade /healthz. ``role``: ``prefill``, ``decode`` or ``mixed``, a
    routing preference advertised in /stats (every endpoint is served
    whatever the role). ``fault_injector`` must be None: the fault
    injector is not ported (ROADMAP queue 1 item 6c). ``journal_capacity``:
    the records the /predict journal keeps (the decode engine keeps its
    own).
    """

    _ids = itertools.count()

    def __init__(self, model, port: int = 9300, host: str = "127.0.0.1",
                 max_batch: int = 256, max_latency_ms: float = 2.0,
                 engine: Optional[InferenceEngine] = None,
                 max_queue: int = 1024,
                 request_timeout_ms: Optional[float] = None,
                 decode_engine=None, fault_injector=None,
                 health_hook=None, request_mirror=None,
                 flight_recorder=None, role: str = "mixed",
                 journal_capacity: int = 512):
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'mixed', got {role!r}")
        if fault_injector is not None:
            raise NotImplementedError(
                "InferenceServer(fault_injector=): the fault injector is not "
                "ported to the PyTorch package yet (ROADMAP queue 1 item 6c)")
        self.role = role
        self.model = model
        self.engine = engine or InferenceEngine(model)
        self.decode_engine = decode_engine
        self.fault_injector = None
        self.health_hook = health_hook
        self.request_mirror = request_mirror
        self.flight_recorder = flight_recorder
        self.request_timeout_ms = request_timeout_ms
        self.batcher = MicroBatcher(self.engine, max_batch=max_batch,
                                    max_latency_ms=max_latency_ms,
                                    max_queue=max_queue,
                                    journal_capacity=journal_capacity)
        self.id = f"server{next(InferenceServer._ids)}"
        # ids minted for requests that came without one: the pid and the
        # server keep them unique across the servers of one host
        self._rid_prefix = f"{os.getpid():x}-{self.id}"
        self._rid_counter = itertools.count(1)
        self._port_req = port
        self._host = host
        self._httpd = None
        self.port: Optional[int] = None
        self._draining = threading.Event()
        # /warmup and the swaps, one at a time: a swap's device work (the
        # candidate's copy to the card, its quantization) must not run
        # while a warm-up captures on another thread
        self._admin_lock = threading.Lock()
        self.last_error: Optional[str] = None
        self._m_engine_errors = get_registry().counter(
            "dl4jtpu_serving_engine_errors_total",
            "Engine faults surfaced as HTTP 500 by the inference server.")
        # per-instance response classes: the SLI under the burn-rate SLO,
        # labelled by server so a new server starts with a clean budget
        self._m_responses = get_registry().counter(
            "dl4jtpu_http_responses_total",
            "HTTP responses by status class, per server instance.",
            ("server", "path", "class"))
        sli, bad = [], []
        for p in ("/predict", "/generate"):
            for c in ("2xx", "4xx", "5xx"):
                child = self._m_responses.labels(
                    server=self.id, path=p, **{"class": c})
                sli.append(child)
                if c == "5xx":
                    bad.append(child)
        # availability over /predict and /generate: 5xx burn the budget,
        # 4xx are the client's
        self.slo = BurnRateSLO(
            f"availability:{self.id}",
            bad_fn=lambda: sum(c.value for c in bad),
            total_fn=lambda: sum(c.value for c in sli),
            objective=0.99)

    def validate_features(self, x: np.ndarray) -> None:
        """400 for a wrong rank or feature width against the model's
        declared input type."""
        itype = input_type_of(self.model)
        if itype is None:
            return
        if itype.kind == "rnn":
            ok = x.ndim == 3 and x.shape[-1] == itype.size
            want = f"(batch, time, {itype.size})"
        elif itype.kind in ("ff", "cnn_flat"):
            expected = itype.batch_shape(1)
            ok = x.ndim == len(expected) and x.shape[1:] == expected[1:]
            want = f"(batch, {', '.join(str(d) for d in expected[1:])})"
        else:
            return
        if not ok:
            raise BadRequestError(f"input shape {tuple(x.shape)} does not "
                                  f"match model input {want}")

    def mint_rid(self) -> str:
        return f"req-{self._rid_prefix}-{next(self._rid_counter):06d}"

    # --------------------------------------------------------------- health
    def note_engine_error(self, e: BaseException) -> None:
        """An engine fault answered 500: kept for /stats and counted."""
        self.last_error = f"{type(e).__name__}: {e}"
        self._m_engine_errors.inc()

    def note_response(self, path: str, code: int) -> None:
        """Count one HTTP response by status class (the handler calls it
        for every request; it feeds the availability SLO)."""
        try:
            cls = f"{int(code) // 100}xx"
            self._m_responses.labels(server=self.id, path=path,
                                     **{"class": cls}).inc()
        except Exception:  # noqa: BLE001 -- accounting never breaks serving
            pass

    def health_info(self) -> dict:
        """``{"status": ...}`` and a ``reason`` when degraded, first match
        first: ``queue_pressure`` (the /predict queue at least 80% full),
        ``kv_pool_exhausted`` (a paged decode engine's queue head cannot
        claim its blocks; with the pool's ``kv`` occupancy),
        ``decode_saturated`` (every decode slot busy), the health hook's
        own, the flight recorder's (``train_non_finite``,
        ``train_anomaly``), ``slo_fast_burn`` (with the SLO's state)."""
        if self._draining.is_set() or self.batcher.stopping:
            return {"status": "draining"}
        st = self.batcher.stats()
        if st["queue_capacity"] and (st["queue_depth"]
                                     >= 0.8 * st["queue_capacity"]):
            return {"status": "degraded", "reason": "queue_pressure"}
        dec = self.decode_engine
        if dec is not None and getattr(dec, "kv_exhausted", False):
            return {"status": "degraded", "reason": "kv_pool_exhausted",
                    "kv": dec.kv_pool_info()}
        if dec is not None and dec.saturated:
            return {"status": "degraded", "reason": "decode_saturated"}
        if self.health_hook is not None:
            try:
                extra = self.health_hook()
            except Exception:  # noqa: BLE001 -- a broken hook cannot take
                extra = None   # the whole server unhealthy
            if extra and extra.get("status") not in (None, "ok"):
                return extra
        if self.flight_recorder is not None:
            try:
                fr = self.flight_recorder.health_info()
            except Exception:  # noqa: BLE001 -- nor can telemetry
                fr = None
            if fr and fr.get("status") not in (None, "ok"):
                return fr
        try:
            slo = self.slo.evaluate()
        except Exception:  # noqa: BLE001 -- nor SLO arithmetic
            slo = None
        if slo is not None and slo.fast_burn:
            return {"status": "degraded", "reason": "slo_fast_burn",
                    "slo": slo.as_dict()}
        return {"status": "ok"}

    def health(self) -> str:
        return self.health_info()["status"]

    def stats(self) -> dict:
        out = {"engine": self.engine.stats(),
               "batcher": self.batcher.stats(),
               "health": self.health_info()["status"],
               "role": self.role,
               "model_version": self.engine.model_version,
               "device": str(self.model.device),
               "last_error": self.last_error}
        if self.decode_engine is not None:
            out["decode"] = self.decode_engine.stats()
        return out

    def request_journal(self, n: Optional[int] = None) -> dict:
        """What ``GET /requests?n=`` serves: the /predict (batcher) and
        /generate (decode) journals merged on ``ts``, newest last."""
        logs = [self.batcher.journal]
        if self.decode_engine is not None:
            logs.append(self.decode_engine.journal)
        recs, total, dropped = [], 0, 0
        for lg in logs:
            snap = lg.snapshot()
            recs.extend(snap["records"])
            total += snap["total"]
            dropped += snap["dropped"]
        recs.sort(key=lambda r: r.get("ts") or 0.0)
        if n is not None:
            recs = recs[-n:] if n > 0 else []
        return {"server": self.id, "total": total, "dropped": dropped,
                "records": recs}

    # ------------------------------------------------------------ warm-up
    def warmup(self, example_shape, max_batch=None):
        """The bucketed engine's ``warmup``, run on the decode loop's
        thread between ticks when one runs (a capture is global: the
        decode programs must not run meanwhile; the engine's lock holds
        /predict; no swap runs meanwhile). Returns the rungs."""
        def run():
            return self.engine.warmup(example_shape, max_batch=max_batch)
        with self._admin_lock:
            if self.decode_engine is not None:
                return self.decode_engine.run_exclusive(run)
            return run()

    # ------------------------------------------------------------- hot swap
    def swap_weights(self, params, state=None,
                     version: Optional[int] = None) -> int:
        """Hot-swap both engines to a same-shape weight tree. Both engines
        validate it first, so a ``WeightSwapError`` leaves serving as it
        was; then the decode engine (if any) stages it and applies it at
        its next tick with no live slot (in-flight generations finish on
        the old weights), and /predict cuts over. No warm-up captures
        meanwhile. Returns the new version."""
        with self._admin_lock:
            if version is None:
                version = self.engine.model_version + 1
            self.engine.check_swap(params, state)
            if self.decode_engine is not None:
                self.decode_engine.swap_weights(params, state,
                                                version=version)
            return self.engine.swap_weights(params, state, version=version)

    def swap_checkpoint(self, path, version: Optional[int] = None) -> int:
        """Load a checkpoint zip's (params, state) and hot-swap them in:
        what POST /admin/swap calls. The zip's configuration is ignored
        (``model_serializer.load_weights``)."""
        from deeplearning4j_tpu_torch.util import model_serializer
        params, state = model_serializer.load_weights(self.engine.model,
                                                      path)
        return self.swap_weights(params, state, version=version)

    def start(self) -> "InferenceServer":
        self.batcher.start()
        if self.decode_engine is not None:
            self.decode_engine.start()
        self._httpd = _TrackingHTTPServer((self._host, self._port_req),
                                          _Handler)
        self._httpd.inference = self
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self

    def stop(self) -> None:
        """Graceful drain: healthz reports draining, the batcher flushes
        what is queued, then the listener and every keep-alive connection
        close."""
        self._draining.set()
        self.batcher.stop()
        if self.decode_engine is not None:
            self.decode_engine.stop()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd.close_all_connections()


class _TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that remembers established connections, so
    stop() can close keep-alive sockets whose handler threads would
    otherwise keep answering."""

    daemon_threads = True

    def __init__(self, *args, **kwargs):
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def get_request(self):
        sock_, addr = super().get_request()
        with self._conns_lock:
            self._conns.add(sock_)
        return sock_, addr

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for sock_ in conns:
            try:
                sock_.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock_.close()
            except OSError:
                pass
