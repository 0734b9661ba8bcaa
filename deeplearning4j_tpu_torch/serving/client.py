"""Client for the InferenceServer (JSON + base64 float32).

Counterpart of deeplearning4j_tpu/serving/client.py. One persistent
keep-alive connection per thread (``keep_alive=False``: one connection a
call); a dropped socket -- before the send or mid-response -- reconnects
once within the call before the retry policy sees an error. Every call
retries through the shared ``resilience.retry.retry_call`` under the
client's ``RetryPolicy`` (``retries`` attempts). Status codes map to the
server's error types: 429 -> ServerOverloadedError (retried with
backoff), 503 -> BatcherStoppedError, 504 -> DeadlineExceededError (not
retried), other 4xx (a 409 migration reject among them) -> ValueError
(not retried), 5xx -> RuntimeError. Connection failures retry under the
same policy. ``post_raw`` forwards bytes and returns the status as data:
the router's upstream call.
"""

from __future__ import annotations

import http.client
import json
import threading
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, DeadlineExceededError, ServerOverloadedError)
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call
from deeplearning4j_tpu_torch.serving.wire import (ndarray_from_b64,
                                                   ndarray_to_b64)

# socket-level failures: the connection died (before the send, or after
# the headers: IncompleteRead), not "the server answered an error"
_CONN_ERRORS = (http.client.RemoteDisconnected, http.client.CannotSendRequest,
                http.client.BadStatusLine, http.client.IncompleteRead,
                ConnectionError, BrokenPipeError, OSError)


def _error_message(code: int, body: bytes) -> str:
    """The structured error body's message ({"error": {"type",
    "message"}}, or a plain string), else ``HTTP <code>``."""
    try:
        err = json.loads(body.decode()).get("error")
        if isinstance(err, dict):
            return str(err.get("message", err))
        if err is not None:
            return str(err)
    except (ValueError, AttributeError):
        pass
    return f"HTTP {code}"


def _typed_http_error(code: int, body: bytes) -> Exception:
    msg = _error_message(code, body)
    if code == 429:
        return ServerOverloadedError(msg)
    if code == 503:
        return BatcherStoppedError(msg)
    if code == 504:
        return DeadlineExceededError(msg)
    if 400 <= code < 500:
        return ValueError(msg)
    return RuntimeError(msg)


class InferenceClient:
    def __init__(self, url: str, timeout: float = 30.0, retries: int = 3,
                 keep_alive: bool = True):
        self.url = url.rstrip("/")
        parsed = urlparse(self.url)
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or (443 if parsed.scheme == "https" else 80)
        self.timeout = timeout
        self.keep_alive = keep_alive
        self.retry_policy = RetryPolicy(max_attempts=max(1, retries),
                                        base_delay=0.05, max_delay=1.0)
        self._local = threading.local()

    # ------------------------------------------------------------ transport
    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(self.host, self.port,
                                           timeout=self.timeout)
            self._local.conn = c
        return c

    def close(self) -> None:
        """Drop this thread's connection; the next call reconnects."""
        c = getattr(self._local, "conn", None)
        if c is not None:
            try:
                c.close()
            except OSError:
                pass
            self._local.conn = None

    def _roundtrip(self, path, body, headers, reconnect=True, give_up=None):
        """One request: ``(status, body, headers)``. A stale keep-alive
        socket reconnects once (``reconnect=False``: one attempt only);
        ``give_up()``, asked before the re-dial, lets a caller that closed
        the socket on purpose (a hedging router cancelling the losing
        attempt) abort instead of sending again."""
        method = "GET" if body is None else "POST"
        for attempt in ((0, 1) if reconnect else (1,)):
            conn = self._conn()
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, resp.read(), dict(resp.getheaders())
            except TimeoutError:
                self.close()
                raise
            except _CONN_ERRORS:
                self.close()
                if attempt:
                    raise
                if give_up is not None and give_up():
                    raise

    def post_raw(self, path, body: bytes, headers=None, reconnect=True,
                 give_up=None):
        """Forward encoded bytes and return ``(status, body, headers)``
        without raising on an error status: the router's upstream call (it
        owns failover and hedging, so it needs the status as data, the
        response headers, and the payload passed through byte for
        byte)."""
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        try:
            return self._roundtrip(path, body, hdrs, reconnect=reconnect,
                                   give_up=give_up)
        finally:
            if not self.keep_alive:
                self.close()

    def _once(self, path, payload):
        body = None if payload is None else json.dumps(payload).encode()
        headers = {} if body is None else {
            "Content-Type": "application/json"}
        try:
            status, data, _ = self._roundtrip(path, body, headers)
        finally:
            if not self.keep_alive:
                self.close()
        if status >= 400:
            raise _typed_http_error(status, data)
        out = json.loads(data.decode())
        if isinstance(out, dict) and "error" in out:
            err = out["error"]
            raise RuntimeError(err.get("message", str(err))
                               if isinstance(err, dict) else err)
        return out

    def _request(self, path, payload=None):
        # overload (429) and connection failures retry with backoff; a
        # payload error or a spent deadline surfaces at once
        return retry_call(self._once, path, payload,
                          policy=self.retry_policy,
                          component="serving_client")

    # ------------------------------------------------------------------ API
    def predict(self, x, deadline_ms: Optional[float] = None) -> np.ndarray:
        """POST one request batch; a 1-D vector is a batch of 1 and the
        batch dim is stripped from the reply."""
        payload = {"ndarray": ndarray_to_b64(np.asarray(x))}
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        return ndarray_from_b64(self._request("/predict", payload)["ndarray"])

    def generate(self, tokens, max_new_tokens: int = 32, seed: int = 0,
                 temperature: float = 0.0, top_k: int = 0) -> dict:
        """POST /generate; returns {"tokens": [...], "prompt_len": int}."""
        return self._request("/generate", {
            "tokens": [int(t) for t in tokens],
            "max_new_tokens": int(max_new_tokens), "seed": int(seed),
            "temperature": float(temperature), "top_k": int(top_k)})

    def kv_export(self, tokens) -> dict:
        """POST /kv/export: the server's cached KV block chain for this
        prompt as a migration payload (serving/kv/migrate.py), for another
        server's ``kv_import``."""
        return self._request("/kv/export",
                             {"tokens": [int(t) for t in tokens]})

    def kv_import(self, payload: dict) -> dict:
        """POST /kv/import: restore a ``kv_export`` payload into the
        server's pool. A rejected payload (HTTP 409, the pool untouched)
        raises ValueError."""
        return self._request("/kv/import", dict(payload))

    def warmup(self, input_shape, max_batch=None) -> dict:
        """POST /warmup: run (on the card, capture) the server's bucket
        ladder for ``input_shape``, a per-example feature shape."""
        payload = {"input_shape": list(input_shape)}
        if max_batch is not None:
            payload["max_batch"] = int(max_batch)
        return self._request("/warmup", payload)

    def health(self) -> dict:
        """GET /healthz, once: a draining server's 503 reads as
        ``{"status": "draining"}``."""
        try:
            return self._once("/healthz", None)
        except BatcherStoppedError:
            return {"status": "draining"}

    def stats(self) -> dict:
        return self._request("/stats")
