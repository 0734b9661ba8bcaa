"""Client for the InferenceServer (JSON + base64 float32).

Counterpart of deeplearning4j_tpu/serving/client.py. One persistent
keep-alive connection per thread; a dropped socket reconnects once within
the call. Status codes map to the server's error types: 429 ->
ServerOverloadedError (retried with backoff), 503 -> BatcherStoppedError,
504 -> DeadlineExceededError, other 4xx (a 409 migration reject among them)
-> ValueError, 5xx -> RuntimeError.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from deeplearning4j_tpu_torch.resilience.errors import (
    BatcherStoppedError, DeadlineExceededError, ServerOverloadedError)
from deeplearning4j_tpu_torch.serving.wire import (ndarray_from_b64,
                                                   ndarray_to_b64)

_CONN_ERRORS = (http.client.RemoteDisconnected, http.client.CannotSendRequest,
                http.client.BadStatusLine, http.client.IncompleteRead,
                ConnectionError, BrokenPipeError)


def _typed_http_error(code: int, body: bytes) -> Exception:
    try:
        err = json.loads(body.decode()).get("error")
        msg = str(err.get("message", err)) if isinstance(err, dict) else str(err)
    except (ValueError, AttributeError):
        msg = f"HTTP {code}"
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
    def __init__(self, url: str, timeout: float = 60.0, retries: int = 3):
        parsed = urlparse(url.rstrip("/"))
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or 80
        self.timeout = timeout
        self.retries = max(1, int(retries))
        self._local = threading.local()

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(self.host, self.port,
                                           timeout=self.timeout)
            self._local.conn = c
        return c

    def close(self) -> None:
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None

    def _roundtrip(self, path, body):
        method = "GET" if body is None else "POST"
        headers = {} if body is None else {"Content-Type": "application/json"}
        for attempt in (0, 1):   # a stale keep-alive socket reconnects once
            try:
                conn = self._conn()
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except _CONN_ERRORS:
                self.close()
                if attempt:
                    raise

    def _request(self, path, payload=None):
        body = None if payload is None else json.dumps(payload).encode()
        for attempt in range(self.retries):
            status, data = self._roundtrip(path, body)
            if status == 429 and attempt + 1 < self.retries:
                time.sleep(0.05 * 2 ** attempt)
                continue
            if status >= 400:
                raise _typed_http_error(status, data)
            return json.loads(data.decode())

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

    def health(self) -> dict:
        try:
            return self._request("/healthz")
        except BatcherStoppedError:
            return {"status": "draining"}

    def stats(self) -> dict:
        return self._request("/stats")
