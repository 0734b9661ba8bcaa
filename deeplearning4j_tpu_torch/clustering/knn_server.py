"""kNN REST server and client.

Counterpart of deeplearning4j_tpu/clustering/knn_server.py (parity
surface: the reference's NearestNeighborsServer, a REST service over an
index, and NearestNeighborsClient, JSON with Base64 arrays). A stdlib
``ThreadingHTTPServer``; with ``use_device=True`` the index is the
brute-force ``NearestNeighbors`` on ``device`` (the card unless the caller
asks for the CPU), built or raising: there is no silent fallback.
``use_device=False`` is the explicit ``VPTree`` choice. Arrays travel as
Base64 of raw little-endian float32 with a shape header (the serving
tier's helpers, byte for byte the JAX package's).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse
import urllib.request

import numpy as np

from deeplearning4j_tpu_torch.clustering.knn import NearestNeighbors
from deeplearning4j_tpu_torch.serving.wire import (  # noqa: F401
    ndarray_from_b64, ndarray_to_b64)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def _json(self, obj, code=200):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        srv = self.server.knn
        path = urlparse(self.path).path
        n = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(n).decode())
        except Exception as e:
            self._json({"error": f"bad json: {e}"}, 400)
            return
        try:
            if path == "/knn":            # by index into the corpus
                idx = int(payload["index"])
                k = int(payload.get("k", 1))
                if not 0 <= idx < len(srv.points):
                    self._json({"error": f"index {idx} out of range "
                                         f"[0, {len(srv.points)})"}, 400)
                    return
                q = srv.points[idx:idx + 1]
                ids, dists = srv.query(q, k + 1)
                # drop the query point itself (reference does the same)
                results = [{"index": int(i), "distance": float(d)}
                           for i, d in zip(ids[0], dists[0])
                           if int(i) != idx][:k]
                self._json({"results": results})
            elif path == "/knnnew":       # by raw vector
                k = int(payload.get("k", 1))
                q = ndarray_from_b64(payload["ndarray"])
                if q.ndim == 1:
                    q = q[None, :]
                ids, dists = srv.query(q, k)
                self._json({"results": [
                    [{"index": int(i), "distance": float(d)}
                     for i, d in zip(row_i, row_d)]
                    for row_i, row_d in zip(ids, dists)]})
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:  # noqa: BLE001 — service must answer
            self._json({"error": str(e)}, 500)


class NearestNeighborsServer:
    """Serve KNN over a fixed corpus (parity: NearestNeighborsServer.java).

        srv = NearestNeighborsServer(points, port=0).start()
        ... NearestNeighborsClient(f"http://localhost:{srv.port}")
    """

    def __init__(self, points: np.ndarray, port: int = 9200,
                 use_device: bool = True, host: str = "127.0.0.1",
                 device=None):
        self.points = np.asarray(points, dtype=np.float32)
        self._port_req = port
        self._host = host
        self.use_device = use_device
        self.device = device
        self._index = None
        self._httpd = None
        self.port: Optional[int] = None

    def _build_index(self):
        if self.use_device:
            self._index = NearestNeighbors(self.points, device=self.device)
            return
        from deeplearning4j_tpu_torch.clustering.trees import VPTree
        self._index = VPTree(self.points)

    def query(self, q: np.ndarray, k: int):
        k = min(k, len(self.points))
        if isinstance(self._index, NearestNeighbors):
            ids, dists = self._index.knn(q, k)
            return np.asarray(ids), np.asarray(dists)
        ids, dists = [], []
        for row in q:
            i, d = self._index.knn(row, k)
            ids.append(i)
            dists.append(d)
        return np.asarray(ids), np.asarray(dists)

    def start(self):
        self._build_index()
        self._httpd = ThreadingHTTPServer((self._host, self._port_req),
                                          _Handler)
        self._httpd.knn = self
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()


class NearestNeighborsClient:
    """Parity: NearestNeighborsClient.java. Connection failures and 5xx
    responses retry with backoff through the shared primitive
    (resilience/retry.py, component="knn_client")."""

    def __init__(self, url: str, timeout: float = 10.0, retries: int = 3):
        from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.retry_policy = RetryPolicy(max_attempts=max(1, retries),
                                        base_delay=0.05, max_delay=1.0)

    def _post_once(self, path, payload):
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:
                out = json.loads(e.read().decode())
            except Exception:
                raise RuntimeError(f"HTTP {e.code}") from e
        if "error" in out:
            raise RuntimeError(out["error"])
        return out

    def _post(self, path, payload):
        from deeplearning4j_tpu_torch.resilience.retry import retry_call
        return retry_call(self._post_once, path, payload,
                          policy=self.retry_policy, component="knn_client")

    def knn(self, index: int, k: int):
        return self._post("/knn", {"index": index, "k": k})["results"]

    def knn_new(self, vector: np.ndarray, k: int):
        return self._post("/knnnew", {
            "k": k, "ndarray": ndarray_to_b64(np.asarray(vector))})["results"]
