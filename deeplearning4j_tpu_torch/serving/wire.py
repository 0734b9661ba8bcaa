"""The ndarray wire format of the HTTP endpoints: base64 of raw
little-endian float32 plus a shape header (a copy of the helpers in
deeplearning4j_tpu/clustering/knn_server.py, so both packages' servers and
clients speak the same bytes)."""

from __future__ import annotations

import base64

import numpy as np


def ndarray_to_b64(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a, dtype=np.float32)
    return {"shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode()}


def ndarray_from_b64(obj: dict) -> np.ndarray:
    raw = base64.b64decode(obj["data"])
    return np.frombuffer(raw, dtype=np.float32).reshape(obj["shape"]).copy()
