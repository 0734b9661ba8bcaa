"""ConvolutionalIterationListener: periodic activation-image capture.

Counterpart of deeplearning4j_tpu/ui/conv_listener.py (parity surface: the
reference's ConvolutionalIterationListener): every ``frequency``
iterations, run the last training batch's first example forward, tile
each convolutional layer's channel activations (NHWC) into one grayscale
grid and publish it as a base64 PNG under the session's
``<sid>/activations`` static-info key (served at /train/activations).

The batch is the network's ``_last_input``, a tensor on its device; the
extra forward runs after the step, outside any captured graph, through
``feed_forward`` (a MultiLayerNetwork) or the graph's own
``_activations``. PNGs come from Pillow when it is installed, else from a
stdlib encoder (zlib + struct): compare decoded pixels, not bytes.
"""

from __future__ import annotations

import base64
import io
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import host_array
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener


def _to_grid(act: np.ndarray, max_channels: int = 16, cols: int = 4):
    """(H, W, C) activation → tiled grayscale grid, per-channel normalized."""
    H, W, C = act.shape
    C = min(C, max_channels)
    cols = min(cols, C)
    rows = (C + cols - 1) // cols
    pad = 1
    grid = np.zeros((rows * (H + pad) + pad, cols * (W + pad) + pad), np.uint8)
    for c in range(C):
        a = act[:, :, c].astype(np.float64)
        lo, hi = a.min(), a.max()
        img = ((a - lo) / (hi - lo) * 255.0).astype(np.uint8) if hi > lo \
            else np.zeros_like(a, np.uint8)
        r, col = divmod(c, cols)
        y0 = pad + r * (H + pad)
        x0 = pad + col * (W + pad)
        grid[y0:y0 + H, x0:x0 + W] = img
    return grid


def _encode_png_gray(gray: np.ndarray) -> bytes:
    """Minimal stdlib grayscale PNG encoder (zlib + struct) — no Pillow
    dependency for the capture path (Pillow is not a declared dependency
    of this package; use it only if present)."""
    try:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(gray, mode="L").save(buf, format="PNG")
        return buf.getvalue()
    except ImportError:
        pass
    import struct
    import zlib
    h, w = gray.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)   # 8-bit grayscale
    raw = b"".join(b"\x00" + gray[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _png_b64(gray: np.ndarray) -> str:
    return base64.b64encode(_encode_png_gray(gray)).decode()


class ConvolutionalIterationListener(IterationListener):
    def __init__(self, storage, frequency: int = 10,
                 session_id: Optional[str] = None, max_channels: int = 16,
                 scale: int = 1):
        self.storage = storage
        self.frequency = max(1, frequency)
        self.session_id = session_id
        self.max_channels = max_channels
        self.scale = scale

    def _capture(self, model):
        """First example of the stashed batch → {layer: (H,W,C) ndarray}."""
        x = getattr(model, "_last_input", None)
        if x is None:
            return {}
        acts = {}
        if hasattr(model, "feed_forward"):            # MultiLayerNetwork
            for i, a in enumerate(model.feed_forward(x[:1])[1:]):
                if a.ndim == 4:                       # NHWC
                    acts[f"{i}:{type(model.layers[i]).__name__}"] = \
                        host_array(a)[0]
        else:                                         # ComputationGraph
            ins = [model._as_input(f)[:1] for f in x]
            with torch.no_grad():
                adict, _ = model._activations(model.params, ins,
                                              train=False)
            for name, a in adict.items():
                if a.ndim == 4 and name not in model.conf.network_inputs:
                    acts[name] = host_array(a)[0]
        return acts

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency != 0:
            return
        try:
            acts = self._capture(model)
        except Exception as e:  # noqa: BLE001 — a UI listener must never
            if not getattr(self, "_warned", False):     # abort training
                self._warned = True
                import warnings
                warnings.warn(f"activation capture failed: {e!r}")
            return
        if not acts:
            return
        sid = self.session_id or "default"
        images = {}
        for name, a in acts.items():
            grid = _to_grid(a, self.max_channels)
            if self.scale > 1:
                grid = np.kron(grid, np.ones((self.scale, self.scale),
                                             np.uint8))
            images[name] = _png_b64(grid)
        self.storage.put_static_info(f"{sid}/activations", {
            "iteration": iteration, "images": images})
