"""Batched data-parallel inference.

Counterpart of deeplearning4j_tpu/parallel/inference.py:
``ParallelInference`` with ``output`` and the dynamic batcher (``start``,
``submit``, ``shutdown``, ``batch_timeout_ms``, ``max_batch_size``).

``output(x)`` pads the batch to a multiple of the mesh's slots (with
copies of its last row, as JAX does) and splits it over them: the slots
of one rank share its device, so a rank's rows are ONE call of the
model's ``output`` (the bucketed engine: K4 for TextGenerationLSTM, K5 for
TinyTransformer). In a process group each rank computes its
``local_batch_slice`` of the padded batch and the rows are all-gathered.

The batcher is a worker thread that merges queued requests up to
``max_batch_size`` rows or ``batch_timeout_ms`` and runs ``output`` on
them. It captures nothing: a bucketed engine captures only in its
``warmup()``, and ``warmup`` here runs that on the caller's thread
before the worker starts (a capture is global to the process, so none
may happen on the worker while another thread runs CUDA work); rungs
not warmed run eagerly.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.exec.mesh import Mesh
from deeplearning4j_tpu_torch.parallel.distributed import (local_batch_slice,
                                                           topology)
from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh


class ParallelInference:
    def __init__(self, model, mesh: Optional[Mesh] = None,
                 max_batch_size: int = 256, batch_timeout_ms: float = 2.0):
        self.model = model
        self.mesh = mesh if mesh is not None else default_mesh(
            device=model.device)
        self.n_devices = self.mesh.devices.size
        self.max_batch_size = max_batch_size
        self.batch_timeout_ms = batch_timeout_ms
        self._q: "queue.Queue" = queue.Queue()
        self._thread = None
        self._stop = threading.Event()

    def warmup(self, example_shape, max_batch: Optional[int] = None):
        """Capture the model's bucketed engine over its ladder up to
        ``max_batch`` (default ``max_batch_size``) rows of
        ``example_shape`` on the caller's thread (serving/engine.py)."""
        eng = self.model.serving_engine()
        return eng.warmup(example_shape,
                          max_batch=min(max_batch or self.max_batch_size,
                                        eng.max_batch))

    # ---------------------------------------------------------- sync output
    def output(self, x) -> torch.Tensor:
        """The model's output on ``x``: padded to a slot multiple, one call
        of the model's ``output`` a rank, the pad rows sliced off."""
        x = self.model._as_input(x)
        b = x.shape[0]
        pad = (-b) % self.n_devices
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        if not (dist.is_available() and dist.is_initialized()):
            return self.model.output(x)[:b]
        _, world = topology()
        out = self.model.output(x[local_batch_slice(x.shape[0])])
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out.contiguous())
        return torch.cat(parts)[:b]

    # ------------------------------------------------------ async (batched)
    def start(self):
        """Start the dynamic-batching worker (parity: the observable
        queue)."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def worker():
            while not self._stop.is_set():
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                batch = [first]
                total = first[0].shape[0]
                deadline = self.batch_timeout_ms / 1000.0
                t0 = time.perf_counter()
                while (total < self.max_batch_size
                       and (time.perf_counter() - t0) < deadline):
                    try:
                        item = self._q.get_nowait()
                        batch.append(item)
                        total += item[0].shape[0]
                    except queue.Empty:
                        break
                try:
                    out = self.output(torch.cat([b[0] for b in batch]))
                    ofs = 0
                    for x, fut in batch:
                        fut.set_result(out[ofs:ofs + x.shape[0]])
                        ofs += x.shape[0]
                except Exception as e:      # noqa: BLE001 -- to the callers
                    for _, fut in batch:
                        fut.set_exception(e)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        return self

    def submit(self, x) -> Future:
        """Submit a request; merged with concurrent requests into one
        batch."""
        if self._thread is None:
            self.start()
        fut: Future = Future()
        self._q.put((self.model._as_input(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x), fut))
        return fut

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
