"""The containers' ``fit`` contract, shared by MultiLayerNetwork and
ComputationGraph.

Counterpart of the fit loop the JAX package writes out in each container
(``fit``, ``_fit_impl``, ``_resume_training``, ``_stream_chunks``,
``_fit_stream``, the listener calls; deeplearning4j_tpu/models/
multi_layer_network.py and computation_graph.py), with the same call
sequences:

- ``fit(data, labels)`` or ``fit(DataSet)`` is one batch;
- ``fit(iterator, epochs=N)`` streams each epoch: the iterator is reset,
  iterated once, and runs of mask-free, same-shape batches are stacked
  into chunks of up to ``_CHUNK_MAX_STEPS`` steps or ``_CHUNK_MAX_BYTES``
  bytes (per container, overridable on the instance), each trained by
  ``fit_scan``; a masked batch, a batch of another shape, a lone batch and
  every batch of a truncated-BPTT network train alone through
  ``_fit_batch``. The chunk boundaries do not depend on the prefetch
  depth, and a chunk's steps are the steps ``_fit_batch`` would run, so
  the parameters are the same bits with prefetch on or off;
- the stream is staged on the device ``prefetch`` items ahead
  (``data.prefetcher.DevicePrefetcher``; None: ``prefetch_depth``, 0: no
  prefetcher), its stages timed into ``last_pipeline_stats`` and
  published to the metrics registry;
- listeners' ``iteration_done`` fires after every ``_fit_batch`` and
  every ``fit_scan`` call, ``on_epoch_end`` after every epoch;
- ``checkpoint`` (a ``resilience.CheckpointListener``, or a directory:
  one save per epoch) is a listener for the duration of the call;
  ``resume_from`` (a checkpoint zip, or a directory: its latest) restores
  the network in place and winds the iterator to where that run stood:
  one ``reset()`` and one ``iter()`` per completed epoch, consumed by
  hand, then the partial epoch's trained batches skipped. The resumed run
  then trains the same steps on the same batches as the uninterrupted
  one, which on the card means the same bits.

A container supplies ``_check_trainable``, ``_fit_batch``, ``fit_scan``,
``_direct_batch`` (a bare batch, or None for an iterator),
``_stream_batch`` (an iterator's item as the container's batch, with its
feature and label arrays and whether it has a mask) and
``_chunk_payload`` (stacked arrays as ``fit_scan``'s arguments). The
device-side pre-processor seam of the JAX stream waits for
``data/normalizers.py``.
"""

from __future__ import annotations

import os
import time

import numpy as np

from deeplearning4j_tpu_torch.monitor.tracing import trace


class FitContract:
    # chunk caps: bounded host-side staging memory for a stacked block
    _CHUNK_MAX_STEPS = 64
    _CHUNK_MAX_BYTES = 256 << 20
    # device-resident prefetch depth of the streamed fit (0: none)
    prefetch_depth = 2
    # per-stage timing summary of the last streamed epoch
    last_pipeline_stats = None

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def _fire_listeners(self):
        if self.listeners:
            with trace.span("callback"):
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration, self.epoch)

    def fit(self, data, labels=None, epochs=1, prefetch=None,
            checkpoint=None, resume_from=None):
        """fit(inputs, labels) | fit(DataSet) | fit(iterator, epochs=N)
        (a ComputationGraph also takes a MultiDataSet, and lists of
        arrays, one per network input and output); ``prefetch``,
        ``checkpoint`` and ``resume_from`` as the module docstring says
        (parity: the JAX containers' ``fit``)."""
        return self._fit_impl(data, labels, epochs, prefetch, checkpoint,
                              resume_from)

    def _fit_impl(self, data, labels, epochs, prefetch, checkpoint,
                  resume_from):
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            CheckpointListener)
        if resume_from is None:
            self._check_trainable()
        ckpt = None
        if checkpoint is not None:
            ckpt = (checkpoint if isinstance(checkpoint, CheckpointListener)
                    else CheckpointListener(checkpoint, every_n_epochs=1))
            self.listeners.append(ckpt)
        try:
            batch = self._direct_batch(data, labels)
            if batch is not None:
                if resume_from is not None:
                    raise ValueError(
                        "resume_from needs resettable iterator data; a bare "
                        "array/DataSet fit has no epoch stream to replay")
                return self._fit_batch(batch)
            n_epochs, skip = epochs, 0
            if resume_from is not None:
                if not hasattr(data, "reset"):
                    raise ValueError(
                        "resume_from needs a resettable iterator (reset()) "
                        "to replay the stream to the crash position")
                skip = self._resume_training(resume_from, data)
                n_epochs = max(0, epochs - self.epoch)
            for k in range(n_epochs):
                if hasattr(data, "reset"):
                    data.reset()
                self._fit_stream(data, prefetch=prefetch,
                                 skip_batches=skip if k == 0 else 0)
                self.epoch += 1
                self._epoch_batch = 0
                for lst in self.listeners:
                    if hasattr(lst, "on_epoch_end"):
                        lst.on_epoch_end(self)
            return self
        finally:
            if ckpt is not None:
                self.listeners.remove(ckpt)

    def _resume_training(self, resume_from, data):
        """Restore from a checkpoint (a zip, or a directory's latest) in
        place and wind ``data`` forward to where that run stood. Returns
        the number of batches to skip in the first (partial) epoch."""
        from deeplearning4j_tpu_torch.resilience.checkpoint import (
            latest_checkpoint)
        from deeplearning4j_tpu_torch.util.model_serializer import \
            restore_into
        path = os.fspath(resume_from)
        if os.path.isdir(path):
            found = latest_checkpoint(path)
            if found is None:
                raise FileNotFoundError(
                    f"resume_from: no checkpoints in directory {path}")
            path = found
        restore_into(self, path)
        # the uninterrupted run did reset() (fit loop) + ONE iter()
        # (_stream_chunks) + full consumption per epoch; a stateful
        # iterator must see the same calls (``for _ in iter(data)`` would
        # call __iter__ twice), so next() is driven by hand
        for _ in range(self.epoch):
            data.reset()
            it = iter(data)
            while True:
                try:
                    next(it)
                except StopIteration:
                    break
        return self._epoch_batch

    def _chunk_len(self, features, labels) -> int:
        """Steps a chunk of batches of these arrays may hold."""
        per = sum(np.asarray(a).nbytes for a in (*features, *labels))
        return max(1, min(self._CHUNK_MAX_STEPS,
                          self._CHUNK_MAX_BYTES // max(1, per)))

    def _stream_chunks(self, data, timer, skip_batches=0):
        """Host stage of the streamed fit: pull batches, stack runs of
        mask-free same-shape batches. Yields ``("chunk", payload)``
        (``fit_scan``'s arguments, stacked numpy blocks) or ``("batch",
        batch)``, in the iterator's order."""
        chunkable = self.conf.backprop_type != "tbptt"
        buf, shape = [], None

        def flush():
            nonlocal buf, shape
            out = None
            if len(buf) == 1:
                out = ("batch", buf[0][0])
            elif buf:
                with timer.stage("stack"):
                    xs = [np.stack([np.asarray(b[1][i]) for b in buf])
                          for i in range(len(buf[0][1]))]
                    ys = [np.stack([np.asarray(b[2][i]) for b in buf])
                          for i in range(len(buf[0][2]))]
                    out = ("chunk", self._chunk_payload(xs, ys))
            buf, shape = [], None
            return out

        it = iter(data)
        for _ in range(skip_batches):
            # resume: trained before the interruption; pull and drop them
            # so the stream (and any iterator state) advances as it did
            try:
                next(it)
            except StopIteration:
                return
        while True:
            t0 = time.perf_counter()
            try:
                with trace.span("fetch"):
                    item = next(it)
            except StopIteration:
                break
            timer.add("fetch", time.perf_counter() - t0)
            batch, features, labels, has_mask = self._stream_batch(item)
            if not chunkable or has_mask:
                out = flush()
                if out is not None:
                    yield out
                yield ("batch", batch)
                continue
            key = (tuple(np.shape(f) for f in features),
                   tuple(np.shape(y) for y in labels))
            if shape is not None and key != shape:
                out = flush()
                if out is not None:
                    yield out
            shape = key
            buf.append((batch, features, labels))
            if len(buf) >= self._chunk_len(features, labels):
                yield flush()
        out = flush()
        if out is not None:
            yield out

    def _fit_stream(self, data, prefetch=None, skip_batches=0):
        """One epoch over an iterator: host chunk assembly, the device
        prefetch, the steps. Per-stage timing lands in
        ``last_pipeline_stats``; its ``host_stall_frac`` is the share of
        the epoch's wall time the consumer spent waiting on data."""
        from deeplearning4j_tpu_torch.data.prefetcher import DevicePrefetcher
        from deeplearning4j_tpu_torch.util.timing import PipelineTimer
        depth = self.prefetch_depth if prefetch is None else int(prefetch)
        timer = PipelineTimer()
        stream = self._stream_chunks(data, timer, skip_batches=skip_batches)
        if depth > 0:
            stream = DevicePrefetcher(stream, depth=depth,
                                      device=self.device, timer=timer)
        it = iter(stream)
        timer.start()
        while True:
            with trace.span("train_step"):
                with timer.stage("wait"):
                    try:
                        kind, payload = next(it)
                    except StopIteration:
                        break
                with timer.stage("step"):
                    if kind == "chunk":
                        self.fit_scan(*payload)
                    else:
                        self._fit_batch(payload)
        timer.stop()
        self.last_pipeline_stats = timer.summary()
        timer.publish("fit")
