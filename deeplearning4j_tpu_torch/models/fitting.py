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
feature and label arrays and whether it has a mask),
``_chunk_payload`` (stacked arrays as ``fit_scan``'s arguments),
``_step(*args, telemetry=False)`` (the device half of a train step) and
``_staged()`` (the updater state the fused update stages).

Observability (the JAX containers' wiring): ``fit`` runs inside
``monitor.profiling.profile_scope`` (``DL4JTPU_PROFILE``); every
``_fit_batch`` and ``fit_scan`` call records into a ``TrainMonitor``
(``dl4jtpu_train_*``; a compile event is a call that captured a graph);
the step graphs register as ``(caller, train_step_b{B})`` and
``apply_updates`` in the program registry; and with a flight recorder
attached (``attach_flight_recorder``) a sampled iteration runs the
sampled step (``train_step_b{B}_telemetry``), whose telemetry is recorded
once a step (``fit_scan``: every step; tBPTT: the batch's last chunk).

Tensor parallelism through the default mesh (the JAX containers on an
executor whose mesh has a ``model`` axis: ``DL4JTPU_MESH=model=m``,
``set_default_mesh`` or ``Executor(build_mesh(..., model_parallel=m))``):
every ``_fit_batch`` and ``fit_scan`` call runs its steps through the
captured TP gradient and update programs of parallel/wrapper.py, one
``ParallelWrapper`` over the executor's mesh that the container builds at
its first such call and keeps (its resident shards and split updater
state stay resident across calls, are rebuilt when ``set_params`` /
``init`` rebuild the optimizer and reloaded when the parameters moved
otherwise, ``_params_version``), and the gathered parameters and updater
state are written back into the container before the listeners fire.
A step's rows split over the data axis where ``Executor.shardable_rows``
holds (JAX's ``shard_data``), else one data slot's program takes the
whole batch: on one card both are the one program over every row (the
data axis is placement there), and the route is counted
(``tp_routes``). The update is the per-leaf one (JAX's ``fused =
model_size <= 1``). Truncated BPTT runs each chunk as one such step,
the recurrent carries entering it detached and coming back from the
gradient program as on one slot. With a flight recorder a sampled
iteration replays the sampled update (``dp_apply_updates_telemetry``,
captured beside the plain one), whose (L, 5) rows run over each layer's
shard leaves together: the rows of the one-slot step, in the container's
layer order. A mesh without a model axis keeps the path above.

The pre-processor seam is the JAX stream's (``_resolve_device_pp``): a
pre-processor on the iterator chain (``data.iterators.
resolve_pre_processor``) with ``device_side`` set is not applied by the
iterator; its ``as_device_transform()`` (torch ops) runs on the card on
every feature array of a chunk or batch, right after the copy, on the
prefetcher's copy stream (on the consumer's stream without a
prefetcher). A uint8 image batch crosses the link at a byte a pixel and
is scaled on the card. A ``device_side`` pre-processor with no device
transform is applied on the host instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import Counter

import numpy as np

from deeplearning4j_tpu_torch.monitor.profiling import profile_scope
from deeplearning4j_tpu_torch.monitor.tracing import trace


class FitContract:
    # chunk caps: bounded host-side staging memory for a stacked block
    _CHUNK_MAX_STEPS = 64
    _CHUNK_MAX_BYTES = 256 << 20
    # device-resident prefetch depth of the streamed fit (0: none)
    prefetch_depth = 2
    # per-stage timing summary of the last streamed epoch
    last_pipeline_stats = None
    _flight = None        # FlightRecorder (monitor/flight.py)
    _train_mon = None     # lazy TrainMonitor (monitor/hooks.py)
    _telem = None         # the last sampled step's telemetry
    _tp_runner = None     # the TP trainer over the executor's mesh (lazy)
    _tp_live = None       # that trainer while a fit call runs on it
    _tp_counts = None     # steps by shard route ("data" / "whole")

    # ------------------------------------------------------------- steps
    def _build_step_graphs(self):
        """The step graphs (exec/executor.py): the plain train step, the
        sampled one (with the flight recorder's telemetry) and the update
        of ``apply_external_updates``; drops every captured graph."""
        ex, caller = self._executor, self._prog_caller
        self._steps = ex.steps(self._step, generator=self._gen,
                               caller=caller)
        self._steps_rec = ex.steps(self._step_sampled, generator=self._gen,
                                   caller=caller,
                                   name="train_step_b{B}_telemetry")
        self._updates = ex.steps(self._dp_apply_updates, caller=caller,
                                 name="apply_updates")

    def _step_sampled(self, *args):
        return self._step(*args, telemetry=True)

    @property
    def _capture_count(self) -> int:
        """CUDA graphs captured since the optimizer was built (the JAX
        package's ``_compile_count``), the TP trainer's included."""
        n = (self._steps.captures + self._steps_rec.captures
             + self._updates.captures)
        pw = self._tp_runner
        if pw is not None and pw._grad is not None \
                and pw._built_for is self._steps:
            n += pw._grad.captures + pw._upd.captures + pw._upd_rec.captures
        return n

    # ------------------------------------------------- tensor parallelism
    def _tp_trainer(self):
        """The TP trainer of the container's own fit path: a
        ``ParallelWrapper`` over the executor's mesh when its model axis
        is > 1 (built at the first such call, anew for another mesh),
        else None."""
        ex = self._executor
        if ex.model_size <= 1:
            return None
        pw = self._tp_runner
        if pw is None or pw.mesh is not ex.mesh:
            from deeplearning4j_tpu_torch.parallel.wrapper import \
                ParallelWrapper
            pw = self._tp_runner = ParallelWrapper(self, mesh=ex.mesh)
        return pw

    @contextlib.contextmanager
    def _tp_scope(self):
        """One ``_fit_batch`` / ``fit_scan`` call's steps on the model
        axis (module docstring): the resident shards brought up to date
        with the container first, the gathered parameters and updater
        state written back after. Without a model axis, nothing."""
        pw = self._tp_trainer()
        if pw is None:
            yield
            return
        pw._tp_sync()
        if self._flight is not None:
            from deeplearning4j_tpu_torch.monitor.flight import \
                prepare_telemetry
            prepare_telemetry(self, pw._tp.params)
        self._tp_live = pw
        try:
            yield
        finally:
            self._tp_live = None
            pw._tp_store()

    def _tp_step(self, iteration, xs, ys, mls, mfs, carries=None):
        """One train step at ``iteration`` through the TP trainer's
        captured programs (lists of inputs, labels, label masks and
        feature masks, None where absent) from ``carries``; returns (loss,
        new carries) and leaves a sampled step's telemetry in
        ``_telem``."""
        from deeplearning4j_tpu_torch.parallel.wrapper import _Batch
        rows = int(xs[0].shape[0])
        if self._tp_counts is None:
            self._tp_counts = Counter()
        self._tp_counts["data" if self._executor.shardable_rows(rows)
                        else "whole"] += 1
        rec = self._flight
        loss, new, telem = self._tp_live._sync_step(
            _Batch(xs, ys, mfs, mls), None, iteration, carries=carries,
            telemetry=rec is not None and rec.sampled(iteration))
        if telem is not None:
            self._telem = telem
        return loss, new

    @property
    def tp_routes(self) -> dict:
        """Steps taken on the model axis by shard route: ``data`` (rows
        split over the data axis) and ``whole`` (one data slot's program
        over the batch)."""
        return dict(self._tp_counts or {})

    def _run(self, graphs, fn, *args):
        """``fn(*args)`` (``fn`` is ``graphs``' function) with the fused
        update's scalars staged before and its counts advanced after:
        through ``graphs``, captured on the card, eagerly on the CPU, with
        the fused update off, or for the eager oracle (``_capture_steps``
        False)."""
        self._params_version += 1
        if self._fused is None:
            return graphs(*args, eager=True)
        opt = self._staged()
        self._fused.stage(opt)
        out = graphs(*args, eager=not self._capture_steps)
        self._fused.advance(opt)
        return out

    def _sampled_or_plain(self, iteration, *args):
        """The train step at ``iteration``: the sampled graph where the
        recorder samples it (its telemetry left in ``_telem``), else the
        plain one. Returns (loss, new carries)."""
        rec = self._flight
        if rec is None or not rec.sampled(iteration):
            return self._run(self._steps, self._step, *args)
        loss, carries, self._telem = self._run(self._steps_rec,
                                               self._step_sampled, *args)
        return loss, carries

    def _flight_record(self, iteration):
        """Hand the last sampled step's telemetry to the recorder (copied
        to the host there, without blocking)."""
        if self._telem is not None:
            self._flight.record(iteration, self._telem)
            self._telem = None

    def attach_flight_recorder(self, recorder):
        """Attach (or detach, with None) a ``monitor.flight.FlightRecorder``.
        Sampled iterations then run the sampled step, captured once per
        signature; the others replay the recorder-off graph."""
        self._flight = recorder
        self._telem = None
        if recorder is not None:
            from deeplearning4j_tpu_torch.monitor.flight import \
                prepare_telemetry
            recorder.bind(self)
            prepare_telemetry(self)

    @property
    def _mon(self):
        if self._train_mon is None:
            from deeplearning4j_tpu_torch.monitor.hooks import TrainMonitor
            self._train_mon = TrainMonitor(type(self).__name__)
        return self._train_mon

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
        (parity: the JAX containers' ``fit``). ``DL4JTPU_PROFILE=dir``
        profiles the whole call into ``dir``."""
        with profile_scope():
            return self._fit_impl(data, labels, epochs, prefetch,
                                  checkpoint, resume_from)

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

    @staticmethod
    def _resolve_device_pp(data):
        """(device transform, host pre-processor) of ``data``'s
        ``device_side`` pre-processor; (None, None) without one."""
        from deeplearning4j_tpu_torch.data.iterators import \
            resolve_pre_processor
        pp = resolve_pre_processor(data)
        if pp is None or not getattr(pp, "device_side", False):
            return None, None
        fn = pp.as_device_transform()
        return (fn, None) if fn is not None else (None, pp)

    def _dev_item(self, item, dev_fn):
        """A stream item with ``dev_fn`` applied on the device to each of
        its feature arrays."""
        from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
        from deeplearning4j_tpu_torch.models.multi_layer_network import \
            to_device

        def f(a):
            return dev_fn(to_device(a, self.device))
        kind, payload = item
        if kind == "chunk":
            xs, ys = payload
            return kind, ([f(a) for a in xs] if isinstance(xs, list)
                          else f(xs), ys)
        if isinstance(payload, MultiDataSet):
            return kind, dataclasses.replace(
                payload, features=[f(a) for a in payload.features])
        return kind, dataclasses.replace(payload, features=f(payload.features))

    def _chunk_len(self, features, labels) -> int:
        """Steps a chunk of batches of these arrays may hold."""
        per = sum(np.asarray(a).nbytes for a in (*features, *labels))
        return max(1, min(self._CHUNK_MAX_STEPS,
                          self._CHUNK_MAX_BYTES // max(1, per)))

    def _stream_chunks(self, data, timer, skip_batches=0, host_pp=None):
        """Host stage of the streamed fit: pull batches (``host_pp``
        applied to each), stack runs of mask-free same-shape batches.
        Yields ``("chunk", payload)`` (``fit_scan``'s arguments, stacked
        numpy blocks) or ``("batch", batch)``, in the iterator's order."""
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
            if host_pp is not None:
                with timer.stage("decode"):
                    item = host_pp.pre_process(item)
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
        dev_fn, host_pp = self._resolve_device_pp(data)
        depth = self.prefetch_depth if prefetch is None else int(prefetch)
        timer = PipelineTimer()
        stream = self._stream_chunks(data, timer, skip_batches=skip_batches,
                                     host_pp=host_pp)
        transform = (None if dev_fn is None
                     else lambda item: self._dev_item(item, dev_fn))
        if depth > 0:
            stream = DevicePrefetcher(stream, depth=depth,
                                      device=self.device,
                                      transform=transform, timer=timer)
        elif transform is not None:
            stream = map(transform, stream)
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
