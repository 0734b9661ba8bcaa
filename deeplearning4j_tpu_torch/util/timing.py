"""Input-pipeline accounting for the streamed fit path.

Counterpart of ``PipelineTimer`` in deeplearning4j_tpu/util/timing.py (the
same stages, ``summary()`` keys and published metric names). Its host
clocks time dispatch: a stage that launches device work returns before the
card has run it, and nothing here synchronizes the card. The JAX module's
device timers (``time_op``, ``host_sync``) are not ported; ``chip_smoke.py``
times the card with CUDA events and ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from deeplearning4j_tpu_torch.monitor.tracing import trace


class PipelineTimer:
    """Per-stage input-pipeline accounting (fetch / stack / h2d / step).

    The containers' streamed fit path records how long the consumer loop
    spends in each stage; ``host_stall_frac()`` is the fraction of the
    epoch's wall time the host spent waiting on data instead of
    dispatching device work.

    Stage conventions used by ``_fit_stream``:

    - ``wait`` -- the consumer blocked in ``next()`` on the input stream.
      With the prefetcher on, this is the only stall the host sees (the
      fetch / stack / h2d work happens inside it or ahead of it).
    - ``fetch`` / ``decode`` / ``h2d`` -- sub-stage costs recorded by the
      stream and the prefetcher; they may nest inside ``wait``, so they
      are not summed into the stall when ``wait`` was recorded.
    - ``step`` -- train-step dispatch (on the card: enqueue or replay
      launch time, not device time).

    ``host_stall_frac`` = wait / wall when ``wait`` was recorded, else
    (fetch + decode + h2d) / wall."""

    _STALL_FALLBACK = ("fetch", "decode", "h2d")

    def __init__(self):
        self.seconds = {}
        self.counts = {}
        self._t0 = None
        self.wall = 0.0

    def add(self, stage: str, sec: float):
        self.seconds[stage] = self.seconds.get(stage, 0.0) + sec
        self.counts[stage] = self.counts.get(stage, 0) + 1

    @contextmanager
    def stage(self, name: str):
        # every timed stage is also a trace span (a no-op while tracing is
        # off), so the timeline and the stage totals agree
        with trace.span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(name, time.perf_counter() - t0)

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self._t0 is not None:
            self.wall += time.perf_counter() - self._t0
            self._t0 = None
        return self

    def host_stall_frac(self):
        if not self.wall:
            return None
        if "wait" in self.seconds:
            stall = self.seconds["wait"]
        else:
            stall = sum(self.seconds.get(s, 0.0)
                        for s in self._STALL_FALLBACK)
        return min(1.0, stall / self.wall)

    def summary(self) -> dict:
        out = {"wall_sec": round(self.wall, 4),
               "host_stall_frac": self.host_stall_frac()}
        if out["host_stall_frac"] is not None:
            out["host_stall_frac"] = round(out["host_stall_frac"], 4)
        for k in sorted(self.seconds):
            out[f"{k}_sec"] = round(self.seconds[k], 4)
        return out

    def publish(self, path: str):
        """Add this timer's stage totals to the process-wide registry
        (``path`` labels the pipeline, "fit"): stage and wall counters
        accumulate across epochs, the stall-fraction gauge holds the last
        epoch's value."""
        from deeplearning4j_tpu_torch.monitor.metrics import get_registry
        reg = get_registry()
        fam = reg.counter(
            "dl4jtpu_pipeline_stage_seconds_total",
            "Cumulative input-pipeline stage seconds (see PipelineTimer "
            "stage conventions).", ("path", "stage"))
        for stage, sec in self.seconds.items():
            fam.labels(path=path, stage=stage).inc(sec)
        reg.counter(
            "dl4jtpu_pipeline_wall_seconds_total",
            "Cumulative wall seconds of streamed fit/eval epochs.",
            ("path",)).labels(path=path).inc(self.wall)
        frac = self.host_stall_frac()
        if frac is not None:
            reg.gauge(
                "dl4jtpu_pipeline_host_stall_frac",
                "Fraction of the last epoch's wall time the host spent "
                "blocked waiting on data.",
                ("path",)).labels(path=path).set(frac)
        return self
