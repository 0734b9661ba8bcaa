"""Observability: pull metrics, span tracing, the request journal, SLOs,
profiling, the training flight recorder and fleet collection.

Counterpart of deeplearning4j_tpu/monitor/__init__.py, with its names:

- ``metrics``: the process-wide registry of Counter / Gauge / Histogram
  families rendered as Prometheus text (``GET /metrics``).
- ``tracing``: the ring-buffered span tracer (Chrome trace-event JSON,
  ``GET /trace``) with ``TraceContext`` and the ``x-trace-context``
  header; timestamps share the wall-clock epoch, so
  ``collect.collect_fleet_trace`` merges several processes' buffers.
- ``slo.BurnRateSLO``: two-window burn-rate health (``/healthz``).
- ``profiling``: ``torch.profiler`` sessions (``POST /admin/profile``,
  ``DL4JTPU_PROFILE=dir`` around ``fit()``).
- ``reqlog``: the wide-event request journal (``GET /requests``).
- ``flight``: the training flight recorder, its telemetry computed inside
  the captured train step (``GET /train/diagnostics``).
- ``hooks.TrainMonitor``: the ``dl4jtpu_train_*`` families of the fit
  paths.
"""

from deeplearning4j_tpu_torch.monitor.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, DEFAULT_STEP_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, get_registry, set_metrics_enabled)
from deeplearning4j_tpu_torch.monitor.tracing import (  # noqa: F401
    TraceContext, Tracer, get_context, get_tracer, set_context, trace,
    trace_context)
from deeplearning4j_tpu_torch.monitor.slo import (  # noqa: F401
    BurnRateSLO, SLOState)
from deeplearning4j_tpu_torch.monitor.collect import (  # noqa: F401
    collect_fleet_trace, collect_requests, flight_counter_events, merge_docs)
from deeplearning4j_tpu_torch.monitor.reqlog import (  # noqa: F401
    RequestLog, new_record)
from deeplearning4j_tpu_torch.monitor.flight import (  # noqa: F401
    STAT_COLS, AnomalyDetector, FlightRecorder)
from deeplearning4j_tpu_torch.monitor.profiling import (  # noqa: F401
    profile_scope, profile_status, start_profile)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_metrics_enabled",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_STEP_BUCKETS",
    "Tracer", "trace", "get_tracer",
    "TraceContext", "set_context", "get_context", "trace_context",
    "BurnRateSLO", "SLOState",
    "collect_fleet_trace", "collect_requests", "merge_docs",
    "flight_counter_events", "RequestLog", "new_record",
    "FlightRecorder", "AnomalyDetector", "STAT_COLS",
    "start_profile", "profile_status", "profile_scope",
]
