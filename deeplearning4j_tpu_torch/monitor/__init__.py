"""Observability: the pull-metrics registry and the span tracer (see
metrics.py and tracing.py). Profiling, the flight recorder, SLOs, request
journals and fleet collection are not ported yet."""

from deeplearning4j_tpu_torch.monitor.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, DEFAULT_STEP_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, get_registry, set_metrics_enabled)
from deeplearning4j_tpu_torch.monitor.tracing import (  # noqa: F401
    Tracer, get_tracer, trace)
