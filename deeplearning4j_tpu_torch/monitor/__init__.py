"""Observability: the pull-metrics registry, the span tracer and the
request journal (see metrics.py, tracing.py and reqlog.py). Profiling, the
flight recorder, SLOs and fleet collection are not ported yet."""

from deeplearning4j_tpu_torch.monitor.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, DEFAULT_STEP_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, get_registry, set_metrics_enabled)
from deeplearning4j_tpu_torch.monitor.reqlog import (  # noqa: F401
    RequestLog, new_record)
from deeplearning4j_tpu_torch.monitor.tracing import (  # noqa: F401
    Tracer, get_tracer, trace)
