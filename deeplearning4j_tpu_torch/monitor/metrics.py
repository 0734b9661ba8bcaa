"""Process-wide pull metrics: Counter / Gauge / Histogram + Prometheus text.

Counterpart of deeplearning4j_tpu/monitor/metrics.py, the same behaviour
and the same names: metric FAMILIES addressed by name, label sets
addressing CHILDREN inside a family, fixed-bucket histograms rendered in
the Prometheus text exposition format, no dependency beyond the standard
library. The fit path publishes into it (``util.timing.PipelineTimer.
publish``, ``optimize.listeners.PerformanceListener``), the serving
path too (the batcher, the decode engine, the host KV tier), and the
server renders it at ``GET /metrics``.

Hot-path cost: one dict lookup + one locked float add per event;
instrumented code caches its children. ``registry.enabled = False`` turns
every record call into an early return.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_metrics_enabled",
    "DEFAULT_LATENCY_BUCKETS", "DEFAULT_STEP_BUCKETS",
]

# request/step latency buckets (seconds): sub-ms up to multi-second calls
DEFAULT_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                           0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# train-step dispatch buckets: same shape, one decade coarser at the top
# (a step that builds kernels or captures a graph takes seconds)
DEFAULT_STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                        0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0, 120.0)

_INF = float("inf")


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fnum(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    f = float(v)
    if f != f:
        return "NaN"
    return repr(f)


def _label_str(labelnames, labelvalues, extra=()) -> str:
    pairs = [f'{k}="{_escape_label(v)}"'
             for k, v in zip(labelnames, labelvalues)]
    pairs += [f'{k}="{_escape_label(v)}"' for k, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Child:
    """One (family, label-values) time series."""

    __slots__ = ("_reg", "_lock", "_labelvalues")

    def __init__(self, reg, labelvalues):
        self._reg = reg
        self._lock = threading.Lock()
        self._labelvalues = labelvalues


class Counter(_Child):
    """Monotonically increasing float (rendered with a ``_total`` name by
    convention — the family name you register should already end so)."""

    __slots__ = ("_value",)

    def __init__(self, reg, labelvalues):
        super().__init__(reg, labelvalues)
        self._value = 0.0

    def inc(self, n: float = 1.0):
        if not self._reg.enabled:
            return
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Child):
    """Settable value. ``set`` stores the raw object and ``value`` floats it
    at READ time -- so a device scalar (a 0-dim tensor on the card) can be
    set in the hot path with no host sync, and its ``.item()`` runs only
    when someone renders or reads the registry. ``set_function`` makes the
    gauge a live callback (a queue depth reads ``Queue.qsize`` at scrape
    time)."""

    __slots__ = ("_raw", "_fn")

    def __init__(self, reg, labelvalues):
        super().__init__(reg, labelvalues)
        self._raw = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v):
        if not self._reg.enabled:
            return
        with self._lock:
            self._raw = v

    def inc(self, n: float = 1.0):
        if not self._reg.enabled:
            return
        with self._lock:
            self._raw = float(self._raw) + n

    def dec(self, n: float = 1.0):
        self.inc(-n)

    def set_function(self, fn: Callable[[], float]):
        self._fn = fn
        return self

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return float(self._raw)


class Histogram(_Child):
    """Fixed-bucket histogram (cumulative ``le`` buckets + sum + count in
    the exposition; p50/p99 derivable by any Prometheus backend — or
    in-process via ``percentile``)."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_exemplars")

    def __init__(self, reg, labelvalues, buckets):
        super().__init__(reg, labelvalues)
        self.buckets = buckets            # finite upper bounds, ascending
        self._counts = [0] * (len(buckets) + 1)   # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        # last exemplar per bucket: (request_id, observed_value), so a
        # slow bucket resolves to a concrete request
        self._exemplars = [None] * (len(buckets) + 1)

    def observe(self, v: float, exemplar: Optional[str] = None):
        if not self._reg.enabled:
            return
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), float(v))

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def cumulative(self):
        """[(upper_bound, cumulative_count), ...] ending at (+Inf, count)."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, c in zip(tuple(self.buckets) + (_INF,), counts):
            cum += c
            out.append((b, cum))
        return out

    def exemplars(self):
        """[(upper_bound, request_id, observed_value), ...] for every
        bucket holding a last exemplar (+Inf bound included)."""
        with self._lock:
            ex = list(self._exemplars)
        out = []
        for b, e in zip(tuple(self.buckets) + (_INF,), ex):
            if e is not None:
                out.append((b, e[0], e[1]))
        return out

    def exemplar_for(self, v: float):
        """The last (request_id, observed_value) exemplar of the bucket
        that a value ``v`` falls into — e.g. ``exemplar_for(p99)`` links
        the p99 bucket to a request. None if that bucket never
        carried an exemplar."""
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._lock:
            return self._exemplars[i]

    def percentile(self, q: float) -> Optional[float]:
        """Linear-interpolated q-quantile (q in [0,1]) from the buckets;
        None when nothing was observed. Values beyond the last finite
        bound report that bound (same saturation Prometheus applies)."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if not total:
            return None
        target = q * total
        cum, lo = 0, 0.0
        for b, c in zip(tuple(self.buckets) + (_INF,), counts):
            prev = cum
            cum += c
            if cum >= target and c > 0:
                if not math.isfinite(b):
                    return lo
                frac = (target - prev) / c
                return lo + (b - lo) * max(0.0, min(1.0, frac))
            if math.isfinite(b):
                lo = b
        return lo


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A named metric + label schema; children are the actual series.
    With an empty label schema the family proxies to its single child, so
    ``reg.counter("x").inc()`` works without a ``labels()`` hop."""

    def __init__(self, reg, kind, name, help, labelnames, buckets=None):
        self._reg = reg
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self._children: Dict[Tuple, _Child] = {}
        self._lock = threading.Lock()

    def labels(self, **kv) -> _Child:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} wants labels {self.labelnames}, got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    cls = _KINDS[self.kind]
                    child = (cls(self._reg, key, self.buckets)
                             if self.kind == "histogram"
                             else cls(self._reg, key))
                    self._children[key] = child
        return child

    def children(self) -> Iterable[Tuple[Tuple, _Child]]:
        return list(self._children.items())

    # no-label convenience: the family acts as its own single child
    def _solo(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        return self.labels()

    def inc(self, n: float = 1.0):
        self._solo().inc(n)

    def dec(self, n: float = 1.0):
        self._solo().dec(n)

    def set(self, v):
        self._solo().set(v)

    def set_function(self, fn):
        return self._solo().set_function(fn)

    def observe(self, v: float, exemplar: Optional[str] = None):
        self._solo().observe(v, exemplar=exemplar)

    @property
    def value(self) -> float:
        return self._solo().value

    @property
    def sum(self) -> float:
        return self._solo().sum

    @property
    def count(self) -> int:
        return self._solo().count

    def cumulative(self):
        return self._solo().cumulative()

    def percentile(self, q: float):
        return self._solo().percentile(q)

    def exemplars(self):
        return self._solo().exemplars()

    def exemplar_for(self, v: float):
        return self._solo().exemplar_for(v)


class MetricsRegistry:
    """Thread-safe registry of metric families with Prometheus rendering.

    One process-wide instance (``get_registry()``) backs every
    instrumented path, so every reader sees the same numbers."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        self.enabled = True

    def _family(self, kind, name, help, labelnames, buckets=None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(self, kind, name, help, labelnames, buckets)
                    self._families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"{name} already registered as {fam.kind}, not {kind}")
        if tuple(labelnames) != fam.labelnames:
            raise ValueError(
                f"{name} already registered with labels {fam.labelnames}")
        return fam

    def counter(self, name, help="", labelnames=()) -> _Family:
        return self._family("counter", name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> _Family:
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS) -> _Family:
        return self._family("histogram", name, help, labelnames,
                            tuple(buckets))

    def get(self, name) -> Optional[_Family]:
        return self._families.get(name)

    def reset(self):
        """Drop every family (tests)."""
        with self._lock:
            self._families.clear()

    # ------------------------------------------------------------- exposition
    def render(self, exemplars: bool = False) -> str:
        """Prometheus text exposition format 0.0.4.

        ``exemplars=True`` appends an OpenMetrics-style exemplar
        (``# {request_id="..."} value``) to every histogram bucket line
        whose bucket carries one. Off by default: strict 0.0.4 parsers
        reject the suffix, so the flag is for OpenMetrics scrapers and
        humans chasing a bucket back to its request."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            children = fam.children()
            if not children:
                continue
            lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in sorted(children):
                ls = _label_str(fam.labelnames, key)
                if fam.kind == "histogram":
                    ex = (dict((b, (rid, v))
                               for b, rid, v in child.exemplars())
                          if exemplars else {})
                    for b, cum in child.cumulative():
                        bl = _label_str(fam.labelnames, key,
                                        extra=(("le", _fnum(b)),))
                        line = f"{name}_bucket{bl} {cum}"
                        if b in ex:
                            rid, v = ex[b]
                            line += (f' # {{request_id="{_escape_label(rid)}"'
                                     f"}} {_fnum(v)}")
                        lines.append(line)
                    lines.append(f"{name}_sum{ls} {_fnum(child.sum)}")
                    lines.append(f"{name}_count{ls} {child.count}")
                else:
                    lines.append(f"{name}{ls} {_fnum(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self, kinds=("counter", "gauge", "histogram")) -> dict:
        """Flat {series: value} dict for JSON embedding .
        Histograms contribute ``_sum``/``_count`` series only. Gauge
        callbacks and lazily-stored device scalars ARE evaluated here."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.kind not in kinds:
                continue
            for key, child in sorted(fam.children()):
                ls = _label_str(fam.labelnames, key)
                try:
                    if fam.kind == "histogram":
                        out[f"{name}_sum{ls}"] = round(child.sum, 6)
                        out[f"{name}_count{ls}"] = child.count
                    else:
                        out[f"{name}{ls}"] = round(float(child.value), 6)
                except Exception:
                    continue        # a dead gauge callback must not poison
        return out                  # the whole snapshot


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented path records into."""
    return _DEFAULT


def set_metrics_enabled(on: bool) -> None:
    """Master switch for the default registry: ``False`` turns every
    record call into an early return (scrape still serves last values)."""
    _DEFAULT.enabled = bool(on)
