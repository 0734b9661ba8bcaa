"""Multi-window burn-rate SLO evaluation over registry counters.

Counterpart of deeplearning4j_tpu/monitor/slo.py (the same windows,
thresholds, gauges and ``SLOState``).

The health half of fleet observability: instead of "did the last probe
succeed", health is judged the way *The Site Reliability Workbook*
(Beyer et al., 2018, ch. 5) recommends — by how fast the error budget is
burning, measured over two windows at once. The burn rate of a window is

    burn = error_rate(window) / (1 - objective)

i.e. burn 1.0 spends exactly the whole budget over the SLO period. A
*fast burn* fires only when BOTH the short (default 5 m) and long
(default 1 h) windows exceed the threshold: the long window keeps a
brief error blip from paging, the short window makes recovery re-admit
quickly — once the storm stops, the 5 m window clears and the AND goes
false even while the 1 h window is still digesting.

The evaluator is pull-based: it reads cumulative ``bad`` / ``total``
callables (registry counter cells — the same cells ``/metrics`` renders)
and keeps a pruned deque of snapshots, so it costs nothing between
``evaluate()`` calls. ``InferenceServer.health_info`` calls
``evaluate()`` per probe; a fast burn flips
``/healthz`` to ``degraded`` with the SLO detail attached, and the
state is exported as ``dl4jtpu_slo_burn_rate{slo,window}`` +
``dl4jtpu_slo_budget_remaining{slo}`` gauges.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from .metrics import get_registry

__all__ = ["BurnRateSLO", "SLOState"]


class SLOState:
    """Result of one ``evaluate()``: the two window burn rates, the
    remaining long-window error budget, and the verdict."""

    __slots__ = ("name", "objective", "burn_short", "burn_long",
                 "budget_remaining", "fast_burn")

    def __init__(self, name, objective, burn_short, burn_long,
                 budget_remaining, fast_burn):
        self.name = name
        self.objective = objective
        self.burn_short = burn_short
        self.burn_long = burn_long
        self.budget_remaining = budget_remaining
        self.fast_burn = fast_burn

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "objective": self.objective,
            "burn_rate_short": round(self.burn_short, 3),
            "burn_rate_long": round(self.burn_long, 3),
            "budget_remaining": round(self.budget_remaining, 4),
            "fast_burn": self.fast_burn,
        }


def _slo_gauges():
    reg = get_registry()
    burn = reg.gauge(
        "dl4jtpu_slo_burn_rate",
        "error-budget burn rate per evaluation window "
        "(1.0 = spending exactly the whole budget over the SLO period)",
        labelnames=("slo", "window"))
    budget = reg.gauge(
        "dl4jtpu_slo_budget_remaining",
        "fraction of the long-window error budget still unspent (0..1)",
        labelnames=("slo",))
    return burn, budget


class BurnRateSLO:
    """Two-window burn-rate evaluator over cumulative counters.

    Parameters
    ----------
    name: SLO identity — the ``slo`` gauge label and healthz detail name.
    bad_fn / total_fn: zero-arg callables returning *cumulative* event
        counts (monotone, e.g. registry counter values). ``bad`` must be
        a subset of ``total``.
    objective: availability target; the error budget is ``1-objective``.
    short_s / long_s: the two window lengths (SRE Workbook: 5 m / 1 h).
    fast_threshold: burn rate both windows must exceed to degrade. The
        default 14.4 is the workbook's page-level burn for a 99.9%
        30-day SLO; with lenient test objectives it simply means
        "errors arriving ≥ 14x faster than the budget allows".
    min_events: windows with fewer total events report burn 0 — a single
        failed request in an idle process must not flip health.
    clock: injectable monotonic clock (tests drive a fake one).
    """

    def __init__(self, name: str,
                 bad_fn: Callable[[], float],
                 total_fn: Callable[[], float],
                 objective: float = 0.999,
                 short_s: float = 300.0,
                 long_s: float = 3600.0,
                 fast_threshold: float = 14.4,
                 min_events: int = 20,
                 clock: Callable[[], float] = time.monotonic,
                 min_tick_s: float = 0.25):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0,1), got {objective}")
        self.name = name
        self.objective = float(objective)
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.fast_threshold = float(fast_threshold)
        self.min_events = int(min_events)
        self._bad_fn = bad_fn
        self._total_fn = total_fn
        self._clock = clock
        self._min_tick_s = float(min_tick_s)
        self._snaps = deque()        # (t, bad, total), oldest first
        self._lock = threading.Lock()
        self._last = None            # last SLOState
        self._m_burn, self._m_budget = _slo_gauges()

    # ------------------------------------------------------------ internals
    def _window_rate(self, now, window, bad, total):
        """(error_rate, events) over [now-window, now] from snapshots."""
        cutoff = now - window
        base = None
        for snap in self._snaps:           # oldest → newest
            if snap[0] >= cutoff:
                base = snap
                break
        if base is None:
            base = self._snaps[0] if self._snaps else (now, bad, total)
        d_total = total - base[2]
        d_bad = bad - base[1]
        if d_total <= 0:
            return 0.0, 0.0
        return max(0.0, d_bad) / d_total, d_total

    # ------------------------------------------------------------ public
    def tick(self) -> None:
        """Record a snapshot (rate-limited; cheap to call per request)."""
        now = self._clock()
        with self._lock:
            if self._snaps and now - self._snaps[-1][0] < self._min_tick_s:
                return
            self._snaps.append((now, float(self._bad_fn()),
                                float(self._total_fn())))
            cutoff = now - self.long_s - 60.0
            while len(self._snaps) > 2 and self._snaps[1][0] <= cutoff:
                self._snaps.popleft()

    def evaluate(self) -> SLOState:
        """Snapshot, compute both windows, publish gauges, return state."""
        self.tick()
        now = self._clock()
        bad = float(self._bad_fn())
        total = float(self._total_fn())
        budget = 1.0 - self.objective
        with self._lock:
            rate_s, n_s = self._window_rate(now, self.short_s, bad, total)
            rate_l, n_l = self._window_rate(now, self.long_s, bad, total)
        burn_s = rate_s / budget if n_s >= self.min_events else 0.0
        burn_l = rate_l / budget if n_l >= self.min_events else 0.0
        fast = (burn_s > self.fast_threshold and
                burn_l > self.fast_threshold)
        remaining = max(0.0, 1.0 - rate_l / budget) if n_l > 0 else 1.0
        state = SLOState(self.name, self.objective, burn_s, burn_l,
                         min(1.0, remaining), fast)
        self._last = state
        try:
            self._m_burn.labels(slo=self.name, window="short").set(burn_s)
            self._m_burn.labels(slo=self.name, window="long").set(burn_l)
            self._m_budget.labels(slo=self.name).set(state.budget_remaining)
        except Exception:
            pass
        return state

    @property
    def last(self) -> Optional[SLOState]:
        return self._last
