"""Shared retry primitive: bounded exponential backoff with decorrelated
jitter.

Counterpart of deeplearning4j_tpu/resilience/retry.py. Every remote call
of the package (the serving client among them) retries through
``retry_call``, with one set of semantics:

- bounded attempts (``max_attempts``) and an optional overall
  ``deadline`` in seconds: the loop never sleeps past a spent budget;
- decorrelated jitter: ``delay = min(max_delay, uniform(base_delay,
  prev_delay * 3))``, which grows roughly exponentially but spreads a
  herd of clients retrying against one recovering endpoint;
- classification: ``TransientError``, overload, connection and timeout
  errors are retried; ``FatalError``, deadline and value errors are
  raised at once;
- metrics: every attempt lands in ``dl4jtpu_retry_attempts_total
  {component, outcome}`` and every backoff sleep in
  ``dl4jtpu_retry_backoff_seconds``.

The clock, the sleeper and the RNG are injected, so tests drive a policy
with a fake clock and sleep for real nowhere.
"""

from __future__ import annotations

import functools
import random
import socket
import time
import urllib.error
from dataclasses import dataclass
from typing import Callable, Optional

from deeplearning4j_tpu_torch.monitor.metrics import get_registry
from deeplearning4j_tpu_torch.resilience.errors import (
    DeadlineExceededError, FatalError, RetriesExhaustedError,
    ServerOverloadedError, TransientError)

__all__ = ["RetryPolicy", "retry_call", "retryable", "default_classifier"]


def default_classifier(exc: BaseException) -> bool:
    """True: transient (retry); False: fatal (raise now). Explicit markers
    win; otherwise network errors (connection resets, timeouts, socket
    failures, HTTP 429 / 502 / 503 / 504) are transient and everything
    else is fatal."""
    if isinstance(exc, (TransientError, ServerOverloadedError)):
        return True
    if isinstance(exc, (FatalError, DeadlineExceededError)):
        return False
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in (429, 502, 503, 504)
    if isinstance(exc, (ConnectionError, TimeoutError, socket.timeout,
                        urllib.error.URLError, BrokenPipeError)):
        return True
    return False


@dataclass(frozen=True)
class RetryPolicy:
    """One call site's retry behaviour. ``max_attempts``: tries including
    the first (None: unbounded; pair it with ``deadline`` or a
    ``give_up``). ``base_delay`` / ``max_delay``: the backoff's bounds in
    seconds. ``deadline``: the wall budget across attempts, in seconds.
    ``classify``: error -> retryable?"""

    max_attempts: Optional[int] = 5
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: Optional[float] = None
    classify: Callable[[BaseException], bool] = default_classifier


DEFAULT_POLICY = RetryPolicy()

# backoff sleeps are seconds, not microseconds
_BACKOFF_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0)


def _metrics():
    reg = get_registry()
    return (reg.counter(
                "dl4jtpu_retry_attempts_total",
                "Attempts made by the shared retry primitive. outcome: "
                "success | error (will retry) | exhausted (gave up) | "
                "fatal (not retryable).",
                ("component", "outcome")),
            reg.histogram(
                "dl4jtpu_retry_backoff_seconds",
                "Backoff sleeps taken between retry attempts.",
                ("component",), buckets=_BACKOFF_BUCKETS))


def retry_call(fn, *args, policy: RetryPolicy = DEFAULT_POLICY,
               component: str = "default",
               give_up: Optional[Callable[[], bool]] = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               rng: Optional[random.Random] = None, **kwargs):
    """``fn(*args, **kwargs)``, retrying transient failures under
    ``policy``. ``give_up()`` is asked before every attempt and every
    sleep; True ends the loop with ``RetriesExhaustedError``. A fatal
    error is raised as it is; a spent budget raises
    ``RetriesExhaustedError`` with the last error as ``__cause__``."""
    attempts_total, backoff_hist = _metrics()
    rng = rng if rng is not None else random
    start = clock()
    prev_delay = policy.base_delay
    attempt = 0
    last_exc: Optional[BaseException] = None
    while True:
        if give_up is not None and give_up():
            raise RetriesExhaustedError(
                f"{component}: aborted by give_up() after {attempt} "
                f"attempt(s)", attempts=attempt,
                elapsed=clock() - start) from last_exc
        attempt += 1
        try:
            result = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 -- classified right below
            last_exc = e
            if not policy.classify(e):
                attempts_total.labels(component=component,
                                      outcome="fatal").inc()
                raise
            elapsed = clock() - start
            out_of_attempts = (policy.max_attempts is not None
                               and attempt >= policy.max_attempts)
            out_of_time = (policy.deadline is not None
                           and elapsed >= policy.deadline)
            if out_of_attempts or out_of_time:
                attempts_total.labels(component=component,
                                      outcome="exhausted").inc()
                why = "deadline" if out_of_time else "attempts"
                raise RetriesExhaustedError(
                    f"{component}: {why} budget spent after {attempt} "
                    f"attempt(s) in {elapsed:.3f}s: "
                    f"{type(e).__name__}: {e}",
                    attempts=attempt, elapsed=elapsed) from e
            attempts_total.labels(component=component,
                                  outcome="error").inc()
            delay = min(policy.max_delay,
                        rng.uniform(policy.base_delay, prev_delay * 3.0))
            prev_delay = delay
            if policy.deadline is not None:
                remaining = policy.deadline - (clock() - start)
                if remaining <= 0 or delay >= remaining:
                    # one last attempt within the budget: the longest
                    # sleep that does not carry past it
                    delay = max(0.0, remaining - 1e-3)
            if give_up is not None and give_up():
                continue        # the top of the loop raises
            if delay > 0:
                backoff_hist.labels(component=component).observe(delay)
                sleep(delay)
        else:
            attempts_total.labels(component=component,
                                  outcome="success").inc()
            return result


def retryable(policy: RetryPolicy = DEFAULT_POLICY,
              component: str = "default"):
    """Decorator form: ``@retryable(policy, component="fetcher")``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return retry_call(fn, *args, policy=policy,
                              component=component, **kwargs)
        return inner
    return wrap
