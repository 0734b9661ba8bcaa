"""Typed errors of the resilience layer.

Counterpart of deeplearning4j_tpu/resilience/errors.py. The retry
primitive (resilience/retry.py) classifies errors as retryable (transient:
worth another attempt after a backoff) or fatal (deterministic); these
classes are the explicit markers, anything else is classified by its
kind (``default_classifier``). The HTTP server maps the overload,
deadline, draining and injected-fault errors to their status codes.
"""

from __future__ import annotations


class TransientError(Exception):
    """Always retryable, whatever the classifier says."""


class FatalError(Exception):
    """Never retryable: every attempt would fail the same way."""


class RetriesExhaustedError(Exception):
    """retry_call gave up: its attempts or its deadline are spent.
    ``__cause__`` is the last underlying error; ``attempts`` says how many
    were made, ``elapsed`` in how many seconds."""

    def __init__(self, message: str, attempts: int = 0,
                 elapsed: float = 0.0):
        super().__init__(message)
        self.attempts = attempts
        self.elapsed = elapsed


class DeadlineExceededError(TimeoutError):
    """A per-request deadline expired before the work ran (HTTP 504)."""


class ServerOverloadedError(RuntimeError):
    """The serving queue is full and the request was shed (HTTP 429)."""


class BatcherStoppedError(RuntimeError):
    """submit() after stop(): the engine is draining or gone (HTTP 503)."""


class RetryBudgetExhaustedError(RuntimeError):
    """The router's shared retry budget is spent: failover and hedging
    stop and the client gets a fast 503 instead of a retry storm."""


class InjectedFaultError(RuntimeError):
    """A fault injected by ``resilience.faults.ServerFaultInjector``;
    ``code`` is the HTTP status the server answers with."""

    def __init__(self, message: str, code: int = 500):
        super().__init__(message)
        self.code = int(code)


class CorruptCheckpointError(ValueError):
    """A checkpoint zip is truncated or damaged; names the member."""

    def __init__(self, path, member=None, detail=None):
        self.path = str(path)
        self.member = member
        where = f" (member {member!r})" if member else ""
        why = f": {detail}" if detail else ""
        super().__init__(
            f"corrupt or truncated checkpoint {self.path}{where}{why}")


class WeightSwapError(ValueError):
    """A hot-swap candidate does not match the serving engine's live
    weights: missing or extra arrays, or a shape or dtype mismatch. Raised
    before any engine state is touched, so a rejected swap leaves serving
    exactly as it was. ``mismatches`` lists the offending array paths with
    the expected and the given shape and dtype."""

    def __init__(self, message: str, mismatches=None):
        self.mismatches = list(mismatches or ())
        if self.mismatches:
            shown = "; ".join(self.mismatches[:3])
            more = len(self.mismatches) - 3
            if more > 0:
                shown += f"; ... {more} more"
            message = f"{message}: {shown}"
        super().__init__(message)


class StreamStalledError(TimeoutError):
    """A streaming iterator saw no data for longer than its
    ``stall_timeout`` while the stream was still open."""
