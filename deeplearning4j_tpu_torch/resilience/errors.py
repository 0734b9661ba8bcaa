"""Error types of the serving path and the checkpoint reader.

Counterpart of the part of deeplearning4j_tpu/resilience/errors.py the
port's slice uses; the HTTP server maps each to its status code.
"""

from __future__ import annotations


class DeadlineExceededError(TimeoutError):
    """A per-request deadline expired before the work ran (HTTP 504)."""


class ServerOverloadedError(RuntimeError):
    """The serving queue is full and the request was shed (HTTP 429)."""


class BatcherStoppedError(RuntimeError):
    """submit() after stop(): the engine is draining or gone (HTTP 503)."""


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
