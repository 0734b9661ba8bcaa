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
