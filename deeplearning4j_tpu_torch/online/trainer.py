"""Guarded continuous fine-tuning off a streaming iterator.

Counterpart of deeplearning4j_tpu/online/trainer.py. ``OnlineTrainer``
is the training half of the online loop: it pulls bounded *rounds* of
batches from a ``StreamingDataSetIterator`` (or the Kafka route wrapping
one), screens every batch through ``BatchGuard`` before it can touch the
weights, fine-tunes with ``model.fit(x, y)`` -- the container's captured
train step, on the TextGenerationLSTM recipe net one K4-train and two K3
-- and ends each productive round with one atomic checkpoint, the unit
the promotion gate evaluates.

Poison handling is quarantine-not-crash: a NaN batch or a loss spike is
counted (``dl4jtpu_online_quarantined_batches_total{reason}``) and
skipped; a non-finite score after a round restores the last checkpoint
in place (``restore_into``) and, with a flight recorder attached, counts
the first non-finite layer under a second label value; a stream that
goes silent surfaces as ``StreamStalledError`` -> ``health_info()`` flips
to degraded (wired into InferenceServer's ``health_hook``) and the next
round simply retries -- the service keeps serving on the incumbent
weights throughout.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.resilience.errors import StreamStalledError

log = logging.getLogger(__name__)

__all__ = ["BatchGuard", "OnlineTrainer"]


def _quarantine_counter():
    from deeplearning4j_tpu_torch.monitor import get_registry
    return get_registry().counter(
        "dl4jtpu_online_quarantined_batches_total",
        "Stream batches rejected by the online BatchGuard before they "
        "could touch the weights, by reason.", ("reason",))


class BatchGuard:
    """Pre-fit screen: does this batch deserve a gradient step?

    Three rejection reasons (the counter's ``reason`` label):

    - ``non_finite``       — NaN/Inf anywhere in features or labels;
    - ``non_finite_loss``  — the batch's pre-step loss is NaN/Inf (e.g.
      labels outside the model's output support);
    - ``loss_spike``       — pre-step loss exceeds ``spike_factor`` × the
      EMA of accepted losses (after ``warmup`` accepted batches), the
      classic poisoned-shard signature.

    The EMA only learns from ACCEPTED batches, so one spike cannot drag
    the baseline up and mask the next one.
    """

    def __init__(self, model, spike_factor: float = 10.0,
                 ema_alpha: float = 0.3, warmup: int = 3):
        if spike_factor <= 1.0:
            raise ValueError(f"spike_factor must be > 1, got {spike_factor}")
        self.model = model
        self.spike_factor = float(spike_factor)
        self.ema_alpha = float(ema_alpha)
        self.warmup = int(warmup)
        self._ema: Optional[float] = None
        self._accepted = 0
        self._m_quarantined = _quarantine_counter()

    def check(self, features, labels) -> Optional[str]:
        """Return the rejection reason, or None when the batch is clean
        (which also folds its loss into the EMA baseline)."""
        f, l = np.asarray(features), np.asarray(labels)
        if not (np.all(np.isfinite(f)) and np.all(np.isfinite(l))):
            return self._reject("non_finite")
        loss = float(self.model.score(x=f, y=l))
        if not math.isfinite(loss):
            return self._reject("non_finite_loss")
        if (self._accepted >= self.warmup and self._ema is not None
                and loss > self.spike_factor * max(self._ema, 1e-8)):
            return self._reject("loss_spike")
        self._ema = (loss if self._ema is None else
                     self.ema_alpha * loss + (1 - self.ema_alpha) * self._ema)
        self._accepted += 1
        return None

    def _reject(self, reason: str, layer: Optional[str] = None) -> str:
        # layer provenance (from the model's flight recorder) rides a
        # SECOND suffixed label value — the plain reason keeps counting,
        # so existing `{reason="non_finite"}` consumers never break
        self._m_quarantined.labels(reason=reason).inc()
        if layer:
            self._m_quarantined.labels(reason=f"{reason}:{layer}").inc()
        log.warning("online guard quarantined a batch: %s%s", reason,
                    f" (layer {layer})" if layer else "")
        return reason


class OnlineTrainer:
    """Bounded-round fine-tuner with crash-safe checkpoints.

    One ``run_round()`` consumes up to ``batches_per_round`` batches from
    the iterator, fits each accepted batch, and — when at least one batch
    trained — saves ONE checkpoint through the manager (atomic zip +
    manifest; docs/FAULT_TOLERANCE.md). SIGKILL at any point loses at most
    the current round: ``resume()`` restores the newest manifest entry,
    and the serving tier never sees a torn model because it only loads
    checkpoints the manifest finished recording.

    The model may be a plain net (full fine-tune) or a
    ``TransferLearning``-built net with frozen feature extractor (head-only
    fine-tune) — frozen layers keep identical param paths, so either kind
    of checkpoint hot-swaps into the serving replicas unchanged.
    """

    def __init__(self, model, iterator, checkpoints,
                 guard: Optional[BatchGuard] = None,
                 batches_per_round: int = 8,
                 post_step_check: bool = True):
        if batches_per_round < 1:
            raise ValueError("batches_per_round must be >= 1, got "
                             f"{batches_per_round}")
        self.model = model
        self.iterator = iterator
        self.checkpoints = (checkpoints if isinstance(checkpoints,
                                                      CheckpointManager)
                            else CheckpointManager(checkpoints))
        self.guard = guard
        self.batches_per_round = int(batches_per_round)
        # post_step_check: after fitting a round, score the last accepted
        # batch — a non-finite result means an update slipped past the
        # pre-fit guard and corrupted the weights; roll the model back to
        # its last checkpoint instead of checkpointing the corruption
        self.post_step_check = post_step_check
        self._stalled = False
        self.quarantined = 0
        self.rounds = 0
        self._m_quarantined = _quarantine_counter()

    # -- lifecycle ---------------------------------------------------------

    def resume(self) -> Optional[str]:
        """Restore the newest checkpoint from the manifest (params, updater,
        iteration/epoch counters) so a restarted trainer continues the same
        run. Returns the restored path, or None on a fresh directory."""
        from deeplearning4j_tpu_torch.util.model_serializer import restore_into
        path = self.checkpoints.latest()
        if path is not None:
            restore_into(self.model, path)
        return path

    # -- the round ---------------------------------------------------------

    def run_round(self) -> Optional[str]:
        """Consume up to ``batches_per_round`` batches; fit the clean ones;
        checkpoint once if anything trained. Returns the new checkpoint
        path, or None (stream empty / stalled / everything quarantined)."""
        trained = 0
        last_f = last_l = None
        self._stalled = False
        for _ in range(self.batches_per_round):
            try:
                ds = next(self.iterator)
            except StopIteration:
                break
            except StreamStalledError:
                # degrade, don't die: health_info() reports it; the stream
                # iterator stays usable, so the next round just retries
                self._stalled = True
                log.warning("online trainer: stream stalled mid-round")
                break
            if self.guard is not None:
                if self.guard.check(ds.features, ds.labels) is not None:
                    self.quarantined += 1
                    continue
            self.model.fit(ds.features, ds.labels)
            trained += 1
            last_f, last_l = ds.features, ds.labels
        if trained == 0:
            return None
        if self.post_step_check and last_f is not None:
            post = float(self.model.score(x=last_f, y=last_l))
            if not math.isfinite(post):
                self._m_quarantined.labels(reason="post_step_non_finite").inc()
                # per-layer provenance from the flight recorder (when one
                # is attached): a second suffixed label value names the
                # first layer that went non-finite — the plain reason
                # above keeps its count, so existing consumers still work
                layer = self._non_finite_layer()
                if layer:
                    self._m_quarantined.labels(
                        reason=f"post_step_non_finite:{layer}").inc()
                restored = self.resume()
                log.error("online trainer: non-finite loss AFTER fitting"
                          "%s; weights restored from %s",
                          f" (first non-finite layer: {layer})"
                          if layer else "", restored)
                return None
        self.rounds += 1
        return self.checkpoints.save(self.model)

    def _non_finite_layer(self) -> Optional[str]:
        """The first layer the model's flight recorder saw go non-finite
        (None without a recorder, or while training is still finite)."""
        rec = getattr(self.model, "_flight", None)
        if rec is None:
            return None
        try:
            fnf = rec.first_non_finite()
        except Exception:
            return None
        return fnf["layer"] if fnf else None

    # -- health ------------------------------------------------------------

    @property
    def stalled(self) -> bool:
        return self._stalled

    def health_info(self) -> Optional[dict]:
        """InferenceServer ``health_hook`` shape: non-ok dict when the
        stream is stalled (503 degraded — load balancers stop preferring
        this node but the process keeps serving), else None."""
        if self._stalled:
            return {"status": "degraded", "reason": "stream_stalled"}
        return None
