"""The assembled online-learning loop: one ``step()`` per control cycle.

Counterpart of deeplearning4j_tpu/online/service.py.
``OnlineLearningService`` wires the pieces of this package into the
train -> gate -> promote -> watch -> rollback cycle:

1. ``trainer.run_round()`` -- guarded fine-tune, one atomic checkpoint;
2. ``gate.decide`` -- candidate (the freshly trained model) vs incumbent
   (the currently promoted checkpoint, loaded into a scratch net so the
   serving engines are never touched by evaluation);
3. ``deployer.promote`` -- pin, swap every target in place (nothing
   captured), record;
4. **regression watch** -- immediately after promotion the live model is
   re-scored; if quality fell more than ``regression_margin`` below the
   pre-promotion incumbent, ``deployer.rollback()`` restores the pinned
   incumbent under a fresh version.

The scratch net is loaded with ``restore_into`` (the checkpoint's
parameters and state copied into its own tensors, the version bumped),
where the JAX package assigns ``scratch.params``: a plain assignment
would leave a warmed engine of the scratch net serving the previous
checkpoint, since engines follow ``_params_version``. Outputs are read to
the host in float32.

``health_info`` merges the trainer's stall state into the serving
server's ``health_hook``, so a silent stream degrades /healthz while
requests keep being served on the incumbent weights.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import host_array
from deeplearning4j_tpu_torch.util.model_serializer import restore_into

log = logging.getLogger(__name__)

__all__ = ["OnlineLearningService"]


class OnlineLearningService:
    """One control loop over trainer + gate + deployer.

    ``scratch_model`` must be architecturally identical to the trainer's
    model (same conf — e.g. another ``build_model("mlp")``); it is the
    evaluation stand-in for whichever checkpoint is currently promoted.
    """

    def __init__(self, trainer, gate, deployer, scratch_model,
                 mirror=None, regression_margin: float = 0.05):
        if regression_margin < 0:
            raise ValueError("regression_margin must be >= 0, got "
                             f"{regression_margin}")
        self.trainer = trainer
        self.gate = gate
        self.deployer = deployer
        self.scratch = scratch_model
        self.mirror = mirror
        self.regression_margin = float(regression_margin)

    # -- model handles -----------------------------------------------------

    def _candidate_fn(self):
        return lambda x: host_array(self.trainer.model.output(x))

    def _incumbent_fn(self):
        """Predict-fn for the promoted checkpoint, or None before the first
        promotion (bootstrap)."""
        cur = self.deployer.current
        if cur is None:
            return None
        restore_into(self.scratch, cur["checkpoint"], load_updater=False)
        return lambda x: host_array(self.scratch.output(x))

    # -- the cycle ---------------------------------------------------------

    def step(self) -> dict:
        """Run one full cycle; returns a summary dict (keys: trained,
        checkpoint, decision, promoted, version, rolled_back,
        live_quality, stalled, quarantined)."""
        out = {"trained": False, "checkpoint": None, "decision": None,
               "promoted": False, "version": self.deployer.version,
               "rolled_back": False, "live_quality": None,
               "stalled": False, "quarantined": self.trainer.quarantined}
        ck = self.trainer.run_round()
        out["stalled"] = self.trainer.stalled
        out["quarantined"] = self.trainer.quarantined
        if ck is None:
            return out
        out["trained"] = True
        out["checkpoint"] = ck

        candidate_fn = self._candidate_fn()
        decision = self.gate.decide(candidate_fn, self._incumbent_fn(),
                                    self.mirror)
        out["decision"] = decision.as_dict()
        if not decision.promote:
            log.info("online gate held back %s: %s", ck, decision.reason)
            return out

        version = self.deployer.promote(ck)
        out["promoted"], out["version"] = True, version

        # regression watch: score what is NOW live against the quality the
        # tier had before this promotion
        live_q = self.gate.evaluate(candidate_fn)
        out["live_quality"] = live_q
        baseline = decision.incumbent_quality
        if (np.isfinite(baseline)
                and live_q < baseline - self.regression_margin):
            rb = self.deployer.rollback()
            out["rolled_back"], out["version"] = True, rb
            log.error("online promotion v%d regressed quality %.4f → %.4f "
                      "(margin %.4f); rolled back as v%d",
                      version, baseline, live_q,
                      self.regression_margin, rb)
        return out

    # -- health ------------------------------------------------------------

    def health_info(self) -> Optional[dict]:
        """InferenceServer ``health_hook`` delegate.

        Healthy (None) passes through untouched so the server's own checks
        (including the SLO burn-rate gate) decide the final status; a
        degraded trainer report is annotated with the promoted version so
        /healthz tells the operator WHICH deployment was live while the
        stream went quiet."""
        info = self.trainer.health_info()
        if info is None:
            return None
        return dict(info, online_version=self.deployer.version)
