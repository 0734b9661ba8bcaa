"""Deployment: promote checkpoints into live serving, with instant rollback.

Counterpart of deeplearning4j_tpu/online/deploy.py. ``Deployer`` owns the
promote/rollback choreography over a set of swap targets (the serving
surfaces that must change weights together):

- **pin first** -- the candidate checkpoint is pinned in the manifest
  BEFORE any target swaps, so ``keep_last`` rotation can never delete the
  file a live replica is serving (or the rollback target);
- **intent file** -- ``deploy.json`` (the JAX package's document, format
  ``deeplearning4j_tpu/deploy-state/v1``) is written atomically (tmp +
  fsync + os.replace) to ``phase: promoting`` before the first swap and
  ``phase: live`` after the last, so a kill mid-promotion is recoverable:
  ``recover()`` re-reads the intent, re-validates the candidate zip, and
  converges every target onto ONE model -- the candidate when its zip is
  intact, the pinned incumbent otherwise;
- **monotonic versions** -- every promotion AND every rollback mints a new
  version (rollback is a roll-*forward* to the old weights), so
  ``x-model-version`` observed by clients never repeats.

Swap targets: ``EngineTarget`` (a bare InferenceEngine or DecodeEngine),
``ServerTarget`` (an in-process InferenceServer: both engines under one
version) and ``HttpTarget`` (a replica's ``POST /admin/swap``). Every swap
writes the checkpoint's arrays INTO an engine's resident tensors
(``swap_weights``): the captured rungs keep their addresses and nothing
is captured.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from deeplearning4j_tpu_torch.resilience.checkpoint import CheckpointManager

__all__ = ["EngineTarget", "ServerTarget", "HttpTarget", "Deployer",
           "DEPLOY_STATE_NAME"]

DEPLOY_STATE_NAME = "deploy.json"


class EngineTarget:
    """Swap a bare in-process engine (InferenceEngine or DecodeEngine —
    both expose ``model`` and ``swap_weights``)."""

    def __init__(self, engine):
        self.engine = engine

    def swap(self, checkpoint_path, version: int) -> int:
        from deeplearning4j_tpu_torch.util.model_serializer import load_weights
        params, state = load_weights(self.engine.model, checkpoint_path)
        return self.engine.swap_weights(params, state, version=version)

    def __repr__(self):
        return f"EngineTarget({type(self.engine).__name__})"


class ServerTarget:
    """Swap an in-process InferenceServer (predict + decode engines move
    together under one version)."""

    def __init__(self, server):
        self.server = server

    def swap(self, checkpoint_path, version: int) -> int:
        return self.server.swap_checkpoint(checkpoint_path, version=version)

    def __repr__(self):
        return f"ServerTarget(port={getattr(self.server, 'port', '?')})"


class HttpTarget:
    """Swap a subprocess replica through its admin endpoint. The replica
    must share a filesystem with the deployer (the checkpoint travels by
    path, not by value — zips can be hundreds of MB)."""

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def swap(self, checkpoint_path, version: int) -> int:
        from deeplearning4j_tpu_torch.serving.client import InferenceClient
        body = json.dumps({"checkpoint": os.fspath(checkpoint_path),
                           "version": int(version)}).encode()
        cli = InferenceClient(self.url, timeout=self.timeout, retries=2)
        try:
            status, data, _hdrs = cli.post_raw("/admin/swap", body)
        finally:
            cli.close()
        if status != 200:
            raise RuntimeError(
                f"swap rejected by {self.url}: HTTP {status} "
                f"{data[:300]!r}")
        return int(json.loads(data.decode())["version"])

    def __repr__(self):
        return f"HttpTarget({self.url})"


class Deployer:
    """Promote/rollback coordinator over a CheckpointManager + targets."""

    def __init__(self, manager: CheckpointManager, targets=(),
                 state_path: Optional[str] = None,
                 chaos_mid_promotion=None):
        self.manager = manager
        self.targets: List = list(targets)
        self.state_path = (os.fspath(state_path) if state_path is not None
                           else os.path.join(manager.directory,
                                             DEPLOY_STATE_NAME))
        # test-only hook, called after the FIRST target has swapped but
        # before the rest — the worst possible instant to die (tier is
        # split-brained); the chaos test SIGKILLs here and recover() must
        # still converge
        self.chaos_mid_promotion = chaos_mid_promotion
        self.current: Optional[dict] = None     # what's serving now
        self.previous: Optional[dict] = None    # the rollback target
        self._version = 0
        from deeplearning4j_tpu_torch.monitor import get_registry
        reg = get_registry()
        self._m_promotions = reg.counter(
            "dl4jtpu_online_promotions_total",
            "Candidate checkpoints promoted into live serving.")
        self._m_rollbacks = reg.counter(
            "dl4jtpu_online_rollbacks_total",
            "Automatic or manual rollbacks to the pinned incumbent.")
        self._load_state()

    @property
    def version(self) -> int:
        return self._version

    # -- intent file -------------------------------------------------------

    def _load_state(self):
        try:
            with open(self.state_path) as fh:
                doc = json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return
        self._version = int(doc.get("version", 0))
        self.current = doc.get("current") or None
        self.previous = doc.get("previous") or None
        self._pending = doc if doc.get("phase") == "promoting" else None

    _pending = None     # unfinished promotion found by _load_state

    def _write_state(self, phase: str, candidate: Optional[dict] = None):
        doc = {"format": "deeplearning4j_tpu/deploy-state/v1",
               "phase": phase, "version": self._version,
               "current": self.current, "previous": self.previous,
               "candidate": candidate}
        tmp = self.state_path + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(doc, fh, indent=1)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.state_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- promotion ---------------------------------------------------------

    def promote(self, checkpoint_path, version: Optional[int] = None) -> int:
        """Promote one checkpoint: validate → pin → record intent → swap
        every target → unpin the superseded → record live. Returns the new
        model version. Raises before touching any target when the zip is
        torn or swap-incompatible (read_meta / the first target's
        validation)."""
        from deeplearning4j_tpu_torch.util.model_serializer import read_meta
        path = os.fspath(checkpoint_path)
        meta = read_meta(path)      # torn zip → CorruptCheckpointError here
        iteration = int(meta["iteration"])
        self.manager.pin(iteration)
        version = int(version) if version is not None else self._version + 1
        cand = {"checkpoint": path, "iteration": iteration,
                "version": version}
        self._write_state("promoting", candidate=cand)
        self._swap_all(path, version, chaos=True)
        self._finish_promotion(cand)
        return version

    def _swap_all(self, path: str, version: int, chaos: bool = False):
        # the chaos hook fires only on a genuine promotion (not recover or
        # rollback re-swaps): the scenario under test is dying between
        # target swaps while the intent file still says "promoting"
        for i, target in enumerate(self.targets):
            target.swap(path, version)
            if chaos and i == 0 and self.chaos_mid_promotion is not None:
                self.chaos_mid_promotion()

    def _finish_promotion(self, cand: dict):
        superseded = self.previous
        self.previous = self.current
        self.current = cand
        self._version = cand["version"]
        self._unpin_superseded(superseded)
        self._write_state("live")
        self._m_promotions.inc()

    def _unpin_superseded(self, superseded: Optional[dict]):
        """Drop the pin on a checkpoint that just left the
        {current, previous} rollback window — unless a window member still
        shares its iteration."""
        if superseded is None:
            return
        it = superseded["iteration"]
        keep = {e["iteration"] for e in (self.current, self.previous) if e}
        if it in keep:
            return
        try:
            self.manager.unpin(it)
        except ValueError:
            pass    # already rotated or deleted out-of-band

    # -- rollback ----------------------------------------------------------

    def rollback(self) -> int:
        """Instant rollback: swap every target to the pinned previous
        checkpoint under a NEW monotonic version. The bad model's pin is
        dropped (it may rotate away); the restored incumbent stays pinned
        as the new current."""
        if self.previous is None:
            raise RuntimeError("no previous deployment to roll back to")
        bad, good = self.current, self.previous
        version = self._version + 1
        self._swap_all(good["checkpoint"], version)
        self.current = {"checkpoint": good["checkpoint"],
                        "iteration": good["iteration"], "version": version}
        self.previous = None
        self._version = version
        self._unpin_superseded(bad)
        self._write_state("live")
        self._m_rollbacks.inc()
        return version

    # -- crash recovery ----------------------------------------------------

    def recover(self) -> Optional[str]:
        """Converge after a restart. Call AFTER attaching targets.

        - intent says ``promoting``: the process died mid-swap and the tier
          may be split-brained. Re-validate the candidate zip: intact →
          finish the promotion (re-swap all targets — swaps are
          idempotent); torn/missing → converge everything back onto the
          pinned incumbent.
        - intent says ``live``: re-apply the current checkpoint so targets
          that restarted on seed weights catch up.

        Returns 'promoted', 'reverted', 'reapplied', or None (fresh)."""
        from deeplearning4j_tpu_torch.util.model_serializer import read_meta
        pending = self._pending
        self._pending = None
        if pending is not None and pending.get("candidate"):
            cand = pending["candidate"]
            try:
                read_meta(cand["checkpoint"])
                ok = True
            except Exception:       # noqa: BLE001 — torn/missing candidate
                ok = False
            if ok:
                self._swap_all(cand["checkpoint"], cand["version"])
                self._finish_promotion(dict(cand))
                return "promoted"
            if self.current is not None:
                self._swap_all(self.current["checkpoint"],
                               self.current["version"])
            self._write_state("live")
            return "reverted"
        if self.current is not None:
            self._swap_all(self.current["checkpoint"],
                           self.current["version"])
            return "reapplied"
        return None
