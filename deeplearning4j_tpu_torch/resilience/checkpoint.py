"""Crash-safe checkpointing: manager, listener, resume discovery.

Counterpart of deeplearning4j_tpu/resilience/checkpoint.py, with the same
file names and manifest, byte for byte, so a directory written by either
package is read by the other. A checkpoint directory holds

- ``checkpoint_iter0000000123_epoch0002.zip`` — one atomic ModelSerializer
  zip per save (params + updater state + iteration/epoch/epoch_batch);
  names sort lexicographically in save order, so the directory is
  self-describing even without the manifest;
- ``manifest.json`` — the manager's ledger: every live checkpoint with its
  counters, save wall-time and pinned flag, plus the running save count.
  Rewritten atomically after every save/rotation, so it never references a
  half-written zip and a torn manifest is impossible.

Rotation keeps the newest ``keep_last`` unpinned checkpoints; with
``keep_every=M`` every M-th save (the 1st, M+1th, 2M+1th, …) is pinned and
exempt from rotation — long runs retain a sparse history plus a dense
recent window.

``CheckpointListener`` triggers on an iteration DELTA
(``iteration - last_saved >= every_n_iterations``), not ``%`` — under
``fit_scan`` the iteration counter advances in chunk-sized jumps and a
modulo test can skip its own cadence forever.

Not ported yet: the AOT companion artifact (``exec/aot.py``), which the
JAX manager rotates with its checkpoint and ``latest_aot`` returns; here
rotation removes the zip alone and ``latest_aot`` raises. A normalizer
(``data/normalizers.py``) given to the manager's ``save`` or to the
listener is written into each zip (``normalizer.json``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from dataclasses import dataclass
from typing import List, Optional

from deeplearning4j_tpu_torch.util import model_serializer

MANIFEST_NAME = "manifest.json"
_FILE_RE = re.compile(r"^checkpoint_iter(\d{10})_epoch(\d{4})\.zip$")

__all__ = ["Checkpoint", "CheckpointManager", "CheckpointListener",
           "checkpoint_filename", "latest_checkpoint", "MANIFEST_NAME"]


def checkpoint_filename(iteration: int, epoch: int) -> str:
    return f"checkpoint_iter{iteration:010d}_epoch{epoch:04d}.zip"


@dataclass(frozen=True)
class Checkpoint:
    """One manifest entry."""

    filename: str
    iteration: int
    epoch: int
    epoch_batch: int = 0
    pinned: bool = False
    saved_at: float = 0.0

    def path(self, directory) -> str:
        return os.path.join(os.fspath(directory), self.filename)


class CheckpointManager:
    """Owns a checkpoint directory: atomic saves, manifest, rotation.

    Not thread-safe by design — one manager per training loop, called from
    the listener on the fit thread.
    """

    def __init__(self, directory, keep_last: int = 3,
                 keep_every: Optional[int] = None, save_updater: bool = True):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if keep_every is not None and keep_every < 1:
            raise ValueError(f"keep_every must be >= 1, got {keep_every}")
        self.directory = os.fspath(directory)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.save_updater = save_updater
        os.makedirs(self.directory, exist_ok=True)
        self._entries: List[Checkpoint] = []
        self._save_count = 0
        self._anchor_iteration: Optional[int] = None
        self._load_manifest()

    # -- manifest ----------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def _load_manifest(self):
        try:
            with open(self._manifest_path(), "r") as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            self._recover_from_scan()
            return
        except (json.JSONDecodeError, OSError):
            # a manifest damaged out-of-band (we only ever os.replace it)
            # is advisory — the zips are the truth, rebuild from them
            self._recover_from_scan()
            return
        self._save_count = int(doc.get("save_count", 0))
        anchor = doc.get("anchor_iteration")
        self._anchor_iteration = int(anchor) if anchor is not None else None
        self._entries = [
            Checkpoint(filename=e["filename"], iteration=int(e["iteration"]),
                       epoch=int(e["epoch"]),
                       epoch_batch=int(e.get("epoch_batch", 0)),
                       pinned=bool(e.get("pinned", False)),
                       saved_at=float(e.get("saved_at", 0.0)))
            for e in doc.get("checkpoints", ())]
        # drop entries whose zip vanished out-of-band
        self._entries = [c for c in self._entries
                         if os.path.exists(c.path(self.directory))]

    def _recover_from_scan(self):
        found = []
        for name in sorted(os.listdir(self.directory)):
            m = _FILE_RE.match(name)
            if m:
                found.append(Checkpoint(filename=name,
                                        iteration=int(m.group(1)),
                                        epoch=int(m.group(2))))
        self._entries = found
        self._save_count = len(found)

    def _write_manifest(self):
        doc = {"format": "deeplearning4j_tpu/checkpoint-manifest/v1",
               "save_count": self._save_count,
               "anchor_iteration": self._anchor_iteration,
               "checkpoints": [
                   {"filename": c.filename, "iteration": c.iteration,
                    "epoch": c.epoch, "epoch_batch": c.epoch_batch,
                    "pinned": c.pinned, "saved_at": c.saved_at}
                   for c in self._entries]}
        tmp = self._manifest_path() + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(doc, fh, indent=1)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self._manifest_path())
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- public surface ----------------------------------------------------

    def save(self, model, normalizer=None) -> str:
        """Write one checkpoint atomically (with ``normalizer`` when
        given), record it, rotate. Returns the checkpoint path."""
        name = checkpoint_filename(model.iteration, model.epoch)
        path = os.path.join(self.directory, name)
        model_serializer.write_model(model, path,
                                     save_updater=self.save_updater,
                                     normalizer=normalizer)
        self._save_count += 1
        pinned = (self.keep_every is not None
                  and (self._save_count - 1) % self.keep_every == 0)
        entry = Checkpoint(filename=name, iteration=model.iteration,
                           epoch=model.epoch,
                           epoch_batch=int(getattr(model, "_epoch_batch", 0)),
                           pinned=pinned, saved_at=time.time())
        # re-saving at the same (iteration, epoch) replaces the entry
        self._entries = [c for c in self._entries if c.filename != name]
        self._entries.append(entry)
        self._rotate()
        self._write_manifest()
        return path

    def _rotate(self):
        unpinned = [c for c in self._entries if not c.pinned]
        while len(unpinned) > self.keep_last:
            victim = unpinned.pop(0)        # oldest unpinned
            self._entries.remove(victim)
            try:
                os.unlink(victim.path(self.directory))
            except OSError:
                pass

    def pin(self, iteration: int) -> Checkpoint:
        """Pin the checkpoint saved at ``iteration`` after the fact so it is
        exempt from ``keep_last`` rotation — what a promotion pins so its
        rollback target survives arbitrarily long training runs. Idempotent;
        raises ``ValueError`` when no live checkpoint has that iteration."""
        return self._set_pinned(iteration, True)

    def unpin(self, iteration: int) -> Checkpoint:
        """Drop the pin on ``iteration``'s checkpoint. The entry immediately
        re-enters ``keep_last`` rotation (and may be rotated away by this
        very call if it is already outside the recent window)."""
        return self._set_pinned(iteration, False)

    def _set_pinned(self, iteration: int, flag: bool) -> Checkpoint:
        iteration = int(iteration)
        hits = [i for i, c in enumerate(self._entries)
                if c.iteration == iteration]
        if not hits:
            live = sorted(c.iteration for c in self._entries)
            raise ValueError(
                f"no checkpoint at iteration {iteration} in "
                f"{self.directory} (live iterations: {live})")
        entry = self._entries[hits[0]]
        if entry.pinned != flag:
            for i in hits:
                self._entries[i] = dataclasses.replace(self._entries[i],
                                                       pinned=flag)
            entry = self._entries[hits[0]]
            if not flag:
                self._rotate()
            self._write_manifest()
        return entry

    def set_anchor(self, iteration: int) -> Checkpoint:
        """Advance the recovery anchor to ``iteration``: pin it, then unpin
        the previous anchor so only one checkpoint is ever anchor-held.
        The anchored step is where a recovery restores from, so rotation
        must never take it, no matter how far training runs ahead. The
        anchor persists in the manifest, so a new manager opening the same
        directory unpins its predecessor's anchor instead of leaking the
        pin forever."""
        iteration = int(iteration)
        prev = self._anchor_iteration
        # set before pin: pin's manifest write must carry the new anchor
        self._anchor_iteration = iteration
        entry = self.pin(iteration)
        if prev is not None and prev != iteration:
            try:
                self.unpin(prev)
            except ValueError:
                pass            # previous anchor already rotated/unknown
        if prev != iteration:
            # pin/unpin skip writing when the flag did not flip (e.g. the
            # entry was already pinned); the moved anchor must still land
            self._write_manifest()
        return entry

    @property
    def anchor(self) -> Optional[int]:
        """Iteration of the current recovery anchor (None before the first
        ``set_anchor``)."""
        return self._anchor_iteration

    def checkpoints(self) -> List[Checkpoint]:
        return list(self._entries)

    def latest(self) -> Optional[str]:
        if not self._entries:
            return None
        best = max(self._entries, key=lambda c: (c.iteration, c.epoch))
        return best.path(self.directory)

    def latest_aot(self) -> Optional[str]:
        """The AOT artifact riding the latest checkpoint: not ported (it
        waits for ``exec/aot.py``, ROADMAP queue 1 item 6)."""
        raise NotImplementedError(
            "AOT artifacts (exec/aot.py) are not ported to the PyTorch "
            "package yet (ROADMAP queue 1 item 6)")


def latest_checkpoint(directory) -> Optional[str]:
    """Most recent checkpoint in ``directory`` (manifest first, filename
    scan as fallback), or None. What ``fit(resume_from=...)`` accepts when
    handed a directory instead of a zip path."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    return CheckpointManager(directory, keep_last=10 ** 9).latest()


class CheckpointListener:
    """Save every N iterations and/or epochs during ``fit`` (IterationListener
    SPI — duck-typed so this module never imports optimize.listeners).

    ``fit(..., checkpoint=...)`` attaches one of these for the duration of
    the call; it can equally be added to ``model.listeners`` directly.
    """

    def __init__(self, directory, every_n_iterations: Optional[int] = None,
                 every_n_epochs: Optional[int] = None, keep_last: int = 3,
                 keep_every: Optional[int] = None, save_updater: bool = True,
                 normalizer=None):
        if not every_n_iterations and not every_n_epochs:
            raise ValueError("CheckpointListener needs every_n_iterations "
                             "and/or every_n_epochs")
        self.manager = CheckpointManager(directory, keep_last=keep_last,
                                         keep_every=keep_every,
                                         save_updater=save_updater)
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.normalizer = normalizer
        self._baseline_iter: Optional[int] = None
        self.last_saved_path: Optional[str] = None

    def _save(self, model):
        self.last_saved_path = self.manager.save(model,
                                                 normalizer=self.normalizer)

    def iteration_done(self, model, iteration: int, epoch: int):
        if not self.every_n_iterations:
            return
        if self._baseline_iter is None:
            # first observation: anchor the cadence so a resumed run saves
            # at the same iteration numbers as an uninterrupted one
            self._baseline_iter = iteration - 1
        if iteration - self._baseline_iter >= self.every_n_iterations:
            self._save(model)
            self._baseline_iter = iteration

    def on_epoch_end(self, model):
        if self.every_n_epochs and model.epoch % self.every_n_epochs == 0:
            self._save(model)
