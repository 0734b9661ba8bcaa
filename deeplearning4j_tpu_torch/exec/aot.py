"""AOT artifacts: what a cold replica would otherwise have to remake, saved
next to the checkpoint.

Counterpart of deeplearning4j_tpu/exec/aot.py. The JAX package serializes
XLA executables. The port has nothing to serialize in that sense: a CUDA
graph cannot be carried to another process, and the hand-written kernels
are ctypes calls no exporter can trace. So the artifact holds the two
things a fresh replica pays for before it serves:

- **The kernel libraries**: every ``csrc/*.cu`` build under its digest
  name (``ops.build``), with its sha256 and the ``nvcc --version`` line
  that built it. ``install_libraries`` writes them into the build
  directory, each only after its sha256 matched and only under a name the
  current sources give, so ``build_kernels`` then starts no ``nvcc``.
  An artifact written off the card carries none.
- **One recipe for each program**, under the JAX package's key string
  (``engine:mln:b8:...``, ``decode:step:S4:...``): the program registry's
  record of it (``flops``, ``bytes``, ``kernel_flops``, ``kernel_bytes``,
  ``launches`` of one call, ``memory_bytes``) and its staged layout's
  signature.

A program built from a recipe is a **restore**: it skips the cost pass
(``exec.programs.Cost``: ``FlopCounterMode`` and the byte-counting
dispatch mode over the eager warm-up) and registers the artifact's record
instead, with ``memory_bytes`` of its own capture. It still runs the
warm-up and the capture a CUDA graph needs on the card, and the capture's
launches must equal the recorded ones, else the restore is a ``corrupt``
miss and the program is traced. A program built from scratch, cost pass
included, is a **trace**: only traces count in the engines'
``trace_count``; restores count in ``dl4jtpu_aot_restores_total{engine}``
and ``dl4jtpu_aot_restore_seconds``.

Validity: the artifact's envelope is the format, the backend (``cuda`` or
``cpu``), ``torch`` (``torch.__version__`` and ``torch.version.cuda``,
where the JAX package has ``jaxlib``), ``arch`` (the card's compute
capability, ``sm_90``), the model signature (the JAX package's hash of the
parameters' shapes and dtypes, so one configuration gets one signature in
both packages) and the precision. Any mismatch rejects the whole artifact
(a miss counted by reason, ``MISS_REASONS``); a JAX-written artifact is a
``format`` miss. Every miss falls back to trace-and-save: the programs are
traced as before and their recipes merged into the artifact. Nothing here
uses ``torch.export`` or an inductor: a restored program runs the very
operations and kernels a traced one does.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from typing import Dict, List, Optional, Tuple

__all__ = ["AotBundle", "open_bundle", "companion_path", "model_signature",
           "MISS_REASONS", "install_kernels"]

FORMAT = "deeplearning4j_tpu_torch/aot-bundle/v1"

#: every reason ``dl4jtpu_aot_misses_total`` can carry: the JAX package's,
#: with ``torch`` for ``jaxlib``, and ``arch``
MISS_REASONS = ("no_artifact", "corrupt", "format", "backend", "torch",
                "model_sig", "precision", "key", "arch")

#: the registry fields a recipe carries
RECIPE_FIELDS = ("flops", "bytes", "kernel_flops", "kernel_bytes",
                 "launches", "memory_bytes")

_metrics = None


def _aot_metrics():
    global _metrics
    if _metrics is None:
        from deeplearning4j_tpu_torch.monitor.metrics import get_registry
        reg = get_registry()
        _metrics = {
            "restores": reg.counter(
                "dl4jtpu_aot_restores_total",
                "Programs built from an AOT artifact's recipe instead of "
                "being traced (counted apart from the engines' program "
                "counters).", ("engine",)),
            "misses": reg.counter(
                "dl4jtpu_aot_misses_total",
                "AOT artifact lookups that fell back to trace-and-save, "
                "by reason (no_artifact/corrupt/format/backend/torch/"
                "model_sig/precision/key/arch).", ("reason",)),
            "seconds": reg.histogram(
                "dl4jtpu_aot_restore_seconds",
                "Wall seconds to build one program from the artifact: its "
                "warm-up and capture.", ("engine",)),
        }
    return _metrics


def note_miss(reason: str) -> None:
    if reason not in MISS_REASONS:
        reason = "corrupt"
    _aot_metrics()["misses"].labels(reason=reason).inc()


def note_restore(engine: str, seconds: float) -> None:
    m = _aot_metrics()
    m["restores"].labels(engine=engine or "unknown").inc()
    m["seconds"].labels(engine=engine or "unknown").observe(seconds)


def env_fingerprint(device=None) -> Dict[str, str]:
    """This process's envelope for programs on ``device``: the backend,
    the torch build, and the card's architecture (``cpu`` off the
    card)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    arch = "cpu"
    if dev.type == "cuda" and torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(dev)
        arch = f"sm_{major}{minor}"
    return {"backend": dev.type,
            "torch": f"{torch.__version__}+cuda{torch.version.cuda}",
            "arch": arch}


def model_signature(*trees) -> str:
    """The JAX package's hash of the trees' shapes and dtypes
    (``serving.engine.model_signature``): weights are runtime inputs, so a
    later checkpoint of one architecture keeps its artifact."""
    from deeplearning4j_tpu_torch.serving.engine import model_signature as sig
    return sig(*trees)


def companion_path(checkpoint_path) -> str:
    """The artifact riding a checkpoint: ``model.zip`` -> ``model.aot.zip``
    (rotated together by CheckpointManager)."""
    p = os.fspath(checkpoint_path)
    return (p[:-len(".zip")] if p.endswith(".zip") else p) + ".aot.zip"


def layout_signature(staged) -> str:
    """A program's staged layout: each staged tensor's dtype and shape."""
    import torch
    out = []
    for t in staged:
        if isinstance(t, torch.Tensor):
            out.append(f"{str(t.dtype).replace('torch.', '')}"
                       f"{list(t.shape)}")
        else:
            out.append(repr(t))
    return ";".join(out)


def write_atomic(path, data: bytes) -> None:
    """temp file + fsync + rename, then fsync the directory: a reader
    sees the old file or the new one, never a torn one (the artifact, and
    the kernel libraries ``ops.build.install_libraries`` writes)."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    # a name of its own for every writer, processes and threads alike
    fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{os.path.basename(path)}.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    try:
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


class AotBundle:
    """Recipes and kernel libraries sharing one validity envelope.

    ``save`` merges with a compatible bundle already on disk (two engines
    warming against one artifact union their programs) and writes
    atomically."""

    def __init__(self, model_sig: str, precision: str,
                 env: Optional[Dict[str, str]] = None):
        env = env or env_fingerprint()
        self.backend = env["backend"]
        self.torch = env["torch"]
        self.arch = env["arch"]
        self.model_sig = str(model_sig)
        self.precision = str(precision)
        self._programs: Dict[str, dict] = {}
        self._libraries: Dict[str, dict] = {}    # name -> member

    # ------------------------------------------------------------ programs
    def keys(self):
        return set(self._programs)

    def __contains__(self, key: str) -> bool:
        return key in self._programs

    def __len__(self) -> int:
        return len(self._programs)

    def add_recipe(self, key: str, record: dict, layout: str) -> None:
        """Store one program's recipe under ``key``: ``record``'s
        ``RECIPE_FIELDS`` (a registry record) and its staged layout."""
        recipe = {f: record.get(f) for f in RECIPE_FIELDS}
        recipe["launches"] = dict(recipe["launches"] or {})
        recipe["layout"] = str(layout)
        self._programs[str(key)] = recipe

    def recipe(self, key: str) -> Optional[dict]:
        """The recipe under ``key``; None on a key miss (counted)."""
        rec = self._programs.get(str(key))
        if rec is None:
            note_miss("key")
            return None
        return {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in rec.items()}

    # ----------------------------------------------------------- libraries
    @property
    def libraries(self) -> List[dict]:
        return [dict(m) for m in self._libraries.values()]

    @property
    def nvcc(self) -> str:
        """The ``nvcc --version`` build line of the carried libraries."""
        return next((m.get("nvcc", "") for m in self._libraries.values()),
                    "")

    def add_libraries(self, members: List[dict]) -> None:
        """Carry ``ops.build.export_libraries()``'s members."""
        for m in members:
            self._libraries[m["name"]] = dict(m)

    def install_libraries(self) -> dict:
        """``ops.build.install_libraries`` of the carried members."""
        from deeplearning4j_tpu_torch.ops import build
        return build.install_libraries(self.libraries)

    # ----------------------------------------------------------------- io
    def _meta(self) -> dict:
        return {"format": FORMAT, "backend": self.backend,
                "torch": self.torch, "arch": self.arch,
                "model_sig": self.model_sig, "precision": self.precision,
                "programs": sorted(self._programs),
                "libraries": [{k: m.get(k, "") for k in
                               ("name", "stem", "sha256", "nvcc")}
                              for _, m in sorted(self._libraries.items())]}

    def compatible(self, other: "AotBundle") -> bool:
        return (self.backend == other.backend and self.torch == other.torch
                and self.arch == other.arch
                and self.model_sig == other.model_sig
                and self.precision == other.precision)

    def save(self, path) -> str:
        """Atomic merge-save: union with a compatible bundle already at
        ``path`` (an incompatible one is overwritten: this process could
        never restore it), then temp + fsync + rename."""
        path = os.fspath(path)
        try:
            prev = AotBundle.load(path)
        except Exception:   # noqa: BLE001 -- absent or unreadable: replace
            prev = None
        if prev is not None and self.compatible(prev):
            for k, v in prev._programs.items():
                self._programs.setdefault(k, v)
            for k, v in prev._libraries.items():
                self._libraries.setdefault(k, v)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
            z.writestr("meta.json", json.dumps(self._meta(), indent=1))
            for i, key in enumerate(sorted(self._programs)):
                z.writestr(f"programs/{i:04d}.json",
                           json.dumps(self._programs[key], sort_keys=True))
            for name, m in sorted(self._libraries.items()):
                z.writestr(f"kernels/{name}", m["data"])
        write_atomic(path, buf.getvalue())
        return path

    @classmethod
    def load(cls, path) -> "AotBundle":
        """Read a bundle (raises on absence, damage or another format:
        ``open_bundle`` is the entry that counts misses instead)."""
        with zipfile.ZipFile(os.fspath(path), "r") as z:
            meta = json.loads(z.read("meta.json"))
            if meta.get("format") != FORMAT:
                raise ValueError(
                    f"unknown artifact format {meta.get('format')!r}")
            b = cls(meta["model_sig"], meta["precision"],
                    env={k: meta[k] for k in ("backend", "torch", "arch")})
            for i, key in enumerate(meta["programs"]):
                b._programs[key] = json.loads(z.read(f"programs/{i:04d}.json"))
            for m in meta.get("libraries", ()):
                b._libraries[m["name"]] = dict(
                    m, data=z.read(f"kernels/{m['name']}"))
        return b


def _load_checked(path) -> Tuple[Optional[AotBundle], Optional[str]]:
    if not path or not os.path.exists(os.fspath(path)):
        return None, "no_artifact"
    try:
        return AotBundle.load(path), None
    except ValueError:
        return None, "format"
    except Exception:   # noqa: BLE001 -- a torn or foreign zip
        return None, "corrupt"


def _env_reason(b: AotBundle, env: Dict[str, str]) -> Optional[str]:
    for field in ("backend", "torch", "arch"):
        if getattr(b, field) != env[field]:
            return field
    return None


def open_bundle(path, model_sig: str, precision: str, device=None
                ) -> Tuple[Optional[AotBundle], Optional[str]]:
    """Open an artifact and hold it to this process's envelope for
    ``device`` and to the caller's model. ``(bundle, None)`` when every
    gate passes, else ``(None, reason)`` with the miss counted: a stale
    recipe is never used, the caller traces and saves instead."""
    b, reason = _load_checked(path)
    if b is not None:
        reason = _env_reason(b, env_fingerprint(device))
        if reason is None and b.model_sig != str(model_sig):
            reason = "model_sig"
        if reason is None and b.precision != str(precision):
            reason = "precision"
    if reason is not None:
        note_miss(reason)
        return None, reason
    return b, None


def install_kernels(path, device=None) -> dict:
    """Install an artifact's kernel libraries into the build directory
    before anything builds them (a replica's first step with ``--aot``):
    the envelope's backend, torch and arch must match, the model need
    not. Returns ``ops.build.install_libraries``'s report, or
    ``{"miss": reason}``."""
    b, reason = _load_checked(path)
    if b is not None:
        reason = _env_reason(b, env_fingerprint(device))
    if reason is not None:
        note_miss(reason)
        return {"miss": reason}
    return b.install_libraries()
