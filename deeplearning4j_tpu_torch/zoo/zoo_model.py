"""ZooModel base: build a zoo network, or load its bundled pretrained zip.

Counterpart of deeplearning4j_tpu/zoo/zoo_model.py. A pretrained zip is
read from the user's cache, ``$DL4JTPU_DATA_DIR/pretrained/<name>.zip``
(``cache_path``), when one is there, else from the artifacts committed
with the JAX package (``deeplearning4j_tpu/zoo/pretrained_artifacts/``);
this module reads those files and their manifests, imports nothing of
that package, and checks the SHA-256 the zip's own manifest records (the
cache's ``pretrained/manifest.json``, written by
``write_manifest_entry``, or the bundle's) before loading.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Tuple

BUNDLED_DIR = (Path(__file__).resolve().parents[2] / "deeplearning4j_tpu"
               / "zoo" / "pretrained_artifacts")


class ZooModel:
    name: str = "zoo_model"
    default_input_shape: Tuple[int, ...] = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, ...] = None, **kwargs):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = tuple(input_shape or self.default_input_shape)
        self.kwargs = kwargs

    def conf(self):
        """Build the MultiLayerConfiguration or the
        ComputationGraphConfiguration."""
        raise NotImplementedError

    def updater(self, default):
        """The ``updater=`` constructor keyword when given, else the
        model's default."""
        return self.kwargs.get("updater") or default

    def init(self, device=None):
        """Build and initialize the network (random weights from the seed):
        a ComputationGraph for a graph configuration, else a
        MultiLayerNetwork. The ``compute_dtype='bfloat16'`` constructor
        keyword sets the configuration's compute dtype, as in the JAX
        package: parameters stay float32, the forward (and a decode
        engine's KV state) runs in bfloat16."""
        from deeplearning4j_tpu_torch.models import (ComputationGraph,
                                                     MultiLayerNetwork)
        conf = self.conf()
        cd = self.kwargs.get("compute_dtype")
        if cd:
            conf.global_conf.compute_dtype = cd
        cls = (ComputationGraph if hasattr(conf, "network_inputs")
               else MultiLayerNetwork)
        return cls(conf, device=device).init()

    def cache_path(self) -> Path:
        """Where a user-provisioned pretrained zip lives (the write
        target); ``pretrained_path`` resolves reads across the cache and
        the bundle."""
        from deeplearning4j_tpu_torch.data.fetchers import data_dir
        return data_dir() / "pretrained" / f"{self.name}.zip"

    def pretrained_path(self) -> Path:
        """The cached zip when present, else the bundled one (never a
        write target)."""
        cached = self.cache_path()
        if cached.exists():
            return cached
        bundled = BUNDLED_DIR / f"{self.name}.zip"
        return bundled if bundled.exists() else cached

    @staticmethod
    def _manifest_path() -> Path:
        from deeplearning4j_tpu_torch.data.fetchers import data_dir
        return data_dir() / "pretrained" / "manifest.json"

    @classmethod
    def manifest(cls) -> dict:
        """The bundled manifest, the cache's entries over it. A value is a
        sha256 string or a dict with ``sha256`` and eval metadata."""
        merged = {}
        bundled = BUNDLED_DIR / "manifest.json"
        if bundled.exists():
            merged.update(json.loads(bundled.read_text()))
        mp = cls._manifest_path()
        if mp.exists():
            merged.update(json.loads(mp.read_text()))
        return merged

    @staticmethod
    def write_manifest_entry(name: str, path) -> str:
        """Record the SHA-256 of a cached pretrained zip in the cache's
        manifest. Returns the hash."""
        digest = hashlib.sha256(Path(path).read_bytes()).hexdigest()
        mp = ZooModel._manifest_path()
        manifest = {}
        if mp.exists():
            manifest = json.loads(mp.read_text())
        manifest[name] = digest
        mp.parent.mkdir(parents=True, exist_ok=True)
        mp.write_text(json.dumps(manifest, indent=2))
        return digest

    def init_pretrained(self, device=None):
        """Load the pretrained network (its parameters and layer state; a
        MultiLayerNetwork or a ComputationGraph, as the zip says) after
        checking the zip's SHA-256 against the manifest that came with it
        (the cache's for a cached zip, none meaning unchecked; the
        bundle's for a bundled one): a corrupt or replaced file raises
        instead of loading garbage weights."""
        p = self.pretrained_path()
        if not p.exists():
            raise FileNotFoundError(
                f"No pretrained weights for '{self.name}' at {p}; place a "
                "model zip there (util.model_serializer format).")
        mf = (BUNDLED_DIR / "manifest.json" if p.parent == BUNDLED_DIR
              else self._manifest_path())
        want = json.loads(mf.read_text()).get(self.name) if mf.exists() \
            else None
        if isinstance(want, dict):
            want = want.get("sha256")
        if want is not None:
            got = hashlib.sha256(p.read_bytes()).hexdigest()
            if got != want:
                raise IOError(
                    f"Checksum mismatch for pretrained '{self.name}': "
                    f"manifest says sha256={want} but {p} hashes to {got}.")
        from deeplearning4j_tpu_torch.util.model_serializer import \
            guess_model
        return guess_model(p, device=device)
