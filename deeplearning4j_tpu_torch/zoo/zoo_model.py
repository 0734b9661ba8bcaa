"""ZooModel base: build a zoo network, or load its bundled pretrained zip.

Counterpart of deeplearning4j_tpu/zoo/zoo_model.py. The pretrained
artifacts are the ones committed with the JAX package
(``deeplearning4j_tpu/zoo/pretrained_artifacts/``); this module reads
those files and their manifest, imports nothing of that package, and
checks the SHA-256 the manifest records before loading.
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
        MultiLayerNetwork."""
        from deeplearning4j_tpu_torch.models import (ComputationGraph,
                                                     MultiLayerNetwork)
        conf = self.conf()
        cls = (ComputationGraph if hasattr(conf, "network_inputs")
               else MultiLayerNetwork)
        return cls(conf, device=device).init()

    def pretrained_path(self) -> Path:
        return BUNDLED_DIR / f"{self.name}.zip"

    @staticmethod
    def manifest() -> dict:
        return json.loads((BUNDLED_DIR / "manifest.json").read_text())

    def init_pretrained(self, device=None):
        """Load the bundled pretrained network (its parameters and layer
        state; a MultiLayerNetwork or a ComputationGraph, as the zip says)
        after checking the zip's SHA-256 against the manifest: a corrupt
        or replaced file raises instead of loading garbage weights."""
        p = self.pretrained_path()
        if not p.exists():
            raise FileNotFoundError(
                f"No pretrained weights for '{self.name}' at {p}.")
        want = self.manifest().get(self.name)
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
