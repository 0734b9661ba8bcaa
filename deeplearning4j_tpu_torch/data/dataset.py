"""The DataSet and MultiDataSet containers.

Counterpart of deeplearning4j_tpu/data/dataset.py (parity surface: nd4j
``DataSet`` -- features, labels and their optional masks -- and
``MultiDataSet``, one of each per network input and output, which a
ComputationGraph trains on). Arrays stay host numpy until a network moves
a batch onto its device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


def host_tensor(a) -> torch.Tensor:
    """A host array as a CPU tensor, float64 as float32: the JAX
    package's arrays are 32-bit (``jnp.asarray`` with x64 off), so a
    float64 batch (numpy's default) trains and serves as float32 in both
    packages."""
    t = torch.as_tensor(np.ascontiguousarray(a))
    return t.float() if t.dtype == torch.float64 else t


def _take(a, idx):
    return None if a is None else a[idx]


@dataclass
class DataSet:
    features: np.ndarray = None
    labels: np.ndarray = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self):
        return 0 if self.features is None else int(self.features.shape[0])

    def to_multi(self) -> "MultiDataSet":
        return MultiDataSet(
            features=[self.features], labels=[self.labels],
            features_masks=[self.features_mask],
            labels_masks=[self.labels_mask])

    def _rows(self, idx) -> "DataSet":
        return DataSet(self.features[idx], self.labels[idx],
                       _take(self.features_mask, idx),
                       _take(self.labels_mask, idx))

    def split_test_and_train(self, n_train: int):
        return self._rows(slice(0, n_train)), self._rows(slice(n_train, None))

    def shuffle(self, seed=None):
        idx = np.random.RandomState(seed).permutation(self.num_examples())
        shuffled = self._rows(idx)
        self.features, self.labels = shuffled.features, shuffled.labels
        self.features_mask = shuffled.features_mask
        self.labels_mask = shuffled.labels_mask
        return self

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self._rows(slice(i, i + batch_size))
                for i in range(0, self.num_examples(), batch_size)]

    @staticmethod
    def merge(datasets: List["DataSet"]) -> "DataSet":
        def cat(name):
            parts = [getattr(d, name) for d in datasets]
            return None if parts[0] is None else np.concatenate(parts)
        return DataSet(cat("features"), cat("labels"), cat("features_mask"),
                       cat("labels_mask"))


@dataclass
class MultiDataSet:
    features: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self):
        return 0 if not self.features else int(self.features[0].shape[0])
