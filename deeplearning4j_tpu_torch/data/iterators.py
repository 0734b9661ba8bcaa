"""DataSet iterators: the base contract and in-memory batching.

Counterpart of deeplearning4j_tpu/data/iterators.py (``DataSetIterator``
with ``set_pre_processor``, ``ListDataSetIterator`` and
``resolve_pre_processor``; parity surface: the reference's
DataSetIterator contract). A pre-processor (data/normalizers.py) applies
to every batch an iterator emits, unless it is ``device_side``: then the
containers apply its device transform after the copy to the card.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """Base contract: iterable of DataSet with reset(). ``iter()`` resets,
    as in the JAX package (and ``fit`` resets before each epoch too, so a
    shuffling iterator advances its seed the same way in both)."""

    pre_processor = None

    def set_pre_processor(self, pp):
        """Attach a normalizer (parity: setPreProcessor)."""
        self.pre_processor = pp
        return self

    def _emit(self, ds: DataSet) -> DataSet:
        pp = self.pre_processor
        if pp is not None and not getattr(pp, "device_side", False):
            ds = pp.pre_process(ds)
        return ds

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        pass

    def batch(self) -> int:
        return -1

    def total_outcomes(self) -> int:
        return -1

    def input_columns(self) -> int:
        return -1


class ListDataSetIterator(DataSetIterator):
    """Batches an in-memory DataSet (parity: ListDataSetIterator); with
    ``shuffle`` each reset draws a new order from ``seed + epoch``."""

    def __init__(self, dataset: DataSet, batch_size: int, shuffle=False,
                 seed=123, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._pos = 0
        self._order = np.arange(dataset.num_examples())

    def reset(self):
        self._pos = 0
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            self._order = rng.permutation(self.dataset.num_examples())
        self._epoch += 1

    def __next__(self):
        n = self.dataset.num_examples()
        if self._pos >= n:
            raise StopIteration
        end = min(self._pos + self.batch_size, n)
        if self.drop_last and end - self._pos < self.batch_size:
            raise StopIteration
        idx = self._order[self._pos:end]
        self._pos = end
        return self._emit(self.dataset._rows(idx))

    def batch(self):
        return self.batch_size

    def total_outcomes(self):
        return int(self.dataset.labels.shape[-1])

    def input_columns(self):
        return int(np.prod(self.dataset.features.shape[1:]))


def resolve_pre_processor(data):
    """The pre-processor attached to ``data`` or to an iterator it wraps
    (its ``base``, up to 8 hops), or None."""
    d, hops = data, 0
    while d is not None and hops < 8:
        pp = getattr(d, "pre_processor", None)
        if pp is not None:
            return pp
        d = getattr(d, "base", None)
        hops += 1
    return None
