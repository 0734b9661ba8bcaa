"""Native-backed data loading: the C++ record readers and the async
batcher.

Counterpart of deeplearning4j_tpu/data/native_loader.py (parity surface:
DataVec's record readers and AsyncDataSetIterator). The parse, shuffle,
gather and copy run in the port's own native library
(native/recordreader.cpp) on C++ worker threads, outside the GIL; the
batches are host numpy ``DataSet``s, which a network's ``fit(iterator)``
moves onto the card through its prefetcher (pinned memory and the copy
stream, data/prefetcher.py). The shuffle draws from the C++ source with
``seed + epoch``, so the batches are the JAX package's bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_idx_native(img_path: str, lab_path: str, n_classes: int = 10):
    """IDX (MNIST/EMNIST) -> (x f32[n, rows*cols] / 255, y one-hot). Raises
    on malformed files; returns None if the native lib is unavailable."""
    lib = native.get_lib()
    if lib is None:
        return None
    n = ctypes.c_int64()
    feat = ctypes.c_int64()
    rc = lib.idx_load(img_path.encode(), lab_path.encode(), n_classes,
                      ctypes.byref(n), ctypes.byref(feat), None, None)
    if rc != 0:
        raise ValueError(f"idx_load failed (code {rc}) for {img_path}")
    x = np.empty((n.value, feat.value), np.float32)
    y = np.empty((n.value, max(n_classes, 1)), np.float32)
    rc = lib.idx_load(img_path.encode(), lab_path.encode(), n_classes,
                      ctypes.byref(n), ctypes.byref(feat),
                      _fptr(x), _fptr(y))
    if rc != 0:
        raise ValueError(f"idx_load failed (code {rc}) for {img_path}")
    return x, y


def load_csv_native(path: str, label_col: int = -1, n_classes: int = 0,
                    skip_lines: int = 0, delimiter: str = ","):
    """CSV -> (x, y). label_col=-1: no label column (y None). Returns None
    if the native lib is unavailable. Plain numeric CSV only: quoted
    fields and embedded delimiters are unsupported; a line over 64 KiB
    raises (rc=8)."""
    lib = native.get_lib()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    d = ctypes.c_char(delimiter.encode())
    rc = lib.csv_dims(path.encode(), skip_lines, d,
                      ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise ValueError(f"csv_dims failed (code {rc}) for {path}")
    n, c = rows.value, cols.value
    n_feat = c - 1 if label_col >= 0 else c
    ydim = n_classes if n_classes > 0 else 1
    x = np.empty((n, n_feat), np.float32)
    y = np.zeros((n, ydim), np.float32)
    rc = lib.csv_load(path.encode(), skip_lines, d, c, label_col,
                      n_classes, _fptr(x), _fptr(y))
    if rc != 0:
        raise ValueError(f"csv_load failed (code {rc}) for {path}")
    if label_col < 0:
        return x, None
    return x, y


class NativeAsyncDataSetIterator(DataSetIterator):
    """Async minibatch iterator over in-memory arrays, each batch assembled
    by a C++ worker thread into a bounded queue (``prefetch`` = its
    capacity). Shuffles per epoch with ``seed + epoch``. ``batches`` counts
    the batches ``batcher_next`` handed out."""

    def __init__(self, features, labels, batch_size: int, shuffle=True,
                 seed: int = 123, prefetch: int = 4):
        lib = native.get_lib()
        if lib is None:
            raise RuntimeError(
                "native library unavailable -- use AsyncDataSetIterator"
                + (f" (build error: {native.build_error()})"
                   if native.build_error() else ""))
        self._lib = lib
        # contiguous copies the C++ thread reads for the iterator's life
        self._x = np.ascontiguousarray(features, np.float32)
        self._y = np.ascontiguousarray(labels, np.float32)
        self._n = self._x.shape[0]
        self._xdim = int(np.prod(self._x.shape[1:]))
        self._ydim = int(np.prod(self._y.shape[1:]))
        self._xshape = self._x.shape[1:]
        self._yshape = self._y.shape[1:]
        self.batch_size = batch_size
        self.batches = 0
        self._h = lib.batcher_create(
            _fptr(self._x), _fptr(self._y), self._n, self._xdim, self._ydim,
            batch_size, 1 if shuffle else 0, seed, prefetch)

    def __next__(self) -> DataSet:
        if self._h is None:
            raise StopIteration
        xb = np.empty((self.batch_size, self._xdim), np.float32)
        yb = np.empty((self.batch_size, self._ydim), np.float32)
        cnt = self._lib.batcher_next(self._h, _fptr(xb), _fptr(yb))
        if cnt == 0:
            raise StopIteration
        self.batches += 1
        return DataSet(xb[:cnt].reshape((cnt,) + self._xshape),
                       yb[:cnt].reshape((cnt,) + self._yshape))

    def reset(self):
        if self._h is not None:
            self._lib.batcher_reset(self._h)

    def batch(self):
        return self.batch_size

    def total_outcomes(self):
        return self._ydim

    def input_columns(self):
        return self._xdim

    def close(self):
        if self._h is not None:
            self._lib.batcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
