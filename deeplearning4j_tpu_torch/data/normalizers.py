"""Data normalizers.

Counterpart of deeplearning4j_tpu/data/normalizers.py, copied: the same
numpy statistics, ``transform`` / ``revert`` and ``to_dict`` documents (a
``normalizer.json`` written by either package reads in the other), and
``as_device_transform`` as torch operations. Parity surface: nd4j's
``NormalizerStandardize``, ``NormalizerMinMaxScaler`` and
``ImagePreProcessingScaler``, attached with ``iterator.
set_pre_processor`` and kept in a model zip.

A normalizer with ``device_side=True`` is not applied by the iterator:
the containers apply ``as_device_transform()`` to the features on the
card after the copy, so raw (uint8) batches cross the link.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet


class Normalizer:
    #: applied on the card after the copy (the iterator passes the batch
    #: through raw); off by default, as in the reference
    device_side = False

    def fit(self, data):
        """Statistics of a DataSet's features, or of an iterator's."""
        if isinstance(data, DataSet):
            self._fit_arrays([data.features])
            return self
        if hasattr(data, "reset"):
            data.reset()
        self._fit_arrays([d.features for d in data])
        return self

    def as_device_transform(self):
        """A function of a features tensor equal to
        ``transform_features`` in float32 (None: none on the device)."""
        return None

    def _fit_arrays(self, arrays):
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        ds.features = self.transform_features(ds.features)
        return ds

    def transform_features(self, f):
        raise NotImplementedError

    def revert_features(self, f):
        raise NotImplementedError

    def pre_process(self, ds: DataSet):
        return self.transform(ds)

    def to_dict(self):
        raise NotImplementedError

    @staticmethod
    def from_dict(d):
        cls = {c.__name__: c for c in
               (NormalizerStandardize, NormalizerMinMaxScaler,
                ImagePreProcessingScaler)}[d["@type"]]
        return cls._from_dict(d)


def _on_device(*stats):
    """A function of a device giving ``stats`` (per-feature arrays) as
    float32 tensors there, copied once per device."""
    cache = {}

    def get(device):
        if device not in cache:
            cache[device] = [torch.as_tensor(np.asarray(a),
                                             dtype=torch.float32,
                                             device=device) for a in stats]
        return cache[device]
    return get


class NormalizerStandardize(Normalizer):
    """Zero mean, unit variance per feature."""

    def __init__(self, device_side=False):
        self.device_side = device_side
        self.mean = None
        self.std = None

    def _fit_arrays(self, arrays):
        flat = np.concatenate([a.reshape(a.shape[0], -1) for a in arrays])
        self.mean = flat.mean(axis=0)
        self.std = flat.std(axis=0) + 1e-8

    def transform_features(self, f):
        shape = f.shape
        out = (f.reshape(shape[0], -1) - self.mean) / self.std
        return out.reshape(shape).astype(f.dtype)

    def revert_features(self, f):
        shape = f.shape
        out = f.reshape(shape[0], -1) * self.std + self.mean
        return out.reshape(shape).astype(f.dtype)

    def to_dict(self):
        return {"@type": "NormalizerStandardize",
                "mean": self.mean.tolist(), "std": self.std.tolist()}

    @classmethod
    def _from_dict(cls, d):
        n = cls()
        n.mean = np.asarray(d["mean"])
        n.std = np.asarray(d["std"])
        return n

    def as_device_transform(self):
        stats = _on_device(self.mean, self.std)

        def fn(f):
            # (B, ...) or a stacked (S, B, ...) block: flattened to the
            # per-example width the statistics were fit on
            mean, std = stats(f.device)
            return ((f.reshape(-1, mean.shape[0]).float() - mean) / std) \
                .reshape(f.shape)
        return fn


class NormalizerMinMaxScaler(Normalizer):
    """Each feature scaled from its [min, max] to [min_range,
    max_range]."""

    def __init__(self, min_range=0.0, max_range=1.0, device_side=False):
        self.device_side = device_side
        self.min_range = min_range
        self.max_range = max_range
        self.data_min = None
        self.data_max = None

    def _fit_arrays(self, arrays):
        flat = np.concatenate([a.reshape(a.shape[0], -1) for a in arrays])
        self.data_min = flat.min(axis=0)
        self.data_max = flat.max(axis=0)

    def transform_features(self, f):
        shape = f.shape
        span = np.maximum(self.data_max - self.data_min, 1e-8)
        out = (f.reshape(shape[0], -1) - self.data_min) / span
        out = out * (self.max_range - self.min_range) + self.min_range
        return out.reshape(shape).astype(f.dtype)

    def revert_features(self, f):
        shape = f.shape
        span = np.maximum(self.data_max - self.data_min, 1e-8)
        out = ((f.reshape(shape[0], -1) - self.min_range)
               / (self.max_range - self.min_range))
        out = out * span + self.data_min
        return out.reshape(shape).astype(f.dtype)

    def to_dict(self):
        return {"@type": "NormalizerMinMaxScaler",
                "min_range": self.min_range, "max_range": self.max_range,
                "data_min": self.data_min.tolist(),
                "data_max": self.data_max.tolist()}

    @classmethod
    def _from_dict(cls, d):
        n = cls(d["min_range"], d["max_range"])
        n.data_min = np.asarray(d["data_min"])
        n.data_max = np.asarray(d["data_max"])
        return n

    def as_device_transform(self):
        span = np.maximum(np.asarray(self.data_max)
                          - np.asarray(self.data_min), 1e-8)
        lo, hi = float(self.min_range), float(self.max_range)
        stats = _on_device(self.data_min, span)

        def fn(f):
            dmin, width = stats(f.device)
            out = (f.reshape(-1, dmin.shape[0]).float() - dmin) / width
            return (out * (hi - lo) + lo).reshape(f.shape)
        return fn


class ImagePreProcessingScaler(Normalizer):
    """Pixel values [0, max_pixel] scaled to [min_range, max_range]
    (default /255). With ``device_side=True`` and uint8 features a batch
    crosses the link at one byte a pixel and is scaled on the card."""

    def __init__(self, min_range=0.0, max_range=1.0, max_pixel=255.0,
                 device_side=False):
        self.device_side = device_side
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def _fit_arrays(self, arrays):
        pass  # stateless

    def transform_features(self, f):
        out = (f / self.max_pixel * (self.max_range - self.min_range)
               + self.min_range)
        return out.astype(np.float32)

    def revert_features(self, f):
        return ((f - self.min_range) / (self.max_range - self.min_range)
                * self.max_pixel).astype(np.float32)

    def to_dict(self):
        return {"@type": "ImagePreProcessingScaler",
                "min_range": self.min_range, "max_range": self.max_range,
                "max_pixel": self.max_pixel}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["min_range"], d["max_range"], d["max_pixel"])

    def as_device_transform(self):
        lo, hi, mp = (float(self.min_range), float(self.max_range),
                      float(self.max_pixel))

        def fn(f):
            return f.float() / mp * (hi - lo) + lo
        return fn
