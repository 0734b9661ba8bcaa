"""Fetchers and iterators of the standard datasets: MNIST, EMNIST,
CIFAR-10, Iris, TinyImageNet and LFW.

Counterpart of deeplearning4j_tpu/data/fetchers.py, copied (numpy only):
each fetcher reads the real files under ``DL4JTPU_DATA_DIR`` (default
``~/.deeplearning4j_tpu/``) when they are there, and otherwise generates
the JAX package's deterministic, class-structured synthetic data with the
real shapes and split sizes, array for array the same. The image
iterators hold and emit uint8 features (``uint8_wire``, the default) with
a ``device_side`` ImagePreProcessingScaler attached, so a batch crosses
the link at one byte a pixel and the /255 runs on the card.
TinyImageNet and LFW read a class-per-directory image tree
(``load_image_tree``, with PIL). ``data_source(name)`` says whether the
last load of a dataset read files (``real``) or generated them
(``synthetic``).
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from pathlib import Path

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

log = logging.getLogger(__name__)


def _uint8_wire(x):
    """Float [0, 1] features as uint8 (round(x * 255)): exact for real
    image data, under 1/255 off for synthetic."""
    return np.round(np.asarray(x, np.float32) * 255.0).astype(np.uint8)


def _wire_pp():
    from deeplearning4j_tpu_torch.data.normalizers import \
        ImagePreProcessingScaler
    return ImagePreProcessingScaler(0.0, 1.0, 255.0, device_side=True)


def data_dir() -> Path:
    return Path(os.environ.get("DL4JTPU_DATA_DIR",
                               str(Path.home() / ".deeplearning4j_tpu")))


# the provenance of the last load per dataset name: "real" (read from
# files under data_dir()) or "synthetic" (the generated fallback)
_SOURCES: dict = {}


def data_source(name: str) -> str:
    return _SOURCES.get(name, "unknown")


def _one_hot(y, n):
    out = np.zeros((y.shape[0], n), np.float32)
    out[np.arange(y.shape[0]), y] = 1.0
    return out


def _synthetic_images(n, h, w, c, n_classes, seed, template_seed=1234):
    """Deterministic, learnable and not trivial image data: class
    templates share one base pattern; each class adds a smooth pattern
    scaled so the best classifier errs ~1%; Gaussian noise of comparable
    energy; 1% of the labels flipped after the image is drawn. A trained
    LeNet lands at ~96-99%, never 100."""
    sigma = 0.18                      # per-pixel sample-noise std
    trng = np.random.RandomState(template_seed + n_classes * 1000 + h)
    shared = (0.35 + 0.3 * trng.rand(h, w, c)).astype(np.float32)

    # low-frequency class patterns (Gaussian-filtered white noise, unit
    # L2 norm), which convolution and pooling learn quickly
    def smooth(a):
        r = max(1, h // 8)
        xs = np.arange(-3 * r, 3 * r + 1)
        k = np.exp(-0.5 * (xs / r) ** 2)
        k /= k.sum()
        for ax in (0, 1):
            a = np.apply_along_axis(
                lambda v: np.convolve(v, k, mode="same"), ax, a)
        return a

    unique = np.stack([smooth(trng.randn(h, w, c)) for _ in
                       range(n_classes)]).astype(np.float32)
    unique /= np.sqrt((unique ** 2).sum(axis=(1, 2, 3), keepdims=True))
    # matched-filter half-gap z = amp*sqrt(2)/(2*sigma): the union-bound
    # Bayes error (C-1)*Q(z) lands ~1-2% at C=10
    amp = 3.4 * 2.0 * sigma / np.sqrt(2.0)
    templates = shared[None] + amp * unique
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, size=n)
    noise = rng.randn(n, h, w, c).astype(np.float32) * sigma
    x = np.clip(templates[y] + noise, 0.0, 1.0)
    flip = rng.rand(n) < 0.01         # deterministic 1% label noise
    y = np.where(flip, rng.randint(0, n_classes, size=n), y)
    return x, y


# ----------------------------------------------------------------- MNIST

def _read_idx_images(path):
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n, h, w = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad IDX magic {magic}"
        return np.frombuffer(f.read(n * h * w), np.uint8).reshape(n, h, w)


def _read_idx_labels(path):
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad IDX magic {magic}"
        return np.frombuffer(f.read(n), np.uint8)


def load_mnist(train=True, num_examples=None, flatten=True, seed=123):
    """(features, one-hot labels): features in [0, 1], (N, 784) flat or
    (N, 28, 28, 1) NHWC."""
    d = data_dir() / "mnist"
    stem = "train" if train else "t10k"
    img_p = next((p for p in (d / f"{stem}-images-idx3-ubyte",
                              d / f"{stem}-images-idx3-ubyte.gz")
                  if p.exists()), None)
    lab_p = next((p for p in (d / f"{stem}-labels-idx1-ubyte",
                              d / f"{stem}-labels-idx1-ubyte.gz")
                  if p.exists()), None)
    if img_p and lab_p:
        x = _read_idx_images(img_p).astype(np.float32) / 255.0
        x = x[..., None]
        y = _read_idx_labels(lab_p).astype(np.int64)
        _SOURCES["mnist"] = "real"
    else:
        n = 60000 if train else 10000
        x, y = _synthetic_images(n, 28, 28, 1, 10, seed if train else seed + 1)
        _SOURCES["mnist"] = "synthetic"
    if num_examples is not None:
        x, y = x[:num_examples], y[:num_examples]
    if flatten:
        x = x.reshape(x.shape[0], -1)
    return x, _one_hot(y, 10)


class MnistDataSetIterator(ListDataSetIterator):
    """MNIST batches (parity: MnistDataSetIterator(batch, train[, shuffle,
    seed, numExamples])); uint8 on the wire unless ``uint8_wire=False``."""

    def __init__(self, batch_size, train=True, shuffle=True, seed=123,
                 num_examples=None, flatten=True, uint8_wire=True):
        x, y = load_mnist(train, num_examples, flatten, seed)
        if uint8_wire:
            x = _uint8_wire(x)
        super().__init__(DataSet(x, y), batch_size, shuffle=shuffle, seed=seed)
        if uint8_wire:
            self.set_pre_processor(_wire_pp())


class EmnistDataSetIterator(ListDataSetIterator):
    """EMNIST (parity: EmnistDataSetIterator). Sets: letters (26), digits
    (10), balanced (47), byclass (62), bymerge (47), mnist (10)."""

    _CLASSES = {"letters": 26, "digits": 10, "balanced": 47, "byclass": 62,
                "bymerge": 47, "mnist": 10}

    def __init__(self, dataset: str, batch_size, train=True, seed=123,
                 num_examples=None, flatten=True, uint8_wire=True):
        ncls = self._CLASSES[dataset]
        d = data_dir() / "emnist"
        stem = f"emnist-{dataset}-{'train' if train else 'test'}"
        img_p = d / f"{stem}-images-idx3-ubyte"
        lab_p = d / f"{stem}-labels-idx1-ubyte"
        if img_p.exists() and lab_p.exists():
            x = _read_idx_images(img_p).astype(np.float32) / 255.0
            x = x[..., None]
            y = _read_idx_labels(lab_p).astype(np.int64)
            if y.max() >= ncls:  # EMNIST letters labels are 1-indexed
                y = y - y.min()
        else:
            n = num_examples or (10000 if train else 2000)
            x, y = _synthetic_images(n, 28, 28, 1, ncls, seed)
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        if flatten:
            x = x.reshape(x.shape[0], -1)
        if uint8_wire:
            x = _uint8_wire(x)
        super().__init__(DataSet(x, _one_hot(y, ncls)), batch_size,
                         shuffle=True, seed=seed)
        if uint8_wire:
            self.set_pre_processor(_wire_pp())


# ----------------------------------------------------------------- CIFAR

def load_cifar10(train=True, num_examples=None, seed=123):
    """CIFAR-10, NHWC in [0, 1]; the binary batches when present."""
    d = data_dir() / "cifar10"
    files = ([d / f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else [d / "test_batch.bin"])
    if all(p.exists() for p in files):
        xs, ys = [], []
        for p in files:
            raw = np.fromfile(p, np.uint8).reshape(-1, 3073)
            ys.append(raw[:, 0].astype(np.int64))
            xs.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        x = np.concatenate(xs).astype(np.float32) / 255.0
        y = np.concatenate(ys)
        _SOURCES["cifar10"] = "real"
    else:
        n = 50000 if train else 10000
        if num_examples is not None:
            n = min(n, num_examples)
        x, y = _synthetic_images(n, 32, 32, 3, 10, seed if train else seed + 1)
        _SOURCES["cifar10"] = "synthetic"
    if num_examples is not None:
        x, y = x[:num_examples], y[:num_examples]
    return x, _one_hot(y, 10)


class CifarDataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size, num_examples=None, train=True, seed=123,
                 uint8_wire=True):
        x, y = load_cifar10(train, num_examples, seed)
        if uint8_wire:
            x = _uint8_wire(x)
        super().__init__(DataSet(x, y), batch_size, shuffle=train, seed=seed)
        if uint8_wire:
            self.set_pre_processor(_wire_pp())


# ------------------------------------------------------------------ Iris

_IRIS_MEANS = np.array([
    [5.006, 3.428, 1.462, 0.246],
    [5.936, 2.770, 4.260, 1.326],
    [6.588, 2.974, 5.552, 2.026]], np.float32)
_IRIS_STD = np.array([
    [0.352, 0.379, 0.174, 0.105],
    [0.516, 0.314, 0.470, 0.198],
    [0.636, 0.322, 0.552, 0.275]], np.float32)


def load_iris(seed=6):
    """150 x 4 iris-like rows drawn from the real per-class Gaussian
    statistics (``<data_dir>/iris.csv`` when present)."""
    p = data_dir() / "iris.csv"
    if p.exists():
        raw = np.loadtxt(p, delimiter=",")
        x, y = raw[:, :4].astype(np.float32), raw[:, 4].astype(np.int64)
    else:
        rng = np.random.RandomState(seed)
        xs, ys = [], []
        for c in range(3):
            xs.append(_IRIS_MEANS[c]
                      + rng.randn(50, 4).astype(np.float32) * _IRIS_STD[c])
            ys.append(np.full(50, c, np.int64))
        x, y = np.concatenate(xs), np.concatenate(ys)
        idx = rng.permutation(150)
        x, y = x[idx], y[idx]
    return x, _one_hot(y, 3)


class IrisDataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size=150, num_examples=150, seed=6):
        x, y = load_iris(seed)
        x, y = x[:num_examples], y[:num_examples]
        super().__init__(DataSet(x, y), batch_size, shuffle=False)


# ------------------------------------------- directory-tree image datasets

_IMAGE_EXTS = (".jpeg", ".jpg", ".png", ".bmp", ".ppm", ".gif")


def load_image_tree(root, image_shape, num_examples=None, num_classes=None,
                    seed=123):
    """Read a class-per-directory image tree (the on-disk format of
    TinyImageNet's train split and LFW) into (x NHWC float [0,1], y int,
    the number of classes).

    ``root/<class_name>/**/*.jpg``: the class index is the sorted
    directory order. Images are resized to ``image_shape`` with PIL, in
    an order drawn from ``seed``. Returns None when the tree is absent or
    empty, so callers can fall back to synthetic data."""
    root = Path(root)
    if not root.is_dir():
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    class_dirs = sorted(d for d in root.iterdir() if d.is_dir())
    if not class_dirs:
        return None
    if num_classes is None:
        num_classes = len(class_dirs)
    h, w, c = image_shape
    paths, labels = [], []
    for ci, d in enumerate(class_dirs):
        for p in sorted(d.rglob("*")):
            if p.suffix.lower() in _IMAGE_EXTS:
                paths.append(p)
                labels.append(ci)
    if not paths:
        return None
    order = np.random.RandomState(seed).permutation(len(paths))
    if num_examples is not None:
        order = order[:num_examples]
    xs = np.empty((len(order), h, w, c), np.float32)
    ys = np.empty(len(order), np.int64)
    k = skipped = 0
    for oi in order:
        try:
            img = Image.open(paths[oi])
            img = img.convert("RGB" if c == 3 else "L")
            if img.size != (w, h):
                img = img.resize((w, h))
            arr = np.asarray(img, np.float32) / 255.0
        except Exception:  # noqa: BLE001 -- truncated/corrupt file on disk
            # one bad file must not stop a large load: skipped and counted
            skipped += 1
            continue
        xs[k] = arr[..., None] if c == 1 else arr
        ys[k] = labels[oi]
        k += 1
    if skipped:
        from deeplearning4j_tpu_torch.monitor import get_registry
        get_registry().counter(
            "dl4jtpu_fetcher_unreadable_images_total",
            "Corrupt/unreadable image files skipped by load_image_tree."
        ).inc(skipped)
        log.warning("load_image_tree(%s): skipped %d unreadable image(s)",
                    root, skipped)
    if k == 0:
        return None
    return xs[:k], ys[:k], num_classes


class TinyImageNetDataSetIterator(ListDataSetIterator):
    """64x64x3, 200 classes (parity: TinyImageNetDataSetIterator). Reads the
    real dataset from ``<data_dir>/tinyimagenet/{train,val}/`` when present
    (class-per-directory tree; TinyImageNet's ``<wnid>/images/*.JPEG``
    nesting is handled by the recursive glob), else deterministic synthetic
    data with the real shapes."""

    def __init__(self, batch_size, num_examples=2000, train=True, seed=123,
                 uint8_wire=True):
        split = "train" if train else "val"
        real = load_image_tree(data_dir() / "tinyimagenet" / split,
                               (64, 64, 3), num_examples, 200, seed)
        if real is not None:
            x, y, _ = real
            _SOURCES["tinyimagenet"] = "real"
        else:
            x, y = _synthetic_images(num_examples, 64, 64, 3, 200,
                                     seed if train else seed + 1)
            _SOURCES["tinyimagenet"] = "synthetic"
        if uint8_wire:
            x = _uint8_wire(x)
        super().__init__(DataSet(x, _one_hot(y, 200)), batch_size,
                         shuffle=train, seed=seed)
        if uint8_wire:
            self.set_pre_processor(_wire_pp())


class LFWDataSetIterator(ListDataSetIterator):
    """Labeled-faces-in-the-wild (parity: LFWDataSetIterator). Reads the
    real person-per-directory tree from ``<data_dir>/lfw/`` when present,
    else synthetic data with the real shapes."""

    def __init__(self, batch_size, num_examples=1000, num_labels=5749,
                 image_shape=(250, 250, 3), train=True, seed=123,
                 uint8_wire=True):
        h, w, c = image_shape
        real = load_image_tree(data_dir() / "lfw", image_shape,
                               num_examples, num_labels, seed)
        if real is not None:
            x, y, n_found = real
            num_labels = max(num_labels, n_found)
            _SOURCES["lfw"] = "real"
        else:
            x, y = _synthetic_images(num_examples, h, w, c, num_labels,
                                     seed if train else seed + 1)
            _SOURCES["lfw"] = "synthetic"
        if uint8_wire:
            x = _uint8_wire(x)
        super().__init__(DataSet(x, _one_hot(y, num_labels)), batch_size,
                         shuffle=train, seed=seed)
        if uint8_wire:
            self.set_pre_processor(_wire_pp())
