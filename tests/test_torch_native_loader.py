"""The port's native record readers and async batcher (native/,
data/native_loader.py) on the CPU, against the JAX package's.

- The port builds its own copy of recordreader.cpp with g++ into
  ``build/native/`` under a name that carries the source's digest.
- IDX and CSV parses equal the JAX package's bit for bit, and bad files
  raise the same errors.
- ``NativeAsyncDataSetIterator`` yields the JAX iterator's batches, bit
  for bit and in its order, over two epochs, shuffled and not, with a
  partial last batch.
- A 2 x LSTM ``fit(iterator)`` fed by the port's iterator ends within
  1e-5 of the JAX network fed by the JAX iterator, from the same weights.
"""

import struct
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.data import native_loader as jloader
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.data import native_loader as loader

from test_torch_regularised_training import port_of
from test_torch_training import _jax_conf, _params_close


@pytest.fixture(autouse=True)
def _libraries():
    """Both packages' libraries, built at first use (g++), or a skip."""
    if not (native.available() and jnative.available()):
        pytest.skip("g++ is needed to build the record readers")


def _write_idx(tmp_path, n=40, rows=5, cols=4, n_classes=7, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (n, rows, cols)).astype(np.uint8)
    labs = rs.randint(0, n_classes, n).astype(np.uint8)
    ip = tmp_path / "t-images-idx3-ubyte"
    lp = tmp_path / "t-labels-idx1-ubyte"
    ip.write_bytes(struct.pack(">IIII", 0x0803, n, rows, cols)
                   + imgs.tobytes())
    lp.write_bytes(struct.pack(">II", 0x0801, n) + labs.tobytes())
    return str(ip), str(lp), imgs, labs


def _write_csv(tmp_path, n=30, seed=1):
    rs = np.random.RandomState(seed)
    data = rs.randn(n, 5).astype(np.float32)
    labs = rs.randint(0, 3, n)
    p = tmp_path / "d.csv"
    p.write_text("a,b,c,d,e,label\n" + "".join(
        ",".join(f"{v:.6f}" for v in row) + f",{lab}\n"
        for row, lab in zip(data, labs)))
    return str(p)


def test_the_library_is_built_from_the_ports_source_into_build_native():
    info = native.build_info()
    path = Path(info["path"])
    root = Path(native.__file__).resolve().parents[2]
    assert path.parent == root / "build" / "native"
    assert path == native.lib_path()
    assert native.lib_path().name.startswith("librecordreader-")
    assert info["error"] is None
    src = Path(native.__file__).resolve().parent / "recordreader.cpp"
    assert src.read_bytes() == (Path(jnative.__file__).resolve().parent
                                / "recordreader.cpp").read_bytes()


def test_disabled_returns_none(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_NO_NATIVE", "1")
    assert native.get_lib() is None and not native.available()
    assert loader.load_csv_native("whatever.csv") is None


def test_a_failed_build_is_reported(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_info",
                        {"path": None, "seconds": 0.0, "error": None})
    assert native._build() is None
    assert native.build_error().startswith("g++ exited")
    assert "broken.cpp" in native.build_error()
    assert not list((tmp_path / "out").glob("*.so"))


def test_idx_parse_equals_jax(tmp_path):
    ip, lp, imgs, labs = _write_idx(tmp_path)
    x, y = loader.load_idx_native(ip, lp, n_classes=7)
    jx, jy = jloader.load_idx_native(ip, lp, n_classes=7)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()
    np.testing.assert_allclose(
        x, imgs.reshape(40, -1).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(y, np.eye(7, dtype=np.float32)[labs])


@pytest.mark.parametrize("which", ["idx", "csv_long_line"])
def test_bad_files_raise_the_jax_errors(tmp_path, which):
    if which == "idx":
        p = tmp_path / "bogus"
        p.write_bytes(b"not an idx file at all")
        call = ("load_idx_native", (str(p), str(p)))
    else:
        p = tmp_path / "long.csv"
        p.write_text("1," * 40000 + "1\n")
        call = ("load_csv_native", (str(p),))
    errs = []
    for mod in (loader, jloader):
        with pytest.raises(ValueError) as e:
            getattr(mod, call[0])(*call[1])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("label_col", [5, -1])
def test_csv_parse_equals_jax(tmp_path, label_col):
    p = _write_csv(tmp_path)
    kw = dict(label_col=label_col, n_classes=3 if label_col >= 0 else 0,
              skip_lines=1)
    x, y = loader.load_csv_native(p, **kw)
    jx, jy = jloader.load_csv_native(p, **kw)
    assert x.tobytes() == jx.tobytes()
    assert (y is None and jy is None) or y.tobytes() == jy.tobytes()


def _epochs(it, n):
    out = []
    for _ in range(n):
        out.append([(d.features.copy(), d.labels.copy()) for d in it])
    return out


@pytest.mark.parametrize("shuffle", [True, False])
def test_iterator_batches_equal_jax_over_two_epochs(shuffle):
    rs = np.random.RandomState(2)
    x = rs.randn(37, 3, 2).astype(np.float32)   # 37 rows: a partial batch
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 37)]
    it = loader.NativeAsyncDataSetIterator(x, y, 8, shuffle=shuffle,
                                           seed=11, prefetch=2)
    jit = jloader.NativeAsyncDataSetIterator(x, y, 8, shuffle=shuffle,
                                             seed=11, prefetch=2)
    got, want = _epochs(it, 2), _epochs(jit, 2)
    assert [len(e) for e in got] == [5, 5]
    assert got[0][-1][0].shape == (5, 3, 2)
    for ge, we in zip(got, want):
        for (gx, gy), (wx, wy) in zip(ge, we):
            assert gx.tobytes() == wx.tobytes()
            assert gy.tobytes() == wy.tobytes()
    assert it.batches == 10
    assert (it.batch(), it.total_outcomes(), it.input_columns()) == (8, 4, 6)
    if shuffle:
        assert not np.array_equal(got[0][0][0], got[1][0][0])
    it.close()
    jit.close()
    assert next(it, None) is None


def test_lstm_fit_fed_by_the_native_iterator_matches_jax():
    jnet = JaxMLN(_jax_conf()).init()
    net = port_of(jnet)
    rs = np.random.RandomState(5)
    eye = np.eye(9, dtype=np.float32)
    x, y = eye[rs.randint(0, 9, (20, 8))], eye[rs.randint(0, 9, (20, 8))]
    it = loader.NativeAsyncDataSetIterator(x, y, 4, seed=3)
    jit = jloader.NativeAsyncDataSetIterator(x, y, 4, seed=3)
    net.fit(it, epochs=2)
    jnet.fit(jit, epochs=2)
    assert net.iteration == jnet.iteration == 10
    assert it.batches == 10
    _params_close(jnet, net, tol=1e-5)
