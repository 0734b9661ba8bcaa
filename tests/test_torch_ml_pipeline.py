"""The port's ML-pipeline estimators (scaleout/ml_pipeline.py) and
object-store adapters (scaleout/s3.py) on the CPU, against the JAX
package's.

- The JAX tests' scenarios, each estimator's network starting from the
  JAX estimator's initial weights (the port's ``MultiLayerNetwork.init``
  patched, test side only, to load them: both estimators build their
  network inside ``fit``): ``predict_proba`` within 1e-4, equal
  ``score``s, the sklearn protocol, save / load.
- ``AutoEncoderModel.transform`` and ``Pipeline`` against JAX's.
- ``workers=4``: the fit through the port's ``ParallelWrapper`` over four
  CPU slots against the JAX wrapper over four host devices.
- ``S3Downloader`` / ``S3Uploader`` over ``LocalFileStore`` make the JAX
  adapters' trees (prefix boundaries, the fetcher cache), and the boto3
  gate raises the JAX message.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.scaleout import ml_pipeline as jpipe
from deeplearning4j_tpu.scaleout import s3 as js3

from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.nn.conf.configuration import \
    MultiLayerConfiguration
from deeplearning4j_tpu_torch.scaleout import (AutoEncoderEstimator,
                                               NetworkClassifier,
                                               NetworkModel, Pipeline)
from deeplearning4j_tpu_torch.scaleout import s3

PROBA_TOL = 1e-4


def _clf_conf(n_in=8, hidden=24, seed=7):
    return (JaxNNC.builder().seed(seed).updater(JaxAdam(1e-2)).list()
            .layer(JaxDense(n_in=n_in, n_out=hidden, activation="relu"))
            .layer(JaxOut(n_in=hidden, n_out=3, activation="softmax",
                          loss="mcxent"))
            .build())


def _ae_conf():
    return (JaxNNC.builder().seed(5).updater(JaxAdam(1e-2)).list()
            .layer(JaxDense(n_in=8, n_out=3, activation="tanh"))
            .layer(JaxOut(n_in=3, n_out=8, activation="identity",
                          loss="mse"))
            .build())


def _port_factory(jax_factory):
    return lambda: MultiLayerConfiguration.from_json(
        jax_factory().to_json())


@pytest.fixture
def jax_init(monkeypatch):
    """The port's ``MultiLayerNetwork.init`` loads the parameters the JAX
    package's init draws for the same configuration."""
    orig = MultiLayerNetwork.init

    def init(self, seed=None):
        orig(self, seed)
        jnet = JaxMLN(jpipe_conf_of(self)).init(seed)
        arrays = jax.tree_util.tree_map(np.asarray, jnet.params)
        return self.set_params(params_from_numpy(arrays,
                                                 device=self.device))
    monkeypatch.setattr(MultiLayerNetwork, "init", init)


def jpipe_conf_of(net):
    from deeplearning4j_tpu.nn.conf.configuration import \
        MultiLayerConfiguration as JaxMLC
    return JaxMLC.from_json(net.conf.to_json())


def _blobs(n=240, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(3, 8) * 3
    y = rs.randint(0, 3, n)
    return (centers[y] + rs.randn(n, 8) * 0.5).astype(np.float32), y


def _close(model, jmodel, X, y):
    np.testing.assert_allclose(model.predict_proba(X),
                               jmodel.predict_proba(X), rtol=0,
                               atol=PROBA_TOL)
    assert model.score(X, y) == jmodel.score(X, y)


def test_classifier_fit_predict_score_equal_jax(jax_init):
    X, y = _blobs()
    clf = NetworkClassifier(_port_factory(_clf_conf), epochs=20,
                            batch_size=32, device="cpu")
    model = clf.fit(X, y)
    jmodel = jpipe.NetworkClassifier(_clf_conf, epochs=20,
                                     batch_size=32).fit(X, y)
    _close(model, jmodel, X, y)
    assert model.score(X, y) > 0.9
    proba = model.predict_proba(X[:5])
    assert proba.shape == (5, 3) and isinstance(proba, np.ndarray)
    np.testing.assert_allclose(proba.sum(-1), 1.0, atol=1e-4)
    assert clf.score(X, y) == model.score(X, y)
    np.testing.assert_array_equal(clf.predict(X), model.predict(X))
    np.testing.assert_array_equal(clf.transform(X[:4]),
                                  model.predict_proba(X[:4]))
    # one-hot targets give the same fit
    onehot = np.eye(3, dtype=np.float32)[y]
    model2 = clf.fit(X, onehot)
    np.testing.assert_array_equal(model2.predict_proba(X),
                                  model.predict_proba(X))


def test_sklearn_protocol_and_save_load_equal_jax(jax_init, tmp_path):
    X, y = _blobs(120, seed=3)
    clf = NetworkClassifier(_port_factory(_clf_conf), epochs=5,
                            device="cpu")
    jclf = jpipe.NetworkClassifier(_clf_conf, epochs=5)
    params = clf.get_params()
    assert set(jclf.get_params()) | {"device"} == set(params)
    assert params["epochs"] == 5 and params["device"] == "cpu"
    with pytest.raises(ValueError, match="unknown parameter 'lr'"):
        clf.set_params(lr=0.1)
    clf.set_params(epochs=15, batch_size=64)
    jclf.set_params(epochs=15, batch_size=64)
    model, jmodel = clf.fit(X, y), jclf.fit(X, y)
    _close(model, jmodel, X, y)
    p = str(tmp_path / "clf.zip")
    model.save(p)
    loaded = NetworkModel.load(p, device="cpu")
    np.testing.assert_allclose(loaded.predict_proba(X[:8]),
                               model.predict_proba(X[:8]), rtol=0, atol=1e-6)
    # the port's zip loads in the JAX package
    np.testing.assert_allclose(jpipe.NetworkModel.load(p).predict_proba(
        X[:8]), model.predict_proba(X[:8]), rtol=0, atol=PROBA_TOL)


def test_autoencoder_transform_and_pipeline_equal_jax(jax_init):
    X, y = _blobs(160, seed=5)
    ae = AutoEncoderEstimator(_port_factory(_ae_conf), compressed_layer=0,
                              epochs=10, device="cpu")
    jae = jpipe.AutoEncoderEstimator(_ae_conf, compressed_layer=0,
                                     epochs=10)
    enc, jenc = ae.fit(X).transform(X), jae.fit(X).transform(X)
    assert enc.shape == (160, 3)
    np.testing.assert_allclose(enc, jenc, rtol=0, atol=PROBA_TOL)
    np.testing.assert_array_equal(ae.transform(X[:3]), enc[:3])

    def small(seed=7):
        return _clf_conf(n_in=3, hidden=16, seed=seed)

    pipe = Pipeline([
        ("encode", AutoEncoderEstimator(_port_factory(_ae_conf),
                                        compressed_layer=0, epochs=10,
                                        device="cpu")),
        ("classify", NetworkClassifier(_port_factory(small), epochs=25,
                                       batch_size=32, device="cpu"))])
    jpipeline = jpipe.Pipeline([
        ("encode", jpipe.AutoEncoderEstimator(_ae_conf, compressed_layer=0,
                                              epochs=10)),
        ("classify", jpipe.NetworkClassifier(small, epochs=25,
                                             batch_size=32))])
    pipe.fit(X, y)
    jpipeline.fit(X, y)
    assert pipe.predict(X).shape == (160,)
    np.testing.assert_allclose(pipe.transform(X), jpipeline.transform(X),
                               rtol=0, atol=PROBA_TOL)
    assert pipe.score(X, y) == jpipeline.score(X, y)
    assert pipe.score(X, y) > 0.6


def test_classifier_on_four_slots_equals_jax(jax_init):
    X, y = _blobs(192, seed=9)
    clf = NetworkClassifier(_port_factory(_clf_conf), epochs=40,
                            batch_size=48, workers=4, device="cpu")
    model = clf.fit(X, y)
    jmodel = jpipe.NetworkClassifier(_clf_conf, epochs=40, batch_size=48,
                                     workers=4).fit(X, y)
    _close(model, jmodel, X, y)
    assert model.score(X, y) > 0.85
    # the wrapper's fit is the plain fit's, batch by batch
    plain = NetworkClassifier(_port_factory(_clf_conf), epochs=40,
                              batch_size=48, device="cpu").fit(X, y)
    np.testing.assert_allclose(model.predict_proba(X),
                               plain.predict_proba(X), rtol=0, atol=1e-6)


# ---- the object-store adapters ---------------------------------------------

def _tree(tmp_path):
    d = tmp_path / "bundle"
    (d / "sub").mkdir(parents=True)
    (d / "a.txt").write_text("a")
    (d / "sub" / "b.txt").write_text("b")
    (d / "database.bin").write_bytes(b"\x00\x01")
    return d


def _files(root):
    return sorted((p.relative_to(root).as_posix(), p.read_bytes())
                  for p in Path(root).rglob("*") if p.is_file())


@pytest.mark.parametrize("prefix", ["data", "data/", ""])
def test_upload_and_download_make_the_jax_trees(tmp_path, prefix):
    d = _tree(tmp_path)
    trees = []
    for mod, tag in ((s3, "port"), (js3, "jax")):
        store = mod.LocalFileStore(tmp_path / f"store_{tag}")
        assert mod.S3Uploader(store).upload_dir(d, "bk", prefix=prefix) == 3
        src = tmp_path / f"k_{tag}.txt"
        src.write_text("x")
        mod.S3Uploader(store).upload_file(src, "bk", "database/x.txt")
        got = mod.S3Downloader(store).download_prefix(
            "bk", prefix, tmp_path / f"fetched_{tag}")
        trees.append((store.list_objects("bk"),
                      store.list_objects("bk", prefix="data"),
                      sorted(p.relative_to(tmp_path / f"fetched_{tag}")
                             .as_posix() for p in got),
                      _files(tmp_path / f"fetched_{tag}")))
    assert trees[0] == trees[1]


def test_download_dataset_lands_in_the_fetcher_cache(tmp_path, monkeypatch):
    from deeplearning4j_tpu.data.fetchers import data_dir as jdata_dir
    from deeplearning4j_tpu_torch.data.fetchers import data_dir
    monkeypatch.setenv("DL4JTPU_DATA_DIR", str(tmp_path / "cache"))
    store = s3.LocalFileStore(tmp_path / "store")
    src = tmp_path / "iris.csv"
    src.write_text("5.1,3.5,1.4,0.2,0\n")
    s3.S3Uploader(store).upload_file(src, "datasets", "iris/iris.csv")
    got = s3.S3Downloader(store).download_dataset("datasets", "iris", "iris")
    assert got == [data_dir() / "iris" / "iris.csv"]
    assert data_dir() == jdata_dir()
    assert got[0].read_text() == src.read_text()
    store.delete("datasets", "iris/iris.csv")
    assert store.list_objects("datasets") == []
    with pytest.raises(FileNotFoundError):
        s3.S3Downloader(store).download("datasets", "iris/iris.csv",
                                        tmp_path / "x")


def test_store_gates_the_optional_boto3(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    msgs = []
    for mod in (s3, js3):
        with pytest.raises(ImportError, match="boto3") as e:
            mod.S3ObjectStore()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ImportError, match="boto3"):
        s3.S3Downloader()
