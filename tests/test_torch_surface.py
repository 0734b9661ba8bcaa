"""The port's public surface against the JAX package's, on the CPU.

- Package namespaces: every name of a JAX package's ``__all__`` whose
  module is ported imports from the port's package (``parallel``,
  ``parallel.distributed``, ``scaleout``, ``exec``'s mesh names and the
  elastic cluster's four modules too); the names still to port are listed (ROADMAP queue 1 items 7 and
  8), with ``exec.aot``'s ``export_compiled``, an XLA executable's
  export, and ``exec``'s measured route tables, which have no
  counterpart.
- The configuration builder: the JAX setters (``bias_init``,
  ``learning_rate``, ``optimization_algo``, ``dtype``, ``compute_dtype``,
  ``mini_batch``, ``minimize``), ``ListBuilder.layer(index, layer)`` and
  ``MultiLayerConfiguration.output_types()``: the same chains give one
  ``to_json()`` document in both packages.
- Serving entry points: ``InferenceClient.warmup`` and ``keep_alive``,
  ``MicroBatcher.predict``, ``InferenceServer(request_timeout_ms=)``,
  ``InferenceServer(fault_injector=)`` and ``POST /chaos``.
- The zoo's pretrained zip: a zip under ``DL4JTPU_DATA_DIR/pretrained/``
  loads in both packages, ahead of the bundled one, checked against the
  manifest ``write_manifest_entry`` writes (the same digest in both).
- The image-tree fetchers (``load_image_tree``,
  ``TinyImageNetDataSetIterator``, ``LFWDataSetIterator``,
  ``data_source``): a small class-per-directory tree made with PIL in a
  temporary directory (a corrupt file among it) gives the same pixels,
  labels and order in both packages; without a tree, the same synthetic
  data.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from test_torch_kv_migrate import jax_tiny
from test_torch_regularised_training import port_of

V = 13

# JAX __all__ names whose modules wait for later items (the streaming
# data path; scaleout's ml_pipeline, item 8; the executor's sharding
# specs and param_spec, item 7's tensor-parallel part), or that have no
# counterpart (an XLA executable's export; the measured route tables)
NOT_PORTED = {
    "deeplearning4j_tpu": set(),
    "deeplearning4j_tpu.serving": set(),
    "deeplearning4j_tpu.data": {"StreamingDataSetIterator", "encode_record",
                                "decode_record"},
    "deeplearning4j_tpu.resilience": set(),
    "deeplearning4j_tpu.monitor": set(),
    "deeplearning4j_tpu.exec.programs": set(),
    "deeplearning4j_tpu.exec.aot": {"export_compiled"},
    "deeplearning4j_tpu.exec.elastic": set(),
    "deeplearning4j_tpu.exec.comms": set(),
    "deeplearning4j_tpu.exec.worker": set(),
    "deeplearning4j_tpu.exec.cluster": set(),
    "deeplearning4j_tpu.exec": {
        "AUX", "BATCH", "OPT", "PARAMS", "REPL", "SLOTS", "STATE",
        "STEP_BATCH", "param_spec", "decode_attn_route", "flash_attn_route",
        "load_measurements", "load_measurements_file", "lstm_fwd_route",
        "lstm_grad_route", "set_route"},
    "deeplearning4j_tpu.parallel": set(),
    "deeplearning4j_tpu.parallel.distributed": set(),
    "deeplearning4j_tpu.scaleout": {
        "AutoEncoderEstimator", "AutoEncoderModel", "NetworkClassifier",
        "NetworkModel", "Pipeline"},
}


@pytest.mark.parametrize("package", sorted(NOT_PORTED))
def test_package_exports_the_ported_jax_names(package):
    jax_mod = importlib.import_module(package)
    port = importlib.import_module(
        package.replace("deeplearning4j_tpu", "deeplearning4j_tpu_torch", 1))
    missing = {n for n in jax_mod.__all__ if not hasattr(port, n)}
    assert missing == NOT_PORTED[package]


def test_version_and_configuration_classes_are_top_level():
    import deeplearning4j_tpu as j
    import deeplearning4j_tpu_torch as t
    assert t.__version__ == j.__version__
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import \
        ComputationGraphConfiguration
    assert t.ComputationGraphConfiguration is ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        ComputationGraphConfiguration as via_configuration
    assert via_configuration is ComputationGraphConfiguration


# ---------------------------------------------------------------- builder

def _ns(jax):
    pkg = "deeplearning4j_tpu" if jax else "deeplearning4j_tpu_torch"
    conf = importlib.import_module(f"{pkg}.nn.conf.configuration")
    layers = importlib.import_module(f"{pkg}.nn.layers")
    upd = importlib.import_module(f"{pkg}.nn.updaters")
    inputs = importlib.import_module(f"{pkg}.nn.conf.inputs")
    return conf, layers, upd, inputs.InputType


def _chain(jax, kind):
    conf, L, U, IT = _ns(jax)
    b = conf.NeuralNetConfiguration.builder().seed(3)
    if kind == "setters":
        b = (b.updater(U.Adam(1e-3)).bias_init(0.1).learning_rate(0.05)
             .optimization_algo("SGD").dtype("float32")
             .compute_dtype("bfloat16").mini_batch(False).minimize(False))
    elif kind == "learning_rate_first":
        b = b.learning_rate(0.2).updater(U.Nesterovs(0.1)).learning_rate(0.3)
    lb = b.list()
    lstm = L.LSTM(n_out=8, activation="tanh")
    out = L.RnnOutputLayer(n_out=V, activation="softmax", loss="mcxent")
    if kind == "indexed":
        lb = lb.layer(1, out).layer(0, lstm)
    else:
        lb = lb.layer(lstm).layer(out)
    return lb.set_input_type(IT.recurrent(V)).build()


@pytest.mark.parametrize("kind", ["setters", "learning_rate_first",
                                  "indexed"])
def test_builder_chains_give_one_document(kind):
    ours, theirs = _chain(False, kind), _chain(True, kind)
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert [t.to_dict() for t in ours.output_types()] == \
        [t.to_dict() for t in theirs.output_types()]
    if kind == "setters":
        g = ours.global_conf
        assert (g.bias_init, g.updater.learning_rate, g.optimization_algo,
                g.compute_dtype, g.mini_batch, g.minimize) == \
            (0.1, 0.05, "sgd", "bfloat16", False, False)


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def tiny():
    return port_of(jax_tiny())


def _x(n=3, t=6, seed=0):
    r = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[r.randint(0, V, (n, t))]


def test_client_warmup_and_keep_alive(tiny):
    from deeplearning4j_tpu_torch.serving import (InferenceClient,
                                                  InferenceServer)
    srv = InferenceServer(tiny, port=0).start()
    try:
        cli = InferenceClient(f"http://127.0.0.1:{srv.port}",
                              keep_alive=False)
        out = cli.warmup((6, V), max_batch=4)
        assert out["buckets"] == [1, 2, 4]
        assert getattr(cli._local, "conn", None) is None
        np.testing.assert_array_equal(
            cli.predict(_x()), srv.engine.predict_host(_x()))
        kept = InferenceClient(f"http://127.0.0.1:{srv.port}")
        kept.health()
        assert kept._local.conn is not None
    finally:
        srv.stop()


def test_micro_batcher_predict_is_submit_and_wait(tiny):
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  MicroBatcher)
    eng = InferenceEngine(tiny, 8)
    mb = MicroBatcher(eng).start()
    try:
        np.testing.assert_array_equal(mb.predict(_x()),
                                      eng.predict_host(_x()))
    finally:
        mb.stop()


@pytest.mark.parametrize("deadline_ms,code", [(None, 504), (60_000.0, 200)])
def test_request_timeout_is_the_default_deadline(tiny, deadline_ms, code):
    import urllib.error
    import urllib.request
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.serving.wire import ndarray_to_b64
    srv = InferenceServer(tiny, 0, "127.0.0.1", 256, 2.0, None, 1024,
                          1e-6).start()
    assert srv.request_timeout_ms == 1e-6
    payload = {"ndarray": ndarray_to_b64(_x())}
    if deadline_ms is not None:
        payload["deadline_ms"] = deadline_ms
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                got = r.status
        except urllib.error.HTTPError as e:
            got = e.code
            assert json.loads(e.read())["error"]["type"] == \
                "deadline_exceeded"
        assert got == code
    finally:
        srv.stop()


def test_server_refuses_a_fault_injector_and_a_bad_role(tiny):
    import urllib.error
    import urllib.request

    from deeplearning4j_tpu_torch.resilience.faults import \
        ServerFaultInjector
    from deeplearning4j_tpu_torch.serving import InferenceServer
    # a fault injector is taken and honoured: the next /generate answers
    # its injected status, and /chaos reconfigures it
    inj = ServerFaultInjector(fail_next=1, error_code=503)
    srv = InferenceServer(tiny, port=0, fault_injector=inj).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        for path, payload, code in (
                ("/generate", {"tokens": [1]}, 503),
                ("/chaos", {"fail_next": 0, "latency_ms": 1.0}, 200)):
            req = urllib.request.Request(
                url + path, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req) as r:
                    got, body = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                got, body = e.code, json.loads(e.read())
            assert got == code, body
        assert body["chaos"]["latency_ms"] == 1.0
        assert inj.describe()["injected_faults"] == 1
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="role"):
        InferenceServer(tiny, port=0, role="router")
    srv = InferenceServer(tiny, port=0, role="prefill")
    assert srv.stats()["role"] == "prefill"


# -------------------------------------------------------------------- zoo

ZOO_KW = dict(vocab_size=V, n_layers=1, d_model=16, n_heads=2, max_len=16)


def test_a_cached_pretrained_zip_loads_in_both_packages(tmp_path,
                                                        monkeypatch):
    from deeplearning4j_tpu.util import model_serializer as jms
    from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny
    from deeplearning4j_tpu.zoo.zoo_model import ZooModel as JaxZoo

    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel
    monkeypatch.setenv("DL4JTPU_DATA_DIR", str(tmp_path))
    src = JaxTiny(seed=5, **ZOO_KW).init()
    zoo = TinyTransformer(**ZOO_KW)
    path = zoo.cache_path()
    assert path == tmp_path / "pretrained" / "tinytransformer.zip"
    assert path == JaxTiny(**ZOO_KW).cache_path()
    path.parent.mkdir(parents=True)
    jms.write_model(src, str(path))
    assert zoo.pretrained_path() == path
    digest = ZooModel.write_manifest_entry("tinytransformer", path)
    assert digest == JaxZoo.write_manifest_entry("tinytransformer", path)
    assert ZooModel.manifest()["tinytransformer"] == digest
    ours = zoo.init_pretrained(device="cpu")
    theirs = JaxTiny(**ZOO_KW).init_pretrained()
    x = _x(2, 8)
    np.testing.assert_allclose(ours.output(x, bucketed=False).numpy(),
                               np.asarray(theirs.output(x)), rtol=1e-5,
                               atol=1e-6)
    ZooModel.write_manifest_entry("tinytransformer", tmp_path / "pretrained"
                                  / "manifest.json")
    with pytest.raises(IOError, match="Checksum mismatch"):
        zoo.init_pretrained(device="cpu")


def test_without_a_cached_zip_the_bundle_is_read(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.zoo_model import BUNDLED_DIR
    monkeypatch.setenv("DL4JTPU_DATA_DIR", str(tmp_path))
    assert TextGenerationLSTM(total_unique_characters=51).pretrained_path() \
        == BUNDLED_DIR / "textgenlstm.zip"


# ---------------------------------------------------------- image trees

def _tree(root, classes=("cat", "dog", "eel"), per=3, seed=0):
    from PIL import Image
    r = np.random.RandomState(seed)
    for ci, name in enumerate(classes):
        d = root / name / "images"
        d.mkdir(parents=True)
        for k in range(per):
            h, w = 10 + k, 12 + ci
            img = Image.fromarray(r.randint(0, 256, (h, w, 3), np.uint8))
            img.save(d / f"{k}.{'png' if k % 2 else 'jpg'}")
    (root / classes[0] / "images" / "broken.jpg").write_bytes(b"not a jpeg")


@pytest.mark.parametrize("shape", [(8, 8, 3), (6, 5, 1)])
def test_load_image_tree_equals_jax(tmp_path, shape):
    from deeplearning4j_tpu.data.fetchers import load_image_tree as jload
    from deeplearning4j_tpu_torch.data.fetchers import load_image_tree
    _tree(tmp_path)
    ours = load_image_tree(tmp_path, shape, num_examples=7, seed=4)
    theirs = jload(tmp_path, shape, num_examples=7, seed=4)
    assert ours[2] == theirs[2] == 3
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[0].shape[1:] == shape
    assert load_image_tree(tmp_path / "absent", shape) is None


def _batches(it):
    return [(np.asarray(ds.features), np.asarray(ds.labels)) for ds in it]


@pytest.mark.parametrize("which", ["tinyimagenet", "lfw"])
@pytest.mark.parametrize("real", [True, False])
def test_tree_iterators_equal_jax(tmp_path, monkeypatch, which, real):
    from deeplearning4j_tpu.data import fetchers as jf
    from deeplearning4j_tpu_torch.data import fetchers as tf
    monkeypatch.setenv("DL4JTPU_DATA_DIR", str(tmp_path))
    if real:
        _tree(tmp_path / ("tinyimagenet/train" if which == "tinyimagenet"
                          else "lfw"))
    if which == "tinyimagenet":
        def make(m):
            return m.TinyImageNetDataSetIterator(4, num_examples=8)
    else:
        def make(m):
            return m.LFWDataSetIterator(4, num_examples=8, num_labels=5,
                                        image_shape=(12, 10, 3))
    ours, theirs = _batches(make(tf)), _batches(make(jf))
    assert len(ours) == len(theirs) > 0
    for (xo, yo), (xt, yt) in zip(ours, theirs):
        assert xo.dtype == np.uint8
        np.testing.assert_array_equal(xo, xt)
        np.testing.assert_array_equal(yo, yt)
    want = "real" if real else "synthetic"
    assert tf.data_source(which) == jf.data_source(which) == want


def test_data_source_names_mnist_and_unknown(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.data.fetchers import (data_source,
                                                        load_mnist)
    monkeypatch.setenv("DL4JTPU_DATA_DIR", str(tmp_path))
    load_mnist(num_examples=4)
    assert data_source("mnist") == "synthetic"
    assert data_source("nothing") == "unknown"
    assert torch.is_tensor(torch.as_tensor(load_mnist(num_examples=2)[0]))
