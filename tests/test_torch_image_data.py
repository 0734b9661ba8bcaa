"""The image data path of the port held against the JAX package on the
CPU: the fetchers (data/fetchers.py), the normalizers
(data/normalizers.py), the pre-processor seam of the iterators and the
containers (a ``device_side`` scaler applied after the copy), and a
normalizer kept in a model zip or a checkpoint.

Fetcher arrays are byte-equal to the JAX package's (MNIST, EMNIST, CIFAR-10
and Iris, a few hundred rows). Normalizer statistics, ``transform`` and
``revert`` equal the JAX normalizers' (the same numpy), their documents
read across packages, and ``as_device_transform`` equals ``transform`` to
float32 rounding (rtol 1e-6). A LeNet-shaped network's streamed fit on
the uint8 wire ends at the same bits as the float fit on the same pixels
scaled the same way, and within 2e-6 of the JAX package's uint8 fit.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import fetchers as jf
from deeplearning4j_tpu.data import normalizers as jn
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.util import model_serializer as jser

from deeplearning4j_tpu_torch import MultiLayerNetwork, params_from_numpy
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                           resolve_pre_processor)
from deeplearning4j_tpu_torch.data import fetchers as f
from deeplearning4j_tpu_torch.data import normalizers as n
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.resilience import CheckpointListener
from deeplearning4j_tpu_torch.util import model_serializer as ser

ROWS = 300


@pytest.mark.parametrize("name", ["mnist", "mnist_train", "emnist",
                                  "cifar10", "iris"])
def test_fetcher_arrays_are_byte_equal_to_jax(name):
    if name == "mnist":
        got, want = (m.load_mnist(train=False, num_examples=ROWS,
                                  flatten=False) for m in (f, jf))
        its = [m.MnistDataSetIterator(64, train=False, num_examples=ROWS)
               for m in (f, jf)]
    elif name == "mnist_train":
        got, want = (m.load_mnist(train=True, num_examples=ROWS)
                     for m in (f, jf))
        its = [m.MnistDataSetIterator(64, num_examples=ROWS,
                                      uint8_wire=False) for m in (f, jf)]
    elif name == "emnist":
        its = [m.EmnistDataSetIterator("letters", 64, num_examples=ROWS,
                                       flatten=False) for m in (f, jf)]
        got = want = None
    elif name == "cifar10":
        got, want = (m.load_cifar10(train=False, num_examples=ROWS)
                     for m in (f, jf))
        its = [m.CifarDataSetIterator(64, num_examples=ROWS)
               for m in (f, jf)]
    else:
        got, want = (m.load_iris() for m in (f, jf))
        its = [m.IrisDataSetIterator(50) for m in (f, jf)]
    if got is not None:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    it, jit_ = its
    for ds, jds in zip(it, jit_):
        assert ds.features.dtype == jds.features.dtype
        assert ds.features.tobytes() == jds.features.tobytes()
        assert ds.labels.tobytes() == jds.labels.tobytes()
    pp, jpp = it.pre_processor, jit_.pre_processor
    assert (pp is None) == (jpp is None)
    if pp is not None:
        assert pp.device_side and pp.to_dict() == jpp.to_dict()
        assert resolve_pre_processor(it) is pp


def _data(seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(40, 3, 2, 2) * 3 + 1).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[r.randint(0, 2, 40)]


NORMALIZERS = [
    ("standardize", lambda m: m.NormalizerStandardize()),
    ("minmax", lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0)),
    ("image", lambda m: m.ImagePreProcessingScaler(0.0, 1.0, 255.0)),
]


@pytest.mark.parametrize("name,make", NORMALIZERS,
                         ids=[c[0] for c in NORMALIZERS])
def test_normalizer_matches_jax(name, make):
    x, y = _data()
    if name == "image":
        x = np.random.RandomState(1).randint(0, 256, x.shape).astype(
            np.uint8)
    norm = make(n).fit(DataSet(x, y))
    jnorm = make(jn).fit(JaxDataSet(x, y))
    assert json.dumps(norm.to_dict()) == json.dumps(jnorm.to_dict())
    tx = norm.transform_features(x)
    assert tx.tobytes() == jnorm.transform_features(x).tobytes()
    assert norm.revert_features(tx).tobytes() == \
        jnorm.revert_features(tx).tobytes()
    # the documents read across packages (read back, the statistics are
    # float64 in both, as the JSON lists hold them)
    back = n.Normalizer.from_dict(jnorm.to_dict())
    jback = jn.Normalizer.from_dict(norm.to_dict())
    assert jback.to_dict() == jnorm.to_dict()
    assert back.transform_features(x).tobytes() == \
        jback.transform_features(x).tobytes()
    # the device transform, on a batch and on a stacked block
    fn = norm.as_device_transform()
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                               tx.astype(np.float32), rtol=1e-6, atol=1e-6)
    block = np.stack([x[:20], x[20:]])
    assert fn(torch.from_numpy(block)).shape == block.shape


def test_device_side_pre_processor_is_left_to_the_container():
    x, y = _data()
    it = ListDataSetIterator(DataSet(x, y), 8)
    it.set_pre_processor(n.NormalizerStandardize().fit(DataSet(x, y)))
    assert not np.array_equal(next(iter(it)).features, x[:8])
    it.set_pre_processor(n.NormalizerStandardize(device_side=True)
                         .fit(DataSet(x, y)))
    assert np.array_equal(next(iter(it)).features, x[:8])


def _lenet_like(h=12):
    return (JaxNNC.builder().seed(3).updater(JaxAdam(1e-3))
            .weight_init("xavier").list()
            .layer(jl.ConvolutionLayer(n_out=4, kernel_size=3,
                                       activation="relu"))
            .layer(jl.SubsamplingLayer(pooling_type="max", kernel_size=2,
                                       stride=2))
            .layer(jl.DenseLayer(n_out=8, activation="relu"))
            .layer(jl.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.convolutional(h, h, 1)).build())


def _pixels(rows=48, h=12, seed=0):
    r = np.random.RandomState(seed)
    x = r.randint(0, 256, (rows, h, h, 1)).astype(np.uint8)
    return x, np.eye(10, dtype=np.float32)[r.randint(0, 10, rows)]


def _port(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return MultiLayerNetwork(conf, device="cpu").set_params(
        params_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params], device="cpu"))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_uint8_wire_fit_equals_the_float_fit(prefetch):
    """The scaler runs on the device after the copy (the prefetcher's
    stream, or the consumer's without one): the uint8 fit's parameters are
    the float fit's bit for bit, and the JAX package's uint8 fit's within
    2e-6."""
    jnet = JaxMLN(_lenet_like()).init()
    x8, y = _pixels()
    wire, plain = _port(jnet), _port(jnet)
    it8 = ListDataSetIterator(DataSet(x8, y), 8)
    it8.set_pre_processor(n.ImagePreProcessingScaler(device_side=True))
    xf = x8.astype(np.float32) / np.float32(255.0)
    wire.fit(it8, epochs=2, prefetch=prefetch)
    plain.fit(ListDataSetIterator(DataSet(xf, y), 8), epochs=2,
              prefetch=prefetch)
    for a, b in zip(wire.params, plain.params):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    from deeplearning4j_tpu.data.iterators import \
        ListDataSetIterator as JaxListIterator
    jit_ = JaxListIterator(JaxDataSet(x8, y), 8)
    jit_.set_pre_processor(jn.ImagePreProcessingScaler(device_side=True))
    jnet.fit(jit_, epochs=2)
    for a, b in zip(wire.params, jnet.params):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=0, atol=2e-6, err_msg=k)
    # evaluate reads the same scaler on the device
    ev8 = wire.evaluate(it8)
    evf = wire.evaluate(ListDataSetIterator(DataSet(xf, y), 8))
    assert ev8.accuracy() == evf.accuracy()


def test_normalizer_in_model_zips_across_packages(tmp_path):
    jnet = JaxMLN(_lenet_like()).init()
    net = _port(jnet)
    x, y = _data()
    norm = n.NormalizerStandardize().fit(DataSet(x, y))
    ser.write_model(net, tmp_path / "p.zip", normalizer=norm)
    jser.write_model(jnet, str(tmp_path / "j.zip"),
                     normalizer=jn.NormalizerStandardize().fit(
                         JaxDataSet(x, y)))
    for path in ("p.zip", "j.zip"):
        for restore in (ser.restore_normalizer, jser.restore_normalizer):
            got = restore(str(tmp_path / path))
            assert json.dumps(got.to_dict()) == json.dumps(norm.to_dict())
    ser.write_model(net, tmp_path / "bare.zip")
    assert ser.restore_normalizer(tmp_path / "bare.zip") is None
    assert "normalizer.json" not in zipfile.ZipFile(
        tmp_path / "bare.zip").namelist()


def test_checkpoint_listener_saves_the_normalizer(tmp_path):
    jnet = JaxMLN(_lenet_like()).init()
    net = _port(jnet)
    x8, y = _pixels(rows=16)
    it = ListDataSetIterator(DataSet(x8, y), 8)
    scaler = n.ImagePreProcessingScaler(device_side=True)
    it.set_pre_processor(scaler)
    lst = CheckpointListener(tmp_path, every_n_iterations=1,
                             normalizer=scaler)
    net.fit(it, epochs=1, checkpoint=lst)
    path = lst.last_saved_path
    assert path is not None
    for restore in (ser.restore_normalizer, jser.restore_normalizer):
        assert restore(str(path)).to_dict() == scaler.to_dict()
    # the checkpoint resumes in a fresh network
    fresh = _port(jnet)
    fresh.fit(it, epochs=1, resume_from=tmp_path)
    assert fresh.iteration == net.iteration
