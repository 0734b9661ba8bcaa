"""The port's evaluations beyond ``Evaluation`` (eval/evaluation.py,
eval/calibration.py) held against the JAX package's on the CPU:
EvaluationBinary, RegressionEvaluation, ROC, ROCMultiClass and
EvaluationCalibration, fed the same arrays in the same batches (with
ties in the scores, time series and masks where a class reads them),
agree to 1e-12 in every metric they report; ``MultiLayerNetwork.
evaluate_regression`` over an iterator equals the JAX network's from the
same parameters (float32 outputs: 1e-6).
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import eval as jev
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT

from deeplearning4j_tpu_torch import (MultiLayerNetwork, eval as pev,
                                      params_from_numpy)
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

TOL = 1e-12
C = 4


def _probs(n, c=C, seed=0, ties=True):
    r = np.random.RandomState(seed)
    p = r.rand(n, c)
    if ties:                        # repeated scores: the average-rank path
        p[::5] = np.round(p[::5], 1)
    return p / p.sum(-1, keepdims=True)


def _onehot(n, c=C, seed=1):
    return np.eye(c)[np.random.RandomState(seed).randint(0, c, n)]


def _batches(n=60, parts=3):
    y, p = _onehot(n), _probs(n)
    return [(y[i::parts], p[i::parts]) for i in range(parts)]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=TOL,
                               atol=TOL, err_msg=what)


def _both(name, *args, **kw):
    return getattr(jev, name)(*args, **kw), getattr(pev, name)(*args, **kw)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_evaluation_binary_matches_jax(threshold):
    j, p = _both("EvaluationBinary", threshold=threshold)
    for y, s in _batches():
        j.eval(y, s)
        p.eval(y, s)
    for i in range(C):
        for m in ("accuracy", "precision", "recall", "f1"):
            _close(getattr(p, m)(i), getattr(j, m)(i), f"{m}({i})")
    for a in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(p, a), getattr(j, a))


def test_regression_evaluation_matches_jax():
    r = np.random.RandomState(3)
    j, p = _both("RegressionEvaluation", column_names=["a", "b", "c"])
    for _ in range(3):
        y = r.randn(7, 3)
        pred = y + 0.3 * r.randn(7, 3)
        j.eval(y, pred)
        p.eval(y, pred)
    y = r.randn(2, 5, 3)                     # a time series flattens
    j.eval(y, y * 0.9)
    p.eval(y, y * 0.9)
    for m in ("mean_squared_error", "mean_absolute_error",
              "root_mean_squared_error", "r_squared", "pearson_correlation"):
        for col in (None, 0, 2):
            _close(getattr(p, m)(col), getattr(j, m)(col), f"{m}({col})")
    assert p.stats() == j.stats()


@pytest.mark.parametrize("two_columns", [False, True])
def test_roc_matches_jax(two_columns):
    j, p = _both("ROC")
    for y, s in _batches():
        if two_columns:             # (B, 2): the positive column is read
            y2 = np.stack([1 - y[:, 0], y[:, 0]], -1)
            s2 = np.stack([1 - s[:, 0], s[:, 0]], -1)
        else:
            y2, s2 = y[:, 0], s[:, 0]
        j.eval(y2, s2)
        p.eval(y2, s2)
    _close(p.calculate_auc(), j.calculate_auc(), "auc")
    for got, want in zip(p.roc_curve(25), j.roc_curve(25)):
        _close(got, want, "roc curve")
    one = _both("ROC")
    for ev in one:
        ev.eval(np.ones(4), np.linspace(0, 1, 4))
    assert one[1].calculate_auc() == one[0].calculate_auc() == 0.5


def test_roc_multiclass_matches_jax():
    j, p = _both("ROCMultiClass")
    for y, s in _batches():
        j.eval(y, s)
        p.eval(y, s)
    for c in range(C):
        _close(p.calculate_auc(c), j.calculate_auc(c), f"auc({c})")
    _close(p.calculate_average_auc(), j.calculate_average_auc(), "average")


@pytest.mark.parametrize("mask", [None, "example", "output", "series"])
def test_evaluation_calibration_matches_jax(mask):
    j, p = _both("EvaluationCalibration", reliability_num_bins=8,
                 histogram_num_bins=20)
    r = np.random.RandomState(4)
    for k, (y, s) in enumerate(_batches(80, 4)):
        m = None
        if mask == "example":
            m = (r.rand(len(y)) > 0.3).astype(np.float64)
        elif mask == "output":
            m = (r.rand(*y.shape) > 0.2).astype(np.float64)
        elif mask == "series":
            y, s = y.reshape(4, 5, C), s.reshape(4, 5, C)
            m = (r.rand(4, 5) > 0.3).astype(np.float64)
        j.eval(y, s, m)
        p.eval(y, s, m)
    assert p.num_classes() == j.num_classes() == C
    for c in range(C):
        rp, rj = p.get_reliability_diagram(c), j.get_reliability_diagram(c)
        assert rp.title == rj.title
        _close(rp.mean_predicted_value, rj.mean_predicted_value, "mean p")
        _close(rp.fraction_positives, rj.fraction_positives, "fraction")
        for getter in ("get_residual_plot", "get_probability_histogram"):
            hp, hj = getattr(p, getter)(c), getattr(j, getter)(c)
            assert hp.title == hj.title
            np.testing.assert_array_equal(hp.bin_counts, hj.bin_counts)
        _close(p.expected_calibration_error(c),
               j.expected_calibration_error(c), "ece")
    for getter in ("get_label_counts_each_class",
                   "get_prediction_counts_each_class"):
        np.testing.assert_array_equal(getattr(p, getter)(),
                                      getattr(j, getter)())
    for getter in ("get_residual_plot_all_classes",
                   "get_probability_histogram_all_classes"):
        np.testing.assert_array_equal(getattr(p, getter)().bin_counts,
                                      getattr(j, getter)().bin_counts)
    _close(p.expected_calibration_error(), j.expected_calibration_error(),
           "ece")
    assert p.stats() == j.stats()
    merged = pev.EvaluationCalibration(8, 20).merge(p).merge(p)
    np.testing.assert_array_equal(merged.label_counts, 2 * p.label_counts)


def test_evaluate_regression_matches_jax():
    conf = (JaxNNC.builder().seed(2).activation("tanh").list()
            .layer(jl.DenseLayer(n_out=8))
            .layer(jl.OutputLayer(n_out=3, activation="identity",
                                  loss="mse"))
            .set_input_type(JIT.feed_forward(5)).build())
    jnet = JaxMLN(conf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jnet.conf.to_json()), device="cpu").set_params(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    r = np.random.RandomState(6)
    x = r.randn(40, 5).astype(np.float32)
    y = r.randn(40, 3).astype(np.float32)
    want = jnet.evaluate_regression(JaxListIterator(JaxDataSet(x, y), 16))
    got = net.evaluate_regression(ListDataSetIterator(DataSet(x, y), 16))
    one = net.evaluate_regression(DataSet(x, y))
    for m in ("mean_squared_error", "mean_absolute_error", "r_squared",
              "pearson_correlation"):
        for col in (None, 1):
            np.testing.assert_allclose(getattr(got, m)(col),
                                       getattr(want, m)(col), rtol=1e-6,
                                       err_msg=m)
            np.testing.assert_allclose(getattr(one, m)(col),
                                       getattr(got, m)(col), rtol=1e-12)
