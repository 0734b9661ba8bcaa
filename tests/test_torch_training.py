"""Training in the port -- fit, fit_scan, truncated BPTT, score, evaluate,
the updater state in the checkpoint -- held against the JAX package's
MultiLayerNetwork on the CPU.

The nets are TextGenerationLSTM-shaped (vocab 9, 2 x LSTM(16), softmax
RnnOutputLayer, Adam(1e-3), element-wise gradient clipping at 10, T=8),
with the JAX net's initial parameters carried over (``params_from_numpy``)
and numpy-seeded batches. On the CPU the JAX package trains through
autodiff of its scan, the port through its K2/K3 plain versions, so the
gradients are computed two independent ways.

Tolerances: float32 losses to 1e-6 relative and parameters to 2e-6
absolute after three Adam steps (the step-1 parameter differences measured
~3e-7; Adam divides by sqrt(v) + eps, so an element whose gradient is ~eps
could move by up to lr = 1e-3 if the two summation orders disagreed on its
sign -- the bound would show that, and no element does). Gradients to 1e-5
relative to their largest magnitude. With ``compute_dtype="bfloat16"`` the
two packages compute different functions on the CPU (the JAX scan runs the
cell in bfloat16, the port's kernels in float32), so only the loss is
compared, to 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import (LSTM as JaxLSTM,
                                          DenseLayer as JaxDense,
                                          OutputLayer as JaxOut,
                                          RnnOutputLayer as JaxRnnOut)
from deeplearning4j_tpu.nn.layers.core import LossLayer as JaxLossLayer
from deeplearning4j_tpu.nn.layers.rnn import RnnLossLayer as JaxRnnLoss
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.util import model_serializer as jax_serializer

from deeplearning4j_tpu_torch import MultiLayerNetwork, ops, params_from_numpy
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

V, H, T, B = 9, 16, 8, 4
P_TOL = 2e-6


def _jax_conf(tbptt=None, compute_dtype=None, seed=7):
    b = (JaxNNC.builder().seed(seed).updater(JaxAdam(1e-3))
         .weight_init("xavier")
         .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    lb = (b.list().layer(JaxLSTM(n_out=H, activation="tanh"))
          .layer(JaxLSTM(n_out=H, activation="tanh"))
          .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
          .set_input_type(JaxInputType.recurrent(V)))
    if tbptt:
        lb = lb.backprop_type("tbptt", tbptt, tbptt)
    return lb.build()


def _port_of(jnet):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    return net.set_params(params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params],
        device="cpu"))


def _pair(conf):
    jnet = JaxMLN(conf).init()
    return jnet, _port_of(jnet)


def _batch(seed, n=B, t=T):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    return eye[r.randint(0, V, (n, t))], eye[r.randint(0, V, (n, t))]


def _params_close(jnet, net, tol=P_TOL):
    for i, (a, b) in enumerate(zip(jnet.params, net.params)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                       rtol=0, atol=tol, err_msg=f"{i}/{k}")


def test_three_fit_steps_match_jax():
    jnet, net = _pair(_jax_conf())
    x, y = _batch(0)
    # step-1 gradients, before any update
    (jl, _), jg = jax.jit(jax.value_and_grad(jnet._loss, has_aux=True))(
        jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y), None, None,
        None)
    grads, score = net.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(score, float(jl), rtol=1e-6)
    for a, b in zip(jg, grads):
        for k in a:
            ref = np.asarray(a[k])
            err = np.abs(b[k].numpy() - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), k
    for step in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=1e-6)
        _params_close(jnet, net)
    assert net.iteration == jnet.iteration == 3
    for a, b in zip(jnet.opt_state, net.opt_state):
        flat = jax_serializer._flatten_pytree(a)
        assert sorted(flat) == sorted(b)
        for k, v in flat.items():
            np.testing.assert_allclose(b[k].numpy(), v, rtol=1e-5, atol=1e-7)


def test_one_tbptt_batch_matches_jax():
    """T=8 in chunks of 3: three train steps on one batch, carries entering
    each chunk detached; the score is the mean of the chunk losses."""
    jnet, net = _pair(_jax_conf(tbptt=3))
    x, y = _batch(1)
    jnet.fit(x, y)
    net.fit(x, y)
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=1e-6)
    _params_close(jnet, net)
    assert net.iteration == 1
    assert int(net.opt_state[0]["0/.count"]) == 3     # one update per chunk
    with pytest.raises(ValueError, match="tbptt"):
        net.fit_scan(x[None], y[None])


def test_fit_iterator_and_fit_scan_match_jax():
    jnet, net = _pair(_jax_conf(seed=8))
    x, y = _batch(2, n=10)
    jnet.fit(JaxListIterator(JaxDataSet(x, y), 4, shuffle=True, seed=3),
             epochs=2)
    net.fit(ListDataSetIterator(DataSet(x, y), 4, shuffle=True, seed=3),
            epochs=2)
    assert (net.iteration, net.epoch) == (jnet.iteration, jnet.epoch) == (6, 2)
    _params_close(jnet, net)
    xs, ys = _batch(3, n=2 * B)
    xs, ys = xs.reshape(2, B, T, V), ys.reshape(2, B, T, V)
    jnet.fit_scan(jnp.asarray(xs), jnp.asarray(ys))
    net.fit_scan(xs, ys)
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=1e-6)
    _params_close(jnet, net)
    assert net.iteration == jnet.iteration == 8


def test_score_and_evaluate_match_jax():
    jnet, net = _pair(_jax_conf(seed=9))
    x, y = _batch(4, n=6)
    np.testing.assert_allclose(net.score(x=x, y=y), jnet.score(x=x, y=y),
                               rtol=1e-6)
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), rtol=1e-6)
    jev, ev = jnet.evaluate(x, y), net.evaluate(x, y)
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    for metric in ("accuracy", "precision", "recall", "f1"):
        assert getattr(ev, metric)() == getattr(jev, metric)()
    it = ListDataSetIterator(DataSet(x, y), 4)
    np.testing.assert_array_equal(net.evaluate(it).confusion, ev.confusion)
    assert ev.matthews_correlation(0) == jev.matthews_correlation(0)
    assert "Accuracy" in ev.stats()


def test_bfloat16_compute_dtype_trains_like_jax():
    jnet, net = _pair(_jax_conf(compute_dtype="bfloat16", seed=10))
    x, y = _batch(5)
    for _ in range(2):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=1e-3)
    assert all(v.dtype == torch.float32 for p in net.params
               for v in p.values())


def _dense_conf(pkg, head):
    """A feed-forward net that exercises l1/l2, a per-layer updater,
    constraints, and either an OutputLayer or a parameterless loss head."""
    if pkg == "jax":
        from deeplearning4j_tpu.nn.updaters import Nesterovs, Sgd
        nnc, dense, out, loss_layer, it = (JaxNNC, JaxDense, JaxOut,
                                           JaxLossLayer, JaxInputType)
    else:
        from deeplearning4j_tpu_torch.nn.layers import (DenseLayer, LossLayer,
                                                        OutputLayer)
        from deeplearning4j_tpu_torch.nn.updaters import Nesterovs, Sgd
        nnc, dense, out, loss_layer, it = (NeuralNetConfiguration, DenseLayer,
                                           OutputLayer, LossLayer, InputType)
    lb = (nnc.builder().seed(4).updater(Sgd(0.05)).l2(1e-2).l1(1e-3).list()
          .layer(dense(n_out=7, activation="tanh",
                       updater=Nesterovs(learning_rate=0.02),
                       constraints=("maxnorm", 0.9))))
    if head == "output_layer":
        lb = lb.layer(out(n_out=5, activation="identity", loss="mse"))
    else:
        lb = (lb.layer(dense(n_out=5, activation="identity"))
              .layer(loss_layer(loss="l2", activation="identity")))
    return lb.set_input_type(it.feed_forward(6)).build()


@pytest.mark.parametrize("head", ["output_layer", "loss_layer"])
def test_regularization_layer_updater_and_constraints_match_jax(head):
    jconf = _dense_conf("jax", head)
    assert MultiLayerConfiguration.from_json(jconf.to_json()).to_json() \
        == _dense_conf("port", head).to_json()
    jnet, net = _pair(jconf)
    r = np.random.RandomState(6)
    x = r.randn(8, 6).astype(np.float32)
    y = r.randn(8, 5).astype(np.float32)
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=1e-6)
        _params_close(jnet, net)
    # the max-norm constraint held after every update
    norms = torch.sqrt((net.params[0]["W"] ** 2).sum(dim=0))
    assert float(norms.max()) <= 0.9 + 1e-6
    assert sorted(net.opt_state[0]) == ["0/.trace/W", "0/.trace/b"]
    if head == "loss_layer":
        assert net.opt_state[2] == {}       # the loss head has no params


def test_rnn_loss_layer_matches_jax():
    def build(nnc, lstm, loss_layer, it, adam):
        return (nnc.builder().seed(5).updater(adam(1e-2)).list()
                .layer(lstm(n_out=V, activation="tanh"))
                .layer(loss_layer(loss="mcxent", activation="softmax"))
                .set_input_type(it.recurrent(V)).build())
    jnet, net = _pair(build(JaxNNC, JaxLSTM, JaxRnnLoss, JaxInputType,
                            JaxAdam))
    x, y = _batch(7)
    jnet.fit(x, y)
    net.fit(x, y)
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=1e-6)
    _params_close(jnet, net)


def test_checkpoint_updater_state_resumes_across_packages(tmp_path):
    """A zip with updater state written by one package resumes in the
    other: the next step is the one the writer would have taken."""
    jnet, net = _pair(_jax_conf(seed=11))
    x, y = _batch(8)
    for _ in range(2):
        jnet.fit(x, y)
        net.fit(x, y)
    jpath, ppath = tmp_path / "jax.zip", tmp_path / "port.zip"
    jax_serializer.write_model(jnet, str(jpath))
    net.save(ppath)

    from_jax = MultiLayerNetwork.load(jpath, device="cpu")
    from_port = jax_serializer.restore_multi_layer_network(str(ppath))
    assert from_jax.iteration == from_port.iteration == 2
    assert sorted(from_jax.opt_state[1]) == sorted(net.opt_state[1])
    for resumed, twin in ((from_jax, jnet), (from_port, net)):
        resumed.fit(x, y)
        twin.fit(x, y)
    _params_close(jnet, from_jax)
    _params_close(from_port, net)
    again = MultiLayerNetwork.load(ppath, device="cpu", load_updater=False)
    assert int(again.opt_state[0]["0/.count"]) == 0
    net.save(tmp_path / "bare.zip", save_updater=False)
    bare = jax_serializer.restore_multi_layer_network(
        str(tmp_path / "bare.zip"))
    assert int(bare.opt_state[0][0].count) == 0


def test_fit_trains_the_zoo_model_on_cpu_without_kernel_launches():
    net = TextGenerationLSTM(total_unique_characters=V).init(device="cpu")
    assert net.conf.global_conf.updater == Adam(1e-3)
    x, y = _batch(10, n=2, t=4)
    before = net.score(x=x, y=y)
    ops.reset_launch_counts()
    net.fit(ListDataSetIterator(DataSet(x, y), 2), epochs=3)
    assert ops.launch_counts() == {}
    assert net.score(x=x, y=y) < before


def test_dataset_and_evaluation_helpers_match_jax():
    from deeplearning4j_tpu.eval.evaluation import Evaluation as JaxEval
    from deeplearning4j_tpu_torch.eval import Evaluation
    x, y = _batch(11, n=7)
    mask = (np.arange(7 * T).reshape(7, T) % 3 > 0).astype(np.float32)
    ours = DataSet(x, y, labels_mask=mask)
    theirs = JaxDataSet(x, y, labels_mask=mask)
    for a, b in zip(ours.split_test_and_train(3),
                    theirs.split_test_and_train(3)):
        np.testing.assert_array_equal(a.labels_mask, b.labels_mask)
    for a, b in zip(ours.batch_by(3), theirs.batch_by(3)):
        np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(ours.shuffle(5).labels,
                                  theirs.shuffle(5).labels)
    merged = DataSet.merge(ours.batch_by(2))
    np.testing.assert_array_equal(merged.labels_mask, ours.labels_mask)
    r = np.random.RandomState(12)
    probs = r.rand(7, T, V).astype(np.float32)
    ev = Evaluation().eval(y, probs, mask).merge(Evaluation().eval(x, probs))
    jev = JaxEval().eval(y, probs, mask).merge(JaxEval().eval(x, probs))
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    for cls in range(V):
        assert ev.false_positive_rate(cls) == jev.false_positive_rate(cls)
        assert ev.precision(cls) == jev.precision(cls)
        assert ev.recall(cls) == jev.recall(cls)
