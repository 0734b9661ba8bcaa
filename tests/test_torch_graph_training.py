"""Training a ComputationGraph in the port -- TinyTransformer through
``fit`` (arrays, DataSet, MultiDataSet, iterator), ``fit_scan``,
``score``, ``evaluate`` and the checkpoint zip with its updater state --
held against the JAX package's ComputationGraph on the CPU.

A small TinyTransformer (2 pre-LN blocks, d_model 32, 4 heads, max_len 64,
an 11-token vocabulary, T = 16) is built in the JAX package and its
initial parameters carried across with ``params_from_numpy``; batches are
numpy-seeded. The JAX side runs its flash attention as its own tests do,
Pallas interpreted: the forward K5 and, under ``jax.grad``, the backward
K6 and K7. The port runs ``FlashAttention`` with the plain versions of the
same three kernels.

Tolerances (float32): losses to 1e-6 relative; gradients to 1e-5 of the
largest gradient magnitude in the model; parameters after Sgd steps to
2e-6 absolute. ``bk`` (the key bias) has no gradient: a constant added to
every key shifts each query's scores by one number, which the softmax
ignores, so both packages return rounding noise for it. Sgd moves it by
lr x noise, inside the tolerance; Adam divides the noise by its own root
mean square and moves it by up to lr per step, so after Adam steps ``bk``
is held only to |delta| <= 2 x lr x steps and every other parameter to
2e-6.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.eval.evaluation import Evaluation as JaxEvaluation
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.util import model_serializer as jax_ser
from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny

from deeplearning4j_tpu_torch import ComputationGraph, ops, params_from_numpy
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                           MultiDataSet)
from deeplearning4j_tpu_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.zoo import TinyTransformer

V, D, HEADS, MAXLEN, T, B = 11, 32, 4, 64, 16, 3
SMALL = dict(vocab_size=V, n_layers=2, d_model=D, n_heads=HEADS,
             max_len=MAXLEN)
GRAD_TOL, P_TOL, LOSS_RTOL = 1e-5, 2e-6, 1e-6
ADAM_LR, SGD_LR = 3e-4, 0.1


@pytest.fixture(autouse=True)
def jax_kernels_interpreted():
    jops.set_helpers_enabled(True, interpret=True)
    yield
    jops.set_helpers_enabled(None)


def _pair(updater="adam", seed=123):
    """The JAX graph (zoo conf, Adam(3e-4) or every layer on Sgd) and the
    port's graph from its JSON and its initial parameters."""
    jconf = JaxTiny(seed=seed, **SMALL).conf()
    if updater == "sgd":
        for node in jconf.nodes.values():
            if node.layer is not None:
                node.layer.updater = JaxSgd(SGD_LR)
    jnet = JaxCG(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = ComputationGraph(conf, device="cpu").set_params(params_from_numpy(
        {n: {k: np.asarray(v) for k, v in p.items()}
         for n, p in jnet.params.items()}, device="cpu"))
    return jnet, net


def _batch(seed, n=B, t=T):
    """Next-token windows: one-hot inputs and their shifted targets."""
    ids = np.random.RandomState(seed).randint(0, V, (n, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _params_close(jnet, net, bk_bound=None):
    """Every parameter within P_TOL; with ``bk_bound`` the key biases only
    within that."""
    assert sorted(jnet.params) == sorted(net.params)
    for n, p in jnet.params.items():
        assert sorted(p) == sorted(net.params[n])
        for k, v in p.items():
            tol = bk_bound if (k == "bk" and bk_bound is not None) else P_TOL
            np.testing.assert_allclose(net.params[n][k].numpy(),
                                       np.asarray(v), rtol=0, atol=tol,
                                       err_msg=f"{n}/{k}")


def test_loss_and_gradients_match_jax():
    jnet, net = _pair()
    x, y = _batch(0)
    (jl, _), jg = jax.value_and_grad(jnet._loss, has_aux=True)(
        jnet.params, jnet.state, [jnp.asarray(x)], [jnp.asarray(y)], None)
    grads, score = net.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(score, float(jl), rtol=LOSS_RTOL)
    scale = max(float(np.abs(np.asarray(g)).max())
                for p in jg.values() for g in p.values())
    assert sorted(grads) == sorted(jg)
    for n, p in jg.items():
        for k, ref in p.items():
            err = np.abs(grads[n][k].numpy() - np.asarray(ref)).max()
            assert err <= GRAD_TOL * scale, f"{n}/{k}: {err} vs {scale}"
    # the attention layers' gradients are not trivially small
    assert float(grads["b0_attn"]["Wq"].abs().max()) > 1e-3 * scale


def jax_loss(jnet, x, y):
    return jnet.score(inputs=[jnp.asarray(x)], labels=[jnp.asarray(y)])


def test_three_sgd_fit_steps_match_jax():
    jnet, net = _pair("sgd")
    x, y = _batch(1)
    losses = []
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        losses.append(net.get_score())
        np.testing.assert_allclose(losses[-1], float(jnet.get_score()),
                                   rtol=LOSS_RTOL)
        _params_close(jnet, net)
    assert net.iteration == jnet.iteration == 3
    assert losses[-1] < losses[0]


def test_three_adam_fit_steps_match_jax():
    """The zoo's Adam(3e-4); the updater state under the JAX package's
    optax key paths."""
    jnet, net = _pair()
    assert net.conf.nodes["b0_attn"].layer.updater == Adam(ADAM_LR)
    x, y = _batch(2)
    for step in range(1, 4):
        jnet.fit(x, y)
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                                   rtol=LOSS_RTOL)
        _params_close(jnet, net, bk_bound=2 * ADAM_LR * step)
    for n, state in jnet.opt_state.items():
        flat = jax_ser._flatten_pytree(state)
        assert sorted(flat) == sorted(net.opt_state[n]), n
        assert int(net.opt_state[n]["0/.count"]) == 3


def test_label_mask_weights_the_loss_like_jax():
    jnet, net = _pair("sgd", seed=5)
    x, y = _batch(3)
    mask = (np.arange(B * T).reshape(B, T) % 4 > 0).astype(np.float32)
    jnet.fit(JaxMultiDataSet([x], [y], labels_masks=[mask]))
    net.fit(MultiDataSet([x], [y], labels_masks=[mask]))
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    _params_close(jnet, net)
    assert net.score(DataSet(x, y, labels_mask=mask)) != net.score(
        DataSet(x, y))


def test_masked_score_and_evaluate_match_the_jax_masked_loss_and_eval():
    """The port's graph ``score`` weights the loss by the labels' masks and
    its ``evaluate`` drops masked rows, as the JAX MultiLayerNetwork and
    both packages' ``fit`` do. The JAX graph's own ``score`` and
    ``evaluate`` ignore label masks, so they are held against the JAX
    graph's ``_loss`` given the mask and a JAX ``Evaluation`` given the
    JAX graph's outputs and the same mask."""
    jnet, net = _pair("sgd", seed=9)
    x, y = _batch(6, n=5)
    mask = (np.random.RandomState(6).rand(5, T) > 0.3).astype(np.float32)
    jl, _ = jnet._loss(jnet.params, jnet.state, [jnp.asarray(x)],
                       [jnp.asarray(y)], None,
                       label_masks=[jnp.asarray(mask)])
    masked = net.score(DataSet(x, y, labels_mask=mask))
    np.testing.assert_allclose(masked, float(jl), rtol=1e-4)
    np.testing.assert_allclose(
        net.score(MultiDataSet([x], [y], labels_masks=[mask])), masked,
        rtol=0)
    assert abs(masked - net.score(DataSet(x, y))) > 1e-4 * abs(masked)
    jev = JaxEvaluation().eval(y, np.asarray(jnet.output(jnp.asarray(x))),
                               mask)
    ev = net.evaluate(DataSet(x, y, labels_mask=mask))
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    assert ev.confusion.sum() == mask.sum() < mask.size


def test_fit_iterator_fit_scan_score_and_evaluate_match_jax():
    jnet, net = _pair("sgd", seed=7)
    x, y = _batch(4, n=7)
    jnet.fit(JaxListIterator(JaxDataSet(x, y), 3, shuffle=True, seed=3),
             epochs=2)
    net.fit(ListDataSetIterator(DataSet(x, y), 3, shuffle=True, seed=3),
            epochs=2)
    assert (net.iteration, net.epoch, net._epoch_batch) == \
        (jnet.iteration, jnet.epoch, jnet._epoch_batch) == (6, 2, 0)
    _params_close(jnet, net)
    xs, ys = _batch(5, n=2 * B)
    xs, ys = xs.reshape(2, B, T, V), ys.reshape(2, B, T, V)
    jnet.fit_scan(jnp.asarray(xs), jnp.asarray(ys))
    net.fit_scan([xs], [ys])
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    _params_close(jnet, net)
    assert net.iteration == jnet.iteration == 8
    np.testing.assert_allclose(net.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), rtol=LOSS_RTOL)
    np.testing.assert_allclose(net.score(inputs=[x], labels=[y]),
                               jax_loss(jnet, x, y), rtol=LOSS_RTOL)
    jev = jnet.evaluate(JaxListIterator(JaxDataSet(x, y), 4))
    ev = net.evaluate(ListDataSetIterator(DataSet(x, y), 4))
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    assert ev.accuracy() == jev.accuracy()
    np.testing.assert_array_equal(net.evaluate(DataSet(x, y)).confusion,
                                  ev.confusion)


def test_fit_takes_arrays_lists_dataset_multidataset_and_tuples():
    """One train step from each form of the same batch lands on the same
    parameters."""
    x, y = _batch(6)
    after = []
    for form in ((x, y), ([x], [y]), (DataSet(x, y),),
                 (MultiDataSet([x], [y]),), ([(x, y)],)):
        _, net = _pair("sgd", seed=9)
        net.fit(*form)
        after.append(net)
    for net in after[1:]:
        assert net.iteration == 1
        for n, p in after[0].params.items():
            for k, v in p.items():
                assert torch.equal(net.params[n][k], v), (n, k)


def test_checkpoint_zip_resumes_training_both_ways(tmp_path):
    """A zip with updater state written by one package resumes in the
    other: the next step is the one the writer would have taken."""
    jnet, net = _pair()
    x, y = _batch(8)
    for _ in range(2):
        jnet.fit(x, y)
        net.fit(x, y)
    jpath, ppath = tmp_path / "jax.zip", tmp_path / "port.zip"
    jax_ser.write_model(jnet, str(jpath))
    net.save(ppath)
    from_jax = ComputationGraph.load(jpath, device="cpu")
    from_port = jax_ser.restore_computation_graph(str(ppath))
    assert from_jax.iteration == from_port.iteration == 2
    assert sorted(from_jax.opt_state["b1_attn"]) == \
        sorted(net.opt_state["b1_attn"])
    assert json.loads(from_jax.conf.to_json()) == \
        json.loads(net.conf.to_json())
    for resumed, twin in ((from_jax, jnet), (from_port, net)):
        resumed.fit(x, y)
        twin.fit(x, y)
        np.testing.assert_allclose(float(resumed.get_score()),
                                   float(twin.get_score()), rtol=LOSS_RTOL)
    _params_close(jnet, from_jax, bk_bound=2 * ADAM_LR * 3)
    _params_close(from_port, net, bk_bound=2 * ADAM_LR * 3)
    again = ComputationGraph.load(ppath, device="cpu", load_updater=False)
    assert int(again.opt_state["out"]["0/.count"]) == 0


@pytest.mark.parametrize("what", ["tbptt"])
def test_unported_graph_training_features_raise(what):
    """Truncated BPTT over a graph is ported now: a TinyTransformer
    configured for it (no recurrent layer, so every chunk of 8 steps
    trains on its own slice) fits one batch as the JAX graph does, a step
    per chunk at one iteration; ``fit_scan`` still refuses it, as the JAX
    graph's does."""
    jnet, net = _pair("sgd")
    for conf in (jnet.conf, net.conf):
        conf.backprop_type = what
        conf.tbptt_fwd_length = conf.tbptt_back_length = 8
    x, y = _batch(10)
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    np.testing.assert_allclose(net.get_score(), float(jnet.get_score()),
                               rtol=LOSS_RTOL)
    _params_close(jnet, net)
    assert net.iteration == jnet.iteration == 1
    with pytest.raises(ValueError, match=what):
        net.fit_scan(x[None], y[None])


def test_zoo_model_at_full_width_fits_on_cpu_without_kernel_launches():
    """TinyTransformer(vocab_size=51) as the zoo gives it (d_model 128, 4
    heads, 2 blocks, max_len 512, Adam(3e-4)): fit accepts it, the loss on
    the batch falls, and the CPU launches no kernel."""
    net = TinyTransformer(vocab_size=51).init(device="cpu")
    ids = np.random.RandomState(11).randint(0, 51, (2, 9))
    eye = np.eye(51, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    before = net.score(inputs=x, labels=y)
    ops.reset_launch_counts()
    net.fit(ListDataSetIterator(DataSet(x, y), 2), epochs=3)
    assert ops.launch_counts() == {}
    assert net.iteration == 3 and net.epoch == 3
    assert net.score(inputs=x, labels=y) < before
