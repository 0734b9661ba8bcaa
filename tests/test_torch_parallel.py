"""The port's data-parallel wrapper and inference against the JAX
package's (deeplearning4j_tpu/parallel/), on the CPU.

The JAX side runs on the eight forced host devices (the ``mesh8`` marker,
tests/conftest.py); the port's side runs eight slots on the CPU, the
counterpart of those devices (exec/mesh.py). Both start from the same
parameters (the JAX network carried over by its JSON and
``params_from_numpy``) and see the same numpy-seeded batches. Tolerance:
1e-5 absolute on every parameter against JAX and against single-device
training, as the JAX package's own tests hold its wrapper; the padded
batch's step equals the unpadded batch's within 1e-6 (JAX's bar for its
exact padding). Also here: the listener calls, ``fit_scan`` and its
errors, BatchNormalization's statistics over pad rows, the LSTM recipe's
shape at small width, ResNet50 at a small width, ``ParallelInference``
(sync and batched) and ``scaled_dot_product_attention`` with q/k offsets.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.nn.conf.graph_conf import MergeVertex as JaxMerge
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import BatchNormalization as JaxBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.parallel import ParallelInference as JaxPI
from deeplearning4j_tpu.parallel import ParallelWrapper as JaxPW

from deeplearning4j_tpu_torch import NeuralNetConfiguration
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.parallel import (ParallelInference,
                                               ParallelWrapper)
from test_torch_regularised_training import port_of

ATOL = 1e-5
SLOTS = 8


def jax_mln(seed=5, lr=0.05, updater="sgd", bn=False, l2=0.0):
    upd = JaxSgd(lr) if updater == "sgd" else JaxAdam(lr)
    b = JaxConf.builder().seed(seed).updater(upd)
    if l2:
        b = b.l2(l2)
    lst = b.list().layer(JaxDense(n_out=16, activation="tanh"))
    if bn:
        lst = lst.layer(JaxBN())
    conf = (lst.layer(JaxOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    return JaxMLN(conf).init()


def jax_cg(seed=5, lr=0.05):
    from deeplearning4j_tpu.models import ComputationGraph as JaxCG
    conf = (JaxConf.builder().seed(seed).updater(JaxSgd(lr))
            .graph_builder().add_inputs("in")
            .set_input_types(JaxInputType.feed_forward(4))
            .add_layer("h1", JaxDense(n_out=16, activation="tanh"), "in")
            .add_layer("h2", JaxDense(n_out=16, activation="tanh"), "in")
            .add_vertex("merge", JaxMerge(), "h1", "h2")
            .add_layer("out", JaxOut(n_out=3, activation="softmax",
                                     loss="mcxent"), "merge")
            .set_outputs("out").build())
    return JaxCG(conf).init()


def data(n=160, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x.sum(axis=1) * 2).astype(int) % 3]
    return x, y


def batches(n, bs, seed=0):
    x, y = data(n, seed)
    return [(x[i:i + bs], y[i:i + bs]) for i in range(0, n, bs)]


def jax_iter(n, bs, seed=0):
    x, y = data(n, seed)
    return JaxListIterator(JaxDataSet(x, y), bs)


def port_iter(n, bs, seed=0):
    x, y = data(n, seed)
    return ListDataSetIterator(DataSet(x, y), bs)


def assert_params_close(jnet, net, atol=ATOL):
    from test_torch_regularised_training import flat, port_flat
    want, got = flat(jnet.params), port_flat(net)
    assert sorted(want) == sorted(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


def assert_nets_close(a, b, atol=ATOL):
    from test_torch_regularised_training import port_flat
    fa, fb = port_flat(a), port_flat(b)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.mesh8
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_sync_dp_matches_single_device_and_jax(kind):
    """Eight slots, averaging_frequency 1: the port equals its own
    single-device fit (bit for bit: one call on the whole batch) and the
    JAX wrapper on eight devices within 1e-5."""
    make = jax_mln if kind == "mln" else jax_cg
    jnet = make()
    single, dp = port_of(jnet), port_of(jnet)
    for x, y in batches(160, 32):
        single.fit(DataSet(x, y))
    ParallelWrapper(dp, workers=SLOTS, averaging_frequency=1).fit(
        port_iter(160, 32))
    JaxPW(jnet, workers=SLOTS, averaging_frequency=1).fit(jax_iter(160, 32))
    assert dp.iteration == single.iteration == jnet.iteration == 5
    assert_nets_close(dp, single, atol=0.0)
    assert_params_close(jnet, dp)
    assert abs(dp.get_score() - float(jnet.get_score())) < 1e-5


@pytest.mark.mesh8
@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_averaging_k4_matches_jax(updater):
    """averaging_frequency 4 over eight slots (no dropout): each slot's
    four local steps on its rows, then the mean of parameters and updater
    state, equal JAX's shard_map rounds within 1e-5; under Adam every
    slot's step i reads count c0 + i, and the counts end at c0 + 4."""
    jnet = jax_mln(lr=0.1 if updater == "sgd" else 0.01, updater=updater)
    net = port_of(jnet)
    pw = ParallelWrapper(net, workers=SLOTS, averaging_frequency=4)
    jpw = JaxPW(jnet, workers=SLOTS, averaging_frequency=4)
    for _ in range(2):
        pw.fit(port_iter(256, 32))
        jpw.fit(jax_iter(256, 32))
    assert net.iteration == jnet.iteration == 16
    assert_params_close(jnet, net)
    assert abs(net.get_score() - float(jnet.get_score())) < 1e-5
    if updater == "adam":
        counts = {int(v) for o in net.opt_state for k, v in o.items()
                  if k.endswith(".count")}
        assert counts == {16}


@pytest.mark.mesh8
def test_uneven_batch_padding_gradient_exact():
    """30 rows over 8 slots: the pad rows carry zero loss weight, so one
    step equals the single-device step on the 30 rows (1e-6) and JAX's
    padded step (1e-5)."""
    jnet = jax_mln()
    single, dp = port_of(jnet), port_of(jnet)
    x, y = data(30)
    single.fit(DataSet(x, y))
    ParallelWrapper(dp, workers=SLOTS).fit(port_iter(30, 30))
    JaxPW(jnet, workers=SLOTS).fit(jax_iter(30, 30))
    assert_nets_close(dp, single, atol=1e-6)
    assert_params_close(jnet, dp)


@pytest.mark.mesh8
def test_batchnorm_statistics_include_the_pad_rows_like_jax():
    """The pad rows (wrapped copies) enter the forward, as in JAX's global
    step: a BatchNormalization net's step on 30 rows over 8 slots, and its
    running statistics, equal JAX's."""
    jnet = jax_mln(bn=True, l2=1e-3)
    net = port_of(jnet)
    ParallelWrapper(net, workers=SLOTS).fit(port_iter(60, 30))
    JaxPW(jnet, workers=SLOTS).fit(jax_iter(60, 30))
    assert_params_close(jnet, net)
    for k in ("mean", "var"):
        np.testing.assert_allclose(net.state[1][k].numpy(),
                                   np.asarray(jnet.state[1][k]), atol=ATOL)


@pytest.mark.mesh8
def test_listeners_fire_as_in_jax():
    """fit chunks same-shape runs into fit_scan (one listener call a
    chunk), a lone or ragged batch trains alone: the calls' iterations
    equal JAX's."""
    from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

    class Rec(IterationListener):
        def __init__(self):
            self.its = []

        def iteration_done(self, model, iteration, epoch):
            self.its.append(iteration)

    jits = []

    class JRec:
        def iteration_done(self, model, iteration, epoch):
            jits.append(iteration)
    jnet = jax_mln()
    net = port_of(jnet)
    rec = Rec()
    net.set_listeners(rec)
    jnet.set_listeners(JRec())
    ParallelWrapper(net, workers=SLOTS).fit(port_iter(150, 32))
    JaxPW(jnet, workers=SLOTS).fit(jax_iter(150, 32))
    assert rec.its == jits == [4, 5]
    assert_params_close(jnet, net)


@pytest.mark.mesh8
def test_fit_scan_sync_and_averaging_match_fit_and_jax():
    """fit_scan equals the per-step (sync) and per-chunk (averaging)
    paths, and JAX's fit_scan."""
    x, y = data(256)
    xs, ys = x.reshape(8, 32, 4), y.reshape(8, 32, 3)
    for k in (1, 4):
        jnet = jax_mln(lr=0.1)
        scan_net, step_net = port_of(jnet), port_of(jnet)
        ParallelWrapper(scan_net, workers=SLOTS,
                        averaging_frequency=k).fit_scan(xs, ys)
        ParallelWrapper(step_net, workers=SLOTS,
                        averaging_frequency=k).fit(port_iter(256, 32))
        JaxPW(jnet, workers=SLOTS, averaging_frequency=k).fit_scan(
            jnp.asarray(xs), jnp.asarray(ys))
        assert scan_net.iteration == step_net.iteration == 8
        assert_nets_close(scan_net, step_net, atol=1e-6)
        assert_params_close(jnet, scan_net)


def test_fit_scan_validates_shapes():
    jnet = jax_mln()
    pw = ParallelWrapper(port_of(jnet), workers=SLOTS)
    with pytest.raises(ValueError, match="divide"):
        pw.fit_scan(np.zeros((4, 30, 4), np.float32),
                    np.zeros((4, 30, 3), np.float32))
    with pytest.raises(ValueError, match="share"):
        pw.fit_scan(np.zeros((4, 32, 4), np.float32),
                    np.zeros((3, 32, 3), np.float32))
    pw4 = ParallelWrapper(port_of(jnet), workers=SLOTS,
                          averaging_frequency=4)
    with pytest.raises(ValueError, match="multiple"):
        pw4.fit_scan(np.zeros((6, 32, 4), np.float32),
                     np.zeros((6, 32, 3), np.float32))


def test_wrapper_errors():
    """A tBPTT net's fit_scan, masks in averaging mode and a mesh without
    a data axis raise, as in JAX; so does a slot on another device than
    the model's."""
    from deeplearning4j_tpu_torch.exec.mesh import Mesh, Slot
    net = lstm_net(tbptt=True)
    with pytest.raises(ValueError, match="truncated BPTT"):
        ParallelWrapper(net, workers=2).fit_scan(
            np.zeros((2, 4, 6, 9), np.float32),
            np.zeros((2, 4, 6, 9), np.float32))
    net = port_of(jax_mln())
    x, y = data(32)
    pw = ParallelWrapper(net, workers=4, averaging_frequency=2)
    with pytest.raises(NotImplementedError, match="masks"):
        pw.fit([DataSet(x, y, labels_mask=np.ones(32, np.float32))])
    with pytest.raises(ValueError, match="'data' axis"):
        ParallelWrapper(net, mesh=Mesh([Slot(0, "cpu")], ("x",)))
    with pytest.raises(ValueError, match="model's device"):
        ParallelWrapper(net, mesh=Mesh([Slot(0, "cuda")], ("data",)))


def lstm_net(width=16, vocab=9, tbptt=False, seed=3):
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
         .list().layer(LSTM(n_out=width, activation="tanh"))
         .layer(LSTM(n_out=width, activation="tanh"))
         .layer(RnnOutputLayer(n_out=vocab, activation="softmax",
                               loss="mcxent"))
         .set_input_type(InputType.recurrent(vocab)))
    if tbptt:
        b = b.backprop_type("tbptt", 3, 3)
    return MultiLayerNetwork(b.build(), device="cpu").init()


def onehot(n, t=6, v=9, seed=0):
    r = np.random.RandomState(seed)
    eye = np.eye(v, dtype=np.float32)
    return eye[r.randint(0, v, (n, t))], eye[r.randint(0, v, (n, t))]


def test_lstm_recipe_shape_sync_and_padding():
    """The LSTM recipe's shape at small width (2 x LSTM(16), one-hot over
    9): four slots equal the container's own fit bit for bit over 5
    steps; 30 rows over 4 slots (two pad rows) give the 30-row step's
    parameters within 1e-6, and the rank's gradients (the gradient
    program) equal ``compute_gradient_and_score``'s within 1e-6."""
    single, dp = lstm_net(), lstm_net()
    pw = ParallelWrapper(dp, workers=4)
    for s in range(5):
        x, y = onehot(32, seed=s)
        single.fit(DataSet(x, y))
        pw.fit([DataSet(x, y)])
    assert_nets_close(dp, single, atol=0.0)
    x, y = onehot(30, seed=9)
    batch, pm = pw._prepare(DataSet(x, y))
    assert batch.rows == 32 and pm.sum() == 30
    flats = pw._sync_gradients(batch, pm, dp.iteration)
    got = pw._layout.unflatten([f[:-1] if i == pw._layout.loss_at else f
                                for i, f in enumerate(flats)])
    want, score = dp.compute_gradient_and_score(x, y)
    for g, w in zip(got, want):
        for k in w:
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=1e-6)
    assert abs(float(flats[pw._layout.loss_at][-1]) - score) < 1e-6
    single.fit(DataSet(x, y))
    pw.fit([DataSet(x, y)])
    assert_nets_close(dp, single, atol=1e-6)


def test_averaging_with_dropout_draws_per_slot(monkeypatch):
    """Each slot's step draws its own dropout masks (the slot folded into
    the seed): a run is repeatable, and differs from one where every slot
    draws the same."""
    from deeplearning4j_tpu_torch.exec.executor import slot_seed
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.parallel import wrapper

    def run():
        conf = (NeuralNetConfiguration.builder().seed(2)
                .updater(Adam(1e-2)).list()
                .layer(DenseLayer(n_out=16, activation="tanh", dropout=0.5))
                .layer(OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.feed_forward(4)).build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        ParallelWrapper(net, workers=4, averaging_frequency=2).fit(
            port_iter(128, 32))
        return net
    a, b = run(), run()
    monkeypatch.setattr(wrapper, "slot_seed",
                        lambda s, it, slot: slot_seed(s, it, 0))
    same = run()
    assert_nets_close(a, b, atol=0.0)
    assert not torch.equal(a.params[0]["W"], same.params[0]["W"])


def test_resnet50_dp_smoke_small_width():
    """ResNet50 (a graph with BatchNormalization) at width 1/8 on 32 x 32
    images: eight slots train it, and the step equals the single-device
    step within 1e-5 (one call on the whole batch)."""
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
    make = ResNet50(num_classes=10, input_shape=(32, 32, 3),
                    width_mult=0.125)
    single, dp = make.init(device="cpu"), make.init(device="cpu")
    rng = np.random.RandomState(0)
    x = rng.rand(16, 32, 32, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 16)]
    single.fit(DataSet(x, y))
    ParallelWrapper(dp, workers=SLOTS).fit(ListDataSetIterator(
        DataSet(x, y), 16))
    assert np.isfinite(dp.get_score())
    assert_nets_close(dp, single, atol=ATOL)


@pytest.mark.mesh8
def test_parallel_inference_matches_model_and_jax():
    jnet = jax_mln()
    net = port_of(jnet)
    x, _ = data(40)
    pi = ParallelInference(net)
    out = pi.output(x)
    assert torch.equal(out, net.output(x))
    want = JaxPI(jnet, mesh=jax.sharding.Mesh(
        np.array(jax.devices()[:SLOTS]), ("data",))).output(x)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL)
    pi8 = ParallelInference(net, mesh=ParallelWrapper(net,
                                                      workers=SLOTS).mesh)
    assert torch.equal(pi8.output(x[:13]), net.output(x[:13]))


def test_parallel_inference_batching_async():
    """Seven submits merged by the worker thread equal their unbatched
    forwards within 1e-6; ``warmup`` runs the engine's ladder on the
    caller's thread first."""
    net = port_of(jax_mln())
    pi = ParallelInference(net, batch_timeout_ms=5.0)
    assert pi.warmup((4,), max_batch=32)
    pi.start()
    rng = np.random.RandomState(1)
    xs = [rng.rand(3, 4).astype(np.float32) for _ in range(7)]
    futs = [pi.submit(x) for x in xs]
    outs = [f.result(timeout=30) for f in futs]
    pi.shutdown()
    for x, o in zip(xs, outs):
        assert o.shape == (3, 3)
        torch.testing.assert_close(o, net.output(x, bucketed=False),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("q_offset,k_offset", [(0, 0), (4, 0), (8, 2)])
def test_sdpa_offsets_causal_match_jax(q_offset, k_offset):
    """The port's scaled_dot_product_attention with q / k offsets (the
    causal mask over arange + offset) against the JAX function, 1e-5;
    with zero offsets it is the flash path (K5's plain version here)."""
    from deeplearning4j_tpu.nn.layers.attention import \
        scaled_dot_product_attention as jax_sdpa
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        scaled_dot_product_attention
    r = np.random.RandomState(q_offset + k_offset)
    q = r.randn(2, 8, 2, 8).astype(np.float32)
    k = r.randn(2, 8, 2, 8).astype(np.float32)
    v = r.randn(2, 8, 2, 8).astype(np.float32)
    for causal in (True, False):
        got = scaled_dot_product_attention(
            torch.tensor(q), torch.tensor(k), torch.tensor(v),
            causal=causal, q_offset=q_offset, k_offset=k_offset)
        want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   q_offset=q_offset, k_offset=k_offset))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    mask = (np.arange(8)[None] < np.array([[6], [8]])).astype(np.float32)
    got = scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True,
        mask=torch.tensor(mask), q_offset=q_offset, k_offset=k_offset)
    want = np.asarray(jax_sdpa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True,
                               mask=jnp.asarray(mask), q_offset=q_offset,
                               k_offset=k_offset))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_sdpa_zero_offsets_take_the_flash_wrapper(monkeypatch):
    """No mask, zero offsets, one shape, a head dim of 8: the call goes
    through ``ops.flash_attention`` (K5 on a card), and not otherwise."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.nn.layers import attention
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    q = torch.randn(1, 8, 2, 8)
    attention.scaled_dot_product_attention(q, q, q, causal=True)
    assert calls == [1]
    attention.scaled_dot_product_attention(q, q, q, causal=True, q_offset=1)
    attention.scaled_dot_product_attention(q[:, :4], q, q, causal=True)
    assert calls == [1]
