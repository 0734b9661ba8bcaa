"""The port's threshold compression, training masters and cluster facades
against the JAX package's (parallel/compression.py, scaleout/), on the
CPU.

Compression: the same indices, values, counts and residuals (exactly:
the same float32 operations), and the same threshold sequence, over ten
numpy-seeded gradients. The masters start from the JAX network's
parameters and see the same batches: ``ParameterAveragingTrainingMaster``
(averaging frequency 2 over four slots / devices) and
``SharedTrainingMaster`` on both paths (two logical workers, and the
collective exchange over eight slots / eight forced host devices, the
``mesh8`` marker) equal JAX within 1e-5 on every parameter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.parallel import compression as jc
from deeplearning4j_tpu import scaleout as jscale

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.exec.mesh import build_mesh
from deeplearning4j_tpu_torch.parallel import compression as pc
from deeplearning4j_tpu_torch import scaleout
from test_torch_regularised_training import flat, port_flat, port_of

ATOL = 1e-5


def _grads(n=500, k=10, seed=0):
    r = np.random.RandomState(seed)
    return [(r.randn(n) * 10.0 ** r.uniform(-4, -1, n)).astype(np.float32)
            for _ in range(k)]


def test_threshold_encode_decode_match_jax():
    for g in _grads(k=4):
        for thr, cap in ((1e-3, 50), (1e-2, 10), (1e-6, 500)):
            want = [np.asarray(a) for a in jc.threshold_encode(
                jnp.asarray(g), thr, cap)]
            got = [a.numpy() for a in pc.threshold_encode(
                torch.tensor(g), thr, cap)]
            for w, o in zip(want, got):
                assert o.dtype == w.dtype and np.array_equal(o, w)
            dense = pc.threshold_decode(*[torch.tensor(a) for a in got[:2]],
                                        g.size)
            assert np.array_equal(dense.numpy(), np.asarray(
                jc.threshold_decode(jnp.asarray(want[0]),
                                    jnp.asarray(want[1]), g.size)))
    g = torch.tensor([0.5, -0.002, 0.0001, -0.8, 0.01])
    idx, vals, count = pc.threshold_encode(g, 0.01, 4)
    assert int(count) == 3
    np.testing.assert_allclose(pc.threshold_decode(idx, vals, 5).numpy(),
                               [0.01, 0.0, 0.0, -0.01, 0.01], atol=1e-7)


def test_adapt_threshold_and_its_tensor_twin_match_jax():
    for thr, count, cap in ((0.5, 10, 10), (0.5, 2, 10), (0.5, 5, 10),
                            (1e-5, 0, 10), (0.1, 3, 12)):
        kw = dict(step=0.25, min_threshold=1e-4)
        want = jc.adapt_threshold(thr, count, cap, **kw)
        assert pc.adapt_threshold(thr, count, cap, **kw) == want
        t = pc.adapt_threshold_tensor(
            torch.tensor(thr, dtype=torch.float32),
            torch.tensor(count, dtype=torch.int32), cap, **kw)
        j = jc.adapt_threshold_jnp(jnp.float32(thr), jnp.int32(count), cap,
                                   step=jnp.float32(0.25),
                                   min_threshold=jnp.float32(1e-4))
        assert t.dtype == torch.float32
        assert t.item() == float(np.asarray(j))


@pytest.mark.parametrize("shake", [0, 3])
def test_encoding_handler_sequence_matches_jax(shake):
    """Ten encodes: messages, residuals and thresholds equal JAX's."""
    kw = dict(threshold=1e-3, min_threshold=1e-5, threshold_step=2e-4,
              shake_frequency=shake, capacity_fraction=0.1)
    ours, theirs = pc.EncodingHandler(**kw), jc.EncodingHandler(**kw)
    for g in _grads():
        got = ours.encode(torch.tensor(g))
        want = theirs.encode(jnp.asarray(g))
        for o, w in zip(got, want):
            assert np.array_equal(o.numpy(), np.asarray(w))
        assert np.array_equal(ours.residual.numpy(),
                              np.asarray(theirs.residual))
        assert ours.threshold == theirs.threshold
    ours.reset()
    assert ours.residual is None and ours.iteration == 0


def test_encoding_handler_takes_a_parameter_tree_in_pytree_order():
    """A tree of tensors ravels as JAX's ``ravel_pytree`` does (dict keys
    sorted), so the message indices agree."""
    r = np.random.RandomState(3)
    tree = [{"b": r.randn(3).astype(np.float32),
             "W": r.randn(4, 3).astype(np.float32)},
            {"W": r.randn(3, 2).astype(np.float32)}]
    got = pc.EncodingHandler(threshold=0.5, capacity_fraction=0.5).encode(
        [{k: torch.tensor(v) for k, v in p.items()} for p in tree])
    want = jc.EncodingHandler(threshold=0.5, capacity_fraction=0.5).encode(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in tree])
    for o, w in zip(got, want):
        assert np.array_equal(o.numpy(), np.asarray(w))


def test_accumulator_all_workers_receive_all_updates():
    acc = pc.EncodedGradientsAccumulator(2, 4, threshold=0.01,
                                         capacity_fraction=1.0)
    acc.store_update(0, torch.tensor([1.0, 0.0, 0.0, 0.0]))
    acc.store_update(1, torch.tensor([0.0, -1.0, 0.0, 0.0]))
    u0, u1 = acc.apply_update(0), acc.apply_update(1)
    assert torch.equal(u0, u1) and u0[0] > 0 and u0[1] < 0
    assert torch.equal(acc.apply_update(0), torch.zeros(4))


# --------------------------------------------------------------- masters
def _jax_net(seed=12, lr=0.1):
    from deeplearning4j_tpu import MultiLayerNetwork, NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.updaters import Sgd
    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr))
            .weight_init("xavier").list()
            .layer(DenseLayer(n_in=4, n_out=16, activation="tanh"))
            .layer(OutputLayer(n_in=16, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf).init()


def _toy(n, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    idx = (x.sum(axis=1) > 0).astype(int) + (x[:, 0] > 1).astype(int)
    return x, np.eye(3, dtype=np.float32)[idx]


def _batches(n_batches=8, bs=8):
    x, y = _toy(n_batches * bs)
    return [(x[i * bs:(i + 1) * bs], y[i * bs:(i + 1) * bs])
            for i in range(n_batches)]


def _close(jnet, net, atol=ATOL):
    want, got = flat(jnet.params), port_flat(net)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.mesh8
def test_parameter_averaging_master_matches_jax():
    jnet = _jax_net()
    net = port_of(jnet)
    jm = jscale.ParameterAveragingTrainingMaster(
        averaging_frequency=2, workers=4, batch_size_per_worker=4
    ).set_collect_training_stats(True)
    m = scaleout.ParameterAveragingTrainingMaster(
        averaging_frequency=2, workers=4, batch_size_per_worker=4
    ).set_collect_training_stats(True)
    bs = _batches()
    jscale.ClusterMultiLayerNetwork(jnet, jm).fit(
        [JaxDataSet(x, y) for x, y in bs], epochs=3)
    cn = scaleout.ClusterMultiLayerNetwork(net, m)
    before = np.mean(cn.score_examples([DataSet(x, y) for x, y in bs]))
    cn.fit([DataSet(x, y) for x, y in bs], epochs=3)
    assert (net.iteration, net.epoch) == (jnet.iteration, jnet.epoch)
    _close(jnet, net)
    assert np.mean(cn.score_examples([DataSet(x, y) for x, y in bs])) < \
        before
    t = m.get_training_stats()
    assert {"fit", "repartition"} <= set(t.timings)
    assert "fit: n=3" in t.summary()
    assert cn.get_network() is net and cn.get_training_master() is m


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_shared_master_logical_workers_match_jax(workers):
    """The round-robin workers with the accumulator: the averaged
    replicas, the iteration and the mean loss equal JAX's over five
    epochs (its residuals carried across calls)."""
    jnet = _jax_net()
    net = port_of(jnet)
    kw = dict(threshold=1e-3, workers=workers, learning_rate=0.1,
              batch_size_per_worker=8)
    jm, m = jscale.SharedTrainingMaster(**kw), scaleout.SharedTrainingMaster(
        **kw)
    bs = _batches()
    for _ in range(5):
        jm.execute_training(jnet, [JaxDataSet(x, y) for x, y in bs])
        m.execute_training(net, [DataSet(x, y) for x, y in bs])
        _close(jnet, net)
        assert abs(net._score - jnet._score) < 1e-5
    assert net.iteration == jnet.iteration == 40


def test_shared_master_update_magnitude_independent_of_workers():
    bs = [DataSet(x, y) for x, y in _batches()]
    deltas = {}
    for workers in (1, 4):
        net = port_of(_jax_net())
        v0 = torch.cat([p.reshape(-1) for d in net.params
                        for p in d.values()])
        scaleout.ClusterMultiLayerNetwork(net, scaleout.SharedTrainingMaster(
            threshold=1e-3, workers=workers, learning_rate=0.05)).fit(bs)
        v1 = torch.cat([p.reshape(-1) for d in net.params
                        for p in d.values()])
        deltas[workers] = float((v1 - v0).norm())
    assert 0.5 < deltas[4] / deltas[1] < 2.0, deltas


@pytest.mark.mesh8
@pytest.mark.parametrize("threshold,step", [(1e-3, 1e-5), (10.0, 0.5)])
def test_shared_master_collective_matches_jax_on_eight(threshold, step):
    """Eight slots on the CPU against JAX's shard_map exchange over eight
    devices: parameters, iteration, score and the mean threshold (a huge
    threshold decays toward the floor in both)."""
    jnet = _jax_net()
    net = port_of(jnet)
    kw = dict(threshold=threshold, threshold_step=step, learning_rate=0.1,
              batch_size_per_worker=4)
    jm = jscale.SharedTrainingMaster(mesh=jax.sharding.Mesh(
        np.array(jax.devices()[:8]), ("data",)), **kw)
    m = scaleout.SharedTrainingMaster(mesh=build_mesh(["cpu"] * 8), **kw)
    bs = _batches(8, 32)
    for _ in range(2):
        jscale.ClusterMultiLayerNetwork(jnet, jm).fit(
            [JaxDataSet(x, y) for x, y in bs])
        scaleout.ClusterMultiLayerNetwork(net, m).fit(
            [DataSet(x, y) for x, y in bs])
    _close(jnet, net)
    assert net.iteration == jnet.iteration == 16
    assert abs(float(net._score) - float(jnet._score)) < 1e-5
    assert abs(m.threshold - float(jm.threshold)) < 1e-9
    if threshold == 10.0:
        assert m.threshold < 10.0
    with pytest.raises(ValueError, match="global batch"):
        m.execute_training(net, [DataSet(*_toy(8))])


def test_repartition_matches_jax():
    x = np.random.RandomState(0).randn(10, 5, 3).astype(np.float32)
    y = np.zeros((10, 5, 2), np.float32)
    mk = (np.arange(5)[None, :] < 3).astype(np.float32).repeat(10, 0)
    got = scaleout.repartition([DataSet(x, y, mk, mk)], 4, seed=2)
    want = jscale.repartition([JaxDataSet(x, y, mk, mk)], 4, seed=2)
    assert [b.features.shape[0] for b in got] == [4, 4, 2]
    for g, w in zip(got, want):
        for name in ("features", "labels", "features_mask", "labels_mask"):
            assert np.array_equal(getattr(g, name),
                                  np.asarray(getattr(w, name)))
    bs = [DataSet(x, y) for x, y in _batches(3, 10)]
    assert [b.features.shape[0] for b in scaleout.repartition(bs, 8)] == \
        [8, 8, 8, 6]
    assert scaleout.repartition([], 8) == []


def test_cluster_graph_facade_and_spi():
    """ClusterComputationGraph forwards fit / evaluate; the SPI's base
    raises."""
    from test_torch_parallel import jax_cg
    net = port_of(jax_cg())
    x, y = _toy(32)
    m = scaleout.ParameterAveragingTrainingMaster(batch_size_per_worker=8,
                                                  workers=4)
    cg = scaleout.ClusterComputationGraph(net, m)
    cg.fit([DataSet(x, y)], epochs=2)
    assert net.iteration == 2
    ev = cg.evaluate(DataSet(x, y))
    assert 0.0 <= ev.accuracy() <= 1.0
    with pytest.raises(NotImplementedError):
        scaleout.TrainingMaster().execute_training(net, [])
