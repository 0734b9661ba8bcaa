"""The port's tensor parallelism (``exec.param_spec``, the mesh's
``model`` axis, parallel/tensor_parallel.py, ``ParallelWrapper`` TP x DP)
against the JAX package's, on the CPU.

The JAX side runs its 2-D (data, model) meshes on the eight forced host
devices (the ``mesh8`` marker, tests/conftest.py); the port's side runs
eight slots on the CPU, each model shard computing with its own shards.
Both start from the same parameters (the JAX network carried over by its
JSON and ``params_from_numpy``) and see the same numpy-seeded batches.

- ``param_spec``: every case of the JAX test (tests/test_exec.py:128-138)
  and the JAX executor's placement of a TinyTransformer and LeNet, spec
  for spec; ``put_params`` splits; the JAX ``_state_shardings``.
- TP x DP ``fit`` and ``fit_scan`` against JAX's TP x DP run and against
  single-device training: the dense net, TinyTransformer and LeNet, at
  the JAX tests' tolerances (rtol 1e-4 / atol 1e-5; conv 2e-4 / 1e-4).
  ``Sgd``, as the JAX tests use (the K bias's exact gradient is 0, and
  Adam's normalization blows its reduction noise up).
- Each attention shard launches the flash path on its own H/m heads;
  the updater state comes back gathered (Adam's moments against
  single-device training).
- The JAX errors: averaging with a model axis, and the port's own: a
  head count the model size does not divide.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from deeplearning4j_tpu import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.exec import Executor as JaxExecutor
from deeplearning4j_tpu.exec import param_spec as jax_param_spec
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd
from deeplearning4j_tpu.parallel.wrapper import ParallelWrapper as JaxPW
from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.exec import Executor, build_mesh, param_spec
from deeplearning4j_tpu_torch.exec.executor import (gather_leaf, key_path,
                                                    split_dim, tree_paths)
from deeplearning4j_tpu_torch.exec.mesh import Mesh, Slot
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    Shards, Split, TensorParallel, gather)
from test_torch_regularised_training import port_of

RTOL, ATOL = 1e-4, 1e-5              # the JAX TP tests' tolerances
CONV_RTOL, CONV_ATOL = 2e-4, 1e-4


def jax_mesh(data=4, model=2):
    return JaxMesh(np.array(jax.devices()[:data * model]).reshape(
        data, model), ("data", "model"))


def port_mesh(data=4, model=2):
    return build_mesh(["cpu"] * (data * model), model_parallel=model)


def jax_tp_net(updater="sgd"):
    upd = JaxSgd(0.1) if updater == "sgd" else JaxAdam(1e-2)
    conf = (JaxConf.builder().seed(9).updater(upd).weight_init("xavier")
            .list()
            .layer(JaxDense(n_out=32, activation="relu"))
            .layer(JaxDense(n_out=16, activation="relu"))
            .layer(JaxOut(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(8)).build())
    return JaxMLN(conf).init()


def tp_data(n=32):
    rs = np.random.RandomState(3)
    x = rs.randn(n, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)]
    return x, y


def jax_tt(n_heads=4):
    return JaxTiny(vocab_size=16, n_layers=2, d_model=32, n_heads=n_heads,
                   seed=5, updater=JaxSgd(0.05)).init()


def tt_data(n=16, T=12, vocab=16):
    rs = np.random.RandomState(4)
    ids = rs.randint(0, vocab, size=(n, T))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=1)]


def jax_lenet():
    from __graft_entry__ import _lenet_conf
    return JaxMLN(_lenet_conf(height=16, width=16)).init()


def lenet_data():
    rs = np.random.RandomState(1)
    x = rs.rand(16, 16, 16, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 16)]
    return x, y


def leaves(params):
    items = params.items() if isinstance(params, dict) \
        else enumerate(params)
    return {(m, k): np.asarray(v.detach() if isinstance(v, torch.Tensor)
                               else v)
            for m, p in items for k, v in p.items()}


def assert_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=str(k))


# ------------------------------------------------------------ param_spec
SPEC_CASES = [("['Wq']", (8, 32), 2), ("['ff2']['W']", (32, 8), 2),
              ("['dense']['W']", (32, 8), 2), ("['b']", (32,), 2),
              ("['W']", (3, 5), 2), ("['Wq']", (8, 32), 1),
              ("['b0_attn']['Wo']", (32, 32), 4),
              ("['up']['W']", (64, 16), 2), ("[0]['W']", (5, 5, 1, 20), 2),
              ("['down']['W']", (6, 12), 3)]


@pytest.mark.parametrize("path,shape,m", SPEC_CASES)
def test_param_spec_megatron_rules_match_jax(path, shape, m):
    """The JAX test's cases (tests/test_exec.py:128-138) and a few more:
    the same spec as a tuple of axis names, ``()`` when replicated."""
    want = tuple(jax_param_spec(path, jnp.zeros(shape), m))
    assert param_spec(path, torch.zeros(shape), m) == want


def test_param_spec_the_jax_test_cases():
    w_col = torch.zeros((8, 32))
    assert param_spec("['Wq']", w_col, 2) == (None, "model")
    w_row = torch.zeros((32, 8))
    assert param_spec("['ff2']['W']", w_row, 2) == ("model", None)
    assert param_spec("['dense']['W']", w_row, 2) == ("model", None)
    assert param_spec("['b']", torch.zeros((32,)), 2) == ()
    assert param_spec("['W']", torch.zeros((3, 5)), 2) == ()
    assert param_spec("['Wq']", w_col, 1) == ()
    assert param_spec("['W']", w_col, 2, axis="tp") == (None, "tp")


@pytest.mark.mesh8
@pytest.mark.parametrize("which", ["tt", "lenet", "dense"])
def test_placement_matches_the_jax_executor(which):
    """Every leaf's spec: the port's executor and wrapper against the JAX
    executor's ``param_shardings`` and wrapper's ``_param_sharding``."""
    jnet = {"tt": jax_tt, "lenet": jax_lenet, "dense": jax_tp_net}[which]()
    net = port_of(jnet)
    jex = JaxExecutor(jax_mesh())
    jsh = jax.tree_util.tree_flatten_with_path(
        jex.param_shardings(jnet.params))[0]
    want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in jsh}
    got = dict((path, spec) for (path, _), spec in zip(
        tree_paths(net.params),
        [s for _, s in tree_paths(Executor(port_mesh()).param_shardings(
            net.params))]))
    assert got == want
    jpw = JaxPW(jnet, mesh=jax_mesh())
    pw = ParallelWrapper(net, mesh=port_mesh())
    for path, leaf in tree_paths(net.params):
        assert pw._param_sharding(leaf, path) == tuple(
            jpw._param_sharding(np.asarray(leaf), path).spec), path


def test_tinytransformer_placement_and_put_params():
    """Q/K/V column-split, Wo / ff2 / the output row-split, LN vectors
    replicated; ``put_params`` / ``_replicated`` split each leaf into
    its model shards (concatenated back: the leaf)."""
    net = port_of(jax_tt())
    ex = Executor(port_mesh())
    sp = ex.param_shardings(net.params)
    assert sp["b0_attn"]["Wq"] == (None, "model")
    assert sp["b0_attn"]["Wo"] == ("model", None)
    assert sp["b0_ff1"]["W"] == (None, "model")
    assert sp["b0_ff2"]["W"] == ("model", None)
    assert sp["b0_ln1"]["gamma"] == () and sp["b0_attn"]["bq"] == ()
    assert sp["pos"]["P"] == ("model", None)     # the row-shape rule
    assert Executor(port_mesh(8, 1)).param_shardings(net.params) == ()
    put = ex.put_params(net.params)
    pw = ParallelWrapper(net, mesh=port_mesh())
    rep = pw._replicated(net.params)
    for tree in (put, rep):
        wq = tree["b0_attn"]["Wq"]
        assert [tuple(t.shape) for t in wq] == [(32, 16), (32, 16)]
        assert torch.equal(torch.cat(wq, 1), net.params["b0_attn"]["Wq"])
        g = tree["b0_ln1"]["gamma"]
        assert len(g) == 2 and g[0] is net.params["b0_ln1"]["gamma"]
    assert key_path("b0_attn", "Wq") == "['b0_attn']['Wq']"
    assert key_path(0, "fwd/W") == "[0]['fwd']['W']"


def test_tensor_parallel_shards_are_put_params():
    """``TensorParallel``'s resident shards are the executor's split
    (``Executor.put_params``, ``split_leaf``), each updater-state leaf
    split as its own parameter (by path), and ``store`` is ``load``'s
    inverse: a round trip leaves every container tensor bit for bit."""
    x, y = tp_data()
    net = port_of(jax_tp_net("adam"))
    net.fit(DataSet(x[:16], y[:16]))          # moments that are not zero
    before = (leaves(net.params), leaves(net.opt_state))
    tp = TensorParallel(net, 2)
    put = Executor(port_mesh(4, 2)).put_params(net.params)
    split = 0
    for i, p in enumerate(net.params):
        for k, v in p.items():
            spec = tp.specs[i][k]
            if split_dim(spec) is None:
                assert tp.params[i][k] is v and put[i][k][0] is v
                continue
            split += 1
            for s in range(2):
                assert torch.equal(tp.params[i][f"{k}@{s}"], put[i][k][s])
            for ok, ov in net.opt_state[i].items():
                if ok.endswith(f"/{k}"):
                    parts = [tp.opt[i][f"{ok}@{s}"] for s in range(2)]
                    assert [tuple(t.shape) for t in parts] == \
                        [tuple(t.shape) for t in put[i][k]]
                    assert torch.equal(gather_leaf(parts, spec), ov)
    assert split == 3
    tp.store()
    for got, want in zip((leaves(net.params), leaves(net.opt_state)),
                         before):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_the_wrapper_and_a_data_axis_default_mesh_train_as_before(
        monkeypatch):
    """``ParallelWrapper`` with a (data, model) mesh trains beside a
    ``DL4JTPU_MESH=model=2`` default mesh (over two CPU slots), and a
    default mesh without a model axis (``data=2``) keeps the container's
    own fit path."""
    from deeplearning4j_tpu_torch.exec import executor as ex_mod
    from deeplearning4j_tpu_torch.exec import mesh as mesh_mod
    from deeplearning4j_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "process_device",
                        lambda: torch.device("cpu"))
    monkeypatch.setenv("DL4JTPU_MESH", "model=2")
    monkeypatch.setenv("DL4JTPU_SLOTS", "2")
    monkeypatch.setattr(mesh_mod, "_default_mesh", None)
    monkeypatch.setattr(ex_mod, "_default_executor", None)
    x, y = tp_data()
    net = port_of(jax_tp_net())
    ParallelWrapper(net, mesh=port_mesh()).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    assert net.iteration == 2
    assert net._executor.model_size == 2
    assert mesh_mod._default_mesh.shape == {"data": 1, "model": 2}
    monkeypatch.setenv("DL4JTPU_MESH", "data=2")
    monkeypatch.setattr(mesh_mod, "_default_mesh", None)
    monkeypatch.setattr(ex_mod, "_default_executor", None)
    fresh = port_of(jax_tp_net())
    fresh.fit(DataSet(x, y))
    assert fresh.iteration == 1
    assert fresh._tp_runner is None and fresh.tp_routes == {}


def test_state_shardings_follow_jax_by_shape():
    """The JAX rule the executor reports: an updater-state leaf takes the
    spec of the first parameter of its shape."""
    ex = Executor(port_mesh(4, 2))
    params = {"dense": {"W": torch.zeros((32, 8)), "b": torch.zeros((8,))}}
    opt = {"m": {"W": torch.zeros((32, 8)), "b": torch.zeros((8,))}}
    sh = ex._state_shardings(opt, params)
    assert sh["m"]["W"] == ("model", None) and sh["m"]["b"] == ()


# ---------------------------------------------------------------- TP x DP
def _jax_fit(jnet, x, y, bs):
    JaxPW(jnet, mesh=jax_mesh()).fit(JaxListIterator(JaxDataSet(x, y), bs))
    return jnet


@pytest.mark.mesh8
def test_dense_tp_dp_fit_matches_jax_and_single_device():
    x, y = tp_data()
    ref = port_of(jax_tp_net())
    for i in range(0, 32, 16):
        ref.fit(DataSet(x[i:i + 16], y[i:i + 16]))
    net = port_of(jax_tp_net())
    pw = ParallelWrapper(net, mesh=port_mesh())
    assert pw.model_axis == "model" and pw.n_devices == 4
    assert pw.data_slots == 4 and pw.model_size == 2
    pw.fit(ListDataSetIterator(DataSet(x, y), 16))
    assert net.iteration == 2
    assert_close(net.params, ref.params)
    jnet = _jax_fit(jax_tp_net(), x, y, 16)
    assert_close(net.params, jnet.params)


@pytest.mark.mesh8
def test_dense_tp_dp_fit_scan_matches_jax():
    x, y = tp_data()
    jnet = jax_tp_net()
    JaxPW(jnet, mesh=jax_mesh()).fit_scan(x.reshape(2, 16, 8),
                                          y.reshape(2, 16, 4))
    net = port_of(jax_tp_net())
    ParallelWrapper(net, mesh=port_mesh()).fit_scan(x.reshape(2, 16, 8),
                                                    y.reshape(2, 16, 4))
    assert net.iteration == 2
    assert_close(net.params, jnet.params)


def test_tp_adam_state_comes_back_gathered():
    """Adam over a (2, 4) mesh: the parameters AND the updater state
    (moments split by path, counts advanced) equal single-device
    training's, and a second fit resumes from them."""
    x, y = tp_data()
    ref = port_of(jax_tp_net("adam"))
    net = port_of(jax_tp_net("adam"))
    pw = ParallelWrapper(net, mesh=port_mesh(2, 4))
    for _ in range(2):
        for i in range(0, 32, 16):
            ref.fit(DataSet(x[i:i + 16], y[i:i + 16]))
        pw.fit(ListDataSetIterator(DataSet(x, y), 16))
    assert_close(net.params, ref.params, 1e-4, 1e-6)
    assert_close(net.opt_state, ref.opt_state, 1e-4, 1e-7)
    assert int(net.opt_state[0]["0/.count"]) == 4


@pytest.mark.mesh8
@pytest.mark.parametrize("path", ["fit", "fit_scan"])
def test_tinytransformer_tp_dp_matches_jax_and_single_device(path):
    x, y = tt_data()
    ref = port_of(jax_tt())
    for i in range(0, 16, 8):
        ref.fit(DataSet(x[i:i + 8], y[i:i + 8]))
    net = port_of(jax_tt())
    pw = ParallelWrapper(net, mesh=port_mesh())
    jnet = jax_tt()
    jpw = JaxPW(jnet, mesh=jax_mesh())
    if path == "fit":
        pw.fit(ListDataSetIterator(DataSet(x, y), 8))
        jpw.fit(JaxListIterator(JaxDataSet(x, y), 8))
    else:
        xs, ys = x.reshape(2, 8, 12, 16), y.reshape(2, 8, 12, 16)
        pw.fit_scan(xs, ys)
        jpw.fit_scan([xs], [ys])      # a graph's inputs and labels: lists
    assert_close(net.params, ref.params)
    assert_close(net.params, jnet.params)


@pytest.mark.mesh8
def test_lenet_tp_dp_matches_jax_and_single_device():
    """The conv kernels split over their output channels, the dense /
    output pair Megatron-style (the dense activation handed on split)."""
    x, y = lenet_data()
    ref = port_of(jax_lenet())
    for i in range(0, 16, 8):
        ref.fit(DataSet(x[i:i + 8], y[i:i + 8]))
    net = port_of(jax_lenet())
    pw = ParallelWrapper(net, mesh=port_mesh())
    pw.fit(ListDataSetIterator(DataSet(x, y), 8))
    assert [l.emit_split for l in pw._tp.shadow.layers] == \
        [False, False, False, False, True, False]
    assert_close(net.params, ref.params, CONV_RTOL, CONV_ATOL)
    jnet = _jax_fit(jax_lenet(), x, y, 8)
    assert_close(net.params, jnet.params, CONV_RTOL, CONV_ATOL)


def test_each_attention_shard_attends_over_its_own_heads(monkeypatch):
    """One step over a (4, 2) mesh: 2 blocks x 2 model shards calls of the
    flash path (K5 on a card, K6 + K7 in its backward), each over the
    shard's B*H/2 heads; ff1 hands its activation to ff2 split."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.nn.layers import attention
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, causal=False):
        calls.append((tuple(q.shape), causal))
        return real(q, k, v, causal)
    monkeypatch.setattr(attention.ops, "flash_attention", spy)
    x, y = tt_data()
    net = port_of(jax_tt())
    pw = ParallelWrapper(net, mesh=port_mesh())
    pw.fit([DataSet(x[:8], y[:8])])
    assert calls == [((8 * 2, 12, 8), True)] * 4
    names = [n for n, nd in pw._tp.shadow.conf.nodes.items()
             if nd.kind == "layer" and nd.layer.emit_split]
    assert names == ["b0_ff1", "b1_ff1"]


def test_split_activation_and_shards_helpers():
    a, b = torch.randn(3, 4), torch.randn(3, 2)
    s = Split([a, b])
    assert s.ndim == 2
    assert torch.equal(gather(s), torch.cat([a, b], -1))
    assert gather(a) is a
    w = Shards([torch.ones(2, 3), torch.zeros(2, 3)], 0)
    assert torch.equal(w.full(), torch.cat([torch.ones(2, 3),
                                            torch.zeros(2, 3)]))


# ------------------------------------------------------------------ errors
@pytest.mark.mesh8
def test_tp_rejects_averaging_like_jax():
    with pytest.raises(ValueError) as want:
        JaxPW(jax_tp_net(), mesh=jax_mesh(), averaging_frequency=4)
    with pytest.raises(ValueError) as got:
        ParallelWrapper(port_of(jax_tp_net()), mesh=port_mesh(),
                        averaging_frequency=4)
    assert str(got.value) == str(want.value)


def test_heads_the_model_size_does_not_divide_raise():
    """d_model 32 over 4 shards splits Wq into 8 columns a shard, inside
    the 16-wide heads of a 2-head layer: refused when built."""
    net = port_of(jax_tt(n_heads=2))
    with pytest.raises(ValueError, match="heads do not divide"):
        TensorParallel(net, 4)
    x, y = tt_data()
    pw = ParallelWrapper(net, mesh=port_mesh(2, 4))
    with pytest.raises(ValueError, match="heads do not divide"):
        pw.fit([DataSet(x[:8], y[:8])])


def test_model_axis_across_ranks_raises():
    slots = [Slot(0, "cpu"), Slot(1, "cpu")]
    with pytest.raises(ValueError, match="ROADMAP item 7"):
        Mesh(slots, ("data", "model"), (1, 2))
