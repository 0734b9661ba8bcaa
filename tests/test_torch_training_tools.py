"""Early stopping, transfer learning and the full-batch solvers of the port,
held against the JAX package on the CPU.

Nets: the JAX suites' MLP (4 -> Dense(16) -> Dense(8) -> softmax(3), Adam
1e-2, seed 42) and toy net (4 -> tanh Dense(16) -> softmax(3), Sgd 0.1,
seed 12), and the TextGenerationLSTM shape at small width (vocab 9, 2 x
LSTM(8), softmax RnnOutputLayer, T=6). The port's network is built from
the JAX network's JSON and parameters (``port_of``); a layer the transfer
builder initializes afresh takes the JAX package's draws, carried across
with ``params_from_numpy`` (the two packages' generators differ by
design).

Tolerances: early-stopping scores rtol 1e-5; parameters after N steps
rtol 1e-4, atol 1e-6; solver score histories rtol 1e-4. Frozen
parameters, and the source network's after a fine-tune, are held bit for
bit. The aliasing tests fail if the JAX lines that assume immutable
arrays (``net.params = unravel(x)`` in the solvers, the shared parameter
lists of ``TransferLearning.Builder`` and ``TransferLearningHelper``, the
helper's write-back by assignment) are carried over literally.
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.fetchers import load_iris
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.earlystopping import early_stopping as jes
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.updaters import Adam as JAdam, Sgd as JSgd
from deeplearning4j_tpu.optimize import solvers as jsol
from deeplearning4j_tpu.transferlearning import transfer as jtl

from deeplearning4j_tpu_torch import params_from_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.earlystopping import early_stopping as es
from deeplearning4j_tpu_torch.nn import layers as pl
from deeplearning4j_tpu_torch.nn.layers.special import FrozenLayer
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.optimize import solvers as sol
from deeplearning4j_tpu_torch.transferlearning import transfer as tl
from test_torch_regularised_training import flat, port_flat, port_of

SCORE_RTOL = 1e-5
P_RTOL, P_ATOL = 1e-4, 1e-6
HIST_RTOL = 1e-4
V, T = 9, 6


def _mlp(seed=42):
    conf = (JNNC.builder().seed(seed).updater(JAdam(1e-2)).list()
            .layer(jl.DenseLayer(n_out=16, activation="relu"))
            .layer(jl.DenseLayer(n_out=8, activation="relu"))
            .layer(jl.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(JIT.feed_forward(4)).build())
    return JMLN(conf).init()


def _toy(seed=12):
    conf = (JNNC.builder().seed(seed).updater(JSgd(0.1))
            .weight_init("xavier").list()
            .layer(jl.DenseLayer(n_in=4, n_out=16, activation="tanh"))
            .layer(jl.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                  loss="mcxent"))
            .build())
    return JMLN(conf).init()


def _lstm(seed=7):
    conf = (JNNC.builder().seed(seed).updater(JAdam(1e-2))
            .weight_init("xavier").list()
            .layer(jl.LSTM(n_out=8, activation="tanh"))
            .layer(jl.LSTM(n_out=8, activation="tanh"))
            .layer(jl.RnnOutputLayer(n_out=V, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(JIT.recurrent(V)).build())
    return JMLN(conf).init()


def _seq(seed, n=8):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    return eye[r.randint(0, V, (n, T))], eye[r.randint(0, V, (n, T))]


def _toy_data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    idx = (x.sum(axis=1) > 0).astype(int) + (x[:, 0] > 1).astype(int)
    return x, np.eye(3, dtype=np.float32)[idx]


def _close(jtree, net, rtol=P_RTOL, atol=P_ATOL):
    want, got = flat(jtree), port_flat(net)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _snap(net):
    return [{k: v.detach().clone() for k, v in p.items()} for p in net.params]


def _bitwise(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


# ------------------------------------------------------------ early stopping

def _es_case(case, ns, tmp):
    """(configuration, train iterator) of ``case`` in namespace ``ns``
    (the JAX or the port module set)."""
    m, DS, It = ns
    x, y = load_iris()
    nan_x = x.copy()
    nan_x[3] = np.nan
    train = It(DS(x, y), 50)
    held = It(DS(x, y), 150)
    if case == "max_epochs_local_saver":
        return m.EarlyStoppingConfiguration(
            score_calculator=m.DataSetLossCalculator(held),
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(5)],
            iteration_termination_conditions=[
                m.InvalidScoreIterationTerminationCondition()],
            model_saver=m.LocalFileModelSaver(str(tmp))), train
    if case == "no_improvement_in_memory":
        return m.EarlyStoppingConfiguration(
            score_calculator=m.DataSetLossCalculator(held),
            epoch_termination_conditions=[
                m.MaxEpochsTerminationCondition(100),
                m.ScoreImprovementEpochTerminationCondition(
                    3, min_improvement=10.0)],
            model_saver=m.InMemoryModelSaver()), It(DS(x, y), 150)
    if case == "improvement_patience_latest":
        return m.EarlyStoppingConfiguration(
            score_calculator=m.DataSetLossCalculator(held, average=False),
            epoch_termination_conditions=[
                m.MaxEpochsTerminationCondition(6),
                m.ScoreImprovementEpochTerminationCondition(2)],
            model_saver=m.InMemoryModelSaver(), save_last_model=True,
            evaluate_every_n_epochs=2), train
    if case == "classification_score":
        return m.EarlyStoppingConfiguration(
            score_calculator=m.ClassificationScoreCalculator(held),
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(3)],
            model_saver=m.InMemoryModelSaver()), train
    if case == "max_score_iteration":
        return m.EarlyStoppingConfiguration(
            score_calculator=m.DataSetLossCalculator(held),
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(9)],
            iteration_termination_conditions=[
                m.MaxScoreIterationTerminationCondition(0.5)]), train
    if case == "invalid_score_iteration":
        return m.EarlyStoppingConfiguration(
            score_calculator=m.DataSetLossCalculator(held),
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(9)],
            iteration_termination_conditions=[
                m.InvalidScoreIterationTerminationCondition()]), \
            It(DS(nan_x, y), 50)
    if case == "max_time_epoch":
        return m.EarlyStoppingConfiguration(
            score_calculator=m.DataSetLossCalculator(held),
            epoch_termination_conditions=[
                m.MaxTimeTerminationCondition(0.0)]), train
    if case == "max_time_iteration":
        return m.EarlyStoppingConfiguration(
            epoch_termination_conditions=[m.MaxEpochsTerminationCondition(9)],
            iteration_termination_conditions=[
                m.MaxTimeTerminationCondition(0.0)]), train
    raise ValueError(case)


ES_CASES = ("max_epochs_local_saver", "no_improvement_in_memory",
            "improvement_patience_latest", "classification_score",
            "max_score_iteration", "invalid_score_iteration",
            "max_time_epoch", "max_time_iteration")


@pytest.mark.parametrize("case", ES_CASES)
def test_early_stopping_matches_jax(case, tmp_path):
    jnet = _mlp()
    net = port_of(jnet)
    jcfg, jit = _es_case(case, (jes, JDataSet, JList), tmp_path / "jax")
    cfg, it = _es_case(case, (es, DataSet, ListDataSetIterator),
                       tmp_path / "port")
    jres = jes.EarlyStoppingTrainer(jcfg, jnet, jit).fit()
    res = es.EarlyStoppingTrainer(cfg, net, it).fit()
    assert res.total_epochs == jres.total_epochs
    assert res.termination_reason == jres.termination_reason
    assert res.termination_details == jres.termination_details
    assert res.best_model_epoch == jres.best_model_epoch
    assert sorted(res.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        np.testing.assert_allclose(res.score_vs_epoch[e], s,
                                   rtol=SCORE_RTOL, err_msg=f"epoch {e}")
    np.testing.assert_allclose(res.best_model_score, jres.best_model_score,
                               rtol=SCORE_RTOL)
    if case == "invalid_score_iteration":
        return              # the weights are NaN in both
    _close(jres.best_model.params, res.best_model)
    assert res.best_model.device == net.device
    if case == "max_epochs_local_saver":
        assert (tmp_path / "port" / "bestModel.zip").exists()
    if case == "improvement_patience_latest":
        latest = cfg.model_saver.get_latest_model()
        _close(jcfg.model_saver.get_latest_model().params, latest)


def test_early_stopping_best_model_is_the_best_epochs_parameters():
    """The best model read back equals, bit for bit, the parameters the
    network held after its best epoch."""
    x, y = load_iris()
    net = port_of(_mlp())
    saved = {}

    class Saver(es.InMemoryModelSaver):
        def save_best_model(self, model, score):
            saved["params"] = _snap(model)
            super().save_best_model(model, score)

    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(
            ListDataSetIterator(DataSet(x, y), 150)),
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(4)],
        model_saver=Saver())
    res = es.EarlyStoppingTrainer(
        cfg, net, ListDataSetIterator(DataSet(x, y), 50)).fit()
    assert _bitwise(res.best_model.params, saved["params"])
    assert res.best_model is not net


# -------------------------------------------------------- transfer learning

def test_transfer_freeze_and_replace_head_matches_jax():
    x, y = load_iris()
    jbase = _mlp()
    for _ in range(60):
        jbase.fit(JDataSet(x, y))
    base = port_of(jbase)
    source = _snap(base)

    def build(m, b, Out, Upd):
        return (m.TransferLearning.Builder(b)
                .fine_tune_configuration(m.FineTuneConfiguration(
                    updater=Upd(0.05)))
                .set_feature_extractor(0).remove_output_layer()
                .add_layer(Out(n_out=3, activation="softmax", loss="mcxent"))
                .build())
    jnew = build(jtl, jbase, jl.OutputLayer, JSgd)
    new = build(tl, base, pl.OutputLayer, Sgd)
    assert isinstance(new.layers[0], FrozenLayer) and len(new.layers) == 3
    _close(jnew.params[:2], _Head(new, 2), rtol=0, atol=0)
    # the fresh head: JAX's draws, copied into the port's own tensors
    with torch.no_grad():
        for k, v in new.params[2].items():
            v.copy_(torch.from_numpy(np.array(jnew.params[2][k])))
    new._params_version += 1
    frozen = _snap(new)[0]
    for _ in range(20):
        jnew.fit(JDataSet(x, y))
        new.fit(x, y)
    _close(jnew.params, new)
    assert _bitwise([new.params[0]], [frozen])
    assert _bitwise(base.params, source), "the fine-tune wrote the source"
    # and the source trains without moving the new net's frozen layer
    base.fit(x, y)
    assert _bitwise([new.params[0]], [frozen])
    assert new.evaluate(DataSet(x, y)).accuracy() > 0.8


class _Head:
    """The first ``n`` layers' parameters of a port network, shaped as
    ``port_flat`` reads them."""

    def __init__(self, net, n):
        self.params = net.params[:n]


def test_transfer_n_out_replace_matches_jax():
    jbase = _mlp()
    base = port_of(jbase)
    jnew = jtl.TransferLearning.Builder(jbase).n_out_replace(1, 12).build()
    new = tl.TransferLearning.Builder(base).n_out_replace(1, 12).build()
    assert new.layers[1].n_out == 12 and new.layers[2].n_in == 12
    _close([jnew.params[0]], _Head(new, 1), rtol=0, atol=0)
    new.set_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnew.params), device="cpu"))
    xq = np.random.RandomState(3).rand(3, 4).astype(np.float32)
    out = new.output(xq)
    assert tuple(out.shape) == (3, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnew.output(xq)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["mlp", "lstm"])
def test_transfer_helper_featurize_and_fit_featurized_match_jax(kind):
    if kind == "mlp":
        x, y = load_iris()
        jbase, freeze, steps = _mlp(), 1, 20
    else:
        x, y = _seq(1)
        jbase, freeze, steps = _lstm(), 0, 6
    jfrozen = jtl.TransferLearning.Builder(jbase) \
        .set_feature_extractor(freeze).build()
    frozen = tl.TransferLearning.Builder(port_of(jbase)) \
        .set_feature_extractor(freeze).build()
    _close(jfrozen.params, frozen, rtol=0, atol=0)
    jh, h = jtl.TransferLearningHelper(jfrozen), \
        tl.TransferLearningHelper(frozen)
    jf, f = jh.featurize(JDataSet(x, y)), h.featurize(DataSet(x, y))
    np.testing.assert_allclose(f.features, np.asarray(jf.features),
                               rtol=1e-5, atol=1e-6)
    front = _snap(frozen)[:freeze + 1]
    s_before = frozen.score(DataSet(x, y))
    for _ in range(steps):
        jh.fit_featurized(jf)
        h.fit_featurized(f)
    _close(jh.unfrozen_mln().params, h.unfrozen_mln())
    _close(jfrozen.params, frozen)
    assert _bitwise(frozen.params[:freeze + 1], front)
    assert frozen.score(DataSet(x, y)) < s_before
    np.testing.assert_allclose(frozen.score(DataSet(x, y)),
                               jfrozen.score(JDataSet(x, y)), rtol=1e-5)


def test_transfer_frozen_lstm_fine_tune_matches_jax():
    """2 x LSTM(8): layer 0 frozen, a new updater; the frozen LSTM runs in
    inference mode, the live one trains, the pair is not fused."""
    x, y = _seq(2)
    jbase = _lstm()
    base = port_of(jbase)
    source = _snap(base)

    def build(m, b, Upd):
        return (m.TransferLearning.Builder(b)
                .fine_tune_configuration(m.FineTuneConfiguration(
                    updater=Upd(0.1)))
                .set_feature_extractor(0).build())
    jnew, new = build(jtl, jbase, JSgd), build(tl, base, Sgd)
    for _ in range(4):
        jnew.fit(JDataSet(x, y))
        new.fit(DataSet(x, y))
    _close(jnew.params, new)
    assert _bitwise([new.params[0]], [source[0]])
    assert _bitwise(base.params, source)


# ------------------------------------------------------------ the aliasing

@pytest.mark.parametrize("freeze", [None, 0])
def test_transfer_builder_clones_the_source_parameters(freeze):
    """A fine-tune of the new net leaves the source net's tensors bit for
    bit, and training the source leaves the new net's. A frozen layer has
    no updater, so without the clone it would keep the source's tensors,
    which are views of the source's fused-update buffers."""
    x, y = load_iris()
    base = port_of(_mlp())
    source = _snap(base)
    b = tl.TransferLearning.Builder(base)
    new = (b if freeze is None else b.set_feature_extractor(freeze)).build()
    for _ in range(3):
        new.fit(x, y)
    assert _bitwise(base.params, source)
    assert not _bitwise(new.params, source)
    snap = _snap(new)
    for _ in range(3):
        base.fit(x, y)
    assert _bitwise(new.params, snap)
    assert not _bitwise(base.params, source)


def test_helper_writes_the_tail_back_into_the_full_net():
    """After ``fit_featurized`` the full net's own tensors hold the tail,
    its warmed serving engine serves them, and its next ``fit`` step
    starts from them."""
    x, y = load_iris()
    net = tl.TransferLearning.Builder(port_of(_mlp())) \
        .set_feature_extractor(0).build()
    eng = net.serving_engine()
    eng.warmup((4,), max_batch=256)
    h = tl.TransferLearningHelper(net)
    f = h.featurize(DataSet(x, y))
    tensors = [dict(p) for p in net.params]
    for _ in range(3):
        h.fit_featurized(f)
    assert all(net.params[i][k] is tensors[i][k] for i in range(3)
               for k in tensors[i]), "the write-back rebound a tensor"
    assert _bitwise(net.params[1:], h.unfrozen_mln().params)
    want = net._forward(net.params, torch.from_numpy(x))[0]
    assert torch.equal(net.output(x), want), "engine serves stale weights"
    twin = port_of(_mlp())
    twin = tl.TransferLearning.Builder(twin).set_feature_extractor(0).build()
    twin.set_params(_snap(net))
    before = _snap(net)
    net.fit(x, y)
    twin.fit(x, y)
    assert _bitwise(net.params, twin.params)
    assert not _bitwise(net.params[1:], before[1:])


def test_solver_result_reaches_fit_and_a_served_engine():
    """A solver's parameters are copied into the network's tensors: the
    warmed engine follows them and the next ``fit`` step starts there."""
    x, y = _toy_data()
    net = port_of(_toy())
    eng = net.serving_engine()
    eng.warmup((4,), max_batch=64)
    tensors = [dict(p) for p in net.params]
    sol.LBFGS(max_iterations=5).optimize(net, DataSet(x, y))
    assert all(net.params[i][k] is tensors[i][k] for i in range(2)
               for k in tensors[i])
    want = net._forward(net.params, torch.from_numpy(x))[0]
    assert torch.equal(net.output(x), want), "engine serves stale weights"
    twin = port_of(_toy())
    twin.set_params(_snap(net))
    net.fit(x, y)
    twin.fit(x, y)
    assert _bitwise(net.params, twin.params)


# ------------------------------------------------------------------ solvers

@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "line_gradient_descent"])
def test_solver_history_matches_jax(algo):
    x, y = _toy_data()
    jnet = _toy()
    net = port_of(jnet)
    js = jsol._ALGOS[algo](max_iterations=5)
    ps = sol._ALGOS[algo](max_iterations=5)
    jconv = js.optimize(jnet, JDataSet(x, y))
    conv = ps.optimize(net, DataSet(x, y))
    assert conv == jconv
    assert len(ps.score_history) == len(js.score_history)
    np.testing.assert_allclose(ps.score_history[:3], js.score_history[:3],
                               rtol=HIST_RTOL)
    assert all(b <= a for a, b in zip(ps.score_history,
                                      ps.score_history[1:]))
    _close(jnet.params, net, rtol=1e-3, atol=1e-5)
    assert net.score(DataSet(x, y)) < ps.score_history[0]


def test_lbfgs_on_the_lstm_net_matches_jax():
    x, y = _seq(4)
    jnet = _lstm()
    net = port_of(jnet)
    js, ps = jsol.LBFGS(max_iterations=4), sol.LBFGS(max_iterations=4)
    assert ps.optimize(net, DataSet(x, y)) == \
        js.optimize(jnet, JDataSet(x, y))
    np.testing.assert_allclose(ps.score_history[:3], js.score_history[:3],
                               rtol=HIST_RTOL)


def test_solver_facade_sgd_calls_fit_and_full_batch_reduce_loss():
    x, y = _toy_data()
    jnet = _toy()
    net = port_of(jnet)
    assert sol.Solver(net, algorithm="sgd").optimize(DataSet(x, y)) is True
    jsol.Solver(jnet, algorithm="sgd").optimize(JDataSet(x, y))
    assert net.iteration == jnet.iteration == 1
    _close(jnet.params, net)
    before = net.score(DataSet(x, y))
    sol.Solver(net, algorithm="lbfgs", max_iterations=30).optimize(
        DataSet(x, y))
    assert net.score(DataSet(x, y)) < before * 0.7
    with pytest.raises(ValueError, match="unknown algorithm"):
        sol.Solver(net, algorithm="newton")


def test_line_search_satisfies_armijo():
    def vg(v):
        with torch.enable_grad():
            w = v.detach().requires_grad_(True)
            f = ((w - 2.0) ** 2).sum()
            (g,) = torch.autograd.grad(f, w)
        return f.detach(), g
    x = torch.zeros(5)
    f0, g0 = vg(x)
    step, f_new, x_new, _ = sol.BackTrackLineSearch().optimize(
        vg, x, float(f0), g0, -g0)
    assert step > 0 and f_new < float(f0)
    # an ascent direction is reset to steepest descent
    step, f_up, _, _ = sol.BackTrackLineSearch().optimize(
        vg, x, float(f0), g0, g0)
    assert step > 0 and f_up < float(f0)
