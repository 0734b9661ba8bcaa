"""The port's train step: the executor (training-precision policy, steps
through CUDA graphs), the fused update inside both containers against the
per-layer loop, and, on the card, captured steps against the eager step.

On the CPU (numpy-seeded inputs, small models: 2 x LSTM(16) at T=8 and
tBPTT chunks of 3; TinyTransformer d_model 32, 4 heads, T=16):

- every fit path of both containers with the fused update equals the
  per-layer loop bit for bit (parameters, updater state under the same
  keys, scores), and so does ``apply_external_updates`` fed a fit step's
  own gradients;
- a checkpoint written mid-training with the fused update loads into the
  flat buffers (in place) and the next step is the writer's;
- the bf16 train-precision policy keeps parameters and updater state
  float32 and the loss float32;
- ``StepGraphs`` warms up on a signature's first call, captures on its
  second and replays from then on (a stub executor stands for the card).

Marked ``cuda`` (they skip without a card, since a captured graph has no
CPU mode; on a machine with one: ``python -m pytest
tests/test_torch_train_step.py -q``; this file imports no JAX): from one
initial state, ten steps of each path captured against the eager step
(parameters within 1e-5 of max|p|, the losses too), the fused eager step
against the per-layer loop bit for bit, exact launch counts per step under
replay equal to the eager step's, one capture per signature, the bf16
policy against the CPU port (losses within 3e-2), and no fallback: a step
that synchronizes the host raises in its warm-up.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork,
                                      ops)
from deeplearning4j_tpu_torch import exec as ex
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                           MultiDataSet)
from deeplearning4j_tpu_torch.exec import executor as exmod
from deeplearning4j_tpu_torch.nn import fused_update as fu
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam, Nesterovs, Schedule
from deeplearning4j_tpu_torch.zoo import TinyTransformer

V, H, T, B = 9, 16, 8, 4
TV, TT, TB = 11, 16, 3
SMALL_TINY = dict(vocab_size=TV, n_layers=2, d_model=32, n_heads=4,
                  max_len=64)
CAPTURE_TOL, BF16_TOL = 1e-5, 3e-2


def _lstm_conf(tbptt=None, seed=7):
    lb = (NeuralNetConfiguration.builder().seed(seed)
          .updater(Adam(1e-2, schedule=Schedule(kind="exponential",
                                                 initial=1e-2,
                                                 decay_rate=0.9)))
          .weight_init("xavier")
          .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0)
          .list().layer(LSTM(n_out=H, activation="tanh"))
          .layer(LSTM(n_out=H, activation="tanh",
                      updater=Nesterovs(learning_rate=0.05)))
          .layer(RnnOutputLayer(n_out=V, activation="softmax", loss="mcxent"))
          .set_input_type(InputType.recurrent(V)))
    if tbptt:
        lb = lb.backprop_type("tbptt", tbptt, tbptt)
    return lb.build()


def _batches(seed, n, rows=B, t=T, v=V):
    r = np.random.RandomState(seed)
    eye = np.eye(v, dtype=np.float32)
    return [(eye[r.randint(0, v, (rows, t))], eye[r.randint(0, v, (rows, t))])
            for _ in range(n)]


def _twins(make, device="cpu"):
    """The same model twice from one initial state: fused update, and the
    per-layer loop."""
    nets = []
    for flag in (True, False):
        fu.set_fused_update(flag)
        try:
            nets.append(make(device))
        finally:
            fu.set_fused_update(None)
    return nets


def _mln(conf, device):
    return MultiLayerNetwork(conf, device=device).init()


def _tiny(device):
    return TinyTransformer(seed=3, **SMALL_TINY).init(device=device)


def _items(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


def _assert_bitwise(a, b):
    for (i, pa), (_, pb) in zip(_items(a.params), _items(b.params)):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), (i, k)
    for (i, oa), (_, ob) in zip(_items(a.opt_state), _items(b.opt_state)):
        assert sorted(oa) == sorted(ob), i
        for k in oa:
            assert oa[k].dtype == ob[k].dtype and torch.equal(oa[k], ob[k]), \
                (i, k)
    assert a.get_score() == b.get_score()
    assert a.iteration == b.iteration


def _fit_path(net, path, seed=0):
    """Drive one fit path of a container on seeded batches."""
    graph = isinstance(net, ComputationGraph)
    kw = dict(t=TT, v=TV, rows=TB) if graph else {}
    data = _batches(seed, 4, **kw)
    if path == "fit":
        for x, y in data:
            net.fit(x, y)
    elif path == "dataset":
        for x, y in data:
            net.fit(MultiDataSet([x], [y]) if graph else DataSet(x, y))
    elif path == "iterator":
        x = np.concatenate([a for a, _ in data])
        y = np.concatenate([b for _, b in data])
        net.fit(ListDataSetIterator(DataSet(x, y), 5), epochs=2)
    elif path == "fit_scan":
        net.fit_scan(np.stack([a for a, _ in data]),
                     np.stack([b for _, b in data]))
    return net


PATHS = [("mln", "fit"), ("mln", "dataset"), ("mln", "iterator"),
         ("mln", "fit_scan"), ("tbptt", "fit"), ("tbptt", "iterator"),
         ("graph", "fit"), ("graph", "dataset"), ("graph", "iterator"),
         ("graph", "fit_scan")]
MAKERS = {"mln": lambda d: _mln(_lstm_conf(), d),
          "tbptt": lambda d: _mln(_lstm_conf(tbptt=3), d),
          "graph": _tiny}


@pytest.mark.parametrize("model,path", PATHS)
def test_fused_fit_equals_the_per_layer_loop_bitwise(model, path):
    fused, loop = _twins(MAKERS[model])
    assert fused._fused is not None and loop._fused is None
    assert not fused._capture_steps          # the CPU runs the step eagerly
    _assert_bitwise(_fit_path(fused, path), _fit_path(loop, path))


@pytest.mark.parametrize("model", ["mln", "graph"])
def test_external_updates_equal_a_fit_step(model):
    """``apply_external_updates`` fed a step's own gradients is that step's
    update (the normalization included), bitwise."""
    a, b = MAKERS[model]("cpu"), MAKERS[model]("cpu")
    kw = dict(t=TT, v=TV, rows=TB) if model == "graph" else {}
    for x, y in _batches(1, 3, **kw):
        grads, _ = b.compute_gradient_and_score(x, y)
        a.fit(x, y)
        b.apply_external_updates(grads)
    b._score, b.iteration = a._score, a.iteration
    _assert_bitwise(a, b)


@pytest.mark.parametrize("model", ["mln", "tbptt", "graph"])
def test_checkpoint_mid_training_resumes_into_the_flat_buffers(model,
                                                               tmp_path):
    net = MAKERS[model]("cpu")
    _fit_path(net, "fit")
    path = tmp_path / "mid.zip"
    net.save(path)
    cls = ComputationGraph if model == "graph" else MultiLayerNetwork
    back = cls.load(path, device="cpu")
    views = [v.data_ptr() for _, p in _items(back.opt_state)
             for v in p.values() if v.is_floating_point()]
    _fit_path(net, "fit", seed=5)
    _fit_path(back, "fit", seed=5)
    # the state loaded in place: the fused plan still owns it
    assert views == [v.data_ptr() for _, p in _items(back.opt_state)
                     for v in p.values() if v.is_floating_point()]
    _assert_bitwise(net, back)


@pytest.mark.parametrize("model", ["mln", "graph"])
def test_bf16_policy_keeps_float32_storage(model):
    ex.set_executor(ex.Executor(train_precision="bf16"))
    try:
        net = MAKERS[model]("cpu")
        assert net._compute_dtype(True) == torch.bfloat16
        assert net._compute_dtype(False) is None
        _fit_path(net, "fit")
        loss = net._score
    finally:
        ex.set_executor(None)
    assert loss.dtype == torch.float32 and np.isfinite(net.get_score())
    for _, p in _items(net.params):
        assert all(v.dtype == torch.float32 for v in p.values())
    for _, o in _items(net.opt_state):
        assert all(v.dtype in (torch.float32, torch.int32)
                   for v in o.values())


def test_executor_reads_the_train_precision_like_jax(monkeypatch):
    monkeypatch.delenv("DL4JTPU_TRAIN_PRECISION", raising=False)
    assert ex.Executor().train_dtype is None
    assert ex.Executor(train_precision="bfloat16").train_precision == "bf16"
    monkeypatch.setenv("DL4JTPU_TRAIN_PRECISION", " BF16 ")
    assert ex.Executor().train_dtype == torch.bfloat16
    assert ex.Executor(train_precision="float32").train_dtype is None
    with pytest.raises(ValueError,
                       match="train_precision must be 'f32' or 'bf16', "
                             "got 'fp8'"):
        ex.Executor(train_precision="fp8")
    mine = ex.Executor()
    ex.set_executor(mine)
    try:
        assert ex.get_executor() is mine
    finally:
        ex.set_executor(None)
    # the next get_executor() builds a fresh default from the environment
    assert exmod._default_executor is None


def test_signature_names_shapes_dtypes_and_absent_arguments():
    x = torch.zeros(2, 3)
    a = exmod.signature((x, None, [(x, x), None]))
    assert a == exmod.signature((torch.ones(2, 3), None,
                                 [(x, torch.ones(2, 3)), None]))
    assert a != exmod.signature((x, x, [(x, x), None]))
    assert a != exmod.signature((x.double(), None, [(x, x), None]))
    assert a != exmod.signature((x[:1], None, [(x, x), None]))


def test_step_graphs_warm_up_then_capture_then_replay(monkeypatch):
    """The policy, with a stub standing for the card: each signature's
    first call runs eagerly as the warm-up, the second captures, later
    ones replay the same graph."""
    calls = []

    class Stub(ex.Executor):
        def warm_up(self, fn, device):
            calls.append("warm")
            return fn()

        def capture(self, fn, args, device, generator=None):
            calls.append("capture")

            def replay(*a):
                calls.append("replay")
                return fn(*a)
            return replay

    graphs = Stub().steps(lambda x, m: x * 2 if m is None else x + m)
    x = torch.ones(3)
    for _ in range(3):
        assert torch.equal(graphs(x, None), x * 2)
    graphs(x, x)
    graphs(x[:2], None)
    assert calls == ["warm", "capture", "replay", "replay", "warm", "warm"]
    assert graphs.captures == 1 and len(graphs.graphs) == 1


def test_replayed_launch_counts_add_and_subtract():
    ops.reset_launch_counts()
    ops.count_launch("k")
    ops.add_launch_counts({"k": 2, "j": 3})
    assert ops.launch_counts() == {"k": 3, "j": 3}
    ops.add_launch_counts({"k": -3})
    assert ops.launch_counts() == {"j": 3}
    ops.reset_launch_counts()


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a captured CUDA graph has no "
                    "CPU mode")
    return torch.device("cuda")


def _max_rel(a, b):
    err = max((pa[k].float() - pb[k].float()).abs().max().item()
              for (_, pa), (_, pb) in zip(_items(a.params), _items(b.params))
              for k in pa)
    scale = max(p[k].abs().max().item() for _, p in _items(b.params)
                for k in p)
    return err / scale


def _steps(net, model, n, seed=0):
    kw = dict(t=TT, v=TV, rows=TB) if model == "graph" else {}
    scores, counts = [], []
    for x, y in _batches(seed, n, **kw):
        ops.reset_launch_counts()
        net.fit(x, y)
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
        scores.append(net.get_score())
    return scores, counts


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mln", "tbptt", "graph"])
def test_captured_steps_replay_the_eager_step(cuda_device, model):
    eager, captured = MAKERS[model]("cuda"), MAKERS[model]("cuda")
    eager._capture_steps = False
    s_e, c_e = _steps(eager, model, 10)
    s_c, c_c = _steps(captured, model, 10)
    assert _max_rel(captured, eager) <= CAPTURE_TOL
    np.testing.assert_allclose(s_c, s_e, rtol=CAPTURE_TOL)
    # every step launched the eager step's kernels, replays included
    assert c_c == c_e and all(c == c_e[0] for c in c_e) and c_e[0]
    # tBPTT (T=8 in chunks of 3): a graph for the first chunk (no
    # carries), one for the full chunks after it, one for the last (T=2)
    assert captured._capture_count == (3 if model == "tbptt" else 1)
    assert len(captured._steps.graphs) == captured._capture_count


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mln", "tbptt", "graph"])
def test_fused_eager_step_equals_the_loop_on_the_card(cuda_device, model):
    fused, loop = _twins(MAKERS[model], "cuda")
    fused._capture_steps = False
    _steps(fused, model, 10)
    _steps(loop, model, 10)
    _assert_bitwise(fused, loop)


@pytest.mark.cuda
def test_external_updates_replay_their_own_graph(cuda_device):
    a, b = _tiny("cuda"), _tiny("cuda")
    a._capture_steps = False
    rs = np.random.RandomState(4)
    for _ in range(5):
        g = {n: {k: torch.tensor(rs.randn(*v.shape).astype(np.float32))
                 for k, v in p.items()} for n, p in a.params.items()}
        a.apply_external_updates(g)
        b.apply_external_updates(g)
    assert _max_rel(b, a) <= CAPTURE_TOL
    assert b._capture_count == 1 and b._updates.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["mln", "graph"])
def test_bf16_policy_on_the_card_matches_the_cpu_port(cuda_device, model):
    ex.set_executor(ex.Executor(train_precision="bf16"))
    try:
        card, cpu = MAKERS[model]("cuda"), MAKERS[model]("cpu")
        s_card, _ = _steps(card, model, 3)
        s_cpu = [net.get_score() for net in
                 (cpu.fit(x, y) for x, y in _batches(
                     0, 3, **(dict(t=TT, v=TV, rows=TB)
                              if model == "graph" else {})))]
    finally:
        ex.set_executor(None)
    np.testing.assert_allclose(s_card, s_cpu, rtol=BF16_TOL)
    for _, p in _items(card.params):
        assert all(v.dtype == torch.float32 for v in p.values())


@pytest.mark.cuda
def test_a_step_that_syncs_the_host_raises_in_its_warm_up(cuda_device):
    graphs = ex.Executor().steps(lambda x: float(x.sum()))
    with pytest.raises(RuntimeError):
        graphs(torch.ones(4, device=cuda_device))
