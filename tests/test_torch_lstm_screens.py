"""The shape half of the port's LSTM screens (``LSTM.fused_supported`` and
``lstm_pair_fusable``) and the plan query behind it,
``lstm_cuda.has_plan``, on the CPU.

On the card a screen asks ``has_plan`` for every kernel its path launches
-- K1 (``lstm_fwd``) for a single layer's inference, K2 and K3
(``lstm_fwd_train``, ``lstm_bwd``) under autograd; K4 (``lstm2_fwd``) or
K4-train and K3 for a pair -- and where one has no launch plan a single
layer runs its own loop and a pair runs as two single layers, each
screened again, as the JAX package's pair does. Here ``has_plan`` is
stubbed (the real one answers True on the CPU, whose plain versions take
every shape), so the calls and the fallback can be seen without a card. A
pair refused by the stub is held against the JAX MultiLayerNetwork at 1e-5
(output and step-1 gradients, relative to their largest magnitude), as
tests/test_torch_training.py holds the fused pair.

``has_plan`` itself is driven through a fake library: False only for the
plan query's "no launch plan" code, a raise for any other code and for a
failed build, one query per shape.

The screens on the card, at the shapes that need them, are in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam

from deeplearning4j_tpu_torch import MultiLayerNetwork, ops, params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import LSTM
from deeplearning4j_tpu_torch.nn.layers.rnn import lstm_pair_fusable
from deeplearning4j_tpu_torch.ops import lstm_cuda

V, H, T, B = 9, 16, 8, 4
TOL = 1e-5
SINGLE = {False: ["lstm_fwd"], True: ["lstm_fwd_train", "lstm_bwd"]}
PAIR = {False: ["lstm2_fwd"], True: ["lstm2_fwd_train", "lstm_bwd"]}


class Asked:
    """A stub ``has_plan``: records each question and answers False for
    the entries in ``refuse``."""

    def __init__(self, refuse=()):
        self.refuse, self.calls = set(refuse), []

    def __call__(self, entry, B, H, dtype, device):
        self.calls.append((entry, B, H, dtype, torch.device(device).type))
        return entry not in self.refuse

    def entries(self):
        return [c[0] for c in self.calls]


def _layer(n_in=V, n_out=H):
    layer = LSTM(n_in=n_in, n_out=n_out, activation="tanh")
    gen = torch.Generator().manual_seed(0)
    return layer, layer.init(gen)


@pytest.mark.parametrize("recording", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_screen_asks_every_kernel_the_path_launches(recording, dtype,
                                                           monkeypatch):
    asked = Asked()
    monkeypatch.setattr(lstm_cuda, "has_plan", asked)
    layer, _ = _layer()
    card = torch.device("cuda", 0)
    assert layer.fused_supported(dtype, 32, card, recording)
    assert asked.calls == [(e, 32, H, dtype, "cuda")
                           for e in SINGLE[recording]]


@pytest.mark.parametrize("refused", ["lstm_fwd", "lstm_fwd_train", "lstm_bwd"])
@pytest.mark.parametrize("recording", [False, True])
def test_single_screen_refuses_a_shape_without_a_plan(refused, recording,
                                                      monkeypatch):
    monkeypatch.setattr(lstm_cuda, "has_plan", Asked({refused}))
    layer, _ = _layer()
    want = refused not in SINGLE[recording]
    assert layer.fused_supported(torch.float32, 32, torch.device("cuda"),
                                 recording) is want


def test_configuration_half_asks_nothing(monkeypatch):
    """A configuration the kernel does not compute is refused before any
    plan is asked."""
    asked = Asked()
    monkeypatch.setattr(lstm_cuda, "has_plan", asked)
    layer, _ = _layer()
    layer.gate_activation = "hardsigmoid"
    assert not layer.fused_supported(torch.float32, 8, torch.device("cuda"),
                                     False)
    assert not layer.fused_supported(torch.float64, 8, torch.device("cuda"),
                                     False)
    assert asked.calls == []


@pytest.mark.parametrize("recording", [False, True])
def test_pair_screen_asks_both_layers_then_the_wavefront(recording,
                                                         monkeypatch):
    asked = Asked()
    monkeypatch.setattr(lstm_cuda, "has_plan", asked)
    (l1, p1), (l2, p2) = _layer(), _layer(H, H)
    x = torch.zeros(B, T, V)
    with torch.set_grad_enabled(recording):
        if not recording:
            p1 = {k: v.detach() for k, v in p1.items()}
            p2 = {k: v.detach() for k, v in p2.items()}
        else:
            p1 = {k: v.requires_grad_() for k, v in p1.items()}
        assert lstm_pair_fusable(l1, l2, p1, p2, x)
    assert asked.entries() == SINGLE[recording] * 2 + PAIR[recording]
    assert {c[1:] for c in asked.calls} == {(B, H, torch.float32, "cpu")}


def _jax_conf(seed=7):
    return (JaxNNC.builder().seed(seed).updater(JaxAdam(1e-3))
            .weight_init("xavier").list()
            .layer(JaxLSTM(n_out=H, activation="tanh"))
            .layer(JaxLSTM(n_out=H, activation="tanh"))
            .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V)).build())


def _port_of(jnet):
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    return net.set_params(params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params],
        device="cpu"))


def _batch(seed):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    return eye[r.randint(0, V, (B, T))], eye[r.randint(0, V, (B, T))]


class Calls:
    """Counts the calls of one ``ops`` entry, passing them on."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *args):
        self.n += 1
        return self.fn(*args)


@pytest.mark.parametrize("refused,launched", [
    # (ops.lstm2_sequence calls, ops.lstm_sequence calls): output, training
    (["lstm2_fwd", "lstm2_fwd_train"], ((0, 2), (0, 2))),
    (["lstm_bwd"], ((1, 0), (0, 0)))])
def test_a_pair_without_a_plan_runs_as_two_screened_layers(refused, launched,
                                                           monkeypatch):
    """Refusing the wavefront kernels sends the pair through two single
    layers (two ``ops.lstm_sequence`` calls, no ``ops.lstm2_sequence``),
    each screened again. Refusing K3 leaves inference on the wavefront and
    sends training through the layers' own loops (no kernel at all), since
    every training path runs K3. Either way the network computes the JAX
    MultiLayerNetwork's function."""
    asked = Asked(refused)
    monkeypatch.setattr(lstm_cuda, "has_plan", asked)
    single = Calls(ops.lstm_sequence)
    pair = Calls(ops.lstm2_sequence)
    monkeypatch.setattr(ops, "lstm_sequence", single)
    monkeypatch.setattr(ops, "lstm2_sequence", pair)
    jnet = JaxMLN(_jax_conf()).init()
    net = _port_of(jnet)
    x, y = _batch(0)

    out = net.output(x, bucketed=False)
    ref = np.asarray(jnet.output(jnp.asarray(x), bucketed=False))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    assert (pair.n, single.n) == launched[0]
    assert asked.entries().count("lstm2_fwd") == 1

    pair.n = single.n = 0
    (jl, _), jg = jax.value_and_grad(jnet._loss, has_aux=True)(
        jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y), None, None,
        None)
    grads, score = net.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(score, float(jl), rtol=1e-6)
    for a, b in zip(jg, grads):
        for k in a:
            ref = np.asarray(a[k])
            assert np.abs(b[k].numpy() - ref).max() <= TOL * np.abs(ref).max()
    assert (pair.n, single.n) == launched[1]


class FakeLib:
    """A kernel library whose plan queries return ``rc``, counting them."""

    def __init__(self, rc):
        self.rc, self.queries = rc, []

    def _query(self, name):
        def query(*args):
            self.queries.append((name, args[:-1]))
            return self.rc
        return query

    def __getattr__(self, name):
        if name.endswith("_plan"):
            return self._query(name)
        raise AttributeError(name)

    @staticmethod
    def lstm_error(rc):
        return b"no launch plan fits" if rc == -2 else b"out of memory"


@pytest.fixture
def fresh_plans(monkeypatch):
    monkeypatch.setattr(lstm_cuda, "_HAS_PLAN", {})


@pytest.mark.parametrize("entry,query,lead", [
    ("lstm_fwd", "lstm_fwd_plan", (0,)),
    ("lstm_fwd_train", "lstm_fwd_plan", (1,)),
    ("lstm2_fwd", "lstm2_fwd_plan", (0,)),
    ("lstm2_fwd_train", "lstm2_fwd_plan", (1,)),
    ("lstm_bwd", "lstm_bwd_plan", ())])
@pytest.mark.parametrize("rc,want", [(0, True), (-2, False)])
def test_has_plan_asks_the_query_once_per_shape(entry, query, lead, rc, want,
                                                fresh_plans, monkeypatch):
    lib = FakeLib(rc)
    monkeypatch.setattr(lstm_cuda, "_lib", lambda stem: lib)
    card = torch.device("cuda", 0)
    for _ in range(3):
        assert lstm_cuda.has_plan(entry, 32, 600, torch.bfloat16, card) \
            is want
    assert lib.queries == [(query, lead + (32, 600, 1, 0))]
    lstm_cuda.has_plan(entry, 16, 600, torch.bfloat16, card)
    assert len(lib.queries) == 2


def test_has_plan_raises_for_any_other_error(fresh_plans, monkeypatch):
    """A CUDA error (here cudaErrorMemoryAllocation, 2) is not "no plan"."""
    monkeypatch.setattr(lstm_cuda, "_lib", lambda stem: FakeLib(2))
    with pytest.raises(RuntimeError, match="lstm_fwd_plan failed: out of "
                                           "memory"):
        lstm_cuda.has_plan("lstm_fwd", 32, 2048, torch.float32,
                           torch.device("cuda"))
    assert lstm_cuda._HAS_PLAN == {}


def test_has_plan_raises_when_the_build_fails(fresh_plans, monkeypatch):
    def broken(stem):
        raise RuntimeError("nvcc failed for lstm_fwd")
    monkeypatch.setattr(lstm_cuda, "_lib", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lstm_cuda.has_plan("lstm_fwd", 32, 2048, torch.float32,
                           torch.device("cuda"))


def test_has_plan_on_the_cpu_takes_every_shape(fresh_plans, monkeypatch):
    def unused(stem):
        raise AssertionError("the CPU asks no kernel library")
    monkeypatch.setattr(lstm_cuda, "_lib", unused)
    assert lstm_cuda.has_plan("lstm2_fwd", 1, 4096, torch.float32, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_cuda.has_plan("lstm_fwd", 1, 8, torch.float32,
                           torch.device("meta"))


def test_wide_layer_on_the_cpu_still_runs_the_plain_kernel():
    """LSTM(2048) has no plan on an H100, but the CPU's plain version takes
    it: the screen passes and the layer agrees with its own loop."""
    layer, params = _layer(4, 2048)
    x = torch.tensor(np.random.RandomState(1).randn(2, 3, 4)
                     .astype(np.float32))
    with torch.no_grad():
        fused = layer.apply(params, x)
        h = c = torch.zeros(2, 2048)
        gate_in = (x.reshape(6, 4) @ params["W"] + params["b"]).reshape(
            2, 3, -1)
        loop = []
        for t in range(3):
            h, c = layer._cell(params, gate_in[:, t], h, c)
            loop.append(h)
    np.testing.assert_allclose(fused.numpy(), torch.stack(loop, 1).numpy(),
                               rtol=0, atol=TOL)
