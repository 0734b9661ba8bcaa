"""Tensor parallelism through the default mesh: a container's own ``fit``
and ``fit_scan``, its bucketed ``output()`` and the decode engine under
``DL4JTPU_MESH=model=2`` over eight CPU slots (a (data 4, model 2)
mesh), held against the port on one slot and against the JAX package's
container on a ``model_parallel=2`` executor over the eight forced host
devices (the ``mesh8`` devices, tests/conftest.py).

- Cases: the dense net of the JAX TP tests, TinyTransformer (d_model 32,
  4 heads, 2 blocks) and the LSTM net of the JAX executor tests
  (tests/test_exec.py).
- ``fit`` in every form it takes (arrays, a DataSet, a MultiDataSet, an
  iterator whose same-shape batches run as a ``fit_scan`` chunk) and
  ``fit_scan``: rtol 1e-4 / atol 1e-5, the JAX TP tests' tolerances.
- The shard decision: rows split over the data axis where the
  executor's ``shardable_rows`` holds (``DL4JTPU_MIN_ROWS_PER_SHARD``),
  as JAX's step takes its sharded program there.
- The bucketed ``output()``: rtol 1e-5 / atol 1e-6. Greedy dense and
  paged decode: the tokens of the unsplit engine and of the JAX engine,
  except after a near-tie (the reference's top-2 probability gap at the
  first differing step at most 1e-4).
- K5-K9 counted through the launch counter at CPU shapes: each plain
  version stands in for its kernel's launch (``ops.count_launch``): 4 K5,
  K6 and K7 a TinyTransformer step (2 blocks x 2 model shards), 4 K5 a
  forward, 4 K8 / K9 a decode step.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JaxMulti
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.exec import Executor as JaxExecutor
from deeplearning4j_tpu.exec import build_mesh as jax_build_mesh
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import LSTM as JaxLSTM
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.exec import Executor, build_mesh
from deeplearning4j_tpu_torch.exec import executor as ex_mod
from deeplearning4j_tpu_torch.exec import mesh as mesh_mod
from deeplearning4j_tpu_torch.ops import attention_cuda
from deeplearning4j_tpu_torch.parallel import distributed
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.serving.spec import SpecConfig
from test_torch_regularised_training import port_of
from test_torch_tensor_parallel import (jax_tp_net, jax_tt, leaves,
                                        tp_data, tt_data)

FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
TIE_MARGIN = 1e-4
V = 13                                   # the LSTM net's vocabulary
BS = 16


@pytest.fixture
def tp_mesh(monkeypatch):
    """``DL4JTPU_MESH=model=2`` over ``DL4JTPU_SLOTS=8`` CPU slots, with
    fresh process defaults; the shard floor at the JAX default (16)."""
    monkeypatch.setattr(distributed, "process_device",
                        lambda: torch.device("cpu"))
    monkeypatch.setenv("DL4JTPU_MESH", "model=2")
    monkeypatch.setenv("DL4JTPU_SLOTS", "8")
    monkeypatch.delenv("DL4JTPU_MIN_ROWS_PER_SHARD", raising=False)
    monkeypatch.setattr(mesh_mod, "_default_mesh", None)
    monkeypatch.setattr(ex_mod, "_default_executor", None)
    return monkeypatch


@pytest.fixture
def launches(monkeypatch):
    """Each kernel's plain version (K5-K7) or wrapper (K8, K9) counted as
    its launch."""
    def spy(mod, fn, entry):
        real = getattr(mod, fn)

        def counted(*a, **kw):
            ops.count_launch(entry)
            return real(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)
    spy(attention_cuda, "flash_attention_fwd_plain", "flash_attn_fwd")
    spy(attention_cuda, "flash_attention_dq_plain", "flash_attn_dq")
    spy(attention_cuda, "flash_attention_dkv_plain", "flash_attn_dkv")
    # the decode wrappers themselves: K9's plain version runs K8's
    spy(ops, "flash_decode_step", "flash_decode")
    spy(ops, "flash_decode_step_paged", "flash_decode_paged")
    ops.reset_launch_counts()
    return ops


def one_slot(net):
    net._exec = Executor(build_mesh(["cpu"]))
    return net


def jax_tp(jnet, min_rows=None):
    jnet._exec = JaxExecutor(jax_build_mesh(model_parallel=2),
                             min_rows_per_shard=min_rows)
    return jnet


def jax_lstm():
    conf = (JaxConf.builder().seed(7).updater(JaxAdam(1e-2))
            .weight_init("xavier").list()
            .layer(JaxLSTM(n_out=16, activation="tanh"))
            .layer(JaxRnnOut(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.recurrent(V)).build())
    return JaxMLN(conf).init()


def lstm_data(n=64, T=8):
    rs = np.random.RandomState(5)
    ids = rs.randint(0, V, size=(n, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


CASES = {"dense": (jax_tp_net, lambda: tp_data(64)),
         "tiny": (jax_tt, lambda: tt_data(64)),
         "lstm": (jax_lstm, lstm_data)}


def fit_every_form(net, x, y, graph, jax=False):
    """Two batches one at a time (arrays, then a DataSet or a
    MultiDataSet), then two through an iterator (one fit_scan chunk)."""
    DS, LI, MD = ((JaxDataSet, JaxListIterator, JaxMulti) if jax
                  else (DataSet, ListDataSetIterator, MultiDataSet))
    net.fit(x[:BS], y[:BS])
    net.fit(MD([x[BS:2 * BS]], [y[BS:2 * BS]]) if graph
            else DS(x[BS:2 * BS], y[BS:2 * BS]))
    net.fit(LI(DS(x[2 * BS:], y[2 * BS:]), BS))
    return net


def assert_params(got, want, rtol=FIT_RTOL, atol=FIT_ATOL):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=str(k))


@pytest.mark.mesh8
@pytest.mark.parametrize("case", list(CASES))
def test_fit_in_every_form_matches_jax_and_one_slot(tp_mesh, case):
    make, data = CASES[case]
    x, y = data()
    jnet = make()
    net, ref = port_of(jnet), one_slot(port_of(jnet))
    graph = isinstance(net.params, dict)
    fit_every_form(net, x, y, graph)
    fit_every_form(ref, x, y, graph)
    fit_every_form(jax_tp(jnet), x, y, graph, jax=True)
    assert net._executor.model_size == 2
    assert net.iteration == ref.iteration == 4
    # 16 rows over data 4 is 4 a data slot, under the floor of 16
    assert net.tp_routes == {"whole": 4}
    assert_params(net.params, ref.params)
    assert_params(net.params, jnet.params)
    np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                               rtol=FIT_RTOL, atol=FIT_ATOL)


@pytest.mark.mesh8
@pytest.mark.parametrize("min_rows", [16, 2])
def test_the_shard_route_follows_shardable_rows(tp_mesh, min_rows):
    """JAX's step takes its sharded program where ``shardable_rows``
    holds; the port's step counts the same route, and both land on one
    slot's parameters."""
    tp_mesh.setenv("DL4JTPU_MIN_ROWS_PER_SHARD", str(min_rows))
    x, y = tp_data(64)
    jnet = jax_tp(jax_tp_net(), min_rows)
    net, ref = port_of(jnet), one_slot(port_of(jnet))
    xs, ys = x.reshape(4, BS, 8), y.reshape(4, BS, 4)
    for k in range(2):
        for n in (net, ref, jnet):
            n.fit(DataSet(xs[k], ys[k]) if n is not jnet
                  else JaxDataSet(xs[k], ys[k]))
    for n in (net, ref, jnet):
        n.fit_scan(xs[2:], ys[2:])
    assert net._executor.min_rows == min_rows
    sharded = net._executor.shardable_rows(BS)
    assert sharded == (min_rows == 2)
    assert net.tp_routes == {"data" if sharded else "whole": 4}
    jstep = jnet._train_step[next(iter(jnet._train_step))]
    assert set(jstep._exec_cache) == {sharded}
    assert_params(net.params, ref.params)
    assert_params(net.params, jnet.params)


def test_set_params_between_two_fits_reloads_the_shards(tp_mesh):
    x, y = tp_data(64)
    net, ref = port_of(jax_tp_net()), one_slot(port_of(jax_tp_net()))
    other = port_of(jax_tp_net())
    for n in (net, ref):
        n.fit(DataSet(x[:BS], y[:BS]))
    form = net._tp_runner._tp
    with torch.no_grad():
        new = [{k: v * 0.5 for k, v in p.items()} for p in other.params]
    for n in (net, ref):
        n.set_params(new)
        n.fit(DataSet(x[BS:2 * BS], y[BS:2 * BS]))
    assert net._tp_runner._tp is not form       # rebuilt, not stale
    assert_params(net.params, ref.params)
    # a move from outside the fit path (a restore writes in place)
    with torch.no_grad():
        for n in (net, ref):
            n.params[0]["W"].mul_(0.75)
            n._params_version += 1
    for n in (net, ref):
        n.fit(DataSet(x[2 * BS:3 * BS], y[2 * BS:3 * BS]))
    assert_params(net.params, ref.params)


@pytest.mark.mesh8
def test_tinytransformer_steps_and_forwards_count_their_kernels(
        tp_mesh, launches):
    """One TP step: K5, K6 and K7 once a block and model shard, over the
    shard's B*H/2 heads; the bucketed forward 4 K5 over shard weights;
    the output within 1e-5 of one slot's and the JAX TP container's, and
    again after a swap (written into the shards in place)."""
    jnet = jax_tt()
    net, ref = port_of(jnet), one_slot(port_of(jnet))
    x, y = tt_data(64)
    net.fit(DataSet(x[:BS], y[:BS]))
    assert launches.launch_counts() == {"flash_attn_fwd": 4,
                                        "flash_attn_dq": 4,
                                        "flash_attn_dkv": 4}
    ref.fit(DataSet(x[:BS], y[:BS]))
    jnet = jax_tp(jnet)
    jnet.fit(JaxDataSet(x[:BS], y[:BS]))
    launches.reset_launch_counts()
    got = net.output(x[BS:BS + 5]).numpy()
    assert launches.launch_counts() == {"flash_attn_fwd": 4}
    eng = net.serving_engine()
    assert eng._weights_set.form is not None
    assert set(eng._weights_set.params["b0_attn"]) >= {"Wq@0", "Wq@1",
                                                       "Wo@0", "bo"}
    np.testing.assert_allclose(got, ref.output(x[BS:BS + 5]).numpy(),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x[BS:BS + 5])),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    ptrs = {k: v.data_ptr() for k, v in
            eng._weights_set.params["b0_attn"].items()}
    fresh = port_of(jax_tt())
    eng.swap_weights(fresh.params)
    assert ptrs == {k: v.data_ptr() for k, v in
                    eng._weights_set.params["b0_attn"].items()}
    np.testing.assert_allclose(
        eng.predict(x[:5]).numpy(),
        one_slot(fresh).output(x[:5], bucketed=False).numpy(),
        rtol=OUT_RTOL, atol=OUT_ATOL)


def _first_tie(model, prompt, got, want):
    """The reference's top-2 probability gap where ``got`` first leaves
    ``want`` (0 when they agree)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            seq = list(prompt) + list(want[:i])
            x = np.eye(16, dtype=np.float32)[seq][None]
            p = np.sort(np.asarray(model.output(x, bucketed=False),
                                   np.float32)[0, -1])
            return float(p[-1] - p[-2])
    return 0.0


@pytest.mark.mesh8
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_greedy_decode_over_head_shards(tp_mesh, launches, kv):
    """K8 / K9 once a layer and model shard a step, over the shard's
    (S, C, H/2, Dh) cache or pool; the prefix cache and chunked prefill
    on the paged engine; one program; the greedy tokens of the unsplit
    engine and of the JAX engine on a TP executor."""
    jnet = jax_tt()
    net, ref = port_of(jnet), one_slot(port_of(jnet))
    kw = dict(slots=4, max_len=32, kv=kv)
    if kv == "paged":
        kw.update(kv_block_size=8, chunk_tokens=4)
    rs = np.random.RandomState(2)
    prompts = [list(rs.randint(0, 16, n)) for n in (3, 9, 9)]
    prompts[2][:8] = prompts[1][:8]          # a shared first block
    eng = DecodeEngine(net, **kw).start()
    launches.reset_launch_counts()            # after warmup's inert calls
    try:
        got = [eng.generate(p, 8)["tokens"] for p in prompts]
        stats = eng.stats()
        state = eng._dstate["b0_attn"]
    finally:
        eng.stop()
    kernel = "flash_decode" if kv == "dense" else "flash_decode_paged"
    assert launches.launch_counts() == {kernel: 4 * stats["steps"]}
    key = "k" if kv == "dense" else "pk"
    lead = 4 if kv == "dense" else eng._pool.num_blocks
    assert [tuple(t.shape) for t in state[key]] == \
        [(lead, 32 if kv == "dense" else 8, 2, 8)] * 2
    assert stats["model_parallel"]["kv_split"] == "heads"
    # JAX's GSPMD spec: Dh over the model axis; 4 slots give each of the
    # 4 data slots one, under the floor of 2, so the rows stay whole
    assert stats["model_parallel"]["jax_slot_spec"]["b0_attn"][key] == \
        [(None, None, None, "model")] * 2
    assert eng.trace_count == 1
    if kv == "paged":
        assert stats["kv"]["prefix_hits"] >= 1
        assert stats["kv"]["prefill_chunks"] >= 1
    reng = DecodeEngine(ref, **kw).start()
    jeng = JaxDecode(jax_tp(jnet), **kw).start()
    try:
        want = [reng.generate(p, 8)["tokens"] for p in prompts]
        jwant = [jeng.generate(p, 8)["tokens"] for p in prompts]
    finally:
        reng.stop()
        jeng.stop()
    for p, g, w, jw in zip(prompts, got, want, jwant):
        assert _first_tie(ref, p, g, w) <= TIE_MARGIN, (p, g, w)
        assert _first_tie(ref, p, g, jw) <= TIE_MARGIN, (p, g, jw)


def test_a_decode_engine_follows_the_fit_and_swaps_its_shards(tp_mesh):
    """A TP decode engine follows its model's TP ``fit`` (the gathered
    parameters split into its shard set in place) until a swap, which
    writes the shards in place too: in both, the tokens of the unsplit
    path over the same weights, and no new program."""
    from deeplearning4j_tpu_torch.serving.decode import generate_naive
    net = port_of(jax_tt())
    x, y = tt_data(16)
    prompt = [1, 2, 3]

    def unsplit(params):
        ref = one_slot(port_of(jax_tt()))
        ref.set_params({n: {k: v.detach().clone() for k, v in p.items()}
                        for n, p in params.items()})
        return ref
    eng = DecodeEngine(net, 2, 32).start()
    ptrs = {k: v.data_ptr() for k, v in eng._params["b0_attn"].items()}
    try:
        net.fit(DataSet(x, y))
        fitted = eng.generate(prompt, 6)["tokens"]
        assert torch.equal(eng._params["b0_attn"]["Wq@1"],
                           net.params["b0_attn"]["Wq"][:, 16:])
        ref = unsplit(net.params)
        with torch.no_grad():
            new = {n: {k: v * 0.9 for k, v in p.items()}
                   for n, p in ref.params.items()}
        eng.swap_weights(new)
        swapped = eng.generate(prompt, 6)["tokens"]
    finally:
        eng.stop()
    assert ptrs == {k: v.data_ptr()
                    for k, v in eng._params["b0_attn"].items()}
    assert eng.trace_count == 1 and eng.model_version == 1
    for params, got in ((ref.params, fitted), (new, swapped)):
        model = unsplit(params)
        want = generate_naive(model, prompt, 6, 32)["tokens"]
        assert _first_tie(model, prompt, got, want) <= TIE_MARGIN, \
            (got, want)


def test_what_a_model_axis_does_not_take_raises(tp_mesh):
    """Speculation, the host KV tier, int8 / fp8 serving and tBPTT run
    under a model axis (tests/test_torch_model_axis_features.py); heads
    the axis does not divide still raise ``ValueError`` (param_spec's
    split would fall inside a head): at the first fit and on either
    engine."""
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    net = port_of(jax_tt(n_heads=1))
    x, y = tt_data(16)
    for call in (lambda: net.fit(DataSet(x, y)),
                 lambda: DecodeEngine(net, 2, 32),
                 lambda: DecodeEngine(net, 2, 32, spec=SpecConfig(net, k=2)),
                 lambda: InferenceEngine(net, 8, precision="int8")):
        with pytest.raises(ValueError, match="heads do not divide"):
            call()
