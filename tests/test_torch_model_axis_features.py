"""What a model axis used to refuse, on the default mesh's model axis:
speculation, the host KV tier, KV migration and int8 / fp8 serving over
head shards, and truncated BPTT, the flight recorder, a compute dtype,
the bf16 train policy, weight noise and constraints in the TP fit. The
mesh is ``DL4JTPU_MESH=model=2`` over eight CPU slots (a (data 4, model
2) mesh, the ``tp_mesh`` fixture of tests/test_torch_default_mesh_tp.py),
each feature held against the port on one slot and against the JAX
package on a ``model_parallel=2`` executor over the eight forced host
devices.

- Greedy decode (speculation dense over an int8 set; speculation paged
  with a draft model over an fp8 set whose host tier evicts and
  restores): the tokens of the one-slot engine and of the JAX engine,
  except after a near-tie (the reference's top-2 probability gap at the
  first differing step at most ``TIE_MARGIN``). The JAX engines run once
  per module (``jax_tokens``).
- KV migration between a TP engine and an unsplit one, both ways: the
  payload's leaf keys are the unsplit engine's and its rows equal them
  at rtol 1e-5 / atol 1e-6; the JAX engine imports the TP engine's chain.
- A quantized shard set: the shards' dequantized codes concatenated equal
  the whole weight's dequantization bit for bit, column and row splits,
  int8 and fp8; the gathered codes are the JAX TP executor's.
- The TP fit with truncated BPTT, a row-split ``maxnorm``, a compute
  dtype: rtol 1e-4 / atol 1e-5 against one slot. The bf16 policy: each
  step from one slot's float32 masters, its change within 2^-8 of one
  slot's in norm (each leaf 2^-6), the score at rtol 1e-4; against the
  JAX TP executor, a score within the bf16 cases' 3e-2 of
  tests/test_torch_fused_update.py;
  weight noise against one slot with the same generator. The recorder's
  rows against one slot's at rtol 1e-4.
- Launches through ``ops.count_launch`` at CPU shapes (each plain version
  stands in for its kernel): K8 / K9 4 a plain step and 4 a verify (2
  layers x 2 shards), 2 a draft step and draft attention layer; K5-K7 4
  a TinyTransformer step; K2 / K3 what the one-slot chunk takes.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.exec import Executor as JaxExecutor
from deeplearning4j_tpu.exec import build_mesh as jax_build_mesh
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.spec import SpecConfig as JaxSpecConfig
from deeplearning4j_tpu.zoo import TinyTransformer as JaxTiny
from deeplearning4j_tpu import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JaxConf
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.exec import Executor, build_mesh
from deeplearning4j_tpu_torch.ops import lstm_cuda
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    gather_parts, split_parts)
from deeplearning4j_tpu_torch.quant import dequantize, quantize
from deeplearning4j_tpu_torch.serving import DecodeEngine, InferenceEngine
from deeplearning4j_tpu_torch.serving.spec import SpecConfig
from test_torch_default_mesh_tp import (BS, FIT_ATOL, FIT_RTOL, TIE_MARGIN,
                                        _first_tie, assert_params, jax_lstm,
                                        jax_tp, launches, lstm_data,
                                        one_slot, tp_mesh)  # noqa: F401
from test_torch_regularised_training import port_of
from test_torch_tensor_parallel import jax_tt, leaves, tp_data, tt_data

ROW_RTOL, ROW_ATOL = 1e-5, 1e-6          # migrated rows
REC_RTOL = 1e-4                          # the recorder's rows
BF16_TOL = 3e-2                          # tests/test_torch_fused_update.py
# a bf16-policy step against one slot's from the same masters, in norm
# relative to the step's change: the whole set within one bfloat16 unit,
# each leaf within four (the two routes' float32 sums round a bfloat16
# value a unit apart now and then, and the step carries it on)
BF16_STEP_RTOL, BF16_LEAF_RTOL = 2.0 ** -8, 2.0 ** -6
NEW = 4                                  # tokens a greedy request


def jax_draft():
    """A one-block draft whose four heads divide over the model axis."""
    return JaxTiny(vocab_size=16, n_layers=1, d_model=32, n_heads=4, seed=3,
                   updater=JaxSgd(0.05)).init()


def _prompts():
    rs = np.random.RandomState(2)
    out = [list(map(int, rs.randint(0, 16, n))) for n in (3, 9, 9)]
    out[2][:8] = out[1][:8]                  # a shared first block
    return out


def _tier_prompts():
    rs = np.random.RandomState(3)
    return [list(map(int, rs.randint(0, 16, 16))) for _ in range(4)]


def _spec_of(draft, **kw):
    cls = JaxSpecConfig if type(draft).__module__.startswith(
        "deeplearning4j_tpu.") else SpecConfig
    return cls(draft, **kw)


def _engine_kw(name, target, draft=None):
    """(engine keyword arguments, prompts, passes) of a decode case over
    ``target`` (either package's; ``draft``: its separate draft model).
    Two cases cover the five features (each JAX engine compiles its own
    programs)."""
    if name == "spec_dense_int8":    # the int8 target as its own draft
        return dict(slots=4, max_len=32, precision="int8",
                    spec=_spec_of(target, k=2)), _prompts(), 1
    # a one-block draft with a tree over an fp8 paged target whose host
    # tier takes 4 chains of 2 blocks over 6 blocks, twice: evictions,
    # restores
    return dict(slots=2, max_len=32, kv="paged", kv_block_size=8,
                chunk_tokens=8, kv_blocks=7, host_kv_bytes=1 << 20,
                precision="fp8", spec=_spec_of(draft, tree=(2, 2))), \
        _tier_prompts(), 2


def _serve(eng, prompts, passes):
    """Every prompt ``passes`` times, one at a time: (tokens, stats)."""
    eng.start()
    try:
        toks = [eng.generate(p, NEW)["tokens"] for _ in range(passes)
                for p in prompts]
        return toks, eng.stats()
    finally:
        eng.stop()


DECODE_CASES = ("spec_dense_int8", "spec_paged_fp8_tier")


@pytest.fixture(scope="module")
def jax_tokens():
    """Each decode case's greedy tokens from the JAX engine on a
    ``model_parallel=2`` executor (built once per module)."""
    out = {}
    jnet, jdraft = jax_tp(jax_tt()), jax_tp(jax_draft())
    for name in DECODE_CASES:
        kw, prompts, passes = _engine_kw(name, jnet, jdraft)
        if passes == 1:                  # the first two prompts suffice
            prompts = prompts[:2]
        out[name] = _serve(JaxDecode(jnet, **kw), prompts, passes)[0]
    return out


def _launch_want(name, st, st0, paged):
    """The decode kernels' launches the stats ``st`` imply since ``st0``
    (warmup's inert draft and verify count there): 2 layers x 2 shards a
    plain step and a verify (K9 plain steps on a paged engine, K8
    everything else), 2 shards a draft step and draft layer."""
    spec = st["spec"]
    verifies = spec["verifies"] - st0["spec"]["verifies"] if spec else 0
    plain = st["steps"] - st0["steps"] - verifies
    want = {}
    if plain:
        want["flash_decode_paged" if paged else "flash_decode"] = 4 * plain
    if spec:
        draft_layers = 2 if name == "spec_dense_int8" else 1
        drafted = spec["draft_steps"] - st0["spec"]["draft_steps"]
        want["flash_decode"] = want.get("flash_decode", 0) + \
            4 * verifies + 2 * draft_layers * drafted
    return want


@pytest.mark.mesh8
@pytest.mark.parametrize("name", DECODE_CASES)
def test_greedy_decode_features_over_head_shards(tp_mesh, launches,
                                                 jax_tokens, name):
    """Each feature on a TP engine: the one-slot engine's tokens and the
    JAX TP engine's (near-tie rule), the decode kernels once a layer and
    model shard, one program of the plain step."""
    jnet = jax_tt()
    net, ref = port_of(jnet), one_slot(port_of(jnet))
    draft, ref_draft = port_of(jax_draft()), one_slot(port_of(jax_draft()))
    kw, prompts, passes = _engine_kw(name, net, draft)
    eng = DecodeEngine(net, **kw)
    eng.start()
    st0 = eng.stats()
    launches.reset_launch_counts()            # after warmup's inert calls
    try:
        got = [eng.generate(p, NEW)["tokens"] for _ in range(passes)
               for p in prompts]
        st = eng.stats()
        info = eng.kv_pool_info() if eng._pool is not None else None
    finally:
        eng.stop()
    assert st["model_parallel"]["kv_split"] == "heads"
    assert eng.trace_count == 1
    assert launches.launch_counts() == _launch_want(name, st, st0,
                                                    eng._pool is not None)
    if st["spec"]:
        assert st["spec"]["verifies"] > 0 and st["spec"]["draft_steps"] > 0
        assert st["spec"]["acceptance_rate"] > 0
        # a draft's own head split
        assert isinstance(eng._draft._tree["b0_attn"]["k"], list)
    if name == "spec_paged_fp8_tier":
        assert info["host_tier"]["spills"] > 0
        assert st["kv"]["host_restores"] > 0
        assert info["blocks_in_use"] == 0
    assert st["precision"] == name.split("_")[2]
    assert [type(eng._params["b0_attn"][k]).__name__
            for k in ("Wq@0", "Wo@1")] == ["QTensor"] * 2
    rkw, _, _ = _engine_kw(name, ref, ref_draft)
    want = _serve(DecodeEngine(ref, **rkw), prompts, passes)[0]
    seqs = [p for _ in range(passes) for p in prompts]
    for p, g, w, jw in zip(seqs, got, want, jax_tokens[name]):
        assert _first_tie(ref, p, g, w) <= TIE_MARGIN, (p, g, w)
        assert _first_tie(ref, p, g, jw) <= TIE_MARGIN, (p, g, jw)


def _lstm_mln():
    """A 2 x LSTM(16) character net (an early-exit target)."""
    from deeplearning4j_tpu_torch import (MultiLayerNetwork,
                                          NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(LSTM(n_out=16, activation="tanh"))
            .layer(LSTM(n_out=16, activation="tanh"))
            .layer(RnnOutputLayer(n_out=16, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(16)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


DRAFT_CASES = {
    "draft_model_int8": lambda t, d: SpecConfig(d, k=2,
                                                draft_precision="int8"),
    "self_draft_fp8": lambda t, d: SpecConfig(self_draft="fp8", k=2),
    "target_draft_int8": lambda t, d: SpecConfig(t, k=2,
                                                 draft_precision="int8"),
    "early_exit": lambda t, d: SpecConfig(self_draft="early_exit:1",
                                          tree=(2, 2)),
    "early_exit_int8": lambda t, d: SpecConfig(
        self_draft="early_exit:1", tree=(2, 2), draft_precision="int8")}


@pytest.mark.parametrize("case", list(DRAFT_CASES))
def test_quantized_and_early_exit_drafts_over_head_shards(tp_mesh, case):
    """A quantized draft is the whole draft tree quantized, then split
    into its own shard set (``DraftEngine.form``), and an early-exit view
    of an MLN target drafts over the target's shard set: the tokens of
    the same draft on one slot."""
    lstm = case.startswith("early_exit")
    if lstm:
        net, ref = _lstm_mln(), one_slot(_lstm_mln())
        draft = ref_draft = None
        kw = dict(prefix_cache=False)
    else:
        net, ref = port_of(jax_tt()), one_slot(port_of(jax_tt()))
        draft, ref_draft = port_of(jax_draft()), \
            one_slot(port_of(jax_draft()))
        kw = {}
    toks = []
    for model, d in ((net, draft), (ref, ref_draft)):
        eng = DecodeEngine(model, 4, 32, spec=DRAFT_CASES[case](model, d),
                           **kw).start()
        try:
            toks.append([eng.generate(p, NEW)["tokens"]
                         for p in _prompts()])
        finally:
            eng.stop()
        if model is net:
            assert eng._draft.form is not None
            if case.endswith(("int8", "fp8")):
                leaf = 0 if lstm else "b0_attn"
                assert any(type(v).__name__ == "QTensor"
                           for v in eng._draft.params[leaf].values())
    for p, g, w in zip(_prompts(), *toks):
        if g != w:
            assert not lstm and _first_tie(ref, p, g, w) <= TIE_MARGIN


def test_a_compute_dtype_model_decodes_over_head_shards(tp_mesh):
    """A bfloat16 compute-dtype TinyTransformer serves over head shards
    (bfloat16 caches a shard) with one slot's greedy tokens."""
    from deeplearning4j_tpu_torch.zoo import TinyTransformer

    def make():
        return TinyTransformer(vocab_size=16, n_layers=2, d_model=32,
                               n_heads=4, seed=5,
                               compute_dtype="bfloat16").init(device="cpu")
    net, ref = make(), one_slot(make())
    toks = []
    for model, kv in ((net, "dense"), (ref, "dense"), (net, "paged"),
                      (ref, "paged")):
        eng = DecodeEngine(model, 2, 32, kv=kv, kv_block_size=8).start()
        try:
            toks.append([eng.generate(p, NEW)["tokens"]
                         for p in _prompts()])
            if model is net:
                cache = eng._dstate["b0_attn"]["k" if kv == "dense"
                                               else "pk"]
                assert [t.dtype for t in cache] == [torch.bfloat16] * 2
        finally:
            eng.stop()
    assert toks[0] == toks[1] and toks[2] == toks[3]


def _paged(net, **kw):
    return DecodeEngine(net, slots=2, max_len=32, kv="paged",
                        kv_block_size=8, chunk_tokens=8, **kw)


def _rows(payload):
    import base64
    out = {}
    for leaf in payload["leaves"]:
        raw = base64.b64decode(leaf["data"])
        out[leaf["path"]] = np.frombuffer(raw, np.dtype(leaf["dtype"])) \
            .reshape(leaf["shape"])
    return out


@pytest.mark.mesh8
@pytest.mark.parametrize("direction", ["tp_to_unsplit", "unsplit_to_tp"])
def test_kv_chains_move_between_split_and_unsplit_engines(tp_mesh,
                                                          direction):
    """A chain exported by a TP engine has the unsplit engine's leaf keys
    and rows (its head split gathered) and continues in an unsplit
    engine, and an unsplit engine's chain continues in a TP engine; the
    JAX TP engine takes the TP engine's chain too. The envelope is the
    unsplit one."""
    jnet = jax_tt()
    net, ref = port_of(jnet), one_slot(port_of(jnet))
    prompt = _tier_prompts()[0]
    tp_eng, un_eng = _paged(net).start(), _paged(ref).start()
    try:
        want = un_eng.generate(prompt, NEW)["tokens"]
        tp_tokens = tp_eng.generate(prompt, NEW)["tokens"]
        tp_pay, un_pay = tp_eng.kv_export(prompt), un_eng.kv_export(prompt)
        assert isinstance(tp_eng._dstate["b0_attn"]["pk"], list)
        assert tp_eng._migrate_envelope() == un_eng._migrate_envelope()
    finally:
        tp_eng.stop()
        un_eng.stop()
    assert _first_tie(ref, prompt, tp_tokens, want) <= TIE_MARGIN
    tp_rows, un_rows = _rows(tp_pay), _rows(un_pay)
    assert sorted(tp_rows) == sorted(un_rows) == [
        "['b0_attn']['pk']", "['b0_attn']['pv']", "['b1_attn']['pk']",
        "['b1_attn']['pv']"]
    for k, r in un_rows.items():
        assert tp_rows[k].shape == r.shape == (2, 8, 4, 8)
        np.testing.assert_allclose(tp_rows[k], r, rtol=ROW_RTOL,
                                   atol=ROW_ATOL, err_msg=k)
    src, dst_net = ((tp_pay, ref) if direction == "tp_to_unsplit"
                    else (un_pay, net))
    dst = _paged(dst_net).start()
    try:
        got = dst.kv_import(src)
        cont = dst.generate(prompt, NEW)
        st = dst.stats()
    finally:
        dst.stop()
    assert got["imported_blocks"] == 2
    assert st["kv"]["prefix_hits"] == 1
    assert _first_tie(ref, prompt, cont["tokens"], want) <= TIE_MARGIN
    if direction == "tp_to_unsplit":
        jeng = JaxDecode(jax_tp(jnet), slots=2, max_len=32, kv="paged",
                         kv_block_size=8, chunk_tokens=8).start()
        try:
            assert jeng.kv_import(tp_pay)["imported_blocks"] == 2
            jcont = jeng.generate(prompt, NEW)["tokens"]
        finally:
            jeng.stop()
        assert _first_tie(ref, prompt, jcont, want) <= TIE_MARGIN


@pytest.mark.parametrize("precision", ["int8", "fp8"])
@pytest.mark.parametrize("split", ["column", "row"])
def test_a_quantized_shard_set_dequantizes_to_the_whole(precision, split):
    """The whole weight quantized, then split: the shards' dequantized
    codes concatenated equal the whole dequantization bit for bit (a
    column split cuts the scales, a row split shares them whole)."""
    w = torch.from_numpy(np.random.RandomState(7).randn(32, 24)
                         .astype(np.float32))
    spec = (None, "model") if split == "column" else ("model", None)
    dim = 1 if split == "column" else 0
    whole = quantize(w, precision)
    parts = split_parts(whole, spec, 2)
    assert [tuple(p.codes.shape) for p in parts] == \
        ([(32, 12)] * 2 if split == "column" else [(16, 24)] * 2)
    got = torch.cat([dequantize(p) for p in parts], dim)
    assert torch.equal(got.view(torch.int32),
                       dequantize(whole).view(torch.int32))
    back = gather_parts(parts, spec)
    assert torch.equal(back.codes.view(torch.uint8),
                       whole.codes.view(torch.uint8))
    assert torch.equal(back.scale, whole.scale)


@pytest.mark.mesh8
@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_quantized_shard_sets_are_the_jax_executors_codes(tp_mesh, launches,
                                                          precision):
    """An int8 / fp8 bucketed engine over a TP shard set: its gathered
    codes and scales equal the JAX TP executor's ``prepare_params`` byte
    for byte, its /predict is the one-slot engine's at rtol 1e-5 / atol
    1e-6, and a forward launches K5 once a block and model shard."""
    jnet = jax_tt()
    net, ref = port_of(jnet), one_slot(port_of(jnet))
    eng = InferenceEngine(net, 8, precision=precision)
    got_set = eng._weights_set.unsplit()
    jq = jax_tp(jnet)._exec.prepare_params(jnet.params, precision)
    for name in ("b0_attn", "b1_ff1", "b1_ff2"):
        for k, q in got_set[name].items():
            jl = jq[name][k]
            if not hasattr(q, "codes"):
                continue
            codes = q.codes.view(torch.uint8).numpy()
            jcodes = np.asarray(jl.codes).view(np.uint8)
            np.testing.assert_array_equal(codes, jcodes, err_msg=k)
            np.testing.assert_array_equal(q.scale.numpy(),
                                          np.asarray(jl.scale), err_msg=k)
    x, _ = tt_data(5)
    launches.reset_launch_counts()
    out = eng.predict(x).numpy()
    assert launches.launch_counts() == {"flash_attn_fwd": 4}
    want = InferenceEngine(ref, 8, precision=precision).predict(x).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def jax_dense(constraints=None, compute_dtype=None):
    """The dense net of the JAX TP tests, with a constraint on its
    row-split middle layer (W (32, 16)) and a compute dtype."""
    b = JaxConf.builder().seed(9).updater(JaxSgd(0.1)).weight_init("xavier")
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    conf = (b.list().layer(JaxDense(n_out=32, activation="relu"))
            .layer(JaxDense(n_out=16, activation="relu",
                            constraints=constraints))
            .layer(JaxOut(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(8)).build())
    return JaxMLN(conf).init()


def _tbptt(net):
    net.conf.backprop_type = "tbptt"
    net.conf.tbptt_fwd_length = net.conf.tbptt_back_length = 4
    return net


def _lstm_launches(monkeypatch):
    """K2 and K3 counted where the layers reach their wrappers."""
    from deeplearning4j_tpu_torch import ops
    for fn, entry in (("fused_lstm_sequence_train", "lstm_fwd_train"),
                      ("fused_lstm_backward", "lstm_bwd")):
        real = getattr(lstm_cuda, fn)

        def counted(*a, _real=real, _entry=entry, **kw):
            ops.count_launch(_entry)
            return _real(*a, **kw)
        monkeypatch.setattr(lstm_cuda, fn, counted)


FIT_CASES = ("tbptt", "maxnorm", "compute_dtype", "bf16_policy")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _assert_step_agrees(got, want, before):
    """A step's change ``got - before`` against ``want - before``, in
    norm: the whole set within ``BF16_STEP_RTOL`` of the change, each
    leaf within ``BF16_LEAF_RTOL`` of its own (plus ``FIT_ATOL``); some
    parameter moved by over 100 x ``FIT_ATOL``."""
    g, w, b = leaves(got), leaves(want), leaves(before)
    err = {k: float(np.linalg.norm(g[k] - w[k])) for k in w}
    move = {k: float(np.linalg.norm(w[k] - b[k])) for k in w}
    for k in w:
        assert err[k] <= BF16_LEAF_RTOL * move[k] + FIT_ATOL, \
            (k, err[k], move[k])
    whole = np.sqrt(sum(e * e for e in err.values()) /
                    sum(d * d for d in move.values()))
    assert whole <= BF16_STEP_RTOL, whole
    assert max(float(np.abs(w[k] - b[k]).max()) for k in w) > 100 * FIT_ATOL


def _fit_counted(nets, x, y, launches, counts):
    """One fit of each net on (x, y), its launches added to its count."""
    for n, c in zip(nets, counts):
        launches.reset_launch_counts()
        n.fit(DataSet(x, y))
        for k, v in launches.launch_counts().items():
            c[k] = c.get(k, 0) + v


def _fit_case(name, tp_mesh):
    """(JAX net, data batches, the port's executor settings)."""
    if name == "tbptt":
        x, y = lstm_data(32, 16)
        return _tbptt(jax_lstm()), [(x[:16], y[:16]), (x[16:], y[16:])], {}
    if name == "bf16_policy":
        x, y = tt_data(3 * BS)
        return jax_tt(), [(x[i:i + BS], y[i:i + BS])
                          for i in range(0, 3 * BS, BS)], \
            {"train_precision": "bf16"}
    x, y = tp_data(48)
    jnet = jax_dense(constraints=("maxnorm", 0.5)) if name == "maxnorm" \
        else jax_dense(compute_dtype="bfloat16")
    return jnet, [(x[i:i + BS], y[i:i + BS]) for i in (0, 16, 32)], {}


@pytest.mark.mesh8
@pytest.mark.parametrize("name", FIT_CASES)
def test_tp_fit_takes_the_training_policies(tp_mesh, launches, monkeypatch,
                                            name):
    """Truncated BPTT (each chunk a TP step, the carries kept as on one
    slot), ``maxnorm`` on a row-split weight (the norm over the shards),
    a bfloat16 compute dtype and the bf16 train policy (float32 master
    shards; each step from one slot's masters, whose bfloat16 copies
    would round apart at a boundary after float32's last bits differ):
    the one-slot fit's parameters and the JAX TP container's, the kernels
    as the one-slot step launches them."""
    _lstm_launches(monkeypatch)
    jnet, data, ex_kw = _fit_case(name, tp_mesh)
    net, ref = port_of(jnet), one_slot(port_of(jnet))
    if name == "tbptt":
        _tbptt(net), _tbptt(ref)
    mesh = build_mesh(["cpu"] * 8, model_parallel=2)
    net._exec = Executor(mesh, **ex_kw)
    ref._exec = Executor(build_mesh(["cpu"]), **ex_kw)
    jex = JaxExecutor(jax_build_mesh(model_parallel=2), **ex_kw)
    jnet._exec = jex
    counts = [{}, {}]
    if name == "bf16_policy":
        # each step from the same float32 masters: after a step the masters
        # differ in float32's last bits, and their bfloat16 copies round
        # apart at a boundary, which the next step would amplify
        for x, y in data:
            before = _clone(ref.params)
            _fit_counted((net, ref), x, y, launches, counts)
            _assert_step_agrees(net.params, ref.params, before)
            net.set_params(_clone(ref.params))
    else:
        for x, y in data:
            _fit_counted((net, ref), x, y, launches, counts)
    for x, y in data:
        jnet.fit(JaxDataSet(x, y))
    assert net._executor.model_size == 2 and net.tp_routes
    if name == "tbptt":     # K2 + K3 a chunk: 4 chunks a batch, 2 batches
        assert counts[0] == counts[1] == {"lstm_fwd_train": 8,
                                          "lstm_bwd": 8}
    if name == "bf16_policy":   # 2 blocks x 2 shards a step (one slot: 2)
        assert counts == [{k: n * len(data) for k in (
            "flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")}
            for n in (4, 2)]
        assert all(v.dtype == torch.float32 for p in net.params.values()
                   for v in p.values())
    if name != "bf16_policy":
        assert_params(net.params, ref.params)
    np.testing.assert_allclose(net.get_score(), ref.get_score(),
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    if name in ("tbptt", "maxnorm"):
        assert_params(net.params, jnet.params)
        np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                                   rtol=FIT_RTOL, atol=FIT_ATOL)
    else:           # bfloat16 arithmetic differs between the packages
        np.testing.assert_allclose(net.get_score(), jnet.get_score(),
                                   rtol=BF16_TOL)
    if name == "maxnorm":
        w = net.params[1]["W"]
        assert float(torch.linalg.vector_norm(w, dim=0).max()) <= 0.5 + 1e-6


@pytest.mark.parametrize("noise", ["DropConnect", "WeightNoise"])
def test_tp_weight_noise_draws_what_one_slot_draws(tp_mesh, noise):
    """Weight noise drawn on each weight's full shape from the step's
    generator, then split: the TP fit is the one-slot fit with the same
    generator, and not the noiseless one."""
    from deeplearning4j_tpu_torch.nn import weightnoise
    wn = (weightnoise.DropConnect(weight_retain_prob=0.8)
          if noise == "DropConnect" else weightnoise.WeightNoise(stddev=0.05))
    x, y = tp_data(48)
    jnet = jax_dense()
    nets = [port_of(jnet), one_slot(port_of(jnet)), port_of(jnet)]
    for n in nets[:2]:
        for layer in n.layers:
            layer.weight_noise = wn
        n._gen = torch.Generator().manual_seed(0)
    for n in nets:
        for i in (0, 16, 32):
            n.fit(DataSet(x[i:i + BS], y[i:i + BS]))
    assert nets[0]._executor.model_size == 2
    assert_params(nets[0].params, nets[1].params)
    moved = max(float((a - b).abs().max()) for pa, pb in
                zip(nets[0].params, nets[2].params)
                for a, b in zip(pa.values(), pb.values()))
    assert moved > 1e-3


@pytest.mark.mesh8
def test_the_flight_recorder_reads_the_same_rows_under_tp(tp_mesh,
                                                          launches,
                                                          tmp_path):
    """The recorder on a TP fit: a sampled step's (L, 5) rows over each
    layer's shard leaves together, the one-slot rows at rtol 1e-4 in the
    container's layer order, a spill that reads as the one-slot run's,
    the parameters those without a recorder's, K5-K7 once a block and
    model shard a step."""
    x, y = tt_data(48)
    net, ref = port_of(jax_tt()), one_slot(port_of(jax_tt()))
    plain = port_of(jax_tt())
    recs = [monitor.FlightRecorder(sample_every=2) for _ in range(2)]
    counts = None
    for n, rec in zip((net, ref), recs):
        n.attach_flight_recorder(rec)
        launches.reset_launch_counts()
        for i in (0, 16, 32):
            n.fit(DataSet(x[i:i + BS], y[i:i + BS]))
        counts = counts or launches.launch_counts()
    for i in (0, 16, 32):
        plain.fit(DataSet(x[i:i + BS], y[i:i + BS]))
    assert counts == {k: 12 for k in ("flash_attn_fwd", "flash_attn_dq",
                                      "flash_attn_dkv")}
    got, want = recs[0].records(), recs[1].records()
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want] \
        == [0, 2]
    for g, w in zip(got, want):
        assert g["stats"].shape == w["stats"].shape == \
            (len(recs[0].layer_names), 5)
        np.testing.assert_allclose(g["stats"], w["stats"], rtol=REC_RTOL,
                                   atol=1e-7)
    assert recs[0].layer_names == recs[1].layer_names
    docs = [monitor.FlightRecorder.restore(r.spill(str(tmp_path / f"{i}")))
            for i, r in enumerate(recs)]
    for key in ("version", "layer_names", "cols", "sample_every",
                "first_non_finite"):
        assert docs[0][key] == docs[1][key], key
    assert [(a["kind"], a["layer"], a["iteration"])
            for a in docs[0]["anomalies"]] == \
        [(a["kind"], a["layer"], a["iteration"])
         for a in docs[1]["anomalies"]]
    for g, w in zip(docs[0]["records"], docs[1]["records"]):
        np.testing.assert_allclose(g["stats"], w["stats"], rtol=REC_RTOL,
                                   atol=1e-7)
    assert_params(net.params, plain.params, rtol=0, atol=0)
    assert_params(net.params, ref.params)


def test_a_draft_whose_heads_do_not_divide_decodes_unsplit(tp_mesh):
    """A draft model whose one head the model axis does not divide
    decodes over its own gathered parameters (no form, a whole-head
    cache) beside a head-split target: the one-slot engine's tokens."""
    net = port_of(jax_tt())
    draft = port_of(jax_tt(n_heads=1))
    eng = DecodeEngine(net, 2, 32, spec=SpecConfig(draft, k=2)).start()
    try:
        got = eng.generate([1, 2, 3], NEW)["tokens"]
    finally:
        eng.stop()
    assert eng._draft.form is None
    assert torch.is_tensor(eng._draft._tree["b0_attn"]["k"])
    assert isinstance(eng._dstate["b0_attn"]["k"], list)
    ref = one_slot(port_of(jax_tt()))
    reng = DecodeEngine(ref, 2, 32).start()
    try:
        want = reng.generate([1, 2, 3], NEW)["tokens"]
    finally:
        reng.stop()
    assert _first_tie(ref, [1, 2, 3], got, want) <= TIE_MARGIN


def test_a_split_draft_follows_its_model(tp_mesh):
    """A float32 draft model's own shard set follows that model as the
    unsplit draft reads the model's tensors: after the draft model's
    parameters move, the next request's draft reads them, split into the
    same shard tensors in place."""
    net, draft = port_of(jax_tt()), port_of(jax_draft())
    eng = DecodeEngine(net, 2, 32, spec=SpecConfig(draft, k=2)).start()
    try:
        eng.generate([1, 2, 3], NEW)
        form, params = eng._draft.form, eng._draft.params
        ptrs = [t.data_ptr() for p in params.values() for t in p.values()]
        moved = {n: {k: v * 0.5 for k, v in p.items()}
                 for n, p in draft.params.items()}
        draft.set_params(moved)
        eng.generate([1, 2, 3], NEW)
    finally:
        eng.stop()
    assert isinstance(eng._draft._tree["b0_attn"]["k"], list)
    assert [t.data_ptr() for p in params.values() for t in p.values()] \
        == ptrs
    assert_params(form.gather(params), moved, rtol=0, atol=0)
