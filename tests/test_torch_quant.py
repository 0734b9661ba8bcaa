"""The port's serving precisions (quant/, int8 and fp8-e4m3 weight-only
quantization) held against the JAX package's, on the CPU: every case of
tests/test_quant.py, each run in both packages.

- The codes equal JAX's byte for byte on the same float32 input (int8 as
  integers, fp8 through their bits), zero channels and the +-127 / +-448
  edges and rounding ties included; the scales bit for bit.
- Round trips within the documented bars (int8 1%, fp8 5% of a leaf's
  amax); an int8 tree at most 0.30 of its float32 bytes.
- The engines at the same precision as the JAX engines: outputs within
  1e-5 (the codes are identical; only the float32 forwards' summation
  order differs), greedy decode tokens equal; end-to-end accuracy deltas
  at most 0.01 (int8) and 0.02 (fp8); swaps quantize after the gate and
  add no program; one program per (model, precision).

The models are the JAX test's (a Dense-64 blobs classifier, the serving
replica's 2 x LSTM(32) char model, a small TinyTransformer), built in the
JAX package and carried across as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu import exec as jex
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.quant import dequantize as jax_dequantize
from deeplearning4j_tpu.quant import quant_error_report as jax_report
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.quant import quantize_tree as jax_quantize_tree
from deeplearning4j_tpu.quant import resolve_precision as jax_resolve
from deeplearning4j_tpu.quant import tree_bytes as jax_tree_bytes
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.engine import InferenceEngine as JaxEngine
from deeplearning4j_tpu.serving.replica import build_model
from deeplearning4j_tpu.serving.spec import SpecConfig as JaxSpec

from deeplearning4j_tpu_torch import exec as ex
from deeplearning4j_tpu_torch.quant import (QTensor, copy_tree, dequantize,
                                            dequantize_tree,
                                            quant_error_report, quantize,
                                            quantize_tree, resolve_precision,
                                            tree_bytes)
from deeplearning4j_tpu_torch.resilience.errors import WeightSwapError
from deeplearning4j_tpu_torch.serving import DecodeEngine, InferenceEngine
from deeplearning4j_tpu_torch.serving.spec import SpecConfig
from test_torch_kv_prefix import jax_transformer, prompts
from test_torch_regularised_training import port_of

OUT_TOL = 1e-5          # port engine vs JAX engine at the same precision
BARS = {"int8": 0.01, "fp8": 0.05}          # round-trip, of a leaf's amax
ACC_BARS = {"int8": 0.01, "fp8": 0.02}      # docs/QUANTIZATION.md


def _jax_net(seed=3, n_in=8, hidden=64, n_out=3):
    conf = (JaxNNC.builder().seed(seed).updater(JaxAdam(1e-2))
            .weight_init("xavier").list()
            .layer(JaxDense(n_out=hidden, activation="relu"))
            .layer(JaxOut(n_out=n_out, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(n_in))
            .build())
    return JaxMLN(conf).init()


def _blobs(n=240, seed=0, d=8, k=3):
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, d) * 3
    y = rs.randint(0, k, n)
    X = centers[y] + rs.randn(n, d) * 0.5
    return X.astype(np.float32), y


def _bits(codes):
    """Codes as comparable numpy integers: int8 as is, fp8 by its bits."""
    if isinstance(codes, torch.Tensor):
        if codes.dtype == torch.float8_e4m3fn:
            codes = codes.view(torch.uint8)
        return codes.numpy()
    a = np.asarray(codes)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and \
        a.dtype != np.int8 else a


def _assert_same_codes(jq, tq):
    np.testing.assert_array_equal(_bits(jq.codes), _bits(tq.codes))
    np.testing.assert_array_equal(np.asarray(jq.scale), tq.scale.numpy())
    assert tuple(jq.codes.shape) == tuple(tq.codes.shape)


# --------------------------------------------------------------- mechanism

def test_resolve_precision_aliases_and_rejects():
    for alias in (None, "", "f32", "float32", "fp32", "none", "int8", "i8",
                  "INT8", "fp8", "e4m3", "fp8_e4m3", "float8"):
        assert resolve_precision(alias) == jax_resolve(alias)
    with pytest.raises(ValueError, match="unknown precision"):
        resolve_precision("int4")


@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_roundtrip_error_bounds_and_codes_match_jax(precision):
    rs = np.random.RandomState(0)
    # mixed per-channel magnitudes: the case per-tensor scales fail
    w = (rs.randn(64, 32) * np.logspace(-2, 1, 32)).astype(np.float32)
    qt = quantize(w, precision)
    assert isinstance(qt, QTensor) and qt.shape == w.shape
    assert qt.dtype == {"int8": torch.int8,
                        "fp8": torch.float8_e4m3fn}[precision]
    _assert_same_codes(jax_quantize(jnp.asarray(w), precision), qt)
    back = dequantize(qt).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jax_dequantize(jax_quantize(jnp.asarray(w),
                                                     precision))))
    rel = np.max(np.abs(back - w)) / np.max(np.abs(w))
    assert rel <= BARS[precision], rel


def test_zero_channel_is_exact_and_finite():
    w = np.zeros((4, 3), np.float32)
    w2 = np.random.RandomState(5).randn(6, 4).astype(np.float32)
    w2[:, 1] = 0.0                       # one dead channel among live ones
    for p in ("int8", "fp8"):
        back = dequantize(quantize(w, p)).numpy()
        assert np.all(back == 0) and np.all(np.isfinite(back))
        q2 = quantize(w2, p)
        assert np.all(dequantize(q2).numpy()[:, 1] == 0)
        assert q2.scale.numpy()[0, 1] == 1.0
        for arr in (w, w2):
            _assert_same_codes(jax_quantize(jnp.asarray(arr), p),
                               quantize(arr, p))


@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_codes_at_the_edges_match_jax(precision):
    """A channel whose largest entry divides to exactly +-127 / +-448 (and
    quotients a rounding step below), int8 half-way ties (half to even),
    fp8 ties and subnormals (round to nearest even), tiny and huge
    channels: the same bytes as JAX, and no code past the format's
    largest finite value."""
    edge = np.array([448, -448, 1.0625, 1.1875, 1.5 * 2 ** -10, 2 ** -10,
                     3 * 2 ** -10, 240, 232, 464 / 1.0001, 0, 13.0, -0.0],
                    np.float32)
    ties = np.array([127, -127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.5, 0, 0,
                     0, 0], np.float32)
    rs = np.random.RandomState(1)
    cols = [edge, ties, np.zeros(13, np.float32),
            rs.randn(13).astype(np.float32) * 1e-30,
            rs.randn(13).astype(np.float32) * 1e30,
            (edge * np.float32(0.1)).astype(np.float32)]
    w = np.stack(cols, 1)
    w = np.concatenate(
        [w, (rs.randn(500, 6) * np.logspace(-6, 6, 6)).astype(np.float32)])
    jq, tq = jax_quantize(jnp.asarray(w), precision), quantize(w, precision)
    _assert_same_codes(jq, tq)
    lim = 127 if precision == "int8" else 448
    vals = tq.codes.to(torch.float32)
    assert torch.isfinite(vals).all() and vals.abs().max().item() == lim


def test_f32_is_identity_same_objects():
    tree = {"W": torch.ones(4, 4), "b": torch.zeros(4)}
    assert quantize_tree(tree, "f32") is tree
    out = dequantize_tree(tree)
    assert out["W"] is tree["W"] and out["b"] is tree["b"]


def test_tree_quantization_skips_vectors_and_exclusions():
    tree = {"layer0": {"W": torch.ones(8, 8), "b": torch.ones(8)},
            "head": {"W": torch.ones(8, 2)}}
    q = quantize_tree(tree, "int8", exclude=("head",))
    assert isinstance(q["layer0"]["W"], QTensor)
    assert not isinstance(q["layer0"]["b"], QTensor)    # 1-D: never
    assert not isinstance(q["head"]["W"], QTensor)      # excluded
    assert q["layer0"]["b"] is tree["layer0"]["b"]


def _jax_flat(tree):
    """A quantized JAX tree by keystr path."""
    is_q = lambda x: type(x).__name__ == "QTensor"  # noqa: E731
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_q)[0]}


def _port_flat(tree):
    from deeplearning4j_tpu_torch.quant.qtensor import _leaves
    return dict(_leaves(tree))


def _vae_jax():
    from deeplearning4j_tpu.nn.layers.special import \
        VariationalAutoencoder as JaxVAE
    conf = (JaxNNC.builder().seed(4).updater(JaxAdam(1e-3)).list()
            .layer(JaxVAE(n_out=6, encoder_layer_sizes=(12, 10),
                          decoder_layer_sizes=(10,)))
            .layer(JaxOut(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(9)).build())
    return JaxMLN(conf).init()


@pytest.mark.parametrize("kind", ["mln", "graph", "list_valued"])
@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_quantize_tree_matches_jax_on_model_trees(kind, precision):
    """A MultiLayerNetwork's list of dicts, a graph's dict by node name and
    a VAE's list-valued ``enc/0/W`` leaves: the same paths quantized (and
    the same excluded), with the same bytes, as JAX's ``quantize_tree``
    on the same model."""
    jnet = {"mln": _jax_net, "graph": lambda: jax_transformer(n_heads=2),
            "list_valued": _vae_jax}[kind]()
    net = port_of(jnet)
    exclude = {"mln": ("[1]",), "graph": ("P",),
               "list_valued": ("dec",)}[kind]
    jq = _jax_flat(jax_quantize_tree(jnet.params, precision, exclude))
    tq = _port_flat(quantize_tree(net.params, precision, exclude))
    assert sorted(jq) == sorted(tq)
    quantized = [k for k, v in tq.items() if isinstance(v, QTensor)]
    assert quantized and all(type(jq[k]).__name__ == "QTensor"
                             for k in quantized)
    assert all(type(v).__name__ != "QTensor" for k, v in jq.items()
               if k not in quantized)
    for k in quantized:
        _assert_same_codes(jq[k], tq[k])
    assert tree_bytes(quantize_tree(net.params, precision, exclude)) == \
        jax_tree_bytes(jax_quantize_tree(jnet.params, precision, exclude))
    if kind == "list_valued":
        assert "[0]['enc'][0]['W']" in quantized


def test_int8_bytes_ratio():
    rs = np.random.RandomState(1)
    arrays = {"W1": rs.randn(256, 256), "W2": rs.randn(256, 128),
              "b": np.zeros(256)}
    tree = {k: torch.tensor(v, dtype=torch.float32)
            for k, v in arrays.items()}
    jtree = {k: jnp.asarray(v, jnp.float32) for k, v in arrays.items()}
    f32 = tree_bytes(tree)
    q = tree_bytes(quantize_tree(tree, "int8"))
    assert q <= 0.30 * f32, (q, f32)
    assert (f32, q) == (jax_tree_bytes(jtree),
                        jax_tree_bytes(jax_quantize_tree(jtree, "int8")))


def test_error_report_matches_jax():
    w = np.random.RandomState(3).randn(8, 8).astype(np.float32) * 0.5
    tree, jtree = {"W": torch.tensor(w)}, {"W": jnp.asarray(w)}
    rep = quant_error_report(tree, quantize_tree(tree, "int8"))
    want = jax_report(jtree, jax_quantize_tree(jtree, "int8"))
    assert rep.keys() == want.keys()
    for k in rep:
        assert rep[k] == pytest.approx(want[k], rel=1e-6, abs=0)
    assert rep["rel_max"] <= 0.01


def test_qtensor_flows_through_a_program():
    """A quantized leaf read by a program over resident tensors (the
    engines' ``ResidentProgram``), dequantized in its body."""
    w = np.random.RandomState(2).randn(16, 8).astype(np.float32)
    qt = quantize(w, "int8")
    prog = ex.ResidentProgram(ex.get_executor(),
                              lambda res, x: x @ dequantize(res["q"]), "q")
    x = torch.ones(2, 16)
    out = prog({"q": qt, "anchor": torch.zeros(1)}, x)
    want = np.ones((2, 16), np.float32) @ np.asarray(
        jax_dequantize(jax_quantize(jnp.asarray(w), "int8")))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6, rtol=0)
    assert prog.programs == 1


# ------------------------------------------------------- engine integration

@pytest.mark.parametrize("precision,out_bar", [("int8", 0.02),
                                               ("fp8", 0.05)])
def test_engine_parity_and_weight_bytes(precision, out_bar):
    jnet = _jax_net(hidden=64)
    net = port_of(jnet)
    X, _ = _blobs(64)
    e32 = InferenceEngine(net, max_batch=64)
    eq = InferenceEngine(net, max_batch=64, precision=precision)
    y32, yq = e32.predict_host(X), eq.predict_host(X)
    assert float(np.max(np.abs(yq - y32))) <= out_bar
    jq = JaxEngine(jnet, max_batch=64, precision=precision)
    np.testing.assert_allclose(yq, jq.predict_host(X), atol=OUT_TOL, rtol=0)
    assert eq.stats()["precision"] == precision
    assert eq.stats()["weight_bytes"] < e32.stats()["weight_bytes"]
    assert eq.stats()["weight_bytes"] == jq.stats()["weight_bytes"]


def test_f32_engine_path_is_bitwise_unchanged():
    net = port_of(_jax_net(seed=11))
    X, _ = _blobs(32, seed=4)
    plain = InferenceEngine(net, max_batch=32)
    explicit = InferenceEngine(net, max_batch=32, precision="f32")
    assert np.array_equal(plain.predict_host(X), explicit.predict_host(X))
    assert np.array_equal(plain.predict_host(X),
                          net.output(X, bucketed=False).numpy())


def test_eval_accuracy_delta_within_bar():
    """Trained in JAX (15 full-batch steps), served at each precision by
    both packages: the deltas within the documented bars, and the port's
    accuracies the JAX engines'."""
    X, y = _blobs(240)
    jnet = _jax_net()
    onehot = np.eye(3, dtype=np.float32)[y]
    for _ in range(15):
        jnet.fit(JaxDataSet(X, onehot))
    net = port_of(jnet)
    acc, jacc = {}, {}
    for precision in ("f32", "int8", "fp8"):
        e = InferenceEngine(net, max_batch=256, precision=precision)
        acc[precision] = float(np.mean(
            np.argmax(e.predict_host(X), -1) == y))
        je = JaxEngine(jnet, max_batch=256, precision=precision)
        jacc[precision] = float(np.mean(
            np.argmax(je.predict_host(X), -1) == y))
    assert abs(acc["int8"] - acc["f32"]) <= ACC_BARS["int8"], acc
    assert abs(acc["fp8"] - acc["f32"]) <= ACC_BARS["fp8"], acc
    assert acc == jacc


def test_copy_tree_matches_leaves_by_path():
    """``copy_tree`` writes each leaf into the one of the same path, in
    place, whatever the order of the keys and whether a dict is nested or
    flat; a missing path or another shape raises with nothing written."""
    r = np.random.RandomState(0)
    a, b = (torch.tensor(r.randn(4, 4).astype(np.float32)) for _ in "ab")
    c = torch.tensor(r.randn(4, 3).astype(np.float32))
    dst = [{"Wq": torch.zeros(4, 4), "Wk": torch.zeros(4, 4),
            "fwd/W": quantize(torch.ones(4, 3), "int8")}]
    ptrs = [dst[0]["Wq"].data_ptr(), dst[0]["fwd/W"].codes.data_ptr()]
    copy_tree(dst, [{"fwd": {"W": quantize(c, "int8")}, "Wk": b, "Wq": a}])
    assert torch.equal(dst[0]["Wq"], a) and torch.equal(dst[0]["Wk"], b)
    assert torch.equal(dst[0]["fwd/W"].codes, quantize(c, "int8").codes)
    assert [dst[0]["Wq"].data_ptr(),
            dst[0]["fwd/W"].codes.data_ptr()] == ptrs
    before = [t.clone() for t in (dst[0]["Wq"], dst[0]["Wk"])]
    for bad, msg in (([{"Wk": a, "fwd/W": quantize(c, "int8")}], "missing"),
                     ([{"Wk": a, "Wq": torch.zeros(4, 2),
                        "fwd/W": quantize(c, "int8")}], "into"),
                     ([{"Wk": a, "Wq": b, "fwd/W": c}], "into")):
        with pytest.raises(ValueError, match=msg):
            copy_tree(dst, bad)
        assert all(torch.equal(x, y) for x, y in
                   zip(before, (dst[0]["Wq"], dst[0]["Wk"])))


def test_swap_under_quantization_adds_no_program():
    jnet = _jax_net(seed=5)
    net = port_of(jnet)
    X, _ = _blobs(16, seed=1)
    e = InferenceEngine(net, max_batch=16, precision="int8")
    e.predict_host(X)
    before = e.trace_count
    codes = next(v for v in e._weights_set.params[0].values()
                 if isinstance(v, QTensor))
    ptr = codes.codes.data_ptr()
    # the candidate arrives in float32 (the trainer's and the zip's form)
    cand = [{k: v.numpy() * np.float32(1.01) for k, v in p.items()}
            for p in net.params]
    assert e.swap_weights(cand) == 1
    got = e.predict_host(X)
    assert e.trace_count == before and e.model_version == 1
    assert codes.codes.data_ptr() == ptr        # written in place
    je = JaxEngine(jnet, max_batch=16, precision="int8")
    je.swap_weights(jax.tree_util.tree_map(
        lambda a: np.asarray(a) * np.float32(1.01), jnet.params))
    np.testing.assert_allclose(got, je.predict_host(X), atol=OUT_TOL, rtol=0)
    bad = [{k: np.zeros((2, 2), np.float32) for k in p} for p in cand]
    with pytest.raises(WeightSwapError):
        e.swap_weights(bad)
    np.testing.assert_array_equal(e.predict_host(X), got)
    assert e.model_version == 1


def _charlstm():
    jnet = build_model("charlstm")
    return jnet, port_of(jnet)


def _serve(eng, prompt, n):
    eng.start()
    try:
        return eng.generate(prompt, max_new_tokens=n, timeout=120)
    finally:
        eng.stop()


def test_decode_engine_one_program_per_precision():
    jnet, net = _charlstm()
    e32 = DecodeEngine(net, slots=2, max_len=32)
    e8 = DecodeEngine(net, slots=2, max_len=32, precision="int8")
    r32 = _serve(e32, [3, 1, 4], 6)
    r8 = _serve(e8, [3, 1, 4], 6)
    assert e32.trace_count == 1 and e8.trace_count == 1
    assert len(r8["tokens"]) == 6
    st8 = e8.stats()
    assert st8["precision"] == "int8"
    assert st8["weight_bytes"] < e32.stats()["weight_bytes"]
    assert all(p["precision"] == "int8" for k, p in
               e8.program_stats().items() if k != "cow")
    j8 = JaxDecode(jnet, slots=2, max_len=32, precision="int8").start()
    try:
        want = j8.generate([3, 1, 4], max_new_tokens=6)["tokens"]
        assert st8["weight_bytes"] == j8.stats()["weight_bytes"]
    finally:
        j8.stop()
    assert r8["tokens"] == want
    assert len(r32["tokens"]) == 6


def test_decode_swap_under_quantization_adds_no_program():
    jnet, net = _charlstm()
    e = DecodeEngine(net, slots=2, max_len=32, precision="int8").start()
    try:
        e.generate([3, 1, 4], max_new_tokens=4, timeout=120)
        before = e.trace_count
        e.swap_weights([{k: v.numpy() for k, v in p.items()}
                        for p in net.params])
        out = e.generate([3, 1, 4], max_new_tokens=4, timeout=120)
        with pytest.raises(WeightSwapError):
            e.swap_weights([{k: v.numpy()[..., :1] for k, v in p.items()}
                            for p in net.params])
    finally:
        e.stop()
    assert e.trace_count == before and e.model_version == 1
    assert len(out["tokens"]) == 4


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_quantized_decode_tokens_match_jax(precision, kv):
    """A TinyTransformer at int8 / fp8 on the port's dense and paged
    engines: greedy tokens equal the JAX engine's at the same precision,
    and the migration envelope carries the precision."""
    jnet = jax_transformer(n_heads=2)
    net = port_of(jnet)
    ps = prompts((3, 7, 12), seed=4)
    kw = dict(slots=4, max_len=64, precision=precision, kv=kv,
              kv_block_size=16)
    if kv == "paged":
        kw["prefix_cache"] = True
    eng = DecodeEngine(net, **kw).start()
    jeng = JaxDecode(jnet, **kw).start()
    try:
        got = [eng.generate(p, max_new_tokens=8, timeout=120)["tokens"]
               for p in ps]
        want = [jeng.generate(p, max_new_tokens=8)["tokens"] for p in ps]
        if kv == "paged":
            assert eng._migrate_envelope()["precision"] == precision
            assert eng._migrate_envelope()["model_sig"] == \
                jeng._migrate_envelope()["model_sig"]
    finally:
        eng.stop()
        jeng.stop()
    assert got == want
    assert eng.trace_count == 1


@pytest.mark.parametrize("mode", ["self_int8", "self_fp8", "draft_int8"])
def test_quantized_drafts_keep_the_plain_tokens(mode):
    """``SpecConfig(self_draft="int8" | "fp8")`` and a seed-3 draft with
    ``draft_precision="int8"``: the emitted tokens equal the plain
    engine's (greedy and sampled), and the JAX engine's greedy ones; the
    draft reads its own quantized set."""
    jt = jax_transformer(n_heads=2)
    net = port_of(jt)
    if mode == "draft_int8":
        jd = jax_transformer(seed=3, n_layers=1, d_model=16, n_heads=2)
        spec = SpecConfig(port_of(jd), tree=(2, 2), draft_precision="int8")
        jspec = JaxSpec(jd, tree=(2, 2), draft_precision="int8")
        dprec = "int8"
    else:
        dprec = mode.split("_")[1]
        spec = SpecConfig(self_draft=dprec, k=3)
        jspec = JaxSpec(self_draft=dprec, k=3)
    ps = prompts((4, 9), seed=6)
    reqs = [(p, 0.0, 0) for p in ps] + [(ps[0], 0.9, 123)]
    plain = DecodeEngine(net, slots=2, max_len=64).start()
    eng = DecodeEngine(net, slots=2, max_len=64, spec=spec).start()
    jeng = JaxDecode(jt, slots=2, max_len=64, spec=jspec).start()
    try:
        want = [plain.generate(p, 10, seed=s, temperature=t,
                               timeout=120)["tokens"] for p, t, s in reqs]
        got = [eng.generate(p, 10, seed=s, temperature=t,
                            timeout=120)["tokens"] for p, t, s in reqs]
        jgot = [jeng.generate(p, max_new_tokens=10)["tokens"] for p in ps]
        st = eng.stats()["spec"]
    finally:
        plain.stop()
        eng.stop()
        jeng.stop()
    assert got == want
    assert got[:len(ps)] == jgot
    assert st["draft_precision"] == dprec and st["drafted_tokens"] > 0
    assert eng.program_stats()["draft"]["precision"] == dprec


def test_executor_precision_policy_reaches_engines(monkeypatch):
    old = ex.get_executor()
    try:
        ex.set_executor(ex.Executor(precision="int8"))
        net = port_of(_jax_net(seed=9))
        e = InferenceEngine(net, max_batch=8)
        assert e.precision == "int8" and e.stats()["precision"] == "int8"
        _, lstm = _charlstm()
        d = DecodeEngine(lstm, slots=2, max_len=16)
        assert d.precision == "int8" and d.stats()["precision"] == "int8"
        monkeypatch.setenv("DL4JTPU_PRECISION", "e4m3")
        assert ex.Executor().precision == "fp8"
        assert jex.Executor().precision == "fp8"
        assert ex.Executor().prepare_params({"W": torch.ones(2, 2)},
                                            "f32")["W"].dtype == torch.float32
    finally:
        ex.set_executor(old)
