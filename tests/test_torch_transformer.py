"""The port's TinyTransformer slice -- ComputationGraph, attention layers,
dense and paged decode, the decode engine, the checkpoint zip -- held
against the JAX package's, on the CPU.

A small TinyTransformer (2 pre-LN blocks, d_model 32, 4 heads, max_len 64,
an 11-token vocabulary) is built in the JAX package and its initial
weights carried across as numpy arrays. The JAX side runs its Pallas
kernels in interpret mode where its own tests do. Tolerances (float32):
1e-5 on output probabilities (the online softmax of the kernels and the
full softmax of the plain versions sum in different orders); greedy
tokens exactly.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.random import PRNGKey as jax_key

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.graph_conf import MergeVertex as JaxMerge
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers.attention import \
    MultiHeadAttention as JaxMHA
from deeplearning4j_tpu.ops.flash_attention import \
    supported as jax_flash_supported
from deeplearning4j_tpu.ops.flash_decode import \
    supported as jax_decode_supported, supported_paged as jax_paged_supported
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.util import model_serializer as jax_ser
from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny

from deeplearning4j_tpu_torch import ComputationGraph, params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers.attention import MultiHeadAttention
from deeplearning4j_tpu_torch.serving import (DecodeEngine, InferenceClient,
                                              InferenceServer)
from deeplearning4j_tpu_torch.serving.decode import _Request, generate_naive
from deeplearning4j_tpu_torch.serving.kv import (SCRATCH_BLOCK, BlockPool,
                                                 PoolExhaustedError)
from deeplearning4j_tpu_torch.serving.spec import SpecConfig
from deeplearning4j_tpu_torch.util import model_serializer
from deeplearning4j_tpu_torch.zoo import TinyTransformer

V, D, HEADS, MAXLEN = 11, 32, 4, 64
PROB_TOL = 1e-5
SMALL = dict(vocab_size=V, n_layers=2, d_model=D, n_heads=HEADS,
             max_len=MAXLEN)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxCG(JaxTiny(**SMALL).conf()).init()
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = ComputationGraph(conf, device="cpu").set_params(params_from_numpy(
        {n: {k: np.asarray(v) for k, v in p.items()}
         for n, p in jnet.params.items()}, device="cpu"))
    return jnet, net


@pytest.fixture
def jax_kernels_interpreted():
    jops.set_helpers_enabled(True, interpret=True)
    yield
    jops.set_helpers_enabled(None)


def _tokens(B, T, seed=0):
    return np.random.RandomState(seed).randint(0, V, (B, T))


def _onehot(ids):
    return np.eye(V, dtype=np.float32)[ids]


def _close(port, ref, tol=PROB_TOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=tol)


def test_one_configuration_json_in_both_packages():
    jconf = JaxTiny(**SMALL).conf()
    pconf = TinyTransformer(**SMALL).conf()
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert back.topological_order == jconf.topological_order
    assert back.nodes["b1_attn"].layer.n_in == D
    assert back.nodes["b0_ff1"].layer.n_out == 4 * D


def test_unported_vertex_is_named():
    """Every JAX vertex reads now (MergeVertex among them); a vertex type
    the port does not know raises, naming it."""
    g = (JaxNNC.builder().graph_builder().add_inputs("a", "b")
         .set_input_types(JaxInputType.feed_forward(3),
                          JaxInputType.feed_forward(3))
         .add_vertex("m", JaxMerge(), "a", "b")
         .add_layer("d", JaxDense(n_out=2), "m").set_outputs("d").build())
    conf = ComputationGraphConfiguration.from_json(g.to_json())
    assert type(conf.nodes["m"].vertex).__name__ == "MergeVertex"
    with pytest.raises(ValueError, match="NoSuchVertex"):
        ComputationGraphConfiguration.from_json(
            g.to_json().replace('"MergeVertex"', '"NoSuchVertex"'))


def test_port_init_shapes_match_jax_params(nets):
    jnet, _ = nets
    net = TinyTransformer(**SMALL).init(device="cpu")
    assert isinstance(net, ComputationGraph)
    assert sorted(net.params) == sorted(jnet.params)
    for n, p in jnet.params.items():
        assert {k: tuple(v.shape) for k, v in net.params[n].items()} == \
            {k: tuple(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("T", [16, 13])
def test_output_matches_jax(nets, T, jax_kernels_interpreted):
    """T = 16 runs the JAX flash kernel (interpreted), T = 13 its einsum
    path; the port runs K5's plain version at both."""
    jnet, net = nets
    x = _onehot(_tokens(3, T))
    ref = np.asarray(jnet.output(jnp.asarray(x), bucketed=False))
    out = net.output(x)
    assert tuple(out.shape) == (3, T, V)
    _close(out.numpy(), ref)
    _close(net.output(x, bucketed=False).numpy(), ref)


def _tables(B, MB, seed=3):
    NB = B * MB + 1
    r = np.random.RandomState(seed)
    return (r.permutation(NB - 1)[:B * MB] + 1).reshape(B, MB) \
        .astype(np.int32), NB


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_decode_step_matches_jax_step_by_step(nets, kv,
                                              jax_kernels_interpreted):
    """Each step's probabilities against the JAX graph's decode step (its
    flash decode kernels interpreted), and the last step against the
    port's own full forward."""
    jnet, net = nets
    B, steps, bs = 3, 20, 8
    ids = _tokens(B, steps, seed=1)
    if kv == "paged":
        tables, NB = _tables(B, MAXLEN // bs)
        jd = jnet.init_decode_state(B, MAXLEN,
                                    kv={"num_blocks": NB, "block_size": bs})
        pd = net.init_decode_state(B, MAXLEN,
                                   kv={"num_blocks": NB, "block_size": bs})
    else:
        tables = None
        jd, pd = jnet.init_decode_state(B, MAXLEN), \
            net.init_decode_state(B, MAXLEN)
    for t in range(steps):
        pos = np.full(B, t, np.int32)
        x = _onehot(ids[:, t])[:, None, :]
        kw = {} if tables is None else {"block_tables": jnp.asarray(tables)}
        jy, jd = jnet.decode_step(jnet.params, jnet.state, jd,
                                  jnp.asarray(x), jnp.asarray(pos), **kw)
        pkw = {} if tables is None else {
            "block_tables": torch.tensor(tables)}
        py, pd = net.decode_step(net.params, pd, torch.tensor(x),
                                 torch.tensor(pos), **pkw)
        _close(py.numpy(), np.asarray(jy))
    full = net.output(_onehot(ids), bucketed=False).numpy()
    _close(py.numpy()[:, 0], full[:, -1])


@pytest.mark.parametrize("d_model,n_heads", [(64, 16), (512, 2)])
def test_head_dims_the_kernels_do_not_take_match_the_jax_layer(
        d_model, n_heads, jax_kernels_interpreted):
    """Dh = 4 is outside what the attention kernels take, and Dh = 256 is
    past the 128 columns their blocks hold whole. The port's layer screens
    head dims as the JAX layer's flash screens do: Dh = 4 runs both layers'
    own einsum and softmax, Dh = 256 the JAX layer's flash kernels
    (interpreted) and the port's kernel wrappers (their plain versions
    here; on the card the kernels' column-chunk split). The forward, and
    dense and paged decode steps, against the JAX layer from the same
    random parameters."""
    jl = JaxMHA(n_in=d_model, n_out=d_model, n_heads=n_heads, causal=True)
    layer = MultiHeadAttention(n_in=d_model, n_out=d_model, n_heads=n_heads,
                               causal=True)
    B, T, C, bs = 3, 16, 16, 8
    Dh = d_model // n_heads
    assert jax_flash_supported(T, Dh) == jax_decode_supported(C, Dh) \
        == jax_paged_supported(bs, Dh) == layer.flash_supported() \
        == (Dh == 256)
    r = np.random.RandomState(7)
    shapes = {k: np.shape(a) for k, a in jl.init(jax_key(0)).items()}
    npp = {k: (r.randn(*shp) / np.sqrt(shp[0])).astype(np.float32)
           for k, shp in shapes.items()}
    jp = {k: jnp.asarray(a) for k, a in npp.items()}
    pp = {k: torch.tensor(a) for k, a in npp.items()}
    x = r.randn(B, T, d_model).astype(np.float32)
    jy, _ = jl.apply(jp, jnp.asarray(x))
    _close(layer.apply(pp, torch.tensor(x)).numpy(), np.asarray(jy))

    tables, NB = _tables(B, C // bs)
    jd, pd = jl.init_decode_state(jp, B, C), layer.init_decode_state(pp, B, C)
    jpd = jl.init_paged_decode_state(jp, B, C, NB, bs)
    ppd = layer.init_paged_decode_state(pp, B, C, NB, bs)
    for step in range(3):        # the last step reads rows 0..pos
        pos = np.array([step, step + 4, step + 10], np.int32)
        xs = x[:, step:step + 1]
        jy, jd = jl.decode_step(jp, jd, jnp.asarray(xs), jnp.asarray(pos))
        py, pd = layer.decode_step(pp, pd, torch.tensor(xs),
                                   torch.tensor(pos))
        _close(py.numpy(), np.asarray(jy))
        jy, jpd = jl.decode_step_paged(jp, jpd, jnp.asarray(xs),
                                       jnp.asarray(pos), jnp.asarray(tables))
        py, ppd = layer.decode_step_paged(pp, ppd, torch.tensor(xs),
                                          torch.tensor(pos),
                                          torch.tensor(tables))
        _close(py.numpy(), np.asarray(jy))


def _jax_generate(jnet, prompts, n):
    eng = JaxDecode(jnet, slots=3, max_len=MAXLEN).start()
    try:
        return [eng.generate(p, max_new_tokens=n)["tokens"] for p in prompts]
    finally:
        eng.stop()


def test_greedy_tokens_agree_across_engines_and_packages(nets):
    """The port's dense engine (through /generate), its paged engine with a
    pool too small for every request at once, its full-prefix generator and
    the JAX DecodeEngine give the same greedy tokens."""
    jnet, net = nets
    prompts = [list(map(int, _tokens(1, n, seed=n)[0])) for n in (1, 7, 19,
                                                                   30)]
    n = 10
    want = _jax_generate(jnet, prompts, n)
    dense = DecodeEngine(net, slots=3, max_len=MAXLEN)
    paged = DecodeEngine(net, slots=3, max_len=MAXLEN, kv="paged",
                         kv_block_size=8, kv_blocks=9).start()
    srv = InferenceServer(net, port=0, decode_engine=dense).start()
    try:
        cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
        futs = [paged.submit(p, max_new_tokens=n) for p in prompts]
        got_dense = [cli.generate(p, max_new_tokens=n)["tokens"]
                     for p in prompts]
        got_paged = [f.result(timeout=60)["tokens"] for f in futs]
        kv = paged.stats()["kv"]
    finally:
        srv.stop()
        paged.stop()
    naive = [generate_naive(net, p, n, MAXLEN)["tokens"] for p in prompts]
    assert got_dense == want
    assert got_paged == want
    assert naive == want
    assert kv["blocks_in_use"] == 0 and kv["blocks_free"] == 8
    assert 0 < kv["high_water"] <= 8


def test_paged_engine_keeps_block_zero_out_of_live_tables(nets):
    _, net = nets
    eng = DecodeEngine(net, slots=2, max_len=MAXLEN, kv="paged",
                       kv_block_size=8)
    reqs = [_Request([1, 2, 3], 20, 0, 0.0, 0, None) for _ in range(2)]
    with eng._cv:
        eng._queue.extend(reqs)
        eng._admit_locked()
    assert eng._slot_reqs == reqs
    for i, r in enumerate(reqs):
        assert len(r.kv_blocks) == 3 and 0 not in r.kv_blocks
        assert list(eng._tables[i, :3]) == r.kv_blocks
        assert not eng._tables[i, 3:].any()
    eng._free_slot(0, reqs[0])
    assert not eng._tables[0].any() and eng._pool.in_use == 3


def test_block_pool_refcounts_and_scratch_block():
    pool = BlockPool(4, 8)
    assert pool.usable == 3 and pool.free_count == 3
    a = pool.alloc(2)
    assert SCRATCH_BLOCK not in a and pool.in_use == 2
    with pytest.raises(PoolExhaustedError):
        pool.alloc(2)                   # all or nothing
    assert pool.free_count == 1
    pool.incref(a[0])
    pool.decref(a[0])
    assert pool.in_use == 2             # still held once
    pool.decref(a[0])
    pool.decref(a[1])
    assert pool.in_use == 0 and pool.high_water == 2
    for bad in (lambda: pool.decref(a[0]), lambda: pool.incref(a[1]),
                lambda: pool.decref(SCRATCH_BLOCK),
                lambda: pool.incref(SCRATCH_BLOCK)):
        with pytest.raises(ValueError):
            bad()


def test_predict_through_the_server_matches_jax(nets):
    jnet, net = nets
    x = _onehot(_tokens(5, 12, seed=4))
    ref = np.asarray(jnet.output(jnp.asarray(x), bucketed=False))
    srv = InferenceServer(net, port=0).start()
    try:
        cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
        _close(cli.predict(x), ref)
        with pytest.raises(Exception, match="400|does not match"):
            cli.predict(np.zeros((2, 12, V + 1), np.float32))
    finally:
        srv.stop()


def test_checkpoint_zip_reads_both_ways(nets, tmp_path):
    jnet, net = nets
    x = _onehot(_tokens(2, 9, seed=5))
    ref = np.asarray(jnet.output(jnp.asarray(x), bucketed=False))
    jax_zip = tmp_path / "jax.zip"
    jax_ser.write_model(jnet, jax_zip)
    restored = model_serializer.restore_computation_graph(jax_zip,
                                                          device="cpu")
    _close(restored.output(x).numpy(), ref)
    assert sorted(restored.opt_state["b0_attn"]) == sorted(
        k.split("/", 1)[1] for k in jax_ser._flatten_pytree(
            jnet.opt_state) if k.startswith("b0_attn/"))
    port_zip = tmp_path / "port.zip"
    restored.save(port_zip)
    back = jax_ser.restore_computation_graph(port_zip)
    _close(np.asarray(back.output(jnp.asarray(x), bucketed=False)), ref)
    with pytest.raises(ValueError, match="ComputationGraph"):
        model_serializer.restore_multi_layer_network(port_zip, device="cpu")


@pytest.mark.parametrize("option", ["host_kv_bytes", "self_draft",
                                    "draft_precision"])
def test_unported_engine_options_raise(nets, option):
    """Options once unported (each raised NotImplementedError naming ROADMAP
    queue 1 item 6) that are ported now. ``host_kv_bytes``: the engine
    builds with a host tier of that budget and reports it in
    ``kv_pool_info()``, and refuses it, as the JAX engine does, without
    the prefix cache. ``self_draft="int8"`` and ``draft_precision="fp8"``
    (since the port's quant/): the engine builds, its draft reads a
    quantized set of that precision, and its greedy tokens are the plain
    engine's."""
    _, net = nets
    if option == "host_kv_bytes":
        eng = DecodeEngine(net, kv="paged", host_kv_bytes=1 << 20)
        assert eng.kv_pool_info()["host_tier"] == {
            "blocks": 0, "bytes": 0, "byte_budget": 1 << 20, "spills": 0,
            "drops": 0}
        assert eng.stats()["kv"]["host_restores"] == 0
        with pytest.raises(ValueError, match="host_kv_bytes requires"):
            DecodeEngine(net, kv="paged", prefix_cache=False,
                         host_kv_bytes=1 << 20)
        return
    kw = {"self_draft": ({"spec": SpecConfig(self_draft="int8")}, "int8"),
          "draft_precision": ({"spec": SpecConfig(net, k=2,
                                                  draft_precision="fp8")},
                              "fp8")}
    spec_kw, precision = kw[option]
    eng = DecodeEngine(net, slots=2, max_len=32, kv="paged", **spec_kw)
    plain = DecodeEngine(net, slots=2, max_len=32, kv="paged")
    outs = []
    for e in (eng, plain):
        e.start()
        try:
            outs.append(e.generate([1, 2, 3], max_new_tokens=6,
                                   timeout=120)["tokens"])
        finally:
            e.stop()
    assert outs[0] == outs[1]
    assert eng.stats()["spec"]["draft_precision"] == precision
