"""The port's entry points take the JAX package's positional calls.

Each call below is made the way the JAX package's tests make it, and its
result is held against the keyword form: ``generate_naive(net, p, n,
max_len)`` (and its ``ValueError`` past ``max_len``), ``output(x, False)``
and ``output(x, train=False)`` on both containers,
``restore_multi_layer_network(path, False)`` /
``restore_computation_graph(path, False)`` and the containers' ``load``,
``DecodeEngine(model, slots, max_len, eos_id, max_queue, precision,
kv)`` and ``InferenceEngine(model, max_batch, min_bucket, precision)``;
the serving entry points' parameters, and the public names of ``monitor``
and ``exec.programs``, are the JAX package's.
Outputs and parameters must be identical (``torch.equal``).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import (ComputationGraph,
                                             MultiLayerNetwork)
from deeplearning4j_tpu_torch.serving import DecodeEngine, InferenceEngine
from deeplearning4j_tpu_torch.serving.decode import generate_naive
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_computation_graph, restore_multi_layer_network)
from test_torch_kv_prefix import MAXLEN, V, jax_lstm, jax_transformer
from test_torch_regularised_training import port_of


@pytest.fixture(scope="module")
def nets():
    return port_of(jax_lstm()), port_of(jax_transformer(n_heads=2))


def _x(T=6, B=2, seed=0):
    r = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[r.randint(0, V, (B, T))]


def test_generate_naive_takes_max_len_positionally(nets):
    for net in nets:
        pos = generate_naive(net, [1, 2, 3], 5, MAXLEN)
        kw = generate_naive(net, [1, 2, 3], max_new_tokens=5, max_len=MAXLEN)
        assert pos == kw
        sampled = generate_naive(net, [1, 2, 3], 5, MAXLEN, 9, 0.8, 4)
        assert sampled == generate_naive(net, [1, 2, 3], 5, MAXLEN, seed=9,
                                         temperature=0.8, top_k=4)
        with pytest.raises(ValueError, match="max_len"):
            generate_naive(net, [1, 2, 3], 5, 7)


def test_output_takes_train_positionally(nets):
    lstm, tiny = nets
    x = _x()
    want = lstm.output(x)
    assert torch.equal(lstm.output(x, False), want)
    assert torch.equal(lstm.output(x, train=False), want)
    assert torch.equal(lstm.output(x, False, None, False),
                       lstm.output(x, bucketed=False))
    want = tiny.output(x)
    assert torch.equal(tiny.output(x, train=False), want)
    assert torch.equal(tiny.output(x, train=False, bucketed=False),
                       tiny.output(x, bucketed=False))


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_restore_and_load_take_load_updater_positionally(nets, kind,
                                                         tmp_path):
    net = nets[0] if kind == "mln" else nets[1]
    restore = (restore_multi_layer_network if kind == "mln"
               else restore_computation_graph)
    cls = MultiLayerNetwork if kind == "mln" else ComputationGraph
    path = tmp_path / "m.zip"
    net.save(path)
    for load_updater in (False, True):
        got = [restore(path, load_updater, device="cpu"),
               cls.load(path, load_updater, device="cpu")]
        want = restore(path, load_updater=load_updater, device="cpu")
        for g in got:
            for a, b in ((g.params, want.params),
                         (g.opt_state, want.opt_state)):
                ta, tb = _tensors(a), _tensors(b)
                assert len(ta) == len(tb)
                assert all(torch.equal(u, v) for u, v in zip(ta, tb))


def _tensors(tree):
    out = []
    items = tree.values() if isinstance(tree, dict) else tree
    for p in items:
        for k in sorted(p):
            v = p[k]
            out.extend(_tensors([v]) if isinstance(v, dict) else [v])
    return out


def test_decode_engine_takes_the_jax_positional_order(nets):
    lstm, tiny = nets
    eng = DecodeEngine(lstm, 2, 24, 5, 16, "f32", "dense")
    assert (eng.slots, eng.max_len, eng.eos_id, eng.max_queue, eng.kv) == \
        (2, 24, 5, 16, "dense")
    eng = DecodeEngine(tiny, 2, MAXLEN, None, 16, None, "paged")
    assert eng.kv == "paged" and eng.eos_id is None
    for precision in ("int8", "fp8"):
        assert DecodeEngine(lstm, 2, 24, None, 16, precision).precision == \
            precision
    # not a serving precision in either package (bf16 is a compute dtype)
    with pytest.raises(ValueError, match="unknown precision"):
        DecodeEngine(lstm, 2, 24, None, 16, "bf16")
    with pytest.raises(NotImplementedError, match="item 6"):
        DecodeEngine(lstm, 2, 24).warmup(aot="artifact")


def test_inference_engine_takes_the_jax_positional_order(nets):
    lstm, tiny = nets
    x = _x(B=3)
    for net in nets:
        eng = InferenceEngine(net, 8, 2, "int8")
        assert (eng.max_batch, eng.min_bucket, eng.precision) == \
            (8, 2, "int8")
        kw = InferenceEngine(net, max_batch=8, min_bucket=2,
                             precision="int8")
        assert np.array_equal(eng.predict_host(x), kw.predict_host(x))
        assert eng.stats()["buckets_used"] == [4]      # 3 rows -> rung 4
    with pytest.raises(NotImplementedError, match="item 6"):
        InferenceEngine(tiny).warmup((6, V), aot="artifact")


@pytest.mark.parametrize("entry", ["DecodeEngine.__init__",
                                   "DecodeEngine.submit",
                                   "DecodeEngine.generate",
                                   "MicroBatcher.__init__",
                                   "MicroBatcher.submit",
                                   "MicroBatcher.predict",
                                   "InferenceServer.__init__",
                                   "InferenceClient.__init__",
                                   "InferenceClient.warmup",
                                   "InferenceEngine.__init__",
                                   "InferenceEngine.predict",
                                   "InferenceEngine.predict_host",
                                   "InferenceEngine.predict_stream",
                                   "InferenceEngine.swap_weights",
                                   "InferenceEngine.warmup",
                                   "InferenceEngine.autotune"])
def test_serving_entry_points_take_the_jax_positions(entry):
    """The journal's and the host tier's arguments (``journal_capacity``,
    ``host_kv_bytes``, ``request_id``, ``tenant``, ``priority``), the
    server's (``request_timeout_ms`` eighth, then ``decode_engine``,
    ``fault_injector``, ``health_hook``, ``request_mirror``,
    ``flight_recorder``, ``role``) and the client's (``keep_alive``) sit
    where the JAX package puts them, with its defaults."""
    import inspect

    from deeplearning4j_tpu.serving.batcher import MicroBatcher as JaxBatcher
    from deeplearning4j_tpu.serving.client import \
        InferenceClient as JaxClient
    from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
    from deeplearning4j_tpu.serving.engine import \
        InferenceEngine as JaxEngine
    from deeplearning4j_tpu.serving.server import \
        InferenceServer as JaxServer

    from deeplearning4j_tpu_torch.serving import (InferenceClient,
                                                  InferenceServer,
                                                  MicroBatcher)
    cls, meth = entry.split(".")
    ours = {"DecodeEngine": DecodeEngine, "MicroBatcher": MicroBatcher,
            "InferenceEngine": InferenceEngine,
            "InferenceServer": InferenceServer,
            "InferenceClient": InferenceClient}[cls]
    theirs = {"DecodeEngine": JaxDecode, "MicroBatcher": JaxBatcher,
              "InferenceEngine": JaxEngine, "InferenceServer": JaxServer,
              "InferenceClient": JaxClient}[cls]

    def params(c):
        return [(p.name, p.default) for p in
                inspect.signature(getattr(c, meth)).parameters.values()]
    assert params(ours) == params(theirs)


@pytest.mark.parametrize("module", ["monitor", "exec.programs"])
def test_monitor_and_program_registry_export_the_jax_names(module):
    """Every name of JAX ``monitor.__all__`` and ``exec.programs.__all__``
    imports from the port, and ``monitor`` exports no other."""
    import importlib
    theirs = importlib.import_module(f"deeplearning4j_tpu.{module}")
    ours = importlib.import_module(f"deeplearning4j_tpu_torch.{module}")
    assert sorted(ours.__all__) == sorted(theirs.__all__)
    for name in theirs.__all__:
        assert getattr(ours, name) is not None, name
    from deeplearning4j_tpu_torch import exec as ex
    for name in ("ProgramRegistry", "get_programs", "is_registering"):
        assert getattr(ex, name) is getattr(
            importlib.import_module("deeplearning4j_tpu_torch.exec.programs"),
            name)
    assert ex.get_executor().programs is ex.get_programs()
