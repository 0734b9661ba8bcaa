"""The port's entry points take the JAX package's positional calls.

Each call below is made the way the JAX package's tests make it, and its
result is held against the keyword form: ``generate_naive(net, p, n,
max_len)`` (and its ``ValueError`` past ``max_len``), ``output(x, False)``
and ``output(x, train=False)`` on both containers,
``restore_multi_layer_network(path, False)`` /
``restore_computation_graph(path, False)`` and the containers' ``load``,
``DecodeEngine(model, slots, max_len, eos_id, max_queue, precision,
kv)`` and ``InferenceEngine(model, max_batch, min_bucket, precision)``;
the serving entry points' parameters, the data-parallel ones
(``parallel``, ``scaleout``, the mesh, ``scaled_dot_product_attention``),
the elastic cluster's (``exec.elastic``, ``exec.comms``, ``exec.worker``,
``exec.cluster``; the port adds a keyword-only ``device``),
and the public names of ``monitor`` and ``exec.programs``, are the JAX
package's.
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


def test_decode_engine_takes_the_jax_positional_order(nets, tmp_path):
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
    # warmup(aot=) with no artifact at the path: a miss, traced and saved
    eng = DecodeEngine(lstm, 2, 24)
    art = str(tmp_path / "lstm.aot.zip")
    assert eng.warmup(art) == eng.warmup_seconds
    assert (eng.trace_count, eng.aot_restores) == (1, 0)
    again = DecodeEngine(lstm, 2, 24)
    again.warmup(art)
    assert (again.trace_count, again.aot_restores) == (0, 1)


def test_inference_engine_takes_the_jax_positional_order(nets, tmp_path):
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
    # warmup's arguments in the JAX order, aot fifth
    art = str(tmp_path / "tiny.aot.zip")
    traced = InferenceEngine(tiny, 4)
    assert traced.warmup((6, V), np.float32, None, None, art) == [1, 2, 4]
    restored = InferenceEngine(tiny, 4)
    restored.warmup((6, V), np.float32, None, None, art)
    assert (traced.trace_count, restored.trace_count,
            restored.aot_restores) == (3, 0, 3)
    assert np.array_equal(traced.predict_host(x), restored.predict_host(x))


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


def _norm(v):
    """A default comparable across packages: a function by its name, a
    dataclass instance (``DEFAULT_POLICY``) by its type and fields."""
    import dataclasses
    if callable(v) and hasattr(v, "__name__"):
        return v.__name__
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, tuple(
            (f.name, _norm(getattr(v, f.name)))
            for f in dataclasses.fields(v)))
    return v


# each fleet entry point: (port module, JAX module, attribute, method,
# the port's own extra parameters after the JAX ones)
FLEET_ENTRIES = {
    "Router.__init__": ("serving.router", "Router", "__init__", []),
    "ReplicaProcess.__init__": ("serving.replica", "ReplicaProcess",
                                "__init__", [("device", "cuda")]),
    "Autoscaler.__init__": ("serving.autoscale", "Autoscaler", "__init__",
                            []),
    "RetryPolicy": ("resilience.retry", "RetryPolicy", None, []),
    "retry_call": ("resilience.retry", "retry_call", None, []),
    "AotBundle.__init__": ("exec.aot", "AotBundle", "__init__", []),
}


@pytest.mark.parametrize("entry", sorted(FLEET_ENTRIES))
def test_fleet_entry_points_take_the_jax_positions(entry):
    """The router's, the replica handle's, the autoscaler's, the retry
    primitive's and the AOT bundle's parameters sit where the JAX package
    puts them, with its defaults; the replica handle adds ``device``
    last (its ``--device``)."""
    import importlib
    import inspect
    mod, attr, meth, extra = FLEET_ENTRIES[entry]

    def params(pkg):
        obj = getattr(importlib.import_module(f"{pkg}.{mod}"), attr)
        if meth is not None:
            obj = getattr(obj, meth)
        return [(p.name, _norm(p.default))
                for p in inspect.signature(obj).parameters.values()]
    ours = params("deeplearning4j_tpu_torch")
    theirs = params("deeplearning4j_tpu")
    assert ours == theirs + extra


# each data-parallel entry point: (port module, attribute, method or None,
# the port's own extra parameters after the JAX ones)
PARALLEL_ENTRIES = {
    "ParallelWrapper.__init__": ("parallel.wrapper", "ParallelWrapper",
                                 "__init__", []),
    "ParallelWrapper.fit": ("parallel.wrapper", "ParallelWrapper", "fit",
                            []),
    "ParallelWrapper.fit_scan": ("parallel.wrapper", "ParallelWrapper",
                                 "fit_scan", []),
    "wrapper.default_mesh": ("parallel.wrapper", "default_mesh", None,
                             [("device", None)]),
    "ParallelInference.__init__": ("parallel.inference",
                                   "ParallelInference", "__init__", []),
    "ParallelInference.output": ("parallel.inference", "ParallelInference",
                                 "output", []),
    "ParallelInference.submit": ("parallel.inference", "ParallelInference",
                                 "submit", []),
    "initialize": ("parallel.distributed", "initialize", None,
                   [("backend", None), ("device", None)]),
    "pod_mesh": ("parallel.distributed", "pod_mesh", None, []),
    "local_batch_slice": ("parallel.distributed", "local_batch_slice", None,
                          []),
    "set_topology": ("parallel.distributed", "set_topology", None, []),
    "build_mesh": ("exec.mesh", "build_mesh", None, []),
    "host_device_env": ("exec.mesh", "host_device_env", None, []),
    "set_default_mesh": ("exec.mesh", "set_default_mesh", None, []),
    "threshold_encode": ("parallel.compression", "threshold_encode", None,
                         []),
    "threshold_decode": ("parallel.compression", "threshold_decode", None,
                         []),
    "adapt_threshold": ("parallel.compression", "adapt_threshold", None,
                        []),
    "EncodingHandler.__init__": ("parallel.compression", "EncodingHandler",
                                 "__init__", []),
    "EncodedGradientsAccumulator.__init__": (
        "parallel.compression", "EncodedGradientsAccumulator", "__init__",
        []),
    "repartition": ("scaleout.cluster", "repartition", None, []),
    "ParameterAveragingTrainingMaster.__init__": (
        "scaleout.training_master", "ParameterAveragingTrainingMaster",
        "__init__", []),
    "SharedTrainingMaster.__init__": (
        "scaleout.training_master", "SharedTrainingMaster", "__init__", []),
    "SharedTrainingMaster.execute_training_collective": (
        "scaleout.training_master", "SharedTrainingMaster",
        "execute_training_collective", []),
    "ClusterMultiLayerNetwork.fit": ("scaleout.cluster",
                                     "ClusterMultiLayerNetwork", "fit", []),
    "scaled_dot_product_attention": ("nn.layers.attention",
                                     "scaled_dot_product_attention", None,
                                     []),
}


@pytest.mark.parametrize("entry", sorted(PARALLEL_ENTRIES))
def test_parallel_entry_points_take_the_jax_positions(entry):
    """The data-parallel modules' parameters (parallel/, scaleout/, the
    mesh, the q / k offsets of ``scaled_dot_product_attention``) sit where
    the JAX package puts them, with its defaults; ``initialize`` adds the
    keyword-only ``backend`` and ``device``, the wrapper's
    ``default_mesh`` a ``device``."""
    import importlib
    import inspect
    mod, attr, meth, extra = PARALLEL_ENTRIES[entry]

    def params(pkg):
        obj = getattr(importlib.import_module(f"{pkg}.{mod}"), attr)
        if meth is not None:
            obj = getattr(obj, meth)
        return [(p.name, _norm(p.default))
                for p in inspect.signature(obj).parameters.values()]
    assert params("deeplearning4j_tpu_torch") == \
        params("deeplearning4j_tpu") + extra


# each elastic-cluster entry point: (port module, attribute, method or
# None, the port's own extra parameters after the JAX ones)
CLUSTER_ENTRIES = {
    "ElasticCoordinator.__init__": ("exec.elastic", "ElasticCoordinator",
                                    "__init__", []),
    "ElasticCoordinator.contribute": ("exec.elastic", "ElasticCoordinator",
                                      "contribute", []),
    "CoordinatorServer.__init__": ("exec.elastic", "CoordinatorServer",
                                   "__init__", []),
    "ChainComms.__init__": ("exec.comms", "ChainComms", "__init__", []),
    "ChainComms.configure": ("exec.comms", "ChainComms", "configure", []),
    "ChainComms.allreduce": ("exec.comms", "ChainComms", "allreduce", []),
    "ThresholdCodec.__init__": ("exec.comms", "ThresholdCodec", "__init__",
                                []),
    "bucketize": ("exec.comms", "bucketize", None, []),
    "encode_bucket": ("exec.comms", "encode_bucket", None, []),
    "decode_bucket": ("exec.comms", "decode_bucket", None, []),
    "CoordClient.__init__": ("exec.worker", "CoordClient", "__init__", []),
    "ElasticWorker.__init__": ("exec.worker", "ElasticWorker", "__init__",
                               [("device", "cuda")]),
    "synth_batch": ("exec.worker", "synth_batch", None, []),
    "params_digest": ("exec.worker", "params_digest", None, []),
    "single_process_reference": ("exec.worker", "single_process_reference",
                                 None, [("device", "cuda")]),
    "worker.main": ("exec.worker", "main", None, []),
    "WorkerProcess.__init__": ("exec.cluster", "WorkerProcess", "__init__",
                               [("device", "cuda")]),
    "ClusterManager.__init__": ("exec.cluster", "ClusterManager",
                                "__init__", [("device", "cuda")]),
    "ClusterManager.run": ("exec.cluster", "ClusterManager", "run", []),
}


@pytest.mark.parametrize("entry", sorted(CLUSTER_ENTRIES))
def test_cluster_entry_points_take_the_jax_positions(entry):
    """The elastic cluster's parameters (exec/elastic.py, exec/comms.py,
    exec/worker.py, exec/cluster.py) sit where the JAX package puts them,
    with its defaults; the worker, its process handle, the manager and
    the single-process oracle add a keyword-only ``device`` last."""
    import importlib
    import inspect
    mod, attr, meth, extra = CLUSTER_ENTRIES[entry]

    def params(pkg):
        obj = getattr(importlib.import_module(f"{pkg}.{mod}"), attr)
        if meth is not None:
            obj = getattr(obj, meth)
        return list(inspect.signature(obj).parameters.values())
    ours, theirs = params("deeplearning4j_tpu_torch"), params(
        "deeplearning4j_tpu")
    assert [(p.name, _norm(p.default)) for p in ours] == \
        [(p.name, _norm(p.default)) for p in theirs] + extra
    assert [p.kind for p in ours[:len(theirs)]] == [p.kind for p in theirs]
    assert all(p.kind == p.KEYWORD_ONLY for p in ours[len(theirs):])


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
