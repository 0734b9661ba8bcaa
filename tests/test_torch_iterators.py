"""The port's iterator wrappers (data/iterators.py) held against the JAX
package's on the CPU: ExistingDataSetIterator, AsyncDataSetIterator (and
its AsyncMultiDataSetIterator alias), MultipleEpochsIterator and
JointParallelDataSetIterator with each InequalityHandling policy.

Each wrapper is built in both packages over the same arrays and emits the
same batches in the same order (an unordered AsyncDataSetIterator the
same multiset), as tests/test_data_pipeline.py and
tests/test_minor_parity.py hold the JAX ones. A worker's error arrives
after every batch decoded before it; ``_shutdown`` and ``reset()`` stop
workers blocked on a full queue. Every test that starts worker threads
runs under a time bound (``bounded``) and checks that no worker is left
alive. Through ``fit``: an AsyncDataSetIterator with two workers trains a
network bit for bit as its base does, a MultipleEpochsIterator(3, base)
as ``epochs=3`` does (with the device prefetcher and a ``device_side``
scaler found through the wrappers), and a ComputationGraph through
AsyncMultiDataSetIterator as through its base.
"""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.data import iterators as jit

from deeplearning4j_tpu_torch import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                           AsyncMultiDataSetIterator,
                                           DataSet, ExistingDataSetIterator,
                                           InequalityHandling,
                                           JointParallelDataSetIterator,
                                           ListDataSetIterator, MultiDataSet,
                                           MultipleEpochsIterator,
                                           resolve_pre_processor)
from deeplearning4j_tpu_torch.data.normalizers import \
    ImagePreProcessingScaler
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam

BOUND_S = 30.0


def bounded(fn, seconds=BOUND_S):
    """``fn()`` on a thread that must finish within ``seconds``; its
    exception, if any, is raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:      # handed back to the test
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _arrays(n=64, d=4, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(n, d).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[(x.sum(1) > d / 2).astype(int)]


def _bases(n=64, batch=8, seed=0, x=None):
    """The same ListDataSetIterator in the JAX package and in the port."""
    xa, y = _arrays(n, seed=seed)
    x = xa if x is None else x
    return (jit.ListDataSetIterator(jds.DataSet(x, y), batch),
            ListDataSetIterator(DataSet(x, y), batch))


def _features(it):
    return [np.asarray(ds.features) for ds in it]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _no_workers(a):
    assert all(not t.is_alive() for t in a._threads)


# ---- the wrappers against the JAX package's ---------------------------------
def test_existing_iterator_matches_jax():
    x, y = _arrays(24)
    chunks = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 24, 8)]
    j = jit.ExistingDataSetIterator([jds.DataSet(a, b) for a, b in chunks])
    p = ExistingDataSetIterator([DataSet(a, b) for a, b in chunks])
    for _ in range(2):                      # iter() resets
        _same(_features(p), _features(j))


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_async_ordered_matches_jax(workers):
    jb, pb = _bases()

    def run():
        a = AsyncDataSetIterator(pb, queue_size=3, workers=workers)
        got = _features(a)
        a._shutdown()
        return got
    want = _features(jit.AsyncDataSetIterator(jb, queue_size=3,
                                              workers=workers))
    _same(bounded(run), want)


def test_async_unordered_same_multiset():
    jb, pb = _bases()
    want = sorted(f.tobytes() for f in _features(jb))

    def run():
        return _features(AsyncDataSetIterator(pb, queue_size=3, workers=4,
                                              ordered=False))
    assert sorted(f.tobytes() for f in bounded(run)) == want


def test_async_transform_runs_on_the_workers():
    seen = set()

    def tx(ds):
        seen.add(threading.get_ident())
        return DataSet(np.asarray(ds.features) * 2.0, ds.labels)

    jb, pb = _bases()
    got = bounded(lambda: _features(AsyncDataSetIterator(
        pb, queue_size=3, workers=3, transform=tx)))
    _same(got, [f * 2.0 for f in _features(jb)])
    assert seen and threading.get_ident() not in seen


def test_worker_error_after_the_prefix():
    """The batches decoded before a worker's error arrive, in order, then
    the error raises (as the JAX iterator delivers them)."""
    x, _ = _arrays()
    x = x.copy()
    x[3 * 8, 0] = -1.0

    def tx(ds):
        if float(np.asarray(ds.features)[0, 0]) < 0:
            raise ValueError("decode failed")
        return ds

    def collect(a):
        got = []
        with pytest.raises(ValueError, match="decode failed"):
            for b in a:
                got.append(np.asarray(b.features))
        return got
    jb, pb = _bases(x=x)
    want = collect(jit.AsyncDataSetIterator(jb, queue_size=2, workers=2,
                                            transform=tx))
    a = AsyncDataSetIterator(pb, queue_size=2, workers=2, transform=tx)
    got = bounded(lambda: collect(a))
    assert len(got) == 3
    _same(got, want)
    bounded(a._shutdown)
    _no_workers(a)


def test_shutdown_and_reset_under_a_full_queue():
    """Workers blocked putting into a full queue stop promptly on
    ``_shutdown`` and on ``reset()``; the reset pass then emits the whole
    base in order."""
    _, pb = _bases(n=512, batch=4)
    a = AsyncDataSetIterator(pb, queue_size=1, workers=4)
    bounded(lambda: next(iter(a)))
    time.sleep(0.2)                         # every worker blocks in put
    threads = list(a._threads)
    t0 = time.perf_counter()
    bounded(a._shutdown, 10.0)
    assert time.perf_counter() - t0 < 5.0
    assert all(not t.is_alive() for t in threads)
    assert a._threads == [] and a._q is None
    # reset() while workers block on the full queue
    bounded(lambda: next(iter(a)))
    time.sleep(0.2)
    threads = list(a._threads)
    bounded(a.reset, 10.0)
    assert all(not t.is_alive() for t in threads)
    jb, _ = _bases(n=512, batch=4)
    got = bounded(lambda: [np.asarray(next(a).features) for _ in range(128)])
    _same(got, _features(jb))
    bounded(a._shutdown)
    _no_workers(a)


def test_double_reset_and_reuse():
    jb, pb = _bases()
    want = _features(jb)
    a = AsyncDataSetIterator(pb, queue_size=2, workers=2)

    def run():
        a.reset()
        a.reset()
        first = _features(a)
        it = iter(a)
        next(it)
        return first, _features(a)
    first, again = bounded(run)
    _same(first, want)
    _same(again, want)
    bounded(a._shutdown)
    _no_workers(a)


def test_multiple_epochs_matches_jax():
    jb, pb = _bases()
    want = _features(jit.MultipleEpochsIterator(3, jb))
    assert len(want) == 24
    _same(_features(MultipleEpochsIterator(3, pb)), want)
    jb, pb = _bases()
    a = AsyncDataSetIterator(MultipleEpochsIterator(3, pb), queue_size=3,
                             workers=2)
    _same(bounded(lambda: _features(a)), want)
    bounded(a._shutdown)


def _joint(port, sizes, policy):
    """A JointParallelDataSetIterator (the port's, or the JAX package's)
    over producers of ``sizes`` rows in batches of 2, without the async
    prefetch."""
    its = []
    for i, n in enumerate(sizes):
        x, y = _arrays(n, d=3, seed=i)
        its.append(ListDataSetIterator(DataSet(x, y), 2) if port else
                   jit.ListDataSetIterator(jds.DataSet(x, y), 2))
    cls = (JointParallelDataSetIterator if port
           else jit.JointParallelDataSetIterator)
    return cls(its, policy, async_prefetch=False)


def _feed(j, consumers):
    out = []
    for c in consumers:
        ds = j.next_for(c)
        out.append(None if ds is None else np.asarray(ds.features))
    return out


@pytest.mark.parametrize("policy,sizes,consumers", [
    (InequalityHandling.STOP_EVERYONE, (2, 8), (0, 0, 1, 1)),
    (InequalityHandling.PASS_NULL, (2, 6), (0, 0, 1, 1, 1, 1)),
    (InequalityHandling.RESET, (2,), (0, 0, 0, 0)),
    (InequalityHandling.RELOCATE, (2, 8), (0, 0, 0, 1, 1)),
], ids=["stop_everyone", "pass_null", "reset", "relocate"])
def test_joint_parallel_policies_match_jax(policy, sizes, consumers):
    j = _joint(False, sizes, policy)
    p = _joint(True, sizes, policy)
    for it in (j, p):
        it.reset()
    assert p.num_producers == j.num_producers
    want, got = _feed(j, consumers), _feed(p, consumers)
    assert [w is None for w in want] == [g is None for g in got]
    _same([g for g in got if g is not None], [w for w in want
                                              if w is not None])


def test_joint_parallel_round_robin_and_async():
    j = _joint(False, (4, 4), InequalityHandling.PASS_NULL)
    p = _joint(True, (4, 4), InequalityHandling.PASS_NULL)
    _same(_features(p), _features(j))
    with pytest.raises(ValueError):
        JointParallelDataSetIterator([])
    # the default: each producer behind its own async prefetch
    its = [ListDataSetIterator(DataSet(*_arrays(4, d=3, seed=i)), 2)
           for i in range(2)]
    a = JointParallelDataSetIterator(its, InequalityHandling.PASS_NULL)
    got = bounded(lambda: _features(a))
    _same(got, _features(j))
    for prod in a.producers:
        bounded(prod._shutdown)


# ---- through fit ------------------------------------------------------------
def _net(seed=5):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Adam(1e-2)).activation("tanh").list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _equal(a, b):
    return all(torch.equal(p[k], q[k]) for p, q in zip(a.params, b.params)
               for k in p)


def test_fit_through_async_equals_the_base():
    n1, n2 = _net(), _net()
    n1._CHUNK_MAX_STEPS = n2._CHUNK_MAX_STEPS = 3
    n1.fit(_bases(n=96)[1], epochs=2)
    a = AsyncDataSetIterator(_bases(n=96)[1], queue_size=3, workers=2)
    bounded(lambda: n2.fit(a, epochs=2, prefetch=2), 120.0)
    bounded(a._shutdown)
    assert _equal(n1, n2) and n1.iteration == n2.iteration == 24
    assert n2.last_pipeline_stats["host_stall_frac"] is not None


def test_fit_through_multiple_epochs_equals_epochs():
    """A uint8-wire base with a ``device_side`` scaler: the wrappers
    forward it (``resolve_pre_processor`` through ``base``)."""
    x, y = _arrays(96)
    raw = np.round(x * 255).astype(np.uint8)

    def base():
        it = ListDataSetIterator(DataSet(raw, y), 8)
        return it.set_pre_processor(ImagePreProcessingScaler(
            device_side=True))
    n1, n2 = _net(), _net()
    n1.fit(base(), epochs=3)
    wrapped = MultipleEpochsIterator(3, base())
    assert resolve_pre_processor(AsyncDataSetIterator(wrapped)) \
        is wrapped.base.pre_processor
    n2.fit(wrapped)
    assert _equal(n1, n2) and n1.iteration == n2.iteration == 36


def test_graph_fit_through_async_multi_iterator():
    g = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
         .graph_builder().add_inputs("in")
         .set_input_types(InputType.feed_forward(4))
         .add_layer("h", DenseLayer(n_out=6, activation="tanh"), "in")
         .add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                       loss="mcxent"), "h")
         .set_outputs("out").build())
    x, y = _arrays(48)
    batches = [MultiDataSet([x[i:i + 8]], [y[i:i + 8]])
               for i in range(0, 48, 8)]
    g1 = ComputationGraph(g, device="cpu").init()
    g2 = ComputationGraph(g, device="cpu").init()
    g1.fit(ExistingDataSetIterator(batches), epochs=2)
    a = AsyncMultiDataSetIterator(ExistingDataSetIterator(batches),
                                  workers=2)
    bounded(lambda: g2.fit(a, epochs=2), 120.0)
    bounded(a._shutdown)
    assert all(torch.equal(g1.params[n][k], g2.params[n][k])
               for n in g1.params for k in g1.params[n])
