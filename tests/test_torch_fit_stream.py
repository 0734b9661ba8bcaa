"""The fit contract's stream in the port -- chunk boundaries, the listeners'
call sequence, device prefetch and the pipeline timer -- held against the
JAX package's containers on the CPU.

The nets are tests/test_torch_training.py's (vocab 9, 2 x LSTM(16),
softmax RnnOutputLayer, Adam(1e-3), T=8) and a chain graph of the same
layers, the JAX net's initial parameters carried over; batches are
numpy-seeded and the chunk cap is set on both instances
(``_CHUNK_MAX_STEPS = 3``) so an epoch of 8 batches streams as chunks of
3, 3 and 2 steps. Tolerances are test_torch_training.py's: parameters
2e-6 absolute, scores 1e-6 relative. Prefetch depths and the chunking
itself change no bit: the port's parameters are compared with
``torch.equal``.
"""

import logging

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.data.iterators import \
    ListDataSetIterator as JaxListIterator
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.optimize import listeners as jlisteners
from deeplearning4j_tpu.util.timing import PipelineTimer as JaxTimer

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.data.prefetcher import DevicePrefetcher
from deeplearning4j_tpu_torch.monitor import get_registry, trace
from deeplearning4j_tpu_torch.optimize import (CollectScoresIterationListener,
                                               PerformanceListener,
                                               ScoreIterationListener)
from deeplearning4j_tpu_torch.util.timing import PipelineTimer

from test_torch_regularised_training import port_of
from test_torch_training import B, T, V, _batch, _jax_conf, _params_close

CHUNK, BATCHES = 3, 8
LOSS_RTOL = 1e-6


def _graph_conf(tbptt=None):
    """_jax_conf's layers as a chain graph (JAX)."""
    conf = _jax_conf()
    g = (JaxNNC.builder().seed(7).updater(JaxAdam(1e-3))
         .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0)
         .graph_builder().add_inputs("in")
         .set_input_types(JaxInputType.recurrent(V)))
    prev = "in"
    for i, l in enumerate(conf.layers):
        g.add_layer(f"l{i}", l, prev)
        prev = f"l{i}"
    if tbptt:
        g.backprop_type("tbptt", tbptt, tbptt)
    return g.set_outputs(prev).build()


def _pair(container, tbptt=None):
    jnet = (JaxCG(_graph_conf(tbptt)) if container == "graph"
            else JaxMLN(_jax_conf(tbptt))).init()
    net = port_of(jnet)
    jnet._CHUNK_MAX_STEPS = net._CHUNK_MAX_STEPS = CHUNK
    return jnet, net


def _iters(seed=0, shuffle=True):
    x, y = _batch(seed, n=B * BATCHES)
    return (JaxListIterator(JaxDataSet(x, y), B, shuffle=shuffle, seed=3),
            ListDataSetIterator(DataSet(x, y), B, shuffle=shuffle, seed=3))


def _graph_params_close(jnet, net):
    for n, p in jnet.params.items():
        for k, v in p.items():
            np.testing.assert_allclose(net.params[n][k].numpy(),
                                       np.asarray(v), rtol=0, atol=2e-6,
                                       err_msg=f"{n}/{k}")


class Recorder:
    """A listener of either package: every call, and the score (read)."""

    def __init__(self):
        self.calls, self.scores, self.ends = [], [], []

    def iteration_done(self, model, iteration, epoch):
        self.calls.append((iteration, epoch))
        self.scores.append(float(model.get_score()))

    def on_epoch_end(self, model):
        self.ends.append((model.iteration, model.epoch))


def _mixed_stream(kinds):
    """Batches of two lengths, some masked, in one list per package."""
    out = {"jax": [], "port": []}
    for i, (t, masked) in enumerate(kinds):
        x, y = _batch(20 + i, t=t)
        m = np.ones((B, t), np.float32) if masked else None
        out["jax"].append(JaxDataSet(x, y, m, m))
        out["port"].append(DataSet(x, y, m, m))
    return out


KINDS = [(T, False)] * 4 + [(T, True)] + [(T, False)] * 2 + [(6, False)] * 3 \
    + [(6, True)] + [(T, False)]


def _summary(item):
    kind, payload = item
    if kind == "chunk":
        xs, ys = payload
        if isinstance(xs, list):
            return kind, [np.shape(a) for a in xs], [np.shape(a) for a in ys]
        return kind, np.shape(xs), np.shape(ys)
    if hasattr(payload, "features_masks"):
        masked = any(m is not None for m in payload.features_masks or ())
        return kind, [np.shape(a) for a in payload.features], masked
    return kind, np.shape(payload.features), payload.features_mask is not None


@pytest.mark.parametrize("container,tbptt", [("mln", None), ("mln", 4),
                                             ("graph", None), ("graph", 4)])
def test_stream_chunks_match_jax(container, tbptt):
    """Runs of mask-free same-shape batches stack into chunks of at most
    3; a masked batch, a shape change, a lone batch and every batch of a
    tBPTT net stand alone, as in the JAX stream."""
    jnet, net = _pair(container, tbptt)
    data = _mixed_stream(KINDS)
    want = [_summary(i) for i in jnet._stream_chunks(data["jax"], None,
                                                     JaxTimer())]
    got = [_summary(i) for i in net._stream_chunks(data["port"],
                                                   PipelineTimer())]
    assert got == want
    kinds = [k for k, *_ in got]
    assert kinds.count("chunk") == (0 if tbptt else 3)
    # resume: skipped batches are pulled and dropped, chunks start after
    skipped = [_summary(i) for i in net._stream_chunks(
        data["port"], PipelineTimer(), skip_batches=2)]
    jskipped = [_summary(i) for i in jnet._stream_chunks(
        data["jax"], None, JaxTimer(), skip_batches=2)]
    assert skipped == jskipped


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_listeners_see_the_jax_call_sequence(container, caplog):
    """iteration_done once a chunk (iterations 3, 6, 8, 11, ...), then
    on_epoch_end, with the JAX scores; the score listener logs the same
    iterations; the parameters end within tolerance."""
    jnet, net = _pair(container)
    jrec, rec = Recorder(), Recorder()
    jnet.set_listeners(jrec, jlisteners.ScoreIterationListener(3))
    net.set_listeners(rec).add_listeners(ScoreIterationListener(3))
    jit, it = _iters()
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu"):
        jnet.fit(jit, epochs=2)
        jlines = [r.getMessage().split(" is ")[0] for r in caplog.records]
        caplog.clear()
        net.fit(it, epochs=2)
        lines = [r.getMessage().split(" is ")[0] for r in caplog.records]
    assert rec.calls == jrec.calls == [(3, 0), (6, 0), (8, 0), (11, 1),
                                       (14, 1), (16, 1)]
    assert rec.ends == jrec.ends == [(8, 1), (16, 2)]
    np.testing.assert_allclose(rec.scores, jrec.scores, rtol=LOSS_RTOL)
    assert lines == jlines == ["Score at iteration 3", "Score at iteration 6"]
    if container == "graph":
        _graph_params_close(jnet, net)
    else:
        _params_close(jnet, net)
    assert net.iteration == jnet.iteration == 16
    assert net.epoch == jnet.epoch == 2 and net._epoch_batch == 0


def test_tbptt_and_masked_batches_fire_once_a_batch():
    """A tBPTT batch is one _fit_batch: one call, whatever its chunks."""
    jnet, net = _pair("mln", tbptt=4)
    jrec, rec = Recorder(), Recorder()
    jnet.set_listeners(jrec)
    net.set_listeners(rec)
    jit, it = _iters(seed=4, shuffle=False)
    jnet.fit(jit)
    net.fit(it)
    assert rec.calls == jrec.calls == [(i, 0) for i in range(1, 9)]
    np.testing.assert_allclose(rec.scores, jrec.scores, rtol=LOSS_RTOL)
    _params_close(jnet, net)


def _fit_with(prefetch, container="mln"):
    _, net = _pair(container)
    net.fit(_iters()[1], epochs=2, prefetch=prefetch)
    return net


def _flat(net):
    """Every parameter tensor, by layer and key."""
    items = net.params.items() if isinstance(net.params, dict) \
        else enumerate(net.params)
    return [p[k] for _, p in items for k in sorted(p)]


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_prefetch_depths_change_no_bit(container):
    """Depths 0, 1, 2 and the class default train the same bits; the
    timer's stages land in last_pipeline_stats and the registry."""
    nets = [_fit_with(d, container) for d in (0, 1, 2, None)]
    for other in nets[1:]:
        assert all(torch.equal(a, b)
                   for a, b in zip(_flat(nets[0]), _flat(other)))
        assert other.iteration == nets[0].iteration == 16
    stats = nets[2].last_pipeline_stats
    assert {"wall_sec", "host_stall_frac", "fetch_sec", "stack_sec",
            "h2d_sec", "wait_sec", "step_sec"} <= set(stats)
    assert 0.0 <= stats["host_stall_frac"] <= 1.0
    assert "h2d_sec" not in nets[0].last_pipeline_stats
    reg = get_registry()
    assert reg.get("dl4jtpu_pipeline_stage_seconds_total").labels(
        path="fit", stage="step").value > 0
    # the gauge holds the last epoch's value (the last net's)
    assert reg.get("dl4jtpu_pipeline_host_stall_frac").labels(
        path="fit").value == pytest.approx(
            nets[-1].last_pipeline_stats["host_stall_frac"], abs=1e-4)


def test_prefetcher_keeps_items_staged_mid_stream():
    """buffered >= 1 until the last item; leaves become tensors, DataSets
    and nesting survive, and each staging is timed as h2d."""
    x, y = _batch(0)
    items = [("batch", DataSet(x, y)), ("chunk", (x[None], y[None])),
             {"k": [x]}, ("batch", DataSet(x, y, x[..., 0], None))]
    timer = PipelineTimer()
    pf = DevicePrefetcher(items, depth=2, device="cpu", timer=timer)
    got, staged = [], []
    for item in pf:
        got.append(item)
        staged.append(pf.buffered)
    assert staged == [2, 2, 1, 0]
    assert isinstance(got[0][1], DataSet)
    assert torch.equal(got[0][1].features, torch.from_numpy(x))
    assert got[1][1][0].shape == (1,) + x.shape
    assert torch.equal(got[2]["k"][0], torch.from_numpy(x))
    assert got[3][1].labels_mask is None
    assert timer.counts["h2d"] == 4
    assert len(list(DevicePrefetcher(items, device="cpu"))) == 4


def test_pipeline_timer_matches_jax():
    """The same stall rule, summary keys and rounding as the JAX timer."""
    for seconds in ({"wait": 0.25, "fetch": 0.5, "step": 0.2},
                    {"fetch": 0.1, "decode": 0.05, "h2d": 0.05}):
        j, p = JaxTimer(), PipelineTimer()
        for t in (j, p):
            for k, v in seconds.items():
                t.add(k, v)
            t.wall = 1.0
        assert p.summary() == j.summary()
    assert PipelineTimer().host_stall_frac() is None


def test_collect_scores_reads_the_score_only_when_read():
    """CollectScores keeps the score tensors; get_score is called by no
    listener on a step whose line is not due or not emitted."""
    _, net = _pair("mln")
    reads = []
    get_score = net.get_score
    net.get_score = lambda: reads.append(1) or get_score()
    collect = CollectScoresIterationListener(1)
    perf = PerformanceListener(frequency=3)
    net.set_listeners(collect, perf, ScoreIterationListener(1))
    logging.getLogger("deeplearning4j_tpu").setLevel(logging.WARNING)
    try:
        net.fit(_iters()[1])
    finally:
        logging.getLogger("deeplearning4j_tpu").setLevel(logging.NOTSET)
    assert reads == []
    assert [i for i, _ in collect.scores] == [3, 6, 8]
    assert all(isinstance(s, float) and np.isfinite(s)
               for _, s in collect.scores)
    assert collect.scores[-1][1] == float(net._score)
    assert get_registry().get("dl4jtpu_listener_samples_per_sec").value > 0


def test_fit_scan_fires_once_and_records_its_last_input():
    jnet, net = _pair("mln")
    jrec, rec = Recorder(), Recorder()
    jnet.set_listeners(jrec)
    net.set_listeners(rec)
    x, y = _batch(5, n=3 * B)
    xs, ys = x.reshape(3, B, T, V), y.reshape(3, B, T, V)
    jnet.fit_scan(xs, ys)
    net.fit_scan(xs, ys)
    assert rec.calls == jrec.calls == [(3, 0)]
    assert torch.equal(net._last_input, torch.from_numpy(xs[-1]))


def test_trace_spans_nest_the_stream_stages():
    """With tracing on, each consumer iteration is a train_step span that
    nests its wait and step; nothing is recorded while it is off."""
    _, net = _pair("mln")
    trace.clear()
    net.fit(_iters()[1])
    assert trace.events() == []
    trace.enable()
    try:
        net.fit(_iters()[1])
    finally:
        trace.enable(False)
    names = [(e["ph"], e["name"]) for e in trace.export()["traceEvents"]]
    trace.clear()
    assert names[0] == ("B", "train_step")
    assert names.count(("B", "train_step")) == 4      # 3 chunks + the end
    assert ("B", "h2d") in names and ("B", "callback") not in names
    assert names.count(("B", "wait")) == names.count(("E", "wait")) == 4


def test_registry_renders_like_jax():
    """The same families, labels and records render the same Prometheus
    text in both packages; a gauge set to a tensor is read at render."""
    from deeplearning4j_tpu.monitor.metrics import MetricsRegistry as JaxReg
    from deeplearning4j_tpu_torch.monitor import MetricsRegistry
    texts = []
    for reg, value in ((JaxReg(), 0.25), (MetricsRegistry(),
                                           torch.tensor(0.25))):
        reg.counter("x_total", "things", ("path",)).labels(path="fit").inc(3)
        g = reg.gauge("y", "a level")
        g.set(value)
        h = reg.histogram("z_seconds", "times", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 2.0):
            h.observe(v)
        texts.append(reg.render())
        assert h.percentile(0.5) == pytest.approx(0.55)
    assert texts[1] == texts[0]
    assert "y 0.25" in texts[1]
