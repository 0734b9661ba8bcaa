"""The port's training flight recorder (monitor/flight.py) and its wiring
into both containers' fit paths, held against the JAX package's on the
CPU.

- ``compute_telemetry`` on the same (old, new, grad) triples, drawn with
  numpy from a seed, in both packages: rtol 1e-5 (float32).
- One step of a small LSTM network (2 x LSTM(8), 9 symbols, Adam, the
  element-wise clip) and a small
  TinyTransformer (2 blocks of d_model 32, 4 heads), the same weights
  carried across (``port_of``) and the same batch, each with a recorder:
  the rows agree at rtol 1e-3 on the gradient and update columns and
  1e-5 on ``param_norm``; the non-finite flags are equal. The JAX step
  runs as its own tests run it on the CPU.
- The same rows fed to both ``AnomalyDetector``s raise the same
  anomalies; a spill written by one package is read by the other's
  ``FlightRecorder.restore``.
- Recorder on against off: the parameters are bit for bit equal
  (``torch.equal``) on every fit path (``fit`` batches, ``fit_scan``,
  tBPTT, the graph container, the per-layer updater), with one record a
  sampled step; a NaN planted in one feature of a batch names the first
  non-finite layer in both packages and in the spill.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.monitor import flight as jflight
from deeplearning4j_tpu.monitor.flight import AnomalyDetector as JaxDetector
from deeplearning4j_tpu.monitor.flight import FlightRecorder as JaxRecorder

from deeplearning4j_tpu_torch.monitor import flight
from deeplearning4j_tpu_torch.monitor.flight import (STAT_COLS,
                                                     AnomalyDetector,
                                                     FlightRecorder)
from deeplearning4j_tpu_torch.nn import fused_update
from test_torch_regularised_training import (SMALL_TINY, TB, TT, TV, batch,
                                             lstm_conf, port_of)

TELEM_RTOL, PARAM_NORM_RTOL = 1e-5, 1e-5
STEP_RTOL = 1e-3


def _triples(seed, shapes, dtype=np.float32):
    r = np.random.RandomState(seed)
    out = []
    for layer in shapes:
        old = {k: r.randn(*s).astype(dtype) for k, s in layer.items()}
        new = {k: v + 0.01 * r.randn(*v.shape).astype(dtype)
               for k, v in old.items()}
        grad = {k: r.randn(*v.shape).astype(dtype) for k, v in old.items()}
        out.append((old, new, grad))
    return out


@pytest.mark.parametrize("shapes", [
    [{"W": (5, 8), "b": (8,)}, {"W": (8, 3), "b": (3,)}],
    [{"W": (4, 16), "RW": (4, 16), "b": (16,)}, {}, {"W": (4, 2)}],
], ids=["dense", "with_paramless"])
def test_compute_telemetry_equals_jax(shapes):
    triples = _triples(3, shapes)
    want = np.asarray(jflight.compute_telemetry(
        [tuple({k: jnp.asarray(v) for k, v in t.items()} for t in tr)
         for tr in triples]))
    got = flight.compute_telemetry(
        [tuple({k: torch.from_numpy(v) for k, v in t.items()} for t in tr)
         for tr in triples]).numpy()
    assert got.shape == (len(shapes), len(STAT_COLS))
    np.testing.assert_allclose(got, want, rtol=TELEM_RTOL, atol=1e-7)


def test_compute_telemetry_flags_non_finite_and_keeps_bf16_rounding():
    old = {"W": torch.tensor([[1.0, 2.0]], dtype=torch.bfloat16)}
    new = {"W": torch.tensor([[1.0078125, 2.0]], dtype=torch.bfloat16)}
    grad = {"W": torch.tensor([[float("nan"), 1.0]])}
    row = flight.compute_telemetry([(old, new, grad)])[0]
    assert row[4] == 1.0
    # u = f32(new) - f32(old) of the rounded values
    assert row[1] == pytest.approx(0.0078125)


def _rows(seq):
    """A fixed sequence of (L=2, 5) rows: warm-up, a spike, a ratio out of
    band, dead updates, a non-finite layer."""
    base = np.array([[1.0, 1e-2, 1.0, 1e-2, 0.0]] * 2, np.float32)
    out = []
    for kind in seq:
        a = base.copy()
        if kind == "spike":
            a[0, 0] = 50.0
        elif kind == "high":
            a[1, 3] = 0.5
        elif kind == "dead":
            a[1, 1] = 0.0
        elif kind == "nan":
            a[0, 4] = 1.0
        out.append(a)
    return out


@pytest.mark.parametrize("seq", [
    ["ok"] * 4 + ["spike", "ok"],
    ["ok", "high", "dead", "dead", "dead", "ok"],
    ["ok", "ok", "nan", "ok"],
], ids=["spike", "ratio_dead", "non_finite"])
def test_anomaly_detector_raises_what_jax_raises(seq):
    names = ["0:LSTM", "1:RnnOutputLayer"]
    ours, theirs = AnomalyDetector(names), JaxDetector(names)
    for it, row in enumerate(_rows(seq)):
        assert ours.observe(it, row) == theirs.observe(it, row)
    assert ours.active() == theirs.active()
    assert ours.health_info() == theirs.health_info()


def _filled(cls, tmp_path, name):
    rec = cls(sample_every=1, spill_path=str(tmp_path / name))
    rec.layer_names = ["0:LSTM", "1:RnnOutputLayer"]
    rec.detector = (AnomalyDetector if cls is FlightRecorder
                    else JaxDetector)(rec.layer_names)
    for it, row in enumerate(_rows(["ok", "ok", "nan"])):
        rec.record(it, row)
    return rec


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spill_is_read_by_the_other_package(tmp_path, writer):
    w, r = ((FlightRecorder, JaxRecorder) if writer == "port"
            else (JaxRecorder, FlightRecorder))
    rec = _filled(w, tmp_path, "box.json")
    path = rec.spill()
    doc = r.restore(path)
    assert doc["layer_names"] == rec.layer_names
    assert doc["cols"] == list(STAT_COLS)
    assert [x["iteration"] for x in doc["records"]] == [0, 1, 2]
    assert doc["first_non_finite"] == {"layer": "0:LSTM", "iteration": 2}
    np.testing.assert_array_equal(doc["records"][2]["stats"],
                                  _rows(["nan"])[0])
    json.load(open(path))


def _lstm_pair(tbptt=None):
    jnet = JaxMLN(lstm_conf("plain", tbptt)).init()
    return jnet, port_of(jnet)


def _tiny_pair():
    from deeplearning4j_tpu.zoo.simple import TinyTransformer as JaxTiny
    jnet = JaxTiny(**SMALL_TINY).init()
    return jnet, port_of(jnet)


def _tiny_batch(seed):
    r = np.random.RandomState(seed)
    eye = np.eye(TV, dtype=np.float32)
    return eye[r.randint(0, TV, (TB, TT))], eye[r.randint(0, TV, (TB, TT))]


@pytest.mark.parametrize("model", ["lstm", "transformer"])
def test_one_step_telemetry_equals_jax(model):
    jnet, net = _lstm_pair() if model == "lstm" else _tiny_pair()
    x, y = batch(4) if model == "lstm" else _tiny_batch(4)
    jrec, rec = JaxRecorder(), FlightRecorder()
    jnet.attach_flight_recorder(jrec)
    net.attach_flight_recorder(rec)
    jnet.fit(x, y)
    net.fit(x, y)
    want, got = jrec.latest()["stats"], rec.latest()["stats"]
    assert rec.layer_names == jrec.layer_names
    assert got.shape == want.shape
    upd = [STAT_COLS.index(c) for c in ("grad_norm", "update_norm",
                                        "update_ratio")]
    np.testing.assert_allclose(got[:, upd], want[:, upd], rtol=STEP_RTOL,
                               atol=1e-9)
    pn = STAT_COLS.index("param_norm")
    np.testing.assert_allclose(got[:, pn], want[:, pn],
                               rtol=PARAM_NORM_RTOL)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])


def _train(net, path, k):
    if path == "graph":
        batches = [_tiny_batch(s) for s in range(5)]
    else:
        batches = [batch(s) for s in range(5)]
    if path == "scan":
        xs = np.stack([b[0] for b in batches])
        ys = np.stack([b[1] for b in batches])
        net.fit_scan(xs, ys)
    else:
        for x, y in batches:
            net.fit(x, y)
    return net


def _make(path):
    if path == "graph":
        return _tiny_pair()[1]
    return _lstm_pair(3 if path == "tbptt" else None)[1]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("path", ["batch", "scan", "tbptt", "graph",
                                  "per_layer"])
def test_recorder_on_and_off_give_the_same_bits(path, k):
    fused_update.set_fused_update(False if path == "per_layer" else None)
    try:
        off, on = _make(path), _make(path)
        rec = FlightRecorder(sample_every=k)
        on.attach_flight_recorder(rec)
        _train(off, path, k)
        _train(on, path, k)
    finally:
        fused_update.set_fused_update(None)
    assert (on._fused is None) == (path == "per_layer")
    ps_on = on.params if isinstance(on.params, list) \
        else list(on.params.values())
    ps_off = off.params if isinstance(off.params, list) \
        else list(off.params.values())
    for a, b in zip(ps_on, ps_off):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    assert [r["iteration"] for r in rec.records()] == \
        [i for i in range(5) if i % k == 0]
    assert rec.layer_names == flight.layer_names(on)


def test_nan_in_one_feature_names_the_first_non_finite_layer(tmp_path):
    jnet, net = _lstm_pair()
    path = str(tmp_path / "box.json")
    jrec = JaxRecorder(sample_every=1)
    rec = FlightRecorder(sample_every=1, spill_path=path,
                         spill_every=10_000)
    jnet.attach_flight_recorder(jrec)
    net.attach_flight_recorder(rec)
    x, y = batch(6)
    bad = x.copy()
    bad[0, 0, 0] = np.nan
    for n in (jnet, net):
        n.fit(x, y)
        n.fit(bad, y)
    fnf = rec.first_non_finite()
    assert fnf == jrec.first_non_finite() == {"layer": "0:LSTM",
                                              "iteration": 1}
    assert rec.health_info()["reason"] == "train_non_finite"
    doc = JaxRecorder.restore(path)
    assert doc["first_non_finite"]["layer"] == "0:LSTM"
    assert any(a["kind"] == "non_finite" for a in doc["anomalies"])


def test_train_monitor_counts_steps_and_compile_events():
    from deeplearning4j_tpu_torch.monitor import get_registry
    net = _lstm_pair()[1]
    x, y = batch(1)
    mon = net._mon
    s0, e0 = mon.steps.value, mon.examples.value
    net.fit(x, y)
    net.fit_scan(np.stack([x, x]), np.stack([y, y]))
    assert mon.steps.value - s0 == 3
    assert mon.examples.value - e0 == 3 * x.shape[0]
    assert mon.score.value == pytest.approx(net.get_score())
    text = get_registry().render()
    assert 'dl4jtpu_train_steps_total{model="MultiLayerNetwork"}' in text
    # the CPU captures nothing: no call is a compile event
    assert mon.compile_events.value == 0
