"""The port's UI stack (ui/) on the CPU, against the JAX package's.

- Components: ``to_json`` and ``render_html`` strings equal the JAX
  package's, and every kind round-trips through the registry.
- ``UIServer``: the port's and the JAX server over the same storage answer
  every GET and POST route with the same status and JSON; the device and
  backend of /train/system/data name ``cpu`` off the card (the JAX
  package's run here on the CPU too).
- ``WebReporter`` -> ``RemoteUIStatsStorageRouter`` -> POST /remote
  delivers every record of a ``fit`` equal to the listener's local copy;
  a down collector does not block ``fit``; a full queue drops.
- ``ConvolutionalIterationListener`` on a small LeNet carried from the
  JAX package's weights: the decoded grids within 1 grey level of the
  JAX listener's, with Pillow and with Pillow blocked (the stdlib
  encoder, whose PNG a plain zlib reader decodes).
"""

import base64
import io
import json
import re
import sys
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from deeplearning4j_tpu import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.models.computation_graph import \
    ComputationGraph as JaxCG
from deeplearning4j_tpu.models.multi_layer_network import \
    MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn.conf.graph_conf import PreprocessorVertex
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JaxConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JaxSub
from deeplearning4j_tpu.nn.updaters import Sgd as JaxSgd
from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.ui import components as jcmp

from deeplearning4j_tpu_torch import ui
from deeplearning4j_tpu_torch.ui import components as cmp
from deeplearning4j_tpu_torch.ui import conv_listener

from test_torch_regularised_training import port_of


def _components(m):
    return [
        (m.ChartLine("loss", m.Style(width=300, margin=20))
         .add_series("train", [0, 1, 2], [3.0, 2.0, 1.0])
         .add_series("val", [0, 1, 2], [3.5, 2.5, float("nan")])),
        m.ChartScatter("emb").add_series("pts", [1, 2], [3, 4]),
        m.ChartHistogram("resid").add_bin(0.0, 0.1, 5).add_bin(0.1, 0.2, 3),
        (m.ChartStackedArea("mem").add_series("a", [0, 1], [1, 1])
         .add_series("b", [0, 1], [2, 2])),
        m.ChartHorizontalBar("counts").add_value("x", 3).add_value("y", 5),
        m.ChartTimeline("phases").add_lane("etl", [(0, 1, "load</script>")]),
        m.ComponentDiv(m.ComponentTable(["layer", "params"], [["conv", 500]]),
                       m.ComponentText("hello <b>")),
    ]


def _html(c):
    """``render_html`` with the canvas ids, which carry the object's
    address, made one name."""
    return re.sub(r"\bc[0-9a-f]{6,}_", "cID_", c.render_html())


def test_components_equal_jax_strings_and_round_trip():
    for c, jc in zip(_components(cmp), _components(jcmp)):
        assert c.to_json() == jc.to_json()
        assert _html(c) == _html(jc)
        back = cmp.Component.from_json(c.to_json())
        assert type(back).__name__ == type(c).__name__
        assert back.to_json() == c.to_json()
    page = re.sub(r"\bc[0-9a-f]{6,}_", "cID_",
                  cmp.render_page(*_components(cmp)))
    assert page == re.sub(r"\bc[0-9a-f]{6,}_", "cID_",
                          jcmp.render_page(*_components(jcmp)))
    with pytest.raises(ValueError):
        cmp.ChartLine("bad").add_series("s", [1, 2], [1.0])


def _conv_conf():
    return (JaxNNC.builder().seed(5).updater(JaxSgd(0.1))
            .weight_init("xavier").list()
            .layer(JaxConv(n_out=4, kernel_size=3, stride=1,
                           activation="relu"))
            .layer(JaxSub(pooling_type="max", kernel_size=2, stride=2))
            .layer(JaxConv(n_out=6, kernel_size=3, stride=1,
                           activation="relu"))
            .layer(JaxDense(n_out=8, activation="relu"))
            .layer(JaxOut(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.convolutional(12, 12, 1))
            .build())


def _conv_graph_conf():
    g = (JaxNNC.builder().seed(5).updater(JaxSgd(0.1))
         .weight_init("xavier").graph_builder())
    g.add_inputs("in").set_input_types(JaxInputType.convolutional(12, 12, 1))
    g.add_layer("c", JaxConv(n_out=4, kernel_size=3, stride=1,
                             activation="relu"), "in")
    g.add_layer("p", JaxSub(pooling_type="max", kernel_size=2, stride=2),
                "c")
    g.add_vertex("v", PreprocessorVertex("cnn_to_ff"), "p")
    g.add_layer("out", JaxOut(n_out=2, activation="softmax",
                              loss="mcxent"), "v")
    return g.set_outputs("out").build()


def _conv_batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(8, 12, 12, 1).astype(np.float32),
            np.eye(2, dtype=np.float32)[rs.randint(0, 2, 8)])


def _train(net, listeners, steps=4):
    net.set_listeners(*listeners)
    x, y = _conv_batch()
    graph = hasattr(net.conf, "network_inputs")
    for _ in range(steps):
        net.fit([x], [y]) if graph else net.fit(x, y)
    return net


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(base, path, payload):
    data = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


GETS = ["/", "/train", "/train/overview.html", "/train/sessions",
        "/train/overview?sid=conv", "/train/overview?sid=nope",
        "/train/overview", "/train/model", "/train/model?sid=conv",
        "/train/model?sid=nope", "/train/model/data?sid=conv",
        "/train/system", "/train/system/data?sid=conv", "/tsne",
        "/tsne/sessions", "/tsne/coords?sid=emb", "/tsne/coords?sid=nope",
        "/train/activations", "/train/activations/data?sid=conv",
        "/train/activations/data?sid=nope", "/nothing/here"]
POSTS = [("/tsne/upload", {"sessionId": "up", "coords": [[0, 1], [1, 0]],
                           "labels": ["a", "b"]}),
         ("/tsne/upload", {"sessionId": "bad", "coords": [1, 2]}),
         ("/remote", {"type": "static", "sessionId": "r",
                      "info": {"numLayers": 3}}),
         ("/remote", {"type": "update", "record": ui.StatsReport(
             session_id="r", iteration=9, score=0.5).to_bytes().hex()}),
         ("/remote", {"type": "other"}),
         ("/elsewhere", {})]


def test_both_servers_answer_every_route_alike():
    storage = ui.InMemoryStatsStorage()
    net = port_of(JaxMLN(_conv_conf()).init())
    _train(net, [ui.StatsListener(storage, session_id="conv"),
                 ui.ConvolutionalIterationListener(storage, frequency=2,
                                                   session_id="conv")])
    coords = np.random.RandomState(0).randn(20, 3)
    servers = [ui.UIServer(port=0), jui.UIServer(port=0)]
    try:
        bases = []
        for srv in servers:
            srv.attach(storage)
            srv.upload_tsne("emb", coords, labels=[f"w{i}" for i in
                                                    range(20)])
            bases.append(f"http://127.0.0.1:{srv.port}")
        for path in GETS:
            got, want = (_get(b, path) for b in bases)
            assert got == want, path
        system = json.loads(_get(bases[0], "/train/system/data?sid=conv")[1])
        assert system["device"] == "cpu" and system["backend"] == "cpu"
        assert len(system["memRssMb"]) == 4
        acts = json.loads(_get(bases[0],
                               "/train/activations/data?sid=conv")[1])
        assert acts["iteration"] == 4 and len(acts["images"]) == 3
        # /remote without a remote storage: 503 from both
        assert _post(bases[0], *POSTS[2]) == _post(bases[1], *POSTS[2])
        assert _post(bases[0], *POSTS[2])[0] == 503
        for srv in servers:
            srv.enable_remote_listener()
        for path, payload in POSTS:
            got, want = (_post(b, path, payload) for b in bases)
            assert got == want, path
        for path in ("/tsne/sessions", "/tsne/coords?sid=up",
                     "/train/sessions", "/train/model?sid=r",
                     "/train/overview?sid=r"):
            got, want = (_get(b, path) for b in bases)
            assert got == want, path
        assert json.loads(_get(bases[0], "/train/overview?sid=r")[1])[
            "iterations"] == [9]
    finally:
        for srv in servers:
            srv.stop()
    singleton = ui.UIServer.get_instance(port=0)
    assert ui.UIServer.get_instance() is singleton
    singleton.stop()
    assert ui.UIServer._instance is None


def test_web_reporter_delivers_every_record_of_a_fit():
    server = ui.UIServer(port=0)
    try:
        remote = server.enable_remote_listener()
        local = ui.InMemoryStatsStorage()
        reporter = ui.WebReporter(f"http://127.0.0.1:{server.port}")
        net = port_of(JaxMLN(_conv_conf()).init())
        _train(net, [ui.StatsListener(reporter, session_id="ws"),
                     ui.StatsListener(local, session_id="ws")], steps=5)
        assert reporter.flush()
        got = [r.to_bytes() for r in remote.get_all_updates("ws")]
        want = local.get_all_updates("ws")
        assert len(got) == 5
        # the two listeners read the same step: equal but for the clock
        for g, w in zip(got, want):
            g = ui.StatsReport.from_bytes(g)
            assert (g.iteration, g.score, g.param_stats, g.update_stats) \
                == (w.iteration, w.score, w.param_stats, w.update_stats)
        assert remote.get_static_info("ws") == local.get_static_info("ws")
        assert reporter.dropped == 0
        reporter.close()
        assert reporter.dropped == 0
    finally:
        server.stop()


def test_a_down_collector_never_blocks_fit_and_a_full_queue_drops():
    reporter = ui.WebReporter("http://127.0.0.1:9", retries=1, timeout=0.1,
                              queue_size=2)
    net = port_of(JaxMLN(_conv_conf()).init())
    t0 = time.perf_counter()
    _train(net, [ui.StatsListener(reporter, session_id="down")], steps=6)
    assert time.perf_counter() - t0 < 30
    reporter.close()
    # 6 updates and the static record: every one dropped, none delivered
    assert reporter.dropped == 7


def _decode_png(png: bytes) -> np.ndarray:
    """An 8-bit grayscale PNG decoded with zlib alone (every row filter
    0, as the stdlib encoder writes)."""
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        tag, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), \
                int.from_bytes(body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not raw[:, 0].any()
    return raw[:, 1:]


def _pil_decode(png: bytes) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(png)))


def _grids(storage, sid, decode):
    info = storage.get_static_info(f"{sid}/activations")
    return info["iteration"], {k: decode(base64.b64decode(v))
                               for k, v in info["images"].items()}


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("pil", [True, False])
def test_conv_listener_grids_equal_jax(monkeypatch, pil, graph):
    pytest.importorskip("PIL")
    jnet = JaxCG(_conv_graph_conf()).init() if graph \
        else JaxMLN(_conv_conf()).init()
    net = port_of(jnet)
    jstore, store = jui.InMemoryStatsStorage(), ui.InMemoryStatsStorage()
    _train(jnet, [jui.ConvolutionalIterationListener(
        jstore, frequency=3, session_id="c", scale=2)])
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    _train(net, [ui.ConvolutionalIterationListener(
        store, frequency=3, session_id="c", scale=2)])
    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    jit, want = _grids(jstore, "c", _pil_decode)
    it, got = _grids(store, "c", _pil_decode if pil else _decode_png)
    assert it == jit == 3
    assert got.keys() == want.keys() == ({"c", "p"} if graph else {
        "0:ConvolutionLayer", "1:SubsamplingLayer", "2:ConvolutionLayer"})
    for k in got:
        assert got[k].shape == want[k].shape
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1
    if not pil:
        raw = next(iter(store.get_static_info("c/activations")
                        ["images"].values()))
        png = base64.b64decode(raw)
        np.testing.assert_array_equal(_pil_decode(png), _decode_png(png))


def test_the_stdlib_encoder_round_trips(monkeypatch):
    gray = (np.arange(35, dtype=np.uint8) * 7).reshape(5, 7)
    monkeypatch.setitem(sys.modules, "PIL", None)
    png = conv_listener._encode_png_gray(gray)
    np.testing.assert_array_equal(_decode_png(png), gray)
