"""The port's ``/metrics`` catalog against the JAX package's.

- Every ``dl4jtpu_*`` series a ported JAX module registers (its name
  literals, read from the JAX package's source; the unported modules --
  ``exec/autotune.py`` and ``util/compile_cache.py`` -- left out) is
  registered somewhere in the port.
- After a dense, a paged and a speculative ``/generate`` served on the CPU
  and a ``fit``, the port's registry holds every series of the JAX decode
  engine, block pool, train monitor, fused update and executor, each with
  the label names the JAX registry gives it, and a scrape of the server's
  ``/metrics`` shows the decode engine's and the pool's series.
- ``TrainMonitor.timed`` and ``serving.spec.oracle_tokens`` take the JAX
  package's names.
"""

import inspect
import json
import pathlib
import re
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.monitor import hooks as jax_hooks
from deeplearning4j_tpu.monitor.metrics import get_registry as jax_registry
from deeplearning4j_tpu.nn import fused_update as jax_fused
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxDecode
from deeplearning4j_tpu.serving.kv.pool import BlockPool as JaxPool
from deeplearning4j_tpu.serving.spec import SpecConfig as JaxSpec
from deeplearning4j_tpu.serving.spec import accept as jax_accept

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.exec import Executor
from deeplearning4j_tpu_torch.monitor import hooks
from deeplearning4j_tpu_torch.monitor.metrics import get_registry
from deeplearning4j_tpu_torch.serving import DecodeEngine, InferenceServer
from deeplearning4j_tpu_torch.serving.spec import SpecConfig, accept
from test_torch_kv_migrate import V, jax_tiny
from test_torch_regularised_training import port_of

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "deeplearning4j_tpu"
PORT_PKG = ROOT / "deeplearning4j_tpu_torch"
# JAX modules with no counterpart in the port yet (ROADMAP queue 1)
UNPORTED = ("exec/autotune.py", "util/compile_cache.py")
NAME = re.compile(r"""["'](dl4jtpu_[a-z0-9_]+)["']""")
# the series F13 found missing, and the modules whose whole catalog a
# served /generate and a fit must register
F13 = ("dl4jtpu_decode_steps_total", "dl4jtpu_decode_tokens_total",
       "dl4jtpu_decode_requests_total", "dl4jtpu_decode_active_slots",
       "dl4jtpu_decode_token_seconds", "dl4jtpu_spec_draft_step_seconds",
       "dl4jtpu_spec_tree_nodes", "dl4jtpu_kv_pool_blocks",
       "dl4jtpu_kv_pool_blocks_free", "dl4jtpu_kv_pool_evictions_total",
       "dl4jtpu_kv_pool_high_water", "dl4jtpu_train_fused_groups",
       "dl4jtpu_train_precision_bf16")
SERVED = ("serving/decode.py", "serving/kv/pool.py", "monitor/hooks.py",
          "nn/fused_update.py", "exec/executor.py")


def jax_catalog():
    """{series name: the JAX module (relative path) that registers it}."""
    out = {}
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        if rel.startswith(UNPORTED):
            continue
        for name in NAME.findall(path.read_text()):
            out.setdefault(name, rel)
    return out


def test_every_ported_jax_series_is_registered_in_the_port():
    port = set()
    for path in PORT_PKG.rglob("*.py"):
        port.update(NAME.findall(path.read_text()))
    cat = jax_catalog()
    assert set(F13) <= set(cat)
    missing = {n: m for n, m in cat.items() if n not in port}
    assert not missing


def _scrape(url):
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        return r.read().decode()


def _post(url, path, payload):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read().decode())


@pytest.fixture(scope="module")
def served():
    """A dense, a paged and a speculative engine behind servers, each
    asked for one /generate; a fit; the JAX engine, pool, monitor and
    fused update built so that the JAX registry holds their series."""
    jnet = jax_tiny()
    net = port_of(jnet)
    engines = {"dense": DecodeEngine(net, 2, 32),
               "paged": DecodeEngine(net, 2, 32, kv="paged",
                                     kv_block_size=8),
               "spec": DecodeEngine(net, 2, 32, spec=SpecConfig(net, k=2))}
    scrapes = {}
    for kind, eng in engines.items():
        srv = InferenceServer(net, port=0, decode_engine=eng).start()
        try:
            url = f"http://127.0.0.1:{srv.port}"
            st, body = _post(url, "/generate", {"tokens": [1, 2, 3],
                                                "max_new_tokens": 3})
            assert st == 200 and len(body["tokens"]) == 3
            scrapes[kind] = _scrape(url)
        finally:
            srv.stop()
    rs = np.random.RandomState(0)
    eye = np.eye(V, dtype=np.float32)
    ids = rs.randint(0, V, (4, 7))
    net.fit(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))
    JaxDecode(jnet, 2, 32, kv="paged", kv_block_size=8,
              spec=JaxSpec(jnet, k=2))
    JaxPool(4, 4, engine="catalog")
    jax_hooks.TrainMonitor("catalog")
    jax_fused._metrics()
    from deeplearning4j_tpu.exec import Executor as JaxExecutor
    JaxExecutor()
    Executor(train_precision="f32")
    return {"engines": engines, "scrapes": scrapes}


def test_the_registry_holds_the_served_series_with_jax_labels(served):
    reg, jreg = get_registry(), jax_registry()
    names = [n for n, m in jax_catalog().items() if m in SERVED]
    assert set(F13) <= set(names)
    for name in names:
        fam, jfam = reg.get(name), jreg.get(name)
        assert fam is not None, name
        assert jfam is not None, name
        assert (fam.kind, fam.labelnames) == (jfam.kind, jfam.labelnames), \
            name


def test_a_scrape_shows_the_decode_and_pool_series(served):
    engines, scrapes = served["engines"], served["scrapes"]
    for kind, text in scrapes.items():
        lab = f'{{engine="{engines[kind].id}"}}'
        for name in ("dl4jtpu_decode_steps_total",
                     "dl4jtpu_decode_tokens_total",
                     "dl4jtpu_decode_requests_total",
                     "dl4jtpu_decode_active_slots",
                     "dl4jtpu_decode_token_seconds_count"):
            assert f"{name}{lab}" in text, (kind, name)
        assert f"dl4jtpu_decode_tokens_total{lab} 3" in text
        assert f"dl4jtpu_decode_requests_total{lab} 1" in text
    paged = scrapes["paged"]
    lab = f'{{engine="{engines["paged"].id}"}}'
    for name in ("dl4jtpu_kv_pool_blocks", "dl4jtpu_kv_pool_blocks_free",
                 "dl4jtpu_kv_pool_evictions_total",
                 "dl4jtpu_kv_pool_high_water"):
        assert f"{name}{lab}" in paged, name
    assert f"dl4jtpu_kv_pool_blocks{lab} 8" in paged
    spec = scrapes["spec"]
    lab = f'{{engine="{engines["spec"].id}"}}'
    assert f"dl4jtpu_spec_draft_step_seconds_count{lab}" in spec
    assert f"dl4jtpu_spec_tree_nodes{lab} 3" in spec
    text = get_registry().render()
    assert "dl4jtpu_train_fused_groups " in text
    assert "dl4jtpu_train_precision_bf16 0" in text


def test_timed_and_oracle_tokens_take_the_jax_names():
    mon = hooks.TrainMonitor("catalog")
    assert (list(inspect.signature(mon.timed).parameters)
            == list(inspect.signature(
                jax_hooks.TrainMonitor.timed).parameters)[1:])
    assert isinstance(mon.timed(), float)
    names = list(inspect.signature(accept.oracle_tokens).parameters)
    assert names == list(inspect.signature(
        jax_accept.oracle_token).parameters)
    assert names == ["logits", "seed", "pos", "temp", "top_k"]
