"""The port's elastic cluster (exec/elastic.py, exec/worker.py,
exec/cluster.py) against the JAX package's, on the CPU.

- **The coordinator.** Every fake-clock sequence of the JAX package's
  tests/test_elastic.py is scripted once and driven through JAX's
  ``ElasticCoordinator`` and the port's: each asserts JAX's outcomes, and
  the two coordinators' observations and ``state()`` (members, events,
  their fake-clock times) must be equal.
- **The workers' arithmetic.** JAX's ``build_model`` weights carried into
  the port's network (``params_from_numpy``); JAX's ``dp_programs`` and the
  port's run the same ``synth_batch`` shards at world 2 for 6 steps: the
  reduced vectors (loss first, then the gradients in ``tree_leaves``
  order) within 1e-5 of their largest magnitude, losses within rtol 1e-5,
  parameters within 1e-5 of max |param|; ``synth_batch`` byte for byte.
- **Subprocess clusters.** ``ClusterManager(..., device="cpu")`` spawns
  real ``python -m deeplearning4j_tpu_torch.exec.worker --device cpu``
  processes, each run under ``run(timeout=180)``: the chain, the star,
  the gloo backend and ``single_process_reference`` give one digest, and
  a SIGKILLed worker's replacement restores the anchor and its programs'
  recipes and lands on the unkilled digest. The four long drills of the
  JAX package are ``slow`` here too.
- A worker asked for ``cuda`` on a machine without a card exits 5 before
  it joins.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.exec.elastic as jax_elastic
import deeplearning4j_tpu_torch.exec.elastic as port_elastic
from deeplearning4j_tpu_torch.exec.cluster import ClusterManager
from deeplearning4j_tpu_torch.exec.worker import (ElasticWorker,
                                                  params_digest,
                                                  single_process_reference,
                                                  synth_batch)

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"jax": jax_elastic, "port": port_elastic}


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """Workers inherit this environment: one intra-op thread each, so the
    subprocess clusters do not oversubscribe the host."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


def _form(E, n: int, clock: FakeClock = None, **kw):
    """Join + sync n workers through formation; returns (coord, clock)."""
    clock = clock or FakeClock()
    coord = E.ElasticCoordinator(n, clock=clock, **kw)
    for i in range(n):
        coord.join(f"w{i}")
        clock.advance(0.01)     # distinct joined_at -> deterministic ranks
    for i in range(n):
        coord.sync(f"w{i}", 1)
    assert coord.generation == 1 and coord.proposal is None
    assert coord.world == n
    return coord, clock


def _ranks(coord):
    return {wid: m["rank"] for wid, m in coord.state()["members"].items()}


def _raises(fn, *a, **kw):
    """The exception's class name (or the return value) of one call."""
    try:
        return fn(*a, **kw)
    except Exception as e:   # noqa: BLE001 -- observed, compared
        return type(e).__name__


def _plain(x):
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.tobytes())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# the scripted sequences (tests/test_elastic.py's fake-clock tests)
# ---------------------------------------------------------------------------

def seq_formation(E, obs):
    coord, _ = _form(E, 3)
    assert coord.phase == "running"
    assert sorted(_ranks(coord).values()) == [0, 1, 2]
    return coord


def seq_sync_waits(E, obs):
    clock = FakeClock()
    coord = E.ElasticCoordinator(2, clock=clock)
    coord.join("w0")
    first = coord.sync("w0", 1)
    assert first == {"status": "wait", "proposal": 1}
    coord.join("w1")
    assert coord.sync("w0", 1)["status"] == "wait"   # w1 not acked yet
    obs.append(coord.sync("w1", 1))
    view = coord.sync("w0", 1)
    obs.append(view)
    assert view["status"] == "go" and view["generation"] == 1
    assert view["world"] == 2
    return coord


def seq_join_beyond_world(E, obs):
    coord, _ = _form(E, 2)
    with pytest.raises(E.ClusterFullError):
        coord.join("w2")
    return coord


def seq_heartbeat_non_member(E, obs):
    coord, _ = _form(E, 1)
    with pytest.raises(E.EvictedError):
        coord.heartbeat("ghost", generation=1)
    return coord


def seq_suspect_and_heal(E, obs):
    coord, clock = _form(E, 2, suspect_after=1.5, evict_after=4.0)
    clock.advance(1.0)
    obs.append(coord.heartbeat("w0", generation=1))
    clock.advance(0.7)                   # w1 lease age ~1.7 >= 1.5
    coord.tick()
    states = {w: m["state"] for w, m in coord.state()["members"].items()}
    assert states["w1"] == E.SUSPECT and states["w0"] == E.LIVE
    obs.append(coord.heartbeat("w1", generation=1))   # heals suspicion
    states = {w: m["state"] for w, m in coord.state()["members"].items()}
    assert states["w1"] == E.LIVE
    return coord


def seq_evict_and_replace(E, obs):
    coord, clock = _form(E, 2, suspect_after=1.5, evict_after=4.0,
                         replacement_grace=8.0)
    ranks_before = _ranks(coord)
    clock.advance(2.0)
    coord.heartbeat("w0", generation=1)
    clock.advance(2.0)                   # w1 lease age 4.0 -> evicted
    coord.tick()
    assert "w1" not in coord.state()["members"]
    assert coord.proposal == 2           # reform in flight
    evs = [e["type"] for e in coord.events]
    assert "evicted" in evs and "reform_proposed" in evs
    assert coord.heartbeat("w0", generation=1)["directive"] == "rollback"
    joined = coord.join("w1b")           # the supervisor's replacement
    obs.append(joined)
    assert joined["proposal"] == 2
    coord.sync("w0", 2)
    assert coord.generation == 1         # replacement not synced yet
    coord.sync("w1b", 2)
    assert coord.generation == 2 and coord.world == 2
    ranks = _ranks(coord)
    assert ranks["w0"] == ranks_before["w0"]
    assert ranks["w1b"] == ranks_before["w1"]
    assert coord.last_recovery_wall == pytest.approx(
        clock.t - (100.0 + 0.02 + 4.0), abs=1e-6)
    assert coord.heartbeat("w0", generation=2)["directive"] == "none"
    return coord


def seq_stale_generation_fenced(E, obs):
    coord, clock = _form(E, 2)
    coord.leave("w1")                    # opens proposal 2
    with pytest.raises(E.FencedError) as ei:
        coord.contribute("w0", generation=1, step=3, rows=16,
                         vec=np.zeros(4, np.float32))
    assert ei.value.proposal == 2
    obs.append((ei.value.proposal, ei.value.anchor, str(ei.value)))
    clock.advance(coord.replacement_grace + 0.1)
    coord.sync("w0", 2)
    coord.tick()
    assert coord.generation == 2
    with pytest.raises(E.FencedError):
        coord.contribute("w0", generation=1, step=3, rows=16,
                         vec=np.zeros(4, np.float32))
    return coord


def seq_grace_degraded(E, obs):
    coord, clock = _form(E, 3, replacement_grace=5.0)
    coord.leave("w2")
    coord.sync("w0", 2)
    coord.sync("w1", 2)
    assert coord.generation == 1         # grace window still open
    clock.advance(2.6)
    coord.heartbeat("w0", generation=1)
    coord.heartbeat("w1", generation=1)
    clock.advance(2.6)
    coord.tick()
    assert coord.generation == 2 and coord.world == 2
    assert sorted(_ranks(coord).values()) == [0, 1]   # ranks compacted
    assert [e for e in coord.events
            if e["type"] == "generation_committed" and e["world"] == 2]
    return coord


def seq_last_nonreporter_evicted(E, obs):
    coord, clock = _form(E, 2, suspect_after=1.5, evict_after=4.0)
    coord.result("w0", {"final_loss": 0.5})
    assert coord.phase == "running"      # w1 still training
    clock.advance(2.0)
    coord.heartbeat("w0", generation=1)
    clock.advance(2.0)                   # w1 lease age 4.0 -> evicted
    coord.tick()
    assert "w1" not in coord.state()["members"]
    assert coord.phase == "done"
    assert coord.proposal is None        # no reform holds the finished job
    return coord


def seq_allreduce_rank_order(E, obs):
    coord, _ = _form(E, 2)
    v0 = np.array([2.0, 4.0], np.float32)     # pre-scaled by rows
    v1 = np.array([6.0, 8.0], np.float32)
    coord.contribute("w0", generation=1, step=0, rows=2, vec=v0)
    coord.contribute("w1", generation=1, step=0, rows=2, vec=v1)
    got = coord.wait_reduced("w0", generation=1, step=0, timeout=1.0)
    np.testing.assert_array_equal(got, np.array([2.0, 3.0], np.float32))
    coord.contribute("w0", generation=1, step=0, rows=2, vec=v0)
    again = coord.wait_reduced("w1", generation=1, step=0, timeout=1.0)
    np.testing.assert_array_equal(again, got)
    assert coord.reduced_steps == 1
    obs.append(got)
    return coord


def seq_reduced_cache_window(E, obs):
    coord, _ = _form(E, 2)
    v = np.ones(2, np.float32)
    steps = E._REDUCED_KEEP + 3
    for s in range(steps):
        coord.contribute("w0", generation=1, step=s, rows=1, vec=v)
        coord.contribute("w1", generation=1, step=s, rows=1, vec=v)
        coord.wait_reduced("w0", generation=1, step=s, timeout=1.0)
    assert len(coord._reduced) == E._REDUCED_KEEP
    kept = sorted(k[1] for k in coord._reduced)
    assert kept == list(range(steps - E._REDUCED_KEEP, steps))
    got = coord.wait_reduced("w1", generation=1, step=steps - 1, timeout=1.0)
    np.testing.assert_array_equal(got, v)
    obs.append(kept)
    return coord


def seq_chain_floor(E, obs):
    coord, clock = _form(E, 2)
    coord.heartbeat("w0", generation=1, step=3)
    coord.heartbeat("w1", generation=1, step=2)
    assert coord.reduced_steps == 2          # floor, not max
    coord.heartbeat("w1", generation=1, step=5)
    assert coord.reduced_steps == 3
    coord.heartbeat("w0", generation=1, step=0)   # rollback replay: ignored
    assert coord.reduced_steps == 3
    coord.result("w0", {"steps": 6})
    coord.result("w1", {"steps": 6})
    assert coord.reduced_steps == 6
    return coord


def seq_fenced_mid_barrier(E, obs):
    coord, _ = _form(E, 2)
    coord.contribute("w0", generation=1, step=0, rows=2,
                     vec=np.zeros(2, np.float32))
    coord.leave("w1")                    # barrier can never complete
    with pytest.raises(E.FencedError):
        coord.wait_reduced("w0", generation=1, step=0, timeout=1.0)
    obs.append(_raises(coord.anchor_report, "w0", 1, 4, "a.zip"))
    obs.append(_raises(coord.anchor_report, "ghost", 1, 4, "a.zip"))
    return coord


def seq_anchor_and_errors(E, obs):
    """Anchors, a bad configuration and rejoins after a healed
    partition: the remaining paths of the state machine."""
    for bad in ({"data_plane": "ring"}, {"codec": "gzip"}):
        obs.append(_raises(E.ElasticCoordinator, 2, **bad))
    obs.append(_raises(E.ElasticCoordinator, 0))
    coord, clock = _form(E, 2, evict_after=2.0, replacement_grace=3.0)
    obs.append(coord.anchor_report("w0", 1, 4, "/c/4.zip"))
    obs.append(coord.config())
    clock.advance(1.5)
    coord.heartbeat("w0", generation=1, step=4)
    clock.advance(0.6)
    coord.tick()                         # w1 evicted by its lease
    obs.append(coord.heartbeat("w0", generation=1, step=4))
    coord.join("w1")                     # the partition heals
    obs.append(coord.sync("w0", 2))
    obs.append(coord.sync("w1", 2))
    obs.append(coord.sync("w0", 2))
    obs.append(_raises(coord.sync, "ghost", 2))
    return coord


SEQUENCES = {f.__name__[4:]: f for f in (
    seq_formation, seq_sync_waits, seq_join_beyond_world,
    seq_heartbeat_non_member, seq_suspect_and_heal, seq_evict_and_replace,
    seq_stale_generation_fenced, seq_grace_degraded,
    seq_last_nonreporter_evicted, seq_allreduce_rank_order,
    seq_reduced_cache_window, seq_chain_floor, seq_fenced_mid_barrier,
    seq_anchor_and_errors)}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_coordinator_matches_jax_on_scripted_sequence(name):
    """Each sequence asserts JAX's outcomes on both coordinators; their
    observations and whole ``state()`` (with the event journal and its
    fake-clock times) are equal."""
    got = {}
    for pkg, E in MODULES.items():
        obs = []
        coord = SEQUENCES[name](E, obs)
        got[pkg] = (_plain(obs), _plain(coord.state()))
    assert got["port"] == got["jax"]


def test_coordinator_metrics_are_the_jax_names():
    from deeplearning4j_tpu_torch.monitor import get_registry
    coord, clock = _form(port_elastic, 2, evict_after=1.0)
    coord.heartbeat("w0", generation=1)
    clock.advance(1.5)
    coord.tick()
    text = get_registry().render()
    for name in ("dl4jtpu_cluster_workers", "dl4jtpu_cluster_generation",
                 "dl4jtpu_cluster_world_size",
                 "dl4jtpu_cluster_heartbeats_total",
                 "dl4jtpu_cluster_evictions_total"):
        assert name in text, name


def test_http_plane_maps_verdicts_to_status_codes():
    """The coordinator's HTTP face: 409 stale_generation (fenced), 410
    evicted, 409 cluster_full, 400 on a bad body; the port's client maps
    them back to the elastic exceptions, and a star allreduce over HTTP
    returns the rank-ordered mean."""
    import threading

    from deeplearning4j_tpu_torch.exec.worker import CoordClient
    coord = port_elastic.ElasticCoordinator(2)
    srv = port_elastic.CoordinatorServer(coord, tick_interval=None).start()
    try:
        c0, c1 = CoordClient(srv.url, "w0"), CoordClient(srv.url, "w1")
        assert c0.join()["proposal"] == 1
        c1.join()
        c0.sync(1)
        c1.sync(1)
        assert c0.sync(1)["status"] == "go"
        out = {}

        def post(c, v):
            out[c.worker_id] = c.allreduce(1, 0, 2, v)
        ts = [threading.Thread(target=post, args=(c, np.array(v, np.float32)))
              for c, v in ((c0, [2.0, 4.0]), (c1, [6.0, 8.0]))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        for v in out.values():
            np.testing.assert_array_equal(v, np.array([2.0, 3.0],
                                                      np.float32))
        with pytest.raises(port_elastic.ClusterFullError):
            CoordClient(srv.url, "w2").join()
        with pytest.raises(port_elastic.EvictedError):
            CoordClient(srv.url, "ghost").heartbeat(1, 0)
        c1.leave()
        with pytest.raises(port_elastic.FencedError) as ei:
            c0.anchor(1, 4, None)
        assert ei.value.proposal == 2
        assert c0.state()["members"].keys() == {"w0"}
        with pytest.raises(RuntimeError, match="400"):
            c0._rpc("/sync", {"worker_id": "w0"})   # no generation
    finally:
        srv.stop()


def test_coord_client_reuses_connection_and_reconnects_once():
    from deeplearning4j_tpu_torch.exec.worker import CoordClient
    coord = port_elastic.ElasticCoordinator(1)
    srv = port_elastic.CoordinatorServer(coord)
    srv.start()
    try:
        client = CoordClient(srv.url, "w0")
        client.state()
        conn1 = client._local.conn
        sock1 = conn1.sock
        assert sock1 is not None
        client.state()
        assert client._local.conn is conn1       # same connection reused
        assert conn1.sock is sock1               # ... and the same socket
        conn1.close()                            # server idle-closed it
        client.state()                           # reconnect-once, no error
        assert client._local.conn.sock is not None
        assert client._local.conn.sock is not sock1
        client.close()
    finally:
        srv.stop()


def test_rank_tagged_spill_paths(monkeypatch):
    from deeplearning4j_tpu_torch.monitor.flight import rank_tagged_path
    monkeypatch.delenv("DL4JTPU_RANK", raising=False)
    assert rank_tagged_path("/tmp/x/spill.json") == "/tmp/x/spill.json"
    monkeypatch.setenv("DL4JTPU_RANK", "2")
    assert rank_tagged_path("/tmp/x/spill.json") == "/tmp/x/spill.rank2.json"


# ---------------------------------------------------------------------------
# the workers' arithmetic against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["mlp", "widemlp", "charlstm"])
def test_synth_batch_is_the_jax_bytes(model):
    from deeplearning4j_tpu.exec.worker import synth_batch as jax_batch
    for seed, step, n in ((42, 0, 32), (7, 5, 30), (42, 11, 1)):
        for a, b in zip(synth_batch(model, seed, step, n),
                        jax_batch(model, seed, step, n)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="no synthetic batch source"):
        synth_batch("tinyattn", 42, 0, 4)


def _jax_and_port(model):
    import jax

    from deeplearning4j_tpu.serving.replica import build_model as jax_build
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        params_from_numpy
    from deeplearning4j_tpu_torch.serving.replica import build_model
    jnet = jax_build(model)
    net = build_model(model, device="cpu")
    net.set_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu"))
    return jnet, net


@pytest.mark.parametrize("model", ["mlp", "charlstm"])
def test_dp_programs_agree_with_jax(model):
    """World 2, 6 steps of 32 rows from the same weights: the JAX
    programs' and the port's reduced vectors, losses and parameters."""
    import jax

    from deeplearning4j_tpu.exec.worker import dp_programs as jax_programs
    from deeplearning4j_tpu_torch.exec.worker import dp_programs
    from deeplearning4j_tpu_torch.parallel.distributed import \
        local_batch_slice
    jnet, net = _jax_and_port(model)
    gj, uj = jax_programs(jnet)
    grad, upd = dp_programs(net)
    world, gb = 2, 32
    for step in range(6):
        x, y = synth_batch(model, 42, step, gb)
        rng = jax.random.fold_in(jax.random.PRNGKey(42), step)
        tj = tp = None
        for r in range(world):
            sl = local_batch_slice(gb, rank=r, world=world)
            rows = np.float32(sl.stop - sl.start)
            out, _ = gj(jnet.params, jnet.state, x[sl], y[sl], rng)
            vj = np.asarray(out, np.float32) * rows
            vp, _ = grad(x[sl], y[sl])
            vp = vp * rows
            tj = vj if tj is None else tj + vj
            tp = vp if tp is None else tp + vp
        rj, rp = tj / np.float32(gb), tp / np.float32(gb)
        assert rp.shape == rj.shape
        np.testing.assert_allclose(rp[0], rj[0], rtol=1e-5)
        assert np.abs(rp - rj).max() <= 1e-5 * np.abs(rj).max(), step
        jnet.params, jnet.opt_state = uj(jnet.params, jnet.opt_state,
                                         rj[1:].astype(np.float32))
        upd(rp[1:])
    theirs = [np.asarray(a) for a in jax.tree_util.tree_leaves(jnet.params)]
    ours = [p[k].numpy() for p in net.params for k in sorted(p)]
    scale = max(np.abs(a).max() for a in theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * scale


def test_params_digest_is_jax_leaf_order():
    """The digest hashes the leaves in JAX's ``tree_leaves`` order: on
    the same bytes it is the JAX package's digest."""
    from deeplearning4j_tpu.exec.worker import params_digest as jax_digest
    jnet, net = _jax_and_port("charlstm")
    assert params_digest(net.params) == jax_digest(jnet.params)
    assert params_digest(np.arange(4, dtype=np.float32)) == \
        jax_digest(np.arange(4, dtype=np.float32))


def test_rollback_without_anchor_rebuilds_the_seed_model():
    """A survivor fenced BEFORE the first checkpoint has already applied
    updates; its rollback must rebuild the deterministic seed model (and
    its programs), not just reset the step counter."""
    from deeplearning4j_tpu_torch.serving.replica import build_model
    w = ElasticWorker("http://127.0.0.1:9", "wX", device="cpu")
    try:
        w.cfg = {"model": "mlp"}
        w.net = build_model("mlp", device="cpu")
        w._build_programs()
        seed_digest = params_digest(w.net.params)
        old = w._grad
        with torch.no_grad():
            for p in w.net.params:
                for v in p.values():
                    v.add_(1.0)
        w.net.iteration = 2
        w.anchor = {"step": 0, "path": None}
        w._restore_anchor()
        assert w.net.iteration == 0
        assert params_digest(w.net.params) == seed_digest
        assert w._grad is not old and w._grad.net is w.net
    finally:
        w.comms.close()


def test_reference_world_one_is_the_plain_mean():
    """At world 1 the oracle's rank-ordered sum is one vector times its
    rows over its rows; at world 3 the shards are ragged (11, 11, 10)."""
    a = single_process_reference("mlp", 42, 3, 32, 1, device="cpu")
    b = single_process_reference("mlp", 42, 3, 32, 1, device="cpu")
    assert a == b and a["steps"] == 3
    c = single_process_reference("mlp", 42, 3, 32, 3, device="cpu")
    assert c["params_digest"] != a["params_digest"]
    assert np.isfinite(c["final_loss"])


# ---------------------------------------------------------------------------
# real subprocess clusters on the CPU
# ---------------------------------------------------------------------------

def _digests(res):
    return {w: r["params_digest"] for w, r in res["results"].items()}


@pytest.mark.parametrize("model", ["mlp", "charlstm"])
def test_cluster_n2_chain_bitwise_vs_star_vs_single_process(tmp_path, model):
    """The data-plane parity triangle: the chain, the star and the
    in-process replay of the same job land on the SAME digest."""
    ref = single_process_reference(model=model, seed=42, total_steps=6,
                                   global_batch=32, world=2, device="cpu")
    mgr = ClusterManager(tmp_path / "chain", workers=2, total_steps=6,
                         global_batch=32, ckpt_every=3, aot=True,
                         model=model, device="cpu")
    res = mgr.run(timeout=180)
    d = _digests(res)
    assert len(d) == 2 and set(d.values()) == {ref["params_digest"]}, (d,
                                                                       ref)
    assert res["reduced_steps"] == 6     # inferred from heartbeat floor
    assert res["spawns"] == 2 and res["replacements"] == 0
    assert res["generation"] == 1
    assert res["checkpoint"] is not None
    assert os.path.exists(res["checkpoint"][:-4] + ".aot.zip")
    # control plane only: no gradient ever passed through the coordinator
    assert not mgr.coord._reduced and not mgr.coord._barriers
    for r in res["results"].values():
        assert r["comms"]["data_plane"] == "chain"
        assert r["comms"]["bytes_sent"] > 0 and r["comms"]["bytes_recv"] > 0
        assert r["device"] == "cpu" and r["steps_run"] == 6
        assert r["final_loss"] == ref["final_loss"]
    res_star = ClusterManager(tmp_path / "star", workers=2, total_steps=6,
                              global_batch=32, ckpt_every=3, aot=True,
                              model=model, data_plane="star",
                              device="cpu").run(timeout=180)
    ds = _digests(res_star)
    assert set(ds.values()) == {ref["params_digest"]}, (ds, ref)
    for r in res_star["results"].values():
        assert r["comms"]["data_plane"] == "star"
    assert mgr.procs and not any(p.alive() for p in mgr.procs.values())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torch_backend_is_bitwise_the_chain(tmp_path, monkeypatch):
    """``DL4JTPU_CLUSTER_BACKEND=torch``: the vectors go through a gloo
    all-gather summed in rank order -- the chain's digest."""
    ref = single_process_reference(model="mlp", total_steps=4, world=2,
                                   device="cpu")
    monkeypatch.setenv("DL4JTPU_CLUSTER_BACKEND", "torch")
    monkeypatch.setenv("DL4JTPU_TORCH_COORD", f"127.0.0.1:{_free_port()}")
    res = ClusterManager(tmp_path / "torch", workers=2, total_steps=4,
                         global_batch=32, ckpt_every=2,
                         device="cpu").run(timeout=180)
    assert set(_digests(res).values()) == {ref["params_digest"]}
    for r in res["results"].values():
        assert r["comms"]["torch_collectives"] is True


def test_sigkill_replacement_restores_recipes_and_is_bitwise(tmp_path):
    """Worker 1 SIGKILLs itself at step 5: its replacement joins the same
    job, restores the step-4 anchor and the artifact's recipes (a restore
    on the CPU is one eager call checked against the recipe), and every
    member ends on the unkilled digest."""
    ref = single_process_reference(model="mlp", total_steps=8, world=2,
                                   device="cpu")
    # a grace far past a replacement's start, so a loaded host cannot turn
    # the drill into a degraded commit (the slow partition test has that)
    mgr = ClusterManager(tmp_path / "kill", workers=2, total_steps=8,
                         global_batch=32, ckpt_every=4, aot=True,
                         replacement_grace=60.0,
                         chaos={1: "die_at_step=5"}, device="cpu")
    res = mgr.run(timeout=180)
    d = _digests(res)
    assert set(d.values()) == {ref["params_digest"]}, (d, ref)
    assert res["spawns"] == 3 and res["replacements"] == 1
    assert res["generation"] >= 2
    r1 = res["results"]["w1r1"]
    assert r1["rejoined"] and r1["aot_restored"] == 2
    assert r1["aot_rejected"] == 0
    assert "CLUSTER_AOT restored=2" in mgr.procs["w1r1"].log_text()
    assert mgr.procs["w0"].proc.returncode == 0
    assert mgr.procs["w1"].proc.returncode == -9


def test_cuda_without_a_card_exits_5_before_joining(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    coord = port_elastic.ElasticCoordinator(1)
    srv = port_elastic.CoordinatorServer(coord).start()
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH",
                                                             "")
        out = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.exec.worker",
             "--coordinator", srv.url, "--worker-id", "w0", "--device",
             "cuda", "--port-file", str(tmp_path / "w0.port")],
            env=env, cwd=tmp_path, capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 5, out.stdout + out.stderr
        assert "device='cpu'" in out.stdout + out.stderr
        assert coord.state()["members"] == {} and coord._joins == 0
        assert not (tmp_path / "w0.port").exists()
    finally:
        srv.stop()


def test_cluster_manager_refuses_a_dead_start(tmp_path):
    """Every worker exiting before the job is done (here: asked for a
    card that is missing) raises from ``run`` with their exit codes, and
    nothing is left running."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mgr = ClusterManager(tmp_path / "dead", workers=2, total_steps=2,
                         device="cuda")
    with pytest.raises(RuntimeError, match="every worker exited"):
        mgr.run(timeout=120)
    assert all(p.proc.returncode == 5 for p in mgr.procs.values())


@pytest.mark.slow
def test_sigkill_and_rejoin_is_bitwise_and_restarts_nothing(tmp_path):
    ref = ClusterManager(tmp_path / "ref", workers=4, total_steps=10,
                         global_batch=32, ckpt_every=4, aot=True,
                         device="cpu").run(timeout=240)
    dr = _digests(ref)
    assert len(set(dr.values())) == 1, dr
    mgr = ClusterManager(tmp_path / "kill", workers=4, total_steps=10,
                         global_batch=32, ckpt_every=4, aot=True,
                         chaos={2: "die_at_step=6"}, device="cpu")
    res = mgr.run(timeout=240)
    dk = _digests(res)
    assert len(set(dk.values())) == 1, dk
    assert set(dk.values()) == set(dr.values()), (dr, dk)
    assert res["replacements"] == 1 and res["spawns"] == 5
    assert res["generation"] == 2
    assert "w2r1" in res["results"]
    assert res["results"]["w2r1"]["rejoined"]
    assert res["results"]["w2r1"]["aot_restored"] >= 1
    for wid in ("w0", "w1", "w3"):
        assert mgr.procs[wid].proc.returncode == 0, wid
    assert 0 < res["last_recovery_wall"] < 60
    evs = [e["type"] for e in res["events"]]
    assert "evicted" in evs and "generation_committed" in evs


@pytest.mark.slow
def test_kill_before_first_checkpoint_recovers_bitwise(tmp_path):
    ref = ClusterManager(tmp_path / "ref", workers=2, total_steps=6,
                         global_batch=32, ckpt_every=4, aot=False,
                         device="cpu").run(timeout=240)
    dr = _digests(ref)
    assert len(set(dr.values())) == 1, dr
    mgr = ClusterManager(tmp_path / "kill", workers=2, total_steps=6,
                         global_batch=32, ckpt_every=4, aot=False,
                         chaos={1: "die_at_step=1"}, device="cpu")
    res = mgr.run(timeout=240)
    dk = _digests(res)
    assert len(set(dk.values())) == 1, dk
    assert set(dk.values()) == set(dr.values()), (dr, dk)
    assert res["replacements"] == 1 and res["spawns"] == 3
    assert res["reduced_steps"] == 6


@pytest.mark.slow
def test_threshold_codec_survives_kill_and_resets_residuals(tmp_path):
    mgr = ClusterManager(tmp_path / "thr", workers=3, total_steps=10,
                         global_batch=30, ckpt_every=3, aot=True,
                         model="charlstm", codec="threshold",
                         bucket_mb=0.005, capacity_fraction=0.05,
                         chaos={1: "die_at_step=5"}, device="cpu")
    res = mgr.run(timeout=240)
    assert res["replacements"] == 1 and res["spawns"] == 4
    assert res["reduced_steps"] == 10
    digs = _digests(res)
    assert len(set(digs.values())) == 1, digs
    for wid, r in res["results"].items():
        assert np.isfinite(r["final_loss"])
        assert r["comms"]["codec"] == "threshold"
        assert r["comms"]["compression_ratio"] > 2.0, (wid, r["comms"])
    for wid in ("w0", "w2"):
        assert res["results"][wid]["comms"]["residual_resets"] >= 1, wid


@pytest.mark.slow
def test_partition_evicts_and_cluster_continues_degraded(tmp_path):
    mgr = ClusterManager(tmp_path / "part", workers=3, total_steps=10,
                         global_batch=30, ckpt_every=3, aot=False,
                         hb_interval=0.2, suspect_after=0.8,
                         evict_after=2.0, replacement_grace=2.0,
                         replace=False, partition=[2],
                         chaos={i: "slow_ms=700" for i in range(3)},
                         device="cpu")
    mgr.start()
    try:
        deadline = time.monotonic() + 120
        while mgr.coord.reduced_steps < 4:   # train past the first anchor
            if time.monotonic() > deadline:
                raise TimeoutError("cluster never reached step 4")
            time.sleep(0.05)
        assert mgr.procs["w2"].alive()
        mgr.partition_worker("w2")
    except BaseException:
        mgr.stop()
        raise
    res = mgr.run(timeout=180)
    assert res["world"] == 2
    assert set(res["results"]) == {"w0", "w1"}
    digs = {r["params_digest"] for r in res["results"].values()}
    assert len(digs) == 1, res["results"]
    evicted = [e for e in res["events"] if e["type"] == "evicted"]
    assert evicted and evicted[0]["worker_id"] == "w2"
    assert evicted[0]["reason"] == "lease_expired"
    degraded = [e for e in res["events"]
                if e["type"] == "generation_committed" and e["world"] == 2]
    assert degraded, res["events"]
    assert res["reduced_steps"] == 10
