"""The port's process group, mesh and cross-rank data parallelism on the
CPU, against the JAX package.

- ``parallel.distributed``: the topology helpers, generations and
  ``fence``, ``initialize``'s environment and loopback fallback, and
  ``local_batch_slice`` over a grid of (global batch, world), each slice
  equal to the JAX function's.
- ``exec.mesh``: the ``DL4JTPU_MESH`` parser's sizes and errors against
  the JAX parser on the eight forced host devices (``mesh8``), slots
  repeating one device, two cards in one process refused, the model
  axis (a (data, model) grid of slots) and one-axis meshes, a
  model-parallel axis across ranks refused, the default mesh and its
  gauges.
- Two ranks over gloo in subprocesses (this file's ``__main__`` is the
  worker; a module fixture starts both with a timeout and kills them on
  expiry): synchronous steps of a dense net, of a BatchNormalization net
  with l2 on a ragged ``local_batch_slice`` (16 and 15 rows), averaging
  over 2 ranks x 2 slots, ``ParallelInference`` across the ranks and the
  collective ``SharedTrainingMaster``. Both ranks' parameters must agree
  bit for bit; the sync nets equal JAX single-device training on the
  global batch within 1e-5 (BatchNormalization's statistics global, the
  l2 gradient counted once), averaging equals JAX's wrapper on four
  devices and the master JAX's collective exchange on two, within 1e-5.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ATOL = 1e-5
WORKER_TIMEOUT = 240


# ------------------------------------------------------- topology helpers
def test_local_batch_slice_matches_jax_over_a_grid():
    from deeplearning4j_tpu.parallel.distributed import \
        local_batch_slice as jax_slice
    from deeplearning4j_tpu_torch.parallel.distributed import \
        local_batch_slice
    for n in (0, 1, 7, 31, 32, 33, 100):
        for world in (1, 2, 3, 4, 8):
            got = [local_batch_slice(n, r, world) for r in range(world)]
            assert got == [jax_slice(n, r, world) for r in range(world)]
            rows = [i for s in got for i in range(n)[s]]
            assert rows == list(range(n))
            sizes = [s.stop - s.start for s in got]
            assert max(sizes) - min(sizes) <= 1
            assert sizes == sorted(sizes, reverse=True)


def test_topology_generation_and_fence():
    from deeplearning4j_tpu_torch.parallel import distributed as d
    assert d.topology() == (0, 1)
    d.set_topology(2, 5)
    try:
        assert d.topology() == (2, 5)
        assert d.local_batch_slice(11) == slice(5, 7)
    finally:
        d.set_topology(None, None)
    assert d.topology() == (0, 1)
    d.set_generation(3)
    try:
        assert d.generation() == 3
        d.fence(3)
        with pytest.raises(d.StaleGenerationError, match="generation 2"):
            d.fence(2)
    finally:
        d.set_generation(0)


def test_initialize_reads_the_environment_and_refuses_mismatches(
        monkeypatch):
    """Without a coordinator, a rank and world from DL4JTPU_RANK /
    DL4JTPU_WORLD are only recorded (JAX's loopback fallback); a
    coordinator without them, or NCCL for the CPU, raises before any
    connection."""
    from deeplearning4j_tpu_torch.parallel import distributed as d
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("DL4JTPU_RANK", "1")
    monkeypatch.setenv("DL4JTPU_WORLD", "3")
    try:
        d.initialize(generation=4)
        assert d.topology() == (1, 3) and d.generation() == 4
        assert not torch.distributed.is_initialized()
    finally:
        d.set_topology(None, None)
        d.set_generation(0)
    monkeypatch.delenv("DL4JTPU_RANK")
    monkeypatch.delenv("DL4JTPU_WORLD")
    with pytest.raises(ValueError, match="process count"):
        d.initialize("127.0.0.1:1")
    with pytest.raises(ValueError, match="NCCL"):
        d.initialize("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------------ mesh
@pytest.mark.mesh8
@pytest.mark.parametrize("spec", ["off", "data=8", "data=4", "data=2",
                                  "data=3", "data=16", "",
                                  "data=4,model=2", "model=2", "model=4",
                                  "data=2,model=2", "model=3",
                                  "data=8,model=2"])
def test_mesh_parser_matches_jax(spec):
    """DL4JTPU_MESH over eight slots on the CPU: the same sizes as the JAX
    parser over eight host devices, or the same error."""
    from deeplearning4j_tpu.exec import mesh as jax_mesh
    from deeplearning4j_tpu_torch.exec import mesh
    devices = ["cpu"] * 8
    try:
        want = dict(jax_mesh._mesh_from_env(spec).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh._mesh_from_env(spec, devices)
        assert str(got.value) == str(e)
        return
    m = mesh._mesh_from_env(spec, devices)
    assert m.shape == want
    assert all(s.device.type == "cpu" and s.rank == 0 for s in m.slots)


def test_mesh_slots_model_axis_and_cards():
    from deeplearning4j_tpu_torch.exec import mesh
    m = mesh.build_mesh(["cpu"] * 4)
    assert m.shape == {"data": 4, "model": 1} and m.size == 4
    assert m.local_slots(0) == m.slots and m.ranks == [0]
    # the model axis (tensor parallelism): a (data, model) grid of slots
    m = mesh.build_mesh(["cpu"] * 4, model_parallel=2)
    assert m.shape == {"data": 2, "model": 2}
    assert m.devices.shape == (2, 2) and len(m.axis_slots("model")) == 2
    assert mesh._mesh_from_env("model=2", ["cpu"] * 4).shape == \
        {"data": 2, "model": 2}
    assert not hasattr(mesh, "TensorParallelNotPorted")
    # one-axis meshes of the other modes, and a model axis across ranks
    assert mesh.Mesh([mesh.Slot(0, "cpu")] * 4, ("seq",)).shape == \
        {"seq": 4}
    two = [mesh.Slot(0, "cpu"), mesh.Slot(1, "cpu")]
    with pytest.raises(ValueError, match="ROADMAP item 7"):
        mesh.Mesh(two, ("data", "model"), (1, 2))
    with pytest.raises(ValueError, match="spans ranks"):
        mesh.Mesh(two, ("pipe",))
    assert mesh.Mesh(two, ("data", "model"), (2, 1)).ranks == [0, 1]
    with pytest.raises(ValueError, match="one process per device"):
        mesh.build_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="one process per device"):
        mesh.build_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="does not divide"):
        mesh.build_mesh(["cpu"] * 3, model_parallel=2)


def test_default_mesh_slots_env_and_gauges(monkeypatch):
    from deeplearning4j_tpu_torch.exec import mesh
    from deeplearning4j_tpu_torch.monitor.metrics import get_registry
    from deeplearning4j_tpu_torch.parallel import distributed
    monkeypatch.setattr(distributed, "_device", torch.device("cpu"))
    env = mesh.host_device_env(8, base={})
    assert env == {"DL4JTPU_SLOTS": "8"}
    monkeypatch.setenv("DL4JTPU_SLOTS", "8")
    monkeypatch.delenv("DL4JTPU_MESH", raising=False)
    mesh.set_default_mesh(None)
    try:
        m = mesh.default_mesh()
        assert m.size == 8 and mesh.default_mesh() is m
        text = get_registry().render()
        assert "dl4jtpu_mesh_devices 8" in text
        assert 'dl4jtpu_mesh_axis_size{axis="data"} 8' in text
        monkeypatch.setenv("DL4JTPU_MESH", "data=2")
        mesh.set_default_mesh(None)
        assert mesh.default_mesh().shape == {"data": 2, "model": 1}
        mine = mesh.build_mesh(["cpu"])
        mesh.set_default_mesh(mine)
        assert mesh.default_mesh() is mine
    finally:
        mesh.set_default_mesh(None)


def test_wrapper_default_mesh_spreads_slots_over_ranks():
    from deeplearning4j_tpu_torch.parallel import distributed
    from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh
    assert default_mesh(8, device="cpu").shape == {"data": 8}
    distributed.set_topology(1, 2)
    try:
        m = default_mesh(4, device="cpu")
        assert [s.rank for s in m.slots] == [0, 0, 1, 1]
        assert len(m.local_slots(1)) == 2
        with pytest.raises(ValueError, match="evenly"):
            default_mesh(3, device="cpu")
    finally:
        distributed.set_topology(None, None)


# --------------------------------------------------- two ranks over gloo
N_SYNC, N_RAGGED, N_AVG = 32, 31, 32
STEPS = 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_mln(bn=False, l2=0.0, lr=0.05, updater="sgd", seed=5):
    from deeplearning4j_tpu import MultiLayerNetwork as JaxMLN
    from deeplearning4j_tpu import NeuralNetConfiguration as JaxConf
    from deeplearning4j_tpu.nn.conf.inputs import InputType
    from deeplearning4j_tpu.nn.layers import (BatchNormalization,
                                              DenseLayer, OutputLayer)
    from deeplearning4j_tpu.nn.updaters import Adam, Sgd
    b = JaxConf.builder().seed(seed).updater(
        Sgd(lr) if updater == "sgd" else Adam(lr))
    if l2:
        b = b.l2(l2)
    lst = b.list().layer(DenseLayer(n_out=16, activation="tanh"))
    if bn:
        lst = lst.layer(BatchNormalization())
    conf = (lst.layer(OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _data(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x.sum(axis=1) * 2).astype(int) % 3]
    return x, y


CASES = {   # name -> (jax net kwargs, global rows, steps)
    "dense": (dict(), N_SYNC, STEPS),
    "bn_l2": (dict(bn=True, l2=1e-3), N_RAGGED, STEPS),
    "l2_adam": (dict(l2=1e-2, updater="adam", lr=0.01), N_RAGGED, STEPS),
    "avg": (dict(lr=0.1), N_AVG, 4),
    "shared": (dict(), 64, 1),
}


def _save_net(tmp, name, jnet):
    from test_torch_regularised_training import flat
    (tmp / f"{name}.json").write_text(jnet.conf.to_json())
    np.savez(tmp / f"{name}_init.npz", **flat(jnet.params))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Run the two gloo ranks once; returns (tmp dir, JAX nets by case)."""
    tmp = tmp_path_factory.mktemp("gloo")
    jnets = {}
    for name, (kw, n, steps) in CASES.items():
        jnets[name] = _jax_mln(**kw)
        _save_net(tmp, name, jnets[name])
        xs, ys = zip(*[_data(n, seed=s) for s in range(steps)])
        np.savez(tmp / f"{name}_data.npz", x=np.stack(xs), y=np.stack(ys))
    port = _free_port()
    env = dict(os.environ)
    root = Path(__file__).resolve().parents[1]
    env["PYTHONPATH"] = (str(root) + os.pathsep + str(root / "tests")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env.pop("DL4JTPU_RANK", None)
    env.pop("DL4JTPU_WORLD", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), "2", str(port), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("gloo ranks hung:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out}"
        assert f"RANK_{rank}_OK" in out, out
    return tmp, jnets


def _rank_params(tmp, name):
    return [dict(np.load(tmp / f"{name}_rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("name", ["dense", "bn_l2", "l2_adam", "avg",
                                  "shared"])
def test_two_ranks_agree_bit_for_bit(two_ranks, name):
    tmp, _ = two_ranks
    a, b = _rank_params(tmp, name)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), (name, k)


@pytest.mark.parametrize("name", ["dense", "bn_l2", "l2_adam"])
def test_two_rank_sync_equals_jax_single_device(two_ranks, name):
    """Each rank its local_batch_slice (16 / 16, or 16 / 15 rows), one slot
    a rank: the result is JAX's single-device training on the global
    batch, BatchNormalization's running statistics included."""
    from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
    from test_torch_regularised_training import flat
    tmp, jnets = two_ranks
    jnet = jnets[name]
    d = np.load(tmp / f"{name}_data.npz")
    for x, y in zip(d["x"], d["y"]):
        jnet.fit(JaxDataSet(x, y))
    got = _rank_params(tmp, name)[0]
    for k, w in flat(jnet.params).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=ATOL,
                                   err_msg=k)
    if name == "bn_l2":
        st = dict(np.load(tmp / "bn_l2_state_rank0.npz"))
        for k in ("mean", "var"):
            np.testing.assert_allclose(st[k], np.asarray(jnet.state[1][k]),
                                       atol=ATOL)


@pytest.mark.mesh8
def test_two_rank_averaging_equals_jax_on_four_devices(two_ranks):
    """averaging_frequency 2 over 2 ranks x 2 slots equals JAX's wrapper
    with four devices on the global batches."""
    from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu.parallel import ParallelWrapper as JaxPW
    from test_torch_regularised_training import flat
    tmp, jnets = two_ranks
    jnet = jnets["avg"]
    d = np.load(tmp / "avg_data.npz")
    JaxPW(jnet, workers=4, averaging_frequency=2).fit(
        [JaxDataSet(x, y) for x, y in zip(d["x"], d["y"])])
    got = _rank_params(tmp, "avg")[0]
    for k, w in flat(jnet.params).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.mesh8
def test_two_rank_shared_master_equals_jax_collective(two_ranks):
    """The collective SharedTrainingMaster over two ranks (one slot each,
    the threshold messages all-reduced) equals JAX's shard_map exchange
    over two devices, and so does the mean threshold."""
    import jax
    from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
    from deeplearning4j_tpu.scaleout import SharedTrainingMaster as JaxSTM
    from test_torch_regularised_training import flat
    tmp, jnets = two_ranks
    jnet = jnets["shared"]
    d = np.load(tmp / "shared_data.npz")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    master = JaxSTM(threshold=1e-3, learning_rate=0.1,
                    batch_size_per_worker=4, mesh=mesh)
    master.execute_training(jnet, [JaxDataSet(d["x"][0], d["y"][0])])
    got = _rank_params(tmp, "shared")[0]
    for k, w in flat(jnet.params).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=ATOL,
                                   err_msg=k)
    info = json.loads((tmp / "shared_rank0.json").read_text())
    assert abs(info["threshold"] - float(master.threshold)) < 1e-9
    assert info["iteration"] == jnet.iteration


def test_two_rank_parallel_inference_gathers_the_rows(two_ranks):
    """``output`` across two ranks: each rank's slice, all-gathered, equals
    the single-process forward within 1e-6 on both ranks."""
    tmp, _ = two_ranks
    outs = [np.load(tmp / f"pi_rank{r}.npy") for r in range(2)]
    want = np.load(tmp / "pi_want.npy")
    for o in outs:
        np.testing.assert_allclose(o, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- worker
def _port_net(tmp, name):
    from deeplearning4j_tpu_torch import (MultiLayerConfiguration,
                                          MultiLayerNetwork,
                                          params_from_numpy)
    conf = MultiLayerConfiguration.from_json(
        (tmp / f"{name}.json").read_text())
    init = dict(np.load(tmp / f"{name}_init.npz"))
    n = len(conf.layers)
    layers = [{k.split("/", 1)[1]: v for k, v in init.items()
               if k.split("/", 1)[0] == str(i)} for i in range(n)]
    return MultiLayerNetwork(conf, device="cpu").set_params(
        params_from_numpy(layers, device="cpu"))


def _flat(net):
    return {f"{i}/{k}": v.detach().numpy() for i, p in enumerate(net.params)
            for k, v in p.items()}


def _worker(rank, world, port, tmp):
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (ParallelInference,
                                                   ParallelWrapper,
                                                   distributed)
    from deeplearning4j_tpu_torch.scaleout import (ClusterMultiLayerNetwork,
                                                   SharedTrainingMaster)
    torch.set_num_threads(2)
    distributed.initialize(f"127.0.0.1:{port}", world, rank,
                           backend="gloo", device="cpu")
    assert distributed.topology() == (rank, world)
    for name in ("dense", "bn_l2", "l2_adam"):
        net = _port_net(tmp, name)
        d = np.load(tmp / f"{name}_data.npz")
        sl = distributed.local_batch_slice(d["x"].shape[1])
        ParallelWrapper(net).fit([DataSet(x[sl], y[sl])
                                  for x, y in zip(d["x"], d["y"])])
        np.savez(tmp / f"{name}_rank{rank}.npz", **_flat(net))
        if name == "bn_l2":
            np.savez(tmp / f"{name}_state_rank{rank}.npz",
                     **{k: v.numpy() for k, v in net.state[1].items()})
    net = _port_net(tmp, "avg")
    d = np.load(tmp / "avg_data.npz")
    sl = distributed.local_batch_slice(d["x"].shape[1])
    pw = ParallelWrapper(net, workers=4, averaging_frequency=2)
    assert len(pw.slots) == 2
    pw.fit([DataSet(x[sl], y[sl]) for x, y in zip(d["x"], d["y"])])
    np.savez(tmp / f"avg_rank{rank}.npz", **_flat(net))
    net = _port_net(tmp, "shared")
    d = np.load(tmp / "shared_data.npz")
    master = SharedTrainingMaster(threshold=1e-3, learning_rate=0.1,
                                  batch_size_per_worker=4,
                                  mesh=distributed.pod_mesh())
    ClusterMultiLayerNetwork(net, master).fit([DataSet(d["x"][0],
                                                       d["y"][0])])
    np.savez(tmp / f"shared_rank{rank}.npz", **_flat(net))
    (tmp / f"shared_rank{rank}.json").write_text(json.dumps(
        {"threshold": master.threshold, "iteration": net.iteration}))
    net = _port_net(tmp, "dense")
    x = np.random.RandomState(7).rand(13, 4).astype(np.float32)
    np.save(tmp / f"pi_rank{rank}.npy",
            ParallelInference(net).output(x).numpy())
    if rank == 0:
        np.save(tmp / "pi_want.npy", net.output(x, bucketed=False).numpy())
    distributed.shutdown()
    print(f"RANK_{rank}_OK", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            Path(sys.argv[4]))
