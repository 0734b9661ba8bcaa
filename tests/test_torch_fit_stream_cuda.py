"""The fit contract on the card (every test here is marked ``cuda`` and
skips without one; the file imports no JAX, so it runs on a machine with a
card: ``python -m pytest tests/test_torch_fit_stream_cuda.py -q``).

At small width (2 x LSTM(16), vocab 9, B=4, T=8; 8 batches an epoch in
chunks of 3): ``fit(iterator)`` with prefetch 0 and 2 trains the same
bits through the same captured steps, the prefetcher's items are on the
card and at least one is staged mid-stream; ``restore_into`` a network
that has already captured its step copies into the graph's buffers, and
the next replayed step equals the step of a network loaded from the zip
and of the run that wrote it; remat gives the gradient of no remat bit
for bit under dropout and launches the training forward twice a step;
graph truncated BPTT replays three captured chunk signatures equal to the
eager chunks, with K2 and K3 once per LSTM and chunk.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork,
                                      ops)
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.data.prefetcher import DevicePrefetcher
from deeplearning4j_tpu_torch.exec.executor import seed_generator
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util import model_serializer
from deeplearning4j_tpu_torch.util.timing import PipelineTimer

V, H, T, B, BATCHES = 9, 16, 8, 4, 8
STEP = {"lstm2_fwd_train": 1, "lstm_bwd": 2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the prefetcher's streams and a "
                    "captured CUDA graph have no CPU mode")
    return torch.device("cuda")


def _layers(dropout=None):
    return [LSTM(n_out=H, activation="tanh", dropout=dropout),
            LSTM(n_out=H, activation="tanh"),
            RnnOutputLayer(n_out=V, activation="softmax", loss="mcxent")]


def _net(remat=False, dropout=None):
    lb = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3))
          .remat(remat).list())
    for l in _layers(dropout):
        lb.layer(l)
    net = MultiLayerNetwork(lb.set_input_type(InputType.recurrent(V)).build(),
                            device="cuda").init()
    net._CHUNK_MAX_STEPS = 3
    return net


def _graph(tbptt):
    g = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3))
         .graph_builder().add_inputs("in")
         .set_input_types(InputType.recurrent(V)))
    prev = "in"
    for i, l in enumerate(_layers()):
        g.add_layer(f"l{i}", l, prev)
        prev = f"l{i}"
    g.backprop_type("tbptt", tbptt, tbptt)
    return ComputationGraph(g.set_outputs(prev).build(), device="cuda").init()


def _data(seed, t=T, n=B * BATCHES):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    return eye[r.randint(0, V, (n, t))], eye[r.randint(0, V, (n, t))]


def _iter(seed=0):
    return ListDataSetIterator(DataSet(*_data(seed)), B, shuffle=True,
                               seed=5)


def _tensors(net):
    items = sorted(net.params.items()) if isinstance(net.params, dict) \
        else enumerate(net.params)
    return [p[k] for _, p in items for k in sorted(p)]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


@pytest.mark.cuda
def test_prefetch_two_trains_the_bits_of_prefetch_zero(cuda_device):
    nets = {d: _net() for d in (0, 2)}
    for d, net in nets.items():
        ops.reset_launch_counts()
        net.fit(_iter(), epochs=2, prefetch=d)
        torch.cuda.synchronize()
        assert ops.launch_counts() == {k: n * 2 * BATCHES
                                       for k, n in STEP.items()}
        assert net._capture_count == 1
    assert _equal(nets[0], nets[2])
    assert nets[0].get_score() == nets[2].get_score()
    # the staged items are on the card, one at least staged mid-stream
    pf = DevicePrefetcher(nets[2]._stream_chunks(_iter(), PipelineTimer()),
                          depth=2, device="cuda")
    items = []
    for item in pf:
        items.append((item, pf.buffered))
    assert [b for _, b in items] == [2, 1, 0]
    assert all(t.is_cuda for (kind, (xs, ys)), _ in items for t in (xs, ys))


@pytest.mark.cuda
def test_restore_into_a_captured_network_replays_the_restored_step(
        cuda_device, tmp_path):
    x, y = _data(1, n=B)
    writer = _net()
    for _ in range(3):
        writer.fit(x, y)                # warm-up, capture, replay
    path = tmp_path / "c.zip"
    writer.save(path)
    target = _net()
    for k in range(3):
        target.fit(*_data(10 + k, n=B))
    assert target._capture_count == 1
    ptrs = [t.data_ptr() for t in _tensors(target)]
    model_serializer.restore_into(target, path)
    assert ptrs == [t.data_ptr() for t in _tensors(target)]
    assert target.iteration == 3 and int(target.opt_state[0]["0/.count"]) == 3
    loaded = MultiLayerNetwork.load(path, device="cuda")
    loaded._capture_steps = False
    x2, y2 = _data(2, n=B)
    for net in (target, loaded, writer):
        net.fit(x2, y2)
    assert target._capture_count == 1          # replayed, not recaptured
    assert _equal(target, loaded) and _equal(target, writer)
    assert target.get_score() == writer.get_score()


@pytest.mark.cuda
def test_remat_gradient_equals_no_remat_and_replays_the_forward(cuda_device):
    x, y = (torch.from_numpy(a).cuda() for a in _data(4, n=B))
    plain, remat = _net(dropout=0.5), _net(remat=True, dropout=0.5)
    remat.set_params(plain.params)
    grads = []
    for net in (plain, remat):
        seed_generator(net._gen, 3, 0)
        ops.reset_launch_counts()
        grads.append(net._gradients(x, y, gen=net._gen)[1])
        torch.cuda.synchronize()
        want = {"lstm2_fwd_train": 1 + (net is remat), "lstm_bwd": 2}
        assert ops.launch_counts() == want
    for a, b in zip(*grads):
        assert all(torch.equal(a[k], b[k]) for k in a)
    counts = []
    for k in range(3):
        ops.reset_launch_counts()
        plain.fit(*_data(20 + k, n=B))
        remat.fit(*_data(20 + k, n=B))
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
    assert counts == [{"lstm2_fwd_train": 3, "lstm_bwd": 4}] * 3
    assert _equal(plain, remat) and remat._capture_count == 1


@pytest.mark.cuda
def test_graph_tbptt_replays_equal_the_eager_chunks(cuda_device):
    eager, captured = _graph(3), _graph(3)
    eager._capture_steps = False
    counts = []
    for k in range(4):
        x, y = _data(30 + k, n=B)
        for net in (eager, captured):
            ops.reset_launch_counts()
            net.fit(x, y)
            torch.cuda.synchronize()
            counts.append(ops.launch_counts())
    assert _equal(eager, captured)
    assert eager.get_score() == captured.get_score()
    # T=8 in chunks of 3: 3 chunks, each K2 and K3 once per LSTM
    assert counts == [{"lstm_fwd_train": 6, "lstm_bwd": 6}] * 8
    assert captured._capture_count == 3
