"""Dropout, weight noise and feature masks inside the captured train step,
on the card (every test here is marked ``cuda`` and skips without one; the
file imports no JAX, so it runs on a machine with a card: ``python -m
pytest tests/test_torch_regularised_cuda.py -q``).

From one initial state, ten steps of the S-shaped nets at small width (H
16, vocab 9, B=4, T=8; TinyTransformer d_model 32) eager and captured:
parameters and losses bit for bit equal (a replay draws from the seed the
host set before it, as the eager step does), every step's launches under
replay equal to the eager step's and to the kernels the screens choose
(S1: K4-train and two K3; S2/S3: two K2 and two K3; S4: three of each;
S5: two each of K5, K6, K7); one capture per signature, masked and
unmasked (a masked batch runs the LSTM's own loop, no kernel); a
registered generator's replay follows ``manual_seed``; and a capture
survives the networks (and their graphs) that died before it, with the
cyclic collector set to run at every allocation.
"""

import gc

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork,
                                      ops)
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.exec import get_executor
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (LSTM, Bidirectional,
                                                LastTimeStep, OutputLayer,
                                                RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect
from deeplearning4j_tpu_torch.zoo import TinyTransformer

V, H, T, B, STEPS = 9, 16, 8, 4, 10
LAUNCHES = {
    "S1": {"lstm2_fwd_train": 1, "lstm_bwd": 2},
    "S2": {"lstm_fwd_train": 2, "lstm_bwd": 2},
    "S3": {"lstm_fwd_train": 2, "lstm_bwd": 2},
    "S4": {"lstm_fwd_train": 3, "lstm_bwd": 3},
    "S5": {"flash_attn_fwd": 2, "flash_attn_dq": 2, "flash_attn_dkv": 2},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a captured CUDA graph has no "
                    "CPU mode")
    return torch.device("cuda")


def _net(kind, device):
    if kind == "S5":
        conf = TinyTransformer(vocab_size=V, d_model=32, n_heads=4,
                               max_len=64).conf()
        for node in conf.nodes.values():
            if node.layer is not None:
                node.layer.dropout = 0.1
        return ComputationGraph(conf, device=device).init()
    b = NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3))
    if kind == "S2":
        b = b.dropout(0.2)
    elif kind == "S3":
        b = b.weight_noise(DropConnect(weight_retain_prob=0.8))
    lb = b.list()
    if kind == "S4":
        lb = (lb.layer(Bidirectional(fwd=LSTM(n_out=H, activation="tanh")))
              .layer(LastTimeStep(fwd=LSTM(n_out=H, activation="tanh")))
              .layer(OutputLayer(n_out=V, activation="softmax",
                                 loss="mcxent")))
    else:
        lb = (lb.layer(LSTM(n_out=H, activation="tanh",
                            dropout=0.5 if kind == "S1" else None))
              .layer(LSTM(n_out=H, activation="tanh"))
              .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                    loss="mcxent")))
    conf = lb.set_input_type(InputType.recurrent(V)).build()
    return MultiLayerNetwork(conf, device=device).init()


def _batches(kind, n, seed=0):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    out = []
    for _ in range(n):
        x, y = eye[r.randint(0, V, (B, T))], eye[r.randint(0, V, (B, T))]
        out.append((x, y[:, -1] if kind == "S4" else y))
    return out


def _run(net, batches, masks=None):
    counts = []
    for k, (x, y) in enumerate(batches):
        ops.reset_launch_counts()
        m = None if masks is None else masks[k]
        net.fit(DataSet(x, y, m, m))
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
    return counts


def _tensors(net):
    items = net.params.values() if isinstance(net.params, dict) \
        else net.params
    return [v for p in items for v in p.values()]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(LAUNCHES))
def test_captured_equals_eager_bit_for_bit(cuda_device, kind):
    eager, captured = _net(kind, "cuda"), _net(kind, "cuda")
    eager._capture_steps = False
    batches = _batches(kind, STEPS)
    c_e = _run(eager, batches)
    c_c = _run(captured, batches)
    for a, b in zip(_tensors(eager), _tensors(captured)):
        assert torch.equal(a, b)
    assert eager.get_score() == captured.get_score()
    assert c_e == c_c == [LAUNCHES[kind]] * STEPS
    assert captured._capture_count == 1


@pytest.mark.cuda
def test_one_capture_per_signature_masked_and_unmasked(cuda_device):
    eager, captured = _net("S1", "cuda"), _net("S1", "cuda")
    eager._capture_steps = False
    batches = _batches("S1", 8, seed=1)
    lengths = np.random.RandomState(2).randint(2, T + 1, (8, B))
    masks = [(np.arange(T)[None, :] < n[:, None]).astype(np.float32)
             if k % 2 else None for k, n in enumerate(lengths)]
    c_e = _run(eager, batches, masks)
    c_c = _run(captured, batches, masks)
    for a, b in zip(_tensors(eager), _tensors(captured)):
        assert torch.equal(a, b)
    assert c_c == c_e
    assert c_e[1] == {} and c_e[0] == LAUNCHES["S1"]   # masked: own loop
    assert captured._capture_count == 2


@pytest.mark.cuda
def test_a_replay_follows_the_seed_set_before_it(cuda_device):
    gen = torch.Generator(device="cuda")
    out = torch.empty(1000, device="cuda")

    def step(x):
        out.copy_(torch.rand(1000, device="cuda", generator=gen) + x)
        return out
    graphs = get_executor().steps(step, generator=gen)
    x = torch.zeros(1000, device="cuda")
    draws = {}
    for seed in (1, 2, 3, 2):
        gen.manual_seed(seed)
        draws.setdefault(seed, []).append(graphs(x).clone())
    gen.manual_seed(2)
    eager = torch.rand(1000, device="cuda", generator=gen)
    assert graphs.captures == 1
    assert torch.equal(draws[2][0], draws[2][1])
    assert torch.equal(draws[2][0], eager)
    assert not torch.equal(draws[1][0], draws[3][0])


@pytest.mark.cuda
def test_a_capture_survives_dead_networks_graphs(cuda_device):
    batches = _batches("S2", 3, seed=3)
    threshold = gc.get_threshold()
    try:
        for _ in range(3):
            dead = _net("S2", "cuda")
            _run(dead, batches)         # warm-up, capture, replay
            assert dead._capture_count == 1
            del dead                    # a reference cycle, graphs inside
        gc.set_threshold(1)
        fresh, eager = _net("S1", "cuda"), _net("S1", "cuda")
        eager._capture_steps = False
        assert _run(fresh, batches) == _run(eager, batches)
    finally:
        gc.set_threshold(*threshold)
    assert fresh._capture_count == 1
    for a, b in zip(_tensors(eager), _tensors(fresh)):
        assert torch.equal(a, b)
