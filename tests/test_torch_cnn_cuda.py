"""The convolutional path on the card, at small sizes: phase 12 of
chip_smoke.py in little. Every test is marked ``cuda`` and skips without
a card; the file imports no JAX (``python -m pytest
tests/test_torch_cnn_cuda.py -q`` on a machine with one).

- ``lenet.zip`` served on the card: probabilities within 1e-4 of the CPU
  port's from the same zip.
- LeNet from its seed on the uint8 wire (the /255 on the card): three
  steps' losses and parameters within rtol 1e-4 of the CPU port's;
  captured steps equal eager ones bit for bit (deterministic cuDNN).
- ResNet50 at width_mult 0.125 on 64 x 64 (a ComputationGraph with 53
  BatchNormalizations): a B=4 float32 step's loss and running statistics
  within 1e-3 of the CPU port's, and two float64 steps'; three captured
  steps equal three eager ones bit for bit, the running statistics
  included.
- A checkpointed SimpleCNN fit (uint8 wire, dropout, BatchNormalization)
  interrupted and resumed ends at the uninterrupted run's bits.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.data.fetchers import (_synthetic_images,
                                                    _uint8_wire, load_mnist)
from deeplearning4j_tpu_torch.data.normalizers import \
    ImagePreProcessingScaler
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.resilience import CheckpointListener
from deeplearning4j_tpu_torch.zoo import LeNet, ResNet50, SimpleCNN

LOSS_RTOL, RESNET_TOL = 1e-4, 1e-3


@pytest.fixture
def cuda_device():
    """The card, with TF32 off for cuDNN and matmuls (PyTorch's default
    lets cuDNN's convolutions round to TF32; the port sets no global
    flag, so a comparison with the CPU turns it off itself)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: cuDNN and a captured CUDA graph "
                    "have no CPU mode")
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


@pytest.fixture
def deterministic():
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = old


def _equal(a, b):
    items = a.items() if isinstance(a, dict) else enumerate(a)
    other = dict(b.items() if isinstance(b, dict) else enumerate(b))
    return all(torch.equal(p[k].cpu(), other[n][k].cpu())
               for n, p in items for k in p)


def _rel(a, b):
    """The largest difference of two trees, each tensor's relative to its
    largest magnitude."""
    items = a.items() if isinstance(a, dict) else enumerate(a)
    other = dict(b.items() if isinstance(b, dict) else enumerate(b))
    return max(float((p[k].cpu() - other[n][k].cpu()).abs().max()
                     / max(other[n][k].abs().max().item(), 1e-30))
               for n, p in items for k in p)


def _wire(rows=384, seed=0):
    x, y = load_mnist(train=True, num_examples=rows, flatten=False,
                      seed=seed)
    it = ListDataSetIterator(DataSet(_uint8_wire(x), y), 128)
    return it.set_pre_processor(ImagePreProcessingScaler(device_side=True))


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch):
        self.scores.append(model.get_score())


@pytest.mark.cuda
def test_lenet_zip_served_on_the_card_matches_the_cpu(cuda_device):
    x, _ = load_mnist(train=False, num_examples=200, flatten=False)
    card = LeNet(num_classes=10).init_pretrained(device=cuda_device)
    cpu = LeNet(num_classes=10).init_pretrained(device="cpu")
    got = card.output(x).float().cpu().numpy()
    assert np.abs(got - cpu.output(x).numpy()).max() <= 1e-4


@pytest.mark.cuda
def test_lenet_on_the_uint8_wire_matches_the_cpu_and_replays_bitwise(
        cuda_device, deterministic):
    card = LeNet(num_classes=10).init(device=cuda_device)
    cpu = MultiLayerNetwork(card.conf, device="cpu").set_params(card.params,
                                                                card.state)
    recs = []
    for net in (card, cpu):
        net._CHUNK_MAX_STEPS = 1
        recs.append(_Scores())
        net.set_listeners(recs[-1])
        net.fit(_wire())
    np.testing.assert_allclose(recs[0].scores, recs[1].scores,
                               rtol=LOSS_RTOL)
    assert _rel(card.params, cpu.params) <= LOSS_RTOL
    cap = LeNet(num_classes=10).init(device=cuda_device)
    eager = LeNet(num_classes=10).init(device=cuda_device)
    eager._capture_steps = False
    for net in (cap, eager):
        net.fit(_wire(), epochs=2)
    assert cap._capture_count == 1 and eager._capture_count == 0
    assert _equal(cap.params, eager.params)


def _resnet(device):
    """Sgd: an Adam step moves near-zero-gradient weights by +-lr with the
    sign of their rounding, so two implementations part after one."""
    return ResNet50(num_classes=10, input_shape=(64, 64, 3),
                    width_mult=0.125, updater=Sgd(1e-2)).init(device=device)


def _images(n, seed):
    r = np.random.RandomState(seed)
    return (r.rand(n, 64, 64, 3).astype(np.float32),
            np.eye(10, dtype=np.float32)[r.randint(0, 10, n)])


@pytest.mark.cuda
def test_resnet50_matches_the_cpu_and_replays_bitwise(cuda_device,
                                                      deterministic):
    x, y = _images(4, 1)
    # one float32 step
    card = _resnet(cuda_device)
    cpu = ComputationGraph(card.conf, device="cpu").set_params(card.params,
                                                               card.state)
    for net in (card, cpu):
        net.fit([x], [y])
    np.testing.assert_allclose(card.get_score(), cpu.get_score(),
                               rtol=RESNET_TOL)
    assert _rel(card.state, cpu.state) <= RESNET_TOL
    # two float64 steps (the float32 backward of this configuration keeps
    # few digits: chip_smoke.py's resnet_part)
    base = _resnet("cpu")
    conf = base.conf
    conf.global_conf.dtype = "float64"
    params = {n: {k: v.double() for k, v in p.items()}
              for n, p in base.params.items()}
    losses = []
    for dev in (cuda_device, torch.device("cpu")):
        net = ComputationGraph(conf, device=dev).set_params(params)
        xs, ys = (torch.from_numpy(a).double().to(dev) for a in (x, y))
        losses.append([])
        for _ in range(2):
            net.fit([xs], [ys])
            losses[-1].append(net.get_score())
        if dev.type == "cuda":
            card = net
    np.testing.assert_allclose(losses[0], losses[1], rtol=RESNET_TOL)
    assert _rel(card.state, net.state) <= RESNET_TOL
    # captured against eager, bit for bit
    cap, eager = _resnet(cuda_device), _resnet(cuda_device)
    eager._capture_steps = False
    x, y = _images(8, 2)
    for net in (cap, eager):
        for _ in range(3):
            net.fit([x], [y])
    assert cap._capture_count == 1
    assert _equal(cap.params, eager.params)
    assert _equal(cap.state, eager.state)


class _Stop(RuntimeError):
    pass


class _StopAfter:
    def __init__(self, it):
        self.it = it

    def iteration_done(self, model, iteration, epoch):
        if epoch == 1 and iteration > self.it:
            raise _Stop()


def _simplecnn_fit(device, directory, stop=None, resume=False):
    x, y = _synthetic_images(128, 16, 16, 3, 5, seed=11)
    it = ListDataSetIterator(DataSet(_uint8_wire(x),
                                     np.eye(5, dtype=np.float32)[y]), 16,
                             shuffle=True, seed=5)
    scaler = ImagePreProcessingScaler(device_side=True)
    it.set_pre_processor(scaler)
    net = SimpleCNN(num_classes=5, input_shape=(16, 16, 3)).init(
        device=device)
    net._CHUNK_MAX_STEPS = 2
    if stop is not None:
        net.set_listeners(_StopAfter(stop))
    kw = ({"resume_from": directory} if resume else
          {"checkpoint": CheckpointListener(directory, every_n_iterations=2,
                                            normalizer=scaler)})
    try:
        net.fit(it, epochs=2, **kw)
    except _Stop:
        pass
    return net


@pytest.mark.cuda
def test_simplecnn_checkpoint_resumes_bitwise(cuda_device, deterministic,
                                              tmp_path):
    ref = _simplecnn_fit(cuda_device, tmp_path / "whole")
    _simplecnn_fit(cuda_device, tmp_path / "cut", stop=11)
    resumed = _simplecnn_fit(cuda_device, tmp_path / "cut", resume=True)
    assert resumed.iteration == ref.iteration == 16
    assert _equal(ref.params, resumed.params)
    assert _equal(ref.state, resumed.state)
