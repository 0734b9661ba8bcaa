"""The Inception zoo, the special layers, pretraining and the iterator
wrappers on the card, at small sizes: phase 13 of chip_smoke.py in
little. Every test is marked ``cuda`` and skips without a card; the file
imports no JAX (``python -m pytest tests/test_torch_inception_cuda.py -q``
on a machine with one).

- InceptionResNetV1 and FaceNetNN4Small2 at 96 x 96 in float64, B=4: two
  steps' losses, running statistics and center-loss centers within 1e-6
  of the CPU port's, the card's dropout draws replayed into it.
- LeNet with frozen convolutions: captured steps equal eager ones bit for
  bit, the frozen parameters as they started and without updater state,
  losses and parameters within 1e-4 of the CPU port's.
- An RBM -> AutoEncoder network's and a VAE network's first pretrain
  steps, the card's draws replayed into the CPU port, within 1e-4.
- A YOLOv2 head (2 anchors, 3 classes) on 128 x 128 images: loss and
  gradients within 1e-4 of the CPU port's.
- LeNet through AsyncDataSetIterator(workers=2) equals it through the
  base, bit for bit.
"""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator, DataSet,
                                           ListDataSetIterator)
from deeplearning4j_tpu_torch.data.fetchers import _uint8_wire, load_mnist
from deeplearning4j_tpu_torch.data.normalizers import \
    ImagePreProcessingScaler
from deeplearning4j_tpu_torch.nn import dropout as D
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import (
    RBM, AutoEncoder, ConvolutionLayer, DenseLayer, FrozenLayer, OutputLayer,
    SubsamplingLayer, VariationalAutoencoder, Yolo2OutputLayer)
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.zoo import (FaceNetNN4Small2,
                                          InceptionResNetV1, LeNet)

F64_TOL, TOL = 1e-6, 1e-4


@pytest.fixture
def cuda_device():
    """The card, with TF32 off for cuDNN and matmuls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: cuDNN and a captured CUDA graph "
                    "have no CPU mode")
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = old


@contextmanager
def draws(mode, record):
    """The seam recording the card's draws (to the host) or replaying
    them, in order, into the CPU port."""
    real = (D.uniform, D.normal)

    def wrap(fn):
        def draw(shape, dtype, device, gen):
            if mode == "record":
                t = fn(shape, dtype, device, gen)
                record.append(t.detach().cpu())
                return t
            return record.pop(0).to(device=device, dtype=dtype)
        return draw
    D.uniform, D.normal = wrap(real[0]), wrap(real[1])
    try:
        yield
    finally:
        D.uniform, D.normal = real


def _rel(a, b):
    items = a.items() if isinstance(a, dict) else enumerate(a)
    other = dict(b.items() if isinstance(b, dict) else enumerate(b))
    return max((float((p[k].double().cpu() - other[n][k].double().cpu())
                      .abs().max()
                      / max(other[n][k].abs().max().item(), 1e-30))
                for n, p in items for k in p), default=0.0)


def _equal(a, b):
    items = a.items() if isinstance(a, dict) else enumerate(a)
    other = dict(b.items() if isinstance(b, dict) else enumerate(b))
    return all(torch.equal(p[k].cpu(), other[n][k].cpu())
               for n, p in items for k in p)


def _cpu(net):
    cls = ComputationGraph if isinstance(net.params, dict) \
        else MultiLayerNetwork
    return cls(net.conf, device="cpu").set_params(net.params, net.state)


@pytest.mark.cuda
@pytest.mark.parametrize("zoo", [InceptionResNetV1, FaceNetNN4Small2],
                         ids=["inception_resnet_v1", "facenet_nn4_small2"])
def test_face_nets_match_the_cpu_in_float64(zoo, cuda_device):
    base = zoo(num_classes=10, input_shape=(96, 96, 3)).init(device="cpu")
    conf = base.conf
    conf.global_conf.dtype = "float64"
    params = {n: {k: v.double() for k, v in p.items()}
              for n, p in base.params.items()}
    card = ComputationGraph(conf, device=cuda_device).set_params(params)
    cpu = ComputationGraph(conf, device="cpu").set_params(params)
    card._capture_steps = False
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.rand(4, 96, 96, 3))
    y = torch.from_numpy(np.eye(10)[r.randint(0, 10, 4)])
    rec, losses = [], ([], [])
    for net, mode, ls in ((card, "record", losses[0]),
                          (cpu, "replay", losses[1])):
        for _ in range(2):
            with draws(mode, rec):
                ls.append(net.fit([x], [y]).get_score())
    assert not rec
    np.testing.assert_allclose(losses[0], losses[1], rtol=F64_TOL)
    assert _rel(card.state, cpu.state) <= F64_TOL
    head = conf.network_outputs[0]
    assert _rel({0: {"c": card.params[head]["centers"]}},
                {0: {"c": cpu.params[head]["centers"]}}) <= F64_TOL


def _frozen_lenet(device):
    conf = (NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3))
            .weight_init("xavier").list()
            .layer(FrozenLayer(inner=ConvolutionLayer(
                n_out=20, kernel_size=5, activation="relu")))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                    stride=2))
            .layer(FrozenLayer(inner=ConvolutionLayer(
                n_out=50, kernel_size=5, activation="relu")))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                    stride=2))
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _wire(rows=384, flatten=False):
    x, y = load_mnist(train=True, num_examples=rows, flatten=flatten)
    it = ListDataSetIterator(DataSet(_uint8_wire(x), y), 128)
    return it.set_pre_processor(ImagePreProcessingScaler(device_side=True))


@pytest.mark.cuda
def test_frozen_lenet_captured_matches_eager_and_the_cpu(cuda_device):
    cap, eager = _frozen_lenet(cuda_device), _frozen_lenet(cuda_device)
    eager._capture_steps = False
    cpu = _cpu(cap)
    start = [{k: v.clone() for k, v in p.items()} for p in cap.params]
    for net in (cap, eager, cpu):
        net.fit(_wire(), epochs=2)
    assert cap._capture_count >= 1
    assert _equal(cap.params, eager.params)
    for i in (0, 2):
        assert _equal([cap.params[i]], [start[i]])
        assert cap.opt_state[i] == {}
    assert not _equal([cap.params[4]], [start[4]])
    assert _rel(cap.params, cpu.params) <= TOL
    np.testing.assert_allclose(cap.get_score(), cpu.get_score(), rtol=TOL)


def _pretrain_net(device, vae):
    b = NeuralNetConfiguration.builder().seed(7).updater(Adam(1e-3)).list()
    if vae:
        b = b.layer(VariationalAutoencoder(
            n_out=8, encoder_layer_sizes=(32,), decoder_layer_sizes=(32,)))
    else:
        b = (b.layer(RBM(n_out=64, k=2))
             .layer(AutoEncoder(n_out=32, corruption_level=0.3)))
    conf = (b.layer(OutputLayer(n_out=10, activation="softmax",
                                loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())
    return MultiLayerNetwork(conf, device=device).init()


@pytest.mark.cuda
@pytest.mark.parametrize("vae", [False, True], ids=["rbm_autoencoder",
                                                    "vae"])
def test_first_pretrain_steps_match_the_cpu(vae, cuda_device):
    card = _pretrain_net(cuda_device, vae)
    cpu = _cpu(card)
    rec = []
    with draws("record", rec):
        card.pretrain(_wire(128, flatten=True), epochs=1)
    with draws("replay", rec):
        cpu.pretrain(_wire(128, flatten=True), epochs=1)
    assert not rec
    assert _rel(card.params, cpu.params) <= TOL
    np.testing.assert_allclose(card.get_score(), cpu.get_score(), rtol=TOL)


@pytest.mark.cuda
def test_yolo2_matches_the_cpu(cuda_device):
    b = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3))
         .weight_init("relu").activation("leakyrelu").list())
    for c in (8, 16, 16, 32, 32):
        b = b.layer(ConvolutionLayer(n_out=c, kernel_size=3, stride=2,
                                     padding=1))
    conf = (b.layer(ConvolutionLayer(n_out=2 * 8, kernel_size=1,
                                     activation="identity"))
            .layer(Yolo2OutputLayer(anchors=((1.0, 1.5), (3.0, 2.0)),
                                    n_classes=3))
            .set_input_type(InputType.convolutional(128, 128, 3)).build())
    card = MultiLayerNetwork(conf, device=cuda_device).init()
    cpu = _cpu(card)
    r = np.random.RandomState(1)
    x = r.rand(4, 128, 128, 3).astype(np.float32)
    y = np.zeros((4, 4, 4, 2, 8), np.float32)
    y[:, :, :, :, 0:4] = r.rand(4, 4, 4, 2, 4)
    y[:, 1, 2, 0, 4] = y[:, 3, 0, 1, 4] = 1.0
    y[:, 1, 2, 0, 5] = y[:, 3, 0, 1, 7] = 1.0
    y = y.reshape(4, 4, 4, 16)
    outs = []
    for net in (card, cpu):
        grads, loss = net.compute_gradient_and_score(x, y)
        outs.append((grads, loss))
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=TOL)
    peak = max(g[k].abs().max().item() for g in outs[1][0] for k in g)
    worst = max((a[k].cpu() - b[k]).abs().max().item()
                for a, b in zip(outs[0][0], outs[1][0]) for k in b)
    assert worst <= TOL * peak


@pytest.mark.cuda
def test_lenet_through_async_equals_the_base(cuda_device):
    nets = [LeNet(num_classes=10).init(device=cuda_device)
            for _ in range(2)]
    nets[0].fit(_wire(), epochs=2)
    a = AsyncDataSetIterator(_wire(), workers=2)
    nets[1].fit(a, epochs=2)
    a._shutdown()
    assert _equal(nets[0].params, nets[1].params)
