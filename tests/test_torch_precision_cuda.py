"""The serving precisions and the bucketed engine's captured rungs on the
card, against the same engines run eagerly or on the CPU. No JAX: this
file runs where the port runs.

- ``InferenceEngine.warmup`` captures one CUDA graph a rung; serving the
  ladder's sizes afterwards captures nothing and adds no program, and the
  captured rungs equal an eager engine's (``_program.capture = False``)
  bit for bit, at f32, int8 and fp8;
- a swap writes into the resident tensors: no capture, every address
  kept, the new weights served;
- the int8 / fp8 codes quantized on the card equal the CPU's bit for bit;
- a bfloat16-compute TinyTransformer's captured dense and paged engines
  (K8 / K9 over bfloat16 caches) give the eager engines' tokens.

Every test skips without a card: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.quant import QTensor, quantize
from deeplearning4j_tpu_torch.serving import DecodeEngine, InferenceEngine
from deeplearning4j_tpu_torch.zoo import TinyTransformer

V, MAXLEN, T = 13, 64, 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _net(device, seed=7, **kw):
    return TinyTransformer(vocab_size=V, n_layers=2, d_model=32, n_heads=4,
                           max_len=MAXLEN, seed=seed, **kw).init(
                               device=device)


def _x(n, seed=0):
    r = np.random.RandomState(seed)
    return np.eye(V, dtype=np.float32)[r.randint(0, V, (n, T))]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "fp8"])
def test_warmup_captures_each_rung_and_serving_captures_nothing(
        precision, cuda_device):
    net = _net(cuda_device)
    eng = InferenceEngine(net, 16, precision=precision)
    eager = InferenceEngine(net, 16, precision=precision)
    eager._program.capture = False
    ladder = eng.warmup((T, V))
    eager.warmup((T, V))
    assert ladder == [1, 2, 4, 8, 16]
    assert eng.captures == len(ladder) and eager.captures == 0
    progs = eng.trace_count
    ops.reset_launch_counts()
    for i, n in enumerate((3, 1, 16, 7, 9, 2)):
        x = _x(n, seed=i)
        assert np.array_equal(eng.predict_host(x), eager.predict_host(x))
    torch.cuda.synchronize()
    # K5 twice a forward, captured and eager alike
    assert ops.launch_counts() == {"flash_attn_fwd": 2 * 2 * 6}
    assert eng.captures == len(ladder) and eng.trace_count == progs


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_a_swap_writes_in_place_and_captures_nothing(precision,
                                                     cuda_device):
    net, other = _net(cuda_device), _net(cuda_device, seed=5)
    eng = InferenceEngine(net, 8, precision=precision)
    eng.warmup((T, V))
    leaves = [t for p in eng._weights_set.params.values() for v in p.values()
              for t in ((v.codes, v.scale) if isinstance(v, QTensor)
                        else (v,))]
    ptrs = [t.data_ptr() for t in leaves]
    caps = eng.captures
    eng.swap_weights({n: {k: v.cpu().numpy() for k, v in p.items()}
                      for n, p in other.params.items()})
    x = _x(5, seed=3)
    got = eng.predict_host(x)
    want = InferenceEngine(other, 8, precision=precision).predict_host(x)
    assert np.array_equal(got, want)
    assert eng.captures == caps and eng.model_version == 1
    assert [t.data_ptr() for t in leaves] == ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "fp8"])
def test_codes_on_the_card_equal_the_cpus(precision, cuda_device):
    rs = np.random.RandomState(0)
    w = (rs.randn(96, 64) * np.logspace(-3, 2, 64)).astype(np.float32)
    w[:, 5] = 0.0
    card, cpu = quantize(torch.tensor(w, device=cuda_device), precision), \
        quantize(torch.tensor(w), precision)
    view = (lambda c: c.view(torch.uint8)) if precision == "fp8" else \
        (lambda c: c)
    assert torch.equal(view(card.codes).cpu(), view(cpu.codes))
    assert torch.equal(card.scale.cpu(), cpu.scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_bfloat16_engines_captured_equal_eager(kv, cuda_device):
    net = _net(cuda_device, compute_dtype="bfloat16")
    prompts = [[1, 2, 3], [5], list(range(1, 12)), [7, 7, 2, 9]]
    outs = []
    for capture in (True, False):
        eng = DecodeEngine(net, slots=4, max_len=MAXLEN, kv=kv,
                           kv_block_size=16)
        eng._capture_programs = capture
        eng.start()
        try:
            futs = [eng.submit(p, max_new_tokens=10) for p in prompts]
            outs.append([f.result(timeout=120)["tokens"] for f in futs])
        finally:
            eng.stop()
        pool = eng._dstate["b0_attn"]["pk" if kv == "paged" else "k"]
        assert pool.dtype == torch.bfloat16
    assert outs[0] == outs[1]
