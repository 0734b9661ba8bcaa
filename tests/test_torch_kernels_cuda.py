"""The port's CUDA kernels -- K1 and K2 (csrc/lstm_fwd.cu, inference and
training modes), K4 and K4-train (csrc/lstm2_fwd.cu), K3 (csrc/lstm_bwd.cu),
K5 (csrc/flash_attn_fwd.cu), K6 and K7 (csrc/flash_attn_bwd.cu), K8 and K9
(csrc/flash_decode.cu) -- against their plain PyTorch versions on the card,
and the autograd functions' gradients on the card against the same on the
CPU.

Marked ``cuda``: they skip without a card, since a CUDA kernel has no CPU
mode. On a machine with one (and ``nvcc``) they run with the usual
``python -m pytest tests/test_torch_kernels_cuda.py``; this file imports no
JAX, so it runs where only the port is installed. Tolerances as in
chip_smoke.py: float32 1e-4, bfloat16 3e-2 on every output (K3's and the
gradients' relative to the largest magnitude of the reference); the
attention kernels take float32 only.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import attention_cuda, decode_cuda, lstm_cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
K1 = ("gate_in", "rw1", "h01", "c01")
K4 = ("gate_in", "rw1", "w2", "b2", "rw2", "h01", "c01", "h02", "c02")
KERNELS = {
    "lstm_fwd": (K1, ops.fused_lstm_sequence, lstm_cuda.lstm_sequence_plain),
    "lstm_fwd_train": (K1, ops.fused_lstm_sequence_train,
                       lstm_cuda.lstm_sequence_train_plain),
    "lstm2_fwd": (K4, ops.fused_lstm2_sequence,
                  lstm_cuda.lstm2_sequence_plain),
    "lstm2_fwd_train": (K4, ops.fused_lstm2_sequence_train,
                        lstm_cuda.lstm2_sequence_train_plain),
    "lstm_bwd": (None, ops.fused_lstm_backward,
                 lstm_cuda.lstm_backward_plain),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(T, B, H, dtype, device, seed=0):
    r = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(H)
    shapes = {"gate_in": ((T, B, 4 * H), 0.5), "rw1": ((H, 4 * H), s),
              "w2": ((H, 4 * H), s), "b2": ((4 * H,), 0.1),
              "rw2": ((H, 4 * H), s), "h01": ((B, H), 0.5),
              "c01": ((B, H), 0.5), "h02": ((B, H), 0.5), "c02": ((B, H), 0.5),
              "dhs": ((T, B, H), 0.5), "dcT": ((B, H), 0.5)}
    return {k: torch.tensor(r.randn(*shp) * sc, dtype=torch.float32)
            .to(dtype).to(device) for k, (shp, sc) in shapes.items()}


def _args(kernel, c):
    names = KERNELS[kernel][0]
    if names is not None:
        return [c[k] for k in names]
    _, tc, cprev, gates, _ = lstm_cuda.lstm_sequence_train_plain(
        *[c[k] for k in K1])
    return [gates, tc, cprev, c["rw1"], c["dhs"], c["dcT"]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("T,B,H", [(64, 40, 256), (7, 15, 40), (5, 70, 300)])
def test_kernel_matches_plain_on_the_card(kernel, dtype, T, B, H,
                                          cuda_device):
    """Serving and training widths (T=64, H=256, a batch that splits across
    blocks) and ragged ones (H not a multiple of the unit slice, B not of
    the row pass)."""
    c = _case(T, B, H, dtype, cuda_device)
    args = _args(kernel, c)
    _, wrapper, plain = KERNELS[kernel]
    before = ops.launch_counts().get(kernel, 0)
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()[kernel] == before + 1
    want = plain(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        if kernel == "lstm_bwd":
            err /= w.float().abs().max().item()
        assert err <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [False, True])
def test_autograd_on_the_card_matches_the_cpu(pair, cuda_device):
    """FusedLSTM / FusedLSTM2 under grad: K2 or K4-train forward and K3
    backward on the card, the plain versions on the CPU, same gradients."""
    names = K4 if pair else K1
    fn = ops.FusedLSTM2 if pair else ops.FusedLSTM
    grads = {}
    for dev in ("cpu", "cuda"):
        c = _case(16, 24, 64, torch.float32, torch.device(dev), seed=3)
        args = [c[k].requires_grad_() for k in names]
        ops.reset_launch_counts()
        outs = fn.apply(*args)
        w = torch.linspace(-1, 1, outs[0].numel(), device=dev)
        (outs[0].reshape(-1) * w).sum().add(outs[-1].sum()).backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            want = ({"lstm2_fwd_train": 1, "lstm_bwd": 2} if pair
                    else {"lstm_fwd_train": 1, "lstm_bwd": 1})
            assert ops.launch_counts() == want
        else:
            assert ops.launch_counts() == {}
        grads[dev] = [a.grad.cpu() for a in args]
    for g, ref in zip(grads["cuda"], grads["cpu"]):
        assert (g - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda_device):
    c = _case(3, 2, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_lstm_sequence(c["gate_in"].transpose(0, 1).contiguous()
                                .transpose(0, 1), c["rw1"], c["h01"],
                                c["c01"])
    with pytest.raises(ValueError, match="cpu"):
        ops.fused_lstm_sequence(c["gate_in"], c["rw1"].cpu(), c["h01"],
                                c["c01"])


def _rand(*shape, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("BH,T,Dh", [(64, 64, 32), (16, 512, 32), (3, 13, 8),
                                     (2, 100, 128), (5, 70, 24), (1, 1, 16)])
def test_flash_attention_matches_plain_on_the_card(BH, T, Dh, causal,
                                                   cuda_device):
    """Serving shapes and ragged ones (T off the 64-row tile and the 32-key
    tile, Dh that is no power of two)."""
    q, k, v = (_rand(BH, T, Dh, device=cuda_device, seed=s) for s in range(3))
    before = ops.launch_counts().get("flash_attn_fwd", 0)
    o, lse = ops.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attn_fwd"] == before + 1
    want_o, want_lse = attention_cuda.flash_attention_fwd_plain(q, k, v,
                                                                causal)
    assert (o - want_o).abs().max().item() <= TOL[torch.float32]
    assert (lse - want_lse).abs().max().item() <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("B,H,Dh,C", [(8, 4, 32, 512), (64, 4, 32, 512),
                                      (3, 2, 8, 48), (2, 3, 128, 64)])
def test_flash_decode_matches_plain_on_the_card(B, H, Dh, C, paged,
                                                cuda_device):
    """Positions at the first row, spread through the cache and at the
    last; the pool behind shuffled page tables, block 0 left as scratch."""
    q = _rand(B, H, Dh, device=cuda_device)
    pos = torch.linspace(0, C - 1, B).round().to(torch.int32).to(cuda_device)
    before = ops.launch_counts()
    if paged:
        bs, MB = 16, C // 16
        NB = B * MB + 1
        pk, pv = (_rand(NB, bs, H, Dh, device=cuda_device, seed=s)
                  for s in (1, 2))
        tables = (torch.randperm(NB - 1, generator=torch.Generator()
                                 .manual_seed(3))[:B * MB] + 1) \
            .reshape(B, MB).to(torch.int32).to(cuda_device)
        got = ops.flash_decode_step_paged(q, pk, pv, pos, tables)
        want = decode_cuda.flash_decode_step_paged_plain(q, pk, pv, pos,
                                                         tables)
        name = "flash_decode_paged"
    else:
        kc, vc = (_rand(B, C, H, Dh, device=cuda_device, seed=s)
                  for s in (1, 2))
        got = ops.flash_decode_step(q, kc, vc, pos)
        want = decode_cuda.flash_decode_step_plain(q, kc, vc, pos)
        name = "flash_decode"
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before.get(name, 0) + 1
    assert (got - want).abs().max().item() <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("BH,T,Dh", [(128, 64, 32), (32, 512, 32),
                                     (16, 100, 32), (3, 13, 8), (2, 100, 128),
                                     (5, 70, 24), (1, 1, 16), (4, 200, 64)])
def test_flash_attention_backward_matches_plain_on_the_card(BH, T, Dh, causal,
                                                            cuda_device):
    """K6 then K7 at the training shape (BH 128, T=64), at T=512 (causal
    bounds across tiles) and ragged ones (T off the 16-row warp tiles and
    the 32-row streamed tiles, padded rows, Dh that is no power of two, Dh
    below a kernel instantiation's width); tolerance relative to the
    largest of the plain version's three gradients. No atomics and one
    writer per output element: a second run repeats dq, delta, dk and dv
    bit for bit."""
    q, k, v, do = (_rand(BH, T, Dh, device=cuda_device, seed=s)
                   for s in range(4))
    o, lse = attention_cuda.flash_attention_fwd_plain(q, k, v, causal)
    before = ops.launch_counts()
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("flash_attn_dq", "flash_attn_dkv"):
        assert after[name] == before.get(name, 0) + 1
    want = attention_cuda.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    causal)
    # one scale for the three: at T=1 without the mask dq and dk are 0
    scale = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= TOL[torch.float32] * scale
    runs = [ops.flash_attention_dq(q, k, v, o, lse, do, causal)
            for _ in range(2)]
    again = ops.flash_attention_dkv(q, k, v, lse, runs[1][1], do, causal)
    torch.cuda.synchronize()
    for a, b in zip(got + runs[0], (runs[1][0],) + again + runs[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d_model,n_heads", [(64, 16)])
def test_attention_layer_head_dims_outside_the_kernels_on_the_card(
        d_model, n_heads, cuda_device):
    """Dh = 4, not a multiple of 8, which the attention kernels do not take
    and the JAX layer sends to its einsum path: the layer's own einsum and
    softmax on the card (float32 matmuls, TF32 off as by default) match the
    CPU port -- forward with its input gradient, and dense and paged decode
    steps -- and launch no attention kernel."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    layer = MultiHeadAttention(n_in=d_model, n_out=d_model, n_heads=n_heads,
                               causal=True)
    assert not layer.flash_supported()
    B, T, C, bs = 3, 9, 16, 4
    MB = C // bs
    tables = (torch.randperm(B * MB, generator=torch.Generator()
                             .manual_seed(3)) + 1).reshape(B, MB) \
        .to(torch.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        params = layer.init(torch.Generator().manual_seed(0))
        params = {k: (p + 0.1 * _rand(*p.shape, device="cpu", seed=i)).to(dev)
                  for i, (k, p) in enumerate(sorted(params.items()))}
        x = _rand(B, T, d_model, device=dev, seed=9).requires_grad_()
        ops.reset_launch_counts()
        y = layer.apply(params, x)
        y.square().sum().backward()
        got = [y.detach(), x.grad]
        dense = layer.init_decode_state(params, B, C, device=dev)
        paged = layer.init_paged_decode_state(params, B, C, B * MB + 1, bs,
                                              device=dev)
        with torch.no_grad():
            for step in range(3):
                pos = torch.tensor([step, step + 4, step + 10],
                                   dtype=torch.int32, device=dev)
                xs = x.detach()[:, step:step + 1]
                o, dense = layer.decode_step(params, dense, xs, pos)
                got.append(o)
                o, paged = layer.decode_step_paged(params, paged, xs, pos,
                                                   tables.to(dev))
                got.append(o)
        if dev == "cuda":
            torch.cuda.synchronize()
        assert ops.launch_counts() == {}
        outs[dev] = [g.cpu() for g in got]
    for g, ref in zip(outs["cuda"], outs["cpu"]):
        assert (g - ref).abs().max().item() <= TOL[torch.float32] * max(
            ref.abs().max().item(), 1.0)


@pytest.mark.cuda
def test_attention_layer_raises_on_the_card_past_the_kernels_head_dims(
        cuda_device):
    """Dh = 256, a multiple of 8 past the kernels' 128, which the JAX layer
    runs through its flash kernels: the layer hands it to the kernel
    wrappers, which raise on the card in the forward and both decode
    steps, and nothing is launched."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    layer = MultiHeadAttention(n_in=512, n_out=512, n_heads=2, causal=True)
    assert layer.flash_supported()
    B, C, bs = 3, 16, 8
    params = {k: p.to("cuda") for k, p in
              layer.init(torch.Generator().manual_seed(0)).items()}
    x = _rand(B, 16, 512, device="cuda", seed=9)
    pos = torch.tensor([0, 4, 10], dtype=torch.int32, device="cuda")
    tables = torch.arange(1, 1 + B * (C // bs), dtype=torch.int32,
                          device="cuda").reshape(B, C // bs)
    dense = layer.init_decode_state(params, B, C, device="cuda")
    paged = layer.init_paged_decode_state(params, B, C, B * (C // bs) + 1,
                                          bs, device="cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        for call in (lambda: layer.apply(params, x),
                     lambda: layer.decode_step(params, dense, x[:, :1], pos),
                     lambda: layer.decode_step_paged(params, paged, x[:, :1],
                                                     pos, tables)):
            with pytest.raises(ValueError, match="head dim 256"):
                call()
    assert ops.launch_counts() == {}


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card_matches_the_cpu(cuda_device):
    """``flash_attention`` under grad on the card: one K5, and a backward of
    one K6 and one K7 from a strided output gradient; the same gradients
    as the plain versions on the CPU."""
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [_rand(8, 100, 32, device=dev, seed=s).requires_grad_()
                  for s in range(3)]
        do = _rand(100, 8, 32, device=dev, seed=3).transpose(0, 1)
        ops.reset_launch_counts()
        ops.flash_attention(*leaves, True).backward(do)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts() == {"flash_attn_fwd": 1,
                                           "flash_attn_dq": 1,
                                           "flash_attn_dkv": 1}
        else:
            assert ops.launch_counts() == {}
        grads[dev] = [t.grad.cpu() for t in leaves]
    for g, ref in zip(grads["cuda"], grads["cpu"]):
        assert (g - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = _rand(2, 8, 8, device=cuda_device).requires_grad_()
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_attention_fwd(q, q, q, True)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_decode_step(_rand(1, 1, 12, device=cuda_device),
                              _rand(1, 4, 1, 12, device=cuda_device),
                              _rand(1, 4, 1, 12, device=cuda_device),
                              torch.zeros(1, dtype=torch.int32,
                                          device=cuda_device))
    x = _rand(2, 8, 12, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_bwd(x, x, x, x, x[..., 0], x)
