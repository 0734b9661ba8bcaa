"""The port's CUDA kernels -- K1 and K2 (csrc/lstm_fwd.cu, inference and
training modes), K4 and K4-train (csrc/lstm2_fwd.cu) and K3
(csrc/lstm_bwd.cu), each on its cluster route and its grid-wide route, K5
(csrc/flash_attn_fwd.cu), K6
and K7 (csrc/flash_attn_bwd.cu), K8 and K9 (csrc/flash_decode.cu) --
against their plain PyTorch versions on the card, and the autograd
functions' gradients on the card against the same on the CPU. Also the
LSTM screens' shape half at F4's shapes (networks whose widths some
kernel has no launch plan for, against the CPU port, launching exactly
what the plan queries answer for), and K8/K9's cluster split: its plan,
20 launches that repeat bit for bit, and a decode step captured in a CUDA
graph and replayed after pos and the page tables change in place.

Marked ``cuda``: they skip without a card, since a CUDA kernel has no CPU
mode. On a machine with one (and ``nvcc``) they run with the usual
``python -m pytest tests/test_torch_kernels_cuda.py``; this file imports no
JAX, so it runs where only the port is installed. Tolerances as in
chip_smoke.py: float32 1e-4, bfloat16 3e-2 on every output (K3's and the
gradients' relative to the largest magnitude of the reference); K5-K7
take float32 only, K8 and K9 a float32 query over a float32 or bfloat16
cache, held to 1e-4 in both (the plain version widens exactly, as the
kernels do).
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


def _k3_check(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        assert err <= TOL[dtype] * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H,route", [
    (16, 32, 256, "cluster"),     # a tBPTT chunk of the LSTM recipe
    (64, 256, 256, "cluster"),    # more rows than the clusters that fit
    (16, 32, 432, "cluster"),     # the largest H whose RW slice fits
    (16, 32, 433, "grid"),        # the next H, past the boundary
    (8, 32, 1056, "grid"),        # the largest H the grid-wide K3 took
])
def test_k3_routes_by_shape_and_matches_plain(T, B, H, route, dtype,
                                              cuda_device):
    """K3 picks its route by shape (on an H100 the cluster route up to
    H=432) and matches its plain version on both sides of the boundary."""
    args = _args("lstm_bwd", _case(T, B, H, dtype, cuda_device))
    got = ops.fused_lstm_backward(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.last_plan("lstm_bwd")["route"] == route
    _k3_check(got, lstm_cuda.lstm_backward_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,route", [
    (7, 1, 40, "cluster"), (5, 70, 300, "cluster"), (6, 33, 100, "cluster"),
    (5, 3, 500, "grid"), (6, 33, 700, "grid")])
def test_k3_every_route_matches_plain(T, B, H, route, cuda_device):
    """Each route on ragged shapes: the cluster route with H not a multiple
    of the cluster, a block with no units, B=1 in one cluster, and rows not
    a multiple of the clusters; the grid-wide kernel with H not a multiple
    of its blocks' units."""
    args = _args("lstm_bwd", _case(T, B, H, torch.float32, cuda_device))
    got = ops.fused_lstm_backward(*args)
    torch.cuda.synchronize()
    plan = lstm_cuda.last_plan("lstm_bwd")
    assert plan["route"] == route
    if route == "cluster":
        assert plan["clusters"] * plan["rows_per_cluster"] >= B
    _k3_check(got, lstm_cuda.lstm_backward_plain(*args), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_repeats_bit_for_bit(dtype, cuda_device):
    """K3 sums in a fixed order with no atomics: 20 launches on one input
    give the same bits (a missing release/acquire around the exchange
    between blocks would show as a rare differing sum)."""
    args = _args("lstm_bwd", _case(64, 32, 256, dtype, cuda_device))
    first = ops.fused_lstm_backward(*args)
    for _ in range(20):
        again = ops.fused_lstm_backward(*args)
        for a, b in zip(again, first):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k3_takes_the_cluster_route_on_the_recipe_shape(cuda_device):
    """The LSTM recipe's backward (T=64, B=32, H=256, float32) runs as one
    launch of the cluster kernel covering every batch row."""
    args = _args("lstm_bwd", _case(64, 32, 256, torch.float32, cuda_device))
    before = ops.launch_counts().get("lstm_bwd", 0)
    ops.fused_lstm_backward(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lstm_bwd"] == before + 1
    plan = lstm_cuda.last_plan("lstm_bwd")
    assert plan["route"] == "cluster"
    assert plan["cluster_size"] in (8, 16)
    assert plan["clusters"] * plan["rows_per_cluster"] >= 32
    assert plan["units_per_block"] * plan["cluster_size"] >= 256


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_fwd_train"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 15, 32])
@pytest.mark.parametrize("T,H,route", [
    (6, 40, "cluster"),      # blocks with no units (u = 3 at 16 blocks)
    (6, 300, "cluster"),     # H not a multiple of 16
    (6, 432, "cluster"),     # the largest H whose RW columns fit
    (6, 433, "grid"),        # the next H, past the boundary
    (4, 1056, "grid"),       # the largest H the grid-wide K1/K2 take
])
def test_k12_routes_by_shape_and_matches_plain(kernel, T, H, route, B, dtype,
                                               cuda_device):
    """K1 and K2 pick their route by shape (on an H100 the cluster route up
    to H=432), match their plain version on both sides of the boundary at
    ragged shapes (B=15: rows that do not divide into the clusters), and
    repeat bit for bit over 20 launches (no atomics; a missing
    release/acquire around the all-gather would show as a rare differing
    value)."""
    args = _args(kernel, _case(T, B, H, dtype, cuda_device))
    wrapper, plain = KERNELS[kernel][1:]
    got = wrapper(*args)
    torch.cuda.synchronize()
    plan = lstm_cuda.last_plan(kernel)
    assert plan["route"] == route
    if route == "cluster":
        assert plan["cluster_size"] in (8, 16)
        assert plan["clusters"] * plan["rows_per_cluster"] >= B
        assert plan["units_per_block"] * plan["cluster_size"] >= H
    want = plain(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]
    for _ in range(20):
        for a, b in zip(wrapper(*args), got):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,T,B", [("lstm_fwd", 16, 15),
                                        ("lstm_fwd_train", 16, 32)])
def test_k12_take_the_cluster_route_on_their_main_paths(kernel, T, B,
                                                        cuda_device):
    """``rnn_time_step``'s 16-step chunks of 15 rows run K1, tBPTT's chunks
    of 16 steps at B=32 K2, both at H=256: the cluster route, every row
    owned by one cluster and no cluster idle."""
    args = _args(kernel, _case(T, B, 256, torch.float32, cuda_device))
    KERNELS[kernel][1](*args)
    torch.cuda.synchronize()
    plan = lstm_cuda.last_plan(kernel)
    assert plan["route"] == "cluster" and plan["cluster_size"] in (8, 16)
    assert plan["units_per_block"] * plan["cluster_size"] >= 256
    assert (plan["clusters"] - 1) * plan["rows_per_cluster"] < B \
        <= plan["clusters"] * plan["rows_per_cluster"]


K4_MODES = pytest.mark.parametrize("kernel", ["lstm2_fwd", "lstm2_fwd_train"])


def _k4_run(kernel, T, B, H, dtype, device):
    args = _args(kernel, _case(T, B, H, dtype, device))
    got = KERNELS[kernel][1](*args)
    torch.cuda.synchronize()
    return args, got, lstm_cuda.last_plan(kernel)


def _k4_check(kernel, args, got, dtype):
    want = KERNELS[kernel][2](*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@K4_MODES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H,route", [
    (64, 32, 256, "cluster"),     # the LSTM recipe's train step
    (64, 16, 256, "cluster"),     # LSTM serving: /predict of 15 windows
    (16, 32, 256, "cluster"),     # the largest H whose columns fit
    (16, 32, 257, "grid"),        # the next H, past the boundary
    (4, 32, 581, "grid"),         # the largest H the grid-wide K4 takes
])
def test_k4_routes_by_shape_and_matches_plain(kernel, T, B, H, route, dtype,
                                              cuda_device):
    """K4 and K4-train pick their route by shape (on an H100 the cluster
    route up to H=256) and match their plain version on both sides of the
    boundary."""
    args, got, plan = _k4_run(kernel, T, B, H, dtype, cuda_device)
    assert plan["route"] == route
    if route == "cluster":
        assert plan["cluster_size"] in (8, 16)
        assert plan["clusters"] * plan["rows_per_cluster"] >= B
        assert plan["units_per_block"] * plan["cluster_size"] >= H
    _k4_check(kernel, args, got, dtype)


@pytest.mark.cuda
@K4_MODES
@pytest.mark.parametrize("T,B,H,route", [
    (7, 1, 40, "cluster"), (6, 33, 100, "cluster"), (5, 3, 250, "cluster"),
    (3, 256, 256, "cluster"), (5, 70, 300, "grid"), (6, 1, 260, "grid")])
def test_k4_every_route_matches_plain(kernel, T, B, H, route, cuda_device):
    """Each route on ragged shapes: the cluster route with H not a multiple
    of 16 (and blocks with no units at H=40), B=1 in one cluster, rows not
    a multiple of the clusters, and B=256 in more clusters than fit at once
    (waves); the grid-wide kernel with H not a multiple of its blocks'
    units."""
    args, got, plan = _k4_run(kernel, T, B, H, torch.float32, cuda_device)
    assert plan["route"] == route
    if route == "cluster":
        assert plan["clusters"] * plan["rows_per_cluster"] >= B
    _k4_check(kernel, args, got, torch.float32)


@pytest.mark.cuda
@K4_MODES
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_repeats_bit_for_bit(kernel, dtype, cuda_device):
    """K4 sums in a fixed order with no atomics: 20 launches on one input
    give the same bits (a missing release/acquire around the all-gather
    between blocks would show as a rare differing value)."""
    args, first, plan = _k4_run(kernel, 64, 32, 256, dtype, cuda_device)
    assert plan["route"] == "cluster"
    for _ in range(20):
        again = KERNELS[kernel][1](*args)
        for a, b in zip(again, first):
            assert torch.equal(a, b)


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
                                     (2, 100, 128), (5, 70, 24), (1, 1, 16),
                                     (4, 64, 136), (3, 100, 256),
                                     (2, 70, 520)])
def test_flash_attention_matches_plain_on_the_card(BH, T, Dh, causal,
                                                   cuda_device):
    """Serving shapes and ragged ones (T off the warps' 16-row tiles and the
    32-key tile, Dh that is no power of two), and head dims past 128 that
    the column-chunk split takes (a last chunk 8 wide at 136 and at 520)."""
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
                                      (3, 2, 8, 48), (2, 3, 128, 64),
                                      (3, 2, 136, 64), (4, 2, 256, 96),
                                      (2, 1, 520, 48)])
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
                                     (5, 70, 24), (1, 1, 16), (4, 200, 64),
                                     (4, 64, 136), (3, 100, 256),
                                     (2, 70, 520)])
def test_flash_attention_backward_matches_plain_on_the_card(BH, T, Dh, causal,
                                                            cuda_device):
    """K6 then K7 at the training shape (BH 128, T=64), at T=512 (causal
    bounds across tiles), ragged ones (T off the 16-row warp tiles and the
    32-row streamed tiles, padded rows, Dh that is no power of two, Dh
    below a kernel instantiation's width) and head dims past 128 (the
    column-chunk split, each chunk's block writing delta or not by its
    chunk); tolerance relative to the
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


def _layer_on_card_matches_cpu(d_model, n_heads, T, bs, launches):
    """MultiHeadAttention (causal) on the card against the CPU port from the
    same random parameters: the forward with its input gradient, and three
    dense and three paged decode steps (B = 3, C = 16), launching exactly
    ``launches`` on the card and nothing on the CPU."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    layer = MultiHeadAttention(n_in=d_model, n_out=d_model, n_heads=n_heads,
                               causal=True)
    B, C = 3, 16
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
        assert ops.launch_counts() == (launches if dev == "cuda" else {})
        outs[dev] = [g.cpu() for g in got]
    for g, ref in zip(outs["cuda"], outs["cpu"]):
        assert (g - ref).abs().max().item() <= TOL[torch.float32] * max(
            ref.abs().max().item(), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("d_model,n_heads", [(64, 16)])
def test_attention_layer_head_dims_outside_the_kernels_on_the_card(
        d_model, n_heads, cuda_device):
    """Dh = 4, not a multiple of 8, which the attention kernels do not take
    and the JAX layer sends to its einsum path: the layer's own einsum and
    softmax on the card (float32 matmuls, TF32 off as by default) match the
    CPU port -- forward with its input gradient, and dense and paged decode
    steps -- and launch no attention kernel."""
    assert not ops.head_dim_supported(d_model // n_heads)
    _layer_on_card_matches_cpu(d_model, n_heads, T=9, bs=4, launches={})


@pytest.mark.cuda
def test_attention_layer_past_128_head_dims_on_the_card_matches_the_cpu(
        cuda_device):
    """Dh = 256, a multiple of 8 past 128 that the JAX layer runs through its
    flash kernels: the layer on the card runs K5 forward and K6 + K7
    backward (column-chunk split, two chunks) and K8 and K9 in the decode
    steps, exactly once per call, and matches the CPU port -- forward with
    its input gradient, and dense and paged decode steps."""
    _layer_on_card_matches_cpu(
        512, 2, T=20, bs=8,
        launches={"flash_attn_fwd": 1, "flash_attn_dq": 1,
                  "flash_attn_dkv": 1, "flash_decode": 3,
                  "flash_decode_paged": 3})


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [32, 256])
def test_flash_attention_autograd_on_the_card_matches_the_cpu(Dh,
                                                              cuda_device):
    """``flash_attention`` under grad on the card: one K5, and a backward of
    one K6 and one K7 from a strided output gradient; the same gradients
    as the plain versions on the CPU. Dh = 256 runs the column-chunk
    split."""
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [_rand(8, 100, Dh, device=dev, seed=s).requires_grad_()
                  for s in range(3)]
        do = _rand(100, 8, Dh, device=dev, seed=3).transpose(0, 1)
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


# ---- F4: the LSTM screens' shape half on the card ---------------------------

V = 9
# (layers, H, B, dtype): past K1's largest H at B=32 (1056 on an H100), a
# width no kernel takes, a pair past K4's largest H (581) whose single
# layers K1 takes, and a bf16 width the grid route refuses (it sizes the
# weights as float32 in either dtype)
F4_CASES = [(1, 1064, 32, torch.float32), (1, 2048, 32, torch.float32),
            (2, 600, 32, torch.float32), (1, 1088, 1, torch.bfloat16)]
SINGLE = {False: ("lstm_fwd",), True: ("lstm_fwd_train", "lstm_bwd")}
PAIR = {False: ("lstm2_fwd",), True: ("lstm2_fwd_train", "lstm_bwd")}


def f4_net(layers, H, dtype, device, seed=11):
    """``layers`` x LSTM(H) and a softmax RnnOutputLayer over a V-char
    vocabulary; bfloat16 as the compute dtype when asked."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    lb = NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3)) \
        .list()
    for _ in range(layers):
        lb = lb.layer(LSTM(n_out=H, activation="tanh"))
    conf = lb.layer(RnnOutputLayer(n_out=V, activation="softmax",
                                   loss="mcxent")) \
        .set_input_type(InputType.recurrent(V)).build()
    if dtype == torch.bfloat16:
        conf.global_conf.compute_dtype = "bfloat16"
    return MultiLayerNetwork(conf, device=device).init()


def f4_launches(layers, H, B, dtype, recording):
    """The launches one forward makes by what ``has_plan`` answers on this
    card: the pair's wavefront where every screen passes, else each layer's
    kernels where its screen passes, else nothing (the layers' loops)."""
    def take(entries):
        return all(lstm_cuda.has_plan(e, B, H, dtype, torch.device("cuda"))
                   for e in entries)
    if not take(SINGLE[recording]):
        return {}
    if layers == 2 and take(PAIR[recording]):
        return {e: 2 if e == "lstm_bwd" else 1 for e in PAIR[recording]}
    return {e: layers for e in SINGLE[recording]}


def f4_batch(B, T=8, seed=0):
    r = np.random.RandomState(seed)
    eye = np.eye(V, dtype=np.float32)
    return eye[r.randint(0, V, (B, T))], eye[r.randint(0, V, (B, T))]


@pytest.mark.cuda
@pytest.mark.parametrize("layers,H,B,dtype", F4_CASES)
def test_lstm_shapes_without_a_plan_run_on_the_card(layers, H, B, dtype,
                                                    cuda_device):
    """Output, step-1 gradients and one ``fit`` step on the card against the
    CPU port from the same parameters (1e-4, bf16 3e-2; gradients relative
    to their largest magnitude, the loss relative), with exactly the
    launches the plan queries answered for: a layer without a plan runs its
    own loop, a pair without one runs as two screened layers."""
    tol = TOL[dtype]
    x, y = f4_batch(B)
    gpu = f4_net(layers, H, dtype, "cuda")
    cpu = f4_net(layers, H, dtype, "cpu").set_params(
        [{k: v.cpu() for k, v in p.items()} for p in gpu.params])
    ops.reset_launch_counts()
    out = gpu.output(x, bucketed=False)
    torch.cuda.synchronize()
    assert ops.launch_counts() == f4_launches(layers, H, B, dtype, False)
    want = cpu.output(x, bucketed=False)
    assert (out.float().cpu() - want.float()).abs().max().item() <= tol
    ops.reset_launch_counts()
    g_gpu, s_gpu = gpu.compute_gradient_and_score(x, y)
    torch.cuda.synchronize()
    assert ops.launch_counts() == f4_launches(layers, H, B, dtype, True)
    g_cpu, s_cpu = cpu.compute_gradient_and_score(x, y)
    assert abs(s_gpu - s_cpu) <= tol * abs(s_cpu)
    for a, b in zip(g_gpu, g_cpu):
        for k in b:
            ref = b[k].float()
            err = (a[k].float().cpu() - ref).abs().max().item()
            assert err <= tol * ref.abs().max().item(), k
    l_gpu = gpu.fit(x, y).get_score()
    l_cpu = cpu.fit(x, y).get_score()
    assert abs(l_gpu - l_cpu) <= tol * abs(l_cpu)


@pytest.mark.cuda
def test_pair_past_the_wavefront_runs_no_wavefront_kernel(cuda_device):
    """2 x LSTM(600) f32 at B=32: on an H100 K4 takes H up to 581, K1 up to
    1056, so the pair runs as two K1 launches."""
    assert not lstm_cuda.has_plan("lstm2_fwd", 32, 600, torch.float32,
                                  cuda_device)
    assert lstm_cuda.has_plan("lstm_fwd", 32, 600, torch.float32,
                              cuda_device)
    net = f4_net(2, 600, torch.float32, "cuda")
    ops.reset_launch_counts()
    net.output(f4_batch(32)[0], bucketed=False)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"lstm_fwd": 2}


@pytest.mark.cuda
def test_wrapper_still_raises_for_a_shape_without_a_plan(cuda_device):
    c = _case(4, 32, 2048, torch.float32, cuda_device)
    assert not lstm_cuda.has_plan("lstm_fwd", 32, 2048, torch.float32,
                                  cuda_device)
    with pytest.raises(RuntimeError, match="no launch plan"):
        ops.fused_lstm_sequence(*[c[k] for k in K1])


@pytest.mark.cuda
@pytest.mark.parametrize("entry", sorted(KERNELS))
def test_plan_query_answers_what_the_launch_does(entry, cuda_device):
    """Where the query says a plan exists the launch takes it (the same
    route and plan); where it says none, the launch raises."""
    for H in (256, 600, 1056, 1064):
        c = _case(2, 32, H, torch.float32, cuda_device)
        ok = lstm_cuda.has_plan(entry, 32, H, torch.float32, cuda_device)
        run = lambda: KERNELS[entry][1](*_args(entry, c))  # noqa: E731
        if ok:
            run()
            torch.cuda.synchronize()
        else:
            with pytest.raises(RuntimeError, match="no launch plan"):
                run()


# ---- K8 / K9: the cluster split ---------------------------------------------

# (B, H, Dh, C, positions): the /generate engines' shape (8 streams halfway
# through their completions), one long stream, a full batch over the whole
# cache, the 256-wide heads' engine shape (two column chunks)
MID = [48, 54, 60, 66, 72, 78, 84, 96]
DECODE_CASES = [(8, 4, 32, 512, MID), (1, 4, 32, 512, [511]),
                (64, 4, 32, 512, None), (8, 2, 256, 512, MID)]


def _decode_inputs(B, H, Dh, C, pos, paged, device, seed=0):
    """q, the cache (dense) or the pool and page tables (16-row blocks,
    shuffled, block 0 left as scratch), and positions (default: spread
    over 0..C-1)."""
    if pos is None:
        pos = torch.linspace(0, C - 1, B).round().long().tolist()
    q = _rand(B, H, Dh, device=device, seed=seed)
    posd = torch.tensor(pos, dtype=torch.int32, device=device)
    if not paged:
        kc, vc = (_rand(B, C, H, Dh, device=device, seed=seed + s)
                  for s in (1, 2))
        return (q, kc, vc, posd)
    bs, MB = 16, C // 16
    NB = B * MB + 1
    pk, pv = (_rand(NB, bs, H, Dh, device=device, seed=seed + s)
              for s in (1, 2))
    tables = (torch.randperm(NB - 1, generator=torch.Generator()
                             .manual_seed(seed + 3))[:B * MB] + 1) \
        .reshape(B, MB).to(torch.int32).to(device)
    return (q, pk, pv, posd, tables)


def _decode_fns(paged):
    if paged:
        return (ops.flash_decode_step_paged,
                decode_cuda.flash_decode_step_paged_plain,
                "flash_decode_paged")
    return (ops.flash_decode_step, decode_cuda.flash_decode_step_plain,
            "flash_decode")


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("B,H,Dh,C,pos", DECODE_CASES)
def test_flash_decode_clusters_repeat_bit_for_bit(B, H, Dh, C, pos, paged,
                                                  cuda_device):
    """The plan (a cluster of S blocks per (b, h, chunk), S from the shape),
    the result against the plain version, and 20 more launches that repeat
    the first bit for bit (every merge in a fixed order, no atomics)."""
    args = _decode_inputs(B, H, Dh, C, pos, paged, cuda_device)
    fn, plain, name = _decode_fns(paged)
    first = fn(*args)
    plan = decode_cuda.last_plan(name)
    assert plan["cluster_size"] in (1, 2, 4, 8, 16)
    assert plan["clusters"] == B * H * -(-Dh // 128)
    assert plan["threads"] in (128, 256)
    torch.cuda.synchronize()
    assert (first - plain(*args)).abs().max().item() <= TOL[torch.float32]
    for _ in range(20):
        assert torch.equal(fn(*args), first)


# bfloat16 caches (a bf16-compute model's decode state): the grids of the
# float32 cases, and head dims past a bfloat16 chunk's 256 columns
BF16_DECODE_CASES = [(1, 4, 32, 512, [511]), (8, 4, 32, 512, MID),
                     (64, 4, 32, 512, None), (3, 2, 8, 48, None),
                     (4, 2, 136, 96, None), (8, 2, 256, 512, MID),
                     (2, 1, 520, 48, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("B,H,Dh,C,pos", BF16_DECODE_CASES)
def test_flash_decode_reads_bfloat16_caches_on_the_card(B, H, Dh, C, pos,
                                                        paged, cuda_device):
    """K8 / K9 over a bfloat16 cache or pool, read in its own type: against
    the plain version (which widens exactly, as the kernel does, so the
    float32 tolerance holds), one launch counted, the plan's clusters (a
    chunk is 256 columns in bfloat16), 20 launches bit for bit, and a
    float32 query with bfloat16 K and V of another dtype refused."""
    args = list(_decode_inputs(B, H, Dh, C, pos, paged, cuda_device))
    args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    fn, plain, name = _decode_fns(paged)
    before = ops.launch_counts().get(name, 0)
    first = fn(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    assert first.dtype == torch.float32
    assert (first - plain(*args)).abs().max().item() <= TOL[torch.float32]
    plan = decode_cuda.last_plan(name)
    assert plan["clusters"] == B * H * -(-Dh // 256)
    assert plan["cluster_size"] in (1, 2, 4, 8, 16)
    for _ in range(20):
        assert torch.equal(fn(*args), first)
    mixed = list(args)
    mixed[2] = args[2].float()
    with pytest.raises(TypeError, match="one dtype"):
        fn(*mixed)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_flash_decode_bfloat16_replays_from_a_cuda_graph(paged, cuda_device):
    """The bfloat16 instantiation captured in a CUDA graph and replayed
    after pos (and the page tables) change in place."""
    args = list(_decode_inputs(8, 4, 32, 512, MID, paged, cuda_device))
    args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    fn, plain, _ = _decode_fns(paged)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    gen = torch.Generator().manual_seed(6)
    for trial in range(3):
        args[3].copy_(torch.randint(0, 512, (8,), generator=gen)
                      .to(torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert (out - plain(*args)).abs().max().item() <= TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_flash_decode_replays_from_a_cuda_graph(paged, cuda_device):
    """One decode step captured in a CUDA graph and replayed after pos (and
    the page tables) change in place: the kernel reads both on the card
    only, so every replay matches the plain version on the new values."""
    args = _decode_inputs(8, 4, 32, 512, MID, paged, cuda_device)
    fn, plain, _ = _decode_fns(paged)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    gen = torch.Generator().manual_seed(5)
    for trial in range(4):
        pos = torch.randint(0, 512 + 8 * trial, (8,), generator=gen)
        args[3].copy_(pos.to(torch.int32))
        if paged:
            NB = args[1].shape[0]
            args[4].copy_((torch.randperm(NB - 1, generator=gen)[:8 * 32] + 1)
                          .reshape(8, 32).to(torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert (out - plain(*args)).abs().max().item() <= TOL[torch.float32]
