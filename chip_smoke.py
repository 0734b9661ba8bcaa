#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; exits non-zero, with no
result line, when any of them or the port's package is missing. Phases:

1. The card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. Build: every kernel source compiled from ``deeplearning4j_tpu_torch/
   csrc`` (one ``nvcc`` per source, in parallel).
3. Kernels, each against its plain PyTorch version on the card. The LSTM
   family at T=64, H=256, float32 and bfloat16: K1 (single-layer LSTM
   forward) and K4 (stacked wavefront forward) at B in {1, 16, 256}; K2
   (training forward), K4-train and K3 (backward) at B in {1, 32, 256}.
   Tolerance f32 1e-4, bf16 3e-2, on every output (K3's relative to the
   largest magnitude of the plain version's). The attention family in
   float32, tolerance 1e-4: K5 (flash attention forward, o and lse) at
   B in {1, 16, 64} x 4 heads, T in {64, 512}, Dh=32, causal and not; K6
   (dq, and the delta it writes for K7) and K7 (dk, dv), the flash
   attention backward, at B in {1, 32, 64} x 4 heads, T in {64, 100,
   512}, Dh=32, causal and not, relative to the largest gradient of the
   plain version; K8 (flash decode, dense cache) and K9 (paged pool,
   bs=16, shuffled page tables) at B in {1, 8, 64}, 4 heads, C=512,
   positions spread over 0..511. With CUDA-event medians of the kernel,
   the plain version and one library call computing the same work
   (cuDNN's ``torch.nn.LSTM``: the forward with grad enabled for the
   training forwards, the backward of that output alone for K3;
   ``scaled_dot_product_attention``, causal for K5, its backward -- dq, dk
   and dv together -- for K6 + K7, over the gathered cache with the
   position mask for K8/K9), and the least time the card could take
   (bound: float32 FMAs outside the tensor cores or bytes; for K5, K6 and
   K7 also ``tc_bound_ms``, the same bytes or the operations at the TF32
   tensor-core rate -- the bound K6 and K7, which run on the tensor cores,
   are held to). K6 and K7 run twice on each case and must repeat bit for
   bit. The attention family's times are device times (calls replayed
   from a CUDA graph: a small kernel runs for less than the host takes to
   launch it), beside the time of a call launched from the host.
4. Serving: the bundled TextGenerationLSTM served by ``InferenceServer`` on
   the card: held-out /predict accuracy, concurrent mixed-size /predict
   against unbatched forwards, greedy /generate against the full-prefix
   path, ``rnn_time_step`` in chunks against ``output``.
5. TinyTransformer serving at its full default width (d_model 128, 4
   heads, 2 pre-LN blocks, FFN 512, max_len 512, the corpus's 51-char
   vocabulary) from the configuration's seed: (a) /predict of the 15
   held-out windows (T=64) and of 4 windows at T=512 against the CPU port
   (plain versions) from the same parameters, probabilities within 1e-4;
   8 concurrent /predict of 1..16 windows against unbatched forwards; (b)
   8 concurrent greedy /generate streams (prompts of 16..64 corpus tokens,
   64 new tokens each) on a dense-KV engine (8 slots, max_len 512) and on
   a paged one (kv_block_size 16, the default pool), their tokens against
   each other and against ``generate_naive`` (the full-prefix forward
   through K5); where tokens differ the reference's top-2 probability
   margin at that step must be <= 1e-4 (a near-tie of the seed weights).
6. Training, the LSTM model at full width: (a) step-1 gradients and three
   ``fit`` steps on the card against the same on the CPU (plain versions)
   from the same initial parameters; (b) the recipe that trained the
   bundled weights (tools/make_pretrained.py: stride-8 windows, batch 32,
   90 epochs of ``fit_scan``) from the seed, with ms per step, tokens per
   second and held-out top-1 (at least the manifest's 0.2979 - 0.03);
   (c) the same with truncated BPTT in chunks of 16 for 2 epochs, whose
   held-out loss must fall.
7. Training TinyTransformer at its full default width, every attention
   forward through K5 and its backward through K6 and K7: (a) step-1 loss
   and gradients and three ``fit`` steps on the card against the CPU port
   (plain versions) from the same initial parameters, at T=64, B=32 and
   at T=512, B=8 (gradients within 1e-4 of max|grad|, losses rtol 1e-4,
   parameters within 1e-4 -- the key bias ``bk``, which has no gradient,
   within 2 x lr x steps); (b) the LSTM model's recipe from the seed
   (stride-8 windows, B=32, T=64, 90 epochs of ``fit_scan``, 2340 steps),
   with ms per step, tokens per second, the loss every 10 epochs and
   held-out top-1 through ``evaluate`` after epochs 10 and 90 (bars:
   top-1 >= 0.24 after epoch 10, last loss <= 0.25 after epoch 90); (c)
   the trained graph saved with its updater, loaded on the card, one more
   ``fit`` step on both: the same loss and parameters; (d) ten ``fit``
   steps under ``torch.profiler``: device busy time and idle share,
   kernels per step and the host operations that take the most time.

Kernel launch counts are reset right before the LSTM serving phase, before
each TinyTransformer part, before training (b) and (c) and before each
part of the TinyTransformer training, and read right after; each
TinyTransformer part and the training runs must launch exactly the kernels
their call or step counts call for (K5 twice per bucketed forward, K8 or
K9 twice per engine step; K5, K6 and K7 twice each per TinyTransformer
train step, K5 alone for ``score`` and ``evaluate``), and nothing else.

Prints, before the last line, one JSON line of per-kernel numbers and the
card's name and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Detailed results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_TOL, BF16_TOL = 1e-4, 3e-2
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
# float32 outside the tensor cores; TF32 and bf16 dense on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HELD_OUT_TOP1, TOP1_SLACK = 0.2979, 0.02      # zoo manifest, textgenlstm
RECIPE_SLACK = 0.03           # a fresh seed's training against the manifest
GRAD_TOL, LOSS_RTOL = 1e-4, 1e-4              # card against the CPU port
# kernel -> (wrapper, plain version, argument names; "reserves" = the plain
# training forward's reserve space, as K3 gets it in a train step)
KERNELS = {
    "lstm_fwd": ("fused_lstm_sequence", "lstm_sequence_plain",
                 ("gate_in", "rw1", "h01", "c01")),
    "lstm_fwd_train": ("fused_lstm_sequence_train",
                       "lstm_sequence_train_plain",
                       ("gate_in", "rw1", "h01", "c01")),
    "lstm2_fwd": ("fused_lstm2_sequence", "lstm2_sequence_plain",
                  ("gate_in", "rw1", "w2", "b2", "rw2", "h01", "c01", "h02",
                   "c02")),
    "lstm2_fwd_train": ("fused_lstm2_sequence_train",
                        "lstm2_sequence_train_plain",
                        ("gate_in", "rw1", "w2", "b2", "rw2", "h01", "c01",
                         "h02", "c02")),
    "lstm_bwd": ("fused_lstm_backward", "lstm_backward_plain",
                 ("reserves", "rw1", "dhs", "dcT")),
}
PALLAS = "deeplearning4j_tpu/ops/lstm_pallas.py"
REPLACES = {"lstm_fwd": f"{PALLAS}:295", "lstm_fwd_train": f"{PALLAS}:282",
            "lstm2_fwd": f"{PALLAS}:634", "lstm2_fwd_train": f"{PALLAS}:634",
            "lstm_bwd": f"{PALLAS}:316"}
SOURCES = {"lstm_fwd": "lstm_fwd.cu", "lstm_fwd_train": "lstm_fwd.cu",
           "lstm2_fwd": "lstm2_fwd.cu", "lstm2_fwd_train": "lstm2_fwd.cu",
           "lstm_bwd": "lstm_bwd.cu"}
# the attention family (float32): K5, K8, K9
ATTN_TOL = 1e-4
PROB_TOL = 1e-4             # TinyTransformer probabilities, card vs CPU port
TIE_MARGIN = 1e-4           # top-2 probability gap that may flip a token
FLASH, DECODE = ("deeplearning4j_tpu/ops/flash_attention.py",
                 "deeplearning4j_tpu/ops/flash_decode.py")
REPLACES.update(flash_attn_fwd=f"{FLASH}:170", flash_decode=f"{DECODE}:115",
                flash_decode_paged=f"{DECODE}:192")
SOURCES.update(flash_attn_fwd="flash_attn_fwd.cu",
               flash_decode="flash_decode.cu",
               flash_decode_paged="flash_decode.cu")
HEADS, HEAD_DIM, KV_BLOCK = 4, 32, 16       # TinyTransformer's defaults
REPLACES.update(flash_attn_dq=f"{FLASH}:202", flash_attn_dkv=f"{FLASH}:212")
SOURCES.update(flash_attn_dq="flash_attn_bwd.cu",
               flash_attn_dkv="flash_attn_bwd.cu")
# TinyTransformer training: the LSTM recipe (tools/make_pretrained.py) and
# its bars, from the JAX package's TinyTransformer through the same recipe
# on a CPU (held-out top-1 0.2687 after epoch 10, falling after; last
# batch's loss 0.092 after epoch 90). The port on a CPU, through
# ``tiny_recipe("cpu")`` below: top-1 0.2604 after epoch 10 (0.2354 after
# epoch 90), loss 2.4195 after epoch 10 and 0.0938 after epoch 90.
TINY_B, TINY_T, TINY_EPOCHS = 32, 64, 90
TINY_TOP1_EPOCH10 = 0.24        # 0.2687 less the LSTM recipe's 0.03 slack
TINY_LOSS_EPOCH90 = 0.25        # the JAX run passed it between epochs 60-70


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int, rounds: int = 5, warmup: int = 2) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median device time of one call: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, so the host's launch cost
    (which exceeds a small kernel's run time) does not count."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound(kernel: str, T: int, B: int, H: int, dtype: str):
    """Least time for the work: every input read once and every output
    written once over HBM (reserves included), or the products' operations
    at the card's peak for the stream type, whichever is larger."""
    es = 2 if dtype == "bfloat16" else 4
    G = 4 * H
    seq, gate = T * B * H, T * B * G
    if kernel.startswith("lstm_fwd"):
        # gate_in, RW, h0, c0 -> hs, cT (+ gates, tanh(c), c_prev)
        nbytes = es * (gate + H * G + 2 * B * H + seq + B * H)
        if kernel.endswith("_train"):
            nbytes += es * (gate + 2 * seq)
        flops = 2.0 * T * B * H * G
    elif kernel.startswith("lstm2_fwd"):
        # gate_in1, RW1, W2, b2, RW2, 4 carries -> hs2, h1T, c1T, c2T
        # (+ hs1, both layers' tanh(c), c_prev and gates)
        nbytes = es * (gate + 3 * H * G + G + 4 * B * H + seq + 3 * B * H)
        if kernel.endswith("_train"):
            nbytes += es * (5 * seq + 2 * gate)
        flops = 3 * 2.0 * T * B * H * G
    else:
        # gates, tanh(c), c_prev, RW, dhs, dcT -> dz, dh0 and dc0 (f32)
        nbytes = es * (gate + 2 * seq + H * G + seq + B * H + gate) \
            + 4 * 2 * B * H
        flops = 2.0 * T * B * G * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(T, B, H, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=g, device="cuda")
                * scale).to(dtype)
    s = H ** -0.5
    return {"gate_in": rnd(T, B, 4 * H, scale=0.5), "rw1": rnd(H, 4 * H, scale=s),
            "w2": rnd(H, 4 * H, scale=s), "b2": rnd(4 * H, scale=0.1),
            "rw2": rnd(H, 4 * H, scale=s), "h01": rnd(B, H, scale=0.5),
            "c01": rnd(B, H, scale=0.5), "h02": rnd(B, H, scale=0.5),
            "c02": rnd(B, H, scale=0.5), "dhs": rnd(T, B, H, scale=0.5),
            "dcT": rnd(B, H, scale=0.5)}


def cudnn_lstm(kernel, c):
    """torch.nn.LSTM (cuDNN) set up to compute the kernel's work on the
    same inputs: gate_in enters through an identity-permutation input
    weight (IFOG columns to PyTorch's IFGO rows). The training forwards run
    with grad enabled (cuDNN's training forward, which keeps its reserve
    space); K3's yardstick is the backward of that output alone. Timed
    only, never used by the port."""
    import torch
    H = c["h01"].shape[-1]
    perm = torch.cat([torch.arange(0, 2 * H), torch.arange(3 * H, 4 * H),
                      torch.arange(2 * H, 3 * H)]).cuda()
    layers = 2 if kernel.startswith("lstm2") else 1
    lstm = torch.nn.LSTM(4 * H, H, num_layers=layers, device="cuda",
                         dtype=c["gate_in"].dtype)
    with torch.no_grad():
        eye = torch.eye(4 * H, device="cuda", dtype=c["gate_in"].dtype)
        lstm.weight_ih_l0.copy_(eye[perm])
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        lstm.weight_hh_l0.copy_(c["rw1"][:, perm].t())
        if layers == 2:
            lstm.weight_ih_l1.copy_(c["w2"][:, perm].t())
            lstm.bias_ih_l1.copy_(c["b2"][perm])
            lstm.bias_hh_l1.zero_()
            lstm.weight_hh_l1.copy_(c["rw2"][:, perm].t())
    lstm.flatten_parameters()
    if layers == 1:
        state = (c["h01"][None], c["c01"][None])
    else:
        state = (torch.stack([c["h01"], c["h02"]]),
                 torch.stack([c["c01"], c["c02"]]))
    if kernel in ("lstm_fwd", "lstm2_fwd"):
        def run():
            with torch.no_grad():
                return lstm(c["gate_in"], state)
        return run
    lstm.requires_grad_(False)       # the kernels' work has no weight grads
    x = c["gate_in"].detach().requires_grad_()
    state = tuple(t.detach().requires_grad_() for t in state)

    def forward():
        with torch.enable_grad():
            return lstm(x, state)
    if kernel != "lstm_bwd":
        return forward
    out, (_, cT) = forward()

    def backward():
        torch.autograd.backward([out, cT], [c["dhs"], c["dcT"][None]],
                                retain_graph=True)
    return backward


def kernel_case(kernel, T, B, H, dtype_name, seed=0, plain_reps=2):
    """One kernel at one shape: error against the plain version on the same
    inputs, and the four times. Launches made here are not the main
    path's; the caller resets the counters before the main path."""
    import torch
    from deeplearning4j_tpu_torch.ops import lstm_cuda
    dtype = getattr(torch, dtype_name)
    c = kernel_inputs(T, B, H, dtype, seed)
    wname, pname, names = KERNELS[kernel]
    wrapper, plain = getattr(lstm_cuda, wname), getattr(lstm_cuda, pname)
    if kernel == "lstm_bwd":
        _, tc, cprev, gates, _ = lstm_cuda.lstm_sequence_train_plain(
            c["gate_in"], c["rw1"], c["h01"], c["c01"])
        args = [gates, tc, cprev] + [c[k] for k in names[1:]]
    else:
        args = [c[k] for k in names]
    got = wrapper(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    errs = [(g.float() - w.float()).abs().max().item() for g, w in
            zip(got, want)]
    if kernel == "lstm_bwd":        # relative to each output's magnitude
        errs = [e / max(w.float().abs().max().item(), 1e-30)
                for e, w in zip(errs, want)]
    err = max(errs)
    tol = F32_TOL if dtype_name == "float32" else BF16_TOL
    if not err <= tol:
        raise AssertionError(f"{kernel} T={T} B={B} H={H} {dtype_name}: max "
                             f"{'relative' if kernel == 'lstm_bwd' else 'abs'}"
                             f" err {err} > {tol}")
    row = {"kernel": kernel, "T": T, "B": B, "H": H, "dtype": dtype_name,
           "max_abs_err": err, "tol": tol,
           "plan": lstm_cuda.last_plan(kernel),
           "ms": time_ms(lambda: wrapper(*args), reps=10),
           "plain_ms": time_ms(lambda: plain(*args), reps=plain_reps,
                               rounds=3)}
    row["bound_ms"], row["bound_by"] = bound(kernel, T, B, H, dtype_name)
    try:
        lib = cudnn_lstm(kernel, c)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = lib()
        if caught:      # e.g. cuDNN re-packing weights on every call
            row["library_note"] = str(caught[0].message)[:200]
        if out is not None:
            row["library_max_abs_err"] = (out[0].float()
                                          - want[0].float()).abs().max().item()
        row["library_ms"] = time_ms(lib, reps=10)
    except RuntimeError as e:       # cuDNN refuses this type/shape
        row["library_ms"], row["library_note"] = None, str(e)[:200]
    return row


def fmt(row):
    lib = ("n/a" if row["library_ms"] is None
           else f"{row['library_ms']:.4f}")
    if "library_note" in row:
        lib += "*"
    return (f"{row['kernel']:9s} T={row['T']} B={row['B']:<4d} H={row['H']} "
            f"{row['dtype']:8s} err {row['max_abs_err']:.3g} (tol "
            f"{row['tol']:g})  kernel {row['ms']:.4f} ms  plain "
            f"{row['plain_ms']:.4f} ms  cudnn {lib} ms  bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']})")


def attn_bound(kernel, c, peak="float32"):
    """Least time for one attention call on these inputs: every input read
    once and every output written once over HBM, or its operations at the
    card's ``peak`` rate (float32 outside the tensor cores by default;
    "tf32" for the tensor-core bound of K5-K7), whichever is larger. K5, K6
    and K7 count the (query, key) pairs the mask keeps; K8/K9 only the live
    rows 0..pos of each stream (and K9 the page-table entries they
    need)."""
    if kernel.startswith("flash_attn"):
        BH, T, Dh = c["q"].shape
        pairs = BH * (T * (T + 1) // 2 if c["causal"] else T * T)
        vec, row = BH * T * Dh, BH * T
        if kernel == "flash_attn_fwd":
            nbytes = 4 * (3 * vec + vec + row)           # q, k, v -> o, lse
            flops = 4.0 * Dh * pairs                     # q.k and p.v
        elif kernel == "flash_attn_dq":
            # q, k, v, o, do, lse -> dq, delta; q.k, do.v, ds.k
            nbytes = 4 * (5 * vec + row + vec + row)
            flops = 6.0 * Dh * pairs
        else:
            # q, k, v, do, lse, delta -> dk, dv; q.k, do.v, p.do, ds.q
            nbytes = 4 * (4 * vec + 2 * row + 2 * vec)
            flops = 8.0 * Dh * pairs
    else:
        B, H, Dh = c["q"].shape
        live = int((c["pos"].long() + 1).sum())
        nbytes = 4 * (2 * B * H * Dh + 2 * live * H * Dh + B)
        if kernel == "flash_decode_paged":
            nbytes += 4 * int((c["pos"].long() // c["pk"].shape[1] + 1).sum())
        flops = 4.0 * Dh * H * live
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_inputs(kernel, B, T, causal=False, pos=None, seed=0):
    """K5: q, k, v (B*4, T, 32). K8/K9: q (B, 4, 32), a cache of capacity
    T (dense, or a pool of 16-row blocks behind shuffled page tables with
    block 0 as scratch), and positions (default: spread over 0..T-1)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    if kernel == "flash_attn_fwd":
        return {"q": rnd(B * HEADS, T, HEAD_DIM),
                "k": rnd(B * HEADS, T, HEAD_DIM),
                "v": rnd(B * HEADS, T, HEAD_DIM), "causal": causal, "B": B}
    if pos is None:
        pos = [T - 1] if B == 1 else \
            torch.linspace(0, T - 1, B).round().long().tolist()
    c = {"q": rnd(B, HEADS, HEAD_DIM),
         "pos": torch.tensor(pos, dtype=torch.int32, device="cuda")}
    if kernel == "flash_decode":
        c["kc"], c["vc"] = rnd(B, T, HEADS, HEAD_DIM), rnd(B, T, HEADS,
                                                           HEAD_DIM)
        return c
    MB = T // KV_BLOCK
    NB = B * MB + 1
    c["pk"], c["pv"] = (rnd(NB, KV_BLOCK, HEADS, HEAD_DIM) for _ in range(2))
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    c["tables"] = perm[:B * MB].reshape(B, MB).to(torch.int32).contiguous()
    return c


def attn_calls(kernel, c):
    """The kernel's wrapper, its plain version (both returning a tuple) and
    one library call (``scaled_dot_product_attention``) computing the same
    function on the same inputs."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import attention_cuda as A
    from deeplearning4j_tpu_torch.ops import decode_cuda as D
    if kernel == "flash_attn_fwd":
        args = (c["q"], c["k"], c["v"], c["causal"])
        BH, T, Dh = c["q"].shape
        q4, k4, v4 = (t.view(c["B"], HEADS, T, Dh) for t in args[:3])
        return (lambda: A.flash_attention_fwd(*args),
                lambda: A.flash_attention_fwd_plain(*args),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=c["causal"]).reshape(BH, T, Dh))
    q, pos = c["q"], c["pos"]
    if kernel == "flash_decode":
        kc, vc = c["kc"], c["vc"]
        wrap = lambda: (D.flash_decode_step(q, kc, vc, pos),)  # noqa: E731
        plain = lambda: (D.flash_decode_step_plain(q, kc, vc, pos),)  # noqa
    else:
        pk, pv, tb = c["pk"], c["pv"], c["tables"]
        wrap = lambda: (D.flash_decode_step_paged(  # noqa: E731
            q, pk, pv, pos, tb),)
        plain = lambda: (D.flash_decode_step_paged_plain(  # noqa: E731
            q, pk, pv, pos, tb),)
        kc, vc = D.gather_pages(pk, tb), D.gather_pages(pv, tb)
    C = kc.shape[1]
    mask = (torch.arange(C, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    return wrap, plain, lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kt, vt, attn_mask=mask)[:, :, 0, :]


def attn_kernel_case(kernel, B, T, causal=False, pos=None, seed=0):
    """One attention kernel at one shape: error against the plain version
    (K5: o and lse), and the four times. Launches made here are not the
    main path's; the caller resets the counters before the main path."""
    import torch
    c = attn_inputs(kernel, B, T, causal, pos, seed)
    wrap, plain, lib = attn_calls(kernel, c)
    with torch.no_grad():
        got = wrap()
        torch.cuda.synchronize()
        want = plain()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not err <= ATTN_TOL:
            raise AssertionError(f"{kernel} B={B} T={T} causal={causal}: "
                                 f"max abs err {err} > {ATTN_TOL}")
        row = {"kernel": kernel, "B": B, "T": T, "H": HEADS, "Dh": HEAD_DIM,
               "dtype": "float32", "max_abs_err": err, "tol": ATTN_TOL,
               "ms": graph_ms(wrap, reps=20),
               "call_ms": time_ms(wrap, reps=20),
               "plain_ms": graph_ms(plain, reps=3, rounds=3),
               "library_max_abs_err": (lib() - want[0]).abs().max().item(),
               "library_ms": graph_ms(lib, reps=20)}
    if kernel == "flash_attn_fwd":
        row["causal"] = causal
        row["tc_bound_ms"], row["tc_bound_by"] = attn_bound(kernel, c, "tf32")
    else:
        row["pos"] = c["pos"].tolist()
    row["bound_ms"], row["bound_by"] = attn_bound(kernel, c)
    return row


def fmt_attn(row):
    what = (f"causal={row['causal']!s:5}" if "causal" in row
            else f"pos {row['pos'][0]}..{row['pos'][-1]}")
    return (f"{row['kernel']:18s} B={row['B']:<3d} T={row['T']:<3d} {what} "
            f"err {row['max_abs_err']:.3g} (tol {row['tol']:g})  kernel "
            f"{row['ms']:.4f} ms (a call from the host {row['call_ms']:.4f}"
            f" ms)  plain {row['plain_ms']:.4f} ms  sdpa "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']})"
            + (f"; tensor cores {row['tc_bound_ms']:.5f} ms"
               if "tc_bound_ms" in row else ""))


def bwd_kernel_case(B, T, causal, seed=0):
    """K6 and K7 at one shape: q, k, v and the output gradient random, o
    and lse from K5's plain version. Each kernel's outputs against its
    plain version's (dq, dk, dv relative to the largest of the three plain
    gradients, delta to its own largest magnitude), a second run of both
    that must repeat the first bit for bit, and the four times:
    each kernel's, its plain version's, and the backward of
    ``scaled_dot_product_attention`` (dq, dk and dv in one call), recorded
    beside both. Returns the rows of K6 and K7."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import attention_cuda as A
    g = torch.Generator(device="cuda").manual_seed(seed)
    BH = B * HEADS
    q, k, v, do = (torch.randn(BH, T, HEAD_DIM, generator=g, device="cuda")
                   for _ in range(4))
    o, lse = A.flash_attention_fwd_plain(q, k, v, causal)
    c = {"q": q, "causal": causal}
    with torch.no_grad():
        dq, delta = A.flash_attention_dq(q, k, v, o, lse, do, causal)
        dk, dv = A.flash_attention_dkv(q, k, v, lse, delta, do, causal)
        dq2, delta2 = A.flash_attention_dq(q, k, v, o, lse, do, causal)
        again = (dq2, delta2) + A.flash_attention_dkv(q, k, v, lse, delta2,
                                                      do, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip((dq, delta, dk, dv), again)):
            raise AssertionError(f"K6/K7 B={B} T={T} causal={causal}: a "
                                 "second run differs from the first")
        want_dq, want_delta = A.flash_attention_dq_plain(q, k, v, o, lse,
                                                         do, causal)
        want_dk, want_dv = A.flash_attention_dkv_plain(q, k, v, lse,
                                                       want_delta, do, causal)
    scale = max(t.abs().max().item() for t in (want_dq, want_dk, want_dv))
    errs = {"flash_attn_dq": max(
        (dq - want_dq).abs().max().item() / scale,
        (delta - want_delta).abs().max().item()
        / want_delta.abs().max().item()),
        "flash_attn_dkv": max((dk - want_dk).abs().max().item(),
                              (dv - want_dv).abs().max().item()) / scale}
    for kernel, err in errs.items():
        if not err <= ATTN_TOL:
            raise AssertionError(f"{kernel} B={B} T={T} causal={causal}: "
                                 f"relative err {err} > {ATTN_TOL}")
    calls = {
        "flash_attn_dq": (
            lambda: A.flash_attention_dq(q, k, v, o, lse, do, causal),
            lambda: A.flash_attention_dq_plain(q, k, v, o, lse, do, causal)),
        "flash_attn_dkv": (
            lambda: A.flash_attention_dkv(q, k, v, lse, delta, do, causal),
            lambda: A.flash_attention_dkv_plain(q, k, v, lse, delta, do,
                                                causal))}
    # SDPA's backward alone cannot be replayed from a graph (autograd runs
    # it on the stream its forward was recorded on), so its time is that of
    # forward + backward less that of the same training forward
    leaves = [t.view(B, HEADS, T, HEAD_DIM).clone().requires_grad_()
              for t in (q, k, v)]
    do4 = do.view(B, HEADS, T, HEAD_DIM)

    def sdpa_forward():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(*leaves, is_causal=causal)

    def sdpa_step():
        return torch.autograd.grad(sdpa_forward(), leaves, do4)
    lib = sdpa_step()
    lib_err = max((a.reshape(BH, T, HEAD_DIM) - w).abs().max().item()
                  for a, w in zip(lib, (want_dq, want_dk, want_dv))) / scale
    step_ms, fwd_ms = graph_ms(sdpa_step, reps=20), graph_ms(sdpa_forward,
                                                             reps=20)
    lib_ms = step_ms - fwd_ms
    rows = []
    with torch.no_grad():
        for kernel, (wrap, plain) in calls.items():
            row = {"kernel": kernel, "B": B, "T": T, "H": HEADS,
                   "Dh": HEAD_DIM, "dtype": "float32", "causal": causal,
                   "max_abs_err": errs[kernel], "tol": ATTN_TOL,
                   "err_relative_to": "largest plain gradient",
                   "ms": graph_ms(wrap, reps=20),
                   "call_ms": time_ms(wrap, reps=20),
                   "plain_ms": graph_ms(plain, reps=3, rounds=3),
                   "library_ms": lib_ms,
                   "library_covers": "dq, dk and dv (K6 + K7): SDPA "
                                     "forward + backward less forward",
                   "library_step_ms": step_ms, "library_fwd_ms": fwd_ms,
                   "library_max_rel_err": lib_err, "bitwise_repeat": True}
            row["bound_ms"], row["bound_by"] = attn_bound(kernel, c)
            row["tc_bound_ms"], row["tc_bound_by"] = attn_bound(kernel, c,
                                                                "tf32")
            rows.append(row)
    return rows


def fmt_bwd(rows):
    dq, dkv = rows
    return (f"flash_attn_dq+dkv B={dq['B']:<3d} T={dq['T']:<3d} "
            f"causal={dq['causal']!s:5} rel err {dq['max_abs_err']:.3g} / "
            f"{dkv['max_abs_err']:.3g} (tol {dq['tol']:g})  K6 "
            f"{dq['ms']:.4f} ms + K7 {dkv['ms']:.4f} ms = "
            f"{dq['ms'] + dkv['ms']:.4f} (from the host {dq['call_ms']:.4f} "
            f"+ {dkv['call_ms']:.4f})  plain {dq['plain_ms']:.4f} + "
            f"{dkv['plain_ms']:.4f} ms  sdpa backward "
            f"{dq['library_ms']:.4f} ms  bound {dq['bound_ms']:.5f} + "
            f"{dkv['bound_ms']:.5f} ms ({dq['bound_by']}, {dkv['bound_by']};"
            f" tensor cores {dq['tc_bound_ms']:.5f} + "
            f"{dkv['tc_bound_ms']:.5f} ms); repeats bitwise")


def slice_phase(card):
    """Serve the bundled TextGenerationLSTM on the card; every check raises
    on failure. Returns the measured numbers."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving import (DecodeEngine,
                                                  InferenceClient,
                                                  InferenceServer)
    from deeplearning4j_tpu_torch.serving.decode import generate_naive
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

    (xtr, _), (xte, yte), vocab = corpus_windows(T=64)
    net = TextGenerationLSTM(
        total_unique_characters=len(vocab)).init_pretrained(device="cuda")
    srv = InferenceServer(net, port=0, max_latency_ms=2.0,
                          decode_engine=DecodeEngine(net, slots=8,
                                                     max_len=256)).start()
    cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
    res = {"card": card}
    try:
        ops.reset_launch_counts()
        # held-out next-char accuracy through /predict; the first request
        # also pays the card's first-use costs, so it is sent twice
        accs, res["predict_heldout_ms"] = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            probs = cli.predict(xte)
            res["predict_heldout_ms"].append(
                round((time.perf_counter() - t0) * 1e3, 3))
            if probs.shape != (len(xte), 64, len(vocab)) \
                    or not np.isfinite(probs).all():
                raise AssertionError(f"/predict returned {probs.shape}")
            accs.append(float((probs.argmax(-1) == yte.argmax(-1)).mean()))
        acc = res["heldout_top1"] = accs[0]
        print(f"slice: /predict held-out top-1 {acc:.4f} (manifest "
              f"{HELD_OUT_TOP1} +- {TOP1_SLACK}); {len(xte)} windows x 64 "
              f"steps in {res['predict_heldout_ms']} ms (first, second) "
              f"[{card}]", flush=True)
        if abs(acc - HELD_OUT_TOP1) > TOP1_SLACK or accs[1] != acc:
            raise AssertionError(f"held-out top-1 {accs} off the manifest")
        after_predict = ops.launch_counts()

        # concurrent mixed-size requests against one unbatched forward each,
        # twice: the first round meets new bucket shapes
        sizes = [1, 3, 7, 2, 5, 16, 4, 9]
        starts = np.cumsum([0] + sizes)
        reqs = [xtr[a:b] for a, b in zip(starts[:-1], starts[1:])]

        def timed_predict(x):
            t = time.perf_counter()
            out = cli.predict(x)
            return out, (time.perf_counter() - t) * 1e3
        res["mixed_predict_ms"] = []
        worst = 0.0
        for _ in range(2):
            with ThreadPoolExecutor(len(reqs)) as pool:
                answers = list(pool.map(timed_predict, reqs))
            for x, (out, _) in zip(reqs, answers):
                want = net.output(x, bucketed=False).float().cpu().numpy()
                worst = max(worst, float(np.abs(out - want).max()))
            res["mixed_predict_ms"].append([round(ms, 3) for _, ms in answers])
        res["mixed_predict_max_abs_err"] = worst
        print(f"slice: {len(reqs)} concurrent /predict of sizes {sizes}: max "
              f"abs err vs unbatched {worst:.3g}; latencies first round "
              f"{res['mixed_predict_ms'][0]} ms, second "
              f"{res['mixed_predict_ms'][1]} ms [{card}]", flush=True)
        if worst > 1e-5:
            raise AssertionError("batched /predict disagrees with unbatched")

        # greedy /generate against the full-prefix forward path
        text_ids = xte.argmax(-1)
        prompts = [list(map(int, text_ids[i, :16])) for i in (0, 5, 10)]

        def timed_generate(p):
            t = time.perf_counter()
            out = cli.generate(p, max_new_tokens=32)["tokens"]
            return out, time.perf_counter() - t
        res["generate_tokens_per_s"], res["generate_request_s"] = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(prompts)) as pool:
                gens = list(pool.map(timed_generate, prompts))
            wall = time.perf_counter() - t0
            res["generate_tokens_per_s"].append(
                round(32 * len(prompts) / wall, 2))
            res["generate_request_s"].append([round(s, 4) for _, s in gens])
            for p, (toks, _) in zip(prompts, gens):
                want = generate_naive(net, p, 32)["tokens"]
                if toks != want:
                    raise AssertionError(
                        f"/generate {toks} != full-prefix {want}")
        text = "".join(vocab[t] for t in gens[0][0])
        print(f"slice: {len(prompts)} concurrent greedy /generate x 32 tokens "
              f"match the full-prefix path (twice); tokens/s "
              f"{res['generate_tokens_per_s']}, request seconds "
              f"{res['generate_request_s']} [{card}]; sample {text!r}",
              flush=True)

        # stateful rnn_time_step in chunks against the whole-window output
        net.rnn_clear_previous_state()
        t0 = time.perf_counter()
        chunks = [net.rnn_time_step(xte[:, i:i + 16]) for i in range(0, 64, 16)]
        torch.cuda.synchronize()
        res["rnn_time_step_ms"] = (time.perf_counter() - t0) * 1e3
        stepped = torch.cat(chunks, dim=1).float().cpu().numpy()
        full = net.output(xte).float().cpu().numpy()
        res["rnn_time_step_max_abs_err"] = float(np.abs(stepped - full).max())
        print(f"slice: rnn_time_step in 4 chunks vs output: max abs err "
              f"{res['rnn_time_step_max_abs_err']:.3g}, "
              f"{res['rnn_time_step_ms']:.1f} ms [{card}]", flush=True)
        if res["rnn_time_step_max_abs_err"] > 1e-4:
            raise AssertionError("rnn_time_step disagrees with output")
        counts = ops.launch_counts()
    finally:
        srv.stop()
    res["launches"] = counts
    res["launches_after_predict"] = after_predict
    print(f"slice: kernel launches after the held-out /predict "
          f"{after_predict}, after the whole phase {counts}", flush=True)
    if not (after_predict.get("lstm2_fwd", 0) > 0
            and counts.get("lstm2_fwd", 0) > after_predict["lstm2_fwd"]
            and counts.get("lstm_fwd", 0) > after_predict.get("lstm_fwd", 0)):
        raise AssertionError(f"main path missed a kernel: {counts}")
    res["stats"] = {k: v for k, v in srv.stats().items() if k != "decode"}
    return res


def _expect_launches(part, want):
    """The launch counts since the last reset must be exactly ``want``."""
    from deeplearning4j_tpu_torch import ops
    got = ops.launch_counts()
    if got != want:
        raise AssertionError(f"{part}: launches {got}, want {want}")
    return got


def _first_tie(net, prompt, got, want):
    """Where two greedy streams first differ, the reference's top-2
    probability margin at that step (the full-prefix forward of the
    reference's own tokens). None when they agree."""
    import torch
    from deeplearning4j_tpu_torch.serving.engine import input_type_of
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not diff and len(got) == len(want):
        return None
    step = diff[0] if diff else min(len(got), len(want))
    toks = list(prompt) + list(want[:step])
    eye = torch.eye(input_type_of(net).size, device=net.device)
    probs = net.output(eye[torch.tensor(toks, device=net.device)][None],
                       bucketed=False)[0, -1]
    top = torch.topk(probs.float(), 2).values
    return step, float(top[0] - top[1])


def transformer_phase(card):
    """Serve TinyTransformer at its full default width on the card from the
    configuration's seed; every check raises on failure. Returns the
    measured numbers."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.serving import (DecodeEngine,
                                                  InferenceClient,
                                                  InferenceServer)
    from deeplearning4j_tpu_torch.serving.decode import generate_naive
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

    (xtr, _), (xte, yte), vocab = corpus_windows(T=64)
    (x512, _), _, _ = corpus_windows(T=512)
    x512 = x512[:4]
    net = TinyTransformer(vocab_size=len(vocab)).init(device="cuda")
    cpu = ComputationGraph(net.conf, device="cpu").set_params(net.params)
    dense = DecodeEngine(net, slots=8, max_len=512)
    paged = DecodeEngine(net, slots=8, max_len=512, kv="paged",
                         kv_block_size=KV_BLOCK)
    srv = InferenceServer(net, port=0, max_latency_ms=2.0,
                          decode_engine=dense).start()
    psrv = InferenceServer(net, port=0, decode_engine=paged).start()
    cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
    pcli = InferenceClient(f"http://127.0.0.1:{psrv.port}")
    cfg = net.conf.nodes["b0_attn"].layer
    res = {"card": card, "d_model": cfg.n_out, "heads": cfg.n_heads,
           "vocab": len(vocab), "kv_blocks": paged.stats()["kv"]["blocks"]}

    def calls():
        return srv.engine.stats()["device_calls"]
    try:
        # (a) /predict: held-out windows (sent twice: the first request
        # pays first-use costs) and 4 windows at T=512, against the CPU port
        ops.reset_launch_counts()
        c0 = calls()
        res["predict_heldout_ms"], outs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(cli.predict(xte))
            res["predict_heldout_ms"].append(
                round((time.perf_counter() - t0) * 1e3, 3))
        t0 = time.perf_counter()
        out512 = cli.predict(x512)
        res["predict_512_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        n_calls = calls() - c0
        res["launches_predict"] = _expect_launches(
            "tiny /predict", {"flash_attn_fwd": 2 * n_calls})
        errs = []
        for x, out in ((xte, outs[0]), (xte, outs[1]), (x512, out512)):
            if out.shape != x.shape or not np.isfinite(out).all():
                raise AssertionError(f"/predict returned {out.shape}")
            want = cpu.output(x, bucketed=False).numpy()
            errs.append(float(np.abs(out - want).max()))
        res["predict_vs_cpu_max_abs_err"] = max(errs)
        res["heldout_top1_seed_weights"] = float(
            (outs[0].argmax(-1) == yte.argmax(-1)).mean())
        print(f"tiny: /predict {len(xte)} held-out windows x 64 in "
              f"{res['predict_heldout_ms']} ms (first, second), 4 x 512 in "
              f"{res['predict_512_ms']} ms; max abs err vs the CPU port "
              f"{max(errs):.3g} (tol {PROB_TOL}); {n_calls} bucketed "
              f"forwards, launches {res['launches_predict']} [{card}]",
              flush=True)
        if max(errs) > PROB_TOL:
            raise AssertionError("/predict on the card disagrees with the "
                                 "CPU port")

        # concurrent mixed-size requests against one unbatched forward each
        sizes = [1, 3, 7, 2, 5, 16, 4, 9]
        starts = np.cumsum([0] + sizes)
        reqs = [xtr[a:b] for a, b in zip(starts[:-1], starts[1:])]

        def timed_predict(x):
            t = time.perf_counter()
            out = cli.predict(x)
            return out, (time.perf_counter() - t) * 1e3
        ops.reset_launch_counts()
        c0 = calls()
        with ThreadPoolExecutor(len(reqs)) as pool:
            answers = list(pool.map(timed_predict, reqs))
        n_calls = calls() - c0
        res["launches_mixed"] = _expect_launches(
            "tiny concurrent /predict", {"flash_attn_fwd": 2 * n_calls})
        worst = max(float(np.abs(out - net.output(x, bucketed=False)
                                 .cpu().numpy()).max())
                    for x, (out, _) in zip(reqs, answers))
        res["mixed_predict_ms"] = [round(ms, 3) for _, ms in answers]
        res["mixed_predict_max_abs_err"] = worst
        print(f"tiny: {len(reqs)} concurrent /predict of sizes {sizes} in "
              f"{n_calls} bucketed forwards: max abs err vs unbatched "
              f"{worst:.3g}; latencies {res['mixed_predict_ms']} ms [{card}]",
              flush=True)
        if worst > 1e-5:
            raise AssertionError("batched /predict disagrees with unbatched")

        # (b) greedy /generate, 8 concurrent streams, on each engine
        ids = xte.argmax(-1)
        lens = [16, 22, 28, 34, 40, 46, 52, 64]
        prompts = [list(map(int, ids[i, :n])) for i, n in enumerate(lens)]
        new = 64
        gens = {}
        for kind, client, eng, kernel in (
                ("dense", cli, dense, "flash_decode"),
                ("paged", pcli, paged, "flash_decode_paged")):
            client.generate(prompts[0][:4], max_new_tokens=4)  # first use
            ops.reset_launch_counts()
            st0 = eng.stats()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(prompts)) as pool:
                gens[kind] = list(pool.map(
                    lambda p: client.generate(p, max_new_tokens=new)
                    ["tokens"], prompts))
            wall = time.perf_counter() - t0
            st1 = eng.stats()
            steps = st1["steps"] - st0["steps"]
            secs = st1["decode_seconds"] - st0["decode_seconds"]
            res[f"launches_{kind}"] = _expect_launches(
                f"tiny {kind} /generate", {kernel: 2 * steps})
            res[f"{kind}_steps"] = steps
            res[f"{kind}_tokens_per_s"] = len(prompts) * new / wall
            res[f"{kind}_ms_per_step"] = secs / steps * 1e3
            if kind == "paged":
                res["paged_kv"] = st1["kv"]
                if st1["kv"]["blocks_in_use"] != 0:
                    raise AssertionError(f"paged engine leaked blocks: "
                                         f"{st1['kv']}")
            print(f"tiny: {kind} /generate, {len(prompts)} concurrent "
                  f"greedy streams x {new} tokens (prompts {lens[0]}.."
                  f"{lens[-1]}): {steps} steps, "
                  f"{res[f'{kind}_ms_per_step']:.3f} ms/step, "
                  f"{res[f'{kind}_tokens_per_s']:.1f} tokens/s; launches "
                  f"{res[f'launches_{kind}']} [{card}]", flush=True)

        # the full-prefix reference, through K5 at every length
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        naive = [generate_naive(net, p, new)["tokens"] for p in prompts]
        res["naive_seconds"] = time.perf_counter() - t0
        res["launches_naive"] = _expect_launches(
            "tiny generate_naive", {"flash_attn_fwd": 2 * len(prompts) * new})
        ties = []
        for p, want, d, pg in zip(prompts, naive, gens["dense"],
                                  gens["paged"]):
            for kind, got in (("dense", d), ("paged", pg)):
                tie = _first_tie(net, p, got, want)
                if tie is not None:
                    ties.append({"engine": kind, "prompt_len": len(p),
                                 "step": tie[0], "top2_margin": tie[1]})
        res["token_mismatches"] = ties
        same = sum(d == w for d, w in zip(gens["dense"], naive))
        print(f"tiny: greedy tokens, dense == full-prefix for {same}/"
              f"{len(prompts)} streams, paged == full-prefix for "
              f"{sum(g == w for g, w in zip(gens['paged'], naive))}/"
              f"{len(prompts)}; mismatches at near-ties {ties}; "
              f"full-prefix path {res['naive_seconds']:.2f} s [{card}]; "
              f"sample {''.join(vocab[t] for t in gens['dense'][0])!r}",
              flush=True)
        if any(t["top2_margin"] > TIE_MARGIN for t in ties):
            raise AssertionError(f"greedy tokens differ beyond a near-tie: "
                                 f"{ties}")
    finally:
        srv.stop()
        psrv.stop()
    return res


def _max_rel_err(got, want):
    """Largest |got - want| over per-layer dicts of tensors, relative to
    the largest |want|."""
    err = max((g[k].float().cpu() - w[k].float().cpu()).abs().max().item()
              for g, w in zip(got, want) for k in w)
    scale = max(w[k].abs().max().item() for w in want for k in w)
    return err / scale


def train_phase(card):
    """Train the TextGenerationLSTM at full width on the card; every check
    raises on failure. Returns the measured numbers."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import MultiLayerNetwork, ops
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

    (xtr, ytr), (xte, yte), vocab = corpus_windows(stride=8)
    B, T, epochs = 32, 64, 90                # tools/make_pretrained.py
    steps = len(xtr) // B
    zoo = TextGenerationLSTM(total_unique_characters=len(vocab))
    res = {"card": card, "steps_per_epoch": steps, "epochs": epochs}

    # (a) the card against the CPU port from the same initial parameters
    cpu = zoo.init(device="cpu")
    gpu = MultiLayerNetwork(zoo.conf(), device="cuda").set_params(cpu.params)
    g_cpu, s_cpu = cpu.compute_gradient_and_score(xtr[:B], ytr[:B])
    g_gpu, s_gpu = gpu.compute_gradient_and_score(xtr[:B], ytr[:B])
    res["grad_rel_err"] = _max_rel_err(g_gpu, g_cpu)
    res["losses_cpu"], res["losses_card"] = [], []
    for k in range(3):
        batch = (xtr[k * B:(k + 1) * B], ytr[k * B:(k + 1) * B])
        res["losses_cpu"].append(cpu.fit(*batch).get_score())
        res["losses_card"].append(gpu.fit(*batch).get_score())
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(res["losses_card"], res["losses_cpu"]))
    print(f"train (a): step-1 gradients on the card vs the CPU port: max "
          f"abs err {res['grad_rel_err']:.3g} of max|grad| (tol {GRAD_TOL}); "
          f"3 fit losses card {res['losses_card']} vs CPU "
          f"{res['losses_cpu']} (max rel err {loss_rel:.3g}, tol "
          f"{LOSS_RTOL}) [{card}]", flush=True)
    if not (res["grad_rel_err"] <= GRAD_TOL and loss_rel <= LOSS_RTOL
            and abs(s_gpu - s_cpu) <= LOSS_RTOL * abs(s_cpu)):
        raise AssertionError("training on the card disagrees with the CPU")

    # (b) the bundled weights' recipe, from the seed
    net = zoo.init(device="cuda")
    xs = torch.tensor(xtr[:steps * B].reshape(steps, B, T, -1)).cuda()
    ys = torch.tensor(ytr[:steps * B].reshape(steps, B, T, -1)).cuda()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    curve = []
    for ep in range(epochs):
        net.fit_scan(xs, ys)
        if ep % 10 == 9:
            curve.append(round(net.get_score(), 4))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts_b = ops.launch_counts()
    n = steps * epochs
    res.update(recipe_steps=n, recipe_seconds=secs, ms_per_step=secs / n * 1e3,
               tokens_per_s=n * B * T / secs, loss_every_10_epochs=curve,
               launches_recipe=counts_b)
    probs = net.output(xte).float().cpu().numpy()
    top1 = res["recipe_heldout_top1"] = float(
        (probs.argmax(-1) == yte.argmax(-1)).mean())
    print(f"train (b): {n} steps (B={B}, T={T}) in {secs:.1f} s: "
          f"{res['ms_per_step']:.3f} ms/step, {res['tokens_per_s']:.0f} "
          f"tokens/s; loss every 10 epochs {curve}; held-out top-1 "
          f"{top1:.4f} (manifest {HELD_OUT_TOP1}, floor "
          f"{HELD_OUT_TOP1 - RECIPE_SLACK:.4f}); launches {counts_b} "
          f"[{card}]", flush=True)
    if counts_b != {"lstm2_fwd_train": n, "lstm_bwd": 2 * n}:
        raise AssertionError(f"recipe launches {counts_b}, want "
                             f"lstm2_fwd_train={n} lstm_bwd={2 * n}")
    if not top1 >= HELD_OUT_TOP1 - RECIPE_SLACK:
        raise AssertionError(f"recipe held-out top-1 {top1}")

    # (c) truncated BPTT in chunks of 16 through the single-layer kernels
    conf = zoo.conf()
    conf.backprop_type = "tbptt"
    conf.tbptt_fwd_length = conf.tbptt_back_length = 16
    tnet = MultiLayerNetwork(conf, device="cuda").init()
    it = ListDataSetIterator(DataSet(xtr, ytr), B, drop_last=True)
    before = tnet.score(x=xte, y=yte)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tnet.fit(it, epochs=2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts_c = ops.launch_counts()
    after = tnet.score(x=xte, y=yte)
    want = 2 * (T // 16) * steps * 2       # layers x chunks x batches
    res.update(tbptt_seconds=secs, tbptt_heldout_loss=[before, after],
               launches_tbptt=counts_c, tbptt_batches=tnet.iteration)
    print(f"train (c): tBPTT(16) 2 epochs, {tnet.iteration} batches in "
          f"{secs:.2f} s; held-out loss {before:.4f} -> {after:.4f}; "
          f"launches {counts_c} [{card}]", flush=True)
    if counts_c != {"lstm_fwd_train": want, "lstm_bwd": want}:
        raise AssertionError(f"tBPTT launches {counts_c}, want {want} each")
    if not after < before:
        raise AssertionError("tBPTT training did not lower the loss")
    return res


def _add_counts(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def tiny_recipe(device, epochs=TINY_EPOCHS):
    """TinyTransformer at its full default width from the zoo's seed,
    trained on ``device`` by the recipe of the bundled LSTM weights
    (stride-8 corpus windows, B=32, T=64, one ``fit_scan`` of 26 steps per
    epoch). Returns (net, results): training seconds (synchronized), the
    last batch's loss every 10 epochs, held-out top-1 through ``evaluate``
    after epoch 10 and after the last, and the launch counts of the
    training steps and, apart, of each evaluation. Runs on the CPU too
    (``python3 -c 'import chip_smoke; print(chip_smoke.tiny_recipe("cpu")
    [1])'``), which is where the CPU port's figures beside the bars come
    from."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

    (xtr, ytr), (xte, yte), vocab = corpus_windows(T=TINY_T, stride=8)
    B, T = TINY_B, TINY_T
    steps = len(xtr) // B
    net = TinyTransformer(vocab_size=len(vocab)).init(device=device)
    xs = torch.tensor(xtr[:steps * B].reshape(steps, B, T, -1)).to(device)
    ys = torch.tensor(ytr[:steps * B].reshape(steps, B, T, -1)).to(device)
    held_out = DataSet(xte, yte)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
    res = {"device": device, "steps_per_epoch": steps, "epochs": epochs,
           "batch": B, "T": T, "loss_every_10_epochs": [],
           "heldout_top1": {}, "launches_train": {}, "launches_eval": {},
           "seconds": 0.0}
    for ep in range(1, epochs + 1):
        ops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        net.fit_scan(xs, ys)
        sync()
        res["seconds"] += time.perf_counter() - t0
        _add_counts(res["launches_train"], ops.launch_counts())
        if ep % 10 == 0:
            res["loss_every_10_epochs"].append(net.get_score())
        if ep in (10, epochs):
            ops.reset_launch_counts()
            c0 = net.serving_engine().stats()["device_calls"]
            res["heldout_top1"][ep] = net.evaluate(held_out).accuracy()
            res["launches_eval"][ep] = {
                "counts": ops.launch_counts(),
                "bucketed_forwards":
                    net.serving_engine().stats()["device_calls"] - c0}
    n = steps * epochs
    res.update(steps=n, ms_per_step=res["seconds"] / n * 1e3,
               tokens_per_s=n * B * T / res["seconds"])
    return net, res


def _param_diffs(got, want):
    """Largest |got - want| over every parameter but the key biases, and
    over the key biases (``bk``: no gradient, see tiny_train_phase)."""
    other = bk = 0.0
    for n, p in want.items():
        for k, w in p.items():
            d = (got[n][k].float().cpu() - w.float().cpu()).abs().max().item()
            if k == "bk":
                bk = max(bk, d)
            else:
                other = max(other, d)
    return other, bk


def tiny_train_phase(card):
    """Train TinyTransformer at its full default width on the card; every
    check raises on failure. Returns the measured numbers.

    ``bk`` has no gradient: a constant added to every key shifts each
    query's scores by one number, which the softmax ignores, so what K7
    returns for it is rounding noise that Adam scales up to steps of about
    lr. It is held to 2 x lr x steps, every other parameter to 1e-4."""
    import torch
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

    zoo = TinyTransformer(vocab_size=51)
    lr = zoo.conf().global_conf.updater.learning_rate
    res = {"card": card}
    one_step = {"flash_attn_fwd": 2, "flash_attn_dq": 2, "flash_attn_dkv": 2}

    # (a) the card against the CPU port from the same initial parameters
    for T, B, stride in ((64, 32, 8), (512, 8, 64)):
        (xtr, ytr), _, vocab = corpus_windows(T=T, stride=stride)
        cpu = zoo.init(device="cpu")
        gpu = ComputationGraph(cpu.conf, device="cuda").set_params(cpu.params)
        x0, y0 = xtr[:B], ytr[:B]
        g_cpu, s_cpu = cpu.compute_gradient_and_score(x0, y0)
        ops.reset_launch_counts()
        g_gpu, s_gpu = gpu.compute_gradient_and_score(x0, y0)
        torch.cuda.synchronize()
        _expect_launches(f"tiny train (a) T={T} gradients", one_step)
        grad_err = _max_rel_err([g_gpu[n] for n in g_cpu], list(g_cpu.values()))
        losses_cpu, losses_card = [], []
        ops.reset_launch_counts()
        for k in range(3):
            batch = (xtr[k * B:(k + 1) * B], ytr[k * B:(k + 1) * B])
            losses_cpu.append(cpu.fit(*batch).get_score())
            losses_card.append(gpu.fit(*batch).get_score())
        _expect_launches(f"tiny train (a) T={T} fit",
                         {k: 3 * n for k, n in one_step.items()})
        ops.reset_launch_counts()
        scores = (gpu.score(inputs=x0, labels=y0),
                  cpu.score(inputs=x0, labels=y0))
        _expect_launches(f"tiny train (a) T={T} score", {"flash_attn_fwd": 2})
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(losses_card + [s_gpu, scores[0]],
                           losses_cpu + [s_cpu, scores[1]]))
        p_err, bk_err = _param_diffs(gpu.params, cpu.params)
        res[f"parity_T{T}"] = {
            "batch": B, "grad_rel_err": grad_err, "loss_rel_err": loss_rel,
            "losses_card": losses_card, "losses_cpu": losses_cpu,
            "param_max_abs_err": p_err, "bk_max_abs_err": bk_err}
        print(f"tiny train (a) T={T} B={B}: step-1 gradients on the card vs "
              f"the CPU port: max abs err {grad_err:.3g} of max|grad| (tol "
              f"{GRAD_TOL}); 3 fit losses card {losses_card} vs CPU "
              f"{losses_cpu}, score, max rel err {loss_rel:.3g} (tol "
              f"{LOSS_RTOL}); parameters after: max abs err {p_err:.3g} "
              f"(tol {GRAD_TOL}), bk {bk_err:.3g} (tol {6 * lr:g}); launches "
              f"exactly 2 K5 + 2 K6 + 2 K7 per step, 2 K5 per score "
              f"[{card}]", flush=True)
        if not (grad_err <= GRAD_TOL and loss_rel <= LOSS_RTOL
                and p_err <= GRAD_TOL and bk_err <= 2 * lr * 3):
            raise AssertionError(f"TinyTransformer training at T={T} on the "
                                 "card disagrees with the CPU port")

    # (b) the recipe from the seed
    net, rec = tiny_recipe("cuda")
    n = rec["steps"]
    res["recipe"] = rec
    top1, curve = rec["heldout_top1"], rec["loss_every_10_epochs"]
    print(f"tiny train (b): {n} steps (B={TINY_B}, T={TINY_T}) in "
          f"{rec['seconds']:.1f} s: {rec['ms_per_step']:.3f} ms/step, "
          f"{rec['tokens_per_s']:.0f} tokens/s; loss every 10 epochs "
          f"{[round(x, 4) for x in curve]}; held-out top-1 after epoch 10 "
          f"{top1[10]:.4f} (floor {TINY_TOP1_EPOCH10}), after epoch "
          f"{TINY_EPOCHS} {top1[TINY_EPOCHS]:.4f}; launches "
          f"{rec['launches_train']}, evaluations {rec['launches_eval']} "
          f"[{card}]", flush=True)
    if rec["launches_train"] != {k: n * c for k, c in one_step.items()}:
        raise AssertionError(f"recipe launches {rec['launches_train']}, want "
                             f"{2 * n} each of K5, K6 and K7")
    for ep, ev in rec["launches_eval"].items():
        if ev["counts"] != {"flash_attn_fwd": 2 * ev["bucketed_forwards"]} \
                or ev["bucketed_forwards"] < 1:
            raise AssertionError(f"evaluate after epoch {ep} launched {ev}")
    if not (top1[10] >= TINY_TOP1_EPOCH10 and curve[-1] <= TINY_LOSS_EPOCH90):
        raise AssertionError(f"recipe missed its bars: top-1 {top1}, losses "
                             f"{curve}")

    # (c) the checkpoint with its updater, resumed on the card
    path = ROOT / "build" / "tiny_trained.zip"
    path.parent.mkdir(exist_ok=True)
    net.save(path)
    loaded = ComputationGraph.load(path, device="cuda")
    (xtr, ytr), _, _ = corpus_windows(T=TINY_T, stride=8)
    x0, y0 = xtr[:TINY_B], ytr[:TINY_B]
    ops.reset_launch_counts()
    net.fit(x0, y0)
    loaded.fit(x0, y0)
    _expect_launches("tiny train (c)", {k: 2 * c for k, c in one_step.items()})
    p_err, bk_err = _param_diffs(loaded.params, net.params)
    res["resume"] = {"loss": loaded.get_score(), "twin_loss": net.get_score(),
                     "iteration": loaded.iteration,
                     "param_max_abs_err": max(p_err, bk_err),
                     "zip_bytes": path.stat().st_size}
    path.unlink()
    print(f"tiny train (c): saved with its updater ({res['resume']['zip_bytes']}"
          f" bytes), loaded on the card, one more step: loss "
          f"{res['resume']['loss']} vs {res['resume']['twin_loss']}, "
          f"parameters max abs diff {max(p_err, bk_err):.3g}, iteration "
          f"{loaded.iteration} [{card}]", flush=True)
    if not (loaded.iteration == net.iteration == n + 1
            and abs(res["resume"]["loss"] - res["resume"]["twin_loss"])
            <= 1e-6 * abs(res["resume"]["twin_loss"])
            and max(p_err, bk_err) <= 1e-6):
        raise AssertionError("the resumed graph's step differs")

    # (d) where a train step's time goes
    prof = profile_steps(net, x0, y0)
    res["profile"] = prof
    busy = prof["device_busy_ms_per_step"]
    print(f"tiny train (d): torch.profiler over {prof['steps']} fit steps: "
          f"{prof['wall_ms_per_step']:.3f} ms/step profiled, device busy "
          + ("not measured (no device events)" if busy is None else
             f"{busy:.3f} ms/step (idle {prof['device_idle_share']:.1%}), "
             f"{prof['kernels_per_step']:.0f} kernels/step; attention "
             f"kernels {prof['attention_ms_per_step']:.4f} ms/step")
          + f"; host self time per step, top: {prof['top_host_ops'][:5]} "
          f"[{card}]", flush=True)
    return res


def profile_steps(net, x, y, steps=10):
    """``steps`` fit steps (after one unprofiled) under torch.profiler: the
    profiled wall ms per step, the device's busy ms per step (the sum of
    its kernels' times: one stream, so they do not overlap) and idle
    share, kernels per step, the attention kernels' ms per step, and the
    host operations with the most self time per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    net.fit(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            net.fit(x, y)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"steps": steps, "wall_ms_per_step": wall,
           "device_busy_ms_per_step": None, "top_host_ops": [
               [a.key, a.count // steps,
                round(a.self_cpu_time_total / 1e3 / steps, 4)]
               for a in sorted(prof.key_averages(),
                               key=lambda a: a.self_cpu_time_total,
                               reverse=True)[:12]]}
    if kernels:
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
        attn = sum(e.time_range.elapsed_us() for e in kernels
                   if "flash_attn" in e.name) / 1e3 / steps
        out.update(device_busy_ms_per_step=busy, attention_ms_per_step=attn,
                   device_idle_share=1 - busy / wall,
                   kernels_per_step=len(kernels) / steps)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from deeplearning4j_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = build.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for "
          f"{sorted(built)}", flush=True)
    for stem, info in built.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build: {stem} {info['seconds']:.1f} s; " + " | ".join(regs),
              flush=True)

    rows = []
    grid = {"lstm_fwd": (1, 16, 256), "lstm2_fwd": (1, 16, 256),
            "lstm_fwd_train": (1, 32, 256), "lstm2_fwd_train": (1, 32, 256),
            "lstm_bwd": (1, 32, 256)}
    for kernel, batches in grid.items():
        for dtype in ("float32", "bfloat16"):
            for B in batches:
                rows.append(kernel_case(kernel, 64, B, 256, dtype))
                print("kernel: " + fmt(rows[-1]) + f" [{card}]", flush=True)
    for B in (1, 16, 64):
        for T in (64, 512):
            for causal in (False, True):
                rows.append(attn_kernel_case("flash_attn_fwd", B, T, causal))
                print("kernel: " + fmt_attn(rows[-1]) + f" [{card}]",
                      flush=True)
    for B in (1, 32, 64):
        for T in (64, 100, 512):
            for causal in (False, True):
                pair = bwd_kernel_case(B, T, causal)
                rows.extend(pair)
                print("kernel: " + fmt_bwd(pair) + f" [{card}]", flush=True)
    for kernel in ("flash_decode", "flash_decode_paged"):
        for B in (1, 8, 64):
            rows.append(attn_kernel_case(kernel, B, 512))
            print("kernel: " + fmt_attn(rows[-1]) + f" [{card}]", flush=True)

    res = slice_phase(card)
    t0 = time.perf_counter()
    tiny = transformer_phase(card)
    tiny["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = train_phase(card)
    train["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiny_train = tiny_train_phase(card)
    tiny_train["phase_seconds"] = time.perf_counter() - t0

    # each kernel at its main path's shape, with the launches of the run
    # that drove it: /predict of the 15 held-out windows (bucket 16, T=64)
    # runs K4, rnn_time_step in 16-step chunks of 15 rows K1; the recipe's
    # steps (B=32, T=64) K4-train and K3; tBPTT chunks (B=32, T=16) K2
    main_shapes = {"lstm2_fwd": (64, 16, res["launches"]),
                   "lstm_fwd": (16, 15, res["launches"]),
                   "lstm2_fwd_train": (64, 32, train["launches_recipe"]),
                   "lstm_bwd": (64, 32, train["launches_recipe"]),
                   "lstm_fwd_train": (16, 32, train["launches_tbptt"])}
    entries = []

    def entry(kernel, row, launches):
        entries.append({
            "name": kernel, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{SOURCES[kernel]}",
            "replaces": REPLACES[kernel], "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
        if "tc_bound_ms" in row:       # K5-K7: the tensor-core bound too
            entries[-1].update(tc_bound_ms=row["tc_bound_ms"],
                               tc_bound_by=row["tc_bound_by"])
        rows.append(row)
    for kernel, (T, B, counts) in main_shapes.items():
        row = kernel_case(kernel, T, B, 256, "float32", seed=1)
        print("main-path shape: " + fmt(row) + f" [{card}]", flush=True)
        entry(kernel, row, counts.get(kernel, 0))
    # TinyTransformer: /predict of the held-out windows runs K5 at bucket 16
    # (BH 64, T=64, causal); the 8-slot engines run K8/K9 with C=512, here
    # at the streams' positions halfway through their completions
    row = attn_kernel_case("flash_attn_fwd", 16, 64, True, seed=1)
    print("main-path shape: " + fmt_attn(row) + f" [{card}]", flush=True)
    entry("flash_attn_fwd", row,
          tiny["launches_predict"]["flash_attn_fwd"]
          + tiny["launches_mixed"]["flash_attn_fwd"])
    # the recipe's train steps (B=32, T=64) run K6 and K7 at BH 128, causal
    recipe = tiny_train["recipe"]["launches_train"]
    for row in bwd_kernel_case(TINY_B, TINY_T, True, seed=1):
        entry(row["kernel"], row, recipe[row["kernel"]])
    print("main-path shape: " + fmt_bwd(rows[-2:]) + f" [{card}]", flush=True)
    mid = [n + 32 for n in (16, 22, 28, 34, 40, 46, 52, 64)]
    for kernel, kind in (("flash_decode", "dense"),
                         ("flash_decode_paged", "paged")):
        row = attn_kernel_case(kernel, 8, 512, pos=mid, seed=1)
        print("main-path shape: " + fmt_attn(row) + f" [{card}]", flush=True)
        entry(kernel, row, tiny[f"launches_{kind}"][kernel])

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernel_rows": rows, "slice": res, "tiny": tiny, "train": train,
         "tiny_train": tiny_train, "kernels": entries}, indent=1))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
