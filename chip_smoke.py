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
   K3 also at (T, B, H) = (16, 32, 300), (16, 32, 432) and (16, 32, 433)
   -- on an H100 the largest H of its cluster route and the smallest of
   its grid-wide route -- and (16, 32, 1056), the largest H K3 takes at
   B=32, which the run also checks; every K3 case runs 20 more times and
   must repeat bit for bit, and its line shows the plan (route, cluster
   size, clusters, rows per cluster) and us per reverse step (ms / (T +
   1)). K4 and K4-train also at (16, 32, 256) and (16, 32, 257) -- on an
   H100 the largest H of their cluster route and the smallest of their
   grid-wide route -- and (16, 32, 581), the largest H they take at B=16
   and 32, which ``k4_hidden_sizes`` checks for both modes; every K4 case
   runs 20 more times and must repeat bit for bit, and its line shows the
   plan and us per iteration (ms / (T + 1)). K1 and K2 also at (16, 32,
   432) and (16, 32, 433) -- on an H100 the largest H of their cluster
   route and the smallest of their grid-wide route -- and (16, 32, 1056),
   the largest H they take at B=16 and 32, which ``k12_hidden_sizes``
   checks for both modes; every K1 and K2 case runs 20 more times and must
   repeat bit for bit, and its line shows the plan and us per step (ms /
   T). Tolerance f32 1e-4, bf16 3e-2, on every output (K3's relative to
   the largest magnitude of the plain version's). The attention family in
   float32, tolerance 1e-4: K5 (flash attention forward, o and lse) at
   B in {1, 16, 64} x 4 heads, T in {64, 512}, Dh=32, causal and not; K6
   (dq, and the delta it writes for K7) and K7 (dk, dv), the flash
   attention backward, at B in {1, 32, 64} x 4 heads, T in {64, 100,
   512}, Dh=32, causal and not, relative to the largest gradient of the
   plain version; K8 (flash decode, dense cache) and K9 (paged pool,
   bs=16, shuffled page tables) at B in {1, 8, 64}, 4 heads, C=512,
   positions spread over 0..511 (one stream at 511), each with its plan
   (blocks per cluster S, clusters), 20 more launches that must repeat
   bit for bit, and its launch floor (an empty kernel on the same grid and
   cluster shape, timed the same way). Then head dims past 128, which the
   attention kernels take through their column-chunk split: K5, K6 + K7
   (B=2 x 2 heads) and K8, K9 (B=4, 2 heads) at Dh in {136, 256, 520} and
   T (or C) in {64, 100}, causal and not, at the same tolerances, K6 and
   K7 repeating bit for bit. With CUDA-event medians of the kernel,
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
   bit. Every kernel's time is its device time (calls replayed from a
   CUDA graph: a small kernel runs for less than the host takes to launch
   it), beside the time of a call launched from the host.
4. Serving: the bundled TextGenerationLSTM served by ``InferenceServer`` on
   the card: held-out /predict accuracy, concurrent mixed-size /predict
   against unbatched forwards, greedy /generate against the full-prefix
   path, ``rnn_time_step`` in chunks against ``output``. Then F4's
   shapes, where the LSTM screens' shape half decides (``f4_phase``): (a)
   2 x LSTM(600) f32 at B=32, (b) LSTM(2048) f32 at B=32, (c) bfloat16
   LSTM(1088) at B=1; each net's output, step-1 gradients and one ``fit``
   step against the CPU port (f32 1e-4, bf16 3e-2), with exactly the
   launches the plan queries answer for ((a): no wavefront kernel).
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
   margin at that step must be <= 1e-4 (a near-tie of the seed weights);
   then ten steps of each engine (8 streams of one prompt token and ten
   new tokens) under ``torch.profiler``: ms per step, device busy time and
   idle share, and K8's or K9's share of the busy time.
   (c) The same model with 2 heads of 256 (d_model 512, 2 blocks, FFN
   2048; every attention kernel through its column-chunk split): /predict
   of the held-out windows against the CPU port (1e-4), 8 greedy streams
   on the dense and the paged engine against ``generate_naive`` under the
   same near-tie rule, and three ``fit`` steps at T=64, B=32 against the
   CPU port at the bars of 7 (a) below.
6. Training, the LSTM model at full width: (a) step-1 gradients and three
   ``fit`` steps on the card against the same on the CPU (plain versions)
   from the same initial parameters; (b) the recipe that trained the
   bundled weights (tools/make_pretrained.py: stride-8 windows, batch 32,
   90 epochs of ``fit_scan``) from the seed, with ms per step, tokens per
   second and held-out top-1 (at least the manifest's 0.2979 - 0.03),
   then ten more ``fit_scan`` steps timed without and with
   ``torch.profiler`` (device busy time and idle share, device operations
   per step, K4-train's and K3's time, the host operations that take the
   most time); (c) the same with truncated BPTT in chunks of 16 for 2
   epochs, whose held-out loss must fall, then ten more tBPTT batches
   under ``torch.profiler`` (device busy time and idle share per batch,
   K2's and K3's time per batch).
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
   steps, the same way.
8. Captured training. Every fit path on the card runs its step through
   CUDA graphs (the first step of a signature eagerly, as the warm-up),
   so 6 and 7 above already train captured and keep their bars. Here, per
   path -- the LSTM recipe's steps, its tBPTT batches, the TinyTransformer
   recipe's steps -- three nets from one init (the per-layer loop, the
   fused eager step, the captured step), ten steps each: the fused eager
   step against the loop bit for bit, the captured against the eager
   within 1e-5 of max|p| (and whether bit for bit), every step's launches
   under replay equal to the eager step's; then ten more steps of the
   eager and of the captured net under ``torch.profiler`` (ms per step,
   device busy time, idle share, device operations). Then the bf16
   train-precision policy: three ``fit`` steps of the LSTM model and of
   TinyTransformer on the card against the CPU port (losses within 3e-2,
   parameters and updater state float32).
9. Regularised and masked training, paths S1-S7 at full width (B=32,
   T=64, float32, from the configurations' seed): S1 the
   TextGenerationLSTM with dropout 0.5 on layer 1 (the pair still fuses:
   K4-train + 2 x K3 a step, K4 at inference), S2 with a global dropout
   0.2 and S3 with a global DropConnect(0.8) (the pair broken: 2 x K2 + 2
   x K3, 2 x K1), S4 Bidirectional(LSTM(256)) concat -> LastTimeStep(
   LSTM(256)) -> OutputLayer on the character after each window (3 x K2
   + 3 x K3, 3 x K1), S5 TinyTransformer with dropout 0.1 on every layer
   (2 each of K5, K6, K7; K5 at inference), S6 the plain TextGenerationLSTM
   on windows of lengths 16..64 (seed 123) with feature and label masks,
   and S7 GravesBidirectionalLSTM -> GravesLSTM -> SimpleRnn ->
   RnnOutputLayer (S6 and S7 run the layers' own loops: no kernel). Per
   path: (a) step-1 loss and gradients and three ``fit`` steps of the
   card's eager step against the CPU port, the card's draws recorded
   through the port's draw seam and replayed into the CPU port
   (gradients within 1e-4 of max|grad|, losses rtol 1e-4); (b) ten steps
   eager and captured from one init, bit for bit, with exactly the
   launches above in every step, and the capture's seconds and the bytes
   of its graph's private memory pool; (c) ten more captured steps under ``torch.profiler``; (d)
   ``output`` of the held-out windows against the CPU port (1e-4) with
   exactly the inference launches above (S4 also ``evaluate``). Then (e)
   the card's generator: Dropout(0.5) keeps 0.5 +- 0.005 of 10^6 draws,
   GaussianDropout's, GaussianNoise's and AlphaDropout's moments within
   1e-2.
10. The fit contract, F1-F7 (the default f32 train-precision policy;
   B=32, T=64; the corpus's stride-8 windows one-hot over the zoo's 77
   columns, 26 batches an epoch, shuffled from seed 5). F1: the zoo's
   TextGenerationLSTM (2 x LSTM(256), RnnOutputLayer 77) streams 2 epochs
   through ``fit(iterator, prefetch=2, checkpoint=CheckpointListener(dir,
   every_n_iterations=8, keep_last=3))`` with a recording listener,
   ``ScoreIterationListener(10)`` and ``CollectScoresIterationListener(1)``,
   chunks of at most 8 steps (``_CHUNK_MAX_STEPS`` on the instance): the
   listeners' (iteration, epoch) calls and the number of saves equal the
   CPU port's on the same stream, the losses at each call within 1e-4
   relative, K4-train once and K3 twice a step, one capture. F2: the same
   with prefetch 0, the final parameters and updater state bit for bit
   those of prefetch 2, and a ``DevicePrefetcher`` over the stream keeps
   at least one item staged until the last. F3: F1 stopped by a listener
   at the first call past iteration 48 in epoch 2, then a fresh network
   ``fit(iterator, epochs=2, resume_from=dir)``: the directory holds 3
   zips and a manifest whose largest (iteration, epoch) entry, read from
   the JSON and the file names alone, is the zip the port resumed from;
   the final parameters and updater state bit for bit those of F1. Then
   ms per step of a warm 3-epoch fit with prefetch 0 and 2 (in turns 0,
   2, 2, 0), with their pipeline stats, against ``fit_scan`` over the same
   batches already on the card, and ms per checkpoint save. F4: the same
   layers as a ComputationGraph with ``backprop_type("tbptt", 16, 16)``,
   4 batches: parameters within 1e-4 of the CPU port fed the same
   batches, K2 twice and K3 twice a chunk, 2 captures; ms per batch
   against the MultiLayerNetwork's truncated BPTT (in turns). F5: F4's
   graph, ``rnn_time_step``: 256 greedy characters at B=1 (ms per
   character), each step within 1e-4 of the same step of ``output`` over
   the whole prefix and the same character unless a top-2 margin is at
   most 1e-4, K1 twice a call; one call at B=15, T=16 within 1e-4 of
   ``output``; after ``rnn_clear_previous_state`` the first 8 steps repeat
   bit for bit. F6: TinyTransformer (d_model 128, 4 heads, 2 blocks, vocab
   51) streams 2 epochs with ``prefetch=2`` and a ``PerformanceListener``:
   K5, K6 and K7 twice each a step, its losses and the listener's
   samples/s. F7: F1's network with dropout 0.5 on layer 1, with
   ``remat`` and without: the step-1 gradient under the same draws bit for
   bit, K4-train twice (forward and recompute) and K3 twice; 5 captured
   fit steps to the same bits, and warm ms per step of both.
11. The decode engine's default paged path and speculation
   (``serving_features_phase``). (a) TinyTransformer at its full default
   width from the configuration's seed (as 5) on a paged engine (8 slots,
   max_len 512, kv_block_size 16, the default pool, the prefix cache,
   chunk_tokens 32): wave 1, 8 greedy streams of 64 new tokens whose
   prompts share the corpus's first 48 tokens (3 full blocks) followed by
   distinct tails of 8..40 corpus tokens; wave 2, the same 8 prompts and
   the longest cut to 72 tokens (4 full blocks and 8 positions of the
   fifth, which wave 1 published: a copy-on-write). Tokens against a paged
   engine with neither the prefix cache nor chunks and against
   ``generate_naive`` under the near-tie rule of 5; K9 exactly twice a
   plain step (a chunk and a copy launch none); no block in use after the
   last request; wave 2 all prefix hits and at least one copy; the prefix
   hits, tokens saved, copies, chunks and cached blocks of the 17 prompts
   one at a time (8 new tokens each) equal the CPU port's; time to first
   token of wave 1's prompts submitted together with and without chunks
   (no prefix cache); ms per step of wave 2 against wave 1. (b) The same
   model, dense and paged (prefix cache) engines, 8 streams of 64 new
   tokens from held-out prompts of 16..64 tokens, greedy and sampled
   (temperature 0.9, seed 123), with two drafts: the target itself, k=4,
   and a 1-block TinyTransformer (d_model 128, 4 heads) from seed 3 with
   the tree (3, 2, 2). Greedy tokens against the plain engine's under the
   near-tie rule; sampled ones identical unless the plain engine's
   Gumbel-score top-2 gap at the first difference is at most 1e-4; K8's
   plan at a plain step's 8 rows and at a verify's 8 x nodes rows; exactly
   the launches of the plain steps (K8 dense, K9 paged), the verifies (K8)
   and the draft's steps (K8 once a draft attention layer); acceptance,
   tokens a tick, ms a tick and tokens/s against the plain engine; ten
   ticks of one-token prompts under ``torch.profiler`` (busy ms, idle
   share, K8/K9's share). (c) The bundled TextGenerationLSTM (2 x
   LSTM(256)) with ``SpecConfig(self_draft="early_exit:1", tree=(3, 2))``
   on a dense engine and on a paged one without the prefix cache and with
   chunks of 32: greedy tokens of 8 streams equal the plain engine's, and
   the plain engine's the CPU port's under the near-tie rule; no kernel
   launched (the LSTM's decode step is a plain cell step); acceptance and
   tokens/s; ``DecodeEngine(lstm, kv="paged")`` raises the JAX package's
   ValueError. (d) The captured decode engine (``captured_engine_part``):
   every program of the engine -- the plain step, the prefill chunk, the
   copy-on-write, the draft, the verify -- a CUDA graph captured in
   ``warmup()``. The same TinyTransformer, 8 slots, max_len 512, 8 streams
   of 64 new tokens from held-out prompts of 16..64 tokens, in six parts:
   the plain dense engine; the plain paged engine with the prefix cache
   and chunks of 32; the target as its own draft (k=4), dense; the seed-3
   draft with tree (3, 2, 2), dense, paged, and paged with chunks of 32
   (speculation with chunked prefill); and the TextGenerationLSTM with
   ``early_exit:1``, tree (3, 2), dense. Each part runs the eager engine
   (the ``_capture_programs = False`` seam) and the captured one in turns
   over 5 rounds in this call: tokens identical between them and across
   rounds, greedy tokens against ``generate_naive`` under the near-tie
   rule, the launches of every round exactly the plain steps', verifies'
   and draft steps' (as (b)), each program one capture whose replay
   launches its K8 or K9 once an attention layer (and position for the
   draft) and nothing for a chunk or a copy, no new capture after
   ``warmup()``, ``trace_count`` 1, no block in use at the end; ms a step
   (plain: decode seconds a step) or a tick (wall a verify) eager and
   captured, min / median / max of the 5 rounds; ten captured steps or
   ticks under ``torch.profiler``; the counters of 3 prompts one at a time
   (24 new tokens) against the CPU port's where the tokens agree.
   Then tokens/s of each part against the captured plain engine, time to
   first token of the 8 prompts with and without chunks (captured paged
   engines without the prefix cache), one ``swap_weights`` (a seed-7
   TinyTransformer) staged while 8 streams run (they finish on the old
   weights; the next 8 equal ``generate_naive`` of the new weights under
   the near-tie rule; no new capture) and one ``eos_id`` run (every stream
   ends at its first ``eos_id``).
12. The convolutional path (``cnn_phase``), which runs no hand-written
   kernel (cuDNN convolutions and plain PyTorch pooling and batch
   normalization, as the JAX package leaves them to XLA): every kernel
   count must stay 0. (a) The three bundled CNN zips served with
   ``InferenceServer`` on the card: ``lenet.zip`` on 2000 synthetic MNIST
   test images, ``simplecnn.zip`` on 800 48 x 48 images of test seed 77,
   ``resnet50_cifar10.zip`` on 2000 synthetic CIFAR-10 images, each
   within 0.02 of its manifest accuracy through /predict, its
   probabilities within 1e-4 (LeNet, SimpleCNN) or 1e-3 (ResNet50Cifar)
   of the CPU port's from the same zip, and eight concurrent mixed-size
   /predict calls within 1e-5 of one unbatched forward each. (b) LeNet
   from its seed on ``MnistDataSetIterator(128, num_examples=6400,
   flatten=False)`` (uint8 on the wire, the device-side /255 after the
   copy): its first 5 steps' losses and parameters within 1e-4 of the CPU
   port's; 10 captured steps equal 10 eager steps bit for bit
   (deterministic cuDNN); 6 epochs captured, held-out accuracy on 2000
   test images above 0.85 and below 1.0, ms a step; ten captured steps
   profiled (busy ms, idle share, device operations, cuDNN's convolution
   kernels' share). (c) ResNet50 at full width (224 x 224 x 3, 1000
   classes) from its configuration's seed, trained with Sgd(1e-2), on
   numpy images: /predict at B=1 and B=32 (ms a request; B=1 within 1e-3
   of the CPU port); at B=4 one float32 step (loss, running statistics)
   and two float64 steps within 1e-3 of the CPU port; 3 captured steps
   equal 3 eager ones bit for bit (deterministic cuDNN), eager ms a step;
   20 captured steps at B=32 (ms a step, images/s) and ten profiled. (d)
   SimpleCNN (48 x 48 x 3, 5 classes), 2 epochs of 16 uint8 batches with
   the device scaler, checkpointed every 4 iterations with its
   normalizer, stopped past iteration 22 and resumed in a fresh network:
   parameters and BatchNormalization state equal the uninterrupted run's
   bit for bit, the checkpoint's normalizer the scaler.

A replayed CUDA graph adds to the launch counts the launches its capture
recorded (the capture itself counts none), so the counts below are the
kernels that ran. Kernel launch counts are reset right before the LSTM
serving phase, before
each TinyTransformer part (the 256-wide heads' too), before training (b)
and (c) and before each part of the TinyTransformer training, and read
right after (and around each counted run of 11); each
TinyTransformer part and the training runs must launch exactly the kernels
their call or step counts call for (K5 twice per bucketed forward, K8 or
K9 twice per engine step; K5, K6 and K7 twice each per TinyTransformer
train step, K5 alone for ``score`` and ``evaluate``), and nothing else.

After the phases each kernel is timed again at its main path's shape, and
K5-K9 at the wide-heads phase's shapes (K5-K7 also at Dh 128 beside them,
the split's cost). Prints, before the last line, one JSON line of
per-kernel numbers and the card's name and power limit; the last line is
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
from contextlib import contextmanager
from pathlib import Path

import numpy as np

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
# K3's extra cases: ragged H=300, both sides of the cluster route's
# boundary (the largest H whose RW slice fits a 16-block cluster on an
# H100, and the next, which takes the grid route) and the largest H the
# grid-wide route takes at B=32 (``k3_hidden_sizes`` on an H100: 1056)
K3_LARGEST_H = 1056
K3_SHAPES = ((16, 32, 300), (16, 32, 432), (16, 32, 433),
             (16, 32, K3_LARGEST_H))
# K4's and K4-train's: both sides of the cluster route's boundary (the
# largest H whose weight columns fit a 16-block cluster on an H100, and
# the next) and the largest H the grid-wide route takes at B=16 and 32
# (``k4_hidden_sizes`` on an H100: 581, the same before and after the
# cluster route came)
K4_LARGEST_H = 581
K4_SHAPES = ((16, 32, 256), (16, 32, 257), (16, 32, K4_LARGEST_H))
# K1's and K2's: both sides of the cluster route's boundary (the largest H
# whose RW columns fit a 16-block cluster on an H100, and the next) and the
# largest H the grid-wide route takes at B=16 and 32 (``k12_hidden_sizes``
# on an H100: 1056, the same before and after the cluster route came)
K12_LARGEST_H = 1056
K12_SHAPES = ((16, 32, 432), (16, 32, 433), (16, 32, K12_LARGEST_H))
# the kernels that sum in a fixed order (no atomics), and the launches of
# their bitwise-repeat check
REPEATED = ("lstm_fwd", "lstm_fwd_train", "lstm_bwd", "lstm2_fwd",
            "lstm2_fwd_train")
REPEATS = 20
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
# head dims past the 128 columns a block of K5-K9 holds (the column-chunk
# split): the kernel sweep, and a TinyTransformer of 2 heads of 256
WIDE_HEAD_DIMS = (136, 256, 520)
WIDE_D_MODEL, WIDE_HEADS = 512, 2
CHUNK_COLUMNS = 128             # the widest head dim a block holds whole


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
           "ms": graph_ms(lambda: wrapper(*args), reps=10),
           "call_ms": time_ms(lambda: wrapper(*args), reps=10),
           "plain_ms": time_ms(lambda: plain(*args), reps=plain_reps,
                               rounds=3)}
    if kernel in REPEATED:      # every launch must give the same bits
        for _ in range(REPEATS):
            again = wrapper(*args)
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                raise AssertionError(f"{kernel} T={T} B={B} H={H} "
                                     f"{dtype_name}: a repeat differs")
        row["repeats_bitwise"] = REPEATS
        # per step (K1, K2: T of them), reverse step (K3) or wavefront
        # iteration (K4): T + 1 of each
        steps = T if kernel.startswith("lstm_fwd") else T + 1
        row["us_per_step"] = row["ms"] * 1e3 / steps
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


def hidden_sizes(wrapper, shapes, lo, hi):
    """The hidden sizes H in [lo, hi] that ``wrapper`` takes on float32
    zeros of ``shapes(H)`` on this card (the kernel refuses the others)."""
    import torch
    took = []
    for H in range(lo, hi + 1):
        try:
            wrapper(*[torch.zeros(s, device="cuda") for s in shapes(H)])
            took.append(H)
        except RuntimeError as e:   # the kernel refused this H
            if "kernel failed" not in str(e):
                raise
    torch.cuda.synchronize()
    return took


def k3_hidden_sizes(lo, hi, B=32):
    """The hidden sizes in [lo, hi] that K3 takes at T=1, batch B."""
    from deeplearning4j_tpu_torch import ops
    return hidden_sizes(ops.fused_lstm_backward, lambda H: (
        (1, B, 4 * H), (1, B, H), (1, B, H), (H, 4 * H), (1, B, H), (B, H)),
        lo, hi)


def k12_hidden_sizes(lo, hi, batches=(16, 32)):
    """The hidden sizes in [lo, hi] that K1 and K2 take at T=1, each batch
    in ``batches``: {"<kernel> B=<B>": [H, ...]}."""
    from deeplearning4j_tpu_torch import ops
    took = {}
    for name, wrapper in (("lstm_fwd", ops.fused_lstm_sequence),
                          ("lstm_fwd_train", ops.fused_lstm_sequence_train)):
        for B in batches:
            took[f"{name} B={B}"] = hidden_sizes(wrapper, lambda H, B=B: (
                (1, B, 4 * H), (H, 4 * H), (B, H), (B, H)), lo, hi)
    return took


def k4_hidden_sizes(lo, hi, batches=(16, 32)):
    """The hidden sizes in [lo, hi] that K4 and K4-train take at T=1, each
    batch in ``batches``: {"<kernel> B=<B>": [H, ...]}."""
    from deeplearning4j_tpu_torch import ops
    took = {}
    for name, wrapper in (("lstm2_fwd", ops.fused_lstm2_sequence),
                          ("lstm2_fwd_train",
                           ops.fused_lstm2_sequence_train)):
        for B in batches:
            took[f"{name} B={B}"] = hidden_sizes(wrapper, lambda H, B=B: (
                (1, B, 4 * H), (H, 4 * H), (H, 4 * H), (4 * H,), (H, 4 * H),
                (B, H), (B, H), (B, H), (B, H)), lo, hi)
    return took


def fmt(row):
    lib = ("n/a" if row["library_ms"] is None
           else f"{row['library_ms']:.4f}")
    if "library_note" in row:
        lib += "*"
    line = (f"{row['kernel']:9s} T={row['T']} B={row['B']:<4d} H={row['H']} "
            f"{row['dtype']:8s} err {row['max_abs_err']:.3g} (tol "
            f"{row['tol']:g})  kernel {row['ms']:.4f} ms (a call from the "
            f"host {row['call_ms']:.4f} ms)  plain "
            f"{row['plain_ms']:.4f} ms  cudnn {lib} ms  bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    if row["kernel"] in REPEATED:
        p = row["plan"]
        per = {"lstm_bwd": "reverse step", "lstm2_fwd": "iteration",
               "lstm2_fwd_train": "iteration"}.get(row["kernel"], "step")
        line += (f"; {row['us_per_step']:.2f} us per {per}; route "
                 f"{p['route']}" + (
                     f", clusters of {p['cluster_size']} x {p['clusters']}, "
                     f"{p['rows_per_cluster']} rows each"
                     if p["route"] == "cluster" else
                     f", {p['unit_blocks']} x {p['batch_blocks']} blocks")
                 + f"; repeats bitwise x{row['repeats_bitwise']}")
    return line


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


def attn_inputs(kernel, B, T, causal=False, pos=None, seed=0, dh=HEAD_DIM,
                heads=HEADS):
    """K5: q, k, v (B*heads, T, dh). K8/K9: q (B, heads, dh), a cache of
    capacity T (dense, or a pool of 16-row blocks behind shuffled page
    tables with block 0 as scratch, T rounded up to whole blocks), and
    positions (default: spread over 0..T-1)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    if kernel == "flash_attn_fwd":
        return {"q": rnd(B * heads, T, dh), "k": rnd(B * heads, T, dh),
                "v": rnd(B * heads, T, dh), "causal": causal, "B": B,
                "heads": heads}
    if pos is None:
        pos = [T - 1] if B == 1 else \
            torch.linspace(0, T - 1, B).round().long().tolist()
    c = {"q": rnd(B, heads, dh),
         "pos": torch.tensor(pos, dtype=torch.int32, device="cuda")}
    if kernel == "flash_decode":
        c["kc"], c["vc"] = rnd(B, T, heads, dh), rnd(B, T, heads, dh)
        return c
    MB = -(-T // KV_BLOCK)
    NB = B * MB + 1
    c["pk"], c["pv"] = (rnd(NB, KV_BLOCK, heads, dh) for _ in range(2))
    perm = torch.randperm(NB - 1, generator=g, device="cuda") + 1
    c["tables"] = perm[:B * MB].reshape(B, MB).to(torch.int32).contiguous()
    return c


# the /generate engines' positions halfway through their completions (8
# streams, prompts of 16..64 tokens, 64 new tokens): K8/K9's main path
DECODE_MID = [n + 32 for n in (16, 22, 28, 34, 40, 46, 52, 64)]


def decode_positions(spec, B, C):
    """K8/K9 positions by name: "last" (every stream at C - 1), "spread"
    (0..C-1), "mid" (DECODE_MID, 8 streams), or a comma list."""
    if spec == "last":
        return [C - 1] * B
    if spec == "spread":
        return None
    if spec == "mid":
        return list(DECODE_MID)
    return [int(p) for p in spec.split(",")]


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
        q4, k4, v4 = (t.view(c["B"], c["heads"], T, Dh) for t in args[:3])
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


def attn_kernel_case(kernel, B, T, causal=False, pos=None, seed=0,
                     dh=HEAD_DIM, heads=HEADS):
    """One attention kernel at one shape: error against the plain version
    (K5: o and lse), and the four times. Launches made here are not the
    main path's; the caller resets the counters before the main path."""
    import torch
    from deeplearning4j_tpu_torch.ops import decode_cuda
    c = attn_inputs(kernel, B, T, causal, pos, seed, dh, heads)
    wrap, plain, lib = attn_calls(kernel, c)
    with torch.no_grad():
        got = wrap()
        torch.cuda.synchronize()
        want = plain()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if not err <= ATTN_TOL:
            raise AssertionError(f"{kernel} B={B} T={T} Dh={dh} causal="
                                 f"{causal}: max abs err {err} > {ATTN_TOL}")
        row = {"kernel": kernel, "B": B, "T": T, "H": heads, "Dh": dh,
               "dtype": "float32", "max_abs_err": err, "tol": ATTN_TOL,
               "ms": graph_ms(wrap, reps=20),
               "call_ms": time_ms(wrap, reps=20),
               "plain_ms": graph_ms(plain, reps=3, rounds=3),
               "library_max_abs_err": (lib() - want[0]).abs().max().item(),
               "library_ms": graph_ms(lib, reps=20)}
        if kernel.startswith("flash_decode"):
            # every merge in a fixed order: each launch gives the same bits
            for _ in range(REPEATS):
                if not torch.equal(wrap()[0], got[0]):
                    raise AssertionError(f"{kernel} B={B} T={T} Dh={dh}: a "
                                         "repeat differs")
            row["repeats_bitwise"] = REPEATS
            # the plan, and an empty kernel on its grid and cluster shape
            # (a checkout whose decode kernels report no plan has neither)
            if hasattr(decode_cuda, "launch_floor"):
                row["plan"] = decode_cuda.last_plan(kernel)
                C = c["kc"].shape[1] if "kc" in c else \
                    c["tables"].shape[1] * KV_BLOCK
                row["floor_ms"] = graph_ms(lambda: decode_cuda.launch_floor(
                    kernel, B, heads, dh, C, KV_BLOCK), reps=20)
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
    if "plan" in row:
        plan = row["plan"]
        what += (f" plan S={plan['cluster_size']} x {plan['clusters']} "
                 f"clusters of {plan['threads']} threads (>= "
                 f"{plan['min_keys_per_block']} keys a busy block), launch "
                 f"floor {row['floor_ms']:.5f} ms")
    if "repeats_bitwise" in row:
        what += f", bitwise over {row['repeats_bitwise']} launches"
    return (f"{row['kernel']:18s} B={row['B']:<3d} T={row['T']:<3d} "
            f"Dh={row['Dh']:<3d} {what} "
            f"err {row['max_abs_err']:.3g} (tol {row['tol']:g})  kernel "
            f"{row['ms']:.4f} ms (a call from the host {row['call_ms']:.4f}"
            f" ms)  plain {row['plain_ms']:.4f} ms  sdpa "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']})"
            + (f"; tensor cores {row['tc_bound_ms']:.5f} ms"
               if "tc_bound_ms" in row else ""))


def bwd_kernel_case(B, T, causal, seed=0, dh=HEAD_DIM, heads=HEADS):
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
    BH = B * heads
    q, k, v, do = (torch.randn(BH, T, dh, generator=g, device="cuda")
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
            raise AssertionError(f"K6/K7 B={B} T={T} Dh={dh} causal="
                                 f"{causal}: a second run differs from the "
                                 "first")
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
            raise AssertionError(f"{kernel} B={B} T={T} Dh={dh} causal="
                                 f"{causal}: relative err {err} > {ATTN_TOL}")
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
    leaves = [t.view(B, heads, T, dh).clone().requires_grad_()
              for t in (q, k, v)]
    do4 = do.view(B, heads, T, dh)

    def sdpa_forward():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(*leaves, is_causal=causal)

    def sdpa_step():
        return torch.autograd.grad(sdpa_forward(), leaves, do4)
    lib = sdpa_step()
    lib_err = max((a.reshape(BH, T, dh) - w).abs().max().item()
                  for a, w in zip(lib, (want_dq, want_dk, want_dv))) / scale
    step_ms, fwd_ms = graph_ms(sdpa_step, reps=20), graph_ms(sdpa_forward,
                                                             reps=20)
    lib_ms = step_ms - fwd_ms
    rows = []
    with torch.no_grad():
        for kernel, (wrap, plain) in calls.items():
            row = {"kernel": kernel, "B": B, "T": T, "H": heads,
                   "Dh": dh, "dtype": "float32", "causal": causal,
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
            f"Dh={dq['Dh']:<3d} causal={dq['causal']!s:5} rel err {dq['max_abs_err']:.3g} / "
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
                want = generate_naive(net, p, 32, 256)["tokens"]
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


# F4's shapes, where the LSTM screens' shape half decides: (a) a pair past
# K4's largest H, (b) a width no LSTM kernel takes, (c) a bfloat16 width
# the grid route refuses at one row (it sizes the weights as float32)
F4_CASES = {"a": (2, 600, 32, "float32"), "b": (1, 2048, 32, "float32"),
            "c": (1, 1088, 1, "bfloat16")}
F4_VOCAB, F4_T = 9, 8
F4_SINGLE = {False: ("lstm_fwd",), True: ("lstm_fwd_train", "lstm_bwd")}
F4_PAIR = {False: ("lstm2_fwd",), True: ("lstm2_fwd_train", "lstm_bwd")}


def f4_net(layers, H, dtype, device, seed=11):
    """``layers`` x LSTM(H) and a softmax RnnOutputLayer over F4_VOCAB
    chars; bfloat16 as the compute dtype when asked."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    lb = NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-3)) \
        .list()
    for _ in range(layers):
        lb = lb.layer(LSTM(n_out=H, activation="tanh"))
    conf = lb.layer(RnnOutputLayer(n_out=F4_VOCAB, activation="softmax",
                                   loss="mcxent")) \
        .set_input_type(InputType.recurrent(F4_VOCAB)).build()
    if dtype == "bfloat16":
        conf.global_conf.compute_dtype = "bfloat16"
    return MultiLayerNetwork(conf, device=device).init()


def f4_phase(card):
    """F4's shapes on the card: each net's output, step-1 gradients and one
    ``fit`` step against the CPU port from the same parameters (f32 1e-4,
    bf16 3e-2; gradients relative to their largest magnitude, losses
    relative), with exactly the launches the plan queries answer for: the
    pair's wavefront where every screen passes, else each layer's kernels,
    else the layers' own loops. (a) must launch no wavefront kernel. Every
    check raises on failure; returns what each case took."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.ops import lstm_cuda
    out = {}
    for tag, (layers, H, B, dt) in F4_CASES.items():
        dtype = getattr(torch, dt)
        tol = F32_TOL if dt == "float32" else BF16_TOL
        plans = {e: lstm_cuda.has_plan(e, B, H, dtype, torch.device("cuda"))
                 for e in ("lstm_fwd", "lstm_fwd_train", "lstm_bwd",
                           "lstm2_fwd", "lstm2_fwd_train")}

        def expect(rec):
            if not all(plans[e] for e in F4_SINGLE[rec]):
                return {}, "the layers' own loops"
            if layers == 2 and all(plans[e] for e in F4_PAIR[rec]):
                return ({e: 2 if e == "lstm_bwd" else 1
                         for e in F4_PAIR[rec]}, "the wavefront kernel")
            return ({e: layers for e in F4_SINGLE[rec]},
                    "the single-layer kernels, layer by layer")
        r = np.random.RandomState(0)
        eye = np.eye(F4_VOCAB, dtype=np.float32)
        x, y = (eye[r.randint(0, F4_VOCAB, (B, F4_T))] for _ in range(2))
        gpu = f4_net(layers, H, dt, "cuda")
        cpu = f4_net(layers, H, dt, "cpu").set_params(gpu.params)
        res = {"layers": layers, "H": H, "B": B, "dtype": dt, "plans": plans}
        ops.reset_launch_counts()
        got = gpu.output(x, bucketed=False)
        torch.cuda.synchronize()
        want, res["path_output"] = expect(False)
        res["launches_output"] = _expect_launches(f"F4 ({tag}) output", want)
        res["output_err"] = (got.float().cpu() - cpu.output(
            x, bucketed=False).float()).abs().max().item()
        ops.reset_launch_counts()
        g_gpu, s_gpu = gpu.compute_gradient_and_score(x, y)
        torch.cuda.synchronize()
        want, res["path_train"] = expect(True)
        res["launches_train"] = _expect_launches(f"F4 ({tag}) gradients",
                                                 want)
        g_cpu, s_cpu = cpu.compute_gradient_and_score(x, y)
        res["grad_rel_err"] = _max_rel_err(g_gpu, g_cpu)
        l_gpu, l_cpu = gpu.fit(x, y).get_score(), cpu.fit(x, y).get_score()
        res["loss_rel_err"] = max(abs(s_gpu - s_cpu) / abs(s_cpu),
                                  abs(l_gpu - l_cpu) / abs(l_cpu))
        print(f"F4 ({tag}): {layers} x LSTM({H}) {dt}, B={B}, T={F4_T}: "
              f"plans {plans}; output through {res['path_output']} "
              f"{res['launches_output']}, err {res['output_err']:.3g}; "
              f"training through {res['path_train']} "
              f"{res['launches_train']}, gradients {res['grad_rel_err']:.3g}"
              f" of max|grad|, losses {res['loss_rel_err']:.3g} relative "
              f"(tol {tol}) [{card}]", flush=True)
        if not (res["output_err"] <= tol and res["grad_rel_err"] <= tol
                and res["loss_rel_err"] <= tol):
            raise AssertionError(f"F4 ({tag}): the card disagrees with the "
                                 "CPU port")
        if tag == "a" and any(k.startswith("lstm2_fwd")
                              for k in list(res["launches_output"])
                              + list(res["launches_train"])):
            raise AssertionError("F4 (a) launched the wavefront kernel")
        out[tag] = res
    return out


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


def _generate_streams(net, ids, vocab, dense, paged, res, card, tag):
    """8 concurrent greedy /generate streams of 64 tokens (prompts of
    16..64 of the token rows ``ids``) through each (client, engine) pair of
    ``dense`` and ``paged``, with exact launches (K8 or K9 twice per engine
    step), then the full-prefix ``generate_naive`` of each prompt (K5 twice
    per token); where a stream differs from it, the reference's top-2
    margin at that step must be <= TIE_MARGIN. Fills ``res``."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving.decode import generate_naive
    lens = [16, 22, 28, 34, 40, 46, 52, 64]
    prompts = [list(map(int, ids[i, :n])) for i, n in enumerate(lens)]
    new = 64
    gens = {}
    for kind, (client, eng), kernel in (
            ("dense", dense, "flash_decode"),
            ("paged", paged, "flash_decode_paged")):
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
            f"{tag} {kind} /generate", {kernel: 2 * steps})
        res[f"{kind}_steps"] = steps
        res[f"{kind}_tokens_per_s"] = len(prompts) * new / wall
        res[f"{kind}_ms_per_step"] = secs / steps * 1e3
        if kind == "paged":
            res["paged_kv"] = st1["kv"]
            if st1["kv"]["blocks_in_use"] != 0:
                raise AssertionError(f"paged engine leaked blocks: "
                                     f"{st1['kv']}")
        print(f"{tag}: {kind} /generate, {len(prompts)} concurrent "
              f"greedy streams x {new} tokens (prompts {lens[0]}.."
              f"{lens[-1]}): {steps} steps, "
              f"{res[f'{kind}_ms_per_step']:.3f} ms/step, "
              f"{res[f'{kind}_tokens_per_s']:.1f} tokens/s; launches "
              f"{res[f'launches_{kind}']} [{card}]", flush=True)

    # the full-prefix reference, through K5 at every length
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    naive = [generate_naive(net, p, new, dense[1].max_len)["tokens"]
             for p in prompts]
    res["naive_seconds"] = time.perf_counter() - t0
    res["launches_naive"] = _expect_launches(
        f"{tag} generate_naive", {"flash_attn_fwd": 2 * len(prompts) * new})
    ties = []
    for p, want, d, pg in zip(prompts, naive, gens["dense"], gens["paged"]):
        for kind, got in (("dense", d), ("paged", pg)):
            tie = _first_tie(net, p, got, want)
            if tie is not None:
                ties.append({"engine": kind, "prompt_len": len(p),
                             "step": tie[0], "top2_margin": tie[1]})
    res["token_mismatches"] = ties
    same = sum(d == w for d, w in zip(gens["dense"], naive))
    print(f"{tag}: greedy tokens, dense == full-prefix for {same}/"
          f"{len(prompts)} streams, paged == full-prefix for "
          f"{sum(g == w for g, w in zip(gens['paged'], naive))}/"
          f"{len(prompts)}; mismatches at near-ties {ties}; "
          f"full-prefix path {res['naive_seconds']:.2f} s [{card}]; "
          f"sample {''.join(vocab[t] for t in gens['dense'][0])!r}",
          flush=True)
    if any(t["top2_margin"] > TIE_MARGIN for t in ties):
        raise AssertionError(f"greedy tokens differ beyond a near-tie: "
                             f"{ties}")


DECODE_PROFILE_STEPS = 10


def _decode_profile(eng, entry, card, tag):
    """Ten steps of the engine ``eng`` under ``profile_steps``: 8 streams of
    one prompt token and ten new tokens each, submitted together, so every
    step decodes all 8 slots (positions 0..9). Ms per step, device busy ms
    and idle share, and the share of device time in the decode kernel
    (``entry``, K8 or K9, exactly 2 launches a step; both are instances of
    ``flash_decode_kernel``). Returns the profile."""
    from deeplearning4j_tpu_torch import ops
    prompts = [[i] for i in range(eng.slots)]
    kernel = "flash_decode_kernel"

    def run():
        st0 = eng.stats()["steps"]
        futs = [eng.submit(p, max_new_tokens=DECODE_PROFILE_STEPS)
                for p in prompts]
        for f in futs:
            f.result(timeout=120)
        return eng.stats()["steps"] - st0
    ops.reset_launch_counts()
    st0 = eng.stats()["steps"]
    prof = profile_steps(run, DECODE_PROFILE_STEPS, (kernel,))
    _expect_launches(f"{tag} decode profile",
                     {entry: 2 * (eng.stats()["steps"] - st0)})
    busy = prof["device_busy_ms_per_step"]
    prof["kernel_share_of_busy"] = (None if busy is None else
                                    prof["tagged_ms_per_step"][kernel] / busy)
    print(f"{tag}: {entry} engine, " + fmt_profile(
        prof, (kernel,), units="engine steps") + (
        "" if busy is None else f"; {entry} {prof['kernel_share_of_busy']:.1%}"
        " of device busy") + f" [{card}]", flush=True)
    return prof


def transformer_phase(card):
    """Serve TinyTransformer at its full default width on the card from the
    configuration's seed; every check raises on failure. Returns the
    measured numbers."""
    import numpy as np
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.serving import (DecodeEngine,
                                                  InferenceClient,
                                                  InferenceServer)
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
        _generate_streams(net, xte.argmax(-1), vocab, (cli, dense),
                          (pcli, paged), res, card, "tiny")
        # where a decode step's time goes, on each engine
        res["profile_dense"] = _decode_profile(dense, "flash_decode", card,
                                               "tiny")
        res["profile_paged"] = _decode_profile(paged, "flash_decode_paged",
                                               card, "tiny")
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
    # where a recipe step's time goes: ten more steps, as fit_scan runs them
    tags = ("lstm_bwd", "lstm2_fwd")
    prof = res["recipe_profile"] = profile_steps(
        lambda: net.fit_scan(xs[:10], ys[:10]), 10, tags)
    print("train (b): " + fmt_profile(prof, tags) + f" [{card}]", flush=True)

    # (c) truncated BPTT in chunks of 16 through the single-layer kernels
    tnet = tbptt_net(zoo)
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
    prof = res["tbptt_profile"] = profile_tbptt(tnet, xtr, ytr, B)
    print("train (c): " + fmt_profile(prof, TBPTT_TAGS, "batch",
                                      "tBPTT batches") + f" [{card}]",
          flush=True)
    return res


TBPTT_TAGS = ("lstm_fwd", "lstm_bwd")


def tbptt_net(zoo):
    """``zoo``'s network on the card, trained by truncated BPTT in chunks
    of 16 (each chunk through K2 forward and K3 backward, per layer)."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    conf = zoo.conf()
    conf.backprop_type = "tbptt"
    conf.tbptt_fwd_length = conf.tbptt_back_length = 16
    return MultiLayerNetwork(conf, device="cuda").init()


def profile_tbptt(net, x, y, B, batches=10):
    """Where a tBPTT batch's time goes: ``batches`` batches of ``B`` rows
    of x, y fitted by ``net`` under ``profile_steps``, tags TBPTT_TAGS."""
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    part = DataSet(x[:batches * B], y[:batches * B])
    return profile_steps(
        lambda: net.fit(ListDataSetIterator(part, B, drop_last=True)),
        batches, TBPTT_TAGS)


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


def _train_parity(zoo, T, B, stride, card, tag):
    """Step-1 loss and gradients, three ``fit`` steps and a ``score`` of
    ``zoo``'s graph on the card against the CPU port from the same initial
    parameters, on corpus windows of length T (batch B): gradients within
    GRAD_TOL of max|grad|, losses rtol LOSS_RTOL, parameters within GRAD_TOL
    (``bk`` within 2 x lr x steps, see tiny_train_phase), and exactly two
    launches each of K5, K6 and K7 per step, two of K5 per score."""
    import torch
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    lr = zoo.conf().global_conf.updater.learning_rate
    one_step = {"flash_attn_fwd": 2, "flash_attn_dq": 2, "flash_attn_dkv": 2}
    (xtr, ytr), _, _ = corpus_windows(T=T, stride=stride)
    cpu = zoo.init(device="cpu")
    gpu = ComputationGraph(cpu.conf, device="cuda").set_params(cpu.params)
    x0, y0 = xtr[:B], ytr[:B]
    g_cpu, s_cpu = cpu.compute_gradient_and_score(x0, y0)
    ops.reset_launch_counts()
    g_gpu, s_gpu = gpu.compute_gradient_and_score(x0, y0)
    torch.cuda.synchronize()
    _expect_launches(f"{tag} train (a) T={T} gradients", one_step)
    grad_err = _max_rel_err([g_gpu[n] for n in g_cpu], list(g_cpu.values()))
    losses_cpu, losses_card = [], []
    ops.reset_launch_counts()
    for k in range(3):
        batch = (xtr[k * B:(k + 1) * B], ytr[k * B:(k + 1) * B])
        losses_cpu.append(cpu.fit(*batch).get_score())
        losses_card.append(gpu.fit(*batch).get_score())
    _expect_launches(f"{tag} train (a) T={T} fit",
                     {k: 3 * n for k, n in one_step.items()})
    ops.reset_launch_counts()
    scores = (gpu.score(inputs=x0, labels=y0),
              cpu.score(inputs=x0, labels=y0))
    _expect_launches(f"{tag} train (a) T={T} score", {"flash_attn_fwd": 2})
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(losses_card + [s_gpu, scores[0]],
                       losses_cpu + [s_cpu, scores[1]]))
    p_err, bk_err = _param_diffs(gpu.params, cpu.params)
    print(f"{tag} train (a) T={T} B={B}: step-1 gradients on the card vs "
          f"the CPU port: max abs err {grad_err:.3g} of max|grad| (tol "
          f"{GRAD_TOL}); 3 fit losses card {losses_card} vs CPU "
          f"{losses_cpu}, score, max rel err {loss_rel:.3g} (tol "
          f"{LOSS_RTOL}); parameters after: max abs err {p_err:.3g} "
          f"(tol {GRAD_TOL}), bk {bk_err:.3g} (tol {6 * lr:g}); launches "
          f"exactly 2 K5 + 2 K6 + 2 K7 per step, 2 K5 per score "
          f"[{card}]", flush=True)
    if not (grad_err <= GRAD_TOL and loss_rel <= LOSS_RTOL
            and p_err <= GRAD_TOL and bk_err <= 2 * lr * 3):
        raise AssertionError(f"{tag} training at T={T} on the card "
                             "disagrees with the CPU port")
    return {"batch": B, "grad_rel_err": grad_err, "loss_rel_err": loss_rel,
            "losses_card": losses_card, "losses_cpu": losses_cpu,
            "param_max_abs_err": p_err, "bk_max_abs_err": bk_err}


def wide_head_phase(card):
    """TinyTransformer(d_model=512, n_heads=2) from the zoo's seed: head dim
    256, past the 128 columns a block of K5-K9 holds, so every attention
    kernel runs its column-chunk split (two chunks). (a) /predict of the
    held-out windows against the CPU port (probabilities within PROB_TOL;
    K5 twice per bucketed forward); (b) 8 greedy /generate streams on a
    dense and a paged engine against ``generate_naive`` under the near-tie
    rule; (c) three ``fit`` steps at T=64 against the CPU port at the bars
    of tiny train (a). Every check raises on failure; returns the numbers."""
    import numpy as np
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.serving import (DecodeEngine,
                                                  InferenceClient,
                                                  InferenceServer)
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

    _, (xte, _), vocab = corpus_windows(T=64)
    zoo = TinyTransformer(vocab_size=len(vocab), d_model=WIDE_D_MODEL,
                          n_heads=WIDE_HEADS)
    net = zoo.init(device="cuda")
    cfg = net.conf.nodes["b0_attn"].layer
    res = {"card": card, "d_model": cfg.n_out, "heads": cfg.n_heads,
           "head_dim": cfg.head_dim}
    cpu = ComputationGraph(net.conf, device="cpu").set_params(net.params)
    dense = DecodeEngine(net, slots=8, max_len=512)
    paged = DecodeEngine(net, slots=8, max_len=512, kv="paged",
                         kv_block_size=KV_BLOCK)
    srv = InferenceServer(net, port=0, decode_engine=dense).start()
    psrv = InferenceServer(net, port=0, decode_engine=paged).start()
    cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
    pcli = InferenceClient(f"http://127.0.0.1:{psrv.port}")
    try:
        ops.reset_launch_counts()
        c0 = srv.engine.stats()["device_calls"]
        out = cli.predict(xte)
        n_calls = srv.engine.stats()["device_calls"] - c0
        res["launches_predict"] = _expect_launches(
            "wide /predict", {"flash_attn_fwd": 2 * n_calls})
        if out.shape != xte.shape or not np.isfinite(out).all():
            raise AssertionError(f"/predict returned {out.shape}")
        err = float(np.abs(out - cpu.output(xte, bucketed=False).numpy())
                    .max())
        res["predict_vs_cpu_max_abs_err"] = err
        print(f"wide: Dh={cfg.head_dim}: /predict {len(xte)} held-out "
              f"windows x 64: max abs err vs the CPU port {err:.3g} (tol "
              f"{PROB_TOL}); launches {res['launches_predict']} [{card}]",
              flush=True)
        if err > PROB_TOL:
            raise AssertionError("wide /predict on the card disagrees with "
                                 "the CPU port")
        _generate_streams(net, xte.argmax(-1), vocab, (cli, dense),
                          (pcli, paged), res, card, "wide")
    finally:
        srv.stop()
        psrv.stop()
    res["parity_T64"] = _train_parity(zoo, 64, TINY_B, 8, card, "wide")
    return res


def tiny_train_phase(card):
    """Train TinyTransformer at its full default width on the card; every
    check raises on failure. Returns the measured numbers.

    ``bk`` has no gradient: a constant added to every key shifts each
    query's scores by one number, which the softmax ignores, so what K7
    returns for it is rounding noise that Adam scales up to steps of about
    lr. It is held to 2 x lr x steps, every other parameter to 1e-4."""
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

    zoo = TinyTransformer(vocab_size=51)
    res = {"card": card}
    one_step = {"flash_attn_fwd": 2, "flash_attn_dq": 2, "flash_attn_dkv": 2}

    # (a) the card against the CPU port from the same initial parameters
    for T, B, stride in ((64, 32, 8), (512, 8, 64)):
        res[f"parity_T{T}"] = _train_parity(zoo, T, B, stride, card, "tiny")

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
    prof = profile_steps(lambda: [net.fit(x0, y0) for _ in range(10)], 10,
                         ("flash_attn",))
    res["profile"] = prof
    print("tiny train (d): " + fmt_profile(prof, ("flash_attn",))
          + f" [{card}]", flush=True)
    return res


CAPTURE_TOL = 1e-5         # captured against eager, of max|p|
CAPTURED_STEPS = 10         # steps of each path from one init


def _tensors(net):
    """A container's parameters and floating updater state, in order."""
    def items(tree):
        return tree.values() if isinstance(tree, dict) else tree
    return [v for tree in (net.params, net.opt_state) for d in items(tree)
            for v in d.values() if v.is_floating_point()]


def _three_nets(make):
    """From one init: the per-layer loop (fused update off, eager), the
    fused eager step and the captured step (the default on the card)."""
    from deeplearning4j_tpu_torch.nn import fused_update as fu
    fu.set_fused_update(False)
    try:
        loop = make()
    finally:
        fu.set_fused_update(None)
    eager, captured = make(), make()
    eager._capture_steps = False
    return loop, eager, captured


def captured_path(name, make, step, profile, tags, unit, card):
    """One training path three ways from one init (``_three_nets``),
    CAPTURED_STEPS steps each (``step(net, k)`` does step k): the fused eager step against the loop bit
    for bit, the captured against the eager within CAPTURE_TOL of max|p|
    (and whether bit for bit), every step's launches under replay equal to
    the eager step's; then ``profile(net)`` of the eager and the captured
    net under ``profile_steps``. Raises on failure; returns the numbers."""
    import torch
    from deeplearning4j_tpu_torch import ops
    nets = dict(zip(("loop", "eager", "captured"), _three_nets(make)))
    counts = {}
    for kind, net in nets.items():
        counts[kind] = []
        for k in range(CAPTURED_STEPS):
            ops.reset_launch_counts()
            step(net, k)
            torch.cuda.synchronize()
            counts[kind].append(ops.launch_counts())
    units = "batches" if unit == "batch" else f"{unit}s"
    loop, eager, cap = (_tensors(nets[k]) for k in nets)
    fused_bitwise = all(torch.equal(a, b) for a, b in zip(eager, loop))
    scale = max(t.abs().max().item() for t in eager)
    cap_err = max((a - b).abs().max().item()
                  for a, b in zip(cap, eager)) / scale
    res = {"fused_vs_loop_bitwise": fused_bitwise,
           "captured_vs_eager_rel_err": cap_err,
           "captured_vs_eager_bitwise": cap_err == 0.0,
           "launches_per_step": counts["eager"][0],
           "captures": nets["captured"]._capture_count,
           "losses": {k: n.get_score() for k, n in nets.items()}}
    print(f"captured train: {name}: {CAPTURED_STEPS} {units} from one init: "
          f"fused eager vs the per-layer loop bitwise {fused_bitwise}; "
          f"captured vs eager max abs err {cap_err:.3g} of max|p| (tol "
          f"{CAPTURE_TOL}), bitwise {cap_err == 0.0}; launches per {unit} "
          f"{counts['eager'][0]} in every {unit}, eager and replayed; "
          f"{res['captures']} graphs captured [{card}]", flush=True)
    if not fused_bitwise:
        raise AssertionError(f"{name}: the fused update differs from the "
                             "per-layer loop")
    if not cap_err <= CAPTURE_TOL:
        raise AssertionError(f"{name}: the captured step differs from the "
                             "eager step")
    want = counts["eager"][0]
    if not want or any(c != want for kind in ("eager", "captured")
                       for c in counts[kind]):
        raise AssertionError(f"{name}: launches per {unit} {counts}")
    for kind in ("eager", "captured"):
        prof = res[f"profile_{kind}"] = profile(nets[kind])
        print(f"captured train: {name} {kind}: "
              + fmt_profile(prof, tags, unit, units) + f" [{card}]",
              flush=True)
    return res


def captured_train_phase(card):
    """Training captured in CUDA graphs against the eager step, per path:
    the LSTM recipe's steps (B=32, T=64, ``fit_scan``), its tBPTT batches
    (chunks of 16, ``fit`` on a DataSet) and the TinyTransformer recipe's
    steps (``captured_path``); then the bf16 train-precision policy, three
    ``fit`` steps of the LSTM model and of TinyTransformer on the card
    against the CPU port (losses within BF16_TOL, parameters float32)."""
    import torch
    from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork,
                                          ops)
    from deeplearning4j_tpu_torch import exec as ex
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM, TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows

    (xtr, ytr), _, vocab = corpus_windows(stride=8)
    B, T = TINY_B, TINY_T
    steps = len(xtr) // B
    xs = torch.tensor(xtr[:steps * B].reshape(steps, B, T, -1)).cuda()
    ys = torch.tensor(ytr[:steps * B].reshape(steps, B, T, -1)).cuda()
    zoo = TextGenerationLSTM(total_unique_characters=len(vocab))
    tiny = TinyTransformer(vocab_size=len(vocab))
    n = CAPTURED_STEPS

    def scan_step(net, k):
        net.fit_scan(xs[k:k + 1], ys[k:k + 1])

    def scan_profile(tags):
        return lambda net: profile_steps(
            lambda: net.fit_scan(xs[n:2 * n], ys[n:2 * n]), n, tags)

    def tbptt_step(net, k):
        net.fit(DataSet(xtr[k * B:(k + 1) * B], ytr[k * B:(k + 1) * B]))

    res = {"card": card}
    tags = ("lstm_bwd", "lstm2_fwd")
    res["lstm"] = captured_path("LSTM recipe", lambda: zoo.init(
        device="cuda"), scan_step, scan_profile(tags), tags, "step", card)
    res["tbptt"] = captured_path(
        "tBPTT(16)", lambda: tbptt_net(zoo), tbptt_step,
        lambda net: profile_tbptt(net, xtr[n * B:], ytr[n * B:], B),
        TBPTT_TAGS, "batch", card)
    tags = ("flash_attn",)
    res["tiny"] = captured_path("TinyTransformer recipe", lambda: tiny.init(
        device="cuda"), scan_step, scan_profile(tags), tags, "step", card)

    # the bf16 train-precision policy against the CPU port
    ex.set_executor(ex.Executor(train_precision="bf16"))
    try:
        for name, model, cls in (("lstm", zoo, MultiLayerNetwork),
                                 ("tiny", tiny, ComputationGraph)):
            cpu = model.init(device="cpu")
            gpu = cls(cpu.conf, device="cuda").set_params(cpu.params)
            losses = {"card": [], "cpu": []}
            ops.reset_launch_counts()
            for k in range(3):
                batch = (xtr[k * B:(k + 1) * B], ytr[k * B:(k + 1) * B])
                losses["cpu"].append(cpu.fit(*batch).get_score())
                losses["card"].append(gpu.fit(*batch).get_score())
            ops_counts = ops.launch_counts()
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(losses["card"], losses["cpu"]))
            f32 = all(t.dtype == torch.float32 for t in _tensors(gpu))
            res[f"bf16_{name}"] = {"losses": losses, "loss_rel_err": rel,
                                   "float32_storage": f32,
                                   "launches": ops_counts}
            print(f"captured train: bf16 policy, {name}: 3 fit steps on the "
                  f"card {losses['card']} vs the CPU port {losses['cpu']}: "
                  f"max rel err {rel:.3g} (tol {BF16_TOL}); parameters and "
                  f"updater state float32 {f32}; launches {ops_counts} "
                  f"[{card}]", flush=True)
            if not (rel <= BF16_TOL and f32):
                raise AssertionError(f"bf16 training of {name} on the card "
                                     "disagrees with the CPU port")
    finally:
        ex.set_executor(None)
    return res


# ---- phase 9: regularised and masked training ------------------------------
REG_PATHS = ("S1", "S2", "S3", "S4", "S5", "S6", "S7")
REG_STEPS, REG_FIT_STEPS = 10, 3
# the kernels of one train step (b) and of one bucketed forward (d) per path
REG_TRAIN_LAUNCHES = {
    "S1": {"lstm2_fwd_train": 1, "lstm_bwd": 2},
    "S2": {"lstm_fwd_train": 2, "lstm_bwd": 2},
    "S3": {"lstm_fwd_train": 2, "lstm_bwd": 2},
    "S4": {"lstm_fwd_train": 3, "lstm_bwd": 3},
    "S5": {"flash_attn_fwd": 2, "flash_attn_dq": 2, "flash_attn_dkv": 2},
    "S6": {}, "S7": {}}
REG_INFER_LAUNCHES = {"S1": {"lstm2_fwd": 1}, "S2": {"lstm_fwd": 2},
                      "S3": {"lstm_fwd": 2}, "S4": {"lstm_fwd": 3},
                      "S5": {"flash_attn_fwd": 2}, "S6": {}, "S7": {}}
REG_TAGS = {"S5": ("flash_attn",), "S6": (), "S7": ()}
MASK_SEED, MASK_MIN = 123, 16   # S6: window lengths drawn from 16..T
STATS_N, KEEP_TOL, MOMENT_TOL = 1_000_000, 0.005, 1e-2


def reg_conf(name, vocab, width=256, d_model=128):
    """Path ``name``'s configuration (the port's), at ``width``: S1-S3 the
    TextGenerationLSTM (2 x LSTM, RnnOutputLayer, the zoo's Adam and
    clipping) with dropout 0.5 on layer 1, a global dropout 0.2, a global
    DropConnect(0.8); S4 Bidirectional(LSTM) concat -> LastTimeStep(LSTM)
    -> OutputLayer; S5 TinyTransformer with dropout 0.1 on every layer; S6
    the plain TextGenerationLSTM (its batches masked); S7
    GravesBidirectionalLSTM -> GravesLSTM -> SimpleRnn -> RnnOutputLayer."""
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (
        LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM,
        LastTimeStep, OutputLayer, RnnOutputLayer, SimpleRnn)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    if name == "S5":
        conf = TinyTransformer(vocab_size=vocab, d_model=d_model).conf()
        for node in conf.nodes.values():
            if node.layer is not None:
                node.layer.dropout = 0.1
        return conf
    b = (NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3))
         .weight_init("xavier")
         .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0))
    if name == "S2":
        b = b.dropout(0.2)
    elif name == "S3":
        b = b.weight_noise(DropConnect(weight_retain_prob=0.8))
    lb = b.list()
    out = RnnOutputLayer(n_out=vocab, activation="softmax", loss="mcxent")
    if name == "S4":
        lb.layer(Bidirectional(fwd=LSTM(n_out=width, activation="tanh"),
                               mode="concat"))
        lb.layer(LastTimeStep(fwd=LSTM(n_out=width, activation="tanh")))
        out = OutputLayer(n_out=vocab, activation="softmax", loss="mcxent")
    elif name == "S7":
        lb.layer(GravesBidirectionalLSTM(n_out=width, activation="tanh"))
        lb.layer(GravesLSTM(n_out=width, activation="tanh"))
        lb.layer(SimpleRnn(n_out=width, activation="tanh"))
    else:
        lb.layer(LSTM(n_out=width, activation="tanh",
                      dropout=0.5 if name == "S1" else None))
        lb.layer(LSTM(n_out=width, activation="tanh"))
    return lb.layer(out).set_input_type(InputType.recurrent(vocab)).build()


def reg_net(name, vocab, device, **kw):
    """Path ``name``'s network on ``device``, initialised from the
    configuration's seed (the same weights on every device)."""
    from deeplearning4j_tpu_torch import ComputationGraph, MultiLayerNetwork
    conf = reg_conf(name, vocab, **kw)
    cls = (ComputationGraph if hasattr(conf, "network_inputs")
           else MultiLayerNetwork)
    return cls(conf, device=device).init()


def reg_batches(name, x, y, B, seed=MASK_SEED):
    """Batches of B windows of ``x`` / ``y`` for path ``name`` as DataSets:
    S4's label is the character after the window; S6's windows have
    lengths drawn from MASK_MIN..T with ``seed``, feature and label masks
    set."""
    from deeplearning4j_tpu_torch.data import DataSet
    n, T = len(x) // B, x.shape[1]
    lengths = np.random.RandomState(seed).randint(MASK_MIN, T + 1, (n, B))
    out = []
    for k in range(n):
        xb, yb = x[k * B:(k + 1) * B], y[k * B:(k + 1) * B]
        if name == "S4":
            yb = yb[:, -1]
        m = None
        if name == "S6":
            m = (np.arange(T)[None, :] < lengths[k][:, None]).astype(
                np.float32)
        out.append(DataSet(xb, yb, m, m))
    return out


@contextmanager
def seam(mode, draws):
    """The port's draw seam recording every draw (``mode`` "record": the
    card's, copied to the host) or handing the recorded draws out again in
    order ("replay": into the CPU port)."""
    from deeplearning4j_tpu_torch.nn import dropout as D
    real = (D.uniform, D.normal)

    def wrap(fn):
        def draw(shape, dtype, device, gen):
            if mode == "record":
                t = fn(shape, dtype, device, gen)
                draws.append(t.detach().cpu())
                return t
            t = draws.pop(0)
            if tuple(t.shape) != tuple(shape):
                raise AssertionError(f"draw order: {t.shape} for {shape}")
            return t.to(device=device, dtype=dtype)
        return draw
    D.uniform, D.normal = wrap(real[0]), wrap(real[1])
    try:
        yield
    finally:
        D.uniform, D.normal = real


def _loss_and_grads(net, ds):
    """Step-1 loss and gradients of a train step at iteration 0 (the
    generator seeded as ``fit`` seeds it)."""
    from deeplearning4j_tpu_torch.exec.executor import seed_generator
    seed_generator(net._gen, net.conf.global_conf.seed, 0)
    if hasattr(net.conf, "network_inputs"):
        loss, grads, _ = net._gradients(*net._batch(net._as_multi(ds)),
                                        net._gen)
        return loss, grads
    m = None if ds.features_mask is None else net._as_input(ds.features_mask)
    loss, grads, _ = net._gradients(
        net._as_input(ds.features), net._as_input(ds.labels),
        None if ds.labels_mask is None else net._as_input(ds.labels_mask),
        None, m, net._gen)
    return loss, grads


def _grad_rel_err(got, want):
    """Largest gradient difference over the largest gradient."""
    def items(t):
        return t.items() if isinstance(t, dict) else enumerate(t)
    pairs = [(g[k].float().cpu(), w[k].float().cpu())
             for (_, g), (_, w) in zip(items(got), items(want)) for k in w]
    return (max((a - b).abs().max().item() for a, b in pairs)
            / max(b.abs().max().item() for _, b in pairs))


def graph_pool_bytes(graph):
    """Bytes the caching allocator holds in ``graph``'s private memory
    pool, from its segment snapshot; None where the snapshot does not
    name each segment's pool (not measured)."""
    import torch
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == pool)


def reg_statistics(device):
    """The generator's statistics bars of tests/test_torch_dropout.py on
    ``device``: Dropout(0.5)'s keep share, GaussianDropout's and
    GaussianNoise's moments, AlphaDropout on a standard normal."""
    import torch
    from deeplearning4j_tpu_torch.exec.executor import seed_generator
    from deeplearning4j_tpu_torch.nn import dropout as D
    gen = torch.Generator(device=device)
    seed_generator(gen, MASK_SEED, 0)
    ones = torch.ones(STATS_N, device=device)
    y = D.Dropout(p=0.5).apply(ones, gen)
    mult = D.GaussianDropout(rate=0.3).apply(ones, gen)
    noise = D.GaussianNoise(stddev=0.5).apply(torch.zeros_like(ones), gen)
    z = torch.randn(STATS_N, device=device, generator=gen)
    alpha = D.AlphaDropout(p=0.1).apply(z, gen)
    got = {"keep_share": (y != 0).float().mean().item(),
           "gaussian_dropout_mean": mult.mean().item(),
           "gaussian_dropout_var": mult.var().item(),
           "gaussian_noise_mean": noise.mean().item(),
           "gaussian_noise_var": noise.var().item(),
           "alpha_mean": alpha.mean().item(),
           "alpha_var": alpha.var().item()}
    want = {"keep_share": (0.5, KEEP_TOL),
            "gaussian_dropout_mean": (1.0, MOMENT_TOL),
            "gaussian_dropout_var": (0.3 / 0.7, MOMENT_TOL),
            "gaussian_noise_mean": (0.0, MOMENT_TOL),
            "gaussian_noise_var": (0.25, MOMENT_TOL),
            "alpha_mean": (0.0, MOMENT_TOL), "alpha_var": (1.0, MOMENT_TOL)}
    bad = {k: v for k, v in got.items()
           if abs(v - want[k][0]) > want[k][1]}
    return got, bad


def reg_path(name, data, vocab, card):
    """Path ``name`` at full width (B=32, T=64): (a) the card's eager step
    against the CPU port, the card's draws replayed into it: step-1 loss
    and gradients, three ``fit`` steps; (b) ten steps eager and captured
    from one init, bit for bit, with the launches of REG_TRAIN_LAUNCHES in
    every step, and the capture's seconds and pool bytes; (c) ten more
    captured steps under ``torch.profiler``; (d) ``output`` of the
    held-out windows against the CPU port with REG_INFER_LAUNCHES (S4
    also ``evaluate``). Raises on any failed bar; returns the numbers."""
    import torch
    from deeplearning4j_tpu_torch import ops
    (xtr, ytr), (xte, yte) = data
    B = TINY_B
    batches = reg_batches(name, xtr, ytr, B)
    res = {"path": name}

    # (a) the card against the CPU port, the same draws
    gpu, cpu = reg_net(name, vocab, "cuda"), reg_net(name, vocab, "cpu")
    gpu._capture_steps = False
    draws = []
    with seam("record", draws):
        lg, gg = _loss_and_grads(gpu, batches[0])
    n_draws = len(draws)
    with seam("replay", draws):
        lc, gc = _loss_and_grads(cpu, batches[0])
    grad_err = _grad_rel_err(gg, gc)
    losses = {"card": [], "cpu": []}
    for ds in batches[:REG_FIT_STEPS]:
        with seam("record", draws):
            losses["card"].append(gpu.fit(ds).get_score())
        with seam("replay", draws):
            losses["cpu"].append(cpu.fit(ds).get_score())
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip([float(lg)] + losses["card"],
                       [float(lc)] + losses["cpu"]))
    res["a"] = {"draws_per_step": n_draws, "grad_rel_err": grad_err,
                "loss_rel_err": loss_err, "losses": losses}
    print(f"regularised {name} (a): card vs CPU port, {n_draws} draws a "
          f"step replayed: step-1 gradients max err {grad_err:.3g} of "
          f"max|grad| (tol {GRAD_TOL}), losses (step 1 and 3 fit steps) "
          f"max rel err {loss_err:.3g} (tol {LOSS_RTOL}) [{card}]",
          flush=True)
    if not (grad_err <= GRAD_TOL and loss_err <= LOSS_RTOL):
        raise AssertionError(f"{name}: the card disagrees with the CPU port")

    # (d) inference from the card's parameters, on both
    inf = {}
    ref = reg_net(name, vocab, "cpu").set_params(
        {n: {k: v.cpu() for k, v in p.items()} for n, p in gpu.params.items()}
        if isinstance(gpu.params, dict)
        else [{k: v.cpu() for k, v in p.items()} for p in gpu.params])
    held = reg_batches(name, xte, yte, len(xte), seed=MASK_SEED + 1)[0]
    kw = {} if held.features_mask is None else {"mask": held.features_mask}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = gpu.output(held.features, **kw)
    torch.cuda.synchronize()
    inf["launches"] = ops.launch_counts()
    want = ref.output(held.features, **kw)
    inf["max_abs_err"] = (out.cpu() - want).abs().max().item()
    if name == "S4":
        ops.reset_launch_counts()
        ev = gpu.evaluate(held)
        inf["evaluate_launches"] = ops.launch_counts()
        inf["accuracy"] = ev.accuracy()
        top1 = float((out.argmax(-1).cpu().numpy()
                      == held.labels.argmax(-1)).mean())
        if abs(inf["accuracy"] - top1) > 1e-9 or \
                inf["evaluate_launches"] != REG_INFER_LAUNCHES[name]:
            raise AssertionError(f"{name}: evaluate {inf}")
    res["d"] = inf
    print(f"regularised {name} (d): output of {len(xte)} held-out windows "
          f"vs the CPU port max abs err {inf['max_abs_err']:.3g} (tol "
          f"{PROB_TOL}); launches {inf['launches']}"
          + (f"; evaluate accuracy {inf['accuracy']:.4f}, launches "
             f"{inf['evaluate_launches']}" if name == "S4" else "")
          + f" [{card}]", flush=True)
    if not (inf["max_abs_err"] <= PROB_TOL
            and inf["launches"] == REG_INFER_LAUNCHES[name]):
        raise AssertionError(f"{name}: inference {inf}")
    del gpu, cpu, ref

    # (b) eager against captured, from one init
    eager, cap = reg_net(name, vocab, "cuda"), reg_net(name, vocab, "cuda")
    eager._capture_steps = False
    counts = {"eager": [], "captured": []}
    for kind, net in (("eager", eager), ("captured", cap)):
        for k, ds in enumerate(batches[:REG_STEPS]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.reset_launch_counts()
            net.fit(ds)
            torch.cuda.synchronize()
            if kind == "captured" and k == 1:        # the capture
                res["capture_seconds"] = time.perf_counter() - t0
                (step,) = net._steps.graphs.values()
                res["capture_pool_bytes"] = graph_pool_bytes(step.graph)
            counts[kind].append(ops.launch_counts())
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(_tensors(eager), _tensors(cap)))
    bitwise = bitwise and eager.get_score() == cap.get_score()
    want = REG_TRAIN_LAUNCHES[name]
    launches_ok = all(c == want for kind in counts for c in counts[kind])
    res["b"] = {"bitwise": bitwise, "launches_per_step": counts["eager"][0],
                "launches_ok": launches_ok, "captures": cap._capture_count}
    print(f"regularised {name} (b): {REG_STEPS} steps eager and captured "
          f"from one init: bitwise {bitwise}; launches per step "
          f"{counts['eager'][0]} (want {want}) in every step, eager and "
          f"replayed: {launches_ok}; {cap._capture_count} graph captured in "
          f"{res['capture_seconds']:.3f} s (with its first replay), its "
          f"private pool {res['capture_pool_bytes']} bytes [{card}]",
          flush=True)
    if not (bitwise and launches_ok and cap._capture_count == 1):
        raise AssertionError(f"{name}: captured vs eager {res['b']}")

    # (c) ten more captured steps under the profiler
    more = batches[REG_STEPS:2 * REG_STEPS]
    tags = REG_TAGS.get(name, ("lstm",))

    def run():
        for ds in more:
            cap.fit(ds)
    res["c"] = profile_steps(run, len(more), tags)
    print(f"regularised {name} (c): " + fmt_profile(res["c"], tags)
          + f" [{card}]", flush=True)
    return res


def regularised_phase(card):
    """Phase 9: S1-S7 (``reg_path``) and the generator's statistics on the
    card (``reg_statistics``)."""
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    train, test, vocab = corpus_windows(stride=8)
    res = {"card": card}
    for name in REG_PATHS:
        t0 = time.perf_counter()
        res[name] = reg_path(name, (train, test), len(vocab), card)
        res[name]["seconds"] = time.perf_counter() - t0
    got, bad = reg_statistics("cuda")
    res["statistics"] = got
    print(f"regularised (e): the card's generator over {STATS_N} draws: "
          + ", ".join(f"{k} {v:.5f}" for k, v in got.items())
          + f" (keep within {KEEP_TOL}, moments within {MOMENT_TOL}) "
          f"[{card}]", flush=True)
    if bad:
        raise AssertionError(f"generator statistics out of bounds: {bad}")
    return res


# ---- phase 10: the fit contract --------------------------------------------
FIT_WIDTH = 77               # TextGenerationLSTM's width in the zoo
FIT_B, FIT_T = 32, 64
FIT_CHUNK, FIT_EVERY, FIT_KEEP, FIT_CRASH = 8, 8, 3, 48
FIT_STEP = {"lstm2_fwd_train": 1, "lstm_bwd": 2}          # F1-F3, F7 plain
FIT_TIMED_EPOCHS = 3
F4_L, F4_BATCHES, F4_TIMED = 16, 4, 10
F5_CHARS, F5_RESTART = 256, 8
F7_STEPS, F7_TIMED = 5, 10
FIT_DIR = ROOT / "build" / "fit_contract"
CKPT_RE = r"^checkpoint_iter(\d{10})_epoch(\d{4})\.zip$"


class FitInterrupted(RuntimeError):
    pass


class CallRecorder:
    """A listener recording every ``iteration_done`` (iteration, epoch)
    and every epoch end; it reads nothing from the card."""

    def __init__(self, stop_after=None):
        self.calls, self.ends = [], []
        self.stop_after = stop_after

    def iteration_done(self, model, iteration, epoch):
        if self.stop_after is not None and epoch == 1 \
                and iteration > self.stop_after:
            raise FitInterrupted(iteration)
        self.calls.append((iteration, epoch))

    def on_epoch_end(self, model):
        self.ends.append((model.iteration, model.epoch))


def _sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def fit_data():
    """The bundled corpus's stride-8 training windows, one-hot over the
    zoo's 77 columns (the corpus fills the first 51), and its held-out
    windows the same way."""
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    (xtr, ytr), (xte, yte), _ = corpus_windows(stride=8)

    def pad(a):
        return np.pad(a, ((0, 0), (0, 0), (0, FIT_WIDTH - a.shape[-1])))
    return pad(xtr), pad(ytr), pad(xte), pad(yte)


def fit_iterator(x, y):
    """F1-F3's stream: 26 batches of 32 an epoch, shuffled from seed 5."""
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    return ListDataSetIterator(DataSet(x, y), FIT_B, shuffle=True, seed=5,
                               drop_last=True)


def fit_f1_run(device, data, directory, prefetch=2, crash=None, resume=False):
    """F1 on ``device``: the zoo's TextGenerationLSTM (width 77) streams 2
    epochs through ``fit`` with chunks of at most 8 steps, the recording,
    score (every 10) and collect-scores listeners, and a checkpoint every 8
    iterations (keep 3) into ``directory``, each save timed; ``crash``:
    the recorder raises past that iteration in epoch 2; ``resume``: a
    fresh network continues from ``directory`` instead of saving. Returns
    (net, recorder, collect, seconds, save ms)."""
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresIterationListener, ScoreIterationListener)
    from deeplearning4j_tpu_torch.resilience import CheckpointListener
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    net = TextGenerationLSTM(
        total_unique_characters=FIT_WIDTH).init(device=device)
    net._CHUNK_MAX_STEPS = FIT_CHUNK
    rec, collect = CallRecorder(crash), CollectScoresIterationListener(1)
    net.set_listeners(rec, ScoreIterationListener(10), collect)
    saves, kw = [], {"prefetch": prefetch}
    if resume:
        kw["resume_from"] = directory
    else:
        ckpt = CheckpointListener(directory, every_n_iterations=FIT_EVERY,
                                  keep_last=FIT_KEEP)
        save = ckpt.manager.save

        def timed_save(model, **kw):
            t0 = time.perf_counter()
            path = save(model, **kw)
            saves.append((time.perf_counter() - t0) * 1e3)
            return path
        ckpt.manager.save = timed_save
        kw["checkpoint"] = ckpt
    _sync(device)
    t0 = time.perf_counter()
    try:
        net.fit(fit_iterator(*data[:2]), epochs=2, **kw)
    except FitInterrupted:
        pass
    _sync(device)
    return net, rec, collect, time.perf_counter() - t0, saves


def _trees_equal(a, b):
    """Every tensor of two per-layer trees (lists or dicts of dicts) equal
    bit for bit."""
    import torch
    ia = a.items() if isinstance(a, dict) else enumerate(a)
    ib = dict(b.items() if isinstance(b, dict) else enumerate(b))
    return all(torch.equal(p[k].cpu(), ib[n][k].cpu())
               for n, p in ia for k in p)


def _tree_diff(a, b):
    ia = a.items() if isinstance(a, dict) else enumerate(a)
    ib = dict(b.items() if isinstance(b, dict) else enumerate(b))
    return max((p[k].float().cpu() - ib[n][k].float().cpu()).abs().max()
               .item() for n, p in ia for k in p)


def _manifest_pick(directory):
    """The checkpoint the JAX package's ``latest_checkpoint`` would pick,
    read from the file names and the manifest JSON alone: the manifest
    entry of the largest (iteration, epoch), whose zip exists and is
    named as both packages name them."""
    import re
    doc = json.loads((directory / "manifest.json").read_text())
    best = max(doc["checkpoints"], key=lambda e: (e["iteration"],
                                                 e["epoch"]))
    m = re.match(CKPT_RE, best["filename"])
    if not (m and (directory / best["filename"]).exists()
            and (int(m.group(1)), int(m.group(2)))
            == (best["iteration"], best["epoch"])):
        raise AssertionError(f"manifest entry {best} names no checkpoint")
    return best, doc


def fit_f1_f3(card, data, res):
    """F1 (card and CPU), F2 (prefetch 0 against 2) and F3 (interrupted and
    resumed), with their launches; returns the F1 networks for timing."""
    import shutil
    from deeplearning4j_tpu_torch import ops, latest_checkpoint
    from deeplearning4j_tpu_torch.data.prefetcher import DevicePrefetcher
    from deeplearning4j_tpu_torch.util.timing import PipelineTimer
    shutil.rmtree(FIT_DIR, ignore_errors=True)
    steps = 2 * (len(data[0]) // FIT_B)
    want = {k: n * steps for k, n in FIT_STEP.items()}
    nets = {}
    for p in (2, 0):
        ops.reset_launch_counts()
        net, rec, collect, secs, saves = fit_f1_run(
            "cuda", data, FIT_DIR / f"f1_p{p}", prefetch=p)
        counts = ops.launch_counts()
        nets[p] = net
        res[f"f1_p{p}"] = {
            "calls": rec.calls, "epoch_ends": rec.ends,
            "scores": collect.scores, "seconds": secs, "save_ms": saves,
            "launches": counts, "captures": net._capture_count,
            "pipeline": net.last_pipeline_stats}
        print(f"fit (F1{'' if p == 2 else ', F2'}): prefetch {p}: {steps} "
              f"steps in {secs:.3f} s (warm-up and capture included), "
              f"{len(rec.calls)} listener calls, {len(saves)} saves "
              f"({', '.join(f'{s:.1f}' for s in saves)} ms), launches "
              f"{counts}, {net._capture_count} capture; pipeline "
              f"{net.last_pipeline_stats} [{card}]", flush=True)
        if counts != want or net._capture_count != 1:
            raise AssertionError(f"F1 prefetch {p}: launches {counts} "
                                 f"(want {want}), {net._capture_count} "
                                 "captures (want 1)")
    # F1 on the CPU port: the same stream, calls, saves and losses
    cpu, crec, ccollect, csecs, csaves = fit_f1_run("cpu", data,
                                                FIT_DIR / "f1_cpu")
    card_scores = res["f1_p2"]["scores"]
    rel = max(abs(a[1] - b[1]) / abs(b[1])
              for a, b in zip(card_scores, ccollect.scores))
    res["f1_cpu"] = {"calls": crec.calls, "scores": ccollect.scores,
                     "saves": len(csaves), "seconds": csecs,
                     "loss_rel_err": rel}
    print(f"fit (F1): card vs CPU port: calls {res['f1_p2']['calls']} "
          f"(CPU {crec.calls}), epoch ends {res['f1_p2']['epoch_ends']}, "
          f"saves {len(res['f1_p2']['save_ms'])} (CPU {len(csaves)}); "
          f"losses at each call max rel err {rel:.3g} (tol {LOSS_RTOL}) "
          f"[{card}]", flush=True)
    if (crec.calls != res["f1_p2"]["calls"]
            or len(csaves) != len(res["f1_p2"]["save_ms"])
            or [i for i, _ in ccollect.scores]
            != [i for i, _ in card_scores] or not rel <= LOSS_RTOL):
        raise AssertionError("F1 on the card disagrees with the CPU port")
    # F2: prefetch changes no bit; the prefetcher keeps items staged
    same = _trees_equal(nets[0].params, nets[2].params) and _trees_equal(
        nets[0].opt_state, nets[2].opt_state)
    pf = DevicePrefetcher(nets[2]._stream_chunks(
        fit_iterator(*data[:2]), PipelineTimer()), depth=2, device="cuda")
    staged = []
    for kind, payload in pf:
        staged.append(pf.buffered)
        if not all(t.is_cuda for t in (payload if kind == "chunk"
                                        else (payload.features,))):
            raise AssertionError("a prefetched item is not on the card")
    res["f2"] = {"bitwise": same, "buffered": staged}
    print(f"fit (F2): prefetch 0 and 2 final parameters and updater state "
          f"bitwise equal: {same}; items staged after each next(): "
          f"{staged} [{card}]", flush=True)
    if not same or min(staged[:-1]) < 1:
        raise AssertionError("F2: prefetch changed the result or staged "
                             "nothing mid-stream")
    # F3: interrupted past FIT_CRASH in epoch 2, resumed by a fresh net
    run_dir = FIT_DIR / "f3"
    ops.reset_launch_counts()
    crashed, crec3, _, _, _ = fit_f1_run("cuda", data, run_dir,
                                         crash=FIT_CRASH)
    c_crash = ops.launch_counts()
    zips = sorted(p.name for p in run_dir.glob("*.zip"))
    best, doc = _manifest_pick(run_dir)
    ours = Path(latest_checkpoint(run_dir)).name
    ops.reset_launch_counts()
    resumed, rrec, _, rsecs, _ = fit_f1_run("cuda", data, run_dir, resume=True)
    c_resume = ops.launch_counts()
    whole = nets[2]
    same = (_trees_equal(resumed.params, whole.params)
            and _trees_equal(resumed.opt_state, whole.opt_state)
            and resumed.iteration == whole.iteration
            and resumed.epoch == whole.epoch)
    res["f3"] = {"stopped_at": crashed.iteration, "zips": zips,
                 "manifest": doc, "picked": best["filename"],
                 "resumed_from": ours, "resume_calls": rrec.calls,
                 "bitwise": same, "launches_crashed": c_crash,
                 "launches_resumed": c_resume, "resume_seconds": rsecs}
    print(f"fit (F3): stopped at iteration {crashed.iteration} (calls "
          f"{crec3.calls}); directory {zips} (keep {FIT_KEEP}), manifest "
          f"save_count {doc['save_count']}, the JAX rule picks "
          f"{best['filename']}, the port resumed from {ours}; resumed calls "
          f"{rrec.calls}; final parameters and updater state bitwise the "
          f"uninterrupted run's: {same}; launches {c_crash} then {c_resume} "
          f"[{card}]", flush=True)
    done = resumed.iteration - int(best["iteration"])
    if not (same and len(zips) == FIT_KEEP and ours == best["filename"]
            and c_resume == {k: n * done for k, n in FIT_STEP.items()}):
        raise AssertionError("F3: the resumed run is not the uninterrupted "
                             "run, or the directory is not as kept")
    shutil.rmtree(FIT_DIR, ignore_errors=True)
    return nets


def fit_timing(card, data, nets, res):
    """ms per step of warm streamed fits of FIT_TIMED_EPOCHS epochs with
    prefetch 0 and 2 (in turns 0, 2, 2, 0; synchronized before and after
    each fit, not between its epochs) against fit_scan over the same
    number of epochs' batches already on the card; the last epoch's
    pipeline stats."""
    import torch
    n = len(data[0]) // FIT_B
    steps = FIT_TIMED_EPOCHS * n
    rows = []
    for p in (0, 2, 2, 0):
        net = nets[p]
        _sync("cuda")
        t0 = time.perf_counter()
        net.fit(fit_iterator(*data[:2]), epochs=FIT_TIMED_EPOCHS, prefetch=p)
        _sync("cuda")
        rows.append({"prefetch": p,
                     "ms_per_step": (time.perf_counter() - t0) / steps * 1e3,
                     "pipeline": net.last_pipeline_stats})
    xs = torch.tensor(data[0][:n * FIT_B].reshape(n, FIT_B, FIT_T, -1),
                      device="cuda")
    ys = torch.tensor(data[1][:n * FIT_B].reshape(n, FIT_B, FIT_T, -1),
                      device="cuda")
    scan = []
    for _ in range(2):
        _sync("cuda")
        t0 = time.perf_counter()
        for _ in range(FIT_TIMED_EPOCHS):
            nets[2].fit_scan(xs, ys)
        _sync("cuda")
        scan.append((time.perf_counter() - t0) / steps * 1e3)
    res["timing"] = {"epochs": FIT_TIMED_EPOCHS, "fits": rows,
                     "fit_scan_staged_ms_per_step": scan}
    for r in rows:
        print(f"fit (timing): a warm fit of {FIT_TIMED_EPOCHS} epochs, "
              f"{steps} steps, prefetch {r['prefetch']}: "
              f"{r['ms_per_step']:.3f} ms/step; last epoch's pipeline "
              f"{r['pipeline']} [{card}]", flush=True)
    print(f"fit (timing): fit_scan over the same {steps} steps' batches "
          f"already on the card: {', '.join(f'{s:.3f}' for s in scan)} "
          f"ms/step [{card}]", flush=True)


def fit_f4_graph(device, tbptt=True):
    """TextGenerationLSTM's layers (the zoo's seed, Adam, clipping; width
    77) as a ComputationGraph in -> LSTM -> LSTM -> RnnOutputLayer,
    truncated BPTT in chunks of 16."""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    g = (NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3))
         .weight_init("xavier")
         .gradient_normalization("ClipElementWiseAbsoluteValue", 10.0)
         .graph_builder().add_inputs("in")
         .set_input_types(InputType.recurrent(FIT_WIDTH))
         .add_layer("lstm1", LSTM(n_out=256, activation="tanh"), "in")
         .add_layer("lstm2", LSTM(n_out=256, activation="tanh"), "lstm1")
         .add_layer("out", RnnOutputLayer(n_out=FIT_WIDTH,
                                          activation="softmax",
                                          loss="mcxent"), "lstm2")
         .set_outputs("out"))
    if tbptt:
        g.backprop_type("tbptt", F4_L, F4_L)
    return ComputationGraph(g.build(), device=device).init()


def _timed_batches(net, x, y, n):
    _sync("cuda")
    t0 = time.perf_counter()
    for k in range(n):
        net.fit(x[k * FIT_B:(k + 1) * FIT_B], y[k * FIT_B:(k + 1) * FIT_B])
    _sync("cuda")
    return (time.perf_counter() - t0) / n * 1e3


def fit_f4(card, data, res):
    """F4: graph truncated BPTT on the card against the CPU port fed the
    same batches, exact launches, and ms per batch against the MLN's
    truncated BPTT at the same shape. Returns the trained graph."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    x, y = data[0], data[1]
    g = fit_f4_graph("cuda")
    cpu = fit_f4_graph("cpu").set_params(g.params)
    chunks = FIT_T // F4_L
    ops.reset_launch_counts()
    losses = []
    for k in range(F4_BATCHES):
        b = slice(k * FIT_B, (k + 1) * FIT_B)
        g.fit(x[b], y[b])
        cpu.fit(x[b], y[b])
        losses.append((g.get_score(), cpu.get_score()))
    counts = ops.launch_counts()
    err = _tree_diff(g.params, cpu.params)
    want = {"lstm_fwd_train": 2 * chunks * F4_BATCHES,
            "lstm_bwd": 2 * chunks * F4_BATCHES}
    res["f4"] = {"losses_card_cpu": losses, "param_max_abs_err": err,
                 "launches": counts, "captures": g._capture_count}
    print(f"fit (F4): graph tBPTT({F4_L}) over T={FIT_T}, B={FIT_B}: "
          f"{F4_BATCHES} batches, losses card/CPU {losses}; parameters max "
          f"abs err {err:.3g} (tol {F32_TOL}); launches {counts} (want "
          f"{want}); {g._capture_count} captures [{card}]", flush=True)
    if counts != want or not err <= F32_TOL or g._capture_count != 2:
        raise AssertionError("F4: graph tBPTT disagrees with the CPU port "
                             "or launched other kernels")
    # ms per batch, warm, against the MLN's truncated BPTT (in turns)
    conf = TextGenerationLSTM(total_unique_characters=FIT_WIDTH).conf()
    conf.backprop_type = "tbptt"
    conf.tbptt_fwd_length = conf.tbptt_back_length = F4_L
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    mln = MultiLayerNetwork(conf, device="cuda").init()
    _timed_batches(mln, x, y, 2)                 # warm-up and capture
    times = {"graph": [], "mln": []}
    for who in ("graph", "mln", "mln", "graph"):
        times[who].append(_timed_batches(g if who == "graph" else mln,
                                         x, y, F4_TIMED))
    res["f4"]["ms_per_batch"] = times
    print(f"fit (F4 timing): ms per tBPTT batch ({chunks} chunks), graph "
          f"{times['graph']}, MultiLayerNetwork {times['mln']} [{card}]",
          flush=True)
    return g


def fit_f5(card, g, data, res):
    """F5: rnn_time_step over F4's trained graph: greedy characters at B=1
    against the full-prefix output, one call at B=15, T=16, and a restart
    after rnn_clear_previous_state."""
    import torch
    from deeplearning4j_tpu_torch import ops
    eye = torch.eye(FIT_WIDTH, device="cuda")
    x_t = torch.from_numpy(data[2][:1, 0]).cuda()
    g.rnn_clear_previous_state()
    ops.reset_launch_counts()
    _sync("cuda")
    t0 = time.perf_counter()
    ins, outs = [], []
    for _ in range(F5_CHARS):
        ins.append(x_t)
        o = g.rnn_time_step(x_t)[:, -1]
        outs.append(o)
        x_t = eye[o.argmax(-1)]
    _sync("cuda")
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = torch.cat(outs)
    ref = g.output(torch.stack(ins, 1), bucketed=False)[0]
    err = (steps - ref).abs().max().item()
    top2 = ref.topk(2, -1).values
    differ = (steps.argmax(-1) != ref.argmax(-1)).nonzero().flatten()
    ties = [int(t) for t in differ
            if (top2[t, 0] - top2[t, 1]).item() <= F32_TOL]
    # K1's shape: 15 held-out windows' first 16 steps in one call
    g.rnn_clear_previous_state()
    xb = torch.from_numpy(data[2][:15, :16]).cuda()
    ops.reset_launch_counts()
    got = g.rnn_time_step(xb)
    counts_b = ops.launch_counts()
    err_b = (got - g.output(xb, bucketed=False)).abs().max().item()
    g.rnn_clear_previous_state()
    again = [g.rnn_time_step(ins[t])[:, -1] for t in range(F5_RESTART)]
    restart = all(torch.equal(a, b) for a, b in zip(again, outs))
    res["f5"] = {"chars": F5_CHARS, "ms_per_char": secs / F5_CHARS * 1e3,
                 "max_abs_err": err, "greedy_differ": differ.tolist(),
                 "ties": ties, "launches": counts, "launches_b15": counts_b,
                 "b15_max_abs_err": err_b, "restart_equal": restart}
    print(f"fit (F5): rnn_time_step, {F5_CHARS} greedy characters at B=1: "
          f"{secs / F5_CHARS * 1e3:.4f} ms/char; each step vs the last step "
          f"of output over the prefix max abs err {err:.3g} (tol "
          f"{F32_TOL}), greedy characters differ at {differ.tolist()} (ties "
          f"within {F32_TOL}: {ties}); launches {counts}; B=15, T=16: max "
          f"abs err {err_b:.3g}, launches {counts_b}; after "
          f"rnn_clear_previous_state the first {F5_RESTART} steps repeat: "
          f"{restart} [{card}]", flush=True)
    if not (err <= F32_TOL and len(ties) == len(differ)
            and counts == {"lstm_fwd": 2 * F5_CHARS}
            and counts_b == {"lstm_fwd": 2} and err_b <= F32_TOL
            and restart):
        raise AssertionError("F5: rnn_time_step disagrees with output")


def fit_f6(card, res):
    """F6: TinyTransformer at its full default width streams 2 epochs
    through fit(iterator, prefetch=2) with a PerformanceListener."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.monitor import get_registry
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresIterationListener, PerformanceListener)
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    (xtr, ytr), _, vocab = corpus_windows(stride=8)
    net = TinyTransformer(vocab_size=len(vocab)).init(device="cuda")
    net._CHUNK_MAX_STEPS = FIT_CHUNK
    collect = CollectScoresIterationListener(1)
    net.set_listeners(PerformanceListener(frequency=FIT_CHUNK), collect)
    steps = 2 * (len(xtr) // FIT_B)
    ops.reset_launch_counts()
    _sync("cuda")
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator(DataSet(xtr, ytr), FIT_B, drop_last=True),
            epochs=2, prefetch=2)
    _sync("cuda")
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    warm = []
    for _ in range(2):          # a warm epoch each, synchronized
        _sync("cuda")
        t1 = time.perf_counter()
        net.fit(ListDataSetIterator(DataSet(xtr, ytr), FIT_B,
                                    drop_last=True), prefetch=2)
        _sync("cuda")
        warm.append((time.perf_counter() - t1) / (steps // 2) * 1e3)
    reg = get_registry()
    sps = reg.get("dl4jtpu_listener_samples_per_sec").value
    bps = reg.get("dl4jtpu_listener_batches_per_sec").value
    want = {k: 2 * steps for k in ("flash_attn_fwd", "flash_attn_dq",
                                   "flash_attn_dkv")}
    res["f6"] = {"steps": steps, "seconds": secs, "launches": counts,
                 "losses": collect.scores[:8], "samples_per_sec": sps,
                 "warm_ms_per_step": warm,
                 "batches_per_sec": bps, "captures": net._capture_count,
                 "pipeline": net.last_pipeline_stats}
    print(f"fit (F6): TinyTransformer, {steps} steps in {secs:.3f} s "
          f"(warm-up and capture included); launches {counts}; losses "
          f"{[(i, round(s, 4)) for i, s in collect.scores[:8]]}; the "
          f"listener's last window {sps:.0f} samples/s, {bps:.1f} batches/s "
          f"(host dispatch: nothing synchronizes); warm epochs "
          f"{', '.join(f'{w:.3f}' for w in warm)} ms/step synchronized; "
          f"pipeline {net.last_pipeline_stats} [{card}]", flush=True)
    if counts != want or net._capture_count != 1:
        raise AssertionError(f"F6 launches {counts}, want {want}")


def fit_f7(card, data, res):
    """F7: F1's network with dropout 0.5 on layer 1, remat and not: the
    step-1 gradient bit for bit, the recompute's launches, and captured
    fit steps to the same bits."""
    import torch
    from deeplearning4j_tpu_torch import MultiLayerNetwork, ops
    from deeplearning4j_tpu_torch.exec.executor import seed_generator
    nets = {}
    for remat in (False, True):
        conf = reg_conf("S1", FIT_WIDTH)
        conf.global_conf.remat = remat
        nets[remat] = MultiLayerNetwork(conf, device="cuda").init()
    x = torch.from_numpy(data[0][:FIT_B]).cuda()
    y = torch.from_numpy(data[1][:FIT_B]).cuda()
    grads, eager = {}, {}
    for remat, net in nets.items():
        seed_generator(net._gen, net.conf.global_conf.seed, 0)
        ops.reset_launch_counts()
        grads[remat] = net._gradients(x, y, gen=net._gen)[1]
        _sync("cuda")
        eager[remat] = ops.launch_counts()
    same_grad = _trees_equal(grads[True], grads[False])
    steps = {}
    for remat, net in nets.items():
        ops.reset_launch_counts()
        _timed_batches(net, data[0], data[1], F7_STEPS)
        steps[remat] = ops.launch_counts()
    same = _trees_equal(nets[True].params, nets[False].params)
    times = {r: _timed_batches(n, data[0], data[1], F7_TIMED)
             for r, n in nets.items()}
    want = {True: {"lstm2_fwd_train": 2 * F7_STEPS,
                   "lstm_bwd": 2 * F7_STEPS},
            False: {"lstm2_fwd_train": F7_STEPS, "lstm_bwd": 2 * F7_STEPS}}
    res["f7"] = {"gradient_bitwise": same_grad, "launches_gradient": {
        str(k): v for k, v in eager.items()}, "launches_fit": {
        str(k): v for k, v in steps.items()}, "params_bitwise": same,
        "ms_per_step": {str(k): v for k, v in times.items()}}
    print(f"fit (F7): dropout 0.5 on layer 1, remat vs not: step-1 gradient "
          f"bitwise {same_grad}, launches {eager[True]} vs {eager[False]}; "
          f"{F7_STEPS} captured fit steps: launches {steps[True]} vs "
          f"{steps[False]}, parameters bitwise {same}; warm ms/step "
          f"{times[True]:.3f} vs {times[False]:.3f} [{card}]", flush=True)
    if not (same_grad and same and steps == want
            and eager[True] == {"lstm2_fwd_train": 2, "lstm_bwd": 2}
            and eager[False] == {"lstm2_fwd_train": 1, "lstm_bwd": 2}
            and all(n._capture_count == 1 for n in nets.values())):
        raise AssertionError("F7: remat changed the gradient or launched "
                             "other kernels")


def fit_contract_phase(card):
    """Phase 10: the fit contract, F1-F7 (``chip_smoke.py`` docstring)."""
    data = fit_data()
    res = {"card": card}
    nets = fit_f1_f3(card, data, res)
    fit_timing(card, data, nets, res)
    g = fit_f4(card, data, res)
    fit_f5(card, g, data, res)
    fit_f6(card, res)
    fit_f7(card, data, res)
    return res


# ------------------------------------------------------------- phase 11
STEM, TAIL_LENS, SERVE_NEW = 48, (8, 12, 16, 20, 24, 28, 32, 40), 64
CHUNK = 32
SPEC_TEMP, SPEC_SEED = 0.9, 123
SCORE_TIE = 1e-4     # top-2 gap of a sampled step's Gumbel scores
PROFILE_TICKS = 10


def _sampled_tie(net, prompt, got, want, temp, seed):
    """Where two sampled streams first differ, the top-2 gap of the
    reference's Gumbel scores (log-probabilities over ``temp`` plus the
    draw's noise) at that step. None when they agree."""
    import torch
    from deeplearning4j_tpu_torch.serving.engine import input_type_of
    from deeplearning4j_tpu_torch.serving.spec.accept import gumbel_noise
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not diff and len(got) == len(want):
        return None
    step = diff[0] if diff else min(len(got), len(want))
    toks = list(prompt) + list(want[:step])
    V = input_type_of(net).size
    eye = torch.eye(V, device=net.device)
    probs = net.output(eye[torch.tensor(toks, device=net.device)][None],
                       bucketed=False)[0, -1]
    scores = (np.log(probs.double().cpu().numpy()) / temp
              + gumbel_noise(seed, len(toks) - 1, V))
    top = np.sort(scores)[::-1][:2]
    return step, float(top[0] - top[1])


def _ties(net, prompts, gots, wants, temp=0.0, seed=0):
    """Near-tie records of every stream that differs from the reference,
    or raise when one differs beyond a near-tie."""
    ties = []
    for p, got, want in zip(prompts, gots, wants):
        tie = (_first_tie(net, p, got, want) if temp == 0 else
               _sampled_tie(net, p, got, want, temp, seed))
        if tie is not None:
            ties.append({"prompt_len": len(p), "step": tie[0],
                         "margin": tie[1]})
    bar = TIE_MARGIN if temp == 0 else SCORE_TIE
    if any(t["margin"] > bar for t in ties):
        raise AssertionError(f"tokens differ beyond a near-tie: {ties}")
    return ties


def _serve(eng, prompts, new, temp=0.0, seed=0):
    """``prompts`` submitted together; tokens, wall seconds and the
    engine's stats before and after."""
    st0 = eng.stats()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=new, seed=seed, temperature=temp)
            for p in prompts]
    toks = [f.result(timeout=600)["tokens"] for f in futs]
    return toks, time.perf_counter() - t0, st0, eng.stats()


def _ttft_ms(eng, prompts):
    """Time to first token of ``prompts`` submitted together (requests of
    one new token: prefill and the first step), ms each."""
    done = {}
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=1) for p in prompts]
    for i, f in enumerate(futs):
        f.add_done_callback(
            lambda _, i=i: done.__setitem__(i, time.perf_counter()))
    for f in futs:
        f.result(timeout=600)
    return [(done[i] - t0) * 1e3 for i in range(len(prompts))]


def _kv_delta(st0, st1, keys=("prefix_hits", "prefix_tokens_saved",
                              "cow_copies", "prefill_chunks",
                              "prefill_tokens")):
    return {k: st1["kv"][k] - st0["kv"][k] for k in keys}


def prefix_part(net, cpu, ids, card, res):
    """Phase 11 (a): the prefix cache and chunked prefill (docstring)."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.serving.decode import generate_naive
    stem = ids[:STEM]
    prompts = [stem + ids[4000 + 211 * i:4000 + 211 * i + n]
               for i, n in enumerate(TAIL_LENS)]
    # 4 full blocks and 8 positions of the fifth, which wave 1's last
    # prompt published: a copy-on-write
    cut = prompts[-1][:STEM + KV_BLOCK + 8]
    kw = dict(slots=8, max_len=512, kv="paged", kv_block_size=KV_BLOCK)
    out = {"prompt_lens": [len(p) for p in prompts], "cut_len": len(cut)}
    eng = DecodeEngine(net, chunk_tokens=CHUNK, **kw).start()
    ref = DecodeEngine(net, prefix_cache=False, **kw).start()
    try:
        for e in (eng, ref):
            e.generate(ids[-4:], max_new_tokens=2)          # first use
        gens = {}
        for wave, ps in (("wave1", prompts), ("wave2", prompts + [cut])):
            ops.reset_launch_counts()
            toks, wall, st0, st1 = _serve(eng, ps, SERVE_NEW)
            steps = st1["steps"] - st0["steps"]
            launches = _expect_launches(
                f"phase 11 (a) {wave}", {"flash_decode_paged": 2 * steps})
            secs = st1["decode_seconds"] - st0["decode_seconds"]
            gens[wave] = toks
            out[wave] = {"steps": steps, "launches": launches,
                         "ms_per_step": secs / steps * 1e3,
                         "wall_s": wall,
                         "tokens_per_s": len(ps) * SERVE_NEW / wall,
                         "kv": _kv_delta(st0, st1)}
            print(f"serve (a): {wave}, {len(ps)} streams x {SERVE_NEW} "
                  f"tokens, prefix cache + chunks of {CHUNK}: {steps} steps,"
                  f" {out[wave]['ms_per_step']:.3f} ms/step, "
                  f"{out[wave]['tokens_per_s']:.1f} tokens/s, wall "
                  f"{wall:.3f} s; {out[wave]['kv']}; launches {launches} "
                  f"[{card}]", flush=True)
        kv = out["kv_after"] = eng.stats()["kv"]
        if kv["blocks_in_use"] != 0 or out["wave2"]["kv"]["cow_copies"] < 1 \
                or out["wave2"]["kv"]["prefix_hits"] < len(prompts) + 1:
            raise AssertionError(f"prefix cache: {out['wave2']['kv']}, "
                                 f"{kv}")
        ops.reset_launch_counts()
        want, wall, st0, st1 = _serve(ref, prompts + [cut], SERVE_NEW)
        steps = st1["steps"] - st0["steps"]
        out["reference"] = {
            "steps": steps, "wall_s": wall,
            "ms_per_step": (st1["decode_seconds"] - st0["decode_seconds"])
            / steps * 1e3,
            "launches": _expect_launches("phase 11 (a) reference",
                                         {"flash_decode_paged": 2 * steps})}
    finally:
        eng.stop()
        ref.stop()
    naive = [generate_naive(net, p, SERVE_NEW, 512)["tokens"]
             for p in prompts + [cut]]
    out["ties"] = {
        "wave1_vs_reference": _ties(net, prompts, gens["wave1"], want),
        "wave2_vs_reference": _ties(net, prompts + [cut], gens["wave2"],
                                    want),
        "reference_vs_naive": _ties(net, prompts + [cut], want, naive),
        "wave2_vs_naive": _ties(net, prompts + [cut], gens["wave2"], naive)}
    # time to first token of wave 1 with and without chunks (no cache)
    for chunk in (None, CHUNK):
        e = DecodeEngine(net, prefix_cache=False, chunk_tokens=chunk,
                         **kw).start()
        try:
            e.generate(ids[-4:], max_new_tokens=2)
            ms = _ttft_ms(e, prompts)
        finally:
            e.stop()
        out[f"ttft_ms_chunk_{chunk}"] = ms
        print(f"serve (a): time to first token, {len(prompts)} prompts of "
              f"{out['prompt_lens']} together, chunk_tokens={chunk}: mean "
              f"{np.mean(ms):.2f} ms, max {max(ms):.2f} ms [{card}]",
              flush=True)

    def one_at_a_time(model):
        e = DecodeEngine(model, chunk_tokens=CHUNK, **kw).start()
        try:
            for p in prompts + prompts + [cut]:
                e.generate(p, max_new_tokens=8, timeout=600)
            st = e.stats()["kv"]
        finally:
            e.stop()
        return {k: st[k] for k in ("prefix_hits", "prefix_tokens_saved",
                                   "cow_copies", "prefill_chunks",
                                   "prefill_tokens", "blocks_in_use",
                                   "blocks_cached")}
    out["one_at_a_time"] = one_at_a_time(net)
    out["one_at_a_time_cpu"] = one_at_a_time(cpu)
    print(f"serve (a): wave 2 {out['wave2']['ms_per_step']:.3f} ms/step "
          f"against wave 1 {out['wave1']['ms_per_step']:.3f} and the "
          f"reference (no cache, no chunks) "
          f"{out['reference']['ms_per_step']:.3f} "
          f"({out['reference']['steps']} steps against "
          f"{out['wave2']['steps']}); one request at a time, card "
          f"{out['one_at_a_time']} == CPU port "
          f"{out['one_at_a_time'] == out['one_at_a_time_cpu']}; near-ties "
          f"{out['ties']} [{card}]", flush=True)
    if out["one_at_a_time"] != out["one_at_a_time_cpu"] \
            or out["one_at_a_time"]["cow_copies"] < 1:
        raise AssertionError(f"card counters {out['one_at_a_time']} != CPU "
                             f"port {out['one_at_a_time_cpu']}")
    res["prefix"] = out


def decode_plans(n_rows):
    """K8's plan (``last_plan``) at the TinyTransformer engines' shapes:
    the plain step's B = 8 rows and a verify's 8 x ``n_rows`` nodes, C =
    512. Launched outside the counted windows."""
    import torch
    from deeplearning4j_tpu_torch.ops import decode_cuda
    plans = {}
    for name, B in (("plain_step", 8), ("verify", 8 * n_rows)):
        q = torch.zeros((B, HEADS, HEAD_DIM), device="cuda")
        kc = torch.zeros((B, 512, HEADS, HEAD_DIM), device="cuda")
        pos = torch.full((B,), 100, dtype=torch.int32, device="cuda")
        decode_cuda.flash_decode_step(q, kc, kc, pos)
        plans[name] = dict(decode_cuda.last_plan("flash_decode"), rows=B)
    return plans


def _spec_launches(eng, st0, st1):
    """The decode kernels a speculative engine's run must have launched:
    the target's plain steps (K8 dense, K9 paged) and verifies (K8) twice
    each, and the draft's steps once a draft attention layer (K8)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    from deeplearning4j_tpu_torch.serving.spec.rewind import layer_entries
    sp0, sp1 = st0["spec"], st1["spec"]
    steps = st1["steps"] - st0["steps"]
    verifies = sp1["verifies"] - sp0["verifies"]
    dsteps = sp1["draft_steps"] - sp0["draft_steps"]
    heads = sum(isinstance(l, MultiHeadAttention)
                for _, l in layer_entries(eng._draft.model))
    tgt = sum(isinstance(l, MultiHeadAttention)
              for _, l in layer_entries(eng.model))
    want = {"flash_decode": tgt * verifies + heads * dsteps}
    plain = tgt * (steps - verifies)
    if eng.kv == "paged":
        want["flash_decode_paged"] = plain
    else:
        want["flash_decode"] += plain
    return {k: v for k, v in want.items() if v}


def spec_part(net, ids, card, res):
    """Phase 11 (b): speculation over TinyTransformer (docstring)."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.serving.spec import SpecConfig
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    vocab = res["vocab"]
    draft = TinyTransformer(vocab_size=vocab, n_layers=1, seed=3).init(
        device=net.device)
    held = ids[len(ids) * 7 // 8:]
    lens = [16, 22, 28, 34, 40, 46, 52, 64]
    prompts = [held[64 * i:64 * i + n] for i, n in enumerate(lens)]
    kvs = {"dense": {}, "paged": dict(kv="paged", kv_block_size=KV_BLOCK)}
    drafts = {"self k=4": lambda: SpecConfig(net, k=4),
              "draft (3,2,2)": lambda: SpecConfig(draft, tree=(3, 2, 2))}
    out = {"plans": decode_plans(1 + 4), "plans_tree": decode_plans(8)}
    print(f"spec (b): K8 plans, plain step {out['plans']['plain_step']}, "
          f"verify k=4 {out['plans']['verify']}, verify (3,2,2) "
          f"{out['plans_tree']['verify']} [{card}]", flush=True)
    plain = {}
    for kind, kw in kvs.items():
        eng = DecodeEngine(net, slots=8, max_len=512, **kw).start()
        try:
            eng.generate(ids[-4:], max_new_tokens=2)
            kernel = "flash_decode" if kind == "dense" else \
                "flash_decode_paged"
            ops.reset_launch_counts()
            toks, wall, st0, st1 = _serve(eng, prompts, SERVE_NEW)
            steps = st1["steps"] - st0["steps"]
            launches = _expect_launches(f"phase 11 (b) plain {kind}",
                                        {kernel: 2 * steps})
            sampled = _serve(eng, prompts, SERVE_NEW, SPEC_TEMP,
                             SPEC_SEED)[0]
        finally:
            eng.stop()
        plain[kind] = {"greedy": toks, "sampled": sampled}
        out[f"plain_{kind}"] = {
            "steps": steps, "wall_s": wall, "launches": launches,
            "tokens_per_s": len(prompts) * SERVE_NEW / wall,
            "ms_per_step": (st1["decode_seconds"] - st0["decode_seconds"])
            / steps * 1e3}
        print(f"spec (b): plain {kind} engine, {len(prompts)} streams x "
              f"{SERVE_NEW}: {steps} steps, "
              f"{out[f'plain_{kind}']['ms_per_step']:.3f} ms/step, "
              f"{out[f'plain_{kind}']['tokens_per_s']:.1f} tokens/s "
              f"[{card}]", flush=True)
    for kind, kw in kvs.items():
        for dname, make in drafts.items():
            tag = f"{kind}, {dname}"
            eng = DecodeEngine(net, slots=8, max_len=512, spec=make(),
                               **kw).start()
            try:
                eng.generate(ids[-4:], max_new_tokens=2)
                ops.reset_launch_counts()
                toks, wall, st0, st1 = _serve(eng, prompts, SERVE_NEW)
                launches = _expect_launches(f"phase 11 (b) {tag}",
                                            _spec_launches(eng, st0, st1))
                sampled = _serve(eng, prompts, SERVE_NEW, SPEC_TEMP,
                                 SPEC_SEED)[0]
                sp = st1["spec"]
                ticks = sp["verifies"] - st0["spec"]["verifies"]
                per_tick = len(prompts) * SERVE_NEW / ticks
                row = {"launches": launches, "wall_s": wall, "ticks": ticks,
                       "acceptance_rate": sp["acceptance_rate"],
                       "mean_accepted_depth": sp["mean_accepted_depth"],
                       "tokens_per_tick": per_tick,
                       "ms_per_tick": wall / ticks * 1e3,
                       "tokens_per_s": len(prompts) * SERVE_NEW / wall}
                row["ties_greedy"] = _ties(net, prompts, toks,
                                           plain[kind]["greedy"])
                row["ties_sampled"] = _ties(net, prompts, sampled,
                                            plain[kind]["sampled"],
                                            SPEC_TEMP, SPEC_SEED)
                # one-token prompts in step: a tick emits the accepted
                # depth + 1 tokens a stream
                new = min(200, max(8, round(
                    PROFILE_TICKS * (1 + row["mean_accepted_depth"]))))

                def run():
                    v0 = eng.stats()["spec"]["verifies"]
                    futs = [eng.submit([t], max_new_tokens=new)
                            for t in range(len(prompts))]
                    for f in futs:
                        f.result(timeout=600)
                    return eng.stats()["spec"]["verifies"] - v0
                row["profile"] = profile_steps(run, PROFILE_TICKS,
                                               ("flash_decode_kernel",))
            finally:
                eng.stop()
            prof = row["profile"]
            busy = prof["device_busy_ms_per_step"]
            row["decode_kernel_share"] = (
                None if busy is None else
                prof["tagged_ms_per_step"]["flash_decode_kernel"] / busy)
            out[tag] = row
            print(f"spec (b): {tag}: acceptance {row['acceptance_rate']:.3f}"
                  f" (mean accepted depth "
                  f"{row['mean_accepted_depth']:.2f}), {ticks} ticks, "
                  f"{per_tick:.2f} tokens a tick, {row['ms_per_tick']:.3f}"
                  f" ms a tick, {row['tokens_per_s']:.1f} tokens/s (plain "
                  f"{out[f'plain_{kind}']['tokens_per_s']:.1f}); near-ties "
                  f"greedy {row['ties_greedy']}, sampled "
                  f"{row['ties_sampled']}; launches {launches}; "
                  + fmt_profile(prof, ("flash_decode_kernel",),
                                unit="tick", units="ticks")
                  + f" [{card}]", flush=True)
    res["spec"] = out


def spec_lstm_part(card, res):
    """Phase 11 (c): speculation over the LSTM's carries (docstring)."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.serving.spec import SpecConfig
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    _, (xte, _), vocab = corpus_windows(T=64)
    zoo = TextGenerationLSTM(total_unique_characters=len(vocab))
    net = zoo.init_pretrained(device="cuda")
    cpu = zoo.init_pretrained(device="cpu")
    out = {}
    try:
        DecodeEngine(net, kv="paged")
    except ValueError as e:
        if "prefix_cache" not in str(e):
            raise
        out["paged_default_raises"] = str(e)
    else:
        raise AssertionError("DecodeEngine(lstm, kv='paged') did not raise")
    text = xte.argmax(-1)
    prompts = [list(map(int, text[i, :n])) for i, n in
               enumerate((16, 22, 28, 34, 40, 46, 52, 64))]
    spec = SpecConfig(self_draft="early_exit:1", tree=(3, 2))
    runs = {"plain": (net, {}), "cpu": (cpu, {}),
            "spec dense": (net, {"spec": spec}),
            "spec paged": (net, {"spec": spec, "kv": "paged",
                                 "prefix_cache": False,
                                 "chunk_tokens": CHUNK})}
    toks = {}
    for name, (model, kw) in runs.items():
        eng = DecodeEngine(model, slots=8, max_len=256, **kw).start()
        try:
            eng.generate(prompts[0][:2], max_new_tokens=2)
            ops.reset_launch_counts()
            toks[name], wall, st0, st1 = _serve(eng, prompts, SERVE_NEW)
            row = {"wall_s": wall, "launches": ops.launch_counts(),
                   "tokens_per_s": len(prompts) * SERVE_NEW / wall}
        finally:
            eng.stop()
        if row["launches"]:
            raise AssertionError(f"LSTM {name}: launches {row['launches']}"
                                 " (its decode step runs no kernel)")
        if "spec" in kw:
            sp = st1["spec"]
            ticks = sp["verifies"] - st0["spec"]["verifies"]
            row.update(acceptance_rate=sp["acceptance_rate"], ticks=ticks,
                       tokens_per_tick=len(prompts) * SERVE_NEW / ticks,
                       ms_per_tick=wall / ticks * 1e3)
        out[name] = row
    out["ties_cpu"] = _ties(net, prompts, toks["plain"], toks["cpu"])
    for name in ("spec dense", "spec paged"):
        if toks[name] != toks["plain"]:
            raise AssertionError(f"LSTM {name} tokens differ from the plain "
                                 "engine's")
    print(f"spec (c): TextGenerationLSTM, early_exit:1 tree (3, 2), "
          f"{len(prompts)} streams x {SERVE_NEW}: tokens equal the plain "
          f"engine's (dense and paged + chunks of {CHUNK}); acceptance "
          f"{out['spec dense']['acceptance_rate']:.3f} / "
          f"{out['spec paged']['acceptance_rate']:.3f}, tokens a tick "
          f"{out['spec dense']['tokens_per_tick']:.2f}, ms a tick "
          f"{out['spec dense']['ms_per_tick']:.3f}, tokens/s "
          f"{out['spec dense']['tokens_per_s']:.1f} / "
          f"{out['spec paged']['tokens_per_s']:.1f} against plain "
          f"{out['plain']['tokens_per_s']:.1f}; plain vs CPU port near-ties "
          f"{out['ties_cpu']}; kv='paged' alone raises: "
          f"{out['paged_default_raises'][:60]!r}... [{card}]", flush=True)
    res["lstm"] = out


# ------------------------------------------------------------- phase 11 (d)
ROUNDS = 5            # eager and captured rounds, in turns, in one call
ONE_AT_A_TIME, ONE_NEW = 3, 24   # prompts and new tokens of the CPU check


def _decode_round(eng, prompts, new, spec):
    """``prompts`` served together once: tokens, the round's numbers (wall,
    tokens/s, ms a step or a tick, steps, ticks) and the stats around
    it."""
    st0 = eng.stats()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    toks = [f.result(timeout=600)["tokens"] for f in futs]
    wall = time.perf_counter() - t0
    st1 = eng.stats()
    steps = st1["steps"] - st0["steps"]
    row = {"wall_s": wall, "tokens_per_s": len(prompts) * new / wall,
           "steps": steps}
    if spec:
        row["ticks"] = st1["spec"]["verifies"] - st0["spec"]["verifies"]
        row["ms"] = wall / row["ticks"] * 1e3
    else:
        row["ms"] = (st1["decode_seconds"] - st0["decode_seconds"]) \
            / steps * 1e3
    return toks, row, st0, st1


def _expected_launches(eng, st0, st1):
    """The decode kernels a run of ``eng`` between two stats must launch:
    K8 (dense) or K9 (paged) twice a plain step and the verifies' and the
    draft's K8 (``_spec_launches``); none for a model without attention."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    from deeplearning4j_tpu_torch.serving.spec.rewind import layer_entries
    if eng._spec is not None:
        return _spec_launches(eng, st0, st1)
    heads = sum(isinstance(l, MultiHeadAttention)
                for _, l in layer_entries(eng.model))
    kernel = "flash_decode_paged" if eng.kv == "paged" else "flash_decode"
    n = heads * (st1["steps"] - st0["steps"])
    return {kernel: n} if n else {}


def _program_launches(eng):
    """What one replay of each program must launch: the step K8 or K9 once
    an attention layer, the verify K8 once a target attention layer, the
    draft K8 once a draft attention layer and position; the prefill (the
    layer's own softmax) and the copy none."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    from deeplearning4j_tpu_torch.serving.spec.rewind import layer_entries

    def heads(m):
        return sum(isinstance(l, MultiHeadAttention)
                   for _, l in layer_entries(m))
    tgt = heads(eng.model)
    kernel = "flash_decode_paged" if eng.kv == "paged" else "flash_decode"
    want = {"step": {kernel: tgt}, "prefill": {}, "cow": {},
            "verify": {"flash_decode": tgt}}
    if eng._draft is not None:
        want["draft"] = {"flash_decode": heads(eng._draft.model)
                         * eng._draft.k}
    return {k: {n: c for n, c in v.items() if c} for k, v in want.items()}


def _spread(xs):
    return {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}


def _counters(st):
    """The counters a one-at-a-time run must share with the CPU port."""
    out = {k: st[k] for k in ("steps", "tokens", "requests",
                              "compiled_programs")}
    if st["kv"] is not None:
        out.update({k: st["kv"][k] for k in (
            "prefix_hits", "prefix_tokens_saved", "cow_copies",
            "prefill_chunks", "prefill_tokens", "blocks_in_use",
            "blocks_cached", "kv_programs")})
    if st["spec"] is not None:
        out.update({k: st["spec"][k] for k in (
            "drafted_tokens", "accepted_tokens", "verifies", "draft_calls",
            "draft_steps", "verify_programs", "draft_programs")})
    return out


def _one_at_a_time(model, kw, prompts, max_len):
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    eng = DecodeEngine(model, slots=8, max_len=max_len, **kw).start()
    try:
        toks = [eng.generate(p, max_new_tokens=ONE_NEW, timeout=600)["tokens"]
                for p in prompts[:ONE_AT_A_TIME]]
        return toks, _counters(eng.stats())
    finally:
        eng.stop()


def captured_part(name, models, make_kw, prompts, naive, max_len, card):
    """One part of phase 11 (d): ``make_kw(target, draft)`` gives the
    engine's arguments for a pair of models (``models``: {"card": (target,
    draft), "cpu": (...)}). The eager engine (the private seam) against the
    captured one, in turns over ROUNDS rounds of ``prompts``, with the
    bars of the docstring; the one-at-a-time counters against the CPU
    port's; ten captured steps or ticks under torch.profiler."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    kw = make_kw(*models["card"])
    spec = "spec" in kw
    eager = DecodeEngine(models["card"][0], slots=8, max_len=max_len, **kw)
    eager._capture_programs = False
    eager.start()
    capt = DecodeEngine(models["card"][0], slots=8, max_len=max_len,
                        **kw).start()
    out = {"rounds": {"eager": [], "captured": []}}
    try:
        progs0 = capt.program_stats()
        want = _program_launches(capt)
        for k, p in progs0.items():
            if p["programs"] != 1 or p["captures"] != 1 \
                    or p["launches"] != [want[k]]:
                raise AssertionError(f"phase 11 (d) {name}: program {k} "
                                     f"{p}, want one capture launching "
                                     f"{want[k]}")
        if any(p["captures"] for p in eager.program_stats().values()):
            raise AssertionError(f"phase 11 (d) {name}: the eager engine "
                                 "captured")
        toks = {}
        for r in range(ROUNDS):
            order = [("eager", eager), ("captured", capt)]
            for mode, eng in (order if r % 2 == 0 else order[::-1]):
                ops.reset_launch_counts()
                t, row, st0, st1 = _decode_round(eng, prompts, SERVE_NEW,
                                                 spec)
                row["launches"] = _expect_launches(
                    f"phase 11 (d) {name} {mode}",
                    _expected_launches(eng, st0, st1))
                out["rounds"][mode].append(row)
                if toks.setdefault(mode, t) != t:
                    raise AssertionError(f"phase 11 (d) {name}: {mode} "
                                         "tokens changed between rounds")
        if toks["eager"] != toks["captured"]:
            raise AssertionError(f"phase 11 (d) {name}: captured tokens "
                                 "differ from eager")
        out["launches"] = {}
        for rows in out["rounds"].values():
            for row in rows:
                _add_counts(out["launches"], row["launches"])
        out["ties_vs_naive"] = _ties(models["card"][0], prompts,
                                     toks["captured"], naive)
        progs1 = capt.program_stats()
        out["programs"] = progs1
        if {k: p["captures"] for k, p in progs1.items()} != \
                {k: p["captures"] for k, p in progs0.items()}:
            raise AssertionError(f"phase 11 (d) {name}: captures after "
                                 f"warmup: {progs0} -> {progs1}")
        st = capt.stats()
        out["trace_count"] = (capt.trace_count, eager.trace_count)
        if out["trace_count"] != (1, 1):
            raise AssertionError(f"phase 11 (d) {name}: trace_count "
                                 f"{out['trace_count']}")
        if st["kv"] is not None and (st["kv"]["blocks_in_use"]
                                     or eager.stats()["kv"]["blocks_in_use"]):
            raise AssertionError(f"phase 11 (d) {name}: blocks in use at "
                                 "the end")
        if spec:
            out["acceptance_rate"] = st["spec"]["acceptance_rate"]
            out["mean_accepted_depth"] = st["spec"]["mean_accepted_depth"]
        new = PROFILE_TICKS if not spec else min(200, max(8, round(
            PROFILE_TICKS * (1 + out["mean_accepted_depth"]))))
        unit = "verifies" if spec else "steps"

        def run():
            st0 = capt.stats()
            futs = [capt.submit([t], max_new_tokens=new)
                    for t in range(len(prompts))]
            for f in futs:
                f.result(timeout=600)
            st1 = capt.stats()
            return (st1["spec"][unit] - st0["spec"][unit] if spec
                    else st1[unit] - st0[unit])
        prof = out["profile"] = profile_steps(run, PROFILE_TICKS,
                                              ("flash_decode",))
        busy = prof["device_busy_ms_per_step"]
        out["decode_kernel_share"] = (
            None if busy is None else
            prof["tagged_ms_per_step"]["flash_decode"] / busy)
    finally:
        eager.stop()
        capt.stop()
    got, cnt = _one_at_a_time(models["card"][0], kw, prompts, max_len)
    want_t, cpu_cnt = _one_at_a_time(models["cpu"][0],
                                     make_kw(*models["cpu"]), prompts,
                                     max_len)
    out["one_at_a_time"] = {"card": cnt, "cpu": cpu_cnt,
                            "tokens_equal": got == want_t}
    if got == want_t and cnt != cpu_cnt:
        raise AssertionError(f"phase 11 (d) {name}: counters {cnt} != CPU "
                             f"port {cpu_cnt}")
    if got != want_t:
        out["one_at_a_time"]["ties"] = _ties(models["card"][0],
                                             prompts[:ONE_AT_A_TIME], got,
                                             want_t)
    for mode in ("eager", "captured"):
        rows = out["rounds"][mode]
        out[mode] = {"ms": _spread([r["ms"] for r in rows]),
                     "tokens_per_s": _spread([r["tokens_per_s"]
                                              for r in rows])}
    u = "tick" if spec else "step"
    e, c = out["eager"]["ms"], out["captured"]["ms"]
    print(f"captured (d): {name}: {len(prompts)} streams x {SERVE_NEW}, "
          f"{ROUNDS} rounds each in turns: ms/{u} eager min "
          f"{e['min']:.3f} / median {e['median']:.3f} / max {e['max']:.3f},"
          f" captured {c['min']:.3f} / {c['median']:.3f} / {c['max']:.3f};"
          f" tokens/s captured median "
          f"{out['captured']['tokens_per_s']['median']:.1f}, eager "
          f"{out['eager']['tokens_per_s']['median']:.1f}; tokens eager == "
          f"captured, near-ties vs naive {out['ties_vs_naive']}; programs "
          + ", ".join(f"{k} {p['captures']} capture(s), "
                      f"{p['launches'][0] if p['launches'] else {}}/replay"
                      for k, p in out["programs"].items())
          + f"; one at a time card == CPU port "
          f"{cnt == cpu_cnt} (tokens equal {got == want_t}); "
          + fmt_profile(prof, ("flash_decode",), unit=u, units=u + "s")
          + f" [{card}]", flush=True)
    return out, toks["captured"]


def _swap_and_eos(net, vocab, prompts, plain, max_len, card):
    """On a captured dense engine: one ``swap_weights`` while 8 streams
    run (applied when they drained; the next streams against
    ``generate_naive`` of the new weights under the near-tie rule; 0 new
    captures), and one ``eos_id`` run (every stream ends at its first
    ``eos_id``: the plain captured streams cut there)."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.serving.decode import generate_naive
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    new = TinyTransformer(vocab_size=vocab, seed=7).init(device="cuda")
    out = {}
    eng = DecodeEngine(net, slots=8, max_len=max_len).start()
    try:
        caps0 = {k: p["captures"] for k, p in eng.program_stats().items()}
        futs = [eng.submit(p, max_new_tokens=SERVE_NEW) for p in prompts]
        t0 = time.perf_counter()
        version = eng.swap_weights(new.params, timeout=600)
        out["swap_wait_s"] = time.perf_counter() - t0
        old = [f.result(timeout=600)["tokens"] for f in futs]
        if old != plain:
            raise AssertionError("phase 11 (d) swap: the streams in flight "
                                 "did not finish on the old weights")
        toks = _serve(eng, prompts, SERVE_NEW)[0]
        caps1 = {k: p["captures"] for k, p in eng.program_stats().items()}
    finally:
        eng.stop()
    naive = [generate_naive(new, p, SERVE_NEW, max_len)["tokens"]
             for p in prompts]
    out.update(version=version, captures=(caps0, caps1),
               ties_vs_naive=_ties(new, prompts, toks, naive))
    if version != 1 or caps0 != caps1:
        raise AssertionError(f"phase 11 (d) swap: version {version}, "
                             f"captures {caps0} -> {caps1}")
    eos = plain[0][10]
    eng = DecodeEngine(net, slots=8, max_len=max_len, eos_id=eos).start()
    try:
        got = _serve(eng, prompts, SERVE_NEW)[0]
        if eng.stats()["compiled_programs"] != 1:
            raise AssertionError("phase 11 (d) eos: more than one program")
    finally:
        eng.stop()
    want = [t[:t.index(eos) + 1] if eos in t else t for t in plain]
    if got != want:
        raise AssertionError(f"phase 11 (d) eos {eos}: {got} != {want}")
    out["eos"] = {"eos_id": eos, "lengths": [len(t) for t in got]}
    print(f"captured (d): swap_weights while {len(prompts)} streams ran: "
          f"applied after {out['swap_wait_s']:.3f} s (the streams drained "
          f"on the old weights), version {version}, captures {caps0} -> "
          f"{caps1}, new tokens vs generate_naive near-ties "
          f"{out['ties_vs_naive']}; eos_id {eos}: streams end at their "
          f"first eos_id, lengths {out['eos']['lengths']} [{card}]",
          flush=True)
    return out


def captured_engine_part(net, cpu, ids, card, res):
    """Phase 11 (d): the captured decode engine (docstring)."""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.serving.decode import generate_naive
    from deeplearning4j_tpu_torch.serving.spec import SpecConfig
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM, \
        TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    vocab = res["vocab"]
    draft = TinyTransformer(vocab_size=vocab, n_layers=1, seed=3).init(
        device="cuda")
    cpu_draft = ComputationGraph(draft.conf, device="cpu").set_params(
        draft.params)
    held = ids[len(ids) * 7 // 8:]
    lens = [16, 22, 28, 34, 40, 46, 52, 64]
    prompts = [held[64 * i:64 * i + n] for i, n in enumerate(lens)]
    naive = [generate_naive(net, p, SERVE_NEW, 512)["tokens"]
             for p in prompts]
    paged = dict(kv="paged", kv_block_size=KV_BLOCK)
    tree = (3, 2, 2)
    parts = {
        "plain dense": lambda t, d: {},
        "plain paged, prefix cache, chunks of 32": lambda t, d: dict(
            paged, chunk_tokens=CHUNK),
        "target as draft k=4, dense": lambda t, d: dict(
            spec=SpecConfig(t, k=4)),
        "draft (3,2,2), dense": lambda t, d: dict(
            spec=SpecConfig(d, tree=tree)),
        "draft (3,2,2), paged": lambda t, d: dict(
            paged, spec=SpecConfig(d, tree=tree)),
        "draft (3,2,2), paged, chunks of 32": lambda t, d: dict(
            paged, chunk_tokens=CHUNK, spec=SpecConfig(d, tree=tree))}
    models = {"card": (net, draft), "cpu": (cpu, cpu_draft)}
    out, toks = {}, {}
    for name, make in parts.items():
        out[name], toks[name] = captured_part(name, models, make, prompts,
                                              naive, 512, card)
    # LSTM: the early-exit self-draft
    _, (xte, _), lvocab = corpus_windows(T=64)
    zoo = TextGenerationLSTM(total_unique_characters=len(lvocab))
    lstm, lcpu = zoo.init_pretrained(device="cuda"), \
        zoo.init_pretrained(device="cpu")
    text = xte.argmax(-1)
    lprompts = [list(map(int, text[i, :n])) for i, n in enumerate(lens)]
    lnaive = [generate_naive(lstm, p, SERVE_NEW, 256)["tokens"]
              for p in lprompts]
    name = "LSTM early_exit:1 (3,2), dense"
    out[name], _ = captured_part(
        name, {"card": (lstm, None), "cpu": (lcpu, None)},
        lambda t, d: dict(spec=SpecConfig(self_draft="early_exit:1",
                                          tree=(3, 2))),
        lprompts, lnaive, 256, card)
    # rates against the captured plain engine, time to first token
    for name, row in out.items():
        base = ("plain paged, prefix cache, chunks of 32" if "paged" in name
                else "plain dense")
        if not name.startswith("LSTM"):
            row["tokens_per_s_vs_plain"] = (
                row["captured"]["tokens_per_s"]["median"]
                / out[base]["captured"]["tokens_per_s"]["median"])
    for chunk in (None, CHUNK):
        e = DecodeEngine(net, slots=8, max_len=512, prefix_cache=False,
                         chunk_tokens=chunk, **paged).start()
        try:
            e.generate(ids[-4:], max_new_tokens=2)
            ms = _ttft_ms(e, prompts)
        finally:
            e.stop()
        out[f"ttft_ms_chunk_{chunk}"] = ms
    print("captured (d): tokens/s against the captured plain engine: "
          + ", ".join(f"{k} {v['tokens_per_s_vs_plain']:.3f}"
                      for k, v in out.items()
                      if isinstance(v, dict) and "tokens_per_s_vs_plain" in v)
          + f"; time to first token of {len(prompts)} prompts together, "
          f"captured paged engine: mean "
          f"{np.mean(out['ttft_ms_chunk_None']):.2f} ms without chunks, "
          f"{np.mean(out[f'ttft_ms_chunk_{CHUNK}']):.2f} ms with chunks of "
          f"{CHUNK} [{card}]", flush=True)
    out["swap_and_eos"] = _swap_and_eos(net, vocab, prompts,
                                        toks["plain dense"], 512, card)
    res["captured"] = out


# ------------------------------------------------------------- phase 12
CNN_SERVE_SLACK = 0.02          # manifest accuracy, as tests/test_pretrained
CNN_PROB_TOL = {"lenet": 1e-4, "simplecnn": 1e-4, "resnet50_cifar10": 1e-3}
CNN_BATCH_TOL = 1e-5            # a merged /predict against one forward
LENET_B, LENET_ROWS, LENET_EPOCHS, LENET_BAR = 128, 6400, 6, 0.85
LENET_PARITY_STEPS, LENET_BITWISE_STEPS = 5, 10
RESNET_B, RESNET_STEPS, RESNET_PARITY_B, RESNET_TOL = 32, 20, 4, 1e-3
CNN_PROFILE_STEPS = 10
# kernel-name fragments of cuDNN's convolution kernels (forward, dgrad,
# wgrad) on Hopper: the share of busy time reads these
CONV_TAGS = ("conv", "xmma", "cudnn", "fprop", "dgrad", "wgrad",
             "implicit_gemm")
CNN_DIR = ROOT / "build" / "cnn_resume"


@contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms (no atomics in a
    backward), for the bit-for-bit comparisons of phase 12."""
    import torch
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def _artifact_data(name):
    """An artifact's test images and integer labels, as the JAX package's
    tests/test_pretrained.py makes them."""
    from deeplearning4j_tpu_torch.data.fetchers import (_synthetic_images,
                                                        load_cifar10,
                                                        load_mnist)
    from deeplearning4j_tpu_torch.zoo import ZooModel
    entry = ZooModel.manifest()[name]
    if name == "lenet":
        x, y = load_mnist(train=False, num_examples=entry["n_test"],
                          flatten=False)
        return entry, x.astype(np.float32), y.argmax(-1)
    if name == "simplecnn":
        x, y = _synthetic_images(entry["n_test"], 48, 48, 3,
                                 entry["n_classes"], seed=entry["test_seed"])
        return entry, x.astype(np.float32), y
    x, y = load_cifar10(train=False, num_examples=entry["n_test"])
    return entry, x.astype(np.float32), y.argmax(-1)


def cnn_serving_part(card, res):
    """(a) The three bundled CNN zips served on the card: held-out
    accuracy through /predict, probabilities against the CPU port's from
    the same zip, eight concurrent mixed-size requests against one
    unbatched forward each."""
    from deeplearning4j_tpu_torch.serving import (InferenceClient,
                                                  InferenceServer)
    from deeplearning4j_tpu_torch.zoo import LeNet, ResNet50Cifar, SimpleCNN
    zoos = {"lenet": lambda e: LeNet(num_classes=10),
            "simplecnn": lambda e: SimpleCNN(num_classes=e["n_classes"]),
            "resnet50_cifar10": lambda e: ResNet50Cifar(num_classes=10)}
    out = {}
    for name, make in zoos.items():
        entry, x, y = _artifact_data(name)
        zoo = make(entry)
        net, cpu = zoo.init_pretrained(device="cuda"), \
            zoo.init_pretrained(device="cpu")
        srv = InferenceServer(net, port=0, max_latency_ms=2.0).start()
        cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
        row = {}
        try:
            ms = []
            for _ in range(2):      # the first pays the card's first use
                t0 = time.perf_counter()
                probs = np.concatenate([cli.predict(x[i:i + 500])
                                        for i in range(0, len(x), 500)])
                ms.append(round((time.perf_counter() - t0) * 1e3, 3))
            want = cpu.output(x).numpy()
            if probs.shape != want.shape or not np.isfinite(probs).all():
                raise AssertionError(f"phase 12 (a) {name}: /predict "
                                     f"returned {probs.shape}")
            acc = float((probs.argmax(-1) == y).mean())
            err = float(np.abs(probs - want).max())
            sizes = [1, 3, 7, 2, 5, 16, 4, 9]
            starts = np.cumsum([0] + sizes)
            reqs = [x[a:b] for a, b in zip(starts[:-1], starts[1:])]
            with ThreadPoolExecutor(len(reqs)) as pool:
                answers = list(pool.map(cli.predict, reqs))
            worst = max(float(np.abs(
                got - net.output(r, bucketed=False).float().cpu().numpy())
                .max()) for got, r in zip(answers, reqs))
        finally:
            srv.stop()
        row.update(accuracy=acc, manifest=entry["accuracy"],
                   predict_ms=ms, rows=len(x), max_abs_err_vs_cpu=err,
                   mixed_max_abs_err=worst)
        out[name] = row
        print(f"cnn (a): {name} /predict of {len(x)} held-out images in "
              f"batches of 500: accuracy {acc:.4f} (manifest "
              f"{entry['accuracy']} +- {CNN_SERVE_SLACK}), {ms} ms (first, "
              f"second); probabilities against the CPU port's from the "
              f"same zip: max abs err {err:.3g} (tol {CNN_PROB_TOL[name]}); "
              f"8 concurrent /predict of sizes {sizes} against unbatched "
              f"forwards: max abs err {worst:.3g} [{card}]", flush=True)
        if abs(acc - entry["accuracy"]) > CNN_SERVE_SLACK:
            raise AssertionError(f"phase 12 (a) {name}: accuracy {acc}")
        if err > CNN_PROB_TOL[name]:
            raise AssertionError(f"phase 12 (a) {name}: card vs CPU {err}")
        if worst > CNN_BATCH_TOL:
            raise AssertionError(f"phase 12 (a) {name}: batched {worst}")
    res["serving"] = out


def _lenet_pair(device="cuda"):
    """LeNet from its configuration's seed on ``device`` and the CPU
    port's copy of its parameters."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import LeNet
    net = LeNet(num_classes=10).init(device=device)
    cpu = MultiLayerNetwork(net.conf, device="cpu").set_params(net.params,
                                                               net.state)
    return net, cpu


class ScoreRecorder:
    """A listener keeping each fit call's loss (a host read)."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, epoch):
        self.scores.append(model.get_score())


def _first_batches(it, n):
    """An iterator over the first ``n`` batches of ``it`` (its rows in
    its order, unshuffled), with its pre-processor."""
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    it.reset()
    rows = [next(it) for _ in range(n)]
    sub = ListDataSetIterator(DataSet.merge(rows), it.batch_size)
    return sub.set_pre_processor(it.pre_processor)


def lenet_part(card, res):
    """(b) LeNet trained from its seed on the uint8 wire: the first steps
    against the CPU port, captured against eager bit for bit, the 6-epoch
    recipe with its held-out accuracy and ms a step, ten captured steps
    profiled."""
    import torch
    from deeplearning4j_tpu_torch.data.fetchers import MnistDataSetIterator
    out = {}
    t0 = time.perf_counter()
    train = MnistDataSetIterator(LENET_B, num_examples=LENET_ROWS,
                                 flatten=False)
    test = MnistDataSetIterator(500, train=False, num_examples=2000,
                                flatten=False)
    out["data_s"] = time.perf_counter() - t0
    if train.dataset.features.dtype != np.uint8 \
            or not train.pre_processor.device_side:
        raise AssertionError("phase 12 (b): the MNIST iterator is not on "
                             "the uint8 wire")
    with deterministic_cudnn():
        # the first steps against the CPU port, one step a fit call
        net, cpu = _lenet_pair()
        first = _first_batches(train, LENET_PARITY_STEPS)
        recs = []
        for m in (net, cpu):
            m._CHUNK_MAX_STEPS = 1
            recs.append(ScoreRecorder())
            m.set_listeners(recs[-1])
            m.fit(first)
        losses = np.array(recs[0].scores), np.array(recs[1].scores)
        loss_err = float(np.max(np.abs(losses[0] - losses[1])
                                / np.abs(losses[1])))
        p_err = max(float((a[k].cpu() - b[k]).abs().max()
                          / max(b[k].abs().max().item(), 1e-30))
                    for a, b in zip(net.params, cpu.params) for k in a)
        out.update(first_losses=losses[0].tolist(),
                   cpu_losses=losses[1].tolist(), loss_rel_err=loss_err,
                   param_rel_err=p_err)
        print(f"cnn (b): LeNet, first {LENET_PARITY_STEPS} steps (B="
              f"{LENET_B}, uint8 wire) against the CPU port: losses "
              f"{[round(float(v), 5) for v in losses[0]]}, max relative err "
              f"{loss_err:.3g}, parameters {p_err:.3g} of each tensor's "
              f"largest (tol {LOSS_RTOL}) [{card}]", flush=True)
        if loss_err > LOSS_RTOL or p_err > LOSS_RTOL:
            raise AssertionError("phase 12 (b): card vs CPU port")
        # captured against eager, bit for bit
        cap, _ = _lenet_pair()
        eager, _ = _lenet_pair()
        eager._capture_steps = False
        some = _first_batches(train, LENET_BITWISE_STEPS)
        for m in (cap, eager):
            m._CHUNK_MAX_STEPS = 4
            m.fit(some)
        if cap._capture_count == 0 or not _trees_equal(cap.params,
                                                       eager.params):
            raise AssertionError(
                f"phase 12 (b): captured vs eager differ by "
                f"{_tree_diff(cap.params, eager.params)}")
        print(f"cnn (b): LeNet, {LENET_BITWISE_STEPS} captured steps equal "
              f"{LENET_BITWISE_STEPS} eager steps bit for bit ("
              f"{cap._capture_count} captures, deterministic cuDNN) "
              f"[{card}]", flush=True)
    # the recipe from the seed, captured
    net, _ = _lenet_pair()
    times = []
    for epoch in range(LENET_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(train)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steps = LENET_ROWS // LENET_B
    acc = float(net.evaluate(test).accuracy())
    out.update(epoch_s=times, heldout_accuracy=acc,
               ms_per_step_warm=min(times[1:]) / steps * 1e3,
               captures=net._capture_count)
    ten = _first_batches(train, CNN_PROFILE_STEPS)
    prof = profile_steps(lambda: net.fit(ten) and CNN_PROFILE_STEPS,
                         CNN_PROFILE_STEPS, (CONV_TAGS,))
    out["profile"] = prof
    print(f"cnn (b): LeNet recipe, {LENET_EPOCHS} epochs of {steps} "
          f"captured steps (B={LENET_B}, uint8 wire, /255 on the card): "
          f"held-out accuracy {acc:.4f} (bar > {LENET_BAR}, < 1.0); epochs "
          f"{[round(t, 3) for t in times]} s, {out['ms_per_step_warm']:.3f} "
          f"ms a step warm; {fmt_profile(prof, (CONV_TAGS,))} [{card}]",
          flush=True)
    if not LENET_BAR < acc < 1.0:
        raise AssertionError(f"phase 12 (b): held-out accuracy {acc}")
    res["lenet"] = out


def _resnet(device="cuda"):
    """ResNet50 at full width from its configuration's seed, trained with
    Sgd(1e-2): the zoo's default Nesterovs(0.1) diverges from this
    initialization in a few small-batch steps (on the CPU at 64 x 64, B=2:
    loss 11 -> 240 -> 8.9e8), and an Adam step moves every weight whose
    gradient is near zero by +-lr with the sign of its rounding, so two
    implementations part after one step."""
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.zoo import ResNet50
    return ResNet50(num_classes=1000, updater=Sgd(1e-2)).init(device=device)


def _resnet_float64():
    """The seed's ResNet50 in float64 on the card and on the CPU, from
    one set of weights."""
    from deeplearning4j_tpu_torch import ComputationGraph
    base = _resnet("cpu")
    conf = base.conf
    conf.global_conf.dtype = "float64"
    params = {n: {k: v.double() for k, v in p.items()}
              for n, p in base.params.items()}
    return (ComputationGraph(conf, device="cuda").set_params(params),
            ComputationGraph(conf, device="cpu").set_params(params))


def _images(n, seed, classes=1000, size=224):
    r = np.random.RandomState(seed)
    x = r.rand(n, size, size, 3).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[r.randint(0, classes, n)]


def _bn_state_err(net, cpu):
    """The largest difference of the running statistics, relative to each
    tensor's largest magnitude."""
    return max(float((d[k].cpu() - cpu.state[n][k]).abs().max()
                     / max(cpu.state[n][k].abs().max().item(), 1e-30))
               for n, d in net.state.items() for k in d)


def resnet_part(card, res):
    """(c) ResNet50 at full width (224 x 224 x 3, 1000 classes) from its
    configuration's seed: /predict at B=1 and 32, two B=4 steps against
    the CPU port, captured against eager bit for bit, 20 captured steps at
    B=32, ten profiled."""
    import torch
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.serving import (InferenceClient,
                                                  InferenceServer)
    out = {}
    net = _resnet()
    out["num_params"] = net.num_params()
    cpu = ComputationGraph(net.conf, device="cpu").set_params(
        {n: {k: v.cpu() for k, v in p.items()} for n, p in
         net.params.items()}, net.state)
    srv = InferenceServer(net, port=0, max_latency_ms=2.0).start()
    cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
    try:
        for b in (1, RESNET_B):
            x, _ = _images(b, seed=b)
            ms = []
            for _ in range(6):
                t0 = time.perf_counter()
                probs = cli.predict(x)
                ms.append((time.perf_counter() - t0) * 1e3)
            if probs.shape != (b, 1000) or not np.isfinite(probs).all():
                raise AssertionError(f"phase 12 (c): /predict {probs.shape}")
            out[f"predict_ms_b{b}"] = ms
            if b == 1:
                err = float(np.abs(probs - cpu.output(x).numpy()).max())
                out["predict_b1_max_abs_err_vs_cpu"] = err
                if err > RESNET_TOL:
                    raise AssertionError(f"phase 12 (c): /predict vs CPU "
                                         f"{err}")
    finally:
        srv.stop()
    print(f"cnn (c): ResNet50 (224 x 224 x 3, 1000 classes, "
          f"{out['num_params']} parameters) /predict: B=1 median "
          f"{statistics.median(out['predict_ms_b1'][1:]):.2f} ms, B="
          f"{RESNET_B} median "
          f"{statistics.median(out[f'predict_ms_b{RESNET_B}'][1:]):.2f} ms "
          f"a request (first requests {out['predict_ms_b1'][0]:.1f} / "
          f"{out[f'predict_ms_b{RESNET_B}'][0]:.1f} ms); B=1 probabilities "
          f"against the CPU port: max abs err "
          f"{out['predict_b1_max_abs_err_vs_cpu']:.3g} [{card}]", flush=True)
    # against the CPU port at B=4: one float32 step, and two float64 steps
    # (this configuration's train-mode backward runs 53 batch
    # normalizations over sigmoid convolutions of near-constant output,
    # and loses most of float32's digits: on the CPU at 96 x 96 the
    # float32 port's second loss is 2-4% off its float64 one at any lr,
    # PERF.md; two float64 implementations stay close)
    x4, y4 = _images(RESNET_PARITY_B, seed=4)
    for m in (net, cpu):
        m.fit([x4], [y4])
    loss32 = (net.get_score(), cpu.get_score())
    loss32_err = abs(loss32[0] - loss32[1]) / abs(loss32[1])
    st32_err = _bn_state_err(net, cpu)
    del cpu
    losses, (net64, cpu64) = [], _resnet_float64()
    t64 = [torch.from_numpy(a).double() for a in (x4, y4)]
    for m in (net64, cpu64):
        xs4, ys4 = (t.to(m.device) for t in t64)
        ls = []
        for _ in range(2):
            m.fit([xs4], [ys4])
            ls.append(m.get_score())
        losses.append(ls)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    st_err = _bn_state_err(net64, cpu64)
    del net64, cpu64
    out.update(parity_float32_losses=loss32,
               parity_float32_loss_rel_err=loss32_err,
               parity_float32_state_rel_err=st32_err,
               parity_float64_losses=losses,
               parity_float64_loss_rel_err=loss_err,
               parity_float64_state_rel_err=st_err)
    print(f"cnn (c): ResNet50 at B={RESNET_PARITY_B} against the CPU port: "
          f"one float32 step, loss {loss32[0]} vs {loss32[1]} (relative err "
          f"{loss32_err:.3g}), BatchNormalization running mean and variance "
          f"within {st32_err:.3g} of each tensor's largest; two float64 "
          f"steps, losses {losses[0]} vs {losses[1]} (max relative err "
          f"{loss_err:.3g}), running statistics within {st_err:.3g} (tol "
          f"{RESNET_TOL}) [{card}]", flush=True)
    if max(loss32_err, st32_err, loss_err, st_err) > RESNET_TOL:
        raise AssertionError("phase 12 (c): card vs CPU port")
    # captured against eager, bit for bit, 3 steps
    xb, yb = _images(RESNET_B, seed=32)
    with deterministic_cudnn():
        cap, eager = _resnet(), _resnet()
        eager._capture_steps = False
        for m in (cap, eager):
            for _ in range(3):
                m.fit([xb], [yb])
        same = (_trees_equal(cap.params, eager.params)
                and _trees_equal(cap.state, eager.state))
        print(f"cnn (c): ResNet50, 3 captured steps at B={RESNET_B} "
              f"{'equal' if same else 'differ from'} 3 eager steps bit for "
              f"bit, parameters and running statistics ("
              f"{cap._capture_count} capture, deterministic cuDNN) "
              f"[{card}]", flush=True)
        if not same or cap._capture_count != 1:
            raise AssertionError(
                f"phase 12 (c): captured vs eager differ by "
                f"{_tree_diff(cap.params, eager.params)}")
        del cap
        # eager ms a step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            eager.fit([xb], [yb])
        torch.cuda.synchronize()
        out["eager_ms_per_step"] = (time.perf_counter() - t0) / 5 * 1e3
        del eager
    # 20 captured steps at B=32 (the default cuDNN algorithms)
    net = _resnet()
    xs, ys = (torch.from_numpy(a).cuda().reshape(
        (RESNET_STEPS, RESNET_B) + a.shape[1:])
        for a in _images(RESNET_STEPS * RESNET_B, seed=7))
    net.fit_scan([xs[:2]], [ys[:2]])         # warm-up and capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit_scan([xs], [ys])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss = net.get_score()
    out.update(captured_ms_per_step=wall / RESNET_STEPS * 1e3,
               images_per_s=RESNET_STEPS * RESNET_B / wall,
               captured_loss=loss, captures=net._capture_count)
    if not np.isfinite(loss):
        raise AssertionError("phase 12 (c): the loss is not finite")
    prof = profile_steps(lambda: net.fit_scan([xs[:CNN_PROFILE_STEPS]],
                                              [ys[:CNN_PROFILE_STEPS]]),
                         CNN_PROFILE_STEPS, (CONV_TAGS,))
    out["profile"] = prof
    busy = prof["device_busy_ms_per_step"]
    conv = (None if busy is None else
            prof["tagged_ms_per_step"][_tag(CONV_TAGS)] / busy)
    out["conv_share_of_busy"] = conv
    print(f"cnn (c): ResNet50, {RESNET_STEPS} captured steps at B="
          f"{RESNET_B}: {out['captured_ms_per_step']:.2f} ms a step "
          f"({out['images_per_s']:.0f} images/s; eager "
          f"{out['eager_ms_per_step']:.2f} ms a step, deterministic cuDNN), "
          f"last loss {loss:.4f}; {fmt_profile(prof, (CONV_TAGS,))}; "
          f"convolution kernels' share of busy time "
          + ("not measured" if conv is None else f"{conv:.1%}")
          + f" [{card}]", flush=True)
    res["resnet50"] = out


def _simplecnn_run(directory, crash=None, resume=False):
    """SimpleCNN (48 x 48 x 3, 5 classes) streaming 2 epochs of 16 uint8
    batches (shuffled, the device scaler) in chunks of 4, a checkpoint
    with the scaler every 4 iterations; ``crash`` stops it past that
    iteration in epoch 2, ``resume`` continues a fresh network from
    ``directory``."""
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.data.fetchers import (_synthetic_images,
                                                        _uint8_wire)
    from deeplearning4j_tpu_torch.data.normalizers import \
        ImagePreProcessingScaler
    from deeplearning4j_tpu_torch.resilience import CheckpointListener
    from deeplearning4j_tpu_torch.zoo import SimpleCNN
    x, y = _synthetic_images(512, 48, 48, 3, 5, seed=11)
    it = ListDataSetIterator(DataSet(_uint8_wire(x),
                                     np.eye(5, dtype=np.float32)[y]), 32,
                             shuffle=True, seed=5)
    scaler = ImagePreProcessingScaler(device_side=True)
    it.set_pre_processor(scaler)
    net = SimpleCNN(num_classes=5).init(device="cuda")
    net._CHUNK_MAX_STEPS = 4
    net.set_listeners(CallRecorder(crash))
    kw = ({"resume_from": directory} if resume else
          {"checkpoint": CheckpointListener(directory, every_n_iterations=4,
                                            normalizer=scaler)})
    try:
        net.fit(it, epochs=2, **kw)
    except FitInterrupted:
        pass
    return net, scaler


def simplecnn_resume_part(card, res):
    """(d) A checkpointed SimpleCNN fit interrupted and resumed: the
    parameters, the BatchNormalization state and the normalizer as the
    uninterrupted run's, bit for bit."""
    import shutil
    import torch
    from deeplearning4j_tpu_torch import latest_checkpoint
    from deeplearning4j_tpu_torch.util.model_serializer import \
        restore_normalizer
    whole, crashed = CNN_DIR / "whole", CNN_DIR / "crashed"
    shutil.rmtree(CNN_DIR, ignore_errors=True)
    try:
        with deterministic_cudnn():
            ref, scaler = _simplecnn_run(whole)
            _, _ = _simplecnn_run(crashed, crash=22)
            stopped = latest_checkpoint(crashed)
            resumed, _ = _simplecnn_run(crashed, resume=True)
        norm = restore_normalizer(stopped)
        same = (_trees_equal(ref.params, resumed.params)
                and _trees_equal(ref.state, resumed.state)
                and ref.iteration == resumed.iteration)
        print(f"cnn (d): SimpleCNN, 2 epochs of 16 uint8 batches with "
              f"dropout and BatchNormalization, checkpointed every 4 "
              f"iterations with its scaler, stopped past iteration 22 and "
              f"resumed from {Path(stopped).name}: parameters and running "
              f"statistics {'equal' if same else 'differ from'} the "
              f"uninterrupted run's bit for bit (iteration "
              f"{resumed.iteration}); the checkpoint's normalizer "
              f"{norm.to_dict() if norm else None} [{card}]", flush=True)
        if not same or norm is None or norm.to_dict() != scaler.to_dict():
            raise AssertionError(
                f"phase 12 (d): resume differs by "
                f"{_tree_diff(ref.params, resumed.params)}")
        if not any(torch.count_nonzero(d["mean"]) for d in ref.state if d):
            raise AssertionError("phase 12 (d): no running statistics")
    finally:
        shutil.rmtree(CNN_DIR, ignore_errors=True)
    res["simplecnn_resume"] = {"bitwise": same,
                               "iteration": resumed.iteration}


def cnn_phase(card):
    """Phase 12: the convolutional path (``chip_smoke.py`` docstring)."""
    from deeplearning4j_tpu_torch import ops
    res = {"card": card}
    ops.reset_launch_counts()
    for part in (cnn_serving_part, lenet_part, resnet_part,
                 simplecnn_resume_part):
        t0 = time.perf_counter()
        part(card, res)
        res[f"{part.__name__}_s"] = time.perf_counter() - t0
    res["launches"] = ops.launch_counts()
    if any(res["launches"].values()):
        raise AssertionError(f"phase 12 launched a hand-written kernel: "
                             f"{res['launches']}")
    return res


def counted_launches(tree, kernel):
    """The launches of ``kernel`` over every counted window (each dict
    entry ``launches``) of a phase's results."""
    if isinstance(tree, dict):
        return sum(v.get(kernel, 0) if k == "launches" and isinstance(v, dict)
                   else counted_launches(v, kernel) for k, v in tree.items())
    return 0


def serving_features_phase(card):
    """Phase 11: the prefix cache, chunked prefill, speculation and the
    captured engine (``chip_smoke.py`` docstring)."""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_ids
    ids, vocab = corpus_ids()
    ids = [int(t) for t in ids]
    net = TinyTransformer(vocab_size=len(vocab)).init(device="cuda")
    cpu = ComputationGraph(net.conf, device="cpu").set_params(net.params)
    res = {"card": card, "vocab": len(vocab)}
    prefix_part(net, cpu, ids, card, res)
    spec_part(net, ids, card, res)
    spec_lstm_part(card, res)
    captured_engine_part(net, cpu, ids, card, res)
    return res


def _tag(t):
    """A profile tag's name: a tuple of fragments is their union."""
    return "|".join(t) if isinstance(t, tuple) else t


def _tagged(t, name):
    return any(f in name for f in t) if isinstance(t, tuple) else t in name


def profile_steps(run, steps, tags):
    """``run()`` does ``steps`` fit steps (or returns how many steps it
    did); it is called once to warm up (timed, unprofiled) and once under
    torch.profiler. Returns the wall ms
    per step of both calls, the device's busy ms per step (the sum of its
    kernels' times: one stream, so they do not overlap) and idle share
    against each wall time, device operations per step, the ms per step of
    the kernels whose names hold each of ``tags``, the kernels with the
    most device time per step, and the host operations with the most self
    time per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    def did(done):
        return done if isinstance(done, int) else steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = did(run())
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / done * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = did(run())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"steps": steps, "wall_ms_per_step": wall,
           "unprofiled_wall_ms_per_step": plain_wall,
           "device_busy_ms_per_step": None, "top_host_ops": [
               [a.key, a.count // steps,
                round(a.self_cpu_time_total / 1e3 / steps, 4)]
               for a in sorted(prof.key_averages(),
                               key=lambda a: a.self_cpu_time_total,
                               reverse=True)[:12]]}
    if kernels:
        def ms(es):
            return sum(e.time_range.elapsed_us() for e in es) / 1e3 / steps
        busy = ms(kernels)
        by_name = {}
        for e in kernels:
            by_name.setdefault(e.name, []).append(e)
        out.update(
            device_busy_ms_per_step=busy, device_idle_share=1 - busy / wall,
            device_idle_share_unprofiled=1 - busy / plain_wall,
            kernels_per_step=len(kernels) / steps,
            tagged_ms_per_step={_tag(t): ms([e for e in kernels
                                             if _tagged(t, e.name)])
                                for t in tags},
            top_device_kernels=[
                [name[:80], len(es) / steps, round(ms(es), 4)]
                for name, es in sorted(by_name.items(),
                                       key=lambda kv: -ms(kv[1]))[:8]])
    return out


def fmt_profile(prof, tags, unit="step", units="fit steps"):
    """One line of a profile_steps result, per ``unit`` (one of the
    ``units`` that ``run`` did)."""
    busy = prof["device_busy_ms_per_step"]
    per = f"ms/{unit}"
    return (f"torch.profiler over {prof['steps']} {units}: "
            f"{prof['wall_ms_per_step']:.3f} {per} profiled, "
            f"{prof['unprofiled_wall_ms_per_step']:.3f} unprofiled; device "
            "busy " + ("not measured (no device events)" if busy is None else
                       f"{busy:.3f} {per} (idle "
                       f"{prof['device_idle_share']:.1%} profiled, "
                       f"{prof['device_idle_share_unprofiled']:.1%} "
                       f"unprofiled), {prof['kernels_per_step']:.0f} device "
                       f"operations/{unit}; " + ", ".join(
                           f"{_tag(t)} kernels "
                           f"{prof['tagged_ms_per_step'][_tag(t)]:.4f}"
                           f" {per}" for t in tags)
                       + f"; top device kernels "
                       f"{prof['top_device_kernels'][:4]}")
            + f"; host self time per {unit}, top: {prof['top_host_ops'][:5]}")


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
    for T, B, H in K3_SHAPES:
        for dtype in ("float32", "bfloat16"):
            rows.append(kernel_case("lstm_bwd", T, B, H, dtype))
            print("kernel: " + fmt(rows[-1]) + f" [{card}]", flush=True)
    k3_sizes = k3_hidden_sizes(K3_LARGEST_H - 8, K3_LARGEST_H + 8)
    print(f"kernel: lstm_bwd at T=1, B=32, float32 takes H in {k3_sizes} of "
          f"{K3_LARGEST_H - 8}..{K3_LARGEST_H + 8} [{card}]", flush=True)
    if K3_LARGEST_H not in k3_sizes:
        raise AssertionError(f"lstm_bwd no longer takes H={K3_LARGEST_H}")
    for T, B, H in K4_SHAPES:
        for kernel in ("lstm2_fwd", "lstm2_fwd_train"):
            for dtype in ("float32", "bfloat16"):
                rows.append(kernel_case(kernel, T, B, H, dtype))
                print("kernel: " + fmt(rows[-1]) + f" [{card}]", flush=True)
    k4_sizes = k4_hidden_sizes(K4_LARGEST_H - 8, K4_LARGEST_H + 8)
    for name, sizes in k4_sizes.items():
        largest = max(sizes, default=None)
        print(f"kernel: {name}, T=1, float32 takes H in {sizes} of "
              f"{K4_LARGEST_H - 8}..{K4_LARGEST_H + 8}: largest {largest} "
              f"[{card}]", flush=True)
        if largest is None or largest < K4_LARGEST_H:
            raise AssertionError(f"{name} no longer takes H={K4_LARGEST_H}")
    for T, B, H in K12_SHAPES:
        for kernel in ("lstm_fwd", "lstm_fwd_train"):
            for dtype in ("float32", "bfloat16"):
                rows.append(kernel_case(kernel, T, B, H, dtype))
                print("kernel: " + fmt(rows[-1]) + f" [{card}]", flush=True)
    k12_sizes = k12_hidden_sizes(K12_LARGEST_H - 8, K12_LARGEST_H + 8)
    for name, sizes in k12_sizes.items():
        largest = max(sizes, default=None)
        print(f"kernel: {name}, T=1, float32 takes H in {sizes} of "
              f"{K12_LARGEST_H - 8}..{K12_LARGEST_H + 8}: largest {largest} "
              f"[{card}]", flush=True)
        if largest is None or largest < K12_LARGEST_H:
            raise AssertionError(f"{name} no longer takes H={K12_LARGEST_H}")
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
        for B, pos in ((1, [511]), (8, None), (64, None)):
            rows.append(attn_kernel_case(kernel, B, 512, pos=pos))
            print("kernel: " + fmt_attn(rows[-1]) + f" [{card}]", flush=True)
    # head dims past 128: K5-K9 through the column-chunk split, 2 heads
    for dh in WIDE_HEAD_DIMS:
        for T in (64, 100):
            for causal in (False, True):
                rows.append(attn_kernel_case("flash_attn_fwd", 2, T, causal,
                                             dh=dh, heads=2))
                print("kernel: " + fmt_attn(rows[-1]) + f" [{card}]",
                      flush=True)
                pair = bwd_kernel_case(2, T, causal, dh=dh, heads=2)
                rows.extend(pair)
                print("kernel: " + fmt_bwd(pair) + f" [{card}]", flush=True)
            for kernel in ("flash_decode", "flash_decode_paged"):
                rows.append(attn_kernel_case(kernel, 4, T, dh=dh, heads=2))
                print("kernel: " + fmt_attn(rows[-1]) + f" [{card}]",
                      flush=True)

    res = slice_phase(card)
    t0 = time.perf_counter()
    f4 = f4_phase(card)
    f4["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiny = transformer_phase(card)
    tiny["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = wide_head_phase(card)
    wide["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = train_phase(card)
    train["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiny_train = tiny_train_phase(card)
    tiny_train["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    captured = captured_train_phase(card)
    captured["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    regularised = regularised_phase(card)
    regularised["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit_contract = fit_contract_phase(card)
    fit_contract["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving = serving_features_phase(card)
    serving["phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cnn = cnn_phase(card)
    cnn["phase_seconds"] = time.perf_counter() - t0

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
        if "floor_ms" in row:          # K8/K9: the launch floor and plan
            entries[-1].update(floor_ms=row["floor_ms"], plan=row["plan"])
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
    mid = DECODE_MID
    for kernel, kind in (("flash_decode", "dense"),
                         ("flash_decode_paged", "paged")):
        row = attn_kernel_case(kernel, 8, 512, pos=mid, seed=1)
        print("main-path shape: " + fmt_attn(row) + f" [{card}]", flush=True)
        by_path = {f"tiny {kind} /generate":
                   tiny[f"launches_{kind}"][kernel],
                   "phase 11": counted_launches(serving, kernel)}
        entry(kernel, row, sum(by_path.values()))
        entries[-1]["launches_by_path"] = by_path
    # the wide-head phase's shapes (Dh 256, 2 heads): /predict of 15 windows
    # (bucket 16, T=64, causal), train steps (B=32, T=64), the engines; K5-K7
    # also at Dh 128 (one chunk), the split's cost beside it
    wide_dh = WIDE_D_MODEL // WIDE_HEADS
    for dh in (wide_dh, CHUNK_COLUMNS):
        rows.append(attn_kernel_case("flash_attn_fwd", 16, 64, True, seed=1,
                                     dh=dh, heads=WIDE_HEADS))
        print("wide-phase shape: " + fmt_attn(rows[-1]) + f" [{card}]",
              flush=True)
        rows.extend(bwd_kernel_case(TINY_B, TINY_T, True, seed=1, dh=dh,
                                    heads=WIDE_HEADS))
        print("wide-phase shape: " + fmt_bwd(rows[-2:]) + f" [{card}]",
              flush=True)
    for kernel in ("flash_decode", "flash_decode_paged"):
        rows.append(attn_kernel_case(kernel, 8, 512, pos=mid, seed=1,
                                     dh=wide_dh, heads=WIDE_HEADS))
        print("wide-phase shape: " + fmt_attn(rows[-1]) + f" [{card}]",
              flush=True)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "kernel_rows": rows, "k3_hidden_sizes": k3_sizes,
         "k4_hidden_sizes": k4_sizes, "k12_hidden_sizes": k12_sizes,
         "slice": res, "f4": f4, "tiny": tiny, "wide": wide,
         "train": train, "tiny_train": tiny_train, "captured": captured,
         "regularised": regularised, "fit_contract": fit_contract,
         "serving_features": serving, "cnn": cnn, "kernels": entries},
        indent=1))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
