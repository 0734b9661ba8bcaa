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
   positions spread over 0..511 (one stream at 511), over a float32 and
   over a bfloat16 cache or pool (a bf16-compute model's decode state,
   read in its own type; the plain version widens it exactly, so both
   hold to 1e-4), each with its plan (blocks per cluster S, clusters),
   20 more launches that must repeat bit for bit, and its launch floor
   (an empty kernel on the same grid and cluster shape, timed the same
   way); the bound counts the cache's bytes at its width. Then head dims
   past 128, which the attention kernels take through their column-chunk
   split: K5, K6 + K7 (B=2 x 2 heads) and K8, K9 (B=4, 2 heads; both
   cache types) at Dh in {136, 256, 520} and T (or C) in {64, 100}, causal
   and not, at the same tolerances, K6 and K7 repeating bit for bit. With CUDA-event medians of the kernel,
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
   of 32 new tokens from held-out prompts of 16..64 tokens, in six parts:
   the plain dense engine; the plain paged engine with the prefix cache
   and chunks of 32; the target as its own draft (k=4), dense; the seed-3
   draft with tree (3, 2, 2), dense, paged, and paged with chunks of 32
   (speculation with chunked prefill); and the TextGenerationLSTM with
   ``early_exit:1``, tree (3, 2), dense. Each part runs the eager engine
   (the ``_capture_programs = False`` seam) and the captured one in turns
   over 2 rounds in this call: tokens identical between them and across
   rounds, greedy tokens against ``generate_naive`` under the near-tie
   rule, the launches of every round exactly the plain steps', verifies'
   and draft steps' (as (b)), each program one capture whose replay
   launches its K8 or K9 once an attention layer (and position for the
   draft) and nothing for a chunk or a copy, no new capture after
   ``warmup()``, ``trace_count`` 1, no block in use at the end; ms a step
   (plain: decode seconds a step) or a tick (wall a verify) eager and
   captured, min / median / max of the 2 rounds; ten captured steps or
   ticks under ``torch.profiler``; the counters of 3 prompts one at a time
   (16 new tokens) against the CPU port's where the tokens agree.
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
13. The Inception zoo, the special layers, pretraining, the evaluations
   and the iterator wrappers (``inception_phase``), which run no
   hand-written kernel: every kernel count must stay 0. (a)
   InceptionResNetV1 at the zoo's defaults (160 x 160 x 3, 1000 classes,
   Adam) from its configuration's seed, on numpy images: /predict at B=1
   and B=32 (ms a request; B=1 within 1e-3 of the CPU port), the
   ``embeddings`` of 32 images of unit norm within 1e-5; at B=4 one
   float32 step (loss and running statistics within 1e-3 of the CPU
   port, the center-loss centers reported) and two float64 steps (loss,
   running statistics and centers within 1e-3), the card's dropout draws
   replayed into the CPU port; 3 captured steps at B=32 equal 3 eager ones
   bit for bit (deterministic cuDNN), eager ms a step; 20 captured steps
   at B=32 (ms a step, images/s) and ten profiled (busy ms, idle share,
   device operations, cuDNN's convolution share). (b) FaceNetNN4Small2 (96
   x 96 x 3) and GoogLeNet (224 x 224 x 3), 1000 classes: /predict at B=1
   within 1e-3 of the CPU port, one float32 B=4 step within 1e-3 of it
   (loss and running statistics; GoogLeNet's Nesterovs step also the
   parameters, against the step's largest update), 5 captured steps at
   B=32. (c) RBM(784 -> 500, k=1) -> AutoEncoder(500 -> 250, corruption
   0.3) -> softmax on ``MnistDataSetIterator(128, num_examples=6400)``:
   each layer's first
   pretrain step, fed the card's draws, within 1e-4 of the CPU port's;
   then ``pretrain`` 1 epoch, ``fit`` 3 epochs and held-out accuracy on
   2000 test images above the CPU port's 0.6690 less 0.03; a
   VariationalAutoencoder(784, (256,), (256,), nZ 32, Bernoulli) network:
   its first step within 1e-4 of the CPU port's, 2 epochs of pretraining
   lowering a held-out batch's -ELBO, ``reconstruct`` and ``generate`` of
   the right shapes in [0, 1]. (d) LeNet with both convolutions in
   FrozenLayer, 5 captured steps: the frozen parameters as they started
   bit for bit and without updater state, the others moved, losses and
   parameters within 1e-4 of the CPU port's; Yolo2OutputLayer at the VOC
   layout (yolo-voc.cfg's 5 anchors, 20 classes, 125 channels, a 13 x 13
   grid) on five stride-2 3 x 3 convolutions and a 1 x 1 one over 416 x
   416 x 3 synthetic images and labels: loss and gradients within 1e-4 of
   the CPU port's, 5 captured steps. (e) LeNet on MNIST's uint8 wire
   through ``AsyncDataSetIterator(base, workers=2)`` equals it through
   the base bit for bit, ``MultipleEpochsIterator(3, base)`` equals
   ``epochs=3`` (ms a step and ``host_stall_frac`` of each), and ROC,
   ROCMultiClass, EvaluationBinary, RegressionEvaluation and
   EvaluationCalibration of the card's outputs on 2000 test images equal
   the CPU port's within 1e-6. The phase prints its seconds.
14. The host KV tier, KV-chain migration, the request journal and the
   pool's health signal (``kv_tier_phase``), on TinyTransformer at its
   full default width from the configuration's seed, every engine a
   captured paged one (8 slots, max_len 512, kv_block_size 16, chunks of
   32, the prefix cache) fed corpus prompts of 128 tokens that each open
   with their own token (no copy-on-write between them). (a) A pool of 97
   blocks and a 64 MiB host tier: wave A (8 greedy streams of 64 new
   tokens), wave B (8 other prompts: it needs the whole pool, so it
   evicts, and spills, A's cached blocks) and wave C (A's prompts again:
   each restores its 7 claimable blocks and evicts B's). Bars: every
   wave's tokens equal, bit for bit, the same engine's without a tier
   (which prefills C again); at least 112 spills and exactly 56
   restores; every C request a prefix hit of 112 tokens with 7 restores
   in its journal record; K9 exactly twice a plain step; no capture
   after ``warmup()``, ``trace_count`` 1, the programs unchanged, every
   pool leaf at its address; no block in use at the end; a
   ``swap_weights`` of a seed-7 TinyTransformer leaves the tier empty and
   no chain head. Reported: time to first token of wave C with and
   without the tier (median, max, from the journal), ms an eviction, the
   batched reads of evicted blocks (blocks, ms) and the restore batch,
   the tier's bytes a block. (b) Two engines with the default pool: the
   source runs wave A, then each prompt's claimable chain (7 blocks) is
   exported, sent through JSON and imported into the destination (7
   imported, none duplicate, no kernel launched); the destination's
   tokens for A equal the source's bit for bit, 8 hits of 112; its
   re-export gives the same leaf data, a re-import 0 imported and 7
   duplicate; a payload with one base64 character changed, one from a
   kv_block_size-32 engine and one from a d_model-64 TinyTransformer are
   rejected (``torn``, ``block_size``, ``model_sig``) with the
   destination's pool unchanged and the reject counter moved; exports
   taken while 8 other streams decode on the source leave their tokens
   equal to (a)'s tierless wave B; a card payload imported into the CPU
   port and a CPU payload into the card continue under the near-tie
   rule. Reported: ms an export and an import (median of 8), the
   payload's bytes, time to first token after the import against the
   source's cold prefill. (c) Over HTTP: (b)'s engines behind
   ``InferenceServer``s, a dense engine (K8), a 4-slot engine whose queue
   holds 2 (40 blocks) and a /predict server whose journal keeps 8:
   /kv/export, /kv/import, then /generate on the second equals the first;
   a torn payload answers 409 ``kv_migrate_rejected``, the dense server
   404; ``/requests`` records with ``x-request-id`` echoed or minted,
   ``x-tenant`` / ``x-priority`` carried, the phases queue, prefill and
   decode and the ``kv`` fields, ``?n=junk`` 400; a burst of 16 on the
   4-slot engine answers 429s, each with one ``shed`` record; ``/healthz``
   reads ``degraded`` / ``kv_pool_exhausted`` with the pool while a
   request of 32 blocks waits behind another, ``ok`` after; 12 /predict
   records (K5) carry bucket, pad, device and readback and the journal
   wraps (total - dropped = 8); ``/metrics`` renders the tier, migration
   and time-to-first-token series; the p99 time to first token's
   exemplar resolves to a ``/requests`` record; exactly K9 twice a paged
   step, K8 twice a dense step and K5 twice a /predict forward.

15. The serving precisions and the bucketed engine's program contract
   (``serving_precision_phase``). (a) The bundled TextGenerationLSTM
   through ``InferenceEngine(net, 32, precision=...)`` at f32, int8 and
   fp8: ``warmup`` captures the ladder 1..32 (rungs and their costs);
   held-out top-1 of the 15 windows (int8 within 0.01 and fp8 within 0.02
   of f32, docs/QUANTIZATION.md), weight bytes, the card against the CPU
   port at the same precision (1e-4), 13 mixed-size /predict calls with
   no new capture and no new program, the captured rungs equal to an
   eager engine's bit for bit, exactly one K4 a forward, /predict ms at
   B=1 and B=32 (captured and eager, median of 20). (b) TinyTransformer
   at its default width from its seed on captured dense and paged engines
   (8 slots, max_len 512, blocks of 16) at f32, with bfloat16 compute (a
   bfloat16 cache and pool: K8 / K9's bfloat16 instantiation), int8 and
   fp8: 8 greedy streams of 64 tokens from held-out prompts of 16..58
   tokens against the CPU port's engine at the same precision under the
   near-tie rule (1e-4; 2e-2 in bfloat16, against the reference's
   dequantized or bfloat16 forward), K8 / K9 exactly twice a step, one
   capture a program, ms a captured step, tokens/s, weight bytes, and ten
   dense steps of each under ``torch.profiler`` (the dequantization's
   device operations and busy ms a step: int8's or fp8's less f32's).
   (c) ``SpecConfig(self_draft="int8" | "fp8", k=4)`` on the dense f32
   engine: tokens against the plain engine's under the near-tie rule,
   exact launches, acceptance, tokens/s against the plain captured
   engine's. (d) Over HTTP at int8 (a dense captured decode engine and a
   max_batch-16 /predict engine): ``/warmup`` captures 1..16 (run on the
   decode loop's thread); ``/admin/swap`` of a seed-7 zip while 8
   /generate streams and mixed /predict run answers version 1, after
   which ``x-model-version`` is 1, /generate equals a fresh int8 engine's
   on the seed-7 weights token for token and /predict a fresh engine's
   (1e-6), and no capture follows ``/warmup``; a d_model-64 zip answers
   409 ``weight_mismatch`` and a payload without ``checkpoint`` 400, with
   serving unchanged; K5 twice a /predict forward and K8 twice a decode
   step. The phase prints its seconds.

16. Observability over the captured engines and train steps
   (``observability_phase``), TinyTransformer at its default width and
   the LSTM recipe (B=32, T=64). (a) A server with a max_batch-16
   /predict engine and a dense decode engine, and a paged engine (8
   slots, max_len 512, blocks of 16): ``/warmup`` captures 1..16; ``GET
   /programs`` lists every captured program of the three engines (rungs
   ``b{B}``, ``step``, ``cow``) with flops, bytes, graph-pool bytes and
   compile seconds, and reading it adds no program and no capture; each
   record's launches equal the launch counts over N replays divided by N
   (rung 16, both steps); the hand kernels' flops of rung 16 and of both
   steps equal ``attn_work``'s at the program's shape (K5 causal at BH 64,
   T=64; K8 / K9 over each slot's whole capacity), once an attention
   layer. (b) A /predict and a /generate with ``x-trace-context``: ``GET
   /trace`` holds ``http_request``, ``enqueue``, ``bucket``, ``pad``,
   ``device``, ``readback`` and ``decode_step`` spans with their trace
   ids, and so do the ``/requests`` records; the dense decode step's ms
   (8 streams of 32 tokens) with tracing off and on, 5 rounds each. (c)
   ``POST /admin/profile`` for 2 s under /generate traffic to the dense
   and the paged engine: 200, a second request 409 ``profile_busy``, and
   the written trace names K8 and K9 (``flash_decode_kernel`` instances,
   launched from graph replays). (d) Each recipe (LSTM: K4-train and K3;
   TinyTransformer: K5-K7) captured for 20 steps from one init, the
   recorder attached after 2 at ``sample_every`` 1 and 4: parameters and
   updater state bit for bit the recorder-off run's, captured = eager
   with the recorder (parameters and rows), one capture when attached,
   records at the sampled iterations, rows within 1e-4 of a float64 host
   computation from the parameters before and after each step and its
   gradients; ms a captured step (one fit_scan of 40 steps after 34 that
   capture both graphs, 3 rounds; the corpus's windows at stride 2) with
   the recorder off, at K=1 and at K=16; then a NaN planted in one
   feature of one example of the LSTM recipe: the spill, ``GET
   /train/diagnostics`` and ``/healthz`` (``train_non_finite``) name
   layer 0. The phase prints its seconds; its launches join the kernels
   line (K3, K4-train, K5-K9).
17. The routed tier from an AOT artifact (``routed_phase``),
   TinyTransformer at its default width. (a) A /predict engine (rungs
   1..16), a dense and a paged decode engine (8 slots, max_len 512)
   ``warmup(aot=)`` against no artifact: they trace and save one
   (recipes under the JAX package's keys, the six kernel libraries);
   fresh engines restore from it: no trace, one restore (and one
   capture) a program, registry records equal the traced ones, outputs
   and tokens (greedy and seeded) bit for bit the traced engines'; each
   engine's ``warmup_seconds`` traced against restored; launches exact.
   (b) Cold start: phase 2's nvcc seconds per source; a ``tinyattn``
   ``ReplicaProcess``'s ready seconds over the built tree without an
   artifact, and with ``--aot`` from a copy of the package whose
   ``build/`` is empty: its libraries must be the artifact's (sha256)
   and its log must show no nvcc run. (c) A ``Router`` over two
   in-process servers on the restored engines (dense and paged decode)
   and a ``tinytransformer`` ``ReplicaProcess`` from the artifact, under
   a storm of /predict and /generate from 4 clients: ``POST /chaos``
   503s at one server (failed over), a SIGKILL of the subprocess and its
   ``--aot`` restart, one ``rolling_restart`` (the in-process servers
   restart over their captured engines), one hedged /predict won by the
   hedge, then a scripted fast 503 ``retry_budget_exhausted``; no other
   client-visible error, /predict within 1e-4 of one engine, greedy
   tokens equal under the near-tie rule, and K5 / K8 / K9 launched in
   this process exactly as the engines' calls and steps call for. (d)
   Scale from zero: a /generate held by ``hold_for_capacity_s`` wakes
   the ``Autoscaler``, a ``ReplicaProcess(aot=...)`` comes up and serves
   it (the held seconds printed); idle, the fleet drains to zero and the
   process exits. Its launches join the kernels line (K5, K8, K9).
18. Data parallelism (``dp_phase``): ``parallel.ParallelWrapper``,
   ``ParallelInference``, the process group, threshold compression, the
   training masters and ``scaled_dot_product_attention``'s offsets. (a)
   The LSTM recipe (TextGenerationLSTM, 2 x LSTM(256), B=32, T=64) under
   ``ParallelWrapper(workers=4)`` in this process (world 1) for 20 steps
   against 20 plain ``fit`` steps from the same parameters and batches:
   parameters within 1e-5 (and whether bit for bit), exactly one K4-train
   and two K3 a step; a 30-row batch over 4 slots (two pad rows): the
   gradient program's gradient and loss within 1e-5 of the container's on
   the 30 rows; ms a captured step against the plain fit's (median of
   the last 10). (b) TinyTransformer at its default width (B=32, T=64)
   under ``averaging_frequency=4`` over 4 slots for 8 rounds: round 0
   against the CPU port's plain ``fit`` of each slot's rows from the same
   parameters, averaged (within 1e-4 of max |param|; the attention key
   biases, whose gradient is 0 in exact arithmetic and which Adam steps
   by up to lr on rounding noise, within 2 x lr x k); exactly 4 x 4 x 2
   of each of K5, K6 and K7 a round; the score falls; ms a round. (c) Two
   subprocesses (``--dp-rank``), each a gloo rank on this card with its
   ``local_batch_slice`` (16 rows) of the LSTM recipe, 10 sync steps:
   both ranks' parameters bit for bit, within 1e-5 of (a) after 10 steps;
   ms a step and the all-reduce's ms (host seconds of the blocking calls)
   and bytes a step; the ranks' launches are printed, not counted here.
   (d) A one-rank NCCL group runs (a)'s sync step 5 times: parameters bit
   for bit (a)'s after 5 steps, and the NCCL all-reduce of the step's
   gradient bytes timed by CUDA events. (e) ``ParallelInference`` over 4
   slots: ``output()`` of 15 held-out windows bit for bit the model's
   ``output`` on TextGenerationLSTM (one K4) and TinyTransformer (two
   K5), then ``warmup`` on this thread and seven ``submit()`` calls of 3
   rows merged by the worker thread, within 1e-5 of their unbatched
   forwards. (f) ``SharedTrainingMaster``, two workers over 10 recipe
   batches (lr 1, threshold 1e-3): the mean score falls, one K4-train and
   two K3 a batch; ``threshold_encode`` / ``threshold_decode`` of one
   recipe gradient on the card give the CPU port's count and indices, and
   the decoded values bit for bit. (g) ``scaled_dot_product_attention``
   (B=16, 4 heads, Dh=32, causal): q_offset 64 over 128 keys against
   float64 (no kernel), and zero offsets through one K5 against the CPU
   port, 1e-4. Its launches join the kernels line (K3, K4, K4-train,
   K5-K7); under 90 s.
19. The elastic cluster (``cluster_phase``): ``exec.cluster.
   ClusterManager`` spawning ``python -m deeplearning4j_tpu_torch.exec.
   worker --device cuda`` processes that share the card, ``charlstm``
   (LSTM(24), T=16, vocabulary 16) at full width, 32 rows a step; K2 and
   K3 first at the workers' shape (T=16, B=16, H=24) against their plain
   versions. (a) 2 workers, 8 steps, an anchor every 4, over the chain and
   over the star: every digest bit for bit
   ``single_process_reference(world=2)`` run in this process; each worker
   one K2 and one K3 a step it ran (its own counters, in its result);
   ms a step, the allreduce's ms, bytes each way. The chain job, the star
   job and (c)'s threshold job are independent and run side by side (six
   worker processes on the card), each held to its checks as if alone;
   their ms a step are taken beside each other. (b) (a)'s chain run with
   ``die_at_step=5`` on worker 1: 3 spawns, 1 replacement, generation >=
   2, the final digest (a)'s; the replacement restores the step-4 anchor
   and the artifact's recipes (``aot_restored`` >= 1, none rejected: its
   captures' launches are the recipes'); the seconds from the kill to its
   first step. (c) 3 workers, 700 ms a step, ``partition=[2]``,
   ``replace=False``: w2's link starved after step 2, its lease expires,
   the grace window commits world 2, the job finishes with the survivors'
   pids unchanged; then ``codec="threshold"`` on 2 workers: one digest,
   compression > 2x, the final loss within 0.05 of the dense chain's
   (the stream is uniform random tokens, so the loss cannot fall below
   ln 16). (d) The data plane alone: two in-process ``ChainComms`` members
   carry widemlp's vector (3154948 float32), dense and threshold, against
   the star over HTTP; dense = star bit for bit. The oracle's launches
   join the kernels line (K2, K3); the workers' are printed apart, under
   ``charlstm`` in the K2 and K3 entries with the phase-19-shape numbers.
20. Model parallelism (``mp_phase``), at TinyTransformer's zoo width
   (d_model 128, 4 heads, Dh 32, FFN 512, vocabulary 51, causal). (a) TP
   x DP: the TinyTransformer (2 blocks, T=64, 32 rows a step, Sgd 0.05)
   through ``ParallelWrapper`` on a (data 4, model 2) mesh of 8 slots, 10
   ``fit`` steps and a ``fit_scan`` of the same batches, each held
   against the one-slot plain fit on the card (rtol 1e-4, atol 1e-5) and
   the ``fit`` run against the CPU port (1e-4 of max |param|); exactly 4
   K5, 4 K6 and 4 K7 a step (2 blocks x 2 model shards: one gradient
   call covers the rank's data slots); ms a captured TP step against the
   one-slot step's; then JAX's TP dense net (8-32-16-4) and LeNet at 16
   x 16 against one slot (conv 2e-4 / 1e-4). (b) ``ring_attention`` at
   B=4, T=4096, 4 heads, Dh 32 over a ("seq",) mesh of 4 slots, causal
   and not, against one full K5 launch and the plain recurrence (1e-4):
   exactly 10 / 16 K5; ms of the ring against the full K5; the causal
   ring on bfloat16 inputs (float32 around the kernels, the result
   bfloat16) against the plain recurrence over the same inputs (2^-8 of
   max), exactly 10 K5; then ``SequenceParallelAttention`` over a
   TinyTransformer attention layer (B=4, T=256): the output and the
   input and weight gradients against the layer's own K5 / K6 + K7 path
   (1e-4 of max |grad|; the key bias, 0 in exact arithmetic, of the
   query bias's), exactly 10 each of K5, K6 and K7. (c) GPipe: four
   TinyTransformer blocks (from a 4-block zoo net) as the stages of a
   ("pipe",) mesh of 4 slots, B=32 as 8 microbatches, T=64:
   ``pipeline_forward`` against the sequential blocks (1e-5 of max |y|),
   5 ``fit_batch`` steps (Sgd 0.05, MSE to a random target) against
   sequential autograd SGD steps (1e-4 of max |param|); exactly 32 K5 a
   forward and 32 of each of K5-K7 a step; ms a step against the
   sequential step's. (d) ``moe_ffw`` (d_model 128, d_hidden 512, 8
   experts) on an ("expert",) mesh of 8 slots over 2048 tokens at
   capacity 1.25 and at an ample one, against the unsharded layer on the
   card and the CPU port (1e-5, the same dropped tokens) and at ample
   capacity ``moe_ffw_dense_reference``; 5 SGD steps on MSE + 0.01 x
   aux; no hand kernel. (e) TP through the default mesh
   (``set_default_mesh`` of a (data 4, model 2) mesh of 8 slots, the
   counterpart of ``DL4JTPU_MESH=model=2`` with ``DL4JTPU_SLOTS=8``): the
   same TinyTransformer's own ``fit`` for 10 captured steps (the rows
   whole: 8 a data slot, under the executor's floor of 16) and one
   ``fit_scan`` of the same batches on an executor whose floor is 2 (the
   rows split over the data axis), each against the one-slot fit on the
   card (rtol 1e-4, atol 1e-5), ``fit`` also against the CPU port (1e-4
   of max |param|), exactly 4 each of K5-K7 a step; host ms a step,
   median and least, beside one slot's; a warmed bucketed /predict of 8
   held-out windows through ``InferenceServer`` over the engine's shard
   set (exactly 4 K5 a forward) against the unsplit forward (1e-5); 8
   concurrent greedy /generate streams through a dense and a paged
   engine over head-split caches against the same engines on one slot
   (the near-tie rule), exactly 4 K8 / K9 a step. (f) What a model axis
   used to refuse, on the same default mesh and TinyTransformer (8 slots,
   max_len 256, 8 greedy streams of 24 new tokens from corpus prompts of
   16..48): the TP plain dense engine against one slot's (the near-tie
   rule; host ms a step of each, as information); speculation over head
   shards, the target as its own draft (k=3) on a dense engine and a
   seed-3 one-block draft with tree (2, 2) on a paged one, against the TP
   plain engine's tokens: exactly 4 K8 / K9 a plain step, 4 K8 a verify
   (2 layers x 2 shards), 2 K8 a draft step and draft attention layer; a
   paged engine with the host tier (4 prompts of 64 twice over 13 blocks
   of 16: spills and restores) with the tierless engine's tokens, 4 K9 a
   step and none a spill or restore; a chain exported from a TP paged
   engine continued in an unsplit one and the reverse (a prefix hit, the
   exporter's tokens); int8 and fp8 over quantized shard sets: a warmed
   /predict of 8 windows against one slot's engine at the same precision
   (1e-5; 4 K5 a forward) and /generate (int8 dense, fp8 paged) against
   one slot's (4 K8 / K9 a step); the TP ``fit`` (T=64, B=32, Sgd 0.05,
   6 captured steps) with a flight recorder (K=2; its rows against one
   slot's at rtol 1e-4) and with DropConnect(0.9) on every layer and
   maxnorm(1.0) on the row-split ff2 weights (rtol 1e-4, atol 1e-5), and
   3 steps in the bf16 policy, each from one slot's float32 masters (the
   step's parameter change within 2^-8 of one slot's in norm, each
   leaf's within 2^-6 plus 1e-5; the parameters float32; the last score
   at rtol 1e-4), exactly 4 each of K5-K7 a step; the TextGenerationLSTM
   (2 x LSTM(256), Sgd 0.05) TP tBPTT(16) ``fit`` of 3 batches against
   one slot (rtol 1e-4, atol 1e-5), each batch on either exactly 8 K2 +
   8 K3 (2 + 2 a chunk). Each part's failure fails the run; (a)-(c), (e) and
   (f) join the kernels line's K2, K3 and K5-K9 launches; under 60 s.
21. Training tools and the online loop (``tools_phase``), on
   TextGenerationLSTM (2 x LSTM(256), the corpus's vocabulary, B=32,
   T=64) from seed 123. (a) ``EarlyStoppingTrainer`` with
   ``MaxEpochs(4)``, ``ScoreImprovement(2)``, ``DataSetLossCalculator``
   on the 15 held-out windows and ``InMemoryModelSaver``, 4 batches an
   epoch: the epoch scores bit for bit those of a hand loop of
   ``_fit_batch`` + ``score`` on a twin from the seed, the best model
   read back bit for bit the twin's parameters after that epoch; exactly
   one K4-train and two K3 a step and one K4 a score. (b) Layer 0 frozen
   by ``TransferLearning.Builder`` with ``Sgd(0.05)``, 6 ``fit`` steps
   (exactly one K1 -- the frozen LSTM in inference mode --, one K2 and
   one K3 a step: the pair screen fuses no frozen layer), and the same
   through ``TransferLearningHelper`` (``featurize``: one K1 a batch;
   ``fit_featurized``: one K2 and one K3 a step): the frozen and the
   source net's parameters bit for bit, the two tails within 1e-5 of
   max |p|. (c) ``LBFGS``, ``ConjugateGradient`` and
   ``LineGradientDescent``, 5 iterations on one full batch: each score
   history non-increasing, the first line-search step and score equal
   (score rtol 1e-4) to one iteration of the same solver on a CPU copy,
   exactly one K4-train and two K3 a value-and-gradient probe; then 3
   captured ``fit`` steps from the solver's parameters bit for bit a
   twin's given them. (d) The online loop: two ``InferenceServer``s of
   the seed's net (engines warmed 1..32) serve /predict; a second net
   (with a ``FlightRecorder`` and a ``StatsListener``) trains from an
   ``InMemoryBroker`` topic through ``NDArrayPubSubRoute`` in rounds of
   4 batches under ``OnlineTrainer`` and ``BatchGuard``; the
   ``PromotionGate`` scores candidate and incumbent on the held-out
   windows and on ``TrafficMirror``'s tap of live /predict, and
   ``Deployer`` promotes through ``ServerTarget`` and ``HttpTarget``. A
   bootstrap round runs before the client thread starts (the trainer's
   step is captured with nothing else on the card), two clean rounds
   and a forced regression (8 batches of labels rolled over the
   vocabulary, promoted anyway, rolled back by the regression watch)
   run under its /predict traffic: no request fails, each server's
   ``X-Model-Version`` rises, ``trace_count`` does not move, and after
   the rollback both servers (in process and over HTTP) give the pinned
   incumbent's output bit for bit, the incumbent's zip swapped into a
   fresh engine included; exactly one K4-train and two K3 a step and
   one K4 a forward (the guard's, post-step and gate scores, the
   servers' dispatches). Each part's seconds and the phase's are
   printed; its launches join the kernels line's K1-K4 and K4-train
   (``launches_phase_21`` in each entry); under 60 s.
22. Keras model import and the embedding libraries (``import_phase``).
   Each model is a Keras 2 file whose weights come from
   ``np.random.default_rng``, held in a dict-backed stand-in for the
   open HDF5 file (``KerasStandIn``) and fed to the importer's private
   half, which reads any mapping, so the phase needs no h5py (the CPU
   tests read real .h5 files through the public importers). (a)
   The zoo's char model at full width, (None, 64, 77) -> 2 x LSTM(256,
   sigmoid gates, ``return_sequences``) -> Dense(77, softmax), categorical
   cross-entropy and Adam, imported on the card and on the CPU (the
   parameters bit for bit): ``output`` at B=32 within 1e-4 of the CPU
   copy with exactly one K4; 3 ``fit`` steps at B=32, T=64, losses within
   rtol 1e-4 and the parameters within 1e-4 of max |param| of the CPU
   copy's, exactly one K4-train and two K3 a step.
   (b) LSTM(256) -> LSTM(256, ``return_sequences=False``, so
   ``LastTimeStep``) -> Dense(5): exactly two K1 a call; (c) the same
   with ``hard_sigmoid`` gates: nothing launched (the layers' own loop);
   each within 1e-4 of its CPU copy. (d) ``Word2Vec`` skip-gram NEG on
   the JAX suite's clustered corpus passes its cluster checks,
   ``DistributedWord2Vec`` over a 4-slot mesh on the card repeats bit for
   bit across two runs and clusters, ``DeepWalk`` on two 6-cliques puts
   same-clique vertices nearer; one NEG epoch at 600 corpus repeats, a
   one-epoch ``Word2Vec.fit`` after a warm one (its host pairs
   included), is timed (pairs/s), and nothing in (d) launches a hand
   kernel. Its
   launches join the kernels line's K1-K4 and K4-train
   (``launches_phase_22``); under 20 s.
23. ETL, the remote UI, the ML pipeline, clustering and t-SNE
   (``ui_phase``), one path: data comes in, a model trains and is
   watched, the models are served, their features clustered. (a) 60000
   + 10000 MNIST-shaped IDX images (28 x 28 uint8 from a seeded mixture
   of 10 blobs, pixel noise 5 around each centre, with labels) and a CSV
   are uploaded into a ``LocalFileStore`` bucket (``S3Uploader``), and
   ``S3Downloader.download_dataset`` puts them in the fetcher cache (under
   ``build/ui_phase``); g++ builds the port's record readers into
   ``build/native/`` (its seconds and path printed; a missing library
   fails the phase), and ``load_idx_native`` / ``load_csv_native`` read
   them equal to numpy's parse of the same bytes (1e-6). (b) A
   ``UIServer(port=0)`` with its remote listener; TextGenerationLSTM (2 x
   LSTM(256), B=32, T=64, the stride-8 windows, seed 123) fit for 2
   epochs by ``NativeAsyncDataSetIterator`` in chunks of 3 steps, under
   a ``StatsListener`` -> ``WebReporter`` -> ``RemoteUIStatsStorageRouter``
   and a local one: exactly one K4-train and two K3 a step, every batch
   from ``batcher_next``; the parameters after the first chunk within
   1e-4 of max |param| of the CPU port fed by its own native iterator;
   after ``flush`` /train/overview's iterations and scores equal the
   local record and /train/system/data names the card; the held-out
   windows' ``output`` through one K4 (1e-4 against the CPU port); ms a
   step and ``host_stall_frac`` of the native-fed fit beside the same fit
   fed by ``ListDataSetIterator`` (fresh nets, no listeners, the same
   launches; the second epoch of each timed warm). (c) LeNet on the IDX
   images (B=64, 20 steps, cuDNN, no hand
   kernel) with ``ConvolutionalIterationListener(frequency 10)`` through
   the reporter: /train/activations/data's PNGs, decoded with zlib, within
   1 grey level of the CPU port's at the same weights and batch. (d)
   ``NetworkClassifier`` over ``LastTimeStep(LSTM(256))`` ->
   ``OutputLayer`` on the char windows labelled by their next character,
   ``workers=4``, 2 epochs: exactly one K2 and one K3 a sync step (one
   program over the four slots' rows); ``predict_proba`` of the held-out
   windows one K1 a call, 1e-4 against the CPU port; ``NetworkModel``
   save / load gives the same outputs; ``AutoEncoderEstimator`` (784-256-
   64) + ``NetworkClassifier`` in a ``Pipeline`` on 12000 IDX rows, no
   hand kernel, test accuracy > 0.9. (e) ``KMeansClustering(k=10)`` on
   the 60000 x 784 features: purity >= 0.99, and on 6000 rows the CPU
   port's assignments and centroids (1e-4); ``NearestNeighbors``,
   euclidean and cosine, 10000 queries over the 60000 rows, k=10, against
   float64 numpy on 256 queries (the k-set's and the returned distances
   within float32's rounding bound of the index's expression: 2 gamma
   (|q|^2 + max |c|^2) on squared distances, 3 gamma for cosine, gamma =
   784 x 2^-24); ``NearestNeighborsServer`` on the card index
   over HTTP equal to the in-process index; exact ``Tsne`` at n=1000
   against the CPU port (P 1e-5; 10 iterations from the CPU port's P at
   rate 10 and exaggeration 4, 1e-4 of max |y|: at the defaults a 1e-7
   change grows past that), then n=5000 for 500 iterations: class centroids further
   apart than twice the classes' RMS spread, every point nearest its own
   class's centroid; the coordinates through /tsne/upload and back from
   /tsne/coords equal; ``BarnesHutTsne`` (n=300, 50 iterations; its
   SpTree loop is host numpy, so it is host-bound) in a process of its
   own (``--bh-tsne``), started after (a) and waited for in (e). Prints ms a k-means iteration, ms of the 10000-query kNN and ms a
   t-SNE iteration. Its launches join the kernels line's K1-K4 and
   K4-train (``launches_phase_23``).

A replayed CUDA graph adds to the launch counts the launches its capture
recorded (the capture itself counts none), so the counts below are the
kernels that ran. Kernel launch counts are reset right before the LSTM
serving phase, before
each TinyTransformer part (the 256-wide heads' too), before training (b)
and (c) and before each part of the TinyTransformer training, and read
right after (and around each counted run of 11 and 14); each
TinyTransformer part and the training runs must launch exactly the kernels
their call or step counts call for (K5 twice per bucketed forward, K8 or
K9 twice per engine step; K5, K6 and K7 twice each per TinyTransformer
train step, K5 alone for ``score`` and ``evaluate``), and nothing else.

After the phases each kernel is timed again at its main path's shape, and
K5-K9 at the wide-heads phase's shapes (K5-K7 also at Dh 128 beside them,
the split's cost); K8 and K9 also over a bfloat16 cache at their main
path's shape, reported under ``bf16`` in their entries with phase 15's
bfloat16 launches. Prints the whole script's seconds, then, before the
last line, one JSON line of per-kernel numbers and the card's name and
power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Detailed results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
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


def phase_done(n, tag, t0, card) -> float:
    """Print phase ``n``'s seconds since ``t0``; returns them."""
    seconds = time.perf_counter() - t0
    print(f"{tag}: phase {n} took {seconds:.1f} s [{card}]", flush=True)
    return seconds


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
    "tf32" for the tensor-core bound of K5-K7), whichever is larger
    (``attn_work``)."""
    flops, nbytes = attn_work(kernel, c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_work(kernel, c):
    """(operations, bytes) of one attention call on these inputs. K5, K6
    and K7 count the (query, key) pairs the mask keeps; K8/K9 only the live
    rows 0..pos of each stream, at the cache's width (2 bytes in
    bfloat16), and K9 the page-table entries they need."""
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
        # q and the output in float32, the live rows at the cache's width
        kv = (c["kc"] if "kc" in c else c["pk"]).element_size()
        nbytes = 4 * (2 * B * H * Dh + B) + kv * 2 * live * H * Dh
        if kernel == "flash_decode_paged":
            nbytes += 4 * int((c["pos"].long() // c["pk"].shape[1] + 1).sum())
        flops = 4.0 * Dh * H * live
    return flops, nbytes


def attn_inputs(kernel, B, T, causal=False, pos=None, seed=0, dh=HEAD_DIM,
                heads=HEADS, kv_dtype="float32"):
    """K5: q, k, v (B*heads, T, dh). K8/K9: q (B, heads, dh), a cache of
    capacity T in ``kv_dtype`` (dense, or a pool of 16-row blocks behind
    shuffled page tables with block 0 as scratch, T rounded up to whole
    blocks), and positions (default: spread over 0..T-1)."""
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
    kvt = getattr(torch, kv_dtype)
    if kernel == "flash_decode":
        c["kc"], c["vc"] = (rnd(B, T, heads, dh).to(kvt) for _ in range(2))
        return c
    MB = -(-T // KV_BLOCK)
    NB = B * MB + 1
    c["pk"], c["pv"] = (rnd(NB, KV_BLOCK, heads, dh).to(kvt)
                        for _ in range(2))
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
    # SDPA over the (gathered) cache in the cache's type: a bfloat16
    # query beside a bfloat16 cache, the output widened
    ql = q.to(kc.dtype)
    return wrap, plain, lambda: F.scaled_dot_product_attention(
        ql[:, :, None, :], kt, vt, attn_mask=mask)[:, :, 0, :].float()


def attn_kernel_case(kernel, B, T, causal=False, pos=None, seed=0,
                     dh=HEAD_DIM, heads=HEADS, kv_dtype="float32"):
    """One attention kernel at one shape: error against the plain version
    (K5: o and lse), and the four times; K8/K9 over a ``kv_dtype`` cache.
    Launches made here are not the main path's; the caller resets the
    counters before the main path."""
    import torch
    from deeplearning4j_tpu_torch.ops import decode_cuda
    c = attn_inputs(kernel, B, T, causal, pos, seed, dh, heads, kv_dtype)
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
               "dtype": kv_dtype, "max_abs_err": err, "tol": ATTN_TOL,
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
                kw = ({} if kv_dtype == "float32"
                      else {"dtype": getattr(torch, kv_dtype)})
                row["floor_ms"] = graph_ms(lambda: decode_cuda.launch_floor(
                    kernel, B, heads, dh, C, KV_BLOCK, **kw), reps=20)
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
    kv = "" if row.get("dtype", "float32") == "float32" else \
        f" {row['dtype']} cache"
    return (f"{row['kernel']:18s} B={row['B']:<3d} T={row['T']:<3d} "
            f"Dh={row['Dh']:<3d}{kv} {what} "
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
    from deeplearning4j_tpu_torch.zoo import (TextGenerationLSTM,
                                              TinyTransformer)
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


def _ties(net, prompts, gots, wants, temp=0.0, seed=0, bar=None):
    """Near-tie records of every stream that differs from the reference,
    or raise when one differs beyond a near-tie (``bar``; default
    TIE_MARGIN greedy, SCORE_TIE sampled)."""
    ties = []
    for p, got, want in zip(prompts, gots, wants):
        tie = (_first_tie(net, p, got, want) if temp == 0 else
               _sampled_tie(net, p, got, want, temp, seed))
        if tie is not None:
            ties.append({"prompt_len": len(p), "step": tie[0],
                         "margin": tie[1]})
    if bar is None:
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
ROUNDS = 2            # eager and captured rounds, in turns, in one call
ONE_AT_A_TIME, ONE_NEW = 3, 16   # prompts and new tokens of the CPU check
CAPTURED_NEW = 32    # new tokens a stream of (d)'s rounds


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
                t, row, st0, st1 = _decode_round(eng, prompts, CAPTURED_NEW,
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
    print(f"captured (d): {name}: {len(prompts)} streams x {CAPTURED_NEW}, "
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
        futs = [eng.submit(p, max_new_tokens=CAPTURED_NEW) for p in prompts]
        # a staged swap pauses admission, so a request still queued when
        # it is staged runs on the new weights: stage it only once the
        # loop has admitted every stream
        deadline = time.monotonic() + 60
        while eng.stats()["queued_requests"]:
            if time.monotonic() > deadline:
                raise AssertionError("phase 11 (d) swap: the streams were "
                                     "not admitted within 60 s")
            time.sleep(0.001)
        t0 = time.perf_counter()
        version = eng.swap_weights(new.params, timeout=600)
        out["swap_wait_s"] = time.perf_counter() - t0
        old = [f.result(timeout=600)["tokens"] for f in futs]
        if old != plain:
            raise AssertionError("phase 11 (d) swap: the streams in flight "
                                 "did not finish on the old weights")
        toks = _serve(eng, prompts, CAPTURED_NEW)[0]
        caps1 = {k: p["captures"] for k, p in eng.program_stats().items()}
    finally:
        eng.stop()
    naive = [generate_naive(new, p, CAPTURED_NEW, max_len)["tokens"]
             for p in prompts]
    out.update(version=version, captures=(caps0, caps1),
               ties_vs_naive=_ties(new, prompts, toks, naive))
    if version != 1 or caps0 != caps1:
        raise AssertionError(f"phase 11 (d) swap: version {version}, "
                             f"captures {caps0} -> {caps1}")
    eos = plain[0][10]
    eng = DecodeEngine(net, slots=8, max_len=max_len, eos_id=eos).start()
    try:
        got = _serve(eng, prompts, CAPTURED_NEW)[0]
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
    naive = [generate_naive(net, p, CAPTURED_NEW, 512)["tokens"]
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
    lnaive = [generate_naive(lstm, p, CAPTURED_NEW, 256)["tokens"]
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


# ------------------------------------------------------------- phase 13
# InceptionResNetV1 at the zoo's defaults (160 x 160 x 3, 1000 classes)
INC_SIZE, INC_CLASSES = 160, 1000
INC_B, INC_STEPS, INC_PARITY_B, INC_TOL = 32, 20, 4, 1e-3
INC_BITWISE_STEPS, INC_EAGER_STEPS = 3, 5
EMBED_TOL = 1e-5                # |embedding| - 1
# the other two nets at their defaults: (size, classes)
ZOO13 = {"facenet_nn4_small2": (96, 1000), "googlenet": (224, 1000)}
ZOO13_STEPS = 5
# pretraining: RBM(784 -> 500, k=1) -> AutoEncoder(500 -> 250) -> softmax on
# MNIST's uint8 wire; the held-out bar is the CPU port's own run of this
# recipe (``pretrain_recipe("cpu")``: 0.6690 on 2000 test images; 0.6690 to
# 0.6705 with four other streams of draws; the same network without
# pretraining 0.7875) less RECIPE_SLACK
PRETRAIN_B, PRETRAIN_ROWS, PRETRAIN_FIT_EPOCHS = 128, 6400, 3
PRETRAIN_CPU_ACC = 0.6690
PRETRAIN_TOL = 1e-4             # first pretrain step, card vs CPU port
VAE_EPOCHS, VAE_LATENT = 2, 32
FROZEN_STEPS, FROZEN_TOL = 5, 1e-4
# YOLOv2 at the VOC layout: yolo-voc.cfg's five anchors, 20 classes, a
# 13 x 13 grid over 416 x 416 images
YOLO_ANCHORS = ((1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
                (9.47112, 4.84053), (11.2364, 10.0071))
YOLO_CLASSES, YOLO_SIZE, YOLO_B, YOLO_STEPS, YOLO_TOL = 20, 416, 4, 5, 1e-4
YOLO_OBJECTS = 3                # objects an image
EVAL_TOL = 1e-6                 # evaluations of card vs CPU outputs
ITER_ROWS = 6400                # LeNet through the iterator wrappers


def _cpu_copy(net):
    """The CPU port's network of ``net``'s configuration, parameters and
    layer state."""
    from deeplearning4j_tpu_torch import ComputationGraph, MultiLayerNetwork
    if isinstance(net.params, dict):
        return ComputationGraph(net.conf, device="cpu").set_params(
            {n: {k: v.cpu() for k, v in p.items()}
             for n, p in net.params.items()}, net.state)
    return MultiLayerNetwork(net.conf, device="cpu").set_params(
        [{k: v.cpu() for k, v in p.items()} for p in net.params], net.state)


def _tree_rel(got, want):
    """The largest difference of two trees (lists or dicts of dicts of
    tensors), each tensor's relative to its largest magnitude (0 for two
    empty trees)."""
    ig = dict(got.items() if isinstance(got, dict) else enumerate(got))
    iw = want.items() if isinstance(want, dict) else enumerate(want)
    errs = [float((ig[n][k].double().cpu() - t.double().cpu()).abs().max()
                  / max(t.abs().max().item(), 1e-30))
            for n, d in iw for k, t in d.items()]
    return max(errs, default=0.0)


def _paired_steps(net, cpu, batches):
    """``fit`` of each batch on the card's eager step (its draws recorded)
    and then on the CPU port (the same draws replayed). Returns the two
    lists of losses."""
    net._capture_steps = False
    draws, losses = [], ([], [])
    for b in batches:
        with seam("record", draws):
            losses[0].append(net.fit(*b).get_score())
    for b in batches:
        with seam("replay", draws):
            losses[1].append(cpu.fit(*b).get_score())
    if draws:
        raise AssertionError(f"{len(draws)} draws left over")
    return losses


def _rel_losses(losses):
    return max(abs(a - b) / abs(b) for a, b in zip(*losses))


def _centers_rel(net, cpu):
    """The center-loss head's centers, card against CPU port (relative to
    the largest)."""
    head = net.conf.network_outputs[0]
    return _tree_rel({head: {"centers": net.params[head]["centers"]}},
                     {head: {"centers": cpu.params[head]["centers"]}})


def _float64_pair(make, dev):
    """The seed's network of ``make`` in float64 on ``dev`` and on the CPU,
    from one set of weights."""
    from deeplearning4j_tpu_torch import ComputationGraph
    base = make("cpu")
    conf = base.conf
    conf.global_conf.dtype = "float64"
    params = {n: {k: v.double() for k, v in p.items()}
              for n, p in base.params.items()}
    return (ComputationGraph(conf, device=dev).set_params(params),
            ComputationGraph(conf, device="cpu").set_params(params))


def _predict_ms(net, cpu, x, reps=6):
    """``x`` through /predict of an InferenceServer over ``net``: ms of
    each request, the probabilities, and (given ``cpu``) their largest
    difference from the CPU port's forward."""
    from deeplearning4j_tpu_torch.serving import (InferenceClient,
                                                  InferenceServer)
    srv = InferenceServer(net, port=0, max_latency_ms=2.0).start()
    cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
    try:
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            probs = cli.predict(x)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        srv.stop()
    if probs.shape[0] != len(x) or not np.isfinite(probs).all():
        raise AssertionError(f"/predict returned {probs.shape}")
    err = None if cpu is None else float(
        np.abs(probs - cpu.output(x).numpy()).max())
    return ms, probs, err


def _captured_ms(net, dev, size, classes, steps, seed=7):
    """ms per captured step of ``steps`` fit_scan steps at B=INC_B after a
    two-step warm-up and capture; returns (ms, images/s, last loss, the
    staged batches)."""
    import torch
    xs, ys = (torch.from_numpy(a).to(dev).reshape(
        (steps, INC_B) + a.shape[1:])
        for a in _images(steps * INC_B, seed, classes, size))
    net.fit_scan([xs[:2]], [ys[:2]])
    _sync(dev)
    t0 = time.perf_counter()
    net.fit_scan([xs], [ys])
    _sync(dev)
    wall = time.perf_counter() - t0
    loss = net.get_score()
    if not np.isfinite(loss):
        raise AssertionError("the loss is not finite")
    return wall / steps * 1e3, steps * INC_B / wall, loss, (xs, ys)


def _inception(dev):
    from deeplearning4j_tpu_torch.zoo import InceptionResNetV1
    return InceptionResNetV1(num_classes=INC_CLASSES,
                             input_shape=(INC_SIZE, INC_SIZE, 3)).init(
                                 device=dev)


def inception_part(card, res, dev="cuda"):
    """(a) InceptionResNetV1 at full width from its configuration's seed
    (Adam, the zoo's updater): /predict at B=1 and 32, unit embeddings,
    one float32 and two float64 B=4 steps against the CPU port, captured
    against eager bit for bit, 20 captured B=32 steps, ten profiled."""
    import torch
    out = {}
    net = _inception(dev)
    out["num_params"] = net.num_params()
    cpu = _cpu_copy(net)
    for b in (1, INC_B):
        x, _ = _images(b, b, INC_CLASSES, INC_SIZE)
        ms, probs, err = _predict_ms(net, cpu if b == 1 else None, x)
        out[f"predict_ms_b{b}"] = ms
        if b == 1:
            out["predict_b1_max_abs_err_vs_cpu"] = err
            if err > INC_TOL:
                raise AssertionError(f"phase 13 (a): /predict vs CPU {err}")
    xe = torch.from_numpy(_images(INC_B, 9, INC_CLASSES, INC_SIZE)[0])
    with torch.no_grad():
        emb = net._activations(net.params, [xe.to(dev)])[0]["embeddings"]
    norm_err = float((emb.norm(dim=-1) - 1).abs().max())
    out["embedding_norm_err"] = norm_err
    print(f"inception (a): InceptionResNetV1 ({INC_SIZE} x {INC_SIZE} x 3, "
          f"{INC_CLASSES} classes, {out['num_params']} parameters) "
          f"/predict: B=1 median "
          f"{statistics.median(out['predict_ms_b1'][1:]):.2f} ms, B="
          f"{INC_B} median "
          f"{statistics.median(out[f'predict_ms_b{INC_B}'][1:]):.2f} ms a "
          f"request (first {out['predict_ms_b1'][0]:.1f} / "
          f"{out[f'predict_ms_b{INC_B}'][0]:.1f} ms); B=1 against the CPU "
          f"port: max abs err {out['predict_b1_max_abs_err_vs_cpu']:.3g} "
          f"(tol {INC_TOL}); embeddings of {INC_B} images: | |e| - 1 | <= "
          f"{norm_err:.3g} (tol {EMBED_TOL}) [{card}]", flush=True)
    if norm_err > EMBED_TOL:
        raise AssertionError(f"phase 13 (a): embedding norms {norm_err}")
    # against the CPU port at B=4, the card's dropout draws replayed: a
    # float32 step (loss, running statistics; the centers reported: an
    # Adam step maps a center's gradient g to lr g / (|g| + 1e-8), which
    # float32's differences in the embeddings move where |g| is near
    # 1e-8), and two float64 steps (loss, running statistics, centers)
    x4, y4 = _images(INC_PARITY_B, 4, INC_CLASSES, INC_SIZE)
    losses = _paired_steps(net, cpu, [([x4], [y4])])
    f32 = {"losses": losses, "loss_rel_err": _rel_losses(losses),
           "state_rel_err": _tree_rel(net.state, cpu.state),
           "centers_rel_err": _centers_rel(net, cpu)}
    del net, cpu
    net64, cpu64 = _float64_pair(_inception, dev)
    t64 = [torch.from_numpy(a).double() for a in (x4, y4)]
    losses = _paired_steps(net64, cpu64, [([t64[0]], [t64[1]])] * 2)
    f64 = {"losses": losses, "loss_rel_err": _rel_losses(losses),
           "state_rel_err": _tree_rel(net64.state, cpu64.state),
           "centers_rel_err": _centers_rel(net64, cpu64)}
    del net64, cpu64
    out.update(parity_float32=f32, parity_float64=f64)
    print(f"inception (a): B={INC_PARITY_B} against the CPU port (the "
          f"card's dropout draws replayed): one float32 step, loss "
          f"{f32['losses'][0][0]} vs {f32['losses'][1][0]} (rel err "
          f"{f32['loss_rel_err']:.3g}), running statistics within "
          f"{f32['state_rel_err']:.3g} of each tensor's largest, centers "
          f"{f32['centers_rel_err']:.3g} (reported); two float64 steps, "
          f"losses {f64['losses'][0]} vs {f64['losses'][1]} (max rel err "
          f"{f64['loss_rel_err']:.3g}), running statistics "
          f"{f64['state_rel_err']:.3g}, centers {f64['centers_rel_err']:.3g} "
          f"(tol {INC_TOL}) [{card}]", flush=True)
    if max(f32["loss_rel_err"], f32["state_rel_err"], f64["loss_rel_err"],
           f64["state_rel_err"], f64["centers_rel_err"]) > INC_TOL:
        raise AssertionError("phase 13 (a): card vs CPU port")
    # captured against eager, bit for bit
    xb, yb = _images(INC_B, 32, INC_CLASSES, INC_SIZE)
    with deterministic_cudnn():
        cap, eager = _inception(dev), _inception(dev)
        eager._capture_steps = False
        for m in (cap, eager):
            for _ in range(INC_BITWISE_STEPS):
                m.fit([xb], [yb])
        same = (_trees_equal(cap.params, eager.params)
                and _trees_equal(cap.state, eager.state))
        diff = _tree_diff(cap.params, eager.params)
        captures = cap._capture_count
        del cap
        print(f"inception (a): {INC_BITWISE_STEPS} captured steps at B="
              f"{INC_B} {'equal' if same else 'differ from'} "
              f"{INC_BITWISE_STEPS} eager steps bit for bit, parameters and "
              f"running statistics ({captures} capture, deterministic "
              f"cuDNN) [{card}]", flush=True)
        if not same or (dev == "cuda" and captures != 1):
            raise AssertionError(
                f"phase 13 (a): captured vs eager differ by {diff}")
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(INC_EAGER_STEPS):
            eager.fit([xb], [yb])
        _sync(dev)
        out["eager_ms_per_step"] = ((time.perf_counter() - t0)
                                    / INC_EAGER_STEPS * 1e3)
        del eager
    net = _inception(dev)
    ms, ips, loss, (xs, ys) = _captured_ms(net, dev, INC_SIZE, INC_CLASSES,
                                           INC_STEPS)
    out.update(captured_ms_per_step=ms, images_per_s=ips, captured_loss=loss,
               captures=net._capture_count)
    prof = None
    if dev == "cuda":
        prof = profile_steps(
            lambda: net.fit_scan([xs[:CNN_PROFILE_STEPS]],
                                 [ys[:CNN_PROFILE_STEPS]]),
            CNN_PROFILE_STEPS, (CONV_TAGS,))
    out["profile"] = prof
    busy = None if prof is None else prof["device_busy_ms_per_step"]
    conv = (None if busy is None else
            prof["tagged_ms_per_step"][_tag(CONV_TAGS)] / busy)
    out["conv_share_of_busy"] = conv
    print(f"inception (a): {INC_STEPS} captured steps at B={INC_B}: "
          f"{ms:.2f} ms a step ({ips:.0f} images/s; eager "
          f"{out['eager_ms_per_step']:.2f} ms a step, deterministic cuDNN), "
          f"last loss {loss:.4f}; "
          + ("not profiled" if prof is None
             else fmt_profile(prof, (CONV_TAGS,)))
          + "; convolution kernels' share of busy time "
          + ("not measured" if conv is None else f"{conv:.1%}")
          + f" [{card}]", flush=True)
    res["inception_resnet_v1"] = out


def _zoo13(name, dev):
    from deeplearning4j_tpu_torch.zoo import FaceNetNN4Small2, GoogLeNet
    size, classes = ZOO13[name]
    cls = FaceNetNN4Small2 if name == "facenet_nn4_small2" else GoogLeNet
    return cls(num_classes=classes, input_shape=(size, size, 3)).init(
        device=dev)


def zoo_part(card, res, dev="cuda"):
    """(b) FaceNetNN4Small2 and GoogLeNet at full width from their seeds:
    /predict at B=1 against the CPU port, one float32 B=4 step against it
    (the card's dropout draws replayed), 5 captured steps at B=32."""
    out = {}
    for name, (size, classes) in ZOO13.items():
        row = {}
        net = _zoo13(name, dev)
        cpu = _cpu_copy(net)
        row["num_params"] = net.num_params()
        x1, _ = _images(1, 1, classes, size)
        ms, _, err = _predict_ms(net, cpu, x1)
        row.update(predict_ms_b1=ms, predict_b1_max_abs_err_vs_cpu=err)
        x4, y4 = _images(INC_PARITY_B, 4, classes, size)
        p0 = {n: {k: v.clone() for k, v in p.items()}
              for n, p in cpu.params.items()}
        losses = _paired_steps(net, cpu, [([x4], [y4])])
        # Adam (FaceNetNN4Small2): loss and running statistics, the
        # centers reported (see inception_part); Nesterovs (GoogLeNet): the
        # parameters too, against the step's largest update (a bias that
        # starts at zero holds lr x its gradient after a step, which
        # float32 sums with cancellation: on the CPU, float32 against
        # float64, up to 3.1e-3 of that bias's largest and 4.1e-4 of the
        # step's largest update)
        row.update(losses=losses, loss_rel_err=_rel_losses(losses),
                   state_rel_err=_tree_rel(net.state, cpu.state))
        held = [row["loss_rel_err"], row["state_rel_err"]]
        if name == "googlenet":
            row["param_rel_err"] = _tree_rel(net.params, cpu.params)
            row["param_err_of_update"] = (
                max(float((net.params[n][k].cpu() - v).abs().max())
                    for n, d in cpu.params.items() for k, v in d.items())
                / max(float((v - p0[n][k]).abs().max())
                      for n, d in cpu.params.items()
                      for k, v in d.items()))
            held.append(row["param_err_of_update"])
        else:
            row["centers_rel_err"] = _centers_rel(net, cpu)
        del net, cpu
        net = _zoo13(name, dev)
        ms_step, ips, loss, _ = _captured_ms(net, dev, size, classes,
                                             ZOO13_STEPS)
        row.update(captured_ms_per_step=ms_step, images_per_s=ips,
                   captured_loss=loss)
        del net
        out[name] = row
        print(f"inception (b): {name} ({size} x {size} x 3, {classes} "
              f"classes, {row['num_params']} parameters): /predict B=1 "
              f"median {statistics.median(ms[1:]):.2f} ms, max abs err "
              f"{err:.3g} against the CPU port; one float32 B="
              f"{INC_PARITY_B} step against it: loss rel err "
              f"{row['loss_rel_err']:.3g}, running statistics "
              f"{row['state_rel_err']:.3g}"
              + (f", parameters {row['param_err_of_update']:.3g} of the "
                 f"step's largest update ({row['param_rel_err']:.3g} of "
                 f"each tensor's largest, reported)"
                 if "param_rel_err" in row else
                 f", centers {row['centers_rel_err']:.3g} (reported)")
              + f" (tol {INC_TOL}); {ZOO13_STEPS} captured steps at B="
              f"{INC_B}: {ms_step:.2f} ms a step ({ips:.0f} images/s), "
              f"last loss {loss:.4f} [{card}]", flush=True)
        if err > INC_TOL or max(held) > INC_TOL:
            raise AssertionError(f"phase 13 (b) {name}: card vs CPU port")
    res["zoo"] = out


def _mnist(train=True, rows=None, batch=PRETRAIN_B, flatten=True,
           shuffle=True):
    from deeplearning4j_tpu_torch.data.fetchers import MnistDataSetIterator
    return MnistDataSetIterator(batch, train=train, shuffle=shuffle,
                                num_examples=rows or PRETRAIN_ROWS,
                                flatten=flatten)


def pretrain_net(dev, vae=False):
    """RBM(784 -> 500, k=1) -> AutoEncoder(500 -> 250, corruption 0.3) ->
    softmax(10), or VariationalAutoencoder(784, encoder (256,), decoder
    (256,), nZ 32, Bernoulli) -> softmax(10), Adam(1e-3), seed 123."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (RBM, AutoEncoder,
                                                    OutputLayer,
                                                    VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    b = NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3)).list()
    if vae:
        b = b.layer(VariationalAutoencoder(
            n_out=VAE_LATENT, encoder_layer_sizes=(256,),
            decoder_layer_sizes=(256,), recon="bernoulli"))
    else:
        b = (b.layer(RBM(n_out=500, k=1))
             .layer(AutoEncoder(n_out=250, corruption_level=0.3)))
    conf = (b.layer(OutputLayer(n_out=10, activation="softmax",
                                loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())
    return MultiLayerNetwork(conf, device=dev).init()


def pretrain_recipe(dev):
    """The pretraining recipe from the seed: ``pretrain`` 1 epoch, ``fit``
    PRETRAIN_FIT_EPOCHS epochs, held-out accuracy on 2000 test images.
    Returns (network, accuracy, pretrain seconds, fit seconds)."""
    net = pretrain_net(dev)
    train = _mnist()
    _sync(dev)
    t0 = time.perf_counter()
    net.pretrain(train, epochs=1)
    _sync(dev)
    t1 = time.perf_counter()
    net.fit(train, epochs=PRETRAIN_FIT_EPOCHS)
    _sync(dev)
    t2 = time.perf_counter()
    acc = float(net.evaluate(_mnist(False, 2000, 500)).accuracy())
    return net, acc, t1 - t0, t2 - t1


def _first_pretrain(net, cpu, data):
    """One pretrain step of each pretrainable layer on the card (draws
    recorded) and on the CPU port (replayed): the largest parameter
    difference (relative to each tensor's largest) and the two scores."""
    draws = []
    with seam("record", draws):
        net.pretrain(data, epochs=1)
    with seam("replay", draws):
        cpu.pretrain(data, epochs=1)
    if draws:
        raise AssertionError(f"{len(draws)} draws left over")
    return (_tree_rel(net.params, cpu.params),
            (net.get_score(), cpu.get_score()))


def pretrain_part(card, res, dev="cuda"):
    """(c) RBM -> AutoEncoder -> softmax on MNIST's uint8 wire: each
    layer's first pretrain step against the CPU port (the same draws),
    then the recipe with its bar; a VAE network pretrained for VAE_EPOCHS
    epochs: its first step against the CPU port, -ELBO falling,
    ``reconstruct`` and ``generate`` in [0, 1]."""
    import torch
    from deeplearning4j_tpu_torch.nn.layers.base import nest_params
    out = {}
    train = _mnist()
    one = _first_batches(train, 1)
    net = pretrain_net(dev)
    err, scores = _first_pretrain(net, _cpu_copy(net), one)
    out["first_step"] = {"param_rel_err": err, "scores": scores}
    net, acc, t_pre, t_fit = pretrain_recipe(dev)
    steps = PRETRAIN_ROWS // PRETRAIN_B
    bar = PRETRAIN_CPU_ACC - RECIPE_SLACK
    out["recipe"] = {"heldout_accuracy": acc, "bar": bar,
                     "pretrain_ms_per_step": t_pre / (2 * steps) * 1e3,
                     "fit_ms_per_step":
                         t_fit / (PRETRAIN_FIT_EPOCHS * steps) * 1e3}
    print(f"inception (c): RBM(784 -> 500, k=1) -> AutoEncoder(500 -> 250) "
          f"-> softmax on MNIST (B={PRETRAIN_B}, uint8 wire): each layer's "
          f"first pretrain step against the CPU port, the same draws: "
          f"parameters within {err:.3g} of each tensor's largest, score "
          f"{scores[0]:.6f} vs {scores[1]:.6f} (tol {PRETRAIN_TOL}); "
          f"pretrain 1 epoch ({out['recipe']['pretrain_ms_per_step']:.3f} "
          f"ms a layer step, eager), fit {PRETRAIN_FIT_EPOCHS} epochs "
          f"({out['recipe']['fit_ms_per_step']:.3f} ms a step): held-out "
          f"accuracy {acc:.4f} (bar {bar}, the CPU port's "
          f"{PRETRAIN_CPU_ACC} less {RECIPE_SLACK}) [{card}]", flush=True)
    if err > PRETRAIN_TOL or abs(scores[0] - scores[1]) > PRETRAIN_TOL * \
            max(1.0, abs(scores[1])) or acc < bar:
        raise AssertionError(f"phase 13 (c): {out}")
    del net
    vae = pretrain_net(dev, vae=True)
    err, scores = _first_pretrain(vae, _cpu_copy(vae), one)
    layer = vae.layers[0]
    held = _mnist(False, PRETRAIN_B).dataset.features
    xh = torch.from_numpy(held.astype(np.float32) / 255.0).to(dev)

    def elbo():
        with torch.no_grad():
            return float(layer.compute_score(nest_params(vae.params[0]), xh))
    before = elbo()
    _sync(dev)
    t0 = time.perf_counter()
    vae.pretrain(train, epochs=VAE_EPOCHS)
    _sync(dev)
    t_vae = time.perf_counter() - t0
    after = elbo()
    p = nest_params(vae.params[0])
    with torch.no_grad():
        rec = layer.reconstruct(p, xh)
        gen = layer.generate(p, torch.randn(16, VAE_LATENT, device=dev))
    in_range = bool(((rec >= 0) & (rec <= 1)).all()
                    and ((gen >= 0) & (gen <= 1)).all())
    out["vae"] = {"first_step_param_rel_err": err, "first_scores": scores,
                  "neg_elbo_before": before, "neg_elbo_after": after,
                  "ms_per_step": t_vae / (VAE_EPOCHS * steps) * 1e3,
                  "reconstruct_shape": list(rec.shape),
                  "generate_shape": list(gen.shape), "in_range": in_range}
    print(f"inception (c): VAE(784, (256,), (256,), nZ {VAE_LATENT}, "
          f"Bernoulli): first pretrain step against the CPU port, the same "
          f"draws: parameters within {err:.3g}, -ELBO {scores[0]:.6f} vs "
          f"{scores[1]:.6f}; {VAE_EPOCHS} epochs "
          f"({out['vae']['ms_per_step']:.3f} ms a step): held-out -ELBO "
          f"{before:.3f} -> {after:.3f}; reconstruct {tuple(rec.shape)}, "
          f"generate {tuple(gen.shape)}, in [0, 1]: {in_range} [{card}]",
          flush=True)
    if (err > PRETRAIN_TOL or abs(scores[0] - scores[1]) > PRETRAIN_TOL
            * max(1.0, abs(scores[1])) or not after < before
            or not in_range or tuple(rec.shape) != (PRETRAIN_B, 784)
            or tuple(gen.shape) != (16, 784)):
        raise AssertionError(f"phase 13 (c) VAE: {out['vae']}")
    res["pretrain"] = out


def frozen_lenet(dev):
    """LeNet with both convolutions wrapped in FrozenLayer (the zoo's
    configuration otherwise: Adam(1e-3), Xavier, seed 123)."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                    DenseLayer, FrozenLayer,
                                                    OutputLayer,
                                                    SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3))
            .weight_init("xavier").list()
            .layer(FrozenLayer(inner=ConvolutionLayer(
                n_out=20, kernel_size=5, stride=1, activation="relu")))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                    stride=2))
            .layer(FrozenLayer(inner=ConvolutionLayer(
                n_out=50, kernel_size=5, stride=1, activation="relu")))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=2,
                                    stride=2))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(28, 28, 1)).build())
    return MultiLayerNetwork(conf, device=dev).init()


def yolo_net(dev):
    """A YOLOv2 head at the VOC layout on a trunk of five stride-2 3 x 3
    convolutions (416 -> 13) and a 1 x 1 convolution to A x (5 + C) = 125
    channels; Adam(1e-3), seed 123."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                    Yolo2OutputLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    b = (NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3))
         .weight_init("relu").activation("leakyrelu").list())
    for c in (16, 32, 64, 128, 256):
        b = b.layer(ConvolutionLayer(n_out=c, kernel_size=3, stride=2,
                                     padding=1))
    conf = (b.layer(ConvolutionLayer(
                n_out=len(YOLO_ANCHORS) * (5 + YOLO_CLASSES), kernel_size=1,
                activation="identity"))
            .layer(Yolo2OutputLayer(anchors=YOLO_ANCHORS,
                                    n_classes=YOLO_CLASSES))
            .set_input_type(InputType.convolutional(YOLO_SIZE, YOLO_SIZE, 3))
            .build())
    return MultiLayerNetwork(conf, device=dev).init()


def yolo_data(n, seed):
    """Synthetic images and YOLOv2 labels: YOLO_OBJECTS objects an image,
    each in a random cell and anchor with its offsets in (0, 1), log-scale
    sizes, objectness 1 and a class one-hot."""
    r = np.random.RandomState(seed)
    g, A, C = YOLO_SIZE // 32, len(YOLO_ANCHORS), YOLO_CLASSES
    x = r.rand(n, YOLO_SIZE, YOLO_SIZE, 3).astype(np.float32)
    y = np.zeros((n, g, g, A, 5 + C), np.float32)
    for i in range(n):
        for _ in range(YOLO_OBJECTS):
            cy, cx, a = r.randint(0, g), r.randint(0, g), r.randint(0, A)
            y[i, cy, cx, a, 0:2] = r.rand(2)
            y[i, cy, cx, a, 2:4] = 0.5 * r.randn(2)
            y[i, cy, cx, a, 4] = 1.0
            y[i, cy, cx, a, 5 + r.randint(0, C)] = 1.0
    return x, y.reshape(n, g, g, A * (5 + C))


def frozen_yolo_part(card, res, dev="cuda"):
    """(d) LeNet with frozen convolutions, 5 captured steps: the frozen
    parameters as they started, bit for bit, the rest moved, the result
    against the CPU port; YOLOv2 at the VOC layout: loss and gradients
    against the CPU port, 5 captured steps."""
    import torch
    from deeplearning4j_tpu_torch.data import DataSet
    out = {}
    some = _first_batches(_mnist(flatten=False), FROZEN_STEPS)
    with deterministic_cudnn():
        net = frozen_lenet(dev)
        cpu = _cpu_copy(net)
        start = [{k: v.clone() for k, v in p.items()} for p in net.params]
        recs = []
        for m in (net, cpu):
            m._CHUNK_MAX_STEPS = 1
            recs.append(ScoreRecorder())
            m.set_listeners(recs[-1])
            m.fit(some)
    frozen = [i for i, l in enumerate(net.layers) if l.frozen]
    kept = all(torch.equal(net.params[i][k], start[i][k])
               for i in frozen for k in start[i])
    moved = all(not torch.equal(net.params[i][k], start[i][k])
                for i, l in enumerate(net.layers) if not l.frozen
                for k in start[i])
    no_state = all(net.opt_state[i] == {} for i in frozen)
    loss_err = _rel_losses((recs[0].scores, recs[1].scores))
    p_err = _tree_rel(net.params, cpu.params)
    out["frozen"] = {"kept": kept, "moved": moved, "no_updater_state":
                     no_state, "losses": recs[0].scores,
                     "loss_rel_err": loss_err, "param_rel_err": p_err,
                     "captures": net._capture_count}
    print(f"inception (d): LeNet with frozen convolutions, "
          f"{FROZEN_STEPS} captured steps ({net._capture_count} captures, "
          f"uint8 wire): frozen parameters as they started bit for bit: "
          f"{kept}, no updater state: {no_state}, the others moved: "
          f"{moved}; against the CPU port: losses rel err {loss_err:.3g}, "
          f"parameters {p_err:.3g} (tol {FROZEN_TOL}) [{card}]", flush=True)
    if not (kept and moved and no_state) or max(loss_err, p_err) > FROZEN_TOL:
        raise AssertionError(f"phase 13 (d) frozen: {out['frozen']}")
    del net, cpu
    net = yolo_net(dev)
    cpu = _cpu_copy(net)
    x, y = yolo_data(YOLO_B, 5)
    ds = DataSet(x, y)
    lg, gg = _loss_and_grads(net, ds)
    lc, gc = _loss_and_grads(cpu, ds)
    grad_err = _grad_rel_err(gg, gc)
    loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
    xs, ys = (torch.from_numpy(a).to(dev) for a in yolo_data(
        YOLO_STEPS * YOLO_B, 6))
    xs = xs.reshape((YOLO_STEPS, YOLO_B) + xs.shape[1:])
    ys = ys.reshape((YOLO_STEPS, YOLO_B) + ys.shape[1:])
    net.fit_scan(xs[:2], ys[:2])
    _sync(dev)
    t0 = time.perf_counter()
    net.fit_scan(xs, ys)
    _sync(dev)
    ms = (time.perf_counter() - t0) / YOLO_STEPS * 1e3
    last = net.get_score()
    out["yolo"] = {"loss": float(lg), "loss_rel_err": loss_err,
                   "grad_rel_err": grad_err, "captured_ms_per_step": ms,
                   "captures": net._capture_count, "last_loss": last}
    print(f"inception (d): Yolo2OutputLayer, {len(YOLO_ANCHORS)} VOC "
          f"anchors, {YOLO_CLASSES} classes, {YOLO_SIZE // 32} x "
          f"{YOLO_SIZE // 32} grid over {YOLO_SIZE} x {YOLO_SIZE} x 3 (B="
          f"{YOLO_B}): loss {float(lg):.5f}, against the CPU port rel err "
          f"{loss_err:.3g}, gradients {grad_err:.3g} of max|grad| (tol "
          f"{YOLO_TOL}); {YOLO_STEPS} captured steps: {ms:.3f} ms a step, "
          f"last loss {last:.4f} [{card}]", flush=True)
    if max(loss_err, grad_err) > YOLO_TOL or not np.isfinite(last):
        raise AssertionError(f"phase 13 (d) yolo: {out['yolo']}")
    res["frozen_yolo"] = out


def _evaluations(labels, probs):
    """Every evaluation of eval/ on (labels, probabilities): the numbers
    each reports."""
    from deeplearning4j_tpu_torch.eval import (ROC, EvaluationBinary,
                                               EvaluationCalibration,
                                               RegressionEvaluation,
                                               ROCMultiClass)
    roc = ROC().eval(labels[:, 0], probs[:, 0])
    multi = ROCMultiClass().eval(labels, probs)
    binary = EvaluationBinary().eval(labels, probs)
    reg = RegressionEvaluation().eval(labels, probs)
    cal = EvaluationCalibration().eval(labels, probs)
    C = labels.shape[-1]
    return {"roc_auc": roc.calculate_auc(),
            "roc_multiclass_auc": [multi.calculate_auc(c) for c in range(C)],
            "roc_multiclass_average": multi.calculate_average_auc(),
            "binary_accuracy": [binary.accuracy(c) for c in range(C)],
            "binary_f1": [binary.f1(c) for c in range(C)],
            "mse": reg.mean_squared_error(), "r2": reg.r_squared(),
            "ece": cal.expected_calibration_error(),
            "prediction_counts":
                cal.get_prediction_counts_each_class().tolist()}


def iterators_eval_part(card, res, dev="cuda"):
    """(e) LeNet through AsyncDataSetIterator(workers=2) and
    MultipleEpochsIterator(3, base) against the base alone and
    ``epochs=3``, bit for bit (deterministic cuDNN), with ms a step and
    the host stall share; every evaluation of the card's outputs against
    the CPU port's."""
    from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                               MultipleEpochsIterator)
    from deeplearning4j_tpu_torch.zoo import LeNet
    out = {}

    def base():
        return _mnist(rows=ITER_ROWS, flatten=False, shuffle=False)
    steps = ITER_ROWS // PRETRAIN_B
    runs = {}
    with deterministic_cudnn():
        for name, epochs, make in (
                ("base", 1, base),
                ("async", 1, lambda: AsyncDataSetIterator(base(),
                                                          workers=2)),
                ("base_x3", 3, base),
                ("multiple_epochs", 1,
                 lambda: MultipleEpochsIterator(3, base()))):
            net = LeNet(num_classes=10).init(device=dev)
            data = make()
            _sync(dev)
            t0 = time.perf_counter()
            net.fit(data, epochs=epochs)
            _sync(dev)
            wall = time.perf_counter() - t0
            if hasattr(data, "_shutdown"):
                data._shutdown()
            runs[name] = net
            n = steps * (3 if name in ("base_x3", "multiple_epochs") else 1)
            out[name] = {"ms_per_step": wall / n * 1e3,
                         "host_stall_frac":
                             net.last_pipeline_stats.get("host_stall_frac"),
                         "iteration": net.iteration}
    same_async = _trees_equal(runs["base"].params, runs["async"].params)
    same_epochs = (_trees_equal(runs["base_x3"].params,
                                runs["multiple_epochs"].params)
                   and runs["base_x3"].iteration
                   == runs["multiple_epochs"].iteration)
    out.update(async_bitwise=same_async, multiple_epochs_bitwise=same_epochs)
    print(f"inception (e): LeNet on MNIST's uint8 wire ({steps} steps an "
          f"epoch, B={PRETRAIN_B}): through AsyncDataSetIterator(workers=2) "
          f"{'equal' if same_async else 'differ from'} the base bit for "
          f"bit; MultipleEpochsIterator(3, base) "
          f"{'equals' if same_epochs else 'differs from'} epochs=3 bit for "
          f"bit; ms a step and host stall share: "
          + ", ".join(f"{k} {v['ms_per_step']:.3f} / {v['host_stall_frac']}"
                      for k, v in out.items() if isinstance(v, dict))
          + f" [{card}]", flush=True)
    if not (same_async and same_epochs):
        raise AssertionError(f"phase 13 (e): iterators {out}")
    # one more epoch of the base and the async nets, warm (captured)
    for name, make in (("base", base), ("async", lambda: AsyncDataSetIterator(
            base(), workers=2))):
        data = make()
        _sync(dev)
        t0 = time.perf_counter()
        runs[name].fit(data)
        _sync(dev)
        out[name].update(
            warm_ms_per_step=(time.perf_counter() - t0) / steps * 1e3,
            warm_host_stall_frac=runs[name].last_pipeline_stats.get(
                "host_stall_frac"))
        if hasattr(data, "_shutdown"):
            data._shutdown()
    print(f"inception (e): a warm epoch through the base "
          f"{out['base']['warm_ms_per_step']:.3f} ms a step "
          f"(host_stall_frac {out['base']['warm_host_stall_frac']}), through "
          f"AsyncDataSetIterator(workers=2) "
          f"{out['async']['warm_ms_per_step']:.3f} "
          f"({out['async']['warm_host_stall_frac']}) [{card}]", flush=True)
    net = runs["multiple_epochs"]
    cpu = _cpu_copy(net)
    test = _mnist(False, 2000, 2000, flatten=False)
    x = test.dataset.features.astype(np.float32) / 255.0
    y = test.dataset.labels
    card_ev = _evaluations(y, net.output(x).float().cpu().numpy())
    cpu_ev = _evaluations(y, cpu.output(x).numpy())
    worst = max(float(np.max(np.abs(np.asarray(card_ev[k], np.float64)
                                    - np.asarray(cpu_ev[k], np.float64))))
                for k in card_ev)
    out["evaluations"] = {"card": card_ev, "cpu": cpu_ev, "max_diff": worst}
    print(f"inception (e): ROC, ROCMultiClass, EvaluationBinary, "
          f"RegressionEvaluation and EvaluationCalibration of the card's "
          f"outputs on 2000 test images against the CPU port's: max diff "
          f"{worst:.3g} (tol {EVAL_TOL}); AUC {card_ev['roc_auc']:.6f}, "
          f"average AUC {card_ev['roc_multiclass_average']:.6f}, MSE "
          f"{card_ev['mse']:.6f}, R^2 {card_ev['r2']:.6f}, ECE "
          f"{card_ev['ece']:.6f} [{card}]", flush=True)
    if worst > EVAL_TOL:
        raise AssertionError(f"phase 13 (e): evaluations {worst}")
    res["iterators_eval"] = out


def inception_phase(card, dev="cuda"):
    """Phase 13: the Inception zoo, the special layers, pretraining, the
    evaluations and the iterator wrappers (``chip_smoke.py`` docstring)."""
    from deeplearning4j_tpu_torch import ops
    res = {"card": card}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for part in (inception_part, zoo_part, pretrain_part, frozen_yolo_part,
                 iterators_eval_part):
        t1 = time.perf_counter()
        part(card, res, dev)
        res[f"{part.__name__}_s"] = time.perf_counter() - t1
    res["launches"] = ops.launch_counts()
    res["seconds"] = time.perf_counter() - t0
    print(f"inception: phase 13 took {res['seconds']:.1f} s ("
          + ", ".join(f"{k[:-2]} {v:.1f} s" for k, v in res.items()
                      if k.endswith("_part_s"))
          + f"); kernel launches {res['launches']} [{card}]", flush=True)
    if any(res["launches"].values()):
        raise AssertionError(f"phase 13 launched a hand-written kernel: "
                             f"{res['launches']}")
    return res


# --------------------------------------------------------------- phase 14
TIER_PROMPT, TIER_NEW, TIER_STREAMS = 128, 64, 8
TIER_BLOCKS = TIER_STREAMS * 12 + 1   # 8 streams of 191 positions + scratch
TIER_BYTES = 64 << 20
TIER_CLAIM = (TIER_PROMPT - 1) // KV_BLOCK * KV_BLOCK     # 112 positions
EXHAUST_NEW = 380     # two such requests cannot share a 40-block pool


def tier_prompts(ids, n, taken, start, length=TIER_PROMPT):
    """``n`` prompts of ``length`` corpus tokens at distinct offsets from
    ``start``, each opening with a token no prompt in ``taken`` opens with,
    so that no prompt claims another's block by copy-on-write."""
    out, off = [], start
    for _ in range(len(ids)):
        p = ids[off:off + length]
        if p[0] not in taken:
            taken.add(p[0])
            out.append(p)
            if len(out) == n:
                return out
        off = (off + 37) % (len(ids) - length)
    raise AssertionError(f"no {n} corpus prompts with distinct first tokens")


def _median_max(xs):
    return {"median": statistics.median(xs), "max": max(xs)}


def _pool_snapshot(eng):
    p = eng._pool
    return (p.in_use, p.free_count, p.cached_count)


def _rejects(eng, reason):
    from deeplearning4j_tpu_torch.monitor import get_registry
    fam = get_registry().get("dl4jtpu_kv_migrate_rejects_total")
    return sum(c.value for key, c in fam.children()
               if key == (eng.id, reason))


def _wave(eng, prompts, tag, new=TIER_NEW):
    """``prompts`` submitted together under request ids ``tag-i``: tokens,
    steps, the launches (K9 twice a step, nothing else), time to first
    token from the journal, and the records."""
    from deeplearning4j_tpu_torch import ops
    ops.reset_launch_counts()
    st0 = eng.stats()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=new, request_id=f"{tag}-{i}")
            for i, p in enumerate(prompts)]
    toks = [f.result(timeout=600)["tokens"] for f in futs]
    wall = time.perf_counter() - t0
    st1 = eng.stats()
    steps = st1["steps"] - st0["steps"]
    launches = _expect_launches(f"phase 14 {tag}",
                                {"flash_decode_paged": 2 * steps})
    recs = [eng.journal.find(f"{tag}-{i}") for i in range(len(prompts))]
    return toks, {"steps": steps, "launches": launches, "wall_s": wall,
                  "ttft_ms": [r["ttft_seconds"] * 1e3 for r in recs],
                  "prefix_hit_depth": [r["kv"]["prefix_hit_depth"]
                                       for r in recs],
                  "host_restores": [r["kv"]["host_restores"] for r in recs],
                  "kv": _kv_delta(st0, st1)}


def _timed(fn, into):
    def run(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        into.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


def tier_part(net, card, res, waves):
    """Phase 14 (a): the host tier (docstring)."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.serving.engine import input_type_of
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    kw = dict(slots=TIER_STREAMS, max_len=512, kv="paged",
              kv_block_size=KV_BLOCK, chunk_tokens=CHUNK,
              kv_blocks=TIER_BLOCKS)
    out, toks = {}, {}
    for tier in (None, TIER_BYTES):
        tag = "tier" if tier else "no_tier"
        eng = DecodeEngine(net, host_kv_bytes=tier, **kw).start()
        spill_ms, flushes, restore_ms = [], [], []
        if tier:
            # an eviction registers its tier entry (spill_ms); the rows of
            # the evicted blocks are read in batches (flushes: blocks, ms);
            # a restore batch's scatter (restore_ms, its flush set aside)
            eng._prefix.spill_fn = _timed(eng._spill_block, spill_ms)
            flush, apply = eng._flush_spills, eng._apply_host_rows

            def timed_flush():
                n, t0 = len(eng._pending_spills), time.perf_counter()
                flush()
                if n:
                    flushes.append((n, (time.perf_counter() - t0) * 1e3))

            def timed_apply(writes):
                k, t0 = len(flushes), time.perf_counter()
                apply(writes)
                if writes:
                    restore_ms.append((time.perf_counter() - t0) * 1e3
                                      - sum(ms for _, ms in flushes[k:]))
            eng._flush_spills, eng._apply_host_rows = timed_flush, timed_apply
        try:
            ptrs = [t.data_ptr() for _, t in eng._pool_leaf_items()]
            progs = eng.program_stats()
            w = out[tag] = {}
            for name, prompts in waves.items():
                toks[tag, name], w[name] = _wave(eng, prompts,
                                                 f"14a-{tag}-{name}")
                print(f"kv tier (a): {tag}, wave {name}: {w[name]['steps']}"
                      f" steps, wall {w[name]['wall_s']:.3f} s, time to "
                      f"first token (ms) {_median_max(w[name]['ttft_ms'])};"
                      f" prefix hit depths {w[name]['prefix_hit_depth']}, "
                      f"restores {w[name]['host_restores']}; "
                      f"{w[name]['kv']} [{card}]", flush=True)
            st = eng.stats()
            w["kv"] = st["kv"]
            problems = []
            if [t.data_ptr() for _, t in eng._pool_leaf_items()] != ptrs:
                problems.append("a pool leaf moved")
            if eng.program_stats() != progs or eng.trace_count != 1:
                problems.append(f"programs {eng.program_stats()} after "
                                f"warmup {progs}")
            if st["kv"]["blocks_in_use"] != 0:
                problems.append(f"{st['kv']['blocks_in_use']} blocks in use")
            if tier:
                t = st["kv"]["host_tier"]
                w["spill_ms"] = _median_max(spill_ms)
                w["spill_ms"]["n"] = len(spill_ms)
                w["spill_batches"] = flushes
                w["restore_batch_ms"] = _median_max(restore_ms)
                w["restore_batch_ms"]["n"] = len(restore_ms)
                w["bytes_per_block"] = t["bytes"] / t["blocks"]
                c = w["C"]
                if (t["spills"] < 112 or st["kv"]["host_restores"] != 56
                        or c["prefix_hit_depth"] != [TIER_CLAIM] * 8
                        or c["host_restores"] != [7] * 8):
                    problems.append(f"tier {t}, restores "
                                    f"{st['kv']['host_restores']}, wave C "
                                    f"{c['prefix_hit_depth']} "
                                    f"{c['host_restores']}")
                other = TinyTransformer(vocab_size=input_type_of(net).size,
                                        seed=7).init(device=net.device)
                eng.swap_weights(other.params)
                kv = eng.stats()["kv"]
                w["after_swap"] = {"host_tier": kv["host_tier"],
                                   "chain_heads": kv["chain_heads"]}
                if (kv["host_tier"]["blocks"], kv["host_tier"]["bytes"],
                        kv["chain_heads"]) != (0, 0, []):
                    problems.append(f"after the swap {w['after_swap']}")
                print(f"kv tier (a): {t['spills']} spills "
                      f"({w['spill_ms']} ms each), read in batches of "
                      f"(blocks, ms) {flushes}, "
                      f"{st['kv']['host_restores']} restores in "
                      f"{len(restore_ms)} batches ({w['restore_batch_ms']} "
                      f"ms each), tier {t['blocks']} blocks, {t['bytes']} "
                      f"bytes ({w['bytes_per_block']:.0f} a block); after "
                      f"a swap {w['after_swap']} [{card}]", flush=True)
            if problems:
                raise AssertionError(f"phase 14 (a) {tag}: {problems}")
        finally:
            eng.stop()
    diff = [n for n in waves if toks["tier", n] != toks["no_tier", n]]
    if diff:
        raise AssertionError(f"phase 14 (a): waves {diff} differ with the "
                             "tier")
    c = {k: _median_max(out[k]["C"]["ttft_ms"]) for k in out}
    out["ttft_ms_wave_C"] = c
    print(f"kv tier (a): tokens of waves A, B, C equal with and without the "
          f"tier; wave C time to first token (ms) with the tier "
          f"{c['tier']}, without {c['no_tier']} [{card}]", flush=True)
    res["tier"] = out
    return toks


def migrate_part(net, cpu, card, res, waves, want_b):
    """Phase 14 (b): migration between engines (docstring). Returns the
    source and destination engines, running, for (c)."""
    import copy
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.serving.engine import input_type_of
    from deeplearning4j_tpu_torch.serving.kv import KVMigrateError
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    kw = dict(slots=TIER_STREAMS, max_len=512, kv="paged",
              kv_block_size=KV_BLOCK, chunk_tokens=CHUNK)
    A, B = waves["A"], waves["B"]
    # the claimable chain: the destination claims (128 - 1) // 16 = 7
    # blocks read-only, the last prompt token runs through a step
    chain = [p[:-1] for p in A]
    out = {}
    src = DecodeEngine(net, **kw).start()
    dst = DecodeEngine(net, **kw).start()
    others = []
    try:
        src_toks, out["source"] = _wave(src, A, "14b-src")
        ptrs = [t.data_ptr() for _, t in dst._pool_leaf_items()]
        progs = dst.program_stats()
        exp_ms, imp_ms, sizes, payloads = [], [], [], []
        ops.reset_launch_counts()
        for c in chain:
            t0 = time.perf_counter()
            p = src.kv_export(c)
            exp_ms.append((time.perf_counter() - t0) * 1e3)
            wire = json.dumps(p)
            sizes.append(len(wire))
            p = json.loads(wire)
            payloads.append(p)
            t0 = time.perf_counter()
            got = dst.kv_import(p)
            imp_ms.append((time.perf_counter() - t0) * 1e3)
            if got != {"imported_blocks": 7, "duplicate_blocks": 0,
                       "tokens": TIER_CLAIM}:
                raise AssertionError(f"phase 14 (b) import {got}")
        _expect_launches("phase 14 (b) exports and imports", {})
        out.update(export_ms=_median_max(exp_ms), import_ms=_median_max(
            imp_ms), payload_bytes=sizes)
        dst_toks, out["destination"] = _wave(dst, A, "14b-dst")
        problems = []
        if dst_toks != src_toks:
            problems.append("the destination's tokens differ")
        if out["destination"]["prefix_hit_depth"] != [TIER_CLAIM] * 8:
            problems.append(f"hits {out['destination']['prefix_hit_depth']}")
        back = [dst.kv_export(c) for c in chain]
        if [[l["data"] for l in b["leaves"]] for b in back] != \
                [[l["data"] for l in p["leaves"]] for p in payloads]:
            problems.append("a re-export differs")
        again = dst.kv_import(copy.deepcopy(payloads[0]))
        if (again["imported_blocks"], again["duplicate_blocks"]) != (0, 7):
            problems.append(f"re-import {again}")
        if [t.data_ptr() for _, t in dst._pool_leaf_items()] != ptrs \
                or dst.program_stats() != progs:
            problems.append("a pool leaf moved or a program was added")
        # rejections: a torn payload, another block size, another model
        torn = copy.deepcopy(payloads[0])
        d = torn["leaves"][0]["data"]
        torn["leaves"][0]["data"] = d[:10] + ("B" if d[10] == "A"
                                              else "A") + d[11:]
        e32 = DecodeEngine(net, **dict(kw, kv_block_size=32)).start()
        n64 = TinyTransformer(vocab_size=input_type_of(net).size,
                              d_model=64).init(device=net.device)
        e64 = DecodeEngine(n64, **kw).start()
        others += [e32, e64]
        bad = {"torn": torn}
        for reason, e in (("block_size", e32), ("model_sig", e64)):
            e.generate(A[0], max_new_tokens=2)
            bad[reason] = json.loads(json.dumps(e.kv_export(chain[0])))
        out["rejects"] = {}
        for reason, p in bad.items():
            before, n0 = _pool_snapshot(dst), _rejects(dst, reason)
            try:
                dst.kv_import(p)
                problems.append(f"{reason}: imported")
            except KVMigrateError as err:
                out["rejects"][reason] = err.reason
                if err.reason != reason or _pool_snapshot(dst) != before \
                        or _rejects(dst, reason) != n0 + 1:
                    problems.append(f"{reason}: {err.reason}, pool "
                                    f"{before} -> {_pool_snapshot(dst)}")
        # an export while 8 other streams decode on the source
        ops.reset_launch_counts()
        st0 = src.stats()
        futs = [src.submit(p, max_new_tokens=TIER_NEW,
                           request_id=f"14b-busy-{i}")
                for i, p in enumerate(B)]
        busy_exports = 0
        while not all(f.done() for f in futs) or not busy_exports:
            src.kv_export(chain[busy_exports % len(chain)])
            busy_exports += 1
        busy = [f.result(timeout=600)["tokens"] for f in futs]
        steps = src.stats()["steps"] - st0["steps"]
        out["busy"] = {"exports": busy_exports, "steps": steps,
                       "launches": _expect_launches(
                           "phase 14 (b) busy source",
                           {"flash_decode_paged": 2 * steps})}
        if busy != want_b:
            problems.append("streams decoding beside exports differ")
        # across devices: the card's chain into the CPU port, and back
        ops.reset_launch_counts()
        to_cpu = DecodeEngine(cpu, **kw)
        to_cpu.kv_import(copy.deepcopy(payloads[0]))
        cpu_toks = to_cpu.start().generate(A[0], TIER_NEW)["tokens"]
        to_cpu.stop()
        from_cpu = DecodeEngine(cpu, **kw).start()
        cpu_b = from_cpu.generate(B[0], TIER_NEW)["tokens"]
        payload = json.loads(json.dumps(from_cpu.kv_export(B[0][:-1])))
        from_cpu.stop()
        st0 = dst.stats()
        dst.kv_import(payload)
        card_b = dst.generate(B[0], TIER_NEW)["tokens"]
        steps = dst.stats()["steps"] - st0["steps"]
        out["cross"] = {"steps": steps, "launches": _expect_launches(
            "phase 14 (b) across devices", {"flash_decode_paged": 2 * steps})}
        out["cross"]["ties"] = {
            "card_to_cpu": _ties(net, [A[0]], [cpu_toks], [src_toks[0]]),
            "cpu_to_card": _ties(net, [B[0]], [card_b], [cpu_b])}
        if problems:
            raise AssertionError(f"phase 14 (b): {problems}")
    except BaseException:
        for e in (src, dst):
            e.stop()
        raise
    finally:
        for e in others:
            e.stop()
    cold = _median_max(out["source"]["ttft_ms"])
    warm = _median_max(out["destination"]["ttft_ms"])
    out["ttft_ms"] = {"cold": cold, "after_import": warm}
    print(f"kv migrate (b): 8 chains of 7 blocks, export {out['export_ms']}"
          f" ms, import {out['import_ms']} ms, payload {sizes[0]} bytes; "
          f"destination tokens equal the source's, 8 hits of {TIER_CLAIM}; "
          f"time to first token (ms) after the import {warm}, cold {cold}; "
          f"rejects {out['rejects']}; {busy_exports} exports beside 8 "
          f"decoding streams, their tokens unchanged; across devices "
          f"{out['cross']['ties']} [{card}]", flush=True)
    res["migrate"] = out
    return src, dst


def _http(url, path, payload=None, headers=None):
    """(status, JSON body or text, headers) of one request."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, headers=dict(
        {"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            body, status, hdrs = r.read().decode(), r.status, r.headers
    except urllib.error.HTTPError as e:
        body, status, hdrs = e.read().decode(), e.code, e.headers
    try:
        body = json.loads(body)
    except ValueError:
        pass
    return status, body, dict(hdrs)


def http_part(net, card, res, src, dst, prompts):
    """Phase 14 (c): migration, the journal, /healthz and /metrics over
    HTTP (docstring)."""
    import copy
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving import (DecodeEngine,
                                                  InferenceServer)
    from deeplearning4j_tpu_torch.serving.engine import input_type_of
    from deeplearning4j_tpu_torch.serving.wire import ndarray_to_b64
    out, problems = {}, []
    dense = DecodeEngine(net, slots=TIER_STREAMS, max_len=512)
    small = DecodeEngine(net, slots=4, max_len=512, kv="paged",
                         kv_block_size=KV_BLOCK, chunk_tokens=CHUNK,
                         kv_blocks=41, max_queue=2)
    servers = [InferenceServer(net, port=0, decode_engine=e).start()
               for e in (src, dst, dense, small)]
    servers.append(InferenceServer(net, port=0, journal_capacity=8).start())
    s1, s2, s3, s4, s5 = [f"http://127.0.0.1:{s.port}" for s in servers]
    paged = (src, dst, small)
    try:
        ops.reset_launch_counts()
        steps0 = [e.stats()["steps"] for e in paged + (dense,)]
        p = prompts[0]
        gen = {"tokens": p, "max_new_tokens": TIER_NEW}
        st, r1, h1 = _http(s1, "/generate", gen, {
            "x-request-id": "14c-gen", "x-tenant": "acme",
            "x-priority": "batch"})
        st_e, payload, _ = _http(s1, "/kv/export", {"tokens": p[:-1]})
        st_i, imp, hi = _http(s2, "/kv/import", payload)
        st2, r2, h2 = _http(s2, "/generate", gen)
        torn = copy.deepcopy(payload)
        d = torn["leaves"][0]["data"]
        torn["leaves"][0]["data"] = d[:10] + ("B" if d[10] == "A"
                                              else "A") + d[11:]
        st_t, bt, _ = _http(s2, "/kv/import", torn)
        st_d, _, _ = _http(s3, "/kv/export", {"tokens": p[:-1]})
        out["migration"] = {
            "statuses": [st, st_e, st_i, st2, st_t, st_d], "import": imp,
            "torn_error": bt.get("error", {}).get("type"),
            "same_tokens": r1.get("tokens") == r2.get("tokens")}
        if ([st, st_e, st_i, st2, st_t, st_d] != [200, 200, 200, 200, 409,
                                                  404]
                or bt["error"]["type"] != "kv_migrate_rejected"
                or r1["tokens"] != r2["tokens"]
                or imp["imported_blocks"] != 7
                or h1.get("x-request-id") != "14c-gen"
                or not h2.get("x-request-id", "").startswith("req-")
                or hi.get("x-model-version") != "0"):
            problems.append(f"migration {out['migration']}, ids "
                            f"{h1.get('x-request-id')} "
                            f"{h2.get('x-request-id')}")
        # the journal: records of /generate on the paged and dense servers
        for i in range(2):
            _http(s3, "/generate", {"tokens": prompts[1 + i],
                                    "max_new_tokens": 16},
                  {"x-request-id": f"14c-dense-{i}"})
        _, j1, _ = _http(s1, "/requests?n=4")
        _, j2, _ = _http(s2, "/requests")
        _, j3, _ = _http(s3, "/requests?n=2")
        bad_n = _http(s1, "/requests?n=junk")[0]
        rec = {r["request_id"]: r for r in j1["records"]}.get("14c-gen")
        minted = {r["request_id"]: r for r in j2["records"]}.get(
            h2.get("x-request-id"))
        dense_recs = [r for r in j3["records"]
                      if r["request_id"].startswith("14c-dense-")]
        out["journal"] = {"record": rec, "minted": minted is not None,
                          "dense": dense_recs, "bad_n": bad_n}
        if (rec is None or (rec["tenant"], rec["priority"], rec["outcome"])
                != ("acme", "batch", "max_new")
                or sorted(rec["phases"]) != ["decode", "prefill", "queue"]
                or sorted(rec["kv"]) != ["host_restores", "peak_blocks",
                                         "prefix_hit_depth"]
                or minted is None or minted["kv"]["prefix_hit_depth"]
                != TIER_CLAIM or len(dense_recs) != 2
                or any("kv" in r for r in dense_recs) or bad_n != 400):
            problems.append(f"journal {out['journal']}")
        # a burst of 16 on a 4-slot engine whose queue holds 2
        burst, statuses = prompts[3:19], {}

        def shoot(i):
            statuses[i] = _http(s4, "/generate", {
                "tokens": burst[i][:32], "max_new_tokens": 32},
                {"x-request-id": f"14c-burst-{i}"})[0]
        with ThreadPoolExecutor(16) as ex:
            list(ex.map(shoot, range(16)))
        shed = [r for r in small.journal.tail()
                if r["request_id"].startswith("14c-burst-")]
        n429 = sum(s == 429 for s in statuses.values())
        out["burst"] = {"statuses": sorted(statuses.values()),
                        "records": len(shed), "shed": sum(
                            r["outcome"] == "shed" for r in shed)}
        if (not n429 or out["burst"]["shed"] != n429 or len(shed) != 16
                or len({r["request_id"] for r in shed}) != 16):
            problems.append(f"burst {out['burst']}")
        # /healthz while the head of the queue cannot claim its blocks
        a = small.submit(prompts[1], max_new_tokens=EXHAUST_NEW)
        b = small.submit(prompts[2], max_new_tokens=EXHAUST_NEW)
        seen, t0 = None, time.perf_counter()
        while time.perf_counter() - t0 < 120 and not a.done():
            h = _http(s4, "/healthz")[1]
            if h.get("reason") == "kv_pool_exhausted":
                seen = h
                break
            time.sleep(0.002)
        a.result(timeout=600)
        b.result(timeout=600)
        after = _http(s4, "/healthz")[1]
        out["healthz"] = {"exhausted": seen, "after": after}
        if (seen is None or seen["status"] != "degraded"
                or seen["kv"]["blocks_in_use"] < 32
                or after != {"status": "ok"}):
            problems.append(f"healthz {out['healthz']}")
        # /predict records (K5) on a server whose journal keeps 8
        x = np.eye(input_type_of(net).size, dtype=np.float32)[
            np.asarray(prompts[0][:64])][None]
        for i in range(12):
            _http(s5, "/predict", {"ndarray": ndarray_to_b64(x)},
                  {"x-request-id": f"14c-predict-{i}"})
        _, j5, _ = _http(s5, "/requests")
        out["predict"] = {"total": j5["total"], "dropped": j5["dropped"],
                          "phases": sorted(j5["records"][-1]["phases"])}
        if (j5["total"] - j5["dropped"] != 8 or len(j5["records"]) != 8
                or out["predict"]["phases"] != ["bucket", "device", "pad",
                                                "queue", "readback"]):
            problems.append(f"predict journal {out['predict']}")
        steps = [e.stats()["steps"] - s0
                 for e, s0 in zip(paged + (dense,), steps0)]
        calls = servers[4].batcher.stats()["device_calls"]
        out["steps"] = {"paged": sum(steps[:3]), "dense": steps[3],
                        "predict_calls": calls}
        out["launches"] = _expect_launches("phase 14 (c)", {
            "flash_decode_paged": 2 * sum(steps[:3]),
            "flash_decode": 2 * steps[3], "flash_attn_fwd": 2 * calls})
        # /metrics, and the p99 time to first token back to its record
        _, text, mh = _http(s1, "/metrics")
        series = ("dl4jtpu_kv_host_tier_bytes", "dl4jtpu_kv_host_spills_total",
                  "dl4jtpu_kv_migrate_imports_total",
                  "dl4jtpu_kv_migrate_rejects_total",
                  "dl4jtpu_decode_ttft_seconds_bucket")
        missing = [s for s in series if f"{s}{{" not in text]
        slo = _http(s1, "/stats")[1]["decode"]["slo"]["ttft"]
        rid, _v = src._m_ttft.exemplar_for(src._m_ttft.percentile(0.99))
        _, j1, _ = _http(s1, "/requests")
        out["metrics"] = {"missing": missing, "p99_ms": slo["p99_ms"],
                          "p99_exemplar": rid, "resolves": rid in {
                              r["request_id"] for r in j1["records"]}}
        if missing or not out["metrics"]["resolves"] \
                or not mh.get("Content-Type", "").startswith("text/plain"):
            problems.append(f"metrics {out['metrics']}")
        if problems:
            raise AssertionError(f"phase 14 (c): {problems}")
    finally:
        for s in servers:
            s.stop()
    print(f"kv http (c): /kv/export -> /kv/import -> /generate equal, torn "
          f"409, dense 404; journal {out['journal']['record']['phases']}, "
          f"burst {out['burst']}, healthz {out['healthz']['exhausted']} then "
          f"{out['healthz']['after']}, /predict journal {out['predict']}, "
          f"p99 time to first token {out['metrics']['p99_ms']} ms -> "
          f"{out['metrics']['p99_exemplar']}; launches {out['launches']} "
          f"[{card}]", flush=True)
    res["http"] = out


def kv_tier_phase(card, dev="cuda"):
    """Phase 14: the host KV tier, KV-chain migration, the request journal
    and the pool's health signal (``chip_smoke.py`` docstring)."""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_ids
    ids, vocab = corpus_ids()
    ids = [int(t) for t in ids]
    net = TinyTransformer(vocab_size=len(vocab)).init(device=dev)
    cpu = ComputationGraph(net.conf, device="cpu").set_params(net.params)
    res = {"card": card}
    t0 = time.perf_counter()
    taken = set()
    A = tier_prompts(ids, TIER_STREAMS, taken, 0)
    B = tier_prompts(ids, TIER_STREAMS, taken, 3001)
    http_prompts = tier_prompts(ids, 3, taken, 5003) + [
        ids[101 * i:101 * i + 48] for i in range(16)]
    waves = {"A": A, "B": B, "C": A}
    toks = tier_part(net, card, res, waves)
    res["tier_part_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    src, dst = migrate_part(net, cpu, card, res, waves,
                            toks["no_tier", "B"])
    res["migrate_part_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    http_part(net, card, res, src, dst, http_prompts)
    res["http_part_s"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    print(f"kv: phase 14 took {res['seconds']:.1f} s (tier "
          f"{res['tier_part_s']:.1f} s, migrate {res['migrate_part_s']:.1f} "
          f"s, http {res['http_part_s']:.1f} s) [{card}]", flush=True)
    return res


# ---- phase 15: the serving precisions -------------------------------------

PRECISIONS = ("f32", "int8", "fp8")
ACC_DELTA = {"int8": 0.01, "fp8": 0.02}   # docs/QUANTIZATION.md, against f32
PREC_TOL = 1e-4         # card against the CPU port at the same precision
BF16_TIE = 2e-2         # bfloat16 top-2 probability gap that may flip a token
PREC_B = 32             # the LSTM engine's ladder: 1..32
PREC_SIZES = [1, 3, 7, 2, 5, 16, 4, 9, 32, 11, 20, 1, 8]   # mixed /predict
PREC_TIMED = 20         # /predict calls timed at B=1 and B=32
PREC_NEW = 64           # new tokens a stream
PREC_DIR = ROOT / "build" / "precision_swap"
# (variant, zoo compute_dtype, serving precision) of the TinyTransformer
DECODE_VARIANTS = (("f32", None, "f32"), ("bf16", "bfloat16", "f32"),
                   ("int8", None, "int8"), ("fp8", None, "fp8"))


def _median_ms(fn, n):
    import torch
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def precision_lstm_part(card, res, dev="cuda"):
    """(a) The bundled TextGenerationLSTM through ``InferenceEngine`` at
    f32, int8 and fp8 (max_batch 32): held-out top-1 of the 15 windows
    (the deltas within docs/QUANTIZATION.md's bars), weight bytes, the
    card against the CPU port at the same precision (1e-4), ``warmup``'s
    rungs and costs, mixed-size traffic with no new capture and the
    captured rungs equal to an eager engine's bit for bit, /predict ms at
    B=1 and B=32 (captured and eager), exactly one K4 a forward."""
    import numpy as np
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.quant import record_accuracy_delta
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    (xtr, _), (xte, yte), vocab = corpus_windows(T=64)
    zoo = TextGenerationLSTM(total_unique_characters=len(vocab))
    net, cpu = zoo.init_pretrained(device=dev), zoo.init_pretrained(
        device="cpu")
    out, acc = {}, {}
    starts = np.cumsum([0] + PREC_SIZES)
    for prec in PRECISIONS:
        eng = InferenceEngine(net, PREC_B, precision=prec)
        eager = InferenceEngine(net, PREC_B, precision=prec)
        eager._program.capture = False
        ladder = eng.warmup((64, len(vocab)))
        eager.warmup((64, len(vocab)))
        caps, progs = eng.captures, eng.trace_count
        ops.reset_launch_counts()
        probs = eng.predict_host(xte)
        held = _expect_launches(f"precision {prec} held-out /predict",
                                {"lstm2_fwd": 1})
        acc[prec] = float((probs.argmax(-1) == yte.argmax(-1)).mean())
        want = InferenceEngine(cpu, PREC_B, precision=prec).predict_host(xte)
        err = float(np.abs(probs - want).max())
        ops.reset_launch_counts()
        bitwise = True
        for a, b in zip(starts[:-1], starts[1:]):
            x = xtr[np.arange(a, b) % len(xtr)]
            bitwise &= np.array_equal(eng.predict_host(x),
                                      eager.predict_host(x))
        mixed = _expect_launches(f"precision {prec} mixed /predict",
                                 {"lstm2_fwd": 2 * len(PREC_SIZES)})
        row = {"ladder": ladder, "rung_costs": eng.rung_costs,
               "warmup_s": eng.warmup_seconds, "captures": eng.captures,
               "programs": eng.trace_count, "heldout_top1": acc[prec],
               "weight_bytes": eng.stats()["weight_bytes"],
               "card_vs_cpu_max_abs_err": err,
               "captured_equals_eager": bitwise,
               "launches": {"lstm2_fwd": held["lstm2_fwd"]
                            + mixed["lstm2_fwd"]}}
        for B in (1, PREC_B):
            x = xtr[:B]
            row[f"predict_ms_b{B}"] = _median_ms(
                lambda: eng.predict_host(x), PREC_TIMED)
            row[f"eager_predict_ms_b{B}"] = _median_ms(
                lambda: eager.predict_host(x), PREC_TIMED)
        if prec != "f32":
            record_accuracy_delta(eng.id, acc[prec] - acc["f32"])
        out[prec] = row
        print(f"precision: LSTM {prec}: held-out top-1 {acc[prec]:.4f}, "
              f"{row['weight_bytes']} weight bytes, card vs CPU port "
              f"{err:.3g} (tol {PREC_TOL:g}); warmup captured {ladder} in "
              f"{row['warmup_s']:.3f} s (costs "
              f"{ {b: round(c['compile_s'], 4) for b, c in eng.rung_costs.items()} }"
              f" s), {len(PREC_SIZES)} mixed requests: captures "
              f"{eng.captures} (was {caps}), programs {eng.trace_count} (was "
              f"{progs}), captured == eager {bitwise}; /predict ms B=1 "
              f"{row['predict_ms_b1']:.3f} (eager "
              f"{row['eager_predict_ms_b1']:.3f}), B={PREC_B} "
              f"{row[f'predict_ms_b{PREC_B}']:.3f} (eager "
              f"{row[f'eager_predict_ms_b{PREC_B}']:.3f}) [{card}]",
              flush=True)
        problems = []
        if err > PREC_TOL:
            problems.append(f"card vs CPU {err}")
        if dev == "cuda" and (caps != len(ladder) or eng.captures != caps):
            problems.append(f"captures {caps} -> {eng.captures}")
        if eng.trace_count != progs or not bitwise:
            problems.append("a new program, or captured != eager")
        if prec != "f32" and abs(acc[prec] - acc["f32"]) > ACC_DELTA[prec]:
            problems.append(f"accuracy {acc[prec]} against {acc['f32']}")
        if problems:
            raise AssertionError(f"precision LSTM {prec}: {problems}")
    res["lstm"] = out


def _decode_prompts(ids):
    """8 held-out prompts of 16..58 corpus tokens."""
    return [ids[6000 + 131 * i:6000 + 131 * i + 16 + 6 * i]
            for i in range(8)]


def _ref_net(net, precision):
    """The CPU port's copy of ``net`` with the weights it serves at
    ``precision`` (dequantized codes): the near-tie rule's reference."""
    from deeplearning4j_tpu_torch import ComputationGraph
    from deeplearning4j_tpu_torch.quant import dequantize_tree, quantize_tree
    cpu = ComputationGraph(net.conf, device="cpu").set_params(net.params)
    if precision != "f32":
        cpu.set_params(dequantize_tree(quantize_tree(cpu.params, precision)))
    return cpu


def precision_decode_part(card, res, ids, dev="cuda"):
    """(b) TinyTransformer at its default width from its seed on captured
    dense and paged engines at f32, bfloat16 compute (a bfloat16 cache and
    pool: K8 / K9's bfloat16 instantiation), int8 and fp8: 8 greedy streams
    of 64 tokens against the CPU port's engine at the same precision under
    the near-tie rule (1e-4; 2e-2 in bfloat16), exact K8 / K9 launches, ms
    a captured step and tokens/s, weight bytes, and ten dense steps of each
    under torch.profiler (the dequantization's device operations a step
    are int8's or fp8's less f32's). (c) The int8 and fp8 self-drafts
    (k=4, dense): their tokens against the plain engine's, acceptance,
    tokens/s against the plain captured engine's."""
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.serving.spec import SpecConfig
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    V = res["vocab"]
    prompts = _decode_prompts(ids)
    out, nets = {}, {}
    for variant, compute, prec in DECODE_VARIANTS:
        kw = {} if compute is None else {"compute_dtype": compute}
        net = TinyTransformer(vocab_size=V, **kw).init(device=dev)
        cpu = ComputationGraph(net.conf, device="cpu").set_params(net.params)
        ref = _ref_net(net, prec)
        nets[variant] = net
        margin = BF16_TIE if compute else TIE_MARGIN
        for kv in ("dense", "paged"):
            mk = dict(slots=8, max_len=512, precision=prec, kv=kv,
                      kv_block_size=KV_BLOCK)
            eng = DecodeEngine(net, **mk).start()
            ceng = DecodeEngine(cpu, **mk).start()
            try:
                ops.reset_launch_counts()
                got, row, st0, st1 = _decode_round(eng, prompts, PREC_NEW,
                                                   False)
                launches = _expect_launches(
                    f"precision {variant} {kv}",
                    _expected_launches(eng, st0, st1))
                want = _decode_round(ceng, prompts, PREC_NEW, False)[0]
                caps = {k: p["captures"]
                        for k, p in eng.program_stats().items()}
                ties = _ties(ref, prompts, got, want, bar=margin)
                pool = eng._dstate["b0_attn"]["pk" if kv == "paged" else "k"]
                rec = dict(row, ties=ties, launches=launches, captures=caps,
                           weight_bytes=eng.stats()["weight_bytes"],
                           cache_dtype=str(pool.dtype).replace("torch.", ""),
                           trace_count=eng.trace_count)
                if kv == "dense":
                    if dev == "cuda":
                        rec["profile"] = _decode_profile(
                            eng, "flash_decode", card,
                            f"precision {variant}")
                    if variant == "f32":
                        out["plain_tokens"] = got
                        out["plain_tokens_per_s"] = row["tokens_per_s"]
            finally:
                eng.stop()
                ceng.stop()
            out[f"{variant}_{kv}"] = rec
            print(f"precision: TinyTransformer {variant} ({rec['cache_dtype']}"
                  f" cache) {kv}: {row['ms']:.3f} ms a captured step, "
                  f"{row['tokens_per_s']:.1f} tokens/s, "
                  f"{rec['weight_bytes']} weight bytes, launches {launches}, "
                  f"near-ties against the CPU port {ties} [{card}]",
                  flush=True)
            if dev == "cuda" and any(c != 1 for c in caps.values()):
                raise AssertionError(f"precision {variant} {kv}: captures "
                                     f"{caps}")
            if rec["cache_dtype"] != (compute or "float32"):
                raise AssertionError(f"{variant}: a {rec['cache_dtype']} "
                                     "cache")
    for q in ("int8", "fp8") if dev == "cuda" else ():
        pf, pq = out["f32_dense"]["profile"], out[f"{q}_dense"]["profile"]
        if pf.get("kernels_per_step") is not None \
                and pq.get("kernels_per_step") is not None:
            out[f"{q}_dequant_ops_per_step"] = (pq["kernels_per_step"]
                                                - pf["kernels_per_step"])
            out[f"{q}_dequant_busy_ms_per_step"] = (
                pq["device_busy_ms_per_step"] - pf["device_busy_ms_per_step"])
            print(f"precision: {q} dequantization "
                  f"{out[f'{q}_dequant_ops_per_step']:.0f} device operations "
                  f"and {out[f'{q}_dequant_busy_ms_per_step']:.4f} busy ms a "
                  f"step more than f32 [{card}]", flush=True)
    net = nets["f32"]
    ref = _ref_net(net, "f32")
    for q in ("int8", "fp8"):
        eng = DecodeEngine(net, slots=8, max_len=512,
                           spec=SpecConfig(self_draft=q, k=4)).start()
        try:
            ops.reset_launch_counts()
            got, row, st0, st1 = _decode_round(eng, prompts, PREC_NEW, True)
            launches = _expect_launches(f"precision self-draft {q}",
                                        _expected_launches(eng, st0, st1))
            spec = st1["spec"]
        finally:
            eng.stop()
        ties = _ties(ref, prompts, got, out["plain_tokens"])
        rec = dict(row, ties=ties, launches=launches,
                   acceptance=spec["acceptance_rate"],
                   draft_precision=spec["draft_precision"],
                   draft_weight_bytes=spec["draft_weight_bytes"],
                   speedup=row["tokens_per_s"] / out["plain_tokens_per_s"])
        out[f"self_draft_{q}"] = rec
        print(f"precision: self-draft {q} (k=4, dense): acceptance "
              f"{rec['acceptance']:.3f}, {row['tokens_per_s']:.1f} tokens/s "
              f"= {rec['speedup']:.2f}x the plain captured engine's "
              f"{out['plain_tokens_per_s']:.1f}, {row['ms']:.3f} ms a tick, "
              f"draft {rec['draft_weight_bytes']} bytes, launches "
              f"{launches}, near-ties {ties} [{card}]", flush=True)
        if spec["draft_precision"] != q:
            raise AssertionError(f"self-draft {q}: {spec['draft_precision']}")
    res["decode"] = out
    return nets


def precision_http_part(card, res, net, ids, dev="cuda"):
    """(d) Over HTTP, int8 on both engines (the TinyTransformer, a dense
    captured decode engine, /predict max_batch 16): /warmup captures the
    ladder; /admin/swap of a seed-7 zip while 8 /generate streams and
    mixed /predict run: the version bumps to 1 on both engines and in
    ``x-model-version``, no capture follows /warmup, and after the swap
    /generate's tokens equal a fresh int8 engine's on the seed-7 weights
    and /predict a fresh int8 engine's; a zip of d_model 64 answers 409
    ``weight_mismatch`` with serving unchanged, a payload without
    ``checkpoint`` 400."""
    import threading

    import numpy as np
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.serving import (DecodeEngine,
                                                  InferenceEngine,
                                                  InferenceServer)
    from deeplearning4j_tpu_torch.serving.wire import (ndarray_from_b64,
                                                       ndarray_to_b64)
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    V = res["vocab"]
    PREC_DIR.mkdir(parents=True, exist_ok=True)
    new = TinyTransformer(vocab_size=V, seed=7).init(device=dev)
    good, wrong = PREC_DIR / "seed7.zip", PREC_DIR / "d64.zip"
    write_model(new, good)
    write_model(TinyTransformer(vocab_size=V, d_model=64).init(device=dev),
                wrong)
    prompts = _decode_prompts(ids)
    eye = np.eye(V, dtype=np.float32)
    rows = np.array(ids[:64 * 32]).reshape(32, 64)
    cuts = np.cumsum([0, 1, 3, 7, 16, 5])
    xs = [eye[rows[a:b]] for a, b in zip(cuts[:-1], cuts[1:])]
    eng = InferenceEngine(net, 16, precision="int8")
    dec = DecodeEngine(net, slots=8, max_len=512, precision="int8")
    srv = InferenceServer(net, port=0, engine=eng, decode_engine=dec).start()
    url = f"http://127.0.0.1:{srv.port}"
    out = {}
    try:
        t0 = time.perf_counter()
        status, body, _ = _http(url, "/warmup", {"input_shape": [64, V],
                                                 "max_batch": 16})
        out["warmup"] = dict(body, status=status,
                             wall_s=time.perf_counter() - t0)
        if status != 200 or body["buckets"] != [1, 2, 4, 8, 16]:
            raise AssertionError(f"/warmup answered {status} {body}")
        caps = (eng.captures, {k: p["captures"]
                               for k, p in dec.program_stats().items()})
        calls0, steps0 = eng.stats()["device_calls"], dec.stats()["steps"]
        ops.reset_launch_counts()
        gens, preds = [None] * 8, []

        def generate(i):
            gens[i] = _http(url, "/generate", {"tokens": prompts[i],
                                               "max_new_tokens": PREC_NEW})

        def predict():
            for x in xs:
                preds.append(_http(url, "/predict",
                                   {"ndarray": ndarray_to_b64(x)}))
        threads = [threading.Thread(target=generate, args=(i,))
                   for i in range(8)] + [threading.Thread(target=predict)]
        for t in threads:
            t.start()
        t1 = time.perf_counter()
        status, body, _ = _http(url, "/admin/swap", {"checkpoint": str(good)})
        out["swap"] = dict(body, status=status,
                           wall_s=time.perf_counter() - t1)
        for t in threads:
            t.join()
        if status != 200 or body["version"] != 1:
            raise AssertionError(f"/admin/swap answered {status} {body}")
        during = {"generate": [g[2].get("x-model-version") for g in gens],
                  "predict": [p[2].get("x-model-version") for p in preds]}
        # after the swap: the seed-7 weights, version 1
        after = [_http(url, "/generate", {"tokens": p,
                                          "max_new_tokens": PREC_NEW})
                 for p in prompts]
        got = [a[1]["tokens"] for a in after]
        x = xs[2]
        status, body, hdrs = _http(url, "/predict",
                                   {"ndarray": ndarray_to_b64(x)})
        pred = ndarray_from_b64(body["ndarray"])
        launches = _expect_launches("precision HTTP", {
            "flash_attn_fwd": 2 * (eng.stats()["device_calls"] - calls0),
            "flash_decode": 2 * (dec.stats()["steps"] - steps0)})
        caps_after = (eng.captures, {k: p["captures"] for k, p in
                                     dec.program_stats().items()})
        fresh = DecodeEngine(new, slots=8, max_len=512,
                             precision="int8").start()
        try:
            want = _decode_round(fresh, prompts, PREC_NEW, False)[0]
        finally:
            fresh.stop()
        want_pred = InferenceEngine(new, 16, precision="int8").predict_host(x)
        rejects = {}
        for name, payload in (("wrong_width", {"checkpoint": str(wrong)}),
                              ("no_checkpoint", {})):
            st, b, _ = _http(url, "/admin/swap", payload)
            rejects[name] = (st, b["error"]["type"])
        st, b2, h2 = _http(url, "/predict", {"ndarray": ndarray_to_b64(x)})
        unchanged = np.array_equal(ndarray_from_b64(b2["ndarray"]), pred)
        out.update(during=during, after_version=hdrs.get("x-model-version"),
                   tokens_equal_fresh=got == want,
                   predict_max_abs_err=float(np.abs(pred - want_pred).max()),
                   launches=launches, captures=caps_after, rejects=rejects,
                   unchanged_after_rejects=unchanged,
                   versions=(eng.model_version, dec.model_version))
    finally:
        srv.stop()
        for f in (good, wrong):
            f.unlink(missing_ok=True)
    res["http"] = out
    print(f"precision: HTTP int8: /warmup {out['warmup']['buckets']} in "
          f"{out['warmup']['seconds']:.3f} s; /admin/swap during traffic "
          f"{out['swap']['status']} version {out['swap']['version']} in "
          f"{out['swap']['wall_s']:.3f} s (versions seen meanwhile "
          f"{out['during']}); after: x-model-version "
          f"{out['after_version']}, /generate == a fresh engine's "
          f"{out['tokens_equal_fresh']}, /predict vs a fresh engine "
          f"{out['predict_max_abs_err']:.3g}; captures {caps} -> "
          f"{caps_after}; rejects {rejects}, serving unchanged {unchanged}; "
          f"launches {launches} [{card}]", flush=True)
    problems = []
    if caps_after != caps:
        problems.append("a capture after /warmup")
    if not out["tokens_equal_fresh"] or out["predict_max_abs_err"] > 1e-6:
        problems.append("serving after the swap is not the new weights'")
    if out["after_version"] != "1" or out["versions"] != (1, 1):
        problems.append(f"versions {out['after_version']} {out['versions']}")
    if rejects != {"wrong_width": (409, "weight_mismatch"),
                   "no_checkpoint": (400, "bad_request")} or not unchanged:
        problems.append(f"rejects {rejects}, unchanged {unchanged}")
    if problems:
        raise AssertionError(f"precision HTTP: {problems}")


def serving_precision_phase(card, dev="cuda"):
    """Phase 15: the serving precisions and the bucketed engine's program
    contract (``chip_smoke.py`` docstring)."""
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_ids
    ids, vocab = corpus_ids()
    ids = [int(t) for t in ids]
    res = {"card": card, "vocab": len(vocab)}
    t0 = time.perf_counter()
    precision_lstm_part(card, res, dev)
    res["lstm_part_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    nets = precision_decode_part(card, res, ids, dev)
    res["decode_part_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    precision_http_part(card, res, nets["f32"], ids, dev)
    res["http_part_s"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    print(f"precision: phase 15 took {res['seconds']:.1f} s (LSTM "
          f"{res['lstm_part_s']:.1f} s, decode {res['decode_part_s']:.1f} s, "
          f"http {res['http_part_s']:.1f} s) [{card}]", flush=True)
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
    for part, args in ((prefix_part, (net, cpu, ids)),
                       (spec_part, (net, ids)), (spec_lstm_part, ()),
                       (captured_engine_part, (net, cpu, ids))):
        t0 = time.perf_counter()
        part(*args, card, res)
        print(f"serving: {part.__name__} {time.perf_counter() - t0:.1f} s "
              f"[{card}]", flush=True)
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


# ---- phase 16: observability over the captured engines and train steps ----
OBS_MAX_BATCH = 16            # the /predict engine's ladder 1..16
OBS_PREDICT_REPLAYS = 5       # rung-16 replays the launch check divides by
OBS_STREAMS, OBS_NEW = 8, 32  # /generate streams and tokens in a round
OBS_ROUNDS = 5                # rounds of tracing on against off
OBS_PROFILE_S = 2.0           # POST /admin/profile's session
FLIGHT_STEPS = 20             # recipe steps of each recorder run
FLIGHT_OFF_STEPS = 2          # of them before the recorder is attached
FLIGHT_SAMPLES = (1, 4)       # sample_every of the bitwise runs
FLIGHT_TIMED = (None, 1, 16)  # recorder off, K=1, K=16
FLIGHT_TIMED_STEPS = 40       # steps of one timed fit_scan call
FLIGHT_RTOL = 1e-4            # rows against the float64 host computation
FLIGHT_CAPTURES_MOVED = 1     # attaching a recorder: one capture (0 off
                              # the card, where nothing is captured)
CAPTURED_MS = {"lstm": 1.181, "tiny": 1.098}  # PERF.md 5, final run, PR 12


def _replay_launches(programs, caller, key, run, n):
    """``run()`` replays the program ``(caller, key)`` n times: its
    registered launches must be the counts' delta over them divided by n."""
    from deeplearning4j_tpu_torch import ops
    rec = programs.get(caller, key)
    ops.reset_launch_counts()
    run()
    counts = ops.launch_counts()
    got = {k: v / n for k, v in counts.items()}
    if got != rec["launches"]:
        raise AssertionError(f"program {caller}/{key}: registered launches "
                             f"{rec['launches']}, {got} a replay")
    return rec, counts


def _obs_prompts(ids, n, length, start):
    return [ids[start + 97 * i:start + 97 * i + length] for i in range(n)]


def obs_programs_part(card, res, net, srv, paged, vocab, ids):
    """(a) The registry over the captured programs: every program of the
    three engines listed by GET /programs with its cost; a record's
    launches are one replay's; the decode step's and the rung's kernel
    work is ``attn_work``'s at the program's shape; reading adds no
    program."""
    import torch
    from deeplearning4j_tpu_torch.exec import get_programs
    url = f"http://127.0.0.1:{srv.port}"
    dense, eng = srv.decode_engine, srv.engine
    st, body, _ = _http(url, "/warmup", {"input_shape": [TINY_T, vocab],
                                         "max_batch": OBS_MAX_BATCH})
    if st != 200:
        raise AssertionError(f"/warmup answered {st}: {body}")
    rungs = body["buckets"]
    before = (eng.trace_count, dense.trace_count, paged.trace_count,
              eng.captures, dense.program_stats(), paged.program_stats())
    st, body, _ = _http(url, "/programs")
    after = (eng.trace_count, dense.trace_count, paged.trace_count,
             eng.captures, dense.program_stats(), paged.program_stats())
    if st != 200 or after != before:
        raise AssertionError(f"/programs {st}; counts {before} -> {after}")
    callers = {eng.id: "predict", dense.id: "dense", paged.id: "paged"}
    mine = [p for p in body["programs"] if p["caller"] in callers]
    keys = sorted((callers[p["caller"]], p["key"]) for p in mine)
    want = sorted([("predict", f"b{b}") for b in rungs]
                  + [("dense", k) for k in dense.program_stats()]
                  + [("paged", k) for k in paged.program_stats()])
    missing = [p for p in mine if any(
        p[f] is None for f in ("flops", "bytes", "memory_bytes",
                               "compile_seconds"))]
    if keys != want or missing:
        raise AssertionError(f"/programs lists {keys}, want {want}; "
                             f"without a number: {missing}")
    L = sum(1 for n in net.conf.layer_nodes()
            if type(net.conf.nodes[n].layer).__name__ == "MultiHeadAttention")
    programs = get_programs()
    x16 = torch.zeros(OBS_MAX_BATCH, TINY_T, vocab)
    x16[..., 0] = 1.0

    def predict():
        for _ in range(OBS_PREDICT_REPLAYS):
            eng.predict_host(x16)
    rung, counts = _replay_launches(programs, eng.id, f"b{OBS_MAX_BATCH}",
                                    predict, OBS_PREDICT_REPLAYS)
    q = torch.zeros(OBS_MAX_BATCH * HEADS, TINY_T, HEAD_DIM)
    want_k5 = L * attn_work("flash_attn_fwd", {"q": q, "causal": True})[0]
    checks = {"b16": (rung["kernel_flops"], want_k5)}
    out = {"records": {f"{callers[p['caller']]}/{p['key']}":
                       {k: v for k, v in p.items() if k != "launches"}
                       | {"replay_launches": p["launches"]} for p in mine},
           "predict_replays": {"launches": counts}}
    for kind, e in (("dense", dense), ("paged", paged)):
        prompts = _obs_prompts(ids, e.slots, 1, 11)
        s0 = [0]

        def gen(e=e, prompts=prompts):
            s0[0] = e._steps
            futs = [e.submit(p, max_new_tokens=OBS_NEW) for p in prompts]
            for f in futs:
                f.result(timeout=300)
        from deeplearning4j_tpu_torch import ops
        ops.reset_launch_counts()
        gen()
        n = e._steps - s0[0]
        got = {k: v / n for k, v in ops.launch_counts().items()}
        rec = programs.get(e.id, "step")
        if got != rec["launches"]:
            raise AssertionError(f"{kind} step: registered launches "
                                 f"{rec['launches']}, {got} a replay")
        C = e.max_len
        c = {"q": torch.zeros(e.slots, HEADS, HEAD_DIM),
             "pos": torch.full((e.slots,), C - 1)}
        if kind == "dense":
            c["kc"] = torch.zeros(e.slots, C, HEADS, HEAD_DIM)
            kernel = "flash_decode"
        else:
            C = e._max_blocks * e.kv_block_size
            c["pos"] = torch.full((e.slots,), C - 1)
            c["pk"] = torch.zeros(1, e.kv_block_size, HEADS, HEAD_DIM)
            kernel = "flash_decode_paged"
        checks[kind] = (rec["kernel_flops"], L * attn_work(kernel, c)[0])
        out[f"{kind}_replays"] = {"launches": ops.launch_counts()}
        out[f"{kind}_kernel_share"] = rec["kernel_flops"] / rec["flops"]
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    out["kernel_flops"] = checks
    print(f"observability: (a) GET /programs lists {len(mine)} captured "
          f"programs of the /predict, dense and paged engines ({keys}), each "
          f"with flops, bytes, memory_bytes and compile_seconds; dense step "
          f"{programs.get(dense.id, 'step')['flops']:.4g} flops, "
          f"{programs.get(dense.id, 'step')['memory_bytes']} pool bytes, "
          f"kernel share {out['dense_kernel_share']:.3f}; paged step kernel "
          f"share {out['paged_kernel_share']:.3f}; launches a replay equal "
          f"the counts' delta; hand-kernel flops against attn_work "
          f"{checks}; reading /programs added no program [{card}]",
          flush=True)
    if bad:
        raise AssertionError(f"kernel flops against attn_work: {bad}")
    res["programs"] = out


def _spans_by_trace(doc):
    spans = {}
    for e in doc["traceEvents"]:
        tid = e.get("args", {}).get("trace_id")
        if e.get("ph") == "B" and tid:
            spans.setdefault(tid, set()).add(e["name"])
    return spans


def _obs_decode_round(e, prompts):
    """One round of ``prompts`` on engine ``e``: ms a step (the step's wall
    on the loop thread, its read included)."""
    s0, d0 = e._steps, e._decode_seconds
    futs = [e.submit(p, max_new_tokens=OBS_NEW) for p in prompts]
    for f in futs:
        f.result(timeout=300)
    return (e._decode_seconds - d0) / (e._steps - s0) * 1e3


def obs_trace_part(card, res, srv, vocab, ids):
    """(b) A /predict and a /generate with an ``x-trace-context`` header:
    their spans in GET /trace and their records in /requests carry its
    trace id; the captured decode step's ms with tracing on and off."""
    import numpy as np
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.monitor import trace
    from deeplearning4j_tpu_torch.serving.wire import ndarray_to_b64
    url = f"http://127.0.0.1:{srv.port}"
    x = np.zeros((3, TINY_T, vocab), np.float32)
    x[..., 0] = 1.0
    trace.clear()
    trace.enable(True)
    ops.reset_launch_counts()
    try:
        st1, _, _ = _http(url, "/predict", {"ndarray": ndarray_to_b64(x)},
                          {"x-trace-context": "smoke-predict;client#1"})
        st2, _, _ = _http(url, "/generate", {
            "tokens": _obs_prompts(ids, 1, 24, 5)[0], "max_new_tokens": 8},
            {"x-trace-context": "smoke-generate"})
        launches = ops.launch_counts()
        st3, doc, _ = _http(url, "/trace")
        st4, journal, _ = _http(url, "/requests")
    finally:
        trace.enable(False)
    spans = _spans_by_trace(doc)
    want_p = {"http_request", "enqueue", "bucket", "pad", "device",
              "readback"}
    want_g = {"http_request", "decode_step"}
    traced = {(r["source"], r["trace_id"]) for r in journal["records"]}
    ok = (st1 == st2 == st3 == st4 == 200
          and want_p <= spans.get("smoke-predict", set())
          and want_g <= spans.get("smoke-generate", set())
          and {("predict", "smoke-predict"),
               ("decode", "smoke-generate")} <= traced)
    out = {"spans": {k: sorted(v) for k, v in spans.items()},
           "launches": launches}
    prompts = _obs_prompts(ids, OBS_STREAMS, 16, 41)
    e = srv.decode_engine
    ms = {"off": [], "on": []}
    for _ in range(OBS_ROUNDS):
        for state in ("off", "on"):
            trace.enable(state == "on")
            ops.reset_launch_counts()
            try:
                ms[state].append(_obs_decode_round(e, prompts))
            finally:
                trace.enable(False)
            out.setdefault("rounds", []).append(
                {"tracing": state, "launches": ops.launch_counts()})
    trace.clear()
    out["step_ms"] = ms
    med = {k: statistics.median(v) for k, v in ms.items()}
    out["step_ms_median"] = med
    print(f"observability: (b) /predict and /generate with x-trace-context: "
          f"spans {out['spans']}; /requests records carry both trace ids "
          f"{ok}; captured dense decode step ({OBS_STREAMS} streams, "
          f"{OBS_NEW} tokens, {OBS_ROUNDS} rounds) tracing off "
          f"{med['off']:.3f} ms ({_spread(ms['off'])}), on "
          f"{med['on']:.3f} ms ({_spread(ms['on'])}) [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"traces: statuses {(st1, st2, st3, st4)}, "
                             f"spans {spans}, records {traced}")
    res["trace"] = out


def _decode_kernel_kinds(names):
    """Which of K8 / K9 appear among profiled kernel names: both are
    ``flash_decode_kernel`` instances, the third template argument PAGED
    (demangled ``<..., true, ...>``, mangled ``Lb1E``)."""
    import re
    kinds = set()
    for n in names:
        if "flash_decode_kernel" not in n:
            continue
        if "<" in n:
            args = [a.strip() for a in n.split("<", 1)[1].split(",")]
            paged = len(args) > 2 and args[2] == "true"
        else:
            m = re.search(r"flash_decode_kernelI\w*?Lb([01])E", n)
            paged = bool(m) and m.group(1) == "1"
        kinds.add("flash_decode_paged" if paged else "flash_decode")
    return kinds


def obs_profile_part(card, res, srv, paged_srv, ids):
    """(c) POST /admin/profile for OBS_PROFILE_S seconds under live
    /generate traffic to the dense and the paged engine: a second request
    meanwhile answers 409, and the written trace names K8 and K9, launched
    from graph replays."""
    import tempfile
    import threading
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.monitor import profiling
    stop = threading.Event()
    errors = []

    def traffic(s, seed):
        url = f"http://127.0.0.1:{s.port}"
        k = 0
        while not stop.is_set():
            st, body, _ = _http(url, "/generate", {
                "tokens": _obs_prompts(ids, 1, 12, seed + 13 * k)[0],
                "max_new_tokens": 16})
            if st != 200:
                errors.append((st, body))
            k += 1
    ops.reset_launch_counts()
    threads = [threading.Thread(target=traffic, args=(s, i * 500))
               for i, s in enumerate((srv, paged_srv))]
    for t in threads:
        t.start()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = str(Path(tmp) / "profile")
        try:
            url = f"http://127.0.0.1:{srv.port}"
            time.sleep(0.3)
            st1, b1, _ = _http(url, "/admin/profile",
                               {"dir": out_dir, "seconds": OBS_PROFILE_S})
            st2, b2, _ = _http(url, "/admin/profile",
                               {"dir": out_dir, "seconds": OBS_PROFILE_S})
            deadline = time.monotonic() + 120.0
            while profiling.profile_status()["profiling"]:
                if time.monotonic() > deadline:
                    raise AssertionError("the profiling session never ended")
                time.sleep(0.1)
        finally:
            stop.set()
            for t in threads:
                t.join()
        last = profiling.profile_status().get("last", {})
        names = set()
        if "trace" in last:
            with open(last["trace"]) as f:
                events = json.load(f)["traceEvents"]
            names = {e.get("name", "") for e in events
                     if e.get("cat") == "kernel"}
        kinds = _decode_kernel_kinds(names)
        size = (Path(last["trace"]).stat().st_size if "trace" in last
                else None)
    out = {"status": [st1, st2], "busy_type": (b2.get("error") or {}).get(
        "type") if isinstance(b2, dict) else None, "kernels": sorted(kinds),
        "kernel_names": len(names), "trace_bytes": size,
        "launches": ops.launch_counts()}
    print(f"observability: (c) POST /admin/profile {OBS_PROFILE_S} s under "
          f"/generate traffic on the dense and paged engines: {st1}, a "
          f"second request meanwhile {st2} ({out['busy_type']}); the trace "
          f"({size} bytes, {len(names)} kernel names) names "
          f"{sorted(kinds)}; traffic launches {out['launches']} [{card}]",
          flush=True)
    if (st1, st2, out["busy_type"]) != (200, 409, "profile_busy") or \
            kinds != {"flash_decode", "flash_decode_paged"} or errors:
        raise AssertionError(f"profiling: {out}, {last}, errors {errors[:3]}")
    res["profile"] = out


def _host64(net, tree=None):
    """A container's parameters (or a tree like them) as float64 numpy, per
    layer in the flight recorder's row order."""
    from deeplearning4j_tpu_torch.monitor import flight
    tree = net.params if tree is None else tree
    groups = tree if isinstance(tree, list) else [
        tree[n] for n in flight.layer_names(net)]
    return [{k: v.detach().double().cpu().numpy() for k, v in g.items()}
            for g in groups]


def _rows64(old, new, grad):
    """The telemetry rows from float64 host arrays."""
    import numpy as np
    rows = []
    for o, nw, g in zip(old, new, grad):
        if not nw:
            rows.append(np.zeros(5))
            continue
        u = {k: nw[k] - o[k] for k in nw}
        gs = sum((g[k] ** 2).sum() for k in nw)
        us = sum((u[k] ** 2).sum() for k in nw)
        ps = sum((nw[k] ** 2).sum() for k in nw)
        ua = sum(np.abs(u[k]).sum() for k in nw)
        pa = sum(np.abs(nw[k]).sum() for k in nw)
        n = sum(nw[k].size for k in nw)
        finite = all(np.isfinite(nw[k]).all() and np.isfinite(g[k]).all()
                     for k in nw)
        rows.append(np.array([np.sqrt(gs), np.sqrt(us), np.sqrt(ps),
                              ua / (pa + 1e-12 * max(n, 1)),
                              0.0 if finite else 1.0]))
    return np.stack(rows)


def _recorded_run(make, xs, ys, k, eager=False, host=False):
    """FLIGHT_STEPS recipe steps from ``make()``: FLIGHT_OFF_STEPS with no
    recorder, then the rest with a recorder sampling every ``k``. With
    ``host``, each sampled step's rows as a float64 host computation from
    the parameters before and after it and its gradients."""
    import numpy as np
    from deeplearning4j_tpu_torch.monitor import FlightRecorder
    net = make()
    if eager:
        net._capture_steps = False
    for s in range(FLIGHT_OFF_STEPS):
        net.fit_scan(xs[s:s + 1], ys[s:s + 1])
    c0 = net._capture_count
    rec = FlightRecorder(sample_every=k)
    net.attach_flight_recorder(rec)
    want = {}
    for s in range(FLIGHT_OFF_STEPS, FLIGHT_STEPS):
        if host and rec.sampled(s):
            before = _host64(net)
            grads = _host64(net, net.compute_gradient_and_score(
                xs[s], ys[s])[0])
        net.fit_scan(xs[s:s + 1], ys[s:s + 1])
        if host and rec.sampled(s):
            want[s] = _rows64(before, _host64(net), grads)
    got = {r["iteration"]: r["stats"] for r in rec.records()}
    err = None
    if host:
        err = max(float(np.max(np.abs(got[s] - w) / np.maximum(
            np.abs(w), 1e-30))) for s, w in want.items())
    return net, rec, net._capture_count - c0, got, err


def flight_model_part(card, res, name, make, xs, ys):
    """(d) for one recipe: recorder-off, K=1 and K=4 runs from one init;
    K=1 eager; bits, rows, captures; then ms a step off, K=1, K=16."""
    import torch
    from deeplearning4j_tpu_torch import ops
    out = {}
    ops.reset_launch_counts()
    off = make()
    for s in range(FLIGHT_STEPS):
        off.fit_scan(xs[s:s + 1], ys[s:s + 1])
    ref = _tensors(off)
    runs = {}
    for k in FLIGHT_SAMPLES:
        runs[k] = _recorded_run(make, xs, ys, k, host=k == 1)
    eager = _recorded_run(make, xs, ys, 1, eager=True)
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    bits = {k: all(torch.equal(a, b) for a, b in zip(_tensors(r[0]), ref))
            for k, r in runs.items()}
    cap_eager = all(torch.equal(a, b) for a, b in
                    zip(_tensors(runs[1][0]), _tensors(eager[0]))) and all(
        (runs[1][3][s] == eager[3][s]).all() for s in runs[1][3])
    moved = {k: r[2] for k, r in runs.items()}
    iters = {k: sorted(r[3]) for k, r in runs.items()}
    want_iters = {k: [s for s in range(FLIGHT_OFF_STEPS, FLIGHT_STEPS)
                      if s % k == 0] for k in FLIGHT_SAMPLES}
    out.update(bitwise_vs_off=bits, captured_vs_eager_bitwise=cap_eager,
               captures_moved=moved, host64_max_rel_err=runs[1][4],
               layer_names=runs[1][1].layer_names)
    print(f"observability: (d) {name}: {FLIGHT_STEPS} captured steps, the "
          f"recorder attached after {FLIGHT_OFF_STEPS}: parameters bit for "
          f"bit those of the recorder-off run {bits}; captured = eager with "
          f"the recorder (parameters and rows) {cap_eager}; captures moved "
          f"{moved}; rows against the float64 host computation max rel err "
          f"{runs[1][4]:.3g} (rtol {FLIGHT_RTOL}); records {iters}; launches "
          f"{out['launches']} [{card}]", flush=True)
    if not (all(bits.values()) and cap_eager
            and all(v == FLIGHT_CAPTURES_MOVED for v in moved.values())
            and iters == want_iters
            and runs[1][4] <= FLIGHT_RTOL):
        raise AssertionError(f"flight recorder, {name}: {out}")
    ms = {}
    nets = {}
    # every net warms and captures both of its graphs before the timed
    # calls: a sampled iteration's graph is captured at its second
    # sampled iteration (2 K steps in)
    warm = 2 * max(k for k in FLIGHT_TIMED if k is not None) + 2
    for k in FLIGHT_TIMED:
        net = nets[k] = make()
        net.fit_scan(xs[:2], ys[:2])
        if k is not None:
            from deeplearning4j_tpu_torch.monitor import FlightRecorder
            net.attach_flight_recorder(FlightRecorder(sample_every=k))
        net.fit_scan(xs[2:warm], ys[2:warm])
        ms[k] = []
    n = min(FLIGHT_TIMED_STEPS, len(xs) - warm)
    for _ in range(3):
        for k, net in nets.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit_scan(xs[warm:warm + n], ys[warm:warm + n])
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) / n * 1e3)
    med = {str(k): statistics.median(v) for k, v in ms.items()}
    out["ms_per_step"] = {str(k): v for k, v in ms.items()}
    out["ms_per_step_median"] = med
    shown = ", ".join(("recorder off" if k == "None" else f"K={k}")
                      + f" {v:.3f}" for k, v in med.items())
    print(f"observability: (d) {name}: ms a captured step (fit_scan of {n}, "
          f"3 rounds, median): {shown} (PERF.md 5: {CAPTURED_MS[name]} "
          f"captured) [{card}]", flush=True)
    res[name] = out
    return runs[1]


def flight_nan_part(card, res, make, xs, ys):
    """(d) a NaN planted in one feature of one example: the spill names the
    first non-finite layer, /train/diagnostics and /healthz show it."""
    import tempfile
    from deeplearning4j_tpu_torch.monitor import FlightRecorder
    from deeplearning4j_tpu_torch.serving import InferenceServer
    net = make()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "blackbox.json")
        rec = FlightRecorder(sample_every=1, spill_path=path,
                             spill_every=10_000)
        net.attach_flight_recorder(rec)
        net.fit_scan(xs[:1], ys[:1])
        bad = xs[1:2].clone()
        bad[0, 0, 0, 0] = float("nan")
        net.fit_scan(bad, ys[1:2])
        # the drain (any read) feeds the detector, which spills at once
        fnf = rec.first_non_finite()
        doc = FlightRecorder.restore(path)
    srv = InferenceServer(net, port=0, flight_recorder=rec).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        st1, diag, _ = _http(url, "/train/diagnostics")
        st2, health, _ = _http(url, "/healthz")
    finally:
        srv.stop()
    want = {"layer": "0:LSTM", "iteration": 1}
    out = {"spill_first_non_finite": doc["first_non_finite"],
           "diagnostics_first_non_finite": diag.get("first_non_finite"),
           "healthz": health}
    print(f"observability: (d) NaN in one feature of one example: the spill "
          f"names {doc['first_non_finite']}, /train/diagnostics ({st1}) "
          f"{diag.get('first_non_finite')}, /healthz ({st2}) "
          f"{health.get('reason')} [{card}]", flush=True)
    if not (doc["first_non_finite"] == want == fnf
            and diag.get("first_non_finite") == want
            and health.get("reason") == "train_non_finite"):
        raise AssertionError(f"NaN run: {out}")
    res["nan"] = out


def observability_phase(card, dev="cuda"):
    """Phase 16: the program registry, traces, profiling and the flight
    recorder over the captured engines (K5, K8, K9) and the captured train
    steps (K3, K4-train; K5-K7) (``chip_smoke.py`` docstring)."""
    import torch
    from deeplearning4j_tpu_torch.serving import DecodeEngine, InferenceServer
    from deeplearning4j_tpu_torch.zoo import (TextGenerationLSTM,
                                              TinyTransformer)
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_ids, corpus_windows
    t0 = time.perf_counter()
    ids, vocab = corpus_ids()
    ids = [int(t) for t in ids]
    V = len(vocab)
    res = {"card": card}
    net = TinyTransformer(vocab_size=V).init(device=dev)
    dense = DecodeEngine(net, slots=OBS_STREAMS, max_len=512)
    paged = DecodeEngine(net, slots=OBS_STREAMS, max_len=512, kv="paged",
                         kv_block_size=KV_BLOCK)
    srv = InferenceServer(net, port=0, max_batch=OBS_MAX_BATCH,
                          decode_engine=dense).start()
    paged_srv = InferenceServer(net, port=0, decode_engine=paged).start()
    try:
        obs_programs_part(card, res, net, srv, paged, V, ids)
        obs_trace_part(card, res, srv, V, ids)
        obs_profile_part(card, res, srv, paged_srv, ids)
    finally:
        srv.stop()
        paged_srv.stop()
    # stride 2: enough steps for the timed calls after both graphs' capture
    (xtr, ytr), _, _ = corpus_windows(stride=2)
    B, T = TINY_B, TINY_T
    steps = len(xtr) // B
    xs = torch.tensor(xtr[:steps * B].reshape(steps, B, T, -1)).to(dev)
    ys = torch.tensor(ytr[:steps * B].reshape(steps, B, T, -1)).to(dev)
    lstm = TextGenerationLSTM(total_unique_characters=V)
    tiny = TinyTransformer(vocab_size=V)
    flight_model_part(card, res, "lstm", lambda: lstm.init(device=dev), xs,
                      ys)
    flight_model_part(card, res, "tiny", lambda: tiny.init(device=dev), xs,
                      ys)
    flight_nan_part(card, res, lambda: lstm.init(device=dev), xs, ys)
    res["seconds"] = time.perf_counter() - t0
    print(f"observability: phase 16 took {res['seconds']:.1f} s [{card}]",
          flush=True)
    return res


ROUTED_MAX_BATCH = 16          # the in-process /predict engines: 1..16
ROUTED_SLOTS, ROUTED_MAXLEN = 8, 512
ROUTED_NEW = 16                # new tokens a /generate of the storm
ROUTED_THREADS = 4             # storm clients
ROUTED_DIR = ROOT / "build" / "routed"
AOT_FIELDS = ("flops", "bytes", "kernel_flops", "kernel_bytes", "launches")


def _routed_engines(net):
    """A /predict engine and the dense and paged decode engines of phase
    11's width."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine, InferenceEngine
    return (InferenceEngine(net, ROUTED_MAX_BATCH),
            DecodeEngine(net, slots=ROUTED_SLOTS, max_len=ROUTED_MAXLEN),
            DecodeEngine(net, slots=ROUTED_SLOTS, max_len=ROUTED_MAXLEN,
                         kv="paged", kv_block_size=KV_BLOCK))


def _warm_from(engines, vocab, art):
    """``warmup(aot=art)`` of each engine: wall seconds and the engine's
    own ``warmup_seconds``."""
    out = {}
    for tag, e in zip(("predict", "dense", "paged"), engines):
        t0 = time.perf_counter()
        if tag == "predict":
            e.warmup((TINY_T, vocab), aot=str(art))
        else:
            e.warmup(aot=str(art))
        out[tag] = {"wall_s": time.perf_counter() - t0,
                    "warmup_seconds": e.warmup_seconds}
    return out


def _engine_launches(eng, dense, paged, c0):
    """The K5 / K8 / K9 launches the engines' calls since ``c0`` (their
    device calls and steps) must have made, from one replay's registered
    launches."""
    from deeplearning4j_tpu_torch.exec import get_programs
    progs = get_programs()
    want = {}
    for e, n0 in zip(eng, c0[:len(eng)]):
        rec = progs.get(e.id, f"b{ROUTED_MAX_BATCH}")["launches"]
        for k, v in rec.items():
            want[k] = want.get(k, 0) + v * (e._calls - n0)
    for e, n0 in zip((dense, paged), c0[len(eng):]):
        for k, v in progs.get(e.id, "step")["launches"].items():
            want[k] = want.get(k, 0) + v * (e._steps - n0)
    return {k: v for k, v in want.items() if v}


def routed_aot_part(card, res, net, vocab, ids, art, dev="cuda"):
    """(a) One artifact from traced engines; fresh engines restore from
    it with no trace, one restore a program, the traced records, and the
    same outputs and tokens bit for bit."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.exec import get_programs
    from deeplearning4j_tpu_torch.exec.aot import AotBundle
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    traced = _routed_engines(net)
    t_secs = _warm_from(traced, vocab, art)
    restored = _routed_engines(net)
    r_secs = _warm_from(restored, vocab, art)
    # the second /predict engine of the routed tier restores too, and one
    # with the replicas' ladder (1..64) adds rungs 32 and 64
    extra = _routed_engines(net)[0]
    extra.warmup((TINY_T, vocab), aot=str(art))
    wide = InferenceEngine(net)
    wide.warmup((TINY_T, vocab), max_batch=64, aot=str(art))
    if (wide.trace_count, wide.aot_restores) != (2, 5):
        raise AssertionError(f"aot: the 1..64 ladder traced "
                             f"{wide.trace_count}, restored "
                             f"{wide.aot_restores}")
    bundle = AotBundle.load(art)
    progs = get_programs()
    checks = {}
    for tag, t, r in zip(("predict", "dense", "paged"), traced, restored):
        keys = ([f"b{b}" for b in (1, 2, 4, 8, 16)] if tag == "predict"
                else sorted(r._programs))
        n_prog = len(keys)
        same = all({f: progs.get(t.id, k)[f] for f in AOT_FIELDS}
                   == {f: progs.get(r.id, k)[f] for f in AOT_FIELDS}
                   for k in keys)
        checks[tag] = {"traced_trace_count": t.trace_count,
                       "trace_count": r.trace_count,
                       "restores": r.aot_restores, "programs": n_prog,
                       "records_equal": same,
                       "captures": (r.captures if tag == "predict" else
                                    sum(s["captures"] for s in
                                        r.program_stats().values()))}
        if (r.trace_count != 0 or r.aot_restores != n_prog or not same
                or checks[tag]["captures"]
                != (n_prog if dev == "cuda" else 0)):
            raise AssertionError(f"aot: {tag} restore {checks[tag]}")
    if extra.trace_count != 0 or extra.aot_restores != 5:
        raise AssertionError("aot: the second /predict engine traced")
    _, (xte, _), _ = corpus_windows(TINY_T)
    x = torch.tensor(xte[:15])
    prompts = [ids[101 * i:101 * i + 24] for i in range(ROUTED_SLOTS)]
    ops.reset_launch_counts()
    c0 = [traced[0]._calls, restored[0]._calls]
    s0 = [e._steps for e in traced[1:] + restored[1:]]
    preds = [e.predict_host(x) for e in (traced[0], restored[0])]
    toks = {}
    for tag, e in (("t_dense", traced[1]), ("t_paged", traced[2]),
                   ("r_dense", restored[1]), ("r_paged", restored[2])):
        e.start()
        toks[tag] = (_serve(e, prompts, ROUTED_NEW)[0]
                     + _serve(e, prompts, ROUTED_NEW, temp=0.8, seed=7)[0])
        e.stop()
    got = ops.launch_counts()
    want = {}
    for part in (_engine_launches(traced[:1], traced[1], traced[2],
                                  [c0[0], s0[0], s0[1]]),
                 _engine_launches(restored[:1], restored[1], restored[2],
                                  [c0[1], s0[2], s0[3]])):
        for k, v in part.items():
            want[k] = want.get(k, 0) + v
    bitwise = {"predict": bool(np.array_equal(preds[0], preds[1])),
               "dense": toks["t_dense"] == toks["r_dense"],
               "paged": toks["t_paged"] == toks["r_paged"]}
    out = {"checks": checks, "traced": t_secs, "restored": r_secs,
           "bitwise": bitwise, "launches": got,
           "artifact": {"programs": sorted(bundle.keys()),
                        "libraries": [m["name"] for m in bundle.libraries],
                        "nvcc": bundle.nvcc,
                        "bytes": os.path.getsize(art)}}
    print(f"routed: (a) artifact {art.name} "
          f"({out['artifact']['bytes']} bytes, {len(bundle)} recipes, "
          f"{len(bundle.libraries)} kernel libraries, {bundle.nvcc}); "
          f"restored engines: {checks}; warmup seconds traced "
          f"{ {k: round(v['warmup_seconds'], 4) for k, v in t_secs.items()} }"
          f" against restored "
          f"{ {k: round(v['warmup_seconds'], 4) for k, v in r_secs.items()} }"
          f" (walls {t_secs} / {r_secs}); outputs and tokens (greedy and "
          f"seeded) bit for bit: {bitwise}; launches {got} [{card}]",
          flush=True)
    if not all(bitwise.values()):
        raise AssertionError(f"aot: restored engines differ: {bitwise}")
    if got != want:
        raise AssertionError(f"aot: launches {got}, want {want}")
    res["aot"] = out
    return restored, extra, traced


def _tree_copy(dst):
    """The port's package alone, without built or cached files: a tree
    whose ``build/`` is empty."""
    import shutil
    shutil.copytree(ROOT / "deeplearning4j_tpu_torch",
                    dst / "deeplearning4j_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def routed_cold_part(card, res, built, dev="cuda"):
    """(b) Cold start: the nvcc seconds of each source, a tinyattn
    replica's ready seconds over the built tree without an artifact, and
    from an artifact in a copy of the package whose build directory is
    empty (it must run no nvcc: its libraries are the artifact's)."""
    import hashlib
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.exec.aot import AotBundle
    from deeplearning4j_tpu_torch.serving import ReplicaProcess
    from deeplearning4j_tpu_torch.serving.replica import (build_server,
                                                          warm_server)
    work = ROUTED_DIR / "cold"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = {k: v["seconds"] for k, v in built.items()}
    rep = ReplicaProcess(str(work), model="tinyattn", name="plain",
                         device=dev)
    try:
        rep.start().wait_ready(timeout=300)
        plain_s = rep.ready_seconds
    finally:
        rep.stop()
    plain_line = _ready_line(rep)
    # the tinyattn artifact, made in this process at the replica's
    # configuration (before any serving thread: it captures)
    art = ROUTED_DIR / "tinyattn.aot.zip"
    srv = build_server("tinyattn", device=dev)
    warm_server(srv, "tinyattn", str(art))
    bundle = AotBundle.load(art)
    tree = _tree_copy(Path(tempfile.mkdtemp(prefix="dl4j_tree_")))
    rep = ReplicaProcess(str(work), model="tinyattn", name="fromaot",
                         aot=str(art), env={"PYTHONPATH": str(tree)},
                         device=dev)
    try:
        rep.start().wait_ready(timeout=300)
        aot_s = rep.ready_seconds
    finally:
        rep.stop()
    aot_line = _ready_line(rep)
    built_dir = tree / "build" / "torch_kernels"
    files = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
             for p in built_dir.glob("*.so")} if built_dir.exists() else {}
    lib_sha = {m["name"]: m["sha256"] for m in bundle.libraries}
    shutil.rmtree(tree, ignore_errors=True)
    out = {"nvcc_seconds": nvcc, "ready_plain_s": plain_s,
           "ready_aot_s": aot_s, "tree": str(tree),
           "libraries": sorted(files), "plain_line": plain_line,
           "aot_line": aot_line}
    print(f"routed: (b) cold start: nvcc seconds per source "
          f"{ {k: round(v, 2) for k, v in nvcc.items()} }; tinyattn "
          f"replica ready in {plain_s:.2f} s over the built tree without "
          f"an artifact ({plain_line}), {aot_s:.2f} s with --aot from a "
          f"package copy with an empty build/ ({len(files)} libraries "
          f"installed from the artifact; {aot_line}) [{card}]", flush=True)
    if files != lib_sha or len(files) != len(built):
        raise AssertionError(f"cold: the copy's libraries {files} are not "
                             f"the artifact's {lib_sha}")
    if aot_line is None or "nvcc_runs=[]" not in aot_line:
        raise AssertionError(f"cold: the replica from the artifact built "
                             f"kernels: {aot_line}")
    res["cold"] = out


def _ready_line(rep):
    """The last ``REPLICA_READY`` line of a replica's log (its port,
    nvcc runs, traces, restores and boot seconds), or None."""
    ran = [ln for ln in Path(rep.log_path).read_text().splitlines()
           if ln.startswith("REPLICA_READY")]
    return ran[-1] if ran else None


def _restart_inproc(srv):
    """A new HTTP server over the same (captured) engines on the same
    port: the in-process replica's restart, which captures nothing."""
    from deeplearning4j_tpu_torch.resilience.faults import \
        ServerFaultInjector
    from deeplearning4j_tpu_torch.serving import InferenceServer
    srv.stop()
    new = InferenceServer(srv.model, port=srv.port,
                          max_batch=ROUTED_MAX_BATCH, engine=srv.engine,
                          decode_engine=srv.decode_engine,
                          fault_injector=ServerFaultInjector())
    return new.start()


def routed_tier_part(*args, **kwargs):
    """(c) A Router over two in-process servers restored in (a) (dense
    and paged decode) and one subprocess replica from the artifact, under
    a storm of /predict and /generate: failover under /chaos, a SIGKILL
    and an --aot restart of the subprocess, a rolling restart, a hedged
    /predict, a scripted fast 503; parity; K5 / K8 / K9 counted exactly
    in this process. Every server, process and router it starts is
    stopped, whether the part passes or not."""
    live = []
    try:
        _routed_tier(live, *args, **kwargs)
    finally:
        for obj in reversed(live):
            obj.stop()


def _routed_tier(live, card, res, net, vocab, ids, art, restored, extra,
                 traced, dev="cuda"):
    import threading
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.resilience.faults import (
        ServerFaultInjector, kill_replica)
    from deeplearning4j_tpu_torch.serving import (InferenceClient,
                                                  InferenceServer,
                                                  ReplicaProcess,
                                                  RetryBudget, Router)
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    eng_a, dense, paged = restored
    srvs = {"a": InferenceServer(net, port=0, max_batch=ROUTED_MAX_BATCH,
                                 engine=eng_a, decode_engine=dense,
                                 fault_injector=ServerFaultInjector()),
            "b": InferenceServer(net, port=0, max_batch=ROUTED_MAX_BATCH,
                                 engine=extra, decode_engine=paged,
                                 fault_injector=ServerFaultInjector())}
    for s in srvs.values():
        live.append(s.start())
    work = ROUTED_DIR / "tier"
    work.mkdir(parents=True, exist_ok=True)
    proc = ReplicaProcess(str(work), model="tinytransformer",
                          slots=ROUTED_SLOTS, max_len=ROUTED_MAXLEN,
                          aot=str(art), name="tier", device=dev)
    live.append(proc)
    proc.start().wait_ready(timeout=300)
    first_ready = proc.ready_seconds
    urls = {k: f"http://127.0.0.1:{s.port}" for k, s in srvs.items()}
    urls["p"] = proc.url
    # no prefix affinity: repeated prompts would all follow the paged
    # server's advertised chains, and the dense one must decode too
    router = Router(list(urls.values()), probe_interval=0.25,
                    hedge=False, prefix_affinity=False,
                    retry_budget=RetryBudget(ratio=0.5, initial=20.0,
                                             cap=50.0)).start()
    live.append(router)
    rurl = f"http://127.0.0.1:{router.port}"
    # the storm's requests and a single engine's answers
    _, (xte, _), _ = corpus_windows(TINY_T)
    sizes = (1, 3, 7, 16, 5, 2)
    xs, off = [], 0
    for n in sizes:
        xs.append(np.ascontiguousarray(xte[(np.arange(n) + off)
                                           % len(xte)]))
        off += n
    want_p = [traced[0].predict_host(torch.tensor(x)) for x in xs]
    prompts = [ids[53 * i + 7:53 * i + 7 + 20 + 3 * i] for i in range(6)]
    traced[1].start()
    want_t = _serve(traced[1], prompts, ROUTED_NEW)[0]
    traced[1].stop()
    errors, perr, toks = [], [], {i: [] for i in range(len(prompts))}
    stop = threading.Event()
    counts = {"predict": 0, "generate": 0}

    def client(k):
        cli = InferenceClient(rurl, timeout=300)
        i = k
        while not stop.is_set():
            try:
                if i % 2:
                    j = (i // 2) % len(xs)
                    got = cli.predict(xs[j])
                    perr.append(float(np.max(np.abs(got - want_p[j]))))
                    counts["predict"] += 1
                else:
                    j = (i // 2) % len(prompts)
                    toks[j].append(cli.generate(prompts[j],
                                                ROUTED_NEW)["tokens"])
                    counts["generate"] += 1
            except Exception as e:  # noqa: BLE001 -- every one is a fault
                errors.append(f"{type(e).__name__}: {e}")
            i += 1
        cli.close()
    ops.reset_launch_counts()
    c0 = [eng_a._calls, extra._calls, dense._steps, paged._steps]
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(ROUTED_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    events = {}
    time.sleep(1.0)
    st, body, _ = _http(urls["a"], "/chaos", {"fail_next": 12,
                                              "error_code": 503})
    events["chaos"] = body
    time.sleep(1.0)
    kill_replica(proc.proc)
    proc.proc.wait(timeout=30)
    proc._close_log()
    time.sleep(0.5)
    proc.start().wait_ready(timeout=300)
    events["killed_restart_ready_s"] = proc.ready_seconds

    def restarter(url):
        for k, u in urls.items():
            if u == url and k in srvs:
                srvs[k] = _restart_inproc(srvs[k])
                live.append(srvs[k])
                return
        proc.stop()
        proc.start().wait_ready(timeout=300)
    t_roll = time.perf_counter()
    router.rolling_restart(restarter, drain_timeout=60.0,
                           ready_timeout=300.0)
    events["rolling_restart_s"] = time.perf_counter() - t_roll
    events["rolling_ready_s"] = proc.ready_seconds
    # one hedged /predict: the primaries slow, the hedge fast
    router.hedge_enabled, router.hedge_delay_ms = True, 20.0
    for k in ("a", "p"):
        _http(urls[k], "/chaos", {"latency_ms": 400.0})
    hedge = None
    for _ in range(12):
        cli = InferenceClient(rurl)
        cli.predict(xs[0])
        cli.close()
        rec = [r for r in router.journal.snapshot()["records"]
               if r.get("hedged") and r.get("outcome") == "hedge_win"]
        if rec:
            hedge = rec[-1]
            break
    for k in ("a", "p"):
        _http(urls[k], "/chaos", {"latency_ms": 0.0})
    router.hedge_enabled = False
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=300)
    storm_s = time.perf_counter() - t0
    got = {k: v for k, v in ops.launch_counts().items()
           if k in ("flash_attn_fwd", "flash_decode", "flash_decode_paged")}
    want = _engine_launches([eng_a, extra], dense, paged, c0)
    # the scripted fast 503: every replica fails once, no budget left
    for u in urls.values():
        _http(u, "/chaos", {"fail_next": 1, "error_code": 500})
    router.budget = RetryBudget(ratio=0.0, initial=0.0)
    t1 = time.perf_counter()
    st503, body503, _ = _http(rurl, "/predict", {"ndarray": _b64(xs[0])})
    fast_s = time.perf_counter() - t1
    for u in urls.values():
        _http(u, "/chaos", {"fail_next": 0})
    ties = {}
    for j, p in enumerate(prompts):
        if toks[j]:
            ties[j] = _ties(net, [p] * len(toks[j]), toks[j],
                            [want_t[j]] * len(toks[j]))
    stats = router.stats()
    from deeplearning4j_tpu_torch.monitor import get_registry
    fam = get_registry().get("dl4jtpu_router_requests_total")
    outcomes = {f"{k[1]}:{k[2]}": c.value for k, c in fam.children()
                if k[0] == router.id and c.value}
    out = {"first_ready_s": first_ready, "events": events,
           "storm_s": storm_s, "requests": counts, "errors": errors,
           "predict_max_err": max(perr) if perr else None,
           "ties": ties, "hedge": hedge, "launches": got,
           "launches_want": want, "fast_503": {
               "status": st503, "seconds": fast_s,
               "type": (body503.get("error", {}).get("type")
                        if isinstance(body503, dict) else body503)},
           "outcomes": outcomes,
           "replicas": {u: s["state"] for u, s in
                        stats["replicas"].items()}}
    print(f"routed: (c) storm of {counts} through the router over 2 "
          f"in-process servers and a subprocess replica ({storm_s:.1f} s; "
          f"replica ready {first_ready:.2f} s, after SIGKILL "
          f"{events['killed_restart_ready_s']:.2f} s, in the rolling "
          f"restart {events['rolling_ready_s']:.2f} s; rolling restart "
          f"{events['rolling_restart_s']:.1f} s); router outcomes "
          f"{outcomes}; /predict max |err| {out['predict_max_err']} "
          f"against one engine; greedy near-ties {ties}; hedge "
          f"{None if hedge is None else hedge['hedge_winner']}; scripted "
          f"fast {st503} {out['fast_503']['type']} in {fast_s * 1e3:.1f} "
          f"ms; client errors {errors}; launches {got} (want {want}) "
          f"[{card}]", flush=True)
    if errors:
        raise AssertionError(f"tier: client-visible errors {errors[:5]}")
    if not perr or max(perr) > PROB_TOL or not all(toks.values()):
        raise AssertionError(f"tier: parity {out['predict_max_err']}, "
                             f"{ {j: len(v) for j, v in toks.items()} }")
    if hedge is None:
        raise AssertionError("tier: no hedged /predict won")
    if (st503, out["fast_503"]["type"]) != (503, "retry_budget_exhausted") \
            or fast_s > 2.0:
        raise AssertionError(f"tier: scripted 503 {out['fast_503']}")
    if outcomes.get("/predict:failed_over", 0) + outcomes.get(
            "/generate:failed_over", 0) == 0:
        raise AssertionError(f"tier: nothing failed over: {outcomes}")
    if got != want or (dev == "cuda" and not all(got.get(k) for k in (
            "flash_attn_fwd", "flash_decode", "flash_decode_paged"))):
        raise AssertionError(f"tier: launches {got}, want {want}")
    res["tier"] = out


def _b64(x):
    from deeplearning4j_tpu_torch.serving.wire import ndarray_to_b64
    return ndarray_to_b64(np.asarray(x))


def routed_scale_part(card, res, art, dev="cuda"):
    """(d) Scale from zero: a request held by the router wakes the
    autoscaler, a replica comes up from the artifact and serves it; then
    idle, the fleet drains back to zero."""
    from deeplearning4j_tpu_torch.serving import (Autoscaler,
                                                  InferenceClient,
                                                  ReplicaProcess, Router)
    work = ROUTED_DIR / "scale"
    work.mkdir(parents=True, exist_ok=True)
    handles = []

    def spawn():
        h = ReplicaProcess(str(work), model="tinytransformer",
                           slots=ROUTED_SLOTS, max_len=ROUTED_MAXLEN,
                           aot=str(art), name=f"auto{len(handles)}",
                           device=dev)
        handles.append(h)
        return h
    router = Router([], probe_interval=0.25, hold_for_capacity_s=300.0)
    scaler = Autoscaler(router, spawn, min_replicas=0, max_replicas=1,
                        idle_grace_s=2.0, cooldown_s=0.0, interval_s=0.2,
                        ready_timeout_s=300.0)
    router.wake_hook = scaler.wake
    router.start()
    scaler.start()
    try:
        cli = InferenceClient(f"http://127.0.0.1:{router.port}",
                              timeout=600)
        t0 = time.perf_counter()
        toks = cli.generate([1, 2, 3, 4, 5], 8)["tokens"]
        held = time.perf_counter() - t0
        cli.close()
        up = scaler.replica_count
        t1 = time.perf_counter()
        while scaler.replica_count and time.perf_counter() - t1 < 60:
            time.sleep(0.1)
        down = scaler.replica_count

        def exited():
            return all(h.proc is not None and h.proc.poll() is not None
                       for h in handles)
        while not exited() and time.perf_counter() - t1 < 90:
            time.sleep(0.1)
        drained = time.perf_counter() - t1
        exited = exited()
    finally:
        scaler.stop()
        router.stop()
        for h in handles:
            h.stop()
    out = {"held_s": held, "ready_s": handles[0].ready_seconds,
           "tokens": len(toks), "up": up, "down": down,
           "drain_s": drained, "exited": exited}
    print(f"routed: (d) scale from zero: the held /generate answered "
          f"{len(toks)} tokens in {held:.2f} s (replica ready "
          f"{out['ready_s']:.2f} s from the artifact); replicas {up} -> "
          f"{down} after {drained:.1f} s idle, process exited {exited} "
          f"[{card}]", flush=True)
    if len(toks) != 8 or up != 1 or down != 0 or not exited:
        raise AssertionError(f"scale: {out}")
    res["scale"] = out


def routed_phase(card, built, dev="cuda"):
    """Phase 17: the routed tier from an AOT artifact (``chip_smoke.py``
    docstring)."""
    import shutil
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_ids
    t0 = time.perf_counter()
    shutil.rmtree(ROUTED_DIR, ignore_errors=True)
    ROUTED_DIR.mkdir(parents=True)
    ids, vocab = corpus_ids()
    ids = [int(t) for t in ids]
    V = len(vocab)
    res = {"card": card}
    net = TinyTransformer(vocab_size=V).init(device=dev)
    art = ROUTED_DIR / "tinytransformer.aot.zip"
    restored, extra, traced = routed_aot_part(card, res, net, V, ids, art,
                                              dev)
    routed_cold_part(card, res, built, dev)
    routed_tier_part(card, res, net, V, ids, art, restored, extra, traced,
                     dev)
    routed_scale_part(card, res, art, dev)
    res["seconds"] = time.perf_counter() - t0
    print(f"routed: phase 17 took {res['seconds']:.1f} s [{card}]",
          flush=True)
    return res


DP_B, DP_T = 32, 64            # the LSTM / TinyTransformer recipe batches
DP_SLOTS = 4                   # slots of the in-process wrappers
DP_SYNC_STEPS = 20             # (a): sync steps against the plain fit
DP_PAD_ROWS = 30               # (a): a batch that needs two pad rows
DP_AVG_K, DP_AVG_ROUNDS = 4, 8  # (b): local steps a round, rounds
DP_GLOO_STEPS = 10             # (c): sync steps of the two gloo ranks
DP_NCCL_STEPS = 5              # (d): sync steps over the one-rank NCCL group
DP_WINDOWS = 15                # (e): the held-out windows
DP_SUBMITS = 3                 # (e): rows of each of seven submit() calls
DP_SHARED_BATCHES = 10         # (f): batches the shared master trains
DP_TIMEOUT = 300               # (c): seconds the two ranks may take
DP_TOL = 1e-5                  # parameters and gradients, F32 bars
DP_AVG_RTOL = 1e-4             # (b): of max |param|, card vs CPU port
DP_TINY_LR = 3e-4              # (b): TinyTransformer's Adam rate (zoo)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_batches(n, start=0):
    """``n`` recipe batches (B=32, T=64) of the corpus's training windows
    at stride 2, from batch ``start``, as DataSets of host arrays."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    (xtr, ytr), _, _ = corpus_windows(stride=2)
    total = len(xtr) // DP_B
    out = []
    for s in range(start, start + n):
        i = s % total
        out.append(DataSet(xtr[i * DP_B:(i + 1) * DP_B],
                           ytr[i * DP_B:(i + 1) * DP_B]))
    return out


def _max_diff(a, b):
    return max(float((x.float() - y.float().to(x.device)).abs().max())
               for x, y in zip(a, b))


def _timed_steps(run, n):
    """Median host ms of ``run(i)`` over ``n`` calls, synchronized."""
    import torch
    ms = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), ms


def dp_sync_part(card, res, V, dev="cuda"):
    """(a) Sync DP of the LSTM recipe in one process (world 1)."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    lstm = TextGenerationLSTM(total_unique_characters=V)
    data = _dp_batches(DP_SYNC_STEPS)
    out = {}
    dp, plain = lstm.init(device=dev), lstm.init(device=dev)
    pw = ParallelWrapper(dp, workers=DP_SLOTS)
    timed = DP_SYNC_STEPS // 2          # the later half: captured steps
    snaps, dp_ms, plain_ms = {}, [], []
    ops.reset_launch_counts()
    for i in range(DP_SYNC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pw.fit([data[i]])
        torch.cuda.synchronize()
        dp_ms.append((time.perf_counter() - t0) * 1e3)
        if i + 1 in (DP_NCCL_STEPS, DP_GLOO_STEPS):
            # the parameters (c) and (d) are held against
            snaps[i + 1] = [t.detach().cpu().clone() for t in _tensors(dp)]
    out["launches"] = _expect_launches(
        "phase 18 (a) sync DP", {"lstm2_fwd_train": DP_SYNC_STEPS,
                                 "lstm_bwd": 2 * DP_SYNC_STEPS})
    for i in range(DP_SYNC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.fit(data[i])
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    err = _max_diff(_tensors(dp), _tensors(plain))
    bitwise = all(torch.equal(a, b) for a, b in
                  zip(_tensors(dp), _tensors(plain)))
    step_ms = statistics.median(dp_ms[timed:])
    plain_step_ms = statistics.median(plain_ms[timed:])
    # the padded batch: 30 rows over 4 slots, the gradient program's
    # reduced gradient against the container's on the 30 rows
    x30 = data[0].features[:DP_PAD_ROWS]
    y30 = data[0].labels[:DP_PAD_ROWS]
    batch, pm = pw._prepare(DataSet(x30, y30))
    flats = pw._sync_gradients(batch, pm, dp.iteration)
    lay = pw._layout
    got = lay.unflatten([f[:-1] if i == lay.loss_at else f
                         for i, f in enumerate(flats)])
    want, score = dp.compute_gradient_and_score(x30, y30)
    pad_err = max(float((g[k] - w[k]).abs().max())
                  for g, w in zip(got, want) for k in w)
    pad_loss_err = abs(float(flats[lay.loss_at][-1]) - score)
    out.update(max_param_diff=err, bitwise=bitwise, pad_rows=int(
        batch.rows - DP_PAD_ROWS), pad_grad_max_abs_err=pad_err,
        pad_loss_err=pad_loss_err, ms_per_step=step_ms,
        plain_ms_per_step=plain_step_ms, ms=dp_ms, plain_ms=plain_ms)
    print(f"dp: (a) sync DP, TextGenerationLSTM (2 x LSTM(256), B={DP_B}, "
          f"T={DP_T}) over {DP_SLOTS} slots: {DP_SYNC_STEPS} steps against "
          f"the plain fit: parameters max diff {err:.3g} (bar {DP_TOL}; bit "
          f"for bit {bitwise}); launches {out['launches']}; B="
          f"{DP_PAD_ROWS} padded by {out['pad_rows']}: gradient max err "
          f"{pad_err:.3g}, loss err {pad_loss_err:.3g} (bar {DP_TOL}); ms a "
          f"captured step {step_ms:.3f} (plain fit {plain_step_ms:.3f}) "
          f"[{card}]", flush=True)
    if not (err <= DP_TOL and pad_err <= DP_TOL and pad_loss_err <= DP_TOL
            and out["pad_rows"] == 2):
        raise AssertionError(f"phase 18 (a): {out}")
    res["sync"] = out
    return lstm, data, snaps


def dp_avg_part(card, res, V, dev="cuda"):
    """(b) Averaging DP of TinyTransformer in one process."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    tiny = TinyTransformer(vocab_size=V)
    k = DP_AVG_K
    data = _dp_batches(k * DP_AVG_ROUNDS, start=DP_SYNC_STEPS)
    net = tiny.init(device=dev)
    pw = ParallelWrapper(net, workers=DP_SLOTS, averaging_frequency=k)
    per_round = {n: k * DP_SLOTS * 2 for n in (
        "flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")}
    out = {"per_round": [], "launches": {}}
    scores, ms = [], []
    for r in range(DP_AVG_ROUNDS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pw.fit(data[r * k:(r + 1) * k])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        got = _expect_launches(f"phase 18 (b) round {r}", per_round)
        out["per_round"].append(got)
        _add_counts(out["launches"], got)
        scores.append(net.get_score())
        if r == 0:
            # the CPU port's plain fit, slot by slot, then the mean
            lb = DP_B // DP_SLOTS
            cpus = []
            for j in range(DP_SLOTS):
                c = tiny.init(device="cpu")
                for ds in data[:k]:
                    c.fit(DataSet(ds.features[j * lb:(j + 1) * lb],
                                  ds.labels[j * lb:(j + 1) * lb]))
                cpus.append(c)
            keys = [(n, key) for n, d in net.params.items() for key in d]
            want = {nk: torch.stack([c.params[nk[0]][nk[1]]
                                     for c in cpus]).mean(0) for nk in keys}
            scale = max(float(w.abs().max()) for w in want.values())
            errs = {nk: float((net.params[nk[0]][nk[1]].cpu()
                               - want[nk]).abs().max()) for nk in keys}
            # a key bias's gradient is 0 in exact arithmetic (softmax
            # ignores a score shift a row), so Adam steps it by up to lr
            # on rounding noise, on each side: held within 2 x lr x k
            # (the rule of the parity tests' params_close)
            bk = {nk: e for nk, e in errs.items() if nk[1] == "bk"}
            rest = {nk: e for nk, e in errs.items() if nk[1] != "bk"}
            worst = max(rest, key=rest.get)
            out.update(round0_rel_err=rest[worst] / scale,
                       round0_worst=f"{worst[0]}/{worst[1]}",
                       round0_key_bias_err=max(bk.values()),
                       key_bias_bound=2 * DP_TINY_LR * k)
    out.update(scores=scores, ms_per_round=ms,
               ms_per_round_median=statistics.median(ms[2:]))
    print(f"dp: (b) averaging DP, TinyTransformer (d_model 128, 4 heads, 2 "
          f"blocks, B={DP_B}, T={DP_T}) over {DP_SLOTS} slots, k={k}: round 0 "
          f"against the CPU port's plain fits (mean of the slots) max err "
          f"{out['round0_rel_err']:.3g} of max |param| at "
          f"{out['round0_worst']} (bar {DP_AVG_RTOL}), key biases "
          f"{out['round0_key_bias_err']:.3g} (bar 2 x lr x k = "
          f"{out['key_bias_bound']:.3g}); "
          f"launches a round {per_round}; score {scores[0]:.4f} -> "
          f"{scores[-1]:.4f} over {DP_AVG_ROUNDS} rounds; ms a round "
          f"(median of rounds 2-{DP_AVG_ROUNDS - 1}) "
          f"{out['ms_per_round_median']:.3f} [{card}]", flush=True)
    if not (out["round0_rel_err"] <= DP_AVG_RTOL
            and out["round0_key_bias_err"] <= out["key_bias_bound"]
            and scores[-1] < scores[0]):
        raise AssertionError(f"phase 18 (b): {out}")
    res["averaging"] = out
    return tiny, net


def dp_rank_main(rank, world, port, out_dir):
    """One of (c)'s ranks: gloo over one card, the LSTM recipe's sync steps
    on its local_batch_slice; writes its parameters and numbers."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   distributed)
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, vocab = corpus_windows(stride=2)
    distributed.initialize(f"127.0.0.1:{port}", world, rank,
                           backend="gloo")
    net = TextGenerationLSTM(total_unique_characters=len(vocab)).init()
    pw = ParallelWrapper(net)
    sl = distributed.local_batch_slice(DP_B)
    data = [DataSet(d.features[sl], d.labels[sl])
            for d in _dp_batches(DP_GLOO_STEPS)]
    ops.reset_launch_counts()
    half = DP_GLOO_STEPS // 2
    for i in range(half):
        pw.fit([data[i]])
    c0 = dict(pw.comm)
    ms, _ = _timed_steps(lambda i: pw.fit([data[half + i]]),
                         DP_GLOO_STEPS - half)
    torch.cuda.synchronize()
    n = DP_GLOO_STEPS - half
    info = {"rank": rank, "rows": sl.stop - sl.start, "ms_per_step": ms,
            "allreduce_ms_per_step": (pw.comm["seconds"] - c0["seconds"])
            / n * 1e3,
            "allreduce_bytes_per_step": (pw.comm["bytes"] - c0["bytes"]) // n,
            "counts_exchange_ms_per_step": (pw.comm["host_seconds"]
                                            - c0["host_seconds"]) / n * 1e3,
            "allreduce_calls_per_step": (pw.comm["calls"] - c0["calls"]) // n,
            "launches": ops.launch_counts()}
    torch.save([t.detach().cpu() for t in _tensors(net)],
               Path(out_dir) / f"rank{rank}.pt")
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(info))
    distributed.shutdown()
    print(f"DP_RANK_{rank}_OK", flush=True)
    return 0


def dp_gloo_part(card, res, snaps):
    """(c) Two ranks sharing the card over gloo, in two subprocesses."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank",
             str(r), "2", str(port), tmp], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DP_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise AssertionError("phase 18 (c): the gloo ranks hung")
        for r, (p, o) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"DP_RANK_{r}_OK" not in o:
                raise AssertionError(f"phase 18 (c) rank {r}:\n{o[-4000:]}")
        params = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(2)]
        infos = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*params))
    err = _max_diff(params[0], snaps[DP_GLOO_STEPS])
    launches = {}
    for i in infos:
        for kname, v in i.pop("launches").items():
            launches[kname] = launches.get(kname, 0) + v
    # the ranks' own counters (other processes): reported, and kept out
    # of this process's kernels line
    out = {"ranks": infos, "bitwise_between_ranks": same,
           "max_diff_vs_a": err, "ranks_launches": launches}
    want = {"lstm2_fwd_train": 2 * DP_GLOO_STEPS,
            "lstm_bwd": 4 * DP_GLOO_STEPS}
    print(f"dp: (c) two ranks over gloo on one card, {DP_GLOO_STEPS} sync "
          f"steps of the LSTM recipe, rows {[i['rows'] for i in infos]}: "
          f"ranks bit for bit {same}; against (a) after {DP_GLOO_STEPS} "
          f"steps max diff {err:.3g} (bar {DP_TOL}); ms a step "
          f"{[round(i['ms_per_step'], 3) for i in infos]}, all-reduce ms a "
          f"step {[round(i['allreduce_ms_per_step'], 3) for i in infos]} "
          f"({infos[0]['allreduce_calls_per_step']} calls, "
          f"{infos[0]['allreduce_bytes_per_step']} bytes), the row counts' "
          f"exchange ms a step "
          f"{[round(i['counts_exchange_ms_per_step'], 3) for i in infos]}; "
          f"launches "
          f"{launches} (the ranks' own counters) [{card}]", flush=True)
    if not (same and err <= DP_TOL and launches == want):
        raise AssertionError(f"phase 18 (c): {out}")
    res["gloo"] = out


def dp_nccl_part(card, res, lstm, data, snaps):
    """(d) A one-rank NCCL group runs (a)'s sync step."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                                   distributed)
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        backend = dist.get_backend()
        net = lstm.init()
        pw = ParallelWrapper(net, workers=DP_SLOTS)
        ops.reset_launch_counts()
        for i in range(DP_NCCL_STEPS):
            pw.fit([data[i]])
        torch.cuda.synchronize()
        launches = _expect_launches(
            "phase 18 (d) NCCL", {"lstm2_fwd_train": DP_NCCL_STEPS,
                                  "lstm_bwd": 2 * DP_NCCL_STEPS})
        same = all(torch.equal(a.cpu(), b) for a, b in
                   zip(_tensors(net), snaps[DP_NCCL_STEPS]))
        # the NCCL all-reduce of the step's flat gradient, by CUDA events
        lay = pw._layout
        bufs = [torch.ones(sum(int(np.prod(s)) for _, _, s in
                               lay.buckets[dt]) + (i == lay.loss_at),
                           dtype=dt, device=net.device)
                for i, dt in enumerate(lay.dtypes)]
        nbytes = sum(b.numel() * b.element_size() for b in bufs)
        ms = time_ms(lambda: [dist.all_reduce(b) for b in bufs], 20)
    finally:
        distributed.shutdown()
    out = {"backend": backend, "launches": launches, "bitwise_vs_a": same,
           "allreduce_ms": ms, "allreduce_bytes": nbytes,
           "comm": dict(pw.comm)}
    print(f"dp: (d) one-rank {backend} group, {DP_NCCL_STEPS} sync steps: "
          f"parameters bit for bit (a)'s after {DP_NCCL_STEPS} {same}; "
          f"launches {launches}; the all-reduce of the step's {nbytes} "
          f"gradient bytes {ms:.4f} ms (CUDA events over 20, median of 5) "
          f"[{card}]", flush=True)
    if not (same and backend == "nccl"):
        raise AssertionError(f"phase 18 (d): {out}")
    res["nccl"] = out


def dp_inference_part(card, res, lstm_net, tiny_net, dev="cuda"):
    """(e) ParallelInference over 4 slots: output() and submit()."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    _, (xte, _), vocab = corpus_windows(64)
    x = xte[:DP_WINDOWS]
    out = {}
    for name, net, kernel in (("lstm", lstm_net, "lstm2_fwd"),
                              ("tiny", tiny_net, "flash_attn_fwd")):
        pi = ParallelInference(net, mesh=default_mesh(DP_SLOTS, device=dev),
                               batch_timeout_ms=20.0)
        want = net.output(x)
        ops.reset_launch_counts()
        got = pi.output(x)
        per = 1 if kernel == "lstm2_fwd" else 2
        o = {"launches": _expect_launches(f"phase 18 (e) {name} output",
                                          {kernel: per})}
        o["bitwise"] = bool(torch.equal(got, want))
        pi.warmup((DP_T, len(vocab)), max_batch=32)
        xs = [xte[i:i + DP_SUBMITS] for i in range(7)]
        singles = [net.output(a) for a in xs]
        ops.reset_launch_counts()
        pi.start()
        futs = [pi.submit(a) for a in xs]
        outs = [f.result(timeout=60) for f in futs]
        pi.shutdown()
        torch.cuda.synchronize()
        o["submit"] = {"launches": ops.launch_counts()}
        o["submit_max_abs_err"] = max(float((a - b).abs().max())
                                      for a, b in zip(outs, singles))
        out[name] = o
        print(f"dp: (e) ParallelInference on {name} over {DP_SLOTS} slots: "
              f"output() of {DP_WINDOWS} windows bit for bit the model's "
              f"{o['bitwise']} (launches {o['launches']}); 7 submits of "
              f"{DP_SUBMITS} rows against their unbatched forwards max err "
              f"{o['submit_max_abs_err']:.3g} (bar {DP_TOL}; launches "
              f"{o['submit']['launches']}) [{card}]", flush=True)
        if not (o["bitwise"] and o["submit_max_abs_err"] <= DP_TOL
                and set(o["submit"]["launches"]) == {kernel}):
            raise AssertionError(f"phase 18 (e) {name}: {o}")
    res["inference"] = out


def dp_shared_part(card, res, lstm, dev="cuda"):
    """(f) SharedTrainingMaster: two workers over ten recipe batches; the
    card's threshold encoding against the CPU port's."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel import compression
    from deeplearning4j_tpu_torch.scaleout import (ClusterMultiLayerNetwork,
                                                   SharedTrainingMaster)
    from deeplearning4j_tpu_torch.scaleout import training_master as tm
    net = lstm.init(device=dev)
    data = _dp_batches(DP_SHARED_BATCHES, start=DP_SYNC_STEPS)
    cn = ClusterMultiLayerNetwork(net, SharedTrainingMaster(
        threshold=1e-3, workers=2, batch_size_per_worker=DP_B,
        learning_rate=1.0))
    before = float(np.mean(cn.score_examples(data)))
    ops.reset_launch_counts()
    cn.fit(data)
    torch.cuda.synchronize()
    out = {"launches": _expect_launches(
        "phase 18 (f) shared master",
        {"lstm2_fwd_train": DP_SHARED_BATCHES,
         "lstm_bwd": 2 * DP_SHARED_BATCHES})}
    after = float(np.mean(cn.score_examples(data)))
    # one recipe gradient, encoded on the card and by the CPU port
    order = tm._order(net)
    _, g = tm._gradient(net, order, tm._vector(net, net.params, order),
                        [data[0].features], [data[0].labels])
    n = g.numel()
    cap = n // 10
    thr = float(g.abs().cpu().kthvalue(n - n // 20).values)
    got = compression.threshold_encode(g, thr, cap)
    want = compression.threshold_encode(g.cpu(), thr, cap)
    count = int(got[2])
    keep_g, keep_w = got[0].cpu() >= 0, want[0] >= 0
    same_idx = torch.equal(torch.sort(got[0].cpu()[keep_g]).values,
                           torch.sort(want[0][keep_w]).values)
    dense = compression.threshold_decode(got[0], got[1], n).cpu()
    dense_w = compression.threshold_decode(want[0], want[1], n)
    same_vals = torch.equal(dense, dense_w)
    out.update(score_before=before, score_after=after, count=count,
               capacity=cap, count_cpu=int(want[2]), same_indices=same_idx,
               same_values_bitwise=same_vals)
    print(f"dp: (f) SharedTrainingMaster, 2 workers over "
          f"{DP_SHARED_BATCHES} recipe batches: mean score {before:.4f} -> "
          f"{after:.4f}; launches {out['launches']}; threshold_encode of a "
          f"recipe gradient ({n} entries, capacity {cap}, threshold "
          f"{thr:.3g}): {count} sent on the card, {out['count_cpu']} by the "
          f"CPU port, the same indices {same_idx}, decoded values bit for "
          f"bit {same_vals} [{card}]", flush=True)
    if not (after < before and same_idx and same_vals
            and count == out["count_cpu"] and count < cap):
        raise AssertionError(f"phase 18 (f): {out}")
    res["shared"] = out


def dp_sdpa_part(card, res, dev="cuda"):
    """(g) scaled_dot_product_attention with offsets, and through K5."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        scaled_dot_product_attention as sdpa
    g = torch.Generator().manual_seed(18)
    B, H, Dh = 16, HEADS, HEAD_DIM
    q = torch.randn(B, DP_T, H, Dh, generator=g)
    k = torch.randn(B, 2 * DP_T, H, Dh, generator=g)
    v = torch.randn(B, 2 * DP_T, H, Dh, generator=g)
    out = {}
    ops.reset_launch_counts()
    got = sdpa(q.to(dev), k.to(dev), v.to(dev), causal=True,
               q_offset=DP_T, k_offset=0)
    plain = sdpa(q.double(), k.double(), v.double(), causal=True,
                 q_offset=DP_T, k_offset=0)
    out["offsets"] = {"launches": _expect_launches(
        "phase 18 (g) offsets", {}),
        "max_abs_err": float((got.double().cpu() - plain).abs().max())}
    qq, kk, vv = (t[:, :DP_T].contiguous() for t in (q, k, v))
    ops.reset_launch_counts()
    got = sdpa(qq.to(dev), kk.to(dev), vv.to(dev), causal=True)
    out["flash"] = {"launches": _expect_launches(
        "phase 18 (g) K5", {"flash_attn_fwd": 1})}
    plain = sdpa(qq, kk, vv, causal=True)
    out["flash"]["max_abs_err"] = float((got.cpu() - plain).abs().max())
    print(f"dp: (g) scaled_dot_product_attention (B={B}, {H} heads, Dh={Dh}, "
          f"causal): q_offset {DP_T}, k_offset 0 over {2 * DP_T} keys "
          f"against float64 max err {out['offsets']['max_abs_err']:.3g}, no "
          f"kernel; zero offsets through K5 (launches "
          f"{out['flash']['launches']}) against the CPU port max err "
          f"{out['flash']['max_abs_err']:.3g} (bar {ATTN_TOL}) [{card}]",
          flush=True)
    if not (out["offsets"]["max_abs_err"] <= ATTN_TOL
            and out["flash"]["max_abs_err"] <= ATTN_TOL):
        raise AssertionError(f"phase 18 (g): {out}")
    res["sdpa"] = out


def dp_phase(card, dev="cuda"):
    """Phase 18: data parallelism (``chip_smoke.py`` docstring)."""
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    t0 = time.perf_counter()
    _, _, vocab = corpus_windows(stride=2)
    V = len(vocab)
    res = {"card": card}
    lstm, data, snaps = dp_sync_part(card, res, V, dev)
    tiny, tiny_net = dp_avg_part(card, res, V, dev)
    dp_gloo_part(card, res, snaps)
    dp_nccl_part(card, res, lstm, data, snaps)
    lstm_net = lstm.init(device=dev)
    dp_inference_part(card, res, lstm_net, tiny_net, dev)
    dp_shared_part(card, res, lstm, dev)
    dp_sdpa_part(card, res, dev)
    res["seconds"] = time.perf_counter() - t0
    print(f"dp: phase 18 took {res['seconds']:.1f} s [{card}]", flush=True)
    return res


# ---- phase 19: the elastic cluster ----------------------------------------
CLUSTER_MODEL = "charlstm"      # LSTM(24) over T=16, vocabulary 16
CLUSTER_SEED, CLUSTER_STEPS, CLUSTER_B = 42, 8, 32
CLUSTER_CKPT_EVERY = 4
CLUSTER_KILL = "die_at_step=5"             # (b): worker 1's scripted death
CLUSTER_TIMEOUT = 180                      # each ClusterManager.run
# (b): a replacement on the card joins ~10 s after its spawn (a fresh
# process: imports, CUDA); JAX's 8 s default grace is sized for CPU workers
REPLACEMENT_GRACE = 60.0
CLUSTER_STEP_LAUNCHES = {"lstm_fwd_train": 1, "lstm_bwd": 1}
# (c): three workers, 30 rows, slowed so the steps outlast the lease
PART_STEPS, PART_B, PART_SLOW_MS = 10, 30, 700
THRESHOLD_LOSS = 0.05          # (c): the threshold run's loss from dense's
COMMS_REPS = 5                             # (d): allreduces of each plane


def _cluster_digests(res):
    return {w: r["params_digest"] for w, r in res["results"].items()}


def _worker_launches(res):
    """Each worker's launches against one K2 and one K3 per call of its
    gradient program (its own counters, in its payload): a step the chain
    tore after its gradients (a peer's death) ran them and is run again
    from the anchor. The sum over the workers."""
    total = {}
    for w, r in res["results"].items():
        want = {k: n * r["grad_calls"] for k, n in
                CLUSTER_STEP_LAUNCHES.items()} if r["device"] != "cpu" \
            else {}
        if r["launches"] != want:
            raise AssertionError(f"phase 19 worker {w}: launches "
                                 f"{r['launches']} over {r['grad_calls']} "
                                 f"gradient calls ({r['steps_run']} steps),"
                                 f" want {want}")
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def _cluster_summary(res):
    """ms a step (the median of the worker's steps after its first, which
    warms up and captures), comm seconds and bytes each way, per
    worker."""
    return {w: {"ms_per_step": statistics.median(r["step_ms"][1:]
                                                 or r["step_ms"]),
                "comm_ms_per_step": statistics.median(r["comm_ms"][1:]
                                                      or r["comm_ms"]),
                "first_step_ms": r["step_ms"][0],
                "comm_seconds": r["comms"]["comm_seconds"],
                "bytes_sent": r["comms"]["bytes_sent"],
                "bytes_recv": r["comms"]["bytes_recv"],
                "steps_run": r["steps_run"], "grad_calls": r["grad_calls"],
                "rank": r["rank"],
                "aot_restored": r["aot_restored"]}
            for w, r in sorted(res["results"].items())}


def _cluster_manager(workdir, dev, **kw):
    """A ClusterManager of phase 19's job; ``kw`` overrides its
    defaults."""
    from deeplearning4j_tpu_torch.exec.cluster import ClusterManager
    args = dict(workers=2, model=CLUSTER_MODEL, seed=CLUSTER_SEED,
                total_steps=CLUSTER_STEPS, global_batch=CLUSTER_B,
                ckpt_every=CLUSTER_CKPT_EVERY, aot=True, device=dev)
    args.update(kw)
    return ClusterManager(workdir, **args)


def _cluster_run(workdir, dev, **kw):
    t0 = time.perf_counter()
    res = _cluster_manager(workdir, dev, **kw).run(timeout=CLUSTER_TIMEOUT)
    res["wall_seconds"] = time.perf_counter() - t0
    return res


def _side_by_side(jobs):
    """Run each of ``jobs`` (name -> callable) in its own thread; their
    results by name, or the first error raised."""
    import threading
    out, errs = {}, []

    def run(name, fn):
        try:
            out[name] = fn()
        except BaseException as e:     # noqa: BLE001 -- raised below
            errs.append(e)
    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def _oracle_steps(dev):
    """``single_process_reference``'s loop over fresh programs, each step
    timed (host ms, synchronized): the oracle's ms a step."""
    import torch
    from deeplearning4j_tpu_torch.exec.executor import step_seed
    from deeplearning4j_tpu_torch.exec.worker import (dp_programs,
                                                      params_digest,
                                                      synth_batch)
    from deeplearning4j_tpu_torch.serving.replica import build_model
    net = build_model(CLUSTER_MODEL, device=dev)
    grad, upd = dp_programs(net)
    half = CLUSTER_B // 2
    ms = []
    for step in range(CLUSTER_STEPS):
        t0 = time.perf_counter()
        x, y = synth_batch(CLUSTER_MODEL, CLUSTER_SEED, step, CLUSTER_B)
        total = None
        for sl in (slice(0, half), slice(half, CLUSTER_B)):
            vec, _ = grad(x[sl], y[sl], step_seed(CLUSTER_SEED, step))
            vec = vec * np.float32(half)
            total = vec if total is None else total + vec
        upd((total / np.float32(CLUSTER_B))[1:])
        if dev != "cpu":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"ms": statistics.median(ms[1:]), "first_ms": ms[0],
            "params_digest": params_digest(net.params)}


def cluster_parity_part(card, res, work, dev="cuda"):
    """(a) The parity triangle: chain = star = the in-process oracle."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.exec.worker import \
        single_process_reference
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ref = single_process_reference(CLUSTER_MODEL, CLUSTER_SEED,
                                   CLUSTER_STEPS, CLUSTER_B, 2, device=dev)
    ref_s = time.perf_counter() - t0
    steady = _oracle_steps(dev)
    want = {k: n * 4 * CLUSTER_STEPS for k, n in
            CLUSTER_STEP_LAUNCHES.items()} if dev != "cpu" else {}
    launches = _expect_launches("phase 19 (a) oracle", want)
    if steady["params_digest"] != ref["params_digest"]:
        raise AssertionError(f"phase 19 (a): the timed oracle {steady} "
                             f"differs from {ref}")
    out = {"reference": ref, "reference_seconds": ref_s,
           "oracle_ms_per_step": steady["ms"],
           "oracle_first_step_ms": steady["first_ms"],
           "launches": launches}
    # the chain, the star and (c)'s threshold job are independent: they
    # run side by side (six workers on the card), each checked as alone
    t0 = time.perf_counter()
    runs = _side_by_side({
        "chain": lambda: _cluster_run(work / "chain", dev,
                                      data_plane="chain"),
        "star": lambda: _cluster_run(work / "star", dev, data_plane="star"),
        "threshold": lambda: _cluster_run(
            work / "threshold", dev, codec="threshold", bucket_mb=0.005,
            capacity_fraction=0.05)})
    out["side_by_side_seconds"] = time.perf_counter() - t0
    res["threshold_run"] = runs.pop("threshold")
    workers = {}
    for plane in ("chain", "star"):
        r = runs[plane]
        d = _cluster_digests(r)
        launches = _worker_launches(r)
        for k, n in launches.items():
            workers[k] = workers.get(k, 0) + n
        out[plane] = {"digests": d, "workers": _cluster_summary(r),
                      "generation": r["generation"],
                      "wall_seconds": r["wall_seconds"],
                      "workers_launches": launches}
        ok = (set(d.values()) == {ref["params_digest"]} and len(d) == 2
              and r["generation"] == 1 and r["spawns"] == 2
              and all(v["steps_run"] == CLUSTER_STEPS
                      for v in out[plane]["workers"].values()))
        print(f"cluster: (a) {plane}, 2 workers on one card, "
              f"{CLUSTER_MODEL} {CLUSTER_STEPS} steps of {CLUSTER_B} rows: "
              f"digests {sorted(set(d.values()))} against the oracle's "
              f"{ref['params_digest']} ({'bit for bit' if ok else 'DIFFER'}"
              f"); per worker ms a step (median after the first), its "
              f"allreduce's ms, comm s, bytes sent / received "
              + "; ".join(f"{w} {v['ms_per_step']:.3f} ms, "
                          f"{v['comm_ms_per_step']:.3f} ms, "
                          f"{v['comm_seconds']:.4f} s, {v['bytes_sent']} / "
                          f"{v['bytes_recv']} (first step "
                          f"{v['first_step_ms']:.1f} ms)"
                          for w, v in out[plane]["workers"].items())
              + f"; the workers' launches {launches}; run "
              f"{r['wall_seconds']:.1f} s beside the other jobs [{card}]",
              flush=True)
        if not ok:
            raise AssertionError(f"phase 19 (a) {plane}: {out[plane]}")
    print(f"cluster: (a) the oracle in this process: "
          f"{steady['ms']:.3f} ms a step (2 shard gradients and one "
          f"update; median after the first, {steady['first_ms']:.1f} ms); "
          f"single_process_reference {ref_s:.2f} s for {CLUSTER_STEPS} "
          f"steps; launches {out['launches']} (both runs) [{card}]",
          flush=True)
    out["workers_launches"] = workers
    res["parity"] = out
    return ref


def cluster_kill_part(card, res, work, ref, dev="cuda"):
    """(b) SIGKILL and replacement from the anchor and its AOT artifact."""
    import threading
    mgr = _cluster_manager(work / "kill", dev,
                           replacement_grace=REPLACEMENT_GRACE,
                           chaos={1: CLUSTER_KILL})
    mgr.start()
    died = {}

    def watch():        # when the scripted SIGKILL lands (20 ms polls)
        p = mgr.procs["w1"]
        while p.alive() and "stop" not in died:
            time.sleep(0.02)
        died.setdefault("at", time.time())
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    t0 = time.perf_counter()
    try:
        r = mgr.run(timeout=CLUSTER_TIMEOUT)
    finally:
        died.setdefault("stop", True)
        watcher.join(timeout=5)
    wall = time.perf_counter() - t0
    d = _cluster_digests(r)
    repl = r["results"].get("w1r1", {})
    first = repl.get("first_step_at")
    kill_to_step = (first - died["at"]) if first and "at" in died else None
    out = {"digests": d, "spawns": r["spawns"],
           "replacements": r["replacements"], "generation": r["generation"],
           "last_recovery_wall": r["last_recovery_wall"],
           "kill_to_first_step_s": kill_to_step,
           "replacement": {k: repl.get(k) for k in
                           ("aot_restored", "aot_rejected", "rank",
                            "steps_run", "rejoined")},
           "workers": _cluster_summary(r), "wall_seconds": wall,
           "w1_returncode": mgr.procs["w1"].proc.returncode,
           "survivor_returncode": mgr.procs["w0"].proc.returncode}
    launches = _worker_launches(r)
    log = mgr.procs["w1r1"].log_text() if "w1r1" in mgr.procs else ""
    ok = (set(d.values()) == {ref["params_digest"]} and len(d) == 2
          and r["spawns"] == 3 and r["replacements"] == 1
          and r["generation"] >= 2 and repl.get("aot_restored", 0) >= 1
          and repl.get("aot_rejected") == 0
          and "CLUSTER_AOT restored=" in log
          and out["survivor_returncode"] == 0 and kill_to_step is not None)
    print(f"cluster: (b) {CLUSTER_KILL} on worker 1: spawns {r['spawns']}, "
          f"replacements {r['replacements']}, generation {r['generation']}; "
          f"digests {sorted(set(d.values()))} against (a)'s "
          f"{ref['params_digest']} ({'bit for bit' if ok else 'FAILED'}); "
          f"the replacement restored {repl.get('aot_restored')} programs "
          f"from the artifact (rejected {repl.get('aot_rejected')}, its "
          f"captures' launches the recipes'), rank {repl.get('rank')}; "
          f"kill to its first step {kill_to_step:.2f} s, the coordinator's "
          f"eviction to commit {r['last_recovery_wall']:.2f} s; the "
          f"workers' launches {launches}; run {wall:.1f} s [{card}]"
          if kill_to_step is not None else f"cluster: (b) {out}",
          flush=True)
    if not ok:
        raise AssertionError(f"phase 19 (b): {out}\n{log[-3000:]}")
    out["workers_launches"] = launches
    res["kill"] = out


def _reap_partitioned(mgr, wid, timeout=CLUSTER_TIMEOUT):
    """SIGKILL ``wid`` once a generation without it has committed."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = mgr.coord.state()
        if st["generation"] >= 2 and wid not in st["members"]:
            mgr.procs[wid].kill()
            return
        time.sleep(0.05)


def cluster_partition_part(card, res, work, dev="cuda"):
    """(c) A partitioned worker evicted, the job committed at world 2;
    then the threshold codec on two workers."""
    import threading
    mgr = _cluster_manager(work / "part", dev, workers=3,
                           total_steps=PART_STEPS, global_batch=PART_B,
                           ckpt_every=3, aot=False, hb_interval=0.2,
                           suspect_after=0.8, evict_after=2.0,
                           replacement_grace=2.0, replace=False,
                           partition=[2],
                           chaos={i: f"slow_ms={PART_SLOW_MS}"
                                  for i in range(3)})
    t0 = time.perf_counter()
    mgr.start()
    try:
        deadline = time.monotonic() + CLUSTER_TIMEOUT
        while mgr.coord.reduced_steps < 2:   # partition after step 2
            if time.monotonic() > deadline:
                raise AssertionError("phase 19 (c): never reached step 2")
            time.sleep(0.05)
        pids = {w: p.pid for w, p in mgr.procs.items()}
        if not mgr.procs["w2"].alive():
            raise AssertionError("phase 19 (c): w2 died before the cut")
        mgr.partition_worker("w2")
        at_step = mgr.coord.reduced_steps
    except BaseException:
        mgr.stop()
        raise
    # w2 cannot hear of its eviction (its link is starved) and would wait
    # out its reform deadline: once the job commits without it, its
    # operator reaps it, so the run does not wait for it at the end
    reaper = threading.Thread(target=_reap_partitioned, args=(mgr, "w2"),
                              daemon=True)
    reaper.start()
    r = mgr.run(timeout=CLUSTER_TIMEOUT)
    reaper.join(timeout=5)
    wall = time.perf_counter() - t0
    evicted = [e for e in r["events"] if e["type"] == "evicted"]
    degraded = [e for e in r["events"]
                if e["type"] == "generation_committed" and e["world"] == 2]
    digs = _cluster_digests(r)
    same_pids = all(mgr.procs[w].pid == pids[w] for w in ("w0", "w1"))
    codes = {w: mgr.procs[w].proc.returncode for w in ("w0", "w1")}
    out = {"world": r["world"], "results": sorted(r["results"]),
           "digests": digs, "evicted": evicted, "partitioned_at": at_step,
           "degraded_commits": len(degraded),
           "reduced_steps": r["reduced_steps"], "same_pids": same_pids,
           "returncodes": codes, "wall_seconds": wall,
           "workers": _cluster_summary(r)}
    launches = _worker_launches(r)
    ok = (r["world"] == 2 and set(r["results"]) == {"w0", "w1"}
          and len(set(digs.values())) == 1 and evicted
          and evicted[0]["worker_id"] == "w2"
          and evicted[0]["reason"] == "lease_expired" and degraded
          and r["reduced_steps"] == PART_STEPS and same_pids
          and set(codes.values()) == {0})
    print(f"cluster: (c) 3 workers ({PART_SLOW_MS} ms a step), w2 "
          f"partitioned at step {at_step}: evicted "
          f"{[(e['worker_id'], e['reason']) for e in evicted[:1]]}, "
          f"committed "
          f"at world {r['world']}, {r['reduced_steps']} steps, survivors "
          f"{sorted(r['results'])} with their pids unchanged {same_pids} "
          f"and exit codes {codes}, one digest "
          f"{len(set(digs.values())) == 1}; the workers' launches "
          f"{launches}; run {wall:.1f} s [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"phase 19 (c): {out}")
    out["workers_launches"] = launches
    # the synthetic stream is uniform random tokens: no model gets the
    # expected loss under ln 16 = 2.7726, and step 0's is 2.7765, so the
    # bar is the dense chain's loss at the same step (same batches)
    dense_loss = res["parity"]["reference"]["final_loss"]
    t = res.pop("threshold_run")         # run beside (a)'s two jobs
    losses = {w: v["final_loss"] for w, v in t["results"].items()}
    tout = {"dense_final_loss": dense_loss, "final_losses": losses,
            "digests": _cluster_digests(t),
            "compression_ratio": {w: v["comms"]["compression_ratio"]
                                  for w, v in t["results"].items()},
            "workers": _cluster_summary(t),
            "wall_seconds": t["wall_seconds"],
            "workers_launches": _worker_launches(t)}
    ok = (len(set(tout["digests"].values())) == 1
          and all(np.isfinite(v) and abs(v - dense_loss) <= THRESHOLD_LOSS
                  for v in losses.values())
          and min(tout["compression_ratio"].values()) > 2.0)
    print(f"cluster: (c) codec threshold, 2 workers, {CLUSTER_STEPS} "
          f"steps: final loss {sorted(set(losses.values()))} against the "
          f"dense chain's {dense_loss:.4f} (bar {THRESHOLD_LOSS}), "
          f"compression {tout['compression_ratio']}, bytes sent "
          f"{[v['bytes_sent'] for v in tout['workers'].values()]}; run "
          f"{t['wall_seconds']:.1f} s beside (a)'s jobs [{card}]",
          flush=True)
    if not ok:
        raise AssertionError(f"phase 19 (c) threshold: {tout}")
    out["threshold"] = tout
    res["partition"] = out


def cluster_comms_part(card, res):
    """(d) The data plane alone: two in-process ChainComms members over
    loopback carry widemlp's vector; against the star's HTTP path. No
    kernel runs here."""
    import threading
    from deeplearning4j_tpu_torch.exec.comms import ChainComms
    from deeplearning4j_tpu_torch.exec.elastic import (CoordinatorServer,
                                                       ElasticCoordinator)
    from deeplearning4j_tpu_torch.exec.worker import CoordClient
    from deeplearning4j_tpu_torch.serving.replica import build_model
    net = build_model("widemlp", device="cpu")
    n = 1 + sum(v.numel() for p in net.params for v in p.values())
    rng = np.random.default_rng(19)
    vecs = [(rng.standard_normal(n) * 1e-3).astype(np.float32)
            for _ in range(2)]
    rows = [16, 16]

    def both(fns):
        outs, errs = [None, None], []

        def go(i):
            try:
                outs[i] = fns[i]()
            except BaseException as e:   # noqa: BLE001 -- raised below
                errs.append(e)
        ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        if errs:
            raise errs[0]
        return outs, (time.perf_counter() - t0) * 1e3

    out = {"elements": n, "bytes": 4 * n}
    results = {}
    for codec in ("dense", "threshold"):
        members = [ChainComms(codec=codec, codec_opts={
            "threshold": 1e-3, "capacity_fraction": 0.1}) for _ in range(2)]
        try:
            eps = {r: ("127.0.0.1", m.data_port)
                   for r, m in enumerate(members)}
            both([lambda r=r: members[r].configure(1, r, 2, eps)
                  for r in range(2)])
            ms = []
            for step in range(COMMS_REPS):
                got, t = both([lambda r=r: members[r].allreduce(
                    step, vecs[r], rows[r]) for r in range(2)])
                ms.append(t)
            results[codec] = got[0]
            out[codec] = {"ms": statistics.median(ms), "all_ms": ms,
                          "bytes_sent": members[0].last["bytes_sent"],
                          "compression_ratio":
                          members[0].last["compression_ratio"]}
        finally:
            for m in members:
                m.close()
    coord = ElasticCoordinator(2)
    srv = CoordinatorServer(coord, tick_interval=None).start()
    try:
        clients = [CoordClient(srv.url, f"w{r}") for r in range(2)]
        for c in clients:
            c.join()
        both([lambda c=c: c.sync(1) for c in clients])
        for c in clients:
            c.sync(1)
        ranks = {w: m["rank"] for w, m in coord.state()["members"].items()}
        ms = []
        for step in range(COMMS_REPS):
            got, t = both([lambda c=c, step=step: c.allreduce(
                1, step, rows[ranks[c.worker_id]],
                vecs[ranks[c.worker_id]]) for c in clients])
            ms.append(t)
        out["star"] = {"ms": statistics.median(ms), "all_ms": ms}
        star = got[0]
    finally:
        srv.stop()
    same = results["dense"].tobytes() == star.tobytes()
    print(f"cluster: (d) the data plane alone, widemlp's vector ({n} "
          f"float32, {4 * n} bytes) between two in-process members: "
          f"allreduce {out['dense']['ms']:.1f} ms dense chain, "
          f"{out['threshold']['ms']:.1f} ms threshold chain (compression "
          f"{out['threshold']['compression_ratio']:.1f}x), "
          f"{out['star']['ms']:.1f} ms the star over HTTP (medians of "
          f"{COMMS_REPS}); dense chain = star bit for bit {same} [{card}]",
          flush=True)
    if not same:
        raise AssertionError("phase 19 (d): the dense chain differs from "
                             "the star")
    res["comms"] = out


def cluster_phase(card, dev="cuda"):
    """Phase 19: the elastic cluster (``chip_smoke.py`` docstring)."""
    import shutil
    t0 = time.perf_counter()
    res = {"card": card, "kernel_rows": []}
    if dev != "cpu":
        # K2 and K3 at the shape the workers' gradient program gives them
        for kernel in ("lstm_fwd_train", "lstm_bwd"):
            row = kernel_case(kernel, 16, CLUSTER_B // 2, 24, "float32",
                              seed=1)
            print("cluster: phase 19 shape: " + fmt(row) + f" [{card}]",
                  flush=True)
            res["kernel_rows"].append(row)
    work = ROOT / "build" / "cluster"
    shutil.rmtree(work, ignore_errors=True)
    ref = cluster_parity_part(card, res, work, dev)
    cluster_kill_part(card, res, work, ref, dev)
    cluster_partition_part(card, res, work, dev)
    cluster_comms_part(card, res)
    res["seconds"] = time.perf_counter() - t0
    print(f"cluster: phase 19 took {res['seconds']:.1f} s [{card}]",
          flush=True)
    return res


# ---- phase 20: model parallelism -----------------------------------------
MP_V = 51                      # TinyTransformer's zoo vocabulary here
MP_B, MP_T = 32, 64            # (a), (c): rows a step, sequence length
MP_STEPS = 10                  # (a): Sgd steps of fit, and one fit_scan
MP_LR = 0.05                   # (a): Sgd rate (JAX tests/test_parallel.py)
MP_DATA, MP_MODEL = 4, 2       # (a): the (data, model) mesh
MP_RTOL, MP_ATOL = 1e-4, 1e-5  # (a): TP x DP against one slot on the card
MP_CONV_RTOL, MP_CONV_ATOL = 2e-4, 1e-4
MP_CPU_TOL = 1e-4              # of max |param|, against the CPU port
SP_B, SP_T, SP_SLOTS = 4, 4096, 4        # (b): the ring
SP_LAYER_B, SP_LAYER_T = 4, 256          # (b): SequenceParallelAttention
SP_TOL = 1e-4
SP_BF16_TOL = 2.0 ** -8   # a bfloat16 output's rounding, relative
PP_STAGES, PP_MICRO = 4, 8               # (c)
PP_STEPS, PP_LR = 5, 0.05
PP_FWD_TOL, PP_STEP_TOL = 1e-5, 1e-4
EP_D, EP_H, EP_E = 128, 512, 8           # (d)
EP_TOKENS = MP_B * MP_T
EP_STEPS, EP_LR, EP_AUX = 5, 0.1, 0.01
EP_TOL = 1e-5
MP_KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")


def _mp_tokens(n, start, vocab, T=MP_T, B=MP_B):
    """``n`` batches of B one-hot windows of the corpus (T tokens and the
    next), from window ``start``."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    (xtr, ytr), _, _ = corpus_windows(stride=2)
    out = []
    for s in range(start, start + n):
        i = s % (len(xtr) // B)
        out.append(DataSet(xtr[i * B:(i + 1) * B, :T],
                           ytr[i * B:(i + 1) * B, :T]))
    return out


def _param_errs(a, b):
    """(max |a - b| over two containers' parameters, a's and b's
    parameters by (member, key))."""
    pa, pb = _flat_params(a), _flat_params(b)
    err = max(float((x - pb[k].to(x.device)).abs().max())
              for k, x in pa.items())
    return err, pa, pb


def _flat_params(net):
    items = net.params.items() if isinstance(net.params, dict) \
        else enumerate(net.params)
    return {(m, k): v.detach().float() for m, p in items
            for k, v in p.items()}


def _step_agreement(got, want, before):
    """A step's change of ``got`` against ``want``'s from the same
    parameters ``before`` (by (member, key)), in norm: (the whole set's
    error over its change, the largest leaf error over that leaf's change
    where the change passes 100 x MP_ATOL, whether every leaf lies within
    MPF_BF16_LEAF_RTOL of its change plus MP_ATOL)."""
    import torch
    pg, pw = _flat_params(got), _flat_params(want)
    err = {k: float(torch.linalg.vector_norm(pg[k] - pw[k])) for k in pw}
    move = {k: float(torch.linalg.vector_norm(pw[k] - before[k]))
            for k in pw}
    whole = (sum(e * e for e in err.values())
             / sum(d * d for d in move.values())) ** 0.5
    leaf = max((err[k] / move[k] for k in pw if move[k] > 100 * MP_ATOL),
               default=0.0)
    ok = all(err[k] <= MPF_BF16_LEAF_RTOL * move[k] + MP_ATOL for k in pw)
    return whole, leaf, ok


def _allclose(pa, pb, rtol, atol):
    import torch
    return all(torch.allclose(x, pb[k].to(x.device), rtol=rtol, atol=atol)
               for k, x in pa.items())


def mp_tp_part(card, res, dev="cuda"):
    """(a) TP x DP through ParallelWrapper on a (data 4, model 2) mesh."""
    import torch
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.exec import build_mesh
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    zoo = TinyTransformer(vocab_size=MP_V, updater=Sgd(MP_LR))
    data = _mp_tokens(MP_STEPS, 0, MP_V)

    def mesh():
        return build_mesh([dev] * (MP_DATA * MP_MODEL),
                          model_parallel=MP_MODEL)
    out = {}
    net = zoo.init(device=dev)
    cpu = ComputationGraph(net.conf, device="cpu").set_params(net.params)
    pw = ParallelWrapper(net, mesh=mesh())
    per_step = {k: 2 * MP_MODEL for k in MP_KERNELS}
    ms, launches = [], {}
    for i in range(MP_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pw.fit([data[i]])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        _add_counts(launches, _expect_launches(
            f"phase 20 (a) TP step {i}", per_step))
    out["fit"] = {"launches": launches, "ms": ms}
    scan = zoo.init(device=dev)
    ops.reset_launch_counts()
    ParallelWrapper(scan, mesh=mesh()).fit_scan(
        np.stack([d.features for d in data]),
        np.stack([d.labels for d in data]))
    torch.cuda.synchronize()
    out["fit_scan"] = {"launches": _expect_launches(
        "phase 20 (a) TP fit_scan",
        {k: MP_STEPS * v for k, v in per_step.items()})}
    ref = zoo.init(device=dev)
    ref_ms = []
    ops.reset_launch_counts()
    for i in range(MP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref.fit(data[i])
        torch.cuda.synchronize()
        ref_ms.append((time.perf_counter() - t0) * 1e3)
    out["reference_launches"] = ops.launch_counts()
    for i in range(MP_STEPS):
        cpu.fit(data[i])
    err, pa, pb = _param_errs(net, ref)
    scan_err, ps, _ = _param_errs(scan, ref)
    cpu_err, _, pc = _param_errs(net, cpu)
    scale = max(float(v.abs().max()) for v in pc.values())
    out.update(
        max_param_diff=err, fit_scan_max_param_diff=scan_err,
        allclose=_allclose(pa, pb, MP_RTOL, MP_ATOL),
        fit_scan_allclose=_allclose(ps, pb, MP_RTOL, MP_ATOL),
        cpu_rel_err=cpu_err / scale, ms_per_step=statistics.median(ms[2:]),
        single_ms_per_step=statistics.median(ref_ms[2:]), single_ms=ref_ms,
        # the least of the captured steps: host time, which other work on
        # a shared host can stretch
        ms_min=min(ms[2:]), single_ms_min=min(ref_ms[2:]))
    print(f"mp: (a) TP x DP, TinyTransformer (d_model 128, 4 heads, 2 "
          f"blocks, vocab {MP_V}, B={MP_B}, T={MP_T}, Sgd({MP_LR})) over a "
          f"(data {MP_DATA}, model {MP_MODEL}) mesh: {MP_STEPS} fit steps "
          f"against one slot on the card max diff {err:.3g} (allclose rtol "
          f"{MP_RTOL} atol {MP_ATOL}: {out['allclose']}), fit_scan "
          f"{scan_err:.3g} ({out['fit_scan_allclose']}), against the CPU "
          f"port {out['cpu_rel_err']:.3g} of max |param| (bar {MP_CPU_TOL}); "
          f"launches a step {per_step}; ms a captured TP step median "
          f"{out['ms_per_step']:.3f} / min {out['ms_min']:.3f} (one slot "
          f"{out['single_ms_per_step']:.3f} / {out['single_ms_min']:.3f}) "
          f"[{card}]", flush=True)
    if not (out["allclose"] and out["fit_scan_allclose"]
            and out["cpu_rel_err"] <= MP_CPU_TOL):
        raise AssertionError(f"phase 20 (a): {out}")
    out["dense"] = _mp_small_tp(card, "dense", dev)
    out["lenet"] = _mp_small_tp(card, "lenet", dev)
    res["tp"] = out


def _mp_small_tp(card, which, dev):
    """(a) the dense net of JAX's TP tests (8-32-16-4, Sgd 0.1, B=16) and
    LeNet at 16 x 16 (B=8), two TP x DP steps against one slot."""
    import torch
    from deeplearning4j_tpu_torch import (MultiLayerNetwork,
                                          NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.exec import build_mesh
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import LeNet
    rs = np.random.RandomState(3)
    if which == "dense":
        def make():
            conf = (NeuralNetConfiguration.builder().seed(9)
                    .updater(Sgd(0.1)).weight_init("xavier").list()
                    .layer(DenseLayer(n_out=32, activation="relu"))
                    .layer(DenseLayer(n_out=16, activation="relu"))
                    .layer(OutputLayer(n_out=4, activation="softmax",
                                       loss="mcxent"))
                    .set_input_type(InputType.feed_forward(8)).build())
            return MultiLayerNetwork(conf, device=dev).init()
        x = rs.randn(32, 8).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 32)]
        bs, rtol, atol = 16, MP_RTOL, MP_ATOL
    else:
        def make():
            return LeNet(num_classes=10, input_shape=(16, 16, 1),
                         seed=12345).init(device=dev)
        x = rs.rand(16, 16, 16, 1).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 16)]
        bs, rtol, atol = 8, MP_CONV_RTOL, MP_CONV_ATOL
    batches = [DataSet(x[i:i + bs], y[i:i + bs]) for i in range(0, len(x),
                                                                bs)]
    ref, net = make(), make()
    for b in batches:
        ref.fit(b)
    ParallelWrapper(net, mesh=build_mesh(
        [dev] * (MP_DATA * MP_MODEL), model_parallel=MP_MODEL)).fit(batches)
    torch.cuda.synchronize()
    err, pa, pb = _param_errs(net, ref)
    ok = _allclose(pa, pb, rtol, atol)
    print(f"mp: (a) {which} TP x DP, {len(batches)} steps of B={bs} against "
          f"one slot: max diff {err:.3g} (allclose rtol {rtol} atol {atol}: "
          f"{ok}) [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"phase 20 (a) {which}: {err}")
    return {"max_param_diff": err, "allclose": ok}


def mp_sp_part(card, res, dev="cuda"):
    """(b) Ring attention over a ("seq",) mesh of 4 slots."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        MultiHeadAttention
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        SequenceParallelAttention, _pairs, _ring_plain, ring_attention)
    from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh
    mesh = default_mesh(SP_SLOTS, "seq", device=dev)
    g = torch.Generator().manual_seed(20)
    B, T, H, Dh = SP_B, SP_T, HEADS, HEAD_DIM
    q, k, v = (torch.randn(B, T, H, Dh, generator=g).to(dev)
               for _ in range(3))

    def fold(a):
        return a.permute(0, 2, 1, 3).reshape(B * H, T, Dh).contiguous()
    out = {}
    for causal in (True, False):
        n_pairs = len(_pairs(SP_SLOTS, causal))
        ops.reset_launch_counts()
        got = ring_attention(q, k, v, mesh, causal=causal)
        torch.cuda.synchronize()
        launches = _expect_launches(f"phase 20 (b) ring causal={causal}",
                                    {"flash_attn_fwd": n_pairs})
        full = ops.flash_attention_fwd(fold(q), fold(k), fold(v), causal)[0]
        full = full.reshape(B, H, T, Dh).permute(0, 2, 1, 3)
        plain = _ring_plain(q, k, v, SP_SLOTS, causal)
        ring_ms = time_ms(lambda: ring_attention(q, k, v, mesh,
                                                 causal=causal), 3)
        full_ms = time_ms(lambda: ops.flash_attention_fwd(
            fold(q), fold(k), fold(v), causal), 3)
        key = "causal" if causal else "plain"
        out[key] = {"launches": launches,
                    "vs_full_k5": float((got - full).abs().max()),
                    "vs_plain": float((got - plain).abs().max()),
                    "ring_ms": ring_ms, "full_k5_ms": full_ms}
        print(f"mp: (b) ring_attention (B={B}, T={T}, {H} heads, Dh={Dh}, "
              f"{SP_SLOTS} slots, {key}): against one full K5 max err "
              f"{out[key]['vs_full_k5']:.3g}, against the plain recurrence "
              f"{out[key]['vs_plain']:.3g} (bar {SP_TOL}); launches "
              f"{launches}; ms {ring_ms:.4f} (full K5 {full_ms:.4f}) "
              f"[{card}]", flush=True)
    # a bfloat16 input rides the same kernels, folded to float32 around
    # the ring: its result is the float32 ring's over the rounded inputs
    qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, v))
    n_pairs = len(_pairs(SP_SLOTS, True))
    ops.reset_launch_counts()
    got = ring_attention(qb, kb, vb, mesh, causal=True)
    torch.cuda.synchronize()
    launches = _expect_launches("phase 20 (b) ring bfloat16",
                                {"flash_attn_fwd": n_pairs})
    plain = _ring_plain(qb.float(), kb.float(), vb.float(), SP_SLOTS, True)
    out["causal_bf16"] = {
        "launches": launches, "dtype": str(got.dtype),
        "vs_plain": float((got.float() - plain).abs().max())
        / float(plain.abs().max())}
    print(f"mp: (b) ring_attention on bfloat16 inputs (causal): "
          f"{got.dtype}, against the plain recurrence in float32 over the "
          f"same inputs {out['causal_bf16']['vs_plain']:.3g} of max (bar "
          f"{SP_BF16_TOL}, bfloat16's rounding of the output); launches "
          f"{launches} [{card}]", flush=True)
    layer = MultiHeadAttention(n_in=128, n_out=128, n_heads=HEADS,
                               causal=True)
    params = {kk: t.to(dev) for kk, t in layer.init(
        torch.Generator().manual_seed(21)).items()}
    x = torch.randn(SP_LAYER_B, SP_LAYER_T, 128, generator=g).to(dev)
    spa = SequenceParallelAttention(layer, mesh)

    def run(fn):
        p = {kk: t.clone().requires_grad_() for kk, t in params.items()}
        xt = x.clone().requires_grad_()
        y = fn(p, xt)
        gr = torch.autograd.grad((y * y).sum(), [xt] + [p[n] for n in (
            "Wq", "Wk", "Wv", "Wo", "bq", "bk", "bv", "bo")])
        torch.cuda.synchronize()
        return y.detach(), gr
    n_pairs = len(_pairs(SP_SLOTS, True))
    ops.reset_launch_counts()
    y, gr = run(spa)
    spa_launches = _expect_launches("phase 20 (b) SequenceParallelAttention",
                                    {k_: n_pairs for k_ in MP_KERNELS})
    ops.reset_launch_counts()
    y_ref, gr_ref = run(lambda p, xt: layer.apply(p, xt))
    # the key bias's gradient is 0 in exact arithmetic (softmax ignores a
    # shift of a row's scores): held against the query bias's scale
    scales = [float(b.abs().max()) for b in gr_ref]
    scales[6] = scales[5]
    out["layer"] = {"launches": spa_launches,
                    "reference_launches": ops.launch_counts(),
                    "out_err": float((y - y_ref).abs().max())
                    / float(y_ref.abs().max()),
                    "grad_err": max(float((a - b).abs().max()) / sc
                                    for a, b, sc in zip(gr, gr_ref, scales))}
    print(f"mp: (b) SequenceParallelAttention over a TinyTransformer "
          f"attention layer (B={SP_LAYER_B}, T={SP_LAYER_T}, causal): output "
          f"{out['layer']['out_err']:.3g} and input / weight gradients "
          f"{out['layer']['grad_err']:.3g} of max against the layer's own "
          f"K5 / K6 + K7 path (bar {SP_TOL}); launches {spa_launches} "
          f"(the layer's {out['layer']['reference_launches']}) [{card}]",
          flush=True)
    bad = [kk for kk in ("causal", "plain")
           if max(out[kk]["vs_full_k5"], out[kk]["vs_plain"]) > SP_TOL]
    if got.dtype != torch.bfloat16 \
            or out["causal_bf16"]["vs_plain"] > SP_BF16_TOL:
        bad.append("causal_bf16")
    if bad or max(out["layer"]["out_err"], out["layer"]["grad_err"]) > SP_TOL:
        raise AssertionError(f"phase 20 (b): {out}")
    res["sp"] = out


def _block_stage(p, x):
    """One TinyTransformer block as a pipeline stage: ln1, causal
    attention (K5; K6 + K7 under autograd), residual, ln2, ff1 gelu, ff2,
    residual, over a stage's dict of tensors."""
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        scaled_dot_product_attention
    import torch
    B, T, D = x.shape

    def ln(h, g, b):
        mean = h.mean(-1, keepdim=True)
        var = h.var(-1, unbiased=False, keepdim=True)
        return (h - mean) * torch.rsqrt(var + 1e-5) * g + b
    h = ln(x, p["ln1_gamma"], p["ln1_beta"])
    q, k, v = ((h @ p[f"W{n}"] + p[f"b{n}"]).reshape(B, T, HEADS, -1)
               for n in "qkv")
    o = scaled_dot_product_attention(q, k, v, causal=True)
    x = x + o.reshape(B, T, D) @ p["Wo"] + p["bo"]
    h = ln(x, p["ln2_gamma"], p["ln2_beta"])
    f = torch.nn.functional.gelu(h @ p["ff1_W"] + p["ff1_b"],
                                 approximate="tanh")
    return x + f @ p["ff2_W"] + p["ff2_b"]


def _block_params(net, i):
    p = net.params
    return {"ln1_gamma": p[f"b{i}_ln1"]["gamma"],
            "ln1_beta": p[f"b{i}_ln1"]["beta"],
            **{n: p[f"b{i}_attn"][n] for n in ("Wq", "Wk", "Wv", "Wo", "bq",
                                                "bk", "bv", "bo")},
            "ln2_gamma": p[f"b{i}_ln2"]["gamma"],
            "ln2_beta": p[f"b{i}_ln2"]["beta"],
            "ff1_W": p[f"b{i}_ff1"]["W"], "ff1_b": p[f"b{i}_ff1"]["b"],
            "ff2_W": p[f"b{i}_ff2"]["W"], "ff2_b": p[f"b{i}_ff2"]["b"]}


def mp_pp_part(card, res, dev="cuda"):
    """(c) GPipe over four TinyTransformer blocks."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelineParallel, pipeline_forward, shard_stages, split_microbatches,
        stack_stage_params)
    from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    tiny = TinyTransformer(vocab_size=MP_V, n_layers=PP_STAGES).init(
        device=dev)
    stages = [{k: v.detach().clone() for k, v in
               _block_params(tiny, i).items()} for i in range(PP_STAGES)]
    mesh = default_mesh(PP_STAGES, "pipe", device=dev)
    g = torch.Generator().manual_seed(22)
    x = torch.randn(MP_B, MP_T, 128, generator=g).to(dev)
    tgt = torch.randn(MP_B, MP_T, 128, generator=g).to(dev)
    n = PP_STAGES * PP_MICRO
    out = {}
    stacked = stack_stage_params(stages)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = pipeline_forward(_block_stage, shard_stages(stacked, mesh),
                               split_microbatches(x, PP_MICRO), mesh)
        torch.cuda.synchronize()
        out["forward"] = {"launches": _expect_launches(
            "phase 20 (c) pipeline_forward", {"flash_attn_fwd": n})}
        want = x
        for p in stages:
            want = _block_stage(p, want)
    out["forward"]["rel_err"] = float(
        (got.reshape(MP_B, MP_T, 128) - want).abs().max()) / float(
        want.abs().max())

    def loss_fn(y, t):
        return ((y - t) ** 2).mean()
    pp = PipelineParallel(_block_stage, loss_fn, stages, mesh,
                          learning_rate=PP_LR, num_microbatches=PP_MICRO)
    seq = {k: v.detach().clone() for k, v in stacked.items()}
    step_launches, pp_ms, seq_ms, losses = {}, [], [], []
    for i in range(PP_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = pp.fit_batch(x, tgt)
        torch.cuda.synchronize()
        pp_ms.append((time.perf_counter() - t0) * 1e3)
        _add_counts(step_launches, _expect_launches(
            f"phase 20 (c) fit_batch {i}", {k: n for k in MP_KERNELS}))
        t0 = time.perf_counter()
        leaves = {k: v.detach().requires_grad_() for k, v in seq.items()}
        h = x
        for s in range(PP_STAGES):
            h = _block_stage({k: v[s] for k, v in leaves.items()}, h)
        ref_loss = loss_fn(h, tgt)
        grads = torch.autograd.grad(ref_loss, list(leaves.values()))
        with torch.no_grad():
            for p, gr in zip(seq.values(), grads):
                p.sub_(PP_LR * gr)
        torch.cuda.synchronize()
        seq_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append((float(loss), float(ref_loss.detach())))
    scale = max(float(v.abs().max()) for v in seq.values())
    out.update(fit={"launches": step_launches}, losses=losses,
               step_rel_err=max(float((pp.params[k] - seq[k]).abs().max())
                                for k in seq) / scale,
               ms_per_step=statistics.median(pp_ms[1:]),
               sequential_ms_per_step=statistics.median(seq_ms[1:]),
               ms_min=min(pp_ms[1:]), sequential_ms_min=min(seq_ms[1:]))
    print(f"mp: (c) GPipe, {PP_STAGES} TinyTransformer blocks (d_model 128, "
          f"{HEADS} heads, FFN 512) over a ('pipe',) mesh of {PP_STAGES} "
          f"slots, B={MP_B} as {PP_MICRO} microbatches, T={MP_T}: forward "
          f"against the sequential blocks {out['forward']['rel_err']:.3g} "
          f"of max |y| (bar {PP_FWD_TOL}); "
          f"{PP_STEPS} fit_batch steps against sequential SGD "
          f"{out['step_rel_err']:.3g} of max |param| (bar {PP_STEP_TOL}); "
          f"launches a forward {out['forward']['launches']}, a step "
          f"{n} each of K5-K7; ms a step median {out['ms_per_step']:.3f} / "
          f"min {out['ms_min']:.3f} (sequential "
          f"{out['sequential_ms_per_step']:.3f} / "
          f"{out['sequential_ms_min']:.3f}) [{card}]", flush=True)
    if not (out["forward"]["rel_err"] <= PP_FWD_TOL
            and out["step_rel_err"] <= PP_STEP_TOL):
        raise AssertionError(f"phase 20 (c): {out}")
    res["pp"] = out


def mp_ep_part(card, res, dev="cuda"):
    """(d) The mixture of experts over an ("expert",) mesh of 8 slots."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.parallel.expert_parallel import (
        init_moe_params, moe_ffw, moe_ffw_dense_reference, shard_moe_params)
    from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh
    params = init_moe_params(20, EP_D, EP_H, EP_E, device=dev)
    mesh = default_mesh(EP_E, "expert", device=dev)
    sharded = shard_moe_params(params, mesh)
    x = torch.randn(EP_TOKENS, EP_D,
                    generator=torch.Generator().manual_seed(23)).to(dev)
    cpu = {k: v.cpu() for k, v in params.items()}
    out = {}
    ops.reset_launch_counts()
    for name, cf in (("default", 1.25), ("ample", float(EP_E))):
        y, aux = moe_ffw(sharded, x, capacity_factor=cf)
        y1, aux1 = moe_ffw(params, x, capacity_factor=cf)
        torch.cuda.synchronize()
        drop = int((y == 0).all(-1).sum())
        r = {"vs_unsharded": float((y - y1).abs().max()),
             "aux": float(aux), "aux_err": abs(float(aux) - float(aux1)),
             "dropped": drop,
             "capacity": max(1, int(cf * EP_TOKENS / EP_E))}
        if name == "default":
            yc, auxc = moe_ffw(cpu, x.cpu(), capacity_factor=cf)
            r.update(vs_cpu=float((y.cpu() - yc).abs().max()),
                     cpu_aux_err=abs(float(aux) - float(auxc)),
                     cpu_dropped=int((yc == 0).all(-1).sum()))
        else:
            r["vs_dense_reference"] = float(
                (y - moe_ffw_dense_reference(params, x)).abs().max())
        out[name] = r
    out["launches"] = _expect_launches("phase 20 (d) moe_ffw", {})
    d, a = out["default"], out["ample"]
    losses = []
    for _ in range(EP_STEPS):
        leaves = {k: ([t.detach().requires_grad_() for t in v]
                      if isinstance(v, list) else v.detach().requires_grad_())
                  for k, v in sharded.items()}
        y, aux = moe_ffw(leaves, x, capacity_factor=1.25)
        loss = (y ** 2).mean() + EP_AUX * aux
        flat = [t for v in leaves.values()
                for t in (v if isinstance(v, list) else [v])]
        grads = iter(torch.autograd.grad(loss, flat))
        with torch.no_grad():
            for k, v in sharded.items():
                for t in (v if isinstance(v, list) else [v]):
                    t.sub_(EP_LR * next(grads))
        losses.append(float(loss.detach()))
    out["sgd_losses"] = losses
    print(f"mp: (d) moe_ffw (d_model {EP_D}, d_hidden {EP_H}, {EP_E} experts "
          f"over an ('expert',) mesh of {EP_E} slots, {EP_TOKENS} tokens): "
          f"capacity 1.25 (C={d['capacity']}) against unsharded "
          f"{d['vs_unsharded']:.3g}, the CPU port {d['vs_cpu']:.3g} (bar "
          f"{EP_TOL}), dropped {d['dropped']} (CPU {d['cpu_dropped']}), aux "
          f"{d['aux']:.5f}; ample (C={a['capacity']}) against the dense "
          f"reference {a['vs_dense_reference']:.3g}, dropped {a['dropped']};"
          f" {EP_STEPS} SGD steps on loss + {EP_AUX} aux {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; no hand kernel [{card}]", flush=True)
    if not (max(d["vs_unsharded"], d["vs_cpu"], a["vs_unsharded"],
                a["vs_dense_reference"]) <= EP_TOL
            and d["dropped"] == d["cpu_dropped"] and a["dropped"] == 0
            and max(d["aux_err"], d["cpu_aux_err"]) <= EP_TOL
            and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 20 (d): {out}")
    res["ep"] = out


MP_OUT_TOL = 1e-5                # (e): /predict against the unsplit forward
MP_GEN_NEW = 32                  # (e): tokens a /generate stream


def mp_default_mesh_part(card, res, dev="cuda"):
    """(e) TP through the default mesh: the container's own fit and
    fit_scan, a warmed /predict, dense and paged /generate."""
    import torch
    from deeplearning4j_tpu_torch import ComputationGraph, ops
    from deeplearning4j_tpu_torch.exec import (Executor, build_mesh,
                                               set_default_mesh)
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.serving import (DecodeEngine,
                                                  InferenceClient,
                                                  InferenceEngine,
                                                  InferenceServer)
    from deeplearning4j_tpu_torch.zoo import TinyTransformer
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_ids
    zoo = TinyTransformer(vocab_size=MP_V, updater=Sgd(MP_LR))
    data = _mp_tokens(MP_STEPS, 0, MP_V)
    mesh = build_mesh([dev] * (MP_DATA * MP_MODEL), model_parallel=MP_MODEL)
    per_step = {k: 2 * MP_MODEL for k in MP_KERNELS}
    out = {}

    def one_slot(net):
        net._exec = Executor(build_mesh([dev]))
        return net

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()
    set_default_mesh(mesh)
    try:
        net = zoo.init(device=dev)
        if net._executor.model_size != MP_MODEL:
            raise AssertionError("phase 20 (e): the default mesh's model "
                                 "axis did not reach the container")
        ref = one_slot(zoo.init(device=dev))
        cpu = ComputationGraph(net.conf, device="cpu")
        cpu._exec = Executor(build_mesh(["cpu"]))
        cpu.set_params(net.params)
        ms, ref_ms, launches = [], [], {}
        for i, ds in enumerate(data):
            ops.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            net.fit(ds)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            _add_counts(launches, _expect_launches(
                f"phase 20 (e) fit step {i}", per_step))
        out["fit"] = {"launches": launches, "ms": ms,
                      "routes": net.tp_routes}
        for ds in data:
            sync()
            t0 = time.perf_counter()
            ref.fit(ds)
            sync()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            cpu.fit(ds)
        scan = zoo.init(device=dev)
        scan._exec = Executor(mesh, min_rows_per_shard=2)
        ops.reset_launch_counts()
        scan.fit_scan(np.stack([d.features for d in data]),
                      np.stack([d.labels for d in data]))
        sync()
        out["fit_scan"] = {"launches": _expect_launches(
            "phase 20 (e) fit_scan",
            {k: MP_STEPS * v for k, v in per_step.items()}),
            "routes": scan.tp_routes}
        if out["fit"]["routes"] != {"whole": MP_STEPS} or \
                out["fit_scan"]["routes"] != {"data": MP_STEPS}:
            raise AssertionError(f"phase 20 (e): shard routes {out}")
        err, pa, pb = _param_errs(net, ref)
        scan_err, ps, _ = _param_errs(scan, ref)
        cpu_err, _, pc = _param_errs(net, cpu)
        scale = max(float(v.abs().max()) for v in pc.values())
        out.update(
            max_param_diff=err, fit_scan_max_param_diff=scan_err,
            allclose=_allclose(pa, pb, MP_RTOL, MP_ATOL),
            fit_scan_allclose=_allclose(ps, pb, MP_RTOL, MP_ATOL),
            cpu_rel_err=cpu_err / scale,
            ms_per_step=statistics.median(ms[2:]), ms_min=min(ms[2:]),
            single_ms_per_step=statistics.median(ref_ms[2:]),
            single_ms_min=min(ref_ms[2:]), single_ms=ref_ms)
        print(f"mp: (e) TP through the default mesh (data {MP_DATA}, model "
              f"{MP_MODEL}), TinyTransformer (d_model 128, 4 heads, 2 "
              f"blocks, vocab {MP_V}, B={MP_B}, T={MP_T}, Sgd({MP_LR})): "
              f"{MP_STEPS} captured fit steps (routes {net.tp_routes}) "
              f"against one slot max diff {err:.3g} (allclose rtol "
              f"{MP_RTOL} atol {MP_ATOL}: {out['allclose']}), fit_scan "
              f"(routes {scan.tp_routes}) {scan_err:.3g} "
              f"({out['fit_scan_allclose']}), against the CPU port "
              f"{out['cpu_rel_err']:.3g} of max |param| (bar {MP_CPU_TOL}); "
              f"launches a step {per_step}; host ms a step median "
              f"{out['ms_per_step']:.3f} / min {out['ms_min']:.3f} (one slot "
              f"{out['single_ms_per_step']:.3f} / "
              f"{out['single_ms_min']:.3f}) [{card}]", flush=True)
        if not (out["allclose"] and out["fit_scan_allclose"]
                and out["cpu_rel_err"] <= MP_CPU_TOL):
            raise AssertionError(f"phase 20 (e): {out}")

        # /predict: the engine's shard set, warmed (captured) rungs 1..16
        eng = InferenceEngine(net, max_batch=16)
        eng.warmup((MP_T, MP_V))
        ids, _ = corpus_ids()
        ids = np.asarray([int(t) for t in ids])
        eye = np.eye(MP_V, dtype=np.float32)
        windows = np.stack([eye[ids[i * 97:i * 97 + MP_T]]
                            for i in range(8)])
        dense = DecodeEngine(net, slots=8, max_len=512)
        paged = DecodeEngine(net, slots=8, max_len=512, kv="paged",
                             kv_block_size=KV_BLOCK)
        srv = InferenceServer(net, port=0, engine=eng,
                              decode_engine=dense).start()
        psrv = InferenceServer(net, port=0, engine=eng,
                               decode_engine=paged).start()
        try:
            cli = InferenceClient(f"http://127.0.0.1:{srv.port}")
            c0 = eng.stats()["device_calls"]
            ops.reset_launch_counts()
            got = cli.predict(windows)
            calls = eng.stats()["device_calls"] - c0
            out["predict"] = {
                "launches": _expect_launches(
                    "phase 20 (e) /predict",
                    {"flash_attn_fwd": 2 * MP_MODEL * calls}),
                "device_calls": calls, "captures": eng.captures}
            want = net.output(windows, bucketed=False).cpu().numpy()
            out["predict"]["max_abs_err"] = float(np.abs(got - want).max())
            print(f"mp: (e) /predict of 8 windows over the engine's shard "
                  f"set ({eng.captures} captured rungs): {calls} forward(s), "
                  f"launches {out['predict']['launches']}, max abs err vs "
                  f"the unsplit forward "
                  f"{out['predict']['max_abs_err']:.3g} (bar {MP_OUT_TOL}) "
                  f"[{card}]", flush=True)
            if not np.isfinite(got).all() or \
                    out["predict"]["max_abs_err"] > MP_OUT_TOL:
                raise AssertionError(f"phase 20 (e) /predict: {out}")
            lens = [16, 22, 28, 34, 40, 46, 52, 64]
            prompts = [list(map(int, ids[i * 211:i * 211 + n]))
                       for i, n in enumerate(lens)]
            for kind, server, engine, kernel in (
                    ("dense", srv, dense, "flash_decode"),
                    ("paged", psrv, paged, "flash_decode_paged")):
                pc = InferenceClient(f"http://127.0.0.1:{server.port}")
                s0 = engine.stats()["steps"]
                ops.reset_launch_counts()
                with ThreadPoolExecutor(len(prompts)) as pool:
                    gens = list(pool.map(
                        lambda p: pc.generate(p, MP_GEN_NEW)["tokens"],
                        prompts))
                steps = engine.stats()["steps"] - s0
                out[kind] = {"launches": _expect_launches(
                    f"phase 20 (e) {kind} /generate",
                    {kernel: 2 * MP_MODEL * steps}), "steps": steps,
                    "programs": engine.trace_count}
                un = one_slot(ComputationGraph(net.conf, device=dev))
                un.set_params({n: {k: v.clone() for k, v in p.items()}
                               for n, p in net.params.items()})
                ueng = DecodeEngine(un, slots=8, max_len=512, kv=kind,
                                    kv_block_size=KV_BLOCK).start()
                try:
                    futs = [ueng.submit(p, MP_GEN_NEW) for p in prompts]
                    wants = [f.result(timeout=300)["tokens"] for f in futs]
                finally:
                    ueng.stop()
                ties = [_first_tie(un, p, g, w)
                        for p, g, w in zip(prompts, gens, wants)]
                worst = max((t[1] for t in ties if t is not None),
                            default=None)
                out[kind].update(identical=sum(t is None for t in ties),
                                 worst_tie_margin=worst)
                print(f"mp: (e) {kind} /generate, 8 streams of "
                      f"{MP_GEN_NEW} tokens over head-split caches: "
                      f"{steps} steps, launches {out[kind]['launches']}, "
                      f"{out[kind]['identical']} of 8 streams equal to the "
                      f"one-slot engine's (worst tie margin {worst}, bar "
                      f"{TIE_MARGIN}) [{card}]", flush=True)
                if worst is not None and worst > TIE_MARGIN:
                    raise AssertionError(f"phase 20 (e) {kind}: {out}")
        finally:
            psrv.stop()
            srv.stop()
    finally:
        set_default_mesh(None)
    res["default_mesh"] = out


MPF_SLOTS, MPF_MAXLEN, MPF_NEW = 8, 256, 24   # (f): the decode engines
MPF_TIER_BLOCKS = 13           # (f): 12 blocks of 16 under 4 x 4 chains
MPF_FIT_STEPS = 6              # (f): steps of each TP fit variant
MPF_TBPTT_BATCHES = 3          # (f): tBPTT batches of 4 chunks (B=32, T=64)
MPF_REC_RTOL, MPF_REC_ATOL = 1e-4, 1e-6   # (f): the recorder's rows
# (f): a bf16-policy step against one slot's from the same float32
# masters, in norm relative to the step's change: the whole set within
# one bfloat16 unit, each leaf within four (plus MP_ATOL)
MPF_BF16_STEP_RTOL, MPF_BF16_LEAF_RTOL = 2.0 ** -8, 2.0 ** -6
MPF_BF16_STEPS = 3             # (f): bf16-policy steps, each from one slot's
MPF_TBPTT_CHUNK = {"lstm_fwd_train": 2, "lstm_bwd": 2}  # (f): 2 layers


def _mpf_streams(eng, prompts, new=MPF_NEW, together=True):
    """Greedy streams of ``prompts`` (submitted together, or one at a
    time) with the engine's stats before and after, the launches reset
    in between: (tokens, st0, st1, launches)."""
    from deeplearning4j_tpu_torch import ops
    st0 = eng.stats()
    ops.reset_launch_counts()
    if together:
        futs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        toks = [f.result(timeout=600)["tokens"] for f in futs]
    else:
        toks = [eng.generate(p, new)["tokens"] for p in prompts]
    got = dict(ops.launch_counts())
    return toks, st0, eng.stats(), got


def _mpf_decode_want(st0, st1, paged, draft_layers=0, shards=MP_MODEL):
    """The decode kernels' launches between two stats of an engine over
    ``shards`` model shards: 2 layers x the shards a plain step (K9 on a
    paged engine) and a verify (K8), the shards a draft step and draft
    attention layer (K8)."""
    spec0, spec1 = st0.get("spec"), st1.get("spec")
    verifies = spec1["verifies"] - spec0["verifies"] if spec1 else 0
    plain = st1["steps"] - st0["steps"] - verifies
    want = {}
    if plain:
        want["flash_decode_paged" if paged else "flash_decode"] = \
            2 * shards * plain
    if spec1:
        drafted = spec1["draft_steps"] - spec0["draft_steps"]
        want["flash_decode"] = want.get("flash_decode", 0) \
            + 2 * shards * verifies + shards * draft_layers * drafted
    return want


def _mpf_ties(net, prompts, gots, wants):
    """(streams equal, worst near-tie margin or None) of two token sets."""
    ties = [_first_tie(net, p, g, w) for p, g, w in zip(prompts, gots, wants)]
    return (sum(t is None for t in ties),
            max((t[1] for t in ties if t is not None), default=None))


def mp_features_part(card, res, dev="cuda"):
    """(f) What a model axis used to refuse, on the default mesh's model
    axis: speculation, the host KV tier, KV migration and int8 / fp8
    serving over head shards, the TP fit with the flight recorder, the
    bf16 policy, weight noise and a row-split maxnorm, and the LSTM
    recipe's TP tBPTT (``chip_smoke.py`` docstring)."""
    import torch
    from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork,
                                          monitor, ops)
    from deeplearning4j_tpu_torch.exec import (Executor, build_mesh,
                                               set_default_mesh)
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.nn.weightnoise import DropConnect
    from deeplearning4j_tpu_torch.serving import (DecodeEngine,
                                                  InferenceEngine)
    from deeplearning4j_tpu_torch.serving.spec import SpecConfig
    from deeplearning4j_tpu_torch.zoo import (TextGenerationLSTM,
                                              TinyTransformer)
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_ids
    mesh = build_mesh([dev] * (MP_DATA * MP_MODEL), model_parallel=MP_MODEL)
    zoo = TinyTransformer(vocab_size=MP_V, updater=Sgd(MP_LR))
    ids, _ = corpus_ids()
    ids = [int(t) for t in ids]
    lens = [16, 20, 24, 28, 32, 36, 40, 48]
    prompts = [ids[i * 173:i * 173 + n] for i, n in enumerate(lens)]
    eye = np.eye(MP_V, dtype=np.float32)
    windows = np.stack([eye[ids[i * 97:i * 97 + MP_T]] for i in range(8)])
    out = {}
    t_part = {}

    def one_slot(net):
        net._exec = Executor(build_mesh([dev]), train_precision=getattr(
            net._executor, "train_precision", None))
        return net

    def unsplit(net):
        u = ComputationGraph(net.conf, device=dev)
        u._exec = Executor(build_mesh([dev]))
        return u.set_params({n: {k: v.clone() for k, v in p.items()}
                             for n, p in net.params.items()})

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def check(tag, ok, row):
        out[tag] = row
        if not ok:
            raise AssertionError(f"phase 20 (f) {tag}: {row}")

    set_default_mesh(mesh)
    try:
        net = zoo.init(device=dev)
        if net._executor.model_size != MP_MODEL:
            raise AssertionError("phase 20 (f): the default mesh's model "
                                 "axis did not reach the container")
        un = unsplit(net)

        # --- speculation, dense and paged, against the TP plain engine;
        # the plain engines' host ms a step beside one slot's
        t0 = time.perf_counter()
        plain = DecodeEngine(net, slots=MPF_SLOTS, max_len=MPF_MAXLEN).start()
        uplain = DecodeEngine(un, slots=MPF_SLOTS, max_len=MPF_MAXLEN).start()
        try:
            want, p0, p1, got = _mpf_streams(plain, prompts)
            plain_launches = _expect_launches(
                "phase 20 (f) plain /generate", _mpf_decode_want(
                    p0, p1, False))
            uwant, u0, u1, _ = _mpf_streams(uplain, prompts)
        finally:
            plain.stop()
            uplain.stop()
        step_ms = (p1["decode_seconds"] - p0["decode_seconds"]) \
            / (p1["steps"] - p0["steps"]) * 1e3
        one_ms = (u1["decode_seconds"] - u0["decode_seconds"]) \
            / (u1["steps"] - u0["steps"]) * 1e3
        same, worst = _mpf_ties(un, prompts, want, uwant)
        check("plain", worst is None or worst <= TIE_MARGIN,
              {"launches": plain_launches, "identical": same,
               "worst_tie_margin": worst, "host_ms_a_step": step_ms,
               "one_slot_host_ms_a_step": one_ms})
        print(f"mp: (f) TP plain dense /generate, 8 streams of {MPF_NEW}: "
              f"host ms a step {step_ms:.3f} against one slot's "
              f"{one_ms:.3f} ({step_ms / one_ms:.2f}x), {same} of 8 streams "
              f"equal to one slot's (worst tie margin {worst}) [{card}]",
              flush=True)
        draft = TinyTransformer(vocab_size=MP_V, n_layers=1, seed=3).init(
            device=dev)
        for kind, what, spec, layers, kw in (
                ("spec_dense", "the target as draft, k=3",
                 SpecConfig(net, k=3), 2, {}),
                ("spec_paged", "a seed-3 one-block draft, tree (2, 2)",
                 SpecConfig(draft, tree=(2, 2)), 1,
                 dict(kv="paged", kv_block_size=KV_BLOCK))):
            eng = DecodeEngine(net, slots=MPF_SLOTS, max_len=MPF_MAXLEN,
                               spec=spec, **kw).start()
            try:
                got, s0, s1, _ = _mpf_streams(eng, prompts)
                launches = _expect_launches(
                    f"phase 20 (f) {kind} /generate", _mpf_decode_want(
                        s0, s1, bool(kw), layers))
            finally:
                eng.stop()
            same, worst = _mpf_ties(net, prompts, got, want)
            rate = s1["spec"]["acceptance_rate"]
            check(kind, (worst is None or worst <= TIE_MARGIN) and rate > 0,
                  {"launches": launches, "identical": same,
                   "worst_tie_margin": worst, "acceptance_rate": rate,
                   "verifies": s1["spec"]["verifies"]
                   - s0["spec"]["verifies"]})
            print(f"mp: (f) {kind} /generate over head shards ({what}): "
                  f"launches {launches}, acceptance {rate:.3f}, {same} of 8 "
                  f"streams equal to the TP plain engine's (worst tie "
                  f"margin {worst}, bar {TIE_MARGIN}) [{card}]", flush=True)
        t_part["spec"] = time.perf_counter() - t0

        # --- the host tier: evictions and restores over head-split pools
        t0 = time.perf_counter()
        tier_prompts = [ids[5000 + 211 * i:5000 + 211 * i + 64]
                        for i in range(4)] * 2
        kw = dict(slots=2, max_len=MPF_MAXLEN, kv="paged",
                  kv_block_size=KV_BLOCK, kv_blocks=MPF_TIER_BLOCKS)
        ref_eng = DecodeEngine(net, **kw).start()
        tier = DecodeEngine(net, host_kv_bytes=64 << 20, **kw).start()
        try:
            twant = _mpf_streams(ref_eng, tier_prompts, together=False)[0]
            tgot, t0s, t1s, _ = _mpf_streams(tier, tier_prompts,
                                             together=False)
            launches = _expect_launches("phase 20 (f) host tier",
                                        _mpf_decode_want(t0s, t1s, True))
            info = tier.kv_pool_info()
        finally:
            tier.stop()
            ref_eng.stop()
        spills = info["host_tier"]["spills"]
        restores = t1s["kv"]["host_restores"]
        check("host_tier", tgot == twant and spills > 0 and restores > 0,
              {"launches": launches, "spills": spills, "restores": restores,
               "equal": tgot == twant})
        print(f"mp: (f) TP paged engine with the host tier, 4 prompts of 64 "
              f"twice over {MPF_TIER_BLOCKS} blocks: {spills} spills, "
              f"{restores} restores, launches {launches} (none a spill or "
              f"restore), tokens equal to the tierless engine's: "
              f"{tgot == twant} [{card}]", flush=True)

        # --- migration both ways between a TP and an unsplit engine
        mig = {}
        pkw = dict(slots=2, max_len=MPF_MAXLEN, kv="paged",
                   kv_block_size=KV_BLOCK)
        for tag, src_net, dst_net, shards in (
                ("tp_to_unsplit", net, un, 1),
                ("unsplit_to_tp", un, net, MP_MODEL)):
            src = DecodeEngine(src_net, **pkw).start()
            dst = DecodeEngine(dst_net, **pkw).start()
            p = tier_prompts[0]
            try:
                first = src.generate(p, MPF_NEW)["tokens"]
                payload = src.kv_export(p)
                imported = dst.kv_import(payload)
                cont, c0, c1, got = _mpf_streams(dst, [p], together=False)
                launches = _expect_launches(
                    f"phase 20 (f) {tag} continued",
                    _mpf_decode_want(c0, c1, True, shards=shards))
            finally:
                src.stop()
                dst.stop()
            tie = _first_tie(net, p, cont[0], first)
            mig[tag] = {"launches": launches, "imported": imported,
                        "prefix_hits": c1["kv"]["prefix_hits"]
                        - c0["kv"]["prefix_hits"], "tie": tie}
            if (tie is not None and tie[1] > TIE_MARGIN) \
                    or mig[tag]["prefix_hits"] != 1:
                raise AssertionError(f"phase 20 (f) {tag}: {mig[tag]}")
        check("migration", True, mig)
        moved = {k: (v["imported"]["imported_blocks"], v["tie"])
                 for k, v in mig.items()}
        print(f"mp: (f) KV chains TP -> unsplit and unsplit -> TP: {moved} "
              f"(blocks, first difference or None) [{card}]", flush=True)
        t_part["tier_migration"] = time.perf_counter() - t0

        # --- int8 / fp8: /predict and /generate over quantized shard sets
        t0 = time.perf_counter()
        for prec, kv in (("int8", "dense"), ("fp8", "paged")):
            eng = InferenceEngine(net, max_batch=16, precision=prec)
            eng.warmup((MP_T, MP_V))
            ueng = InferenceEngine(un, max_batch=16, precision=prec)
            c0 = eng.stats()["device_calls"]
            ops.reset_launch_counts()
            got = eng.predict(windows)
            calls = eng.stats()["device_calls"] - c0
            plaunch = _expect_launches(f"phase 20 (f) {prec} /predict", {
                "flash_attn_fwd": 2 * MP_MODEL * calls})
            err = float((got.float().cpu() - ueng.predict(windows).float()
                         .cpu()).abs().max())
            dkw = {} if kv == "dense" else dict(kv="paged",
                                                kv_block_size=KV_BLOCK)
            deng = DecodeEngine(net, slots=MPF_SLOTS, max_len=MPF_MAXLEN,
                                precision=prec, **dkw).start()
            udeng = DecodeEngine(un, slots=MPF_SLOTS, max_len=MPF_MAXLEN,
                                 precision=prec, **dkw).start()
            try:
                toks, q0, q1, _ = _mpf_streams(deng, prompts)
                dlaunch = _expect_launches(
                    f"phase 20 (f) {prec} /generate",
                    _mpf_decode_want(q0, q1, kv == "paged"))
                utoks = _mpf_streams(udeng, prompts)[0]
            finally:
                deng.stop()
                udeng.stop()
            same, worst = _mpf_ties(un, prompts, toks, utoks)
            check(prec, err <= MP_OUT_TOL and (worst is None
                                               or worst <= TIE_MARGIN),
                  {"predict": {"launches": plaunch, "max_abs_err": err,
                               "device_calls": calls},
                   "generate": {"launches": dlaunch, "identical": same,
                                "worst_tie_margin": worst},
                   "weight_bytes": eng.stats().get("weight_bytes")})
            print(f"mp: (f) {prec} over the shard set: /predict of 8 "
                  f"windows {calls} forward(s), launches {plaunch}, max abs "
                  f"err vs one slot's {prec} engine {err:.3g} (bar "
                  f"{MP_OUT_TOL}); {kv} /generate launches {dlaunch}, "
                  f"{same} of 8 streams equal to one slot's (worst tie "
                  f"margin {worst}) [{card}]", flush=True)
        t_part["quantized"] = time.perf_counter() - t0

        # --- TP fit: the recorder, the bf16 policy, weight noise + maxnorm
        t0 = time.perf_counter()
        data = _mp_tokens(MPF_FIT_STEPS, 20, MP_V)
        per_step = {k: 2 * MP_MODEL for k in MP_KERNELS}
        fits = {}

        def fit_pair(tag, make, rec=False):
            tp_net, ref_net = make(), one_slot(make())
            recs = []
            if rec:
                recs = [monitor.FlightRecorder(sample_every=2)
                        for _ in range(2)]
                tp_net.attach_flight_recorder(recs[0])
                ref_net.attach_flight_recorder(recs[1])
            launches = {}
            for i, ds in enumerate(data):
                ops.reset_launch_counts()
                tp_net.fit(ds)
                sync()
                _add_counts(launches, _expect_launches(
                    f"phase 20 (f) {tag} step {i}", per_step))
            for ds in data:
                ref_net.fit(ds)
            sync()
            err, pa, pb = _param_errs(tp_net, ref_net)
            row = {"launches": launches, "max_param_diff": err,
                   "routes": tp_net.tp_routes,
                   "score": float(tp_net.get_score()),
                   "one_slot_score": float(ref_net.get_score())}
            return row, pa, pb, recs

        row, pa, pb, recs = fit_pair("recorder", lambda: zoo.init(device=dev),
                                     rec=True)
        got, want = recs[0].records(), recs[1].records()
        rows_ok = (len(got) == len(want) == MPF_FIT_STEPS // 2 and all(
            np.allclose(g["stats"], w["stats"], rtol=MPF_REC_RTOL,
                        atol=MPF_REC_ATOL) for g, w in zip(got, want)))
        row.update(records=len(got), rows_allclose=rows_ok,
                   allclose=_allclose(pa, pb, MP_RTOL, MP_ATOL))
        fits["recorder"] = row
        # the bf16 policy, each step from one slot's float32 masters (their
        # bfloat16 copies round apart at a boundary once float32's last
        # bits differ, and a further step would carry that on)
        tp_net, ref_net = zoo.init(device=dev), zoo.init(device=dev)
        tp_net._exec = Executor(mesh, train_precision="bf16")
        ref_net._exec = Executor(build_mesh([dev]), train_precision="bf16")
        launches, whole, leaf, leaves_ok = {}, [], [], True
        for i, ds in enumerate(data[:MPF_BF16_STEPS]):
            before = {k: v.clone() for k, v in _flat_params(ref_net).items()}
            ops.reset_launch_counts()
            tp_net.fit(ds)
            sync()
            _add_counts(launches, _expect_launches(
                f"phase 20 (f) bf16 policy step {i}", per_step))
            ref_net.fit(ds)
            sync()
            w, lf, ok_leaf = _step_agreement(tp_net, ref_net, before)
            whole.append(w)
            leaf.append(lf)
            leaves_ok = leaves_ok and ok_leaf
            tp_net.set_params({n: {k: v.clone() for k, v in p.items()}
                               for n, p in ref_net.params.items()})
        score, one_score = float(tp_net.get_score()), \
            float(ref_net.get_score())
        fits["bf16_policy"] = {
            "launches": launches, "step_err_over_change": whole,
            "largest_leaf_err_over_change": leaf, "leaves_ok": leaves_ok,
            "score": score, "one_slot_score": one_score,
            "routes": tp_net.tp_routes,
            "params_float32": all(v.dtype == torch.float32 for p in
                                  tp_net.params.values() for v in p.values()),
            "allclose": leaves_ok and max(whole) <= MPF_BF16_STEP_RTOL,
            "score_close": abs(score - one_score)
            <= MP_RTOL * abs(one_score) + MP_ATOL}
        conf = zoo.conf()
        for name in conf.layer_nodes():
            layer = conf.nodes[name].layer
            layer.weight_noise = DropConnect(weight_retain_prob=0.9)
            if name.endswith("_ff2"):           # W (512, 128): row split
                layer.constraints = ("maxnorm", 1.0)
        row, pa, pb, _ = fit_pair(
            "noise + maxnorm",
            lambda: ComputationGraph(conf, device=dev).set_params(
                {n: {k: v.clone() for k, v in p.items()}
                 for n, p in net.params.items()}))
        row.update(allclose=_allclose(pa, pb, MP_RTOL, MP_ATOL))
        fits["noise_maxnorm"] = row
        ok = (fits["recorder"]["rows_allclose"]
              and all(f["allclose"] for f in fits.values())
              and fits["bf16_policy"]["score_close"]
              and fits["bf16_policy"]["params_float32"])
        check("fit", ok, fits)
        print(f"mp: (f) TP fit, {MPF_FIT_STEPS} captured steps each against "
              f"one slot: recorder (K=2) {fits['recorder']['records']} "
              f"records, rows allclose (rtol {MPF_REC_RTOL}) "
              f"{fits['recorder']['rows_allclose']}, params "
              f"{fits['recorder']['max_param_diff']:.3g}; bf16 policy, "
              f"{MPF_BF16_STEPS} steps each from one slot's masters: "
              f"|error| / |change| "
              f"{[f'{w:.3g}' for w in fits['bf16_policy']['step_err_over_change']]}"
              f" (bar {MPF_BF16_STEP_RTOL:.4g}), largest leaf "
              f"{[f'{w:.3g}' for w in fits['bf16_policy']['largest_leaf_err_over_change']]}"
              f" (bar {MPF_BF16_LEAF_RTOL:.4g}), last score "
              f"{fits['bf16_policy']['score']:.5f} / "
              f"{fits['bf16_policy']['one_slot_score']:.5f}; DropConnect "
              f"0.9 + maxnorm(1.0) on the ff2 rows "
              f"{fits['noise_maxnorm']['max_param_diff']:.3g}; launches a "
              f"step {per_step} [{card}]", flush=True)
        t_part["fit"] = time.perf_counter() - t0

        # --- the LSTM recipe net's TP tBPTT against one slot
        t0 = time.perf_counter()
        lzoo = TextGenerationLSTM(total_unique_characters=MP_V,
                                  updater=Sgd(MP_LR))

        def tbptt_net():
            conf = lzoo.conf()
            conf.backprop_type = "tbptt"
            conf.tbptt_fwd_length = conf.tbptt_back_length = 16
            return MultiLayerNetwork(conf, device=dev).init()
        tnet, tref = tbptt_net(), one_slot(tbptt_net())
        batches = _mp_tokens(MPF_TBPTT_BATCHES, 40, MP_V)
        per_batch = {k: v * (MP_T // 16) for k, v in MPF_TBPTT_CHUNK.items()}
        counts = []
        for tag, n in (("one slot", tref), ("TP", tnet)):
            got = {}
            for i, ds in enumerate(batches):
                ops.reset_launch_counts()
                n.fit(ds)
                sync()
                _add_counts(got, _expect_launches(
                    f"phase 20 (f) tBPTT {tag} batch {i}", per_batch))
            counts.append(got)
        chunks = MPF_TBPTT_BATCHES * (MP_T // 16)
        per_chunk = {k: v // chunks for k, v in counts[0].items()}
        tp_launches = counts[1]
        err, pa, pb = _param_errs(tnet, tref)
        check("tbptt", _allclose(pa, pb, MP_RTOL, MP_ATOL) and tnet.tp_routes,
              {"launches": tp_launches, "one_slot_per_chunk": per_chunk,
               "chunks": chunks, "max_param_diff": err,
               "routes": tnet.tp_routes})
        print(f"mp: (f) TextGenerationLSTM (2 x LSTM(256), B={MP_B}, "
              f"T={MP_T}) TP tBPTT(16), {chunks} chunks: launches "
              f"{tp_launches} (one slot's a chunk {per_chunk}), params "
              f"against one slot {err:.3g} (rtol {MP_RTOL} atol {MP_ATOL}) "
              f"[{card}]", flush=True)
        t_part["tbptt"] = time.perf_counter() - t0
    finally:
        set_default_mesh(None)
    out["seconds"] = t_part
    res["features"] = out


def mp_phase(card, dev="cuda"):
    """Phase 20: model parallelism (``chip_smoke.py`` docstring)."""
    t0 = time.perf_counter()
    res = {"card": card}
    for part in (mp_tp_part, mp_sp_part, mp_pp_part, mp_ep_part,
                 mp_default_mesh_part, mp_features_part):
        t1 = time.perf_counter()
        part(card, res, dev)
        print(f"mp: {part.__name__} {time.perf_counter() - t1:.1f} s "
              f"[{card}]", flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"mp: phase 20 took {res['seconds']:.1f} s [{card}]", flush=True)
    return res


# ---- phase 21: training tools and the online loop -------------------------
TT_B, TT_T = 32, 64            # the recipe's batches (B, T)
ES_TRAIN_BATCHES = 4           # (a): training batches an epoch
ES_MAX_EPOCHS, ES_PATIENCE = 4, 2
TL_STEPS = 6                   # (b): steps of each fine-tune path
TL_LR = 0.05                   # (b): the fine-tune's Sgd rate
TL_TAIL_TOL = 1e-5             # (b): featurized vs unfeaturized, of max |p|
SOLVER_ITERS = 5               # (c): iterations of each solver on the card
SOLVER_TOL = 1e-4              # (c): first step's score, card vs CPU (rel.)
SOLVER_FIT_STEPS = 3           # (c): captured fit steps after a solver
ONLINE_ROUNDS = 3              # (d): clean rounds (one promotion each)
ONLINE_BATCHES = 4             # (d): batches a clean round
ONLINE_FORCED = 8              # (d): rolled-label batches of the forced round
ONLINE_MAX_BATCH = 32          # (d): the servers' ladder 1..32
ONLINE_REQ = 4                 # (d): windows a /predict of the client
TT_DIR = ROOT / "build" / "training_tools"


def _snap(net):
    return [{k: v.detach().clone() for k, v in p.items()} for p in net.params]


def _held_out():
    """The corpus's 15 held-out windows (T=64) as one DataSet."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    _, (xte, yte), _ = corpus_windows(stride=2)
    return DataSet(xte, yte)


def _stacked(batches):
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    return DataSet(np.concatenate([b.features for b in batches]),
                   np.concatenate([b.labels for b in batches]))


def tt_early_stopping_part(card, res, V, dev="cuda"):
    """(a) Early stopping against a hand loop on a twin net."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    zoo = TextGenerationLSTM(total_unique_characters=V)
    train = _dp_batches(ES_TRAIN_BATCHES, start=200)
    held = _held_out()
    n_held = held.num_examples()
    net, twin = zoo.init(device=dev), zoo.init(device=dev)
    cfg = EarlyStoppingConfiguration(
        score_calculator=DataSetLossCalculator(
            ListDataSetIterator(held, n_held)),
        epoch_termination_conditions=[
            MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
            ScoreImprovementEpochTerminationCondition(ES_PATIENCE)],
        model_saver=InMemoryModelSaver())
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    result = EarlyStoppingTrainer(
        cfg, net, ListDataSetIterator(_stacked(train), TT_B)).fit()
    E = result.total_epochs
    launches = _expect_launches("phase 21 (a) early stopping", {
        "lstm2_fwd_train": E * ES_TRAIN_BATCHES,
        "lstm_bwd": 2 * E * ES_TRAIN_BATCHES, "lstm2_fwd": E})
    seconds = time.perf_counter() - t0
    # the hand loop: the same steps and scores on a twin from the seed
    scores, snaps = {}, []
    for e in range(E):
        for ds in train:
            twin._fit_batch(ds)
            twin.get_score()
        # DataSetLossCalculator's arithmetic: sum of score x rows, / rows
        scores[e] = (0.0 + twin.score(held) * n_held) / n_held
        snaps.append(_snap(twin))
    best = result.best_model
    best_equal = _trees_equal(best.params, snaps[result.best_model_epoch])
    scores_equal = result.score_vs_epoch == scores
    out = {"launches": launches, "epochs": E, "seconds": seconds,
           "score_vs_epoch": result.score_vs_epoch,
           "hand_scores": scores, "best_epoch": result.best_model_epoch,
           "termination": result.termination_details,
           "scores_bitwise": scores_equal, "best_bitwise": best_equal}
    print(f"tools: (a) early stopping, TextGenerationLSTM (2 x LSTM(256), "
          f"B={TT_B}, T={TT_T}), MaxEpochs({ES_MAX_EPOCHS}) + "
          f"ScoreImprovement({ES_PATIENCE}) on the {n_held} held-out "
          f"windows: {E} epochs ({result.termination_details}), scores "
          f"{[round(s, 6) for s in result.score_vs_epoch.values()]} bit for "
          f"bit the hand loop's: {scores_equal}; best epoch "
          f"{result.best_model_epoch} read back bit for bit: {best_equal}; "
          f"launches {launches}; {seconds:.2f} s [{card}]", flush=True)
    if not (scores_equal and best_equal and best.device == net.device):
        raise AssertionError(f"phase 21 (a): {out}")
    res["early_stopping"] = out


def tt_transfer_part(card, res, V, dev="cuda"):
    """(b) Transfer learning: layer 0 frozen, fine-tuned and featurized."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.nn.layers.special import FrozenLayer
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.transferlearning import (
        FineTuneConfiguration, TransferLearning, TransferLearningHelper)
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    base = TextGenerationLSTM(total_unique_characters=V).init(device=dev)
    source = _snap(base)

    def build():
        return (TransferLearning.Builder(base)
                .fine_tune_configuration(FineTuneConfiguration(
                    updater=Sgd(TL_LR)))
                .set_feature_extractor(0).build())
    new, tail_net = build(), build()
    if not (isinstance(new.layers[0], FrozenLayer)
            and not isinstance(new.layers[1], FrozenLayer)):
        raise AssertionError("phase 21 (b): layer 0 is not frozen alone")
    frozen = _snap(new)[0]
    data = _dp_batches(TL_STEPS, start=300)
    out = {}
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for ds in data:
        new.fit(ds)
    out["fine_tune"] = {"launches": _expect_launches(
        "phase 21 (b) frozen fine-tune", {
            "lstm_fwd": TL_STEPS, "lstm_fwd_train": TL_STEPS,
            "lstm_bwd": TL_STEPS})}
    helper = TransferLearningHelper(tail_net)
    ops.reset_launch_counts()
    feats = [helper.featurize(ds) for ds in data]
    out["featurize"] = {"launches": _expect_launches(
        "phase 21 (b) featurize", {"lstm_fwd": TL_STEPS})}
    ops.reset_launch_counts()
    for f in feats:
        helper.fit_featurized(f)
    out["fit_featurized"] = {"launches": _expect_launches(
        "phase 21 (b) fit_featurized", {"lstm_fwd_train": TL_STEPS,
                                         "lstm_bwd": TL_STEPS})}
    out["seconds"] = time.perf_counter() - t0
    frozen_kept = (_trees_equal([new.params[0]], [frozen])
                   and _trees_equal([tail_net.params[0]], [frozen]))
    source_kept = _trees_equal(base.params, source)
    scale = max(float(v.abs().max()) for p in new.params[1:]
                for v in p.values())
    tail_err = _tree_diff(new.params[1:], tail_net.params[1:]) / scale
    tail_bitwise = _trees_equal(new.params[1:], tail_net.params[1:])
    out.update(frozen_bitwise=frozen_kept, source_bitwise=source_kept,
               tail_rel_err=tail_err, tail_bitwise=tail_bitwise)
    print(f"tools: (b) transfer learning, layer 0 frozen, Sgd({TL_LR}), "
          f"{TL_STEPS} steps each: fine-tune launches "
          f"{out['fine_tune']['launches']}, featurize "
          f"{out['featurize']['launches']}, fit_featurized "
          f"{out['fit_featurized']['launches']}; frozen parameters bit for "
          f"bit: {frozen_kept}; source net bit for bit: {source_kept}; "
          f"featurized against unfeaturized tail: {tail_err:.3g} of max "
          f"|p| (bar {TL_TAIL_TOL}; bit for bit {tail_bitwise}); "
          f"{out['seconds']:.2f} s [{card}]", flush=True)
    if not (frozen_kept and source_kept and tail_err <= TL_TAIL_TOL):
        raise AssertionError(f"phase 21 (b): {out}")
    res["transfer"] = out


def _recording_line_search():
    """A BackTrackLineSearch that records each search's step and counts
    its value-and-gradient probes."""
    from deeplearning4j_tpu_torch.optimize.solvers import BackTrackLineSearch

    class Recorded(BackTrackLineSearch):
        def __init__(self):
            super().__init__()
            self.steps, self.probes = [], 0

        def optimize(self, vg, x, f0, g0, direction):
            def counted(v):
                self.probes += 1
                return vg(v)
            got = super().optimize(counted, x, f0, g0, direction)
            self.steps.append(got[0])
            return got
    return Recorded()


def tt_solver_part(card, res, V, dev="cuda"):
    """(c) LBFGS, CG and line gradient descent, full batch, on the card."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.optimize import solvers
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    zoo = TextGenerationLSTM(total_unique_characters=V)
    (ds,) = _dp_batches(1, start=400)
    fit_data = _dp_batches(SOLVER_FIT_STEPS, start=401)
    out = {}
    for algo in ("lbfgs", "conjugate_gradient", "line_gradient_descent"):
        net, cpu = zoo.init(device=dev), zoo.init(device="cpu")
        ls, cpu_ls = _recording_line_search(), _recording_line_search()
        solver = solvers._ALGOS[algo](max_iterations=SOLVER_ITERS,
                                      line_search=ls)
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        converged = solver.optimize(net, ds)
        _sync(net.device)
        seconds = time.perf_counter() - t0
        probes = 1 + ls.probes
        launches = _expect_launches(f"phase 21 (c) {algo}", {
            "lstm2_fwd_train": probes, "lstm_bwd": 2 * probes})
        hist = solver.score_history
        cpu_solver = solvers._ALGOS[algo](max_iterations=1,
                                          line_search=cpu_ls)
        cpu_solver.optimize(cpu, ds)
        first = (ls.steps[0], hist[1] if len(hist) > 1 else hist[0])
        cpu_first = (cpu_ls.steps[0], cpu_solver.score_history[-1])
        score0_err = abs(hist[0] - cpu_solver.score_history[0]) / abs(
            cpu_solver.score_history[0])
        score1_err = abs(first[1] - cpu_first[1]) / abs(cpu_first[1])
        monotone = all(b <= a for a, b in zip(hist, hist[1:]))
        # a captured fit from the solver's parameters: the same steps as a
        # twin given those parameters
        twin = zoo.init(device=dev).set_params(_snap(net))
        c0 = net._capture_count
        ops.reset_launch_counts()
        for d in fit_data:
            net.fit(d)
            twin.fit(d)
        fit_launches = _expect_launches(f"phase 21 (c) {algo} fit", {
            "lstm2_fwd_train": 2 * SOLVER_FIT_STEPS,
            "lstm_bwd": 4 * SOLVER_FIT_STEPS})
        captured = net._capture_count - c0
        fit_equal = _trees_equal(net.params, twin.params)
        out[algo] = {"solve": {"launches": launches},
                     "fit": {"launches": fit_launches},
                     "converged": converged, "score_history": hist,
                     "steps": ls.steps, "probes": probes,
                     "cpu_first": cpu_first, "score0_rel_err": score0_err,
                     "score1_rel_err": score1_err, "monotone": monotone,
                     "fit_bitwise": fit_equal, "fit_captures": captured,
                     "seconds": seconds}
        print(f"tools: (c) {algo}, {SOLVER_ITERS} iterations full batch "
              f"(B={TT_B}, T={TT_T}): scores "
              f"{[round(s, 6) for s in hist]}, steps {ls.steps}, "
              f"{probes} probes, launches {launches}, {seconds:.2f} s; the "
              f"CPU copy's first step {cpu_first[0]} and score "
              f"{cpu_first[1]:.6f} (score rel err {score0_err:.3g} / "
              f"{score1_err:.3g}, bar {SOLVER_TOL}); then {SOLVER_FIT_STEPS} "
              f"fit steps ({captured} captured) bit for bit a twin's from "
              f"the solver's parameters: {fit_equal} [{card}]", flush=True)
        if not (monotone and ls.steps[0] == cpu_first[0]
                and score0_err <= SOLVER_TOL and score1_err <= SOLVER_TOL
                and fit_equal and len(hist) > 1
                and (captured >= 1 or dev == "cpu")):
            raise AssertionError(f"phase 21 (c) {algo}: {out[algo]}")
    res["solvers"] = out


def _post(url, x):
    """(status, model version, output) of one /predict."""
    status, body, hdrs = _http(url, "/predict", {"ndarray": _b64(x)})
    low = {k.lower(): v for k, v in hdrs.items()}
    if status != 200:
        return status, None, body
    from deeplearning4j_tpu_torch.serving.wire import ndarray_from_b64
    return status, int(low["x-model-version"]), ndarray_from_b64(
        body["ndarray"])


def tt_online_part(card, res, V, dev="cuda"):
    """(d) The online loop: serve, train from a topic, gate, promote under
    live /predict traffic, force a regression, roll back."""
    import shutil
    import threading
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data.kafka import (
        InMemoryBroker, NDArrayPublisher, NDArrayPubSubRoute)
    from deeplearning4j_tpu_torch.monitor.flight import FlightRecorder
    from deeplearning4j_tpu_torch.online import (
        BatchGuard, Deployer, HttpTarget, OnlineLearningService,
        OnlineTrainer, PromotionGate, ServerTarget, TrafficMirror)
    from deeplearning4j_tpu_torch.resilience.checkpoint import \
        CheckpointManager
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  InferenceServer)
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, StatsListener
    from deeplearning4j_tpu_torch.util.model_serializer import load_weights
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    zoo = TextGenerationLSTM(total_unique_characters=V)
    shutil.rmtree(TT_DIR, ignore_errors=True)
    held = _held_out()
    probe = held.features[:ONLINE_REQ]
    # two servers on the seed's weights: one swapped in process, one
    # through POST /admin/swap
    mirror = TrafficMirror()
    servers, engines = [], []
    for _ in range(2):
        net = zoo.init(device=dev)
        eng = InferenceEngine(net, max_batch=ONLINE_MAX_BATCH)
        srv = InferenceServer(net, port=0, engine=eng, max_latency_ms=1.0,
                              request_mirror=mirror.record).start()
        eng.warmup((TT_T, V), max_batch=ONLINE_MAX_BATCH)
        servers.append(srv)
        engines.append(eng)
    warm = [e.trace_count for e in engines]
    urls = [f"http://127.0.0.1:{s.port}" for s in servers]
    # the trainer's net from the topic through the route
    train_net, scratch = zoo.init(device=dev), zoo.init(device=dev)
    rec = FlightRecorder()
    train_net.attach_flight_recorder(rec)
    storage = InMemoryStatsStorage()
    train_net.add_listeners(StatsListener(storage, session_id="phase21"))
    broker = InMemoryBroker()
    pub = NDArrayPublisher(broker, "corpus")
    route = NDArrayPubSubRoute(broker, "corpus", batch_size=TT_B,
                               buffer_records=4 * TT_B).start()
    mgr = CheckpointManager(TT_DIR / "ck", keep_last=3)
    guard = BatchGuard(train_net)
    trainer = OnlineTrainer(train_net, route.iterator, mgr, guard=guard,
                            batches_per_round=ONLINE_BATCHES)
    gate = PromotionGate(held.features, held.labels, min_improvement=0.0,
                         max_shadow_disagreement=1.0)
    dep = Deployer(mgr, targets=[ServerTarget(servers[0]),
                                 HttpTarget(urls[1])])
    svc = OnlineLearningService(trainer, gate, dep, scratch, mirror=mirror)
    for s in servers:
        s.health_hook = svc.health_info

    stop, failures, seen = threading.Event(), [], {0: [], 1: []}

    def traffic():
        rng = np.random.default_rng(21)
        xs = held.features
        while not stop.is_set():
            for i, url in enumerate(urls):
                rows = rng.integers(0, len(xs), ONLINE_REQ)
                try:
                    status, v, _ = _post(url, xs[rows])
                except Exception as e:      # noqa: BLE001 -- a failed request
                    failures.append(repr(e))
                    continue
                if status != 200:
                    failures.append(status)
                else:
                    seen[i].append(v)
    th = threading.Thread(target=traffic, daemon=True)

    def publish(batches, roll=False):
        for ds in batches:
            y = np.roll(ds.labels, 1, axis=-1) if roll else ds.labels
            for j in range(ds.features.shape[0]):
                pub.publish(ds.features[j], y[j])
        pub.flush()

    calls0 = sum(e._calls for e in engines)
    it0 = train_net.iteration
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    k4, steps, start = 0, [], 500
    try:
        for r in range(ONLINE_ROUNDS + 1):
            forced = r == ONLINE_ROUNDS
            if r == 1:
                # the bootstrap round ran the trainer's step eagerly and
                # captured it with no other thread on the card (a capture,
                # and the eager warm-up's sync-debug mode, are process-wide);
                # from here on its steps replay while the client runs
                th.start()
                deadline = time.monotonic() + 60
                while not mirror.seen:
                    if time.monotonic() > deadline or failures:
                        raise AssertionError(
                            f"phase 21 (d): no /predict answered "
                            f"({failures[:3]})")
                    time.sleep(0.01)
            if forced:
                before = [e.predict_host(probe) for e in engines]
                incumbent_ck = dep.current["checkpoint"]
                v_good = dep.version
                gate.min_improvement = -1e9
                svc.regression_margin = 0.0
                trainer.guard = None
                trainer.batches_per_round = ONLINE_FORCED
            n = ONLINE_FORCED if forced else ONLINE_BATCHES
            publish(_dp_batches(n, start=start), roll=forced)
            start += n
            checks0 = guard._accepted + trainer.quarantined
            out = svc.step()
            steps.append(out)
            d = out["decision"]
            # K4 of the step: the guard's scores, the post-step score, the
            # gate's held-out evaluations (and the shadow replay of the
            # mirror, two forwards), the regression watch
            k4 += (guard._accepted + trainer.quarantined - checks0) + 1 + 1
            if d is not None and not np.isnan(d["incumbent_quality"]):
                k4 += 1 + (0 if np.isnan(d["shadow_disagreement"]) else 2)
            if out["promoted"]:
                k4 += 1
            time.sleep(0.2)         # let the client see this version
    finally:
        stop.set()
        if th.is_alive():
            th.join(timeout=60)
        route.stop()
    calls = sum(e._calls for e in engines) - calls0
    trained = train_net.iteration - it0
    launches = _expect_launches("phase 21 (d) online loop", {
        "lstm2_fwd_train": trained, "lstm_bwd": 2 * trained,
        "lstm2_fwd": k4 + calls})
    seconds = time.perf_counter() - t0
    promotions = sum(1 for s in steps if s["promoted"])
    forced_out = steps[-1]
    after = [e.predict_host(probe) for e in engines]
    # the pinned incumbent's own output: its zip swapped into a fresh engine
    ref = InferenceEngine(zoo.init(device=dev), max_batch=ONLINE_MAX_BATCH)
    ref.swap_weights(*load_weights(ref.model, incumbent_ck))
    pinned = ref.predict_host(probe)
    rollback_bitwise = all(np.array_equal(a, b) and np.array_equal(a, pinned)
                           for a, b in zip(after, before))
    http_after = [_post(u, probe) for u in urls]
    http_bitwise = all(s == 200 and np.array_equal(o, pinned)
                       for s, _, o in http_after)
    traces = [e.trace_count for e in engines]
    versions_rise = all(seen[i] == sorted(seen[i]) and seen[i]
                        and seen[i][-1] > seen[i][0] for i in seen)
    report = storage.get_latest_update("phase21")
    for s in servers:
        s.stop()
    out = {"launches": launches, "seconds": seconds,
           "promotions": promotions, "failures": len(failures),
           "requests": {i: len(v) for i, v in seen.items()},
           "versions": {i: sorted(set(v)) for i, v in seen.items()},
           "trace_counts": traces, "warm_trace_counts": warm,
           "mirror_seen": mirror.seen,
           "decisions": [s["decision"] for s in steps],
           "forced": {k: forced_out[k] for k in (
               "promoted", "rolled_back", "version", "live_quality")},
           "rollback_bitwise": rollback_bitwise,
           "http_rollback_bitwise": http_bitwise,
           "stats_report": report.to_json() if report else None,
           "flight_records": len(rec.records())}
    qual = [(round(s["decision"]["candidate_quality"], 4),
             round(s["decision"]["incumbent_quality"], 4))
            for s in steps if s["decision"]]
    print(f"tools: (d) online loop, TextGenerationLSTM served by 2 "
          f"InferenceServers (warmed 1..{ONLINE_MAX_BATCH}; ServerTarget and "
          f"HttpTarget), a second net trained from an InMemoryBroker topic "
          f"through NDArrayPubSubRoute: {len(steps)} rounds, {trained} "
          f"steps, {promotions} promotions, (candidate, incumbent) quality "
          f"{qual}; {sum(out['requests'].values())} /predict under way, "
          f"{len(failures)} failed, versions seen {out['versions']}, "
          f"trace_count {traces} (warm {warm}), mirrored {mirror.seen}; "
          f"forced regression: {out['forced']}, served after the rollback "
          f"bit for bit the pinned incumbent's: {rollback_bitwise} (HTTP "
          f"{http_bitwise}); launches {launches}; {seconds:.2f} s [{card}]",
          flush=True)
    if report is not None:
        j = report.to_json()
        print(f"tools: (d) StatsListener report: iteration {j['iteration']}, "
              f"score {j['score']:.6f}, "
              f"{j['iterationTimeMs']:.3f} ms/iteration, layers "
              f"{ {k: round(v['norm'], 4) for k, v in j['paramStats'].items()} } "
              f"(param norms from the flight recorder) [{card}]", flush=True)
    if not (promotions >= ONLINE_ROUNDS + 1 and not failures
            and versions_rise and traces == warm and mirror.seen > 0
            and forced_out["promoted"] and forced_out["rolled_back"]
            and forced_out["version"] == v_good + 2
            and rollback_bitwise and http_bitwise and report is not None):
        raise AssertionError(f"phase 21 (d): {out}")
    res["online"] = out


def tools_phase(card, dev="cuda"):
    """Phase 21: training tools and the online loop (``chip_smoke.py``
    docstring)."""
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    t0 = time.perf_counter()
    _, _, vocab = corpus_windows(stride=2)
    V = len(vocab)
    res = {"card": card}
    for part in (tt_early_stopping_part, tt_transfer_part, tt_solver_part,
                 tt_online_part):
        t1 = time.perf_counter()
        part(card, res, V, dev)
        res[f"{part.__name__}_seconds"] = time.perf_counter() - t1
        print(f"tools: {part.__name__} {time.perf_counter() - t1:.1f} s "
              f"[{card}]", flush=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"tools: phase 21 took {res['seconds']:.1f} s [{card}]", flush=True)
    return res


IMP_V, IMP_T, IMP_B, IMP_H = 77, 64, 32, 256   # (a): the zoo's char model
IMP_CLASSES = 5                # (b), (c): the classifier's outputs
IMP_STEPS = 3                  # (a): fit steps, card against the CPU copy
IMP_SEED = 2028
W2V_EPOCH_REPS = 600           # (d): corpus repeats of the timed NEG epoch
IMP_READER = "dict stand-in (KerasStandIn)"


class KerasStandIn(dict):
    """A dict-backed stand-in for an open Keras HDF5 file: the private
    importers read only ``attrs``, ``in``, ``[]`` and ``np.asarray(node)``,
    so a group is a dict with ``attrs`` and a dataset a numpy array."""

    def __init__(self, attrs=None, **items):
        super().__init__(**items)
        self.attrs = dict(attrs or {})


def keras_file(cfg, weights, training):
    """The stand-in for an open Keras 2 HDF5 file of this model: its
    configs in ``attrs``, a group per layer under ``model_weights``."""
    attrs = {"model_config": json.dumps(cfg),
             "training_config": json.dumps(training)}
    groups = {ln: KerasStandIn({"weight_names": [n for n, _ in ws]},
                               **dict(ws)) for ln, ws in weights.items()}
    return KerasStandIn(attrs, model_weights=KerasStandIn(**groups))


def keras_import(source, device):
    from deeplearning4j_tpu_torch.modelimport.keras_import import \
        _import_sequential
    return _import_sequential(source, device=device)


def keras_lstm_model(rng, rec, head, classes, rs2=True):
    """A Keras 2 Sequential over (None, IMP_T, IMP_V): two LSTM(IMP_H), the
    second with ``return_sequences=rs2``, then Dense(classes, softmax);
    categorical cross-entropy and Adam in its training config."""
    def lstm(name, rs, **extra):
        c = {"name": name, "units": IMP_H, "activation": "tanh",
             "recurrent_activation": rec, "use_bias": True,
             "return_sequences": rs}
        c.update(extra)
        return {"class_name": "LSTM", "config": c}

    def normal(*shape, scale=0.1):
        return rng.normal(size=shape, scale=scale).astype(np.float32)

    cfg = {"class_name": "Sequential", "keras_version": "2.2.4",
           "backend": "tensorflow", "config": {"layers": [
               lstm("l1", True, batch_input_shape=[None, IMP_T, IMP_V]),
               lstm("l2", rs2),
               {"class_name": "Dense", "config": {
                   "name": head, "units": classes, "activation": "softmax",
                   "use_bias": True}}]}}
    weights = {}
    for name, n_in in (("l1", IMP_V), ("l2", IMP_H)):
        weights[name] = [(f"{name}/kernel:0", normal(n_in, 4 * IMP_H)),
                         (f"{name}/recurrent_kernel:0",
                          normal(IMP_H, 4 * IMP_H)),
                         (f"{name}/bias:0", normal(4 * IMP_H))]
    weights[head] = [(f"{head}/kernel:0", normal(IMP_H, classes)),
                     (f"{head}/bias:0", normal(classes))]
    training = {"loss": "categorical_crossentropy", "optimizer_config": {
        "class_name": "Adam", "config": {"learning_rate": 1e-3}}}
    return cfg, weights, training


def _one_hot(rng, shape, classes):
    return np.eye(classes, dtype=np.float32)[rng.integers(0, classes, shape)]


def import_char_part(card, res, dev="cuda"):
    """(a) The zoo's char model imported at full width: K4 serving and
    K4-train + K3 training against the import's CPU copy."""
    import torch
    from deeplearning4j_tpu_torch import ops
    rng = np.random.default_rng(IMP_SEED)
    src = keras_file(*keras_lstm_model(rng, "sigmoid", "out", IMP_V))
    t0 = time.perf_counter()
    net, cpu = keras_import(src, dev), keras_import(src, "cpu")
    import_s = time.perf_counter() - t0
    same = _trees_equal(net.params, cpu.params)
    x = _one_hot(rng, (IMP_B, IMP_T), IMP_V)
    y = _one_hot(rng, (IMP_B, IMP_T), IMP_V)
    ops.reset_launch_counts()
    out = net.output(x)
    torch.cuda.synchronize()
    out_launches = _expect_launches("phase 22 (a) output", {"lstm2_fwd": 1})
    err = float((out.cpu() - cpu.output(x)).abs().max())
    losses, cpu_losses = [], []
    ops.reset_launch_counts()
    for _ in range(IMP_STEPS):
        net.fit(x, y)
        losses.append(net.get_score())
    torch.cuda.synchronize()
    fit_launches = _expect_launches("phase 22 (a) fit", {
        "lstm2_fwd_train": IMP_STEPS, "lstm_bwd": 2 * IMP_STEPS})
    for _ in range(IMP_STEPS):
        cpu.fit(x, y)
        cpu_losses.append(cpu.get_score())
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    param_err, _, pc = _param_errs(net, cpu)
    param_rel = param_err / max(float(v.abs().max()) for v in pc.values())
    out = {"reader": IMP_READER, "import_seconds": import_s,
           "params_equal_cpu_import": same, "max_abs_err": err,
           "losses": losses, "cpu_losses": cpu_losses,
           "loss_rel_err": loss_err, "param_rel_err": param_rel,
           "launches": {k: out_launches.get(k, 0) + fit_launches.get(k, 0)
                        for k in set(out_launches) | set(fit_launches)}}
    print(f"import: (a) Keras Sequential (None, {IMP_T}, {IMP_V}) -> 2 x "
          f"LSTM({IMP_H}, sigmoid gates) -> Dense({IMP_V}, softmax), Adam, "
          f"read through the {IMP_READER}: card and CPU imports' "
          f"parameters equal: {same}; output at B={IMP_B} vs the CPU copy "
          f"max abs err {err:.3g} (tol {PROB_TOL}), launches "
          f"{out_launches}; {IMP_STEPS} fit steps: losses "
          f"{[round(l, 6) for l in losses]} vs CPU max rel err "
          f"{loss_err:.3g} (tol {LOSS_RTOL}), parameters after them vs "
          f"CPU {param_rel:.3g} of max |param| (tol {MP_CPU_TOL}), "
          f"launches {fit_launches} [{card}]", flush=True)
    if not (same and err <= PROB_TOL and loss_err <= LOSS_RTOL
            and param_rel <= MP_CPU_TOL):
        raise AssertionError(f"phase 22 (a): {out}")
    res["char"] = out


def import_classifier_part(card, res, dev="cuda"):
    """(b) An LSTM -> LastTimeStep(LSTM) classifier (two K1 a call) and
    (c) the same with hard_sigmoid gates (the layers' own loop, nothing
    launched), each against its CPU copy."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.nn.layers import LastTimeStep
    for tag, rec, want in (("b", "sigmoid", {"lstm_fwd": 2}),
                           ("c", "hard_sigmoid", {})):
        rng = np.random.default_rng(IMP_SEED + ord(tag))
        src = keras_file(*keras_lstm_model(rng, rec, "cls", IMP_CLASSES,
                                           rs2=False))
        net, cpu = keras_import(src, dev), keras_import(src, "cpu")
        x = _one_hot(rng, (IMP_B, IMP_T), IMP_V)
        ops.reset_launch_counts()
        out = net.output(x)
        torch.cuda.synchronize()
        launches = _expect_launches(f"phase 22 ({tag}) output", want)
        err = float((out.cpu() - cpu.output(x)).abs().max())
        part = {"reader": IMP_READER, "max_abs_err": err,
                "launches": launches,
                "gate_activation": net.layers[0].gate_activation,
                "layers": [type(l).__name__ for l in net.layers]}
        print(f"import: ({tag}) LSTM({IMP_H}) -> LSTM({IMP_H}, "
              f"return_sequences=False) -> Dense({IMP_CLASSES}), {rec} "
              f"gates, layers {part['layers']}: output at B={IMP_B} vs the "
              f"CPU copy max abs err {err:.3g} (tol {PROB_TOL}); launches "
              f"{launches} [{card}]", flush=True)
        if not (err <= PROB_TOL and isinstance(net.layers[1], LastTimeStep)):
            raise AssertionError(f"phase 22 ({tag}): {part}")
        res["classifier" if tag == "b" else "screen"] = part


def _w2v_corpus(n_reps=60):
    """The JAX suite's clustered corpus (tests/test_nlp.py)."""
    a = ["the cat sat on the mat with another cat",
         "a cat and a kitten play with the mat",
         "the kitten chased the cat around the mat"]
    b = ["stocks rose as the market rallied today",
         "the market fell while stocks dropped today",
         "investors sold stocks as the market crashed"]
    return (a + b) * n_reps


def _two_cliques():
    from deeplearning4j_tpu_torch.graph import Graph
    g = Graph(12)
    for grp in (range(0, 6), range(6, 12)):
        for i in grp:
            for j in grp:
                if i < j:
                    g.add_edge(i, j)
    g.add_edge(5, 6)
    return g


def import_embeddings_part(card, res, dev="cuda"):
    """(d) Word2Vec NEG, DistributedWord2Vec over 4 slots and DeepWalk
    with their tables on the card: the JAX suite's checks, one NEG epoch's
    pairs/s, and no hand-kernel launch."""
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.graph import DeepWalk
    from deeplearning4j_tpu_torch.nlp import DistributedWord2Vec, Word2Vec
    from deeplearning4j_tpu_torch.parallel.wrapper import default_mesh
    ops.reset_launch_counts()
    w2v = Word2Vec(min_word_frequency=3, layer_size=32, window_size=3,
                   epochs=3, negative=5, seed=7, sentences=_w2v_corpus(),
                   subsampling=0, device=dev).fit()
    sims = {"cat~kitten": w2v.similarity("cat", "kitten"),
            "cat~stocks": w2v.similarity("cat", "stocks"),
            "market~stocks": w2v.similarity("market", "stocks"),
            "market~mat": w2v.similarity("market", "mat")}
    near = w2v.words_nearest("cat", 5)
    w2v_ok = (sims["cat~kitten"] > sims["cat~stocks"]
              and sims["market~stocks"] > sims["market~mat"]
              and any(w in near for w in ("kitten", "mat"))
              and w2v.syn0.device.type == torch.device(dev).type)
    mesh = default_mesh(4, device=dev)

    def distributed():
        return DistributedWord2Vec(
            mesh=mesh, averaging_frequency=4, min_word_frequency=3,
            layer_size=24, window_size=3, epochs=3, seed=7,
            sentences=_w2v_corpus(), subsampling=0, device=dev).fit()
    d1, d2 = distributed(), distributed()
    repeat = bool(torch.equal(d1.syn0, d2.syn0))
    d_ok = (d1.similarity("stocks", "market")
            > d1.similarity("stocks", "kitten")
            and d1.similarity("cat", "kitten") > d1.similarity("cat", "market"))
    dw = DeepWalk(vector_size=16, window_size=3, learning_rate=0.1, seed=7,
                  device=dev)
    dw.walks_per_vertex = 5
    dw.fit(_two_cliques(), walk_length=10, epochs=20)
    same = float(np.mean([dw.similarity(0, j) for j in range(1, 6)]))
    cross = float(np.mean([dw.similarity(0, j) for j in range(6, 12)]))
    # one NEG skip-gram epoch at 10x the corpus: a one-epoch fit (its
    # host pairs and staging included), timed after a warm one that
    # builds the vocabulary and tables
    big = Word2Vec(min_word_frequency=3, layer_size=100, window_size=5,
                   negative=5, seed=7, epochs=1, subsampling=0,
                   sentences=_w2v_corpus(W2V_EPOCH_REPS), device=dev).fit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big.fit()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    n_pairs = int(big._neg_pairs()[0].shape[-1])
    bs = big._effective_batch()
    launches = _expect_launches("phase 22 (d) embeddings", {})
    part = {"word2vec": {"similarities": sims, "nearest_cat": near,
                         "ok": w2v_ok},
            "distributed": {"slots": mesh.size, "repeat_bitwise": repeat,
                            "ok": d_ok},
            "deepwalk": {"same": same, "cross": cross},
            "neg_epoch": {"pairs": n_pairs, "batch": bs,
                          "steps": -(-n_pairs // bs), "seconds": epoch_s,
                          "pairs_per_s": n_pairs / epoch_s},
            "launches": launches}
    print(f"import: (d) Word2Vec skip-gram NEG on the card: {sims}, nearest "
          f"to cat {near}: {w2v_ok}; DistributedWord2Vec over {mesh.size} "
          f"slots clusters: {d_ok}, two runs bit for bit: {repeat}; "
          f"DeepWalk on two 6-cliques: same {same:.3f} > cross "
          f"{cross:.3f}; one NEG epoch (a Word2Vec.fit) of {n_pairs} pairs "
          f"(batch {bs}, {-(-n_pairs // bs)} steps, D=100, 5 shared "
          f"negatives) in "
          f"{epoch_s * 1e3:.1f} ms: {n_pairs / epoch_s:.4g} pairs/s; "
          f"hand-kernel launches {launches} [{card}]", flush=True)
    if not (w2v_ok and d_ok and repeat and same > cross):
        raise AssertionError(f"phase 22 (d): {part}")
    res["embeddings"] = part


def import_phase(card, dev="cuda"):
    """Phase 22: Keras model import and the embedding libraries
    (``chip_smoke.py`` docstring)."""
    t0 = time.perf_counter()
    res = {"card": card}
    for part in (import_char_part, import_classifier_part,
                 import_embeddings_part):
        t1 = time.perf_counter()
        part(card, res, dev)
        res[f"{part.__name__}_seconds"] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    print(f"import: phase 22 took {res['seconds']:.1f} s [{card}]",
          flush=True)
    return res


# ---- phase 23: ETL, the remote UI, the ML pipeline, clustering, t-SNE -----
UI_DIR = ROOT / "build" / "ui_phase"
ETL_N, ETL_TEST_N, ETL_SIDE, ETL_CLASSES = 60000, 10000, 28, 10
# pixel noise std around each blob's centre. k-means++ draws each next
# centre with probability ~ d^2 to the nearest chosen one: over 784 pixels
# a blob's own points carry d^2 ~ 2 * 784 * noise^2, so at noise 25 the
# nine covered blobs weigh as much as the last uncovered one and the
# start puts two centres in one blob about half the time (purity 0.9014
# at this seed on an H100 and on the CPU port alike); at 5 a covered
# blob weighs ~1/200 of an uncovered one
ETL_NOISE = 5.0
ETL_CSV_ROWS, ETL_CSV_COLS, ETL_CSV_CLASSES = 2000, 16, 3
ETL_SEED = 2029
ETL_TOL = 1e-6                 # native parse against numpy's, per value
UI_B, UI_T, UI_STRIDE, UI_EPOCHS = 32, 64, 8, 2
UI_CHUNK = 3                   # (b): fit_scan chunks; parity at the first
UI_PARITY_TOL = 1e-4           # (b): of max |param|, against the CPU port
LENET_B, LENET_STEPS, LENET_FREQ = 64, 20, 10
GREY_TOL = 1                   # (c): decoded activation grids, grey levels
CLF_H, CLF_SLOTS, CLF_EPOCHS = 256, 4, 2
AE_SIZES, AE_ROWS = (784, 256, 64), 12000
KM_K, KM_SUBSET, KM_PURITY, KM_TOL = 10, 6000, 0.99, 1e-4
KNN_K, KNN_QUERIES, KNN_CHECK = 10, 10000, 256
TSNE_N, TSNE_ITERS = 5000, 500
TSNE_CPU_N, TSNE_CPU_ITERS = 1000, 10
# (e): at the default rate and exaggeration a 1e-7 change of the start
# grows to 2e-4 of max |y| in 10 iterations at n=1000 (float rounding
# alone), so the card's steps are held against the CPU port's at a rate
# and an exaggeration under which the trajectory does not explode
TSNE_CPU_KW = dict(learning_rate=10.0, early_exaggeration=4.0)
TSNE_P_TOL, TSNE_Y_TOL = 1e-5, 1e-4
BH_N, BH_ITERS = 300, 50


def etl_arrays():
    """MNIST-shaped uint8 images from a seeded mixture of 10 blobs (a
    random centre a class, Gaussian pixel noise), their labels, and a
    small numeric CSV with a class column."""
    rng = np.random.default_rng(ETL_SEED)
    centres = rng.integers(0, 256, (ETL_CLASSES, ETL_SIDE * ETL_SIDE)
                           ).astype(np.float32)
    out = {}
    for stem, n in (("train", ETL_N), ("t10k", ETL_TEST_N)):
        lab = rng.integers(0, ETL_CLASSES, n).astype(np.uint8)
        noise = rng.standard_normal((n, ETL_SIDE * ETL_SIDE),
                                    dtype=np.float32) * ETL_NOISE
        img = np.clip(centres[lab] + noise, 0, 255).astype(np.uint8)
        out[stem] = (img.reshape(n, ETL_SIDE, ETL_SIDE), lab)
    csv = rng.standard_normal((ETL_CSV_ROWS, ETL_CSV_COLS)).astype(np.float32)
    out["csv"] = (csv, rng.integers(0, ETL_CSV_CLASSES, ETL_CSV_ROWS))
    return out


def write_etl_files(arrays, directory):
    import struct
    directory.mkdir(parents=True, exist_ok=True)
    for stem in ("train", "t10k"):
        img, lab = arrays[stem]
        n = len(lab)
        (directory / f"{stem}-images-idx3-ubyte").write_bytes(
            struct.pack(">IIII", 0x0803, n, ETL_SIDE, ETL_SIDE)
            + img.tobytes())
        (directory / f"{stem}-labels-idx1-ubyte").write_bytes(
            struct.pack(">II", 0x0801, n) + lab.tobytes())
    x, y = arrays["csv"]
    lines = [",".join(f"f{i}" for i in range(ETL_CSV_COLS)) + ",label"]
    lines += [",".join(f"{v:.6f}" for v in row) + f",{c}"
              for row, c in zip(x, y)]
    (directory / "table.csv").write_text("\n".join(lines) + "\n")


def ui_etl_part(card, res):
    """(a) Files into an object store, down into the fetcher cache, and
    through the native readers."""
    import shutil
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.data import fetchers
    from deeplearning4j_tpu_torch.data.native_loader import (
        load_csv_native, load_idx_native)
    from deeplearning4j_tpu_torch.scaleout.s3 import (LocalFileStore,
                                                      S3Downloader,
                                                      S3Uploader)
    t0 = time.perf_counter()
    arrays = etl_arrays()
    src = UI_DIR / "src"
    write_etl_files(arrays, src)
    make_s = time.perf_counter() - t0
    store = LocalFileStore(UI_DIR / "store")
    uploaded = S3Uploader(store).upload_dir(src, "datasets", prefix="mnist")
    old = os.environ.get("DL4JTPU_DATA_DIR")
    os.environ["DL4JTPU_DATA_DIR"] = str(UI_DIR / "cache")
    try:
        t1 = time.perf_counter()
        got = S3Downloader(store).download_dataset("datasets", "mnist",
                                                   "mnist")
        download_s = time.perf_counter() - t1
        cache = fetchers.data_dir() / "mnist"
        same_bytes = sorted(p.name for p in got) == sorted(
            p.name for p in src.iterdir()) and all(
            (cache / p.name).read_bytes() == p.read_bytes()
            for p in src.iterdir())
        t1 = time.perf_counter()
        avail = native.available()
        info = native.build_info()
        if not avail:
            raise AssertionError(f"phase 23 (a): the native library is "
                                 f"missing: {native.build_error()}")
        data = {}
        for stem in ("train", "t10k"):
            data[stem] = load_idx_native(
                str(cache / f"{stem}-images-idx3-ubyte"),
                str(cache / f"{stem}-labels-idx1-ubyte"), ETL_CLASSES)
        xc, yc = load_csv_native(str(cache / "table.csv"),
                                 label_col=ETL_CSV_COLS,
                                 n_classes=ETL_CSV_CLASSES, skip_lines=1)
        read_s = time.perf_counter() - t1
        # numpy's parse of the same bytes: the fetcher's IDX reader, the
        # CSV through float()
        errs = {}
        for stem in ("train", "t10k"):
            xr, yr = fetchers.load_mnist(train=stem == "train")
            x, y = data[stem]
            errs[stem] = float(np.abs(x - xr).max())
            if not np.array_equal(y, yr):        # both one-hot
                raise AssertionError(f"phase 23 (a): {stem} labels differ")
        real = fetchers.data_source("mnist")
        rows = [ln.split(",") for ln in
                (cache / "table.csv").read_text().splitlines()[1:]]
        xr = np.array([[float(v) for v in r[:-1]] for r in rows], np.float32)
        yr = np.array([int(r[-1]) for r in rows])
        errs["csv"] = float(np.abs(xc - xr).max())
        csv_labels = np.array_equal(
            yc, np.eye(ETL_CSV_CLASSES, dtype=np.float32)[yr])
    finally:
        if old is None:
            os.environ.pop("DL4JTPU_DATA_DIR", None)
        else:
            os.environ["DL4JTPU_DATA_DIR"] = old
    out = {"uploaded": uploaded, "downloaded": len(got),
           "same_bytes": same_bytes, "library": info["path"],
           "gxx_seconds": info["seconds"], "max_abs_err": errs,
           "mnist_source": real, "csv_labels_equal": csv_labels,
           "make_s": make_s, "download_s": download_s, "read_s": read_s}
    print(f"ui: (a) {ETL_N} + {ETL_TEST_N} MNIST-shaped IDX images (10 "
          f"seeded blobs) and a {ETL_CSV_ROWS} x {ETL_CSV_COLS} CSV: "
          f"{uploaded} objects into a LocalFileStore bucket, "
          f"{len(got)} down into the fetcher cache (bytes equal "
          f"{same_bytes}; load_mnist reads them: {real}); g++ built "
          f"{info['path']} in {info['seconds']:.2f} s; native parses vs "
          f"numpy's max abs err {errs} (tol {ETL_TOL}); files made in "
          f"{make_s:.2f} s, downloaded in {download_s:.2f} s, read in "
          f"{read_s:.2f} s [{card}]", flush=True)
    if not (same_bytes and csv_labels and real == "real"
            and max(errs.values()) <= ETL_TOL
            and uploaded == len(got) == 5):
        raise AssertionError(f"phase 23 (a): {out}")
    res["etl"] = out
    shutil.rmtree(UI_DIR / "store", ignore_errors=True)
    return data


class _Snapshot:
    """An iteration listener that keeps the parameters at one iteration
    (on the host)."""

    def __init__(self, at):
        self.at, self.params = at, None

    def iteration_done(self, model, iteration, epoch):
        if iteration == self.at:
            self.params = [{k: v.detach().cpu().clone() for k, v in p.items()}
                           for p in model.params]

    def on_epoch_end(self, model):
        pass


def _get_json(url, path):
    import urllib.request
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def _native_fit(net, x, y, seed, epochs=UI_EPOCHS):
    """``fit`` of ``net`` fed by a native iterator: (wall seconds, the
    iterator's batches, the steps)."""
    from deeplearning4j_tpu_torch.data.native_loader import \
        NativeAsyncDataSetIterator
    it = NativeAsyncDataSetIterator(x, y, UI_B, shuffle=True, seed=seed)
    i0 = net.iteration
    t0 = time.perf_counter()
    net.fit(it, epochs=epochs)
    _sync(net.device)
    wall = time.perf_counter() - t0
    it.close()
    return wall, it.batches, net.iteration - i0


def ui_train_part(card, res, url, reporter, dev="cuda"):
    """(b) The char model's native-fed fit under the remote UI."""
    import math
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.data.native_loader import \
        NativeAsyncDataSetIterator
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, StatsListener
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    (xtr, ytr), (xte, yte), vocab = corpus_windows(UI_T, stride=UI_STRIDE)
    zoo = TextGenerationLSTM(total_unique_characters=len(vocab))
    net = zoo.init(device=dev)
    net._CHUNK_MAX_STEPS = UI_CHUNK
    local = InMemoryStatsStorage()
    snap = _Snapshot(UI_CHUNK)
    net.set_listeners(StatsListener(reporter, session_id="char"),
                      StatsListener(local, session_id="char"), snap)
    steps_epoch = math.ceil(len(xtr) / UI_B)
    ops.reset_launch_counts()
    wall, batches, steps = _native_fit(net, xtr, ytr, zoo.seed)
    launches = _expect_launches("phase 23 (b) native-fed fit", {
        "lstm2_fwd_train": steps, "lstm_bwd": 2 * steps})
    if not (batches == steps == UI_EPOCHS * steps_epoch):
        raise AssertionError(f"phase 23 (b): {batches} batches from "
                             f"batcher_next, {steps} steps, want "
                             f"{UI_EPOCHS * steps_epoch}")
    # the CPU port fed by its own native iterator, the same seed
    cpu = zoo.init(device="cpu")
    cit = NativeAsyncDataSetIterator(xtr, ytr, UI_B, shuffle=True,
                                     seed=zoo.seed)
    for _, ds in zip(range(UI_CHUNK), iter(cit)):
        cpu._fit_batch(ds)
    cit.close()
    scale = max(float(v.abs().max()) for p in cpu.params for v in p.values())
    parity = max(float((snap.params[i][k] - v).abs().max())
                 for i, p in enumerate(cpu.params)
                 for k, v in p.items()) / scale
    if not reporter.flush(timeout=60):
        raise AssertionError("phase 23 (b): the reporter did not settle")
    ov = _get_json(url, "/train/overview?sid=char")
    ups = local.get_all_updates("char")
    overview_equal = (ov["iterations"] == [r.iteration for r in ups]
                      and ov["scores"] == [r.score for r in ups])
    system = _get_json(url, "/train/system/data?sid=char")
    names_card = system.get("device") == (
        torch.cuda.get_device_name(0) if dev == "cuda" else "cpu") \
        and system.get("backend") == dev
    # the held-out windows through one K4
    ops.reset_launch_counts()
    out = net.output(xte)
    _sync(dev)
    out_launches = _expect_launches("phase 23 (b) held-out output",
                                    {"lstm2_fwd": 1})
    out_err = float((out.cpu() - _cpu_copy(net).output(xte)).abs().max())
    # ms a step: the native-fed fit beside the same fit fed by
    # ListDataSetIterator, fresh nets, no listeners; the first epoch
    # captures each chunk's program, the second is timed warm
    timing = {}
    for tag in ("native", "list"):
        fresh = zoo.init(device=dev)
        if tag == "native":
            it = NativeAsyncDataSetIterator(xtr, ytr, UI_B, shuffle=True,
                                            seed=zoo.seed)
        else:
            it = ListDataSetIterator(DataSet(xtr, ytr), UI_B, shuffle=True,
                                     seed=zoo.seed)
        ops.reset_launch_counts()
        fresh.fit(it, epochs=1)
        t0 = time.perf_counter()
        fresh.fit(it, epochs=1)
        _sync(dev)
        w, n = time.perf_counter() - t0, fresh.iteration
        stats = dict(fresh.last_pipeline_stats or {})
        timing[tag] = {
            "ms_per_step": w * 2e3 / n, "steps": n,
            "host_stall_frac": stats.get("host_stall_frac"),
            "stages": {k[:-4]: v for k, v in stats.items()
                       if k.endswith("_sec")},
            "launches": _expect_launches(f"phase 23 (b) {tag} timing", {
                "lstm2_fwd_train": n, "lstm_bwd": 2 * n})}
        if tag == "native":
            it.close()
            if it.batches != n:
                raise AssertionError(f"phase 23 (b): {it.batches} native "
                                     f"batches for {n} steps")
    o = {"steps": steps, "batches_native": batches, "wall_s": wall,
         "launches": launches, "parity_rel": parity,
         "records": len(ups), "overview_equal": overview_equal,
         "system": {k: system.get(k) for k in ("device", "backend")},
         "reporter_dropped": reporter.dropped,
         "output": {"max_abs_err": out_err, "launches": out_launches},
         "timing": timing}
    print(f"ui: (b) TextGenerationLSTM (2 x LSTM(256), B={UI_B}, T={UI_T}, "
          f"stride-{UI_STRIDE} windows) fit by NativeAsyncDataSetIterator "
          f"for {UI_EPOCHS} epochs under StatsListener -> WebReporter -> "
          f"POST /remote: {steps} steps, {batches} batches from "
          f"batcher_next, launches {launches}; parameters after "
          f"{UI_CHUNK} steps vs the CPU port on its own native "
          f"iterator {parity:.3g} of max |param| (tol {UI_PARITY_TOL}); "
          f"/train/overview = the local record ({len(ups)} records): "
          f"{overview_equal}; /train/system/data {o['system']}; held-out "
          f"output max abs err {out_err:.3g} (tol {PROB_TOL}), launches "
          f"{out_launches}; ms a step native "
          f"{timing['native']['ms_per_step']:.3f} (host_stall_frac "
          f"{timing['native']['host_stall_frac']}) vs ListDataSetIterator "
          f"{timing['list']['ms_per_step']:.3f} "
          f"({timing['list']['host_stall_frac']}); the timed epochs' "
          f"stages (s) native {timing['native']['stages']}, list "
          f"{timing['list']['stages']} [{card}]", flush=True)
    if not (parity <= UI_PARITY_TOL and overview_equal and names_card
            and out_err <= PROB_TOL and reporter.dropped == 0
            and len(ups) > 0):
        raise AssertionError(f"phase 23 (b): {o}")
    res["train"] = o


def _decode_gray_png(png: bytes) -> np.ndarray:
    """An 8-bit grayscale PNG decoded with zlib and the five row filters
    (the stdlib encoder writes filter 0, Pillow any of them)."""
    import zlib
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        tag, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w = int.from_bytes(body[:4], "big")
            h = int.from_bytes(body[4:8], "big")
            if body[8:10] != b"\x08\x00":
                raise AssertionError("not an 8-bit grayscale PNG")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.int64)
    prev = np.zeros(w, np.int64)
    for r in range(h):
        f, line = raw[r, 0], raw[r, 1:].astype(np.int64)
        cur = np.zeros(w, np.int64)
        for c in range(w):
            a = cur[c - 1] if c else 0
            b, d = prev[c], prev[c - 1] if c else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:                    # Paeth
                pa, pb, pc = abs(b - d), abs(a - d), abs(a + b - 2 * d)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else d
            cur[c] = (line[c] + pred) & 0xFF
        out[r], prev = cur, cur
    return out.astype(np.uint8)


def ui_activations_part(card, res, url, reporter, data, dev="cuda"):
    """(c) ConvolutionalIterationListener on LeNet over the IDX data."""
    import base64
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.ui import (ConvolutionalIterationListener,
                                             InMemoryStatsStorage)
    from deeplearning4j_tpu_torch.zoo import LeNet
    x, y = data["train"]
    x = x[:LENET_B * LENET_STEPS].reshape(-1, ETL_SIDE, ETL_SIDE, 1)
    y = y[:LENET_B * LENET_STEPS]
    net = LeNet(num_classes=ETL_CLASSES).init(device=dev)
    net.set_listeners(ConvolutionalIterationListener(
        reporter, frequency=LENET_FREQ, session_id="lenet"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(LENET_STEPS):
        net.fit(DataSet(x[i * LENET_B:(i + 1) * LENET_B],
                        y[i * LENET_B:(i + 1) * LENET_B]))
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _expect_launches("phase 23 (c) LeNet", {})
    if not reporter.flush(timeout=60):
        raise AssertionError("phase 23 (c): the reporter did not settle")
    got = _get_json(url, "/train/activations/data?sid=lenet")
    # the CPU port at the same weights and batch
    cpu = _cpu_copy(net)
    cpu._last_input = net._last_input.cpu()
    store = InMemoryStatsStorage()
    ConvolutionalIterationListener(store, frequency=LENET_FREQ,
                                   session_id="lenet").iteration_done(
        cpu, LENET_STEPS, 0)
    want = store.get_static_info("lenet/activations")
    diffs = {}
    for k, v in want["images"].items():
        a = _decode_gray_png(base64.b64decode(got["images"][k]))
        b = _decode_gray_png(base64.b64decode(v))
        diffs[k] = int(np.abs(a.astype(int) - b.astype(int)).max()) \
            if a.shape == b.shape else None
    o = {"iteration": got.get("iteration"), "grey_diffs": diffs,
         "launches": launches, "wall_s": wall}
    print(f"ui: (c) LeNet on the IDX images (B={LENET_B}, {LENET_STEPS} "
          f"steps, cuDNN, no hand kernel: launches {launches}) with "
          f"ConvolutionalIterationListener(frequency {LENET_FREQ}) through "
          f"the reporter: /train/activations/data at iteration "
          f"{o['iteration']}, {len(got['images'])} grids, decoded with zlib "
          f"vs the CPU port's at the same weights: grey-level diffs {diffs} "
          f"(tol {GREY_TOL}); {wall:.2f} s [{card}]", flush=True)
    if not (o["iteration"] == LENET_STEPS and got["images"].keys()
            == want["images"].keys() and len(diffs) >= 2
            and all(d is not None and d <= GREY_TOL
                    for d in diffs.values())):
        raise AssertionError(f"phase 23 (c): {o}")
    res["activations"] = o


def _clf_conf(V):
    from deeplearning4j_tpu_torch import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import (LSTM, LastTimeStep,
                                                    OutputLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    return (NeuralNetConfiguration.builder().seed(ETL_SEED)
            .updater(Adam(1e-3)).list()
            .layer(LastTimeStep(fwd=LSTM(n_out=CLF_H, activation="tanh")))
            .layer(OutputLayer(n_out=V, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(V)).build())


def _ae_confs():
    from deeplearning4j_tpu_torch import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    d, h, z = AE_SIZES

    def ae():
        return (NeuralNetConfiguration.builder().seed(ETL_SEED)
                .updater(Adam(1e-3)).list()
                .layer(DenseLayer(n_in=d, n_out=h, activation="relu"))
                .layer(DenseLayer(n_in=h, n_out=z, activation="relu"))
                .layer(DenseLayer(n_in=z, n_out=h, activation="relu"))
                .layer(OutputLayer(n_in=h, n_out=d, activation="sigmoid",
                                   loss="mse"))
                .build())

    def head():
        return (NeuralNetConfiguration.builder().seed(ETL_SEED)
                .updater(Adam(1e-3)).list()
                .layer(DenseLayer(n_in=z, n_out=32, activation="relu"))
                .layer(OutputLayer(n_in=32, n_out=ETL_CLASSES,
                                   activation="softmax", loss="mcxent"))
                .build())
    return ae, head


def ui_pipeline_part(card, res, data, dev="cuda"):
    """(d) The ML-pipeline estimators: an LSTM classifier over four slots,
    save / load, and an autoencoder pipeline."""
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.scaleout import (AutoEncoderEstimator,
                                                   NetworkClassifier,
                                                   NetworkModel, Pipeline)
    from deeplearning4j_tpu_torch.zoo.corpus import corpus_windows
    (xtr, ytr), (xte, yte), vocab = corpus_windows(UI_T, stride=UI_STRIDE)
    V = len(vocab)
    # a window's label: its next character (the last step's target)
    ytr_next, yte_next = ytr[:, -1], yte[:, -1].argmax(-1)
    clf = NetworkClassifier(lambda: _clf_conf(V), epochs=CLF_EPOCHS,
                            batch_size=UI_B, workers=CLF_SLOTS,
                            device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model = clf.fit(xtr, ytr_next)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    steps = model.network.iteration
    fit_launches = _expect_launches("phase 23 (d) classifier fit", {
        "lstm_fwd_train": steps, "lstm_bwd": steps})
    calls = []
    ops.reset_launch_counts()
    for _ in range(2):
        calls.append(model.predict_proba(xte))
    proba_launches = _expect_launches("phase 23 (d) predict_proba",
                                      {"lstm_fwd": 2})
    cpu = NetworkModel(_cpu_copy(model.network))
    proba_err = float(np.abs(calls[0] - cpu.predict_proba(xte)).max())
    path = UI_DIR / "classifier.zip"
    model.save(str(path))
    ops.reset_launch_counts()
    loaded = NetworkModel.load(str(path), device=dev)
    load_err = float(np.abs(loaded.predict_proba(xte) - calls[0]).max())
    load_launches = _expect_launches("phase 23 (d) loaded predict_proba",
                                     {"lstm_fwd": 1})
    score = model.score(xte, yte_next)
    # the autoencoder pipeline on the IDX features: no hand kernel
    ae, head = _ae_confs()
    x, y = data["train"]
    xt, yt = data["t10k"]
    pipe = Pipeline([
        ("encode", AutoEncoderEstimator(ae, compressed_layer=1, epochs=1,
                                        device=dev)),
        ("classify", NetworkClassifier(head, epochs=1, device=dev))])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pipe.fit(x[:AE_ROWS], y[:AE_ROWS])
    pipe_score = pipe.score(xt, yt)
    enc = pipe.models_[0][1].transform(xt[:8])
    pipe_s = time.perf_counter() - t0
    pipe_launches = _expect_launches("phase 23 (d) pipeline", {})
    o = {"steps": steps, "fit_s": fit_s, "score": score,
         "launches": fit_launches,
         "predict_proba": {"max_abs_err": proba_err,
                           "launches": proba_launches,
                           "repeat_equal": bool(np.array_equal(*calls))},
         "load": {"max_abs_err": load_err, "launches": load_launches},
         "pipeline": {"score": pipe_score, "seconds": pipe_s,
                      "encoding_shape": list(enc.shape),
                      "launches": pipe_launches}}
    print(f"ui: (d) NetworkClassifier over LastTimeStep(LSTM({CLF_H})) -> "
          f"OutputLayer({V}) on the stride-{UI_STRIDE} windows labelled by "
          f"their next character, workers={CLF_SLOTS}, {CLF_EPOCHS} epochs: "
          f"{steps} sync steps in {fit_s:.2f} s, launches {fit_launches} "
          f"(one K2 and one K3 a step over the four slots' rows); "
          f"predict_proba of the {len(xte)} held-out windows twice: "
          f"launches {proba_launches}, vs the CPU port {proba_err:.3g} (tol "
          f"{PROB_TOL}); held-out next-char accuracy {score:.4f}; "
          f"NetworkModel save / load: max abs err {load_err:.3g}, launches "
          f"{load_launches}; AutoEncoderEstimator {AE_SIZES} + "
          f"NetworkClassifier Pipeline on {AE_ROWS} IDX rows: test accuracy "
          f"{pipe_score:.4f}, encoding {list(enc.shape)}, launches "
          f"{pipe_launches}, {pipe_s:.2f} s [{card}]", flush=True)
    if not (proba_err <= PROB_TOL and load_err <= 1e-6
            and o["predict_proba"]["repeat_equal"]
            and enc.shape == (8, AE_SIZES[2]) and pipe_score > 0.9):
        raise AssertionError(f"phase 23 (d): {o}")
    res["pipeline"] = o


def _purity(assign, labels, k):
    return sum(np.bincount(labels[assign == c]).max()
               for c in range(k) if (assign == c).any()) / len(labels)


def _knn_check(x, q, idx, dist, metric):
    """Each query's k results against float64 numpy, within the float32
    rounding bound of the expression the index computes (gamma = D x
    2^-24, the bound of a D-term dot product): euclidean, on squared
    distances, 2 gamma (|q|^2 + max |c|^2); cosine 3 gamma (the unit
    vectors' own rounding too). The float64 distances of the returned
    indices must be the k smallest ones, and the returned distances
    theirs. Returns the largest error of each as a share of its bound,
    and the share of indices in float64's order."""
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    gamma = x.shape[1] * 2.0 ** -24
    if metric == "cosine":
        xn = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
        qn = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        d = 1.0 - qn @ xn.T
        got = dist.astype(np.float64)
        bound = np.full((len(q), 1), 3 * gamma)
    else:
        q2, c2 = (q64 ** 2).sum(1)[:, None], (x64 ** 2).sum(1)[None]
        d = np.maximum(q2 + c2 - 2 * q64 @ x64.T, 0.0)
        got = dist.astype(np.float64) ** 2
        bound = 2 * gamma * (q2 + c2.max())
    k = idx.shape[1]
    best = np.sort(d, axis=1)[:, :k]
    mine = np.take_along_axis(d, idx.astype(np.int64), 1)
    set_err = float((np.abs(np.sort(mine, axis=1) - best) / bound).max())
    dist_err = float((np.abs(got - mine) / bound).max())
    same = float((np.argsort(d, axis=1, kind="stable")[:, :k] == idx).mean())
    return set_err, dist_err, same


def ui_clustering_part(card, res, url, data, bh_job, dev="cuda"):
    """(e) k-means, kNN and its server, exact t-SNE, and the Barnes-Hut
    t-SNE process's result, on the IDX features."""
    import urllib.request
    import torch
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.clustering import (KMeansClustering,
                                                     NearestNeighbors, kmeans)
    from deeplearning4j_tpu_torch.clustering.knn_server import (
        NearestNeighborsClient, NearestNeighborsServer)
    from deeplearning4j_tpu_torch.plot import Tsne
    x, y = data["train"]
    xt, _ = data["t10k"]
    labels = y.argmax(1)
    o = {}
    ops.reset_launch_counts()
    # k-means
    t0 = time.perf_counter()
    km = KMeansClustering(k=KM_K, seed=ETL_SEED, device=dev).apply_to(x)
    km_s = time.perf_counter() - t0
    purity = _purity(km.assignments, labels, KM_K)
    pts = torch.as_tensor(x, device=dev)
    cent = torch.as_tensor(km.centroids, device=dev)
    km_ms = time_ms(lambda: kmeans._lloyd_step(pts, cent, KM_K), 1,
                    rounds=3, warmup=1)
    sub = x[:KM_SUBSET]
    kc = KMeansClustering(k=KM_K, seed=ETL_SEED, device=dev).apply_to(sub)
    kp = KMeansClustering(k=KM_K, seed=ETL_SEED, device="cpu").apply_to(sub)
    km_sub = {"assignments_equal": bool(np.array_equal(kc.assignments,
                                                       kp.assignments)),
              "centroid_err": float(np.abs(kc.centroids
                                           - kp.centroids).max()),
              "iterations": [kc.iterations, kp.iterations]}
    o["kmeans"] = {"purity": purity, "iterations": km.iterations,
                   "seconds": km_s, "ms_per_iteration": km_ms,
                   "cost": km.cost, "subset": km_sub}
    print(f"ui: (e) KMeansClustering(k={KM_K}) on {len(x)} x {x.shape[1]}: "
          f"purity {purity:.4f} (bar {KM_PURITY}), {km.iterations} Lloyd "
          f"iterations, {km_ms:.3f} ms an iteration, {km_s:.2f} s with the "
          f"host's k-means++ start; on {KM_SUBSET} rows against the CPU "
          f"port: {km_sub} (tol {KM_TOL}) [{card}]", flush=True)
    if not (purity >= KM_PURITY and km_sub["assignments_equal"]
            and km_sub["centroid_err"] <= KM_TOL):
        raise AssertionError(f"phase 23 (e) k-means: {o['kmeans']}")
    # kNN: 10000 queries over the 60000-row corpus
    o["knn"] = {}
    for metric in ("euclidean", "cosine"):
        nn = NearestNeighbors(x, metric=metric, device=dev)
        if nn.corpus.device.type != dev:
            raise AssertionError("phase 23 (e): the kNN index is not on "
                                 "the card")
        nn.knn(xt[:8], KNN_K)
        t0 = time.perf_counter()
        idx, dist = nn.knn(xt[:KNN_QUERIES], KNN_K)
        knn_ms = (time.perf_counter() - t0) * 1e3
        set_err, dist_err, same = _knn_check(x, xt[:KNN_CHECK],
                                             idx[:KNN_CHECK],
                                             dist[:KNN_CHECK], metric)
        o["knn"][metric] = {"ms": knn_ms, "set_err": set_err,
                            "dist_err": dist_err, "index_share": same}
        print(f"ui: (e) NearestNeighbors({metric}) on the card, "
              f"{KNN_QUERIES} queries x {len(x)} corpus, k={KNN_K}: "
              f"{knn_ms:.1f} ms; against float64 numpy on {KNN_CHECK} "
              f"queries: the k-set's distances {set_err:.3g} and the "
              f"returned distances {dist_err:.3g} of float32's rounding "
              f"bound (bar 1), indices in float64's order {same:.4f} "
              f"[{card}]", flush=True)
        if not (set_err <= 1.0 and dist_err <= 1.0):
            raise AssertionError(f"phase 23 (e) kNN {metric}: "
                                 f"{o['knn'][metric]}")
    # the kNN server over the card index
    srv = NearestNeighborsServer(x, port=0, device=dev).start()
    try:
        if not (isinstance(srv._index, NearestNeighbors)
                and srv._index.corpus.device.type == dev):
            raise AssertionError("phase 23 (e): the server's index is not "
                                 "on the card")
        cli = NearestNeighborsClient(f"http://127.0.0.1:{srv.port}")
        got = cli.knn_new(xt[:4], KNN_K)
        want_i, want_d = srv._index.knn(xt[:4], KNN_K)
        by_vector = all([r["index"] for r in row] == list(wi)
                        and [r["distance"] for r in row]
                        == [float(v) for v in wd]
                        for row, wi, wd in zip(got, want_i, want_d))
        near = cli.knn(index=5, k=KNN_K)
        wi, _ = srv._index.knn(x[5:6], KNN_K + 1)
        by_index = [r["index"] for r in near] == [
            int(i) for i in wi[0] if i != 5][:KNN_K]
    finally:
        srv.stop()
    o["server"] = {"by_vector_equal": by_vector, "by_index_equal": by_index}
    print(f"ui: (e) NearestNeighborsServer on the card index over HTTP: "
          f"/knnnew equal to the in-process index {by_vector}, /knn "
          f"{by_index} [{card}]", flush=True)
    if not (by_vector and by_index):
        raise AssertionError(f"phase 23 (e) server: {o['server']}")
    # exact t-SNE: the CPU port's P and first steps at n=1000, then 5000
    # points for 500 iterations
    small = x[:TSNE_CPU_N]
    pc = Tsne(device=dev)._p_matrix(small).cpu()
    pp = Tsne(device="cpu")._p_matrix(small)
    p_err = float((pc - pp).abs().max())
    # the steps from one P: the perplexity search's betas are large on
    # these tight blobs, so float32's rounding of the distances moves P by
    # ~1% relative (4e-6 of P's 3e-4) and the trajectories follow their
    # own P's
    kw = dict(max_iter=TSNE_CPU_ITERS, **TSNE_CPU_KW)
    tc, tp = Tsne(device=dev, **kw), Tsne(device="cpu", **kw)
    tc._p_matrix = lambda _x: pp.to(dev)
    tp._p_matrix = lambda _x: pp
    yc, yp = tc.fit(small), tp.fit(small)
    y_err = float(np.abs(yc - yp).max() / np.abs(yp).max())
    big = x[:TSNE_N]
    t0 = time.perf_counter()
    Tsne(device=dev)._p_matrix(big)
    _sync(dev)
    p_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts = Tsne(device=dev, max_iter=TSNE_ITERS)
    emb = ts.fit(big)
    tsne_s = time.perf_counter() - t0
    # the separation bar: class centroids further apart than twice the
    # classes' spread (each class's RMS distance to its centroid: the JAX
    # test's flattened std also counts a centroid's x - y offset, which
    # with ten classes says nothing of their spread), and every point
    # nearest its own class's centroid
    lab = labels[:TSNE_N]
    cents = np.stack([emb[lab == c].mean(0) for c in range(ETL_CLASSES)])
    spread = np.mean([np.sqrt(((emb[lab == c] - cents[c]) ** 2).sum(1)
                              .mean()) for c in range(ETL_CLASSES)])
    min_sep = min(np.linalg.norm(cents[i] - cents[j])
                  for i in range(ETL_CLASSES)
                  for j in range(i + 1, ETL_CLASSES))
    nearest = float((((emb[:, None] - cents[None]) ** 2).sum(-1).argmin(1)
                     == lab).mean())
    # the coordinates through the UI's t-SNE routes
    body = json.dumps({"sessionId": "idx", "coords": emb.tolist(),
                       "labels": [int(v) for v in lab]}).encode()
    req = urllib.request.Request(url + "/tsne/upload", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        uploaded = json.loads(r.read())["status"]
    back = _get_json(url, "/tsne/coords?sid=idx")
    coords_equal = back["coords"] == emb.astype(np.float64).tolist()
    o["tsne"] = {"p_err": p_err, "y_err": y_err, "n": TSNE_N,
                 "iterations": TSNE_ITERS, "seconds": tsne_s,
                 "p_seconds": p_s,
                 "ms_per_iteration": (tsne_s - p_s) * 1e3 / TSNE_ITERS,
                 "kl": ts.kl, "min_sep": float(min_sep),
                 "spread": float(spread), "nearest_centroid": nearest,
                 "upload": uploaded,
                 "coords_equal": coords_equal}
    o["barnes_hut"] = bh_tsne_result(bh_job)
    o["launches"] = _expect_launches("phase 23 (e)", {})
    print(f"ui: (e) exact Tsne at n={TSNE_CPU_N} against the CPU port: P "
          f"max abs err {p_err:.3g} (tol {TSNE_P_TOL}), {TSNE_CPU_ITERS} "
          f"iterations from the CPU port's P at {TSNE_CPU_KW} {y_err:.3g} "
          f"of max |y| (tol {TSNE_Y_TOL}); n={TSNE_N}, {TSNE_ITERS} iterations: "
          f"{tsne_s:.2f} s ({o['tsne']['ms_per_iteration']:.3f} ms an "
          f"iteration after {p_s:.2f} s of P), KL {ts.kl:.4f}, smallest "
          f"class-centroid distance {min_sep:.2f} against 2 x spread "
          f"{2 * spread:.2f}, nearest its class's centroid {nearest:.4f}; "
          f"/tsne/upload {uploaded}, /tsne/coords equal "
          f"{coords_equal}; BarnesHutTsne n={o['barnes_hut']['n']}, "
          f"{o['barnes_hut']['iterations']} iterations (host-bound: the SpTree loop is host numpy; kNN graph and P on "
          f"the card) {o['barnes_hut']['seconds']:.2f} s in its own process "
          f"beside (b)-(e), waited {o['barnes_hut']['waited_s']:.2f} s, "
          f"finite {o['barnes_hut']['finite']}; launches {o['launches']} "
          f"[{card}]", flush=True)
    if not (p_err <= TSNE_P_TOL and y_err <= TSNE_Y_TOL
            and min_sep > 2 * spread and nearest == 1.0
            and uploaded == "ok" and coords_equal
            and o["barnes_hut"]["finite"]):
        raise AssertionError(f"phase 23 (e) t-SNE: {o['tsne']}, "
                             f"{o['barnes_hut']}")
    res["clustering"] = o


def bh_tsne_start(x, dev):
    """Start Barnes-Hut t-SNE of ``x`` in its own process (this script
    with ``--bh-tsne``): its tree loop is host numpy, so it runs beside
    the phase's card work on another core without taking this process's
    GIL."""
    inp, out = UI_DIR / "bh_in.npy", UI_DIR / "bh_out.npz"
    np.save(inp, x)
    log = open(UI_DIR / "bh.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--bh-tsne", str(inp),
         str(out), dev], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
    return {"proc": proc, "out": out, "log": log}


def bh_tsne_main(inp, out, dev):
    """``--bh-tsne IN OUT DEV``: BarnesHutTsne of the rows in IN; the
    embedding and the fit's seconds into OUT."""
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne
    x = np.load(inp)
    t0 = time.perf_counter()
    emb = BarnesHutTsne(max_iter=BH_ITERS, device=dev).fit(x)
    np.savez(out, emb=emb, seconds=time.perf_counter() - t0,
             iterations=BH_ITERS)
    return 0


def bh_tsne_result(job, timeout=600):
    """Wait for the Barnes-Hut process; its seconds, the wait, and
    whether its embedding is finite and of its shape."""
    t0 = time.perf_counter()
    try:
        rc = job["proc"].wait(timeout=timeout)
    finally:
        job["log"].close()
    waited = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"phase 23 (e): Barnes-Hut t-SNE exited {rc}: "
                             + (UI_DIR / "bh.log").read_text()[-3000:])
    got = np.load(job["out"])
    emb = got["emb"]
    return {"seconds": float(got["seconds"]), "waited_s": waited,
            "n": len(emb), "iterations": int(got["iterations"]),
            "finite": bool(emb.shape == (BH_N, 2)
                           and np.isfinite(emb).all())}


def ui_phase(card, dev="cuda"):
    """Phase 23: ETL, the native-fed char model under the remote UI, the
    ML pipeline, clustering and t-SNE (``chip_smoke.py`` docstring)."""
    import shutil
    from deeplearning4j_tpu_torch.ui import UIServer, WebReporter
    t0 = time.perf_counter()
    shutil.rmtree(UI_DIR, ignore_errors=True)
    UI_DIR.mkdir(parents=True)
    res = {"card": card}
    server = UIServer(port=0)
    reporter = bh_job = None
    try:
        server.enable_remote_listener()
        url = f"http://127.0.0.1:{server.port}"
        reporter = WebReporter(url)
        t1 = time.perf_counter()
        data = ui_etl_part(card, res)
        res["etl_seconds"] = time.perf_counter() - t1
        bh_job = bh_tsne_start(data["train"][0][:BH_N], dev)
        for name, run in (
                ("train", lambda: ui_train_part(card, res, url, reporter,
                                                dev)),
                ("activations", lambda: ui_activations_part(
                    card, res, url, reporter, data, dev)),
                ("pipeline", lambda: ui_pipeline_part(card, res, data, dev)),
                ("clustering", lambda: ui_clustering_part(
                    card, res, url, data, bh_job, dev))):
            t1 = time.perf_counter()
            run()
            res[f"{name}_seconds"] = time.perf_counter() - t1
    finally:
        if bh_job is not None and bh_job["proc"].poll() is None:
            bh_job["proc"].kill()
            bh_job["proc"].wait()
        if reporter is not None:
            reporter.close()
        server.stop()
        shutil.rmtree(UI_DIR, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"ui: phase 23 took {res['seconds']:.1f} s ("
          + ", ".join(f"{k[:-8]} {v:.1f} s" for k, v in res.items()
                      if k.endswith("_seconds"))
          + f") [{card}]", flush=True)
    return res


def main() -> int:
    import torch
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-rank":
        # one of phase 18 (c)'s gloo ranks, started by dp_gloo_part
        rank, world, port = (int(a) for a in sys.argv[2:5])
        return dp_rank_main(rank, world, port, sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--bh-tsne":
        # phase 23 (e)'s Barnes-Hut t-SNE, started by bh_tsne_start
        return bh_tsne_main(*sys.argv[2:5])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from deeplearning4j_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_done(1, "card", t_script, card)

    t0 = time.perf_counter()
    built = build.build_kernels()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for "
          f"{sorted(built)}", flush=True)
    for stem, info in built.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build: {stem} {info['seconds']:.1f} s; " + " | ".join(regs),
              flush=True)
    phase_done(2, "build", t0, card)

    t0 = time.perf_counter()
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
    for kv_dtype in ("float32", "bfloat16"):
        for kernel in ("flash_decode", "flash_decode_paged"):
            for B, pos in ((1, [511]), (8, None), (64, None)):
                rows.append(attn_kernel_case(kernel, B, 512, pos=pos,
                                             kv_dtype=kv_dtype))
                print("kernel: " + fmt_attn(rows[-1]) + f" [{card}]",
                      flush=True)
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
                for kv_dtype in ("float32", "bfloat16"):
                    rows.append(attn_kernel_case(kernel, 4, T, dh=dh,
                                                 heads=2, kv_dtype=kv_dtype))
                    print("kernel: " + fmt_attn(rows[-1]) + f" [{card}]",
                          flush=True)

    phase_done(3, "kernel", t0, card)

    t4 = time.perf_counter()
    res = slice_phase(card)
    res["phase_seconds"] = time.perf_counter() - t4
    t0 = time.perf_counter()
    f4 = f4_phase(card)
    f4["phase_seconds"] = time.perf_counter() - t0
    phase_done(4, "slice", t4, card)
    t5 = time.perf_counter()
    tiny = transformer_phase(card)
    tiny["phase_seconds"] = time.perf_counter() - t5
    t0 = time.perf_counter()
    wide = wide_head_phase(card)
    wide["phase_seconds"] = time.perf_counter() - t0
    phase_done(5, "tiny", t5, card)
    t0 = time.perf_counter()
    train = train_phase(card)
    train["phase_seconds"] = phase_done(6, "train", t0, card)
    t0 = time.perf_counter()
    tiny_train = tiny_train_phase(card)
    tiny_train["phase_seconds"] = phase_done(7, "tiny train", t0, card)
    t0 = time.perf_counter()
    captured = captured_train_phase(card)
    captured["phase_seconds"] = phase_done(8, "captured", t0, card)
    t0 = time.perf_counter()
    regularised = regularised_phase(card)
    regularised["phase_seconds"] = phase_done(9, "regularised", t0, card)
    t0 = time.perf_counter()
    fit_contract = fit_contract_phase(card)
    fit_contract["phase_seconds"] = phase_done(10, "fit contract", t0, card)
    t0 = time.perf_counter()
    serving = serving_features_phase(card)
    serving["phase_seconds"] = phase_done(11, "serving features", t0, card)
    t0 = time.perf_counter()
    cnn = cnn_phase(card)
    cnn["phase_seconds"] = phase_done(12, "cnn", t0, card)
    inception = inception_phase(card)
    kv_tier = kv_tier_phase(card)
    precision = serving_precision_phase(card)
    obs = observability_phase(card)
    routed = routed_phase(card, built)
    dp = dp_phase(card)
    cluster = cluster_phase(card)
    mp = mp_phase(card)
    tools = tools_phase(card)
    model_import = import_phase(card)
    ui = ui_phase(card)

    # each kernel at its main path's shape, with the launches of the run
    # that drove it: /predict of the 15 held-out windows (bucket 16, T=64)
    # runs K4, rnn_time_step in 16-step chunks of 15 rows K1; the recipe's
    # steps (B=32, T=64) K4-train and K3; tBPTT chunks (B=32, T=16) K2
    main_shapes = {"lstm2_fwd": (64, 16, {
                       "lstm2_fwd": res["launches"].get("lstm2_fwd", 0)
                       + counted_launches(precision["lstm"], "lstm2_fwd")
                       + counted_launches(dp, "lstm2_fwd")
                       + counted_launches(tools, "lstm2_fwd")
                       + counted_launches(model_import, "lstm2_fwd")
                       + counted_launches(ui, "lstm2_fwd")}),
                   "lstm_fwd": (16, 15, {
                       "lstm_fwd": res["launches"].get("lstm_fwd", 0)
                       + counted_launches(tools, "lstm_fwd")
                       + counted_launches(model_import, "lstm_fwd")
                       + counted_launches(ui, "lstm_fwd")}),
                   "lstm2_fwd_train": (64, 32, {
                       k: train["launches_recipe"].get(k, 0)
                       + counted_launches(obs, k) + counted_launches(dp, k)
                       + counted_launches(tools, k)
                       + counted_launches(model_import, k)
                       + counted_launches(ui, k)
                       for k in ("lstm2_fwd_train", "lstm_bwd")}),
                   "lstm_bwd": (64, 32, {
                       k: train["launches_recipe"].get(k, 0)
                       + counted_launches(obs, k) + counted_launches(dp, k)
                       + counted_launches(cluster, k)
                       + counted_launches(mp, k)
                       + counted_launches(tools, k)
                       + counted_launches(model_import, k)
                       + counted_launches(ui, k)
                       for k in ("lstm2_fwd_train", "lstm_bwd")}),
                   "lstm_fwd_train": (16, 32, {
                       "lstm_fwd_train":
                       train["launches_tbptt"].get("lstm_fwd_train", 0)
                       + counted_launches(cluster, "lstm_fwd_train")
                       + counted_launches(mp, "lstm_fwd_train")
                       + counted_launches(tools, "lstm_fwd_train")
                       + counted_launches(ui, "lstm_fwd_train")})}
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
        entries[-1]["launches_phase_20"] = counted_launches(mp, kernel)
        entries[-1]["launches_phase_21"] = counted_launches(tools, kernel)
        entries[-1]["launches_phase_22"] = counted_launches(model_import,
                                                            kernel)
        entries[-1]["launches_phase_23"] = counted_launches(ui, kernel)
    # phase 19: the in-process oracle's K2 / K3 are in the totals above;
    # the workers' own counters are printed apart, beside the kernels'
    # numbers at the workers' shape (T=16, B=16, H=24)
    for row in cluster["kernel_rows"]:
        e = next(x for x in entries if x["name"] == row["kernel"])
        e["charlstm"] = {k: row[k] for k in (
            "T", "B", "H", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
        e["charlstm"]["launches"] = counted_launches(cluster, row["kernel"])
        e["charlstm"]["workers_launches"] = sum(
            part["workers_launches"].get(row["kernel"], 0)
            for part in (cluster["parity"], cluster["kill"],
                         cluster["partition"],
                         cluster["partition"]["threshold"]))
    # TinyTransformer: /predict of the held-out windows runs K5 at bucket 16
    # (BH 64, T=64, causal); the 8-slot engines run K8/K9 with C=512, here
    # at the streams' positions halfway through their completions
    row = attn_kernel_case("flash_attn_fwd", 16, 64, True, seed=1)
    print("main-path shape: " + fmt_attn(row) + f" [{card}]", flush=True)
    by_path = {"tiny /predict": tiny["launches_predict"]["flash_attn_fwd"]
               + tiny["launches_mixed"]["flash_attn_fwd"],
               "phase 14": counted_launches(kv_tier, "flash_attn_fwd"),
               "phase 15": counted_launches(precision, "flash_attn_fwd"),
               "phase 16": counted_launches(obs, "flash_attn_fwd"),
               "phase 17": counted_launches(routed, "flash_attn_fwd"),
               "phase 18": counted_launches(dp, "flash_attn_fwd"),
               "phase 20": counted_launches(mp, "flash_attn_fwd")}
    entry("flash_attn_fwd", row, sum(by_path.values()))
    entries[-1]["launches_by_path"] = by_path
    entries[-1]["launches_phase_20"] = by_path["phase 20"]
    # the recipe's train steps (B=32, T=64) run K6 and K7 at BH 128, causal
    recipe = tiny_train["recipe"]["launches_train"]
    for row in bwd_kernel_case(TINY_B, TINY_T, True, seed=1):
        entry(row["kernel"], row, recipe[row["kernel"]]
              + counted_launches(obs, row["kernel"])
              + counted_launches(dp, row["kernel"])
              + counted_launches(mp, row["kernel"]))
        entries[-1]["launches_phase_20"] = counted_launches(mp, row["kernel"])
    print("main-path shape: " + fmt_bwd(rows[-2:]) + f" [{card}]", flush=True)
    mid = DECODE_MID
    for kernel, kind in (("flash_decode", "dense"),
                         ("flash_decode_paged", "paged")):
        row = attn_kernel_case(kernel, 8, 512, pos=mid, seed=1)
        print("main-path shape: " + fmt_attn(row) + f" [{card}]", flush=True)
        # the bfloat16 instantiation's launches: phase 15's bf16 engines
        bf16_launches = sum(counted_launches(v, kernel) for k, v in
                            precision["decode"].items()
                            if k.startswith("bf16_"))
        by_path = {f"tiny {kind} /generate":
                   tiny[f"launches_{kind}"][kernel],
                   "phase 11": counted_launches(serving, kernel),
                   "phase 14": counted_launches(kv_tier, kernel),
                   "phase 15 (float32 caches)":
                   counted_launches(precision, kernel) - bf16_launches,
                   "phase 16": counted_launches(obs, kernel),
                   "phase 17": counted_launches(routed, kernel),
                   "phase 20": counted_launches(mp, kernel)}
        entry(kernel, row, sum(by_path.values()))
        entries[-1]["launches_by_path"] = by_path
        entries[-1]["launches_phase_20"] = by_path["phase 20"]
        # the same shape over a bfloat16 cache (F8): that instantiation's
        # numbers beside the float32 ones
        row = attn_kernel_case(kernel, 8, 512, pos=mid, seed=1,
                               kv_dtype="bfloat16")
        print("main-path shape: " + fmt_attn(row) + f" [{card}]", flush=True)
        rows.append(row)
        entries[-1]["bf16"] = {
            k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "floor_ms",
                                "plan")}
        entries[-1]["bf16"]["launches"] = bf16_launches
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

    script_seconds = time.perf_counter() - t_script
    print(f"chip_smoke: the whole script took {script_seconds:.1f} s "
          f"[{card}]", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "script_seconds": script_seconds,
         "kernel_rows": rows, "k3_hidden_sizes": k3_sizes,
         "k4_hidden_sizes": k4_sizes, "k12_hidden_sizes": k12_sizes,
         "slice": res, "f4": f4, "tiny": tiny, "wide": wide,
         "train": train, "tiny_train": tiny_train, "captured": captured,
         "regularised": regularised, "fit_contract": fit_contract,
         "serving_features": serving, "cnn": cnn, "inception": inception,
         "kv_tier": kv_tier, "precision": precision, "observability": obs,
         "routed": routed, "data_parallel": dp, "cluster": cluster,
         "model_parallel": mp, "training_tools": tools,
         "model_import": model_import, "ui": ui,
         "kernels": entries},
        indent=1))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
