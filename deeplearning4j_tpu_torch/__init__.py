"""PyTorch/CUDA port of deeplearning4j_tpu for NVIDIA Hopper cards.

The JAX package beside it is the reference. This package imports neither
``jax`` nor ``deeplearning4j_tpu``; its entry points run on CUDA unless the
caller passes ``device="cpu"``. Ported so far: serving and training of
sequential networks with LSTM layers (the bundled TextGenerationLSTM),
through hand-written CUDA kernels for the fused LSTM forward (inference
and training modes) and backward; serving and training of computation
graphs with causal self-attention (TinyTransformer), through hand-written
CUDA kernels for flash attention (forward, and the backward's dq and
dk/dv) and for flash decode over dense and paged KV caches. Both
containers train with the JAX package's default step: the fused flat
update (nn/fused_update.py), the bf16 train-precision policy, and on the
card each step replayed from a CUDA graph (exec/executor.py); and with its
``fit`` contract: streamed chunks, device prefetch, listeners
(``optimize``), crash-safe checkpoints and resume (``resilience``), the
pipeline's metrics and spans (``monitor``). The convolutional path --
LeNet, SimpleCNN, AlexNet, VGG, Darknet19 and ResNet50 served and
trained, with BatchNormalization's running statistics as layer state,
every graph vertex, the normalizers with the device-side image scaler
and the standard datasets' fetchers -- runs on cuDNN and plain PyTorch,
as the JAX package leaves it to XLA. Both serving engines take the JAX
package's weight-only serving precisions (``quant``: int8 and
fp8-e4m3 codes with per-channel scales, ``exec.Executor(precision=)``),
hot-swap their own resident weights in place, and run captured programs
(CUDA graphs) over them.
"""

from deeplearning4j_tpu_torch import monitor, optimize, resilience  # noqa: F401
from deeplearning4j_tpu_torch.models.computation_graph import (  # noqa: F401
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (  # noqa: F401
    MultiLayerNetwork, params_from_numpy)
from deeplearning4j_tpu_torch.resilience import (  # noqa: F401
    CheckpointListener, CheckpointManager, latest_checkpoint)
