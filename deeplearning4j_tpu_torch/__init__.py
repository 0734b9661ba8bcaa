"""PyTorch/CUDA port of deeplearning4j_tpu for NVIDIA Hopper cards.

The JAX package beside it is the reference. This package imports neither
``jax`` nor ``deeplearning4j_tpu``; its entry points run on CUDA unless the
caller passes ``device="cpu"``. Ported so far: serving and training of
sequential networks with LSTM layers (the bundled TextGenerationLSTM),
through hand-written CUDA kernels for the fused LSTM forward (inference
and training modes) and backward; serving and training of computation
graphs with causal self-attention (TinyTransformer), through hand-written
CUDA kernels for flash attention (forward, and the backward's dq and
dk/dv) and for flash decode over dense and paged KV caches.
"""

from deeplearning4j_tpu_torch.models.computation_graph import (  # noqa: F401
    ComputationGraph)
from deeplearning4j_tpu_torch.models.multi_layer_network import (  # noqa: F401
    MultiLayerNetwork, params_from_numpy)
