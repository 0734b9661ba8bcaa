"""Training and inference over the mesh's slots (exec/mesh.py).
Counterpart of deeplearning4j_tpu/parallel/: ``ParallelWrapper``
(wrapper.py; data parallelism, and TP x DP over a (data, model) mesh
through tensor_parallel.py), ``ParallelInference`` (inference.py), the
process group (distributed.py), threshold compression (compression.py),
ring attention (sequence_parallel.py), GPipe (pipeline.py) and the
mixture of experts (expert_parallel.py)."""

from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

__all__ = ["ParallelWrapper", "ParallelInference"]
