"""Data-parallel training and inference over the mesh's slots
(exec/mesh.py): ``ParallelWrapper`` (wrapper.py), ``ParallelInference``
(inference.py), the process group (distributed.py) and threshold
compression (compression.py). Counterpart of deeplearning4j_tpu/parallel/;
its pipeline, expert and sequence parallelism are not ported yet."""

from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference

__all__ = ["ParallelWrapper", "ParallelInference"]
