"""t-SNE embeddings. Counterpart of deeplearning4j_tpu/plot/."""

from deeplearning4j_tpu_torch.plot.tsne import (  # noqa: F401
    BarnesHutTsne, Tsne)

__all__ = ["Tsne", "BarnesHutTsne"]
