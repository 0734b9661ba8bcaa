"""Graph API + embeddings (counterpart of deeplearning4j_tpu/graph;
parity: the reference's deeplearning4j-graph/).

In-memory graph structures, random-walk iterators and DeepWalk graph
vectorization (hierarchical softmax over a degree-weighted Huffman tree):
walks are generated vectorized on the host, and the embedding updates run
as batched gather / scatter-add steps on the device (the card unless
``device=`` says otherwise).
"""

from deeplearning4j_tpu_torch.graph.api import (Vertex, Edge, Graph,
                                          NoEdgeHandling, NoEdgesException)
from deeplearning4j_tpu_torch.graph.walks import (RandomWalkIterator,
                                            WeightedRandomWalkIterator,
                                            RandomWalkGraphIteratorProvider)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, GraphHuffman

__all__ = [
    "Vertex", "Edge", "Graph", "NoEdgeHandling", "NoEdgesException",
    "RandomWalkIterator", "WeightedRandomWalkIterator",
    "RandomWalkGraphIteratorProvider", "DeepWalk", "GraphHuffman",
]
