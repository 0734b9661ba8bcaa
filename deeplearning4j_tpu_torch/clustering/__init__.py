"""Nearest neighbours and clustering: the spatial trees (host numpy),
``KMeansClustering`` and ``NearestNeighbors`` on the device, and the kNN
server (knn_server.py). Counterpart of deeplearning4j_tpu/clustering/."""

from deeplearning4j_tpu_torch.clustering.trees import (  # noqa: F401
    KDTree, QuadTree, SpTree, VPTree)
from deeplearning4j_tpu_torch.clustering.kmeans import \
    KMeansClustering  # noqa: F401
from deeplearning4j_tpu_torch.clustering.knn import \
    NearestNeighbors  # noqa: F401

__all__ = ["VPTree", "KDTree", "QuadTree", "SpTree", "KMeansClustering",
           "NearestNeighbors"]
