"""Cluster-scale training: the TrainingMaster SPI, its parameter-averaging
and gradient-sharing masters, training stats and the cluster facades.
Counterpart of deeplearning4j_tpu/scaleout/ without ``ml_pipeline`` and
``s3`` (ROADMAP item 8)."""

from deeplearning4j_tpu_torch.scaleout.training_master import (
    ParameterAveragingTrainingMaster, SharedTrainingMaster, TrainingMaster,
    TrainingStats)
from deeplearning4j_tpu_torch.scaleout.cluster import (
    ClusterComputationGraph, ClusterMultiLayerNetwork, repartition)

__all__ = [
    "TrainingMaster", "ParameterAveragingTrainingMaster",
    "SharedTrainingMaster", "TrainingStats",
    "ClusterMultiLayerNetwork", "ClusterComputationGraph", "repartition",
]
