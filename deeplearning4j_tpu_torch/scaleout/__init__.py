"""Cluster-scale training: the TrainingMaster SPI, its parameter-averaging
and gradient-sharing masters, training stats, the cluster facades, the
ML-pipeline estimators (ml_pipeline.py) and the object-store adapters
(s3.py). Counterpart of deeplearning4j_tpu/scaleout/."""

from deeplearning4j_tpu_torch.scaleout.training_master import (
    ParameterAveragingTrainingMaster, SharedTrainingMaster, TrainingMaster,
    TrainingStats)
from deeplearning4j_tpu_torch.scaleout.ml_pipeline import (
    AutoEncoderEstimator, AutoEncoderModel, NetworkClassifier, NetworkModel,
    Pipeline)
from deeplearning4j_tpu_torch.scaleout.cluster import (
    ClusterComputationGraph, ClusterMultiLayerNetwork, repartition)

__all__ = [
    "NetworkClassifier", "NetworkModel", "AutoEncoderEstimator",
    "AutoEncoderModel", "Pipeline",
    "TrainingMaster", "ParameterAveragingTrainingMaster",
    "SharedTrainingMaster", "TrainingStats",
    "ClusterMultiLayerNetwork", "ClusterComputationGraph", "repartition",
]
