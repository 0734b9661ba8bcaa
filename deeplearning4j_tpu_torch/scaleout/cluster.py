"""Cluster training facades.

Counterpart of deeplearning4j_tpu/scaleout/cluster.py: ``repartition``
and the ``ClusterMultiLayerNetwork`` / ``ClusterComputationGraph``
facades, which own a network and a TrainingMaster and forward ``fit`` and
``evaluate``, in the shape of the reference's Spark wrappers:

    master = ParameterAveragingTrainingMaster(averaging_frequency=4)
    cluster_net = ClusterMultiLayerNetwork(net, master)
    cluster_net.fit(batches)
    ev = cluster_net.evaluate(batches)
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.data.dataset import DataSet


def repartition(batches, batch_size: int, seed: Optional[int] = None):
    """Re-cut a list or iterable of DataSets into equal-size minibatches
    (the last one may be short), optionally shuffling the examples first;
    masks are kept."""
    items = [b if isinstance(b, DataSet) else DataSet(*b) for b in batches]
    if not items:
        return []
    merged = DataSet.merge(items)
    if seed is not None:
        merged.shuffle(seed)
    return merged.batch_by(batch_size)


class _ClusterModel:
    def __init__(self, net, training_master):
        self.net = net
        self.master = training_master

    def fit(self, data, epochs: int = 1):
        """``data``: an iterable of DataSets (the RDD's counterpart)."""
        for _ in range(epochs):
            if hasattr(data, "reset"):
                data.reset()
            self.master.execute_training(self.net, data)
            self.net.epoch += 1
        return self.net

    def evaluate(self, data):
        return self.net.evaluate(data)

    def score_examples(self, data):
        """Each minibatch's mean score (parity: scoreExamples)."""
        scores = []
        for ds in data:
            if not isinstance(ds, DataSet):
                ds = DataSet(*ds)
            scores.append(self.net.score(ds))
        return scores

    def get_network(self):
        return self.net

    def get_training_master(self):
        return self.master


class ClusterMultiLayerNetwork(_ClusterModel):
    """Parity: SparkDl4jMultiLayer."""


class ClusterComputationGraph(_ClusterModel):
    """Parity: SparkComputationGraph."""
