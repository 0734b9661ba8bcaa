"""ML-pipeline estimator / transformer facade over the network containers.

Counterpart of deeplearning4j_tpu/scaleout/ml_pipeline.py (parity surface:
dl4j-spark-ml's SparkDl4jNetwork, an estimator over a configuration whose
``fit`` trains through a TrainingMaster and returns a model with
``output`` / ``predict``, and its AutoEncoder, whose fitted model's
``transform`` gives the compressed layer's activations). The facade speaks
the scikit-learn estimator protocol (``fit(X, y)``, ``predict``,
``predict_proba``, ``transform``, ``get_params``, ``set_params``);
``workers`` / ``mesh`` run the fit data-parallel through the port's
``ParallelWrapper``. Each estimator builds its network inside ``fit`` from
``conf_factory()`` on ``device`` (the card unless the caller asks for the
CPU); the fitted models hand back host numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import host_array


def _one_hot(y, n):
    y = np.asarray(y)
    if y.ndim == 2:          # already one-hot
        return y.astype(np.float32)
    from deeplearning4j_tpu_torch.data.fetchers import _one_hot as _encode
    return _encode(y.astype(int), n)


class _BaseEstimator:
    """sklearn-protocol plumbing (get_params/set_params over __init__
    kwargs, stored verbatim)."""

    _param_names: tuple = ()

    def get_params(self, deep=True):
        return {k: getattr(self, k) for k in self._param_names}

    def set_params(self, **kw):
        for k, v in kw.items():
            if k not in self._param_names:
                raise ValueError(f"unknown parameter {k!r}")
            setattr(self, k, v)
        return self


class NetworkClassifier(_BaseEstimator):
    """Estimator over a configuration factory (parity:
    SparkDl4jNetwork(conf, numLabels, trainingMaster, epochs)).

    ``conf_factory``: () -> MultiLayerConfiguration (a factory, not a conf:
    refitting must start from fresh parameters, and sklearn clones
    estimators by get_params/set_params). ``workers``/``mesh`` route
    training through ParallelWrapper (the TrainingMaster role)."""

    _param_names = ("conf_factory", "epochs", "batch_size", "workers",
                    "mesh", "device")

    def __init__(self, conf_factory: Callable, epochs: int = 1,
                 batch_size: int = 128, workers: Optional[int] = None,
                 mesh=None, device=None):
        self.conf_factory = conf_factory
        self.epochs = epochs
        self.batch_size = batch_size
        self.workers = workers
        self.mesh = mesh
        self.device = device

    def fit(self, X, y):
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

        net = MultiLayerNetwork(self.conf_factory(),
                                device=self.device).init()
        n_out = net.layers[-1].n_out
        ds = DataSet(np.asarray(X, np.float32), _one_hot(y, n_out))
        it = ListDataSetIterator(ds, self.batch_size, shuffle=True)
        if self.workers is not None or self.mesh is not None:
            from deeplearning4j_tpu_torch.parallel.wrapper import \
                ParallelWrapper
            ParallelWrapper(net, workers=self.workers,
                            mesh=self.mesh).fit(it, epochs=self.epochs)
        else:
            net.fit(it, epochs=self.epochs)
        self.model_ = NetworkModel(net)
        return self.model_

    # sklearn-style convenience: estimator.fit(...).predict(...) works on
    # the returned model; these delegate after fit for pipeline use
    def predict(self, X):
        return self.model_.predict(X)

    def predict_proba(self, X):
        return self.model_.predict_proba(X)

    def transform(self, X):
        return self.model_.transform(X)

    def score(self, X, y):
        return self.model_.score(X, y)


class NetworkModel:
    """Fitted model (parity: SparkDl4jModel — ``output``/``predict``)."""

    def __init__(self, network):
        self.network = network

    def predict_proba(self, X):
        return host_array(self.network.output(np.asarray(X, np.float32)))

    def predict(self, X):
        return self.predict_proba(X).argmax(axis=-1)

    # a classifier's pipeline-transform output is its class distribution
    transform = predict_proba

    def score(self, X, y):
        y = np.asarray(y)
        if y.ndim == 2:
            y = y.argmax(-1)
        return float((self.predict(X) == y).mean())

    def save(self, path):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(self.network, path)

    @staticmethod
    def load(path, device=None):
        from deeplearning4j_tpu_torch.util.model_serializer import \
            guess_model
        return NetworkModel(guess_model(path, device=device))


class AutoEncoderEstimator(_BaseEstimator):
    """Unsupervised estimator (parity: AutoEncoder.scala — fit on raw
    vectors, targets = inputs; the model's ``transform`` returns the
    COMPRESSED layer's activations, AutoEncoderModel.udfTransformer)."""

    _param_names = ("conf_factory", "compressed_layer", "epochs",
                    "batch_size", "workers", "mesh", "device")

    def __init__(self, conf_factory: Callable, compressed_layer: int,
                 epochs: int = 1, batch_size: int = 128,
                 workers: Optional[int] = None, mesh=None, device=None):
        self.conf_factory = conf_factory
        self.compressed_layer = compressed_layer
        self.epochs = epochs
        self.batch_size = batch_size
        self.workers = workers
        self.mesh = mesh
        self.device = device

    def fit(self, X, y=None):
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator

        X = np.asarray(X, np.float32)
        net = MultiLayerNetwork(self.conf_factory(),
                                device=self.device).init()
        it = ListDataSetIterator(DataSet(X, X.copy()), self.batch_size,
                                 shuffle=True)
        if self.workers is not None or self.mesh is not None:
            from deeplearning4j_tpu_torch.parallel.wrapper import \
                ParallelWrapper
            ParallelWrapper(net, workers=self.workers,
                            mesh=self.mesh).fit(it, epochs=self.epochs)
        else:
            net.fit(it, epochs=self.epochs)
        self.model_ = AutoEncoderModel(net, self.compressed_layer)
        return self.model_

    def transform(self, X):
        return self.model_.transform(X)


class AutoEncoderModel:
    def __init__(self, network, compressed_layer: int):
        self.network = network
        self.compressed_layer = compressed_layer

    def transform(self, X):
        """Activations at the compressed layer (the encoding)."""
        acts = self.network.feed_forward(np.asarray(X, np.float32))
        return host_array(acts[self.compressed_layer + 1])


class Pipeline:
    """Minimal chained transform pipeline (each stage: fit returns a model
    with ``transform``; the last stage may be a classifier). Provided so
    the facade is self-contained; the estimators are equally at home in
    sklearn.pipeline.Pipeline."""

    def __init__(self, steps):
        self.steps = list(steps)

    def fit(self, X, y=None):
        self.models_ = []
        cur = X
        for i, (name, est) in enumerate(self.steps):
            last = i == len(self.steps) - 1
            model = est.fit(cur, y) if last else est.fit(cur)
            self.models_.append((name, model))
            if not last:
                cur = model.transform(cur)
        return self

    def _through(self, X):
        cur = X
        for name, model in self.models_[:-1]:
            cur = model.transform(cur)
        return cur, self.models_[-1][1]

    def predict(self, X):
        cur, last = self._through(X)
        return last.predict(cur)

    def transform(self, X):
        cur, last = self._through(X)
        return last.transform(cur)

    def score(self, X, y):
        cur, last = self._through(X)
        return last.score(cur, y)
