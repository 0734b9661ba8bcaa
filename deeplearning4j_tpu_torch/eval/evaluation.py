"""Classification evaluation.

Counterpart of the ``Evaluation`` class of deeplearning4j_tpu/eval/
evaluation.py (parity surface: eval/Evaluation.java): a confusion matrix
accumulated on the host with numpy, and accuracy, precision, recall and F1
read from it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Evaluation:
    """Multi-class classification metrics."""

    def __init__(self, num_classes: Optional[int] = None, labels=None):
        self.num_classes = num_classes
        self.label_names = labels
        self.confusion: Optional[np.ndarray] = None

    def _ensure(self, n):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes),
                                      np.int64)

    def eval(self, labels, predictions, mask=None):
        """labels/predictions: (B, C) one-hot/probs, or (B, T, C) time series
        (flattened, rows where the mask is 0 dropped)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            B, T, C = labels.shape
            labels = labels.reshape(B * T, C)
            predictions = predictions.reshape(B * T, C)
            if mask is not None:
                m = np.asarray(mask).reshape(B * T) > 0
                labels, predictions = labels[m], predictions[m]
        self._ensure(labels.shape[-1])
        np.add.at(self.confusion, (labels.argmax(-1), predictions.argmax(-1)),
                  1)
        return self

    # ---- metrics ----------------------------------------------------------
    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def accuracy(self):
        tot = self.confusion.sum()
        return float(self._tp().sum() / tot) if tot else 0.0

    def _per_class(self, totals, cls):
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(totals > 0, self._tp() / totals, 0.0)
        if cls is not None:
            return float(per[cls])
        return float(per[totals > 0].mean() if (totals > 0).any() else 0.0)

    def precision(self, cls=None):
        return self._per_class(self.confusion.sum(axis=0).astype(np.float64),
                               cls)

    def recall(self, cls=None):
        return self._per_class(self.confusion.sum(axis=1).astype(np.float64),
                               cls)

    def f1(self, cls=None):
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def false_positive_rate(self, cls):
        c = self.confusion
        fp = c[:, cls].sum() - c[cls, cls]
        tn = c.sum() - c[cls].sum() - c[:, cls].sum() + c[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def matthews_correlation(self, cls):
        c = self.confusion
        tp = c[cls, cls]
        fp = c[:, cls].sum() - tp
        fn = c[cls].sum() - tp
        tn = c.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def stats(self):
        return "\n".join([
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
            str(self.confusion),
            "==================================================================",
        ])

    def merge(self, other: "Evaluation"):
        if self.confusion is None:
            self.confusion = other.confusion.copy()
            self.num_classes = other.num_classes
        else:
            self.confusion += other.confusion
        return self
