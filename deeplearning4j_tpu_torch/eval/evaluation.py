"""Classification, binary, regression and ROC evaluation.

Counterpart of deeplearning4j_tpu/eval/evaluation.py (parity surface: the
reference's eval/Evaluation.java, EvaluationBinary, RegressionEvaluation,
ROC and ROCMultiClass), host numpy on the network's outputs read back:
``Evaluation`` a confusion matrix with accuracy, precision, recall and F1;
``EvaluationBinary`` per-output counts at a threshold;
``RegressionEvaluation`` per-column sums for MSE, MAE, RMSE, R^2 and the
Pearson correlation; ``ROC`` the exact AUC by the rank statistic (ties
averaged) and a thresholded curve; ``ROCMultiClass`` one ROC per class.
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


class EvaluationBinary:
    """Per-output binary metrics for multi-label nets
    (parity: eval/EvaluationBinary.java)."""

    def __init__(self, threshold=0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        preds = (np.asarray(predictions).reshape(labels.shape) >= self.threshold)
        lab = labels >= 0.5
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        self.tp += (preds & lab).sum(0)
        self.fp += (preds & ~lab).sum(0)
        self.tn += (~preds & ~lab).sum(0)
        self.fn += (~preds & lab).sum(0)
        return self

    def accuracy(self, i):
        tot = self.tp[i] + self.fp[i] + self.tn[i] + self.fn[i]
        return float((self.tp[i] + self.tn[i]) / tot) if tot else 0.0

    def precision(self, i):
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i):
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i):
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0


class RegressionEvaluation:
    """Per-column regression metrics (parity: eval/RegressionEvaluation.java)."""

    def __init__(self, column_names=None):
        self.column_names = column_names
        self._n = 0
        self._sum_sq_err = None
        self._sum_abs_err = None
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_label_pred = None
        self._sum_pred_sq = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        preds = np.asarray(predictions, np.float64)
        labels = labels.reshape(-1, labels.shape[-1])
        preds = preds.reshape(-1, preds.shape[-1])
        if self._sum_sq_err is None:
            c = labels.shape[-1]
            for a in ("_sum_sq_err", "_sum_abs_err", "_sum_label",
                      "_sum_label_sq", "_sum_pred", "_sum_label_pred",
                      "_sum_pred_sq"):
                setattr(self, a, np.zeros(c))
        err = preds - labels
        self._n += labels.shape[0]
        self._sum_sq_err += (err ** 2).sum(0)
        self._sum_abs_err += np.abs(err).sum(0)
        self._sum_label += labels.sum(0)
        self._sum_label_sq += (labels ** 2).sum(0)
        self._sum_pred += preds.sum(0)
        self._sum_pred_sq += (preds ** 2).sum(0)
        self._sum_label_pred += (labels * preds).sum(0)
        return self

    def mean_squared_error(self, col=None):
        m = self._sum_sq_err / self._n
        return float(m[col]) if col is not None else float(m.mean())

    def mean_absolute_error(self, col=None):
        m = self._sum_abs_err / self._n
        return float(m[col]) if col is not None else float(m.mean())

    def root_mean_squared_error(self, col=None):
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col=None):
        ss_tot = self._sum_label_sq - self._sum_label ** 2 / self._n
        ss_res = self._sum_sq_err
        with np.errstate(divide="ignore", invalid="ignore"):
            r2 = np.where(ss_tot > 0, 1.0 - ss_res / ss_tot, 0.0)
        return float(r2[col]) if col is not None else float(r2.mean())

    def pearson_correlation(self, col=None):
        n = self._n
        cov = self._sum_label_pred - self._sum_label * self._sum_pred / n
        vl = self._sum_label_sq - self._sum_label ** 2 / n
        vp = self._sum_pred_sq - self._sum_pred ** 2 / n
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where((vl > 0) & (vp > 0), cov / np.sqrt(vl * vp), 0.0)
        return float(r[col]) if col is not None else float(r.mean())

    def stats(self):
        return (f"MSE: {self.mean_squared_error():.6f}  "
                f"MAE: {self.mean_absolute_error():.6f}  "
                f"RMSE: {self.root_mean_squared_error():.6f}  "
                f"R^2: {self.r_squared():.6f}")


class ROC:
    """Binary ROC / AUC (parity: eval/ROC.java). Exact AUC via rank statistic
    rather than the reference's thresholded approximation."""

    def __init__(self):
        self.scores = []
        self.labels = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            labels = labels[..., 1]
            preds = preds[..., 1]
        self.labels.append(labels.reshape(-1))
        self.scores.append(preds.reshape(-1))
        return self

    def calculate_auc(self):
        y = np.concatenate(self.labels) >= 0.5
        s = np.concatenate(self.scores)
        n_pos, n_neg = int(y.sum()), int((~y).sum())
        if n_pos == 0 or n_neg == 0:
            return 0.5
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, len(s) + 1)
        # average ranks for ties
        s_sorted = s[order]
        i = 0
        while i < len(s_sorted):
            j = i
            while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
                j += 1
            if j > i:
                avg = (i + j + 2) / 2.0
                ranks[order[i:j + 1]] = avg
            i = j + 1
        return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))

    def roc_curve(self, steps=100):
        y = np.concatenate(self.labels) >= 0.5
        s = np.concatenate(self.scores)
        thresholds = np.linspace(0, 1, steps + 1)
        tpr, fpr = [], []
        for t in thresholds:
            pred = s >= t
            tp = (pred & y).sum()
            fp = (pred & ~y).sum()
            fn = (~pred & y).sum()
            tn = (~pred & ~y).sum()
            tpr.append(tp / max(tp + fn, 1))
            fpr.append(fp / max(fp + tn, 1))
        return np.array(fpr), np.array(tpr), thresholds


class ROCMultiClass:
    """One-vs-all ROC per class (parity: eval/ROCMultiClass.java)."""

    def __init__(self):
        self._rocs = {}

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        preds = np.asarray(predictions).reshape(labels.shape)
        for c in range(labels.shape[-1]):
            self._rocs.setdefault(c, ROC()).eval(labels[:, c], preds[:, c])
        return self

    def calculate_auc(self, cls):
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self):
        return float(np.mean([r.calculate_auc() for r in self._rocs.values()]))
