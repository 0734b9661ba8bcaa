"""EvaluationCalibration: classifier calibration analysis.

Counterpart of deeplearning4j_tpu/eval/calibration.py. Parity surface:
the reference's eval/EvaluationCalibration.java:
- per-class reliability diagrams (positive fraction vs mean predicted
  probability per bin, :114-187 / getReliabilityDiagram :307),
- label / predicted-class count distributions (:343/:351),
- residual plots |label - p| overall and per label class (:362/:377),
- probability histograms overall and per label class (:388/:401),
all mask-aware (per-example column mask or per-output mask) and
time-series-capable (rank-3 inputs are flattened with the mask, the
evalTimeSeries path).

Accumulation is vectorized numpy on the host, on the network's outputs
read back from the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

DEFAULT_RELIABILITY_DIAG_NUM_BINS = 10
DEFAULT_HISTOGRAM_NUM_BINS = 50


@dataclass
class ReliabilityDiagram:
    """One class's reliability curve (parity: curves/ReliabilityDiagram)."""
    title: str
    mean_predicted_value: np.ndarray    # (bins,) average p in each bin
    fraction_positives: np.ndarray      # (bins,) empirical positive fraction


@dataclass
class Histogram:
    """Fixed-range histogram (parity: curves/Histogram)."""
    title: str
    lower: float
    upper: float
    bin_counts: np.ndarray


class EvaluationCalibration:
    """Parity: eval/EvaluationCalibration.java:41."""

    def __init__(self,
                 reliability_num_bins: int = DEFAULT_RELIABILITY_DIAG_NUM_BINS,
                 histogram_num_bins: int = DEFAULT_HISTOGRAM_NUM_BINS):
        self.reliability_num_bins = reliability_num_bins
        self.histogram_num_bins = histogram_num_bins
        self._n = None          # num classes; arrays allocated on first eval
        self.reset()

    def reset(self):
        self._n = None
        self.rdiag_pos_count = None          # (rbins, C)
        self.rdiag_total_count = None        # (rbins, C)
        self.rdiag_sum_predictions = None    # (rbins, C)
        self.label_counts = None             # (C,)
        self.prediction_counts = None        # (C,)
        self.residual_overall = None         # (hbins,)
        self.residual_by_class = None        # (hbins, C)
        self.prob_overall = None             # (hbins,)
        self.prob_by_class = None            # (hbins, C)
        return self

    def _ensure(self, n):
        if self._n is not None:
            if n != self._n:
                raise ValueError(f"num classes changed: {self._n} -> {n}")
            return
        self._n = n
        rb, hb = self.reliability_num_bins, self.histogram_num_bins
        self.rdiag_pos_count = np.zeros((rb, n))
        self.rdiag_total_count = np.zeros((rb, n))
        self.rdiag_sum_predictions = np.zeros((rb, n))
        self.label_counts = np.zeros(n)
        self.prediction_counts = np.zeros(n)
        self.residual_overall = np.zeros(hb)
        self.residual_by_class = np.zeros((hb, n))
        self.prob_overall = np.zeros(hb)
        self.prob_by_class = np.zeros((hb, n))

    # ------------------------------------------------------------------ eval
    def eval(self, labels, predictions, mask=None):
        """labels/predictions: (B, C) or (B, T, C); mask: per-example (B,) /
        (B, T) for time series, or per-output (same shape as labels)."""
        l = np.asarray(labels, np.float64)
        p = np.asarray(predictions, np.float64)
        if l.ndim == 3:
            B, T, C = l.shape
            l = l.reshape(B * T, C)
            p = p.reshape(B * T, C)
            if mask is not None:
                mask = np.asarray(mask)
                # per-output (B,T,C) masks keep the class axis; per-example
                # (B,T) masks flatten to one weight per timestep
                mask = (mask.reshape(B * T, C) if mask.ndim == 3
                        else mask.reshape(-1))
        self._ensure(l.shape[-1])

        # normalize mask to a per-output (B, C) weight matrix
        if mask is None:
            w = np.ones_like(l)
        else:
            m = np.asarray(mask, np.float64)
            w = (np.broadcast_to(m[:, None], l.shape).copy()
                 if m.ndim == 1 else m)

        rb = self.reliability_num_bins
        # reliability bins: digitize p into rb bins over [0, 1]; the last
        # bin is closed above (p == 1.0 falls in bin rb-1), the reference's
        # lte(1.0) edge case
        bins = np.minimum((p * rb).astype(np.int64), rb - 1)
        for j in range(rb):
            in_bin = (bins == j) * w
            self.rdiag_total_count[j] += in_bin.sum(axis=0)
            self.rdiag_pos_count[j] += (l * in_bin).sum(axis=0)
            self.rdiag_sum_predictions[j] += (p * in_bin).sum(axis=0)

        ex_w = (w.max(axis=1) > 0)           # rows with any live output
        self.label_counts += (l * w).sum(axis=0)
        # masked-out columns must not win the argmax for a row's predicted
        # class: exclude them (rows with no live column are dropped by ex_w)
        pred_cls = np.where(w > 0, p, -np.inf).argmax(axis=1)
        np.add.at(self.prediction_counts, pred_cls[ex_w], 1)

        # residuals |l - p| and probability histograms over [0, 1]
        hb = self.histogram_num_bins
        resid = np.abs(l - p)
        rbins = np.minimum((resid * hb).astype(np.int64), hb - 1)
        pbins = np.minimum((p * hb).astype(np.int64), hb - 1)
        live = w > 0
        np.add.at(self.residual_overall, rbins[live], 1)
        np.add.at(self.prob_overall, pbins[live], 1)
        # per-label-class: rows whose label is class c contribute their
        # residual/probability for class c
        lab_cls = l.argmax(axis=1)
        # a row only contributes per-class stats when its true-label column
        # is itself live under the per-output mask
        lab_live = np.take_along_axis(w, lab_cls[:, None], axis=1)[:, 0] > 0
        labeled = (l.max(axis=1) > 0) & ex_w & lab_live
        cls = lab_cls[labeled]
        np.add.at(self.residual_by_class,
                  (rbins[labeled, cls], cls), 1)
        np.add.at(self.prob_by_class, (pbins[labeled, cls], cls), 1)
        return self

    # --------------------------------------------------------------- getters
    def num_classes(self):
        return self._n

    def get_reliability_diagram(self, class_idx: int) -> ReliabilityDiagram:
        """Bins with zero count are dropped (reference :307-339)."""
        total = self.rdiag_total_count[:, class_idx]
        keep = total > 0
        mean_p = self.rdiag_sum_predictions[keep, class_idx] / total[keep]
        frac_pos = self.rdiag_pos_count[keep, class_idx] / total[keep]
        return ReliabilityDiagram(
            f"Reliability Diagram: Class {class_idx}", mean_p, frac_pos)

    def get_label_counts_each_class(self):
        return self.label_counts.astype(np.int64)

    def get_prediction_counts_each_class(self):
        return self.prediction_counts.astype(np.int64)

    def get_residual_plot_all_classes(self) -> Histogram:
        return Histogram("Residual Plot - All Predictions and Classes",
                         0.0, 1.0, self.residual_overall.astype(np.int64))

    def get_residual_plot(self, label_class_idx: int) -> Histogram:
        return Histogram(
            f"Residual Plot - Predictions for Label Class {label_class_idx}",
            0.0, 1.0,
            self.residual_by_class[:, label_class_idx].astype(np.int64))

    def get_probability_histogram_all_classes(self) -> Histogram:
        return Histogram("Network Probabilities Histogram - All Predictions "
                         "and Classes", 0.0, 1.0,
                         self.prob_overall.astype(np.int64))

    def get_probability_histogram(self, label_class_idx: int) -> Histogram:
        return Histogram(
            f"Network Probabilities Histogram - P(class {label_class_idx}) - "
            f"Data Labelled Class {label_class_idx}", 0.0, 1.0,
            self.prob_by_class[:, label_class_idx].astype(np.int64))

    # ------------------------------------------------------- merge/summary
    def merge(self, other: "EvaluationCalibration"):
        if other._n is None:
            return self
        if self._n is None:
            self._ensure(other._n)
        for attr in ("rdiag_pos_count", "rdiag_total_count",
                     "rdiag_sum_predictions", "label_counts",
                     "prediction_counts", "residual_overall",
                     "residual_by_class", "prob_overall", "prob_by_class"):
            getattr(self, attr).__iadd__(getattr(other, attr))
        return self

    def expected_calibration_error(self, class_idx: Optional[int] = None):
        """ECE = sum_bins (n_bin/N) * |acc_bin - conf_bin|, a standard
        summary the reference exposes only graphically."""
        if class_idx is None:
            tot = self.rdiag_total_count.sum(axis=1)
            pos = self.rdiag_pos_count.sum(axis=1)
            sp = self.rdiag_sum_predictions.sum(axis=1)
        else:
            tot = self.rdiag_total_count[:, class_idx]
            pos = self.rdiag_pos_count[:, class_idx]
            sp = self.rdiag_sum_predictions[:, class_idx]
        n = tot.sum()
        if n == 0:
            return 0.0
        keep = tot > 0
        return float(np.sum(tot[keep] / n *
                            np.abs(pos[keep] / tot[keep] - sp[keep] / tot[keep])))

    def stats(self):
        lines = ["===================Evaluation Calibration=================",
                 f" # of classes:  {self._n}",
                 f" Reliability bins: {self.reliability_num_bins}, "
                 f"histogram bins: {self.histogram_num_bins}",
                 f" Label counts:      {self.get_label_counts_each_class()}",
                 f" Prediction counts: {self.get_prediction_counts_each_class()}",
                 f" ECE (micro):       {self.expected_calibration_error():.4f}",
                 "=========================================================="]
        return "\n".join(lines)
