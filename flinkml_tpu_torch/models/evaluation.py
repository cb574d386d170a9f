"""BinaryClassificationEvaluator — threshold-curve metrics.

Member of the wider Flink ML operator family (the reference snapshot has
no evaluator; apache/flink-ml's ``BinaryClassificationEvaluator`` defines
the metric set mirrored here): ``areaUnderROC``, ``areaUnderPR``, ``ks``
(max |TPR - FPR|), ``accuracy`` (at the 0.5 threshold), and ``logLoss``
(clipped cross-entropy over probability scores). Weighted rows
supported; ties in the score column are handled exactly (metrics are
computed on the unique-threshold step curve, not per-row).

Computation is a single host-side sort + cumulative sums: evaluation is a
one-pass reduction over one column, so there is no device work to win
with. The port's counterpart of ``flinkml_tpu.models.evaluation``, the
same float64 numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from flinkml_tpu_torch.api import AlgoOperator
from flinkml_tpu_torch.common_params import (
    HasLabelCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasWeightCol,
)
from flinkml_tpu_torch.params import StringArrayParam
from flinkml_tpu_torch.table import Table

_SUPPORTED = ("areaUnderROC", "areaUnderPR", "ks", "accuracy", "logLoss")


def binary_metrics(scores, labels, weights=None, predictions=None) -> dict:
    """Exact weighted binary metrics from scores (higher = more positive).

    ``accuracy`` uses ``predictions`` (0/1 per row) when given — the
    model's own decision rule; otherwise it thresholds ``scores`` at 0.5,
    which is only meaningful for probability scores (NOT for unbounded
    margins like LinearSVC's — pass the prediction column for those).
    """
    s = np.asarray(scores, dtype=np.float64).reshape(-1)
    y = np.asarray(labels, dtype=np.float64).reshape(-1)
    w = (np.ones_like(s) if weights is None
         else np.asarray(weights, dtype=np.float64).reshape(-1))
    if not np.isfinite(s).all():
        raise ValueError("scores contain NaN/inf")
    if not ((y == 0) | (y == 1)).all():
        raise ValueError("labels must be 0/1")
    if s.shape != y.shape or s.shape != w.shape:
        raise ValueError("scores/labels/weights lengths differ")
    pos = float(np.sum(w * y))
    neg = float(np.sum(w * (1.0 - y)))
    if pos == 0 or neg == 0:
        raise ValueError("both classes must be present (weighted)")

    order = np.argsort(-s, kind="stable")
    s_sorted, y_sorted, w_sorted = s[order], y[order], w[order]
    tp = np.cumsum(w_sorted * y_sorted)
    fp = np.cumsum(w_sorted * (1.0 - y_sorted))
    # Unique-threshold boundaries: last row of each tied score group.
    boundary = np.append(s_sorted[1:] != s_sorted[:-1], True)
    tpr = np.concatenate([[0.0], tp[boundary] / pos])
    fpr = np.concatenate([[0.0], fp[boundary] / neg])
    precision = np.concatenate(
        [[1.0], tp[boundary] / np.maximum(tp[boundary] + fp[boundary], 1e-300)]
    )
    recall = tpr

    # np.trapezoid is numpy>=2; numpy 1.x spells it np.trapz.
    _trapezoid = getattr(np, "trapezoid", None) or np.trapz
    auc_roc = float(_trapezoid(tpr, fpr))
    auc_pr = float(_trapezoid(precision, recall))
    ks = float(np.max(np.abs(tpr - fpr)))
    if predictions is not None:
        pred = np.asarray(predictions, dtype=np.float64).reshape(-1)
        if pred.shape != y.shape:
            raise ValueError("predictions/labels lengths differ")
    else:
        pred = (s >= 0.5).astype(np.float64)
    accuracy = float(np.sum(w * (pred == y)) / np.sum(w))
    # logLoss needs probability scores; clip to keep finite on hard 0/1
    # outputs (sklearn's convention). Meaningless for unbounded margins —
    # same caveat as the 0.5-threshold accuracy above.
    p_clip = np.clip(s, 1e-15, 1 - 1e-15)
    log_loss = float(
        -np.sum(w * (y * np.log(p_clip) + (1 - y) * np.log1p(-p_clip)))
        / np.sum(w)
    )
    return {
        "areaUnderROC": auc_roc,
        "areaUnderPR": auc_pr,
        "ks": ks,
        "accuracy": accuracy,
        "logLoss": log_loss,
    }


class BinaryClassificationEvaluator(
    HasLabelCol, HasRawPredictionCol, HasPredictionCol, HasWeightCol,
    AlgoOperator,
):
    METRICS_NAMES = StringArrayParam(
        "metricsNames",
        "Names of the output metrics.",
        ["areaUnderROC", "areaUnderPR"],
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        names = self.get(self.METRICS_NAMES)
        unknown = [n for n in names if n not in _SUPPORTED]
        if unknown:
            raise ValueError(
                f"unsupported metrics {unknown}; supported: {list(_SUPPORTED)}"
            )
        raw = np.asarray(table.column(self.get(self.RAW_PREDICTION_COL)))
        # Accept either a score column [n] or a [n, 2] probability pair
        # (the rawPrediction layout our classifiers emit: [1-p, p]).
        scores = raw[:, 1] if raw.ndim == 2 else raw
        labels = table.column(self.get(self.LABEL_COL))
        weight_col = self.get(self.WEIGHT_COL)
        weights = table.column(weight_col) if weight_col else None
        # Accuracy uses the model's own prediction column when present
        # (required for margin-style scores like LinearSVC's).
        pred_col = self.get(self.PREDICTION_COL)
        predictions = (
            table.column(pred_col) if pred_col in table.column_names else None
        )
        metrics = binary_metrics(scores, labels, weights, predictions)
        return (Table({n: np.asarray([metrics[n]]) for n in names}),)
