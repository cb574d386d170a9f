"""MulticlassClassificationEvaluator, RegressionEvaluator,
ClusteringEvaluator.

Members of the wider Flink ML evaluator family (the reference snapshot
has none). All are one-pass reductions over host-resident columns —
except the clustering silhouette, whose O(n·k) distance work runs as one
float32 product on the compute device (the same gemm-shaped step as
KMeans assignment). The port's counterpart of
``flinkml_tpu.models.evaluation_multi``: the metrics stay float64 numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import AlgoOperator
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasWeightCol,
)
from flinkml_tpu_torch.params import StringArrayParam, StringParam
from flinkml_tpu_torch.table import Table


def _weighted(values, w):
    return float(np.sum(values * w) / np.sum(w))


def multiclass_metrics(labels, predictions, weights=None) -> Dict[str, float]:
    """Weighted multiclass metrics from a confusion matrix.

    Per-class precision/recall/F1 aggregate weighted by true-class
    support (the sklearn ``average='weighted'`` convention, matching the
    upstream evaluator's weightedPrecision/weightedRecall/weightedF1).
    """
    y = np.asarray(labels, dtype=np.float64).reshape(-1)
    p = np.asarray(predictions, dtype=np.float64).reshape(-1)
    w = (np.ones_like(y) if weights is None
         else np.asarray(weights, dtype=np.float64).reshape(-1))
    if y.shape != p.shape or y.shape != w.shape:
        raise ValueError("labels/predictions/weights lengths differ")
    if not (np.isfinite(y).all() and np.isfinite(p).all()):
        raise ValueError(
            "labels/predictions contain NaN/inf (drop cold-start NaN "
            "predictions before evaluating)"
        )
    classes, inv = np.unique(np.concatenate([y, p]), return_inverse=True)
    k = len(classes)
    yi, pi = inv[: len(y)], inv[len(y):]
    # Weighted confusion matrix via bincount on flattened (true, pred).
    conf = np.bincount(yi * k + pi, weights=w, minlength=k * k).reshape(k, k)
    support = conf.sum(axis=1)              # weighted rows per true class
    predicted = conf.sum(axis=0)
    tp = np.diag(conf)
    total = conf.sum()
    accuracy = float(tp.sum() / total)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(predicted > 0, tp / predicted, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(
            precision + recall > 0,
            2 * precision * recall / (precision + recall),
            0.0,
        )
    sw = support / total
    return {
        "accuracy": accuracy,
        "weightedPrecision": float(np.sum(precision * sw)),
        "weightedRecall": float(np.sum(recall * sw)),
        "weightedF1": float(np.sum(f1 * sw)),
    }


_MULTI_SUPPORTED = (
    "accuracy", "weightedPrecision", "weightedRecall", "weightedF1",
)


class MulticlassClassificationEvaluator(
    HasLabelCol, HasPredictionCol, HasWeightCol, AlgoOperator
):
    METRICS_NAMES = StringArrayParam(
        "metricsNames", "Names of the output metrics.",
        ["accuracy", "weightedF1"],
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        names = self.get(self.METRICS_NAMES)
        unknown = [n for n in names if n not in _MULTI_SUPPORTED]
        if unknown:
            raise ValueError(
                f"unsupported metrics {unknown}; supported: "
                f"{list(_MULTI_SUPPORTED)}"
            )
        weight_col = self.get(self.WEIGHT_COL)
        metrics = multiclass_metrics(
            table.column(self.get(self.LABEL_COL)),
            table.column(self.get(self.PREDICTION_COL)),
            table.column(weight_col) if weight_col else None,
        )
        return (Table({n: np.asarray([metrics[n]]) for n in names}),)


def regression_metrics(labels, predictions, weights=None) -> Dict[str, float]:
    y = np.asarray(labels, dtype=np.float64).reshape(-1)
    p = np.asarray(predictions, dtype=np.float64).reshape(-1)
    w = (np.ones_like(y) if weights is None
         else np.asarray(weights, dtype=np.float64).reshape(-1))
    if y.shape != p.shape or y.shape != w.shape:
        raise ValueError("labels/predictions/weights lengths differ")
    err = p - y
    mse = _weighted(err * err, w)
    mae = _weighted(np.abs(err), w)
    mean_y = _weighted(y, w)
    ss_tot = float(np.sum(w * (y - mean_y) ** 2))
    ss_res = float(np.sum(w * err * err))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan")
    # sklearn convention: 1 - Var_w(err) / Var_w(y).
    var_y = ss_tot / float(np.sum(w))
    var_err = _weighted((err - _weighted(err, w)) ** 2, w)
    explained = 1.0 - var_err / var_y if var_y > 0 else float("nan")
    return {
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mae": mae,
        "r2": r2,
        "explainedVariance": explained,
    }


_REG_SUPPORTED = ("mse", "rmse", "mae", "r2", "explainedVariance")


class RegressionEvaluator(
    HasLabelCol, HasPredictionCol, HasWeightCol, AlgoOperator
):
    METRICS_NAMES = StringArrayParam(
        "metricsNames", "Names of the output metrics.", ["rmse", "r2"],
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        names = self.get(self.METRICS_NAMES)
        unknown = [n for n in names if n not in _REG_SUPPORTED]
        if unknown:
            raise ValueError(
                f"unsupported metrics {unknown}; supported: "
                f"{list(_REG_SUPPORTED)}"
            )
        weight_col = self.get(self.WEIGHT_COL)
        metrics = regression_metrics(
            table.column(self.get(self.LABEL_COL)),
            table.column(self.get(self.PREDICTION_COL)),
            table.column(weight_col) if weight_col else None,
        )
        return (Table({n: np.asarray([metrics[n]]) for n in names}),)


def simplified_silhouette(x: np.ndarray, assignment: np.ndarray) -> float:
    """Simplified (centroid-based) silhouette: a(i) = distance to own
    centroid, b(i) = distance to nearest other centroid — the O(n·k)
    form the upstream evaluator uses (exact silhouette is O(n²)).

    The [n, k] distance matrix is one float32 gemm on the compute device
    (same shape as the KMeans assignment step).
    """
    import torch

    from flinkml_tpu_torch.device import default_device
    from flinkml_tpu_torch.ops.blas import squared_distances

    x = np.asarray(x, dtype=np.float64)
    a = np.asarray(assignment)
    clusters, idx = np.unique(a, return_inverse=True)
    k = len(clusters)
    if k < 2:
        raise ValueError("silhouette requires at least 2 clusters")
    if k >= x.shape[0]:
        raise ValueError("silhouette requires n_points > n_clusters")
    cents = np.stack([x[idx == c].mean(axis=0) for c in range(k)])
    device = default_device()
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    d = np.sqrt(np.maximum(
        squared_distances(f32(x), f32(cents)).cpu().numpy()
        .astype(np.float64), 0.0))
    n = x.shape[0]
    own = d[np.arange(n), idx]
    d_other = d.copy()
    d_other[np.arange(n), idx] = np.inf
    nearest_other = d_other.min(axis=1)
    denom = np.maximum(np.maximum(own, nearest_other), 1e-300)
    return float(np.mean((nearest_other - own) / denom))


class ClusteringEvaluator(HasFeaturesCol, HasPredictionCol, AlgoOperator):
    """Simplified silhouette over a features + cluster-assignment table."""

    METRICS_NAMES = StringArrayParam(
        "metricsNames", "Names of the output metrics.", ["silhouette"],
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        names = self.get(self.METRICS_NAMES)
        unknown = [n for n in names if n != "silhouette"]
        if unknown:
            raise ValueError(
                f"unsupported metrics {unknown}; supported: ['silhouette']"
            )
        from flinkml_tpu_torch.models._data import features_matrix

        value = simplified_silhouette(
            features_matrix(table, self.get(self.FEATURES_COL)),
            np.asarray(table.column(self.get(self.PREDICTION_COL))),
        )
        return (Table({"silhouette": np.asarray([value])}),)
