"""IsotonicRegression — weighted monotone regression via pool-adjacent-
violators (the Spark/Flink family member).

The port's copy of ``flinkml_tpu.models.isotonic``: PAV is an inherently
sequential O(n) stack algorithm over sorted rows — host code by nature in
both packages (the sort dominates and numpy's is fine), so the fit and the
predictions are the JAX package's bit for bit. Prediction interpolates linearly
between fitted boundary points and clamps outside the fitted range, the
upstream convention.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasWeightCol,
)
from flinkml_tpu_torch.params import BoolParam
from flinkml_tpu_torch.table import Table


def _feature_column(table: Table, col: str) -> np.ndarray:
    """The single scalar feature as [n] f64 — accepts a 1-D column or the
    repo's standard [n, 1] / Vector object layouts (via features_matrix)."""
    from flinkml_tpu_torch.models._data import features_matrix

    x = features_matrix(table, col)
    if x.shape[1] != 1:
        raise ValueError(
            f"IsotonicRegression takes a single feature, got dim {x.shape[1]}"
        )
    return x[:, 0]


def pav(x: np.ndarray, y: np.ndarray, w: np.ndarray,
        increasing: bool = True):
    """Weighted PAV. Returns (boundaries, values): the stepwise-fit knots
    (x deduplicated by weighted mean within ties, then pooled)."""
    # Zero-weight rows carry no information and would poison the pooled
    # means (sklearn drops them too).
    keep = w > 0
    if not keep.any():
        raise ValueError("all weights are zero")
    x, y, w = x[keep], y[keep], w[keep]
    order = np.argsort(x, kind="stable")
    xs, ys, ws = x[order], y[order], w[order]
    if not increasing:
        ys = -ys
    # Merge duplicate x first (weighted mean), as sklearn/Spark do.
    uniq, start = np.unique(xs, return_index=True)
    stop = np.append(start[1:], len(xs))
    xm, ym, wm = [], [], []
    for s, e in zip(start, stop):
        wt = ws[s:e].sum()
        xm.append(xs[s])
        ym.append(float((ys[s:e] * ws[s:e]).sum() / wt))
        wm.append(float(wt))
    # PAV stack: pool adjacent violators into weighted-mean blocks.
    # Each block is [start_idx, end_idx, mean, weight] over xm indices.
    blocks: List[List[float]] = []
    for i, (yi, wi) in enumerate(zip(ym, wm)):
        blocks.append([i, i, yi, wi])
        while len(blocks) > 1 and blocks[-2][2] >= blocks[-1][2]:
            s2, e2, y2, w2 = blocks.pop()
            s1, e1, y1, w1 = blocks.pop()
            tot = w1 + w2
            blocks.append([s1, e2, (y1 * w1 + y2 * w2) / tot, tot])
    # Emit (start_x, v) and (end_x, v) knots per block: interpolation is
    # flat within blocks and linear between them (the Spark boundary
    # convention).
    boundaries: List[float] = []
    values: List[float] = []
    for s, e, v, _ in blocks:
        boundaries.append(xm[int(s)])
        values.append(v)
        if e > s:
            boundaries.append(xm[int(e)])
            values.append(v)
    bnd = np.asarray(boundaries)
    val = np.asarray(values)
    if not increasing:
        val = -val
    return bnd, val


class _IsotonicParams(
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasWeightCol
):
    ISOTONIC = BoolParam(
        "isotonic", "Fit increasing (true) or decreasing (false).", True
    )


class IsotonicRegression(_IsotonicParams, Estimator):
    def fit(self, *inputs: Table) -> "IsotonicRegressionModel":
        (table,) = inputs
        x = _feature_column(table, self.get(self.FEATURES_COL))
        y = np.asarray(
            table.column(self.get(self.LABEL_COL)), dtype=np.float64
        ).reshape(-1)
        weight_col = self.get(self.WEIGHT_COL)
        w = (
            np.asarray(table.column(weight_col), dtype=np.float64).reshape(-1)
            if weight_col else np.ones_like(y)
        )
        if not (x.shape == y.shape == w.shape):
            raise ValueError("features/label/weight lengths differ")
        bnd, val = pav(x, y, w, self.get(self.ISOTONIC))
        model = IsotonicRegressionModel()
        model.copy_params_from(self)
        model.set_model_data(
            Table({"boundaries": bnd[None, :], "values": val[None, :]})
        )
        return model


class IsotonicRegressionModel(_IsotonicParams, Model):
    def __init__(self):
        super().__init__()
        self._boundaries: Optional[np.ndarray] = None
        self._values: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table) -> "IsotonicRegressionModel":
        (table,) = inputs
        self._boundaries = np.asarray(
            table.column("boundaries"), np.float64
        )[0]
        self._values = np.asarray(table.column("values"), np.float64)[0]
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({
            "boundaries": self._boundaries[None, :],
            "values": self._values[None, :],
        })]

    @property
    def boundaries(self) -> np.ndarray:
        self._require()
        return self._boundaries

    @property
    def values(self) -> np.ndarray:
        self._require()
        return self._values

    def _require(self) -> None:
        if self._boundaries is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        x = _feature_column(table, self.get(self.FEATURES_COL))
        pred = np.interp(x, self._boundaries, self._values)
        return (table.with_column(self.get(self.PREDICTION_COL), pred),)

    def _arrays(self):
        self._require()
        return {"boundaries": self._boundaries, "values": self._values}

    def _set_arrays(self, arrays) -> None:
        self._boundaries = np.asarray(arrays["boundaries"]).reshape(-1)
        self._values = np.asarray(arrays["values"]).reshape(-1)
