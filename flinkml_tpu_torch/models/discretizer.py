"""KBinsDiscretizer — fit bin edges per feature, transform to bin ids.

The port's counterpart of ``flinkml_tpu.models.discretizer`` (the wider
Flink ML family's ``KBinsDiscretizer``), host numpy as the JAX package's.
Strategies:

  - ``uniform``: equal-width bins between each feature's min and max;
  - ``quantile``: per-feature quantile edges (duplicates collapse, so a
    feature with few distinct values just gets fewer bins);
  - ``kmeans``: 1-D Lloyd per feature (sorted-quantile init, edges at
    midpoints between adjacent centroids — the sklearn convention).

The fitted model transforms like a Bucketizer whose splits were learned:
``bin = #{edges < x}`` per feature, values clipped into
``[0, numBins-1]`` (out-of-range data goes to the edge bins, matching
the upstream/sklearn clip behavior). Fit statistics are vectorized host
passes — quantiles and 1-D k-means over host-resident columns don't
benefit from a device round-trip; the GBT trainer shares this binning
layout on its hot path (``gbt.quantile_bin_edges``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import HasInputCol, HasOutputCol
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.models.gbt import bin_features, quantile_bin_edges
from flinkml_tpu_torch.params import IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table

UNIFORM = "uniform"
QUANTILE = "quantile"
KMEANS = "kmeans"


class _KBinsParams(HasInputCol, HasOutputCol):
    NUM_BINS = IntParam(
        "numBins", "Number of bins per feature.", 5, ParamValidators.gt(1)
    )
    STRATEGY = StringParam(
        "strategy", "How to place the bin edges.", QUANTILE,
        ParamValidators.in_array([UNIFORM, QUANTILE, KMEANS]),
    )


def _kmeans_1d_edges(col: np.ndarray, num_bins: int) -> np.ndarray:
    """1-D Lloyd: init from quantiles of the DISTINCT values (so ties in
    skewed data can never collapse the seed below k — Lloyd can only
    shrink the center count, never grow it), exact assignment via sorted
    midpoints."""
    uniq = np.unique(col)
    k = min(num_bins, len(uniq))
    if k < 2:
        return np.full(0, np.inf)
    centers = np.quantile(uniq, np.linspace(0, 1, 2 * k + 1)[1::2])
    centers = np.unique(centers)
    for _ in range(20):
        mids = (centers[:-1] + centers[1:]) / 2.0
        assign = np.searchsorted(mids, col)
        sums = np.bincount(assign, weights=col, minlength=len(centers))
        counts = np.bincount(assign, minlength=len(centers))
        new = np.where(counts > 0, sums / np.maximum(counts, 1), centers)
        if np.allclose(new, centers):
            centers = new
            break
        centers = np.unique(new)
    return (centers[:-1] + centers[1:]) / 2.0


class KBinsDiscretizer(_KBinsParams, Estimator):
    def fit(self, *inputs: Table) -> "KBinsDiscretizerModel":
        (table,) = inputs
        x = features_matrix(table, self.get(self.INPUT_COL))
        num_bins = self.get(self.NUM_BINS)
        strategy = self.get(self.STRATEGY)
        d = x.shape[1]
        if strategy == QUANTILE:
            # Same binning contract as the GBT trainer's hot path.
            edges = quantile_bin_edges(x, num_bins)
        else:
            edges = np.full((d, num_bins - 1), np.inf)
            for j in range(d):
                col = x[:, j]
                if strategy == UNIFORM:
                    lo, hi = float(col.min()), float(col.max())
                    if hi > lo:
                        e = np.linspace(lo, hi, num_bins + 1)[1:-1]
                    else:
                        e = np.full(0, np.inf)
                else:
                    e = _kmeans_1d_edges(col, num_bins)
                edges[j, : len(e)] = e
        model = KBinsDiscretizerModel()
        model.copy_params_from(self)
        model.set_model_data(Table({"binEdges": edges[None, :, :]}))
        return model


class KBinsDiscretizerModel(_KBinsParams, Model):
    def __init__(self):
        super().__init__()
        self._edges: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table) -> "KBinsDiscretizerModel":
        (table,) = inputs
        self._set_arrays({"binEdges": table.column("binEdges")})
        return self

    def _arrays(self):
        self._require()
        return {"binEdges": self._edges}

    def _set_arrays(self, arrays) -> None:
        e = np.asarray(arrays["binEdges"], np.float64)
        self._edges = e[0] if e.ndim == 3 else e

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({"binEdges": self._edges[None, :, :]})]

    @property
    def bin_edges(self) -> np.ndarray:
        self._require()
        return self._edges

    def _require(self) -> None:
        if self._edges is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        x = features_matrix(table, self.get(self.INPUT_COL))
        if x.shape[1] != self._edges.shape[0]:
            raise ValueError(
                f"model was fit on {self._edges.shape[0]} features, "
                f"got {x.shape[1]}"
            )
        out = bin_features(x, self._edges).astype(np.float64)
        return (table.with_column(self.get(self.OUTPUT_COL), out),)
