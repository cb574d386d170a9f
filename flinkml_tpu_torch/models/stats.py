"""Correlation — Pearson / Spearman correlation matrix of a features
column (the Spark/Flink ``Correlation`` stat operator).

The port's counterpart of ``flinkml_tpu.models.stats``: Pearson is the
normalized covariance from PCA's gram pass on the compute device
(:func:`flinkml_tpu_torch.models.pca.mean_and_gram`, one ``all_reduce``
on a mesh); Spearman is Pearson over per-column average ranks, ranked on
the host (ties get average ranks, the scipy convention).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from flinkml_tpu_torch.api import AlgoOperator
from flinkml_tpu_torch.common_params import HasFeaturesCol
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.models.pca import mean_and_gram, shard_with_mask
from flinkml_tpu_torch.params import ParamValidators, StringParam
from flinkml_tpu_torch.parallel.mesh import DeviceMesh, check_mesh
from flinkml_tpu_torch.table import Table

PEARSON = "pearson"
SPEARMAN = "spearman"


def _average_ranks(col: np.ndarray) -> np.ndarray:
    """1-based average ranks with ties averaged (scipy ``rankdata``)."""
    order = np.argsort(col, kind="stable")
    sorted_col = col[order]
    boundaries = np.concatenate(
        [[True], sorted_col[1:] != sorted_col[:-1]]
    )
    group = np.cumsum(boundaries) - 1
    start = np.nonzero(boundaries)[0]
    stop = np.append(start[1:], len(col))
    avg = (start + stop - 1) / 2.0 + 1.0
    ranks = np.empty(len(col))
    ranks[order] = avg[group]
    return ranks


def correlation_matrix(
    x: np.ndarray, method: str = PEARSON, mesh: DeviceMesh = None
) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if method == SPEARMAN:
        x = np.stack([_average_ranks(x[:, j]) for j in range(x.shape[1])],
                     axis=1)
    mesh = mesh or DeviceMesh()
    xd, wd = shard_with_mask(x, mesh)
    cnt, s, g = mean_and_gram(mesh, xd, wd, np.asarray(x[0], np.float32))
    mean_c = s / cnt
    cov = g / cnt - np.outer(mean_c, mean_c)
    std = np.sqrt(np.maximum(np.diag(cov), 0.0))
    safe = np.where(std > 0, std, 1.0)
    corr = cov / np.outer(safe, safe)
    # Constant columns correlate NaN with everything but 1 with themselves.
    const = std == 0
    corr[const, :] = np.nan
    corr[:, const] = np.nan
    np.fill_diagonal(corr, 1.0)
    return np.clip(corr, -1.0, 1.0, out=corr)


class Correlation(HasFeaturesCol, AlgoOperator):
    METHOD = StringParam(
        "method", "Correlation method.", PEARSON,
        ParamValidators.in_array([PEARSON, SPEARMAN]),
    )

    def __init__(self, mesh: DeviceMesh = None):
        check_mesh(mesh)
        super().__init__()
        self.mesh = mesh

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        x = features_matrix(table, self.get(self.FEATURES_COL))
        corr = correlation_matrix(x, self.get(self.METHOD), self.mesh)
        return (Table({"corr": corr[None, :, :]}),)
