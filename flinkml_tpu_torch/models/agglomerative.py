"""AgglomerativeClustering — hierarchical clustering (upstream Flink ML
``AgglomerativeClustering``; an AlgoOperator, no fitted model).

Mechanism: the O(n²) pairwise distance matrix is one host f64 BLAS
gemm (merge order is precision-sensitive — an f32 device gemm flips
near-tied merges, see ``_squared_distance_matrix``); the inherently
sequential merge loop runs vectorized Lance-Williams updates with a
nearest-neighbor array (near-O(n²) total work in the common case).
Linkages: ward (default), complete, average, single; stop by
``numClusters`` (default 2) or ``distanceThreshold``.

Like the upstream operator, output labels are cluster ids in
``[0, k)`` remapped to first-appearance order for determinism.

The port's counterpart of ``flinkml_tpu.models.agglomerative``, the same host numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import AlgoOperator
from flinkml_tpu_torch.common_params import HasFeaturesCol, HasPredictionCol
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.params import FloatParam, IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table

WARD = "ward"
COMPLETE = "complete"
AVERAGE = "average"
SINGLE = "single"


def _squared_distance_matrix(x: np.ndarray) -> np.ndarray:
    """Pairwise SQUARED euclidean distances in float64 (host BLAS gemm).

    Merge ORDER is precision-sensitive: an f32 device gemm flips merges
    between near-tied pairs (fuzzing showed ~10% of random cases diverge
    from sklearn in f32 and none in f64), so exactness beats device
    placement here — agglomerative is a moderate-n method and the host
    f64 gemm is more than fast enough at that scale.
    """
    x = np.asarray(x, dtype=np.float64)
    sq = np.einsum("ij,ij->i", x, x)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.maximum(d2, 0.0, out=d2)
    np.fill_diagonal(d2, 0.0)
    return d2


def agglomerate(
    x: np.ndarray,
    linkage: str = WARD,
    num_clusters: Optional[int] = 2,
    distance_threshold: Optional[float] = None,
) -> np.ndarray:
    """Lance-Williams agglomeration; returns integer labels [n].

    The merge loop maintains a per-row nearest-neighbor array (the
    classic NN-array scheme): each merge costs one O(n) row update plus
    O(n) NN repairs in the common case, keeping total host work near
    O(n²) rather than the naive O(n³) of a full argmin per merge.
    """
    n = x.shape[0]
    if num_clusters is not None and not 1 <= num_clusters <= n:
        raise ValueError(f"numClusters must be in [1, {n}], got {num_clusters}")
    d2 = _squared_distance_matrix(x)
    # Ward works on squared distances internally (sklearn/scipy report the
    # sqrt of the Ward objective); the other linkages use plain distances.
    d = d2 if linkage == WARD else np.sqrt(d2)
    big = np.inf
    np.fill_diagonal(d, big)
    sizes = np.ones(n)
    active = np.ones(n, dtype=bool)
    labels = np.arange(n)
    # Per-row nearest active neighbor.
    nn = np.argmin(d, axis=1)
    nn_dist = d[np.arange(n), nn]
    target = 1 if num_clusters is None else num_clusters
    for _ in range(n - target):
        i = int(np.argmin(nn_dist))
        j = int(nn[i])
        if i > j:
            i, j = j, i
        merge_dist = d[i, j]
        if distance_threshold is not None:
            reported = np.sqrt(merge_dist) if linkage == WARD else merge_dist
            if reported > distance_threshold:
                break
        ni, nj = sizes[i], sizes[j]
        # Lance-Williams update of row/col i to represent i∪j.
        di, dj = d[i], d[j]
        if linkage == SINGLE:
            new = np.minimum(di, dj)
        elif linkage == COMPLETE:
            new = np.maximum(di, dj)
        elif linkage == AVERAGE:
            new = (ni * di + nj * dj) / (ni + nj)
        else:  # ward, on squared distances
            nk = sizes
            new = (
                (ni + nk) * di + (nj + nk) * dj - nk * merge_dist
            ) / (ni + nj + nk)
        new[~active] = big
        new[i] = big
        d[i] = new
        d[:, i] = new
        d[j] = big
        d[:, j] = big
        sizes[i] = ni + nj
        active[j] = False
        labels[labels == j] = i   # rows always point at their active rep
        # NN maintenance: the merged row re-scans; rows whose NN was i or
        # j re-scan (their old NN distance is stale); any other row only
        # needs the cheap "did the new i row get closer?" check.
        nn_dist[j] = big
        nn[i] = int(np.argmin(d[i]))
        nn_dist[i] = d[i, nn[i]]
        stale = active & ((nn == i) | (nn == j))
        stale[i] = False
        for k in np.nonzero(stale)[0]:
            nn[k] = int(np.argmin(d[k]))
            nn_dist[k] = d[k, nn[k]]
        improved = active & (d[:, i] < nn_dist)
        improved[i] = False
        nn[improved] = i
        nn_dist[improved] = d[improved, i]
    # Remap to first-appearance order.
    _, first_idx = np.unique(labels, return_index=True)
    order = labels[np.sort(first_idx)]
    remap = {c: k for k, c in enumerate(order)}
    return np.asarray([remap[c] for c in labels])


class AgglomerativeClustering(HasFeaturesCol, HasPredictionCol, AlgoOperator):
    LINKAGE = StringParam(
        "linkage", "Cluster-merge criterion.", WARD,
        ParamValidators.in_array([WARD, COMPLETE, AVERAGE, SINGLE]),
    )
    NUM_CLUSTERS = IntParam(
        "numClusters", "Target number of clusters.", 2, ParamValidators.gt(0)
    )
    DISTANCE_THRESHOLD = FloatParam(
        "distanceThreshold",
        "Stop merging above this linkage distance (overrides numClusters; "
        "set None to return to numClusters mode).",
        None, lambda v: v is None or v > 0.0,
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        x = features_matrix(table, self.get(self.FEATURES_COL))
        threshold = self.get(self.DISTANCE_THRESHOLD)
        num_clusters = None if threshold is not None else self.get(self.NUM_CLUSTERS)
        labels = agglomerate(
            x, self.get(self.LINKAGE), num_clusters, threshold
        )
        return (
            table.with_column(
                self.get(self.PREDICTION_COL), labels.astype(np.float64)
            ),
        )
