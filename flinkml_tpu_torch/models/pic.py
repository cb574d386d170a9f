"""PowerIterationClustering — clustering from pairwise affinities (the
Spark/Flink family member; an AlgoOperator like the upstream).

The port's counterpart of ``flinkml_tpu.models.pic`` (Lin & Cohen's PIC):
power-iterate ``v <- D⁻¹ A v`` (the row-normalized affinity matrix) from a
degree-seeded start; the pseudo-eigenvector's entries separate by cluster
long before convergence, and a 1-D k-means over them gives the
assignment.

On the device each iteration is ONE ``segment_sum`` kernel launch of
``w_norm · v[dst]`` into the edges' sources (the COO edge list never
becomes a dense ``[n, n]`` affinity), then the L1 normalization, in
float32; the 1-D k-means runs on the host. The kernel adds with atomics,
so on the card an iterate equals the in-order sum within float32
rounding.

Input: a table of ``srcCol``/``dstCol``/``weightCol`` edges (undirected:
each edge is symmetrized). Output: one row per distinct vertex id with its
cluster.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import AlgoOperator
from flinkml_tpu_torch.common_params import HasMaxIter, HasPredictionCol, HasSeed
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.params import IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table


class _PICParams(HasMaxIter, HasPredictionCol, HasSeed):
    SRC_COL = StringParam("srcCol", "Edge source vertex id column.", "src")
    DST_COL = StringParam("dstCol", "Edge destination vertex id column.", "dst")
    WEIGHT_COL = StringParam(
        "weightCol", "Edge affinity column (empty = 1.0).", None
    )
    K = IntParam("k", "Number of clusters.", 2, ParamValidators.gt(1))


def power_iteration(src: torch.Tensor, dst: torch.Tensor,
                    w_norm: torch.Tensor, v0: torch.Tensor,
                    n_iter: int) -> torch.Tensor:
    """``n_iter`` steps of ``v <- segment_sum(w_norm · v[dst], src) /
    max(‖·‖₁, 1e-30)`` on the tensors' device (``src`` int32)."""
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    n = v0.shape[0]
    dst = dst.long()
    floor = torch.tensor(1e-30, dtype=v0.dtype, device=v0.device)
    v = v0
    for _ in range(int(n_iter)):
        v = segment_sum(w_norm * v[dst], src, n)
        v = v / torch.maximum(torch.sum(torch.abs(v)), floor)
    return v


def _kmeans_1d(values: np.ndarray, k: int, rng: np.random.Generator,
               iters: int = 50) -> np.ndarray:
    """Tiny exact-assignment 1-D Lloyd (quantile-seeded)."""
    lo, hi = float(values.min()), float(values.max())
    if hi - lo <= 1e-30:
        # A constant embedding: nothing to separate, one cluster.
        return np.zeros(len(values), dtype=np.int64)
    centers = np.unique(np.quantile(values, np.linspace(0, 1, 2 * k + 1)[1::2]))
    while len(centers) < k:
        centers = np.unique(np.append(centers, rng.uniform(lo, hi)))
    for _ in range(iters):
        mids = (centers[:-1] + centers[1:]) / 2.0
        assign = np.searchsorted(mids, values)
        sums = np.bincount(assign, weights=values, minlength=len(centers))
        counts = np.bincount(assign, minlength=len(centers))
        new = np.where(counts > 0, sums / np.maximum(counts, 1), centers)
        if np.allclose(new, centers):
            break
        centers = np.sort(new)
    mids = (centers[:-1] + centers[1:]) / 2.0
    return np.searchsorted(mids, values)


def pic_inputs(table_src, table_dst, w, k: int, seed: int):
    """The host preparation: vertex ids, symmetrized int32 edges, the
    row-normalized float32 weights, the seeded float32 start and the
    generator (carried on to the 1-D k-means)."""
    if (w < 0).any():
        raise ValueError("affinities must be non-negative")
    vertex_ids, idx = np.unique(
        np.concatenate([table_src, table_dst]), return_inverse=True
    )
    n = len(vertex_ids)
    if n < k:
        raise ValueError(f"{n} vertices < k={k}")
    src = idx[: len(table_src)].astype(np.int32)
    dst = idx[len(table_src):].astype(np.int32)
    src_s = np.concatenate([src, dst])
    dst_s = np.concatenate([dst, src])
    w_s = np.concatenate([w, w]).astype(np.float64)
    degree = np.zeros(n)
    np.add.at(degree, src_s, w_s)
    if (degree <= 0).any():
        raise ValueError("every vertex needs positive total affinity")
    w_norm = (w_s / degree[src_s]).astype(np.float32)
    rng = np.random.default_rng(seed)
    # Degree-seeded start plus seeded jitter: exactly symmetric
    # components would otherwise get identical entries.
    v0 = degree / degree.sum()
    v0 = (v0 * (1.0 + 0.01 * rng.standard_normal(n))).astype(np.float32)
    return vertex_ids, src_s, dst_s, w_norm, v0, rng


class PowerIterationClustering(_PICParams, AlgoOperator):
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        src_raw = np.asarray(table.column(self.get(self.SRC_COL)))
        dst_raw = np.asarray(table.column(self.get(self.DST_COL)))
        weight_col = self.get(self.WEIGHT_COL)
        w = (
            np.asarray(table.column(weight_col), np.float64)
            if weight_col else np.ones(len(src_raw))
        )
        k = self.get(self.K)
        vertex_ids, src_s, dst_s, w_norm, v0, rng = pic_inputs(
            src_raw, dst_raw, w, k, self.get_seed())
        device = default_device()
        up = lambda a: torch.from_numpy(a).to(device)
        v = power_iteration(up(src_s), up(dst_s), up(w_norm), up(v0),
                            self.get(self.MAX_ITER))
        labels = _kmeans_1d(v.cpu().numpy().astype(np.float64), k, rng)
        # First-appearance relabeling for determinism.
        _, first = np.unique(labels, return_index=True)
        lut = np.empty(labels.max() + 1, dtype=np.int64)
        for rank, i in enumerate(np.sort(first)):
            lut[labels[i]] = rank
        labels = lut[labels].astype(np.float64)
        return (
            Table({
                "id": vertex_ids,
                self.get(self.PREDICTION_COL): labels,
            }),
        )
