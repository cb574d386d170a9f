"""Gradient-boosted trees and random forests (histogram-based):
GBTClassifier, GBTRegressor, RandomForestClassifier, RandomForestRegressor.

The port's counterpart of ``flinkml_tpu.models.gbt``:

  - **Quantile binning** (host, once): each feature to int32 bin ids in
    ``[0, maxBins)`` through per-feature quantile edges; raw thresholds
    come back from the edges, so inference needs no binning.
  - **Level-wise growth with static shapes**: every tree is a complete
    binary tree of depth ``maxDepth`` (heap layout). Each level computes
    every (node, feature, bin) gradient and hessian histogram at once,
    cumulative-sums over bins and picks every node's best split with one
    argmax.
  - **The forest on the device**: JAX builds it in one ``lax.scan``; the
    port runs a Python loop over trees and levels whose every operand
    stays on the compute device (the margins, node ids, histograms, the
    per-tree arrays); the host reads the forest once at the end.
  - **Histograms** (``hist_layout``, the JAX package's
    ``FLINKML_TPU_GBT_HISTOGRAM``; by default the tuning table's
    ``gbt_histogram``, else ``"segment"``): ``"segment"`` sends g and h
    as one ``[n·d, 2]`` payload to the port's ``segment_sum`` kernel into
    ``n_leaves·d·bins`` segments, and the leaf sums as ``[n, 2]`` into
    ``n_leaves`` (one launch a level and one for the leaves, where JAX
    makes two ``segment_sum``s each). The kernel adds with atomics in an
    order that changes from run to run, so it refuses under
    ``torch.use_deterministic_algorithms(True)``. ``"cumsum"``: cells
    sorted once by their static (feature, bin) key
    (:func:`gbt_hist_tables`), each level's ``2^level``-wide one-hot
    expanded g and h reduced with ``chunked_run_totals``, and the leaf
    sums read from the last level's histograms (the JAX package sums the
    rows with ``segment_sum`` in both layouts): no atomics, the same bits
    run to run.
  - **Mesh**: with ``mesh=`` each rank holds its block of rows, and the
    histograms of a level (g and h together) are summed with ONE
    ``all_reduce``, the ``segment`` layout's leaf sums with one more (JAX:
    a ``psum`` of each).
    Each rank draws its rows' subsample or bootstrap weights from the
    tree's key for its ``n_local`` rows, as every JAX shard does.
  - Second-order (XGBoost) gains: ``gain = GL²/(HL+λ) + GR²/(HR+λ) -
    G²/(H+λ)``; leaf value ``-G/(H+λ)``; logistic loss for the classifier
    (base score = training log-odds), squared loss for the regressor
    (base = weighted mean). Boosted trees subsample rows (a float64
    uniform below ``subsample``); random forests weight rows by Poisson
    bootstrap counts and draw a per-tree feature subset (a permutation
    prefix), with the JAX package's threefry draws bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasLabelCol,
    HasLearningRate,
    HasPredictionCol,
    HasRawPredictionCol,
    HasSeed,
    HasWeightCol,
)
from flinkml_tpu_torch.models._data import (
    check_binary_labels,
    hashed_feature_matrix,
    labeled_data,
    sparse_features,
)
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.params import FloatParam, IntParam, ParamValidators
from flinkml_tpu_torch.parallel.mesh import DeviceMesh, pad_to_multiple
from flinkml_tpu_torch.table import Table

HIST_LAYOUTS = ("segment", "cumsum")


class _GBTParams(
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasWeightCol,
    HasLearningRate, HasSeed,
):
    NUM_TREES = IntParam(
        "numTrees", "Number of boosting rounds.", 50, ParamValidators.gt(0)
    )
    MAX_DEPTH = IntParam(
        "maxDepth", "Depth of every (complete) tree.", 5,
        ParamValidators.in_range(1, 12),
    )
    MAX_BINS = IntParam(
        "maxBins", "Histogram bins per feature.", 64,
        ParamValidators.in_range(2, 256),
    )
    REG_LAMBDA = FloatParam(
        "regLambda", "L2 regularization on leaf values.", 1.0,
        ParamValidators.gt_eq(0.0),
    )
    SUBSAMPLE = FloatParam(
        "subsample", "Per-tree row sampling fraction.", 1.0,
        ParamValidators.in_range(0.0, 1.0, lower_inclusive=False),
    )
    VALIDATION_FRACTION = FloatParam(
        "validationFraction",
        "Held-out fraction for early stopping: the forest is truncated "
        "to the prefix with the best holdout loss (0 = off; boosted "
        "estimators only).",
        0.0, ParamValidators.in_range(0.0, 0.9),
    )
    NUM_HASH_FEATURES = IntParam(
        "numHashFeatures",
        "Bundle width for SparseVector feature columns: sparse inputs "
        "(one-hot / hashed text) are hash-bundled into this many dense "
        "features before binning, so trees train in O(n x numHashFeatures) "
        "memory regardless of the sparse dimensionality. Dense inputs "
        "ignore it.",
        256, ParamValidators.in_range(2, 1 << 16),
    )


# -- binning ------------------------------------------------------------------

def quantile_bin_edges(x: np.ndarray, max_bins: int) -> np.ndarray:
    """Per-feature interior quantile edges, padded with +inf to a fixed
    ``[d, max_bins - 1]`` (duplicate quantiles collapse, so features with
    few distinct values just use fewer real edges)."""
    n, d = x.shape
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    edges = np.full((d, max_bins - 1), np.inf)
    for j in range(d):
        e = np.unique(np.quantile(x[:, j], qs))
        e = e[np.isfinite(e)]
        edges[j, : len(e)] = e
    return edges


def bin_features(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """bin = #{edges < x} per feature; ``bin <= b  <=>  x <= edges[b]``."""
    n, d = x.shape
    out = np.empty((n, d), dtype=np.int32)
    for j in range(d):
        out[:, j] = np.searchsorted(edges[j], x[:, j], side="left")
    return out


def check_hist_layout(layout: str) -> None:
    if layout not in HIST_LAYOUTS:
        raise ValueError(
            f"hist_layout={layout!r}: expected 'segment' or 'cumsum'"
        )


def resolve_hist_layout(layout: Optional[str] = None) -> str:
    """The in-RAM fit's histogram layout: ``layout`` when given, else the
    tuning table's ``gbt_histogram`` for this thread's device
    (:mod:`flinkml_tpu_torch.autotune`), else ``segment``: the JAX
    package's precedence, the keyword standing for its
    ``FLINKML_TPU_GBT_HISTOGRAM``."""
    if layout is None:
        from flinkml_tpu_torch.autotune import tuned_default

        layout = tuned_default("gbt_histogram", "segment",
                               allowed=HIST_LAYOUTS)
    check_hist_layout(layout)
    return layout


def gbt_hist_tables(b_pad: np.ndarray, p_size: int, n_bins: int):
    """Pack-time tables for the ``cumsum`` histogram layout, the JAX
    package's bit for bit. Per rank block of the padded binned matrix
    ``[n, d]``: flatten the ``n_local·d`` cells row-major, sort ONCE by
    the static key ``feat·n_bins + bin``, and record

    - ``srow [p·cells] int32``: row-in-block of each sorted cell;
    - ``ends [p·max_runs] int32``: inclusive end of each (feat, bin) run,
      padded by repeating the last end (differences to exactly 0);
    - ``cols [p·max_runs] int32``: the run's static key, ascending.
    """
    from flinkml_tpu_torch.ops.sparse import run_boundary_tables

    n, d = b_pad.shape
    n_local = n // p_size
    cells = n_local * d
    srow = np.empty((p_size, cells), np.int32)
    skeys = np.empty((p_size, cells), np.int64)
    for dev in range(p_size):
        shard = b_pad[dev * n_local:(dev + 1) * n_local]
        key = (np.arange(d, dtype=np.int64)[None, :] * n_bins
               + shard).reshape(-1)
        order = np.argsort(key, kind="stable")
        srow[dev] = (order // d).astype(np.int32)
        skeys[dev] = key[order]
    ends, cols = run_boundary_tables(skeys)
    return srow.reshape(-1), ends.reshape(-1), cols.reshape(-1)


def sharded_hist_args(b_pad: np.ndarray, mesh: DeviceMesh, n_bins: int,
                      hist_layout: str) -> tuple:
    """This rank's blocks of the ``cumsum`` layout's tables
    (``srow``, ``ends``, ``cols``) on its device; empty for ``segment``."""
    if hist_layout != "cumsum":
        return ()
    srow, ends, cols = gbt_hist_tables(b_pad, mesh.axis_size(), n_bins)
    return (mesh.shard_batch(srow), mesh.shard_batch(ends),
            mesh.shard_batch(cols))


# -- the device forest builder --------------------------------------------------

def _all_reduce(mesh: Optional[DeviceMesh], t: torch.Tensor) -> torch.Tensor:
    if mesh is not None and mesh.group(DeviceMesh.DATA_AXIS) is not None:
        from flinkml_tpu_torch.parallel.collectives import all_reduce_

        all_reduce_(mesh, t)
    return t


def grad_hess(pred, y, w, logistic: bool):
    """Per-row (g, h) of the loss at the float32 margins ``pred``."""
    if logistic:
        p = torch.sigmoid(pred)
        return (p - y) * w, torch.clamp_min(p * (1 - p), 1e-6) * w
    return (pred - y) * w, w


def level_hists_segment(binned, gh, node, n_feat: int, n_bins: int,
                        n_leaves: int) -> torch.Tensor:
    """``[n_leaves, n_feat, n_bins, 2]`` histograms of g and h (this
    rank's rows): ONE ``segment_sum`` of the ``[n·d, 2]`` payload into the
    uniform segment space ``n_leaves·d·bins``."""
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    feat_ids = torch.arange(n_feat, dtype=torch.int32, device=binned.device)
    ids = ((node[:, None] * n_feat + feat_ids[None, :]) * n_bins
           + binned).reshape(-1)
    payload = gh.repeat_interleave(n_feat, dim=0)
    out = segment_sum(payload, ids, n_leaves * n_feat * n_bins)
    return out.reshape(n_leaves, n_feat, n_bins, 2)


def level_hists_cumsum(gh, node, level: int, tables, n_feat: int,
                       n_bins: int, n_leaves: int) -> torch.Tensor:
    """The sort-free histograms (this rank's rows): gather g, h and node
    by the pack-time cell order, expand by a ``2^level``-wide node
    one-hot, reduce the g and h columns in ONE ``chunked_run_totals`` at
    the static (feat, bin) run ends, scatter the runs to their keys."""
    from flinkml_tpu_torch.ops.sparse import chunked_run_totals

    srow, ends, cols = tables
    width = 1 << level
    srow_l = srow.long()
    oh = torch.nn.functional.one_hot(node[srow_l].long(), width).to(gh.dtype)
    both = torch.cat([gh[srow_l, 0:1] * oh, gh[srow_l, 1:2] * oh], dim=1)
    t2 = chunked_run_totals(both, ends)                  # [runs, 2*width]
    fb = torch.zeros((n_feat * n_bins, 2 * width), dtype=gh.dtype,
                     device=gh.device)
    # Ascending keys; the padding runs add exactly 0 onto the last one.
    fb.index_add_(0, cols.long(), t2)
    full = torch.zeros((n_leaves, n_feat, n_bins, 2), dtype=gh.dtype,
                       device=gh.device)
    fb = fb.reshape(n_feat, n_bins, 2, width)
    full[:width] = fb.permute(3, 0, 1, 2)
    return full


def best_splits(hist: torch.Tensor, lam: torch.Tensor, fmask: torch.Tensor):
    """Every node's split from the summed ``[L, d, bins, 2]`` histograms,
    the JAX builder's rule: cumulative sums over bins, the XGBoost gain, a
    gain of 0 where one side is empty and for the last bin, ``-inf`` for
    features outside the tree's subset, the first maximum.
    Returns ``(feature, bin, gain)``, each ``[L]``."""
    n_leaves, n_feat, n_bins, _ = hist.shape
    gl = torch.cumsum(hist[..., 0], dim=2)
    hl = torch.cumsum(hist[..., 1], dim=2)
    gt, ht = gl[:, :, -1:], hl[:, :, -1:]
    gr, hr = gt - gl, ht - hl
    gain = (gl * gl / (hl + lam) + gr * gr / (hr + lam)
            - gt * gt / (ht + lam))
    zero = torch.zeros((), dtype=gain.dtype, device=gain.device)
    gain = torch.where((hl > 0) & (hr > 0), gain, zero)
    gain[:, :, -1] = 0.0
    gain = torch.where(fmask[None, :, None] > 0, gain,
                       torch.full((), -float("inf"), dtype=gain.dtype,
                                  device=gain.device))
    flat = gain.reshape(n_leaves, n_feat * n_bins)
    best = torch.argmax(flat, dim=1)
    best_gain = torch.clamp_min(torch.amax(flat, dim=1), 0.0)
    return ((best // n_bins).to(torch.int32), (best % n_bins).to(torch.int32),
            best_gain)


def advance(binned, node, bf, bb):
    """Each row's node one level down: right when its bin exceeds the
    node's split bin."""
    nl = node.long()
    sample_bin = torch.gather(binned, 1, bf[nl].long()[:, None])[:, 0]
    return node * 2 + (sample_bin > bb[nl]).to(torch.int32)


def tree_weights(key, n_local: int, subsample: float, boosting: bool,
                 n_feat: int, feat_subset: int, device):
    """One tree's row weights and feature mask, drawn from its key as the
    JAX builder draws them (``k_rows, k_feats = split(tree_key)``):
    boosting, a float64 uniform below ``subsample`` (all ones at 1.0,
    where every draw is below); bagging, Poisson(``subsample``) bootstrap
    counts; the feature mask, the first ``feat_subset`` entries of a
    permutation (all ones for 0)."""
    from flinkml_tpu_torch.ops import threefry

    k_rows, k_feats = threefry.split(key)
    if boosting:
        if subsample >= 1.0:
            mask = torch.ones(n_local, dtype=torch.float32, device=device)
        else:
            u = threefry.uniform(k_rows, (n_local,), dtype=torch.float64)
            mask = (u < float(np.float32(subsample))).to(torch.float32)
    else:
        mask = threefry.poisson(k_rows, subsample, (n_local,)).to(
            torch.float32)
    fmask = torch.ones(n_feat, dtype=torch.float32, device=device)
    if feat_subset:
        perm = threefry.permutation(k_feats, n_feat)
        fmask = torch.zeros(n_feat, dtype=torch.float32, device=device)
        fmask[perm[:feat_subset]] = 1.0
    return mask, fmask


def build_forest(binned, y, w, *, base: float, lr: float, lam: float,
                 subsample: float, seed: int, n_feat: int, n_bins: int,
                 depth: int, num_trees: int, logistic: bool,
                 boosting: bool = True, feat_subset: int = 0,
                 hist_layout: Optional[str] = None, hist_tables: tuple = (),
                 mesh: Optional[DeviceMesh] = None):
    """The whole forest on the device from this rank's rows (``binned
    [n_local, d] int32``, ``y``, ``w`` float32 on the compute device).
    Returns host ``(feats [T, n_inner] int32, bins int32, gains float32,
    leaves [T, n_leaves] float32)``.

    ``boosting=False`` bags (random forest): every tree fits the base
    score's residual on Poisson bootstrap weights and its feature subset
    (``feat_subset > 0``), the margins are not updated.
    ``hist_layout=None`` is :func:`resolve_hist_layout`'s; ``hist_tables``
    are :func:`sharded_hist_args` for the same layout."""
    from flinkml_tpu_torch.ops import threefry

    hist_layout = resolve_hist_layout(hist_layout)
    device = binned.device
    n_leaves = 1 << depth
    n_inner = n_leaves - 1
    n_local = binned.shape[0]
    f32 = torch.float32
    lam_t = torch.tensor(lam, dtype=f32, device=device)
    lr_t = torch.tensor(lr, dtype=f32, device=device)
    feats = torch.zeros((num_trees, n_inner), dtype=torch.int32,
                        device=device)
    bins = torch.zeros_like(feats)
    gains = torch.zeros((num_trees, n_inner), dtype=f32, device=device)
    leaves = torch.zeros((num_trees, n_leaves), dtype=f32, device=device)
    pred = (torch.zeros_like(y) + torch.tensor(base, dtype=f32,
                                               device=device)).to(f32)
    keys = threefry.split(threefry.PRNGKey(seed, device), num_trees)
    for t in range(num_trees):
        g, h = grad_hess(pred, y, w, logistic)
        mask, fmask = tree_weights(keys[t], n_local, subsample, boosting,
                                   n_feat, feat_subset, device)
        gh = torch.stack([g * mask, h * mask], dim=1)
        node = torch.zeros(n_local, dtype=torch.int32, device=device)
        for level in range(depth):
            if hist_layout == "cumsum":
                hist = level_hists_cumsum(gh, node, level, hist_tables,
                                          n_feat, n_bins, n_leaves)
            else:
                hist = level_hists_segment(binned, gh, node, n_feat, n_bins,
                                           n_leaves)
            hist = _all_reduce(mesh, hist)
            bf, bb, bg = best_splits(hist, lam_t, fmask)
            width = 1 << level
            start = width - 1
            feats[t, start:start + width] = bf[:width]
            bins[t, start:start + width] = bb[:width]
            gains[t, start:start + width] = bg[:width]
            node = advance(binned, node, bf, bb)
        if hist_layout == "cumsum":
            leaf_gh = leaf_sums_from_hist(hist, bf, bb, n_leaves)
        else:
            leaf_gh = _all_reduce(mesh, _leaf_sums(gh, node, n_leaves))
        leaf = -leaf_gh[:, 0] / torch.clamp_min(leaf_gh[:, 1] + lam_t, 1e-12)
        leaves[t] = leaf
        if boosting:
            pred = (pred + lr_t * leaf[node.long()]).to(f32)
    return (feats.cpu().numpy(), bins.cpu().numpy(), gains.cpu().numpy(),
            leaves.cpu().numpy())


def _leaf_sums(gh, node, n_leaves: int) -> torch.Tensor:
    """``[n_leaves, 2]`` sums of g and h by leaf: one ``segment_sum``."""
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    return segment_sum(gh, node, n_leaves)


def leaf_sums_from_hist(hist, bf, bb, n_leaves: int) -> torch.Tensor:
    """``[n_leaves, 2]`` sums of g and h by leaf from the last level's
    summed histograms: node ``i``'s left child ``2i`` holds its split
    feature's bins up to the split bin, the right child ``2i + 1`` the
    rest (the gain's ``GL`` and ``GT - GL``). The ``cumsum`` layout's
    leaves, with no pass over the rows, no atomics and no collective;
    they equal the rows' sums up to float32 rounding."""
    idx = torch.arange(hist.shape[0], device=hist.device)
    per = torch.cumsum(hist[idx, bf.long()], dim=1)     # [L, bins, 2]
    left = per[idx, bb.long()]
    right = per[:, -1] - left
    return torch.stack([left, right], dim=1).reshape(-1, 2)[:n_leaves]


# -- host forest walks ----------------------------------------------------------

def _walk_forest_per_tree(x: np.ndarray, feats, thrs, leaves,
                          depth: int) -> np.ndarray:
    """[T, n] per-tree leaf values for raw features (host numpy)."""
    n = x.shape[0]
    out = np.empty((feats.shape[0], n))
    for t in range(feats.shape[0]):
        node = np.zeros(n, dtype=np.int64)   # index within level
        for level in range(depth):
            start = (1 << level) - 1
            f = feats[t, start + node]
            thr = thrs[t, start + node]
            node = node * 2 + (x[np.arange(n), f] > thr)
        out[t] = leaves[t, node]
    return out


def _walk_forest(x: np.ndarray, feats, thrs, leaves, depth: int) -> np.ndarray:
    """Sum of leaf values over all trees (host numpy), one tree at a
    time: an O(n) accumulator."""
    n = x.shape[0]
    total = np.zeros(n)
    for t in range(feats.shape[0]):
        node = np.zeros(n, dtype=np.int64)
        for level in range(depth):
            start = (1 << level) - 1
            f = feats[t, start + node]
            thr = thrs[t, start + node]
            node = node * 2 + (x[np.arange(n), f] > thr)
        total += leaves[t, node]
    return total


def split_thresholds(edges: np.ndarray, feats, bins) -> np.ndarray:
    """Raw thresholds: split "bin <= b" <=> "x <= edges[f, b]" (the last
    bin has threshold +inf: everything goes left)."""
    edges_inf = np.concatenate(
        [edges, np.full((edges.shape[0], 1), np.inf)], axis=1
    )
    return edges_inf[feats, np.minimum(bins, edges_inf.shape[1] - 1)]


# -- estimators ------------------------------------------------------------------

class _GBTBase(StreamingEstimatorMixin, _GBTParams, Estimator):
    """``fit`` accepts, besides a single in-RAM :class:`Table`, an
    iterable of batch Tables or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache` (the
    out-of-core path of :mod:`flinkml_tpu_torch.models._gbt_stream`:
    boosting only, no ``validationFraction``).

    ``hist_layout`` picks the in-RAM fit's per-level histogram reduction
    (``"segment"`` or ``"cumsum"``, module docstring); None, the default,
    takes the tuning table's ``gbt_histogram`` for the fit's device, else
    ``"segment"`` (:func:`resolve_hist_layout`; the JAX package reads
    ``FLINKML_TPU_GBT_HISTOGRAM``, then its tuning table). The streamed
    fit histograms with the ``segment_sum`` kernel, as the JAX package's
    does whatever the layout."""

    _LOGISTIC = True
    _BOOSTING = True

    def __init__(self, mesh=None, *, stream_reservoir_capacity: int = 65_536,
                 hist_layout: Optional[str] = None, **knobs):
        if hist_layout is not None:
            check_hist_layout(hist_layout)
        super().__init__(mesh=mesh, **knobs)
        self.stream_reservoir_capacity = stream_reservoir_capacity
        self.hist_layout = hist_layout

    def _feat_fraction(self, d: int) -> float:
        return 1.0

    def _labeled_maybe_hashed(self, table: Table):
        """(x, y, w, hash_features): SparseVector feature columns are
        hash-bundled to ``numHashFeatures`` dense columns (0 = dense
        input)."""
        features_col = self.get(self.FEATURES_COL)
        sp = sparse_features(table, features_col)
        if sp is None:
            x, y, w = labeled_data(
                table, features_col, self.get(self.LABEL_COL),
                self.get(self.WEIGHT_COL),
            )
            return x, y, w, 0
        n_hash = self.get(self.NUM_HASH_FEATURES)
        x = hashed_feature_matrix(sp, n_hash).astype(np.float64)
        y = np.asarray(
            table.column(self.get(self.LABEL_COL)), np.float64
        ).reshape(-1)
        if y.shape[0] != x.shape[0]:
            raise ValueError(
                f"label column has {y.shape[0]} rows, features have "
                f"{x.shape[0]}"
            )
        weight_col = self.get(self.WEIGHT_COL)
        w = (
            np.asarray(table.column(weight_col), np.float64).reshape(-1)
            if weight_col is not None
            else np.ones(x.shape[0], np.float64)
        )
        return x, y, w, n_hash

    def _fit_forest(self, table: Table):
        x, y, w, hash_features = self._labeled_maybe_hashed(table)
        if self._LOGISTIC:
            # The FULL label column, before any holdout split.
            check_binary_labels(y, type(self).__name__)
        vf = self.get(self.VALIDATION_FRACTION)
        holdout = None
        if vf > 0:
            if not self._BOOSTING:
                raise ValueError(
                    "validationFraction applies to boosted estimators only "
                    "(bagged forests don't overfit with more trees)"
                )
            rng = np.random.default_rng(self.get_seed())
            perm = rng.permutation(x.shape[0])
            n_hold = max(1, int(round(vf * x.shape[0])))
            if n_hold >= x.shape[0]:
                raise ValueError("validationFraction leaves no training rows")
            hold_idx, train_idx = perm[:n_hold], perm[n_hold:]
            holdout = (x[hold_idx], y[hold_idx], w[hold_idx])
            x, y, w = x[train_idx], y[train_idx], w[train_idx]
        if self._LOGISTIC:
            pos = float(np.sum(w * y))
            neg = float(np.sum(w * (1 - y)))
            base = float(np.log(max(pos, 1e-12) / max(neg, 1e-12)))
        else:
            base = float(np.sum(w * y) / np.sum(w))
        max_bins = self.get(self.MAX_BINS)
        depth = self.get(self.MAX_DEPTH)
        edges = quantile_bin_edges(x, max_bins)
        binned = bin_features(x, edges)
        mesh = self.mesh or DeviceMesh()
        p = mesh.axis_size()
        b_pad, n_valid = pad_to_multiple(binned, p)
        y_pad, _ = pad_to_multiple(y.astype(np.float32), p)
        w_pad = np.zeros(b_pad.shape[0], np.float32)
        w_pad[:n_valid] = w[:n_valid].astype(np.float32)
        f = self._feat_fraction(x.shape[1])
        feat_subset = (
            0 if f >= 1.0 else max(1, int(round(f * x.shape[1])))
        )
        hist_layout = resolve_hist_layout(self.hist_layout)
        feats, bins, gains, leaves = build_forest(
            mesh.shard_batch(b_pad), mesh.shard_batch(y_pad),
            mesh.shard_batch(w_pad),
            base=float(np.float32(base)),
            lr=float(np.float32(self.get(self.LEARNING_RATE))),
            lam=float(np.float32(self.get(self.REG_LAMBDA))),
            subsample=self.get(self.SUBSAMPLE), seed=self.get_seed(),
            n_feat=x.shape[1], n_bins=max_bins, depth=depth,
            num_trees=self.get(self.NUM_TREES), logistic=self._LOGISTIC,
            boosting=self._BOOSTING, feat_subset=feat_subset,
            hist_layout=hist_layout,
            hist_tables=sharded_hist_args(b_pad, mesh, max_bins,
                                          hist_layout),
            mesh=mesh,
        )
        thrs = split_thresholds(edges, feats, bins)
        if holdout is not None:
            feats, thrs, gains, leaves = self._truncate_to_best_prefix(
                holdout, feats, thrs, gains, leaves, base, depth,
            )
        return (feats, thrs, gains, leaves, base, depth, x.shape[1],
                hash_features)

    def _truncate_to_best_prefix(self, holdout, feats, thrs, gains, leaves,
                                 base, depth):
        """Early stopping: keep the tree prefix with the best holdout
        loss (cumulative per-tree margins on the held-out rows)."""
        hx, hy, hw = holdout
        lr = self.get(self.LEARNING_RATE)
        contribs = _walk_forest_per_tree(hx, feats, thrs, leaves, depth)
        margins = base + lr * np.cumsum(contribs, axis=0)   # [T, n_hold]
        if self._LOGISTIC:
            losses = (
                np.logaddexp(0.0, margins) - hy[None, :] * margins
            )
        else:
            losses = 0.5 * (margins - hy[None, :]) ** 2
        per_prefix = (losses * hw[None, :]).sum(axis=1)
        best = int(np.argmin(per_prefix)) + 1
        return feats[:best], thrs[:best], gains[:best], leaves[:best]

    def _fit_stream_forest(self, source):
        """Out-of-core forest build (:mod:`._gbt_stream`)."""
        from flinkml_tpu_torch.iteration.datacache import (
            DataCache,
            cache_stream,
        )
        from flinkml_tpu_torch.models._gbt_stream import train_gbt_stream

        if not self._BOOSTING:
            raise ValueError(
                "streamed fits support boosted estimators only; random "
                "forests need the in-RAM path (independent bagged trees)"
            )
        if self.get(self.VALIDATION_FRACTION) > 0:
            raise ValueError(
                "validationFraction is not supported in streamed fits "
                "(a holdout needs a second materialized stream)"
            )
        if self.resume and not isinstance(source, DataCache):
            raise ValueError(
                "resume=True requires a durable DataCache input: a one-shot "
                "stream cannot be replayed from the start after a failure"
            )
        features_col = self.get(self.FEATURES_COL)
        label_col = self.get(self.LABEL_COL)
        weight_col = self.get(self.WEIGHT_COL)
        hash_seen = [None]  # None until the first batch decides the mode
        if isinstance(source, DataCache):
            cache = source
            columns = (features_col, label_col, weight_col)
        else:

            def batches():
                for t in source:
                    x, y, w, nh = self._labeled_maybe_hashed(t)
                    if hash_seen[0] is None:
                        hash_seen[0] = nh
                    elif hash_seen[0] != nh:
                        raise ValueError(
                            "stream mixes sparse and dense feature "
                            "batches; use one representation throughout"
                        )
                    yield {"x": x.astype(np.float32),
                           "y": y.astype(np.float32),
                           "w": w.astype(np.float32)}

            cache = cache_stream(
                batches(), self.cache_dir, self.cache_memory_budget_bytes
            )
            columns = ("x", "y", "w")
        label_check = (
            (lambda y: check_binary_labels(y, type(self).__name__))
            if self._LOGISTIC else None
        )
        depth = self.get(self.MAX_DEPTH)
        feats, bins, gains, leaves, base, edges = train_gbt_stream(
            cache,
            mesh=self.mesh or DeviceMesh(),
            logistic=self._LOGISTIC,
            num_trees=self.get(self.NUM_TREES),
            depth=depth,
            max_bins=self.get(self.MAX_BINS),
            learning_rate=self.get(self.LEARNING_RATE),
            reg_lambda=self.get(self.REG_LAMBDA),
            subsample=self.get(self.SUBSAMPLE),
            seed=self.get_seed(),
            columns=columns,
            label_check=label_check,
            reservoir_capacity=self.stream_reservoir_capacity,
            **self._checkpoint_kwargs(),
        )
        thrs = split_thresholds(edges, feats, bins)
        return (feats, thrs, gains, leaves, base, depth, edges.shape[0],
                hash_seen[0] or 0)

    _MODEL_CLS = None   # set per concrete estimator

    def fit(self, *inputs):
        (table,) = inputs
        if isinstance(table, Table):
            self._reject_in_ram_checkpointing(
                "the in-RAM fit builds the whole forest in one device "
                "program"
            )
            forest = self._fit_forest(table)
        else:
            forest = self._fit_stream_forest(table)
        (feats, thrs, gains, leaves, base, depth, n_features,
         hash_features) = forest
        model = self._MODEL_CLS()
        model.copy_params_from(self)
        # Bagged forests predict the MEAN of tree outputs (lr = 1/T);
        # boosted forests scale each tree by the learning rate.
        lr = (
            self.get(self.LEARNING_RATE) if self._BOOSTING
            else 1.0 / feats.shape[0]
        )
        model._set_forest(feats, thrs, leaves, base, depth, lr,
                          gains, n_features, hash_features)
        return model


class _GBTModelBase(_GBTParams, Model):
    _LOGISTIC = True

    def __init__(self):
        super().__init__()
        self._feats: Optional[np.ndarray] = None
        self._thrs: Optional[np.ndarray] = None
        self._leaves: Optional[np.ndarray] = None
        self._base: float = 0.0
        self._depth: int = 0
        self._lr: float = 0.1
        self._gains: Optional[np.ndarray] = None
        self._n_features: int = 0
        self._hash_features: int = 0

    def _set_forest(self, feats, thrs, leaves, base, depth, lr,
                    gains=None, n_features=None, hash_features=0):
        self._feats = np.asarray(feats, np.int64)
        self._thrs = np.asarray(thrs, np.float64)
        self._leaves = np.asarray(leaves, np.float64)
        self._base = float(base)
        self._depth = int(depth)
        self._lr = float(lr)
        self._gains = (
            np.asarray(gains, np.float64) if gains is not None
            else np.ones_like(self._feats, dtype=np.float64)
        )
        self._n_features = (
            int(n_features) if n_features is not None
            else int(self._feats.max()) + 1
        )
        # > 0 when the forest was trained on hash-bundled sparse input:
        # transform applies the same stateless bundling.
        self._hash_features = int(hash_features)

    def set_model_data(self, *inputs: Table):
        (table,) = inputs
        self._set_arrays({k: table.column(k) for k in table.column_names})
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        t = self._feats.shape[0]
        return [Table({
            "feat": self._feats, "threshold": self._thrs,
            "gain": self._gains, "leaf": self._leaves,
            "base": np.full(t, self._base),
            "depth": np.full(t, self._depth),
            "learningRate": np.full(t, self._lr),
            "numFeatures": np.full(t, self._n_features),
            "hashFeatures": np.full(t, self._hash_features),
        })]

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require()
        return {
            "feat": self._feats, "threshold": self._thrs,
            "gain": self._gains, "leaf": self._leaves,
            "base": np.asarray(self._base),
            "depth": np.asarray(self._depth),
            "learningRate": np.asarray(self._lr),
            "numFeatures": np.asarray(self._n_features),
            "hashFeatures": np.asarray(self._hash_features),
        }

    def _set_arrays(self, arrays) -> None:
        """The saved layout (scalars 0-d) or the model-data table's
        (scalars repeated per tree)."""
        def scalar(name, default=None):
            if name not in arrays:
                return default
            return np.asarray(arrays[name]).reshape(-1)[0]

        self._set_forest(
            arrays["feat"], arrays["threshold"], arrays["leaf"],
            float(scalar("base")), int(scalar("depth")),
            float(scalar("learningRate")),
            gains=arrays.get("gain"),
            n_features=(None if "numFeatures" not in arrays
                        else int(scalar("numFeatures"))),
            hash_features=int(scalar("hashFeatures", 0)),
        )

    def _require(self) -> None:
        if self._feats is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def feature_importances(self, num_features: Optional[int] = None) -> np.ndarray:
        """Gain importance (the XGBoost convention): each feature's share
        of the total split gain across the forest, normalized to sum to
        1. Default length = the training feature count."""
        self._require()
        d = self._n_features if num_features is None else int(num_features)
        max_feat = int(self._feats.max())
        if d <= max_feat:
            raise ValueError(
                f"num_features={d} but the forest splits on feature "
                f"{max_feat}"
            )
        imp = np.bincount(
            self._feats.reshape(-1),
            weights=self._gains.reshape(-1),
            minlength=d,
        )
        total = imp.sum()
        return imp / total if total > 0 else imp

    def _margin(self, table: Table) -> np.ndarray:
        col = table.column(self.get(self.FEATURES_COL))
        if self._hash_features and col.dtype == object:
            x = hashed_feature_matrix(
                col, self._hash_features
            ).astype(np.float64)
        else:
            from flinkml_tpu_torch.models._data import features_matrix

            x = features_matrix(table, self.get(self.FEATURES_COL))
        if x.ndim != 2:
            raise ValueError(f"features must be [n, d], got {x.shape}")
        if self._feats.size and self._feats.max() >= x.shape[1]:
            raise ValueError(
                f"model uses feature {self._feats.max()}, features have "
                f"dim {x.shape[1]}"
            )
        return self._base + self._lr * _walk_forest(
            x, self._feats, self._thrs, self._leaves, self._depth
        )


class GBTClassifier(_GBTBase):
    """Binary gradient-boosted tree classifier (logistic loss)."""

    _LOGISTIC = True


class GBTClassifierModel(_GBTModelBase):
    _LOGISTIC = True

    RAW_PREDICTION_COL = HasRawPredictionCol.RAW_PREDICTION_COL

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        margin = self._margin(table)
        prob = 1.0 / (1.0 + np.exp(-margin))
        out = table.with_column(
            self.get(self.PREDICTION_COL), (margin >= 0).astype(np.float64)
        )
        out = out.with_column(
            self.get(self.RAW_PREDICTION_COL),
            np.stack([1.0 - prob, prob], axis=1),
        )
        return (out,)


class GBTRegressor(_GBTBase):
    """Gradient-boosted tree regressor (squared loss)."""

    _LOGISTIC = False


class GBTRegressorModel(_GBTModelBase):
    _LOGISTIC = False

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        return (
            table.with_column(self.get(self.PREDICTION_COL), self._margin(table)),
        )


class _RandomForestParams(_GBTParams):
    FEATURE_SUBSET_FRACTION = FloatParam(
        "featureSubsetFraction",
        "Fraction of features drawn per tree (None = sqrt(d)/d for the "
        "classifier, all features for the regressor — the sklearn "
        "conventions).",
        None, lambda v: v is None or 0 < v <= 1,
    )


class _RFBase(_RandomForestParams, _GBTBase):
    """Random forest = the same device forest builder in BAGGING mode:
    every tree fits the base-score residual independently on Poisson
    bootstrap weights and a per-tree feature subset; prediction averages
    the tree outputs."""

    _BOOSTING = False

    def _feat_fraction(self, d: int) -> float:
        f = self.get(self.FEATURE_SUBSET_FRACTION)
        return float(f) if f is not None else min(1.0, np.sqrt(d) / d)


class RandomForestClassifier(_RFBase):
    """Bagged binary classifier (defaults: subsample 1.0, feature subset
    sqrt(d))."""

    _LOGISTIC = True


class RandomForestClassifierModel(_RandomForestParams, GBTClassifierModel):
    pass


class RandomForestRegressor(_RFBase):
    _LOGISTIC = False

    def _feat_fraction(self, d: int) -> float:
        # Regression forests default to ALL features per tree.
        f = self.get(self.FEATURE_SUBSET_FRACTION)
        return float(f) if f is not None else 1.0


class RandomForestRegressorModel(_RandomForestParams, GBTRegressorModel):
    pass


GBTClassifier._MODEL_CLS = GBTClassifierModel
GBTRegressor._MODEL_CLS = GBTRegressorModel
RandomForestClassifier._MODEL_CLS = RandomForestClassifierModel
RandomForestRegressor._MODEL_CLS = RandomForestRegressorModel
