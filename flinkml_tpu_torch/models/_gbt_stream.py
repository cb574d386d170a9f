"""Out-of-core histogram GBT: level-wise boosting over a replayed cache.

The port's counterpart of ``flinkml_tpu.models._gbt_stream``. The in-RAM
builder (:func:`flinkml_tpu_torch.models.gbt.build_forest`) holds the
whole binned dataset on the device; here the dataset lives in a
:class:`~flinkml_tpu_torch.iteration.datacache.DataCache` (host RAM and
disk segments) and only one batch (plus the prefetch depth) is on the
device at a time.

Each tree level is one replay pass: every batch's (node, feature, bin)
gradient and hessian histograms come from ONE ``segment_sum`` kernel
launch of the ``[rows·d, 2]`` payload (one ``all_reduce`` on a mesh of
several ranks) and are added on the device in float32 in batch order; the
host then picks every node's split from the small ``[n_leaves, d, bins]``
sums in float64, and the next pass advances each row's node id. A last
pass advances to the leaves and sums them (one more launch a batch).
Per-row state (margin, node id, subsample mask) is host-resident.

Scope (the JAX package's): boosting only, no ``validationFraction``, the
``segment`` histograms only. Bin edges come from a seeded
:class:`~flinkml_tpu_torch.utils.sampling.RowReservoir` row sample
(default 64k rows): with ``reservoir_capacity >= n`` they are exact.
Checkpoints every N trees hold the margins and the partial forest; a
resume re-runs passes A and B (edges and the binned cache) from the same
seed and cache and fast-forwards the subsample generator one draw per
completed tree, so it continues bit for bit with the uninterrupted run
wherever the histogram sums are (on the CPU; on the card the kernel's
atomics add in a run-dependent order).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.parallel.mesh import DeviceMesh

_LAM_FLOOR = 1e-12


def _best_level_splits(hg, hh, lam, n_leaves, n_feat, n_bins):
    """Host mirror of the in-RAM builder's split selection: cumulative
    histograms, XGBoost gain, empty-side and last-bin guards, per-node
    argmax, in float64."""
    hg = np.asarray(hg, np.float64).reshape(n_leaves, n_feat, n_bins)
    hh = np.asarray(hh, np.float64).reshape(n_leaves, n_feat, n_bins)
    gl = np.cumsum(hg, axis=2)
    hl = np.cumsum(hh, axis=2)
    gt, ht = gl[:, :, -1:], hl[:, :, -1:]
    gr, hr = gt - gl, ht - hl
    with np.errstate(divide="ignore", invalid="ignore"):
        gain = (
            gl * gl / (hl + lam) + gr * gr / (hr + lam)
            - gt * gt / (ht + lam)
        )
    gain = np.where((hl > 0) & (hr > 0), gain, 0.0)
    gain[:, :, -1] = 0.0
    flat = gain.reshape(n_leaves, n_feat * n_bins)
    best = np.argmax(flat, axis=1)
    best_gain = np.maximum(flat[np.arange(n_leaves), best], 0.0)
    return (
        (best // n_bins).astype(np.int32),
        (best % n_bins).astype(np.int32),
        best_gain.astype(np.float32),
    )


def train_gbt_stream(
    cache,
    *,
    mesh: DeviceMesh,
    logistic: bool,
    num_trees: int,
    depth: int,
    max_bins: int,
    learning_rate: float,
    reg_lambda: float,
    subsample: float,
    seed: int,
    columns: Tuple[str, str, Optional[str]] = ("x", "y", "w"),
    reservoir_capacity: int = 65_536,
    prefetch_depth: int = 2,
    label_check: Optional[Callable[[np.ndarray], None]] = None,
    checkpoint_manager=None,
    checkpoint_interval: int = 0,
    resume: bool = False,
):
    """Build a boosted forest from a sealed raw-feature ``DataCache``.

    Returns ``(feats[T, n_inner], bins[T, n_inner], gains[T, n_inner],
    leaves[T, n_leaves], base, edges[d, max_bins-1])``.

    On a mesh of several ranks each rank passes its OWN partition as its
    cache: per-row state stays on the rank that owns the rows, histograms
    are summed over the ranks, and the split decisions are the same on
    every rank. The agreements (bin edges from a pooled reservoir, the
    base score from gathered sums, the replay schedule) come from
    :mod:`flinkml_tpu_torch.iteration.stream_sync`; checkpoints are
    rank-scoped (the margins are per rank) with an agreed commit.
    ``checkpoint_manager`` + ``checkpoint_interval`` snapshot the
    between-tree state every N trees; ``resume=True`` restores the newest
    snapshot every rank holds and continues.
    """
    from flinkml_tpu_torch.iteration.stream_sync import (
        DeferredValidation,
        checked_ingest,
    )
    from flinkml_tpu_torch.models._linear_sgd import multi_rank
    from flinkml_tpu_torch.models.gbt import bin_features, quantile_bin_edges
    from flinkml_tpu_torch.utils.sampling import RowReservoir

    multi = multi_rank(mesh)
    x_key, y_key, w_key = columns
    rng = np.random.default_rng(seed)

    # -- pass A: reservoir for bin edges + base-score sums -----------------
    dv = DeferredValidation()
    reservoir = RowReservoir(reservoir_capacity, seed=seed)
    wy_sum = w_sum = wneg_sum = 0.0
    n_feat = None

    def check_batch(x, y):
        nonlocal n_feat
        if x.ndim != 2:
            raise ValueError(f"stream batches must be [n, d], got {x.shape}")
        if x.shape[0] == 0:
            raise ValueError("stream batch has zero rows; drop empty batches")
        if n_feat is None:
            n_feat = x.shape[1]
        elif x.shape[1] != n_feat:
            raise ValueError(
                f"batch feature dim {x.shape[1]} != first batch's {n_feat}"
            )
        if label_check is not None:
            label_check(y)

    def read(batch):
        x = np.asarray(batch[x_key], np.float32)
        y = np.asarray(batch[y_key], np.float32)
        w = (
            np.asarray(batch[w_key], np.float32)
            if w_key is not None and w_key in batch
            else np.ones(x.shape[0], np.float32)
        )
        return x, y, w

    def ingest(batch):
        x, y, w = read(batch)
        check_batch(x, y)
        return x, y, w

    for x, y, w in checked_ingest(cache.reader(), dv, ingest, multi):
        reservoir.add(x)
        wy_sum += float(np.sum(w * y))
        w_sum += float(np.sum(w))
        wneg_sum += float(np.sum(w * (1 - y)))

    if multi:
        from flinkml_tpu_torch.iteration.stream_sync import (
            agree_feature_dim,
            gather_vectors,
            pooled_sample,
        )

        dv.rendezvous(mesh, "stream ingest validation")
        dim = agree_feature_dim(
            cache, x_key, mesh, local_dim=0 if n_feat is None else n_feat
        )
        if dim == 0:
            raise ValueError("training stream is empty on every process")
        n_feat = dim
        sums = gather_vectors(
            np.asarray([wy_sum, w_sum, wneg_sum, float(cache.num_rows)]),
            mesh,
        ).sum(axis=0)
        wy_sum, w_sum, wneg_sum = sums[0], sums[1], sums[2]
        sample = reservoir.sample()
        if sample.size == 0:
            sample = np.zeros((0, dim), np.float32)
        sample = pooled_sample(
            sample.astype(np.float32), cache.num_rows,
            reservoir_capacity, seed, mesh,
        )
    else:
        if n_feat is None or cache.num_rows == 0:
            raise ValueError("training stream is empty")
        sample = reservoir.sample()
    n = cache.num_rows  # LOCAL rows: per-row state is rank-resident
    if logistic:
        base = float(np.log(max(wy_sum, 1e-12) / max(wneg_sum, 1e-12)))
    else:
        base = float(wy_sum / w_sum)
    edges = quantile_bin_edges(sample, max_bins)

    # -- pass B: binned cache (uint8 bins: max_bins <= 256) ----------------
    # A raw cache that spills gets a private spill directory beside its
    # segments for the binned copy, removed after the build.
    from flinkml_tpu_torch.iteration.datacache import DataCacheWriter

    spill_dir = None
    budget = None
    if cache.segments:
        spill_dir = tempfile.mkdtemp(
            prefix="flinkml-gbt-binned-",
            dir=os.path.dirname(cache.segments[0].path),
        )
        budget = 0  # the raw cache already spills: keep the copy on disk
    try:
        writer = DataCacheWriter(spill_dir, budget)
        ranges = []  # (start_row, rows) in binned-cache batch order
        r0 = 0
        for batch in cache.reader():
            x, y, w = read(batch)
            writer.append({
                "b": bin_features(x, edges).astype(np.uint8),
                "y": y, "w": w,
            })
            ranges.append((r0, x.shape[0]))
            r0 += x.shape[0]
        binned_cache = writer.finish()
        return _build_forest(
            binned_cache, ranges, mesh=mesh, multi=multi, logistic=logistic,
            num_trees=num_trees, depth=depth, max_bins=max_bins,
            n_feat=n_feat, n=n, base=base, edges=edges,
            learning_rate=learning_rate, reg_lambda=reg_lambda,
            subsample=subsample, rng=rng, prefetch_depth=prefetch_depth,
            checkpoint_manager=checkpoint_manager,
            checkpoint_interval=checkpoint_interval, resume=resume,
        )
    finally:
        if spill_dir is not None:
            shutil.rmtree(spill_dir, ignore_errors=True)


def _build_forest(
    binned_cache, ranges, *, mesh, multi, logistic, num_trees, depth,
    max_bins, n_feat, n, base, edges, learning_rate, reg_lambda, subsample,
    rng, prefetch_depth, checkpoint_manager=None, checkpoint_interval=0,
    resume=False,
):
    """The level-wise replay build over a sealed binned cache (module
    docstring)."""
    from flinkml_tpu_torch.iteration.checkpoint import (
        begin_resume,
        rank_scoped,
        save_agreed,
        should_snapshot,
    )
    from flinkml_tpu_torch.iteration.datacache import PrefetchingDeviceFeed
    from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
    from flinkml_tpu_torch.parallel.mesh import pad_to_multiple

    from flinkml_tpu_torch.models.gbt import (
        _all_reduce,
        _leaf_sums,
        advance,
        grad_hess,
        level_hists_segment,
    )

    n_leaves = 1 << depth
    n_inner = n_leaves - 1
    row_tile = mesh.axis_size() * 8
    device = mesh.device
    reduce_mesh = mesh if multi else None

    def batch_step(binned, y, w_eff, pred, node, split, leaves):
        """One batch's ``[n_leaves, d, bins, 2]`` histograms (or, with
        ``leaves``, its ``[n_leaves, 2]`` leaf sums) after advancing its
        rows through ``split`` (the previous level's ``(feat, bin)``),
        summed over the ranks; and the advanced node ids. g and h are
        recomputed from the margins (cheaper than two more host arrays)."""
        binned = binned.to(torch.int32)
        if split is not None:
            node = advance(binned, node, *split)
        g, h = grad_hess(pred, y, w_eff, logistic)
        gh = torch.stack([g, h], dim=1)
        out = (_leaf_sums(gh, node, n_leaves) if leaves else
               level_hists_segment(binned, gh, node, n_feat, max_bins,
                                   n_leaves))
        return _all_reduce(reduce_mesh, out), node

    # Host-resident per-row state, rank-local.
    pred = np.full(n, base, np.float32)
    node = np.zeros(n, np.int32)
    mask = np.ones(n, np.float32)

    plan = None
    if multi:
        from flinkml_tpu_torch.iteration.stream_sync import (
            SyncedReplayPlan,
            pad_rows_to,
        )

        plan = SyncedReplayPlan.create(binned_cache, mesh, row_tile)

        def shard_padded(arr):
            """The agreed height on every rank (zero-weight padding and
            dummies are exact no-ops)."""
            return mesh.global_batch(pad_rows_to(arr, plan.local_height))

    else:

        def shard_padded(arr):
            """Zero-pad rows to the row tile (padded rows carry w = 0)."""
            return mesh.shard_batch(pad_to_multiple(arr, row_tile)[0])

    def place(item):
        if item is None:  # a dummy step on a drained rank (multi only)
            zb = np.zeros((plan.local_height, n_feat), np.uint8)
            zf = np.zeros(plan.local_height, np.float32)
            return (0, 0, mesh.global_batch(zb), mesh.global_batch(zf),
                    mesh.global_batch(zf))
        start, rows, batch = item
        return (start, rows,
                shard_padded(batch["b"]),
                shard_padded(batch["y"]), shard_padded(batch["w"]))

    def feed():
        src = ((ranges[i][0], ranges[i][1], b)
               for i, b in enumerate(binned_cache.reader()))
        if multi:
            src = plan.epoch_batches(src, lambda: None)
        return PrefetchingDeviceFeed(src, place=place, depth=prefetch_depth)

    def shard_state(arr, start, rows):
        return shard_padded(arr[start:start + rows])

    def write_nodes(start, rows, new_node):
        if rows:
            node[start:start + rows] = mesh.local_rows(new_node)[:rows]

    feats_out = np.zeros((num_trees, n_inner), np.int32)
    bins_out = np.zeros((num_trees, n_inner), np.int32)
    gains_out = np.zeros((num_trees, n_inner), np.float32)
    leaves_out = np.zeros((num_trees, n_leaves), np.float32)

    # -- checkpoint/resume: the unit of recovery is one completed tree -----
    if multi and checkpoint_manager is not None:
        checkpoint_manager = rank_scoped(checkpoint_manager)
    resume_tree = begin_resume(checkpoint_manager, resume,
                               mesh.num_devices if multi else 1)
    if multi and resume:
        from flinkml_tpu_torch.iteration.stream_sync import agree_max

        # Every rank resumes from the newest tree EVERY rank still holds:
        # walk down the min over ranks of each rank's newest epoch <= cand.
        local = set(checkpoint_manager.all_epochs())

        def newest_at_most(c):
            return max((e for e in local if e <= c), default=-1)

        cand = -agree_max(-newest_at_most(1 << 30), mesh)
        while cand >= 0:
            nxt = -agree_max(-newest_at_most(cand), mesh)
            if nxt == cand:
                break
            cand = nxt
        resume_tree = None if cand < 0 else cand
    start_tree = 0
    if resume_tree is not None:
        from flinkml_tpu_torch.iteration.stream_sync import agreed_restore

        like = (pred, feats_out, bins_out, gains_out, leaves_out)
        state, start_tree = agreed_restore(
            checkpoint_manager, resume_tree, like, mesh,
            f"checkpoint restore (tree {resume_tree})",
        )
        pred, feats_out, bins_out, gains_out, leaves_out = (
            np.array(a) for a in state
        )
        if subsample < 1.0:
            # Fast-forward the subsample generator one draw per completed
            # tree: the resumed trees see the uninterrupted run's masks.
            for _ in range(start_tree):
                rng.random(n)

    guard = DispatchGuard()  # multi-process backpressure (no-op single)
    lam = np.float64(reg_lambda)
    for t in range(start_tree, num_trees):
        if subsample < 1.0:
            mask = (rng.random(n) < subsample).astype(np.float32)
        node[:] = 0
        prev_split = None  # (feat, bin) tensors of the level just decided
        for level in range(depth):
            acc = None
            f = feed()
            try:
                for start, rows, bb, yb, wb in f:
                    hist, new_node = batch_step(
                        bb, yb, wb * shard_state(mask, start, rows),
                        shard_state(pred, start, rows),
                        shard_state(node, start, rows), prev_split, False)
                    if prev_split is not None:
                        write_nodes(start, rows, new_node)
                    acc = hist if acc is None else acc + hist
                    guard.after_dispatch(acc)
            finally:
                f.close()
            guard.flush(acc)
            acc = acc.cpu().numpy()
            bf, bbin, bgain = _best_level_splits(
                acc[..., 0], acc[..., 1], lam, n_leaves, n_feat, max_bins
            )
            width = 1 << level
            start_i = width - 1
            feats_out[t, start_i:start_i + width] = bf[:width]
            bins_out[t, start_i:start_i + width] = bbin[:width]
            gains_out[t, start_i:start_i + width] = bgain[:width]
            prev_split = (torch.from_numpy(bf).to(device),
                          torch.from_numpy(bbin).to(device))
        # -- the final advance + leaf sums (one replay) ---------------------
        acc = None
        f = feed()
        try:
            for start, rows, bb, yb, wb in f:
                sums, new_node = batch_step(
                    bb, yb, wb * shard_state(mask, start, rows),
                    shard_state(pred, start, rows),
                    shard_state(node, start, rows), prev_split, True)
                write_nodes(start, rows, new_node)
                acc = sums if acc is None else acc + sums
                guard.after_dispatch(acc)
        finally:
            f.close()
        guard.flush(acc)
        acc = acc.cpu().numpy().astype(np.float64)
        leaf = (-acc[:, 0] / np.maximum(acc[:, 1] + lam, _LAM_FLOOR)).astype(
            np.float32
        )
        leaves_out[t] = leaf
        # The margin update is host work: node and pred are host-resident.
        pred += learning_rate * leaf[node]
        if should_snapshot(checkpoint_manager, checkpoint_interval,
                           t + 1, num_trees):
            save_agreed(
                checkpoint_manager,
                (pred, feats_out, bins_out, gains_out, leaves_out),
                t + 1, mesh, per_rank=True,
                layouts=("per_rank", "replicated", "replicated",
                         "replicated", "replicated"),
            )
    return feats_out, bins_out, gains_out, leaves_out, base, edges
