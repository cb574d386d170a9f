"""ALS — alternating least squares matrix factorization (explicit +
implicit feedback).

The port's counterpart of ``flinkml_tpu.models.als``, on the compute device
with the port's kernels:

  - Each half-step builds every target's normal equations at once from
    the ratings COO: gather the fixed side's factors (``y = Y[idx]``),
    form per-rating outer products, and sum them per target into
    ``A [n, k, k]`` / ``b [n, k]`` / ``counts [n]``.
  - The per-rating work is chunked (``CHUNK`` rows per rank a chunk), so
    peak memory is ``chunk × k²`` instead of ``nnz × k²``. Padding rows
    carry target id ``n`` (a dummy segment that is dropped), fixed index 0
    and rating 0.
  - The reduction is the ``layout`` keyword (the JAX package reads
    ``FLINKML_TPU_ALS_REDUCTION``), by default the tuning table's
    ``als_reduction``, else ``"segment"``: ``"segment"`` runs the port's ``segment_sum`` kernel three
    times a chunk, ``[chunk, k²]``, ``[chunk, k]`` and ``[chunk]`` into
    ``n + 1`` segments — on the card its atomics add in an order that
    changes from run to run, and under
    ``torch.use_deterministic_algorithms(True)`` the kernel refuses (no
    quiet switch to ``index_add_``); ``"cumsum"`` sorts each side's COO
    by target once, precomputes the run boundaries of every (chunk, rank)
    slice (:func:`als_run_tables`) and reduces each chunk with
    :func:`~flinkml_tpu_torch.ops.sparse.chunked_run_totals` and one
    ``index_add_`` at ascending targets (padding runs add exactly 0), the
    same bits on every run. The streamed fit always uses ``segment``.
  - Every target's system solves as one batched Cholesky
    (``torch.linalg``, as the JAX package solves outside Pallas).
  - On a mesh the COO chunks split over the data axis (every rank passes
    the same table) and one ``all_reduce`` sums each chunk's partial
    ``A``/``b``/``counts``; factors are replicated.

Regularization follows ALS-WR: λ is scaled by each target's rating count
(``A_u += λ·n_u·I``) and floored at 1e-4. Implicit mode is
Hu/Koren/Volinsky: ``c = 1 + α·r``, ``A_u = YᵀY + Σ (c-1) y yᵀ + λ·n_u·I``,
``b_u = Σ c·y``. Model data, ``save`` and ``load`` use the JAX package's
formats.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import HasMaxIter, HasPredictionCol, HasSeed
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.params import (
    BoolParam,
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from flinkml_tpu_torch.table import Table

#: The normal-equation reductions (the ``layout`` keyword of :class:`ALS`).
LAYOUTS = ("segment", "cumsum")


class _ALSParams(HasMaxIter, HasPredictionCol, HasSeed):
    USER_COL = StringParam("userCol", "User id column.", "user")
    ITEM_COL = StringParam("itemCol", "Item id column.", "item")
    RATING_COL = StringParam("ratingCol", "Rating column.", "rating")
    RANK = IntParam("rank", "Factor dimensionality.", 10, ParamValidators.gt(0))
    REG_PARAM = FloatParam(
        "regParam", "ALS-WR regularization (scaled by rating count).", 0.1,
        ParamValidators.gt_eq(0.0),
    )
    IMPLICIT_PREFS = BoolParam(
        "implicitPrefs", "Implicit-feedback (confidence-weighted) mode.", False
    )
    ALPHA = FloatParam(
        "alpha", "Implicit-mode confidence slope (c = 1 + alpha * r).", 1.0,
        ParamValidators.gt_eq(0.0),
    )


def check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}: expected one of {LAYOUTS}")


def resolve_layout(layout: Optional[str] = None) -> str:
    """The in-RAM fit's reduction: ``layout`` when given, else the tuning
    table's ``als_reduction`` for this thread's device
    (:mod:`flinkml_tpu_torch.autotune`), else ``segment``: the JAX
    package's precedence, the keyword standing for its
    ``FLINKML_TPU_ALS_REDUCTION``."""
    if layout is None:
        from flinkml_tpu_torch.autotune import tuned_default

        layout = tuned_default("als_reduction", "segment", allowed=LAYOUTS)
    check_layout(layout)
    return layout


def als_run_tables(seg_padded: np.ndarray, p_size: int, chunk: int):
    """Per-(chunk, rank) run boundaries for the ``cumsum`` reduction:
    ``(ends, cols)``, each ``[n_chunks, p·max_runs]``, over a COO that is
    PRE-SORTED by segment id (padding ids sort last by construction). One
    :func:`~flinkml_tpu_torch.ops.sparse.run_boundary_tables` call over
    the COO reshaped to one row per (chunk, rank) slice — the JAX
    package's tables, bit for bit."""
    from flinkml_tpu_torch.ops.sparse import run_boundary_tables

    chunk_g = p_size * chunk
    n_chunks = seg_padded.shape[0] // chunk_g
    if n_chunks == 0:  # empty table: zero chunks, zero table rows
        empty = np.zeros((0, 1), np.int32)
        return empty, empty
    ends, cols = run_boundary_tables(
        seg_padded[: n_chunks * chunk_g].reshape(n_chunks * p_size, chunk)
    )
    return ends.reshape(n_chunks, -1), cols.reshape(n_chunks, -1)


def _weights(r: torch.Tensor, alpha: float, implicit: bool):
    """``(a_w, b_w)``: the weights of ``y yᵀ`` in ``A`` and of ``y`` in
    ``b``. Padding rows (rating 0) weigh 0 in implicit mode; in explicit
    mode their ``a_w = 1`` lands in the dropped dummy segment."""
    if implicit:
        conf_minus_1 = alpha * r
        return conf_minus_1, 1.0 + conf_minus_1  # Σ(c-1)yyᵀ / Σc·y
    return torch.ones_like(r), r                 # Σyyᵀ / Σr·y


def normal_eq_chunk(seg, idx, r, fixed, alpha: float, n_segments: int,
                    implicit: bool, layout: str = "segment", ends=None,
                    cols=None, mesh=None):
    """One COO chunk's contribution to the normal equations:
    ``(a [n, k, k], b [n, k], cnt [n])``, summed over the mesh's data
    axis (one ``all_reduce`` of the three) when ``mesh`` has a group.

    ``seg``/``idx``/``r`` are this rank's ``[chunk]`` block (int32 target,
    int fixed-side index, float32 rating), ``fixed`` the replicated
    ``[m, k]`` factors. ``layout="segment"``: three ``segment_sum`` kernel
    launches into ``n_segments + 1`` segments. ``layout="cumsum"``: the
    block's run ``ends``/``cols`` (:func:`als_run_tables`) reduce it
    without atomics."""
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    k = fixed.shape[1]
    rows = seg.shape[0]
    y = fixed[idx.long()]                  # gather of the fixed side
    a_w, b_w = _weights(r, alpha, implicit)
    outer = ((y[:, :, None] * y[:, None, :])
             * a_w[:, None, None]).reshape(rows, k * k)
    n1 = n_segments + 1
    if layout == "segment":
        a = segment_sum(outer, seg, n1)[:-1]
        b = segment_sum(b_w[:, None] * y, seg, n1)[:-1]
        cnt = segment_sum(torch.ones_like(r), seg, n1)[:-1]
        if mesh is None or mesh.group(mesh.DATA_AXIS) is None:
            return a.reshape(n_segments, k, k), b, cnt
        packed = torch.cat([a, b, cnt[:, None]], dim=1)
    else:
        from flinkml_tpu_torch.ops.sparse import chunked_run_totals

        payload = torch.cat(
            [outer, b_w[:, None] * y, torch.ones((rows, 1), dtype=y.dtype,
                                                 device=y.device)], dim=1)
        runs = chunked_run_totals(payload, ends)    # [max_runs, k²+k+1]
        packed = torch.zeros((n1, k * k + k + 1), dtype=y.dtype,
                             device=y.device)
        # Ascending targets; padding runs add exactly 0 onto the last one.
        packed.index_add_(0, cols.long(), runs)
        packed = packed[:-1]
    if mesh is not None and mesh.group(mesh.DATA_AXIS) is not None:
        from flinkml_tpu_torch.parallel.collectives import all_reduce_

        all_reduce_(mesh, packed)
    return (packed[:, : k * k].reshape(n_segments, k, k),
            packed[:, k * k: k * k + k], packed[:, -1])


def solve_factors(a, b, gram, reg: float, counts):
    """Batched solve of every target's system:
    ``(A + gram + λ·max(n,1)·I) x = b``.

    λ is floored at 1e-4: with regParam=0 an under-determined row (rating
    count < rank) has a singular system; the floor keeps every system SPD
    within float32 Cholesky tolerance. A system whose factorization still
    fails gives NaN factors (as the JAX package's ``cho_solve`` does)."""
    k = b.shape[1]
    lam = torch.clamp_min(reg * torch.clamp_min(counts, 1.0), 1e-4)
    eye = torch.eye(k, dtype=a.dtype, device=a.device)
    systems = a + gram[None, :, :] + lam[:, None, None] * eye[None, :, :]
    chol, info = torch.linalg.cholesky_ex(systems)
    x = torch.cholesky_solve(b[:, :, None], chol)[:, :, 0]
    return torch.where((info == 0)[:, None], x, x.new_tensor(float("nan")))


def _agree_id_vocab(local_ids: np.ndarray, mesh) -> np.ndarray:
    """Union the per-rank sorted unique id arrays: each rank's ids ride
    :func:`~flinkml_tpu_torch.iteration.stream_sync.gather_vectors`
    (float64, exact for integer |id| < 2**47), NaN-padded to the agreed
    max length; every rank computes the identical union. Returns int64
    when every id is integral, float64 otherwise. An empty local
    vocabulary is legal (that rank feeds only dummy chunks)."""
    from flinkml_tpu_torch.iteration.stream_sync import (
        agree_max,
        gather_vectors,
    )

    h = agree_max(int(local_ids.shape[0]), mesh)
    if h == 0:
        raise ValueError("training stream is empty on every process")
    pad = np.full(h, np.nan)
    pad[: local_ids.shape[0]] = np.asarray(local_ids, np.float64)
    rows = gather_vectors(pad, mesh)
    ids = np.unique(rows[np.isfinite(rows)])
    as_int = ids.astype(np.int64)
    if np.array_equal(as_int.astype(np.float64), ids):
        return as_int
    return ids


def _pad_coo(seg: np.ndarray, idx: np.ndarray, r: np.ndarray,
             n_dummy: int, multiple: int):
    """Pad the COO to ``multiple``; padded entries get segment id
    ``n_dummy`` (the dropped dummy row), fixed-side index 0, rating 0 —
    contributing nothing in either mode."""
    pad = (-seg.shape[0]) % multiple
    return (
        np.concatenate([seg, np.full(pad, n_dummy)]).astype(np.int32),
        np.concatenate([idx, np.zeros(pad, idx.dtype)]).astype(np.int32),
        np.concatenate([r, np.zeros(pad, r.dtype)]).astype(np.float32),
    )


def _gram(fixed: torch.Tensor, implicit: bool) -> torch.Tensor:
    k = fixed.shape[1]
    if implicit:
        return fixed.T @ fixed
    return torch.zeros((k, k), dtype=fixed.dtype, device=fixed.device)


def _local_chunks(arr: np.ndarray, p_size: int, rank: int, chunk: int,
                  device) -> torch.Tensor:
    """This rank's ``[n_chunks, chunk]`` blocks of a padded host COO
    column (chunk ``c`` of the global order is ``p_size`` blocks of
    ``chunk`` rows; rank ``i`` keeps block ``i``), on ``device``."""
    blocks = arr.reshape(-1, p_size, chunk)[:, rank]
    return torch.from_numpy(np.ascontiguousarray(blocks)).to(device)


def _half_step(mesh, coo, fixed: torch.Tensor, n_target: int, reg: float,
               implicit: bool, alpha: float, layout: str,
               run_tables=None) -> torch.Tensor:
    """One ALS half-step: solve all ``n_target`` factors given the fixed
    side. ``coo`` is this rank's device-resident ``(seg, idx, r)`` chunk
    blocks, each ``[n_chunks, chunk]``; ``run_tables`` its ``(ends,
    cols)`` blocks under the ``cumsum`` layout."""
    k = fixed.shape[1]
    seg, idx, r = coo
    a = torch.zeros((n_target, k, k), dtype=torch.float32, device=fixed.device)
    b = torch.zeros((n_target, k), dtype=torch.float32, device=fixed.device)
    cnt = torch.zeros((n_target,), dtype=torch.float32, device=fixed.device)
    for c in range(seg.shape[0]):
        extra = {} if run_tables is None else dict(
            ends=run_tables[0][c], cols=run_tables[1][c])
        pa, pb, pc = normal_eq_chunk(seg[c], idx[c], r[c], fixed, alpha,
                                     n_target, implicit, layout, mesh=mesh,
                                     **extra)
        a.add_(pa)
        b.add_(pb)
        cnt.add_(pc)
    return solve_factors(a, b, _gram(fixed, implicit), reg, cnt)


class ALS(StreamingEstimatorMixin, _ALSParams, Estimator):
    """Alternating least squares over (user, item, rating) tables.

    ``fit`` accepts, besides a single in-RAM :class:`Table`:

      - an **iterable of batch Tables** — the out-of-core path: the COO
        stream is cached once (spilling to ``cache_dir`` beyond
        ``cache_memory_budget_bytes``) while the id vocabularies
        accumulate; every half-step then replays the cache, building the
        target side's normal equations batch by batch;
      - a sealed :class:`~flinkml_tpu_torch.iteration.datacache.DataCache`
        whose batches carry this estimator's user/item/rating columns.

    On a ``mesh`` of several ranks a streamed fit takes each rank's own
    partition. ``checkpoint_manager`` + ``checkpoint_interval`` snapshot
    ``(user_factors, item_factors)`` every N outer iterations of the
    streamed fit; ``resume=True`` restores and continues exactly.
    ``layout`` picks the in-RAM fit's normal-equation reduction (module
    docstring); None, the default, takes the tuning table's
    ``als_reduction`` for the fit's device, else ``"segment"``
    (:func:`resolve_layout`).
    """

    # Rows per rank handed to one normal-equation chunk; bounds the
    # nnz×k² intermediate to chunk×k² per rank.
    CHUNK = 1 << 16

    #: The knob is ACCEPTED at construction so the fit-time refusal can
    #: explain WHY the embedding-sharded primitive does not apply to ALS
    #: training (see :meth:`_refuse_sharded_fit`).
    _SHARDING_PLAN_AWARE = True

    def __init__(self, layout: Optional[str] = None, **kwargs):
        if layout is not None:
            check_layout(layout)
        super().__init__(**kwargs)
        self.layout = layout

    def _refuse_sharded_fit(self) -> None:
        """ALS's wall is NOT factor storage — it is the half-step's
        normal-equation buffers (``A [n_users, k, k]`` / ``b [n_users,
        k]``), a vocab-sized working set that row-sharding the factor
        tables cannot cap. Refuse loudly and point at what does exist:
        :meth:`ALSModel.factor_tables` serves fitted factors sharded."""
        if self.sharding_plan is not None:
            raise ValueError(
                "ALS.fit does not thread a sharding_plan: the per-half-"
                "step normal-equation buffers (A [n, k, k] / b [n, k]) "
                "are vocab-sized regardless of how the factor tables "
                "shard, so an embedding-sharded plan would not cap the "
                "working set it promises to cap. Partition the id space "
                "upstream (or shrink rank) to fit the half-step; fitted "
                "factors CAN be served sharded — see "
                "ALSModel.factor_tables and docs/development/"
                "embeddings.md."
            )

    def _mesh_and_device(self):
        from flinkml_tpu_torch.device import default_device

        mesh = self.mesh
        if mesh is not None and mesh.group(mesh.DATA_AXIS) is None:
            mesh = None  # one rank: no collective
        device = default_device() if self.mesh is None else self.mesh.device
        return mesh, device

    def fit(self, *inputs) -> "ALSModel":
        self._refuse_sharded_fit()
        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
        self._reject_in_ram_checkpointing()
        users_raw = np.asarray(table.column(self.get(self.USER_COL)))
        items_raw = np.asarray(table.column(self.get(self.ITEM_COL)))
        ratings = np.asarray(
            table.column(self.get(self.RATING_COL)), dtype=np.float32
        )
        implicit = self.get(self.IMPLICIT_PREFS)
        if implicit and (ratings < 0).any():
            raise ValueError("implicitPrefs requires non-negative ratings")
        user_ids, u_idx = np.unique(users_raw, return_inverse=True)
        item_ids, i_idx = np.unique(items_raw, return_inverse=True)
        u_idx, i_idx = u_idx.reshape(-1), i_idx.reshape(-1)
        n_users, n_items = len(user_ids), len(item_ids)
        rank = self.get(self.RANK)
        reg = self.get(self.REG_PARAM)
        alpha = self.get(self.ALPHA)
        mesh, device = self._mesh_and_device()
        p = 1 if mesh is None else mesh.axis_size()
        me = 0 if mesh is None else mesh.axis_index()
        chunk = min(self.CHUNK, max(256, -(-len(ratings) // p)))

        rng = np.random.default_rng(self.get_seed())
        # Signed Gaussian init at scale 1/sqrt(rank); the first half-step
        # solves user factors from these, so no user init is needed.
        item_f = torch.from_numpy(
            rng.normal(scale=1.0 / np.sqrt(rank), size=(n_items, rank))
            .astype(np.float32)).to(device)

        chunk_g = p * chunk
        user_tabs = item_tabs = None
        layout = resolve_layout(self.layout)
        if layout == "cumsum":
            # Sort each side by target ONCE (the assignment is static
            # across iterations); padding ids (n_targets) sort last by
            # construction, so _pad_coo keeps the order.
            ou = np.argsort(u_idx, kind="stable")
            oi = np.argsort(i_idx, kind="stable")
            by_user = _pad_coo(u_idx[ou], i_idx[ou], ratings[ou], n_users,
                               chunk_g)
            by_item = _pad_coo(i_idx[oi], u_idx[oi], ratings[oi], n_items,
                               chunk_g)

            def place_tabs(tabs):
                # This rank's slice of each chunk's [p·max_runs] tables.
                ends, cols = tabs
                runs = ends.shape[1] // p
                return tuple(
                    torch.from_numpy(np.ascontiguousarray(
                        t.reshape(t.shape[0], p, runs)[:, me])).to(device)
                    for t in (ends, cols))

            user_tabs = place_tabs(als_run_tables(by_user[0], p, chunk))
            item_tabs = place_tabs(als_run_tables(by_item[0], p, chunk))
        else:
            by_user = _pad_coo(u_idx, i_idx, ratings, n_users, chunk_g)
            by_item = _pad_coo(i_idx, u_idx, ratings, n_items, chunk_g)
        user_coo = tuple(_local_chunks(a, p, me, chunk, device)
                         for a in by_user)
        item_coo = tuple(_local_chunks(a, p, me, chunk, device)
                         for a in by_item)
        for _ in range(self.get(self.MAX_ITER)):
            user_f = _half_step(mesh, user_coo, item_f, n_users, reg,
                                implicit, alpha, layout, user_tabs)
            item_f = _half_step(mesh, item_coo, user_f, n_items, reg,
                                implicit, alpha, layout, item_tabs)
        model = ALSModel()
        model.copy_params_from(self)
        model._set_factors(user_ids, user_f.cpu().numpy(), item_ids,
                           item_f.cpu().numpy())
        return model

    def _fit_stream(self, source) -> "ALSModel":
        """Out-of-core ALS (see class docstring): one caching pass
        accumulates the sorted id vocabularies; each half-step replays the
        cache in fixed ``chunk``-row slices, padding every batch, and
        accumulates the normal-equation partials on the device (the
        ``segment`` layout). Only one batch (plus prefetch depth) of the
        COO is on the device at a time.

        On a mesh of several ranks each rank feeds its own ratings
        partition: the id vocabularies are unioned exactly (numeric ids,
        |id| < 2**47 — :func:`_agree_id_vocab`), the per-half-step chunk
        count is agreed (drained ranks add all-padding dummy chunks, exact
        no-ops), ingest failures ride the held-error rendezvous, and the
        replicated factor pair checkpoints through one writer and an
        agreed commit."""
        from flinkml_tpu_torch.iteration.checkpoint import (
            begin_resume,
            save_replicated,
            should_snapshot,
        )
        from flinkml_tpu_torch.iteration.datacache import (
            DataCache,
            DataCacheWriter,
            PrefetchingDeviceFeed,
            device_put,
        )
        from flinkml_tpu_torch.iteration.stream_sync import (
            DeferredValidation,
            agree_max,
            agreed_restore,
            checked_ingest,
            entry_rows,
            gather_vectors,
        )
        from flinkml_tpu_torch.models._linear_sgd import multi_rank
        from flinkml_tpu_torch.parallel.dispatch import DispatchGuard

        multi = multi_rank(self.mesh)
        if self.resume and not isinstance(source, DataCache):
            raise ValueError(
                "resume=True requires a durable DataCache input: a one-shot "
                "stream cannot be replayed from the start after a failure"
            )
        user_col = self.get(self.USER_COL)
        item_col = self.get(self.ITEM_COL)
        rating_col = self.get(self.RATING_COL)
        implicit = self.get(self.IMPLICIT_PREFS)
        rank = self.get(self.RANK)
        reg = self.get(self.REG_PARAM)
        alpha = self.get(self.ALPHA)
        mesh = self.mesh if multi else None
        _, device = self._mesh_and_device()
        resume_epoch = begin_resume(
            self.checkpoint_manager, self.resume,
            self.mesh.num_devices if multi else 1)

        # -- pass 0: cache + per-batch uniques (one global sort at the end)
        user_parts = []
        item_parts = []
        nnz = 0

        def ingest(u, i, r):
            nonlocal nnz
            if not (u.shape[0] == i.shape[0] == r.shape[0]):
                raise ValueError(
                    "user/item/rating columns must have equal length, got "
                    f"{u.shape[0]}/{i.shape[0]}/{r.shape[0]}"
                )
            if implicit and (r < 0).any():
                raise ValueError(
                    "implicitPrefs requires non-negative ratings"
                )
            if multi:
                for arr, what in ((u, "user"), (i, "item")):
                    ok = np.issubdtype(arr.dtype, np.number)
                    if ok:
                        a64 = np.asarray(arr, np.float64)
                        ok = bool(
                            np.all(np.isfinite(a64))
                            and (a64.size == 0
                                 or np.abs(a64).max() < 2.0 ** 47)
                        )
                    if not ok:
                        raise ValueError(
                            "multi-process ALS streamed fit requires "
                            f"finite numeric {what} ids with |id| < 2**47 "
                            "(they are unioned exactly as float64 values)"
                        )
            user_parts.append(np.unique(u))
            item_parts.append(np.unique(i))
            nnz += r.shape[0]

        def batch_arrays(b):
            if isinstance(b, Table):
                return (
                    np.asarray(b.column(user_col)),
                    np.asarray(b.column(item_col)),
                    np.asarray(b.column(rating_col), np.float32),
                )
            return (
                np.asarray(b[user_col]),
                np.asarray(b[item_col]),
                np.asarray(b[rating_col], np.float32),
            )

        dv = DeferredValidation()

        def checked_add(b):
            ingest(*batch_arrays(b))

        if isinstance(source, DataCache):
            cache = source
            for _ in checked_ingest(cache.reader(), dv, checked_add, multi):
                pass
        else:
            writer = DataCacheWriter(
                self.cache_dir, self.cache_memory_budget_bytes
            )

            def add_append(b):
                u, i, r = batch_arrays(b)
                ingest(u, i, r)
                # The append is part of the checked step too (a rank-local
                # spill failure must ride the rendezvous).
                writer.append({user_col: np.array(u), item_col: np.array(i),
                               rating_col: np.array(r)})

            for _ in checked_ingest(source, dv, add_append, multi):
                pass
            cache = writer.finish()

        def local_unique(parts):
            return (
                np.unique(np.concatenate(parts)) if parts else np.empty(0)
            )

        if multi:
            # Rendezvous BEFORE any agreement: a held ingest error must
            # surface as itself, not as "stream is empty".
            dv.rendezvous(mesh, "stream ingest validation")
            nnz = int(round(gather_vectors(
                np.asarray([float(nnz)]), mesh
            ).sum()))
            if nnz == 0:
                raise ValueError("training stream is empty on every process")
            user_ids = _agree_id_vocab(local_unique(user_parts), mesh)
            item_ids = _agree_id_vocab(local_unique(item_parts), mesh)
        else:
            if nnz == 0:
                raise ValueError("training stream is empty")
            user_ids = local_unique(user_parts)
            item_ids = local_unique(item_parts)
        n_users, n_items = len(user_ids), len(item_ids)

        # Replayed batches dispatch in FIXED chunk-row slices (this rank's
        # share of one chunk), the in-RAM fit's CHUNK bound; nnz is the
        # global count, so every rank uses the same chunk.
        p = mesh.axis_size() if multi else 1
        chunk = min(self.CHUNK, max(256, -(-nnz // p)))

        steps_half = None
        if multi:
            # Agreed chunk schedule per half-step: every rank adds the
            # same number of chunks; drained ranks fill with all-dummy
            # chunks (exact no-ops: every row lands in the dropped
            # segment).
            local_total = sum(
                -(-entry_rows(e) // chunk) for e in cache.entries
            )
            steps_half = agree_max(local_total, mesh)

        def replay_half(fixed, by_user: bool):
            """One half-step's accumulation over the replayed cache."""
            n_target = n_users if by_user else n_items
            k = fixed.shape[1]
            a = torch.zeros((n_target, k, k), dtype=torch.float32,
                            device=device)
            bvec = torch.zeros((n_target, k), dtype=torch.float32,
                               device=device)
            cnt = torch.zeros((n_target,), dtype=torch.float32,
                              device=device)
            guard = DispatchGuard()  # multi-rank backpressure

            def place(batch):
                u, i, r = batch_arrays(batch)
                u_idx = np.searchsorted(user_ids, u).astype(np.int32)
                i_idx = np.searchsorted(item_ids, i).astype(np.int32)
                seg, idx = (u_idx, i_idx) if by_user else (i_idx, u_idx)
                seg, idx, r = _pad_coo(seg, idx, r, n_target, chunk)
                return device_put(
                    tuple(x.reshape(-1, chunk) for x in (seg, idx, r)),
                    device)

            def add(seg, idx, r):
                pa, pb, pc = normal_eq_chunk(seg, idx, r, fixed, alpha,
                                             n_target, implicit, mesh=mesh)
                a.add_(pa)
                bvec.add_(pb)
                cnt.add_(pc)
                guard.after_dispatch(cnt)

            dispatched = 0
            feed = PrefetchingDeviceFeed(cache.reader(), place=place, depth=2)
            try:
                for segs, idxs, rs in feed:
                    for c in range(segs.shape[0]):
                        if steps_half is not None and dispatched >= steps_half:
                            raise RuntimeError(
                                "local cache yielded more chunks than the "
                                "agreed schedule — caches must be sealed "
                                "before planning"
                            )
                        add(segs[c], idxs[c], rs[c])
                        dispatched += 1
            finally:
                feed.close()
            if steps_half is not None and dispatched < steps_half:
                # Drained before the agreed schedule: dummy chunks keep the
                # collective count aligned across ranks.
                dseg, didx, dr = device_put((
                    np.full(chunk, n_target, np.int32),
                    np.zeros(chunk, np.int32),
                    np.zeros(chunk, np.float32)), device)
                while dispatched < steps_half:
                    add(dseg, didx, dr)
                    dispatched += 1
            guard.flush(cnt)
            return solve_factors(a, bvec, _gram(fixed, implicit), reg, cnt)

        start_epoch = 0
        if resume_epoch is None:
            rng = np.random.default_rng(self.get_seed())
            item_h = rng.normal(scale=1.0 / np.sqrt(rank),
                                size=(n_items, rank)).astype(np.float32)
            user_f = torch.zeros((n_users, rank), dtype=torch.float32,
                                 device=device)
        else:
            like = (np.zeros((n_users, rank), np.float32),
                    np.zeros((n_items, rank), np.float32))
            (user_h, item_h), start_epoch = agreed_restore(
                self.checkpoint_manager, resume_epoch, like, mesh
            )
            user_f = torch.from_numpy(
                np.asarray(user_h, np.float32)).to(device)
        item_f = torch.from_numpy(np.asarray(item_h, np.float32)).to(device)

        max_iter = self.get(self.MAX_ITER)
        for epoch in range(start_epoch, max_iter):
            user_f = replay_half(item_f, by_user=True)
            item_f = replay_half(user_f, by_user=False)
            if should_snapshot(self.checkpoint_manager,
                               self.checkpoint_interval, epoch + 1, max_iter):
                state = (user_f.cpu().numpy(), item_f.cpu().numpy())
                if multi:
                    save_replicated(
                        self.checkpoint_manager, state, epoch + 1, mesh
                    )
                else:
                    self.checkpoint_manager.save(state, epoch + 1)

        model = ALSModel()
        model.copy_params_from(self)
        model._set_factors(user_ids, user_f.cpu().numpy(), item_ids,
                           item_f.cpu().numpy())
        return model


class ALSModel(_ALSParams, Model):
    def __init__(self):
        super().__init__()
        self._user_ids: Optional[np.ndarray] = None
        self._item_ids: Optional[np.ndarray] = None
        self._user_factors: Optional[np.ndarray] = None
        self._item_factors: Optional[np.ndarray] = None

    def _set_factors(self, user_ids, user_factors, item_ids, item_factors):
        self._user_ids = np.asarray(user_ids)
        self._item_ids = np.asarray(item_ids)
        self._user_factors = np.asarray(user_factors, np.float64)
        self._item_factors = np.asarray(item_factors, np.float64)

    @property
    def user_factors(self) -> np.ndarray:
        self._require()
        return self._user_factors

    @property
    def item_factors(self) -> np.ndarray:
        self._require()
        return self._item_factors

    def set_model_data(self, *inputs: Table) -> "ALSModel":
        user_t, item_t = inputs
        self._set_factors(
            user_t.column("id"), user_t.column("factors"),
            item_t.column("id"), item_t.column("factors"),
        )
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [
            Table({"id": self._user_ids, "factors": self._user_factors}),
            Table({"id": self._item_ids, "factors": self._item_factors}),
        ]

    def _require(self) -> None:
        if self._user_factors is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def _positions(self, raw: np.ndarray, ids: np.ndarray):
        order = np.argsort(ids, kind="stable")
        sorted_ids = ids[order]
        pos = np.searchsorted(sorted_ids, raw)
        pos_c = np.minimum(pos, len(ids) - 1)
        found = sorted_ids[pos_c] == raw
        return order[pos_c], found

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        """Predict ratings for (user, item) rows; unseen ids → NaN (the
        upstream 'nan' cold-start strategy)."""
        (table,) = inputs
        self._require()
        users = np.asarray(table.column(self.get(self.USER_COL)))
        items = np.asarray(table.column(self.get(self.ITEM_COL)))
        u_pos, u_ok = self._positions(users, self._user_ids)
        i_pos, i_ok = self._positions(items, self._item_ids)
        pred = np.einsum(
            "nk,nk->n", self._user_factors[u_pos], self._item_factors[i_pos]
        )
        pred = np.where(u_ok & i_ok, pred, np.nan)
        return (table.with_column(self.get(self.PREDICTION_COL), pred),)

    def factor_tables(self, mesh=None, plan=None, hbm_budget_bytes=None):
        """The fitted factors as row-sharded
        :class:`~flinkml_tpu_torch.embeddings.EmbeddingTable`\\ s
        ``(user_table, item_table)`` — the serving-scale export
        (``table.lookup`` is bitwise stable at every world size). Plan and
        budget resolution are EmbeddingTable's (explicit plan >
        ``infer_plan`` under a budget > replicated)."""
        from flinkml_tpu_torch.embeddings import EmbeddingTable

        self._require()
        kw = dict(mesh=mesh, plan=plan, hbm_budget_bytes=hbm_budget_bytes)
        return (
            EmbeddingTable(
                "als/user", *self._user_factors.shape,
                rows=self._user_factors.astype(np.float32), **kw,
            ),
            EmbeddingTable(
                "als/item", *self._item_factors.shape,
                rows=self._item_factors.astype(np.float32), **kw,
            ),
        )

    def recommend_for_all_users(self, num_items: int):
        """Top ``num_items`` items per user: one ``[users, k] @ [k,
        items]`` matmul on the compute device, then the port's ``topk``
        kernel (``jax.lax.top_k``'s order). Returns ``(item_id_matrix
        [n_users, num_items], score_matrix)``."""
        from flinkml_tpu_torch.device import default_device
        from flinkml_tpu_torch.kernels.topk import top_k

        self._require()
        device = default_device()
        u = torch.from_numpy(self._user_factors.astype(np.float32)).to(device)
        v = torch.from_numpy(self._item_factors.astype(np.float32)).to(device)
        scores = torch.matmul(u, v.T)
        vals, idx = top_k(scores, min(num_items, len(self._item_ids)))
        return (self._item_ids[idx.cpu().numpy()], vals.cpu().numpy())

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require()
        return {
            "userIds": self._user_ids,
            "userFactors": self._user_factors,
            "itemIds": self._item_ids,
            "itemFactors": self._item_factors,
        }

    def _set_arrays(self, arrays) -> None:
        self._set_factors(
            arrays["userIds"], arrays["userFactors"],
            arrays["itemIds"], arrays["itemFactors"],
        )
