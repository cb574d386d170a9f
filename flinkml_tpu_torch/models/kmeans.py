"""KMeans — Lloyd's algorithm with random or k-means++ init.

The port's counterpart of ``flinkml_tpu.models.kmeans`` (reference:
``KMeans.java:79-335``, ``KMeansModel.java``, ``KMeansModelData.java``):

- Init: a seeded host choice of k distinct rows (``random``, the
  reference's ``selectRandomCentroids``) or k-means++ seeding, with the
  JAX package's numpy calls, so both packages start from the same
  centroids.
- The Lloyd loop runs on the compute device for ``maxIter`` steps with no
  host read in between: ``squared_distances`` → ``argmin`` → one-hot
  (padded rows weigh 0) → per-cluster sums ``onehot.T @ x`` and counts →
  new centroids; an empty cluster keeps its previous centroid. The JAX
  package runs the same body as one ``fori_loop`` program.
- Termination: ``maxIter`` only, as in the reference.

Dtype rule: the fit computes in the feature column's floating dtype (a
non-float column promotes to float64); the JAX estimator promotes to
float64 and computes in its x64 flag's dtype. ``KMeansModel.transform``
does the same with the query column.

``KMeansModel.transform_kernel`` (euclidean only) is the per-stage
nearest-centroid math as plain PyTorch, and the KMeans head of the
``fused_chain`` kernel on the card; it pins its input column, as the JAX
package's does.

**The streamed fit** (:func:`train_kmeans_stream`, the reference's
``ReplayOperator`` + point-caching ``SelectNearestCentroidOperator``):
``KMeans.fit`` over an iterable of batch Tables or a sealed
:class:`~flinkml_tpu_torch.iteration.datacache.DataCache`. Pass 0 caches a
one-shot stream (spilling past a memory budget) while a seeded
:class:`~flinkml_tpu_torch.utils.sampling.RowReservoir` samples the
initial centroids; each Lloyd epoch replays the cache through a
prefetching device feed, adding each batch's per-cluster sums and counts
(:func:`kmeans_partials`, the one-hot product, so the sums are the same
bits on every run) in batch order, and updates the centroids once.
Checkpoints snapshot the centroids every N epochs; a resume continues
from the newest one bit for bit. The streamed fit computes in float32,
as the JAX package's.

**On a mesh.** ``mesh=`` (a :class:`~flinkml_tpu_torch.parallel.
DeviceMesh`) runs the in-RAM Lloyd loop data parallel: every rank pads the
points to a multiple of ``8·P`` rows and keeps its block, and each step's
per-cluster sums and counts go through one ``all_reduce`` of ``[sums |
counts]`` (the JAX step's two ``psum``s), so every rank holds the same
centroids. ``KMeansModel`` scores rows sharded the same way. A streamed
fit on a mesh of several ranks is the multi-process stream: each rank
feeds its own partition, the ranks agree one padded height and one step
count an epoch (short ranks feed zero-weight dummies), the initial
centroids are drawn from the ranks' pooled reservoir samples, each
step's partials are summed over the ranks, and the mesh's first rank
commits the snapshots into the shared directory.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flinkml_tpu_torch.api import ColumnKernel, Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasK,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
)
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models import _linear_sgd
from flinkml_tpu_torch.models._data import (
    features_matrix,
    features_tensor,
    sharded_rows,
)
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.ops import blas
from flinkml_tpu_torch.ops.distance import DistanceMeasure
from flinkml_tpu_torch.params import IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.parallel import pad_to_multiple
from flinkml_tpu_torch.precision import chain_policy
from flinkml_tpu_torch.table import Table

#: Row tile of the padded point matrix (the JAX package's per-device
#: sublane tile); padded rows weigh 0.
ROW_TILE = 8


class _KMeansParams(
    HasDistanceMeasure, HasFeaturesCol, HasPredictionCol, HasK, HasMaxIter, HasSeed
):
    """Reference: KMeansParams. KMeans redefines ``k`` (clusters, default 2,
    > 1) over HasK's nearest-neighbors variant. ``initMode`` adds k-means++
    to the reference's random init."""

    K = IntParam(
        "k", "The number of clusters to create.", 2, ParamValidators.gt(1)
    )

    INIT_MODE = StringParam(
        "initMode", "Centroid initialization: random or k-means++.", "random",
        ParamValidators.in_array(["random", "k-means++"]),
    )


class KMeans(StreamingEstimatorMixin, _KMeansParams, Estimator):
    """Fits centroids on the compute device. ``fit`` accepts a
    :class:`Table` (the in-RAM fit), an iterable of batch Tables (the
    out-of-core streamed fit: the cache spills to ``cache_dir`` beyond
    ``cache_memory_budget_bytes``) or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache` whose batches
    carry the features column. ``checkpoint_manager``,
    ``checkpoint_interval`` and ``resume`` act on the streamed fit; the
    in-RAM fit refuses them (``ValueError``, as in the JAX package).

    ``mesh`` runs the in-RAM fit data parallel, and a streamed fit as the
    multi-process stream (each rank passes its own partition);
    ``sharding_plan`` and ``precision`` raise ``ValueError`` at
    construction (the mixin's), as in the JAX package, whose KMeans takes
    neither.
    """

    def fit(self, *inputs) -> "KMeansModel":
        (table,) = inputs
        k = self.get(_KMeansParams.K)
        measure = self.get(_KMeansParams.DISTANCE_MEASURE)
        if measure != "euclidean":
            raise ValueError(
                "KMeans currently supports the euclidean distance measure "
                f"(parity with the reference), got {measure!r}"
            )
        if isinstance(table, Table):
            self._reject_in_ram_checkpointing(
                "the in-RAM fit runs as one whole-loop device program"
            )
            x = features_matrix(table, self.get(_KMeansParams.FEATURES_COL),
                                dtype=None)
            if x.shape[0] < k:
                raise ValueError(
                    f"k={k} exceeds number of points {x.shape[0]}")
            centroids = train_kmeans(
                x,
                k=k,
                max_iter=self.get(_KMeansParams.MAX_ITER),
                seed=self.get_seed(),
                init_mode=self.get(_KMeansParams.INIT_MODE),
                mesh=self.mesh,
            )
        else:
            centroids = self._fit_stream(table, k)
        model = KMeansModel(mesh=self.mesh)
        model.copy_params_from(self)
        model.set_model_data(Table({"centroids": centroids[None, :, :]}))
        return model

    def _fit_stream(self, source, k: int) -> np.ndarray:
        from flinkml_tpu_torch.iteration.datacache import DataCache

        features_col = self.get(_KMeansParams.FEATURES_COL)
        if isinstance(source, DataCache):
            batches = source
        else:
            batches = ({"x": features_matrix(t, features_col)
                        .astype(np.float32)} for t in source)
        return train_kmeans_stream(
            batches,
            k=k,
            max_iter=self.get(_KMeansParams.MAX_ITER),
            seed=self.get_seed(),
            init_mode=self.get(_KMeansParams.INIT_MODE),
            cache_dir=self.cache_dir,
            memory_budget_bytes=self.cache_memory_budget_bytes,
            column=features_col if isinstance(source, DataCache) else "x",
            mesh=self.mesh,
            **self._checkpoint_kwargs(),
        )


class KMeansModel(_KMeansParams, Model):
    """Nearest-centroid prediction (broadcast-model pattern,
    ``KMeansModel.java``). With a ``mesh`` of several ranks, rows are
    scored sharded: each rank its block, the blocks gathered."""

    def __init__(self, mesh=None):
        from flinkml_tpu_torch.parallel.mesh import check_mesh

        super().__init__()
        check_mesh(mesh)
        self.mesh = mesh
        self._centroids: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table) -> "KMeansModel":
        (table,) = inputs
        self._set_arrays({"centroids": table.column("centroids")})
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"centroids": self._centroids[None, :, :]})]

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require_model()
        return {"centroids": self._centroids}

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        c = np.asarray(arrays["centroids"], dtype=np.float64)
        self._centroids = c.reshape(c.shape[-2], c.shape[-1])

    @property
    def centroids(self) -> np.ndarray:
        self._require_model()
        return self._centroids

    def _require_model(self) -> None:
        if self._centroids is None:
            raise ValueError("Model data is not set; call set_model_data or fit first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        fcol = self.get(_KMeansParams.FEATURES_COL)
        measure = DistanceMeasure.get_instance(
            self.get(_KMeansParams.DISTANCE_MEASURE)
        )

        def nearest(x):
            centroids = torch.from_numpy(self._centroids).to(x.device, x.dtype)
            return measure.nearest(x, centroids)

        if self.mesh is not None and self.mesh.num_devices > 1:
            assign = sharded_rows(self.mesh,
                                  features_matrix(table, fcol, dtype=None),
                                  nearest)
        else:
            assign = nearest(features_tensor(table, fcol))
        return (
            table.with_column(self.get(_KMeansParams.PREDICTION_COL), assign),
        )

    def transform_kernel(self) -> Optional[ColumnKernel]:
        """Nearest-centroid assignment as a chainable kernel: the per-stage
        path's euclidean ``nearest`` (argmin of ``squared_distances``, an
        int64 index) in the feature column's dtype, the centroids as a
        constant. Other distance measures keep the per-stage path."""
        if self._centroids is None:
            return None
        if self.get(_KMeansParams.DISTANCE_MEASURE) != "euclidean":
            return None
        fcol = self.get(_KMeansParams.FEATURES_COL)
        pcol = self.get(_KMeansParams.PREDICTION_COL)

        def fn(cols, consts, valid):
            x = cols[fcol]
            if x.dim() == 1:
                x = x.reshape(-1, 1)
            if not x.dtype.is_floating_point:
                x = x.to(torch.float64)
            pol = chain_policy()
            if pol is not None and pol.declared:
                # The distances at policy.compute, their sums too (plain
                # dtype propagation, as the JAX kernel): the precision
                # check refuses this stage where accum is wider.
                x = x.to(pol.compute_dtype)
            c = torch.as_tensor(consts["centroids"]).to(device=x.device,
                                                         dtype=x.dtype)
            return {pcol: torch.argmin(blas.squared_distances(x, c), dim=-1)}

        return ColumnKernel(
            input_cols=(fcol,), output_cols=(pcol,), fn=fn,
            constants={"centroids": self._centroids},
            fingerprint=("KMeansModel", fcol, pcol, "euclidean"),
            # As the JAX package: the input column is an eager output.
            pin_inputs=True,
            accumulates="compute",
        )


def kmeans_partials(xb: torch.Tensor, wb: torch.Tensor,
                    centroids: torch.Tensor):
    """One Lloyd pass's per-cluster ``(sums [k, d], counts [k])`` over the
    rows ``xb`` weighed by ``wb`` (0 for padding): argmin over the squared
    distances, then a weighted one-hot product (a matrix product, not an
    atomic scatter, so the sums are the same bits on every run)."""
    k = centroids.shape[0]
    assign = torch.argmin(blas.squared_distances(xb, centroids), dim=-1)
    onehot = F.one_hot(assign, k).to(xb.dtype) * wb[:, None]
    return onehot.T @ xb, torch.sum(onehot, dim=0)


def update_centroids(sums: torch.Tensor, counts: torch.Tensor,
                     centroids: torch.Tensor) -> torch.Tensor:
    """The cluster means; an empty cluster keeps its previous centroid."""
    safe = torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, centroids)


def _reduce_partials(mesh, sums: torch.Tensor, counts: torch.Tensor):
    """``(sums, counts)`` summed over the mesh's data axis by one
    ``all_reduce`` of ``[sums | counts]``; untouched without a mesh."""
    if mesh is None or mesh.group(mesh.DATA_AXIS) is None:
        return sums, counts
    from flinkml_tpu_torch.parallel.collectives import all_reduce_

    n = sums.numel()
    buf = all_reduce_(mesh, torch.cat([sums.reshape(-1), counts]))
    return buf[:n].reshape(sums.shape), buf[n:]


def lloyd(xd: torch.Tensor, wd: torch.Tensor, centroids: torch.Tensor,
          max_iter: int, mesh=None) -> torch.Tensor:
    """``max_iter`` Lloyd steps on the device from ``centroids``; no host
    read in between. ``wd`` weighs each row (0 for padding). Over a
    ``mesh``, ``xd``/``wd`` are this rank's block and each step's partials
    are summed over the ranks."""
    for _ in range(max_iter):
        sums, counts = _reduce_partials(
            mesh, *kmeans_partials(xd, wd, centroids))
        centroids = update_centroids(sums, counts, centroids)
    return centroids


def _kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding: each next centroid sampled ∝ distance² to the
    nearest chosen one."""
    centroids = [x[rng.integers(x.shape[0])]]
    d2 = ((x - centroids[0]) ** 2).sum(-1)
    for _ in range(1, k):
        probs = d2 / d2.sum() if d2.sum() > 0 else np.full(len(x), 1.0 / len(x))
        nxt = x[rng.choice(x.shape[0], p=probs)]
        centroids.append(nxt)
        d2 = np.minimum(d2, ((x - nxt) ** 2).sum(-1))
    return np.stack(centroids)


def init_centroids(x: np.ndarray, k: int, seed: int,
                   init_mode: str = "random") -> np.ndarray:
    """The seeded initial centroids, drawn as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    if init_mode == "k-means++":
        return _kmeans_pp_init(x, k, rng)
    init_idx = rng.choice(x.shape[0], size=k, replace=False)
    return np.ascontiguousarray(x[init_idx])


def train_kmeans(
    x: np.ndarray,
    k: int,
    mesh=None,
    max_iter: int = 20,
    seed: int = 0,
    init_mode: str = "random",
    initial_centroids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Returns centroids [k, d] (in ``x``'s dtype); the whole loop runs on
    the compute device (over ``mesh``, data parallel on its ranks, every
    rank passing the same ``x``). ``initial_centroids`` overrides the
    seeded init (tests, warm restarts)."""
    _linear_sgd.check_mesh(mesh)
    if initial_centroids is not None:
        start = np.asarray(initial_centroids, x.dtype)
    else:
        start = init_centroids(x, k, seed, init_mode)
    xd, wd, _ = prepare_kmeans_data(x, mesh)
    centroids = lloyd(xd, wd, torch.from_numpy(start).to(xd.device), max_iter,
                      mesh)
    return centroids.cpu().numpy()


def prepare_kmeans_data(x: np.ndarray, mesh=None):
    """Pad and mask the points and move them to the compute device; returns
    ``(xd, wd, n_valid)``. Rows pad to a multiple of :data:`ROW_TILE` times
    the mesh's data axis P (1 without a mesh); padded rows weigh 0, so they
    never influence centroids. Over a mesh ``xd``/``wd`` are this rank's
    block."""
    _linear_sgd.check_mesh(mesh)
    x_pad, n_valid = pad_to_multiple(x, ROW_TILE * _linear_sgd.p_size(mesh))
    w = np.zeros(x_pad.shape[0], dtype=x.dtype)
    w[:n_valid] = 1.0
    xd, wd = _linear_sgd.shard_rows(mesh, (x_pad, w), default_device()
                                    if mesh is None else mesh.device)
    return xd, wd, n_valid


def train_kmeans_stream(
    batches,
    k: int,
    mesh=None,
    max_iter: int = 20,
    seed: int = 0,
    init_mode: str = "random",
    cache_dir: Optional[str] = None,
    memory_budget_bytes: Optional[int] = None,
    prefetch_depth: int = 2,
    column: str = "x",
    init_sample_size: int = 65_536,
    initial_centroids: Optional[np.ndarray] = None,
    checkpoint_manager=None,
    checkpoint_interval: int = 0,
    resume: bool = False,
    listeners: Sequence = (),
) -> np.ndarray:
    """Out-of-core Lloyd over a one-shot stream of batch dicts (or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache`), with one
    batch (plus the prefetch depth) on the device at a time; returns the
    float32 centroids ``[k, d]`` on the host.

    - **Pass 0** caches the stream (spilling beyond
      ``memory_budget_bytes`` into ``cache_dir``) while a seeded
      :class:`~flinkml_tpu_torch.utils.sampling.RowReservoir` samples it:
      ``init_mode="random"`` takes k reservoir rows in a shuffled order,
      ``"k-means++"`` seeds from an ``init_sample_size`` sample;
      ``initial_centroids`` overrides both. A sealed cache is sampled by
      one read.
    - **Each Lloyd epoch** replays the cache through a
      :class:`~flinkml_tpu_torch.iteration.datacache.PrefetchingDeviceFeed`,
      each batch padded to a multiple of :data:`ROW_TILE` rows of zero
      weight, adds the batches' :func:`kmeans_partials` in batch order and
      updates the centroids once (an empty cluster keeps its centroid).
    - **Checkpoints:** ``checkpoint_manager`` + ``checkpoint_interval``
      save the centroids every N epochs and at the end; ``resume=True``
      restores the newest snapshot and continues, bit for bit with the
      uninterrupted run (each epoch is a function of the centroids and the
      cache). Resume needs a durable ``DataCache``: a one-shot stream
      cannot be replayed from its start.
    - ``listeners`` fire at every epoch boundary with the centroids (a
      device tensor) and at the end.
    - ``mesh`` of several ranks: each rank passes its own partition. Pass
      0 validates every batch, a failure on one rank aborting every rank;
      the ranks agree the schedule
      (:class:`~flinkml_tpu_torch.iteration.stream_sync.
      SyncedReplayPlan`: each batch padded to one height, dummies after a
      short rank's batches) and the feature dim, ``k`` is held against
      the global row count, the random or k-means++ init draws from the
      ranks' reservoirs pooled (:func:`~flinkml_tpu_torch.iteration.
      stream_sync.pooled_sample`), each step's partials are summed over
      the ranks in one ``all_reduce``, and the mesh's first rank commits
      the snapshots. Every rank ends with the same bits.

    The JAX package's ``flinkml_tpu.models.kmeans.train_kmeans_stream``,
    with its draws, its padding and its error messages.
    """
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
    from flinkml_tpu_torch.iteration.runtime import notify_epoch_listeners
    from flinkml_tpu_torch.iteration.stream_sync import (
        DeferredValidation,
        SyncedReplayPlan,
        agree_feature_dim,
        agreed_restore,
        checked_ingest,
        gather_vectors,
        pad_rows_to,
        pooled_sample,
    )
    from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
    from flinkml_tpu_torch.utils.sampling import RowReservoir

    _linear_sgd.check_mesh(mesh)
    multi = _linear_sgd.multi_rank(mesh)
    if resume and not isinstance(batches, DataCache):
        raise ValueError(
            "resume=True requires a durable DataCache input: a one-shot "
            "stream cannot be replayed from the start after a failure"
        )
    # The resume target is decided before pass 0, so a restore skips the
    # reservoir pass and the seeding whose centroids it would discard.
    resume_epoch = begin_resume(
        checkpoint_manager, resume,
        mesh.num_devices if multi else _linear_sgd._P_SIZE)
    device = default_device() if mesh is None else mesh.device
    n_feat = [None]  # the first batch's feature dim; every batch must match

    def check_dims(x):
        if x.ndim != 2:
            raise ValueError(f"stream batches must be [n, d], got {x.shape}")
        if x.shape[0] == 0:
            raise ValueError("stream batch has zero rows; drop empty batches")
        if n_feat[0] is None:
            n_feat[0] = x.shape[1]
        elif x.shape[1] != n_feat[0]:
            raise ValueError(
                f"batch feature dim {x.shape[1]} != first batch's {n_feat[0]}"
            )

    def ingest(b):
        x = np.asarray(b[column], np.float32)
        check_dims(x)
        return x

    def place(batch):
        x_pad, n_valid = pad_to_multiple(ingest(batch), ROW_TILE)
        w = np.zeros(x_pad.shape[0], np.float32)
        w[:n_valid] = 1.0  # padded rows never influence centroids
        return device_put((x_pad, w), device)

    def fixed_place(height: int, dim: int):
        """The multi-process placement: every step is ``height`` rows on
        every rank (weight-0 padding, all-zero dummies)."""

        def place_multi(batch):
            if "_dummy" in batch:
                x_pad = np.zeros((height, dim), np.float32)
                w = np.zeros(height, np.float32)
            else:
                x = np.asarray(batch[column], np.float32)
                x_pad = pad_rows_to(x, height)
                w = pad_rows_to(np.ones(x.shape[0], np.float32), height)
            return device_put((x_pad, w), device)

        return place_multi

    # -- pass 0: cache (unless sealed) + reservoir sample for the init -----
    reservoir_cap = k if init_mode == "random" else max(k, init_sample_size)
    need_init = initial_centroids is None and resume_epoch is None
    reservoir = RowReservoir(reservoir_cap, seed=seed)
    # On a mesh the source's and the checks' failures are held for one
    # agreement before any planning collective; a sealed cache is read
    # (validated) even when no init needs it, so that no batch fails on
    # one rank at replay, mid-collective.
    dv = DeferredValidation()
    if isinstance(batches, DataCache):
        cache = batches
        if need_init or multi:
            for x in checked_ingest(cache.reader(), dv, ingest, multi):
                if need_init:
                    reservoir.add(x)
    else:
        writer = DataCacheWriter(cache_dir, memory_budget_bytes)

        def ingest_append(b):
            x = ingest(b)
            writer.append({column: np.array(x)})
            return x

        for x in checked_ingest(batches, dv, ingest_append, multi):
            if need_init:
                reservoir.add(x)
        cache = writer.finish()
    dim = n_feat[0] or 0
    plan = None
    if multi:
        dv.rendezvous(mesh, "stream ingest validation")
        plan = SyncedReplayPlan.create(cache, mesh, ROW_TILE)
        dim = agree_feature_dim(cache, column, mesh, local_dim=dim)
        total_rows = int(gather_vectors(
            np.asarray([cache.num_rows], np.float64), mesh).sum())
    else:
        total_rows = cache.num_rows
    if total_rows < k:  # on a mesh a replicated value: every rank raises
        raise ValueError(f"k={k} exceeds number of points {total_rows}")

    rng = np.random.default_rng(seed)
    start_epoch = 0
    if resume_epoch is not None:
        # One cached batch gives the feature dim (agreed on a mesh).
        d_feat = dim if multi else np.asarray(
            next(iter(cache.reader()))[column]).shape[1]
        centroids, start_epoch = agreed_restore(
            checkpoint_manager, resume_epoch,
            np.zeros((k, d_feat), np.float32), mesh if multi else None)
    elif initial_centroids is not None:
        centroids = np.asarray(initial_centroids, np.float32)
        if centroids.shape[0] != k:
            raise ValueError(
                f"initial_centroids has {centroids.shape[0]} rows, need {k}"
            )
    else:
        sample = reservoir.sample()
        if multi:
            # One global sample from every rank's, the same on each.
            sample = pooled_sample(sample, cache.num_rows, reservoir_cap,
                                   seed, mesh)
        if init_mode == "k-means++":
            centroids = _kmeans_pp_init(sample, k, rng).astype(np.float32)
        else:
            # The reservoir is the uniform k-row sample; shuffled as the
            # reference's selection is (KMeans.java:314-335).
            centroids = sample[rng.permutation(sample.shape[0])[:k]]

    guard = DispatchGuard()  # bounded in-flight steps (a no-op alone)
    reduce_mesh = mesh if multi else None
    cent = torch.from_numpy(np.ascontiguousarray(centroids)).to(device)
    for epoch in range(start_epoch, max_iter):
        sums = counts = None
        if multi:
            src = plan.epoch_batches(cache.reader(), lambda: {"_dummy": True})
            place_fn = fixed_place(plan.local_height, dim)
        else:
            src, place_fn = cache.reader(), place
        feed = PrefetchingDeviceFeed(src, place=place_fn, depth=prefetch_depth)
        try:
            for xb, wb in feed:
                s, c = _reduce_partials(reduce_mesh,
                                        *kmeans_partials(xb, wb, cent))
                sums = s if sums is None else sums + s
                counts = c if counts is None else counts + c
                counts = guard.after_dispatch(counts)
        finally:
            feed.close()
        if sums is None:
            raise ValueError("training stream is empty")
        counts = guard.flush(counts)
        cent = update_centroids(sums, counts, cent)
        if should_snapshot(checkpoint_manager, checkpoint_interval,
                           epoch + 1, max_iter):
            if multi:
                save_replicated(checkpoint_manager, cent.cpu().numpy(),
                                epoch + 1, mesh)
            else:
                checkpoint_manager.save(cent.cpu().numpy(), epoch + 1)
        if listeners:
            cent = notify_epoch_listeners(listeners, epoch, cent)
    if checkpoint_manager is not None:
        checkpoint_manager.wait()  # surface a failed final async write
    for listener in listeners:
        listener.on_iteration_terminated(cent)
    return cent.cpu().numpy()
