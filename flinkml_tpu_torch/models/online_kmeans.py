"""OnlineKMeans — decayed mini-batch k-means over a stream.

The port's counterpart of ``flinkml_tpu.models.online_kmeans`` (apache
flink-ml's ``OnlineKMeans``): one centroid update per arriving batch, fed
to :func:`flinkml_tpu_torch.iteration.iterate`, with the decay rule of
Spark's streaming k-means and flink-ml::

    n'       = decay * n + count_batch
    centroid = (decay * n * centroid + sum_batch) / n'      (n' > 0)

``decayFactor`` 1 gives the running mini-batch mean; 0 forgets history
each batch. Initial centroids come from a fitted ``KMeansModel`` through
``set_initial_model_data``, or else from ``k`` seeded random rows of the
first batch. Everything computes in float64, as the JAX step does (it
casts each batch to float64): the batch's assignment pass
(:func:`_batch_stats`: squared distances, argmin, a one-hot product, so
the sums are the same bits on every run) and the decay rule, on the
compute device.

The carry ``{"centroids", "weights", "version"}`` is checkpointed in the
JAX package's layout, so a snapshot of either package resumes in the
other, and saved models cross packages both ways. ``sentinel=`` and
``recovery=`` thread the numerics sentinel and the rollback-and-quarantine
policy of :mod:`flinkml_tpu_torch.recovery` through ``iterate``; the
model's ``recovery_summary`` records what the recovery did.

**Several processes.** In a process group of more than one rank each
rank feeds its own partition: the first batch's dim is agreed over the
ranks, the initial centroids are ``k`` rows drawn from the ranks' first
batches pooled (:func:`~flinkml_tpu_torch.iteration.stream_sync.
pooled_sample`), and every agreed step sums the batch statistics over the
ranks in one ``all_reduce`` and applies the decay rule once (a drained
rank feeds zero-weight dummies). It computes in float32, as the JAX
package's multi-process step does; the centroids are the same bits on
every rank. Checkpoints, the sentinel and recovery on that path are
refused, as in the JAX package.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasDecayFactor,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasPredictionCol,
    HasSeed,
)
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.models.kmeans import kmeans_partials
from flinkml_tpu_torch.ops.distance import DistanceMeasure
from flinkml_tpu_torch.params import IntParam, ParamValidators
from flinkml_tpu_torch.table import Table


class _OnlineKMeansParams(
    HasFeaturesCol, HasPredictionCol, HasGlobalBatchSize, HasDecayFactor,
    HasSeed,
):
    K = IntParam(
        "k", "The number of clusters to create.", 2, ParamValidators.gt(1)
    )


def _batch_stats(x: torch.Tensor, centroids: torch.Tensor):
    """One assignment pass: the batch's per-centroid sums ``[k, d]`` and
    counts ``[k]``: KMeans' weighted one-hot product at unit weights (a
    one-hot times 1 is itself: the JAX ``_batch_stats``' unweighted
    product)."""
    return kmeans_partials(x, torch.ones(x.shape[0], dtype=x.dtype,
                                         device=x.device), centroids)


def _decayed_update(centroids, weights, sums, counts, decay: float):
    """The decay rule: ``(centroids, weights)`` after one batch. A centroid
    whose decayed weight is 0 keeps its place."""
    old_w = weights * decay
    new_w = old_w + counts
    safe = torch.clamp_min(new_w, 1e-12)[:, None]
    updated = (old_w[:, None] * centroids + sums) / safe
    return torch.where(new_w[:, None] > 0, updated, centroids), new_w


class OnlineKMeans(_OnlineKMeansParams, Estimator):
    """Decayed mini-batch k-means: ``fit(table)`` consumes
    ``globalBatchSize`` mini-batches of one Table, ``fit_stream(batches)``
    an iterable of batch Tables (one update each)."""

    def __init__(self, mesh=None):
        from flinkml_tpu_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
        super().__init__()
        self.mesh = mesh
        self._initial_centroids: Optional[np.ndarray] = None

    def set_initial_model_data(self, *inputs: Table) -> "OnlineKMeans":
        """Warm start from a (bounded) KMeansModel's model-data table."""
        (table,) = inputs
        c = np.asarray(table.column("centroids"), dtype=np.float64)
        self._initial_centroids = c.reshape(c.shape[-2], c.shape[-1])
        return self

    def fit(self, *inputs: Table) -> "OnlineKMeansModel":
        """Consume the table as a stream of ``globalBatchSize``
        mini-batches."""
        (table,) = inputs
        return self.fit_stream(table.batches(self.get(self.GLOBAL_BATCH_SIZE)))

    def fit_stream(
        self,
        batches: Iterable[Table],
        *,
        checkpoint_manager=None,
        checkpoint_interval: int = 0,
        resume: bool = False,
        stream_resume: str = "replay",
        sentinel=None,
        recovery=None,
    ) -> "OnlineKMeansModel":
        """One decayed centroid update per arriving batch.

        ``batches`` is an iterable of batch Tables, or a
        :class:`~flinkml_tpu_torch.data.Dataset` or
        :class:`~flinkml_tpu_torch.data.ElasticFeed` handed to ``iterate``
        whole (its cursor rides every snapshot; a snapshot records the
        feed's world). ``checkpoint_manager`` (+ ``checkpoint_interval``)
        snapshots the carry (centroids, decayed weights, model version)
        every N consumed batches and at the end; ``resume=True`` continues
        from the newest valid snapshot, the same bits as the uninterrupted
        run. ``stream_resume``: ``"replay"`` skips the consumed prefix of
        a source that restarts from its beginning, ``"continue"`` consumes
        a live stream from the front. ``sentinel``/``recovery``: the
        numerics sentinel and the rollback-and-quarantine policy (see
        ``OnlineLogisticRegression.fit_stream``); a healed fit equals the
        same stream without the quarantined batches. In a process group of
        several ranks each rank passes its own partition (the module
        docstring's "Several processes"; over ``mesh``, else a mesh of
        every rank), and a checkpoint manager, ``resume``, a sentinel or a
        recovery policy is refused.
        """
        from flinkml_tpu_torch.iteration import (
            IterationConfig,
            TerminateOnMaxIter,
            iterate,
        )
        from flinkml_tpu_torch.iteration.checkpoint import begin_resume
        from flinkml_tpu_torch.models._streaming import (
            feed_world_size,
            peek_stream,
        )
        from flinkml_tpu_torch.models.online_logistic_regression import (
            _process_count,
        )

        k = self.get(self.K)
        decay = self.get(self.DECAY_FACTOR)
        fcol = self.get(self.FEATURES_COL)
        rng = np.random.default_rng(self.get_seed())
        config = IterationConfig(
            TerminateOnMaxIter(2**31 - 1),
            checkpoint_interval=checkpoint_interval,
            checkpoint_manager=checkpoint_manager,
            stream_resume=stream_resume,
            sentinel=sentinel,
            recovery=recovery,
        )
        if _process_count() > 1:
            if (checkpoint_manager is not None or resume
                    or sentinel is not None or recovery is not None):
                raise NotImplementedError(
                    "checkpoint/resume and sentinel/recovery for the "
                    "multi-process online stream path are not wired (as in "
                    "the JAX package); run the checkpointing or "
                    "self-healing fit single-process"
                )
            return self._fit_stream_multiprocess(batches, k, decay, fcol,
                                                 rng)
        restore_epoch = begin_resume(checkpoint_manager, resume,
                                     world_size=feed_world_size(batches))

        # The first batch: the initial centroids draw from it (without
        # initial model data) and it fixes the carry's shapes for restore.
        first, stream = peek_stream(batches)
        if first is None:
            empty = self._model_from_empty_stream(
                checkpoint_manager, restore_epoch
            )
            if empty is not None:
                return empty
            raise ValueError("training stream is empty")
        x0 = features_matrix(first, fcol)   # float64
        device = default_device()

        def dev(a):
            if isinstance(a, np.ndarray) and not a.flags.writeable:
                a = np.array(a)  # torch.as_tensor wants a writable array
            return torch.as_tensor(a).to(device=device, dtype=torch.float64)

        if restore_epoch is not None:
            # A snapshot overwrites the init: no draw (a resumed live
            # stream's first batch is not the draw batch), only shapes.
            centroids0 = np.zeros((k, x0.shape[1]))
        elif self._initial_centroids is not None:
            centroids0 = self._initial_centroids
        else:
            if x0.shape[0] < k:
                raise ValueError(
                    f"first batch has {x0.shape[0]} rows < k={k}; "
                    "increase globalBatchSize or provide initial model data"
                )
            centroids0 = x0[rng.choice(x0.shape[0], size=k, replace=False)]
        state = {"centroids": dev(centroids0),
                 "weights": torch.zeros(k, dtype=torch.float64, device=device),
                 "version": 0}

        def step(carry, batch_table, epoch):
            # A restored carry comes back from the checkpoint as numpy.
            cent = dev(carry["centroids"])
            x = dev(features_matrix(batch_table, fcol))   # float64
            sums, counts = _batch_stats(x, cent)
            cent, weights = _decayed_update(cent, dev(carry["weights"]),
                                            sums, counts, decay)
            return {"centroids": cent, "weights": weights,
                    "version": int(carry["version"]) + 1}, None

        result = iterate(step, state, stream, config, resume=resume)
        final = result.state
        model = self._model(torch.as_tensor(final["centroids"]).cpu().numpy(),
                            int(final["version"]))
        model.recovery_summary = result.recovery
        return model

    def _fit_stream_multiprocess(self, batches, k, decay, fcol, rng):
        """The multi-process stream (the module docstring's "Several
        processes")."""
        import itertools

        from flinkml_tpu_torch.iteration.datacache import device_put
        from flinkml_tpu_torch.iteration.stream_sync import (
            agree_first_item_dim,
            pooled_sample,
            synced_padded_stream,
        )
        from flinkml_tpu_torch.models.kmeans import _reduce_partials
        from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
        from flinkml_tpu_torch.parallel.mesh import DeviceMesh

        mesh = self.mesh if self.mesh is not None else DeviceMesh()
        device = mesh.device
        d_seen = [None]

        def check(x):
            if x.ndim != 2 or x.shape[0] == 0:
                raise ValueError(
                    f"stream batches must be non-empty [n, d], got {x.shape}"
                )
            if d_seen[0] is None:
                d_seen[0] = x.shape[1]
            elif x.shape[1] != d_seen[0]:
                raise ValueError(
                    f"batch feature dim {x.shape[1]} != first batch's "
                    f"{d_seen[0]}"
                )

        first, rest, dim = agree_first_item_dim(
            (features_matrix(t, fcol).astype(np.float32) for t in batches),
            check, lambda x: x.shape[1], mesh)
        d_seen[0] = dim
        if self._initial_centroids is not None:
            centroids = np.asarray(self._initial_centroids, np.float32)
        else:
            # The one-process draw takes k rows of the first batch; here
            # "the first batch" is every rank's first batch, pooled.
            if first is None:
                local, local_rows = np.zeros((0, dim), np.float32), 0
            else:
                take = min(k, first.shape[0])
                local = first[rng.choice(first.shape[0], size=take,
                                         replace=False)]
                local_rows = first.shape[0]
            centroids = pooled_sample(local, local_rows, k, self.get_seed(),
                                      mesh)
            if centroids.shape[0] < k:
                raise ValueError(
                    f"first batches hold {centroids.shape[0]} rows < k={k}; "
                    "increase globalBatchSize or provide initial model data"
                )
        cent = torch.from_numpy(np.ascontiguousarray(centroids)).to(device)
        weights = torch.zeros(k, dtype=torch.float32, device=device)
        guard = DispatchGuard()
        stream = itertools.chain([first] if first is not None else [], rest)
        version = 0
        for (x_pad,), valid, _h in synced_padded_stream(
                ((x,) for x in stream), mesh, check=lambda item: check(item[0]),
                row_tile=8, dummy_cols=((dim,),)):
            xb, wb = device_put((x_pad, valid), device)
            sums, counts = _reduce_partials(mesh,
                                            *kmeans_partials(xb, wb, cent))
            cent, weights = _decayed_update(cent, weights, sums, counts,
                                            decay)
            version += 1
            guard.after_dispatch(cent)
        guard.flush(cent)
        return self._model(cent.cpu().numpy(), version)

    def _model(self, centroids, version: int) -> "OnlineKMeansModel":
        model = OnlineKMeansModel()
        model.copy_params_from(self)
        model._centroids = np.asarray(centroids, dtype=np.float64)
        model._model_version = version
        return model

    def _model_from_empty_stream(
        self, manager, restore_epoch
    ) -> Optional["OnlineKMeansModel"]:
        """The empty streams that are not errors: a resumed run whose live
        tail is already exhausted returns the checkpointed model, and a
        warm-started run returns the initial model data at version 0.
        None when the empty stream is an error."""
        if restore_epoch is not None and manager is not None:
            state, _ = manager.restore_latest(
                like={"centroids": 0, "weights": 0, "version": 0}
            )
            return self._model(state["centroids"], int(state["version"]))
        if self._initial_centroids is not None:
            return self._model(self._initial_centroids, 0)
        return None


class OnlineKMeansModel(_OnlineKMeansParams, Model):
    """Nearest-centroid prediction; carries the model-data version (one
    version per consumed batch), as the online LR model does."""

    def __init__(self):
        super().__init__()
        self._centroids: Optional[np.ndarray] = None
        self._model_version = 0

    @property
    def centroids(self) -> np.ndarray:
        self._require()
        return self._centroids

    @property
    def model_version(self) -> int:
        return self._model_version

    def set_model_data(self, *inputs: Table) -> "OnlineKMeansModel":
        (table,) = inputs
        self._set_arrays({"centroids": table.column("centroids")})
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({"centroids": self._centroids[None, :, :]})]

    def _arrays(self):
        self._require()
        return {"centroids": self._centroids}

    def _set_arrays(self, arrays) -> None:
        c = np.asarray(arrays["centroids"], dtype=np.float64)
        self._centroids = c.reshape(c.shape[-2], c.shape[-1])

    def _require(self) -> None:
        if self._centroids is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        """The nearest centroid of each row, in float64 on the compute
        device (the JAX model's dtype)."""
        (table,) = inputs
        self._require()
        device = default_device()
        x = torch.from_numpy(
            features_matrix(table, self.get(self.FEATURES_COL))).to(device)
        assign = DistanceMeasure.get_instance("euclidean").nearest(
            x, torch.from_numpy(self._centroids).to(device))
        return (table.with_column(self.get(self.PREDICTION_COL), assign),)

    def save(self, path: str) -> None:
        self._require()
        self._save_with_arrays(path, self._arrays(),
                               extra={"modelVersion": self._model_version})

    @classmethod
    def load(cls, path: str) -> "OnlineKMeansModel":
        model, arrays, meta = cls._load_with_arrays(path)
        model._set_arrays(arrays)
        model._model_version = int(meta.get("modelVersion", 0))
        return model
