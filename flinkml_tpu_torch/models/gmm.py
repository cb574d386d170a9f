"""GaussianMixture — EM-fit mixture of diagonal or full-covariance
Gaussians (the Spark/Flink family member).

The port's counterpart of ``flinkml_tpu.models.gmm``. Each EM iteration is
one float32 pass on the compute device over the mesh's rows:

  - E-step: every component's log-density at once (full covariances
    through ``torch.linalg.cholesky`` and one batched
    ``solve_triangular`` with all rows as the right-hand sides, the
    library calls JAX makes outside any Pallas kernel), responsibilities
    by a stable log-sum-exp;
  - M-step statistics (Σr, Σr·x, Σr·x xᵀ or Σr·x², the log-likelihood and
    the row count) summed over the mesh's ranks with ONE ``all_reduce``
    of their packed buffer (JAX: a ``psum`` of each), then the host
    M-step in float64; the loop stops on a log-likelihood change ≤ tol.

The EM runs in centered space (the host mean subtracted once), seeded by
k-means++ from the data (:func:`flinkml_tpu_torch.models.kmeans.
_kmeans_pp_init`, the JAX package's draws) with the data variance as
every initial covariance. ``covarianceType`` ∈ {"full", "diag"}.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasMaxIter,
    HasPredictionCol,
    HasRawPredictionCol,
    HasSeed,
    HasTol,
)
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.models.pca import shard_with_mask
from flinkml_tpu_torch.params import IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.parallel.mesh import DeviceMesh
from flinkml_tpu_torch.table import Table

_REG = 1e-6  # covariance ridge, sklearn's reg_covar default


class _GMMParams(
    HasFeaturesCol, HasPredictionCol, HasRawPredictionCol, HasMaxIter,
    HasTol, HasSeed,
):
    K = IntParam("k", "Number of mixture components.", 2, ParamValidators.gt(0))
    COVARIANCE_TYPE = StringParam(
        "covarianceType", "Component covariance structure.", "full",
        ParamValidators.in_array(["full", "diag"]),
    )


def log_prob(x, weights, means, covs, cov_type: str) -> torch.Tensor:
    """``[n, k]`` log(w_j · N(x | mu_j, Sigma_j)) at the dtype of ``x``."""
    n, d = x.shape
    diff = x[:, None, :] - means[None, :, :]            # [n, k, d]
    if cov_type == "diag":
        inv = 1.0 / covs                                # [k, d]
        maha = torch.sum(diff * diff * inv[None], dim=2)
        logdet = torch.sum(torch.log(covs), dim=1)      # [k]
    else:
        chol = torch.linalg.cholesky(covs)              # [k, d, d]
        # One triangular solve per component with every row as a
        # right-hand side: L_j Z_j = diff[:, j, :]ᵀ.
        rhs = diff.permute(1, 2, 0)                     # [k, d, n]
        z = torch.linalg.solve_triangular(chol, rhs, upper=False)
        maha = torch.sum(z * z, dim=1).T                # [n, k]
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(chol, dim1=1, dim2=2)), dim=1)
    log_norm = -0.5 * (d * math.log(2.0 * math.pi) + logdet)
    return torch.log(weights)[None, :] + log_norm[None, :] - 0.5 * maha


def em_statistics(xl, wl, weights, means, covs, cov_type: str,
                  mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """One E-step over this rank's rows: the packed float32 statistics
    ``[r_k (k) | r_x (k·d) | r_xx (k·d or k·d·d) | ll | n]`` on the device,
    summed over the mesh's ranks (one ``all_reduce``)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(xl.device)
    logp = log_prob(xl, f32(weights), f32(means), f32(covs), cov_type)
    logz = torch.logsumexp(logp, dim=1, keepdim=True)
    resp = torch.exp(logp - logz) * wl[:, None]         # masked rows drop
    if cov_type == "diag":
        r_xx = resp.T @ (xl * xl)                        # [k, d]
    else:
        r_xx = torch.einsum("nk,nd,ne->kde", resp, xl, xl)
    packed = torch.cat([
        torch.sum(resp, dim=0), (resp.T @ xl).reshape(-1), r_xx.reshape(-1),
        torch.sum(logz[:, 0] * wl).reshape(1), torch.sum(wl).reshape(1)])
    if mesh is not None and mesh.group(DeviceMesh.DATA_AXIS) is not None:
        from flinkml_tpu_torch.parallel.collectives import all_reduce_

        all_reduce_(mesh, packed)
    return packed


def unpack_statistics(packed, k: int, d: int, cov_type: str):
    """``(r_k, r_x, r_xx, ll, n)`` in float64 on the host."""
    a = torch.as_tensor(packed).cpu().numpy().astype(np.float64)
    r_k, a = a[:k], a[k:]
    r_x, a = a[:k * d].reshape(k, d), a[k * d:]
    shape = (k, d) if cov_type == "diag" else (k, d, d)
    size = int(np.prod(shape))
    return r_k, r_x, a[:size].reshape(shape), a[size], a[size + 1]


def _m_step(r_k, r_x, r_xx, cov_type: str):
    d = r_x.shape[1]
    safe = np.maximum(r_k, 1e-12)
    weights = r_k / r_k.sum()
    means = r_x / safe[:, None]
    if cov_type == "diag":
        covs = r_xx / safe[:, None] - means * means + _REG
        covs = np.maximum(covs, _REG)
    else:
        covs = (
            r_xx / safe[:, None, None]
            - means[:, :, None] * means[:, None, :]
            + _REG * np.eye(d)[None]
        )
    return weights, means, covs


def _check_ll(ll: float) -> None:
    if not np.isfinite(ll):
        raise FloatingPointError(
            "GaussianMixture log-likelihood became non-finite; "
            "the data may be degenerate (try covarianceType='diag' "
            "or fewer components)"
        )


class GaussianMixture(StreamingEstimatorMixin, _GMMParams, Estimator):
    """``fit`` accepts, besides a single in-RAM :class:`Table`, an
    iterable of batch Tables or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache`: each EM
    iteration replays the cache, adding the batches' statistics on the
    device in float32 (checkpoints every N iterations; a resume continues
    bit for bit wherever the statistics are). On a mesh of several ranks
    each rank feeds its own partition (the agreed replay schedule, pooled
    moments and init sample of
    :mod:`flinkml_tpu_torch.iteration.stream_sync`)."""

    def fit(self, *inputs) -> "GaussianMixtureModel":
        from flinkml_tpu_torch.models.kmeans import _kmeans_pp_init

        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
        self._reject_in_ram_checkpointing()
        x = features_matrix(table, self.get(self.FEATURES_COL))
        n, d = x.shape
        k = self.get(self.K)
        if n < k:
            raise ValueError(f"n_rows={n} < k={k}")
        cov_type = self.get(self.COVARIANCE_TYPE)
        mesh = self.mesh or DeviceMesh()
        # Centered space: the float32 statistics stay magnitude-safe.
        shift = x.mean(axis=0)
        x = x - shift
        xd, wd = shard_with_mask(x, mesh)
        rng = np.random.default_rng(self.get_seed())
        means = np.asarray(_kmeans_pp_init(x, k, rng), dtype=np.float64)
        var = np.maximum(x.var(axis=0), _REG)
        if cov_type == "diag":
            covs = np.tile(var[None, :], (k, 1))
        else:
            covs = np.tile(np.diag(var)[None], (k, 1, 1))
        weights = np.full(k, 1.0 / k)
        prev_ll = -np.inf
        for _ in range(self.get(self.MAX_ITER)):
            r_k, r_x, r_xx, ll, n_tot = unpack_statistics(
                em_statistics(xd, wd, weights, means, covs, cov_type, mesh),
                k, d, cov_type)
            weights, means, covs = _m_step(r_k, r_x, r_xx, cov_type)
            ll = float(ll) / float(n_tot)
            _check_ll(ll)
            if abs(ll - prev_ll) <= self.get(self.TOL):
                prev_ll = ll
                break
            prev_ll = ll
        model = GaussianMixtureModel()
        model.copy_params_from(self)
        model._set(weights, means + shift[None, :], covs)
        return model

    def _fit_stream(self, source) -> "GaussianMixtureModel":
        """Out-of-core EM: pass 0 caches the stream while summing the
        mean/variance moments (the centering shift and the initial
        covariances) and reservoir-sampling rows for k-means++; each EM
        iteration replays the cache batch by batch."""
        from flinkml_tpu_torch.iteration.checkpoint import (
            begin_resume,
            save_replicated,
            should_snapshot,
        )
        from flinkml_tpu_torch.iteration.datacache import (
            DataCache,
            DataCacheWriter,
            PrefetchingDeviceFeed,
        )
        from flinkml_tpu_torch.iteration.stream_sync import (
            DeferredValidation,
            agreed_restore,
            checked_ingest,
        )
        from flinkml_tpu_torch.models._linear_sgd import multi_rank
        from flinkml_tpu_torch.models.kmeans import _kmeans_pp_init
        from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
        from flinkml_tpu_torch.parallel.mesh import pad_to_multiple
        from flinkml_tpu_torch.utils.sampling import RowReservoir

        if self.resume and not isinstance(source, DataCache):
            raise ValueError(
                "resume=True requires a durable DataCache input: a one-shot "
                "stream cannot be replayed from the start after a failure"
            )
        features_col = self.get(self.FEATURES_COL)
        k = self.get(self.K)
        cov_type = self.get(self.COVARIANCE_TYPE)
        mesh = self.mesh or DeviceMesh()
        multi = multi_rank(mesh)
        row_tile = mesh.axis_size() * 8
        column = features_col if isinstance(source, DataCache) else "x"
        resume_epoch = begin_resume(self.checkpoint_manager, self.resume,
                                    mesh.num_devices if multi else 1)

        # -- pass 0: cache + running moments + init row sample -------------
        reservoir = RowReservoir(65_536, seed=self.get_seed())
        sum_x = sum_xx = None
        count = 0
        d = None

        def ingest(x):
            nonlocal sum_x, sum_xx, count, d
            if x.ndim != 2 or x.shape[0] == 0:
                raise ValueError(
                    f"stream batches must be non-empty [n, d], got {x.shape}"
                )
            if d is None:
                d = x.shape[1]
            elif x.shape[1] != d:
                raise ValueError(
                    f"batch feature dim {x.shape[1]} != first batch's {d}"
                )
            if resume_epoch is None:
                reservoir.add(x)
            s = x.astype(np.float64)
            sum_x = s.sum(0) if sum_x is None else sum_x + s.sum(0)
            sq = (s * s).sum(0)
            sum_xx = sq if sum_xx is None else sum_xx + sq
            count += x.shape[0]

        dv = DeferredValidation()

        def extract_cached(batch):
            x = np.asarray(batch[column], np.float32)
            ingest(x)
            return x

        if isinstance(source, DataCache):
            cache = source
            for _ in checked_ingest(cache.reader(), dv, extract_cached,
                                    multi):
                pass
        else:
            writer = DataCacheWriter(
                self.cache_dir, self.cache_memory_budget_bytes
            )

            def extract_append(t):
                x = features_matrix(t, features_col).astype(np.float32)
                ingest(x)
                writer.append({column: np.array(x)})

            for _ in checked_ingest(source, dv, extract_append, multi):
                pass
            cache = writer.finish()
        plan = None
        local_count = count
        if multi:
            from flinkml_tpu_torch.iteration.stream_sync import (
                SyncedReplayPlan,
                agree_feature_dim,
                gather_vectors,
            )

            dv.rendezvous(mesh, "stream ingest validation")
            plan = SyncedReplayPlan.create(cache, mesh, row_tile)
            d = agree_feature_dim(
                cache, column, mesh, local_dim=0 if d is None else d
            )
            local_stats = np.concatenate([
                np.zeros(2 * d) if sum_x is None
                else np.concatenate([sum_x, sum_xx]),
                [float(count)],
            ])
            stats = gather_vectors(local_stats, mesh).sum(axis=0)
            sum_x, sum_xx = stats[:d], stats[d: 2 * d]
            count = int(round(stats[2 * d]))
        if count < k:
            raise ValueError(f"n_rows={count} < k={k}")

        mean = sum_x / count
        var = np.maximum(sum_xx / count - mean * mean, _REG)
        shift = mean
        if cov_type == "diag":
            covs = np.tile(var[None, :], (k, 1))
        else:
            covs = np.tile(np.diag(var)[None], (k, 1, 1))
        weights = np.full(k, 1.0 / k)
        if resume_epoch is None:
            from flinkml_tpu_torch.iteration.stream_sync import pooled_sample

            rng = np.random.default_rng(self.get_seed())
            sample = reservoir.sample()
            if multi:
                sample = pooled_sample(sample.astype(np.float32), local_count,
                                       65_536, self.get_seed(), mesh)
            sample = sample.astype(np.float64) - shift[None, :]
            means = np.asarray(_kmeans_pp_init(sample, k, rng), np.float64)
        else:
            means = np.zeros((k, d))  # placeholder; restored below

        shift32 = shift.astype(np.float32)[None, :]
        device = mesh.device

        def to_device(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        if multi:
            from flinkml_tpu_torch.iteration.stream_sync import pad_rows_to

            height = plan.local_height

            def place(batch):
                if "_dummy" in batch:
                    return (to_device(np.zeros((height, d), np.float32)),
                            to_device(np.zeros(height, np.float32)))
                x = np.asarray(batch[column], np.float32) - shift32
                return (to_device(pad_rows_to(x, height)),
                        to_device(pad_rows_to(np.ones(x.shape[0],
                                                      np.float32), height)))
        else:

            def place(batch):
                x = np.asarray(batch[column], np.float32) - shift32
                x_pad, n_valid = pad_to_multiple(x, row_tile)
                wl = np.zeros(x_pad.shape[0], np.float32)
                wl[:n_valid] = 1.0
                return to_device(x_pad), to_device(wl)

        mgr = self.checkpoint_manager
        prev_ll = -np.inf
        start_epoch = 0
        terminated = False
        if resume_epoch is not None:
            like = (weights, means, covs, np.float64(0.0), np.asarray(False))
            (weights, means, covs, prev_ll, term), start_epoch = (
                agreed_restore(mgr, resume_epoch, like, mesh)
            )
            prev_ll = float(prev_ll)
            terminated = bool(term)

        def snapshot(epoch):
            state = (weights, means, covs, np.float64(prev_ll),
                     np.asarray(terminated))
            if multi:
                save_replicated(mgr, state, epoch, mesh)
            else:
                mgr.save(state, epoch)

        guard = DispatchGuard()
        reduce_mesh = mesh if multi else None
        max_iter = self.get(self.MAX_ITER)
        for epoch in range(start_epoch, max_iter):
            if terminated:
                break  # restored from a tol-terminated run: a no-op resume
            acc = None
            src = (plan.epoch_batches(cache.reader(), lambda: {"_dummy": True})
                   if multi else cache.reader())
            feed = PrefetchingDeviceFeed(src, place=place, depth=2)
            try:
                for xb, wl in feed:
                    out = em_statistics(xb, wl, weights, means, covs,
                                        cov_type, reduce_mesh)
                    acc = out if acc is None else acc + out
                    guard.after_dispatch(acc)
            finally:
                feed.close()
            guard.flush(acc)
            r_k, r_x, r_xx, ll, n_tot = unpack_statistics(acc, k, d, cov_type)
            weights, means, covs = _m_step(r_k, r_x, r_xx, cov_type)
            ll = float(ll) / float(n_tot)
            _check_ll(ll)
            terminated = abs(ll - prev_ll) <= self.get(self.TOL)
            prev_ll = ll
            if should_snapshot(mgr, self.checkpoint_interval, epoch + 1,
                               max_iter, terminal=terminated):
                snapshot(epoch + 1)
            if terminated:
                break
        model = GaussianMixtureModel()
        model.copy_params_from(self)
        model._set(weights, means + shift[None, :], covs)
        return model


class GaussianMixtureModel(_GMMParams, Model):
    def __init__(self):
        super().__init__()
        self._weights: Optional[np.ndarray] = None
        self._means: Optional[np.ndarray] = None
        self._covs: Optional[np.ndarray] = None

    def _set(self, weights, means, covs):
        self._weights = np.asarray(weights, np.float64)
        self._means = np.asarray(means, np.float64)
        self._covs = np.asarray(covs, np.float64)

    @property
    def weights(self) -> np.ndarray:
        self._require()
        return self._weights

    @property
    def means(self) -> np.ndarray:
        self._require()
        return self._means

    @property
    def covariances(self) -> np.ndarray:
        self._require()
        return self._covs

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require()
        return {"weights": self._weights, "means": self._means,
                "covs": self._covs}

    def _set_arrays(self, arrays) -> None:
        """The saved layout, or the model-data table's (a leading axis of
        1 on every array, told by the weights')."""
        w = np.asarray(arrays["weights"])
        lead = w.ndim == 2
        pick = (lambda a: np.asarray(a)[0]) if lead else np.asarray
        self._set(pick(arrays["weights"]), pick(arrays["means"]),
                  pick(arrays["covs"]))

    def set_model_data(self, *inputs: Table) -> "GaussianMixtureModel":
        (table,) = inputs
        self._set_arrays({k: table.column(k)
                          for k in ("weights", "means", "covs")})
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({k: v[None] for k, v in self._arrays().items()})]

    def _require(self) -> None:
        if self._weights is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        x = features_matrix(table, self.get(self.FEATURES_COL))
        device = default_device()
        f32 = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.float32)).to(device)
        logp = log_prob(f32(x), f32(self._weights), f32(self._means),
                        f32(self._covs), self.get(self.COVARIANCE_TYPE))
        logp = logp.cpu().numpy().astype(np.float64)
        shifted = logp - logp.max(axis=1, keepdims=True)
        resp = np.exp(shifted)
        resp /= resp.sum(axis=1, keepdims=True)
        out = table.with_column(
            self.get(self.PREDICTION_COL),
            np.argmax(logp, axis=1).astype(np.float64),
        )
        out = out.with_column(self.get(self.RAW_PREDICTION_COL), resp)
        return (out,)
