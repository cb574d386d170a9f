"""LDA — latent Dirichlet allocation via batch variational Bayes (the
Spark/Flink family member).

The port's counterpart of ``flinkml_tpu.models.lda``. The VB updates
(Blei/Hoffman, the sklearn formulation) are dense linear algebra in
float32 on the compute device:

  - E-step (per document, vectorized over ALL docs at once): iterate
    ``γ = α + expE[log θ] ⊙ ((counts / (expE[log θ]·expE[log β])) ·
    expE[log β]ᵀ)`` — two [n, V]×[V, k] products per inner iteration,
    40 iterations from a ``gamma(100)/100`` start drawn with the JAX
    package's threefry key (:func:`flinkml_tpu_torch.ops.threefry.gamma`);
  - sufficient statistics ``expE[log θ]ᵀ · (counts / φ)``, the bound's
    ``Σ counts·log φ`` and the token count, packed into one buffer
    ``[sstats | ll | tokens]`` and summed over the mesh's ranks with ONE
    ``all_reduce`` a pass (JAX: a ``psum`` of each);
  - M-step on the host in float64: ``λ = η + expE[log β] ⊙ sstats``; the
    loop stops on a per-token bound change ≤ tol.

JAX draws the E-step start ``gamma(key, 100, (n_local, k))`` in every
shard from the same key, so a fit equals JAX's on a mesh of as many
devices as the port has ranks (one process: JAX's one-device mesh).

A device-resident counts column is used in place (the card's dense
[n, V] float32 corpus is never copied to the host); ``transform`` emits
the normalized doc-topic mixture; ``describe_topics`` returns each
topic's top terms.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
    HasTol,
)
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.ops import threefry
from flinkml_tpu_torch.params import FloatParam, IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.parallel.mesh import DeviceMesh, pad_to_multiple
from flinkml_tpu_torch.table import Table

_E_STEPS = 40   # inner E-step iterations per outer pass
_GAMMA_SHAPE = 100.0


class _LDAParams(
    HasFeaturesCol, HasPredictionCol, HasMaxIter, HasTol, HasSeed,
):
    K = IntParam("k", "Number of topics.", 10, ParamValidators.gt(1))
    DOC_CONCENTRATION = FloatParam(
        "docConcentration",
        "Dirichlet prior on doc-topic mixtures (alpha; None = 1/k).", None,
        lambda v: v is None or v > 0,
    )
    TOPIC_CONCENTRATION = FloatParam(
        "topicConcentration",
        "Dirichlet prior on topic-word distributions (eta; None = 1/k).",
        None, lambda v: v is None or v > 0,
    )
    TOPIC_DISTRIBUTION_COL = StringParam(
        "topicDistributionCol", "Output doc-topic mixture column.",
        "topicDistribution",
    )

    def _priors(self, k: int) -> Tuple[float, float]:
        alpha = self.get(self.DOC_CONCENTRATION)
        eta = self.get(self.TOPIC_CONCENTRATION)
        return (1.0 / k if alpha is None else alpha,
                1.0 / k if eta is None else eta)


def _counts_matrix(table: Table, col: str) -> np.ndarray:
    """The host float64 ``[n, V]`` counts of a dense or TF-vector column."""
    c = table.column(col)
    if c.dtype == object:
        sizes = {v.size() for v in c}
        if len(sizes) != 1:
            raise ValueError(f"TF vectors disagree on vocab size: {sorted(sizes)}")
        out = np.zeros((len(c), sizes.pop()))
        for i, v in enumerate(c):
            if isinstance(v, SparseVector):
                out[i, v.indices] = v.values
            else:
                out[i] = v.to_array()
        return out
    x = np.asarray(c, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError(f"counts column must be [n, V], got {x.shape}")
    return x


def _counts_tensor(table: Table, col: str, device) -> torch.Tensor:
    """The counts as float32 ``[n, V]`` on ``device``: a device-resident
    column in place, a host column through :func:`_counts_matrix`."""
    if table.is_device_resident(col):
        c = table.device_column(col, device)
        if c.dim() != 2:
            raise ValueError(f"counts column must be [n, V], got {tuple(c.shape)}")
        return c.to(torch.float32)
    return torch.from_numpy(
        _counts_matrix(table, col).astype(np.float32)).to(device)


def _exp_dirichlet_expectation(a: torch.Tensor) -> torch.Tensor:
    """exp(E[log p]) for rows of a Dirichlet parameter matrix."""
    return torch.exp(torch.special.digamma(a) - torch.special.digamma(
        torch.sum(a, dim=-1, keepdim=True)))


def _e_step(counts: torch.Tensor, exp_elog_beta: torch.Tensor, alpha: float,
            gamma0: torch.Tensor) -> torch.Tensor:
    """The E-step fixed point from ``gamma0``: ``_E_STEPS`` updates of γ."""
    gamma = gamma0
    for _ in range(_E_STEPS):
        exp_elog_theta = _exp_dirichlet_expectation(gamma)
        # counts / (θ·β + 1e-30) in one [n, V] buffer.
        ratio = exp_elog_theta @ exp_elog_beta
        torch.div(counts, ratio.add_(1e-30), out=ratio)
        gamma = alpha + exp_elog_theta * (ratio @ exp_elog_beta.T)
    return gamma


def _gamma_fixed_point(counts: torch.Tensor, lam: torch.Tensor,
                       alpha: float) -> torch.Tensor:
    """The E-step of ``transform``: from ``α + (document length)/k``."""
    k = lam.shape[0]
    gamma0 = alpha + torch.sum(counts, dim=1, keepdim=True) / k
    gamma0 = gamma0.expand(counts.shape[0], k)
    return _e_step(counts, _exp_dirichlet_expectation(lam), alpha, gamma0)


def vb_pass(counts: torch.Tensor, rows_w: torch.Tensor, lam: torch.Tensor,
            alpha: float, key: torch.Tensor,
            mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """One outer VB pass over this rank's rows: the packed float32
    ``[sstats (k·V) | ll | tokens]`` on the device, summed over the mesh's
    ranks (one ``all_reduce``). ``counts`` ``[n_local, V]`` and ``rows_w``
    (1 on real rows) are float32; ``lam`` is float32 ``[k, V]``; ``key``
    draws the E-step start ``gamma(key, 100, (n_local, k)) / 100``."""
    k = lam.shape[0]
    exp_elog_beta = _exp_dirichlet_expectation(lam)
    gamma0 = threefry.gamma(key, _GAMMA_SHAPE, (counts.shape[0], k)).to(
        device=counts.device, dtype=torch.float32) * 0.01
    gamma = _e_step(counts, exp_elog_beta, alpha, gamma0)
    exp_elog_theta = _exp_dirichlet_expectation(gamma)
    phi_norm = (exp_elog_theta @ exp_elog_beta).add_(1e-30)
    w = rows_w[:, None]
    sstats = (exp_elog_theta * w).T @ (counts / phi_norm)
    ll = torch.sum(counts * torch.log_(phi_norm) * w)
    packed = torch.cat([sstats.reshape(-1), ll.reshape(1),
                        torch.sum(counts * w).reshape(1)])
    if mesh is not None and mesh.group(DeviceMesh.DATA_AXIS) is not None:
        from flinkml_tpu_torch.parallel.collectives import all_reduce_

        all_reduce_(mesh, packed)
    return packed


def _m_step(lam: np.ndarray, packed: torch.Tensor, eta: float,
            device) -> Tuple[np.ndarray, float]:
    """``(λ', per-token bound)`` on the host in float64 from a pass's
    packed statistics and the pass's float32 ``expE[log β]``."""
    k, vocab = lam.shape
    a = packed.cpu().numpy().astype(np.float64)
    exp_elog_beta = _exp_dirichlet_expectation(torch.from_numpy(
        lam.astype(np.float32)).to(device)).cpu().numpy().astype(np.float64)
    new = eta + exp_elog_beta * a[:k * vocab].reshape(k, vocab)
    return new, float(a[k * vocab]) / max(float(a[k * vocab + 1]), 1e-30)


def _initial_lambda(key: torch.Tensor, k: int, vocab: int) -> np.ndarray:
    return threefry.gamma(key, _GAMMA_SHAPE, (k, vocab)).cpu().numpy() * 0.01


class LDA(StreamingEstimatorMixin, _LDAParams, Estimator):
    """``fit`` accepts, besides a single in-RAM :class:`Table`, an
    iterable of batch Tables or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache` — the
    out-of-core path: each outer VB pass replays the cached corpus,
    adding the topic sufficient statistics batch by batch on the device.
    ``checkpoint_manager`` + ``checkpoint_interval`` snapshot
    ``(lambda, prev_ll, terminated)`` every N outer passes of the streamed
    fit; ``resume=True`` continues bit for bit. On a mesh of several ranks
    each rank feeds its own partition (the agreed replay schedule of
    :mod:`flinkml_tpu_torch.iteration.stream_sync`)."""

    def fit(self, *inputs) -> "LDAModel":
        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
        self._reject_in_ram_checkpointing()
        from flinkml_tpu_torch.models._linear_sgd import multi_rank
        from flinkml_tpu_torch.models.pca import shard_with_mask

        col = self.get(self.FEATURES_COL)
        k = self.get(self.K)
        alpha, eta = self._priors(k)
        mesh = self.mesh or DeviceMesh()
        device = mesh.device if multi_rank(mesh) else default_device()
        if multi_rank(mesh):
            counts = _counts_matrix(table, col)
            if (counts < 0).any():
                raise ValueError("token counts must be non-negative")
            cl, wl = shard_with_mask(counts, mesh)
            vocab = counts.shape[1]
        else:
            cl = _counts_tensor(table, col, device)
            if bool((cl < 0).any()):
                raise ValueError("token counts must be non-negative")
            wl = torch.ones(cl.shape[0], dtype=torch.float32, device=device)
            vocab = cl.shape[1]
        key = threefry.PRNGKey(self.get_seed(), device=device)
        lam = _initial_lambda(key, k, vocab)
        reduce_mesh = mesh if multi_rank(mesh) else None
        prev_ll = -np.inf
        for it in range(self.get(self.MAX_ITER)):
            lam_dev = torch.from_numpy(lam.astype(np.float32)).to(device)
            packed = vb_pass(cl, wl, lam_dev, alpha,
                             threefry.fold_in(key, it), reduce_mesh)
            lam, ll = _m_step(lam, packed, eta, device)
            if abs(ll - prev_ll) <= self.get(self.TOL):
                prev_ll = ll
                break
            prev_ll = ll
        model = LDAModel()
        model.copy_params_from(self)
        model._set(lam)
        return model

    def _fit_stream(self, source) -> "LDAModel":
        """Out-of-core VB (see class docstring): pass 0 caches the corpus;
        each outer pass replays it, adding the packed statistics per
        batch. Each batch's E-step start draws from
        ``fold_in(fold_in(key, pass), batch_index)``, so the trajectory is
        deterministic (and independent of the RAM/spill split). On several
        ranks a drained rank runs zero-weight dummy steps (exact no-ops in
        the masked sums) and rank 0 writes the replicated checkpoints."""
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
            agreed_restore,
            checked_ingest,
        )
        from flinkml_tpu_torch.models._linear_sgd import multi_rank
        from flinkml_tpu_torch.parallel.dispatch import DispatchGuard

        if self.resume and not isinstance(source, DataCache):
            raise ValueError(
                "resume=True requires a durable DataCache input: a one-shot "
                "stream cannot be replayed from the start after a failure"
            )
        features_col = self.get(self.FEATURES_COL)
        k = self.get(self.K)
        alpha, eta = self._priors(k)
        mesh = self.mesh or DeviceMesh()
        multi = multi_rank(mesh)
        row_tile = mesh.axis_size() * 8
        resume_epoch = begin_resume(self.checkpoint_manager, self.resume,
                                    mesh.num_devices if multi else 1)
        column = features_col if isinstance(source, DataCache) else "x"
        vocab = [None]

        def to_counts(batch) -> np.ndarray:
            """The batch's host counts (a cached float batch as it is: the
            replay places it without a float64 copy)."""
            if isinstance(batch, Table):
                c = _counts_matrix(batch, features_col)
            else:
                c = np.asarray(batch[column])
                if c.dtype.kind != "f":
                    c = c.astype(np.float64)
            if c.ndim != 2 or c.shape[0] == 0:
                raise ValueError(
                    f"stream batches must be non-empty [n, V], got {c.shape}"
                )
            if (c < 0).any():
                raise ValueError("token counts must be non-negative")
            if vocab[0] is None:
                vocab[0] = c.shape[1]
            elif c.shape[1] != vocab[0]:
                raise ValueError(
                    f"batch vocab size {c.shape[1]} != first batch's "
                    f"{vocab[0]}"
                )
            return c

        dv = DeferredValidation()
        if isinstance(source, DataCache):
            cache = source
            if not multi and cache.num_rows == 0:
                raise ValueError("training stream is empty")
            if multi:
                # Validate every cached batch before the rendezvous: a bad
                # batch first seen at replay time would raise on one rank
                # while its peers wait in the all_reduce.
                for _ in checked_ingest(cache.reader(), dv, to_counts, multi):
                    pass
            elif cache.num_batches:
                reader = cache.reader()
                to_counts(next(iter(reader)))  # vocab from the first batch
                if hasattr(reader, "close"):
                    reader.close()
        else:
            writer = DataCacheWriter(
                self.cache_dir, self.cache_memory_budget_bytes
            )

            def ingest_append(t):
                writer.append({column: to_counts(t).astype(np.float32)})

            for _ in checked_ingest(source, dv, ingest_append, multi):
                pass
            cache = writer.finish()
            if not multi and vocab[0] is None:
                raise ValueError("training stream is empty")

        plan = None
        if multi:
            from flinkml_tpu_torch.iteration.stream_sync import (
                SyncedReplayPlan,
                agree_feature_dim,
            )

            dv.rendezvous(mesh, "stream ingest validation")
            plan = SyncedReplayPlan.create(cache, mesh, row_tile)
            vocab[0] = agree_feature_dim(
                cache, column, mesh,
                local_dim=0 if vocab[0] is None else vocab[0],
            )
            if vocab[0] == 0:
                raise ValueError("training stream is empty on every process")

        device = mesh.device if multi else default_device()
        key = threefry.PRNGKey(self.get_seed(), device=device)
        if resume_epoch is None:
            lam = _initial_lambda(key, k, vocab[0])
        else:
            lam = np.zeros((k, vocab[0]))  # placeholder; restored below
        mgr = self.checkpoint_manager
        prev_ll = -np.inf
        start_epoch = 0
        terminated = False
        if resume_epoch is not None:
            like = (lam, np.float64(0.0), np.asarray(False))
            (lam, prev_ll, term), start_epoch = agreed_restore(
                mgr, resume_epoch, like, mesh)
            prev_ll = float(prev_ll)
            terminated = bool(term)

        def to_device(a):
            return device_put(np.ascontiguousarray(a), device)

        if multi:
            from flinkml_tpu_torch.iteration.stream_sync import pad_rows_to

            height = plan.local_height

            def place(batch):
                if batch is None:  # dummy step on a drained rank
                    return (to_device(np.zeros((height, vocab[0]), np.float32)),
                            to_device(np.zeros(height, np.float32)))
                c = np.asarray(to_counts(batch), np.float32)
                return (to_device(pad_rows_to(c, height)),
                        to_device(pad_rows_to(np.ones(c.shape[0], np.float32),
                                              height)))
        else:

            def place(batch):
                c = np.asarray(to_counts(batch), np.float32)
                # The 8p row tile bounds the set of padded shapes.
                c_pad, n_valid = pad_to_multiple(c, row_tile)
                rows_w = np.zeros(c_pad.shape[0], np.float32)
                rows_w[:n_valid] = 1.0
                return to_device(c_pad), to_device(rows_w)

        guard = DispatchGuard()
        reduce_mesh = mesh if multi else None
        max_iter = self.get(self.MAX_ITER)
        for it in range(start_epoch, max_iter):
            if terminated:
                break  # restored from a tol-terminated run: a no-op resume
            lam_dev = to_device(lam.astype(np.float32))
            pass_key = threefry.fold_in(key, it)
            acc = None
            src = (plan.epoch_batches(cache.reader(), lambda: None)
                   if multi else cache.reader())
            feed = PrefetchingDeviceFeed(src, place=place, depth=2)
            try:
                for b, (cb, wb) in enumerate(feed):
                    out = vb_pass(cb, wb, lam_dev, alpha,
                                  threefry.fold_in(pass_key, b), reduce_mesh)
                    acc = out if acc is None else acc + out
                    guard.after_dispatch(acc)
            finally:
                feed.close()
            guard.flush(acc)
            lam, ll = _m_step(lam, acc, eta, device)
            terminated = abs(ll - prev_ll) <= self.get(self.TOL)
            prev_ll = ll
            if should_snapshot(mgr, self.checkpoint_interval, it + 1,
                               max_iter, terminal=terminated):
                state = (lam, np.float64(prev_ll), np.asarray(terminated))
                if multi:
                    save_replicated(mgr, state, it + 1, mesh)
                else:
                    mgr.save(state, it + 1)
            if terminated:
                break

        model = LDAModel()
        model.copy_params_from(self)
        model._set(lam)
        return model


class LDAModel(_LDAParams, Model):
    def __init__(self):
        super().__init__()
        self._lambda: Optional[np.ndarray] = None

    def _set(self, lam: np.ndarray) -> None:
        self._lambda = np.asarray(lam, np.float64)

    @property
    def topics_matrix(self) -> np.ndarray:
        """[k, V] topic-word distributions (rows sum to 1)."""
        self._require()
        return self._lambda / self._lambda.sum(axis=1, keepdims=True)

    def describe_topics(self, max_terms: int = 10) -> Table:
        """Per topic: top term indices and their weights."""
        self._require()
        tm = self.topics_matrix
        order = np.argsort(-tm, axis=1)[:, :max_terms]
        weights = np.take_along_axis(tm, order, axis=1)
        return Table({
            "topic": np.arange(tm.shape[0]),
            "termIndices": order,
            "termWeights": weights,
        })

    def _arrays(self):
        self._require()
        return {"lambda": self._lambda}

    def _set_arrays(self, arrays) -> None:
        """The saved layout, or the model-data table's (a leading axis of
        1)."""
        lam = np.asarray(arrays["lambda"], np.float64)
        self._set(lam[0] if lam.ndim == 3 else lam)

    def set_model_data(self, *inputs: Table) -> "LDAModel":
        (table,) = inputs
        self._set_arrays({"lambda": table.column("lambda")})
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({"lambda": self._lambda[None, :, :]})]

    def _require(self) -> None:
        if self._lambda is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        device = default_device()
        counts = _counts_tensor(table, self.get(self.FEATURES_COL), device)
        if counts.shape[1] != self._lambda.shape[1]:
            raise ValueError(
                f"vocab size {counts.shape[1]} != model's "
                f"{self._lambda.shape[1]}"
            )
        alpha, _ = self._priors(self._lambda.shape[0])
        lam = torch.from_numpy(self._lambda.astype(np.float32)).to(device)
        gamma = _gamma_fixed_point(counts, lam, alpha)
        gamma = gamma.cpu().numpy().astype(np.float64)
        theta = gamma / gamma.sum(axis=1, keepdims=True)
        out = table.with_column(
            self.get(self.TOPIC_DISTRIBUTION_COL), theta
        )
        out = out.with_column(
            self.get(self.PREDICTION_COL),
            np.argmax(theta, axis=1).astype(np.float64),
        )
        return (out,)
