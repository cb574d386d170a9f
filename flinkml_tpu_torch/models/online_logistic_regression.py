"""OnlineLogisticRegression — FTRL-proximal over a stream of mini-batches.

The port's counterpart of ``flinkml_tpu.models.online_logistic_regression``
(BASELINE.json config #4; reference: ``Iterations.iterateUnboundedStreams``,
``Iterations.java:118-127``). The unbounded stream is a Python iterable of
batch Tables fed to :func:`flinkml_tpu_torch.iteration.iterate`; each batch
is one FTRL update on the compute device, in the feature column's floating
dtype (float64 for anything else), and a model version counted per batch:

    g      = mean logistic gradient on the batch
    σ      = (√(n+g²) − √n) / α
    z     += g − σ·w ;  n += g²
    w_i    = 0                            if |z_i| ≤ λ1
           = −(z_i − sign(z_i)·λ1) / ((β+√n_i)/α + λ2)   otherwise

with λ1 = reg·elasticNet, λ2 = reg·(1−elasticNet). Both products are
``torch.matmul`` (the JAX package leaves them to XLA). Each update hands
its batch's loss to ``iterate`` as a 0-d tensor, which reads it once per
batch: alone, or together with the numerics sentinel's verdict when one
checks that batch (one read either way).

The carry ``{"z", "n", "coef", "version"}`` is checkpointed in the JAX
package's layout (``coef, n, version, z``: sorted keys), so a snapshot of
either package resumes in the other. ``sentinel=``/``recovery=`` thread the
numerics sentinel and the rollback-and-quarantine policy of
:mod:`flinkml_tpu_torch.recovery` through ``iterate``; the fitted model's
``recovery_summary`` records what the recovery did.

**Several processes.** In a process group of more than one rank each
rank feeds its own arriving partition and every update is one global
FTRL step in lockstep (:func:`~flinkml_tpu_torch.iteration.stream_sync.
synced_padded_stream`: a drained rank feeds zero-weight dummies until
every stream ends), its gradient, loss and weight sums summed over the
ranks in one ``all_reduce``: the reference's per-mini-batch allReduce of
the subtasks' gradients. It computes in float32, as the JAX package's
multi-process step does; the model is the same bits on every rank and
its version counts global steps (the most batches of any rank).
Checkpoints, the sentinel and recovery on that path are refused, as in the
JAX package.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasBatchStrategy,
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasWeightCol,
)
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models._data import features_tensor, labeled_data
from flinkml_tpu_torch.params import FloatParam, ParamValidators
from flinkml_tpu_torch.table import Table


class _OnlineLogisticRegressionParams(
    HasFeaturesCol,
    HasLabelCol,
    HasWeightCol,
    HasBatchStrategy,
    HasGlobalBatchSize,
    HasReg,
    HasElasticNet,
    HasPredictionCol,
    HasRawPredictionCol,
):
    ALPHA = FloatParam("alpha", "The alpha parameter of FTRL.", 0.1,
                       ParamValidators.gt(0.0))
    BETA = FloatParam("beta", "The beta parameter of FTRL.", 0.1,
                      ParamValidators.gt(0.0))


def _ftrl_algebra(z, n, w_coef, g, alpha, beta, l1, l2):
    """The FTRL-proximal state update given the batch's mean gradient."""
    sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / alpha
    z = z + g - sigma * w_coef
    n = n + g * g
    new_coef = torch.where(
        torch.abs(z) <= l1,
        torch.zeros((), dtype=z.dtype, device=z.device),
        -(z - torch.sign(z) * l1) / ((beta + torch.sqrt(n)) / alpha + l2),
    )
    return z, n, new_coef


def _ftrl_update(z, n, w_coef, x, y, weight, alpha, beta, l1, l2):
    """One FTRL-proximal step on a batch: ``(z, n, new_coef, loss)``, the
    loss the batch's weighted mean log-loss (``softplus`` as
    ``logaddexp(., 0)``, JAX's form)."""
    dot = torch.matmul(x, w_coef)
    p = torch.sigmoid(dot)
    wsum = torch.clamp_min(torch.sum(weight), 1e-12)
    g = torch.matmul(x.T, weight * (p - y)) / wsum
    z, n, new_coef = _ftrl_algebra(z, n, w_coef, g, alpha, beta, l1, l2)
    ys = 2.0 * y - 1.0
    margin = -dot * ys
    loss = torch.sum(weight * torch.logaddexp(margin, torch.zeros_like(margin))
                     ) / wsum
    return z, n, new_coef, loss


def _process_count() -> int:
    """Processes of the ``torch.distributed`` group (1 when there is none)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class OnlineLogisticRegression(_OnlineLogisticRegressionParams, Estimator):
    """FTRL over a stream: ``fit(table)`` consumes ``globalBatchSize``
    mini-batches of one Table, ``fit_stream(batches)`` an iterable of
    batch Tables (one update each)."""

    def __init__(self, mesh=None):
        from flinkml_tpu_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
        super().__init__()
        self.mesh = mesh
        self._initial_coefficient: Optional[np.ndarray] = None

    def set_initial_model_data(self, *inputs: Table) -> "OnlineLogisticRegression":
        """Warm start from an offline model's coefficient table."""
        (table,) = inputs
        self._initial_coefficient = np.asarray(
            table.column("coefficient"), dtype=np.float64
        ).reshape(-1)
        return self

    def fit(self, *inputs: Table) -> "OnlineLogisticRegressionModel":
        (table,) = inputs
        batch_size = self.get(_OnlineLogisticRegressionParams.GLOBAL_BATCH_SIZE)
        return self.fit_stream(table.batches(batch_size))

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
    ) -> "OnlineLogisticRegressionModel":
        """One FTRL update per arriving batch.

        ``batches`` is an iterable of batch Tables, or a
        :class:`~flinkml_tpu_torch.data.Dataset` or
        :class:`~flinkml_tpu_torch.data.ElasticFeed`, handed to ``iterate``
        whole so that its cursor rides every snapshot. A snapshot records
        the feed's world (``num_shards``); an ElasticFeed resumed at
        another world restores under the manager's ``rescale="allow"``
        (the FTRL carry is replicated, so the result is the same bits).
        ``checkpoint_manager`` (+ ``checkpoint_interval``) snapshots the
        whole carry every N consumed batches and at the end;
        ``resume=True`` continues from the newest valid snapshot, the same
        bits as the uninterrupted run. ``stream_resume``: ``"replay"`` for
        a source that re-presents the stream from the start (the consumed
        batches are skipped), ``"continue"`` for a live stream already at
        "now". ``sentinel`` (a :class:`~flinkml_tpu_torch.recovery.
        NumericsSentinel`) checks the carry and the loss after every batch
        before a snapshot can hold them; ``recovery`` (a
        :class:`~flinkml_tpu_torch.recovery.RecoveryPolicy`, which implies
        a default sentinel) heals a poisoned batch in the loop: rollback,
        quarantine, retry, so the fit equals the same stream without that
        batch. In a process group of several ranks each rank passes its
        own partition (the module docstring's "Several processes"; over
        ``mesh``, else a mesh of every rank), and a checkpoint manager,
        ``resume``, a sentinel or a recovery policy is refused.
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

        alpha = self.get(_OnlineLogisticRegressionParams.ALPHA)
        beta = self.get(_OnlineLogisticRegressionParams.BETA)
        reg = self.get(_OnlineLogisticRegressionParams.REG)
        en = self.get(_OnlineLogisticRegressionParams.ELASTIC_NET)
        l1, l2 = reg * en, reg * (1.0 - en)
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
                    "self-healing fit single-process, or use the bounded "
                    "multi-process streamed fits, which commit agreed "
                    "snapshots"
                )
            return self._fit_stream_multiprocess(batches, alpha, beta, l1, l2)
        restore_epoch = begin_resume(checkpoint_manager, resume,
                                     world_size=feed_world_size(batches))
        fcol = self.get(_OnlineLogisticRegressionParams.FEATURES_COL)
        lcol = self.get(_OnlineLogisticRegressionParams.LABEL_COL)
        wcol = self.get(_OnlineLogisticRegressionParams.WEIGHT_COL)

        # The first batch fixes the feature dim and dtype, so the carry is
        # a full tree of arrays from epoch 0 (restore needs its structure).
        first, stream = peek_stream(batches)
        if first is None:
            empty = self._model_from_empty_stream(
                checkpoint_manager, restore_epoch
            )
            if empty is not None:
                return empty
            raise ValueError("training stream is empty")
        x0 = labeled_data(first, fcol, lcol, wcol, dtype=None)[0]
        dim = x0.shape[1]
        device = default_device()
        dt = torch.from_numpy(np.empty(0, x0.dtype)).dtype

        def dev(a):
            if isinstance(a, np.ndarray) and not a.flags.writeable:
                a = np.array(a)  # torch.as_tensor wants a writable array
            return torch.as_tensor(a).to(device=device, dtype=dt)

        if self._initial_coefficient is None:
            coef0 = torch.zeros(dim, dtype=dt, device=device)
            z0 = torch.zeros(dim, dtype=dt, device=device)
        else:
            coef0 = dev(self._initial_coefficient)
            # Warm start: z such that the closed form gives coef0 at n=0:
            # z = -w·(beta/alpha + l2) - sign(w)·l1 (0 where w is 0).
            z0 = -coef0 * (beta / alpha + l2) - torch.sign(coef0) * l1
            z0 = torch.where(coef0 == 0.0, torch.zeros_like(z0), z0)
        state = {"z": z0, "n": torch.zeros(dim, dtype=dt, device=device),
                 "coef": coef0, "version": 0}

        def step(carry, batch_table, epoch):
            x, y, w = labeled_data(batch_table, fcol, lcol, wcol, dtype=None)
            # A restored carry comes back from the checkpoint as numpy.
            z, n, coef, loss = _ftrl_update(
                dev(carry["z"]), dev(carry["n"]), dev(carry["coef"]),
                dev(x), dev(y), dev(w), alpha, beta, l1, l2,
            )
            return {"z": z, "n": n, "coef": coef,
                    "version": int(carry["version"]) + 1}, loss

        result = iterate(step, state, stream, config, resume=resume)
        final = result.state
        model = self._model(torch.as_tensor(final["coef"]).cpu().numpy(),
                            int(final["version"]))
        # What the recovery did (None without a policy).
        model.recovery_summary = result.recovery
        return model

    def _model(self, coef, version: int) -> "OnlineLogisticRegressionModel":
        model = OnlineLogisticRegressionModel()
        model.copy_params_from(self)
        model._coefficient = np.asarray(coef, dtype=np.float64)
        model._model_version = version
        return model

    def _model_from_empty_stream(
        self, manager, restore_epoch
    ) -> Optional["OnlineLogisticRegressionModel"]:
        """The empty streams that are not errors: a resumed run whose live
        tail is already exhausted returns the checkpointed model, and a
        warm-started run returns the initial coefficient at version 0.
        None when the empty stream is an error."""
        if restore_epoch is not None and manager is not None:
            state, _ = manager.restore_latest(
                like={"z": 0, "n": 0, "coef": 0, "version": 0}
            )
            return self._model(state["coef"], int(state["version"]))
        if self._initial_coefficient is not None:
            return self._model(self._initial_coefficient, 0)
        return None

    def _fit_stream_multiprocess(self, batches, alpha, beta, l1, l2):
        """The multi-process stream (the module docstring's "Several
        processes"): the first batch's dim agreed over the ranks (a rank
        with no batch adopts it), then one global FTRL step per agreed
        step, in float32."""
        import itertools

        from flinkml_tpu_torch.iteration.datacache import device_put
        from flinkml_tpu_torch.iteration.stream_sync import (
            agree_first_item_dim,
            synced_padded_stream,
        )
        from flinkml_tpu_torch.models._linear_sgd import _reduce_terms
        from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
        from flinkml_tpu_torch.parallel.mesh import DeviceMesh

        mesh = self.mesh if self.mesh is not None else DeviceMesh()
        device = mesh.device
        fcol = self.get(_OnlineLogisticRegressionParams.FEATURES_COL)
        lcol = self.get(_OnlineLogisticRegressionParams.LABEL_COL)
        wcol = self.get(_OnlineLogisticRegressionParams.WEIGHT_COL)

        def extract(t):
            x, y, w = labeled_data(t, fcol, lcol, wcol)
            return (np.asarray(x, np.float32), np.asarray(y, np.float32),
                    np.asarray(w, np.float32))

        d_seen = [None]

        def check(item):
            x = item[0]
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
            (extract(t) for t in batches), check,
            lambda item: item[0].shape[1], mesh)
        d_seen[0] = dim
        f32 = dict(dtype=torch.float32, device=device)
        if self._initial_coefficient is None:
            coef = torch.zeros(dim, **f32)
            z = torch.zeros(dim, **f32)
        else:
            if self._initial_coefficient.shape[0] != dim:
                raise ValueError(
                    f"initial coefficient has dim "
                    f"{self._initial_coefficient.shape[0]} but the stream "
                    f"has dim {dim}"
                )
            coef = torch.as_tensor(self._initial_coefficient).to(**f32)
            z = -coef * (beta / alpha + l2) - torch.sign(coef) * l1
            z = torch.where(coef == 0.0, torch.zeros_like(z), z)
        n = torch.zeros(dim, **f32)
        guard = DispatchGuard()
        stream = itertools.chain([first] if first is not None else [], rest)
        version = 0
        # The zero-padded weights are the validity mask (padding and dummy
        # rows weigh 0): the loop's valid_w is not needed.
        for padded, _valid, _h in synced_padded_stream(
                stream, mesh, check=check, row_tile=8,
                dummy_cols=((dim,), (), ())):
            x, y, w = device_put(padded, device)
            dot = torch.matmul(x, coef)
            margin = -dot * (2.0 * y - 1.0)
            grad, _loss, wsum = _reduce_terms(
                mesh, torch.matmul(x.T, w * (torch.sigmoid(dot) - y)),
                torch.sum(w * torch.logaddexp(margin,
                                              torch.zeros_like(margin))),
                torch.sum(w))
            g = grad / torch.clamp_min(wsum, 1e-12)
            z, n, coef = _ftrl_algebra(z, n, coef, g, alpha, beta, l1, l2)
            version += 1
            guard.after_dispatch(coef)
        guard.flush(coef)
        return self._model(coef.cpu().numpy(), version)


class OnlineLogisticRegressionModel(_OnlineLogisticRegressionParams, Model):
    """Versioned online model: transform predicts with the latest weights
    and stamps each output row with the model version."""

    def __init__(self):
        super().__init__()
        self._coefficient: Optional[np.ndarray] = None
        self._model_version: int = 0

    def set_model_data(self, *inputs: Table) -> "OnlineLogisticRegressionModel":
        (table,) = inputs
        self._coefficient = np.asarray(
            table.column("coefficient"), dtype=np.float64
        ).reshape(-1)
        if "modelVersion" in table:
            self._model_version = int(table.column("modelVersion")[0])
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"coefficient": self._coefficient[None, :],
                       "modelVersion": np.array([self._model_version])})]

    @property
    def coefficient(self) -> np.ndarray:
        self._require_model()
        return self._coefficient

    @property
    def model_version(self) -> int:
        return self._model_version

    def _require_model(self) -> None:
        if self._coefficient is None:
            raise ValueError(
                "Model data is not set; call set_model_data or fit first")

    def _arrays(self):
        self._require_model()
        return {"coefficient": self._coefficient}

    def _set_arrays(self, arrays) -> None:
        self._coefficient = np.asarray(arrays["coefficient"],
                                       dtype=np.float64).reshape(-1)

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        x = features_tensor(
            table, self.get(_OnlineLogisticRegressionParams.FEATURES_COL))
        coef = torch.as_tensor(self._coefficient).to(device=x.device,
                                                     dtype=x.dtype)
        dot = torch.matmul(x, coef).cpu().numpy()
        p = 1.0 / (1.0 + np.exp(-dot))
        out = (
            table.with_column(
                self.get(_OnlineLogisticRegressionParams.PREDICTION_COL),
                (dot >= 0).astype(np.float64))
            .with_column(
                self.get(_OnlineLogisticRegressionParams.RAW_PREDICTION_COL),
                np.stack([1 - p, p], axis=-1))
            .with_column("modelVersion",
                         np.full(len(dot), self._model_version, np.int64))
        )
        return (out,)

    def save(self, path: str) -> None:
        self._require_model()
        self._save_with_arrays(path, self._arrays(),
                               extra={"modelVersion": self._model_version})

    @classmethod
    def load(cls, path: str) -> "OnlineLogisticRegressionModel":
        model, arrays, meta = cls._load_with_arrays(path)
        model._set_arrays(arrays)
        model._model_version = int(meta.get("modelVersion", 0))
        return model
