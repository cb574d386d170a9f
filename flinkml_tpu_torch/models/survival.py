"""AFTSurvivalRegression — accelerated-failure-time survival model (the
Spark family member).

The port's counterpart of ``flinkml_tpu.models.survival``: Weibull AFT
with right-censoring, ``log T = β·x + σ·ε`` with ε standard extreme-value.
Per-row log-likelihood (censor = 1 for an observed event, 0 for
right-censored)::

    z  = (log t - β·x) / σ
    ll = censor · (z - log σ) - exp(z)

Training rides the port's shared Adam trainer
(:func:`flinkml_tpu_torch.models._adam.make_adam_trainer`: threefry
minibatch draws, autograd gradients, one ``all_reduce`` a step on a
mesh), with ``log σ`` as the optimized scale parameter. Prediction is the
median survival time ``exp(β·x) · ln(2)^σ``; ``quantileProbabilities``
adds per-row quantile columns (host float64).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
    HasTol,
)
from flinkml_tpu_torch.models._adam import make_adam_trainer
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.ops import threefry
from flinkml_tpu_torch.params import BoolParam, FloatArrayParam, StringParam
from flinkml_tpu_torch.parallel.mesh import (
    DeviceMesh,
    check_mesh,
    pad_to_multiple,
)
from flinkml_tpu_torch.table import Table


class _AFTParams(
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasMaxIter,
    HasLearningRate, HasGlobalBatchSize, HasTol, HasSeed,
):
    CENSOR_COL = StringParam(
        "censorCol", "1.0 = event observed, 0.0 = right-censored.", "censor"
    )
    FIT_INTERCEPT = BoolParam(
        "fitIntercept",
        "Whether to fit an intercept term (matches Spark AFT's "
        "fitIntercept=true default; without it, data whose log survival "
        "times have nonzero mean biases the scale/coefficients).",
        True,
    )
    QUANTILE_PROBABILITIES = FloatArrayParam(
        "quantileProbabilities",
        "Survival-time quantiles emitted by transform (empty = none).",
        [],
    )
    QUANTILES_COL = StringParam(
        "quantilesCol", "Output column for the quantile matrix.", "quantiles"
    )


def _aft_loss_builder():
    def local_loss(params, xb, yb, wb):
        # yb packs [log_t, censor] as a [bs, 2] column.
        beta, log_sigma = params[0], params[1][0]
        log_t = yb[:, 0]
        censor = yb[:, 1]
        z = (log_t - xb @ beta) / torch.exp(log_sigma)
        ll = censor * (z - log_sigma) - torch.exp(z)
        return torch.sum(-ll * wb)

    return local_loss


class AFTSurvivalRegression(_AFTParams, Estimator):
    def __init__(self, mesh: Optional[DeviceMesh] = None):
        check_mesh(mesh)
        super().__init__()
        self.mesh = mesh

    def fit(self, *inputs: Table) -> "AFTSurvivalRegressionModel":
        (table,) = inputs
        x = features_matrix(table, self.get(self.FEATURES_COL))
        t = np.asarray(
            table.column(self.get(self.LABEL_COL)), np.float64
        ).reshape(-1)
        censor = np.asarray(
            table.column(self.get(self.CENSOR_COL)), np.float64
        ).reshape(-1)
        if (t <= 0).any():
            raise ValueError("survival times must be positive")
        if not np.isin(censor, (0.0, 1.0)).all():
            raise ValueError("censor column must be 0/1")
        if censor.sum() == 0:
            raise ValueError("all rows are censored; nothing to fit")
        mesh = self.mesh or DeviceMesh()
        p = mesh.axis_size()
        fit_intercept = self.get(self.FIT_INTERCEPT)
        if fit_intercept:
            # The intercept as an appended constant feature.
            x = np.concatenate([x, np.ones((x.shape[0], 1), x.dtype)], axis=1)
        x_pad, n_valid = pad_to_multiple(x.astype(np.float32), p)
        y = np.stack([np.log(t), censor], axis=1).astype(np.float32)
        y_pad, _ = pad_to_multiple(y, p)
        w_pad = np.zeros(x_pad.shape[0], np.float32)
        w_pad[:n_valid] = 1.0
        local_bs = max(1, self.get(self.GLOBAL_BATCH_SIZE) // p)
        trainer = make_adam_trainer(mesh, local_bs, _aft_loss_builder, 2)
        params0 = (
            torch.zeros(x.shape[1], dtype=torch.float32, device=mesh.device),
            torch.zeros(1, dtype=torch.float32, device=mesh.device),
        )
        (beta, log_sigma), _steps, _loss = trainer(
            mesh.shard_batch(x_pad), mesh.shard_batch(y_pad),
            mesh.shard_batch(w_pad), params0,
            self.get(self.LEARNING_RATE), self.get(self.MAX_ITER),
            self.get(self.TOL),
            threefry.PRNGKey(self.get_seed(), mesh.device),
        )
        model = AFTSurvivalRegressionModel()
        model.copy_params_from(self)
        beta = beta.cpu().numpy().astype(np.float64)
        intercept = float(beta[-1]) if fit_intercept else 0.0
        if fit_intercept:
            beta = beta[:-1]
        model._set(beta, float(np.exp(log_sigma.cpu().numpy()[0])), intercept)
        return model


class AFTSurvivalRegressionModel(_AFTParams, Model):
    def __init__(self):
        super().__init__()
        self._beta: Optional[np.ndarray] = None
        self._sigma: float = 1.0
        self._intercept: float = 0.0

    def _set(self, beta: np.ndarray, sigma: float,
             intercept: float = 0.0) -> None:
        self._beta = np.asarray(beta, np.float64)
        self._sigma = float(sigma)
        self._intercept = float(intercept)

    @property
    def coefficients(self) -> np.ndarray:
        self._require()
        return self._beta

    @property
    def scale(self) -> float:
        self._require()
        return self._sigma

    @property
    def intercept(self) -> float:
        self._require()
        return self._intercept

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require()
        return {"beta": self._beta, "sigma": np.asarray(self._sigma),
                "intercept": np.asarray(self._intercept)}

    def _set_arrays(self, arrays) -> None:
        """The saved layout, or the model-data table's (a leading axis
        of 1)."""
        beta = np.asarray(arrays["beta"], np.float64)
        self._set(beta[0] if beta.ndim == 2 else beta,
                  float(np.asarray(arrays["sigma"]).reshape(-1)[0]),
                  float(np.asarray(arrays.get("intercept", 0.0))
                        .reshape(-1)[0]))

    def set_model_data(self, *inputs: Table) -> "AFTSurvivalRegressionModel":
        (table,) = inputs
        self._set_arrays({k: table.column(k) for k in table.column_names})
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({
            "beta": self._beta[None, :], "sigma": np.asarray([self._sigma]),
            "intercept": np.asarray([self._intercept]),
        })]

    def _require(self) -> None:
        if self._beta is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        x = features_matrix(table, self.get(self.FEATURES_COL))
        eta = x @ self._beta + self._intercept
        # Weibull median: exp(eta) * ln(2)^sigma.
        median = np.exp(eta) * np.log(2.0) ** self._sigma
        out = table.with_column(self.get(self.PREDICTION_COL), median)
        qs = self.get(self.QUANTILE_PROBABILITIES)
        if qs:
            q = np.asarray(qs, np.float64)
            if (q <= 0).any() or (q >= 1).any():
                raise ValueError(
                    f"quantileProbabilities must lie in (0, 1), got {qs}"
                )
            # T_q = exp(eta) * (-ln(1-q))^sigma.
            mat = np.exp(eta)[:, None] * (
                (-np.log1p(-q))[None, :] ** self._sigma
            )
            out = out.with_column(self.get(self.QUANTILES_COL), mat)
        return (out,)
