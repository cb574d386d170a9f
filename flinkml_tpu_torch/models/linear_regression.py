"""LinearRegression — least squares by proximal SGD or the normal
equations.

The port's counterpart of ``flinkml_tpu.models.linear_regression``
(BASELINE.json config #3).

- ``solver="sgd"`` (default): the shared linear trainer
  (:mod:`flinkml_tpu_torch.models._linear_sgd`) under the squared loss;
  L2 (ridge), L1 (lasso) and elastic net by the proximal step. Dense and
  SparseVector features in RAM, and streamed fits (an iterable of batch
  Tables or a sealed DataCache), checkpointable.
- ``solver="normal"``: the exact weighted ridge solution. The ``[d, d]``
  normal matrix ``XᵀWX`` and ``XᵀWy`` are two float32 products on the
  compute device (``torch.matmul``; the JAX package leaves this product to
  XLA too), then a float64 solve on the host (``lstsq`` at ``reg == 0``,
  the minimum-norm solution). Dense features, in RAM, no elastic net.

The model: ``prediction = x · coef`` (dense: one product on the compute
device; SparseVector rows: the ``spmv`` kernel).

``mesh=`` (a :class:`~flinkml_tpu_torch.parallel.DeviceMesh`) runs both
solvers data parallel on its ranks (SGD: one ``all_reduce`` a step; the
normal equations: each rank's ``XᵀWX`` and ``XᵀWy`` summed by one
``all_reduce``, the JAX package's ``psum``s) and scores dense rows sharded
over them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasReg,
    HasSeed,
    HasTol,
    HasWeightCol,
)
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models import _linear_sgd
from flinkml_tpu_torch.models._coefficient import (
    CoefficientModelMixin,
    linear_margins,
)
from flinkml_tpu_torch.models._data import labeled_data, sparse_features
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.parallel.mesh import check_mesh
from flinkml_tpu_torch.params import ParamValidators, StringParam
from flinkml_tpu_torch.table import Table


class _LinearRegressionParams(
    HasFeaturesCol,
    HasLabelCol,
    HasWeightCol,
    HasMaxIter,
    HasReg,
    HasElasticNet,
    HasLearningRate,
    HasGlobalBatchSize,
    HasTol,
    HasSeed,
    HasPredictionCol,
):
    SOLVER = StringParam(
        "solver",
        "'sgd' (proximal minibatch SGD) or 'normal' (exact weighted "
        "ridge OLS via one sharded gram pass + host f64 solve).",
        "sgd", ParamValidators.in_array(["sgd", "normal"]),
    )


def normal_equation_terms(x: np.ndarray, y: np.ndarray, w: np.ndarray,
                          mesh=None):
    """``(XᵀWX, XᵀWy)`` in float32 on the compute device, returned as
    float64 host arrays. Over a ``mesh`` each rank computes its block's
    terms and one ``all_reduce`` of ``[XᵀWX | XᵀWy]`` sums them."""
    device = default_device() if mesh is None else mesh.device
    xd, yd, wd = _linear_sgd.shard_rows(
        mesh, tuple(np.asarray(a, np.float32) for a in (x, y, w)), device)
    xw = xd * wd[:, None]
    a = torch.matmul(xd.T, xw)
    b = torch.matmul(xw.T, yd)
    if mesh is not None:
        from flinkml_tpu_torch.parallel.collectives import all_reduce_

        d = a.shape[0]
        buf = all_reduce_(mesh, torch.cat([a.reshape(-1), b]))
        a, b = buf[:d * d].reshape(d, d), buf[d * d:]
    return a.cpu().numpy().astype(np.float64), b.cpu().numpy().astype(np.float64)


def _fit_normal_equations(table, features_col, label_col, weight_col,
                          reg: float, mesh=None) -> np.ndarray:
    """Exact weighted ridge OLS at the SGD solver's fixed point: the
    trainer's gradient is ``XᵀW·err + 2·reg·c``, so both solvers solve
    ``(XᵀWX + 2·reg·I) c = XᵀWy`` (sklearn Ridge: α = 2·reg)."""
    x, y, w = labeled_data(table, features_col, label_col, weight_col)
    a64, b64 = normal_equation_terms(x, y, w, mesh)
    if reg > 0:
        a64 += 2.0 * reg * np.eye(a64.shape[0])
        return np.linalg.solve(a64, b64)
    # reg == 0: a rank-deficient (collinear) gram takes the min-norm
    # solution, as sklearn's lstsq does.
    coef, _, _, _ = np.linalg.lstsq(a64, b64, rcond=None)
    return coef


class LinearRegression(StreamingEstimatorMixin, _LinearRegressionParams,
                       Estimator):
    """Fits a LinearRegression from a Table, an iterable of batch Tables
    or a sealed DataCache (``solver="sgd"``), or a dense Table
    (``solver="normal"``). ``sharding_plan`` and ``precision`` take the
    dense in-RAM ``sgd`` fit through the plan trainer and are refused on
    the other paths (the JAX package's ``ValueError``)."""

    _SHARDING_PLAN_AWARE = True
    _PRECISION_AWARE = True

    def _make_model(self, coef) -> "LinearRegressionModel":
        model = LinearRegressionModel(mesh=self.mesh)
        model.copy_params_from(self)
        model.set_model_data(Table({"coefficient": coef[None, :]}))
        return model

    def _hyper(self) -> dict:
        return dict(
            loss="squared",
            max_iter=self.get(_LinearRegressionParams.MAX_ITER),
            learning_rate=self.get(_LinearRegressionParams.LEARNING_RATE),
            reg=self.get(_LinearRegressionParams.REG),
            elastic_net=self.get(_LinearRegressionParams.ELASTIC_NET),
            tol=self.get(_LinearRegressionParams.TOL),
            **self._checkpoint_kwargs(),
        )

    def fit(self, *inputs) -> "LinearRegressionModel":
        (table,) = inputs
        cols = (self.get(_LinearRegressionParams.FEATURES_COL),
                self.get(_LinearRegressionParams.LABEL_COL),
                self.get(_LinearRegressionParams.WEIGHT_COL))
        normal = self.get(self.SOLVER) == "normal"
        if not isinstance(table, Table):
            if normal:
                raise ValueError(
                    "solver='normal' does not support streamed fits (the "
                    "closed form needs the full gram); use solver='sgd'"
                )
            if self.sharding_plan is not None:
                raise ValueError(
                    "sharding_plan supports in-RAM Table fits only; "
                    "streamed fits keep their replicated carry"
                )
            if self.precision is not None:
                raise ValueError(
                    "precision supports in-RAM Table fits only; the "
                    "streamed trainer is not yet policy-gated"
                )
            coef = _linear_sgd.streamed_linear_fit(
                table, features_col=cols[0], label_col=cols[1],
                weight_col=cols[2], cache_dir=self.cache_dir, mesh=self.mesh,
                memory_budget_bytes=self.cache_memory_budget_bytes,
                **self._hyper(),
            )
            return self._make_model(coef)
        if normal:
            if self.checkpoint_manager is not None or self.resume:
                raise ValueError(
                    "solver='normal' is a one-shot closed form; "
                    "checkpointing applies to solver='sgd'"
                )
            if self.sharding_plan is not None:
                raise ValueError(
                    "solver='normal' does not thread a sharding_plan "
                    "(the closed form materializes the replicated "
                    "[d, d] gram); use solver='sgd'"
                )
            if self.precision is not None:
                raise ValueError(
                    "solver='normal' does not thread a precision policy "
                    "(the closed form is a one-shot f32 solve); use "
                    "solver='sgd'"
                )
            if self.get(self.ELASTIC_NET) > 0:
                raise ValueError(
                    "solver='normal' has no closed form for elasticNet > 0; "
                    "use solver='sgd'"
                )
            if sparse_features(table, cols[0]) is not None:
                raise ValueError(
                    "solver='normal' requires dense features (the [d, d] "
                    "normal matrix is dense); use solver='sgd' for the "
                    "sparse path"
                )
            return self._make_model(
                _fit_normal_equations(table, *cols, self.get(self.REG),
                                      self.mesh))
        coef = _linear_sgd.train_linear_model_from_table(
            table, *cols,
            global_batch_size=self.get(
                _LinearRegressionParams.GLOBAL_BATCH_SIZE),
            seed=self.get_seed(), mesh=self.mesh,
            sharding_plan=self.sharding_plan, precision=self.precision,
            **self._hyper(),
        )
        return self._make_model(coef)


class LinearRegressionModel(CoefficientModelMixin, _LinearRegressionParams,
                            Model):
    def __init__(self, mesh=None):
        super().__init__()
        check_mesh(mesh)
        self.mesh = mesh
        self._coefficient: Optional[np.ndarray] = None

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        pred = linear_margins(
            table, self.get(_LinearRegressionParams.FEATURES_COL),
            self._coefficient, self.mesh)
        return (table.with_column(
            self.get(_LinearRegressionParams.PREDICTION_COL), pred),)
