"""LinearSVC — linear support vector classifier by proximal SGD.

The port's counterpart of ``flinkml_tpu.models.linear_svc`` (BASELINE.json
config #3). Training is the shared linear trainer
(:mod:`flinkml_tpu_torch.models._linear_sgd`) under the hinge loss: L2 in
the gradient, L1 (``elasticNet``) by the proximal soft-threshold. Dense
features train by the dense step (``torch.matmul``), SparseVector features
by the nnz-bucketed sparse step (the ``spmv`` and ``segment_sum``
kernels). ``fit`` also takes an iterable of batch Tables or a sealed
:class:`~flinkml_tpu_torch.iteration.datacache.DataCache`: the streamed,
out-of-core fit, checkpointable like the in-RAM ones.

The model: ``rawPrediction = x · coef``, ``prediction = 1[raw >=
threshold]``. Dense features are scored by one product on the compute
device, SparseVector features by
:func:`flinkml_tpu_torch.ops.sparse.sparse_margins` (the ``spmv`` kernel).

``mesh=`` (a :class:`~flinkml_tpu_torch.parallel.DeviceMesh`) trains the
in-RAM fits data parallel on its ranks and scores dense rows sharded over
them (the JAX package's LinearSVCModel has no sharded transform; the
port's gives the same values).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasSeed,
    HasTol,
    HasWeightCol,
)
from flinkml_tpu_torch.models import _linear_sgd
from flinkml_tpu_torch.models._coefficient import (
    CoefficientModelMixin,
    linear_margins,
)
from flinkml_tpu_torch.models._data import check_binary_labels
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.parallel.mesh import check_mesh
from flinkml_tpu_torch.params import FloatParam
from flinkml_tpu_torch.table import Table


class _LinearSVCParams(
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
    HasRawPredictionCol,
):
    THRESHOLD = FloatParam(
        "threshold", "Decision threshold on the raw prediction.", 0.0
    )


def _check_labels(y: np.ndarray) -> None:
    check_binary_labels(y, "LinearSVC")


class LinearSVC(StreamingEstimatorMixin, _LinearSVCParams, Estimator):
    """Fits a LinearSVC from a Table (dense or SparseVector features), an
    iterable of batch Tables, or a sealed DataCache. ``sharding_plan``
    and ``precision`` take the dense in-RAM fit through the plan trainer
    and are refused on the other paths (the JAX package's
    ``ValueError``)."""

    _SHARDING_PLAN_AWARE = True
    _PRECISION_AWARE = True

    def _make_model(self, coef) -> "LinearSVCModel":
        model = LinearSVCModel(mesh=self.mesh)
        model.copy_params_from(self)
        model.set_model_data(Table({"coefficient": coef[None, :]}))
        return model

    def _hyper(self) -> dict:
        return dict(
            loss="hinge",
            max_iter=self.get(_LinearSVCParams.MAX_ITER),
            learning_rate=self.get(_LinearSVCParams.LEARNING_RATE),
            reg=self.get(_LinearSVCParams.REG),
            elastic_net=self.get(_LinearSVCParams.ELASTIC_NET),
            tol=self.get(_LinearSVCParams.TOL),
            **self._checkpoint_kwargs(),
        )

    def fit(self, *inputs) -> "LinearSVCModel":
        (table,) = inputs
        cols = dict(features_col=self.get(_LinearSVCParams.FEATURES_COL),
                    label_col=self.get(_LinearSVCParams.LABEL_COL),
                    weight_col=self.get(_LinearSVCParams.WEIGHT_COL))
        if not isinstance(table, Table):
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
                table, label_check=_check_labels,
                cache_dir=self.cache_dir, mesh=self.mesh,
                memory_budget_bytes=self.cache_memory_budget_bytes,
                **cols, **self._hyper(),
            )
            return self._make_model(coef)
        coef = _linear_sgd.train_linear_model_from_table(
            table, *cols.values(), label_check=_check_labels,
            global_batch_size=self.get(_LinearSVCParams.GLOBAL_BATCH_SIZE),
            seed=self.get_seed(), mesh=self.mesh,
            sharding_plan=self.sharding_plan, precision=self.precision,
            **self._hyper(),
        )
        return self._make_model(coef)


class LinearSVCModel(CoefficientModelMixin, _LinearSVCParams, Model):
    def __init__(self, mesh=None):
        super().__init__()
        check_mesh(mesh)
        self.mesh = mesh
        self._coefficient: Optional[np.ndarray] = None

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        dot = linear_margins(table, self.get(_LinearSVCParams.FEATURES_COL),
                             self._coefficient, self.mesh)
        pred = (dot >= self.get(_LinearSVCParams.THRESHOLD)).astype(np.float64)
        out = table.with_column(
            self.get(_LinearSVCParams.PREDICTION_COL), pred
        ).with_column(self.get(_LinearSVCParams.RAW_PREDICTION_COL), dot)
        return (out,)
