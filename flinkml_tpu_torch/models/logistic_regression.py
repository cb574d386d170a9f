"""LogisticRegressionModel — binomial logistic regression inference.

The port's counterpart of the model half of
``flinkml_tpu.models.logistic_regression`` (reference:
``LogisticRegressionModel.java:100-170``): prediction = ``dot >= 0``, raw
prediction = ``[1-p, p]`` with ``p = sigmoid(dot)``.

- Dense features: one ``torch.matmul`` on the compute device (the JAX
  package leaves this product to XLA); the same math is the stage's
  ``transform_kernel``, whose CUDA form is the head of the ``fused_chain``
  kernel (:mod:`flinkml_tpu_torch.kernels.chain`).
- Sparse features (every row a ``SparseVector``): nnz-bucketed ELL scored
  by the ``spmv`` kernel (:func:`flinkml_tpu_torch.ops.sparse.sparse_margins`);
  the margins come back to the host and the sigmoid tail runs there in
  float64.

Dtype rule: the dense path computes in the feature column's dtype (a
non-float column promotes to float64). The JAX package computes this stage
in the dtype its global x64 flag gives (float64 under x64, which is how its
tests run); the port has no such flag, so a float32 column is scored in
float32 here.

The ``LogisticRegression`` estimator (``fit``) and multinomial model data
come with later slices of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import ColumnKernel, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasMultiClass,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasSeed,
    HasTol,
    HasWeightCol,
)
from flinkml_tpu_torch.models._coefficient import CoefficientModelMixin
from flinkml_tpu_torch.models._data import features_tensor, sparse_features
from flinkml_tpu_torch.table import Table


class _LogisticRegressionParams(
    HasFeaturesCol,
    HasLabelCol,
    HasWeightCol,
    HasMaxIter,
    HasReg,
    HasLearningRate,
    HasGlobalBatchSize,
    HasTol,
    HasSeed,
    HasMultiClass,
    HasPredictionCol,
    HasRawPredictionCol,
):
    """Params shared by estimator and model (reference:
    LogisticRegressionParams / LogisticRegressionModelParams)."""


def _predict(x: torch.Tensor, coef) -> Tuple[torch.Tensor, torch.Tensor]:
    """prediction = 1[dot >= 0]; raw = [1-p, p], in ``x``'s dtype."""
    coef = torch.as_tensor(coef).to(device=x.device, dtype=x.dtype)
    dot = torch.matmul(x, coef)
    p = torch.sigmoid(dot)
    pred = (dot >= 0).to(x.dtype)
    raw = torch.stack([1.0 - p, p], dim=-1)
    return pred, raw


class LogisticRegressionModel(CoefficientModelMixin, _LogisticRegressionParams, Model):
    """Broadcast-model batch inference: one batched product per table."""

    def __init__(self):
        super().__init__()
        self._coefficient: Optional[np.ndarray] = None

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        c = np.asarray(arrays["coefficient"], dtype=np.float64)
        # [d] as saved, or [1, d] as get_model_data tables carry it.
        if c.ndim >= 2 and c.shape[0] == 1:
            c = c[0]
        if c.ndim != 1:
            raise NotImplementedError(
                f"multinomial LogisticRegression model data (coefficient "
                f"shape {c.shape}) is not ported yet: it comes with the "
                "multinomial LogisticRegression slice of flinkml_tpu_torch"
            )
        self._coefficient = c

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        pcol = self.get(_LogisticRegressionParams.PREDICTION_COL)
        rcol = self.get(_LogisticRegressionParams.RAW_PREDICTION_COL)
        fcol = self.get(_LogisticRegressionParams.FEATURES_COL)
        sparse_col = sparse_features(table, fcol)
        if sparse_col is not None:
            from flinkml_tpu_torch.ops.sparse import sparse_margins

            # Margins arrive on the host; the elementwise tail stays there.
            dot = sparse_margins(sparse_col, self._coefficient)
            p = 1.0 / (1.0 + np.exp(-dot.astype(np.float64)))
            pred = (dot >= 0).astype(dot.dtype)
            raw = np.stack([1.0 - p, p], axis=-1)
        else:
            pred, raw = _predict(features_tensor(table, fcol), self._coefficient)
        return (table.with_column(pcol, pred).with_column(rcol, raw),)

    def transform_kernel(self) -> Optional[ColumnKernel]:
        """Dense inference as a chainable kernel: the same math as the
        per-stage path. Sparse feature columns are object columns, which
        the fused executor never admits, so they keep the O(nnz) path."""
        if self._coefficient is None:
            return None
        fcol = self.get(_LogisticRegressionParams.FEATURES_COL)
        pcol = self.get(_LogisticRegressionParams.PREDICTION_COL)
        rcol = self.get(_LogisticRegressionParams.RAW_PREDICTION_COL)

        def fn(cols, consts, valid):
            x = cols[fcol]
            if x.dim() == 1:
                x = x.reshape(-1, 1)
            if not x.dtype.is_floating_point:
                x = x.to(torch.float64)
            pred, raw = _predict(x, consts["coefficient"])
            return {pcol: pred, rcol: raw}

        return ColumnKernel(
            input_cols=(fcol,), output_cols=(pcol, rcol), fn=fn,
            constants={"coefficient": self._coefficient},
            fingerprint=("LogisticRegressionModel", fcol, pcol, rcol, False),
            pin_inputs=True,
        )
