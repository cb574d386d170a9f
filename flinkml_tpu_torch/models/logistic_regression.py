"""LogisticRegression — binomial logistic regression, mini-batch SGD, L2.

The port's counterpart of ``flinkml_tpu.models.logistic_regression``
(reference: ``LogisticRegression.java:76-454``,
``LogisticRegressionModel.java:100-170``).

``LogisticRegression.fit`` trains on the compute device
(:mod:`flinkml_tpu_torch.models._linear_sgd`): dense features by the dense
SGD step, SparseVector features by the nnz-bucketed sparse step (``spmv``
forward, ``segment_sum`` gradient). Loss, update and termination are the
JAX package's: ``loss = Σ wᵢ·log(1+exp(-ŷᵢ·(2yᵢ-1)))``, ``coef -=
lr/weightSum · grad``, stop after ``maxIter`` epochs or when the epoch's
weighted-mean loss is not above ``tol``. The fit computes in the feature
column's floating dtype (float64 for anything else); the JAX package
computes in the dtype its global x64 flag gives.

Binomial only: labels outside {0, 1} under ``multiClass`` ``auto``
(more than two classes) or ``multinomial`` raise ``NotImplementedError``
(ROADMAP.md Queue 1 item 2). Streamed fits, checkpointing, meshes, sharding
plans and precision policies raise too, naming their ROADMAP.md items.

The model: prediction = ``dot >= 0``, raw prediction = ``[1-p, p]`` with
``p = sigmoid(dot)``.

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

Multinomial model data comes with a later slice of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import ColumnKernel, Estimator, Model
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
from flinkml_tpu_torch.models import _linear_sgd
from flinkml_tpu_torch.models._coefficient import CoefficientModelMixin
from flinkml_tpu_torch.models._data import (
    check_binary_labels,
    features_tensor,
    labeled_data,
    labeled_sparse_data,
    sparse_features,
)
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


class LogisticRegression(_LogisticRegressionParams, Estimator):
    """Fits binomial LR by SGD on the compute device, from a :class:`Table`
    of dense or SparseVector features.

    The constructor takes the JAX estimator's knobs; every one whose path
    is not ported yet (``mesh``, ``cache_dir``,
    ``cache_memory_budget_bytes``, ``checkpoint_manager``, ``resume``,
    ``sharding_plan``, ``precision``) raises ``NotImplementedError`` naming
    its ROADMAP.md item when it is set (``checkpoint_interval`` acts only
    with a ``checkpoint_manager``, as in the JAX package).
    """

    def __init__(self, mesh=None, cache_dir=None,
                 cache_memory_budget_bytes=None, checkpoint_manager=None,
                 checkpoint_interval: int = 0, resume: bool = False,
                 sharding_plan=None, precision=None):
        super().__init__()
        _linear_sgd.refuse_unported(
            mesh=mesh, cache_dir=cache_dir,
            cache_memory_budget_bytes=cache_memory_budget_bytes,
            checkpoint_manager=checkpoint_manager, resume=resume,
            sharding_plan=sharding_plan, precision=precision,
        )

    def fit(self, *inputs) -> LogisticRegressionModel:
        (table,) = inputs
        if not isinstance(table, Table):
            raise NotImplementedError(
                "streamed fits (an iterable of batch Tables or a DataCache) "
                "are not ported to flinkml_tpu_torch yet: they come with "
                "ROADMAP.md Queue 1 item 5 (streamed and out-of-core fits)"
            )
        multi_class = self.get(_LogisticRegressionParams.MULTI_CLASS)
        features_col = self.get(_LogisticRegressionParams.FEATURES_COL)
        label_col = self.get(_LogisticRegressionParams.LABEL_COL)
        weight_col = self.get(_LogisticRegressionParams.WEIGHT_COL)
        hyper = dict(
            max_iter=self.get(_LogisticRegressionParams.MAX_ITER),
            learning_rate=self.get(_LogisticRegressionParams.LEARNING_RATE),
            global_batch_size=self.get(
                _LogisticRegressionParams.GLOBAL_BATCH_SIZE),
            reg=self.get(_LogisticRegressionParams.REG),
            tol=self.get(_LogisticRegressionParams.TOL),
            seed=self.get_seed(),
        )
        if sparse_features(table, features_col) is not None:
            indptr, indices, values, dim, y, w = labeled_sparse_data(
                table, features_col, label_col, weight_col)
            if _resolve_multi_class(multi_class, y) == "multinomial":
                raise ValueError(
                    "multinomial logistic regression supports dense "
                    "features only; one-hot/sparse inputs train one "
                    "binomial model per concept"
                )
            _check_binomial_labels(y)
            coef = _linear_sgd.train_linear_model_sparse_csr(
                indptr, indices, values, dim, y, w, loss="logistic",
                elastic_net=0.0, **hyper,
            )
        else:
            x, y, w = labeled_data(table, features_col, label_col,
                                   weight_col, dtype=None)
            if x.shape[0] == 0:
                raise ValueError("training table is empty")
            if _resolve_multi_class(multi_class, y) == "multinomial":
                raise NotImplementedError(
                    "multinomial (softmax) LogisticRegression fit is not "
                    "ported to flinkml_tpu_torch yet: it comes with "
                    "ROADMAP.md Queue 1 item 2 (multinomial "
                    "LogisticRegression)"
                )
            _check_binomial_labels(y)
            coef = train_logistic_regression(x, y, w, **hyper)

        model = LogisticRegressionModel()
        model.copy_params_from(self)
        model.set_model_data(Table({"coefficient": coef[None, ...]}))
        return model


def _check_binomial_labels(y: np.ndarray) -> None:
    check_binary_labels(y, "binomial logistic regression")


def _resolve_multi_class(multi_class: str, y: np.ndarray) -> str:
    """'auto' follows the label cardinality (≤2 → binomial), like the
    wider flink-ml family; explicit settings are honored as-is."""
    if multi_class != "auto":
        return multi_class
    return "multinomial" if np.unique(y).size > 2 else "binomial"


def train_logistic_regression(
    x: np.ndarray,
    y: np.ndarray,
    w: np.ndarray,
    max_iter: int,
    learning_rate: float,
    global_batch_size: int,
    reg: float,
    tol: float,
    seed: int,
    dtype=None,
    mode: str = "device",
    listeners=(),
    checkpoint_manager=None,
    resume: bool = False,
    sharding_plan=None,
    precision=None,
) -> np.ndarray:
    """The SGD loop; returns the fitted coefficient on the host.

    ``mode="device"`` (the only mode ported) runs the whole epoch loop on
    the compute device with its carry there
    (:func:`flinkml_tpu_torch.models._linear_sgd.train_linear_model`);
    ``listeners`` fire once, when it ends. ``mode="host"`` (one dispatch
    per epoch through ``iterate``) raises ``NotImplementedError``
    (ROADMAP.md Queue 1 item 15).
    """
    if mode not in ("device", "host"):
        raise ValueError(f"mode must be 'device' or 'host', got {mode!r}")
    if mode == "host":
        raise NotImplementedError(
            "mode='host' (the per-epoch iterate loop) is not ported to "
            "flinkml_tpu_torch yet: it comes with ROADMAP.md Queue 1 item "
            "15 (the iterate runtime and host mode); use mode='device'"
        )
    return _linear_sgd.train_linear_model(
        x, y, w, loss="logistic", max_iter=max_iter,
        learning_rate=learning_rate, global_batch_size=global_batch_size,
        reg=reg, elastic_net=0.0, tol=tol, seed=seed, dtype=dtype,
        listeners=listeners, checkpoint_manager=checkpoint_manager,
        resume=resume, sharding_plan=sharding_plan, precision=precision,
    )
