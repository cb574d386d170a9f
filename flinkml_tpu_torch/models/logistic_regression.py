"""LogisticRegression — binomial and multinomial logistic regression,
mini-batch SGD, L2.

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

``fit`` also takes an iterable of batch Tables or a sealed
:class:`~flinkml_tpu_torch.iteration.datacache.DataCache` (binomial only):
the streamed, out-of-core fit (:func:`flinkml_tpu_torch.models.
_linear_sgd.streamed_linear_fit`), which spills its epoch-0 cache to
``cache_dir`` beyond ``cache_memory_budget_bytes`` and computes in
float32, as the JAX package's streamed fit does. ``checkpoint_manager``,
``checkpoint_interval`` and ``resume`` snapshot and resume both the
streamed and the in-RAM fits.

``multiClass``: ``auto`` follows the label cardinality (more than two
classes: multinomial), ``binomial`` and ``multinomial`` are taken as set.
A multinomial fit (dense features only, as in the JAX package) trains a
``[k, d]`` matrix by softmax cross-entropy over labels ``0..k-1``
(:func:`flinkml_tpu_torch.models._linear_sgd.train_softmax_model`).
``mesh=`` (a :class:`~flinkml_tpu_torch.parallel.DeviceMesh`) trains the
in-RAM fits data parallel on the mesh's ranks, each on its block of the
rows with one ``all_reduce`` a step, and the model scores dense rows
sharded the same way (every rank passes the same table and receives the
whole result). Sharding plans, precision policies and a mesh for the
streamed fit raise ``NotImplementedError``, naming their ROADMAP.md items.

The model: binomial prediction = ``dot >= 0``, raw prediction = ``[1-p,
p]`` with ``p = sigmoid(dot)``; multinomial prediction = the argmax of the
logits ``x @ Wᵀ`` (first index on ties), raw prediction = their softmax.

- Dense features: one ``torch.matmul`` on the compute device (the JAX
  package leaves this product to XLA); the same math is the stage's
  ``transform_kernel``, whose CUDA form is the head of the ``fused_chain``
  kernel (:mod:`flinkml_tpu_torch.kernels.chain`).
- Sparse features (every row a ``SparseVector``): nnz-bucketed ELL scored
  by the ``spmv`` kernel (:func:`flinkml_tpu_torch.ops.sparse.sparse_margins`;
  a ``[k, d]`` model by a gathered product there); the margins come back
  to the host and the sigmoid or softmax tail runs there in float64.

Dtype rule: the dense path computes in the feature column's dtype (a
non-float column promotes to float64). The JAX package computes this stage
in the dtype its global x64 flag gives (float64 under x64, which is how its
tests run); the port has no such flag, so a float32 column is scored in
float32 here.
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
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models import _linear_sgd
from flinkml_tpu_torch.models._coefficient import CoefficientModelMixin
from flinkml_tpu_torch.models._data import (
    check_binary_labels,
    features_matrix,
    features_tensor,
    labeled_data,
    labeled_sparse_data,
    sharded_rows,
    sparse_features,
)
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.precision import chain_policy
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


#: Elements a CPU elementwise kernel takes in one vectorized step at most
#: (two 512-bit vectors of bytes): see :func:`_full_blocks`.
_CPU_BLOCK = 128


def _full_blocks(fn, v: torch.Tensor) -> torch.Tensor:
    """``fn(v)`` for an elementwise ``fn``, computed on the CPU over whole
    vectorized blocks: PyTorch's CPU kernels for transcendental functions
    (``sigmoid``, ``exp``) take the last ``len % block`` elements through a
    scalar path that can differ from the vector path in the last bit, so
    without the padding a row's value would depend on its position in
    the batch."""
    n = v.shape[0]
    if v.device.type != "cpu" or n % _CPU_BLOCK == 0:
        return fn(v)
    padded = v.new_zeros((n + _CPU_BLOCK - n % _CPU_BLOCK,) + v.shape[1:])
    padded[:n] = v
    return fn(padded)[:n]


def _predict(x: torch.Tensor, coef,
             pred_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """prediction = 1[dot >= 0] (in ``pred_dtype``, default ``x``'s); raw =
    [1-p, p], in ``x``'s dtype. In float32 and float64 the dot is a
    product and a sum along each row, so a row's outputs do not depend on
    the rows beside it (a float32 ``matmul`` on the CPU rounds a row
    differently in batches of different sizes; a served response must
    equal the same rows alone; the sigmoid likewise, see
    :func:`_full_blocks`). A 16-bit row keeps ``matmul``: its products are
    exact and the sum rounds once, as in the kernel."""
    coef = torch.as_tensor(coef).to(device=x.device, dtype=x.dtype)
    if x.dtype in (torch.float32, torch.float64):
        dot = (x * coef).sum(-1)
    else:
        dot = torch.matmul(x, coef)
    p = _full_blocks(torch.sigmoid, dot)
    pred = (dot >= 0).to(pred_dtype or x.dtype)
    raw = torch.stack([1.0 - p, p], dim=-1)
    return pred, raw


def _predict_multinomial(x: torch.Tensor, coef,
                         pred_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """prediction = argmax of the logits ``x @ coef.T`` (first index on
    ties, the first NaN if any; in ``pred_dtype``, default ``x``'s); raw =
    their softmax (max-subtracted, exp over its sum, as
    ``jax.nn.softmax``), in ``x``'s dtype. On the CPU, as in
    :func:`_predict`, a float32 or float64 row's logits are a product and
    a sum along the row, one class at a time (a ``[rows, k, d]`` product
    would not fit at MNIST's width), and the exp runs over whole vector
    blocks, so a row's outputs do not depend on the rows beside it. On the
    card the logits stay one GEMM."""
    coef = torch.as_tensor(coef).to(device=x.device, dtype=x.dtype)
    if x.device.type == "cpu" and x.dtype in (torch.float32, torch.float64):
        logits = torch.stack(
            [(x * coef[j]).sum(-1) for j in range(coef.shape[0])], dim=-1)
    else:
        logits = torch.matmul(x, coef.T)
    e = _full_blocks(
        torch.exp, logits - torch.max(logits, dim=-1, keepdim=True).values)
    raw = e / torch.sum(e, dim=-1, keepdim=True)
    pred = torch.argmax(logits, dim=-1).to(pred_dtype or x.dtype)
    return pred, raw


def _softmax_from_logits(logits: np.ndarray):
    """The host tail of sparse multinomial scoring (float64)."""
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    raw = e / e.sum(axis=-1, keepdims=True)
    pred = np.argmax(logits, axis=-1).astype(np.float64)
    return pred, raw


class LogisticRegressionModel(CoefficientModelMixin, _LogisticRegressionParams, Model):
    """Broadcast-model batch inference: one batched product per table.
    With a ``mesh`` of several ranks, dense rows are scored sharded: each
    rank scores its block and the blocks are gathered (JAX
    ``logistic_regression.py:297-307``)."""

    def __init__(self, mesh=None):
        from flinkml_tpu_torch.parallel.mesh import check_mesh

        super().__init__()
        check_mesh(mesh)
        self.mesh = mesh
        self._coefficient: Optional[np.ndarray] = None

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        c = np.asarray(arrays["coefficient"], dtype=np.float64)
        # [d] or [k, d] as saved, or with the leading axis of 1 that
        # get_model_data tables carry ([1, d], [1, k, d]).
        if c.ndim >= 2 and c.shape[0] == 1:
            c = c[0]
        if c.ndim not in (1, 2):
            raise ValueError(
                "LogisticRegression model data must be a coefficient [d] or "
                f"a class matrix [k, d] (with an optional leading axis of "
                f"1), got shape {np.shape(arrays['coefficient'])}"
            )
        self._coefficient = c

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        pcol = self.get(_LogisticRegressionParams.PREDICTION_COL)
        rcol = self.get(_LogisticRegressionParams.RAW_PREDICTION_COL)
        fcol = self.get(_LogisticRegressionParams.FEATURES_COL)
        multinomial = self._coefficient.ndim == 2
        sparse_col = sparse_features(table, fcol)
        if sparse_col is not None:
            from flinkml_tpu_torch.ops.sparse import sparse_margins

            # Margins arrive on the host; the elementwise tail stays there.
            dot = sparse_margins(sparse_col, self._coefficient)
            if multinomial:
                pred, raw = _softmax_from_logits(dot.astype(np.float64))
            else:
                p = 1.0 / (1.0 + np.exp(-dot.astype(np.float64)))
                pred = (dot >= 0).astype(dot.dtype)
                raw = np.stack([1.0 - p, p], axis=-1)
        elif self.mesh is not None and self.mesh.num_devices > 1:
            # Rows split over the data axis, the coefficient on every rank
            # (the broadcast-model pattern); every rank gathers the result.
            predict = _predict_multinomial if multinomial else _predict
            pred, raw = sharded_rows(
                self.mesh, features_matrix(table, fcol, dtype=None),
                lambda xl: predict(xl, self._coefficient))
        else:
            predict = _predict_multinomial if multinomial else _predict
            pred, raw = predict(features_tensor(table, fcol), self._coefficient)
        return (table.with_column(pcol, pred).with_column(rcol, raw),)

    def transform_kernel(self) -> Optional[ColumnKernel]:
        """Dense inference as a chainable kernel: the same math as the
        per-stage path (binomial or multinomial). Sparse feature columns
        are object columns, which the fused executor never admits, so they
        keep the O(nnz) path."""
        if self._coefficient is None:
            return None
        multinomial = self._coefficient.ndim == 2
        predict = _predict_multinomial if multinomial else _predict
        fcol = self.get(_LogisticRegressionParams.FEATURES_COL)
        pcol = self.get(_LogisticRegressionParams.PREDICTION_COL)
        rcol = self.get(_LogisticRegressionParams.RAW_PREDICTION_COL)

        def fn(cols, consts, valid):
            x = cols[fcol]
            if x.dim() == 1:
                x = x.reshape(-1, 1)
            if not x.dtype.is_floating_point:
                x = x.to(torch.float64)
            pol = chain_policy()
            if pol is None or not pol.declared:
                pred, raw = predict(x, consts["coefficient"])
                return {pcol: pred, rcol: raw}
            # Under a declared policy (as the JAX kernel): the features and
            # the coefficients at policy.compute, the product accumulating
            # at policy.accum (bfloat16 values multiply exactly in float32),
            # the prediction at policy.compute.
            kdt, adt = pol.compute_dtype, pol.accum_dtype
            coef = torch.as_tensor(consts["coefficient"]).to(
                device=x.device, dtype=kdt)
            pred, raw = predict(x.to(kdt).to(adt), coef.to(adt),
                                pred_dtype=kdt)
            return {pcol: pred, rcol: raw}

        return ColumnKernel(
            input_cols=(fcol,), output_cols=(pcol, rcol), fn=fn,
            constants={"coefficient": self._coefficient},
            fingerprint=("LogisticRegressionModel", fcol, pcol, rcol,
                         multinomial),
            pin_inputs=True,
            accumulates="accum",
        )


class LogisticRegression(StreamingEstimatorMixin, _LogisticRegressionParams,
                         Estimator):
    """Fits LR by SGD on the compute device, from a :class:`Table` of dense
    or SparseVector features (binomial), or of dense features
    (multinomial), or from a stream of batch Tables or a sealed
    ``DataCache`` (binomial).

    The constructor takes the JAX estimator's knobs (see
    :class:`~flinkml_tpu_torch.models._streaming.StreamingEstimatorMixin`):
    ``mesh`` trains the in-RAM fits data parallel; ``sharding_plan`` and
    ``precision`` route the dense binomial fit through the plan trainer
    (:func:`flinkml_tpu_torch.sharding.apply.train_linear_plan`) and are
    refused on the sparse, multinomial and streamed fits with the JAX
    package's ``ValueError``.
    """

    _SHARDING_PLAN_AWARE = True
    _PRECISION_AWARE = True

    def fit(self, *inputs) -> LogisticRegressionModel:
        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
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
            mesh=self.mesh,
            **self._checkpoint_kwargs(),
        )
        if sparse_features(table, features_col) is not None:
            if self.sharding_plan is not None:
                raise ValueError(
                    "sharding_plan supports the dense binomial path "
                    "only; the sparse trainer keeps its replicated "
                    "[dim] model (shard it via ROADMAP item 5's "
                    "embedding-table path instead)"
                )
            if self.precision is not None:
                raise ValueError(
                    "precision supports the dense binomial path only; "
                    "the sparse trainer's gather/segment-sum kernels "
                    "are not yet policy-gated"
                )
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
                # Softmax cross-entropy over integer classes 0..k-1: the
                # coefficient is [k, d].
                if self.sharding_plan is not None:
                    raise ValueError(
                        "sharding_plan supports the dense binomial "
                        "path only (the softmax trainer is not yet "
                        "plan-aware)"
                    )
                if self.precision is not None:
                    raise ValueError(
                        "precision supports the dense binomial path "
                        "only (the softmax trainer is not yet "
                        "policy-gated)"
                    )
                num_classes = _check_multinomial_labels(y)
                coef = _linear_sgd.train_softmax_model(
                    x, y, w, num_classes=num_classes, elastic_net=0.0,
                    **hyper,
                )
            else:
                _check_binomial_labels(y)
                coef = train_logistic_regression(
                    x, y, w, sharding_plan=self.sharding_plan,
                    precision=self.precision, **hyper)

        model = LogisticRegressionModel(mesh=self.mesh)
        model.copy_params_from(self)
        model.set_model_data(Table({"coefficient": coef[None, ...]}))
        return model

    def _fit_stream(self, source) -> LogisticRegressionModel:
        """The out-of-core fit from an iterable of batch Tables or a
        DataCache (``ReplayOperator.java:62-250`` parity)."""
        if self.get(_LogisticRegressionParams.MULTI_CLASS) == "multinomial":
            raise ValueError(
                "multinomial logistic regression does not support "
                "streamed fits; materialize the data as a Table"
            )
        if self.sharding_plan is not None:
            raise ValueError(
                "sharding_plan supports in-RAM Table fits only; streamed "
                "fits keep their replicated carry"
            )
        if self.precision is not None:
            raise ValueError(
                "precision supports in-RAM Table fits only; the streamed "
                "trainer is not yet policy-gated"
            )
        coef = _linear_sgd.streamed_linear_fit(
            source,
            features_col=self.get(_LogisticRegressionParams.FEATURES_COL),
            label_col=self.get(_LogisticRegressionParams.LABEL_COL),
            weight_col=self.get(_LogisticRegressionParams.WEIGHT_COL),
            label_check=_check_stream_labels,
            loss="logistic",
            max_iter=self.get(_LogisticRegressionParams.MAX_ITER),
            learning_rate=self.get(_LogisticRegressionParams.LEARNING_RATE),
            reg=self.get(_LogisticRegressionParams.REG),
            elastic_net=0.0,
            tol=self.get(_LogisticRegressionParams.TOL),
            cache_dir=self.cache_dir,
            memory_budget_bytes=self.cache_memory_budget_bytes,
            mesh=self.mesh,
            **self._checkpoint_kwargs(),
        )
        model = LogisticRegressionModel(mesh=self.mesh)
        model.copy_params_from(self)
        model.set_model_data(Table({"coefficient": coef[None, :]}))
        return model


def _check_binomial_labels(y: np.ndarray) -> None:
    check_binary_labels(y, "binomial logistic regression")


def _check_stream_labels(y: np.ndarray) -> None:
    """Streamed fits are binomial only: more than two classes get that
    limitation in the message."""
    try:
        _check_binomial_labels(y)
    except ValueError as e:
        raise ValueError(
            f"{e}; multinomial (>2 classes) is not supported for "
            "streamed fits — materialize the data as a Table"
        ) from None


def _check_multinomial_labels(y: np.ndarray) -> int:
    """Labels must be exactly the integers 0..k-1 (every class present);
    returns k. Guards against phantom classes and against a single
    outlier label allocating a huge [maxLabel+1, d] matrix."""
    uniq = np.unique(y)
    if (
        not np.all(uniq == np.round(uniq))
        or uniq.min() < 0
        or uniq.size != int(uniq.max()) + 1
    ):
        raise ValueError(
            "multinomial logistic regression requires integer labels "
            f"covering 0..k-1 exactly, got {uniq[:6]}"
            f"{'...' if uniq.size > 6 else ''}"
        )
    return int(uniq.max()) + 1


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
    checkpoint_interval: int = 0,
    resume: bool = False,
    sharding_plan=None,
    precision=None,
    mesh=None,
) -> np.ndarray:
    """The SGD loop; returns the fitted coefficient on the host (over
    ``mesh``, data parallel on its ranks).

    - ``mode="device"``: the whole epoch loop on the compute device with
      its carry there
      (:func:`flinkml_tpu_torch.models._linear_sgd.train_linear_model`),
      in ``checkpoint_interval``-epoch dispatches with a checkpoint
      manager; listeners fire after each dispatch.
    - ``mode="host"``: one step per epoch driven by
      :func:`flinkml_tpu_torch.iteration.iterate`: listeners and
      checkpoints at every epoch, one dispatch and one read of the loss
      per epoch. On a mesh of several ranks its snapshots are agreed
      commits (:class:`~flinkml_tpu_torch.iteration.checkpoint.
      AgreedCommits`: the mesh's first rank writes).
    """
    if mode not in ("device", "host"):
        raise ValueError(f"mode must be 'device' or 'host', got {mode!r}")
    if mode == "device":
        return _linear_sgd.train_linear_model(
            x, y, w, loss="logistic", max_iter=max_iter,
            learning_rate=learning_rate, global_batch_size=global_batch_size,
            reg=reg, elastic_net=0.0, tol=tol, seed=seed, dtype=dtype,
            listeners=listeners, checkpoint_manager=checkpoint_manager,
            checkpoint_interval=checkpoint_interval, resume=resume,
            sharding_plan=sharding_plan, precision=precision, mesh=mesh,
        )
    if sharding_plan is not None:
        raise ValueError(
            "sharding_plan is supported in mode='device' only (the host "
            "iterate loop replicates its carry)"
        )
    if precision is not None:
        raise ValueError(
            "precision is supported in mode='device' only (the "
            "policy-gated step lives on the plan-sharded path)"
        )
    _linear_sgd.check_mesh(mesh)
    from flinkml_tpu_torch.iteration import (
        IterationConfig,
        TerminateOnMaxIterOrTol,
        iterate,
    )
    from flinkml_tpu_torch.iteration.checkpoint import AgreedCommits

    n, dim = x.shape
    if dtype is None:
        dtype = x.dtype if x.dtype.kind == "f" else np.float64
    x, y, w = (np.asarray(a, dtype=dtype) for a in (x, y, w))
    perm = np.random.default_rng(seed).permutation(n)
    x, y, w = x[perm], y[perm], w[perm]
    device = default_device() if mesh is None else mesh.device
    xd, yd, wd = _linear_sgd.shard_rows(mesh, (x, y, w), device)
    local_bs = _linear_sgd.align_local_bs(
        global_batch_size, _linear_sgd.p_size(mesh), xd.shape[0])
    local_step = _linear_sgd.make_dense_step("logistic", local_bs, mesh)
    dt = xd.dtype
    hy = tuple(torch.tensor(v, dtype=dt, device=device)
               for v in (learning_rate, reg, 0.0))

    def epoch_step(state, epoch):
        # A restored carry comes back from the checkpoint as numpy.
        coef = torch.as_tensor(state).to(device=device, dtype=dt)
        return local_step(coef, epoch, xd, yd, wd, *hy)

    if checkpoint_manager is not None:
        checkpoint_manager.world_size = 1 if mesh is None else mesh.num_devices
        if _linear_sgd.multi_rank(mesh):
            # The loop saves on every rank: the mesh's first rank writes,
            # every rank agrees on the commit and on the restore.
            checkpoint_manager = AgreedCommits(checkpoint_manager, mesh)
    result = iterate(
        epoch_step, torch.zeros(dim, dtype=dt, device=device),
        config=IterationConfig(
            TerminateOnMaxIterOrTol(max_iter, tol),
            checkpoint_interval=checkpoint_interval,
            checkpoint_manager=checkpoint_manager,
        ),
        listeners=listeners, resume=resume,
    )
    return torch.as_tensor(result.state).cpu().numpy()
