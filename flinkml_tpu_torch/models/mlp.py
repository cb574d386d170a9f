"""MLPClassifier and MLPRegressor — multilayer perceptrons (the Spark/Flink
``MultilayerPerceptronClassifier`` family member).

The port's counterpart of ``flinkml_tpu.models.mlp``: the fit runs Adam
steps on the compute device through the shared trainer
(:mod:`flinkml_tpu_torch.models._adam`: threefry minibatch draws,
``torch.autograd`` gradients, one ``all_reduce`` a step on a mesh), every
layer a matrix product. (The upstream operator trains with L-BFGS on the
JVM; both packages use Adam instead and document it.)

Architecture: ``layers = [d_in, h_1, ..., h_k, n_out]``, tanh hidden
activations, He-scaled Gaussian init from ``threefry.split`` /
``threefry.normal`` (JAX's draws); the classifier takes class ids
``0..n_classes-1`` and a log-softmax loss, the regressor a squared loss.
Only the classifier has ``rawPredictionCol``. Prediction runs on the host
in float64, as in the JAX package; model data, ``save`` and ``load`` use
its format.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
    HasRawPredictionCol,
    HasSeed,
    HasTol,
)
from flinkml_tpu_torch.models._adam import flat_params, make_adam_trainer
from flinkml_tpu_torch.models._data import features_matrix, labeled_data
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.ops import threefry
from flinkml_tpu_torch.params import IntArrayParam, ParamValidators
from flinkml_tpu_torch.table import Table


class _MLPParams(
    HasFeaturesCol, HasLabelCol, HasPredictionCol,
    HasMaxIter, HasLearningRate, HasGlobalBatchSize, HasTol, HasSeed,
):
    LAYERS = IntArrayParam(
        "layers",
        "Sizes of every layer, input first, output last.",
        None, ParamValidators.non_empty_array(),
    )


class _MLPClassifierParams(_MLPParams, HasRawPredictionCol):
    """Only the classifier emits a rawPrediction column; the regressor
    must not carry the dead param."""


def _init_params(layers: List[int], key: torch.Tensor) -> List:
    """``[(w_i, b_i)]``: ``w_i = normal(sub_i, [l_i, l_{i+1}]) ·
    sqrt(2 / l_i)`` (the scale in float64, rounded once to float32 as JAX
    with x64 rounds it), ``b_i = 0``; ``key, sub_i = split(key)`` per
    layer."""
    params = []
    for i in range(len(layers) - 1):
        key, sub = threefry.split(key)
        scale = float(np.float32(np.sqrt(2.0 / layers[i])))
        params.append((
            threefry.normal(sub, (layers[i], layers[i + 1])) * scale,
            torch.zeros(layers[i + 1], dtype=torch.float32,
                        device=key.device),
        ))
    return params


def _forward(params, x):
    """params: flat tuple (w0, b0, w1, b1, ...); returns logits."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers - 1):
        h = torch.tanh(h @ params[2 * i] + params[2 * i + 1])
    return h @ params[-2] + params[-1]


def _mlp_loss_builder():
    def local_loss(params, xb, yb, wb):
        logp = torch.log_softmax(_forward(params, xb), dim=1)
        nll = -torch.gather(logp, 1, yb.long()[:, None])[:, 0]
        return torch.sum(nll * wb)

    return local_loss


def _mlp_squared_loss_builder():
    def local_loss(params, xb, yb, wb):
        err = _forward(params, xb)[:, 0] - yb
        return 0.5 * torch.sum(err * err * wb)

    return local_loss


def _mesh_and_device(mesh):
    """``(mesh, device)``: the fit's world-1 mesh when none is given."""
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh

    mesh = mesh if mesh is not None else DeviceMesh()
    return mesh, mesh.device


class _MLPBase(StreamingEstimatorMixin, _MLPParams, Estimator):
    """Shared fit scaffold: the subclasses differ only in label
    preparation and the loss builder.

    ``fit`` also accepts an iterable of batch Tables or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache` — the
    out-of-core path (:func:`~flinkml_tpu_torch.models._adam.
    run_streamed_adam`): the stream is cached once, then each epoch
    replays the cache chunk by chunk, running Adam steps within the
    resident chunk with the optimizer state carried across chunks.
    ``checkpoint_manager`` + ``checkpoint_interval`` snapshot the full
    Adam state every N epochs; ``resume=True`` (durable DataCache input
    required) continues exactly.
    """

    _MODEL_CLS = None
    _LOSS_BUILDER = None

    def _prepare_labels(self, y: np.ndarray, layers) -> np.ndarray:
        raise NotImplementedError

    def _check_layers(self):
        layers = self.get(self.LAYERS)
        if layers is None or len(layers) < 2:
            raise ValueError("layers must list at least [inputDim, outputDim]")
        return layers

    def _make_model(self, flat):
        model = self._MODEL_CLS()
        model.copy_params_from(self)
        model._weights = [t.detach().cpu().numpy().astype(np.float64)
                          for t in flat]
        return model

    def fit(self, *inputs):
        from flinkml_tpu_torch.parallel.mesh import pad_to_multiple

        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
        self._reject_in_ram_checkpointing()
        layers = self._check_layers()
        x, y, w = labeled_data(
            table, self.get(self.FEATURES_COL), self.get(self.LABEL_COL)
        )
        if x.shape[1] != layers[0]:
            raise ValueError(
                f"layers[0]={layers[0]} != feature dim {x.shape[1]}"
            )
        y_dev = self._prepare_labels(y, layers)
        mesh, device = _mesh_and_device(self.mesh)
        p = mesh.axis_size()
        x_pad, n_valid = pad_to_multiple(x.astype(np.float32), p)
        y_pad, _ = pad_to_multiple(y_dev, p)
        w_pad = np.zeros(x_pad.shape[0], np.float32)
        w_pad[:n_valid] = w[:n_valid].astype(np.float32)
        local_bs = max(1, self.get(self.GLOBAL_BATCH_SIZE) // p)
        trainer = make_adam_trainer(
            mesh, local_bs, type(self)._LOSS_BUILDER, 2 * (len(layers) - 1))
        key = threefry.PRNGKey(self.get_seed(), device)
        flat0 = flat_params(_init_params(list(layers), key))
        flat, _steps, _loss = trainer(
            mesh.shard_batch(x_pad), mesh.shard_batch(y_pad),
            mesh.shard_batch(w_pad), flat0, self.get(self.LEARNING_RATE),
            self.get(self.MAX_ITER), self.get(self.TOL),
            threefry.fold_in(key, 123),
        )
        return self._make_model(flat)

    def _fit_stream(self, source):
        """Out-of-core Adam through the shared runner: the optimizer state
        rides across the replayed chunks as one continuous run,
        snapshotted at epoch boundaries."""
        from flinkml_tpu_torch.models._adam import run_streamed_adam

        layers = self._check_layers()
        features_col = self.get(self.FEATURES_COL)
        label_col = self.get(self.LABEL_COL)
        mesh, device = _mesh_and_device(self.mesh)

        def ingest(t):
            x, y, w = labeled_data(t, features_col, label_col)
            if x.shape[1] != layers[0]:
                raise ValueError(
                    f"layers[0]={layers[0]} != feature dim {x.shape[1]}"
                )
            return {
                "x": x.astype(np.float32),
                "y": self._prepare_labels(y, layers),
                "w": w.astype(np.float32),
            }

        def params0_fn(d):
            if d != layers[0]:
                raise ValueError(f"layers[0]={layers[0]} != feature dim {d}")
            return flat_params(_init_params(
                list(layers), threefry.PRNGKey(self.get_seed(), device)))

        flat = run_streamed_adam(
            source,
            what="MLP streamed fit",
            mesh=mesh,
            cache_dir=self.cache_dir,
            cache_memory_budget_bytes=self.cache_memory_budget_bytes,
            ingest=ingest,
            place_y=lambda y: self._prepare_labels(y, layers),
            loss_builder=type(self)._LOSS_BUILDER,
            n_params=2 * (len(layers) - 1),
            params0_fn=params0_fn,
            lr=self.get(self.LEARNING_RATE),
            global_bs=self.get(self.GLOBAL_BATCH_SIZE),
            max_iter=self.get(self.MAX_ITER),
            tol=self.get(self.TOL),
            seed=self.get_seed(),
            **self._checkpoint_kwargs(),
        )
        return self._make_model(flat)


class MLPClassifier(_MLPClassifierParams, _MLPBase):
    def _prepare_labels(self, y: np.ndarray, layers) -> np.ndarray:
        n_classes = layers[-1]
        yi = y.astype(np.int64)
        if not np.all(y == yi) or yi.min() < 0 or yi.max() >= n_classes:
            raise ValueError(
                f"labels must be class ids in [0, {n_classes}), got "
                f"[{y.min()}, {y.max()}]"
            )
        return yi.astype(np.int32)


class _MLPModelBase(_MLPParams, Model):
    """Weight storage, forward pass, and persistence shared by the
    sibling classifier/regressor models."""

    def __init__(self):
        super().__init__()
        self._weights: Optional[List[np.ndarray]] = None

    def set_model_data(self, *inputs: Table) -> "_MLPModelBase":
        (table,) = inputs
        n = int(np.asarray(table.column("numArrays"))[0])
        self._weights = [
            np.asarray(table.column(f"arr{i}"), np.float64)[0]
            for i in range(n)
        ]
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        cols = {"numArrays": np.asarray([len(self._weights)])}
        for i, a in enumerate(self._weights):
            cols[f"arr{i}"] = a[None, ...]
        return [Table(cols)]

    def _require(self) -> None:
        if self._weights is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def _logits(self, table: Table) -> np.ndarray:
        x = features_matrix(table, self.get(self.FEATURES_COL))
        n_layers = len(self._weights) // 2
        h = x
        for i in range(n_layers - 1):
            h = np.tanh(h @ self._weights[2 * i] + self._weights[2 * i + 1])
        return h @ self._weights[-2] + self._weights[-1]

    def _arrays(self):
        self._require()
        return {f"arr{i}": a for i, a in enumerate(self._weights)}

    def _set_arrays(self, arrays) -> None:
        n = sum(1 for k in arrays if k.startswith("arr"))
        self._weights = [np.asarray(arrays[f"arr{i}"], np.float64)
                         for i in range(n)]

    def save(self, path: str) -> None:
        self._save_with_arrays(path, self._arrays(),
                               extra={"numArrays": len(self._weights)})


class MLPClassifierModel(_MLPClassifierParams, _MLPModelBase):
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        logits = self._logits(table)
        shifted = logits - logits.max(axis=1, keepdims=True)
        probs = np.exp(shifted)
        probs /= probs.sum(axis=1, keepdims=True)
        out = table.with_column(
            self.get(self.PREDICTION_COL),
            np.argmax(logits, axis=1).astype(np.float64),
        )
        out = out.with_column(self.get(self.RAW_PREDICTION_COL), probs)
        return (out,)


class MLPRegressor(_MLPBase):
    """Multilayer perceptron regressor: ``layers = [d_in, h..., 1]``,
    tanh hidden activations, linear output, squared loss — the same Adam
    trainer as the classifier."""

    def _prepare_labels(self, y: np.ndarray, layers) -> np.ndarray:
        if layers[-1] != 1:
            raise ValueError(
                "layers must be [inputDim, hidden..., 1] for regression"
            )
        return y.astype(np.float32)


class MLPRegressorModel(_MLPModelBase):
    """Sibling of the classifier model (not a subclass of it): the
    transform emits the linear output directly."""

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        pred = self._logits(table)[:, 0]
        return (
            table.with_column(self.get(self.PREDICTION_COL), pred),
        )


MLPClassifier._MODEL_CLS = MLPClassifierModel
MLPClassifier._LOSS_BUILDER = staticmethod(_mlp_loss_builder)
MLPRegressor._MODEL_CLS = MLPRegressorModel
MLPRegressor._LOSS_BUILDER = staticmethod(_mlp_squared_loss_builder)
