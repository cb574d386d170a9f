"""Knn — brute-force k-nearest-neighbors classifier.

The port's counterpart of ``flinkml_tpu.models.knn`` (reference:
``Knn.java:52-140``, ``KnnModel.java:51-197``):

- ``fit`` keeps the train set as the model: the ``[n, d]`` features and
  the labels (float64 on the host, as the JAX package saves them).
- ``transform`` runs the queries in blocks of :attr:`KnnModel.CHUNK` rows,
  so the ``[chunk, n_train]`` distance block stays bounded: one
  ``torch.matmul`` per block through the ‖x‖²-2x·y+‖y‖² expansion
  (:func:`flinkml_tpu_torch.ops.blas.squared_distances`), then
  ``top_k(-d2, k)`` — the CUDA ``topk`` kernel on the card, one launch
  per block — and a one-hot vote, ties toward the smaller class id.
  Distance ties go to the lower train index, as in ``jax.lax.top_k``.

Dtype rule: the vote computes in the query column's floating dtype (a
non-float column promotes to float64); the train set is cast to it. The
JAX package computes in the dtype its global x64 flag gives.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasK,
    HasLabelCol,
    HasPredictionCol,
)
from flinkml_tpu_torch.kernels.topk import top_k
from flinkml_tpu_torch.models._data import features_tensor, labeled_data
from flinkml_tpu_torch.ops import blas
from flinkml_tpu_torch.table import Table


class _KnnParams(HasFeaturesCol, HasLabelCol, HasPredictionCol, HasK):
    pass


class Knn(_KnnParams, Estimator):
    def fit(self, *inputs: Table) -> "KnnModel":
        (table,) = inputs
        x, y, _ = labeled_data(
            table,
            self.get(_KnnParams.FEATURES_COL),
            self.get(_KnnParams.LABEL_COL),
        )
        model = KnnModel()
        model.copy_params_from(self)
        model.set_model_data(Table({"features": x, "labels": y}))
        return model


class KnnModel(_KnnParams, Model):
    CHUNK = 4096  # query rows per distance-matrix block

    def __init__(self):
        super().__init__()
        self._features: Optional[np.ndarray] = None
        self._labels: Optional[np.ndarray] = None
        # (device, dtype) -> train features on that device.
        self._train: Dict[Tuple[torch.device, torch.dtype], torch.Tensor] = {}

    def set_model_data(self, *inputs: Table) -> "KnnModel":
        (table,) = inputs
        self._set_arrays({"features": table.column("features"),
                          "labels": table.column("labels")})
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"features": self._features, "labels": self._labels})]

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require_model()
        return {"features": self._features, "labels": self._labels}

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        self._features = np.asarray(arrays["features"], dtype=np.float64)
        self._labels = np.asarray(arrays["labels"], dtype=np.float64)
        self._train = {}

    def _require_model(self) -> None:
        if self._features is None:
            raise ValueError("Model data is not set; call set_model_data or fit first")

    def _train_on(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """The train features on ``device`` in ``dtype`` (uploaded once)."""
        key = (device, dtype)
        if key not in self._train:
            self._train[key] = torch.from_numpy(self._features).to(
                device=device, dtype=dtype)
        return self._train[key]

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        k = self.get(_KnnParams.K)
        n_train = self._features.shape[0]
        if n_train == 0:
            raise ValueError("Knn model has no training points")
        # Reference parity: KnnModel's top-k priority queue simply holds
        # all n points when k > n — vote among everything, don't raise.
        k = min(k, n_train)
        x = features_tensor(table, self.get(_KnnParams.FEATURES_COL))

        # Map labels to dense class ids for the one-hot vote.
        classes, label_ids = np.unique(self._labels, return_inverse=True)
        xt = self._train_on(x.device, x.dtype)
        ids = torch.from_numpy(label_ids.astype(np.int64)).to(x.device)
        preds = [
            _knn_vote(x[start:start + self.CHUNK], xt, ids, k, len(classes))
            for start in range(0, x.shape[0], self.CHUNK)
        ]
        pred_ids = (torch.cat(preds).cpu().numpy() if preds
                    else np.zeros(0, dtype=np.int64))
        pred = classes[pred_ids]
        return (table.with_column(self.get(_KnnParams.PREDICTION_COL), pred),)


def _knn_vote(queries: torch.Tensor, train_x: torch.Tensor,
              train_label_ids: torch.Tensor, k: int,
              num_classes: int) -> torch.Tensor:
    """Top-k nearest by squared distance, then majority vote.

    Ties break toward the smaller class id (``argmax`` takes the first
    maximum), distance ties toward the lower train index (``top_k``)."""
    d2 = blas.squared_distances(queries, train_x)
    _, idx = top_k(d2.neg_(), k)
    votes = train_label_ids[idx.long()]  # [nq, k]
    counts = torch.sum(F.one_hot(votes, num_classes), dim=1)
    return torch.argmax(counts, dim=-1)
