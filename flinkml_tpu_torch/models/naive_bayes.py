"""NaiveBayes — multinomial NB over categorical (indexed) features.

The port's counterpart of ``flinkml_tpu.models.naive_bayes`` (parity with
``NaiveBayes.java:55-348`` and ``NaiveBayesModel.java``):

  - **Fit.** The vocabularies are built on the host (the distinct labels;
    each feature's distinct values over every label), as in the JAX
    package. Each (label, feature, category) occurrence is one flat
    segment id, and the counts are ONE ``keyed_aggregate``: the
    ``segment_sum`` kernel over this rank's ids with float64 values of 1,
    then one ``all_reduce`` on a mesh. Integer counts are exact, so the
    order of the kernel's atomic adds does not matter: the counts, and
    the smoothed ``theta``/``pi`` computed from them on the host, equal
    the JAX package's bit for bit.
  - **Smoothing** (``GenerateModelFunction``, ``NaiveBayes.java:278-347``):
    ``theta[l][j][c] = log(count + smoothing) - log(docCount_l +
    smoothing * numCategories_j)``; ``pi[l] = log(docCount_l * F +
    smoothing) - log(totalDocs * F + L * smoothing)``.
  - **Transform** (``NaiveBayesModel.java:174-183``): each value's
    category id by a binary search in its feature's vocabulary, the
    gather of ``theta`` and the argmax over ``pi[l] + Σ_j theta[l][j][x_j]``
    on the compute device (the per-feature terms added in feature order);
    a value never seen in training raises.
  - Model data, ``save`` and ``load`` use the JAX package's formats.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasSmoothing,
)
from flinkml_tpu_torch.models._data import features_matrix, labeled_data
from flinkml_tpu_torch.parallel.mesh import (
    DeviceMesh,
    check_mesh,
    pad_to_multiple,
)
from flinkml_tpu_torch.table import Table


class _NaiveBayesParams(HasFeaturesCol, HasLabelCol, HasPredictionCol,
                        HasSmoothing):
    pass


def count_triples(mesh: DeviceMesh, flat: np.ndarray,
                  num_segments: int) -> np.ndarray:
    """Occurrences of each flat segment id, summed over the mesh's ranks:
    ``keyed_aggregate`` of float64 ones by ``flat``. Every rank passes the
    same global ids, padded to the data axis with zero-valued cells, and
    keeps its block; its ones are made on the device."""
    from flinkml_tpu_torch.parallel.collectives import keyed_aggregate

    flat_pad, n_valid = pad_to_multiple(flat.astype(np.int32), mesh.axis_size())
    keys = mesh.shard_batch(flat_pad)
    m = keys.shape[0]
    start = m * (mesh.axis_index() if mesh.mesh is not None else 0)
    ones = torch.ones(m, dtype=torch.float64, device=keys.device)
    if start + m > n_valid:
        ones[max(n_valid - start, 0):] = 0.0
    return keyed_aggregate(mesh, ones, keys, num_segments).cpu().numpy()


class NaiveBayes(_NaiveBayesParams, Estimator):
    """Fits a :class:`NaiveBayesModel`; ``mesh`` (a
    :class:`~flinkml_tpu_torch.parallel.DeviceMesh`) splits the counted
    cells over its ranks."""

    def __init__(self, mesh: Optional[DeviceMesh] = None):
        check_mesh(mesh)
        super().__init__()
        self.mesh = mesh

    def fit(self, *inputs: Table) -> "NaiveBayesModel":
        (table,) = inputs
        x, y, _ = labeled_data(
            table,
            self.get(_NaiveBayesParams.FEATURES_COL),
            self.get(_NaiveBayesParams.LABEL_COL),
        )
        if not np.all(y == np.round(y)):
            raise ValueError("Label value should be indexed number.")
        smoothing = self.get(_NaiveBayesParams.SMOOTHING)
        n, num_features = x.shape

        labels, label_idx = np.unique(y, return_inverse=True)
        num_labels = len(labels)
        cat_values: List[np.ndarray] = []
        cat_idx = np.empty_like(x, dtype=np.int64)
        for j in range(num_features):
            vals, idx = np.unique(x[:, j], return_inverse=True)
            cat_values.append(vals)
            cat_idx[:, j] = idx
        max_cats = max(len(v) for v in cat_values)

        num_segments = num_labels * num_features * max_cats
        flat = (
            label_idx[:, None] * (num_features * max_cats)
            + np.arange(num_features)[None, :] * max_cats
            + cat_idx
        ).reshape(-1)
        counts = count_triples(self.mesh or DeviceMesh(), flat,
                               num_segments).reshape(
            num_labels, num_features, max_cats)

        doc_count = np.bincount(label_idx, minlength=num_labels).astype(
            np.float64)
        num_cats = np.array([len(v) for v in cat_values], dtype=np.float64)

        theta_log = np.log(doc_count[:, None] + smoothing * num_cats[None, :])
        theta = np.log(counts + smoothing) - theta_log[:, :, None]
        # Categories past a feature's vocabulary are padding.
        for j in range(num_features):
            theta[:, j, len(cat_values[j]):] = -np.inf

        total = doc_count.sum() * num_features
        pi = np.log(doc_count * num_features + smoothing) - np.log(
            total + num_labels * smoothing
        )

        model = NaiveBayesModel()
        model.copy_params_from(self)
        model._set_fitted(theta, pi, labels, cat_values)
        return model


class NaiveBayesModel(_NaiveBayesParams, Model):
    def __init__(self):
        super().__init__()
        self._theta: Optional[np.ndarray] = None  # [L, F, C] log-likelihood
        self._pi: Optional[np.ndarray] = None  # [L] log prior
        self._labels: Optional[np.ndarray] = None  # [L] label values
        self._cat_values: Optional[List[np.ndarray]] = None  # per-feature vocab

    def _set_fitted(self, theta, pi, labels, cat_values) -> "NaiveBayesModel":
        self._theta, self._pi, self._labels = theta, pi, labels
        self._cat_values = list(cat_values)
        return self

    # -- model data --------------------------------------------------------
    def set_model_data(self, *inputs: Table) -> "NaiveBayesModel":
        (table,) = inputs
        theta = np.asarray(table.column("theta"), dtype=np.float64)[0]
        pi = np.asarray(table.column("piArray"), dtype=np.float64)[0]
        labels = np.asarray(table.column("labels"), dtype=np.float64)[0]
        cats = table.column("categoryValues")[0]
        self._set_fitted(theta, pi, labels, [np.asarray(c) for c in cats])
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        cats = np.empty(1, dtype=object)
        cats[0] = [np.asarray(c) for c in self._cat_values]
        return [
            Table(
                {
                    "theta": self._theta[None],
                    "piArray": self._pi[None],
                    "labels": self._labels[None],
                    "categoryValues": cats,
                }
            )
        ]

    def _require_model(self) -> None:
        if self._theta is None:
            raise ValueError(
                "Model data is not set; call set_model_data or fit first")

    # -- inference ---------------------------------------------------------
    def category_ids(self, x: torch.Tensor) -> torch.Tensor:
        """``[n, F]`` category ids of the values in ``x`` (on its device),
        by a binary search in each feature's vocabulary; a value never
        seen in training raises ``ValueError``."""
        n, num_features = x.shape
        idx = torch.empty((n, num_features), dtype=torch.int64,
                          device=x.device)
        for j in range(num_features):
            vocab = torch.from_numpy(np.ascontiguousarray(
                self._cat_values[j], dtype=np.float64)).to(x.device)
            col = x[:, j].contiguous()
            pos = torch.clamp(torch.searchsorted(vocab, col), 0,
                              vocab.numel() - 1)
            bad = vocab[pos] != col
            if bool(bad.any()):
                seen = col[bad].cpu().numpy()
                raise ValueError(
                    f"feature {j} contains values never seen in training: "
                    f"{np.unique(seen)[:5]}"
                )
            idx[:, j] = pos
        return idx

    def scores(self, idx: torch.Tensor) -> torch.Tensor:
        """``[n, L]`` log posteriors ``pi[l] + Σ_j theta[l, j, idx[:, j]]``
        on ``idx``'s device, the feature terms added in feature order."""
        device = idx.device
        theta = torch.from_numpy(self._theta).to(device)  # [L, F, C]
        total = None
        for j in range(idx.shape[1]):
            term = theta[:, j, :].T[idx[:, j]]  # [n, L]
            total = term if total is None else total + term
        return torch.from_numpy(self._pi).to(device)[None, :] + total

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        from flinkml_tpu_torch.device import default_device

        (table,) = inputs
        self._require_model()
        x = features_matrix(table, self.get(_NaiveBayesParams.FEATURES_COL))
        n, num_features = x.shape
        if num_features != self._theta.shape[1]:
            raise ValueError(
                f"input has {num_features} features, model was fit on "
                f"{self._theta.shape[1]}"
            )
        xt = torch.from_numpy(x).to(default_device())
        pred_idx = torch.argmax(self.scores(self.category_ids(xt)), dim=1)
        pred = self._labels[pred_idx.cpu().numpy()]
        return (table.with_column(self.get(_NaiveBayesParams.PREDICTION_COL),
                                  pred),)

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        self._require_model()
        arrays = {
            "theta": self._theta,
            "piArray": self._pi,
            "labels": self._labels,
        }
        for j, v in enumerate(self._cat_values):
            arrays[f"catValues_{j}"] = v
        self._save_with_arrays(
            path, arrays, extra={"numFeatures": int(self._theta.shape[1])}
        )

    @classmethod
    def load(cls, path: str) -> "NaiveBayesModel":
        model, arrays, meta = cls._load_with_arrays(path)
        cats = [arrays[f"catValues_{j}"]
                for j in range(int(meta["numFeatures"]))]
        model._set_fitted(arrays["theta"], arrays["piArray"],
                          arrays["labels"], cats)
        return model
