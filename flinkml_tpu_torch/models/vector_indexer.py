"""VectorIndexer — detect categorical features in a vector column and
index them (the upstream operator).

``fit`` decides per feature: ≤ ``maxCategories`` distinct values →
categorical, its sorted distinct values map to indices ``0..k-1``;
otherwise the feature is continuous and passes through unchanged.
``handleInvalid`` governs unseen categorical values at transform time:
``error`` raises, ``skip`` drops the row, ``keep`` maps to the extra
index ``k``.

The port's counterpart of ``flinkml_tpu.models.vector_indexer``, the same host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasHandleInvalid,
    HasInputCol,
    HasOutputCol,
)
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.params import IntParam, ParamValidators
from flinkml_tpu_torch.table import Table


class _VectorIndexerParams(HasInputCol, HasOutputCol, HasHandleInvalid):
    MAX_CATEGORIES = IntParam(
        "maxCategories",
        "Features with at most this many distinct values are categorical.",
        20, ParamValidators.gt(1),
    )


class VectorIndexer(_VectorIndexerParams, Estimator):
    def fit(self, *inputs: Table) -> "VectorIndexerModel":
        (table,) = inputs
        x = features_matrix(table, self.get(self.INPUT_COL))
        max_cat = self.get(self.MAX_CATEGORIES)
        category_maps: Dict[int, np.ndarray] = {}
        for j in range(x.shape[1]):
            col = x[:, j]
            # NaN can never be matched by the equality lookup, so it must
            # not enter a category map — NaN rows are handled by
            # handleInvalid at transform time (same stance as
            # StringIndexer).
            uniq = np.unique(col[~np.isnan(col)])
            if 0 < len(uniq) <= max_cat:
                category_maps[j] = uniq
        model = VectorIndexerModel()
        model.copy_params_from(self)
        model._set_maps(x.shape[1], category_maps)
        return model


class VectorIndexerModel(_VectorIndexerParams, Model):
    def __init__(self):
        super().__init__()
        self._num_features: Optional[int] = None
        self._category_maps: Dict[int, np.ndarray] = {}

    def _set_maps(self, num_features: int,
                  category_maps: Dict[int, np.ndarray]) -> None:
        self._num_features = int(num_features)
        self._category_maps = {
            int(j): np.asarray(v, np.float64) for j, v in category_maps.items()
        }

    @property
    def category_maps(self) -> Dict[int, np.ndarray]:
        self._require()
        return self._category_maps

    def set_model_data(self, *inputs: Table) -> "VectorIndexerModel":
        (table,) = inputs
        num_features = int(np.asarray(table.column("numFeatures"))[0])
        idx = np.asarray(table.column("featureIndex"))
        values = table.column("categories")
        self._set_maps(
            num_features,
            {int(j): values[i] for i, j in enumerate(idx) if j >= 0},
        )  # featureIndex -1 is the no-categorical-features sentinel row
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        keys = sorted(self._category_maps)
        cats = np.empty(max(len(keys), 1), dtype=object)
        if keys:
            for i, j in enumerate(keys):
                cats[i] = self._category_maps[j]
            return [Table({
                "numFeatures": np.full(len(keys), self._num_features),
                "featureIndex": np.asarray(keys),
                "categories": cats,
            })]
        cats[0] = np.zeros(0)
        return [Table({
            "numFeatures": np.asarray([self._num_features]),
            "featureIndex": np.asarray([-1]),
            "categories": cats,
        })]

    def _require(self) -> None:
        if self._num_features is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        x = features_matrix(table, self.get(self.INPUT_COL))
        if x.shape[1] != self._num_features:
            raise ValueError(
                f"model was fit on {self._num_features} features, "
                f"got {x.shape[1]}"
            )
        handle = self.get(self.HANDLE_INVALID)
        out = x.copy()
        keep_mask = np.ones(x.shape[0], dtype=bool)
        for j, cats in self._category_maps.items():
            pos = np.searchsorted(cats, x[:, j])
            pos_c = np.minimum(pos, len(cats) - 1)
            found = cats[pos_c] == x[:, j]
            if handle == HasHandleInvalid.ERROR_INVALID:
                if not found.all():
                    raise ValueError(
                        f"Feature {j} has values not seen during fitting: "
                        f"{x[~found, j][:5]}"
                    )
            elif handle == HasHandleInvalid.SKIP_INVALID:
                keep_mask &= found
            else:
                pos_c = np.where(found, pos_c, len(cats))
            out[:, j] = pos_c
        result = table.with_column(self.get(self.OUTPUT_COL), out)
        if not keep_mask.all():
            result = result.take(np.nonzero(keep_mask)[0])
        return (result,)

    def save(self, path: str) -> None:
        self._require()
        arrays = {
            f"cats_{j}": v for j, v in self._category_maps.items()
        }
        arrays["featureIndex"] = np.asarray(sorted(self._category_maps))
        self._save_with_arrays(
            path, arrays, extra={"numFeatures": self._num_features}
        )

    @classmethod
    def load(cls, path: str) -> "VectorIndexerModel":
        model, arrays, meta = cls._load_with_arrays(path)
        model._set_arrays({**arrays, "numFeatures": meta["numFeatures"]})
        return model

    def _set_arrays(self, arrays) -> None:
        """The saved arrays, with the metadata's ``numFeatures`` among
        them."""
        self._set_maps(
            int(np.asarray(arrays["numFeatures"]).reshape(-1)[0]),
            {int(j): np.asarray(arrays[f"cats_{int(j)}"])
             for j in np.asarray(arrays["featureIndex"]).reshape(-1)},
        )
