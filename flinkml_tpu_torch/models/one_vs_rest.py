"""OneVsRest — multiclass meta-classifier over any binary Estimator
(the Spark/Flink family member).

One binary model per class (label = 1 for the class, 0 for the rest);
prediction takes the argmax of the per-class positive scores (the
``rawPrediction`` probability column when the inner model emits one,
else the 0/1 prediction). The inner estimator is refit per class
sequentially — each fit runs on the compute device (the inner LR's
fit and ``fused_chain`` transform), the same stance as the tuning loops.
The port's counterpart of ``flinkml_tpu.models.one_vs_rest``; a saved
model keeps one subdirectory per class, and loads across packages.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasRawPredictionCol,
)
from flinkml_tpu_torch.io import read_write
from flinkml_tpu_torch.table import Table


class _OneVsRestParams(
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasRawPredictionCol
):
    pass


class OneVsRest(_OneVsRestParams, Estimator):
    def __init__(self, classifier: Optional[Estimator] = None):
        super().__init__()
        self.classifier = classifier

    def fit(self, *inputs: Table) -> "OneVsRestModel":
        (table,) = inputs
        if self.classifier is None:
            raise ValueError("OneVsRest requires a binary classifier")
        label_col = self.get(self.LABEL_COL)
        y = np.asarray(table.column(label_col), np.float64).reshape(-1)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(f"need >= 2 classes, got {classes}")
        if not np.all(classes == np.round(classes)):
            raise ValueError(f"labels must be integral class ids, got {classes}")
        # The binary 0/1 view must land in the column the INNER
        # estimator reads (it may differ from OneVsRest's labelCol —
        # writing only our own column would silently train every
        # per-class model on the raw multiclass ids).
        inner_label_param = self.classifier.get_param("labelCol")
        inner_label_col = (
            self.classifier.get(inner_label_param)
            if inner_label_param is not None else label_col
        )
        models = []
        for c in classes:
            binary = table.with_column(
                inner_label_col, (y == c).astype(np.float64)
            )
            if inner_label_col != label_col:
                binary = binary.with_column(
                    label_col, (y == c).astype(np.float64)
                )
            models.append(self.classifier.fit(binary))
        out = OneVsRestModel()
        out.copy_params_from(self)
        out._set(classes, models)
        return out


class OneVsRestModel(_OneVsRestParams, Model):
    def __init__(self):
        super().__init__()
        self._classes: Optional[np.ndarray] = None
        self._models: Optional[List[Model]] = None

    def _set(self, classes: np.ndarray, models: List[Model]) -> None:
        self._classes = np.asarray(classes, np.float64)
        self._models = list(models)

    @property
    def classes(self) -> np.ndarray:
        self._require()
        return self._classes

    @property
    def models(self) -> List[Model]:
        self._require()
        return self._models

    def _require(self) -> None:
        if self._models is None:
            raise ValueError("Model data is not set; fit first or load")

    @staticmethod
    def _inner_col(model: Model, param_name: str, fallback: str) -> str:
        """The column the INNER model writes (its own configured param,
        not OneVsRest's — mirroring fit's labelCol resolution)."""
        p = model.get_param(param_name)
        return model.get(p) if p is not None else fallback

    def _class_score(self, model: Model, table: Table) -> np.ndarray:
        (scored,) = model.transform(table)
        raw_col = self._inner_col(
            model, "rawPredictionCol", self.get(self.RAW_PREDICTION_COL)
        )
        if raw_col in scored.column_names:
            raw = np.asarray(scored.column(raw_col), np.float64)
            if raw.ndim == 2 and raw.shape[1] == 2:
                return raw[:, 1]           # probability pair: P(class)
            if raw.ndim == 1:
                return raw                 # margin (LinearSVC's layout)
        pred_col = self._inner_col(
            model, "predictionCol", self.get(self.PREDICTION_COL)
        )
        return np.asarray(scored.column(pred_col), np.float64)

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        scores = np.stack(
            [self._class_score(m, table) for m in self._models], axis=1
        )
        pred = self._classes[np.argmax(scores, axis=1)]
        out = table.with_column(self.get(self.PREDICTION_COL), pred)
        out = out.with_column(self.get(self.RAW_PREDICTION_COL), scores)
        return (out,)

    # -- persistence: one subdirectory per class model ----------------------
    def save(self, path: str) -> None:
        self._require()
        read_write.save_metadata(self, path, extra={
            "classes": [float(c) for c in self._classes],
        })
        for i, m in enumerate(self._models):
            m.save(read_write.stage_path(path, i))

    @classmethod
    def load(cls, path: str) -> "OneVsRestModel":
        meta = read_write.load_metadata(path, expected_class=cls)
        model = cls()
        model.load_param_map_json(meta["paramMap"])
        classes = np.asarray(meta["classes"], np.float64)
        models = [
            read_write.load_stage(read_write.stage_path(path, i))
            for i in range(len(classes))
        ]
        model._set(classes, models)
        return model
