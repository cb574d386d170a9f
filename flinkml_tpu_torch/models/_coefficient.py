"""Shared scaffold for models whose data is a single coefficient vector."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np

from flinkml_tpu_torch.table import Table


class CoefficientModelMixin:
    """set/get model data, the ``_arrays`` persistence layout, and the
    fitted-check for coefficient models (LogisticRegression now; LinearSVC,
    LinearRegression and online LR in later slices)."""

    _coefficient: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table):
        (table,) = inputs
        self._set_arrays({"coefficient": np.asarray(table.column("coefficient"))})
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"coefficient": self._coefficient[None, ...]})]

    @property
    def coefficient(self) -> np.ndarray:
        self._require_model()
        return self._coefficient

    def _require_model(self) -> None:
        if self._coefficient is None:
            raise ValueError("Model data is not set; call set_model_data or fit first")

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require_model()
        return {"coefficient": self._coefficient}

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        c = np.asarray(arrays["coefficient"], dtype=np.float64)
        self._coefficient = c[0] if c.ndim == 2 and c.shape[0] == 1 else c
