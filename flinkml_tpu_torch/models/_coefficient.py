"""Shared scaffold for models whose data is a single coefficient vector."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from flinkml_tpu_torch.table import Table


def linear_margins(table: Table, features_col: str,
                   coefficient: np.ndarray, mesh=None) -> np.ndarray:
    """``x · coef`` per row on the host: SparseVector rows through
    :func:`flinkml_tpu_torch.ops.sparse.sparse_margins` (the ``spmv``
    kernel, float32, returned as float64), dense rows by one product on
    the compute device in the column's floating dtype (float64 for
    anything else). With a ``mesh`` of several ranks the dense rows are
    scored sharded (:func:`~flinkml_tpu_torch.models._data.sharded_rows`:
    each rank its block, the blocks gathered)."""
    from flinkml_tpu_torch.models._data import (
        features_matrix,
        features_tensor,
        sharded_rows,
        sparse_features,
    )

    sparse_col = sparse_features(table, features_col)
    if sparse_col is not None:
        from flinkml_tpu_torch.ops.sparse import sparse_margins

        return sparse_margins(sparse_col, coefficient).astype(np.float64)

    def margins(x):
        coef = torch.as_tensor(coefficient).to(device=x.device, dtype=x.dtype)
        return torch.matmul(x, coef)

    if mesh is not None and mesh.num_devices > 1:
        return sharded_rows(mesh, features_matrix(table, features_col,
                                                  dtype=None), margins)
    return margins(features_tensor(table, features_col)).cpu().numpy()


class CoefficientModelMixin:
    """set/get model data, the ``_arrays`` persistence layout, and the
    fitted-check for coefficient models (LogisticRegression, LinearSVC,
    LinearRegression); ``mesh`` is the sharded transform's (None: one
    device)."""

    _coefficient: Optional[np.ndarray] = None
    mesh = None

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
