"""Column-extraction helpers shared by algorithms.

The port's counterpart of ``flinkml_tpu.models._data``: tables are already
columnar, so "extraction" is densifying a features column to ``[n, d]``
(on the host, or as a tensor on the compute device) and picking the sparse
path when every row is a ``SparseVector``.
"""

from __future__ import annotations

import numpy as np
import torch

from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.linalg import SparseVector, stack_vectors
from flinkml_tpu_torch.table import Table


def features_matrix(
    table: Table, features_col: str, dtype=np.float64
) -> np.ndarray:
    """Densify a features column to a host float ``[n, d]`` array.

    Accepts 2-D numeric columns (native layout) or object columns of
    ``Vector`` / array-likes. ``dtype=None`` preserves a floating input
    dtype and promotes non-float inputs to float64.
    """
    col = table.column(features_col)
    if col.dtype == object:
        return stack_vectors(col)
    if dtype is None:
        dtype = col.dtype if col.dtype.kind == "f" else np.float64
    if col.ndim == 1:
        return col.astype(dtype).reshape(-1, 1)
    return np.ascontiguousarray(col, dtype=dtype)


def features_tensor(table: Table, features_col: str) -> torch.Tensor:
    """The features column as a float ``[n, d]`` tensor on the compute
    device: a floating dtype is kept, anything else becomes float64. A
    device-resident column is used in place; a host column uploads once
    (cached on the table); an object column of vectors is densified on
    the host first."""
    device = default_device()
    if (not table.is_device_resident(features_col)
            and table.column(features_col).dtype == object):
        x = torch.from_numpy(stack_vectors(table.column(features_col))).to(device)
    else:
        x = table.device_column(features_col, device)
    if not x.dtype.is_floating_point:
        x = x.to(torch.float64)
    if x.dim() == 1:
        x = x.reshape(-1, 1)
    return x


def sparse_features(table: Table, features_col: str):
    """The features column if EVERY row is a SparseVector, else None —
    the dispatch every linear model uses to pick the O(nnz) sparse path
    over densification."""
    if table.is_device_resident(features_col):
        return None
    col = table.column(features_col)
    if (
        col.dtype == object
        and col.size
        and isinstance(col[0], SparseVector)
        and all(isinstance(v, SparseVector) for v in col)
    ):
        return col
    return None
