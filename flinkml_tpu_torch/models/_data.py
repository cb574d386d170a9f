"""Column-extraction helpers shared by algorithms.

The port's counterpart of ``flinkml_tpu.models._data``: tables are already
columnar, so "extraction" is densifying a features column to ``[n, d]``
(on the host, or as a tensor on the compute device), reading label and
weight columns, and picking the sparse path when every row is a
``SparseVector``.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def labeled_data(
    table: Table,
    features_col: str,
    label_col: str,
    weight_col: Optional[str] = None,
    dtype=np.float64,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract (X [n,d], y [n], w [n]); weight defaults to 1.0 per row.

    ``dtype`` is the features' as in :func:`features_matrix` (``None``
    keeps a floating column's dtype); labels and weights are float64.
    """
    x = features_matrix(table, features_col, dtype=dtype)
    y = np.asarray(table.column(label_col), dtype=np.float64).reshape(-1)
    if y.shape[0] != x.shape[0]:
        raise ValueError(
            f"label column {label_col!r} has {y.shape[0]} rows, features have {x.shape[0]}"
        )
    if weight_col is not None:
        w = np.asarray(table.column(weight_col), dtype=np.float64).reshape(-1)
    else:
        w = np.ones(x.shape[0], dtype=np.float64)
    return x, y, w


_HASH_MIX = np.uint64(0x9E3779B97F4A7C15)  # golden-ratio multiplicative mix


def hashed_feature_matrix(
    sparse_col: np.ndarray, num_buckets: int, dtype=np.float32
) -> np.ndarray:
    """Hash-bundle a SparseVector column into a dense ``[n, num_buckets]``
    host matrix: bucket ``mix(col_id) % num_buckets`` accumulates the sum
    of that row's values whose column hashes there (the JAX package's
    bundling, bit for bit: the tree models' route for high-cardinality
    sparse inputs, so histograms stay ``n x num_buckets`` whatever the
    sparse dimensionality)."""
    from flinkml_tpu_torch.ops.sparse import csr_from_sparse_vectors

    indptr, indices, values, _dim = csr_from_sparse_vectors(
        sparse_col, dtype=dtype
    )
    n = indptr.size - 1
    mixed = indices.astype(np.uint64) * _HASH_MIX
    buckets = ((mixed >> np.uint64(32)) % np.uint64(num_buckets)).astype(
        np.int64
    )
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    flat = np.bincount(
        rows * num_buckets + buckets, weights=values,
        minlength=n * num_buckets,
    )
    return flat.reshape(n, num_buckets).astype(dtype)


def check_binary_labels(y: np.ndarray, model_name: str) -> None:
    """Validate labels ∈ {0, 1} (shared by the binomial classifiers)."""
    labels = np.unique(y)
    if not np.all(np.isin(labels, (0.0, 1.0))):
        raise ValueError(
            f"{model_name} requires labels in {{0, 1}}, got {labels}"
        )


def labeled_sparse_data(
    table: Table,
    features_col: str,
    label_col: str,
    weight_col: Optional[str] = None,
    dtype=np.float32,
):
    """Sparse analog of :func:`labeled_data`: host CSR arrays + labels.

    Returns ``(indptr, indices, values, dim, y, w)``.
    """
    from flinkml_tpu_torch.ops.sparse import csr_from_sparse_vectors

    col = table.column(features_col)
    indptr, indices, values, dim = csr_from_sparse_vectors(col, dtype=dtype)
    y = np.asarray(table.column(label_col), dtype=dtype).reshape(-1)
    if y.shape[0] != indptr.size - 1:
        raise ValueError(
            f"label column {label_col!r} has {y.shape[0]} rows, features "
            f"have {indptr.size - 1}"
        )
    if weight_col is not None:
        w = np.asarray(table.column(weight_col), dtype=dtype).reshape(-1)
    else:
        w = np.ones(y.shape[0], dtype=dtype)
    return indptr, indices, values, dim, y, w


def sharded_rows(mesh, x: np.ndarray, fn):
    """``fn`` over this rank's block of ``x``'s rows, the blocks gathered
    back in row order on the host (the sharded transform: pad to the
    mesh's data axis, :meth:`~flinkml_tpu_torch.parallel.DeviceMesh.
    shard_batch`, ``fn``, :meth:`~flinkml_tpu_torch.parallel.DeviceMesh.
    to_host`). A collective: every rank calls it with the same ``x``.
    ``fn`` returns a tensor or a tuple of tensors with a leading row
    axis."""
    from flinkml_tpu_torch.parallel.mesh import pad_to_multiple

    x_pad, n_valid = pad_to_multiple(x, mesh.axis_size())
    out = fn(mesh.shard_batch(x_pad))
    if isinstance(out, tuple):
        return tuple(mesh.to_host(o)[:n_valid] for o in out)
    return mesh.to_host(out)[:n_valid]
