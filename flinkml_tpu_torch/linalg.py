"""Vector/matrix value types and factories.

Parity with ``flink-ml-core/.../ml/linalg/``: ``DenseVector``,
``SparseVector``, ``DenseMatrix`` POJOs and the ``Vectors.dense/sparse``
factories (``Vectors.java:25,30``). The reference also ships custom Flink
serializers per type (``typeinfo/DenseVectorSerializer.java``); here
serialization is plain numpy ``.npz`` (see
``flinkml_tpu_torch.io.read_write``) — no custom wire format is needed
because tables move as columnar batches, not record streams.

These types are *host-side value objects* for user-facing rows and model
data, identical to the JAX package's (``flinkml_tpu.linalg``) so a row built
for one package feeds the other. The compute path never loops over them —
algorithms convert whole columns to device tensors (``Table`` columns are
already ``[rows, dim]``) and sparse data to padded ELL blocks
(``flinkml_tpu_torch.ops.sparse``) before touching the GPU.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (and ≥ 1). Shared size-quantization
    helper: padded shapes quantized to powers of two bound the number of
    distinct cached programs to log2(max size) per call site (row buckets
    in :mod:`flinkml_tpu_torch.pipeline_fusion`)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class Vector:
    """Abstract vector. Parity: ``ml/linalg/Vector.java``."""

    def size(self) -> int:
        raise NotImplementedError

    def get(self, i: int) -> float:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        raise NotImplementedError

    def to_dense(self) -> "DenseVector":
        return DenseVector(self.to_array())

    def __len__(self) -> int:
        return self.size()


class DenseVector(Vector):
    """Dense double vector. Parity: ``ml/linalg/DenseVector.java``."""

    def __init__(self, values: Union[np.ndarray, Sequence[float]]):
        self.values = np.asarray(values, dtype=np.float64)
        if self.values.ndim != 1:
            raise ValueError(f"DenseVector requires 1-D data, got {self.values.ndim}-D")

    def size(self) -> int:
        return self.values.shape[0]

    def get(self, i: int) -> float:
        return float(self.values[i])

    def set(self, i: int, value: float) -> None:
        self.values[i] = value

    def to_array(self) -> np.ndarray:
        return self.values

    def dot(self, other: "Vector") -> float:
        return float(np.dot(self.values, other.to_array()))

    def norm2(self) -> float:
        return float(np.linalg.norm(self.values))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DenseVector) and np.array_equal(
            self.values, other.values
        )

    def __hash__(self) -> int:
        return hash(self.values.tobytes())

    def __repr__(self) -> str:
        return f"DenseVector({self.values.tolist()})"


class SparseVector(Vector):
    """Sorted-index sparse vector. Parity: ``ml/linalg/SparseVector.java``
    (indices kept sorted and deduplicated at construction)."""

    def __init__(
        self,
        size: int,
        indices: Union[np.ndarray, Sequence[int]],
        values: Union[np.ndarray, Sequence[float]],
    ):
        indices = np.asarray(indices, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        if indices.shape != values.shape or indices.ndim != 1:
            raise ValueError("indices and values must be 1-D with equal length")
        if indices.size > 0:
            if indices.min() < 0 or indices.max() >= size:
                raise ValueError(
                    f"index out of range for size {size}: "
                    f"[{indices.min()}, {indices.max()}]"
                )
            order = np.argsort(indices, kind="stable")
            indices = indices[order]
            values = values[order]
            if np.any(np.diff(indices) == 0):
                raise ValueError("duplicate indices in SparseVector")
        self._size = int(size)
        self.indices = indices
        self.values = values

    @classmethod
    def _from_sorted(cls, size: int, indices: np.ndarray,
                     values: np.ndarray) -> "SparseVector":
        """Internal trusted construction: skips validation and sorting.
        Callers guarantee sorted, unique, in-range int64 indices and
        float64 values — used by bulk producers (e.g. the sparse
        OneHotEncoder) where per-row validation dominates."""
        self = object.__new__(cls)
        self._size = int(size)
        self.indices = indices
        self.values = values
        return self

    def size(self) -> int:
        return self._size

    def get(self, i: int) -> float:
        if not 0 <= i < self._size:
            raise IndexError(f"index {i} out of range for size {self._size}")
        pos = np.searchsorted(self.indices, i)
        if pos < self.indices.size and self.indices[pos] == i:
            return float(self.values[pos])
        return 0.0

    def to_array(self) -> np.ndarray:
        out = np.zeros(self._size, dtype=np.float64)
        out[self.indices] = self.values
        return out

    def dot(self, other: "Vector") -> float:
        if isinstance(other, SparseVector):
            return float(np.dot(self.to_array(), other.to_array()))
        return float(np.dot(self.values, other.to_array()[self.indices]))

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, SparseVector)
            and other._size == self._size
            and np.array_equal(other.indices, self.indices)
            and np.array_equal(other.values, self.values)
        )

    def __hash__(self) -> int:
        return hash((self._size, self.indices.tobytes(), self.values.tobytes()))

    def __repr__(self) -> str:
        return (
            f"SparseVector({self._size}, {self.indices.tolist()}, "
            f"{self.values.tolist()})"
        )


class DenseMatrix:
    """Column-major dense matrix. Parity: ``ml/linalg/DenseMatrix.java``
    (the reference stores column-major for its gemv; here the backing array
    is a standard 2-D row-major numpy array)."""

    def __init__(self, num_rows: int, num_cols: int, values: np.ndarray = None):
        if values is None:
            values = np.zeros((num_rows, num_cols), dtype=np.float64)
        values = np.asarray(values, dtype=np.float64)
        if values.shape == (num_rows * num_cols,):
            # Accept flat column-major payloads like the reference ctor.
            values = values.reshape((num_cols, num_rows)).T.copy()
        if values.shape != (num_rows, num_cols):
            raise ValueError(
                f"values shape {values.shape} != ({num_rows}, {num_cols})"
            )
        self.values = values

    @property
    def num_rows(self) -> int:
        return self.values.shape[0]

    @property
    def num_cols(self) -> int:
        return self.values.shape[1]

    def get(self, i: int, j: int) -> float:
        return float(self.values[i, j])

    def __eq__(self, other: object) -> bool:
        return isinstance(other, DenseMatrix) and np.array_equal(
            self.values, other.values
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"DenseMatrix({self.num_rows}x{self.num_cols})"


class Vectors:
    """Factory methods. Parity: ``ml/linalg/Vectors.java:25,30``."""

    @staticmethod
    def dense(*values: float) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(list(values))

    @staticmethod
    def sparse(size: int, indices: Sequence[int], values: Sequence[float]) -> SparseVector:
        return SparseVector(size, indices, values)


def stack_vectors(vectors: Iterable[Vector]) -> np.ndarray:
    """Densify a sequence of vectors into a [rows, dim] batch array.

    The bridge from row-wise user data to the columnar compute path; sparse
    inputs at scale should use ``flinkml_tpu_torch.ops.sparse`` instead.
    """
    rows = [v.to_array() if isinstance(v, Vector) else np.asarray(v) for v in vectors]
    return np.stack(rows).astype(np.float64)
