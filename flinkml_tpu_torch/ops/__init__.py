"""Sparse and dense numerical ops of the port."""
from flinkml_tpu_torch.ops import blas  # noqa: F401
from flinkml_tpu_torch.ops.distance import (  # noqa: F401
    DistanceMeasure,
    EuclideanDistanceMeasure,
)
from flinkml_tpu_torch.ops.sparse import BatchedCSR  # noqa: F401

__all__ = ["blas", "DistanceMeasure", "EuclideanDistanceMeasure", "BatchedCSR"]
