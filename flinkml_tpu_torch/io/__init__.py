"""Persistence of stages (metadata JSON + ``.npz`` model data) and the
numeric-CSV and LibSVM readers (native parsers built with ``g++`` at first
use, with a pure-Python parse beside them)."""

from flinkml_tpu_torch.io.csv import read_csv, read_csv_table  # noqa: F401
from flinkml_tpu_torch.io.libsvm import (  # noqa: F401
    read_libsvm,
    read_libsvm_dense,
    read_libsvm_table,
)
from flinkml_tpu_torch.io.read_write import (  # noqa: F401
    ModelIntegrityError,
    content_fingerprint,
    load_metadata,
    load_model_arrays,
    load_stage,
    save_metadata,
    save_model_arrays,
    stage_from_arrays,
)

__all__ = [
    "ModelIntegrityError",
    "content_fingerprint",
    "load_metadata",
    "load_model_arrays",
    "load_stage",
    "save_metadata",
    "save_model_arrays",
    "read_csv",
    "read_csv_table",
    "read_libsvm",
    "read_libsvm_dense",
    "read_libsvm_table",
    "stage_from_arrays",
]
