"""Persistence of stages (metadata JSON + ``.npz`` model data)."""

from flinkml_tpu_torch.io.read_write import (  # noqa: F401
    ModelIntegrityError,
    content_fingerprint,
    load_stage,
    stage_from_arrays,
)

__all__ = [
    "ModelIntegrityError",
    "content_fingerprint",
    "load_stage",
    "stage_from_arrays",
]
