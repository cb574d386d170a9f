"""flinkml_tpu_torch.features — the streaming feature platform.

The port's counterpart of ``flinkml_tpu.features``.

Two halves close the train-to-serve freshness loop:

- **hashing** (:mod:`.hashing`) — a seeded, process-stable hash front
  end mapping raw string/int keys straight to embedding-table rows, no
  vocabulary build, with measured collision telemetry
  (``features.hash``) and the FML505 buckets-vs-vocab gate.
- **incremental publishes** (:mod:`.delta`, :mod:`.trainer`,
  :mod:`.publisher`, :mod:`.model`) — a streaming FM trainer whose
  touched rows publish as fingerprint-chained
  :class:`~flinkml_tpu_torch.features.delta.ModelDelta` versions that serving
  replicas patch in place, so fresh rows reach a pool without a single
  full-model republish on the hot path.

Operator guide: ``docs/operators/features.md`` (written for the JAX
package; the port keeps its API).
"""

from flinkml_tpu_torch.features.delta import ModelDelta
from flinkml_tpu_torch.features.hashing import (
    CollisionTracker,
    HashedFeature,
    HashVocabMismatchError,
    check_hash_vocab,
    expected_collision_fraction,
    hash_buckets,
    murmur3_32,
)
from flinkml_tpu_torch.features.model import HashedFMModel
from flinkml_tpu_torch.features.publisher import DeltaPublisher
from flinkml_tpu_torch.features.trainer import StreamingHashedFMTrainer

__all__ = [
    "CollisionTracker",
    "DeltaPublisher",
    "HashVocabMismatchError",
    "HashedFMModel",
    "HashedFeature",
    "ModelDelta",
    "StreamingHashedFMTrainer",
    "check_hash_vocab",
    "expected_collision_fraction",
    "hash_buckets",
    "murmur3_32",
]
