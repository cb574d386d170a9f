"""flinkml_tpu_torch.data — streaming input pipelines with checkpointable
cursors and async device prefetch.

The port's counterpart of ``flinkml_tpu.data``, one process:

    source → map/filter/rebatch/window → shuffle → prefetch-to-device

built from sharded :mod:`~flinkml_tpu_torch.data.source` heads
(in-memory arrays, CSV and LibSVM files through the native parsers, a
seeded generator), deterministic :mod:`~flinkml_tpu_torch.data.ops`, a
bucket-padding :class:`DevicePrefetcher` tail on its own CUDA stream, and
a :class:`Cursor` that rides :class:`~flinkml_tpu_torch.iteration.
CheckpointManager` snapshots, so a killed and resumed pipeline replays the
exact uninterrupted batch sequence (shuffle order included).
:class:`ElasticFeed` merges ``world`` shard readers into one global order
that does not depend on ``world``. A cursor written by either package
restores in the other.

A source's ``mesh=`` reads this rank's shard of the mesh's data axis,
each rank's partition of a multi-process stream. The exports are the JAX
package's, ``HashOp`` (``Dataset.hash_column``: raw keys hashed into
bucket ids by :mod:`flinkml_tpu_torch.features.hashing`) among them.
"""

from flinkml_tpu_torch.data.dataset import Dataset, DatasetIterator
from flinkml_tpu_torch.data.elastic import ElasticFeed, ElasticFeedIterator
from flinkml_tpu_torch.data.ops import (
    FilterOp,
    HashOp,
    MapOp,
    Op,
    RebatchOp,
    ShuffleOp,
    WindowOp,
)
from flinkml_tpu_torch.data.prefetch import DevicePrefetcher, pad_place_table
from flinkml_tpu_torch.data.source import (
    ArraySource,
    CSVSource,
    LibSVMSource,
    Source,
    SourceIterator,
    SyntheticSource,
    resolve_shard,
    round_robin_skip,
)
from flinkml_tpu_torch.data.state import (
    Cursor,
    CursorShardMismatchError,
    rng_state_dict,
)

__all__ = [
    "Dataset",
    "DatasetIterator",
    "ElasticFeed",
    "ElasticFeedIterator",
    "Cursor",
    "CursorShardMismatchError",
    "rng_state_dict",
    "round_robin_skip",
    "Source",
    "SourceIterator",
    "ArraySource",
    "CSVSource",
    "LibSVMSource",
    "SyntheticSource",
    "resolve_shard",
    "Op",
    "MapOp",
    "FilterOp",
    "HashOp",
    "RebatchOp",
    "WindowOp",
    "ShuffleOp",
    "DevicePrefetcher",
    "pad_place_table",
]
