"""The iteration runtime (:mod:`~flinkml_tpu_torch.iteration.runtime`),
the device loop, checkpoint/resume and the data cache, one process."""

from flinkml_tpu_torch.iteration.runtime import (  # noqa: F401
    ForwardInputsOfLastRound,
    IterationConfig,
    IterationListener,
    IterationResult,
    Iterations,
    TerminateOnMaxIter,
    TerminateOnMaxIterOrTol,
    TerminationCriterion,
    iterate,
    notify_epoch_listeners,
)
from flinkml_tpu_torch.iteration.device_loop import device_iterate  # noqa: F401
from flinkml_tpu_torch.iteration.checkpoint import (  # noqa: F401
    CheckpointIntegrityError,
    CheckpointManager,
    LayoutConflictError,
    RescaleError,
    RescalePolicy,
    reshard_rank_state,
)
from flinkml_tpu_torch.iteration.datacache import (  # noqa: F401
    DataCache,
    DataCacheReader,
    DataCacheSnapshot,
    DataCacheWriter,
    PrefetchingDeviceFeed,
    Segment,
    cache_stream,
    replay,
)

__all__ = [
    "CheckpointIntegrityError",
    "CheckpointManager",
    "DataCache",
    "DataCacheReader",
    "DataCacheSnapshot",
    "DataCacheWriter",
    "ForwardInputsOfLastRound",
    "IterationConfig",
    "IterationListener",
    "IterationResult",
    "Iterations",
    "PrefetchingDeviceFeed",
    "LayoutConflictError",
    "RescaleError",
    "RescalePolicy",
    "Segment",
    "TerminateOnMaxIter",
    "TerminateOnMaxIterOrTol",
    "TerminationCriterion",
    "cache_stream",
    "device_iterate",
    "iterate",
    "notify_epoch_listeners",
    "replay",
    "reshard_rank_state",
]
