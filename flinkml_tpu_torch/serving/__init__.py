"""flinkml_tpu_torch.serving — the online inference runtime.

The port's counterpart of ``flinkml_tpu.serving``, with the same public
names. Every batch runs the active model's ``transform`` on the engine's
device (``cuda`` unless the constructing thread asked for the CPU with
:func:`~flinkml_tpu_torch.device.use_device`), so a fused run is one
``fused_chain`` launch; on the card each engine dispatches on a CUDA
stream of its own, so replicas sharing one card overlap.

The layer between the train/transform framework and "heavy traffic from
millions of users" (ROADMAP north star): a request path in front of the
fused pipeline executor, versioned model publication, zero-downtime
model rollout, and a horizontally scaled replica-pool front. The pieces:

- :class:`ServingEngine` — thread-safe ``predict()`` with
  **continuous batching**: concurrent requests coalesce into the
  power-of-two row buckets the fused compile cache already owns,
  splitting at bucket boundaries so a late arrival joins the currently
  forming bucket (per-request row reassembly keeps responses bitwise
  single-version); per-bucket warmup at load, bounded-queue admission
  control, per-request deadlines swept promptly, and host-path load
  shedding. ``ServingConfig(batching="fifo")`` keeps the
  whole-request packing for comparison.
- :class:`ReplicaPool` + :class:`Router` — N engine replicas (one per
  device, or one per mesh slice time-sharing with training through
  ``local_execution_lock``) behind least-outstanding-rows routing with
  deadline-aware admission, per-replica overload degradation, automatic
  failover, and rolling (one-replica-at-a-time) registry hot-swaps.
- :class:`PoolAutoscaler` — the closed control loop over the pool's
  own metrics: hysteretic scale-up/-down (the 1.10x
  decisive-win idiom), chaos replacement, and training slice-lease reclaim (FML304-audited).
- :class:`GrayFailGuard` + :class:`GrayFailPolicy` — gray-failure
  defense for the pool: per-dispatch deadlines with true abandonment,
  hedged requests (first completion wins, loser cancelled at the
  queue), MAD-based latency-outlier quarantine (the ``SLOW`` health
  state, canary-probed rejoin, autoscaler-composed replacement), and a
  brownout ladder shedding SLO classes in declared order under
  pool-wide degradation.
- :class:`MultiModelPool` + :class:`SLOClass` — N registries over one
  pool with per-class deadline budgets and admission share caps
  (weighted admission: a batch job can never starve the interactive
  tier; refusals are the typed :class:`SLOAdmissionError`).
- :class:`ModelRegistry` — versioned, fingerprint-verified model store
  with an atomic "current" pointer; ``publish`` / ``get`` / ``rollback``.
- :class:`SnapshotPublisher` — an ``IterationListener`` that turns a
  *running* training stream into registry versions every N epochs
  (mid-stream model emission, the reference's unbounded-``Iterations``
  capability).
- typed errors (:mod:`flinkml_tpu_torch.serving.errors`) for every rejection
  the online path can produce.
"""

from flinkml_tpu_torch.serving.autoscaler import AutoscaleConfig, PoolAutoscaler
from flinkml_tpu_torch.serving.batcher import (
    AdaptiveMicroBatcher,
    BatchSegment,
    ContinuousBatcher,
    ServingRequest,
)
from flinkml_tpu_torch.serving.engine import (
    PendingPrediction,
    ServingConfig,
    ServingEngine,
    ServingResponse,
)
from flinkml_tpu_torch.serving.grayfail import (
    GrayFailGuard,
    GrayFailPolicy,
    ReplicaQuarantinedError,
)
from flinkml_tpu_torch.serving.errors import (
    DeltaChainError,
    EngineStoppedError,
    ModelIntegrityError,
    ModelVersionNotFoundError,
    PoolUnavailableError,
    RegistryError,
    ServingError,
    ServingMemoryError,
    ServingOverloadError,
    ServingSchemaError,
    ServingTimeoutError,
    SLOAdmissionError,
)
from flinkml_tpu_torch.serving.health import HealthPolicy, ReplicaHealth, ReplicaState
from flinkml_tpu_torch.serving.multiplex import (
    BATCH,
    INTERACTIVE,
    MultiModelPool,
    SLOClass,
)
from flinkml_tpu_torch.serving.pool import Replica, ReplicaPool, slice_meshes
from flinkml_tpu_torch.serving.publisher import SnapshotPublisher
from flinkml_tpu_torch.serving.registry import ModelRegistry
from flinkml_tpu_torch.serving.router import Router

__all__ = [
    "AdaptiveMicroBatcher",
    "AutoscaleConfig",
    "BATCH",
    "BatchSegment",
    "ContinuousBatcher",
    "DeltaChainError",
    "EngineStoppedError",
    "GrayFailGuard",
    "GrayFailPolicy",
    "HealthPolicy",
    "INTERACTIVE",
    "MultiModelPool",
    "PoolAutoscaler",
    "SLOAdmissionError",
    "SLOClass",
    "ModelIntegrityError",
    "ModelRegistry",
    "ModelVersionNotFoundError",
    "PoolUnavailableError",
    "RegistryError",
    "PendingPrediction",
    "Replica",
    "ReplicaHealth",
    "ReplicaPool",
    "ReplicaQuarantinedError",
    "ReplicaState",
    "Router",
    "ServingConfig",
    "ServingEngine",
    "ServingError",
    "ServingMemoryError",
    "ServingOverloadError",
    "ServingRequest",
    "ServingResponse",
    "ServingSchemaError",
    "ServingTimeoutError",
    "SnapshotPublisher",
    "slice_meshes",
]
