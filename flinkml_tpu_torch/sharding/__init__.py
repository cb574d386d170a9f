"""flinkml_tpu_torch.sharding — the declarative sharding layer.

The port's counterpart of ``flinkml_tpu.sharding``. A
:class:`~flinkml_tpu_torch.sharding.plan.ShardingPlan` maps parameter
families (name patterns) to specs over the named mesh axes ``data`` /
``fsdp`` / ``tp``, declares how batches shard, and is checked against the
mesh before any step by the FML5xx pass
(:mod:`flinkml_tpu_torch.analysis.sharding_check`):

- :mod:`.plan` — the plan value: presets, ``infer_plan``, JSON (the JAX
  package's, byte for byte) and the checkpoint layout tags
  (``layouts_for``);
- :mod:`.apply` — the plan through the linear trainer: state placed per
  the plan (DTensors on the mesh's torch ``DeviceMesh``), each rank's
  step on its blocks with an all-gather of ``coef`` and one all-reduce of
  the gradient over the batch axes.
"""

from flinkml_tpu_torch.sharding.plan import (  # noqa: F401
    BATCH_PARALLEL,
    EMBEDDING,
    EMBEDDING_FAMILY_PATTERNS,
    FSDP,
    FSDP_TP,
    NoFeasiblePlanError,
    PRESETS,
    REPLICATED,
    ShardingPlan,
    infer_plan,
    is_embedding_param,
    layouts_for,
    per_device_state_bytes,
)
from flinkml_tpu_torch.sharding.apply import (  # noqa: F401
    PlanValidationError,
    batch_sharding,
    shard_state,
    state_shardings,
    train_linear_plan,
)

__all__ = [
    "ShardingPlan",
    "REPLICATED",
    "BATCH_PARALLEL",
    "FSDP",
    "FSDP_TP",
    "EMBEDDING",
    "EMBEDDING_FAMILY_PATTERNS",
    "PRESETS",
    "infer_plan",
    "is_embedding_param",
    "layouts_for",
    "per_device_state_bytes",
    "NoFeasiblePlanError",
    "PlanValidationError",
    "batch_sharding",
    "shard_state",
    "state_shardings",
    "train_linear_plan",
]
