"""The parallelism substrate on ``torch.distributed``.

The port's counterpart of ``flinkml_tpu.parallel``: one process per rank
and one device per rank (PyTorch's idiom, not JAX's single controller over
many local devices). :class:`DeviceMesh` names the ranks with the JAX axis
names; :mod:`~flinkml_tpu_torch.parallel.collectives` runs each primitive
on this rank's block and combines the blocks with one collective;
:func:`init_distributed` forms the process group (``nccl`` for ``cuda``,
``gloo`` for ``cpu``); :mod:`~flinkml_tpu_torch.parallel.dispatch` bounds
in-flight collective steps and serializes threads over one mesh;
:mod:`~flinkml_tpu_torch.parallel.tensor` (tensor, pipeline and expert
parallelism) and :mod:`~flinkml_tpu_torch.parallel.ring` (ring and Ulysses
attention) run the JAX package's ``shard_map`` bodies on each rank's block.
"""

from flinkml_tpu_torch.parallel.mesh import DeviceMesh, pad_to_multiple
from flinkml_tpu_torch.parallel.collectives import (
    REPLICATED,
    all_reduce_sum,
    broadcast,
    keyed_aggregate,
    map_partition,
    psum,
)
from flinkml_tpu_torch.parallel.broadcast_utils import (
    BroadcastContext,
    get_broadcast_variable,
    with_broadcast,
)
from flinkml_tpu_torch.parallel.dispatch import (
    DispatchGuard,
    default_sync_interval,
    synced_loop,
)
from flinkml_tpu_torch.parallel.distributed import (
    agree_resume_epoch,
    compact_rank,
    host_barrier,
    init_distributed,
    process_slice,
    rescale_world,
    shutdown_distributed,
)
from flinkml_tpu_torch.parallel.ring import ring_attention, ulysses_attention
from flinkml_tpu_torch.parallel.tensor import (
    expert_parallel_ffn,
    pipeline_parallel_apply,
    register_pipeline_stage,
    routed_expert_ffn,
    tensor_parallel_mlp,
)

__all__ = [
    "DeviceMesh",
    "pad_to_multiple",
    "REPLICATED",
    "all_reduce_sum",
    "broadcast",
    "keyed_aggregate",
    "map_partition",
    "psum",
    "BroadcastContext",
    "get_broadcast_variable",
    "with_broadcast",
    "DispatchGuard",
    "default_sync_interval",
    "synced_loop",
    "agree_resume_epoch",
    "compact_rank",
    "host_barrier",
    "init_distributed",
    "process_slice",
    "rescale_world",
    "shutdown_distributed",
    "ring_attention",
    "ulysses_attention",
    "expert_parallel_ffn",
    "pipeline_parallel_apply",
    "register_pipeline_stage",
    "routed_expert_ffn",
    "tensor_parallel_mlp",
]
