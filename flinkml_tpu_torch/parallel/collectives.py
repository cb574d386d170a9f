"""Distributed primitives on ``torch.distributed``.

The port's counterpart of ``flinkml_tpu.parallel.collectives``
(reference: ``AllReduceImpl.java:52-299``, ``BroadcastUtils``,
``DataStreamUtils.mapPartition``). Each rank runs the function on its
own block and one collective combines the blocks over the mesh's data
axis:

- :func:`all_reduce_sum`: a local sum over the block's rows, then one
  ``all_reduce``;
- :func:`broadcast`: the value placed on this rank's device, then one
  ``broadcast`` from the axis's first rank per leaf;
- :func:`keyed_aggregate`: the port's ``segment_sum`` kernel on the local
  block, then one ``all_reduce``;
- :func:`map_partition`: the function on the local block; its results
  all-gathered in data order, or returned as they are with a replicated
  ``out_specs``.

Inputs follow the SPMD convention of :mod:`~flinkml_tpu_torch.parallel.
mesh`: a host (numpy) array is the global table every rank passes, sharded
here by :meth:`~flinkml_tpu_torch.parallel.DeviceMesh.shard_batch`; a
tensor is already this rank's block. Without a process group the mesh has
one rank and no collective is issued. gloo and NCCL add in their own
order, not XLA's ``psum`` order, so a sum agrees with the JAX package's to
rounding; every rank receives the same bits.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from flinkml_tpu_torch.parallel.mesh import DeviceMesh, tree_map

#: ``out_specs`` of :func:`map_partition` for a result that is already
#: replicated (the JAX package's ``P()``).
REPLICATED = "replicated"


def _local(mesh: DeviceMesh, array) -> torch.Tensor:
    if torch.is_tensor(array):
        return array.to(mesh.device)
    return mesh.shard_batch(np.asarray(array))


def psum(mesh: DeviceMesh, tensor: torch.Tensor,
         axis: str = DeviceMesh.DATA_AXIS) -> torch.Tensor:
    """``tensor`` summed over the ranks along ``axis`` (every rank gets
    the sum; ``jax.lax.psum`` inside a ``shard_map``). A new tensor; the
    argument is not modified."""
    out = tensor.clone()
    all_reduce_(mesh, out, axis)
    return out


def all_reduce_(mesh: DeviceMesh, tensor: torch.Tensor,
                axis: str = DeviceMesh.DATA_AXIS) -> torch.Tensor:
    """In-place sum of ``tensor`` over the ranks along ``axis``; a no-op
    without a process group. Returns ``tensor``."""
    group = mesh.group(axis)
    if group is not None:
        import torch.distributed as dist

        from flinkml_tpu_torch.parallel.dispatch import (
            record_collective_dispatch,
        )

        record_collective_dispatch("all_reduce", mesh.axis_ranks(axis),
                                   ("all_reduce",))
        dist.all_reduce(tensor, group=group)
    return tensor


def all_reduce_sum(mesh: DeviceMesh, contributions) -> torch.Tensor:
    """Sum the contributions of every rank; every rank gets the result.

    ``contributions``: the global ``[P·k, ...]`` host table (one block of
    ``k`` rows per rank, as each of the reference's P subtasks holds one
    ``double[]``), or this rank's block as a tensor. The block is summed
    over its rows, then one ``all_reduce`` (``AllReduceImpl``'s chunked
    reduce-scatter and all-gather are the backend's).
    """
    return all_reduce_(mesh, torch.sum(_local(mesh, contributions), dim=0))


def broadcast(mesh: DeviceMesh, tree):
    """Replicate value(s) to every rank: each leaf placed on this rank's
    device, then broadcast from the data axis's first rank (so every rank
    holds that rank's bits)."""
    placed = mesh.replicate(tree)
    group = mesh.group(DeviceMesh.DATA_AXIS)
    if group is None:
        return placed
    import torch.distributed as dist

    src_rank = mesh.axis_ranks(DeviceMesh.DATA_AXIS)[0]

    def send(leaf):
        leaf = leaf.contiguous()
        dist.broadcast(leaf, src_rank, group=group)
        return leaf

    return tree_map(send, placed)


def keyed_aggregate(mesh: DeviceMesh, values, keys,
                    num_segments: int) -> torch.Tensor:
    """Sum ``values`` grouped by integer ``keys``; the result is
    replicated.

    values: ``[n, ...]``, keys: ``[n]`` in ``[0, num_segments)`` (host
    tables, or this rank's blocks as tensors). Returns ``[num_segments,
    ...]`` summed over every rank: the ``segment_sum`` kernel on this
    rank's block, then one ``all_reduce``.
    """
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    v = _local(mesh, values)
    k = _local(mesh, np.asarray(keys, dtype=np.int32)
               if not torch.is_tensor(keys) else keys.to(torch.int32))
    return all_reduce_(mesh, segment_sum(v, k, int(num_segments)))


def gather_blocks(mesh: DeviceMesh, block: torch.Tensor) -> torch.Tensor:
    """Every rank's block along the data axis, concatenated in data order
    on this rank's device (one ``all_gather``; every rank calls it)."""
    import torch.distributed as dist

    group = mesh.group(DeviceMesh.DATA_AXIS)
    block = torch.as_tensor(block).to(mesh.device).contiguous()
    if group is None:
        return block
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, block, group=group)
    # all_gather fills in group-rank order; place each by its data index.
    order = mesh.axis_ranks(DeviceMesh.DATA_AXIS)
    by_rank = dict(zip(dist.get_process_group_ranks(group), parts))
    return torch.cat([by_rank[r] for r in order])


def map_partition(mesh: DeviceMesh, fn: Callable, *arrays, out_specs=None):
    """Apply ``fn`` once per rank to its block of each input (the shard IS
    the partition).

    ``fn`` returns tensor(s) with a leading row axis; by default every
    rank's results are all-gathered in data order (``mapPartition``'s one
    output per partition, concatenated). Pass ``out_specs=REPLICATED``
    (the JAX package's ``P()``) when the result is already replicated,
    e.g. after a :func:`psum` inside ``fn``: it is returned as it is.
    """
    if out_specs not in (None, REPLICATED):
        raise ValueError(
            f"out_specs must be None (gathered) or {REPLICATED!r}, got "
            f"{out_specs!r}"
        )
    out = fn(*(_local(mesh, a) for a in arrays))
    if out_specs == REPLICATED:
        return out
    if isinstance(out, (tuple, list)):
        return type(out)(gather_blocks(mesh, o) for o in out)
    return gather_blocks(mesh, out)
