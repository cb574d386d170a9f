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

The group primitives below take a process group and its ranks in mesh
order (:meth:`~flinkml_tpu_torch.parallel.DeviceMesh.group_over`) and
stand for the JAX package's named-axis collectives inside ``shard_map``:
:func:`group_all_reduce` (``psum``), :func:`group_all_gather`
(``all_gather(tiled=True)``), :func:`group_all_to_all`
(``all_to_all(split_axis=0, concat_axis=0, tiled=True)``) and
:func:`ppermute` (``ppermute`` with the ring permutation, one
``batch_isend_irecv``). Under gloo, ``send``/``recv`` and ``all_to_all``
move host tensors in this port: a CUDA payload is copied to host memory,
exchanged, and copied back (:data:`HOST_STAGED` counts each), while the
arithmetic stays on the card. ``all_reduce`` and ``all_gather`` take the
CUDA tensors directly, and NCCL never stages.

While a capture traces a program (:mod:`flinkml_tpu_torch.analysis.
_capture`), every primitive here calls its ``torch.ops.flinkml`` op
instead, whether or not a group exists, so the captured graph holds the
program's collectives in order with their axes (``"data"``) or ranks
(``"ranks=0,1"``) as a string argument (:func:`spec_of`); the op's real
implementation finds the mesh or group again under that string
(:data:`CAPTURED`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from flinkml_tpu_torch.kernels import _gate
from flinkml_tpu_torch.parallel.mesh import DeviceMesh, tree_map

#: ``out_specs`` of :func:`map_partition` for a result that is already
#: replicated (the JAX package's ``P()``).
REPLICATED = "replicated"


#: The mesh or ``(group, ranks)`` a captured collective named by its spec
#: string ran over (the newest capture's), for the op's real
#: implementation.
CAPTURED: dict = {}


def spec_of(ranks) -> str:
    """The string a captured group primitive carries: its ranks in mesh
    order."""
    return "ranks=" + ",".join(str(int(r)) for r in ranks)


def _captured(name: str, key: str, where, *args):
    CAPTURED[key] = where
    return _gate.op(name)(*args)


def _local(mesh: DeviceMesh, array) -> torch.Tensor:
    if torch.is_tensor(array):
        return array.to(mesh.device)
    return mesh.shard_batch(np.asarray(array))


def psum(mesh: DeviceMesh, tensor: torch.Tensor,
         axis: str = DeviceMesh.DATA_AXIS) -> torch.Tensor:
    """``tensor`` summed over the ranks along ``axis`` (every rank gets
    the sum; ``jax.lax.psum`` inside a ``shard_map``). A new tensor; the
    argument is not modified."""
    if _gate.CAPTURE.on:
        return _captured("psum", axis, mesh, tensor, axis)
    out = tensor.clone()
    all_reduce_(mesh, out, axis)
    return out


def all_reduce_(mesh: DeviceMesh, tensor: torch.Tensor,
                axis: str = DeviceMesh.DATA_AXIS) -> torch.Tensor:
    """In-place sum of ``tensor`` over the ranks along ``axis``; a no-op
    without a process group. Returns ``tensor``."""
    if _gate.CAPTURE.on:
        return _captured("all_reduce_", axis, mesh, tensor, axis)
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
    if _gate.CAPTURE.on:
        axis = DeviceMesh.DATA_AXIS
        return tree_map(lambda leaf: _captured("broadcast", axis, mesh,
                                               leaf, axis), placed)
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


#: Payloads a gloo group moved through host memory, by primitive (see the
#: module docstring). NCCL groups never add to it.
HOST_STAGED = {"ppermute": 0, "all_to_all": 0}


def _dist():
    import torch.distributed as dist

    return dist


def _staged(group, tensor: torch.Tensor) -> bool:
    """True when ``tensor`` crosses ``group`` through host memory: a CUDA
    tensor under gloo."""
    return tensor.is_cuda and _dist().get_backend(group) == "gloo"


def _group_order(group, ranks) -> list:
    """The mesh index of each group rank: ``torch.distributed`` numbers a
    group's members by global rank, the mesh by its own order."""
    members = _dist().get_process_group_ranks(group)
    return [list(ranks).index(g) for g in members]


def group_all_reduce(group, ranks, tensor: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``tensor`` over ``group`` (``psum``); a no-op
    without a group or for one rank. Returns ``tensor``."""
    if _gate.CAPTURE.on:
        spec = spec_of(ranks)
        return _captured("group_all_reduce", spec, (group, ranks), tensor,
                         spec)
    if group is None or len(ranks) == 1:
        return tensor
    from flinkml_tpu_torch.parallel.dispatch import record_collective_dispatch

    record_collective_dispatch("all_reduce", ranks, ("all_reduce",))
    _dist().all_reduce(tensor, group=group)
    return tensor


def group_all_gather(group, ranks, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` concatenated along dim 0 in mesh order
    (``all_gather(tiled=True)``)."""
    if _gate.CAPTURE.on:
        spec = spec_of(ranks)
        return _captured("group_all_gather", spec, (group, ranks), tensor,
                         spec)
    tensor = tensor.contiguous()
    if group is None or len(ranks) == 1:
        return tensor
    from flinkml_tpu_torch.parallel.dispatch import record_collective_dispatch

    dist = _dist()
    parts = [torch.empty_like(tensor) for _ in ranks]
    record_collective_dispatch("all_gather", ranks, ("all_gather",))
    dist.all_gather(parts, tensor, group=group)
    by_mesh = dict(zip(_group_order(group, ranks), parts))
    return torch.cat([by_mesh[m] for m in range(len(ranks))])


def group_all_to_all(group, ranks, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor [P, ...]``: block ``m`` goes to the mesh's rank ``m``, and
    block ``m`` of the result came from it (``all_to_all(split_axis=0,
    concat_axis=0, tiled=True)``)."""
    if _gate.CAPTURE.on:
        spec = spec_of(ranks)
        return _captured("group_all_to_all", spec, (group, ranks), tensor,
                         spec)
    if group is None or len(ranks) == 1:
        return tensor.clone()
    from flinkml_tpu_torch.parallel.dispatch import record_collective_dispatch

    dist = _dist()
    order = _group_order(group, ranks)
    device = tensor.device
    send = tensor[order].contiguous()
    if _staged(group, send):
        HOST_STAGED["all_to_all"] += 1
        send = send.cpu()
    recv = torch.empty_like(send)
    record_collective_dispatch("all_to_all", ranks, ("all_to_all",))
    dist.all_to_all_single(recv, send, group=group)
    out = torch.empty_like(recv)
    out[order] = recv
    return out.to(device)


def ppermute(group, ranks, tensors, shift: int = 1) -> list:
    """Each tensor sent ``shift`` places on along ``ranks`` (mesh order,
    cyclic) and replaced by the one from ``shift`` places before: the
    ring ``ppermute``. One ``batch_isend_irecv`` carries every tensor
    (one tag each), so no rank waits on a send its peer has not posted a
    receive for. Returns new tensors."""
    tensors = list(tensors)
    if _gate.CAPTURE.on:
        spec = spec_of(ranks)
        return list(_captured("ppermute", spec, (group, ranks), tensors,
                              spec, int(shift)))
    if group is None or len(ranks) == 1:
        return [t.clone() for t in tensors]
    from flinkml_tpu_torch.parallel.dispatch import record_collective_dispatch

    dist = _dist()
    p = len(ranks)
    me = list(ranks).index(dist.get_rank())
    dst, src = ranks[(me + shift) % p], ranks[(me - shift) % p]
    staged = any(_staged(group, t) for t in tensors)
    sends = [t.contiguous().cpu() if staged else t.contiguous()
             for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    if staged:
        HOST_STAGED["ppermute"] += 1
    ops = [dist.P2POp(dist.isend, s, dst, group, tag)
           for tag, s in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, r, src, group, tag)
            for tag, r in enumerate(recvs)]
    record_collective_dispatch("ppermute", ranks, ("ppermute",))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]
