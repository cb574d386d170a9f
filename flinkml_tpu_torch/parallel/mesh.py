"""Device mesh and placement helpers: the parallelism substrate.

The port's counterpart of ``flinkml_tpu.parallel.mesh``. The JAX package
drives a named ``jax.sharding.Mesh`` of local devices from one controller;
here every rank is one process with one device, and a :class:`DeviceMesh`
names the ranks of the default ``torch.distributed`` group with the JAX
axis names (``data``, ``fsdp``, ``tp``), wrapping
``torch.distributed.device_mesh.DeviceMesh`` (one process group per axis).

The SPMD convention is the JAX package's: every rank passes the same
global host table, and :meth:`DeviceMesh.shard_batch` keeps this rank's
contiguous block of rows (the block ``NamedSharding`` gives device r), so
a device tensor in the port is always this rank's block of a data-sharded
array or a replicated value. :meth:`DeviceMesh.to_host` all-gathers the
blocks. Without a process group the mesh is a world-1 mesh on the compute
device and issues no collective.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class DeviceMesh:
    """The ranks of the default process group as a named mesh, plus this
    rank's device and the placement conveniences.

    ``axis_shapes`` defaults to ``{"data": world size}``; ``devices`` are
    the ranks the mesh spans, in mesh order (default: every rank), each
    standing for that rank's one device. A mesh needing more ranks than
    there are raises ``ValueError``, as the JAX mesh does for devices.
    This rank's device is the port's compute device (``cuda``: the current
    card). With a process group every rank must build the mesh, in the
    same order (it creates one process group per axis).
    """

    DATA_AXIS = "data"
    #: Model/optimizer state sharding axis (FSDP) and tensor-parallel axis,
    #: the named axes sharding plans key to (ROADMAP.md Queue 1 item 7b).
    FSDP_AXIS = "fsdp"
    TP_AXIS = "tp"

    def __init__(self, axis_shapes: Optional[Dict[str, int]] = None,
                 devices: Optional[Sequence[int]] = None):
        import torch.distributed as dist

        from flinkml_tpu_torch.device import default_device

        grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        ranks = list(range(world)) if devices is None else [int(r) for r in devices]
        if axis_shapes is None:
            axis_shapes = {self.DATA_AXIS: len(ranks)}
        names = tuple(axis_shapes.keys())
        shape = tuple(int(s) for s in axis_shapes.values())
        n = int(np.prod(shape))
        if n > len(ranks):
            raise ValueError(
                f"mesh shape {dict(axis_shapes)} needs {n} devices, "
                f"only {len(ranks)} available"
            )
        self._names = names
        self._ranks = np.asarray(ranks[:n], dtype=np.int64).reshape(shape)
        device = default_device()
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.rank = dist.get_rank() if grouped else 0
        self.mesh = None
        if grouped:
            from torch.distributed.device_mesh import DeviceMesh as _TorchMesh

            self.mesh = _TorchMesh(device.type, torch.as_tensor(self._ranks),
                                   mesh_dim_names=names)
        self._product_groups: Dict[Tuple[str, ...], Any] = {}
        where = np.argwhere(self._ranks == self.rank)
        self.coordinate: Optional[Tuple[int, ...]] = (
            tuple(int(i) for i in where[0]) if where.size else None)

    # -- basic properties --------------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self._names

    @property
    def num_devices(self) -> int:
        return int(self._ranks.size)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self._names, self._ranks.shape))

    @property
    def device_ids(self) -> Tuple[int, ...]:
        """The ranks of the mesh in mesh order (one device each)."""
        return tuple(int(r) for r in self._ranks.reshape(-1))

    def axis_size(self, name: str = DATA_AXIS) -> int:
        return self.shape[name]

    def axis_index(self, name: str = DATA_AXIS) -> int:
        """This rank's coordinate along ``name``."""
        if self.coordinate is None:
            raise ValueError(
                f"rank {self.rank} is not in this mesh (ranks "
                f"{list(self.device_ids)})"
            )
        return self.coordinate[self._names.index(name)]

    def group(self, name: str = DATA_AXIS):
        """The process group of this rank's line along ``name``; None
        without a process group (the world-1 mesh issues no collective)."""
        if self.mesh is None:
            return None
        self.axis_index(name)  # raises for a rank outside the mesh
        return self.mesh.get_group(name)

    def axis_ranks(self, name: str = DATA_AXIS) -> Tuple[int, ...]:
        """The global ranks along ``name`` through this rank, in mesh
        order."""
        coord = list(self.coordinate or (0,) * len(self._names))
        axis = self._names.index(name)
        coord[axis] = slice(None)
        return tuple(int(r) for r in self._ranks[tuple(coord)])

    def group_over(self, axes: Sequence[str]):
        """``(group, ranks)``: the process group of this rank's slice of
        the mesh over ``axes`` (every rank that shares this rank's
        coordinates on the other axes: the product of ``axes``), and that
        slice's ranks in row-major order over ``axes``, the order
        ``NamedSharding`` lays a dim sharded over them. ``(None,
        (rank,))`` without a process group or for no axes. One axis is
        its own group; a product of several makes one group per slice the
        first time it is asked for, a collective call: every rank of the
        process group asks for the same products in the same order (the
        SPMD rule)."""
        axes = tuple(axes)
        if self.mesh is None or not axes:
            return None, (self.rank,)
        if len(axes) == 1:
            return self.group(axes[0]), self.axis_ranks(axes[0])
        cached = self._product_groups.get(axes)
        if cached is None:
            import torch.distributed as dist

            idx = [self._names.index(a) for a in axes]
            others = [i for i in range(len(self._names)) if i not in idx]
            width = int(np.prod([self._ranks.shape[i] for i in idx]))
            rows = self._ranks.transpose(others + idx).reshape(-1, width)
            cached = (None, (self.rank,))
            for row in rows:
                ranks = tuple(int(r) for r in row)
                group = dist.new_group(list(ranks))
                if self.rank in ranks:
                    cached = (group, ranks)
            self._product_groups[axes] = cached
        return cached

    def coordinate_of(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (0 for no axes): the
        block of a dim sharded over their product that it holds."""
        index = 0
        for a in axes:
            index = index * self.axis_size(a) + (
                self.axis_index(a) if self.coordinate is not None else 0)
        return index

    # -- plan-shaped construction ------------------------------------------
    @classmethod
    def for_plan(cls, plan, devices: Optional[Sequence[int]] = None,
                 tp_size: Optional[int] = None) -> "DeviceMesh":
        """A mesh shaped for a sharding plan's required axes
        (``plan.required_axes()``) over the given ranks (default: all):

        - only ``data`` (or no axes): ``{"data": n}``;
        - ``fsdp`` without ``tp``: ``{"data": 1, "fsdp": n}``;
        - ``fsdp`` + ``tp``: ``{"data": 1, "fsdp": n // tp, "tp": tp}``,
          ``tp_size`` defaulting to 2 (it must divide n).
        """
        import torch.distributed as dist

        if devices is None:
            grouped = dist.is_available() and dist.is_initialized()
            devices = list(range(dist.get_world_size() if grouped else 1))
        n = len(devices)
        axes = set(plan.required_axes())
        if cls.TP_AXIS in axes and cls.FSDP_AXIS in axes:
            tp = int(tp_size) if tp_size is not None else min(2, n)
            if n % tp != 0:
                raise ValueError(f"tp_size {tp} does not divide {n} devices")
            return cls({cls.DATA_AXIS: 1, cls.FSDP_AXIS: n // tp,
                        cls.TP_AXIS: tp}, devices=devices)
        if cls.FSDP_AXIS in axes:
            return cls({cls.DATA_AXIS: 1, cls.FSDP_AXIS: n}, devices=devices)
        return cls({cls.DATA_AXIS: n}, devices=devices)

    # -- elastic re-shaping ------------------------------------------------
    def shrink(self, new_size: int, axis: str = DATA_AXIS) -> "DeviceMesh":
        """A new mesh over the leading ``new_size`` slots of ``axis``
        (survivors keep their relative order, as
        :func:`~flinkml_tpu_torch.parallel.distributed.compact_rank`
        renumbers them). Every rank of the group builds it; a rank left
        out holds a mesh it is not a member of."""
        new_size = int(new_size)
        old = self.axis_size(axis)
        if not (1 <= new_size <= old):
            raise ValueError(
                f"cannot shrink axis {axis!r} from {old} to {new_size}"
            )
        shapes = self.shape
        shapes[axis] = new_size
        idx = tuple(slice(0, new_size) if name == axis else slice(None)
                    for name in self._names)
        return DeviceMesh(shapes, devices=list(self._ranks[idx].reshape(-1)))

    # -- placement ---------------------------------------------------------
    def shard_batch(self, array) -> torch.Tensor:
        """This rank's contiguous block of a global host batch, on the
        mesh's device: rows ``[i·m, (i+1)·m)`` for data index ``i`` of
        ``P`` and ``m = n / P``. The leading dimension must divide by the
        data-axis size (pad with :func:`pad_to_multiple` first), the
        reference's ``globalBatchSize / parallelism`` contract."""
        p = self.axis_size(self.DATA_AXIS)
        n = array.shape[0]
        if n % p != 0:
            raise ValueError(
                f"batch dimension {n} not divisible by data-axis size {p}; "
                "pad with pad_to_multiple first"
            )
        m = n // p
        i = self.axis_index(self.DATA_AXIS) if self.mesh is not None else 0
        block = array[i * m:(i + 1) * m]
        if torch.is_tensor(block):
            return block.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(block)).to(self.device)

    def replicate(self, tree):
        """Every leaf of a tree of arrays as a tensor on this rank's device
        (each rank passes the same value: the broadcast model)."""
        def put(leaf):
            if torch.is_tensor(leaf):
                return leaf.to(self.device)
            return torch.as_tensor(np.asarray(leaf)).to(self.device)

        return tree_map(put, tree)

    def to_host(self, arr) -> np.ndarray:
        """The global array of a data-sharded result on the host: this
        rank's block all-gathered over the data axis, in data order. A
        COLLECTIVE when the axis has more than one rank: every rank calls
        it, in the same order (the SPMD transform convention: every rank
        scores the same global table and receives the whole result)."""
        group = self.group(self.DATA_AXIS) if self.mesh is not None else None
        if group is None or self.axis_size(self.DATA_AXIS) == 1:
            return torch.as_tensor(arr).cpu().numpy()
        from flinkml_tpu_torch.parallel.collectives import gather_blocks

        return gather_blocks(self, arr).cpu().numpy()

    def local_rows(self, arr) -> np.ndarray:
        """THIS rank's block of a data-sharded result on the host (the
        inverse of :meth:`global_batch`): no collective."""
        return torch.as_tensor(arr).cpu().numpy()

    def global_batch(self, local_rows) -> torch.Tensor:
        """The data-sharded batch whose block on this rank is
        ``local_rows`` (each rank passes only its own rows, e.g. its
        :func:`~flinkml_tpu_torch.parallel.process_slice` of the dataset;
        ranks that share a data index pass the same rows). Without a
        process group this is :meth:`shard_batch`."""
        if self.mesh is None:
            return self.shard_batch(local_rows)
        if torch.is_tensor(local_rows):
            return local_rows.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(local_rows)).to(self.device)

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, ranks={list(self.device_ids)}, "
                f"device={self.device})")


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Zero-pad ``array`` along ``axis`` to a multiple; returns (padded, n_valid).

    Algorithms carry ``n_valid`` (or a weight column) so padded rows never
    contribute to sums.
    """
    n = array.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array, n
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(array, pad_width), n


def check_mesh(mesh) -> None:
    """``TypeError`` unless ``mesh`` is None or a :class:`DeviceMesh`."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh must be a flinkml_tpu_torch.parallel.DeviceMesh (or None "
            f"for one device), got {type(mesh).__name__}"
        )
