"""EmbeddingTable — a row-sharded ``[vocab, dim]`` parameter as a value.

The port's counterpart of ``flinkml_tpu.embeddings.table``: one object that
owns the four decisions every large table forces:

- **layout** — rows shard over the plan's row axes (the ``EMBEDDING``
  family's ``(fsdp, tp)`` product; any preset that keeps rows whole is
  legal). Plan resolution: an explicit plan > :func:`~flinkml_tpu_torch.
  sharding.plan.infer_plan` under ``hbm_budget_bytes`` > ``REPLICATED``.
  The FML5xx pass (:func:`~flinkml_tpu_torch.sharding.apply.
  validate_plan`) runs over the PADDED shape with the optimizer slots
  counted, before any placement.
- **access** — :meth:`lookup` (replicated ids, the serving path: a masked
  gather and one batch-sized ``all_reduce``, bitwise stable at every
  world size) and :meth:`scatter_add` (the training path: the
  strategy-dispatched exchange of :mod:`.exchange`).
- **optimizer state** — ``optimizer_slots`` same-shaped companions named
  ``<table>/embedding_slot<i>``, sharded like the table.
- **checkpointing** — :meth:`save` records the UNPADDED global arrays
  with plan-derived ``sharded:0`` layout tags, so a snapshot written at
  one world size restores at another (:meth:`restore` re-pads and
  re-places).

Placement follows the port's SPMD convention: every rank passes the same
global host array, and rank ``r`` of the row group keeps rows ``[r·
shard_rows, (r+1)·shard_rows)`` of the zero-padded table (and of each
slot) on its device. :meth:`to_host`, :meth:`state_dict` and :meth:`save`
of a sharded table all-gather the blocks: every rank of the group calls
them, in the same order.

Naming contract: the table's parameter is ``<name>/embedding`` — the
``*embedding*`` family pattern routes it to the row-sharded rule of the
``EMBEDDING`` preset and to the embedding-aware branches of ``infer_plan``
and FML503.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.embeddings import exchange
from flinkml_tpu_torch.parallel import collectives


def _row_entry(plan, param_name: str):
    """The plan's dim-0 spec entry for the table (None/str/tuple), after
    refusing any layout that splits the row payload."""
    from flinkml_tpu_torch.sharding.plan import entry_axes

    spec = plan.spec_for(param_name, ndim=2)
    for dim_idx, entry in enumerate(spec[1:], start=1):
        if entry_axes(entry):
            raise ValueError(
                f"plan {plan.name!r} shards dim {dim_idx} of embedding "
                f"table {param_name!r} over {entry_axes(entry)}: the "
                "sparse lookup/exchange primitives move WHOLE rows "
                "between shards — shard dim 0 only (the EMBEDDING "
                "preset's layout)"
            )
    return spec[0] if spec else None


def _entry_axes_tuple(entry) -> Tuple[str, ...]:
    from flinkml_tpu_torch.sharding.plan import entry_axes

    return entry_axes(entry)


def _ids_tensor(ids, device) -> torch.Tensor:
    if torch.is_tensor(ids):
        return ids.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(ids, np.int64)).to(device)


class EmbeddingTable:
    """See the module docstring. ``rows=None`` initializes to zeros (or
    ``scale``-scaled normal rows when ``scale`` is given); a host array
    of shape ``[vocab, dim]`` seeds the table explicitly."""

    def __init__(
        self,
        name: str,
        vocab: int,
        dim: int,
        *,
        mesh=None,
        plan=None,
        dtype=np.float32,
        optimizer_slots: int = 0,
        hbm_budget_bytes: Optional[int] = None,
        rows: Optional[np.ndarray] = None,
        slots: Optional[Sequence[np.ndarray]] = None,
        seed: int = 0,
        scale: Optional[float] = None,
    ):
        from flinkml_tpu_torch.parallel import DeviceMesh
        from flinkml_tpu_torch.sharding.apply import validate_plan
        from flinkml_tpu_torch.sharding.plan import (
            EMBEDDING,
            REPLICATED,
            infer_plan,
        )

        if vocab < 1 or dim < 1:
            raise ValueError(f"need vocab >= 1 and dim >= 1, got "
                             f"({vocab}, {dim})")
        self.name = str(name)
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.optimizer_slots = int(optimizer_slots)
        self.param_name = f"{self.name}/embedding"

        if plan is None:
            if hbm_budget_bytes is not None:
                # The mesh (given, or the EMBEDDING-shaped mesh over every
                # rank) decides which preset fits: an over-budget vocab
                # lands on the embedding plan, a small one stays
                # replicated/batch-parallel.
                probe_mesh = mesh or DeviceMesh.for_plan(EMBEDDING)
                plan = infer_plan(
                    probe_mesh, {self.param_name: (self.vocab, self.dim)},
                    hbm_budget_bytes, dtype_bytes=self.dtype.itemsize,
                    optimizer_slots=self.optimizer_slots,
                )
                mesh = mesh or probe_mesh
            else:
                plan = REPLICATED
        self.plan = plan
        self.mesh = mesh or DeviceMesh.for_plan(plan)
        self.row_entry = _row_entry(plan, self.param_name)

        axis_sizes = self.mesh.shape
        self.row_axes = tuple(a for a in _entry_axes_tuple(self.row_entry)
                              if a in axis_sizes)
        self.n_shards = 1
        for axis in self.row_axes:
            self.n_shards *= int(axis_sizes[axis])
        self.shard_rows = exchange.shard_rows_for(self.vocab, self.n_shards)
        self.padded_vocab = self.shard_rows * self.n_shards
        self.axes = (exchange.ShardAxes.of(self.mesh, self.row_axes)
                     if self.sharded else exchange.ShardAxes(None, (0,), 0))

        # FML5xx, pre-placement, over the PADDED shape (what is actually
        # laid out) with the optimizer slots counted.
        validate_plan(
            plan, self.mesh,
            param_shapes={self.param_name: (self.padded_vocab, self.dim)},
            hbm_budget_bytes=hbm_budget_bytes,
            dtype_bytes=self.dtype.itemsize,
            optimizer_slots=self.optimizer_slots,
        )

        if rows is None:
            if scale is None:
                host = np.zeros((self.vocab, self.dim), self.dtype)
            else:
                rng = np.random.default_rng(seed)
                host = (rng.standard_normal((self.vocab, self.dim))
                        * float(scale)).astype(self.dtype)
        else:
            host = np.asarray(rows, self.dtype)
            if host.shape != (self.vocab, self.dim):
                raise ValueError(
                    f"rows shape {host.shape} != ({self.vocab}, {self.dim})"
                )
        self.rows = self._place(host)
        if slots is not None:
            if len(slots) != self.optimizer_slots:
                raise ValueError(
                    f"{len(slots)} slot arrays != optimizer_slots="
                    f"{self.optimizer_slots}"
                )
            self.slots = tuple(self._place(np.asarray(s, self.dtype))
                               for s in slots)
        else:
            self.slots = tuple(
                self._place(np.zeros((self.vocab, self.dim), self.dtype))
                for _ in range(self.optimizer_slots)
            )

    # -- placement ---------------------------------------------------------
    @property
    def sharded(self) -> bool:
        return self.n_shards > 1

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _place(self, host: np.ndarray) -> torch.Tensor:
        """Pad the host ``[vocab, dim]`` array to the shard grid and keep
        this rank's block on its device (the whole table unsharded)."""
        pad = self.padded_vocab - host.shape[0]
        if pad:
            host = np.concatenate(
                [host, np.zeros((pad, host.shape[1]), host.dtype)]
            )
        lo = self.axes.index * self.shard_rows
        block = np.ascontiguousarray(host[lo:lo + self.shard_rows])
        return torch.from_numpy(block).to(self.device)

    def _gather(self, block: torch.Tensor) -> torch.Tensor:
        """The padded global table from every shard's block (a collective
        over the row group when sharded)."""
        if not self.sharded:
            return block
        return collectives.group_all_gather(self.axes.group, self.axes.ranks,
                                            block)

    # -- access ------------------------------------------------------------
    def lookup(self, ids) -> torch.Tensor:
        """Rows for (replicated) global ``ids``, on this rank's device —
        exact, and bitwise identical at every world size (see
        :func:`~flinkml_tpu_torch.embeddings.exchange.psum_lookup`)."""
        ids = _ids_tensor(ids, self.device)
        if not self.sharded:
            return self.rows[ids]
        return exchange.psum_lookup(self.rows, ids, axes=self.axes,
                                    shard_rows=self.shard_rows)

    def scatter_add(self, ids, delta, strategy: Optional[str] = None):
        """``rows[ids] += delta`` through the strategy-dispatched
        exchange: the ``[m]`` id / ``[m, dim]`` delta batch (the same on
        every rank) is split over the shards (each routes its slice), so
        traffic is batch-sized. Pads with id-0/delta-0 no-op rows to the
        shard grid. Returns self."""
        if strategy is not None and strategy not in exchange.STRATEGIES:
            # Validate BEFORE the unsharded early-return: a typo'd
            # strategy developed against a small table must fail here.
            raise ValueError(
                f"unknown exchange strategy {strategy!r}; expected one "
                f"of {exchange.STRATEGIES}"
            )
        ids = np.asarray(ids, np.int32).reshape(-1)
        delta = np.asarray(delta, self.dtype)
        if ids.shape[0] != delta.shape[0]:
            raise ValueError(f"{ids.shape[0]} ids != {delta.shape[0]} rows")
        if not self.sharded:
            self.rows = self.rows.index_add(
                0, _ids_tensor(ids, self.device),
                torch.from_numpy(np.ascontiguousarray(delta)).to(self.device))
            return self
        if strategy is None:
            strategy = exchange.resolve_exchange(self.vocab, self.n_shards)
            if strategy == "dense_psum":  # sharded table: exchange anyway
                strategy = exchange.exchange_strategy()
        pad = (-ids.shape[0]) % self.n_shards
        if pad:
            ids = np.concatenate([ids, np.zeros(pad, np.int32)])
            delta = np.concatenate(
                [delta, np.zeros((pad, self.dim), self.dtype)]
            )
        m = ids.shape[0] // self.n_shards
        lo = self.axes.index * m
        ids_l = torch.from_numpy(ids[lo:lo + m]).to(self.device)
        delta_l = torch.from_numpy(
            np.ascontiguousarray(delta[lo:lo + m])).to(self.device)
        (self.rows,) = exchange.scatter_add(
            (self.rows,), ((0, ids_l, delta_l),), axes=self.axes,
            n_shards=self.n_shards, shard_rows=self.shard_rows,
            strategy=strategy,
        )
        return self

    def to_host(self) -> np.ndarray:
        """The UNPADDED global ``[vocab, dim]`` host array."""
        return self._gather(self.rows).cpu().numpy()[: self.vocab]

    # -- incremental row patch (the features delta-publish path) -----------
    def _patched_rows(self, ids, values) -> torch.Tensor:
        ids = np.asarray(ids, np.int32).reshape(-1)
        values = np.asarray(values, self.dtype)
        if values.shape != (ids.shape[0], self.dim):
            raise ValueError(
                f"row values shape {values.shape} != "
                f"({ids.shape[0]}, {self.dim})"
            )
        if ids.shape[0] != np.unique(ids).shape[0]:
            raise ValueError(
                f"row delta for table {self.name!r} has duplicate ids — "
                "SET semantics require one value per row"
            )
        if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= self.vocab):
            raise ValueError(
                f"row delta ids out of range [0, {self.vocab}) for table "
                f"{self.name!r}"
            )
        if not ids.size:
            return self.rows
        ids_t = _ids_tensor(ids, self.device)
        vals_t = torch.from_numpy(np.ascontiguousarray(values)).to(self.device)
        # A SET (not an add of a difference) into a copy: the patched table
        # is bitwise a fresh placement of the patched host array, and the
        # old tensor is untouched. A sharded table sets the rows it owns.
        out = self.rows.clone()
        if not self.sharded:
            out[ids_t] = vals_t
            return out
        mask, safe = exchange.owned(ids_t, self.axes, self.shard_rows)
        out[safe[mask]] = vals_t[mask]
        return out

    def apply_row_delta(self, ids, values) -> "EmbeddingTable":
        """``rows[ids] = values`` (exact SET, unique ids, each row patched
        on its owning shard). Rebinds ``self.rows`` and returns self — the
        TRAINER-side form. Serving replicas use
        :meth:`clone_with_row_delta` so a model a batch holds keeps its
        rows."""
        self.rows = self._patched_rows(ids, values)
        return self

    def clone_with_row_delta(self, ids, values) -> "EmbeddingTable":
        """Functional patch: a shallow clone whose ``rows`` is the patched
        tensor; slots and layout are shared with self, and the old table —
        and any in-flight batch holding it — serves exactly its own
        version."""
        patched = self._patched_rows(ids, values)
        clone = copy.copy(self)
        clone.rows = patched
        return clone

    # -- footprint ---------------------------------------------------------
    def per_device_bytes(self) -> int:
        """Per-device bytes of the table plus its optimizer slots under
        the current layout — the number FML503 compares to the budget."""
        return (self.shard_rows * self.dim * self.dtype.itemsize
                * (1 + self.optimizer_slots))

    def exchange_bytes_per_step(self, batch: int,
                                strategy: str = "ring") -> int:
        """Analytic per-step exchange traffic for a ``batch``-id gather +
        scatter round (all shards, both directions) — linear in
        ``batch``, independent of vocab."""
        if not self.sharded or strategy == "dense_psum":
            # The dense placement's psum moves the whole table.
            return 2 * self.padded_vocab * self.dim * self.dtype.itemsize
        row_bytes = self.dim * self.dtype.itemsize
        id_bytes = 4
        return 2 * self.n_shards * int(batch) * (row_bytes + id_bytes)

    # -- checkpointing -----------------------------------------------------
    def _slot_name(self, i: int) -> str:
        return f"{self.param_name}_slot{i}"

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Host state (unpadded global arrays) keyed by plan-family names
        — what :meth:`save` records and :meth:`restore` expects."""
        out = {self.param_name: self.to_host()}
        for i, slot in enumerate(self.slots):
            out[self._slot_name(i)] = (
                self._gather(slot).cpu().numpy()[: self.vocab])
        return out

    def save(self, manager, epoch: int) -> str:
        """Snapshot through ``CheckpointManager.save(..., plan=...)`` —
        layout tags derive from the plan (``sharded:0`` for the table and
        every slot). On several ranks the first rank writes and every rank
        agrees on the commit."""
        from flinkml_tpu_torch.iteration.checkpoint import save_agreed

        save_agreed(manager, self.state_dict(), epoch, plan=self.plan)
        return os.path.join(manager.directory, f"ckpt-{epoch}")

    @classmethod
    def restore(
        cls,
        manager,
        name: str,
        vocab: int,
        dim: int,
        *,
        mesh=None,
        plan=None,
        dtype=np.float32,
        optimizer_slots: int = 0,
        hbm_budget_bytes: Optional[int] = None,
    ) -> Tuple["EmbeddingTable", int]:
        """Restore the newest snapshot onto a possibly DIFFERENT mesh /
        world size: the snapshot's global arrays re-pad and re-place for
        the new layout; the restored :meth:`to_host` is bit-equal to the
        saved one. Returns ``(table, epoch)``; raises if the manager holds
        no snapshot."""
        from flinkml_tpu_torch.iteration.stream_sync import (
            agreed_restore_latest,
        )

        like = {f"{name}/embedding": np.zeros((vocab, dim), np.dtype(dtype))}
        for i in range(optimizer_slots):
            like[f"{name}/embedding_slot{i}"] = np.zeros(
                (vocab, dim), np.dtype(dtype))
        restored = agreed_restore_latest(manager, like)
        if restored is None:
            raise ValueError(
                f"no checkpoint to restore embedding table {name!r} from "
                f"under {manager.directory}"
            )
        state, epoch = restored
        table = cls(
            name, vocab, dim, mesh=mesh, plan=plan, dtype=dtype,
            optimizer_slots=optimizer_slots,
            hbm_budget_bytes=hbm_budget_bytes,
            rows=state[f"{name}/embedding"],
            slots=[state[f"{name}/embedding_slot{i}"]
                   for i in range(optimizer_slots)],
        )
        return table, epoch
