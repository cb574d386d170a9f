"""Sparse lookup + gradient exchange over sharded embedding rows.

The port's counterpart of ``flinkml_tpu.embeddings.exchange``: shard-level
primitives, run on every rank of the table's row group, that move
**batch-sized row payloads** between the shards of a row-sharded
``[vocab, dim]`` table — never a vocab-sized dense array and never a host
gather. The JAX package calls them inside ``shard_map`` over the plan's
row axes; here ``axes`` is a :class:`ShardAxes` (the process group of
those axes, its ranks in mesh order and this rank's shard index), and the
named-axis collectives are :mod:`flinkml_tpu_torch.parallel.collectives`'
(under gloo, ``send``/``recv`` and ``all_to_all`` stage a CUDA payload
through host memory, as that module says).

Ownership contract (shared by every strategy): shard ``r`` owns global
rows ``[r·shard_rows, (r+1)·shard_rows)`` of the zero-padded table. A
gather sums per-shard contributions that are zero everywhere except the
one owning shard, so **lookups are exact** — bitwise identical across
strategies AND across world sizes. Scatter-adds differ between strategies
only in float32 summation order on duplicate ids.

Three strategies:

- ``ring`` — ids + row accumulators hop ``P`` times around the ring
  (``batch_isend_irecv``); every visited shard adds the rows it owns.
- ``all_to_all`` — ids are all-gathered to every shard. The gather sends
  each shard's masked contributions home through one ``all_to_all``; the
  scatter all-gathers the rows too and sums the ones this shard owns with
  the port's ``segment_sum`` kernel (:mod:`flinkml_tpu_torch.kernels.
  segsum`), the masked rows adding zeros into local row 0, as the JAX
  package has it.
- ``dense_psum`` — not an exchange: the below-threshold placement where
  the table stays replicated. :func:`resolve_exchange` routes small
  vocabs here.

Resolution precedence: ``FLINKML_TPU_EMBEDDING_EXCHANGE`` > the tuning
table's ``embedding_exchange`` for the current mesh
(:mod:`flinkml_tpu_torch.autotune`) > the static ``ring`` default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch

from flinkml_tpu_torch.parallel import collectives

#: The exchange strategies.
STRATEGIES = ("ring", "all_to_all", "dense_psum")

#: Explicit strategy override (highest precedence).
ENV_VAR = "FLINKML_TPU_EMBEDDING_EXCHANGE"

#: Vocab-size override for the dense-psum threshold (lowest vocab that
#: SHARDS). ``FLINKML_W2V_SHARD_VOCAB`` is honored as a back-compat alias
#: (0 forces sharding).
ENV_DENSE_VOCAB_VAR = "FLINKML_TPU_EMBEDDING_DENSE_VOCAB"

#: Below this vocab size a dense [vocab, dim] gradient psum per step beats
#: sparse collectives (the JAX package's Word2Vec measurement).
DENSE_VOCAB_DEFAULT = 1 << 18


def dense_vocab_threshold() -> int:
    """The vocab size at or below which tables stay replicated and
    gradients ride a dense psum (the ``dense_psum`` placement)."""
    for var in (ENV_DENSE_VOCAB_VAR, "FLINKML_W2V_SHARD_VOCAB"):
        raw = os.environ.get(var)
        if raw is not None:
            return int(raw)
    return DENSE_VOCAB_DEFAULT


def exchange_strategy() -> str:
    """The SHARDED exchange algorithm (``ring`` or ``all_to_all``): env
    var > the tuning table's ``embedding_exchange`` > static ``ring``. An
    explicit ``dense_psum`` is refused: it is a placement, not a sharded
    algorithm; a table whose measured winner is ``dense_psum`` (the
    below-threshold placement) quietly falls back to ``ring``."""
    raw = os.environ.get(ENV_VAR)
    if raw is not None:
        if raw not in STRATEGIES:
            raise ValueError(
                f"{ENV_VAR}={raw!r}: expected one of {STRATEGIES}"
            )
        if raw == "dense_psum":
            raise ValueError(
                f"{ENV_VAR}=dense_psum: dense_psum is the replicated "
                "PLACEMENT, not a sharded exchange algorithm — to force "
                f"the dense path, raise the vocab threshold instead "
                f"({ENV_DENSE_VOCAB_VAR}, or the FLINKML_W2V_SHARD_VOCAB "
                "alias); on an already-sharded table pick 'ring' or "
                "'all_to_all'"
            )
        return raw
    from flinkml_tpu_torch.autotune import tuned_default

    chosen = tuned_default("embedding_exchange", "ring",
                           allowed=STRATEGIES)
    return chosen if chosen in ("ring", "all_to_all") else "ring"


def resolve_exchange(vocab: int, n_shards: int) -> str:
    """The strategy for a ``vocab``-row table over ``n_shards`` shards:
    ``dense_psum`` when the table cannot shard or is at most the dense
    threshold, else :func:`exchange_strategy`."""
    if n_shards <= 1 or vocab <= dense_vocab_threshold():
        return "dense_psum"
    return exchange_strategy()


def shard_rows_for(vocab: int, n_shards: int) -> int:
    """Rows per shard (ceil) — shard ``r`` owns
    ``[r·shard_rows, (r+1)·shard_rows)`` of the zero-padded table."""
    return -(-int(vocab) // int(n_shards))


@dataclasses.dataclass(frozen=True)
class ShardAxes:
    """The row axes of a sharded table as this rank sees them: their
    process group (None without one), its ranks in mesh order, and this
    rank's shard index (the flattened ``axis_index`` over the axes)."""

    group: Optional[object]
    ranks: Tuple[int, ...]
    index: int

    @classmethod
    def of(cls, mesh, axes: Sequence[str]) -> "ShardAxes":
        group, ranks = mesh.group_over(tuple(axes))
        return cls(group, tuple(ranks), mesh.coordinate_of(tuple(axes)))


# -- shard-level primitives (every rank of the row group calls them) --------


def owned(ids: torch.Tensor, axes: ShardAxes, shard_rows: int):
    """``(mask, safe local index)`` for the global ids THIS shard owns."""
    local_idx = ids.long() - axes.index * shard_rows
    mask = (local_idx >= 0) & (local_idx < shard_rows)
    return mask, torch.clamp(local_idx, 0, shard_rows - 1)


def _masked_rows(table: torch.Tensor, ids: torch.Tensor, axes: ShardAxes,
                 shard_rows: int) -> torch.Tensor:
    """This shard's rows for ``ids`` (``ids.shape + (dim,)``), zero where
    another shard owns the id."""
    mask, safe = owned(ids, axes, shard_rows)
    return torch.where(mask[..., None], table[safe],
                       table.new_zeros(()))


def ring_gather(pairs: Sequence, *, axes: ShardAxes, n_shards: int,
                shard_rows: int):
    """Rows of the row-sharded tables for each ``(table_shard, ids)`` in
    ``pairs`` — ONE ring loop carries every payload. ``ids`` may be
    ``[bs]`` or ``[bs, n]``; returns one ``ids.shape + (dim,)`` tensor
    per pair."""
    idss = [ids for _, ids in pairs]
    accs = [t.new_zeros(tuple(ids.shape) + (t.shape[1],))
            for (t, _), ids in zip(pairs, idss)]
    for _ in range(n_shards):
        accs = [acc + _masked_rows(table, ids, axes, shard_rows)
                for (table, _), ids, acc in zip(pairs, idss, accs)]
        moved = collectives.ppermute(axes.group, axes.ranks, idss + accs)
        idss, accs = moved[:len(pairs)], moved[len(pairs):]
    return tuple(accs)  # n_shards hops: payloads are back home, complete


def ring_scatter_add(tables: Sequence, triples: Sequence, *,
                     axes: ShardAxes, n_shards: int, shard_rows: int):
    """Scatter-add each ``(table_slot, ids, rows)`` in ``triples`` into
    ``tables`` (a tuple of row-sharded shards) via ONE ring loop for every
    payload; returns the updated tuple (new tensors)."""
    tables = [t.clone() for t in tables]
    idss = [ids for _, ids, _ in triples]
    rowss = [rows for _, _, rows in triples]
    for _ in range(n_shards):
        for (slot, _, _), ids, rows in zip(triples, idss, rowss):
            mask, safe = owned(ids, axes, shard_rows)
            add = torch.where(mask[..., None], rows, rows.new_zeros(()))
            tables[slot].index_add_(0, safe.reshape(-1),
                                    add.reshape(-1, rows.shape[-1]))
        moved = collectives.ppermute(axes.group, axes.ranks, idss + rowss)
        idss, rowss = moved[:len(triples)], moved[len(triples):]
    return tuple(tables)


def _flat_sizes(idss) -> Tuple[int, ...]:
    return tuple(int(ids.numel()) for ids in idss)


def a2a_gather(pairs: Sequence, *, axes: ShardAxes, n_shards: int,
               shard_rows: int):
    """The ``all_to_all`` gather: ids all-gathered to every shard, each
    shard contributes its masked rows for the FULL global id list, one
    ``all_to_all`` routes contributions home, and the sum over source
    shards (exactly one non-zero each) completes the rows — bitwise equal
    to :func:`ring_gather`. Every payload rides one collective round when
    the tables' dims match (mixed dims: a round per payload)."""
    dims = sorted({int(t.shape[1]) for t, _ in pairs})
    if len(dims) > 1:
        out = []
        for pair in pairs:
            out.extend(a2a_gather((pair,), axes=axes, n_shards=n_shards,
                                  shard_rows=shard_rows))
        return tuple(out)
    dim = dims[0]
    ms = _flat_sizes([ids for _, ids in pairs])
    total = sum(ms)
    flat = torch.cat([ids.reshape(-1) for _, ids in pairs])      # [M]
    idsg = collectives.group_all_gather(axes.group, axes.ranks, flat)
    per_src = idsg.reshape(n_shards, total)
    contribs = []
    offset = 0
    for (table, _), m in zip(pairs, ms):
        seg = per_src[:, offset:offset + m].reshape(-1)
        contribs.append(_masked_rows(table, seg, axes, shard_rows)
                        .reshape(n_shards, m, dim))
        offset += m
    back = collectives.group_all_to_all(
        axes.group, axes.ranks, torch.cat(contribs, dim=1))    # [P, M, dim]
    rows = torch.sum(back, dim=0)                               # [M, dim]
    out = []
    offset = 0
    for (_, ids), m in zip(pairs, ms):
        out.append(rows[offset:offset + m].reshape(tuple(ids.shape) + (dim,)))
        offset += m
    return tuple(out)


def a2a_scatter_add(tables: Sequence, triples: Sequence, *,
                    axes: ShardAxes, n_shards: int, shard_rows: int):
    """The ``all_to_all``-family scatter: every shard all-gathers the
    (ids, rows) payloads and sums the rows IT owns into its shard with
    the ``segment_sum`` kernel. Masked (non-owned) rows add zeros into
    local row 0 — the ELL no-op-add convention. All payloads ride ONE id
    and ONE row ``all_gather`` when their dims match; the per-slot sums
    stay separate."""
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    dims = sorted({int(rows.shape[-1]) for _, _, rows in triples})
    if len(dims) > 1:
        for triple in triples:
            tables = a2a_scatter_add(tables, (triple,), axes=axes,
                                     n_shards=n_shards,
                                     shard_rows=shard_rows)
        return tuple(tables)
    dim = dims[0]
    tables = list(tables)
    ms = _flat_sizes([ids for _, ids, _ in triples])
    total = sum(ms)
    flat_ids = torch.cat([ids.reshape(-1) for _, ids, _ in triples])
    flat_rows = torch.cat([rows.reshape(-1, dim) for _, _, rows in triples])
    idsg = collectives.group_all_gather(axes.group, axes.ranks, flat_ids)
    rowsg = collectives.group_all_gather(axes.group, axes.ranks, flat_rows)
    per_src_ids = idsg.reshape(n_shards, total)
    per_src_rows = rowsg.reshape(n_shards, total, dim)
    offset = 0
    for (slot, _, _), m in zip(triples, ms):
        seg_ids = per_src_ids[:, offset:offset + m].reshape(-1)
        seg_rows = per_src_rows[:, offset:offset + m].reshape(-1, dim)
        mask, safe = owned(seg_ids, axes, shard_rows)
        tables[slot] = tables[slot] + segment_sum(
            torch.where(mask[:, None], seg_rows, seg_rows.new_zeros(())),
            torch.where(mask, safe, 0).to(torch.int32),
            shard_rows,
        )
        offset += m
    return tuple(tables)


def gather(pairs: Sequence, *, axes: ShardAxes, n_shards: int,
           shard_rows: int, strategy: str = "ring"):
    """Strategy-dispatched sparse lookup (see the module docstring)."""
    if strategy == "ring":
        return ring_gather(pairs, axes=axes, n_shards=n_shards,
                           shard_rows=shard_rows)
    if strategy == "all_to_all":
        return a2a_gather(pairs, axes=axes, n_shards=n_shards,
                          shard_rows=shard_rows)
    raise ValueError(
        f"unknown sharded exchange strategy {strategy!r} (dense_psum is a "
        f"placement, not an exchange; expected 'ring' or 'all_to_all')"
    )


def scatter_add(tables: Sequence, triples: Sequence, *, axes: ShardAxes,
                n_shards: int, shard_rows: int, strategy: str = "ring"):
    """Strategy-dispatched sparse gradient exchange (module docstring)."""
    if strategy == "ring":
        return ring_scatter_add(tables, triples, axes=axes,
                                n_shards=n_shards, shard_rows=shard_rows)
    if strategy == "all_to_all":
        return a2a_scatter_add(tables, triples, axes=axes,
                               n_shards=n_shards, shard_rows=shard_rows)
    raise ValueError(
        f"unknown sharded exchange strategy {strategy!r} (dense_psum is a "
        f"placement, not an exchange; expected 'ring' or 'all_to_all')"
    )


def psum_lookup(table_shard: torch.Tensor, ids: torch.Tensor, *,
                axes: ShardAxes, shard_rows: int) -> torch.Tensor:
    """Replicated-ids lookup (the SERVING path): every shard gathers its
    masked contribution for the same global id list and one batch-sized
    ``all_reduce`` completes the rows. Exactly one shard contributes per
    id, so the result is bitwise identical at every world size."""
    contrib = _masked_rows(table_shard, ids, axes, shard_rows)
    return collectives.group_all_reduce(axes.group, axes.ranks, contrib)
