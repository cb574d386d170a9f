"""The Dataset chain: source → transforms → shuffle → prefetch-to-device.

The port's counterpart of ``flinkml_tpu.data.dataset``. The reference
hands every trainer a uniform, replayable, backpressured record feed
through its DataStream layer; this class is that feed: a declarative
chain over a sharded :class:`~flinkml_tpu_torch.data.source.Source`,
composable :mod:`~flinkml_tpu_torch.data.ops` transforms, and an
optional :class:`~flinkml_tpu_torch.data.prefetch.DevicePrefetcher`
tail. A Dataset is an iterable of :class:`~flinkml_tpu_torch.table.Table`
batches, so it drops in anywhere a batch iterable is accepted —
``fit_stream`` of the online trainer, the streamed ``fit`` of the linear
family, ``iterate`` — and the iteration runtime additionally recognizes
it to checkpoint and restore its :class:`~flinkml_tpu_torch.data.state
.Cursor`.

Datasets are immutable: every combinator returns a new chain sharing
the source. Iteration state lives entirely in the
:class:`DatasetIterator`, so concurrent iterations never interfere.

Resume model: every stage is deterministic, so position ``k`` ⇒ "the
batch sequence's k-th element". ``iterate(cursor)`` restores by
fast-forwarding — pushed down to the source in O(1)/O(parse) when the
chain is skip-transparent (no cardinality-changing op), or by replaying
the chain and dropping the consumed prefix otherwise (shuffle included:
the seeded buffer regenerates the identical order). Either way the
resumed consumer sees the exact uninterrupted sequence.

Every source batch read passes the ``data.read`` fault seam
(:mod:`flinkml_tpu_torch.faults`) before any transform touches it.
``hash_column`` comes with ``features/hashing.py``, ROADMAP.md Queue 1
item 9.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from flinkml_tpu_torch.data.ops import (
    FilterOp,
    HashOp,
    MapOp,
    Op,
    RebatchOp,
    ShuffleOp,
    WindowOp,
)
from flinkml_tpu_torch.data.source import (
    ArraySource,
    CSVSource,
    LibSVMSource,
    Source,
    SyntheticSource,
)
from flinkml_tpu_torch.data.state import (
    Cursor,
    CursorShardMismatchError,
    rng_state_dict,
)
from flinkml_tpu_torch.table import Table

_log = logging.getLogger(__name__)


class Dataset:
    """An immutable source → ops → prefetch chain of Table batches."""

    def __init__(self, source: Source, ops: Sequence[Op] = (),
                 prefetch_spec: Optional[dict] = None):
        if not isinstance(source, Source):
            raise TypeError(
                f"Dataset requires a data.Source head, got {type(source)!r}"
            )
        self._source = source
        self._ops: Tuple[Op, ...] = tuple(ops)
        self._prefetch = prefetch_spec

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_source(source: Source) -> "Dataset":
        return Dataset(source)

    @staticmethod
    def from_arrays(data, batch_size: int, shard=None, mesh=None) -> "Dataset":
        """In-memory Table / column-dict source (see :class:`ArraySource`)."""
        return Dataset(ArraySource(data, batch_size, shard=shard, mesh=mesh))

    @staticmethod
    def from_csv(pattern, batch_size: int, delimiter: str = ",",
                 header="auto", shard=None, mesh=None) -> "Dataset":
        """Numeric-CSV file glob source (see :class:`CSVSource`)."""
        return Dataset(CSVSource(pattern, batch_size, delimiter=delimiter,
                                 header=header, shard=shard, mesh=mesh))

    @staticmethod
    def from_libsvm(pattern, batch_size: int, n_features: int,
                    shard=None, mesh=None, **kw) -> "Dataset":
        """LibSVM file glob source (see :class:`LibSVMSource`)."""
        return Dataset(LibSVMSource(pattern, batch_size, n_features,
                                    shard=shard, mesh=mesh, **kw))

    @staticmethod
    def synthetic(make_batch: Callable[[int, np.random.Generator], Table],
                  num_batches: int, seed: int = 0, shard=None,
                  mesh=None) -> "Dataset":
        """Seeded generator source (see :class:`SyntheticSource`)."""
        return Dataset(SyntheticSource(make_batch, num_batches, seed=seed,
                                       shard=shard, mesh=mesh))

    # -- combinators --------------------------------------------------------
    def _with_op(self, op: Op) -> "Dataset":
        if self._prefetch is not None:
            raise ValueError(
                "prefetch() must be the LAST stage of a Dataset chain "
                "(its output lives on device; host transforms cannot "
                "follow it)"
            )
        return Dataset(self._source, self._ops + (op,), None)

    def map(self, fn: Callable[[Table], Table]) -> "Dataset":
        return self._with_op(MapOp(fn))

    def filter(self, pred: Callable[[Table], np.ndarray]) -> "Dataset":
        return self._with_op(FilterOp(pred))

    def rebatch(self, batch_size: int,
                drop_remainder: bool = False) -> "Dataset":
        return self._with_op(RebatchOp(batch_size, drop_remainder))

    def window(self, size: int, stride: Optional[int] = None) -> "Dataset":
        return self._with_op(WindowOp(size, stride))

    def shuffle(self, buffer_batches: int, seed: int = 0) -> "Dataset":
        return self._with_op(ShuffleOp(buffer_batches, seed))

    def hash_column(self, input_col: str, *, seed: int, num_buckets: int,
                    output_col: str = "hashed_ids",
                    **kwargs) -> "Dataset":
        """The seeded feature hash of ``input_col`` (refused, with
        :class:`~flinkml_tpu_torch.data.ops.HashOp`: ROADMAP.md Queue 1
        item 9)."""
        return self._with_op(HashOp(None))

    def prefetch(self, depth: int = 2, place=None,
                 metrics_group: str = "data.prefetch") -> "Dataset":
        """Append the async host→device tail (see
        :class:`~flinkml_tpu_torch.data.prefetch.DevicePrefetcher`):
        batches arrive as Tables of bucket-padded device-resident columns
        (on the device current when the iteration starts, or where
        ``place`` puts them)."""
        if self._prefetch is not None:
            raise ValueError("Dataset already has a prefetch stage")
        return Dataset(self._source, self._ops, dict(
            depth=depth, place=place, metrics_group=metrics_group,
        ))

    # -- properties ---------------------------------------------------------
    @property
    def skip_transparent(self) -> bool:
        """True when every op maps batches 1:1, so a resume's skip can
        be pushed down to the source instead of replaying the chain."""
        return all(op.skip_transparent for op in self._ops)

    @property
    def num_shards(self) -> int:
        """The source's shard count — the feed's world size (what the
        checkpoint rescale guard pins, and what cursors record
        authoritatively)."""
        return self._source.num_shards

    @property
    def shard_index(self) -> int:
        return self._source.shard_index

    @property
    def reshardable(self) -> bool:
        """True when a cursor written at a DIFFERENT shard count can be
        legally re-split into this chain: the source deals round-robin
        over a canonical global order AND every op is skip-transparent
        (a per-shard shuffle/rebatch entangles the output sequence with
        the shard count)."""
        return self._source.reshardable and self.skip_transparent

    def describe(self) -> str:
        parts = [type(self._source).__name__]
        parts += [op.describe() for op in self._ops]
        if self._prefetch is not None:
            parts.append(f"prefetch(depth={self._prefetch['depth']})")
        return " -> ".join(parts)

    # -- iteration ----------------------------------------------------------
    def iterate(self, cursor: Optional[Cursor] = None) -> "DatasetIterator":
        """A fresh tracked iteration, optionally restored to ``cursor``
        (the consumer's next batch is sequence element
        ``cursor.emitted``)."""
        return DatasetIterator(self, cursor)

    def iterate_from(self, emitted: int) -> "DatasetIterator":
        """Restore-by-watermark: equivalent to ``iterate(Cursor(emitted))``."""
        return DatasetIterator(self, Cursor(emitted=int(emitted)))

    def __iter__(self) -> "DatasetIterator":
        return self.iterate()

    def peek(self) -> Optional[Table]:
        """The first batch (or None for an empty pipeline), produced by
        a throwaway prefetch-free iteration — peeking must not leave a
        worker thread behind or consume the real feed."""
        ds = (self if self._prefetch is None
              else Dataset(self._source, self._ops, None))
        it = ds.iterate()
        try:
            return next(it)
        except StopIteration:
            return None
        finally:
            it.close()


def _drop(it: Iterator[Table], n: int) -> Iterator[Table]:
    for _ in range(n):
        try:
            next(it)
        except StopIteration:
            return
    for batch in it:
        yield batch


def _read_seam(src, shard_index: int) -> Iterator[Table]:
    """Source reads through the ``data.read`` fault seam. Module-level
    (not a DatasetIterator method) for the same no-back-reference reason
    as :class:`_ChainState`."""
    from flinkml_tpu_torch import faults

    for batch in src:
        if faults.ACTIVE is not None:  # a scripted source failure
            faults.fire("data.read", read=src.batches_read,
                        shard=shard_index)
        yield batch


class _ChainState:
    """State shared between the chain generators and the
    DatasetIterator. A separate object on purpose: the prefetch worker
    holds the chain, so the chain must NOT reference the DatasetIterator
    (which owns the prefetcher) — that cycle would keep an abandoned
    prefetcher reachable from the worker's own stack and defeat the
    GC-finalizer thread cleanup."""

    __slots__ = ("shuffle_rng",)

    def __init__(self):
        self.shuffle_rng: Optional[np.random.Generator] = None

    def register_shuffle_probe(self, rng: np.random.Generator) -> None:
        """Called by :class:`~flinkml_tpu_torch.data.ops.ShuffleOp` so cursor
        snapshots can record the buffer's RNG state."""
        self.shuffle_rng = rng


class _TrackedIterator:
    """The assembly + iterator/lifecycle tail shared by
    :class:`DatasetIterator` and :class:`~flinkml_tpu_torch.data.elastic
    .ElasticFeedIterator`: base iterator → ops (with a
    :class:`_ChainState` for shuffle probes) → optional dropped replay
    prefix → optional :class:`~flinkml_tpu_torch.data.prefetch
    .DevicePrefetcher`, plus the delivered-batch accounting and the
    idempotent ``close`` the cursor machinery depends on. One
    definition, so a fix to the tail (prefetcher shutdown, in-flight
    accounting) can never diverge between the two feeds."""

    def _assemble(self, base_it: Iterator[Table], ops: Sequence[Op],
                  drop: int, prefetch_spec: Optional[dict],
                  start: int) -> None:
        self._chain_state = _ChainState()
        it = base_it
        for op in ops:
            it = op.apply(it, self._chain_state)
        if drop:
            it = _drop(it, drop)
        self._prefetcher = None
        if prefetch_spec is not None:
            from flinkml_tpu_torch.data.prefetch import DevicePrefetcher

            self._prefetcher = DevicePrefetcher(it, **prefetch_spec)
            it = self._prefetcher
        self._it = it
        self._emitted = int(start)
        self._closed = False

    # -- iterator protocol --------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> Table:
        if self._closed:
            raise StopIteration
        try:
            batch = next(self._it)
        except StopIteration:
            self.close()
            raise
        self._emitted += 1
        return batch

    @property
    def emitted(self) -> int:
        return self._emitted

    def _shuffle_state(self) -> Optional[dict]:
        return (rng_state_dict(self._chain_state.shuffle_rng)
                if self._chain_state.shuffle_rng is not None else None)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Stop the prefetch worker (if any) and end the iteration.
        Idempotent; always safe to call from a ``finally``."""
        self._closed = True
        if self._prefetcher is not None:
            self._prefetcher.close()
        self._close_sources()

    def _close_sources(self) -> None:
        """Subclass hook: release reader-side resources on close."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


class DatasetIterator(_TrackedIterator):
    """One tracked iteration of a :class:`Dataset`.

    Tracks the delivered-batch watermark and the source/shuffle
    positions for :meth:`cursor` snapshots; owns (and closes) the
    prefetcher.
    """

    def __init__(self, dataset: Dataset, cursor: Optional[Cursor] = None):
        self._dataset = dataset
        skip = int(cursor.emitted) if cursor is not None else 0
        fast = dataset.skip_transparent
        if (
            cursor is not None
            and cursor.num_shards is not None
            and (cursor.shard_index is None
                 or cursor.num_shards != dataset.num_shards)
        ):
            # The cursor's shard count is authoritative: a different
            # count is either a LEGAL reshard (round-robin source +
            # skip-transparent chain: re-derive this shard's skip from
            # the global watermark) or a loud error — never a silent
            # fast-forward to the wrong rows. A GLOBAL-order cursor
            # (shard_index None) counts a different unit entirely, so it
            # is refused even at a matching shard count.
            if cursor.shard_index is None:
                raise CursorShardMismatchError(
                    f"global-order cursor (world {cursor.num_shards}) "
                    f"restored into a per-shard Dataset "
                    f"({dataset.describe()}, shard "
                    f"{dataset.shard_index}/{dataset.num_shards}); "
                    "global cursors resume through an ElasticFeed"
                )
            if not dataset.reshardable:
                raise CursorShardMismatchError(
                    f"cursor was written by a {cursor.num_shards}-way "
                    f"sharded feed but this chain is sharded "
                    f"{dataset.num_shards}-way and cannot reshard "
                    f"({dataset.describe()}: "
                    + ("source deals are not round-robin"
                       if not dataset._source.reshardable
                       else "chain has non-skip-transparent ops")
                    + "); resume at the original shard count"
                )
            skip = dataset._source.skip_for_global(cursor.global_emitted)
            fast = True  # reshardable requires skip-transparency
            _log.info(
                "dataset reshard resume: world %d -> %d, global watermark "
                "%d -> shard %d/%d skip %d — %s",
                cursor.num_shards, dataset.num_shards,
                cursor.global_emitted, dataset.shard_index,
                dataset.num_shards, skip, dataset.describe(),
            )
        elif skip:
            _log.info(
                "dataset resume: fast-forwarding %d batches (%s skip) — %s",
                skip, "source" if fast else "replay", dataset.describe(),
            )
        # The EXACT global watermark this iteration starts from: after a
        # reshard the per-shard skips are uneven, so the lockstep
        # product (emitted x num_shards) would drift — the cursor's
        # recorded watermark (or the product, for pre-elastic cursors)
        # anchors it, and every subsequent lockstep round advances it by
        # num_shards (see :meth:`cursor`).
        if cursor is None:
            self._global_base = 0
        elif cursor.num_shards is not None:
            self._global_base = cursor.global_emitted
        else:  # legacy cursor: per-shard emitted, never resharded
            self._global_base = skip * dataset.num_shards
        self._emitted_base = skip
        self._src = dataset._source.open(skip_batches=skip if fast else 0)
        self._assemble(
            _read_seam(self._src, dataset._source.shard_index),
            dataset._ops, drop=0 if fast else skip,
            prefetch_spec=dataset._prefetch, start=skip,
        )

    # -- cursor -------------------------------------------------------------
    def source_position(self) -> Dict[str, Any]:
        """The underlying source iterator's position record (public:
        an :class:`~flinkml_tpu_torch.data.ElasticFeed`'s global cursor
        aggregates its shard readers' positions through this)."""
        return self._src.position()

    def cursor(self) -> Cursor:
        """The current position: ``emitted`` is the replay watermark;
        source/shuffle/in-flight record where the producer side stands
        (ahead of the watermark by whatever sits in transform buffers
        and the prefetch queue)."""
        # batches_read counts source batches consumed on behalf of this
        # iteration (a replay-resumed iterator's dropped prefix
        # included — those outputs were consumed too, just internally),
        # so reads minus deliveries IS the in-flight population on both
        # the fast-skip and replay paths.
        src_pos = self.source_position()
        in_flight = max(0, src_pos["batches_read"] - self._emitted)
        return Cursor(
            emitted=self._emitted,
            source=src_pos,
            shuffle=self._shuffle_state(),
            in_flight=in_flight,
            num_shards=self._dataset.num_shards,
            shard_index=self._dataset.shard_index,
            # Lockstep: each round past the resume point advanced the
            # GLOBAL sequence by one batch per shard.
            global_watermark=(
                self._global_base
                + (self._emitted - self._emitted_base)
                * self._dataset.num_shards
            ),
        )
