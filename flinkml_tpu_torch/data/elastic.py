"""ElasticFeed: the world-parallel, global-order input feed.

The port's counterpart of ``flinkml_tpu.data.elastic``, in one process.
The elastic-resume contract needs a feed whose delivered batch sequence is
**independent of the world size**: "world" parallelizes the *data plane*
(reading, parsing, prefetching), while consumption stays in one canonical
global order — the reference's unbounded iteration, where records arrive
from P parallel source subtasks but the online model updates once per
arriving record. That independence is what makes "kill at world 4, resume
at world 2 or world 8, bit-identical model" hold.

:class:`ElasticFeed` is that feed: ``world`` per-shard
:class:`~flinkml_tpu_torch.data.Dataset` readers (built by a
``make_dataset(shard)`` factory, shard ``i`` of ``world``), merged
round-robin back into the canonical global sequence (batch ``g`` comes
from shard ``g % world`` — the deal every reshardable
:class:`~flinkml_tpu_torch.data.source.Source` uses), with optional
**post-merge** ops (map/shuffle/rebatch, applied to the *global*
stream, hence world-independent by construction) and an optional
device-prefetch tail. The ``world`` readers run in this process. On a
mesh of several ranks each rank builds its own feed over its partition
(``make_dataset`` reading ``Dataset.from_*(..., mesh=mesh)``, this rank's
shard), and the multi-process streamed fits keep the ranks in step.

Cursor model: an ElasticFeed cursor counts **global** batches
(``Cursor.emitted``; ``shard_index`` is None — the global-scope
discriminator) and records the writing ``world`` in
``Cursor.num_shards``. Resume:

- **same world**: each shard reader fast-forwards to its own share of
  the watermark (``round_robin_skip``) — works for ANY source;
- **different world** (the elastic case): requires every per-shard
  chain to be reshardable (round-robin source, skip-transparent
  per-shard ops); the new readers re-split the SAME global sequence, so
  the consumer continues at exactly batch ``emitted``;
- post-merge non-transparent ops (shuffle) force a replay of the merged
  stream with the consumed prefix dropped — still exact, because the
  merged global sequence (and therefore the seeded shuffle) is
  identical at every world;
- anything else — e.g. a world change over contiguous-block
  ArraySource shards — raises
  :class:`~flinkml_tpu_torch.data.state.CursorShardMismatchError` loudly.

An ElasticFeed drops in anywhere a Dataset does: ``fit_stream`` of the
online trainer, the streamed fits, :func:`~flinkml_tpu_torch.iteration
.iterate` (which checkpoints its cursor in every snapshot and reopens it
on resume — at the same world or a new one).
"""

from __future__ import annotations

import logging
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

from flinkml_tpu_torch.data.dataset import (
    Dataset,
    DatasetIterator,
    _TrackedIterator,
)
from flinkml_tpu_torch.data.ops import MapOp, Op, RebatchOp, ShuffleOp
from flinkml_tpu_torch.data.source import round_robin_skip
from flinkml_tpu_torch.data.state import Cursor, CursorShardMismatchError
from flinkml_tpu_torch.table import Table

_log = logging.getLogger(__name__)


class ElasticFeed:
    """World-parallel readers, one canonical global order. See module
    docstring. Immutable like Dataset: combinators return new feeds."""

    def __init__(self, make_dataset: Callable[[Tuple[int, int]], Dataset],
                 world: int, ops: Sequence[Op] = (),
                 prefetch_spec: Optional[dict] = None):
        if int(world) < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self._make = make_dataset
        self._world = int(world)
        self._ops: Tuple[Op, ...] = tuple(ops)
        self._prefetch = prefetch_spec

    # -- combinators (post-merge: applied to the GLOBAL stream) -------------
    def _with_op(self, op: Op) -> "ElasticFeed":
        if self._prefetch is not None:
            raise ValueError(
                "prefetch() must be the LAST stage of an ElasticFeed"
            )
        return ElasticFeed(self._make, self._world, self._ops + (op,), None)

    def map(self, fn: Callable[[Table], Table]) -> "ElasticFeed":
        return self._with_op(MapOp(fn))

    def rebatch(self, batch_size: int,
                drop_remainder: bool = False) -> "ElasticFeed":
        return self._with_op(RebatchOp(batch_size, drop_remainder))

    def shuffle(self, buffer_batches: int, seed: int = 0) -> "ElasticFeed":
        """Seeded shuffle of the GLOBAL batch sequence — because it runs
        after the merge, the shuffled order is identical at every world
        (the property that keeps shuffled elastic resume bit-exact)."""
        return self._with_op(ShuffleOp(buffer_batches, seed))

    def prefetch(self, depth: int = 2, place=None,
                 metrics_group: str = "data.prefetch") -> "ElasticFeed":
        if self._prefetch is not None:
            raise ValueError("ElasticFeed already has a prefetch stage")
        return ElasticFeed(self._make, self._world, self._ops, dict(
            depth=depth, place=place, metrics_group=metrics_group,
        ))

    # -- properties ---------------------------------------------------------
    @property
    def world(self) -> int:
        return self._world

    @property
    def num_shards(self) -> int:
        """Alias of :attr:`world` — the uniform "feed world size" surface
        the checkpoint rescale guard pins (``Dataset.num_shards`` is the
        per-shard counterpart)."""
        return self._world

    @property
    def post_merge_transparent(self) -> bool:
        """True when every post-merge op maps batches 1:1, so a resume
        can fast-forward the shard readers instead of replaying the
        merged stream."""
        return all(op.skip_transparent for op in self._ops)

    def _shard_datasets(self) -> List[Dataset]:
        out = []
        for i in range(self._world):
            ds = self._make((i, self._world))
            if not isinstance(ds, Dataset):
                raise TypeError(
                    "make_dataset must return a flinkml_tpu_torch.data.Dataset, "
                    f"got {type(ds)!r}"
                )
            if ds.num_shards != self._world or ds.shard_index != i:
                raise ValueError(
                    "make_dataset must honor its shard argument: asked "
                    f"for shard ({i}, {self._world}), got "
                    f"({ds.shard_index}, {ds.num_shards})"
                )
            out.append(ds)
        return out

    def describe(self) -> str:
        parts = [f"elastic(world={self._world})"]
        parts += [op.describe() for op in self._ops]
        if self._prefetch is not None:
            parts.append(f"prefetch(depth={self._prefetch['depth']})")
        return " -> ".join(parts)

    # -- iteration ----------------------------------------------------------
    def iterate(self, cursor: Optional[Cursor] = None) -> "ElasticFeedIterator":
        """A fresh tracked global-order iteration, optionally restored
        to ``cursor`` — written at THIS world or any other (the elastic
        reshard; see module docstring for what must hold)."""
        return ElasticFeedIterator(self, cursor)

    def __iter__(self) -> "ElasticFeedIterator":
        return self.iterate()

    def peek(self) -> Optional[Table]:
        """The first global batch via a throwaway prefetch-free
        iteration (same contract as :meth:`Dataset.peek`)."""
        feed = (self if self._prefetch is None
                else ElasticFeed(self._make, self._world, self._ops, None))
        it = feed.iterate()
        try:
            return next(it)
        except StopIteration:
            return None
        finally:
            it.close()


class ElasticFeedIterator(_TrackedIterator):
    """One tracked global-order iteration of an :class:`ElasticFeed`.
    The assembly and iterator/lifecycle tail (ops, replay drop,
    prefetcher, delivered-batch accounting, idempotent close) is the
    shared :class:`~flinkml_tpu_torch.data.dataset._TrackedIterator`."""

    def __init__(self, feed: ElasticFeed, cursor: Optional[Cursor] = None):
        self._feed = feed
        world = feed._world
        global_skip = 0
        if cursor is not None:
            if cursor.shard_index is not None:
                raise CursorShardMismatchError(
                    f"per-shard cursor (shard {cursor.shard_index}/"
                    f"{cursor.num_shards}) restored into a global-order "
                    f"ElasticFeed(world={world}); per-shard cursors "
                    "resume through their own Dataset"
                )
            global_skip = int(cursor.emitted)
        datasets = feed._shard_datasets()
        old_world = (cursor.num_shards if cursor is not None
                     and cursor.num_shards is not None else world)
        resharding = old_world != world
        if resharding and global_skip and not all(
            ds.reshardable for ds in datasets
        ):
            culprit = next(ds for ds in datasets if not ds.reshardable)
            raise CursorShardMismatchError(
                f"cursor was written at world {old_world} but this feed "
                f"has world {world}, and the per-shard chain "
                f"({culprit.describe()}) cannot reshard: "
                + ("its source deals are not round-robin"
                   if not culprit._source.reshardable
                   else "it has non-skip-transparent per-shard ops")
                + "; resume at the original world"
            )
        fast = feed.post_merge_transparent
        if global_skip:
            _log.info(
                "elastic resume: world %d -> %d, global watermark %d "
                "(%s) — %s", old_world, world, global_skip,
                "reader fast-forward" if fast else "merged replay",
                feed.describe(),
            )
        if fast and global_skip:
            skips = [round_robin_skip(i, world, global_skip)
                     for i in range(world)]
        else:
            skips = [0] * world
        self._shard_iters: List[DatasetIterator] = [
            ds.iterate(Cursor(emitted=skips[i]) if skips[i] else None)
            for i, ds in enumerate(datasets)
        ]
        start_g = global_skip if (fast and global_skip) else 0

        def merged(iters: List[DatasetIterator], g: int) -> Iterator[Table]:
            # Round-robin in global-index order; the sequence ends at
            # the first missing index (shard exhausted), so unequal
            # shard lengths still yield exactly the canonical prefix.
            while True:
                try:
                    batch = next(iters[g % world])
                except StopIteration:
                    return
                yield batch
                g += 1

        self._assemble(
            merged(self._shard_iters, start_g), feed._ops,
            drop=0 if fast else global_skip,
            prefetch_spec=feed._prefetch, start=global_skip,
        )

    # -- cursor -------------------------------------------------------------
    def cursor(self) -> Cursor:
        """The current GLOBAL position: ``emitted`` counts global
        batches, ``num_shards`` records the world, ``shard_index`` is
        None (the global-scope discriminator), and ``source`` carries
        the per-shard reader positions for the audit trail."""
        per_shard = [it.source_position() for it in self._shard_iters]
        reads = sum(p["batches_read"] for p in per_shard)
        return Cursor(
            emitted=self._emitted,
            source={"world": self._feed._world, "per_shard": per_shard},
            shuffle=self._shuffle_state(),
            in_flight=max(0, reads - self._emitted),
            num_shards=self._feed._world,
            shard_index=None,
            global_watermark=self._emitted,  # global scope: exact
        )

    # -- lifecycle ----------------------------------------------------------
    def _close_sources(self) -> None:
        for it in self._shard_iters:
            it.close()
