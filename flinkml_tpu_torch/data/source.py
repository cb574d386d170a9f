"""Sharded input-pipeline sources.

The port's counterpart of ``flinkml_tpu.data.source``. The heads of a
:class:`~flinkml_tpu_torch.data.Dataset` chain: each source yields
:class:`~flinkml_tpu_torch.table.Table` batches from one replayable,
shard-assignable origin — in-memory arrays, numeric-CSV file globs,
LibSVM file globs (both through :mod:`flinkml_tpu_torch.io`'s native
parsers), or a seeded synthetic generator. The reference gets this layer
from Flink's connector sources (per-subtask splits of a partitioned
stream); here an explicit ``shard=(index, count)`` assigns the split —
row blocks for array sources, files round-robin for file sources, batch
indices round-robin for synthetic sources; a ``mesh=`` assigns this
rank's split of the mesh's data axis (the per-process split of the JAX
package), which is how each rank of a multi-process streamed fit reads
its own partition.

Contracts every source honors (what makes the cursor machinery work):

- **deterministic replay**: ``open()`` twice yields the identical batch
  sequence (file globs are sorted; synthetic draws are keyed by global
  batch index, not call order);
- **resumable skip**: ``open(skip_batches=k)`` starts at batch ``k`` of
  this shard's sequence without re-yielding the prefix (array/synthetic
  sources jump in O(1); file sources re-parse only as far as needed and
  cache per-file row counts so a second skip is cheap);
- **position**: the returned iterator's :meth:`SourceIterator.position`
  reports (shard, offset) for the cursor's audit trail.
"""

from __future__ import annotations

import glob as _glob
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np

from flinkml_tpu_torch.data.state import CursorShardMismatchError
from flinkml_tpu_torch.table import Table


def resolve_shard(shard: Optional[Tuple[int, int]], mesh=None) -> Tuple[int, int]:
    """Normalize a shard assignment: an explicit ``(index, count)``, a
    :class:`~flinkml_tpu_torch.parallel.DeviceMesh` (this rank's index
    and the size of the mesh's data axis: the reference's per-subtask
    stream split; ``(0, 1)`` for a mesh without a process group), or
    neither (the single unsharded feed).

    Elastic resume re-derives each NEW shard's read position from a
    restored global watermark one level up: the resolved shard's
    :meth:`Source.skip_for_global` (round-robin deals,
    :func:`round_robin_skip`) computes the fast-forward, and
    :class:`~flinkml_tpu_torch.data.Dataset`/:class:`~flinkml_tpu_torch
    .data.ElasticFeed` validate the shard-count change before any batch is
    misread."""
    if shard is not None:
        index, count = int(shard[0]), int(shard[1])
    elif mesh is not None:
        from flinkml_tpu_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
        if mesh.mesh is None:
            index, count = 0, 1
        else:
            index, count = mesh.axis_index(), mesh.axis_size()
    else:
        index, count = 0, 1
    if count < 1 or not (0 <= index < count):
        raise ValueError(f"invalid shard assignment ({index}, {count})")
    return index, count


def round_robin_skip(shard_index: int, num_shards: int,
                     global_batches: int) -> int:
    """How many of shard ``shard_index``'s round-robin-dealt global
    batch indices (``shard_index, shard_index + num_shards, ...``) fall
    below ``global_batches`` — the per-shard fast-forward that lands a
    resharded resume exactly at a restored global watermark."""
    g = int(global_batches)
    if g <= shard_index:
        return 0
    return (g - shard_index + num_shards - 1) // num_shards


class SourceIterator:
    """Iterator over one shard's batches with a reportable position."""

    def __init__(self, gen: Iterator[Table], source: "Source", start: int):
        self._gen = gen
        self._source = source
        self.batches_read = int(start)

    def __iter__(self) -> "SourceIterator":
        return self

    def __next__(self) -> Table:
        batch = next(self._gen)
        self.batches_read += 1
        return batch

    def position(self) -> Dict[str, Any]:
        pos = self._source._position(self.batches_read)
        pos.update(
            shard=self._source.shard_index,
            num_shards=self._source.num_shards,
            batches_read=self.batches_read,
        )
        return pos


class Source:
    """Base class: a replayable, shardable origin of Table batches."""

    #: True when the shard deal is a pure round-robin over ONE canonical
    #: global batch sequence (batch ``g`` belongs to shard ``g % n``),
    #: so a cursor written at one shard count can be re-split across
    #: another: the global order is identical at every world, only the
    #: reading is parallelized. Contiguous-block deals (ArraySource) and
    #: file-granularity deals (CSV/LibSVM globs) are NOT — their
    #: mid-stream progress is entangled with the shard count.
    reshardable = False

    def __init__(self, shard: Optional[Tuple[int, int]] = None, mesh=None):
        self.shard_index, self.num_shards = resolve_shard(shard, mesh)

    def open(self, skip_batches: int = 0) -> SourceIterator:
        """A fresh iterator over this shard's batches, starting at batch
        ``skip_batches`` of the (deterministic) sequence."""
        return SourceIterator(
            self._batches(int(skip_batches)), self, int(skip_batches)
        )

    def skip_for_global(self, global_batches: int) -> int:
        """This shard's fast-forward for a restored GLOBAL watermark:
        the number of its own batches with global index below
        ``global_batches``. Defined only for :attr:`reshardable`
        sources — anything else raises
        :class:`~flinkml_tpu_torch.data.state.CursorShardMismatchError`
        (loudly, before any row is misread)."""
        raise CursorShardMismatchError(
            f"{type(self).__name__} deals shards "
            f"({self.shard_index}/{self.num_shards}) without a canonical "
            "round-robin global batch order, so a cursor cannot be "
            "re-split across a different shard count; resume at the "
            "original count, or feed through a reshardable source "
            "(SyntheticSource, or an ElasticFeed over one)"
        )

    def __iter__(self) -> SourceIterator:
        return self.open()

    # -- subclass surface ---------------------------------------------------
    def _batches(self, skip: int) -> Iterator[Table]:
        raise NotImplementedError

    def _position(self, batches_read: int) -> Dict[str, Any]:
        return {}


def _as_table(data: Union[Table, Mapping[str, Any]]) -> Table:
    return data if isinstance(data, Table) else Table(dict(data))


class ArraySource(Source):
    """In-memory arrays (a :class:`Table` or a column mapping), split
    into consecutive ``batch_size``-row batches. Sharding assigns each
    rank one contiguous row block (remainder rows go to the leading
    ranks), so every rank's feed is a slice view — zero copies until a
    transform touches the rows."""

    def __init__(self, data, batch_size: int,
                 shard: Optional[Tuple[int, int]] = None, mesh=None):
        super().__init__(shard, mesh)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.table = _as_table(data)
        self.batch_size = int(batch_size)
        n = self.table.num_rows
        base, rem = divmod(n, self.num_shards)
        sizes = [base + (1 if i < rem else 0) for i in range(self.num_shards)]
        self._lo = sum(sizes[: self.shard_index])
        self._hi = self._lo + sizes[self.shard_index]

    @property
    def num_batches(self) -> int:
        rows = self._hi - self._lo
        return -(-rows // self.batch_size) if rows else 0

    def _batches(self, skip: int) -> Iterator[Table]:
        start = self._lo + skip * self.batch_size
        for lo in range(start, self._hi, self.batch_size):
            yield self.table.slice(lo, min(lo + self.batch_size, self._hi))

    def _position(self, batches_read: int) -> Dict[str, Any]:
        return {"row_offset": min(
            batches_read * self.batch_size, self._hi - self._lo
        )}


class SyntheticSource(Source):
    """Seeded generator source: ``make_batch(index, rng) -> Table`` is
    called with the GLOBAL batch index and a Generator keyed by
    ``(seed, index)`` — so batch ``i`` is identical no matter which rank
    draws it, in what order, or after how many skips. Sharding deals
    global indices round-robin, which ALSO makes this the reshardable
    source: the global sequence is canonical at every shard count, so an
    elastic resume re-splits a restored watermark exactly
    (:meth:`skip_for_global`)."""

    reshardable = True

    def __init__(self, make_batch: Callable[[int, np.random.Generator], Table],
                 num_batches: int, seed: int = 0,
                 shard: Optional[Tuple[int, int]] = None, mesh=None):
        super().__init__(shard, mesh)
        if num_batches < 0:
            raise ValueError(f"num_batches must be >= 0, got {num_batches}")
        self.make_batch = make_batch
        self.num_batches_global = int(num_batches)
        self.seed = int(seed)

    def _global_indices(self) -> range:
        return range(self.shard_index, self.num_batches_global,
                     self.num_shards)

    @property
    def num_batches(self) -> int:
        return len(self._global_indices())

    def skip_for_global(self, global_batches: int) -> int:
        return round_robin_skip(
            self.shard_index, self.num_shards,
            min(int(global_batches), self.num_batches_global),
        )

    def _batches(self, skip: int) -> Iterator[Table]:
        for gi in list(self._global_indices())[skip:]:
            rng = np.random.default_rng([self.seed, gi])
            yield self.make_batch(gi, rng)

    def _position(self, batches_read: int) -> Dict[str, Any]:
        idx = list(self._global_indices())
        nxt = idx[batches_read] if batches_read < len(idx) else None
        return {"next_global_batch": nxt}


class _FileSource(Source):
    """Shared machinery of the file-glob sources: sorted glob, files
    round-robin per rank, per-file batch counts cached after first parse
    so a resumed skip re-parses only the file the cursor lands in."""

    def __init__(self, pattern: Union[str, List[str]], batch_size: int,
                 shard: Optional[Tuple[int, int]] = None, mesh=None):
        super().__init__(shard, mesh)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = int(batch_size)
        if isinstance(pattern, str):
            files = sorted(_glob.glob(pattern))
            if not files:
                raise FileNotFoundError(
                    f"no files match input-pipeline glob {pattern!r}"
                )
        else:
            files = list(pattern)
        self.files = files[self.shard_index :: self.num_shards]
        self._batch_counts: Dict[str, int] = {}

    def _read_file(self, path: str) -> Table:
        raise NotImplementedError

    def _file_batches(self, path: str) -> int:
        if path not in self._batch_counts:
            rows = self._read_file(path).num_rows
            self._batch_counts[path] = -(-rows // self.batch_size)
        return self._batch_counts[path]

    def _batches(self, skip: int) -> Iterator[Table]:
        remaining = skip
        for path in self.files:
            # A cached batch count skips a whole file without re-parsing
            # it; an uncached one costs exactly ONE parse (there is no
            # row index in CSV/LibSVM to consult) — kept and reused when
            # the cursor lands inside this file.
            table: Optional[Table] = None
            count = self._batch_counts.get(path)
            if count is None:
                table = self._read_file(path)
                count = -(-table.num_rows // self.batch_size)
                self._batch_counts[path] = count
            if remaining >= count:
                remaining -= count
                continue
            if table is None:
                table = self._read_file(path)
            for i, batch in enumerate(table.batches(self.batch_size)):
                if i < remaining:
                    continue
                yield batch
            remaining = 0

    def _position(self, batches_read: int) -> Dict[str, Any]:
        remaining, fi = batches_read, 0
        for fi, path in enumerate(self.files):
            count = self._batch_counts.get(path)
            if count is None or remaining < count:
                break
            remaining -= count
        return {"file_index": fi, "batch_in_file": remaining}


class CSVSource(_FileSource):
    """Numeric-CSV file glob through
    :func:`flinkml_tpu_torch.io.read_csv_table` (native multithreaded
    parser, or the pure-Python parse without a compiler). Every file
    must share one schema; columns without a header row are ``c0..cN``."""

    def __init__(self, pattern, batch_size: int, delimiter: str = ",",
                 header="auto", shard=None, mesh=None):
        super().__init__(pattern, batch_size, shard, mesh)
        self.delimiter = delimiter
        self.header = header

    def _read_file(self, path: str) -> Table:
        from flinkml_tpu_torch.io import read_csv_table

        return read_csv_table(path, delimiter=self.delimiter,
                              header=self.header)


class LibSVMSource(_FileSource):
    """LibSVM file glob densified to a ``{features, label}`` Table via
    :func:`flinkml_tpu_torch.io.read_libsvm_dense`. ``n_features`` pins
    the feature dim so every file (and every shard) agrees on the batch
    width."""

    def __init__(self, pattern, batch_size: int, n_features: int,
                 features_col: str = "features", label_col: str = "label",
                 shard=None, mesh=None):
        super().__init__(pattern, batch_size, shard, mesh)
        self.n_features = int(n_features)
        self.features_col = features_col
        self.label_col = label_col

    def _read_file(self, path: str) -> Table:
        from flinkml_tpu_torch.io import read_libsvm_dense

        x, y = read_libsvm_dense(path, n_features=self.n_features)
        return Table({self.features_col: x, self.label_col: y})
