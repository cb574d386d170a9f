"""Segmented host data cache, epoch replay and a prefetching device feed.

The port's counterpart of ``flinkml_tpu.iteration.datacache`` (reference:
``DataCacheWriter.java:36-139``, ``DataCacheReader.java:35-135``,
``Segment.java:27``, ``DataCacheSnapshot.java:1-224`` and the
``ReplayOperator``, ``ReplayOperator.java:62-250``).

Records are columnar batches (a dict of numpy arrays). A batch stays in
host RAM until the writer's memory budget is exceeded, then spills to a
segment file: ``FMLTSEG1`` | u32 header length | JSON header (dtype, shape
and byte offset of each column) | the columns' bytes back to back. The
format is the JAX package's byte for byte, so a segment or a
:class:`DataCacheSnapshot` written by either package replays in the other.

:class:`PrefetchingDeviceFeed` overlaps the next batch's host→device copy
with the current step. On the card it copies on a stream of its own, from
pinned host memory, and the consumer's stream waits on an event recorded
after each batch's copies (see the class).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import shutil
import threading
import time
import weakref
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.device import default_device

_log = logging.getLogger(__name__)

Batch = Dict[str, np.ndarray]

_MAGIC = b"FMLTSEG1"


@dataclasses.dataclass(frozen=True)
class Segment:
    """One spilled segment file. Parity: ``Segment.java:27``."""

    path: str
    num_rows: int
    nbytes: int


def _write_segment(path: str, batch: Batch) -> Segment:
    """Write ``batch`` as a raw columnar segment, atomically (a temporary
    file renamed into place)."""
    header: Dict[str, Any] = {"columns": {}}
    offset = 0
    cols: List[Tuple[str, np.ndarray]] = []
    for name, arr in batch.items():
        arr = np.ascontiguousarray(arr)
        header["columns"][name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
        }
        offset += arr.nbytes
        cols.append((name, arr))
    num_rows = cols[0][1].shape[0] if cols else 0
    header["num_rows"] = num_rows
    hbytes = json.dumps(header).encode()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(len(hbytes).to_bytes(4, "little"))
        f.write(hbytes)
        for _, arr in cols:
            arr.tofile(f)
    os.replace(tmp, path)
    return Segment(path=path, num_rows=num_rows, nbytes=offset)


def _read_segment(path: str) -> Batch:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise IOError(f"{path}: not a datacache segment (magic={magic!r})")
        hlen = int.from_bytes(f.read(4), "little")
        header = json.loads(f.read(hlen))
        data_start = f.tell()
        batch: Batch = {}
        for name, meta in header["columns"].items():
            dtype = np.dtype(meta["dtype"])
            shape = tuple(meta["shape"])
            f.seek(data_start + meta["offset"])
            count = int(np.prod(shape)) if shape else 1
            batch[name] = np.fromfile(f, dtype=dtype, count=count).reshape(shape)
    return batch


class DataCacheWriter:
    """Append columnar batches; spill to disk beyond a memory budget
    (default 256 MiB; a budget needs a ``directory``)."""

    def __init__(
        self,
        directory: Optional[str] = None,
        memory_budget_bytes: Optional[int] = None,
    ):
        if directory is None and memory_budget_bytes is not None:
            raise ValueError(
                "memory_budget_bytes requires a spill directory; without one "
                "the cache is RAM-only and the budget cannot be honored"
            )
        self.directory = directory
        self.memory_budget_bytes = int(
            256 << 20 if memory_budget_bytes is None else memory_budget_bytes
        )
        # In append order, each an in-RAM Batch or a spilled Segment: a
        # spill mid-stream must not reorder replay.
        self._entries: List[Any] = []
        self._mem_bytes = 0
        self._num_spilled = 0
        self._finished = False
        self._num_rows = 0

    def append(self, batch: Batch) -> None:
        if self._finished:
            raise RuntimeError("DataCacheWriter already finished")
        batch = {k: np.asarray(v) for k, v in batch.items()}
        nbytes = sum(a.nbytes for a in batch.values())
        rows = next(iter(batch.values())).shape[0] if batch else 0
        for name, a in batch.items():
            if a.dtype == object:
                raise TypeError(
                    f"column {name!r} has dtype=object; densify before caching"
                )
            if a.shape[0] != rows:
                raise ValueError(
                    f"column {name!r} has {a.shape[0]} rows, expected {rows}"
                )
        self._num_rows += rows
        if (
            self.directory is not None
            and self._mem_bytes + nbytes > self.memory_budget_bytes
        ):
            # A spilled batch is copied to disk: the caller's arrays stay
            # untouched and reusable.
            self._spill(batch)
        else:
            # RAM batches are handed back by reference every epoch: frozen,
            # so that an in-place update fails instead of changing later
            # epochs.
            for a in batch.values():
                a.flags.writeable = False
            self._entries.append(batch)
            self._mem_bytes += nbytes

    def _spill(self, batch: Batch) -> None:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f"segment-{self._num_spilled:06d}.bin")
        self._num_spilled += 1
        segment = _write_segment(path, batch)
        _log.info("datacache spill: segment %s (%d rows, %d bytes)", path,
                  segment.num_rows, segment.nbytes)
        self._entries.append(segment)

    def finish(self) -> "DataCache":
        """Seal the cache; no further appends."""
        self._finished = True
        return DataCache(entries=list(self._entries), num_rows=self._num_rows)


@dataclasses.dataclass
class DataCache:
    """A sealed, re-readable sequence of batches (in RAM and spilled), in
    append order."""

    entries: List[Any]  # Batch | Segment
    num_rows: int

    @property
    def num_batches(self) -> int:
        return len(self.entries)

    @property
    def mem_batches(self) -> List[Batch]:
        return [e for e in self.entries if not isinstance(e, Segment)]

    @property
    def segments(self) -> List[Segment]:
        return [e for e in self.entries if isinstance(e, Segment)]

    def reader(self, start_position: int = 0) -> "DataCacheReader":
        return DataCacheReader(self, start_position)

    def __iter__(self) -> Iterator[Batch]:
        return self.reader()


class DataCacheReader:
    """Iterate batches from a resumable position (whole batches
    consumed). Parity: ``DataCacheReader.java:35-135``."""

    def __init__(self, cache: DataCache, start_position: int = 0):
        self._cache = cache
        self.position = int(start_position)

    def __iter__(self) -> "DataCacheReader":
        return self

    def __next__(self) -> Batch:
        i = self.position
        if i >= len(self._cache.entries):
            raise StopIteration
        self.position += 1
        entry = self._cache.entries[i]
        if isinstance(entry, Segment):
            return _read_segment(entry.path)
        # A shallow copy: a consumer may replace keys without touching the
        # cached batch, whose arrays are frozen.
        return dict(entry)


class DataCacheSnapshot:
    """Persist and recover a cache: every batch written as a segment under
    ``snapshot_dir`` with a JSON manifest. Parity:
    ``DataCacheSnapshot.java:1-224``."""

    MANIFEST = "datacache-manifest.json"

    @staticmethod
    def persist(cache: DataCache, snapshot_dir: str) -> None:
        os.makedirs(snapshot_dir, exist_ok=True)
        segments: List[Segment] = []
        for i, entry in enumerate(cache.entries):
            dst = os.path.join(snapshot_dir, f"snap-segment-{i:06d}.bin")
            if isinstance(entry, Segment):
                if os.path.abspath(dst) != os.path.abspath(entry.path):
                    shutil.copyfile(entry.path, dst)
                segments.append(Segment(dst, entry.num_rows, entry.nbytes))
            else:
                segments.append(_write_segment(dst, entry))
        manifest = {
            "num_rows": cache.num_rows,
            "segments": [
                {"file": os.path.basename(s.path), "num_rows": s.num_rows,
                 "nbytes": s.nbytes}
                for s in segments
            ],
        }
        tmp = os.path.join(snapshot_dir, f".manifest.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(snapshot_dir, DataCacheSnapshot.MANIFEST))

    @staticmethod
    def recover(snapshot_dir: str) -> DataCache:
        with open(os.path.join(snapshot_dir, DataCacheSnapshot.MANIFEST)) as f:
            manifest = json.load(f)
        segments = [
            Segment(path=os.path.join(snapshot_dir, s["file"]),
                    num_rows=s["num_rows"], nbytes=s["nbytes"])
            for s in manifest["segments"]
        ]
        return DataCache(entries=list(segments), num_rows=manifest["num_rows"])


# ---------------------------------------------------------------------------
# Epoch replay (ReplayOperator analog)
# ---------------------------------------------------------------------------


def cache_stream(
    batches: Iterable[Batch],
    directory: Optional[str] = None,
    memory_budget_bytes: Optional[int] = None,
) -> DataCache:
    """Materialise a one-shot batch stream into a replayable cache (epoch
    0 of ``ReplayOperator.java:62-250``)."""
    w = DataCacheWriter(directory, memory_budget_bytes)
    for b in batches:
        w.append(b)
    return w.finish()


def replay(cache: DataCache,
           num_epochs: Optional[int] = None) -> Iterator[Tuple[int, Batch]]:
    """Yield ``(epoch, batch)``, reading the whole cache once per epoch;
    ``num_epochs=None`` replays until the caller stops."""
    if cache.num_batches == 0:
        return
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        for batch in cache.reader():
            yield epoch, batch
        epoch += 1


# ---------------------------------------------------------------------------
# Prefetching device feed
# ---------------------------------------------------------------------------


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array on ``device``: on the card through a pinned staging
    buffer with an asynchronous copy on the current stream (the caching
    host allocator keeps the buffer until that copy completes)."""
    if device.type == "cuda":
        a = np.ascontiguousarray(a)
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        pinned = torch.empty(a.shape, dtype=dtype, pin_memory=True)
        pinned.numpy()[...] = a
        return pinned.to(device, non_blocking=True)
    if not a.flags.writeable:
        a = np.array(a)  # torch.from_numpy wants a writable array
    return torch.from_numpy(np.ascontiguousarray(a))


def device_put(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Every numpy array of ``tree`` (a dict, tuple or list of arrays, or
    one array) as a tensor on ``device`` (default: ``default_device()``);
    other leaves pass as they are."""
    device = default_device() if device is None else device
    if isinstance(tree, dict):
        return {k: device_put(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_put(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        return _upload(tree, device)
    return tree


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """Every tensor of a placed batch: a tensor, a dict/tuple/list of them,
    or a Table of device columns (a padded column's buffer; all five
    tensors of a sorted sparse column)."""
    from flinkml_tpu_torch.table import (
        LazyDeviceColumn,
        PaddedDeviceColumn,
        SortedSparseColumn,
        Table,
    )

    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, Table):
        for name in tree.column_names:
            yield from _tensors(tree._raw_column(name))
    elif isinstance(tree, SortedSparseColumn):
        yield from tree.tensors()
    elif (isinstance(tree, PaddedDeviceColumn)
          and not isinstance(tree, LazyDeviceColumn)):
        yield tree.buf
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


_FEED_END = object()


def _feed_worker(batches: Iterable[Any], place, q: "queue.Queue",
                 stop: threading.Event, err_box: list,
                 stream: Optional[torch.cuda.Stream]) -> None:
    """The feed's producer loop. It holds no reference to the feed, so a
    consumer that drops the feed lets its finalizer stop this thread."""

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    try:
        for b in batches:
            if stop.is_set():
                return
            if stream is None:
                item = (place(b), None)
            else:
                with torch.cuda.stream(stream):
                    placed = place(b)
                    done = torch.cuda.Event()
                    done.record(stream)
                item = (placed, done)
            if not put(item):
                return
    except BaseException as e:  # surfaced, with its traceback, on next()
        err_box.append(e)
    finally:
        put(_FEED_END)


class PrefetchingDeviceFeed:
    """Background host→device pipeline over a batch iterator.

    A worker thread pulls host batches, applies ``place`` (default
    :func:`device_put` to the constructing thread's ``default_device()``;
    a custom ``place`` names its device itself) and parks up to ``depth``
    placed batches in a queue, so the next batch's copy runs under the
    current step.

    On the card the worker runs ``place`` on a CUDA stream of its own (a
    worker thread's copies would otherwise go to its current stream) and
    records an event after each batch; :meth:`__next__` makes the
    consumer's current stream wait on that event, and marks every tensor of
    the batch as used on the consumer's stream (``record_stream``), so the
    caching allocator does not hand its memory out again while the
    consumer's kernels may still read it. The default ``place`` copies from
    pinned host memory, which is what makes a ``non_blocking`` copy
    asynchronous.

    ``wait_s`` is the host time :meth:`__next__` spent waiting for the
    worker (the consumer's feed wait). The feed is a context manager;
    :meth:`close` (idempotent) stops the worker. A raising producer's
    exception is re-raised by every later ``next()``.
    """

    def __init__(self, batches: Iterable[Any], place=None, depth: int = 2,
                 thread_name: str = "device-feed"):
        # Resolved here, in the consumer's thread: the worker thread has
        # no use_device scope of its own.
        device = default_device()
        self._place = place if place is not None else (
            lambda b: device_put(b, device))
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err_box: list = []
        self._stop = threading.Event()
        self._done = False
        self._device = device
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.wait_s = 0.0
        self._thread = threading.Thread(
            target=_feed_worker,
            args=(batches, self._place, self._q, self._stop, self._err_box,
                  stream),
            daemon=True,
            name=thread_name,
        )
        self._thread.start()
        self._finalizer = weakref.finalize(self, self._stop.set)

    def __iter__(self) -> "PrefetchingDeviceFeed":
        return self

    def __next__(self):
        if self._done:
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if item is _FEED_END:
            self._done = True
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        placed, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            for t in _tensors(placed):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
        return placed

    def close(self) -> None:
        """Stop the worker and release queued batches. Idempotent."""
        self._stop.set()
        self._done = True
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "PrefetchingDeviceFeed":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False
