"""Async host→device prefetch into the fused executor's row buckets.

The port's counterpart of ``flinkml_tpu.data.prefetch``. The tail of a
:class:`~flinkml_tpu_torch.data.Dataset` chain: a worker thread pulls host
Tables, zero-pads every dense column to the fused executor's power-of-two
row bucket (:func:`flinkml_tpu_torch.pipeline_fusion.row_bucket`),
uploads the padded buffers, and parks up to ``depth`` device-resident
Tables in a bounded queue. With ``depth >= 2`` the next batch's copy runs
under the current step's compute (double buffering).

The emitted Tables carry :class:`~flinkml_tpu_torch.table.
PaddedDeviceColumn` columns whose buffers are EXACTLY bucket-height, with
the logical row count kept on the column; an object column of
``SparseVector`` rows becomes a :class:`~flinkml_tpu_torch.table.
SortedSparseColumn` (padded ELL plus the pack-time sort tables, built here
on the worker thread, so the sort overlaps the consumer's steps).

The queue, worker and lifecycle machinery is the port's
:class:`~flinkml_tpu_torch.iteration.datacache.PrefetchingDeviceFeed`: on
the card the worker uploads on a CUDA stream of its own and records an
event per batch, and the consumer's stream waits on it; every tensor of a
delivered Table — each padded column's buffer, and all five tensors of a
sorted sparse column (``buf``, ``indices``, ``indptr``, ``perm``,
``segment_ids``) — is marked used on the consumer's stream
(``record_stream``). This class adds the bucket padding and the metrics.

Metrics (``utils.metrics.default_registry()``, group ``data.prefetch``
by default): ``queue_depth`` / ``stall_fraction`` / ``rows_per_sec``
gauges and the ``batches_prefetched`` / ``rows_prefetched`` counters.
The worker fires the ``data.prefetch`` fault seam
(:mod:`flinkml_tpu_torch.faults`) before each placement: a raise there
stops the worker and reaches the consumer's ``next()`` with the worker's
traceback; a delay models a slow producer.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Optional

import numpy as np

from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.iteration.datacache import (
    PrefetchingDeviceFeed,
    device_put,
)
from flinkml_tpu_torch.table import PaddedDeviceColumn, Table


def _default_place(device) -> Callable[[Any], Any]:
    """Upload a numpy array (or a dict/tuple/list of them) to ``device``."""

    def place(a):
        return device_put(a, device)

    return place


def pad_place_table(table: Table, place=None) -> Table:
    """Pad ``table``'s dense columns to their power-of-two row bucket and
    upload each (``place``: one numpy array to a tensor; default: to
    ``default_device()``) as a bucket-height :class:`~flinkml_tpu_torch.
    table.PaddedDeviceColumn` with the logical row count kept and the
    dtype preserved exactly. Object columns whose rows are all
    ``SparseVector`` become bucket-height :class:`~flinkml_tpu_torch.table.
    SortedSparseColumn` s (:func:`~flinkml_tpu_torch.ops.sparse.
    pack_sorted_sparse_column`); other object (ragged) columns stay on the
    host."""
    from flinkml_tpu_torch.linalg import SparseVector
    from flinkml_tpu_torch.ops.sparse import pack_sorted_sparse_column
    from flinkml_tpu_torch.pipeline_fusion import row_bucket

    if place is None:
        place = _default_place(default_device())
    n = table.num_rows
    bucket = row_bucket(n)
    cols = {}
    for name in table.column_names:
        arr = table.column(name)
        if arr.dtype == object:
            if n and all(isinstance(v, SparseVector) for v in arr):
                cols[name] = pack_sorted_sparse_column(arr, bucket=bucket,
                                                       place=place)
            else:
                cols[name] = arr
            continue
        pad = bucket - n
        if pad:
            arr = np.concatenate(
                [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)]
            )
        cols[name] = PaddedDeviceColumn(place(arr), n)
    return Table(cols)


class DevicePrefetcher(PrefetchingDeviceFeed):
    """Double-buffered bounded-queue async host→device feed over a batch
    iterator, bucket-padding Tables (see module docstring). Iterate it;
    ``close()`` (or the ``with`` block, or the collection of an abandoned
    handle) stops the worker."""

    def __init__(self, batches: Iterable[Any], depth: int = 2, place=None,
                 metrics_group: str = "data.prefetch"):
        from flinkml_tpu_torch.utils.metrics import default_registry

        group = (
            default_registry().group(metrics_group) if metrics_group else None
        )
        self._group = group
        self._stalled_s = 0.0
        self._consume_t0: Optional[float] = None
        self._rows_out = 0.0
        # Resolved here, in the consumer's thread: the worker thread has no
        # use_device scope of its own.
        if place is None:
            place = _default_place(default_device())

        reads = [0]

        def pad_and_place(batch):
            # Runs on the worker thread: the fault seam, bucket pad,
            # upload, counters.
            from flinkml_tpu_torch import faults

            reads[0] += 1
            if faults.ACTIVE is not None:  # a scripted producer failure
                faults.fire("data.prefetch", read=reads[0])
            if isinstance(batch, Table):
                placed = pad_place_table(batch, place)
                if group is not None:
                    group.counter("batches_prefetched")
                    group.counter("rows_prefetched", float(batch.num_rows))
                return placed
            if group is not None:
                group.counter("batches_prefetched")
            return place(batch)

        super().__init__(batches, place=pad_and_place, depth=depth,
                         thread_name="data-prefetch")

    def __next__(self):
        t0 = time.perf_counter()
        if self._consume_t0 is None:
            self._consume_t0 = t0
        try:
            item = super().__next__()
        finally:
            now = time.perf_counter()
            self._stalled_s += now - t0
            if self._group is not None:
                self._group.gauge("queue_depth", self._q.qsize())
                elapsed = now - self._consume_t0
                if elapsed > 0:
                    self._group.gauge(
                        "stall_fraction", self._stalled_s / elapsed
                    )
        if self._group is not None and isinstance(item, Table):
            self._rows_out += item.num_rows
            elapsed = time.perf_counter() - self._consume_t0
            if elapsed > 0:
                self._group.gauge("rows_per_sec", self._rows_out / elapsed)
        return item

    @property
    def stall_fraction(self) -> float:
        """Fraction of the consumer's wall clock spent blocked on the
        queue — the "is the producer keeping up" number."""
        if self._consume_t0 is None:
            return 0.0
        elapsed = time.perf_counter() - self._consume_t0
        return self._stalled_s / elapsed if elapsed > 0 else 0.0
