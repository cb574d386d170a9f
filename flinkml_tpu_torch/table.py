"""Columnar Table over numpy arrays and torch tensors.

The port's counterpart of ``flinkml_tpu.table``: each column is an array
with leading axis = rows (feature columns are 2-D ``[rows, dim]``), held in
one of two homes:

  - **host**: a numpy array (the ingest format, and the only home for
    object/ragged columns such as ``SparseVector`` rows);
  - **device**: a ``torch.Tensor`` on the compute device — the output format
    of the per-stage transforms and of the fused pipeline executor
    (:mod:`flinkml_tpu_torch.pipeline_fusion`), which keeps intermediate
    columns on the device across stage boundaries.

The relational ops (``select`` / ``with_column`` / ``drop`` / ``rename``)
rebind buffers under new names without touching the host. ``column(name)``
takes the host copy of a device column (cached after the first fetch);
``device_column(name)`` hands back the device tensor, uploading a host
column on first use (also cached, per device). Row-indexed ops (``take`` /
``slice`` / ``concat`` / ``to_rows``) operate on the host representation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional

import numpy as np
import torch

from flinkml_tpu_torch.device import default_device


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array. numpy has no bfloat16: a bfloat16
    tensor comes back as float32 holding exactly its values."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


class PaddedDeviceColumn:
    """A device-resident column whose backing tensor carries extra padding
    rows beyond the column's logical row count.

    The fused pipeline executor computes on row-bucket-padded buffers;
    wrapping its outputs instead of slicing them keeps result construction
    free of device work. Rows past ``rows`` are unspecified; every consumer
    goes through :meth:`Table.column` / :meth:`Table.device_column`, which
    slice.
    """

    __slots__ = ("buf", "rows")

    def __init__(self, buf: torch.Tensor, rows: int):
        if buf.shape[0] < rows:
            raise ValueError(
                f"padded buffer has {buf.shape[0]} rows < logical {rows}"
            )
        self.buf = buf
        self.rows = int(rows)

    @property
    def shape(self):
        return (self.rows,) + tuple(self.buf.shape[1:])

    @property
    def ndim(self) -> int:
        return self.buf.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.buf.dtype

    def to_host(self) -> np.ndarray:
        """The logical rows as a host numpy array (one device→host copy;
        :meth:`Table.column` caches the result per table)."""
        return to_numpy(self.buf[: self.rows])


class LazyDeviceColumn(PaddedDeviceColumn):
    """A :class:`PaddedDeviceColumn` whose buffer is not computed yet.

    The fused executor computes only a run's *eager* columns; an
    intermediate consumed inside the run is wrapped here with a thunk that,
    on first access, runs the chain truncated at that column. Shape and
    dtype are known up front (the executor's spec pass), so
    table construction and relational ops never trigger the compute.
    """

    __slots__ = ("_thunk", "_buf", "_padded_shape", "_dtype")

    def __init__(self, thunk: Callable[[], torch.Tensor], rows: int,
                 padded_shape, dtype: torch.dtype):
        if padded_shape[0] < rows:
            raise ValueError(
                f"padded buffer has {padded_shape[0]} rows < logical {rows}"
            )
        self._thunk = thunk
        self._buf = None
        self._padded_shape = tuple(padded_shape)
        self._dtype = dtype
        self.rows = int(rows)

    @property
    def buf(self) -> torch.Tensor:
        if self._buf is None:
            self._buf = self._thunk()
            self._thunk = None
        return self._buf

    @property
    def shape(self):
        return (self.rows,) + self._padded_shape[1:]

    @property
    def ndim(self) -> int:
        return len(self._padded_shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype


class SortedSparseColumn(PaddedDeviceColumn):
    """A device-resident SPARSE column in the pipeline's sorted layout
    (``flinkml_tpu.table.SortedSparseColumn``): padded-ELL blocks
    zero-padded to the row bucket, CSR ``indptr``, and the pack-time
    global sort tables that let the gradient scatter run the sorted
    ``segment_sum`` with no sort at step time:

    - ``buf``         — ``[bucket, width]`` float values (the inherited
      padded buffer; ``width`` is a power of two);
    - ``indices``     — ``[bucket, width]`` int32 column ids, ascending
      within a row; padding cells carry index 0 / value 0 (exact no-ops);
    - ``indptr``      — ``[bucket + 1]`` int32 CSR row pointers over the
      logical nnz (padding rows contribute 0);
    - ``perm`` / ``segment_ids`` — ``[bucket * width]`` int32: a stable
      argsort of the flat index block and the ids in that order, computed
      once on the prefetch worker. A consumer's scatter is
      ``segment_sum(contrib.index_select(0, perm), segment_ids, dim,
      indices_are_sorted=True)``.

    ``indices_are_sorted`` is recorded on the column: the packer sorts,
    the consumer reads the attribute. The padding cells sort to the front
    as segment 0's no-op adds, so the tables cover the FULL padded block,
    as the JAX column's do: the sorted sum then adds in the JAX kernel's
    order.
    """

    __slots__ = ("indices", "indptr", "perm", "segment_ids", "dim",
                 "indices_are_sorted", "_host_rows")

    def __init__(self, values: torch.Tensor, indices: torch.Tensor,
                 indptr: torch.Tensor, perm: torch.Tensor,
                 segment_ids: torch.Tensor, dim: int, rows: int,
                 host_rows: Optional[np.ndarray] = None):
        super().__init__(values, rows)
        if tuple(indices.shape) != tuple(values.shape):
            raise ValueError(
                f"indices shape {tuple(indices.shape)} != values shape "
                f"{tuple(values.shape)}"
            )
        bucket, width = values.shape
        if tuple(indptr.shape) != (bucket + 1,):
            raise ValueError(
                f"indptr shape {tuple(indptr.shape)} != ({bucket + 1},)"
            )
        if tuple(perm.shape) != (bucket * width,) or \
                tuple(segment_ids.shape) != (bucket * width,):
            raise ValueError(
                "perm/segment_ids must be flat [bucket * width] tables"
            )
        self.indices = indices
        self.indptr = indptr
        self.perm = perm
        self.segment_ids = segment_ids
        self.dim = int(dim)
        self.indices_are_sorted = True
        self._host_rows = host_rows

    def tensors(self) -> tuple:
        """The column's five tensors: ``(buf, indices, indptr, perm,
        segment_ids)``."""
        return (self.buf, self.indices, self.indptr, self.perm,
                self.segment_ids)

    def to_host(self) -> np.ndarray:
        """The logical rows as the object array of ``SparseVector``s the
        column was packed from (kept by the packer; rebuilt from the CSR
        blocks for a column built on the device)."""
        if self._host_rows is not None:
            return self._host_rows
        from flinkml_tpu_torch.linalg import SparseVector

        vals = to_numpy(self.buf)
        idx = self.indices.cpu().numpy()
        ptr = self.indptr.cpu().numpy()
        out = np.empty(self.rows, dtype=object)
        for r in range(self.rows):
            k = int(ptr[r + 1] - ptr[r])
            # A column built without the true per-row nnz counts every ELL
            # cell, so index-0 padding repeats: fold repeats by sum (the
            # no-op padding makes that exact).
            ui, inv = np.unique(idx[r, :k], return_inverse=True)
            uv = np.zeros(ui.size, dtype=np.float64)
            np.add.at(uv, inv, vals[r, :k].astype(np.float64))
            out[r] = SparseVector._from_sorted(self.dim, ui.astype(np.int64),
                                               uv)
        self._host_rows = out
        return out


def _is_device_backed(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, PaddedDeviceColumn))


class Table:
    """Immutable named-column container backed by host numpy arrays and/or
    device-resident ``torch.Tensor`` columns.

    All columns share the same leading dimension (row count). Columns may be:
      - 1-D arrays (scalar columns: labels, weights, categories),
      - N-D arrays (vector/matrix columns: features ``[rows, dim]``),
      - object arrays (ragged data, e.g. sparse vectors),
      - ``torch.Tensor`` buffers (device-resident columns).
    """

    def __init__(self, columns: Mapping[str, Any]):
        if not columns:
            raise ValueError("Table requires at least one column")
        conv: Dict[str, Any] = {}
        n_rows: Optional[int] = None
        for name, col in columns.items():
            if isinstance(col, np.ndarray) or _is_device_backed(col):
                arr = col
            else:
                arr = _to_array(col)
            if arr.ndim == 0:
                arr = arr.reshape(1)
            if n_rows is None:
                n_rows = arr.shape[0]
            elif arr.shape[0] != n_rows:
                raise ValueError(
                    f"Column {name!r} has {arr.shape[0]} rows, expected {n_rows}"
                )
            conv[name] = arr
        self._columns = conv
        self._num_rows = int(n_rows or 0)
        # Per-home caches: a device column fetched to host (or a host
        # column uploaded to a device) is converted at most once per Table.
        self._host_cache: Dict[str, np.ndarray] = {}
        self._device_cache: Dict[tuple, torch.Tensor] = {}

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_columns(**columns: Any) -> "Table":
        return Table(columns)

    @staticmethod
    def from_rows(rows: Iterable[Mapping[str, Any]]) -> "Table":
        rows = list(rows)
        if not rows:
            raise ValueError("Table.from_rows requires at least one row")
        names = list(rows[0].keys())
        return Table({n: _to_array([r[n] for r in rows]) for n in names})

    # -- schema ------------------------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def _raw_column(self, name: str) -> Any:
        if name not in self._columns:
            raise KeyError(
                f"Column {name!r} not in table (has {self.column_names})"
            )
        return self._columns[name]

    def is_device_resident(self, name: str) -> bool:
        """True when the column's backing buffer is a tensor."""
        return _is_device_backed(self._raw_column(name))

    def has_device_copy(self, name: str, device=None) -> bool:
        """Whether the column is device-backed or already uploaded to
        ``device`` (default: :func:`~flinkml_tpu_torch.device.
        default_device`) — whether reading it there costs no host→device
        copy."""
        if self.is_device_resident(name):
            return True
        dev = str(torch.device(device) if device is not None
                  else default_device())
        return any(key[0] == name and key[-1] == dev
                   for key in self._device_cache)

    def column(self, name: str) -> np.ndarray:
        """The column as a host numpy array; a device column is copied to
        the host HERE (once, cached, counted in the ``table`` metric
        group's ``device_to_host_materializations``)."""
        col = self._raw_column(name)
        if not _is_device_backed(col):
            return col
        if name not in self._host_cache:
            if isinstance(col, PaddedDeviceColumn):
                host = col.to_host()
            else:
                host = to_numpy(col)
            from flinkml_tpu_torch.utils.metrics import metrics

            group = metrics.group("table")
            group.counter("device_to_host_materializations")
            group.counter("device_to_host_bytes", float(host.nbytes))
            self._host_cache[name] = host
        return self._host_cache[name]

    __getitem__ = column

    def device_column(self, name: str, device=None) -> torch.Tensor:
        """The column as a tensor on ``device`` (default:
        :func:`~flinkml_tpu_torch.device.default_device`) — no copy for a
        column already there; host columns upload on first use (cached).
        Object (ragged) columns have no device representation and raise."""
        device = torch.device(device) if device is not None else default_device()
        key = (name, str(device))
        if key in self._device_cache:
            return self._device_cache[key]
        col = self._raw_column(name)
        if isinstance(col, PaddedDeviceColumn):
            t = col.buf[: col.rows]
        elif isinstance(col, torch.Tensor):
            t = col
        else:
            if col.dtype == object:
                raise TypeError(
                    f"Column {name!r} is an object (ragged) column; it has "
                    "no device representation"
                )
            # Uploads preserve the host dtype exactly: the fused executor's
            # parity contract depends on the device copy being the same
            # bits as the host column.
            t = torch.from_numpy(np.ascontiguousarray(col))
        t = t.to(device)
        self._device_cache[key] = t
        return t

    def device_column_padded(self, name: str, rows: int, device=None) -> torch.Tensor:
        """:meth:`device_column` zero-padded to ``rows`` rows on ``device``,
        cached per ``(column, rows, device)`` — the fused executor's ingest
        path. Only the logical rows cross the bus; the padding is zeroed on
        the device."""
        device = torch.device(device) if device is not None else default_device()
        key = (name, int(rows), str(device))
        if key not in self._device_cache:
            raw = self._raw_column(name)
            if (isinstance(raw, PaddedDeviceColumn)
                    and raw.buf.shape[0] == rows and raw.buf.device == device):
                # A fused output re-entering a fused run at the same
                # bucket: hand the padded buffer straight through.
                self._device_cache[key] = raw.buf
            else:
                arr = self.device_column(name, device)
                if int(rows) > arr.shape[0]:
                    buf = torch.empty((int(rows),) + tuple(arr.shape[1:]),
                                      dtype=arr.dtype, device=device)
                    buf[: arr.shape[0]].copy_(arr)
                    buf[arr.shape[0]:].zero_()
                    arr = buf
                self._device_cache[key] = arr
        return self._device_cache[key]

    # -- relational ops ----------------------------------------------------
    def select(self, *names: str) -> "Table":
        return Table({n: self._raw_column(n) for n in names})

    def with_column(self, name: str, values: Any) -> "Table":
        cols = dict(self._columns)
        if isinstance(values, np.ndarray) or _is_device_backed(values):
            cols[name] = values
        else:
            cols[name] = _to_array(values)
        return Table(cols)

    def drop(self, *names: str) -> "Table":
        return Table({n: c for n, c in self._columns.items() if n not in names})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self._columns.items()})

    # Row-indexed ops operate on the host representation.
    def take(self, indices: np.ndarray) -> "Table":
        return Table({n: self.column(n)[indices] for n in self._columns})

    def slice(self, start: int, stop: int) -> "Table":
        return Table({n: self.column(n)[start:stop] for n in self._columns})

    def concat(self, other: "Table") -> "Table":
        if set(self.column_names) != set(other.column_names):
            raise ValueError("concat requires identical column sets")
        return Table({
            n: np.concatenate([self.column(n), other.column(n)])
            for n in self.column_names
        })

    # -- iteration ---------------------------------------------------------
    def batches(self, batch_size: int, drop_remainder: bool = False) -> Iterator["Table"]:
        """Yield consecutive row slices of at most ``batch_size`` rows."""
        n = self._num_rows
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for start in range(0, stop, batch_size):
            yield self.slice(start, min(start + batch_size, n))

    def to_rows(self) -> List[Dict[str, Any]]:
        return [
            {n: self.column(n)[i] for n in self._columns}
            for i in range(self._num_rows)
        ]

    def __repr__(self) -> str:  # pragma: no cover
        cols = ", ".join(
            f"{n}:{c.dtype}{list(c.shape[1:])}"
            f"{'@device' if _is_device_backed(c) else ''}"
            for n, c in self._columns.items()
        )
        return f"Table[{self._num_rows} rows; {cols}]"


def _to_array(values: Any) -> np.ndarray:
    """Convert a python sequence to a numpy column, keeping ragged data as object."""
    try:
        arr = np.asarray(values)
        if arr.dtype == object and arr.ndim == 0:
            arr = np.asarray([values])
    except ValueError:
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = v
        return arr
    if arr.dtype == object:
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    return arr
