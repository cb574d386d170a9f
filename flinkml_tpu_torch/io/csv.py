"""Numeric-CSV ingest: native multithreaded parser with a pure-Python parse.

The port's counterpart of ``flinkml_tpu.io.csv`` (the same grammar and
results). Companion to :mod:`flinkml_tpu_torch.io.libsvm`: the port's copy
of the parser, ``flinkml_tpu_torch/native/csv_parser.cpp``, is compiled on
demand (:mod:`flinkml_tpu_torch.io._native`), and the pure-Python parse
serves where there is no compiler. The reference reads CSV through Flink's
table connectors, record-at-a-time on the JVM; here the parser splits the
buffer at line boundaries across threads and fills a column-major float64
buffer so each column is a contiguous zero-copy numpy view.

Scope: numeric CSV — every field is a number, empty fields become NaN, no
quoting. Header row auto-detected (any non-numeric field in the first
line).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from flinkml_tpu_torch.io._native import PARSES, compile_and_load
from flinkml_tpu_torch.table import Table


def _declare(lib: ctypes.CDLL) -> None:
    lib.csv_open.restype = ctypes.c_void_p
    lib.csv_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_char,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.csv_fill.restype = ctypes.c_int32
    lib.csv_fill.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float64, flags="F_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.csv_close.restype = None
    lib.csv_close.argtypes = [ctypes.c_void_p]


def _parse_field(token: str) -> float:
    """Shared numeric grammar for fallback + header detection: Python's
    float() minus its '_'-separator extension, matching the native
    parser's from_chars/strtod grammar."""
    if "_" in token:
        raise ValueError(f"invalid numeric field {token!r}")
    return float(token)


def _is_number(token: str) -> bool:
    token = token.strip()
    if not token:
        return True  # empty fields are valid (NaN)
    try:
        _parse_field(token)
        return True
    except ValueError:
        return False


def _split_header(data: bytes, delimiter: str, header) -> Tuple[Optional[List[str]], bytes]:
    """Pop the header line if present; returns (names or None, body)."""
    # First non-blank line decides.
    text_end = data.find(b"\n")
    first = (data if text_end < 0 else data[:text_end]).decode("utf-8", "replace")
    while first.strip() == "" and text_end >= 0:
        data = data[text_end + 1:]
        text_end = data.find(b"\n")
        first = (data if text_end < 0 else data[:text_end]).decode("utf-8", "replace")
    fields = [f.strip() for f in first.rstrip("\r").split(delimiter)]
    has_header = (
        header if isinstance(header, bool)
        else any(not _is_number(f) for f in fields)
    )
    if not has_header:
        return None, data
    body = b"" if text_end < 0 else data[text_end + 1:]
    return fields, body


def read_csv(
    source: Union[str, bytes],
    delimiter: str = ",",
    header: Union[bool, str] = "auto",
    n_threads: Optional[int] = None,
    use_native: bool = True,
) -> Tuple[Optional[List[str]], np.ndarray]:
    """Parse numeric CSV.

    Args:
        source: file path, or raw bytes of CSV content.
        header: True/False, or "auto" (non-numeric first line = header).
    Returns:
        ``(names or None, data)`` with ``data`` float64 ``[rows, cols]``,
        column-major (each ``data[:, j]`` is contiguous).
    """
    if isinstance(source, bytes):
        data = source
    else:
        with open(source, "rb") as f:
            data = f.read()
    if len(delimiter.encode()) != 1:
        raise ValueError(
            f"delimiter must be one single-byte char, got {delimiter!r}"
        )
    names, body = _split_header(data, delimiter, header)
    if not body.strip():
        cols = len(names) if names else 0
        return names, np.empty((0, cols), dtype=np.float64, order="F")

    lib = compile_and_load("csv_parser", _declare) if use_native else None
    if lib is not None:
        mat = _parse_native(lib, body, delimiter, n_threads)
        PARSES["csv", "native"] += 1
    else:
        mat = _parse_python(body, delimiter)
        PARSES["csv", "python"] += 1
    if names is not None and mat.shape[1] != len(names):
        raise ValueError(
            f"header has {len(names)} columns but data rows have {mat.shape[1]}"
        )
    return names, mat


def read_csv_table(
    source: Union[str, bytes],
    delimiter: str = ",",
    header: Union[bool, str] = "auto",
    n_threads: Optional[int] = None,
    use_native: bool = True,
) -> Table:
    """Parse numeric CSV straight into a :class:`Table` (zero-copy column
    views). Without a header, columns are named ``c0..c{n-1}``."""
    names, mat = read_csv(source, delimiter, header, n_threads, use_native)
    if names is None:
        names = [f"c{i}" for i in range(mat.shape[1])]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate header column names: {dupes}")
    return Table({name: mat[:, j] for j, name in enumerate(names)})


def _parse_native(lib, body: bytes, delimiter: str, n_threads) -> np.ndarray:
    n_threads = n_threads or min(os.cpu_count() or 1, 16)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    bad = ctypes.c_int64()
    status = ctypes.c_int32()
    handle = lib.csv_open(
        body, len(body), n_threads, delimiter.encode()[0],
        ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(bad),
        ctypes.byref(status),
    )
    try:
        if status.value == 1:
            raise ValueError(
                f"CSV row {bad.value} has a different field count than row 0"
            )
        if status.value == 2 or rows.value == 0:
            return np.empty((0, max(cols.value, 0)), dtype=np.float64, order="F")
        out = np.empty((rows.value, cols.value), dtype=np.float64, order="F")
        rc = lib.csv_fill(handle, out, ctypes.byref(bad))
        if rc != 0:
            raise ValueError(f"CSV row {bad.value} has a malformed numeric field")
        return out
    finally:
        lib.csv_close(handle)


def _parse_python(body: bytes, delimiter: str) -> np.ndarray:
    """The pure-Python parse; same contract as the native parser."""
    rows: List[List[float]] = []
    ncols = -1
    for raw in body.decode("utf-8").split("\n"):
        line = raw.rstrip("\r")
        if not line.strip():
            continue
        fields = line.split(delimiter)
        if ncols < 0:
            ncols = len(fields)
        elif len(fields) != ncols:
            raise ValueError(
                f"CSV row {len(rows)} has a different field count than row 0"
            )
        vals = []
        for f in fields:
            f = f.strip()
            if not f:
                vals.append(float("nan"))
            else:
                try:
                    vals.append(_parse_field(f))
                except ValueError:
                    raise ValueError(
                        f"CSV row {len(rows)} has a malformed numeric field"
                    ) from None
        rows.append(vals)
    if not rows:
        return np.empty((0, 0), dtype=np.float64, order="F")
    return np.asarray(rows, dtype=np.float64, order="F")
