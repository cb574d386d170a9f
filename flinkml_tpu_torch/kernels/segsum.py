"""Segment sum — the sparse gradient scatter-accumulate.

Replaces ``flinkml_tpu/kernels/segsum.py:222 pallas_segment_sum``:
``out[ids[j]] += values[j]`` into a zeroed ``[num_segments]`` output
(``values [cells]``), or ``[num_segments, k]`` for the row payload
(``values [cells, k]``).

:func:`segment_sum` is the wrapper: for tensors on the CPU it computes the
plain PyTorch version :func:`segment_sum_plain`; for CUDA tensors it
launches the hand-written kernel ``csrc/segsum.cu`` or raises
:class:`~flinkml_tpu_torch.kernels.KernelUnsupportedError`. Two device
paths, chosen by ``indices_are_sorted`` as in the JAX API:

- unsorted: fire-and-forget reductions (``RED``) into a zeroed output, a
  grid-stride loop of one per cell (flat), or one vector reduction per 4
  or 2 float32 payload columns (``[cells, k]``). The adds land in an order
  that changes from run to run, so the result equals the in-order sum
  within rounding only; refused under
  ``torch.use_deterministic_algorithms(True)``.
- sorted (ids ascending): a run-flush that sums each run left to right and
  stores it once — deterministic, and in the JAX kernel's addition order —
  and writes every output element exactly once (the gaps between runs as
  zeros), so its output is allocated with ``torch.empty``.
  :func:`sorted_plan` is the kernel's ownership rule in Python.

Zero cells or zero segments return zeros without a launch, as the JAX
dispatcher does. The kernel trusts ``0 <= ids < num_segments``: the host
packers check the indices before upload
(:func:`flinkml_tpu_torch.ops.sparse.pack_ell_buckets`). Unlike the Pallas
kernel, the output lives in device memory, so there is no VMEM ceiling on
``num_segments * k``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.kernels import _build, _gate
from flinkml_tpu_torch.kernels.spmv import vector_phase

#: Value types the CUDA kernel takes (ids are int32).
SUPPORTED_DTYPES = (torch.float32, torch.float64)

LAUNCHES = _gate.launch_counter("segment_sum")

#: The sorted flat kernel's tile: 256 threads own 8 consecutive cells each
#: (``csrc/segsum.cu`` kOwn, kTile).
SORTED_OWN = 8
SORTED_TILE = 256 * SORTED_OWN
#: Cells per owner of the sorted ``[cells, k]`` kernel (kChunk).
SORTED_CHUNK = 16

_ARGTYPES = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,    # sorted, values, ids
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # cells, k, num_segments
    ctypes.c_int, ctypes.c_int,                        # phase, vec
    ctypes.c_void_p, ctypes.c_void_p,                  # out, stream
]
_SYMBOLS = {torch.float32: "fml_segsum_f32", torch.float64: "fml_segsum_f64"}
_INT32_LIMIT = 2**31


def _zeros(values: torch.Tensor, num_segments: int) -> torch.Tensor:
    return torch.zeros((num_segments,) + tuple(values.shape[1:]),
                       dtype=values.dtype, device=values.device)


def segment_sum_plain(values: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` into zeros."""
    return _zeros(values, num_segments).index_add_(0, ids.long(), values)


def unsupported_reason(values, ids, num_segments: int,
                       indices_are_sorted: bool = False) -> Optional[str]:
    """Why the CUDA kernel cannot run these operands (None = it can)."""
    if values.dim() not in (1, 2):
        return f"values must be [cells] or [cells, k], got rank {values.dim()}"
    if ids.dim() != 1:
        return f"ids must be [cells], got rank {ids.dim()}"
    if values.shape[0] != ids.shape[0]:
        return f"values rows {values.shape[0]} != ids rows {ids.shape[0]}"
    if ids.dtype != torch.int32:
        return f"ids dtype {ids.dtype} is not int32"
    if values.dtype not in SUPPORTED_DTYPES:
        return (f"values dtype {values.dtype} is not supported (supported: "
                "float32, float64)")
    if values.device != ids.device:
        return f"values on {values.device} but ids on {ids.device}"
    if num_segments < 0:
        return f"num_segments must be >= 0, got {num_segments}"
    k = 1 if values.dim() == 1 else values.shape[1]
    if values.shape[0] * k >= _INT32_LIMIT or num_segments * k >= _INT32_LIMIT:
        return (f"cells*k = {values.shape[0] * k} or num_segments*k = "
                f"{num_segments * k} does not fit a 32-bit int")
    if not indices_are_sorted and torch.are_deterministic_algorithms_enabled():
        return ("the unsorted path adds with atomics in a run-dependent "
                "order, and torch.use_deterministic_algorithms(True) is on; "
                "sort the ids and pass indices_are_sorted=True (the sparse "
                "trainer's layout=\"sorted\")")
    return None


def payload_vector(values: torch.Tensor) -> int:
    """Payload columns per vector load and reduction on the unsorted
    ``[cells, k]`` path: 4 (float32) or 2 when ``k`` and the values' base
    alignment allow 16- or 8-byte accesses, else 1. float64 has no vector
    reduction, only the 16-byte load of 2 columns."""
    k, item, ptr = values.shape[1], values.element_size(), values.data_ptr()
    for vec in ((4, 2) if item == 4 else (2,)):
        if k % vec == 0 and ptr % (vec * item) == 0:
            return vec
    return 1


def sorted_tile_bases(cells: int, phase: int) -> List[int]:
    """First cell of every tile of the sorted flat kernel: tiles of
    :data:`SORTED_TILE` cells start on the 16-byte ``phase`` (the first one
    up to 3 cells before cell 0), or at cell 0 when no phase aligns
    (``phase < 0``)."""
    base0 = phase - 4 if phase > 0 else 0
    return list(range(base0, cells, SORTED_TILE))


def sorted_plan(ids: np.ndarray, num_segments: int, k: int = 1,
                phase: int = 0) -> List[Tuple[int, int, int, int]]:
    """The sorted kernel's writes, computed by its own rules: a list of
    ``(segment, writer, first, end)``, one per output segment the kernel
    stores (each of its ``k`` columns by the same writer). ``writer`` is
    the owner (flat: tile * 256 + thread, each owning
    :data:`SORTED_OWN` cells of its tile; ``[cells, k]``: the chunk of
    :data:`SORTED_CHUNK` cells), or -1 for the segments before ``ids[0]``
    and after ``ids[-1]``, which the whole grid zeroes. The segment's value
    is ``0 + v[first] + ... + v[end - 1]`` in cell order (``first == end``:
    a zero).

    A run of equal ids belongs to the owner of its first cell, which sums
    it (reading past its own cells when the run goes on) and zeroes the
    segments between the previous cell's id and the run's."""
    ids = np.asarray(ids)
    cells = ids.size
    if cells == 0:
        return []
    writes = [(s, -1, 0, 0) for s in range(int(ids[0]))]
    writes += [(s, -1, 0, 0) for s in range(int(ids[-1]) + 1, num_segments)]
    if k == 1:
        owners = [(b + SORTED_OWN * t, b + SORTED_OWN * (t + 1))
                  for b in sorted_tile_bases(cells, phase)
                  for t in range(SORTED_TILE // SORTED_OWN)]
    else:
        owners = [(lo, lo + SORTED_CHUNK)
                  for lo in range(0, cells, SORTED_CHUNK)]
    for writer, (lo, hi) in enumerate(owners):
        lo, hi = max(lo, 0), min(hi, cells)
        for c in range(lo, hi):
            if c > 0 and ids[c] == ids[c - 1]:
                continue          # not a run start: its owner is earlier
            seg = int(ids[c])
            if c > 0:
                writes += [(s, writer, c, c)
                           for s in range(int(ids[c - 1]) + 1, seg)]
            end = c + 1
            while end < cells and ids[end] == seg:
                end += 1
            writes.append((seg, writer, c, end))
    return writes


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                *, indices_are_sorted: bool = False) -> torch.Tensor:
    """``out[ids[j]] += values[j]`` into zeros ``[num_segments(, k)]``:
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (unsupported operands raise ``KernelUnsupportedError``).
    ``indices_are_sorted=True`` promises ascending ``ids`` and takes the
    deterministic run-flush path."""
    if values.device.type == "cpu":
        return segment_sum_plain(values, ids, num_segments)
    if values.device.type != "cuda":
        raise _gate.refuse("segment_sum", f"device {values.device} is not CUDA")
    reason = unsupported_reason(values, ids, num_segments, indices_are_sorted)
    if reason is not None:
        raise _gate.refuse("segment_sum", reason)
    if values.numel() == 0 or num_segments == 0:
        return _zeros(values, num_segments)
    values = values.contiguous()
    ids = ids.contiguous()
    cells = values.shape[0]
    k = 1 if values.dim() == 1 else values.shape[1]
    shape = (num_segments,) + tuple(values.shape[1:])
    # The sorted path writes every element; the atomics add into zeros.
    new = torch.empty if indices_are_sorted else torch.zeros
    out = new(shape, dtype=values.dtype, device=values.device)
    # The 16-byte phase of ids and values: the sorted flat kernel's tiles.
    sorted_flat = indices_are_sorted and k == 1
    phase = vector_phase(ids, values) if sorted_flat else -1
    vec = payload_vector(values) if k > 1 else 1
    fn = _build.function("segsum", _SYMBOLS[values.dtype], _ARGTYPES)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = fn(int(indices_are_sorted), values.data_ptr(), ids.data_ptr(),
                  cells, k, num_segments, phase, vec, out.data_ptr(), stream)
    _build.check("segment_sum", "segsum", code)
    LAUNCHES.bump()
    return out
