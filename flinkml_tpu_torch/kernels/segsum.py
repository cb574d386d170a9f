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
  zeros), so its output is allocated with ``torch.empty``. Ids that do not
  ascend still give the sum into zeros, as the Pallas kernel and
  ``index_add_`` do: the kernel flags a descent as it reads the ids, and a
  one-block repair kernel launched after it on the same stream recomputes
  the whole output with atomics when the flag is set (a run-dependent
  order, and no faster than one block), and does nothing otherwise. No
  host sync: a per-stream work area of one int (:func:`_work_area`)
  carries the flag, and each call leaves it zeroed. :func:`sorted_plan`
  is the kernel's write rule in Python.

Zero cells or zero segments return zeros without a launch, as the JAX
dispatcher does. The kernel trusts ``0 <= ids < num_segments``: the host
packers check the indices before upload
(:func:`flinkml_tpu_torch.ops.sparse.pack_ell_buckets`). Unlike the Pallas
kernel, the output lives in device memory, so there is no VMEM ceiling on
``num_segments * k``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.kernels import _build, _gate
from flinkml_tpu_torch.kernels.spmv import vector_phase

#: Value types the CUDA kernel takes (ids are int32; bfloat16 adds round
#: at each add, as the Pallas kernel's).
SUPPORTED_DTYPES = (torch.float32, torch.float64, torch.bfloat16)

LAUNCHES = _gate.launch_counter("segment_sum")

#: The sorted flat kernel's tile: 256 threads own 8 consecutive cells each
#: (``csrc/segsum.cu`` kOwn, kTile).
SORTED_OWN = 8
SORTED_TILE = 256 * SORTED_OWN
#: Cells per owner of the sorted ``[cells, k]`` kernel (kChunk).
SORTED_CHUNK = 16

#: ``sorted_plan``'s writer of a segment the repair pass recomputes.
REPAIR = -2

_ARGTYPES = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,    # sorted, values, ids
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # cells, k, num_segments
    ctypes.c_int, ctypes.c_int,                        # phase, vec
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out, work, stream
]
_SYMBOLS = {torch.float32: "fml_segsum_f32", torch.float64: "fml_segsum_f64",
            torch.bfloat16: "fml_segsum_bf16"}
_INT32_LIMIT = 2**31


_WORK: Dict[Tuple[int, int], torch.Tensor] = {}


def _work_area(device: torch.device, stream: int) -> torch.Tensor:
    """The sorted kernels' zeroed int32 descent flag for launches on
    ``stream``: zeroed once when made, and left zeroed by every call, so
    calls on one stream share it in turn."""
    key = (device.index, stream)
    work = _WORK.get(key)
    if work is None:
        work = _WORK.setdefault(
            key, torch.zeros(1, dtype=torch.int32, device=device))
    return work


def _zeros(values: torch.Tensor, num_segments: int) -> torch.Tensor:
    return torch.zeros((num_segments,) + tuple(values.shape[1:]),
                       dtype=values.dtype, device=values.device)


def segment_sum_plain(values: torch.Tensor, ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` into zeros (on the CPU it
    adds in cell order, rounding each add at the values' dtype; a bfloat16
    ``[cells, k]`` payload goes through the flat form, whose adds keep that
    order)."""
    if values.dtype == torch.bfloat16 and values.dim() == 2:
        k = values.shape[1]
        flat = (ids.long()[:, None] * k
                + torch.arange(k, device=ids.device)).reshape(-1)
        return _zeros(values, num_segments).view(-1).index_add_(
            0, flat, values.reshape(-1)).view(num_segments, k)
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
                "float32, float64, bfloat16)")
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
    alignment allow 16- or 8-byte accesses (bfloat16: 2 in 4 bytes), else
    1. float64 has no vector reduction, only the 16-byte load of 2
    columns."""
    k, item, ptr = values.shape[1], values.element_size(), values.data_ptr()
    for vec in ((4, 2) if item == 4 else (2,)):
        if k % vec == 0 and ptr % (vec * item) == 0:
            return vec
    return 1


def phase_cells(values: torch.Tensor) -> int:
    """Cells of one 16-byte copy of ids and values together on the sorted
    flat path (``csrc/segsum.cu`` kPhaseCells): 4, or 8 for bfloat16."""
    return 8 if values.element_size() == 2 else 4


def sorted_tile_bases(cells: int, phase: int, group: int = 4) -> List[int]:
    """First cell of every tile of the sorted flat kernel: tiles of
    :data:`SORTED_TILE` cells start on the 16-byte ``phase`` (the first one
    up to ``group - 1`` cells before cell 0; ``group``:
    :func:`phase_cells`), or at cell 0 when no phase aligns
    (``phase < 0``)."""
    base0 = phase - group if phase > 0 else 0
    return list(range(base0, cells, SORTED_TILE))


def sorted_plan(ids: np.ndarray, num_segments: int, k: int = 1,
                phase: int = 0,
                group: int = 4) -> List[Tuple[int, int, int, int]]:
    """The sorted kernel's final writes, computed by its own rules: a list
    of ``(segment, writer, first, end)``, one per output segment (each of
    its ``k`` columns by the same writer).

    Ascending ids: ``writer`` is the owner (flat: tile * 256 + thread, each
    owning :data:`SORTED_OWN` cells of its tile; ``[cells, k]``: the chunk
    of :data:`SORTED_CHUNK` cells), or -1 for the segments before
    ``ids[0]`` and after ``ids[-1]``, which the whole grid zeroes. The
    segment's value is ``0 + v[first] + ... + v[end - 1]`` in cell order
    (``first == end``: a zero). A run of equal ids belongs to the owner of
    its first cell, which sums it (reading past its own cells when the run
    goes on) and zeroes the segments between the previous cell's id and
    the run's.

    Ids with a descent anywhere: the repair kernel rewrites every segment
    after the run-flush, so every segment has one final write by
    :data:`REPAIR`, ``0`` plus every cell with its id added by atomics in
    no fixed order (``first == end == -1``)."""
    ids = np.asarray(ids)
    cells = ids.size
    if cells == 0:
        return []
    if (np.diff(ids.astype(np.int64)) < 0).any():
        return [(s, REPAIR, -1, -1) for s in range(num_segments)]
    writes = [(s, -1, 0, 0) for s in range(int(ids[0]))]
    writes += [(s, -1, 0, 0) for s in range(int(ids[-1]) + 1, num_segments)]
    if k == 1:
        owners = [(b + SORTED_OWN * t, b + SORTED_OWN * (t + 1))
                  for b in sorted_tile_bases(cells, phase, group)
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
    the plain version for CPU tensors, the CUDA kernels for CUDA tensors
    (unsupported operands raise ``KernelUnsupportedError``); one call
    counts one launch.
    ``indices_are_sorted=True`` takes the deterministic run-flush path
    for ascending ``ids``; on ids that do not ascend it still returns the
    sum (by its repair pass, in a run-dependent order)."""
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
    # The sorted path writes every element (or its repair pass does); the
    # atomics add into zeros.
    new = torch.empty if indices_are_sorted else torch.zeros
    out = new(shape, dtype=values.dtype, device=values.device)
    # The 16-byte phase of ids and values: the sorted flat kernel's tiles.
    sorted_flat = indices_are_sorted and k == 1
    phase = (vector_phase(ids, values, phase_cells(values)) if sorted_flat
             else -1)
    vec = payload_vector(values) if k > 1 else 1
    fn = _build.function("segsum", _SYMBOLS[values.dtype], _ARGTYPES)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        work = (_work_area(values.device, stream).data_ptr()
                if indices_are_sorted else None)
        code = fn(int(indices_are_sorted), values.data_ptr(), ids.data_ptr(),
                  cells, k, num_segments, phase, vec, out.data_ptr(), work,
                  stream)
    _build.check("segment_sum", "segsum", code)
    LAUNCHES.bump()
    return out
