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

- unsorted: one ``atomicAdd`` per cell. The adds land in an order that
  changes from run to run, so the result equals the in-order sum within
  rounding only; refused under ``torch.use_deterministic_algorithms(True)``.
- sorted (ids ascending): a run-flush that sums each run left to right and
  stores it once — deterministic, and in the JAX kernel's addition order.

Zero cells or zero segments return zeros without a launch, as the JAX
dispatcher does. The kernel trusts ``0 <= ids < num_segments``: the host
packers check the indices before upload
(:func:`flinkml_tpu_torch.ops.sparse.pack_ell_buckets`). Unlike the Pallas
kernel, the output lives in device memory, so there is no VMEM ceiling on
``num_segments * k``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from flinkml_tpu_torch.kernels import _build, _gate

#: Value types the CUDA kernel takes (ids are int32).
SUPPORTED_DTYPES = (torch.float32, torch.float64)

LAUNCHES = _gate.launch_counter("segment_sum")

_ARGTYPES = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,    # sorted, values, ids
    ctypes.c_int, ctypes.c_int,                        # cells, k
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
    out = _zeros(values, num_segments)
    if values.numel() == 0 or num_segments == 0:
        return out
    values = values.contiguous()
    ids = ids.contiguous()
    cells = values.shape[0]
    k = 1 if values.dim() == 1 else values.shape[1]
    fn = _build.function("segsum", _SYMBOLS[values.dtype], _ARGTYPES)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = fn(int(indices_are_sorted), values.data_ptr(), ids.data_ptr(),
                  cells, k, out.data_ptr(), stream)
    _build.check("segment_sum", "segsum", code)
    LAUNCHES.bump()
    return out
