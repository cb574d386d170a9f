"""Padded-ELL CSR SpMV — the sparse forward-margin matvec.

Replaces ``flinkml_tpu/kernels/spmv.py:74 pallas_spmv``:
``out[r] = sum_s values[r, s] * w[indices[r, s]]`` over one padded
``[rows, width]`` ELL bucket (padding cells, index 0 / value 0, add 0).

:func:`spmv` is the wrapper: for tensors on the CPU it computes the plain
PyTorch version :func:`spmv_plain`; for CUDA tensors it launches the
hand-written kernel ``csrc/spmv.cu`` (the bucket as one flat stream of
cells: 16-byte loads, every gather of a thread in flight together, each
row summed in a fixed order — see the source note for what bounds it on
the H100) or raises
:class:`~flinkml_tpu_torch.kernels.KernelUnsupportedError`.

The kernel trusts ``0 <= indices < dim``; a CUDA gather does not clamp as
the JAX one does, so callers check the indices on the host before they
upload them (:func:`flinkml_tpu_torch.ops.sparse.pack_ell_buckets`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from flinkml_tpu_torch.kernels import _build, _gate

#: Value types the CUDA kernel takes (values and w share one; bfloat16 and
#: float16 multiply and sum in float32 and round each row's sum once).
SUPPORTED_DTYPES = (torch.float32, torch.float64, torch.bfloat16,
                    torch.float16)

LAUNCHES = _gate.launch_counter("spmv")

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # indices, values, w
    ctypes.c_int64, ctypes.c_int, ctypes.c_int,          # rows, width, phase
    ctypes.c_void_p, ctypes.c_void_p,                    # out, stream
]
_SYMBOLS = {torch.float32: "fml_spmv_f32", torch.float64: "fml_spmv_f64",
            torch.bfloat16: "fml_spmv_bf16", torch.float16: "fml_spmv_f16"}


def spmv_plain(indices: torch.Tensor, values: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: gather, multiply, sum over the slots
    (bfloat16 and float16: in float32, each row's sum rounded once, as the
    kernel)."""
    if values.dtype in (torch.bfloat16, torch.float16):
        return torch.sum(values.float() * w[indices.long()].float(),
                         dim=1).to(values.dtype)
    return torch.sum(values * w[indices.long()], dim=1)


def vector_phase(indices: torch.Tensor, values: torch.Tensor,
                 cells: int = 4) -> int:
    """The cell position modulo ``cells`` at which ``indices`` starts a
    16-byte aligned group of cells and ``values`` an aligned group of
    ``cells`` values (16 bytes, or less for narrower values: the kernels'
    vector loads), or -1 when no position aligns both (the kernel then
    loads each cell alone). Read from the base pointers: a bucket view may
    start at any cell."""
    ip, vp, item = indices.data_ptr(), values.data_ptr(), values.element_size()
    align = min(16, cells * item)
    for phase in range(cells):
        if (ip + 4 * phase) % 16 == 0 and (vp + item * phase) % align == 0:
            return phase
    return -1


def unsupported_reason(indices, values, w) -> Optional[str]:
    """Why the CUDA kernel cannot run these operands (None = it can)."""
    if indices.dim() != 2 or values.dim() != 2:
        return (f"indices/values must be [rows, width], got ranks "
                f"{indices.dim()}/{values.dim()}")
    if tuple(indices.shape) != tuple(values.shape):
        return (f"indices shape {tuple(indices.shape)} != values shape "
                f"{tuple(values.shape)}")
    if w.dim() != 1:
        return f"w must be [dim], got rank {w.dim()}"
    if indices.dtype != torch.int32:
        return f"indices dtype {indices.dtype} is not int32"
    if values.dtype not in SUPPORTED_DTYPES:
        return (f"values dtype {values.dtype} is not supported (supported: "
                "float32, float64, bfloat16, float16)")
    if values.dtype != w.dtype:
        return f"values dtype {values.dtype} != w dtype {w.dtype}"
    devices = {indices.device, values.device, w.device}
    if len(devices) != 1:
        return f"operands on different devices {sorted(map(str, devices))}"
    if values.shape[1] >= 2**31 or values.shape[0] >= 2**31:
        return (f"rows {values.shape[0]} or width {values.shape[1]} does "
                "not fit a 32-bit int")
    return None


def spmv(indices: torch.Tensor, values: torch.Tensor,
         w: torch.Tensor) -> torch.Tensor:
    """``sum(values * w[indices], dim=1)`` over a padded ELL bucket: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (unsupported operands raise ``KernelUnsupportedError``)."""
    if _gate.CAPTURE.on:
        return _gate.op("spmv")(indices, values, w)
    if values.device.type == "cpu":
        return spmv_plain(indices, values, w)
    if values.device.type != "cuda":
        raise _gate.refuse("spmv", f"device {values.device} is not CUDA")
    reason = unsupported_reason(indices, values, w)
    if reason is not None:
        raise _gate.refuse("spmv", reason)
    indices = indices.contiguous()
    values = values.contiguous()
    w = w.contiguous()
    rows, width = values.shape
    out = torch.empty(rows, dtype=values.dtype, device=values.device)
    if rows == 0:
        return out
    fn = _build.function("spmv", _SYMBOLS[values.dtype], _ARGTYPES)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = fn(indices.data_ptr(), values.data_ptr(), w.data_ptr(),
                  rows, width, vector_phase(indices, values), out.data_ptr(),
                  stream)
    _build.check("spmv", "spmv", code)
    LAUNCHES.bump()
    return out
