"""Row-wise top-k — KNN voting and LSH candidate ranking.

Replaces ``flinkml_tpu/kernels/topk.py:79 pallas_top_k`` and the
``top_k`` dispatcher (``:123``): the ``(values, int32 indices)`` of the k
largest entries of each row of a ``[rows, n]`` (or ``[n]``) floating
tensor, descending in IEEE total order (NaN above +inf, +0 above -0, -NaN
below -inf) with ties toward the lower index — bit for bit the order of
``jax.lax.top_k``, the JAX package's default backend. (The Pallas kernel
treats +0 and -0 as equal, so it differs from ``lax.top_k`` there.)

:func:`top_k` is the wrapper: for tensors on the CPU it computes the plain
PyTorch version :func:`top_k_plain`; for CUDA tensors it launches the
hand-written kernel ``csrc/topk.cu`` for any 1 <= k <= n, on one of three
routes that :func:`route` picks by a fixed rule (a radix select of the
rank-k key in shared memory; a per-thread scan for long rows and small k;
a radix select over many blocks per row, in bands of 16,384 ranks for
large k — see the source note), or raises
:class:`~flinkml_tpu_torch.kernels.KernelUnsupportedError`.
``torch.topk`` does not promise this tie order, so it is neither.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from flinkml_tpu_torch.kernels import _build, _gate

#: Value types the CUDA kernel takes (bfloat16 and float16: each element's
#: bits placed on top of a 32-bit key as it is loaded).
SUPPORTED_DTYPES = (torch.float32, torch.float64, torch.bfloat16,
                    torch.float16)

#: Dynamic shared memory the ``fused`` route may use for a row's keys and
#: its sort buffer (the kernel accepts up to 220 KB of the H100's 227 KB).
FUSED_SMEM_BYTES = 200 * 1024
#: Largest k the rule sends to the ``scan`` route (the kernel takes up to
#: 32). On the KNN chunk [4096, 60000] f32 the scan reads each element
#: once and takes 0.59 / 1.45 / 2.02 / 2.64 / 3.43 / 5.26 ms at k = 5 / 12
#: / 16 / 20 / 24 / 32; the radix route reads it once per digit and takes
#: 1.93–1.96 ms at every k (H100 80GB HBM3 at 700 W, chip_smoke.py's
#: route probe): the scan wins up to k = 12.
SCAN_MAX_K = 12
#: Blocks that fill the H100 (two per SM of 132): rows fewer than this
#: split into segments on the ``radix`` route, and the ``scan`` route
#: needs at least this many rows.
TARGET_BLOCKS = 264
#: Fewest elements a row segment holds.
MIN_SEGMENT = 2048
#: Most segments per row.
MAX_SEGMENTS = 1024

#: The routes of ``csrc/topk.cu`` and their codes.
ROUTES = {"fused": 0, "scan": 1, "radix": 2}

LAUNCHES = _gate.launch_counter("topk")

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # x, rows, n, k
    ctypes.c_int, ctypes.c_int,                                   # route, segs
    ctypes.c_void_p, ctypes.c_void_p,                             # values, indices
    ctypes.c_void_p, ctypes.c_void_p,                             # scratch, stream
]
_SCRATCH_ARGTYPES = [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int]                       # rows, k, route, segs
_SYMBOLS = {torch.float32: "f32", torch.float64: "f64",
            torch.bfloat16: "bf16", torch.float16: "f16"}
_INT32_LIMIT = 2**31
#: The signed integer view of each float width, and its magnitude mask.
_KEY_VIEW = {2: (torch.int16, 0x7FFF), 4: (torch.int32, 0x7FFFFFFF),
             8: (torch.int64, 0x7FFFFFFFFFFFFFFF)}


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """Integer keys whose signed order is the IEEE total order of ``x``:
    ``bits ^ ((bits >> (width - 1)) & 0x7f..f)`` flips the magnitude bits
    of negative numbers."""
    view, mask = _KEY_VIEW[x.element_size()]
    bits = x.contiguous().view(view)
    return bits ^ ((bits >> (8 * x.element_size() - 1)) & mask)


def top_k_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: a stable descending sort of the order
    keys, the first k kept, the values gathered from ``x``."""
    if not x.dtype.is_floating_point:
        raise TypeError(f"top_k needs a floating tensor, got {x.dtype}")
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"k={k} outside [0, n={n}]")
    _, order = torch.sort(order_keys(x), dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    if x.element_size() == 2:
        # Gathered as bits: PyTorch's 16-bit gathers rewrite a NaN's bits
        # (bfloat16; float16 on the CPU quiets a signalling NaN).
        bits = torch.gather(x.contiguous().view(torch.int16), -1, idx)
        return bits.view(x.dtype), idx.to(torch.int32)
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def fused_smem_bytes(n: int, k: int, itemsize: int) -> int:
    """Dynamic shared memory of the ``fused`` route: the row's keys (padded
    to a 16-byte multiple) and a sort buffer of ``next_pow2(k)`` pairs."""
    vec = 16 // itemsize
    p2 = 1 << max(k - 1, 0).bit_length()
    return -(-n // vec) * vec * itemsize + p2 * (itemsize + 4)


def route(rows: int, n: int, k: int, itemsize: int) -> str:
    """The kernel route for these operands, by a fixed rule:

    - ``fused`` when the row and a sort of k pairs fit
      :data:`FUSED_SMEM_BYTES` (one launch, every pass in shared memory);
    - ``scan`` when rows fill the card and k <= :data:`SCAN_MAX_K` (one
      read of each element from device memory: the KNN chunk);
    - ``radix`` otherwise (a launch per digit over :func:`segments` blocks
      per row; for k above one shared-memory sort, bands of 16,384 ranks,
      ``kSortCap`` in the source)."""
    if fused_smem_bytes(n, k, itemsize) <= FUSED_SMEM_BYTES:
        return "fused"
    if k <= SCAN_MAX_K and rows >= TARGET_BLOCKS:
        return "scan"
    return "radix"


def segments(rows: int, n: int) -> int:
    """Blocks per row on the ``radix`` route: 1 when ``rows`` fill the
    card, else enough segments of at least :data:`MIN_SEGMENT` elements to
    make about :data:`TARGET_BLOCKS` blocks (at most
    :data:`MAX_SEGMENTS`)."""
    if rows >= TARGET_BLOCKS:
        return 1
    by_blocks = -(-TARGET_BLOCKS // max(rows, 1))
    by_length = n // MIN_SEGMENT
    return max(1, min(by_blocks, by_length, MAX_SEGMENTS))


def unsupported_reason(x: torch.Tensor, k: int) -> Optional[str]:
    """Why the CUDA kernel cannot rank these operands (None = it can)."""
    if x.dim() not in (1, 2):
        return f"operand must be [n] or [rows, n], got rank {x.dim()}"
    if x.dtype not in SUPPORTED_DTYPES:
        return (f"operand dtype {x.dtype} is not supported (supported: "
                "float32, float64, bfloat16, float16; integer ranking has no "
                "kernel)")
    n = x.shape[-1]
    if not 1 <= k <= n:
        return f"k={k} outside [1, n={n}]"
    rows = 1 if x.dim() == 1 else x.shape[0]
    if n >= _INT32_LIMIT or rows >= _INT32_LIMIT:
        return f"n={n} or rows={rows} does not fit a 32-bit int"
    return None


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, int32 indices)`` of the k largest entries of each row,
    in ``jax.lax.top_k``'s order: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (unsupported operands raise
    ``KernelUnsupportedError``)."""
    if _gate.CAPTURE.on:
        return tuple(_gate.op("topk")(x, int(k)))
    if x.device.type == "cpu":
        return top_k_plain(x, k)
    if x.device.type != "cuda":
        raise _gate.refuse("topk", f"device {x.device} is not CUDA")
    reason = unsupported_reason(x, k)
    if reason is not None:
        raise _gate.refuse("topk", reason)
    rows = 1 if x.dim() == 1 else x.shape[0]
    return launch(x, k, route(rows, x.shape[-1], k, key_bytes(x.dtype)))


def key_bytes(dtype: torch.dtype) -> int:
    """Bytes of the kernel's order key for ``dtype``: bfloat16 and float16
    rank by a 32-bit key."""
    return 4 if dtype.itemsize == 2 else dtype.itemsize


def launch(x: torch.Tensor, k: int,
           route_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the CUDA kernel on ``route_name`` (one of :data:`ROUTES`) for
    operands :func:`unsupported_reason` accepts. :func:`top_k` picks the
    route; a measurement may name another to compare them."""
    x = x.contiguous()
    rows = 1 if x.dim() == 1 else x.shape[0]
    n = x.shape[-1]
    shape = tuple(x.shape[:-1]) + (k,)
    values = torch.empty(shape, dtype=x.dtype, device=x.device)
    indices = torch.empty(shape, dtype=torch.int32, device=x.device)
    if rows == 0:
        return values, indices
    code = ROUTES[route_name]
    segs = segments(rows, n) if route_name == "radix" else 1
    suffix = _SYMBOLS[x.dtype]
    size_fn = _build.function("topk", f"fml_topk_scratch_bytes_{suffix}",
                              _SCRATCH_ARGTYPES, restype=ctypes.c_int64)
    n_scratch = size_fn(rows, k, code, segs)
    scratch = (torch.empty(n_scratch, dtype=torch.uint8, device=x.device)
               if n_scratch > 0 else None)
    fn = _build.function("topk", f"fml_topk_{suffix}", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), rows, n, k, code, segs, values.data_ptr(),
                  indices.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), stream)
    _build.check("topk", "topk", code)
    LAUNCHES.bump()
    return values, indices
