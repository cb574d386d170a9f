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
hand-written kernel ``csrc/topk.cu`` (one block per row: a strided scan
that keeps each thread's best k in shared memory, then k block-wide
arg-max rounds; rows too few to fill the card split into
:func:`segments`, whose ordered candidates a second launch merges — see
the source note) or raises
:class:`~flinkml_tpu_torch.kernels.KernelUnsupportedError`.
``torch.topk`` does not promise this tie order, so it is neither.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from flinkml_tpu_torch.kernels import _build, _gate

#: Largest k the CUDA kernel selects (each thread keeps k pairs in shared
#: memory); the plain version takes any k <= n.
MAX_K = 128

#: Value types the CUDA kernel takes.
SUPPORTED_DTYPES = (torch.float32, torch.float64)

#: Blocks that fill the H100 (two per SM of 132): rows fewer than this split.
TARGET_BLOCKS = 264
#: Fewest elements a row segment holds.
MIN_SEGMENT = 2048
#: Most segments per row (the merge keeps one head per segment in shared
#: memory).
MAX_SEGMENTS = 1024

LAUNCHES = _gate.launch_counter("topk")

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # x, rows, n, k
    ctypes.c_int,                                                 # segments
    ctypes.c_void_p, ctypes.c_void_p,                             # values, indices
    ctypes.c_void_p, ctypes.c_void_p,                             # candidates
    ctypes.c_void_p,                                              # stream
]
_SYMBOLS = {torch.float32: "fml_topk_f32", torch.float64: "fml_topk_f64"}
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
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def segments(rows: int, n: int, k: int) -> int:
    """Blocks per row: 1 when ``rows`` fill the card, else enough segments
    of at least ``max(MIN_SEGMENT, k)`` elements to make about
    :data:`TARGET_BLOCKS` blocks (at most :data:`MAX_SEGMENTS`)."""
    if rows >= TARGET_BLOCKS:
        return 1
    by_blocks = -(-TARGET_BLOCKS // max(rows, 1))
    by_length = n // max(MIN_SEGMENT, k)
    return max(1, min(by_blocks, by_length, MAX_SEGMENTS))


def unsupported_reason(x: torch.Tensor, k: int) -> Optional[str]:
    """Why the CUDA kernel cannot rank these operands (None = it can)."""
    if x.dim() not in (1, 2):
        return f"operand must be [n] or [rows, n], got rank {x.dim()}"
    if x.dtype not in SUPPORTED_DTYPES:
        return (f"operand dtype {x.dtype} is not supported (supported: "
                "float32, float64; integer ranking has no kernel)")
    n = x.shape[-1]
    if not 1 <= k <= n:
        return f"k={k} outside [1, n={n}]"
    if k > MAX_K:
        return (f"k={k} exceeds the kernel's ceiling of {MAX_K} kept pairs "
                "per thread")
    rows = 1 if x.dim() == 1 else x.shape[0]
    if n >= _INT32_LIMIT or rows >= _INT32_LIMIT:
        return f"n={n} or rows={rows} does not fit a 32-bit int"
    return None


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, int32 indices)`` of the k largest entries of each row,
    in ``jax.lax.top_k``'s order: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (unsupported operands raise
    ``KernelUnsupportedError``)."""
    if x.device.type == "cpu":
        return top_k_plain(x, k)
    if x.device.type != "cuda":
        raise _gate.refuse("topk", f"device {x.device} is not CUDA")
    reason = unsupported_reason(x, k)
    if reason is not None:
        raise _gate.refuse("topk", reason)
    x = x.contiguous()
    rows = 1 if x.dim() == 1 else x.shape[0]
    n = x.shape[-1]
    shape = tuple(x.shape[:-1]) + (k,)
    values = torch.empty(shape, dtype=x.dtype, device=x.device)
    indices = torch.empty(shape, dtype=torch.int32, device=x.device)
    if rows == 0:
        return values, indices
    segs = segments(rows, n, k)
    cand_key = cand_idx = None
    if segs > 1:
        # Each segment's ordered (order key, index) candidates.
        key_dtype = _KEY_VIEW[x.element_size()][0]
        cand_key = torch.empty((rows, segs, k), dtype=key_dtype,
                               device=x.device)
        cand_idx = torch.empty((rows, segs, k), dtype=torch.int32,
                               device=x.device)
    fn = _build.function("topk", _SYMBOLS[x.dtype], _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), rows, n, k, segs, values.data_ptr(),
                  indices.data_ptr(),
                  None if cand_key is None else cand_key.data_ptr(),
                  None if cand_idx is None else cand_idx.data_ptr(), stream)
    _build.check("topk", "topk", code)
    LAUNCHES.bump()
    return values, indices
