"""The serving engine's load-time memory estimate.

The port's part of ``flinkml_tpu.analysis.memory``: only
:func:`estimate_serving_bytes`, which reads no program. It walks a model's
learned arrays and sizes them at the widths the engine's precision tier
stores them, plus the batch buffers of the largest dispatch bucket. The
JAX package's program walker (per-device peak-live-bytes over a jaxpr,
rules FML701–FML704) comes with ROADMAP.md Queue 1 item 13.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import numpy as np


def _dtype_itemsize(dtype) -> int:
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError:
        return 2 if "bfloat16" in str(dtype) else 4


def estimate_serving_bytes(
    model: Any,
    schema: Mapping[str, Tuple[Any, Tuple[int, ...]]],
    max_batch_rows: int,
    policy: Optional[Any] = None,
) -> int:
    """A device-free upper-ish estimate of one serving replica's device
    memory: every learned model array at the width the engine's precision
    tier stores it (int8 codes + float32 scales under a ``quant`` policy,
    ``policy.compute`` under a mixed policy: the fused chain casts
    constants at its boundary), plus three live batch-sized buffers
    (input, one intermediate, output) at the largest dispatch bucket. The
    :class:`~flinkml_tpu_torch.serving.engine.ServingEngine` load-time
    budget gate consumes this BEFORE the active-model flip, so a refused
    swap keeps the old model serving. Same bytes as the JAX package's
    estimate for the same model, schema and policy."""
    from flinkml_tpu_torch.precision import quantizable, resolve_policy
    from flinkml_tpu_torch.recovery.sentinel import _iter_stage_arrays

    policy = resolve_policy(policy)
    const_bytes = 0
    for _name, arr in _iter_stage_arrays(model):
        a = np.asarray(arr)
        if policy is not None and policy.quant == "int8" \
                and quantizable(a):
            cols = int(a.shape[-1]) if a.ndim >= 2 else 1
            const_bytes += a.size + 4 * cols
        elif policy is not None and policy.mixed:
            const_bytes += a.size * int(policy.compute_dtype.itemsize)
        else:
            const_bytes += int(a.nbytes)
    batch_bytes = 0
    for _col, (dtype, trailing) in schema.items():
        elems = int(max_batch_rows)
        for d in trailing:
            elems *= int(d)
        width = (
            int(policy.compute_dtype.itemsize)
            if policy is not None and policy.mixed
            else _dtype_itemsize(dtype)
        )
        batch_bytes += elems * width
    return int(const_bytes + 3 * batch_bytes)
