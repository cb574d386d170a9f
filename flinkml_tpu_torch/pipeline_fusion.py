"""Fused device-resident pipeline execution.

The port's counterpart of ``flinkml_tpu.pipeline_fusion``. A run of
kernel-capable stages (stages exposing
:meth:`~flinkml_tpu_torch.api.AlgoOperator.transform_kernel`) executes as
ONE program: on CUDA one launch of the hand-written ``fused_chain`` kernel
(:mod:`flinkml_tpu_torch.kernels.chain`), on the CPU the plain PyTorch
chain. A run may read several input columns (numeric of any kind, such as
OneHotEncoder's integer codes) and hold stages with several outputs. Intermediate columns never leave the device, and the result
:class:`~flinkml_tpu_torch.table.Table` carries device-resident output
columns that reach the host only when read.

Programs and row buckets
------------------------

Programs are cached under

  ``(chain fingerprint, external input col specs, constant specs,
  requested output columns, bucket, device)``

where ``bucket`` is the row count padded up to a power of two
(≥ :data:`MIN_ROW_BUCKET`), so one program serves every batch size within
a bucket. Building a CUDA program checks that the kernel computes the
chain (an unsupported chain raises ``KernelUnsupportedError`` — there is
no silent eager path on the card). Model constants are not key material:
they are packed per set of model arrays, so refreshed model data reuses
the program.

Lazy intermediates
------------------

The eager program writes only the run's *terminal* columns plus the
inputs of ``pin_inputs`` stages (the LR and KMeans heads' input, as in the
JAX package). Other intermediates (a one-hot output, an assembled row, a
scaler's output) land in the result table as
:class:`~flinkml_tpu_torch.table.LazyDeviceColumn`: shape and dtype come
from the plain chain over one zero row on the CPU, and the first read runs
the chain truncated at that column.

This slice covers the default precision only: the JAX package's
``precision_scope``, mixed and int8 tiers, and ``warmup_transform`` come
later.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import ColumnKernel
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.kernels import chain as _chain
from flinkml_tpu_torch.linalg import next_pow2
from flinkml_tpu_torch.table import LazyDeviceColumn, PaddedDeviceColumn, Table

#: Smallest row bucket: tiny tables all share one program.
MIN_ROW_BUCKET = 8

_CACHE: Dict[Tuple, Callable] = {}
_SPECS: Dict[Tuple, Dict[str, Tuple[tuple, torch.dtype]]] = {}
_LOCK = threading.Lock()
_ENABLED = [True]


def enabled() -> bool:
    """Fusion master switch (:func:`set_enabled`); off restores pure
    per-stage execution."""
    return _ENABLED[0]


def set_enabled(flag: bool) -> None:
    _ENABLED[0] = bool(flag)


def reset_cache() -> None:
    """Drop every cached program and output spec (tests)."""
    with _LOCK:
        _CACHE.clear()
        _SPECS.clear()


def compiled_program_count() -> int:
    """Number of chain programs in the cache."""
    with _LOCK:
        return len(_CACHE)


def row_bucket(n: int) -> int:
    """Padded row count for ``n`` rows: next power of two, floored at
    :data:`MIN_ROW_BUCKET`."""
    return max(MIN_ROW_BUCKET, next_pow2(n))


def _dense_in_table(table: Table, name: str) -> bool:
    """Whether ``name`` is a column the executor can place on the device."""
    if name not in table:
        return False
    if table.is_device_resident(name):
        return True
    return table.column(name).dtype.kind in "fiub"


def collect_run(table: Table, stages: Sequence, start: int):
    """Longest run of kernel-capable stages beginning at ``stages[start]``
    whose external inputs are dense columns of ``table`` (or products of
    earlier kernels in the run). Returns ``(kernels, next_index)`` —
    ``kernels`` empty when ``stages[start]`` cannot join a run."""
    kernels: List[ColumnKernel] = []
    produced: set = set()
    i = start
    while i < len(stages):
        kernel = stages[i].transform_kernel()
        if kernel is None:
            break
        if any(
            c not in produced and not _dense_in_table(table, c)
            for c in kernel.input_cols
        ):
            break
        kernels.append(kernel)
        produced.update(kernel.output_cols)
        i += 1
    return kernels, i


def external_inputs(kernels: Sequence[ColumnKernel]) -> List[str]:
    """Columns a run reads from the table (not produced inside the run),
    in first-use order."""
    ext: List[str] = []
    produced: set = set()
    for k in kernels:
        for c in k.input_cols:
            if c not in produced and c not in ext:
                ext.append(c)
        produced.update(k.output_cols)
    return ext


def _output_cols(kernels: Sequence[ColumnKernel]) -> List[str]:
    out: List[str] = []
    for k in kernels:
        for c in k.output_cols:
            if c not in out:
                out.append(c)
    return out


def _closure_outputs(kernels: Sequence[ColumnKernel],
                     requested: Sequence[str]) -> Tuple[str, ...]:
    """``requested`` plus the pins its dependency closure demands: for
    every ``pin_inputs`` kernel the requested columns (transitively)
    depend on, the kernel's chain-produced input columns join the
    outputs."""
    producer = {}
    for j, k in enumerate(kernels):
        for c in k.output_cols:
            producer[c] = j
    needed: set = set()
    stack = [producer[c] for c in requested if c in producer]
    while stack:
        j = stack.pop()
        if j in needed:
            continue
        needed.add(j)
        stack.extend(
            producer[c] for c in kernels[j].input_cols if c in producer
        )
    pins: List[str] = []
    for j in sorted(needed):
        if kernels[j].pin_inputs:
            for c in kernels[j].input_cols:
                if c in producer and c not in pins:
                    pins.append(c)
    return tuple(dict.fromkeys([*pins, *requested]))


def _program(kernels, ext_names, out_names, base_key, device: torch.device):
    """The cached chain program writing ``out_names`` (built on a miss)."""
    key = base_key + (tuple(out_names),)
    with _LOCK:
        program = _CACHE.get(key)
    if program is None:
        program = _chain.build_chain(kernels, ext_names, out_names, device)
        with _LOCK:
            program = _CACHE.setdefault(key, program)
    return program


def _output_specs(kernels, ext_names, out_names, ext_vals, consts,
                  base_key) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Padded shape and dtype of every output column, cached: the plain
    chain over ONE zero row on the CPU (kernels are row-local, so the
    leading axis is the bucket's). A ``meta``-device trace would say the
    same without data, but its first use imports ~2 s of symbolic-shape
    machinery."""
    with _LOCK:
        specs = _SPECS.get(base_key)
    if specs is None:
        row = [torch.zeros((1,) + tuple(v.shape[1:]), dtype=v.dtype)
               for v in ext_vals]
        outs = _chain.chain_plain(kernels, ext_names, out_names, row,
                                  consts, 1)
        bucket = ext_vals[0].shape[0]
        specs = {c: ((bucket,) + tuple(v.shape[1:]), v.dtype)
                 for c, v in outs.items()}
        with _LOCK:
            _SPECS[base_key] = specs
    return specs


def execute_kernel_chain(table: Table, kernels: Sequence[ColumnKernel]) -> Table:
    """Run ``kernels`` over ``table`` as one fused program on the compute
    device: one host→device upload per external host-resident input
    column, none for device-resident inputs and intermediates, and a
    result table whose new columns are device-resident."""
    if not kernels:
        return table
    kernels = tuple(kernels)
    device = default_device()
    n = table.num_rows
    bucket = row_bucket(n)
    ext = external_inputs(kernels)
    out_names = _output_cols(kernels)

    # A column consumed by a later kernel of the run is an intermediate:
    # not computed eagerly. Eager = terminal columns + the pins their
    # closure demands.
    producer = {c: j for j, k in enumerate(kernels) for c in k.output_cols}
    terminal = [
        c for c in out_names
        if not any(
            c in kernels[j].input_cols
            for j in range(producer[c] + 1, len(kernels))
        )
    ]
    eager_names = list(_closure_outputs(kernels, terminal))
    lazy_names = [c for c in out_names if c not in eager_names]

    ext_vals = tuple(table.device_column_padded(name, bucket, device)
                     for name in ext)
    ext_specs = tuple((name, str(v.dtype), tuple(v.shape[1:]))
                      for name, v in zip(ext, ext_vals))
    consts = tuple(k.constants for k in kernels)
    const_specs = tuple(
        tuple((c, str(np.asarray(v).dtype), np.shape(v))
              for c, v in sorted(k.constants.items()))
        for k in kernels
    )
    base_key = (tuple(k.fingerprint for k in kernels), ext_specs, const_specs,
                bucket, str(device))
    specs = _output_specs(kernels, ext, out_names, ext_vals, consts, base_key)
    outs = _program(kernels, ext, eager_names, base_key, device)(
        ext_vals, consts, n
    )

    result = table
    for name in eager_names:
        result = result.with_column(name, PaddedDeviceColumn(outs[name], n))
    for name in lazy_names:
        shape, dtype = specs[name]

        def thunk(name=name):
            wanted = _closure_outputs(kernels, (name,))
            return _program(kernels, ext, wanted, base_key, device)(
                ext_vals, consts, n
            )[name]

        result = result.with_column(
            name, LazyDeviceColumn(thunk, n, shape, dtype)
        )
    return result
