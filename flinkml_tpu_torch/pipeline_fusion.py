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
  bucket, device, policy, requested output columns)``

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

Precision tiers
---------------

An active :class:`~flinkml_tpu_torch.precision.PrecisionPolicy`
(:func:`set_policy` / :func:`precision_scope`, per thread) changes the
chain in the declared way: every float input and model constant is cast to
``policy.compute`` at the chain's boundary, and under ``int8_inference``
every float constant of at least ``precision.int8_min_const_elems()``
elements (``FLINKML_TPU_INT8_MIN_CONST``, else the tuning table, else
``INT8_MIN_CONST_ELEMS``) travels as per-column absmax int8 codes with float32 scales (quantized once per
model array) and is dequantized inside the chain. The policy is key
material (a bfloat16, an int8 and a float32 program never alias), a lazy
column runs under the policy captured at transform time, and every chain
is checked against the policy before a program is built
(:func:`check_precision`: the stages' declared accumulation widths give
the JAX package's FML601/FML603/FML607 verdicts; a refused chain caches
nothing). No policy leaves every path as it was.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from flinkml_tpu_torch import precision as _precision
from flinkml_tpu_torch.api import ColumnKernel
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.kernels import chain as _chain
from flinkml_tpu_torch.linalg import next_pow2
from flinkml_tpu_torch.precision import (
    PrecisionValidationError,
    QuantizedConst,
    resolve_policy,
)
from flinkml_tpu_torch.table import LazyDeviceColumn, PaddedDeviceColumn, Table

#: Smallest row bucket: tiny tables all share one program.
MIN_ROW_BUCKET = 8

_CACHE: Dict[Tuple, Callable] = {}
_SPECS: Dict[Tuple, Dict[str, Tuple[tuple, torch.dtype]]] = {}
_LOCK = threading.Lock()
_ENABLED = [True]
# Per-THREAD policy slot: a serving thread's scope never reaches another
# thread's transforms.
_POLICY = threading.local()
# int8 codes and scales per model array, keyed by the array's identity (the
# entry holds the array, so its id is not reused while the entry lives); a
# bounded LRU, so serving pays the absmax passes once per model array.
_QUANT: "collections.OrderedDict" = collections.OrderedDict()
_QUANT_MAX = 128


def enabled() -> bool:
    """Fusion master switch (:func:`set_enabled`); off restores pure
    per-stage execution."""
    return _ENABLED[0]


def set_enabled(flag: bool) -> None:
    _ENABLED[0] = bool(flag)


def active_policy():
    """The :class:`~flinkml_tpu_torch.precision.PrecisionPolicy` fused
    chains run under on THIS thread (None: plain full-width execution)."""
    return getattr(_POLICY, "value", None)


def set_policy(policy) -> None:
    """Install a policy (object, preset name, JSON dict, or None) as THIS
    thread's fused-executor policy. Prefer :func:`precision_scope`."""
    _POLICY.value = resolve_policy(policy)


class precision_scope:
    """Context manager scoping this thread's fused-executor policy::

        with pipeline_fusion.precision_scope("mixed_inference"):
            (out,) = model.transform(table)

    Scopes nest and restore; other threads keep their own policy."""

    def __init__(self, policy):
        self._policy = resolve_policy(policy)
        self._prev = None

    def __enter__(self):
        self._prev = active_policy()
        _POLICY.value = self._policy
        return self._policy

    def __exit__(self, *exc):
        _POLICY.value = self._prev
        return False


def reset_cache() -> None:
    """Drop every cached program, output spec and quantized constant
    (tests)."""
    with _LOCK:
        _CACHE.clear()
        _SPECS.clear()
        _QUANT.clear()


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


def _program(kernels, ext_names, out_names, base_key, device: torch.device,
             policy=None):
    """The cached chain program writing ``out_names`` under ``policy``
    (built on a miss)."""
    key = base_key + (tuple(out_names),)
    with _LOCK:
        program = _CACHE.get(key)
    if program is None:
        program = _chain.build_chain(kernels, ext_names, out_names, device,
                                     policy)
        with _LOCK:
            program = _CACHE.setdefault(key, program)
    return program


def _output_specs(kernels, ext_names, out_names, ext_vals, consts,
                  base_key, policy=None) -> Dict[str, Tuple[tuple, torch.dtype]]:
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
                                  consts, 1, policy)
        bucket = ext_vals[0].shape[0]
        specs = {c: ((bucket,) + tuple(v.shape[1:]), v.dtype)
                 for c, v in outs.items()}
        with _LOCK:
            _SPECS[base_key] = specs
    return specs


def check_precision(kernels: Sequence[ColumnKernel], consts,
                    policy) -> None:
    """The precision check of one chain against ``policy``, before any
    program is built; raises
    :class:`~flinkml_tpu_torch.precision.PrecisionValidationError` with the
    JAX package's rule ids. The port does not walk programs: each stage
    declares where it accumulates (``ColumnKernel.accumulates``), and the
    model constants' stored dtypes are read directly.

    - FML601: a stage accumulating at ``policy.compute`` (KMeans' distance
      sums) under a declared policy whose ``accum`` is wider;
    - FML603: a float constant stored narrower than ``policy.params``;
    - FML607: an int8 constant under a policy with no quantization scheme.

    The port's stages never accumulate int8 codes (FML606: they dequantize
    first) and run no collective (FML604)."""
    findings = []
    narrow_compute = policy.declared and _precision.is_narrower(
        policy.compute, policy.accum)
    params_bits = _precision.significand_bits(policy.params)
    for k, kc in zip(kernels, consts):
        stage = _chain._stage_name(k) or type(k).__name__
        if k.accumulates == "compute" and narrow_compute:
            findings.append(_precision.Finding(
                "FML601",
                f"{stage} accumulates in {policy.compute}, narrower than "
                f"policy.accum ({policy.accum})",
            ))
        for name, v in sorted(kc.items()):
            if isinstance(v, QuantizedConst):
                continue
            dt = np.asarray(v).dtype
            if (dt.kind == "f"
                    and _precision.significand_bits(dt) < params_bits):
                findings.append(_precision.Finding(
                    "FML603",
                    f"parameter {name!r} of {stage} is stored as {dt}, "
                    f"narrower than policy.params ({policy.params})",
                    column=name,
                ))
            if dt == np.int8 and policy.quant is None:
                findings.append(_precision.Finding(
                    "FML607",
                    f"parameter {name!r} of {stage} is stored as int8 but "
                    f"policy {policy.name!r} declares no quantization "
                    "scheme",
                    column=name,
                ))
    if findings:
        program = "+".join(_chain._stage_name(k) or type(k).__name__
                           for k in kernels)
        rendered = "; ".join(f"{f.rule}: {f.message}" for f in findings)
        raise PrecisionValidationError(
            f"pipeline_fusion[{program}] fails its precision check under "
            f"{policy.describe()}: {rendered}",
            findings,
        )


def _quantized(raw, min_elems: int):
    """``raw``'s int8 codes and scales (``raw`` itself when the tier leaves
    it at float width: fewer than ``min_elems`` elements), memoized per
    model array and threshold."""
    key = (id(raw), min_elems)
    with _LOCK:
        hit = _QUANT.get(key)
        if hit is not None and hit[0] is raw:
            _QUANT.move_to_end(key)
            return hit[1]
    val = (QuantizedConst(*_precision.quantize_absmax(raw))
           if _precision.quantizable(raw, min_elems) else raw)
    with _LOCK:
        _QUANT[key] = (raw, val)
        _QUANT.move_to_end(key)
        while len(_QUANT) > _QUANT_MAX:
            _QUANT.popitem(last=False)
    return val


def _tier_consts(kernels, policy):
    """Each kernel's constants as the chain takes them under ``policy``:
    under ``int8_inference`` the eligible float arrays as int8 pairs."""
    if policy is None or policy.quant != "int8":
        return tuple(k.constants for k in kernels)
    min_elems = _precision.int8_min_const_elems()
    return tuple({n: _quantized(v, min_elems) for n, v in k.constants.items()}
                 for k in kernels)


def _const_spec(name, v):
    if isinstance(v, QuantizedConst):
        return (name, "int8[absmax]", np.shape(v.q))
    return (name, str(np.asarray(v).dtype), np.shape(v))


def execute_kernel_chain(table: Table, kernels: Sequence[ColumnKernel]) -> Table:
    """Run ``kernels`` over ``table`` as one fused program on the compute
    device under this thread's policy: one host→device upload per external
    host-resident input column, none for device-resident inputs and
    intermediates, and a result table whose new columns are
    device-resident."""
    if not kernels:
        return table
    kernels = tuple(kernels)
    policy = active_policy()
    if policy is not None:
        check_precision(kernels, [k.constants for k in kernels], policy)
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
    consts = _tier_consts(kernels, policy)
    const_specs = tuple(
        tuple(_const_spec(c, v) for c, v in sorted(kc.items()))
        for kc in consts
    )
    base_key = (tuple(k.fingerprint for k in kernels), ext_specs, const_specs,
                bucket, str(device))
    if policy is not None:
        base_key += (policy,)
    specs = _output_specs(kernels, ext, out_names, ext_vals, consts, base_key,
                          policy)
    outs = _program(kernels, ext, eager_names, base_key, device, policy)(
        ext_vals, consts, n
    )

    result = table
    for name in eager_names:
        result = result.with_column(name, PaddedDeviceColumn(outs[name], n))
    for name in lazy_names:
        shape, dtype = specs[name]

        # The policy captured now, not the reader's.
        def thunk(name=name, policy=policy):
            wanted = _closure_outputs(kernels, (name,))
            return _program(kernels, ext, wanted, base_key, device, policy)(
                ext_vals, consts, n
            )[name]

        result = result.with_column(
            name, LazyDeviceColumn(thunk, n, shape, dtype)
        )
    return result


def warmup_transform(
    model,
    example: Table,
    row_counts: Sequence[int],
    output_cols: Sequence[str] = (),
) -> Tuple[List[int], Tuple[str, ...]]:
    """Build ``model.transform``'s fused programs for every row bucket
    covering ``row_counts`` (under this thread's policy), so that a
    latency-sensitive caller pays every build up front: ``example``'s host
    columns are tiled row-cyclically to each bucket's row count and pushed
    through the real ``transform``, and ``output_cols`` (default: every
    column ``transform`` adds) are read back, which runs any lazy column's
    program. Returns ``(buckets, read_cols)``."""
    buckets = sorted({row_bucket(int(n)) for n in row_counts})
    host_cols = {name: np.asarray(example.column(name))
                 for name in example.column_names}
    read = tuple(output_cols)
    for bucket in buckets:
        tiled = Table({
            name: np.resize(col, (bucket,) + col.shape[1:])
            for name, col in host_cols.items()
        })
        (out,) = model.transform(tiled)
        if not read:
            read = tuple(
                c for c in out.column_names if c not in example.column_names
            )
        for c in read:
            out.column(c)
    return buckets, read
