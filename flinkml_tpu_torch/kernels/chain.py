"""Fused transform chain — one kernel launch per run of stages.

Replaces ``flinkml_tpu/kernels/chain.py:173 pallas_chain_fn``. The Pallas
kernel traces any row-local ``ColumnKernel`` chain; a hand-written CUDA
kernel cannot, so ``csrc/chain.cu`` implements the chains of the stages
the port has, in this grammar (:data:`GRAMMAR`, checked by
:func:`plan_chain`):

- prologue: any ``OneHotEncoderModel`` stages over input columns, then at
  most one ``VectorAssembler`` over input columns and one-hot outputs;
- body: up to :data:`MAX_STAGES` scaler stages (Standard, MinMax, MaxAbs,
  Robust scaler models), a linear run;
- head: none, or the ``LogisticRegressionModel`` (binomial or
  multinomial), or the ``KMeansModel`` (euclidean).

At least one stage. Any other chain, dtype or width raises
:class:`~flinkml_tpu_torch.kernels.KernelUnsupportedError` on CUDA tensors;
nothing falls back to the eager path there.

Two versions of one contract ``run(ext_vals, consts, n_valid) -> {col:
tensor}`` (``consts``: per kernel, its host constant arrays):

- :func:`chain_plain` — the plain PyTorch version: each kernel's ``fn`` in
  order. The executor's path for CPU tensors, and the reference the CUDA
  kernel is held against.
- :class:`ChainProgram` — the CUDA kernel. The host describes the row as a
  list of parts (one per input column: dense, or one-hot expanded), reads
  each stage's op from its fingerprint, casts its constants to the compute
  dtype BEFORE the zero guards (as the per-stage transforms do), packs
  them and the head's matrix into one table (uploaded once per set of
  model arrays, read from shared memory as far as it fits there:
  :func:`shared_memory`), and launches on one of two routes, picked by the
  fixed rule :func:`route`: ``vector`` (lane groups of 16-byte chunks, for
  rows of whole chunks) or ``scalar`` (one warp per row, any row).

Which outputs are written follows the executor's request: the eager
program of a scaler→LR run writes the last scaler's output (pinned by the
head's ``pin_inputs``) and the head's ``prediction``/``rawPrediction``; a
lazy intermediate (a one-hot output, the assembled row, a scaler's
output) runs the same kernel truncated after the stage that makes it.

Precision tiers. Both versions take a
:class:`~flinkml_tpu_torch.precision.PrecisionPolicy` (or None). A
declared policy (mixed, or quantized) casts every float input and constant
to ``policy.compute`` at the chain's boundary and dequantizes int8
constants (:func:`boundary`, as the JAX package's ``_chain_fn``), and the
stages compute under it (:func:`~flinkml_tpu_torch.precision.chain_policy`).
On CUDA a bfloat16 row runs the kernel's ``bf16`` entry (float32 registers,
each op rounded), the constant table holds the boundary's values, and
under ``int8_inference`` the table is uploaded as int8 codes, float32
scales and segments that the kernel dequantizes into shared memory
(:func:`pack_int8`). float16 is refused.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.kernels import _build, _gate
from flinkml_tpu_torch.precision import (
    QuantizedConst,
    is_narrower,
    running_under,
)

#: Scaler stages one launch applies at most (3 op bits each in a 32-bit word).
MAX_STAGES = 8

#: Input parts of one row at most (``csrc/chain.cu`` kMaxParts).
MAX_PARTS = 64

#: Shared memory a block may use on the H100 (the per-stage constants, the
#: head's matrix and the rows a class head stages live there, as far as
#: they fit: :func:`shared_memory`).
MAX_SMEM_BYTES = 232_448

#: Row dtypes the CUDA kernel computes (bfloat16: under a precision tier,
#: or from bfloat16 input columns).
SUPPORTED_DTYPES = (torch.float32, torch.float64, torch.bfloat16)

SCALER_STAGES = ("StandardScalerModel", "MinMaxScalerModel",
                 "MaxAbsScalerModel", "RobustScalerModel")
ONEHOT_STAGE = "OneHotEncoderModel"
ASSEMBLER_STAGE = "VectorAssembler"
LR_STAGE = "LogisticRegressionModel"
KMEANS_STAGE = "KMeansModel"
#: The heads, as ``ChainPlan.head`` names them (kernel codes 1, 2, 3).
HEADS = ("binomial", "multinomial", "kmeans")

GRAMMAR = (
    f"[{ONEHOT_STAGE} over input columns]* [{ASSEMBLER_STAGE} over input "
    f"columns and one-hot outputs]? [scaler model]{{0..{MAX_STAGES}}} "
    f"(a linear run) [{LR_STAGE} | {KMEANS_STAGE} (euclidean)]?, at least "
    "one stage"
)

LAUNCHES = _gate.launch_counter("fused_chain")

#: Packed constant tables a :class:`ChainProgram` keeps, one per set of
#: model arrays (two versions of one model shape served side by side fit).
TABLES_KEPT = 4

#: Bytes of one vector access of the ``vector`` route, and the most such
#: chunks a row may have there (one lane each, a warp per row at most).
VECTOR_BYTES = 16
MAX_VECTOR_CHUNKS = 32
ROUTES = ("vector", "scalar")
#: Threads of a block on each route (``csrc/chain.cu`` kVecThreads,
#: kThreads): their warps each stage rows for a class head.
VECTOR_THREADS = 128
SCALAR_THREADS = 256


class _Part(ctypes.Structure):
    """``csrc/chain.cu`` ``struct Part``: one input column of the row."""

    _fields_ = [
        ("src", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("max_index", ctypes.c_longlong),
        ("width", ctypes.c_int),
        ("offset", ctypes.c_int),
        ("base", ctypes.c_int),
        ("code", ctypes.c_int),
    ]


class _PartList(ctypes.Structure):
    _fields_ = [("p", _Part * MAX_PARTS)]


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,   # parts, n_parts, gather
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,   # table, n_table, n_smem
    ctypes.c_int, ctypes.c_uint, ctypes.c_int,     # n_run, ops, d
    ctypes.c_int, ctypes.c_int, ctypes.c_int,      # head, k, group
    ctypes.c_int,                                  # threads (scalar route)
    ctypes.c_int64, ctypes.c_longlong,             # n_rows, smem bytes
    ctypes.c_void_p, ctypes.c_void_p,              # row_out, out
    ctypes.c_void_p, ctypes.c_void_p,              # pred, raw
    ctypes.c_int, ctypes.c_int, ctypes.c_int,      # rnd, pred_ty, raw_ty
    ctypes.c_void_p, ctypes.c_int,                 # qseg, n_seg
    ctypes.c_void_p, ctypes.c_void_p,              # qf, qc
    ctypes.c_void_p,                               # stream
]
#: The kernel entry of each row dtype (bfloat16 rows: float32 registers),
#: and of a float64 row whose inputs or head narrow under a tier.
_SYMBOLS = {torch.float32: "fml_fused_chain_f32",
            torch.float64: "fml_fused_chain_f64",
            torch.bfloat16: "fml_fused_chain_bf16",
            "f64_tier": "fml_fused_chain_f64_tier"}

# Element type codes of an input column (csrc/chain.cu Elem) and the part
# flags.
_ELEM = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3,
         torch.int16: 4, torch.int8: 5, torch.uint8: 6, torch.bool: 6,
         torch.bfloat16: 7}
_ONEHOT, _DROP_LAST, _ROUND_BF16, _ROUND_F32 = 16, 32, 64, 128
_HEAD_CODE = {None: 0, "binomial": 1, "multinomial": 2, "kmeans": 3}
# The head's rounding bits (csrc/chain.cu kInBf16 ...) and output types.
_IN_BF16, _OUT_BF16, _IN_F32, _OUT_F32 = 1, 2, 4, 8
_OUT_TY = {"row": 0, torch.float32: 1, torch.bfloat16: 2}
#: Ints of one int8-table segment (csrc/chain.cu, the head).
SEGMENT_INTS = 8

# Op bits of one stage (see csrc/chain.cu).
_MINMAX, _SUB, _DIV = 1, 2, 4


def route(d: int, itemsize: int, *ptrs: int, all_in_row: bool = True) -> str:
    """The fixed rule: ``vector`` when a row of ``d`` elements is a whole
    number of 16-byte chunks, at most :data:`MAX_VECTOR_CHUNKS`, every
    dense input (``ptrs``, their base addresses) starts 16-byte aligned
    (then every row of a single input does), and every part is in the row
    (``all_in_row``); ``scalar`` otherwise."""
    chunks, rest = divmod(d * itemsize, VECTOR_BYTES)
    if (rest == 0 and 1 <= chunks <= MAX_VECTOR_CHUNKS and all_in_row
            and all(p % VECTOR_BYTES == 0 for p in ptrs)):
        return "vector"
    return "scalar"


def lane_group(d: int, itemsize: int) -> Tuple[int, int, int]:
    """The ``vector`` route's mapping of a row to lanes: ``(group,
    rows_per_warp, columns_per_lane)``. A group of lanes (the row's chunk
    count rounded up to a power of two) covers one row, lane ``q`` of the
    group columns ``[q * columns_per_lane, + columns_per_lane)``; lanes
    past the row's chunks idle."""
    chunks = d * itemsize // VECTOR_BYTES
    group = 1
    while group < chunks:
        group *= 2
    return group, 32 // group, VECTOR_BYTES // itemsize


def shared_memory(n_table: int, n_stages: int, per_warp: int, warps: int,
                  itemsize: int,
                  whole: bool = False) -> Optional[Tuple[int, int, int]]:
    """Where a launch keeps its constants: ``(table elements in shared
    memory, warps a block, bytes)``. The whole table (``n_table``
    elements, of which the stages' are the first ``n_stages``) when it fits
    beside ``warps`` warps' row buffers (``per_warp`` elements each); else
    the head's block is read from device memory, then the stages' too;
    then the block has fewer warps. None when one warp's row buffer alone
    exceeds :data:`MAX_SMEM_BYTES`. ``whole`` (an int8 table, which the
    kernel dequantizes into shared memory only): first the whole table,
    with fewer warps if need be; when it does not fit beside one warp's
    rows, the float table's placements (fewer than ``n_table`` elements:
    the caller launches on the table dequantized once,
    :meth:`ChainProgram.float_table`)."""
    cap = MAX_SMEM_BYTES // itemsize
    if whole and n_table + per_warp <= cap:
        fewer = min(warps, (cap - n_table) // per_warp) if per_warp else warps
        return n_table, fewer, (n_table + fewer * per_warp) * itemsize
    for n in (n_table, n_stages, 0):
        if n + warps * per_warp <= cap:
            return n, warps, (n + warps * per_warp) * itemsize
    fewer = cap // per_warp if per_warp else 0
    if fewer < 1:
        return None
    return 0, fewer, fewer * per_warp * itemsize


def _stage_name(kernel) -> str:
    return kernel.fingerprint[0] if kernel.fingerprint else ""


def _declared(policy) -> bool:
    return policy is not None and policy.declared


def boundary_const(policy, v, device):
    """One model constant as the chain's boundary gives it under a
    declared ``policy``: an int8 pair dequantized (``q * scale`` at
    ``policy.compute``), a float array cast to ``policy.compute``, anything
    else as it is."""
    dt = policy.compute_dtype
    if isinstance(v, QuantizedConst):
        q = torch.from_numpy(np.asarray(v.q)).to(device).to(dt)
        return q * torch.from_numpy(np.asarray(v.scale)).to(device).to(dt)
    t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
    if t.dtype.is_floating_point:
        return t.to(device=device, dtype=dt)
    return v


def boundary(policy, ext_vals, consts):
    """The chain's inputs, constants and validity-mask dtype as the JAX
    package's ``_chain_fn`` takes them under ``policy``: a declared policy
    casts every float input and constant to ``policy.compute`` and
    dequantizes int8 pairs; no policy, or one that declares nothing
    (``full``), leaves them as they are."""
    if not _declared(policy):
        return tuple(ext_vals), tuple(consts), torch.float32
    dt = policy.compute_dtype
    device = ext_vals[0].device
    ext = tuple(v.to(dt) if v.dtype.is_floating_point else v
                for v in ext_vals)
    cs = tuple({n: boundary_const(policy, v, device) for n, v in kc.items()}
               for kc in consts)
    return ext, cs, dt


def chain_plain(kernels, ext_names: Sequence[str], out_names: Sequence[str],
                ext_vals, consts, n_valid: int,
                policy=None) -> Dict[str, torch.Tensor]:
    """The plain PyTorch chain: each kernel's ``fn`` in order, up to the
    last kernel an ``out_names`` column needs, under ``policy`` (see
    :func:`boundary`)."""
    producer = {c: j for j, k in enumerate(kernels) for c in k.output_cols}
    last = max(producer[c] for c in out_names)
    bucket = ext_vals[0].shape[0]
    device = ext_vals[0].device
    ext_vals, consts, mask_dt = boundary(policy, ext_vals, consts)
    valid = (torch.arange(bucket, device=device) < n_valid).to(mask_dt)
    cols = dict(zip(ext_names, ext_vals))
    with running_under(policy):
        for kernel, kc in zip(kernels[:last + 1], consts):
            cols.update(kernel.fn(
                {c: cols[c] for c in kernel.input_cols}, kc, valid
            ))
    return {c: cols[c] for c in out_names}


@dataclasses.dataclass(frozen=True)
class PartPlan:
    """One input of the kernel's row: the chain's external column number
    ``ext``, taken as it is or (``onehot = (max_index, drop_last)``)
    expanded to one-hot slots; ``out_col``: the one-hot output it writes;
    ``in_row``: whether it is part of the row (else it only writes
    ``out_col``)."""

    ext: int
    onehot: Optional[Tuple[int, bool]] = None
    out_col: Optional[str] = None
    in_row: bool = True

    @property
    def onehot_width(self) -> int:
        """Slots of a one-hot part: the categories (all but the last with
        dropLast) and the catch-all slot."""
        max_index, drop_last = self.onehot
        return max_index + (0 if drop_last else 1) + 1


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """What one launch computes: the row from ``parts`` (written to
    ``row_col`` when the VectorAssembler's output is asked for), the first
    ``n_run`` body stages (kernel numbers ``stages``), the output of the
    last of them written to ``out_col`` (None: not written), and the
    ``head`` (None or one of :data:`HEADS`, kernel number ``head_stage``)
    writing ``pred_col`` (and ``raw_col`` for LR)."""

    parts: Tuple[PartPlan, ...]
    row_col: Optional[str]
    stages: Tuple[int, ...]
    out_col: Optional[str]
    head: Optional[str] = None
    head_stage: Optional[int] = None
    pred_col: Optional[str] = None
    raw_col: Optional[str] = None

    @property
    def n_run(self) -> int:
        return len(self.stages)


def plan_chain(kernels, ext_names: Sequence[str],
               out_names: Sequence[str]) -> ChainPlan:
    """Check that ``csrc/chain.cu`` computes this chain and these outputs;
    raise :class:`KernelUnsupportedError` naming the reason if not."""
    def refuse(reason):
        return _gate.refuse("fused_chain",
                            f"{reason} (the kernel's grammar: {GRAMMAR})")

    kernels = tuple(kernels)
    ext = tuple(ext_names)
    if not kernels:
        raise refuse("empty chain")
    names = [_stage_name(k) for k in kernels]
    n, i = len(kernels), 0
    # One-hot units: output column -> (input column, max_index, drop_last).
    units: Dict[str, Tuple[str, int, bool]] = {}
    while i < n and names[i] == ONEHOT_STAGE:
        _, in_cols, out_cols, drop_last, max_idx = kernels[i].fingerprint
        for c, o, mv in zip(in_cols, out_cols, max_idx):
            if c not in ext:
                raise refuse(f"stage {i} ({ONEHOT_STAGE}) reads {c!r}, which "
                             "is not an input column of the chain")
            units[o] = (c, int(mv), bool(drop_last))
        i += 1
    row_col, row_inputs = None, None
    if i < n and names[i] == ASSEMBLER_STAGE:
        row_inputs = tuple(kernels[i].input_cols)
        row_col = kernels[i].output_cols[0]
        for c in row_inputs:
            if c not in ext and c not in units:
                raise refuse(f"stage {i} ({ASSEMBLER_STAGE}) reads {c!r}, "
                             "neither an input column nor a one-hot output")
        i += 1
    first = i
    while i < n and names[i] in SCALER_STAGES:
        i += 1
    body = tuple(range(first, i))
    head_stage = i if i < n and names[i] in (LR_STAGE, KMEANS_STAGE) else None
    if head_stage is not None:
        i += 1
    if i < n:
        raise refuse(f"stage {i} ({names[i] or type(kernels[i].fn).__name__}) "
                     "has no place in the chain")
    if len(body) > MAX_STAGES:
        raise refuse(f"{len(body)} scaler stages > MAX_STAGES={MAX_STAGES}")
    tail = body + (() if head_stage is None else (head_stage,))
    if tail:
        src = tuple(kernels[tail[0]].input_cols)
        if row_col is not None and src != (row_col,):
            raise refuse(f"stage {tail[0]} reads {src}, not the "
                         f"{ASSEMBLER_STAGE}'s output")
        if row_col is None:
            if len(src) != 1 or (src[0] not in ext and src[0] not in units):
                raise refuse(f"stage {tail[0]} reads {src}: the body reads "
                             "one input column or one one-hot output")
            row_inputs = src
        for a, b in zip(tail, tail[1:]):
            if tuple(kernels[b].input_cols) != (kernels[a].output_cols[0],):
                raise refuse(f"stage {b} reads {tuple(kernels[b].input_cols)}"
                             f", not stage {a}'s output: the body is a "
                             "linear run")
    elif row_inputs is None:
        row_inputs = tuple(units)
    scaler_out = [kernels[j].output_cols[0] for j in body]
    if len(set(scaler_out)) != len(scaler_out):
        raise refuse(f"scaler output columns {scaler_out} are not distinct")

    head, head_cols = None, ()
    if head_stage is not None:
        hk = kernels[head_stage]
        head_cols = tuple(hk.output_cols)
        if names[head_stage] == KMEANS_STAGE:
            if hk.fingerprint[3] != "euclidean":
                raise refuse(f"{KMEANS_STAGE} with distance "
                             f"{hk.fingerprint[3]!r} (euclidean only)")
            head = "kmeans"
        else:
            head = "multinomial" if hk.fingerprint[4] else "binomial"

    wanted = list(dict.fromkeys(out_names))
    known = set(units) | set(scaler_out) | set(head_cols) | {row_col}
    if not wanted or any(c not in known for c in wanted):
        raise refuse(f"cannot write the output set {wanted}")
    want_scalers = [c for c in wanted if c in scaler_out]
    if any(c in head_cols for c in wanted):
        if any(c not in wanted for c in head_cols):
            raise refuse(f"cannot write the output set {wanted}: the head "
                         f"writes {head_cols} together")
        if want_scalers and want_scalers != scaler_out[-1:]:
            raise refuse(f"cannot write the output set {wanted}: with the "
                         "head, only the last scaler's output")
        n_run = len(body)
    else:
        head = head_stage = None
        if len(want_scalers) > 1:
            raise refuse(f"cannot write the output set {wanted}: one "
                         "scaler output a launch")
        n_run = scaler_out.index(want_scalers[0]) + 1 if want_scalers else 0
    if not (row_col in wanted or n_run or head):
        # Only one-hot outputs: the row is those units alone.
        row_inputs = tuple(o for o in units if o in wanted)

    written = set()

    def part(c, in_row):
        if c not in units:
            return PartPlan(ext.index(c), in_row=in_row)
        src, mv, drop_last = units[c]
        out = c if c in wanted and c not in written else None
        written.add(out)
        return PartPlan(ext.index(src), (mv, drop_last), out, in_row)

    parts = [part(c, True) for c in row_inputs]
    parts += [part(o, False) for o in units if o in wanted and o not in written]
    if len(parts) > MAX_PARTS:
        raise refuse(f"{len(parts)} input parts > MAX_PARTS={MAX_PARTS}")
    return ChainPlan(
        parts=tuple(parts),
        row_col=row_col if row_col in wanted else None,
        stages=body[:n_run],
        out_col=scaler_out[n_run - 1] if n_run and (
            scaler_out[n_run - 1] in wanted) else None,
        head=head, head_stage=head_stage,
        pred_col=head_cols[0] if head else None,
        raw_col=head_cols[1] if head in ("binomial", "multinomial") else None,
    )


@dataclasses.dataclass(frozen=True)
class TableEntry:
    """One segment of the constant table, in order: ``value`` — a model
    constant as the executor hands it (an array, or a
    :class:`~flinkml_tpu_torch.precision.QuantizedConst`) named ``key``, or
    a ``literal`` float64 array (zeros, a min-max range's scale and
    offset); ``shape`` — what the features need, ``(d,)`` or the head's
    ``(k, d)`` matrix (stored transposed, ``[d][k]``); ``head``: part of
    the head's block, at the compute width; ``post``: 1 the zero guard, 2
    minus entry ``other`` (the min-max span), 3 the squared row norms of
    entry ``other``'s matrix (KMeans ``|C|^2``, ``value`` None)."""

    stage: str
    key: str
    value: object
    shape: Tuple[int, ...]
    head: bool = False
    literal: bool = False
    post: int = 0
    other: int = 0

    @property
    def length(self) -> int:
        return int(np.prod(self.shape))


def table_entries(plan: ChainPlan, kernels, consts,
                  d: int) -> Tuple[list, int]:
    """The table's layout for ``plan`` and its op word: each run stage's
    ``a[d], b[d], [scale, offset]`` (a: the shift or data min; b: the
    scale, max-abs or span), then the head's block (binomial ``coef[d]``;
    multinomial ``W^T [d][k]``; KMeans ``C^T [d][k]`` and ``|C[c]|^2
    [k]``). The one description of the layout: :func:`pack_table` fills
    it with values, :func:`pack_int8` with segments."""
    entries: list = []
    ops = 0

    def add(stage, key, value, shape, **kw):
        entries.append(TableEntry(stage, key, value, shape, **kw))
        return len(entries) - 1

    def literal(stage, v):
        v = np.asarray(v, dtype=np.float64)
        add(stage, "", v, v.shape, literal=True)

    for s, j in enumerate(plan.stages):
        kernel, c = kernels[j], consts[j]
        name = _stage_name(kernel)
        if name == "MinMaxScalerModel":
            lo, hi = kernel.fingerprint[3:5]
            a = add(name, "dataMin", c["dataMin"], (d,))
            add(name, "dataMax", c["dataMax"], (d,), post=2, other=a)
            literal(name, [hi - lo, lo])
            ops |= _MINMAX << (3 * s)
            continue
        if name == "MaxAbsScalerModel":
            sub, div, shift, scale = False, True, None, "maxAbs"
        else:
            shift, scale = ("mean", "std") if name == "StandardScalerModel" \
                else ("median", "range")
            sub, div = kernel.fingerprint[3:5]
        if sub:
            add(name, shift, c[shift], (d,))
        else:
            literal(name, np.zeros(d))
        if div:
            add(name, scale, c[scale], (d,), post=1)
        else:
            literal(name, np.zeros(d))
        literal(name, [0.0, 0.0])
        ops |= (_SUB * bool(sub) | _DIV * bool(div)) << (3 * s)
    if plan.head is not None:
        hc = consts[plan.head_stage]
        name = _stage_name(kernels[plan.head_stage])
        if plan.head == "binomial":
            add(name, "coefficient", hc["coefficient"], (d,), head=True)
        else:
            key = "coefficient" if plan.head == "multinomial" else "centroids"
            k = head_classes(plan, consts)
            m = add(name, key, hc[key], (k, d), head=True)
            if plan.head == "kmeans":
                add(name, "|C|^2", None, (k,), head=True, post=3, other=m)
    return entries, ops


def _entry_value(e: TableEntry, policy, dt: torch.dtype) -> torch.Tensor:
    """The values of entry ``e`` (not a post-3 one) at ``dt`` on the CPU,
    in the entry's shape: a literal as it is; a constant through the
    chain's boundary under ``policy`` (no policy: as it is)."""
    if e.literal:
        t = torch.from_numpy(e.value)
    else:
        v = boundary_const(policy, e.value, "cpu") if _declared(policy) \
            else e.value
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
    if len(e.shape) == 1 and t.numel() != e.length:
        raise ValueError(
            f"{e.stage} constant {e.key!r} has {t.numel()} elements but the "
            f"features have dim {e.length}"
        )
    if len(e.shape) == 2 and tuple(t.shape) != e.shape:
        raise ValueError(
            f"features have dim {e.shape[1]} but the model's {e.key} has "
            f"shape {tuple(t.shape)}"
        )
    return t.reshape(e.shape).to(dt)


def _sq_norms(m: torch.Tensor) -> torch.Tensor:
    """``|C[c]|^2`` of a ``[k, d]`` matrix at its dtype: numpy's sum where
    numpy has the dtype (the bits the untiered table has always had),
    PyTorch's at bfloat16 (each square and the sum rounded, as the plain
    distance rounds them)."""
    if m.dtype == torch.bfloat16:
        return torch.sum(m * m, dim=1)
    a = m.numpy()
    return torch.from_numpy(np.sum(a * a, axis=1, dtype=a.dtype))


def _flat(v: torch.Tensor) -> torch.Tensor:
    return (v.T if v.dim() == 2 else v).reshape(-1)


def pack_table(plan: ChainPlan, kernels, consts, row: torch.dtype, d: int,
               policy=None) -> Tuple[torch.Tensor, int]:
    """The kernel's working table for ``plan`` over a row of ``row`` and
    its op word (:func:`table_entries`): each constant through the chain's
    boundary under ``policy`` (:func:`boundary_const`: cast, or int8
    dequantized; no policy: as it is), then cast to the row's dtype, the
    head's block to the compute width (``policy.compute``, else the
    row's), BEFORE the zero guards and the min-max span (as the stages
    compute them). The table is float64 (a float64 row) or float32 — it
    holds every value exactly."""
    entries, ops = table_entries(plan, kernels, consts, d)
    compute = policy.compute_dtype if _declared(policy) else row
    vals: list = []
    for e in entries:
        if e.post == 3:
            vals.append(_sq_norms(vals[e.other]))
            continue
        v = _entry_value(e, policy, compute if e.head else row)
        if e.post == 1:
            v = torch.where(v > 0, v, torch.ones((), dtype=v.dtype))
        elif e.post == 2:
            v = v - vals[e.other]
        vals.append(v)
    table_dt = torch.float64 if row == torch.float64 else torch.float32
    return torch.cat([torch.zeros(0, dtype=table_dt)]
                     + [_flat(v).to(table_dt) for v in vals]), ops


def pack_int8(plan: ChainPlan, kernels, consts, d: int,
              policy) -> Tuple[np.ndarray, int, Dict[str, int]]:
    """The int8 table of ``plan`` under the int8 ``policy`` (``consts``:
    the executor's, int8 pairs and float arrays): one segment per entry
    of :func:`table_entries` (:data:`SEGMENT_INTS` int32 each, see
    ``csrc/chain.cu``) in a byte blob with the float64 values, the float32
    scales and the int8 codes. Returns ``(blob, ops, layout)`` with the
    element counts and byte offsets in ``layout``. A float constant that
    is not quantized (below the tier's threshold, ``precision.int8_min_const_elems()``) is
    its float32 value (the boundary's cast), KMeans' ``|C|^2`` is summed
    at the compute width from the dequantized centroids; the kernel
    decodes the segments to :func:`pack_table`'s values."""
    entries, ops = table_entries(plan, kernels, consts, d)
    segs: list = []
    vals: list = []
    codes: list = []
    n_vals = n_codes = off = 0

    def floats(v):
        nonlocal n_vals
        v = np.asarray(v, dtype=np.float64).reshape(-1)
        vals.append(v)
        n_vals += v.size
        return n_vals - v.size

    for e in entries:
        kind, sc, per = 0, 0, 1
        if e.post == 3:
            src = floats(_sq_norms(_entry_value(
                entries[e.other], policy, policy.compute_dtype)).numpy())
        elif e.literal:
            src = floats(e.value)
        elif isinstance(e.value, QuantizedConst):
            q = _entry_value(dataclasses.replace(e, value=e.value.q), None,
                             torch.int8)
            codes.append(_flat(q).numpy())
            kind, src, n_codes = 1, n_codes, n_codes + e.length
            sc = floats(np.asarray(e.value.scale, np.float32))
            # A matrix's scales are per column of its last axis: one per
            # k codes of the transposed layout; a vector has one scale.
            per = e.shape[0] if len(e.shape) == 2 else e.length
        else:
            src = floats(_flat(_entry_value(e, policy,
                                            policy.compute_dtype)).numpy())
        post = e.post if e.post in (1, 2) else 0
        segs.append((off, e.length, kind, src, sc, per, post,
                     e.other if post == 2 else 0))
        off += e.length
    seg_bytes = len(segs) * SEGMENT_INTS * 4
    vals_at = -(-seg_bytes // 8) * 8
    codes_at = vals_at + 8 * n_vals
    blob = np.zeros(codes_at + max(n_codes, 1), dtype=np.uint8)
    blob[:seg_bytes] = np.asarray(segs, np.int32).reshape(-1).view(np.uint8)
    if n_vals:
        blob[vals_at:codes_at] = np.concatenate(vals).view(np.uint8)
    if n_codes:
        blob[codes_at:codes_at + n_codes] = np.concatenate(codes).view(
            np.uint8)
    return blob, ops, {"n_table": off, "n_seg": len(segs),
                       "vals_at": vals_at, "codes_at": codes_at}


def head_classes(plan: ChainPlan, consts) -> int:
    """Classes (or centroids) of a multinomial or KMeans head, else 0."""
    def rows(v):
        return int(np.shape(v.q if isinstance(v, QuantizedConst) else v)[0])

    if plan.head == "multinomial":
        return rows(consts[plan.head_stage]["coefficient"])
    if plan.head == "kmeans":
        return rows(consts[plan.head_stage]["centroids"])
    return 0


def _refuse(reason: str) -> _gate.KernelUnsupportedError:
    return _gate.refuse("fused_chain", reason)


@dataclasses.dataclass(frozen=True)
class Layout:
    """:meth:`ChainProgram.layout`'s answer for one signature of inputs:
    each part's width and flags, the row's dtype and width, whether the
    vector route gathers, and the route."""

    widths: Tuple[int, ...]
    dtype: torch.dtype
    d: int
    gather: bool
    route: str
    flags: Tuple[int, ...]


class ChainProgram:
    """A chain planned for ``csrc/chain.cu``: ``run(ext_vals, consts,
    n_valid)`` lays out the row's parts, packs the constants (once per set
    of model arrays, cached by identity) and launches one kernel over the
    first ``n_valid`` rows, under ``policy`` (see the module docstring).

    One program serves every model of its shape (the program key holds
    no constant values), from any thread and CUDA stream: the packed
    tables of the last :data:`TABLES_KEPT` sets of model arrays are kept
    side by side (so two versions served in turn, as in a rolling swap,
    do not repack on every batch), a pack has landed on the device before
    any launch reads it (a synchronous copy), and each launch marks the
    table in use on its stream, so an evicted table's memory is not
    reused while a launch on another stream still reads it."""

    def __init__(self, kernels, ext_names: Sequence[str],
                 out_names: Sequence[str], policy=None):
        self.kernels = tuple(kernels)
        self.ext_names, self.out_names = tuple(ext_names), tuple(out_names)
        self.policy = policy
        self.plan = plan_chain(self.kernels, ext_names, out_names)
        # (slot, array ids, dtype, device, d) -> (arrays, packed), LRU; an
        # entry holds its arrays, so their ids are not reused while it
        # lives.
        self._tables: "collections.OrderedDict" = collections.OrderedDict()
        self._tables_lock = threading.Lock()
        self._layout = None  # (input signature, Layout)

    def _cached(self, slot: str, consts, dtype: torch.dtype,
                device: torch.device, d: int, build):
        """``build()``'s packed table for these model arrays (by
        identity), ``dtype``, ``device`` and ``d``, built on a miss."""
        arrays = tuple(v for kc in consts for v in kc.values())
        key = (slot, tuple(map(id, arrays)), dtype, device, d)
        with self._tables_lock:
            hit = self._tables.get(key)
            if hit is not None:
                self._tables.move_to_end(key)
                return hit[1]
        packed = build()
        with self._tables_lock:
            self._tables[key] = (arrays, packed)
            self._tables.move_to_end(key)
            while len(self._tables) > TABLES_KEPT:
                self._tables.popitem(last=False)
        return packed

    def table(self, consts, dtype: torch.dtype, device: torch.device,
              d: int):
        """The packed constants for a row of ``dtype``: ``(tensor, ops, k,
        int8 layout or None)`` — the working table, or under the int8 tier
        the blob of :func:`pack_int8`."""
        def build():
            k = head_classes(self.plan, consts)
            policy = self.policy
            if _declared(policy) and policy.quant == "int8":
                blob, ops, lay = pack_int8(self.plan, self.kernels, consts, d,
                                           policy)
                return torch.from_numpy(blob).to(device), ops, k, lay
            host, ops = pack_table(self.plan, self.kernels, consts, dtype, d,
                                   policy)
            return host.to(device), ops, k, None
        return self._cached("_table", consts, dtype, device, d, build)

    def float_table(self, consts, dtype: torch.dtype, device: torch.device,
                    d: int):
        """Under the int8 tier, the working table of :func:`pack_table`:
        every int8 pair dequantized once (``q * scale`` at
        ``policy.compute``, the multiply the kernel makes at the load), for
        a table too large for shared memory, which the kernel then reads
        from device memory as under no policy. ``(tensor, ops, k, None)``,
        cached for the life of the model arrays."""
        def build():
            host, ops = pack_table(self.plan, self.kernels, consts, dtype, d,
                                   self.policy)
            return host.to(device), ops, head_classes(self.plan, consts), None
        return self._cached("_float", consts, dtype, device, d, build)

    def layout(self, ext_vals) -> "Layout":
        """How a launch over ``ext_vals`` reads them (a part that is not
        contiguous is read from a contiguous copy, which is aligned); the
        route by :func:`route`. Under a declared policy each float part
        counts at ``policy.compute`` (the boundary cast, made at the load:
        the part's rounding flag)."""
        declared = _declared(self.policy)
        compute = self.policy.compute_dtype if declared else None
        if compute == torch.float16:
            raise _refuse("float16 compute is not supported (the kernel "
                          "computes float32, float64 and bfloat16 rows)")
        widths, flags, row_dtypes, dense = [], [], [], []
        for part in self.plan.parts:
            v = ext_vals[part.ext]
            if v.dtype not in _ELEM:
                raise _refuse(f"input dtype {v.dtype} is not supported "
                              f"(supported: {sorted(map(str, _ELEM))})")
            flag = 0
            if part.onehot is not None:
                if v.dim() != 1:
                    raise _refuse("a one-hot index column must be [rows], "
                                  f"got {tuple(v.shape)}")
                width, dt = part.onehot_width, torch.float64
            else:
                if v.dim() not in (1, 2):
                    raise _refuse("an input must be [rows] or [rows, w], "
                                  f"got {tuple(v.shape)}")
                width = 1 if v.dim() == 1 else v.shape[1]
                # Non-float parts promote to float64 (the stages' rule).
                dt = v.dtype if v.dtype.is_floating_point else torch.float64
                if declared and dt.is_floating_point and dt != compute:
                    if compute == torch.bfloat16:
                        flag = _ROUND_BF16
                    elif is_narrower(compute, dt):
                        flag = _ROUND_F32
                    dt = compute
                dense.append(v.data_ptr() if v.is_contiguous() else 0)
            widths.append(width)
            flags.append(flag)
            if part.in_row:
                row_dtypes.append(dt)
        dtype = functools.reduce(torch.promote_types, row_dtypes)
        if dtype not in SUPPORTED_DTYPES:
            raise _refuse(f"row dtype {dtype} is not supported (supported: "
                          "float32, float64, bfloat16)")
        regs = torch.float64 if dtype == torch.float64 else torch.float32
        parts = self.plan.parts
        d = sum(w for w, p in zip(widths, parts) if p.in_row)
        gather = not (len(parts) == 1 and parts[0].onehot is None
                      and ext_vals[parts[0].ext].dtype == regs)
        return Layout(tuple(widths), dtype, d, gather,
                      route(d, regs.itemsize, *dense,
                            all_in_row=all(p.in_row for p in parts)),
                      tuple(flags))

    def _head_args(self, dtype: torch.dtype):
        """``(rnd, pred dtype, raw dtype)`` of the head over a row of
        ``dtype`` (see ``csrc/chain.cu``): the head computes at the
        declared policy's widths, else at the row's."""
        compute = accum = dtype
        if _declared(self.policy):
            compute = self.policy.compute_dtype
            accum = self.policy.accum_dtype
            if dtype != torch.float64 and torch.float64 in (compute, accum):
                raise _refuse(f"a head at {compute}/{accum} over a {dtype} "
                              "row is not supported")
        rnd = 0
        if dtype == torch.float64:
            rnd |= {torch.bfloat16: _IN_BF16, torch.float32: _IN_F32}.get(
                compute, 0)
            rnd |= {torch.bfloat16: _OUT_BF16, torch.float32: _OUT_F32}.get(
                accum, 0)
        elif accum == torch.bfloat16:
            rnd |= _OUT_BF16
        return rnd, compute, accum

    def placement(self, lay: "Layout", k: int, n_table: int,
                  quant: bool) -> Tuple[bool, int, int, int, int]:
        """How a launch over rows of ``lay`` stages a table of ``n_table``
        elements (``quant``: int8, dequantized into shared memory only):
        ``(vector route, lane group, table elements in shared memory,
        threads a block, shared-memory bytes)``. Under the int8 tier fewer
        than ``n_table`` elements in shared memory means the launch takes
        the float table (:meth:`float_table`). Raises
        :class:`KernelUnsupportedError` when one warp's rows do not fit."""
        plan, d = self.plan, lay.d
        item = 8 if lay.dtype == torch.float64 else 4
        vector = lay.route == "vector"
        group, rows_per_warp, _ = lane_group(d, item) if vector else (0, 1, 0)
        class_head = plan.head in ("multinomial", "kmeans")
        if not (not vector or lay.gather or class_head or quant):
            return vector, group, 0, SCALAR_THREADS, 0
        # Each warp of a class head stages its rows, and (multinomial) the
        # row's logits, in shared memory.
        logits = k if plan.head == "multinomial" else 0
        n_stages = plan.n_run * (2 * d + 2)
        place = None
        if vector:
            per_warp = rows_per_warp * d + logits if class_head else 0
            place = shared_memory(n_table, n_stages, per_warp,
                                  VECTOR_THREADS // 32, item, quant)
            if place is None or place[1] < VECTOR_THREADS // 32:
                # A vector block keeps all its warps: the scalar route
                # takes the rows.
                vector, group, place = False, 0, None
        if not vector:
            per_warp = d + logits if class_head else 0
            place = shared_memory(n_table, n_stages, per_warp,
                                  SCALAR_THREADS // 32, item, quant)
        if place is None:
            raise _refuse(
                f"a {plan.head} head over d={d} with {k} classes stages "
                f"{per_warp * item} bytes a row beside a table of "
                f"{n_table * item if quant else 0} bytes, more than the "
                f"{MAX_SMEM_BYTES} bytes of shared memory a block can hold"
            )
        n_smem, warps, smem = place
        return vector, group, n_smem, warps * 32, smem

    def __call__(self, ext_vals, consts, n_valid: int) -> Dict[str, torch.Tensor]:
        plan = self.plan
        for v in ext_vals:
            if v.device.type != "cuda":
                raise _refuse(f"device {v.device} is not CUDA")
        # The layout depends on the inputs' dtypes, shapes, strides and
        # 16-byte alignment only: kept for the last such signature.
        sig = tuple((v.dtype, v.shape, v.stride(), v.data_ptr() % VECTOR_BYTES)
                    for v in ext_vals)
        cached = self._layout  # one read: another thread may replace it
        if cached is None or cached[0] != sig:
            cached = self._layout = (sig, self.layout(ext_vals))
        lay = cached[1]
        dtype, d, gather = lay.dtype, lay.d, lay.gather
        device = ext_vals[0].device
        bucket = ext_vals[0].shape[0]
        table, ops, k, quant = self.table(consts, dtype, device, d)
        n_table = quant["n_table"] if quant else table.numel()
        _, group, n_smem, threads, smem = self.placement(
            lay, k, n_table, quant is not None)
        if quant and n_smem < n_table:
            # The int8 table does not fit in shared memory: launch on the
            # float table, its head read from device memory.
            table, ops, k, quant = self.float_table(consts, dtype, device, d)

        rnd, compute, accum = self._head_args(dtype)
        new = functools.partial(torch.empty, device=device)
        outs: Dict[str, torch.Tensor] = {}
        parts = _PartList()
        offset = 0
        # Held until the launch is enqueued: a contiguous copy freed earlier
        # could be handed to an output below.
        srcs = [ext_vals[part.ext].contiguous() for part in plan.parts]
        for i, (part, width, flag, v) in enumerate(zip(
                plan.parts, lay.widths, lay.flags, srcs)):
            p = parts.p[i]
            p.src, p.width = v.data_ptr(), width
            p.code = _ELEM[v.dtype] | flag
            if part.onehot is not None:
                max_index, drop_last = part.onehot
                p.max_index, p.base = max_index, width - 1
                p.code |= _ONEHOT | (_DROP_LAST if drop_last else 0)
                if part.out_col is not None:
                    outs[part.out_col] = new((bucket, width),
                                             dtype=torch.float64)
                    p.out = outs[part.out_col].data_ptr()
            p.offset = offset if part.in_row else -1
            offset += width if part.in_row else 0
        for col in (plan.row_col, plan.out_col):
            if col is not None:
                outs[col] = new((bucket, d), dtype=dtype)
        pred_ty = raw_ty = 0
        if plan.head == "kmeans":
            outs[plan.pred_col] = new((bucket,), dtype=torch.int64)
        elif plan.head is not None:
            outs[plan.pred_col] = new((bucket,), dtype=compute)
            outs[plan.raw_col] = new(
                (bucket, 2 if plan.head == "binomial" else k), dtype=accum)
            regs = torch.float64 if dtype == torch.float64 else torch.float32
            pred_ty = 0 if compute == regs else _OUT_TY[compute]
            raw_ty = 0 if accum == regs else _OUT_TY[accum]

        def ptr(col):
            return outs[col].data_ptr() if col in outs else None

        narrow_f64 = dtype == torch.float64 and (
            rnd & (_IN_BF16 | _IN_F32) or any(lay.flags))
        fn = _build.function(
            "chain", _SYMBOLS["f64_tier" if narrow_f64 else dtype], _ARGTYPES)
        check_part_layout()
        if quant:
            base = table.data_ptr()
            qargs = (base, quant["n_seg"], base + quant["vals_at"],
                     base + quant["codes_at"])
        else:
            qargs = (None, 0, None, None)
        with torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            table.record_stream(current)
            stream = current.cuda_stream
            code = fn(ctypes.addressof(parts), len(plan.parts), int(gather),
                      None if quant else table.data_ptr(), n_table, n_smem,
                      plan.n_run, ops, d, _HEAD_CODE[plan.head], k, group,
                      threads, int(n_valid), smem,
                      ptr(plan.row_col), ptr(plan.out_col),
                      ptr(plan.pred_col), ptr(plan.raw_col),
                      rnd, pred_ty, raw_ty, *qargs, stream)
        _build.check("fused_chain", "chain", code)
        LAUNCHES.bump()
        return outs


@functools.lru_cache(maxsize=None)
def check_part_layout() -> None:
    """Raise unless the built kernel's ``struct Part`` has the size of
    :class:`_Part` (the layout the host fills); checked once."""
    size = _build.function("chain", "fml_chain_part_bytes", [])()
    if size != ctypes.sizeof(_Part):
        raise RuntimeError(
            f"kernels[fused_chain]: csrc/chain.cu's Part is {size} bytes, "
            f"the host's {ctypes.sizeof(_Part)}"
        )


def build_chain(kernels, ext_names: Sequence[str], out_names: Sequence[str],
                device: torch.device, policy=None):
    """The chain program for ``device`` under ``policy``:
    :func:`chain_plain` on the CPU, a :class:`ChainProgram` (planned now,
    so an unsupported chain refuses before anything runs) on CUDA."""
    kernels = tuple(kernels)
    if device.type == "cpu":
        return functools.partial(chain_plain, kernels, tuple(ext_names),
                                 tuple(out_names), policy=policy)
    if device.type != "cuda":
        raise _refuse(f"device {device} is not CUDA")
    return ChainProgram(kernels, ext_names, out_names, policy)


def fused_chain(kernels, ext_names: Sequence[str], out_names: Sequence[str],
                ext_vals, n_valid: int) -> Dict[str, torch.Tensor]:
    """One-shot wrapper: the chain over ``ext_vals`` with the kernels' own
    constants — plain for CPU tensors, the CUDA kernel for CUDA tensors."""
    run = build_chain(kernels, ext_names, out_names, ext_vals[0].device)
    return run(ext_vals, tuple(k.constants for k in kernels), n_valid)
