"""Fused transform chain — one kernel launch per run of stages.

Replaces ``flinkml_tpu/kernels/chain.py:173 pallas_chain_fn``. The Pallas
kernel traces any row-local ``ColumnKernel`` chain; a hand-written CUDA
kernel cannot, so ``csrc/chain.cu`` implements the chains this slice of
the port can build: a linear run of up to :data:`MAX_STAGES` scaler stages
(Standard, MinMax, MaxAbs, Robust scaler models), optionally ending in the
binomial ``LogisticRegressionModel`` head. Any other chain, dtype or width
raises :class:`~flinkml_tpu_torch.kernels.KernelUnsupportedError` on CUDA
tensors; nothing falls back to the eager path there.

Two versions of one contract ``run(ext_vals, consts, n_valid) -> {col:
tensor}`` (``consts``: per kernel, its host constant arrays):

- :func:`chain_plain` — the plain PyTorch version: each kernel's ``fn`` in
  order. The executor's path for CPU tensors, and the reference the CUDA
  kernel is held against.
- :class:`ChainProgram` — the CUDA kernel. The host reads each stage's op
  from its fingerprint, casts its constants to the compute dtype BEFORE the
  zero guards (as the per-stage transforms do), packs them into one small
  table (uploaded once per set of model arrays), and launches on one of two
  routes, picked by the fixed rule :func:`route`: ``vector`` (lane groups
  with 16-byte loads, for rows of whole 16-byte chunks) or ``scalar`` (one
  warp per row, any width).

Which outputs are written follows the executor's request: the eager
program of a scaler→LR run writes the last scaler's output (pinned by the
head's ``pin_inputs``) and the head's ``prediction``/``rawPrediction``; a
lazy intermediate ``s_j`` runs the same kernel truncated after stage j.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.kernels import _build, _gate

#: Scaler stages one launch applies at most (3 op bits each in a 32-bit word).
MAX_STAGES = 8

#: Shared memory a block may use on the H100 (the per-stage constants and
#: the coefficient live there).
MAX_SMEM_BYTES = 232_448

SUPPORTED_DTYPES = (torch.float32, torch.float64)

SCALER_STAGES = ("StandardScalerModel", "MinMaxScalerModel",
                 "MaxAbsScalerModel", "RobustScalerModel")
HEAD_STAGE = "LogisticRegressionModel"

LAUNCHES = _gate.launch_counter("fused_chain")

#: Bytes of one vector access of the ``vector`` route, and the most such
#: chunks a row may have there (one lane each, a warp per row at most).
VECTOR_BYTES = 16
MAX_VECTOR_CHUNKS = 32
ROUTES = ("vector", "scalar")

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,      # x, table
    ctypes.c_int, ctypes.c_uint,           # n_run, ops
    ctypes.c_int, ctypes.c_int,            # d, head
    ctypes.c_int,                          # group (0: the scalar route)
    ctypes.c_int64,                        # n_rows
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # out, pred, raw
    ctypes.c_void_p,                       # stream
]
_SYMBOLS = {torch.float32: "fml_fused_chain_f32",
            torch.float64: "fml_fused_chain_f64"}

# Op bits of one stage (see csrc/chain.cu).
_MINMAX, _SUB, _DIV = 1, 2, 4


def route(d: int, itemsize: int, x_ptr: int) -> str:
    """The fixed rule: ``vector`` when a row of ``d`` elements is a whole
    number of 16-byte chunks, at most :data:`MAX_VECTOR_CHUNKS`, and x
    starts 16-byte aligned (then every row does); ``scalar`` otherwise."""
    chunks, rest = divmod(d * itemsize, VECTOR_BYTES)
    if rest == 0 and 1 <= chunks <= MAX_VECTOR_CHUNKS \
            and x_ptr % VECTOR_BYTES == 0:
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


def _stage_name(kernel) -> str:
    return kernel.fingerprint[0] if kernel.fingerprint else ""


def chain_plain(kernels, ext_names: Sequence[str], out_names: Sequence[str],
                ext_vals, consts, n_valid: int) -> Dict[str, torch.Tensor]:
    """The plain PyTorch chain: each kernel's ``fn`` in order, up to the
    last kernel an ``out_names`` column needs."""
    producer = {c: j for j, k in enumerate(kernels) for c in k.output_cols}
    last = max(producer[c] for c in out_names)
    bucket = ext_vals[0].shape[0]
    device = ext_vals[0].device
    valid = (torch.arange(bucket, device=device) < n_valid).to(torch.float32)
    cols = dict(zip(ext_names, ext_vals))
    for kernel, kc in zip(kernels[:last + 1], consts):
        cols.update(kernel.fn(
            {c: cols[c] for c in kernel.input_cols}, kc, valid
        ))
    return {c: cols[c] for c in out_names}


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """What one launch computes: ``n_run`` scaler stages, the output of the
    last one written to ``out_col`` (None: not written), and with ``head``
    the LR outputs ``pred_col``/``raw_col``."""

    n_run: int
    out_col: Optional[str]
    head: bool
    pred_col: Optional[str] = None
    raw_col: Optional[str] = None


def plan_chain(kernels, ext_names: Sequence[str],
               out_names: Sequence[str]) -> ChainPlan:
    """Check that ``csrc/chain.cu`` computes this chain and these outputs;
    raise :class:`KernelUnsupportedError` naming the reason if not."""
    def refuse(reason):
        return _gate.refuse("fused_chain", reason)

    kernels = tuple(kernels)
    if not kernels:
        raise refuse("empty chain")
    names = [_stage_name(k) for k in kernels]
    head = names[-1] == HEAD_STAGE
    scalers = kernels[:-1] if head else kernels
    for i, name in enumerate(names[:len(scalers)]):
        if name not in SCALER_STAGES:
            raise refuse(
                f"stage {i} ({name or type(kernels[i].fn).__name__}) has no "
                f"fused_chain op; supported stages: {SCALER_STAGES} "
                f"optionally ending in {HEAD_STAGE}"
            )
    if not scalers:
        raise refuse("the chain has no scaler stage")
    if len(scalers) > MAX_STAGES:
        raise refuse(f"{len(scalers)} scaler stages > MAX_STAGES={MAX_STAGES}")
    if head and kernels[-1].fingerprint[4]:
        raise refuse("multinomial LogisticRegressionModel (binomial only)")
    ext_names = tuple(ext_names)
    if ext_names != tuple(scalers[0].input_cols):
        raise refuse(
            f"the chain reads columns {ext_names}; the kernel reads one "
            "column, the first stage's input"
        )
    for i in range(1, len(kernels)):
        if tuple(kernels[i].input_cols) != (kernels[i - 1].output_cols[0],):
            raise refuse(
                f"stage {i} reads {tuple(kernels[i].input_cols)}, not stage "
                f"{i - 1}'s output: the kernel runs linear chains only"
            )
    scaler_out = [k.output_cols[0] for k in scalers]
    if len(set(scaler_out)) != len(scaler_out):
        raise refuse(f"scaler output columns {scaler_out} are not distinct")
    wanted = list(dict.fromkeys(out_names))
    if head:
        pred_col, raw_col = kernels[-1].output_cols
        if pred_col in wanted or raw_col in wanted:
            out_col = scaler_out[-1] if scaler_out[-1] in wanted else None
            extra = set(wanted) - {out_col, pred_col, raw_col}
            if extra or pred_col not in wanted or raw_col not in wanted:
                raise refuse(f"cannot write the output set {wanted}")
            return ChainPlan(len(scalers), out_col, True, pred_col, raw_col)
    if len(wanted) != 1 or wanted[0] not in scaler_out:
        raise refuse(f"cannot write the output set {wanted}")
    return ChainPlan(scaler_out.index(wanted[0]) + 1, wanted[0], False)


def _stage_entry(kernel, consts: Mapping[str, np.ndarray], dt: np.dtype,
                 d: int):
    """``(op bits, a[d], b[d], scale, offset)`` of one scaler stage, its
    constants cast to ``dt`` first and zero-guarded after."""
    def vec(key):
        v = np.asarray(consts[key]).astype(dt).reshape(-1)
        if v.shape[0] != d:
            raise ValueError(
                f"{_stage_name(kernel)} constant {key!r} has dim "
                f"{v.shape[0]} but the features have dim {d}"
            )
        return v

    def guard(v):
        return np.where(v > 0, v, dt.type(1)).astype(dt)

    name = _stage_name(kernel)
    zeros = np.zeros(d, dt)
    if name in ("StandardScalerModel", "RobustScalerModel"):
        shift, scale = ("mean", "std") if name == "StandardScalerModel" \
            else ("median", "range")
        sub, div = kernel.fingerprint[3:5]
        return (_SUB * bool(sub) | _DIV * bool(div),
                vec(shift) if sub else zeros,
                guard(vec(scale)) if div else zeros, 0.0, 0.0)
    if name == "MaxAbsScalerModel":
        return _DIV, zeros, guard(vec("maxAbs")), 0.0, 0.0
    lo, hi = kernel.fingerprint[3:5]
    dmin = vec("dataMin")
    return _MINMAX, dmin, vec("dataMax") - dmin, hi - lo, lo


def pack_table(plan: ChainPlan, kernels, consts, dt: np.dtype,
               d: int) -> Tuple[np.ndarray, int]:
    """The kernel's constant table (type ``dt``) and op word for ``plan``."""
    parts, ops = [], 0
    for s in range(plan.n_run):
        bits, a, b, scale, offset = _stage_entry(kernels[s], consts[s], dt, d)
        ops |= bits << (3 * s)
        parts += [a, b, np.asarray([scale, offset], dtype=dt)]
    if plan.head:
        coef = np.asarray(consts[-1]["coefficient"]).astype(dt)
        if coef.shape != (d,):
            raise ValueError(
                f"features have dim {d} but the model coefficient has shape "
                f"{coef.shape}"
            )
        parts.append(coef)
    return np.concatenate(parts), ops


class ChainProgram:
    """A chain planned for ``csrc/chain.cu``: ``run(ext_vals, consts,
    n_valid)`` packs the constants (once per set of model arrays, cached by
    identity) and launches one kernel over the first ``n_valid`` rows."""

    def __init__(self, kernels, ext_names: Sequence[str],
                 out_names: Sequence[str]):
        self.kernels = tuple(kernels)
        self.plan = plan_chain(self.kernels, ext_names, out_names)
        self._table = None   # (arrays, dtype, device, tensor, ops)

    def table(self, consts, dtype: torch.dtype, device: torch.device,
              d: int) -> Tuple[torch.Tensor, int]:
        arrays = tuple(v for kc in consts for v in kc.values())
        hit = self._table
        if (hit is not None and hit[1] == dtype and hit[2] == device
                and len(hit[0]) == len(arrays)
                and all(a is b for a, b in zip(hit[0], arrays))):
            return hit[3], hit[4]
        np_dt = np.dtype(str(dtype).replace("torch.", ""))
        host, ops = pack_table(self.plan, self.kernels, consts, np_dt, d)
        tensor = torch.from_numpy(host).to(device)
        self._table = (arrays, dtype, device, tensor, ops)
        return tensor, ops

    def __call__(self, ext_vals, consts, n_valid: int) -> Dict[str, torch.Tensor]:
        plan = self.plan
        x = ext_vals[0]
        if x.device.type != "cuda":
            raise _gate.refuse("fused_chain", f"device {x.device} is not CUDA")
        if not x.dtype.is_floating_point:
            x = x.to(torch.float64)   # the scalers' dtype rule
        if x.dtype not in SUPPORTED_DTYPES:
            raise _gate.refuse(
                "fused_chain",
                f"input dtype {x.dtype} is not supported (supported: "
                "float32, float64)",
            )
        if x.dim() == 1:
            x = x.reshape(-1, 1)
        if x.dim() != 2:
            raise _gate.refuse("fused_chain",
                               f"input must be [rows, d], got {tuple(x.shape)}")
        x = x.contiguous()
        bucket, d = x.shape
        n_table = plan.n_run * (2 * d + 2) + (d if plan.head else 0)
        if n_table * x.element_size() > MAX_SMEM_BYTES:
            raise _gate.refuse(
                "fused_chain",
                f"d={d} with {plan.n_run} stages needs "
                f"{n_table * x.element_size()} bytes of constants, more "
                f"than the {MAX_SMEM_BYTES} bytes of shared memory a block "
                "can hold",
            )
        group = (lane_group(d, x.element_size())[0]
                 if route(d, x.element_size(), x.data_ptr()) == "vector"
                 else 0)
        table, ops = self.table(consts, x.dtype, x.device, d)
        new = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
        outs: Dict[str, torch.Tensor] = {}
        if plan.out_col is not None:
            outs[plan.out_col] = new((bucket, d))
        if plan.head:
            outs[plan.pred_col] = new((bucket,))
            outs[plan.raw_col] = new((bucket, 2))

        def ptr(col):
            return outs[col].data_ptr() if col in outs else None

        fn = _build.function("chain", _SYMBOLS[x.dtype], _ARGTYPES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = fn(x.data_ptr(), table.data_ptr(), plan.n_run, ops, d,
                      int(plan.head), group, int(n_valid), ptr(plan.out_col),
                      ptr(plan.pred_col), ptr(plan.raw_col), stream)
        _build.check("fused_chain", "chain", code)
        LAUNCHES.bump()
        return outs


def build_chain(kernels, ext_names: Sequence[str], out_names: Sequence[str],
                device: torch.device):
    """The chain program for ``device``: :func:`chain_plain` on the CPU,
    a :class:`ChainProgram` (planned now, so an unsupported chain refuses
    before anything runs) on CUDA."""
    kernels = tuple(kernels)
    if device.type == "cpu":
        return functools.partial(chain_plain, kernels, tuple(ext_names),
                                 tuple(out_names))
    if device.type != "cuda":
        raise _gate.refuse("fused_chain", f"device {device} is not CUDA")
    return ChainProgram(kernels, ext_names, out_names)


def fused_chain(kernels, ext_names: Sequence[str], out_names: Sequence[str],
                ext_vals, n_valid: int) -> Dict[str, torch.Tensor]:
    """One-shot wrapper: the chain over ``ext_vals`` with the kernels' own
    constants — plain for CPU tensors, the CUDA kernel for CUDA tensors."""
    run = build_chain(kernels, ext_names, out_names, ext_vals[0].device)
    return run(ext_vals, tuple(k.constants for k in kernels), n_valid)
