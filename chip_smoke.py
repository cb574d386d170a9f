#!/usr/bin/env python3
"""Smoke test of flinkml_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It drives the PyTorch port only (nothing of JAX, nothing of ``flinkml_tpu``)
and fails with a non-zero exit if any phase fails:

1. prints the card's name and power limit; builds every CUDA kernel from
   ``flinkml_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. kernel phase: each kernel against its plain PyTorch version at the main
   paths' shapes — ``spmv`` at 65,536 and 262,144 rows x 39 slots, dim
   1e6, float32;
   ``fused_chain`` at 100,000 x 32 in float64 and float32; ``segment_sum``
   at the sparse-fit step (262,144 x 39 cells into 1e6 segments, float32
   and float64, unsorted and sorted) and with a row payload (2^20 cells x
   16 into 65,536 segments) — with CUDA-event times (L2 flushed before each
   launch), the plain version's and the library call's time, and the bound
   from bytes and operations;
3. sparse serving path: LogisticRegressionModel (dim 1e6, seeded
   coefficient, built with ``stage_from_arrays``) transforms 65,536
   Criteo-profile SparseVector rows 4 times (a first call, then 3 timed);
   margins are checked against float64 numpy;
4. dense serving path: the four scalers are fitted on seeded data
   (100,000 x 32), an LR head with a seeded coefficient closes the chain,
   and ``PipelineModel.transform`` runs 4 times fused (a first call, then 3
   timed), then per-stage, then after a save -> load round trip; outputs
   are checked against each other and against a float64 numpy reference;
5. dense fit path: ``LogisticRegression().fit`` on the bench's a9a-width
   data (1,000,000 x 123 float32, batch 262,144, 20 epochs, tol 0), twice
   (a first fit, then a steady one), the coefficient held against a float64
   numpy run of the same steps; the device loop timed alone;
6. sparse fit path: ``LogisticRegression().fit`` on 262,144 Criteo-profile
   SparseVector rows (dim 1e6, batch 262,144, 20 epochs, tol 0; layout
   ``unsorted``), twice, and ``train_linear_model_sparse_csr`` with layout
   ``sorted``, each held against a float64 numpy run of the same steps;
   the host's CSR conversion and packing timed apart from the device loop.

Each path runs with the launch counters set to 0 just before it and read
just after; a path whose kernel never launched fails. The last lines are
the kernels' JSON summary, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# vector (non-tensor-core) float32 / float64 rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

SPMV_ROWS, SPMV_DIM, SPMV_NNZ = 65_536, 1_000_000, 39
CHAIN_ROWS, CHAIN_D = 100_000, 32
# The fits: the bench's dense (a9a-width) and Criteo sparse workloads.
DENSE_FIT_ROWS, DENSE_FIT_D = 1_000_000, 123
SPARSE_FIT_ROWS = 262_144
FIT_BATCH, FIT_EPOCHS, FIT_LR = 262_144, 20, 0.1
PAYLOAD_CELLS, PAYLOAD_K, PAYLOAD_SEGMENTS = 1 << 20, 16, 65_536


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def make_criteo_csr(n, dim=1_000_000, nnz=39, seed=0, n_active=256):
    """Criteo-profile CSR (``nnz`` uniform-random columns per row over
    ``dim``), the generator of the repo's sparse benchmark."""
    rng = np.random.default_rng(seed)
    indptr = np.arange(n + 1, dtype=np.int64) * nnz
    indices = rng.integers(0, dim, size=n * nnz).astype(np.int32)
    values = rng.normal(size=n * nnz).astype(np.float32)
    active = rng.choice(dim, size=n_active, replace=False)
    beta = np.zeros(dim, dtype=np.float32)
    beta[active] = rng.normal(size=n_active)
    margins = (
        values.reshape(n, nnz) * beta[indices.reshape(n, nnz)]
    ).sum(axis=1)
    y = (margins > 0).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    return indptr, indices, values, y, w


def make_data(n, dim, seed=0, dtype=np.float32):
    """Dense a9a-width data with planted labels, the generator of the
    repo's dense benchmark."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(dtype)
    true_coef = rng.normal(size=dim).astype(dtype)
    y = (x @ true_coef > 0).astype(dtype)
    w = np.ones(n, dtype=dtype)
    return x, y, w


def criteo_rows(indices, values, n, nnz, dim):
    """SparseVector rows of a ``make_criteo_csr`` draw; duplicate draws
    within a row merge by sum (CSR semantics)."""
    from flinkml_tpu_torch.linalg import SparseVector

    idx2 = indices.reshape(n, nnz)
    order = np.argsort(idx2, axis=1, kind="stable")
    si = np.take_along_axis(idx2, order, axis=1)
    sv = np.take_along_axis(values.reshape(n, nnz).astype(np.float64), order,
                            axis=1)
    first = np.ones((n, nnz), dtype=bool)
    first[:, 1:] = si[:, 1:] != si[:, :-1]
    starts = np.flatnonzero(first.reshape(-1))
    merged_i = si.reshape(-1)[starts].astype(np.int64)
    merged_v = np.add.reduceat(sv.reshape(-1), starts)
    bounds = np.concatenate([[0], np.cumsum(first.sum(axis=1))])
    rows = np.empty(n, dtype=object)
    for r in range(n):
        lo, hi = bounds[r], bounds[r + 1]
        rows[r] = SparseVector._from_sorted(dim, merged_i[lo:hi],
                                            merged_v[lo:hi])
    return rows


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Mean device time of one call, by CUDA events around each call, with
    the 50 MB L2 flushed (a 256 MB write) before every call so inputs come
    from device memory as they do on the main path."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, warmup: int = 3, iters: int = 20) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.mean([s.elapsed_time(e) for s, e in pairs]))


def timed_calls(torch, fn, calls: int = 3):
    """``(first_s, steady_s, result)``: host-clock seconds of a first call
    (set-up: uploads, program builds) and the mean of ``calls`` more, each
    ending in ``torch.cuda.synchronize()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(calls):
        result = fn()
    torch.cuda.synchronize()
    return first, (time.perf_counter() - t0) / calls, result


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item())


def check_close(name, got, want, rtol, atol):
    torch = sys.modules["torch"]
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    if not torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol):
        fail(f"{name}: max abs err {max_err(got, want)} beyond "
             f"rtol={rtol} atol={atol}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


# -- phase 2: kernels against their plain versions ------------------------------

def spmv_phase(torch, timer, rows=SPMV_ROWS):
    """``spmv`` at ``rows`` x 39 cells, dim 1e6: the serving shape (65,536
    rows) or the sparse fit's (262,144 rows)."""
    from flinkml_tpu_torch.kernels import spmv as kspmv

    indptr, indices, values, _, _ = make_criteo_csr(rows, SPMV_DIM,
                                                    SPMV_NNZ, seed=1)
    w_host = np.random.default_rng(2).normal(size=SPMV_DIM).astype(np.float32)
    idx = torch.from_numpy(indices.reshape(rows, SPMV_NNZ)).cuda()
    val = torch.from_numpy(values.reshape(rows, SPMV_NNZ)).cuda()
    w = torch.from_numpy(w_host).cuda()
    got = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    want = kspmv.spmv_plain(idx, val, w)
    check_close("spmv vs plain", got, want, 1e-5, 1e-5)
    ref = (values.astype(np.float64).reshape(rows, SPMV_NNZ)
           * w_host.astype(np.float64)[indices.reshape(rows, SPMV_NNZ)]
           ).sum(axis=1)
    check_close("spmv vs float64 numpy", got, torch.from_numpy(ref).cuda(),
                1e-5, 1e-5)

    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr).cuda(), idx.reshape(-1).long(),
        val.reshape(-1), size=(rows, SPMV_DIM),
    )
    library_call = "torch.mv(sparse_csr_tensor, w)"
    library = lambda: torch.mv(csr, w)  # noqa: E731
    try:
        lib_out = library()
    except (RuntimeError, NotImplementedError):
        library_call = "torch.sparse.mm(sparse_csr_tensor, w[:, None])"
        library = lambda: torch.sparse.mm(csr, w[:, None])  # noqa: E731
        lib_out = library()
    check_close("spmv vs library", got, lib_out.reshape(-1), 1e-5, 1e-5)

    ms = timer(lambda: kspmv.spmv(idx, val, w))
    plain_ms = timer(lambda: kspmv.spmv_plain(idx, val, w))
    library_ms = timer(library)
    touched = np.unique(indices).size
    n_bytes = idx.numel() * 4 + val.numel() * 4 + touched * 4 + rows * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * val.numel(), "float32")
    rec = {
        "name": "spmv", "route": "cuda",
        "source": "flinkml_tpu_torch/kernels/csrc/spmv.cu",
        "replaces": "flinkml_tpu/kernels/spmv.py:74",
        "shape": [rows, SPMV_NNZ, SPMV_DIM], "dtype": "float32",
        "max_abs_err": max_err(got, want), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library_call": library_call,
    }
    log("kernel " + json.dumps(rec))
    return rec


def chain_models(x, coef):
    """The five-stage chain with statistics computed in float64 numpy."""
    from flinkml_tpu_torch import (
        LogisticRegressionModel, MaxAbsScalerModel, MinMaxScalerModel,
        RobustScalerModel, StandardScalerModel, Table,
    )

    s = (x - x.mean(0)) / x.std(0)
    mn, mx = s.min(0), s.max(0)
    m = (s - mn) / (mx - mn)
    ma = np.abs(m).max(0)
    a = m / ma
    q = np.quantile(a, [0.25, 0.75], axis=0)
    stages = [
        StandardScalerModel().set_model_data(
            Table({"mean": x.mean(0)[None], "std": x.std(0)[None]})),
        MinMaxScalerModel().set_model_data(
            Table({"dataMin": mn[None], "dataMax": mx[None]})),
        MaxAbsScalerModel().set_model_data(Table({"maxAbs": ma[None]})),
        RobustScalerModel().set_model_data(
            Table({"median": np.median(a, 0)[None],
                   "range": (q[1] - q[0])[None]})),
    ]
    prev = "features"
    for i, st in enumerate(stages, start=1):
        st.set(st.INPUT_COL, prev).set(st.OUTPUT_COL, f"s{i}")
        prev = f"s{i}"
    lr = LogisticRegressionModel().set(LogisticRegressionModel.FEATURES_COL,
                                       prev)
    lr.set_model_data(Table({"coefficient": coef[None]}))
    return stages + [lr]


def chain_phase(torch, timer, dtype, rtol, atol):
    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.kernels import chain as kchain

    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(CHAIN_ROWS, CHAIN_D))
    coef = rng.normal(size=CHAIN_D)
    kernels = [s.transform_kernel() for s in chain_models(x, coef)]
    bucket = pipeline_fusion.row_bucket(CHAIN_ROWS)
    xp = torch.zeros((bucket, CHAIN_D), dtype=tdt, device="cuda")
    xp[:CHAIN_ROWS] = torch.from_numpy(x).to(device="cuda", dtype=tdt)
    outs = ["s4", "prediction", "rawPrediction"]
    program = kchain.ChainProgram(kernels, ["features"], outs)
    host_consts = tuple(k.constants for k in kernels)
    dev_consts = tuple({c: torch.as_tensor(v).cuda() for c, v in kc.items()}
                       for kc in host_consts)
    got = program([xp], host_consts, CHAIN_ROWS)
    torch.cuda.synchronize()
    want = kchain.chain_plain(kernels, ["features"], outs, [xp], dev_consts,
                              CHAIN_ROWS)
    err = 0.0
    for c in ("s4", "rawPrediction"):
        check_close(f"fused_chain[{dtype}] {c}", got[c][:CHAIN_ROWS],
                    want[c][:CHAIN_ROWS], rtol, atol)
        err = max(err, max_err(got[c][:CHAIN_ROWS], want[c][:CHAIN_ROWS]))
    dot = torch.matmul(got["s4"][:CHAIN_ROWS].double(),
                       torch.from_numpy(coef).cuda())
    decisive = dot.abs() > 1e-4
    if not torch.equal(got["prediction"][:CHAIN_ROWS][decisive],
                       want["prediction"][:CHAIN_ROWS][decisive]):
        fail(f"fused_chain[{dtype}] prediction differs from plain")

    ms = timer(lambda: program([xp], host_consts, CHAIN_ROWS))
    plain_ms = timer(lambda: kchain.chain_plain(
        kernels, ["features"], outs, [xp], dev_consts, CHAIN_ROWS))
    item = xp.element_size()
    n, d = CHAIN_ROWS, CHAIN_D
    table_bytes = (4 * (2 * d + 2) + d) * item
    n_bytes = n * d * item * 2 + n * item + 2 * n * item + table_bytes
    # Per element: Standard 2 (sub, div), MinMax 5 (sub, cmp, div, mul, add),
    # MaxAbs 1, Robust 1 (div), dot 2; per row ~5 for the sigmoid head.
    n_ops = n * d * 11 + n * 5
    b_ms, b_by = bound_ms(n_bytes, n_ops, dtype)
    rec = {
        "name": "fused_chain", "route": "cuda",
        "source": "flinkml_tpu_torch/kernels/csrc/chain.cu",
        "replaces": "flinkml_tpu/kernels/chain.py:173",
        "shape": [n, d], "dtype": dtype, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }
    log("kernel " + json.dumps(rec))
    return rec


# -- phase 3: sparse LR serving path ---------------------------------------------

def sparse_path(torch):
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.ops.sparse import sparse_margins

    n, dim, nnz = SPMV_ROWS, SPMV_DIM, SPMV_NNZ
    indptr, indices, values, _, _ = make_criteo_csr(n, dim, nnz, seed=0)
    coef = np.random.default_rng(4).normal(size=dim)
    model = fml.stage_from_arrays(
        "flinkml_tpu.models.logistic_regression.LogisticRegressionModel",
        fml.LogisticRegressionModel().get_param_map_json(),
        {"coefficient": coef},
    )
    rows = criteo_rows(indices, values, n, nnz, dim)
    idx2 = indices.reshape(n, nnz)
    val2 = values.reshape(n, nnz)
    table = fml.Table({"features": rows})
    ref = (val2.astype(np.float64)
           * coef.astype(np.float32).astype(np.float64)[idx2]).sum(axis=1)

    def run():
        (out,) = model.transform(table)
        return out.column("rawPrediction"), out.column("prediction")

    fml.reset_launch_counts()
    first_s, call_s, (raw, pred) = timed_calls(torch, run)
    launches = fml.launch_counts()["spmv"]
    if launches < 4:
        fail(f"sparse path: spmv launched {launches} times in 4 transforms")

    margins = sparse_margins(rows, coef)
    if not np.allclose(margins, ref, rtol=1e-5, atol=1e-5):
        fail("sparse path: margins differ from float64 numpy by "
             f"{np.abs(margins - ref).max()}")
    p_ref = 1.0 / (1.0 + np.exp(-ref))
    if raw.shape != (n, 2) or not np.isfinite(raw).all():
        fail(f"sparse path: rawPrediction shape {raw.shape} or non-finite")
    if not np.allclose(raw[:, 1], p_ref, rtol=1e-5, atol=1e-5):
        fail("sparse path: rawPrediction differs from float64 numpy")
    decisive = np.abs(ref) > 1e-4
    if not np.array_equal(pred[decisive], (ref[decisive] >= 0).astype(pred.dtype)):
        fail("sparse path: prediction differs from float64 numpy")
    rec = {"path": "sparse_lr_transform", "rows": n, "dim": dim,
           "transforms": 4, "first_call_s": first_s, "call_s": call_s,
           "rows_per_s": n / call_s, "spmv_launches": launches,
           "max_abs_margin_err": float(np.abs(margins - ref).max())}
    log("path " + json.dumps(rec))
    return launches


# -- phase 4: dense pipeline serving path ----------------------------------------

def numpy_chain(model, x):
    """Float64 numpy reference of the five-stage chain."""
    st, mm, ma, rb, lr = model.stages
    d = {k: np.asarray(v) for k, v in st._arrays().items()}
    s = (x - d["mean"]) / np.where(d["std"] > 0, d["std"], 1.0)
    d = mm._arrays()
    span = d["dataMax"] - d["dataMin"]
    s = np.where(span > 0, (s - d["dataMin"]) / np.where(span > 0, span, 1.0),
                 0.5)
    d = ma._arrays()
    s = s / np.where(d["maxAbs"] > 0, d["maxAbs"], 1.0)
    d = rb._arrays()
    s = s / np.where(d["range"] > 0, d["range"], 1.0)
    dot = s @ lr.coefficient
    p = 1.0 / (1.0 + np.exp(-dot))
    return s, dot, np.stack([1.0 - p, p], axis=-1)


def dense_path(torch):
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch import pipeline_fusion

    n, d = CHAIN_ROWS, CHAIN_D
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    train = fml.Table({"features": x, "label": y})
    stages, cur, prev = [], train, "features"
    for i, cls in enumerate((fml.StandardScaler, fml.MinMaxScaler,
                             fml.MaxAbsScaler, fml.RobustScaler), start=1):
        m = cls().set(cls.INPUT_COL, prev).set(cls.OUTPUT_COL, f"s{i}").fit(cur)
        (cur,) = m.transform(cur)
        prev = f"s{i}"
        stages.append(m)
    xs = x.astype(np.float32)
    mean_ref = xs.astype(np.float64).mean(0)
    if not np.allclose(stages[0]._arrays()["mean"], mean_ref, rtol=1e-5,
                       atol=1e-6):
        fail("dense path: StandardScaler mean differs from numpy")
    lr = fml.LogisticRegressionModel().set(
        fml.LogisticRegressionModel.FEATURES_COL, prev)
    lr.set_model_data(fml.Table({"coefficient": rng.normal(size=(1, d))}))
    model = fml.PipelineModel(stages + [lr])
    table = fml.Table({"features": x})

    def run():
        (out,) = model.transform(table)
        return {c: out.column(c) for c in ("s4", "prediction", "rawPrediction")}

    pipeline_fusion.set_enabled(True)
    fml.reset_launch_counts()
    first_s, call_s, fused = timed_calls(torch, run)
    launches = fml.launch_counts()["fused_chain"]
    if launches < 4:
        fail(f"dense path: fused_chain launched {launches} times in 4 "
             "transforms")

    pipeline_fusion.set_enabled(False)
    try:
        _, per_stage_s, per_stage = timed_calls(torch, run)
    finally:
        pipeline_fusion.set_enabled(True)
    for c, rtol in (("s4", 1e-12), ("rawPrediction", 1e-10)):
        if not np.allclose(fused[c], per_stage[c], rtol=rtol, atol=rtol):
            fail(f"dense path: fused {c} differs from per-stage by "
                 f"{np.abs(fused[c] - per_stage[c]).max()}")
    s_ref, dot_ref, raw_ref = numpy_chain(model, x)
    if not (np.allclose(fused["s4"], s_ref, rtol=1e-12, atol=1e-12)
            and np.allclose(fused["rawPrediction"], raw_ref, rtol=1e-10,
                            atol=1e-10)):
        fail("dense path: fused output differs from the float64 numpy chain")
    decisive = np.abs(dot_ref) > 1e-9
    if not np.array_equal(fused["prediction"][decisive],
                          (dot_ref[decisive] >= 0).astype(np.float64)):
        fail("dense path: prediction differs from the float64 numpy chain")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model")
        model.save(path)
        loaded = fml.PipelineModel.load(path)
        (out,) = loaded.transform(table)
        for c in ("s4", "prediction", "rawPrediction"):
            if not np.array_equal(out.column(c), fused[c]):
                fail(f"dense path: {c} changed across save -> load")
    rec = {"path": "dense_pipeline_transform", "rows": n, "d": d,
           "dtype": "float64", "transforms": 4, "first_call_s": first_s,
           "fused_call_s": call_s, "fused_rows_per_s": n / call_s,
           "per_stage_call_s": per_stage_s,
           "per_stage_rows_per_s": n / per_stage_s,
           "fused_chain_launches": launches}
    log("path " + json.dumps(rec))
    return launches


# -- phase 2b: segment_sum against its plain version -----------------------------

def segsum_case(torch, timer, ids_host, values_host, num_segments, dtype,
                sorted_ids, rtol, atol):
    """One ``segment_sum`` case: kernel vs plain version on the card, the
    sorted path also bit for bit vs the in-order sum (``np.add.at``), and
    the times."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum

    tdt = getattr(torch, dtype)
    ids = torch.from_numpy(ids_host).cuda()
    ids_long = ids.long()
    vals = torch.from_numpy(values_host).to("cuda", tdt)
    got = ksegsum.segment_sum(vals, ids, num_segments,
                              indices_are_sorted=sorted_ids)
    torch.cuda.synchronize()
    want = ksegsum.segment_sum_plain(vals, ids, num_segments)
    label = (f"segment_sum[{'sorted' if sorted_ids else 'unsorted'}, {dtype}, "
             f"k={1 if vals.dim() == 1 else vals.shape[1]}]")
    check_close(f"{label} vs plain", got, want, rtol, atol)
    bitwise = None
    if sorted_ids:
        in_order = np.zeros(tuple(got.shape), dtype=vals.cpu().numpy().dtype)
        np.add.at(in_order, ids_host, vals.cpu().numpy())
        bitwise = bool(np.array_equal(got.cpu().numpy(), in_order))
        if not bitwise:
            fail(f"{label}: the run-flush differs from the in-order sum")

    def library():
        return torch.zeros(tuple(got.shape), dtype=tdt,
                           device="cuda").index_add_(0, ids_long, vals)

    ms = timer(lambda: ksegsum.segment_sum(vals, ids, num_segments,
                                           indices_are_sorted=sorted_ids))
    plain_ms = timer(lambda: ksegsum.segment_sum_plain(vals, ids,
                                                       num_segments))
    library_ms = timer(library)
    item = vals.element_size()
    n_bytes = ids.numel() * 4 + vals.numel() * item + got.numel() * item
    b_ms, b_by = bound_ms(n_bytes, vals.numel(), dtype)
    rec = {
        "name": "segment_sum", "route": "cuda",
        "source": "flinkml_tpu_torch/kernels/csrc/segsum.cu",
        "replaces": "flinkml_tpu/kernels/segsum.py:222",
        "shape": [int(vals.shape[0]), int(got.numel() // num_segments),
                  num_segments],
        "dtype": dtype, "sorted": sorted_ids,
        "max_abs_err": max_err(got, want), "bitwise_in_order": bitwise,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms,
        "library_call": "torch.zeros(...).index_add_(0, ids_int64, values)",
    }
    log("kernel " + json.dumps(rec))
    return rec


def segsum_phase(torch, timer):
    """The sparse-fit step's scatter (Criteo cells into 1e6 segments) in
    float32 and float64, unsorted and sorted, and the row payload.
    Tolerances vs the plain version (``index_add_``, whose atomics also
    reorder the adds): float32 rtol/atol 1e-5, float64 1e-12."""
    _, indices, values, _, _ = make_criteo_csr(SPARSE_FIT_ROWS, SPMV_DIM,
                                               SPMV_NNZ, seed=5)
    sorted_order = np.argsort(indices, kind="stable")
    main = None
    for dtype, tol in (("float32", 1e-5), ("float64", 1e-12)):
        for sorted_ids in (False, True):
            ids = indices[sorted_order] if sorted_ids else indices
            vals = values[sorted_order] if sorted_ids else values
            rec = segsum_case(torch, timer, ids, vals.astype(dtype), SPMV_DIM,
                              dtype, sorted_ids, tol, tol)
            if dtype == "float32" and not sorted_ids:
                main = rec   # the fit's default layout
    rng = np.random.default_rng(6)
    ids = rng.integers(0, PAYLOAD_SEGMENTS, size=PAYLOAD_CELLS).astype(np.int32)
    vals = rng.normal(size=(PAYLOAD_CELLS, PAYLOAD_K)).astype(np.float32)
    for sorted_ids in (False, True):
        order = np.argsort(ids, kind="stable") if sorted_ids else slice(None)
        segsum_case(torch, timer, ids[order], vals[order], PAYLOAD_SEGMENTS,
                    "float32", sorted_ids, 1e-5, 1e-5)
    return main


# -- phase 5: dense fit path --------------------------------------------------------

def numpy_dense_fit(x, y, w, seed, batch, epochs, lr):
    """Float64 numpy run of the dense trainer's steps (reg 0): the same
    seeded shuffle, the same rotating windows."""
    n = x.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    x64 = x[perm].astype(np.float64)
    y64, w64 = y[perm].astype(np.float64), w[perm].astype(np.float64)
    n_windows = max(-(-n // batch), 1)
    coef = np.zeros(x.shape[1])
    for ep in range(epochs):
        start = min((ep % n_windows) * batch, n - batch)
        xb, yb, wb = (a[start:start + batch] for a in (x64, y64, w64))
        ys = 2.0 * yb - 1.0
        mult = wb * (-ys / (1.0 + np.exp(xb @ coef * ys)))
        coef = coef - lr / wb.sum() * (xb.T @ mult)
    return coef


class _Epochs:
    """Listener: the last epoch a fit ran."""

    epoch = None

    def on_epoch_watermark_incremented(self, epoch, state):
        self.epoch = epoch

    def on_iteration_terminated(self, state):
        pass


def dense_fit_path(torch):
    """Tolerance vs the float64 reference: 1e-4 of the largest
    coefficient (float32 products over 262,144 rows, 20 steps)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import _linear_sgd as sgd

    x, y, w = make_data(DENSE_FIT_ROWS, DENSE_FIT_D)
    table = fml.Table({"features": x, "label": y})
    est = (fml.LogisticRegression().set_seed(0).set_tol(0.0)
           .set_global_batch_size(FIT_BATCH).set_max_iter(FIT_EPOCHS)
           .set_learning_rate(FIT_LR))
    fml.reset_launch_counts()
    first_s, fit_s, model = timed_calls(torch, lambda: est.fit(table), calls=2)
    counts = fml.launch_counts()
    coef = model.coefficient
    ref = numpy_dense_fit(x, y, w, 0, FIT_BATCH, FIT_EPOCHS, FIT_LR)
    err = float(np.abs(coef - ref).max())
    if (coef.shape != ref.shape or not np.isfinite(coef).all()
            or not err <= 1e-4 * np.abs(ref).max()):
        fail(f"dense fit: coefficient differs from float64 numpy by {err}")

    # The device loop alone, on data already on the card.
    xd, yd, wd = (torch.from_numpy(a).cuda() for a in (x, y, w))
    trainer = sgd._dense_trainer("logistic", FIT_BATCH)
    listener = _Epochs()
    _, loop_s, _ = timed_calls(torch, lambda: sgd._run_chunked(
        trainer, (xd, yd, wd), DENSE_FIT_D, torch.float32, FIT_LR, 0.0, 0.0,
        0.0, FIT_EPOCHS, listeners=[listener]))
    if listener.epoch != FIT_EPOCHS - 1:
        fail(f"dense fit: the device loop ran {listener.epoch} + 1 epochs")
    samples = FIT_BATCH * FIT_EPOCHS
    rec = {"path": "dense_lr_fit", "rows": DENSE_FIT_ROWS, "d": DENSE_FIT_D,
           "dtype": "float32", "batch": FIT_BATCH, "epochs": FIT_EPOCHS,
           "first_fit_s": first_s, "fit_s": fit_s,
           "samples_per_s": samples / fit_s, "device_loop_s": loop_s,
           "device_loop_samples_per_s": samples / loop_s,
           "host_s": fit_s - loop_s, "max_abs_coef_err": err,
           "max_abs_coef": float(np.abs(ref).max()), "launches": counts}
    log("path " + json.dumps(rec))


# -- phase 6: sparse fit path -----------------------------------------------------

def numpy_sparse_fit(indptr, indices, values, dim, y, w, epochs, lr):
    """Float64 numpy full-batch run of the sparse trainer's steps (reg 0;
    batch >= rows, so every bucket's window is the whole bucket)."""
    n = indptr.size - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    v = values.astype(np.float64)
    y64, w64 = y.astype(np.float64), w.astype(np.float64)
    coef = np.zeros(dim)
    for _ in range(epochs):
        dot = np.bincount(rows, weights=v * coef[indices], minlength=n)
        ys = 2.0 * y64 - 1.0
        mult = w64 * (-ys / (1.0 + np.exp(dot * ys)))
        grad = np.bincount(indices, weights=v * mult[rows], minlength=dim)
        coef = coef - lr / w64.sum() * grad
    return coef


def sparse_fit_path(torch):
    """Tolerance vs the float64 reference: 1e-4 of the largest
    coefficient (float32 sums of ~10 cells per column and 39 per row,
    added by atomics in a run-dependent order on the unsorted path)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.models._data import labeled_sparse_data

    n, dim, nnz = SPARSE_FIT_ROWS, SPMV_DIM, SPMV_NNZ
    if FIT_BATCH < n:
        fail("sparse fit: the full-batch numpy reference needs batch >= rows")
    _, indices, values, y, _ = make_criteo_csr(n, dim, nnz, seed=0)
    table = fml.Table({"features": criteo_rows(indices, values, n, nnz, dim),
                       "label": y})
    est = (fml.LogisticRegression().set_seed(0).set_tol(0.0)
           .set_global_batch_size(FIT_BATCH).set_max_iter(FIT_EPOCHS)
           .set_learning_rate(FIT_LR))
    est.fit(table)   # first fit: kernel libraries load, allocator warms
    torch.cuda.synchronize()
    fml.reset_launch_counts()
    t0 = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = fml.launch_counts()
    if counts["segment_sum"] < FIT_EPOCHS or counts["spmv"] < FIT_EPOCHS:
        fail(f"sparse fit: kernel launches {counts} in one {FIT_EPOCHS}-epoch "
             "fit")

    _, csr_s, csr = timed_calls(
        torch, lambda: labeled_sparse_data(table, "features", "label"))
    indptr, cidx, cval, _, cy, cw = csr
    ref = numpy_sparse_fit(indptr, cidx, cval, dim, cy, cw, FIT_EPOCHS,
                           FIT_LR)
    errs = {"unsorted": float(np.abs(model.coefficient - ref).max())}

    fml.reset_launch_counts()
    t0 = time.perf_counter()
    coef_sorted = sgd.train_linear_model_sparse_csr(
        *csr[:4], cy, cw, "logistic", FIT_EPOCHS, FIT_LR, FIT_BATCH, 0.0, 0.0,
        0.0, 0, layout="sorted")
    torch.cuda.synchronize()
    sorted_fit_s = time.perf_counter() - t0
    sorted_counts = fml.launch_counts()
    errs["sorted"] = float(np.abs(coef_sorted - ref).max())
    for layout, err in errs.items():
        if not err <= 1e-4 * np.abs(ref).max():
            fail(f"sparse fit ({layout}): coefficient differs from float64 "
                 f"numpy by {err}")
    if sorted_counts["segment_sum"] < FIT_EPOCHS:
        fail(f"sparse fit (sorted): kernel launches {sorted_counts}")

    # Host packing apart from the device loop, for both layouts.
    split = {}
    for layout in ("unsorted", "sorted"):
        _, pack_s, (data_args, local_bss) = timed_calls(
            torch, lambda: sgd.prepare_sparse_buckets(
                *csr[:4], cy, cw, FIT_BATCH, seed=0, layout=layout))
        trainer = sgd._sparse_trainer_bucketed("logistic", local_bss, dim,
                                               layout)

        def loop():
            return sgd._run_chunked(trainer, data_args, dim, torch.float32,
                                    FIT_LR, 0.0, 0.0, 0.0, FIT_EPOCHS)

        _, loop_s, _ = timed_calls(torch, loop)
        split[layout] = {"pack_upload_s": pack_s, "device_loop_s": loop_s,
                         "buckets": len(local_bss),
                         "device_share": device_share(torch, loop)}
    samples = FIT_BATCH * FIT_EPOCHS
    rec = {"path": "sparse_lr_fit", "rows": n, "dim": dim, "nnz": nnz,
           "batch": FIT_BATCH, "epochs": FIT_EPOCHS, "fit_s": fit_s,
           "samples_per_s": samples / fit_s,
           "sorted_fit_s": sorted_fit_s,
           "sorted_samples_per_s": samples / sorted_fit_s,
           "csr_from_rows_s": csr_s, "split": split,
           "max_abs_coef_err": errs,
           "max_abs_coef": float(np.abs(ref).max()), "launches": counts,
           "sorted_launches": sorted_counts}
    log("path " + json.dumps(rec))
    return counts


def device_share(torch, fn):
    """Share of ``fn``'s wall time during which the card ran kernels, from
    ``torch.profiler`` (None when the profiler reports no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    except RuntimeError as e:   # the profiler, not the path, failed
        log(f"device share not measured: {e}")
        return None
    busy_us = 0.0
    for e in prof.key_averages():
        busy_us += getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
    return busy_us / wall_us if busy_us > 0 else None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import flinkml_tpu_torch  # noqa: F401  (fails outside a checkout)
    from flinkml_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    times = _build.build_all()
    log(f"build: {json.dumps(times)} total {time.perf_counter() - t0:.2f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{name}]: {line.strip()}")

    timer = Timer(torch)
    spmv_rec = spmv_phase(torch, timer)
    spmv_phase(torch, timer, rows=SPARSE_FIT_ROWS)
    chain_rec = chain_phase(torch, timer, "float64", 1e-12, 1e-12)
    chain_phase(torch, timer, "float32", 1e-5, 1e-6)
    segsum_rec = segsum_phase(torch, timer)
    del timer

    serve_spmv = sparse_path(torch)
    chain_rec["launches"] = dense_path(torch)
    dense_fit_path(torch)
    fit_counts = sparse_fit_path(torch)
    spmv_rec["launches"] = serve_spmv + fit_counts["spmv"]
    segsum_rec["launches"] = fit_counts["segment_sum"]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (spmv_rec, chain_rec,
                                            segsum_rec)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
