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
   path's shapes — ``spmv`` at 65,536 rows x 39 slots, dim 1e6, float32;
   ``fused_chain`` at 100,000 x 32 in float64 and float32 — with CUDA-event
   times (L2 flushed before each launch), the plain version's and the
   library call's time, and the bound from bytes and operations;
3. sparse path: LogisticRegressionModel (dim 1e6, seeded coefficient, built
   with ``stage_from_arrays``) transforms 65,536 Criteo-profile SparseVector
   rows 4 times (a first call, then 3 timed); margins are checked against
   float64 numpy;
4. dense path: the four scalers are fitted on seeded data (100,000 x 32),
   an LR head with a seeded coefficient closes the chain, and
   ``PipelineModel.transform`` runs 4 times fused (a first call, then 3
   timed), then per-stage, then
   after a save -> load round trip; outputs are checked against each other
   and against a float64 numpy reference.

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

def spmv_phase(torch, timer):
    from flinkml_tpu_torch.kernels import spmv as kspmv

    indptr, indices, values, _, _ = make_criteo_csr(SPMV_ROWS, SPMV_DIM,
                                                    SPMV_NNZ, seed=1)
    w_host = np.random.default_rng(2).normal(size=SPMV_DIM).astype(np.float32)
    idx = torch.from_numpy(indices.reshape(SPMV_ROWS, SPMV_NNZ)).cuda()
    val = torch.from_numpy(values.reshape(SPMV_ROWS, SPMV_NNZ)).cuda()
    w = torch.from_numpy(w_host).cuda()
    got = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    want = kspmv.spmv_plain(idx, val, w)
    check_close("spmv vs plain", got, want, 1e-5, 1e-5)
    ref = (values.astype(np.float64).reshape(SPMV_ROWS, SPMV_NNZ)
           * w_host.astype(np.float64)[indices.reshape(SPMV_ROWS, SPMV_NNZ)]
           ).sum(axis=1)
    check_close("spmv vs float64 numpy", got, torch.from_numpy(ref).cuda(),
                1e-5, 1e-5)

    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr).cuda(), idx.reshape(-1).long(),
        val.reshape(-1), size=(SPMV_ROWS, SPMV_DIM),
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
    n_bytes = idx.numel() * 4 + val.numel() * 4 + touched * 4 + SPMV_ROWS * 4
    b_ms, b_by = bound_ms(n_bytes, 2.0 * val.numel(), "float32")
    rec = {
        "name": "spmv", "route": "cuda",
        "source": "flinkml_tpu_torch/kernels/csrc/spmv.cu",
        "replaces": "flinkml_tpu/kernels/spmv.py:74",
        "shape": [SPMV_ROWS, SPMV_NNZ, SPMV_DIM], "dtype": "float32",
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
    from flinkml_tpu_torch.linalg import SparseVector
    from flinkml_tpu_torch.ops.sparse import sparse_margins

    n, dim, nnz = SPMV_ROWS, SPMV_DIM, SPMV_NNZ
    indptr, indices, values, _, _ = make_criteo_csr(n, dim, nnz, seed=0)
    coef = np.random.default_rng(4).normal(size=dim)
    model = fml.stage_from_arrays(
        "flinkml_tpu.models.logistic_regression.LogisticRegressionModel",
        fml.LogisticRegressionModel().get_param_map_json(),
        {"coefficient": coef},
    )
    rows = np.empty(n, dtype=object)
    idx2 = indices.reshape(n, nnz)
    val2 = values.reshape(n, nnz)
    for r in range(n):
        # Duplicate draws within a row merge by sum (CSR semantics).
        ui, inv = np.unique(idx2[r], return_inverse=True)
        uv = np.zeros(ui.size, dtype=np.float64)
        np.add.at(uv, inv, val2[r].astype(np.float64))
        rows[r] = SparseVector._from_sorted(dim, ui.astype(np.int64), uv)
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
    chain_rec = chain_phase(torch, timer, "float64", 1e-12, 1e-12)
    chain_phase(torch, timer, "float32", 1e-5, 1e-6)
    del timer

    spmv_rec["launches"] = sparse_path(torch)
    chain_rec["launches"] = dense_path(torch)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (spmv_rec, chain_rec)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
