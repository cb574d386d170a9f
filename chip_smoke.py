#!/usr/bin/env python3
"""Smoke test of flinkml_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It drives the PyTorch port only (nothing of JAX, nothing of ``flinkml_tpu``)
and fails with a non-zero exit if any phase fails:

1. prints the card's name and power limit; builds every CUDA kernel from
   ``flinkml_tpu_torch/kernels/csrc`` and the measurement probes of
   ``kernels/probes`` (one ``nvcc`` per source, in parallel);
2. kernel phase: each kernel against its plain PyTorch version at the main
   paths' shapes — ``spmv`` at 65,536 and 262,144 rows x 39 slots, dim
   1e6, float32 (and at widths 1, 7, 39, 40, 1,000 and 3,000 on bucket
   views off the 16-byte phase, float32 and float64; the same bits on two
   launches);
   ``fused_chain`` at 100,000 x 32 in float64 and float32, on both of its
   routes; ``segment_sum`` at the sparse-fit step (262,144 x 39 cells into
   1e6 segments, float32 and float64, unsorted beside the random-reduction
   floor, and sorted) and with a row payload (2^20 cells x 16 into 65,536
   segments), the sorted path's output block poisoned with NaN first; ``topk`` bit for bit against ``top_k_plain``
   (values and indices) at [4096, 60000] k=5, [1024, 8192] k=16 and
   k=1,024, [256, 2048] k=128 (float32), 1-D n=1e6 k=100 and k=20,000
   (float64, two bands) and on adversarial rows (duplicates, +0/-0,
   -inf-only rows, NaN of both signs; k up to the whole row), short and
   split into segments — with CUDA-event times (L2 flushed before each
   launch), the plain version's and the library call's time, and the bound
   from bytes and operations; then the route probe (the same inputs
   through each of the kernel's routes, timed in turns);
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
   the host's CSR conversion and packing timed apart from the device loop;
7. KNN path: ``Knn().fit`` on 60,000 x 784 float32 rows (integers 0-15),
   ``KnnModel.transform`` of 10,000 queries (k=5, 10 classes: three query
   chunks, three ``topk`` launches), the first 512 predictions equal to a
   float64 numpy brute force, and again with k=200; one chunk's product,
   distances and ``topk`` timed apart;
8. LSH path: ``MinHashLSH(numHashTables=5)`` on 65,536 Criteo-profile
   SparseVector rows (39 draws per row over 4,096 columns, so that rows
   overlap), transform, ``approx_nearest_neighbors(k=100)`` (one ``topk``
   launch) and ``approx_similarity_join`` at 2,000 x 2,000 rows, each equal
   to a numpy brute force;
9. KMeans paths: ``KMeans(maxIter=100)`` at 65,536 x 784, k=10 and
   262,144 x 128, k=64 on standard normal float32 points (twice, and the
   device loop alone), the objective below the init's; the same fits in
   float64 against a float64 numpy Lloyd run from the same init (rtol
   1e-4); ``BisectingKMeans(k=8)`` on 65,536 x 784 blobs against the CPU
   port.

Each path runs with the launch counters set to 0 just before it and read
just after; a path whose kernel never launched fails. The last lines are
the kernels' JSON summary, the card's name and power limit, and
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --ab OTHER`` runs none of that: it times ``spmv``,
``topk``, ``segment_sum`` and ``fused_chain`` through the wrappers of the
checkout at OTHER (an unpacked ``git archive`` of another commit) and of
this one, each in its own process, in the order OTHER, this, this, OTHER,
and prints one JSON line per process after the card's line.

``python3 chip_smoke.py --variants`` runs none of that either: it builds
edited copies of ``chain.cu`` and ``segsum.cu`` (:data:`VARIANTS`: a step
removed or a constant changed, to measure what each costs) and times each
through the port's wrappers; one JSON line per measurement.
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
    again = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"spmv {rows} x {SPMV_NNZ}: two launches differ")
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
    # Beside it: the same cells with gathers confined to 2,048 entries of w
    # (L1-resident: the cell stream's share), and the same number of random
    # gathers over the same dim with no cell stream (the gathers' floor).
    local = idx.remainder(2048)
    local_gather_ms = timer(lambda: kspmv.spmv(local, val, w))
    del local
    floor_out = torch.empty(val.numel() // 8 + 1, device="cuda")
    floor = probe_function("fml_gather_floor")
    stream = torch.cuda.current_stream().cuda_stream
    gather_floor_ms = timer(lambda: _build_check(floor(
        w.data_ptr(), SPMV_DIM, floor_out.data_ptr(), val.numel(), stream)))
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
        "library_call": library_call, "repeatable": True,
        # Beside the HBM bound: each gather moves one 32-byte L2 sector.
        "gather_l2_bytes": val.numel() * 32,
        "local_gather_ms": local_gather_ms, "gather_floor_ms": gather_floor_ms,
    }
    log("kernel " + json.dumps(rec))
    return rec


def probe_function(symbol: str):
    """``symbol`` of a measurement probe in ``flinkml_tpu_torch/kernels/
    probes`` (built by ``_build.build_all`` with the kernels' ``nvcc``
    flags; not a kernel of the port): ``(out-or-input pointers..., n,
    stream)`` as its source says."""
    import ctypes

    from flinkml_tpu_torch.kernels import _build

    if symbol == "fml_gather_floor":
        args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p]
        return _build.function("gather_floor", symbol, args)
    return _build.function("red_floor", symbol, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])


def _build_check(code):
    if code != 0:
        fail(f"floor probe: CUDA error {code}")


# Bucket widths the packer's DP picks (ops/sparse.py), and one wider than
# the kernel's 2,048-cell tile.
SPMV_WIDTHS = (1, 7, 39, 40, 1000, 3000)
SPMV_WIDTH_CELLS = 4 << 20


def spmv_widths_phase(torch):
    """``spmv`` at every width on a bucket view that starts one row in (off
    the 16-byte phase whenever the width is not a multiple of 4), float32
    and float64, the same bits on two launches. Widths up to 1,000: within
    rtol/atol 1e-5 of the plain version and of float64 numpy. The width
    past a tile (3,000 float32 terms a row, whose sums in two orders
    differ by more than 1e-5): within the summation error bound."""
    from flinkml_tpu_torch.kernels import spmv as kspmv

    for dtype in ("float32", "float64"):
        tdt = getattr(torch, dtype)
        for width in SPMV_WIDTHS:
            rows = SPMV_WIDTH_CELLS // width + 1
            rng = np.random.default_rng(width)
            idx_h = rng.integers(0, SPMV_DIM, size=(rows, width)).astype(np.int32)
            val_h = rng.normal(size=(rows, width)).astype(dtype)
            w_h = rng.normal(size=SPMV_DIM).astype(dtype)
            idx = torch.from_numpy(idx_h).cuda()[1:]
            val = torch.from_numpy(val_h).cuda()[1:]
            w = torch.from_numpy(w_h).cuda()
            got = kspmv.spmv(idx, val, w)
            again = kspmv.spmv(idx, val, w)
            torch.cuda.synchronize()
            label = f"spmv width {width} {dtype}"
            if not torch.equal(got, again):
                fail(f"{label}: two launches differ")
            terms = (val_h[1:].astype(np.float64)
                     * w_h.astype(np.float64)[idx_h[1:]])
            ref = torch.from_numpy(terms.sum(axis=1)).cuda()
            plain = kspmv.spmv_plain(idx, val, w)
            if width <= 1000:
                check_close(f"{label} vs plain", got, plain, 1e-5, 1e-5)
                check_close(f"{label} vs float64 numpy", got, ref, 1e-5, 1e-5)
                continue
            # Wider than a tile: a sum of `width` rounded terms, in any
            # order, is within gamma_width * sum|terms| of the exact sum
            # (recursive summation's error bound, unit roundoff u).
            u = float(np.finfo(dtype).eps) / 2
            gamma = width * u / (1 - width * u)
            bound = torch.from_numpy(gamma * np.abs(terms).sum(axis=1)).cuda()
            for name, other, scale in (("float64 numpy", ref, 1.0),
                                       ("plain", plain.double(), 2.0)):
                err = (got.double() - other).abs()
                if not bool(torch.all(err <= scale * bound)):
                    fail(f"{label} vs {name}: error beyond the summation "
                         f"bound (max err {float(err.max())})")
        log(f"spmv widths {list(SPMV_WIDTHS)} {dtype}: equal to plain and "
            "float64 numpy (1e-5; the summation bound past a tile), "
            "repeatable")


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


# Instructions of one IEEE division on the FMA pipes (a reciprocal
# estimate and its Newton steps, about 8 of them in float32 and float64):
# the estimate behind the chain's division floor.
DIV_INSTRUCTIONS = 8


def chain_phase(torch, timer, dtype, rtol, atol):
    """The five-stage chain at 100,000 x 32 on both routes, each against
    the plain chain: ``vector`` (the rule's pick for x as allocated) and
    ``scalar`` (the same rows one element into their buffer, off the
    16-byte alignment); the times of both routes, the plain chain's, the
    byte bound and the division floor."""
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
    want = kchain.chain_plain(kernels, ["features"], outs, [xp], dev_consts,
                              CHAIN_ROWS)
    dot = torch.matmul(want["s4"][:CHAIN_ROWS].double(),
                       torch.from_numpy(coef).cuda())
    decisive = dot.abs() > 1e-4
    shifted = torch.empty(xp.numel() + 1, dtype=tdt, device="cuda")
    views = {"vector": xp, "scalar": shifted[1:].view(xp.shape)}
    views["scalar"].copy_(xp)
    err, route_ms = 0.0, {}
    for name, xv in views.items():
        if kchain.route(CHAIN_D, xv.element_size(), xv.data_ptr()) != name:
            fail(f"fused_chain[{dtype}]: the {name} view takes another route")
        got = program([xv], host_consts, CHAIN_ROWS)
        torch.cuda.synchronize()
        for c in ("s4", "rawPrediction"):
            check_close(f"fused_chain[{dtype}, {name}] {c}",
                        got[c][:CHAIN_ROWS], want[c][:CHAIN_ROWS], rtol, atol)
            err = max(err, max_err(got[c][:CHAIN_ROWS], want[c][:CHAIN_ROWS]))
        if not torch.equal(got["prediction"][:CHAIN_ROWS][decisive],
                           want["prediction"][:CHAIN_ROWS][decisive]):
            fail(f"fused_chain[{dtype}, {name}] prediction differs from plain")
        route_ms[name] = timer(lambda: program([xv], host_consts, CHAIN_ROWS))
    del shifted, views

    ms = route_ms["vector"]
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
    # Four of those ops are IEEE divisions of DIV_INSTRUCTIONS each; one
    # FMA-pipe instruction a lane per cycle is half the peak FLOP rate.
    div_floor_ms = (n * d * 4 * DIV_INSTRUCTIONS
                    / (PEAK_OPS_PER_S[dtype] / 2)) * 1e3
    rec = {
        "name": "fused_chain", "route": "cuda",
        "source": "flinkml_tpu_torch/kernels/csrc/chain.cu",
        "replaces": "flinkml_tpu/kernels/chain.py:173",
        "shape": [n, d], "dtype": dtype, "kernel_route": "vector",
        "max_abs_err": err, "ms": ms, "route_ms": route_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "division_floor_ms": div_floor_ms, "library_ms": None,
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

def poison(torch, shape, tdt):
    """Leave a freed block of ``shape`` full of NaN in the caching
    allocator, so that an output the kernel fails to write shows as NaN."""
    torch.full(shape, float("nan"), dtype=tdt, device="cuda")
    torch.cuda.synchronize()


def segsum_case(torch, timer, ids_host, values_host, num_segments, dtype,
                sorted_ids, rtol, atol, red_floor=False):
    """One ``segment_sum`` case: kernel vs plain version on the card, the
    sorted path also bit for bit vs the in-order sum (``np.add.at``) on an
    output block poisoned with NaN, and the times; with ``red_floor``, the
    same number of random reductions into the same output size alone
    (``probes/red_floor.cu``)."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum

    tdt = getattr(torch, dtype)
    ids = torch.from_numpy(ids_host).cuda()
    ids_long = ids.long()
    vals = torch.from_numpy(values_host).to("cuda", tdt)
    out_shape = (num_segments,) + tuple(vals.shape[1:])
    poison(torch, out_shape, tdt)
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
    if red_floor:
        floor_out = torch.zeros(num_segments, dtype=tdt, device="cuda")
        floor = probe_function("fml_red_floor_f32" if dtype == "float32"
                               else "fml_red_floor_f64")
        stream = torch.cuda.current_stream().cuda_stream
        rec["red_floor_ms"] = timer(lambda: _build_check(floor(
            floor_out.data_ptr(), num_segments, vals.numel(), stream)))
        del floor_out
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
                              dtype, sorted_ids, tol, tol,
                              red_floor=not sorted_ids)
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


# -- phase 2c: topk against its plain version ----------------------------------------

# (rows, n, k, dtype, why): the main shapes of the topk phase.
TOPK_CASES = (
    (4096, 60_000, 5, "float32", "one KNN chunk at MNIST width"),
    (1024, 8192, 16, "float32", "autotune/search.py:668"),
    (256, 2048, 128, "float32", "the Pallas kernel's MAX_K"),
    (None, 1_000_000, 100, "float64", "LSH-shaped 1-D"),
    (1024, 8192, 1024, "float32", "k past 128, one sort per row"),
    (None, 1_000_000, 20_000, "float64", "k past one sort: two bands"),
)
# (rows, n, k, dtype, routes): the same inputs through each route that
# takes them, timed in turns, for the rule in kernels/topk.py::route.
TOPK_ROUTE_CASES = (
    (4096, 60_000, 5, "float32", ("scan", "radix")),
    (4096, 60_000, 12, "float32", ("scan", "radix")),
    (4096, 60_000, 16, "float32", ("scan", "radix")),
    (1024, 8192, 16, "float32", ("fused", "scan", "radix")),
    (256, 2048, 32, "float32", ("fused", "radix")),
)


def topk_adversarial(dtype):
    """Small rows that pin the order: duplicates, +0 and -0, -inf-only
    rows, NaN of both signs, ascending and descending rows."""
    rng = np.random.default_rng(8)
    x = rng.integers(-3, 4, size=(9, 67)).astype(dtype)
    x[1] = -np.inf
    x[2, ::2], x[2, 1::2] = 0.0, -0.0
    x[3, ::5] = np.nan
    neg_nan = np.frombuffer(
        np.array([0xFFF8000000000000], np.uint64).tobytes(), np.float64)[0]
    x[3, 1::7] = neg_nan
    x[4] = np.arange(67)
    x[5] = -np.arange(67)
    x[6, :60] = -np.inf
    x[7] = 1.0
    return x


def topk_check(torch, x, k, label):
    """Kernel vs plain, bitwise in values and indices; returns the kernel's
    result."""
    from flinkml_tpu_torch.kernels import topk as ktopk

    got_v, got_i = ktopk.top_k(x, k)
    torch.cuda.synchronize()
    want_v, want_i = ktopk.top_k_plain(x, k)
    if got_v.shape != want_v.shape or got_i.dtype != torch.int32:
        fail(f"topk {label}: shape {tuple(got_v.shape)} / dtype {got_i.dtype}")
    view = torch.int32 if x.element_size() == 4 else torch.int64
    if not (torch.equal(got_i, want_i)
            and torch.equal(got_v.view(view), want_v.view(view))):
        bad = (got_i != want_i).nonzero()[:5].tolist()
        fail(f"topk {label}: differs from the plain version (first index "
             f"mismatches at {bad})")
    return got_v, got_i


def topk_phase(torch, timer):
    """``topk`` bit for bit against ``top_k_plain`` at the main paths'
    shapes and on adversarial rows; times of the kernel, the plain version
    and ``torch.topk`` (timed only)."""
    from flinkml_tpu_torch.kernels import topk as ktopk

    for dtype in ("float32", "float64"):
        x = torch.from_numpy(topk_adversarial(dtype)).cuda()
        for k in (1, 10, 67):
            topk_check(torch, x, k, f"adversarial {dtype} k={k}")
        # One long row of the same values: split into segments.
        long = torch.from_numpy(topk_adversarial(dtype).reshape(-1)).cuda()
        topk_check(torch, x.reshape(-1), x.numel(),
                   f"adversarial whole {x.numel()}-element row {dtype}")
        long = long.repeat(500)
        for k in (1, 100, 128, 129, 20_000):
            topk_check(torch, long, k, f"adversarial 1-D {dtype} k={k} "
                       f"({ktopk.segments(1, long.numel())} segments)")
    rng = np.random.default_rng(9)
    recs = []
    for rows, n, k, dtype, why in TOPK_CASES:
        shape = (n,) if rows is None else (rows, n)
        if rows == 4096:
            # -d2 of integer features: integer values with many ties.
            host = -rng.integers(0, 176_401, size=shape).astype(dtype)
        elif rows is None:
            # -Jaccard distances: a few thousand distinct values.
            host = -np.round(rng.random(size=shape), 3).astype(dtype)
        else:
            host = rng.normal(size=shape).astype(dtype)
        x = torch.from_numpy(host).cuda()
        r = 1 if rows is None else rows
        route = ktopk.route(r, n, k, x.element_size())
        got_v, _ = topk_check(torch, x, k, f"{list(shape)} k={k} {dtype}")
        ms = timer(lambda: ktopk.top_k(x, k))
        plain_ms = timer(lambda: ktopk.top_k_plain(x, k))
        library_ms = timer(lambda: torch.topk(x, k, dim=-1))
        lib_v, _ = torch.topk(x, k, dim=-1)
        item = x.element_size()
        n_bytes = r * n * item + r * k * (item + 4)
        b_ms, b_by = bound_ms(n_bytes, r * n, dtype)
        rec = {
            "name": "topk", "route": "cuda",
            "source": "flinkml_tpu_torch/kernels/csrc/topk.cu",
            "replaces": "flinkml_tpu/kernels/topk.py:79",
            "shape": list(shape), "k": k, "dtype": dtype, "why": why,
            "kernel_route": route, "max_abs_err": 0.0,
            "library_values_equal": bool(torch.equal(lib_v, got_v)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            "library_call": "torch.topk(x, k, dim=-1)",
        }
        log("kernel " + json.dumps(rec))
        recs.append(rec)
        del x
    topk_route_probe(torch, timer)
    return recs[0]


def topk_route_probe(torch, timer):
    """Each of TOPK_ROUTE_CASES through every route that takes it, bit for
    bit against the plain version, timed in turns (forward, then back):
    the measurements behind the fixed rule in ``kernels/topk.py``."""
    from flinkml_tpu_torch.kernels import topk as ktopk

    rng = np.random.default_rng(12)
    view = {"float32": torch.int32, "float64": torch.int64}
    for rows, n, k, dtype, routes in TOPK_ROUTE_CASES:
        host = (-rng.integers(0, 176_401, size=(rows, n)).astype(dtype)
                if n == 60_000 else rng.normal(size=(rows, n)).astype(dtype))
        x = torch.from_numpy(host).cuda()
        want_v, want_i = ktopk.top_k_plain(x, k)
        times = {r: [] for r in routes}
        for order in (routes, routes[::-1]):
            for r in order:
                got_v, got_i = ktopk.launch(x, k, r)
                torch.cuda.synchronize()
                if not (torch.equal(got_i, want_i) and torch.equal(
                        got_v.view(view[dtype]), want_v.view(view[dtype]))):
                    fail(f"topk route {r} [{rows}, {n}] k={k}: differs "
                         "from the plain version")
                times[r].append(timer(lambda: ktopk.launch(x, k, r)))
        rec = {"shape": [rows, n], "k": k, "dtype": dtype,
               "rule": ktopk.route(rows, n, k, x.element_size()),
               "ms": times}
        log("topk_route " + json.dumps(rec))
        del x, want_v, want_i


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


# -- phase 7: KNN transform at MNIST width ----------------------------------------

KNN_TRAIN, KNN_QUERIES, KNN_D, KNN_CLASSES, KNN_K = 60_000, 10_000, 784, 10, 5
KNN_CHECK = 512
KNN_WIDE_K = 200


def numpy_knn(x, y, q, k):
    """Float64 numpy brute force: exact squared distances of integer
    features, a stable argsort (ties to the lower train index), a vote
    with ties to the smaller class."""
    classes, ids = np.unique(y, return_inverse=True)
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    d2 = ((q64 * q64).sum(1)[:, None] - 2.0 * (q64 @ x64.T)
          + (x64 * x64).sum(1)[None, :])
    nearest = np.argsort(d2, axis=1, kind="stable")[:, :k]
    votes = ids[nearest]
    counts = np.stack([np.bincount(v, minlength=len(classes)) for v in votes])
    return classes[np.argmax(counts, axis=1)]


def knn_path(torch, timer):
    """``Knn().fit`` on 60,000 x 784 rows and ``KnnModel.transform`` of
    10,000 queries, k=5, 10 classes, float32 features drawn as integers
    0-15 (distances exact in float32): three query chunks, the last
    partial. Predictions must equal the float64 numpy brute force on the
    first 512 queries exactly."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.kernels.topk import top_k
    from flinkml_tpu_torch.ops import blas

    rng = np.random.default_rng(10)
    x = rng.integers(0, 16, size=(KNN_TRAIN, KNN_D)).astype(np.float32)
    y = rng.integers(0, KNN_CLASSES, size=KNN_TRAIN).astype(np.float64)
    q = rng.integers(0, 16, size=(KNN_QUERIES, KNN_D)).astype(np.float32)
    t0 = time.perf_counter()
    model = fml.Knn().set_k(KNN_K).fit(fml.Table({"features": x, "label": y}))
    fit_s = time.perf_counter() - t0
    queries = fml.Table({"features": q})

    def run():
        (out,) = model.transform(queries)
        return out.column("prediction")

    first_s, call_s, pred = timed_calls(torch, run, calls=2)
    fml.reset_launch_counts()
    pred = run()
    launches = fml.launch_counts()["topk"]
    chunks = -(-KNN_QUERIES // model.CHUNK)
    if launches != chunks:
        fail(f"knn: topk launched {launches} times for {chunks} chunks")
    want = numpy_knn(x, y, q[:KNN_CHECK], KNN_K)
    if pred.shape != (KNN_QUERIES,) or not np.array_equal(pred[:KNN_CHECK],
                                                          want):
        fail(f"knn: {int((pred[:KNN_CHECK] != want).sum())} of {KNN_CHECK} "
             "predictions differ from the float64 numpy brute force")

    # k past the Pallas kernel's 128 (the radix route: a row of distances
    # does not fit shared memory and k > 12), on the checked queries.
    model_wide = fml.Knn().set_k(KNN_WIDE_K).fit(
        fml.Table({"features": x, "label": y}))
    (out_wide,) = model_wide.transform(fml.Table({"features": q[:KNN_CHECK]}))
    want_wide = numpy_knn(x, y, q[:KNN_CHECK], KNN_WIDE_K)
    wide_diff = int((out_wide.column("prediction") != want_wide).sum())
    if wide_diff:
        fail(f"knn k={KNN_WIDE_K}: {wide_diff} of {KNN_CHECK} predictions "
             "differ from the float64 numpy brute force")

    # One full chunk's parts, on the card (CUDA events, L2 flushed).
    qc = torch.from_numpy(q[:model.CHUNK]).cuda()
    xt = torch.from_numpy(x).cuda()
    matmul_ms = timer(lambda: torch.matmul(qc, xt.T))
    distance_ms = timer(lambda: blas.squared_distances(qc, xt))
    neg = blas.squared_distances(qc, xt).neg_()
    topk_ms = timer(lambda: top_k(neg, KNN_K))
    del neg
    rec = {"path": "knn_transform", "train": KNN_TRAIN, "queries": KNN_QUERIES,
           "d": KNN_D, "k": KNN_K, "classes": KNN_CLASSES, "dtype": "float32",
           "chunk": model.CHUNK, "fit_s": fit_s, "first_call_s": first_s,
           "call_s": call_s, "queries_per_s": KNN_QUERIES / call_s,
           "chunk_matmul_ms": matmul_ms, "chunk_distance_ms": distance_ms,
           "chunk_topk_ms": topk_ms,
           "chunk_matmul_tflops": 2.0 * model.CHUNK * KNN_TRAIN * KNN_D
           / matmul_ms / 1e9,
           "device_share": device_share(torch, run),
           "topk_launches": launches, "checked_queries": KNN_CHECK,
           "checked_k": [KNN_K, KNN_WIDE_K]}
    log("path " + json.dumps(rec))
    return launches


# -- phase 8: MinHashLSH ----------------------------------------------------------

LSH_ROWS, LSH_DIM, LSH_TABLES, LSH_K = 65_536, 4_096, 5, 100
LSH_JOIN_ROWS, LSH_THRESHOLD = 2_000, 0.97


def numpy_minhash(a, b, indptr, flat, prime):
    """[rows, tables] min-hashes of CSR index sets (empty rows: prime)."""
    out = np.full((indptr.size - 1, a.size), prime, dtype=np.int64)
    h = (a[None, :] * (flat[:, None].astype(np.int64) + 1) + b[None, :]) % prime
    for r in range(indptr.size - 1):
        if indptr[r + 1] > indptr[r]:
            out[r] = h[indptr[r]:indptr[r + 1]].min(axis=0)
    return out


def lsh_path(torch, timer):
    """``MinHashLSH(numHashTables=5)`` on 65,536 Criteo-profile rows (39
    draws per row over 4,096 columns, so that rows overlap), transform,
    ``approx_nearest_neighbors(k=100)`` and ``approx_similarity_join`` at
    2,000 x 2,000 rows, each held against a numpy brute force."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.kernels.topk import top_k
    from flinkml_tpu_torch.models.lsh import PRIME

    _, indices, values, _, _ = make_criteo_csr(LSH_ROWS, LSH_DIM, SPMV_NNZ,
                                               seed=11)
    rows = criteo_rows(indices, values, LSH_ROWS, SPMV_NNZ, LSH_DIM)
    sets = [v.indices[v.values != 0] for v in rows]
    lengths = np.array([len(r) for r in sets])
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    flat = np.concatenate(sets)
    table = fml.Table({"features": rows, "id": np.arange(LSH_ROWS)})
    est = (fml.MinHashLSH().set_input_col("features").set_output_col("hashes")
           .set_num_hash_tables(LSH_TABLES).set_seed(0))
    model = est.fit(table)
    t0 = time.perf_counter()
    (hashed,) = model.transform(table)
    transform_s = time.perf_counter() - t0
    want_h = numpy_minhash(model._a, model._b, indptr, flat, PRIME)
    if not np.array_equal(hashed.column("hashes"), want_h.astype(np.float64)):
        fail("lsh: transform hashes differ from numpy")

    key = rows[0]
    key_set = sets[0]
    fml.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nn = model.approx_nearest_neighbors(table, key, LSH_K)
    torch.cuda.synchronize()
    ann_s = time.perf_counter() - t0
    launches = fml.launch_counts()["topk"]
    cand = np.nonzero((want_h == want_h[0][None, :]).any(axis=1))[0]
    inter = np.bincount(np.repeat(np.arange(LSH_ROWS), lengths),
                        weights=np.isin(flat, key_set), minlength=LSH_ROWS)
    inter = inter.astype(np.int64)[cand]
    dists = 1.0 - inter / (lengths[cand] + key_set.size - inter)
    order = np.argsort(dists, kind="stable")[:LSH_K]
    if not (np.array_equal(nn.column("id"), cand[order])
            and np.array_equal(nn.column("distCol"), dists[order])):
        fail("lsh: approx_nearest_neighbors differs from the stable argsort")
    if launches != 1:
        fail(f"lsh: topk launched {launches} times in one query")
    neg = torch.from_numpy(-dists).cuda()
    topk_ms = timer(lambda: top_k(neg, min(LSH_K, dists.size)))

    n = LSH_JOIN_ROWS
    ta = fml.Table({"features": rows[:n]})
    tb = fml.Table({"features": rows[n:2 * n]})
    t0 = time.perf_counter()
    join = model.approx_similarity_join(ta, tb, LSH_THRESHOLD)
    join_s = time.perf_counter() - t0
    dense = np.zeros((2 * n, LSH_DIM), dtype=np.float32)   # exact counts
    dense[np.repeat(np.arange(2 * n), lengths[:2 * n]),
          flat[:indptr[2 * n]]] = 1.0
    inter2 = (dense[:n] @ dense[n:].T).astype(np.int64)
    union2 = lengths[:n, None] + lengths[None, n:2 * n] - inter2
    d2 = 1.0 - inter2 / union2
    shared = (want_h[:n, None, :] == want_h[None, n:2 * n, :]).any(axis=2)
    ia, ib = np.nonzero(shared & (d2 <= LSH_THRESHOLD))
    want_join = sorted(zip(ia.tolist(), ib.tolist(), d2[ia, ib].tolist()))
    got_join = sorted(zip(join.column("idA").tolist(),
                          join.column("idB").tolist(),
                          join.column("distCol").tolist()))
    if got_join != want_join or not got_join:
        fail(f"lsh: join has {len(got_join)} pairs, numpy {len(want_join)}")
    rec = {"path": "minhash_lsh", "rows": LSH_ROWS, "dim": LSH_DIM,
           "nnz": SPMV_NNZ, "tables": LSH_TABLES, "transform_s": transform_s,
           "transform_rows_per_s": LSH_ROWS / transform_s,
           "ann_k": LSH_K, "ann_candidates": int(cand.size), "ann_s": ann_s,
           "ann_topk_ms": topk_ms,
           "ann_host_s": ann_s - topk_ms / 1e3, "topk_launches": launches,
           "join_rows": [n, n], "join_threshold": LSH_THRESHOLD,
           "join_pairs": len(got_join), "join_s": join_s}
    log("path " + json.dumps(rec))
    return launches


# -- phase 9: KMeans fits -----------------------------------------------------------

# (rows, d, k, iterations): bench.py's kmeans_mnist and kmeans cells.
KMEANS_CELLS = ((65_536, 784, 10, 100), (262_144, 128, 64, 100))
BISECT_K = 8


def numpy_lloyd(x, centroids, max_iter):
    """Float64 numpy Lloyd steps (empty clusters keep their centroid).
    Once an assignment repeats, every later step reproduces the same
    centroids, so the loop stops there."""
    x = x.astype(np.float64)
    c = centroids.astype(np.float64)
    x2 = (x * x).sum(1)[:, None]
    prev = None
    for _ in range(max_iter):
        assign = np.argmin(x2 - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :],
                           axis=1)
        if prev is not None and np.array_equal(assign, prev):
            break
        prev = assign
        onehot = np.zeros((x.shape[0], c.shape[0]))
        onehot[np.arange(x.shape[0]), assign] = 1.0
        counts = onehot.sum(0)
        sums = onehot.T @ x
        c = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1.0)[:, None],
                     c)
    return c


def inertia(x, c):
    """Sum of squared distances to the nearest centroid, in float64."""
    x = x.astype(np.float64)
    d2 = (x * x).sum(1)[:, None] - 2.0 * (x @ c.T) + (c * c).sum(1)[None, :]
    return float(np.maximum(d2.min(axis=1), 0.0).sum())


def kmeans_blobs(n, d, k, seed):
    """Float32 points (unit noise) around k centres 1,000 apart on each
    axis's scale: no point lies near a boundary between blobs, so two
    float32 runs that sum in different orders split the blobs alike."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 1000.0
    labels = rng.integers(0, k, size=n)
    return (centres[labels] + rng.normal(size=(n, d))).astype(np.float32)


def kmeans_path(torch):
    """``KMeans(k, maxIter=100).fit`` (random init, seed 0) at the bench's
    two shapes and on its data (standard normal float32): timed in float32,
    with the device loop timed alone; Lloyd's objective must fall from the
    init. The same fit on the same points in float64 is held against a
    float64 numpy Lloyd run from the same init (rtol 1e-4): a float32 run
    on points without cluster structure has points within rounding of a
    boundary, and one flip sends it down another path, so float32 is not
    compared with float64 step for step. Then ``BisectingKMeans(k=8)`` on
    MNIST-width blobs against the CPU port on the same data (equal
    predictions, centroids within 1e-10)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import kmeans as km

    recs = []
    for n, d, k, iters in KMEANS_CELLS:
        x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
        est = fml.KMeans().set_k(k).set_max_iter(iters).set_seed(0)
        table = fml.Table({"features": x})
        first_s, fit_s, model = timed_calls(torch, lambda: est.fit(table),
                                            calls=2)
        start = km.init_centroids(x, k, 0)
        got = model.centroids
        if got.shape != (k, d) or not np.isfinite(got).all():
            fail(f"kmeans {n}x{d} k={k}: centroids shape {got.shape} or "
                 "non-finite")
        before, after = inertia(x, start), inertia(x, got)
        if not after < before:
            fail(f"kmeans {n}x{d} k={k}: inertia {after} not below the "
                 f"init's {before}")
        xd, wd, _ = km.prepare_kmeans_data(x)
        c0 = torch.from_numpy(start).cuda()
        _, loop_s, _ = timed_calls(torch, lambda: km.lloyd(xd, wd, c0, iters),
                                   calls=2)
        share = device_share(torch, lambda: km.lloyd(xd, wd, c0, iters))
        del xd, wd

        x64 = x.astype(np.float64)
        t0 = time.perf_counter()
        got64 = est.fit(fml.Table({"features": x64})).centroids
        fit64_s = time.perf_counter() - t0
        want = numpy_lloyd(x64, km.init_centroids(x64, k, 0), iters)
        err = float(np.abs(got64 - want).max())
        if not np.allclose(got64, want, rtol=1e-4, atol=1e-4):
            fail(f"kmeans {n}x{d} k={k} float64: centroids differ from "
                 f"numpy by {err}")
        rec = {"path": "kmeans_fit", "rows": n, "d": d, "k": k,
               "iterations": iters, "dtype": "float32", "init_mode": "random",
               "first_fit_s": first_s, "fit_s": fit_s,
               "points_per_s": n * iters / fit_s, "device_loop_s": loop_s,
               "device_loop_points_per_s": n * iters / loop_s,
               "host_s": fit_s - loop_s, "device_share": share,
               "inertia_init": before, "inertia_fit": after,
               "float64_fit_s": fit64_s,
               "float64_max_abs_centroid_err": err}
        log("path " + json.dumps(rec))
        recs.append(rec)

    n, d, _, _ = KMEANS_CELLS[0]
    x = kmeans_blobs(n, d, 10, seed=13)
    table = fml.Table({"features": x})
    est = fml.BisectingKMeans().set_k(BISECT_K).set_seed(0)
    t0 = time.perf_counter()
    gpu = est.fit(table)
    (pg,) = gpu.transform(table)
    gpu_s = time.perf_counter() - t0
    with fml.use_device("cpu"):
        cpu = est.fit(table)
        (pc,) = cpu.transform(table)
    if gpu.centroids.shape != (BISECT_K, d) or not np.array_equal(
            pg.column("prediction"), pc.column("prediction")) or \
            not np.allclose(gpu.centroids, cpu.centroids, rtol=1e-10,
                            atol=1e-10):
        fail("bisecting kmeans: the card's fit differs from the CPU port's")
    rec = {"path": "bisecting_kmeans_fit", "rows": n, "d": d, "k": BISECT_K,
           "fit_and_transform_s": gpu_s,
           "max_abs_centroid_err_vs_cpu": float(
               np.abs(gpu.centroids - cpu.centroids).max())}
    log("path " + json.dumps(rec))
    return recs


def device_share(torch, fn):
    """Share of ``fn``'s wall time during which the card ran kernels or
    copies: the device events' self time from ``torch.profiler`` (None when
    the profiler reports no device time)."""
    from torch.autograd import DeviceType
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
        # Host ops also carry the device time of the kernels they launch;
        # count each device event once, on the device's own rows.
        if e.device_type == DeviceType.CUDA:
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
    spmv_widths_phase(torch)
    chain_rec = chain_phase(torch, timer, "float64", 1e-12, 1e-12)
    chain_phase(torch, timer, "float32", 1e-5, 1e-6)
    segsum_rec = segsum_phase(torch, timer)
    topk_rec = topk_phase(torch, timer)

    serve_spmv = sparse_path(torch)
    chain_rec["launches"] = dense_path(torch)
    dense_fit_path(torch)
    fit_counts = sparse_fit_path(torch)
    spmv_rec["launches"] = serve_spmv + fit_counts["spmv"]
    segsum_rec["launches"] = fit_counts["segment_sum"]
    topk_rec["launches"] = knn_path(torch, timer) + lsh_path(torch, timer)
    del timer
    kmeans_path(torch)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (spmv_rec, chain_rec, segsum_rec,
                                            topk_rec)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- optional: one checkout's kernels against another's on the same card ----------

AB_TOPK_CASES = TOPK_CASES[:4]


def ab_inner(tree: str) -> int:
    """Time ``spmv`` (the serving and fit shapes), ``topk`` (four cases of
    its phase), ``segment_sum`` (the fit shape, unsorted and sorted, float32
    and float64) and ``fused_chain`` (100,000 x 32, float64 and float32)
    through the public wrappers of the checkout at ``tree``, by
    :class:`Timer`, and for the last two also by the profiler's device time
    of the kernel alone (the ``... device`` keys: the host's enqueue is in
    the first and not in the second); print one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from flinkml_tpu_torch.kernels import _build
    from flinkml_tpu_torch.kernels import chain as kchain
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.kernels import topk as ktopk

    if not os.path.abspath(_build.__file__).startswith(os.path.abspath(tree)):
        fail(f"--ab-inner imported {_build.__file__}, not {tree}'s")
    _build.build_all()
    timer = Timer(torch)
    out = {"tree": tree}
    for rows in (SPMV_ROWS, SPARSE_FIT_ROWS):
        _, indices, values, _, _ = make_criteo_csr(rows, SPMV_DIM, SPMV_NNZ,
                                                   seed=1)
        idx = torch.from_numpy(indices.reshape(rows, SPMV_NNZ)).cuda()
        val = torch.from_numpy(values.reshape(rows, SPMV_NNZ)).cuda()
        w = torch.from_numpy(np.random.default_rng(2).normal(
            size=SPMV_DIM).astype(np.float32)).cuda()
        out[f"spmv {rows} x {SPMV_NNZ}"] = timer(lambda: kspmv.spmv(idx, val,
                                                                     w))
    rng = np.random.default_rng(9)
    for rows, n, k, dtype, _ in AB_TOPK_CASES:
        shape = (n,) if rows is None else (rows, n)
        host = (-rng.integers(0, 176_401, size=shape).astype(dtype)
                if rows == 4096 else
                -np.round(rng.random(size=shape), 3).astype(dtype)
                if rows is None else rng.normal(size=shape).astype(dtype))
        x = torch.from_numpy(host).cuda()
        out[f"topk {list(shape)} k={k}"] = timer(lambda: ktopk.top_k(x, k))
        del x
    _, indices, values, _, _ = make_criteo_csr(SPARSE_FIT_ROWS, SPMV_DIM,
                                               SPMV_NNZ, seed=5)
    order = np.argsort(indices, kind="stable")
    for dtype in ("float32", "float64"):
        for sorted_ids in (False, True):
            sel = order if sorted_ids else slice(None)
            ids = torch.from_numpy(indices[sel]).cuda()
            vals = torch.from_numpy(values[sel].astype(dtype)).cuda()
            key = (f"segment_sum {'sorted' if sorted_ids else 'unsorted'} "
                   f"{dtype}")
            call = (lambda: ksegsum.segment_sum(
                vals, ids, SPMV_DIM, indices_are_sorted=sorted_ids))
            out[key] = timer(call)
            out[key + " device"] = kernel_device_ms(torch, call, "segsum")
            del ids, vals
    rng = np.random.default_rng(3)
    x = rng.normal(size=(CHAIN_ROWS, CHAIN_D))
    kernels = [s.transform_kernel()
               for s in chain_models(x, rng.normal(size=CHAIN_D))]
    program = kchain.ChainProgram(kernels, ["features"],
                                  ["s4", "prediction", "rawPrediction"])
    consts = tuple(k.constants for k in kernels)
    for dtype in ("float64", "float32"):
        xp = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
        call = (lambda: program([xp], consts, CHAIN_ROWS))
        out[f"fused_chain {dtype}"] = timer(call)
        out[f"fused_chain {dtype} device"] = kernel_device_ms(
            torch, call, "fused_chain")
    print(json.dumps(out), flush=True)
    return 0


def ab_main(old: str) -> int:
    """``--ab OLD``: the kernels of the checkout at OLD and of this one,
    each timed in its own process, in the order old, new, new, old."""
    here = os.path.dirname(os.path.abspath(__file__))
    print(card_line(), flush=True)
    for tree in (old, here, here, old):
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--ab-inner", tree], capture_output=True,
                              text=True, timeout=900)
        lines = [ln for ln in done.stdout.splitlines() if ln.startswith("{")]
        if done.returncode != 0 or not lines:
            fail(f"--ab-inner {tree}: exit {done.returncode}\n"
                 f"{done.stderr[-2000:]}")
        print(lines[-1], flush=True)
    return 0


# -- --variants: edited kernel sources timed through the wrappers -----------------

_CHAIN_DIV = ("v = b > T(0) ? (v - a) / b : T(0.5);",
              "v = b > T(0) ? (v - a) * b : T(0.5);")
_CHAIN_DIV2 = ("if (op & 4u) v = v / b;", "if (op & 4u) v = v * b;")
_CHAIN_LOAD = ("if (active && row + step < n_rows) W::load(x + (row + step) "
               "* d + col, next);",
               "for (int j = 0; j < V; ++j) next[j] = T(j) + T(0.25);")
_CHAIN_STORE = ("if (out != nullptr) W::store(out + row * d + col, v);",
                "if (out != nullptr && v[0] == T(-12345)) "
                "W::store(out + row * d + col, v);")

#: (name, source, literal edits): what each step of a kernel costs. A
#: variant that removes work gives wrong outputs on purpose.
VARIANTS = (
    ("chain as built", "chain.cu", []),
    ("chain: no x loads, no s4 stores", "chain.cu",
     [_CHAIN_LOAD, _CHAIN_STORE]),
    ("chain: the 4 divisions as multiplies", "chain.cu",
     [_CHAIN_DIV, _CHAIN_DIV2]),
    ("chain: no sigmoid in the head", "chain.cu",
     [("const T p = T(1) / (T(1) + exp_t(-acc));", "const T p = acc;")]),
    ("chain: 256-thread blocks", "chain.cu",
     [("constexpr int kVecThreads = 128;", "constexpr int kVecThreads = 256;")]),
    ("segsum as built", "segsum.cu", []),
    ("segsum: sorted runs stop at the owner's cells", "segsum.cu",
     [("    while (going && j < cells) {", "    while (false && j < cells) {")]),
    ("segsum: sorted without the gap zeroes", "segsum.cu",
     [("  zero_gaps(lo, hi, out);\n", "")]),
)


def build_variants(variants):
    """Write and build every variant (one ``nvcc`` each, in parallel, with
    the kernels' flags, into ``kernels/build/variants``); ``{name: CDLL}``."""
    import ctypes

    from flinkml_tpu_torch.kernels import _build

    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc, started = _build.nvcc_path(), []
    for i, (name, source, edits) in enumerate(variants):
        with open(os.path.join(_build.CSRC_DIR, source)) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                fail(f"variant {name!r}: {old!r} is not in {source}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = path[:-3] + ".so"
        proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", lib, path],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((name, proc, lib))
    libs = {}
    for name, proc, lib in started:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"variant {name!r} failed to build:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


class Through:
    """Route the kernel launches of the wrappers to ``lib`` while open."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        import ctypes

        from flinkml_tpu_torch.kernels import _build

        self.orig = _build.function

        def function(name, symbol, argtypes, restype=ctypes.c_int):
            fn = getattr(self.lib, symbol)
            fn.argtypes, fn.restype = list(argtypes), restype
            return fn
        _build.function = function

    def __exit__(self, *exc):
        from flinkml_tpu_torch.kernels import _build

        _build.function = self.orig


def kernel_device_ms(torch, fn, name: str, iters: int = 20):
    """Mean device time per call of ``fn`` of the kernels whose name holds
    ``name``, from ``torch.profiler`` (None when it reports none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key)
    return total / iters / 1e3 if total > 0 else None


def variants_main() -> int:
    """``--variants``: every entry of :data:`VARIANTS` through the port's
    own wrapper at the kernel phase's shapes (``fused_chain`` 100,000 x 32,
    ``segment_sum`` at the fit shape), timed by :class:`Timer` and by the
    profiler's device time of the kernel alone; one JSON line each."""
    import torch

    from flinkml_tpu_torch.kernels import chain as kchain
    from flinkml_tpu_torch.kernels import segsum as ksegsum

    if not torch.cuda.is_available():
        print("chip_smoke --variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    timer = Timer(torch)
    libs = build_variants(VARIANTS)

    def report(name, call, kernel, **keys):
        with Through(libs[name]):
            rec = {"variant": name, **keys, "ms": timer(call),
                   "device_ms": kernel_device_ms(torch, call, kernel)}
        print(json.dumps(rec), flush=True)

    rng = np.random.default_rng(3)
    x = rng.normal(size=(CHAIN_ROWS, CHAIN_D))
    kernels = [s.transform_kernel()
               for s in chain_models(x, rng.normal(size=CHAIN_D))]
    consts = tuple(k.constants for k in kernels)
    program = kchain.ChainProgram(kernels, ["features"],
                                  ["s4", "prediction", "rawPrediction"])
    for dtype in ("float64", "float32"):
        xp = torch.from_numpy(x).to("cuda", getattr(torch, dtype))
        for name, source, _ in VARIANTS:
            if source == "chain.cu":
                report(name, lambda: program([xp], consts, CHAIN_ROWS),
                       "fused_chain", dtype=dtype)

    _, indices, values, _, _ = make_criteo_csr(SPARSE_FIT_ROWS, SPMV_DIM,
                                               SPMV_NNZ, seed=5)
    order = np.argsort(indices, kind="stable")
    for dtype in ("float32", "float64"):
        for sorted_ids in (True, False):
            sel = order if sorted_ids else slice(None)
            ids = torch.from_numpy(indices[sel]).cuda()
            vals = torch.from_numpy(values[sel].astype(dtype)).cuda()
            for name, source, _ in VARIANTS:
                # The "sorted" variants edit the sorted path only.
                if source != "segsum.cu" or (
                        ": sorted" in name and not sorted_ids):
                    continue
                report(name, lambda: ksegsum.segment_sum(
                    vals, ids, SPMV_DIM, indices_are_sorted=sorted_ids),
                    "segsum", dtype=dtype, sorted=sorted_ids)
            del ids, vals
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        sys.exit(ab_main(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-inner":
        sys.exit(ab_inner(sys.argv[2]))
    if len(sys.argv) == 2 and sys.argv[1] == "--variants":
        sys.exit(variants_main())
    sys.exit(main())
