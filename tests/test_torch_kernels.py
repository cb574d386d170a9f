"""The port's kernel modules (``flinkml_tpu_torch.kernels``): each plain
PyTorch version against the JAX function it replaces, run through XLA and
through the Pallas kernel in interpret mode; the host side of the CUDA
``fused_chain`` (chain plans, refusals, the packed constant table — held
against the plain chain by a numpy model of the kernel's arithmetic); the
CUDA ``segment_sum``'s sorted run-flush, held bit for bit against the
Pallas kernel by a Python model of its chunking; ``top_k_plain`` bit for
bit against ``jax.lax.top_k`` and, away from signed zeros, the Pallas
``pallas_top_k`` in interpret mode; the build module. The CUDA kernels
themselves are held against their plain versions on the card by
``tests/test_torch_cuda.py``."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu import kernels as jax_kernels
from flinkml_tpu.kernels.topk import pallas_top_k
from flinkml_tpu_torch.api import ColumnKernel
from flinkml_tpu_torch.kernels import _build, _gate
from flinkml_tpu_torch.kernels import chain as kchain
from flinkml_tpu_torch.kernels import segsum as ksegsum
from flinkml_tpu_torch.kernels import spmv as kspmv
from flinkml_tpu_torch.kernels import topk as ktopk
from tests._segsum_ids import sorted_id_patterns
from tests._torch_port_common import (  # noqa: F401
    F32_ATOL,
    F32_RTOL,
    F64_RAW_RTOL,
    F64_SCALER_RTOL,
    JAX_BACKENDS,
    SPARSE_TOL,
    dense_data,
    five_stage_pair,
    jax_backend,
    jax_chain,
    on_cpu,
)


def _ell(rows, width, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(rows, width)).astype(np.int32)
    val = rng.normal(size=(rows, width)).astype(dtype)
    # ELL padding cells: index 0, value 0.
    pad = rng.random(size=(rows, width)) < 0.2
    idx[pad], val[pad] = 0, 0
    w = rng.normal(size=dim).astype(dtype)
    return idx, val, w


# -- spmv ------------------------------------------------------------------------

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(37, 9, 4096), (256, 39, 1000), (5, 1, 7)])
def test_spmv_plain_matches_jax(backend, dtype, shape, monkeypatch):
    """spmv_plain vs the JAX ``kernels.spmv`` (XLA gather-sum, or
    ``pallas_spmv`` interpreted) at rtol/atol 1e-5."""
    rows, width, dim = shape
    idx, val, w = _ell(rows, width, dim, dtype, seed=rows)
    jax_backend(monkeypatch, backend, "spmv")
    want = np.asarray(jax_kernels.spmv(idx, val, w))
    got = kspmv.spmv(torch.from_numpy(idx), torch.from_numpy(val),
                     torch.from_numpy(w))
    assert got.dtype == torch.from_numpy(val).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=SPARSE_TOL,
                               atol=SPARSE_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", [1, 7, 40, 1000])
def test_spmv_plain_matches_jitted_jax_twin(dtype, width):
    """spmv_plain at the widths the packer's DP picks, against the jitted
    JAX twin ``sum(values * take(w, indices), axis=1)`` at rtol/atol 1e-5,
    on a bucket view that starts at an odd row."""
    idx, val, w = _ell(23, width, 5000, dtype, seed=width)
    want = jax.jit(lambda i, v, ww: jnp.sum(v * jnp.take(ww, i, axis=0),
                                            axis=1))(idx[3:], val[3:], w)
    ti, tv = torch.from_numpy(idx)[3:], torch.from_numpy(val)[3:]
    got = kspmv.spmv(ti, tv, torch.from_numpy(w))
    assert got.shape == (20,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SPARSE_TOL, atol=SPARSE_TOL)


def test_spmv_vector_phase():
    """The cell phase at which indices and values both start a 16-byte
    group, read from the base pointers of a bucket view."""
    idx = torch.zeros((8, 39), dtype=torch.int32)
    for dtype in (torch.float32, torch.float64):
        val = torch.zeros((8, 39), dtype=dtype)
        assert kspmv.vector_phase(idx, val) == 0
        for start in range(1, 5):
            # Row `start` begins at cell 39 * start: the next aligned cell
            # of both arrays is (-39 * start) mod 4 cells later.
            assert kspmv.vector_phase(idx[start:], val[start:]) == (
                -39 * start) % 4
    # Indices and values whose alignments disagree: no vector phase.
    flat = torch.zeros(64, dtype=torch.float32)
    assert kspmv.vector_phase(idx.reshape(-1)[1:], flat[2:]) == -1


def test_spmv_unsupported_reasons():
    idx, val, w = (torch.from_numpy(a) for a in _ell(4, 3, 10, np.float32, 0))
    assert kspmv.unsupported_reason(idx, val, w) is None
    assert "int32" in kspmv.unsupported_reason(idx.long(), val, w)
    assert kspmv.unsupported_reason(idx, val.half(), w.half()) is None
    assert kspmv.unsupported_reason(idx, val.bfloat16(), w.bfloat16()) is None
    assert "!=" in kspmv.unsupported_reason(idx, val, w.double())
    assert "rank" in kspmv.unsupported_reason(idx, val, w[None])
    assert "shape" in kspmv.unsupported_reason(idx[:2], val, w)


# -- fused_chain -------------------------------------------------------------------

def _port_kernels(port_model):
    return [s.transform_kernel() for s in port_model.stages]


def _padded(x, bucket):
    xp = np.zeros((bucket,) + x.shape[1:], x.dtype)
    xp[: x.shape[0]] = x
    return torch.from_numpy(xp)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("rows", [6, 50, 300])
def test_chain_plain_matches_jax_f64(backend, rows, on_cpu):
    """The plain chain vs the JAX chain function (XLA, and the Pallas
    kernel interpreted) over the five-stage chain, float64."""
    x, coef = dense_data(rows=300)
    jax_model, port = five_stage_pair(x, coef)
    x = x[:rows]
    want = jax_chain(jax_model, x, backend)
    kernels = _port_kernels(port)
    outs = ["s1", "s2", "s3", "s4", "prediction", "rawPrediction"]
    got = kchain.fused_chain(kernels, ["features"], outs,
                             [_padded(x, max(8, 1 << (rows - 1).bit_length()))],
                             rows)
    got = {c: v[:rows].numpy() for c, v in got.items()}
    for c in ("s1", "s2", "s3", "s4"):
        assert got[c].dtype == want[c].dtype
        np.testing.assert_allclose(got[c], want[c], rtol=F64_SCALER_RTOL,
                                   atol=F64_SCALER_RTOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL)
    dot = want["s4"] @ coef
    decisive = np.abs(dot) > 1e-9
    np.testing.assert_array_equal(got["prediction"][decisive],
                                  want["prediction"][decisive])


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_chain_plain_matches_jax_f32(backend, on_cpu):
    """Float32 input: the scalers stay float32 in both packages; the port's
    LR head computes in float32 where the JAX package's (under x64)
    computes in float64 — hence the float32 tolerance."""
    x, coef = dense_data(rows=200, seed=4)
    jax_model, port = five_stage_pair(x, coef)
    x32 = x.astype(np.float32)
    want = jax_chain(jax_model, x32, backend)
    got = kchain.fused_chain(_port_kernels(port), ["features"],
                             ["s4", "prediction", "rawPrediction"],
                             [_padded(x32, 256)], 200)
    got = {c: v[:200].numpy() for c, v in got.items()}
    assert got["s4"].dtype == want["s4"].dtype == np.float32
    np.testing.assert_allclose(got["s4"], want["s4"], rtol=F32_RTOL,
                               atol=F32_ATOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=F32_RTOL, atol=F32_ATOL)


def _kernel_model(plan, table, ops, x):
    """numpy model of csrc/chain.cu's arithmetic over the packed table."""
    d = x.shape[1]
    stride = 2 * d + 2
    v = x.copy()
    for s in range(plan.n_run):
        op = (ops >> (3 * s)) & 7
        st = table[s * stride:(s + 1) * stride]
        a, b, scale, offset = st[:d], st[d:2 * d], st[2 * d], st[2 * d + 1]
        if op & 1:
            v = np.where(b > 0, (v - a) / np.where(b > 0, b, 1), v.dtype.type(0.5))
            v = v * scale + offset
        else:
            if op & 2:
                v = v - a
            if op & 4:
                v = v / b
    out = {}
    if plan.out_col is not None:
        out[plan.out_col] = v
    if plan.head:
        dot = v @ table[plan.n_run * stride:]
        p = 1 / (1 + np.exp(-dot))
        out[plan.pred_col] = (dot >= 0).astype(v.dtype)
        out[plan.raw_col] = np.stack([1 - p, p], axis=-1)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("outs", [("s4", "prediction", "rawPrediction"),
                                  ("s1",), ("s2",), ("s3",)])
def test_packed_table_reproduces_plain_chain(dtype, outs, on_cpu):
    """The table the host packs for the CUDA kernel (constants cast to the
    compute dtype before the zero guards, MinMax spans, op bits) gives the
    plain chain's scaler outputs exactly, eager and truncated."""
    x, coef = dense_data(rows=64, seed=5)
    _, port = five_stage_pair(x, coef)
    kernels = _port_kernels(port)
    x = x.astype(dtype)
    plan = kchain.plan_chain(kernels, ["features"], outs)
    table, ops = kchain.pack_table(plan, kernels,
                                   [k.constants for k in kernels],
                                   torch.from_numpy(x).dtype, x.shape[1])
    table = table.numpy()
    assert table.dtype == dtype
    got = _kernel_model(plan, table, ops, x)
    want = kchain.chain_plain(kernels, ["features"], outs,
                              [torch.from_numpy(x)],
                              [k.constants for k in kernels], 64)
    for c in outs:
        w = want[c].numpy()
        if c == "rawPrediction":
            np.testing.assert_allclose(got[c], w, rtol=F32_RTOL, atol=F32_ATOL)
        elif c != "prediction":
            np.testing.assert_array_equal(got[c], w)


@pytest.mark.parametrize("d,itemsize,ptr,want", [
    (32, 4, 0, "vector"), (32, 8, 16, "vector"), (4, 4, 32, "vector"),
    (2, 8, 0, "vector"), (128, 4, 0, "vector"), (64, 8, 0, "vector"),
    (12, 4, 0, "vector"),
    (1, 4, 0, "scalar"), (1, 8, 0, "scalar"), (7, 4, 0, "scalar"),
    (33, 4, 0, "scalar"), (123, 4, 0, "scalar"), (132, 4, 0, "scalar"),
    (66, 8, 0, "scalar"), (1000, 8, 0, "scalar"),
    (32, 4, 4, "scalar"), (32, 8, 8, "scalar"),
])
def test_chain_route_rule(d, itemsize, ptr, want):
    """The vector route takes rows of whole 16-byte chunks (at most 32) on
    a 16-byte-aligned base; every other width or view is scalar."""
    assert kchain.route(d, itemsize, ptr) == want
    assert want in kchain.ROUTES


@pytest.mark.parametrize("d,itemsize,want", [
    (32, 4, (8, 4, 4)), (32, 8, (16, 2, 2)), (4, 4, (1, 32, 4)),
    (2, 8, (1, 32, 2)), (12, 4, (4, 8, 4)), (128, 4, (32, 1, 4)),
    (64, 8, (32, 1, 2)), (40, 8, (32, 1, 2)),
])
def test_chain_lane_group(d, itemsize, want):
    """A power-of-two lane group covers a row, one 16-byte chunk a lane:
    at d=32 f32 eight lanes of 4 columns, four rows a warp."""
    group, rows_per_warp, cols = kchain.lane_group(d, itemsize)
    assert (group, rows_per_warp, cols) == want
    assert group * rows_per_warp == 32 and group * cols * itemsize >= d * itemsize
    assert (group // 2) * cols < d   # no group is twice what the row needs


def _vector_route_dot(v, coef, itemsize):
    """The vector route's dot, as csrc/chain.cu orders it: each lane of a
    group adds its chunk's products left to right from 0, then a fixed xor
    tree over the group's lanes (idle lanes add 0)."""
    d = v.shape[1]
    group, _, cols = kchain.lane_group(d, itemsize)
    dt = v.dtype.type
    parts = np.zeros((v.shape[0], group), v.dtype)
    for q in range(group):
        for j in range(q * cols, min((q + 1) * cols, d)):
            parts[:, q] = parts[:, q] + v[:, j] * coef[j]
    off = group // 2
    while off:
        parts = parts + parts[:, np.arange(group) ^ off]
        off //= 2
    assert parts.dtype == np.dtype(dt)
    return parts[:, 0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_vector_route_dot_order_within_tolerance(dtype, on_cpu):
    """The vector route's dot order (lane chunks, xor tree) gives the plain
    chain's rawPrediction within the declared tolerances."""
    x, coef = dense_data(rows=64, d=32, seed=9)
    _, port = five_stage_pair(x, coef)
    kernels = _port_kernels(port)
    x = x.astype(dtype)
    outs = ("s4", "prediction", "rawPrediction")
    want = kchain.chain_plain(kernels, ["features"], outs,
                              [torch.from_numpy(x)],
                              [k.constants for k in kernels], 64)
    s4 = want["s4"].numpy()
    dot = _vector_route_dot(s4, coef.astype(dtype), np.dtype(dtype).itemsize)
    p = 1 / (1 + np.exp(-dot))
    tol = (F64_RAW_RTOL, F64_RAW_RTOL) if dtype == np.float64 \
        else (F32_RTOL, F32_ATOL)
    np.testing.assert_allclose(np.stack([1 - p, p], -1),
                               want["rawPrediction"].numpy(), rtol=tol[0],
                               atol=tol[1])


def test_chain_plans():
    x, coef = dense_data(rows=20)
    _, port = five_stage_pair(x, coef)
    k = _port_kernels(port)
    eager = kchain.plan_chain(k, ["features"], ["s4", "prediction",
                                                "rawPrediction"])
    assert (eager.n_run, eager.out_col, eager.head) == (4, "s4", "binomial")
    assert eager.parts == (kchain.PartPlan(0),)
    lazy = kchain.plan_chain(k, ["features"], ["s2"])
    assert (lazy.n_run, lazy.out_col, lazy.head) == (2, "s2", None)
    scalers_only = kchain.plan_chain(k[:3], ["features"], ["s3"])
    assert (scalers_only.n_run, scalers_only.head) == (3, None)
    # A head with no scaler before it (the JAX package's single-stage run).
    head_only = kchain.plan_chain(k[4:], ["s4"], ["prediction",
                                                  "rawPrediction"])
    assert (head_only.n_run, head_only.out_col, head_only.head) == \
        (0, None, "binomial")


def test_chain_refusals():
    x, coef = dense_data(rows=20)
    _, port = five_stage_pair(x, coef)
    k = _port_kernels(port)
    refuse = pytest.raises(fml.KernelUnsupportedError, match="fused_chain")
    with refuse:
        kchain.plan_chain([], [], ["s1"])
    with refuse:   # a stage the kernel has no op for
        other = ColumnKernel(("s4",), ("o",), fn=None,
                             fingerprint=("PolynomialExpansion", "s4", "o"))
        kchain.plan_chain(k[:4] + [other], ["features"], ["o"])
    with pytest.raises(fml.KernelUnsupportedError, match="grammar"):
        # A prologue stage after a scaler.
        onehot = ColumnKernel(("c",), ("o",), fn=None, fingerprint=(
            "OneHotEncoderModel", ("c",), ("o",), True, (3,)))
        kchain.plan_chain(k[:1] + [onehot], ["features", "c"], ["o"])
    with refuse:   # not a linear chain
        kchain.plan_chain([k[0], k[2]], ["features"], ["s3"])
    with refuse:   # two intermediate outputs in one launch
        kchain.plan_chain(k, ["features"], ["s1", "s2"])
    with refuse:   # more stages than the op word holds
        many = [dataclasses.replace(k[0], input_cols=(f"c{i}",),
                                    output_cols=(f"c{i + 1}",))
                for i in range(kchain.MAX_STAGES + 1)]
        kchain.plan_chain(many, ["c0"], [f"c{kchain.MAX_STAGES + 1}"])
    with refuse:   # a head's outputs are written together
        kchain.plan_chain(k, ["features"], ["prediction"])
    with refuse:   # with the head, only the last scaler's output
        kchain.plan_chain(k, ["features"], ["s2", "prediction",
                                            "rawPrediction"])
    program = kchain.ChainProgram(k, ["features"], ["s1"])
    with refuse:   # CPU tensors never reach the CUDA program
        program([torch.zeros(8, x.shape[1])], [kk.constants for kk in k], 4)


def test_pack_table_refuses_dim_mismatch():
    x, coef = dense_data(rows=20)
    _, port = five_stage_pair(x, coef)
    k = _port_kernels(port)
    plan = kchain.plan_chain(k, ["features"], ["s4", "prediction",
                                               "rawPrediction"])
    with pytest.raises(ValueError, match="dim"):
        kchain.pack_table(plan, k, [kk.constants for kk in k],
                          torch.float64, x.shape[1] + 1)


# -- fused_chain: the prologue and the class heads --------------------------------

def _stage_cols(n=60, seed=21):
    """Seeded columns for the single-stage chains: features [n, 4],
    a label, a float and an int category column."""
    rng = np.random.default_rng(seed)
    return {
        "features": rng.normal(size=(n, 4)) * 2.0 + 1.0,
        "label": (rng.random(n) > 0.5).astype(np.float64),
        "c1": rng.integers(0, 4, size=n).astype(np.float64),
        "c2": rng.integers(0, 3, size=n),
    }


def _nine_stages():
    """``{name: (jax stage, port stage, serving columns)}`` for each of
    the nine stages with a ``transform_kernel``, the port's built from the
    JAX model data, as ``tests/test_pipeline_fusion.py`` feeds them one at
    a time. The serving columns hold out-of-range categories and the
    dropped-last one."""
    from flinkml_tpu.io.read_write import load_stage as jax_load  # noqa: F401
    from flinkml_tpu.models import kmeans as jax_kmeans
    from flinkml_tpu.models import logistic_regression as jax_lr
    from flinkml_tpu.models import one_hot_encoder as jax_ohe
    from flinkml_tpu.models import scalers as jax_scalers
    from flinkml_tpu.models import vector_assembler as jax_va
    from flinkml_tpu.table import Table as JaxTable
    from flinkml_tpu_torch.io.read_write import instantiate_with_params
    from tests._torch_port_common import port_stage_like

    cols = _stage_cols()
    serve = _stage_cols(seed=22)
    serve["c1"][:3] = [5.0, 3.0, -1.0]
    serve["c2"][:2] = [9, 2]
    train = JaxTable(cols)
    rng = np.random.default_rng(23)
    out = {}
    for name in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler",
                 "RobustScaler"):
        cls = getattr(jax_scalers, name)
        m = cls().set(cls.INPUT_COL, "features").set(cls.OUTPUT_COL, "out")
        m = m.fit(train)
        out[name] = (m, port_stage_like(m), serve)
    va = jax_va.VectorAssembler().set_input_cols(["features", "label"]) \
        .set_handle_invalid("keep").set_output_col("out")
    out["VectorAssembler"] = (
        va, instantiate_with_params(fml.VectorAssembler,
                                    va.get_param_map_json()), serve)
    oh = jax_ohe.OneHotEncoder().set_input_cols(["c1", "c2"]) \
        .set_output_cols(["o1", "o2"]).set_handle_invalid("keep").fit(train)
    out["OneHotEncoder"] = (oh, port_stage_like(oh), serve)
    for name, coef in (("LogisticRegression", rng.normal(size=(1, 4))),
                       ("LogisticRegressionMultinomial",
                        rng.normal(size=(1, 3, 4)))):
        m = jax_lr.LogisticRegressionModel()
        m.set_model_data(JaxTable({"coefficient": coef}))
        out[name] = (m, port_stage_like(m), serve)
    km = jax_kmeans.KMeansModel().set_model_data(
        JaxTable({"centroids": cols["features"][None, :3]}))
    out["KMeans"] = (km, port_stage_like(km), serve)
    return out


NINE = ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler",
        "VectorAssembler", "OneHotEncoder", "LogisticRegression",
        "LogisticRegressionMultinomial", "KMeans")


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("name", NINE)
def test_single_stage_chain_matches_jax(backend, name, monkeypatch, on_cpu):
    """Each of the nine kernel-capable stages alone: the port's plain chain
    against the JAX chain function (XLA, and the Pallas chain kernel
    interpreted) — equal bits and dtypes for the scalers, the assembler and
    the one-hot encoder; rawPrediction within 1e-10 and equal predictions
    for the heads (on these rows no two classes are within 1e-9)."""
    from tests._torch_port_common import jax_chain_cols, port_chain_cols

    jax_stage, port_stage, serve = _nine_stages()[name]
    jax_backend(monkeypatch, backend, "fused_chain")
    want = jax_chain_cols([jax_stage.transform_kernel()], serve, backend)
    got = port_chain_cols([port_stage.transform_kernel()], serve)
    assert set(got) == set(want)
    for c, w in want.items():
        assert got[c].dtype == w.dtype, c
        if c == "rawPrediction":
            np.testing.assert_allclose(got[c], w, rtol=F64_RAW_RTOL,
                                       atol=F64_RAW_RTOL)
        else:
            np.testing.assert_array_equal(got[c], w, err_msg=c)


def _row_model(plan, lay, x_parts):
    """numpy model of csrc/chain.cu's row: every in-row part in order, a
    dense one cast to the row's dtype, a one-hot one by the kernel's slot
    rule (truncate; outside [0, max_index], NaN included, to the catch-all
    slot; dropLast's last category all zero)."""
    dt = np.dtype(str(lay.dtype).replace("torch.", ""))
    cols = []
    for part, width in zip(plan.parts, lay.widths):
        if not part.in_row:
            continue
        v = x_parts[part.ext]
        n = v.shape[0]
        if part.onehot is None:
            cols.append(v.reshape(n, -1).astype(dt))
            continue
        max_index, drop_last = part.onehot
        t = np.trunc(v.astype(np.float64))
        with np.errstate(invalid="ignore"):
            valid = (t >= 0) & (t <= max_index)
        slot = np.where(valid, t, width - 1).astype(np.int64)
        oh = np.zeros((n, width), dt)
        oh[np.arange(n), slot] = 1
        oh[valid & drop_last & (t == max_index)] = 0
        cols.append(oh)
    return np.concatenate(cols, axis=1)


def _head_model(plan, table, k, v):
    """numpy model of the class heads over the packed table."""
    d = v.shape[1]
    off = plan.n_run * (2 * d + 2)
    if plan.head == "multinomial":
        logits = v @ table[off:off + d * k].reshape(d, k)
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return {plan.pred_col: np.argmax(logits, axis=1).astype(v.dtype),
                plan.raw_col: e / e.sum(axis=1, keepdims=True)}
    ct = table[off:off + d * k].reshape(d, k)
    c2 = table[off + d * k:off + d * k + k]
    d2 = np.maximum((np.sum(v * v, axis=1)[:, None] - 2 * (v @ ct)) + c2, 0)
    return {plan.pred_col: np.argmin(d2, axis=1)}


@pytest.mark.parametrize("case", ["census", "onehot", "multinomial",
                                  "kmeans", "assembler_kmeans"])
def test_packed_layout_reproduces_plain_chain(case, on_cpu):
    """The host side of the new chains on the CPU: the plan's parts, the
    row's dtype and width (:meth:`ChainProgram.layout`), and the packed
    head matrices (``W^T``, ``C^T`` and ``|C|^2``), run through a numpy
    model of the kernel's arithmetic, give the plain chain's outputs."""
    from tests.test_torch_features import census_pair

    stages = _nine_stages()
    if case == "census":
        _, port_stages, serve = census_pair(n=40)
    elif case == "onehot":
        _, st, serve = stages["OneHotEncoder"]
        port_stages = [st]
    elif case == "multinomial":
        _, st, serve = stages["LogisticRegressionMultinomial"]
        port_stages = [stages["MinMaxScaler"][1], st.set_features_col("out")]
    elif case == "kmeans":
        _, st, serve = stages["KMeans"]
        port_stages = [st]
    else:
        _, va, serve = stages["VectorAssembler"]
        km = fml.KMeansModel().set_features_col("out").set_model_data(
            fml.Table({"centroids": np.random.default_rng(3).normal(
                size=(1, 6, 5))}))
        port_stages = [va, km]
    kernels = [s.transform_kernel() for s in port_stages]
    from flinkml_tpu_torch.pipeline_fusion import (
        _output_cols, external_inputs)

    ext, outs = external_inputs(kernels), _output_cols(kernels)
    want = kchain.chain_plain(kernels, ext, outs,
                              [torch.from_numpy(np.asarray(serve[c]))
                               for c in ext],
                              [k.constants for k in kernels], 60)
    # The executor's eager set: terminals and the pins.
    eager = [c for c in outs if c in ("prediction", "rawPrediction")] or outs
    pins = [c for k in kernels if k.pin_inputs for c in k.input_cols
            if c in outs]
    program = kchain.ChainProgram(kernels, ext, pins + eager)
    plan = program.plan
    lay = program.layout([torch.from_numpy(np.asarray(serve[c]))
                          for c in ext])
    table, ops = kchain.pack_table(plan, kernels,
                                   [k.constants for k in kernels], lay.dtype,
                                   lay.d)
    table = table.numpy()
    k = kchain.head_classes(plan, [k.constants for k in kernels])
    row = _row_model(plan, lay, [np.asarray(serve[c]) for c in ext])
    assert row.shape[1] == lay.d
    if plan.row_col is not None:
        np.testing.assert_array_equal(row, want[plan.row_col].numpy())
    if len(plan.parts) == 1 and plan.parts[0].out_col is not None:
        np.testing.assert_array_equal(row,
                                      want[plan.parts[0].out_col].numpy())
    v = _kernel_model(dataclasses.replace(plan, head=None, out_col="v"),
                      table, ops, row)["v"]
    if plan.out_col is not None:
        np.testing.assert_array_equal(v, want[plan.out_col].numpy())
    if plan.head == "binomial":
        got = _kernel_model(plan, table, ops, row)
    elif plan.head is not None:
        got = _head_model(plan, table, k, v)
    for c in (plan.pred_col, plan.raw_col) if plan.head else ():
        if c == "rawPrediction":
            np.testing.assert_allclose(got[c], want[c].numpy(),
                                       rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL)
        elif c is not None:
            assert got[c].dtype == want[c].numpy().dtype
            np.testing.assert_array_equal(got[c], want[c].numpy())


def test_chain_plans_with_prologue():
    """The census chain's plans: the eager program (the scaled row and the
    head's outputs; the one-hot outputs and the assembled row lazy), a lazy
    one-hot output (that unit alone), the assembled row (its parts), a
    request that mixes a one-hot output with the head's, and the layout:
    the row of 3 one-hot parts and 2 dense ones, float64, gathered."""
    from tests.test_torch_features import census_pair

    _, port_stages, serve = census_pair(n=20)
    kernels = [s.transform_kernel() for s in port_stages]
    ext = ["c0", "x0", "c1", "x1", "c2"]
    eager = kchain.plan_chain(kernels, ext,
                              ["scaled", "prediction", "rawPrediction"])
    assert (eager.n_run, eager.out_col, eager.head, eager.row_col) == \
        (1, "scaled", "binomial", None)
    assert [p.ext for p in eager.parts] == [0, 1, 2, 3, 4]
    assert [p.onehot is not None for p in eager.parts] == \
        [True, False, True, False, True]
    assert all(p.out_col is None for p in eager.parts)
    lazy = kchain.plan_chain(kernels, ext, ["oc1"])
    assert (lazy.n_run, lazy.head, lazy.row_col) == (0, None, None)
    assert lazy.parts == (kchain.PartPlan(2, (6, True), "oc1"),)
    row = kchain.plan_chain(kernels, ext, ["features"])
    assert (row.row_col, len(row.parts)) == ("features", 5)
    mixed = kchain.plan_chain(kernels, ext, ["oc2", "prediction",
                                             "rawPrediction"])
    assert [p.out_col for p in mixed.parts] == [None, None, None, None,
                                                "oc2"]
    program = kchain.ChainProgram(kernels, ext, ["scaled", "prediction",
                                                 "rawPrediction"])
    vals = [torch.from_numpy(np.asarray(serve[c])) for c in ext]
    lay = program.layout(vals)
    assert (lay.dtype, lay.widths, lay.d, lay.gather) == \
        (torch.float64, (4, 1, 7, 2, 2), 16, True)
    assert lay.route == kchain.route(16, 8, vals[1].data_ptr(),
                                     vals[3].data_ptr())


def test_chain_layout_routes(on_cpu):
    """The route rule over parts: one aligned dense float input of the
    row's dtype takes 16-byte loads (no gather); an integer input is
    gathered (promoted to float64); a misaligned dense part or an
    out-of-row part sends the chain to the scalar route."""
    x, coef = dense_data(rows=20, d=4)
    _, port = five_stage_pair(x, coef)
    k = _port_kernels(port)
    program = kchain.ChainProgram(k[:1], ["features"], ["s1"])
    lay = program.layout([torch.zeros(8, 4, dtype=torch.float64)])
    assert (lay.gather, lay.route, lay.d) == (False, "vector", 4)
    lay = program.layout([torch.zeros(8, 4, dtype=torch.int32)])
    assert (lay.gather, lay.dtype, lay.route) == (True, torch.float64,
                                                  "vector")
    buf = torch.zeros(33, dtype=torch.float64)
    lay = program.layout([buf[1:].view(8, 4)])
    assert lay.route == "scalar"
    assert kchain.route(4, 8, 0, 16) == "vector"
    assert kchain.route(4, 8, 0, 8) == "scalar"
    assert kchain.route(4, 8, all_in_row=False) == "scalar"
    # A float16 column is taken: a float16 row, gathered (its registers
    # are float32).
    lay = program.layout([torch.zeros(8, 4, dtype=torch.float16)])
    assert (lay.dtype, lay.gather, lay.route) == (torch.float16, True,
                                                  "vector")


@pytest.mark.parametrize("n_table,n_stages,per_warp,warps,item,want", [
    # StandardScaler -> KMeans at 784 x k = 64: the whole table fits in
    # float32; in float64 the centroids are read from device memory.
    (1570 + 784 * 64 + 64, 1570, 784, 8, 4, (51810, 8, 232328)),
    (1570 + 784 * 64 + 64, 1570, 784, 8, 8, (1570, 8, 62736)),
    # A multinomial head of 1,000 classes: rows and logits, 8 warps.
    (1570 + 784 * 1000, 1570, 1784, 8, 8, (1570, 8, 126736)),
    # Eight stages at d = 2,000 do not fit beside the rows: all in device
    # memory.
    (8 * 4002, 8 * 4002, 2000, 8, 8, (0, 8, 128000)),
    # A row of 20,000 float32: two warps a block.
    (40002 + 20000 * 5 + 5, 40002, 20000, 8, 4, (0, 2, 160000)),
    # A row one warp cannot stage.
    (60002, 60002, 30000, 8, 8, None),
    # No head: the table only.
    (2 * 66, 2 * 66, 0, 4, 8, (132, 4, 1056)),
])
def test_chain_shared_memory_placement(n_table, n_stages, per_warp, warps,
                                       item, want):
    """What the kernel keeps in shared memory: the whole table beside the
    warps' row buffers when it fits, else the head's block in device
    memory, then the stages' too, then fewer warps; a row buffer alone
    over the limit is the one refusal."""
    got = kchain.shared_memory(n_table, n_stages, per_warp, warps, item)
    assert got == want
    if got is not None:
        assert got[2] <= kchain.MAX_SMEM_BYTES


def test_chain_refuses_too_many_parts():
    """More input parts than the kernel's part list holds."""
    n = kchain.MAX_PARTS + 1
    cols = tuple(f"c{i}" for i in range(n))
    va = ColumnKernel(cols, ("v",), fn=None,
                      fingerprint=("VectorAssembler", cols, "v"))
    with pytest.raises(fml.KernelUnsupportedError, match="MAX_PARTS"):
        kchain.plan_chain([va], cols, ["v"])


# -- segment_sum -------------------------------------------------------------------

def _segsum_inputs(cells, k, num_segments, dtype, sorted_ids, seed):
    """Seeded values and int32 ids; sorted ids come in runs of 1..40 cells,
    so runs start, end inside and span the kernel's 8- and 16-cell
    owners."""
    rng = np.random.default_rng(seed)
    shape = (cells,) if k is None else (cells, k)
    values = rng.normal(size=shape).astype(dtype)
    if sorted_ids:
        runs = rng.integers(1, 41, size=cells)
        starts = np.sort(rng.choice(num_segments, size=min(cells, num_segments),
                                    replace=False))
        ids = np.repeat(starts, runs[:starts.size])[:cells]
        ids = np.concatenate([ids, np.full(cells - ids.size, starts[-1])])
    else:
        ids = rng.integers(0, num_segments, size=cells)
    return values, ids.astype(np.int32)


def _run_flush_model(values, ids, num_segments, phase=0):
    """The CUDA sorted kernel's arithmetic, from its write plan
    (``segsum.sorted_plan``): every segment it stores is ``0 + v[first] +
    ... + v[end - 1]`` added left to right in the values' dtype."""
    v2 = values[:, None] if values.ndim == 1 else values
    k = v2.shape[1]
    out = np.full((num_segments, k), np.nan, values.dtype)
    for seg, _, first, end in ksegsum.sorted_plan(ids, num_segments, k, phase):
        acc = np.zeros(k, values.dtype)
        for j in range(first, end):
            acc = (acc + v2[j]).astype(values.dtype)
        out[seg] = acc
    return out[:, 0] if values.ndim == 1 else out


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("sorted_ids", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(500, None, 97), (300, 4, 40), (7, None, 3)])
def test_segment_sum_plain_matches_jax(backend, sorted_ids, dtype, shape,
                                       monkeypatch):
    """segment_sum_plain vs the JAX ``kernels.segment_sum`` (XLA, or
    ``pallas_segment_sum`` interpreted), flat and row payload, at rtol/atol
    1e-6 (f32; 1e-12 f64): both sum in element order on the CPU."""
    cells, k, nseg = shape
    values, ids = _segsum_inputs(cells, k, nseg, dtype, sorted_ids, seed=cells)
    jax_backend(monkeypatch, backend, "segment_sum")
    want = np.asarray(jax_kernels.segment_sum(
        values, ids, nseg, indices_are_sorted=sorted_ids))
    got = ksegsum.segment_sum(torch.from_numpy(values), torch.from_numpy(ids),
                              nseg, indices_are_sorted=sorted_ids)
    assert got.dtype == torch.from_numpy(values).dtype
    tol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [None, 3])
def test_segment_sum_run_flush_model_is_bitwise_pallas(dtype, k):
    """The CUDA run-flush's order (modelled in numpy from its write plan)
    equals the Pallas sorted kernel bit for bit — runs shorter than, equal
    to and longer than an owner's cells, crossing owner boundaries."""
    from flinkml_tpu.kernels.segsum import pallas_segment_sum

    values, ids = _segsum_inputs(400, k, 60, dtype, True, seed=7)
    assert np.max(np.bincount(ids)) > 2 * ksegsum.SORTED_CHUNK
    want = np.asarray(pallas_segment_sum(values, ids, 60,
                                         indices_are_sorted=True,
                                         interpret=True))
    np.testing.assert_array_equal(_run_flush_model(values, ids, 60), want)


@pytest.mark.parametrize("pattern", sorted(sorted_id_patterns()))
@pytest.mark.parametrize("k,phase", [(1, 0), (1, 1), (1, 3), (1, -1),
                                     (16, -1)])
def test_sorted_plan_writes_every_segment_once(pattern, k, phase):
    """The sorted kernel's ownership rule: every output segment is stored
    exactly once (the head and tail by the grid, each run and the gap
    before it by the owner of the run's first cell), and the runs cover
    every cell once, in order."""
    ids, nseg = sorted_id_patterns()[pattern]
    plan = ksegsum.sorted_plan(ids, nseg, k, phase)
    segs = np.array([w[0] for w in plan])
    np.testing.assert_array_equal(np.sort(segs), np.arange(nseg))
    runs = sorted((first, end, seg, writer)
                  for seg, writer, first, end in plan if end > first)
    np.testing.assert_array_equal([r[0] for r in runs],
                                  [0] + [r[1] for r in runs[:-1]])
    assert runs[-1][1] == ids.size
    per = ksegsum.SORTED_OWN if k == 1 else ksegsum.SORTED_CHUNK
    base0 = phase - 4 if (k == 1 and phase > 0) else 0
    for first, end, seg, writer in runs:
        assert (ids[first:end] == seg).all()
        # The writer owns the run's first cell.
        assert writer == (first - base0) // per
    for seg, writer, first, end in plan:
        if writer == -1:
            assert seg < ids[0] or seg > ids[-1]
        elif first == end:   # a gap: between the previous id and the run's
            assert ids[first - 1] < seg < ids[first]


@pytest.mark.parametrize("ids,nseg", [
    ([5, 2], 8), ([0, 0, 7, 1, 1], 9),
    (list(np.random.default_rng(4).permutation(3000) % 700), 701),
])
@pytest.mark.parametrize("k", [1, 16])
def test_sorted_plan_repairs_descending_ids(ids, nseg, k):
    """Ids that do not ascend: the run-flush would give a segment two
    writers (on [5, 2] segments 2-5, on [0, 0, 7, 1, 1] segments 1-7), so
    the kernel's repair pass replaces every store — each segment has
    exactly one final value, its cells' sum into zero. Ascending ids (equal
    neighbours included) never take the repair."""
    ids = np.asarray(ids, np.int32)
    plan = ksegsum.sorted_plan(ids, nseg, k)
    segs = sorted(w[0] for w in plan)
    assert segs == list(range(nseg))
    assert {w[1] for w in plan} == {ksegsum.REPAIR}
    for pattern in sorted_id_patterns().values():
        writers = {w[1] for w in ksegsum.sorted_plan(*pattern, k)}
        assert ksegsum.REPAIR not in writers


@pytest.mark.parametrize("cells,phase,want", [
    (10, 0, [0]), (10, 1, [-3]), (4096, 3, [-1, 2047, 4095]),
    (4100, -1, [0, 2048, 4096]), (2048, 0, [0]),
])
def test_sorted_tile_bases(cells, phase, want):
    """Tiles of 2,048 cells start on the 16-byte phase (the first up to 3
    cells before cell 0) and cover every cell."""
    assert ksegsum.SORTED_TILE == 2048
    assert ksegsum.sorted_tile_bases(cells, phase) == want


@pytest.mark.parametrize("pattern", sorted(sorted_id_patterns()))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [None, 16])
def test_sorted_plan_sums_are_bitwise_pallas(pattern, dtype, k):
    """The in-order sums the write plan implies equal the JAX
    ``pallas_segment_sum`` sorted path (interpreted) bit for bit on every
    id pattern, gaps included."""
    from flinkml_tpu.kernels.segsum import pallas_segment_sum

    ids, nseg = sorted_id_patterns()[pattern]
    ids = ids.astype(np.int32)
    rng = np.random.default_rng(ids.size)
    values = rng.normal(size=(ids.size,) if k is None
                        else (ids.size, k)).astype(dtype)
    want = np.asarray(pallas_segment_sum(values, ids, nseg,
                                         indices_are_sorted=True,
                                         interpret=True))
    got = _run_flush_model(values, ids, nseg, phase=1)
    np.testing.assert_array_equal(got, want)


def test_payload_vector_rule():
    """Vector width of the unsorted [cells, k] path: 4 or 2 float32
    columns, 2 float64 columns, from k and the base alignment."""
    base = torch.zeros(64 * 17, dtype=torch.float32)
    assert base.data_ptr() % 16 == 0
    assert ksegsum.payload_vector(base.reshape(-1, 16)) == 4
    assert ksegsum.payload_vector(base[:60].reshape(-1, 6)) == 2
    assert ksegsum.payload_vector(base[2:66].reshape(-1, 16)) == 2
    assert ksegsum.payload_vector(base[1:65].reshape(-1, 16)) == 1
    assert ksegsum.payload_vector(base[:63].reshape(-1, 7)) == 1
    d = base.double()
    assert ksegsum.payload_vector(d.reshape(-1, 16)) == 2
    assert ksegsum.payload_vector(d[1:65].reshape(-1, 16)) == 1
    assert ksegsum.payload_vector(d[:63].reshape(-1, 3)) == 1


def test_segment_sum_empty_inputs():
    """Zero cells or zero segments: zeros of the output shape."""
    v = torch.zeros(0, 3, dtype=torch.float32)
    out = ksegsum.segment_sum(v, torch.zeros(0, dtype=torch.int32), 5)
    assert out.shape == (5, 3) and not out.any()
    out = ksegsum.segment_sum(torch.zeros(0), torch.zeros(0, dtype=torch.int32), 0)
    assert out.shape == (0,)


def test_segment_sum_unsupported_reasons():
    v = torch.ones(6, dtype=torch.float32)
    ids = torch.zeros(6, dtype=torch.int32)
    assert ksegsum.unsupported_reason(v, ids, 4) is None
    assert "int32" in ksegsum.unsupported_reason(v, ids.long(), 4)
    assert ksegsum.unsupported_reason(v.half(), ids, 4) is None
    assert ksegsum.unsupported_reason(v.bfloat16(), ids, 4) is None
    assert "rows" in ksegsum.unsupported_reason(v[:5], ids, 4)
    assert "rank" in ksegsum.unsupported_reason(v[None, None], ids, 4)
    assert "rank" in ksegsum.unsupported_reason(v, ids[None], 4)
    assert "32-bit" in ksegsum.unsupported_reason(v, ids, 2**31)
    with pytest.raises(fml.KernelUnsupportedError, match="not CUDA"):
        ksegsum.segment_sum(v.to("meta"), ids.to("meta"), 4)


def test_segment_sum_unsorted_refused_in_deterministic_mode():
    """The atomic path adds in a run-dependent order: under PyTorch's
    deterministic mode it is refused, naming the sorted layout."""
    v = torch.ones(6, dtype=torch.float32)
    ids = torch.zeros(6, dtype=torch.int32)
    torch.use_deterministic_algorithms(True)
    try:
        reason = ksegsum.unsupported_reason(v, ids, 4)
        assert ksegsum.unsupported_reason(v, ids, 4,
                                          indices_are_sorted=True) is None
    finally:
        torch.use_deterministic_algorithms(False)
    assert 'layout="sorted"' in reason and "deterministic" in reason


# -- topk --------------------------------------------------------------------------

NEG_NAN = np.frombuffer(np.array([0xFFF8000000000000], np.uint64).tobytes(),
                        np.float64)[0]


def _topk_rows(dtype, n=150, seed=0, signed=True):
    """Rows that pin the order: integer values (many duplicates), an
    all--inf row, a row with -inf in most places, NaN, a constant row,
    ascending and descending rows, and (``signed``) +0/-0 and -NaN."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 6, size=(8, n)).astype(dtype)
    if signed:
        x[0, ::3], x[0, 1::3] = 0.0, -0.0
    x[1] = -np.inf
    x[2, :-7] = -np.inf
    x[3, ::4] = np.nan
    if signed:
        x[3, 2::9] = NEG_NAN
    x[4] = 2.5
    x[5] = np.arange(1, n + 1)
    x[6] = -np.arange(1, n + 1)
    return x


def _same_bits(got, want) -> bool:
    return np.asarray(got).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("k", [1, 7, 128, 150, 129, 1000, "n"])
def test_top_k_plain_matches_lax_top_k(dtype, rank, k):
    """top_k_plain vs ``jax.lax.top_k`` (the JAX package's default
    backend): values and indices bit for bit, ±0 and NaN included, past
    the 128 kept pairs of the Pallas kernel and up to k = n."""
    if k == "n":
        n, k = 1000, 1000
    else:
        n = 150 if k <= 150 else k + 500
    x = _topk_rows(dtype, n=n, seed=k)
    for row in ([x] if rank == 2 else list(x)):
        want_v, want_i = jax.lax.top_k(jnp.asarray(row), k)
        got_v, got_i = ktopk.top_k(torch.from_numpy(row), k)
        assert got_i.dtype == torch.int32
        assert got_v.dtype == torch.from_numpy(row).dtype
        assert _same_bits(got_v.numpy(), want_v)
        assert _same_bits(got_i.numpy(), want_i)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 6, 128])
def test_top_k_plain_matches_pallas_away_from_signed_zeros(dtype, k):
    """top_k_plain vs ``pallas_top_k`` in interpret mode, bit for bit on
    rows without zeros or -NaN (the Pallas kernel's max ranks +0 and -0
    as equal, and -NaN as NaN)."""
    x = _topk_rows(dtype, seed=k + 1, signed=False)
    x = np.concatenate([x, np.random.default_rng(k).normal(size=(5, 150))
                        .astype(dtype)])
    want_v, want_i = pallas_top_k(jnp.asarray(x), k, interpret=True)
    got_v, got_i = ktopk.top_k(torch.from_numpy(x), k)
    assert _same_bits(got_v.numpy(), want_v)
    assert _same_bits(got_i.numpy(), want_i)


def test_top_k_signed_zero_follows_lax_top_k():
    """+0 ranks above -0 as in ``lax.top_k``; the Pallas kernel ties them
    (a fault of the reference: its docstring promises lax.top_k's order)."""
    row = np.array([0.0, -0.0, 1.0, np.nan, 1.0, -np.inf, 0.0, -0.0],
                   np.float32)
    got_v, got_i = ktopk.top_k(torch.from_numpy(row), 6)
    want_v, want_i = jax.lax.top_k(jnp.asarray(row), 6)
    assert got_i.tolist() == [3, 2, 4, 0, 6, 1] == np.asarray(want_i).tolist()
    assert _same_bits(got_v.numpy(), want_v)
    assert np.signbit(got_v.numpy()).tolist() == [False] * 5 + [True]
    _, pallas_i = pallas_top_k(jnp.asarray(row), 6, interpret=True)
    assert np.asarray(pallas_i).tolist() == [3, 2, 4, 0, 1, 6]


def test_top_k_order_keys_are_total_order():
    vals = np.array([NEG_NAN, -np.inf, -1.0, -0.0, 0.0, 1e-300, 1.0, np.inf,
                     np.nan])
    keys = ktopk.order_keys(torch.from_numpy(vals))
    assert bool(torch.all(keys[1:] > keys[:-1]))
    keys32 = ktopk.order_keys(torch.from_numpy(vals.astype(np.float32)))
    assert keys32.dtype == torch.int32
    assert bool(torch.all(keys32[1:] >= keys32[:-1]))


def test_top_k_unsupported_reasons():
    x = torch.zeros(4, 200)
    assert ktopk.unsupported_reason(x, 5) is None
    assert ktopk.unsupported_reason(x.double(), 128) is None
    assert "not supported" in ktopk.unsupported_reason(x.int(), 5)
    assert ktopk.unsupported_reason(x.half(), 5) is None
    assert ktopk.unsupported_reason(x.bfloat16(), 5) is None
    assert "outside" in ktopk.unsupported_reason(x, 0)
    assert "outside" in ktopk.unsupported_reason(x[:, :3], 4)
    assert ktopk.unsupported_reason(x, 129) is None
    assert ktopk.unsupported_reason(x, 200) is None   # k = n
    assert "rank" in ktopk.unsupported_reason(x[None], 5)
    big = torch.empty(2**31, device="meta")
    assert "32-bit" in ktopk.unsupported_reason(big, 5)
    with pytest.raises(fml.KernelUnsupportedError, match="not CUDA"):
        ktopk.top_k(torch.zeros(10, device="meta"), 3)


def test_top_k_plain_domain():
    """The plain version keeps lax.top_k's domain: any 0 <= k <= n, and
    only floating operands (the CUDA kernel takes 1 <= k <= n)."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 300)))
    v, i = ktopk.top_k(x, 300)
    assert v.shape == (3, 300) and bool(torch.all(v[:, 1:] <= v[:, :-1]))
    assert ktopk.top_k(x, 0)[0].shape == (3, 0)
    with pytest.raises(ValueError, match="outside"):
        ktopk.top_k(x, 301)
    with pytest.raises(TypeError, match="floating"):
        ktopk.top_k(torch.arange(10), 3)


@pytest.mark.parametrize("rows,n,k,dtype,want", [
    (4096, 60_000, 5, torch.float32, "scan"),      # the KNN chunk
    (4096, 60_000, 12, torch.float32, "scan"),
    (4096, 60_000, 16, torch.float32, "radix"),    # past the crossover
    (4096, 60_000, 200, torch.float32, "radix"),
    (1024, 8192, 16, torch.float32, "fused"),
    (1024, 8192, 1024, torch.float32, "fused"),
    (256, 2048, 128, torch.float32, "fused"),
    (1, 1312, 100, torch.float64, "fused"),        # an LSH query
    (1, 1_000_000, 100, torch.float64, "radix"),
    (1, 1_000_000, 20_000, torch.float64, "radix"),
    (100, 60_000, 5, torch.float32, "radix"),      # too few rows to scan
    (1, 16_384, 16_384, torch.float64, "radix"),   # the sort buffer spills
])
def test_top_k_route_rule(rows, n, k, dtype, want):
    """The fixed rule that picks the kernel's route, at the main paths'
    shapes; a long row with few rows splits into segments."""
    item = torch.empty(0, dtype=dtype).element_size()
    assert ktopk.route(rows, n, k, item) == want
    if want == "fused":
        assert ktopk.fused_smem_bytes(n, k, item) <= ktopk.FUSED_SMEM_BYTES
    assert ktopk.segments(rows, n) == (1 if rows >= ktopk.TARGET_BLOCKS
                                       else min(-(-264 // rows),
                                                n // 2048, 1024) or 1)


def test_top_k_fused_smem_bytes():
    # [256, 2048] f32, k=128: 8 KB of keys and 128 pairs of 8 bytes.
    assert ktopk.fused_smem_bytes(2048, 128, 4) == 2048 * 4 + 128 * 8
    # Keys pad to 16 bytes; the sort buffer to a power of two.
    assert ktopk.fused_smem_bytes(67, 10, 8) == 68 * 8 + 16 * 12
    assert ktopk.fused_smem_bytes(5, 1, 4) == 8 * 4 + 1 * 8
    assert set(ktopk.ROUTES) == {"fused", "scan", "radix"}


# -- build and launch bookkeeping -----------------------------------------------------

def test_build_sources_and_library_names():
    assert _build.sources() == ["chain", "segsum", "spmv", "topk"]
    path = _build._library_path("spmv")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in _build.NVCC_FLAGS


def test_build_probes_are_not_kernels():
    """The measurement probes build by the same scheme from their own
    directory and are not among the kernels' sources."""
    assert _build.probes() == ["gather_floor", "red_floor"]
    assert not set(_build.probes()) & set(_build.sources())
    assert _build._source_path("red_floor").startswith(_build.PROBE_DIR)
    assert _build._source_path("segsum").startswith(_build.CSRC_DIR)
    path = _build._library_path("red_floor")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_launch_counters_only_count_kernel_launches(on_cpu):
    assert set(fml.launch_counts()) == set(_gate.SITES) == {
        "fused_chain", "segment_sum", "spmv", "topk"}
    fml.reset_launch_counts()
    idx, val, w = (torch.from_numpy(a) for a in _ell(4, 3, 10, np.float32, 0))
    kspmv.spmv(idx, val, w)   # plain versions: not launches
    ksegsum.segment_sum(val.reshape(-1), idx.reshape(-1), 10)
    ktopk.top_k(val, 2)
    assert fml.launch_counts() == {"fused_chain": 0, "segment_sum": 0,
                                   "spmv": 0, "topk": 0}
    with pytest.raises(ValueError):
        _gate.LaunchCounter("not_a_site")


# -- bfloat16 operands (the precision tiers) ---------------------------------

def _bf16_pair(a: np.ndarray):
    """``a`` rounded to bfloat16, as a torch tensor and a JAX array holding
    the same bits. A NaN becomes the quiet NaN of its sign (0x7FC0 or
    0xFFC0): PyTorch's conversion writes 0xFFFF for every NaN."""
    f = np.ascontiguousarray(a, np.float32)
    t = torch.from_numpy(f.copy()).to(torch.bfloat16)
    bits = t.view(torch.int16)
    nan = torch.from_numpy(np.isnan(f))
    neg = torch.from_numpy(np.signbit(f))
    bits[nan & ~neg] = 0x7FC0
    bits[nan & neg] = -64  # 0xFFC0
    return t, jnp.asarray(bits.numpy()).view(jnp.bfloat16)


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _same_bf16(got, want) -> None:
    """Equal bits, but a NaN only by its sign: ``lax.top_k`` at bfloat16
    canonicalizes a NaN's payload, where the kernels return the input
    element."""
    g, w = _bf16_bits(got), _bf16_bits(want)
    gn = (g & 0x7F80) == 0x7F80
    gn &= (g & 0x7F) != 0
    wn = (w & 0x7F80) == 0x7F80
    wn &= (w & 0x7F) != 0
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(np.where(gn, g < 0, g), np.where(wn, w < 0, w))


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("shape", [(37, 9, 4096), (256, 39, 1000), (5, 1, 7)])
def test_spmv_bf16_plain_matches_jax(backend, shape, monkeypatch):
    """bfloat16 values and w: spmv_plain (float32 products and row sums,
    each sum rounded once) vs the JAX ``kernels.spmv`` (XLA, or
    ``pallas_spmv`` interpreted): a bfloat16 output within one bfloat16
    rounding of the row's float32 sum (2^-8 of its magnitude, and of the
    sum of |terms| for rows that cancel; XLA's bfloat16 ops also round each
    product and partial sum: 2^-6 of the sum of |terms|)."""
    rows, width, dim = shape
    idx, val, w = _ell(rows, width, dim, np.float32, seed=rows)
    tv, jv = _bf16_pair(val)
    tw, jw = _bf16_pair(w)
    jax_backend(monkeypatch, backend, "spmv")
    want = jax_kernels.spmv(idx, jv, jw)
    assert want.dtype == jnp.bfloat16
    got = kspmv.spmv(torch.from_numpy(idx), tv, tw)
    assert got.dtype == torch.bfloat16
    terms = np.abs(tv.float().numpy() * tw.float().numpy()[idx]).sum(1)
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert np.all(diff <= (2.0 ** -8 if backend == "pallas" else 2.0 ** -6)
                  * (terms + 1e-30))


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("sorted_ids", [False, True])
@pytest.mark.parametrize("shape", [(500, None, 97), (300, 4, 40), (7, None, 3)])
def test_segment_sum_bf16_plain_is_bitwise_jax(backend, sorted_ids, shape,
                                               monkeypatch):
    """bfloat16 values: segment_sum_plain (``index_add_``, in cell order,
    each add rounded) equals the JAX ``kernels.segment_sum`` (XLA, or
    ``pallas_segment_sum`` interpreted) bit for bit, flat and row
    payload."""
    cells, k, nseg = shape
    values, ids = _segsum_inputs(cells, k, nseg, np.float32, sorted_ids,
                                 seed=cells)
    tv, jv = _bf16_pair(values * 7.0)
    jax_backend(monkeypatch, backend, "segment_sum")
    want = jax_kernels.segment_sum(jv, ids, nseg,
                                   indices_are_sorted=sorted_ids)
    got = ksegsum.segment_sum(tv, torch.from_numpy(ids), nseg,
                              indices_are_sorted=sorted_ids)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("phase", [0, 1, 5, 7, -1])
def test_segment_sum_bf16_run_flush_is_bitwise_pallas(k, phase):
    """The CUDA run-flush at bfloat16 (its write plan with the bf16 tiles'
    8-cell phase, each run summed left to right from 0 and rounded at each
    add) equals the Pallas sorted kernel bit for bit."""
    from flinkml_tpu.kernels.segsum import pallas_segment_sum

    values, ids = _segsum_inputs(400, k, 60, np.float32, True, seed=7)
    tv, jv = _bf16_pair(values * 3.0)
    want = pallas_segment_sum(jv, ids, 60, indices_are_sorted=True,
                              interpret=True)
    v2 = tv[:, None] if tv.dim() == 1 else tv
    kk = v2.shape[1]
    group = ksegsum.phase_cells(tv)
    assert group == 8
    out = torch.full((60, kk), float("nan"), dtype=torch.bfloat16)
    plan = ksegsum.sorted_plan(ids, 60, kk, phase if kk == 1 else -1, group)
    for seg, _, first, end in plan:
        acc = torch.zeros(kk, dtype=torch.bfloat16)
        for j in range(first, end):
            acc = acc + v2[j]
        out[seg] = acc
    got = out[:, 0] if tv.dim() == 1 else out
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


def test_segment_sum_bf16_phase_and_vector_rules():
    """The sorted flat path's phase at bfloat16 aligns 8 cells of values
    (16 bytes) with their ids; the unsorted ``[cells, k]`` path reduces 2
    bfloat16 columns at a time."""
    ids = torch.zeros(64, dtype=torch.int32)
    vals = torch.zeros(64, dtype=torch.bfloat16)
    assert ksegsum.phase_cells(vals) == 8
    assert ksegsum.phase_cells(vals.float()) == 4
    for start in range(8):
        ph = kspmv.vector_phase(ids[start:], vals[start:], 8)
        assert ph == (-start) % 8
        ip, vp = ids[start:].data_ptr(), vals[start:].data_ptr()
        assert (ip + 4 * ph) % 16 == 0 and (vp + 2 * ph) % 16 == 0
    assert ksegsum.sorted_tile_bases(5000, 3, 8)[:2] == [-5, -5 + 2048]
    assert ksegsum.payload_vector(torch.zeros(10, 6, dtype=torch.bfloat16)) == 2
    assert ksegsum.payload_vector(
        torch.zeros(10, 5, dtype=torch.bfloat16)) == 1
    # spmv's bfloat16 groups of 4 cells need 8-byte aligned values.
    v = torch.zeros(64, dtype=torch.bfloat16)
    for start in range(4):
        ph = kspmv.vector_phase(ids[start:], v[start:])
        assert (v[start:].data_ptr() + 2 * ph) % 8 == 0


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("k", [1, 7, 128, 150])
def test_top_k_bf16_plain_matches_lax_top_k(rank, k):
    """bfloat16 rows: top_k_plain vs ``jax.lax.top_k`` at bfloat16, values
    and indices bit for bit (±0, NaN and -NaN included; a NaN value by its
    sign, see :func:`_same_bf16`)."""
    x, jx = _bf16_pair(_topk_rows(np.float32, n=150, seed=k))
    for row, jrow in ([(x, jx)] if rank == 2 else list(zip(x, jx))):
        want_v, want_i = jax.lax.top_k(jrow, k)
        got_v, got_i = ktopk.top_k(row, k)
        assert got_v.dtype == torch.bfloat16 and got_i.dtype == torch.int32
        _same_bf16(got_v, want_v)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("k", [1, 6, 128])
def test_top_k_bf16_plain_matches_pallas_away_from_signed_zeros(k):
    """bfloat16 rows without zeros or -NaN: top_k_plain vs ``pallas_top_k``
    in interpret mode, bit for bit."""
    rows = np.concatenate([_topk_rows(np.float32, seed=k + 1, signed=False),
                           np.random.default_rng(k).normal(size=(5, 150))])
    x, jx = _bf16_pair(rows)
    want_v, want_i = pallas_top_k(jx, k, interpret=True)
    got_v, got_i = ktopk.top_k(x, k)
    _same_bf16(got_v, want_v)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_top_k_bf16_routes_by_float32_keys():
    """A bfloat16 row ranks by float32 keys on the card, so the route rule
    sizes its shared memory with 4-byte keys."""
    assert ktopk.key_bytes(torch.bfloat16) == 4
    assert ktopk.key_bytes(torch.float64) == 8
    assert ktopk.route(4096, 60000, 5, ktopk.key_bytes(torch.bfloat16)) \
        == ktopk.route(4096, 60000, 5, 4)
