"""The port's models and executor against the JAX package: each scaler's
``fit`` and per-stage ``transform``, LogisticRegressionModel's dense and
sparse ``transform`` (sparse through ``spmv``, against the JAX function
run through XLA and through ``pallas_spmv`` interpreted), and the whole
five-stage ``PipelineModel.transform``, fused and per-stage."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.linalg import SparseVector as JaxSparseVector
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models import scalers as jax_scalers
from flinkml_tpu.ops import sparse as jax_sparse
from flinkml_tpu.pipeline import Pipeline as JaxPipeline
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.models import scalers as torch_scalers
from flinkml_tpu_torch.ops import sparse as torch_sparse
from tests._torch_port_common import (  # noqa: F401
    F32_ATOL,
    F32_RTOL,
    F64_RAW_RTOL,
    F64_SCALER_RTOL,
    JAX_BACKENDS,
    SCALER_NAMES,
    SPARSE_TOL,
    assert_lr_outputs_close,
    dense_data,
    five_stage_pair,
    jax_backend,
    jax_chain,
    jax_per_stage,
    on_cpu,
    outputs,
    port_stage_like,
)

#: Fit statistics are float32 sums in both packages, in another order.
FIT_RTOL, FIT_ATOL = 1e-5, 1e-6


# -- scalers ----------------------------------------------------------------------

@pytest.mark.parametrize("name", SCALER_NAMES)
def test_scaler_fit_matches_jax(name, on_cpu):
    x, _ = dense_data(rows=400, d=5, seed=11)
    j = getattr(jax_scalers, name)().set_input_col("features")
    t = getattr(torch_scalers, name)().set_input_col("features")
    jm = j.fit(JaxTable({"features": x}))
    tm = t.fit(fml.Table({"features": x}))
    assert type(tm).__name__ == type(jm).__name__
    want = jm.get_model_data()[0]
    got = tm.get_model_data()[0]
    assert got.column_names == want.column_names
    for c in want.column_names:
        w, g = np.asarray(want.column(c)), got.column(c)
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
        if name in ("MinMaxScaler", "MaxAbsScaler", "RobustScaler"):
            # Extrema of the same float32 values, exact quantiles.
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=FIT_RTOL, atol=FIT_ATOL)


def test_scaler_fit_options_match_jax(on_cpu):
    x, _ = dense_data(rows=200, d=4, seed=12)
    pairs = [
        (jax_scalers.MinMaxScaler().set_min(-2.0).set_max(3.0),
         torch_scalers.MinMaxScaler().set_min(-2.0).set_max(3.0)),
        (jax_scalers.RobustScaler().set_lower(0.1).set_upper(0.8)
         .set_with_centering(True),
         torch_scalers.RobustScaler().set_lower(0.1).set_upper(0.8)
         .set_with_centering(True)),
        (jax_scalers.StandardScaler().set_with_mean(False),
         torch_scalers.StandardScaler().set_with_mean(False)),
    ]
    for j, t in pairs:
        j.set_input_col("features")
        t.set_input_col("features")
        (want,) = j.fit(JaxTable({"features": x})).transform(
            JaxTable({"features": x}))
        (got,) = t.fit(fml.Table({"features": x})).transform(
            fml.Table({"features": x}))
        np.testing.assert_allclose(got.column("output"),
                                   want.column("output"), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="min"):
        torch_scalers.MinMaxScaler().set_min(1.0).set_max(0.0).fit(
            fml.Table({"input": x}))


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
@pytest.mark.parametrize("name", SCALER_NAMES)
def test_scaler_transform_matches_jax(name, dtype, on_cpu):
    """Per-stage transform on the same model data: float64 at rtol 1e-12,
    float32 at the float32 tolerance, integer input promoted to
    float64 in both."""
    x, _ = dense_data(rows=150, d=5, seed=13)
    jm = getattr(jax_scalers, name)().set_input_col("features").fit(
        JaxTable({"features": x}))
    tm = port_stage_like(jm)
    xin = (x * 10).astype(dtype)
    (want,) = jm.transform(JaxTable({"features": xin}))
    (got,) = tm.transform(fml.Table({"features": xin}))
    w, g = np.asarray(want.column("output")), got.column("output")
    assert g.dtype == w.dtype
    if g.dtype == np.float32:
        np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(g, w, rtol=F64_SCALER_RTOL,
                                   atol=F64_SCALER_RTOL)


def test_scaler_1d_column_and_fused_equals_per_stage(on_cpu):
    x = np.linspace(-3.0, 5.0, 40)
    st = torch_scalers.StandardScaler().set_input_col("x").set_output_col(
        "y").fit(fml.Table({"x": x}))
    mm = torch_scalers.MinMaxScaler().set_input_col("y").set_output_col(
        "z").fit(fml.Table({"x": x, "y": st.transform(
            fml.Table({"x": x}))[0].column("y")}))
    model = fml.PipelineModel([st, mm])
    (fused,) = model.transform(fml.Table({"x": x}))
    pipeline_fusion.set_enabled(False)
    try:
        (per_stage,) = model.transform(fml.Table({"x": x}))
    finally:
        pipeline_fusion.set_enabled(True)
    assert fused.column("z").shape == (40, 1)
    np.testing.assert_array_equal(fused.column("z"), per_stage.column("z"))


# -- logistic regression ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lr_dense_transform_matches_jax(dtype, on_cpu):
    x, coef = dense_data(rows=250, d=7, seed=14)
    jm = jax_lr.LogisticRegressionModel().set_model_data(
        JaxTable({"coefficient": coef[None]}))
    tm = port_stage_like(jm)
    (want,) = jm.transform(JaxTable({"features": x.astype(dtype)}))
    (got,) = tm.transform(fml.Table({"features": x.astype(dtype)}))
    got = outputs(got, ("prediction", "rawPrediction"))
    want = outputs(want, ("prediction", "rawPrediction"))
    assert got["rawPrediction"].dtype == dtype
    assert_lr_outputs_close(got, want, x @ coef, f64=dtype == np.float64)


def _sparse_rows(n, dim, seed, skew=True):
    rng = np.random.default_rng(seed)
    rows_t, rows_j = [], []
    for _ in range(n):
        k = int(rng.integers(1, 40 if skew else 8))
        idx = rng.choice(dim, size=k, replace=False)
        val = rng.normal(size=k)
        rows_t.append(fml.SparseVector(dim, idx, val))
        rows_j.append(JaxSparseVector(dim, idx, val))
    col = np.empty(n, dtype=object)
    col[:] = rows_t
    jcol = np.empty(n, dtype=object)
    jcol[:] = rows_j
    return col, jcol


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_sparse_margins_match_jax(backend, monkeypatch, on_cpu):
    """Bucketed ELL margins through spmv vs the JAX sparse_margins (XLA,
    or pallas_spmv interpreted), skewed nnz over several buckets."""
    col, jcol = _sparse_rows(300, 4096, seed=15)
    coef = np.random.default_rng(16).normal(size=4096)
    jax_backend(monkeypatch, backend, "spmv")
    want = jax_sparse.sparse_margins(jcol, coef)
    got = torch_sparse.sparse_margins(col, coef)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SPARSE_TOL, atol=SPARSE_TOL)
    buckets, _ = torch_sparse.pack_ell_buckets(
        *torch_sparse.csr_from_sparse_vectors(col))
    assert len(buckets) > 1


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_lr_sparse_transform_matches_jax(backend, monkeypatch, on_cpu):
    col, jcol = _sparse_rows(200, 2048, seed=17)
    coef = np.random.default_rng(18).normal(size=2048)
    jm = jax_lr.LogisticRegressionModel().set_model_data(
        JaxTable({"coefficient": coef[None]}))
    tm = port_stage_like(jm)
    jax_backend(monkeypatch, backend, "spmv")
    (want,) = jm.transform(JaxTable({"features": jcol}))
    (got,) = tm.transform(fml.Table({"features": col}))
    w_raw, g_raw = np.asarray(want.column("rawPrediction")), \
        got.column("rawPrediction")
    assert g_raw.dtype == w_raw.dtype and g_raw.shape == (200, 2)
    np.testing.assert_allclose(g_raw, w_raw, rtol=SPARSE_TOL, atol=SPARSE_TOL)
    dense = np.stack([v.to_array() for v in col]) @ coef
    decisive = np.abs(dense) > 1e-4
    np.testing.assert_array_equal(got.column("prediction")[decisive],
                                  np.asarray(want.column("prediction"))[decisive])


def test_sparse_chunking_and_index_check(monkeypatch, on_cpu):
    col, _ = _sparse_rows(100, 512, seed=19, skew=False)
    coef = np.random.default_rng(20).normal(size=512)
    whole = torch_sparse.sparse_margins(col, coef)
    monkeypatch.setattr(torch_sparse, "_SCORING_CHUNK_ELEMS", 64)
    np.testing.assert_array_equal(torch_sparse.sparse_margins(col, coef), whole)
    indptr, indices, values, dim = torch_sparse.csr_from_sparse_vectors(col)
    indices[3] = dim
    with pytest.raises(ValueError, match="out of range"):
        torch_sparse.pack_ell_buckets(indptr, indices, values, dim)
    with pytest.raises(ValueError, match="dim"):
        torch_sparse.sparse_margins(col, coef[:-1])
    with pytest.raises(NotImplementedError, match="multinomial"):
        torch_sparse.sparse_margins(col, np.ones((3, 512)))


def test_ell_packing_matches_jax():
    col, jcol = _sparse_rows(120, 1000, seed=21)
    t = torch_sparse.csr_from_sparse_vectors(col)
    j = jax_sparse.csr_from_sparse_vectors(jcol)
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_array_equal(a, b)
    nnz = np.diff(t[0])
    assert torch_sparse.choose_ell_widths(nnz) == jax_sparse.choose_ell_widths(nnz)
    tb, tr = torch_sparse.pack_ell_buckets(*t)
    jb, jr = jax_sparse.pack_ell_buckets(*j)
    for x, y in zip(tb, jb):
        np.testing.assert_array_equal(x["indices"], y["indices"])
        np.testing.assert_array_equal(x["values"], y["values"])
    for x, y in zip(tr, jr):
        np.testing.assert_array_equal(x, y)


# -- the five-stage pipeline ------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rows", [6, 100, 300])
def test_five_stage_pipeline_matches_jax_per_stage(fused, rows, on_cpu):
    x, coef = dense_data(rows=300, seed=22)
    jax_model, port = five_stage_pair(x, coef)
    x = x[:rows]
    want = jax_per_stage(jax_model, x)
    pipeline_fusion.set_enabled(fused)
    try:
        (out,) = port.transform(fml.Table({"features": x}))
    finally:
        pipeline_fusion.set_enabled(True)
    got = outputs(out)
    for c in ("s1", "s2", "s3", "s4"):
        assert got[c].dtype == want[c].dtype
        np.testing.assert_allclose(got[c], want[c], rtol=F64_SCALER_RTOL,
                                   atol=F64_SCALER_RTOL)
    assert_lr_outputs_close(got, want, want["s4"] @ coef)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_five_stage_pipeline_matches_jax_fused_chain(backend, on_cpu):
    """The port's fused transform vs the JAX package's fused chain
    function (XLA, and the Pallas chain kernel interpreted)."""
    x, coef = dense_data(rows=200, seed=23)
    jax_model, port = five_stage_pair(x, coef)
    want = jax_chain(jax_model, x, backend)
    (out,) = port.transform(fml.Table({"features": x}))
    got = outputs(out)
    for c in ("s1", "s2", "s3", "s4"):
        np.testing.assert_allclose(got[c], want[c], rtol=F64_SCALER_RTOL,
                                   atol=F64_SCALER_RTOL)
    assert_lr_outputs_close(got, want, want["s4"] @ coef)


def test_fused_outputs_are_lazy_and_programs_reused(on_cpu):
    x, coef = dense_data(rows=100, seed=24)
    _, port = five_stage_pair(x, coef)
    pipeline_fusion.reset_cache()
    (out,) = port.transform(fml.Table({"features": x[:40]}))
    from flinkml_tpu_torch.table import LazyDeviceColumn, PaddedDeviceColumn

    raw = out._raw_column
    assert isinstance(raw("s2"), LazyDeviceColumn) and raw("s2")._buf is None
    assert type(raw("s4")) is PaddedDeviceColumn
    assert pipeline_fusion.compiled_program_count() == 1
    out.column("s2")
    assert pipeline_fusion.compiled_program_count() == 2
    # Another row count in the same bucket (64) reuses both programs.
    (out2,) = port.transform(fml.Table({"features": x[:60]}))
    out2.column("s2")
    assert pipeline_fusion.compiled_program_count() == 2
    assert pipeline_fusion.row_bucket(60) == 64
    assert pipeline_fusion.row_bucket(3) == pipeline_fusion.MIN_ROW_BUCKET


def test_port_pipeline_fit_matches_jax(on_cpu):
    """Pipeline.fit of the four scalers in the port vs the JAX package,
    then the same transform."""
    x, _ = dense_data(rows=300, seed=25)
    def stages(mod):
        out, prev = [], "features"
        for i, name in enumerate(SCALER_NAMES, start=1):
            cls = getattr(mod, name)
            out.append(cls().set(cls.INPUT_COL, prev)
                       .set(cls.OUTPUT_COL, f"s{i}"))
            prev = f"s{i}"
        return out

    jm = JaxPipeline(stages(jax_scalers)).fit(JaxTable({"features": x}))
    tm = fml.Pipeline(stages(torch_scalers)).fit(fml.Table({"features": x}))
    for js, ts in zip(jm.stages, tm.stages):
        for c in js.get_model_data()[0].column_names:
            np.testing.assert_allclose(
                ts.get_model_data()[0].column(c),
                np.asarray(js.get_model_data()[0].column(c)),
                rtol=FIT_RTOL, atol=FIT_ATOL)


def test_lr_model_requires_data_and_checks_dim(on_cpu):
    m = fml.LogisticRegressionModel()
    assert m.transform_kernel() is None
    with pytest.raises(ValueError, match="Model data"):
        m.transform(fml.Table({"features": np.ones((2, 3))}))
    m.set_model_data(fml.Table({"coefficient": np.ones((1, 3))}))
    with pytest.raises(RuntimeError):
        m.transform(fml.Table({"features": np.ones((2, 4))}))
    (out,) = m.transform(fml.Table({"features": np.ones((2, 3),
                                                        dtype=np.int32)}))
    assert out.column("rawPrediction").dtype == np.float64
    assert isinstance(out.device_column("prediction"), torch.Tensor)
