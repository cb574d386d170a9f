"""Multinomial LogisticRegression in the port against the JAX package, on
the CPU: the softmax trainer (one step and the whole loop, early
termination included) against ``train_softmax_model`` on a one-device
mesh, the estimator end to end, the dense and sparse ``transform``, the
multinomial head of the fused chain against the JAX chain function (XLA,
and the Pallas chain kernel interpreted), and save/load of the ``[k, d]``
model across the packages.

Declared tolerances (coefficients are O(0.1–1)): float64 fits 1e-10
absolute, float32 fits 1e-5 (the products and sums add in another order
in XLA and PyTorch's CPU kernels); rawPrediction 1e-10 (float64), 1e-5
(float32) and sparse 1e-5 (float32 margins); predictions equal wherever
the two largest logits differ by more than 1e-9 (1e-4 in float32).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.io import read_write as jax_rw
from flinkml_tpu.linalg import SparseVector as JaxSparseVector
from flinkml_tpu.models import _linear_sgd as jax_sgd
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models import scalers as jax_scalers
from flinkml_tpu.ops import sparse as jax_sparse
from flinkml_tpu.parallel import DeviceMesh
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.models import _linear_sgd as t_sgd
from flinkml_tpu_torch.ops import sparse as t_sparse
from tests._torch_port_common import (  # noqa: F401
    F32_ATOL,
    F32_RTOL,
    F64_RAW_RTOL,
    F64_SCALER_RTOL,
    JAX_BACKENDS,
    SPARSE_TOL,
    jax_backend,
    jax_chain_cols,
    on_cpu,
    port_chain_cols,
    port_stage_like,
)
from tests.test_torch_fit import EpochRecorder, sparse_rows

F64_FIT_TOL = 1e-10
F32_FIT_TOL = 1e-5
K = 4


@pytest.fixture(scope="module")
def mesh1():
    return DeviceMesh(devices=jax.devices()[:1])


def softmax_data(n=240, d=5, k=K, seed=0):
    """Planted classes 0..k-1 (every class present) with label noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
    scores = x @ rng.normal(size=(d, k)) + 0.5 * rng.normal(size=(n, k))
    y = np.argmax(scores, axis=1).astype(np.float64)
    y[:k] = np.arange(k)
    w = rng.uniform(0.5, 2.0, size=n)
    return x, y, w


def _decisive(logits, eps):
    top2 = np.sort(logits, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > eps


@pytest.mark.parametrize("dtype,tol_fit", [(np.float64, F64_FIT_TOL),
                                           (np.float32, F32_FIT_TOL)])
@pytest.mark.parametrize("tol", [0.0, 0.9])
@pytest.mark.parametrize("reg,elastic_net", [(0.0, 0.0), (0.02, 0.5)])
def test_train_softmax_model_matches_jax(dtype, tol_fit, tol, reg,
                                         elastic_net, mesh1, on_cpu):
    """The whole-loop softmax trainer against JAX's on one device, with
    rotating windows (batch 64 of 240 rows), L2 and the L1 soft-threshold;
    ``tol`` 0.9 stops both at the same epoch."""
    x, y, w = softmax_data()
    kw = dict(num_classes=K, max_iter=40, learning_rate=0.5,
              global_batch_size=64, reg=reg, elastic_net=elastic_net,
              tol=tol, seed=3)
    lj, lt = EpochRecorder(), EpochRecorder()
    want = jax_sgd.train_softmax_model(x.astype(dtype), y, w, mesh=mesh1,
                                       listeners=[lj], **kw)
    got = t_sgd.train_softmax_model(x.astype(dtype), y, w, listeners=[lt],
                                    **kw)
    assert got.shape == want.shape == (K, x.shape[1])
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=tol_fit, atol=tol_fit)
    assert lt.epoch == lj.epoch
    assert (lt.epoch < 39) == (tol > 0)
    np.testing.assert_array_equal(lt.terminated, got)


def test_softmax_step_matches_jax(mesh1, on_cpu):
    """One softmax step (window 1 of a batch of 50) in float64."""
    from jax.sharding import PartitionSpec as P

    x, y, w = softmax_data(n=120, seed=2)
    coef = np.random.default_rng(3).normal(size=(K, x.shape[1])) * 0.1
    args = (np.float64(0.3), np.float64(0.01), np.float64(0.002))
    jstep = jax_sgd.make_softmax_step(K, 50, DeviceMesh.DATA_AXIS)
    run = jax.jit(jax.shard_map(
        lambda c, xl, yl, wl, *h: jstep(c, 1, xl, yl, wl, *h),
        mesh=mesh1.mesh, in_specs=(P(),) + (P(DeviceMesh.DATA_AXIS),) * 3
        + (P(),) * 3, out_specs=(P(), P()), check_vma=False))
    want_c, want_l = run(coef, x, y, w, *args)
    tstep = t_sgd.make_softmax_step(K, 50)
    got_c, got_l = tstep(torch.from_numpy(coef), 1, torch.from_numpy(x),
                         torch.from_numpy(y), torch.from_numpy(w),
                         *(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-12)


@pytest.mark.parametrize("multi_class", ["auto", "multinomial"])
def test_fit_multinomial_matches_jax(multi_class, mesh1, on_cpu):
    """The estimator end to end: ``multiClass`` auto (four classes) or
    multinomial, the same [k, d] model and the same predictions."""
    x, y, w = softmax_data(seed=4)
    cols = {"features": x, "label": y, "weight": w}
    j, t = jax_lr.LogisticRegression(), fml.LogisticRegression()
    for m in (j, t):
        (m.set_seed(5).set_global_batch_size(80).set_learning_rate(0.4)
         .set_reg(0.01).set_max_iter(25).set_weight_col("weight")
         .set_multi_class(multi_class))
    j.mesh = mesh1
    want = j.fit(JaxTable(cols))
    got = t.fit(fml.Table(cols))
    assert got.coefficient.shape == (K, x.shape[1])
    np.testing.assert_allclose(got.coefficient, want.coefficient,
                               rtol=F64_FIT_TOL, atol=F64_FIT_TOL)
    (tj,) = want.transform(JaxTable({"features": x}))
    (tt,) = got.transform(fml.Table({"features": x}))
    np.testing.assert_array_equal(tt.column("prediction"),
                                  tj.column("prediction"))


def _models(d=5, k=K, seed=6):
    coef = np.random.default_rng(seed).normal(size=(k, d))
    jm = jax_lr.LogisticRegressionModel()
    jm.set_model_data(JaxTable({"coefficient": coef[None]}))
    return jm, port_stage_like(jm), coef


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_transform_matches_jax(dtype, on_cpu):
    """Per-stage dense transform: softmax rawPrediction [n, k] and argmax
    prediction. The port scores a float32 column in float32, the JAX
    package (under x64) in float64: hence the float32 tolerance."""
    jm, tm, coef = _models()
    x, _, _ = softmax_data(n=100, seed=7)
    x = x.astype(dtype)
    (jo,) = jm.transform(JaxTable({"features": x}))
    (to,) = tm.transform(fml.Table({"features": x}))
    raw, pred = to.column("rawPrediction"), to.column("prediction")
    assert raw.shape == (100, K) and raw.dtype == dtype
    rtol, atol = (F64_RAW_RTOL, F64_RAW_RTOL) if dtype == np.float64 \
        else (F32_RTOL, F32_ATOL)
    np.testing.assert_allclose(raw, jo.column("rawPrediction"), rtol=rtol,
                               atol=atol)
    decisive = _decisive(x.astype(np.float64) @ coef.T,
                         1e-9 if dtype == np.float64 else 1e-4)
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(pred[decisive],
                                  np.asarray(jo.column("prediction"))[decisive])


def test_dense_transform_ties_and_nan(on_cpu):
    """Ties take the first class and a NaN logit row predicts its first
    NaN class, in both packages."""
    coef = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    jm, tm = jax_lr.LogisticRegressionModel(), fml.LogisticRegressionModel()
    for m, tab in ((jm, JaxTable), (tm, fml.Table)):
        m.set_model_data(tab({"coefficient": coef[None]}))
    x = np.array([[2.0, 1.0], [1.0, 1.0], [np.nan, 0.0], [0.0, 3.0]])
    (jo,) = jm.transform(JaxTable({"features": x}))
    (to,) = tm.transform(fml.Table({"features": x}))
    np.testing.assert_array_equal(to.column("prediction"),
                                  jo.column("prediction"))
    np.testing.assert_array_equal(to.column("prediction"), [0, 0, 0, 2])
    np.testing.assert_allclose(to.column("rawPrediction"),
                               jo.column("rawPrediction"), rtol=1e-12,
                               atol=1e-12)


def _sparse_data(n=200, dim=400, seed=8):
    rng = np.random.default_rng(seed)
    nnz = rng.integers(1, 15, size=n)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = np.concatenate(
        [np.sort(rng.choice(dim, k, replace=False)) for k in nnz]
    ).astype(np.int32)
    values = rng.normal(size=indptr[-1]).astype(np.float32)
    return indptr, indices, values, dim


def test_sparse_transform_matches_jax(on_cpu, monkeypatch):
    """SparseVector rows through a [k, d] model: margins [n, k] in float32
    (the gathered product, several buckets and scoring chunks), the
    softmax tail in float64 on the host."""
    indptr, indices, values, dim = _sparse_data()
    jm, tm, coef = _models(d=dim)
    monkeypatch.setattr(t_sparse, "_SCORING_CHUNK_ELEMS", 256)
    jrows = sparse_rows(indptr, indices, values, dim, JaxSparseVector)
    trows = sparse_rows(indptr, indices, values, dim, fml.SparseVector)
    want_m = jax_sparse.sparse_margins(jrows, coef)
    got_m = t_sparse.sparse_margins(trows, coef)
    assert got_m.shape == want_m.shape == (trows.size, K)
    np.testing.assert_allclose(got_m, want_m, rtol=SPARSE_TOL, atol=SPARSE_TOL)
    (jo,) = jm.transform(JaxTable({"features": jrows}))
    (to,) = tm.transform(fml.Table({"features": trows}))
    np.testing.assert_allclose(to.column("rawPrediction"),
                               jo.column("rawPrediction"), rtol=SPARSE_TOL,
                               atol=SPARSE_TOL)
    decisive = _decisive(want_m.astype(np.float64), 1e-4)
    np.testing.assert_array_equal(
        to.column("prediction")[decisive],
        np.asarray(jo.column("prediction"))[decisive])


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("with_scaler", [False, True])
def test_multinomial_chain_matches_jax(backend, with_scaler, monkeypatch,
                                       on_cpu):
    """The multinomial head alone and after a MinMaxScaler: the port's
    plain chain against the JAX chain function."""
    x, _, _ = softmax_data(n=90, seed=9)
    jm, _, coef = _models()
    stages = []
    if with_scaler:
        sc = jax_scalers.MinMaxScaler().set_input_col("features") \
            .set_output_col("mm").fit(JaxTable({"features": x}))
        stages.append(sc)
        jm.set_features_col("mm")
    stages.append(jm)
    jax_backend(monkeypatch, backend, "fused_chain")
    want = jax_chain_cols([s.transform_kernel() for s in stages],
                          {"features": x}, backend)
    got = port_chain_cols([port_stage_like(s).transform_kernel()
                           for s in stages], {"features": x})
    if with_scaler:
        np.testing.assert_allclose(got["mm"], want["mm"],
                                   rtol=F64_SCALER_RTOL, atol=F64_SCALER_RTOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL)
    feats = want["mm"] if with_scaler else x
    decisive = _decisive(feats @ coef.T, 1e-9)
    np.testing.assert_array_equal(got["prediction"][decisive],
                                  want["prediction"][decisive])
    assert got["prediction"].dtype == want["prediction"].dtype


def test_multinomial_save_load_across_packages(tmp_path, on_cpu):
    jm, tm, coef = _models()
    jm.save(str(tmp_path / "j"))
    tm.save(str(tmp_path / "t"))
    from_jax = fml.load_stage(str(tmp_path / "j"))
    from_port = jax_rw.load_stage(str(tmp_path / "t"))
    np.testing.assert_array_equal(from_jax.coefficient, coef)
    np.testing.assert_array_equal(from_port.coefficient, coef)
    x, _, _ = softmax_data(n=20)
    (a,) = from_jax.transform(fml.Table({"features": x}))
    (b,) = from_port.transform(JaxTable({"features": x}))
    np.testing.assert_allclose(a.column("rawPrediction"),
                               b.column("rawPrediction"), rtol=F64_RAW_RTOL,
                               atol=F64_RAW_RTOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_served_multinomial_rows_answer_as_alone(dtype, on_cpu):
    """A multinomial model served through a ServingEngine on the CPU
    answers 1, 7, 33 and 130 rows bit for bit as it answers each row alone
    (the head's logits are row sums, its exp runs over whole vector
    blocks), and the served head agrees with JAX's multinomial transform
    within the declared tolerances."""
    from flinkml_tpu_torch.serving import ServingConfig, ServingEngine

    d, k = 37, 6
    jm, tm, coef = _models(d=d, k=k, seed=11)
    x = np.random.default_rng(12).normal(size=(130, d)).astype(dtype)
    engine = ServingEngine(
        tm, fml.Table({"features": x[:4]}),
        ServingConfig(max_batch_rows=256, max_wait_ms=0.0),
        output_cols=("prediction", "rawPrediction"), name="multinomial",
    ).start()
    try:
        alone = [engine.predict({"features": x[i]}) for i in range(130)]
        (jo,) = jm.transform(JaxTable({"features": x}))
        for n in (1, 7, 33, 130):
            served = engine.predict({"features": x[:n]})
            for col in ("prediction", "rawPrediction"):
                np.testing.assert_array_equal(
                    served.column(col),
                    np.concatenate([a.column(col) for a in alone[:n]]))
        rtol, atol = (F64_RAW_RTOL, F64_RAW_RTOL) if dtype == np.float64 \
            else (F32_RTOL, F32_ATOL)
        np.testing.assert_allclose(served.column("rawPrediction"),
                                   jo.column("rawPrediction"), rtol=rtol,
                                   atol=atol)
        decisive = _decisive(x.astype(np.float64) @ coef.T,
                             1e-9 if dtype == np.float64 else 1e-4)
        np.testing.assert_array_equal(
            served.column("prediction")[decisive],
            np.asarray(jo.column("prediction"))[decisive])
    finally:
        engine.stop()
