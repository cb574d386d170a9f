"""The port's data-parallel in-RAM fits on a mesh against the JAX
package's, on the CPU.

The port fits on P = 2 and 4 gloo ranks (one process each; one launch per
P runs every case, ``tests/_torch_mesh_worker.py fits``, under its own
timeout), JAX on a P-device mesh of the conftest's 8 CPU devices, from the
same seeded numpy data: dense binomial LR in float64 and float32 (and with
``tol`` stopping both at the same epoch, and ``mode="host"``), sparse LR in
the ``unsorted``, ``sorted`` and ``cumsum`` layouts, multinomial LR, the
LR, LinearSVC (dense and sparse), LinearRegression (SGD and the normal
equations), KMeans and BisectingKMeans estimators, each model's sharded
``transform``, and a checkpointed fit stopped and resumed at the same
world. Each output is held twice:

- every rank has the same bits (the ring all-reduce gives every rank the
  same sum, and every rank applies the same update);
- JAX's result within 1e-10 (float64) or 1e-5 (float32, and the float32
  sparse fits), absolute: gloo sums a step's gradient in its own order,
  not XLA's ``psum`` order, and the products add in PyTorch's CPU order.

The sorted layout is bit for bit with JAX's kernel order only on the card
at world 1; at world P its per-device window tables are JAX's, bit for
bit (``test_window_tables_match_jax``), and the fit agrees within 1e-5.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.linalg import SparseVector as JaxSparseVector
from flinkml_tpu.models import _linear_sgd as jax_sgd
from flinkml_tpu.models import bisecting_kmeans as jax_bkm
from flinkml_tpu.models import kmeans as jax_kmeans
from flinkml_tpu.models import linear_regression as jax_linreg
from flinkml_tpu.models import linear_svc as jax_svc
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.parallel import DeviceMesh as JaxMesh
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.iteration import CheckpointManager, RescaleError
from flinkml_tpu_torch.models import _linear_sgd as t_sgd
from tests import _torch_mesh_worker as worker
from tests._torch_port_common import on_cpu  # noqa: F401
from tests.test_torch_parallel import WORLDS, launch

F64_TOL, F32_TOL = 1e-10, 1e-5
LAYOUT_ENV = "FLINKML_TPU_SPARSE_LAYOUT"


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    workdir = str(tmp_path_factory.mktemp(f"fits{world}"))
    return world, workdir, launch("fits", world, workdir)


def _jax_sparse_rows(indptr, indices, values, dim):
    rows = np.empty(indptr.size - 1, dtype=object)
    for r in range(rows.size):
        lo, hi = indptr[r], indptr[r + 1]
        rows[r] = JaxSparseVector(dim, indices[lo:hi].astype(np.int64),
                                  values[lo:hi].astype(np.float64))
    return rows


def _configure(est, params):
    for key, value in params.items():
        est = getattr(est, f"set_{key}")(value)
    return est


def jax_reference(world: int, port: dict) -> dict:
    """JAX's value of every case on a ``world``-device mesh. The models'
    transforms score with the port's rank-0 coefficients, so they hold
    the transform alone."""
    jm = JaxMesh({"data": world}, jax.devices()[:world])
    old = os.environ.get(LAYOUT_ENV)
    out = {}
    try:
        x, y, w = worker.dense_lr_data()
        out["lr_dense_f64"] = jax_sgd.train_linear_model(
            x, y, w, "logistic", jm, **worker.DENSE_KW)
        out["lr_dense_f32"] = jax_sgd.train_linear_model(
            x, y, w, "logistic", jm, dtype=np.float32, **worker.DENSE_KW)
        ep = worker.Epochs()
        out["lr_dense_tol"] = jax_sgd.train_linear_model(
            x, y, w, "logistic", jm, listeners=[ep], **worker.TOL_KW)
        out["lr_dense_tol_epoch"] = np.asarray([ep.epoch])
        # mode="host" takes the device fit's steps.
        out["lr_host_mode"] = out["lr_dense_f64"]
        csr = worker.sparse_lr_data()
        for layout in worker.LAYOUTS:
            os.environ[LAYOUT_ENV] = layout
            out[f"lr_sparse_{layout}"] = jax_sgd.train_linear_model_sparse_csr(
                *csr[:6], "logistic", jm, **worker.SPARSE_KW)
        os.environ[LAYOUT_ENV] = "unsorted"
        xs, ys, ws = worker.softmax_data()
        out["lr_multinomial"] = jax_sgd.train_softmax_model(
            xs, ys, ws, 3, jm, **worker.SOFTMAX_KW)

        out["lr_estimator"] = (jax_lr.LogisticRegression(mesh=jm).set_seed(3)
                               .set_max_iter(10)
                               .fit(JaxTable({"features": x, "label": y}))
                               .coefficient)
        xt = worker.transform_rows(x.shape[1])
        model = jax_lr.LogisticRegressionModel(mesh=jm).set_model_data(
            JaxTable({"coefficient": port["lr_estimator"][None]}))
        (t,) = model.transform(JaxTable({"features": xt}))
        out["lr_transform_pred"] = np.asarray(t.column("prediction"))
        out["lr_transform_raw"] = np.asarray(t.column("rawPrediction"))
        out["lr_multinomial_estimator"] = (
            jax_lr.LogisticRegression(mesh=jm).set_multi_class("multinomial")
            .set_seed(2).set_max_iter(8)
            .fit(JaxTable({"features": xs, "label": ys})).coefficient)
        model = jax_lr.LogisticRegressionModel(mesh=jm).set_model_data(
            JaxTable({"coefficient": port["lr_multinomial_estimator"][None]}))
        (t,) = model.transform(JaxTable({"features": worker.transform_rows(4)}))
        out["lr_multinomial_transform_pred"] = np.asarray(t.column("prediction"))
        out["lr_multinomial_transform_raw"] = np.asarray(
            t.column("rawPrediction"))
        sparse_table = JaxTable({"features": _jax_sparse_rows(*csr[:4]),
                                 "label": csr[4]})
        out["lr_sparse_estimator"] = (jax_lr.LogisticRegression(mesh=jm)
                                      .set_seed(5).set_max_iter(6)
                                      .fit(sparse_table).coefficient)

        out["svc"] = _configure(jax_svc.LinearSVC(mesh=jm), worker.SVC_PARAMS) \
            .fit(JaxTable({"features": x, "label": y})).coefficient
        svc_model = jax_svc.LinearSVCModel().set_model_data(
            JaxTable({"coefficient": port["svc"][None]}))
        (t,) = svc_model.transform(JaxTable({"features": xt}))
        out["svc_transform_raw"] = np.asarray(t.column("rawPrediction"))
        out["svc_transform_pred"] = np.asarray(t.column("prediction"))
        out["svc_sparse"] = _configure(jax_svc.LinearSVC(mesh=jm),
                                       worker.SVC_PARAMS).fit(
            sparse_table).coefficient
        yr = x @ np.arange(1.0, x.shape[1] + 1.0) \
            + 0.1 * np.cos(np.arange(len(x)))
        out["linreg"] = _configure(jax_linreg.LinearRegression(mesh=jm),
                                   worker.LINREG_PARAMS).fit(
            JaxTable({"features": x, "label": yr})).coefficient
        reg_model = jax_linreg.LinearRegressionModel().set_model_data(
            JaxTable({"coefficient": port["linreg"][None]}))
        (t,) = reg_model.transform(JaxTable({"features": xt}))
        out["linreg_transform"] = np.asarray(t.column("prediction"))
        out["linreg_normal"] = (jax_linreg.LinearRegression(mesh=jm)
                                .set_solver("normal").set_reg(0.02)
                                .fit(JaxTable({"features": x, "label": yr}))
                                .coefficient)
        xb = worker.blobs()
        out["kmeans"] = _configure(jax_kmeans.KMeans(mesh=jm),
                                   worker.KMEANS_PARAMS).fit(
            JaxTable({"features": xb})).centroids
        km_model = jax_kmeans.KMeansModel().set_model_data(
            JaxTable({"centroids": port["kmeans"][None]}))
        (t,) = km_model.transform(
            JaxTable({"features": worker.transform_rows(4) * 6.0}))
        out["kmeans_transform"] = np.asarray(t.column("prediction"))
        out["bisecting"] = (jax_bkm.BisectingKMeans(mesh=jm).set_k(3)
                            .set_seed(1).set_max_iter(8)
                            .fit(JaxTable({"features": xb})).centroids)
        out["ckpt_resumed"] = out["ckpt_uninterrupted"] = \
            jax_sgd.train_linear_model(x, y, w, "logistic", jm,
                                       **worker.CKPT_KW)
        out["no_mesh_fit"] = jax_sgd.train_linear_model(
            x, y, w, "logistic", JaxMesh(devices=jax.devices()[:1]),
            **worker.DENSE_KW)
        out["no_mesh_collectives"] = np.asarray([0])
    finally:
        if old is None:
            os.environ.pop(LAYOUT_ENV, None)
        else:
            os.environ[LAYOUT_ENV] = old
    return {k: np.asarray(v) for k, v in out.items()}


#: Every case and its tolerance against JAX (absolute).
CASES = {
    "lr_dense_f64": F64_TOL, "lr_dense_f32": F32_TOL, "lr_dense_tol": F64_TOL,
    "lr_dense_tol_epoch": 0, "lr_host_mode": F64_TOL,
    "lr_sparse_unsorted": F32_TOL, "lr_sparse_sorted": F32_TOL,
    "lr_sparse_cumsum": F32_TOL, "lr_multinomial": F64_TOL,
    "lr_estimator": F64_TOL, "lr_transform_pred": 0,
    "lr_transform_raw": F64_TOL, "lr_multinomial_estimator": F64_TOL,
    "lr_multinomial_transform_pred": 0,
    "lr_multinomial_transform_raw": F64_TOL,
    "lr_sparse_estimator": F32_TOL, "svc": F64_TOL,
    "svc_transform_raw": F64_TOL, "svc_transform_pred": 0,
    "svc_sparse": F32_TOL, "linreg": F64_TOL, "linreg_transform": F64_TOL,
    "linreg_normal": F32_TOL, "kmeans": F64_TOL, "kmeans_transform": 0,
    "bisecting": F64_TOL, "ckpt_resumed": F64_TOL,
    "ckpt_uninterrupted": F64_TOL, "no_mesh_fit": F64_TOL,
    "no_mesh_collectives": 0,
}


@pytest.fixture(scope="module")
def jax_refs(ranks):
    world, _, outs = ranks
    return jax_reference(world, outs[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_agree_bit_for_bit(ranks, name):
    world, _, outs = ranks
    for r in range(1, world):
        assert outs[r][name].dtype == outs[0][name].dtype
        np.testing.assert_array_equal(outs[r][name], outs[0][name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_fit_matches_jax(ranks, jax_refs, name):
    world, _, outs = ranks
    got, want = outs[0][name], jax_refs[name]
    assert got.shape == want.shape
    if got.dtype.kind == "f" and want.dtype.kind == "f":
        assert got.dtype == want.dtype or name in ("lr_sparse_estimator",
                                                   "svc_sparse")
    np.testing.assert_allclose(got, want, rtol=0, atol=CASES[name])


def test_resumed_fit_equals_the_uninterrupted_one(ranks):
    world, workdir, outs = ranks
    for r in range(world):
        np.testing.assert_array_equal(outs[r]["ckpt_resumed"],
                                      outs[r]["ckpt_uninterrupted"])
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    assert mgr.all_epochs() == [6, 9, 12]
    # The snapshots record world P: a resume at another world is refused
    # by the default policy.
    x, y, w = worker.dense_lr_data()
    with fml.use_device("cpu"), pytest.raises(
            RescaleError, match=f"written at world_size={world}"):
        t_sgd.train_linear_model(x, y, w, "logistic", checkpoint_manager=mgr,
                                 resume=True, **worker.CKPT_KW)


def test_fit_without_a_mesh_issues_no_collective(ranks):
    world, _, outs = ranks
    for r in range(world):
        assert outs[r]["no_mesh_collectives"].tolist() == [0]


@pytest.mark.parametrize("layout", ["sorted", "cumsum"])
@pytest.mark.parametrize("world", WORLDS)
def test_window_tables_match_jax(layout, world):
    """The per-device window tables at P devices are the JAX package's,
    bit for bit."""
    rng = np.random.default_rng(world)
    idx = rng.integers(0, 50, size=(4 * world + 4 * world, 6)).astype(np.int32)
    val = rng.normal(size=idx.shape).astype(np.float32)
    if layout == "sorted":
        got = t_sgd._window_sort_tables(idx, world, 3)
        want = jax_sgd._window_sort_tables(idx, world, 3)
    else:
        got = t_sgd._window_cumsum_tables(idx, val, world, 3)
        want = jax_sgd._window_cumsum_tables(idx, val, world, 3)
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype
        np.testing.assert_array_equal(g, wnt)


def test_sharded_blocks_per_rank(on_cpu):
    """A world-1 mesh fit equals the fit without a mesh bit for bit (no
    process group: no collective)."""
    x, y, w = worker.dense_lr_data()
    mesh = fml.parallel.DeviceMesh()
    np.testing.assert_array_equal(
        t_sgd.train_linear_model(x, y, w, "logistic", mesh=mesh,
                                 **worker.DENSE_KW),
        t_sgd.train_linear_model(x, y, w, "logistic", **worker.DENSE_KW))
    csr = worker.sparse_lr_data()
    for layout in worker.LAYOUTS:
        np.testing.assert_array_equal(
            t_sgd.train_linear_model_sparse_csr(
                *csr, "logistic", mesh=mesh, layout=layout,
                **worker.SPARSE_KW),
            t_sgd.train_linear_model_sparse_csr(
                *csr, "logistic", layout=layout, **worker.SPARSE_KW))


def test_streamed_fits_on_a_mesh_refused(on_cpu):
    """The multi-process streams (item 7c) are ported: on a world-1 mesh
    (no process group) a streamed fit is the one-process stream, the same
    bits as without a mesh (P ranks: ``tests/test_torch_stream_mp.py``).
    Sharding plans (7b) are ported, and a streamed fit refuses a plan with
    JAX's ``ValueError``."""
    mesh = fml.parallel.DeviceMesh()
    x, y, _ = worker.dense_lr_data(n=20)
    table = fml.Table({"features": x, "label": y})
    for cls in (fml.LogisticRegression, fml.LinearSVC, fml.LinearRegression):
        np.testing.assert_array_equal(
            cls(mesh=mesh).set_max_iter(3).fit([table]).coefficient,
            cls().set_max_iter(3).fit([table]).coefficient)
    np.testing.assert_array_equal(
        fml.KMeans(mesh=mesh).set_seed(1).fit(
            [fml.Table({"features": x})]).centroids,
        fml.KMeans().set_seed(1).fit([fml.Table({"features": x})]).centroids)
    from flinkml_tpu_torch.sharding import REPLICATED

    for cls in (fml.LogisticRegression, fml.LinearSVC, fml.LinearRegression):
        with pytest.raises(ValueError, match="in-RAM Table fits only"):
            cls(sharding_plan=REPLICATED).fit([table])
