"""LinearSVC and LinearRegression in the port against the JAX package on a
one-device mesh, on the CPU: every case of ``tests/test_linear_models.py``
but ``test_multi_device_sparse`` (the mesh's parity cases are in
``tests/test_torch_data_parallel.py``),
each fitted by both packages on the same seeded inputs, with the JAX
test's own assertion held on the port's model too; the normal-equation
solver; models saved by either package loaded by the other.

Declared tolerances: dense float64 fits 1e-10 against JAX (the products
add in another order); sparse fits (float32) 1e-5; the normal solver 1e-6
relative (a float32 gram summed in another order, solved in float64: the
solve scales the gram's rounding by its condition number, at most ~10
here), and 1e-4 on the collinear gram, whose min-norm solve is as ill
conditioned as the data makes it.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import flinkml_tpu_torch as fml
from flinkml_tpu.io import read_write as jax_read_write
from flinkml_tpu.linalg import Vectors as JaxVectors
from flinkml_tpu.models import linear_regression as jax_linreg
from flinkml_tpu.models import linear_svc as jax_svc
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.parallel import DeviceMesh
from flinkml_tpu.table import Table as JaxTable
from tests._torch_port_common import on_cpu  # noqa: F401

F64_TOL = 1e-10
F32_TOL = 1e-5
LAYOUT_ENV = "FLINKML_TPU_SPARSE_LAYOUT"


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


@pytest.fixture(autouse=True)
def default_layout(monkeypatch):
    """The JAX sparse fit's default (unsorted) layout, as the port's."""
    monkeypatch.delenv(LAYOUT_ENV, raising=False)


MESH1 = None


def _mesh1():
    global MESH1
    if MESH1 is None:
        MESH1 = DeviceMesh(devices=jax.devices()[:1])
    return MESH1


PAIRS = {
    "LinearSVC": (fml.LinearSVC, jax_svc.LinearSVC),
    "LinearRegression": (fml.LinearRegression, jax_linreg.LinearRegression),
    "LogisticRegression": (fml.LogisticRegression, jax_lr.LogisticRegression),
}


def fit_both(name, cols, sparse=None, **params):
    """Fit the port's and the JAX estimator ``name`` with ``params`` on
    ``cols`` (``sparse``: the features as CSR ``(mat, dim)``, each package
    given its own SparseVectors). Returns ``(port model, jax model)``."""
    t_cls, j_cls = PAIRS[name]
    t_est, j_est = t_cls(), j_cls(mesh=_mesh1())
    for k, v in params.items():
        getattr(t_est, f"set_{k}")(v)
        getattr(j_est, f"set_{k}")(v)
    t_cols, j_cols = dict(cols), dict(cols)
    if sparse is not None:
        t_cols["features"] = _sparse_vectors(*sparse, fml.Vectors)
        j_cols["features"] = _sparse_vectors(*sparse, JaxVectors)
    return t_est.fit(fml.Table(t_cols)), j_est.fit(JaxTable(j_cols))


def _sparse_vectors(mat, dim, vectors):
    return np.array([
        vectors.sparse(dim, mat.indices[mat.indptr[i]:mat.indptr[i + 1]],
                       mat.data[mat.indptr[i]:mat.indptr[i + 1]])
        for i in range(mat.shape[0])], dtype=object)


def _close(got, want, tol):
    np.testing.assert_allclose(got.coefficient, want.coefficient, rtol=tol,
                               atol=tol)


def _class_cols(rng):
    x = rng.normal(size=(300, 5))
    true = rng.normal(size=5) * 2
    return {"features": x, "label": (x @ true > 0).astype(np.float64)}


def test_linear_svc_fit_predict(rng, on_cpu):
    cols = _class_cols(rng)
    got, want = fit_both("LinearSVC", cols, seed=0, max_iter=300,
                         learning_rate=0.5, global_batch_size=300)
    _close(got, want, F64_TOL)
    (out,) = got.transform(fml.Table(cols))
    assert np.mean(out.column("prediction") == cols["label"]) > 0.97
    assert out.column("rawPrediction").shape == (300,)
    (jout,) = want.transform(JaxTable(cols))
    np.testing.assert_allclose(out.column("rawPrediction"),
                               jout.column("rawPrediction"), rtol=F64_TOL,
                               atol=F64_TOL)
    np.testing.assert_array_equal(out.column("prediction"),
                                  jout.column("prediction"))


def test_linear_svc_against_sklearn(rng, on_cpu):
    from sklearn.svm import LinearSVC as SkSVC

    cols = _class_cols(rng)
    got, want = fit_both("LinearSVC", cols, seed=0, max_iter=500,
                         learning_rate=0.5, global_batch_size=300, reg=0.001)
    _close(got, want, F64_TOL)
    sk = SkSVC(fit_intercept=False, max_iter=5000).fit(cols["features"],
                                                       cols["label"])
    c = got.coefficient
    cos = c @ sk.coef_[0] / (np.linalg.norm(c) * np.linalg.norm(sk.coef_[0]))
    assert cos > 0.98


def test_linear_svc_threshold(rng, on_cpu):
    cols = _class_cols(rng)
    got, want = fit_both("LinearSVC", cols, seed=0, max_iter=50)
    got.set_threshold(0.5)
    want.set_threshold(0.5)
    (out,) = got.transform(fml.Table(cols))
    (jout,) = want.transform(JaxTable(cols))
    np.testing.assert_array_equal(out.column("prediction"),
                                  jout.column("prediction"))


@pytest.mark.parametrize("name", ["LinearSVC", "LinearRegression"])
def test_save_load_across_packages(name, tmp_path, rng, on_cpu):
    """A fitted model saved by either package loads in the other (the
    class name mapped, the content fingerprint verified)."""
    cols = _class_cols(rng)
    got, _ = fit_both(name, cols, seed=0, max_iter=50, reg=0.1)
    got.save(str(tmp_path / "port"))
    loaded = jax_read_write.load_stage(str(tmp_path / "port"))
    assert type(loaded).__name__ == f"{name}Model"
    assert type(loaded).__module__.startswith("flinkml_tpu.models")
    np.testing.assert_array_equal(loaded.coefficient, got.coefficient)
    loaded.save(str(tmp_path / "jax"))
    back = fml.load_stage(str(tmp_path / "jax"))
    assert isinstance(back, getattr(fml, f"{name}Model"))
    np.testing.assert_array_equal(back.coefficient, got.coefficient)
    assert back.get_param_map_json() == got.get_param_map_json()
    own = type(got).load(str(tmp_path / "port"))
    np.testing.assert_array_equal(own.coefficient, got.coefficient)


def test_linear_regression_recovers_coefficients(rng, on_cpu):
    x = rng.normal(size=(500, 4))
    true = np.array([1.5, -2.0, 0.5, 3.0])
    y = x @ true + 0.01 * rng.normal(size=500)
    cols = {"features": x, "label": y}
    got, want = fit_both("LinearRegression", cols, seed=0, max_iter=2000,
                         learning_rate=0.5, global_batch_size=500)
    _close(got, want, F64_TOL)
    np.testing.assert_allclose(got.coefficient, true, atol=0.05)
    (out,) = got.transform(fml.Table(cols))
    assert np.corrcoef(out.column("prediction"), y)[0, 1] > 0.999


def test_lasso_sparsifies(rng, on_cpu):
    x = rng.normal(size=(400, 8))
    y = 2.0 * x[:, 0] - 1.0 * x[:, 1] + 0.01 * rng.normal(size=400)
    got, want = fit_both("LinearRegression", {"features": x, "label": y},
                         seed=0, max_iter=1500, learning_rate=0.5,
                         global_batch_size=400, reg=0.5, elastic_net=1.0)
    _close(got, want, F64_TOL)
    coef = got.coefficient
    assert abs(coef[0]) > 1.0 and abs(coef[1]) > 0.4
    assert np.all(np.abs(coef[2:]) < 0.02)


def test_weighted_linear_regression(rng, on_cpu):
    x = rng.normal(size=(200, 2))
    y = x @ np.array([1.0, 1.0])
    got, want = fit_both("LinearRegression",
                         {"features": x, "label": y, "w": np.ones(200)},
                         seed=1, max_iter=500, learning_rate=0.5,
                         global_batch_size=200, weight_col="w")
    _close(got, want, F64_TOL)
    np.testing.assert_allclose(got.coefficient, [1.0, 1.0], atol=0.02)


def test_sparse_logistic_regression(rng, on_cpu):
    mat = sp.random(400, 50, density=0.1, random_state=0, format="csr")
    y = (mat @ rng.normal(size=50) > 0).astype(np.float64)
    got, want = fit_both("LogisticRegression", {"label": y}, sparse=(mat, 50),
                         seed=0, max_iter=400, learning_rate=1.0,
                         global_batch_size=400)
    _close(got, want, F32_TOL)
    (out,) = got.transform(fml.Table({"features": _sparse_vectors(
        mat, 50, fml.Vectors)}))
    assert np.mean(out.column("prediction") == y) > 0.93


def _sparse_and_dense(rng, n=200, d=6, label_fn=None):
    x = rng.normal(size=(n, d)) * (rng.random((n, d)) < 0.4)
    y = (label_fn(x) if label_fn is not None
         else (x[:, 0] + x[:, 1] > 0).astype(np.float64))
    return x, sp.csr_matrix(x), y


def test_sparse_linear_svc_matches_dense(rng, on_cpu):
    x, mat, y = _sparse_and_dense(rng)
    kw = dict(seed=3, max_iter=200, global_batch_size=200, learning_rate=0.5)
    dense_m, dense_j = fit_both("LinearSVC", {"features": x, "label": y}, **kw)
    sparse_m, sparse_j = fit_both("LinearSVC", {"label": y}, sparse=(mat, 6),
                                  **kw)
    _close(dense_m, dense_j, F64_TOL)
    _close(sparse_m, sparse_j, F32_TOL)
    a, b = dense_m.coefficient, sparse_m.coefficient
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999
    (sa,) = sparse_m.transform(fml.Table({"features": _sparse_vectors(
        mat, 6, fml.Vectors)}))
    (sb,) = dense_m.transform(fml.Table({"features": x}))
    assert np.mean(sa.column("prediction") == sb.column("prediction")) > 0.98
    (ja,) = sparse_j.transform(JaxTable({"features": _sparse_vectors(
        mat, 6, JaxVectors)}))
    np.testing.assert_allclose(sa.column("rawPrediction"),
                               ja.column("rawPrediction"), rtol=F32_TOL,
                               atol=F32_TOL)


def test_sparse_linear_regression_matches_dense(rng, on_cpu):
    x, mat, y = _sparse_and_dense(rng, label_fn=lambda x: x[:, 0] * 2.0
                                  - x[:, 2])
    kw = dict(seed=3, max_iter=400, global_batch_size=200, learning_rate=0.5,
              tol=0.0)
    dense_m, dense_j = fit_both("LinearRegression", {"features": x,
                                                     "label": y}, **kw)
    sparse_m, sparse_j = fit_both("LinearRegression", {"label": y},
                                  sparse=(mat, 6), **kw)
    _close(dense_m, dense_j, F64_TOL)
    _close(sparse_m, sparse_j, F32_TOL)
    np.testing.assert_allclose(sparse_m.coefficient, dense_m.coefficient,
                               atol=5e-3)
    (a,) = sparse_m.transform(fml.Table({"features": _sparse_vectors(
        mat, 6, fml.Vectors)}))
    (b,) = dense_m.transform(fml.Table({"features": x}))
    np.testing.assert_allclose(a.column("prediction"), b.column("prediction"),
                               atol=2e-2)


def test_sparse_inference_dim_mismatch_raises(rng, on_cpu):
    x, mat, y = _sparse_and_dense(rng)
    model, _ = fit_both("LinearSVC", {"label": y}, sparse=(mat, 6), seed=0,
                        max_iter=20, global_batch_size=200)
    wrong = fml.Table({"features": np.array(
        [fml.Vectors.sparse(12, [0, 7], [1.0, 2.0])], dtype=object)})
    with pytest.raises(ValueError, match="dim"):
        model.transform(wrong)


def test_mixed_vector_column_densifies(rng, on_cpu):
    from flinkml_tpu.linalg import DenseVector as JaxDense

    x = rng.normal(size=(64, 4))
    y = (x[:, 0] > 0).astype(np.float64)

    def vecs(vectors, dense):
        return np.array([vectors.sparse(4, np.arange(4), row) if i % 2
                         else dense(row) for i, row in enumerate(x)],
                        dtype=object)

    kw = dict(seed=0, max_iter=100, global_batch_size=64, learning_rate=0.5)
    t_est, j_est = fml.LinearSVC(), jax_svc.LinearSVC(mesh=_mesh1())
    for est in (t_est, j_est):
        for k, v in kw.items():
            getattr(est, f"set_{k}")(v)
    got = t_est.fit(fml.Table({"features": vecs(fml.Vectors, fml.DenseVector),
                               "label": y}))
    want = j_est.fit(JaxTable({"features": vecs(JaxVectors, JaxDense),
                               "label": y}))
    _close(got, want, F64_TOL)
    (out,) = got.transform(fml.Table({"features": vecs(fml.Vectors,
                                                       fml.DenseVector)}))
    assert np.mean(out.column("prediction") == y) > 0.9


def test_sparse_dense_agreement(rng, on_cpu):
    x, mat, y = _sparse_and_dense(rng)
    kw = dict(seed=3, max_iter=200, global_batch_size=200)
    dense_m, _ = fit_both("LogisticRegression", {"features": x, "label": y},
                          **kw)
    sparse_m, sparse_j = fit_both("LogisticRegression", {"label": y},
                                  sparse=(mat, 6), **kw)
    _close(sparse_m, sparse_j, F32_TOL)
    a, b = dense_m.coefficient, sparse_m.coefficient
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999
    (sa,) = sparse_m.transform(fml.Table({"features": _sparse_vectors(
        mat, 6, fml.Vectors)}))
    (sb,) = dense_m.transform(fml.Table({"features": x}))
    np.testing.assert_array_equal(sa.column("prediction"),
                                  sb.column("prediction"))


def test_checkpointed_in_ram_fits_match_jax(tmp_path, rng, on_cpu):
    """The estimators' checkpoint knobs on the in-RAM fits: JAX and the
    port snapshot at the same epochs; the resumed fit is the
    uninterrupted one."""
    from flinkml_tpu.iteration import CheckpointManager as JaxManager

    cols = _class_cols(rng)
    kw = dict(seed=0, max_iter=12, learning_rate=0.5, global_batch_size=100)
    golden, _ = fit_both("LinearSVC", cols, **kw)
    mgr = fml.CheckpointManager(str(tmp_path / "t"), max_to_keep=10)
    jmgr = JaxManager(str(tmp_path / "j"), world_size=1, max_to_keep=10)
    t_est = fml.LinearSVC(checkpoint_manager=mgr, checkpoint_interval=5)
    j_est = jax_svc.LinearSVC(mesh=_mesh1(), checkpoint_manager=jmgr,
                              checkpoint_interval=5)
    for est in (t_est, j_est):
        for k, v in {**kw, "max_iter": 7}.items():
            getattr(est, f"set_{k}")(v)
    t_est.fit(fml.Table(cols))
    j_est.fit(JaxTable(cols))
    assert mgr.all_epochs() == jmgr.all_epochs() == [5, 7]
    resumed = (fml.LinearSVC(checkpoint_manager=mgr, checkpoint_interval=5,
                             resume=True).set_seed(0).set_max_iter(12)
               .set_learning_rate(0.5).set_global_batch_size(100)
               ).fit(fml.Table(cols))
    np.testing.assert_array_equal(resumed.coefficient, golden.coefficient)


# -- the normal equations ------------------------------------------------------------


def _normal_both(cols, **params):
    return fit_both("LinearRegression", cols, solver="normal", **params)


def test_linear_regression_normal_solver_exact(on_cpu):
    from sklearn.linear_model import LinearRegression as SkOLS, Ridge

    rng = np.random.default_rng(11)
    x = rng.normal(size=(300, 6))
    y = x @ rng.normal(size=6) + 0.1 * rng.normal(size=300)
    cols = {"features": x, "label": y}
    got, want = _normal_both(cols)
    np.testing.assert_allclose(got.coefficient, want.coefficient, rtol=1e-6)
    np.testing.assert_allclose(got.coefficient,
                               SkOLS(fit_intercept=False).fit(x, y).coef_,
                               rtol=1e-4, atol=1e-5)
    got, want = _normal_both(cols, reg=5.0)
    np.testing.assert_allclose(got.coefficient, want.coefficient, rtol=1e-6)
    np.testing.assert_allclose(
        got.coefficient, Ridge(alpha=10.0, fit_intercept=False).fit(x, y).coef_,
        rtol=1e-4, atol=1e-5)


def test_linear_regression_normal_solver_weighted(on_cpu):
    from sklearn.linear_model import LinearRegression as SkOLS

    rng = np.random.default_rng(12)
    x = rng.normal(size=(200, 3))
    y = x @ np.asarray([1.0, -2.0, 0.5]) + rng.normal(size=200)
    w = rng.uniform(0.1, 5.0, size=200)
    got, want = _normal_both({"features": x, "label": y, "w": w},
                             weight_col="w")
    np.testing.assert_allclose(got.coefficient, want.coefficient, rtol=1e-6)
    ref = SkOLS(fit_intercept=False).fit(x, y, sample_weight=w)
    np.testing.assert_allclose(got.coefficient, ref.coef_, rtol=1e-4,
                               atol=1e-5)


def test_normal_equation_terms_match_numpy(on_cpu):
    """The gram and ``XᵀWy`` products in float32, against float64 numpy of
    the same float32 inputs."""
    from flinkml_tpu_torch.models.linear_regression import (
        normal_equation_terms,
    )

    rng = np.random.default_rng(5)
    x, y, w = rng.normal(size=(500, 7)), rng.normal(size=500), rng.random(500)
    a, b = normal_equation_terms(x, y, w)
    x32, y32, w32 = (v.astype(np.float32).astype(np.float64)
                     for v in (x, y, w))
    np.testing.assert_allclose(a, x32.T @ (x32 * w32[:, None]), rtol=1e-5)
    np.testing.assert_allclose(b, (x32 * w32[:, None]).T @ y32, rtol=1e-5,
                               atol=1e-5)


def test_linear_regression_normal_solver_validation(rng, on_cpu):
    """Every refusal of the JAX ``fit``, with its message, in both."""
    x, mat, y = _sparse_and_dense(rng, n=8, d=2)
    dense = {"features": np.zeros((4, 2)), "label": np.zeros(4)}
    cases = [
        (dict(elastic_net=0.5, reg=0.1), dense, None, "elasticNet"),
        (dict(), {"label": y}, (mat, 2), "dense features"),
    ]
    for params, cols, sparse, match in cases:
        with pytest.raises(ValueError, match=match):
            _normal_both(cols, sparse=sparse, **params)
        est = fml.LinearRegression().set_solver("normal")
        for k, v in params.items():
            getattr(est, f"set_{k}")(v)
        with pytest.raises(ValueError, match=match):
            est.fit(fml.Table(
                dict(cols, features=_sparse_vectors(*sparse, fml.Vectors))
                if sparse else cols))
    for est in (fml.LinearRegression(checkpoint_manager=object()),
                fml.LinearRegression(resume=True)):
        with pytest.raises(ValueError, match="one-shot closed form"):
            est.set_solver("normal").fit(fml.Table(dense))
    with pytest.raises(ValueError, match="solver='sgd'"):
        fml.LinearRegression().set_solver("normal").fit(iter([]))
    with pytest.raises(ValueError):
        fml.LinearRegression().set_solver("qr")


def test_normal_solver_matches_sgd_fixed_point(on_cpu):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(400, 4))
    y = x @ np.asarray([2.0, -1.0, 0.5, 0.0]) + 0.05 * rng.normal(size=400)
    cols = {"features": x, "label": y}
    exact, _ = _normal_both(cols, reg=2.0)
    sgd, jsgd = fit_both("LinearRegression", cols, reg=2.0, max_iter=800,
                         global_batch_size=400, learning_rate=0.5, tol=0.0,
                         seed=0)
    _close(sgd, jsgd, F64_TOL)
    np.testing.assert_allclose(sgd.coefficient, exact.coefficient, rtol=2e-3,
                               atol=2e-4)


def test_normal_solver_tiny_scale_features(on_cpu):
    from sklearn.linear_model import LinearRegression as SkOLS

    rng = np.random.default_rng(14)
    x = rng.normal(size=(200, 3)) * 1e-6
    y = x @ np.asarray([1e6, -2e6, 5e5]) + 0.01 * rng.normal(size=200)
    got, want = _normal_both({"features": x, "label": y})
    np.testing.assert_allclose(got.coefficient, want.coefficient, rtol=1e-6)
    np.testing.assert_allclose(got.coefficient,
                               SkOLS(fit_intercept=False).fit(x, y).coef_,
                               rtol=1e-3)


def test_normal_solver_collinear_min_norm(on_cpu):
    from sklearn.linear_model import LinearRegression as SkOLS

    rng = np.random.default_rng(15)
    base = rng.normal(size=(150, 2))
    x = np.concatenate([base, base[:, :1]], axis=1)
    y = base @ np.asarray([1.0, -1.0]) + 0.01 * rng.normal(size=150)
    got, want = _normal_both({"features": x, "label": y})
    np.testing.assert_allclose(got.coefficient, want.coefficient, atol=1e-4)
    np.testing.assert_allclose(got.coefficient,
                               SkOLS(fit_intercept=False).fit(x, y).coef_,
                               atol=1e-3)
    np.testing.assert_allclose(got.coefficient[0], got.coefficient[2],
                               atol=1e-3)


def test_estimators_refuse_unported_knobs(on_cpu):
    """Sharding plans (item 7b) and precision policies (item 3) are
    ported: the dense in-RAM fits take them and agree with JAX's, and the
    streamed fits refuse them with JAX's ``ValueError`` (more cases in
    ``tests/test_torch_sharding.py``); ``mesh=`` is ported (its parity
    cases are in ``tests/test_torch_data_parallel.py``) and takes a
    DeviceMesh."""
    from flinkml_tpu.sharding import plan as jax_plan
    from flinkml_tpu_torch.sharding import plan as t_plan

    rng = np.random.default_rng(5)
    x = rng.normal(size=(48, 4))
    y = (x[:, 0] > 0).astype(np.float64)
    mesh1 = _mesh1()
    for cls, jax_cls in ((fml.LinearSVC, jax_svc.LinearSVC),
                         (fml.LinearRegression, jax_linreg.LinearRegression)):
        for knobs, jax_knobs, tol in (
                ({"sharding_plan": t_plan.FSDP},
                 {"sharding_plan": jax_plan.FSDP}, 1e-10),
                ({"precision": "mixed"}, {"precision": "mixed"}, 1e-5)):
            got = cls(**knobs).set_seed(2).set_max_iter(4).fit(
                fml.Table({"features": x, "label": y}))
            want = jax_cls(mesh=mesh1, **jax_knobs).set_seed(2).set_max_iter(
                4).fit(JaxTable({"features": x, "label": y}))
            np.testing.assert_allclose(got.coefficient,
                                       np.asarray(want._coefficient),
                                       rtol=0, atol=tol)
            with pytest.raises(ValueError, match="in-RAM Table fits only"):
                cls(**knobs).fit([fml.Table({"features": x, "label": y})])
        with pytest.raises(TypeError, match="DeviceMesh"):
            cls(mesh=object())


def test_fit_without_card_raises_device_error():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    x = np.random.default_rng(0).normal(size=(20, 3))
    with pytest.raises(RuntimeError, match="use_device"):
        fml.LinearSVC().fit(fml.Table({"features": x,
                                       "label": (x[:, 0] > 0) * 1.0}))
