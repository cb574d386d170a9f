"""The port's MLPs, factorization machines and isotonic regression
(``flinkml_tpu_torch.models.mlp`` / ``fm`` / ``isotonic``) against the
JAX package's, on the CPU.

Every case of ``tests/test_mlp_fm_isotonic.py``, run on the port with the
JAX test's own assertions, plus parity with the JAX package on the same
numpy inputs:

  - initial parameters: the keys, scales and zeros equal JAX's bit for
    bit, the MLP's weights and FM's ``V`` within the normal draw's 3 ulps
    (``tests/test_torch_threefry.py``) times the same float32 scale;
  - the first 1 and 5 Adam steps of MLPClassifier, MLPRegressor,
    FMClassifier and FMRegressor equal JAX's within 1e-5 (float32; the
    JAX side on a one-device mesh, the port's default world-1 mesh): the
    same rows are drawn, and only float32 summation order differs.
    Whole fits are held on what the JAX tests assert, since Adam's
    ``±lr·sign(ĝ)`` update turns order noise on near-zero gradients into
    full steps;
  - models carried across by ``stage_from_arrays`` and by ``load_stage``
    of a JAX save transform as the JAX models do (float64 host math, the
    same expression: bit for bit);
  - FM's sparse margin (``spmv`` in float64 and gathered factor rows):
    the JAX package's own sparse margin needs ``jax.experimental.
    enable_x64``, which this JAX lacks, so the port's is held against
    JAX's dense ``_margin`` on the densified rows and against float64
    numpy (rtol 1e-12);
  - isotonic regression is host numpy in both packages: bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from sklearn.isotonic import IsotonicRegression as SkIso
from sklearn.metrics import r2_score, roc_auc_score

import flinkml_tpu.models as jm
from flinkml_tpu.models import fm as jfm
from flinkml_tpu.models import mlp as jmlp
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.io.read_write import load_stage, stage_from_arrays
from flinkml_tpu_torch.linalg import SparseVector, Vectors
from flinkml_tpu_torch.models import (
    FMClassifier,
    FMRegressor,
    FMRegressorModel,
    IsotonicRegression,
    IsotonicRegressionModel,
    MLPClassifier,
    MLPClassifierModel,
    MLPRegressor,
    MLPRegressorModel,
)
from flinkml_tpu_torch.models import fm as tfm
from flinkml_tpu_torch.models import mlp as tmlp
from flinkml_tpu_torch.models.isotonic import pav
from flinkml_tpu_torch.ops import threefry
from flinkml_tpu_torch.table import Table

STEP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _jmesh():
    return JMesh(devices=jax.devices()[:1])


# -- MLP ---------------------------------------------------------------------

def _xor_data(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 2))
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.float64)
    return x, y


def _mlp(layers, cls=MLPClassifier, **kw):
    m = (cls().set_layers(layers).set_max_iter(600).set_learning_rate(0.01)
         .set_global_batch_size(256).set_tol(0.0).set_seed(0))
    for name, v in kw.items():
        getattr(m, f"set_{name}")(v)
    return m


def test_mlp_solves_xor():
    x, y = _xor_data()
    t = Table({"features": x, "label": y})
    model = _mlp([2, 16, 2]).fit(t)
    (out,) = model.transform(t)
    assert (out["prediction"] == y).mean() > 0.97
    np.testing.assert_allclose(out["rawPrediction"].sum(axis=1), 1.0,
                               rtol=1e-9)


def test_mlp_multiclass():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(size=(100, 2)) * 0.4 + c
                        for c in ([0, 0], [4, 0], [0, 4])])
    y = np.repeat([0.0, 1.0, 2.0], 100)
    t = Table({"features": x, "label": y})
    model = _mlp([2, 8, 3], max_iter=400).fit(t)
    (out,) = model.transform(t)
    assert (out["prediction"] == y).mean() > 0.97


def test_mlp_validation_and_persistence(tmp_path):
    x, y = _xor_data(n=300, seed=2)
    t = Table({"features": x, "label": y})
    with pytest.raises(ValueError, match="layers"):
        MLPClassifier().fit(t)
    with pytest.raises(ValueError, match="feature dim"):
        _mlp([5, 2]).fit(t)
    with pytest.raises(ValueError, match="class ids"):
        _mlp([2, 2]).fit(Table({"features": x, "label": y + 5}))
    model = _mlp([2, 8, 2], max_iter=50).fit(t)
    model.save(str(tmp_path / "mlp"))
    loaded = MLPClassifierModel.load(str(tmp_path / "mlp"))
    (p1,) = model.transform(t)
    (p2,) = loaded.transform(t)
    np.testing.assert_allclose(p2["rawPrediction"], p1["rawPrediction"])
    clone = MLPClassifierModel()
    clone.copy_params_from(model)
    clone.set_model_data(*model.get_model_data())
    (p3,) = clone.transform(t)
    np.testing.assert_allclose(p3["prediction"], p1["prediction"])
    # The port's save loads in the JAX package and predicts the same.
    jloaded = jm.MLPClassifierModel.load(str(tmp_path / "mlp"))
    (jp,) = jloaded.transform(JTable({"features": x, "label": y}))
    assert jp["rawPrediction"].tobytes() == p1["rawPrediction"].tobytes()


def test_mlp_deterministic():
    x, y = _xor_data(n=200, seed=3)
    t = Table({"features": x, "label": y})
    m1 = _mlp([2, 4, 2], max_iter=30).fit(t)
    m2 = _mlp([2, 4, 2], max_iter=30).fit(t)
    for a, b in zip(m1._weights, m2._weights):
        np.testing.assert_array_equal(a, b)


def test_mlp_regressor_fits_nonlinear_function(tmp_path):
    rng = np.random.default_rng(21)
    x = rng.uniform(-2, 2, size=(1500, 2))
    y = np.sin(x[:, 0]) * 2 + x[:, 1] ** 2
    t = Table({"features": x, "label": y})
    model = (MLPRegressor().set_layers([2, 32, 1]).set_max_iter(1500)
             .set_learning_rate(0.01).set_global_batch_size(512).set_tol(0.0)
             .set_seed(0).fit(t))
    (out,) = model.transform(t)
    assert r2_score(y, out["prediction"]) > 0.95
    model.save(str(tmp_path / "mlpr"))
    loaded = MLPRegressorModel.load(str(tmp_path / "mlpr"))
    np.testing.assert_allclose(loaded.transform(t)[0]["prediction"],
                               out["prediction"])
    with pytest.raises(ValueError, match=r"hidden\.\.\., 1"):
        MLPRegressor().set_layers([2, 8, 2]).fit(t)


def test_mlp_regressor_has_no_raw_prediction_param():
    assert MLPRegressor().get_param("rawPredictionCol") is None
    assert MLPClassifier().get_param("rawPredictionCol") is not None


@pytest.mark.parametrize("layers", ([2, 16, 2], [784, 128, 10], [5, 7, 9, 1]))
def test_mlp_initial_params_equal_jax(layers):
    """The keys and the scale are JAX's bit for bit; each weight is a
    normal draw (within 3 ulps of JAX's) times the same float32 scale."""
    want = jmlp._init_params(layers, jax.random.PRNGKey(7))
    got = tmlp._init_params(layers, threefry.PRNGKey(7, "cpu"))
    for (jw, jb), (tw, tb) in zip(want, got):
        jw = np.asarray(jw)
        np.testing.assert_allclose(tw.numpy(), jw, rtol=4 * 2.0**-23, atol=0)
        assert np.asarray(jb).tobytes() == tb.numpy().tobytes()


def _mlp_pair(cls_name, layers, x, y, steps):
    kw = dict(max_iter=steps, learning_rate=0.05, global_batch_size=64)
    port = _mlp(layers, getattr(tmlp, cls_name), **kw)
    ref = _mlp(layers, getattr(jmlp, cls_name), **kw)
    ref.mesh = _jmesh()
    return (port.fit(Table({"features": x, "label": y})),
            ref.fit(JTable({"features": x, "label": y})))


@pytest.mark.parametrize("steps", (1, 5))
@pytest.mark.parametrize("cls_name", ("MLPClassifier", "MLPRegressor"))
def test_mlp_first_steps_match_jax(cls_name, steps):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 6))
    if cls_name == "MLPClassifier":
        layers, y = [6, 12, 3], rng.integers(0, 3, 300).astype(np.float64)
    else:
        layers, y = [6, 12, 1], x[:, 0] * x[:, 1]
    port, ref = _mlp_pair(cls_name, layers, x, y, steps)
    for a, b in zip(port._weights, ref._weights):
        np.testing.assert_allclose(a, b, **STEP_TOL)


def test_mlp_carried_across_transforms_like_jax(tmp_path):
    x, y = _xor_data(n=256, seed=4)
    ref = _mlp([2, 8, 2], jmlp.MLPClassifier, max_iter=40)
    ref.mesh = _jmesh()
    jmodel = ref.fit(JTable({"features": x, "label": y}))
    arrays = {f"arr{i}": a for i, a in enumerate(jmodel._weights)}
    carried = stage_from_arrays(
        "flinkml_tpu.models.mlp.MLPClassifierModel",
        jmodel.get_param_map_json(), arrays)
    (got,) = carried.transform(Table({"features": x}))
    (want,) = jmodel.transform(JTable({"features": x}))
    assert got["rawPrediction"].tobytes() == want["rawPrediction"].tobytes()
    assert got["prediction"].tobytes() == want["prediction"].tobytes()
    jmodel.save(str(tmp_path / "jmlp"))
    loaded = load_stage(str(tmp_path / "jmlp"))
    assert isinstance(loaded, MLPClassifierModel)
    assert loaded.transform(Table({"features": x}))[0]["rawPrediction"] \
        .tobytes() == want["rawPrediction"].tobytes()


# -- FM ----------------------------------------------------------------------

def test_fm_classifier_learns_interactions():
    rng = np.random.default_rng(4)
    x = rng.choice([0.0, 1.0], size=(1500, 8))
    y = ((x[:, 0] * x[:, 1] + x[:, 2] * x[:, 3]) > 0.5).astype(np.float64)
    t = Table({"features": x, "label": y})
    model = (FMClassifier().set_factor_size(8).set_max_iter(800)
             .set_learning_rate(0.05).set_global_batch_size(512).set_tol(0.0)
             .set_seed(0).fit(t))
    (out,) = model.transform(t)
    assert roc_auc_score(y, out["rawPrediction"][:, 1]) > 0.95


def test_fm_regressor_and_persistence(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1000, 5))
    y = 2.0 + x[:, 0] - x[:, 4] + 1.5 * x[:, 1] * x[:, 2]
    t = Table({"features": x, "label": y})
    model = (FMRegressor().set_factor_size(6).set_max_iter(1500)
             .set_learning_rate(0.05).set_global_batch_size(512).set_tol(0.0)
             .set_seed(0).fit(t))
    (out,) = model.transform(t)
    assert r2_score(y, out["prediction"]) > 0.95
    model.save(str(tmp_path / "fm"))
    loaded = FMRegressorModel.load(str(tmp_path / "fm"))
    np.testing.assert_allclose(loaded.transform(t)[0]["prediction"],
                               out["prediction"])
    clone = FMRegressorModel()
    clone.copy_params_from(model)
    clone.set_model_data(*model.get_model_data())
    np.testing.assert_allclose(clone.transform(t)[0]["prediction"],
                               out["prediction"])
    jloaded = jm.FMRegressorModel.load(str(tmp_path / "fm"))
    assert jloaded.transform(JTable({"features": x}))[0]["prediction"] \
        .tobytes() == out["prediction"].tobytes()


def test_fm_reg_shrinks_factors():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 4))
    y = (x[:, 0] > 0).astype(np.float64)
    t = Table({"features": x, "label": y})

    def fit(reg):
        return (FMClassifier().set_factor_size(4).set_max_iter(300)
                .set_learning_rate(0.05).set_global_batch_size(256)
                .set_tol(0.0).set_seed(0).set_reg(reg).fit(t))

    small, large = fit(0.0), fit(1.0)
    assert np.linalg.norm(large._v) < np.linalg.norm(small._v)
    assert np.linalg.norm(large._w) < np.linalg.norm(small._w)


def test_fm_rejects_nonbinary_labels():
    t = Table({"features": np.zeros((3, 2)),
               "label": np.asarray([0.0, 1.0, 2.0])})
    with pytest.raises(ValueError, match="0, 1"):
        FMClassifier().fit(t)


def test_fm_initial_factors_within_normal_ulps():
    est = FMClassifier().set_factor_size(8).set_seed(11)
    jest = jm.FMClassifier().set_factor_size(8).set_seed(11)
    got = est._params0(123, torch.device("cpu"))
    want = jest._params0(123)
    ulps = np.abs(np.asarray(want[2]).view(np.int32).astype(np.int64)
                  - got[2].numpy().view(np.int32).astype(np.int64))
    assert ulps.max() <= 3
    for i in (0, 1, 3):
        assert np.asarray(want[i]).tobytes() == got[i].numpy().tobytes()


def _fm_data(n=512, d=24, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    return x, y


@pytest.mark.parametrize("steps", (1, 5))
@pytest.mark.parametrize("logistic", (True, False), ids=("clf", "reg"))
def test_fm_first_steps_match_jax(logistic, steps):
    x, y = _fm_data()
    if not logistic:
        y = x[:, 0] + 1.0
    name = "FMClassifier" if logistic else "FMRegressor"

    def est(mod):
        return (getattr(mod, name)().set_max_iter(steps).set_reg(0.01)
                .set_global_batch_size(256).set_seed(0).set_tol(0.0))

    port = est(tfm).fit(Table({"features": x, "label": y}))
    ref = est(jfm)
    ref.mesh = _jmesh()
    ref = ref.fit(JTable({"features": x, "label": y}))
    np.testing.assert_allclose(port._w0, ref._w0, **STEP_TOL)
    np.testing.assert_allclose(port._w, ref._w, **STEP_TOL)
    np.testing.assert_allclose(port._v, ref._v, **STEP_TOL)


def test_fm_sharded_world1_first_steps_match_jax():
    """The embedding-sharded trainer at world 1 (one shard) against JAX's
    sharded trainer on a one-device mesh."""
    from flinkml_tpu.sharding import EMBEDDING as J_EMBEDDING
    from flinkml_tpu_torch.sharding.plan import EMBEDDING

    x, _ = _fm_data(seed=2)
    label = x[:, 0] + 1.0
    port = (FMRegressor(sharding_plan=EMBEDDING).set_max_iter(5)
            .set_global_batch_size(256).set_seed(0).set_tol(0.0)
            .fit(Table({"features": x, "label": label})))
    ref = (jm.FMRegressor(sharding_plan=J_EMBEDDING,
                          mesh=JMesh.for_plan(J_EMBEDDING,
                                              devices=jax.devices()[:1]))
           .set_max_iter(5).set_global_batch_size(256).set_seed(0)
           .set_tol(0.0).fit(JTable({"features": x, "label": label})))
    np.testing.assert_allclose(port._w0, ref._w0, **STEP_TOL)
    np.testing.assert_allclose(port._w, ref._w, **STEP_TOL)
    np.testing.assert_allclose(port._v, ref._v, **STEP_TOL)


def test_fm_sharded_refusals():
    from flinkml_tpu_torch.sharding.plan import (
        BATCH_PARALLEL,
        EMBEDDING,
        FSDP_TP,
    )

    x, y = _fm_data(n=64)
    t = Table({"features": x, "label": y})
    with pytest.raises(ValueError, match="streamed fit does not thread"):
        FMClassifier(sharding_plan=EMBEDDING).fit([t, t])
    with pytest.raises(ValueError, match="leaves the FM factor family"):
        FMClassifier(sharding_plan=BATCH_PARALLEL).fit(t)
    with pytest.raises(ValueError, match="factor rows whole"):
        FMClassifier(sharding_plan=FSDP_TP).fit(t)


def _jax_fm_model(logistic=True, d=30, k=4, seed=9):
    rng = np.random.default_rng(seed)
    model = (jm.FMClassifierModel if logistic else jm.FMRegressorModel)()
    model._set(0.25, rng.normal(size=d), rng.normal(size=(d, k)) * 0.3)
    return model


def _sparse_rows(n, d, seed=3):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        nnz = int(rng.integers(0, 6)) if i % 5 else 0
        idx = np.sort(rng.choice(d, size=nnz, replace=False))
        rows.append(SparseVector(d, idx, rng.normal(size=nnz)))
    col = np.empty(n, dtype=object)
    col[:] = rows
    return col


@pytest.mark.parametrize("logistic", (True, False), ids=("clf", "reg"))
def test_fm_carried_across_dense_transform_bit_for_bit(logistic, tmp_path):
    jmodel = _jax_fm_model(logistic)
    arrays = {"w0": np.asarray(jmodel._w0), "w": jmodel._w, "v": jmodel._v}
    cls = "FMClassifierModel" if logistic else "FMRegressorModel"
    carried = stage_from_arrays(f"flinkml_tpu.models.fm.{cls}",
                                jmodel.get_param_map_json(), arrays)
    x = np.random.default_rng(2).normal(size=(40, 30))
    (got,) = carried.transform(Table({"features": x}))
    (want,) = jmodel.transform(JTable({"features": x}))
    for col in want.column_names:
        if col != "features":
            assert got[col].tobytes() == want[col].tobytes(), col
    jmodel.save(str(tmp_path / "jfm"))
    loaded = load_stage(str(tmp_path / "jfm"))
    assert loaded.transform(Table({"features": x}))[0]["prediction"] \
        .tobytes() == want["prediction"].tobytes()


@pytest.mark.parametrize("logistic", (True, False), ids=("clf", "reg"))
def test_fm_sparse_margin_matches_dense_and_float64(logistic):
    jmodel = _jax_fm_model(logistic)
    col = _sparse_rows(57, 30)
    carried = stage_from_arrays(
        "flinkml_tpu.models.fm."
        + ("FMClassifierModel" if logistic else "FMRegressorModel"),
        jmodel.get_param_map_json(),
        {"w0": np.asarray(jmodel._w0), "w": jmodel._w, "v": jmodel._v})
    got = carried._margin(Table({"features": col}))
    dense = np.stack([v.to_array() for v in col])
    want = jmodel._margin(JTable({"features": dense}))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    xv = dense @ jmodel._v
    ref = (jmodel._w0 + dense @ jmodel._w
           + 0.5 * (xv * xv - (dense ** 2) @ (jmodel._v ** 2)).sum(1))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    # Empty rows get the intercept; the transform goes the sparse way.
    assert got[0] == jmodel._w0
    (out,) = carried.transform(Table({"features": col}))
    assert out["prediction"].shape == (57,)


def test_fm_sparse_margin_dim_mismatch():
    carried = FMRegressorModel()
    carried._set(0.0, np.zeros(4), np.zeros((4, 2)))
    with pytest.raises(ValueError, match="model expects 4"):
        carried._margin(Table({"features": _sparse_rows(3, 5)}))


# -- Isotonic ----------------------------------------------------------------

def _iso_pair(cols, weight=None, **params):
    est, jest = IsotonicRegression(), jm.IsotonicRegression()
    for e in (est, jest):
        if weight:
            e.set_weight_col(weight)
        for name, v in params.items():
            getattr(e, f"set_{name}")(v)
    model, jmodel = est.fit(Table(dict(cols))), jest.fit(JTable(dict(cols)))
    assert model.boundaries.tobytes() == jmodel.boundaries.tobytes()
    assert model.values.tobytes() == jmodel.values.tobytes()
    return model


def test_pav_matches_sklearn():
    from flinkml_tpu.models.isotonic import pav as jpav

    rng = np.random.default_rng(7)
    x = rng.uniform(0, 10, 200)
    y = 0.5 * x + rng.normal(size=200)
    sk = SkIso().fit(x, y)
    bnd, val = pav(x, y, np.ones_like(x))
    np.testing.assert_allclose(np.interp(x, bnd, val), sk.predict(x),
                               rtol=1e-9, atol=1e-9)
    jb, jv = jpav(x, y, np.ones_like(x))
    assert bnd.tobytes() == jb.tobytes() and val.tobytes() == jv.tobytes()


def test_isotonic_weighted_and_decreasing(tmp_path):
    x = np.asarray([1.0, 2.0, 3.0, 4.0])
    y = np.asarray([1.0, 3.0, 2.0, 4.0])
    w = np.asarray([1.0, 1.0, 3.0, 1.0])
    t = Table({"features": x, "label": y, "w": w})
    model = _iso_pair({"features": x, "label": y, "w": w}, weight="w")
    sk = SkIso().fit(x, y, sample_weight=w)
    (out,) = model.transform(t)
    np.testing.assert_allclose(out["prediction"], sk.predict(x), rtol=1e-12)
    td = Table({"features": x, "label": y[::-1].copy()})
    md = _iso_pair({"features": x, "label": y[::-1].copy()}, isotonic=False)
    skd = SkIso(increasing=False).fit(x, y[::-1])
    np.testing.assert_allclose(md.transform(td)[0]["prediction"],
                               skd.predict(x), rtol=1e-12)
    model.save(str(tmp_path / "iso"))
    loaded = IsotonicRegressionModel.load(str(tmp_path / "iso"))
    np.testing.assert_allclose(loaded.transform(t)[0]["prediction"],
                               out["prediction"])
    jloaded = jm.IsotonicRegressionModel.load(str(tmp_path / "iso"))
    np.testing.assert_array_equal(jloaded.boundaries, model.boundaries)


def test_isotonic_interpolation_and_clamping():
    model = _iso_pair({"features": np.asarray([0.0, 10.0]),
                       "label": np.asarray([0.0, 1.0])})
    probe = Table({"features": np.asarray([-5.0, 5.0, 15.0])})
    (out,) = model.transform(probe)
    np.testing.assert_allclose(out["prediction"], [0.0, 0.5, 1.0])


def test_isotonic_duplicate_x_ties():
    x = np.asarray([1.0, 1.0, 2.0])
    y = np.asarray([0.0, 2.0, 0.5])
    model = _iso_pair({"features": x, "label": y})
    sk = SkIso().fit(x, y)
    np.testing.assert_allclose(
        model.transform(Table({"features": x}))[0]["prediction"],
        sk.predict(x), rtol=1e-12)


def test_isotonic_zero_weight_rows_dropped():
    x = np.asarray([1.0, 2.0, 3.0])
    y = np.asarray([5.0, 4.0, 3.0])
    w = np.asarray([0.0, 0.0, 1.0])
    model = _iso_pair({"features": x, "label": y, "w": w}, weight="w")
    (out,) = model.transform(Table({"features": x}))
    np.testing.assert_allclose(out["prediction"], 3.0)
    with pytest.raises(ValueError, match="all weights"):
        IsotonicRegression().set_weight_col("w").fit(
            Table({"features": x, "label": y, "w": np.zeros(3)}))


def test_isotonic_accepts_vector_column():
    col = np.empty(3, dtype=object)
    for i, v in enumerate([1.0, 2.0, 3.0]):
        col[i] = Vectors.dense(v)
    t = Table({"features": col, "label": np.asarray([1.0, 2.0, 3.0])})
    model = IsotonicRegression().fit(t)
    (out,) = model.transform(t)
    np.testing.assert_allclose(out["prediction"], [1.0, 2.0, 3.0])


def test_isotonic_carried_across():
    rng = np.random.default_rng(8)
    x, y = rng.uniform(0, 5, 80), rng.normal(size=80)
    jmodel = jm.IsotonicRegression().fit(JTable({"features": x, "label": y}))
    carried = stage_from_arrays(
        "flinkml_tpu.models.isotonic.IsotonicRegressionModel",
        jmodel.get_param_map_json(),
        {"boundaries": jmodel.boundaries, "values": jmodel.values})
    probe = rng.uniform(-1, 6, 50)
    assert carried.transform(Table({"features": probe}))[0]["prediction"] \
        .tobytes() == jmodel.transform(JTable({"features": probe}))[0][
            "prediction"].tobytes()
