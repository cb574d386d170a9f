"""The port's histogram GBT and random forests
(``flinkml_tpu_torch.models.gbt``) against the JAX package, on the CPU.

Parity: the JAX estimators on a one-device mesh (``JMesh({"data": 1},
jax.devices()[:1])``) and the port under ``use_device("cpu")`` fit the same
tables with the same seed, for both histogram layouts (the JAX package's
``FLINKML_TPU_GBT_HISTOGRAM``, the port's ``hist_layout=``), boosted and
bagged. The forests are held by ``chip_smoke.forest_parting``'s near-tie
rule: every split (feature and threshold) equal and the leaves within
1e-5 relative, up to the first node where the two forests' best gains lie
within 1e-4 of each other (a near tie: two splits that part the node's
rows alike have equal gains up to float32 rounding, and the port's
``torch.sigmoid`` and summation order round otherwise than XLA's); a
boosted forest is compared up to that node, a bagged one tree by tree, and
the test prints the ties it met. Past a tie the predictions are held by
the JAX test's quality pins.

The port's own cases mirror ``tests/test_gbt.py`` (quality against
sklearn, weights, determinism, persistence, stumps, ``regLambda`` 0, gain
importances, the random forests' bagging and feature-subset contract,
early stopping, hash-bundled sparse input, the ``cumsum`` layout and its
tables); models saved by either package load in the other.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
from sklearn.ensemble import HistGradientBoostingClassifier
from sklearn.metrics import r2_score, roc_auc_score

import flinkml_tpu.models as jm
import flinkml_tpu.models.gbt as jgbt
import flinkml_tpu_torch as fml
from flinkml_tpu.linalg import SparseVector as JSparseVector
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.models import gbt as pg
from flinkml_tpu_torch.table import Table

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

LAYOUTS = ("segment", "cumsum")
ESTIMATORS = ("GBTClassifier", "GBTRegressor", "RandomForestClassifier",
              "RandomForestRegressor")


@pytest.fixture(autouse=True)
def _cpu():
    with fml.use_device("cpu"):
        yield


def _jmesh1():
    return JMesh({"data": 1}, jax.devices()[:1])


def _nonlinear_classification(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 6))
    logits = 3 * (x[:, 0] * x[:, 1] > 0) - 1.5 + 0.8 * np.sin(3 * x[:, 2])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return x, y


def _nonlinear_regression(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 5))
    y = (
        np.where(x[:, 0] > 0, 3.0, -1.0) + x[:, 1] ** 2
        + 0.5 * x[:, 2] * x[:, 3] + 0.1 * rng.normal(size=n)
    )
    return x, y


def _setup(est, **kw):
    for name, v in kw.items():
        getattr(est, f"set_{name}")(v)
    return est


def _clf(**kw):
    base = dict(num_trees=40, max_depth=4, learning_rate=0.2, seed=0)
    base.update(kw)
    return _setup(pg.GBTClassifier(), **base)


def assert_forests_agree(jmodel, pmodel, boosting, label=""):
    report, problems = chip_smoke.forest_parting(
        chip_smoke.forest_arrays(jmodel), chip_smoke.forest_arrays(pmodel),
        boosting)
    assert not problems, problems
    if report["ties"]:
        print(f"{label}: near ties {report['ties']}")
    return report


# -- parity with the JAX package ------------------------------------------------

PARITY = {
    "GBTClassifier": dict(subsample=0.8),
    "GBTRegressor": dict(subsample=0.7, reg_lambda=0.5),
    "RandomForestClassifier": dict(subsample=0.9),
    "RandomForestRegressor": dict(feature_subset_fraction=0.5),
}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", ESTIMATORS)
def test_forest_matches_jax_on_one_device(monkeypatch, name, layout):
    if "Classifier" in name:
        x, y = _nonlinear_classification(n=700, seed=21)
    else:
        x, y = _nonlinear_regression(n=700, seed=22)
    kw = dict(PARITY[name], num_trees=8, max_depth=4, max_bins=24, seed=5)
    monkeypatch.setenv("FLINKML_TPU_GBT_HISTOGRAM", layout)
    jmodel = _setup(getattr(jm, name)(mesh=_jmesh1()), **kw).fit(
        JTable({"features": x, "label": y}))
    pmodel = _setup(getattr(pg, name)(hist_layout=layout), **kw).fit(
        Table({"features": x, "label": y}))
    boosting = name.startswith("GBT")
    report = assert_forests_agree(jmodel, pmodel, boosting, f"{name}/{layout}")
    # Before any tie, the first trees are equal.
    assert report["equal_trees"] >= 1
    assert pmodel._base == jmodel._base and pmodel._lr == jmodel._lr
    (jo,) = jmodel.transform(JTable({"features": x}))
    (po,) = pmodel.transform(Table({"features": x}))
    if "Classifier" in name:
        jauc = roc_auc_score(y, jo["rawPrediction"][:, 1])
        pauc = roc_auc_score(y, po["rawPrediction"][:, 1])
        assert abs(pauc - jauc) < 0.01, (pauc, jauc)
        if not report["ties"]:
            np.testing.assert_allclose(po["rawPrediction"],
                                       jo["rawPrediction"], rtol=1e-5,
                                       atol=1e-6)
    else:
        assert abs(r2_score(y, po["prediction"])
                   - r2_score(y, jo["prediction"])) < 0.01
        if not report["ties"]:
            np.testing.assert_allclose(po["prediction"], jo["prediction"],
                                       rtol=1e-5, atol=1e-5)


def test_early_stopping_matches_jax(monkeypatch):
    monkeypatch.setenv("FLINKML_TPU_GBT_HISTOGRAM", "segment")
    rng = np.random.default_rng(16)
    x = rng.uniform(-2, 2, size=(400, 4))
    y = (rng.uniform(size=400) < 1 / (1 + np.exp(-1.5 * x[:, 0]))).astype(
        np.float64)
    kw = dict(num_trees=40, max_depth=4, learning_rate=0.4,
              validation_fraction=0.25, seed=0)
    jmodel = _setup(jm.GBTClassifier(mesh=_jmesh1()), **kw).fit(
        JTable({"features": x[:300], "label": y[:300]}))
    pmodel = _setup(pg.GBTClassifier(), **kw).fit(
        Table({"features": x[:300], "label": y[:300]}))
    report = assert_forests_agree(jmodel, pmodel, True, "early stopping")
    if not report["ties"]:
        assert pmodel._feats.shape == jmodel._feats.shape


def test_sparse_hashed_input_matches_jax(monkeypatch):
    monkeypatch.setenv("FLINKML_TPU_GBT_HISTOGRAM", "segment")
    ptable, y = _sparse_cat_table(n=300, seed=3)
    jcol = np.empty(len(y), dtype=object)
    for i, v in enumerate(ptable.column("features")):
        jcol[i] = JSparseVector(v.size(), v.indices, v.values)
    jtable = JTable({"features": jcol, "label": y})
    np.testing.assert_array_equal(
        pg.hashed_feature_matrix(ptable.column("features"), 64),
        jgbt.hashed_feature_matrix(jcol, 64))
    kw = dict(num_trees=5, max_depth=3, num_hash_features=64,
              learning_rate=0.5, seed=0)
    jmodel = _setup(jm.GBTClassifier(mesh=_jmesh1()), **kw).fit(jtable)
    pmodel = _setup(pg.GBTClassifier(), **kw).fit(ptable)
    assert pmodel._hash_features == 64 and pmodel._n_features == 64
    assert_forests_agree(jmodel, pmodel, True, "hashed")


@pytest.mark.parametrize("name", ESTIMATORS)
def test_models_load_across_packages(tmp_path, name):
    """A forest saved by JAX loads in the port (``load_stage``,
    ``stage_from_arrays``) and the port's save loads in JAX; transforms
    equal bit for bit (the host walk is the same numpy)."""
    from flinkml_tpu_torch.io.read_write import load_stage, stage_from_arrays

    x, y = (_nonlinear_classification(n=300, seed=4) if "Classifier" in name
            else _nonlinear_regression(n=300, seed=4))
    jmodel = _setup(getattr(jm, name)(mesh=_jmesh1()), num_trees=4,
                    max_depth=3, seed=1).fit(JTable({"features": x,
                                                     "label": y}))
    jmodel.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"))
    assert type(loaded).__name__ == name + "Model"
    col = "rawPrediction" if "Classifier" in name else "prediction"
    want = np.asarray(jmodel.transform(JTable({"features": x}))[0][col])
    got = loaded.transform(Table({"features": x}))[0].column(col)
    np.testing.assert_array_equal(got, want)
    (tbl,) = jmodel.get_model_data()
    again = stage_from_arrays(
        type(jmodel).__module__ + "." + type(jmodel).__name__,
        jmodel.get_param_map_json(),
        {k: np.asarray(tbl[k]) for k in tbl.column_names})
    np.testing.assert_array_equal(
        again.transform(Table({"features": x}))[0].column(col), want)
    loaded.save(str(tmp_path / "port"))
    back = getattr(jm, name + "Model").load(str(tmp_path / "port"))
    np.testing.assert_array_equal(
        np.asarray(back.transform(JTable({"features": x}))[0][col]), want)


# -- the port's own cases (tests/test_gbt.py) ------------------------------------

def test_classifier_beats_linear_on_nonlinear_data():
    x, y = _nonlinear_classification()
    t = Table({"features": x, "label": y})
    (out,) = _clf().fit(t).transform(t)
    auc = roc_auc_score(y, out.column("rawPrediction")[:, 1])
    ref = HistGradientBoostingClassifier(
        max_iter=40, max_depth=4, learning_rate=0.2).fit(x, y)
    ref_auc = roc_auc_score(y, ref.predict_proba(x)[:, 1])
    assert auc > 0.92 and auc > ref_auc - 0.03, (auc, ref_auc)
    assert (out.column("prediction") == y).mean() > 0.82


def test_classifier_holdout_generalizes():
    x, y = _nonlinear_classification(seed=2)
    model = _clf().fit(Table({"features": x[:1500], "label": y[:1500]}))
    (out,) = model.transform(Table({"features": x[1500:]}))
    auc = roc_auc_score(y[1500:], out.column("rawPrediction")[:, 1])
    ref = HistGradientBoostingClassifier(
        max_iter=40, max_depth=4, learning_rate=0.2).fit(x[:1500], y[:1500])
    ref_auc = roc_auc_score(y[1500:], ref.predict_proba(x[1500:])[:, 1])
    assert auc > ref_auc - 0.02 and auc > 0.78, (auc, ref_auc)


def test_regressor_fits_nonlinear_function():
    x, y = _nonlinear_regression()
    t = Table({"features": x, "label": y})
    model = _setup(pg.GBTRegressor(), num_trees=60, max_depth=4,
                   learning_rate=0.2, seed=0).fit(t)
    assert r2_score(y, model.transform(t)[0].column("prediction")) > 0.93


def test_weighted_rows_shift_the_model():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(500, 2))
    y = (x[:, 0] > 0).astype(np.float64)
    t = Table({"features": x, "label": y,
               "w": np.where(y == 1, 100.0, 0.01)})
    (out,) = _clf(num_trees=10, weight_col="w").fit(t).transform(t)
    assert out.column("prediction").mean() > 0.9


def test_deterministic_and_subsample_varies():
    x, y = _nonlinear_classification(n=600, seed=4)
    t = Table({"features": x, "label": y})
    m1 = _clf(num_trees=5).fit(t)
    m2 = _clf(num_trees=5).fit(t)
    np.testing.assert_array_equal(m1._leaves, m2._leaves)
    m3 = _clf(num_trees=5, subsample=0.5).fit(t)
    assert not np.array_equal(m3._leaves, m1._leaves)
    assert (m3.transform(t)[0].column("prediction") == y).mean() > 0.6


def test_save_load_and_model_data(tmp_path):
    x, y = _nonlinear_classification(n=500, seed=5)
    t = Table({"features": x, "label": y})
    model = _clf(num_trees=8).fit(t)
    model.save(str(tmp_path / "gbt"))
    loaded = pg.GBTClassifierModel.load(str(tmp_path / "gbt"))
    p1 = model.transform(t)[0].column("rawPrediction")
    np.testing.assert_allclose(loaded.transform(t)[0].column("rawPrediction"),
                               p1)
    clone = pg.GBTClassifierModel()
    clone.copy_params_from(model)
    clone.set_model_data(*model.get_model_data())
    np.testing.assert_allclose(clone.transform(t)[0].column("rawPrediction"),
                               p1)


def test_regressor_save_load(tmp_path):
    x, y = _nonlinear_regression(n=400, seed=6)
    t = Table({"features": x, "label": y})
    model = _setup(pg.GBTRegressor(), num_trees=10, max_depth=3,
                   seed=1).fit(t)
    model.save(str(tmp_path / "gbtr"))
    loaded = pg.GBTRegressorModel.load(str(tmp_path / "gbtr"))
    np.testing.assert_allclose(loaded.transform(t)[0].column("prediction"),
                               model.transform(t)[0].column("prediction"))


def test_classifier_rejects_nonbinary_labels():
    t = Table({"features": np.zeros((4, 2)),
               "label": np.asarray([0.0, 1.0, 2.0, 1.0])})
    with pytest.raises(ValueError, match="0, 1"):
        _clf().fit(t)


def test_depth1_is_a_stump_ensemble():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, size=(800, 3))
    y = (x[:, 1] > 0.3).astype(np.float64)
    t = Table({"features": x, "label": y})
    model = _clf(max_depth=1, num_trees=20).fit(t)
    assert (model.transform(t)[0].column("prediction") == y).mean() > 0.97
    assert (model._feats[:, 0] == 1).mean() > 0.8


def test_reg_lambda_zero_still_learns():
    x, y = _nonlinear_classification(n=800, seed=8)
    t = Table({"features": x, "label": y})
    model = _clf(num_trees=20, reg_lambda=0.0).fit(t)
    assert (model.transform(t)[0].column("prediction") == y).mean() > 0.8
    assert np.isfinite(model._leaves).all()


def test_feature_importances_rank_informative_features():
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, size=(800, 5))
    y = ((x[:, 1] > 0) ^ (x[:, 3] > 0)).astype(np.float64)
    model = _clf(num_trees=20, max_depth=3).fit(
        Table({"features": x, "label": y}))
    imp = model.feature_importances()
    assert imp.shape == (5,)
    np.testing.assert_allclose(imp.sum(), 1.0, rtol=1e-9)
    assert set(np.argsort(-imp)[:2]) == {1, 3}
    assert imp[[1, 3]].sum() > 0.9
    imp8 = model.feature_importances(num_features=8)
    np.testing.assert_allclose(imp8[:5], imp)
    np.testing.assert_allclose(imp8[5:], 0.0)
    with pytest.raises(ValueError, match="splits on feature"):
        model.feature_importances(num_features=1)
    rng2 = np.random.default_rng(10)
    x2 = rng2.uniform(-1, 1, size=(600, 3))
    y2 = (x2[:, 2] > 0).astype(np.float64)
    deep = _clf(num_trees=10, max_depth=5).fit(
        Table({"features": x2, "label": y2}))
    imp_deep = deep.feature_importances()
    assert np.argmax(imp_deep) == 2 and imp_deep[2] > 0.9, imp_deep


def test_random_forest_classifier_quality_and_diversity():
    x, y = _nonlinear_classification(n=1500, seed=11)
    t = Table({"features": x, "label": y})
    model = _setup(pg.RandomForestClassifier(), num_trees=40, max_depth=5,
                   subsample=0.7, seed=0).fit(t)
    auc = roc_auc_score(y, model.transform(t)[0].column("rawPrediction")[:, 1])
    assert auc > 0.8, auc
    assert len({tuple(np.unique(model._feats[i])) for i in range(10)}) > 1
    assert model._lr == pytest.approx(1.0 / 40)


def test_random_forest_regressor_and_persistence(tmp_path):
    x, y = _nonlinear_regression(n=1200, seed=12)
    t = Table({"features": x, "label": y})
    model = _setup(pg.RandomForestRegressor(), num_trees=40, max_depth=6,
                   subsample=0.7, seed=0).fit(t)
    out = model.transform(t)[0].column("prediction")
    assert r2_score(y, out) > 0.7
    model.save(str(tmp_path / "rf"))
    loaded = pg.RandomForestRegressorModel.load(str(tmp_path / "rf"))
    np.testing.assert_allclose(loaded.transform(t)[0].column("prediction"),
                               out)


def test_random_forest_feature_fraction_param():
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, size=(400, 4))
    y = (x[:, 0] > 0).astype(np.float64)
    full = _setup(pg.RandomForestClassifier(), num_trees=8, max_depth=2,
                  feature_subset_fraction=1.0, seed=0).fit(
        Table({"features": x, "label": y}))
    assert np.all(full._feats[:, 0] == 0)


def test_random_forest_trees_are_diverse_at_default_params():
    x, y = _nonlinear_regression(n=600, seed=14)
    model = _setup(pg.RandomForestRegressor(), num_trees=6, max_depth=3,
                   seed=0).fit(Table({"features": x, "label": y}))
    leaves = [tuple(np.round(model._leaves[i], 6)) for i in range(6)]
    assert len(set(leaves)) > 1


def test_random_forest_subset_contract_is_strict():
    rng = np.random.default_rng(15)
    x = rng.uniform(-1, 1, size=(500, 6))
    y = (x[:, 2] > 0).astype(np.float64)
    model = _setup(pg.RandomForestClassifier(), num_trees=50, max_depth=3,
                   feature_subset_fraction=0.34, seed=0).fit(
        Table({"features": x, "label": y}))
    for i in range(50):
        used = {int(f) for f, g in zip(model._feats[i], model._gains[i])
                if g > 0}
        assert len(used) <= 2, (i, used)
    assert "featureSubsetFraction" in model.get_param_map_json()


def test_early_stopping_truncates_overfitting_forest():
    rng = np.random.default_rng(16)
    x = rng.uniform(-2, 2, size=(400, 4))
    y = (rng.uniform(size=400) < 1 / (1 + np.exp(-1.5 * x[:, 0]))).astype(
        np.float64)
    t = Table({"features": x[:300], "label": y[:300]})
    full = _clf(num_trees=80, max_depth=5, learning_rate=0.4).fit(t)
    stopped = _clf(num_trees=80, max_depth=5, learning_rate=0.4,
                   validation_fraction=0.25).fit(t)
    assert stopped._feats.shape[0] < 80
    probe = Table({"features": x[300:]})
    full_auc = roc_auc_score(
        y[300:], full.transform(probe)[0].column("rawPrediction")[:, 1])
    stop_auc = roc_auc_score(
        y[300:], stopped.transform(probe)[0].column("rawPrediction")[:, 1])
    assert stop_auc >= full_auc - 0.02


def test_early_stopping_rejected_for_bagging():
    t = Table({"features": np.zeros((10, 2)),
               "label": np.asarray([0.0, 1.0] * 5)})
    with pytest.raises(ValueError, match="boosted"):
        _setup(pg.RandomForestClassifier(), validation_fraction=0.2,
               num_trees=2).fit(t)


def test_labels_validated_before_holdout_split():
    rng = np.random.default_rng(17)
    x = rng.uniform(-1, 1, size=(40, 2))
    y = np.zeros(40)
    y[::2] = 1.0
    y[7] = 2.0
    for vf in (0.0, 0.25):
        with pytest.raises(ValueError, match="0, 1"):
            _clf(num_trees=2, validation_fraction=vf).fit(
                Table({"features": x, "label": y}))


def test_early_stopping_regressor_path():
    rng = np.random.default_rng(18)
    x = rng.uniform(-2, 2, size=(300, 3))
    y = x[:, 0] + 0.5 * rng.normal(size=300)
    stopped = _setup(pg.GBTRegressor(), num_trees=60, max_depth=5,
                     learning_rate=0.4, validation_fraction=0.25,
                     seed=0).fit(Table({"features": x[:220],
                                        "label": y[:220]}))
    assert stopped._feats.shape[0] < 60
    out = stopped.transform(Table({"features": x[220:]}))[0]
    assert r2_score(y[220:], out.column("prediction")) > 0.5


def _sparse_cat_table(n=600, cardinality=1_000_000, seed=0):
    """SparseVector features at a cardinality where densifying would need
    n x 1e6 floats: three informative real-valued columns and
    high-cardinality one-hot noise (``tests/test_gbt.py``'s generator)."""
    rng = np.random.default_rng(seed)
    info_cols = [12_345, 777_777, 424_242]
    col = np.empty(n, dtype=object)
    y = np.empty(n, np.float64)
    for i in range(n):
        v = rng.normal(size=len(info_cols))
        noise_ids = rng.choice(cardinality, size=4, replace=False)
        ids = np.concatenate([np.asarray(info_cols), noise_ids])
        vals = np.concatenate([v, np.full(4, 0.01)])
        uniq, first = np.unique(ids, return_index=True)
        col[i] = SparseVector(cardinality, uniq, vals[first])
        y[i] = float(v[0] + 0.5 * v[1] - 0.5 * v[2] > 0)
    return Table({"features": col, "label": y}), y


def test_gbt_trains_on_sparse_without_densifying():
    table, y = _sparse_cat_table()
    model = _setup(pg.GBTClassifier(), num_trees=15, max_depth=4,
                   max_bins=32, num_hash_features=512, learning_rate=0.5,
                   seed=0).fit(table)
    assert model._hash_features == 512 and model._n_features == 512
    acc = float(np.mean(model.transform(table)[0].column("prediction") == y))
    assert acc > 0.8, acc


def test_gbt_sparse_model_persistence_round_trip(tmp_path):
    table, _ = _sparse_cat_table(n=200)
    model = _setup(pg.GBTClassifier(), num_trees=5, max_depth=3,
                   num_hash_features=64, seed=0).fit(table)
    out = model.transform(table)[0].column("prediction")
    model.save(str(tmp_path / "sgbt"))
    loaded = pg.GBTClassifierModel.load(str(tmp_path / "sgbt"))
    assert loaded._hash_features == 64
    np.testing.assert_array_equal(
        loaded.transform(table)[0].column("prediction"), out)
    m3 = pg.GBTClassifierModel()
    m3.copy_params_from(model)
    m3.set_model_data(*model.get_model_data())
    np.testing.assert_array_equal(m3.transform(table)[0].column("prediction"),
                                  out)


def test_gbt_sparse_streamed_fit(tmp_path):
    tables, ys = zip(*(_sparse_cat_table(n=200, seed=s) for s in range(4)))
    model = _setup(pg.GBTClassifier(cache_dir=str(tmp_path / "sp"),
                                    cache_memory_budget_bytes=1),
                   num_trees=10, max_depth=4, num_hash_features=256,
                   learning_rate=0.5, seed=0).fit(iter(tables))
    assert model._hash_features == 256
    acc = float(np.mean(model.transform(tables[0])[0].column("prediction")
                        == ys[0]))
    assert acc > 0.7, acc


def test_random_forest_on_sparse_input():
    table, y = _sparse_cat_table(n=300)
    model = _setup(pg.RandomForestClassifier(), num_trees=20, max_depth=6,
                   num_hash_features=128, seed=0).fit(table)
    assert float(np.mean(model.transform(table)[0].column("prediction")
                         == y)) > 0.7


def test_cumsum_histogram_layout_matches_segment():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(512, 5)).astype(np.float32)
    y = (x[:, 0] * x[:, 1] > 0).astype(np.float64)
    t = Table({"features": x, "label": y})

    def fit(layout):
        m = _setup(pg.GBTClassifier(hist_layout=layout), num_trees=6,
                   max_depth=3, max_bins=16, subsample=0.8, seed=0).fit(t)
        return m, m.transform(t)[0].column("rawPrediction")

    m_seg, raw_seg = fit("segment")
    m_cum, raw_cum = fit("cumsum")
    np.testing.assert_array_equal(m_seg._feats, m_cum._feats)
    np.testing.assert_allclose(m_seg._leaves, m_cum._leaves, rtol=1e-5)
    np.testing.assert_allclose(raw_cum, raw_seg, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="hist_layout"):
        pg.GBTClassifier(hist_layout="sorted")


def test_gbt_hist_tables_equal_jax_and_reconstruct_histograms():
    rng = np.random.default_rng(0)
    p, n_local, d, n_bins = 2, 24, 3, 4
    b = rng.integers(0, n_bins, size=(p * n_local, d)).astype(np.int32)
    tables = pg.gbt_hist_tables(b, p, n_bins)
    for got, want in zip(tables, jgbt.gbt_hist_tables(b, p, n_bins)):
        np.testing.assert_array_equal(got, want)
    srow, ends, cols = tables
    cells = n_local * d
    g = rng.normal(size=p * n_local)
    for dev in range(p):
        shard = b[dev * n_local:(dev + 1) * n_local]
        expect = np.zeros(d * n_bins)
        np.add.at(expect,
                  (np.arange(d)[None, :] * n_bins + shard).reshape(-1),
                  np.repeat(g[dev * n_local:(dev + 1) * n_local], d))
        sr = srow[dev * cells:(dev + 1) * cells]
        e = ends[dev * (ends.size // p):(dev + 1) * (ends.size // p)]
        c = cols[dev * (cols.size // p):(dev + 1) * (cols.size // p)]
        csum = np.cumsum(g[dev * n_local + sr])
        tvals = csum[e]
        seg = tvals - np.concatenate([[0.0], tvals[:-1]])
        got = np.zeros(d * n_bins)
        np.add.at(got, c, seg)
        np.testing.assert_allclose(got, expect, atol=1e-10)


def test_binning_equals_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(300, 4))
    x[:, 2] = np.round(x[:, 2])       # few distinct values: fewer edges
    e = pg.quantile_bin_edges(x, 16)
    np.testing.assert_array_equal(e, jgbt.quantile_bin_edges(x, 16))
    np.testing.assert_array_equal(pg.bin_features(x, e),
                                  jgbt.bin_features(x, e))


# -- the card checks of chip_smoke.py path V, with planted faults ----------------

def test_near_tie_rule_catches_planted_faults():
    """``forest_parting`` passes a forest against itself and fails a
    forest built from histograms that drop half their cells, and one
    whose bootstrap draws come from the wrong key."""
    x, y = _nonlinear_classification(n=600, seed=30)
    t = Table({"features": x, "label": y})
    kw = dict(num_trees=6, max_depth=3, max_bins=16, seed=2)
    good = _setup(pg.GBTClassifier(), **kw).fit(t)
    ref = chip_smoke.forest_arrays(good)
    assert chip_smoke.forest_parting(ref, ref, True)[1] == []

    real = pg.level_hists_segment

    def half_cells(binned, gh, node, *a):
        return real(binned[: binned.shape[0] // 2], gh[: gh.shape[0] // 2],
                    node[: node.shape[0] // 2], *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "level_hists_segment", half_cells)
        bad = _setup(pg.GBTClassifier(), **kw).fit(t)
    assert chip_smoke.forest_parting(ref, chip_smoke.forest_arrays(bad),
                                     True)[1]

    rf_kw = dict(num_trees=6, max_depth=3, max_bins=16, seed=2,
                 feature_subset_fraction=0.5)
    rf = _setup(pg.RandomForestClassifier(), **rf_kw).fit(t)
    real_weights = pg.tree_weights

    def wrong_key(key, *a, **k):
        from flinkml_tpu_torch.ops import threefry
        return real_weights(threefry.fold_in(key, 1), *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "tree_weights", wrong_key)
        rf_bad = _setup(pg.RandomForestClassifier(), **rf_kw).fit(t)
    assert chip_smoke.forest_parting(chip_smoke.forest_arrays(rf),
                                     chip_smoke.forest_arrays(rf_bad),
                                     False)[1]
