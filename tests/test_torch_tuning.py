"""Model selection of the port (``flinkml_tpu_torch.tuning``) against the
JAX package's, on the CPU: ParamGridBuilder, CrossValidator and
TrainValidationSplit with their models.

Both packages split the rows with the same seeded numpy permutation, so
each fold trains on the same rows. The inner fits are the port's float64
linear trainers, held against JAX's on a one-device mesh; the fold
metrics (areaUnderROC, rmse, float64 numpy over the folds' predictions)
agree within ``METRIC_TOL``, and the chosen parameter is the same. A
tuning model saved by JAX loads in the port and predicts the same.

JAX's fused pipeline executor needs ``jax.experimental.enable_x64``, which
the JAX on this host lacks, so the JAX side of the pipeline case runs its
stages one by one (``pipeline_fusion.set_enabled(False)``); the port's
runs fused.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import flinkml_tpu as jfml
import flinkml_tpu.models as jm
import flinkml_tpu_torch as fml
import flinkml_tpu_torch.models as tm
from flinkml_tpu import pipeline_fusion as jfusion
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.io.read_write import load_stage
from flinkml_tpu_torch.table import Table

METRIC_TOL = 1e-9
PRED_TOL = 1e-9


@pytest.fixture(autouse=True)
def _cpu():
    with fml.use_device("cpu"):
        yield


def _jmesh1():
    return JMesh({"data": 1}, jax.devices()[:1])


def _binary(n=240, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5))
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(float)
    return {"features": x, "label": y}


def _lr(pkg, jax_side, cls="LogisticRegression", max_iter=30):
    est = getattr(pkg, cls)(mesh=_jmesh1()) if jax_side else \
        getattr(pkg, cls)()
    return est.set_max_iter(max_iter).set_global_batch_size(512) \
        .set_learning_rate(1.0).set_seed(0)


def _pkgs():
    return ((jfml, jm, JTable, True), (fml, tm, Table, False))


def _cv(root, models, lr, grid_values, folds=3, seed=0, evaluator=None):
    grid = root.ParamGridBuilder().add_grid(
        lr, models.LogisticRegression.REG, grid_values).build()
    cv = root.CrossValidator(lr, grid, evaluator
                             or models.BinaryClassificationEvaluator())
    return cv.set_num_folds(folds).set_seed(seed)


def test_param_grid_builder_matches_jax():
    for root, models, _, jax_side in _pkgs():
        lr = _lr(models, jax_side)
        grid = (root.ParamGridBuilder()
                .add_grid(lr, models.LogisticRegression.REG, [0.0, 0.1, 1.0])
                .add_grid(lr, models.LogisticRegression.MAX_ITER, [10, 20])
                .build())
        assert len(grid) == 6 and all(len(m) == 2 for m in grid)
        assert [(p.name, v) for m in grid for _, p, v in m][:4] == [
            ("reg", 0.0), ("maxIter", 10), ("reg", 0.0), ("maxIter", 20)]
        with pytest.raises(ValueError, match="empty"):
            root.ParamGridBuilder().add_grid(
                lr, models.LogisticRegression.REG, [])
        with pytest.raises(ValueError, match="not defined"):
            root.ParamGridBuilder().add_grid(
                lr, models.GBTRegressor.NUM_TREES, [5])


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_validator_matches_jax(seed, tmp_path):
    cols = _binary(seed=seed)
    out = []
    for root, models, table, jax_side in _pkgs():
        model = _cv(root, models, _lr(models, jax_side),
                    [0.0, 0.01, 0.1], seed=seed).fit(table(cols))
        out.append(model)
    jmodel, pmodel = out
    assert pmodel.best_index == jmodel.best_index
    np.testing.assert_allclose(pmodel.avg_metrics, jmodel.avg_metrics,
                               rtol=METRIC_TOL, atol=METRIC_TOL)
    assert pmodel.param_maps_description == jmodel.param_maps_description
    want = jmodel.transform(JTable(cols))[0]
    got = pmodel.transform(Table(cols))[0]
    np.testing.assert_allclose(got.column("rawPrediction"),
                               want["rawPrediction"], rtol=PRED_TOL,
                               atol=PRED_TOL)
    np.testing.assert_array_equal(got.column("prediction"), want["prediction"])
    # JAX's save loads in the port (the wrapper and its inner model).
    jmodel.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"))
    assert isinstance(loaded, fml.CrossValidatorModel)
    assert isinstance(loaded.best_model, tm.LogisticRegressionModel)
    assert loaded.best_index == jmodel.best_index
    assert loaded.avg_metrics == jmodel.avg_metrics
    np.testing.assert_allclose(loaded.transform(Table(cols))[0].column(
        "rawPrediction"), want["rawPrediction"], rtol=1e-12, atol=1e-12)
    loaded.save(str(tmp_path / "port"))
    back = jfml.CrossValidatorModel.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.transform(JTable(cols))[0][
        "prediction"], want["prediction"])


def test_cross_validator_planted_fault_another_split():
    """Another fold seed moves the metrics past the tolerance."""
    cols = _binary()
    jmodel = _cv(jfml, jm, _lr(jm, True), [0.0, 0.1], seed=0).fit(
        JTable(cols))
    pmodel = _cv(fml, tm, _lr(tm, False), [0.0, 0.1], seed=5).fit(
        Table(cols))
    assert np.abs(np.subtract(pmodel.avg_metrics,
                              jmodel.avg_metrics)).max() > 1e3 * METRIC_TOL


def test_train_validation_split_smaller_better_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 4))
    cols = {"features": x,
            "label": x @ np.asarray([1.0, -2.0, 0.5, 0.0])
            + 0.1 * rng.normal(size=300)}
    out = []
    for root, models, table, jax_side in _pkgs():
        est = _lr(models, jax_side, "LinearRegression", max_iter=20) \
            .set_learning_rate(0.1)
        grid = root.ParamGridBuilder().add_grid(
            est, models.LinearRegression.REG, [0.0, 1.0, 10.0]).build()
        tvs = root.TrainValidationSplit(
            est, grid, models.RegressionEvaluator().set_metrics_names(
                ["rmse"]))
        out.append(tvs.set_larger_better(False).set_seed(0).fit(table(cols)))
    jmodel, pmodel = out
    assert pmodel.best_index == jmodel.best_index == 0
    np.testing.assert_allclose(pmodel.avg_metrics, jmodel.avg_metrics,
                               rtol=METRIC_TOL, atol=METRIC_TOL)
    jmodel.save(str(tmp_path / "tvs"))
    loaded = load_stage(str(tmp_path / "tvs"))
    assert isinstance(loaded, fml.TrainValidationSplitModel)
    np.testing.assert_allclose(
        loaded.transform(Table(cols))[0].column("prediction"),
        jmodel.transform(JTable(cols))[0]["prediction"], rtol=1e-12,
        atol=1e-12)


def test_tuning_over_pipeline_inner_stage_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(200, 4))
    cols = {"input": x, "label": (x[:, 0] > 0).astype(float)}
    out = []
    jfusion.set_enabled(False)
    try:
        for root, models, table, jax_side in _pkgs():
            lr = _lr(models, jax_side).set_features_col("features")
            pipe = root.Pipeline([
                models.StandardScaler().set_input_col("input")
                .set_output_col("features"), lr])
            grid = root.ParamGridBuilder().add_grid(
                lr, models.LogisticRegression.REG, [0.0, 50.0]).build()
            cv = root.CrossValidator(
                pipe, grid, models.BinaryClassificationEvaluator())
            out.append(cv.set_num_folds(2).set_seed(0).fit(table(cols)))
        jmodel, pmodel = out
        assert pmodel.best_index == jmodel.best_index == 0
        np.testing.assert_allclose(pmodel.avg_metrics, jmodel.avg_metrics,
                                   rtol=METRIC_TOL, atol=METRIC_TOL)
        got = pmodel.transform(Table(cols))[0].column("prediction")
        want = jmodel.transform(JTable(cols))[0]["prediction"]
    finally:
        jfusion.set_enabled(True)
    np.testing.assert_array_equal(got, want)
    assert (got == cols["label"]).mean() > 0.9


def test_metric_name_selection_matches_jax():
    cols = _binary(seed=3)
    out = []
    for root, models, table, jax_side in _pkgs():
        ev = models.BinaryClassificationEvaluator().set_metrics_names(
            ["areaUnderPR", "areaUnderROC"])
        cv = _cv(root, models, _lr(models, jax_side), [0.0], folds=2,
                 evaluator=ev).set_metric_name("areaUnderROC")
        out.append(cv.fit(table(cols)).avg_metrics)
    np.testing.assert_allclose(out[1], out[0], rtol=METRIC_TOL,
                               atol=METRIC_TOL)
    assert 0.5 < out[1][0] <= 1.0


def test_refusals_match_jax():
    cols = _binary(n=20)
    for root, models, table, jax_side in _pkgs():
        lr = _lr(models, jax_side)
        grid = root.ParamGridBuilder().add_grid(
            lr, models.LogisticRegression.REG, [0.0]).build()
        with pytest.raises(ValueError, match="estimator and evaluator"):
            root.CrossValidator(None, grid, None).fit(table(cols))
        cv = root.CrossValidator(lr, grid,
                                 models.BinaryClassificationEvaluator())
        with pytest.raises(ValueError, match="rows < numFolds"):
            cv.set_num_folds(30).fit(table(cols))
        with pytest.raises(ValueError, match="empty split"):
            root.TrainValidationSplit(
                lr, grid, models.BinaryClassificationEvaluator()) \
                .set_train_ratio(0.01).fit(table(cols))
