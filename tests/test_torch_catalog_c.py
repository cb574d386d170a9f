"""The host half of the port's model catalog against the JAX package, on
the CPU: the feature transforms (Normalizer, ElementwiseProduct,
VectorSlicer, PolynomialExpansion, Binarizer, Bucketizer), the misc
transforms (FeatureHasher, Interaction, DCT, StopWordsRemover,
RandomSplitter), Imputer, VectorIndexer, StringIndexer and
IndexToStringModel, SQLTransformer, FPGrowth, PrefixSpan, Swing,
AgglomerativeClustering, the four evaluators and OneVsRest.

Every host stage is the JAX package's numpy in both packages, so each is
held bit for bit: the same seeded numpy inputs go through the JAX stage
and the port's, and every output column of every output table must have
the same values (NaN where NaN), the same dtype kind and the same column
order. A fitted model saved by JAX loads in the port (``load_stage``, and
``stage_from_arrays`` from its arrays) and transforms bit for bit; the
port's save loads back in JAX. A device-resident input column gives the
same outputs as the host column.

Declared tolerances: the clustering silhouette's distances are one
float32 product (PyTorch's against XLA's), within ``SILHOUETTE_TOL``;
OneVsRest's inner LogisticRegression and LinearSVC fits are the port's
float64 linear trainer, within ``F64_FIT_TOL`` of JAX's on a one-device
mesh (``test_torch_fit.py``'s bound), and its GBT classifier by
``chip_smoke.forest_parting``'s near-tie rule (``test_torch_gbt.py``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import flinkml_tpu.models as jm
import flinkml_tpu_torch as fml
import flinkml_tpu_torch.models as tm
from flinkml_tpu.linalg import SparseVector as JSparseVector
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.io.read_write import load_stage, stage_from_arrays
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.table import Table
from tests.test_torch_gbt import assert_forests_agree

SILHOUETTE_TOL = 1e-6
F64_FIT_TOL = 1e-10


@pytest.fixture(autouse=True)
def _cpu():
    with fml.use_device("cpu"):
        yield


def _jmesh1():
    return JMesh({"data": 1}, jax.devices()[:1])


# -- comparing tables -------------------------------------------------------------

def _value(v):
    """A comparable form of one object cell: vectors by (size, indices,
    values), sequences as tuples."""
    if isinstance(v, (SparseVector, JSparseVector)):
        return ("sv", v.size(), tuple(np.asarray(v.indices).tolist()),
                tuple(np.asarray(v.values).tolist()))
    if hasattr(v, "to_array"):
        return ("dv", tuple(np.asarray(v.to_array()).tolist()))
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(_value(x) for x in v)
    if isinstance(v, float) and np.isnan(v):
        return "nan"
    return v


def assert_same_column(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == object or got.dtype == object:
        assert [_value(v) for v in got.reshape(-1)] == \
            [_value(v) for v in want.reshape(-1)], name
        return
    assert got.dtype.kind == want.dtype.kind, (name, got.dtype, want.dtype)
    if want.dtype.kind in "fc":
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.astype(want.dtype).tobytes() == want.tobytes(), name
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_same_tables(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.column_names == w.column_names
        for c in w.column_names:
            assert_same_column(g.column(c), w.column(c), c)


def _setup(stage, **params):
    for name, v in params.items():
        getattr(stage, f"set_{name}")(v)
    return stage


# -- the cases: (JAX/port stage builder, input columns) ------------------------------

def _dense(n=40, d=5, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d))
    x[3] = 0.0   # a zero row exercises the norm guard
    return x


def _tokens(rows):
    out = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        out[i] = list(r)
    return out


def _baskets(n=60, items=8, seed=1):
    rng = np.random.default_rng(seed)
    return _tokens([sorted({f"i{j}" for j in rng.choice(
        items, size=rng.integers(1, 5), p=np.linspace(2, 1, items) / np.linspace(
            2, 1, items).sum())}) for _ in range(n)])


def _sequences(n=40, seed=2):
    rng = np.random.default_rng(seed)
    return _tokens([[f"s{j}" for j in rng.integers(0, 5, rng.integers(1, 6))]
                    for _ in range(n)])


def _categorical(n=50, seed=3):
    rng = np.random.default_rng(seed)
    return {"s": rng.choice(["a", "b", "c", "d"], size=n, p=[.4, .3, .2, .1]),
            "v": rng.choice([3.0, 1.0, 2.0], size=n)}


def _with_nans(n=30, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    a[[2, 7]] = np.nan
    v = rng.integers(0, 4, size=(n, 3)).astype(np.float64)
    v[5, 1] = np.nan
    return {"a": a, "v": v}


def _hash_cols(n=30, seed=5):
    rng = np.random.default_rng(seed)
    return {"age": rng.uniform(18, 80, n), "city": rng.choice(
        ["sf", "nyc", "la"], n), "clicks": rng.integers(0, 5, n).astype(float)}


def _binary_scores(n=200, seed=6, ties=False):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=n) < 0.4).astype(np.float64)
    s = np.clip(0.3 * y + rng.uniform(size=n) * 0.7, 0, 1)
    if ties:
        s = np.round(s, 1)
    raw = np.stack([1 - s, s], axis=1)
    return {"label": y, "rawPrediction": raw,
            "prediction": (s > 0.5).astype(np.float64),
            "w": rng.uniform(0.5, 2.0, n)}


def _multiclass(n=150, seed=7):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n).astype(np.float64)
    p = np.where(rng.uniform(size=n) < 0.7, y, rng.integers(0, 3, n))
    return {"label": y, "prediction": p.astype(np.float64),
            "w": rng.uniform(0.5, 2.0, n)}


def _regression(n=120, seed=8):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=n)
    return {"label": y, "prediction": y + 0.3 * rng.normal(size=n),
            "w": rng.uniform(0.5, 2.0, n)}


def _blobs(n_per=20, seed=9):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(n_per, 2)) * 0.5 + c
                        for c in ((0, 0), (4, 0), (0, 4))])
    return {"features": x, "prediction": np.repeat([0.0, 1.0, 2.0], n_per)}


def _swing_cols(seed=10):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 12, 120)
    items = rng.integers(0, 9, 120)
    return {"user": users.astype(np.int64), "item": items.astype(np.int64)}


CASES = {
    "normalizer_p2": (lambda p: _setup(p.Normalizer(), input_col="x",
                                       output_col="o"), lambda: {"x": _dense()}),
    "normalizer_p1": (lambda p: _setup(p.Normalizer(), input_col="x",
                                       output_col="o", p=1.0),
                      lambda: {"x": _dense()}),
    "normalizer_inf": (lambda p: _setup(p.Normalizer(), input_col="x",
                                        output_col="o", p=float("inf")),
                       lambda: {"x": _dense()}),
    "elementwise_product": (
        lambda p: _setup(p.ElementwiseProduct(), input_col="x", output_col="o",
                         scaling_vec=[1.0, -2.0, 0.5, 0.0, 3.0]),
        lambda: {"x": _dense()}),
    "vector_slicer": (lambda p: _setup(p.VectorSlicer(), input_col="x",
                                       output_col="o", indices=[4, 0, 2]),
                      lambda: {"x": _dense()}),
    "polynomial_2": (lambda p: _setup(p.PolynomialExpansion(), input_col="x",
                                      output_col="o"),
                     lambda: {"x": _dense(d=3)}),
    "polynomial_3": (lambda p: _setup(p.PolynomialExpansion(), input_col="x",
                                      output_col="o", degree=3),
                     lambda: {"x": _dense(d=3)}),
    "binarizer": (lambda p: _setup(p.Binarizer(), input_cols=["a", "x"],
                                   output_cols=["oa", "ox"],
                                   thresholds=[0.0, 0.5]),
                  lambda: {"a": _dense(d=1)[:, 0], "x": _dense()}),
    "bucketizer_keep": (
        lambda p: _setup(p.Bucketizer(), input_cols=["a"], output_cols=["o"],
                         splits_array=[[-np.inf, -0.5, 0.0, 0.5, np.inf]],
                         handle_invalid="keep"),
        lambda: {"a": _with_nans()["a"]}),
    "bucketizer_skip": (
        lambda p: _setup(p.Bucketizer(), input_cols=["a"], output_cols=["o"],
                         splits_array=[[-1.0, 0.0, 1.0]],
                         handle_invalid="skip"),
        lambda: {"a": _with_nans()["a"]}),
    "feature_hasher": (
        lambda p: _setup(p.FeatureHasher(), input_cols=["age", "city",
                                                        "clicks"],
                         output_col="f", num_features=64),
        _hash_cols),
    "interaction": (lambda p: _setup(p.Interaction(), input_cols=["a", "x"],
                                     output_col="o"),
                    lambda: {"a": _dense(d=1)[:, 0], "x": _dense(d=3)}),
    "dct": (lambda p: _setup(p.DCT(), input_col="x", output_col="o"),
            lambda: {"x": _dense(d=6)}),
    "dct_inverse": (lambda p: _setup(p.DCT(), input_col="x", output_col="o",
                                     inverse=True),
                    lambda: {"x": _dense(d=6)}),
    "stop_words": (
        lambda p: _setup(p.StopWordsRemover(), input_cols=["t"],
                         output_cols=["o"]),
        lambda: {"t": _tokens([["The", "cat", "is", "on", "a", "mat"],
                               ["I", "AM", "here"], []])}),
    "stop_words_custom": (
        lambda p: _setup(p.StopWordsRemover(), input_cols=["t"],
                         output_cols=["o"], stop_words=["cat", "Mat"],
                         case_sensitive=True),
        lambda: {"t": _tokens([["The", "cat", "mat", "Mat"], ["cat"]])}),
    "random_splitter": (
        lambda p: _setup(p.RandomSplitter(), weights=[0.5, 0.3, 0.2], seed=3),
        lambda: {"x": _dense(n=80)}),
    "imputer_mean": (
        lambda p: _setup(p.Imputer(), input_cols=["a", "v"],
                         output_cols=["oa", "ov"]), _with_nans),
    "imputer_median": (
        lambda p: _setup(p.Imputer(), input_cols=["a", "v"],
                         output_cols=["oa", "ov"], strategy="median"),
        _with_nans),
    "imputer_most_frequent": (
        lambda p: _setup(p.Imputer(), input_cols=["v"], output_cols=["ov"],
                         strategy="mostFrequent"), _with_nans),
    "imputer_missing_value": (
        lambda p: _setup(p.Imputer(), input_cols=["a"], output_cols=["oa"],
                         missing_value=-999.0),
        lambda: {"a": np.asarray([1.0, -999.0, 3.0, 4.5])}),
    "vector_indexer_keep": (
        lambda p: _setup(p.VectorIndexer(), input_col="v", output_col="o",
                         max_categories=3, handle_invalid="keep"),
        lambda: {"v": _with_nans()["v"]}),
    "vector_indexer_skip": (
        lambda p: _setup(p.VectorIndexer(), input_col="v", output_col="o",
                         max_categories=4, handle_invalid="skip"),
        lambda: {"v": _with_nans()["v"]}),
    "string_indexer_freq": (
        lambda p: _setup(p.StringIndexer(), input_cols=["s", "v"],
                         output_cols=["si", "vi"],
                         string_order_type="frequencyDesc"), _categorical),
    "string_indexer_alpha": (
        lambda p: _setup(p.StringIndexer(), input_cols=["s", "v"],
                         output_cols=["si", "vi"],
                         string_order_type="alphabetDesc"), _categorical),
    "string_indexer_max_index": (
        lambda p: _setup(p.StringIndexer(), input_cols=["s"],
                         output_cols=["si"], max_index_num=2,
                         string_order_type="frequencyAsc",
                         handle_invalid="keep"), _categorical),
    "sql_arithmetic": (
        lambda p: _setup(p.SQLTransformer(), statement=(
            "SELECT *, (a + b) / 2 AS m, ABS(a) * POW(b, 2) AS q "
            "FROM __THIS__ WHERE a > -0.5 AND NOT b < -1")),
        lambda: {"a": _dense(d=1)[:, 0], "b": _dense(seed=1, d=1)[:, 0],
                 "x": _dense(), "s": np.asarray(["r%d" % i
                                                 for i in range(40)])}),
    "sql_projection": (
        lambda p: _setup(p.SQLTransformer(), statement=(
            "SELECT x, s, -a % 3 + SIGN(b) * 2 AS e FROM __THIS__")),
        lambda: {"a": _dense(d=1)[:, 0], "b": _dense(seed=1, d=1)[:, 0],
                 "x": _dense(), "s": np.asarray(["r%d" % i
                                                 for i in range(40)])}),
    "fpgrowth": (
        lambda p: _setup(p.FPGrowth(), min_support=0.1, min_confidence=0.3),
        lambda: {"items": _baskets()}),
    "prefixspan": (
        lambda p: _setup(p.PrefixSpan(), min_support=0.2,
                         max_pattern_length=4),
        lambda: {"sequence": _sequences()}),
    "swing": (lambda p: _setup(p.Swing(), k=5, min_user_behavior=2,
                               max_user_behavior=20), _swing_cols),
    "agglomerative_ward": (
        lambda p: _setup(p.AgglomerativeClustering(), num_clusters=3),
        lambda: {"features": _blobs()["features"]}),
    "agglomerative_average": (
        lambda p: _setup(p.AgglomerativeClustering(), linkage="average",
                         num_clusters=4),
        lambda: {"features": _blobs(seed=2)["features"]}),
    "agglomerative_threshold": (
        lambda p: _setup(p.AgglomerativeClustering(), linkage="complete",
                         distance_threshold=2.0),
        lambda: {"features": _blobs(seed=3)["features"]}),
    "binary_evaluator": (
        lambda p: _setup(p.BinaryClassificationEvaluator(), metrics_names=[
            "areaUnderROC", "areaUnderPR", "ks", "accuracy", "logLoss"]),
        _binary_scores),
    "binary_evaluator_weighted_ties": (
        lambda p: _setup(p.BinaryClassificationEvaluator(), weight_col="w"),
        lambda: _binary_scores(ties=True)),
    "multiclass_evaluator": (
        lambda p: _setup(p.MulticlassClassificationEvaluator(), metrics_names=[
            "accuracy", "weightedF1", "weightedPrecision", "weightedRecall"]),
        _multiclass),
    "multiclass_evaluator_weighted": (
        lambda p: _setup(p.MulticlassClassificationEvaluator(),
                         weight_col="w"), _multiclass),
    "regression_evaluator": (
        lambda p: _setup(p.RegressionEvaluator(), metrics_names=[
            "rmse", "mse", "mae", "r2", "explainedVariance"], weight_col="w"),
        _regression),
}


def _run(pkg, table_cls, name, cols):
    stage = CASES[name][0](pkg)
    table = table_cls(cols)
    if hasattr(stage, "fit"):
        model = stage.fit(table)
        return model, model.transform(table)
    return stage, stage.transform(table)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_stage_matches_jax_bit_for_bit(name):
    cols = CASES[name][1]()
    _, want = _run(jm, JTable, name, cols)
    _, got = _run(tm, Table, name, cols)
    assert_same_tables(got, want)


@pytest.mark.parametrize("name", ["normalizer_p2", "polynomial_2", "dct",
                                  "imputer_mean", "vector_indexer_keep",
                                  "agglomerative_ward", "sql_arithmetic"])
def test_device_resident_input_matches_host(name):
    cols = CASES[name][1]()
    _, want = _run(tm, Table, name, cols)
    dev = {k: (torch.from_numpy(v) if v.dtype.kind == "f" else v)
           for k, v in cols.items()}
    _, got = _run(tm, Table, name, dev)
    assert_same_tables(got, want)


def test_clustering_evaluator_matches_jax():
    cols = _blobs()
    want = jm.ClusteringEvaluator().transform(JTable(cols))[0]
    got = tm.ClusteringEvaluator().transform(Table(cols))[0]
    np.testing.assert_allclose(got.column("silhouette"),
                               want["silhouette"], rtol=SILHOUETTE_TOL)


@pytest.mark.parametrize("name", ["imputer_mean", "imputer_most_frequent",
                                  "vector_indexer_keep", "string_indexer_freq",
                                  "string_indexer_alpha", "fpgrowth"])
def test_jax_saved_model_loads_in_port(tmp_path, name):
    cols = CASES[name][1]()
    jmodel, want = _run(jm, JTable, name, cols)
    jmodel.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"))
    assert type(loaded).__name__ == type(jmodel).__name__
    assert type(loaded).__module__.startswith("flinkml_tpu_torch.")
    assert_same_tables(loaded.transform(Table(cols)), want)
    loaded.save(str(tmp_path / "port"))
    back = type(jmodel).load(str(tmp_path / "port"))
    assert_same_tables(back.transform(JTable(cols)), want)


def test_stage_from_arrays_builds_every_new_model():
    from flinkml_tpu.io.read_write import load_model_arrays, load_metadata

    import tempfile

    for name in ("imputer_mean", "vector_indexer_keep", "string_indexer_freq",
                 "fpgrowth"):
        cols = CASES[name][1]()
        jmodel, want = _run(jm, JTable, name, cols)
        with tempfile.TemporaryDirectory() as d:
            jmodel.save(d)
            arrays = load_model_arrays(d)
            meta = load_metadata(d)
        for extra in ("numFeatures", "numBaskets"):
            if extra in meta:
                arrays[extra] = np.asarray(meta[extra])
        stage = stage_from_arrays(meta["className"], meta["paramMap"], arrays)
        assert_same_tables(stage.transform(Table(cols)), want)


def test_fpgrowth_rules_and_itemsets_match_jax():
    cols = {"items": _baskets(n=80, seed=11)}
    jmodel = _setup(jm.FPGrowth(), min_support=0.08,
                    min_confidence=0.2).fit(JTable(cols))
    pmodel = _setup(tm.FPGrowth(), min_support=0.08,
                    min_confidence=0.2).fit(Table(cols))
    assert_same_tables(pmodel.freq_itemsets(), jmodel.freq_itemsets())
    assert_same_tables(pmodel.association_rules(), jmodel.association_rules())
    assert_same_tables(pmodel.get_model_data()[0], jmodel.get_model_data()[0])


def test_index_to_string_matches_jax(tmp_path):
    cols = _categorical()
    jidx = _setup(jm.StringIndexer(), input_cols=["s"], output_cols=["si"],
                  handle_invalid="keep").fit(JTable(cols))
    pidx = _setup(tm.StringIndexer(), input_cols=["s"], output_cols=["si"],
                  handle_invalid="keep").fit(Table(cols))
    idx = {"si": np.asarray([0.0, 1.0, 3.0, 4.0, 2.0])}
    jinv = jm.IndexToStringModel.from_indexer(jidx)
    pinv = tm.IndexToStringModel.from_indexer(pidx)
    for m in (jinv, pinv):
        m.set_input_cols(["si"]).set_output_cols(["s2"])
    assert_same_tables(pinv.transform(Table(idx)), jinv.transform(JTable(idx)))
    jinv.save(str(tmp_path / "inv"))
    loaded = load_stage(str(tmp_path / "inv"))
    assert_same_tables(loaded.transform(Table(idx)),
                       jinv.transform(JTable(idx)))


@pytest.mark.parametrize("build,cols,match", [
    (lambda p: _setup(p.Imputer(), input_cols=["a"], output_cols=["o"]),
     {"a": np.asarray([np.nan, np.nan])}, "no non-missing"),
    (lambda p: _setup(p.Bucketizer(), input_cols=["a"], output_cols=["o"],
                      splits_array=[[-1.0, 0.0, 1.0]]),
     {"a": np.asarray([0.5, 3.0])}, None),
    (lambda p: _setup(p.FeatureHasher(), input_cols=["v"], output_col="o"),
     {"v": np.zeros((3, 2))}, "VectorAssembler"),
    (lambda p: _setup(p.SQLTransformer(), statement="DROP TABLE x"),
     {"a": np.zeros(3)}, None),
    (lambda p: _setup(p.BinaryClassificationEvaluator(),
                      metrics_names=["nope"]),
     {"label": np.asarray([0.0, 1.0]), "rawPrediction": np.asarray([.2, .7])},
     "unsupported metrics"),
])
def test_refusals_match_jax(build, cols, match):
    stage_j, stage_p = build(jm), build(tm)

    def run(stage, table):
        return (stage.fit(table) if hasattr(stage, "fit") else
                stage.transform(table))

    with pytest.raises(Exception) as want:
        run(stage_j, JTable(cols))
    with pytest.raises(type(want.value)) as got:
        run(stage_p, Table(cols))
    assert str(got.value) == str(want.value)
    if match:
        assert match in str(got.value)


# -- OneVsRest --------------------------------------------------------------------

def _three_class(n_per=60, seed=0):
    rng = np.random.default_rng(seed)
    centers = [(5.0, 0.0), (-2.5, 4.33), (-2.5, -4.33)]
    x = np.concatenate([rng.normal(size=(n_per, 2)) * 0.6 + c
                        for c in centers])
    return x, np.repeat([0.0, 1.0, 2.0], n_per)


def _linear(pkg, cls="LogisticRegression", mesh=None, **kw):
    est = getattr(pkg, cls)(mesh=mesh) if mesh is not None else \
        getattr(pkg, cls)()
    return _setup(est, **dict(dict(max_iter=40, global_batch_size=512,
                                   learning_rate=1.0, seed=0), **kw))


@pytest.mark.parametrize("cls", ["LogisticRegression", "LinearSVC"])
def test_one_vs_rest_matches_jax(cls):
    x, y = _three_class(seed=1)
    y = y * 3 + 5      # non-contiguous class ids {5, 8, 11}
    cols = {"features": x, "label": y}
    jmodel = jm.OneVsRest(_linear(jm, cls, _jmesh1())).fit(JTable(cols))
    pmodel = tm.OneVsRest(_linear(tm, cls)).fit(Table(cols))
    np.testing.assert_array_equal(pmodel.classes, jmodel.classes)
    for pm, jmod in zip(pmodel.models, jmodel.models):
        np.testing.assert_allclose(pm.coefficient, jmod.coefficient,
                                   rtol=F64_FIT_TOL, atol=F64_FIT_TOL)
    want = jmodel.transform(JTable(cols))[0]
    got = pmodel.transform(Table(cols))[0]
    np.testing.assert_allclose(got.column("rawPrediction"),
                               want["rawPrediction"], rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(got.column("prediction"), want["prediction"])
    assert (got.column("prediction") == y).mean() > 0.9


def test_one_vs_rest_custom_columns_match_jax():
    x, y = _three_class(n_per=40, seed=4)
    cols = {"features": x, "target": y}
    jinner = _linear(jm, mesh=_jmesh1()).set_label_col("target") \
        .set_raw_prediction_col("innerRaw")
    pinner = _linear(tm).set_label_col("target") \
        .set_raw_prediction_col("innerRaw")
    jmodel = jm.OneVsRest(jinner).set_label_col("target").fit(JTable(cols))
    pmodel = tm.OneVsRest(pinner).set_label_col("target").fit(Table(cols))
    want = jmodel.transform(JTable(cols))[0]
    got = pmodel.transform(Table(cols))[0]
    np.testing.assert_allclose(got.column("rawPrediction"),
                               want["rawPrediction"], rtol=1e-9, atol=1e-9)
    assert len(np.unique(got.column("rawPrediction"))) > 10


def test_one_vs_rest_over_gbt_matches_jax(monkeypatch):
    monkeypatch.setenv("FLINKML_TPU_GBT_HISTOGRAM", "segment")
    rng = np.random.default_rng(7)
    x = rng.uniform(-2, 2, size=(240, 2))
    y = np.where(np.abs(x).sum(1) < 1.2, 0.0,
                 np.where(x[:, 0] * x[:, 1] > 0, 1.0, 2.0))
    cols = {"features": x, "label": y}
    kw = dict(num_trees=6, max_depth=3, learning_rate=0.3, seed=0)
    jmodel = jm.OneVsRest(_setup(jm.GBTClassifier(mesh=_jmesh1()),
                                 **kw)).fit(JTable(cols))
    pmodel = tm.OneVsRest(_setup(tm.GBTClassifier(), **kw)).fit(Table(cols))
    for i, (pm, jmod) in enumerate(zip(pmodel.models, jmodel.models)):
        assert_forests_agree(jmod, pm, True, f"class {i}")
    got = pmodel.transform(Table(cols))[0].column("prediction")
    assert (got == y).mean() > 0.85


def test_one_vs_rest_jax_save_loads_with_class_subdirectories(tmp_path):
    x, y = _three_class(n_per=30, seed=3)
    cols = {"features": x, "label": y}
    jmodel = jm.OneVsRest(_linear(jm, mesh=_jmesh1())).fit(JTable(cols))
    jmodel.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"))
    assert isinstance(loaded, tm.OneVsRestModel)
    assert all(isinstance(m, tm.LogisticRegressionModel)
               for m in loaded.models)
    want = jmodel.transform(JTable(cols))[0]
    got = loaded.transform(Table(cols))[0]
    np.testing.assert_allclose(got.column("rawPrediction"),
                               want["rawPrediction"], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.column("prediction"), want["prediction"])
    loaded.save(str(tmp_path / "port"))
    back = jm.OneVsRestModel.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.transform(JTable(cols))[0]["prediction"],
                                  want["prediction"])


def test_one_vs_rest_refusals_match_jax():
    t = {"features": np.zeros((4, 2)), "label": np.zeros(4)}
    t2 = {"features": np.zeros((4, 2)),
          "label": np.asarray([0.5, 1.0, 0.5, 1.0])}
    for build, cols, match in ((lambda p: p.OneVsRest(), t, "classifier"),
                               (lambda p: p.OneVsRest(_linear(p)), t,
                                "2 classes"),
                               (lambda p: p.OneVsRest(_linear(p)), t2,
                                "integral")):
        with pytest.raises(ValueError, match=match):
            build(jm).fit(JTable(cols))
        with pytest.raises(ValueError, match=match):
            build(tm).fit(Table(cols))
