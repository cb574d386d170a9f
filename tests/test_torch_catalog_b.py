"""GaussianMixture, PCA, Correlation, PowerIterationClustering, the feature
tests and selectors, KBinsDiscretizer and AFTSurvivalRegression of the
port against the JAX package, on the CPU.

The JAX references run on a one-device mesh (``JMesh({"data": 1},
jax.devices()[:1])``) with the same tables and seeds. Tolerances:

  - host-only math (the chi-square and F tests, their selectors,
    ``KBinsDiscretizer``'s edges, Spearman's ranks, the 1-D k-means):
    equal bit for bit;
  - float32 device passes (PCA's and Correlation's gram, the variance,
    GMM's E-step, PIC's power iterate): rtol 1e-5 on the statistics, 1e-4
    on PCA components and correlations, where the float32 matmuls and
    sums of XLA and PyTorch add in different orders; GMM's parameters
    after its EM iterations within 1e-4 (relative to each array's
    scale), the same init and the same assignments; PIC's labels equal;
  - AFT's Adam fit (the same threefry draws): coefficients and scale
    within 1e-5 after 300 steps.

The port's own cases mirror ``tests/test_gmm.py``, ``test_pca.py``,
``test_pic.py``, ``test_selectors.py``, ``test_discretizer_stats.py``,
the AFT half of ``test_survival_fpgrowth.py`` and the PCA half of
``test_stream_fit_mlp_pca.py`` (sklearn, scipy and numpy references), the
streamed GMM of ``test_stream_fit.py`` and its resume of
``test_stream_resume.py``; every model saved by JAX loads in the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.stats import chi2_contingency, pearsonr, spearmanr
from sklearn.decomposition import PCA as SkPCA
from sklearn.feature_selection import VarianceThreshold
from sklearn.metrics import adjusted_rand_score
from sklearn.preprocessing import KBinsDiscretizer as SkKBins

import flinkml_tpu.models as jm
import flinkml_tpu.models.pic as jpic
import flinkml_tpu.models.selectors as jsel
import flinkml_tpu.models.stats as jstats
import flinkml_tpu_torch as fml
import flinkml_tpu_torch.models as tm
from flinkml_tpu.iteration.datacache import cache_stream as jcache_stream
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.io.read_write import load_stage
from flinkml_tpu_torch.iteration.checkpoint import CheckpointManager
from flinkml_tpu_torch.iteration.datacache import cache_stream
from flinkml_tpu_torch.models import gmm as pgmm
from flinkml_tpu_torch.models import pic as ppic
from flinkml_tpu_torch.models import selectors as psel
from flinkml_tpu_torch.models import stats as pstats
from flinkml_tpu_torch.table import Table


@pytest.fixture(autouse=True)
def _cpu():
    with fml.use_device("cpu"):
        yield


def _jmesh1():
    return JMesh({"data": 1}, jax.devices()[:1])


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _cross_load(tmp_path, jmodel, table, col, jtable=None):
    """JAX's save loads in the port with the same transform; the port's
    save loads back in JAX."""
    jmodel.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"))
    want = np.asarray(jmodel.transform(jtable or JTable(dict(
        (k, table.column(k)) for k in table.column_names)))[0][col])
    got = loaded.transform(table)[0].column(col)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    loaded.save(str(tmp_path / "port"))
    back = type(jmodel).load(str(tmp_path / "port"))
    for name in ("_weights", "_means", "_covs", "_mean", "_components",
                 "_indices", "_edges", "_beta"):
        if hasattr(jmodel, name):
            np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                          np.asarray(getattr(jmodel, name)))
    return loaded


# -- GaussianMixture -----------------------------------------------------------

def _blobs(seed=0, n_per=150):
    rng = np.random.default_rng(seed)
    comps = [
        (np.asarray([0.0, 0.0]), np.asarray([[1.0, 0.6], [0.6, 1.0]])),
        (np.asarray([6.0, 0.0]), np.asarray([[0.5, 0.0], [0.0, 2.0]])),
        (np.asarray([0.0, 6.0]), np.asarray([[1.5, -0.5], [-0.5, 0.7]])),
    ]
    xs, ys = [], []
    for i, (m, c) in enumerate(comps):
        xs.append(rng.multivariate_normal(m, c, size=n_per))
        ys.append(np.full(n_per, i))
    return np.concatenate(xs), np.concatenate(ys)


def _gmm(pkg, k=3, cov="full", iters=100, seed=1, **kw):
    cls = pkg.GaussianMixture
    est = cls(**kw) if pkg is tm else cls(mesh=_jmesh1(), **kw)
    return (est.set_k(k).set_covariance_type(cov).set_max_iter(iters)
            .set_tol(1e-7).set_seed(seed))


@pytest.mark.parametrize("cov", ["full", "diag"])
def test_gmm_matches_jax(cov, tmp_path):
    x, y = _blobs(seed=2)
    jmodel = _gmm(jm, cov=cov, iters=15, seed=3).fit(JTable({"features": x}))
    pmodel = _gmm(tm, cov=cov, iters=15, seed=3).fit(Table({"features": x}))
    for a in ("weights", "means", "covariances"):
        _close(getattr(pmodel, a), getattr(jmodel, a), 1e-4)
    t = Table({"features": x})
    pout = pmodel.transform(t)[0]
    jout = jmodel.transform(JTable({"features": x}))[0]
    np.testing.assert_array_equal(pout.column("prediction"),
                                  np.asarray(jout["prediction"]))
    _close(pout.column("rawPrediction"), jout["rawPrediction"], 1e-4)
    _cross_load(tmp_path, jmodel, t, "prediction")


def test_gmm_em_statistics_match_jax():
    """One E-step's statistics against the JAX step on the same inputs."""
    from flinkml_tpu.models.gmm import _em_step_fn

    x, _ = _blobs(seed=4, n_per=50)
    x = x - x.mean(0)
    rng = np.random.default_rng(0)
    for cov, covs in (("diag", rng.uniform(0.5, 2, (3, 2))),
                      ("full", np.stack([np.eye(2) * s for s in
                                         (0.7, 1.0, 1.6)]))):
        weights, means = np.asarray([0.2, 0.3, 0.5]), rng.normal(size=(3, 2))
        f32 = lambda a: jnp.asarray(a, jnp.float32)
        want = _em_step_fn(_jmesh1().mesh, "data", 3, cov)(
            f32(x), f32(np.ones(len(x))), f32(weights), f32(means), f32(covs))
        import torch
        got = pgmm.unpack_statistics(pgmm.em_statistics(
            torch.from_numpy(x.astype(np.float32)),
            torch.ones(len(x)), weights, means, covs, cov), 3, 2, cov)
        for g, w in zip(got, want):
            _close(g, np.asarray(w), 1e-5)


def test_gmm_full_covariance_recovers_components():
    x, y = _blobs()
    t = Table({"features": x})
    model = _gmm(tm).fit(t)
    out = model.transform(t)[0]
    assert adjusted_rand_score(y, out.column("prediction")) > 0.9
    np.testing.assert_allclose(model.weights.sum(), 1.0, rtol=1e-9)
    assert model.weights.min() > 0.25
    np.testing.assert_allclose(out.column("rawPrediction").sum(axis=1), 1.0,
                               rtol=1e-9)


def test_gmm_diag_mode_offset_and_duplicates():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(size=(200, 3)) * np.asarray([0.5, 2, 1]),
                        rng.normal(size=(200, 3)) + 5.0])
    model = _gmm(tm, k=2, cov="diag").fit(Table({"features": x}))
    assert model.covariances.shape == (2, 3)
    pred = model.transform(Table({"features": x}))[0].column("prediction")
    assert adjusted_rand_score(np.repeat([0, 1], 200), pred) > 0.95
    xb, yb = _blobs(seed=8, n_per=100)
    big = _gmm(tm, seed=9).fit(Table({"features": xb + 10_000.0}))
    assert np.isfinite(big.means).all() and big.means.min() > 9_000
    assert adjusted_rand_score(yb, big.transform(Table(
        {"features": xb + 10_000.0}))[0].column("prediction")) > 0.9
    dup = np.ones((20, 2))
    dup[10:] = 2.0
    assert np.isfinite(_gmm(tm, k=2, iters=5, seed=10).fit(
        Table({"features": dup})).means).all()
    with pytest.raises(ValueError, match="n_rows"):
        _gmm(tm, k=1000).fit(Table({"features": dup}))


def _gmm_batches(n_batches=4, rows=90, seed=0):
    x, _ = _blobs(seed=seed, n_per=n_batches * rows // 3)
    x = x[np.random.default_rng(seed).permutation(len(x))]
    return [{"x": x[i * rows:(i + 1) * rows].astype(np.float32)}
            for i in range(n_batches)]


@pytest.mark.parametrize("cov", ["full", "diag"])
def test_gmm_streamed_matches_jax(cov):
    batches = _gmm_batches()
    jmodel = _gmm(jm, cov=cov, iters=10, seed=5).set_features_col("x").fit(
        jcache_stream(iter(batches)))
    pmodel = _gmm(tm, cov=cov, iters=10, seed=5).set_features_col("x").fit(
        cache_stream(iter(batches)))
    for a in ("weights", "means", "covariances"):
        _close(getattr(pmodel, a), getattr(jmodel, a), 1e-4)


def test_gmm_stream_spilled_and_resume(tmp_path):
    batches = _gmm_batches(seed=6)
    tables = [Table({"features": b["x"]}) for b in batches]
    ram = _gmm(tm, iters=6, seed=2).fit(iter(tables))
    spilled = _gmm(tm, iters=6, seed=2, cache_dir=str(tmp_path / "s"),
                   cache_memory_budget_bytes=1).fit(iter(tables))
    np.testing.assert_array_equal(spilled.means, ram.means)
    cache = cache_stream(iter(batches))

    class Crash(CheckpointManager):
        def save(self, state, epoch, extra=None, **kw):
            p = super().save(state, epoch, extra, **kw)
            if epoch >= 3:
                raise RuntimeError("injected crash")
            return p

    golden = _gmm(tm, iters=6, seed=2).set_features_col("x").fit(cache)
    with pytest.raises(RuntimeError, match="injected"):
        _gmm(tm, iters=6, seed=2, checkpoint_manager=Crash(
            str(tmp_path / "ck")), checkpoint_interval=3).set_features_col(
            "x").fit(cache)
    resumed = _gmm(tm, iters=6, seed=2, checkpoint_manager=CheckpointManager(
        str(tmp_path / "ck")), checkpoint_interval=3,
        resume=True).set_features_col("x").fit(cache)
    for a in ("weights", "means", "covariances"):
        np.testing.assert_array_equal(getattr(resumed, a),
                                      getattr(golden, a))
    with pytest.raises(ValueError, match="requires a checkpoint_manager"):
        _gmm(tm, resume=True).set_features_col("x").fit(cache)


# -- PCA and Correlation --------------------------------------------------------

def _pca_data(n=500, d=6, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 3)) * np.asarray([5.0, 2.0, 0.5])
    return z @ rng.normal(size=(3, d)) + rng.normal(scale=0.1, size=(n, d)) \
        + 3.0


def test_pca_matches_jax_and_sklearn(tmp_path):
    x = _pca_data()
    jmodel = jm.PCA(mesh=_jmesh1()).set_input_col("f").set_output_col(
        "p").set_k(3).fit(JTable({"f": x}))
    pmodel = tm.PCA().set_input_col("f").set_output_col("p").set_k(3).fit(
        Table({"f": x}))
    _close(pmodel.components, jmodel.components, 1e-4)
    _close(pmodel.explained_variance, jmodel.explained_variance, 1e-5)
    sk = SkPCA(3).fit(x)
    np.testing.assert_allclose(np.abs(pmodel.components),
                               np.abs(sk.components_), atol=1e-4)
    np.testing.assert_allclose(pmodel.explained_variance,
                               sk.explained_variance_, rtol=1e-4)
    # Deterministic sign: each component's largest entry is positive.
    comps = pmodel.components
    assert (comps[np.arange(3), np.abs(comps).argmax(1)] > 0).all()
    _cross_load(tmp_path, jmodel, Table({"f": x}), "p")
    with pytest.raises(ValueError, match="k="):
        tm.PCA().set_input_col("f").set_k(7).fit(Table({"f": x}))


def test_pca_gram_matches_jax():
    from flinkml_tpu.models.pca import _mean_and_gram_fn

    import torch
    x = _pca_data(seed=3).astype(np.float32)
    shift = x[0]
    want = _mean_and_gram_fn(_jmesh1().mesh, "data")(
        jnp.asarray(x), jnp.ones(len(x), jnp.float32), jnp.asarray(shift))
    got = tm.pca.mean_and_gram(None, torch.from_numpy(x),
                               torch.ones(len(x)), shift)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), 1e-5)


def test_pca_stream_matches_jax_and_in_ram():
    x = _pca_data(n=640, seed=4).astype(np.float32)
    batches = [{"f": x[i:i + 160]} for i in range(0, 640, 160)]
    jmodel = jm.PCA(mesh=_jmesh1()).set_input_col("f").set_k(2).fit(
        jcache_stream(iter(batches)))
    pmodel = tm.PCA().set_input_col("f").set_k(2).fit(
        cache_stream(iter(batches)))
    _close(pmodel.components, jmodel.components, 1e-4)
    in_ram = tm.PCA().set_input_col("f").set_k(2).fit(Table({"f": x}))
    _close(pmodel.components, in_ram.components, 1e-4)
    from_tables = tm.PCA().set_input_col("f").set_k(2).fit(
        iter([Table({"f": b["f"]}) for b in batches]))
    np.testing.assert_array_equal(from_tables.components, pmodel.components)
    with pytest.raises(ValueError, match="empty"):
        tm.PCA().set_input_col("f").fit(iter([]))


@pytest.mark.parametrize("method", ["pearson", "spearman"])
def test_correlation_matches_jax_and_scipy(method):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 4))
    x[:, 1] = x[:, 0] * 2 + rng.normal(scale=0.5, size=300)
    x[:, 2] = np.round(x[:, 2])          # ties for Spearman's ranks
    (jout,) = jm.Correlation(mesh=_jmesh1()).set_method(method).transform(
        JTable({"features": x}))
    (pout,) = tm.Correlation().set_method(method).transform(
        Table({"features": x}))
    got = pout.column("corr")[0]
    _close(got, np.asarray(jout["corr"])[0], 1e-4)
    ref = spearmanr(x).statistic if method == "spearman" else np.corrcoef(
        x, rowvar=False)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(pstats._average_ranks(x[:, 2]),
                                  jstats._average_ranks(x[:, 2]))
    assert got[0, 1] == pytest.approx(pearsonr(x[:, 0], x[:, 1])[0],
                                      abs=1e-4) or method == "spearman"


def test_correlation_constant_columns():
    x = np.random.default_rng(0).normal(size=(50, 3))
    x[:, 1] = 4.0
    corr = tm.Correlation().transform(Table({"features": x}))[0].column(
        "corr")[0]
    assert np.isnan(corr[1, 0]) and corr[1, 1] == 1.0


# -- PowerIterationClustering -----------------------------------------------------

def _block_graph(sizes=(40, 40), p_in=0.5, p_out=0.01, seed=0):
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    iu = np.triu_indices(n, 1)
    p = np.where(labels[iu[0]] == labels[iu[1]], p_in, p_out)
    keep = rng.uniform(size=p.size) < p
    return iu[0][keep], iu[1][keep], labels


@pytest.mark.parametrize("sizes,k", [((40, 40), 2), ((30, 30, 30), 3)])
def test_pic_matches_jax(sizes, k):
    src, dst, truth = _block_graph(sizes=sizes, seed=k)
    w = np.random.default_rng(1).uniform(0.5, 1.5, len(src))
    kw = dict(k=k, max_iter=30, weight_col="w", seed=0)

    def run(op, table_cls):
        for name, v in kw.items():
            getattr(op, f"set_{name}")(v)
        return op.transform(table_cls({"src": src, "dst": dst, "w": w}))[0]

    jout = run(jm.PowerIterationClustering(), JTable)
    pout = run(tm.PowerIterationClustering(), Table)
    np.testing.assert_array_equal(pout.column("id"), np.asarray(jout["id"]))
    np.testing.assert_array_equal(pout.column("prediction"),
                                  np.asarray(jout["prediction"]))
    order = np.argsort(pout.column("id"))
    assert adjusted_rand_score(truth, pout.column("prediction")[order]) > 0.8
    # The power iterate against JAX's and a float64 numpy iteration.
    import torch
    ids, s, d_, wn, v0, _ = ppic.pic_inputs(src, dst, w, k, 0)
    got = ppic.power_iteration(torch.from_numpy(s), torch.from_numpy(d_),
                               torch.from_numpy(wn), torch.from_numpy(v0),
                               30).numpy()
    want = np.asarray(jpic._power_iteration_fn(len(ids))(
        jnp.asarray(s), jnp.asarray(d_), jnp.asarray(wn), jnp.asarray(v0),
        jnp.asarray(30, jnp.int32)))
    _close(got, want, 1e-5)
    v = v0.astype(np.float64)
    for _ in range(30):
        v = np.bincount(s, weights=wn.astype(np.float64) * v[d_],
                        minlength=len(v))
        v /= np.abs(v).sum()
    _close(got, v, 1e-4)


def test_pic_string_ids_labeling_and_validation():
    src = np.asarray(["a", "b", "c", "x", "y", "z", "a"])
    dst = np.asarray(["b", "c", "a", "y", "z", "x", "x"])
    w = np.asarray([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.01])
    out = (tm.PowerIterationClustering().set_k(2).set_max_iter(50)
           .set_weight_col("w").set_seed(0)
           .transform(Table({"src": src, "dst": dst, "w": w}))[0])
    by_id = dict(zip(out.column("id"), out.column("prediction")))
    assert by_id["a"] == by_id["b"] == by_id["c"] != by_id["x"]
    assert by_id["x"] == by_id["y"] == by_id["z"]
    assert by_id[sorted(by_id)[0]] == 0.0
    with pytest.raises(ValueError, match="non-negative"):
        tm.PowerIterationClustering().set_weight_col("w").set_k(2).transform(
            Table({"src": np.asarray([0, 1]), "dst": np.asarray([1, 2]),
                   "w": np.asarray([1.0, -1.0])}))
    with pytest.raises(ValueError, match="vertices"):
        tm.PowerIterationClustering().set_k(5).transform(
            Table({"src": np.asarray([0]), "dst": np.asarray([1])}))
    k4 = np.asarray([(i, j) for i in range(4) for j in range(i + 1, 4)])
    const = tm.PowerIterationClustering().set_k(2).set_max_iter(60).transform(
        Table({"src": k4[:, 0], "dst": k4[:, 1]}))[0]
    assert set(np.unique(const.column("prediction"))) == {0.0}


# -- selectors ---------------------------------------------------------------------

def _cat_data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n)
    x0 = (y + rng.integers(0, 2, n)) % 4
    x1 = rng.integers(0, 5, n)
    x2 = rng.integers(0, 2, n)
    return np.stack([x0, x1, x2], axis=1).astype(float), y.astype(float)


@pytest.mark.parametrize("op", ["ChiSqTest", "ANOVATest", "FValueTest"])
def test_feature_tests_equal_jax(op):
    x, y = _cat_data(seed=2)
    if op == "FValueTest":
        y = y + np.random.default_rng(3).normal(size=len(y))
    (jout,) = getattr(jm, op)().transform(JTable({"features": x, "label": y}))
    (pout,) = getattr(tm, op)().transform(Table({"features": x, "label": y}))
    assert pout.column_names == list(jout.column_names)
    for c in pout.column_names:
        np.testing.assert_array_equal(pout.column(c), np.asarray(jout[c]))


def test_chi_square_matches_scipy():
    x, y = _cat_data()
    stats, pvals, dofs = psel.chi_square_test(x, y)
    for j in range(x.shape[1]):
        _, xi = np.unique(x[:, j], return_inverse=True)
        _, yi = np.unique(y, return_inverse=True)
        observed = np.zeros((xi.max() + 1, yi.max() + 1))
        np.add.at(observed, (xi, yi), 1)
        ref = chi2_contingency(observed, correction=False)
        assert stats[j] == pytest.approx(ref.statistic, rel=1e-10)
        assert pvals[j] == pytest.approx(ref.pvalue, rel=1e-8, abs=1e-12)
    assert pvals[0] < 1e-6 < pvals[1]


def test_variance_threshold_matches_jax_and_sklearn(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 5)) * np.asarray([1.0, 0.01, 2.0, 0.0, 0.3])
    x[:, 3] = 7.0
    jmodel = jm.VarianceThresholdSelector(mesh=_jmesh1()).set_output_col(
        "o").set_variance_threshold(0.05).fit(JTable({"features": x}))
    pmodel = tm.VarianceThresholdSelector().set_output_col(
        "o").set_variance_threshold(0.05).fit(Table({"features": x}))
    np.testing.assert_array_equal(pmodel.selected_indices,
                                  jmodel.selected_indices)
    np.testing.assert_array_equal(
        pmodel.selected_indices,
        VarianceThreshold(0.05).fit(x).get_support(indices=True))
    from flinkml_tpu_torch.parallel import DeviceMesh
    _close(psel.feature_variance(x, DeviceMesh()), x.var(0), 1e-5)
    _cross_load(tmp_path, jmodel, Table({"features": x}), "o")


@pytest.mark.parametrize("score,mode,thr", [
    ("chi2", "numTopFeatures", 1), ("fClassif", "percentile", 0.5),
    ("fClassif", "fpr", 0.05)])
def test_univariate_selector_equals_jax(score, mode, thr, tmp_path):
    x, y = _cat_data(seed=6)
    x = np.concatenate([x, np.random.default_rng(6).normal(size=(400, 2))],
                       axis=1)

    def fit(pkg, tbl):
        return (pkg.UnivariateFeatureSelector().set_output_col("o")
                .set_score_function(score).set_selection_mode(mode)
                .set_selection_threshold(thr).fit(tbl({"features": x,
                                                       "label": y})))

    jmodel, pmodel = fit(jm, JTable), fit(tm, Table)
    np.testing.assert_array_equal(pmodel.selected_indices,
                                  jmodel.selected_indices)
    _cross_load(tmp_path, jmodel, Table({"features": x}), "o")
    with pytest.raises(ValueError, match="dim"):
        pmodel.transform(Table({"features": x[:, :int(
            pmodel.selected_indices.max())]}))


def test_selection_threshold_validation():
    x, y = _cat_data()
    with pytest.raises(ValueError, match="selectionThreshold"):
        (tm.UnivariateFeatureSelector().set_selection_mode("percentile")
         .set_selection_threshold(1.5).fit(Table({"features": x,
                                                  "label": y})))
    assert psel._chi2_sf(3.0, 2) == jsel._chi2_sf(3.0, 2)
    assert psel._f_sf(2.5, 3, 40) == jsel._f_sf(2.5, 3, 40)


# -- KBinsDiscretizer ----------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["uniform", "quantile", "kmeans"])
def test_kbins_equals_jax_and_sklearn(strategy, tmp_path):
    rng = np.random.default_rng(8)
    x = np.stack([rng.normal(size=300), rng.exponential(size=300),
                  rng.integers(0, 3, 300).astype(float)], axis=1)

    def fit(pkg, tbl):
        return (pkg.KBinsDiscretizer().set_input_col("f").set_output_col("o")
                .set_num_bins(5).set_strategy(strategy).fit(tbl({"f": x})))

    jmodel, pmodel = fit(jm, JTable), fit(tm, Table)
    np.testing.assert_array_equal(pmodel.bin_edges, jmodel.bin_edges)
    probe = np.concatenate([x, x * 3 - 1])
    out = pmodel.transform(Table({"f": probe}))[0].column("o")
    np.testing.assert_array_equal(out, np.asarray(jmodel.transform(
        JTable({"f": probe}))[0]["o"]))
    assert out.min() >= 0 and out.max() <= 4
    if strategy == "uniform":
        sk = SkKBins(5, encode="ordinal", strategy="uniform").fit(x[:, :2])
        np.testing.assert_array_equal(out[:300, :2],
                                      sk.transform(x[:, :2]))
    _cross_load(tmp_path, jmodel, Table({"f": x}), "o")


# -- AFTSurvivalRegression ------------------------------------------------------------

def _weibull_data(n=2000, seed=0, censor_frac=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    beta = np.asarray([0.8, -0.5, 0.2])
    sigma = 0.5
    eps = np.log(rng.exponential(size=n))
    t_true = np.exp(x @ beta + sigma * eps)
    c_time = np.quantile(t_true, 1 - censor_frac) * rng.uniform(0.5, 1.5, n)
    observed = t_true <= c_time
    return x, np.where(observed, t_true, c_time), observed.astype(float), \
        beta, sigma


def _aft(pkg, steps=1500, **kw):
    est = pkg.AFTSurvivalRegression() if pkg is tm else \
        pkg.AFTSurvivalRegression(mesh=_jmesh1())
    est = (est.set_max_iter(steps).set_learning_rate(0.05)
           .set_global_batch_size(1024).set_tol(0.0).set_seed(0))
    for name, v in kw.items():
        getattr(est, f"set_{name}")(v)
    return est


def test_aft_matches_jax(tmp_path):
    x, t, censor, _, _ = _weibull_data(n=800, seed=3)
    kw = dict(steps=300, quantile_probabilities=[0.25, 0.5, 0.9])
    jmodel = _aft(jm, **kw).fit(JTable({"features": x, "label": t,
                                        "censor": censor}))
    pmodel = _aft(tm, **kw).fit(Table({"features": x, "label": t,
                                       "censor": censor}))
    _close(pmodel.coefficients, jmodel.coefficients, 1e-5)
    assert pmodel.scale == pytest.approx(jmodel.scale, rel=1e-5)
    assert pmodel.intercept == pytest.approx(jmodel.intercept, rel=1e-5,
                                             abs=1e-6)
    loaded = _cross_load(tmp_path, jmodel, Table({"features": x}),
                         "quantiles")
    assert loaded.scale == jmodel.scale


def test_aft_recovers_weibull_parameters_and_intercept(tmp_path):
    x, t, censor, beta, sigma = _weibull_data()
    model = _aft(tm).fit(Table({"features": x, "label": t * np.exp(2.0),
                                "censor": censor}))
    np.testing.assert_allclose(model.coefficients, beta, atol=0.1)
    assert abs(model.scale - sigma) < 0.1
    assert abs(model.intercept - 2.0) < 0.1
    model.save(str(tmp_path / "aft"))
    loaded = tm.AFTSurvivalRegressionModel.load(str(tmp_path / "aft"))
    assert loaded.intercept == model.intercept
    m2 = tm.AFTSurvivalRegressionModel()
    m2.copy_params_from(model)
    m2.set_model_data(*model.get_model_data())
    assert m2.intercept == model.intercept and m2.scale == model.scale
    out = model.transform(Table({"features": x}))[0].column("prediction")
    finite = censor == 1.0
    corr = np.corrcoef(np.log(out[finite]), np.log(t[finite]) + 2.0)[0, 1]
    assert corr > 0.65, corr


def test_aft_validation():
    x = np.zeros((3, 1))
    with pytest.raises(ValueError, match="positive"):
        _aft(tm).fit(Table({"features": x, "label": np.asarray([1.0, 0, 2]),
                            "censor": np.ones(3)}))
    with pytest.raises(ValueError, match="0/1"):
        _aft(tm).fit(Table({"features": x, "label": np.ones(3),
                            "censor": np.asarray([0.5, 1, 1])}))
    with pytest.raises(ValueError, match="censored"):
        _aft(tm).fit(Table({"features": x, "label": np.ones(3),
                            "censor": np.zeros(3)}))
    model = tm.AFTSurvivalRegressionModel()
    model._set(np.zeros(1), 1.0)
    model.set_quantile_probabilities([1.5])
    with pytest.raises(ValueError, match="quantileProbabilities"):
        model.transform(Table({"features": x}))
