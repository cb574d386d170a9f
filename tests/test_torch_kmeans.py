"""The port's batch KMeans and BisectingKMeans against the JAX package, on
the CPU.

The JAX reference runs on a one-device mesh
(``DeviceMesh(devices=jax.devices()[:1])``): the port trains on one
device, and an 8-device psum adds in another order. Inputs are seeded
numpy blobs, well separated, so no point sits on an assignment boundary.

Declared tolerances on centroids: float64 rtol/atol 1e-10 (the products
sum in another order than XLA's); float32 rtol/atol 1e-5. Assignments and
predictions must be equal.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.models import bisecting_kmeans as jax_bkm
from flinkml_tpu.models import kmeans as jax_kmeans
from flinkml_tpu.models import scalers as jax_scalers
from flinkml_tpu.parallel import DeviceMesh
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.models import kmeans as torch_kmeans
from tests._torch_port_common import (  # noqa: F401
    JAX_BACKENDS,
    jax_backend,
    jax_chain_cols,
    on_cpu,
    port_chain_cols,
)

F64_TOL = 1e-10
F32_TOL = 1e-5


def _mesh1():
    return DeviceMesh(devices=jax.devices()[:1])


def _blobs(n_per=40, k=4, d=3, seed=0, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread
    return np.concatenate([rng.normal(size=(n_per, d)) + c for c in centers])


@pytest.mark.parametrize("init_mode", ["random", "k-means++"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_TOL),
                                       (np.float32, F32_TOL)])
def test_train_kmeans_matches_jax(init_mode, dtype, tol, on_cpu):
    x = _blobs(n_per=37, seed=1).astype(dtype)   # 148 rows: padded to 152
    kw = dict(max_iter=12, seed=3, init_mode=init_mode)
    want = jax_kmeans.train_kmeans(x, 4, _mesh1(), **kw)
    got = torch_kmeans.train_kmeans(x, 4, **kw)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_seeded_init_matches_jax():
    x = _blobs(seed=2)
    for mode in ("random", "k-means++"):
        got = torch_kmeans.init_centroids(x, 4, 9, mode)
        rng = np.random.default_rng(9)
        if mode == "k-means++":
            want = jax_kmeans._kmeans_pp_init(x, 4, rng)
        else:
            want = x[rng.choice(x.shape[0], size=4, replace=False)]
        np.testing.assert_array_equal(got, want)


def test_empty_cluster_keeps_its_centroid(on_cpu):
    x = _blobs(n_per=30, k=2, seed=4)
    init = np.stack([x[0], x[-1], np.full(3, 1e6)])
    want = jax_kmeans.train_kmeans(x, 3, _mesh1(), 5, 0,
                                   initial_centroids=init)
    got = torch_kmeans.train_kmeans(x, 3, None, 5, 0, initial_centroids=init)
    np.testing.assert_array_equal(got[2], init[2])
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)


@pytest.mark.parametrize("init_mode", ["random", "k-means++"])
def test_kmeans_fit_and_transform_match_jax(init_mode, on_cpu):
    x = _blobs(seed=5)
    est_j = (jax_kmeans.KMeans(mesh=_mesh1()).set_k(4).set_max_iter(15)
             .set_seed(7).set(jax_kmeans.KMeans.INIT_MODE, init_mode))
    est_t = (fml.KMeans().set_k(4).set_max_iter(15).set_seed(7)
             .set(fml.KMeans.INIT_MODE, init_mode))
    mj = est_j.fit(JaxTable({"features": x}))
    mt = est_t.fit(fml.Table({"features": x}))
    np.testing.assert_allclose(mt.centroids, mj.centroids, rtol=F64_TOL,
                               atol=F64_TOL)
    (pj,) = mj.transform(JaxTable({"features": x}))
    (pt,) = mt.transform(fml.Table({"features": x}))
    np.testing.assert_array_equal(pt.column("prediction"),
                                  np.asarray(pj.column("prediction")))
    assert mt.get_param_map_json() == mj.get_param_map_json()


@pytest.mark.parametrize("measure", ["euclidean", "cosine", "manhattan"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kmeans_model_transform_matches_jax(measure, dtype, on_cpu):
    rng = np.random.default_rng(6)
    centroids = rng.normal(size=(5, 4)) * 3.0
    x = rng.normal(size=(70, 4)) * 3.0
    mj = jax_kmeans.KMeansModel().set_model_data(
        JaxTable({"centroids": centroids[None]}))
    mj.set(mj.DISTANCE_MEASURE, measure)
    mt = fml.stage_from_arrays(
        "flinkml_tpu.models.kmeans.KMeansModel", mj.get_param_map_json(),
        {"centroids": centroids})
    (pj,) = mj.transform(JaxTable({"features": x}))
    (pt,) = mt.transform(fml.Table({"features": x.astype(dtype)}))
    np.testing.assert_array_equal(pt.column("prediction"),
                                  np.asarray(pj.column("prediction")))


@pytest.mark.parametrize("k", [3, 5])
def test_bisecting_kmeans_matches_jax(k, on_cpu):
    x = _blobs(n_per=30, k=5, seed=k)
    mj = (jax_bkm.BisectingKMeans(mesh=_mesh1()).set_k(k).set_max_iter(10)
          .set_seed(2).fit(JaxTable({"features": x})))
    mt = (fml.BisectingKMeans().set_k(k).set_max_iter(10).set_seed(2)
          .fit(fml.Table({"features": x})))
    assert isinstance(mt, fml.BisectingKMeansModel)
    np.testing.assert_allclose(mt.centroids, mj.centroids, rtol=F64_TOL,
                               atol=F64_TOL)
    (pj,) = mj.transform(JaxTable({"features": x}))
    (pt,) = mt.transform(fml.Table({"features": x}))
    np.testing.assert_array_equal(pt.column("prediction"),
                                  np.asarray(pj.column("prediction")))


def test_bisecting_kmeans_degenerate_split_retires_leaf(on_cpu):
    x = np.ones((30, 2))
    x[15:] = 5.0
    mj = (jax_bkm.BisectingKMeans(mesh=_mesh1()).set_k(4).set_max_iter(5)
          .set_seed(1).fit(JaxTable({"features": x})))
    mt = (fml.BisectingKMeans().set_k(4).set_max_iter(5).set_seed(1)
          .fit(fml.Table({"features": x})))
    np.testing.assert_array_equal(mt.centroids, mj.centroids)


@pytest.mark.parametrize("cls_name", ["KMeansModel", "BisectingKMeansModel"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_save_load_across_packages(cls_name, saver, tmp_path, on_cpu):
    x = _blobs(seed=8)
    jax_mod = jax_kmeans if cls_name == "KMeansModel" else jax_bkm
    centroids = x[:4].copy()
    mj = getattr(jax_mod, cls_name)().set_model_data(
        JaxTable({"centroids": centroids[None]}))
    mt = getattr(fml, cls_name)().set_model_data(
        fml.Table({"centroids": centroids[None]}))
    path = str(tmp_path / "km")
    (mj if saver == "jax" else mt).save(path)
    loaded_t = fml.load_stage(path)
    loaded_j = getattr(jax_mod, cls_name).load(path)
    assert type(loaded_t).__name__ == cls_name
    np.testing.assert_array_equal(loaded_t.centroids, loaded_j.centroids)
    (a,) = loaded_t.transform(fml.Table({"features": x}))
    (b,) = loaded_j.transform(JaxTable({"features": x}))
    np.testing.assert_array_equal(a.column("prediction"),
                                  np.asarray(b.column("prediction")))


def test_kmeans_model_has_no_fused_head(on_cpu):
    """The KMeans head fuses now (it had no transform_kernel before): a
    scaler -> KMeansModel pipeline runs as ONE program whose outputs equal
    the per-stage path's, the scaler output pinned as an eager column."""
    x = _blobs(seed=9)
    t = fml.Table({"features": x})
    scaler = (fml.StandardScaler().set(fml.StandardScaler.INPUT_COL, "features")
              .set(fml.StandardScaler.OUTPUT_COL, "s").fit(t))
    km = (fml.KMeans().set_k(4).set_max_iter(10).set_seed(1)
          .set(fml.KMeans.FEATURES_COL, "s").fit(scaler.transform(t)[0]))
    assert km.transform_kernel().pin_inputs
    model = fml.PipelineModel([scaler, km])
    (fused,) = model.transform(t)
    assert pipeline_fusion.compiled_program_count() == 1
    pipeline_fusion.set_enabled(False)
    try:
        (per_stage,) = model.transform(t)
    finally:
        pipeline_fusion.set_enabled(True)
    for c in ("s", "prediction"):
        assert fused.column(c).dtype == per_stage.column(c).dtype
        np.testing.assert_array_equal(fused.column(c), per_stage.column(c))


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("with_scaler", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kmeans_transform_kernel_matches_jax(backend, with_scaler, dtype,
                                             monkeypatch, on_cpu):
    """``KMeansModel.transform_kernel`` alone and after a StandardScaler:
    the port's plain chain against the JAX chain function (XLA, and the
    Pallas chain kernel interpreted) — the same assignments on blobs with
    no point near a boundary; the port's per-stage transform agrees. The
    int64 index is the JAX package's under x64."""
    x = _blobs(n_per=30, k=5, d=6, seed=11).astype(dtype)
    centroids = _blobs(n_per=1, k=5, d=6, seed=11, spread=8.0)
    jm = jax_kmeans.KMeansModel().set_model_data(
        JaxTable({"centroids": centroids[None]}))
    tm = fml.KMeansModel().set_model_data(
        fml.Table({"centroids": centroids[None]}))
    jax_stages, port_stages = [jm], [tm]
    if with_scaler:
        sj = jax_scalers.StandardScaler().set_input_col("features") \
            .set_output_col("s").fit(JaxTable({"features": x}))
        st = fml.stage_from_arrays(
            "flinkml_tpu.models.scalers.StandardScalerModel",
            sj.get_param_map_json(),
            {c: sj.get_model_data()[0].column(c) for c in ("mean", "std")})
        jm.set_features_col("s")
        tm.set_features_col("s")
        jax_stages.insert(0, sj)
        port_stages.insert(0, st)
    jax_backend(monkeypatch, backend, "fused_chain")
    want = jax_chain_cols([s.transform_kernel() for s in jax_stages],
                          {"features": x}, backend)
    got = port_chain_cols([s.transform_kernel() for s in port_stages],
                          {"features": x})
    assert got["prediction"].dtype == want["prediction"].dtype == np.int64
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    (per_stage,) = fml.PipelineModel(port_stages).transform(
        fml.Table({"features": x}))
    np.testing.assert_array_equal(per_stage.column("prediction"),
                                  got["prediction"])
    assert fml.KMeansModel().transform_kernel() is None
    assert tm.set_distance_measure("cosine").transform_kernel() is None


def test_kmeans_refusals(on_cpu):
    x = _blobs(seed=10)
    t = fml.Table({"features": x})
    # The streamed fit and its knobs are ported (item 6): a stream of
    # Tables fits, and the in-RAM fit refuses the checkpoint knobs as the
    # JAX package does (ValueError), the cache knobs being the stream's.
    streamed = fml.KMeans().set_seed(1).fit([t, t])
    assert streamed.centroids.shape == (2, 3)
    assert np.isfinite(streamed.centroids).all()
    # mesh= is ported (item 7a; P ranks in test_torch_data_parallel.py):
    # it takes a DeviceMesh, and a world-1 mesh fits as no mesh does.
    with pytest.raises(TypeError, match="DeviceMesh"):
        fml.KMeans(mesh=object())
    from flinkml_tpu_torch.parallel import DeviceMesh as TorchMesh

    np.testing.assert_array_equal(
        fml.KMeans(mesh=TorchMesh()).set_seed(1).fit(t).centroids,
        fml.KMeans().set_seed(1).fit(t).centroids)
    for knobs in ({"checkpoint_manager": object()}, {"resume": True}):
        with pytest.raises(ValueError, match="streamed fits only"):
            fml.KMeans(**knobs).fit(t)
        with pytest.raises(ValueError, match="streamed fits only"):
            jax_kmeans.KMeans(mesh=_mesh1(), **knobs).fit(JaxTable(
                {"features": x}))
    # Sharding plans and precision policies (items 7b and 3) are ported
    # for the linear family only: KMeans refuses both at construction
    # with JAX's message, in both packages.
    from flinkml_tpu_torch.sharding import FSDP

    for knobs in ({"sharding_plan": FSDP}, {"precision": "mixed"}):
        name = next(iter(knobs))
        for cls in (fml.KMeans, jax_kmeans.KMeans):
            with pytest.raises(ValueError,
                               match=f"KMeans does not support {name}"):
                cls(**knobs)
    in_ram = fml.KMeans(cache_dir="/nonexistent").set_seed(1).fit(t)
    assert in_ram.centroids.shape == (2, 3)
    with pytest.raises(TypeError, match="DeviceMesh"):
        torch_kmeans.train_kmeans(x, 2, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        fml.BisectingKMeans(mesh=object())
    with pytest.raises(ValueError, match="exceeds number of points"):
        fml.KMeans().set_k(500).fit(t)
    with pytest.raises(ValueError, match="euclidean"):
        fml.KMeans().set_distance_measure("cosine").fit(t)
    with pytest.raises(ValueError, match="n_rows"):
        fml.BisectingKMeans().set_k(500).fit(t)
    with pytest.raises(ValueError, match="Model data is not set"):
        fml.KMeansModel().transform(t)
