"""The multi-rank cases of the port's device-side catalog (GBT and random
forests in RAM and streamed, GaussianMixture, PCA, Correlation), run by
``tests/_torch_mesh_worker.py catalog_b`` on P gloo ranks on the CPU.

Imports numpy, torch and the port only. The input builders are shared
with ``tests/test_torch_catalog_b_mesh.py``, which feeds the same numpy
inputs to the JAX package on a P-device mesh. In-RAM fits give every
rank the whole table; streamed fits give rank ``r`` the ``r``-th block of
every combined batch, so the JAX one-process fit on a P-device mesh over
the combined batches holds each rank's rows on its device.
"""

from __future__ import annotations

import numpy as np

FOREST_KW = dict(num_trees=6, max_depth=3, max_bins=16, seed=4)
STREAM_ROWS = 80          # rows of each rank's block of a combined batch
STREAM_BATCHES = 4
GMM_KW = dict(k=3, max_iter=12, tol=1e-7, seed=2)


def forest_data(n=601, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, 5))
    y = ((x[:, 0] * x[:, 1] > 0) ^ (rng.uniform(size=n) < 0.1)).astype(
        np.float64)
    return x, y


def stream_blocks(world: int, seed=3):
    """``[batch][rank]`` blocks of ``STREAM_ROWS`` float32 rows, features
    ``x`` and labels ``y``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STREAM_BATCHES):
        x = rng.uniform(-1, 1, size=(world * STREAM_ROWS, 4)).astype(
            np.float32)
        y = (x[:, 0] * x[:, 1] + 0.5 * x[:, 2] > 0).astype(np.float32)
        out.append([{"x": x[r * STREAM_ROWS:(r + 1) * STREAM_ROWS],
                     "y": y[r * STREAM_ROWS:(r + 1) * STREAM_ROWS],
                     "w": np.ones(STREAM_ROWS, np.float32)}
                    for r in range(world)])
    return out


def combined_batches(world: int):
    return [{k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
            for blocks in stream_blocks(world)]


def gmm_data(n_per=120, seed=5):
    rng = np.random.default_rng(seed)
    centers = np.asarray([[0.0, 0.0, 0.0], [7.0, 0.0, 1.0], [0.0, 7.0, -1.0]])
    x = np.concatenate([c + rng.normal(scale=(0.6, 1.0, 0.8), size=(n_per, 3))
                        for c in centers])
    return x[rng.permutation(len(x))]


def pca_data(n=480, seed=6):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 3)) * np.asarray([4.0, 2.0, 0.5])
    return (z @ rng.normal(size=(3, 6)) + 2.0).astype(np.float32)


def _setup(est, **kw):
    for name, v in kw.items():
        getattr(est, f"set_{name}")(v)
    return est


def catalog_b_cases(mesh, rank: int, world: int) -> dict:
    from flinkml_tpu_torch.iteration.datacache import cache_stream
    from flinkml_tpu_torch.models import (
        PCA,
        Correlation,
        GaussianMixture,
        GBTClassifier,
        RandomForestClassifier,
    )
    from flinkml_tpu_torch.models._gbt_stream import train_gbt_stream
    from flinkml_tpu_torch.table import Table

    out = {}
    x, y = forest_data()
    t = Table({"features": x, "label": y})
    for name, est in (
            ("gbt_segment", GBTClassifier(mesh=mesh, hist_layout="segment")),
            ("gbt_cumsum", GBTClassifier(mesh=mesh, hist_layout="cumsum")),
            ("rf", RandomForestClassifier(mesh=mesh))):
        kw = dict(FOREST_KW, subsample=0.8)
        if name == "rf":
            kw["feature_subset_fraction"] = 0.6
        m = _setup(est, **kw).fit(t)
        for a in ("feats", "thrs", "gains", "leaves"):
            out[f"{name}_{a}"] = getattr(m, f"_{a}")

    mine = [blocks[rank] for blocks in stream_blocks(world)]
    res = train_gbt_stream(
        cache_stream(iter(mine)), mesh=mesh, logistic=True, num_trees=5,
        depth=3, max_bins=16, learning_rate=0.3, reg_lambda=1.0,
        subsample=1.0, seed=0, reservoir_capacity=1 << 16)
    for name, a in zip(("feats", "bins", "gains", "leaves", "base", "edges"),
                       res):
        out[f"stream_{name}"] = np.asarray(a)

    xg = gmm_data()
    g = _setup(GaussianMixture(mesh=mesh), **GMM_KW).fit(
        Table({"features": xg}))
    out["gmm_means"], out["gmm_covs"] = g.means, g.covariances
    out["gmm_weights"] = g.weights
    block = len(xg) // world
    parts = [{"x": xg[rank * block:(rank + 1) * block][i:i + 60].astype(
        np.float32)} for i in range(0, block, 60)]
    gs = _setup(GaussianMixture(mesh=mesh), **dict(GMM_KW, max_iter=40)) \
        .set_features_col("x").fit(cache_stream(iter(parts)))
    out["gmm_stream_means"], out["gmm_stream_weights"] = gs.means, gs.weights

    xp = pca_data()
    p = PCA(mesh=mesh).set_input_col("f").set_k(3).fit(Table({"f": xp}))
    out["pca_components"] = p.components
    out["pca_variance"] = p.explained_variance
    pblock = len(xp) // world
    pb = [{"f": xp[rank * pblock:(rank + 1) * pblock][i:i + 80]}
          for i in range(0, pblock, 80)]
    ps = PCA(mesh=mesh).set_input_col("f").set_k(3).fit(
        cache_stream(iter(pb)))
    out["pca_stream_components"] = ps.components
    out["pca_stream_mean"] = ps._mean
    out["corr"] = Correlation(mesh=mesh).transform(
        Table({"features": xp}))[0].column("corr")[0]
    return out
