"""The device-side catalog of the port on two gloo ranks, against the JAX
package on a two-device mesh, on the CPU.

Two ranks (``tests/_torch_mesh_worker.py catalog_b``, the rank body
``tests/_torch_catalog_cases.py::catalog_b_cases``, started once for the
module) fit the in-RAM forests (GBT with both histogram layouts and a
random forest with Poisson bagging and feature subsets: each rank draws
its block's weights from the tree's key, as every JAX shard does), the
streamed GBT over each rank's partition, GaussianMixture in RAM and
streamed, PCA in RAM and streamed, and Correlation. Every output is the
same bits on both ranks. Against JAX on ``JMesh({"data": 2},
jax.devices()[:2])``:

  - the forests by ``chip_smoke.forest_parting``'s near-tie rule (splits
    equal, leaves within 1e-5, up to a node whose best gains tie within
    1e-4), in RAM and streamed (JAX's one-process streamed fit over the
    combined batches, each rank's block one device's shard, exact edges:
    the reservoir holds every row);
  - GMM in RAM within 1e-4 of each array's scale (the same init on every
    rank), PCA and Correlation within 1e-4;
  - the streamed GMM seeds from the ranks' pooled reservoir sample, which
    the one-process JAX fit draws otherwise: it is held at its converged
    mixture (components matched by their means) within 1e-3; the
    streamed PCA agrees its shift from rank 0's first row, the combined
    stream's first row, and its components within 1e-4.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest

import flinkml_tpu.models as jm
from flinkml_tpu.iteration.datacache import cache_stream as jcache_stream
from flinkml_tpu.models._gbt_stream import train_gbt_stream as jtrain
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from tests import _torch_catalog_cases as cases
from tests.test_torch_tensor_parallel import launch, same_on_every_rank

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

P = 2


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return launch("catalog_b", P, str(tmp_path_factory.mktemp("catalog_b")))


def _jmesh():
    return JMesh({"data": P}, jax.devices()[:P])


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _rank_forest(outs, name):
    return tuple(same_on_every_rank(outs, f"{name}_{a}")
                 for a in ("feats", "thrs", "gains", "leaves"))


@pytest.mark.parametrize("name", ["gbt_segment", "gbt_cumsum", "rf"])
def test_in_ram_forest_on_two_ranks_matches_jax(outs, monkeypatch, name):
    monkeypatch.setenv("FLINKML_TPU_GBT_HISTOGRAM",
                       "cumsum" if name == "gbt_cumsum" else "segment")
    x, y = cases.forest_data()
    cls = jm.RandomForestClassifier if name == "rf" else jm.GBTClassifier
    kw = dict(cases.FOREST_KW, subsample=0.8)
    if name == "rf":
        kw["feature_subset_fraction"] = 0.6
    jmodel = cases._setup(cls(mesh=_jmesh()), **kw).fit(
        JTable({"features": x, "label": y}))
    report, problems = chip_smoke.forest_parting(
        chip_smoke.forest_arrays(jmodel), _rank_forest(outs, name),
        name != "rf")
    assert not problems, problems
    if report["ties"]:
        print(f"{name} P=2: near ties {report['ties']}")
    assert report["equal_trees"] >= 1


def test_streamed_gbt_on_two_ranks_matches_jax(outs):
    want = jtrain(jcache_stream(iter(cases.combined_batches(P))),
                  mesh=_jmesh(), logistic=True, num_trees=5, depth=3,
                  max_bins=16, learning_rate=0.3, reg_lambda=1.0,
                  subsample=1.0, seed=0, reservoir_capacity=1 << 16)
    got = [same_on_every_rank(outs, f"stream_{a}")
           for a in ("feats", "bins", "gains", "leaves", "base", "edges")]
    np.testing.assert_array_equal(got[5], np.asarray(want[5]))
    assert float(got[4]) == pytest.approx(want[4], rel=1e-12)

    def forest(r):   # equal edges: comparing bins compares thresholds
        return tuple(np.asarray(a) for a in r[:4])

    report, problems = chip_smoke.forest_parting(forest(want), forest(got),
                                                 True)
    assert not problems, problems
    if not report["ties"]:
        np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=1e-5,
                                   atol=1e-6)


def test_gmm_on_two_ranks_matches_jax(outs):
    xg = cases.gmm_data()
    kw = cases.GMM_KW
    jmodel = (jm.GaussianMixture(mesh=_jmesh()).set_k(kw["k"])
              .set_max_iter(kw["max_iter"]).set_tol(kw["tol"])
              .set_seed(kw["seed"]).fit(JTable({"features": xg})))
    _close(same_on_every_rank(outs, "gmm_means"), jmodel.means, 1e-4)
    _close(same_on_every_rank(outs, "gmm_covs"), jmodel.covariances, 1e-4)
    _close(same_on_every_rank(outs, "gmm_weights"), jmodel.weights, 1e-4)


def test_streamed_gmm_on_two_ranks_converges_with_jax(outs):
    xg = cases.gmm_data()
    block = len(xg) // P
    combined = [{"x": np.concatenate(
        [xg[r * block:(r + 1) * block][i:i + 60] for r in range(P)]).astype(
        np.float32)} for i in range(0, block, 60)]
    kw = cases.GMM_KW
    jmodel = (jm.GaussianMixture(mesh=_jmesh()).set_k(kw["k"])
              .set_max_iter(40).set_tol(kw["tol"]).set_seed(kw["seed"])
              .set_features_col("x").fit(jcache_stream(iter(combined))))
    got = same_on_every_rank(outs, "gmm_stream_means")
    order_g = np.lexsort(got.T[::-1])
    order_j = np.lexsort(jmodel.means.T[::-1])
    _close(got[order_g], jmodel.means[order_j], 1e-3)
    _close(same_on_every_rank(outs, "gmm_stream_weights")[order_g],
           jmodel.weights[order_j], 1e-3)


def test_pca_and_correlation_on_two_ranks_match_jax(outs):
    xp = cases.pca_data()
    jmodel = jm.PCA(mesh=_jmesh()).set_input_col("f").set_k(3).fit(
        JTable({"f": xp}))
    _close(same_on_every_rank(outs, "pca_components"), jmodel.components,
           1e-4)
    _close(same_on_every_rank(outs, "pca_variance"),
           jmodel.explained_variance, 1e-4)
    block = len(xp) // P
    combined = [{"f": np.concatenate([xp[r * block:(r + 1) * block][i:i + 80]
                                      for r in range(P)])}
                for i in range(0, block, 80)]
    js = jm.PCA(mesh=_jmesh()).set_input_col("f").set_k(3).fit(
        jcache_stream(iter(combined)))
    _close(same_on_every_rank(outs, "pca_stream_components"), js.components,
           1e-4)
    _close(same_on_every_rank(outs, "pca_stream_mean"), js._mean, 1e-5)
    (jc,) = jm.Correlation(mesh=_jmesh()).transform(JTable({"features": xp}))
    _close(same_on_every_rank(outs, "corr"), np.asarray(jc["corr"])[0], 1e-4)
