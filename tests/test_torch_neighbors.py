"""The port's Knn and MinHashLSH against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. KNN
predictions must be equal (the JAX side runs under x64, the conftest
configuration; integer-valued features make float32 and float64 distances
exact, so the float32 port agrees too). MinHashLSH hashes, nearest
neighbours and joins must be equal; the ANN ranking is also held against
the stable host argsort and against ``jax.lax.top_k`` and the Pallas
``pallas_top_k`` (interpret mode) called directly on the same float64
distance vector, because the JAX ``approx_nearest_neighbors`` needs
``jax.experimental.enable_x64``, which this jax no longer has.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.kernels.topk import pallas_top_k
from flinkml_tpu.linalg import SparseVector as JaxSparseVector
from flinkml_tpu.models import knn as jax_knn
from flinkml_tpu.models import lsh as jax_lsh
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.models import knn as torch_knn
from flinkml_tpu_torch.models import lsh as torch_lsh
from tests._torch_port_common import on_cpu  # noqa: F401


def _knn_data(n_train=120, n_query=45, d=3, n_classes=4, seed=0):
    """Integer features in 0..3: many equal distances (index ties) and
    many tied votes; labels are arbitrary floats, not 0..C-1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=(n_train, d)).astype(np.float64)
    labels = np.array([-1.0, 2.5, 7.0, 10.0])[:n_classes]
    y = labels[rng.integers(0, n_classes, size=n_train)]
    q = rng.integers(0, 4, size=(n_query, d)).astype(np.float64)
    return x, y, q


def _knn_pair(x, y, k):
    jm = jax_knn.Knn().set(jax_knn.Knn.K, k).fit(
        JaxTable({"features": x, "label": y}))
    tm = fml.Knn().set(fml.Knn.K, k).fit(fml.Table({"features": x, "label": y}))
    return jm, tm


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_knn_predictions_equal_jax(k, dtype, on_cpu):
    x, y, q = _knn_data(seed=k)
    jm, tm = _knn_pair(x, y, k)
    (want,) = jm.transform(JaxTable({"features": q}))
    (got,) = tm.transform(fml.Table({"features": q.astype(dtype)}))
    np.testing.assert_array_equal(got.column("prediction"),
                                  np.asarray(want.column("prediction")))


def test_knn_duplicated_train_rows_tie_to_lower_index(on_cpu):
    """Duplicated train rows with different labels: the tie goes to the
    lower train index, in both packages."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(10, 2))
    x = np.concatenate([base, base, base])
    y = np.concatenate([np.zeros(10), np.ones(10), np.full(10, 2.0)])
    jm, tm = _knn_pair(x, y, 1)
    q = base + 1e-3
    (want,) = jm.transform(JaxTable({"features": q}))
    (got,) = tm.transform(fml.Table({"features": q}))
    np.testing.assert_array_equal(got.column("prediction"), np.zeros(10))
    np.testing.assert_array_equal(got.column("prediction"),
                                  np.asarray(want.column("prediction")))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_knn_k_200_equals_jax(dtype, on_cpu):
    """k past the Pallas kernel's 128 kept pairs: the port's top-k takes
    any k, as the JAX package's default ``lax.top_k`` does."""
    x, y, q = _knn_data(n_train=700, n_query=40, d=4, seed=12)
    jm, tm = _knn_pair(x, y, 200)
    (want,) = jm.transform(JaxTable({"features": q}))
    (got,) = tm.transform(fml.Table({"features": q.astype(dtype)}))
    np.testing.assert_array_equal(got.column("prediction"),
                                  np.asarray(want.column("prediction")))


def test_knn_k_larger_than_train_votes_among_all(on_cpu):
    x, y, q = _knn_data(n_train=13, seed=4)
    jm, tm = _knn_pair(x, y, 200)
    (want,) = jm.transform(JaxTable({"features": q}))
    (got,) = tm.transform(fml.Table({"features": q}))
    np.testing.assert_array_equal(got.column("prediction"),
                                  np.asarray(want.column("prediction")))


def test_knn_several_chunks(monkeypatch, on_cpu):
    x, y, q = _knn_data(n_query=50, seed=5)
    jm, tm = _knn_pair(x, y, 5)
    (want,) = jm.transform(JaxTable({"features": q}))
    monkeypatch.setattr(torch_knn.KnnModel, "CHUNK", 7)
    (got,) = tm.transform(fml.Table({"features": q}))
    np.testing.assert_array_equal(got.column("prediction"),
                                  np.asarray(want.column("prediction")))


def test_knn_errors_match_jax(on_cpu):
    with pytest.raises(ValueError, match="Model data is not set"):
        fml.KnnModel().transform(fml.Table({"features": np.zeros((2, 2))}))
    empty = fml.KnnModel().set_model_data(
        fml.Table({"features": np.zeros((0, 2)), "labels": np.zeros(0)}))
    with pytest.raises(ValueError, match="no training points"):
        empty.transform(fml.Table({"features": np.zeros((2, 2))}))
    assert (fml.Knn().get_param_map_json()
            == jax_knn.Knn().get_param_map_json())


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_knn_save_load_across_packages(saver, tmp_path, on_cpu):
    x, y, q = _knn_data(seed=6)
    jm, tm = _knn_pair(x, y, 3)
    path = str(tmp_path / "knn")
    (jm if saver == "jax" else tm).save(path)
    loaded_t = fml.load_stage(path)
    loaded_j = jax_knn.KnnModel.load(path)
    assert isinstance(loaded_t, fml.KnnModel) and loaded_t.get_k() == 3
    (a,) = loaded_t.transform(fml.Table({"features": q}))
    (b,) = loaded_j.transform(JaxTable({"features": q}))
    np.testing.assert_array_equal(a.column("prediction"),
                                  np.asarray(b.column("prediction")))


# -- MinHashLSH -------------------------------------------------------------------

def _lsh_rows(n=60, d=12, seed=7):
    """Low-cardinality 0/1 rows: many EQUAL Jaccard distances, so a
    tie-break difference cannot hide."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, d)) > 0.5).astype(np.float64)


def _sparse_cols(x):
    """The same rows as SparseVector object columns of both packages."""
    jcol = np.empty(len(x), dtype=object)
    tcol = np.empty(len(x), dtype=object)
    for i, row in enumerate(x):
        idx = np.nonzero(row)[0]
        jcol[i] = JaxSparseVector(x.shape[1], idx, row[idx])
        tcol[i] = SparseVector(x.shape[1], idx, row[idx])
    return jcol, tcol


def _lsh_pair(x, tables=3, seed=11):
    jm = (jax_lsh.MinHashLSH().set(jax_lsh.MinHashLSH.INPUT_COL, "f")
          .set(jax_lsh.MinHashLSH.OUTPUT_COL, "h")
          .set(jax_lsh.MinHashLSH.NUM_HASH_TABLES, tables).set_seed(seed)
          .fit(JaxTable({"f": x})))
    tm = (fml.MinHashLSH().set(fml.MinHashLSH.INPUT_COL, "f")
          .set(fml.MinHashLSH.OUTPUT_COL, "h")
          .set(fml.MinHashLSH.NUM_HASH_TABLES, tables).set_seed(seed)
          .fit(fml.Table({"f": x})))
    return jm, tm


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_minhash_family_and_hashes_equal_jax(layout, on_cpu):
    x = _lsh_rows()
    x[5] = 0.0   # an empty row hashes to PRIME
    jm, tm = _lsh_pair(x, tables=4)
    np.testing.assert_array_equal(tm._a, jm._a)
    np.testing.assert_array_equal(tm._b, jm._b)
    jcol, tcol = _sparse_cols(x) if layout == "sparse" else (x, x)
    (want,) = jm.transform(JaxTable({"f": jcol}))
    (got,) = tm.transform(fml.Table({"f": tcol}))
    np.testing.assert_array_equal(got.column("h"), np.asarray(want.column("h")))
    assert torch_lsh.PRIME == jax_lsh.PRIME
    assert (got.column("h")[5] == torch_lsh.PRIME).all()


def _golden(model, x, key):
    """The stable host argsort ranking (the JAX package's pinned order)."""
    rows = jax_lsh._active_indices(x)
    hashes = model._hash_rows(rows)
    key_idx = np.nonzero(key)[0]
    key_hash = model._hash_rows([key_idx])[0]
    cand = np.nonzero((hashes == key_hash[None, :]).any(axis=1))[0]
    dists = np.asarray([jax_lsh._jaccard_distance(rows[i], key_idx)
                        for i in cand])
    return cand, dists


@pytest.mark.parametrize("k", [3, 7, 1000])
@pytest.mark.parametrize("key_row", [0, 17])
def test_minhash_ann_ranking_pinned_order(k, key_row, on_cpu):
    """ANN rows and distances equal the stable argsort EXACTLY, and the
    port's ranking equals ``lax.top_k`` and ``pallas_top_k`` (interpret
    mode) on the same float64 distances."""
    x = _lsh_rows()
    jm, tm = _lsh_pair(x)
    cand, dists = _golden(jm, x, x[key_row])
    k_eff = min(k, dists.size)
    order = np.argsort(dists, kind="stable")[:k_eff]
    got = tm.approx_nearest_neighbors(
        fml.Table({"f": x, "id": np.arange(len(x))}), x[key_row], k)
    np.testing.assert_array_equal(got.column("id"), cand[order])
    np.testing.assert_array_equal(got.column("distCol"), dists[order])
    assert jnp.asarray(-dists).dtype == jnp.float64
    _, lax_order = jax.lax.top_k(jnp.asarray(-dists), k_eff)
    np.testing.assert_array_equal(got.column("id"), cand[np.asarray(lax_order)])
    if k_eff <= 128:
        _, pallas_order = pallas_top_k(jnp.asarray(-dists), k_eff,
                                       interpret=True)
        np.testing.assert_array_equal(got.column("id"),
                                      cand[np.asarray(pallas_order)])


@pytest.mark.parametrize("k", [129, 300])
def test_minhash_ann_past_128_results(k, on_cpu):
    """More than 128 results: rows and distances equal the stable argsort
    exactly, and the ranking equals ``lax.top_k`` on the same float64
    distances."""
    x = _lsh_rows(n=600, d=10, seed=13)
    jm, tm = _lsh_pair(x, tables=4)
    cand, dists = _golden(jm, x, x[0])
    assert dists.size > k
    order = np.argsort(dists, kind="stable")[:k]
    got = tm.approx_nearest_neighbors(
        fml.Table({"f": x, "id": np.arange(len(x))}), x[0], k)
    np.testing.assert_array_equal(got.column("id"), cand[order])
    np.testing.assert_array_equal(got.column("distCol"), dists[order])
    _, lax_order = jax.lax.top_k(jnp.asarray(-dists), k)
    np.testing.assert_array_equal(got.column("id"), cand[np.asarray(lax_order)])


def test_minhash_ann_sparse_key_and_no_candidates(on_cpu):
    x = _lsh_rows()
    _, tm = _lsh_pair(x)
    _, tcol = _sparse_cols(x)
    t = fml.Table({"f": tcol, "id": np.arange(len(x))})
    dense = tm.approx_nearest_neighbors(t, x[3], 5)
    sparse = tm.approx_nearest_neighbors(t, tcol[3], 5)
    np.testing.assert_array_equal(dense.column("id"), sparse.column("id"))
    far = np.zeros(x.shape[1] + 50)
    far[-1] = 1.0
    t_far = fml.Table({"f": np.pad(x, ((0, 0), (0, 50))),
                       "id": np.arange(len(x))})
    assert tm.approx_nearest_neighbors(t_far, far, 5).num_rows == 0


def test_minhash_join_equals_jax(on_cpu):
    xa, xb = _lsh_rows(n=40, seed=8), _lsh_rows(n=30, seed=9)
    jm, tm = _lsh_pair(xa, tables=5)
    want = jm.approx_similarity_join(JaxTable({"f": xa}), JaxTable({"f": xb}),
                                     0.6)
    got = tm.approx_similarity_join(fml.Table({"f": xa}), fml.Table({"f": xb}),
                                    0.6)
    assert got.num_rows > 0
    for c in ("idA", "idB", "distCol"):
        np.testing.assert_array_equal(got.column(c), np.asarray(want.column(c)))


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_minhash_save_load_across_packages(saver, tmp_path, on_cpu):
    x = _lsh_rows()
    jm, tm = _lsh_pair(x)
    path = str(tmp_path / "lsh")
    (jm if saver == "jax" else tm).save(path)
    loaded_t = fml.load_stage(path)
    loaded_j = jax_lsh.MinHashLSHModel.load(path)
    assert isinstance(loaded_t, fml.MinHashLSHModel)
    (a,) = loaded_t.transform(fml.Table({"f": x}))
    (b,) = loaded_j.transform(JaxTable({"f": x}))
    np.testing.assert_array_equal(a.column("h"), np.asarray(b.column("h")))
    assert loaded_t.get_param_map_json() == loaded_j.get_param_map_json()
