"""Word2Vec, FM and MLP of the port on two ranks, against the JAX package
on a two-device mesh, on the CPU.

Two gloo ranks (``tests/_torch_mesh_worker.py recsys_b``, the rank body
``tests/_torch_recsys_cases.py::recsys_b_cases``, started once for the
module) run the multi-device cases of ``tests/test_word2vec.py`` and
``tests/test_embeddings.py`` (Word2Vec's vocab-sharded trainer under both
exchange strategies, FM's sharded factors) and the streamed Word2Vec, MLP
and FM fits of ``tests/test_stream_fit_recsys.py`` and
``tests/test_stream_fit_mlp_pca.py`` with each rank feeding its own
partition. Every output is the same bits on both ranks. Against JAX:

  - in-RAM fits on the data mesh equal JAX's on a two-device mesh within
    the float32 tolerance of a psum in another order (MLP's 5 steps 1e-5,
    Word2Vec 1e-4); the sharded Word2Vec follows the dense trainer within
    the JAX test's 2e-3/2e-4 and equals JAX's sharded fit within 1e-4;
  - FM's sharded factors hold the JAX test's quality pins, and the first
    step's intercept equals the data-parallel one within its 1e-4;
  - a streamed MLP or FM over two partitions equals JAX's one-process
    streamed fit on a two-device mesh over the combined batches (each
    rank's batch is one device's shard there: the same rows, the same
    draws) within 1e-5 (the psum's order), spilled equals in-RAM and a
    resume equals the uninterrupted run bit for bit;
  - the streamed Word2Vec builds each rank's pairs with a per-rank RNG,
    which the one-process JAX fit cannot reproduce: it is held on the JAX
    test's assertions, spill and resume bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import flinkml_tpu.models as jm
from flinkml_tpu.iteration.datacache import cache_stream as jcache_stream
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.sharding import FSDP as J_FSDP
from flinkml_tpu.table import Table as JTable
from tests import _torch_recsys_cases as cases
from tests.test_torch_tensor_parallel import launch, same_on_every_rank

P = 2


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return launch("recsys_b", P, str(tmp_path_factory.mktemp("recsys_b")))


def _jmesh():
    return JMesh({"data": P}, jax.devices()[:P])


def _corpus_table(seed=3):
    col = np.empty(120, dtype=object)
    col[:] = cases.w2v_corpus(seed)
    return JTable({"doc": col})


def _jax_w2v(dim=12, iters=2, seed=3):
    return jm.Word2Vec(mesh=_jmesh()).set_input_col("doc") \
        .set_vector_size(dim).set_max_iter(iters).set_min_count(1) \
        .set_seed(0).fit(_corpus_table(seed))


def test_w2v_dense_on_two_ranks_matches_jax(outs):
    got = same_on_every_rank(outs, "w2v_dense")
    np.testing.assert_allclose(got, _jax_w2v().vectors, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strategy", ["ring", "all_to_all"])
def test_w2v_sharded_strategies_match_dense(outs, monkeypatch, strategy):
    dense = same_on_every_rank(outs, "w2v_dense")
    got = same_on_every_rank(outs, f"w2v_sharded_{strategy}")
    np.testing.assert_allclose(got, dense, rtol=2e-3, atol=2e-4)
    monkeypatch.setenv("FLINKML_W2V_SHARD_VOCAB", "0")
    monkeypatch.setenv("FLINKML_TPU_EMBEDDING_EXCHANGE", strategy)
    np.testing.assert_allclose(got, _jax_w2v().vectors, rtol=1e-4,
                               atol=1e-4)


def test_w2v_ring_and_a2a_agree(outs):
    np.testing.assert_allclose(
        same_on_every_rank(outs, "w2v_seed5_ring"),
        same_on_every_rank(outs, "w2v_seed5_all_to_all"),
        rtol=1e-4, atol=1e-6)


def test_fm_sharded_factors_quality_parity(outs):
    _, y = cases.fm_data()
    yd = same_on_every_rank(outs, "fm_dense_pred")
    ys = same_on_every_rank(outs, "fm_shard_pred")
    assert same_on_every_rank(outs, "fm_shard_v").shape == (24, 8)
    assert (ys == y).mean() >= (yd == y).mean() - 0.05
    assert (yd == ys).mean() >= 0.9, (yd != ys).sum()
    # The data-parallel fit against JAX's on the two-device mesh.
    x, _ = cases.fm_data()
    ref = jm.FMClassifier(mesh=_jmesh()).set_max_iter(40) \
        .set_global_batch_size(256).set_seed(0) \
        .fit(JTable({"features": x, "label": y}))
    jd = ref.transform(JTable({"features": x}))[0]["prediction"]
    assert (jd == yd).mean() >= 0.98


def test_fm_sharded_first_step_matches_dense(outs):
    dense = same_on_every_rank(outs, "fm_step_dense_w0")
    shard = same_on_every_rank(outs, "fm_step_fsdp_w0")
    np.testing.assert_allclose(shard, dense, rtol=1e-4, atol=1e-6)
    x, _ = cases.fm_data(seed=2)
    ref = jm.FMRegressor(sharding_plan=J_FSDP,
                         mesh=JMesh.for_plan(J_FSDP,
                                             devices=jax.devices()[:P])) \
        .set_max_iter(1).set_global_batch_size(256).set_seed(0) \
        .fit(JTable({"features": x, "label": x[:, 0] + 1.0}))
    np.testing.assert_allclose(shard, [ref._w0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(same_on_every_rank(outs, "fm_step_fsdp_w"),
                               ref._w, rtol=1e-4, atol=1e-5)


def test_mlp_in_ram_on_two_ranks_matches_jax(outs):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 6))
    y = rng.integers(0, 3, 300).astype(np.float64)
    ref = jm.MLPClassifier(mesh=_jmesh()).set_layers([6, 12, 3]) \
        .set_max_iter(5).set_learning_rate(0.05).set_global_batch_size(64) \
        .set_tol(0.0).set_seed(0).fit(JTable({"features": x, "label": y}))
    for i, want in enumerate(ref._weights):
        np.testing.assert_allclose(
            same_on_every_rank(outs, f"mlp_inram_{i}"), want, rtol=1e-5,
            atol=1e-5)


def _combined(world, seed=0):
    """The ranks' t-th batches concatenated in rank order, per t."""
    batches = cases.adam_batches(n_batches=2 * world, seed=seed)
    parts = [batches[r::world] for r in range(world)]
    return [{k: np.concatenate([p[t][k] for p in parts])
             for k in ("features", "label")} for t in range(len(parts[0]))]


@pytest.mark.parametrize("name", ["mlp", "fm"])
def test_streamed_adam_on_two_ranks(outs, name):
    n = 4 if name == "mlp" else 3
    for i in range(n):
        golden = same_on_every_rank(outs, f"{name}_golden_{i}")
        assert same_on_every_rank(outs, f"{name}_resumed_{i}").tobytes() \
            == golden.tobytes()
        stream = same_on_every_rank(outs, f"{name}_stream_{i}")
        assert same_on_every_rank(outs, f"{name}_spill_{i}").tobytes() \
            == stream.tobytes()
    est_cls = jm.MLPClassifier if name == "mlp" else jm.FMClassifier
    make = cases.mlp_estimator if name == "mlp" else cases.fm_estimator
    ylab = np.int32 if name == "mlp" else np.float32
    ref = make(est_cls, mesh=_jmesh()).fit(jcache_stream(
        {"x": b["features"], "y": b["label"].astype(ylab),
         "w": np.ones(len(b["label"]), np.float32)} for b in _combined(P)))
    for i, want in enumerate(cases._flat_model(ref)):
        np.testing.assert_allclose(
            same_on_every_rank(outs, f"{name}_golden_{i}"), want, rtol=1e-5,
            atol=1e-5)
    probe = _combined(P, seed=1)
    y = np.concatenate([b["label"] for b in probe])
    acc = (same_on_every_rank(outs, f"{name}_learn_pred") == y).mean()
    assert acc > (0.9 if name == "mlp" else 0.85), acc


def test_w2v_streamed_on_two_ranks(outs):
    stream = same_on_every_rank(outs, "w2v_stream")
    assert same_on_every_rank(outs, "w2v_spill").tobytes() == stream.tobytes()
    assert same_on_every_rank(outs, "w2v_resumed").tobytes() == \
        same_on_every_rank(outs, "w2v_golden").tobytes()
    vocab = list(same_on_every_rank(outs, "w2v_stream_vocab"))
    assert sorted(vocab) == sorted([f"a{i}" for i in range(6)]
                                   + [f"b{i}" for i in range(6)])
    vecs = same_on_every_rank(outs, "w2v_cliques")
    vecs = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    idx = {t: i for i, t in enumerate(vocab)}
    assert float(vecs[idx["a0"]] @ vecs[idx["a1"]]) > \
        float(vecs[idx["a0"]] @ vecs[idx["b0"]])
