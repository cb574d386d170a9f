"""LDA of the port (``flinkml_tpu_torch.models.lda``) against the JAX
package, on the CPU.

JAX draws the E-step start ``gamma(key, 100, (n_local, k))`` in every
shard from the same key, so its fit on the conftest's default 8-device
mesh starts from 8 repeated blocks. The port in one process is held
against JAX on a ONE-device mesh, and two gloo ranks (``tests/
_torch_mesh_worker.py catalog_c``) against JAX's 2-device mesh: each rank
draws its block's start as that device's shard does. The draws themselves
are JAX's bit for bit (``test_torch_threefry.py``), so what remains is
float32 arithmetic: PyTorch's matmul and digamma against XLA's.

Declared tolerances: one VB pass's packed statistics within
``PASS_RTOL`` of their largest entry; λ after several passes within
``LDA_RTOL``; the doc-topic mixtures within ``THETA_ATOL``. A planted
fault (one E-step too few, another key) breaks the pass tolerance. The
streamed fit's resume is held bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flinkml_tpu.models as jm
import flinkml_tpu_torch as fml
import flinkml_tpu_torch.models as tm
from flinkml_tpu.iteration.datacache import cache_stream as jcache_stream
from flinkml_tpu.linalg import SparseVector as JSparseVector
from flinkml_tpu.models import lda as jlda
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.io.read_write import load_stage, stage_from_arrays
from flinkml_tpu_torch.iteration.checkpoint import CheckpointManager
from flinkml_tpu_torch.iteration.datacache import cache_stream
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.models import lda as tlda
from flinkml_tpu_torch.ops import threefry as tf
from flinkml_tpu_torch.table import Table
from tests import _torch_catalog_cases as cases
from tests.test_torch_tensor_parallel import launch, same_on_every_rank

PASS_RTOL = 1e-5
LDA_RTOL = 1e-5
THETA_ATOL = 1e-5
P = 2


@pytest.fixture(autouse=True)
def _cpu():
    with fml.use_device("cpu"):
        yield


def _jmesh(p=1):
    return JMesh({"data": p}, jax.devices()[:p])


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _off(got, want) -> float:
    """The largest difference over the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


_STREAM_KW = ("cache_dir", "cache_memory_budget_bytes", "checkpoint_manager",
              "checkpoint_interval", "resume")


def _lda(pkg, mesh=None, **kw):
    kw = dict(cases.LDA_KW, **kw)
    est = pkg.LDA(mesh=mesh, **{n: kw.pop(n) for n in _STREAM_KW if n in kw})
    for name, v in kw.items():
        getattr(est, f"set_{name}")(v)
    return est


# -- the pieces ---------------------------------------------------------------

def test_exp_dirichlet_expectation_matches_jax():
    a = np.random.default_rng(0).gamma(2.0, size=(4, 50)).astype(np.float32)
    want = np.asarray(jlda._exp_dirichlet_expectation(jnp.asarray(a)))
    got = tlda._exp_dirichlet_expectation(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)


def _first_pass(seed=5, k=3):
    counts, _, _ = cases.lda_corpus()
    c32 = counts.astype(np.float32)
    lam = np.asarray(jax.random.gamma(jax.random.PRNGKey(seed), 100.0,
                                      (k, counts.shape[1])) * 0.01)
    mesh = _jmesh()
    step = jlda._vb_pass_fn(mesh.mesh, JMesh.DATA_AXIS, k)
    s, _, ll, tok = step(mesh.shard_batch(c32),
                         mesh.shard_batch(np.ones(len(c32), np.float32)),
                         jnp.asarray(lam, jnp.float32),
                         jnp.asarray(1.0 / k, jnp.float32),
                         jax.random.fold_in(jax.random.PRNGKey(seed), 0))
    want = np.concatenate([np.asarray(s).reshape(-1),
                           [float(ll), float(tok)]])
    return c32, lam, want


def _port_pass(c32, lam, seed=5):
    k = lam.shape[0]
    return tlda.vb_pass(
        torch.from_numpy(c32), torch.ones(len(c32)),
        torch.from_numpy(lam.astype(np.float32)), 1.0 / k,
        tf.fold_in(tf.PRNGKey(seed, "cpu"), 0)).numpy()


def test_initial_topics_are_jax_draws():
    lam = tlda._initial_lambda(tf.PRNGKey(5, "cpu"), 3, 30)
    want = np.asarray(jax.random.gamma(jax.random.PRNGKey(5), 100.0,
                                       (3, 30)) * 0.01)
    assert lam.tobytes() == want.tobytes()


def test_vb_pass_matches_jax_one_device():
    c32, lam, want = _first_pass()
    got = _port_pass(c32, lam)
    k, vocab = lam.shape
    _close(got[:k * vocab], want[:k * vocab], PASS_RTOL)
    np.testing.assert_allclose(got[k * vocab:], want[k * vocab:],
                               rtol=PASS_RTOL)


@pytest.mark.parametrize("fault", ["one_e_step_too_few", "another_key"])
def test_vb_pass_planted_fault_breaks_the_tolerance(fault, monkeypatch):
    c32, lam, want = _first_pass()
    if fault == "one_e_step_too_few":
        monkeypatch.setattr(tlda, "_E_STEPS", tlda._E_STEPS - 1)
        got = _port_pass(c32, lam)
    else:
        got = _port_pass(c32, lam, seed=6)
    k, vocab = lam.shape
    assert _off(got[:k * vocab], want[:k * vocab]) > 10 * PASS_RTOL


# -- the in-RAM fit ------------------------------------------------------------

@pytest.mark.parametrize("seed,iters", [(5, 4), (0, 8)])
def test_fit_matches_jax_one_device_mesh(seed, iters):
    counts, _, _ = cases.lda_corpus()
    jmodel = _lda(jm, _jmesh(), seed=seed, max_iter=iters).fit(
        JTable({"features": counts}))
    pmodel = _lda(tm, seed=seed, max_iter=iters).fit(
        Table({"features": counts}))
    _close(pmodel.topics_matrix, jmodel.topics_matrix, LDA_RTOL)
    _close(pmodel._lambda, jmodel._lambda, LDA_RTOL)
    want = jmodel.transform(JTable({"features": counts}))[0]
    got = pmodel.transform(Table({"features": counts}))[0]
    np.testing.assert_allclose(got.column("topicDistribution"),
                               want["topicDistribution"], atol=THETA_ATOL)
    np.testing.assert_array_equal(got.column("prediction"),
                                  want["prediction"])


def test_fit_differs_from_jax_default_eight_device_mesh():
    """The trap: JAX's default mesh draws 8 repeated start blocks, so the
    one-process port does not equal it (it equals the one-device mesh)."""
    counts, _, _ = cases.lda_corpus(n_docs=96)
    eight = _lda(jm).fit(JTable({"features": counts}))
    one = _lda(jm, _jmesh()).fit(JTable({"features": counts}))
    port = _lda(tm).fit(Table({"features": counts}))
    assert _off(port._lambda, eight._lambda) > 10 * LDA_RTOL
    _close(port._lambda, one._lambda, LDA_RTOL)


def test_fit_recovers_block_topics():
    counts, topics, dominant = cases.lda_corpus(n_docs=200, vocab=60,
                                                doc_len=80)
    t = Table({"features": counts})
    model = _lda(tm, max_iter=12, tol=1e-6, seed=0).fit(t)
    sims = (model.topics_matrix / np.linalg.norm(
        model.topics_matrix, axis=1, keepdims=True)) @ (
        topics / np.linalg.norm(topics, axis=1, keepdims=True)).T
    assert sims.max(axis=1).min() > 0.9
    (out,) = model.transform(t)
    # Dominant topics agree with the generator's up to a relabelling.
    pred = out.column("prediction").astype(int)
    agree = sum(np.bincount(dominant[pred == t]).max(initial=0)
                for t in range(3))
    assert agree / len(pred) > 0.85
    np.testing.assert_allclose(out.column("topicDistribution").sum(axis=1),
                               1.0, rtol=1e-6)
    desc = model.describe_topics(5)
    assert desc.num_rows == 3
    for row in range(3):
        assert len(set(desc.column("termIndices")[row] // 20)) == 1


def test_sparse_and_device_resident_input_equal_dense():
    counts, _, _ = cases.lda_corpus(n_docs=40, seed=3)
    rows = np.empty(len(counts), dtype=object)
    jrows = np.empty(len(counts), dtype=object)
    for i, row in enumerate(counts):
        nz = np.nonzero(row)[0]
        rows[i] = SparseVector(counts.shape[1], nz, row[nz])
        jrows[i] = JSparseVector(counts.shape[1], nz, row[nz])
    dense = _lda(tm).fit(Table({"features": counts}))
    sparse = _lda(tm).fit(Table({"features": rows}))
    tensor = _lda(tm).fit(Table({"features": torch.from_numpy(
        counts.astype(np.float32))}))
    assert sparse._lambda.tobytes() == dense._lambda.tobytes()
    assert tensor._lambda.tobytes() == dense._lambda.tobytes()
    jsparse = _lda(jm, _jmesh()).fit(JTable({"features": jrows}))
    _close(sparse._lambda, jsparse._lambda, LDA_RTOL)


def test_validation_matches_jax():
    counts, _, _ = cases.lda_corpus(n_docs=20, seed=5)
    with pytest.raises(ValueError, match="non-negative"):
        _lda(tm).fit(Table({"features": -counts}))
    model = _lda(tm, max_iter=1).fit(Table({"features": counts}))
    with pytest.raises(ValueError, match="vocab size"):
        model.transform(Table({"features": counts[:, :10]}))
    with pytest.raises(ValueError, match="docConcentration"):
        tm.LDA().set_doc_concentration(-1.0)
    with pytest.raises(ValueError, match="topicConcentration"):
        tm.LDA().set_topic_concentration(0.0)
    with pytest.raises(ValueError, match="Model data is not set"):
        tm.LDAModel().transform(Table({"features": counts}))


def test_priors_match_jax():
    counts, _, _ = cases.lda_corpus(n_docs=40, seed=2)
    kw = dict(max_iter=3)
    jmodel = _lda(jm, _jmesh(), **kw).set_doc_concentration(0.5) \
        .set_topic_concentration(0.05).fit(JTable({"features": counts}))
    pmodel = _lda(tm, **kw).set_doc_concentration(0.5) \
        .set_topic_concentration(0.05).fit(Table({"features": counts}))
    _close(pmodel._lambda, jmodel._lambda, LDA_RTOL)


def test_jax_saved_model_loads_in_port(tmp_path):
    counts, _, _ = cases.lda_corpus(n_docs=40, seed=4)
    jmodel = _lda(jm, _jmesh(), max_iter=3).fit(JTable({"features": counts}))
    jmodel.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"))
    assert isinstance(loaded, tm.LDAModel)
    assert loaded._lambda.tobytes() == jmodel._lambda.tobytes()
    want = jmodel.transform(JTable({"features": counts}))[0]
    got = loaded.transform(Table({"features": counts}))[0]
    np.testing.assert_allclose(got.column("topicDistribution"),
                               want["topicDistribution"], atol=THETA_ATOL)
    from_arrays = stage_from_arrays(
        "flinkml_tpu.models.lda.LDAModel", jmodel.get_param_map_json(),
        {"lambda": jmodel.get_model_data()[0]["lambda"]})
    assert from_arrays._lambda.tobytes() == jmodel._lambda.tobytes()
    loaded.save(str(tmp_path / "port"))
    back = jm.LDAModel.load(str(tmp_path / "port"))
    assert np.asarray(back._lambda).tobytes() == jmodel._lambda.tobytes()
    md = tm.LDAModel().set_model_data(*loaded.get_model_data())
    assert md._lambda.tobytes() == loaded._lambda.tobytes()


# -- the streamed fit -------------------------------------------------------------

def _batches(seed=1, rows=24, n=3):
    counts, _, _ = cases.lda_corpus(n_docs=rows * n, seed=seed)
    return [{"x": counts[i * rows:(i + 1) * rows].astype(np.float32)}
            for i in range(n)]


def test_streamed_fit_matches_jax_one_device():
    batches = _batches()
    jmodel = _lda(jm, _jmesh()).set_features_col("x").fit(
        jcache_stream(iter(batches)))
    pmodel = _lda(tm).set_features_col("x").fit(cache_stream(iter(batches)))
    _close(pmodel._lambda, jmodel._lambda, LDA_RTOL)
    tables = [Table({"features": b["x"]}) for b in batches]
    from_tables = _lda(tm).fit(iter(tables))
    assert from_tables._lambda.tobytes() == pmodel._lambda.tobytes()


def test_streamed_fit_spills_and_resumes_bit_for_bit(tmp_path):
    batches = _batches(seed=2)
    tables = [Table({"features": b["x"]}) for b in batches]
    ram = _lda(tm).fit(iter(tables))
    spilled = _lda(tm, cache_dir=str(tmp_path / "s"),
                   cache_memory_budget_bytes=1).fit(iter(tables))
    assert spilled._lambda.tobytes() == ram._lambda.tobytes()
    cache = cache_stream(iter(batches))

    class Crash(CheckpointManager):
        def save(self, state, epoch, extra=None, **kw):
            p = super().save(state, epoch, extra, **kw)
            if epoch >= 2:
                raise RuntimeError("injected crash")
            return p

    golden = _lda(tm).set_features_col("x").fit(cache)
    with pytest.raises(RuntimeError, match="injected"):
        _lda(tm, checkpoint_manager=Crash(str(tmp_path / "ck")),
             checkpoint_interval=1).set_features_col("x").fit(cache)
    resumed = _lda(tm, checkpoint_manager=CheckpointManager(
        str(tmp_path / "ck")), checkpoint_interval=1,
        resume=True).set_features_col("x").fit(cache)
    assert resumed._lambda.tobytes() == golden._lambda.tobytes()
    with pytest.raises(ValueError, match="requires a checkpoint_manager"):
        _lda(tm, resume=True).set_features_col("x").fit(cache)
    with pytest.raises(ValueError, match="durable DataCache"):
        _lda(tm, checkpoint_manager=CheckpointManager(str(tmp_path / "c2")),
             resume=True).fit(iter(tables))


def test_streamed_fit_validates_batches():
    with pytest.raises(ValueError, match="non-negative"):
        _lda(tm).fit(iter([Table({"features": -np.ones((4, 5))})]))
    with pytest.raises(ValueError, match="vocab size"):
        _lda(tm).fit(iter([Table({"features": np.ones((4, 5))}),
                           Table({"features": np.ones((4, 6))})]))


# -- two gloo ranks against JAX's 2-device mesh -------------------------------------

@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    return launch("catalog_c", P, str(tmp_path_factory.mktemp("catalog_c")))


def test_in_ram_fit_on_two_ranks_matches_jax_two_device_mesh(outs):
    counts, _, _ = cases.lda_corpus()
    got = same_on_every_rank(outs, "lda_lambda")
    want = _lda(jm, _jmesh(P)).fit(JTable({"features": counts}))._lambda
    _close(got, want, LDA_RTOL)
    one = _lda(jm, _jmesh()).fit(JTable({"features": counts}))._lambda
    assert _off(got, one) > 10 * LDA_RTOL  # each rank's block draws alone


def test_streamed_fit_on_two_ranks_matches_jax_two_device_mesh(outs):
    got = same_on_every_rank(outs, "lda_stream_lambda")
    want = _lda(jm, _jmesh(P)).set_features_col("x").fit(
        jcache_stream(iter(cases.lda_combined_batches(P))))._lambda
    _close(got, want, LDA_RTOL)
