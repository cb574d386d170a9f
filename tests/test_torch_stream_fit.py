"""Streamed, out-of-core and checkpointed linear fits in the port
(``flinkml_tpu_torch.models._linear_sgd``) against the JAX package on a
one-device mesh, on the CPU: the linear one-process cases of
``tests/test_stream_fit.py``, the sparse stream under both of the JAX
package's lowerings (XLA, and the Pallas ``spmv``/``segment_sum``
interpreted), the chunked device loop's per-chunk listeners and
``mode="host"`` against JAX's, and checkpoints of a streamed fit crossing
packages.

Declared tolerances: float32 fits 1e-5 absolute against the JAX package
(the products and sums add in another order); float64 fits 1e-10. Within
the port every comparison is exact: spilled against in-RAM, resumed
against uninterrupted, estimator against trainer (the same operations in
the same order on the CPU).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.iteration import CheckpointManager as JaxCheckpointManager
from flinkml_tpu.iteration.datacache import cache_stream as jax_cache_stream
from flinkml_tpu.linalg import Vectors as JaxVectors
from flinkml_tpu.models import _linear_sgd as j_sgd
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models.linear_regression import (
    LinearRegression as JaxLinearRegression,
)
from flinkml_tpu.models.linear_svc import LinearSVC as JaxLinearSVC
from flinkml_tpu.parallel import DeviceMesh
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.iteration.datacache import DataCacheWriter, cache_stream
from flinkml_tpu_torch.models import _linear_sgd as t_sgd
from flinkml_tpu_torch.models._data import labeled_sparse_data
from flinkml_tpu_torch.models.logistic_regression import (
    LogisticRegression,
    train_logistic_regression,
)
from tests._torch_port_common import on_cpu  # noqa: F401

F32_TOL = 1e-5
F64_TOL = 1e-10
KERNELS_ENV = "FLINKML_TPU_KERNELS"


@pytest.fixture(scope="module")
def mesh1():
    return DeviceMesh(devices=jax.devices()[:1])


def _make_batches(n_batches=6, rows=64, d=10, seed=0):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=d)
    out = []
    for _ in range(n_batches):
        x = rng.normal(size=(rows, d)).astype(np.float32)
        y = (x @ true > 0).astype(np.float32)
        out.append({"x": x, "y": y, "w": np.ones(rows, np.float32)})
    return out


HYPER = dict(loss="logistic", max_iter=8, learning_rate=0.5, reg=0.01,
             elastic_net=0.0, tol=0.0)


def _train(batches, **kw):
    return t_sgd.train_linear_model_stream(batches, **{**HYPER, **kw})


def _jax_train(batches, mesh, **kw):
    return j_sgd.train_linear_model_stream(batches, mesh=mesh,
                                           **{**HYPER, **kw})


def _tables(batches, cls):
    return [cls({"features": b["x"], "label": b["y"], "weight": b["w"]})
            for b in batches]


def test_spilled_cache_matches_in_ram_exactly(tmp_path, mesh1, on_cpu):
    batches = _make_batches()
    in_ram = _train(iter(batches))
    spilled = _train(iter(batches), cache_dir=str(tmp_path / "spill"),
                     memory_budget_bytes=1)
    np.testing.assert_array_equal(spilled, in_ram)
    assert any((tmp_path / "spill").glob("segment-*.bin"))
    want = _jax_train(iter(batches), mesh1)
    assert in_ram.dtype == want.dtype == np.float32
    np.testing.assert_allclose(in_ram, want, rtol=F32_TOL, atol=F32_TOL)


def test_variable_batch_sizes(tmp_path, mesh1, on_cpu):
    """Ragged batches pad to the row tile with weight-0 rows: exact."""
    rng = np.random.default_rng(3)
    true = rng.normal(size=6)
    batches = []
    for rows in (64, 37, 128, 5):
        x = rng.normal(size=(rows, 6)).astype(np.float32)
        batches.append({"x": x, "y": (x @ true > 0).astype(np.float32),
                        "w": np.ones(rows, np.float32)})
    in_ram = _train(iter(batches))
    spilled = _train(iter(batches), cache_dir=str(tmp_path / "rag"),
                     memory_budget_bytes=1)
    np.testing.assert_array_equal(spilled, in_ram)
    np.testing.assert_allclose(in_ram, _jax_train(iter(batches), mesh1),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_stream_losses_and_elastic_net_match_jax(loss, mesh1, on_cpu):
    batches = _make_batches(seed=5)
    kw = dict(loss=loss, reg=0.05, elastic_net=0.5, learning_rate=0.1)
    np.testing.assert_allclose(_train(iter(batches), **kw),
                               _jax_train(iter(batches), mesh1, **kw),
                               rtol=F32_TOL, atol=F32_TOL)


def test_estimator_fit_from_table_stream(mesh1, on_cpu):
    batches = _make_batches()
    est = (LogisticRegression().set_weight_col("weight").set_max_iter(8)
           .set_learning_rate(0.5).set_reg(0.01).set_tol(0.0))
    model = est.fit(iter(_tables(batches, fml.Table)))
    coef = model.get_model_data()[0].column("coefficient")[0]
    np.testing.assert_array_equal(np.asarray(coef), _train(iter(batches)))
    big = np.concatenate([b["x"] for b in batches])
    lbl = np.concatenate([b["y"] for b in batches])
    (out,) = model.transform(fml.Table({"features": big}))
    assert float((out.column("prediction") == lbl).mean()) > 0.9

    jest = (jax_lr.LogisticRegression(mesh=mesh1).set_weight_col("weight")
            .set_max_iter(8).set_learning_rate(0.5).set_reg(0.01).set_tol(0.0))
    want = jest.fit(iter(_tables(batches, JaxTable))).coefficient
    np.testing.assert_allclose(model.coefficient, want, rtol=F32_TOL,
                               atol=F32_TOL)


def test_linear_svc_and_regression_streamed_fit(tmp_path, mesh1, on_cpu):
    """Every linear estimator streams: the spilled estimator fit equals the
    low-level trainer with its loss, and the JAX estimator's fit."""
    batches = _make_batches(seed=21)
    svc = (fml.LinearSVC(cache_dir=str(tmp_path / "svc"),
                         cache_memory_budget_bytes=1)
           .set_weight_col("weight").set_max_iter(8).set_learning_rate(0.5)
           .set_reg(0.01).set_tol(0.0)).fit(iter(_tables(batches, fml.Table)))
    np.testing.assert_array_equal(
        np.asarray(svc.get_model_data()[0].column("coefficient")[0]),
        _train(iter(batches), loss="hinge"))
    assert any((tmp_path / "svc").glob("segment-*.bin"))
    jsvc = (JaxLinearSVC(mesh=mesh1).set_weight_col("weight").set_max_iter(8)
            .set_learning_rate(0.5).set_reg(0.01).set_tol(0.0)
            ).fit(iter(_tables(batches, JaxTable)))
    np.testing.assert_allclose(svc.coefficient, jsvc.coefficient,
                               rtol=F32_TOL, atol=F32_TOL)

    rng = np.random.default_rng(8)
    true = rng.normal(size=10)
    reg_batches = []
    for _ in range(4):
        x = rng.normal(size=(64, 10)).astype(np.float32)
        reg_batches.append({"x": x, "y": (x @ true).astype(np.float32),
                            "w": np.ones(64, np.float32)})

    def lin(cls, table_cls, **kw):
        return (cls(**kw).set_weight_col("weight").set_max_iter(8)
                .set_learning_rate(0.1).set_reg(0.0).set_tol(0.0)
                ).fit(iter(_tables(reg_batches, table_cls)))

    got = lin(fml.LinearRegression, fml.Table)
    np.testing.assert_array_equal(
        got.coefficient, _train(iter(reg_batches), loss="squared",
                                learning_rate=0.1, reg=0.0).astype(np.float64))
    want = lin(JaxLinearRegression, JaxTable, mesh=mesh1)
    np.testing.assert_allclose(got.coefficient, want.coefficient,
                               rtol=F32_TOL, atol=F32_TOL)


def test_linear_regression_normal_solver_rejects_stream(on_cpu):
    with pytest.raises(ValueError, match="solver='sgd'"):
        fml.LinearRegression().set_solver("normal").fit(iter(_make_batches()))


def test_fit_from_sealed_datacache(mesh1, on_cpu):
    batches = _make_batches(seed=11)
    cached = _train(cache_stream(iter(batches)))
    np.testing.assert_array_equal(cached, _train(iter(batches)))
    np.testing.assert_allclose(
        cached, _jax_train(jax_cache_stream(iter(batches)), mesh1),
        rtol=F32_TOL, atol=F32_TOL)


class _Crash(CheckpointManager):
    """A manager that raises after committing its first snapshot at or
    past ``crash_at``."""

    crash_at = 3

    def save(self, state, epoch, extra=None, **kw):
        path = super().save(state, epoch, extra, **kw)
        if not getattr(self, "fired", False) and epoch >= self.crash_at:
            self.fired = True
            raise RuntimeError("injected crash")
        return path


def test_datacache_resume_exact(tmp_path, on_cpu):
    """Crash mid-fit over a durable cache; the resumed fit is the
    uninterrupted one, bit for bit."""
    cache = cache_stream(iter(_make_batches(seed=7)),
                         directory=str(tmp_path / "cache"))
    golden = _train(cache, max_iter=9)
    mgr = _Crash(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="injected"):
        _train(cache, max_iter=9, checkpoint_manager=mgr,
               checkpoint_interval=3)
    assert mgr.latest_epoch() == 3
    recovered = _train(cache, max_iter=9, checkpoint_manager=mgr,
                       checkpoint_interval=3, resume=True)
    np.testing.assert_array_equal(recovered, golden)


def test_resume_after_tol_termination_is_noop(tmp_path, on_cpu):
    cache = cache_stream(iter(_make_batches(seed=4)))
    mgr = CheckpointManager(str(tmp_path / "tolck"))
    done = _train(cache, max_iter=30, tol=0.5, checkpoint_manager=mgr,
                  checkpoint_interval=5)
    stopped_at = mgr.latest_epoch()
    assert stopped_at is not None and stopped_at < 30
    resumed = _train(cache, max_iter=30, tol=0.5, checkpoint_manager=mgr,
                     checkpoint_interval=5, resume=True)
    np.testing.assert_array_equal(resumed, done)
    assert mgr.latest_epoch() == stopped_at


def test_zero_weight_batch_raises(on_cpu):
    batches = _make_batches(n_batches=2)
    batches[1]["w"] = np.zeros_like(batches[1]["w"])
    with pytest.raises(ValueError, match="zero total weight"):
        _train(iter(batches))


def test_datacache_bad_labels_raise(on_cpu):
    """Labels outside {0, 1} inside a caller's DataCache raise as the
    in-RAM path does (the first pass validates cached batches too)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = np.where(x[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    cache = cache_stream(iter([{"features": x, "label": y}]))
    with pytest.raises(ValueError, match="labels"):
        LogisticRegression().set_max_iter(2).fit(cache)
    with pytest.raises(ValueError, match="labels"):
        fml.LinearSVC().set_max_iter(2).fit(cache)


def test_caller_arrays_stay_writable(on_cpu):
    batches = _make_batches(n_batches=2)
    _train(iter(batches))
    batches[0]["x"][0, 0] = 123.0


def test_manager_without_interval_saves_terminal(tmp_path, on_cpu):
    mgr = CheckpointManager(str(tmp_path / "noint"))
    _train(iter(_make_batches()), checkpoint_manager=mgr)
    assert mgr.latest_epoch() == 8


def test_one_shot_stream_rejects_resume(tmp_path, on_cpu):
    with pytest.raises(ValueError, match="durable"):
        _train(iter(_make_batches()), resume=True,
               checkpoint_manager=CheckpointManager(str(tmp_path)))


def test_empty_stream_raises(on_cpu):
    with pytest.raises(ValueError, match="empty"):
        _train(iter([]))
    with pytest.raises(ValueError, match="empty"):
        LogisticRegression().fit(iter([]))


# -- the sparse stream -------------------------------------------------------------


def _sparse_tables(n_batches, rows, dim, nnz, seed=0, vectors=None):
    vectors = vectors or fml.Vectors
    table = fml.Table if vectors is fml.Vectors else JaxTable
    out = []
    for b in range(n_batches):
        r = np.random.default_rng(seed + b)
        vecs = []
        for _ in range(rows):
            idx = np.sort(r.choice(dim, nnz, replace=False))
            vecs.append(vectors.sparse(dim, idx.tolist(), r.normal(size=nnz)))
        y = (r.random(rows) > 0.5).astype(np.float64)
        out.append(table({"features": np.array(vecs, dtype=object),
                          "label": y}))
    return out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sparse_streamed_fit_matches_jax(backend, mesh1, on_cpu, monkeypatch):
    """SparseVector streams through the sparse-native trainer against the
    JAX package's, its gradient by XLA or by the Pallas kernels
    (interpreted; the JAX step's ``shard_map`` then runs with
    ``check_vma=False``, which a Pallas call inside it needs)."""
    if backend == "pallas":
        monkeypatch.setenv(KERNELS_ENV, "segment_sum=pallas,spmv=pallas")
        monkeypatch.setattr(jax, "shard_map", functools.partial(
            jax.shard_map, check_vma=False))
    else:
        monkeypatch.delenv(KERNELS_ENV, raising=False)
    j_sgd._sparse_stream_stepper.cache_clear()
    dim = 500
    got = (LogisticRegression().set_max_iter(3).set_learning_rate(0.5)
           .set_reg(0.01)).fit(iter(_sparse_tables(4, 24, dim, 5)))
    want = (jax_lr.LogisticRegression(mesh=mesh1).set_max_iter(3)
            .set_learning_rate(0.5).set_reg(0.01)).fit(
        iter(_sparse_tables(4, 24, dim, 5, vectors=JaxVectors)))
    j_sgd._sparse_stream_stepper.cache_clear()
    assert got.coefficient.shape == (dim,)
    np.testing.assert_allclose(got.coefficient, want.coefficient,
                               rtol=F32_TOL, atol=F32_TOL)


def test_sparse_streamed_fit_matches_densified_stream(on_cpu):
    """The same per-batch steps with the gradient reduced by
    ``segment_sum`` or by the dense product: equal up to summation
    order."""
    from flinkml_tpu_torch.models._data import labeled_data

    tables = _sparse_tables(4, 48, 5_000, 5)

    def est():
        return LogisticRegression().set_max_iter(3).set_learning_rate(0.5)

    m_sparse = est().fit(iter(tables))

    def densify(t):
        x, y, _ = labeled_data(t, "features", "label", None)
        return fml.Table({"features": x, "label": y})

    m_dense = est().fit(iter(densify(t) for t in tables))
    np.testing.assert_allclose(m_sparse.coefficient, m_dense.coefficient,
                               atol=1e-7)


def test_sparse_streamed_fit_high_dim_stays_o_nnz(on_cpu):
    """dim = 2e6 with 5 nnz a row: the cache holds CSR, never [n, dim]."""
    m = LogisticRegression().set_max_iter(2).fit(
        iter(_sparse_tables(3, 50, 2_000_000, 5)))
    assert m.coefficient.shape == (2_000_000,)
    assert np.isfinite(m.coefficient).all()


def _csr_dicts(tables):
    for t in tables:
        indptr, indices, values, d, y, w = labeled_sparse_data(
            t, "features", "label", None)
        yield {
            "indptr": np.asarray(indptr)[None, :],
            "indices": np.asarray(indices)[None, :],
            "values": np.asarray(values)[None, :],
            "y": np.asarray(y)[None, :],
            "w": np.asarray(w)[None, :],
            "dim": np.asarray([[d]], np.int64),
        }


SPARSE_HYPER = dict(features_col="features", label_col="label",
                    weight_col=None, loss="logistic", max_iter=6,
                    learning_rate=0.5, reg=0.01, elastic_net=0.0, tol=0.0)


def test_sparse_streamed_resume_exact_from_csr_cache(tmp_path, mesh1, on_cpu):
    """The durable sparse stream (a sealed cache of flat CSR batches):
    resume is bit for bit; the same cache's fit in the JAX package within
    1e-5."""
    cache = cache_stream(_csr_dicts(_sparse_tables(3, 32, 3_000, 4)))
    golden = t_sgd.streamed_linear_fit(cache, **SPARSE_HYPER)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    t_sgd.streamed_linear_fit(cache, checkpoint_manager=mgr,
                              checkpoint_interval=2,
                              **{**SPARSE_HYPER, "max_iter": 3})
    resumed = t_sgd.streamed_linear_fit(cache, checkpoint_manager=mgr,
                                        resume=True, **SPARSE_HYPER)
    np.testing.assert_array_equal(resumed, golden)
    jcache = jax_cache_stream(iter(list(cache.reader())))
    want = j_sgd.streamed_linear_fit(jcache, mesh=mesh1, **SPARSE_HYPER)
    np.testing.assert_allclose(golden, want, rtol=F32_TOL, atol=F32_TOL)


def _csr_row(dim, seed):
    r = np.random.default_rng(seed)
    n, nnz = 16, 3
    return {
        "indptr": (np.arange(n + 1, dtype=np.int64) * nnz)[None, :],
        "indices": r.integers(0, dim, n * nnz).astype(np.int32)[None, :],
        "values": r.normal(size=n * nnz).astype(np.float32)[None, :],
        "y": (r.random(n) > 0.5).astype(np.float32)[None, :],
        "dim": np.asarray([[dim]], np.int64),
    }


def test_sparse_streamed_csr_cache_edge_cases(on_cpu):
    hyper = {**SPARSE_HYPER, "max_iter": 2, "reg": 0.0}
    coef = t_sgd.streamed_linear_fit(cache_stream(iter([_csr_row(500, 0)])),
                                     **hyper)
    assert coef.shape == (500,) and np.isfinite(coef).all()
    with pytest.raises(ValueError, match="dim"):
        t_sgd.streamed_linear_fit(
            cache_stream(iter([_csr_row(500, 0), _csr_row(900, 1)])), **hyper)


def _flat_csr_batch(indptr, indices, values, y, dim):
    return {
        "indptr": np.asarray(indptr, np.int64)[None],
        "indices": np.asarray(indices, np.int32)[None],
        "values": np.asarray(values, np.float32)[None],
        "y": np.asarray(y, np.float32)[None],
        "dim": np.array([[dim]], np.int64),
    }


def test_csr_stream_rejects_non_monotone_indptr(on_cpu):
    dim = 32
    bad = _flat_csr_batch([0, 5, 3, 9], np.zeros(9), np.ones(9), np.ones(3),
                          dim)
    with pytest.raises(ValueError, match="non-decreasing"):
        _train([bad], sparse_dim=dim)
    bad0 = _flat_csr_batch([1, 4, 9], np.zeros(9), np.ones(9), np.ones(2), dim)
    with pytest.raises(ValueError, match="start at 0"):
        _train([bad0], sparse_dim=dim)


def test_csr_stream_rejects_out_of_range_indices(on_cpu):
    """The CUDA gather does not clamp: both polarities refused on the first
    pass, from a stream and from a caller's cache."""
    dim = 32
    neg = _flat_csr_batch([0, 2, 4], [1, -3, 5, 2], np.ones(4), np.ones(2),
                          dim)
    with pytest.raises(ValueError, match="column indices"):
        _train([neg], sparse_dim=dim)
    high = _flat_csr_batch([0, 2, 4], [1, 3, dim, 2], np.ones(4), np.ones(2),
                           dim)
    with pytest.raises(ValueError, match="column indices"):
        _train([high], sparse_dim=dim)
    with pytest.raises(ValueError, match="column indices"):
        t_sgd.streamed_linear_fit(cache_stream(iter([high])), **SPARSE_HYPER)


def test_check_csr_structure_matches_jax():
    args = (np.array([0, 2, 2, 5]), np.array([0, 31, 4, 0, 30]), 32)
    np.testing.assert_array_equal(t_sgd._check_csr_structure(*args),
                                  j_sgd._check_csr_structure(*args))
    np.testing.assert_array_equal(t_sgd._check_csr_structure(*args), [2, 0, 3])
    with pytest.raises(ValueError):
        t_sgd._check_csr_structure(np.array([], np.int64),
                                   np.array([], np.int64), 32)


def test_ell_packing_matches_jax():
    rng = np.random.default_rng(2)
    nnz = rng.integers(0, 12, size=40)
    indptr = np.concatenate([[0], np.cumsum(nnz)])
    indices = rng.integers(0, 100, size=indptr[-1]).astype(np.int32)
    values = rng.normal(size=indptr[-1]).astype(np.float32)
    for m in (1, 2, 3, 5, 39, 64, 65):
        assert t_sgd._ell_width_for(m) == j_sgd._ell_width_for(m)
    for got, want in zip(
            t_sgd._pack_uniform_ell(indptr, indices, values, np.float32),
            j_sgd._pack_uniform_ell(indptr, indices, values, np.float32)):
        np.testing.assert_array_equal(got, want)


def test_sparse_stream_step_matches_plain_math(on_cpu):
    """One sparse stream step against float64 numpy: the spmv forward and
    the segment_sum gradient, padding cells included."""
    import torch

    indptr = np.array([0, 3, 4, 8])
    indices = np.array([1, 4, 7, 2, 0, 1, 5, 9], np.int32)
    values = np.random.default_rng(0).normal(size=8).astype(np.float32)
    bi, bv = t_sgd._pack_uniform_ell(indptr, indices, values, np.float32)
    y = np.array([1.0, 0.0, 1.0], np.float32)
    w = np.array([1.0, 2.0, 0.5], np.float32)
    coef = np.random.default_rng(1).normal(size=10).astype(np.float32)
    hy = [torch.tensor(v, dtype=torch.float32) for v in (0.5, 0.01, 0.0)]
    step = t_sgd._sparse_stream_stepper("logistic", 10)
    new, loss_sum, wsum = step(torch.from_numpy(coef), torch.from_numpy(bi),
                               torch.from_numpy(bv), torch.from_numpy(y),
                               torch.from_numpy(w), *hy)
    dense = np.zeros((3, 10))
    np.add.at(dense, (np.repeat(np.arange(3), np.diff(indptr)), indices),
              values)
    dot = dense @ coef
    ys = 2 * y - 1
    mult = w * (-ys / (1 + np.exp(dot * ys)))
    grad = dense.T @ mult + 2 * 0.01 * coef
    want = coef - 0.5 / w.sum() * grad
    np.testing.assert_allclose(new.numpy(), want, rtol=1e-5, atol=1e-6)
    assert float(wsum) == pytest.approx(3.5)


# -- checkpoints of the in-RAM and streamed fits -----------------------------------


class EpochRecorder:
    def __init__(self):
        self.epochs, self.states, self.terminated = [], [], None

    def on_epoch_watermark_incremented(self, epoch, state):
        self.epochs.append(epoch)
        self.states.append(np.array(np.asarray(state)))

    def on_iteration_terminated(self, state):
        self.terminated = np.asarray(state)


def _dense_lr(n=300, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
    y = (x @ rng.normal(size=d) + 0.7 * rng.normal(size=n) > 0).astype(
        np.float64)
    return x, y, rng.uniform(0.5, 2.0, size=n)


@pytest.mark.parametrize("interval", [0, 4])
def test_chunked_listeners_match_jax(interval, tmp_path, mesh1, on_cpu):
    """The device loop's listeners fire after every dispatch, as JAX's
    ``_run_chunked`` fires them: every ``checkpoint_interval`` epochs with
    a manager, once without; the same epochs and states."""
    x, y, w = _dense_lr()
    kw = dict(loss="logistic", max_iter=10, learning_rate=0.5,
              global_batch_size=64, reg=0.01, elastic_net=0.0, tol=0.0,
              seed=3)
    lt, lj = EpochRecorder(), EpochRecorder()
    got = t_sgd.train_linear_model(
        x, y, w, listeners=[lt], checkpoint_interval=interval,
        checkpoint_manager=CheckpointManager(str(tmp_path / "t")), **kw)
    want = j_sgd.train_linear_model(
        x, y, w, mesh=mesh1, listeners=[lj], checkpoint_interval=interval,
        checkpoint_manager=JaxCheckpointManager(str(tmp_path / "j"),
                                                world_size=1), **kw)
    assert lt.epochs == lj.epochs == ([3, 7, 9] if interval else [9])
    for a, b in zip(lt.states, lj.states):
        np.testing.assert_allclose(a, b, rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_array_equal(lt.terminated, got)


@pytest.mark.parametrize("trainer", ["dense", "softmax", "sparse"])
def test_in_ram_fit_resume_exact(trainer, tmp_path, on_cpu):
    """Every device-loop trainer: stopped at epoch 6 and resumed to 12, the
    same bits as 12 epochs at once."""
    x, y, w = _dense_lr()
    if trainer == "dense":
        def fit(**kw):
            return t_sgd.train_linear_model(
                x, y, w, "hinge", learning_rate=0.5, global_batch_size=64,
                reg=0.05, elastic_net=0.5, tol=0.0, seed=3, **kw)
    elif trainer == "softmax":
        yk = (np.arange(y.size) % 3).astype(np.float64)

        def fit(**kw):
            return t_sgd.train_softmax_model(
                x, yk, w, 3, learning_rate=0.5, global_batch_size=64,
                reg=0.01, elastic_net=0.0, tol=0.0, seed=3, **kw)
    else:
        tables = _sparse_tables(1, 120, 300, 6)
        indptr, indices, values, dim, ys, ws = labeled_sparse_data(
            tables[0], "features", "label", None)

        def fit(**kw):
            return t_sgd.train_linear_model_sparse_csr(
                indptr, indices, values, dim, ys, ws, "logistic",
                learning_rate=1.0, global_batch_size=40, reg=0.01,
                elastic_net=0.0, tol=0.0, seed=2, **kw)

    golden = fit(max_iter=12)
    mgr = CheckpointManager(str(tmp_path))
    fit(max_iter=6, checkpoint_manager=mgr, checkpoint_interval=4)
    assert mgr.all_epochs() == [4, 6]
    resumed = fit(max_iter=12, checkpoint_manager=mgr, checkpoint_interval=4,
                  resume=True)
    np.testing.assert_array_equal(resumed, golden)


def test_mode_host_matches_jax(tmp_path, mesh1, on_cpu):
    """``mode="host"``: one step per epoch through ``iterate``, listeners
    at every epoch; against JAX's host mode, and equal to the device mode;
    resumed from its checkpoints, the same bits."""
    from flinkml_tpu.iteration import IterationListener as JaxListener

    x, y, w = _dense_lr()
    kw = dict(max_iter=12, learning_rate=0.5, global_batch_size=64,
              reg=0.01, tol=0.0, seed=3)
    lt = EpochRecorder()

    class JRec(EpochRecorder, JaxListener):
        def __init__(self):
            EpochRecorder.__init__(self)

    lj = JRec()
    got = train_logistic_regression(x, y, w, mode="host", listeners=[lt],
                                    **kw)
    want = jax_lr.train_logistic_regression(x, y, w, mesh=mesh1, mode="host",
                                            listeners=[lj], **kw)
    assert lt.epochs == lj.epochs == list(range(12))
    for a, b in zip(lt.states, lj.states):
        np.testing.assert_allclose(a, b, rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(got, train_logistic_regression(x, y, w, **kw),
                               rtol=F64_TOL, atol=F64_TOL)

    mgr = CheckpointManager(str(tmp_path))
    train_logistic_regression(x, y, w, mode="host", checkpoint_manager=mgr,
                              checkpoint_interval=5,
                              **{**kw, "max_iter": 7})
    assert mgr.all_epochs() == [5, 7]
    resumed = train_logistic_regression(
        x, y, w, mode="host", checkpoint_manager=mgr, checkpoint_interval=5,
        resume=True, **kw)
    np.testing.assert_array_equal(resumed, got)
    with pytest.raises(ValueError, match="mode must be"):
        train_logistic_regression(x, y, w, mode="nope", **kw)


def test_estimator_checkpoint_knobs(tmp_path, on_cpu):
    """The estimator's checkpoint knobs reach the in-RAM fit: a resumed
    estimator fit is the uninterrupted one."""
    x, y, w = _dense_lr()
    table = fml.Table({"features": x, "label": y})

    def est(max_iter, **kw):
        return (LogisticRegression(**kw).set_seed(2).set_global_batch_size(64)
                .set_learning_rate(0.5).set_tol(0.0).set_max_iter(max_iter))

    golden = est(10).fit(table).coefficient
    mgr = CheckpointManager(str(tmp_path))
    est(4, checkpoint_manager=mgr, checkpoint_interval=2).fit(table)
    assert mgr.latest_epoch() == 4
    resumed = est(10, checkpoint_manager=mgr, checkpoint_interval=2,
                  resume=True).fit(table).coefficient
    np.testing.assert_array_equal(resumed, golden)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_streamed_fit_checkpoint_crosses_packages(direction, tmp_path, mesh1,
                                                  on_cpu):
    """A streamed fit stopped at epoch 4 by one package resumes to 8 in the
    other (the ``(coef, loss)`` carry in one shared layout), and reaches
    the uninterrupted fit's coefficients."""
    batches = _make_batches(seed=13)
    golden = _train(cache_stream(iter(batches)))
    first, second = (("jax", "port") if direction == "jax_to_port"
                     else ("port", "jax"))

    def run(pkg, **kw):
        if pkg == "jax":
            return _jax_train(jax_cache_stream(iter(batches)), mesh1,
                              checkpoint_manager=JaxCheckpointManager(
                                  str(tmp_path), world_size=1), **kw)
        return _train(cache_stream(iter(batches)),
                      checkpoint_manager=CheckpointManager(str(tmp_path)),
                      **kw)

    run(first, max_iter=4, checkpoint_interval=2)
    resumed = run(second, checkpoint_interval=2, resume=True)
    np.testing.assert_allclose(resumed, golden, rtol=F32_TOL, atol=F32_TOL)


# -- what stays unported ----------------------------------------------------------


def test_stream_refusals(on_cpu):
    # The sorted-column stream is ported: an empty stream is refused, as
    # the JAX package refuses it.
    for sgd in (t_sgd, j_sgd):
        with pytest.raises(ValueError, match="training stream is empty"):
            sgd.train_linear_model_sorted_stream(iter([]), "features",
                                                 "label", **HYPER)
    with pytest.raises(ValueError, match="multinomial"):
        LogisticRegression().set_multi_class("multinomial").fit(
            iter(_tables(_make_batches(), fml.Table)))


def test_writer_budget_spills_half_of_a_stream(tmp_path, on_cpu):
    """A budget of half the stream's bytes keeps the first half in RAM and
    spills the rest (the shape of the out-of-core run on the card)."""
    batches = _make_batches(n_batches=8)
    half = sum(a.nbytes for b in batches for a in b.values()) // 2
    w = DataCacheWriter(str(tmp_path), memory_budget_bytes=half)
    for b in batches:
        w.append(dict(b))
    cache = w.finish()
    assert len(cache.mem_batches) == len(cache.segments) == 4
    np.testing.assert_array_equal(
        _train(cache), _train(cache_stream(iter(batches))))
