"""The ``cumsum`` sparse layout and ``BatchedCSR`` in the port
(``flinkml_tpu_torch``) against the JAX package, on the CPU.

Inputs are seeded numpy arrays handed to both packages. Declared
tolerances:

- ``chunked_run_totals``: float64 1e-12, float32 1e-5 relative to the
  largest run total (both packages run a chunked running sum, XLA's and
  PyTorch's scans add in their own orders); a repeated end is exactly 0.
- The pack-time tables (``run_boundary_tables``, ``_window_cumsum_tables``,
  ``ell_sort_tables`` through ``BatchedCSR``): equal bit for bit.
- ``BatchedCSR`` products: float64 1e-12, float32 1e-6.
- ``train_linear_model_sparse_csr(layout="cumsum")`` against JAX's fit
  under ``FLINKML_TPU_SPARSE_LAYOUT=cumsum`` on a one-device mesh: float64
  within 1e-10, float32 within rtol/atol 1e-5; against the port's own
  ``unsorted`` fit: float64 1e-10, float32 1e-5 (another addition order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.linalg import SparseVector as JaxSparseVector
from flinkml_tpu.models import _linear_sgd as jax_sgd
from flinkml_tpu.ops import sparse as jax_sparse
from flinkml_tpu.parallel import DeviceMesh
from flinkml_tpu_torch.models import _linear_sgd as t_sgd
from flinkml_tpu_torch.ops import BatchedCSR
from flinkml_tpu_torch.ops import sparse as t_sparse
from tests._torch_port_common import JAX_BACKENDS, on_cpu  # noqa: F401
from tests.test_torch_fit import EpochRecorder, sparse_lr_data

LAYOUT_ENV = "FLINKML_TPU_SPARSE_LAYOUT"
F64_FIT_TOL = 1e-10
F32_FIT_TOL = 1e-5


@pytest.fixture(scope="module")
def mesh1():
    return DeviceMesh(devices=jax.devices()[:1])


def _run_ends(cells, runs, rng, repeats=5):
    """Ascending inclusive run ends over ``cells`` cells (the last at
    ``cells - 1``), then ``repeats`` copies of the last end (padding runs)."""
    inner = np.sort(rng.choice(cells - 1, size=runs - 1, replace=False))
    ends = np.concatenate([inner, [cells - 1], np.full(repeats, cells - 1)])
    return ends.astype(np.int32)


@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("payload", [None, 3])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_chunked_run_totals_matches_jax(chunk, payload, dtype, tol,
                                        monkeypatch):
    """1-D and ``[cells, k]``, one chunk (the input is smaller than
    ``CUMSUM_CHUNK``) and many (``CUMSUM_CHUNK`` cut to 16 on both sides),
    runs inside a chunk and spanning several; padding runs exactly 0."""
    if chunk is not None:
        monkeypatch.setattr(jax_sparse, "CUMSUM_CHUNK", chunk)
        monkeypatch.setattr(t_sparse, "CUMSUM_CHUNK", chunk)
    rng = np.random.default_rng(7)
    cells = 1000
    shape = (cells,) if payload is None else (cells, payload)
    contrib = (rng.normal(size=shape) * 3.0).astype(dtype)
    ends = _run_ends(cells, 40, rng)
    want = np.asarray(jax_sparse.chunked_run_totals(jnp.asarray(contrib),
                                                    jnp.asarray(ends)))
    got = t_sparse.chunked_run_totals(torch.from_numpy(contrib),
                                      torch.from_numpy(ends)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    # The padding runs (repeated ends) add exactly 0.
    assert not np.any(got[-5:])
    # And the totals are the runs' sums.
    bounds = np.concatenate([[0], ends[:40] + 1])
    ref = np.stack([contrib[lo:hi].astype(np.float64).sum(axis=0)
                    for lo, hi in zip(bounds[:-1], bounds[1:])])
    np.testing.assert_allclose(got[:40], ref, rtol=0, atol=tol * scale)


def test_chunked_run_totals_small_input_pads_to_next_pow2(monkeypatch):
    """A small input does not pad to a whole ``CUMSUM_CHUNK``: the scan
    runs over ``next_pow2(cells + 1)`` cells."""
    seen = []
    real = torch.cumsum

    def spy(x, dim):
        seen.append(tuple(x.shape))
        return real(x, dim)

    monkeypatch.setattr(torch, "cumsum", spy)
    t_sparse.chunked_run_totals(torch.ones(100), torch.tensor([49, 99]))
    # One chunk of 128 cells; its one row scans beside an all-zero row.
    assert seen[0] == (2, 128)


@pytest.mark.parametrize("cells,k,chunk", [
    (100, None, None), (100, 1, None), (100, 3, None), (5000, None, 1024),
    (5000, 1, 1024), (5000, 2, 1024), (1023, None, 1024)])
def test_chunked_run_totals_scans_take_the_row_wise_shape(
        monkeypatch, cells, k, chunk):
    """Every running sum scans dim 1 of a 2-D view of at least two rows
    (the row-wise scan on the card, never the one-row device-wide scan),
    and the result is the same bits as the plain one-row scans."""
    if chunk is not None:
        monkeypatch.setattr(t_sparse, "CUMSUM_CHUNK", chunk)
    rng = np.random.default_rng(cells)
    shape = (cells,) if k is None else (cells, k)
    contrib = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    ends = torch.from_numpy(np.unique(np.concatenate(
        [rng.integers(0, cells, size=40), [cells - 1]])))
    seen = []
    real = torch.cumsum

    def spy(x, dim):
        seen.append((tuple(x.shape), dim))
        return real(x, dim)

    monkeypatch.setattr(torch, "cumsum", spy)
    got = t_sparse.chunked_run_totals(contrib, ends)
    monkeypatch.setattr(torch, "cumsum", real)
    assert len(seen) == 2
    for shp, dim in seen:
        assert len(shp) == 2 and dim == 1 and shp[0] >= 2, seen
    # The same bits as the scans without the zero row (the CPU adds each
    # row in order whatever the shape).
    monkeypatch.setattr(t_sparse, "_row_cumsum",
                        lambda rows: real(rows, dim=1))
    want = t_sparse.chunked_run_totals(contrib, ends)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(4, 60), (1, 1), (3, 0), (2, 7)])
def test_run_boundary_tables_match_jax(shape):
    rng = np.random.default_rng(11)
    keys = np.sort(rng.integers(0, 9, size=shape), axis=1).astype(np.int32)
    want = jax_sparse.run_boundary_tables(keys)
    got = t_sparse.run_boundary_tables(keys)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("local_bs", [7, 50, 120])
def test_window_cumsum_tables_match_jax(local_bs):
    """The same loop and stable argsort: every table equal bit for bit,
    clamped tail windows and repeated columns included."""
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 40, size=(120, 6)).astype(np.int32)
    idx[:, 4:] = 0                                      # ELL padding cells
    val = rng.normal(size=idx.shape).astype(np.float32)
    val[:, 4:] = 0.0
    want = jax_sgd._window_cumsum_tables(idx, val, 1, local_bs)
    got = t_sgd._window_cumsum_tables(idx, val, 1, local_bs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_prepare_cumsum_buckets_match_jax(mesh1, on_cpu):
    """The bucketed pack with the ``cumsum`` tables: 8 tensors a bucket,
    equal to the JAX package's arrays."""
    indptr, indices, values, dim, y, w = sparse_lr_data()
    jargs, jbss = jax_sgd.prepare_sparse_buckets(
        indptr, indices, values, dim, y, w, mesh1, 150, seed=4,
        layout="cumsum")
    targs, tbss = t_sgd.prepare_sparse_buckets(
        indptr, indices, values, dim, y, w, 150, seed=4, layout="cumsum")
    assert tbss == jbss and len(tbss) > 1
    assert len(targs) == len(jargs) == 8 * len(tbss)
    for g, j in zip(targs, jargs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


# -- BatchedCSR ------------------------------------------------------------------------

def _vectors(n=30, dim=50, seed=3, cls=fml.SparseVector):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        k = int(rng.integers(0, 8))
        idx = np.sort(rng.choice(dim, size=k, replace=False)).astype(np.int64)
        rows.append(cls(dim, idx, rng.normal(size=k)))
    return rows


def _jax_vectors(rows):
    return [JaxSparseVector(v.size(), v.indices, v.values) for v in rows]


@pytest.mark.parametrize("max_nnz", [None, 3])
@pytest.mark.parametrize("sort", [False, True])
def test_pack_sparse_vectors_matches_jax(max_nnz, sort):
    rows = _vectors()
    want = jax_sparse.BatchedCSR.pack_sparse_vectors(
        _jax_vectors(rows), max_nnz, np.float64, sort=sort)
    got = BatchedCSR.pack_sparse_vectors(rows, max_nnz, np.float64, sort=sort)
    assert len(got) == len(want) == (5 if sort else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_batched_csr_methods_match_jax(dtype, tol, backend, on_cpu,
                                       monkeypatch):
    """Construction, ``to_dense``, ``matvec`` (``spmv``), ``rmatvec``
    (``segment_sum``), ``slice_rows`` and the shape properties, against
    the JAX class under XLA or its Pallas kernels (interpret mode)."""
    rows = _vectors(dim=64)
    jb = jax_sparse.BatchedCSR.from_sparse_vectors(_jax_vectors(rows),
                                                   dtype=dtype)
    tb = BatchedCSR.from_sparse_vectors(rows, dtype=dtype)
    assert (tb.num_rows, tb.max_nnz, tb.dim) == (jb.num_rows, jb.max_nnz,
                                                 jb.dim)
    assert tb.indices.dtype == torch.int32 and tb.indices.device.type == "cpu"
    np.testing.assert_array_equal(tb.to_dense().numpy(),
                                  np.asarray(jb.to_dense()))
    rng = np.random.default_rng(5)
    wvec = rng.normal(size=64).astype(dtype)
    coeffs = rng.normal(size=len(rows)).astype(dtype)
    monkeypatch.setenv("FLINKML_TPU_KERNELS",
                       f"spmv={backend},segment_sum={backend}")
    want_mv = np.asarray(jb.matvec(wvec))
    want_rmv = np.asarray(jb.rmatvec(coeffs))
    got_mv = tb.matvec(wvec).numpy()
    got_rmv = tb.rmatvec(torch.from_numpy(coeffs)).numpy()
    assert got_mv.dtype == want_mv.dtype == dtype
    np.testing.assert_allclose(got_mv, want_mv, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_rmv, want_rmv, rtol=tol, atol=tol)
    # Dense products in float64.
    dense = np.asarray(jb.to_dense(), np.float64)
    np.testing.assert_allclose(got_mv, dense @ wvec, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_rmv, dense.T @ coeffs, rtol=tol, atol=tol)
    ts, js = tb.slice_rows(4, 19), jb.slice_rows(4, 19)
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))
    np.testing.assert_allclose(ts.matvec(wvec).numpy(),
                               np.asarray(js.matvec(wvec)), rtol=tol,
                               atol=tol)


def test_batched_csr_from_scipy_matches_jax(on_cpu):
    rng = np.random.default_rng(9)
    mat = sp.random(40, 70, density=0.08, format="lil", random_state=rng,
                    dtype=np.float64)
    mat[3] = 0.0                                        # an empty row
    mat = mat.tocsr()
    mat.eliminate_zeros()
    jb = jax_sparse.BatchedCSR.from_scipy(mat)
    tb = BatchedCSR.from_scipy(mat)
    np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
    np.testing.assert_array_equal(tb.values.numpy(), np.asarray(jb.values))
    np.testing.assert_array_equal(tb.to_dense().numpy(),
                                  mat.toarray().astype(np.float32))
    empty = BatchedCSR.from_scipy(sp.csr_matrix((0, 5)))
    assert tuple(empty.indices.shape) == tuple(
        jax_sparse.BatchedCSR.from_scipy(sp.csr_matrix((0, 5))).indices.shape)


@pytest.mark.parametrize("with_nnz", [False, True])
def test_batched_csr_sorted_matches_jax(with_nnz, on_cpu):
    """``sorted()``: the port's ``SortedSparseColumn`` with the JAX
    column's tables (sort tables and ``indptr``) bit for bit, on the
    batch's device."""
    rows = _vectors(n=25, dim=40, seed=8)
    nnz = np.array([v.indices.size for v in rows]) if with_nnz else None
    jcol = jax_sparse.BatchedCSR.from_sparse_vectors(
        _jax_vectors(rows)).sorted(nnz)
    tcol = BatchedCSR.from_sparse_vectors(rows).sorted(nnz)
    assert isinstance(tcol, fml.table.SortedSparseColumn)
    assert tcol.indices_are_sorted and tcol.dim == jcol.dim
    assert tcol.rows == jcol.rows
    for name in ("buf", "indices", "indptr", "perm", "segment_ids"):
        got = getattr(tcol, name)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jcol, name)))


def test_batched_csr_refusals(on_cpu):
    """Out-of-range indices at construction (the CUDA gather does not
    clamp), ragged shapes, and a ``backend`` other than None."""
    with pytest.raises(ValueError, match="out of range"):
        BatchedCSR(np.array([[0, 5]]), np.ones((1, 2)), 5)
    with pytest.raises(ValueError, match="out of range"):
        BatchedCSR(np.array([[-1, 0]]), np.ones((1, 2)), 5)
    with pytest.raises(ValueError, match="equal 2-D shapes"):
        BatchedCSR(np.zeros((2, 3)), np.zeros((2, 2)), 5)
    with pytest.raises(ValueError, match="equal 2-D shapes"):
        jax_sparse.BatchedCSR(np.zeros((2, 3)), np.zeros((2, 2)), 5)
    b = BatchedCSR(np.array([[0, 4]]), np.ones((1, 2)), 5)
    for method, arg in (("matvec", np.ones(5)), ("rmatvec", np.ones(1))):
        with pytest.raises(ValueError, match="backend"):
            getattr(b, method)(arg, backend="pallas")
    with pytest.raises(ValueError, match="empty batch"):
        BatchedCSR.from_sparse_vectors([])


# -- the cumsum fit --------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_FIT_TOL),
                                       (np.float32, F32_FIT_TOL)])
@pytest.mark.parametrize("stop", [0.0, 0.62])
def test_cumsum_fit_matches_jax(dtype, tol, stop, mesh1, on_cpu, monkeypatch):
    """``layout="cumsum"`` against JAX's fit under its env var, one
    device; ``stop`` (tol) 0.62 ends both at the same epoch."""
    monkeypatch.setenv(LAYOUT_ENV, "cumsum")
    indptr, indices, values, dim, y, w = sparse_lr_data()
    kw = dict(loss="logistic", max_iter=30, learning_rate=2.0,
              global_batch_size=150, reg=0.001, elastic_net=0.2, tol=stop,
              seed=5, dtype=dtype)
    lj, lt = EpochRecorder(), EpochRecorder()
    want = jax_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, y, w, mesh=mesh1, listeners=[lj], **kw)
    got = t_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, y, w, listeners=[lt], layout="cumsum",
        **kw)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert lt.epoch == lj.epoch
    assert (lt.epoch < 29) == (stop > 0)


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64_FIT_TOL),
                                       (np.float32, F32_FIT_TOL)])
@pytest.mark.parametrize("loss", ["logistic", "hinge", "squared"])
def test_cumsum_fit_equals_unsorted_fit(dtype, tol, loss, on_cpu):
    """The port's three layouts compute one gradient in three addition
    orders: the fits agree within the dtype's tolerance."""
    indptr, indices, values, dim, y, w = sparse_lr_data(seed=4)
    kw = dict(loss=loss, max_iter=25, learning_rate=0.5,
              global_batch_size=120, reg=0.01, elastic_net=0.5, tol=0.0,
              seed=2, dtype=dtype)
    fits = {layout: t_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, y, w, layout=layout, **kw)
        for layout in t_sgd.SPARSE_LAYOUTS}
    assert set(fits) == {"unsorted", "sorted", "cumsum"}
    for layout in ("sorted", "cumsum"):
        np.testing.assert_allclose(fits[layout], fits["unsorted"], rtol=tol,
                                   atol=tol)
    assert np.abs(fits["cumsum"]).max() > 1e-2


def test_cumsum_fit_resumes_bit_for_bit(tmp_path, on_cpu):
    """A cumsum fit chunked by checkpoints, crashed and resumed, equals
    the uninterrupted one bit for bit (no atomics: on the card too)."""
    from flinkml_tpu_torch.iteration import CheckpointManager

    indptr, indices, values, dim, y, w = sparse_lr_data(seed=6)
    kw = dict(loss="logistic", max_iter=12, learning_rate=1.0,
              global_batch_size=100, reg=0.0, elastic_net=0.0, tol=0.0,
              seed=1, layout="cumsum")
    whole = t_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, y, w, **kw)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    part = t_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, y, w, checkpoint_manager=mgr,
        checkpoint_interval=4, **dict(kw, max_iter=8))
    assert mgr.latest_epoch() == 8 and not np.array_equal(part, whole)
    resumed = t_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, y, w, checkpoint_manager=mgr,
        checkpoint_interval=4, resume=True, **kw)
    np.testing.assert_array_equal(resumed, whole)
