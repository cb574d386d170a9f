"""LogisticRegression.fit in the port (``flinkml_tpu_torch``) against the
JAX package on a one-device mesh, on the CPU: the modules of the fit path
(margin terms, padding, label extraction, termination criteria), one dense
and one sparse step, the whole-loop trainers (early termination by ``tol``
included: the same epoch count), the estimator end to end, the reference
fixture, cross-package save/load, and every refusal of the paths not
ported yet. Inputs are seeded numpy arrays handed to both packages.

Declared tolerances (coefficients are O(0.1–1)):

- float64 fits: 1e-10 absolute. Both packages run the same operations in
  the same order except the dense products and sums, which XLA and
  PyTorch's CPU kernels add in different orders (observed ≤ 3e-16).
- float32 fits: 1e-5 absolute, for the same reason at float32 rounding
  over up to 50 epochs (observed ≤ 2e-7).
- Losses: the gradient factor to 1e-12 (f64) / 1e-6 (f32) relative;
  the per-example loss to 1e-9 relative, because PyTorch's ``softplus``
  returns its input above 20 where JAX adds ``log1p(exp(-x)) < 2.1e-9``.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import flinkml_tpu_torch as fml
from flinkml_tpu.io import read_write as jax_read_write
from flinkml_tpu.iteration import runtime as jax_runtime
from flinkml_tpu.linalg import SparseVector as JaxSparseVector
from flinkml_tpu.models import _data as jax_data
from flinkml_tpu.models import _linear_sgd as jax_sgd
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.ops import losses as jax_losses
from flinkml_tpu.parallel import DeviceMesh, pad_to_multiple as jax_pad
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch import iteration as t_iteration
from flinkml_tpu_torch.models import _data as t_data
from flinkml_tpu_torch.models import _linear_sgd as t_sgd
from flinkml_tpu_torch.models import logistic_regression as t_lr
from flinkml_tpu_torch.ops import losses as t_losses
from flinkml_tpu_torch.parallel import pad_to_multiple as t_pad
from tests._torch_port_common import jax_backend, on_cpu  # noqa: F401
from tests.test_convergence_parity import REFERENCE_COEF
from tests.test_logistic_regression import reference_train_table

F64_FIT_TOL = 1e-10
F32_FIT_TOL = 1e-5
LAYOUTS = ("unsorted", "sorted", "cumsum")
LAYOUT_ENV = "FLINKML_TPU_SPARSE_LAYOUT"


@pytest.fixture(scope="module")
def mesh1():
    """The JAX reference on one device, as the port trains."""
    return DeviceMesh(devices=jax.devices()[:1])


class EpochRecorder:
    """Listener of either package: records the last epoch and the state."""

    def __init__(self):
        self.epoch, self.state, self.terminated = None, None, None

    def on_epoch_watermark_incremented(self, epoch, state):
        self.epoch, self.state = epoch, state

    def on_iteration_terminated(self, state):
        self.terminated = state


def dense_lr_data(n=300, d=5, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
    y = (x @ rng.normal(size=d) + 0.7 * rng.normal(size=n) > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n)
    return x.astype(dtype), y, w


def sparse_lr_data(n=400, dim=300, seed=1):
    """CSR with nnz 1..11 per row (several ELL buckets), sorted unique
    columns per row, planted labels."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(1, 12, size=n)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = np.concatenate(
        [np.sort(rng.choice(dim, k, replace=False)) for k in nnz]
    ).astype(np.int32)
    values = rng.normal(size=indptr[-1]).astype(np.float32)
    beta = rng.normal(size=dim)
    margins = np.add.reduceat(values * beta[indices], indptr[:-1])
    y = (margins + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return indptr, indices, values, dim, y, w


def sparse_rows(indptr, indices, values, dim, cls):
    rows = np.empty(indptr.size - 1, dtype=object)
    for r in range(rows.size):
        lo, hi = indptr[r], indptr[r + 1]
        rows[r] = cls(dim, indices[lo:hi].astype(np.int64),
                      values[lo:hi].astype(np.float64))
    return rows


# -- modules of the fit path -----------------------------------------------------------

@pytest.mark.parametrize("loss", ["logistic", "hinge", "squared"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_margin_terms_match_jax(loss, dtype):
    rng = np.random.default_rng(3)
    dot = (rng.normal(size=200) * 15.0).astype(dtype)   # |margin| up to ~50
    y = rng.integers(0, 2, size=200).astype(dtype)
    w = rng.uniform(0.5, 2.0, size=200).astype(dtype)
    want_mult, want_loss = (np.asarray(a) for a in
                            jax_losses.margin_terms(loss, dot, y, w))
    got_mult, got_loss = (a.numpy() for a in t_losses.margin_terms(
        loss, *(torch.from_numpy(a) for a in (dot, y, w))))
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got_mult, want_mult, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got_loss, want_loss, rtol=max(rtol, 1e-9),
                               atol=rtol)


@pytest.mark.parametrize("shape,multiple", [((7, 3), 4), ((8,), 4), ((0, 2), 3)])
def test_pad_to_multiple_matches_jax(shape, multiple):
    a = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    got, n_got = t_pad(a, multiple)
    want, n_want = jax_pad(a, multiple)
    np.testing.assert_array_equal(got, want)
    assert n_got == n_want


def test_labeled_data_matches_jax():
    x, y, w = dense_lr_data(n=40)
    cols = {"features": x, "label": y, "weight": w}
    want = jax_data.labeled_data(JaxTable(cols), "features", "label", "weight")
    got = t_data.labeled_data(fml.Table(cols), "features", "label", "weight")
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g, j)
        assert g.dtype == j.dtype
    f32 = t_data.labeled_data(fml.Table({"features": x.astype(np.float32),
                                         "label": y}),
                              "features", "label", dtype=None)
    assert f32[0].dtype == np.float32 and f32[2].tolist() == [1.0] * 40


def test_labeled_sparse_data_matches_jax():
    indptr, indices, values, dim, y, w = sparse_lr_data(n=50, dim=40)
    want = jax_data.labeled_sparse_data(
        JaxTable({"features": sparse_rows(indptr, indices, values, dim,
                                          JaxSparseVector),
                  "label": y, "w": w}), "features", "label", "w")
    got = t_data.labeled_sparse_data(
        fml.Table({"features": sparse_rows(indptr, indices, values, dim,
                                           fml.SparseVector),
                   "label": y, "w": w}), "features", "label", "w")
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g, j)


def test_check_binary_labels_matches_jax():
    bad = np.array([0.0, 1.0, 2.0])
    with pytest.raises(ValueError) as want:
        jax_data.check_binary_labels(bad, "m")
    with pytest.raises(ValueError) as got:
        t_data.check_binary_labels(bad, "m")
    assert str(got.value) == str(want.value)
    t_data.check_binary_labels(np.array([0.0, 1.0, 1.0]), "m")


def test_termination_criterion_matches_jax():
    for max_iter, tol in ((1, 0.0), (5, 0.1), (20, 1e-3)):
        want = jax_runtime.TerminateOnMaxIterOrTol(max_iter, tol)
        got = t_iteration.TerminateOnMaxIterOrTol(max_iter, tol)
        for epoch in range(max_iter + 1):
            for value in (None, 0.0, 0.05, 0.1, 0.5, float("nan")):
                assert got.should_terminate(epoch, value) == \
                    want.should_terminate(epoch, value)
    with pytest.raises(ValueError):
        t_iteration.TerminateOnMaxIterOrTol(0, 0.1)
    assert issubclass(t_iteration.TerminateOnMaxIterOrTol,
                      t_iteration.TerminationCriterion)


@pytest.mark.parametrize("n,bs", [(10, 3), (10, 10), (9, 4), (1, 1)])
def test_window_matches_jax(n, bs):
    """The rotating window, the clamped tail window included."""
    a = np.arange(n * 2, dtype=np.float64).reshape(n, 2)
    for epoch in range(7):
        want = np.asarray(jax_sgd._window(a, epoch, bs))
        got = t_sgd._window(torch.from_numpy(a), epoch, bs).numpy()
        np.testing.assert_array_equal(got, want)
    assert t_sgd.align_local_bs(7, 1, 5) == jax_sgd.align_local_bs(7, 1, 5)


# -- one step -------------------------------------------------------------------------

def _jax_on_one_device(fn, mesh, n_args):
    """``fn`` under ``shard_map`` on the one-device mesh (its ``psum`` is
    then the identity), every argument replicated."""
    return jax.jit(jax.shard_map(fn, mesh=mesh.mesh,
                                 in_specs=(P(),) * n_args,
                                 out_specs=(P(), P()), check_vma=False))


@pytest.mark.parametrize("loss", ["logistic", "hinge", "squared"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_step_matches_jax(loss, dtype, mesh1):
    """One dense step (window 3 of 5, L2 and L1 both active) vs JAX's
    ``make_dense_step``."""
    x, y, w = (a.astype(dtype) for a in dense_lr_data(n=250, d=6))
    coef = np.random.default_rng(5).normal(size=6).astype(dtype) * 0.3
    hy = tuple(np.asarray(v, dtype) for v in (0.3, 0.01, 0.002))
    jstep = jax_sgd.make_dense_step(loss, 50, DeviceMesh.DATA_AXIS)
    want = _jax_on_one_device(
        lambda c, xl, yl, wl, lr, l2, l1: jstep(c, 3, xl, yl, wl, lr, l2, l1),
        mesh1, 7)(coef, x, y, w, *hy)
    tstep = t_sgd.make_dense_step(loss, 50)
    got = tstep(*(torch.from_numpy(a) for a in (coef,)), 3,
                *(torch.from_numpy(a) for a in (x, y, w) + hy))
    tol = F64_FIT_TOL if dtype == np.float64 else 1e-6
    for g, j in zip(got, want):
        assert g.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sparse_step_matches_jax(layout, backend, mesh1, on_cpu, monkeypatch):
    """Packing and one bucketed sparse step vs the JAX package's
    ``prepare_sparse_buckets`` + ``make_sparse_step_bucketed`` (gradient
    by XLA's scatter or the Pallas ``segment_sum``/``spmv`` interpreted).
    The packed tables are equal exactly; the step within 1e-6 (float32)."""
    indptr, indices, values, dim, y, w = sparse_lr_data()
    jargs, jbss = jax_sgd.prepare_sparse_buckets(
        indptr, indices, values, dim, y, w, mesh1, 150, seed=4, layout=layout)
    targs, tbss = t_sgd.prepare_sparse_buckets(
        indptr, indices, values, dim, y, w, 150, seed=4, layout=layout)
    assert tbss == jbss and len(targs) == len(jargs) and len(tbss) > 1
    for g, j in zip(targs, jargs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))

    coef = (np.random.default_rng(6).normal(size=dim) * 0.2).astype(np.float32)
    hy = tuple(np.asarray(v, np.float32) for v in (0.5, 0.01, 0.001))
    jax_backend(monkeypatch, backend, "segment_sum")
    jstep = jax_sgd.make_sparse_step_bucketed(
        "logistic", jbss, DeviceMesh.DATA_AXIS, dim, layout,
        segsum_backend=backend, spmv_backend=backend)
    n = len(jargs)
    want = _jax_on_one_device(
        lambda c, *rest: jstep(c, 2, rest[:n], *rest[n:]), mesh1, n + 4,
    )(coef, *jargs, *hy)
    tstep = t_sgd.make_sparse_step_bucketed("logistic", tbss, dim, layout)
    got = tstep(torch.from_numpy(coef), 2, targs,
                *(torch.from_numpy(a) for a in hy))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)


# -- whole-loop trainers ----------------------------------------------------------------

def _dense_pair(mesh1, dtype, tol, loss="logistic", reg=0.01,
                elastic_net=0.0):
    x, y, w = dense_lr_data()
    kw = dict(loss=loss, max_iter=50, learning_rate=0.5,
              global_batch_size=64, reg=reg, elastic_net=elastic_net,
              tol=tol, seed=3, dtype=dtype)
    lj, lt = EpochRecorder(), EpochRecorder()
    want = jax_sgd.train_linear_model(x, y, w, mesh=mesh1, listeners=[lj], **kw)
    got = t_sgd.train_linear_model(x, y, w, listeners=[lt], **kw)
    return got, want, lt, lj


@pytest.mark.parametrize("dtype,tol_fit", [(np.float64, F64_FIT_TOL),
                                           (np.float32, F32_FIT_TOL)])
@pytest.mark.parametrize("tol", [0.0, 0.45])
def test_train_linear_model_matches_jax(dtype, tol_fit, tol, mesh1, on_cpu):
    """Dense trainer vs JAX's on one device; ``tol`` 0.45 stops both early
    at the same epoch."""
    got, want, lt, lj = _dense_pair(mesh1, dtype, tol)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=tol_fit, atol=tol_fit)
    assert lt.epoch == lj.epoch
    assert (lt.epoch < 49) == (tol > 0)
    np.testing.assert_array_equal(lt.state, got)
    np.testing.assert_array_equal(lt.terminated, got)


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_train_linear_model_other_losses_match_jax(loss, mesh1, on_cpu):
    """The shared trainer under the hinge and squared losses, with elastic
    net (the proximal soft-threshold) on."""
    got, want, lt, lj = _dense_pair(mesh1, np.float64, 0.0, loss=loss,
                                    reg=0.6, elastic_net=0.5)
    np.testing.assert_allclose(got, want, rtol=F64_FIT_TOL, atol=F64_FIT_TOL)
    assert lt.epoch == lj.epoch
    l2_only = _dense_pair(mesh1, np.float64, 0.0, loss=loss, reg=0.6)[0]
    assert np.abs(got - l2_only).max() > 1e-3   # the L1 step is active


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("tol", [0.0, 0.62])
def test_train_sparse_csr_matches_jax(layout, tol, mesh1, on_cpu, monkeypatch):
    """Sparse trainer vs JAX's (its layout chosen by its env var) on one
    device; ``tol`` 0.62 stops both early at the same epoch."""
    monkeypatch.setenv(LAYOUT_ENV, layout)
    indptr, indices, values, dim, y, w = sparse_lr_data()
    kw = dict(loss="logistic", max_iter=30, learning_rate=2.0,
              global_batch_size=150, reg=0.001, elastic_net=0.0, tol=tol,
              seed=5)
    lj, lt = EpochRecorder(), EpochRecorder()
    want = jax_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, y, w, mesh=mesh1, listeners=[lj], **kw)
    got = t_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, y, w, listeners=[lt], layout=layout,
        **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=F32_FIT_TOL, atol=F32_FIT_TOL)
    assert lt.epoch == lj.epoch
    assert (lt.epoch < 29) == (tol > 0)


@pytest.mark.parametrize("sync_every", [1, 3])
def test_device_loop_equals_per_step_check(sync_every, on_cpu, monkeypatch):
    """Reading the device flag every few steps gives exactly what a check
    after every step gives: the same coefficients and epoch count."""
    x, y, w = dense_lr_data()
    kw = dict(loss="logistic", max_iter=40, learning_rate=0.5,
              global_batch_size=64, reg=0.01, elastic_net=0.0, tol=0.45,
              seed=3)
    lb, lo = EpochRecorder(), EpochRecorder()
    base = t_sgd.train_linear_model(x, y, w, listeners=[lb], **kw)
    # The stop falls inside a group of SYNC_EVERY steps, not at its end.
    assert 0 < lb.epoch < 39 and (lb.epoch + 1) % t_sgd.SYNC_EVERY != 0
    monkeypatch.setattr(t_sgd, "SYNC_EVERY", sync_every)
    other = t_sgd.train_linear_model(x, y, w, listeners=[lo], **kw)
    np.testing.assert_array_equal(other, base)
    assert lo.epoch == lb.epoch


def test_device_loop_stops_on_nan_like_while_loop(on_cpu):
    """A NaN loss is not above ``tol``: the loop stops, as
    ``lax.while_loop`` does."""
    coef = torch.zeros(2, dtype=torch.float64)
    steps = []

    def step(c, ep):
        steps.append(ep)
        return c + 1.0, torch.tensor(float("nan") if ep == 2 else 1.0,
                                     dtype=torch.float64)

    out, ep, loss = t_sgd._device_loop(
        step, coef, 0, torch.tensor(float("inf"), dtype=torch.float64),
        torch.tensor(0.0, dtype=torch.float64), 20)
    assert int(ep) == 3 and torch.isnan(loss)
    assert out.tolist() == [3.0, 3.0]
    assert len(steps) == t_sgd.SYNC_EVERY   # one host read, then stop


# -- the estimator end to end -----------------------------------------------------------

def _estimators(**params):
    j, t = jax_lr.LogisticRegression(), fml.LogisticRegression()
    for name, value in params.items():
        getattr(j, f"set_{name}")(value)
        getattr(t, f"set_{name}")(value)
    return j, t


def test_estimator_param_map_is_byte_identical():
    j, t = _estimators(reg=0.1, tol=1e-3, global_batch_size=64, seed=7,
                       weight_col="w", max_iter=9)
    assert json.dumps(t.get_param_map_json()) == \
        json.dumps(j.get_param_map_json())


@pytest.mark.parametrize("tol", [0.0, 0.45])
def test_fit_dense_matches_jax(tol, mesh1, on_cpu):
    x, y, w = dense_lr_data()
    cols = {"features": x, "label": y, "weight": w}
    j, t = _estimators(seed=2, global_batch_size=64, learning_rate=0.5,
                       reg=0.01, tol=tol, max_iter=30, weight_col="weight")
    j.mesh = mesh1
    want = j.fit(JaxTable(cols))
    got = t.fit(fml.Table(cols))
    np.testing.assert_allclose(got.coefficient, want.coefficient,
                               rtol=F64_FIT_TOL, atol=F64_FIT_TOL)
    assert json.dumps(got.get_param_map_json()) == \
        json.dumps(want.get_param_map_json())
    (tj,) = want.transform(JaxTable({"features": x}))
    (tt,) = got.transform(fml.Table({"features": x}))
    np.testing.assert_array_equal(tt.column("prediction"),
                                  tj.column("prediction"))


def test_fit_dense_float32_column_trains_in_float32(on_cpu):
    """The fit computes in the feature column's float dtype: a float32
    table trains as ``train_linear_model(dtype=float32)`` does."""
    x, y, w = dense_lr_data()
    t = fml.LogisticRegression().set_seed(2).set_global_batch_size(64)
    got = t.fit(fml.Table({"features": x.astype(np.float32), "label": y}))
    want = t_sgd.train_linear_model(
        x.astype(np.float32), y, np.ones_like(y), "logistic", 20, 0.1, 64,
        0.0, 0.0, 1e-6, 2, dtype=np.float32)
    np.testing.assert_array_equal(got.coefficient, want.astype(np.float64))


def test_fit_sparse_matches_jax(mesh1, on_cpu, monkeypatch):
    """SparseVector features: the default (unsorted) layout on both sides."""
    monkeypatch.delenv(LAYOUT_ENV, raising=False)
    indptr, indices, values, dim, y, w = sparse_lr_data()
    j, t = _estimators(seed=4, global_batch_size=150, learning_rate=2.0,
                       reg=0.001, tol=0.0, max_iter=15)
    j.mesh = mesh1
    want = j.fit(JaxTable({"features": sparse_rows(
        indptr, indices, values, dim, JaxSparseVector), "label": y}))
    rows = sparse_rows(indptr, indices, values, dim, fml.SparseVector)
    got = t.fit(fml.Table({"features": rows, "label": y}))
    np.testing.assert_allclose(got.coefficient, want.coefficient,
                               rtol=F32_FIT_TOL, atol=F32_FIT_TOL)
    (tt,) = got.transform(fml.Table({"features": rows}))
    assert tt.column("rawPrediction").shape == (rows.size, 2)


def test_fit_reaches_reference_fixture(on_cpu):
    """The reference's pinned coefficients
    (``LogisticRegressionTest.java:91-94``), reached by the port with the
    configuration ``tests/test_convergence_parity.py`` uses."""
    ref = reference_train_table()
    table = fml.Table({c: ref.column(c) for c in ref.column_names})
    model = (fml.LogisticRegression().set_seed(0).set_tol(0.0)
             .set_global_batch_size(32).set_max_iter(20)
             .set_learning_rate(0.1).set_weight_col("weight").fit(table))
    np.testing.assert_allclose(model.coefficient, REFERENCE_COEF, atol=0.1)
    np.testing.assert_allclose(model.coefficient, REFERENCE_COEF, atol=5e-3)


def test_save_load_across_packages(tmp_path, on_cpu):
    """The fitted model and the unfitted estimator, saved by either
    package and loaded by the other."""
    x, y, _ = dense_lr_data(n=60)
    est = fml.LogisticRegression().set_seed(1).set_reg(0.05).set_tol(0.0)
    model = est.fit(fml.Table({"features": x, "label": y}))

    model.save(str(tmp_path / "port_model"))
    loaded = jax_read_write.load_stage(str(tmp_path / "port_model"))
    assert isinstance(loaded, jax_lr.LogisticRegressionModel)
    np.testing.assert_array_equal(loaded.coefficient, model.coefficient)
    loaded.save(str(tmp_path / "jax_model"))
    back = fml.load_stage(str(tmp_path / "jax_model"))
    assert isinstance(back, fml.LogisticRegressionModel)
    np.testing.assert_array_equal(back.coefficient, model.coefficient)
    assert back.get_param_map_json() == model.get_param_map_json()

    est.save(str(tmp_path / "port_est"))
    j_est = jax_read_write.load_stage(str(tmp_path / "port_est"))
    assert isinstance(j_est, jax_lr.LogisticRegression)
    assert j_est.get_param_map_json() == est.get_param_map_json()
    j_est.set_max_iter(3)
    j_est.save(str(tmp_path / "jax_est"))
    t_est = fml.load_stage(str(tmp_path / "jax_est"))
    assert isinstance(t_est, fml.LogisticRegression)
    assert t_est.get_max_iter() == 3 and t_est.get_reg() == 0.05


# -- refusals ---------------------------------------------------------------------------

def test_multinomial_fit_refused(on_cpu):
    """The multinomial fits that both packages refuse: labels that are not
    exactly 0..k-1, SparseVector features, and more than two classes under
    ``multiClass="binomial"`` (tests/test_torch_multinomial.py holds the
    fits that run)."""
    x, _, _ = dense_lr_data(n=30)
    three = np.arange(30) % 3
    indptr, indices, values, dim, _, _ = sparse_lr_data(n=30, dim=20)
    cases = (
        ("multinomial", {"features": x, "label": 2.0 * three},
         "covering 0..k-1"),
        ("auto", {"label": three.astype(np.float32)}, "dense features only"),
        ("binomial", {"features": x, "label": three.astype(float)},
         "labels in"),
    )
    for multi_class, cols, match in cases:
        if "features" not in cols:
            jcols = dict(cols, features=sparse_rows(
                indptr, indices, values, dim, JaxSparseVector))
            cols = dict(cols, features=sparse_rows(
                indptr, indices, values, dim, fml.SparseVector))
        else:
            jcols = cols
        with pytest.raises(ValueError, match=match):
            fml.LogisticRegression().set_multi_class(multi_class).fit(
                fml.Table(cols))
        with pytest.raises(ValueError, match=match):
            jax_lr.LogisticRegression().set_multi_class(multi_class).fit(
                JaxTable(jcols))


def test_unported_paths_refused(on_cpu, tmp_path, monkeypatch, mesh1):
    """What stays unported raises ``NotImplementedError`` naming its
    ROADMAP.md Queue 1 item. (The checkpoint knobs, ``resume``,
    ``cache_dir``, streamed fits and ``mode="host"`` are ported: their
    parity cases are in ``tests/test_torch_stream_fit.py``; ``mesh=`` is
    ported: a world-1 mesh here, P ranks in
    ``tests/test_torch_data_parallel.py``.)"""
    from flinkml_tpu_torch.iteration import IterationConfig
    from flinkml_tpu_torch.iteration import checkpoint as t_ckpt
    from flinkml_tpu_torch.models import online_logistic_regression as t_olr

    x, y, w = dense_lr_data(n=30)
    with pytest.raises(ValueError, match="mode must be"):
        t_lr.train_logistic_regression(x, y, w, 5, 0.1, 8, 0.0, 0.0, 0,
                                       mode="nope")
    indptr, indices, values, dim, ys, ws = sparse_lr_data(n=20, dim=30)
    # The cumsum layout is ported (item 14): it trains, as the other two.
    fits = [t_sgd.train_linear_model_sparse_csr(
        indptr, indices, values, dim, ys, ws, "logistic", 2, 0.1, 8, 0.0,
        0.0, 0.0, 0, layout=layout) for layout in ("cumsum", "unsorted")]
    np.testing.assert_allclose(*fits, rtol=F32_FIT_TOL, atol=F32_FIT_TOL)
    with pytest.raises(ValueError, match="expected one of"):
        t_sgd.prepare_sparse_buckets(indptr, indices, values, dim, ys, ws, 8,
                                     layout="nope")
    # mesh= is ported (item 7a): a world-1 mesh fits as JAX's one-device
    # mesh does, and as the port without a mesh, bit for bit.
    from flinkml_tpu_torch.parallel import DeviceMesh as TorchMesh

    table = fml.Table({"features": x, "label": y})
    meshed = fml.LogisticRegression(mesh=TorchMesh()).set_seed(1).fit(table)
    plain = fml.LogisticRegression().set_seed(1).fit(table)
    np.testing.assert_array_equal(meshed.coefficient, plain.coefficient)
    want = jax_lr.LogisticRegression(mesh=mesh1).set_seed(1).fit(
        JaxTable({"features": x, "label": y})).coefficient
    np.testing.assert_allclose(meshed.coefficient, want, rtol=F64_FIT_TOL,
                               atol=F64_FIT_TOL)
    # Sharding plans (item 7b) and the fit half of the precision
    # policies (item 3) are ported: parity cases with JAX's fits on its
    # one-device mesh (more in tests/test_torch_sharding.py and
    # tests/test_torch_plan_precision.py).
    from flinkml_tpu.sharding import plan as jax_plan
    from flinkml_tpu_torch.sharding import plan as t_plan

    for knobs, jax_knobs, tol in (
            ({"sharding_plan": t_plan.REPLICATED},
             {"sharding_plan": jax_plan.REPLICATED}, F64_FIT_TOL),
            ({"precision": "mixed"}, {"precision": "mixed"}, 1e-5)):
        got = fml.LogisticRegression(**knobs).set_seed(1).fit(table)
        want = jax_lr.LogisticRegression(mesh=mesh1, **jax_knobs).set_seed(
            1).fit(JaxTable({"features": x, "label": y}))
        np.testing.assert_allclose(got.coefficient, want.coefficient,
                                   rtol=0, atol=tol)
    # rescale="reshard" of assembled leaves is ported with 7b, the agreed
    # commits with 7c: one process, save_agreed is the manager's save, as
    # in JAX (the P-rank commits: tests/test_torch_stream_mp.py).
    from flinkml_tpu.iteration import checkpoint as jax_ckpt

    assert t_iteration.CheckpointManager(
        str(tmp_path), rescale="reshard").rescale_policy.on_mismatch == \
        "reshard"
    state = {"coef": np.arange(3.0)}
    t_ckpt.save_agreed(t_iteration.CheckpointManager(str(tmp_path / "t")),
                       state, 1)
    jax_ckpt.save_agreed(jax_ckpt.CheckpointManager(str(tmp_path / "j"),
                                                    world_size=1), state, 1)
    for d in ("t", "j"):
        got, epoch = t_iteration.CheckpointManager(str(tmp_path / d)).restore(
            1, like={"coef": 0})
        np.testing.assert_array_equal(got["coef"], state["coef"])
    # The multi-process online stream refuses checkpoints, as JAX's does.
    monkeypatch.setattr(t_olr, "_process_count", lambda: 2)
    with pytest.raises(NotImplementedError,
                       match="multi-process online stream"):
        fml.OnlineLogisticRegression().fit_stream(
            [table], checkpoint_manager=t_iteration.CheckpointManager(
                str(tmp_path / "olr")))
    # The numerics sentinel and self-healing recovery (item 12) are ported;
    # on the multi-process online stream they are refused, as in JAX.
    for knob in ("sentinel", "recovery"):
        with pytest.raises(NotImplementedError,
                           match="multi-process online stream"):
            fml.OnlineLogisticRegression().fit_stream([table],
                                                      **{knob: object()})
    monkeypatch.undo()
    from flinkml_tpu_torch.recovery import NumericsSentinel, RecoveryPolicy

    config = IterationConfig(sentinel=NumericsSentinel(),
                             recovery=RecoveryPolicy(backoff_s=0.0))
    assert config.sentinel.interval == 1 and config.recovery.max_retries == 3
    # The sorted-column stream is ported (the data/ package's prefetched
    # SortedSparseColumn tables): a dense feature column is refused.
    with pytest.raises(ValueError, match="not a SortedSparseColumn"):
        t_sgd.train_linear_model_sorted_stream(
            [table], "features", "label", loss="logistic", max_iter=1,
            learning_rate=0.1, reg=0.0, elastic_net=0.0, tol=0.0)


def test_fit_without_card_raises_device_error():
    """Outside ``use_device('cpu')`` the fit asks for the card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    x, y, _ = dense_lr_data(n=30)
    with pytest.raises(RuntimeError, match="use_device"):
        fml.LogisticRegression().fit(fml.Table({"features": x, "label": y}))
