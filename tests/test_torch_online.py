"""OnlineLogisticRegression (FTRL) in the port against the JAX package, on
the CPU: every case of ``tests/test_online_logistic_regression.py`` and the
one-process OnlineLogisticRegression cases of ``tests/test_online_resume.py``
(a crash is a stream that raises at a batch, a damaged snapshot a truncated
or rewritten file; the cases with the fault seams are in
``tests/test_torch_preemption.py`` and ``tests/test_torch_recovery.py``), the
FTRL algebra and step against the JAX functions, and FTRL carries and
models crossing packages.

Declared tolerance against JAX: 1e-10 (float64; the products add in
another order). Within the port, resume is bit for bit.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.io import read_write as jax_read_write
from flinkml_tpu.iteration import CheckpointManager as JaxCheckpointManager
from flinkml_tpu.models import online_logistic_regression as jax_olr
from flinkml_tpu.models.logistic_regression import (
    LogisticRegression as JaxLogisticRegression,
)
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.models import online_logistic_regression as t_olr
from tests._torch_port_common import on_cpu  # noqa: F401

F64_TOL = 1e-10
N_BATCHES = 12
CRASH_EPOCH = 7
INTERVAL = 2


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


def make_stream(rng, n_batches=20, batch=64, dim=5):
    true = rng.normal(size=dim) * 2
    cols = []
    for _ in range(n_batches):
        x = rng.normal(size=(batch, dim))
        cols.append({"features": x, "label": (x @ true > 0).astype(np.float64)})
    x = np.concatenate([c["features"] for c in cols])
    y = np.concatenate([c["label"] for c in cols])
    return cols, x, y


def tables(cols, cls=None):
    cls = cls or fml.Table
    return [cls(dict(c)) for c in cols]


def fit_both(cols, configure=lambda e: e, **kw):
    got = configure(fml.OnlineLogisticRegression()).fit_stream(
        tables(cols), **kw)
    want = configure(jax_olr.OnlineLogisticRegression()).fit_stream(
        tables(cols, JaxTable), **kw)
    np.testing.assert_allclose(got.coefficient, want.coefficient,
                               rtol=F64_TOL, atol=F64_TOL)
    assert got.model_version == want.model_version
    return got, want


def test_param_defaults():
    for olr in (fml.OnlineLogisticRegression(),
                jax_olr.OnlineLogisticRegression()):
        assert olr.get_alpha() == 0.1 and olr.get_beta() == 0.1
        assert olr.get_batch_strategy() == "count"
        assert olr.get_global_batch_size() == 32
    assert json.dumps(fml.OnlineLogisticRegression().get_param_map_json()) \
        == json.dumps(jax_olr.OnlineLogisticRegression().get_param_map_json())


def test_fit_stream_learns(rng, on_cpu):
    cols, x, y = make_stream(rng)
    got, want = fit_both(cols, lambda e: e.set_alpha(0.5))
    assert got.model_version == 20
    (out,) = got.transform(fml.Table({"features": x}))
    assert np.mean(out.column("prediction") == y) > 0.9
    assert (out.column("modelVersion") == 20).all()
    (jout,) = want.transform(JaxTable({"features": x}))
    np.testing.assert_allclose(out.column("rawPrediction"),
                               jout.column("rawPrediction"), rtol=F64_TOL,
                               atol=F64_TOL)


def test_fit_single_table_batches(rng, on_cpu):
    _, x, y = make_stream(rng, n_batches=4, batch=32)
    got = fml.OnlineLogisticRegression().set_global_batch_size(32).fit(
        fml.Table({"features": x, "label": y}))
    want = jax_olr.OnlineLogisticRegression().set_global_batch_size(32).fit(
        JaxTable({"features": x, "label": y}))
    assert got.model_version == want.model_version == 4
    np.testing.assert_allclose(got.coefficient, want.coefficient,
                               rtol=F64_TOL, atol=F64_TOL)


def test_warm_start_from_offline_model(rng, on_cpu):
    cols, x, y = make_stream(rng, n_batches=3)
    offline = (JaxLogisticRegression().set_seed(0).set_max_iter(100)
               .set_global_batch_size(512)
               .fit(JaxTable({"features": x, "label": y})))
    data = offline.get_model_data()[0].column("coefficient")
    got, want = fit_both(cols[:1], lambda e: e.set_initial_model_data(
        fml.Table({"coefficient": data})) if isinstance(
            e, fml.OnlineLogisticRegression) else e.set_initial_model_data(
                JaxTable({"coefficient": data})))
    (out,) = got.transform(fml.Table({"features": x}))
    assert np.mean(out.column("prediction") == y) > 0.95


def test_l1_sparsifies(rng, on_cpu):
    dim, cols = 10, []
    for _ in range(30):
        x = rng.normal(size=(64, dim))
        cols.append({"features": x, "label": (x[:, 0] > 0).astype(np.float64)})
    got, _ = fit_both(cols, lambda e: e.set_alpha(0.5).set_reg(0.1)
                      .set_elastic_net(1.0))
    coef = got.coefficient
    assert abs(coef[0]) > 0.5
    assert np.sum(np.abs(coef[1:]) < 1e-9) >= dim // 2


def test_empty_stream_raises(on_cpu):
    for est in (fml.OnlineLogisticRegression(),
                jax_olr.OnlineLogisticRegression()):
        with pytest.raises(ValueError, match="empty"):
            est.fit_stream([])


def test_save_load(tmp_path, rng, on_cpu):
    """Saved by either package, loaded by the other, the model version
    kept."""
    cols, _, _ = make_stream(rng, n_batches=5)
    model = fml.OnlineLogisticRegression().set_alpha(0.5).fit_stream(
        tables(cols))
    model.save(str(tmp_path / "port"))
    loaded = fml.OnlineLogisticRegressionModel.load(str(tmp_path / "port"))
    assert loaded.model_version == 5
    np.testing.assert_array_equal(loaded.coefficient, model.coefficient)
    jloaded = jax_read_write.load_stage(str(tmp_path / "port"))
    assert isinstance(jloaded, jax_olr.OnlineLogisticRegressionModel)
    assert jloaded.model_version == 5
    np.testing.assert_array_equal(jloaded.coefficient, model.coefficient)
    jloaded.save(str(tmp_path / "jax"))
    back = fml.load_stage(str(tmp_path / "jax"))
    assert isinstance(back, fml.OnlineLogisticRegressionModel)
    assert back.model_version == 5
    np.testing.assert_array_equal(back.coefficient, model.coefficient)


def test_model_data_round_trip(rng, on_cpu):
    cols, _, _ = make_stream(rng, n_batches=2)
    model = fml.OnlineLogisticRegression().fit_stream(tables(cols))
    other = fml.OnlineLogisticRegressionModel().set_model_data(
        *model.get_model_data())
    assert other.model_version == 2
    np.testing.assert_array_equal(other.coefficient, model.coefficient)
    jother = jax_olr.OnlineLogisticRegressionModel().set_model_data(
        JaxTable({c: model.get_model_data()[0].column(c)
                  for c in ("coefficient", "modelVersion")}))
    assert jother.model_version == 2


def test_ftrl_update_matches_jax():
    """One step of the algebra and the batch update, with L1 active, from
    a state where some coordinates are past the threshold."""
    rng = np.random.default_rng(4)
    d = 7
    x, y = rng.normal(size=(40, d)), (rng.random(40) > 0.5) * 1.0
    w = rng.uniform(0.5, 2.0, size=40)
    z, n, coef = rng.normal(size=d), rng.random(d), rng.normal(size=d) * 0.3
    args = (0.3, 1.0, 0.8, 0.02)
    got = t_olr._ftrl_update(*(torch.from_numpy(a) for a in
                               (z, n, coef, x, y, w)), *args)
    want = jax_olr._ftrl_update(z, n, coef, x, y, w, *args)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=F64_TOL,
                                   atol=F64_TOL)
    assert (got[2].numpy() == 0.0).any()


# -- crash, damage and resume ------------------------------------------------------


def lr_batches(seed=0, n=N_BATCHES, rows=48, dim=5, cls=None):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=dim) * 2
    out = []
    for _ in range(n):
        x = rng.normal(size=(rows, dim))
        out.append((cls or fml.Table)(
            {"features": x, "label": (x @ true > 0).astype(np.float64)}))
    return out


def _lr(pkg=fml):
    cls = fml.OnlineLogisticRegression if pkg is fml \
        else jax_olr.OnlineLogisticRegression
    return cls().set_alpha(0.5).set_reg(0.01)


def _crashing(batches, at=CRASH_EPOCH):
    """The stream, raising when batch ``at`` is pulled."""
    for i, b in enumerate(batches):
        if i == at:
            raise RuntimeError("injected crash")
        yield b


def _crash(est, batches, mgr):
    with pytest.raises(RuntimeError, match="injected"):
        est.fit_stream(_crashing(batches), checkpoint_manager=mgr,
                       checkpoint_interval=INTERVAL)
    assert mgr.latest_epoch() == CRASH_EPOCH - 1


def _damage(directory, epoch, how):
    ckpt = directory / f"ckpt-{epoch}"
    if how == "truncate":
        arrays = ckpt / "arrays.npz"
        arrays.write_bytes(arrays.read_bytes()[:50])
    elif how == "manifest":
        (ckpt / "meta.json").write_text("not json")
    else:  # the arrays rewritten: the fingerprint disagrees
        meta = json.loads((ckpt / "meta.json").read_text())
        with np.load(ckpt / "arrays.npz") as z:
            leaves = {k: z[k] for k in z.files}
        leaves["leaf_0"] = leaves["leaf_0"] + 1.0
        np.savez(ckpt / "arrays.npz", **leaves)
        (ckpt / "meta.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("how", ["truncate", "manifest", "arrays"])
def test_online_lr_kill_corrupt_resume_bit_exact(how, tmp_path, on_cpu):
    """Crash at batch 7, the newest snapshot (6) damaged: the resume walks
    back to 4 and ends on the uninterrupted model, bit for bit."""
    batches = lr_batches()
    golden = _lr().fit_stream(batches)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    _crash(_lr(), batches, mgr)
    _damage(tmp_path / "ckpt", 6, how)
    assert mgr.newest_valid_epoch() == 4
    recovered = _lr().fit_stream(batches, checkpoint_manager=mgr,
                                 checkpoint_interval=INTERVAL, resume=True)
    np.testing.assert_array_equal(recovered.coefficient, golden.coefficient)
    assert recovered.model_version == golden.model_version == N_BATCHES
    want = _lr(jax_olr).fit_stream(lr_batches(cls=JaxTable))
    np.testing.assert_allclose(golden.coefficient, want.coefficient,
                               rtol=F64_TOL, atol=F64_TOL)


def test_replay_vs_continue_cursor(tmp_path, on_cpu):
    batches = lr_batches(seed=3)
    golden = _lr().fit_stream(batches)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    _crash(_lr(), batches, mgr)
    recovered = _lr().fit_stream(
        iter(batches[6:]), checkpoint_manager=mgr,
        checkpoint_interval=INTERVAL, resume=True, stream_resume="continue")
    np.testing.assert_array_equal(recovered.coefficient, golden.coefficient)
    assert recovered.model_version == N_BATCHES

    mgr2 = CheckpointManager(str(tmp_path / "ckpt2"), max_to_keep=10)
    _crash(_lr(), batches, mgr2)
    replayed = _lr().fit_stream(batches, checkpoint_manager=mgr2,
                                checkpoint_interval=INTERVAL, resume=True,
                                stream_resume="replay")
    np.testing.assert_array_equal(replayed.coefficient, golden.coefficient)


def test_resume_after_completion_is_noop(tmp_path, on_cpu):
    batches = lr_batches(seed=9)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    done = _lr().fit_stream(batches, checkpoint_manager=mgr,
                            checkpoint_interval=INTERVAL)
    assert mgr.latest_epoch() == N_BATCHES
    again = _lr().fit_stream(batches, checkpoint_manager=mgr,
                             checkpoint_interval=INTERVAL, resume=True)
    np.testing.assert_array_equal(again.coefficient, done.coefficient)
    assert again.model_version == done.model_version


def test_resume_with_exhausted_stream_returns_checkpointed_model(tmp_path,
                                                                 on_cpu):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    done = _lr().fit_stream(lr_batches(seed=23), checkpoint_manager=mgr,
                            checkpoint_interval=2)
    again = _lr().fit_stream(iter([]), checkpoint_manager=mgr,
                             checkpoint_interval=2, resume=True,
                             stream_resume="continue")
    np.testing.assert_array_equal(again.coefficient, done.coefficient)
    assert again.model_version == done.model_version


def test_empty_stream_with_warm_start_returns_initial_model(on_cpu):
    init = np.array([1.0, -2.0, 3.0])
    for est in (fml.OnlineLogisticRegression(),
                jax_olr.OnlineLogisticRegression()):
        est._initial_coefficient = init
        model = est.fit_stream(iter([]))
        np.testing.assert_array_equal(model.coefficient, init)
        assert model.model_version == 0


def test_resume_without_manager_rejected(on_cpu):
    with pytest.raises(ValueError, match="requires a checkpoint_manager"):
        _lr().fit_stream(lr_batches(n=2), resume=True)


def test_double_failure_recovery(tmp_path, on_cpu):
    batches = lr_batches(seed=5)
    golden = _lr().fit_stream(batches)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    for at in (3, 9):
        with pytest.raises(RuntimeError, match="injected"):
            _lr().fit_stream(_crashing(batches, at), checkpoint_manager=mgr,
                             checkpoint_interval=INTERVAL,
                             resume=mgr.latest_epoch() is not None)
    assert mgr.latest_epoch() == 8
    resumed = _lr().fit_stream(batches, checkpoint_manager=mgr,
                               checkpoint_interval=INTERVAL, resume=True)
    np.testing.assert_array_equal(resumed.coefficient, golden.coefficient)
    assert resumed.model_version == N_BATCHES


@pytest.mark.parametrize("first", ["jax", "port"])
def test_ftrl_carry_resumes_across_packages(first, tmp_path, on_cpu):
    """An FTRL fit crashed in one package resumes in the other: the dict
    carry's leaves in the JAX package's order (coef, n, version, z), so
    ``z`` never comes back as ``coef``; the result is the uninterrupted
    fit's."""
    golden = _lr().fit_stream(lr_batches())
    if first == "jax":
        mgr = JaxCheckpointManager(str(tmp_path), max_to_keep=10)
        with pytest.raises(RuntimeError, match="injected"):
            _lr(jax_olr).fit_stream(_crashing(lr_batches(cls=JaxTable)),
                                    checkpoint_manager=mgr,
                                    checkpoint_interval=INTERVAL)
        resumed = _lr().fit_stream(
            lr_batches(), checkpoint_manager=CheckpointManager(
                str(tmp_path), max_to_keep=10),
            checkpoint_interval=INTERVAL, resume=True)
    else:
        _crash(_lr(), lr_batches(), CheckpointManager(str(tmp_path),
                                                      max_to_keep=10))
        resumed = _lr(jax_olr).fit_stream(
            lr_batches(cls=JaxTable), checkpoint_manager=JaxCheckpointManager(
                str(tmp_path), max_to_keep=10),
            checkpoint_interval=INTERVAL, resume=True)
    np.testing.assert_allclose(resumed.coefficient, golden.coefficient,
                               rtol=F64_TOL, atol=F64_TOL)
    assert resumed.model_version == N_BATCHES
    meta = json.loads((tmp_path / "ckpt-6" / "meta.json").read_text())
    assert meta["treedef"] == \
        "PyTreeDef({'coef': *, 'n': *, 'version': *, 'z': *})"


# -- what stays unported -------------------------------------------------------------


def test_unported_online_paths_refused(monkeypatch, tmp_path, on_cpu):
    """The sentinel and recovery (item 12) are ported: the same poisoned
    stream raises at the same source batch under ``sentinel=`` and heals
    under ``recovery=`` to JAX's healed model (within F64_TOL) with the
    same summary. What stays refused: the multi-process stream's
    checkpoints, sentinel and recovery (refused in JAX too) and a mesh
    that is not a DeviceMesh."""
    from flinkml_tpu import recovery as jax_recovery
    from flinkml_tpu_torch import recovery as t_recovery

    def poisoned(cls):
        out = lr_batches(cls=cls)
        out[5] = cls({"features": np.full((48, 5), np.nan),
                      "label": np.zeros(48)})
        return out

    for pkg, rec, cls in ((fml, t_recovery, fml.Table),
                          (jax_olr, jax_recovery, JaxTable)):
        with pytest.raises(rec.NumericsError) as ei:
            _lr(pkg).fit_stream(poisoned(cls),
                                sentinel=rec.NumericsSentinel())
        assert ei.value.source_index == 5
    got = _lr().fit_stream(poisoned(fml.Table), recovery=t_recovery.
                           RecoveryPolicy(backoff_s=0.0))
    want = _lr(jax_olr).fit_stream(poisoned(JaxTable), recovery=jax_recovery.
                                   RecoveryPolicy(backoff_s=0.0))
    np.testing.assert_allclose(got.coefficient, want.coefficient,
                               rtol=F64_TOL, atol=F64_TOL)
    assert got.recovery_summary == want.recovery_summary
    # The multi-process stream (item 7c) is ported; its checkpoints,
    # sentinel and recovery are refused, as in JAX (P ranks:
    # tests/test_torch_stream_mp.py).
    monkeypatch.setattr(t_olr, "_process_count", lambda: 2)
    with pytest.raises(NotImplementedError,
                       match="multi-process online stream"):
        _lr().fit_stream(lr_batches(n=2), checkpoint_manager=CheckpointManager(
            str(tmp_path)))
    for knob in ("sentinel", "recovery"):
        with pytest.raises(NotImplementedError,
                           match="multi-process online stream"):
            _lr().fit_stream(lr_batches(n=2), **{knob: object()})
    with pytest.raises(TypeError, match="DeviceMesh"):
        fml.OnlineLogisticRegression(mesh=object())
