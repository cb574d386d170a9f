"""OnlineKMeans in the port (``flinkml_tpu_torch``) against the JAX package,
on the CPU: a counterpart of each case of ``tests/test_online_kmeans.py``
fed the same seeded batches to both packages, checkpoint/resume
(``replay`` and ``continue``, a crash being a stream that raises at a
batch), snapshots and saved models crossing packages, and the refusals.

Both packages compute in float64 (the JAX step casts each batch to
float64). Declared tolerance against JAX: 1e-12 relative and absolute on
centroids (the distance and one-hot products add in another order);
assignments, versions and model data layouts are equal. Within the port,
resume is bit for bit.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.iteration import CheckpointManager as JaxCheckpointManager
from flinkml_tpu.models import kmeans as jax_kmeans
from flinkml_tpu.models import online_kmeans as jax_okm
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.models import online_kmeans as t_okm
from flinkml_tpu_torch.models import online_logistic_regression as t_olr
from tests._torch_port_common import on_cpu  # noqa: F401

TOL = 1e-12
N_BATCHES = 12
INTERVAL = 2


def blob_cols(rng, centers, n_each=60, scale=0.3):
    return {"features": np.concatenate(
        [c + rng.normal(scale=scale, size=(n_each, len(c))) for c in centers]
    )}


def blob_stream(seed, centers, n_batches, n_each=40):
    rng = np.random.default_rng(seed)
    return [blob_cols(rng, centers, n_each) for _ in range(n_batches)]


def tables(cols, cls=None):
    cls = cls or fml.Table
    return [cls(dict(c)) for c in cols]


def fit_both(cols, configure, **kw):
    """The same batches through both packages' ``fit_stream``."""
    got = configure(t_okm.OnlineKMeans()).fit_stream(iter(tables(cols)), **kw)
    want = configure(jax_okm.OnlineKMeans()).fit_stream(
        iter(tables(cols, JaxTable)), **kw)
    assert got.centroids.dtype == want.centroids.dtype == np.float64
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=TOL,
                               atol=TOL)
    assert got.model_version == want.model_version
    return got, want


def _okm(module=t_okm, seed=5):
    return module.OnlineKMeans().set_k(2).set_seed(seed).set_decay_factor(0.5)


def _okm_configure(e):
    return e.set_k(2).set_seed(5).set_decay_factor(0.5)


def _crashing(batches, at):
    for i, t in enumerate(batches):
        if i == at:
            raise RuntimeError("injected crash")
        yield t


def _stream(seed=0, cls=None):
    return tables(blob_stream(seed, [(0.0, 0.0), (9.0, 9.0)], N_BATCHES), cls)


# -- counterparts of tests/test_online_kmeans.py ---------------------------------------

def test_decay_rule_exact_single_centroid(on_cpu):
    """Two far-apart warm centroids, every batch on centroid 0: the hand
    recurrence n' = decay·n + count, c' = (decay·n·c + sum)/n'."""
    decay = 0.5
    far = np.array([[0.0, 0.0], [100.0, 100.0]])
    cols = [{"features": np.full((4, 2), float(v))} for v in (1, 2, 3)]

    def configure(e):
        table = (fml.Table if isinstance(e, t_okm.OnlineKMeans)
                 else JaxTable)({"centroids": far[None]})
        return e.set_k(2).set_decay_factor(decay).set_initial_model_data(table)

    got, _ = fit_both(cols, configure)
    c, n = np.array([0.0, 0.0]), 0.0
    for v in (1.0, 2.0, 3.0):
        n_new = decay * n + 4.0
        c = (decay * n * c + np.full(2, v) * 4) / n_new
        n = n_new
    np.testing.assert_allclose(got.centroids[0], c, rtol=1e-12)
    np.testing.assert_array_equal(got.centroids[1], far[1])


def test_warm_start_tracks_drift(on_cpu):
    rng = np.random.default_rng(1)
    warm_cols = blob_cols(rng, [(0.0, 0.0), (5.0, 5.0)])
    warm = jax_kmeans.KMeans().set_k(2).set_seed(0).fit(JaxTable(warm_cols))
    data = warm.get_model_data()[0].column("centroids")
    drifted = [(2.0, 2.0), (7.0, 7.0)]
    cols = blob_stream(2, drifted, 25)

    def configure(e):
        table = (fml.Table if isinstance(e, t_okm.OnlineKMeans)
                 else JaxTable)({"centroids": data})
        return e.set_k(2).set_decay_factor(0.3).set_initial_model_data(table)

    got, _ = fit_both(cols, configure)
    order = np.argsort(got.centroids[:, 0])
    np.testing.assert_allclose(got.centroids[order], np.asarray(drifted),
                               atol=0.3)
    assert got.model_version == 25


def test_cold_start_from_first_batch(on_cpu):
    cols = blob_stream(3, [(0.0, 0.0), (8.0, 8.0)], 10, n_each=60)
    got, _ = fit_both(
        cols, lambda e: e.set_k(2).set_seed(3).set_decay_factor(1.0))
    order = np.argsort(got.centroids[:, 0])
    np.testing.assert_allclose(got.centroids[order], [[0, 0], [8, 8]],
                               atol=0.5)


def test_fit_table_batches(on_cpu):
    """``fit(table)`` consumes the table as globalBatchSize mini-batches."""
    cols = blob_cols(np.random.default_rng(4), [(0.0, 0.0), (6.0, 6.0)],
                     n_each=128)
    got = (t_okm.OnlineKMeans().set_k(2).set_seed(1).set_global_batch_size(64)
           .set_decay_factor(1.0).fit(fml.Table(cols)))
    want = (jax_okm.OnlineKMeans().set_k(2).set_seed(1)
            .set_global_batch_size(64).set_decay_factor(1.0)
            .fit(JaxTable(cols)))
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=TOL,
                               atol=TOL)
    assert got.model_version == want.model_version == 4
    (out,) = got.transform(fml.Table(cols))
    (jout,) = want.transform(JaxTable(cols))
    assign = np.asarray(out.column("prediction"))
    np.testing.assert_array_equal(assign, np.asarray(jout.column("prediction")))
    np.testing.assert_array_equal(
        np.sort(np.bincount(assign.astype(int), minlength=2)), [128, 128])


def test_first_batch_smaller_than_k_raises(on_cpu):
    for module, table in ((t_okm, fml.Table), (jax_okm, JaxTable)):
        with pytest.raises(ValueError, match="first batch"):
            module.OnlineKMeans().set_k(2).set_seed(0).fit_stream(
                iter([table({"features": np.zeros((1, 2))})]))


def test_empty_stream_raises(on_cpu):
    for module in (t_okm, jax_okm):
        with pytest.raises(ValueError, match="empty"):
            module.OnlineKMeans().set_k(2).fit_stream(iter([]))


def test_save_load_round_trip(tmp_path, on_cpu):
    cols = blob_stream(5, [(0.0, 0.0), (9.0, 9.0)], 5)
    model, _ = fit_both(cols, _okm_configure)
    p = str(tmp_path / "okm")
    model.save(p)
    loaded = t_okm.OnlineKMeansModel.load(p)
    np.testing.assert_array_equal(loaded.centroids, model.centroids)
    assert loaded.model_version == model.model_version == 5
    t = fml.Table(blob_cols(np.random.default_rng(6),
                            [(0.0, 0.0), (9.0, 9.0)]))
    (a,) = model.transform(t)
    (b,) = loaded.transform(t)
    np.testing.assert_array_equal(np.asarray(a.column("prediction")),
                                  np.asarray(b.column("prediction")))


def test_model_data_round_trip(on_cpu):
    cols = blob_stream(7, [(0.0, 0.0), (9.0, 9.0)], 3)
    model, want = fit_both(cols, _okm_configure)
    other = t_okm.OnlineKMeansModel().set_model_data(*model.get_model_data())
    np.testing.assert_array_equal(other.centroids, model.centroids)
    (data,) = model.get_model_data()
    (jdata,) = want.get_model_data()
    assert data.column("centroids").shape == jdata.column("centroids").shape


def test_transform_requires_model(on_cpu):
    for module, table in ((t_okm, fml.Table), (jax_okm, JaxTable)):
        with pytest.raises(ValueError, match="Model data"):
            module.OnlineKMeansModel().transform(
                table({"features": np.zeros((2, 2))}))


# -- checkpoint / resume ---------------------------------------------------------------

@pytest.mark.parametrize("stream_resume", ["replay", "continue"])
def test_crash_resume_bit_for_bit(stream_resume, tmp_path, on_cpu):
    """A fit crashed at batch 7 (snapshots every 2) resumes from batch 6:
    ``replay`` re-reads the stream from its start and skips 6 batches,
    ``continue`` reads a live stream already at batch 6. Either ends on
    the uninterrupted model, bit for bit."""
    batches = _stream()
    golden = _okm().fit_stream(batches)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    with pytest.raises(RuntimeError, match="injected"):
        _okm().fit_stream(_crashing(batches, 7), checkpoint_manager=mgr,
                          checkpoint_interval=INTERVAL)
    assert mgr.latest_epoch() == 6
    source = batches if stream_resume == "replay" else iter(batches[6:])
    resumed = _okm().fit_stream(source, checkpoint_manager=mgr,
                                checkpoint_interval=INTERVAL, resume=True,
                                stream_resume=stream_resume)
    np.testing.assert_array_equal(resumed.centroids, golden.centroids)
    assert resumed.model_version == golden.model_version == N_BATCHES
    want = _okm(jax_okm).fit_stream(_stream(cls=JaxTable))
    np.testing.assert_allclose(golden.centroids, want.centroids, rtol=TOL,
                               atol=TOL)


def test_resume_edge_cases(tmp_path, on_cpu):
    """Resume after completion is a no-op; an exhausted live tail returns
    the checkpointed model; a warm start on an empty stream returns the
    initial model; resume needs a manager."""
    batches = _stream(seed=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    done = _okm().fit_stream(batches, checkpoint_manager=mgr,
                             checkpoint_interval=INTERVAL)
    assert mgr.latest_epoch() == N_BATCHES
    for source, how in ((batches, "replay"), (iter([]), "continue")):
        again = _okm().fit_stream(source, checkpoint_manager=mgr,
                                  checkpoint_interval=INTERVAL, resume=True,
                                  stream_resume=how)
        np.testing.assert_array_equal(again.centroids, done.centroids)
        assert again.model_version == done.model_version
    init = np.array([[1.0, -2.0], [3.0, 4.0]])
    for module, table in ((t_okm, fml.Table), (jax_okm, JaxTable)):
        model = (module.OnlineKMeans().set_k(2).set_initial_model_data(
            table({"centroids": init[None]})).fit_stream(iter([])))
        np.testing.assert_array_equal(model.centroids, init)
        assert model.model_version == 0
    with pytest.raises(ValueError, match="requires a checkpoint_manager"):
        _okm().fit_stream(batches, resume=True)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_carry_resumes_across_packages(first, tmp_path, on_cpu):
    """A fit crashed in one package resumes in the other: the dict carry's
    leaves in the JAX package's order (centroids, version, weights)."""
    golden = _okm().fit_stream(_stream())
    if first == "jax":
        mgr = JaxCheckpointManager(str(tmp_path), max_to_keep=10)
        with pytest.raises(RuntimeError, match="injected"):
            _okm(jax_okm).fit_stream(_crashing(_stream(cls=JaxTable), 7),
                                     checkpoint_manager=mgr,
                                     checkpoint_interval=INTERVAL)
        resumed = _okm().fit_stream(
            _stream(), checkpoint_manager=CheckpointManager(
                str(tmp_path), max_to_keep=10),
            checkpoint_interval=INTERVAL, resume=True)
    else:
        with pytest.raises(RuntimeError, match="injected"):
            _okm().fit_stream(_crashing(_stream(), 7),
                              checkpoint_manager=CheckpointManager(
                                  str(tmp_path), max_to_keep=10),
                              checkpoint_interval=INTERVAL)
        resumed = _okm(jax_okm).fit_stream(
            _stream(cls=JaxTable), checkpoint_manager=JaxCheckpointManager(
                str(tmp_path), max_to_keep=10),
            checkpoint_interval=INTERVAL, resume=True)
    np.testing.assert_allclose(resumed.centroids, golden.centroids, rtol=TOL,
                               atol=TOL)
    assert resumed.model_version == N_BATCHES
    meta = json.loads((tmp_path / "ckpt-6" / "meta.json").read_text())
    assert meta["treedef"] == \
        "PyTreeDef({'centroids': *, 'version': *, 'weights': *})"


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_saved_models_cross_packages(saver, tmp_path, on_cpu):
    port, jax_model = fit_both(blob_stream(8, [(0.0, 0.0), (9.0, 9.0)], 4),
                               _okm_configure)
    path = str(tmp_path / "m")
    if saver == "jax":
        jax_model.save(path)
        loaded = t_okm.OnlineKMeansModel.load(path)
        np.testing.assert_array_equal(loaded.centroids, jax_model.centroids)
    else:
        port.save(path)
        loaded = jax_okm.OnlineKMeansModel.load(path)
        np.testing.assert_array_equal(loaded.centroids, port.centroids)
    assert loaded.model_version == 4
    assert loaded.get_param_map_json() == port.get_param_map_json()
    assert isinstance(fml.load_stage(path), t_okm.OnlineKMeansModel)


# -- what stays unported ---------------------------------------------------------------

def test_unported_online_kmeans_paths_refused(monkeypatch, tmp_path, on_cpu):
    """The sentinel and recovery (item 12) are ported: under the same
    ``NaNGrad`` plan the port's healed centroids equal JAX's (within TOL)
    with the same summary. What stays refused: the multi-process stream's
    checkpoints, sentinel and recovery (refused in JAX too) and a mesh
    that is not a DeviceMesh."""
    from flinkml_tpu import faults as jax_faults
    from flinkml_tpu import recovery as jax_recovery
    from flinkml_tpu_torch import faults as t_faults
    from flinkml_tpu_torch import recovery as t_recovery

    healed = {}
    for module, faults, rec, cls in (
            (t_okm, t_faults, t_recovery, None),
            (jax_okm, jax_faults, jax_recovery, JaxTable)):
        with faults.armed(faults.FaultPlan(faults.NaNGrad(3))):
            healed[module] = _okm(module).fit_stream(
                _stream(cls=cls), recovery=rec.RecoveryPolicy(backoff_s=0.0))
    got, want = healed[t_okm], healed[jax_okm]
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=TOL,
                               atol=TOL)
    assert got.recovery_summary == want.recovery_summary
    assert got.recovery_summary["quarantined"] == [3]
    # The multi-process stream (item 7c) is ported; its checkpoints are
    # refused, as in JAX (P ranks: tests/test_torch_stream_mp.py).
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_okm.OnlineKMeans(mesh=object())
    monkeypatch.setattr(t_olr, "_process_count", lambda: 2)
    with pytest.raises(NotImplementedError,
                       match="multi-process online stream"):
        _okm().fit_stream(_stream()[:2], checkpoint_manager=CheckpointManager(
            str(tmp_path)))
    for knob in ("sentinel", "recovery"):
        with pytest.raises(NotImplementedError,
                           match="multi-process online stream"):
            _okm().fit_stream(_stream()[:2], **{knob: object()})
    assert fml.OnlineKMeans is t_okm.OnlineKMeans
    assert fml.OnlineKMeansModel is t_okm.OnlineKMeansModel
