"""The port's streamed GBT (``flinkml_tpu_torch.models._gbt_stream``)
against the JAX package, on the CPU.

The JAX reference is ``flinkml_tpu.models._gbt_stream.train_gbt_stream``
on a one-device mesh over the same cache. Both add each batch's float32
histograms in batch order and pick the splits on the host in float64, so
the forests equal JAX's bit for bit wherever the histogram sums do; the
comparison allows the near-tie rule of ``chip_smoke.forest_parting`` and
prints what it met, and holds gains and leaves within 1e-5 (the gradients
go through ``torch.sigmoid``, which parts from XLA's by an ulp).

The port's own cases mirror the streamed-GBT cases of
``tests/test_stream_fit.py``, ``tests/test_stream_resume.py`` and
``tests/test_gbt_reservoir.py``: spilled equals in RAM exactly, the
streamed build follows the in-RAM builder, classifier and regressor learn,
random forests and ``validationFraction`` are refused, a crash at a tree
boundary resumes bit for bit (with and without subsampling, through
``train_gbt_stream`` and through the estimator), a JAX snapshot resumes
in the port, and the reservoir's approximate edges stay inside the JAX
test's envelope. A resume that skips a tree fails
``chip_smoke.forest_parting`` (the check path V2 makes on the card).
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.iteration.checkpoint import CheckpointManager as JManager
from flinkml_tpu.iteration.datacache import cache_stream as jcache_stream
from flinkml_tpu.models._gbt_stream import train_gbt_stream as jtrain
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu_torch.iteration import stream_sync
from flinkml_tpu_torch.iteration.checkpoint import CheckpointManager
from flinkml_tpu_torch.iteration.datacache import cache_stream
from flinkml_tpu_torch.models import _gbt_stream
from flinkml_tpu_torch.models import gbt as pg
from flinkml_tpu_torch.parallel import DeviceMesh
from flinkml_tpu_torch.table import Table

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

ARGS = dict(logistic=True, num_trees=4, depth=3, max_bins=16,
            learning_rate=0.3, reg_lambda=1.0, subsample=1.0, seed=0)


@pytest.fixture(autouse=True)
def _cpu():
    with fml.use_device("cpu"):
        yield


def _gbt_batches(n_batches=5, rows=96, d=4, seed=0, regression=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.uniform(-1, 1, size=(rows, d)).astype(np.float32)
        raw = x[:, 0] * x[:, 1] + 0.5 * x[:, 2]
        y = raw if regression else (raw > 0).astype(np.float32)
        out.append({"x": x, "y": y.astype(np.float32),
                    "w": np.ones(rows, np.float32)})
    return out


def _forest(result):
    feats, bins, gains, leaves, base, edges = result
    return (np.asarray(feats), pg.split_thresholds(edges, feats, bins),
            np.asarray(gains), np.asarray(leaves))


def _crash_manager_cls(crash_at_epoch):
    class Crash(CheckpointManager):
        fired = False

        def save(self, state, epoch, extra=None, **kw):
            p = super().save(state, epoch, extra, **kw)
            if not Crash.fired and epoch >= crash_at_epoch:
                Crash.fired = True
                raise RuntimeError("injected crash")
            return p

    return Crash


@pytest.mark.parametrize("logistic,subsample", [(True, 1.0), (True, 0.7),
                                                (False, 0.8)])
def test_stream_matches_jax(logistic, subsample):
    batches = _gbt_batches(regression=not logistic)
    args = dict(ARGS, logistic=logistic, subsample=subsample, num_trees=6)
    want = jtrain(jcache_stream(iter(batches)),
                  mesh=JMesh({"data": 1}, jax.devices()[:1]), **args)
    got = _gbt_stream.train_gbt_stream(cache_stream(iter(batches)),
                                       mesh=DeviceMesh(), **args)
    np.testing.assert_array_equal(got[5], np.asarray(want[5]))   # edges
    assert got[4] == want[4]                                     # base
    report, problems = chip_smoke.forest_parting(_forest(want), _forest(got),
                                                 True)
    assert not problems, problems
    if report["ties"]:
        print(f"streamed logistic={logistic}: near ties {report['ties']}")
    else:
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        for a, b in zip(want[2:4], got[2:4]):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5,
                                       atol=1e-6)


def test_stream_spilled_matches_in_ram_exactly(tmp_path):
    batches = _gbt_batches()
    ram = _gbt_stream.train_gbt_stream(cache_stream(iter(batches)),
                                       mesh=DeviceMesh(), **ARGS)
    spill = cache_stream(iter(batches), directory=str(tmp_path / "spill"),
                         memory_budget_bytes=1)
    spilled = _gbt_stream.train_gbt_stream(spill, mesh=DeviceMesh(), **ARGS)
    for a, b in zip(ram, spilled):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert any((tmp_path / "spill").glob("segment-*.bin"))
    # The binned copy's private spill directory is gone after the build.
    assert not list((tmp_path / "spill").glob("flinkml-gbt-binned-*"))


def test_stream_matches_in_ram_builder():
    batches = _gbt_batches()
    x_all = np.concatenate([b["x"] for b in batches])
    y_all = np.concatenate([b["y"] for b in batches])

    def est():
        return (pg.GBTClassifier().set_num_trees(4).set_max_depth(3)
                .set_max_bins(16).set_learning_rate(0.3).set_seed(0))

    in_ram = est().fit(Table({"features": x_all, "label": y_all}))
    streamed = est().fit(iter([Table({"features": b["x"], "label": b["y"]})
                               for b in batches]))
    np.testing.assert_array_equal(streamed._feats, in_ram._feats)
    np.testing.assert_allclose(streamed._thrs, in_ram._thrs, rtol=1e-6)
    np.testing.assert_allclose(streamed._leaves, in_ram._leaves, rtol=2e-3,
                               atol=2e-4)


def test_classifier_streamed_fit_learns(tmp_path):
    batches = _gbt_batches(n_batches=8, rows=128)
    model = (pg.GBTClassifier(cache_dir=str(tmp_path / "gbt"),
                              cache_memory_budget_bytes=1)
             .set_num_trees(20).set_max_depth(4).set_max_bins(32)
             .set_learning_rate(0.3).set_seed(0)
             .fit(iter([Table({"features": b["x"], "label": b["y"]})
                        for b in batches])))
    x_all = np.concatenate([b["x"] for b in batches])
    y_all = np.concatenate([b["y"] for b in batches])
    out = model.transform(Table({"features": x_all}))[0].column("prediction")
    assert float(np.mean(out == y_all)) > 0.9


def test_regressor_streamed_fit_learns():
    batches = _gbt_batches(n_batches=8, rows=128, regression=True)
    model = (pg.GBTRegressor().set_num_trees(30).set_max_depth(4)
             .set_max_bins(32).set_learning_rate(0.3).set_seed(0)
             .fit(iter([Table({"features": b["x"], "label": b["y"]})
                        for b in batches])))
    x_all = np.concatenate([b["x"] for b in batches])
    y_all = np.concatenate([b["y"] for b in batches])
    out = model.transform(Table({"features": x_all}))[0].column("prediction")
    assert float(np.sqrt(np.mean((out - y_all) ** 2))) < 0.15


def test_stream_rejects_rf_and_validation_fraction():
    tables = [Table({"features": b["x"], "label": b["y"]})
              for b in _gbt_batches(n_batches=2)]
    with pytest.raises(ValueError, match="boosted"):
        pg.RandomForestClassifier().fit(iter(tables))
    with pytest.raises(ValueError, match="validationFraction"):
        pg.GBTClassifier().set_validation_fraction(0.2).fit(iter(tables))
    with pytest.raises(ValueError, match="durable DataCache"):
        pg.GBTClassifier(resume=True, checkpoint_manager=CheckpointManager(
            "unused")).fit(iter(tables))


def _resume_cache(seed=0):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(4):
        x = rng.uniform(-1, 1, size=(96, 4)).astype(np.float32)
        y = (x[:, 0] * x[:, 1] + 0.5 * x[:, 2] > 0).astype(np.float32)
        batches.append({"x": x, "y": y, "w": np.ones(96, np.float32)})
    return batches


@pytest.mark.parametrize("subsample", [1.0, 0.7])
def test_stream_resume_exact(tmp_path, subsample):
    cache = cache_stream(iter(_resume_cache()))
    args = dict(ARGS, num_trees=6, subsample=subsample)
    golden = _gbt_stream.train_gbt_stream(cache, mesh=DeviceMesh(), **args)
    mgr = _crash_manager_cls(2)(str(tmp_path / f"ckpt{subsample}"))
    with pytest.raises(RuntimeError, match="injected"):
        _gbt_stream.train_gbt_stream(cache, mesh=DeviceMesh(),
                                     checkpoint_manager=mgr,
                                     checkpoint_interval=2, **args)
    assert mgr.latest_epoch() == 2
    recovered = _gbt_stream.train_gbt_stream(
        cache, mesh=DeviceMesh(), checkpoint_manager=mgr,
        checkpoint_interval=2, resume=True, **args)
    for a, b in zip(golden, recovered):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # A resume that skips a tree fails the card's resume check.
    real = stream_sync.agreed_restore

    def skip_a_tree(*a, **k):
        state, start = real(*a, **k)
        return state, start + 1

    mgr = _crash_manager_cls(2)(str(tmp_path / f"skip{subsample}"))
    with pytest.raises(RuntimeError, match="injected"):
        _gbt_stream.train_gbt_stream(cache, mesh=DeviceMesh(),
                                     checkpoint_manager=mgr,
                                     checkpoint_interval=2, **args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stream_sync, "agreed_restore", skip_a_tree)
        skipped = _gbt_stream.train_gbt_stream(
            cache, mesh=DeviceMesh(), checkpoint_manager=mgr,
            checkpoint_interval=2, resume=True, **args)
    assert chip_smoke.forest_parting(_forest(golden), _forest(skipped),
                                     True)[1]


def test_jax_snapshot_resumes_in_the_port(tmp_path):
    """A JAX streamed fit crashed at tree 2 resumes in the port (the
    snapshot's leaves are the JAX package's ``CheckpointManager`` files)
    and ends with the uninterrupted JAX forest's splits."""
    batches = _resume_cache(seed=3)
    args = dict(ARGS, num_trees=5, subsample=0.7)
    jmesh = JMesh({"data": 1}, jax.devices()[:1])
    golden = jtrain(jcache_stream(iter(batches)), mesh=jmesh, **args)

    class Crash(JManager):
        def save(self, state, epoch, extra=None, **kw):
            p = super().save(state, epoch, extra, **kw)
            if epoch >= 2:
                raise RuntimeError("injected crash")
            return p

    with pytest.raises(RuntimeError, match="injected"):
        jtrain(jcache_stream(iter(batches)), mesh=jmesh,
               checkpoint_manager=Crash(str(tmp_path / "ck"), world_size=1),
               checkpoint_interval=2, **args)
    got = _gbt_stream.train_gbt_stream(
        cache_stream(iter(batches)), mesh=DeviceMesh(),
        checkpoint_manager=CheckpointManager(str(tmp_path / "ck")),
        checkpoint_interval=0, resume=True, **args)
    report, problems = chip_smoke.forest_parting(_forest(golden),
                                                 _forest(got), True)
    assert not problems, problems


def test_estimator_resume_plumbing(tmp_path):
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        x = rng.uniform(-1, 1, size=(64, 4)).astype(np.float32)
        batches.append({"features": x,
                        "label": (x[:, 0] > 0).astype(np.float32)})
    cache = cache_stream(iter(batches))

    def est(**kw):
        return (pg.GBTClassifier(**kw).set_num_trees(4).set_max_depth(2)
                .set_max_bins(8).set_seed(0))

    golden = est().fit(cache)
    mgr = _crash_manager_cls(2)(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="injected"):
        est(checkpoint_manager=mgr, checkpoint_interval=2).fit(cache)
    recovered = est(checkpoint_manager=mgr, checkpoint_interval=2,
                    resume=True).fit(cache)
    g = golden.get_model_data()[0]
    r = recovered.get_model_data()[0]
    for col in g.column_names:
        np.testing.assert_array_equal(np.asarray(g.column(col)),
                                      np.asarray(r.column(col)))


def _reservoir_data(n=40_000, seed=0):
    rng = np.random.default_rng(seed)
    cols = [rng.normal(size=n), rng.lognormal(sigma=1.0, size=n),
            rng.uniform(-2, 2, size=n),
            np.concatenate([rng.normal(-3, 0.5, n // 2),
                            rng.normal(3, 0.5, n - n // 2)])]
    x = np.stack(cols, axis=1).astype(np.float32)
    raw = x[:, 0] * x[:, 3] + 0.8 * x[:, 2] - 0.3 * np.log1p(x[:, 1])
    return x, (raw > np.median(raw)).astype(np.float32)


def test_reservoir_model_accuracy_drift_bounded():
    """``tests/test_gbt_reservoir.py``'s envelope: the forest on the
    edges of a 1,024-row reservoir loses under 1.5 accuracy points
    against exact edges (40,000 rows)."""
    x, y = _reservoir_data()
    n = x.shape[0]

    def batches():
        for s in range(0, n, 2_000):
            yield {"x": x[s:s + 2_000], "y": y[s:s + 2_000],
                   "w": np.ones(min(2_000, n - s), np.float32)}

    args = dict(ARGS, num_trees=8, depth=3, max_bins=32)

    def acc(result):
        feats, thrs, _, leaves = _forest(result)
        margin = result[4] + 0.3 * pg._walk_forest(
            x.astype(np.float64), feats, thrs, leaves, 3)
        return float(((margin > 0) == y).mean())

    exact = _gbt_stream.train_gbt_stream(cache_stream(batches()),
                                         mesh=DeviceMesh(),
                                         reservoir_capacity=n, **args)
    approx = _gbt_stream.train_gbt_stream(cache_stream(batches()),
                                          mesh=DeviceMesh(),
                                          reservoir_capacity=1_024, **args)
    assert acc(exact) > 0.9
    assert acc(exact) - acc(approx) < 0.015
