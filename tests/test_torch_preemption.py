"""Preemption, crash seams and elastic planning in the port, on the CPU.

Mirrors, on ``flinkml_tpu_torch``, the JAX package's fault-seam cases
that need no serving or cluster: the kill/corrupt/resume acceptance of
the three online trainers and the double failure
(``tests/test_online_resume.py``), the crash at the ``data.read`` seam
and the watchdog preempting an online fit, the ``data.read`` and
``data.prefetch`` seams of the input pipeline
(``tests/test_data_pipeline.py``), the survivors' rendezvous with its
``rendezvous.rescale`` seam, and the plan-sharded fit under ``RankLost``
and ``NaNGrad`` (``tests/test_elastic_resume.py``): at one rank in this
process and at P = 2 gloo ranks (``tests/_torch_mesh_worker.py faults``),
held against the JAX package's plan fit on a P-device mesh (plan fits
within 1e-10, as ``tests/test_torch_sharding.py`` holds them; the elastic
plan and the raise epoch exactly).
"""

from __future__ import annotations

import os
import shutil
import traceback

import jax
import numpy as np
import pytest

from flinkml_tpu import faults as jax_faults
from flinkml_tpu.iteration import CheckpointManager as JaxCheckpointManager
from flinkml_tpu.parallel import DeviceMesh as JaxMesh
from flinkml_tpu.sharding import apply as jax_apply
from flinkml_tpu.sharding import plan as jax_plan
from flinkml_tpu.utils.preemption import (
    PreemptionWatchdog as JaxPreemptionWatchdog,
)
from flinkml_tpu_torch import faults
from flinkml_tpu_torch.data import Dataset
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.models import (
    OnlineKMeans,
    OnlineLogisticRegression,
    OnlineStandardScaler,
)
from flinkml_tpu_torch.parallel.distributed import agree_resume_epoch
from flinkml_tpu_torch.sharding import plan as t_plan
from flinkml_tpu_torch.sharding.apply import train_linear_plan
from flinkml_tpu_torch.table import Table
from flinkml_tpu_torch.utils.preemption import PreemptionWatchdog, active
from tests import _torch_mesh_worker as worker
from tests.test_torch_parallel import launch

N_BATCHES = 12
CRASH_EPOCH = 7
INTERVAL = 2
F64_TOL = 1e-10


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def lr_batches(seed=0, n=N_BATCHES, rows=48, dim=5):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=dim) * 2
    out = []
    for _ in range(n):
        x = rng.normal(size=(rows, dim))
        out.append(Table({"features": x,
                          "label": (x @ true > 0).astype(np.float64)}))
    return out


def km_batches(seed=1, n=N_BATCHES, rows=40, dim=4):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-8, 8, size=(3, dim))
    out = []
    for _ in range(n):
        assign = rng.integers(0, 3, size=rows)
        out.append(Table({"features": centers[assign]
                          + rng.normal(scale=0.4, size=(rows, dim))}))
    return out


def sc_batches(seed=2, n=N_BATCHES, rows=32, dim=6):
    rng = np.random.default_rng(seed)
    return [Table({"input": rng.normal(size=(rows, dim)) * (1 + i)})
            for i in range(n)]


def _lr():
    return OnlineLogisticRegression().set_alpha(0.5).set_reg(0.01)


def _km():
    return OnlineKMeans().set_k(3).set_seed(11).set_decay_factor(0.9)


def _sc():
    return OnlineStandardScaler().set_input_col("input")


def _crash_and_corrupt(est_factory, batches, mgr, corrupt="arrays"):
    """Injected crash at CRASH_EPOCH, then the newest snapshot damaged."""
    with faults.armed(faults.FaultPlan(faults.RaiseAtEpoch(CRASH_EPOCH))):
        with pytest.raises(faults.FaultInjected):
            est_factory().fit_stream(batches, checkpoint_manager=mgr,
                                     checkpoint_interval=INTERVAL)
    assert mgr.latest_epoch() == CRASH_EPOCH - 1
    return faults.corrupt_latest(mgr, target=corrupt)


class _DrainRecorder:
    def __init__(self):
        self.stopped = []

    def stop(self, drain=True, timeout=None):
        self.stopped.append(drain)


# -- tests/test_online_resume.py ---------------------------------------------


@pytest.mark.parametrize("trainer,corrupt", [
    ("lr", "arrays"), ("kmeans", "manifest"), ("scaler", "truncate")])
def test_online_kill_corrupt_resume_bit_exact(tmp_path, trainer, corrupt):
    make, batches, final = {
        "lr": (_lr, lr_batches(), lambda m: m.coefficient),
        "kmeans": (_km, km_batches(), lambda m: m.centroids),
        "scaler": (_sc, sc_batches(),
                   lambda m: np.stack([m._data["mean"], m._data["std"]])),
    }[trainer]
    golden = make().fit_stream(batches)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    assert _crash_and_corrupt(make, batches, mgr, corrupt) == 6
    recovered = make().fit_stream(batches, checkpoint_manager=mgr,
                                  checkpoint_interval=INTERVAL, resume=True)
    np.testing.assert_array_equal(final(recovered), final(golden))
    assert recovered.model_version == golden.model_version == N_BATCHES


def test_double_failure_recovery(tmp_path):
    batches = lr_batches(seed=5)
    golden = _lr().fit_stream(batches)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    for crash_at in (4, 9):
        with faults.armed(faults.FaultPlan(faults.RaiseAtEpoch(crash_at))):
            with pytest.raises(faults.FaultInjected):
                _lr().fit_stream(batches, checkpoint_manager=mgr,
                                 checkpoint_interval=1, resume=True)
        assert mgr.latest_epoch() == crash_at
    final = _lr().fit_stream(batches, checkpoint_manager=mgr,
                             checkpoint_interval=1, resume=True)
    np.testing.assert_array_equal(final.coefficient, golden.coefficient)


def _lr_dataset(seed=0, shuffled=True):
    rows = np.concatenate([np.asarray(b.column("features"))
                           for b in lr_batches(seed=seed)])
    labels = np.concatenate([np.asarray(b.column("label"))
                             for b in lr_batches(seed=seed)])
    ds = Dataset.from_arrays(Table({"features": rows, "label": labels}),
                             batch_size=48)
    return ds.shuffle(4, seed=13) if shuffled else ds


def test_dataset_kill_at_read_seam_resume_bit_exact(tmp_path):
    """The source dies at read #10 (the peek costs read #1, the fit
    re-reads from the start): after the epoch-8 commit."""
    golden = _lr().fit_stream(_lr_dataset(seed=31, shuffled=False))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    with faults.armed(faults.FaultPlan(faults.RaiseAtRead(at_read=10))):
        with pytest.raises(faults.FaultInjected):
            _lr().fit_stream(_lr_dataset(seed=31, shuffled=False),
                             checkpoint_manager=mgr,
                             checkpoint_interval=INTERVAL)
    assert mgr.latest_epoch() == 8
    recovered = _lr().fit_stream(_lr_dataset(seed=31, shuffled=False),
                                 checkpoint_manager=mgr,
                                 checkpoint_interval=INTERVAL, resume=True)
    np.testing.assert_array_equal(recovered.coefficient, golden.coefficient)
    assert recovered.model_version == golden.model_version


def test_watchdog_preempts_online_fit_and_resumes(tmp_path):
    batches = lr_batches(seed=7)
    golden = _lr().fit_stream(batches)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    engine = _DrainRecorder()
    wd = PreemptionWatchdog(signals=())
    wd.register_engine(engine)

    class _RequestAt(faults.Fault):
        site = "iteration.epoch"

        def should_fire(self, ctx):
            return ctx.get("epoch") == 5

        def apply(self, ctx):
            wd.request("scripted preemption")

    with wd:
        with faults.armed(faults.FaultPlan(_RequestAt())):
            preempted = _lr().fit_stream(batches, checkpoint_manager=mgr,
                                         checkpoint_interval=INTERVAL)
    assert mgr.latest_epoch() == 5
    assert engine.stopped == [True]
    assert preempted.model_version == 5
    resumed = _lr().fit_stream(batches, checkpoint_manager=mgr,
                               checkpoint_interval=INTERVAL, resume=True)
    np.testing.assert_array_equal(resumed.coefficient, golden.coefficient)
    assert resumed.model_version == N_BATCHES


# -- tests/test_data_pipeline.py ---------------------------------------------


def _table(n=40, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return Table({"features": rng.normal(size=(n, d)),
                  "y": np.arange(float(n))})


def test_prefetcher_raise_at_prefetch_seam():
    """The seam fires on the worker thread; the raise reaches the
    consumer's next() with the worker's frames, the worker stops, and a
    later next() raises again instead of returning a short stream."""
    ds = Dataset.from_arrays(_table(20), 4).prefetch(depth=1)
    with faults.armed(faults.FaultPlan(
            faults.RaiseAtRead(at_read=2, site="data.prefetch"))) as plan:
        it = ds.iterate()
        next(it)
        with pytest.raises(faults.FaultInjected, match="read #2") as ei:
            for _ in it:
                pass
    assert [site for site, _, _ in plan.log] == ["data.prefetch"]
    frames = "".join(traceback.format_tb(ei.value.__traceback__))
    assert "pad_and_place" in frames
    prefetcher = it._prefetcher
    prefetcher._thread.join(timeout=5.0)
    assert not prefetcher._thread.is_alive()
    with pytest.raises(faults.FaultInjected):
        next(prefetcher)


def test_raise_at_read_seam_fires_mid_stream():
    ds = Dataset.from_arrays(_table(40), 4)
    with faults.armed(faults.FaultPlan(faults.RaiseAtRead(at_read=5))):
        it = ds.iterate()
        got = [next(it) for _ in range(4)]
        with pytest.raises(faults.FaultInjected, match="read #5"):
            next(it)
    assert len(got) == 4
    cursor = it.cursor()
    it.close()
    assert cursor.emitted == 4
    tail = [np.asarray(b.column("y")) for b in ds.iterate(cursor)]
    np.testing.assert_array_equal(np.concatenate(tail),
                                  np.arange(16.0, 40.0))


def test_delay_read_slows_the_feed_without_raising():
    ds = Dataset.from_arrays(_table(20), 4)
    plan = faults.FaultPlan(faults.DelayRead(delay_s=0.001, first_n=3))
    with faults.armed(plan):
        assert len(list(ds)) == 5
    assert [s for s, _, _ in plan.log] == ["data.read"] * 3


# -- tests/test_elastic_resume.py --------------------------------------------


def test_agree_resume_epoch_picks_newest_commonly_valid(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    for epoch in (2, 4, 6):
        mgr.save({"w": np.full(2, float(epoch))}, epoch)
    assert agree_resume_epoch(mgr) == 6
    faults.corrupt_latest(mgr, target="arrays")
    assert agree_resume_epoch(mgr) == 4
    assert agree_resume_epoch(CheckpointManager(str(tmp_path / "no"))) is None


def test_rescale_rendezvous_seam_scriptable(tmp_path):
    """The rendezvous seam fails on script; undisturbed, the port's
    elastic plan is JAX's over the same snapshot directory."""
    wd = PreemptionWatchdog(signals=())
    wd.notify_rank_lost(3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"w": np.ones(2)}, 1)
    with faults.armed(faults.FaultPlan(faults.FailRendezvous())) as plan:
        with pytest.raises(faults.FaultInjected, match="rendezvous"):
            wd.plan_elastic_resume(mgr, world=4)
    assert plan.log and plan.log[0][0] == "rendezvous.rescale"
    got = wd.plan_elastic_resume(mgr, world=4)
    jwd = JaxPreemptionWatchdog(signals=())
    jwd.notify_rank_lost(3)
    want = jwd.plan_elastic_resume(
        JaxCheckpointManager(str(tmp_path), world_size=1), world=4)
    assert (got.epoch, got.old_world, got.new_world) == \
        (want.epoch, want.old_world, want.new_world) == (1, 4, 3)


def test_rank_lost_without_watchdog_is_a_hard_crash():
    assert active() is None
    with faults.armed(faults.FaultPlan(faults.RankLost(epoch=1, rank=0))):
        with pytest.raises(faults.FaultInjected, match="rank loss"):
            _lr().fit_stream(lr_batches(n=3))


def test_compact_rank_and_survivor_world():
    from flinkml_tpu_torch.parallel.distributed import compact_rank

    assert compact_rank(3, [2]) == 2 and compact_rank(2, [2]) is None
    wd = PreemptionWatchdog(signals=())
    wd.notify_rank_lost(1)
    wd.notify_rank_lost(1)  # idempotent
    assert wd.lost_ranks == [1] and wd.survivor_world(4) == 3
    assert wd.survivor_world(1) == 1 and wd.shrink_requested


def test_verify_keeps_bool_contract_over_failed_async_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10, async_write=True)
    mgr.save({"w": np.ones(2)}, 1)
    mgr.wait()
    with faults.armed(faults.FaultPlan(faults.TornWrite(2))):
        mgr.save({"w": np.full(2, 2.0)}, 2)  # the background write tears
        assert mgr.newest_valid_epoch() == 1
    assert mgr.verify(1) and not mgr.verify(2)
    assert agree_resume_epoch(mgr) == 1


# -- the plan-sharded fit under faults ---------------------------------------


def _jax_plan_fit(world, **kw):
    x, y = worker.fault_plan_data()
    mesh = JaxMesh.for_plan(jax_plan.FSDP, devices=jax.devices()[:world])
    return jax_apply.train_linear_plan(x, y, None, jax_plan.FSDP, mesh,
                                       **worker.FAULT_PLAN_KW, **kw)


def test_fsdp_plan_rank_lost_stops_with_snapshot_one_rank(tmp_path):
    """One rank: a RankLost under the watchdog stops the plan fit at the
    kill epoch with a terminal plan-tagged snapshot, and the resumed fit
    equals the uninterrupted one (and JAX's, within F64_TOL)."""
    x, y = worker.fault_plan_data()
    kill, interval = worker.FAULT_KILL_EPOCH, worker.FAULT_INTERVAL

    def run(mgr=None, resume=False, stats=None):
        return train_linear_plan(x, y, None, t_plan.FSDP, None,
                                 checkpoint_manager=mgr,
                                 checkpoint_interval=interval,
                                 resume=resume, stats=stats,
                                 **worker.FAULT_PLAN_KW)

    golden = run()
    np.testing.assert_allclose(golden, _jax_plan_fit(1), rtol=0,
                               atol=F64_TOL)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    stats = {}
    wd = PreemptionWatchdog(signals=())
    with wd:
        with faults.armed(faults.FaultPlan(
                faults.RankLost(epoch=kill, rank=0))):
            run(mgr, stats=stats)
    assert stats["preempted"] and stats["epoch"] == kill
    assert wd.lost_ranks == [0] and mgr.latest_epoch() == kill
    assert wd.plan_elastic_resume(mgr, world=1).epoch == kill
    np.testing.assert_array_equal(run(mgr, resume=True), golden)


@pytest.fixture(scope="module")
def fault_ranks(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("faults2"))
    return workdir, launch("faults", 2, workdir)


def test_fsdp_plan_rank_lost_two_ranks_matches_jax(fault_ranks, tmp_path):
    """P = 2 gloo ranks: RankLost(rank 1) under a watchdog on both ranks
    stops the fit at the kill epoch (preempted, one terminal snapshot),
    the survivors' plan is JAX's (world 2 -> 1 at the kill epoch), the
    preempted coefficients are JAX's, and the snapshot resumes at world 1
    to the uninterrupted fit (the plan-derived tags reshard it)."""
    workdir, outs = fault_ranks
    kill = worker.FAULT_KILL_EPOCH
    for key in ("preempted_coef", "preempted", "elastic_plan", "nan_raise"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
    assert outs[0]["preempted"].tolist() == [1, kill, kill]
    assert outs[0]["lost_ranks"].tolist() == [1]

    jmgr_dir = str(tmp_path / "jax_ckpt")
    jmgr = JaxCheckpointManager(jmgr_dir, max_to_keep=10, rescale="reshard")
    jwd = JaxPreemptionWatchdog(signals=())
    with jwd:
        with jax_faults.armed(jax_faults.FaultPlan(
                jax_faults.RankLost(epoch=kill, rank=1))):
            jax_coef = _jax_plan_fit(
                2, checkpoint_manager=jmgr,
                checkpoint_interval=worker.FAULT_INTERVAL)
    jplan = jwd.plan_elastic_resume(jmgr, world=2)
    assert outs[0]["elastic_plan"].tolist() == \
        [jplan.epoch, jplan.old_world, jplan.new_world] == [kill, 2, 1]
    np.testing.assert_allclose(outs[0]["preempted_coef"], jax_coef, rtol=0,
                               atol=F64_TOL)

    x, y = worker.fault_plan_data()
    golden = train_linear_plan(x, y, None, t_plan.FSDP, None,
                               **worker.FAULT_PLAN_KW)
    resume_dir = str(tmp_path / "w1")
    shutil.copytree(os.path.join(workdir, "plan_ckpt"), resume_dir)
    mgr = CheckpointManager(resume_dir, max_to_keep=10, rescale="reshard")
    resumed = train_linear_plan(x, y, None, t_plan.FSDP, None,
                                checkpoint_manager=mgr,
                                checkpoint_interval=worker.FAULT_INTERVAL,
                                resume=True, **worker.FAULT_PLAN_KW)
    np.testing.assert_allclose(resumed, golden, rtol=1e-9, atol=1e-12)


def test_fsdp_plan_nangrad_two_ranks_raises_at_jax_epoch(fault_ranks):
    """The sentinel over each rank's blocks, its verdict all-reduced:
    both ranks raise at the NaNGrad epoch with the same non-finite bits as
    JAX's plan fit on a two-device mesh. The magnitude bit is the port's
    rule on every world (a NaN leaf sets it, as JAX's verdict does on one
    device); JAX's verdict over the two-device sharded state measured
    without it, so that bit is not compared here."""
    from flinkml_tpu import recovery as jax_recovery

    _, outs = fault_ranks
    with jax_faults.armed(jax_faults.FaultPlan(
            jax_faults.NaNGrad(worker.FAULT_NAN_EPOCH))):
        with pytest.raises(jax_recovery.NumericsError) as ei:
            _jax_plan_fit(2, sentinel=jax_recovery.NumericsSentinel())
    want = [ei.value.epoch, ei.value.source_index, ei.value.verdict & 3]
    for out in outs:
        epoch, source, bits = out["nan_raise"].tolist()
        assert [epoch, source, bits & 3] == want == \
            [worker.FAULT_NAN_EPOCH, worker.FAULT_NAN_EPOCH, 2]
        assert bits == 6


def test_online_scaler_merges_the_ranks_moments(fault_ranks):
    """OnlineStandardScaler on two ranks, each over its own partition:
    every rank holds the same bits, equal within 1e-12 to one process
    over the combined stream, and the version counts every batch."""
    _, outs = fault_ranks
    np.testing.assert_array_equal(outs[0]["scaler"], outs[1]["scaler"])
    combined = [b for r in range(2) for b in worker.scaler_partition(r, 2)]
    model = OnlineStandardScaler().fit_stream(combined)
    np.testing.assert_allclose(
        outs[0]["scaler"], np.stack([model._data["mean"], model._data["std"]]),
        rtol=1e-12, atol=1e-12)
    assert outs[0]["scaler_version"].tolist() == [len(combined)] == [7]
