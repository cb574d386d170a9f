"""The port's fault-injection layer (``flinkml_tpu_torch.faults``), on the
CPU.

Mirrors the JAX package's ``tests/test_faults.py`` on the port: plan
arming and firing, zero cost when disarmed, the corrupt-snapshot fallback
ladder of ``restore_latest``, torn writes, kill-after-commit, transfer
faults at the dispatch seam and the preemption watchdog (final checkpoint
and drain, SIGTERM). The registry's dropped publish is in
``tests/test_torch_serving.py``. Then the seams the JAX package tests elsewhere (the
``data.read`` and ``data.prefetch`` seams, the ``rendezvous.rescale``
seam) and the cross-package checks: a plan's JSON is the same bytes in
both packages, a plan written by JAX replays in the port, and
``FuzzPlan`` draws the same schedules.
"""

import os
import signal

import numpy as np
import pytest

from flinkml_tpu_torch import faults
from flinkml_tpu_torch.iteration import (
    CheckpointIntegrityError,
    CheckpointManager,
    IterationConfig,
    TerminateOnMaxIter,
    iterate,
)
from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.utils.preemption import PreemptionWatchdog, active


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _count_step(state, data, epoch):
    return state + float(data), None


# ---------------------------------------------------------------------------
# Plan semantics
# ---------------------------------------------------------------------------

def test_raise_at_epoch_fires_once_and_logs():
    plan = faults.FaultPlan(faults.RaiseAtEpoch(2))
    with faults.armed(plan):
        with pytest.raises(faults.FaultInjected, match="epoch 2"):
            iterate(_count_step, 0.0, [1.0, 2.0, 3.0, 4.0],
                    IterationConfig(TerminateOnMaxIter(4)))
    assert faults.ACTIVE is None  # armed() always disarms
    assert plan.log == [
        ("iteration.epoch", "RaiseAtEpoch(2)", {"epoch": 2})
    ]
    # Epochs 0 and 1 completed before the injected crash.
    with faults.armed(faults.FaultPlan()):
        pass  # empty plan is legal


def test_crash_run_consumed_exactly_the_prefix():
    consumed = []

    def stream():
        for i in range(10):
            consumed.append(i)
            yield float(i)

    with faults.armed(faults.FaultPlan(faults.RaiseAtEpoch(3))):
        with pytest.raises(faults.FaultInjected):
            iterate(_count_step, 0.0, stream(),
                    IterationConfig(TerminateOnMaxIter(10)))
    # The epoch-3 fault fires BEFORE batch 3 is consumed.
    assert consumed == [0, 1, 2]


def test_zero_overhead_when_disarmed(monkeypatch):
    """With no plan armed the seams are a None check: FaultPlan.fire must
    never be invoked anywhere."""
    calls = []
    orig = faults.FaultPlan.fire
    monkeypatch.setattr(
        faults.FaultPlan, "fire",
        lambda self, site, **ctx: calls.append(site) or orig(self, site, **ctx),
    )
    assert faults.ACTIVE is None
    iterate(_count_step, 0.0, [1.0, 2.0],
            IterationConfig(TerminateOnMaxIter(2)))
    guard = DispatchGuard(interval=1)
    guard.after_dispatch(np.zeros(2))
    guard.flush(np.zeros(2))
    assert calls == []


def test_armed_disarms_on_exception():
    with pytest.raises(RuntimeError, match="boom"):
        with faults.armed(faults.FaultPlan()):
            raise RuntimeError("boom")
    assert faults.ACTIVE is None


# ---------------------------------------------------------------------------
# Checkpoint faults + the fallback ladder
# ---------------------------------------------------------------------------

def _save_epochs(tmp_path, epochs, keep=10):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=keep)
    state = {"w": np.arange(4.0), "v": 0}
    for e in epochs:
        state = {"w": state["w"] + e, "v": e}
        mgr.save(state, e)
    return mgr, state


@pytest.mark.parametrize("target", ["arrays", "manifest", "truncate"])
def test_corrupt_latest_falls_back_to_previous_valid(tmp_path, target):
    mgr, _ = _save_epochs(tmp_path, [1, 2, 3])
    faults.corrupt_latest(mgr, target=target)
    like = {"w": np.zeros(4), "v": 0}
    state, epoch = mgr.restore_latest(like)
    assert epoch == 2
    np.testing.assert_array_equal(state["w"], np.arange(4.0) + 1 + 2)


def test_all_corrupt_raises_not_fresh_start(tmp_path):
    mgr, _ = _save_epochs(tmp_path, [1, 2])
    faults.corrupt_checkpoint(str(tmp_path / "ckpt" / "ckpt-1"), "arrays")
    faults.corrupt_checkpoint(str(tmp_path / "ckpt" / "ckpt-2"), "manifest")
    with pytest.raises(CheckpointIntegrityError, match="no valid checkpoint"):
        mgr.restore_latest({"w": np.zeros(4), "v": 0})


def test_restore_explicit_epoch_verifies_integrity(tmp_path):
    mgr, _ = _save_epochs(tmp_path, [1])
    faults.corrupt_latest(mgr, target="arrays")
    # Depending on where the flipped bytes land, damage surfaces as a
    # zip-CRC load failure or as a fingerprint mismatch — both must be
    # the integrity error the fallback ladder keys on.
    with pytest.raises(CheckpointIntegrityError,
                       match="integrity|unloadable"):
        mgr.restore(1, {"w": np.zeros(4), "v": 0})


def test_fingerprint_catches_swapped_arrays(tmp_path):
    """A VALID npz from a different epoch swapped under a manifest passes
    every structural check — only the sha256 fingerprint catches it."""
    import shutil

    mgr, _ = _save_epochs(tmp_path, [1, 2, 3])
    shutil.copy(
        str(tmp_path / "ckpt" / "ckpt-1" / "arrays.npz"),
        str(tmp_path / "ckpt" / "ckpt-3" / "arrays.npz"),
    )
    like = {"w": np.zeros(4), "v": 0}
    with pytest.raises(CheckpointIntegrityError, match="fingerprint"):
        mgr.restore(3, like)
    _, epoch = mgr.restore_latest(like)
    assert epoch == 2  # ladder falls back past the tampered snapshot


def test_empty_manager_restore_latest_is_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.restore_latest({"w": np.zeros(2)}) is None


def test_torn_write_never_commits(tmp_path):
    mgr, _ = _save_epochs(tmp_path, [1, 2])
    with faults.armed(faults.FaultPlan(faults.TornWrite(3))):
        with pytest.raises(faults.FaultInjected, match="torn"):
            mgr.save({"w": np.zeros(4), "v": 3}, 3)
    # Epoch 3 never became visible; the ladder restores epoch 2.
    assert mgr.latest_epoch() == 2
    _, epoch = mgr.restore_latest({"w": np.zeros(4), "v": 0})
    assert epoch == 2


def test_kill_after_checkpoint_commits_first(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    plan = faults.FaultPlan(faults.KillAfterCheckpoint(min_epoch=4))
    with faults.armed(plan):
        with pytest.raises(faults.FaultInjected, match="kill after"):
            iterate(
                _count_step, 0.0, [float(i) for i in range(10)],
                IterationConfig(TerminateOnMaxIter(10),
                                checkpoint_interval=2,
                                checkpoint_manager=mgr),
            )
    # The epoch-4 snapshot IS durable — the kill happened after commit.
    assert mgr.latest_epoch() == 4
    state, epoch = mgr.restore_latest(0.0)
    assert (state, epoch) == (0.0 + 0 + 1 + 2 + 3, 4)


def test_corrupt_then_kill_composes_in_plan_order(tmp_path):
    """The canonical acceptance scenario: the newest snapshot is corrupted
    AND the process dies at the same commit; recovery must use the prior
    snapshot."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    plan = faults.FaultPlan(
        faults.CorruptSnapshot(min_epoch=4, target="arrays"),
        faults.KillAfterCheckpoint(min_epoch=4),
    )
    with faults.armed(plan):
        with pytest.raises(faults.FaultInjected):
            iterate(
                _count_step, 0.0, [float(i) for i in range(10)],
                IterationConfig(TerminateOnMaxIter(10),
                                checkpoint_interval=2,
                                checkpoint_manager=mgr),
            )
    assert [s for s, _, _ in plan.log] == [
        "checkpoint.committed", "checkpoint.committed"
    ]
    state, epoch = mgr.restore_latest(0.0)
    assert epoch == 2  # epoch 4 is corrupt → ladder fell back
    assert state == 0.0 + 0 + 1


# ---------------------------------------------------------------------------
# Transfer + publish faults
# ---------------------------------------------------------------------------

def test_transfer_fault_fail():
    guard = DispatchGuard(interval=0)
    with faults.armed(faults.FaultPlan(faults.TransferFault(at_count=2))):
        guard.after_dispatch(np.zeros(2))
        with pytest.raises(faults.FaultInjected, match="transfer"):
            guard.after_dispatch(np.zeros(2))


def test_transfer_fault_delay_does_not_raise():
    guard = DispatchGuard(interval=0)
    plan = faults.FaultPlan(
        faults.TransferFault(at_count=1, mode="delay", delay_s=0.001)
    )
    with faults.armed(plan):
        guard.after_dispatch(np.zeros(2))
    assert plan.log and plan.log[0][0] == "dispatch.transfer"


# ---------------------------------------------------------------------------
# Preemption watchdog
# ---------------------------------------------------------------------------

class _DrainRecorder:
    def __init__(self):
        self.stopped = []

    def stop(self, drain=True, timeout=None):
        self.stopped.append(drain)


def test_watchdog_requests_final_checkpoint_and_drain(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    engine = _DrainRecorder()
    wd = PreemptionWatchdog(signals=())
    wd.register_engine(engine)

    fired = {"at": None}

    def step(state, data, epoch):
        if epoch == 3:
            wd.request("test preemption")
            fired["at"] = epoch
        return state + float(data), None

    with wd:
        assert active() is wd
        result = iterate(
            step, 0.0, [float(i) for i in range(10)],
            IterationConfig(TerminateOnMaxIter(10), checkpoint_interval=100,
                            checkpoint_manager=mgr),
        )
    assert active() is None
    assert result.preempted
    # Stopped at the epoch boundary after the request: 4 epochs ran.
    assert result.epochs == 4 and fired["at"] == 3
    # One final checkpoint committed, engines drained afterwards.
    assert mgr.latest_epoch() == 4
    assert engine.stopped == [True]
    state, epoch = mgr.restore_latest(0.0)
    assert (state, epoch) == (0.0 + 0 + 1 + 2 + 3, 4)


def test_watchdog_resume_completes_to_parity(tmp_path):
    golden = iterate(_count_step, 0.0, [float(i) for i in range(8)],
                     IterationConfig(TerminateOnMaxIter(8))).state

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    wd = PreemptionWatchdog(signals=())

    def step(state, data, epoch):
        if epoch == 4:
            wd.request()
        return state + float(data), None

    with wd:
        first = iterate(step, 0.0, [float(i) for i in range(8)],
                        IterationConfig(TerminateOnMaxIter(8),
                                        checkpoint_manager=mgr))
    assert first.preempted
    resumed = iterate(_count_step, 0.0, [float(i) for i in range(8)],
                      IterationConfig(TerminateOnMaxIter(8),
                                      checkpoint_manager=mgr),
                      resume=True)
    assert not resumed.preempted
    assert resumed.state == golden


def test_watchdog_sigterm_sets_flag():
    wd = PreemptionWatchdog(signals=(signal.SIGTERM,))
    with wd:
        os.kill(os.getpid(), signal.SIGTERM)
        # CPython delivers the signal at a bytecode boundary; the wait
        # below both yields and bounds the test.
        assert wd._event.wait(timeout=5.0)
        assert wd.requested and wd.reason == f"signal {signal.SIGTERM}"
    # Handler restored: sending SIGTERM now would kill the process, so
    # just check the watchdog is no longer active.
    assert active() is None


def test_watchdog_finalize_idempotent():
    engine = _DrainRecorder()
    wd = PreemptionWatchdog(signals=())
    wd.register_engine(engine)
    wd.finalize()
    wd.finalize()
    assert engine.stopped == [True]


def test_watchdog_preemption_with_torn_final_write_falls_back(tmp_path):
    """Compound failure: SIGTERM arrives AND the
    preemption's final checkpoint write tears (``TornWrite`` at the
    ``checkpoint.write`` seam — the host dies mid-flush of its last
    snapshot). The torn commit must surface, the PRIOR interval commit
    must remain the restore point, and a resume must reach parity with
    the uninterrupted run."""
    stream = [float(i) for i in range(8)]
    golden = iterate(_count_step, 0.0, stream,
                     IterationConfig(TerminateOnMaxIter(8))).state

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=10)
    wd = PreemptionWatchdog(signals=(signal.SIGTERM,))

    def step(state, data, epoch):
        if epoch == 4:
            os.kill(os.getpid(), signal.SIGTERM)  # a REAL SIGTERM
        return state + float(data), None

    # Interval commits land at epochs 2 and 4; the preemption stop then
    # attempts a terminal snapshot at epoch 5, whose write tears.
    with wd:
        with faults.armed(faults.FaultPlan(faults.TornWrite(5))) as plan:
            with pytest.raises(faults.FaultInjected, match="torn"):
                iterate(
                    step, 0.0, stream,
                    IterationConfig(TerminateOnMaxIter(8),
                                    checkpoint_interval=2,
                                    checkpoint_manager=mgr),
                )
    assert ("checkpoint.write", "TornWrite(5)", {
        "epoch": 5, "directory": str(tmp_path / "ckpt"),
    }) in [(s, d, {k: v for k, v in c.items() if k != "path"})
           for s, d, c in plan.log]
    # The torn epoch-5 snapshot never became visible; epoch 4 survives.
    assert mgr.latest_epoch() == 4
    state, epoch = mgr.restore_latest(0.0)
    assert (state, epoch) == (0.0 + 0 + 1 + 2 + 3, 4)

    resumed = iterate(_count_step, 0.0, stream,
                      IterationConfig(TerminateOnMaxIter(8),
                                      checkpoint_interval=2,
                                      checkpoint_manager=mgr),
                      resume=True)
    assert not resumed.preempted
    assert resumed.state == golden


# ---------------------------------------------------------------------------
# Across packages: plan JSON, replay, FuzzPlan, the poison helpers
# ---------------------------------------------------------------------------

from flinkml_tpu import faults as jax_faults  # noqa: E402


def _every_fault(mod, marker):
    return mod.FaultPlan(
        mod.RaiseAtEpoch(3, message="boom"), mod.KillAfterCheckpoint(2),
        mod.CorruptSnapshot(1, "truncate"), mod.TornWrite(4),
        mod.TransferFault(2, "delay", 0.01), mod.DropPublish(3),
        mod.RaiseAtRead(5, "data.prefetch"),
        mod.DelayRead(0.002, first_n=4), mod.RankLost(6, rank=1),
        mod.ReplicaDown("r1", 2), mod.StallDispatch("r0", 1, 0.1, 5),
        mod.JitterDispatch("r2", 0.3, 0.05, seed=9), mod.SlowRamp("r3"),
        mod.WorkerCrash(4, "epoch", 23, marker), mod.FailRendezvous(2),
        mod.NaNGrad(7), mod.InfLoss(8), mod.PoisonBatch(9),
    )


def test_fault_catalog_and_plan_json_match_jax(tmp_path):
    """Every fault class of the JAX package exists in the port with the
    same constructor record; a plan's JSON is the same bytes."""
    assert sorted(faults.fault_types()) == sorted(jax_faults.fault_types())
    marker = str(tmp_path / "m")
    got, want = _every_fault(faults, marker), _every_fault(jax_faults, marker)
    extra = {"seed": 3, "scenario": {"batches": 10}}
    assert faults.plan_to_json(got, extra) == \
        jax_faults.plan_to_json(want, extra)
    assert [f.describe() for f in got.faults] == \
        [f.describe() for f in want.faults]


def test_jax_written_plan_replays_in_port():
    """A repro file written by the JAX package replays in the port: the
    same faults fire at the same sites and epochs of the same loop."""
    plan = jax_faults.FaultPlan(jax_faults.NaNGrad(2),
                                jax_faults.RaiseAtEpoch(4))
    payload = jax_faults.plan_to_json(plan, extra={"seed": 1})
    logs = []
    for mod, run, cfg in ((faults, iterate, IterationConfig),
                          (jax_faults, None, None)):
        replay = mod.plan_from_json(payload)
        if mod is jax_faults:
            from flinkml_tpu.iteration import IterationConfig as cfg
            from flinkml_tpu.iteration import iterate as run
        with mod.armed(replay):
            with pytest.raises(mod.FaultInjected, match="epoch 4"):
                run(lambda s, d, e: ({"w": s["w"] + d}, None),
                    {"w": np.zeros(2)}, [1.0] * 6,
                    cfg(TerminateOnMaxIter(6)))
        logs.append([(site, desc) for site, desc, _ in replay.log])
    assert logs[0] == logs[1] == [("train.step", "NaNGrad(at_epoch=2)"),
                                  ("iteration.epoch", "RaiseAtEpoch(4)")]


@pytest.mark.parametrize("seed", [7, 11])
def test_fuzzplan_samples_match_jax(seed, tmp_path):
    """``FuzzPlan(seed).sample(i)`` is JAX's schedule for i < 50, on the
    trainer seams and on the worker soak's (markers included)."""
    markers = str(tmp_path)
    for kw in ({}, {"seams": ("cluster.worker", "iteration.epoch",
                              "train.step"),
                    "max_faults": 2, "marker_dir": markers}):
        got = faults.FuzzPlan(seed, **kw)
        want = jax_faults.FuzzPlan(seed, **kw)
        for i in range(50):
            assert faults.plan_to_json(got.sample(i)) == \
                jax_faults.plan_to_json(want.sample(i)), i


def test_poison_helpers_keep_device_dtype_and_structure():
    """NaNGrad's and PoisonBatch's twins: every float leaf all-NaN in its
    own dtype and on its own device, ints, bools and object columns
    untouched, containers (dict key order, tuples, Tables) kept."""
    import torch

    from flinkml_tpu_torch.table import PaddedDeviceColumn, Table

    state = {"z": torch.ones(3, dtype=torch.float32),
             "b": torch.ones(2, dtype=torch.bfloat16),
             "version": 4, "idx": torch.arange(3),
             "h": (np.ones(2), np.arange(2))}
    out = faults._poison_float_leaves(state)
    assert list(out) == list(state) and isinstance(out["h"], tuple)
    for key in ("z", "b"):
        assert out[key].dtype == state[key].dtype
        assert out[key].device == state[key].device
        assert torch.isnan(out[key].float()).all()
    assert out["version"] == 4 and torch.equal(out["idx"], state["idx"])
    assert np.isnan(out["h"][0]).all()
    np.testing.assert_array_equal(out["h"][1], np.arange(2))
    assert torch.equal(state["z"], torch.ones(3))  # the input is untouched

    from flinkml_tpu_torch.linalg import SparseVector

    sv = np.empty(2, dtype=object)
    sv[:] = [SparseVector(4, [1], [2.0]), SparseVector(4, [0], [1.0])]
    batch = Table({"x": np.ones((2, 3), np.float32), "ids": np.arange(2),
                   "sv": sv, "t": torch.ones(2, 2, dtype=torch.float64),
                   "p": PaddedDeviceColumn(torch.ones(4, 3), 2)})
    twin = faults._poison_batch_value(batch)
    assert twin.column_names == batch.column_names
    assert np.isnan(twin.column("x")).all() and \
        twin.column("x").dtype == np.float32
    np.testing.assert_array_equal(twin.column("ids"), np.arange(2))
    assert twin.column("sv") is sv
    assert np.isnan(twin.column("t")).all()
    assert twin.num_rows == 2 and np.isnan(twin.column("p")).all()
    assert twin._raw_column("p").buf.shape == (4, 3)
