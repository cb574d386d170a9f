"""The port's iteration runtime, device loop and checkpoint manager
(``flinkml_tpu_torch.iteration``) against the JAX package's
(``flinkml_tpu.iteration``), on the CPU: every case of
``tests/test_iteration.py`` run on both packages with the same inputs
(``rescale="reshard"`` becomes a refusal case), and snapshots crossing
packages in both directions, the FTRL dict carry included (leaf order:
sorted keys, as ``jax.tree_util`` flattens a dict).

Tolerance: exact. The loops run the same float64 additions in the same
order on both sides.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flinkml_tpu.iteration import (
    CheckpointManager as JaxCheckpointManager,
    IterationConfig as JaxConfig,
    IterationListener as JaxListener,
    Iterations as JaxIterations,
    TerminateOnMaxIter as JaxMaxIter,
    TerminateOnMaxIterOrTol as JaxMaxIterOrTol,
    device_iterate as jax_device_iterate,
    iterate as jax_iterate,
)
from flinkml_tpu_torch import iteration as t_it
from flinkml_tpu_torch.iteration import checkpoint as t_ckpt
from flinkml_tpu_torch.iteration import (
    CheckpointManager,
    IterationConfig,
    IterationListener,
    Iterations,
    TerminateOnMaxIter,
    TerminateOnMaxIterOrTol,
    device_iterate,
    iterate,
)

BOTH = (
    (iterate, IterationConfig, TerminateOnMaxIter, TerminateOnMaxIterOrTol),
    (jax_iterate, JaxConfig, JaxMaxIter, JaxMaxIterOrTol),
)


def test_bounded_replay_sum():
    records = np.arange(4000, dtype=np.float64)

    def step(state, data, epoch):
        return state + data.sum(), None

    got = Iterations.iterate_bounded_streams_until_termination(
        step, 0.0, records, IterationConfig(TerminateOnMaxIter(5)))
    want = JaxIterations.iterate_bounded_streams_until_termination(
        step, 0.0, records, JaxConfig(JaxMaxIter(5)))
    assert got.epochs == want.epochs == 5
    assert got.state == want.state == pytest.approx(5 * records.sum())


def test_terminate_on_tol():
    def step(state, epoch):
        new = state / 2.0
        return new, new

    for it, cfg, _, tol_crit in BOTH:
        result = it(step, 1.0, config=cfg(tol_crit(100, 0.01)))
        assert result.state <= 0.01
        assert result.epochs == 7
        assert result.criteria_history[-1] <= 0.01
    got = iterate(step, 1.0, config=IterationConfig(
        TerminateOnMaxIterOrTol(100, 0.01)))
    want = jax_iterate(step, 1.0, config=JaxConfig(JaxMaxIterOrTol(100, 0.01)))
    assert got.criteria_history == want.criteria_history


def test_max_iter_validation():
    for cls in (TerminateOnMaxIter, JaxMaxIter):
        with pytest.raises(ValueError):
            cls(0)
    for cls in (TerminateOnMaxIterOrTol, JaxMaxIterOrTol):
        with pytest.raises(ValueError):
            cls(0, 0.1)
    for epoch in range(6):
        assert TerminateOnMaxIter(4).should_terminate(epoch, None) == \
            JaxMaxIter(4).should_terminate(epoch, None)


def _recorder(base):
    events = []

    class Recorder(base):
        def on_epoch_watermark_incremented(self, epoch, state):
            events.append(("epoch", epoch, state))

        def on_iteration_terminated(self, state):
            events.append(("terminated", state))

    return Recorder(), events


def test_listeners_called_per_epoch():
    def step(state, epoch):
        return state + 1, None

    rec, got = _recorder(IterationListener)
    iterate(step, 0, config=IterationConfig(TerminateOnMaxIter(3)),
            listeners=[rec])
    jrec, want = _recorder(JaxListener)
    jax_iterate(step, 0, config=JaxConfig(JaxMaxIter(3)), listeners=[jrec])
    assert got == want == [("epoch", 0, 1), ("epoch", 1, 2), ("epoch", 2, 3),
                           ("terminated", 3)]


def test_forward_inputs_of_last_round():
    from flinkml_tpu.iteration import ForwardInputsOfLastRound as JaxForward

    got, want = t_it.ForwardInputsOfLastRound(lambda s: s * 10), \
        JaxForward(lambda s: s * 10)
    iterate(lambda s, e: (s + 1, None), 0,
            config=IterationConfig(TerminateOnMaxIter(4)), listeners=[got])
    jax_iterate(lambda s, e: (s + 1, None), 0,
                config=JaxConfig(JaxMaxIter(4)), listeners=[want])
    assert got.terminated and want.terminated
    assert got.value == want.value == 40


def test_unbounded_stream_consumes_once_each():
    batches = [np.full(10, i, dtype=np.float64) for i in range(4)]

    def step(state, batch, epoch):
        return state + batch.sum(), None

    got = Iterations.iterate_unbounded_streams(
        step, 0.0, batches, IterationConfig(TerminateOnMaxIter(100)))
    want = JaxIterations.iterate_unbounded_streams(
        step, 0.0, batches, JaxConfig(JaxMaxIter(100)))
    assert got.epochs == want.epochs == 4
    assert got.state == want.state


def test_callable_data_provider_stops_on_none():
    def provider(epoch):
        return np.ones(3) if epoch < 6 else None

    def step(state, batch, epoch):
        return state + batch.sum(), None

    for it, cfg, max_iter, _ in BOTH:
        result = it(step, 0.0, provider, cfg(max_iter(100)))
        assert result.epochs == 6 and result.state == 18.0


def test_outputs_collected():
    def step(state, epoch):
        return state + 1, None, state * 10

    for it, cfg, max_iter, _ in BOTH:
        assert it(step, 0, config=cfg(max_iter(3))).outputs == [0, 10, 20]


def test_tensor_step():
    """A step on device tensors (the port's counterpart of the jitted
    step): the criterion is a 0-d tensor, read as a float."""
    def tstep(state, data, epoch):
        new = state + torch.sum(data)
        return new, torch.abs(new)

    @jax.jit
    def jstep(state, data, epoch):
        new = state + jnp.sum(data)
        return new, jnp.abs(new)

    got = iterate(tstep, torch.tensor(0.0, dtype=torch.float64),
                  torch.ones(8, dtype=torch.float64),
                  IterationConfig(TerminateOnMaxIter(4)))
    want = jax_iterate(jstep, jnp.asarray(0.0), jnp.ones(8),
                       JaxConfig(JaxMaxIter(4)))
    assert float(got.state) == float(want.state) == 32.0
    assert got.criteria_history == want.criteria_history


def test_device_iterate_max_iter():
    state, epochs, _ = device_iterate(
        lambda s, e: (s + 1.0, torch.tensor(1e9)), torch.tensor(0.0), 10)
    jstate, jepochs, _ = jax_device_iterate(
        lambda s, e: (s + 1.0, jnp.asarray(1e9)), jnp.asarray(0.0), 10)
    assert float(state) == float(jstate) == 10.0
    assert int(epochs) == int(jepochs) == 10


def test_device_iterate_tol():
    def tstep(state, epoch):
        new = state / 2.0
        return new, new

    def jstep(state, epoch):
        new = state / 2.0
        return new, new

    state, epochs, crit = device_iterate(tstep, torch.tensor(1.0), 100,
                                         tol=0.01)
    jstate, jepochs, jcrit = jax_device_iterate(jstep, jnp.asarray(1.0), 100,
                                                tol=0.01)
    assert int(epochs) == int(jepochs) == 7
    assert float(crit) == float(jcrit) <= 0.01
    assert float(state) == float(jstate)


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------


def test_checkpoint_save_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": np.arange(5.0),
             "rng": np.asarray(jax.random.key_data(jax.random.key(0)))}
    mgr.save(state, epoch=3)
    restored, epoch = mgr.restore_latest(like=state)
    assert epoch == 3
    np.testing.assert_array_equal(restored["w"], state["w"])
    np.testing.assert_array_equal(restored["rng"], state["rng"])
    # A tensor leaf is saved from the device's copy and comes back as
    # numpy.
    mgr.save({"w": torch.arange(5.0, dtype=torch.float64)}, epoch=4)
    back, _ = mgr.restore(4, like={"w": 0})
    np.testing.assert_array_equal(back["w"], np.arange(5.0))


def test_async_checkpoint_matches_sync(tmp_path):
    state = {"w": np.arange(6.0), "e": np.float64(1.5)}
    sync = CheckpointManager(str(tmp_path / "s"))
    anc = CheckpointManager(str(tmp_path / "a"), async_write=True)
    for epoch in (1, 2, 3):
        sync.save(state, epoch)
        anc.save(state, epoch)
    assert anc.all_epochs() == sync.all_epochs() == [1, 2, 3]
    ra, ea = anc.restore_latest(like=state)
    rs, es = sync.restore_latest(like=state)
    assert ea == es == 3
    np.testing.assert_array_equal(ra["w"], rs["w"])
    # The same files: the fingerprints agree.
    for mgr in (sync, anc):
        with open(os.path.join(mgr.directory, "ckpt-3", "meta.json")) as f:
            assert json.load(f)["fingerprint"]


def _lr_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 3))
    y = (x[:, 0] > 0).astype(np.float64)
    return x, y, np.ones(64)


def test_async_checkpoint_failover_exact(tmp_path):
    """Crash (a shorter run), resume, bit-exact result, with async writes;
    the JAX package's run of the same fit agrees within 1e-10."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu.models.logistic_regression import (
        train_logistic_regression as jax_train,
    )
    from flinkml_tpu.parallel import DeviceMesh
    from flinkml_tpu_torch.models.logistic_regression import (
        train_logistic_regression,
    )

    x, y, w = _lr_data()
    kw = dict(max_iter=30, learning_rate=0.5, global_batch_size=64, reg=0.0,
              tol=0.0, seed=5)
    with fml.use_device("cpu"):
        golden = train_logistic_regression(x, y, w, **kw)
        mgr = CheckpointManager(str(tmp_path), async_write=True)
        train_logistic_regression(x, y, w, **{**kw, "max_iter": 12},
                                  checkpoint_manager=mgr,
                                  checkpoint_interval=6)
        assert mgr.latest_epoch() == 12
        resumed = train_logistic_regression(
            x, y, w, **kw, checkpoint_manager=mgr, checkpoint_interval=6,
            resume=True)
    np.testing.assert_array_equal(resumed, golden)
    want = jax_train(x, y, w, mesh=DeviceMesh(devices=jax.devices()[:1]),
                     **kw)
    np.testing.assert_allclose(resumed, want, rtol=1e-10, atol=1e-10)


def test_async_checkpoint_snapshots_before_mutation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    state = {"w": np.arange(5.0), "t": torch.arange(3.0)}
    mgr.save(state, epoch=1)
    state["w"] += 100.0
    state["t"] += 100.0
    restored, _ = mgr.restore(1, like=state)
    np.testing.assert_array_equal(restored["w"], np.arange(5.0))
    np.testing.assert_array_equal(restored["t"], np.arange(3.0))
    mgr.close()


def test_async_checkpoint_close_idempotent(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save({"w": np.ones(2)}, epoch=1)
    mgr.close()
    mgr.close()
    mgr.save({"w": np.ones(2)}, epoch=2)
    assert mgr.all_epochs() == [1, 2]
    mgr.close()


def test_async_checkpoint_write_error_surfaces(tmp_path):
    target = tmp_path / "ckpts"
    mgr = CheckpointManager(str(target), async_write=True)
    mgr.save({"w": np.ones(2)}, epoch=1)
    mgr.wait()
    shutil.rmtree(target)
    mgr.save({"w": np.ones(2)}, epoch=2)
    with pytest.raises(OSError):
        mgr.wait()


def test_checkpoint_prune(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=2)
    for e in range(5):
        mgr.save({"x": np.array([e])}, epoch=e)
        jmgr.save({"x": np.array([e])}, epoch=e)
    assert mgr.all_epochs() == jmgr.all_epochs() == [3, 4]


def test_checkpoint_structure_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"a": np.ones(2), "b": np.ones(3)}, epoch=0)
    with pytest.raises(ValueError):
        mgr.restore(0, like={"a": np.ones(2)})


def test_periodic_checkpoint_during_iterate(tmp_path):
    def step(state, epoch):
        return state + 1, None

    mgr = CheckpointManager(str(tmp_path / "t"), max_to_keep=100)
    iterate(step, 0, config=IterationConfig(
        TerminateOnMaxIter(10), checkpoint_interval=3, checkpoint_manager=mgr))
    jmgr = JaxCheckpointManager(str(tmp_path / "j"), max_to_keep=100)
    jax_iterate(step, 0, config=JaxConfig(
        JaxMaxIter(10), checkpoint_interval=3, checkpoint_manager=jmgr))
    assert mgr.all_epochs() == jmgr.all_epochs() == [3, 6, 9, 10]


def _failing_step(fail_at_epoch):
    def step(state, data, epoch):
        if fail_at_epoch is not None and epoch == fail_at_epoch:
            raise RuntimeError("injected failure")
        return state + data.sum() * (epoch + 1), None

    return step


def test_failover_resume_exact(tmp_path):
    """Fail mid-iteration, resume from the checkpoint: exactly the
    no-failure result, and the JAX package's."""
    records = np.arange(100, dtype=np.float64)

    def config(mgr):
        return IterationConfig(TerminateOnMaxIter(8), checkpoint_interval=2,
                               checkpoint_manager=mgr)

    golden = iterate(_failing_step(None), 0.0, records,
                     config(CheckpointManager(str(tmp_path / "g"))))
    mgr = CheckpointManager(str(tmp_path / "f"))
    with pytest.raises(RuntimeError):
        iterate(_failing_step(5), 0.0, records, config(mgr))
    assert mgr.latest_epoch() == 4
    result = iterate(_failing_step(None), 0.0, records, config(mgr),
                     resume=True)
    assert result.state == golden.state
    assert mgr.latest_epoch() == 8
    want = jax_iterate(_failing_step(None), 0.0, records, JaxConfig(
        JaxMaxIter(8), checkpoint_interval=2,
        checkpoint_manager=JaxCheckpointManager(str(tmp_path / "j"))))
    assert result.state == want.state


def test_stream_resume_replay_vs_continue(tmp_path):
    def step(s, data, epoch):
        return s + float(data), None

    def run(mode, stream):
        mgr = CheckpointManager(str(tmp_path / mode))
        mgr.save(30.0, epoch=2)
        return iterate(step, 0.0, stream, IterationConfig(
            TerminateOnMaxIter(4), checkpoint_manager=mgr,
            stream_resume=mode), resume=True).state

    assert run("replay", [10.0, 20.0, 30.0, 40.0]) == 100.0
    assert run("continue", iter([30.0, 40.0])) == 100.0


def test_stream_resume_invalid_mode():
    for it, cfg, max_iter, _ in BOTH:
        with pytest.raises(ValueError, match="stream_resume"):
            it(lambda s, d, e: (s, None), 0, [1.0],
               cfg(max_iter(1), stream_resume="bogus"))


def test_resume_without_manager_raises():
    for it, *_ in BOTH:
        with pytest.raises(ValueError):
            it(lambda s, e: (s, None), 0, resume=True)


def test_resume_with_empty_dir_starts_fresh(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    result = iterate(lambda s, e: (s + 1, None), 0,
                     config=IterationConfig(TerminateOnMaxIter(3),
                                            checkpoint_manager=mgr),
                     resume=True)
    assert result.state == 3


def _bump_world(directory, epoch):
    meta_path = os.path.join(directory, f"ckpt-{epoch}", "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["world_size"] = meta["world_size"] + 1
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def test_rescale_guard_on_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"coef": np.arange(4.0)}
    mgr.save(state, epoch=3)
    _bump_world(str(tmp_path), 3)
    with pytest.raises(t_ckpt.RescaleError, match="rescal"):
        mgr.restore(3, like=state)
    relaxed = CheckpointManager(str(tmp_path), allow_rescale=True)
    restored, epoch = relaxed.restore(3, like=state)
    assert epoch == 3
    np.testing.assert_array_equal(restored["coef"], state["coef"])


def test_rescale_guard_uses_world_size(tmp_path):
    state = {"w": np.ones(2)}
    CheckpointManager(str(tmp_path), world_size=4).save(state, epoch=1)
    _, epoch = CheckpointManager(str(tmp_path), world_size=4).restore(
        1, like=state)
    assert epoch == 1
    with pytest.raises(ValueError, match="rescal"):
        CheckpointManager(str(tmp_path), world_size=2).restore(1, like=state)
    # The port's default world is one card.
    with pytest.raises(ValueError, match="rescal"):
        CheckpointManager(str(tmp_path)).restore(1, like=state)


def test_reshard_and_multi_device_commits_refused(tmp_path):
    """``rescale="reshard"`` of assembled leaves and ``save(plan=...)``
    are ported with the sharding plans (item 7b): a snapshot of the JAX
    package's manager under ``plan=`` and ``reshard`` restores the same
    way in the port. The multi-process commits stay the multi-device
    slice's (ROADMAP.md Queue 1 item 7c), ported: one process,
    ``save_agreed`` is the manager's save, ``rank_scoped`` the manager
    itself, and ``reshard_rank_state`` re-lays out a family the JAX
    package wrote as the JAX package does."""
    from flinkml_tpu.sharding import plan as jax_plan
    from flinkml_tpu_torch.sharding import plan as t_plan

    state = {"w": np.arange(4.0), "b": np.float64(2.0)}
    JaxCheckpointManager(str(tmp_path / "jax"), world_size=4).save(
        state, 1, plan=jax_plan.FSDP)
    CheckpointManager(str(tmp_path / "port"), world_size=4).save(
        state, 1, plan=t_plan.FSDP)
    for d in ("jax", "port"):
        with open(tmp_path / d / "ckpt-1" / "meta.json") as fh:
            assert json.load(fh)["layouts"] == ["replicated", "sharded:0"]
        for mgr in (CheckpointManager(str(tmp_path / d), world_size=2,
                                      rescale="reshard"),
                    JaxCheckpointManager(str(tmp_path / d), world_size=2,
                                         rescale="reshard")):
            got, _ = mgr.restore(1, like=state)
            np.testing.assert_array_equal(got["w"], state["w"])
        for mgr in (CheckpointManager(str(tmp_path / d), world_size=3,
                                      rescale=t_ckpt.RescalePolicy.reshard()),
                    JaxCheckpointManager(str(tmp_path / d), world_size=3,
                                         rescale="reshard")):
            with pytest.raises(ValueError, match="does not divide"):
                mgr.restore(1, like=state)
    mgr = CheckpointManager(str(tmp_path / "agreed"))
    t_ckpt.save_agreed(mgr, state, 1)
    assert mgr.all_epochs() == [1]
    assert t_ckpt.rank_scoped(mgr) is mgr
    from flinkml_tpu.iteration import checkpoint as jax_ckpt

    family = tmp_path / "family"
    for r in range(4):
        JaxCheckpointManager(str(family / f"rank-{r}"), world_size=4).save(
            {"w": np.full(3, 7.0), "rows": np.arange(4.0) + 10 * r}, 2,
            layouts={"w": "replicated", "rows": "sharded:0"})
    like = {"w": 0, "rows": 0}
    for shard in ((0, 2), (1, 2), (0, 1)):
        got = t_ckpt.reshard_rank_state(str(family), 2, like, shard)
        want = jax_ckpt.reshard_rank_state(str(family), 2, like, shard)
        for key in like:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    shutil.rmtree(str(family / "rank-2"))
    with pytest.raises(t_ckpt.RescaleError, match="not contiguous"):
        t_ckpt.reshard_rank_state(str(family), 2, like, (0, 2))


def test_unported_iteration_knobs_refused():
    """The watchdog, sentinel and recovery knobs (item 12) are ported:
    the same poisoned loop raises the same typed ``NumericsError`` at the
    same epoch in both packages under ``sentinel=``, and heals to the same
    state under ``recovery=``. The cursor feeds of the ``data/`` package
    are ported: a Dataset is iterated one batch per epoch, and a feed that
    only looks like one (``peek`` and ``num_shards``) is a plain
    iterable."""
    from flinkml_tpu import iteration as jax_iteration
    from flinkml_tpu import recovery as jax_recovery
    from flinkml_tpu_torch import recovery as t_recovery
    from flinkml_tpu_torch.data import Dataset
    from flinkml_tpu_torch.table import Table

    feed = [1.0, 2.0, float("nan"), 4.0, 5.0]

    def poisoned(s, d, e):
        return {"w": s["w"] + d}, float(d)

    for it, rec in ((jax_iteration, jax_recovery), (None, t_recovery)):
        cfg = (it.IterationConfig if it is not None else IterationConfig)
        run = (it.iterate if it is not None else iterate)
        with pytest.raises(rec.NumericsError) as ei:
            run(poisoned, {"w": np.zeros(2)}, list(feed),
                cfg(TerminateOnMaxIter(5), sentinel=rec.NumericsSentinel()))
        assert (ei.value.epoch, ei.value.source_index,
                ei.value.classification, ei.value.verdict) == (
                    2, 2, "data_poison", 7)
        healed = run(poisoned, {"w": np.zeros(2)}, list(feed),
                     cfg(TerminateOnMaxIter(10),
                         recovery=rec.RecoveryPolicy(backoff_s=0.0),
                         watchdog=None))
        assert healed.recovery["quarantined"] == [2]
        np.testing.assert_array_equal(np.asarray(healed.state["w"]),
                                      np.full(2, 12.0))

    class FakeDataset:
        num_shards = 1

        def peek(self):
            return None

        def __iter__(self):
            return iter([1.0, 2.0])

    def step(s, d, e):
        return s + d, None

    assert iterate(step, 0.0, FakeDataset()).state == 3.0
    ds = Dataset.from_arrays(Table({"y": np.arange(5.0)}), 2)
    result = iterate(lambda s, d, e: (s + float(d.column("y").sum()), None),
                     0.0, ds)
    assert (result.state, result.epochs) == (10.0, 3)


# -- the protocol helpers --------------------------------------------------------


def test_begin_resume_and_should_snapshot_match_jax(tmp_path):
    from flinkml_tpu.iteration import checkpoint as j_ckpt

    for resume in (False, True):
        for mod, cls in ((t_ckpt, CheckpointManager),
                         (j_ckpt, JaxCheckpointManager)):
            mgr = cls(str(tmp_path / f"{mod.__name__}-{resume}"))
            mgr.save({"a": np.ones(1)}, 4)
            assert mod.begin_resume(mgr, resume, 1) == (4 if resume else None)
            assert mgr.world_size == 1
        for args in ((None, 2, 2, 5), (object(), 0, 3, 5), (object(), 2, 4, 5),
                     (object(), 2, 3, 5), (object(), 0, 5, 5)):
            assert t_ckpt.should_snapshot(*args) == \
                j_ckpt.should_snapshot(*args)
        assert t_ckpt.should_snapshot(object(), 0, 1, 5, terminal=True)
    with pytest.raises(ValueError, match="requires a checkpoint_manager"):
        t_ckpt.begin_resume(None, True, 1)


def test_verify_walk_back_and_discard(tmp_path):
    """A truncated newest snapshot fails verification; ``restore_latest``
    walks back to the previous one; with every snapshot damaged it
    raises."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10)
    for e in (2, 4, 6):
        mgr.save({"w": np.full(3, float(e))}, e, extra={"at": e})
    arrays = tmp_path / "ckpt-6" / "arrays.npz"
    arrays.write_bytes(arrays.read_bytes()[:40])
    assert not mgr.verify(6) and mgr.verify(4)
    assert mgr.newest_valid_epoch() == 4
    state, epoch = mgr.restore_latest(like={"w": 0})
    assert epoch == 4 and state["w"].tolist() == [4.0] * 3
    assert mgr.last_restored_extra == {"at": 4} == mgr.read_extra(4)
    # A manifest that is not JSON, then a fingerprint that disagrees.
    (tmp_path / "ckpt-4" / "meta.json").write_text("{")
    meta = json.loads((tmp_path / "ckpt-2" / "meta.json").read_text())
    meta["fingerprint"] = "0" * 64
    (tmp_path / "ckpt-2" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(t_ckpt.CheckpointIntegrityError):
        mgr.restore_latest(like={"w": 0})
    mgr.discard(6)
    mgr.discard(6)
    assert mgr.all_epochs() == [2, 4]


# -- snapshots across packages ------------------------------------------------------


CARRIES = {
    "tuple": lambda: (np.arange(5, dtype=np.float32), np.float64(0.25)),
    # The FTRL carry: JAX flattens it by sorted key (coef, n, version, z).
    "ftrl": lambda: {"z": np.arange(3.0) - 1.0, "n": np.arange(3.0) * 2.0,
                     "coef": np.array([0.5, -0.25, 0.0]), "version": 7},
    "nested": lambda: {"b": [np.ones(2), None], "a": (np.int32(3),)},
}


@pytest.mark.parametrize("carry", sorted(CARRIES))
def test_snapshots_cross_packages(carry, tmp_path):
    """A snapshot written by either package restores in the other, leaf
    for leaf (the JAX manager told it is one device, as it trains here);
    both write the same manifest."""
    state = CARRIES[carry]()
    port = CheckpointManager(str(tmp_path / "port"))
    port.save(state, 5, extra={"k": 1})
    jmgr = JaxCheckpointManager(str(tmp_path / "port"), world_size=1)
    back, epoch = jmgr.restore_latest(like=state)
    assert epoch == 5 and jmgr.last_restored_extra == {"k": 1}
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype

    JaxCheckpointManager(str(tmp_path / "jax"), world_size=1).save(
        state, 9, extra={"k": 2})
    got, epoch = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        like=state)
    assert epoch == 9
    for key in (state if isinstance(state, dict) else range(len(state))):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               got[key], state[key])
    pm = json.loads((tmp_path / "port" / "ckpt-5" / "meta.json").read_text())
    jm = json.loads((tmp_path / "jax" / "ckpt-9" / "meta.json").read_text())
    assert pm["treedef"] == jm["treedef"]
    assert pm["fingerprint"] == jm["fingerprint"]
    assert {k: v for k, v in pm.items() if k not in ("epoch", "extra")} == \
        {k: v for k, v in jm.items() if k not in ("epoch", "extra")}


def test_jax_default_world_is_refused_here(tmp_path):
    """The JAX manager's default world is ``jax.device_count()`` (8 on the
    tests' virtual mesh): the port's one-card default rejects that
    snapshot, and ``rescale="allow"`` takes it."""
    state = {"w": np.ones(2)}
    JaxCheckpointManager(str(tmp_path)).save(state, 1)
    with pytest.raises(t_ckpt.RescaleError, match="world_size=8"):
        CheckpointManager(str(tmp_path)).restore_latest(like=state)
    got, _ = CheckpointManager(str(tmp_path), rescale="allow").restore_latest(
        like=state)
    np.testing.assert_array_equal(got["w"], state["w"])


def test_tree_flatten_matches_jax():
    trees = [CARRIES[k]() for k in sorted(CARRIES)] + [
        1.0, [1, 2], None, (1,), {"a": (1, None), "b": [2]}]
    for tree in trees:
        leaves, treedef = t_ckpt.tree_flatten(tree)
        jleaves, jdef = jax.tree_util.tree_flatten(tree)
        assert treedef == str(jdef)
        assert len(leaves) == len(jleaves)
        for a, b in zip(leaves, jleaves):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        back = t_ckpt.tree_unflatten(tree, leaves)
        assert str(jax.tree_util.tree_structure(back)) == str(jdef)
