"""The port's ``parallel/`` (``flinkml_tpu_torch.parallel``) against the
JAX package's, on the CPU.

Multi-rank: the port's collectives run on P = 2 and 4 gloo ranks (one
process each, a ``file://`` rendezvous under the test's directory, started
once per P by :func:`flinkml_tpu_torch.parallel.launch.spawn_ranks` with
its own timeout; the rank body is ``tests/_torch_mesh_worker.py``, which
imports no JAX), and JAX's on a P-device mesh of the conftest's 8 CPU
devices, from the same numpy inputs: the cases of ``tests/
test_parallel.py`` (all-reduce, keyed aggregate, map partition,
broadcast, shard/replicate/``to_host``) plus the barrier, the agreement
and the mesh's shape rules. Each output is held twice: the same bits on
every rank, and JAX's value within the JAX tests' own tolerance (1e-12
relative for the all-reduce, 1e-10 for the keyed aggregate; gloo adds in
its own order).

One process: the cases of ``test_broadcast.py``, ``test_dispatch.py``,
``test_device_lock.py`` and the single-process cases of
``test_distributed.py`` (retry, jitter, deadline, ``process_slice``,
``compact_rank``, ``host_barrier``), each run in both packages where the
JAX function runs here; ``nccl`` with two ranks on one card and a ``cuda``
mesh without a card raise.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import flinkml_tpu_torch as fml
from flinkml_tpu import parallel as jpar
from flinkml_tpu.parallel import dispatch as jdispatch
from flinkml_tpu.parallel import distributed as jdist
from flinkml_tpu_torch import parallel as tpar
from flinkml_tpu_torch.parallel import dispatch as tdispatch
from flinkml_tpu_torch.parallel import distributed as tdist
from flinkml_tpu_torch.parallel.launch import spawn_ranks
from flinkml_tpu_torch.utils import device_lock as tlock
from flinkml_tpu_torch.utils import logging as tlog
from tests import _torch_mesh_worker as worker
from tests._torch_port_common import on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_worker.py")
WORLDS = (2, 4)
LAUNCH_TIMEOUT_S = 240


def launch(which: str, world: int, workdir: str):
    """Every rank's outputs (``rank<r>.npz``) of one launch."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    spawn_ranks([sys.executable, WORKER, which, workdir], world, workdir,
                LAUNCH_TIMEOUT_S, env=env)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, launch("parallel", world,
                         str(tmp_path_factory.mktemp(f"parallel{world}")))


def jax_reference(world: int) -> dict:
    """JAX's value of every replicated output, on a ``world``-device mesh."""
    inp = worker.make_inputs(world)
    jm = jpar.DeviceMesh({"data": world}, jax.devices()[:world])
    ax = jpar.DeviceMesh.DATA_AXIS
    out = {
        "all_reduce_rows1": jpar.all_reduce_sum(jm, jm.shard_batch(inp["contrib"])),
        "all_reduce_rows3": jpar.all_reduce_sum(jm, inp["contrib3"]),
        "keyed": jpar.keyed_aggregate(jm, inp["values"], inp["keys"], 5),
        "keyed_scalar": jpar.keyed_aggregate(jm, inp["svalues"], inp["skeys"], 4),
        "map_partition": jpar.map_partition(
            jm, lambda s: jnp.sum(s, axis=0, keepdims=True), inp["rows"]),
        "map_partition_replicated": jpar.map_partition(
            jm, lambda s: jax.lax.psum(jnp.sum(s), ax)
            / jax.lax.psum(s.shape[0], ax), inp["rows"][:, 0], out_specs=P()),
    }
    rep = jpar.broadcast(jm, {"w": inp["model_w"], "b": np.float64(2.0)})
    out["broadcast_w"], out["broadcast_b"] = rep["w"], rep["b"]
    out["shard_to_host"] = jm.to_host(jm.shard_batch(inp["table"]))
    out["replicate"] = jm.replicate(np.ones(3))
    out["host_barrier"] = [jdist.host_barrier(jm, tag=3)]
    with pytest.raises(ValueError, match="needs"):
        jpar.DeviceMesh({"data": 2 * world}, jax.devices()[:world])
    multi = jpar.DeviceMesh({"data": world // 2, "fsdp": 2},
                            jax.devices()[:world])
    out["multi_axis_sizes"] = [multi.axis_size("data"), multi.axis_size("fsdp")]
    out["multi_axis_to_host"] = multi.to_host(multi.shard_batch(inp["table"]))
    out = {k: np.asarray(v) for k, v in out.items()}
    # The port's own contract where JAX has no multi-process counterpart:
    # broadcast sends the first rank's bits; the agreement is max/min of
    # the ranks; the bounded dispatch is JAX's multi-process default.
    out["broadcast_from_first_rank"] = np.zeros(3)
    out["agree"] = np.asarray([world - 1, 0])
    out["mesh_too_large_raises"] = np.asarray([1])
    out["dispatch_event_devices"] = np.arange(world)
    out["sync_interval"] = np.asarray([jdispatch._DEFAULT_MULTIPROCESS_INTERVAL])
    return out


REPLICATED_OUTPUTS = (
    "all_reduce_rows1", "all_reduce_rows3", "keyed", "keyed_scalar",
    "map_partition", "map_partition_replicated", "broadcast_w",
    "broadcast_b", "broadcast_from_first_rank", "shard_to_host", "replicate",
    "host_barrier", "agree", "mesh_too_large_raises", "multi_axis_sizes",
    "multi_axis_to_host", "dispatch_event_devices", "sync_interval",
)
#: The JAX tests' tolerances (``tests/test_parallel.py``).
RTOL = {"keyed": 1e-10, "keyed_scalar": 1e-10}


@pytest.fixture(scope="module")
def jax_refs():
    return {world: jax_reference(world) for world in WORLDS}


@pytest.mark.parametrize("name", REPLICATED_OUTPUTS)
def test_ranks_agree_bit_for_bit(ranks, name):
    world, outs = ranks
    for r in range(1, world):
        assert outs[r][name].dtype == outs[0][name].dtype
        np.testing.assert_array_equal(outs[r][name], outs[0][name])


@pytest.mark.parametrize("name", REPLICATED_OUTPUTS)
def test_collective_matches_jax(ranks, jax_refs, name):
    world, outs = ranks
    want = jax_refs[world][name]
    got = outs[0][name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL.get(name, 1e-12), atol=0)


def test_shard_blocks_are_named_sharding_blocks(ranks):
    """Rank r's block is the block ``NamedSharding`` gives device r."""
    world, outs = ranks
    jm = jpar.DeviceMesh({"data": world}, jax.devices()[:world])
    sharded = jm.shard_batch(worker.make_inputs(world)["table"])
    blocks = sorted(sharded.addressable_shards, key=lambda s: s.index[0].start)
    for r in range(world):
        np.testing.assert_array_equal(outs[r]["local_shard"],
                                      np.asarray(blocks[r].data))
        np.testing.assert_array_equal(outs[r]["local_rank_world"], [r, world])


def test_process_slice_per_rank(ranks):
    world, outs = ranks
    for r in range(world):
        s = jdist.process_slice(10, r, world)
        np.testing.assert_array_equal(outs[r]["local_process_slice"],
                                      [s.start, s.stop])


def test_launch_fails_within_its_timeout(tmp_path):
    """A rank that never reaches the collective its peer waits in: the
    launch kills both at its deadline and raises."""
    script = tmp_path / "hang.py"
    script.write_text(
        "import os, time\n"
        "import torch.distributed as dist\n"
        "from flinkml_tpu_torch.parallel import init_distributed\n"
        "import flinkml_tpu_torch as fml\n"
        "fml.set_default_device('cpu')\n"
        "init_distributed()\n"
        "if dist.get_rank() == 0:\n"
        "    time.sleep(600)\n"
        "dist.barrier()\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn_ranks([sys.executable, str(script)], 2, str(tmp_path), 12,
                    env=env)


def test_launch_reports_a_failed_rank(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text("import os, sys\n"
                      "sys.exit(3 if os.environ['FLINKML_TPU_RANK'] == '1' "
                      "else 0)\n")
    with pytest.raises(RuntimeError, match=r"exit codes \[0, 3\]"):
        spawn_ranks([sys.executable, str(script)], 2, str(tmp_path), 60)


# -- the mesh in one process ----------------------------------------------------------


def test_world_one_mesh(on_cpu):
    m = tpar.DeviceMesh()
    j = jpar.DeviceMesh(devices=jax.devices()[:1])
    assert m.axis_names == j.axis_names == ("data",)
    assert m.num_devices == j.num_devices == 1
    assert m.axis_size() == j.axis_size() == 1
    assert m.group() is None and m.device == torch.device("cpu")
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(m.to_host(m.shard_batch(x)),
                                  j.to_host(j.shard_batch(x)))
    np.testing.assert_array_equal(m.local_rows(m.global_batch(x)), x)
    with pytest.raises(ValueError, match="needs 2 devices, only 1"):
        tpar.DeviceMesh({"data": 2})
    with pytest.raises(KeyError):
        m.axis_size("model")


def test_for_plan_and_shrink_shapes(on_cpu):
    class Plan:
        def __init__(self, axes):
            self.axes = axes

        def required_axes(self):
            return self.axes

    assert tpar.DeviceMesh.for_plan(Plan(("data",))).shape == {"data": 1}
    assert tpar.DeviceMesh.for_plan(Plan(("fsdp",))).shape == \
        {"data": 1, "fsdp": 1}
    assert tpar.DeviceMesh.for_plan(Plan(("fsdp", "tp"))).shape == \
        {"data": 1, "fsdp": 1, "tp": 1}
    assert tpar.DeviceMesh().shrink(1).shape == {"data": 1}
    with pytest.raises(ValueError, match="cannot shrink"):
        tpar.DeviceMesh().shrink(2)


def test_collectives_on_a_world_one_mesh_match_jax(on_cpu, rng):
    m = tpar.DeviceMesh()
    j = jpar.DeviceMesh(devices=jax.devices()[:1])
    contrib = rng.normal(size=(4, 7))
    np.testing.assert_allclose(tpar.all_reduce_sum(m, contrib).numpy(),
                               np.asarray(jpar.all_reduce_sum(j, contrib)),
                               rtol=1e-12)
    values, keys = rng.normal(size=(20, 2)), rng.integers(0, 3, size=20)
    np.testing.assert_allclose(
        tpar.keyed_aggregate(m, values, keys, 3).numpy(),
        np.asarray(jpar.keyed_aggregate(j, values, keys, 3)), rtol=1e-10)
    got = tpar.map_partition(m, lambda s: s * 2.0, np.arange(4.0))
    np.testing.assert_array_equal(got.numpy(), np.arange(4.0) * 2.0)
    with pytest.raises(ValueError, match="out_specs"):
        tpar.map_partition(m, lambda s: s, np.arange(4.0), out_specs="rows")


def test_mesh_type_is_checked(on_cpu):
    for cls in (fml.LogisticRegression, fml.LinearSVC, fml.LinearRegression,
                fml.KMeans, fml.BisectingKMeans, fml.LogisticRegressionModel,
                fml.KMeansModel):
        with pytest.raises(TypeError, match="DeviceMesh"):
            cls(mesh=object())
        assert cls(mesh=tpar.DeviceMesh()).mesh is not None


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda mesh forms")
    with pytest.raises(RuntimeError, match="use_device"):
        tpar.DeviceMesh()   # the default compute device is cuda
    with pytest.raises(RuntimeError, match="use_device"):
        tdist.default_backend()


def test_nccl_two_ranks_on_one_card_raise_before_the_group(tmp_path,
                                                           monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    formed = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: formed.append(a))
    addr = "file://" + str(tmp_path / "store")
    with pytest.raises(ValueError, match="one rank per CUDA device"):
        tdist.init_distributed(addr, 2, 0, backend="nccl")   # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks share this host's 1"):
        tdist.init_distributed(addr, 2, 1, backend="nccl")
    assert formed == [] and not dist.is_initialized()


def test_world_one_group_over_gloo(tmp_path, on_cpu):
    """With an address the group forms at world 1 too (the JAX package
    skips it), and a mesh fit over it equals the fit without a mesh bit
    for bit."""
    from flinkml_tpu_torch.models import _linear_sgd as t_sgd

    x, y, w = worker.dense_lr_data(n=60)
    kw = dict(worker.DENSE_KW, max_iter=6)
    plain = t_sgd.train_linear_model(x, y, w, "logistic", **kw)
    assert tdist.init_distributed("file://" + str(tmp_path / "s"), 1, 0) \
        == (0, 1)
    try:
        assert tdist.is_initialized()
        mesh = tpar.DeviceMesh()
        assert mesh.group() is not None
        events = []
        tdispatch.add_dispatch_observer(events.append)
        try:
            meshed = t_sgd.train_linear_model(x, y, w, "logistic", mesh=mesh,
                                              **kw)
        finally:
            tdispatch.remove_dispatch_observer(events.append)
        assert len(events) == kw["max_iter"]   # one all_reduce a step
        np.testing.assert_array_equal(meshed, plain)
        assert tlog.rank_tag() == "[rank 0/1]"
    finally:
        tdist.shutdown_distributed()
    assert not tdist.is_initialized()


# -- broadcast variables (tests/test_broadcast.py) --------------------------------------


def test_with_broadcast_basic(on_cpu):
    coef = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    x = np.ones((4, 3), dtype=np.float32)
    for mod in (tpar, jpar):
        def predict(batch):
            c = mod.get_broadcast_variable("model")
            return np.asarray(batch @ np.asarray(c))

        out = mod.with_broadcast(predict, inputs=[x],
                                 broadcast_variables={"model": coef})
        np.testing.assert_allclose(out, np.full(4, 6.0), rtol=1e-6)


def test_with_broadcast_over_mesh(on_cpu):
    coef = np.arange(8, dtype=np.float32)
    mesh = tpar.DeviceMesh()

    def fn():
        c = tpar.get_broadcast_variable("coef")
        assert torch.is_tensor(c) and c.device == mesh.device
        return c.numpy()

    out = tpar.with_broadcast(fn, broadcast_variables={"coef": coef},
                              mesh=mesh)
    np.testing.assert_array_equal(out, coef)


def test_broadcast_scope_cleanup(on_cpu):
    for mod in (tpar, jpar):
        mod.with_broadcast(lambda: None, broadcast_variables={"v": np.zeros(2)})
        with pytest.raises(KeyError):
            mod.get_broadcast_variable("v")


def test_nested_scopes_shadow(on_cpu):
    for mod in (tpar, jpar):
        def outer():
            def inner():
                assert float(np.asarray(mod.get_broadcast_variable("v"))[0]) == 2.0
                assert float(np.asarray(mod.get_broadcast_variable("w"))[0]) == 9.0
                return True

            assert mod.with_broadcast(inner,
                                      broadcast_variables={"v": np.full(1, 2.0)})
            return float(np.asarray(mod.get_broadcast_variable("v"))[0])

        assert mod.with_broadcast(outer, broadcast_variables={
            "v": np.full(1, 1.0), "w": np.full(1, 9.0)}) == 1.0


def test_missing_variable_raises(on_cpu):
    for mod in (tpar, jpar):
        with pytest.raises(KeyError, match="no broadcast variable"):
            mod.with_broadcast(lambda: mod.get_broadcast_variable("nope"),
                               broadcast_variables={})


# -- bounded dispatch and the lock registry (tests/test_dispatch.py) --------------------


@pytest.fixture
def port_lock_registry():
    """Restore the port's lock and lease registries after a test."""
    saved = dict(tdispatch._MESH_LOCKS)
    yield
    with tdispatch._MESH_LOCKS_GUARD:
        tdispatch._MESH_LOCKS.clear()
        tdispatch._MESH_LOCKS.update(saved)


def test_default_interval_single_process_unbounded(monkeypatch):
    monkeypatch.delenv("FLINKML_SYNC_INTERVAL", raising=False)
    assert tpar.default_sync_interval() == jpar.default_sync_interval() == 0


def test_env_override(monkeypatch):
    for value in ("4", "0"):
        monkeypatch.setenv("FLINKML_SYNC_INTERVAL", value)
        assert tpar.default_sync_interval() == jpar.default_sync_interval() \
            == int(value)


def test_guard_blocks_every_interval(monkeypatch):
    syncs = []
    guard = tpar.DispatchGuard(interval=3)
    monkeypatch.setattr(tdispatch, "block_until_ready",
                        lambda c: syncs.append(c) or c)
    for i in range(7):
        guard.after_dispatch(i)
    assert syncs == [2, 5]
    guard.flush(99)
    assert syncs == [2, 5, 99]
    guard.flush(100)
    assert syncs == [2, 5, 99]


def test_synced_loop_runs_all_steps_and_returns_carry():
    out = tpar.synced_loop(10, lambda c, i: c + torch.tensor(float(i)),
                           torch.tensor(0.0), interval=4)
    want = jpar.synced_loop(10, lambda c, i: c + jnp.float32(i),
                            jnp.float32(0), interval=4)
    assert float(out) == float(want) == sum(range(10))


def test_synced_loop_zero_steps():
    init = torch.arange(3.0)
    assert tpar.synced_loop(0, lambda c, i: pytest.fail("must not run"),
                            init) is init


def test_lock_registry_per_device_set(port_lock_registry):
    a = tdispatch.local_execution_lock([0, 1])
    assert tdispatch.local_execution_lock((1, 0)) is a
    with a:
        assert "lock:mesh:0,1" in tdispatch.held_lock_tokens()
    assert tdispatch.held_lock_tokens() == ()
    overlap = tdispatch.local_execution_lock([1, 2])
    assert isinstance(overlap, tdispatch._CompositeLock)
    with tdispatch.local_execution_lock(None):
        assert "lock:process" in tdispatch.held_lock_tokens()
    with tdispatch.lease_devices([3], "fit") as lease:
        assert tdispatch.leased_device_ids() == frozenset({3})
        with pytest.raises(ValueError, match="already registered"):
            tdispatch.lease_devices([3], "fit")
        assert lease.snapshot()["devices"] == [3]
    assert tdispatch.leased_device_ids() == frozenset()


def test_dispatch_events_carry_held_locks(port_lock_registry):
    events = []
    tdispatch.add_dispatch_observer(events.append)
    try:
        with tdispatch.local_execution_lock([0]):
            tdispatch.record_collective_dispatch("p", [0], ("all_reduce",))
    finally:
        tdispatch.remove_dispatch_observer(events.append)
    assert events[0]["devices"] == (0,)
    assert events[0]["locks"] == ("lock:mesh:0",)
    assert not tdispatch.has_dispatch_observers()


# -- the device-client lock (tests/test_device_lock.py) ----------------------------------


def test_cpu_process_skips_lock(tmp_path, monkeypatch, on_cpu):
    monkeypatch.setenv(tlock.LOCK_PATH_ENV, str(tmp_path / "lock"))
    with tlock.device_client_lock() as acquired:
        assert acquired is False
    assert not (tmp_path / "lock").exists()


def test_exclusive_across_processes(tmp_path, monkeypatch):
    path = str(tmp_path / "lock")
    monkeypatch.setenv(tlock.LOCK_PATH_ENV, path)
    code = (
        "import os\n"
        "os.environ.pop('_FLINKML_TPU_DEVICE_LOCK_HELD', None)\n"
        "from flinkml_tpu_torch.utils.device_lock import device_client_lock\n"
        "try:\n"
        "    with device_client_lock(timeout_s=0.5, poll_s=0.1, force=True):\n"
        "        print('ACQUIRED')\n"
        "except TimeoutError:\n"
        "    print('TIMEOUT')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    env[tlock.LOCK_PATH_ENV] = path
    with tlock.device_client_lock(force=True) as acquired:
        assert acquired is True
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.stdout.strip() == "TIMEOUT", (out.stdout, out.stderr)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ACQUIRED", (out.stdout, out.stderr)


def test_child_of_holder_skips(tmp_path, monkeypatch):
    monkeypatch.setenv(tlock.LOCK_PATH_ENV, str(tmp_path / "lock"))
    monkeypatch.setattr(tlock, "_targets_cpu_only", lambda: False)
    with tlock.device_client_lock(force=True) as acquired:
        assert acquired is True
        assert os.environ.get(tlock._HELD_ENV) == "1"
        with tlock.device_client_lock() as nested:
            assert nested is False
    assert tlock._HELD_ENV not in os.environ


def test_lock_file_defaults_to_the_temporary_directory(monkeypatch, tmp_path):
    monkeypatch.delenv(tlock.LOCK_PATH_ENV, raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert tlock.lock_path() == str(tmp_path / tlock.DEFAULT_LOCK_NAME)


# -- the process group in one process (tests/test_distributed.py) -----------------------


def test_init_distributed_single_process_noop():
    assert tdist.init_distributed() == jdist.init_distributed() == (0, 1)


def _patch_rendezvous(monkeypatch, outcomes, sleeps):
    """Route ``init_process_group`` through a script: ``outcomes`` lists
    the exceptions to raise (None = succeed)."""
    import torch.distributed as dist

    calls = []

    def fake_init(*args, **kwargs):
        calls.append((args, kwargs))
        outcome = outcomes[len(calls) - 1]
        if outcome is not None:
            raise outcome

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(tdist.time, "sleep", lambda s: sleeps.append(s))
    return calls


def test_init_distributed_retries_transient_rendezvous(monkeypatch, on_cpu):
    sleeps = []
    calls = _patch_rendezvous(monkeypatch, [
        RuntimeError("DEADLINE_EXCEEDED: barrier timed out"),
        RuntimeError("UNAVAILABLE: failed to connect to coordinator"),
        None,
    ], sleeps)
    idx, count = tdist.init_distributed("10.0.0.1:8476", 2, 0,
                                        max_attempts=3, backoff_s=0.5)
    assert len(calls) == 3
    assert calls[0][0] == ("gloo",)
    assert calls[0][1]["init_method"] == "tcp://10.0.0.1:8476"
    assert calls[0][1]["world_size"] == 2 and calls[0][1]["rank"] == 0
    assert 0.5 <= sleeps[0] <= 0.5 * 1.25
    assert 1.0 <= sleeps[1] <= 1.0 * 1.25
    assert (idx, count) == (0, 1)   # the scripted group never formed


def test_init_distributed_reads_the_environment(monkeypatch, on_cpu):
    calls = _patch_rendezvous(monkeypatch, [None, None], [])
    monkeypatch.setenv("FLINKML_TPU_COORD_ADDR", "file:///tmp/x")
    monkeypatch.setenv("FLINKML_TPU_WORLD_SIZE", "4")
    monkeypatch.setenv("FLINKML_TPU_RANK", "3")
    tdist.init_distributed()
    assert calls[0][1] == {"init_method": "file:///tmp/x", "world_size": 4,
                           "rank": 3}
    for name in ("FLINKML_TPU_COORD_ADDR", "FLINKML_TPU_WORLD_SIZE",
                 "FLINKML_TPU_RANK"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("MASTER_ADDR", "host")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    tdist.init_distributed(timeout_s=5)
    assert calls[1][1]["init_method"] == "tcp://host:1234"
    assert (calls[1][1]["world_size"], calls[1][1]["rank"]) == (2, 1)
    assert calls[1][1]["timeout"].total_seconds() == 5


def test_init_distributed_backoff_jitter_decorrelates():
    draws = {tdist.retry_backoff_s(3, 1.0, jitter=0.5) for _ in range(32)}
    assert len(draws) > 1
    assert all(4.0 <= d <= 6.0 for d in draws)
    assert tdist.retry_backoff_s(1, 0.0) == 0.0
    import random

    for mod in (tdist, jdist):
        assert (mod.retry_backoff_s(2, 1.0, jitter=0.5, rng=random.Random(7))
                == jdist.retry_backoff_s(2, 1.0, jitter=0.5,
                                         rng=random.Random(7)))


def test_init_distributed_fails_fast_on_non_transient(monkeypatch, on_cpu):
    sleeps = []
    calls = _patch_rendezvous(monkeypatch, [
        RuntimeError("INVALID_ARGUMENT: rank 7 out of range"), None], sleeps)
    with pytest.raises(RuntimeError, match="INVALID_ARGUMENT"):
        tdist.init_distributed("10.0.0.1:8476", 2, 0, max_attempts=5)
    assert len(calls) == 1 and sleeps == []


def test_init_distributed_exhausts_attempts(monkeypatch, on_cpu):
    sleeps = []
    err = RuntimeError("connection refused")
    calls = _patch_rendezvous(monkeypatch, [err, err], sleeps)
    with pytest.raises(RuntimeError, match="connection refused"):
        tdist.init_distributed("10.0.0.1:8476", 2, 0, max_attempts=2,
                               backoff_s=0.25)
    assert len(calls) == 2 and len(sleeps) == 1
    assert 0.25 <= sleeps[0] <= 0.25 * 1.25


def test_init_distributed_total_deadline_cap(monkeypatch, on_cpu):
    sleeps = []
    err = RuntimeError("connection refused")
    calls = _patch_rendezvous(monkeypatch, [err] * 10, sleeps)
    monkeypatch.setattr(tdist.time, "monotonic", lambda: 0.0)
    with pytest.raises(RuntimeError, match="connection refused"):
        tdist.init_distributed("10.0.0.1:8476", 2, 0, max_attempts=10,
                               backoff_s=10.0, deadline_s=5.0)
    assert len(calls) == 1 and sleeps == []
    with pytest.raises(ValueError, match="deadline_s"):
        tdist.init_distributed("10.0.0.1:8476", 2, 0, deadline_s=-1.0)
    with pytest.raises(ValueError, match="invalid rank"):
        tdist.init_distributed("10.0.0.1:8476", 2, 2)


def test_host_barrier_sums_over_the_mesh(on_cpu):
    mesh = tpar.DeviceMesh()
    jm = jpar.DeviceMesh(devices=jax.devices()[:1])
    for tag in (1, 3):
        assert tpar.host_barrier(mesh, tag=tag) == \
            jpar.host_barrier(jm, tag=tag) == tag
    assert tpar.host_barrier(tag=2) == 2   # the default all-ranks mesh


@pytest.mark.parametrize(
    "n,count,expected",
    [(10, 2, [(0, 5), (5, 10)]), (10, 3, [(0, 4), (4, 7), (7, 10)]),
     (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)])],
)
def test_process_slice_partitions_exactly(n, count, expected):
    slices = [tpar.process_slice(n, p, count) for p in range(count)]
    assert slices == [jpar.process_slice(n, p, count) for p in range(count)]
    assert [(s.start, s.stop) for s in slices] == expected


def test_process_slice_defaults_to_this_process():
    assert tpar.process_slice(100) == slice(0, 100)


def test_compact_rank_and_rescale_world(monkeypatch):
    for lost in ([1], [0, 2], []):
        for old in range(4):
            assert tpar.compact_rank(old, lost) == jpar.compact_rank(old, lost)
    monkeypatch.delenv("FLINKML_TPU_COORD_ADDR", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tpar.rescale_world(1, 0) == (0, 1)
    with pytest.raises(ValueError, match="invalid rescaled"):
        tpar.rescale_world(2, 2)
    tdist.require_single_controller("a one-process path")


def test_agree_resume_epoch_single_process(tmp_path):
    from flinkml_tpu_torch.iteration import CheckpointManager

    mgr = CheckpointManager(str(tmp_path))
    assert tpar.agree_resume_epoch(mgr) is None
    mgr.save({"w": np.ones(2)}, 2)
    mgr.save({"w": np.ones(2)}, 4)
    assert tpar.agree_resume_epoch(mgr, old_world=2, new_world=1) == 4


def test_rank_tagged_logging(monkeypatch):
    monkeypatch.setattr(tlog, "_RANK", None)
    monkeypatch.setenv("FLINKML_TPU_RANK", "2")
    monkeypatch.setenv("FLINKML_TPU_WORLD_SIZE", "4")
    assert tlog.rank_tag() == "[rank 2/4]"
    tlog.set_rank(1, 3)
    assert tlog.rank_tag() == "[rank 1/3]"
    log = tlog.get_logger("distributed")
    assert log.logger.name == "flinkml_tpu_torch.distributed"
    assert log.process("hi", {})[0] == "[rank 1/3] hi"
    import logging

    handler = tlog.enable_console(logging.WARNING)
    assert tlog.enable_console(logging.WARNING) is handler
    logging.getLogger(tlog.ROOT_NAME).removeHandler(handler)
