"""The port's ``ElasticFeed`` and elastic resume of the online trainer
against the JAX package, on the CPU (the one-process cases of
``tests/test_elastic_resume.py``).

An ElasticFeed merges ``world`` shard readers round-robin into one global
order, so the batches it delivers — and a model trained on them — do not
depend on ``world``. The crash is a post-merge ``map`` that raises at one
global batch (the cases with the ``faults`` seams and the watchdog are in
``tests/test_torch_preemption.py``).

Declared tolerances: within the port every comparison is exact (the same
float64 operations in the same order on the CPU); against the JAX
package's FTRL model 1e-12 (float64, sums in another order).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

import flinkml_tpu.data as jdata
import flinkml_tpu_torch as fml
import flinkml_tpu_torch.data as tdata
from flinkml_tpu.models.online_logistic_regression import (
    OnlineLogisticRegression as JaxOnlineLR,
)
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.iteration import CheckpointManager, RescaleError
from flinkml_tpu_torch.table import Table
from tests._torch_port_common import on_cpu  # noqa: F401

B = 24          # global batches
DIM = 5
INTERVAL = 3    # checkpoint cadence
KILL = 10       # the global batch at which the killed run raises
PKGS = {"port": (tdata, Table), "jax": (jdata, JaxTable)}
_TRUE = np.arange(1.0, DIM + 1.0)
F64_TOL = 1e-12


def _batch_maker(table_cls):
    def lr_batch(i, rng):
        x = rng.normal(size=(48, DIM))
        return table_cls({"features": x,
                          "label": (x @ _TRUE > 0).astype(np.float64),
                          "i": np.full(48, float(i))})
    return lr_batch


def lr_feed(pkg, world, shuffled=False):
    mod, table_cls = PKGS[pkg]
    make = _batch_maker(table_cls)
    feed = mod.ElasticFeed(
        lambda shard: mod.Dataset.synthetic(make, B, seed=7, shard=shard),
        world,
    )
    return feed.shuffle(4, seed=13) if shuffled else feed


def _order(feed_or_it):
    return [float(np.asarray(b.column("i"))[0]) for b in feed_or_it]


@pytest.mark.parametrize("shuffled", [False, True])
def test_global_order_is_world_independent_and_jax_equal(shuffled, on_cpu):
    golden = _order(lr_feed("jax", 1, shuffled))
    assert sorted(golden) == [float(i) for i in range(B)]
    assert (golden != sorted(golden)) == shuffled
    for world in (1, 2, 3, 4, 8):
        port = list(lr_feed("port", world, shuffled))
        assert _order(port) == golden
        jax = list(lr_feed("jax", world, shuffled))
        for p, j in zip(port, jax):
            np.testing.assert_array_equal(p.column("features"),
                                          j.column("features"))


@pytest.mark.parametrize("cut", [1, 6, 13, B])
def test_cursor_resplits_mid_stream(cut, on_cpu):
    """A cursor cut at world 4 resumes the exact tail at worlds 2, 3 and 8
    (shuffle order included), equal to the JAX feed's cursor and tail."""
    golden = _order(lr_feed("port", 1, shuffled=True))
    it = lr_feed("port", 4, shuffled=True).iterate()
    jit_ = lr_feed("jax", 4, shuffled=True).iterate()
    head = _order(next(it) for _ in range(cut))
    for _ in range(cut):
        next(jit_)
    cursor = it.cursor()
    assert cursor.to_json_dict() == jit_.cursor().to_json_dict()
    it.close()
    jit_.close()
    assert (cursor.emitted, cursor.num_shards, cursor.shard_index) == \
        (cut, 4, None)
    for world in (2, 3, 8):
        tail = _order(lr_feed("port", world, shuffled=True).iterate(cursor))
        assert head + tail == golden
        jtail = _order(lr_feed("jax", world, shuffled=True).iterate(
            jdata.Cursor.from_json_dict(cursor.to_json_dict())))
        assert jtail == tail


def test_feed_validates_its_shard_factory(on_cpu):
    make = _batch_maker(Table)
    with pytest.raises(ValueError, match="honor its shard argument"):
        next(iter(tdata.ElasticFeed(
            lambda shard: tdata.Dataset.synthetic(make, B, shard=(0, 1)), 4)))
    with pytest.raises(TypeError, match="Dataset"):
        next(iter(tdata.ElasticFeed(lambda shard: [], 2)))


# -- the online trainer: kill at world 4, resume at worlds 2 and 8 -------------------


def _lr(cls=fml.OnlineLogisticRegression):
    return cls().set_alpha(0.5).set_reg(0.01)


def _crash_at(global_batch):
    """A post-merge map that raises when the feed delivers
    ``global_batch`` (read from the batch's ``i`` column)."""
    order = _order(lr_feed("port", 1, shuffled=True))

    def crash(t):
        if float(np.asarray(t.column("i"))[0]) == order[global_batch]:
            raise RuntimeError(f"injected crash at batch {global_batch}")
        return t

    return crash


def _kill_at_world4(directory):
    mgr = CheckpointManager(str(directory), max_to_keep=20)
    feed = lr_feed("port", 4, shuffled=True).map(_crash_at(KILL))
    with pytest.raises(RuntimeError, match="injected crash"):
        _lr().fit_stream(feed, checkpoint_manager=mgr,
                         checkpoint_interval=INTERVAL)
    last = KILL // INTERVAL * INTERVAL
    assert mgr.latest_epoch() == last
    cursor = mgr.read_extra(last)["data_cursor"]
    assert (cursor["emitted"], cursor["num_shards"], cursor["shard_index"]) \
        == (last, 4, None)
    return last


@pytest.mark.parametrize("world", [2, 8])
def test_kill_world4_resume_bit_exact(world, tmp_path, on_cpu):
    golden = _lr().fit_stream(lr_feed("port", 1, shuffled=True))
    assert golden.model_version == B
    _kill_at_world4(tmp_path / "ckpt")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=20,
                            rescale="allow")
    resumed = _lr().fit_stream(lr_feed("port", world, shuffled=True),
                               checkpoint_manager=mgr,
                               checkpoint_interval=INTERVAL, resume=True)
    assert resumed.model_version == B
    np.testing.assert_array_equal(resumed.coefficient, golden.coefficient)
    # The terminal snapshot records the resumed world.
    assert mgr.read_extra(B)["data_cursor"]["num_shards"] == world

    jax = _lr(JaxOnlineLR).fit_stream(lr_feed("jax", 1, shuffled=True))
    assert jax.model_version == B
    np.testing.assert_allclose(resumed.coefficient, jax.coefficient,
                               rtol=F64_TOL, atol=F64_TOL)


def test_resume_at_another_world_needs_rescale_allow(tmp_path, on_cpu):
    """The default manager rejects a snapshot of another world; the same
    world resumes without ``rescale``, bit for bit; a prefetched feed
    gives the same bits."""
    golden = _lr().fit_stream(lr_feed("port", 1, shuffled=True))
    _kill_at_world4(tmp_path / "a")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    with pytest.raises(RescaleError):
        _lr().fit_stream(lr_feed("port", 2, shuffled=True),
                         checkpoint_manager=CheckpointManager(
                             str(tmp_path / "a")), resume=True)
    same = _lr().fit_stream(lr_feed("port", 4, shuffled=True),
                            checkpoint_manager=CheckpointManager(
                                str(tmp_path / "b")), resume=True)
    np.testing.assert_array_equal(same.coefficient, golden.coefficient)
    prefetched = _lr().fit_stream(
        lr_feed("port", 3, shuffled=True).prefetch(2))
    np.testing.assert_array_equal(prefetched.coefficient, golden.coefficient)


def test_array_shards_cannot_reshard_a_fit(tmp_path, on_cpu):
    """An ElasticFeed over contiguous-block ArraySource shards resumes only
    at its own world: at another the cursor is refused, as in JAX."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(240, DIM))
    cols = {"features": x, "label": (x @ _TRUE > 0).astype(np.float64)}

    def feed(world):
        return tdata.ElasticFeed(
            lambda shard: tdata.Dataset.from_arrays(Table(cols), 20,
                                                    shard=shard), world)

    mgr = CheckpointManager(str(tmp_path), max_to_keep=20, rescale="allow")
    _lr().fit_stream(feed(4), checkpoint_manager=mgr, checkpoint_interval=4)
    mgr.discard(mgr.latest_epoch())  # resume mid-stream, not at the end
    with pytest.raises(tdata.CursorShardMismatchError):
        _lr().fit_stream(feed(2), checkpoint_manager=mgr, resume=True)
