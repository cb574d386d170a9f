"""The port's data cache, replay and prefetching feed
(``flinkml_tpu_torch.iteration.datacache``) and the one-process
``stream_sync`` helpers, against the JAX package's, on the CPU: every case
of ``tests/test_datacache.py``, segments byte-identical to the JAX
package's, and caches and snapshots written by either package replayed by
the other. Tolerance: exact (the batches are bytes on disk).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.iteration import datacache as j_dc
from flinkml_tpu.iteration import stream_sync as j_sync
from flinkml_tpu_torch.iteration import stream_sync as t_sync
from flinkml_tpu_torch.iteration.datacache import (
    DataCacheSnapshot,
    DataCacheWriter,
    PrefetchingDeviceFeed,
    _read_segment,
    _write_segment,
    cache_stream,
    device_put,
    replay,
)


def _batches(n_batches=4, rows=8, dim=3, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {
            "features": rng.normal(size=(rows, dim)).astype(np.float32),
            "label": rng.integers(0, 2, size=rows).astype(np.float32),
        }
        for _ in range(n_batches)
    ]


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype


def test_write_read_in_memory():
    batches = _batches()
    w = DataCacheWriter()
    for b in batches:
        w.append(b)
    cache = w.finish()
    assert cache.num_rows == 32 and cache.num_batches == 4
    _assert_batches_equal(batches, list(cache.reader()))
    _assert_batches_equal(batches, list(cache.reader()))


def test_spill_to_disk_beyond_budget(tmp_path):
    batches = _batches(n_batches=6)
    one = sum(a.nbytes for a in batches[0].values())
    w = DataCacheWriter(str(tmp_path), memory_budget_bytes=2 * one)
    jw = j_dc.DataCacheWriter(str(tmp_path / "jax"), memory_budget_bytes=2 * one)
    for b in batches:
        w.append(b)
        jw.append(dict(b))
    cache, jcache = w.finish(), jw.finish()
    assert len(cache.mem_batches) == len(jcache.mem_batches) == 2
    assert len(cache.segments) == len(jcache.segments) == 4
    assert all(s.path.startswith(str(tmp_path)) for s in cache.segments)
    _assert_batches_equal(batches, list(cache.reader()))
    for s, js in zip(cache.segments, jcache.segments):
        assert (s.num_rows, s.nbytes) == (js.num_rows, js.nbytes)


def test_reader_position_resume(tmp_path):
    batches = _batches(n_batches=5)
    cache = cache_stream(iter(batches), str(tmp_path), memory_budget_bytes=1)
    reader = cache.reader()
    next(reader), next(reader)
    assert reader.position == 2
    _assert_batches_equal(batches[2:], list(cache.reader(reader.position)))


def test_append_after_finish_raises():
    w = DataCacheWriter()
    w.finish()
    with pytest.raises(RuntimeError):
        w.append(_batches(1)[0])


def test_ragged_columns_rejected():
    with pytest.raises(ValueError, match="rows"):
        DataCacheWriter().append({"a": np.zeros(3), "b": np.zeros(4)})


def test_budget_without_directory_rejected():
    with pytest.raises(ValueError, match="spill directory"):
        DataCacheWriter(memory_budget_bytes=10)


def test_mem_batches_are_frozen_against_mutation():
    batches = _batches(1)
    original = np.array(batches[0]["features"], copy=True)
    cache = cache_stream(iter(batches))
    out = next(cache.reader())
    with pytest.raises(ValueError):
        out["features"][0, 0] = 99.0
    out["features"] = np.zeros_like(np.asarray(out["features"]))
    np.testing.assert_array_equal(next(cache.reader())["features"], original)


def test_spilled_batches_leave_caller_buffer_reusable(tmp_path):
    writer = DataCacheWriter(directory=str(tmp_path), memory_budget_bytes=0)
    buf = np.arange(12, dtype=np.float64).reshape(3, 4)
    writer.append({"features": buf})
    buf[:] = -1.0
    cache = writer.finish()
    np.testing.assert_array_equal(next(cache.reader())["features"],
                                  np.arange(12, dtype=np.float64).reshape(3, 4))


def test_feed_close_while_worker_blocked_exits(on_cpu_feed):
    feed = PrefetchingDeviceFeed(iter(_batches(8)), depth=1)
    next(feed)
    feed.close()
    feed._thread.join(timeout=5)
    assert not feed._thread.is_alive()
    with pytest.raises(StopIteration):
        next(feed)


def test_object_dtype_rejected_on_spill(tmp_path):
    w = DataCacheWriter(str(tmp_path), memory_budget_bytes=0)
    obj = np.empty(2, dtype=object)
    obj[0], obj[1] = [1], [2, 3]
    with pytest.raises(TypeError):
        w.append({"a": obj})


def test_snapshot_persist_recover(tmp_path):
    batches = _batches(n_batches=4)
    one = sum(a.nbytes for a in batches[0].values())
    w = DataCacheWriter(str(tmp_path / "spill"), memory_budget_bytes=2 * one)
    for b in batches:
        w.append(b)
    cache = w.finish()
    DataCacheSnapshot.persist(cache, str(tmp_path / "snap"))
    recovered = DataCacheSnapshot.recover(str(tmp_path / "snap"))
    assert recovered.num_rows == cache.num_rows
    _assert_batches_equal(batches, list(recovered.reader()))


def test_replay_epochs():
    batches = _batches(n_batches=3)
    cache = cache_stream(iter(batches))
    seen = list(replay(cache, num_epochs=2))
    jseen = list(j_dc.replay(j_dc.cache_stream(iter(batches)), num_epochs=2))
    assert [e for e, _ in seen] == [e for e, _ in jseen] == [0, 0, 0, 1, 1, 1]
    _assert_batches_equal(batches, [b for e, b in seen if e == 1])


@pytest.fixture
def on_cpu_feed():
    with fml.use_device("cpu"):
        yield


def test_prefetching_device_feed_matches(on_cpu_feed):
    batches = _batches(n_batches=5)
    out = list(PrefetchingDeviceFeed(iter(batches), depth=2))
    assert len(out) == 5
    for host, dev in zip(batches, out):
        assert isinstance(dev["features"], torch.Tensor)
        assert dev["features"].device.type == "cpu"
        np.testing.assert_array_equal(host["features"],
                                      dev["features"].numpy())


def test_device_put_places_every_array(on_cpu_feed):
    frozen = np.arange(4.0)
    frozen.flags.writeable = False
    tree = {"a": (frozen, np.int32(3)), "b": [np.ones((2, 2))], "c": "keep"}
    got = device_put(tree)
    assert isinstance(got["a"][0], torch.Tensor) and got["c"] == "keep"
    np.testing.assert_array_equal(got["a"][0].numpy(), frozen)
    assert got["b"][0].dtype == torch.float64


def test_spill_preserves_append_order(tmp_path):
    small1 = {"a": np.full((2, 2), 1.0, dtype=np.float32)}
    big = {"a": np.full((64, 64), 2.0, dtype=np.float32)}
    small2 = {"a": np.full((2, 2), 3.0, dtype=np.float32)}
    budget = small1["a"].nbytes + small2["a"].nbytes + 1
    w = DataCacheWriter(str(tmp_path), memory_budget_bytes=budget)
    for b in (small1, big, small2):
        w.append(b)
    cache = w.finish()
    assert len(cache.segments) == 1 and len(cache.mem_batches) == 2
    assert [b["a"].flat[0] for b in cache.reader()] == [1.0, 2.0, 3.0]


def test_snapshot_preserves_mixed_order(tmp_path):
    small1 = {"a": np.full((2,), 1.0, dtype=np.float32)}
    big = {"a": np.full((1024,), 2.0, dtype=np.float32)}
    small2 = {"a": np.full((2,), 3.0, dtype=np.float32)}
    w = DataCacheWriter(str(tmp_path / "spill"), memory_budget_bytes=64)
    for b in (small1, big, small2):
        w.append(b)
    DataCacheSnapshot.persist(w.finish(), str(tmp_path / "snap"))
    rec = DataCacheSnapshot.recover(str(tmp_path / "snap"))
    assert [b["a"].flat[0] for b in rec.reader()] == [1.0, 2.0, 3.0]


def test_object_dtype_rejected_in_memory_too():
    obj = np.empty(2, dtype=object)
    obj[0], obj[1] = [1], [2, 3]
    with pytest.raises(TypeError):
        DataCacheWriter().append({"a": obj})


def test_replay_empty_cache_terminates():
    assert list(replay(cache_stream(iter([])), num_epochs=None)) == []


def test_feed_next_after_exhaustion_raises_stopiteration(on_cpu_feed):
    feed = PrefetchingDeviceFeed(iter(_batches(2)), depth=1)
    list(feed)
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(feed)


def test_prefetching_device_feed_propagates_errors(on_cpu_feed):
    def gen():
        yield {"a": np.zeros(2)}
        raise ValueError("boom")

    feed = PrefetchingDeviceFeed(gen(), depth=1)
    next(feed)
    with pytest.raises(ValueError, match="boom"):
        next(feed)
    with pytest.raises(ValueError, match="boom"):
        next(feed)


def test_feed_counts_its_wait(on_cpu_feed):
    """``wait_s`` is the host time ``next()`` spent waiting for the worker:
    a slow producer makes the consumer wait."""
    import time

    def slow():
        for b in _batches(3):
            time.sleep(0.05)
            yield b

    feed = PrefetchingDeviceFeed(slow(), depth=1)
    assert len(list(feed)) == 3
    assert feed.wait_s >= 0.1


def test_concurrent_readers_are_independent(tmp_path):
    writer = DataCacheWriter(str(tmp_path / "c"), memory_budget_bytes=1)
    for i in range(8):
        writer.append({"x": np.full((16, 3), float(i), np.float32)})
    cache = writer.finish()
    seen, errs = [[], []], []

    def consume(slot):
        try:
            for batch in cache.reader():
                seen[slot].append(float(batch["x"][0, 0]))
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=consume, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errs, errs
    assert seen[0] == seen[1] == [float(i) for i in range(8)]


def test_concurrent_streamed_fits_from_one_cache(tmp_path):
    """Two streamed linear fits replaying one sealed spilled cache from
    separate threads give exactly the sequential result."""
    from flinkml_tpu_torch.models._linear_sgd import train_linear_model_stream

    rng = np.random.default_rng(0)
    true = rng.normal(size=4)
    writer = DataCacheWriter(str(tmp_path / "c"), memory_budget_bytes=1)
    for _ in range(4):
        x = rng.normal(size=(48, 4)).astype(np.float32)
        writer.append({"x": x, "y": (x @ true > 0).astype(np.float32)})
    cache = writer.finish()
    args = dict(loss="logistic", max_iter=5, learning_rate=0.5, reg=0.01,
                elastic_net=0.0, tol=0.0)
    with fml.use_device("cpu"):
        golden = train_linear_model_stream(cache, **args)
    results, errs = [None, None], []

    def fit(slot):
        try:
            with fml.use_device("cpu"):
                results[slot] = train_linear_model_stream(cache, **args)
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=fit, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    np.testing.assert_array_equal(results[0], golden)
    np.testing.assert_array_equal(results[1], golden)


# -- across packages ---------------------------------------------------------------


def _mixed_batch(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(7, 3)).astype(np.float32),
        "y": rng.normal(size=7),
        "ids": rng.integers(0, 9, size=(7, 2)).astype(np.int32),
        "flag": rng.random(7) > 0.5,
        "dim": np.full((7, 1), 1_000_000, np.int64),
    }


def test_segments_are_byte_identical(tmp_path):
    batch = _mixed_batch()
    seg = _write_segment(str(tmp_path / "port.bin"), batch)
    jseg = j_dc._write_segment(str(tmp_path / "jax.bin"), batch)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    assert (seg.num_rows, seg.nbytes) == (jseg.num_rows, jseg.nbytes)
    _assert_batches_equal([_read_segment(jseg.path)],
                          [j_dc._read_segment(seg.path)])


def test_snapshots_replay_across_packages(tmp_path):
    """A JAX ``DataCacheSnapshot`` (spilled and in-RAM batches) replays in
    the port and the port's in the JAX package, in order."""
    batches = _batches(n_batches=5) + [_mixed_batch()]
    one = sum(a.nbytes for a in batches[0].values())
    jw = j_dc.DataCacheWriter(str(tmp_path / "jspill"),
                              memory_budget_bytes=2 * one)
    for b in batches:
        jw.append(dict(b))
    j_dc.DataCacheSnapshot.persist(jw.finish(), str(tmp_path / "jsnap"))
    port = DataCacheSnapshot.recover(str(tmp_path / "jsnap"))
    _assert_batches_equal(batches, list(port.reader()))

    DataCacheSnapshot.persist(cache_stream(iter(batches), str(
        tmp_path / "pspill"), memory_budget_bytes=2 * one),
        str(tmp_path / "psnap"))
    back = j_dc.DataCacheSnapshot.recover(str(tmp_path / "psnap"))
    assert back.num_rows == port.num_rows
    _assert_batches_equal(batches, list(back.reader()))
    assert sorted(os.listdir(tmp_path / "psnap")) == \
        sorted(os.listdir(tmp_path / "jsnap"))


# -- the one-process stream_sync helpers ---------------------------------------------


def test_deferred_validation_and_guarded_iter_match_jax():
    def source():
        yield 1
        yield 2
        raise IOError("shard unreadable")

    def check(v):
        if v == 2:
            raise ValueError("bad batch 2")
        return v * 10

    for mod in (t_sync, j_sync):
        dv = mod.DeferredValidation()
        assert list(mod.checked_ingest(source(), dv, check, multi=True)) == [10]
        with pytest.raises(ValueError, match="bad batch 2"):
            dv.rendezvous(None, "ingest")
        dv = mod.DeferredValidation()
        assert list(mod.guarded_iter(source(), dv)) == [1, 2]
        assert isinstance(dv.err, IOError)
        with pytest.raises(ValueError, match="bad batch 2"):
            list(mod.checked_ingest(source(), mod.DeferredValidation(),
                                    check, multi=False))


def test_entry_rows_and_pad_rows_match_jax(tmp_path):
    batches = _batches(n_batches=3, rows=5)
    cache = cache_stream(iter(batches), str(tmp_path), memory_budget_bytes=100)
    jcache = j_dc.cache_stream(iter(batches), str(tmp_path / "j"),
                               memory_budget_bytes=100)
    assert [t_sync.entry_rows(e) for e in cache.entries] == \
        [j_sync.entry_rows(e) for e in jcache.entries] == [5, 5, 5]
    assert len(cache.segments) == len(jcache.segments) == 2
    a = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(t_sync.pad_rows_to(a, 8, np.float32),
                                  j_sync.pad_rows_to(a, 8, np.float32))


def test_agreed_restores_are_plain_restores(tmp_path):
    from flinkml_tpu_torch.iteration import CheckpointManager

    mgr = CheckpointManager(str(tmp_path))
    assert t_sync.agreed_restore_latest(mgr, {"w": 0}) is None
    mgr.save({"w": np.ones(2)}, 3)
    state, epoch = t_sync.agreed_restore(mgr, 3, {"w": 0})
    assert epoch == 3 and state["w"].tolist() == [1.0, 1.0]
    assert t_sync.agreed_restore_latest(mgr, {"w": 0})[1] == 3
    from flinkml_tpu_torch.iteration.checkpoint import CheckpointIntegrityError

    with pytest.raises(CheckpointIntegrityError, match="unreadable"):
        t_sync.agreed_restore(mgr, 4, {"w": 0})
