"""The port's agreement layer (``flinkml_tpu_torch.iteration.stream_sync``)
against the JAX package's, on the CPU.

One process: the cases of ``tests/test_stream_sync.py``, each run through
both packages where both have the function. Several ranks (P = 2 and 4
gloo ranks, ``tests/_torch_mesh_worker.py stream_sync``, one launch per P
under its own timeout): ``agree_max``/``agree_min``, ``gather_vectors``,
``pooled_sample`` (held against the JAX package's draw,
``flinkml_tpu/iteration/stream_sync.py:670-696``, on the gathered rows),
the replay plan over uneven caches, an empty rank's plan and feature dim,
the lockstep padded stream and the first-item agreement with an empty
rank.
"""

from __future__ import annotations

import numpy as np
import pytest

from flinkml_tpu.iteration import datacache as jax_datacache
from flinkml_tpu.iteration import stream_sync as jax_ss
from flinkml_tpu.parallel import DeviceMesh as JaxMesh
from flinkml_tpu_torch.iteration import cache_stream
from flinkml_tpu_torch.iteration import stream_sync as ss
from tests.test_torch_stream_mp import launch

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def jmesh():
    return JaxMesh()


# -- one process ---------------------------------------------------------------------


def test_agree_max_single_process_identity(jmesh):
    for v in (7, 0):
        assert ss.agree_max(v) == jax_ss.agree_max(v, jmesh) == v
        assert ss.agree_min(v) == jax_ss.agree_min(v, jmesh) == v


def test_gather_vectors_single_process_identity(jmesh):
    v = np.asarray([1.5, -2.25, 1e12 + 0.125])
    got = ss.gather_vectors(v, None)
    assert got.shape == (1, 3)
    np.testing.assert_array_equal(got, jax_ss.gather_vectors(v, jmesh))
    np.testing.assert_array_equal(got[0], v)


def test_pooled_sample_single_process_identity(jmesh):
    s = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(ss.pooled_sample(s, 100, 5, 0, None), s)
    np.testing.assert_array_equal(jax_ss.pooled_sample(s, 100, 5, 0, jmesh),
                                  s)


def _plan_pair(jmesh, sizes, tile=8):
    batches = [{"x": np.zeros((n, 2), np.float32)} for n in sizes]
    cache = cache_stream(iter(batches))
    jcache = jax_datacache.cache_stream(iter(batches))
    return (cache, ss.SyncedReplayPlan.create(cache, None, tile),
            jcache, jax_ss.SyncedReplayPlan.create(jcache, jmesh, tile))


def test_plan_schedule_from_cache(jmesh):
    _, plan, _, jplan = _plan_pair(jmesh, (5, 17, 3))
    assert plan.global_steps == jplan.global_steps == 3
    # The tallest batch (17 rows) rounded up to the tile.
    assert plan.local_height == jplan.local_height == 24


def test_plan_epoch_batches_pads_with_dummies(jmesh):
    cache, plan, jcache, jplan = _plan_pair(jmesh, (4, 4))
    plan.global_steps = jplan.global_steps = 5  # as if a peer had 5
    got = list(plan.epoch_batches(cache.reader(), lambda: {"_dummy": True}))
    want = list(jplan.epoch_batches(jcache.reader(),
                                    lambda: {"_dummy": True}))
    assert ["_dummy" in b for b in got] == ["_dummy" in b for b in want] == \
        [False, False, True, True, True]


def test_plan_rejects_unsealed_overrun(jmesh):
    cache, plan, _, _ = _plan_pair(jmesh, (4, 4, 4))
    plan.global_steps = 2  # an impossible agreement for this cache
    with pytest.raises(RuntimeError, match="more batches than the agreed"):
        list(plan.epoch_batches(cache.reader(), lambda: {"_dummy": True}))


def test_plan_empty_cache_raises(jmesh):
    with pytest.raises(ValueError, match="empty on every process"):
        ss.SyncedReplayPlan.create(cache_stream(iter([])), None, 8)
    with pytest.raises(ValueError, match="empty on every process"):
        jax_ss.SyncedReplayPlan.create(
            jax_datacache.cache_stream(iter([])), jmesh, 8)


def test_deferred_validation_call_skips_after_held_error():
    dv = ss.DeferredValidation()
    assert dv.call(lambda v: v * 2, 21) == 42
    boom = ValueError("bad batch")

    def failing(_):
        raise boom

    assert dv.call(failing, 1) is None and dv.err is boom
    calls = []
    assert dv.call(lambda v: calls.append(v) or v, 2) is None
    assert calls == [] and dv.err is boom


def test_synced_stream_single_process_propagates_iterator_error(jmesh):
    def source():
        yield np.ones((2, 2), np.float32)
        raise IOError("injected")

    for it in (ss.synced_stream(source(), None),
               jax_ss.synced_stream(source(), jmesh)):
        assert next(it).shape == (2, 2)
        with pytest.raises(IOError, match="injected"):
            next(it)


def test_synced_padded_stream_pads_and_masks(jmesh):
    """The port's padded items are the JAX package's, bit for bit."""
    items = [(np.ones((5, 3), np.float32), np.arange(5, dtype=np.float32)),
             (np.ones((9, 3), np.float32), np.arange(9, dtype=np.float32))]
    got = list(ss.synced_padded_stream(iter(items), None, check=None,
                                       row_tile=8, dummy_cols=((3,), ())))
    want = list(jax_ss.synced_padded_stream(iter(items), jmesh, check=None,
                                            row_tile=8,
                                            dummy_cols=((3,), ())))
    assert [h for _, _, h in got] == [h for _, _, h in want] == [8, 16]
    for (g_arrays, g_w, _), (w_arrays, w_w, _) in zip(got, want):
        for g, w in zip(g_arrays, w_arrays):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g_w, w_w)
    assert got[0][1].tolist() == [1.0] * 5 + [0.0] * 3


def test_agree_first_item_dim_single_process(jmesh):
    for mod, mesh in ((ss, None), (jax_ss, jmesh)):
        first, rest, dim = mod.agree_first_item_dim(
            iter([np.ones((2, 5)), np.ones((3, 5))]), lambda x: None,
            lambda x: x.shape[1], mesh)
        assert dim == 5 and first.shape == (2, 5)
        assert [r.shape for r in rest] == [(3, 5)]
        with pytest.raises(ValueError, match="empty on every process"):
            mod.agree_first_item_dim(iter([]), lambda x: None,
                                     lambda x: x.shape[1], mesh)


def test_agree_feature_dim_single_process(jmesh):
    batches = [{"x": np.zeros((3, 4), np.float32)}]
    assert ss.agree_feature_dim(cache_stream(iter(batches)), "x", None) == \
        jax_ss.agree_feature_dim(jax_datacache.cache_stream(iter(batches)),
                                 "x", jmesh) == 4


# -- several ranks -------------------------------------------------------------------


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, launch("stream_sync", world,
                         str(tmp_path_factory.mktemp(f"stream_sync{world}")))


def test_ranks_agree(ranks):
    """Every replicated output is the same bits on every rank."""
    world, outs = ranks
    for name, value in outs[0].items():
        if not name.startswith("local_"):
            for r in range(1, world):
                np.testing.assert_array_equal(outs[r][name], value,
                                              err_msg=name)


def test_agree_max_min_and_gather(ranks):
    world, outs = ranks
    assert outs[0]["agree_max"].tolist() == [10 * (world - 1) + 3]
    assert outs[0]["agree_min"].tolist() == [3]
    want = np.stack([np.asarray([r + 0.125, -2.0 ** 40 * (r + 1), 1e-300])
                     for r in range(world)])
    np.testing.assert_array_equal(outs[0]["gathered"], want)


def jax_draw(samples, local_rows, cap, seed):
    """The JAX package's pooled draw on the gathered rows
    (``flinkml_tpu/iteration/stream_sync.py:670-696``): each rank's rows
    weighted ``local_rows / sample_rows``, Efraimidis–Spirakis top-k."""
    rows, weights = [], []
    for sample, n_rows in zip(samples, local_rows):
        if sample.shape[0] == 0:
            continue
        rows.append(sample)
        weights.append(np.full(sample.shape[0], float(n_rows)
                               / sample.shape[0], np.float64))
    pool = np.concatenate(rows, axis=0)
    w = np.concatenate(weights)
    take = min(cap, pool.shape[0])
    rng = np.random.default_rng(seed)
    keys = rng.random(pool.shape[0]) ** (1.0 / np.maximum(w, 1e-12))
    order = np.argsort(keys)[::-1][:take]
    return pool[order]


def test_pooled_sample_is_the_jax_draw(ranks):
    from tests._torch_mesh_worker import POOL_CAP

    world, outs = ranks
    samples = [o["local_sample"] for o in outs]
    np.testing.assert_array_equal(
        outs[0]["pooled"],
        jax_draw(samples, [100 * (r + 1) for r in range(world)], POOL_CAP,
                 11))
    # A rank with an empty sample adds nothing to the pool.
    np.testing.assert_array_equal(
        outs[0]["pooled_empty_rank"],
        jax_draw(samples[:1], [100], POOL_CAP, 11))


def test_plan_over_uneven_caches(ranks):
    """Rank r holds r + 1 batches of 5 + 4r rows: every rank steps P times
    at the tallest height, rank r with P - 1 - r dummies; a rank with an
    empty cache adopts the agreed plan and feature dim."""
    world, outs = ranks
    assert outs[0]["plan"].tolist() == [world,
                                        -(-(5 + 4 * (world - 1)) // 8) * 8]
    assert [int(o["local_plan_dummies"][0]) for o in outs] == [
        world - 1 - r for r in range(world)]
    assert outs[0]["plan_empty_rank"].tolist() == [1, 8]
    assert outs[0]["feature_dim"].tolist() == [2]


def test_synced_padded_stream_in_lockstep(ranks):
    """Rank r feeds r + 2 items of 3 + 5r rows: every rank steps P + 1
    times at the tallest height of the step (tile 8); a drained rank's
    dummies weigh 0 and hold zeros."""
    world, outs = ranks
    height = -(-(3 + 5 * (world - 1)) // 8) * 8
    assert outs[0]["padded_heights"].tolist() == [height] * (world + 1)
    for r, o in enumerate(outs):
        n = r + 2
        assert o["local_padded_valid"].tolist() == (
            [float(3 + 5 * r)] * n + [0.0] * (world + 1 - n))
        assert o["local_padded_x_sum"].tolist() == (
            [float(i * 3 * (3 + 5 * r)) for i in range(n)]
            + [0.0] * (world + 1 - n))


def test_first_item_agreement_with_an_empty_rank(ranks):
    world, outs = ranks
    assert outs[0]["first_item_dim"].tolist() == [5]
    assert [int(o["local_first_is_none"][0]) for o in outs] == [
        0] * (world - 1) + [1]
