"""The port's ALS (``flinkml_tpu_torch.models.als``) against the JAX
package's, on the CPU.

The cases of ``tests/test_als.py`` and the ALS cases of ``tests/
test_stream_fit_recsys.py``, each run in both packages from the same
numpy data and held to the JAX package's tolerance between its two
reductions (rtol 5e-4, atol 5e-5 on the factors): float32 normal
equations summed in another order and solved by another Cholesky
(``torch.linalg`` here, ``jax.scipy.linalg`` there) agree to rounding,
not to the bit. The port's ``layout`` keyword stands for the JAX
package's ``FLINKML_TPU_ALS_REDUCTION`` (monkeypatched on the JAX side).
On the CPU the plain ``segment_sum`` adds in cell order, so a fit repeats
bit for bit under either layout, and the streamed fit's spill and resume
equal the uninterrupted in-RAM replay bit for bit.

Several ranks: P = 2 and 4 gloo ranks (``tests/_torch_mesh_worker.py
als``, the rank body ``tests/_torch_recsys_cases.py::als_cases``) fit in
RAM on a mesh (every rank passes the same table) and stream their own
partitions; every rank ends with the same bits, within the tolerance of
the JAX fit on a P-device mesh, and the resumed streamed fit equals the
uninterrupted one bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from flinkml_tpu.models.als import ALS as JALS
from flinkml_tpu.models.als import ALSModel as JALSModel
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.io.read_write import load_stage, stage_from_arrays
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.iteration.datacache import cache_stream
from flinkml_tpu_torch.models.als import ALS, ALSModel, als_run_tables
from flinkml_tpu_torch.table import Table
from tests import _torch_recsys_cases as cases
from tests.test_torch_tensor_parallel import launch, same_on_every_rank

TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _low_rank_ratings(n_users=40, n_items=30, rank=4, frac=0.6, seed=0,
                      noise=0.0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_users, rank)) / np.sqrt(rank)
    v = rng.normal(size=(n_items, rank)) / np.sqrt(rank)
    full = u @ v.T
    mask = rng.uniform(size=full.shape) < frac
    users, items = np.nonzero(mask)
    r = full[users, items] + noise * rng.normal(size=users.shape[0])
    return users.astype(np.int64), items.astype(np.int64), r, full


def _als(cls=ALS, rank=6, iters=12, reg=0.01, **kw):
    est = cls().set_rank(rank).set_max_iter(iters).set_reg_param(reg) \
        .set_seed(0)
    for name, v in kw.items():
        getattr(est, f"set_{name}")(v)
    return est


def _both(data: dict, **kw):
    """The port's and the JAX package's models fitted on ``data``."""
    return (_als(**kw).fit(Table(data)),
            _als(JALS, **kw).fit(JTable(data)))


def _close(port, jax_model):
    np.testing.assert_allclose(port.user_factors, jax_model.user_factors,
                               **TOL)
    np.testing.assert_allclose(port.item_factors, jax_model.item_factors,
                               **TOL)


def test_explicit_reconstructs_low_rank_matrix():
    users, items, r, full = _low_rank_ratings()
    data = {"user": users, "item": items, "rating": r}
    model, jmodel = _both(data)
    _close(model, jmodel)
    (out,) = model.transform(Table(data))
    rmse = float(np.sqrt(np.mean((out.column("prediction") - r) ** 2)))
    assert rmse < 0.05, rmse
    all_u, all_i = np.meshgrid(np.arange(full.shape[0]),
                               np.arange(full.shape[1]), indexing="ij")
    (pred_all,) = model.transform(
        Table({"user": all_u.ravel(), "item": all_i.ravel()}))
    rmse_all = float(np.sqrt(np.mean(
        (pred_all.column("prediction") - full.ravel()) ** 2)))
    assert rmse_all < 0.15, rmse_all


def test_regularization_shrinks_factors():
    users, items, r, _ = _low_rank_ratings(seed=1)
    data = {"user": users, "item": items, "rating": r}
    small, jsmall = _both(data, reg=0.001)
    large, jlarge = _both(data, reg=10.0)
    _close(large, jlarge)
    assert (np.linalg.norm(large.user_factors)
            < 0.2 * np.linalg.norm(small.user_factors))


def test_cold_start_nan_and_unseen_ids():
    users, items, r, _ = _low_rank_ratings(seed=2)
    model = _als(iters=3).fit(Table({"user": users, "item": items,
                                     "rating": r}))
    probe = Table({"user": np.asarray([0, 9999]), "item": np.asarray([0, 0])})
    (out,) = model.transform(probe)
    assert np.isfinite(out.column("prediction")[0])
    assert np.isnan(out.column("prediction")[1])


def test_string_ids_work():
    data = {"user": np.asarray(["alice", "bob", "alice", "carol", "bob",
                                "carol"]),
            "item": np.asarray(["x", "x", "y", "y", "z", "z"]),
            "rating": np.asarray([5.0, 4.0, 1.0, 2.0, 3.0, 5.0])}
    model, jmodel = _both(data, rank=2, iters=8, reg=0.1)
    _close(model, jmodel)
    (out,) = model.transform(Table(data))
    assert np.all(np.isfinite(out.column("prediction")))
    (pa,) = model.transform(Table({"user": np.asarray(["alice", "alice"]),
                                   "item": np.asarray(["x", "y"])}))
    assert pa.column("prediction")[0] > pa.column("prediction")[1]


def test_implicit_ranks_interacted_items_higher():
    rng = np.random.default_rng(3)
    users, items, counts = [], [], []
    for u in range(20):
        liked = [i for i in range(15) if i % 2 == u % 2]
        for i in rng.choice(liked, size=5):
            users.append(u)
            items.append(i)
            counts.append(float(rng.integers(1, 10)))
    data = {"user": np.asarray(users), "item": np.asarray(items),
            "rating": np.asarray(counts)}
    model, jmodel = _both(data, rank=4, iters=10, reg=0.1,
                          implicit_prefs=True, alpha=10.0)
    _close(model, jmodel)
    ids, scores = model.recommend_for_all_users(5)
    assert (ids[0] % 2 == 0).mean() >= 0.8
    assert np.all(np.diff(scores[0]) <= 1e-6)
    jids, jscores = jmodel.recommend_for_all_users(5)
    np.testing.assert_allclose(scores, jscores, **TOL)


def test_recommend_for_all_users_follows_lax_top_k():
    """The same factors rank in ``lax.top_k``'s order (ties toward the
    lower index) through the port's ``topk`` plain version."""
    users, items, r, _ = _low_rank_ratings(seed=8)
    model = _als(iters=3).fit(Table({"user": users, "item": items,
                                     "rating": r}))
    jmodel = JALSModel()
    jmodel.copy_params_from(model)
    jmodel.set_model_data(*[JTable({k: t.column(k) for k in ("id",
                                                             "factors")})
                            for t in model.get_model_data()])
    ids, scores = model.recommend_for_all_users(7)
    jids, jscores = jmodel.recommend_for_all_users(7)
    assert np.array_equal(ids, jids)
    assert scores.tobytes() == np.asarray(jscores).tobytes()
    many, _ = model.recommend_for_all_users(1000)
    assert many.shape == (40, 30)


def test_implicit_rejects_negative_ratings():
    t = Table({"user": np.asarray([0]), "item": np.asarray([0]),
               "rating": np.asarray([-1.0])})
    with pytest.raises(ValueError, match="non-negative"):
        _als(implicit_prefs=True).fit(t)


def test_save_load_and_model_data_roundtrip_across_packages(tmp_path):
    users, items, r, _ = _low_rank_ratings(seed=4)
    t = Table({"user": users, "item": items, "rating": r})
    model = _als(iters=4).fit(t)
    model.save(str(tmp_path / "als"))
    loaded = ALSModel.load(str(tmp_path / "als"))
    np.testing.assert_array_equal(loaded.user_factors, model.user_factors)
    (p1,) = model.transform(t)
    (p2,) = loaded.transform(t)
    np.testing.assert_array_equal(p2.column("prediction"),
                                  p1.column("prediction"))
    clone = ALSModel()
    clone.copy_params_from(model)
    clone.set_model_data(*model.get_model_data())
    (p3,) = clone.transform(t)
    np.testing.assert_array_equal(p3.column("prediction"),
                                  p1.column("prediction"))
    # The JAX package reads the port's save, and the port the JAX one's.
    jloaded = JALSModel.load(str(tmp_path / "als"))
    np.testing.assert_array_equal(jloaded.item_factors, model.item_factors)
    jmodel = _als(JALS, iters=4).fit(JTable({"user": users, "item": items,
                                             "rating": r}))
    jmodel.save(str(tmp_path / "jax"))
    ported = load_stage(str(tmp_path / "jax"))
    assert isinstance(ported, ALSModel)
    (pj,) = jmodel.transform(JTable({"user": users, "item": items}))
    (pp,) = ported.transform(Table({"user": users, "item": items}))
    np.testing.assert_array_equal(pp.column("prediction"),
                                  np.asarray(pj.column("prediction")))
    arrays = {"userIds": jmodel._user_ids, "userFactors": jmodel.user_factors,
              "itemIds": jmodel._item_ids, "itemFactors": jmodel.item_factors}
    built = stage_from_arrays("flinkml_tpu.models.als.ALSModel",
                              jmodel.get_param_map_json(), arrays)
    assert built.get_rank() == 6
    np.testing.assert_array_equal(built.user_factors, jmodel.user_factors)


def test_chunked_path_matches_single_chunk():
    users, items, r, _ = _low_rank_ratings(seed=5)
    t = Table({"user": users, "item": items, "rating": r})
    big = _als(iters=3).fit(t)
    for layout in ("segment", "cumsum"):
        est = _als(iters=3)
        est.layout = layout
        est.CHUNK = 64  # force many chunks
        np.testing.assert_allclose(est.fit(t).user_factors,
                                   big.user_factors, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("layout", ["segment", "cumsum"])
def test_deterministic_given_seed(layout):
    users, items, r, _ = _low_rank_ratings(seed=6)
    t = Table({"user": users, "item": items, "rating": r})

    def fit():
        est = _als(iters=3)
        est.layout = layout
        return est.fit(t)

    np.testing.assert_array_equal(fit().user_factors, fit().user_factors)


def test_reg_zero_underdetermined_user_stays_finite():
    data = {"user": np.asarray([0, 0, 1, 1, 1, 1, 1, 1, 1, 1]),
            "item": np.asarray([0, 1, 0, 1, 2, 3, 4, 5, 6, 7]),
            "rating": np.linspace(1, 5, 10)}
    model, jmodel = _both(data, rank=6, iters=4, reg=0.0)
    assert np.isfinite(model.user_factors).all()
    assert np.isfinite(model.item_factors).all()
    (out,) = model.transform(Table(data))
    assert np.isfinite(out.column("prediction")).all()


@pytest.mark.parametrize("implicit", [False, True])
def test_cumsum_reduction_matches_segment_and_jax(monkeypatch, implicit):
    u, i, r = cases.als_ratings()
    data = {"user": u.astype(np.int32), "item": i.astype(np.int32),
            "rating": r}
    fits = {}
    for layout in ("segment", "cumsum"):
        est = ALS(layout=layout).set_rank(6).set_max_iter(4).set_seed(0) \
            .set_implicit_prefs(implicit)
        fits[layout] = est.fit(Table(data))
        monkeypatch.setenv("FLINKML_TPU_ALS_REDUCTION", layout)
        jest = JALS().set_rank(6).set_max_iter(4).set_seed(0) \
            .set_implicit_prefs(implicit)
        _close(fits[layout], jest.fit(JTable(data)))
    np.testing.assert_allclose(fits["cumsum"].user_factors,
                               fits["segment"].user_factors, **TOL)
    np.testing.assert_allclose(fits["cumsum"].item_factors,
                               fits["segment"].item_factors, **TOL)


def test_cumsum_reduction_empty_and_tiny_tables():
    from flinkml_tpu.models.als import als_run_tables as jax_tables

    empty_e, empty_c = als_run_tables(np.zeros(0, np.int32), 2, 8)
    assert empty_e.shape[0] == 0 and empty_c.shape[0] == 0
    seg = np.sort(np.random.default_rng(0).integers(0, 9, 64)).astype(
        np.int32)
    for got, want in zip(als_run_tables(seg, 2, 16), jax_tables(seg, 2, 16)):
        assert got.tobytes() == want.tobytes()
    t = Table({"user": np.asarray([3], np.int32),
               "item": np.asarray([1], np.int32),
               "rating": np.asarray([4.0], np.float32)})
    m_cum = ALS(layout="cumsum").set_rank(3).set_max_iter(2).set_seed(0).fit(t)
    m_seg = ALS(layout="segment").set_rank(3).set_max_iter(2).set_seed(0).fit(t)
    np.testing.assert_allclose(m_cum.user_factors, m_seg.user_factors,
                               rtol=1e-5)


def test_layout_keyword_and_sharding_refusal():
    with pytest.raises(ValueError, match="layout='sorted'"):
        ALS(layout="sorted")
    from flinkml_tpu_torch.sharding import EMBEDDING

    with pytest.raises(ValueError, match="normal-equation buffers"):
        ALS(sharding_plan=EMBEDDING).fit(Table({
            "user": np.zeros(2), "item": np.zeros(2), "rating": np.ones(2)}))


# -- the streamed fit -----------------------------------------------------------------


def _stream_als(**kw):
    return cases.als_estimator(**kw)


def _jax_stream_als(**kw):
    return JALS(**kw).set_rank(4).set_max_iter(5).set_reg_param(0.05) \
        .set_seed(0)


def test_als_stream_spilled_matches_in_ram_exactly(tmp_path):
    from flinkml_tpu.iteration.datacache import cache_stream as jcache

    batches = cases.rating_batches()
    ram = _stream_als().fit(cache_stream(iter(batches)))
    spilled = _stream_als().fit(cache_stream(
        iter(batches), directory=str(tmp_path / "spill"),
        memory_budget_bytes=1))
    np.testing.assert_array_equal(spilled.user_factors, ram.user_factors)
    np.testing.assert_array_equal(spilled.item_factors, ram.item_factors)
    assert any((tmp_path / "spill").glob("segment-*.bin"))
    jmesh = JMesh({"data": 1}, jax.devices()[:1])
    _close(ram, _jax_stream_als(mesh=jmesh).fit(jcache(iter(batches))))


def test_als_stream_learns_and_tables_path(tmp_path):
    batches = cases.rating_batches(n_batches=6)
    model = _stream_als(
        cache_dir=str(tmp_path / "als"), cache_memory_budget_bytes=1
    ).set_max_iter(10).fit(iter([Table(b) for b in batches]))
    big = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    (out,) = model.transform(Table({"user": big["user"], "item": big["item"]}))
    rmse = float(np.sqrt(np.mean((out.column("prediction")
                                  - big["rating"]) ** 2)))
    assert rmse < 0.25, rmse


def test_als_stream_resume_exact(tmp_path):
    from flinkml_tpu_torch.iteration import CheckpointManager as Manager

    class Crash(Manager):
        fired = False

        def save(self, state, epoch, extra=None, **kw):
            p = super().save(state, epoch, extra, **kw)
            if not Crash.fired and epoch >= 2:
                Crash.fired = True
                raise RuntimeError("injected crash")
            return p

    cache = cache_stream(iter(cases.rating_batches()))
    golden = _stream_als().set_max_iter(6).fit(cache)
    mgr = Crash(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="injected"):
        _stream_als(checkpoint_manager=mgr,
                    checkpoint_interval=2).set_max_iter(6).fit(cache)
    assert mgr.latest_epoch() == 2
    rec = _stream_als(checkpoint_manager=mgr, checkpoint_interval=2,
                      resume=True).set_max_iter(6).fit(cache)
    np.testing.assert_array_equal(rec.user_factors, golden.user_factors)
    np.testing.assert_array_equal(rec.item_factors, golden.item_factors)


def test_als_in_ram_rejects_checkpoint_knobs(tmp_path):
    b = cases.rating_batches(n_batches=1)[0]
    with pytest.raises(ValueError, match="streamed fits only"):
        _stream_als(checkpoint_manager=CheckpointManager(
            str(tmp_path))).fit(Table(b))
    with pytest.raises(ValueError, match="durable DataCache"):
        _stream_als(resume=True).fit(iter([Table(b)]))


# -- several ranks --------------------------------------------------------------------


@pytest.fixture(scope="module", params=(2, 4), ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, launch("als", world,
                         str(tmp_path_factory.mktemp(f"als{world}")))


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("layout", ["segment", "cumsum"])
def test_in_ram_fit_on_a_mesh(ranks, monkeypatch, layout, implicit):
    p, outs = ranks
    u, i, r = cases.als_ratings()
    monkeypatch.setenv("FLINKML_TPU_ALS_REDUCTION", layout)
    jm = JALS(mesh=JMesh({"data": p}, jax.devices()[:p])).set_rank(6) \
        .set_max_iter(4).set_seed(0).set_implicit_prefs(implicit) \
        .fit(JTable({"user": u, "item": i, "rating": r}))
    for side, want in (("user", jm.user_factors), ("item", jm.item_factors)):
        got = same_on_every_rank(outs, f"inram_{layout}_{implicit}_{side}")
        np.testing.assert_allclose(got, want, **TOL)


def test_streamed_fit_on_several_ranks(ranks):
    """Each rank streams its own batches; the factors equal the in-RAM
    fit over every rank's ratings within tolerance, the spilled cache
    adds nothing, and the resumed fit equals the uninterrupted one."""
    p, outs = ranks
    golden_u = same_on_every_rank(outs, "stream_user")
    golden_i = same_on_every_rank(outs, "stream_item")
    batches = cases.rating_batches(n_batches=2 * p)
    big = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    jm = _jax_stream_als().set_max_iter(6).fit(JTable(big))
    np.testing.assert_allclose(golden_u, jm.user_factors, **TOL)
    np.testing.assert_allclose(golden_i, jm.item_factors, **TOL)
    assert same_on_every_rank(outs, "spill_user").tobytes() == \
        golden_u.tobytes()
    assert same_on_every_rank(outs, "resume_user").tobytes() == \
        golden_u.tobytes()
    assert same_on_every_rank(outs, "resume_item").tobytes() == \
        golden_i.tobytes()
