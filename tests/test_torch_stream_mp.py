"""The port's streamed fits on several ranks against the JAX package's
one-process streamed fits, on the CPU.

Each rank feeds its own partition of the stream
(``tests/_stream_mp_common.py``: uneven batch sizes and counts, so the
agreed padded height and the dummy tail are exercised). The port runs P =
2 and 4 gloo ranks (``tests/_torch_mesh_worker.py stream_mp``, one launch
per P under its own timeout); the pytest parent computes the references:

- every rank ends with the same bits (outputs named ``local_*`` are the
  rank's own);
- the dense, CSR and KMeans fits agree with the JAX package's one-process
  fits over the combined stream (step t joins every rank's batch t:
  ``combined_batches``, ``sparse_combined_tables``) within
  ``tests/test_distributed.py``'s tolerances (rtol 2e-4 / atol 2e-5 for
  coefficients, 2e-4 / 2e-4 for centroids);
- they, the LinearSVC, LinearRegression and dense LR estimator streams
  agree with the port's own one-process fit over the combined stream
  within 1e-5 (float32: gloo and the padded step add in another order);
- FTRL (from zeros and warm-started) and OnlineKMeans (from given
  centroids) agree with the JAX package's one-process online fits over
  the combined stream within the coefficient and centroid tolerances;
  FTRL's version counts global steps, its accuracy > 0.8 as in JAX;
- snapshots in the shared directory resume at world P bit for bit, and
  at world 1 under ``rescale="reshard"``; a rank-scoped family reshards
  as the JAX package's ``reshard_rank_state`` does;
- a failure on one rank aborts every rank (``stream_faults``, P = 2),
  and a hang fails the launch's timeout, not the suite.
"""

from __future__ import annotations

import functools
import json
import os
import sys

import jax
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.iteration import checkpoint as jax_ckpt
from flinkml_tpu.models import _linear_sgd as jax_sgd
from flinkml_tpu.models import kmeans as jax_kmeans
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models.online_kmeans import OnlineKMeans as JaxOnlineKMeans
from flinkml_tpu.models.online_logistic_regression import (
    OnlineLogisticRegression as JaxOnlineLR,
)
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu.parallel import DeviceMesh as JaxMesh
from flinkml_tpu_torch.iteration import CheckpointManager, RescaleError
from flinkml_tpu_torch.iteration import cache_stream
from flinkml_tpu_torch.data import Dataset
from flinkml_tpu_torch.iteration import checkpoint as t_ckpt
from flinkml_tpu_torch.models import _linear_sgd as t_sgd
from flinkml_tpu_torch.models import kmeans as t_kmeans
from flinkml_tpu_torch.models.logistic_regression import (
    train_logistic_regression,
)
from flinkml_tpu_torch.parallel.launch import spawn_ranks
from tests import _stream_mp_common as C
from tests import _torch_mesh_worker as worker
from tests._torch_port_common import on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_worker.py")
WORLDS = (2, 4)
#: One launch of P ranks; a hang fails this launch, not the suite.
LAUNCH_TIMEOUT_S = 120
COEF_TOL = dict(rtol=2e-4, atol=2e-5)
CENT_TOL = dict(rtol=2e-4, atol=2e-4)
PORT_TOL = 1e-5


def launch(which: str, world: int, workdir: str):
    """Every rank's outputs (``rank<r>.npz``) of one launch."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    spawn_ranks([sys.executable, WORKER, which, workdir], world, workdir,
                LAUNCH_TIMEOUT_S, env=env)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"),
                         allow_pickle=True)) for r in range(world)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    workdir = str(tmp_path_factory.mktemp(f"stream_mp{world}"))
    return world, workdir, launch("stream_mp", world, workdir)


@pytest.fixture(scope="module")
def fault_ranks(tmp_path_factory):
    return launch("stream_faults", 2,
                  str(tmp_path_factory.mktemp("stream_faults")))


def _lr_params():
    return {k: v for k, v in C.LINEAR_HP.items()
            if k not in ("loss", "elastic_net")}


def online_fits(pkg_table, ftrl_cls, okm_cls, batches) -> dict:
    """FTRL (from zeros and from ``FTRL_INIT``) and OnlineKMeans (from
    ``initial_centroids``) over ``batches`` in one process, through either
    package's estimators (``pkg_table`` its Table)."""
    def ftrl(init=None):
        est = ftrl_cls()
        for k, v in worker.FTRL_HP.items():
            est = getattr(est, f"set_{k}")(v)
        if init is not None:
            est = est.set_initial_model_data(pkg_table({"coefficient":
                                                        init[None]}))
        return np.asarray(est.fit_stream(iter(
            pkg_table({"features": b["x"], "label": b["y"]})
            for b in batches))._coefficient)

    okm = (okm_cls().set_k(C.K_CLUSTERS).set_decay_factor(worker.OKM_DECAY)
           .set_initial_model_data(pkg_table(
               {"centroids": C.initial_centroids()[None]}))
           .fit_stream(iter(pkg_table({"features": b["x"]})
                            for b in batches)))
    return {"olr_coef": ftrl(), "olr_warm": ftrl(worker.FTRL_INIT),
            "okm_warm": np.asarray(okm._centroids)}


@functools.lru_cache(maxsize=None)
def jax_reference(world: int) -> dict:
    """The JAX package's one-process fits over the combined stream (on the
    conftest's CPU devices, as ``tests/test_distributed.py`` runs them)."""
    mesh = JaxMesh()
    est = jax_lr.LogisticRegression(mesh=mesh)
    for k, v in C.SPARSE_HP.items():
        getattr(est, f"set_{k}")(v)
    return {
        **online_fits(JaxTable, JaxOnlineLR, JaxOnlineKMeans,
                      C.combined_batches(world)),
        "coef": np.asarray(jax_sgd.train_linear_model_stream(
            iter(C.combined_batches(world)), mesh=mesh, **C.LINEAR_HP)),
        "sp_coef": np.asarray(est.fit(
            iter(C.sparse_combined_tables(world)))._coefficient),
        "cents": np.asarray(jax_kmeans.train_kmeans_stream(
            iter({"x": b["x"]} for b in C.combined_batches(world)),
            k=C.K_CLUSTERS, mesh=mesh,
            initial_centroids=C.initial_centroids(), **C.KMEANS_HP)),
    }


@functools.lru_cache(maxsize=None)
def port_reference(world: int) -> dict:
    """The port's own one-process fits over the combined stream."""
    combined = C.combined_batches(world)
    with fml.use_device("cpu"):
        def est(cls, params):
            return worker._estimator(cls, None, params)

        return {
            **online_fits(fml.Table, fml.OnlineLogisticRegression,
                          fml.OnlineKMeans, combined),
            "coef": t_sgd.train_linear_model_stream(iter(combined),
                                                    **C.LINEAR_HP),
            "stop_uninterrupted": t_sgd.train_linear_model_stream(
                iter(combined), **dict(C.LINEAR_HP,
                                       max_iter=worker.STREAM_EPOCHS)),
            "sp_coef": est(fml.LogisticRegression, C.SPARSE_HP).fit(
                iter(worker.sparse_combined(C, world))).coefficient,
            "sp_coef_empty_rank": est(fml.LogisticRegression,
                                      C.SPARSE_HP).fit(
                iter(worker.sparse_partition(C, 0, world))).coefficient,
            "lr_dense_estimator": est(fml.LogisticRegression,
                                      _lr_params()).fit(
                iter(worker.dense_tables(combined))).coefficient,
            "svc": est(fml.LinearSVC, worker.STREAM_SVC).fit(
                iter(worker.dense_tables(combined))).coefficient,
            "linreg": est(fml.LinearRegression, worker.STREAM_LINREG).fit(
                iter(worker.dense_tables(worker.regression_batches(
                    combined)))).coefficient,
            "cents": t_kmeans.train_kmeans_stream(
                iter({"x": b["x"]} for b in combined), k=C.K_CLUSTERS,
                initial_centroids=C.initial_centroids(), **C.KMEANS_HP),
        }


def test_ranks_bit_for_bit(ranks):
    """Every rank ends every fit with the same bits."""
    world, _, outs = ranks
    for name, value in outs[0].items():
        if name.startswith("local_"):
            continue
        for r in range(1, world):
            np.testing.assert_array_equal(outs[r][name], value, err_msg=name)


def test_dense_stream_matches_jax(ranks):
    world, _, outs = ranks
    np.testing.assert_allclose(outs[0]["coef"], jax_reference(world)["coef"],
                               **COEF_TOL)
    np.testing.assert_allclose(outs[0]["coef"], port_reference(world)["coef"],
                               rtol=0, atol=PORT_TOL)
    # A one-shot stream (pass 0 caches it) trains as the sealed cache.
    np.testing.assert_array_equal(outs[0]["coef_one_shot"], outs[0]["coef"])


def test_sparse_stream_matches_jax(ranks):
    """The CSR stream (one agreed ELL width; the ``spmv`` and unsorted
    ``segment_sum`` kernels' plain versions here)."""
    world, _, outs = ranks
    np.testing.assert_allclose(outs[0]["sp_coef"],
                               jax_reference(world)["sp_coef"], **COEF_TOL)
    ref = port_reference(world)
    np.testing.assert_allclose(outs[0]["sp_coef"], ref["sp_coef"], rtol=0,
                               atol=PORT_TOL)
    # Ranks with no partition at all feed dummies only: rank 0's stream.
    np.testing.assert_allclose(outs[0]["sp_coef_empty_rank"],
                               ref["sp_coef_empty_rank"], rtol=0,
                               atol=PORT_TOL)


def test_kmeans_stream_matches_jax(ranks):
    world, _, outs = ranks
    np.testing.assert_allclose(outs[0]["cents"], jax_reference(world)["cents"],
                               **CENT_TOL)
    np.testing.assert_allclose(outs[0]["cents"],
                               port_reference(world)["cents"], rtol=0,
                               atol=PORT_TOL)
    for name in ("cents_rand", "cents_empty", "cents_estimator"):
        assert outs[0][name].shape == (C.K_CLUSTERS, C.N_FEATURES)
        assert np.all(np.isfinite(outs[0][name])), name


@pytest.mark.parametrize("name", ["lr_dense_estimator", "svc", "linreg"])
def test_estimator_streams_match_one_process(ranks, name):
    """LogisticRegression (dense), LinearSVC and LinearRegression fed
    batch Tables on the mesh."""
    world, _, outs = ranks
    np.testing.assert_allclose(outs[0][name], port_reference(world)[name],
                               rtol=0, atol=PORT_TOL)


def test_online_streams(ranks):
    """FTRL and OnlineKMeans: a version a global step (the most batches of
    any rank, not their sum); FTRL learns the planted signs."""
    world, _, outs = ranks
    most = max(len(C.local_batches(p, world)) for p in range(world))
    assert [int(o["local_batches"][0]) for o in outs] == [
        len(C.local_batches(p, world)) for p in range(world)]
    assert int(outs[0]["olr_version"][0]) == most
    assert int(outs[0]["okm_version"][0]) == most
    x, y = C.global_data()
    acc = float((((x @ outs[0]["olr_coef"]) > 0) == (y > 0.5)).mean())
    assert acc > 0.8, acc
    assert np.all(np.isfinite(outs[0]["okm_cents"]))


@pytest.mark.parametrize("name,tol", [("olr_coef", COEF_TOL),
                                      ("olr_warm", COEF_TOL),
                                      ("okm_warm", CENT_TOL)])
def test_online_streams_match_jax(ranks, name, tol):
    """FTRL (from zeros and warm-started) and OnlineKMeans (from given
    centroids) on P ranks against the JAX package's one-process fits over
    the combined stream, and against the port's own within 1e-5: a step
    sums every rank's partials, and the decay rule runs once a global
    step."""
    world, _, outs = ranks
    np.testing.assert_allclose(outs[0][name], jax_reference(world)[name],
                               **tol)
    np.testing.assert_allclose(outs[0][name], port_reference(world)[name],
                               rtol=0, atol=PORT_TOL)


def test_one_all_reduce_per_step(ranks):
    """The dense stream issues one ``all_reduce`` a step: the most batches
    of any rank, times the epochs (the agreements ride ``_agree``)."""
    world, _, outs = ranks
    most = max(len(C.local_batches(p, world)) for p in range(world))
    for o in outs:
        assert int(o["local_collectives"][0]) == most * C.LINEAR_HP["max_iter"]


def test_resume_at_the_same_world_bit_for_bit(ranks):
    world, workdir, outs = ranks
    o = outs[0]
    np.testing.assert_array_equal(o["coef_resumed"], o["coef"])
    np.testing.assert_array_equal(o["stop_resumed"], o["stop_uninterrupted"])
    np.testing.assert_array_equal(o["cents_resumed"], o["cents_rand"])
    np.testing.assert_array_equal(o["host_resumed"], o["host_uninterrupted"])
    np.testing.assert_allclose(o["stop_uninterrupted"],
                               port_reference(world)["stop_uninterrupted"],
                               rtol=0, atol=PORT_TOL)
    # One writer into the shared directory, recording world P.
    assert CheckpointManager(os.path.join(workdir, "ckpt_linear")
                             ).all_epochs() == [2, 4, 5]
    for sub in ("ckpt_linear", "ckpt_host", "ckpt_kmeans"):
        latest = CheckpointManager(os.path.join(workdir, sub)).latest_epoch()
        with open(os.path.join(workdir, sub, f"ckpt-{latest}",
                               "meta.json")) as fh:
            assert json.load(fh)["world_size"] == world, sub


def test_snapshot_resumed_at_world_1_under_reshard(ranks, on_cpu):
    """The world-P snapshot of epoch ``STREAM_STOP`` resumes at world 1
    under ``rescale="reshard"`` (its leaves are replicated) over the
    combined stream, within 1e-5 of the uninterrupted world-P fit; the
    default policy refuses the rescale, for the host-mode loop's
    snapshots too."""
    world, workdir, outs = ranks
    stop_dir = os.path.join(workdir, "ckpt_stop_world1")
    cache = cache_stream(iter(C.combined_batches(world)))
    hp = dict(C.LINEAR_HP, max_iter=worker.STREAM_EPOCHS)
    with pytest.raises(RescaleError, match=f"world_size={world}"):
        t_sgd.train_linear_model_stream(
            cache, checkpoint_manager=CheckpointManager(stop_dir),
            resume=True, **hp)
    got = t_sgd.train_linear_model_stream(
        cache, checkpoint_manager=CheckpointManager(stop_dir,
                                                    rescale="reshard"),
        checkpoint_interval=1, resume=True, **hp)
    np.testing.assert_allclose(got, outs[0]["stop_uninterrupted"], rtol=0,
                               atol=PORT_TOL)
    x, y, w = worker.dense_lr_data()
    with pytest.raises(RescaleError, match="rescal"):
        train_logistic_regression(
            x, y, w, mode="host", resume=True,
            checkpoint_manager=CheckpointManager(
                os.path.join(workdir, "ckpt_host")),
            **{k: v for k, v in worker.DENSE_KW.items()
               if k != "elastic_net"})


@pytest.mark.parametrize("new_world", [1, 2])
def test_rank_scoped_family_reshards_as_jax(ranks, new_world):
    """A world-P family of ``rank_scoped`` snapshots (a replicated, a
    ``sharded:0`` and a ``per_rank`` leaf, committed by ``save_agreed(...,
    per_rank=True)``) re-laid-out for each rank of a new world: the JAX
    package's ``reshard_rank_state`` on the same directory, bit for bit;
    the ``per_rank`` leaf refuses in both."""
    world, workdir, outs = ranks
    family = os.path.join(workdir, "family")
    assert sorted(os.listdir(family)) == [f"rank-{r}" for r in range(world)]
    assert [str(o["local_scoped_dir"][0]) for o in outs] == [
        os.path.join(family, f"rank-{r}") for r in range(world)]
    like = {"rep": 0, "rows": 0, "local": 0}
    # The per_rank leaf re-read as sharded:0 (its rank blocks joined).
    tags = {"rep": "replicated", "rows": "sharded:0", "local": "sharded:0"}
    for r in range(new_world):
        got = t_ckpt.reshard_rank_state(family, 2, like, (r, new_world),
                                        layouts=tags)
        want = jax_ckpt.reshard_rank_state(family, 2, like, (r, new_world),
                                           layouts=tags)
        for key in ("rep", "rows", "local"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
        np.testing.assert_array_equal(
            got["rows"], np.split(np.concatenate(
                [np.arange(4.0) + 10 * p for p in range(world)]),
                new_world)[r])
    with pytest.raises(RescaleError, match="per_rank"):
        t_ckpt.reshard_rank_state(family, 2, like, (0, new_world))
    with pytest.raises(jax_ckpt.RescaleError, match="per_rank"):
        jax_ckpt.reshard_rank_state(family, 2, like, (0, new_world))


def test_dataset_mesh_shards(ranks, on_cpu):
    """``Dataset.from_arrays(..., mesh=)`` reads rank r's shard
    (``shard=(r, P)``), and a streamed fit fed it on every rank equals the
    one-process fit over the shards' combined stream."""
    world, _, outs = ranks
    x, y = C.global_data()
    cols = {"features": x.astype(np.float64), "label": y.astype(np.float64)}
    shards = [list(Dataset.from_arrays(cols, 16, shard=(r, world)))
              for r in range(world)]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["local_dataset_first_rows"],
                                      shards[r][0].column("features"))
    steps = max(len(s) for s in shards)
    combined = [fml.Table({
        k: np.concatenate([s[t].column(k) for s in shards if t < len(s)])
        for k in cols}) for t in range(steps)]
    want = worker._estimator(fml.LogisticRegression, None, _lr_params()).fit(
        iter(combined)).coefficient
    np.testing.assert_allclose(outs[0]["dataset_fit"], want, rtol=0,
                               atol=PORT_TOL)


def test_sorted_column_stream_refused_on_a_mesh(ranks):
    """A prefetched Dataset of SparseVector rows (``Dataset(..., mesh=)``
    then ``prefetch``) agrees the sorted-column route, which trains on one
    rank only: every rank raises, and none trains its partition alone."""
    _, _, outs = ranks
    for o in outs:
        msg = str(o["local_error_sorted_mesh"][0])
        assert "sorted-column stream" in msg and "sparse_dim" in msg, msg


FAULT_CASES = ("iterator", "kmeans_ragged", "kmeans_iter", "kmeans_cached",
               "linear_ragged", "sparse_ragged", "sparse_dim", "ftrl_iter",
               "online_kmeans", "missing_shard")


@pytest.mark.parametrize("case", FAULT_CASES)
def test_rank_local_failure_aborts_every_rank(fault_ranks, case):
    """The failure lives on rank 0 (``tests/_hang_guard_worker.py``'s
    cases that need no fault seams, plus the CSR stream's and a missing
    rank-scoped shard): both ranks raise, rank 0 its own error, rank 1
    the agreement's; a hang would fail the launch's timeout."""
    outs = fault_ranks
    for o in outs:
        assert int(o[f"local_raised_{case}"][0]) == 1, case
    mine = str(outs[0][f"local_error_{case}"][0])
    peer = str(outs[1][f"local_error_{case}"][0])
    assert "abort" in peer or "another process" in peer, peer
    if case != "sparse_dim":  # there each rank finds its dim the odd one
        assert "all ranks abort together" not in mine, mine


def test_every_batch_bad_surfaces_the_real_error(fault_ranks):
    """Held failures agree before planning: a stream bad on every rank
    reports its validation error, not "empty on every process"."""
    for o in fault_ranks:
        assert "must be [n, d]" in str(o["local_error_all_bad"][0])


def test_streamed_fits_without_a_mesh_stay_one_process(on_cpu):
    """A streamed fit given no mesh (or a mesh without a process group)
    runs the one-process stream: no agreement and no collective."""
    from flinkml_tpu_torch.parallel import DeviceMesh, dispatch

    batches = C.local_batches(0, 1)
    events = []
    dispatch.add_dispatch_observer(events.append)
    try:
        alone = t_sgd.train_linear_model_stream(iter(batches), **C.LINEAR_HP)
        meshed = t_sgd.train_linear_model_stream(iter(batches),
                                                 mesh=DeviceMesh(),
                                                 **C.LINEAR_HP)
    finally:
        dispatch.remove_dispatch_observer(events.append)
    assert events == []
    np.testing.assert_array_equal(alone, meshed)
    assert jax.process_count() == 1
