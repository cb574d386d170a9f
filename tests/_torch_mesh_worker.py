"""One rank of the port's multi-rank parity runs (``tests/test_torch_
parallel.py``, ``tests/test_torch_data_parallel.py``,
``tests/test_torch_sharding.py``, ``tests/test_torch_naive_bayes.py``).

Run as a script by :func:`flinkml_tpu_torch.parallel.launch.spawn_ranks`,
one process per rank, over gloo on the CPU:

    python tests/_torch_mesh_worker.py MODE OUT_DIR

MODE is ``parallel``, ``fits``, ``plans`` or ``naive_bayes``, or one of
the multi-process streams' (``tests/test_torch_stream_mp.py``,
``tests/test_torch_stream_sync.py``): ``stream_mp`` (the streamed fits
over each rank's own partition, their checkpoints and rank-scoped
snapshots), ``stream_faults`` (failures on one rank that must abort
every rank), ``stream_sync`` (the agreement layer) and ``stream_cuda``
(the streamed CSR fit on the card, every rank on ``cuda:0`` over gloo:
``tests/test_torch_cuda.py``), or ``faults`` (the plan-sharded fit under
scripted faults: ``RankLost`` under a watchdog, ``NaNGrad`` under the
sentinel; ``tests/test_torch_preemption.py``), or ``tensor``, ``ring``,
``embeddings``, ``features`` and ``als`` (``tests/_torch_recsys_cases.py``:
tensor and pipeline parallelism, ring attention, sharded embedding
tables, the sharded hashed-FM trainer and ALS on the mesh), or
``catalog_b`` (``tests/_torch_catalog_cases.py``: the forests in RAM and
streamed, GaussianMixture, PCA and Correlation on the mesh), or
``catalog_c`` (the same file: LDA in RAM and streamed). The streams' data
and hyperparameters are ``tests/_stream_mp_common.py``'s, which builds
them from numpy alone.

It imports numpy, torch and the port only (never ``jax`` or
``flinkml_tpu``), builds the inputs with :func:`make_inputs` from numpy
seeds (the tests build the same inputs for the JAX side), runs every case
of the chosen module and writes ``OUT_DIR/rank<r>.npz``. Outputs whose
name starts with ``local_`` are this rank's own (its block, its slice);
every other output must be the same bits on every rank.
"""

from __future__ import annotations

import os
import sys

import numpy as np

#: The fits' hyperparameters, shared with the JAX side of the tests.
DENSE_KW = dict(max_iter=14, learning_rate=0.5, global_batch_size=48,
                reg=0.01, elastic_net=0.0, tol=0.0, seed=3)
SPARSE_KW = dict(max_iter=12, learning_rate=2.0, global_batch_size=90,
                 reg=0.001, elastic_net=0.0, tol=0.0, seed=5)
TOL_KW = dict(DENSE_KW, max_iter=40, tol=0.45)
SOFTMAX_KW = dict(max_iter=12, learning_rate=0.4, global_batch_size=40,
                  reg=0.01, elastic_net=0.0, tol=0.0, seed=2)
SVC_PARAMS = dict(max_iter=15, reg=0.05, elastic_net=0.5, learning_rate=0.3,
                  global_batch_size=50, seed=4)
LINREG_PARAMS = dict(max_iter=15, reg=0.02, elastic_net=0.3,
                     learning_rate=0.05, global_batch_size=60, seed=6)
KMEANS_PARAMS = dict(k=3, max_iter=8, seed=1)
CKPT_KW = dict(DENSE_KW, max_iter=12)
CKPT_STOP, CKPT_INTERVAL = 6, 3
LAYOUTS = ("unsorted", "sorted", "cumsum")


def dense_lr_data(n=203, d=5, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d)
    y = (x @ rng.normal(size=d) + 0.7 * rng.normal(size=n) > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n)
    return x.astype(dtype), y, w


def sparse_lr_data(n=230, dim=120, seed=1):
    """CSR with nnz 1..11 per row (several ELL buckets), sorted unique
    columns per row, planted labels."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(1, 12, size=n)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = np.concatenate(
        [np.sort(rng.choice(dim, k, replace=False)) for k in nnz]
    ).astype(np.int32)
    values = rng.normal(size=indptr[-1]).astype(np.float32)
    beta = rng.normal(size=dim)
    margins = np.add.reduceat(values * beta[indices], indptr[:-1])
    y = (margins + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return indptr, indices, values, dim, y, w


def softmax_data(n=157, d=4, k=3, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.argmax(x @ rng.normal(size=(d, k)) + 0.5 * rng.normal(size=(n, k)),
                  axis=1).astype(np.float64)
    return x, y, rng.uniform(0.5, 2.0, size=n)


def blobs(n=210, d=4, seed=9):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0] * d, [6.0] * d, [-6.0] + [6.0] * (d - 1)])
    return centers[rng.integers(0, 3, size=n)] + rng.normal(size=(n, d))


def make_inputs(p: int) -> dict:
    """The collectives' inputs at world ``p`` (numpy, seeded)."""
    rng = np.random.default_rng(2024 + p)
    return {
        "contrib": rng.normal(size=(p, 100)),
        "contrib3": rng.normal(size=(3 * p, 5)),
        "values": rng.normal(size=(16 * p, 3)),
        "keys": rng.integers(0, 5, size=16 * p),
        "svalues": rng.normal(size=8 * p),
        "skeys": rng.integers(0, 4, size=8 * p),
        "rows": np.arange(4.0 * p).reshape(4 * p, 1),
        "table": np.arange(8.0 * p).reshape(4 * p, 2),
        "model_w": np.arange(5.0),
    }


def transform_rows(d: int, seed: int = 11, n: int = 37) -> np.ndarray:
    """Rows to score: 37 is divisible by neither 2 nor 4, so the sharded
    transform pads."""
    return np.random.default_rng(seed).normal(size=(n, d))


def sparse_vectors(indptr, indices, values, dim):
    from flinkml_tpu_torch.linalg import SparseVector

    rows = np.empty(indptr.size - 1, dtype=object)
    for r in range(rows.size):
        lo, hi = indptr[r], indptr[r + 1]
        rows[r] = SparseVector(dim, indices[lo:hi].astype(np.int64),
                               values[lo:hi].astype(np.float64))
    return rows


class Epochs:
    """Listener: the last epoch a fit ran."""

    epoch = -1

    def on_epoch_watermark_incremented(self, epoch, state):
        self.epoch = epoch

    def on_iteration_terminated(self, state):
        pass


# -- the collectives ------------------------------------------------------------------

def parallel_cases(mesh, world: int) -> dict:
    import torch

    from flinkml_tpu_torch import parallel as par
    from flinkml_tpu_torch.iteration import stream_sync
    from flinkml_tpu_torch.parallel import dispatch
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh

    inp = make_inputs(world)
    out = {}
    rank = mesh.rank
    host = lambda t: t.cpu().numpy()  # noqa: E731
    out["all_reduce_rows1"] = host(par.all_reduce_sum(mesh, inp["contrib"]))
    out["all_reduce_rows3"] = host(par.all_reduce_sum(mesh, inp["contrib3"]))
    out["keyed"] = host(par.keyed_aggregate(mesh, inp["values"], inp["keys"], 5))
    out["keyed_scalar"] = host(par.keyed_aggregate(mesh, inp["svalues"],
                                                   inp["skeys"], 4))
    out["map_partition"] = host(par.map_partition(
        mesh, lambda s: torch.sum(s, dim=0, keepdim=True), inp["rows"]))

    def global_mean(shard):
        total = par.psum(mesh, torch.sum(shard))
        count = par.psum(mesh, torch.tensor(float(shard.shape[0])))
        return total / count

    out["map_partition_replicated"] = host(par.map_partition(
        mesh, global_mean, inp["rows"][:, 0], out_specs=par.REPLICATED))
    rep = par.broadcast(mesh, {"w": inp["model_w"], "b": np.float64(2.0)})
    out["broadcast_w"], out["broadcast_b"] = host(rep["w"]), host(rep["b"])
    out["broadcast_from_first_rank"] = host(
        par.broadcast(mesh, np.full(3, float(rank))))
    block = mesh.shard_batch(inp["table"])
    out["local_shard"] = host(block)
    out["shard_to_host"] = mesh.to_host(block)
    out["replicate"] = host(mesh.replicate(np.ones(3)))
    out["host_barrier"] = np.asarray([par.host_barrier(mesh, tag=3)])
    out["agree"] = np.asarray([stream_sync.agree_max(rank, mesh),
                               stream_sync.agree_min(rank, mesh)])
    s = par.process_slice(10)
    out["local_process_slice"] = np.asarray([s.start, s.stop])
    try:
        DeviceMesh({"data": 2 * world})
        out["mesh_too_large_raises"] = np.asarray([0])
    except ValueError:
        out["mesh_too_large_raises"] = np.asarray([1])
    multi = DeviceMesh({"data": world // 2, "fsdp": 2})
    out["multi_axis_sizes"] = np.asarray([multi.axis_size("data"),
                                          multi.axis_size("fsdp")])
    out["multi_axis_to_host"] = multi.to_host(multi.shard_batch(inp["table"]))
    events = []
    dispatch.add_dispatch_observer(events.append)
    try:
        par.all_reduce_sum(mesh, inp["contrib"])
    finally:
        dispatch.remove_dispatch_observer(events.append)
    out["dispatch_event_devices"] = np.asarray(events[0]["devices"])
    out["sync_interval"] = np.asarray([par.default_sync_interval()])
    return out


# -- the data-parallel fits -------------------------------------------------------------

def fit_cases(mesh, world: int, workdir: str) -> dict:
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.models.logistic_regression import (
        train_logistic_regression,
    )
    from flinkml_tpu_torch.parallel import dispatch

    out = {}
    x, y, w = dense_lr_data()
    for name, dtype in (("lr_dense_f64", np.float64),
                        ("lr_dense_f32", np.float32)):
        out[name] = sgd.train_linear_model(x.astype(dtype), y, w, "logistic",
                                           mesh=mesh, **DENSE_KW)
    ep = Epochs()
    out["lr_dense_tol"] = sgd.train_linear_model(x, y, w, "logistic",
                                                 mesh=mesh, listeners=[ep],
                                                 **TOL_KW)
    out["lr_dense_tol_epoch"] = np.asarray([ep.epoch])
    out["lr_host_mode"] = train_logistic_regression(
        x, y, w, mesh=mesh, mode="host",
        **{k: v for k, v in DENSE_KW.items() if k != "elastic_net"})
    csr = sparse_lr_data()
    for layout in LAYOUTS:
        out[f"lr_sparse_{layout}"] = sgd.train_linear_model_sparse_csr(
            *csr, "logistic", mesh=mesh, layout=layout, **SPARSE_KW)
    xs, ys, ws = softmax_data()
    out["lr_multinomial"] = sgd.train_softmax_model(xs, ys, ws, 3, mesh=mesh,
                                                    **SOFTMAX_KW)

    # The estimators, end to end, and their models' sharded transform.
    lr = fml.LogisticRegression(mesh=mesh).set_seed(3).set_max_iter(10)
    lr_model = lr.fit(fml.Table({"features": x, "label": y}))
    out["lr_estimator"] = lr_model.coefficient
    xt = transform_rows(x.shape[1])
    (t,) = lr_model.transform(fml.Table({"features": xt}))
    out["lr_transform_pred"] = np.asarray(t.column("prediction"))
    out["lr_transform_raw"] = np.asarray(t.column("rawPrediction"))
    mlr = (fml.LogisticRegression(mesh=mesh).set_multi_class("multinomial")
           .set_seed(2).set_max_iter(8))
    mlr_model = mlr.fit(fml.Table({"features": xs, "label": ys}))
    out["lr_multinomial_estimator"] = mlr_model.coefficient
    (t,) = mlr_model.transform(fml.Table({"features": transform_rows(4)}))
    out["lr_multinomial_transform_pred"] = np.asarray(t.column("prediction"))
    out["lr_multinomial_transform_raw"] = np.asarray(t.column("rawPrediction"))
    sparse_table = fml.Table({"features": sparse_vectors(*csr[:4]),
                              "label": csr[4]})
    out["lr_sparse_estimator"] = (fml.LogisticRegression(mesh=mesh)
                                  .set_seed(5).set_max_iter(6)
                                  .fit(sparse_table).coefficient)

    def svc_est(cls, params):
        est = cls(mesh=mesh)
        for key, value in params.items():
            est = getattr(est, f"set_{key}")(value)
        return est

    svc = svc_est(fml.LinearSVC, SVC_PARAMS).fit(
        fml.Table({"features": x, "label": y}))
    out["svc"] = svc.coefficient
    (t,) = svc.transform(fml.Table({"features": xt}))
    out["svc_transform_raw"] = np.asarray(t.column("rawPrediction"))
    out["svc_transform_pred"] = np.asarray(t.column("prediction"))
    out["svc_sparse"] = svc_est(fml.LinearSVC, SVC_PARAMS).fit(
        sparse_table).coefficient
    yr = x @ np.arange(1.0, x.shape[1] + 1.0) + 0.1 * np.cos(np.arange(len(x)))
    reg = svc_est(fml.LinearRegression, LINREG_PARAMS).fit(
        fml.Table({"features": x, "label": yr}))
    out["linreg"] = reg.coefficient
    (t,) = reg.transform(fml.Table({"features": xt}))
    out["linreg_transform"] = np.asarray(t.column("prediction"))
    out["linreg_normal"] = (fml.LinearRegression(mesh=mesh).set_solver("normal")
                            .set_reg(0.02).fit(fml.Table({"features": x,
                                                          "label": yr}))
                            .coefficient)
    xb = blobs()
    km = svc_est(fml.KMeans, KMEANS_PARAMS).fit(fml.Table({"features": xb}))
    out["kmeans"] = km.centroids
    (t,) = km.transform(fml.Table({"features": transform_rows(4) * 6.0}))
    out["kmeans_transform"] = np.asarray(t.column("prediction"))
    out["bisecting"] = (fml.BisectingKMeans(mesh=mesh).set_k(3).set_seed(1)
                        .set_max_iter(8).fit(fml.Table({"features": xb}))
                        .centroids)

    # A checkpointed fit stopped at CKPT_STOP and resumed at the same world.
    ckpt_dir = os.path.join(workdir, "ckpt")
    stop_kw = dict(CKPT_KW, max_iter=CKPT_STOP)
    sgd.train_linear_model(x, y, w, "logistic", mesh=mesh,
                           checkpoint_manager=CheckpointManager(ckpt_dir),
                           checkpoint_interval=CKPT_INTERVAL, **stop_kw)
    out["ckpt_resumed"] = sgd.train_linear_model(
        x, y, w, "logistic", mesh=mesh,
        checkpoint_manager=CheckpointManager(ckpt_dir),
        checkpoint_interval=CKPT_INTERVAL, resume=True, **CKPT_KW)
    out["ckpt_uninterrupted"] = sgd.train_linear_model(
        x, y, w, "logistic", mesh=mesh, **CKPT_KW)

    # A fit given no mesh issues no collective.
    events = []
    dispatch.add_dispatch_observer(events.append)
    try:
        out["no_mesh_fit"] = sgd.train_linear_model(x, y, w, "logistic",
                                                    **DENSE_KW)
    finally:
        dispatch.remove_dispatch_observer(events.append)
    out["no_mesh_collectives"] = np.asarray([len(events)])
    return out


# -- the sharding plans (test_torch_sharding.py) ----------------------------------------

PLAN_NAMES = ("replicated", "batch_parallel", "fsdp", "fsdp_tp", "embedding")
PLAN_KW = dict(max_iter=8, learning_rate=0.5, global_batch_size=48,
               reg=0.01, elastic_net=0.3)
PLAN_DIM = 64
BUDGET_EPOCHS, BUDGET_INTERVAL = 12, 4


def plan_data(n=128, dim=PLAN_DIM, seed=0):
    """Seeded rows, planted labels and weights for the plan fits."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim))
    y = (x @ rng.normal(size=dim) > 0).astype(np.float64)
    return x, y, rng.uniform(0.5, 2.0, size=n)


def budget_bytes(dim=PLAN_DIM, itemsize=8) -> int:
    """A budget the replicated coef + momentum provably exceed."""
    return int(dim * itemsize * 2 * 0.75)


def plan_cases(world: int, workdir: str) -> dict:
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.parallel import dispatch
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh
    from flinkml_tpu_torch.sharding import (
        BATCH_PARALLEL,
        FSDP,
        PRESETS,
        PlanValidationError,
        shard_state,
    )
    from flinkml_tpu_torch.sharding.apply import (
        init_linear_state,
        train_linear_plan,
    )

    out = {}
    x, y, w = plan_data()
    meshes = {name: DeviceMesh.for_plan(PRESETS[name]) for name in PLAN_NAMES}
    for name in PLAN_NAMES:
        for opt in ("sgd", "adam"):
            for dt in ("float64", "float32"):
                out[f"plan_{name}_{opt}_{dt}"] = train_linear_plan(
                    x.astype(dt), y, w, PRESETS[name], meshes[name],
                    optimizer=opt, **PLAN_KW)
    stats = {}
    events = []
    dispatch.add_dispatch_observer(events.append)
    try:
        train_linear_plan(x, y, w, FSDP, meshes["fsdp"], stats=stats,
                          **PLAN_KW)
    finally:
        dispatch.remove_dispatch_observer(events.append)
    out["fsdp_collectives"] = np.asarray(
        [stats["collectives"]["all_gather"], stats["collectives"]["all_reduce"],
         stats["steps"], len(events)])
    state = shard_state(FSDP, meshes["fsdp"],
                        init_linear_state(PLAN_DIM, "adam", np.float64))
    out["local_fsdp_coef_shape"] = np.asarray(state["coef"].to_local().shape)
    out["fsdp_placements"] = np.asarray(
        [repr(p) for p in state["coef"].placements])
    out["fsdp_step_placements"] = np.asarray(
        [repr(p) for p in state["step"].placements])
    # The estimators over a data mesh: the plan's mesh is rebuilt over the
    # same ranks.
    table = fml.Table({"features": x, "label": y})
    out["lr_estimator_fsdp"] = (fml.LogisticRegression(
        mesh=DeviceMesh(), sharding_plan=FSDP).set_seed(3).set_max_iter(6)
        .fit(table).coefficient)
    out["lr_estimator_mixed"] = (fml.LogisticRegression(
        mesh=DeviceMesh(), precision="mixed").set_seed(3).set_max_iter(6)
        .fit(table).coefficient)
    # Over budget replicated: refused before any step; FSDP trains with
    # plan-tagged snapshots that resume at another world.
    budget = budget_bytes()
    try:
        train_linear_plan(x, y, w, BATCH_PARALLEL, meshes["batch_parallel"],
                          hbm_budget_bytes=budget, max_iter=1)
        out["budget_refused"] = np.asarray([0])
    except PlanValidationError as e:
        out["budget_refused"] = np.asarray([int("FML503" in str(e))])
    if PLAN_DIM * 8 * 2 // world <= budget:
        mgr = CheckpointManager(os.path.join(workdir, "ckpt_fsdp"),
                                max_to_keep=10, rescale="reshard")
        out["budget_fsdp"] = train_linear_plan(
            x, y, None, FSDP, meshes["fsdp"], max_iter=BUDGET_EPOCHS,
            learning_rate=0.5, hbm_budget_bytes=budget,
            checkpoint_manager=mgr, checkpoint_interval=BUDGET_INTERVAL)
    return out


def naive_bayes_cases(world: int) -> dict:
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh

    x, y = naive_bayes_data()
    model = fml.NaiveBayes(mesh=DeviceMesh()).fit(
        fml.Table({"features": x, "label": y}))
    (t,) = model.transform(fml.Table({"features": x}))
    return {"nb_theta": model._theta, "nb_pi": model._pi,
            "nb_pred": np.asarray(t.column("prediction"))}


def naive_bayes_data(n=601, seed=4):
    """Integer categories of seven features (n odd: the cells pad)."""
    rng = np.random.default_rng(seed)
    cards = (3, 5, 2, 7, 4, 9, 6)
    x = np.stack([rng.integers(0, c, size=n) for c in cards], 1)
    y = ((x[:, 0] + x[:, 3] + rng.integers(0, 2, size=n)) % 3).astype(float)
    return x.astype(np.float64), y


# -- the multi-process streams (test_torch_stream_mp.py, test_torch_stream_sync.py) ----

#: The streamed SVC / LinearRegression fits' hyperparameters.
STREAM_SVC = dict(max_iter=4, learning_rate=0.3, reg=0.05, elastic_net=0.5,
                  tol=0.0)
STREAM_LINREG = dict(max_iter=4, learning_rate=0.05, reg=0.02,
                     elastic_net=0.3, tol=0.0)
#: A checkpointed dense stream stopped at STREAM_STOP of STREAM_EPOCHS.
STREAM_STOP, STREAM_EPOCHS = 2, 5
#: Rows of each rank's first batch drawn for the pooled-sample case.
POOL_CAP = 6
#: FTRL's hyperparameters (``tests/_stream_mp_worker.py``'s) and the
#: warm start of its second fit.
FTRL_HP = dict(alpha=0.5, beta=0.1, reg=0.001, elastic_net=0.5)
FTRL_INIT = np.linspace(-0.3, 0.3, 6)
#: OnlineKMeans' decay factor.
OKM_DECAY = 0.9


def stream_common():
    """``tests/_stream_mp_common.py`` (numpy only), from the tests dir."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _stream_mp_common

    return _stream_mp_common


def port_sparse_table(rows, dim: int):
    """One port Table of SparseVector rows (``_stream_mp_common``'s
    per-row ``(indices, values, label)``)."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.linalg import SparseVector

    vecs = np.empty(len(rows), dtype=object)
    for j, (idx, val, _) in enumerate(rows):
        vecs[j] = SparseVector(dim, np.asarray(idx, np.int64),
                               np.asarray(val, np.float64))
    return fml.Table({"features": vecs, "label": np.asarray(
        [lab for _, _, lab in rows], np.float64)})


def sparse_partition(C, rank: int, world: int):
    sl = C.slice_for(rank, world)
    rows, bs = C._sparse_rows(sl.start, sl.stop), C.BATCH_SIZES[rank]
    return [port_sparse_table(rows[i:i + bs], C.SPARSE_DIM)
            for i in range(0, len(rows), bs)]


def sparse_combined(C, world: int):
    """The one-process stream whose step t joins every rank's batch t."""
    per = []
    for p in range(world):
        sl = C.slice_for(p, world)
        rows = C._sparse_rows(sl.start, sl.stop)
        bs = C.BATCH_SIZES[p]
        per.append([rows[i:i + bs] for i in range(0, len(rows), bs)])
    steps = max(len(b) for b in per)
    return [port_sparse_table([r for b in per if t < len(b) for r in b[t]],
                              C.SPARSE_DIM) for t in range(steps)]


def dense_tables(batches, label="y"):
    import flinkml_tpu_torch as fml

    return [fml.Table({"features": b["x"].astype(np.float64),
                       "label": b[label].astype(np.float64)})
            for b in batches]


def regression_batches(batches):
    """The dense partition with a linear target (LinearRegression)."""
    return [{"x": b["x"], "y": (b["x"] @ np.arange(1.0, b["x"].shape[1] + 1)
                                ).astype(np.float32)} for b in batches]


def _estimator(cls, mesh, params):
    est = cls(mesh=mesh)
    for key, value in params.items():
        est = getattr(est, f"set_{key}")(value)
    return est


def stream_mp_cases(mesh, rank: int, world: int, workdir: str) -> dict:
    """Every multi-process streamed fit on this rank's partition."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager, cache_stream
    from flinkml_tpu_torch.iteration import checkpoint as ckpt
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.models.kmeans import train_kmeans_stream
    from flinkml_tpu_torch.models.logistic_regression import (
        train_logistic_regression,
    )
    from flinkml_tpu_torch.parallel import dispatch

    C = stream_common()
    out = {}
    batches = C.local_batches(rank, world)
    out["local_batches"] = np.asarray([len(batches)])

    # The dense stream from a durable local cache, snapshots into the
    # shared directory; the terminal snapshot resumes to the same bits.
    cache = cache_stream(iter(batches))
    ckpt_dir = os.path.join(workdir, "ckpt_linear")
    events = []
    dispatch.add_dispatch_observer(events.append)
    try:
        out["coef"] = sgd.train_linear_model_stream(
            cache, mesh=mesh, checkpoint_manager=CheckpointManager(ckpt_dir),
            checkpoint_interval=2, **C.LINEAR_HP)
    finally:
        dispatch.remove_dispatch_observer(events.append)
    out["local_collectives"] = np.asarray([len(events)])
    out["coef_resumed"] = sgd.train_linear_model_stream(
        cache, mesh=mesh, checkpoint_manager=CheckpointManager(ckpt_dir),
        resume=True, **C.LINEAR_HP)
    # A one-shot stream (pass 0 caches it) gives the same bits.
    out["coef_one_shot"] = sgd.train_linear_model_stream(
        iter(batches), mesh=mesh, **C.LINEAR_HP)

    # Stopped at STREAM_STOP, resumed at the same world to STREAM_EPOCHS.
    stop_dir = os.path.join(workdir, "ckpt_stop")
    hp = dict(C.LINEAR_HP, max_iter=STREAM_EPOCHS)
    for d in (stop_dir, stop_dir + "_world1"):
        sgd.train_linear_model_stream(
            cache, mesh=mesh, checkpoint_manager=CheckpointManager(d),
            checkpoint_interval=1, **dict(hp, max_iter=STREAM_STOP))
    out["stop_resumed"] = sgd.train_linear_model_stream(
        cache, mesh=mesh, checkpoint_manager=CheckpointManager(stop_dir),
        checkpoint_interval=1, resume=True, **hp)
    out["stop_uninterrupted"] = sgd.train_linear_model_stream(
        cache, mesh=mesh, **hp)

    # The estimators: LR over CSR partitions (the sparse stream, the
    # kernels' plain versions here), LinearSVC and LinearRegression dense.
    lr = _estimator(fml.LogisticRegression, mesh, C.SPARSE_HP)
    out["sp_coef"] = lr.fit(iter(sparse_partition(C, rank, world))).coefficient
    lr_params = {k: v for k, v in C.LINEAR_HP.items()
                 if k not in ("loss", "elastic_net")}
    out["lr_dense_estimator"] = _estimator(
        fml.LogisticRegression, mesh, lr_params).fit(
        iter(dense_tables(batches))).coefficient
    out["svc"] = _estimator(fml.LinearSVC, mesh, STREAM_SVC).fit(
        iter(dense_tables(batches))).coefficient
    out["linreg"] = _estimator(fml.LinearRegression, mesh, STREAM_LINREG).fit(
        iter(dense_tables(regression_batches(batches)))).coefficient
    # A rank with no partition at all still runs the whole fit.
    out["sp_coef_empty_rank"] = _estimator(
        fml.LogisticRegression, mesh, C.SPARSE_HP).fit(
        iter(sparse_partition(C, rank, world) if rank == 0 else [])
    ).coefficient

    # Each rank reads its own shard of one Dataset (mesh=).
    xg, yg = C.global_data()
    data = fml.data.Dataset.from_arrays({"features": xg.astype(np.float64),
                                         "label": yg.astype(np.float64)},
                                        16, mesh=mesh)
    out["local_dataset_first_rows"] = np.asarray(
        data.peek().column("features"))
    out["dataset_fit"] = _estimator(fml.LogisticRegression, mesh,
                                    lr_params).fit(data).coefficient
    # A prefetched Dataset of SparseVector rows takes the sorted-column
    # stream, which has no multi-process form: every rank refuses it.
    sparse_data = fml.data.Dataset.from_arrays(
        port_sparse_table(C._sparse_rows(0, 64), C.SPARSE_DIM), 16,
        mesh=mesh).prefetch(2)
    try:
        _estimator(fml.LogisticRegression, mesh, C.SPARSE_HP).fit(sparse_data)
        out["local_error_sorted_mesh"] = np.asarray([""], dtype=object)
    except ValueError as e:
        out["local_error_sorted_mesh"] = np.asarray([str(e)], dtype=object)

    # KMeans: a given init, the pooled random init, an empty partition, and
    # the estimator over Tables.
    xb = [{"x": b["x"]} for b in batches]
    out["cents"] = train_kmeans_stream(
        iter(xb), k=C.K_CLUSTERS, mesh=mesh,
        initial_centroids=C.initial_centroids(), **C.KMEANS_HP)
    out["cents_rand"] = train_kmeans_stream(
        iter(xb), k=C.K_CLUSTERS, mesh=mesh, **C.KMEANS_HP)
    out["cents_empty"] = train_kmeans_stream(
        iter(xb if rank == 0 else []), k=C.K_CLUSTERS, mesh=mesh,
        **C.KMEANS_HP)
    out["cents_estimator"] = (
        fml.KMeans(mesh=mesh).set_k(C.K_CLUSTERS).set_seed(3).set_max_iter(5)
        .set_init_mode("k-means++")
        .fit(iter(fml.Table({"features": b["x"]}) for b in batches))
        .centroids)
    # The pooled random init stopped at epoch 2 and resumed to the end:
    # the same bits as cents_rand.
    km_dir = os.path.join(workdir, "ckpt_kmeans")
    train_kmeans_stream(cache_stream(iter(xb)), k=C.K_CLUSTERS, mesh=mesh,
                        checkpoint_manager=CheckpointManager(km_dir),
                        checkpoint_interval=1, **dict(C.KMEANS_HP,
                                                      max_iter=2))
    out["cents_resumed"] = train_kmeans_stream(
        cache_stream(iter(xb)), k=C.K_CLUSTERS, mesh=mesh,
        checkpoint_manager=CheckpointManager(km_dir), checkpoint_interval=1,
        resume=True, **C.KMEANS_HP)

    # The online estimators: FTRL from zeros and warm-started, and
    # OnlineKMeans from the pooled init and from the given centroids.
    def ftrl(init=None):
        est = _estimator(fml.OnlineLogisticRegression, mesh, FTRL_HP)
        if init is not None:
            est = est.set_initial_model_data(fml.Table({"coefficient":
                                                        init[None]}))
        return est.fit_stream(iter(
            fml.Table({"features": b["x"], "label": b["y"]})
            for b in batches))

    olr = ftrl()
    out["olr_coef"] = olr.coefficient
    out["olr_version"] = np.asarray([olr.model_version])
    out["olr_warm"] = ftrl(FTRL_INIT).coefficient

    def online_kmeans(init=None):
        est = (fml.OnlineKMeans(mesh=mesh).set_k(C.K_CLUSTERS).set_seed(7)
               .set_decay_factor(OKM_DECAY))
        if init is not None:
            est = est.set_initial_model_data(fml.Table({"centroids":
                                                        init[None]}))
        return est.fit_stream(iter(fml.Table({"features": b["x"]})
                                   for b in batches))

    okm = online_kmeans()
    out["okm_cents"] = okm.centroids
    out["okm_version"] = np.asarray([okm.model_version])
    out["okm_warm"] = online_kmeans(C.initial_centroids()).centroids

    # mode="host" on the mesh: agreed commits, resumed to the same bits.
    x, y, w = dense_lr_data()
    host_kw = {k: v for k, v in DENSE_KW.items() if k != "elastic_net"}
    host_dir = os.path.join(workdir, "ckpt_host")
    train_logistic_regression(x, y, w, mesh=mesh, mode="host",
                              checkpoint_manager=CheckpointManager(host_dir),
                              checkpoint_interval=3,
                              **dict(host_kw, max_iter=6))
    out["host_resumed"] = train_logistic_regression(
        x, y, w, mesh=mesh, mode="host",
        checkpoint_manager=CheckpointManager(host_dir),
        checkpoint_interval=3, resume=True, **host_kw)
    out["host_uninterrupted"] = train_logistic_regression(
        x, y, w, mesh=mesh, mode="host", **host_kw)

    # A rank-scoped family: a replicated, a sharded:0 and a per_rank leaf.
    family = os.path.join(workdir, "family")
    scoped = ckpt.rank_scoped(CheckpointManager(family, world_size=world))
    ckpt.save_agreed(
        scoped, {"rep": np.full(3, 7.0), "rows": np.arange(4.0) + 10 * rank,
                 "local": np.full(2, float(rank))}, 2, mesh, per_rank=True,
        layouts={"rep": "replicated", "rows": "sharded:0",
                 "local": "per_rank"})
    out["local_scoped_dir"] = np.asarray([scoped.directory], dtype=object)
    return out


def stream_cuda_cases(mesh, rank: int, world: int) -> dict:
    """The streamed CSR LogisticRegression on the card (the ``spmv`` and
    ``segment_sum`` kernels), each rank its own partition, and the
    kernels' launches on this rank."""
    import flinkml_tpu_torch as fml

    C = stream_common()
    fml.reset_launch_counts()
    coef = _estimator(fml.LogisticRegression, mesh, C.SPARSE_HP).fit(
        iter(sparse_partition(C, rank, world))).coefficient
    counts = fml.launch_counts()
    return {"sp_coef": coef, "local_launches": np.asarray(
        [counts.get("spmv", 0), counts.get("segment_sum", 0)])}


def stream_fault_cases(mesh, rank: int, workdir: str) -> dict:
    """Failures that live on rank 0 only; every rank must raise (the
    port's mirror of ``tests/_hang_guard_worker.py``'s cases that need
    no fault seams). ``raised_<case>`` is 1 where this rank raised, with
    the rank's own error on rank 0."""
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration import CheckpointManager, cache_stream
    from flinkml_tpu_torch.iteration import checkpoint as ckpt
    from flinkml_tpu_torch.iteration.stream_sync import (
        agreed_restore,
        synced_stream,
    )
    from flinkml_tpu_torch.models import _linear_sgd as sgd
    from flinkml_tpu_torch.models.kmeans import train_kmeans_stream

    rng = np.random.default_rng(100 + rank)
    lin = dict(loss="logistic", max_iter=2, learning_rate=0.5, reg=0.0,
               elastic_net=0.0, tol=0.0)

    def good_batch(n=16, d=4):
        x = rng.normal(size=(n, d)).astype(np.float32)
        return {"x": x, "y": (x[:, 0] > 0).astype(np.float32)}

    def iterator_raise():
        def source():
            yield np.ones((4, 3), np.float32)
            if rank == 0:
                raise IOError("injected shard read failure")
            yield np.ones((4, 3), np.float32)

        for _ in synced_stream(source(), mesh):
            pass

    def kmeans_ragged():
        batches = [good_batch(), good_batch()]
        if rank == 0:
            batches[1] = {"x": rng.normal(size=(16, 6)).astype(np.float32)}
        train_kmeans_stream(iter({"x": b["x"]} for b in batches), k=2,
                            mesh=mesh, max_iter=2, seed=0)

    def kmeans_iter_raise():
        def source():
            yield {"x": good_batch()["x"]}
            if rank == 0:
                raise IOError("injected stream failure")
            yield {"x": good_batch()["x"]}

        train_kmeans_stream(source(), k=2, mesh=mesh, max_iter=2, seed=0)

    def kmeans_bad_cached_batch():
        batches = [{"x": good_batch()["x"]}, {"x": good_batch()["x"]}]
        if rank == 0:
            batches[1] = {"x": np.ones(8, np.float32)}
        train_kmeans_stream(cache_stream(iter(batches)), k=2, mesh=mesh,
                            max_iter=2, seed=0,
                            initial_centroids=np.zeros((2, 4), np.float32))

    def linear_ragged_value():
        batches = [good_batch(), good_batch()]
        if rank == 0:
            bad = dict(batches[1])
            bad["x"] = [[1.0, 2.0], [3.0]]  # ragged: np.array raises
            batches[1] = bad
        sgd.train_linear_model_stream(iter(batches), mesh=mesh, **lin)

    def sparse_ragged_csr():
        def csr(n, nnz):
            return {"indptr": np.arange(0, n * nnz + 1, nnz)[None],
                    "indices": np.zeros((1, n * nnz), np.int32),
                    "values": np.ones((1, n * nnz), np.float32),
                    "y": np.ones((1, n), np.float32),
                    "dim": np.asarray([[10]], np.int64)}

        batches = [csr(8, 2), csr(8, 3)]
        if rank == 0:
            batches[1]["values"] = np.ones((1, 5), np.float32)
        sgd.train_linear_model_stream(iter(batches), mesh=mesh,
                                      sparse_dim=10, **lin)

    def sparse_dim_disagrees():
        x = {"indptr": np.asarray([[0, 1]]), "indices": np.zeros((1, 1)),
             "values": np.ones((1, 1), np.float32),
             "y": np.ones((1, 1), np.float32)}
        d = 12 if rank == 0 else 10
        sgd.train_linear_model_stream(
            iter([dict(x, dim=np.asarray([[d]]))]), mesh=mesh, sparse_dim=d,
            **lin)

    def online_ftrl_iter_raise():
        def source():
            b = good_batch()
            yield fml.Table({"features": b["x"], "label": b["y"]})
            if rank == 0:
                raise IOError("injected stream failure")
            b = good_batch()
            yield fml.Table({"features": b["x"], "label": b["y"]})

        fml.OnlineLogisticRegression(mesh=mesh).fit_stream(source())

    def online_kmeans_bad_batch():
        tables = [fml.Table({"features": good_batch()["x"]})] * 2
        if rank == 0:
            tables = tables[:1] + [fml.Table({"features": np.ones((4, 6))})]
        fml.OnlineKMeans(mesh=mesh).set_k(2).fit_stream(iter(tables))

    def missing_rank_shard():
        scoped = ckpt.rank_scoped(CheckpointManager(
            os.path.join(workdir, "faults_family")))
        ckpt.save_agreed(scoped, {"m": np.arange(3.0)}, 1, mesh,
                         per_rank=True)
        if rank == 0:
            os.remove(os.path.join(scoped.directory, "ckpt-1", "arrays.npz"))
        agreed_restore(scoped, 1, {"m": 0}, mesh)

    cases = {"iterator": iterator_raise, "kmeans_ragged": kmeans_ragged,
             "kmeans_iter": kmeans_iter_raise,
             "kmeans_cached": kmeans_bad_cached_batch,
             "linear_ragged": linear_ragged_value,
             "sparse_ragged": sparse_ragged_csr,
             "sparse_dim": sparse_dim_disagrees,
             "ftrl_iter": online_ftrl_iter_raise,
             "online_kmeans": online_kmeans_bad_batch,
             "missing_shard": missing_rank_shard}
    out = {}
    for name, case in cases.items():
        try:
            case()
            raised, message = 0, ""
        except Exception as e:  # noqa: BLE001 — the agreed abort expected
            raised, message = 1, f"{type(e).__name__}: {e}"
        out[f"local_raised_{name}"] = np.asarray([raised])
        out[f"local_error_{name}"] = np.asarray([message], dtype=object)
    # Every batch bad on every rank: the held error surfaces as itself.
    try:
        train_kmeans_stream(iter([{"x": np.ones(8, np.float32)}]), k=2,
                            mesh=mesh, max_iter=2, seed=0)
        out["local_error_all_bad"] = np.asarray([""], dtype=object)
    except ValueError as e:
        out["local_error_all_bad"] = np.asarray([str(e)], dtype=object)
    return out


def stream_sync_cases(mesh, rank: int, world: int) -> dict:
    """The agreement layer over the ranks: ``agree_*``, ``gather_vectors``,
    ``pooled_sample`` (its inputs saved for the JAX draw), the plan and
    the lockstep streams on uneven per-rank inputs."""
    from flinkml_tpu_torch.iteration import cache_stream
    from flinkml_tpu_torch.iteration import stream_sync as ss

    out = {}
    out["agree_max"] = np.asarray([ss.agree_max(10 * rank + 3, mesh)])
    out["agree_min"] = np.asarray([ss.agree_min(10 * rank + 3, mesh)])
    vec = np.asarray([rank + 0.125, -2.0 ** 40 * (rank + 1), 1e-300])
    out["gathered"] = ss.gather_vectors(vec, mesh)
    # pooled_sample: rank r holds 3 + r sampled rows of 100·(r + 1).
    rng = np.random.default_rng(50 + rank)
    local = rng.normal(size=(3 + rank, 4)).astype(np.float32)
    out["local_sample"] = local
    out["pooled"] = ss.pooled_sample(local, 100 * (rank + 1), POOL_CAP, 11,
                                     mesh)
    out["pooled_empty_rank"] = ss.pooled_sample(
        local if rank == 0 else np.empty((0,)), 100, POOL_CAP, 11, mesh)
    # The plan over uneven caches; rank r has r + 1 batches of 5 + 4r rows.
    cache = cache_stream(iter([{"x": np.zeros((5 + 4 * rank, 2), np.float32)}
                               for _ in range(rank + 1)]))
    plan = ss.SyncedReplayPlan.create(cache, mesh, 8)
    out["plan"] = np.asarray([plan.global_steps, plan.local_height])
    steps = list(plan.epoch_batches(cache.reader(), lambda: {"_dummy": True}))
    out["local_plan_dummies"] = np.asarray([sum("_dummy" in b
                                                for b in steps)])
    empty = cache_stream(iter([] if rank == 0 else
                              [{"x": np.zeros((3, 2), np.float32)}]))
    out["plan_empty_rank"] = np.asarray(list(
        (lambda p: (p.global_steps, p.local_height))(
            ss.SyncedReplayPlan.create(empty, mesh, 8))))
    out["feature_dim"] = np.asarray([ss.agree_feature_dim(
        empty, "x", mesh)])
    # synced_padded_stream: rank r feeds r + 2 items of 3 + 5r rows.
    items = [(np.full((3 + 5 * rank, 3), float(i), np.float32),
              np.arange(3 + 5 * rank, dtype=np.float32))
             for i in range(rank + 2)]
    got = list(ss.synced_padded_stream(iter(items), mesh, check=None,
                                       row_tile=8, dummy_cols=((3,), ())))
    out["padded_heights"] = np.asarray([h for _, _, h in got])
    out["local_padded_valid"] = np.asarray([float(v.sum())
                                            for _, v, _ in got])
    out["local_padded_x_sum"] = np.asarray([float(a[0].sum())
                                            for a, _, _ in got])
    # agree_first_item_dim with an empty rank: it adopts the agreed dim.
    first, rest, dim = ss.agree_first_item_dim(
        iter([] if rank == world - 1 else [np.ones((2, 5))]),
        lambda x: None, lambda x: x.shape[1], mesh)
    out["first_item_dim"] = np.asarray([dim])
    out["local_first_is_none"] = np.asarray([int(first is None)])
    return out


#: The plan x fault composition's run (the JAX package's
#: ``tests/test_elastic_resume.py`` FSDP case).
FAULT_PLAN_KW = dict(max_iter=12, learning_rate=0.5)
FAULT_KILL_EPOCH, FAULT_INTERVAL, FAULT_NAN_EPOCH = 7, 3, 4


def fault_plan_data(n=96, dim=64, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim))
    return x, (x @ np.arange(1.0, dim + 1.0) > 0).astype(x.dtype)


def fault_cases(mesh, rank: int, world: int, workdir: str) -> dict:
    """The FSDP plan fit at this world under scripted faults: a
    ``RankLost`` of the last rank under a watchdog on every rank (a clean
    stop with a terminal snapshot, then the survivors' elastic plan), and
    a ``NaNGrad`` under the sentinel (every rank raises at one epoch);
    then OnlineStandardScaler over each rank's own partition (one merge of
    the ranks' moments at the end)."""
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.recovery import NumericsError, NumericsSentinel
    from flinkml_tpu_torch.sharding import plan as t_plan
    from flinkml_tpu_torch.sharding.apply import train_linear_plan
    from flinkml_tpu_torch.utils.preemption import PreemptionWatchdog

    x, y = fault_plan_data()
    fsdp_mesh = type(mesh).for_plan(t_plan.FSDP)
    out = {}
    mgr = CheckpointManager(os.path.join(workdir, "plan_ckpt"),
                            max_to_keep=10, rescale="reshard")
    stats = {}
    wd = PreemptionWatchdog(signals=())
    with wd:
        with faults.armed(faults.FaultPlan(faults.RankLost(
                epoch=FAULT_KILL_EPOCH, rank=world - 1))) as plan:
            coef = train_linear_plan(
                x, y, None, t_plan.FSDP, fsdp_mesh,
                checkpoint_manager=mgr, checkpoint_interval=FAULT_INTERVAL,
                stats=stats, **FAULT_PLAN_KW)
    resume = wd.plan_elastic_resume(mgr, world=world)
    out["preempted_coef"] = coef
    out["preempted"] = np.asarray([bool(stats["preempted"]),
                                   stats["epoch"], stats["steps"]])
    out["lost_ranks"] = np.asarray(wd.lost_ranks)
    out["elastic_plan"] = np.asarray([resume.epoch, resume.old_world,
                                      resume.new_world])
    out["fault_log"] = np.asarray([len(plan.log)])
    try:
        with faults.armed(faults.FaultPlan(
                faults.NaNGrad(FAULT_NAN_EPOCH))):
            train_linear_plan(x, y, None, t_plan.FSDP, fsdp_mesh,
                              sentinel=NumericsSentinel(), **FAULT_PLAN_KW)
        out["nan_raise"] = np.asarray([-1, -1, -1])
    except NumericsError as e:
        out["nan_raise"] = np.asarray([e.epoch, e.source_index, e.verdict])
    # OnlineStandardScaler's ranks: each its own partition, one merge.
    from flinkml_tpu_torch.models import OnlineStandardScaler

    model = OnlineStandardScaler().fit_stream(scaler_partition(rank, world))
    out["scaler"] = np.stack([model._data["mean"], model._data["std"]])
    out["scaler_version"] = np.asarray([model.model_version])
    return out


def scaler_partition(rank: int, world: int, seed=2):
    """Rank ``rank``'s batches of the scaler stream (rank 0 one more)."""
    from flinkml_tpu_torch.table import Table

    rng = np.random.default_rng([seed, rank])
    return [Table({"input": rng.normal(size=(32, 6)) * (1 + i + rank)})
            for i in range(3 + (rank == 0))]


def main(argv) -> int:
    which, out_dir = argv[1], argv[2]
    from _torch_threads import cap_torch_threads

    cap_torch_threads()
    import _torch_catalog_cases as catalog
    import _torch_recsys_cases as recsys
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.parallel import DeviceMesh, init_distributed
    from flinkml_tpu_torch.parallel.distributed import shutdown_distributed

    if which == "stream_cuda":
        # Every rank on the one card, over gloo (NCCL runs one rank a card).
        fml.set_default_device("cuda")
        rank, world = init_distributed(backend="gloo", timeout_s=120)
    else:
        fml.set_default_device("cpu")
        rank, world = init_distributed(timeout_s=120)
    try:
        mesh = DeviceMesh()
        if which == "parallel":
            out = parallel_cases(mesh, world)
        elif which == "plans":
            out = plan_cases(world, out_dir)
        elif which == "naive_bayes":
            out = naive_bayes_cases(world)
        elif which == "stream_mp":
            out = stream_mp_cases(mesh, rank, world, out_dir)
        elif which == "stream_faults":
            out = stream_fault_cases(mesh, rank, out_dir)
        elif which == "stream_sync":
            out = stream_sync_cases(mesh, rank, world)
        elif which == "stream_cuda":
            out = stream_cuda_cases(mesh, rank, world)
        elif which == "faults":
            out = fault_cases(mesh, rank, world, out_dir)
        elif which == "tensor":
            out = recsys.tensor_cases(world)
        elif which == "ring":
            out = recsys.ring_cases(world)
        elif which == "embeddings":
            out = recsys.embedding_cases(world, out_dir)
        elif which == "features":
            out = recsys.feature_cases(world)
        elif which == "als":
            out = recsys.als_cases(mesh, rank, world, out_dir)
        elif which == "recsys_b":
            out = recsys.recsys_b_cases(mesh, rank, world, out_dir)
        elif which == "catalog_b":
            out = catalog.catalog_b_cases(mesh, rank, world)
        elif which == "catalog_c":
            out = catalog.catalog_c_cases(mesh, rank, world)
        else:
            out = fit_cases(mesh, world, out_dir)
        out["local_rank_world"] = np.asarray([rank, world])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        shutdown_distributed()
    if "jax" in sys.modules or "flinkml_tpu" in sys.modules:
        raise RuntimeError("a rank of the port imported JAX")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
