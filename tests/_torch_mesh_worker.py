"""One rank of the port's multi-rank parity runs (``tests/test_torch_
parallel.py``, ``tests/test_torch_data_parallel.py``,
``tests/test_torch_sharding.py``, ``tests/test_torch_naive_bayes.py``).

Run as a script by :func:`flinkml_tpu_torch.parallel.launch.spawn_ranks`,
one process per rank, over gloo on the CPU:

    python tests/_torch_mesh_worker.py {parallel|fits|plans|naive_bayes} OUT_DIR

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


def main(argv) -> int:
    which, out_dir = argv[1], argv[2]
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.parallel import DeviceMesh, init_distributed
    from flinkml_tpu_torch.parallel.distributed import shutdown_distributed

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
