"""Multi-process training recipe on the PyTorch port: one process per
rank on torch.distributed.

The recipe, per rank:

  1. **Join the group**: ``init_distributed()`` reads the group from the
     environment (``FLINKML_TPU_COORD_ADDR``, ``FLINKML_TPU_WORLD_SIZE``,
     ``FLINKML_TPU_RANK``); a no-op in one process, so the same script
     runs anywhere.
  2. **Mesh**: ``DeviceMesh()`` spans every rank.
  3. **Ingest a slice**: ``process_slice(n)`` gives this rank's
     contiguous rows; ``mesh.global_batch(local_rows)`` puts them on the
     rank's device as its block of the data-sharded batch: no rank ever
     holds the full dataset.
  4. **Train**: a logistic-SGD step on every rank, its gradient summed by
     ``psum`` (one all_reduce) over the ranks; ``synced_loop`` bounds
     the collectives in flight. Every rank computes identical replicated
     coefficients.
  5. **Checkpoint with commit ordering**: every rank syncs at a
     ``host_barrier`` before rank 0 commits the manifest, then a second
     barrier publishes it.

On a cluster run one copy per rank with the environment above:

    python multihost_pod_torch.py --worker <shared-dir>

Run ``python examples/multihost_pod_torch.py --local-demo`` to see the
whole flow as two gloo ranks on this host (on the card by default, on
the CPU with --device cpu); with no flag it runs as one process.
"""

import json
import os
import sys
import tempfile

DEMO_PREFIX = "multihost-pod-"


def worker(workdir: str, args) -> None:
    import numpy as np
    import torch

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flinkml_tpu_torch.models.kmeans import train_kmeans_stream
    from flinkml_tpu_torch.models.online_logistic_regression import (
        OnlineLogisticRegression,
    )
    from flinkml_tpu_torch.parallel import (
        DeviceMesh,
        host_barrier,
        init_distributed,
        process_slice,
        shutdown_distributed,
        synced_loop,
    )
    from flinkml_tpu_torch.parallel.collectives import psum
    from flinkml_tpu_torch.table import Table

    def log(msg):
        print(f"[rank {os.environ.get('FLINKML_TPU_RANK', '0')}] {msg}",
              flush=True)

    fml.set_default_device(args.device)
    # 1. Join the group (environment driven; a no-op in one process).
    rank, world = init_distributed(backend=args.backend)
    log(f"joined the group ({rank}/{world})")

    # 2. The mesh over every rank.
    mesh = DeviceMesh()
    log(f"mesh over {mesh.num_devices} ranks on {mesh.device}")

    # 3. Each rank ingests ONLY its slice of the (here: synthetic) dataset.
    n_global, dim = (2048 if args.small else 4096), 16
    rng = np.random.default_rng(0)
    true_coef = rng.normal(size=dim).astype(np.float32)
    sl = process_slice(n_global)
    # Per-rank deterministic generation of just this rank's rows; a real
    # pipeline would read the files assigned by the same slice.
    row_rng = np.random.default_rng(1234)
    x_all = row_rng.normal(size=(n_global, dim)).astype(np.float32)
    x_local = x_all[sl]
    y_local = (x_local @ true_coef > 0).astype(np.float32)
    xg = mesh.global_batch(x_local)
    yg = mesh.global_batch(y_local)
    log("global batch assembled")

    # 4. The logistic-SGD step: each rank's gradient, summed over the ranks.
    count = psum(mesh, torch.tensor(float(xg.shape[0]), device=mesh.device))

    def one_step(coef, i):
        mult = torch.sigmoid(xg @ coef) - yg
        grad = psum(mesh, xg.T @ mult)
        if i == 0:
            log("first step ran")
        return coef - (1.0 / count) * grad

    coef = synced_loop(60, one_step, torch.zeros(dim, device=mesh.device))
    coef_host = coef.cpu().numpy()
    log("training done")

    # Replicated lockstep check: every rank holds identical coefficients.
    acc = float(np.mean((x_local @ coef_host > 0) == y_local))
    assert acc > 0.9, f"rank {rank}: failed to learn (acc={acc})"

    # 4b. The estimator catalog trains the same way (every streamed and
    # online fit accepts per-rank stream partitions). One of each flavor:
    cents = train_kmeans_stream(
        iter({"x": x_local[s : s + 64]} for s in range(0, len(x_local), 64)),
        k=4, mesh=mesh, max_iter=3, seed=0,
    )
    assert np.isfinite(cents).all()
    log("streamed KMeans over per-rank partitions done")
    olr_model = OnlineLogisticRegression(mesh=mesh).fit_stream(iter(
        Table({"features": x_local[s : s + 64],
               "label": y_local[s : s + 64].astype(np.float64)})
        for s in range(0, len(x_local), 64)
    ))
    assert np.isfinite(olr_model.coefficient).all()
    log("online FTRL over per-rank streams done")

    # 5. Barrier-ordered checkpoint commit (two-phase: shards -> barrier
    # -> manifest by rank 0 -> barrier -> visible everywhere).
    np.save(os.path.join(workdir, f"coef-shard-{rank}.npy"), coef_host)
    log("shard written; entering barrier 1")
    host_barrier(mesh, tag=1)
    log("barrier 1 passed")
    manifest = os.path.join(workdir, "manifest.json")
    if rank == 0:
        mgr = CheckpointManager(os.path.join(workdir, "ckpt"),
                                world_size=mesh.num_devices)
        mgr.save({"coef": coef_host}, epoch=60)
        tmp = manifest + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": 60, "ranks": world}, f)
        os.replace(tmp, manifest)
    host_barrier(mesh, tag=2)
    assert os.path.exists(manifest), "commit must be visible after barrier"
    shutdown_distributed()
    print(f"POD_OK rank={rank}/{world} devices={mesh.num_devices} "
          f"acc={acc:.3f}", flush=True)


def _args(argv):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the device the port computes on (default: cuda)")
    parser.add_argument("--small", action="store_true",
                        help="a smaller problem, for a quick run on the CPU")
    parser.add_argument("--local-demo", action="store_true",
                        help="two gloo ranks on this host")
    parser.add_argument("--worker", metavar="DIR",
                        help="run one rank; the group from the environment")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="the process group's backend (default: nccl "
                        "on cuda, gloo on the CPU)")
    return parser.parse_args(argv)


def _local_demo(args) -> str:
    """Spawn two ranks on this host over gloo (two ranks on one card
    cannot use nccl) with a ``file://`` store, each running
    :func:`worker`; returns the work directory."""
    import subprocess

    workdir = tempfile.mkdtemp(prefix=DEMO_PREFIX)
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update({
            "FLINKML_TPU_COORD_ADDR": "file://" + os.path.join(workdir,
                                                               "store"),
            "FLINKML_TPU_WORLD_SIZE": "2",
            "FLINKML_TPU_RANK": str(rank),
            "OMP_NUM_THREADS": "1",
        })
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               workdir, "--device", args.device, "--backend", "gloo"]
        procs.append(subprocess.Popen(cmd + (["--small"] if args.small
                                             else []), env=env))
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        # Never leak ranks: a timeout or an interrupt must not leave the
        # pair parked on a barrier.
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise SystemExit(f"rank exit codes: {codes}")
    return workdir


if __name__ == "__main__":
    try:
        import flinkml_tpu_torch  # noqa: F401
    except ImportError:  # run from a checkout: the repo root on sys.path
        sys.path.insert(
            0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    import shutil

    args = _args(sys.argv[1:])
    if args.worker:
        worker(args.worker, args)
    elif args.local_demo:
        shutil.rmtree(_local_demo(args))
        print("LOCAL DEMO OK (2 ranks)")
        print("multihost_pod OK")
    else:
        workdir = tempfile.mkdtemp(prefix=DEMO_PREFIX)
        worker(workdir, args)
        shutil.rmtree(workdir)
        print("multihost_pod OK")
