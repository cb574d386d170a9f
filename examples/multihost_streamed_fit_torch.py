"""Multi-process streamed (out-of-core) training on the PyTorch port.

The streamed fits (linear family, KMeans, GaussianMixture, MLP/FM) train
across a multi-process mesh from PER-PROCESS stream partitions: each rank
feeds only its own batches; the ranks agree the schedule (fixed batch
height, per-epoch step count: short ranks run zero-weight dummy steps),
pool init samples, and commit checkpoints rank-0-write + barrier. The
fitted model is replicated and bit-identical on every rank. One process
per rank, on torch.distributed.

On a cluster, run once per rank with the group in the environment:

    FLINKML_TPU_COORD_ADDR=tcp://<host0>:<port> FLINKML_TPU_WORLD_SIZE=<ranks> \
    FLINKML_TPU_RANK=<this rank> \
    python multihost_streamed_fit_torch.py --worker <shared-dir>

or as a self-contained two-rank demo on this host (gloo; on the card by
default, on the CPU with --device cpu):

    python examples/multihost_streamed_fit_torch.py [--device cpu] [--small]
"""

import os
import sys
import tempfile

DEMO_PREFIX = "multihost-stream-"


def worker(workdir: str, args) -> None:
    import numpy as np

    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.models import KMeans, LogisticRegression
    from flinkml_tpu_torch.parallel import (
        DeviceMesh,
        init_distributed,
        process_slice,
        shutdown_distributed,
    )
    from flinkml_tpu_torch.table import Table

    fml.set_default_device(args.device)
    rank, world = init_distributed(backend=args.backend)
    mesh = DeviceMesh()
    print(f"[rank {rank}] {world} ranks, device {mesh.device}", flush=True)

    # A "too big for one host" dataset: this rank materializes ONLY its
    # process_slice, as a stream of batch Tables (in production: read your
    # shard of files and yield batches).
    n, d = (20_000 if args.small else 100_000), 16
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=d).astype(np.float32)
    sl = process_slice(n)
    my_batches = []
    for start in range(sl.start, sl.stop, 8192):
        rows = min(8192, sl.stop - start)
        r = np.random.default_rng(1000 + start)  # seeded by global offset
        x = r.normal(size=(rows, d)).astype(np.float32)
        y = (x @ w_true > 0).astype(np.float32)
        my_batches.append(Table({"features": x, "label": y}))

    model = (
        LogisticRegression(mesh=mesh)
        .set_max_iter(10 if args.small else 20).set_learning_rate(0.5)
        .set_reg(1e-4).fit(iter(my_batches))
    )
    coef = np.asarray(model.get_model_data()[0].column("coefficient"))
    # Direction recovery (labels are noiseless): cosine with the truth.
    cos = float(
        coef.ravel() @ w_true
        / (np.linalg.norm(coef) * np.linalg.norm(w_true))
    )
    print(f"[rank {rank}] LR cosine(coef, w_true) = {cos:.4f}", flush=True)
    assert cos > 0.95, cos

    km = (
        KMeans(mesh=mesh).set_k(8).set_max_iter(5 if args.small else 10)
        .set_seed(3)
        .fit(iter(
            Table({"features": t.column("features")}) for t in my_batches
        ))
    )
    cents = np.asarray(km.get_model_data()[0].column("centroids"))
    print(f"[rank {rank}] KMeans centroids {cents.shape}, "
          f"norm {np.linalg.norm(cents):.3f}", flush=True)
    np.save(os.path.join(workdir, f"coef_{rank}.npy"), coef)
    shutdown_distributed()
    print(f"[rank {rank}] done", flush=True)


def _args(argv):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the device the port computes on (default: cuda)")
    parser.add_argument("--small", action="store_true",
                        help="a smaller problem, for a quick run on the CPU")
    parser.add_argument("--local-demo", action="store_true",
                        help="two gloo ranks on this host (the default)")
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
    args = _args(sys.argv[1:])
    if args.worker:
        worker(args.worker, args)
    else:
        import shutil

        import numpy as np

        workdir = _local_demo(args)
        a = np.load(os.path.join(workdir, "coef_0.npy"))
        b = np.load(os.path.join(workdir, "coef_1.npy"))
        assert np.array_equal(a, b)
        shutil.rmtree(workdir)
        print("local demo OK: both ranks fitted the identical model from "
              "disjoint stream partitions")
        print("multihost_streamed_fit OK")
