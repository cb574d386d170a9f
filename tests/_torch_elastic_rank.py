"""One rank of an elastic process world, launched by
``tests/test_torch_cluster.py`` and ``chip_smoke.py`` path O3 (the port's
counterpart of ``tests/_elastic_rank.py``; imports no JAX).

Driven by :class:`flinkml_tpu_torch.cluster.ElasticProcessWorld`: world
size IS the process count, the rendezvous rides the
``FLINKML_TPU_COORD_ADDR`` env family through env-driven
:func:`init_distributed` (gloo: two ranks may share one card), the state
lives on the launcher's device (:func:`~flinkml_tpu_torch.cluster.elastic.
rank_device`), and a :class:`~flinkml_tpu_torch.faults.WorkerCrash`
hard-exits the highest rank mid-run — a real ``os._exit`` across a real
process boundary. The supervisor relaunches the survivors as a smaller
world; this script then finds the dead world's rank-scoped snapshot
family and re-lays it out to the new world via the checkpoint layout
tags (``reshard_rank_state``), finishing bit for bit as a continuous
one-process golden run.

State is two float64 leaves chosen to exercise both layout tags: ``w``
(replicated — every rank must agree bit for bit) and ``rows``
(``sharded:0`` — per-rank chunks reassemble and re-split on rescale),
updated on the device each epoch. The epoch math depends only on the
epoch, so any resume path that is NOT a silent fresh start reproduces
the golden bits.

Usage: python _torch_elastic_rank.py <workdir> [golden]
Writes ``<workdir>/result.json`` (or ``result-golden.json``) from the
final world's rank 0.
"""

import glob
import json
import os
import sys

EPOCHS = 6
KILL_EPOCH = 3
ROWS, DIM = 8, 3


def main() -> int:
    workdir = sys.argv[1]
    golden = len(sys.argv) > 2 and sys.argv[2] == "golden"
    from _torch_threads import cap_torch_threads

    cap_torch_threads()

    import numpy as np
    import torch

    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.cluster.elastic import rank_device
    from flinkml_tpu_torch.device import default_device
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.checkpoint import (
        rank_scoped,
        reshard_rank_state,
    )
    from flinkml_tpu_torch.parallel import (
        init_distributed,
        shutdown_distributed,
    )

    rank_device()
    device = default_device()
    # Env-driven rendezvous: ElasticProcessWorld exported the
    # FLINKML_TPU_COORD_ADDR family; without it a one-process no-op.
    rank, world = init_distributed(backend="gloo")

    ckdir = os.path.join(workdir, "ckpt-golden" if golden else "ckpt")
    mgr = CheckpointManager(ckdir, max_to_keep=10, rescale="reshard")
    layouts = {"w": "replicated", "rows": "sharded:0"}

    if not golden and world > 1 and rank == world - 1:
        # The chaos half: this rank dies at the epoch-KILL_EPOCH seam.
        # The marker file keeps the crash once-per-run ACROSS restarts —
        # a relaunched rank re-arming the same plan must not die again.
        faults.arm(faults.FaultPlan(faults.WorkerCrash(
            at=KILL_EPOCH, key="epoch", exit_code=23,
            marker=os.path.join(workdir, "crash.marker"),
        )))

    chunk = ROWS // world
    sl = slice(rank * chunk, (rank + 1) * chunk)
    like = {"w": np.zeros(DIM), "rows": np.zeros((chunk, 2))}

    scoped = rank_scoped(mgr)
    family = sorted(glob.glob(os.path.join(ckdir, "rank-*")))
    resumed_from = 0
    if world == 1 and family:
        # Survivor of a shrunken world: reassemble the dead world's
        # rank-scoped family and re-split it for (rank 0, world 1) —
        # the newest epoch EVERY old rank committed.
        epoch = min(
            CheckpointManager(d, rescale="reshard").latest_epoch() or 0
            for d in family
        )
        host = reshard_rank_state(ckdir, epoch, like, (rank, world),
                                  layouts=layouts)
        resumed_from = epoch
    elif scoped.latest_epoch() is not None:
        host, resumed_from = scoped.restore(scoped.latest_epoch(), like=like)
    else:
        host = {
            "w": np.zeros(DIM),
            "rows": np.arange(ROWS * 2, dtype=np.float64
                              ).reshape(ROWS, 2)[sl],
        }
    state = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
             for k, v in host.items()}
    ramp = torch.arange(1.0, DIM + 1.0, dtype=torch.float64, device=device)

    for epoch in range(resumed_from + 1, EPOCHS + 1):
        if faults.ACTIVE is not None:
            faults.fire("cluster.worker", rank=rank, epoch=epoch)
        # Epoch-only math: world-independent by construction, so any
        # honest resume reproduces the golden bits exactly.
        state = {
            "w": state["w"] + float(epoch) * ramp,
            "rows": state["rows"] * 1.5 + float(epoch),
        }
        scoped.save(state, epoch, layouts=layouts)
    scoped.wait()

    if rank == 0 and world == 1:
        out = os.path.join(
            workdir, "result-golden.json" if golden else "result.json"
        )
        with open(out, "w") as f:
            json.dump({
                "resumed_from": resumed_from,
                "epochs": EPOCHS,
                "device": str(state["w"].device),
                "w": state["w"].cpu().tolist(),
                "rows": state["rows"].cpu().tolist(),
            }, f)
    shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
