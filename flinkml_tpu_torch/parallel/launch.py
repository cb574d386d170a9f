"""Start the ranks of a process group on this host.

The port's launcher for several ranks of one program: each rank is a
subprocess given the rendezvous environment :func:`~flinkml_tpu_torch.
parallel.init_distributed` reads (``FLINKML_TPU_COORD_ADDR`` as a
``file://`` store under the run's directory, so no port is needed,
``FLINKML_TPU_WORLD_SIZE``, ``FLINKML_TPU_RANK``) and one thread of
intra-op parallelism (``OMP_NUM_THREADS=1``), so P ranks on one host do
not oversubscribe its cores. The whole launch has one deadline: a rank
that hangs (a collective some peer never reached) is killed with every
other rank, and the launch raises.

.. code-block:: python

    from flinkml_tpu_torch.parallel.launch import spawn_ranks

    ranks = spawn_ranks([sys.executable, "worker.py"], world=2,
                        workdir=tmp, timeout_s=120)
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import time
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str


def _tail(text: str, n: int = 3000) -> str:
    return text if len(text) <= n else "..." + text[-n:]


def spawn_ranks(argv: Sequence[str], world: int, workdir: str,
                timeout_s: float, env: Optional[Dict[str, str]] = None
                ) -> List[RankResult]:
    """Run ``argv`` as ranks ``0..world-1`` of one process group and wait
    for all of them, at most ``timeout_s`` seconds in all.

    Each rank's output goes to ``<workdir>/rank<r>.out`` and ``.err`` (and
    comes back in its :class:`RankResult`). On the deadline every rank
    still running is killed (its whole process group) and ``TimeoutError``
    is raised; a rank that exits non-zero raises ``RuntimeError`` naming
    each rank's code and the tail of its errors.
    """
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"rendezvous-{os.getpid()}-{time.time_ns()}")
    base = dict(os.environ if env is None else env)
    base.update({
        "FLINKML_TPU_COORD_ADDR": "file://" + store,
        "FLINKML_TPU_WORLD_SIZE": str(int(world)),
        "OMP_NUM_THREADS": "1",
    })
    procs, files = [], []
    try:
        for rank in range(int(world)):
            out = open(os.path.join(workdir, f"rank{rank}.out"), "w+")
            err = open(os.path.join(workdir, f"rank{rank}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(
                list(argv), env=dict(base, FLINKML_TPU_RANK=str(rank)),
                stdout=out, stderr=err, start_new_session=True,
            ))
        deadline = time.monotonic() + float(timeout_s)
        timed_out = False
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
    results = []
    for rank, (p, (out, err)) in enumerate(zip(procs, files)):
        out.seek(0)
        err.seek(0)
        results.append(RankResult(rank, p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    if timed_out:
        raise TimeoutError(
            f"{world} ranks of {list(argv)} did not finish within "
            f"{timeout_s} s; every rank was killed:\n"
            + "\n".join(f"rank {r.rank}: {_tail(r.stderr)}" for r in results)
        )
    if any(r.returncode != 0 for r in results):
        raise RuntimeError(
            f"ranks of {list(argv)} failed (exit codes "
            f"{[r.returncode for r in results]}):\n"
            + "\n".join(f"rank {r.rank} (exit {r.returncode}): "
                        f"{_tail(r.stderr)}" for r in results)
        )
    return results
