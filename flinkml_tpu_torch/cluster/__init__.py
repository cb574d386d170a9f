"""Multi-process worker runtime: "N replicas" means N processes.

The port's counterpart of the JAX package's ``cluster/``, on PyTorch: the
same names, the same frames on the wire. The serving pool's in-process
replicas share one interpreter lock and take turns at the host; here each
replica is a worker process with its own, on the card the parent asked
for. The pieces:

- :mod:`~flinkml_tpu_torch.cluster.protocol` / :mod:`~flinkml_tpu_torch.
  cluster.client` — the length-prefixed local transport (request ids,
  per-byte deadlines, typed error frames);
- :mod:`~flinkml_tpu_torch.cluster.worker` — the child harness (one
  ServingEngine behind the transport, on the parent's device, the
  ``cluster.worker`` fault seam);
- :mod:`~flinkml_tpu_torch.cluster.process` — spawn/supervise children
  (a fresh interpreter each; ``CUDA_VISIBLE_DEVICES`` picks a worker's
  card);
- :mod:`~flinkml_tpu_torch.cluster.remote` — the engine adapter the
  serving router dispatches over, unchanged;
- :mod:`~flinkml_tpu_torch.cluster.pool` — :class:`ClusterPool`, a
  ReplicaPool of worker processes, plus cross-process lease reclaim
  and batch-sized embedding row exchange;
- :mod:`~flinkml_tpu_torch.cluster.elastic` — elastic process worlds
  (world size = process count; crash → resume at the smaller world).
"""

from flinkml_tpu_torch.cluster.client import WorkerClient
from flinkml_tpu_torch.cluster.elastic import (
    COORD_ADDR_VAR,
    RANK_VAR,
    WORLD_SIZE_VAR,
    ElasticProcessWorld,
    free_port,
    rendezvous_env,
)
from flinkml_tpu_torch.cluster.errors import (
    ClusterError,
    ConnectionClosedError,
    FrameError,
    OversizedFrameError,
    RemoteError,
    TransportError,
    TransportTimeoutError,
    WorkerDiedError,
    WorkerSpawnError,
)
from flinkml_tpu_torch.cluster.pool import (
    ClusterPool,
    fetch_embedding_rows,
    reclaim_worker_leases,
)
from flinkml_tpu_torch.cluster.process import WorkerProcess, WorkerSpec
from flinkml_tpu_torch.cluster.remote import RemoteEngine

__all__ = [
    "COORD_ADDR_VAR",
    "RANK_VAR",
    "WORLD_SIZE_VAR",
    "ClusterError",
    "ClusterPool",
    "ConnectionClosedError",
    "ElasticProcessWorld",
    "FrameError",
    "OversizedFrameError",
    "RemoteEngine",
    "RemoteError",
    "TransportError",
    "TransportTimeoutError",
    "WorkerClient",
    "WorkerDiedError",
    "WorkerProcess",
    "WorkerSpawnError",
    "WorkerSpec",
    "fetch_embedding_rows",
    "free_port",
    "reclaim_worker_leases",
    "rendezvous_env",
]
