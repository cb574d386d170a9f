"""The distributed primitives of the PyTorch port, used directly: mesh,
AllReduce, broadcast, keyed aggregation, mapPartition, host barrier: the
building blocks every estimator trains through, on torch.distributed
(one process per rank; here one rank, whose collectives are the
identity). Runs on an NVIDIA GPU, or on the CPU with --device cpu:

    python examples/parallel_primitives_torch.py [--device cpu] [--small]
"""

import argparse
import os
import sys

try:
    import flinkml_tpu_torch  # noqa: F401
except ImportError:  # run from a checkout: put the repo root on sys.path
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )

import flinkml_tpu_torch as fml

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device the port computes on (default: cuda)")
parser.add_argument("--small", action="store_true",
                    help="a smaller problem, for a quick run on the CPU")
args = parser.parse_args()
fml.set_default_device(args.device)

import numpy as np

from flinkml_tpu_torch.parallel import DeviceMesh, host_barrier
from flinkml_tpu_torch.parallel.broadcast_utils import (
    get_broadcast_variable,
    with_broadcast,
)
from flinkml_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    keyed_aggregate,
    map_partition,
)


def host(t) -> np.ndarray:
    """A result on the host."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


mesh = DeviceMesh()  # 1-D "data" axis over every rank
P = mesh.axis_size()
print(f"mesh: {P} ranks on axis '{mesh.DATA_AXIS}' ({mesh.device})")

# --- AllReduce: per-rank partial sums -> identical global sum ------------
parts = np.arange(P * 4, dtype=np.float64).reshape(P, 4)
total = host(all_reduce_sum(mesh, parts))
np.testing.assert_array_equal(total, parts.sum(axis=0))
print("all_reduce_sum:", total)

# --- Broadcast variables: replicate a model to every rank ----------------
# (inside the function the variable is read by name, the reference's
# getBroadcastVariable idiom)
rows = np.arange(P * 8, dtype=np.float64).reshape(P * 8, 1)


def scorer(x_batch):
    model = get_broadcast_variable("model")
    return x_batch * model["bias"]


scored = with_broadcast(
    scorer, (mesh.shard_batch(rows),),
    broadcast_variables={"model": {"coef": np.ones(4), "bias": np.array(2.0)}},
    mesh=mesh,
)
np.testing.assert_array_equal(host(scored), rows * 2.0)
print("with_broadcast: ok")

# --- Keyed aggregation: segment_sum + all_reduce (keyBy + reduce) --------
values = np.ones((P * 8, 2))
keys = np.tile(np.arange(4), P * 2)
sums = host(keyed_aggregate(mesh, values, keys.astype(np.int32),
                            num_segments=4))
np.testing.assert_array_equal(sums, np.full((4, 2), 2.0 * P))
print("keyed_aggregate:", sums[:, 0])

# --- mapPartition: run a function once per shard --------------------------
data = np.arange(P * 8, dtype=np.float64)


def per_partition(shard):
    # Each rank sees its local rows; emit a per-row normalized value.
    return shard - shard.mean()


centered = host(map_partition(mesh, per_partition, data))
assert centered.shape == data.shape
print("map_partition: per-shard mean removed")

# --- Host barrier: every rank rendezvous (the control plane) -------------
participants = host_barrier(mesh, tag=1)
print("host_barrier participants:", participants)
print("parallel_primitives OK")
