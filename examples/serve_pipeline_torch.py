"""End-to-end online serving on the PyTorch port: fit -> publish v1 ->
serve concurrent clients -> publish v2+ from a STILL-RUNNING training
stream -> hot-swap with zero dropped or mis-versioned responses and zero
steady-state rebuilds (guard-verified). Runs on an NVIDIA GPU, or on the
CPU with --device cpu:

    python examples/serve_pipeline_torch.py [--device cpu] [--small]
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

import functools
import shutil
import tempfile
import threading

import numpy as np

from flinkml_tpu_torch.analysis.guard import TransferRetraceGuard
from flinkml_tpu_torch.models import KMeans, KMeansModel, StandardScaler
from flinkml_tpu_torch.models.kmeans import train_kmeans_stream
from flinkml_tpu_torch.parallel import DeviceMesh
from flinkml_tpu_torch.pipeline import Pipeline, PipelineModel
from flinkml_tpu_torch.serving import (
    ModelRegistry,
    ServingConfig,
    ServingEngine,
    SnapshotPublisher,
)
from flinkml_tpu_torch.table import Table

# --- Synthesize clustered data -------------------------------------------
rng = np.random.default_rng(0)
n, d, k = (1_000 if args.small else 4_000), 8, 4
x = rng.normal(size=(n, d)) + rng.integers(0, k, size=(n, 1)) * 3.0
train = Table({"features": x})

# --- Fit v1: scale -> cluster (both stages fuse into one kernel launch) --
pipe = Pipeline([
    StandardScaler().set(StandardScaler.INPUT_COL, "features")
                    .set(StandardScaler.OUTPUT_COL, "scaled"),
    KMeans().set(KMeans.FEATURES_COL, "scaled").set(KMeans.K, k)
            .set(KMeans.MAX_ITER, 3).set(KMeans.SEED, 7),
])
model_v1 = pipe.fit(train)
scaler = model_v1.stages[0]

# --- Publish v1 into a versioned registry --------------------------------
registry_dir = tempfile.mkdtemp(prefix="flinkml_registry_")
registry = ModelRegistry(registry_dir)
v1 = registry.publish(model_v1)
print(f"published v{v1}; registry versions: {registry.versions()}")

# --- Serve: the engine warms every row bucket at load, then follows the
# registry (each publish hot-swaps with zero downtime) --------------------
engine = ServingEngine(
    registry,
    example=Table({"features": x[:4]}),
    config=ServingConfig(max_batch_rows=64, max_wait_ms=1.0),
    output_cols=("prediction",),
    name="example",
).start().follow_registry()


@functools.lru_cache(maxsize=16)
def reference_model(version):
    """The fingerprint-verified registry copy of a version (for parity)."""
    return registry.get(version)[1]


stop = threading.Event()
errors, versions_seen = [], set()
completed = [0] * 6


def client(tid):
    crng = np.random.default_rng(tid)
    try:
        # The reference runs on the engine's device (``cuda:0``, not a bare
        # ``cuda``): the programs the engine warmed up serve it too.
        with fml.use_device(engine.device):
            while not stop.is_set():
                rows = int(crng.integers(1, 9))
                lo = int(crng.integers(0, n - rows))
                req = x[lo:lo + rows]
                resp = engine.predict({"features": req})
                versions_seen.add(resp.version)
                # Bitwise parity against the version that claims it.
                (ref,) = reference_model(resp.version).transform(
                    Table({"features": req})
                )
                np.testing.assert_array_equal(
                    ref.column("prediction"), resp.column("prediction")
                )
                completed[tid] += 1
    except BaseException as e:  # noqa: BLE001 (reported by the main thread)
        errors.append(e)


# --- Mid-stream publication: a Lloyd loop over a stream emits a versioned
# snapshot every 3 epochs WITHOUT stopping; the engine swaps live --------
(scaled_train,) = scaler.transform(train)
sx = np.asarray(scaled_train.column("scaled"), np.float32)
stream_batches = [{"x": sx[i::8]} for i in range(8)]


def make_model(centroids):
    # The loop's state is a tensor on the device: read it to the host.
    centroids = centroids.cpu() if hasattr(centroids, "cpu") else centroids
    m = KMeansModel().set(KMeansModel.FEATURES_COL, "scaled") \
                     .set(KMeansModel.K, k)
    m.set_model_data(
        Table({"centroids": np.asarray(centroids, np.float64)[None]})
    )
    return PipelineModel([scaler, m])


publisher = SnapshotPublisher(registry, make_model, every_n_epochs=3)

# Steady state must be rebuild-free: after the engine's load-time warmup,
# client traffic AND hot swaps build no new program (same-shape model data
# reuses the built programs: constants are arguments). The clients stop,
# and the engine with them, whatever the stream or the guard raises.
threads = [threading.Thread(target=client, args=(i,), daemon=True)
           for i in range(6)]
try:
    with TransferRetraceGuard(allow_compiles=0, location="serve_pipeline"):
        for t in threads:
            t.start()
        try:
            final_centroids = train_kmeans_stream(
                stream_batches, k=k, mesh=DeviceMesh(), max_iter=9, seed=7,
                listeners=[publisher],
            )
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)

    assert not any(t.is_alive() for t in threads), "client threads hung"
    assert not errors, errors[:3]
    assert len(versions_seen) >= 2, (
        f"clients never observed a hot swap: {versions_seen}"
    )
    print("mid-stream published versions: "
          f"{[v for _, v in publisher.published]}")
    print(f"clients served {sum(completed)} requests across model versions "
          f"{sorted(versions_seen)}: zero dropped, zero mis-versioned, "
          "zero steady-state rebuilds")

    stats = engine.stats()
    print(f"p50={stats['gauges']['p50_ms']:.2f}ms "
          f"p99={stats['gauges']['p99_ms']:.2f}ms "
          f"batches={stats['counters']['batches']:.0f} "
          f"avg_occupancy="
          f"{stats['counters']['batch_rows'] / stats['counters']['batch_padded_rows']:.2f}")
finally:
    engine.stop()
assert registry.current_version() == registry.versions()[-1]
shutil.rmtree(registry_dir)
print("serving example OK")
print("serve_pipeline OK")
