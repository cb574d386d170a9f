"""KMeans example on the PyTorch port: k-means++ init, the Lloyd loop on
the device, save/load, a cluster-quality check (the adjusted Rand index,
in numpy, against a second clustering by the port). Runs on an NVIDIA
GPU, or on the CPU with --device cpu:

    python examples/train_kmeans_torch.py [--device cpu] [--small]
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

import tempfile

import numpy as np

from flinkml_tpu_torch.models import KMeans, KMeansModel
from flinkml_tpu_torch.table import Table


def adjusted_rand_score(a, b) -> float:
    """The adjusted Rand index of two labelings (Hubert and Arabie)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(table, (ai, bi), 1)

    def pairs(v):
        return float((v * (v - 1) / 2).sum())

    index = pairs(table)
    rows, cols = pairs(table.sum(1)), pairs(table.sum(0))
    expected = rows * cols / pairs(np.array([len(a)]))
    top = (rows + cols) / 2
    return 1.0 if top == expected else (index - expected) / (top - expected)


# --- Three well-separated blobs ------------------------------------------
rng = np.random.default_rng(7)
per_blob = 100 if args.small else 400
centers = np.array([[0.0, 0.0], [6.0, 6.0], [-6.0, 5.0]])
x = np.concatenate([c + rng.normal(scale=0.7, size=(per_blob, 2))
                    for c in centers])
table = Table({"features": x})

# --- Fit: the whole Lloyd iteration runs on the device -------------------
kmeans = (
    KMeans()
    .set_k(3)
    .set_max_iter(30)
    .set_seed(0)
    .set_init_mode("k-means++")
)
model = kmeans.fit(table)

(out,) = model.transform(table)
assign = np.asarray(out["prediction"])
print("cluster sizes:", np.bincount(assign.astype(int)))

# Each learned centroid should sit on one true blob center.
learned = np.sort(model.centroids, axis=0)
print("learned centroids (sorted):\n", np.round(learned, 2))

# --- Agreement with a second clustering: another seed --------------------
(other,) = (KMeans().set_k(3).set_max_iter(30).set_seed(1)
            .set_init_mode("k-means++").fit(table).transform(table))
ari = adjusted_rand_score(np.asarray(other["prediction"]), assign)
print(f"adjusted Rand vs a second KMeans (seed 1): {ari:.3f}")
assert ari > 0.99

# --- Persist and reload --------------------------------------------------
with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "kmeans_model")
    model.save(path)
    reloaded = KMeansModel.load(path)
    (again,) = reloaded.transform(table)
    assert np.array_equal(np.asarray(again["prediction"]), assign)
    print("save/load round-trip OK")
print("train_kmeans OK")
