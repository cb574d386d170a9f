"""Five clustering algorithms on the PyTorch port, on two datasets that
tell them apart: blobs (everyone succeeds) and concentric rings (only
affinity-based clustering can). The adjusted Rand index is computed in
numpy. Runs on an NVIDIA GPU, or on the CPU with --device cpu:

    python examples/clustering_tour_torch.py [--device cpu] [--small]
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

from flinkml_tpu_torch.models import (
    AgglomerativeClustering,
    BisectingKMeans,
    GaussianMixture,
    KMeans,
    PowerIterationClustering,
)
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


rng = np.random.default_rng(0)

# -- dataset 1: three gaussian blobs ----------------------------------------
x_blobs = np.concatenate([
    rng.normal(size=(80, 2)) * 0.5 + c for c in ([0, 0], [5, 0], [0, 5])
])
y_blobs = np.repeat([0, 1, 2], 80)
t_blobs = Table({"features": x_blobs})

results = {}
(km,) = KMeans().set_k(3).set_init_mode("k-means++").set_seed(0).fit(
    t_blobs).transform(t_blobs)
results["KMeans"] = adjusted_rand_score(y_blobs, km["prediction"])

(bk,) = BisectingKMeans().set_k(3).set_seed(0).fit(t_blobs).transform(t_blobs)
results["BisectingKMeans"] = adjusted_rand_score(y_blobs, bk["prediction"])

(gm,) = GaussianMixture().set_k(3).set_seed(0).set_max_iter(
    30 if args.small else 80).fit(t_blobs).transform(t_blobs)
results["GaussianMixture"] = adjusted_rand_score(y_blobs, gm["prediction"])

(ag,) = AgglomerativeClustering().set_num_clusters(3).transform(t_blobs)
results["Agglomerative"] = adjusted_rand_score(y_blobs, ag["prediction"])
print("blobs:", {k: round(v, 3) for k, v in results.items()})
assert min(results.values()) > 0.9, results

# -- dataset 2: concentric rings --------------------------------------------
theta = rng.uniform(0, 2 * np.pi, 200)
r = np.concatenate([np.full(100, 1.0), np.full(100, 4.0)])
r += 0.1 * rng.normal(size=200)
x_rings = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
y_rings = np.repeat([0, 1], 100)

(km2,) = KMeans().set_k(2).set_seed(0).fit(
    Table({"features": x_rings})).transform(Table({"features": x_rings}))
km2_ari = adjusted_rand_score(y_rings, km2["prediction"])

# kNN affinity graph for PIC.
d2 = ((x_rings[:, None] - x_rings[None]) ** 2).sum(-1)
np.fill_diagonal(d2, np.inf)
knn = np.argsort(d2, axis=1)[:, :8]
src = np.repeat(np.arange(200), 8)
dst = knn.ravel()
edges = Table({"src": src, "dst": dst,
               "w": np.exp(-d2[src, dst] / 0.5)})
(pic,) = (
    PowerIterationClustering().set_k(2).set_max_iter(50)
    .set_weight_col("w").set_seed(0).transform(edges)
)
order = np.argsort(pic["id"])
pic_ari = adjusted_rand_score(y_rings, pic["prediction"][order])
print(f"rings: KMeans ARI={km2_ari:.3f}  PIC ARI={pic_ari:.3f}  "
      "(affinity clustering handles non-convex shapes)")
assert pic_ari > km2_ari
print("clustering_tour OK")
