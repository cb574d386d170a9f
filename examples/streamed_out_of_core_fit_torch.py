"""Out-of-core training on the PyTorch port: fit from a one-shot stream of
batches with a memory budget. Epoch 0 trains while caching (spilling past
the budget to disk segments); later epochs replay the cache through a
prefetching device feed. Runs on an NVIDIA GPU, or on the CPU with
--device cpu:

    python examples/streamed_out_of_core_fit_torch.py [--device cpu] [--small]
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

from flinkml_tpu_torch.models import LogisticRegression
from flinkml_tpu_torch.models.als import ALS
from flinkml_tpu_torch.table import Table

rng = np.random.default_rng(5)
d = 24
true_coef = rng.normal(size=d)


def batch_stream(n_batches, rows_each):
    """A one-shot generator: the data does NOT fit in memory at once."""
    for _ in range(n_batches):
        x = rng.normal(size=(rows_each, d)).astype(np.float32)
        y = (x @ true_coef > 0).astype(np.float32)
        yield Table({"features": x, "label": y})


with tempfile.TemporaryDirectory() as cache_dir:
    lr = LogisticRegression(
        cache_dir=cache_dir,
        # Tiny budget on purpose: most batches spill to disk segments.
        cache_memory_budget_bytes=256 * 1024,
    ).set_max_iter(10 if args.small else 20).set_learning_rate(0.5) \
        .set_tol(0.0)

    # fit() with an iterable streams: epoch 0 caches and trains, the later
    # epochs replay the (mostly on-disk) cache.
    model = lr.fit(batch_stream(n_batches=10 if args.small else 40,
                                rows_each=512))

    # Score a fresh sample.
    x = rng.normal(size=(2048, d)).astype(np.float32)
    y = (x @ true_coef > 0).astype(np.float32)
    (out,) = model.transform(Table({"features": x, "label": y}))
    acc = float(np.mean(out["prediction"] == y))
    print(f"held-out accuracy after out-of-core fit: {acc:.3f}")
    assert acc > 0.95

# Every streamed estimator follows the same pattern. A taste of the
# recommendation family on the same cache discipline:
with tempfile.TemporaryDirectory() as cache_dir:
    n_users, n_items, rank = 60, 40, 3
    uf = rng.normal(size=(n_users, rank))
    vf = rng.normal(size=(n_items, rank))

    def rating_stream(n_batches, rows_each):
        for _ in range(n_batches):
            u = rng.integers(0, n_users, rows_each)
            i = rng.integers(0, n_items, rows_each)
            yield Table({
                "user": u, "item": i,
                "rating": np.einsum("nk,nk->n", uf[u], vf[i])
                .astype(np.float32),
            })

    als_model = (
        ALS(cache_dir=cache_dir, cache_memory_budget_bytes=256 * 1024)
        .set_rank(4).set_max_iter(8).set_reg_param(0.05).set_seed(0)
        .fit(rating_stream(n_batches=12, rows_each=512))
    )
    u = rng.integers(0, n_users, 1024)
    i = rng.integers(0, n_items, 1024)
    (pred,) = als_model.transform(Table({"user": u, "item": i}))
    rmse = float(np.sqrt(np.mean(
        (pred["prediction"] - np.einsum("nk,nk->n", uf[u], vf[i])) ** 2
    )))
    print(f"ALS streamed-fit RMSE vs ground-truth factors: {rmse:.3f}")
    assert rmse < 0.3
print("streamed_out_of_core_fit OK")
