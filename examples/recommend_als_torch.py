"""ALS recommendation on the PyTorch port, end to end: synthetic taste
clusters -> implicit ALS -> top-k recommendations, and explicit-mode
rating prediction. Runs on an NVIDIA GPU, or on the CPU with
--device cpu:

    python examples/recommend_als_torch.py [--device cpu] [--small]
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

from flinkml_tpu_torch.models import ALS, RegressionEvaluator
from flinkml_tpu_torch.table import Table

rng = np.random.default_rng(0)

# -- explicit ratings from a low-rank taste model ---------------------------
n_users, n_items, rank = 100, 80, 5
u = rng.normal(size=(n_users, rank)) / np.sqrt(rank)
v = rng.normal(size=(n_items, rank)) / np.sqrt(rank)
full = 3.0 + 1.5 * (u @ v.T)
mask = rng.uniform(size=full.shape) < 0.3
users, items = np.nonzero(mask)
ratings = full[users, items] + 0.05 * rng.normal(size=len(users))
train = Table({"user": users, "item": items, "rating": ratings})

model = (
    ALS().set_rank(8).set_max_iter(6 if args.small else 12)
    .set_reg_param(0.05).set_seed(0).fit(train)
)
(scored,) = model.transform(train)
(metrics,) = (
    RegressionEvaluator().set_label_col("rating")
    .set_metrics_names(["rmse"]).transform(scored)
)
print(f"explicit ALS in-sample RMSE: {metrics['rmse'][0]:.4f}")
assert metrics["rmse"][0] < 0.5

# -- implicit feedback: click counts -> top-k recommendations ---------------
clicks_u, clicks_i, counts = [], [], []
for usr in range(n_users):
    liked = np.argsort(-full[usr])[:10]          # true taste
    for it in rng.choice(liked, size=6):
        clicks_u.append(usr)
        clicks_i.append(it)
        counts.append(float(rng.integers(1, 8)))
implicit_train = Table({
    "user": np.asarray(clicks_u), "item": np.asarray(clicks_i),
    "rating": np.asarray(counts),
})
imp = (
    ALS().set_rank(8).set_max_iter(5 if args.small else 10)
    .set_reg_param(0.1).set_implicit_prefs(True).set_alpha(10.0).set_seed(0)
    .fit(implicit_train)
)
rec_items, rec_scores = imp.recommend_for_all_users(5)
hit = np.mean([
    len(set(np.asarray(rec_items[usr]).tolist())
        & set(np.argsort(-full[usr])[:10].tolist())) / 5
    for usr in range(n_users)
])
print(f"implicit ALS top-5 hit rate vs true taste: {hit:.2f}")
assert hit > 0.5
print("recommend_als OK")
