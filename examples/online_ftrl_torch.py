"""Online learning on the PyTorch port: FTRL-proximal logistic regression
over an unbounded stream, warm-started from an offline model: continuous
mini-batch updates with a model version per update. Runs on an NVIDIA
GPU, or on the CPU with --device cpu:

    python examples/online_ftrl_torch.py [--device cpu] [--small]
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
    LogisticRegression,
    OnlineLogisticRegression,
)
from flinkml_tpu_torch.table import Table

rng = np.random.default_rng(1)
d = 16
true_coef = rng.normal(size=d)


def make_batch(n):
    x = rng.normal(size=(n, d))
    y = (x @ true_coef + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    return Table({"features": x, "label": y})


# --- Offline warm start ---------------------------------------------------
offline_table = make_batch(2000)
offline = (
    LogisticRegression().set_seed(0).set_max_iter(100)
    .set_global_batch_size(2000).fit(offline_table)
)

# --- Online phase: one FTRL update per arriving batch ---------------------
online = (
    OnlineLogisticRegression()
    .set_alpha(0.1)
    .set_beta(1.0)
    .set_reg(0.001)
    .set_elastic_net(0.5)
    .set_initial_model_data(*offline.get_model_data())
)
stream = (make_batch(256) for _ in range(20 if args.small else 50))
model = online.fit_stream(stream)
print("model version after stream:", model.model_version)

# --- The refreshed model still predicts the concept -----------------------
test = make_batch(1000)
(out,) = model.transform(test)
acc = float(np.mean(out["prediction"] == test["label"]))
print(f"online-updated accuracy: {acc:.3f}")
assert acc > 0.9
print("online_ftrl OK")
