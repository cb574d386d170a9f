"""Gradient-boosted trees on the PyTorch port, on a nonlinear task a
linear model cannot fit. Runs on an NVIDIA GPU, or on the CPU with
--device cpu:

    python examples/gbt_nonlinear_torch.py [--device cpu] [--small]
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
    BinaryClassificationEvaluator,
    GBTClassifier,
    LogisticRegression,
    RandomSplitter,
)
from flinkml_tpu_torch.table import Table

rng = np.random.default_rng(0)
n = 1500 if args.small else 4000
x = rng.uniform(-2, 2, size=(n, 6))
# XOR-of-signs interaction + a sinusoid: zero linear signal.
logits = 3.0 * (x[:, 0] * x[:, 1] > 0) - 1.5 + np.sin(3 * x[:, 2])
y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
data = Table({"features": x, "label": y})
train, test = RandomSplitter().set_weights([0.8, 0.2]).set_seed(0) \
    .transform(data)

gbt = (
    GBTClassifier().set_num_trees(15 if args.small else 40).set_max_depth(4)
    .set_learning_rate(0.2).set_seed(0)
)
model = gbt.fit(train)
(pred,) = model.transform(test)

lr = (
    LogisticRegression().set_max_iter(60).set_global_batch_size(1024)
    .set_learning_rate(1.0).set_seed(0)
)
(lr_pred,) = lr.fit(train).transform(test)

ev = BinaryClassificationEvaluator().set_metrics_names(["areaUnderROC"])
(gbt_auc,) = ev.transform(pred)
(lr_auc,) = ev.transform(lr_pred)
print(f"GBT holdout AUC: {gbt_auc['areaUnderROC'][0]:.3f}   "
      f"(linear baseline: {lr_auc['areaUnderROC'][0]:.3f})")
assert gbt_auc["areaUnderROC"][0] > lr_auc["areaUnderROC"][0] + 0.1
print("gbt_nonlinear OK")
