"""High-cardinality categorical features on the PyTorch port, end to end:
sparse one-hot encoding (SparseVector per row) into the nnz-bucketed
sparse LogisticRegression trainer. The dense one-hot layout would need
n x cardinality floats; everything here is O(nnz). Runs on an NVIDIA GPU,
or on the CPU with --device cpu:

    python examples/sparse_high_cardinality_torch.py [--device cpu] [--small]
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

from flinkml_tpu_torch.linalg import Vectors
from flinkml_tpu_torch.models import LogisticRegression, OneHotEncoder
from flinkml_tpu_torch.pipeline import Pipeline
from flinkml_tpu_torch.table import Table

CARDINALITY = 1_000_000
rng = np.random.default_rng(11)
n = 500 if args.small else 2000

categories = rng.integers(0, CARDINALITY, size=n).astype(np.float64)
categories[0] = CARDINALITY - 1  # pin the max so the fitted size is full
labels = (categories >= CARDINALITY // 2).astype(np.float64)
table = Table({"cat": categories, "label": labels})

dense_gib = n * CARDINALITY * 8 / 2**30
print(f"dense one-hot would be {dense_gib:,.0f} GiB; sparse is O(n)")

pipeline = Pipeline([
    OneHotEncoder()
    .set_input_cols(["cat"])
    .set_output_cols(["features"])
    .set_drop_last(False)
    .set_output_format("sparse"),   # reference SparseVector encoding
    LogisticRegression()
    .set_seed(0)
    .set_max_iter(100 if args.small else 200)
    .set_learning_rate(5.0)
    .set_global_batch_size(n),      # full batch: memorization regime
])
model = pipeline.fit(table)
(out,) = model.transform(table)
acc = float(np.mean(out["prediction"] == labels))
print(f"train accuracy at cardinality {CARDINALITY:,}: {acc:.3f}")
assert acc > 0.95


# -- the streamed variant: datasets LARGER THAN RAM at the same dim -------
# SparseVector feature streams cache and train AS CSR (O(nnz) on disk and
# on the device). Same estimator, same params; the input is an iterable
# of batch Tables instead of one Table.
def sparse_batches(n_batches=4, rows=256):
    r = np.random.default_rng(7)
    for _ in range(n_batches):
        cats = r.integers(0, CARDINALITY, size=rows)
        vecs = np.array(
            [Vectors.sparse(CARDINALITY, [c], [1.0]) for c in cats],
            dtype=object,
        )
        y = (cats >= CARDINALITY // 2).astype(np.float64)
        yield Table({"features": vecs, "label": y})


streamed = (
    LogisticRegression()
    .set_seed(0).set_max_iter(5 if args.small else 30).set_learning_rate(5.0)
    .fit(sparse_batches(n_batches=2 if args.small else 4))
)
coef = streamed.get_model_data()[0].column("coefficient")[0]
print(f"streamed sparse fit at cardinality {CARDINALITY:,}: "
      f"coef shape {np.asarray(coef).shape} (cache cost is O(nnz))")
print("sparse_high_cardinality OK")
