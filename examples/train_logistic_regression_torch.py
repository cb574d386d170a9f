"""End-to-end example on the PyTorch port: CSV -> pipeline (assemble +
scale + LR) -> evaluate -> save/load. Runs on an NVIDIA GPU, or on the CPU
with --device cpu:

    python examples/train_logistic_regression_torch.py [--device cpu] [--small]
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

from flinkml_tpu_torch.io import read_csv_table
from flinkml_tpu_torch.models import (
    BinaryClassificationEvaluator,
    LogisticRegression,
    StandardScaler,
    VectorAssembler,
)
from flinkml_tpu_torch.pipeline import Pipeline, PipelineModel

# --- Synthesize a CSV (stand-in for your data file) ----------------------
rng = np.random.default_rng(0)
n, d = (1000, 12) if args.small else (5000, 12)
x = rng.normal(size=(n, d))
y = (x @ rng.normal(size=d) + 0.3 * rng.normal(size=n) > 0).astype(int)
header = ",".join([f"f{i}" for i in range(d)] + ["label"])
rows = "\n".join(
    ",".join(f"{v:.6g}" for v in row) + f",{lab}" for row, lab in zip(x, y)
)
workdir = tempfile.mkdtemp(prefix="example_train_")
csv_path = os.path.join(workdir, "example_train.csv")
with open(csv_path, "w") as f:
    f.write(header + "\n" + rows + "\n")

# --- Ingest (native multithreaded parser) --------------------------------
table = read_csv_table(csv_path)

# --- Pipeline: assemble feature columns -> standardize -> train ----------
pipe = Pipeline([
    VectorAssembler().set_input_cols([f"f{i}" for i in range(d)])
                     .set(VectorAssembler.OUTPUT_COL, "input"),
    StandardScaler(),
    LogisticRegression().set_features_col("output").set_label_col("label")
                        .set_max_iter(30 if args.small else 100)
                        .set_learning_rate(0.5)
                        .set_global_batch_size(4096).set_reg(0.01)
                        .set_seed(42),
])
model = pipe.fit(table)

# --- Score + evaluate ----------------------------------------------------
(scored,) = model.transform(table)
(metrics,) = (
    BinaryClassificationEvaluator()
    .set(BinaryClassificationEvaluator.METRICS_NAMES,
         ["areaUnderROC", "accuracy"])
    .transform(scored)
)
print("AUC:", float(metrics.column("areaUnderROC")[0]))
print("accuracy:", float(metrics.column("accuracy")[0]))

# --- Persist and reload --------------------------------------------------
with tempfile.TemporaryDirectory() as td:
    path = os.path.join(td, "model")
    model.save(path)
    reloaded = PipelineModel.load(path)
    (rescored,) = reloaded.transform(table)
    assert np.array_equal(
        np.asarray(rescored.column("prediction")),
        np.asarray(scored.column("prediction")),
    )
    print("save/load round-trip OK")
os.remove(csv_path)
os.rmdir(workdir)
print("train_logistic_regression OK")
