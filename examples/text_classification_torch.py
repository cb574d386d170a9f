"""Text classification on the PyTorch port, end to end: tokenize -> stop
words -> TF-IDF -> sparse LogisticRegression, all in one Pipeline, with
cross-validated vocabulary pruning. Runs on an NVIDIA GPU, or on the CPU
with --device cpu:

    python examples/text_classification_torch.py [--device cpu] [--small]
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

from flinkml_tpu_torch import CrossValidator, ParamGridBuilder, Pipeline
from flinkml_tpu_torch.models import (
    IDF,
    BinaryClassificationEvaluator,
    CountVectorizer,
    LogisticRegression,
    StopWordsRemover,
    Tokenizer,
)
from flinkml_tpu_torch.table import Table

rng = np.random.default_rng(0)
pos = ["great", "superb", "loved", "excellent", "wonderful"]
neg = ["awful", "boring", "hated", "terrible", "dreadful"]
filler = ["the", "movie", "was", "and", "a", "it", "film", "plot"]
docs, labels = [], []
for _ in range(200 if args.small else 400):
    y = int(rng.integers(0, 2))
    words = list(rng.choice(pos if y else neg, 3)) + list(
        rng.choice(filler, 6))
    rng.shuffle(words)
    docs.append(" ".join(words))
    labels.append(float(y))
data = Table({"text": np.asarray(docs), "label": np.asarray(labels)})

cv_stage = CountVectorizer().set_input_col("clean").set_output_col("tf")
pipe = Pipeline([
    Tokenizer().set_input_col("text").set_output_col("tok"),
    StopWordsRemover().set_input_cols(["tok"]).set_output_cols(["clean"]),
    cv_stage,
    IDF().set_input_col("tf").set_output_col("features"),
    LogisticRegression().set_max_iter(30 if args.small else 60)
    .set_global_batch_size(512).set_learning_rate(1.0).set_seed(0),
])

# minDF as a fraction: 0.45 requires terms in 45% of documents, which
# drops the (class-specific, ~30%-frequency) sentiment words and keeps
# only filler; cross-validation must catch that over-pruning.
grid = (
    ParamGridBuilder()
    .add_grid(cv_stage, CountVectorizer.MIN_DF, [1.0, 0.45])
    .build()
)
tuner = CrossValidator(pipe, grid, BinaryClassificationEvaluator())
tuner.set_num_folds(3).set_seed(0)
model = tuner.fit(data)
(pred,) = model.transform(data)
acc = (pred["prediction"] == data["label"]).mean()
print(f"best grid point: {model.param_maps_description[model.best_index]}")
print(f"cv AUCs: {[round(m, 4) for m in model.avg_metrics]}")
print(f"in-sample accuracy: {acc:.3f}")
assert model.best_index == 0 and acc > 0.95
print("text_classification OK")
