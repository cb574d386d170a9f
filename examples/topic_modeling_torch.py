"""Topic modeling on the PyTorch port, end to end: Tokenizer ->
CountVectorizer -> LDA, with topic descriptions mapped back through the
fitted vocabulary. Runs on an NVIDIA GPU, or on the CPU with
--device cpu:

    python examples/topic_modeling_torch.py [--device cpu] [--small]
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

from flinkml_tpu_torch import Pipeline
from flinkml_tpu_torch.models import LDA, CountVectorizer, Tokenizer
from flinkml_tpu_torch.table import Table

rng = np.random.default_rng(0)
sports = ["game", "team", "score", "coach", "season", "player"]
cooking = ["recipe", "oven", "flour", "butter", "sauce", "bake"]
travel = ["flight", "hotel", "beach", "passport", "luggage", "tour"]
docs = []
for _ in range(300 if args.small else 600):
    pool = [sports, cooking, travel][int(rng.integers(0, 3))]
    docs.append(" ".join(rng.choice(pool, size=12)))
t = Table({"text": np.asarray(docs)})

prep = Pipeline([
    Tokenizer().set_input_col("text").set_output_col("tok"),
    CountVectorizer().set_input_col("tok").set_output_col("features"),
]).fit(t)
(tf,) = prep.transform(t)
vocab = prep.stages[1].vocabulary

lda = LDA().set_k(3).set_max_iter(15 if args.small else 30).set_seed(0) \
    .fit(tf)
desc = lda.describe_topics(4)
for r in range(3):
    words = [vocab[i] for i in desc["termIndices"][r]]
    weights = np.round(desc["termWeights"][r], 3)
    print(f"topic {r}: {list(zip(words, weights))}")

(out,) = lda.transform(tf)
mix = np.asarray(out["topicDistribution"][0])
print("doc 0 mixture:", np.round(mix, 3))
assert np.isclose(mix.sum(), 1.0, atol=1e-4)
print("topic_modeling OK")
