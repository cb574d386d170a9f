"""Three of the PyTorch port's examples against their JAX counterparts,
run at the JAX script's size on the CPU, their printed numbers compared.

The JAX scripts run unchanged, as ``examples/<name>.py`` in a
subprocess with ``JAX_PLATFORMS=cpu``; ``train_logistic_regression``'s
with the JAX package's fused executor off (it needs
``jax.experimental.enable_x64``, which this jax no longer has), so its
pipeline runs stage by stage. Stated tolerances: the LR example's AUC
within 5e-3 and accuracy within 1e-2 (the same data; float32 against
JAX's float32 SGD, summed in another order); KMeans' cluster sizes equal
and its sorted centroids within 0.01 (printed to 2 decimals); the sparse
example's train accuracy equal and its coefficient shape equal.
"""

from __future__ import annotations

import os
import re
import sys

from tests._torch_examples import EXAMPLES, number, run, run_port

_FUSION_OFF = (
    "import runpy, sys\n"
    "from flinkml_tpu import pipeline_fusion\n"
    "pipeline_fusion.set_enabled(False)\n"
    "sys.argv = [sys.argv[1]]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
)


def _jax(name: str) -> str:
    script = os.path.join(EXAMPLES, f"{name}.py")
    return run([sys.executable, "-c", _FUSION_OFF, script],
               env_extra={"JAX_PLATFORMS": "cpu"})


def test_train_logistic_regression_matches_jax():
    want = _jax("train_logistic_regression")
    got = run_port("train_logistic_regression", "--device", "cpu")
    assert abs(number(got, "AUC:") - number(want, "AUC:")) <= 5e-3
    assert abs(number(got, "accuracy:") - number(want, "accuracy:")) <= 1e-2
    assert "save/load round-trip OK" in got and "round-trip OK" in want


def _centroids(out: str):
    block = out.split("learned centroids (sorted):")[1]
    return [float(v) for v in re.findall(r"-?\d+\.\d+", block)[:6]]


def test_train_kmeans_matches_jax():
    want = _jax("train_kmeans")
    got = run_port("train_kmeans", "--device", "cpu")
    sizes = re.compile(r"cluster sizes: \[([\d ]+)\]")
    assert sorted(sizes.search(got).group(1).split()) == \
        sorted(sizes.search(want).group(1).split())
    for g, w in zip(_centroids(got), _centroids(want)):
        assert abs(g - w) <= 0.01 + 1e-9
    assert number(got, "adjusted Rand vs a second KMeans (seed 1):") == 1.0


def test_sparse_high_cardinality_matches_jax():
    want = _jax("sparse_high_cardinality")
    got = run_port("sparse_high_cardinality", "--device", "cpu")
    label = "train accuracy at cardinality 1,000,000:"
    assert number(got, label) == number(want, label)
    shape = "coef shape (1000000,)"
    assert shape in got and shape in want
