"""The PyTorch port's examples, part 1: each runs on the CPU
(``--device cpu --small``) in a subprocess, prints its headline numbers
and ends with its OK token (the scripts also keep their JAX
counterparts' own checks: the save/load round trips, the accuracy
floors)."""

from __future__ import annotations

import pytest

from tests._torch_examples import number, run_port


def test_train_logistic_regression_example():
    out = run_port("train_logistic_regression", "--device", "cpu", "--small")
    assert number(out, "AUC:") > 0.98
    assert number(out, "accuracy:") > 0.9
    assert "save/load round-trip OK" in out


def test_sparse_high_cardinality_example():
    out = run_port("sparse_high_cardinality", "--device", "cpu", "--small")
    assert number(out, "train accuracy at cardinality 1,000,000:") > 0.95
    assert "coef shape (1000000,)" in out


def test_serve_pipeline_example():
    out = run_port("serve_pipeline", "--device", "cpu", "--small")
    assert "zero dropped, zero mis-versioned" in out
    assert number(out, "published v") == 1
    assert "serving example OK" in out


@pytest.mark.parametrize("name,label,floor", [
    ("train_kmeans", "adjusted Rand vs a second KMeans (seed 1):", 0.99),
    ("streamed_out_of_core_fit", "held-out accuracy after out-of-core fit:",
     0.95),
])
def test_example_headline(name, label, floor):
    out = run_port(name, "--device", "cpu", "--small")
    assert number(out, label) > floor
