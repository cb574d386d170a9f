"""The PyTorch port's examples, part 2 (see ``test_torch_examples_a``)."""

from __future__ import annotations

import pytest

from tests._torch_examples import number, run_port


def test_checkpoint_resume_example():
    out = run_port("checkpoint_resume", "--device", "cpu", "--small")
    assert "checkpoints on disk: [12, 24]" in out
    assert "resumed coefficients are exactly the uninterrupted result" in out


@pytest.mark.parametrize("name,label,floor", [
    ("online_ftrl", "online-updated accuracy:", 0.9),
    ("clustering_tour", "PIC ARI=", 0.99),
    ("gbt_nonlinear", "GBT holdout AUC:", 0.7),
])
def test_example_headline(name, label, floor):
    out = run_port(name, "--device", "cpu", "--small")
    assert number(out, label) > floor


def test_text_classification_example():
    out = run_port("text_classification", "--device", "cpu", "--small")
    assert number(out, "in-sample accuracy:") > 0.95
    assert "cv AUCs: [1.0," in out
