"""All fifteen of the PyTorch port's examples on the card, at their
default (the JAX scripts') sizes, each in a subprocess with
``--device cuda``; the multi-process ones run two gloo ranks on the one
card. Each must exit 0 and end with its OK token. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_examples_cuda.py -m cuda --noconftest -q
"""

from __future__ import annotations

import pytest
import torch

from tests._torch_examples import SCRIPTS, run_port

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_on_card(cuda_device, name):
    out = run_port(name, "--device", "cuda")
    assert out.strip().splitlines()[-1] == f"{name} OK"
