"""Running the PyTorch port's example scripts (``examples/*_torch.py``) in
subprocesses, for ``tests/test_torch_examples_*.py``."""

from __future__ import annotations

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

#: Every ported example, in the order they were ported.
SCRIPTS = ("train_logistic_regression", "sparse_high_cardinality",
           "serve_pipeline", "train_kmeans", "streamed_out_of_core_fit",
           "checkpoint_resume", "online_ftrl", "clustering_tour",
           "gbt_nonlinear", "text_classification", "topic_modeling",
           "recommend_als", "parallel_primitives", "multihost_streamed_fit",
           "multihost_pod")
#: Extra arguments a script takes in the tests (the pod's two-rank demo).
EXTRA = {"multihost_pod": ("--local-demo",)}
TIMEOUT_S = 240


def run(argv, env_extra=None, timeout=TIMEOUT_S) -> str:
    """``argv`` in a subprocess from the repo root, torch's threads capped
    (the tests run beside other workers); its standard output, or an
    assertion with both streams when it fails."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.update(env_extra or {})
    proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, (
        f"{argv} exited {proc.returncode}\n{proc.stdout[-3000:]}\n"
        f"{proc.stderr[-5000:]}")
    return proc.stdout


def run_port(name: str, *args: str) -> str:
    """The port's example ``name`` with ``args``; checks that its last line
    is its OK token."""
    script = os.path.join(EXAMPLES, f"{name}_torch.py")
    out = run([sys.executable, script, *EXTRA.get(name, ()), *args])
    assert out.strip().splitlines()[-1] == f"{name} OK", out[-2000:]
    return out


def number(out: str, label: str) -> float:
    """The first number after ``label`` in ``out``."""
    m = re.search(re.escape(label) + r"\s*([-+0-9.eE]+)", out)
    assert m, f"{label!r} not in:\n{out[-2000:]}"
    return float(m.group(1))
