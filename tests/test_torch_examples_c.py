"""The PyTorch port's examples, part 3 (see ``test_torch_examples_a``):
the multi-process ones run two gloo ranks on the CPU."""

from __future__ import annotations

from tests._torch_examples import number, run_port


def test_topic_modeling_example():
    out = run_port("topic_modeling", "--device", "cpu", "--small")
    assert out.count("topic ") == 3 and "doc 0 mixture:" in out


def test_recommend_als_example():
    out = run_port("recommend_als", "--device", "cpu", "--small")
    assert number(out, "explicit ALS in-sample RMSE:") < 0.5
    assert number(out, "implicit ALS top-5 hit rate vs true taste:") > 0.5


def test_parallel_primitives_example():
    out = run_port("parallel_primitives", "--device", "cpu", "--small")
    assert "all_reduce_sum: [0. 1. 2. 3.]" in out
    assert number(out, "host_barrier participants:") == 1


def test_multihost_streamed_fit_example():
    out = run_port("multihost_streamed_fit", "--device", "cpu", "--small")
    assert "both ranks fitted the identical model" in out


def test_multihost_pod_example():
    out = run_port("multihost_pod", "--device", "cpu", "--small")
    assert out.count("POD_OK") == 2 and "LOCAL DEMO OK (2 ranks)" in out


def test_examples_import_neither_jax_nor_the_jax_package():
    """Every ``examples/*_torch.py`` imports only the port, torch, numpy
    and the standard library: no ``jax``, no ``flinkml_tpu``."""
    import ast
    import glob
    import os
    import sys

    from tests._torch_examples import EXAMPLES, SCRIPTS

    paths = sorted(glob.glob(os.path.join(EXAMPLES, "*_torch.py")))
    assert [os.path.basename(p)[:-9] for p in paths] == sorted(SCRIPTS)
    allowed = {"flinkml_tpu_torch", "torch", "numpy"} | set(
        sys.stdlib_module_names)
    for path in paths:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path, name)
