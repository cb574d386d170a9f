"""Fixture parity and the CLI of ``flinkml_tpu_torch.analysis``.

For every file of ``tests/analysis_fixtures/`` (the JAX package's seeded
fixtures; each name declares its expected rule), the port's ``check_*_file``,
lint and trace checks give the same rule ids and counts as the JAX
package's passes run on the same file here. The port's CLI on the
directory exits non-zero with ``--fail-on-findings`` and lists the same
rules as the JAX package's CLI; its retrace self-check runs on the CPU
with ``--device cpu`` and refuses the card's default device on a host
without one.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from flinkml_tpu_torch.analysis import Report
from flinkml_tpu_torch.analysis.__main__ import _pass_retrace_selfcheck
from flinkml_tpu_torch.analysis.__main__ import main as port_main

from tests._torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
NAMES = sorted(os.listdir(FIXTURES))


def _check(pkg: str, path: str):
    """The findings of ``pkg``'s pass for one fixture file (the CLI's
    routing by extension)."""
    a = pkg + ".analysis"
    if path.endswith(".py"):
        mod = __import__(a + ".ast_lint", fromlist=["lint_paths"])
        return list(mod.lint_paths([path]))
    if path.endswith(".trace.json"):
        mod = __import__(a + ".collectives", fromlist=["load_trace"])
        return mod.check_dispatch_trace(mod.load_trace(path), location=path)
    routes = {".plan.json": ("sharding_check", "check_plan_file"),
              ".policy.json": ("precision", "check_policy_file"),
              ".scatter.json": ("sorted_scatter", "check_scatter_file"),
              ".memory.json": ("memory", "check_memory_file"),
              ".features.json": ("features_check", "check_features_file")}
    for ext, (module, fn) in routes.items():
        if path.endswith(ext):
            mod = __import__(f"{a}.{module}", fromlist=[fn])
            return getattr(mod, fn)(path)
    raise AssertionError(f"no pass routes {path}")


def _counts(findings):
    return dict(collections.Counter(f.rule for f in findings))


@pytest.mark.parametrize("name", NAMES)
def test_fixture_rules_equal_the_jax_passes(name):
    path = os.path.join(FIXTURES, name)
    want = _counts(_check("flinkml_tpu", path))
    got = _counts(_check("flinkml_tpu_torch", path))
    assert got == want
    # A seeded fixture's name declares a rule it must raise ("50x": any
    # of the band).
    if name.startswith("bad_") and "_fml" in name:
        rule = "FML" + name.split("_fml")[1][:3]
        assert any(r.startswith(rule.rstrip("x")) for r in got), (rule, got)
    elif name.startswith("good_") or name.endswith("_locked.trace.json"):
        assert got == {}


def _cli(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(args))
    return rc, buf.getvalue()


def test_cli_directory_walk_same_rules_as_jax():
    from flinkml_tpu.analysis.__main__ import main as jax_main

    rc, out = _cli(port_main, FIXTURES, "--no-selfcheck", "--format",
                   "json", "--fail-on-findings")
    jrc, jout = _cli(jax_main, FIXTURES, "--no-selfcheck", "--format",
                     "json", "--fail-on-findings")
    assert rc == jrc == 1
    port = collections.Counter(r["rule"] for r in json.loads(out))
    jax = collections.Counter(r["rule"] for r in json.loads(jout))
    assert port == jax
    assert {"rule", "severity", "location", "message"} <= set(
        json.loads(out)[0])


def test_cli_single_files_text_and_suppress():
    fixture = os.path.join(FIXTURES,
                           "bad_precision_fml604_bf16_psum.policy.json")
    rc, out = _cli(port_main, fixture, "--no-selfcheck")
    assert rc == 1 and "FML604" in out
    with pytest.raises(json.JSONDecodeError):
        json.loads(out)
    rc, out = _cli(port_main, fixture, "--no-selfcheck", "--suppress",
                   "FML604")
    assert rc == 0 and out.strip() == "no findings"
    # FML703 is a warning: exit 0 unless --fail-on-findings.
    undonated = os.path.join(FIXTURES,
                             "bad_memory_fml703_undonated.memory.json")
    assert _cli(port_main, undonated, "--no-selfcheck")[0] == 0
    assert _cli(port_main, undonated, "--no-selfcheck",
                "--fail-on-findings")[0] == 1


def test_cli_rules_catalog_equals_jax():
    from flinkml_tpu.analysis.findings import RULES as JAX_RULES
    from flinkml_tpu_torch.analysis.findings import RULES

    assert RULES == JAX_RULES and len(RULES) == 34
    rc, out = _cli(port_main, "--rules")
    assert rc == 0 and len(out.strip().splitlines()) == 34


def test_cli_module_on_the_cpu_selfcheck_included():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "flinkml_tpu_torch.analysis", FIXTURES,
         "--fail-on-findings", "--device", "cpu", "--format", "json"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    rules = {r["rule"] for r in json.loads(proc.stdout)}
    assert {"FML102", "FML107", "FML302", "FML404", "FML505", "FML601",
            "FML701", "FML704"} <= rules
    # The self-check itself is clean on the CPU.
    assert not rules & {"FML401", "FML402", "FML403"}


def test_selfcheck_clean_on_cpu_and_refuses_a_missing_card():
    import torch

    report = Report()
    _pass_retrace_selfcheck(report, "cpu")
    assert list(report) == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _pass_retrace_selfcheck(Report(), "cuda")


@pytest.mark.parametrize("ext,rule", [
    (".memory.json", "FML701"), (".policy.json", "FML601"),
    (".scatter.json", "FML404"), (".features.json", "FML505"),
])
def test_malformed_files_fail_loudly(tmp_path, ext, rule):
    bad = tmp_path / ("broken" + ext)
    bad.write_text("{not json")
    got = _check("flinkml_tpu_torch", str(bad))
    assert [f.rule for f in got] == [rule]
    assert [f.rule for f in _check("flinkml_tpu", str(bad))] == [rule]


def test_bad_programs_fail_loudly(tmp_path):
    from flinkml_tpu_torch.analysis.memory import check_memory_file
    from flinkml_tpu_torch.analysis.precision import check_policy_file

    empty = tmp_path / "empty.memory.json"
    empty.write_text("{}")
    assert [f.rule for f in check_memory_file(str(empty))] == ["FML701"]
    badprog = tmp_path / "prog.memory.json"
    badprog.write_text(json.dumps({"program": {"name": "nonsense_step"}}))
    assert [f.rule for f in check_memory_file(str(badprog))] == ["FML701"]
    p2 = tmp_path / "badprog.policy.json"
    p2.write_text(json.dumps({"policy": {"name": "mixed"},
                              "program": {"name": "nope"}}))
    assert "bad program" in check_policy_file(str(p2))[0].message
    # A loss name the step checks only when it runs: still one finding.
    p3 = tmp_path / "badloss.policy.json"
    p3.write_text(json.dumps({"policy": {"name": "mixed"},
                              "program": {"name": "sgd_step",
                                          "loss": "bogus"}}))
    (f3,) = check_policy_file(str(p3))
    assert f3.rule == "FML601" and "bad program" in f3.message


def test_lint_resolves_port_stages_for_a_port_script(tmp_path):
    from flinkml_tpu_torch.analysis import lint_source

    src = open(os.path.join(FIXTURES, "bad_pipeline.py")).read().replace(
        "flinkml_tpu.", "flinkml_tpu_torch.")
    got = _counts(lint_source(src, "port_pipeline.py"))
    assert got == _counts(_check("flinkml_tpu",
                                 os.path.join(FIXTURES, "bad_pipeline.py")))
