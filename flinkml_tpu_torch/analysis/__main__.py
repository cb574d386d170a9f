"""``python -m flinkml_tpu_torch.analysis`` — the ahead-of-time lint gate.

The port's counterpart of ``python -m flinkml_tpu.analysis``, with the
same directory walk, file routing, options and exit status. The passes
run device-free over the given targets:

  1. *graph validation*: every ``.py`` target (file or directory) is
     AST-linted for pipeline schema/ordering/collision findings;
  2. *collective order*: every ``*.trace.json`` target (a recorded
     dispatch trace, e.g. the threaded-kmeans deadlock fixture)
     is checked for unlocked concurrent collective dispatch;
  2b. *sharding plans*: every ``*.plan.json`` target (a declared
     ShardingPlan + mesh + param shapes, see
     ``docs/development/sharding.md``) is validated pre-compile —
     FML501-504;
  2c. *precision policies*: every ``*.policy.json`` target (a declared
     PrecisionPolicy, optionally with an example program and a plan
     width, see ``docs/development/precision.md``) runs the
     precision-flow pass — FML601-607;
  2d. *sorted-scatter provenance*: every ``*.scatter.json`` target (a
     declarative scatter probe with a declared pack-time sorted
     guarantee, see :mod:`flinkml_tpu_torch.analysis.sorted_scatter`) runs
     the FML404 walk;
  2e. *memory liveness*: every ``*.memory.json`` target (a mesh + plan
     + HBM budget + probe program and/or quant-tier ladder, see
     :mod:`flinkml_tpu_torch.analysis.memory`) runs the peak-live-bytes
     pass — FML701-704;
  3. *transfer/retrace self-check*: the fused four-scaler → LR chain is
     executed at several row counts inside one bucket under
     :class:`~flinkml_tpu_torch.analysis.guard.TransferRetraceGuard` —
     zero program builds, zero ``nvcc`` runs and one upload per transform,
     or findings. It runs on the port's default device, ``cuda``, and on
     the CPU with ``--device cpu``; with no card and no ``--device cpu``
     it raises, as every entry point of the port does (no fallback).

Exit status: 0 when clean, 1 on any error-severity finding (or on ANY
finding with ``--fail-on-findings``). ``--format json`` emits
machine-readable findings (rule, severity, location, message — what CI
annotates from; ``--json`` is the legacy spelling), ``--suppress
FML104,...`` drops rules, ``--rules`` prints the catalog,
``--no-selfcheck`` skips pass 3.
"""

from __future__ import annotations

import argparse
import os
import sys

from flinkml_tpu_torch.analysis.findings import RULES, Report


def _pass_lint(py_targets, report: Report) -> None:
    from flinkml_tpu_torch.analysis.ast_lint import lint_paths

    report.extend(lint_paths(py_targets))


def _pass_traces(trace_targets, report: Report) -> None:
    from flinkml_tpu_torch.analysis.collectives import (
        check_dispatch_trace,
        load_trace,
    )

    for path in trace_targets:
        report.extend(
            check_dispatch_trace(load_trace(path), location=path)
        )


def _pass_plans(plan_targets, report: Report) -> None:
    from flinkml_tpu_torch.analysis.sharding_check import check_plan_file

    for path in plan_targets:
        report.extend(check_plan_file(path))


def _pass_policies(policy_targets, report: Report) -> None:
    from flinkml_tpu_torch.analysis.precision import check_policy_file

    for path in policy_targets:
        report.extend(check_policy_file(path))


def _pass_scatters(scatter_targets, report: Report) -> None:
    from flinkml_tpu_torch.analysis.sorted_scatter import check_scatter_file

    for path in scatter_targets:
        report.extend(check_scatter_file(path))


def _pass_features(features_targets, report: Report) -> None:
    from flinkml_tpu_torch.analysis.features_check import check_features_file

    for path in features_targets:
        report.extend(check_features_file(path))


def _pass_memory(memory_targets, report: Report) -> None:
    from flinkml_tpu_torch.analysis.memory import check_memory_file

    for path in memory_targets:
        report.extend(check_memory_file(path))


#: extension -> pass runner. Adding a fixture type is ONE row here: the
#: CLI arg split and the directory walk both iterate this table, so a
#: new extension can never be routed by one and silently missed by the
#: other (the four copy-pasted walk loops this replaced did exactly
#: that dance by hand).
_FIXTURE_PASSES = (
    (".trace.json", _pass_traces),
    (".plan.json", _pass_plans),
    (".policy.json", _pass_policies),
    (".scatter.json", _pass_scatters),
    (".memory.json", _pass_memory),
    (".features.json", _pass_features),
)


def selfcheck_model(x, rng):
    """The bench's ``pipeline_fused`` chain over ``x`` (4 scalers + a
    LogisticRegressionModel with a seeded coefficient, the 5-stage
    all-kernel spine ``bench.py:602`` measures), as a PipelineModel."""
    import numpy as np

    from flinkml_tpu_torch.models.logistic_regression import (
        LogisticRegressionModel,
    )
    from flinkml_tpu_torch.models.scalers import (
        MaxAbsScalerModel,
        MinMaxScalerModel,
        RobustScalerModel,
        StandardScalerModel,
    )
    from flinkml_tpu_torch.pipeline import PipelineModel
    from flinkml_tpu_torch.table import Table

    d = x.shape[1]
    stages = []
    prev = "features"
    scaler_data = {
        StandardScalerModel: {"mean": x.mean(0)[None], "std": x.std(0)[None]},
        MinMaxScalerModel: {"dataMin": x.min(0)[None],
                            "dataMax": x.max(0)[None]},
        MaxAbsScalerModel: {"maxAbs": np.abs(x).max(0)[None]},
        RobustScalerModel: {"median": np.median(x, 0)[None],
                            "range": np.ones((1, d))},
    }
    for i, (cls, data) in enumerate(scaler_data.items(), start=1):
        m = cls().set(cls.INPUT_COL, prev).set(cls.OUTPUT_COL, f"s{i}")
        m.set_model_data(Table(data))
        stages.append(m)
        prev = f"s{i}"
    lr = LogisticRegressionModel().set(
        LogisticRegressionModel.FEATURES_COL, prev
    )
    lr.set_model_data(Table({"coefficient": rng.normal(size=(1, d))}))
    stages.append(lr)
    return PipelineModel(stages)


def _pass_retrace_selfcheck(report: Report, device) -> None:
    """Drive the selfcheck chain across varying batch sizes within one row
    bucket (and one boundary crossing) under a zero-budget guard, on
    ``device`` (None: the port's default, ``cuda``) — the runtime half of
    the bucket-policy contract."""
    import numpy as np

    from flinkml_tpu_torch.analysis.guard import TransferRetraceGuard
    from flinkml_tpu_torch.device import requested_device, use_device
    from flinkml_tpu_torch.table import Table

    rng = np.random.default_rng(0)
    n, d = 200, 8
    x = rng.normal(size=(n, d))
    table = Table({"features": x})
    pm = selfcheck_model(x, rng)

    with use_device(device if device is not None else requested_device()):
        # Warmup: one program for the 128-row bucket.
        pm.transform(table.slice(0, 100))
        guard = TransferRetraceGuard(
            allow_compiles=0,
            allow_new_buckets=True,          # crossing 128 -> 256 is policy
            allow_host_to_device=5,          # one declared upload per table
            allow_device_to_host=0,          # nothing reads back in the loop
            raise_on_violation=False,
            location="selfcheck:pipeline_fused",
        )
        with guard:
            for rows in (100, 77, 96, 128):  # same bucket: no build
                pm.transform(table.slice(0, rows))
            pm.transform(table.slice(0, 129))  # new bucket: allowed
    report.extend(guard.findings)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flinkml_tpu_torch.analysis",
        description="Ahead-of-time pipeline validation, collective-order "
                    "checking, and a transfer/retrace lint gate.",
    )
    parser.add_argument(
        "targets", nargs="*",
        help=".py files / directories to lint, *.trace.json dispatch "
             "traces, *.plan.json sharding plans, *.policy.json "
             "precision policies, *.scatter.json sorted-scatter "
             "probes, and *.memory.json memory-liveness targets to "
             "check",
    )
    parser.add_argument(
        "--fail-on-findings", action="store_true",
        help="exit non-zero on ANY finding (default: errors only)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default=None,
        help="output format: human-readable text (default) or "
             "machine-readable JSON findings (rule, severity, location, "
             "message) for CI annotation",
    )
    parser.add_argument("--json", action="store_true",
                        help="emit findings as JSON (legacy spelling of "
                             "--format json)")
    parser.add_argument(
        "--suppress", default="",
        help="comma-separated rule ids to drop (e.g. FML104,FML106)",
    )
    parser.add_argument("--rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument(
        "--no-selfcheck", action="store_true",
        help="skip the transfer/retrace executor self-check pass",
    )
    parser.add_argument(
        "--device", default=None,
        help="device of the self-check (default: the port's, cuda)",
    )
    args = parser.parse_args(argv)

    if args.rules:
        for rule, (sev, desc) in sorted(RULES.items()):
            print(f"{rule} [{sev}] {desc}")
        return 0

    py_targets: list = []
    buckets: dict = {ext: [] for ext, _runner in _FIXTURE_PASSES}
    for t in args.targets:
        for ext, _runner in _FIXTURE_PASSES:
            if t.endswith(ext):
                buckets[ext].append(t)
                break
        else:
            py_targets.append(t)
            if os.path.isdir(t):
                for root, _dirs, names in os.walk(t):
                    for n in sorted(names):
                        for ext, _runner in _FIXTURE_PASSES:
                            if n.endswith(ext):
                                buckets[ext].append(os.path.join(root, n))
                                break

    report = Report()
    if py_targets:
        _pass_lint(py_targets, report)
    for ext, runner in _FIXTURE_PASSES:
        if buckets[ext]:
            runner(buckets[ext], report)
    if not args.no_selfcheck:
        _pass_retrace_selfcheck(report, args.device)

    if args.suppress:
        report = report.suppress(
            [r.strip() for r in args.suppress.split(",") if r.strip()]
        )

    if args.json or args.format == "json":
        print(report.to_json())
    else:
        print(report.render())

    if args.fail_on_findings:
        return 1 if report else 0
    return 1 if report.errors() else 0


if __name__ == "__main__":
    sys.exit(main())
