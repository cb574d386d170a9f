"""Structured findings — the common currency of every analysis pass.

The port's copy of ``flinkml_tpu.analysis.findings`` (framework-neutral,
so copied rather than imported). :class:`Finding` is also
:class:`flinkml_tpu_torch.precision.Finding`, the class the plan and
precision checks raised before the analysis passes were ported.

Each pass (graph validator, collective-order checker, transfer/retrace
guard) reports :class:`Finding`s: a stable rule id from :data:`RULES`, a
severity, the stage/column the finding anchors to, and a fix hint. A
:class:`Report` aggregates findings, applies suppressions, and renders
them for humans (CLI) or machines (``--format json``).

Rule ids are permanent: a released id is never reused for a different
check, so suppression lists stay meaningful across versions. Add new
rules at the end of their band (1xx schema, 2xx graph wiring, 3xx
collectives, 4xx transfer/retrace, 5xx sharding plans, 6xx precision
flow, 7xx memory liveness).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Optional, Sequence

ERROR = "error"
WARNING = "warning"

#: Rule catalog: id -> (default severity, one-line description).
RULES = {
    # -- 1xx: schema / pipeline validation ---------------------------------
    "FML101": (ERROR, "stage reads a column absent from its input schema"),
    "FML102": (WARNING, "stage output column silently overwrites an existing column"),
    "FML103": (ERROR, "stage kernel fails abstract evaluation (shape/dtype mismatch)"),
    "FML104": (WARNING, "non-fusable stage breaks a kernel chain into separate programs"),
    "FML105": (ERROR, "transform_kernel fingerprint is not stable across calls"),
    "FML106": (WARNING, "silent dtype promotion: output column is wider than every input"),
    "FML107": (ERROR, "stage consumes a column that only a later stage produces"),
    # -- 2xx: graph wiring -------------------------------------------------
    "FML201": (ERROR, "graph node input TableId is never produced (cycle or missing input)"),
    "FML202": (ERROR, "graph output TableId is never produced by any node"),
    "FML203": (ERROR, "two graph nodes claim the same output TableId"),
    # -- 3xx: collectives --------------------------------------------------
    "FML301": (ERROR, "cross-rank collective sequences diverge (rendezvous mismatch)"),
    "FML302": (ERROR, "concurrent multi-device collective dispatch without a common lock"),
    "FML303": (ERROR, "serving replica-pool mesh slice overlaps a concurrent dispatch without a shared slice lock"),
    "FML304": (ERROR, "serving replica-pool dispatch on devices under an active training slice lease that was never reclaimed"),
    # -- 4xx: transfer / retrace guard -------------------------------------
    "FML401": (ERROR, "host<->device transfer beyond the declared budget in a guarded region"),
    "FML402": (ERROR, "compile-cache miss beyond the declared bucket policy in a guarded region"),
    "FML403": (ERROR, "two compiles share input specs and bucket but differ in chain fingerprint"),
    "FML404": (ERROR, "scatter-add traced with indices_are_sorted=False over indices carrying the pack-time sorted guarantee (re-pays the sort every step)"),
    # -- 5xx: sharding plans -----------------------------------------------
    "FML501": (ERROR, "sharding plan references an unknown mesh axis (or uses one illegally)"),
    "FML502": (ERROR, "mesh axis size does not divide the parameter dimension it shards"),
    "FML503": (ERROR, "replicated parameter (+ optimizer state) exceeds the per-device HBM budget"),
    "FML504": (ERROR, "two sharding plans in one program imply conflicting collective orders"),
    "FML505": (ERROR, "hash front-end num_buckets does not match the embedding table's vocab rows"),
    # -- 6xx: precision flow -------------------------------------------------
    "FML601": (ERROR, "reduction/accumulation (sum, dot accumulator, state update) runs narrower than policy.accum"),
    "FML602": (ERROR, "silent upcast in the compute region: a strong wide constant promotes policy.compute work"),
    "FML603": (ERROR, "parameter or optimizer-state leaf stored narrower than policy.params"),
    "FML604": (ERROR, "cross-rank collective runs narrower than policy.accum without an explicit pre-cast"),
    "FML605": (ERROR, "sharding-plan HBM math assumed a parameter width different from policy.params"),
    "FML606": (ERROR, "quantized (int8) parameters accumulate at integer width without a dequant scale"),
    "FML607": (ERROR, "int8-quantized parameter leaf served under a non-quantized policy (degraded params republished as the full-width tier)"),
    # -- 7xx: memory liveness ----------------------------------------------
    "FML701": (ERROR, "estimated per-device peak live bytes exceed the HBM budget"),
    "FML702": (ERROR, "vocab-scale intermediate materialized on the hot path (the embedding contract promises batch-sized payloads)"),
    "FML703": (WARNING, "same-shape parameter/carry update whose input buffer is not donated (missed donate_argnums doubles peak at the worst moment)"),
    "FML704": (ERROR, "no quant tier in the f32 -> bf16 -> int8 ladder fits the per-device HBM budget"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result, anchored to a rule and (optionally) a stage."""

    rule: str
    message: str
    stage: Optional[str] = None
    column: Optional[str] = None
    fix_hint: Optional[str] = None
    location: Optional[str] = None

    @property
    def severity(self) -> str:
        return RULES.get(self.rule, (ERROR, ""))[0]

    def render(self) -> str:
        where = " @ ".join(p for p in (self.location, self.stage) if p)
        head = f"{self.rule} [{self.severity}]"
        if where:
            head += f" {where}"
        if self.column:
            head += f" (column {self.column!r})"
        out = f"{head}: {self.message}"
        if self.fix_hint:
            out += f"\n    fix: {self.fix_hint}"
        return out

    def to_map(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "message": self.message,
            "stage": self.stage,
            "column": self.column,
            "fixHint": self.fix_hint,
            "location": self.location,
        }


class Report:
    """An ordered collection of findings with suppression filtering."""

    def __init__(self, findings: Iterable[Finding] = ()):
        self.findings: List[Finding] = list(findings)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def suppress(self, rules: Sequence[str]) -> "Report":
        dropped = set(rules)
        return Report(f for f in self.findings if f.rule not in dropped)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    def __bool__(self) -> bool:
        return bool(self.findings)

    def render(self) -> str:
        if not self.findings:
            return "no findings"
        lines = [f.render() for f in self.findings]
        lines.append(
            f"{len(self.errors())} error(s), {len(self.warnings())} warning(s)"
        )
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps([f.to_map() for f in self.findings], indent=2)
