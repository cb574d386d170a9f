"""Collective order: the cross-rank comparator (FML301).

The port's copy of the framework-neutral part of
``flinkml_tpu.analysis.collectives``. Rendezvous collectives need every
participant to reach the same collectives in the same order; ranks (or
plans) whose ordered :class:`CollectiveOp` sequences differ would wait in
different collectives forever. :func:`check_rank_order` compares the
sequences. The JAX package's extraction of a sequence from a jaxpr and its
dispatch-trace checks (FML302–FML304) come with ROADMAP.md Queue 1 item
13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Sequence, Tuple

from flinkml_tpu_torch.precision import Finding


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in program order: primitive name + mesh axes."""

    primitive: str
    axes: Tuple[str, ...] = ()

    def to_map(self) -> dict:
        return {"primitive": self.primitive, "axes": list(self.axes)}

    @staticmethod
    def from_map(m: Mapping) -> "CollectiveOp":
        return CollectiveOp(str(m["primitive"]),
                            tuple(str(a) for a in m.get("axes", ())))


def check_rank_order(
    sequences: Mapping[Any, Sequence[CollectiveOp]],
    program: str = "program",
) -> List[Finding]:
    """FML301 for each sequence that differs from the first one."""
    items = list(sequences.items())
    if len(items) < 2:
        return []
    ref_rank, ref = items[0]
    findings: List[Finding] = []
    for rank, seq in items[1:]:
        if tuple(seq) == tuple(ref):
            continue
        i = 0
        while i < min(len(ref), len(seq)) and ref[i] == seq[i]:
            i += 1
        a = ref[i].primitive if i < len(ref) else "<end>"
        b = seq[i].primitive if i < len(seq) else "<end>"
        findings.append(Finding(
            "FML301",
            f"{program}: rank {rank} diverges from rank {ref_rank} at "
            f"collective #{i} ({b} vs {a}) — rendezvous mismatch deadlocks "
            "the mesh",
            stage=str(program),
            fix_hint="all ranks must execute one SPMD program; remove "
                     "rank-dependent branching around collectives",
        ))
    return findings
