"""Collective order: extraction, the cross-rank comparator (FML301) and
the dispatch-trace checks (FML302–FML304).

The port's counterpart of ``flinkml_tpu.analysis.collectives``.
Rendezvous collectives need every participant to reach the same
collectives in the same order. Two program shapes break that:

  1. **Cross-rank divergence** (FML301): ranks run programs whose
     collective sequences differ — rank 0 waits in an all-reduce while
     rank 1 waits in an all-gather, forever. :func:`extract_collectives`
     reads the ordered sequence out of a function's capture
     (:mod:`._capture`: each collective of
     :mod:`flinkml_tpu_torch.parallel.collectives` is one ``flinkml`` node
     there, a Python loop unrolled), and :func:`check_rank_order` compares
     sequences across ranks. Each op is reported under the JAX package's
     primitive name (:data:`COLLECTIVE_PRIMITIVES`), so a sequence compares
     with a JAX program's and with the plans' pseudo-programs (FML504).
  2. **Unlocked concurrent dispatch** (FML302): two host *threads* each
     dispatch collective programs over overlapping devices; the ranks
     then see the two programs' collectives in different orders.
     :func:`check_dispatch_trace` flags the shape from a recorded
     :class:`DispatchEvent` trace: any pair of multi-device collective
     dispatches from different threads over intersecting device sets
     that do not share a lock token. FML303 is the serving replica-pool
     form, FML304 a pool dispatch on devices a training lease still holds.

Traces come from :mod:`flinkml_tpu_torch.parallel.dispatch` observers
(live runs: ``add_dispatch_observer`` receives each event as a map in
this schema) or from JSON files (recorded fixtures, the JAX package's
``*.trace.json``); both are host-side only, so the checker runs
device-free.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, List, Mapping, Optional, Sequence, Tuple

from flinkml_tpu_torch.analysis.findings import Finding

#: The port's collective ops (``torch.ops.flinkml``) and the JAX
#: primitive each stands for.
COLLECTIVE_PRIMITIVES = {
    "psum": "psum",
    "all_reduce_": "psum",
    "group_all_reduce": "psum",
    "group_all_gather": "all_gather",
    "group_all_to_all": "all_to_all",
    "ppermute": "ppermute",
    "broadcast": "pbroadcast",
}


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in program order: primitive name + mesh axes."""

    primitive: str
    axes: Tuple[str, ...] = ()

    def to_map(self) -> dict:
        return {"primitive": self.primitive, "axes": list(self.axes)}

    @staticmethod
    def from_map(m) -> "CollectiveOp":
        """From ``{"primitive", "axes"}``, or a bare primitive name (the
        port's live dispatch events carry names)."""
        if isinstance(m, str):
            return CollectiveOp(m)
        return CollectiveOp(str(m["primitive"]),
                            tuple(str(a) for a in m.get("axes", ())))


def _axes_of(spec: str) -> Tuple[str, ...]:
    """A captured collective's axes: the mesh axis names, or its ranks
    (``"ranks=0,1"``) as one entry."""
    if spec.startswith("ranks="):
        return (spec,)
    return tuple(a for a in spec.split(",") if a)


def collectives_of_graph(gm) -> Tuple[CollectiveOp, ...]:
    """The ordered collective sequence of a captured graph."""
    from flinkml_tpu_torch.analysis._capture import op_name

    out: List[CollectiveOp] = []
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        ns, name = op_name(node)
        if ns == "flinkml" and name in COLLECTIVE_PRIMITIVES:
            spec = node.args[1] if len(node.args) > 1 else ""
            out.append(CollectiveOp(COLLECTIVE_PRIMITIVES[name],
                                    _axes_of(str(spec))))
    return tuple(out)


def extract_collectives(fn, *example_args) -> Tuple[CollectiveOp, ...]:
    """The ordered collective sequence of ``fn``, captured abstractly
    against the example arguments (shapes and dtypes only: no step runs,
    no rank is contacted, no process group is needed). A Python loop's
    collectives appear once per iteration it ran."""
    from flinkml_tpu_torch.analysis._capture import capture

    return collectives_of_graph(capture(fn, *example_args))


def check_rank_order(
    sequences: Mapping[Any, Sequence[CollectiveOp]],
    program: str = "program",
) -> List[Finding]:
    """FML301 when the per-rank collective sequences are not identical."""
    items = list(sequences.items())
    if len(items) < 2:
        return []
    ref_rank, ref = items[0]
    findings: List[Finding] = []
    for rank, seq in items[1:]:
        if tuple(seq) == tuple(ref):
            continue
        # Locate the first divergence for the message.
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


# ---------------------------------------------------------------------------
# Dispatch traces (cross-thread ordering)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DispatchEvent:
    """One host-side dispatch of a (possibly collective) program.

    ``devices`` are the device ids the program's collectives span;
    ``locks`` are the tokens of the tracked locks the dispatching thread
    held (``parallel.dispatch.local_execution_lock`` records them);
    ``leases`` are the tokens of active slice leases that OTHER threads
    held over these devices at dispatch time
    (``parallel.dispatch.lease_devices`` — the FML304 audit input).
    """

    thread: str
    program: str
    devices: Tuple[int, ...] = ()
    collectives: Tuple[CollectiveOp, ...] = ()
    locks: Tuple[str, ...] = ()
    leases: Tuple[str, ...] = ()

    def to_map(self) -> dict:
        return {
            "thread": self.thread,
            "program": self.program,
            "devices": list(self.devices),
            "collectives": [c.to_map() for c in self.collectives],
            "locks": list(self.locks),
            "leases": list(self.leases),
        }

    @staticmethod
    def from_map(m: Mapping) -> "DispatchEvent":
        return DispatchEvent(
            thread=str(m["thread"]),
            program=str(m.get("program", "?")),
            devices=tuple(int(d) for d in m.get("devices", ())),
            collectives=tuple(
                CollectiveOp.from_map(c) for c in m.get("collectives", ())
            ),
            locks=tuple(str(t) for t in m.get("locks", ())),
            leases=tuple(str(t) for t in m.get("leases", ())),
        )


def load_trace(path: str) -> List[DispatchEvent]:
    """Load a recorded dispatch trace (JSON list of event maps)."""
    with open(path, "r") as fh:
        data = json.load(fh)
    events = data["events"] if isinstance(data, Mapping) else data
    return [DispatchEvent.from_map(m) for m in events]


#: Dispatch-trace program prefix of serving replica-pool slices (the
#: :class:`~flinkml_tpu_torch.serving.pool.ReplicaPool` tags each replica's
#: engine ``serving.pool/<pool>/<replica>``).
POOL_PROGRAM_PREFIX = "serving.pool/"


def _is_pool_dispatch(event: DispatchEvent) -> bool:
    return event.program.startswith(POOL_PROGRAM_PREFIX)


def check_dispatch_trace(events: Iterable[DispatchEvent],
                         location: Optional[str] = None) -> List[Finding]:
    """FML302/FML303 for every pair of threads that dispatched
    multi-device collective programs over intersecting device sets
    without a common lock token. One finding per (thread pair, program
    pair) shape, not per event occurrence.

    The shape specializes to **FML303** when either side is a serving
    replica-pool slice dispatch (program prefix
    :data:`POOL_PROGRAM_PREFIX`): a pool whose mesh slices overlap a
    concurrently registered training dispatch (or another pool's slices)
    without a shared ``local_execution_lock`` — the pool-specific fix is
    to give the replicas their slice meshes (``ServingConfig.mesh``) so
    the per-slice locks compose with every overlapping set.

    **FML304** is the lease-aware shape (orthogonal to locking, so a
    shared lock does NOT clear it): a pool dispatch whose event carries
    an active foreign slice-lease token ran serving work on devices a
    training job still OWNS — the autoscaler skipped the reclaim
    handshake (``SliceLease.request_revoke`` + ``wait_released``) before
    placing the replica. One finding per (program, lease) pair."""
    events = list(events)
    findings: List[Finding] = []
    reported = set()
    for e in events:
        if not _is_pool_dispatch(e):
            continue
        for token in e.leases:
            key = ("FML304", e.program, token)
            if key in reported:
                continue
            reported.add(key)
            findings.append(Finding(
                "FML304",
                f"replica-pool dispatch {e.program!r} (thread "
                f"{e.thread!r}) runs on devices {sorted(e.devices)} "
                f"still covered by active training lease {token!r} — "
                "the slice was never reclaimed, so serving now steals "
                "cycles the trainer's lease promised it (and a shared "
                "lock only serializes the theft)",
                stage=e.program, location=location,
                fix_hint="reclaim before placing: "
                         "lease.request_revoke(reason) and "
                         "wait_released(timeout) — the trainer releases "
                         "at its next epoch boundary — or scale onto "
                         "unleased devices "
                         "(parallel.dispatch.leased_device_ids)",
            ))
    multi = [e for e in events if len(e.devices) > 1]
    for i, a in enumerate(multi):
        for b in multi[i + 1:]:
            if a.thread == b.thread:
                continue
            if not (set(a.devices) & set(b.devices)):
                continue
            if set(a.locks) & set(b.locks):
                continue
            key = frozenset(((a.thread, a.program), (b.thread, b.program)))
            if key in reported:
                continue
            reported.add(key)
            if _is_pool_dispatch(a) or _is_pool_dispatch(b):
                pool_ev, other = (
                    (a, b) if _is_pool_dispatch(a) else (b, a)
                )
                findings.append(Finding(
                    "FML303",
                    f"replica-pool slice {pool_ev.program!r} (thread "
                    f"{pool_ev.thread!r}) overlaps the concurrent dispatch "
                    f"{other.program!r} (thread {other.thread!r}) on shared "
                    "devices with no common slice lock — the replica's and "
                    "the trainer's collective enqueues may interleave and "
                    "deadlock the rendezvous",
                    stage=f"{pool_ev.program} / {other.program}",
                    location=location,
                    fix_hint="give the pool replicas their slice meshes "
                             "(ServingConfig.mesh / ReplicaPool(meshes=...)) "
                             "so every batch holds local_execution_lock("
                             "slice), which composes with overlapping "
                             "training locks",
                ))
                continue
            findings.append(Finding(
                "FML302",
                f"threads {a.thread!r} and {b.thread!r} dispatch collective "
                f"programs ({a.program!r}, {b.program!r}) over shared "
                "devices with no common lock — per-device collective "
                "enqueue order may interleave and deadlock the rendezvous",
                stage=f"{a.program} / {b.program}", location=location,
                fix_hint="hold parallel.dispatch.local_execution_lock(mesh) "
                         "around every host-driven loop that dispatches "
                         "multi-device collective programs",
            ))
    return findings
