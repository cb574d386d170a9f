"""Sharding-plan validation (FML5xx), before any step.

The port's counterpart of ``flinkml_tpu.analysis.sharding_check``. A
:class:`~flinkml_tpu_torch.sharding.plan.ShardingPlan` promises how a
program lays state out over a mesh; this pass checks the promise against
axis sizes alone, with no device:

  - **FML501** — the plan names a mesh axis the mesh does not have, or
    uses one axis on two dims of one parameter.
  - **FML502** — a mesh axis (product) does not divide the dim it shards.
  - **FML503** — a parameter plus its optimizer state exceeds the
    per-device memory budget: replicated, or still after sharding.
  - **FML504** — two plans in one program imply different collective
    orders: each plan's gradient sync as an ordered
    :class:`~flinkml_tpu_torch.analysis.collectives.CollectiveOp`
    pseudo-program (an all-gather over the shard axes and a
    reduce-scatter over the batch axes for a sharded family, one psum for
    a replicated one), compared by the FML301 comparator.

The pseudo-program is the JAX package's and stays its: the port's plan
step issues an all-gather and ONE all-reduce of ``[grad | loss_sum |
wsum]`` (:mod:`flinkml_tpu_torch.sharding.apply`), the same numbers as a
reduce-scatter and a slice, with one collective fewer kind.

Inputs are live plans (:func:`check_plan`, :func:`check_program`) or
``*.plan.json`` files (:func:`check_plan_file`), the JAX package's
format.
"""

from __future__ import annotations

import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from flinkml_tpu_torch.analysis.collectives import CollectiveOp, check_rank_order
from flinkml_tpu_torch.analysis.findings import Finding
from flinkml_tpu_torch.sharding.plan import entry_axes


def _axis_sizes(mesh) -> Dict[str, int]:
    from flinkml_tpu_torch.sharding.plan import _axis_sizes as impl

    return impl(mesh)


def _plan_params(plan, param_shapes: Optional[Mapping[str, Sequence[int]]]
                 ) -> List[Tuple[str, Optional[Tuple[int, ...]]]]:
    """The parameter universe to validate: the caller's shapes when
    given, else the plan's own family patterns (shape-free checks
    only)."""
    if param_shapes:
        return [(n, tuple(int(d) for d in s))
                for n, s in param_shapes.items()]
    return [(pattern, None) for pattern, _ in plan.rules]


def check_plan(
    plan,
    mesh,
    param_shapes: Optional[Mapping[str, Sequence[int]]] = None,
    hbm_budget_bytes: Optional[int] = None,
    dtype_bytes: int = 4,
    optimizer_slots: int = 1,
    location: Optional[str] = None,
) -> List[Finding]:
    """FML501/502/503 for one plan against one mesh.

    ``param_shapes`` (name -> shape) enables the divisibility (FML502)
    and footprint (FML503) checks; without it only the axis checks run.
    ``hbm_budget_bytes`` enables FML503; ``optimizer_slots`` counts
    same-shaped optimizer companions (1 = SGD momentum, 2 = Adam m/v).
    """
    sizes = _axis_sizes(mesh)
    findings: List[Finding] = []

    # -- FML501: unknown axes (batch + every family spec) ------------------
    for axis in plan.batch_axes:
        if axis not in sizes:
            findings.append(Finding(
                "FML501",
                f"plan {plan.name!r} shards batches over axis {axis!r}, "
                f"which the mesh {dict(sizes)} does not have",
                stage=plan.name, column="batch", location=location,
                fix_hint="add the axis to the mesh (DeviceMesh.for_plan) "
                         "or drop it from batch_axes",
            ))
    specs = tuple(plan.rules) + (("<default>", plan.default_spec),)
    for pattern, spec in specs:
        seen_axes: set = set()
        for entry in spec:
            for axis in entry_axes(entry):
                if axis not in sizes:
                    findings.append(Finding(
                        "FML501",
                        f"plan {plan.name!r} family {pattern!r} shards "
                        f"over axis {axis!r}, which the mesh "
                        f"{dict(sizes)} does not have",
                        stage=plan.name, column=pattern, location=location,
                        fix_hint="name one of the mesh's axes, or build "
                                 "the mesh with DeviceMesh.for_plan(plan)",
                    ))
                if axis in seen_axes:
                    findings.append(Finding(
                        "FML501",
                        f"plan {plan.name!r} family {pattern!r} uses axis "
                        f"{axis!r} on two dimensions of one parameter — "
                        "a PartitionSpec axis may appear at most once",
                        stage=plan.name, column=pattern, location=location,
                        fix_hint="shard each dim over distinct axes",
                    ))
                seen_axes.add(axis)

    # -- FML502 + FML503: shape-aware checks -------------------------------
    from flinkml_tpu_torch.sharding.plan import is_embedding_param

    for name, shape in _plan_params(plan, param_shapes):
        if shape is None:
            continue
        spec = plan.spec_for(name, ndim=len(shape))
        embedding = is_embedding_param(name)
        sharded_factor = 1
        sharded_axes: List[str] = []
        for dim_idx, entry in enumerate(spec):
            axes = entry_axes(entry)
            if not axes:
                continue
            factor = 1
            for axis in axes:
                factor *= sizes.get(axis, 1)
            sharded_factor *= factor
            sharded_axes.extend(axes)
            if shape[dim_idx] % factor != 0:
                findings.append(Finding(
                    "FML502",
                    f"plan {plan.name!r} shards {name!r} dim {dim_idx} "
                    f"(extent {shape[dim_idx]}) over axes {axes} of total "
                    f"size {factor}, which does not divide it"
                    + (" (the embedding family's vocab axis must divide "
                       "the shard product — EmbeddingTable pads its vocab "
                       "to a multiple automatically; a hand-written plan "
                       "must pad too)" if embedding and dim_idx == 0
                       else ""),
                    stage=plan.name, column=name, location=location,
                    fix_hint="pad the dimension to a multiple of the axis "
                             "size, or shard a different dim",
                ))
        if hbm_budget_bytes is not None:
            # The largest per-device slice (per-dim ceil, as infer_plan
            # counts it) plus its same-layout optimizer slots: a sharded
            # family must fit too, not only divide.
            from flinkml_tpu_torch.sharding.plan import (
                human_bytes,
                shard_slice_elems,
            )

            per_device = shard_slice_elems(plan, sizes, name, shape) \
                * dtype_bytes * (1 + optimizer_slots)
            if per_device > int(hbm_budget_bytes):
                if sharded_factor == 1:
                    findings.append(Finding(
                        "FML503",
                        f"plan {plan.name!r} replicates {name!r} "
                        f"({tuple(shape)}): {human_bytes(per_device)} of "
                        f"parameter + optimizer state per device exceeds "
                        f"the HBM budget of "
                        f"{human_bytes(hbm_budget_bytes)}",
                        stage=plan.name, column=name, location=location,
                        fix_hint="shard the family over an fsdp (or "
                                 "fsdp,tp) axis, or use infer_plan to "
                                 "pick a fitting preset",
                    ))
                else:
                    findings.append(Finding(
                        "FML503",
                        f"plan {plan.name!r} shards {name!r} "
                        f"({tuple(shape)}) over axes {sharded_axes} "
                        f"(product {sharded_factor}), but the per-device "
                        f"shard still costs {human_bytes(per_device)} of "
                        f"parameter + optimizer state against the HBM "
                        f"budget of {human_bytes(hbm_budget_bytes)}",
                        stage=plan.name, column=name, location=location,
                        fix_hint="grow the shard axes (a larger fsdp×tp "
                                 "product), shrink the table, or raise "
                                 "the budget",
                    ))
    return findings


def plan_collective_signature(
    plan,
    mesh,
    param_shapes: Optional[Mapping[str, Sequence[int]]] = None,
) -> Tuple[CollectiveOp, ...]:
    """The ordered gradient-sync pseudo-program ``plan`` implies: per
    parameter (sorted by name — the deterministic program order), an
    all-gather over its shard axes plus a reduce-scatter over the batch
    axes when sharded, one psum over the batch axes when replicated.
    Two plans whose signatures diverge would enqueue collectives in
    different orders inside one program — the FML301 rendezvous-
    mismatch shape, detected by the same comparator."""
    params = sorted(_plan_params(plan, param_shapes), key=lambda p: p[0])
    sig: List[CollectiveOp] = []
    for name, shape in params:
        ndim = len(shape) if shape is not None else None
        axes = plan.param_axes(name, ndim=ndim)
        if axes:
            sig.append(CollectiveOp("all_gather", tuple(axes)))
            sig.append(CollectiveOp("reduce_scatter",
                                    tuple(plan.batch_axes) + tuple(axes)))
        else:
            sig.append(CollectiveOp("psum", tuple(plan.batch_axes)))
    return tuple(sig)


def check_cross_plan(
    plans: Sequence,
    mesh,
    param_shapes: Optional[Mapping[str, Sequence[int]]] = None,
    location: Optional[str] = None,
) -> List[Finding]:
    """FML504 when two plans in one program imply conflicting collective
    orders — composed from the FML301 checker over the plans' derived
    signatures."""
    if len(plans) < 2:
        return []
    # Keys must be unique per PLAN, not per name: two distinct plans
    # sharing a name would otherwise collapse into one dict entry and
    # skip exactly the conflict this rule exists to catch.
    sequences = {
        f"{plan.name}[{i}]" if sum(
            1 for p in plans if p.name == plan.name) > 1 else plan.name:
        plan_collective_signature(plan, mesh, param_shapes)
        for i, plan in enumerate(plans)
    }
    out: List[Finding] = []
    for f in check_rank_order(sequences, program="sharding plans"):
        # Rewrite the cross-RANK finding as the cross-PLAN rule: same
        # divergence machinery, different program shape.
        out.append(Finding(
            "FML504",
            f.message.replace("rank ", "plan ") + " (two plans in one "
            "program must imply one collective order; split them into "
            "separate dispatches or reconcile the family tables)",
            stage=f.stage, location=location,
            fix_hint="use ONE plan per program, or make both plans shard "
                     "every shared family identically",
        ))
    return out


def check_program(
    plans: Sequence,
    mesh,
    param_shapes: Optional[Mapping[str, Sequence[int]]] = None,
    hbm_budget_bytes: Optional[int] = None,
    dtype_bytes: int = 4,
    optimizer_slots: int = 1,
    location: Optional[str] = None,
) -> List[Finding]:
    """The full FML5xx pass over every plan a program uses: per-plan
    FML501-503 plus the cross-plan FML504."""
    findings: List[Finding] = []
    for plan in plans:
        findings.extend(check_plan(
            plan, mesh, param_shapes=param_shapes,
            hbm_budget_bytes=hbm_budget_bytes, dtype_bytes=dtype_bytes,
            optimizer_slots=optimizer_slots, location=location,
        ))
    findings.extend(
        check_cross_plan(plans, mesh, param_shapes, location=location)
    )
    return findings


def check_plan_file(path: str) -> List[Finding]:
    """Validate a ``*.plan.json`` fixture/config:

    .. code-block:: json

        {"mesh": {"data": 1, "fsdp": 8},
         "param_shapes": {"coef": [4096]},
         "hbm_budget_bytes": 16384,
         "optimizer_slots": 1,
         "plans": [{"name": "...", "rules": [...], "batch_axes": [...]}]}

    (``plan`` with a single object is accepted too.) Unreadable or
    malformed files report one FML501 finding naming the path — the
    gate must fail loudly, not skip silently.
    """
    from flinkml_tpu_torch.sharding.plan import ShardingPlan

    try:
        with open(path, "r") as fh:
            doc = json.load(fh)
        raw_plans = doc.get("plans")
        if raw_plans is None:
            raw_plans = [doc["plan"]] if "plan" in doc else []
        plans = [ShardingPlan.from_json_dict(p) for p in raw_plans]
        mesh = {str(k): int(v) for k, v in (doc.get("mesh") or {}).items()}
        shapes = {
            str(k): tuple(int(d) for d in v)
            for k, v in (doc.get("param_shapes") or {}).items()
        } or None
        budget = doc.get("hbm_budget_bytes")
        slots = int(doc.get("optimizer_slots", 1))
        dtype_bytes = int(doc.get("dtype_bytes", 4))
    except (OSError, ValueError, KeyError, TypeError) as e:
        return [Finding(
            "FML501",
            f"sharding-plan file {path} is unreadable or malformed: {e!r}",
            location=path,
            fix_hint="see docs/development/sharding.md for the "
                     "*.plan.json schema",
        )]
    if not plans:
        return [Finding(
            "FML501",
            f"sharding-plan file {path} declares no plans",
            location=path,
            fix_hint="add a 'plan' object or a 'plans' list",
        )]
    return check_program(
        plans, mesh, param_shapes=shapes, hbm_budget_bytes=budget,
        dtype_bytes=dtype_bytes, optimizer_slots=slots, location=path,
    )
