"""ShardingPlan — how each parameter family lays out over named mesh axes.

The port's counterpart of ``flinkml_tpu.sharding.plan``. A plan is a
small frozen value between the model code and the trainer, and answers
three questions, each for a different layer:

1. *How does parameter ``name`` shard?* — :meth:`ShardingPlan.spec_for`
   (and :meth:`ShardingPlan.partition_spec`, the torch placements of the
   same spec: one ``Shard(d)`` or ``Replicate()`` per mesh dimension),
   read by :mod:`flinkml_tpu_torch.sharding.apply`;
2. *How do batches shard?* — ``batch_axes`` /
   :meth:`ShardingPlan.batch_partition_spec`;
3. *How does a checkpointed leaf relate to the world size?* —
   :meth:`ShardingPlan.layout_tag` / :func:`layouts_for`, read by
   :meth:`~flinkml_tpu_torch.iteration.checkpoint.CheckpointManager.save`'s
   ``plan=``.

Family matching: ``rules`` is an ordered ``(pattern, spec)`` table;
``fnmatch`` patterns match the parameter's name (for nested trees its
``a/b/c`` key path, or that path's last component); the FIRST match wins
and unmatched names take ``default_spec``. A spec entry is ``None`` (the
dim replicated), an axis name, or a tuple of axis names (the dim sharded
over their product). A spec longer than a parameter's rank truncates to
the rank, so one ``FSDP_TP`` table serves ``[d, h]`` matrices
(``("fsdp", "tp")``) and ``[d]`` vectors (``("fsdp",)``).

A plan's JSON (:meth:`ShardingPlan.to_json_dict`) is the JAX package's,
byte for byte, so one ``*.plan.json`` serves both packages.

:func:`infer_plan` tries the presets in the order the tuning table
measured for the current mesh (knob ``infer_plan_order``,
:mod:`flinkml_tpu_torch.autotune`), else in :data:`STATIC_CANDIDATE_ORDER`
(ascending communication cost). Explicit ``candidates`` always win.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

#: The canonical mesh axis names.
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"

SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]


class NoFeasiblePlanError(ValueError):
    """:func:`infer_plan` found no candidate plan whose per-device
    parameter + optimizer-state footprint fits the budget on the given
    mesh. The message lists every candidate's footprint."""


def _normalize_entry(entry: Any) -> SpecEntry:
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry
    if isinstance(entry, (tuple, list)):
        out = tuple(entry)
        if not all(isinstance(a, str) for a in out):
            raise ValueError(f"spec axis names must be strings, got {entry!r}")
        return out
    raise ValueError(
        f"spec entries must be None, an axis name, or a tuple of axis "
        f"names; got {entry!r}"
    )


def _normalize_spec(spec: Any) -> Spec:
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(_normalize_entry(e) for e in spec)


def entry_axes(entry: SpecEntry) -> Tuple[str, ...]:
    """The axis names one spec entry shards its dim over (() if none)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _mesh_axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = tuple(mesh)
    return tuple(str(a) for a in names)


def _placements(spec: Spec, axis_names: Sequence[str]) -> Tuple[Any, ...]:
    """One ``Shard(d)``/``Replicate()`` per mesh axis for ``spec``. A dim
    sharded over several axes is split over them in mesh order, as a
    DTensor splits it; a tuple entry naming them in another order has no
    DTensor form and raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        in_mesh = [a for a in axis_names if a in axes]
        if list(axes) != in_mesh:
            raise ValueError(
                f"spec entry {entry!r} names axes that are missing from the "
                f"mesh {tuple(axis_names)} or out of the mesh's order (a "
                "DTensor splits a dim over mesh dims in mesh order)"
            )
        for a in axes:
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in axis_names)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """A frozen mapping from parameter families to partition specs over
    named mesh axes, plus the batch sharding. Hashable, and JSON
    round-trippable.

    ``rules``: ordered ``(fnmatch pattern, spec)`` pairs; first match
    wins. ``batch_axes``: the axes a batch's leading (row) dim shards
    over — ``()`` means replicated batches. ``default_spec``: the spec
    for names no rule matches (replicated by default).
    """

    name: str
    rules: Tuple[Tuple[str, Spec], ...] = ()
    batch_axes: Tuple[str, ...] = ()
    default_spec: Spec = ()

    def __post_init__(self):
        object.__setattr__(
            self, "rules",
            tuple((str(p), _normalize_spec(s)) for p, s in self.rules),
        )
        object.__setattr__(
            self, "batch_axes", tuple(str(a) for a in self.batch_axes)
        )
        object.__setattr__(
            self, "default_spec", _normalize_spec(self.default_spec)
        )

    # -- family resolution -------------------------------------------------
    def spec_for(self, name: str, ndim: Optional[int] = None) -> Spec:
        """The spec for parameter ``name`` (first matching rule, else the
        default), truncated to ``ndim`` entries when given."""
        spec = self.default_spec
        last = name.rsplit("/", 1)[-1]
        for pattern, rule_spec in self.rules:
            if fnmatch.fnmatchcase(name, pattern) or \
                    fnmatch.fnmatchcase(last, pattern):
                spec = rule_spec
                break
        if ndim is not None:
            spec = spec[:ndim]
        return spec

    def partition_spec(self, name: str, axis_names, ndim: Optional[int] = None):
        """The torch placements of parameter ``name`` on a mesh with
        ``axis_names`` (a sequence, or a mesh with ``axis_names``): one
        ``Shard(d)`` or ``Replicate()`` per mesh dimension."""
        return _placements(self.spec_for(name, ndim),
                           _mesh_axis_names(axis_names))

    def batch_partition_spec(self, axis_names):
        """The placements of a batch: its leading dim over ``batch_axes``,
        replicated over every other mesh dimension."""
        entry = self.batch_axes if self.batch_axes else None
        return _placements((entry,) if entry else (),
                           _mesh_axis_names(axis_names))

    # -- introspection -----------------------------------------------------
    def param_axes(self, name: str, ndim: Optional[int] = None
                   ) -> Tuple[str, ...]:
        """Every axis name ``name``'s spec shards over, in dim order."""
        out: List[str] = []
        for entry in self.spec_for(name, ndim):
            out.extend(entry_axes(entry))
        return tuple(out)

    def is_sharded(self, name: str, ndim: Optional[int] = None) -> bool:
        return bool(self.param_axes(name, ndim))

    def shard_dim(self, name: str, ndim: Optional[int] = None
                  ) -> Optional[int]:
        """The FIRST dim index ``name``'s spec shards (None when fully
        replicated): the dim the checkpoint ``sharded:<axis>`` tag
        records."""
        for i, entry in enumerate(self.spec_for(name, ndim)):
            if entry_axes(entry):
                return i
        return None

    def required_axes(self) -> Tuple[str, ...]:
        """Every mesh axis the plan references (params + batch), in
        first-use order."""
        seen: Dict[str, None] = {}
        for axis in self.batch_axes:
            seen.setdefault(axis)
        for _, spec in tuple(self.rules) + (("*", self.default_spec),):
            for entry in spec:
                for axis in entry_axes(entry):
                    seen.setdefault(axis)
        return tuple(seen)

    # -- checkpoint layout derivation --------------------------------------
    def layout_tag(self, name: str, ndim: Optional[int] = None) -> str:
        """The checkpoint layout tag this plan implies for ``name``:
        ``sharded:<dim>`` for the first sharded dim, else
        ``replicated``. A snapshot of a plan-sharded state records the
        assembled global value plus this tag, so a restore at another
        world revalidates the dim the plan shards."""
        from flinkml_tpu_torch.iteration.checkpoint import (
            LAYOUT_REPLICATED,
            sharded,
        )

        dim = self.shard_dim(name, ndim)
        return LAYOUT_REPLICATED if dim is None else sharded(dim)

    # -- serialization -----------------------------------------------------
    def to_json_dict(self) -> dict:
        def enc(entry: SpecEntry):
            return list(entry) if isinstance(entry, tuple) else entry

        return {
            "name": self.name,
            "rules": [[p, [enc(e) for e in s]] for p, s in self.rules],
            "batch_axes": list(self.batch_axes),
            "default_spec": [enc(e) for e in self.default_spec],
        }

    @staticmethod
    def from_json_dict(d: Mapping) -> "ShardingPlan":
        def dec(entry):
            return tuple(entry) if isinstance(entry, list) else entry

        return ShardingPlan(
            name=str(d.get("name", "plan")),
            rules=tuple(
                (p, tuple(dec(e) for e in s)) for p, s in d.get("rules", ())
            ),
            batch_axes=tuple(d.get("batch_axes", ())),
            default_spec=tuple(dec(e) for e in d.get("default_spec", ())),
        )


# -- presets -----------------------------------------------------------------

#: Everything replicated, batches replicated: the one-device program.
REPLICATED = ShardingPlan("replicated")

#: Data parallelism: parameters replicated, batches sharded over ``data``
#: (one gradient sum a step).
BATCH_PARALLEL = ShardingPlan("batch_parallel", batch_axes=(DATA_AXIS,))

#: FSDP/ZeRO-3: parameters and optimizer state shard dim 0 over ``fsdp``;
#: batches shard over ``data × fsdp``.
FSDP = ShardingPlan(
    "fsdp",
    rules=(("*", (FSDP_AXIS,)),),
    batch_axes=(DATA_AXIS, FSDP_AXIS),
)

#: FSDP × tensor parallelism: matrices shard dim 0 over ``fsdp`` and dim
#: 1 over ``tp``; vectors truncate to ``("fsdp",)``.
FSDP_TP = ShardingPlan(
    "fsdp_tp",
    rules=(("*", (FSDP_AXIS, TP_AXIS)),),
    batch_axes=(DATA_AXIS, FSDP_AXIS),
)

#: Name patterns of the embedding family: ``[vocab, dim]`` tables read by
#: id, whose shards must keep rows whole.
EMBEDDING_FAMILY_PATTERNS: Tuple[str, ...] = ("*embedding*",)


def is_embedding_param(name: str) -> bool:
    """Whether ``name`` belongs to the embedding family (matched on the
    full ``a/b/c`` key path and on its last component, as
    :meth:`ShardingPlan.spec_for` matches)."""
    last = name.rsplit("/", 1)[-1]
    return any(
        fnmatch.fnmatchcase(name, p) or fnmatch.fnmatchcase(last, p)
        for p in EMBEDDING_FAMILY_PATTERNS
    )


#: The embedding plan: embedding-family tables shard their vocab dim over
#: the ``fsdp × tp`` product with rows whole; every other family shards
#: FSDP×TP-style.
EMBEDDING = ShardingPlan(
    "embedding",
    rules=(
        ("*embedding*", ((FSDP_AXIS, TP_AXIS),)),
        ("*", (FSDP_AXIS, TP_AXIS)),
    ),
    batch_axes=(DATA_AXIS, FSDP_AXIS),
)

PRESETS: Dict[str, ShardingPlan] = {
    p.name: p
    for p in (REPLICATED, BATCH_PARALLEL, FSDP, FSDP_TP, EMBEDDING)
}


# -- footprint model + inference -------------------------------------------

_BYTE_UNITS = (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10))


def human_bytes(n: int) -> str:
    """``n`` in human units with the raw byte count in parens:
    ``"12.00 MiB (12582912 B)"``."""
    n = int(n)
    for unit, div in _BYTE_UNITS:
        if n >= div:
            return f"{n / div:.2f} {unit} ({n} B)"
    return f"{n} B"


def _axis_sizes(mesh) -> Dict[str, int]:
    """A mesh's axis sizes: a port ``DeviceMesh`` or a plain ``{axis:
    size}`` dict."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return {str(k): int(v) for k, v in shape.items()}
    raise TypeError(
        f"cannot read mesh axis sizes from {mesh!r}; pass a DeviceMesh or "
        "an {axis: size} dict"
    )


def shard_slice_elems(plan: ShardingPlan, axis_sizes: Mapping[str, int],
                      name: str, shape: Sequence[int]) -> int:
    """Elements of parameter ``name``'s largest per-device slice under
    ``plan``: the product over dims of ``ceil(extent / axis product)``
    (an uneven dim pads to its ceiling)."""
    spec = plan.spec_for(name, ndim=len(shape))
    elems = 1
    for dim_idx, extent in enumerate(shape):
        factor = 1
        if dim_idx < len(spec):
            for axis in entry_axes(spec[dim_idx]):
                factor *= int(axis_sizes.get(axis, 1))
        elems *= math.ceil(int(extent) / factor)
    return elems


def per_device_state_bytes(
    plan: ShardingPlan,
    mesh,
    param_shapes: Mapping[str, Sequence[int]],
    dtype_bytes: int = 4,
    optimizer_slots: int = 1,
) -> int:
    """Per-device bytes of the parameters plus their optimizer state under
    ``plan``; ``optimizer_slots`` counts same-shaped companions per
    parameter (1 for SGD momentum, 2 for Adam's m/v)."""
    axis_sizes = _axis_sizes(mesh)
    slots = 1 + int(optimizer_slots)
    total = 0
    for name, shape in param_shapes.items():
        total += shard_slice_elems(plan, axis_sizes, name, shape) \
            * dtype_bytes * slots
    return total


#: The quantization tiers :func:`infer_plan`'s memory-aware mode walks,
#: widest first.
QUANT_TIER_LADDER: Tuple[str, ...] = ("float32", "bfloat16", "int8")


def _tier_leaf_bytes(name: str, shape: Sequence[int], slice_elems: int,
                     tier: str, optimizer_slots: int) -> int:
    """Per-device bytes of one leaf and its optimizer slots under a tier.
    The int8 tier quantizes float leaves of at least
    :data:`~flinkml_tpu_torch.precision.INT8_MIN_CONST_ELEMS` elements (1
    B an element plus one float32 scale per last-axis column); slots stay
    at float32."""
    from flinkml_tpu_torch.precision import INT8_MIN_CONST_ELEMS

    total_elems = 1
    for d in shape:
        total_elems *= int(d)
    if tier == "float32":
        param, slot = 4 * slice_elems, 4 * slice_elems
    elif tier == "bfloat16":
        param, slot = 2 * slice_elems, 2 * slice_elems
    elif tier == "int8":
        if total_elems >= INT8_MIN_CONST_ELEMS and len(shape) >= 1:
            scale_cols = int(shape[-1]) if len(shape) >= 2 else 1
            param = 1 * slice_elems + 4 * scale_cols
        else:
            param = 4 * slice_elems
        slot = 4 * slice_elems
    else:
        raise ValueError(
            f"unknown quant tier {tier!r} (ladder: {QUANT_TIER_LADDER})"
        )
    return param + slot * int(optimizer_slots)


def per_device_state_bytes_tiered(
    plan: ShardingPlan,
    mesh,
    param_shapes: Mapping[str, Sequence[int]],
    tier: str = "float32",
    optimizer_slots: int = 1,
) -> int:
    """Per-device parameter + optimizer-state bytes under ``plan`` and a
    quantization tier (the per-leaf width model behind
    :func:`infer_plan`'s ``quant_tiers``)."""
    axis_sizes = _axis_sizes(mesh)
    total = 0
    for name, shape in param_shapes.items():
        slice_elems = shard_slice_elems(plan, axis_sizes, name, shape)
        total += _tier_leaf_bytes(
            name, shape, slice_elems, tier, optimizer_slots
        )
    return total


#: The candidate order: ascending communication cost (data parallel's one
#: sum < FSDP's gather/scatter pair < FSDP×TP's extra tp collectives <
#: EMBEDDING's row exchange).
STATIC_CANDIDATE_ORDER: Tuple[ShardingPlan, ...] = (
    BATCH_PARALLEL, FSDP, FSDP_TP, EMBEDDING,
)


def _splits_embedding_rows(plan: ShardingPlan, name: str,
                           shape: Sequence[int]) -> bool:
    """Whether ``plan`` would shard a non-leading dim of embedding-family
    parameter ``name`` (a layout the row exchange cannot host)."""
    spec = plan.spec_for(name, ndim=len(shape))
    return any(entry_axes(e) for e in spec[1:])


def _tuned_candidates() -> Tuple[ShardingPlan, ...]:
    """The measured candidate order for the current mesh (autotune knob
    ``infer_plan_order``), else :data:`STATIC_CANDIDATE_ORDER`. Unknown
    names in a table entry are skipped; presets it omits keep their
    static relative order at the back."""
    from flinkml_tpu_torch.autotune import tuned_default

    names = tuned_default("infer_plan_order", None)
    if not names:
        return STATIC_CANDIDATE_ORDER
    by_name = {p.name: p for p in STATIC_CANDIDATE_ORDER}
    ordered = [by_name[n] for n in names if n in by_name]
    ordered += [p for p in STATIC_CANDIDATE_ORDER if p not in ordered]
    return tuple(ordered)


def infer_plan(
    mesh,
    param_shapes: Mapping[str, Sequence[int]],
    hbm_budget_bytes: int,
    dtype_bytes: int = 4,
    optimizer_slots: int = 1,
    candidates: Optional[Sequence[ShardingPlan]] = None,
    quant_tiers: Optional[Sequence[str]] = None,
) -> Union[ShardingPlan, Tuple[ShardingPlan, str]]:
    """The first plan, in ``candidates`` order (default: the tuning
    table's ``infer_plan_order`` for this mesh, else
    :data:`STATIC_CANDIDATE_ORDER`, where first fit is cheapest fit),
    whose per-device parameter + optimizer-state footprint fits
    ``hbm_budget_bytes`` on ``mesh``. Candidates that need axes the mesh
    lacks, or that split an embedding table's rows, are skipped;
    :class:`NoFeasiblePlanError` lists every candidate when none fits.

    ``quant_tiers`` (``True`` for :data:`QUANT_TIER_LADDER`, or a
    subsequence of it) makes the search tier-major and the result
    ``(plan, tier)``; footprints then come from
    :func:`per_device_state_bytes_tiered`.
    """
    if candidates is None:
        candidates = _tuned_candidates()
    axis_sizes = _axis_sizes(mesh)
    budget = int(hbm_budget_bytes)
    tiered = quant_tiers is not None
    tiers: Sequence[Optional[str]] = (
        (tuple(QUANT_TIER_LADDER) if quant_tiers is True
         else tuple(quant_tiers)) if tiered else (None,)
    )
    embedding_params = [
        n for n, s in param_shapes.items()
        if is_embedding_param(n) and len(s) > 1
    ]
    tried: List[str] = []
    skipped: set = set()
    for tier in tiers:
        for plan in candidates:
            if plan.name in skipped:
                continue
            missing = [a for a in plan.required_axes()
                       if a not in axis_sizes]
            if missing:
                tried.append(f"{plan.name}: mesh lacks axes {missing}")
                skipped.add(plan.name)
                continue
            split = [
                n for n in embedding_params
                if _splits_embedding_rows(plan, n, param_shapes[n])
            ]
            if split:
                tried.append(
                    f"{plan.name}: splits embedding rows of {split} "
                    "across a non-leading dim (the sparse exchange "
                    "moves whole rows)"
                )
                skipped.add(plan.name)
                continue
            if tier is None:
                footprint = per_device_state_bytes(
                    plan, axis_sizes, param_shapes, dtype_bytes,
                    optimizer_slots,
                )
            else:
                footprint = per_device_state_bytes_tiered(
                    plan, axis_sizes, param_shapes, tier, optimizer_slots
                )
            if footprint <= budget:
                return (plan, tier) if tiered else plan
            label = plan.name if tier is None else f"{plan.name}@{tier}"
            tried.append(f"{label}: {human_bytes(footprint)}/device")
    raise NoFeasiblePlanError(
        f"no sharding plan fits hbm_budget_bytes={human_bytes(budget)} "
        f"on mesh {axis_sizes}"
        + (" at any quant tier" if tiered else "")
        + ": " + "; ".join(tried)
        + ". Add an fsdp/tp mesh axis, shrink the model, or raise the "
        "budget."
    )


# -- tree naming + layout derivation -----------------------------------------


def _leaves_with_paths(tree, path: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order and with its
    key names: dict keys sorted, list/tuple indices, namedtuple field
    names; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], path + (str(k),))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += _leaves_with_paths(getattr(tree, f), path + (f,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_paths(v, path + (str(i),))
        return out
    return [(path, tree)]


def _leaf_name(path: Tuple[str, ...]) -> str:
    return "/".join(path) or "param"


def state_names(state) -> Tuple[Tuple[str, Any], ...]:
    """``(name, leaf)`` per leaf of ``state``, names joined as ``a/b/c``
    key paths (the names ``jax.tree_util``'s key paths give the same
    nested dict)."""
    return tuple((_leaf_name(p), leaf) for p, leaf in _leaves_with_paths(state))


def _ndim(leaf) -> int:
    shape = getattr(leaf, "shape", None)
    return len(shape) if shape is not None else int(np.ndim(leaf))


def _map_named(fn, tree, path: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(_leaf_name(path), tree)


def layouts_for(plan: ShardingPlan, state):
    """The checkpoint layout-tag tree ``plan`` implies for ``state`` (what
    ``CheckpointManager.save(..., plan=plan)`` records)."""
    return _map_named(lambda name, leaf: plan.layout_tag(name, ndim=_ndim(leaf)),
                      state)
