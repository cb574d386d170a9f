"""Static per-device memory liveness (FML701–FML704), and the serving
engine's load-time estimate.

The port's counterpart of ``flinkml_tpu.analysis.memory``. The walker
reads a capture of the program (:mod:`._capture`, device-free) and
estimates its **per-device peak live bytes** under a ``(ShardingPlan,
quant tier)`` pair, as PyTorch's caching allocator counts them
(``torch.cuda.max_memory_allocated``):

  - **parameters and optimizer slots** (the arguments at
    ``param_argnums``) are sized per leaf at their stored dtype, sharded
    through :func:`~flinkml_tpu_torch.sharding.plan.shard_slice_elems`,
    the same per-dim ceiling as FML503;
  - **every other value** is a buffer from the node that allocates it to
    its last use, its leading dim divided (ceil) by the plan's batch-axes
    product. The arguments are resident for the whole program (the caller
    owns them; ``donate_argnums`` marks arguments the caller hands over,
    freed at their last use), and the outputs to its end;
  - **views allocate nothing.** ``t``, ``view``, ``expand``, ``slice``,
    ``as_strided`` and every op whose schema returns an alias of an
    argument share their base's buffer and keep it alive;
  - **in-place updates allocate nothing either**: ``sub_``, ``copy_`` and
    the ``out=`` variants write into the argument's buffer. That is the
    port's donation: JAX's ``donate_argnums`` lets XLA write a same-shape
    update over its input, and a PyTorch step does it by updating its
    argument in place.

Eager PyTorch, unlike XLA, never reuses an operand's buffer for the op's
own output: each op allocates its output while its operands are alive.
Python keeps a tensor alive while a local variable names it, which a
capture cannot see, so a step whose locals hold large intermediates past
their last use reads higher on the card than here; ``chip_smoke.py`` path
Y3 holds the estimate against ``max_memory_allocated`` on the linear
family's steps within the JAX package's calibration band (0.5x–2.0x).

Rules:

  - **FML701** — the estimated peak exceeds the per-device budget.
  - **FML702** — a vocab-scale intermediate on the hot path: a node whose
    value carries a full embedding-table extent (a one-hot densification,
    its transpose, a full-table product) where the embedding contract
    promises batch-sized payloads. One finding per shape; program outputs
    and the state's own buffers (an in-place table update) are exempt.
  - **FML703** — a same-shape parameter/optimizer-state output made out of
    place: the argument is neither updated in place nor donated, so the
    old and the new state coexist at the peak.
  - **FML704** — no quant tier in the float32 -> bfloat16 -> int8 ladder
    fits the budget under any candidate plan.

Inputs are live functions (:func:`check_memory_fn`,
:func:`estimate_fn_memory`) or ``*.memory.json`` files
(:func:`check_memory_file`, the JAX package's format; the trainer probes
are the port's own step). :func:`estimate_serving_bytes` reads no program:
it sizes a model's learned arrays at the widths the engine's precision
tier stores them, plus the batch buffers of the largest dispatch bucket.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from flinkml_tpu_torch.analysis.findings import Finding
from flinkml_tpu_torch.sharding.plan import (
    PRESETS,
    QUANT_TIER_LADDER,
    REPLICATED,
    NoFeasiblePlanError,
    ShardingPlan,
    _axis_sizes,
    human_bytes,
    infer_plan,
    is_embedding_param,
    shard_slice_elems,
)

#: Same-shape update leaves smaller than this are not worth a donation
#: finding: donating a scalar step counter saves nothing.
DONATION_MIN_ELEMS = 256

#: Leading extents below this never count as "vocab-scale".
VOCAB_SCALE_MIN_ROWS = 1024


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    """One program's per-device memory model under a plan.

    ``peak_bytes`` is the headline: the maximum over the node schedule of
    the resident arguments, the outputs made so far and the live
    intermediates. ``argument_bytes``/``output_bytes``/``param_bytes``
    break the resident set down; ``temp_peak_bytes`` is the peak less the
    resident arguments."""

    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    param_bytes: int
    temp_peak_bytes: int

    def render(self) -> str:
        return (
            f"peak {human_bytes(self.peak_bytes)}/device "
            f"(arguments {human_bytes(self.argument_bytes)}, of which "
            f"params+slots {human_bytes(self.param_bytes)}; outputs "
            f"{human_bytes(self.output_bytes)}; intermediate peak "
            f"{human_bytes(self.temp_peak_bytes)})"
        )


def _dtype_itemsize(dtype) -> int:
    import torch

    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError:
        return 2 if "bfloat16" in str(dtype) else 4


class _Graph:
    """A captured graph's buffers: which node allocates which buffer, the
    aliases, last uses and outputs."""

    def __init__(self, gm):
        from flinkml_tpu_torch.analysis._capture import (
            alias_of,
            is_tensor,
            op_name,
            output_nodes,
            tensor_inputs,
            val,
        )

        self.nodes = [n for n in gm.graph.nodes if n.op != "output"]
        self.index = {n: k for k, n in enumerate(self.nodes)}
        self.buffer: Dict[Any, Any] = {}      # node -> buffer key
        self.made_at: Dict[Any, int] = {}     # buffer key -> node index
        self.value: Dict[Any, Any] = {}       # buffer key -> fake tensor
        self.written: set = set()             # buffers updated in place
        for k, node in enumerate(self.nodes):
            v = val(node)
            if node.op == "call_function" and op_name(node)[1] == "getitem":
                src, i = node.args
                parts = self.buffer.get(src)
                self.buffer[node] = (parts.get(i) if isinstance(parts, dict)
                                     else parts)
                continue
            if node.op != "call_function":
                # Arguments (sized by the walk) and constants (the
                # module's own, like a jaxpr's constvars: not counted).
                self.buffer[node] = node
                continue
            alias = alias_of(node)
            if alias is not None and alias[0] in self.buffer:
                base = self.buffer[alias[0]]
                self.buffer[node] = base
                if alias[1]:
                    self.written.add(base)
                continue
            if is_tensor(v):
                self.buffer[node] = node
                self.made_at[node] = k
                self.value[node] = v
            elif isinstance(v, (list, tuple)):
                parts = {}
                for i, x in enumerate(v):
                    if is_tensor(x):
                        parts[i] = (node, i)
                        self.made_at[(node, i)] = k
                        self.value[(node, i)] = x
                self.buffer[node] = parts
        self.last_use: Dict[Any, int] = {}
        for k, node in enumerate(self.nodes):
            for a in tensor_inputs(node):
                b = self.buffer.get(a)
                for key in (b.values() if isinstance(b, dict) else [b]):
                    if key is not None:
                        self.last_use[key] = k
        self.outputs = output_nodes(gm)
        self.output_buffers = set()
        for n in self.outputs:
            b = self.buffer.get(n)
            for key in (b.values() if isinstance(b, dict) else [b]):
                if key is not None:
                    self.output_buffers.add(key)


class _LiveWalk:
    """One liveness walk over a captured graph, with the FML702 sites."""

    def __init__(self, plan: ShardingPlan, axis_sizes: Mapping[str, int],
                 vocab_extents: frozenset):
        self.plan = plan
        self.axis_sizes = dict(axis_sizes)
        self.vocab_extents = vocab_extents
        batch = 1
        for axis in plan.batch_axes:
            batch *= int(self.axis_sizes.get(axis, 1))
        self.batch_factor = max(1, batch)
        self.vocab_sites: List[Tuple[str, Tuple[int, ...], str]] = []

    def param_bytes(self, name: str, v) -> int:
        """A named parameter leaf: sharded by its plan family spec."""
        elems = shard_slice_elems(self.plan, self.axis_sizes, name,
                                  tuple(v.shape))
        return elems * _dtype_itemsize(v.dtype)

    def value_bytes(self, v) -> int:
        """An activation or intermediate: the leading dim divides (ceil) by
        the plan's batch-axes product; trailing dims stay whole."""
        shape = tuple(v.shape)
        if not shape:
            return _dtype_itemsize(v.dtype)
        elems = math.ceil(int(shape[0]) / self.batch_factor)
        for d in shape[1:]:
            elems *= int(d)
        return elems * _dtype_itemsize(v.dtype)

    def note_vocab_sites(self, g: _Graph, state_buffers: set) -> None:
        from flinkml_tpu_torch.analysis._capture import is_tensor, op_name, val

        if not self.vocab_extents:
            return
        exempt = set(g.outputs)
        seen = set()
        for node in g.nodes:
            if node.op != "call_function" or node in exempt:
                continue
            if g.buffer.get(node) in state_buffers:
                continue
            v = val(node)
            if not is_tensor(v):
                continue
            shape = tuple(int(d) for d in v.shape)
            if not any(d in self.vocab_extents for d in shape) \
                    or shape in seen:
                continue
            seen.add(shape)
            name = op_name(node)[1]
            if name == "getitem":
                name = op_name(node.args[0])[1]
            self.vocab_sites.append((name, shape,
                                     str(v.dtype).replace("torch.", "")))

    def walk(self, g: _Graph, arg_bytes: Dict[Any, int],
             freeable_args: set) -> Tuple[int, int]:
        """``(peak, temp_peak)`` of the schedule given each argument
        buffer's bytes; ``freeable_args`` are freed at their last use."""
        sizes: Dict[Any, int] = {}
        live = 0
        for key, nbytes in arg_bytes.items():
            sizes[key] = int(nbytes)
            live += int(nbytes)
        resident = sum(n for key, n in arg_bytes.items()
                       if key not in freeable_args)
        peak = live
        dying: Dict[int, List[Any]] = {}
        for key, k in g.made_at.items():
            if key in g.output_buffers:
                continue
            dying.setdefault(g.last_use.get(key, k), []).append(key)
        for key in freeable_args:
            if key not in g.output_buffers and key in g.last_use:
                dying.setdefault(g.last_use[key], []).append(key)
        made: Dict[int, List[Any]] = {}
        for key, k in g.made_at.items():
            made.setdefault(k, []).append(key)
        for k in range(len(g.nodes)):
            new = 0
            for key in made.get(k, ()):
                sizes[key] = self.value_bytes(g.value[key])
                new += sizes[key]
            peak = max(peak, live + new)
            live += new
            for key in dying.get(k, ()):
                live -= sizes.pop(key, 0)
        peak = max(peak, live)
        return peak, max(0, peak - resident)


def _estimate(gm, example_args, plan, mesh, param_argnums, donate_argnums):
    """``(MemoryEstimate, vocab sites, graph, roles, names, donated)``."""
    from flinkml_tpu_torch.analysis._capture import (
        is_tensor,
        leaf_indices,
        leaf_roles,
        placeholders,
        val,
    )

    plan = plan if plan is not None else REPLICATED
    axis_sizes = _axis_sizes(mesh) if mesh is not None else {}
    phs = placeholders(gm)
    roles, names = leaf_roles(example_args, tuple(param_argnums), len(phs))
    donated = {phs[i] for i in leaf_indices(example_args, donate_argnums)
               if i < len(phs)}
    vocab = frozenset(
        int(val(p).shape[0]) for p, role, name in zip(phs, roles, names)
        if role == "param" and is_embedding_param(name) and is_tensor(val(p))
        and val(p).dim() >= 2 and int(val(p).shape[0]) >= VOCAB_SCALE_MIN_ROWS
    )
    walk = _LiveWalk(plan, axis_sizes, vocab)
    g = _Graph(gm)
    arg_bytes: Dict[Any, int] = {}
    param_bytes = 0
    for p, role, name in zip(phs, roles, names):
        v = val(p)
        if not is_tensor(v):
            continue
        if role == "param":
            nbytes = walk.param_bytes(name, v)
            param_bytes += nbytes
        else:
            nbytes = walk.value_bytes(v)
        arg_bytes[p] = nbytes
    peak, temp_peak = walk.walk(g, arg_bytes, donated & set(arg_bytes))
    walk.note_vocab_sites(g, set(arg_bytes))
    out_bytes = 0
    for key in g.output_buffers:
        if key in g.value:
            out_bytes += walk.value_bytes(g.value[key])
        elif key in arg_bytes:
            out_bytes += arg_bytes[key]
    estimate = MemoryEstimate(
        peak_bytes=int(peak),
        argument_bytes=int(sum(arg_bytes.values())),
        output_bytes=int(out_bytes),
        param_bytes=int(param_bytes),
        temp_peak_bytes=int(temp_peak),
    )
    return estimate, walk.vocab_sites, g, roles, names, donated


def estimate_fn_memory(
    fn,
    *example_args,
    plan: Optional[ShardingPlan] = None,
    mesh: Optional[Any] = None,
    param_argnums: Sequence[int] = (),
    donate_argnums: Sequence[int] = (),
    axis_env: Optional[Sequence[Tuple[str, int]]] = None,
) -> MemoryEstimate:
    """Capture ``fn`` abstractly (no step runs, no device) and estimate
    its per-device peak live bytes under ``plan``. ``param_argnums`` marks
    the state arguments (sized by their plan family); ``donate_argnums``
    the arguments the caller hands over (freed at their last use).
    ``axis_env`` is accepted for the JAX package's signature and unused."""
    from flinkml_tpu_torch.analysis._capture import capture

    del axis_env
    gm = capture(fn, *example_args)
    return _estimate(gm, example_args, plan, mesh, param_argnums,
                     donate_argnums)[0]


def check_memory_fn(
    fn,
    *example_args,
    plan: Optional[ShardingPlan] = None,
    mesh: Optional[Any] = None,
    hbm_budget_bytes: Optional[int] = None,
    param_argnums: Sequence[int] = (),
    donate_argnums: Sequence[int] = (),
    program: str = "program",
    location: Optional[str] = None,
    axis_env: Optional[Sequence[Tuple[str, int]]] = None,
) -> List[Finding]:
    """The full check over one live function: FML701 (budget), FML702
    (vocab-scale intermediates), FML703 (same-shape state outputs made out
    of place)."""
    from flinkml_tpu_torch.analysis._capture import capture, is_tensor, val

    del axis_env
    gm = capture(fn, *example_args)
    estimate, vocab_sites, g, roles, names, donated = _estimate(
        gm, example_args, plan, mesh, param_argnums, donate_argnums)
    findings: List[Finding] = []
    plan_name = (plan or REPLICATED).name

    if hbm_budget_bytes is not None and \
            estimate.peak_bytes > int(hbm_budget_bytes):
        findings.append(Finding(
            "FML701",
            f"program {program!r} under plan {plan_name!r}: estimated "
            f"{estimate.render()} exceeds the per-device memory budget of "
            f"{human_bytes(hbm_budget_bytes)}",
            stage=program, location=location,
            fix_hint="shard further (a larger fsdp x tp product), drop "
                     "to a narrower quant tier (infer_plan's "
                     "quant_tiers= mode walks f32 -> bf16 -> int8), "
                     "update the state in place, or raise the budget",
        ))

    for op, shape, dtype in vocab_sites:
        findings.append(Finding(
            "FML702",
            f"program {program!r}: {op} materializes a vocab-scale "
            f"intermediate of shape {shape} ({dtype}) on the hot path — "
            "the embedding contract promises batch-sized payloads "
            "(lookup gathers rows, the gradient exchange moves "
            "batch-many rows), never a full-table value",
            stage=program, location=location,
            fix_hint="gather/scatter by ids instead of densifying "
                     "(one_hot @ table and a full-table all-reduce are the "
                     "shapes flinkml_tpu_torch.embeddings exists to avoid)",
        ))

    # FML703 — a same-shape state output made out of place.
    fresh = {
        (tuple(g.value[key].shape), str(g.value[key].dtype))
        for key in g.output_buffers if key in g.value
    }
    flagged: set = set()
    for p, role, name in zip([n for n in g.nodes if n.op == "placeholder"],
                             roles, names):
        v = val(p)
        if role != "param" or p in donated or not is_tensor(v):
            continue
        if p in g.written or name in flagged:
            continue
        shape = tuple(int(d) for d in v.shape)
        if int(np.prod(shape, dtype=np.int64)) < DONATION_MIN_ELEMS:
            continue
        if (shape, str(v.dtype)) in fresh:
            flagged.add(name)
            findings.append(Finding(
                "FML703",
                f"program {program!r}: state leaf {name!r} "
                f"({shape}, {str(v.dtype).replace('torch.', '')}) has a "
                "same-shape output (its update) made out of place — the "
                "old and new state coexist at the peak moment, doubling "
                "state memory",
                stage=program, column=name, location=location,
                fix_hint="update the state argument in place (sub_, "
                         "copy_, an out= variant) so the update is written "
                         "over it",
            ))
    return findings


# ---------------------------------------------------------------------------
# FML704 — the tier ladder has no fitting rung
# ---------------------------------------------------------------------------


def check_tier_ladder(
    mesh,
    param_shapes: Mapping[str, Sequence[int]],
    hbm_budget_bytes: int,
    optimizer_slots: int = 1,
    tiers: Sequence[str] = QUANT_TIER_LADDER,
    location: Optional[str] = None,
) -> List[Finding]:
    """FML704 when no ``(plan, quant_tier)`` pair fits the budget — the
    finding carries :func:`~flinkml_tpu_torch.sharding.plan.infer_plan`'s
    per-tier footprint listing."""
    try:
        infer_plan(
            mesh, param_shapes, hbm_budget_bytes,
            optimizer_slots=optimizer_slots, quant_tiers=tuple(tiers),
        )
    except NoFeasiblePlanError as e:
        return [Finding(
            "FML704",
            str(e),
            location=location,
            fix_hint="grow the mesh's fsdp/tp product, shrink the "
                     "vocab/model, or raise the per-device budget — "
                     "quantization alone cannot close this gap",
        )]
    return []


# ---------------------------------------------------------------------------
# Serving load-time gate
# ---------------------------------------------------------------------------


def estimate_serving_bytes(
    model: Any,
    schema: Mapping[str, Tuple[Any, Tuple[int, ...]]],
    max_batch_rows: int,
    policy: Optional[Any] = None,
) -> int:
    """A device-free upper-ish estimate of one serving replica's device
    memory: every learned model array at the width the engine's precision
    tier stores it (int8 codes + float32 scales under a ``quant`` policy,
    ``policy.compute`` under a mixed policy: the fused chain casts
    constants at its boundary), plus three live batch-sized buffers
    (input, one intermediate, output) at the largest dispatch bucket. The
    :class:`~flinkml_tpu_torch.serving.engine.ServingEngine` load-time
    budget gate consumes this BEFORE the active-model flip, so a refused
    swap keeps the old model serving. Same bytes as the JAX package's
    estimate for the same model, schema and policy."""
    from flinkml_tpu_torch.precision import quantizable, resolve_policy
    from flinkml_tpu_torch.recovery.sentinel import _iter_stage_arrays

    policy = resolve_policy(policy)
    const_bytes = 0
    for _name, arr in _iter_stage_arrays(model):
        a = np.asarray(arr)
        if policy is not None and policy.quant == "int8" \
                and quantizable(a):
            cols = int(a.shape[-1]) if a.ndim >= 2 else 1
            const_bytes += a.size + 4 * cols
        elif policy is not None and policy.mixed:
            const_bytes += a.size * int(policy.compute_dtype.itemsize)
        else:
            const_bytes += int(a.nbytes)
    batch_bytes = 0
    for _col, (dtype, trailing) in schema.items():
        elems = int(max_batch_rows)
        for d in trailing:
            elems *= int(d)
        width = (
            int(policy.compute_dtype.itemsize)
            if policy is not None and policy.mixed
            else _dtype_itemsize(dtype)
        )
        batch_bytes += elems * width
    return int(const_bytes + 3 * batch_bytes)


# ---------------------------------------------------------------------------
# *.memory.json fixtures / configs
# ---------------------------------------------------------------------------


def _probe_program(spec_map: Mapping):
    """The probe ``spec_map`` names — ``(fn, example_args, param_argnums,
    donate_argnums)``. The trainer probes are the port's own step
    (:func:`~flinkml_tpu_torch.sharding.apply.linear_step_fn`).

    ``sgd_step``/``adam_step``: the step over its real optimizer state;
    ``donate`` true updates the state arguments in place (``copy_``), the
    port's donation, false returns the new state out of place (the FML703
    shape). ``embedding_lookup``: the batch-sized contract (clean).
    ``embedding_dense_grad``: the one-hot densified gradient (FML702)."""
    import torch

    from flinkml_tpu_torch.analysis._capture import spec, torch_dtype

    name = str(spec_map.get("name", ""))
    dim = int(spec_map.get("dim", 8))
    rows = int(spec_map.get("rows", 8))
    dtype = torch_dtype(str(spec_map.get("dtype", "float32")))
    dname = str(dtype).replace("torch.", "")

    if name in ("sgd_step", "adam_step"):
        from flinkml_tpu_torch.sharding.apply import (
            init_linear_state,
            linear_step_fn,
        )

        optimizer = "sgd" if name == "sgd_step" else "adam"
        step = linear_step_fn(
            loss=str(spec_map.get("loss", "logistic")), optimizer=optimizer,
            dtype_name=dname, learning_rate=0.1, momentum=0.9,
            reg_l2=0.0, reg_l1=0.0, policy=None,
        )
        state = {k: spec(np.shape(v), dtype)
                 for k, v in init_linear_state(dim, optimizer, dname).items()}
        batch = spec((rows, dim), dtype)
        vec = spec((rows,), dtype)
        fn = step
        if bool(spec_map.get("donate", False)):
            def fn(state, xb, yb, wb):
                new, loss = step(state, xb, yb, wb)
                for k in state:
                    state[k].copy_(new[k])
                return state, loss

        return fn, (state, batch, vec, vec), (0,), ()
    if name == "embedding_lookup":
        vocab = int(spec_map.get("vocab", 4096))

        def lookup(state, ids):
            return state["emb/embedding"].index_select(0, ids)

        table = spec((vocab, dim), dtype)
        ids = spec((rows,), torch.int64)
        return lookup, ({"emb/embedding": table}, ids), (0,), ()
    if name == "embedding_dense_grad":
        vocab = int(spec_map.get("vocab", 4096))

        def dense_grad(state, ids, grad):
            table = state["emb/embedding"]
            onehot = (ids[:, None] == torch.arange(table.shape[0])
                      ).to(table.dtype)
            return {"emb/embedding": table + onehot.T @ grad}

        table = spec((vocab, dim), dtype)
        ids = spec((rows,), torch.int64)
        grad = spec((rows, dim), dtype)
        return dense_grad, ({"emb/embedding": table}, ids, grad), (0,), ()
    raise ValueError(
        f"unknown memory probe program {name!r} (known: sgd_step, "
        "adam_step, embedding_lookup, embedding_dense_grad)"
    )


def _resolve_plan(raw) -> ShardingPlan:
    if raw is None:
        return REPLICATED
    if isinstance(raw, str):
        try:
            return PRESETS[raw]
        except KeyError:
            raise ValueError(
                f"unknown plan preset {raw!r} (presets: {sorted(PRESETS)})"
            ) from None
    return ShardingPlan.from_json_dict(raw)


def check_memory_file(path: str) -> List[Finding]:
    """Validate a ``*.memory.json`` fixture/config (the JAX package's
    schema):

    .. code-block:: json

        {"mesh": {"data": 1, "fsdp": 4, "tp": 2},
         "plan": "embedding",
         "hbm_budget_bytes": 1048576,
         "program": {"name": "sgd_step", "dim": 65536, "rows": 64,
                     "donate": false},
         "param_shapes": {"emb/embedding": [1048576, 64]},
         "optimizer_slots": 1,
         "tiers": ["float32", "bfloat16", "int8"]}

    ``program`` (optional) names a probe captured under the plan and
    checked for FML701/702/703; ``tiers`` (optional, with
    ``param_shapes``) walks the quant ladder (FML704). Unreadable or
    malformed files report one FML701 finding naming the path."""
    try:
        with open(path, "r") as fh:
            doc = json.load(fh)
        plan = _resolve_plan(doc.get("plan"))
        mesh = {str(k): int(v) for k, v in (doc.get("mesh") or {}).items()}
        budget = doc.get("hbm_budget_bytes")
        program = doc.get("program")
        shapes = {
            str(k): tuple(int(d) for d in v)
            for k, v in (doc.get("param_shapes") or {}).items()
        }
        slots = int(doc.get("optimizer_slots", 1))
        tiers = doc.get("tiers")
        if program is None and tiers is None:
            raise ValueError(
                "a *.memory.json target needs a 'program' probe, a "
                "'tiers' ladder check, or both"
            )
    except (OSError, ValueError, KeyError, TypeError) as e:
        return [Finding(
            "FML701",
            f"memory file {path} is unreadable or malformed: {e!r}",
            location=path,
            fix_hint="see flinkml_tpu_torch/analysis/memory.py for the "
                     "*.memory.json schema",
        )]
    findings: List[Finding] = []
    if program is not None:
        try:
            fn, args, param_argnums, donate = _probe_program(program)
            findings.extend(check_memory_fn(
                fn, *args, plan=plan, mesh=mesh,
                hbm_budget_bytes=budget, param_argnums=param_argnums,
                donate_argnums=donate,
                program=str(program.get("name")), location=path,
            ))
        except (ValueError, TypeError) as e:
            return [Finding(
                "FML701",
                f"memory file {path} names a bad probe program: {e}",
                location=path,
                fix_hint="see flinkml_tpu_torch/analysis/memory.py",
            )]
    if tiers is not None and shapes and budget is not None:
        findings.extend(check_tier_ladder(
            mesh, shapes, int(budget), optimizer_slots=slots,
            tiers=[str(t) for t in tiers], location=path,
        ))
    return findings
