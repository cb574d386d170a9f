"""Precision-flow validation (FML6xx), before any step.

The port's counterpart of ``flinkml_tpu.analysis.precision``. A
:class:`~flinkml_tpu_torch.precision.PrecisionPolicy` is a promise about
where a program may round: ``compute`` is where the hot work runs,
``accum`` the floor under every accumulation, ``params`` the storage width
of parameters and optimizer state. This pass walks a capture of the
program (:mod:`._capture`: aten ops and the port's ``flinkml`` kernel and
collective nodes, device-free) and tracks each value's **dtype
provenance** against the policy:

  - **FML601** — a reduction, a matrix product or an optimizer/state
    update (an add/sub/mul/div still carrying parameter provenance, in
    place or not) runs narrower than ``policy.accum``. A product's
    accumulator is its output dtype. A reduction's is PyTorch's
    accumulate type: ``sum``, ``mean``, ``cumsum`` and ``prod`` of a
    bfloat16 or float16 tensor accumulate in float32 and round once, as the
    JAX package's ``jnp.sum`` does by its upcast, so they are narrow only
    below that.
  - **FML602** — a silent upcast in the compute region: a strong (non
    0-d) float constant wider than ``policy.compute`` meets a
    compute-width value and the result comes out wide. PyTorch's
    promotion happens inside the op (a 0-d tensor or a Python scalar never
    promotes a dimensioned tensor), so no cast node marks it.
  - **FML603** — a parameter or optimizer-state leaf stored narrower than
    ``policy.params``.
  - **FML604** — a collective (``flinkml.psum``, ``all_reduce_``, the
    group primitives) on a float narrower than ``accum`` without an
    explicit narrowing cast right before it.
  - **FML605** — a sharding plan's budget width against
    ``policy.params`` (:func:`check_policy_plan`, no program).
  - **FML606** — a reduction or product over int8 parameters whose output
    is still an integer: the int8 codes accumulated without their scales.
  - **FML607** — int8 parameter leaves under a policy that declares no
    quantization.

**Provenance.** Placeholders are ``param`` or ``data``; constants
(``get_attr``, factories with no tensor input) are ``const``. Provenance
flows through every node except a *narrowing* float cast (``_to_copy``),
which resets it to ``data``: casting state down to ``compute`` at a step
boundary is the sanctioned contract.

Inputs are live functions (:func:`check_precision_fn`) or
``*.policy.json`` files (:func:`check_policy_file`, the JAX package's
format; the example programs are the port's own step builders). The same
walk backs the FML106 promotion check (:func:`promotion_findings`). The
fused executor and the plan trainers keep their declared-width checks
(:func:`flinkml_tpu_torch.pipeline_fusion.check_precision`,
:func:`flinkml_tpu_torch.sharding.apply.validate_linear_precision`), which
give the same verdicts without a capture on the hot path.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from flinkml_tpu_torch.analysis.collectives import COLLECTIVE_PRIMITIVES
from flinkml_tpu_torch.analysis.findings import Finding

#: Reductions: PyTorch accumulates them at the accumulate type of their
#: input (float32 for the 16-bit floats), or at their output dtype.
REDUCTION_PRIMITIVES = frozenset({
    "sum", "nansum", "mean", "prod", "cumsum", "cumprod", "logcumsumexp",
    "logsumexp",
})

#: Matrix products: the accumulator is the output dtype.
DOT_PRIMITIVES = frozenset({
    "mm", "mv", "bmm", "addmm", "addmv", "addbmm", "baddbmm", "dot",
    "vdot", "matmul", "linear", "einsum", "tensordot",
})

#: Elementwise arithmetic that, when still carrying param provenance at a
#: narrow width, is a state update (in place too: ``sub_`` is ``sub``).
_UPDATE_PRIMITIVES = frozenset({"add", "sub", "mul", "div", "addcmul",
                                "addcdiv", "lerp"})

#: Binary arithmetic checked for the stray-wide-constant promotion.
_PROMOTION_PRIMITIVES = frozenset({
    "add", "sub", "mul", "div", "maximum", "minimum", "pow", "atan2",
    "remainder", "fmod", "where",
})

#: dtype casts.
_CASTS = frozenset({"_to_copy", "to", "convert_element_type"})

_PARAMISH = frozenset({"param", "carry"})

_BITS = {"bfloat16": 8, "float16": 11, "float32": 24, "float64": 53}


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _is_float(dtype) -> bool:
    return _name(dtype) in _BITS


def _is_int8(dtype) -> bool:
    return _name(dtype) == "int8"


def _is_integer(dtype) -> bool:
    return _name(dtype) in ("int8", "uint8", "int16", "int32", "int64")


def _bits(dtype) -> int:
    """Significand bits of a float dtype (a wide sentinel otherwise)."""
    return _BITS.get(_name(dtype), 1 << 16)


def _dtype_of(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.dtype
    if isinstance(v, (list, tuple)):
        for x in v:
            if isinstance(x, torch.Tensor):
                return x.dtype
    return None


def _base(name: str) -> str:
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


class _Flow:
    """One dtype-provenance walk over a captured graph, accumulating
    FML601/602/604/606 findings."""

    def __init__(self, policy, program: str, location: Optional[str]):
        self.policy = policy
        self.program = program
        self.location = location
        self.findings: List[Finding] = []
        self._seen: set = set()
        self.prov: Dict[Any, frozenset] = {}
        self.widened_from: Dict[Any, int] = {}
        self.narrowed_from: Dict[Any, int] = {}

    def _add(self, rule: str, key: tuple, message: str, fix: str,
             column: Optional[str] = None) -> None:
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(
            rule, message, stage=self.program, column=column,
            location=self.location, fix_hint=fix,
        ))

    def walk(self, gm, roles: Sequence[str]) -> None:
        from flinkml_tpu_torch.analysis._capture import (
            op_name,
            tensor_inputs,
            val,
        )

        phs = iter(roles)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                self.prov[node] = frozenset({next(phs, "data")})
            elif node.op == "get_attr":
                self.prov[node] = frozenset({"const"})
            elif node.op == "call_function":
                ns, name = op_name(node)
                ins = tensor_inputs(node)
                if not ins:
                    self.prov[node] = frozenset({"const"})
                    continue
                joined = frozenset().union(
                    *(self.prov.get(a, frozenset({"const"})) for a in ins))
                if name == "getitem":
                    self.prov[node] = joined
                    continue
                in_dts = [(a, _dtype_of(val(a))) for a in ins]
                out_dt = _dtype_of(val(node))
                if ns == "aten" and name in _CASTS and len(ins) == 1:
                    self._cast(node, in_dts[0][1], out_dt, joined)
                    continue
                self._check(node, ns, name, in_dts, out_dt, joined)
                self.prov[node] = joined

    def _cast(self, node, in_dt, out_dt, joined) -> None:
        if in_dt is not None and out_dt is not None and _is_float(in_dt) \
                and _is_float(out_dt):
            if _bits(out_dt) < _bits(in_dt):
                # The sanctioned step-boundary down-cast.
                self.narrowed_from[node] = _bits(in_dt)
                self.prov[node] = frozenset({"data"})
                return
            if _bits(out_dt) > _bits(in_dt):
                self.widened_from[node] = _bits(in_dt)
        self.prov[node] = joined

    def _check(self, node, ns, name, in_dts, out_dt, joined) -> None:
        policy = self.policy
        accum_bits = _bits(policy.accum)
        out_is_float = out_dt is not None and _is_float(out_dt)

        if ns == "flinkml" and name in COLLECTIVE_PRIMITIVES:
            for a, dt in in_dts:
                if dt is None or not _is_float(dt) or _bits(dt) >= accum_bits:
                    continue
                if self.narrowed_from.get(a, 0) >= accum_bits:
                    continue  # deliberate bandwidth cast right before
                self._add(
                    "FML604", ("FML604", name, _name(dt)),
                    f"collective {name!r} operates on {_name(dt)} — "
                    f"narrower than policy.accum ({policy.accum}) — without "
                    "an explicit pre-cast; cross-rank reduction order is "
                    f"already nondeterministic, rounding it at {_name(dt)} "
                    "compounds with topology",
                    fix="accumulate collectives at policy.accum, or cast "
                        "down EXPLICITLY right before the collective to "
                        "declare the bandwidth-for-precision trade",
                )

        base = _base(name)
        reduces = ns == "aten" and base in REDUCTION_PRIMITIVES
        dots = ns == "aten" and base in DOT_PRIMITIVES
        if ((reduces or dots) and out_dt is not None and _is_integer(out_dt)
                and (joined & _PARAMISH)
                and any(dt is not None and _is_int8(dt) for _, dt in in_dts)):
            self._add(
                "FML606", ("FML606", name, _name(out_dt)),
                f"{name} accumulates int8-quantized parameters at "
                f"{_name(out_dt)} without a dequant scale — int8 "
                "accumulation wraps at ±127, and unscaled integer codes are "
                "not values",
                fix="dequantize first (q.to(policy.compute) * scale, the "
                    "sanctioned int8-tier shape — flinkml_tpu_torch."
                    "precision.quantize_absmax) so the accumulation runs at "
                    "policy.accum on scaled floats",
            )

        if out_is_float:
            acc_bits = _bits(out_dt)
            if reduces and any(dt is not None and _is_float(dt)
                               and _bits(dt) <= 11 for _, dt in in_dts):
                acc_bits = max(acc_bits, _BITS["float32"])
            if acc_bits < accum_bits and reduces:
                self._add(
                    "FML601", ("FML601", name, _name(out_dt)),
                    f"{name} accumulates in {_name(out_dt)}, narrower than "
                    f"policy.accum ({policy.accum})",
                    fix="cast the operand up before reducing (or pass "
                        "dtype=) so the running sum carries policy.accum "
                        "precision",
                )
            elif acc_bits < accum_bits and dots:
                self._add(
                    "FML601", ("FML601", "dot", _name(out_dt)),
                    f"{name} accumulator runs at {_name(out_dt)}, narrower "
                    f"than policy.accum ({policy.accum})",
                    fix="multiply at policy.compute and accumulate at "
                        "policy.accum (cast the operands up, or take the "
                        "product in the accumulation dtype)",
                )
            elif (acc_bits < accum_bits and ns == "aten"
                  and base in _UPDATE_PRIMITIVES and (joined & _PARAMISH)):
                self._add(
                    "FML601", ("FML601", "update", base, _name(out_dt)),
                    f"parameter/optimizer-state update ({name}) runs at "
                    f"{_name(out_dt)}, narrower than policy.accum "
                    f"({policy.accum}) — each step rounds the state, "
                    "divergence compounds",
                    fix="store state at policy.params, cast to "
                        "policy.compute at the step boundary for the "
                        "forward work, and run every state update at "
                        "policy.accum",
                )

        compute_bits = _bits(policy.compute)
        if (out_is_float and ns == "aten" and base in _PROMOTION_PRIMITIVES
                and _bits(out_dt) > compute_bits):
            at_compute = any(
                (dt is not None and _is_float(dt) and _bits(dt) == compute_bits)
                or self.widened_from.get(a) == compute_bits
                for a, dt in in_dts)
            wide_const = any(
                self.prov.get(a, frozenset({"const"})) <= frozenset({"const"})
                and dt is not None and _is_float(dt)
                and _bits(dt) > compute_bits and _ndim(a) > 0
                for a, dt in in_dts)
            if at_compute and wide_const:
                self._add(
                    "FML602", ("FML602", base, _name(out_dt)),
                    f"a strong {_name(out_dt)} constant promotes a "
                    f"{policy.compute} value to {_name(out_dt)} inside the "
                    f"compute region ({name}) — the whole downstream chain "
                    "runs wide, defeating the narrow compute the policy "
                    "declared",
                    fix="use a Python scalar or a 0-d tensor (neither "
                        "promotes), or cast the constant to policy.compute",
                )


def _ndim(node) -> int:
    from flinkml_tpu_torch.analysis._capture import val

    v = val(node)
    return int(getattr(v, "dim", lambda: 0)())


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def check_closed_jaxpr(
    graph,
    policy,
    invar_roles: Optional[Sequence[str]] = None,
    invar_names: Optional[Sequence[str]] = None,
    program: str = "program",
    location: Optional[str] = None,
) -> List[Finding]:
    """FML601/602/603/604/606/607 over one captured graph (the port's
    closed jaxpr). ``invar_roles`` labels each placeholder ``"param"`` or
    ``"data"`` (default: all data); ``invar_names`` names the leaves for
    FML603/607 messages."""
    from flinkml_tpu_torch.analysis._capture import placeholders, val

    phs = placeholders(graph)
    roles = list(invar_roles or ())
    roles += ["data"] * (len(phs) - len(roles))
    names = list(invar_names or ())
    names += [f"arg{i}" for i in range(len(names), len(phs))]

    flow = _Flow(policy, program, location)
    params_bits = _bits(policy.params)
    quant = getattr(policy, "quant", None)
    for node, role, name in zip(phs, roles, names):
        dt = _dtype_of(val(node))
        if dt is None or role != "param":
            continue
        if _is_float(dt) and _bits(dt) < params_bits:
            flow._add(
                "FML603", ("FML603", name),
                f"parameter/optimizer-state leaf {name!r} is stored as "
                f"{_name(dt)}, narrower than policy.params ({policy.params})",
                fix="keep master weights and optimizer moments at "
                    "policy.params; cast to policy.compute only at the "
                    "step boundary",
                column=name,
            )
        if _is_int8(dt) and quant is None:
            flow._add(
                "FML607", ("FML607", name),
                f"parameter leaf {name!r} is stored as int8 but policy "
                f"{policy.name!r} declares no quantization scheme — "
                "quantized params are republished as the full-width "
                f"({policy.params}) tier",
                fix="serve quantized models under the int8 tier "
                    "(PrecisionPolicy quant='int8', preset "
                    "'int8_inference') or republish the full-width "
                    "master weights",
                column=name,
            )
    flow.walk(graph, roles)
    return flow.findings


def check_precision_fn(
    fn,
    *example_args,
    policy,
    param_argnums: Iterable[int] = (),
    program: str = "program",
    location: Optional[str] = None,
    axis_env=None,
) -> List[Finding]:
    """Capture ``fn`` abstractly (shapes and dtypes only) and run the
    precision-flow pass. ``param_argnums`` marks the arguments holding
    parameters or optimizer state. ``axis_env`` is accepted for the JAX
    package's signature: a capture binds no named axis (a collective
    carries its axes itself)."""
    from flinkml_tpu_torch.analysis._capture import (
        capture,
        leaf_roles,
        placeholders,
    )

    del axis_env
    gm = capture(fn, *example_args)
    roles, names = leaf_roles(example_args, tuple(param_argnums),
                              len(placeholders(gm)))
    return check_closed_jaxpr(gm, policy, invar_roles=roles,
                              invar_names=names, program=program,
                              location=location)


def validate_precision(
    fn,
    *example_args,
    policy,
    param_argnums: Iterable[int] = (),
    program: str = "program",
    location: Optional[str] = None,
    axis_env=None,
    extra_findings: Iterable[Finding] = (),
) -> None:
    """Run the pass and raise the typed
    :class:`~flinkml_tpu_torch.precision.PrecisionValidationError` on any
    error-severity finding."""
    from flinkml_tpu_torch.precision import raise_findings

    findings = list(extra_findings) + check_precision_fn(
        fn, *example_args, policy=policy, param_argnums=param_argnums,
        program=program, location=location, axis_env=axis_env,
    )
    raise_findings(findings, program, policy)


def check_policy_plan(policy, dtype_bytes: Optional[int] = None,
                      plan_name: Optional[str] = None,
                      location: Optional[str] = None) -> List[Finding]:
    """FML605 (:func:`flinkml_tpu_torch.precision.check_policy_plan`)."""
    from flinkml_tpu_torch.precision import check_policy_plan as impl

    return impl(policy, dtype_bytes=dtype_bytes, plan_name=plan_name,
                location=location)


# ---------------------------------------------------------------------------
# *.policy.json fixtures / configs
# ---------------------------------------------------------------------------


def _example_program(spec_map: Mapping):
    """The example program a policy file names: ``(fn, example_args,
    param_argnums)``. The trainer programs are the port's own step
    (:func:`flinkml_tpu_torch.sharding.apply.linear_step_fn`), so a file
    exercises the step the product runs."""
    import torch

    from flinkml_tpu_torch.analysis._capture import spec, torch_dtype

    name = str(spec_map.get("name", ""))
    dim = int(spec_map.get("dim", 8))
    rows = int(spec_map.get("rows", 8))
    dtype = torch_dtype(str(spec_map.get("dtype", "float32")))

    if name in ("sgd_step", "adam_step"):
        from flinkml_tpu_torch.sharding.apply import (
            init_linear_state,
            linear_step_fn,
        )

        optimizer = "sgd" if name == "sgd_step" else "adam"
        step = linear_step_fn(
            loss=str(spec_map.get("loss", "logistic")), optimizer=optimizer,
            dtype_name=_name(dtype), learning_rate=0.1, momentum=0.9,
            reg_l2=0.0, reg_l1=0.0, policy=None,
        )
        state = init_linear_state(dim, optimizer, _name(dtype))
        batch = spec((rows, dim), dtype)
        vec = spec((rows,), dtype)
        return step, (state, batch, vec, vec), (0,)
    if name == "stray_constant_chain":
        # A dimensioned float32 tensor: PyTorch's strong constant.
        const = torch.tensor([float(spec_map.get("constant", 1.5))],
                             dtype=torch.float32)

        def chain(x):
            return x * const

        return chain, (spec((rows, dim), dtype),), ()
    if name == "state_passthrough":
        # Pure identity: the ONLY thing checkable is how the state is
        # STORED — isolates FML603 from FML601.
        def ident(state):
            return state

        state = {"coef": spec((dim,), dtype),
                 "momentum": spec((dim,), dtype)}
        return ident, (state,), (0,)
    if name == "psum_gradient":
        from flinkml_tpu_torch.parallel import collectives

        axis = str(spec_map.get("axis", "data"))

        def grad_sync(g):
            # A capture needs no mesh: the op carries its axis.
            return collectives.psum(None, g, axis)

        return grad_sync, (spec((dim,), dtype),), ()
    if name == "int8_unscaled_matmul":
        # The FML606 shape: int8 weights multiplied while still codes.
        def unscaled(q, x):
            return torch.matmul(x, q)

        return (unscaled, (spec((dim, dim), torch.int8),
                           spec((rows, dim), torch.int8)), (0,))
    if name == "int8_state_passthrough":
        def ident(state):
            return state

        state = {"coef_q": spec((dim, dim), torch.int8),
                 "coef_scale": spec((dim,), torch.float32)}
        return ident, (state,), (0,)
    raise ValueError(
        f"unknown example program {name!r} (known: sgd_step, adam_step, "
        "stray_constant_chain, state_passthrough, psum_gradient, "
        "int8_unscaled_matmul, int8_state_passthrough)"
    )


def check_policy_file(path: str) -> List[Finding]:
    """Validate a ``*.policy.json`` fixture/config (the JAX package's
    schema: ``policy``, an optional example ``program`` checked for
    FML601–607, an optional ``plan`` width checked for FML605).
    Unreadable or malformed files report one FML601 finding naming the
    path — the gate must fail loudly, not skip silently."""
    from flinkml_tpu_torch.precision import PrecisionPolicy

    try:
        with open(path, "r") as fh:
            doc = json.load(fh)
        policy = PrecisionPolicy.from_json_dict(doc["policy"])
        program = doc.get("program")
        plan = doc.get("plan") or {}
    except (OSError, ValueError, KeyError, TypeError) as e:
        return [Finding(
            "FML601",
            f"precision-policy file {path} is unreadable or malformed: "
            f"{e!r}",
            location=path,
            fix_hint="see flinkml_tpu_torch/analysis/precision.py for the "
                     "*.policy.json schema",
        )]
    findings: List[Finding] = []
    if program is not None:
        # The guard spans the capture too: a field the step checks only
        # when it runs (the loss name) becomes this file's one finding.
        try:
            fn, args, param_argnums = _example_program(program)
            file_findings = check_precision_fn(
                fn, *args, policy=policy, param_argnums=param_argnums,
                program=str(program.get("name")), location=path,
            )
        except (ValueError, TypeError) as e:
            return [Finding(
                "FML601",
                f"precision-policy file {path} names a bad program: {e}",
                location=path,
                fix_hint="see flinkml_tpu_torch/analysis/precision.py",
            )]
        findings.extend(file_findings)
    findings.extend(check_policy_plan(
        policy, dtype_bytes=plan.get("dtype_bytes"),
        plan_name=plan.get("name"), location=path,
    ))
    return findings


# ---------------------------------------------------------------------------
# FML106 — silent float64 promotion, through the same walk
# ---------------------------------------------------------------------------


def _widening_sites(graph, out: List[str]) -> None:
    """aten op names of nodes that produce float64 from all-narrower float
    operands — where a silent promotion happens."""
    from flinkml_tpu_torch.analysis._capture import op_name, tensor_inputs, val

    for node in graph.graph.nodes:
        if node.op != "call_function":
            continue
        dt = _dtype_of(val(node))
        if dt is None or _name(dt) != "float64":
            continue
        ins = [_dtype_of(val(a)) for a in tensor_inputs(node)]
        floats = [d for d in ins if d is not None and _is_float(d)]
        if floats and all(_name(d) != "float64" for d in floats):
            out.append(op_name(node)[1])


def promotion_findings(
    closed,
    input_dtypes: Sequence,
    output_dtypes: Mapping[str, Any],
    stage: Optional[str] = None,
    location: Optional[str] = None,
) -> List[Finding]:
    """FML106 over one (possibly fused multi-stage) program: every known
    float input is narrow but an output came back float64 — the widening
    happened inside, silently. ``closed`` (the captured graph that
    localizes the first widening op for the message) may be a zero-arg
    callable, invoked only once a finding is certain."""
    known = [d for d in input_dtypes if d is not None]
    if not known or any(not _is_float(d) or _name(d) == "float64"
                        for d in known):
        return []
    wide_outs = [name for name, d in output_dtypes.items()
                 if d is not None and _name(d) == "float64"]
    if not wide_outs:
        return []
    sites: List[str] = []
    if callable(closed) and not hasattr(closed, "graph"):
        closed = closed()
    if closed is not None:
        _widening_sites(closed, sites)
    at = f" (widened at {sites[0]!r})" if sites else ""
    ins = ", ".join(sorted({_name(d) for d in known}))
    return [Finding(
        "FML106",
        f"inputs are {ins} but output {name!r} is float64 "
        f"(silent promotion){at}",
        stage=stage, column=name, location=location,
        fix_hint="cast explicitly or preserve the input dtype; float64 "
                 "doubles bandwidth and memory",
    ) for name in wide_outs]
