"""PrecisionPolicy — the declared mixed-precision contract of serving.

The port's counterpart of ``flinkml_tpu.precision``. A policy names three
float widths and an optional quantization scheme:

- ``compute`` — the width the chain's elementwise and matmul work runs in
  (``bfloat16`` in the mixed tiers);
- ``accum`` — the least width any reduction (a dot, a distance sum, a
  softmax denominator) may run in;
- ``params`` — the width model constants are stored in;
- ``quant`` — ``"int8"``: eligible model constants travel as per-column
  absmax int8 codes with float32 scales (:func:`quantize_absmax`) and are
  dequantized to ``compute`` width inside the chain.

A policy is frozen and hashable (it keys the fused executor's program
cache, so a bfloat16, an int8 and a float32 program never alias) and
round-trips through JSON. The fused executor
(:mod:`flinkml_tpu_torch.pipeline_fusion`) checks every chain against the
active policy before it builds a program and raises
:class:`PrecisionValidationError` with the rule ids of the JAX package's
FML6xx pass.

``bfloat16`` is ``torch.bfloat16``; numpy has no bfloat16, so the host
helpers here (the quantizer) take numpy arrays of the other widths only.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

#: Canonical float dtype names a policy may declare.
_FLOAT_NAMES = ("bfloat16", "float16", "float32", "float64")

#: Significand widths (bits): the precision order accumulation cares about.
_SIGNIFICAND_BITS = {"bfloat16": 8, "float16": 11, "float32": 24,
                     "float64": 53}

TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "float64": torch.float64}


def float_name(dtype) -> str:
    """Canonical name of a float dtype (a name, a numpy dtype or a torch
    dtype)."""
    if isinstance(dtype, str) and dtype in _FLOAT_NAMES:
        return dtype
    if isinstance(dtype, np.dtype) and dtype.name in _FLOAT_NAMES:
        return dtype.name
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    if name not in _FLOAT_NAMES:
        raise ValueError(
            f"{dtype!r} is not a float dtype a PrecisionPolicy can "
            f"declare (one of {_FLOAT_NAMES})"
        )
    return name


def significand_bits(dtype) -> int:
    """Significand width of a float dtype; non-floats return a sentinel
    wider than every float (integer values never count as narrow)."""
    try:
        name = float_name(dtype)
    except ValueError:
        return 1 << 16
    return _SIGNIFICAND_BITS[name]


def is_narrower(a, b) -> bool:
    """Whether float dtype ``a`` rounds coarser than ``b``."""
    return significand_bits(a) < significand_bits(b)


def __getattr__(name: str):
    # ``precision.Finding`` is the analysis passes' class
    # (:class:`flinkml_tpu_torch.analysis.findings.Finding`), imported on
    # first use: the analysis package imports modules that import this one.
    if name == "Finding":
        from flinkml_tpu_torch.analysis.findings import Finding

        return Finding
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class PrecisionValidationError(ValueError):
    """A chain failed the precision check against its declared policy —
    raised before any program is built, carrying the findings."""

    def __init__(self, message: str, findings=()):
        super().__init__(message)
        self.findings = list(findings)


#: Quantization schemes a policy may declare for model constants.
_QUANT_SCHEMES = ("int8",)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """The declared ``(compute, accum, params)`` contract and an optional
    quantization scheme (see the module docstring)."""

    name: str = "custom"
    compute: str = "float32"
    accum: str = "float32"
    params: str = "float32"
    quant: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "compute", float_name(self.compute))
        object.__setattr__(self, "accum", float_name(self.accum))
        object.__setattr__(self, "params", float_name(self.params))
        if not self.quant:
            object.__setattr__(self, "quant", None)
        elif self.quant not in _QUANT_SCHEMES:
            raise ValueError(
                f"policy {self.name!r}: unknown quantization scheme "
                f"{self.quant!r} (one of {_QUANT_SCHEMES}, or None)"
            )
        if is_narrower(self.accum, self.compute):
            raise ValueError(
                f"policy {self.name!r}: accum ({self.accum}) narrower than "
                f"compute ({self.compute}) — accumulating below the compute "
                "width is never intentional"
            )

    @property
    def compute_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.compute]

    @property
    def accum_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.accum]

    @property
    def params_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.params]

    @property
    def mixed(self) -> bool:
        """Whether the policy narrows compute below params."""
        return is_narrower(self.compute, self.params)

    @property
    def declared(self) -> bool:
        """Whether the policy changes the chain: a mixed or a quantized
        tier casts every float input and constant to ``compute`` at the
        chain's boundary (``full`` leaves the chain as it is)."""
        return self.mixed or self.quant is not None

    def describe(self) -> str:
        return (f"{self.name}(compute={self.compute}, accum={self.accum}, "
                f"params={self.params})")

    def to_json_dict(self) -> dict:
        out = {"name": self.name, "compute": self.compute,
               "accum": self.accum, "params": self.params}
        if self.quant is not None:
            out["quant"] = self.quant
        return out

    @staticmethod
    def from_json_dict(d: Mapping) -> "PrecisionPolicy":
        quant = d.get("quant")
        return PrecisionPolicy(
            name=str(d.get("name", "custom")),
            compute=str(d.get("compute", "float32")),
            accum=str(d.get("accum", "float32")),
            params=str(d.get("params", "float32")),
            quant=None if quant in (None, "") else str(quant),
        )


#: Everything at float32 (the explicit other side of an A/B; no policy
#: leaves programs untouched).
FULL = PrecisionPolicy("full", "float32", "float32", "float32")
#: bfloat16 compute, float32 accumulation and parameters: refuses any
#: stage that accumulates in bfloat16 (the strict gate).
MIXED = PrecisionPolicy("mixed", "bfloat16", "float32", "float32")
#: bfloat16 compute and accumulation, float32 parameters: the serving tier.
MIXED_INFERENCE = PrecisionPolicy(
    "mixed_inference", "bfloat16", "bfloat16", "float32"
)
#: float32 compute and accumulation over int8-quantized model constants.
INT8_INFERENCE = PrecisionPolicy(
    "int8_inference", "float32", "float32", "float32", quant="int8"
)

PRESET_POLICIES = {
    p.name: p for p in (FULL, MIXED, MIXED_INFERENCE, INT8_INFERENCE)
}


def resolve_policy(policy) -> Optional[PrecisionPolicy]:
    """Accept a policy object, a preset name, a JSON dict, or None."""
    if policy is None or isinstance(policy, PrecisionPolicy):
        return policy
    if isinstance(policy, str):
        try:
            return PRESET_POLICIES[policy]
        except KeyError:
            raise ValueError(
                f"unknown precision preset {policy!r} (presets: "
                f"{sorted(PRESET_POLICIES)})"
            ) from None
    if isinstance(policy, Mapping):
        return PrecisionPolicy.from_json_dict(policy)
    raise TypeError(f"cannot interpret {policy!r} as a PrecisionPolicy")


# -- the trainer gate (FML601/603/604/605), from declared widths --------------


def check_policy_plan(policy: PrecisionPolicy,
                      dtype_bytes: Optional[int] = None,
                      plan_name: Optional[str] = None,
                      location: Optional[str] = None):
    """FML605 when a sharding plan's budget math assumed a parameter width
    (``dtype_bytes``, the width ``infer_plan``/FML503 used) other than
    ``policy.params``'s. None when no width was assumed."""
    from flinkml_tpu_torch.analysis.findings import Finding

    if dtype_bytes is None:
        return []
    want = int(policy.params_dtype.itemsize)
    if int(dtype_bytes) == want:
        return []
    label = f"plan {plan_name!r}" if plan_name else "the sharding plan"
    return [Finding(
        "FML605",
        f"{label} budgets parameters at {int(dtype_bytes)} B/elem but the "
        f"policy stores params as {policy.params} ({want} B/elem) — the "
        "HBM footprint the plan validated is not the footprint that will "
        "exist",
        stage=plan_name, location=location,
        fix_hint="validate the plan with dtype_bytes = the itemsize of "
                 "policy.params (and re-run infer_plan — a budget that fit "
                 "at 2 B may not fit at 4 B)",
    )]


def check_trainer_widths(policy: PrecisionPolicy, state, accumulations,
                         collectives=(), program: str = "program"):
    """FML601/603/604 for a trainer step from the widths it declares (the
    gate the trainers run before a step, with no capture on their path;
    :func:`flinkml_tpu_torch.analysis.precision.check_precision_fn` walks
    the step's capture for the same verdicts):

    - ``state``: ``{leaf name: dtype}`` of the stored parameters and
      optimizer state — FML603 for a leaf narrower than ``policy.params``;
    - ``accumulations``: ``{site: dtype}`` of every reduction, dot
      accumulator and state update — FML601 for one narrower than
      ``policy.accum``;
    - ``collectives``: ``(name, dtype, precast_from)`` of every cross-rank
      collective — FML604 for one narrower than ``policy.accum`` unless
      ``precast_from`` (the width it was explicitly cast down from, the
      sanctioned bandwidth trade) is at least ``policy.accum``.
    """
    from flinkml_tpu_torch.analysis.findings import Finding

    findings = []
    for name, dt in state.items():
        if significand_bits(dt) < significand_bits(policy.params):
            findings.append(Finding(
                "FML603",
                f"parameter/optimizer-state leaf {name!r} is stored as "
                f"{float_name(dt)}, narrower than policy.params "
                f"({policy.params})",
                column=name, stage=program,
                fix_hint="keep master weights and optimizer moments at "
                         "policy.params; cast to policy.compute only at the "
                         "step boundary",
            ))
    seen = set()
    for site, dt in accumulations.items():
        if significand_bits(dt) < significand_bits(policy.accum) \
                and site not in seen:
            seen.add(site)
            findings.append(Finding(
                "FML601",
                f"{site} accumulates in {float_name(dt)}, narrower than "
                f"policy.accum ({policy.accum})",
                stage=program,
                fix_hint="store state at policy.params, multiply at "
                         "policy.compute with a policy.accum accumulator, "
                         "and run every state update at policy.accum",
            ))
    for name, dt, precast_from in collectives:
        if significand_bits(dt) >= significand_bits(policy.accum):
            continue
        if precast_from is not None and \
                significand_bits(precast_from) >= significand_bits(policy.accum):
            continue
        findings.append(Finding(
            "FML604",
            f"collective {name!r} operates on {float_name(dt)} — narrower "
            f"than policy.accum ({policy.accum}) — without an explicit "
            "pre-cast",
            stage=program,
            fix_hint="run collectives at policy.accum, or cast down "
                     "explicitly right before the collective",
        ))
    return findings


def raise_findings(findings, program: str, policy: PrecisionPolicy) -> None:
    """Raise :class:`PrecisionValidationError` carrying ``findings`` (the
    JAX package's ``validate_precision`` message) when there are any."""
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        raise PrecisionValidationError(
            f"program {program!r} failed precision-flow validation "
            f"against policy {policy.describe()}:\n"
            + "\n".join(f.render() for f in errors),
            findings=errors,
        )


# -- post-training quantization (the int8 tier's storage transform) ----------

#: Float constants with fewer elements stay at float width under the int8
#: tier: the static fallback of :func:`int8_min_const_elems`.
INT8_MIN_CONST_ELEMS = 16

#: Explicit override of the int8 tier's smallest quantized constant.
ENV_INT8_MIN_CONST_VAR = "FLINKML_TPU_INT8_MIN_CONST"

_INT8_ENV_WARNED: set = set()


def int8_min_const_elems() -> int:
    """The int8 tier's minimum-constant-size threshold, with the JAX
    package's precedence: an explicit ``FLINKML_TPU_INT8_MIN_CONST`` > the
    tuning table's ``int8_min_const_elems`` for this thread's device >
    :data:`INT8_MIN_CONST_ELEMS`. A value that is not a positive integer
    degrades to the static default (an explicit one with one log line:
    never silently to the table's value, a third party neither the
    operator nor the docs named)."""
    from flinkml_tpu_torch.autotune import tuned_default

    env = os.environ.get(ENV_INT8_MIN_CONST_VAR)
    if env is not None:
        try:
            v = int(env)
        except ValueError:
            v = 0
        if v >= 1:
            return v
        if env not in _INT8_ENV_WARNED:
            _INT8_ENV_WARNED.add(env)
            from flinkml_tpu_torch.utils.logging import get_logger

            get_logger("precision").warning(
                "%s=%r is not a positive integer; using the static "
                "default %d", ENV_INT8_MIN_CONST_VAR, env,
                INT8_MIN_CONST_ELEMS,
            )
        return INT8_MIN_CONST_ELEMS
    try:
        v = int(tuned_default("int8_min_const_elems", INT8_MIN_CONST_ELEMS))
    except (TypeError, ValueError):
        return INT8_MIN_CONST_ELEMS
    return v if v >= 1 else INT8_MIN_CONST_ELEMS


def quantizable(arr, min_elems: Optional[int] = None) -> bool:
    """Whether the int8 tier quantizes this model constant: a float array
    of rank >= 1 with at least ``min_elems`` (default
    :data:`INT8_MIN_CONST_ELEMS`, as the JAX package's; the fused executor
    passes :func:`int8_min_const_elems`) elements."""
    a = np.asarray(arr)
    if a.dtype.kind != "f":
        return False
    limit = INT8_MIN_CONST_ELEMS if min_elems is None else min_elems
    return a.size >= int(limit) and a.ndim >= 1


def quantize_absmax(arr):
    """Per-column absmax int8 quantization of one model constant, bit for
    bit the JAX package's: rank >= 2 takes one scale per last-axis column,
    a vector one scale. Returns ``(q, scale)``: ``q`` int8 in
    ``[-127, 127]``, ``scale`` float32, ``q * scale ≈ arr``; an all-zero
    column gets scale 1.0."""
    a = np.asarray(arr)
    if a.ndim >= 2:
        absmax = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)))
    else:
        absmax = np.max(np.abs(a)) if a.size else np.float64(0.0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(
        np.rint(a / scale.astype(a.dtype)), -127, 127
    ).astype(np.int8)
    return q, scale


def dequantize_absmax(q, scale, dtype="float32"):
    """The inverse transform at ``dtype`` width (host reference)."""
    dt = np.dtype(dtype)
    return np.asarray(q).astype(dt) * np.asarray(scale).astype(dt)


class QuantizedConst(NamedTuple):
    """One int8-quantized model constant as a chain receives it: the codes
    and the float32 scales of :func:`quantize_absmax` (host arrays). The
    chain dequantizes ``q * scale`` at ``policy.compute`` width."""

    q: np.ndarray
    scale: np.ndarray


def cast_floats(tree, dtype):
    """Cast every floating tensor of a dict, list or tuple (nested) to
    ``dtype``; other leaves pass through."""
    dt = TORCH_DTYPES[float_name(dtype)] if not isinstance(
        dtype, torch.dtype) else dtype
    if isinstance(tree, Mapping):
        return type(tree)((k, cast_floats(v, dt)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_floats(v, dt) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dt) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype.is_floating_point:
        return tree.to(dt)
    return tree


# -- the policy a running chain computes under -------------------------------

_RUN = threading.local()


def chain_policy() -> Optional[PrecisionPolicy]:
    """The policy of the chain running on this thread (None outside a
    chain, and for a chain with no policy). Stage functions read it: the
    per-stage transforms call the same functions outside any chain, so a
    policy never reaches them."""
    return getattr(_RUN, "value", None)


class running_under:
    """Pin ``policy`` as :func:`chain_policy` while a chain runs."""

    def __init__(self, policy: Optional[PrecisionPolicy]):
        self._policy = policy
        self._prev = None

    def __enter__(self):
        self._prev = chain_policy()
        _RUN.value = self._policy
        return self._policy

    def __exit__(self, *exc):
        _RUN.value = self._prev
        return False
