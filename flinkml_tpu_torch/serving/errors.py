"""Typed serving errors — the admission-control and registry contract.

Every rejection the online path can hand a client is a *named* error, so
callers can branch on failure mode (retry on overload, surface timeouts,
page on integrity failures) instead of parsing messages. The model-data
integrity error lives with the persistence layer
(:class:`flinkml_tpu_torch.io.read_write.ModelIntegrityError`) and is re-exported
here because the registry is where operators meet it.
"""

from __future__ import annotations

from flinkml_tpu_torch.io.read_write import ModelIntegrityError  # noqa: F401


class ServingError(RuntimeError):
    """Base class of every serving-runtime error."""


class ServingOverloadError(ServingError):
    """The request was rejected at admission: the bounded request queue
    is full and shedding to the host path is disabled
    (``ServingConfig.shed_on_overload=False``). Back off and retry."""


class ServingTimeoutError(ServingError, TimeoutError):
    """The request's deadline expired before a result was produced —
    either while queued (the dispatcher rejects expired requests at
    batch formation) or while waiting on an in-flight batch."""


class EngineStoppedError(ServingError):
    """The engine is not running (never started, or stopped); queued
    requests are failed with this at shutdown rather than left hanging."""


class ServingSchemaError(ServingError, ValueError):
    """A request's columns do not match the engine's input schema (names,
    trailing shapes) fixed by the warmup example at load time."""


class ServingMemoryError(ServingError):
    """A model was refused at load/swap time because its estimated
    per-device memory footprint (learned arrays at the engine's precision
    tier, plus batch buffers at the largest dispatch bucket — see
    :func:`flinkml_tpu_torch.analysis.memory.estimate_serving_bytes`) exceeds
    ``ServingConfig.hbm_budget_bytes``. Raised BEFORE the active-model
    flip, so a follower's refused swap keeps the previous model serving
    — the ``refuse_nonfinite`` idiom applied to capacity."""


class SLOAdmissionError(ServingOverloadError):
    """A multi-tenant request was refused at CLASS admission: its SLO
    class's share of pool capacity (``SLOClass.max_queue_share``) is
    fully in flight. A :class:`ServingOverloadError` subclass — the
    remedy is the same (back off and retry) — but named so a batch
    client can tell "my class budget is spent" from "the whole pool is
    saturated": the former is working as designed (the interactive tier
    keeps its headroom), the latter is a capacity page."""


class PoolUnavailableError(ServingError):
    """The replica pool has no healthy replica left to route to — every
    replica is unhealthy or draining. Distinct from
    :class:`ServingOverloadError` (healthy replicas exist but every
    bounded queue is full): this one pages, that one backs off."""


class RegistryError(RuntimeError):
    """Base class of model-registry errors."""


class ModelVersionNotFoundError(RegistryError, KeyError):
    """The requested model version does not exist in the registry (or the
    registry has no published versions yet)."""


class DeltaChainError(RegistryError):
    """An incremental (delta) version cannot be resolved to a model: its
    base version is pruned, a fingerprint along the chain does not match
    the state it claims to patch, or the base is not delta-capable. The
    message names the exact broken link (``version N -> base M``) — the
    registry NEVER silently falls back to a stale or fresh model (the
    ``restore_latest`` contract, extended to delta chains)."""


__all__ = [
    "ModelIntegrityError",
    "PoolUnavailableError",
    "SLOAdmissionError",
    "ServingError",
    "ServingOverloadError",
    "ServingTimeoutError",
    "EngineStoppedError",
    "ServingSchemaError",
    "ServingMemoryError",
    "RegistryError",
    "ModelVersionNotFoundError",
    "DeltaChainError",
]
