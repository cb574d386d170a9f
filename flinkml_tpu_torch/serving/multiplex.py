"""Multi-model multiplexing with SLO-weighted admission.

One :class:`MultiModelPool` serves N models over ONE replica pool and one
device universe. Each registered model gets its own source (registry or
fixed stage), its own replicas (each replica serves exactly one model —
the fused executor's programs are per-chain, so mixing models in one
batch is never possible anyway), and an :class:`SLOClass` that states how
the model's traffic shares the pool:

- ``deadline_ms`` — the class's default per-request deadline budget
  (interactive requests get a short one and fail fast; batch requests
  get a long one and wait their turn).
- ``max_queue_share`` — the fraction of AGGREGATE pool queue capacity
  the class may hold in flight. This is the anti-starvation mechanism,
  enforced at ADMISSION in :meth:`MultiModelPool.predict`: a batch class
  capped at 0.5 can never occupy more than half the pool's queue slots
  OR more than its bounded share of the device plane's time (in-flight
  rows are what contend for dispatch), so the interactive tier always
  has admission headroom and bounded queue-wait no matter how hard a
  batch job pushes. Refusals are the typed
  :class:`~flinkml_tpu_torch.serving.errors.SLOAdmissionError` — a batch
  client backing off is the system working, not an incident.
- ``weight`` — the class's priority for SCALING decisions: the
  autoscaler's multi-model target picks the model with the highest
  weight × backlog, so a contended interactive model receives new
  replicas before a contended batch model
  (:meth:`MultiModelPool.scale_target`).

Routing stays the pool's least-outstanding-rows balance, filtered to the
target model's replicas (``Router.predict(model_id=...)``); failover,
per-replica degradation, and retirement are inherited unchanged. Every
model with a registry source participates in rolling hot-swaps
independently (:meth:`MultiModelPool.follow_registries`).

Per-class observability (``serving.<pool>.admission``, one labeled group
per class): ``admitted_requests`` / ``admitted_rows`` /
``budget_rejections`` counters, ``outstanding_rows`` and per-class
``p50_ms`` / ``p99_ms`` latency gauges — the per-class-SLO dashboards'
families.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Union

import torch

from flinkml_tpu_torch.device import requested_device
from flinkml_tpu_torch.serving.engine import ServingConfig
from flinkml_tpu_torch.serving.errors import RegistryError, SLOAdmissionError
from flinkml_tpu_torch.serving.health import HealthPolicy, ReplicaState
from flinkml_tpu_torch.serving.pool import Replica, ReplicaPool
from flinkml_tpu_torch.serving.registry import ModelRegistry
from flinkml_tpu_torch.table import Table
from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import LatencyWindow, metrics

_log = get_logger("serving.multiplex")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service-level class (see module docstring)."""

    name: str
    weight: float = 1.0
    deadline_ms: Optional[float] = None
    max_queue_share: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"SLO class {self.name!r}: weight must be > 0")
        if not 0.0 < self.max_queue_share <= 1.0:
            raise ValueError(
                f"SLO class {self.name!r}: max_queue_share must be in "
                f"(0, 1], got {self.max_queue_share}"
            )


#: The latency tier: full pool access, short deadline budget, priority
#: weight for scaling.
INTERACTIVE = SLOClass(
    "interactive", weight=3.0, deadline_ms=1000.0, max_queue_share=1.0
)

#: The throughput tier: long deadline budget, capped at half the pool's
#: capacity so it can NEVER starve the interactive tier.
BATCH = SLOClass(
    "batch", weight=1.0, deadline_ms=30_000.0, max_queue_share=0.5
)


@dataclasses.dataclass
class _ModelEntry:
    model_id: str
    source: Any
    slo: SLOClass
    registry: Optional[ModelRegistry]


class _ClassLedger:
    """Per-class in-flight accounting + latency window (thread-safe)."""

    def __init__(self, pool_name: str, slo: SLOClass, window: int = 2048):
        self.slo = slo
        self.outstanding_rows = 0
        self._lock = threading.Lock()
        self.metrics = metrics.group(
            f"serving.{pool_name}.admission",
            labels={"slo_class": slo.name},
        )
        # The ONE p50/p99 gauge implementation, shared with the engine
        # (utils.metrics.LatencyWindow) — per-class dashboards must
        # never disagree with per-engine ones about the same traffic.
        self._latency = LatencyWindow(self.metrics, window)

    def try_admit(self, rows: int, budget_rows: float) -> bool:
        with self._lock:
            if self.outstanding_rows + rows > budget_rows:
                return False
            self.outstanding_rows += rows
        self.metrics.counter("admitted_requests")
        self.metrics.counter("admitted_rows", float(rows))
        self.metrics.gauge("outstanding_rows", float(self.outstanding_rows))
        return True

    def settle(self, rows: int) -> None:
        with self._lock:
            self.outstanding_rows = max(0, self.outstanding_rows - rows)
        self.metrics.gauge("outstanding_rows", float(self.outstanding_rows))

    def record_latency(self, latency_ms: float) -> None:
        self._latency.record(latency_ms)


class MultiModelPool(ReplicaPool):
    """N registries over one pool — see module docstring.

    Starts EMPTY; register models with :meth:`add_model`, then
    :meth:`start`. ``example`` fixes the request schema shared by every
    model (multi-tenant fronts serve one feature schema; register
    another pool for another schema). ``share_compiles`` is
    :class:`~flinkml_tpu_torch.serving.pool.ReplicaPool`'s."""

    def __init__(
        self,
        example: Table,
        *,
        config: Optional[ServingConfig] = None,
        devices: Optional[List[Any]] = None,
        name: str = "mmpool",
        health_policy: Optional[HealthPolicy] = None,
        share_compiles: bool = True,
        grayfail: Optional[Any] = None,
    ):
        self._init_core(
            None, example, config=config, output_cols=None,
            name=name, health_policy=health_policy,
            grayfail=grayfail, share_compiles=share_compiles,
        )
        if devices is None:
            devices = [requested_device()]
        self._device_universe = [torch.device(d) for d in devices]
        self._models: Dict[str, _ModelEntry] = {}
        self._ledgers: Dict[str, _ClassLedger] = {}

    # -- model registration ------------------------------------------------
    def add_model(self, model_id: str, source: Any,
                  slo: SLOClass = INTERACTIVE,
                  n_replicas: int = 1) -> None:
        """Register one model (a :class:`ModelRegistry` or fixed stage)
        under an SLO class, with ``n_replicas`` initial replicas placed
        round-robin on the pool's device universe. Call before or after
        :meth:`start` — replicas added to a started pool warm before
        they join rotation, like any scale-up."""
        if model_id in self._models:
            raise ValueError(f"model {model_id!r} already registered")
        entry = _ModelEntry(
            model_id=model_id, source=source, slo=slo,
            registry=source if isinstance(source, ModelRegistry) else None,
        )
        self._models[model_id] = entry
        if slo.name not in self._ledgers:
            self._ledgers[slo.name] = _ClassLedger(self.name, slo)
        for _ in range(int(n_replicas)):
            self.add_replica(source=source, model_id=model_id)

    def models(self) -> Dict[str, SLOClass]:
        return {mid: e.slo for mid, e in self._models.items()}

    def _entry(self, model_id: str) -> _ModelEntry:
        try:
            return self._models[model_id]
        except KeyError:
            raise KeyError(
                f"no model {model_id!r} in pool {self.name} (registered: "
                f"{sorted(self._models)})"
            ) from None

    # -- the request path --------------------------------------------------
    def predict(self, model_id: str,
                features: Union[Table, Mapping[str, Any]],
                timeout_ms: Optional[float] = None):
        """Route one request to ``model_id``'s replicas, under its SLO
        class's admission budget and deadline (an explicit
        ``timeout_ms`` wins over the class default). Raises the typed
        :class:`~flinkml_tpu_torch.serving.errors.SLOAdmissionError` when the
        class's capacity share is fully in flight."""
        entry = self._entry(model_id)
        ledger = self._ledgers[entry.slo.name]
        if entry.slo.name in self.brownout_shed_classes:
            # Brownout ladder: under pool-WIDE degradation the guard
            # sheds whole SLO classes in declared order (batch first)
            # so the surviving tiers keep their latency — the typed
            # refusal batch clients already know how to back off from.
            ledger.metrics.counter("brownout_rejections")
            raise SLOAdmissionError(
                f"SLO class {entry.slo.name!r} is shed by the pool's "
                "brownout ladder (pool-wide degradation); back off and "
                "retry"
            )
        rows = self._rows_of(features)
        budget = entry.slo.max_queue_share * self._total_capacity()
        if not ledger.try_admit(rows, budget):
            ledger.metrics.counter("budget_rejections")
            raise SLOAdmissionError(
                f"SLO class {entry.slo.name!r} has its full "
                f"{entry.slo.max_queue_share:.0%} share of pool capacity "
                f"({budget:.0f} rows) in flight; back off and retry"
            )
        # Untimed requests inherit a FINITE deadline: the class default,
        # else the pool-level knob — a stalled replica must never hold a
        # caller (and its admission share) forever.
        timeout = (
            timeout_ms if timeout_ms is not None else entry.slo.deadline_ms
        )
        if timeout is None:
            timeout = self._base_config.default_timeout_ms
        t0 = time.monotonic()
        try:
            # The ledger releases in the finally: with per-attempt
            # abandonment this is ABANDONMENT time, not straggler
            # completion time — router.predict returns/raises the moment
            # it stops waiting, never when a stalled replica finishes.
            # Hedges are admitted once (here), never per attempt.
            resp = self._router.predict(
                features, timeout_ms=timeout, model_id=model_id
            )
        finally:
            ledger.settle(rows)
        ledger.record_latency((time.monotonic() - t0) * 1000.0)
        return resp

    def _total_capacity(self) -> float:
        # LIVE capacity only: counting retired (UNHEALTHY, stopped)
        # replicas would let a capped class occupy 100% of what is
        # actually serving — the exact starvation the share cap exists
        # to prevent.
        return float(sum(
            r.engine.config.max_queue_rows for r in self.replicas
            if r.health.state is not ReplicaState.UNHEALTHY
        )) or 1.0

    # -- scaling hooks (consumed by PoolAutoscaler) ------------------------
    def scale_target(self) -> Dict[str, Any]:
        """The neediest model for the next scale-up: highest SLO weight
        × per-model backlog fraction (ties: fewest replicas). Returns
        ``add_replica`` kwargs."""
        best_id, best_score = None, -1.0
        # Snapshot: add_model() may insert concurrently (the autoscaler
        # thread iterates here).
        for mid, entry in list(self._models.items()):
            mine = [r for r in self.replicas if r.model_id == mid]
            healthy = [
                r for r in mine if r.health.state is ReplicaState.HEALTHY
            ]
            capacity = sum(
                r.engine.config.max_queue_rows for r in healthy
            ) or 1.0
            queued = sum(
                max(r.health.outstanding_rows, r.engine.queued_rows)
                for r in healthy
            )
            backlog = queued / capacity
            # A model with NO healthy replica is the neediest of all.
            score = entry.slo.weight * (
                backlog if healthy else float("inf")
            )
            if score > best_score or (
                score == best_score and best_id is not None
                and len(mine) < len([
                    r for r in self.replicas if r.model_id == best_id
                ])
            ):
                best_id, best_score = mid, score
        if best_id is None:
            return {}
        entry = self._models[best_id]
        return {"source": entry.source, "model_id": best_id}

    def _scale_down_victim(self) -> Replica:
        """Never remove a model's LAST replica: victims come from models
        with >= 2 healthy replicas, least-loaded first, lowest SLO
        weight first among equals."""
        per_model: Dict[str, int] = {}
        for r in self.replicas:
            if r.health.state is ReplicaState.HEALTHY:
                per_model[r.model_id] = per_model.get(r.model_id, 0) + 1
        candidates = [
            r for r in self.replicas
            if r.health.state is ReplicaState.HEALTHY
            and per_model.get(r.model_id, 0) >= 2
        ]
        if not candidates:
            raise ValueError(
                f"pool {self.name}: every model is at its last healthy "
                "replica; refusing scale-down"
            )
        def rank(r: Replica):
            slo = self._models[r.model_id].slo if r.model_id in self._models \
                else INTERACTIVE
            return (r.health.outstanding_rows, slo.weight)
        return min(candidates, key=rank)

    # -- rolling hot-swap (per model) --------------------------------------
    def follow_registry(self) -> "MultiModelPool":
        return self.follow_registries()

    def follow_registries(self) -> "MultiModelPool":
        """Roll every model registry's publishes/rollbacks across THAT
        model's replicas, one at a time (the single-model pool's rolling
        contract, per tenant)."""
        any_registry = False
        for mid, entry in list(self._models.items()):
            if entry.registry is None:
                continue
            any_registry = True
            if getattr(entry, "_listener", None) is None:
                listener = (lambda version, mid=mid: self._roll_model(mid))
                entry.registry.add_listener(listener)
                entry._listener = listener
            self._roll_model(mid)
        if not any_registry:
            raise RegistryError(
                "follow_registries requires at least one "
                "ModelRegistry-backed model"
            )
        self._following = True
        return self

    def _roll_model(self, model_id: str) -> None:
        entry = self._entry(model_id)
        if entry.registry is None:
            return
        with self._roll_lock:
            for replica in list(self.replicas):
                if replica.model_id != model_id:
                    continue
                if replica.health.state is ReplicaState.UNHEALTHY:
                    continue
                current = entry.registry.current_version()
                if current is None:
                    return
                if replica.engine.active_version != current:
                    replica.engine.swap_to(current)
                    self._metrics.counter("rolled_swaps")

    def revive(self, replica_name: str) -> None:
        """Operator path, model-aware: the base revive would re-sync
        through the pool-level registry — always None here (models
        carry their own). Restart + health reset + sibling EWMA seed
        are inherited semantics; the version re-sync happens through
        the replica's OWN model registry (``engine.start`` reloads
        CURRENT, and a followed registry re-rolls the model)."""
        replica = self._replica(replica_name)
        replica.engine.start()
        replica.health.revive()
        self._seed_ewma(replica)
        self._update_health_gauge()
        if replica.model_id in self._models:
            entry = self._models[replica.model_id]
            if entry.registry is not None:
                self._roll_model(replica.model_id)

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        # Registry listeners are per model here, not the base pool's
        # single-source listener — unfollow each, then delegate (the
        # base's registry branch is a no-op with _registry=None, and
        # its replica-stop semantics must not be forked).
        for entry in self._models.values():
            listener = getattr(entry, "_listener", None)
            if listener is not None and entry.registry is not None:
                entry.registry.remove_listener(listener)
                entry._listener = None
        self._following = False
        super().stop(drain=drain, timeout=timeout)

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        base = super().stats()
        base["models"] = {
            mid: {
                "slo_class": e.slo.name,
                "weight": e.slo.weight,
                "replicas": [
                    r.name for r in self.replicas if r.model_id == mid
                ],
            }
            for mid, e in self._models.items()
        }
        base["classes"] = {
            name: {
                "outstanding_rows": ledger.outstanding_rows,
                "max_queue_share": ledger.slo.max_queue_share,
                "counters": ledger.metrics.snapshot()["counters"],
                "gauges": ledger.metrics.snapshot()["gauges"],
            }
            for name, ledger in self._ledgers.items()
        }
        return base
