"""Replica pool: N serving engines behind one router — serving scale-out.

The reference serves models through Flink's parallel task slots; here
the slot is a :class:`~flinkml_tpu_torch.serving.engine.ServingEngine` replica
and the parallelism substrate is the device plane. A
:class:`ReplicaPool` spins up one engine per **device** placement (the
fused executor's single-device programs dispatch lock-free and in
parallel; each replica's dispatcher thread runs on its device under
:func:`~flinkml_tpu_torch.device.use_device`, on a CUDA stream of its
own) or per **mesh slice** (each replica holds
``local_execution_lock(slice)`` per batch, so pools time-share devices
with concurrent training exactly like concurrent fits do, and the slice
locks compose through ``parallel.dispatch``'s overlap machinery).
Replicas repeat over the given devices: ``n_replicas=8`` on a host with
one card gives eight engines on ``cuda:0``, each on its own stream, all
sharing the one build of each kernel and the fused executor's programs.
The port runs one device per process, so a mesh slice is a one-device
mesh.

What the pool adds over N independent engines:

- **One front door** — :meth:`predict` routes through a
  :class:`~flinkml_tpu_torch.serving.router.Router`:
  least-outstanding-rows balance, deadline-aware admission, and
  automatic failover of pure transforms.
- **Per-replica degradation** — a replica that trips its queue bound
  drains and rejoins; one that fails its dispatches (e.g. the
  ``serving.replica`` fault seam killing it mid-traffic) is retired
  (stopped without drain, so its queued requests fail fast into the
  router's retry) while the pool keeps serving. No global brownout.
- **Rolling hot-swap** — :meth:`follow_registry` registers ONE pool
  listener and rolls each publish/rollback across the replicas one at a
  time, re-reading the registry's CURRENT pointer at every step: each
  engine's swap is individually zero-downtime, at most one replica is
  warming at any moment (never all down at once), and a rollback racing
  a publish converges every replica to whatever the pointer last said
  (the registry serializes deliveries and re-reads the pointer per
  delivery, so the final roll always carries the newest version).

Metrics: every replica's engine reports into ONE group
(``serving.<pool>``) distinguished by a ``replica`` label, so
per-replica gauges aggregate in the Prometheus exposition instead of
colliding; pool-level routing counters live in ``serving.<pool>.router``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from flinkml_tpu_torch.device import requested_device

from flinkml_tpu_torch.serving.engine import ServingConfig, ServingEngine
from flinkml_tpu_torch.serving.errors import RegistryError
from flinkml_tpu_torch.serving.health import HealthPolicy, ReplicaHealth, ReplicaState
from flinkml_tpu_torch.serving.registry import ModelRegistry
from flinkml_tpu_torch.serving.router import Router
from flinkml_tpu_torch.table import Table
from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import metrics

_log = get_logger("serving.pool")


def slice_meshes(n_slices: int, devices: Optional[Sequence[Any]] = None,
                 plan: Optional[Any] = None) -> List[Any]:
    """Cut the devices (ranks of the default process group, one device
    each; default: every rank) into ``n_slices`` disjoint meshes — the
    per-replica placement for mesh-bound serving. Disjoint slices get
    independent ``local_execution_lock``s (replicas dispatch
    concurrently); a slice overlapping a training mesh composes every
    intersecting lock, which is what keeps a pool safe beside training.

    The port runs one device per process, so every slice must be ONE
    device: ``n_slices`` must equal the number of devices, else
    ``ValueError``. ``plan`` shapes each slice for the plan's required
    axes via ``DeviceMesh.for_plan``."""
    import torch.distributed as dist

    from flinkml_tpu_torch.parallel import DeviceMesh

    if devices is None:
        grouped = dist.is_available() and dist.is_initialized()
        devices = list(range(dist.get_world_size() if grouped else 1))
    n_slices = int(n_slices)
    if not 1 <= n_slices <= len(devices):
        raise ValueError(
            f"cannot cut {len(devices)} devices into {n_slices} slices"
        )
    if len(devices) % n_slices:
        # Silently dropping the remainder would quietly serve on fewer
        # devices than the operator provisioned.
        raise ValueError(
            f"{len(devices)} devices do not divide into {n_slices} equal "
            f"slices; pass an explicit devices= subset"
        )
    per = len(devices) // n_slices
    if per != 1:
        raise ValueError(_ONE_DEVICE_SLICE.format(per))
    chunks = [list(devices[i * per:(i + 1) * per]) for i in range(n_slices)]
    if plan is not None:
        return [DeviceMesh.for_plan(plan, devices=c) for c in chunks]
    return [
        DeviceMesh({DeviceMesh.DATA_AXIS: per}, devices=c) for c in chunks
    ]


_ONE_DEVICE_SLICE = (
    "a serving mesh slice of {} devices: the port runs one device per "
    "process (ROADMAP.md item 7a), so each replica's mesh must span one "
    "device; cut the devices into as many slices as there are devices"
)


def _check_one_device(mesh: Any) -> None:
    ids = getattr(mesh, "device_ids", None)
    n = len(ids) if ids is not None else len(mesh)
    if n != 1:
        raise ValueError(_ONE_DEVICE_SLICE.format(n))


@dataclasses.dataclass
class Replica:
    """One pool slot: a named engine plus its health ledger.
    ``model_id`` is set by multi-model pools (each replica serves ONE
    model; the router filters candidates by it)."""

    name: str
    engine: ServingEngine
    health: ReplicaHealth
    device: Optional[Any] = None
    mesh: Optional[Any] = None
    model_id: Optional[str] = None


class ReplicaPool:
    """See module docstring.

    ``source`` is a :class:`ModelRegistry` (versioned, rolling hot-swap)
    or a fixed transformer stage. Placement, one of:

    - default: the constructing thread's device
      (:func:`~flinkml_tpu_torch.device.requested_device`: ``cuda``
      unless it asked for the CPU), repeated ``n_replicas`` times (one
      replica by default);
    - ``devices=[...]``: replicas round-robin over the given
      ``torch.device`` s (``n_replicas`` caps/repeats over them);
    - ``meshes=[...]``: one replica per one-device mesh slice (each
      engine gets ``config.mesh`` and time-shares via the slice lock —
      build slices with :func:`slice_meshes`).

    ``share_compiles=True`` makes :meth:`start` ensure a compile-cache
    store (:func:`flinkml_tpu_torch.compile_cache.ensure_store`: the
    configured one, else the kernels' default ``kernels/build/``), so the
    replicas, and every later process on the same store, load each kernel
    library the first replica built instead of running ``nvcc``. The fused
    executor's programs are eager PyTorch, shared in memory by every
    replica of the process.

    ``config`` is the per-replica engine template; per-replica queue
    bounds apply per engine, so pool capacity is the sum.
    ``shed_on_overload`` is forced off for replicas — a full replica
    queue fails over to a less-loaded replica (and trips DRAINING after
    enough refusals) instead of serving slowly on the router's thread.
    """

    def __init__(
        self,
        source: Union[ModelRegistry, Any],
        example: Table,
        *,
        config: Optional[ServingConfig] = None,
        n_replicas: Optional[int] = None,
        devices: Optional[Sequence[Any]] = None,
        meshes: Optional[Sequence[Any]] = None,
        output_cols: Optional[Sequence[str]] = None,
        name: str = "pool",
        health_policy: Optional[HealthPolicy] = None,
        share_compiles: bool = True,
        grayfail: Optional["GrayFailPolicy"] = None,
    ):
        if devices is not None and meshes is not None:
            raise ValueError("pass devices= or meshes=, not both")
        self._init_core(
            source, example, config=config, output_cols=output_cols,
            name=name, health_policy=health_policy,
            grayfail=grayfail, share_compiles=share_compiles,
        )
        placements: List[Dict[str, Any]]
        if meshes is not None:
            for m in meshes:
                _check_one_device(m)
            placements = [{"mesh": m} for m in meshes]
            self._device_universe = None  # scale-up needs explicit meshes
        else:
            if devices is None:
                devices = [requested_device()]
            devices = [torch.device(d) for d in devices]
            n = int(n_replicas) if n_replicas is not None else len(devices)
            if n < 1:
                raise ValueError(f"n_replicas must be >= 1, got {n}")
            placements = [
                {"device": devices[i % len(devices)]} for i in range(n)
            ]
            # The placement universe scale-ups draw from (round-robin,
            # continuing the initial assignment).
            self._device_universe = list(devices)
        for place in placements:
            self.replicas.append(self._make_replica(place, source))

    def _init_core(self, source: Any, example: Table, *,
                   config: Optional[ServingConfig], output_cols,
                   name: str, health_policy: Optional[HealthPolicy],
                   grayfail: Optional["GrayFailPolicy"] = None,
                   share_compiles: bool = True) -> None:
        """Everything a pool is besides its initial replica set — shared
        with :class:`~flinkml_tpu_torch.serving.multiplex.MultiModelPool`,
        which starts EMPTY and grows replicas per registered model."""
        self.name = name
        self._share_compiles = share_compiles
        self._source = source
        self._registry = source if isinstance(source, ModelRegistry) else None
        self._base_config = config or ServingConfig()
        self._device_universe: Optional[List[Any]] = None
        self._schema = {
            c: (np.asarray(example.column(c)).dtype,
                np.asarray(example.column(c)).shape[1:])
            for c in example.column_names
        }
        self._example = example
        self._output_cols = output_cols
        self._health_policy = health_policy or HealthPolicy()
        self.replicas: List[Replica] = []
        self._next_index = 0
        self._metrics = metrics.group(f"serving.{name}.router")
        # Freshness lag gauges: trainer watermark vs what replicas serve
        # (batch counts, no wall clock) — see freshness_lag().
        self._freshness_metrics = metrics.group(f"serving.{name}.freshness")
        from flinkml_tpu_torch.serving.grayfail import GrayFailPolicy

        # Gray-failure defense is on by default: the policy's floors
        # keep it inert at healthy CPU-mesh latencies, so only genuine
        # 10x+ stalls trigger abandonment/hedging/quarantine.
        self.grayfail_policy = grayfail or GrayFailPolicy()
        #: SLO classes currently shed by the brownout ladder (set by a
        #: running GrayFailGuard; multi-model admission consults it).
        self.brownout_shed_classes: frozenset = frozenset()
        self._router = Router(
            self.replicas, self._rows_of, self._metrics,
            on_retire=self._retire,
            grayfail=self.grayfail_policy,
            default_timeout_ms=self._base_config.default_timeout_ms,
            pool_name=name,
        )
        self._roll_lock = threading.RLock()
        self._following = False
        self._started = False

    def set_brownout(self, shed_classes: frozenset) -> None:
        """Install the brownout ladder's current shed set (called by
        :class:`~flinkml_tpu_torch.serving.grayfail.GrayFailGuard`); admission
        for these SLO classes is refused with the typed
        :class:`~flinkml_tpu_torch.serving.errors.SLOAdmissionError` until the
        ladder de-escalates."""
        self.brownout_shed_classes = frozenset(shed_classes)
        if shed_classes:
            _log.warning("pool %s: brownout shedding SLO classes %s",
                         self.name, sorted(shed_classes))

    def grayfail_guard(self, policy: Optional[Any] = None,
                       interval_s: float = 0.25):
        """Build (not start) a gray-failure guard bound to this pool —
        convenience mirroring ``PoolAutoscaler(pool, cfg)``."""
        from flinkml_tpu_torch.serving.grayfail import GrayFailGuard

        return GrayFailGuard(
            self, policy or self.grayfail_policy, interval_s=interval_s
        )

    def _make_replica(self, place: Dict[str, Any], source: Any,
                      model_id: Optional[str] = None) -> Replica:
        """Build (but do not start) one replica slot; advances the name
        counter so scale-ups continue the ``r<i>`` numbering."""
        i = self._next_index
        self._next_index += 1
        rname = f"r{i}"
        cfg = dataclasses.replace(
            self._base_config,
            device=place.get("device"),
            mesh=place.get("mesh"),
            metrics_name=self.name,
            metrics_labels={"replica": rname},
            dispatch_tag=f"serving.pool/{self.name}/{rname}",
            # Replicas never shed to the caller's host path: shedding
            # would serve the request slowly on the ROUTER thread and
            # hide the queue-full signal the per-replica degradation
            # (failover -> DRAINING -> pool overload) is built on.
            # The pool's shed path IS failover to a less-loaded
            # replica.
            shed_on_overload=False,
        )
        engine = ServingEngine(
            source, self._example, cfg, output_cols=self._output_cols,
            name=f"{self.name}/{rname}",
        )
        return Replica(
            name=rname, engine=engine,
            health=ReplicaHealth(rname, self._health_policy),
            device=place.get("device"), mesh=place.get("mesh"),
            model_id=model_id,
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ReplicaPool":
        """Start every replica (load + per-bucket warmup, serially — the
        first replica builds each (program, bucket, policy) once and every
        later replica of the process reuses it; see ``share_compiles``).
        Returns self."""
        if self._share_compiles:
            from flinkml_tpu_torch import compile_cache

            compile_cache.ensure_store()
        for replica in list(self.replicas):  # scaling mutates the list
            replica.engine.start()
        self._started = True
        self._metrics.gauge("replicas", float(len(self.replicas)))
        self._update_health_gauge()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        if self._following and self._registry is not None:
            self._registry.remove_listener(self._on_registry_change)
            self._following = False
        # Snapshot: a still-running autoscaler removing a replica
        # mid-iteration would shift the list and skip one — leaving its
        # dispatcher running after stop() returned.
        for replica in list(self.replicas):
            replica.engine.stop(drain=drain, timeout=timeout)
        self._started = False

    # -- the request path --------------------------------------------------
    def predict(self, features: Union[Table, Mapping[str, Any]],
                timeout_ms: Optional[float] = None):
        """Route one request (same contract as
        :meth:`ServingEngine.predict`, plus failover — see
        :class:`~flinkml_tpu_torch.serving.router.Router`)."""
        return self._router.predict(features, timeout_ms=timeout_ms)

    def _rows_of(self, features: Union[Table, Mapping[str, Any]]) -> int:
        try:
            col, (_, trailing) = next(iter(self._schema.items()))
            a = (features.column(col) if isinstance(features, Table)
                 else features[col])
            a = np.asarray(a)
            return a.shape[0] if a.ndim > len(trailing) else 1
        except Exception:  # noqa: BLE001 — schema errors surface in the engine
            return 1

    # -- degradation -------------------------------------------------------
    def _retire(self, replica: Replica, error: BaseException) -> None:
        """Take a failed replica out of service: stop WITHOUT drain so
        its queued requests fail fast into the router's retry path. Runs
        the stop off-thread — the retiring router thread must not block
        on the dead replica's dispatcher."""
        self._metrics.counter("replicas_retired")
        self._update_health_gauge()
        _log.warning(
            "retiring replica %s/%s after %r; traffic respread over %d "
            "healthy replicas", self.name, replica.name, error,
            len(self.healthy_replicas()),
        )

        def _stop():
            try:
                replica.engine.stop(drain=False, timeout=5.0)
            except Exception:  # noqa: BLE001 — already failed; log only
                _log.exception("stopping retired replica %s", replica.name)

        threading.Thread(
            target=_stop, name=f"retire-{self.name}/{replica.name}",
            daemon=True,
        ).start()

    def revive(self, replica_name: str) -> None:
        """Operator path: restart a retired replica and rejoin rotation
        (re-synced to the registry's current version when following).
        Health stats reset on revive — a revived replica must not be
        ranked by its pre-failure latency/backlog history — and the
        EWMA re-seeds from healthy siblings like a fresh scale-up."""
        replica = self._replica(replica_name)
        replica.engine.start()
        replica.health.revive()
        self._seed_ewma(replica)
        self._update_health_gauge()
        if self._following:
            self._roll_to_current()

    # -- elastic membership (the autoscaler's surface) ---------------------
    def _seed_ewma(self, replica: Replica) -> None:
        """Seed a fresh/revived replica's latency EWMA from the median
        of its healthy siblings, so the router's deadline-aware ordering
        treats it as a known quantity and sends it load immediately
        instead of letting the estimate settle late."""
        values = [
            r.health.ewma_ms_per_row
            for r in self.replicas
            if r is not replica
            and r.health.state is ReplicaState.HEALTHY
            and r.health.ewma_ms_per_row is not None
        ]
        if values:
            replica.health.seed_ewma(float(np.median(values)))

    def add_replica(self, device: Optional[Any] = None,
                    mesh: Optional[Any] = None,
                    source: Optional[Any] = None,
                    model_id: Optional[str] = None) -> Replica:
        """Grow the pool by one replica (the autoscaler's scale-up).

        Placement: an explicit ``device`` or ``mesh``, else the next
        device of the pool's placement universe (round-robin,
        continuing the constructor's assignment; mesh-placed pools must
        pass a mesh). On a started pool the new replica starts — and
        warms — BEFORE joining the routing table, and its warmup reuses
        the programs its siblings already built in this process. Its
        latency EWMA seeds from the healthy siblings' median so it
        takes load immediately."""
        if device is None and mesh is None:
            if self._device_universe is None:
                raise ValueError(
                    "mesh-placed pool: pass add_replica(mesh=...) (build "
                    "slices with slice_meshes)"
                )
            device = self._device_universe[
                self._next_index % len(self._device_universe)
            ]
        if mesh is not None:
            _check_one_device(mesh)
        place = {"device": device, "mesh": mesh}
        replica = self._make_replica(
            place, source if source is not None else self._source,
            model_id=model_id,
        )
        if self._started:
            replica.engine.start()
        self._seed_ewma(replica)
        # Join rotation only once warmed: the router iterates the live
        # list, so the append IS the go-live.
        self.replicas.append(replica)
        self._metrics.counter("replicas_added")
        self._metrics.gauge("replicas", float(len(self.replicas)))
        self._update_health_gauge()
        _log.info("pool %s scaled UP: replica %s on %s (now %d)",
                  self.name, replica.name,
                  device if device is not None else mesh,
                  len(self.replicas))
        return replica

    def remove_replica(self, replica_name: Optional[str] = None,
                       drain: bool = True,
                       timeout: Optional[float] = None) -> str:
        """Shrink the pool by one replica (the autoscaler's scale-down):
        take it out of rotation FIRST (new requests stop routing to it),
        then stop it — with ``drain`` (default) its queued requests
        finish before the engine dies, so scale-down loses nothing.
        Default victim: the healthy replica with the least outstanding
        work (never the last healthy one)."""
        if replica_name is not None:
            replica = self._replica(replica_name)
        else:
            replica = self._scale_down_victim()
        self.replicas.remove(replica)  # out of rotation before the stop
        replica.engine.stop(drain=drain, timeout=timeout)
        self._metrics.counter("replicas_removed")
        self._finish_remove(replica)
        return replica.name

    def prune_retired(self) -> List[str]:
        """Drop UNHEALTHY (retired, already-stopped) replicas from the
        pool. The autoscaler calls this after REPLACING a retirement:
        keeping the dead slot around would leak one stopped engine per
        failure under a flapping fault (and inflate capacity-based
        accounting); an operator who wants the dead engine back instead
        uses :meth:`revive` BEFORE the replacement lands. Returns the
        pruned names."""
        retired = [
            r for r in self.replicas
            if r.health.state is ReplicaState.UNHEALTHY
        ]
        for replica in retired:
            self.replicas.remove(replica)
            # Retirement already stopped the engine (without drain);
            # belt-and-braces for an engine retired mid-stop.
            try:
                replica.engine.stop(drain=False, timeout=1.0)
            except Exception:  # noqa: BLE001 — already dead; log only
                _log.exception("stopping pruned replica %s", replica.name)
        if retired:
            self._metrics.counter("replicas_pruned", float(len(retired)))
            self._metrics.gauge("replicas", float(len(self.replicas)))
            self._update_health_gauge()
            _log.info("pool %s pruned retired replicas: %s", self.name,
                      [r.name for r in retired])
        return [r.name for r in retired]

    def _scale_down_victim(self) -> Replica:
        """Default victim choice: the healthy replica with the least
        outstanding work, never the last healthy one (multi-model pools
        additionally keep every model's last replica)."""
        healthy = [
            r for r in self.replicas
            if r.health.state is ReplicaState.HEALTHY
        ]
        if len(healthy) <= 1:
            raise ValueError(
                f"pool {self.name}: refusing to remove the last "
                "healthy replica"
            )
        return min(healthy, key=lambda r: r.health.outstanding_rows)

    def _finish_remove(self, replica: Replica) -> None:
        self._metrics.gauge("replicas", float(len(self.replicas)))
        self._update_health_gauge()
        _log.info("pool %s scaled DOWN: replica %s removed (now %d)",
                  self.name, replica.name, len(self.replicas))

    def healthy_replicas(self) -> List[Replica]:
        return [
            r for r in list(self.replicas)
            if r.health.state is not ReplicaState.UNHEALTHY
        ]

    def _replica(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica {name!r} in pool {self.name}")

    def _update_health_gauge(self) -> None:
        healthy = sum(
            1 for r in list(self.replicas)
            if r.health.state is ReplicaState.HEALTHY
        )
        self._metrics.gauge("healthy_replicas", float(healthy))

    # -- rolling hot-swap --------------------------------------------------
    def follow_registry(self) -> "ReplicaPool":
        """Roll every registry publish/rollback across the pool, one
        replica at a time (see module docstring)."""
        if self._registry is None:
            raise RegistryError(
                "follow_registry requires a ModelRegistry-backed pool"
            )
        if not self._following:
            self._registry.add_listener(self._on_registry_change)
            self._following = True
        self._roll_to_current()  # catch up on anything already published
        return self

    def _on_registry_change(self, version: int) -> None:
        self._roll_to_current()

    def _roll_to_current(self) -> None:
        with self._roll_lock:
            for replica in list(self.replicas):  # scaling mutates the list
                if replica.health.state is ReplicaState.UNHEALTHY:
                    continue  # revive() re-syncs it
                # Re-read CURRENT per step: a rollback racing this roll
                # flips the remaining replicas to the rolled-back version
                # mid-roll, and the rollback's own (serialized) delivery
                # converges the early ones — last pointer wins everywhere.
                current = self._registry.current_version()
                if current is None:
                    return
                if replica.engine.active_version != current:
                    replica.engine.swap_to(current)
                    self._metrics.counter("rolled_swaps")
            self.freshness_lag()

    # -- observability -----------------------------------------------------
    def freshness_lag(
        self, trainer_watermark: Optional[int] = None,
    ) -> Optional[int]:
        """How stale the pool is, in source batches: the trainer-side
        edge minus the OLDEST watermark any healthy replica currently
        serves (the worst answer a client can get). The edge is the live
        ``trainer_watermark`` when given (batches the trainer has
        consumed, published or not), else the registry's newest stamped
        watermark. Publishes the ``serving.<pool>.freshness`` gauges
        (``lag_batches`` / ``latest_watermark`` / ``served_watermark_min``)
        and returns the lag — None when the pool is not registry-backed
        or no stamped watermarks exist yet. Deterministic by
        construction: watermarks are batch counts, never wall clocks."""
        if self._registry is None:
            return None
        latest = (int(trainer_watermark) if trainer_watermark is not None
                  else self._registry.latest_watermark())
        if latest is None:
            return None
        served = []
        for r in self.healthy_replicas():
            v = r.engine.active_version
            if v is None:
                continue
            mark = self._registry.watermark_of(v)
            if mark is not None:
                served.append(mark)
        if not served:
            return None
        lag = int(latest) - int(min(served))
        self._freshness_metrics.gauge("latest_watermark", int(latest))
        self._freshness_metrics.gauge("served_watermark_min",
                                      int(min(served)))
        self._freshness_metrics.gauge("lag_batches", lag)
        return lag
    def versions(self) -> Dict[str, Optional[int]]:
        return {r.name: r.engine.active_version for r in list(self.replicas)}

    def stats(self) -> Dict[str, Any]:
        per_replica = {}
        for r in list(self.replicas):
            snap = r.engine._metrics.snapshot()
            per_replica[r.name] = {
                **r.health.snapshot(),
                "engine_running": r.engine.running,
                "active_version": r.engine.active_version,
                "queue_depth": r.engine._batcher.queue_depth,
                "queued_rows": r.engine._batcher.queued_rows,
                "counters": snap["counters"],
                "gauges": snap["gauges"],
            }
        return {
            "name": self.name,
            "replicas": len(self.replicas),
            "healthy": len([
                r for r in list(self.replicas)
                if r.health.state is ReplicaState.HEALTHY
            ]),
            "router": self._metrics.snapshot()["counters"],
            "freshness_lag": self.freshness_lag(),
            "brownout_shed": sorted(self.brownout_shed_classes),
            "per_replica": per_replica,
        }
