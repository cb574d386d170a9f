"""Metric-driven replica autoscaling — the closed control loop over a
:class:`~flinkml_tpu_torch.serving.pool.ReplicaPool`.

The pool already exports everything an autoscaler needs: per-replica
queued rows and queue capacity (backlog occupancy), the engines' p50/p99
latency gauges, and the health ledgers' outstanding-row balance. This
module closes the loop: a :class:`PoolAutoscaler` samples those signals
every ``interval_s``, smooths backlog into an EWMA (a single saturated
poll must not trigger a replica), and grows/shrinks the pool through
:meth:`ReplicaPool.add_replica` / :meth:`ReplicaPool.remove_replica`.

Design rules, each inherited from an existing subsystem:

- **Hysteresis.** A scale event needs a *decisive*
  signal: scale-up fires only when the backlog EWMA exceeds the
  threshold by a 1.10x margin (``decisive_margin``), sustained for
  ``up_consecutive`` evaluations; scale-down needs the mirror-image
  decisively-idle signal for ``down_consecutive`` evaluations plus a
  cooldown. Noise can never flap the replica count.
- **Scale-up builds nothing new.** Every replica of a process shares
  the one build of each kernel and the fused executor's programs, so a
  new replica's warmup reuses what its siblings built, and the
  pool seeds the newcomer's latency EWMA from its healthy siblings'
  median so the router sends it load immediately.
- **Leases make colocation negotiable.** A training job that holds
  :func:`~flinkml_tpu_torch.parallel.dispatch.lease_devices` on part of the
  device plane is left alone until serving load demands the slice back:
  with ``reclaim_leases`` the scaler performs the reclaim handshake
  (``request_revoke`` → the trainer releases at its next epoch boundary
  → the freed devices become placements). Skipping the handshake is
  statically detectable — a pool dispatch on a still-leased slice is the
  FML304 shape (:mod:`flinkml_tpu_torch.analysis.collectives`).
- **Replacement outranks hysteresis.** When retirements push the healthy
  count under ``min_replicas`` (the chaos shape: a replica dies
  mid-spike), the scaler replaces it on the next evaluation regardless
  of streaks — the chaos contract extends to the scaling loop.

Metrics (``serving.<pool>.autoscaler``): ``scale_events_total``,
``scale_up_total`` / ``scale_down_total`` / ``replacements_total`` /
``lease_reclaims_total`` counters; ``replicas``, ``backlog_fraction``
(the EWMA), ``observed_p99_ms`` gauges.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional

from flinkml_tpu_torch.parallel.dispatch import _device_id
from flinkml_tpu_torch.serving.health import ReplicaState
from flinkml_tpu_torch.serving.pool import ReplicaPool
from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import metrics

_log = get_logger("serving.autoscaler")


#: The static fallback of the scale-up backlog threshold: an
#: ``AutoscaleConfig.scale_up_backlog`` of None takes the tuning table's
#: ``serving_scale_up_backlog`` for the pool's device, else this.
SCALE_UP_BACKLOG = 0.5


def _tuned_backlog_threshold(fallback: float) -> float:
    """The mesh-keyed ``serving_scale_up_backlog`` autotune knob,
    degraded to the static default on a bad table value (the serving
    knob contract)."""
    from flinkml_tpu_torch.autotune import tuned_default

    try:
        value = float(tuned_default("serving_scale_up_backlog", fallback))
    except (TypeError, ValueError):
        return fallback
    return value if 0.0 < value < 1.0 else fallback


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Control-loop knobs (see module docstring for the policies).

    ``scale_up_backlog=None`` reads the measured threshold for the pool's
    device from the autotune table (knob ``serving_scale_up_backlog``;
    static fallback :data:`SCALE_UP_BACKLOG`, 0.5; a value outside (0, 1)
    degrades to it). Thresholds are fractions of aggregate queue capacity
    (queued rows / sum of ``max_queue_rows``)."""

    min_replicas: int = 1
    max_replicas: int = 8
    scale_up_backlog: Optional[float] = None
    scale_down_backlog: float = 0.05
    #: Optional latency SLO: scale up when the worst replica p99 exceeds
    #: this (decisively), even with queue room left.
    p99_target_ms: Optional[float] = None
    #: The 1.10x decisive-win margin: signals must beat their
    #: threshold by this factor before an event fires.
    decisive_margin: float = 1.10
    up_consecutive: int = 2
    down_consecutive: int = 8
    cooldown_s: float = 1.0
    interval_s: float = 0.25
    #: EWMA smoothing for the backlog signal (weight of the NEW sample).
    backlog_alpha: float = 0.5
    #: Allow reclaiming training slice leases for scale-up placements
    #: when every unleased device is already carrying a replica.
    reclaim_leases: bool = False
    lease_reclaim_timeout_s: float = 10.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.decisive_margin < 1.0:
            raise ValueError(
                "decisive_margin must be >= 1.0 (it is a hysteresis "
                "band, not a discount)"
            )


def _pool_tuned_backlog(pool: ReplicaPool) -> float:
    """The tuned threshold for the device of the pool's first replica."""
    from flinkml_tpu_torch.serving.engine import _tuning_scope

    device = next((getattr(r.engine, "device", None)
                   for r in pool.replicas), None)
    if device is None:
        return _tuned_backlog_threshold(SCALE_UP_BACKLOG)
    with _tuning_scope(device):
        return _tuned_backlog_threshold(SCALE_UP_BACKLOG)


class PoolAutoscaler:
    """See module docstring. Drive it with :meth:`start` (background
    control thread) or call :meth:`step` yourself (deterministic tests,
    external schedulers)."""

    def __init__(self, pool: ReplicaPool,
                 config: Optional[AutoscaleConfig] = None):
        self.pool = pool
        self.config = config or AutoscaleConfig()
        self._up_threshold = (
            self.config.scale_up_backlog
            if self.config.scale_up_backlog is not None
            else _pool_tuned_backlog(pool)
        )
        self._metrics = metrics.group(f"serving.{pool.name}.autoscaler")
        self._backlog_ewma: Optional[float] = None
        self._up_streak = 0
        self._down_streak = 0
        self._last_event = float("-inf")
        self._lock = threading.Lock()  # one step at a time
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- signals -----------------------------------------------------------
    def signals(self) -> Dict[str, Any]:
        """One sample of the pool's scaling signals: instantaneous and
        EWMA backlog fraction, worst healthy-replica p99, counts."""
        replicas = list(self.pool.replicas)
        healthy = [
            r for r in replicas if r.health.state is ReplicaState.HEALTHY
        ]
        queued = 0
        capacity = 0
        worst_p99 = None
        for r in healthy:
            # outstanding_rows (router-submitted, unsettled) is a
            # superset of the batcher's queued rows — counting both
            # would double the signal.
            queued += max(r.health.outstanding_rows, r.engine.queued_rows)
            capacity += r.engine.config.max_queue_rows
            p99 = r.engine.observed_p99_ms
            if p99 is not None:
                worst_p99 = p99 if worst_p99 is None else max(worst_p99, p99)
        backlog = (queued / capacity) if capacity else 0.0
        return {
            "replicas": len(replicas),
            "healthy": len(healthy),
            "backlog_fraction": backlog,
            "worst_p99_ms": worst_p99,
        }

    # -- the control step --------------------------------------------------
    def step(self, now: Optional[float] = None) -> Optional[str]:
        """One control evaluation; returns ``"up"``, ``"down"``,
        ``"replace"``, or None. Thread-safe (the background loop and a
        manual driver may coexist, evaluations serialize)."""
        with self._lock:
            return self._step_locked(
                time.monotonic() if now is None else now
            )

    def _step_locked(self, now: float) -> Optional[str]:
        cfg = self.config
        sig = self.signals()
        alpha = cfg.backlog_alpha
        self._backlog_ewma = (
            sig["backlog_fraction"] if self._backlog_ewma is None
            else (1 - alpha) * self._backlog_ewma
            + alpha * sig["backlog_fraction"]
        )
        self._metrics.gauge("replicas", float(sig["replicas"]))
        self._metrics.gauge("backlog_fraction", self._backlog_ewma)
        if sig["worst_p99_ms"] is not None:
            self._metrics.gauge("observed_p99_ms", sig["worst_p99_ms"])

        # Garbage-collect retirements the pool no longer needs: once the
        # healthy count covers min_replicas, a dead slot is just a
        # leaked stopped engine (a flapping fault would accumulate one
        # per failure). A scaler-managed pool supersedes the manual
        # revive() path — operators who want a dead engine back revive
        # it before the next evaluation.
        if (sig["healthy"] >= cfg.min_replicas
                and sig["replicas"] > sig["healthy"]):
            self.pool.prune_retired()

        # Replacement: a retirement under min_replicas is repaired
        # regardless of streaks (the chaos contract), rate-limited only
        # by the cooldown so a flapping failure cannot fork-bomb.
        if (sig["healthy"] < cfg.min_replicas
                and now - self._last_event >= cfg.cooldown_s):
            if self._grow("replace retired replica"):
                # The replacement supersedes the dead slot.
                self.pool.prune_retired()
                self._metrics.counter("replacements_total")
                self._last_event = now
                return "replace"

        margin = cfg.decisive_margin
        over_backlog = self._backlog_ewma >= self._up_threshold * margin
        over_p99 = (
            cfg.p99_target_ms is not None
            and sig["worst_p99_ms"] is not None
            and sig["worst_p99_ms"] >= cfg.p99_target_ms * margin
        )
        idle_backlog = self._backlog_ewma <= cfg.scale_down_backlog / margin
        p99_fine = (
            cfg.p99_target_ms is None
            or sig["worst_p99_ms"] is None
            or sig["worst_p99_ms"] < cfg.p99_target_ms
        )

        if over_backlog or over_p99:
            self._up_streak += 1
            self._down_streak = 0
        elif idle_backlog and p99_fine:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = 0
            self._down_streak = 0

        if now - self._last_event < cfg.cooldown_s:
            return None
        if (self._up_streak >= cfg.up_consecutive
                and sig["healthy"] < cfg.max_replicas):
            reason = (
                f"backlog EWMA {self._backlog_ewma:.2f} >= "
                f"{self._up_threshold:.2f} x {margin}"
                if over_backlog else
                f"p99 {sig['worst_p99_ms']:.1f}ms >= "
                f"{cfg.p99_target_ms}ms x {margin}"
            )
            if self._grow(reason):
                self._metrics.counter("scale_up_total")
                self._metrics.counter("scale_events_total")
                self._last_event = now
                self._up_streak = 0
                return "up"
            return None
        if (self._down_streak >= cfg.down_consecutive
                and sig["healthy"] > cfg.min_replicas
                and len(self.pool.replicas) > cfg.min_replicas):
            try:
                name = self.pool.remove_replica()
            except ValueError:
                return None
            _log.info("autoscaler %s: scale DOWN (%s) — backlog EWMA "
                      "%.3f", self.pool.name, name, self._backlog_ewma)
            self._metrics.counter("scale_down_total")
            self._metrics.counter("scale_events_total")
            self._last_event = now
            self._down_streak = 0
            return "down"
        return None

    # -- placements --------------------------------------------------------
    def _grow(self, reason: str) -> bool:
        """Scale up by one replica, honoring training slice leases: an
        unleased device with the fewest replicas wins; when every
        candidate is leased, either reclaim (``reclaim_leases``: the
        revoke → release handshake) or refuse loudly — NEVER place on a
        still-leased slice (the FML304 shape)."""
        kwargs = self._scale_target()
        universe = self.pool._device_universe
        if universe is None:
            # Mesh-placed pool: no placement universe to draw from.
            _log.warning(
                "autoscaler %s: cannot scale a mesh-placed pool without "
                "an explicit mesh; skipping (%s)", self.pool.name, reason,
            )
            return False
        from flinkml_tpu_torch.parallel import dispatch as _dispatch

        leased = _dispatch.leased_device_ids()
        free = [d for d in universe if _device_id(d) not in leased]
        if not free and leased:
            if not self.config.reclaim_leases:
                _log.warning(
                    "autoscaler %s: every candidate device is leased to "
                    "training and reclaim_leases is off; skipping "
                    "scale-up (%s)", self.pool.name, reason,
                )
                return False
            if not self._reclaim_lease(reason):
                return False
            leased = _dispatch.leased_device_ids()
            free = [d for d in universe if _device_id(d) not in leased]
            if not free:
                return False
        if not free:
            # Empty universe, or every device leased and reclaim failed:
            # never place on a leased slice (the FML304 shape) and never
            # crash the control loop on min() of nothing.
            _log.warning(
                "autoscaler %s: no unleased placement available; "
                "skipping scale-up (%s)", self.pool.name, reason,
            )
            return False
        per_device: Dict[int, int] = {}
        for r in self.pool.replicas:
            if r.device is not None:
                key = _device_id(r.device)
                per_device[key] = per_device.get(key, 0) + 1
        device = min(free, key=lambda d: per_device.get(_device_id(d), 0))
        _log.info("autoscaler %s: scale UP onto device %s — %s",
                  self.pool.name, device, reason)
        self.pool.add_replica(device=device, **kwargs)
        return True

    def _scale_target(self) -> Dict[str, Any]:
        """Extra ``add_replica`` kwargs for the neediest target — the
        multi-model pool overrides this decision via ``scale_target()``
        (SLO-weighted); plain pools need nothing."""
        target = getattr(self.pool, "scale_target", None)
        return target() if callable(target) else {}

    def _reclaim_lease(self, reason: str) -> bool:
        """The reclaim handshake: pick the active lease overlapping the
        pool's universe, request revocation, and wait (bounded) for the
        holder to release at its safe boundary."""
        from flinkml_tpu_torch.parallel import dispatch as _dispatch

        universe_ids = {_device_id(d) for d in self.pool._device_universe}
        candidates = [
            l for l in _dispatch.active_leases()
            if l.devices & universe_ids
        ]
        if not candidates:
            return False
        # Most-overlapping lease frees the most placement room.
        lease = max(candidates, key=lambda l: len(l.devices & universe_ids))
        _log.warning(
            "autoscaler %s: reclaiming training lease %s (%s)",
            self.pool.name, lease.token, reason,
        )
        lease.request_revoke(f"autoscaler {self.pool.name}: {reason}")
        if not lease.wait_released(self.config.lease_reclaim_timeout_s):
            _log.warning(
                "autoscaler %s: lease %s not released within %.1fs; "
                "will not place on a leased slice",
                self.pool.name, lease.token,
                self.config.lease_reclaim_timeout_s,
            )
            return False
        self._metrics.counter("lease_reclaims_total")
        return True

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "PoolAutoscaler":
        """Start the background control loop (daemon thread, one
        :meth:`step` per ``interval_s``). Returns self."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"autoscaler-{self.pool.name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the loop must survive
                _log.exception("autoscaler %s: step failed", self.pool.name)

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            self._thread = None

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        snap = self._metrics.snapshot()
        return {
            "pool": self.pool.name,
            "replicas": len(self.pool.replicas),
            "backlog_ewma": self._backlog_ewma,
            "up_threshold": self._up_threshold,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
        }
