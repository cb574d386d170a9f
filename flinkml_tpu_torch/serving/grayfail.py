"""Gray-failure defense: quarantine latency outliers, brown out by class.

Every failure the pool could survive before this module was *binary* —
a replica died, erred, or tripped its queue bound. The failure mode
that dominates production serving is the **gray failure**: a replica
that is alive, passing dispatches, and 50–500x slower than its siblings
(a GC-style pause, a contended device, a stuck transfer). One such
replica silently drags pool p99 to its own latency, because nothing
between "healthy" and "dead" exists to catch it.

This module adds that layer, in two halves:

**Router-side containment** (consumed by
:class:`~flinkml_tpu_torch.serving.router.Router`, configured here): the
:class:`GrayFailPolicy` gives every dispatch a per-attempt budget
(healthy-sibling attempt-p99 median × ``deadline_multiplier``) after
which the router ABANDONS the attempt and fails over — and a hedge
threshold after which an idempotent pure-transform request is
speculatively re-dispatched to the next-best replica, first completion
wins, loser cancelled at the queue.

**Pool-side detection** (:class:`GrayFailGuard`): a step-driven watcher
(same shape as the
:class:`~flinkml_tpu_torch.serving.autoscaler.PoolAutoscaler`: ``step()`` for
deterministic tests, ``start()`` for the background thread) that runs a
ROBUST outlier test over the per-replica attempt-latency rings
(:meth:`~flinkml_tpu_torch.serving.health.ReplicaHealth.attempt_p99`):

- a replica whose attempt p99 sits more than ``slow_mad_k`` MADs above
  the healthy-sibling median (MAD = median absolute deviation — robust
  to the outlier itself, unlike a mean/stddev test) for ``slow_trip``
  consecutive evaluations is QUARANTINED: ``HEALTHY -> SLOW``, out of
  routing, *not* killed. The trip/clear thresholds carry the
  autoscaler's decisive-win hysteresis (trip needs the score decisively
  over ``slow_mad_k × decisive_margin``; clear needs it decisively
  under ``slow_mad_k / decisive_margin``) so a replica oscillating at
  the threshold neither flaps in nor flaps out.
- a SLOW replica receives low-rate CANARY dispatches (one tiny request
  every ``canary_interval_s``, bounded by ``canary_timeout_ms``); its
  ring was cleared at quarantine, so the rejoin decision reads only
  post-quarantine evidence. ``slow_clear`` consecutive clean
  evaluations rejoin it (``SLOW -> HEALTHY``) with its EWMA re-seeded
  from the healthy siblings — recovery without operator intervention.
- a quarantine that NEVER recovers escalates: after
  ``quarantine_retire_s`` in SLOW the guard retires the replica
  (``force_unhealthy`` + the pool's retire path), at which point the
  autoscaler's replacement branch takes over. Composition with the
  autoscaler needs no code here: SLOW is not HEALTHY, so a quarantined
  replica already counts against ``min_replicas`` in
  ``PoolAutoscaler.signals()`` and triggers replacement.

**Brownout ladder**: a MAD test cannot see *pool-wide* degradation
(every replica slow — host contention, a shared-device stall): the
median moves with the failure. The guard therefore also tracks the
healthy-median attempt p99 against a slow EWMA baseline of itself;
sustained degradation past ``brownout_multiplier ×`` baseline escalates
a shed LADDER one rung per trip: SLO classes are refused admission in
``shed_order`` (batch first), via the existing typed
:class:`~flinkml_tpu_torch.serving.errors.SLOAdmissionError`, so the
interactive tier keeps its latency while the batch tier backs off —
instead of every class timing out equally. Recovery de-escalates one
rung at a time.

Metrics (``serving.<pool>.grayfail``): ``quarantines_total``,
``rejoins_total``, ``slow_retired_total``, ``canary_probes`` /
``canary_errors``, ``brownout_escalations`` / ``brownout_deescalations``
counters; ``brownout_level`` gauge. Per-replica ``slow_score`` gauges
publish into the pool's labeled engine group (``serving.<pool>``,
``replica=<name>``). The router adds ``serving.<pool>.hedges``
(labeled ``outcome=dispatched|won|lost``) and its own
``abandoned_attempts`` counter.
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.serving.health import ReplicaState
from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import metrics

_log = get_logger("serving.grayfail")

#: The static fallback of the per-attempt deadline multiplier: a
#: ``GrayFailPolicy.deadline_multiplier`` of None takes the tuning table's
#: ``serving_deadline_multiplier`` for this thread's device, else this.
DEADLINE_MULTIPLIER = 4.0


class ReplicaQuarantinedError(RuntimeError):
    """Administrative error recorded when the guard retires a replica
    whose quarantine never recovered (``quarantine_retire_s``)."""


@dataclasses.dataclass(frozen=True)
class GrayFailPolicy:
    """Knobs for the whole gray-failure stack (module docstring).

    The floors (``attempt_floor_ms``, ``hedge_floor_ms``,
    ``slow_abs_floor_ms``, ``brownout_abs_floor_ms``) keep the defenses
    quiet on fast pools: a CPU-mesh pool serving in single-digit
    milliseconds must not abandon, hedge, or quarantine over
    scheduler-timeslice noise that a multiplier alone would amplify.
    Production-true latencies clear the floors by construction; tests
    lower them explicitly."""

    # -- per-dispatch deadlines (router-side abandonment)
    abandon: bool = True
    #: Budget = healthy-sibling attempt-p99 median × this. None reads
    #: the autotune table knob ``serving_deadline_multiplier`` (fallback
    #: :data:`DEADLINE_MULTIPLIER`, 4.0) — the tuned_default contract: a
    #: bad table value degrades to the static default.
    deadline_multiplier: Optional[float] = None
    attempt_floor_ms: float = 250.0
    #: Sibling rings need this many attempts before their p99 is
    #: trusted for budgets/hedging — no abandonment on cold pools.
    min_attempt_samples: int = 20
    # -- hedged requests (router-side)
    hedge: bool = True
    hedge_multiplier: float = 1.5
    hedge_floor_ms: float = 100.0
    # -- latency-outlier quarantine (guard-side)
    slow_mad_k: float = 6.0
    slow_abs_floor_ms: float = 20.0
    slow_trip: int = 3
    slow_clear: int = 3
    #: The autoscaler's decisive-win margin, applied to the MAD score:
    #: trip only when score > k × margin, clear only when score < k / margin.
    decisive_margin: float = 1.10
    min_slow_samples: int = 20
    canary_interval_s: float = 0.5
    canary_timeout_ms: float = 1000.0
    canary_min_samples: int = 3
    #: SLOW longer than this -> retire (autoscaler replaces). None: never.
    quarantine_retire_s: Optional[float] = 120.0
    #: Refuse a quarantine that would leave fewer HEALTHY replicas.
    min_healthy_after_quarantine: int = 1
    # -- brownout ladder (guard-side)
    brownout: bool = True
    #: SLO classes shed under pool-wide degradation, in order: one rung
    #: of the ladder per sustained trip, batch first by default.
    shed_order: Tuple[str, ...] = ("batch",)
    brownout_multiplier: float = 3.0
    brownout_abs_floor_ms: float = 50.0
    brownout_trip: int = 4
    brownout_clear: int = 4
    baseline_alpha: float = 0.1

    def resolved_deadline_multiplier(self) -> float:
        if self.deadline_multiplier is not None:
            return float(self.deadline_multiplier)
        from flinkml_tpu_torch.serving.engine import _tuned_float

        return _tuned_float("serving_deadline_multiplier", DEADLINE_MULTIPLIER)


class GrayFailGuard:
    """Pool-side gray-failure watcher — see the module docstring.

    ``step()`` is the whole brain (deterministic tests drive it
    directly); ``start()`` runs it on a daemon thread every
    ``interval_s``, exactly the autoscaler's shape."""

    def __init__(self, pool: Any, policy: Optional[GrayFailPolicy] = None,
                 interval_s: float = 0.25):
        self.pool = pool
        self.policy = policy or getattr(pool, "grayfail_policy", None) \
            or GrayFailPolicy()
        self.interval_s = float(interval_s)
        self._metrics = metrics.group(f"serving.{pool.name}.grayfail")
        self._slow_streak: Dict[str, int] = {}
        self._clear_streak: Dict[str, int] = {}
        self._last_canary: Dict[str, float] = {}
        self._brownout_level = 0
        self._brownout_streak = 0
        self._brownout_clear_streak = 0
        self._baseline_p99: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._canary_columns: Optional[Dict[str, np.ndarray]] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GrayFailGuard":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — guard must outlive one bad step
                    _log.exception("gray-failure guard step failed")

        self._thread = threading.Thread(
            target=_loop, name=f"grayfail-{self.pool.name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def brownout_level(self) -> int:
        return self._brownout_level

    # -- the evaluation step ----------------------------------------------
    def step(self, now: Optional[float] = None) -> List[str]:
        """One evaluation pass. Returns the actions taken (for logs and
        deterministic tests): ``quarantine:<r>``, ``rejoin:<r>``,
        ``retire:<r>``, ``brownout:<level>``."""
        now = time.monotonic() if now is None else now
        pol = self.policy
        actions: List[str] = []
        replicas = list(self.pool.replicas)
        healthy = [
            r for r in replicas if r.health.state is ReplicaState.HEALTHY
        ]
        p99s = {
            r.name: r.health.attempt_p99(min_samples=pol.min_slow_samples)
            for r in healthy
        }
        known = [v for v in p99s.values() if v is not None]
        med = statistics.median(known) if known else None
        mad = None
        if med is not None and len(known) >= 2:
            mad = statistics.median([abs(v - med) for v in known])
            # MAD floor: quantized/identical latencies give MAD 0, which
            # would make any epsilon an infinite score.
            mad = max(mad, 0.05 * med, 0.1)
        self._prune_gone({r.name for r in replicas})
        if mad is not None:
            actions += self._check_outliers(healthy, p99s, med, mad)
        actions += self._run_quarantine(replicas, p99s, med, mad, now)
        if pol.brownout:
            actions += self._check_brownout(med)
        return actions

    def _prune_gone(self, live: set) -> None:
        for d in (self._slow_streak, self._clear_streak, self._last_canary):
            for name in list(d):
                if name not in live:
                    del d[name]

    # -- quarantine entry --------------------------------------------------
    def _score(self, p99: float, med: float, mad: float) -> float:
        return (p99 - med) / mad

    def _check_outliers(self, healthy, p99s, med, mad) -> List[str]:
        pol = self.policy
        actions: List[str] = []
        for r in healthy:
            p99 = p99s.get(r.name)
            if p99 is None:
                continue
            score = self._score(p99, med, mad)
            metrics.group(
                f"serving.{self.pool.name}", labels={"replica": r.name}
            ).gauge("slow_score", round(score, 3))
            tripping = (
                score > pol.slow_mad_k * pol.decisive_margin
                and (p99 - med) > pol.slow_abs_floor_ms
            )
            if not tripping:
                self._slow_streak[r.name] = 0
                continue
            self._slow_streak[r.name] = self._slow_streak.get(r.name, 0) + 1
            if self._slow_streak[r.name] < pol.slow_trip:
                continue
            remaining = sum(
                1 for h in healthy
                if h is not r and h.health.state is ReplicaState.HEALTHY
            )
            if remaining < pol.min_healthy_after_quarantine:
                _log.warning(
                    "pool %s: replica %s is a latency outlier (score %.1f) "
                    "but quarantine would leave %d healthy — refusing",
                    self.pool.name, r.name, score, remaining,
                )
                continue
            if r.health.mark_slow():
                self._slow_streak[r.name] = 0
                self._clear_streak[r.name] = 0
                self._metrics.counter("quarantines_total")
                self.pool._update_health_gauge()
                _log.warning(
                    "pool %s: QUARANTINED replica %s — attempt p99 %.1fms "
                    "vs healthy median %.1fms (MAD score %.1f > %g); "
                    "canary probes every %.2fs",
                    self.pool.name, r.name, p99, med, score,
                    pol.slow_mad_k, pol.canary_interval_s,
                )
                actions.append(f"quarantine:{r.name}")
        return actions

    # -- canary probing + rejoin/retire -------------------------------------
    def _canary_features(self) -> Optional[Dict[str, np.ndarray]]:
        if self._canary_columns is None:
            example = getattr(self.pool, "_example", None)
            if example is None:
                return None
            self._canary_columns = {
                c: np.asarray(example.column(c))[:1]
                for c in example.column_names
            }
        return self._canary_columns

    def _probe(self, replica) -> None:
        """One canary dispatch against a SLOW replica; the observation
        (success latency or censored timeout) lands in the replica's
        attempt ring, which is all the rejoin decision reads."""
        pol = self.policy
        features = self._canary_features()
        if features is None:
            return
        self._metrics.counter("canary_probes")
        t0 = time.monotonic()
        try:
            pending = replica.engine.submit(
                features, timeout_ms=pol.canary_timeout_ms
            )
        except BaseException as e:  # noqa: BLE001 — probe failure is data
            self._metrics.counter("canary_errors")
            if replica.health.on_error(e):
                self.pool._retire(replica, e)
            return
        if pending.wait(pol.canary_timeout_ms / 1000.0):
            try:
                pending.response()
            except BaseException as e:  # noqa: BLE001 — probe failure is data
                self._metrics.counter("canary_errors")
                if replica.health.on_error(e):
                    self.pool._retire(replica, e)
                return
            replica.health.record_attempt((time.monotonic() - t0) * 1000.0)
        else:
            pending.abandon()
            replica.health.record_attempt(
                pol.canary_timeout_ms, abandoned=True
            )

    def _run_quarantine(self, replicas, p99s, med, mad, now) -> List[str]:
        pol = self.policy
        actions: List[str] = []
        for r in replicas:
            if r.health.state is not ReplicaState.SLOW:
                continue
            if pol.quarantine_retire_s is not None and (
                r.health.state_age_s() > pol.quarantine_retire_s
            ):
                err = ReplicaQuarantinedError(
                    f"replica {r.name} stayed SLOW past "
                    f"{pol.quarantine_retire_s}s without recovering"
                )
                if r.health.force_unhealthy(err):
                    self._metrics.counter("slow_retired_total")
                    self.pool._retire(r, err)
                    actions.append(f"retire:{r.name}")
                continue
            last = self._last_canary.get(r.name, 0.0)
            if now - last >= pol.canary_interval_s:
                self._last_canary[r.name] = now
                self._probe(r)
            # Recovery is judged on the NEWEST canary window only: a
            # replica that just recovered must not stay quarantined
            # (and eventually be retired) because its stall-era canary
            # observations are still in the ring.
            canary_p99 = r.health.recent_attempt_p99(
                pol.canary_min_samples, min_samples=pol.canary_min_samples
            )
            recovered = False
            if canary_p99 is not None and med is not None and mad is not None:
                score = self._score(canary_p99, med, mad)
                recovered = (
                    score < pol.slow_mad_k / pol.decisive_margin
                    or (canary_p99 - med) <= pol.slow_abs_floor_ms
                )
            if recovered:
                streak = self._clear_streak.get(r.name, 0) + 1
                self._clear_streak[r.name] = streak
                if streak >= pol.slow_clear and r.health.clear_slow():
                    self._clear_streak[r.name] = 0
                    self._metrics.counter("rejoins_total")
                    self.pool._seed_ewma(r)
                    self.pool._update_health_gauge()
                    _log.info(
                        "pool %s: replica %s REJOINED after quarantine "
                        "(canary p99 %.1fms vs healthy median %.1fms)",
                        self.pool.name, r.name, canary_p99, med,
                    )
                    actions.append(f"rejoin:{r.name}")
            else:
                self._clear_streak[r.name] = 0
        return actions

    # -- brownout ladder -----------------------------------------------------
    def _check_brownout(self, pool_p99: Optional[float]) -> List[str]:
        pol = self.policy
        actions: List[str] = []
        if pool_p99 is None:
            return actions
        degraded = False
        if self._baseline_p99 is not None:
            threshold = max(
                self._baseline_p99 * pol.brownout_multiplier,
                self._baseline_p99 + pol.brownout_abs_floor_ms,
            )
            degraded = pool_p99 > threshold
        if not degraded:
            # Only a non-degraded sample may move the baseline: letting
            # the baseline chase a brownout would define the failure away.
            a = pol.baseline_alpha
            self._baseline_p99 = (
                pool_p99 if self._baseline_p99 is None
                else (1 - a) * self._baseline_p99 + a * pool_p99
            )
        if degraded:
            self._brownout_clear_streak = 0
            self._brownout_streak += 1
            if (
                self._brownout_streak >= pol.brownout_trip
                and self._brownout_level < len(pol.shed_order)
            ):
                self._brownout_streak = 0
                self._brownout_level += 1
                self._metrics.counter("brownout_escalations")
                actions.append(f"brownout:{self._brownout_level}")
                _log.warning(
                    "pool %s: BROWNOUT level %d — shedding SLO classes %s "
                    "(pool p99 %.1fms vs baseline %.1fms)",
                    self.pool.name, self._brownout_level,
                    pol.shed_order[:self._brownout_level],
                    pool_p99, self._baseline_p99 or float("nan"),
                )
        else:
            self._brownout_streak = 0
            if self._brownout_level > 0:
                self._brownout_clear_streak += 1
                if self._brownout_clear_streak >= pol.brownout_clear:
                    self._brownout_clear_streak = 0
                    self._brownout_level -= 1
                    self._metrics.counter("brownout_deescalations")
                    actions.append(f"brownout:{self._brownout_level}")
                    _log.info(
                        "pool %s: brownout de-escalated to level %d",
                        self.pool.name, self._brownout_level,
                    )
        self._metrics.gauge("brownout_level", float(self._brownout_level))
        shed = frozenset(pol.shed_order[:self._brownout_level])
        if shed != self.pool.brownout_shed_classes:
            self.pool.set_brownout(shed)
        return actions
