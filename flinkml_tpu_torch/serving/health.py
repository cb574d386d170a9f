"""Per-replica health: states, degradation policy, and the ledger.

The pool's overload story degrades **by replica, not globally**: one replica tripping its queue bound or failing its dispatches
is taken out of rotation while the rest of the pool keeps serving. Three
states:

- ``HEALTHY`` — in rotation.
- ``DRAINING`` — temporarily out of rotation after tripping its queue
  bound ``overload_trip`` times in a row; the engine keeps draining its
  queue, and the replica rejoins automatically once its backlog falls
  under ``drain_low_water`` of capacity (checked inline on every routing
  decision — no poller thread).
- ``SLOW`` — quarantined by the gray-failure guard
  (:class:`~flinkml_tpu_torch.serving.grayfail.GrayFailGuard`): the replica is
  alive and passing dispatches but a robust latency-outlier test (its
  attempt p99 vs the healthy-sibling median, MAD-based) says it is
  dragging pool tail latency. Removed from routing WITHOUT being
  killed; the guard probes it with low-rate canary dispatches and
  rejoins it (:meth:`ReplicaHealth.clear_slow`) on sustained recovery.
  A SLOW replica does NOT count as healthy for the autoscaler, so
  quarantine below ``min_replicas`` triggers replacement.
- ``UNHEALTHY`` — failed hard (``max_consecutive_errors`` dispatch
  failures, e.g. the ``serving.replica`` fault seam killing it): the
  pool retires it (stop without drain — queued requests fail fast and
  the router re-runs them on healthy replicas) and never routes to it
  again until :meth:`ReplicaHealth.revive`.

Transitions are CAS-style under one lock so racing router threads agree
on exactly one retirement per replica.

The ledger also keeps a per-ATTEMPT latency ring (:meth:`record_attempt`
/ :meth:`attempt_p99`): successful attempt latencies plus CENSORED
observations for abandoned attempts (recorded at the abandonment budget
— a stalled dispatch whose true latency is unknown still counts as "at
least this slow"). This ring, not the engine's completion window, is
what the gray-failure outlier test reads: it sees what the ROUTER
experienced, including the dispatches it gave up on.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import math
import threading
import time
from typing import Optional


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"
    DRAINING = "draining"
    SLOW = "slow"
    UNHEALTHY = "unhealthy"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Degradation thresholds (see module docstring)."""

    #: Dispatch failures in a row before the replica is retired.
    max_consecutive_errors: int = 1
    #: Queue-full refusals in a row before the replica drains.
    overload_trip: int = 8
    #: Fraction of ``max_queue_rows`` the backlog must fall under for a
    #: DRAINING replica to rejoin rotation.
    drain_low_water: float = 0.25


class ReplicaHealth:
    """One replica's health ledger. Thread-safe; shared by every router
    thread touching the replica."""

    def __init__(self, name: str, policy: Optional[HealthPolicy] = None):
        self.name = name
        self.policy = policy or HealthPolicy()
        self._lock = threading.Lock()
        self._state = ReplicaState.HEALTHY
        self._consecutive_errors = 0
        self._consecutive_overloads = 0
        self._last_error: Optional[BaseException] = None
        self._state_since = time.monotonic()
        #: Rows submitted to this replica and not yet settled — the
        #: router's least-outstanding-rows balance key.
        self.outstanding_rows = 0
        #: EWMA of observed ms per served row (queue wait included);
        #: feeds the router's deadline-aware replica ordering.
        self.ewma_ms_per_row: Optional[float] = None
        #: Per-attempt latency ring (successes + censored abandonments)
        #: — the gray-failure outlier test's input. Guarded by ``_lock``.
        self._attempt_ms: collections.deque = collections.deque(maxlen=256)
        #: :meth:`attempt_p99` of the ring as it stands (None: not yet
        #: computed since it last changed). The router reads every
        #: sibling's p99 on every request of a pool of several replicas,
        #: so one sort a change, not one a read. Guarded by ``_lock``.
        self._attempt_p99: Optional[float] = None
        self._abandoned_attempts = 0

    # -- state -------------------------------------------------------------
    @property
    def state(self) -> ReplicaState:
        return self._state

    @property
    def last_error(self) -> Optional[BaseException]:
        return self._last_error

    def _transition(self, state: ReplicaState) -> None:
        self._state = state
        self._state_since = time.monotonic()

    def routable(self) -> bool:
        return self._state is ReplicaState.HEALTHY

    # -- router accounting -------------------------------------------------
    def submit(self, rows: int) -> None:
        with self._lock:
            self.outstanding_rows += rows

    def settle(self, rows: int) -> None:
        with self._lock:
            self.outstanding_rows = max(0, self.outstanding_rows - rows)

    def estimated_wait_ms(self) -> Optional[float]:
        """Outstanding backlog × observed per-row latency, or None before
        any observation. An ESTIMATE for ordering/deadline hints only —
        never a reason to hard-reject on its own."""
        with self._lock:
            if self.ewma_ms_per_row is None:
                return None
            return self.outstanding_rows * self.ewma_ms_per_row

    # -- outcomes ----------------------------------------------------------
    def on_success(self, rows: int, latency_ms: float) -> None:
        with self._lock:
            self._consecutive_errors = 0
            self._consecutive_overloads = 0
            if rows > 0:
                per_row = latency_ms / rows
                self.ewma_ms_per_row = (
                    per_row if self.ewma_ms_per_row is None
                    else 0.8 * self.ewma_ms_per_row + 0.2 * per_row
                )

    # -- gray-failure signal (per-attempt latency ring) --------------------
    def record_attempt(self, latency_ms: float, abandoned: bool = False
                       ) -> None:
        """Record what one ROUTER attempt experienced on this replica:
        the attempt latency on success, or a censored observation (the
        abandonment budget — "at least this slow") when the router gave
        up waiting."""
        with self._lock:
            self._attempt_ms.append(float(latency_ms))
            self._attempt_p99 = None
            if abandoned:
                self._abandoned_attempts += 1

    def attempt_p99(self, min_samples: int = 1) -> Optional[float]:
        """p99 over the attempt ring, or None below ``min_samples``."""
        with self._lock:
            n = len(self._attempt_ms)
            if n < max(1, min_samples):
                return None
            if self._attempt_p99 is None:
                ordered = sorted(self._attempt_ms)
                self._attempt_p99 = ordered[min(n - 1,
                                                math.ceil(0.99 * n) - 1)]
            return self._attempt_p99

    def recent_attempt_p99(self, window: int,
                           min_samples: int = 1) -> Optional[float]:
        """p99 over only the newest ``window`` ring entries (None below
        ``min_samples`` total). The quarantine REJOIN decision reads
        this: a recovered replica's stall-era canary observations would
        otherwise hold the whole-ring p99 high until they aged out of
        the ring — hundreds of probes after the stall actually cleared."""
        with self._lock:
            if len(self._attempt_ms) < max(1, min_samples):
                return None
            recent = sorted(list(self._attempt_ms)[-max(1, window):])
            n = len(recent)
            return recent[min(n - 1, math.ceil(0.99 * n) - 1)]

    def mark_slow(self) -> bool:
        """HEALTHY -> SLOW (CAS): quarantine a latency outlier without
        killing it. True for exactly one caller; False from any other
        state (a DRAINING/UNHEALTHY replica already has a stronger
        verdict). Clears the attempt ring: the rejoin decision must read
        only POST-quarantine (canary) evidence, not the stall that
        caused the quarantine."""
        with self._lock:
            if self._state is not ReplicaState.HEALTHY:
                return False
            self._attempt_ms.clear()
            self._attempt_p99 = None
            self._transition(ReplicaState.SLOW)
            return True

    def clear_slow(self) -> bool:
        """SLOW -> HEALTHY (CAS) on sustained canary recovery. Clears
        the attempt ring: the stall-era censored observations would
        otherwise immediately re-trip the outlier test on rejoin."""
        with self._lock:
            if self._state is not ReplicaState.SLOW:
                return False
            self._attempt_ms.clear()
            self._attempt_p99 = None
            self._abandoned_attempts = 0
            self._transition(ReplicaState.HEALTHY)
            return True

    def force_unhealthy(self, error: BaseException) -> bool:
        """Administrative retirement (the guard escalating a quarantine
        that never recovered): any state except UNHEALTHY -> UNHEALTHY.
        True for exactly one caller — the same exactly-one-retirement
        CAS as :meth:`on_error`."""
        with self._lock:
            if self._state is ReplicaState.UNHEALTHY:
                return False
            self._last_error = error
            self._transition(ReplicaState.UNHEALTHY)
            return True

    def state_age_s(self) -> float:
        with self._lock:
            return time.monotonic() - self._state_since

    def on_overload(self) -> bool:
        """Record one queue-full refusal; True when this trip moved the
        replica HEALTHY -> DRAINING (the caller logs/metrics it)."""
        with self._lock:
            self._consecutive_overloads += 1
            if (
                self._state is ReplicaState.HEALTHY
                and self._consecutive_overloads >= self.policy.overload_trip
            ):
                self._transition(ReplicaState.DRAINING)
                return True
            return False

    def on_error(self, error: BaseException) -> bool:
        """Record one dispatch failure; True when this failure crossed
        the threshold and the replica must be RETIRED (exactly one caller
        gets True — the CAS the pool's single-retire relies on)."""
        with self._lock:
            self._last_error = error
            self._consecutive_errors += 1
            if (
                self._state is not ReplicaState.UNHEALTHY
                and self._consecutive_errors
                >= self.policy.max_consecutive_errors
            ):
                self._transition(ReplicaState.UNHEALTHY)
                return True
            return False

    def maybe_rejoin(self, queued_rows: int, max_queue_rows: int) -> bool:
        """Inline DRAINING -> HEALTHY recovery check (called by the
        router on every pass over the replicas)."""
        with self._lock:
            if self._state is not ReplicaState.DRAINING:
                return False
            if queued_rows <= max_queue_rows * self.policy.drain_low_water:
                self._transition(ReplicaState.HEALTHY)
                self._consecutive_overloads = 0
                return True
            return False

    def revive(self) -> None:
        """Operator-driven UNHEALTHY -> HEALTHY (after the pool restarted
        the engine). Resets the LATENCY/backlog stats too: the revived
        engine starts with an empty queue and fresh programs, so ranking
        it by its pre-failure EWMA (often inflated by the very death
        throes that retired it) would mis-order it until the stale
        history washed out — the pool re-seeds from healthy siblings
        right after (:meth:`seed_ewma`)."""
        with self._lock:
            self._consecutive_errors = 0
            self._consecutive_overloads = 0
            self._last_error = None
            self.outstanding_rows = 0
            self.ewma_ms_per_row = None
            self._attempt_ms.clear()
            self._attempt_p99 = None
            self._abandoned_attempts = 0
            self._transition(ReplicaState.HEALTHY)

    def seed_ewma(self, ms_per_row: Optional[float]) -> None:
        """Seed the latency estimate of a replica that has served
        nothing yet (fresh scale-up, or just revived) from its healthy
        siblings' median, so the router's deadline ordering treats it as
        a known-latency candidate immediately instead of letting it
        settle late. Never clobbers a real observation."""
        if ms_per_row is None:
            return
        with self._lock:
            if self.ewma_ms_per_row is None:
                self.ewma_ms_per_row = float(ms_per_row)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "state": self._state.value,
                "state_age_s": round(time.monotonic() - self._state_since, 3),
                "outstanding_rows": self.outstanding_rows,
                "consecutive_errors": self._consecutive_errors,
                "consecutive_overloads": self._consecutive_overloads,
                "ewma_ms_per_row": self.ewma_ms_per_row,
                "attempt_samples": len(self._attempt_ms),
                "abandoned_attempts": self._abandoned_attempts,
                "last_error": (
                    repr(self._last_error) if self._last_error else None
                ),
            }
