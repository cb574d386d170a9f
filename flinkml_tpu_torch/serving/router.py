"""Request routing over a replica pool: balance, admit, fail over, hedge.

The router is the pool's front door. Per request:

1. **Admission** is deadline-aware: a request whose deadline already
   passed is refused with the typed timeout BEFORE it occupies any
   queue, and replicas are ordered so ones whose estimated backlog
   (outstanding rows × observed ms/row EWMA) fits the remaining budget
   come first — the estimate orders candidates, it never hard-rejects
   (an EWMA is a hint, not a promise). Untimed requests inherit the
   pool-level ``default_timeout_ms`` so a stalled replica can never
   hold a caller forever.
2. **Balance** is least-outstanding-rows: among routable replicas the
   one with the fewest submitted-but-unsettled rows wins — cheap,
   greedy, and (unlike round-robin) automatically biased away from slow
   or draining-adjacent replicas because their backlog settles late.
3. **Failover**: a replica whose dispatch fails (a killed replica's
   batches raise, a stopped engine refuses) reports to its health
   ledger — crossing the threshold retires it via the pool callback —
   and the request is re-run on the next candidate. Transforms are pure,
   so a retry cannot double-apply anything; a request is retried at most
   once per replica. Queue-full refusals fail over the same way without
   counting as errors (and trip the replica into DRAINING after enough
   consecutive refusals — per-replica degradation, not a global brownout).
4. **Gray-failure containment** (when a
   :class:`~flinkml_tpu_torch.serving.grayfail.GrayFailPolicy` is wired in):

   - *Per-attempt deadlines with true abandonment*: each dispatch gets
     a budget of healthy-sibling attempt-p99 median ×
     ``deadline_multiplier`` (floored at ``attempt_floor_ms``). A
     dispatch exceeding it is ABANDONED — the router stops waiting and
     fails over, the request's queued rows release at the batcher's
     next sweep, and the abandoned attempt's late straggler result is
     discarded by the request's terminal-transition CAS, so it can
     never surface as a duplicate or (across a hot swap) mis-versioned
     response. The abandonment is recorded in the replica's attempt
     ring as a CENSORED observation at the budget value — the
     quarantine guard's evidence.
   - *Hedged requests*: transforms are pure and idempotent, so a
     request whose first attempt exceeds the hedge threshold
     (sibling p99 × ``hedge_multiplier``, floored) is speculatively
     re-dispatched to the next-best replica. First completion wins;
     the loser is abandoned (cancelled at the queue, straggler result
     discarded). Hedging duplicates DISPATCH work only — admission
     budgets (SLO ledgers) are charged per request, upstream of the
     router, so a hedge is never double-counted.

Typed outcomes: client mistakes (:class:`ServingSchemaError`) and
deadline expiry (:class:`ServingTimeoutError`) propagate immediately —
they would fail identically on every replica. When every candidate was
tried: all-queues-full is :class:`ServingOverloadError` (back off and
retry), no-routable-replica is :class:`PoolUnavailableError` (page).
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from flinkml_tpu_torch.serving.errors import (
    PoolUnavailableError,
    ServingOverloadError,
    ServingSchemaError,
    ServingTimeoutError,
)
from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import metrics

_log = get_logger("serving.router")

#: Grace the engine's synchronous path has always given an IN-FLIGHT
#: batch past the request deadline; the router's await loop honors the
#: same allowance before raising the typed timeout.
_DEADLINE_GRACE_S = 0.25

#: Cap on one await-loop sleep: the race event wakes the loop on any
#: attempt's terminal transition, but an attempt that completes in the
#: narrow window before its event is wired would otherwise sleep a full
#: budget.
_MAX_WAIT_SLICE_S = 0.05


class _Attempt:
    """One in-flight dispatch of a request on one replica."""

    __slots__ = ("replica", "pending", "t0", "abandon_at", "hedge")

    def __init__(self, replica, pending, t0, abandon_at, hedge):
        self.replica = replica
        self.pending = pending
        self.t0 = t0
        self.abandon_at = abandon_at  # monotonic, None = no budget
        self.hedge = hedge


class Router:
    """Stateless-per-request router over the pool's replicas. ``replicas``
    is a live sequence of objects with ``.name``, ``.engine`` and
    ``.health`` (:class:`~flinkml_tpu_torch.serving.health.ReplicaHealth`);
    ``rows_of`` estimates a request's row count for balance accounting;
    ``on_retire(replica, error)`` is the pool's retirement hook (invoked
    exactly once per replica, from whichever router thread crossed the
    error threshold). ``grayfail`` enables per-attempt abandonment and
    hedging; ``default_timeout_ms`` is the finite deadline untimed
    requests inherit; ``pool_name`` names the labeled hedge-outcome
    metric family."""

    def __init__(
        self,
        replicas: Sequence[Any],
        rows_of: Callable[[Any], int],
        metrics_group,
        on_retire: Optional[Callable[[Any, BaseException], None]] = None,
        grayfail: Optional[Any] = None,
        default_timeout_ms: Optional[float] = None,
        pool_name: Optional[str] = None,
    ):
        self._replicas = replicas
        self._rows_of = rows_of
        self._metrics = metrics_group
        self._on_retire = on_retire
        self._grayfail = grayfail
        self._default_timeout_ms = default_timeout_ms
        self._pool_name = pool_name

    def _hedge_outcome(self, outcome: str) -> None:
        self._metrics.counter(f"hedges_{outcome}")
        if self._pool_name is not None:
            metrics.group(
                f"serving.{self._pool_name}.hedges",
                labels={"outcome": outcome},
            ).counter("total")

    # -- candidate selection -----------------------------------------------
    def _candidates(self, tried: set,
                    model_id: Optional[str] = None) -> List[Any]:
        out = []
        for replica in list(self._replicas):  # snapshot: scaling mutates
            if replica.name in tried:
                continue
            if (model_id is not None
                    and getattr(replica, "model_id", None) != model_id):
                continue  # multi-model pools: route within the model
            health = replica.health
            if not health.routable():
                # Inline DRAINING -> HEALTHY recovery: rejoin once the
                # backlog fell under the policy's low-water mark. (SLOW
                # replicas rejoin through the guard's canary path, never
                # here.)
                health.maybe_rejoin(
                    replica.engine._batcher.queued_rows,
                    replica.engine.config.max_queue_rows,
                )
                if not health.routable():
                    continue
            out.append(replica)
        return out

    def _order(self, candidates: List[Any],
               remaining_ms: Optional[float]) -> List[Any]:
        def backlog(r):
            return r.health.outstanding_rows

        ordered = sorted(candidates, key=backlog)
        if remaining_ms is None:
            return ordered
        fits, tight = [], []
        for r in ordered:
            est = r.health.estimated_wait_ms()
            (fits if est is None or est <= remaining_ms else tight).append(r)
        return fits + tight

    # -- gray-failure budgets ----------------------------------------------
    def _sibling_p99_ms(self, exclude: Optional[Any]) -> Optional[float]:
        """Median of the routable replicas' attempt-ring p99s (excluding
        ``exclude``) — the robust 'what do healthy siblings look like'
        statistic the attempt budget and hedge threshold derive from.
        None until enough siblings have enough samples."""
        gf = self._grayfail
        vals = []
        for r in list(self._replicas):
            if r is exclude or not r.health.routable():
                continue
            p = r.health.attempt_p99(min_samples=gf.min_attempt_samples)
            if p is not None:
                vals.append(p)
        if not vals:
            return None
        return float(statistics.median(vals))

    def _attempt_budget_s(self, replica: Any) -> Optional[float]:
        gf = self._grayfail
        if gf is None or not gf.abandon:
            return None
        sib = self._sibling_p99_ms(replica)
        if sib is None:
            return None  # cold pool: no evidence, no abandonment
        budget_ms = max(
            gf.attempt_floor_ms, sib * gf.resolved_deadline_multiplier()
        )
        return budget_ms / 1000.0

    def _hedge_delay_s(self) -> Optional[float]:
        gf = self._grayfail
        if gf is None or not gf.hedge:
            return None
        sib = self._sibling_p99_ms(None)
        if sib is None:
            return None
        return max(gf.hedge_floor_ms, sib * gf.hedge_multiplier) / 1000.0

    # -- the request path --------------------------------------------------
    def predict(self, features: Any, timeout_ms: Optional[float] = None,
                model_id: Optional[str] = None):
        if timeout_ms is None:
            timeout_ms = self._default_timeout_ms
        t0 = time.monotonic()
        deadline = t0 + timeout_ms / 1000.0 if timeout_ms is not None else None
        rows = self._rows_of(features)
        self._metrics.counter("routed_requests")
        self._metrics.counter("routed_rows", float(rows))
        tried: set = set()
        state = {"overload": None, "failure": None, "abandoned": 0}
        while True:
            if deadline is not None and time.monotonic() >= deadline:
                self._metrics.counter("admission_timeouts")
                raise ServingTimeoutError(
                    f"request deadline ({timeout_ms}ms) expired at pool "
                    "admission"
                )
            remaining_ms = (
                None if deadline is None
                else (deadline - time.monotonic()) * 1000.0
            )
            candidates = self._order(
                self._candidates(tried, model_id), remaining_ms
            )
            if not candidates:
                break
            resp = self._run_attempts(
                candidates, features, rows, deadline, tried, state
            )
            if resp is not None:
                if tried:
                    self._metrics.counter("retried_successes")
                return resp
        if state["overload"] is not None:
            self._metrics.counter("pool_overloads")
            raise ServingOverloadError(
                "every healthy replica's queue is full; retry with backoff"
            ) from state["overload"]
        self._metrics.counter("pool_unavailable")
        detail = ""
        if state["failure"] is not None:
            detail = f" (last failure: {state['failure']!r})"
        elif state["abandoned"]:
            detail = (
                f" ({state['abandoned']} dispatch(es) abandoned past their "
                "attempt budget — every candidate looks stalled)"
            )
        raise PoolUnavailableError(
            "no healthy replica available" + detail
        ) from state["failure"]

    # -- one round: primary attempt + optional hedge -------------------------
    def _dispatch(self, replica: Any, features: Any, rows: int,
                  deadline: Optional[float], race: threading.Event,
                  tried: set, state: dict, hedge: bool) -> Optional[_Attempt]:
        """Submit one attempt. Returns the live attempt, or None when the
        submit itself was refused/failed (recorded in ``tried``/``state``
        — the caller moves on)."""
        health = replica.health
        health.submit(rows)
        now = time.monotonic()
        remaining_ms = None if deadline is None else max(
            0.0, (deadline - now) * 1000.0
        )
        try:
            pending = replica.engine.submit(features, timeout_ms=remaining_ms)
        except ServingSchemaError:
            health.settle(rows)
            raise  # client mistake: identical on every replica
        except ServingOverloadError as e:
            health.settle(rows)
            state["overload"] = e
            tried.add(replica.name)
            self._metrics.counter("overload_reroutes")
            if health.on_overload():
                self._metrics.counter("replicas_draining")
                _log.warning(
                    "replica %s tripped its queue bound -> DRAINING",
                    replica.name,
                )
            return None
        except BaseException as e:  # noqa: BLE001 — replica failure
            health.settle(rows)
            self._record_failure(replica, e, tried, state)
            return None
        pending.request.race = race
        budget_s = self._attempt_budget_s(replica)
        abandon_at = None if budget_s is None else now + budget_s
        return _Attempt(replica, pending, now, abandon_at, hedge)

    def _record_failure(self, replica: Any, error: BaseException,
                        tried: set, state: dict) -> None:
        state["failure"] = error
        tried.add(replica.name)
        self._metrics.counter("failovers")
        if replica.health.on_error(error):
            _log.warning(
                "replica %s failed dispatch (%r) -> UNHEALTHY",
                replica.name, error,
            )
            if self._on_retire is not None:
                self._on_retire(replica, error)

    def _abandon_attempt(self, a: _Attempt, rows: int, tried: set,
                         state: dict) -> bool:
        """Per-attempt budget expiry: stop waiting, record the censored
        observation, fail over. False when the attempt completed in the
        race window (the caller finalizes it normally instead)."""
        if not a.pending.abandon():
            return False
        health = a.replica.health
        health.settle(rows)
        budget_ms = (a.abandon_at - a.t0) * 1000.0
        health.record_attempt(budget_ms, abandoned=True)
        tried.add(a.replica.name)
        state["abandoned"] += 1
        self._metrics.counter("abandoned_attempts")
        _log.warning(
            "abandoned dispatch on replica %s after %.0fms attempt budget "
            "(failing over; straggler result will be discarded)",
            a.replica.name, budget_ms,
        )
        return True

    def _cancel_loser(self, a: _Attempt, rows: int) -> None:
        """Another attempt won the race: cancel this one at the queue and
        discard whatever it may still produce. Its elapsed time is a
        LOWER BOUND on its latency — recorded censored, so a habitually
        slow replica keeps accumulating quarantine evidence even when
        hedges keep saving its requests."""
        a.pending.abandon()
        a.replica.health.settle(rows)
        a.replica.health.record_attempt(
            (time.monotonic() - a.t0) * 1000.0, abandoned=True
        )
        if a.hedge:
            self._hedge_outcome("lost")

    def _run_attempts(self, candidates: List[Any], features: Any, rows: int,
                      deadline: Optional[float], tried: set,
                      state: dict) -> Optional[Any]:
        """Dispatch to ``candidates[0]`` and race it against per-attempt
        budgets, the overall deadline, and (past the hedge threshold) one
        speculative re-dispatch to the next-best candidate. Returns the
        winning response, or None when every live attempt failed or was
        abandoned (the outer loop re-selects over the updated tried-set).
        """
        race = threading.Event()
        attempts: List[_Attempt] = []
        winner: Optional[_Attempt] = None
        alternates = list(candidates[1:])
        first = self._dispatch(
            candidates[0], features, rows, deadline, race, tried, state,
            hedge=False,
        )
        if first is None:
            return None
        attempts.append(first)
        hedge_delay = self._hedge_delay_s() if alternates else None
        hedge_at = None if hedge_delay is None else first.t0 + hedge_delay
        try:
            while attempts:
                now = time.monotonic()
                # 1) Completions first: a result that landed outranks any
                #    budget that expired in the same slice.
                for a in list(attempts):
                    if not a.pending.request.done.is_set():
                        continue
                    attempts.remove(a)
                    health = a.replica.health
                    health.settle(rows)
                    err = a.pending.request.error
                    if err is None and a.pending.request.result is not None:
                        latency_ms = (now - a.t0) * 1000.0
                        health.on_success(rows, latency_ms)
                        health.record_attempt(latency_ms)
                        if a.hedge:
                            self._hedge_outcome("won")
                        winner = a
                        return a.pending.response()
                    if isinstance(err, ServingTimeoutError):
                        raise err  # deadline contract outranks failover
                    self._record_failure(a.replica, err, tried, state)
                if not attempts:
                    return None
                # 2) Overall deadline (same in-flight grace the engine's
                #    synchronous path has always allowed).
                if deadline is not None and now >= deadline + _DEADLINE_GRACE_S:
                    raise ServingTimeoutError(
                        "request did not complete within its deadline"
                    )
                # 3) Per-attempt budgets: abandon and fail over.
                for a in list(attempts):
                    if a.abandon_at is not None and now >= a.abandon_at:
                        if self._abandon_attempt(a, rows, tried, state):
                            attempts.remove(a)
                if not attempts:
                    return None
                # 4) Hedge: one speculative re-dispatch, once.
                if (hedge_at is not None and now >= hedge_at
                        and len(attempts) == 1):
                    hedge_at = None
                    while alternates:
                        alt = alternates.pop(0)
                        if alt.name in tried or not alt.health.routable():
                            continue
                        hedged = self._dispatch(
                            alt, features, rows, deadline, race, tried,
                            state, hedge=True,
                        )
                        if hedged is not None:
                            attempts.append(hedged)
                            self._hedge_outcome("dispatched")
                            break
                # 5) Sleep to the next edge (or the first terminal event).
                edges = [
                    a.abandon_at for a in attempts if a.abandon_at is not None
                ]
                if deadline is not None:
                    edges.append(deadline + _DEADLINE_GRACE_S)
                if hedge_at is not None:
                    edges.append(hedge_at)
                wait_s = (
                    min(edges) - time.monotonic() if edges
                    else _MAX_WAIT_SLICE_S
                )
                race.wait(min(max(wait_s, 0.0005), _MAX_WAIT_SLICE_S))
                race.clear()
            return None
        finally:
            # No exit path may leave an attempt un-settled: losers (and,
            # on a typed raise, every straggler) are cancelled at the
            # queue and their late results discarded.
            for a in attempts:
                if a is not winner:
                    self._cancel_loser(a, rows)
