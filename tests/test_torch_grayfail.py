"""Gray-failure defense: abandonment, hedging, quarantine, brownout, in the
port (``flinkml_tpu_torch.serving``), on the CPU.

Mirrors the JAX package's ``tests/test_grayfail.py`` name for name, then
holds the port against the JAX package: the same attempt latencies give
the same quarantine and brownout verdicts, the serving soak's sampler
draws the same schedules, and the serving soak's CLI passes. The
acceptance contract of the gray-failure subsystem:

  1. Per-dispatch deadlines with TRUE abandonment — the router stops
     waiting past the per-attempt budget and fails over; the abandoned
     straggler's late result is discarded by the request's terminal CAS,
     so it can never surface as a duplicate or (across a hot swap)
     mis-versioned response.
  2. Hedged requests are exactly-once at the client: first completion
     wins, the loser is cancelled at the queue, admission is charged per
     request (never per attempt).
  3. Latency-outlier quarantine: the MAD test trips a slow-but-alive
     replica into SLOW (out of routing, NOT killed), canary probes
     drive SLOW -> HEALTHY on sustained recovery, and a quarantine that
     never recovers escalates to retirement. SLOW counts against the
     autoscaler's ``min_replicas``, so quarantine triggers replacement.
  4. The brownout ladder sheds SLO classes in declared order (batch
     before interactive) under pool-WIDE degradation, via the typed
     ``SLOAdmissionError``.
  5. Chaos acceptance: 1 of 4 replicas stalled ~100x mid-traffic is
     autonomously quarantined, zero requests are lost, zero responses
     are duplicated or mis-versioned, closed-loop p99 recovers, and the
     replica rejoins after the stall clears with no operator action.
"""

import threading
import time

import numpy as np
import pytest

from flinkml_tpu_torch import faults
from flinkml_tpu_torch.models.scalers import StandardScaler
from flinkml_tpu_torch.serving import (
    AutoscaleConfig,
    BATCH,
    GrayFailPolicy,
    INTERACTIVE,
    ModelRegistry,
    MultiModelPool,
    PoolAutoscaler,
    ReplicaPool,
    ReplicaState,
    ServingConfig,
    ServingRequest,
    ServingTimeoutError,
    SLOAdmissionError,
)
from flinkml_tpu_torch.table import Table
from flinkml_tpu_torch.utils.metrics import metrics
from tests._torch_serving_common import (  # noqa: F401
    _on_cpu,
    _time_limit,
    on_cpu,
    program_counts,
)



def _data(n=256, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d))


def _scaler(x):
    return (
        StandardScaler()
        .set(StandardScaler.INPUT_COL, "features")
        .set(StandardScaler.OUTPUT_COL, "scaled")
        .fit(Table({"features": x}))
    )


def _pool(source, x, n_replicas=4, name="gf_pool", grayfail=None, **cfg):
    config = ServingConfig(**{
        "max_batch_rows": 64,
        "max_queue_rows": 512,
        "max_wait_ms": 1.0,
        **cfg,
    })
    return ReplicaPool(
        source, Table({"features": x[:4]}), config=config,
        n_replicas=n_replicas, output_cols=("scaled",), name=name,
        grayfail=grayfail,
    )


def _seed_rings(pool, ms=5.0, n=10, only=None):
    """Deterministically seed per-replica attempt rings (sequential
    warm traffic all lands on one replica under least-outstanding
    ties, so tests seed the sibling evidence directly)."""
    for r in pool.replicas:
        if only is not None and r.name not in only:
            continue
        for _ in range(n):
            r.health.record_attempt(ms)


def _expected(model, x):
    (ref,) = model.transform(Table({"features": x}))
    return np.asarray(ref.column("scaled"))


# ---------------------------------------------------------------------------
# 1. Terminal-transition CAS on ServingRequest (the safety primitive)
# ---------------------------------------------------------------------------

def test_request_terminal_cas_first_transition_wins():
    """Exactly one of complete/fail/abandon takes effect; every later
    transition is refused — the mechanism that makes a late straggler
    incapable of producing a duplicate or mis-versioned response."""
    def req():
        return ServingRequest(
            columns={"x": np.zeros((2, 2))}, rows=2,
            enqueued_at=time.monotonic(), deadline=None,
        )

    r = req()
    race = threading.Event()
    r.race = race
    assert r.complete({"x": np.ones((2, 2))}, version=1)
    assert race.is_set()  # terminal transition wakes the racing router
    assert not r.complete({"x": np.zeros((2, 2))}, version=2)
    assert not r.abandon()
    assert not r.fail(RuntimeError("late"))
    assert r.version == 1 and r.error is None and not r.abandoned

    r = req()
    assert r.abandon()
    assert r.abandoned
    assert not r.complete({"x": np.ones((2, 2))}, version=9)
    assert r.result is None and r.version is None

    r = req()
    assert r.fail(RuntimeError("boom"))
    assert not r.abandon()


# ---------------------------------------------------------------------------
# 2. Pool-level default timeout (an untimed request can never hang)
# ---------------------------------------------------------------------------

def test_untimed_request_inherits_pool_default_timeout():
    x = _data()
    model = _scaler(x)
    pool = _pool(model, x, n_replicas=2, name="deft_pool",
                 default_timeout_ms=200.0).start()
    try:
        assert pool._router._default_timeout_ms == 200.0
        with faults.armed(faults.FaultPlan(
            faults.StallDispatch("r0", delay_s=1.0),
            faults.StallDispatch("r1", delay_s=1.0),
        )):
            t0 = time.monotonic()
            with pytest.raises(ServingTimeoutError):
                pool.predict({"features": x[:2]})  # NO explicit timeout
            # Bounded by default deadline + in-flight grace, not by the
            # 1s stall (and certainly not forever).
            assert time.monotonic() - t0 < 2.0
    finally:
        pool.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# 3. Abandonment: stop waiting, fail over, censored evidence
# ---------------------------------------------------------------------------

def test_abandonment_fails_over_and_records_censored():
    x = _data()
    model = _scaler(x)
    policy = GrayFailPolicy(
        attempt_floor_ms=40.0, min_attempt_samples=5, hedge=False,
        deadline_multiplier=4.0, brownout=False,
    )
    pool = _pool(model, x, n_replicas=3, name="aband_pool",
                 grayfail=policy).start()
    expected = _expected(model, x)
    try:
        _seed_rings(pool, ms=5.0, n=10)
        with faults.armed(faults.FaultPlan(
            faults.StallDispatch("r0", delay_s=0.6)
        )):
            for i in range(4):
                sl = slice(i * 4, i * 4 + 4)
                t0 = time.monotonic()
                resp = pool.predict({"features": x[sl]}, timeout_ms=5000.0)
                # Served well inside the 0.6s stall: the router stopped
                # waiting at the ~40ms attempt budget and failed over.
                assert time.monotonic() - t0 < 0.5
                np.testing.assert_array_equal(
                    np.asarray(resp.columns["scaled"]), expected[sl]
                )
        st = pool.stats()
        assert st["router"].get("abandoned_attempts", 0) >= 1
        r0 = pool.replicas[0].health.snapshot()
        assert r0["abandoned_attempts"] >= 1  # censored ring evidence
        assert r0["state"] == "healthy"  # abandonment alone never kills
    finally:
        pool.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# 4. Hedging: exactly-once, loser cancelled, straggler discarded
# ---------------------------------------------------------------------------

def test_hedge_exactly_once_straggler_discarded():
    x = _data()
    model = _scaler(x)
    policy = GrayFailPolicy(
        abandon=False, hedge=True, hedge_floor_ms=40.0,
        hedge_multiplier=1.0, min_attempt_samples=5, brownout=False,
    )
    pool = _pool(model, x, n_replicas=2, name="hedge_pool",
                 grayfail=policy).start()
    expected = _expected(model, x)
    try:
        _seed_rings(pool, ms=5.0, n=10)
        with faults.armed(faults.FaultPlan(
            faults.StallDispatch("r0", delay_s=0.4, for_batches=1)
        )):
            resp = pool.predict({"features": x[:4]}, timeout_ms=5000.0)
            np.testing.assert_array_equal(
                np.asarray(resp.columns["scaled"]), expected[:4]
            )
            # The stalled primary finishes ~0.4s in; its result must be
            # discarded by the terminal CAS, never double-surfaced.
            deadline = time.monotonic() + 5.0
            r0 = pool.replicas[0].engine
            while time.monotonic() < deadline:
                if r0._metrics.snapshot()["counters"].get(
                        "discarded_results", 0) >= 1:
                    break
                time.sleep(0.02)
        st = pool.stats()["router"]
        assert st.get("hedges_dispatched", 0) >= 1
        assert st.get("hedges_won", 0) >= 1
        assert r0._metrics.snapshot()["counters"].get(
            "discarded_results", 0) >= 1
        # The labeled hedge-outcome metric family is live.
        won = metrics.group("serving.hedge_pool.hedges",
                            labels={"outcome": "won"})
        assert won.snapshot()["counters"].get("total", 0) >= 1
    finally:
        pool.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# 5. Abandoned straggler across a hot swap: version safety
# ---------------------------------------------------------------------------

def test_abandoned_straggler_version_safety_across_hot_swap(tmp_path):
    x = _data()
    model = _scaler(x)
    policy = GrayFailPolicy(
        attempt_floor_ms=40.0, min_attempt_samples=5, hedge=False,
        deadline_multiplier=4.0, brownout=False,
    )
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model)
    pool = _pool(reg, x, n_replicas=2, name="swap_pool",
                 grayfail=policy).start()
    pool.follow_registry()
    try:
        _seed_rings(pool, ms=5.0, n=10)
        with faults.armed(faults.FaultPlan(
            faults.StallDispatch("r0", delay_s=0.5, for_batches=1)
        )):
            # Lands on r0 (stalled), is abandoned at ~40ms, serves on r1.
            resp = pool.predict({"features": x[:4]}, timeout_ms=5000.0)
            assert resp.version == 1
            # Roll the pool to v2 while r0's straggler batch is still
            # sleeping on the v1-era request.
            reg.publish(_scaler(x * 2.0))
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if set(pool.versions().values()) == {2}:
                break
            time.sleep(0.05)
        assert set(pool.versions().values()) == {2}
        # The straggler completed under SOME version — but its request
        # was already terminal, so the result was discarded, not served.
        r0 = pool.replicas[0].engine
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if r0._metrics.snapshot()["counters"].get(
                    "discarded_results", 0) >= 1:
                break
            time.sleep(0.02)
        assert r0._metrics.snapshot()["counters"].get(
            "discarded_results", 0) >= 1
    finally:
        pool.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# 6. Quarantine -> canary -> rejoin lifecycle (deterministic, step-driven)
# ---------------------------------------------------------------------------

def _lifecycle_policy(**over):
    kw = dict(
        abandon=False, hedge=False, brownout=False,
        min_slow_samples=5, slow_trip=2, slow_clear=2,
        slow_abs_floor_ms=1.0, canary_interval_s=0.0,
        canary_timeout_ms=1000.0, canary_min_samples=2,
        quarantine_retire_s=None,
    )
    kw.update(over)
    return GrayFailPolicy(**kw)


def test_quarantine_canary_rejoin_lifecycle():
    x = _data()
    model = _scaler(x)
    pool = _pool(model, x, n_replicas=4, name="quar_pool").start()
    guard = pool.grayfail_guard(policy=_lifecycle_policy())
    try:
        _seed_rings(pool, ms=5.0, n=10, only={"r1", "r2", "r3"})
        _seed_rings(pool, ms=500.0, n=10, only={"r0"})
        assert guard.step() == []  # hysteresis: one trip is not enough
        actions = guard.step()
        assert "quarantine:r0" in actions
        assert pool.replicas[0].health.state is ReplicaState.SLOW
        assert pool.stats()["healthy"] == 3  # out of routing, NOT killed
        # The outlier score gauge is published per replica.
        score = metrics.group("serving.quar_pool",
                              labels={"replica": "r0"})
        assert score.snapshot()["gauges"]["slow_score"] > 6.0
        # Canary probes (the engine is actually fast — the seeded ring
        # was the lie) accumulate post-quarantine evidence and rejoin.
        seen = []
        for _ in range(10):
            seen += guard.step()
            if "rejoin:r0" in seen:
                break
        assert "rejoin:r0" in seen
        assert pool.replicas[0].health.state is ReplicaState.HEALTHY
        assert pool.stats()["healthy"] == 4
        counters = guard._metrics.snapshot()["counters"]
        assert counters.get("quarantines_total", 0) >= 1
        assert counters.get("rejoins_total", 0) >= 1
        assert counters.get("canary_probes", 0) >= 2
    finally:
        pool.stop(drain=False, timeout=5.0)


def test_quarantine_refused_when_it_would_empty_the_pool():
    x = _data()
    model = _scaler(x)
    pool = _pool(model, x, n_replicas=2, name="floor_pool").start()
    guard = pool.grayfail_guard(
        policy=_lifecycle_policy(min_healthy_after_quarantine=2)
    )
    try:
        _seed_rings(pool, ms=5.0, n=10, only={"r1"})
        _seed_rings(pool, ms=500.0, n=10, only={"r0"})
        for _ in range(4):
            assert guard.step() == []
        assert pool.replicas[0].health.state is ReplicaState.HEALTHY
    finally:
        pool.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# 7. Composition with the autoscaler: replacement and escalation
# ---------------------------------------------------------------------------

def test_quarantine_counts_against_min_replicas_and_is_replaced():
    x = _data()
    model = _scaler(x)
    pool = _pool(model, x, n_replicas=4, name="scale_pool").start()
    scaler = PoolAutoscaler(pool, AutoscaleConfig(
        min_replicas=4, max_replicas=6, cooldown_s=0.0,
    ))
    try:
        assert pool.replicas[0].health.mark_slow()
        sig = scaler.signals()
        assert sig["healthy"] == 3  # SLOW is not healthy
        assert scaler.step() == "replace"
        assert len(pool.replicas) == 5
        # The quarantined replica is still there, still SLOW — replaced,
        # not killed: it may yet recover and rejoin.
        assert pool.replicas[0].health.state is ReplicaState.SLOW
        assert scaler.signals()["healthy"] == 4
    finally:
        pool.stop(drain=False, timeout=5.0)


def test_quarantine_that_never_recovers_escalates_to_retirement():
    x = _data()
    model = _scaler(x)
    pool = _pool(model, x, n_replicas=4, name="retire_pool").start()
    guard = pool.grayfail_guard(
        policy=_lifecycle_policy(quarantine_retire_s=0.0)
    )
    try:
        assert pool.replicas[0].health.mark_slow()
        time.sleep(0.01)  # any positive state age beats the 0.0s budget
        actions = guard.step()
        assert "retire:r0" in actions
        assert pool.replicas[0].health.state is ReplicaState.UNHEALTHY
        counters = guard._metrics.snapshot()["counters"]
        assert counters.get("slow_retired_total", 0) >= 1
    finally:
        pool.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# 8. Brownout ladder: shed batch before interactive, recover one rung
# ---------------------------------------------------------------------------

def test_brownout_sheds_batch_before_interactive():
    x = _data()
    policy = GrayFailPolicy(
        abandon=False, hedge=False,
        slow_mad_k=1e9,  # isolate the brownout path from quarantine
        min_slow_samples=2,
        brownout=True, brownout_trip=2, brownout_clear=2,
        brownout_multiplier=2.0, brownout_abs_floor_ms=1.0,
    )
    mm = MultiModelPool(Table({"features": x[:4]}),
                        config=ServingConfig(max_batch_rows=64,
                                             max_queue_rows=512,
                                             max_wait_ms=1.0),
                        name="bo_pool", grayfail=policy)
    mm.add_model("m_int", _scaler(x), slo=INTERACTIVE, n_replicas=1)
    mm.add_model("m_batch", _scaler(x), slo=BATCH, n_replicas=1)
    mm.start()
    guard = mm.grayfail_guard(policy=policy)
    feats = {"features": x[:2]}
    try:
        _seed_rings(mm, ms=5.0, n=10)
        guard.step()  # establishes the ~5ms baseline
        # Pool-WIDE degradation: every replica slow — the MAD test is
        # blind to this (the median moves with the failure).
        for r in mm.replicas:
            r.health._attempt_ms.clear()
        _seed_rings(mm, ms=100.0, n=10)
        actions = []
        for _ in range(3):
            actions += guard.step()
        assert "brownout:1" in actions
        assert mm.brownout_shed_classes == frozenset({"batch"})
        # Batch is refused with the typed error; interactive still serves.
        with pytest.raises(SLOAdmissionError):
            mm.predict("m_batch", feats)
        resp = mm.predict("m_int", feats, timeout_ms=5000.0)
        assert resp.columns["scaled"].shape == (2, x.shape[1])
        assert mm._ledgers["batch"].metrics.snapshot()["counters"].get(
            "brownout_rejections", 0) >= 1
        # Recovery de-escalates one rung and batch is admitted again.
        for r in mm.replicas:
            r.health._attempt_ms.clear()
        _seed_rings(mm, ms=5.0, n=10)
        for _ in range(3):
            actions += guard.step()
        assert "brownout:0" in actions
        assert mm.brownout_shed_classes == frozenset()
        mm.predict("m_batch", feats, timeout_ms=5000.0)
    finally:
        mm.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# 9. SLO admission releases at abandonment, not straggler completion
# ---------------------------------------------------------------------------

def test_slo_admission_released_at_abandonment():
    x = _data()
    policy = GrayFailPolicy(
        attempt_floor_ms=40.0, min_attempt_samples=5, hedge=False,
        deadline_multiplier=4.0, brownout=False,
    )
    mm = MultiModelPool(Table({"features": x[:4]}),
                        config=ServingConfig(max_batch_rows=64,
                                             max_queue_rows=512,
                                             max_wait_ms=1.0),
                        name="slo_pool", grayfail=policy)
    mm.add_model("m", _scaler(x), slo=BATCH, n_replicas=2)
    mm.start()
    try:
        _seed_rings(mm, ms=5.0, n=10)
        ledger = mm._ledgers["batch"]
        with faults.armed(faults.FaultPlan(
            faults.StallDispatch("r0", delay_s=0.6, for_batches=1)
        )):
            t0 = time.monotonic()
            resp = mm.predict("m", {"features": x[:4]}, timeout_ms=5000.0)
            elapsed = time.monotonic() - t0
            # Served by failover while r0's straggler is still sleeping…
            assert elapsed < 0.5
            assert resp.columns["scaled"].shape[0] == 4
            # …and the admission rows are ALREADY released — a stalled
            # replica must not hold a class's share hostage for the
            # straggler's lifetime.
            assert ledger.outstanding_rows == 0
        time.sleep(0.7)  # let the straggler finish + be discarded
        assert ledger.outstanding_rows == 0  # no double-settle underflow
    finally:
        mm.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# 10. Fault specs: round-trip, determinism, fuzz sampler
# ---------------------------------------------------------------------------

def test_grayfail_fault_specs_roundtrip_and_determinism():
    for name in ("StallDispatch", "JitterDispatch", "SlowRamp"):
        assert name in faults.fault_types()
    plan = faults.FaultPlan(
        faults.StallDispatch("r1", at_batch=2, delay_s=0.05, for_batches=3),
        faults.JitterDispatch("r0", p=0.5, delay_s=0.0, seed=7),
        faults.SlowRamp("r2", at_batch=1, step_s=0.01, max_s=0.1),
    )
    clone = faults.plan_from_json(faults.plan_to_json(plan))
    assert [faults.fault_to_spec(f) for f in clone.faults] == \
        [faults.fault_to_spec(f) for f in plan.faults]
    # Jitter draws are deterministic in the committed seed: a JSON repro
    # replays the exact stall pattern.
    j1, j2 = plan.faults[1], clone.faults[1]
    ctx = {"engine": "pool/r0"}
    assert [j1.should_fire(ctx) for _ in range(32)] == \
        [j2.should_fire(ctx) for _ in range(32)]
    # A finite stall window opens at at_batch and closes after
    # for_batches — the rejoin fixture.
    st = faults.StallDispatch("r0", at_batch=2, delay_s=0.0, for_batches=2)
    fired = []
    for _ in range(5):
        hit = st.should_fire({"engine": "p/r0"})
        if hit:
            st.apply({})
        fired.append(hit)
    assert fired == [False, True, True, False, False]


def test_fuzzplan_serving_seam_sampler_is_deterministic():
    plan = faults.FuzzPlan(seed=3, seams=("serving.replica",),
                          budget=4, horizon=8, replicas=4)
    for i in range(4):
        a, b = plan.sample(i), plan.sample(i)
        assert [faults.fault_to_spec(f) for f in a.faults] == \
            [faults.fault_to_spec(f) for f in b.faults]
        for f in a.faults:
            assert f.site == "serving.replica"
            assert f.engine in {"r0", "r1", "r2", "r3"}


# ---------------------------------------------------------------------------
# 11. Chaos acceptance: stall 1 of 4 replicas ~100x mid-traffic
# ---------------------------------------------------------------------------

def test_grayfail_chaos_acceptance():
    """The pinned end-to-end contract: one replica stalls ~100x under
    closed-loop load -> the guard quarantines it autonomously, zero
    requests are lost, zero responses are duplicated/mis-versioned,
    p99 recovers, and the replica rejoins once the stall clears."""
    from flinkml_tpu_torch.recovery.fuzz import serving_grayfail_policy

    x = _data()
    model = _scaler(x)
    expected = _expected(model, x)
    pool = _pool(model, x, n_replicas=4, name="chaos_gf_pool",
                 grayfail=serving_grayfail_policy()).start()
    guard = pool.grayfail_guard(interval_s=0.05).start()
    errors = []
    served = [0]
    stop = threading.Event()

    def probe_p99(n=60):
        lat = []
        for i in range(n):
            sl = slice((i % 50) * 4, (i % 50) * 4 + 4)
            t0 = time.perf_counter()
            resp = pool.predict({"features": x[sl]}, timeout_ms=5000.0)
            lat.append((time.perf_counter() - t0) * 1e3)
            np.testing.assert_array_equal(
                np.asarray(resp.columns["scaled"]), expected[sl]
            )
        lat.sort()
        return lat[min(len(lat) - 1, int(np.ceil(0.99 * len(lat))) - 1)]

    def client(tid):
        rng = np.random.default_rng(tid)
        try:
            while not stop.is_set():
                lo = int(rng.integers(0, x.shape[0] - 4))
                sl = slice(lo, lo + 4)
                resp = pool.predict({"features": x[sl]},
                                    timeout_ms=5000.0)
                np.testing.assert_array_equal(
                    np.asarray(resp.columns["scaled"]), expected[sl]
                )
                served[0] += 1
                time.sleep(0.002)
        except BaseException as e:  # noqa: BLE001 — any client error fails
            errors.append(e)

    try:
        p99_base = probe_p99()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        with faults.armed(faults.FaultPlan(
            faults.StallDispatch("r1", delay_s=0.2)  # ~100x a CPU batch
        )):
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                if pool.replicas[1].health.state is ReplicaState.SLOW:
                    break
                time.sleep(0.05)
            assert pool.replicas[1].health.state is ReplicaState.SLOW, \
                "guard never quarantined the stalled replica"
            served_at_quarantine = served[0]
            time.sleep(0.3)  # pool must keep serving around the stall
            assert served[0] > served_at_quarantine
        # Stall cleared (faults disarmed): canaries must rejoin r1 with
        # no operator intervention.
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if pool.replicas[1].health.state is ReplicaState.HEALTHY:
                break
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]  # zero lost, zero mis-served
        assert pool.replicas[1].health.state is ReplicaState.HEALTHY, \
            "replica never rejoined after the stall cleared"
        counters = guard._metrics.snapshot()["counters"]
        assert counters.get("quarantines_total", 0) >= 1
        assert counters.get("rejoins_total", 0) >= 1
        p99_after = probe_p99()
        assert p99_after <= max(2.0 * p99_base, p99_base + 50.0), (
            f"p99 did not recover: {p99_after:.1f}ms vs baseline "
            f"{p99_base:.1f}ms"
        )
    finally:
        stop.set()
        guard.stop()
        pool.stop(drain=False, timeout=5.0)


# ---------------------------------------------------------------------------
# Held against the JAX package: the same latency samples, the same verdicts
# ---------------------------------------------------------------------------

def _guard_trace(pkg):
    """Drive one package's ``GrayFailGuard`` over a pool of four fake
    replicas through one scripted run of attempt latencies (a stall on r1,
    its canary window recovering, then a pool-wide degradation) on a fake
    clock; return every step's actions, states and brownout set."""
    from tests._torch_serving_common import FakePool

    grayfail = __import__(f"{pkg}.serving.grayfail", fromlist=["x"])
    policy = grayfail.GrayFailPolicy(
        min_slow_samples=8, slow_trip=2, slow_clear=2, slow_abs_floor_ms=10.0,
        canary_interval_s=0.0, canary_min_samples=4,
        quarantine_retire_s=None, brownout=True, brownout_trip=2,
        brownout_clear=2, shed_order=("batch", "best_effort"),
    )
    pool = FakePool(pkg, 4, devices=[0])
    guard = grayfail.GrayFailGuard(pool, policy)
    rng = np.random.default_rng(3)
    phases = (
        [{r: 5.0 for r in "0123"}] * 2
        + [{"0": 5.0, "1": 250.0, "2": 6.0, "3": 5.0}] * 4
        + [{"0": 5.0, "1": 5.0, "2": 6.0, "3": 5.0}] * 4
        + [{r: 90.0 for r in "0123"}] * 6
        + [{r: 5.0 for r in "0123"}] * 8
    )
    trace = []
    for t, lat in enumerate(phases):
        for r in pool.replicas:
            for _ in range(8):
                r.health.record_attempt(
                    lat[r.name[1:]] * float(rng.uniform(0.9, 1.1)))
        trace.append((guard.step(now=float(t)), pool.states(),
                      sorted(pool.brownout_shed_classes)))
    return trace, pool.events


def test_grayfail_verdicts_match_jax():
    """The same attempt-latency samples give the same quarantine, rejoin
    and brownout verdicts, step for step, in both packages."""
    got = _guard_trace("flinkml_tpu_torch")
    want = _guard_trace("flinkml_tpu")
    assert got == want
    actions = [a for step in got[0] for a in step[0]]
    assert "quarantine:r1" in actions and "rejoin:r1" in actions
    assert any(a.startswith("brownout:") for a in actions)


@pytest.mark.parametrize("seed", [7, 11])
def test_fuzzplan_serving_samples_match_jax(seed):
    """``FuzzPlan(seed).sample(i)`` over the serving seam (the serving
    soak's sampler) is JAX's schedule for i < 50."""
    from flinkml_tpu import faults as jax_faults
    from flinkml_tpu_torch.recovery.fuzz import SERVING_REPLICAS

    kw = dict(seams=("serving.replica",), budget=50, horizon=8,
              max_faults=3, replicas=SERVING_REPLICAS)
    got = faults.FuzzPlan(seed, **kw)
    want = jax_faults.FuzzPlan(seed, **kw)
    for i in range(50):
        assert faults.plan_to_json(got.sample(i)) == \
            jax_faults.plan_to_json(want.sample(i)), i


def test_serving_soak_cli_on_the_cpu_green(capsys):
    """``python -m flinkml_tpu_torch.recovery.fuzz --serving --device cpu
    --seed 7 --budget 2`` passes: every schedule's invariants hold."""
    from flinkml_tpu_torch.recovery.fuzz import main

    assert main(["--serving", "--device", "cpu", "--seed", "7",
                 "--budget", "2"]) == 0
    out = capsys.readouterr().out
    assert "2/2 schedules, 0 failed" in out and "FAILED" not in out
