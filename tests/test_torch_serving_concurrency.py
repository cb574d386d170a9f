"""Serving engine under concurrency: parity, no new programs, liveness,
overload, in the port (``flinkml_tpu_torch.serving``), on the CPU.

Mirrors the JAX package's ``tests/test_serving_concurrency.py`` name for
name; the dispatch traces are audited by the JAX package's analyzer. The
acceptance contract of the serving subsystem:

  1. ≥8 concurrent client threads get responses bitwise-identical to a
     single-request direct ``transform`` — micro-batch packing, bucket
     padding, and per-request slicing are invisible to clients.
  2. Steady state builds nothing: after the engine's load-time warmup,
     the fused programs and kernel builds stay flat no matter how
     requests are packed (``program_counts``).
  3. Serving coexists with a concurrently running ``train_kmeans_stream``
     over overlapping devices — no deadlock, and the recorded dispatch
     trace passes the analyzer's FML302 collective-interleaving check.
  4. Saturation degrades gracefully: a full bounded queue either sheds to
     the per-stage path (correct results, ``shed=True``) or rejects with the
     typed overload error; deadlines produce ServingTimeoutError.
  5. Hot swap mid-traffic: every response carries the version that served
     it, and responses verify bitwise against THAT version's model — no
     dropped and no mis-versioned responses across the swap.
  6. Pool rolling swaps under racing registry writes: a rollback racing a
     publish across a following ReplicaPool converges EVERY replica to
     the registry's final CURRENT pointer, with zero mis-versioned
     responses throughout.
"""

import threading
import time

import numpy as np
import pytest

from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.api import AlgoOperator
from flinkml_tpu_torch.models.logistic_regression import LogisticRegression
from flinkml_tpu_torch.models.scalers import MinMaxScaler, StandardScaler
from flinkml_tpu_torch.pipeline import PipelineModel
from flinkml_tpu_torch.serving import (
    ModelRegistry,
    ServingConfig,
    ServingEngine,
    ServingOverloadError,
    ServingTimeoutError,
)
from flinkml_tpu_torch.table import Table
from tests._torch_serving_common import (  # noqa: F401
    _on_cpu,
    _time_limit,
    on_cpu,
    program_counts,
)



def _data(n=200, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    return x, y


def _three_stage_chain(x, y):
    """features -> scaled -> squashed -> prediction, all kernel-capable
    (fuses into one program per bucket)."""
    train = Table({"features": x, "label": y})
    sc = (
        StandardScaler()
        .set(StandardScaler.INPUT_COL, "features")
        .set(StandardScaler.OUTPUT_COL, "scaled")
        .fit(train)
    )
    (t2,) = sc.transform(train)
    mm = (
        MinMaxScaler()
        .set(MinMaxScaler.INPUT_COL, "scaled")
        .set(MinMaxScaler.OUTPUT_COL, "squashed")
        .fit(t2)
    )
    (t3,) = mm.transform(t2)
    lr = (
        LogisticRegression()
        .set(LogisticRegression.FEATURES_COL, "squashed")
        .set(LogisticRegression.LABEL_COL, "label")
        .set_max_iter(3)
        .fit(t3)
    )
    return PipelineModel([sc, mm, lr])


def _engine(source, x, name="default", **cfg):
    config = ServingConfig(**{
        "max_batch_rows": 64,
        "max_queue_rows": 512,
        "warmup_row_counts": None,  # every bucket up to max_batch_rows
        **cfg,
    })
    return ServingEngine(
        source, Table({"features": x[:4]}), config,
        output_cols=("prediction", "rawPrediction"),
        name=name,
    )


def test_eight_thread_parity_zero_retrace():
    """8 client threads, mixed row counts, vs single-request transform —
    bitwise. Steady state builds nothing: the fused programs and the
    kernel builds stay flat from the end of start() (the JAX package's
    no-retrace guard)."""
    x, y = _data()
    pm = _three_stage_chain(x, y)
    pipeline_fusion.reset_cache()
    # A dedicated metrics-group name: the process-wide registry
    # accumulates across tests, and this test asserts EXACT counters.
    eng = _engine(pm, x, name="parity8").start()
    after_warmup = program_counts()
    errors = []

    def client(tid):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(25):
                rows = int(rng.integers(1, 13))
                lo = int(rng.integers(0, x.shape[0] - rows))
                sl = x[lo:lo + rows]
                resp = eng.predict({"features": sl})
                (ref,) = pm.transform(Table({"features": sl}))
                for c in ("prediction", "rawPrediction"):
                    ev, av = ref.column(c), resp.column(c)
                    assert ev.dtype == av.dtype
                    np.testing.assert_array_equal(ev, av)
        except BaseException as e:  # noqa: BLE001 — surface to the main thread
            errors.append(e)

    try:
        threads = [
            threading.Thread(target=on_cpu(client), args=(i,)) for i in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "client threads hung"
        assert not errors, errors[:3]
        # Zero steady-state retraces: the reference transforms above run
        # at row counts inside warmed buckets, so even they compile
        # nothing new.
        assert program_counts() == after_warmup
        stats = eng.stats()
        assert stats["counters"]["requests"] == 200
        assert stats["counters"]["rows"] == stats["counters"]["batch_rows"]
    finally:
        eng.stop()


def test_serving_coexists_with_kmeans_stream():
    """Liveness: 4 serving client threads while train_kmeans_stream runs
    its whole Lloyd loop (holding the mesh lock) on overlapping devices.
    Single-device serving programs cannot interleave the multi-device
    collective rendezvous, so both must make progress; the recorded
    dispatch trace must pass the analyzer's FML302 check."""
    # The JAX package's trace analyzer (FML302) audits the port's trace.
    from flinkml_tpu.analysis.collectives import (
        DispatchEvent,
        check_dispatch_trace,
    )
    from flinkml_tpu_torch.models.kmeans import train_kmeans_stream
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.parallel import dispatch as _dispatch

    x, y = _data(n=240)
    pm = _three_stage_chain(x, y)
    eng = _engine(pm, x).start()
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(512, 4)).astype(np.float32)
    batches = [{"x": xs[i::4]} for i in range(4)]
    mesh = DeviceMesh()

    events = []
    _dispatch.add_dispatch_observer(events.append)
    stop = threading.Event()
    errors = []
    served = [0]

    def client(tid):
        try:
            while not stop.is_set():
                rows = 1 + (tid % 4)
                resp = eng.predict({"features": x[tid * 3:tid * 3 + rows]})
                assert resp.columns["prediction"].shape == (rows,)
                served[0] += 1
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    trainer_out = []

    def trainer():
        trainer_out.append(train_kmeans_stream(
            batches, k=3, mesh=mesh, max_iter=6, seed=0,
        ))

    try:
        clients = [
            threading.Thread(target=client, args=(i,)) for i in range(4)
        ]
        tt = threading.Thread(target=on_cpu(trainer))
        for t in clients:
            t.start()
        tt.start()
        tt.join(timeout=300)
        assert not tt.is_alive(), "training deadlocked against serving"
        time.sleep(0.2)
        stop.set()
        for t in clients:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in clients), "serving starved"
        assert not errors, errors[:3]
        assert trainer_out and trainer_out[0].shape == (3, 4)
        assert served[0] > 0
        # Analyzer audit of the real interleaving we just produced.
        trace = [
            DispatchEvent(
                thread=e["thread"], program=e["program"],
                devices=tuple(e["devices"]),
                collectives=tuple(e["collectives"]),
                locks=tuple(e["locks"]),
            )
            for e in events
        ]
        assert "serving.batch" in {e.program for e in trace}
        assert check_dispatch_trace(trace) == []
    finally:
        _dispatch.remove_dispatch_observer(events.append)
        eng.stop()


class _GatedStage(AlgoOperator):
    """Host stage that BLOCKS the dispatcher thread until released —
    deterministic queue saturation (no sleep races). Caller threads (the
    shed path, reference transforms) pass through untouched."""

    def __init__(self):
        super().__init__()
        self.entered = threading.Event()  # dispatcher is inside transform
        self.release = threading.Event()

    def transform(self, *inputs):
        if threading.current_thread().name.startswith("serving-"):
            self.entered.set()
            assert self.release.wait(timeout=120)
        return inputs


def _gated_engine(x, y, **cfg):
    pm = _three_stage_chain(x, y)
    gate = _GatedStage()
    gated = PipelineModel([gate, *pm.stages])
    eng = _engine(
        gated, x, max_batch_rows=8, max_queue_rows=8,
        warmup_row_counts=(1,), **cfg,
    )
    return eng, gate, gated


def _background_predict(eng, features):
    """Fire-and-forget client; shutdown errors are expected and muted."""

    def run():
        try:
            eng.predict(features)
        except Exception:  # noqa: BLE001 — rejected at shutdown, by design
            pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _saturate(eng, gate, x):
    """Park the dispatcher inside the gate, then fill the bounded queue
    to exactly max_queue_rows with a background request."""
    t1 = _background_predict(eng, {"features": x[:1]})
    assert gate.entered.wait(timeout=60)  # dispatcher blocked in-flight
    t2 = _background_predict(eng, {"features": x[:8]})
    deadline = time.monotonic() + 60
    while eng.stats()["queued_rows"] < 8:  # the 8-row filler is queued
        assert time.monotonic() < deadline
        time.sleep(0.005)
    return t1, t2


def test_overload_rejects_with_typed_error():
    x, y = _data()
    eng, gate, _ = _gated_engine(x, y, shed_on_overload=False)
    eng.start()
    try:
        _saturate(eng, gate, x)
        with pytest.raises(ServingOverloadError):
            eng.predict({"features": x[:1]})
        assert eng.stats()["counters"]["rejected"] >= 1
    finally:
        gate.release.set()
        eng.stop(drain=False)


def test_overload_sheds_to_host_path_with_parity():
    x, y = _data()
    eng, gate, gated = _gated_engine(x, y, shed_on_overload=True)
    eng.start()
    try:
        _saturate(eng, gate, x)
        resp = eng.predict({"features": x[:5]})
        assert resp.shed
        (ref,) = gated.transform(Table({"features": x[:5]}))
        np.testing.assert_array_equal(
            ref.column("prediction"), resp.column("prediction")
        )
        assert eng.stats()["counters"]["shed_requests"] >= 1
    finally:
        gate.release.set()
        eng.stop(drain=False)


def test_deadline_expiry_raises_timeout():
    x, y = _data()
    eng, gate, _ = _gated_engine(x, y, shed_on_overload=False)
    eng.start()
    try:
        # Park the dispatcher; the next request cannot be dispatched and
        # must fail by deadline — whether expired in-queue or while
        # waiting on the in-flight batch.
        _background_predict(eng, {"features": x[:1]})
        assert gate.entered.wait(timeout=60)
        with pytest.raises(ServingTimeoutError):
            eng.predict({"features": x[:1]}, timeout_ms=20.0)
        assert eng.stats()["counters"]["timeouts"] >= 1
    finally:
        gate.release.set()
        eng.stop(drain=False)


def test_hot_swap_mid_traffic_no_misversioned_responses(tmp_path):
    """Swap under load: every response verifies bitwise against the model
    of the version it claims, and nothing is dropped."""
    x, y = _data()
    pm1 = _three_stage_chain(x, y)
    pm2 = _three_stage_chain(x, -y + 1)
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(pm1)
    models = {1: pm1, 2: pm2}
    eng = _engine(reg, x).start()
    errors = []
    versions_seen = set()
    done = []  # one append per answered request (append is atomic)
    swapped = threading.Event()

    def client(tid):
        rng = np.random.default_rng(tid)

        def one_request():
            rows = int(rng.integers(1, 9))
            lo = int(rng.integers(0, x.shape[0] - rows))
            sl = x[lo:lo + rows]
            resp = eng.predict({"features": sl})
            versions_seen.add(resp.version)
            ref_model = models[resp.version]
            (ref,) = ref_model.transform(Table({"features": sl}))
            np.testing.assert_array_equal(
                ref.column("prediction"), resp.column("prediction")
            )
            done.append(1)

        try:
            # ≥30 requests each, then keep the traffic flowing until the
            # swap has landed — a fixed pre-swap sleep lost the race on
            # a warm box (all 180 requests finished before the swap).
            n = 0
            while n < 30 or (not swapped.is_set() and n < 3000):
                one_request()
                n += 1
            one_request()  # issued after swap_to returned: version 2
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    try:
        threads = [
            threading.Thread(target=on_cpu(client), args=(i,)) for i in range(6)
        ]
        for t in threads:
            t.start()
        while len(done) < 30 and not errors:  # clients warm and mid-flight
            time.sleep(0.005)
        reg.publish(pm2)
        eng.swap_to(2)
        swapped.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert len(done) >= 186  # zero dropped: every request answered
        assert versions_seen == {1, 2}
    finally:
        eng.stop()


def test_pool_rollback_races_publish_converges(tmp_path):
    """A rollback racing a publish across a following 3-replica pool:
    whatever order the registry commits them, every replica must converge
    to the FINAL CURRENT pointer (the registry serializes listener
    deliveries and re-reads the pointer per delivery; the pool's rolling
    swap re-reads it per replica), and every response served throughout
    must verify bitwise against the model of the version it claims."""
    from flinkml_tpu_torch.serving import ReplicaPool

    x, y = _data()
    pm1 = _three_stage_chain(x, y)
    pm2 = _three_stage_chain(x, -y + 1)
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(pm1)
    models = {1: pm1, 2: pm2}
    pool = ReplicaPool(
        reg, Table({"features": x[:4]}),
        config=ServingConfig(max_batch_rows=64, max_queue_rows=512,
                             max_wait_ms=1.0),
        n_replicas=3, output_cols=("prediction",), name="race_pool",
    ).start()
    pool.follow_registry()
    errors = []
    versions_seen = set()
    done = []  # one append per answered request (append is atomic)
    stop = threading.Event()

    def client(tid):
        rng = np.random.default_rng(tid)
        try:
            while not stop.is_set():
                rows = int(rng.integers(1, 9))
                lo = int(rng.integers(0, x.shape[0] - rows))
                sl = x[lo:lo + rows]
                resp = pool.predict({"features": sl})
                versions_seen.add(resp.version)
                (ref,) = models[resp.version].transform(
                    Table({"features": sl})
                )
                np.testing.assert_array_equal(
                    ref.column("prediction"), resp.column("prediction")
                )
                done.append(1)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def publisher():
        reg.publish(pm2)

    def rollbacker():
        # Spin until v2 exists, then roll back — racing the publish's
        # listener delivery (and the pool's roll) as closely as possible.
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if 2 in reg.versions():
                reg.rollback(1)
                return
            time.sleep(0.0005)

    try:
        clients = [
            threading.Thread(target=on_cpu(client), args=(i,)) for i in range(4)
        ]
        for t in clients:
            t.start()
        time.sleep(0.2)
        tp = threading.Thread(target=publisher)
        tr = threading.Thread(target=rollbacker)
        tp.start()
        tr.start()
        tp.join(timeout=120)
        tr.join(timeout=120)
        assert not tp.is_alive() and not tr.is_alive()
        time.sleep(0.3)  # let the last (serialized) delivery finish
        stop.set()
        for t in clients:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in clients)
        assert not errors, errors[:3]
        final = reg.current_version()
        assert final == 1  # the rollback ran after the publish committed
        assert pool.versions() == {"r0": final, "r1": final, "r2": final}, (
            "replicas did not converge to the registry pointer"
        )
        assert done  # at least one request answered during the race
        assert versions_seen <= {1, 2}
        assert pool.predict({"features": x[:2]}).version == final
    finally:
        pool.stop()
