"""Serving subsystem units in the port (``flinkml_tpu_torch.serving``), on
the CPU: registry, batcher, engine, publisher.

The first part mirrors the JAX package's ``tests/test_serving.py`` name
for name; "zero retraces" reads as "no new program": the fused programs
and the kernel builds stay flat from the end of ``start()``. The contracts
under test:

  1. ModelRegistry: monotone versions, atomic CURRENT pointer,
     publish/get/rollback, listener notification, and fingerprint-verified
     loads (save → tamper → load raises ModelIntegrityError).
  2. AdaptiveMicroBatcher: coalescing up to the bucket / max-wait window,
     FIFO whole-request batches, bounded admission, deadline expiry.
  3. ServingEngine: responses bitwise-equal to direct transform, version
     tagging, schema validation, hot swap (old in-flight batches finish on
     the old version), warmup builds, stats exposition.
  4. SnapshotPublisher: mid-stream publication cadence from iterate()'s
     unbounded mode and from train_kmeans_stream's listener hook.

The second part holds the port against the JAX package on the same numpy
inputs (engine and pool responses against the JAX stages' per-stage
transforms of a JAX-fitted model carried across through its saved files;
a JAX registry directory served by the port and a port version loaded by
JAX; batch compositions; health transitions; ``estimate_serving_bytes``),
and the third mirrors the serving cases of the JAX package's other test
files (non-finite refusal, ``DropPublish``, the precision tiers, the
memory gate, a preemption watchdog draining a real engine). Every test
runs under ``use_device("cpu")``; the engine's threads carry that device
themselves.
"""
import threading
import time

import numpy as np
import pytest

from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.io import read_write
from flinkml_tpu_torch.models.kmeans import KMeansModel
from flinkml_tpu_torch.models.logistic_regression import LogisticRegression
from flinkml_tpu_torch.models.scalers import StandardScaler
from flinkml_tpu_torch.pipeline import PipelineModel
from flinkml_tpu_torch.serving import (
    AdaptiveMicroBatcher,
    EngineStoppedError,
    ModelIntegrityError,
    ModelRegistry,
    ModelVersionNotFoundError,
    RegistryError,
    ServingConfig,
    ServingEngine,
    ServingRequest,
    ServingSchemaError,
    SnapshotPublisher,
)
from flinkml_tpu_torch.table import Table
from tests._torch_serving_common import (  # noqa: F401
    _on_cpu,
    _time_limit,
    on_cpu,
    program_counts,
)


def _data(n=120, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    return x, y


def _fitted_pipeline(x, y):
    train = Table({"features": x, "label": y})
    sc = (
        StandardScaler()
        .set(StandardScaler.INPUT_COL, "features")
        .set(StandardScaler.OUTPUT_COL, "scaled")
        .fit(train)
    )
    (t2,) = sc.transform(train)
    lr = (
        LogisticRegression()
        .set(LogisticRegression.FEATURES_COL, "scaled")
        .set(LogisticRegression.LABEL_COL, "label")
        .set_max_iter(3)
        .fit(t2)
    )
    return PipelineModel([sc, lr])


@pytest.fixture
def pipeline_and_data():
    x, y = _data()
    return _fitted_pipeline(x, y), x


def _engine(source, x, **cfg):
    config = ServingConfig(**{
        "max_batch_rows": 64,
        "max_queue_rows": 256,
        "warmup_row_counts": (1, 64),
        **cfg,
    })
    return ServingEngine(
        source, Table({"features": x[:4]}), config,
        output_cols=("prediction", "rawPrediction"),
    )


# ---------------------------------------------------------------------------
# 1. ModelRegistry
# ---------------------------------------------------------------------------

def test_registry_publish_get_rollback(tmp_path, pipeline_and_data):
    pm, x = pipeline_and_data
    reg = ModelRegistry(str(tmp_path / "reg"))
    assert reg.current_version() is None
    assert reg.versions() == []
    with pytest.raises(ModelVersionNotFoundError):
        reg.get()

    v1 = reg.publish(pm)
    assert (v1, reg.current_version(), reg.versions()) == (1, 1, [1])
    v2 = reg.publish(pm)
    assert (v2, reg.current_version(), reg.versions()) == (2, 2, [1, 2])

    got_v, loaded = reg.get()
    assert got_v == 2
    t = Table({"features": x[:7]})
    np.testing.assert_array_equal(
        pm.transform(t)[0].column("prediction"),
        loaded.transform(t)[0].column("prediction"),
    )

    assert reg.rollback(1) == 1
    assert reg.current_version() == 1
    assert reg.versions() == [1, 2]  # rollback deletes nothing
    with pytest.raises(ModelVersionNotFoundError):
        reg.rollback(99)
    with pytest.raises(RegistryError):
        reg.publish(pm, version=2)  # explicit collision


def test_registry_notifies_listeners(tmp_path, pipeline_and_data):
    pm, _ = pipeline_and_data
    reg = ModelRegistry(str(tmp_path / "reg"))
    seen = []
    reg.add_listener(seen.append)
    reg.publish(pm)
    reg.publish(pm)
    reg.rollback(1)
    assert seen == [1, 2, 1]
    reg.remove_listener(seen.append)
    reg.publish(pm)
    assert seen == [1, 2, 1]


def test_registry_listener_exception_does_not_break_publish(
    tmp_path, pipeline_and_data
):
    """A failing follower (e.g. an engine whose swap raises) must not
    unwind into the publishing/training thread: the publish is already
    committed; the failure surfaces as a warning + counter, and every
    other listener still fires."""
    pm, _ = pipeline_and_data
    reg = ModelRegistry(str(tmp_path / "reg"))
    seen = []

    def bad(version):
        raise RuntimeError("boom")

    reg.add_listener(bad)
    reg.add_listener(seen.append)
    with pytest.warns(RuntimeWarning, match="boom"):
        assert reg.publish(pm) == 1
    assert seen == [1]
    assert reg.current_version() == 1


def test_registry_tampered_model_fails_load(tmp_path, pipeline_and_data):
    """save → tamper → load: a bit flip in any stage's persisted model
    arrays must surface as ModelIntegrityError, not silent corruption."""
    pm, _ = pipeline_and_data
    reg = ModelRegistry(str(tmp_path / "reg"))
    v = reg.publish(pm)
    # Rewrite stage 0's (the scaler's) model data with altered values.
    stage_dir = read_write.stage_path(reg.path_of(v), 0)
    arrays = read_write.load_model_arrays(stage_dir)
    arrays["mean"] = arrays["mean"] + 1.0
    import os
    os.remove(os.path.join(stage_dir, read_write.MODEL_DATA_DIR, "model.npz"))
    read_write.save_model_arrays(stage_dir, arrays)
    with pytest.raises(ModelIntegrityError):
        reg.get(v)


# ---------------------------------------------------------------------------
# 2. AdaptiveMicroBatcher
# ---------------------------------------------------------------------------

def _req(rows, deadline=None):
    return ServingRequest(
        columns={"x": np.zeros((rows, 2))},
        rows=rows,
        enqueued_at=time.monotonic(),
        deadline=deadline,
    )


def test_batcher_coalesces_within_window():
    b = AdaptiveMicroBatcher(max_batch_rows=64, max_wait_s=0.2,
                             max_queue_rows=256)
    for _ in range(3):
        assert b.offer(_req(2))
    batch, expired = b.next_batch(poll_s=0.01)
    # 6 rows < bucket 8: the window waits max_wait for company, then
    # dispatches all three together.
    assert [r.rows for r in batch] == [2, 2, 2]
    assert expired == []


def test_batcher_dispatches_early_when_bucket_fills():
    b = AdaptiveMicroBatcher(max_batch_rows=64, max_wait_s=30.0,
                             max_queue_rows=256)
    b.offer(_req(5))
    b.offer(_req(3))  # 8 rows == bucket(8): occupancy 1.0
    t0 = time.monotonic()
    batch, _ = b.next_batch(poll_s=0.01)
    assert [r.rows for r in batch] == [5, 3]
    assert time.monotonic() - t0 < 5.0  # did NOT wait the 30s window


def test_batcher_never_splits_and_respects_max_rows():
    b = AdaptiveMicroBatcher(max_batch_rows=8, max_wait_s=0.0,
                             max_queue_rows=64)
    b.offer(_req(5))
    b.offer(_req(5))  # would overflow max_batch_rows together
    batch, _ = b.next_batch()
    assert [r.rows for r in batch] == [5]
    batch, _ = b.next_batch()
    assert [r.rows for r in batch] == [5]


def test_batcher_bounded_admission_and_stop():
    b = AdaptiveMicroBatcher(max_batch_rows=8, max_wait_s=0.0,
                             max_queue_rows=8)
    assert b.offer(_req(8))
    assert not b.offer(_req(1))  # full
    b.stop()
    with pytest.raises(EngineStoppedError):
        b.offer(_req(1))
    assert [r.rows for r in b.drain_pending()] == [8]
    assert b.queue_depth == 0


def test_batcher_window_closes_before_queued_deadline():
    """A lone request whose deadline falls INSIDE the max-wait window must
    be dispatched in time, not expired by the very wait that was supposed
    to batch it."""
    b = AdaptiveMicroBatcher(max_batch_rows=64, max_wait_s=5.0,
                             max_queue_rows=256)
    b.offer(_req(2, deadline=time.monotonic() + 0.05))
    t0 = time.monotonic()
    batch, expired = b.next_batch(poll_s=0.01)
    assert [r.rows for r in batch] == [2]
    assert expired == []
    assert time.monotonic() - t0 < 2.0  # closed at the deadline, not 5s


def test_batcher_late_wakeup_dispatches_the_window_deadline():
    """A declared difference from the JAX batcher (ROADMAP Queue 3): when
    the dispatcher wakes later than the 5 ms margin at a window that a
    queued deadline closed, the request whose deadline closed it is
    dispatched in that window, not expired by the late wake-up; any other
    request whose deadline passed meanwhile still expires."""
    b = AdaptiveMicroBatcher(max_batch_rows=64, max_wait_s=5.0,
                             max_queue_rows=256)
    wait = b._cond.wait

    def late_wait(timeout=None):
        wait(timeout)
        time.sleep(0.06)  # the wake-up lands well past both deadlines
        return False

    b._cond.wait = late_wait
    deadline = time.monotonic() + 0.05
    b.offer(_req(2, deadline=deadline))
    other = _req(3, deadline=deadline + 0.002)
    b.offer(other)
    batch, expired = b.next_batch(poll_s=0.01)
    assert time.monotonic() > deadline + 0.002
    assert [r.rows for r in batch] == [2] and expired == [other]


def test_batcher_expires_overdue_requests():
    b = AdaptiveMicroBatcher(max_batch_rows=8, max_wait_s=0.0,
                             max_queue_rows=64)
    b.offer(_req(2, deadline=time.monotonic() - 1.0))  # already expired
    b.offer(_req(3))
    batch, expired = b.next_batch(poll_s=0.01)
    assert [r.rows for r in expired] == [2]
    assert [r.rows for r in batch] == [3]


# ---------------------------------------------------------------------------
# 3. ServingEngine
# ---------------------------------------------------------------------------

def test_engine_parity_and_response_shape(pipeline_and_data):
    pm, x = pipeline_and_data
    eng = _engine(pm, x).start()
    try:
        (ref,) = pm.transform(Table({"features": x[:9]}))
        resp = eng.predict({"features": x[:9]})
        assert resp.version is None  # fixed-model engine: unversioned
        for c in ("prediction", "rawPrediction"):
            np.testing.assert_array_equal(ref.column(c), resp.column(c))
        # Single row with the leading axis omitted.
        one = eng.predict({"features": x[0]})
        np.testing.assert_array_equal(
            ref.column("prediction")[:1], one.column("prediction")
        )
        assert one.latency_ms >= 0.0
    finally:
        eng.stop()


def test_engine_schema_validation(pipeline_and_data):
    pm, x = pipeline_and_data
    eng = _engine(pm, x).start()
    try:
        with pytest.raises(ServingSchemaError):
            eng.predict({"wrong": x[:2]})
        with pytest.raises(ServingSchemaError):
            eng.predict({"features": x[:2, :3]})  # wrong trailing dim
        with pytest.raises(ServingSchemaError):
            eng.predict({"features": x[:0]})  # empty
        with pytest.raises(ServingSchemaError):
            eng.predict({"features": np.zeros((65, x.shape[1]))})  # > max
    finally:
        eng.stop()


def test_engine_serves_deadline_inside_batch_window(pipeline_and_data):
    """Idle server, long batching window, short request deadline: the
    window must close early and serve the request before it expires."""
    pm, x = pipeline_and_data
    eng = _engine(pm, x, max_wait_ms=5000.0).start()
    try:
        resp = eng.predict({"features": x[:2]}, timeout_ms=500)
        assert resp.columns["prediction"].shape == (2,)
    finally:
        eng.stop()


def test_engine_rejects_undiscoverable_output_cols():
    """In-place overwrite (OUTPUT_COL == INPUT_COL) defeats added-column
    discovery; the engine must fail the load, not serve empty responses."""
    x, y = _data()
    train = Table({"features": x})
    sc = (
        StandardScaler()
        .set(StandardScaler.INPUT_COL, "features")
        .set(StandardScaler.OUTPUT_COL, "features")
        .fit(train)
    )
    eng = ServingEngine(
        sc, Table({"features": x[:4]}),
        ServingConfig(max_batch_rows=64, warmup_row_counts=(1,)),
    )
    with pytest.raises(ServingSchemaError, match="output columns"):
        eng.start()


def test_engine_follow_registry_catches_up(tmp_path):
    """A publish landing before follow_registry() is delivered by the
    registration-time catch-up swap, not lost."""
    x, y = _data()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(_fitted_pipeline(x, y))
    eng = _engine(reg, x).start()          # loads v1
    try:
        reg.publish(_fitted_pipeline(x, -y + 1))  # lands unobserved
        assert eng.active_version == 1
        eng.follow_registry()              # catch-up swap to v2
        assert eng.active_version == 2
    finally:
        eng.stop()


def test_engine_requires_start(pipeline_and_data):
    pm, x = pipeline_and_data
    eng = _engine(pm, x)
    with pytest.raises(EngineStoppedError):
        eng.predict({"features": x[:2]})


def test_engine_warmup_precompiles_buckets(pipeline_and_data):
    """After start(), serving row counts within warmed buckets builds
    nothing: the engine paid every build at load."""
    pm, x = pipeline_and_data
    pipeline_fusion.reset_cache()
    eng = _engine(pm, x, warmup_row_counts=None).start()  # all buckets
    try:
        warmed = program_counts()
        assert warmed[0] > 0
        for rows in (1, 3, 8, 9, 17, 33, 64):
            eng.predict({"features": np.resize(x, (rows, x.shape[1]))})
        assert program_counts() == warmed
    finally:
        eng.stop()


def test_engine_hot_swap_routes_new_requests(tmp_path):
    x, y = _data()
    pm1 = _fitted_pipeline(x, y)
    pm2 = _fitted_pipeline(x, -y + 1)  # different fit, same shapes
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(pm1)
    eng = _engine(reg, x).start()
    try:
        r1 = eng.predict({"features": x[:5]})
        assert r1.version == 1
        v2 = reg.publish(pm2)
        assert eng.active_version == 1  # not following: explicit swap
        assert eng.swap_to() == v2
        r2 = eng.predict({"features": x[:5]})
        assert r2.version == 2
        np.testing.assert_array_equal(
            pm2.transform(Table({"features": x[:5]}))[0].column("prediction"),
            r2.column("prediction"),
        )
    finally:
        eng.stop()


def test_engine_follow_registry_auto_swaps(tmp_path):
    x, y = _data()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(_fitted_pipeline(x, y))
    eng = _engine(reg, x).start().follow_registry()
    try:
        reg.publish(_fitted_pipeline(x, -y + 1))
        assert eng.active_version == 2
        assert eng.predict({"features": x[:3]}).version == 2
        reg.rollback(1)
        assert eng.active_version == 1
        # Following survives a stop()/start() cycle.
        eng.stop()
        eng.start()
        reg.rollback(2)
        assert eng.active_version == 2
    finally:
        eng.stop()


def test_engine_stop_drains_and_rejects(pipeline_and_data):
    pm, x = pipeline_and_data
    eng = _engine(pm, x).start()
    eng.stop()
    with pytest.raises(EngineStoppedError):
        eng.predict({"features": x[:2]})
    # Restartable: a stopped engine can come back with a fresh queue.
    eng.start()
    try:
        assert eng.predict({"features": x[:2]}).columns
    finally:
        eng.stop()


def test_engine_stats_and_exposition(pipeline_and_data):
    pm, x = pipeline_and_data
    eng = ServingEngine(
        pm, Table({"features": x[:4]}),
        ServingConfig(max_batch_rows=64, warmup_row_counts=(1,)),
        output_cols=("prediction",), name="statstest",
    ).start()
    try:
        eng.predict({"features": x[:6]})
        stats = eng.stats()
        assert stats["counters"]["requests"] >= 1
        assert stats["counters"]["batches"] >= 1
        assert "p50_ms" in stats["gauges"]
        text = eng.stats_text()
        assert "# TYPE flinkml_requests counter" in text
        assert 'flinkml_requests{group="serving.statstest"}' in text
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# 4. SnapshotPublisher
# ---------------------------------------------------------------------------

def _kmeans_model(centroids):
    m = KMeansModel().set(KMeansModel.FEATURES_COL, "features")
    m.set_model_data(
        Table({"centroids": np.asarray(centroids, np.float64)[None]})
    )
    return m


def test_publisher_cadence_in_unbounded_iterate(tmp_path):
    from flinkml_tpu_torch.iteration import Iterations

    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = SnapshotPublisher(
        reg, _kmeans_model, every_n_epochs=2, publish_on_terminate=True
    )

    def step(state, batch, epoch):
        return state + batch, None

    stream = [np.ones((3, 2)) * i for i in range(5)]  # 5 epochs
    Iterations.iterate_unbounded_streams(
        step, np.zeros((3, 2)), stream, listeners=[pub]
    )
    # Epochs 1 and 3 publish on cadence; epoch 4 (final) on terminate.
    assert [e for e, _ in pub.published] == [1, 3, 4]
    assert reg.versions() == [1, 2, 3]
    assert reg.current_version() == 3


def test_publisher_skips_duplicate_terminal_snapshot(tmp_path):
    from flinkml_tpu_torch.iteration import Iterations

    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = SnapshotPublisher(reg, _kmeans_model, every_n_epochs=2)

    def step(state, batch, epoch):
        return state + batch, None

    stream = [np.ones((2, 2))] * 4  # 4 epochs: epoch 3 publishes on cadence
    Iterations.iterate_unbounded_streams(
        step, np.zeros((2, 2)), stream, listeners=[pub]
    )
    assert [e for e, _ in pub.published] == [1, 3]  # no duplicate terminal


def test_publisher_restart_then_republish_is_idempotent(tmp_path):
    """A trainer that crashes after publishing epoch E
    and resumes from the epoch-E checkpoint re-reaches the same publish
    point — the registry must NOT grow a duplicate version (dedupe keyed
    on epoch + state fingerprint, committed atomically with the
    version)."""
    from flinkml_tpu_torch.iteration import Iterations

    reg = ModelRegistry(str(tmp_path / "reg"))

    def step(state, batch, epoch):
        return state + batch, None

    stream = [np.ones((3, 2)) * i for i in range(5)]
    pub = SnapshotPublisher(reg, _kmeans_model, every_n_epochs=2,
                            publish_on_terminate=False)
    Iterations.iterate_unbounded_streams(
        step, np.zeros((3, 2)), stream, listeners=[pub]
    )
    assert [e for e, _ in pub.published] == [1, 3]
    assert reg.versions() == [1, 2]

    # "Restart": a FRESH publisher (and fresh registry handle, as a new
    # process would construct) replays the run from the start — every
    # publish re-reaches an (epoch, state) the registry already holds.
    reg2 = ModelRegistry(str(tmp_path / "reg"))
    pub2 = SnapshotPublisher(reg2, _kmeans_model, every_n_epochs=2,
                             publish_on_terminate=False)
    Iterations.iterate_unbounded_streams(
        step, np.zeros((3, 2)), stream, listeners=[pub2]
    )
    # The replayed publishes resolved to the EXISTING versions.
    assert [v for _, v in pub2.published] == [1, 2]
    assert reg2.versions() == [1, 2]  # no growth
    assert reg2.current_version() == 2

    # A genuinely new state still publishes a new version.
    pub3 = SnapshotPublisher(reg2, _kmeans_model, every_n_epochs=2,
                             publish_on_terminate=False)
    Iterations.iterate_unbounded_streams(
        step, np.ones((3, 2)) * 100, stream, listeners=[pub3]
    )
    assert reg2.versions() == [1, 2, 3, 4]


def test_publisher_dedupe_hit_still_swaps_engine(tmp_path):
    """An attached engine may be serving a pre-restart version: a publish
    that resolves via dedupe must still hot-swap the engine to the
    resolved version."""
    from flinkml_tpu_torch.iteration import Iterations

    class SwapRecorder:
        def __init__(self):
            self.swaps = []

        def swap_to(self, version):
            self.swaps.append(version)

    reg = ModelRegistry(str(tmp_path / "reg"))

    def step(state, batch, epoch):
        return state + batch, None

    stream = [np.ones((3, 2))] * 4  # publishes at epochs 1 and 3
    pub = SnapshotPublisher(reg, _kmeans_model, every_n_epochs=2,
                            publish_on_terminate=False)
    Iterations.iterate_unbounded_streams(
        step, np.zeros((3, 2)), stream, listeners=[pub]
    )
    assert reg.versions() == [1, 2]

    eng = SwapRecorder()
    pub2 = SnapshotPublisher(reg, _kmeans_model, every_n_epochs=2,
                             publish_on_terminate=False, engine=eng)
    Iterations.iterate_unbounded_streams(
        step, np.zeros((3, 2)), stream, listeners=[pub2]
    )
    assert reg.versions() == [1, 2]  # all publishes resolved via dedupe
    assert eng.swaps == [1, 2]       # ...and the engine still swapped


def test_publisher_from_kmeans_stream(tmp_path):
    """The train_*_stream hook: a live Lloyd loop emits registry versions
    mid-stream, and the published centroids match the run's trajectory."""
    from flinkml_tpu_torch.models.kmeans import train_kmeans_stream
    from flinkml_tpu_torch.parallel import DeviceMesh

    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    batches = [{"x": x[i::4]} for i in range(4)]
    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = SnapshotPublisher(reg, _kmeans_model, every_n_epochs=2)
    final = train_kmeans_stream(
        batches, k=3, mesh=DeviceMesh(), max_iter=4, seed=0,
        listeners=[pub],
    )
    assert [e for e, _ in pub.published] == [1, 3]
    assert reg.versions() == [1, 2]
    _, last = reg.get()
    np.testing.assert_array_equal(np.asarray(last.centroids, np.float32),
                                  final)


# ---------------------------------------------------------------------------
# 5. Held against the JAX package
# ---------------------------------------------------------------------------

def _jax_pipeline_via_files(tmp_path, x, coef):
    """``(jax model, port model)``: the bench's five-stage chain fitted in
    JAX, carried to the port through its saved files."""
    from tests._torch_port_common import five_stage_pair

    jax_model, _ = five_stage_pair(x, coef)
    path = str(tmp_path / "jax_model")
    jax_model.save(path)
    return jax_model, PipelineModel.load(path)


SERVED = ("s4", "prediction", "rawPrediction")


def _served(resp):
    return {c: resp.column(c) for c in SERVED}


def _assert_matches_jax(got, jax_model, x, f64):
    from tests._torch_port_common import (
        F32_ATOL,
        F32_RTOL,
        F64_RAW_RTOL,
        assert_lr_outputs_close,
        jax_per_stage,
    )

    want = jax_per_stage(jax_model, x)
    tol = dict(rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL) if f64 else \
        dict(rtol=F32_RTOL, atol=F32_ATOL)
    np.testing.assert_allclose(got["s4"], want["s4"], **tol)
    coef = np.asarray(jax_model.stages[-1].get_model_data()[0]
                      .column("coefficient"))[0]
    assert_lr_outputs_close(got, want, want["s4"] @ coef, f64=f64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_engine_responses_match_jax_per_stage(tmp_path, dtype):
    """The port's engine, serving a JAX-fitted model loaded from its
    files, answers every request with the JAX stages' per-stage
    transform of the same rows: within 1e-10 in float64, rtol 1e-5 /
    atol 1e-6 in float32; predictions equal where decisive."""
    from tests._torch_port_common import dense_data

    x, coef = dense_data(rows=200)
    x = x.astype(dtype)
    jax_model, port_model = _jax_pipeline_via_files(tmp_path, x, coef)
    engine = ServingEngine(
        port_model, Table({"features": x[:4]}),
        ServingConfig(max_batch_rows=64, max_wait_ms=1.0),
        output_cols=SERVED, name=f"jax_parity_{np.dtype(dtype).name}",
    ).start()
    try:
        assert engine.device.type == "cpu"
        got = {c: [] for c in SERVED}
        for lo in range(0, 200, 25):
            resp = engine.predict({"features": x[lo:lo + 25]})
            for c in SERVED:
                got[c].append(resp.column(c))
        got = {c: np.concatenate(v) for c, v in got.items()}
        _assert_matches_jax(got, jax_model, x, f64=dtype == np.float64)
    finally:
        engine.stop()


def test_pool_responses_match_jax_per_stage(tmp_path):
    """The same through a 3-replica pool under concurrent clients."""
    from flinkml_tpu_torch.serving import ReplicaPool
    from tests._torch_port_common import dense_data

    x, coef = dense_data(rows=192)
    jax_model, port_model = _jax_pipeline_via_files(tmp_path, x, coef)
    pool = ReplicaPool(
        port_model, Table({"features": x[:4]}),
        config=ServingConfig(max_batch_rows=32, max_wait_ms=1.0),
        n_replicas=3, output_cols=SERVED, name="jax_parity_pool",
    ).start()
    parts = [None] * 8
    errors = []

    def client(i):
        try:
            parts[i] = _served(pool.predict({"features": x[i * 24:(i + 1) * 24]}))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:3]
        got = {c: np.concatenate([p[c] for p in parts]) for c in SERVED}
        _assert_matches_jax(got, jax_model, x, f64=True)
    finally:
        pool.stop()


def test_jax_registry_serves_from_port_and_back(tmp_path):
    """A registry directory JAX's ``ModelRegistry`` wrote (versions, the
    CURRENT pointer, WATERMARK stamps, dedupe keys) serves from the
    port's registry; a version the port publishes there loads back in
    JAX's ``read_write`` and JAX's registry."""
    from flinkml_tpu.io import read_write as jax_rw
    from flinkml_tpu.serving import ModelRegistry as JaxRegistry
    from tests._torch_port_common import dense_data, five_stage_pair

    x, coef = dense_data(rows=64)
    jax_v1, _ = five_stage_pair(x, coef)
    jax_v2, _ = five_stage_pair(x * 2.0, -coef)
    root = str(tmp_path / "reg")
    jreg = JaxRegistry(root)
    assert jreg.publish(jax_v1, dedupe_key="epoch=1", watermark=10) == 1
    assert jreg.publish(jax_v2, dedupe_key="epoch=2", watermark=20) == 2
    jreg.rollback(1)

    reg = ModelRegistry(root)
    assert reg.versions() == [1, 2]
    assert reg.current_version() == 1
    assert (reg.watermark_of(1), reg.watermark_of(2)) == (10, 20)
    assert reg.latest_watermark() == 20
    assert reg.find_dedupe("epoch=2") == 2
    assert reg.publish(jax_v1, dedupe_key="epoch=2") == 2  # deduplicated

    engine = ServingEngine(
        reg, Table({"features": x[:4]}),
        ServingConfig(max_batch_rows=64, max_wait_ms=1.0),
        output_cols=SERVED, name="jax_registry",
    ).start()
    try:
        resp = engine.predict({"features": x})
        assert resp.version == 1
        _assert_matches_jax(_served(resp), jax_v1, x, f64=True)
        engine.swap_to(2)
        resp = engine.predict({"features": x})
        assert resp.version == 2
        _assert_matches_jax(_served(resp), jax_v2, x, f64=True)
    finally:
        engine.stop()

    _, port_v2 = reg.get(2)
    v3 = reg.publish(port_v2, dedupe_key="epoch=3", watermark=30)
    assert v3 == 3
    jreg = JaxRegistry(root)
    assert (jreg.current_version(), jreg.watermark_of(3)) == (3, 30)
    assert jreg.find_dedupe("epoch=3") == 3
    jax_loaded = jax_rw.load_stage(reg.path_of(3))
    assert type(jax_loaded).__module__.startswith("flinkml_tpu.")
    from tests._torch_port_common import jax_per_stage

    np.testing.assert_array_equal(
        jax_per_stage(jax_loaded, x)["rawPrediction"],
        jax_per_stage(jax_v2, x)["rawPrediction"],
    )


def _batch_script(seed):
    """Scripted arrivals: ``(rows, deadline offset or None, pops after)``
    per request; an offset below zero is already overdue."""
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(40):
        rows = int(rng.choice([1, 2, 3, 5, 8, 13, 16, 24, 40]))
        deadline = -1.0 if rng.random() < 0.1 else None
        script.append((rows, deadline, int(rng.integers(0, 3))))
    return script


def _compositions(pkg, cls_name, script, max_batch_rows):
    """Drive one package's batcher through ``script`` with a zero window
    (every pop closes at once, as a window past its end does) and return
    each pop's ``(batch, expired)`` as request numbers and row ranges."""
    mod = __import__(f"{pkg}.serving.batcher", fromlist=["x"])
    b = getattr(mod, cls_name)(max_batch_rows=max_batch_rows,
                               max_wait_s=0.0,
                               max_queue_rows=4 * max_batch_rows)
    ids, out = {}, []

    def pop():
        batch, expired = b.next_batch(poll_s=0.0)
        out.append((
            [(ids[id(s.request)], s.start, s.rows) for s in batch],
            sorted(ids[id(r)] for r in expired),
        ))

    now = time.monotonic()
    for i, (rows, deadline, pops) in enumerate(script):
        req = mod.ServingRequest(
            columns={"f": np.zeros((rows, 2))}, rows=rows, enqueued_at=now,
            deadline=None if deadline is None else now + deadline,
        )
        ids[id(req)] = i
        out.append(("offer", i, b.offer(req)))
        for _ in range(pops):
            pop()
    while b.queued_rows:
        pop()
    return out


@pytest.mark.parametrize("cls_name", ["AdaptiveMicroBatcher",
                                      "ContinuousBatcher"])
@pytest.mark.parametrize("max_batch_rows", [8, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_compositions_match_jax(cls_name, max_batch_rows, seed):
    """The same scripted arrivals (sizes, overdue deadlines, pops between
    offers) give the same batch compositions, row splits, admission
    refusals and expiries in both packages' batchers."""
    script = _batch_script(seed)
    got = _compositions("flinkml_tpu_torch", cls_name, script,
                        max_batch_rows)
    want = _compositions("flinkml_tpu", cls_name, script, max_batch_rows)
    assert got == want
    assert any(batch for batch, _ in
               (o for o in got if o[0] != "offer"))


def _health_script(pkg):
    """One scripted life of a replica's health ledger; the states and the
    time-free part of the snapshot after every call."""
    health = __import__(f"{pkg}.serving.health", fromlist=["x"])
    policy = health.HealthPolicy(max_consecutive_errors=2, overload_trip=2,
                                 drain_low_water=0.25)
    h = health.ReplicaHealth("r0", policy)
    steps = [
        ("submit", 8), ("on_success", 8, 4.0), ("settle", 8),
        ("on_overload",), ("on_overload",), ("maybe_rejoin", 100, 256),
        ("maybe_rejoin", 10, 256), ("record_attempt", 3.0),
        ("record_attempt", 80.0, True), ("mark_slow",), ("mark_slow",),
        ("clear_slow",), ("on_error", RuntimeError("x")),
        ("on_error", RuntimeError("y")), ("seed_ewma", 0.5), ("revive",),
        ("submit", 4), ("on_success", 4, 2.0), ("settle", 4),
    ]
    trace = []
    for name, *args in steps:
        result = getattr(h, name)(*args)
        snap = h.snapshot()
        trace.append((name, result if isinstance(result, bool) else None,
                      h.state.value,
                      {k: v for k, v in snap.items()
                       if k not in ("name", "state_age_s")}))
    return trace


def test_health_transitions_match_jax():
    assert _health_script("flinkml_tpu_torch") == _health_script("flinkml_tpu")


@pytest.mark.parametrize("preset", [None, "full", "mixed", "mixed_inference",
                                    "int8_inference"])
def test_estimate_serving_bytes_matches_jax(preset, tmp_path):
    """The memory gate's estimate is JAX's bytes for every preset, on the
    five-stage chain carried across through its files."""
    from flinkml_tpu.analysis.memory import (
        estimate_serving_bytes as jax_estimate,
    )
    from flinkml_tpu_torch.analysis.memory import estimate_serving_bytes
    from tests._torch_port_common import dense_data

    x, coef = dense_data(rows=16, d=24)
    jax_model, port_model = _jax_pipeline_via_files(tmp_path, x, coef)
    for dtype in (np.float64, np.float32):
        schema = {"features": (np.dtype(dtype), (24,))}
        assert estimate_serving_bytes(port_model, schema, 256, preset) == \
            jax_estimate(jax_model, schema, 256, preset)


# ---------------------------------------------------------------------------
# 6. The serving cases of the JAX package's other test files
# ---------------------------------------------------------------------------

def _online_lr_models():
    from tests.test_torch_recovery import _lr, lr_batches

    good = _lr().fit_stream(lr_batches(n=3))
    bad = _lr().fit_stream(lr_batches(poison=0, n=2))
    x = np.asarray(lr_batches(n=1)[0].column("features"))[:4]
    return good, bad, x


def test_registry_refuses_nonfinite_publish(tmp_path):
    from flinkml_tpu_torch.recovery import NonFiniteModelError

    _, bad, _ = _online_lr_models()
    assert not np.isfinite(bad.coefficient).all()
    reg = ModelRegistry(str(tmp_path / "reg"))
    with pytest.raises(NonFiniteModelError, match="refusing to publish"):
        reg.publish(bad)
    assert reg.versions() == []  # nothing written
    # explicit escape hatch still writes
    assert reg.publish(bad, check_finite=False) == 1


def test_engine_refuses_nonfinite_model_and_keeps_serving(tmp_path):
    good, bad, x = _online_lr_models()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(good)
    engine = ServingEngine(
        reg, Table({"features": x}),
        config=ServingConfig(max_batch_rows=64, max_wait_ms=1.0),
        name="nonfinite",
    ).start()
    try:
        v1 = engine.predict({"features": x}).version
        assert v1 == 1
        # A bypassed bad publish arrives via follow; the swap is refused
        # (isolated listener error) and v1 keeps serving.
        engine.follow_registry()
        with pytest.warns(RuntimeWarning, match="listener"):
            reg.publish(bad, check_finite=False)
        assert engine.active_version == 1
        assert engine.predict({"features": x}).version == 1
    finally:
        engine.stop()


def test_drop_publish_leaves_registry_untouched(tmp_path):
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.models.online_kmeans import OnlineKMeansModel

    model = OnlineKMeansModel()
    model._centroids = np.zeros((2, 3))
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model)
    with faults.armed(faults.FaultPlan(faults.DropPublish(at_publish=1))):
        with pytest.raises(faults.FaultInjected, match="dropped publish"):
            reg.publish(model)
    assert reg.versions() == [1]
    assert reg.current_version() == 1
    # The next publish (plan disarmed) proceeds normally.
    assert reg.publish(model) == 2


def test_watchdog_drains_a_real_engine(pipeline_and_data):
    """A preemption watchdog's finalize stops a registered engine with
    drain: every request already queued is answered, later ones are
    refused."""
    from flinkml_tpu_torch.utils.preemption import PreemptionWatchdog

    pm, x = pipeline_and_data
    eng = _engine(pm, x, max_wait_ms=50.0).start()
    wd = PreemptionWatchdog(signals=())
    wd.register_engine(eng)
    pending = [eng.submit({"features": x[i:i + 3]}) for i in range(5)]
    wd.finalize()
    assert not eng.running
    for p in pending:
        assert p.wait(5.0)
        assert p.response().columns["prediction"].shape == (3,)
    with pytest.raises(EngineStoppedError):
        eng.predict({"features": x[:2]})


def _scaler_lr_pipeline(n=256, d=8, seed=3, max_iter=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    t = Table({"features": x, "label": y})
    sc = StandardScaler().set(StandardScaler.INPUT_COL, "features") \
                         .set(StandardScaler.OUTPUT_COL, "scaled").fit(t)
    (st,) = sc.transform(t)
    lr = LogisticRegression().set(
        LogisticRegression.FEATURES_COL, "scaled"
    ).set(LogisticRegression.LABEL_COL, "label").set_max_iter(max_iter) \
     .set(LogisticRegression.SEED, 7).fit(st)
    return PipelineModel([sc, lr]), t


def _scaler_kmeans_pipeline(n=128, d=8, seed=4):
    from flinkml_tpu_torch.models.kmeans import KMeans

    rng = np.random.default_rng(seed)
    t = Table({"features": rng.normal(size=(n, d))})
    sc = StandardScaler().set(StandardScaler.INPUT_COL, "features") \
                         .set(StandardScaler.OUTPUT_COL, "scaled").fit(t)
    (st,) = sc.transform(t)
    km = KMeans().set(KMeans.K, 3).set(KMeans.FEATURES_COL, "scaled") \
                 .set(KMeans.SEED, 7).fit(st)
    return PipelineModel([sc, km]), t


def _wide_scaler_lr_pipeline(n=400, d=32, seed=11):
    """d >= the int8 tier's size threshold, so every model constant
    (scaler mean/scale vectors, the LR coefficient) quantizes."""
    return _scaler_lr_pipeline(n=n, d=d, seed=seed, max_iter=3)


def _precision_pipelines():
    return _scaler_lr_pipeline, _scaler_kmeans_pipeline, \
        _wide_scaler_lr_pipeline


def _serving_cfg(**kw):
    return ServingConfig(max_batch_rows=64, max_wait_ms=1.0,
                         warmup_row_counts=(8,), **kw)


def test_serving_engine_policy_equivalence():
    from flinkml_tpu_torch.precision import MIXED_INFERENCE

    lr_pipeline, _, _ = _precision_pipelines()
    pm, t = lr_pipeline()
    example = Table({"features": np.asarray(t.column("features"))[:8]})
    req = Table({"features": np.asarray(t.column("features"))[:32]})
    e32 = ServingEngine(pm, example, _serving_cfg(), name="f32p").start()
    try:
        r32 = e32.predict(req)
    finally:
        e32.stop()
    ebf = ServingEngine(
        pm, example, _serving_cfg(precision="mixed_inference"),
        name="bf16p",
    ).start()
    try:
        assert ebf._policy is MIXED_INFERENCE
        rbf = ebf.predict(req)
    finally:
        ebf.stop()
    np.testing.assert_array_equal(
        r32.column("prediction"), rbf.column("prediction")
    )
    # numpy has no bfloat16: the port reads bfloat16 back as float32
    # holding exactly its values.
    raw = rbf.column("rawPrediction")
    assert raw.dtype == np.float32
    import torch

    np.testing.assert_array_equal(
        torch.from_numpy(raw).to(torch.bfloat16).float().numpy(), raw)
    np.testing.assert_allclose(
        r32.column("rawPrediction").astype(np.float64),
        raw.astype(np.float64), atol=2e-2,
    )


def test_serving_load_refused_under_strict_policy():
    from flinkml_tpu_torch.precision import MIXED, PrecisionValidationError

    _, kmeans_pipeline, _ = _precision_pipelines()
    pm, t = kmeans_pipeline(seed=7)
    example = Table({"features": np.asarray(t.column("features"))[:8]})
    with pytest.raises(PrecisionValidationError):
        ServingEngine(
            pm, example, _serving_cfg(precision=MIXED), name="strict",
        ).start()


def test_serving_refused_swap_keeps_old_model(tmp_path):
    """The refuse-at-LOAD contract: a policy-violating publish fails the
    swap with the typed error and the previous model keeps serving —
    the same shape as refuse_nonfinite."""
    from flinkml_tpu_torch.precision import MIXED, PrecisionValidationError

    lr_pipeline, kmeans_pipeline, _ = _precision_pipelines()
    good, t = lr_pipeline(seed=8)
    bad, _ = kmeans_pipeline(seed=8)
    reg = ModelRegistry(str(tmp_path))
    v1 = reg.publish(good)
    example = Table({"features": np.asarray(t.column("features"))[:8]})
    engine = ServingEngine(
        reg, example, _serving_cfg(precision=MIXED), name="swapper",
    ).start()
    try:
        assert engine.active_version == v1
        v2 = reg.publish(bad)
        with pytest.raises(PrecisionValidationError):
            engine.swap_to(v2)
        assert engine.active_version == v1
        resp = engine.predict(
            Table({"features": np.asarray(t.column("features"))[:16]})
        )
        assert resp.version == v1
    finally:
        engine.stop()


def test_replica_pool_inherits_policy():
    from flinkml_tpu_torch.precision import MIXED_INFERENCE
    from flinkml_tpu_torch.serving.pool import ReplicaPool

    lr_pipeline, _, _ = _precision_pipelines()
    pm, t = lr_pipeline(seed=9)
    example = Table({"features": np.asarray(t.column("features"))[:8]})
    req = Table({"features": np.asarray(t.column("features"))[:16]})
    (o32,) = pm.transform(t)
    pool = ReplicaPool(
        pm, example, config=_serving_cfg(precision="mixed_inference"),
        n_replicas=2, name="bfpool",
    ).start()
    try:
        for r in pool.replicas:
            assert r.engine._policy is MIXED_INFERENCE
        resp = pool.predict(req)
        np.testing.assert_array_equal(
            resp.column("prediction"),
            np.asarray(o32.column("prediction"))[:16],
        )
        assert resp.column("rawPrediction").dtype == np.float32
    finally:
        pool.stop()


def test_serving_engine_int8_tier_end_to_end():
    """ServingConfig(precision='int8_inference'): the engine serves the
    quantized tier within the pinned tolerance of an f32 engine, through
    the same load/warmup/FML6xx gate path as every other policy (the
    port's int8 threshold is 16 elements, below this model's d = 32)."""
    _, _, wide_pipeline = _precision_pipelines()
    pm, t = wide_pipeline(seed=13)
    x = np.asarray(t.column("features"))
    example = Table({"features": x[:4]})
    e32 = ServingEngine(
        pm, example, ServingConfig(max_batch_rows=64, max_wait_ms=1.0),
        output_cols=("prediction", "rawPrediction"), name="p_f32",
    ).start()
    eq8 = ServingEngine(
        pm, example,
        ServingConfig(max_batch_rows=64, max_wait_ms=1.0,
                      precision="int8_inference"),
        output_cols=("prediction", "rawPrediction"), name="p_int8",
    ).start()
    try:
        r32 = e32.predict({"features": x[:32]})
        rq8 = eq8.predict({"features": x[:32]})
        np.testing.assert_array_equal(
            r32.column("prediction"), rq8.column("prediction")
        )
        dev = np.max(np.abs(
            r32.column("rawPrediction").astype(np.float64)
            - rq8.column("rawPrediction").astype(np.float64)
        ))
        assert 0.0 < dev < 5e-3, dev
    finally:
        e32.stop()
        eq8.stop()


def test_estimate_serving_bytes_tier_ordering():
    from flinkml_tpu_torch.analysis.memory import estimate_serving_bytes
    from flinkml_tpu_torch.models.logistic_regression import (
        LogisticRegressionModel,
    )

    d = 64
    lr = LogisticRegressionModel().set(
        LogisticRegressionModel.FEATURES_COL, "features"
    )
    lr.set_model_data(Table({"coefficient": np.ones((1, d))}))
    schema = {"features": (np.dtype(np.float64), (d,))}
    full = estimate_serving_bytes(lr, schema, 64, policy=None)
    int8 = estimate_serving_bytes(lr, schema, 64,
                                  policy="int8_inference")
    mixed = estimate_serving_bytes(lr, schema, 64,
                                   policy="mixed_inference")
    assert int8 < full and mixed < full
    assert full > 3 * 64 * d * 8  # three batch buffers floor


def test_serving_budget_gate_refuses_swap_and_keeps_old_model(tmp_path):
    from flinkml_tpu_torch.models.logistic_regression import (
        LogisticRegressionModel,
    )
    from flinkml_tpu_torch.serving import ServingMemoryError

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8))
    y = (x @ rng.normal(size=8) > 0).astype(np.float64)
    small = LogisticRegression().set(
        LogisticRegression.FEATURES_COL, "features"
    ).set(LogisticRegression.LABEL_COL, "label").set_max_iter(3).fit(
        Table({"features": x, "label": y})
    )
    # v2: finite (passes the sentinel) but with a multi-MiB learned
    # array — over any KiB-scale budget. It is refused BEFORE warmup,
    # so it never has to transform.
    big = LogisticRegressionModel().set(
        LogisticRegressionModel.FEATURES_COL, "features"
    )
    big.set_model_data(
        Table({"coefficient": np.ones((1, 1 << 20))})
    )

    reg = ModelRegistry(str(tmp_path / "reg"))
    v1 = reg.publish(small)
    eng = ServingEngine(
        reg, Table({"features": x[:4]}),
        ServingConfig(max_batch_rows=64, warmup_row_counts=(4,),
                      hbm_budget_bytes=1 << 20),
        output_cols=("prediction",), name="budget",
    ).start()
    try:
        assert eng.predict(Table({"features": x[:4]})).version == v1
        v2 = reg.publish(big)
        with pytest.raises(ServingMemoryError, match="keeps serving"):
            eng.swap_to(v2)
        # The refused swap left v1 active and serving.
        assert eng.predict(Table({"features": x[:4]})).version == v1
    finally:
        eng.stop()


def test_engine_captures_its_device_at_construction(pipeline_and_data):
    """The engine's device is the constructing thread's: built under
    ``use_device("cpu")`` it serves on the CPU from its own dispatcher
    thread (which never entered that scope) and launches no kernel; built
    in a thread that asked for nothing it takes the port's default,
    ``cuda``, and on a host without a card refuses to start, naming the
    remedy, instead of falling back to the CPU."""
    import torch

    import flinkml_tpu_torch as fml

    pm, x = pipeline_and_data
    before = fml.launch_counts()
    eng = _engine(pm, x).start()
    try:
        assert eng.device == torch.device("cpu")
        assert eng._thread is not threading.current_thread()
        eng.predict({"features": x[:5]})
    finally:
        eng.stop()
    assert fml.launch_counts() == before

    made = {}
    t = threading.Thread(target=lambda: made.update(e=_engine(pm, x)))
    t.start()
    t.join()
    assert made["e"].device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="use_device"):
            made["e"].start()
        assert not made["e"].running


def test_chain_program_tables_under_threads():
    """One ``ChainProgram`` serves two models of one shape from many
    threads at once (engines of a rolling swap, a multi-model pool): each
    call gets the table packed from its own model's arrays, and the two
    tables stay cached side by side instead of repacking each turn."""
    import sys

    import torch

    from flinkml_tpu_torch.kernels import chain as kchain

    x, y = _data()
    models = [_fitted_pipeline(x, y), _fitted_pipeline(x * 2.0, 1.0 - y)]
    kernels = [[s.transform_kernel() for s in m.stages] for m in models]
    consts = [[k.constants for k in ks] for ks in kernels]
    program = kchain.ChainProgram(kernels[0], ["features"],
                                  ["prediction", "rawPrediction"])
    cpu, d = torch.device("cpu"), x.shape[1]
    want = [kchain.ChainProgram(kernels[i], ["features"],
                                ["prediction", "rawPrediction"])
            .table(consts[i], torch.float64, cpu, d)[0] for i in (0, 1)]
    assert not torch.equal(want[0], want[1])
    errors = []

    def worker(tid):
        try:
            for i in range(300):
                m = (tid + i) % 2
                got = program.table(consts[m], torch.float64, cpu, d)[0]
                if not torch.equal(got, want[m]):
                    errors.append((tid, i, m))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(program._tables) == 2


def test_serving_exports_the_jax_packages_names():
    import flinkml_tpu.serving as jax_serving

    import flinkml_tpu_torch.serving as serving

    assert serving.__all__ == jax_serving.__all__
    for name in serving.__all__:
        ours, theirs = getattr(serving, name), getattr(jax_serving, name)
        if isinstance(theirs, type) or callable(theirs):
            assert ours.__name__ == theirs.__name__
        else:  # the SLO class presets
            assert repr(ours) == repr(theirs)


def _window_script(seed):
    """Timed arrivals for a batcher with a window: ``(arrival, rows,
    deadline offset or None)``, arrivals 0-3 ms apart; an offset below
    zero is already overdue, a small one closes or outlives a window."""
    rng = np.random.default_rng(seed)
    script, t = [], 0.0
    for _ in range(40):
        t += float(rng.choice([0.0, 0.0005, 0.001, 0.002, 0.003]))
        rows = int(rng.choice([1, 2, 3, 5, 8, 13, 16, 24, 40]))
        u = rng.random()
        deadline = (-1.0 if u < 0.1 else
                    float(rng.choice([0.001, 0.006, 0.008])) if u < 0.4
                    else None)
        script.append((t, rows, deadline))
    return script


def _windowed(pkg, cls_name, script, max_batch_rows, by_poll=False):
    """Drive one package's batcher through ``script`` on a simulated
    clock (a wait ends at its timeout or at the next arrival, which it
    offers; serving takes no time), with ``next_batch`` or — ``by_poll``
    — as the CPU host drives ``poll``. Returns each batch as ``(time,
    [(request, start, rows)])`` and the set of expired requests."""
    mod = __import__(f"{pkg}.serving.batcher", fromlist=["x"])
    b = getattr(mod, cls_name)(max_batch_rows=max_batch_rows,
                               max_wait_s=0.004,
                               max_queue_rows=4 * max_batch_rows)
    clock, pending, ids, held = [100.0], list(script), {}, []
    batches, expired = [], set()

    def arrive():
        while pending and 100.0 + pending[0][0] <= clock[0]:
            t, rows, deadline = pending.pop(0)
            req = mod.ServingRequest(
                columns={"f": np.zeros((rows, 2))}, rows=rows,
                enqueued_at=100.0 + t,
                deadline=None if deadline is None else 100.0 + t + deadline)
            ids[id(req)] = len(ids)
            held.append(req)  # alive, so no later request reuses its id()
            b.offer(req)

    def wait(timeout=None):
        nxt = 100.0 + pending[0][0] if pending else float("inf")
        end = clock[0] + timeout
        clock[0] = max(clock[0], min(nxt, end))
        arrive()
        return nxt <= end

    def record(batch, gone):
        if batch:
            batches.append((clock[0], [(ids[id(s.request)], s.start, s.rows)
                                       for s in batch]))
        expired.update(ids[id(r)] for r in gone)

    real_time = mod.time
    mod.time = type("Clock", (), {"monotonic": staticmethod(
        lambda: clock[0])})
    b._cond.wait = wait
    try:
        while pending or b.queued_rows:
            arrive()
            if not by_poll:
                record(*b.next_batch(poll_s=0.01))
                continue
            batch, gone, wake_at = b.poll()
            record(batch, gone)
            if not batch:
                wait((wake_at if wake_at is not None else float("inf"))
                     - clock[0])
    finally:
        mod.time = real_time
    return batches, expired


@pytest.mark.parametrize("cls_name", ["AdaptiveMicroBatcher",
                                      "ContinuousBatcher"])
@pytest.mark.parametrize("max_batch_rows", [8, 32])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("by_poll", [False, True])
def test_batcher_windows_match_jax(cls_name, max_batch_rows, seed, by_poll):
    """With a window, deadlines that close it early, expiries mid-window
    and a bucket filling, the port's batcher — through ``next_batch``, or
    through ``poll`` polled again at each arrival and at the time it names,
    as the CPU host drives it — forms the batches the JAX package's
    ``next_batch`` forms, at the same times, and expires the same
    requests."""
    script = _window_script(seed)
    got = _windowed("flinkml_tpu_torch", cls_name, script, max_batch_rows,
                    by_poll=by_poll)
    want = _windowed("flinkml_tpu", cls_name, script, max_batch_rows)
    assert got == want
    assert got[0] and got[1]


def test_cpu_engines_share_one_dispatcher(pipeline_and_data):
    """Every CPU engine of the process is served by the one host thread
    (``engine._CPU_HOST``); each engine's own thread only waits, and stop()
    still drains and joins it."""
    pm, x = pipeline_and_data
    engines = [_engine(pm, x, max_wait_ms=0.0) for _ in range(2)]
    seen = set()
    for eng in engines:
        run = eng._run_batch

        def traced(batch, run=run):
            seen.add(threading.current_thread().name)
            run(batch)

        eng._run_batch = traced
        eng.start()
    try:
        for i in range(6):
            engines[i % 2].predict({"features": x[i:i + 3]})
        assert seen == {"serving-cpu-host"}
    finally:
        for eng in engines:
            eng.stop()
    assert not any(eng.running for eng in engines)


def test_cpu_host_runs_armed_batches_while_a_seam_stalls(pipeline_and_data):
    """With a fault plan armed, a stalled replica's ``serving.replica``
    seam sleeps on a thread of its own: the sibling engine is served
    meanwhile, and every batch, the stalled one too, still runs on the one
    host thread."""
    import flinkml_tpu_torch.faults as faults

    pm, x = pipeline_and_data
    engines = [ServingEngine(pm, Table({"features": x[:4]}),
                             ServingConfig(max_batch_rows=64,
                                           max_queue_rows=256,
                                           warmup_row_counts=(1, 64),
                                           max_wait_ms=0.0),
                             output_cols=("prediction",), name=name)
               for name in ("stalled", "sibling")]
    ran = []
    for eng in engines:
        run = eng._run_batch

        def traced(batch, run=run):
            ran.append(threading.current_thread().name)
            run(batch)

        eng._run_batch = traced
        eng.start()
    stalled, sibling = engines
    stall = faults.StallDispatch("stalled", delay_s=2.0, for_batches=1)
    try:
        with faults.armed(faults.FaultPlan(stall)):
            slow = threading.Thread(target=stalled.predict,
                                    args=({"features": x[:3]},))
            slow.start()
            t0 = time.monotonic()
            while not stall.fired and time.monotonic() - t0 < 10.0:
                time.sleep(0.005)
            assert stall.fired
            got = sibling.predict({"features": x[3:6]})
            assert slow.is_alive()  # the sibling answered inside the stall
            slow.join(10.0)
        assert not slow.is_alive()
        want = pm.transform(Table({"features": x[3:6]}))[0]
        np.testing.assert_array_equal(got.column("prediction"),
                                      np.asarray(want.column("prediction")))
        assert ran == ["serving-cpu-host"] * 2
    finally:
        for eng in engines:
            eng.stop()
