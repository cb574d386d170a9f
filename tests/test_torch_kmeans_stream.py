"""The rest of KMeans in the port (``flinkml_tpu_torch``): the row reservoir
and the streamed, cached and checkpointed fit, against the JAX package on
a one-device mesh, on the CPU.

Inputs are seeded numpy blobs, well separated, handed to both packages as
the same batches. Both streamed fits compute in float32. Declared
tolerances:

- ``RowReservoir``: its sample equals the JAX one bit for bit.
- Streamed centroids against JAX's: rtol/atol 1e-5 (float32 sums added in
  another order than XLA's); the initial centroids, drawn by the same
  reservoir and generator, are equal exactly (a zero-epoch fit returns
  them).
- The port against itself: a spilled cache, a resumed fit and a repeated
  fit are equal bit for bit; the stream against the whole-loop
  ``train_kmeans`` from the same init within 1e-5 (per-batch sums added
  in another order).
- Snapshots crossing packages: the restored centroids equal the writer's
  bit for bit; the finished fits agree within 1e-5.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.iteration import CheckpointManager as JaxCheckpointManager
from flinkml_tpu.iteration import datacache as jax_datacache
from flinkml_tpu.models import kmeans as jax_kmeans
from flinkml_tpu.parallel import DeviceMesh
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu.utils.sampling import RowReservoir as JaxRowReservoir
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.iteration import datacache as t_datacache
from flinkml_tpu_torch.models import kmeans as t_kmeans
from flinkml_tpu_torch.utils.sampling import RowReservoir
from tests._torch_port_common import on_cpu  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module")
def mesh1():
    return DeviceMesh(devices=jax.devices()[:1])


@pytest.fixture(autouse=True)
def _jax_mesh_lock_registry():
    """The JAX streamed KMeans registers its mesh's device set in the JAX
    package's process-wide lock registry. A one-device set would overlap
    the full meshes of later JAX tests in the same worker and turn their
    lock into a composite, so the registry is restored after each test."""
    from flinkml_tpu.parallel import dispatch

    saved = dict(dispatch._MESH_LOCKS)
    yield
    with dispatch._MESH_LOCKS_GUARD:
        dispatch._MESH_LOCKS.clear()
        dispatch._MESH_LOCKS.update(saved)


def _blobs(sizes=(64, 64, 64, 64), d=5, k=3, seed=0):
    """Batch dicts ``{"features": [n, d] float32}`` drawn around ``k``
    centres far apart."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(k, d)).astype(np.float32)
    out = []
    for rows in sizes:
        assign = rng.integers(0, k, size=rows)
        x = centers[assign] + rng.normal(scale=0.5, size=(rows, d))
        out.append({"features": x.astype(np.float32)})
    return out


def _both(batches, mesh, **kw):
    """``(port, jax)`` streamed fits over the same batches."""
    args = dict(k=3, max_iter=6, seed=7, column="features")
    args.update(kw)
    got = t_kmeans.train_kmeans_stream(iter(batches), **args)
    want = jax_kmeans.train_kmeans_stream(iter(batches), mesh=mesh, **args)
    return got, want


class _Crash(CheckpointManager):
    """A port manager that raises once a save reaches ``crash_at``."""

    crash_at = None

    def save(self, state, epoch, extra=None, **kw):
        out = super().save(state, epoch, extra, **kw)
        if self.crash_at is not None and epoch >= self.crash_at:
            self.crash_at = None
            raise RuntimeError("injected crash")
        return out


class _JaxCrash(JaxCheckpointManager):
    crash_at = None

    def save(self, state, epoch, extra=None, **kw):
        out = super().save(state, epoch, extra, **kw)
        if self.crash_at is not None and epoch >= self.crash_at:
            self.crash_at = None
            raise RuntimeError("injected crash")
        return out


class _Recorder:
    def __init__(self):
        self.epochs, self.states, self.terminated = [], [], None

    def on_epoch_watermark_incremented(self, epoch, state):
        self.epochs.append(epoch)
        self.states.append(np.array(torch.as_tensor(state).numpy()
                                    if torch.is_tensor(state) else state))

    def on_iteration_terminated(self, state):
        self.terminated = np.array(torch.as_tensor(state).numpy()
                                   if torch.is_tensor(state) else state)


# -- the reservoir ---------------------------------------------------------------------

@pytest.mark.parametrize("capacity,sizes", [
    (5, (3, 4, 10, 0, 7)),          # fill across blocks, then replacements
    (100, (30, 30)),                # never full
    (8, (64, 64, 64, 64)),          # mostly replacements
    (1, (1, 1, 1, 5)),
])
def test_row_reservoir_matches_jax(capacity, sizes):
    rng = np.random.default_rng(3)
    blocks = [rng.normal(size=(n, 4)).astype(np.float32) for n in sizes]
    got, want = RowReservoir(capacity, seed=11), JaxRowReservoir(capacity,
                                                                 seed=11)
    for b in blocks:
        got.add(b)
        want.add(b)
    assert got.rows_seen == want.rows_seen == sum(sizes)
    np.testing.assert_array_equal(got.sample(), want.sample())
    assert got.sample().dtype == np.float32


def test_row_reservoir_edge_cases():
    with pytest.raises(ValueError, match="capacity must be positive"):
        RowReservoir(0)
    with pytest.raises(ValueError, match="capacity must be positive"):
        JaxRowReservoir(0)
    assert RowReservoir(3).sample().shape == JaxRowReservoir(3).sample().shape


# -- the streamed fit against JAX's ----------------------------------------------------

@pytest.mark.parametrize("init_mode", ["random", "k-means++"])
@pytest.mark.parametrize("sizes", [(64, 64, 64, 64), (37, 50, 13, 64, 41)])
def test_stream_matches_jax(init_mode, sizes, mesh1, on_cpu):
    """Random and k-means++ init from the reservoir (k-means++ on a
    120-row sample, so replacements happen), fixed and variable batch
    sizes (padded to the row tile with zero weight)."""
    batches = _blobs(sizes)
    kw = dict(init_mode=init_mode, init_sample_size=120)
    got, want = _both(batches, mesh1, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # The initial centroids (a zero-epoch fit) are equal exactly.
    init_t, init_j = _both(batches, mesh1, max_iter=0, **kw)
    np.testing.assert_array_equal(init_t, init_j)


def test_stream_initial_centroids_match_jax(mesh1, on_cpu):
    batches = _blobs(seed=2)
    init = batches[0]["features"][[0, 1, 2]] + 0.25
    got, want = _both(batches, mesh1, initial_centroids=init, max_iter=4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # An empty cluster keeps its centroid (a far-away start).
    far = np.concatenate([init[:2], np.full((1, 5), 1e4, np.float32)])
    got, want = _both(batches, mesh1, initial_centroids=far, max_iter=3)
    np.testing.assert_array_equal(got[2], far[2])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_stream_from_sealed_cache_matches_jax(mesh1, on_cpu):
    """A sealed DataCache in each package (the same batches): sampled by
    one read, then replayed each epoch."""
    batches = _blobs((40, 72, 64), seed=4)
    args = dict(k=3, max_iter=5, seed=3, column="features")
    got = t_kmeans.train_kmeans_stream(
        t_datacache.cache_stream(iter(batches)), **args)
    want = jax_kmeans.train_kmeans_stream(
        jax_datacache.cache_stream(iter(batches)), mesh=mesh1, **args)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # The sealed cache gives the one-shot stream's result exactly.
    np.testing.assert_array_equal(
        got, t_kmeans.train_kmeans_stream(iter(batches), **args))


def test_spilled_cache_equals_in_ram(tmp_path, on_cpu):
    batches = _blobs(seed=5)
    args = dict(k=3, max_iter=6, seed=1, column="features")
    in_ram = t_kmeans.train_kmeans_stream(iter(batches), **args)
    spilled = t_kmeans.train_kmeans_stream(
        iter(batches), cache_dir=str(tmp_path / "c"), memory_budget_bytes=1,
        **args)
    assert len(list((tmp_path / "c").iterdir())) == len(batches)
    np.testing.assert_array_equal(spilled, in_ram)


def test_stream_equals_whole_loop_fit(on_cpu):
    """The stream from the same init as the port's whole-loop
    ``train_kmeans`` over the concatenated rows."""
    batches = _blobs((64, 24, 64, 40), seed=6)
    x = np.concatenate([b["features"] for b in batches])
    init = x[[3, 70, 150]]
    whole = t_kmeans.train_kmeans(x, 3, max_iter=7, initial_centroids=init)
    streamed = t_kmeans.train_kmeans_stream(
        iter(batches), k=3, max_iter=7, column="features",
        initial_centroids=init)
    assert whole.dtype == streamed.dtype == np.float32
    np.testing.assert_allclose(streamed, whole, rtol=TOL, atol=TOL)


def test_listeners_fire_per_epoch(mesh1, on_cpu):
    batches = _blobs(seed=8)
    lt, lj = _Recorder(), _Recorder()
    got = t_kmeans.train_kmeans_stream(iter(batches), k=3, max_iter=4, seed=2,
                                       column="features", listeners=[lt])
    want = jax_kmeans.train_kmeans_stream(
        iter(batches), k=3, mesh=mesh1, max_iter=4, seed=2,
        column="features", listeners=[lj])
    assert lt.epochs == lj.epochs == [0, 1, 2, 3]
    for s_t, s_j in zip(lt.states, lj.states):
        np.testing.assert_allclose(s_t, s_j, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(lt.terminated, got)
    np.testing.assert_allclose(lt.terminated, want, rtol=TOL, atol=TOL)


# -- checkpoints and resume ------------------------------------------------------------

def test_resume_bit_for_bit(tmp_path, on_cpu):
    """A fit crashed after its epoch-3 snapshot and resumed equals the
    uninterrupted one bit for bit; a second crash and resume too."""
    cache = t_datacache.cache_stream(iter(_blobs(seed=9)))
    args = dict(k=3, max_iter=8, seed=7, column="features")
    golden = t_kmeans.train_kmeans_stream(cache, **args)
    mgr = _Crash(str(tmp_path / "ck"))
    for crash_at in (3, 6):
        mgr.crash_at = crash_at
        with pytest.raises(RuntimeError, match="injected"):
            t_kmeans.train_kmeans_stream(
                cache, checkpoint_manager=mgr, checkpoint_interval=3,
                resume=crash_at > 3, **args)
        assert mgr.latest_epoch() == crash_at
    final = t_kmeans.train_kmeans_stream(
        cache, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")),
        checkpoint_interval=3, resume=True, **args)
    np.testing.assert_array_equal(final, golden)
    # Resuming a finished run is a no-op returning the terminal snapshot.
    again = t_kmeans.train_kmeans_stream(
        cache, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")),
        checkpoint_interval=3, resume=True, **args)
    np.testing.assert_array_equal(again, golden)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_packages(writer, tmp_path, mesh1, on_cpu):
    """A run of one package crashes after its epoch-2 snapshot; the other
    package resumes from that snapshot directory: to epoch 2 it returns
    the writer's centroids bit for bit, to the end it agrees with the
    writer's uninterrupted fit within 1e-5."""
    batches = _blobs(seed=10)
    args = dict(k=3, max_iter=6, seed=4, column="features")
    d = str(tmp_path / "ck")
    t_cache = t_datacache.cache_stream(iter(batches))
    j_cache = jax_datacache.cache_stream(iter(batches))
    if writer == "jax":
        mgr = _JaxCrash(d)
        mgr.crash_at = 2
        with pytest.raises(RuntimeError, match="injected"):
            jax_kmeans.train_kmeans_stream(
                j_cache, mesh=mesh1, checkpoint_manager=mgr,
                checkpoint_interval=2, **args)
        at2 = jax_kmeans.train_kmeans_stream(j_cache, mesh=mesh1,
                                             **dict(args, max_iter=2))
        full = jax_kmeans.train_kmeans_stream(j_cache, mesh=mesh1, **args)

        def resume(max_iter):
            return t_kmeans.train_kmeans_stream(
                t_cache, checkpoint_manager=CheckpointManager(d),
                checkpoint_interval=0, resume=True,
                **dict(args, max_iter=max_iter))
    else:
        mgr = _Crash(d)
        mgr.crash_at = 2
        with pytest.raises(RuntimeError, match="injected"):
            t_kmeans.train_kmeans_stream(
                t_cache, checkpoint_manager=mgr, checkpoint_interval=2,
                **args)
        at2 = t_kmeans.train_kmeans_stream(t_cache, **dict(args, max_iter=2))
        full = t_kmeans.train_kmeans_stream(t_cache, **args)

        def resume(max_iter):
            return jax_kmeans.train_kmeans_stream(
                j_cache, mesh=mesh1,
                checkpoint_manager=JaxCheckpointManager(d),
                checkpoint_interval=0, resume=True,
                **dict(args, max_iter=max_iter))
    np.testing.assert_array_equal(resume(2), at2)
    np.testing.assert_allclose(resume(6), full, rtol=TOL, atol=TOL)


# -- the estimator ---------------------------------------------------------------------

def test_estimator_streamed_fit_matches_jax(tmp_path, mesh1, on_cpu):
    """``KMeans().fit`` over an iterable of Tables (spilling) and over a
    sealed DataCache, with the checkpoint knobs, against JAX's estimator;
    the model transforms as the in-RAM one does."""
    batches = _blobs((50, 64, 30), seed=11)
    tables = [fml.Table(b) for b in batches]
    jtables = [JaxTable(b) for b in batches]
    mgr = CheckpointManager(str(tmp_path / "ck"))
    est = (fml.KMeans(cache_dir=str(tmp_path / "c"),
                      cache_memory_budget_bytes=1, checkpoint_manager=mgr,
                      checkpoint_interval=2)
           .set_k(3).set_max_iter(5).set_seed(3))
    model = est.fit(iter(tables))
    want = (jax_kmeans.KMeans(mesh=mesh1).set_k(3).set_max_iter(5)
            .set_seed(3).fit(iter(jtables)))
    np.testing.assert_allclose(model.centroids, want.centroids, rtol=TOL,
                               atol=TOL)
    assert mgr.all_epochs()[-1] == 5
    cached = (fml.KMeans().set_k(3).set_max_iter(5).set_seed(3)
              .fit(t_datacache.cache_stream(iter(batches))))
    np.testing.assert_array_equal(cached.centroids, model.centroids)
    x = np.concatenate([b["features"] for b in batches])
    (out,) = model.transform(fml.Table({"features": x}))
    (jout,) = want.transform(JaxTable({"features": x}))
    np.testing.assert_array_equal(np.asarray(out.column("prediction")),
                                  np.asarray(jout.column("prediction")))


# -- the JAX package's error cases -----------------------------------------------------

def _raises_like_jax(match, mesh, batches_fn, **kw):
    args = dict(k=3, max_iter=2, seed=0, column="features")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        t_kmeans.train_kmeans_stream(batches_fn(t_datacache), **args)
    with pytest.raises(ValueError, match=match):
        jax_kmeans.train_kmeans_stream(batches_fn(jax_datacache), mesh=mesh,
                                       **args)


def test_error_cases_match_jax(tmp_path, mesh1, on_cpu):
    batches = _blobs(seed=12)
    ragged = batches[:2] + [{"features": np.zeros((8, 4), np.float32)}]
    _raises_like_jax("durable DataCache", mesh1, lambda m: iter(batches),
                     resume=True)
    _raises_like_jax("requires a checkpoint_manager", mesh1,
                     lambda m: m.cache_stream(iter(batches)), resume=True)
    _raises_like_jax("exceeds number of points 0", mesh1, lambda m: iter([]))
    _raises_like_jax("batch feature dim 4 != first batch's 5", mesh1,
                     lambda m: iter(ragged))
    _raises_like_jax("exceeds number of points 192", mesh1,
                     lambda m: iter(batches[:3]), k=500)
    _raises_like_jax("zero rows", mesh1, lambda m: iter(
        [{"features": np.zeros((0, 5), np.float32)}]))
    _raises_like_jax(r"must be \[n, d\]", mesh1, lambda m: iter(
        [{"features": np.zeros(5, np.float32)}]))
    _raises_like_jax("initial_centroids has 2 rows", mesh1,
                     lambda m: iter(batches),
                     initial_centroids=np.zeros((2, 5), np.float32))
    # mesh= takes the multi-process stream (item 7c, P ranks in
    # tests/test_torch_stream_mp.py); anything but a DeviceMesh is refused.
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_kmeans.train_kmeans_stream(iter(batches), k=3, mesh=object())


def test_tie_prone_stream_follows_the_in_ram_fit(mesh1, on_cpu):
    """On data with near ties the port's streamed fit follows JAX's in-RAM
    fit, not JAX's streamed fit (ROADMAP.md's declared differences).

    ``standard_normal`` float32 batches (8 x 4,096 x 16, data seed 1),
    k = 8, 20 epochs, k-means++ on a 2,000-row sample, seed 7: the port's
    streamed centroids are within 1e-5 of JAX's in-RAM ``train_kmeans``
    from the same init, while JAX's streamed fit parts from both (observed
    on the CPU: 1.0e-2 max abs centroid, 235 of 32,768 assignments differ).
    JAX's streamed fit adds each batch's ``onehot.T @ xb`` in XLA's order,
    one ulp away from the whole-table product, and Lloyd amplifies that
    at near ties. Smaller sizes tried (4 x 4,096, 8 x 2,048, 4 x 2,048 and
    8 x 1,024 rows, data seeds 0-5) do not part.
    """
    rng = np.random.default_rng(1)
    batches = [rng.standard_normal((4096, 16)).astype(np.float32)
               for _ in range(8)]
    args = dict(k=8, max_iter=20, seed=7, init_mode="k-means++",
                init_sample_size=2000)

    def stream():
        return iter([{"x": b} for b in batches])

    port = t_kmeans.train_kmeans_stream(stream(), **args)
    jax_stream = jax_kmeans.train_kmeans_stream(stream(), mesh=mesh1, **args)
    init = jax_kmeans.train_kmeans_stream(stream(), mesh=mesh1,
                                          **dict(args, max_iter=0))
    x = np.concatenate(batches)
    jax_ram = jax_kmeans.train_kmeans(x, 8, mesh1, 20, 0,
                                      initial_centroids=init)
    np.testing.assert_allclose(port, jax_ram, rtol=0, atol=TOL)

    def assign(c):
        return np.argmin(((x[:, None, :] - c[None]) ** 2).sum(-1), axis=1)

    gap = float(np.abs(port - jax_stream).max())
    differing = int((assign(port) != assign(jax_stream)).sum())
    assert 1e-3 < gap < 1e-1, gap
    assert 50 < differing < 2000, differing
