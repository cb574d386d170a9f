"""The port's hashed features and delta publishing (``flinkml_tpu_torch.
features``) against the JAX package's, on the CPU.

The cases of ``tests/test_features.py`` (all but the FML505 analysis
fixture, which belongs to the port's analysis CLI, not ported yet) and of
``tests/test_feature_freshness.py``:

- the hash: the published murmur3 vectors, the committed golden vectors
  (``tests/golden_hash_vectors.json``) and the JAX package's bucket ids,
  bit for bit, in this process and in two child interpreters under
  different ``PYTHONHASHSEED`` values (``tests/_torch_hash_child.py``);
- row patches, ``ModelDelta``, ``HashedFMModel`` and the registry's delta
  chain, with models and deltas saved by either package loading in the
  other (fingerprint verified) and giving the same answers;
- the streaming trainer: the same batches give the JAX trainer's state
  bit for bit on one device (the host arithmetic is the same numpy, the
  lookups are exact and both scatters add in id order on the CPU), and
  within the scatter tolerance (rtol 1e-5, atol 1e-5) on P = 2 and 4 gloo
  ranks with the table sharded (``tests/_torch_mesh_worker.py
  features``), where a mesh-bound model serves the same bits on every
  rank;
- the freshness loop: a 2-replica pool follows the registry through row
  patches alone, with exact integer staleness, a replica killed mid-patch
  and a compacted chain falling back to a full load.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from flinkml_tpu import features as jfeatures
from flinkml_tpu.features.delta import ModelDelta as JDelta
from flinkml_tpu.features.model import HashedFMModel as JModel
from flinkml_tpu.table import Table as JTable
from flinkml_tpu_torch import faults
from flinkml_tpu_torch.data import ArraySource, Dataset
from flinkml_tpu_torch.embeddings.table import EmbeddingTable
from flinkml_tpu_torch.features import (
    CollisionTracker,
    DeltaPublisher,
    HashedFeature,
    HashedFMModel,
    HashVocabMismatchError,
    ModelDelta,
    StreamingHashedFMTrainer,
    check_hash_vocab,
    expected_collision_fraction,
    hash_buckets,
    murmur3_32,
)
from flinkml_tpu_torch.features.hashing import _hash_ints_vectorized, _key_bytes
from flinkml_tpu_torch.io.read_write import content_fingerprint, load_stage
from flinkml_tpu_torch.serving.engine import ServingConfig
from flinkml_tpu_torch.serving.errors import DeltaChainError
from flinkml_tpu_torch.serving.pool import ReplicaPool
from flinkml_tpu_torch.serving.registry import ModelRegistry
from flinkml_tpu_torch.table import Table
from flinkml_tpu_torch.utils.metrics import metrics
from tests import _torch_recsys_cases as cases
from tests._torch_serving_common import _on_cpu, _time_limit  # noqa: F401
from tests.test_torch_tensor_parallel import launch, same_on_every_rank

_HERE = os.path.dirname(os.path.abspath(__file__))
_GOLDEN = os.path.join(_HERE, "golden_hash_vectors.json")
SCATTER_TOL = dict(rtol=1e-5, atol=1e-5)


# -- the hash -----------------------------------------------------------------------


def test_murmur3_published_reference_vectors():
    vectors = [
        (b"", 0, 0x00000000),
        (b"", 1, 0x514E28B7),
        (b"", 0xFFFFFFFF, 0x81F16F39),
        (b"hello", 0, 0x248BFA47),
        (b"hello, world", 0, 0x149BBB7F),
        (b"The quick brown fox jumps over the lazy dog",
         0x9747B28C, 0x2FA826CD),
        (b"abc", 0, 0xB3DD93FA),
    ]
    for data, seed, want in vectors:
        assert murmur3_32(data, seed) == want, (data, seed)
        assert jfeatures.murmur3_32(data, seed) == want


def test_golden_vectors_committed():
    with open(_GOLDEN) as f:
        golden = json.load(f)
    for seed_s, entries in golden["hashes"].items():
        for key_repr, want in entries.items():
            key = eval(key_repr)  # noqa: S307 — our own committed reprs
            assert murmur3_32(_key_bytes(key), int(seed_s)) == want, (
                seed_s, key_repr)
    for buckets_s, entries in golden["buckets"].items():
        for key_repr, want in entries.items():
            key = eval(key_repr)  # noqa: S307
            got = int(hash_buckets([key], seed=42,
                                   num_buckets=int(buckets_s))[0])
            assert got == want, (buckets_s, key_repr)


def test_vectorized_int_path_bitwise_matches_scalar_and_jax():
    keys = np.array([0, 1, -1, 7, 2**31, -(2**31), 123456789,
                     2**63 - 1, -(2**63)], np.int64)
    vec = _hash_ints_vectorized(keys, 42)
    scalar = [murmur3_32(_key_bytes(int(k)), 42) for k in keys]
    assert [int(v) for v in vec] == [int(s) for s in scalar]
    big = np.random.default_rng(0).integers(-2**62, 2**62, size=(64, 7))
    for buckets in (16, 1 << 16, 1 << 20):
        got = hash_buckets(big, seed=5, num_buckets=buckets, pad_key=3)
        want = jfeatures.hash_buckets(big, seed=5, num_buckets=buckets,
                                      pad_key=3)
        assert got.dtype == np.int32 and got.tobytes() == want.tobytes()


def test_hash_buckets_range_padding_and_types():
    ids = hash_buckets(["a", "b", 17, b"raw"], seed=3, num_buckets=100)
    assert ids.dtype == np.int32
    assert ((ids >= 0) & (ids < 100)).all()
    assert ids.tobytes() == jfeatures.hash_buckets(
        ["a", "b", 17, b"raw"], seed=3, num_buckets=100).tobytes()
    padded = hash_buckets(["a", "", "b"], seed=3, num_buckets=100,
                          pad_key="")
    assert padded[1] == -1 and padded[0] == ids[0]
    assert int(hash_buckets(["xy"], seed=1, num_buckets=1000)[0]) == int(
        hash_buckets([b"xy"], seed=1, num_buckets=1000)[0])
    assert int(hash_buckets([7], seed=1, num_buckets=10**9)[0]) != int(
        hash_buckets(["7"], seed=1, num_buckets=10**9)[0])
    with pytest.raises(ValueError, match="num_buckets"):
        hash_buckets([1], seed=0, num_buckets=0)


def test_hash_determinism_across_processes_and_hashseed():
    reports = []
    for seed in ("0", "424242"):
        proc = subprocess.run(
            [sys.executable, os.path.join(_HERE, "_torch_hash_child.py")],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONHASHSEED": seed,
                 "PYTHONPATH": os.pathsep.join(
                     [os.path.dirname(_HERE)]
                     + ([os.environ["PYTHONPATH"]]
                        if os.environ.get("PYTHONPATH") else []))},
        )
        assert proc.returncode == 0, proc.stderr
        reports.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    a, b = reports
    assert a["hashes"] == b["hashes"] and a["buckets"] == b["buckets"]
    assert a["vectorized_matches_scalar"] is True
    assert a["imported_jax"] is False
    with open(_GOLDEN) as f:
        golden = json.load(f)
    assert a["hashes"] == golden["hashes"]
    assert a["buckets"] == golden["buckets"]


def test_collision_tracker_counts_and_birthday_estimate():
    tracker = CollisionTracker("torch_clicks", num_buckets=8, seed=5)
    keys = [f"user:{i}" for i in range(64)]
    tracker.observe(keys, hash_buckets(keys, seed=5, num_buckets=8))
    snap = metrics.group("features.hash", labels={
        "feature": "torch_clicks"}).snapshot()["gauges"]
    jt = jfeatures.CollisionTracker("torch_clicks_ref", num_buckets=8,
                                    seed=5)
    jt.observe(keys, jfeatures.hash_buckets(keys, seed=5, num_buckets=8))
    assert snap["keys_seen"] == 64 == jt.keys_seen
    assert snap["collisions"] == jt.collisions > 0
    assert 0.0 < snap["collision_rate"] <= 1.0
    assert expected_collision_fraction(2, 10**6) < 1e-3
    assert expected_collision_fraction(10**4, 8) > 0.99


def test_hashed_feature_as_map_and_stage_and_dataset_op():
    feature = HashedFeature(9, 128, input_col="keys",
                            output_col="hashed_ids")
    t = Table({"keys": np.array(["a", "b", "c", "a"])})
    ids = np.asarray(feature(t).column("hashed_ids"))
    assert ids.shape == (4,) and ids[0] == ids[3]
    (out2,) = feature.transform(t)
    assert np.array_equal(np.asarray(out2.column("hashed_ids")), ids)
    ds = Dataset.from_source(
        ArraySource({"keys": np.array([["a"], ["b"], ["c"], ["a"]])},
                    batch_size=2)
    ).hash_column("keys", seed=9, num_buckets=128)
    assert ds.skip_transparent
    got = np.concatenate(
        [np.asarray(b.column("hashed_ids")).reshape(-1) for b in ds])
    assert np.array_equal(got, ids)
    assert "hash(keys->hashed_ids" in ds.describe()


def test_fml505_live_gate():
    check_hash_vocab(64, 64)
    with pytest.raises(HashVocabMismatchError, match="FML505"):
        check_hash_vocab(64, 128, where="test")
    with pytest.raises(HashVocabMismatchError, match="FML505"):
        HashedFMModel.from_arrays(
            np.zeros(1), np.zeros((32, 1)), np.zeros((32, 4)),
            num_buckets=64,
        )


# -- row patches ---------------------------------------------------------------------


def test_apply_row_delta_unsharded():
    rows, ids, vals, want = cases.patch_case()
    t = EmbeddingTable("p0", 100, 8, rows=rows)
    clone = t.clone_with_row_delta(ids, vals)
    assert np.array_equal(clone.to_host(), want)
    assert np.array_equal(t.to_host(), rows), "clone mutated the original"
    t.apply_row_delta(ids, vals)
    assert np.array_equal(t.to_host(), want)


def test_apply_row_delta_validation():
    t = EmbeddingTable("p3", 10, 4, rows=np.zeros((10, 4), np.float32))
    with pytest.raises(ValueError, match="duplicate"):
        t.apply_row_delta([1, 1], np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        t.apply_row_delta([10], np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="shape"):
        t.apply_row_delta([1], np.zeros((1, 3), np.float32))


# -- ModelDelta and HashedFMModel, across packages ----------------------------


def _delta(pkg_delta):
    return pkg_delta.build(
        base_version=3, base_fingerprint="aa", result_fingerprint="bb",
        watermark=17, depth=2,
        row_deltas={"v": (np.array([2, 7], np.int32),
                          np.arange(8, dtype=np.float32).reshape(2, 4))},
        dense_deltas={"w0": np.array([0.5], np.float32)},
    )


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_model_delta_roundtrip_across_packages(tmp_path, saver):
    path = str(tmp_path / "delta")
    (_delta(ModelDelta) if saver == "port" else _delta(JDelta)).save(path)
    loaded = load_stage(path)
    assert isinstance(loaded, ModelDelta)
    assert loaded.base_version == 3 and loaded.depth == 2
    assert loaded.watermark == 17
    assert (loaded.base_fingerprint, loaded.result_fingerprint) == ("aa", "bb")
    got_ids, got_vals = loaded.row_deltas()["v"]
    assert np.array_equal(got_ids, [2, 7])
    assert np.array_equal(got_vals, np.arange(8).reshape(2, 4))
    assert np.array_equal(loaded.dense_deltas()["w0"], [0.5])
    jloaded = JDelta.load(path)
    assert jloaded.row_deltas()["v"][1].tobytes() == got_vals.tobytes()
    with pytest.raises(TypeError, match="not servable"):
        loaded.transform(Table({"x": np.zeros(1)}))
    with pytest.raises(ValueError, match="unique"):
        ModelDelta.build(
            base_version=1, base_fingerprint="", result_fingerprint="",
            watermark=0, depth=1,
            row_deltas={"v": (np.array([1, 1]), np.zeros((2, 4)))},
        )


def _fm_arrays(seed=1, b=32, k=4):
    rng = np.random.default_rng(seed)
    return (np.array([0.3], np.float32),
            rng.standard_normal((b, 1)).astype(np.float32),
            rng.standard_normal((b, k)).astype(np.float32))


def test_hashed_fm_model_margin_save_load_across_packages(tmp_path):
    w0, w, v = _fm_arrays()
    model = HashedFMModel.from_arrays(w0, w, v, num_buckets=32, hash_seed=9)
    jmodel = JModel.from_arrays(w0, w, v, num_buckets=32, hash_seed=9)
    ids = np.array([[1, 5, -1], [3, 3, 7]], np.int64)
    (out,) = model.transform(Table({"ids": ids}))
    margin = np.asarray(out.column("rawPrediction"))
    (jout,) = jmodel.transform(JTable({"ids": ids}))
    assert margin.tobytes() == np.asarray(
        jout.column("rawPrediction")).tobytes()
    sv = v[1] + v[5]
    want0 = (w0[0] + w[1, 0] + w[5, 0]
             + 0.5 * ((sv * sv) - v[1] ** 2 - v[5] ** 2).sum())
    np.testing.assert_allclose(margin[0], want0, rtol=1e-5)
    prob = np.asarray(out.column("prediction"))
    np.testing.assert_allclose(prob, 1.0 / (1.0 + np.exp(-margin)),
                               rtol=1e-6)
    model.save(str(tmp_path / "port"))
    jmodel.save(str(tmp_path / "jax"))
    for path in ("port", "jax"):
        loaded = load_stage(str(tmp_path / path))
        assert isinstance(loaded, HashedFMModel)
        assert loaded.get(HashedFMModel.HASH_SEED) == 9
        (o,) = loaded.transform(Table({"ids": ids}))
        assert np.asarray(o.column("rawPrediction")).tobytes() == \
            margin.tobytes()
    jl = JModel.load(str(tmp_path / "port"))
    assert content_fingerprint(jl.delta_state()) == content_fingerprint(
        model.delta_state())


def test_apply_delta_returns_new_model_and_rejects_unknown_leaves():
    model = HashedFMModel.from_arrays(
        np.zeros(1), np.zeros((8, 1), np.float32),
        np.zeros((8, 4), np.float32), num_buckets=8)
    delta = ModelDelta.build(
        base_version=1, base_fingerprint="", result_fingerprint="",
        watermark=1, depth=1,
        row_deltas={"v": (np.array([2]), np.ones((1, 4), np.float32))},
        dense_deltas={"w0": np.array([1.5], np.float32)},
    )
    patched = model.apply_delta(delta)
    assert patched is not model
    assert model.v[2].sum() == 0.0, "apply_delta mutated the base"
    assert np.array_equal(patched.v[2], np.ones(4, np.float32))
    assert patched.w0[0] == 1.5
    bad = ModelDelta.build(
        base_version=1, base_fingerprint="", result_fingerprint="",
        watermark=1, depth=1,
        row_deltas={"nope": (np.array([0]), np.zeros((1, 4)))},
    )
    with pytest.raises(KeyError, match="nope"):
        model.apply_delta(bad)


def test_mesh_bound_model_patches_its_tables():
    from flinkml_tpu_torch.parallel import DeviceMesh

    w0, w, v = _fm_arrays(b=16)
    model = HashedFMModel.from_arrays(w0, w, v, num_buckets=16)
    bound = model.for_mesh(DeviceMesh())
    delta = ModelDelta.build(
        base_version=1, base_fingerprint="", result_fingerprint="",
        watermark=1, depth=1,
        row_deltas={"v": (np.array([3]), np.ones((1, 4), np.float32)),
                    "w": (np.array([3]), np.ones((1, 1), np.float32))},
    )
    patched = bound.apply_delta(delta)
    ids = np.array([[3, 4, -1]], np.int64)
    (a,) = patched.transform(Table({"ids": ids}))
    (b,) = model.apply_delta(delta).transform(Table({"ids": ids}))
    assert np.asarray(a.column("rawPrediction")).tobytes() == \
        np.asarray(b.column("rawPrediction")).tobytes()
    assert bound._v_table.to_host()[3].sum() == v[3].sum()


# -- the trainer ---------------------------------------------------------------------


def _trained(n_batches=6, num_buckets=32, key_range=200, **kwargs):
    rng = np.random.default_rng(7)
    tr = StreamingHashedFMTrainer(num_buckets=num_buckets, factor_size=4,
                                  learning_rate=0.1, **kwargs)

    def feed(k):
        for _ in range(k):
            keys = rng.integers(0, key_range, size=(16, 3))
            ids = hash_buckets(keys.reshape(-1), seed=1,
                               num_buckets=num_buckets).reshape(16, 3)
            tr.fit_batch(ids, (keys.sum(axis=1) % 2).astype(np.float32))
    feed(n_batches)
    return tr, feed


def test_trainer_state_bitwise_with_jax():
    batches = cases.click_batches()
    tr = StreamingHashedFMTrainer(num_buckets=64, factor_size=4,
                                  learning_rate=0.1)
    jtr = jfeatures.StreamingHashedFMTrainer(num_buckets=64, factor_size=4,
                                             learning_rate=0.1)
    for ids, y in batches:
        assert tr.fit_batch(ids, y) == jtr.fit_batch(ids, y)
    assert tr.state_fingerprint() == jtr.state_fingerprint()
    assert np.array_equal(tr.drain_touched(), jtr.drain_touched())
    with pytest.raises(ValueError, match="FML505"):
        tr.fit_batch(np.array([[64]]), np.ones(1))


@pytest.fixture(scope="module", params=(2, 4), ids=lambda p: f"P{p}")
def sharded_trainer(request, tmp_path_factory):
    world = request.param
    return world, launch("features",
                         world, str(tmp_path_factory.mktemp(f"feat{world}")))


@pytest.mark.parametrize("strategy", ["ring", "all_to_all"])
def test_sharded_trainer_matches_one_device(sharded_trainer, strategy):
    _, outs = sharded_trainer
    jtr = jfeatures.StreamingHashedFMTrainer(num_buckets=64, factor_size=4,
                                             learning_rate=0.1)
    losses = [jtr.fit_batch(ids, y) for ids, y in cases.click_batches()]
    np.testing.assert_allclose(
        same_on_every_rank(outs, f"fm_{strategy}_losses"), losses,
        **SCATTER_TOL)
    for name, arr in jtr.delta_state().items():
        np.testing.assert_allclose(
            same_on_every_rank(outs, f"fm_{strategy}_{name}"), arr,
            **SCATTER_TOL)
    touched = jtr.drain_touched()
    assert np.array_equal(
        same_on_every_rank(outs, f"fm_{strategy}_touched"), touched)
    np.testing.assert_allclose(
        same_on_every_rank(outs, f"fm_{strategy}_rows_v"),
        jtr.rows_for(touched)["v"], **SCATTER_TOL)
    served = same_on_every_rank(outs, f"fm_{strategy}_served")
    ids = cases.click_batches(1, seed=9)[0][0]
    model = HashedFMModel.from_arrays(
        *(same_on_every_rank(outs, f"fm_{strategy}_{n}")
          for n in ("w0", "w", "v")), num_buckets=64,
        input_col="hashed_ids")
    (want,) = model.transform(Table({"hashed_ids": ids}))
    assert served.tobytes() == np.asarray(
        want.column("prediction")).tobytes()


# -- the registry's delta chain --------------------------------------------------


def test_delta_publish_resolves_bitwise_to_full_snapshot(tmp_path):
    tr, feed = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = DeltaPublisher(reg, tr, every_n_batches=1, max_depth=10)
    base = dict(reg._metrics.snapshot()["counters"])
    pub.publish_now()
    feed(3)
    pub.publish_now()
    feed(2)
    v = pub.publish_now()
    assert reg.versions() == [1, 2, 3] and v == 3
    assert pub.chain_depth == 2
    got_v, resolved = reg.get()
    assert got_v == 3
    full = tr.make_model()
    for name, arr in full.delta_state().items():
        assert np.array_equal(resolved.delta_state()[name], arr), name
    t = Table({"hashed_ids": np.array([[1, 5, 9], [2, 2, -1]], np.int64)})
    (a,) = resolved.transform(t)
    (b,) = full.transform(t)
    assert np.array_equal(np.asarray(a.column("prediction")),
                          np.asarray(b.column("prediction")))
    assert reg.watermark_of(1) == 6
    assert reg.watermark_of(3) == 11 == reg.latest_watermark()
    assert len(reg.delta_chain(1, 3)) == 2
    assert len(reg.delta_chain(2, 3)) == 1
    assert reg.delta_chain(3, 3) is None
    assert reg.delta_chain(2, 1) is None
    snap = reg._metrics.snapshot()["counters"]
    assert snap["delta_publishes"] - base.get("delta_publishes", 0) == 2
    assert snap["full_publishes"] - base.get("full_publishes", 0) == 1
    assert snap["delta_loads"] - base.get("delta_loads", 0) >= 1
    # The JAX package reads the port's registry versions.
    jdelta = JDelta.load(reg.path_of(3))
    assert jdelta.base_version == 2 and jdelta.depth == 2
    assert jdelta.get(JDelta.MODEL_CLASS) == \
        "flinkml_tpu.features.model.HashedFMModel"


def test_delta_chain_pruned_base_raises_named_error(tmp_path):
    tr, feed = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = DeltaPublisher(reg, tr, every_n_batches=1, max_depth=10)
    pub.publish_now()
    feed(1)
    pub.publish_now()
    feed(1)
    pub.publish_now()
    shutil.rmtree(reg.path_of(2))
    with pytest.raises(DeltaChainError) as exc:
        reg.get(3)
    msg = str(exc.value)
    assert "3" in msg and "2" in msg and "pruned" in msg
    _, base = reg.get(1)
    assert isinstance(base, HashedFMModel)


def test_delta_chain_corrupted_mid_chain_fingerprint(tmp_path):
    tr, feed = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = DeltaPublisher(reg, tr, every_n_batches=1, max_depth=10)
    pub.publish_now()
    feed(1)
    ids = tr.drain_touched()
    corrupted = ModelDelta.build(
        base_version=1, base_fingerprint="0" * 64,
        result_fingerprint=tr.state_fingerprint(),
        watermark=tr.watermark, depth=1,
        row_deltas={name: (ids, vals)
                    for name, vals in tr.rows_for(ids).items()},
        dense_deltas={"w0": np.asarray(tr.w0)},
    )
    reg.publish(corrupted, watermark=tr.watermark)
    with pytest.raises(DeltaChainError) as exc:
        reg.get(2)
    msg = str(exc.value)
    assert "version 2" in msg and "base 1" in msg and "fingerprint" in msg
    feed(1)
    ids = tr.drain_touched()
    lying = ModelDelta.build(
        base_version=1,
        base_fingerprint=content_fingerprint(reg.get(1)[1].delta_state()),
        result_fingerprint="f" * 64,
        watermark=tr.watermark, depth=1,
        row_deltas={name: (ids, vals)
                    for name, vals in tr.rows_for(ids).items()},
        dense_deltas={"w0": np.asarray(tr.w0)},
    )
    v = reg.publish(lying, watermark=tr.watermark)
    with pytest.raises(DeltaChainError, match="result fingerprint"):
        reg.get(v)


def test_publisher_compacts_at_max_depth_and_prices_bytes(tmp_path):
    tr, feed = _trained(num_buckets=1024, key_range=8)
    reg = ModelRegistry(str(tmp_path / "reg"))
    pub = DeltaPublisher(reg, tr, every_n_batches=1, max_depth=2,
                         name="torch_compact")
    pub.publish_now()
    for _ in range(4):
        feed(1)
        pub.publish_now()
    assert pub.chain_depth == 1
    snap = metrics.group("features.publisher",
                         labels={"publisher": "torch_compact"}).snapshot()
    assert snap["counters"]["compactions"] == 1
    assert snap["counters"]["full_publishes"] == 2
    assert snap["counters"]["delta_publishes"] == 3
    assert 0.0 < snap["gauges"]["delta_ratio"] < 1.0
    _, model = reg.get(4)
    assert isinstance(model, HashedFMModel)


# -- the freshness loop ----------------------------------------------------------------

_B, _L = 128, 3
_SEED = 11


def _stream(rng, n=16):
    keys = rng.integers(0, 5000, size=(n, _L))
    ids = hash_buckets(keys.reshape(-1), seed=_SEED,
                       num_buckets=_B).reshape(n, _L)
    return ids, (keys.sum(axis=1) % 2).astype(np.float32)


def _loop(tmp_path, name, n_replicas=2, every_n=1, max_depth=32):
    rng = np.random.default_rng(3)
    trainer = StreamingHashedFMTrainer(
        num_buckets=_B, factor_size=4, hash_seed=_SEED, learning_rate=0.1)
    registry = ModelRegistry(str(tmp_path / "reg"))
    publisher = DeltaPublisher(registry, trainer, every_n_batches=every_n,
                               max_depth=max_depth)
    trainer.fit_batch(*_stream(rng))
    publisher.publish_now()
    example = Table({"hashed_ids": np.zeros((2, _L), np.int32)})
    pool = ReplicaPool(
        registry, example, config=ServingConfig(max_batch_rows=64,
                                                max_wait_ms=1.0),
        n_replicas=n_replicas, name=name,
    ).start().follow_registry()
    return rng, trainer, registry, publisher, pool


def test_live_freshness_scenario_delta_only_hot_path(tmp_path):
    rng, tr, reg, pub, pool = _loop(tmp_path, "torch_fresh_pool")
    try:
        reg_base = dict(reg._metrics.snapshot()["counters"])
        n_publishes = 8
        for _ in range(n_publishes):
            tr.fit_batch(*_stream(rng))
            assert pub.maybe_publish() is not None
        full = tr.make_model()
        current = reg.current_version()
        assert pool.versions() == {"r0": current, "r1": current}
        for r in pool.replicas:
            counters = r.engine._metrics.snapshot()["counters"]
            assert counters["full_loads"] == 1, (r.name, counters)
            assert counters["delta_swaps"] == n_publishes, (r.name, counters)
        reg_counters = reg._metrics.snapshot()["counters"]
        assert (reg_counters.get("delta_publishes", 0)
                - reg_base.get("delta_publishes", 0)) == n_publishes
        assert (reg_counters.get("full_publishes", 0)
                - reg_base.get("full_publishes", 0)) == 0
        assert pool.freshness_lag(tr.watermark) == 0
        ids, _ = _stream(rng, n=8)
        resp = pool.predict({"hashed_ids": ids})
        assert resp.version == current
        (want,) = full.transform(Table({"hashed_ids": ids}))
        np.testing.assert_array_equal(
            resp.column("prediction"), np.asarray(want.column("prediction")))
        np.testing.assert_array_equal(
            resp.column("rawPrediction"),
            np.asarray(want.column("rawPrediction")))
    finally:
        pool.stop()


def test_staleness_accounting_is_deterministic(tmp_path):
    every_n = 3
    rng, tr, reg, pub, pool = _loop(tmp_path, "torch_stale_pool",
                                    every_n=every_n)
    try:
        for step in range(1, 8):
            tr.fit_batch(*_stream(rng))
            published = pub.maybe_publish()
            lag = pool.freshness_lag(tr.watermark)
            if published is not None:
                assert lag == 0, step
            else:
                assert 0 < lag <= every_n - 1, (step, lag)
        snap = metrics.group("serving.torch_stale_pool.freshness").snapshot()
        assert snap["gauges"]["lag_batches"] == lag
        assert snap["gauges"]["latest_watermark"] == tr.watermark
        assert pool.freshness_lag() == 0
    finally:
        pool.stop()


def test_chaos_kill_mid_patch_loses_zero_requests(tmp_path):
    rng, tr, reg, pub, pool = _loop(tmp_path, "torch_chaos_fresh")
    errors, served = [], [0]
    stop = threading.Event()

    def client(tid):
        crng = np.random.default_rng(100 + tid)
        try:
            while not stop.is_set():
                n = int(crng.integers(1, 6))
                keys = crng.integers(0, 5000, size=(n, _L))
                ids = hash_buckets(keys.reshape(-1), seed=_SEED,
                                   num_buckets=_B).reshape(n, _L)
                resp = pool.predict({"hashed_ids": ids})
                assert resp.columns["prediction"].shape == (n,)
                served[0] += 1
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    try:
        with faults.armed(faults.FaultPlan(
                faults.ReplicaDown("r0", at_batch=2))) as plan:
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for _ in range(6):
                tr.fit_batch(*_stream(rng))
                pub.maybe_publish()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if (pool.stats()["per_replica"]["r0"]["state"]
                        == "unhealthy"):
                    break
                time.sleep(0.05)
            served_at_kill = served[0]
            time.sleep(0.3)
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert served[0] > served_at_kill, "pool stopped serving after kill"
        assert pool.stats()["per_replica"]["r0"]["state"] == "unhealthy"
        assert any(site == "serving.replica" for site, _, _ in plan.log)
        assert pool.versions()["r1"] == reg.current_version()
        tr.fit_batch(*_stream(rng))
        pub.maybe_publish()
        current = reg.current_version()
        assert pool.versions()["r1"] == current
        pool.revive("r0")
        assert pool.versions() == {"r0": current, "r1": current}
        assert pool.freshness_lag(tr.watermark) == 0
    finally:
        stop.set()
        pool.stop()


def test_engine_falls_back_to_full_load_off_chain(tmp_path):
    rng, tr, reg, pub, pool = _loop(tmp_path, "torch_fallback_pool",
                                    n_replicas=1, max_depth=2)
    try:
        for _ in range(3):
            tr.fit_batch(*_stream(rng))
            pub.publish_now()
        (replica,) = pool.replicas
        counters = replica.engine._metrics.snapshot()["counters"]
        assert counters["delta_swaps"] == 2
        assert counters["full_loads"] == 2
        assert replica.engine.active_version == reg.current_version()
    finally:
        pool.stop()
