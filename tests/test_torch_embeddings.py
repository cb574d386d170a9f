"""The port's sharded embedding tables (``flinkml_tpu_torch.embeddings``)
against the JAX package's, on the CPU.

The cases of ``tests/test_embeddings.py`` but the Word2Vec and FM ones
(those models are not ported yet). The sharded cases run on P = 2 and 4
gloo ranks (``tests/_torch_mesh_worker.py embeddings``, the rank body
``tests/_torch_recsys_cases.py::embedding_cases``) over the EMBEDDING
plan's mesh ``{"data": 1, "fsdp": P/2, "tp": 2}``, and on a JAX table over
the same plan on P CPU devices. Tolerances: lookups bit for bit (one
owning shard per id, at every world size and in both packages); scatters
rtol 1e-5 and atol 1e-5 against ``np.add.at`` and JAX (the JAX tests'
own), and the unsharded scatter bit for bit with JAX's ``.at[].add``
(both add in id order on the CPU). A snapshot saved at world P restores
at world 1 bit for bit, and the JAX package's snapshot restores in the
port.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

from flinkml_tpu.embeddings import EmbeddingTable as JTable
from flinkml_tpu.iteration import CheckpointManager as JManager
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.sharding import EMBEDDING as J_EMBEDDING
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.embeddings import (
    EmbeddingTable,
    dense_vocab_threshold,
    exchange,
    resolve_exchange,
    shard_rows_for,
)
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.parallel import DeviceMesh
from flinkml_tpu_torch.sharding import (
    EMBEDDING,
    FSDP_TP,
    REPLICATED,
    is_embedding_param,
    per_device_state_bytes,
)
from flinkml_tpu_torch.table import Table
from tests import _torch_recsys_cases as cases
from tests._torch_serving_common import _on_cpu, _time_limit  # noqa: F401
from tests.test_torch_tensor_parallel import launch, same_on_every_rank

WORLDS = (2, 4)
SCATTER_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    workdir = str(tmp_path_factory.mktemp(f"embeddings{world}"))
    return world, workdir, launch("embeddings", world, workdir)


def _jtable(p, vocab=1000, dim=16, rows=None, **kw):
    mesh = JMesh.for_plan(J_EMBEDDING, devices=jax.devices()[:p])
    return JTable("t", vocab, dim, mesh=mesh, plan=J_EMBEDDING,
                  rows=cases.table_rows(vocab, dim) if rows is None else rows,
                  **kw)


# -- exchange primitives --------------------------------------------------------


def test_family_naming_convention():
    assert is_embedding_param("w2v/center_embedding")
    assert is_embedding_param("t/embedding_slot0")
    assert not is_embedding_param("coef")
    assert shard_rows_for(1000, 8) == 125
    assert shard_rows_for(1001, 8) == 126


def test_lookup_bitwise_vs_dense_across_worlds_and_packages(ranks):
    p, _, outs = ranks
    assert int(outs[0]["n_shards"]) == p
    got = same_on_every_rank(outs, "lookup")
    rows = cases.table_rows()
    ids = np.random.default_rng(1).integers(0, 1000, 512).astype(np.int32)
    assert got.tobytes() == rows[ids].tobytes()
    assert got.tobytes() == np.asarray(_jtable(p).lookup(ids)).tobytes()
    t = EmbeddingTable("t", 1000, 16, rows=rows)  # world 1
    assert t.lookup(ids).numpy().tobytes() == got.tobytes()


@pytest.mark.parametrize("strategy", ["ring", "all_to_all"])
def test_scatter_add_matches_dense_reference(ranks, strategy):
    """Both strategies reproduce the dense ``np.add.at`` scatter
    (duplicate ids included; 777 ids pad to the shard grid) and the JAX
    package's sharded scatter of the same strategy."""
    p, _, outs = ranks
    got = same_on_every_rank(outs, f"scatter_{strategy}")
    ids, delta = cases.scatter_batch()
    ref = cases.table_rows().copy()
    np.add.at(ref, ids, delta)
    np.testing.assert_allclose(got, ref, **SCATTER_TOL)
    jt = _jtable(p)
    jt.scatter_add(ids, delta, strategy=strategy)
    np.testing.assert_allclose(got, jt.to_host(), **SCATTER_TOL)


def test_unsharded_scatter_add_bitwise_with_jax():
    ids, delta = cases.scatter_batch()
    rows = cases.table_rows()
    t = EmbeddingTable("t", 1000, 16, rows=rows)
    t.scatter_add(ids, delta)
    jt = _jtable(1)
    jt.scatter_add(ids, delta)
    assert t.to_host().tobytes() == jt.to_host().tobytes()


def test_exchange_strategy_resolution(monkeypatch):
    """env > static ``ring``; dense_psum is the below-threshold placement
    and never the sharded algorithm."""
    assert resolve_exchange(10, 1) == "dense_psum"
    assert resolve_exchange(dense_vocab_threshold(), 8) == "dense_psum"
    over = dense_vocab_threshold() + 1
    assert resolve_exchange(over, 8) == "ring"
    monkeypatch.setenv("FLINKML_TPU_EMBEDDING_EXCHANGE", "all_to_all")
    assert resolve_exchange(over, 8) == "all_to_all"
    monkeypatch.setenv("FLINKML_TPU_EMBEDDING_EXCHANGE", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        resolve_exchange(over, 8)
    monkeypatch.setenv("FLINKML_TPU_EMBEDDING_EXCHANGE", "dense_psum")
    with pytest.raises(ValueError, match="vocab threshold"):
        resolve_exchange(over, 8)
    monkeypatch.delenv("FLINKML_TPU_EMBEDDING_EXCHANGE")
    monkeypatch.setenv("FLINKML_W2V_SHARD_VOCAB", "0")
    assert resolve_exchange(10, 8) == "ring"
    monkeypatch.setenv("FLINKML_TPU_EMBEDDING_DENSE_VOCAB", "20")
    assert dense_vocab_threshold() == 20


def test_scatter_add_validates_strategy_even_unsharded():
    t = EmbeddingTable("small", 16, 4, plan=REPLICATED,
                       mesh=DeviceMesh.for_plan(REPLICATED))
    assert not t.sharded
    with pytest.raises(ValueError, match="unknown exchange strategy"):
        t.scatter_add(np.zeros(2, np.int32), np.zeros((2, 4)),
                      strategy="all_to_al")


def test_footprint_model_agrees_with_padded_placement(ranks):
    """infer_plan's footprint is the largest slice, so a plan it accepts
    never fails the table's padded FML503 check at the same budget."""
    p, _, outs = ranks
    mesh = {"data": 1, "fsdp": 4, "tp": 2}
    shapes = {"edge/embedding": (8193, 64)}
    assert per_device_state_bytes(EMBEDDING, mesh, shapes,
                                  optimizer_slots=1) == 1025 * 64 * 4 * 2
    assert str(outs[0]["edge_plan"]) == "embedding"
    assert int(outs[0]["edge_shard_rows"]) == -(-8193 // p)
    assert bool(outs[0]["err_edge"])


def test_unknown_strategy_refused_in_exchange():
    axes = exchange.ShardAxes(None, (0,), 0)
    with pytest.raises(ValueError, match="dense_psum is a placement"):
        exchange.gather((), axes=axes, n_shards=8, shard_rows=1,
                        strategy="dense_psum")
    with pytest.raises(ValueError, match="dense_psum is a placement"):
        exchange.scatter_add((), (), axes=axes, n_shards=8, shard_rows=1,
                             strategy="dense_psum")


# -- refuse / route -----------------------------------------------------------------


def test_over_budget_vocab_refused_replicated_and_routed_sharded(ranks):
    p, _, outs = ranks
    assert bool(outs[0]["err_over_rep"])
    assert str(outs[0]["over_plan"]) == "embedding"
    assert bool(outs[0]["over_fits"])
    assert bool(outs[0]["err_huge"])


def test_row_splitting_plan_refused():
    with pytest.raises(ValueError, match="WHOLE rows"):
        EmbeddingTable("t", 64, 8, mesh=DeviceMesh.for_plan(FSDP_TP),
                       plan=FSDP_TP)


def test_fsdp_plan_is_a_legal_row_layout(ranks):
    p, _, outs = ranks
    assert int(outs[0]["fsdp_shards"]) == p // 2
    got = same_on_every_rank(outs, "fsdp_lookup")
    assert got.tobytes() == cases.table_rows()[:100].tobytes()


# -- checkpoint: world P -> world 1 ----------------------------------------------


def test_world_p_snapshot_restores_at_world_1_bit_equal(ranks):
    p, workdir, outs = ranks
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"), rescale="reshard")
    with open(os.path.join(workdir, "ckpt", "ckpt-7", "meta.json")) as fh:
        meta = json.load(fh)
    assert meta["layouts"] == ["sharded:0"] * 3
    t1, epoch = EmbeddingTable.restore(mgr, "t", 1001, 16, plan=EMBEDDING,
                                       optimizer_slots=2)
    assert epoch == 7 and not t1.sharded
    saved = same_on_every_rank(outs, "saved_host")
    assert t1.to_host().tobytes() == saved.tobytes()
    slots = np.stack([t1.state_dict()[t1._slot_name(i)] for i in range(2)])
    assert slots.tobytes() == outs[0]["saved_slots"].tobytes()
    q = outs[0]["saved_query"]
    assert t1.lookup(q).numpy().tobytes() == \
        same_on_every_rank(outs, "saved_lookup").tobytes()


def test_jax_snapshot_restores_in_the_port(tmp_path):
    """A table the JAX package saved (plan-derived ``sharded:0`` tags over
    its 8-device mesh) restores through the port's CheckpointManager at
    world 1, bit for bit."""
    jt = _jtable(8, vocab=1001, rows=cases.table_rows(1001),
                 optimizer_slots=1)
    rng = np.random.default_rng(3)
    jt.scatter_add(rng.integers(0, 1001, 64).astype(np.int32),
                   rng.normal(size=(64, 16)).astype(np.float32))
    jt.save(JManager(str(tmp_path), rescale="reshard"), 3)
    t, epoch = EmbeddingTable.restore(
        CheckpointManager(str(tmp_path), rescale="reshard"), "t", 1001, 16,
        optimizer_slots=1)
    assert epoch == 3
    assert t.to_host().tobytes() == jt.to_host().tobytes()


def test_restore_without_snapshot_raises(tmp_path):
    with pytest.raises(ValueError, match="no checkpoint"):
        EmbeddingTable.restore(CheckpointManager(str(tmp_path)), "t", 10, 4)


# -- row patches -----------------------------------------------------------------


def test_sharded_row_patch_bitwise_equals_fresh_placement(ranks):
    """A sharded patch is a SET on the owning shard: each rank's block
    equals a fresh placement of the patched host array, bit for bit."""
    _, _, outs = ranks
    rows, ids, vals, want = cases.patch_case()
    assert same_on_every_rank(outs, "patch_clone").tobytes() == want.tobytes()
    assert same_on_every_rank(outs, "patch_orig").tobytes() == rows.tobytes()
    for o in outs:
        assert o["local_patch_block"].tobytes() == \
            o["local_fresh_block"].tobytes()
    assert same_on_every_rank(outs, "patch_lookup").tobytes() == \
        vals.tobytes()


# -- serving ------------------------------------------------------------------------


def test_pool_serving_bitwise_stable_and_bf16_tolerance():
    from flinkml_tpu.embeddings.serving import EmbeddingLookupModel as JModel
    from flinkml_tpu.table import Table as JTable_
    from flinkml_tpu_torch.embeddings.serving import EmbeddingLookupModel
    from flinkml_tpu_torch.serving.engine import ServingConfig
    from flinkml_tpu_torch.serving.pool import ReplicaPool, slice_meshes

    rng = np.random.default_rng(4)
    vocab, dim = 2048, 16
    rows = rng.normal(size=(vocab, dim)).astype(np.float32)
    ids = rng.integers(0, vocab, size=(48, 5)).astype(np.int32)
    ids[ids % 11 == 0] = -1
    model = EmbeddingLookupModel(rows, plan=EMBEDDING,
                                 precision="mixed_inference")
    (unbound,) = EmbeddingLookupModel(
        rows, precision="mixed_inference").transform(Table({"ids": ids}))
    pool = ReplicaPool(
        model, Table({"ids": ids[:8]}),
        config=ServingConfig(max_batch_rows=64, max_wait_ms=1.0),
        meshes=slice_meshes(1, plan=EMBEDDING), output_cols=("vector",),
        name="torch_emb_test_pool",
    ).start()
    try:
        v1 = pool.predict({"ids": ids}).columns["vector"]
        v2 = pool.predict({"ids": ids}).columns["vector"]
    finally:
        pool.stop()
    assert v1.tobytes() == v2.tobytes()
    assert v1.tobytes() == np.asarray(unbound.column("vector")).tobytes()
    (jout,) = JModel(rows, precision="mixed_inference").transform(
        JTable_({"ids": ids}))
    # bfloat16 rows summed one id at a time at bfloat16: JAX's bits.
    assert v1.tobytes() == np.asarray(jout.column("vector"),
                                      np.float32).tobytes()
    (f32,) = EmbeddingLookupModel(rows, precision=None).transform(
        Table({"ids": ids}))
    diff = np.abs(v1 - np.asarray(f32.column("vector"))).max()
    assert 0 < diff < 0.05, diff  # bfloat16 really engaged, and bounded


def test_engine_binds_for_mesh_models_at_install():
    from flinkml_tpu_torch.embeddings.serving import EmbeddingLookupModel
    from flinkml_tpu_torch.serving.engine import ServingConfig, ServingEngine

    rows = cases.table_rows(64, 4)
    model = EmbeddingLookupModel(rows, precision=None)
    engine = ServingEngine(model, Table({"ids": np.zeros((2, 3), np.int32)}),
                           config=ServingConfig(mesh=DeviceMesh()))
    engine.start()
    try:
        active = engine._active.model
        assert active is not model and active._table is not None
        got = engine.predict({"ids": np.array([[1, 2, -1]], np.int32)})
    finally:
        engine.stop()
    np.testing.assert_allclose(got.columns["vector"][0],
                               (rows[1] + rows[2]) / 2, rtol=1e-6)


def test_slice_meshes_plan_shaping():
    from flinkml_tpu_torch.serving.pool import slice_meshes

    (mesh,) = slice_meshes(1, plan=EMBEDDING)
    assert mesh.shape == {"data": 1, "fsdp": 1, "tp": 1}
    (flat,) = slice_meshes(1)
    assert flat.shape == {"data": 1}


# -- ALS: refusal and factor export ---------------------------------------------


def test_als_fit_refuses_sharding_plan():
    from flinkml_tpu_torch.models.als import ALS

    with pytest.raises(ValueError, match="normal-equation buffers"):
        ALS(sharding_plan=EMBEDDING).fit(Table({
            "user": np.zeros(4, np.int64),
            "item": np.zeros(4, np.int64),
            "rating": np.ones(4),
        }))


def test_als_factor_tables_export_sharded(ranks):
    _, _, outs = ranks
    assert bool(outs[0]["als_sharded"])
    host = same_on_every_rank(outs, "als_host")
    user_f = np.random.default_rng(5).normal(size=(37, 4)).astype(np.float32)
    assert host.tobytes() == user_f.tobytes()
    assert same_on_every_rank(outs, "als_lookup").tobytes() == host.tobytes()


def test_als_factor_tables_world_1():
    from flinkml_tpu_torch.models.als import ALS

    rng = np.random.default_rng(0)
    with use_device("cpu"):
        model = ALS().set_max_iter(2).fit(Table({
            "user": rng.integers(0, 20, 200),
            "item": rng.integers(0, 16, 200),
            "rating": rng.random(200) * 5,
        }))
        user_t, item_t = model.factor_tables(plan=EMBEDDING)
    assert not user_t.sharded
    np.testing.assert_allclose(user_t.to_host(),
                               model.user_factors.astype(np.float32),
                               rtol=1e-6, atol=1e-7)
    ids = np.arange(len(model.item_factors))
    assert item_t.lookup(ids).numpy().tobytes() == \
        item_t.to_host()[ids].tobytes()


def test_lookup_model_rows_carry_across_from_jax():
    from flinkml_tpu.embeddings.serving import EmbeddingLookupModel as JModel
    from flinkml_tpu.table import Table as JTable_
    from flinkml_tpu_torch.io.read_write import stage_from_arrays

    rows = cases.table_rows(64, 8)
    jmodel = JModel(rows)
    model = stage_from_arrays(
        "flinkml_tpu.embeddings.serving.EmbeddingLookupModel", {},
        {"rows": jmodel._rows})
    ids = np.array([[1, 2, 3], [4, -1, -1]], np.int32)
    (got,) = model.transform(Table({"ids": ids}))
    (want,) = jmodel.transform(JTable_({"ids": ids}))
    assert np.asarray(got.column("vector")).tobytes() == np.asarray(
        want.column("vector"), np.float32).tobytes()
