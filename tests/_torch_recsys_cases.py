"""The multi-rank cases of the port's tensor parallelism, ring attention,
embedding tables, hashed features and ALS, run by ``tests/
_torch_mesh_worker.py`` (modes ``tensor``, ``ring``, ``embeddings``,
``features``, ``als`` and ``recsys_b``: Word2Vec, FM and MLP) on P gloo
ranks on the CPU.

Imports numpy, torch and the port only. The input builders are shared
with the tests, which feed the same numpy inputs to the JAX package on a
P-device mesh of the conftest's CPU devices. A case's outputs are numpy
arrays; an expected refusal is recorded as its message (a 0-d string
array). Outputs whose name starts with ``local_`` are this rank's own.
"""

from __future__ import annotations

import numpy as np

# -- tensor parallelism ------------------------------------------------------


def mlp_inputs(seed=0, n=32, d_in=16, d_ff=64, d_out=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(n, d_in)).astype(f),
            rng.normal(size=(d_in, d_ff)).astype(f),
            rng.normal(size=(d_ff,)).astype(f),
            rng.normal(size=(d_ff, d_out)).astype(f),
            rng.normal(size=(d_out,)).astype(f))


def pipeline_inputs(n_stages, seed=2, n_mb=6, b=4, d=8, scale=0.3):
    rng = np.random.default_rng(seed)
    params = (rng.normal(size=(n_stages, d, d)) * scale).astype(np.float32)
    x = rng.normal(size=(n_mb, b, d)).astype(np.float32)
    return x, params


def expert_inputs(e, seed=4, n=16, d_in=8, d_ff=32, d_out=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    w1 = (rng.normal(size=(e, d_in, d_ff)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(e, d_ff, d_out)) * 0.3).astype(np.float32)
    logits = rng.normal(size=(n, e)).astype(np.float32)
    return x, logits, w1, w2


def softmax(logits):
    z = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return (z / z.sum(axis=-1, keepdims=True)).astype(np.float32)


def routed_inputs(e, seed=8, n_per=8, d=4, ff=8):
    rng = np.random.default_rng(seed)
    n = n_per * e
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = (rng.normal(size=(n, e)) * 2).astype(np.float32)
    w1 = (rng.normal(size=(e, d, ff)) * 0.4).astype(np.float32)
    w2 = (rng.normal(size=(e, ff, d)) * 0.4).astype(np.float32)
    return x, logits, w1, w2


def routed_bf16_inputs(e, seed=10, per=320, d=4):
    """320 tokens a rank, every one routed to expert 0 (the int32 slot
    counting regression): float32 values exactly representable in
    bfloat16."""
    rng = np.random.default_rng(seed)
    n = e * per

    def bf16(a):  # round to bfloat16 by truncation of the float32 bits
        bits = np.asarray(a, np.float32).view(np.uint32) & 0xFFFF0000
        return bits.view(np.float32)

    x = bf16(rng.normal(size=(n, d)))
    logits = np.full((n, e), -10.0, np.float32)
    logits[:, 0] = 10.0
    w1 = bf16(rng.normal(size=(e, d, 8)) * 0.3)
    w2 = bf16(rng.normal(size=(e, 8, d)) * 0.3)
    return x, logits, w1, w2


def _refusal(fn) -> np.ndarray:
    try:
        fn()
    except ValueError as e:
        return np.asarray(str(e))
    return np.asarray("")


def _np(t) -> np.ndarray:
    import torch

    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def tensor_cases(world: int) -> dict:
    import torch

    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.parallel import tensor as tp

    out = {}
    p = world
    z = np.zeros
    out["tp_mlp"] = _np(tp.tensor_parallel_mlp(
        *mlp_inputs(), DeviceMesh({"model": p}), axis="model"))
    out["tp_mlp_2d"] = _np(tp.tensor_parallel_mlp(
        *mlp_inputs(1, n=8, d_in=4, d_ff=16, d_out=4),
        DeviceMesh({"data": 2, "model": p // 2}), axis="model"))
    out["err_d_ff"] = _refusal(lambda: tp.tensor_parallel_mlp(
        z((2, 4), np.float32), z((4, 4 * p + 1), np.float32),
        z(4 * p + 1, np.float32), z((4 * p + 1, 4), np.float32),
        z(4, np.float32), DeviceMesh({"model": p})))
    out["err_axis"] = _refusal(lambda: tp.tensor_parallel_mlp(
        z((2, 4), np.float32), z((4, 8), np.float32), z(8, np.float32),
        z((8, 4), np.float32), z(4, np.float32), DeviceMesh({"data": p}),
        axis="model"))
    x, params = pipeline_inputs(p)
    out["pipeline"] = _np(tp.pipeline_parallel_apply(
        x, params, stage="linear_tanh", mesh=DeviceMesh({"pipe": p})))
    out["err_stages"] = _refusal(lambda: tp.pipeline_parallel_apply(
        z((2, 2, 4), np.float32), z((p + 1, 4, 4), np.float32),
        stage="linear_tanh", mesh=DeviceMesh({"pipe": p})))
    out["err_unknown_stage"] = _refusal(lambda: tp.pipeline_parallel_apply(
        z((2, 2, 4), np.float32), z((p, 4, 4), np.float32), stage="nope",
        mesh=DeviceMesh({"pipe": p})))
    tp.register_pipeline_stage(
        "affine_relu", lambda a, w: torch.clamp_min(a @ w, 0))
    x, params = pipeline_inputs(p, seed=3, n_mb=3, b=2, d=4, scale=0.4)
    out["pipeline_custom"] = _np(tp.pipeline_parallel_apply(
        x, params, stage="affine_relu", mesh=DeviceMesh({"pipe": p})))
    x, logits, w1, w2 = expert_inputs(p)
    out["expert_dense"] = _np(tp.expert_parallel_ffn(
        x, softmax(logits), w1, w2, DeviceMesh({"expert": p})))
    assign = np.random.default_rng(5).integers(0, p, size=x.shape[0])
    gates = np.eye(p, dtype=np.float32)[assign]
    out["expert_top1"] = _np(tp.expert_parallel_ffn(
        x, gates, w1, w2, DeviceMesh({"expert": p})))
    out["err_expert_count"] = _refusal(lambda: tp.expert_parallel_ffn(
        z((2, 4), np.float32), z((2, p + 1), np.float32),
        z((p + 1, 4, 8), np.float32), z((p + 1, 8, 4), np.float32),
        DeviceMesh({"expert": p})))
    x, params = pipeline_inputs(p // 2, seed=6, n_mb=3, b=2, d=5)
    out["pipeline_2d"] = _np(tp.pipeline_parallel_apply(
        x, params, stage="linear_tanh",
        mesh=DeviceMesh({"data": 2, "pipe": p // 2}), axis="pipe"))
    x, logits, w1, w2 = expert_inputs(p // 2, seed=7, n=6, d_in=4, d_ff=8,
                                      d_out=4)
    out["expert_2d"] = _np(tp.expert_parallel_ffn(
        x, softmax(logits), w1, w2,
        DeviceMesh({"data": 2, "expert": p // 2}), axis="expert"))
    tp.register_pipeline_stage("mutable_stage", lambda a, w: a @ w)
    eye = np.stack([np.eye(4, dtype=np.float32)] * p)
    ones = np.ones((2, 2, 4), np.float32)
    out["restage_1"] = _np(tp.pipeline_parallel_apply(
        ones, eye, "mutable_stage", DeviceMesh({"pipe": p})))
    tp.register_pipeline_stage("mutable_stage", lambda a, w: (a @ w) * 2.0)
    out["restage_2"] = _np(tp.pipeline_parallel_apply(
        ones, eye, "mutable_stage", DeviceMesh({"pipe": p})))
    x, logits, w1, w2 = routed_inputs(p)
    out["routed_drops"] = _np(tp.routed_expert_ffn(
        x, logits, w1, w2, DeviceMesh({"expert": p}), capacity_factor=0.5))
    out["routed_no_drops"] = _np(tp.routed_expert_ffn(
        x, logits, w1, w2, DeviceMesh({"expert": p}),
        capacity_factor=100.0))
    probs = softmax(logits)
    gates = (np.eye(p, dtype=np.float32)[probs.argmax(-1)]
             * probs.max(-1)[:, None])
    out["routed_dense_top1"] = _np(tp.expert_parallel_ffn(
        x, gates, w1, w2, DeviceMesh({"expert": p})))
    out["err_routed"] = _refusal(lambda: tp.routed_expert_ffn(
        z((8, 4), np.float32), z((8, p + 1), np.float32),
        z((p + 1, 4, 8), np.float32), z((p + 1, 8, 4), np.float32),
        DeviceMesh({"expert": p})))
    x, logits, w1, w2 = routed_bf16_inputs(p)
    bf = torch.bfloat16
    out["routed_bf16"] = _np(tp.routed_expert_ffn(
        torch.from_numpy(x).to(bf), torch.from_numpy(logits).to(bf),
        torch.from_numpy(w1).to(bf), torch.from_numpy(w2).to(bf),
        DeviceMesh({"expert": p}), capacity_factor=float(p)))
    return out


# -- ring attention ----------------------------------------------------------


def qkv(b=2, h=8, l=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, l, d)).astype(np.float32)
                 for _ in range(3))


def ring_cases(world: int) -> dict:
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.parallel.ring import ring_attention, ulysses_attention

    mesh = DeviceMesh()
    out = {}
    q, k, v = qkv()
    for causal in (False, True):
        out[f"ring_{causal}"] = _np(ring_attention(q, k, v, mesh,
                                                   causal=causal))
        out[f"ulysses_{causal}"] = _np(ulysses_attention(q, k, v, mesh,
                                                         causal=causal))
    q, k, v = qkv(b=1, h=2, l=128, d=8, seed=3)
    out["ring_long"] = _np(ring_attention(q, k, v, mesh, causal=True))
    q, k, v = qkv(h=6 if world == 4 else 3)
    out["err_heads"] = _refusal(lambda: ulysses_attention(q, k, v, mesh))
    q, k, v = qkv(l=62 if world == 4 else 63)
    out["err_seq"] = _refusal(lambda: ring_attention(q, k, v, mesh))
    q3 = np.zeros((4, 8, 16), np.float32)
    out["err_rank"] = _refusal(lambda: ring_attention(q3, q3, q3, mesh))
    q, k, v = qkv(b=1, h=1, l=64, d=4, seed=9)
    out["ring_first_token"] = _np(ring_attention(q, k, v, mesh,
                                                 causal=True))
    q, k, v = qkv(b=1, h=8, l=64, d=8, seed=4)
    seq = DeviceMesh({"seq": world})
    out["ring_seq_axis"] = _np(ring_attention(q, k, v, seq, causal=True))
    out["ulysses_seq_axis"] = _np(ulysses_attention(q, k, v, seq,
                                                    causal=False))
    return out


# -- embedding tables --------------------------------------------------------


def table_rows(vocab=1000, dim=16, seed=0):
    return np.random.default_rng(seed).normal(
        size=(vocab, dim)).astype(np.float32)


def scatter_batch(vocab=1000, dim=16, seed=2, m=777):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, m).astype(np.int32),
            rng.normal(size=(m, dim)).astype(np.float32))


def embedding_cases(world: int, workdir: str) -> dict:
    from flinkml_tpu_torch.embeddings import EmbeddingTable
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.sharding import EMBEDDING, FSDP, REPLICATED
    from flinkml_tpu_torch.sharding import NoFeasiblePlanError
    from flinkml_tpu_torch.sharding.apply import PlanValidationError

    mesh = DeviceMesh.for_plan(EMBEDDING)
    out = {}
    rows = table_rows()
    t = EmbeddingTable("t", 1000, 16, mesh=mesh, plan=EMBEDDING, rows=rows)
    ids = np.random.default_rng(1).integers(0, 1000, 512).astype(np.int32)
    out["n_shards"] = np.asarray(t.n_shards)
    out["lookup"] = _np(t.lookup(ids))
    sids, delta = scatter_batch()
    for strategy in ("ring", "all_to_all"):
        t = EmbeddingTable("t", 1000, 16, mesh=mesh, plan=EMBEDDING,
                           rows=rows)
        t.scatter_add(sids, delta, strategy=strategy)
        out[f"scatter_{strategy}"] = t.to_host()
    # infer_plan's footprint equals the padded placement's at the edge.
    vocab, dim = 8193, 64
    shard_rows = -(-vocab // world)
    padded = shard_rows * dim * 4 * 2
    t = EmbeddingTable("edge", vocab, dim, mesh=mesh,
                       hbm_budget_bytes=padded, optimizer_slots=1)
    out["edge_plan"] = np.asarray(t.plan.name)
    out["edge_shard_rows"] = np.asarray(t.shard_rows)
    out["err_edge"] = np.asarray(_raises(
        lambda: EmbeddingTable("edge", vocab, dim, mesh=mesh,
                               hbm_budget_bytes=padded - 1,
                               optimizer_slots=1), NoFeasiblePlanError))
    # The over-budget contract: refused replicated, routed sharded.
    vocab, dim = 1 << 14, 16
    rep_bytes = vocab * dim * 4 * 2
    budget = rep_bytes // world  # over at 1 shard, fits at P
    out["err_over_rep"] = np.asarray(_raises(
        lambda: EmbeddingTable("big", vocab, dim, mesh=mesh, plan=REPLICATED,
                               hbm_budget_bytes=budget, optimizer_slots=1),
        PlanValidationError, "FML503"))
    t = EmbeddingTable("big/embedding_probe", vocab, dim, mesh=mesh,
                       hbm_budget_bytes=budget, optimizer_slots=1)
    out["over_plan"] = np.asarray(t.plan.name)
    out["over_fits"] = np.asarray(t.per_device_bytes() <= budget)
    out["err_huge"] = np.asarray(_raises(
        lambda: EmbeddingTable("huge/embedding_probe", vocab, dim,
                               mesh=mesh, hbm_budget_bytes=rep_bytes // 64,
                               optimizer_slots=1), NoFeasiblePlanError))
    # FSDP shards rows over fsdp alone.
    t = EmbeddingTable("t", 1000, 16, mesh=mesh, plan=FSDP, rows=rows)
    out["fsdp_shards"] = np.asarray(t.n_shards)
    out["fsdp_lookup"] = _np(t.lookup(np.arange(100)))
    # A snapshot at world P (restored at world 1 by the test).
    t = EmbeddingTable("t", 1001, 16, mesh=mesh, plan=EMBEDDING,
                       rows=table_rows(1001), optimizer_slots=2)
    rng = np.random.default_rng(3)
    t.scatter_add(rng.integers(0, 1001, 256).astype(np.int32),
                  rng.normal(size=(256, 16)).astype(np.float32))
    t.save(CheckpointManager(f"{workdir}/ckpt", rescale="reshard"), 7)
    out["saved_host"] = t.to_host()
    out["saved_slots"] = np.stack([t.state_dict()[t._slot_name(i)]
                                   for i in range(2)])
    q = rng.integers(0, 1001, 64).astype(np.int32)
    out["saved_query"] = q
    out["saved_lookup"] = _np(t.lookup(q))
    # Row patches: a SET on the owning shard equals a fresh placement.
    prow, pids, pvals, want = patch_case()
    t = EmbeddingTable("p1", 100, 8, mesh=mesh, plan=EMBEDDING, rows=prow)
    clone = t.clone_with_row_delta(pids, pvals)
    fresh = EmbeddingTable("p2", 100, 8, mesh=mesh, plan=EMBEDDING,
                           rows=want)
    out["patch_clone"] = clone.to_host()
    out["patch_orig"] = t.to_host()
    out["local_patch_block"] = _np(clone.rows)
    out["local_fresh_block"] = _np(fresh.rows)
    out["patch_lookup"] = _np(clone.lookup(pids))
    # ALS factors exported sharded.
    user_f = np.random.default_rng(5).normal(size=(37, 4))
    ut = EmbeddingTable("als/user", 37, 4, mesh=mesh, plan=EMBEDDING,
                        rows=user_f.astype(np.float32))
    out["als_sharded"] = np.asarray(ut.sharded)
    out["als_host"] = ut.to_host()
    out["als_lookup"] = _np(ut.lookup(np.arange(37)))
    return out


def _raises(fn, exc, match: str = "") -> bool:
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def patch_case():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((100, 8)).astype(np.float32)
    ids = np.array([0, 5, 13, 57, 99], np.int32)
    vals = rng.standard_normal((5, 8)).astype(np.float32)
    want = rows.copy()
    want[ids] = vals
    return rows, ids, vals, want


# -- hashed features (a sharded trainer) ---------------------------------------


def click_batches(n_batches=6, num_buckets=64, key_range=300, seed=7):
    from flinkml_tpu_torch.features import hash_buckets

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        keys = rng.integers(0, key_range, size=(16, 3))
        ids = hash_buckets(keys.reshape(-1), seed=1,
                           num_buckets=num_buckets).reshape(16, 3)
        ids[keys % 13 == 0] = -1
        out.append((ids, (keys.sum(axis=1) % 2).astype(np.float32)))
    return out


def feature_cases(world: int) -> dict:
    from flinkml_tpu_torch.features import StreamingHashedFMTrainer
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.sharding import EMBEDDING

    out = {}
    mesh = DeviceMesh.for_plan(EMBEDDING)
    for strategy in ("ring", "all_to_all"):
        import os

        os.environ["FLINKML_TPU_EMBEDDING_EXCHANGE"] = strategy
        tr = StreamingHashedFMTrainer(num_buckets=64, factor_size=4,
                                      learning_rate=0.1, mesh=mesh,
                                      plan=EMBEDDING)
        losses = [tr.fit_batch(ids, y) for ids, y in click_batches()]
        state = tr.delta_state()
        out[f"fm_{strategy}_losses"] = np.asarray(losses)
        for name, arr in state.items():
            out[f"fm_{strategy}_{name}"] = arr
        touched = tr.drain_touched()
        out[f"fm_{strategy}_touched"] = touched
        rows = tr.rows_for(touched)
        out[f"fm_{strategy}_rows_v"] = rows["v"]
        model = tr.make_model().for_mesh(mesh)
        from flinkml_tpu_torch.table import Table

        ids = click_batches(1, seed=9)[0][0]
        (pred,) = model.transform(Table({"hashed_ids": ids}))
        out[f"fm_{strategy}_served"] = np.asarray(pred.column("prediction"))
        del os.environ["FLINKML_TPU_EMBEDDING_EXCHANGE"]
    return out


# -- ALS -----------------------------------------------------------------------


def als_ratings(seed=7, nnz=3000, n_users=64, n_items=50):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, size=nnz).astype(np.int64),
            rng.integers(0, n_items, size=nnz).astype(np.int64),
            rng.uniform(1, 5, size=nnz).astype(np.float32))


def rating_batches(n_users=40, n_items=30, rank=3, per_batch=256,
                   n_batches=4, seed=0):
    """The JAX package's streamed-fit batches
    (``tests/test_stream_fit_recsys.py``)."""
    rng = np.random.default_rng(seed)
    uf = rng.normal(size=(n_users, rank))
    vf = rng.normal(size=(n_items, rank))
    out = []
    for _ in range(n_batches):
        u = rng.integers(0, n_users, size=per_batch).astype(np.int64)
        i = rng.integers(0, n_items, size=per_batch).astype(np.int64)
        r = np.einsum("nk,nk->n", uf[u], vf[i]).astype(np.float32)
        out.append({"user": u, "item": i, "rating": r})
    return out


def als_estimator(**kw):
    from flinkml_tpu_torch.models.als import ALS

    return ALS(**kw).set_rank(4).set_max_iter(5).set_reg_param(0.05) \
        .set_seed(0)


def als_cases(mesh, rank: int, world: int, workdir: str) -> dict:
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import cache_stream
    from flinkml_tpu_torch.models.als import ALS
    from flinkml_tpu_torch.table import Table

    out = {}
    u, i, r = als_ratings()
    t = Table({"user": u, "item": i, "rating": r})
    for layout in ("segment", "cumsum"):
        for implicit in (False, True):
            est = ALS(mesh=mesh, layout=layout).set_rank(6).set_max_iter(4) \
                .set_seed(0).set_implicit_prefs(implicit)
            m = est.fit(t)
            out[f"inram_{layout}_{implicit}_user"] = m.user_factors
            out[f"inram_{layout}_{implicit}_item"] = m.item_factors
    # The streamed fit: each rank feeds its own batches.
    batches = rating_batches(n_batches=2 * world)[rank::world]
    cache = cache_stream(iter(batches))
    golden = als_estimator(mesh=mesh).set_max_iter(6).fit(cache)
    out["stream_user"] = golden.user_factors
    out["stream_item"] = golden.item_factors
    spilled = als_estimator(
        mesh=mesh, cache_dir=f"{workdir}/spill{rank}",
        cache_memory_budget_bytes=1).set_max_iter(6).fit(
            iter([Table(b) for b in batches]))
    out["spill_user"] = spilled.user_factors
    # Stopped after 2 iterations (its last snapshot), then resumed to 6.
    ckpt = f"{workdir}/ckpt"
    als_estimator(mesh=mesh, checkpoint_manager=CheckpointManager(ckpt),
                  checkpoint_interval=2).set_max_iter(2).fit(cache)
    rec = als_estimator(mesh=mesh, checkpoint_manager=CheckpointManager(ckpt),
                        checkpoint_interval=2, resume=True).set_max_iter(
                            6).fit(cache)
    out["resume_user"] = rec.user_factors
    out["resume_item"] = rec.item_factors
    return out


# -- Word2Vec, FM and MLP (mode recsys_b) ------------------------------------


def w2v_corpus(seed=3):
    """``tests/test_embeddings.py``'s Word2Vec corpus: two topics."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow", "sheep", "goat"]
    tools = ["hammer", "saw", "drill", "wrench", "screw", "nail"]
    docs = []
    for _ in range(120):
        pool = animals if rng.random() < 0.5 else tools
        docs.append(list(rng.choice(pool, size=8)))
    return docs


def fm_data(n=512, d=24, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    true = rng.normal(size=d)
    return x, (x @ true > 0).astype(np.float64)


def adam_batches(n_batches=4, rows=64, d=6, seed=0):
    """``tests/test_stream_fit_mlp_pca.py``'s MLP/FM stream batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = rng.normal(size=(rows, d)).astype(np.float32)
        y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
        out.append({"features": x, "label": y})
    return out


def sentence_docs(n_batches=3, per_batch=40, seed=0):
    """``tests/test_stream_fit_recsys.py``'s token batches (two cliques)."""
    rng = np.random.default_rng(seed)
    cliques = [[f"a{i}" for i in range(6)], [f"b{i}" for i in range(6)]]
    return [[list(rng.choice(cliques[rng.integers(0, 2)], size=8))
             for _ in range(per_batch)] for _ in range(n_batches)]


def token_table(docs, table_cls):
    col = np.empty(len(docs), dtype=object)
    col[:] = [list(d) for d in docs]
    return table_cls({"tokens": col})


def w2v_estimator(cls, **kw):
    return (cls(**kw).set_input_col("tokens").set_vector_size(16)
            .set_window_size(2).set_min_count(1).set_max_iter(3)
            .set_seed(0))


def mlp_estimator(cls, **kw):
    return (cls(**kw).set_layers([6, 8, 2]).set_max_iter(6)
            .set_global_batch_size(64).set_learning_rate(0.05).set_tol(0.0)
            .set_seed(0))


def fm_estimator(cls, **kw):
    return (cls(**kw).set_factor_size(4).set_max_iter(6)
            .set_global_batch_size(64).set_learning_rate(0.05)
            .set_reg(0.001).set_tol(0.0).set_seed(0))


def _with_env(env: dict, fn):
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def recsys_b_cases(mesh, rank: int, world: int, workdir: str) -> dict:
    """Word2Vec's dense and sharded trainers, FM's sharded factors, and
    the streamed Word2Vec, MLP and FM fits on ``world`` ranks."""
    from flinkml_tpu_torch.iteration import CheckpointManager
    from flinkml_tpu_torch.iteration.datacache import cache_stream
    from flinkml_tpu_torch.models import (
        FMClassifier,
        FMRegressor,
        MLPClassifier,
        Word2Vec,
    )
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.sharding.plan import EMBEDDING, FSDP
    from flinkml_tpu_torch.table import Table

    out = {}
    # -- Word2Vec in RAM: dense, then sharded under both strategies.
    col = np.empty(120, dtype=object)
    col[:] = w2v_corpus()
    t = Table({"doc": col})

    def w2v_fit(dim=12, iters=2, corpus=t):
        return Word2Vec(mesh=mesh).set_input_col("doc").set_vector_size(dim) \
            .set_max_iter(iters).set_min_count(1).set_seed(0).fit(corpus)

    out["w2v_dense"] = w2v_fit().vectors
    for strategy in ("ring", "all_to_all"):
        env = {"FLINKML_W2V_SHARD_VOCAB": "0",
               "FLINKML_TPU_EMBEDDING_EXCHANGE": strategy}
        out[f"w2v_sharded_{strategy}"] = _with_env(env, w2v_fit).vectors
        col5 = np.empty(120, dtype=object)
        col5[:] = w2v_corpus(seed=5)
        out[f"w2v_seed5_{strategy}"] = _with_env(
            env, lambda: w2v_fit(8, 1, Table({"doc": col5}))).vectors
    # -- FM: the replicated fit on the data mesh, the sharded factor fits.
    x, y = fm_data()
    ft = Table({"features": x, "label": y})
    dense = FMClassifier(mesh=mesh).set_max_iter(40) \
        .set_global_batch_size(256).set_seed(0).fit(ft)
    shard = FMClassifier(sharding_plan=EMBEDDING,
                         mesh=DeviceMesh.for_plan(EMBEDDING)).set_max_iter(40) \
        .set_global_batch_size(256).set_seed(0).fit(ft)
    out["fm_dense_pred"] = dense.transform(ft)[0]["prediction"]
    out["fm_shard_pred"] = shard.transform(ft)[0]["prediction"]
    out["fm_shard_v"] = shard._v
    x2, _ = fm_data(seed=2)
    lt = Table({"features": x2, "label": x2[:, 0] + 1.0})
    one = dict(max_iter=1, global_batch_size=256, seed=0)
    for name, plan in (("dense", None), ("fsdp", FSDP)):
        kw = {"mesh": mesh} if plan is None else {
            "sharding_plan": plan, "mesh": DeviceMesh.for_plan(plan)}
        est = FMRegressor(**kw)
        for k, v in one.items():
            getattr(est, f"set_{k}")(v)
        m = est.fit(lt)
        out[f"fm_step_{name}_w0"] = np.asarray([m._w0])
        out[f"fm_step_{name}_w"] = m._w
    # -- MLP in RAM on the data mesh: 5 steps.
    rng = np.random.default_rng(3)
    xm = rng.normal(size=(300, 6))
    ym = rng.integers(0, 3, 300).astype(np.float64)
    mlp = MLPClassifier(mesh=mesh).set_layers([6, 12, 3]).set_max_iter(5) \
        .set_learning_rate(0.05).set_global_batch_size(64).set_tol(0.0) \
        .set_seed(0).fit(Table({"features": xm, "label": ym}))
    for i, a in enumerate(mlp._weights):
        out[f"mlp_inram_{i}"] = a
    # -- the streamed fits: each rank feeds its own partition.
    mine = adam_batches(n_batches=2 * world)[rank::world]
    for name, est_cls, make in (("mlp", MLPClassifier, mlp_estimator),
                                ("fm", FMClassifier, fm_estimator)):
        ram = make(est_cls, mesh=mesh).fit(iter(Table(b) for b in mine))
        spill = make(est_cls, mesh=mesh, cache_dir=f"{workdir}/{name}{rank}",
                     cache_memory_budget_bytes=1).fit(
            iter(Table(b) for b in mine))
        for i, (a, b) in enumerate(zip(_flat_model(ram), _flat_model(spill))):
            out[f"{name}_stream_{i}"] = a
            out[f"{name}_spill_{i}"] = b
        ylab = np.int32 if name == "mlp" else np.float32
        cache = cache_stream(
            {"x": b["features"], "y": b["label"].astype(ylab),
             "w": np.ones(len(b["label"]), np.float32)} for b in mine)
        golden = make(est_cls, mesh=mesh).fit(cache)
        ckpt = f"{workdir}/{name}_ckpt"
        make(est_cls, mesh=mesh, checkpoint_manager=CheckpointManager(ckpt),
             checkpoint_interval=2).set_max_iter(2).fit(cache)
        rec = make(est_cls, mesh=mesh,
                   checkpoint_manager=CheckpointManager(ckpt),
                   checkpoint_interval=2, resume=True).fit(cache)
        for i, (a, b) in enumerate(zip(_flat_model(golden),
                                       _flat_model(rec))):
            out[f"{name}_golden_{i}"] = a
            out[f"{name}_resumed_{i}"] = b
        learn = make(est_cls, mesh=mesh).set_max_iter(25).fit(
            iter(Table(b) for b in adam_batches(n_batches=2 * world,
                                                seed=1)[rank::world]))
        probe = np.concatenate([b["features"] for b in adam_batches(
            n_batches=2 * world, seed=1)])
        out[f"{name}_learn_pred"] = learn.transform(
            Table({"features": probe}))[0]["prediction"]
    # Word2Vec streamed: each rank its own documents.
    sdocs = sentence_docs(n_batches=2 * world)[rank::world]
    tables = lambda: iter(token_table(d, Table) for d in sdocs)  # noqa: E731
    ram = w2v_estimator(Word2Vec, mesh=mesh).fit(tables())
    spill = w2v_estimator(Word2Vec, mesh=mesh,
                          cache_dir=f"{workdir}/w2v{rank}",
                          cache_memory_budget_bytes=1).fit(tables())
    out["w2v_stream"] = ram.vectors
    out["w2v_stream_vocab"] = np.asarray(ram.vocabulary, dtype=str)
    out["w2v_spill"] = spill.vectors
    golden = w2v_estimator(Word2Vec, mesh=mesh).set_max_iter(4).fit(tables())
    ckpt = f"{workdir}/w2v_ckpt"
    w2v_estimator(Word2Vec, mesh=mesh,
                  checkpoint_manager=CheckpointManager(ckpt),
                  checkpoint_interval=2).set_max_iter(2).fit(tables())
    rec = w2v_estimator(Word2Vec, mesh=mesh,
                        checkpoint_manager=CheckpointManager(ckpt),
                        checkpoint_interval=2, resume=True) \
        .set_max_iter(4).fit(tables())
    out["w2v_golden"] = golden.vectors
    out["w2v_resumed"] = rec.vectors
    out["w2v_cliques"] = w2v_estimator(Word2Vec, mesh=mesh).set_max_iter(8) \
        .fit(tables()).vectors
    return out


def _flat_model(model):
    """An MLP's weights or an FM's ``(w0, w, v)`` as a list of arrays."""
    if hasattr(model, "_weights"):
        return list(model._weights)
    return [np.asarray([model._w0]), model._w, model._v]
