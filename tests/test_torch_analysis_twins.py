"""Twin programs: the JAX package's analysis tests that run on this host,
each program written once in JAX and once in torch, through the JAX
package's pass and the port's, with the same findings.

- memory (``tests/test_analysis_memory.py``): the estimate's argument,
  output and parameter bytes are equal; peak bytes agree within a stated
  tolerance, and each buffer where XLA and aten differ is named beside
  its case (XLA writes an elementwise result into a dying operand's
  buffer, aten allocates it beside; a JAX donation is a torch in-place
  update);
- sorted scatters (``tests/test_sparse_sorted.py:332-370``): the good and
  bad steps, and the real sorted-column step of both packages;
- collective order (``tests/test_analysis_collectives.py``): extracted
  sequences, rank orders and dispatch traces;
- precision (``tests/test_precision.py``): the check programs.

JAX's scan carries have no torch counterpart (a Python loop unrolls), so
``test_scan_carry_provenance_recurses`` has no twin.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import flinkml_tpu.analysis as J
import flinkml_tpu_torch.analysis as P
from flinkml_tpu.analysis import memory as jmem
from flinkml_tpu_torch.analysis import memory as pmem
from flinkml_tpu_torch.analysis._capture import nodes_named, capture, spec
from flinkml_tpu_torch.parallel import collectives as coll

from tests._torch_threads import cap_torch_threads

cap_torch_threads()

BF16 = np.dtype(ml_dtypes.bfloat16)


def rules(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------


def test_estimate_counts_arguments_and_outputs():
    x = np.zeros((1024, 8), np.float32)
    je = J.estimate_fn_memory(lambda x: (x * 2.0).sum(), x)
    pe = P.estimate_fn_memory(lambda x: (x * 2.0).sum(), x)
    assert pe.argument_bytes == je.argument_bytes == 1024 * 8 * 4
    assert pe.output_bytes == je.output_bytes == 4
    # XLA writes the sum into the dying product's buffer; aten allocates
    # the 4-byte sum beside it.
    assert pe.peak_bytes == je.peak_bytes + 4
    assert "peak" in pe.render() and "KiB" in pe.render()


def test_liveness_frees_dead_intermediates():
    def jchain(x):
        for _ in range(16):
            x = x * 1.0001 + 1.0
        return x

    def pchain(x):
        for _ in range(16):
            x = x * 1.0001 + 1.0
        return x

    x = np.zeros((4096,), np.float32)
    buf = 4096 * 4
    je, pe = J.estimate_fn_memory(jchain, x), P.estimate_fn_memory(pchain, x)
    assert je.temp_peak_bytes <= 4 * buf and pe.temp_peak_bytes <= 4 * buf
    # aten: each op's output beside its operand (2 buffers at most); XLA
    # reuses the operand's, so its chain holds 1.
    assert pe.temp_peak_bytes == 2 * buf and je.temp_peak_bytes == buf


def test_donation_is_an_in_place_update():
    a = np.zeros((8192,), np.float32)
    undonated = J.estimate_fn_memory(lambda s, g: s - g, a, a,
                                     param_argnums=(0,))
    donated = J.estimate_fn_memory(lambda s, g: s - g, a, a,
                                   param_argnums=(0,), donate_argnums=(0,))
    out_of_place = P.estimate_fn_memory(lambda s, g: s - g, a, a,
                                        param_argnums=(0,))
    in_place = P.estimate_fn_memory(lambda s, g: s.sub_(g), a, a,
                                    param_argnums=(0,))
    saved = undonated.peak_bytes - donated.peak_bytes
    assert saved == 8192 * 4
    assert out_of_place.peak_bytes - in_place.peak_bytes == saved
    assert out_of_place.peak_bytes == undonated.peak_bytes


def test_params_are_sized_by_the_plan_slice():
    from flinkml_tpu.sharding.plan import BATCH_PARALLEL as JBP, FSDP as JF
    from flinkml_tpu_torch.sharding.plan import BATCH_PARALLEL, FSDP

    state = {"coef": np.zeros((8192,), np.float32)}
    xb = np.zeros((4, 8192), np.float32)
    mesh = {"data": 1, "fsdp": 8}
    for jplan, pplan, want in ((JF, FSDP, 8192 * 4 // 8),
                               (JBP, BATCH_PARALLEL, 8192 * 4)):
        je = J.estimate_fn_memory(
            lambda s, x: {"coef": s["coef"] - x.sum(0)}, state, xb,
            plan=jplan, mesh=mesh, param_argnums=(0,))
        pe = P.estimate_fn_memory(
            lambda s, x: {"coef": s["coef"] - x.sum(0)}, state, xb,
            plan=pplan, mesh=mesh, param_argnums=(0,))
        assert pe.param_bytes == je.param_bytes == want


def test_batch_sharded_intermediates_divide_the_leading_dim():
    from flinkml_tpu.sharding.plan import BATCH_PARALLEL as JBP
    from flinkml_tpu_torch.sharding.plan import BATCH_PARALLEL

    x = np.zeros((800, 16), np.float32)
    je = J.estimate_fn_memory(lambda x: (x * 2.0).sum(), x, plan=JBP,
                              mesh={"data": 8})
    pe = P.estimate_fn_memory(lambda x: (x * 2.0).sum(), x,
                              plan=BATCH_PARALLEL, mesh={"data": 8})
    assert pe.argument_bytes == je.argument_bytes == 100 * 16 * 4


def test_subprogram_intermediates_count():
    inner_j = jax.jit(lambda x: jnp.tanh(x) * jnp.exp(x) + jnp.sin(x))

    def inner_p(x):
        return torch.tanh(x) * torch.exp(x) + torch.sin(x)

    x = np.zeros((2048,), np.float32)
    je = J.estimate_fn_memory(lambda x: inner_j(x).sum(), x)
    pe = P.estimate_fn_memory(lambda x: inner_p(x).sum(), x)
    assert je.temp_peak_bytes >= 2048 * 4 and pe.temp_peak_bytes >= 2048 * 4


def test_peak_of_a_product_chain_within_tolerance():
    """``tanh(x @ x.T)`` squared and summed: XLA writes ``tanh`` and the
    square over the product's buffer (two 256 KiB buffers at the peak:
    ``x`` and the product); aten allocates ``tanh`` beside the product
    and the square beside ``tanh`` (three), while ``x.T`` is a view in
    both. So the port's peak is 1.5x JAX's here, within the 0.5x–2.0x
    band JAX holds its estimate to against XLA's own memory analysis."""
    def jf(x):
        h = jnp.tanh(x @ x.T)
        return (h * h).sum()

    def pf(x):
        h = torch.tanh(x @ x.T)
        return (h * h).sum()

    x = np.zeros((256, 256), np.float32)
    je, pe = J.estimate_fn_memory(jf, x), P.estimate_fn_memory(pf, x)
    buf = 256 * 256 * 4
    assert je.peak_bytes in (2 * buf, 2 * buf + 4)
    assert pe.peak_bytes == 3 * buf
    assert 0.5 <= pe.peak_bytes / je.peak_bytes <= 2.0


def _probe_rules(spec_map, budget=1 << 30, mesh=None, jplan=None,
                 pplan=None):
    out = []
    for mod, plan in ((jmem, jplan), (pmem, pplan)):
        fn, args, p, d = mod._probe_program(spec_map)
        out.append(mod.check_memory_fn(
            fn, *args, plan=plan, mesh=mesh or {}, hbm_budget_bytes=budget,
            param_argnums=p, donate_argnums=d, program=spec_map["name"]))
    return out


@pytest.mark.parametrize("budget,fires", [(1024, True), (1 << 30, False)])
def test_fml701_over_and_under_budget(budget, fires):
    from flinkml_tpu.sharding.plan import FSDP as JF
    from flinkml_tpu_torch.sharding.plan import FSDP

    jf, pf = _probe_rules({"name": "sgd_step", "dim": 4096, "rows": 64,
                           "donate": True}, budget=budget,
                          mesh={"data": 1, "fsdp": 8}, jplan=JF, pplan=FSDP)
    assert rules(jf) == rules(pf)
    assert ("FML701" in rules(pf)) == fires
    if fires:
        (f701,) = [f for f in pf if f.rule == "FML701"]
        assert "KiB" in f701.message or "MiB" in f701.message


def test_fml702_flags_one_hot_densification():
    jf, pf = _probe_rules({"name": "embedding_dense_grad", "vocab": 4096,
                           "dim": 16, "rows": 32})
    assert rules(jf) == rules(pf)
    assert "4096" in next(f for f in pf if f.rule == "FML702").message


def test_fml702_exempts_batch_sized_lookup_and_state_update():
    jf, pf = _probe_rules({"name": "embedding_lookup", "vocab": 4096,
                           "dim": 16, "rows": 32})
    assert rules(jf) == rules(pf) == []

    vocab, dim, rows = 4096, 16, 32

    def jscatter(state, ids, delta):
        table = state["emb/embedding"]
        return {"emb/embedding": table.at[ids].add(delta)}

    def pscatter(state, ids, delta):
        table = state["emb/embedding"]
        return {"emb/embedding": table.index_add_(0, ids, delta)}

    jargs = ({"emb/embedding": jax.ShapeDtypeStruct((vocab, dim),
                                                     np.float32)},
             jax.ShapeDtypeStruct((rows,), np.int32),
             jax.ShapeDtypeStruct((rows, dim), np.float32))
    pargs = ({"emb/embedding": spec((vocab, dim))},
             spec((rows,), torch.int64), spec((rows, dim)))
    jf = J.check_memory_fn(jscatter, *jargs, hbm_budget_bytes=1 << 30,
                           param_argnums=(0,), donate_argnums=(0,))
    pf = P.check_memory_fn(pscatter, *pargs, hbm_budget_bytes=1 << 30,
                           param_argnums=(0,))
    assert rules(jf) == rules(pf) == []


def test_fml702_ignores_small_tables():
    def jdense(state, ids, grad):
        table = state["t/embedding"]
        oh = jax.nn.one_hot(ids, table.shape[0], dtype=table.dtype)
        return {"t/embedding": table + oh.T @ grad}

    def pdense(state, ids, grad):
        table = state["t/embedding"]
        oh = (ids[:, None] == torch.arange(table.shape[0])).to(table.dtype)
        return {"t/embedding": table.add_(oh.T @ grad)}

    jf = J.check_memory_fn(
        jdense, {"t/embedding": jax.ShapeDtypeStruct((64, 8), np.float32)},
        jax.ShapeDtypeStruct((4,), np.int32),
        jax.ShapeDtypeStruct((4, 8), np.float32),
        hbm_budget_bytes=1 << 30, param_argnums=(0,), donate_argnums=(0,))
    pf = P.check_memory_fn(
        pdense, {"t/embedding": spec((64, 8))}, spec((4,), torch.int64),
        spec((4, 8)), hbm_budget_bytes=1 << 30, param_argnums=(0,))
    assert rules(jf) == rules(pf) == []


@pytest.mark.parametrize("optimizer,cols", [
    ("sgd", ["coef", "momentum"]), ("adam", ["coef", "m", "v"])])
def test_fml703_on_the_real_step(optimizer, cols):
    name = f"{optimizer}_step"
    for donate in (False, True):
        jf, pf = _probe_rules({"name": name, "dim": 4096, "rows": 64,
                               "donate": donate})
        assert rules(jf) == rules(pf)
        got = sorted(f.column for f in pf if f.rule == "FML703")
        assert got == ([] if donate else cols)
    assert 512 >= pmem.DONATION_MIN_ELEMS


def test_fml704_and_tier_ladder():
    shapes = {"emb/embedding": (1 << 20, 64)}
    mesh = {"data": 1, "fsdp": 8}
    jf = J.check_tier_ladder(mesh, shapes, 4096)
    pf = P.check_tier_ladder(mesh, shapes, 4096)
    assert rules(jf) == rules(pf) == ["FML704"]
    assert pf[0].message == jf[0].message
    small = {"emb/embedding": (1 << 14, 64)}
    assert P.check_tier_ladder(mesh, small, 2 << 20) == [] == \
        J.check_tier_ladder(mesh, small, 2 << 20)


# ---------------------------------------------------------------------------
# sorted scatters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flag,sorted_argnums,want", [
    (False, (1,), ["FML404"]), (True, (1,), []), (False, (), [])])
def test_fml404_good_and_bad_steps(flag, sorted_argnums, want):
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    def jstep(v, i):
        return jax.ops.segment_sum(v, i, num_segments=16,
                                   indices_are_sorted=flag)

    def pstep(v, i):
        return segment_sum(v, i, 16, indices_are_sorted=flag)

    jargs = (jnp.zeros(64, jnp.float32), jnp.zeros(64, jnp.int32))
    pargs = (spec((64,)), spec((64,), torch.int32))
    jf = J.check_sorted_scatter_fn(jstep, jargs, sorted_argnums)
    pf = P.check_sorted_scatter_fn(pstep, pargs, sorted_argnums)
    assert rules(jf) == rules(pf) == want


def _port_sorted_step_args(dim, bucket, width):
    return (spec((dim,)), spec((bucket, width), torch.int32),
            spec((bucket, width)), spec((bucket * width,), torch.int64),
            spec((bucket * width,), torch.int32), spec((bucket,)),
            spec((bucket,)), spec(()), spec(()), spec(()))


def test_sorted_column_stepper_traces_clean_and_its_false_copy_flags():
    from flinkml_tpu.models._linear_sgd import (
        _sorted_column_stepper as jax_stepper,
    )
    from flinkml_tpu_torch.models import _linear_sgd

    dim, bucket, width = 64, 16, 8
    jargs = (
        jnp.zeros(dim, jnp.float32), jnp.zeros((bucket, width), jnp.int32),
        jnp.zeros((bucket, width), jnp.float32),
        jnp.zeros(bucket * width, jnp.int32),
        jnp.zeros(bucket * width, jnp.int32), jnp.zeros(bucket, jnp.float32),
        jnp.ones(bucket, jnp.float32), jnp.asarray(12, jnp.int32),
        jnp.float32(0.5), jnp.float32(1e-4), jnp.float32(0.0),
    )
    assert J.check_sorted_scatter_fn(jax_stepper("logistic", dim), jargs,
                                     (3, 4)) == []
    args = _port_sorted_step_args(dim, bucket, width)
    step = _linear_sgd._sorted_column_stepper("logistic", dim)
    assert P.check_sorted_scatter_fn(step, args, (3, 4)) == []
    (node,) = nodes_named(capture(step, *args), "segment_sum")
    assert node.args[3] is True

    real = _linear_sgd.segment_sum

    def unsorted(values, ids, n, indices_are_sorted=False):
        return real(values, ids, n, indices_are_sorted=False)

    _linear_sgd.segment_sum = unsorted
    try:
        bad = _linear_sgd._sorted_column_stepper("logistic", dim)
        assert rules(P.check_sorted_scatter_fn(bad, args, (3, 4))) == \
            ["FML404"]
    finally:
        _linear_sgd.segment_sum = real


# ---------------------------------------------------------------------------
# collective order
# ---------------------------------------------------------------------------


def test_extracted_sequences_equal():
    def jf(x):
        return jax.lax.psum(jax.lax.psum(x, "data"), "data")

    closed = jax.make_jaxpr(jf, axis_env=[("data", 4)])(jnp.ones(3))
    from flinkml_tpu.analysis.collectives import _walk_jaxpr

    jseq = []
    _walk_jaxpr(closed.jaxpr, jseq)

    def pf(x):
        y = coll.psum(None, x, "data")
        return coll.all_reduce_(None, y, "data")

    pseq = P.extract_collectives(pf, torch.ones(3))
    assert [c.to_map() for c in pseq] == [c.to_map() for c in jseq]


def test_rank_order_divergence_fml301():
    def rank_program(rank):
        def pf(x):
            if rank == 0:
                x = coll.psum(None, x, "data")
                return coll.group_all_gather(None, (0, 1), x)
            x = coll.group_all_gather(None, (0, 1), x)
            return coll.psum(None, x, "data")
        return pf

    seqs = {r: P.extract_collectives(rank_program(r), torch.ones(3))
            for r in (0, 1)}
    same = {r: seqs[0] for r in (0, 1)}
    jops = {r: tuple(J.CollectiveOp(c.primitive, c.axes) for c in s)
            for r, s in seqs.items()}
    assert P.check_rank_order(same) == []
    pf, jf = P.check_rank_order(seqs, "step"), J.check_rank_order(jops,
                                                                 "step")
    assert rules(pf) == rules(jf) == ["FML301"]
    assert pf[0].message == jf[0].message and "rank 1" in pf[0].message


def _ev(pkg, thread, devices, locks=(), program="p", leases=()):
    return pkg.DispatchEvent(thread=thread, program=program,
                             devices=devices, locks=tuple(locks),
                             leases=tuple(leases))


TRACE_CASES = {
    "single_device": ([("a", (0,)), ("b", (0,))], []),
    "disjoint": ([("a", (0, 1)), ("b", (2, 3))], []),
    "same_thread": ([("a", (0, 1)), ("a", (0, 1))], []),
    "unlocked_overlap": ([("a", (0, 1)), ("b", (1, 2))], ["FML302"]),
    "shared_lock": ([("a", (0, 1), ["L"]), ("b", (1, 2), ["L"])], []),
    "different_locks": ([("a", (0, 1), ["L1"]), ("b", (1, 2), ["L2"])],
                        ["FML302"]),
    "pool_slice": ([("r0", (0, 1), (), "serving.pool/p/r0.batch"),
                    ("t", (0, 1, 2, 3), ["L"], "kmeans")], ["FML303"]),
    "pool_lease": ([("r2", (0, 1), ["L"], "serving.pool/a/r2.batch",
                     ["lease:t:0,1"]), ("t", (0, 1), ["L"], "train")],
                   ["FML304"]),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_dispatch_trace_rules(case):
    events, want = TRACE_CASES[case]
    got = {}
    for name, pkg in (("jax", J), ("port", P)):
        evs = [_ev(pkg, *e) for e in events]
        got[name] = rules(pkg.check_dispatch_trace(evs))
    assert got["port"] == got["jax"] == want


@pytest.mark.parametrize("locked", [False, True])
def test_live_recording_unlocked_vs_locked(locked):
    from flinkml_tpu_torch.parallel import dispatch

    events = []
    lock = dispatch.local_execution_lock([701, 702])
    barrier = threading.Barrier(2)

    def fit(name):
        barrier.wait(10)
        for _ in range(3):
            if locked:
                with lock:
                    dispatch.record_collective_dispatch(
                        "kmeans.lloyd_epoch", (701, 702), ("all_reduce",))
            else:
                dispatch.record_collective_dispatch(
                    "kmeans.lloyd_epoch", (701, 702), ("all_reduce",))

    dispatch.add_dispatch_observer(events.append)
    try:
        threads = [threading.Thread(target=fit, args=(f"fit-{i}",))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        dispatch.remove_dispatch_observer(events.append)
        with dispatch._MESH_LOCKS_GUARD:
            dispatch._MESH_LOCKS.pop(frozenset({701, 702}), None)
    trace = [P.DispatchEvent.from_map(e) for e in events]
    assert len(trace) == 6
    jtrace = [J.DispatchEvent.from_map(e.to_map()) for e in trace]
    want = [] if locked else ["FML302"]
    assert rules(P.check_dispatch_trace(trace)) == want
    assert rules(J.check_dispatch_trace(jtrace)) == want


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def _jpol(name):
    from flinkml_tpu import precision

    return precision.resolve_policy(name)


def _ppol(name):
    from flinkml_tpu_torch import precision

    return precision.resolve_policy(name)


def test_fml601_603_real_trainer_step():
    from flinkml_tpu.analysis.precision import check_precision_fn as jcheck
    from flinkml_tpu.sharding.apply import (
        init_linear_state as jinit,
        linear_step_fn as jstep,
    )
    from flinkml_tpu_torch.sharding.apply import linear_step_fn

    state = jax.tree_util.tree_map(
        lambda leaf: jax.ShapeDtypeStruct(np.shape(leaf), leaf.dtype),
        jinit(8, "sgd", BF16))
    jb = jax.ShapeDtypeStruct((8, 8), BF16)
    jv = jax.ShapeDtypeStruct((8,), BF16)
    jf = jcheck(jstep("logistic", "sgd", "bfloat16", 0.1, 0.9, 0.0, 0.0),
                state, jb, jv, jv, policy=_jpol("mixed"), param_argnums=(0,))
    pstate = {"coef": spec((8,), "bfloat16"),
              "momentum": spec((8,), "bfloat16")}
    pb, pv = spec((8, 8), "bfloat16"), spec((8,), "bfloat16")
    pf = P.check_precision_fn(
        linear_step_fn("logistic", "sgd", "bfloat16", 0.1, 0.9, 0.0, 0.0),
        pstate, pb, pv, pv, policy=_ppol("mixed"), param_argnums=(0,))
    assert rules(pf) == rules(jf)
    assert {"FML601", "FML603"} <= set(rules(pf))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_policy_correct_step_validates_clean(optimizer):
    from flinkml_tpu.sharding.apply import (
        linear_step_fn as jstep,
        validate_linear_precision,
    )
    from flinkml_tpu_torch.sharding.apply import (
        init_linear_state,
        linear_step_fn,
    )

    validate_linear_precision(
        _jpol("mixed"), jstep("logistic", optimizer, "float32", 0.1, 0.9,
                              0.0, 0.0, policy=_jpol("mixed")),
        dim=8, rows=8, dt=np.float32, optimizer=optimizer)
    step = linear_step_fn("logistic", optimizer, "float32", 0.1, 0.9, 0.0,
                          0.0, policy="mixed")
    state = init_linear_state(8, optimizer, "float32")
    P.validate_precision(step, state, spec((8, 8)), spec((8,)), spec((8,)),
                         policy=_ppol("mixed"), param_argnums=(0,))


@pytest.mark.parametrize("strong", [True, False])
def test_fml602_stray_wide_constant(strong):
    jconst = np.float32(1.5) if strong else 1.5
    pconst = torch.tensor([1.5]) if strong else 1.5
    jf = J.check_precision_fn(
        lambda x: (x.astype(BF16) * 2.0) * jconst,
        jax.ShapeDtypeStruct((8, 4), np.float32),
        policy=_jpol("mixed_inference"))
    pf = P.check_precision_fn(
        lambda x: (x.to(torch.bfloat16) * 2.0) * pconst, spec((8, 4)),
        policy=_ppol("mixed_inference"))
    assert rules(pf) == rules(jf) == (["FML602"] if strong else [])
    if strong:
        assert "promotes" in pf[0].message


@pytest.mark.parametrize("precast", [False, True])
def test_fml604_narrow_collective_and_sanctioned_precast(precast):
    if precast:
        jfn = lambda g: jax.lax.psum(g.astype(BF16), "data")  # noqa: E731
        pfn = lambda g: coll.psum(None, g.to(torch.bfloat16), "data")  # noqa: E731,E501
        jarg, parg = jax.ShapeDtypeStruct((8,), np.float32), spec((8,))
    else:
        jfn = lambda g: jax.lax.psum(g, "data")  # noqa: E731
        pfn = lambda g: coll.psum(None, g, "data")  # noqa: E731
        jarg = jax.ShapeDtypeStruct((8,), BF16)
        parg = spec((8,), "bfloat16")
    jf = J.check_precision_fn(jfn, jarg, policy=_jpol("mixed"),
                              axis_env=[("data", 8)])
    pf = P.check_precision_fn(pfn, parg, policy=_ppol("mixed"))
    assert rules(pf) == rules(jf) == ([] if precast else ["FML604"])


def test_fml605_plan_width_conflict():
    for dtype_bytes, want in ((2, ["FML605"]), (4, []), (None, [])):
        assert rules(P.check_policy_plan(_ppol("mixed"), dtype_bytes)) == \
            rules(J.check_policy_plan(_jpol("mixed"), dtype_bytes)) == want


def test_fml606_unscaled_int8_accumulation():
    jq = jax.ShapeDtypeStruct((8, 8), np.int8)
    jx = jax.ShapeDtypeStruct((4, 8), np.int8)
    jf = J.check_precision_fn(lambda q, x: jnp.dot(x, q), jq, jx,
                              policy=_jpol("int8_inference"),
                              param_argnums=(0,))
    pf = P.check_precision_fn(lambda q, x: torch.matmul(x, q),
                              spec((8, 8), torch.int8),
                              spec((4, 8), torch.int8),
                              policy=_ppol("int8_inference"),
                              param_argnums=(0,))
    assert rules(pf) == rules(jf) == ["FML606"]

    def jclean(q, scale, x):
        return jnp.dot(x, q.astype(jnp.float32) * scale)

    def pclean(q, scale, x):
        return torch.matmul(x, q.to(torch.float32) * scale)

    jf = J.check_precision_fn(
        jclean, jq, jax.ShapeDtypeStruct((8,), np.float32),
        jax.ShapeDtypeStruct((4, 8), np.float32),
        policy=_jpol("int8_inference"), param_argnums=(0, 1))
    pf = P.check_precision_fn(
        pclean, spec((8, 8), torch.int8), spec((8,)), spec((4, 8)),
        policy=_ppol("int8_inference"), param_argnums=(0, 1))
    assert rules(pf) == rules(jf) == []


@pytest.mark.parametrize("leaf,policy,want", [
    ("int8", "full", ["FML607"]), ("int8", "int8_inference", []),
    ("int64", "full", [])])
def test_fml607_int8_params(leaf, policy, want):
    jstate = {"coef_q": jax.ShapeDtypeStruct((16, 16), np.dtype(leaf))}
    pstate = {"coef_q": spec((16, 16), leaf)}
    jf = J.check_precision_fn(lambda s: s, jstate, policy=_jpol(policy),
                              param_argnums=(0,))
    pf = P.check_precision_fn(lambda s: s, pstate, policy=_ppol(policy),
                              param_argnums=(0,))
    assert rules(pf) == rules(jf) == want
