"""The port's sharding plans (``flinkml_tpu_torch.sharding``) against the
JAX package's, on the CPU.

- The plan value: family matching, truncation, presets, JSON byte for
  byte, ``infer_plan``, ``state_names`` and ``layouts_for`` against JAX on
  the same trees.
- FML501–FML504: the port's findings (rule, message, stage, column) equal
  JAX's on every case of ``tests/test_sharding_plan.py`` and on every
  ``*.plan.json`` fixture of ``tests/analysis_fixtures``.
- ``train_linear_plan`` under REPLICATED, BATCH_PARALLEL, FSDP, FSDP_TP and
  EMBEDDING (``coef`` over the ``fsdp × tp`` product),
  SGD and Adam, float64 and float32, at P = 1, 2 and 4 gloo ranks (one
  launch per P of ``tests/_torch_mesh_worker.py plans``; FSDP_TP has tp =
  2 at P = 2 and 4): every rank the same bits; within 1e-10 (float64) or
  1e-5 (float32) of JAX's P-device plan fit; within rtol 1e-9 / atol
  1e-12 of the port's REPLICATED fit (``test_sharding_plan.py:350``'s
  bound). Each step issues one all-gather of ``coef`` and one all-reduce.
- The over-budget FSDP fit of ``test_sharding_plan.py:525``: refused
  replicated (FML503), trained under FSDP with plan-tagged snapshots,
  resumed at world 1 under ``rescale="reshard"``; and a JAX FSDP snapshot
  of 8 devices resumed by the port.
- ``CheckpointManager.save(plan=...)`` and the plan knobs of the
  estimators, as parity cases.
"""

from __future__ import annotations

import collections
import glob
import json
import os

import jax
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.analysis import sharding_check as jax_check
from flinkml_tpu.iteration import CheckpointManager as JaxCheckpointManager
from flinkml_tpu.models import linear_regression as jax_linreg
from flinkml_tpu.models import linear_svc as jax_svc
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.parallel import DeviceMesh as JaxMesh
from flinkml_tpu.sharding import apply as jax_apply
from flinkml_tpu.sharding import plan as jax_plan
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.analysis import sharding_check as t_check
from flinkml_tpu_torch.iteration import (
    CheckpointManager,
    LayoutConflictError,
    RescaleError,
)
from flinkml_tpu_torch.iteration import checkpoint as t_ckpt
from flinkml_tpu_torch.models import _linear_sgd as t_sgd
from flinkml_tpu_torch.parallel import DeviceMesh
from flinkml_tpu_torch.sharding import apply as t_apply
from flinkml_tpu_torch.sharding import plan as t_plan
from tests import _torch_mesh_worker as worker
from tests._torch_port_common import on_cpu  # noqa: F401
from tests.test_torch_parallel import launch

F64_TOL, F32_TOL = 1e-10, 1e-5
WORLDS = (1, 2, 4)
FIXTURES = os.path.join(os.path.dirname(__file__), "analysis_fixtures")


def _jax_mesh(plan, n):
    return JaxMesh.for_plan(plan, devices=jax.devices()[:n])


def _both(name):
    return getattr(t_plan, name), getattr(jax_plan, name)


def _findings(findings):
    return [(f.rule, f.message, f.stage, f.column) for f in findings]


# ---------------------------------------------------------------------------
# The plan value
# ---------------------------------------------------------------------------

def _custom(mod):
    return mod.ShardingPlan(
        "custom",
        rules=(("embed*", (("fsdp", "tp"), None)), ("*_bias", ()),
               ("*", ("fsdp",))),
        batch_axes=("data",),
    )


@pytest.mark.parametrize("name,ndim", [
    ("embedding_table", None), ("dense_bias", None), ("coef", None),
    ("layer0/dense_bias", None), ("other", None), ("w", 2), ("w", 1),
    ("step", 0), ("w2v/center_embedding", 2),
])
def test_spec_matching_and_truncation_match_jax(name, ndim):
    for plan_name in ("REPLICATED", "BATCH_PARALLEL", "FSDP", "FSDP_TP",
                      "EMBEDDING"):
        tp, jp = _both(plan_name)
        assert tp.spec_for(name, ndim) == jp.spec_for(name, ndim)
        assert tp.param_axes(name, ndim) == jp.param_axes(name, ndim)
        assert tp.shard_dim(name, ndim) == jp.shard_dim(name, ndim)
        assert tp.layout_tag(name, ndim) == jp.layout_tag(name, ndim)
    assert _custom(t_plan).spec_for(name, ndim) == \
        _custom(jax_plan).spec_for(name, ndim)
    narrow = (t_plan.ShardingPlan("narrow", rules=(("coef", ("fsdp",)),)),
              jax_plan.ShardingPlan("narrow", rules=(("coef", ("fsdp",)),)))
    assert narrow[0].spec_for(name, ndim) == narrow[1].spec_for(name, ndim)


def test_presets_catalog_and_required_axes():
    assert set(t_plan.PRESETS) == set(jax_plan.PRESETS)
    for name in t_plan.PRESETS:
        assert t_plan.PRESETS[name].required_axes() == \
            jax_plan.PRESETS[name].required_axes()
    assert t_plan.FSDP_TP.spec_for("w", ndim=1) == ("fsdp",)
    assert t_plan.FSDP.layout_tag("coef", ndim=1) == "sharded:0"
    assert t_plan.EMBEDDING.spec_for("w2v/center_embedding", ndim=2) == \
        (("fsdp", "tp"),)
    assert [p.name for p in t_plan.STATIC_CANDIDATE_ORDER] == \
        [p.name for p in jax_plan.STATIC_CANDIDATE_ORDER]


def _rt(mod):
    return mod.ShardingPlan(
        "rt",
        rules=(("embed*", (("fsdp", "tp"), None)), ("*", ("fsdp",))),
        batch_axes=("data", "fsdp"),
        default_spec=(None, "tp"),
    )


@pytest.mark.parametrize("name", sorted(jax_plan.PRESETS) + ["rt", "custom"])
def test_plan_json_byte_identical_with_jax(name):
    if name == "rt":
        tp, jp = _rt(t_plan), _rt(jax_plan)
    elif name == "custom":
        tp, jp = _custom(t_plan), _custom(jax_plan)
    else:
        tp, jp = t_plan.PRESETS[name], jax_plan.PRESETS[name]
    text = json.dumps(jp.to_json_dict())
    assert json.dumps(tp.to_json_dict()) == text
    back = t_plan.ShardingPlan.from_json_dict(json.loads(text))
    assert back == tp and hash(back) == hash(tp)
    assert json.dumps(back.to_json_dict()) == text


def _namedtuple():
    Pair = collections.namedtuple("Pair", ["first", "second"])
    return Pair(np.zeros(4), np.zeros((2, 2)))


TREES = {
    "sgd": lambda: t_apply.init_linear_state(64, "sgd", np.float32),
    "adam": lambda: t_apply.init_linear_state(64, "adam", np.float64),
    "nested": lambda: {"b": {"w": np.zeros((8, 4)), "bias": np.zeros(4)},
                       "a": [np.zeros(8), (np.zeros(()), None)],
                       "emb/embedding": np.zeros((16, 2))},
    "list": lambda: [np.zeros(3), np.zeros((3, 3))],
    "leaf": lambda: np.zeros(5),
    "namedtuple": _namedtuple,
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_state_names_and_layouts_match_jax(tree):
    state = TREES[tree]()
    t_names = [n for n, _ in t_plan.state_names(state)]
    j_names = [n for n, _ in jax_plan.state_names(state)]
    assert t_names == j_names
    for plan_name in ("FSDP", "BATCH_PARALLEL", "FSDP_TP", "EMBEDDING"):
        tp, jp = _both(plan_name)
        t_tags = t_plan.layouts_for(tp, state)
        j_tags = jax_plan.layouts_for(jp, state)
        assert t_ckpt.tree_flatten(t_tags)[0] == \
            jax.tree_util.tree_leaves(j_tags)
        assert t_apply.plan_layouts(tp, state) == t_tags
    if tree == "adam":
        assert t_plan.layouts_for(t_plan.FSDP, state) == {
            "coef": "sharded:0", "m": "sharded:0", "v": "sharded:0",
            "step": "replicated"}


def test_mesh_for_plan_shapes(on_cpu):
    ranks = list(range(8))
    assert DeviceMesh.for_plan(t_plan.REPLICATED, ranks).shape == {"data": 8}
    assert DeviceMesh.for_plan(t_plan.FSDP, ranks).shape == \
        {"data": 1, "fsdp": 8}
    assert DeviceMesh.for_plan(t_plan.FSDP_TP, ranks).shape == \
        {"data": 1, "fsdp": 4, "tp": 2}
    assert DeviceMesh.for_plan(t_plan.FSDP_TP, ranks, tp_size=4).shape == \
        {"data": 1, "fsdp": 2, "tp": 4}
    with pytest.raises(ValueError, match="does not divide"):
        DeviceMesh.for_plan(t_plan.FSDP_TP, ranks, tp_size=3)


def test_placements_are_the_plans_specs():
    from torch.distributed.tensor import Replicate, Shard

    axes = ("data", "fsdp", "tp")
    assert t_plan.FSDP.partition_spec("coef", axes, ndim=1) == \
        (Replicate(), Shard(0), Replicate())
    assert t_plan.FSDP_TP.partition_spec("w", axes, ndim=2) == \
        (Replicate(), Shard(0), Shard(1))
    assert t_plan.EMBEDDING.partition_spec("e/embedding", axes, ndim=2) == \
        (Replicate(), Shard(0), Shard(0))
    assert t_plan.FSDP.batch_partition_spec(axes) == \
        (Shard(0), Shard(0), Replicate())
    assert t_plan.REPLICATED.batch_partition_spec(("data",)) == (Replicate(),)
    reversed_order = t_plan.ShardingPlan("r", rules=(("*", (("tp", "fsdp"),)),))
    with pytest.raises(ValueError, match="mesh's order"):
        reversed_order.partition_spec("w", axes, ndim=1)


def test_state_placement_without_a_group(on_cpu):
    mesh = DeviceMesh.for_plan(t_plan.FSDP)
    assert t_apply.batch_world(t_plan.FSDP, mesh) == 1
    state = t_apply.shard_state(t_plan.FSDP, mesh,
                                t_apply.init_linear_state(64, "sgd",
                                                          np.float64))
    assert state["coef"].shape == (64,) and state["coef"].device.type == "cpu"
    tags = t_apply.state_shardings(t_plan.FSDP, mesh, {"coef": np.zeros(64)})
    assert [repr(p) for p in tags["coef"]] == ["Replicate()", "Shard(dim=0)"]


# ---------------------------------------------------------------------------
# Footprints and infer_plan
# ---------------------------------------------------------------------------

def test_per_device_state_bytes_match_jax():
    mesh = {"data": 1, "fsdp": 8}
    shapes = {"coef": (8000,)}
    for plan in ("BATCH_PARALLEL", "FSDP"):
        tp, jp = _both(plan)
        for slots in (1, 2):
            got = t_plan.per_device_state_bytes(tp, mesh, shapes,
                                                optimizer_slots=slots)
            assert got == jax_plan.per_device_state_bytes(
                jp, mesh, shapes, optimizer_slots=slots)
    assert t_plan.per_device_state_bytes(t_plan.FSDP, mesh, shapes) == 8_000
    for tier in t_plan.QUANT_TIER_LADDER:
        assert t_plan.per_device_state_bytes_tiered(
            t_plan.FSDP_TP, {"data": 1, "fsdp": 4, "tp": 2},
            {"w": (64, 64), "b": (3,)}, tier) == \
            jax_plan.per_device_state_bytes_tiered(
                jax_plan.FSDP_TP, {"data": 1, "fsdp": 4, "tp": 2},
                {"w": (64, 64), "b": (3,)}, tier)


INFER_CASES = [
    ({"data": 1, "fsdp": 4, "tp": 2}, {"w": (64, 64)}, 32_768, {}),
    ({"data": 1, "fsdp": 4, "tp": 2}, {"w": (64, 64)}, 10_000, {}),
    ({"data": 1, "fsdp": 4, "tp": 2}, {"w": (64, 64)}, 5_000, {}),
    ({"data": 1, "fsdp": 4, "tp": 2}, {"w": (64, 64)}, 1_000, {}),
    ({"data": 8}, {"w": (64, 64)}, 10_000, {}),
    ({"data": 1, "fsdp": 4, "tp": 2}, {"w2v/center_embedding": (1 << 16, 16)},
     (1 << 16) * 16 * 4 * 2 // 3, {}),
    ({"data": 1, "fsdp": 4, "tp": 2}, {"w2v/center_embedding": (1 << 16, 16)},
     (1 << 16) * 16 * 4 * 2 // 6, {}),
    ({"data": 1, "fsdp": 4, "tp": 2}, {"w2v/center_embedding": (1 << 16, 16)},
     (1 << 16) * 16 * 4 * 2 // 20, {}),
    ({"data": 1, "fsdp": 4, "tp": 2}, {"emb/embedding": (1001, 16)},
     126 * 16 * 4 * 2, {}),
    ({"data": 1, "fsdp": 4, "tp": 2}, {"emb/embedding": (1001, 16)},
     126 * 16 * 4 * 2 - 1, {}),
    ({"data": 1, "fsdp": 2}, {"w": (4096, 64)}, 600_000,
     {"quant_tiers": True}),
    ({"data": 1, "fsdp": 2}, {"w": (4096, 64)}, 100_000,
     {"quant_tiers": True}),
    ({"data": 4}, {"w": (4096, 64)}, 2_200_000, {"quant_tiers": ["int8"]}),
]


@pytest.mark.parametrize("case", range(len(INFER_CASES)))
def test_infer_plan_matches_jax(case):
    mesh, shapes, budget, kw = INFER_CASES[case]

    def run(mod):
        try:
            out = mod.infer_plan(mesh, shapes, budget, **kw)
        except mod.NoFeasiblePlanError as e:
            return ("error", str(e))
        return (out[0].name, out[1]) if isinstance(out, tuple) \
            else (out.name,)

    assert run(t_plan) == run(jax_plan)


def test_infer_plan_accepts_device_mesh(on_cpu):
    mesh = DeviceMesh.for_plan(t_plan.FSDP, list(range(8)))
    assert t_plan.infer_plan(mesh, {"coef": (8192,)}, 40_000).name == "fsdp"
    assert t_plan.shard_slice_elems(
        t_plan.EMBEDDING, {"data": 1, "fsdp": 4, "tp": 2}, "emb/embedding",
        (1001, 16)) == 126 * 16


# ---------------------------------------------------------------------------
# FML501–FML504
# ---------------------------------------------------------------------------

def _plan_pair(spec):
    return tuple(mod.ShardingPlan(*spec[0], **spec[1])
                 for mod in (t_plan, jax_plan))


CHECK_CASES = {
    "fml501_unknown": (((("bad",), dict(rules=(("*", ("model",)),),
                                        batch_axes=("batch",))),
                       {"data": 8}, None, None, 1)),
    "fml501_duplicate": ((("dup",), dict(rules=(("*", ("fsdp", "fsdp")),))),
                         {"data": 1, "fsdp": 8}, None, None, 1),
    "fml502": ("FSDP", {"data": 1, "fsdp": 8}, {"coef": (4090,)}, None, 1),
    "fml502_clean": ("FSDP", {"data": 1, "fsdp": 8}, {"coef": (4096,)},
                     None, 1),
    "fml503": ("BATCH_PARALLEL", {"data": 8}, {"coef": (8192,)}, 16_384, 1),
    "fml503_fixed": ("FSDP", {"data": 1, "fsdp": 8}, {"coef": (8192,)},
                     16_384, 1),
    "fml503_sharded_over": ("EMBEDDING", {"data": 1, "fsdp": 4, "tp": 2},
                            {"big/embedding": (1 << 20, 64)},
                            (1 << 17) * 64 * 4 * 3 - 1, 2),
    "fml503_sharded_fits": ("EMBEDDING", {"data": 1, "fsdp": 4, "tp": 2},
                            {"big/embedding": (1 << 20, 64)},
                            (1 << 17) * 64 * 4 * 3, 2),
    "tp_mlp": ((("tp_mlp",), dict(rules=(("w1", (None, "tp")),
                                         ("w2", ("tp", None))))),
               {"data": 1, "tp": 8}, {"w1": (16, 32), "w2": (32, 16)},
               None, 1),
}


@pytest.mark.parametrize("name", sorted(CHECK_CASES))
def test_check_plan_findings_equal_jax(name):
    spec, mesh, shapes, budget, slots = CHECK_CASES[name]
    if isinstance(spec, str):
        tp, jp = _both(spec)
    else:
        tp, jp = _plan_pair(spec)
    kw = dict(param_shapes=shapes, hbm_budget_bytes=budget,
              optimizer_slots=slots)
    got = t_check.check_plan(tp, mesh, **kw)
    want = jax_check.check_plan(jp, mesh, **kw)
    assert _findings(got) == _findings(want)
    assert [f.render() for f in got] == [f.render() for f in want]
    if name in ("fml501_duplicate", "fml502"):
        assert len(got) == 1


def test_fml504_signatures_and_cross_plan_equal_jax():
    mesh = {"data": 1, "fsdp": 8}
    shapes = {"coef": (4096,)}
    for name in ("FSDP", "BATCH_PARALLEL", "FSDP_TP", "REPLICATED"):
        tp, jp = _both(name)
        assert [c.to_map() for c in
                t_check.plan_collective_signature(tp, mesh, shapes)] == \
            [c.to_map() for c in
             jax_check.plan_collective_signature(jp, mesh, shapes)]
    pairs = [("FSDP", "BATCH_PARALLEL"), ("FSDP", "FSDP")]
    for a, b in pairs:
        got = t_check.check_cross_plan([_both(a)[0], _both(b)[0]], mesh,
                                       shapes)
        want = jax_check.check_cross_plan([_both(a)[1], _both(b)[1]], mesh,
                                          shapes)
        assert _findings(got) == _findings(want)
    # Two conflicting plans sharing a name stay two comparator entries.
    same = [((("p",), dict(rules=(("*", ("fsdp",)),),
                           batch_axes=("data", "fsdp")))),
            ((("p",), dict(rules=(("*", ()),), batch_axes=("data", "fsdp"))))]
    t_plans = [_plan_pair(s)[0] for s in same]
    j_plans = [_plan_pair(s)[1] for s in same]
    got = t_check.check_cross_plan(t_plans, mesh, shapes)
    assert [f.rule for f in got] == ["FML504"]
    assert _findings(got) == _findings(
        jax_check.check_cross_plan(j_plans, mesh, shapes))
    assert t_check.check_program([t_plan.FSDP], mesh, shapes) == []


@pytest.mark.parametrize("path", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES,
                                                        "*.plan.json"))))
def test_seeded_plan_fixtures_equal_jax(path):
    full = os.path.join(FIXTURES, path)
    got = t_check.check_plan_file(full)
    assert got, "a seeded fixture must be flagged"
    assert _findings(got) == _findings(jax_check.check_plan_file(full))
    if "fml50x" in path:
        assert sorted(f.rule for f in got) == ["FML502", "FML503"]
        by_rule = {f.rule: f for f in got}
        assert "pads its vocab" in by_rule["FML502"].message
        assert "per-device shard still costs" in by_rule["FML503"].message


def test_unreadable_plan_file_fails_loudly(tmp_path):
    bad = tmp_path / "broken.plan.json"
    bad.write_text("{not json")
    assert [f.rule for f in t_check.check_plan_file(str(bad))] == ["FML501"]
    empty = tmp_path / "empty.plan.json"
    empty.write_text("{}")
    got = t_check.check_plan_file(str(empty))
    assert _findings(got) == _findings(jax_check.check_plan_file(str(empty)))


# ---------------------------------------------------------------------------
# train_linear_plan at P = 1, 2 and 4 ranks against JAX's P-device fit
# ---------------------------------------------------------------------------

PLAN_CASES = {f"plan_{n}_{o}_{d}": (n, o, d) for n in worker.PLAN_NAMES
              for o in ("sgd", "adam") for d in ("float64", "float32")}
PLAN_OUTPUTS = sorted(PLAN_CASES)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    workdir = str(tmp_path_factory.mktemp(f"plans{world}"))
    return world, workdir, launch("plans", world, workdir)


@pytest.fixture(scope="module")
def jax_plan_fits():
    """JAX's P-device plan fit of every case, per P."""
    x, y, w = worker.plan_data()
    out = {}
    for world in WORLDS:
        for key, (name, opt, dt) in PLAN_CASES.items():
            plan = jax_plan.PRESETS[name]
            out[world, key] = jax_apply.train_linear_plan(
                x.astype(dt), y.astype(dt), w.astype(dt), plan,
                _jax_mesh(plan, world), optimizer=opt, **worker.PLAN_KW)
    return out


def test_ranks_agree_bit_for_bit(ranks):
    world, _, outs = ranks
    for name in outs[0]:
        if name.startswith("local_"):
            continue
        for r in range(1, world):
            np.testing.assert_array_equal(outs[r][name], outs[0][name],
                                          err_msg=name)


@pytest.mark.parametrize("name", PLAN_OUTPUTS)
def test_plan_fit_matches_jax(ranks, jax_plan_fits, name):
    world, _, outs = ranks
    got, want = outs[0][name], jax_plan_fits[world, name]
    assert got.dtype == want.dtype
    tol = F64_TOL if name.endswith("float64") else F32_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", [n for n in PLAN_OUTPUTS
                                  if n.endswith("float64")])
def test_plan_fit_matches_the_replicated_fit(ranks, name):
    _, _, outs = ranks
    opt = "adam" if "_adam_" in name else "sgd"
    np.testing.assert_allclose(outs[0][name],
                               outs[0][f"plan_replicated_{opt}_float64"],
                               rtol=1e-9, atol=1e-12)


def test_plan_step_collectives(ranks):
    world, _, outs = ranks
    gathers, reduces, steps, events = outs[0]["fsdp_collectives"].tolist()
    # One all-gather of coef and one all-reduce a step (the loop's
    # counts); the dispatch observer also sees the result's final gather.
    assert (gathers, reduces, steps) == (8, 8, 8)
    assert events == gathers + reduces + 1
    assert outs[0]["local_fsdp_coef_shape"].tolist() == \
        [worker.PLAN_DIM // world]
    assert outs[0]["fsdp_placements"].tolist() == \
        ["Replicate()", "Shard(dim=0)"]
    assert outs[0]["fsdp_step_placements"].tolist() == \
        ["Replicate()", "Replicate()"]


def test_estimators_on_a_data_mesh_match_jax(ranks):
    """``LogisticRegression(mesh=, sharding_plan=FSDP)`` on a data mesh:
    the plan's mesh is rebuilt over the same ranks, as in JAX."""
    world, _, outs = ranks
    x, y, _ = worker.plan_data()
    table = JaxTable({"features": x, "label": y})
    jm = JaxMesh({"data": world}, jax.devices()[:world])
    want = (jax_lr.LogisticRegression(mesh=jm, sharding_plan=jax_plan.FSDP)
            .set_seed(3).set_max_iter(6).fit(table).coefficient)
    np.testing.assert_allclose(outs[0]["lr_estimator_fsdp"], want, rtol=0,
                               atol=F64_TOL)
    want = (jax_lr.LogisticRegression(mesh=jm, precision="mixed")
            .set_seed(3).set_max_iter(6).fit(table).coefficient)
    np.testing.assert_allclose(outs[0]["lr_estimator_mixed"], want, rtol=0,
                               atol=F32_TOL)


def test_over_budget_fit_trains_under_fsdp_and_resumes_at_world_1(
        ranks, on_cpu):
    """``test_sharding_plan.py:525`` at P ranks: the replicated plan is
    refused over budget (FML503), FSDP trains with plan-tagged snapshots
    (at P = 1 FSDP does not fit either), and the final snapshot resumes at
    world 1 under ``rescale="reshard"``."""
    world, workdir, outs = ranks
    assert outs[0]["budget_refused"].tolist() == [1]
    if world == 1:
        assert "budget_fsdp" not in outs[0]
        return
    x, y, _ = worker.plan_data()
    plan = jax_plan.FSDP
    want = jax_apply.train_linear_plan(
        x, y, None, plan, _jax_mesh(plan, world),
        max_iter=worker.BUDGET_EPOCHS, learning_rate=0.5,
        hbm_budget_bytes=worker.budget_bytes())
    got = outs[0]["budget_fsdp"]
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)
    ckpt = os.path.join(workdir, "ckpt_fsdp")
    with open(os.path.join(ckpt, f"ckpt-{worker.BUDGET_EPOCHS}",
                           "meta.json")) as fh:
        meta = json.load(fh)
    assert meta["layouts"] == ["sharded:0", "sharded:0"]
    assert meta["world_size"] == world
    resumed = t_apply.train_linear_plan(
        x, y, None, t_plan.FSDP, None, max_iter=worker.BUDGET_EPOCHS,
        learning_rate=0.5,
        checkpoint_manager=CheckpointManager(ckpt, max_to_keep=10,
                                             rescale="reshard"),
        checkpoint_interval=worker.BUDGET_INTERVAL, resume=True)
    np.testing.assert_array_equal(resumed, got)
    with pytest.raises(RescaleError, match="reject"):
        t_apply.train_linear_plan(
            x, y, None, t_plan.FSDP, None, max_iter=worker.BUDGET_EPOCHS,
            checkpoint_manager=CheckpointManager(ckpt), resume=True)


def test_jax_fsdp_snapshot_resumes_in_the_port(tmp_path, on_cpu):
    """A JAX FSDP fit on 8 devices snapshots at epochs 4, 8, 12; the port
    resumes the last at world 1 under ``rescale="reshard"``: the same
    coefficient with no epoch left, and JAX's continuation to epoch 16
    within 1e-10."""
    x, y, _ = worker.plan_data(n=96, seed=1)
    kw = dict(learning_rate=0.5, checkpoint_interval=4)
    mesh8 = _jax_mesh(jax_plan.FSDP, 8)
    jax_dir = str(tmp_path / "jax")
    coef12 = jax_apply.train_linear_plan(
        x, y, None, jax_plan.FSDP, mesh8, max_iter=12,
        checkpoint_manager=JaxCheckpointManager(jax_dir, max_to_keep=10,
                                                rescale="reshard"), **kw)
    with open(os.path.join(jax_dir, "ckpt-12", "meta.json")) as fh:
        assert json.load(fh)["world_size"] == 8
    port_dir = str(tmp_path / "port")
    import shutil

    shutil.copytree(jax_dir, port_dir)
    mgr = CheckpointManager(port_dir, max_to_keep=10, rescale="reshard")
    got = t_apply.train_linear_plan(x, y, None, t_plan.FSDP, None,
                                    max_iter=12, checkpoint_manager=mgr,
                                    resume=True, **kw)
    np.testing.assert_array_equal(got, coef12)
    cont = t_apply.train_linear_plan(x, y, None, t_plan.FSDP, None,
                                     max_iter=16, checkpoint_manager=mgr,
                                     resume=True, **kw)
    want = jax_apply.train_linear_plan(
        x, y, None, jax_plan.FSDP, mesh8, max_iter=16,
        checkpoint_manager=JaxCheckpointManager(jax_dir, max_to_keep=10,
                                                rescale="reshard"),
        resume=True, **kw)
    np.testing.assert_allclose(cont, want, rtol=0, atol=F64_TOL)


# ---------------------------------------------------------------------------
# Checkpoints: plan-derived layouts, one source of truth
# ---------------------------------------------------------------------------

def test_save_plan_records_derived_layout_tags(tmp_path):
    mgr = CheckpointManager(str(tmp_path), world_size=8)
    state = t_apply.init_linear_state(64, "adam", np.float32)
    mgr.save(state, 1, plan=t_plan.FSDP)
    with open(tmp_path / "ckpt-1" / "meta.json") as fh:
        meta = json.load(fh)
    assert meta["layouts"] == ["sharded:0", "sharded:0", "replicated",
                               "sharded:0"]
    assert meta["world_size"] == 8
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), world_size=8)
    jmgr.save(jax_apply.init_linear_state(64, "adam", np.float32), 1,
              plan=jax_plan.FSDP)
    with open(tmp_path / "jax" / "ckpt-1" / "meta.json") as fh:
        jmeta = json.load(fh)
    for key in ("layouts", "treedef", "world_size", "num_leaves"):
        assert meta[key] == jmeta[key]


def test_save_plan_conflicting_explicit_layouts_raise_typed(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = t_apply.init_linear_state(64, "sgd", np.float32)
    with pytest.raises(LayoutConflictError, match="authoritative") as exc:
        mgr.save(state, 1, plan=t_plan.FSDP, layouts="replicated")
    assert "coef" in str(exc.value)
    assert mgr.all_epochs() == []
    mgr.save(state, 2, plan=t_plan.FSDP,
             layouts={"coef": "sharded:0", "momentum": "sharded:0"})
    assert mgr.all_epochs() == [2]


def test_reshard_restore_checks_sharded_leaves(tmp_path):
    """``rescale="reshard"`` on assembled leaves: a replicated leaf
    passes, a ``sharded:0`` leaf must divide across the new world, a
    ``per_rank`` leaf is refused, as in JAX (a rank-scoped family
    reassembles through ``reshard_rank_state``)."""
    state = {"coef": np.arange(6.0), "bias": np.float64(1.0)}
    CheckpointManager(str(tmp_path / "a"), world_size=3).save(
        state, 1, plan=t_plan.FSDP)
    ok = CheckpointManager(str(tmp_path / "a"), world_size=2,
                           rescale="reshard")
    got, epoch = ok.restore(1, like=state)
    np.testing.assert_array_equal(got["coef"], state["coef"])
    bad = CheckpointManager(str(tmp_path / "a"), world_size=4,
                            rescale=t_ckpt.RescalePolicy.reshard())
    with pytest.raises(RescaleError, match="does not divide across 4"):
        bad.restore(1, like=state)
    jbad = JaxCheckpointManager(str(tmp_path / "a"), world_size=4,
                                rescale="reshard")
    with pytest.raises(ValueError, match="does not divide across 4"):
        jbad.restore(1, like=state)
    CheckpointManager(str(tmp_path / "b"), world_size=2).save(
        state, 1, layouts={"coef": "per_rank", "bias": "replicated"})
    with pytest.raises(RescaleError, match="leaf 1 is per_rank"):
        CheckpointManager(str(tmp_path / "b"), world_size=1,
                          rescale="reshard").restore(1, like=state)
    with pytest.raises(ValueError, match="leaf 1 is per_rank"):
        JaxCheckpointManager(str(tmp_path / "b"), world_size=1,
                             rescale="reshard").restore(1, like=state)


# ---------------------------------------------------------------------------
# The knobs on the estimators
# ---------------------------------------------------------------------------

def test_estimator_accepts_sharding_plan_and_rejects_unaware_paths(on_cpu):
    x, y, _ = worker.plan_data(n=64, dim=16, seed=2)
    got = (fml.LogisticRegression(sharding_plan=t_plan.FSDP).set_max_iter(5)
           .set_seed(1).fit(fml.Table({"features": x, "label": y})).coefficient)
    want = (jax_lr.LogisticRegression(
        mesh=JaxMesh(devices=jax.devices()[:1]),
        sharding_plan=jax_plan.FSDP).set_max_iter(5).set_seed(1)
        .fit(JaxTable({"features": x, "label": y})).coefficient)
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)
    table = fml.Table({"features": x, "label": y})
    with pytest.raises(ValueError, match="streamed"):
        fml.LogisticRegression(sharding_plan=t_plan.FSDP).fit(iter([table]))
    sparse = fml.Table({"features": np.array(
        [fml.SparseVector(4, [0], [1.0])] * 4, dtype=object),
        "label": np.array([0.0, 1.0, 0.0, 1.0])})
    with pytest.raises(ValueError, match="dense binomial path only"):
        fml.LogisticRegression(sharding_plan=t_plan.FSDP).fit(sparse)
    multi = fml.Table({"features": x, "label": np.arange(64.0) % 3})
    with pytest.raises(ValueError, match="softmax trainer"):
        fml.LogisticRegression(sharding_plan=t_plan.FSDP).fit(multi)
    with pytest.raises(ValueError, match="listeners"):
        t_sgd.train_linear_model(
            x, y, np.ones(64), "logistic", 2, 0.1, 8, 0.0, 0.0, 0.0, 0,
            sharding_plan=t_plan.FSDP, listeners=[object()])


def test_plan_unaware_estimators_refuse_the_knob_at_construction(on_cpu):
    from flinkml_tpu.models.kmeans import KMeans as JaxKMeans

    for cls in (fml.KMeans, JaxKMeans):
        with pytest.raises(ValueError, match="does not support sharding_plan"):
            cls(sharding_plan=t_plan.FSDP)
    x, y, _ = worker.plan_data(n=64, dim=16, seed=4)
    table = fml.Table({"features": x, "label": y})
    jtable = JaxTable({"features": x, "label": y})
    jmesh = JaxMesh(devices=jax.devices()[:1])
    got = (fml.LinearSVC(sharding_plan=t_plan.FSDP).set_max_iter(3)
           .set_seed(1).fit(table))
    want = (jax_svc.LinearSVC(mesh=jmesh, sharding_plan=jax_plan.FSDP)
            .set_max_iter(3).set_seed(1).fit(jtable))
    np.testing.assert_allclose(got.coefficient,
                               np.asarray(want._coefficient), rtol=0,
                               atol=F64_TOL)
    yr = x @ np.ones(16)
    got = (fml.LinearRegression(sharding_plan=t_plan.FSDP).set_max_iter(3)
           .set_seed(1).fit(fml.Table({"features": x, "label": yr})))
    want = (jax_linreg.LinearRegression(mesh=jmesh,
                                        sharding_plan=jax_plan.FSDP)
            .set_max_iter(3).set_seed(1).fit(JaxTable({"features": x, "label": yr})))
    np.testing.assert_allclose(got.coefficient,
                               np.asarray(want._coefficient), rtol=0,
                               atol=F64_TOL)
    normal = fml.LinearRegression(sharding_plan=t_plan.FSDP)
    normal.set(fml.LinearRegression.SOLVER, "normal")
    with pytest.raises(ValueError, match="solver='sgd'"):
        normal.fit(table)
    with pytest.raises(ValueError, match="streamed"):
        fml.LinearSVC(sharding_plan=t_plan.FSDP).fit([table])


def test_refusals_come_before_any_step(monkeypatch, on_cpu):
    """FML502 (an uneven fsdp split) and FML501 (a mesh without the
    plan's axes) are refused before any step runs. ``sentinel=`` (item
    12) is ported: under ``NaNGrad`` it raises the same ``NumericsError``
    at the same epoch as JAX's plan fit, before that epoch's snapshot."""
    calls = []
    monkeypatch.setattr(t_apply.LinearStep, "__call__",
                        lambda *a, **k: calls.append(1))
    x, y, _ = worker.plan_data(n=32, dim=6)
    mesh = DeviceMesh({"data": 1, "fsdp": 4}, devices=[0, 1, 2, 3])
    with pytest.raises(t_apply.PlanValidationError, match="FML502"):
        t_apply.train_linear_plan(x, y, None, t_plan.FSDP, mesh, max_iter=2)
    with pytest.raises(t_apply.PlanValidationError, match="FML501"):
        t_apply.train_linear_plan(x, y, None, t_plan.FSDP, DeviceMesh(),
                                  max_iter=2)
    x8, y8, _ = worker.plan_data(n=32, dim=8)
    with pytest.raises(ValueError, match="needs a process group"):
        t_apply.train_linear_plan(x8, y8, None, t_plan.FSDP, mesh,
                                  max_iter=2)
    assert calls == []
    monkeypatch.undo()
    from flinkml_tpu import faults as jax_faults
    from flinkml_tpu import recovery as jax_recovery
    from flinkml_tpu_torch import faults as t_faults
    from flinkml_tpu_torch import recovery as t_recovery

    raised = []
    for apply, faults, rec, mesh in (
            (t_apply, t_faults, t_recovery, None),
            (jax_apply, jax_faults, jax_recovery,
             _jax_mesh(jax_plan.FSDP, 1))):
        plan = t_plan.FSDP if apply is t_apply else jax_plan.FSDP
        with faults.armed(faults.FaultPlan(faults.NaNGrad(3))):
            with pytest.raises(rec.NumericsError) as ei:
                apply.train_linear_plan(x8, y8, None, plan, mesh,
                                        max_iter=6,
                                        sentinel=rec.NumericsSentinel())
        raised.append((ei.value.epoch, ei.value.source_index,
                       ei.value.classification, ei.value.verdict))
    assert raised[0] == raised[1] == (3, 3, "data_poison", 6)
    assert calls == []
