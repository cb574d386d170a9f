"""The port's tuning table and knob search (``flinkml_tpu_torch.autotune``)
against the JAX package's: table semantics, lookup precedence, hysteresis,
the consumers at every default they resolve, and the committed table's
measured-values contract.

Each case of ``tests/test_autotune.py`` has a counterpart here by name.
Held against the JAX functions, exactly: ``mesh_key`` with explicit
arguments, a table's saved JSON bytes, ``value``/``meshes``/``record``,
``check()``'s findings (on tables without the JAX-only
``kernel_backend_*`` knobs), ``settle`` and ``order_presets`` on drawn
candidate dicts, and ``tuned_default``'s precedence. Tests that need a
table write one into ``tmp_path`` and point ``FLINKML_TPU_TUNING_TABLE``
at it; the port runs on the CPU here (mesh ``cpu/cpu/1``), for which the
committed table has no entry, so no other test's defaults move.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import flinkml_tpu.autotune as jax_autotune
from flinkml_tpu.autotune import search as jax_search
from flinkml_tpu_torch import use_device
from flinkml_tpu_torch.autotune import (
    KNOWN_KNOBS,
    TuningTable,
    load_table,
    mesh_key,
    tuned_default,
)
from flinkml_tpu_torch.autotune.search import (
    RATIO_FLOOR,
    STATIC_DEFAULTS,
    order_presets,
    settle,
)
from flinkml_tpu_torch.autotune.table import (
    DEFAULT_TABLE_PATH,
    ENV_DISABLE_VAR,
    ENV_TABLE_VAR,
    UNCONSULTED_KNOBS,
)
from tests._torch_threads import cap_torch_threads

cap_torch_threads()

#: The committed entries' mesh: one H100 (the card the search ran on).
H100_MESH = "cuda/NVIDIA_H100_80GB_HBM3/1"
#: The knobs a one-card search measures (the two multi-rank ones, plan
#: order and embedding exchange, measure nothing at world 1).
ONE_CARD_KNOBS = (
    "sparse_layout", "gbt_histogram", "als_reduction", "w2v_accum",
    "serving_max_batch_rows", "serving_window_ms",
    "serving_scale_up_backlog", "int8_min_const_elems",
)


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _write_table(tmp_path, knobs, mesh=None):
    table = TuningTable()
    mesh = mesh or mesh_key()
    for knob, value in knobs.items():
        table.set_knob(mesh, knob, value,
                       candidates={"a": 1.0, "b": 2.0},
                       source="test")
    path = str(tmp_path / "table.json")
    table.save(path)
    return path


@pytest.fixture
def tuned(tmp_path, monkeypatch):
    """Point the process at a throwaway tuning table."""
    def point_at(knobs, mesh=None):
        monkeypatch.setenv(ENV_TABLE_VAR, _write_table(tmp_path, knobs, mesh))
    return point_at


# -- table semantics ---------------------------------------------------------


def test_table_roundtrip_and_check(tmp_path):
    table = TuningTable()
    table.set_knob("cpu/cpu/8", "sparse_layout", "cumsum",
                   candidates={"unsorted": 1.0, "cumsum": 2.0},
                   source="test")
    path = str(tmp_path / "t.json")
    table.save(path)
    loaded = load_table(path)
    assert loaded.value("cpu/cpu/8", "sparse_layout") == "cumsum"
    assert loaded.check() == []
    rec = loaded.record("cpu/cpu/8", "sparse_layout")
    assert rec["candidates"] == {"unsorted": 1.0, "cumsum": 2.0}
    assert rec["source"] == "test"


SET_KNOBS = [
    ("cuda/NVIDIA_H100_80GB_HBM3/1", "sparse_layout", "sorted",
     {"unsorted": 10.5, "sorted": 12.25, "cumsum": 3.0}),
    ("cuda/NVIDIA_H100_80GB_HBM3/1", "serving_max_batch_rows", 512,
     {"256": 1.0, "512": 2.0}),
    ("cpu/cpu/1", "serving_window_ms", 1.0, {"1.0": 5.0, "2.0": 4.0}),
    ("cpu/cpu/2", "infer_plan_order", ["fsdp", "batch_parallel", "fsdp_tp"],
     {"batch_parallel": 1.0, "fsdp": 2.0, "fsdp_tp": 0.5}),
    ("cpu/cpu/1", "int8_min_const_elems", 64, {"16": 1.0, "64": 1.3}),
]


def test_saved_table_json_equals_jax(tmp_path):
    """The same ``set_knob`` calls (``measured_at`` and ``source`` given)
    save the same JSON bytes in both packages, and both read it back to
    the same ``value``, ``record`` and ``meshes``."""
    port, jax = TuningTable(), jax_autotune.TuningTable()
    for mesh, knob, value, cands in SET_KNOBS:
        for t in (port, jax):
            t.set_knob(mesh, knob, value, candidates=cands,
                       measured_at="2026-10-18T00:00:00Z",
                       source="python -m flinkml_tpu_torch.autotune")
    p_path = port.save(str(tmp_path / "port.json"))
    j_path = jax.save(str(tmp_path / "jax.json"))
    with open(p_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    p_loaded, j_loaded = load_table(j_path), jax_autotune.load_table(p_path)
    assert p_loaded.meshes() == j_loaded.meshes()
    for mesh, knob, value, _ in SET_KNOBS:
        assert p_loaded.value(mesh, knob) == j_loaded.value(mesh, knob) \
            == value
        assert p_loaded.record(mesh, knob) == j_loaded.record(mesh, knob)
    assert p_loaded.value("tpu/TPU_v4/8", "sparse_layout") is None


BAD_TABLES = {
    "unknown_knob_and_guess": {
        "version": 1,
        "entries": {
            "cpu/cpu/8": {
                "not_a_knob": {"value": 1, "candidates": {"x": 1.0},
                               "measured_at": "", "source": "",
                               "unit": ""},
                "sparse_layout": {"value": "cumsum", "candidates": {},
                                  "measured_at": "", "source": "",
                                  "unit": ""},
            },
            "not-a-mesh-key": {},
        },
    },
    "bad_version": {"version": 2, "entries": {}},
    "entries_not_dict": {"version": 1, "entries": []},
    "knobs_not_dict": {"version": 1, "entries": {"cpu/cpu/1": 3}},
    "record_without_value": {
        "version": 1, "entries": {"cpu/cpu/1": {"gbt_histogram": {}}}},
    "missing_fields": {
        "version": 1,
        "entries": {"cuda/NVIDIA_H100_80GB_HBM3/1": {
            "als_reduction": {"value": "segment",
                              "candidates": {"segment": 2.0}}}}},
    "clean": {
        "version": 1,
        "entries": {"cpu/cpu/1": {
            "w2v_accum": {"value": "scatter", "unit": "pairs_per_sec",
                          "candidates": {"scatter": 2.0, "onehot": 1.0},
                          "measured_at": "x", "source": "y"}}}},
}


@pytest.mark.parametrize("name", sorted(BAD_TABLES))
def test_check_findings_equal_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as fh:
        json.dump(BAD_TABLES[name], fh)
    assert list(load_table(path).check()) == \
        list(jax_autotune.load_table(path).check())


def test_table_check_flags_problems(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as fh:
        json.dump(BAD_TABLES["unknown_knob_and_guess"], fh)
    problems = load_table(path).check()
    assert any("unknown knob" in p for p in problems)
    assert any("measured, not guessed" in p for p in problems)
    assert any("bad mesh key" in p for p in problems)


@pytest.mark.parametrize("knob", UNCONSULTED_KNOBS)
def test_check_names_kernel_backend_knobs_not_consulted(tmp_path, knob):
    """Declared difference: the JAX package's kernel-backend knobs have
    no consumer in the port (one CUDA route per kernel site)."""
    path = str(tmp_path / "kb.json")
    with open(path, "w") as fh:
        json.dump({"version": 1, "entries": {"cpu/cpu/8": {knob: {
            "value": "pallas", "candidates": {"xla": 1.0, "pallas": 2.0},
            "measured_at": "", "source": "", "unit": ""}}}}, fh)
    assert load_table(path).check() == [
        f"cpu/cpu/8/{knob}: not consulted in the port (its kernel gate "
        "has one CUDA route and no backend choice)"]
    assert knob not in KNOWN_KNOBS and knob not in STATIC_DEFAULTS


@pytest.mark.parametrize("knob", ["typo_knob", "kernel_backend_spmv"])
def test_set_knob_refuses_unknown_knob(knob):
    with pytest.raises(ValueError, match="unknown tuning knob"):
        TuningTable().set_knob("cpu/cpu/8", knob, 1)


def test_unreadable_table_degrades_to_empty(tmp_path, monkeypatch):
    path = tmp_path / "garbage.json"
    path.write_text("{not json")
    monkeypatch.setenv(ENV_TABLE_VAR, str(path))
    assert tuned_default("sparse_layout", "unsorted") == "unsorted"
    assert jax_autotune.tuned_default("sparse_layout", "unsorted",
                                      mesh="cpu/cpu/1") == "unsorted"


@pytest.mark.parametrize("args", [
    ("cuda", "NVIDIA H100 80GB HBM3", 1),
    ("cuda", "NVIDIA H100 80GB HBM3", 4),
    ("cpu", "cpu", 8),
    ("tpu", "TPU v4", 4),
    ("gpu", "A/B c+d", 2),
])
def test_mesh_key_explicit_equals_jax(args):
    assert mesh_key(*args) == jax_autotune.mesh_key(*args)


def test_mesh_key_of_this_thread():
    """The port's current mesh: the compute device and the default
    process group's world size (1 without one)."""
    assert mesh_key() == "cpu/cpu/1"


# -- lookup precedence -------------------------------------------------------


def test_tuned_default_precedence(tuned, monkeypatch):
    tuned({"sparse_layout": "cumsum"})
    assert tuned_default("sparse_layout", "unsorted") == "cumsum"
    # FLINKML_TPU_AUTOTUNE=0 turns the table layer off.
    monkeypatch.setenv(ENV_DISABLE_VAR, "0")
    assert tuned_default("sparse_layout", "unsorted") == "unsorted"
    monkeypatch.delenv(ENV_DISABLE_VAR)
    # a value outside `allowed` degrades to the fallback, loudly-once.
    assert tuned_default("sparse_layout", "unsorted",
                         allowed=("unsorted", "sorted")) == "unsorted"
    # another mesh's entry is invisible here.
    tuned({"sparse_layout": "cumsum"}, mesh="tpu/TPU_v4/8")
    assert tuned_default("sparse_layout", "unsorted") == "unsorted"


LOOKUPS = [
    ("sparse_layout", "unsorted", None, "cpu/cpu/1"),
    ("sparse_layout", "unsorted", ("unsorted", "sorted"), "cpu/cpu/1"),
    ("sparse_layout", "unsorted", None, "cpu/cpu/2"),
    ("serving_max_batch_rows", 1024, None, "cpu/cpu/1"),
    ("infer_plan_order", None, None, "cpu/cpu/1"),
    ("w2v_accum", "scatter", ("scatter", "onehot"), "cpu/cpu/1"),
]


@pytest.mark.parametrize("disabled", [False, True])
def test_tuned_default_equals_jax(tmp_path, monkeypatch, disabled):
    """The same table, env and arguments give the same value in both
    packages, including ``FLINKML_TPU_AUTOTUNE=0``."""
    table = TuningTable()
    table.set_knob("cpu/cpu/1", "sparse_layout", "cumsum",
                   candidates={"cumsum": 2.0}, source="t")
    table.set_knob("cpu/cpu/1", "serving_max_batch_rows", 512,
                   candidates={"512": 2.0}, source="t")
    table.set_knob("cpu/cpu/1", "infer_plan_order", ["fsdp"],
                   candidates={"fsdp": 2.0}, source="t")
    table.set_knob("cpu/cpu/1", "w2v_accum", "onehot",
                   candidates={"onehot": 2.0}, source="t")
    monkeypatch.setenv(ENV_TABLE_VAR, table.save(str(tmp_path / "t.json")))
    if disabled:
        monkeypatch.setenv(ENV_DISABLE_VAR, "0")
    for knob, fallback, allowed, mesh in LOOKUPS:
        assert tuned_default(knob, fallback, allowed, mesh) == \
            jax_autotune.tuned_default(knob, fallback, allowed, mesh)


def test_bad_table_value_degrades_with_one_log_line(tuned, caplog):
    tuned({"gbt_histogram": "bogus"})
    from flinkml_tpu_torch.models.gbt import resolve_hist_layout

    with caplog.at_level(logging.WARNING, logger="flinkml_tpu_torch"):
        assert resolve_hist_layout() == "segment"
        assert resolve_hist_layout() == "segment"
    assert sum("is not one of" in r.getMessage()
               for r in caplog.records) == 1


def test_gates_consult_table_env_wins(tuned):
    """The four layout keywords take the table when left None; an
    explicit keyword beats it everywhere (the port's counterpart of the
    JAX env gates)."""
    from flinkml_tpu_torch.models import _linear_sgd, als, gbt, word2vec

    tuned({
        "sparse_layout": "cumsum",
        "gbt_histogram": "cumsum",
        "als_reduction": "cumsum",
        "w2v_accum": "onehot",
    })
    assert _linear_sgd.resolve_layout() == "cumsum"
    assert gbt.resolve_hist_layout() == "cumsum"
    assert als.resolve_layout() == "cumsum"
    assert word2vec.resolve_accum() == "onehot"
    # the explicit keyword beats the table everywhere.
    assert _linear_sgd.resolve_layout("sorted") == "sorted"
    assert gbt.resolve_hist_layout("segment") == "segment"
    assert als.resolve_layout("segment") == "segment"
    assert word2vec.resolve_accum("scatter") == "scatter"
    assert gbt.GBTClassifier().hist_layout is None
    assert als.ALS().layout is None and word2vec.Word2Vec().accum is None
    with pytest.raises(ValueError, match="expected"):
        als.ALS(layout="bogus")


def _als_table():
    from flinkml_tpu_torch.table import Table

    rng = np.random.default_rng(0)
    return Table({
        "user": rng.integers(0, 40, size=600).astype(np.int32),
        "item": rng.integers(0, 30, size=600).astype(np.int32),
        "rating": rng.uniform(1, 5, size=600).astype(np.float32),
    })


def _sparse_csr():
    rng = np.random.default_rng(1)
    n, dim, nnz = 96, 50, 4
    indptr = np.arange(n + 1, dtype=np.int64) * nnz
    indices = rng.integers(0, dim, size=n * nnz).astype(np.int32)
    values = rng.normal(size=n * nnz).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    return indptr, indices, values, dim, y, np.ones(n, np.float32)


@pytest.mark.parametrize("fit", ["als", "sparse_lr"])
def test_tuned_layout_fits_as_the_explicit_keyword(tuned, fit):
    """A fit that leaves its layout to the table runs the table's layout:
    the same bits as the fit that names it."""
    from flinkml_tpu_torch.models import _linear_sgd
    from flinkml_tpu_torch.models.als import ALS

    tuned({"als_reduction": "cumsum", "sparse_layout": "cumsum"})
    if fit == "als":
        def run(layout):
            return ALS(layout=layout).set_rank(3).set_max_iter(2) \
                .set_seed(0).fit(_als_table()).user_factors
    else:
        def run(layout):
            return _linear_sgd.train_linear_model_sparse_csr(
                *_sparse_csr(), "logistic", 5, 0.1, 32, 0.0, 0.0, 0.0, 0,
                layout=layout)
    assert np.asarray(run(None)).tobytes() == \
        np.asarray(run("cumsum")).tobytes()


def test_infer_plan_consults_measured_order(tuned):
    from flinkml_tpu_torch.sharding.plan import (
        BATCH_PARALLEL,
        FSDP,
        infer_plan,
    )

    shapes = {"coef": (64,)}
    mesh = {"data": 2, "fsdp": 4}
    # Static order: batch_parallel fits -> wins.
    assert infer_plan(mesh, shapes, hbm_budget_bytes=1 << 20).name == \
        "batch_parallel"
    # A measured order promoting fsdp flips the default choice...
    tuned({"infer_plan_order": ["fsdp", "batch_parallel", "fsdp_tp"]})
    assert infer_plan(mesh, shapes, hbm_budget_bytes=1 << 20).name == "fsdp"
    # ...while explicit candidates are untouched by the table.
    assert infer_plan(
        mesh, shapes, hbm_budget_bytes=1 << 20,
        candidates=(BATCH_PARALLEL, FSDP),
    ).name == "batch_parallel"


class _Identity:
    def transform(self, table):
        return (table.with_column(
            "out", np.asarray(table.column("features")) * 2.0
        ),)


def test_serving_config_consults_table(tuned):
    from flinkml_tpu_torch.serving.engine import ServingConfig, ServingEngine
    from flinkml_tpu_torch.table import Table

    tuned({"serving_max_batch_rows": 512, "serving_window_ms": 1.5})
    example = Table({"features": np.ones((4, 2))})
    engine = ServingEngine(_Identity(), example, name="tuned-cfg")
    assert engine.config.max_batch_rows == 512
    assert engine.config.max_wait_ms == 1.5
    # explicit values always win over the table.
    engine2 = ServingEngine(
        _Identity(), example,
        ServingConfig(max_batch_rows=64, max_wait_ms=3.0),
        name="explicit-cfg",
    )
    assert engine2.config.max_batch_rows == 64
    assert engine2.config.max_wait_ms == 3.0


def _autoscaler_threshold(explicit=None):
    from flinkml_tpu_torch.serving import (
        AutoscaleConfig, PoolAutoscaler, ReplicaPool,
    )
    from flinkml_tpu_torch.table import Table

    pool = ReplicaPool(_Identity(), Table({"features": np.ones((4, 2))}),
                       output_cols=("out",), name="tuned-as")
    return PoolAutoscaler(
        pool, AutoscaleConfig(scale_up_backlog=explicit))._up_threshold


def _int8_threshold(explicit=None):
    import os

    from flinkml_tpu_torch import precision

    if explicit is None:
        return precision.int8_min_const_elems()
    os.environ[precision.ENV_INT8_MIN_CONST_VAR] = str(explicit)
    try:
        return precision.int8_min_const_elems()
    finally:
        del os.environ[precision.ENV_INT8_MIN_CONST_VAR]


def _exchange(explicit=None):
    import os

    from flinkml_tpu_torch.embeddings.exchange import (
        ENV_VAR, exchange_strategy,
    )

    if explicit is None:
        return exchange_strategy()
    os.environ[ENV_VAR] = explicit
    try:
        return exchange_strategy()
    finally:
        del os.environ[ENV_VAR]


def _deadline_multiplier(explicit=None):
    from flinkml_tpu_torch.serving.grayfail import GrayFailPolicy

    return GrayFailPolicy(
        deadline_multiplier=explicit).resolved_deadline_multiplier()


CONSUMERS = {
    # consumer: (resolve, knob, static, table value, explicit value)
    "autoscaler": (_autoscaler_threshold, "serving_scale_up_backlog", 0.5,
                   0.25, 0.75),
    "int8": (_int8_threshold, "int8_min_const_elems", 16, 64, 4),
    "exchange": (_exchange, "embedding_exchange", "ring", "all_to_all",
                 "ring"),
    "grayfail": (_deadline_multiplier, "serving_deadline_multiplier", 4.0,
                 2.5, 6.0),
}


@pytest.mark.parametrize("name", sorted(CONSUMERS))
def test_consumers_consult_table(tmp_path, monkeypatch, name):
    """Every other stand-in resolves explicit > table > static, as the
    JAX package's consumer does."""
    resolve, knob, static, value, explicit = CONSUMERS[name]
    assert resolve() == static
    # (the grayfail knob is consulted but not a KNOWN_KNOB in either
    # package: a hand-written entry)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": 1, "entries": {"cpu/cpu/1": {
        knob: {"value": value, "candidates": {str(value): 1.0},
               "measured_at": "x", "source": "y", "unit": "u"}}}}))
    monkeypatch.setenv(ENV_TABLE_VAR, str(path))
    assert resolve() == value
    assert resolve(explicit) == explicit


@pytest.mark.parametrize("name,bad", [
    ("autoscaler", 1.5), ("int8", -3), ("exchange", "dense_psum"),
    ("grayfail", "fast"),
])
def test_consumers_degrade_bad_table_values(tmp_path, monkeypatch, name,
                                            bad):
    resolve, knob, static, _, _ = CONSUMERS[name]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": 1, "entries": {"cpu/cpu/1": {
        knob: {"value": bad, "candidates": {"x": 1.0},
               "measured_at": "x", "source": "y", "unit": "u"}}}}))
    monkeypatch.setenv(ENV_TABLE_VAR, str(path))
    assert resolve() == static


# -- hysteresis --------------------------------------------------------------


def test_settle_hysteresis():
    # within the floor: incumbent keeps the seat (noise cannot flip).
    assert settle("sparse_layout",
                  {"unsorted": 100.0, "cumsum": 105.0}) == "unsorted"
    # decisive win: challenger takes it.
    assert settle("sparse_layout",
                  {"unsorted": 100.0, "cumsum": 100.0 * RATIO_FLOOR * 1.05}
                  ) == "cumsum"
    # numeric knobs keep their type.
    assert settle("serving_max_batch_rows",
                  {"1024": 100.0, "2048": 200.0}) == 2048
    assert settle("serving_window_ms",
                  {"2.0": 100.0, "1.0": 101.0}) == 2.0
    # a COMMITTED winner defends the seat, not the static default.
    assert settle("sparse_layout",
                  {"unsorted": 105.0, "cumsum": 100.0},
                  incumbent="cumsum") == "cumsum"
    assert settle("sparse_layout",
                  {"unsorted": 100.0 * RATIO_FLOOR * 1.05, "cumsum": 100.0},
                  incumbent="cumsum") == "unsorted"


CANDIDATE_NAMES = {
    "sparse_layout": ("unsorted", "sorted", "cumsum"),
    "gbt_histogram": ("segment", "cumsum"),
    "w2v_accum": ("scatter", "onehot"),
    "serving_max_batch_rows": ("256", "512", "1024", "2048"),
    "serving_window_ms": ("0.5", "1.0", "2.0", "4.0"),
    "serving_scale_up_backlog": ("0.25", "0.5", "0.75"),
    "int8_min_const_elems": ("4", "16", "64", "256"),
    "embedding_exchange": ("ring", "all_to_all", "dense_psum"),
}

_rates = st.floats(min_value=0.01, max_value=1e7, allow_nan=False)


@st.composite
def _settle_case(draw):
    knob = draw(st.sampled_from(sorted(CANDIDATE_NAMES)))
    names = draw(st.lists(st.sampled_from(CANDIDATE_NAMES[knob]),
                          min_size=1, unique=True))
    cands = {n: draw(_rates) for n in names}
    incumbent = draw(st.sampled_from([None] + list(CANDIDATE_NAMES[knob])))
    if incumbent is not None and knob in ("serving_max_batch_rows",
                                          "int8_min_const_elems"):
        incumbent = int(incumbent)
    elif incumbent is not None and knob in ("serving_window_ms",
                                            "serving_scale_up_backlog"):
        incumbent = float(incumbent)
    return knob, cands, incumbent


@settings(max_examples=150, deadline=None)
@given(_settle_case())
def test_settle_equals_jax(case):
    knob, cands, incumbent = case
    got = settle(knob, dict(cands), incumbent)
    want = jax_search.settle(knob, dict(cands), incumbent)
    assert got == want and type(got) is type(want)


@settings(max_examples=150, deadline=None)
@given(st.dictionaries(st.sampled_from(("batch_parallel", "fsdp",
                                        "fsdp_tp", "embedding")),
                       _rates))
def test_order_presets_equals_jax(cands):
    assert order_presets(dict(cands)) == jax_search.order_presets(
        dict(cands))


def test_order_presets_promotion():
    static = STATIC_DEFAULTS["infer_plan_order"]
    # ties / within-floor keep the static (cheapest-communication) order
    assert order_presets(
        {"batch_parallel": 100.0, "fsdp": 105.0, "fsdp_tp": 50.0}
    ) == static
    # a decisive fsdp win promotes it past batch_parallel only
    assert order_presets(
        {"batch_parallel": 100.0, "fsdp": 150.0, "fsdp_tp": 50.0}
    ) == ["fsdp", "batch_parallel", "fsdp_tp"]


def test_static_defaults_are_jax_less_kernel_backends():
    jax_static = {k: v for k, v in jax_search.STATIC_DEFAULTS.items()
                  if k not in UNCONSULTED_KNOBS}
    assert STATIC_DEFAULTS == jax_static
    assert set(KNOWN_KNOBS) == set(jax_autotune.KNOWN_KNOBS) - set(
        UNCONSULTED_KNOBS)
    assert RATIO_FLOOR == jax_search.RATIO_FLOOR


# -- the committed table -----------------------------------------------------


def test_committed_table_has_measured_values_for_this_mesh():
    """The acceptance pin: the committed table carries values MEASURED on
    one H100 by the port's search — winner, candidates, stamp, and a
    source naming the card and its power limit — for every knob a
    one-card search measures, and nothing else (no entry copied from the
    JAX package's table, which was measured on its virtual CPU mesh)."""
    table = load_table(DEFAULT_TABLE_PATH)
    assert table.check() == []
    assert table.meshes() == (H100_MESH,)
    assert sorted(table.data["entries"][H100_MESH]) == sorted(ONE_CARD_KNOBS)
    for knob in ONE_CARD_KNOBS:
        rec = table.record(H100_MESH, knob)
        assert rec["candidates"], f"{knob}: no measured candidates"
        assert rec["measured_at"], knob
        assert "NVIDIA H100" in rec["source"] and " W" in rec["source"], \
            rec["source"]
    assert set(table.record(H100_MESH, "sparse_layout")["candidates"]) == \
        {"unsorted", "sorted", "cumsum"}
    assert set(table.record(H100_MESH, "gbt_histogram")["candidates"]) == \
        {"segment", "cumsum"}
    assert set(table.record(H100_MESH, "als_reduction")["candidates"]) == \
        {"segment", "cumsum"}
    # onehot runs on CPU tables only: refused on the card, not measured.
    w2v = table.record(H100_MESH, "w2v_accum")
    assert set(w2v["candidates"]) == {"scatter"}
    assert set(w2v["refused"]) == {"onehot"}


def test_quick_search_smoke(tmp_path):
    """The search harness itself, smoke-size, on the CPU: GBT's two
    layouts measured; the plan order measures nothing at world 1 and is
    left out. The full run is `python -m flinkml_tpu_torch.autotune
    --commit` on the card."""
    from flinkml_tpu_torch.autotune.search import apply_results, search_knobs

    results = search_knobs(["infer_plan_order", "gbt_histogram"],
                           quick=True)
    assert set(results) == {"gbt_histogram"}
    rec = results["gbt_histogram"]
    assert set(rec["candidates"]) == {"segment", "cumsum"}
    assert all(v > 0 for v in rec["candidates"].values())
    assert rec["value"] in ("segment", "cumsum")
    table = apply_results(TuningTable(), results, mesh="cpu/cpu/1")
    path = table.save(str(tmp_path / "out.json"))
    assert load_table(path).check() == []


_TWO_RANK_KNOBS = """
import json
import flinkml_tpu_torch as fml
from flinkml_tpu_torch.autotune import mesh_key, search
from flinkml_tpu_torch.parallel import init_distributed, shutdown_distributed
from tests._torch_threads import cap_torch_threads
cap_torch_threads()
fml.set_default_device("cpu")
init_distributed()
print(json.dumps({"mesh": mesh_key(),
                  "plan": search.measure_infer_plan_order(quick=True),
                  "exchange": search.measure_embedding_exchange(quick=True)}))
shutdown_distributed()
"""


def test_multi_rank_knobs_measure_on_two_ranks(tmp_path):
    """The two knobs a one-card search leaves out measure on a world of
    two gloo ranks (mesh ``cpu/cpu/2``): every preset of the plan order
    and every exchange candidate gets a positive rate."""
    import os
    import sys

    from flinkml_tpu_torch.parallel.launch import spawn_ranks

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results = spawn_ranks([sys.executable, "-c", _TWO_RANK_KNOBS], 2,
                          str(tmp_path), 240,
                          env=dict(os.environ, PYTHONPATH=repo))
    for r in results:
        assert r.returncode == 0, r.stderr[-3000:]
        rep = json.loads(r.stdout.strip().splitlines()[-1])
        assert rep["mesh"] == "cpu/cpu/2"
        assert set(rep["plan"]) == set(STATIC_DEFAULTS["infer_plan_order"])
        assert set(rep["exchange"]) == {"ring", "all_to_all", "dense_psum"}
        assert all(v > 0 for d in (rep["plan"], rep["exchange"])
                   for v in d.values())
