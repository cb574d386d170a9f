"""The port's graph validator and AST lint (FML101–FML107, FML201–FML203).

The cases of ``tests/test_analysis_validator.py`` on the port's stages,
under ``use_device("cpu")``. Where the JAX package's case runs here
(schema flow, ordering, graph wiring, the lint), the JAX validator over
the same stages of the JAX package gives the same rule ids. Where it
cannot (its kernel evaluation needs ``jax.experimental.enable_x64``, gone
in jax 0.9.0: the clean-chain sweep and FML106), the port is held to the
rule's meaning: every shipped kernel-capable stage evaluates clean under
the port's compute-dtype rule (a float32 column stays float32), and a
kernel that casts to float64 is flagged.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.analysis import (
    analyze_graph,
    analyze_pipeline,
    kernel_output_specs,
    lint_paths,
    lint_source,
    schema_of,
    stage_io,
)
from flinkml_tpu_torch.api import AlgoOperator, ColumnKernel
from flinkml_tpu_torch.graph import GraphBuilder
from flinkml_tpu_torch.models.kmeans import KMeans, KMeansModel
from flinkml_tpu_torch.models.logistic_regression import LogisticRegression
from flinkml_tpu_torch.models.one_hot_encoder import OneHotEncoder
from flinkml_tpu_torch.models.scalers import (
    MaxAbsScaler,
    MinMaxScaler,
    RobustScaler,
    StandardScaler,
)
from flinkml_tpu_torch.models.vector_assembler import VectorAssembler
from flinkml_tpu_torch.pipeline import PipelineModel
from flinkml_tpu_torch.table import Table

from tests._torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(autouse=True)
def _cpu():
    with fml.use_device("cpu"):
        yield


def _rules(report):
    return sorted(f.rule for f in report)


def _data(n=40, d=5, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(dtype)
    y = (x @ rng.normal(size=d).astype(dtype) > 0).astype(dtype)
    return Table({"features": x, "label": y})


def _scaler(cls, t, in_col, out_col):
    return cls().set(cls.INPUT_COL, in_col).set(cls.OUTPUT_COL, out_col).fit(t)


def _fitted_chain(t):
    stages, cur, prev = [], t, "features"
    for i, cls in enumerate(
            (StandardScaler, MinMaxScaler, MaxAbsScaler, RobustScaler), 1):
        m = _scaler(cls, cur, prev, f"s{i}")
        (cur,) = m.transform(cur)
        prev = f"s{i}"
        stages.append(m)
    lr = (LogisticRegression().set(LogisticRegression.FEATURES_COL, prev)
          .set(LogisticRegression.LABEL_COL, "label").fit(cur))
    return stages + [lr]


def test_clean_chain_and_every_shipped_kernel():
    t = _data()
    stages = _fitted_chain(t)
    assert not analyze_pipeline(PipelineModel(stages), schema_of(t)).findings
    km = (KMeans().set(KMeans.FEATURES_COL, "features").set(KMeans.K, 2)
          .set(KMeans.PREDICTION_COL, "cluster").fit(t))
    enc = (OneHotEncoder().set_input_cols(["c1"]).set_output_cols(["o1"])
           .set_handle_invalid("keep")
           .fit(Table({"c1": np.array([0.0, 1.0, 2.0])})))
    t2 = t.with_column("c1", np.zeros(len(t)))
    report = analyze_pipeline(PipelineModel(stages + [km, enc]),
                              schema_of(t2))
    assert not report.findings, report.render()
    assert not analyze_pipeline(iter(stages), schema_of(t)).findings


def test_missing_input_column_fml101():
    t = _data()
    m = _scaler(StandardScaler, t, "features", "out")
    m.set(StandardScaler.INPUT_COL, "nope")
    report = analyze_pipeline(PipelineModel([m]), schema_of(t))
    (f,) = [f for f in report if f.rule == "FML101"]
    assert f.column == "nope" and "features" in f.message


def test_output_collision_fml102():
    t = _data()
    a = _scaler(StandardScaler, t, "features", "out")
    b = _scaler(MaxAbsScaler, a.transform(t)[0], "out", "out")
    assert "FML102" in _rules(analyze_pipeline(PipelineModel([a, b]),
                                               schema_of(t)))
    c = _scaler(MinMaxScaler, t, "features", "label")
    assert "FML102" in _rules(analyze_pipeline(PipelineModel([c]),
                                               schema_of(t)))


def test_shape_mismatch_fml103():
    t = _data(d=4)
    s = _scaler(StandardScaler, t, "features", "scaled")
    km = KMeansModel().set(KMeansModel.FEATURES_COL, "scaled")
    km.set_model_data(Table({"centroids": np.zeros((1, 3, 7))}))
    assert "FML103" in _rules(analyze_pipeline(PipelineModel([s, km]),
                                               schema_of(t)))


class _HostStage(AlgoOperator):
    def transform(self, *inputs):
        return inputs


def test_fusion_break_fml104():
    t = _data()
    a = _scaler(StandardScaler, t, "features", "a")
    b = _scaler(MaxAbsScaler, a.transform(t)[0], "a", "b")
    report = analyze_pipeline(PipelineModel([a, _HostStage(), b]),
                              schema_of(t))
    assert "FML104" in _rules(report)


def test_unstable_fingerprint_fml105():
    import dataclasses

    t = _data()
    base = _scaler(StandardScaler, t, "features", "a")
    b = _scaler(MaxAbsScaler, base.transform(t)[0], "a", "b")
    tick = [0]
    real = base.transform_kernel

    def unstable():
        tick[0] += 1
        k = real()
        return dataclasses.replace(k, fingerprint=k.fingerprint + (tick[0],))

    base.transform_kernel = unstable
    report = analyze_pipeline(PipelineModel([base, b]), schema_of(t))
    assert "FML105" in _rules(report)


def test_ordering_error_fml107_open_schema_like_jax():
    from flinkml_tpu.analysis import analyze_pipeline as jax_analyze
    from flinkml_tpu.models.scalers import (
        MaxAbsScaler as JMaxAbs,
        StandardScaler as JStd,
    )

    def chain(std, maxabs):
        producer = std().set(std.INPUT_COL, "features").set(
            std.OUTPUT_COL, "scaled")
        consumer = maxabs().set(maxabs.INPUT_COL, "scaled").set(
            maxabs.OUTPUT_COL, "z")
        return [consumer, producer]

    got = _rules(analyze_pipeline(chain(StandardScaler, MaxAbsScaler)))
    assert got == _rules(jax_analyze(chain(JStd, JMaxAbs)))
    # The read of "scaled" before its producer; the producer's write then
    # overwrites what the open schema took for a source column.
    assert got == ["FML102", "FML107"]


def test_float32_chain_stays_float32_no_fml106():
    t = _data(dtype=np.float32)
    pm = PipelineModel(_fitted_chain(t)[:4])
    report = analyze_pipeline(pm, schema_of(t))
    assert "FML106" not in _rules(report), report.render()
    specs = kernel_output_specs(pm.stages[0].transform_kernel(), schema_of(t))
    assert specs["s1"].dtype == np.float32 and specs["s1"].tail == (5,)
    (fused,) = pm.transform(t)
    assert fused.column("s4").dtype == np.float32
    rng = np.random.default_rng(3)
    t2 = Table({"a": rng.normal(size=(20, 3)).astype(np.float32),
                "b": rng.normal(size=20).astype(np.float32)})
    va = (VectorAssembler().set(VectorAssembler.INPUT_COLS, ["a", "b"])
          .set(VectorAssembler.HANDLE_INVALID, "keep")
          .set(VectorAssembler.OUTPUT_COL, "asm"))
    assert "FML106" not in _rules(analyze_pipeline([va], schema_of(t2)))


class _Promoter(AlgoOperator):
    def transform(self, *inputs):
        (t,) = inputs
        return (t.with_column("wide", t.column("x").astype(np.float64)),)

    def transform_kernel(self):
        def fn(cols, consts, valid):
            return {"wide": cols["x"].to(torch.float64)}

        return ColumnKernel(("x",), ("wide",), fn, fingerprint=("Promoter",))


def test_float64_promotion_flagged_fml106_and_localized():
    t = Table({"x": np.ones(8, dtype=np.float32)})
    (f,) = [f for f in analyze_pipeline([_Promoter()], schema_of(t))
            if f.rule == "FML106"]
    assert f.column == "wide" and "_to_copy" in f.message


def test_object_vector_column_not_abstract_evaluated():
    from flinkml_tpu_torch.linalg import DenseVector

    rng = np.random.default_rng(0)
    col = np.empty(10, dtype=object)
    for i in range(10):
        col[i] = DenseVector(rng.normal(size=3))
    dense = Table({"features": rng.normal(size=(10, 3))})
    m = _scaler(StandardScaler, dense, "features", "out")
    report = analyze_pipeline(PipelineModel([m]),
                              schema_of(Table({"features": col})))
    assert "FML103" not in _rules(report), report.render()


def test_schema_of_device_and_bfloat16_columns():
    t = Table({"x": torch.zeros(4, 3, dtype=torch.bfloat16),
               "y": np.zeros(4, np.int32)})
    s = schema_of(t)
    assert s["x"].dtype == torch.bfloat16 and s["x"].tail == (3,)
    assert s["y"].dtype == np.int32 and s["y"].known
    io = stage_io(StandardScaler().set(StandardScaler.INPUT_COL, "x"))
    assert io.inputs == ("x",) and not io.opaque


def _graphs(pkg_graph, std):
    def build(missing_input):
        builder = pkg_graph.GraphBuilder().set_max_output_table_num(1)
        src = builder.create_table_id()
        dangling = builder.create_table_id()
        s = std().set(std.INPUT_COL, "features").set(std.OUTPUT_COL,
                                                     "scaled")
        outs = builder.add_estimator(s, dangling if missing_input else src)
        return builder.build_estimator([src], outs)

    def unproduced():
        builder = pkg_graph.GraphBuilder().set_max_output_table_num(1)
        src = builder.create_table_id()
        builder.add_estimator(std(), src)
        return builder.build_estimator([src], [builder.create_table_id()])

    def duplicate():
        builder = pkg_graph.GraphBuilder().set_max_output_table_num(1)
        src = builder.create_table_id()
        (o1,) = builder.add_estimator(std(), src)
        builder.add_estimator(std(), src)
        g = builder.build_estimator([src], [o1])
        g._nodes[1].output_ids = list(g._nodes[0].output_ids)
        return g

    return {"clean": build(False), "missing": build(True),
            "unproduced": unproduced(), "duplicate": duplicate()}


def test_graph_wiring_like_jax():
    import flinkml_tpu.graph as jgraph
    from flinkml_tpu.analysis import analyze_graph as jax_graph
    from flinkml_tpu.models.scalers import StandardScaler as JStd

    import flinkml_tpu_torch.graph as pgraph

    port, jax = _graphs(pgraph, StandardScaler), _graphs(jgraph, JStd)
    want = {"clean": [], "missing": ["FML201"], "unproduced": ["FML202"],
            "duplicate": ["FML203"]}
    for name, rules in want.items():
        got = _rules(analyze_graph(port[name]))
        assert got == _rules(jax_graph(jax[name])), name
        assert set(rules) <= set(got), (name, got)
    assert GraphBuilder is pgraph.GraphBuilder


def test_lint_examples_and_inline_sources():
    assert not lint_paths(["examples/"]).findings
    src = """
from flinkml_tpu_torch.models import VectorAssembler, StandardScaler
from flinkml_tpu_torch.pipeline import Pipeline
d = 3
pipe = Pipeline([
    VectorAssembler().set_input_cols([f"f{i}" for i in range(d)])
                     .set(VectorAssembler.OUTPUT_COL, "input"),
    StandardScaler(),
])
"""
    assert not lint_source(src, "inline.py").findings
    bad = """
from flinkml_tpu_torch.models import VectorAssembler, StandardScaler
from flinkml_tpu_torch.pipeline import Pipeline
pipe = Pipeline([
    StandardScaler(),
    VectorAssembler().set_input_cols(["a"])
                     .set(VectorAssembler.OUTPUT_COL, "input"),
])
"""
    assert "FML107" in _rules(lint_source(bad, "inline.py"))
    assert _rules(lint_source("def (:", "broken.py")) == ["FML101"]


def test_fused_run_evaluation_matches_the_executor():
    t = _data(dtype=np.float32)
    pm = PipelineModel(_fitted_chain(t))
    kernels = [s.transform_kernel() for s in pm.stages]
    specs = {}
    schema = schema_of(t)
    for k in kernels:
        out = kernel_output_specs(k, {**schema, **specs})
        specs.update(out)
    pipeline_fusion.reset_cache()
    (fused,) = pm.transform(t)
    for name, s in specs.items():
        col = fused.column(name)
        assert col.dtype == s.dtype and tuple(col.shape[1:]) == s.tail
