"""The port's graph API (``flinkml_tpu_torch.graph``) against the JAX
package's, on the CPU.

A mirror of ``tests/test_graph.py`` (the reference's ``GraphTest``) on
port fixture stages, and the graph save/load cases on the port's own
stages (the loader resolves port classes only). Across packages: a
``GraphModel`` and a ``Graph`` saved by JAX load in the port and give the
same outputs, a graph saved by the port loads in JAX, and a
StandardScaler → LogisticRegression graph equals the same stages as a
``Pipeline``.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import jax
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu import graph as jax_graph
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models import scalers as jax_scalers
from flinkml_tpu.parallel import DeviceMesh as JaxMesh
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.api import AlgoOperator, Estimator, Model
from flinkml_tpu_torch.graph import Graph, GraphBuilder, GraphModel
from flinkml_tpu_torch.params import IntParam
from flinkml_tpu_torch.table import Table
from tests._torch_port_common import on_cpu  # noqa: F401


class SumModel(Model):
    """Adds a fitted delta to the 'value' column."""

    DELTA = IntParam("delta", "value added to inputs", 0)

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        return (table.with_column(
            "value", table.column("value") + self.get(SumModel.DELTA)),)

    def set_model_data(self, *inputs: Table) -> "SumModel":
        (table,) = inputs
        self.set(SumModel.DELTA, int(table.column("delta")[0]))
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"delta": np.array([self.get(SumModel.DELTA)])})]


class SumEstimator(Estimator):
    def fit(self, *inputs: Table) -> SumModel:
        (table,) = inputs
        model = SumModel()
        model.set(SumModel.DELTA, int(np.sum(table.column("value"))))
        return model


class UnionAlgoOperator(AlgoOperator):
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        out = inputs[0]
        for t in inputs[1:]:
            out = out.concat(t)
        return (out,)


def make_table(values):
    return Table({"value": np.asarray(values)})


def test_linear_graph_fit_transform():
    b = GraphBuilder()
    src = b.create_table_id()
    out1 = b.add_estimator(SumEstimator(), src)
    out2 = b.add_algo_operator(SumModel().set(SumModel.DELTA, 7), out1[0])
    gm = b.build_estimator([src], [out2[0]]).fit(make_table([1, 2, 3]))
    (out,) = gm.transform(make_table([0]))
    assert out.column("value")[0] == 13


def test_dag_with_union():
    b = GraphBuilder()
    a, c = b.create_table_id(), b.create_table_id()
    merged = b.add_algo_operator(UnionAlgoOperator(), a, c)
    out = b.add_estimator(SumEstimator(), merged[0])
    gm = b.build_estimator([a, c], [out[0]]).fit(make_table([1]),
                                                 make_table([2, 3]))
    (res,) = gm.transform(make_table([0]), make_table([0]))
    assert np.array_equal(res.column("value"), [6, 6])


def test_graph_model_data_wiring():
    b = GraphBuilder()
    src = b.create_table_id()
    est = SumEstimator()
    out = b.add_estimator(est, src)
    model_data = b.get_model_data_from_estimator(est)
    graph = b.build_estimator([src], [out[0]],
                              output_model_data=[model_data[0]])
    gm = graph.fit(make_table([1, 2, 3]))
    assert int(gm.get_model_data()[0].column("delta")[0]) == 6


def test_get_model_data_returns_only_wired_tables():
    b = GraphBuilder()
    src = b.create_table_id()
    m1 = SumModel().set(SumModel.DELTA, 1)
    m2 = SumModel().set(SumModel.DELTA, 2)
    o1 = b.add_algo_operator(m1, src)
    o2 = b.add_algo_operator(m2, o1[0])
    d2 = b.get_model_data_from_model(m2)
    gm = b.build_model([src], [o2[0]], output_model_data=[d2[0]])
    gm.transform(make_table([0]))
    data = gm.get_model_data()
    assert len(data) == 1 and int(data[0].column("delta")[0]) == 2


def test_get_model_data_unwired_raises():
    b = GraphBuilder()
    src = b.create_table_id()
    out = b.add_algo_operator(SumModel().set(SumModel.DELTA, 1), src)
    gm = b.build_model([src], [out[0]])
    with pytest.raises(ValueError):
        gm.get_model_data()


def test_set_model_data_arity_checked():
    b = GraphBuilder()
    src, md = b.create_table_id(), b.create_table_id()
    model = SumModel()
    out = b.add_algo_operator(model, src)
    b.set_model_data_on_model(model, md)
    gm = b.build_model([src], [out[0]], input_model_data=[md])
    with pytest.raises(ValueError):
        gm.set_model_data(Table({"delta": np.array([1])}),
                          Table({"delta": np.array([2])}))


def test_graph_set_model_data():
    b = GraphBuilder()
    src, model_data_in = b.create_table_id(), b.create_table_id()
    model = SumModel()
    b.add_algo_operator(model, src)
    b.set_model_data_on_model(model, model_data_in)
    out_ids = b._stage_nodes[id(model)].output_ids
    gm = b.build_model([src], [out_ids[0]], input_model_data=[model_data_in])
    gm.set_model_data(Table({"delta": np.array([42])}))
    (out,) = gm.transform(make_table([1]))
    assert out.column("value")[0] == 43


def test_transform_without_required_model_data_raises():
    b = GraphBuilder()
    src, md = b.create_table_id(), b.create_table_id()
    model = SumModel()
    out = b.add_algo_operator(model, src)
    b.set_model_data_on_model(model, md)
    gm = b.build_model([src], [out[0]], input_model_data=[md])
    with pytest.raises(ValueError, match="set_model_data"):
        gm.transform(make_table([1]))


def test_build_model_rejects_estimator_nodes():
    b = GraphBuilder()
    src = b.create_table_id()
    out = b.add_estimator(SumEstimator(), src)
    with pytest.raises(ValueError):
        b.build_model([src], [out[0]])


def test_unreachable_input_raises():
    b = GraphBuilder()
    src, orphan = b.create_table_id(), b.create_table_id()
    out = b.add_algo_operator(SumModel().set(SumModel.DELTA, 1), orphan)
    graph = b.build_estimator([src], [out[0]])
    with pytest.raises(ValueError):
        graph.fit(make_table([1]))


def test_node_json_equals_jax():
    from tests import example_stages

    maps = []
    for mod, union, est_cls in (
            (fml.graph, UnionAlgoOperator, SumEstimator),
            (jax_graph, example_stages.UnionAlgoOperator,
             example_stages.SumEstimator)):
        b = mod.GraphBuilder().set_max_output_table_num(3)
        src, other = b.create_table_id(), b.create_table_id()
        merged = b.add_algo_operator(union(), src, other)
        est = est_cls()
        b.add_estimator(est, merged[0])
        b.get_model_data_from_estimator(est)
        maps.append([n.to_map() for n in b._nodes])
    assert maps[0] == maps[1]
    back = fml.graph.GraphNode.from_map(maps[1][1])
    assert back.to_map() == maps[1][1]


# -- real stages: save/load, across packages ----------------------------------------


def _census(n=400, d=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + 1.0
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    return x, y


def _scaler_lr_graph(mod, scaler_cls, lr_cls, **lr_kw):
    b = mod.GraphBuilder()
    src = b.create_table_id()
    scaler = scaler_cls().set(scaler_cls.INPUT_COL, "features").set(
        scaler_cls.OUTPUT_COL, "scaled")
    scaled = b.add_estimator(scaler, src)
    lr = lr_cls(**lr_kw).set(lr_cls.FEATURES_COL, "scaled").set_seed(
        3).set_max_iter(12)
    out = b.add_estimator(lr, scaled[0])
    return b.build_estimator([src], [out[0]])


def test_graph_equals_the_pipeline_and_round_trips(tmp_path, on_cpu):
    x, y = _census()
    table = fml.Table({"features": x, "label": y})
    graph = _scaler_lr_graph(fml.graph, fml.StandardScaler,
                             fml.LogisticRegression)
    gm = graph.fit(table)
    (out,) = gm.transform(table)
    pipe = fml.Pipeline([
        fml.StandardScaler().set(fml.StandardScaler.INPUT_COL, "features")
        .set(fml.StandardScaler.OUTPUT_COL, "scaled"),
        fml.LogisticRegression().set(fml.LogisticRegression.FEATURES_COL,
                                     "scaled").set_seed(3).set_max_iter(12),
    ]).fit(table)
    (want,) = pipe.transform(table)
    for col in ("scaled", "prediction", "rawPrediction"):
        np.testing.assert_array_equal(out.column(col), want.column(col))
    gm.save(str(tmp_path / "gm"))
    (again,) = GraphModel.load(str(tmp_path / "gm")).transform(table)
    np.testing.assert_array_equal(again.column("rawPrediction"),
                                  out.column("rawPrediction"))
    graph.save(str(tmp_path / "graph"))
    (refit,) = Graph.load(str(tmp_path / "graph")).fit(table).transform(table)
    np.testing.assert_array_equal(refit.column("rawPrediction"),
                                  out.column("rawPrediction"))


def test_graph_saved_by_jax_loads_in_the_port(tmp_path, on_cpu):
    x, y = _census(seed=1)
    jmesh = JaxMesh(devices=jax.devices()[:1])
    jgraph = _scaler_lr_graph(jax_graph, jax_scalers.StandardScaler,
                              jax_lr.LogisticRegression, mesh=jmesh)
    jtable = JaxTable({"features": x, "label": y})
    jgm = jgraph.fit(jtable)
    jgm.save(str(tmp_path / "jax_gm"))
    jgraph.save(str(tmp_path / "jax_graph"))
    (want,) = jgm.transform(jtable)
    table = fml.Table({"features": x, "label": y})
    loaded = GraphModel.load(str(tmp_path / "jax_gm"))
    assert isinstance(loaded._nodes[1].stage, fml.LogisticRegressionModel)
    (got,) = loaded.transform(table)
    np.testing.assert_allclose(got.column("scaled"), want["scaled"],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.column("rawPrediction"),
                               want["rawPrediction"], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got.column("prediction"),
                                  want["prediction"])
    # The JAX-saved Graph refits in the port as the same graph built in
    # the port does. StandardScaler's statistics are summed in float32 in
    # both packages and agree within rtol 1e-5, not bit for bit (a
    # declared difference), so the refit is held bit for bit against the
    # port's own graph and loosely against JAX's.
    port_graph = Graph.load(str(tmp_path / "jax_graph"))
    (refit,) = port_graph.fit(table).transform(table)
    (own,) = _scaler_lr_graph(fml.graph, fml.StandardScaler,
                              fml.LogisticRegression).fit(table).transform(
        table)
    np.testing.assert_array_equal(refit.column("rawPrediction"),
                                  own.column("rawPrediction"))
    np.testing.assert_allclose(refit.column("rawPrediction"),
                               want["rawPrediction"], rtol=0, atol=1e-6)
    loaded.save(str(tmp_path / "port_gm"))
    with open(os.path.join(tmp_path, "port_gm", "metadata")) as fh:
        assert json.load(fh)["className"] == "flinkml_tpu.graph.GraphModel"
    (back,) = jax_graph.GraphModel.load(str(tmp_path / "port_gm")).transform(
        jtable)
    np.testing.assert_array_equal(back["rawPrediction"],
                                  want["rawPrediction"])
