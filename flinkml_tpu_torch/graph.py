"""Graph / GraphBuilder / GraphModel — DAGs of stages.

The port's counterpart of ``flinkml_tpu.graph`` (parity with
``ml/builder/GraphBuilder.java:39-433``, ``Graph.java:54``,
``GraphModel.java:50``, ``GraphNode.java:33``, ``TableId.java:29``,
``GraphExecutionHelper.java:36-114``):

  - ``GraphBuilder`` records a DAG of stages connected by symbolic
    ``TableId``s (``create_table_id``, ``add_algo_operator``,
    ``add_estimator``, model-data wiring) and builds either a ``Graph``
    (an Estimator) or a ``GraphModel`` (a Model).
  - ``Graph.fit`` executes nodes in topological order: Estimator nodes are
    fit then used to transform; AlgoOperator nodes transform directly; the
    result is a ``GraphModel`` over the fitted stages.
  - Save/load is the JAX package's layout (numbered stage subdirectories
    and the node list under ``graphData`` in the metadata), so a graph
    saved by either package loads in the other; the stages run on the
    port's compute device.

Execution is eager over in-memory ``Table``s.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from flinkml_tpu_torch.api import AlgoOperator, Estimator, Model, Stage
from flinkml_tpu_torch.io import read_write
from flinkml_tpu_torch.table import Table


class TableId:
    """Symbolic handle for a table to be produced at execution time.

    Parity: ``TableId.java:29``.
    """

    def __init__(self, table_id: int):
        self.id = int(table_id)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, TableId) and other.id == self.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:  # pragma: no cover
        return f"TableId({self.id})"


class GraphNode:
    """One stage in the DAG plus its input/output TableIds.

    Parity: ``GraphNode.java:33`` (nodeId, stageType, estimatorInputIds,
    algoOpInputIds, outputIds, inputModelDataIds, outputModelDataIds).
    """

    ESTIMATOR = "ESTIMATOR"
    ALGO_OPERATOR = "ALGO_OPERATOR"

    def __init__(
        self,
        node_id: int,
        stage: Optional[Stage],
        stage_type: str,
        estimator_input_ids: Optional[Sequence[TableId]],
        algo_op_input_ids: Sequence[TableId],
        output_ids: Sequence[TableId],
        input_model_data_ids: Optional[Sequence[TableId]] = None,
        output_model_data_ids: Optional[Sequence[TableId]] = None,
    ):
        self.node_id = node_id
        self.stage = stage
        self.stage_type = stage_type
        self.estimator_input_ids = (
            list(estimator_input_ids) if estimator_input_ids is not None else None
        )
        self.algo_op_input_ids = list(algo_op_input_ids)
        self.output_ids = list(output_ids)
        self.input_model_data_ids = (
            list(input_model_data_ids) if input_model_data_ids is not None else None
        )
        self.output_model_data_ids = (
            list(output_model_data_ids) if output_model_data_ids is not None else None
        )

    # -- JSON --------------------------------------------------------------
    def to_map(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "nodeId": self.node_id,
            "stageType": self.stage_type,
            "algoOpInputIds": [t.id for t in self.algo_op_input_ids],
            "outputIds": [t.id for t in self.output_ids],
        }
        if self.estimator_input_ids is not None:
            out["estimatorInputIds"] = [t.id for t in self.estimator_input_ids]
        if self.input_model_data_ids is not None:
            out["inputModelDataIds"] = [t.id for t in self.input_model_data_ids]
        if self.output_model_data_ids is not None:
            out["outputModelDataIds"] = [t.id for t in self.output_model_data_ids]
        return out

    @staticmethod
    def from_map(m: Dict[str, Any]) -> "GraphNode":
        ids = lambda key: [TableId(i) for i in m[key]] if key in m else None
        return GraphNode(
            node_id=int(m["nodeId"]),
            stage=None,
            stage_type=m["stageType"],
            estimator_input_ids=ids("estimatorInputIds"),
            algo_op_input_ids=[TableId(i) for i in m["algoOpInputIds"]],
            output_ids=[TableId(i) for i in m["outputIds"]],
            input_model_data_ids=ids("inputModelDataIds"),
            output_model_data_ids=ids("outputModelDataIds"),
        )

    def all_input_ids(self) -> List[TableId]:
        out = list(self.algo_op_input_ids)
        if self.estimator_input_ids is not None:
            out += self.estimator_input_ids
        if self.input_model_data_ids is not None:
            out += self.input_model_data_ids
        return out


class _ExecutionContext:
    """Maps TableIds to concrete Tables, executing nodes as they become ready.

    Parity: ``GraphExecutionHelper.java:36-114`` (topological execution of
    ready nodes).
    """

    def __init__(self) -> None:
        self.tables: Dict[TableId, Table] = {}

    def set_tables(self, ids: Sequence[TableId], tables: Sequence[Table]) -> None:
        # A node may declare more output slots than the stage actually
        # produces (max_output_table_num); extra slots stay unassigned. The
        # reverse — more tables than slots — is a misconfiguration.
        if len(tables) > len(ids):
            raise ValueError(
                f"stage produced {len(tables)} tables but only {len(ids)} "
                "output slots are allocated; raise set_max_output_table_num"
            )
        for tid, tbl in zip(ids, tables):
            self.tables[tid] = tbl

    def get_tables(self, ids: Sequence[TableId]) -> Tuple[Table, ...]:
        return tuple(self.tables[tid] for tid in ids)

    def ready(self, node: GraphNode) -> bool:
        return all(tid in self.tables for tid in node.all_input_ids())


def _execute_nodes(
    nodes: Sequence[GraphNode], ctx: _ExecutionContext, fit_mode: bool
) -> List[GraphNode]:
    """Run the DAG; returns fitted model-nodes (Graph.java:81-135 semantics)."""
    pending = list(nodes)
    model_nodes: List[GraphNode] = []
    while pending:
        node = next((n for n in pending if ctx.ready(n)), None)
        if node is None:
            raise ValueError(
                "Graph is not executable: some node inputs are never produced "
                "(cycle or missing input table)"
            )
        pending.remove(node)
        stage = node.stage
        if fit_mode and node.stage_type == GraphNode.ESTIMATOR:
            stage = stage.fit(*ctx.get_tables(node.estimator_input_ids))
        if node.input_model_data_ids is not None:
            stage.set_model_data(*ctx.get_tables(node.input_model_data_ids))
        outputs = stage.transform(*ctx.get_tables(node.algo_op_input_ids))
        ctx.set_tables(node.output_ids, outputs)
        if node.output_model_data_ids is not None:
            ctx.set_tables(node.output_model_data_ids, stage.get_model_data())
        model_nodes.append(
            GraphNode(
                node.node_id,
                stage,
                GraphNode.ALGO_OPERATOR,
                None,
                node.algo_op_input_ids,
                node.output_ids,
                node.input_model_data_ids,
                node.output_model_data_ids,
            )
        )
    return model_nodes


class GraphBuilder:
    """Records stages wired by TableIds; builds Graph/GraphModel.

    Parity: ``GraphBuilder.java:39-433``. Because a stage's output arity is
    unknown until execution, each added stage is given
    ``max_output_table_num`` symbolic outputs (``setMaxOutputTableNum``,
    GraphBuilder.java:61); unused slots are simply never materialized.
    """

    def __init__(self) -> None:
        self._next_table_id = 0
        self._next_node_id = 0
        self._max_output_table_num = 20
        self._nodes: List[GraphNode] = []
        # stage identity → node, for model-data wiring after the fact.
        self._stage_nodes: Dict[int, GraphNode] = {}

    def set_max_output_table_num(self, n: int) -> "GraphBuilder":
        self._max_output_table_num = n
        return self

    def create_table_id(self) -> TableId:
        tid = TableId(self._next_table_id)
        self._next_table_id += 1
        return tid

    def _new_output_ids(self) -> List[TableId]:
        return [self.create_table_id() for _ in range(self._max_output_table_num)]

    def _add_node(self, node: GraphNode, stage: Stage) -> None:
        self._nodes.append(node)
        self._stage_nodes[id(stage)] = node

    def add_algo_operator(self, algo_op: AlgoOperator, *inputs: TableId) -> List[TableId]:
        """Parity: GraphBuilder.addAlgoOperator (:98-122)."""
        outputs = self._new_output_ids()
        node = GraphNode(
            self._next_node_id, algo_op, GraphNode.ALGO_OPERATOR, None, list(inputs), outputs
        )
        self._next_node_id += 1
        self._add_node(node, algo_op)
        return outputs

    def add_estimator(
        self,
        estimator: Estimator,
        *inputs: TableId,
        estimator_inputs: Optional[Sequence[TableId]] = None,
        model_inputs: Optional[Sequence[TableId]] = None,
    ) -> List[TableId]:
        """Parity: GraphBuilder.addEstimator (:124-167).

        With only ``*inputs``, the fitted model transforms the same tables
        the estimator was fit on; ``estimator_inputs``/``model_inputs`` split
        them when they differ.
        """
        if estimator_inputs is None:
            estimator_inputs = list(inputs)
        if model_inputs is None:
            model_inputs = list(inputs)
        outputs = self._new_output_ids()
        node = GraphNode(
            self._next_node_id,
            estimator,
            GraphNode.ESTIMATOR,
            list(estimator_inputs),
            list(model_inputs),
            outputs,
        )
        self._next_node_id += 1
        self._add_node(node, estimator)
        return outputs

    def set_model_data_on_estimator(self, estimator: Estimator, *inputs: TableId) -> None:
        """Parity: GraphBuilder.setModelDataOnEstimator (:169-193)."""
        self._node_of(estimator).input_model_data_ids = list(inputs)

    def set_model_data_on_model(self, model: Model, *inputs: TableId) -> None:
        """Parity: GraphBuilder.setModelDataOnModel (:195-224)."""
        self._node_of(model).input_model_data_ids = list(inputs)

    def get_model_data_from_estimator(self, estimator: Estimator) -> List[TableId]:
        """Parity: GraphBuilder.getModelDataFromEstimator (:226-255)."""
        node = self._node_of(estimator)
        node.output_model_data_ids = self._new_output_ids()
        return node.output_model_data_ids

    def get_model_data_from_model(self, model: Model) -> List[TableId]:
        """Parity: GraphBuilder.getModelDataFromModel (:257-284)."""
        node = self._node_of(model)
        node.output_model_data_ids = self._new_output_ids()
        return node.output_model_data_ids

    def _node_of(self, stage: Stage) -> GraphNode:
        node = self._stage_nodes.get(id(stage))
        if node is None:
            raise ValueError(f"Stage {stage!r} has not been added to this GraphBuilder")
        return node

    # -- builders ----------------------------------------------------------
    def build_estimator(
        self,
        inputs: Sequence[TableId],
        outputs: Sequence[TableId],
        input_model_data: Optional[Sequence[TableId]] = None,
        output_model_data: Optional[Sequence[TableId]] = None,
        model_inputs: Optional[Sequence[TableId]] = None,
    ) -> "Graph":
        """Parity: GraphBuilder.buildEstimator (:286-357)."""
        return Graph(
            list(self._nodes),
            list(inputs),
            list(model_inputs if model_inputs is not None else inputs),
            list(outputs),
            list(input_model_data) if input_model_data is not None else None,
            list(output_model_data) if output_model_data is not None else None,
        )

    def build_algo_operator(
        self, inputs: Sequence[TableId], outputs: Sequence[TableId]
    ) -> "GraphModel":
        """Parity: GraphBuilder.buildAlgoOperator (:359-374)."""
        return self.build_model(inputs, outputs)

    def build_model(
        self,
        inputs: Sequence[TableId],
        outputs: Sequence[TableId],
        input_model_data: Optional[Sequence[TableId]] = None,
        output_model_data: Optional[Sequence[TableId]] = None,
    ) -> "GraphModel":
        """Parity: GraphBuilder.buildModel (:376-433)."""
        for node in self._nodes:
            if node.stage_type == GraphNode.ESTIMATOR:
                raise ValueError(
                    "build_model requires a DAG without Estimator-typed nodes"
                )
        return GraphModel(
            list(self._nodes),
            list(inputs),
            list(outputs),
            list(input_model_data) if input_model_data is not None else None,
            list(output_model_data) if output_model_data is not None else None,
        )


class Graph(Estimator):
    """An Estimator over a DAG of stages. Parity: ``Graph.java:54-135``."""

    def __init__(
        self,
        nodes: List[GraphNode],
        estimator_input_ids: List[TableId],
        model_input_ids: List[TableId],
        output_ids: List[TableId],
        input_model_data_ids: Optional[List[TableId]],
        output_model_data_ids: Optional[List[TableId]],
    ):
        super().__init__()
        self._nodes = nodes
        self._estimator_input_ids = estimator_input_ids
        self._model_input_ids = model_input_ids
        self._output_ids = output_ids
        self._input_model_data_ids = input_model_data_ids
        self._output_model_data_ids = output_model_data_ids

    def fit(self, *inputs: Table) -> "GraphModel":
        if len(inputs) != len(self._estimator_input_ids):
            raise ValueError(
                f"number of provided tables {len(inputs)} does not match the "
                f"expected number of tables {len(self._estimator_input_ids)}"
            )
        ctx = _ExecutionContext()
        ctx.set_tables(self._estimator_input_ids, inputs)
        model_nodes = _execute_nodes(self._nodes, ctx, fit_mode=True)
        gm = GraphModel(
            model_nodes,
            self._model_input_ids,
            self._output_ids,
            self._input_model_data_ids,
            self._output_model_data_ids,
        )
        gm._capture_model_data(ctx)
        return gm

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        _save_graph(self, path, self._nodes, self._graph_meta())

    def _graph_meta(self) -> Dict[str, Any]:
        return {
            "nodes": [n.to_map() for n in self._nodes],
            "estimatorInputIds": [t.id for t in self._estimator_input_ids],
            "modelInputIds": [t.id for t in self._model_input_ids],
            "outputIds": [t.id for t in self._output_ids],
            "inputModelDataIds": [t.id for t in self._input_model_data_ids]
            if self._input_model_data_ids is not None
            else None,
            "outputModelDataIds": [t.id for t in self._output_model_data_ids]
            if self._output_model_data_ids is not None
            else None,
        }

    @classmethod
    def load(cls, path: str) -> "Graph":
        meta = read_write.load_metadata(path)
        g = meta["graphData"]
        nodes = _load_graph_nodes(path, g)
        opt = lambda key: (
            [TableId(i) for i in g[key]] if g.get(key) is not None else None
        )
        return cls(
            nodes,
            [TableId(i) for i in g["estimatorInputIds"]],
            [TableId(i) for i in g["modelInputIds"]],
            [TableId(i) for i in g["outputIds"]],
            opt("inputModelDataIds"),
            opt("outputModelDataIds"),
        )


class GraphModel(Model):
    """A Model over a DAG of fitted stages. Parity: ``GraphModel.java:50``."""

    def __init__(
        self,
        nodes: List[GraphNode],
        input_ids: List[TableId],
        output_ids: List[TableId],
        input_model_data_ids: Optional[List[TableId]],
        output_model_data_ids: Optional[List[TableId]],
    ):
        super().__init__()
        self._nodes = nodes
        self._input_ids = input_ids
        self._output_ids = output_ids
        self._input_model_data_ids = input_model_data_ids
        self._output_model_data_ids = output_model_data_ids
        self._pending_model_data: Optional[Tuple[Table, ...]] = None
        self._model_data_tables: Optional[List[Table]] = None

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        if len(inputs) != len(self._input_ids):
            raise ValueError(
                f"number of provided tables {len(inputs)} does not match the "
                f"expected number of tables {len(self._input_ids)}"
            )
        ctx = _ExecutionContext()
        ctx.set_tables(self._input_ids, inputs)
        if self._input_model_data_ids is not None:
            if self._pending_model_data is None:
                raise ValueError(
                    "This GraphModel requires model data; call set_model_data "
                    "before transform"
                )
            ctx.set_tables(self._input_model_data_ids, self._pending_model_data)
        _execute_nodes(self._nodes, ctx, fit_mode=False)
        self._capture_model_data(ctx)
        return ctx.get_tables(self._output_ids)

    def set_model_data(self, *inputs: Table) -> "GraphModel":
        if self._input_model_data_ids is None:
            raise ValueError("This GraphModel does not accept external model data")
        if len(inputs) != len(self._input_model_data_ids):
            raise ValueError(
                f"number of provided model-data tables {len(inputs)} does not "
                f"match the expected number {len(self._input_model_data_ids)}"
            )
        self._pending_model_data = tuple(inputs)
        return self

    def get_model_data(self) -> List[Table]:
        """Exactly the tables wired via ``output_model_data`` at build time.

        Parity: ``GraphModel.java`` getModelData returns the tables at
        ``outputModelDataIds``; unwired graphs raise.
        """
        if self._output_model_data_ids is None:
            raise ValueError("This GraphModel exposes no model data")
        if self._model_data_tables is None:
            raise ValueError(
                "Model data is not available before fit/transform has executed"
            )
        return list(self._model_data_tables)

    def _capture_model_data(self, ctx: _ExecutionContext) -> None:
        if self._output_model_data_ids is None:
            return
        if all(tid in ctx.tables for tid in self._output_model_data_ids):
            self._model_data_tables = [
                ctx.tables[tid] for tid in self._output_model_data_ids
            ]

    def save(self, path: str) -> None:
        meta = {
            "nodes": [n.to_map() for n in self._nodes],
            "inputIds": [t.id for t in self._input_ids],
            "outputIds": [t.id for t in self._output_ids],
            "inputModelDataIds": [t.id for t in self._input_model_data_ids]
            if self._input_model_data_ids is not None
            else None,
            "outputModelDataIds": [t.id for t in self._output_model_data_ids]
            if self._output_model_data_ids is not None
            else None,
        }
        _save_graph(self, path, self._nodes, meta)

    @classmethod
    def load(cls, path: str) -> "GraphModel":
        meta = read_write.load_metadata(path)
        g = meta["graphData"]
        nodes = _load_graph_nodes(path, g)
        opt = lambda key: (
            [TableId(i) for i in g[key]] if g.get(key) is not None else None
        )
        return cls(
            nodes,
            [TableId(i) for i in g["inputIds"]],
            [TableId(i) for i in g["outputIds"]],
            opt("inputModelDataIds"),
            opt("outputModelDataIds"),
        )


def _save_graph(composite: Stage, path: str, nodes: Sequence[GraphNode], graph_meta: Dict) -> None:
    read_write.save_metadata(composite, path, extra={"graphData": graph_meta})
    for i, node in enumerate(nodes):
        node.stage.save(read_write.stage_path(path, i))


def _load_graph_nodes(path: str, graph_meta: Dict) -> List[GraphNode]:
    nodes = [GraphNode.from_map(m) for m in graph_meta["nodes"]]
    for i, node in enumerate(nodes):
        node.stage = read_write.load_stage(read_write.stage_path(path, i))
    return nodes
