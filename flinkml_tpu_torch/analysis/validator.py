"""Ahead-of-time pipeline and graph validation (FML101–FML107,
FML201–FML203).

The port's counterpart of ``flinkml_tpu.analysis.validator``. Validates
:class:`~flinkml_tpu_torch.pipeline.Pipeline` /
:class:`~flinkml_tpu_torch.pipeline.PipelineModel` stage chains and
:class:`~flinkml_tpu_torch.graph.Graph` DAGs before any transform:

  - schema flow: every column a stage reads must exist in its input
    schema (FML101), reads of columns only a later stage produces are
    ordering errors (FML107), and outputs that overwrite existing
    columns are flagged (FML102);
  - kernel abstract evaluation: each kernel-capable stage's
    ``transform_kernel().fn`` runs over fake tensors of its input
    :class:`ColumnSpec` s under a ``FakeTensorMode`` (no buffer, no
    device: a fake CPU tensor takes every kernel wrapper's plain path,
    never a CUDA one) — shape/dtype mismatches between stages surface as
    FML103, and the output specs feed the next stage's check;
  - fusion topology: a non-kernel stage sandwiched between kernel-capable
    neighbours splits one fused chain into two (FML104);
  - kernel contract: ``transform_kernel`` must return a stable, hashable
    fingerprint across calls (FML105 — an unstable fingerprint defeats
    the fused program cache);
  - dtype hygiene: an output column wider than every input it was
    computed from is a silent float64 promotion (FML106), in one stage or
    in the fused run (the run's plain chain, ``kernels.chain.chain_plain``,
    the reference the ``fused_chain`` kernel is held against, evaluated
    the same way).

The port's stages compute in their columns' floating dtype (a float32
column stays float32 through a scaler; constants are cast to it), and the
evaluation follows that rule: there is no process-wide x64 flag as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flinkml_tpu_torch.analysis.findings import Finding, Report

#: Abstract-eval row count. Any value works (kernels are row-local); 8
#: matches the executor's MIN_ROW_BUCKET.
EVAL_ROWS = 8


def _is_object(dtype) -> bool:
    return isinstance(dtype, np.dtype) and dtype.kind == "O"


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """Abstract column type: dtype (a numpy dtype, or a torch dtype for
    the widths numpy lacks: bfloat16) + trailing (per-row) shape.

    ``dtype None`` means unknown — produced by stages the validator cannot
    abstract-evaluate; checks that need the spec are skipped rather than
    guessed.
    """

    dtype: Optional[object] = None
    tail: Optional[Tuple[int, ...]] = None

    @property
    def known(self) -> bool:
        # Object (ragged/row-wise Vector) columns have a dtype but no
        # abstract-evaluable type: the fused executor skips them, so the
        # validator must not evaluate them either.
        return (self.dtype is not None and self.tail is not None
                and not _is_object(self.dtype))


UNKNOWN = ColumnSpec()

#: TableSchema: column name -> ColumnSpec.
TableSchema = Dict[str, ColumnSpec]


def _spec_dtype(dtype):
    """A column's dtype as a ColumnSpec keeps it: numpy where numpy has
    the width, else the torch dtype."""
    import torch

    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
        if name == "bfloat16":
            return dtype
        return np.dtype(name)
    return np.dtype(dtype)


def _torch_dtype(dtype):
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def schema_of(table) -> TableSchema:
    """The :class:`ColumnSpec` schema of a live Table (device columns
    included — no column is read)."""
    out: TableSchema = {}
    for name in table.column_names:
        col = table._raw_column(name)
        out[name] = ColumnSpec(_spec_dtype(col.dtype), tuple(col.shape[1:]))
    return out


# ---------------------------------------------------------------------------
# Stage I/O introspection (param-based; works on any WithParams stage)
# ---------------------------------------------------------------------------

_INPUT_COL_PARAMS = {"inputCol", "featuresCol", "labelCol", "weightCol"}
_INPUT_COLS_PARAMS = {"inputCols"}
_OUTPUT_COL_PARAMS = {"outputCol", "predictionCol", "rawPredictionCol"}
_OUTPUT_COLS_PARAMS = {"outputCols"}


@dataclasses.dataclass(frozen=True)
class StageIO:
    """Columns a stage reads/writes, derived from its Has*Col params.

    ``opaque``: the stage declares no recognized column params — its
    reads/writes are unknowable, so schema tracking goes open after it.
    ``resets``: the stage replaces the table wholesale (evaluators emit a
    metrics table) — downstream schema is unknown.
    """

    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    opaque: bool = False
    resets: bool = False


def stage_io(stage) -> StageIO:
    """Derive :class:`StageIO` from a stage's params.

    Evaluator-family stages (class name contains ``Evaluator``) consume
    their prediction/rawPrediction columns rather than producing them, and
    replace the table with a metrics table.
    """
    is_eval = "Evaluator" in type(stage).__name__
    inputs: List[str] = []
    outputs: List[str] = []
    recognized = False
    try:
        params = type(stage).params()
    except Exception:
        return StageIO((), (), opaque=True)
    for p in params:
        name = getattr(p, "name", None)
        try:
            v = stage.get(p)
        except Exception:
            continue
        if v is None:
            continue
        if name in _INPUT_COL_PARAMS:
            inputs.append(v)
            recognized = True
        elif name in _INPUT_COLS_PARAMS:
            inputs.extend(v)
            recognized = True
        elif name in _OUTPUT_COL_PARAMS or name in _OUTPUT_COLS_PARAMS:
            vals = list(v) if name in _OUTPUT_COLS_PARAMS else [v]
            (inputs if is_eval else outputs).extend(vals)
            recognized = True
    return StageIO(
        tuple(dict.fromkeys(inputs)),
        tuple(dict.fromkeys(outputs)),
        opaque=not recognized,
        resets=is_eval,
    )


# ---------------------------------------------------------------------------
# Kernel abstract evaluation
# ---------------------------------------------------------------------------

def _fake_inputs(kernel, schema: TableSchema, rows: int):
    """Fake column tensors and the float32 validity mask of one kernel
    (made inside the caller's ``FakeTensorMode``)."""
    import torch

    cols = {
        c: torch.empty((rows,) + tuple(schema[c].tail),
                       dtype=_torch_dtype(schema[c].dtype))
        for c in kernel.input_cols
    }
    return cols, torch.empty((rows,), dtype=torch.float32)


def _specs_of(out) -> TableSchema:
    return {name: ColumnSpec(_spec_dtype(v.dtype), tuple(v.shape[1:]))
            for name, v in out.items()}


def kernel_output_specs(kernel, schema: TableSchema,
                        rows: int = EVAL_ROWS) -> TableSchema:
    """Abstract-evaluate a :class:`ColumnKernel` over ``schema``: its
    ``fn`` over fake tensors under a ``FakeTensorMode`` (no buffer, no
    device; the model constants stay host arrays, as the executor passes
    them). Raises whatever the kernel's math raises on incompatible
    shapes/dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        cols, valid = _fake_inputs(kernel, schema, rows)
        out = kernel.fn(cols, dict(kernel.constants), valid)
    return _specs_of(out)


def _stable_kernel(stage):
    """Fetch a stage's kernel twice; returns ``(kernel, finding_or_None)``
    covering the FML105 contract (equal, hashable fingerprints)."""
    label = type(stage).__name__
    try:
        k1 = stage.transform_kernel()
        k2 = stage.transform_kernel()
    except Exception as e:  # a raising gate is itself a contract breach
        return None, Finding(
            "FML105", f"transform_kernel raised: {e!r}", stage=label,
            fix_hint="gate unfusable configurations by returning None, "
                     "not by raising",
        )
    if k1 is None:
        return None, None
    try:
        hash(k1.fingerprint)
    except TypeError:
        return k1, Finding(
            "FML105",
            f"kernel fingerprint {k1.fingerprint!r} is unhashable",
            stage=label,
            fix_hint="fingerprints must be hashable tuples of static "
                     "config (they key the fused program cache)",
        )
    if k2 is not None and k1.fingerprint != k2.fingerprint:
        return k1, Finding(
            "FML105",
            "fingerprint differs between two transform_kernel() calls "
            f"({k1.fingerprint!r} != {k2.fingerprint!r})",
            stage=label,
            fix_hint="derive the fingerprint from stage config only — an "
                     "unstable fingerprint rebuilds the fused program on "
                     "every transform",
        )
    return k1, None


def _kernel_graph(kernel, schema: TableSchema, rows: int = EVAL_ROWS):
    """The capture of one kernel's ``fn`` (what lets the shared FML106
    path localize the widening op). None when the capture fails (the
    FML103 check already reported that)."""
    from flinkml_tpu_torch.analysis._capture import capture, spec

    try:
        cols = {c: spec((rows,) + tuple(schema[c].tail),
                        _torch_dtype(schema[c].dtype))
                for c in kernel.input_cols}
        consts = dict(kernel.constants)
        return capture(lambda c, v: kernel.fn(c, consts, v), cols,
                       spec((rows,)))
    except Exception:
        return None


def _promotion_findings(stage_label, in_specs, out_specs,
                        closed=None) -> List[Finding]:
    """FML106 — delegates to the ONE dtype-flow code path
    (:func:`flinkml_tpu_torch.analysis.precision.promotion_findings`),
    which also serves the fused multi-stage check in
    :func:`analyze_pipeline`. ``closed`` (the kernel's capture, or a lazy
    zero-arg thunk producing it, optional) localizes the widening op in
    the message."""
    from flinkml_tpu_torch.analysis.precision import promotion_findings

    return promotion_findings(
        closed,
        [s.dtype if s.known else None for s in in_specs],
        {name: (s.dtype if s.known else None)
         for name, s in out_specs.items()},
        stage=stage_label,
    )


# ---------------------------------------------------------------------------
# Pipeline chain validation
# ---------------------------------------------------------------------------

def analyze_pipeline(pipeline, schema: Optional[TableSchema] = None,
                     location: Optional[str] = None) -> Report:
    """Validate a Pipeline / PipelineModel / stage sequence against an
    input :data:`TableSchema` (``schema_of(table)``), or against an *open*
    schema (``None`` — any column may pre-exist; only ordering and
    collision checks apply)."""
    from flinkml_tpu_torch.api import AlgoOperator

    stages = list(getattr(pipeline, "stages", pipeline))
    report = Report()
    closed = schema is not None
    current: TableSchema = dict(schema) if schema else {}
    external: set = set(current)
    produced_at: Dict[str, int] = {}
    pending_reads: List[Tuple[int, str, str]] = []  # (stage idx, label, col)
    kernel_capable: List[bool] = []
    kernels: List = []                 # per-stage kernel (None = unfusable)
    schema_before: List[TableSchema] = []  # schema snapshot at each stage

    for i, stage in enumerate(stages):
        label = f"[{i}] {type(stage).__name__}"
        kernel = None
        if isinstance(stage, AlgoOperator):
            kernel, f = _stable_kernel(stage)
            if f is not None:
                report.add(dataclasses.replace(f, stage=label,
                                               location=location))
        kernel_capable.append(kernel is not None)
        kernels.append(kernel)
        schema_before.append(dict(current))

        io = None
        if kernel is not None:
            reads, writes = kernel.input_cols, kernel.output_cols
        else:
            io = stage_io(stage)
            reads, writes = io.inputs, io.outputs

        # -- reads ---------------------------------------------------------
        for c in reads:
            if c in current:
                continue
            if closed:
                report.add(Finding(
                    "FML101",
                    f"reads column {c!r} which is not in the schema "
                    f"(available: {sorted(current)})",
                    stage=label, column=c, location=location,
                    fix_hint="rename the column param or add an upstream "
                             "stage producing it",
                ))
            else:
                # Open schema: assume external unless a later stage turns
                # out to be the producer (FML107, resolved after the walk).
                pending_reads.append((i, label, c))
                external.add(c)
                current[c] = UNKNOWN

        # -- writes / collisions -------------------------------------------
        for c in writes:
            if c in current:
                if c in reads:
                    msg = f"overwrites its own input column {c!r} in place"
                    hint = ("in-place overwrite loses the pre-stage values "
                            "for every later stage; use a distinct output "
                            "column name")
                elif c in external:
                    msg = (f"output column {c!r} silently overwrites a "
                           "source-data column")
                    hint = "pick an output column name absent from the input"
                else:
                    prev = produced_at.get(c)
                    msg = (f"output column {c!r} collides with the output "
                           f"of stage {prev}" if prev is not None else
                           f"output column {c!r} overwrites an existing column")
                    hint = "give each stage a distinct output column name"
                report.add(Finding("FML102", msg, stage=label, column=c,
                                   location=location, fix_hint=hint))
            produced_at[c] = i

        # -- abstract evaluation / schema update ---------------------------
        in_specs = [current.get(c, UNKNOWN) for c in reads]
        if kernel is not None and all(s.known for s in in_specs):
            try:
                out_specs = kernel_output_specs(kernel, current)
            except Exception as e:
                report.add(Finding(
                    "FML103",
                    f"kernel abstract evaluation failed: {e}",
                    stage=label, location=location,
                    fix_hint="the stage's kernel cannot consume the "
                             "upstream schema — fix the column shapes/"
                             "dtypes or the stage wiring",
                ))
                out_specs = {c: UNKNOWN for c in writes}
            else:
                # The capture thunk is LAZY: promotion_findings only
                # captures when a finding is certain, so clean stages (the
                # common case) pay no localization capture.
                for f in _promotion_findings(
                    label, in_specs, out_specs,
                    closed=lambda k=kernel, s=dict(current):
                        _kernel_graph(k, s),
                ):
                    report.add(dataclasses.replace(f, location=location))
            current.update(out_specs)
        else:
            if kernel is None:
                # A kernel-capable stage's writes are exact (from the
                # kernel) even when specs are unknown; only kernel-less
                # stages can reset or open the schema.
                if io.resets:
                    # Evaluator: the output table is a fresh metrics table.
                    current = {}
                    external = set()
                    closed = False
                elif io.opaque:
                    # Unknown stage: it may add/drop anything.
                    closed = False
            for c in writes:
                current[c] = UNKNOWN

    # FML107: open-schema reads whose producer turned out to be later.
    for idx, label, c in pending_reads:
        j = produced_at.get(c)
        if j is not None and j > idx:
            report.add(Finding(
                "FML107",
                f"reads column {c!r} which only stage {j} produces "
                "(stage ordering error)",
                stage=label, column=c, location=location,
                fix_hint="reorder the stages so producers precede consumers",
            ))

    # FML104: a non-kernel stage strictly between kernel-capable stages.
    stages_list = list(stages)
    for i in range(1, len(kernel_capable) - 1):
        if (not kernel_capable[i]) and kernel_capable[i - 1] \
                and kernel_capable[i + 1]:
            report.add(Finding(
                "FML104",
                "non-fusable stage splits a kernel chain into two fused "
                "programs (extra dispatch + device round-trip)",
                stage=f"[{i}] {type(stages_list[i]).__name__}",
                location=location,
                fix_hint="implement transform_kernel for this stage or "
                         "move it to the edge of the chain",
            ))

    # FML106 over the FUSED program: each maximal kernel run (>= 2
    # stages — what the executor runs as one chain) through the shared
    # dtype-flow path in analysis.precision; per-stage findings above came
    # through the SAME code path, so (column-keyed) dedupe keeps one
    # report.
    flagged = {f.column for f in report if f.rule == "FML106"}
    for start, end in _kernel_runs(kernel_capable):
        for f in _fused_promotion_findings(
            kernels[start:end], schema_before[start],
            f"fused[{start}..{end - 1}]",
        ):
            if f.column not in flagged:
                flagged.add(f.column)
                report.add(dataclasses.replace(f, location=location))
    return report


def _kernel_runs(kernel_capable: Sequence[bool]):
    """Maximal runs of >= 2 consecutive kernel-capable stages — the
    executor's fusion unit (``pipeline.py`` fuses exactly these)."""
    runs = []
    i = 0
    while i < len(kernel_capable):
        if not kernel_capable[i]:
            i += 1
            continue
        j = i
        while j < len(kernel_capable) and kernel_capable[j]:
            j += 1
        if j - i >= 2:
            runs.append((i, j))
        i = j
    return runs


def _fused_promotion_findings(run_kernels, schema: TableSchema,
                              label: str) -> List[Finding]:
    """Evaluate the run's plain chain (``kernels.chain.chain_plain``, what
    the executor runs on the CPU and holds the CUDA kernel against) over
    fake tensors and run the shared FML106 check over the whole
    multi-stage program."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from flinkml_tpu_torch import pipeline_fusion
    from flinkml_tpu_torch.analysis._capture import capture, spec
    from flinkml_tpu_torch.analysis.precision import promotion_findings
    from flinkml_tpu_torch.kernels.chain import chain_plain

    ext = pipeline_fusion.external_inputs(run_kernels)
    ext_specs = [schema.get(c, UNKNOWN) for c in ext]
    if not all(s.known for s in ext_specs):
        return []
    out_names = []
    for k in run_kernels:
        out_names.extend(c for c in k.output_cols if c not in out_names)
    consts = tuple(dict(k.constants) for k in run_kernels)
    shapes = [((EVAL_ROWS,) + tuple(s.tail), _torch_dtype(s.dtype))
              for s in ext_specs]

    def chain(*vals):
        return chain_plain(run_kernels, ext, out_names, list(vals), consts,
                           EVAL_ROWS)

    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            vals = [torch.empty(shape, dtype=dt) for shape, dt in shapes]
            abstract = chain(*vals)
        out_dtypes = {name: v.dtype for name, v in abstract.items()}
    except Exception:
        # An unevaluable chain already surfaced as FML103 per stage.
        return []

    def closed():
        # Lazy: only captured once a finding is certain. A capture
        # failure degrades to an unlocalized message.
        try:
            return capture(chain, *(spec(s, dt) for s, dt in shapes))
        except Exception:
            return None

    return promotion_findings(
        closed, [s.dtype for s in ext_specs], out_dtypes, stage=label,
    )


# ---------------------------------------------------------------------------
# Graph wiring validation
# ---------------------------------------------------------------------------

def analyze_graph(graph, location: Optional[str] = None) -> Report:
    """Static executability of a Graph / GraphModel DAG: every node's
    inputs must be producible (FML201), graph outputs must be produced
    (FML202), and no two nodes may claim one output id (FML203) — the
    checks ``_execute_nodes`` performs at runtime, moved to build time."""
    report = Report()
    nodes = list(graph._nodes)

    if hasattr(graph, "_estimator_input_ids"):  # Graph (estimator)
        given = set(t.id for t in graph._estimator_input_ids)
        given |= set(t.id for t in graph._model_input_ids)
    else:  # GraphModel
        given = set(t.id for t in graph._input_ids)
    if getattr(graph, "_input_model_data_ids", None):
        given |= set(t.id for t in graph._input_model_data_ids)

    claimed: Dict[int, int] = {}
    for node in nodes:
        out_ids = [t.id for t in node.output_ids]
        if node.output_model_data_ids:
            out_ids += [t.id for t in node.output_model_data_ids]
        for tid in out_ids:
            if tid in claimed and claimed[tid] != node.node_id:
                report.add(Finding(
                    "FML203",
                    f"TableId({tid}) is claimed by nodes "
                    f"{claimed[tid]} and {node.node_id}",
                    stage=f"node {node.node_id}", location=location,
                    fix_hint="every output TableId must have exactly one "
                             "producing node",
                ))
            claimed.setdefault(tid, node.node_id)

    # Fixed-point readiness — the static analog of runtime execution.
    available = set(given)
    pending = list(nodes)
    progress = True
    while progress:
        progress = False
        for node in list(pending):
            if all(t.id in available for t in node.all_input_ids()):
                pending.remove(node)
                available.update(t.id for t in node.output_ids)
                if node.output_model_data_ids:
                    available.update(
                        t.id for t in node.output_model_data_ids
                    )
                progress = True
    for node in pending:
        missing = [t.id for t in node.all_input_ids()
                   if t.id not in available]
        report.add(Finding(
            "FML201",
            f"node {node.node_id} "
            f"({type(node.stage).__name__ if node.stage else '?'}) waits "
            f"on TableId(s) {missing} which no node produces "
            "(cycle or missing input table)",
            stage=f"node {node.node_id}", location=location,
            fix_hint="wire the missing TableIds to a producing stage or "
                     "to the graph inputs",
        ))

    out_ids = getattr(graph, "_output_ids", [])
    for t in out_ids:
        if t.id not in available:
            report.add(Finding(
                "FML202",
                f"graph output TableId({t.id}) is never produced",
                location=location,
                fix_hint="graph outputs must be outputs of some node (or "
                         "graph inputs)",
            ))
    return report
