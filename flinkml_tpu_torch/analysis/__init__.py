"""Ahead-of-time static analysis for flinkml_tpu_torch pipelines.

The port's counterpart of ``flinkml_tpu.analysis``, with its export list.
The program passes walk a capture of the program
(:func:`._capture.capture`: ``make_fx`` over fake tensors, device-free,
not functionalized, with the port's kernel and collective sites as
``flinkml`` nodes) where the JAX package walks a jaxpr:

  1. **Graph validator** (:mod:`.validator`, :mod:`.ast_lint`) — schema
     flow, kernel abstract evaluation under a ``FakeTensorMode``, fusion
     topology, fingerprint stability; over live ``Pipeline`` /
     ``PipelineModel`` / ``Graph`` objects or over scripts' ASTs
     (FML101–107, FML201–203).
  2. **Collective order** (:mod:`.collectives`) — the ordered collective
     sequence of a capture compared across ranks (FML301), and recorded
     dispatch traces checked for unlocked concurrent dispatch and
     unreclaimed leases (FML302–304).
  3. **Transfer/retrace guard** (:mod:`.guard`) — runtime budget checks
     for hot loops: program builds beyond the bucket policy, ``nvcc``
     runs, and host↔device transfers beyond declared budgets (FML401–403).
  4. **Sharding-plan validation** (:mod:`.sharding_check`) — FML501–504.
  5. **Precision flow** (:mod:`.precision`) — FML601–607 over a capture,
     and the dtype-flow check behind FML106.
  6. **Sorted-scatter provenance** (:mod:`.sorted_scatter`) — FML404: a
     ``segment_sum`` called unsorted over ids with pack-time sorted
     provenance.
  7. **Memory liveness** (:mod:`.memory`) — FML701–704: a per-device
     peak-live-bytes estimate (views and in-place updates allocate
     nothing), and the serving engine's load-time estimate.
  8. **Hash sizing** (:mod:`.features_check`) — FML505 over
     ``*.features.json``.

CLI: ``python -m flinkml_tpu_torch.analysis <paths...>
[--fail-on-findings] [--device cpu]`` (see :mod:`.__main__`); rule
catalog in :data:`.findings.RULES`.
"""

from flinkml_tpu_torch.analysis.findings import (  # noqa: F401
    ERROR,
    Finding,
    Report,
    RULES,
    WARNING,
)
from flinkml_tpu_torch.analysis.validator import (  # noqa: F401
    ColumnSpec,
    StageIO,
    analyze_graph,
    analyze_pipeline,
    kernel_output_specs,
    schema_of,
    stage_io,
)
from flinkml_tpu_torch.analysis.ast_lint import lint_paths, lint_source  # noqa: F401
from flinkml_tpu_torch.analysis.collectives import (  # noqa: F401
    COLLECTIVE_PRIMITIVES,
    CollectiveOp,
    DispatchEvent,
    check_dispatch_trace,
    check_rank_order,
    extract_collectives,
    load_trace,
)
from flinkml_tpu_torch.analysis.guard import (  # noqa: F401
    GuardViolation,
    TransferRetraceGuard,
    transfer_retrace_guard,
)
from flinkml_tpu_torch.analysis.sharding_check import (  # noqa: F401
    check_cross_plan,
    check_plan,
    check_plan_file,
    check_program,
    plan_collective_signature,
)
from flinkml_tpu_torch.analysis.precision import (  # noqa: F401
    check_closed_jaxpr,
    check_policy_file,
    check_policy_plan,
    check_precision_fn,
    promotion_findings,
    validate_precision,
)
from flinkml_tpu_torch.analysis.sorted_scatter import (  # noqa: F401
    ORDER_PRESERVING,
    check_scatter_file,
    check_sorted_scatter_fn,
    check_sorted_scatter_jaxpr,
)
from flinkml_tpu_torch.analysis.memory import (  # noqa: F401
    MemoryEstimate,
    check_memory_file,
    check_memory_fn,
    check_tier_ladder,
    estimate_fn_memory,
    estimate_serving_bytes,
)
