"""Sorted-scatter provenance validation (FML404), before any step.

The port's counterpart of ``flinkml_tpu.analysis.sorted_scatter``. The
sorted-layout contract: sortedness is bought ONCE at pack time — a
:class:`~flinkml_tpu_torch.table.SortedSparseColumn` carries
``indices_are_sorted=True`` as recorded provenance — so every downstream
gradient scatter is entitled to ``segment_sum``'s sorted path (the
deterministic run-flush kernel, no atomics). A ``segment_sum`` called with
``indices_are_sorted=False`` over ids that CAME from a sorted source takes
the atomic path every step and throws the pack-time work away, with no
error anywhere. That is FML404.

Device-free: the check walks a capture (:mod:`._capture`), where each
``kernels.segsum.segment_sum`` call is one ``flinkml.segment_sum`` node
with its flag, propagates a **sorted** mark from the declared sorted inputs
through the ops that keep element order (:data:`ORDER_PRESERVING`), and
flags every ``segment_sum`` whose ``ids`` carry the mark while its flag is
``False``.

Inputs are live functions (:func:`check_sorted_scatter_fn`) or
``*.scatter.json`` probes (:func:`check_scatter_file`, the JAX package's
format, routed by ``python -m flinkml_tpu_torch.analysis``):

.. code-block:: json

    {"program": {"name": "segment_sum", "cells": 64, "num_segments": 16,
                 "indices_are_sorted": false},
     "sorted_guarantee": true}
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from flinkml_tpu_torch.analysis.findings import Finding

#: aten ops through which sorted provenance propagates: they keep element
#: order along the sorted axis (``select`` takes one row of a table of
#: sorted rows, JAX's ``dynamic_slice``). Gathers and permutes are absent —
#: ``ids.index_select(0, perm)`` has an arbitrary order unless ``perm`` is
#: the sorting permutation, which this static pass cannot see.
ORDER_PRESERVING = frozenset({
    "view", "reshape", "_unsafe_view", "expand", "squeeze", "unsqueeze",
    "slice", "select", "_to_copy", "clone", "detach", "alias",
})


def _walk(gm, sorted_nodes: set, location: Optional[str]) -> List[Finding]:
    from flinkml_tpu_torch.analysis._capture import arg, op_name

    findings: List[Finding] = []
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        ns, name = op_name(node)
        if (ns, name) == ("flinkml", "segment_sum"):
            ids = arg(node, 1, "ids")
            if (not arg(node, 3, "indices_are_sorted", False)
                    and ids in sorted_nodes):
                findings.append(Finding(
                    "FML404",
                    "segment_sum called with indices_are_sorted=False over "
                    "ids with pack-time sorted provenance: the pipeline "
                    "already sorted these ids (SortedSparseColumn contract) "
                    "and this scatter takes the atomic path on every step",
                    location=location,
                    fix_hint="pass indices_are_sorted=True to segment_sum "
                             "(read the column's indices_are_sorted "
                             "attribute instead of hardcoding False)",
                ))
        elif ns == "aten" and name in ORDER_PRESERVING:
            src = node.args[0] if node.args else None
            if src in sorted_nodes:
                sorted_nodes.add(node)
    return findings


def check_sorted_scatter_jaxpr(graph, sorted_argnums: Sequence[int],
                               location: Optional[str] = None
                               ) -> List[Finding]:
    """FML404 findings for a captured graph (the port's jaxpr) whose
    placeholders at ``sorted_argnums`` carry the pack-time sorted
    guarantee."""
    from flinkml_tpu_torch.analysis._capture import placeholders

    phs = placeholders(graph)
    sorted_nodes = {phs[i] for i in sorted_argnums if i < len(phs)}
    return _walk(graph, sorted_nodes, location)


def check_sorted_scatter_fn(fn, args, sorted_argnums: Sequence[int],
                            location: Optional[str] = None
                            ) -> List[Finding]:
    """Capture ``fn(*args)`` (abstract, device-free) and run the FML404
    walk with the arguments at ``sorted_argnums`` declared as
    sorted-provenance inputs (a SortedSparseColumn's ``segment_ids``, its
    ``perm``, ...)."""
    from flinkml_tpu_torch.analysis._capture import capture, leaf_indices

    gm = capture(fn, *args)
    return check_sorted_scatter_jaxpr(
        gm, leaf_indices(args, sorted_argnums), location)


def _probe_program(program: dict):
    """The probe ``program`` names: a small function, its abstract
    arguments, and which argument is the ids input.

    ``segment_sum``: the gradient scatter itself. ``gathered_segment_sum``:
    the SortedSparseColumn consumer shape — ``segment_sum(
    contrib.index_select(0, perm), segment_ids, ...)`` (the gather permutes
    VALUES, not ids; the ids input keeps its provenance)."""
    import torch

    from flinkml_tpu_torch.analysis._capture import spec
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    name = program.get("name", "segment_sum")
    cells = int(program.get("cells", 64))
    num_segments = int(program.get("num_segments", 16))
    flag = bool(program.get("indices_are_sorted", False))
    vals = spec((cells,), torch.float32)
    ids = spec((cells,), torch.int32)
    if name == "segment_sum":
        def fn(v, i):
            return segment_sum(v, i, num_segments, indices_are_sorted=flag)

        return fn, (vals, ids), 1
    if name == "gathered_segment_sum":
        def fn(v, p, i):
            return segment_sum(v.index_select(0, p), i, num_segments,
                               indices_are_sorted=flag)

        return fn, (vals, spec((cells,), torch.int32), ids), 2
    raise ValueError(f"unknown scatter probe program {name!r} "
                     "(known: segment_sum, gathered_segment_sum)")


def check_scatter_file(path: str) -> List[Finding]:
    """Validate a ``*.scatter.json`` probe (schema in the module
    docstring). Unreadable or malformed files report one FML404 finding
    naming the path — the gate must fail loudly, not skip silently."""
    try:
        with open(path, "r") as fh:
            doc = json.load(fh)
        program = doc["program"]
        sorted_guarantee = bool(doc.get("sorted_guarantee", False))
        fn, args, ids_argnum = _probe_program(program)
    except (OSError, ValueError, KeyError, TypeError) as e:
        return [Finding(
            "FML404",
            f"sorted-scatter file {path} is unreadable or malformed: "
            f"{e!r}",
            location=path,
            fix_hint="see flinkml_tpu_torch/analysis/sorted_scatter.py for "
                     "the *.scatter.json schema",
        )]
    sorted_argnums = (ids_argnum,) if sorted_guarantee else ()
    return check_sorted_scatter_fn(fn, args, sorted_argnums, location=path)
