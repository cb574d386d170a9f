"""PrefixSpan — frequent sequential pattern mining (the Spark family
member; an AlgoOperator, no fitted model — mirrors the upstream API).

Pei et al.'s prefix-projected mining: recursively extend each frequent
prefix with the items that remain frequent in its projected database
(the suffixes after the prefix's first occurrence). Host combinatorial
work like FPGrowth — pointer-chasing over projections has no dense
numeric structure for an accelerator.

Patterns here are sequences of single items (each element one item —
the common case; Spark's itemset-elements generalization is not
modeled). ``minSupport`` is a fraction of sequences;
``maxPatternLength`` bounds the recursion.

The port's counterpart of ``flinkml_tpu.models.prefixspan``, the same host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from flinkml_tpu_torch.api import AlgoOperator
from flinkml_tpu_torch.models.text import _object_column, _token_column
from flinkml_tpu_torch.params import FloatParam, IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table


def prefixspan(sequences: List[List[str]], min_support: float,
               max_length: int):
    """Frequent sequential patterns: dict {tuple(items): count}."""
    n = len(sequences)
    min_count = max(1, int(np.ceil(min_support * n)))
    seqs = [[str(it) for it in s] for s in sequences]

    out: Dict[Tuple[str, ...], int] = {}
    # Explicit DFS stack (no Python recursion: maxPatternLength can
    # legitimately exceed the interpreter's recursion limit).
    stack: List[Tuple[Tuple[str, ...], List[Tuple[int, int]]]] = [
        ((), [(i, 0) for i in range(n)])
    ]
    while stack:
        prefix, projections = stack.pop()
        if len(prefix) >= max_length:
            continue
        # Count each candidate item once per sequence (first occurrence
        # position recorded for the next projection).
        first_pos: Dict[str, Dict[int, int]] = {}
        for si, start in projections:
            seen = set()
            seq = seqs[si]
            for pos in range(start, len(seq)):
                it = seq[pos]
                if it not in seen:
                    seen.add(it)
                    first_pos.setdefault(it, {})[si] = pos
        for it, positions in first_pos.items():
            if len(positions) < min_count:
                continue
            pattern = prefix + (it,)
            out[pattern] = len(positions)
            stack.append(
                (pattern, [(si, pos + 1) for si, pos in positions.items()])
            )
    return out


class PrefixSpan(AlgoOperator):
    SEQUENCE_COL = StringParam(
        "sequenceCol", "Sequence (token-list) column.", "sequence"
    )
    MIN_SUPPORT = FloatParam(
        "minSupport", "Minimum fraction of sequences containing a pattern.",
        0.1, ParamValidators.in_range(0.0, 1.0, lower_inclusive=False),
    )
    MAX_PATTERN_LENGTH = IntParam(
        "maxPatternLength", "Longest pattern mined.", 10,
        ParamValidators.gt(0),
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        """Output: one row per frequent pattern — (sequence, freq),
        support-descending (the upstream ``findFrequentSequentialPatterns``
        layout)."""
        (table,) = inputs
        seqs = _token_column(table, self.get(self.SEQUENCE_COL))
        patterns = prefixspan(
            [list(s) for s in seqs],
            self.get(self.MIN_SUPPORT),
            self.get(self.MAX_PATTERN_LENGTH),
        )
        ordered = sorted(patterns.items(), key=lambda kv: (-kv[1], kv[0]))
        return (
            Table({
                "sequence": _object_column([list(k) for k, _ in ordered]),
                "freq": np.asarray([v for _, v in ordered], np.int64),
            }) if ordered else Table({
                "sequence": np.empty(0, dtype=object),
                "freq": np.zeros(0, np.int64),
            }),
        )
