"""Misc transformers: FeatureHasher, Interaction, DCT,
StopWordsRemover, RandomSplitter.

Members of the wider Flink ML operator family (the reference snapshot
has none of these). All host-side row transforms (see
``feature_transforms.py``). The port's counterpart of
``flinkml_tpu.models.misc_transforms``, the same host numpy.
"""

from __future__ import annotations

import zlib
from functools import lru_cache as _lru_cache
from typing import Dict, List, Tuple

import numpy as np

from flinkml_tpu_torch.api import AlgoOperator, Transformer
from flinkml_tpu_torch.common_params import (
    HasInputCol,
    HasInputCols,
    HasOutputCol,
    HasOutputCols,
    HasSeed,
)
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.models.text import _object_column, _token_column
from flinkml_tpu_torch.params import (
    BoolParam,
    FloatArrayParam,
    IntParam,
    ParamValidators,
    StringArrayParam,
)
from flinkml_tpu_torch.table import Table

# The classic English stop-word list (Snowball).
ENGLISH_STOP_WORDS = (
    "i me my myself we our ours ourselves you your yours yourself "
    "yourselves he him his himself she her hers herself it its itself "
    "they them their theirs themselves what which who whom this that "
    "these those am is are was were be been being have has had having "
    "do does did doing a an the and but if or because as until while "
    "of at by for with about against between into through during "
    "before after above below to from up down in out on off over under "
    "again further then once here there when where why how all any "
    "both each few more most other some such no nor not only own same "
    "so than too very s t can will just don should now"
).split()


class FeatureHasher(HasInputCols, HasOutputCol, Transformer):
    """Hash a mixed set of columns into one SparseVector feature space:
    numeric scalar columns contribute their value at the bucket of the
    column name; string/categorical columns contribute 1.0 at the bucket
    of ``"col=value"`` (the hashing-trick analog of one-hot). Collisions
    add (crc32, deterministic)."""

    NUM_FEATURES = IntParam(
        "numFeatures", "Hash-space dimensionality.", 1 << 18,
        ParamValidators.gt(0),
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        input_cols = self.get(self.INPUT_COLS)
        if not input_cols:
            raise ValueError("inputCols must be set")
        n_feat = self.get(self.NUM_FEATURES)
        n_rows = table.num_rows

        def bucket(key: str) -> int:
            return zlib.crc32(key.encode("utf-8")) % n_feat

        # Numeric columns hash once per column; categorical per value.
        contribs: List[Tuple[np.ndarray, np.ndarray]] = []  # (bucket[n], value[n])
        for col in input_cols:
            values = table.column(col)
            if values.ndim != 1:
                raise ValueError(
                    f"FeatureHasher needs scalar columns; {col!r} has shape "
                    f"{values.shape} (use VectorAssembler for vectors)"
                )
            if values.dtype.kind in "fiub":
                b = bucket(col)
                contribs.append((
                    np.full(n_rows, b, dtype=np.int64),
                    np.asarray(values, dtype=np.float64),
                ))
            else:
                uniq, inv = np.unique(values.astype(str), return_inverse=True)
                buckets = np.asarray(
                    [bucket(f"{col}={v}") for v in uniq], dtype=np.int64
                )
                contribs.append((buckets[inv], np.ones(n_rows)))
        all_buckets = np.stack([c[0] for c in contribs], axis=1)  # [n, cols]
        all_values = np.stack([c[1] for c in contribs], axis=1)
        rows = []
        for i in range(n_rows):
            b, v = all_buckets[i], all_values[i]
            order = np.argsort(b, kind="stable")
            b, v = b[order], v[order]
            # Merge duplicate buckets (collisions add).
            uniq_b, start = np.unique(b, return_index=True)
            sums = np.add.reduceat(v, start)
            rows.append(SparseVector._from_sorted(n_feat, uniq_b, sums))
        return (
            table.with_column(self.get(self.OUTPUT_COL), _object_column(rows)),
        )


class Interaction(HasInputCols, HasOutputCol, Transformer):
    """Row-wise interaction: the flattened outer product of the input
    columns (scalars treated as 1-vectors) — dim = Π dims."""

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        input_cols = self.get(self.INPUT_COLS)
        if not input_cols or len(input_cols) < 2:
            raise ValueError("Interaction needs at least 2 inputCols")
        mats = []
        for col in input_cols:
            v = np.asarray(table.column(col), dtype=np.float64)
            mats.append(v[:, None] if v.ndim == 1 else v)
        out = mats[0]
        for m in mats[1:]:
            out = (out[:, :, None] * m[:, None, :]).reshape(out.shape[0], -1)
        return (table.with_column(self.get(self.OUTPUT_COL), out),)


class DCT(HasInputCol, HasOutputCol, Transformer):
    """Orthonormal DCT-II per row (``inverse=True`` applies DCT-III).

    Computed as one [n, d] @ [d, d] cosine-matrix matmul in host numpy,
    the JAX package's order of operations — no scipy dependency.
    """

    INVERSE = BoolParam("inverse", "Apply the inverse DCT.", False)

    @staticmethod
    @_lru_cache(maxsize=16)
    def _basis(d: int) -> np.ndarray:
        """Orthonormal DCT-II matrix C: C[k, m] = s_k cos(π(m+½)k/d)."""
        k = np.arange(d)[:, None]
        m = np.arange(d)[None, :]
        c = np.cos(np.pi * (m + 0.5) * k / d)
        c[0] *= np.sqrt(1.0 / d)
        c[1:] *= np.sqrt(2.0 / d)
        return c

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        x = np.asarray(table.column(self.get(self.INPUT_COL)), dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"DCT input must be [n, d], got {x.shape}")
        c = self._basis(x.shape[1])
        # DCT-II: y = x Cᵀ; DCT-III (the inverse, C orthonormal): x = y C.
        out = x @ c if self.get(self.INVERSE) else x @ c.T
        return (table.with_column(self.get(self.OUTPUT_COL), out),)


class StopWordsRemover(HasInputCols, HasOutputCols, Transformer):
    """Drop stop words from token-list columns (default: the English
    Snowball list; case-insensitive unless ``caseSensitive``)."""

    STOP_WORDS = StringArrayParam(
        "stopWords", "The words to filter out.", list(ENGLISH_STOP_WORDS),
    )
    CASE_SENSITIVE = BoolParam(
        "caseSensitive", "Case-sensitive filtering.", False
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        input_cols = self.get(self.INPUT_COLS)
        output_cols = self.get(self.OUTPUT_COLS)
        if not input_cols or not output_cols:
            raise ValueError("inputCols and outputCols must be set")
        if len(input_cols) != len(output_cols):
            raise ValueError(
                f"{len(input_cols)} input columns vs {len(output_cols)} output columns"
            )
        case = self.get(self.CASE_SENSITIVE)
        stop = set(self.get(self.STOP_WORDS))
        if not case:
            stop = {w.lower() for w in stop}
        out = table
        for col, out_col in zip(input_cols, output_cols):
            tokens_col = _token_column(table, col)
            filtered = [
                [t for t in toks
                 if (t if case else str(t).lower()) not in stop]
                for toks in tokens_col
            ]
            out = out.with_column(out_col, _object_column(filtered))
        return (out,)


class RandomSplitter(HasSeed, AlgoOperator):
    """Split one table into N disjoint tables by row, with probabilities
    proportional to ``weights`` (the upstream train/test splitter)."""

    WEIGHTS = FloatArrayParam(
        "weights", "Relative sizes of the output splits.", [0.8, 0.2],
        ParamValidators.non_empty_array(),
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        weights = np.asarray(self.get(self.WEIGHTS), dtype=np.float64)
        if (weights <= 0).any():
            raise ValueError("weights must be positive")
        probs = weights / weights.sum()
        rng = np.random.default_rng(self.get_seed())
        assignment = rng.choice(len(probs), size=table.num_rows, p=probs)
        return tuple(
            table.take(np.nonzero(assignment == s)[0])
            for s in range(len(probs))
        )
