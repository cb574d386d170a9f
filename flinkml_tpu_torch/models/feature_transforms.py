"""Stateless feature transformers: Normalizer, ElementwiseProduct,
VectorSlicer, PolynomialExpansion, Binarizer, Bucketizer.

Beyond the reference snapshot (whose only feature stages are OneHotEncoder
plus what this repo adds, SURVEY.md §2.3) but standard members of the wider
Flink ML operator family. All of these are pure row-wise functions with no
fitted state, so they are ``Transformer``s (no Estimator/Model split).

The port's counterpart of ``flinkml_tpu.models.feature_transforms``, the
same host numpy: these are O(n·d) elementwise passes over columnar
tables, executed once per table (a device-resident column is read to the
host first); shipping them to the device would spend more on the
transfer than the math. When one of them sits in front of a trainer, the
trainer's device feed ships the *result* exactly once, which is the same
number of host↔device crossings the fused alternative would pay.
"""

from __future__ import annotations

from itertools import combinations_with_replacement
from typing import Tuple

import numpy as np

from flinkml_tpu_torch.api import Transformer
from flinkml_tpu_torch.common_params import (
    HasHandleInvalid,
    HasInputCol,
    HasInputCols,
    HasOutputCol,
    HasOutputCols,
)
from flinkml_tpu_torch.params import (
    FloatArrayArrayParam,
    FloatArrayParam,
    FloatParam,
    IntArrayParam,
    IntParam,
    ParamValidators,
)
from flinkml_tpu_torch.table import Table


def _features(table: Table, col: str) -> np.ndarray:
    x = np.asarray(table.column(col), dtype=np.float64)
    if x.ndim != 2:
        raise ValueError(f"Column {col!r} must be a [rows, dim] matrix, got {x.shape}")
    return x


class Normalizer(HasInputCol, HasOutputCol, Transformer):
    """Scale each row to unit p-norm (default p=2). Zero rows stay zero."""

    P = FloatParam("p", "The p of the p-norm.", 2.0, ParamValidators.gt_eq(1.0))

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        x = _features(table, self.get(self.INPUT_COL))
        p = self.get(self.P)
        if np.isinf(p):
            norms = np.abs(x).max(axis=1)
        else:
            norms = (np.abs(x) ** p).sum(axis=1) ** (1.0 / p)
        safe = np.where(norms > 0, norms, 1.0)
        return (
            table.with_column(self.get(self.OUTPUT_COL), x / safe[:, None]),
        )


class ElementwiseProduct(HasInputCol, HasOutputCol, Transformer):
    """Hadamard product of every row with a fixed scaling vector."""

    SCALING_VEC = FloatArrayParam(
        "scalingVec", "The fixed vector to multiply each row by.", None,
        ParamValidators.non_empty_array(),
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        scaling = self.get(self.SCALING_VEC)
        if scaling is None:
            raise ValueError("scalingVec must be set")
        v = np.asarray(scaling, dtype=np.float64)
        x = _features(table, self.get(self.INPUT_COL))
        if x.shape[1] != v.shape[0]:
            raise ValueError(
                f"scalingVec has {v.shape[0]} entries, features have dim {x.shape[1]}"
            )
        return (table.with_column(self.get(self.OUTPUT_COL), x * v),)


class VectorSlicer(HasInputCol, HasOutputCol, Transformer):
    """Select a subset of feature indices from each row (order preserved,
    duplicates allowed — the upstream family's semantics)."""

    INDICES = IntArrayParam(
        "indices", "Indices of the features to keep.", None,
        ParamValidators.non_empty_array(),
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        indices = self.get(self.INDICES)
        if indices is None:
            raise ValueError("indices must be set")
        idx = np.asarray(indices, dtype=np.int64)
        x = _features(table, self.get(self.INPUT_COL))
        if (idx < 0).any() or (idx >= x.shape[1]).any():
            raise ValueError(
                f"indices must be within [0, {x.shape[1] - 1}], got {indices}"
            )
        return (table.with_column(self.get(self.OUTPUT_COL), x[:, idx]),)


class PolynomialExpansion(HasInputCol, HasOutputCol, Transformer):
    """Expand features into all monomials of degree 1..degree.

    Output order: combinations-with-replacement of feature indices in
    lexicographic order, grouped by ascending degree — e.g. dim 2,
    degree 2 → ``[x0, x1, x0², x0·x1, x1²]``. Output size is
    C(dim + degree, degree) − 1 (no constant term), matching the upstream
    family's expansion set (ordering documented here rather than
    bit-matching Spark's recursion).
    """

    DEGREE = IntParam(
        "degree", "The polynomial degree to expand to.", 2,
        ParamValidators.gt_eq(1),
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        x = _features(table, self.get(self.INPUT_COL))
        degree = self.get(self.DEGREE)
        cols = []
        for deg in range(1, degree + 1):
            for combo in combinations_with_replacement(range(x.shape[1]), deg):
                cols.append(np.prod(x[:, combo], axis=1))
        return (
            table.with_column(
                self.get(self.OUTPUT_COL), np.stack(cols, axis=1)
            ),
        )


class Binarizer(HasInputCols, HasOutputCols, Transformer):
    """Threshold columns to {0, 1}: value > threshold → 1.0.

    Works on scalar columns and on [rows, dim] vector columns alike
    (one threshold per input column).
    """

    THRESHOLDS = FloatArrayParam(
        "thresholds", "Per-column binarization thresholds.", None,
        ParamValidators.non_empty_array(),
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        input_cols = self.get(self.INPUT_COLS)
        output_cols = self.get(self.OUTPUT_COLS)
        thresholds = self.get(self.THRESHOLDS)
        if not input_cols or thresholds is None:
            raise ValueError("inputCols and thresholds must be set")
        if not (len(input_cols) == len(output_cols) == len(thresholds)):
            raise ValueError(
                "inputCols, outputCols, and thresholds must have equal length"
            )
        out = table
        for col, out_col, thr in zip(input_cols, output_cols, thresholds):
            values = np.asarray(table.column(col), dtype=np.float64)
            out = out.with_column(out_col, (values > thr).astype(np.float64))
        return (out,)


class Bucketizer(HasInputCols, HasOutputCols, HasHandleInvalid, Transformer):
    """Map continuous scalar columns to bucket indices via split points.

    ``splitsArray[i]`` is the strictly-increasing split vector for input
    column i (±inf sentinels allowed): bucket b covers
    ``[splits[b], splits[b+1])``, with the last bucket right-inclusive.
    ``handleInvalid``: "error" raises on NaN/out-of-range, "skip" drops
    the whole row, "keep" maps invalids to the extra bucket
    ``numBuckets``.
    """

    SPLITS_ARRAY = FloatArrayArrayParam(
        "splitsArray", "Per-column arrays of split points.", None,
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        input_cols = self.get(self.INPUT_COLS)
        output_cols = self.get(self.OUTPUT_COLS)
        splits_array = self.get(self.SPLITS_ARRAY)
        handle_invalid = self.get(self.HANDLE_INVALID)
        if not input_cols or splits_array is None:
            raise ValueError("inputCols and splitsArray must be set")
        if not (len(input_cols) == len(output_cols) == len(splits_array)):
            raise ValueError(
                "inputCols, outputCols, and splitsArray must have equal length"
            )
        out = table
        keep_mask = np.ones(table.num_rows, dtype=bool)
        for col, out_col, splits in zip(input_cols, output_cols, splits_array):
            s = np.asarray(splits, dtype=np.float64)
            if len(s) < 2 or not np.all(np.diff(s) > 0):
                raise ValueError(
                    f"splits for column {col!r} must be >= 2 strictly "
                    f"increasing values, got {splits}"
                )
            values = np.asarray(table.column(col), dtype=np.float64)
            n_buckets = len(s) - 1
            # searchsorted('right') puts v == splits[b] into bucket b;
            # clamp the top edge so the last bucket is right-inclusive.
            bucket = np.searchsorted(s, values, side="right") - 1
            bucket = np.where(values == s[-1], n_buckets - 1, bucket)
            invalid = (
                np.isnan(values) | (values < s[0]) | (values > s[-1])
            )
            if handle_invalid == HasHandleInvalid.ERROR_INVALID:
                if invalid.any():
                    raise ValueError(
                        f"Column {col!r} has values outside "
                        f"[{s[0]}, {s[-1]}]: {values[invalid][:5]}"
                    )
            elif handle_invalid == HasHandleInvalid.SKIP_INVALID:
                keep_mask &= ~invalid
            else:  # keep → catch-all bucket
                bucket = np.where(invalid, n_buckets, bucket)
            out = out.with_column(out_col, bucket.astype(np.float64))
        if not keep_mask.all():
            out = out.take(np.nonzero(keep_mask)[0])
        return (out,)
