"""Imputer — replace missing values in scalar or vector columns with
fitted surrogates (mean / median / most frequent, per dimension).

Beyond the reference snapshot but a standard member of the wider Flink ML
operator family. Missing = ``missingValue`` (default NaN; NaN always
counts as missing). Surrogates are per-column host statistics: the
columns are host-resident and the statistic is one vectorized pass, so
there is no device work to ship. ``mostFrequent`` ties break by smallest
value (deterministic).

The port's counterpart of ``flinkml_tpu.models.imputer``, the same host numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import HasInputCols, HasOutputCols
from flinkml_tpu_torch.params import FloatParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table

MEAN = "mean"
MEDIAN = "median"
MOST_FREQUENT = "mostFrequent"


class _ImputerParams(HasInputCols, HasOutputCols):
    STRATEGY = StringParam(
        "strategy", "Imputation strategy.", MEAN,
        ParamValidators.in_array([MEAN, MEDIAN, MOST_FREQUENT]),
    )
    MISSING_VALUE = FloatParam(
        "missingValue",
        "The placeholder that marks a value as missing (NaN always does).",
        float("nan"),
    )


def _missing_mask(values: np.ndarray, missing_value: float) -> np.ndarray:
    mask = np.isnan(values)
    if not np.isnan(missing_value):
        mask |= values == missing_value
    return mask


def _column_surrogates(values: np.ndarray, col: str, strategy: str,
                       missing_value: float) -> list:
    """Per-dimension surrogates for a scalar ([n]) or vector ([n, d])
    column."""
    mat = values if values.ndim == 2 else values[:, None]
    out = []
    for j in range(mat.shape[1]):
        v = mat[:, j]
        present = v[~_missing_mask(v, missing_value)]
        if present.size == 0:
            raise ValueError(
                f"Column {col!r} (dim {j}) has no non-missing values "
                "to fit from"
            )
        if strategy == MEAN:
            out.append(float(present.mean()))
        elif strategy == MEDIAN:
            out.append(float(np.median(present)))
        else:  # mostFrequent; np.unique is ascending -> smallest wins ties
            uniq, counts = np.unique(present, return_counts=True)
            out.append(float(uniq[np.argmax(counts)]))
    return out


class Imputer(_ImputerParams, Estimator):
    def fit(self, *inputs: Table) -> "ImputerModel":
        (table,) = inputs
        input_cols = self.get(self.INPUT_COLS)
        if not input_cols:
            raise ValueError("inputCols must be set")
        strategy = self.get(self.STRATEGY)
        missing_value = self.get(self.MISSING_VALUE)
        surrogates = []       # flat; per-column widths recorded alongside
        widths = []
        for col in input_cols:
            values = np.asarray(table.column(col), dtype=np.float64)
            if values.ndim > 2 or (values.ndim == 2 and values.shape[1] == 0):
                raise ValueError(
                    f"Column {col!r} must be scalar or [n, d] with d >= 1, "
                    f"has shape {values.shape}"
                )
            subs = _column_surrogates(values, col, strategy, missing_value)
            widths.append(0 if values.ndim == 1 else len(subs))
            surrogates.extend(subs)
        model = ImputerModel()
        model.copy_params_from(self)
        model.set_model_data(
            Table({
                "surrogate": np.asarray(surrogates)[None, :],
                "width": np.asarray(widths)[None, :],
            })
        )
        return model


class ImputerModel(_ImputerParams, Model):
    def __init__(self):
        super().__init__()
        self._surrogates: Optional[np.ndarray] = None
        # Per input column: 0 = scalar, d = vector width (flat offsets
        # into _surrogates).
        self._widths: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table) -> "ImputerModel":
        (table,) = inputs
        self._surrogates = np.asarray(table.column("surrogate"), np.float64)[0]
        if "width" in table:
            self._widths = np.asarray(table.column("width"), np.int64)[0]
        else:   # pre-vector-support model data: all scalar columns
            self._widths = np.zeros(len(self._surrogates), np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({
            "surrogate": self._surrogates[None, :],
            "width": self._widths[None, :],
        })]

    def _require(self) -> None:
        if self._surrogates is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        input_cols = self.get(self.INPUT_COLS)
        output_cols = self.get(self.OUTPUT_COLS)
        if len(input_cols) != len(output_cols):
            raise ValueError(
                f"{len(input_cols)} input columns vs {len(output_cols)} output columns"
            )
        if len(input_cols) != len(self._widths):
            raise ValueError(
                f"model was fit on {len(self._widths)} columns, "
                f"got {len(input_cols)}"
            )
        missing_value = self.get(self.MISSING_VALUE)
        out = table
        offset = 0
        for col, out_col, width in zip(
            input_cols, output_cols, self._widths
        ):
            values = np.asarray(table.column(col), dtype=np.float64)
            if width == 0:
                if values.ndim != 1:
                    raise ValueError(
                        f"Column {col!r} was fit as scalar, got {values.shape}"
                    )
                surrogate = self._surrogates[offset]
                offset += 1
                mask = _missing_mask(values, missing_value)
                filled = np.where(mask, surrogate, values)
            else:
                if values.ndim != 2 or values.shape[1] != width:
                    raise ValueError(
                        f"Column {col!r} was fit as [n, {width}], got "
                        f"{values.shape}"
                    )
                surrogate = self._surrogates[offset: offset + width]
                offset += width
                mask = _missing_mask(values, missing_value)
                filled = np.where(mask, surrogate[None, :], values)
            out = out.with_column(out_col, filled)
        return (out,)

    def _arrays(self):
        self._require()
        return {"surrogate": self._surrogates, "width": self._widths}

    def _set_arrays(self, arrays) -> None:
        self._surrogates = np.asarray(arrays["surrogate"])
        self._widths = (
            np.asarray(arrays["width"]).astype(np.int64) if "width" in arrays
            else np.zeros(len(self._surrogates), np.int64)
        )
