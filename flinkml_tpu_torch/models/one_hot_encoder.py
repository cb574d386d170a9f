"""OneHotEncoder — integer category columns → one-hot vectors.

The port's counterpart of ``flinkml_tpu.models.one_hot_encoder``
(reference: ``OneHotEncoder.java:51-147``, ``OneHotEncoderModel.java:56-190``):

- ``fit`` finds the max category index per input column; the model data is
  (columnIndex, maxIndex) pairs.
- A value v encodes as 1.0 at slot v of ``maxIndex + (0 if dropLast else
  1)`` slots; with ``dropLast`` the last category (``v == maxIndex``)
  encodes as the all-zero vector.
- ``handleInvalid``: ``error`` rejects values outside ``[0, maxIndex]`` and
  non-integral ones, ``keep`` sends them to one more catch-all slot after
  the others, ``skip`` is refused, as in the JAX package.
- ``outputFormat``: ``dense`` (``[n, size]`` float64 matrices) or
  ``sparse`` (one ``SparseVector`` per row, the reference's encoding).

``transform`` runs on the host in numpy, as the JAX package's does.
``transform_kernel`` (dense output with ``keep`` only) is the same
encoding as plain PyTorch, and the one-hot prologue of the ``fused_chain``
kernel on the card. Its index rule is the host path's after the host's
checks: a float index truncates toward zero, and an index outside
``[0, maxIndex]`` goes to the catch-all slot, NaN and ±inf included (the
host path raises on NaN, a non-integral value; the JAX package's fused
``astype(int32)`` sends NaN to slot 0 and wraps int64 values beyond the
int32 range, which the port compares whole).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flinkml_tpu_torch.api import ColumnKernel, Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasHandleInvalid,
    HasInputCols,
    HasOutputCols,
)
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.params import BoolParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table

# Shared, frozen 1.0 buffer for the sparse rows.
_ONE = np.ones(1)
_ONE.setflags(write=False)


class _OneHotEncoderParams(HasInputCols, HasOutputCols, HasHandleInvalid):
    DROP_LAST = BoolParam("dropLast", "Whether to drop the last category.", True)
    OUTPUT_FORMAT = StringParam(
        "outputFormat",
        "Encoding layout: 'dense' ([n, size] matrices) or 'sparse' "
        "(per-row SparseVector, the reference's encoding — required at "
        "high cardinality).",
        "dense",
        ParamValidators.in_array(["dense", "sparse"]),
    )


class OneHotEncoder(_OneHotEncoderParams, Estimator):
    """Finds each input column's largest category index."""

    def fit(self, *inputs: Table) -> "OneHotEncoderModel":
        (table,) = inputs
        input_cols = self.get(_OneHotEncoderParams.INPUT_COLS)
        if not input_cols:
            raise ValueError("inputCols must be set")
        max_indices = []
        for col in input_cols:
            values = np.asarray(table.column(col), dtype=np.float64)
            _check_indexed(values, col)
            if (values < 0).any():
                raise ValueError(f"Column {col!r} contains negative category values")
            max_indices.append(int(values.max()))
        model = OneHotEncoderModel()
        model.copy_params_from(self)
        model.set_model_data(Table({
            "columnIndex": np.arange(len(input_cols)),
            "maxIndex": np.asarray(max_indices),
        }))
        return model


class OneHotEncoderModel(_OneHotEncoderParams, Model):
    """Encodes each input column with its fitted ``maxIndex``."""

    def __init__(self):
        super().__init__()
        self._max_indices: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table) -> "OneHotEncoderModel":
        (table,) = inputs
        self._set_arrays({c: table.column(c)
                          for c in ("columnIndex", "maxIndex")})
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({
            "columnIndex": np.arange(len(self._max_indices)),
            "maxIndex": self._max_indices.copy(),
        })]

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require_model()
        return {"maxIndex": self._max_indices}

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        max_indices = np.asarray(arrays["maxIndex"]).reshape(-1)
        if "columnIndex" in arrays:
            order = np.argsort(np.asarray(arrays["columnIndex"]).reshape(-1))
            max_indices = max_indices[order]
        self._max_indices = max_indices.astype(int)

    def _require_model(self) -> None:
        if self._max_indices is None:
            raise ValueError("Model data is not set; call set_model_data or fit first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        input_cols = self.get(_OneHotEncoderParams.INPUT_COLS)
        output_cols = self.get(_OneHotEncoderParams.OUTPUT_COLS)
        handle_invalid = self.get(_OneHotEncoderParams.HANDLE_INVALID)
        if handle_invalid == HasHandleInvalid.SKIP_INVALID:
            raise ValueError(
                "handleInvalid='skip' is not supported (parity with the "
                "reference, which supports 'error' only)"
            )
        if len(input_cols) != len(output_cols):
            raise ValueError(
                f"{len(input_cols)} input columns vs {len(output_cols)} output columns"
            )
        if len(input_cols) != len(self._max_indices):
            raise ValueError(
                f"model was fit on {len(self._max_indices)} columns, got {len(input_cols)}"
            )
        drop_last = self.get(_OneHotEncoderParams.DROP_LAST)
        sparse_format = self.get(_OneHotEncoderParams.OUTPUT_FORMAT) == "sparse"
        keep = handle_invalid == HasHandleInvalid.KEEP_INVALID
        out = table
        for col, out_col, max_idx in zip(input_cols, output_cols,
                                         self._max_indices):
            values = np.asarray(table.column(col), dtype=np.float64)
            _check_indexed(values, col)
            with np.errstate(invalid="ignore"):   # ±inf: an invalid index
                idx = values.astype(int)
            # Valid categories are [0, maxIndex] whatever dropLast; with
            # dropLast the last one encodes as the all-zero vector.
            max_valid = int(max_idx)
            base_size = max_valid + (0 if drop_last else 1)
            invalid = (idx < 0) | (idx > max_valid)
            if keep:
                # The catch-all slot comes after the base_size slots.
                size = base_size + 1
                hot = np.where(invalid, base_size, idx)
                zero_row = ~invalid & drop_last & (idx == max_valid)
            else:
                if invalid.any():
                    raise ValueError(
                        f"Column {col!r} contains categories outside "
                        f"[0, {max_valid}]: {idx[invalid][:5]}"
                    )
                size = base_size
                hot = idx
                zero_row = drop_last & (idx == max_valid)
            if sparse_format:
                empty_i = np.zeros(0, dtype=np.int64)
                empty_v = np.zeros(0)
                hot64 = hot.astype(np.int64)
                hot64.setflags(write=False)
                onehot = np.empty(len(idx), dtype=object)
                for i in range(len(idx)):
                    onehot[i] = (
                        SparseVector._from_sorted(size, empty_i, empty_v)
                        if zero_row[i]
                        else SparseVector._from_sorted(size, hot64[i:i + 1], _ONE)
                    )
            else:
                onehot = np.zeros((len(idx), size), dtype=np.float64)
                rows = np.nonzero(~zero_row)[0]
                onehot[rows, hot[rows]] = 1.0
            out = out.with_column(out_col, onehot)
        return (out,)

    def transform_kernel(self) -> Optional[ColumnKernel]:
        """Fusable only for ``outputFormat='dense'`` with
        ``handleInvalid='keep'``: sparse output is an object column, and
        ``error`` raises on data values, which a device function cannot."""
        if self._max_indices is None:
            return None
        if (self.get(_OneHotEncoderParams.OUTPUT_FORMAT) != "dense"
                or self.get(_OneHotEncoderParams.HANDLE_INVALID)
                != HasHandleInvalid.KEEP_INVALID):
            return None
        input_cols = self.get(_OneHotEncoderParams.INPUT_COLS)
        output_cols = self.get(_OneHotEncoderParams.OUTPUT_COLS)
        if (not input_cols or not output_cols
                or len(input_cols) != len(output_cols)
                or len(input_cols) != len(self._max_indices)):
            return None
        input_cols, output_cols = tuple(input_cols), tuple(output_cols)
        drop_last = bool(self.get(_OneHotEncoderParams.DROP_LAST))
        max_idx = tuple(int(m) for m in self._max_indices)

        def fn(cols, consts, valid):
            return {out_col: encode_keep(cols[col], mv, drop_last)
                    for col, out_col, mv in zip(input_cols, output_cols,
                                                max_idx)}

        return ColumnKernel(
            input_cols=input_cols, output_cols=output_cols, fn=fn,
            fingerprint=("OneHotEncoderModel", input_cols, output_cols,
                         drop_last, max_idx),
        )


def encode_keep(values: torch.Tensor, max_index: int,
                drop_last: bool) -> torch.Tensor:
    """Dense float64 one-hot of an index column under ``keep``: the index
    truncates toward zero; one outside ``[0, max_index]`` (NaN, ±inf
    included) takes the catch-all slot ``base_size``; with ``drop_last``
    the index ``max_index`` gives an all-zero row."""
    base_size = max_index + (0 if drop_last else 1)
    if values.dtype.is_floating_point:
        t = torch.trunc(values.to(torch.float64))
        invalid = ~((t >= 0) & (t <= max_index))
        idx = torch.where(invalid, 0.0, t).to(torch.int64)
    else:
        idx = values.to(torch.int64)
        invalid = (idx < 0) | (idx > max_index)
    hot = torch.where(invalid, base_size, idx)
    onehot = F.one_hot(hot, base_size + 1).to(torch.float64)
    if drop_last:
        zero_row = ~invalid & (idx == max_index)
        onehot = torch.where(zero_row[:, None], 0.0, onehot)
    return onehot


def _check_indexed(values: np.ndarray, col: str) -> None:
    if not np.all(values == np.round(values)):
        raise ValueError(
            f"Value in column {col!r} cannot be parsed as indexed integer."
        )
