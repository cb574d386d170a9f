"""VectorAssembler — concatenate numeric and vector columns into one
features column.

The port's counterpart of ``flinkml_tpu.models.vector_assembler``. A
stateless ``AlgoOperator`` (no fit): scalar columns give one slot, 2-D
columns their width. ``handleInvalid``: ``error`` rejects non-finite
values, ``skip`` drops the rows that hold one, ``keep`` passes them
through. Dtype rule: floating parts keep their dtype, non-float parts
promote to float64, and the result takes the widest (``result_type``), so
an all-float32 assembly stays float32.

``transform`` runs on the host in numpy, as the JAX package's does;
``transform_kernel`` (``keep`` only) is the same concatenation as plain
PyTorch, and the assembling prologue of the ``fused_chain`` kernel on the
card.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import AlgoOperator, ColumnKernel
from flinkml_tpu_torch.common_params import HasHandleInvalid, HasInputCols
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.params import StringParam
from flinkml_tpu_torch.table import Table


class VectorAssembler(HasInputCols, HasHandleInvalid, AlgoOperator):
    OUTPUT_COL = StringParam("outputCol", "Output column name.", "features")

    def transform_kernel(self) -> Optional[ColumnKernel]:
        """Fusable only with ``handleInvalid='keep'``: ``skip`` changes the
        row count and ``error`` raises on data values."""
        cols = self.get(self.INPUT_COLS)
        if not cols or self.get(self.HANDLE_INVALID) != HasHandleInvalid.KEEP_INVALID:
            return None
        cols = tuple(cols)
        out_col = self.get(self.OUTPUT_COL)

        def fn(colvals, consts, valid):
            parts = []
            for c in cols:
                p = colvals[c]
                if p.dim() == 1:
                    p = p.reshape(-1, 1)
                if not p.dtype.is_floating_point:
                    p = p.to(torch.float64)
                parts.append(p)
            dt = functools.reduce(torch.promote_types, (p.dtype for p in parts))
            return {out_col: torch.cat([p.to(dt) for p in parts], dim=1)}

        return ColumnKernel(
            input_cols=cols, output_cols=(out_col,), fn=fn,
            fingerprint=("VectorAssembler", cols, out_col),
        )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        cols = self.get(self.INPUT_COLS)
        if not cols:
            raise ValueError("inputCols must be set")
        parts: List[np.ndarray] = [
            features_matrix(table, c, dtype=None) for c in cols
        ]
        n = parts[0].shape[0]
        for c, p in zip(cols, parts):
            if p.shape[0] != n:
                raise ValueError(
                    f"column {c!r} has {p.shape[0]} rows, expected {n}"
                )
        dt = np.result_type(*(p.dtype for p in parts))
        out = np.concatenate([p.astype(dt, copy=False) for p in parts], axis=1)
        mode = self.get(self.HANDLE_INVALID)
        bad = ~np.isfinite(out).all(axis=1)
        if mode == "error":
            if bad.any():
                raise ValueError(
                    f"non-finite value in row {int(np.argmax(bad))}; "
                    "set handleInvalid to 'skip' or 'keep' to allow"
                )
        elif mode == "skip":
            if bad.any():
                keep = ~bad
                table = table.take(np.flatnonzero(keep))
                out = out[keep]
        return (table.with_column(self.get(self.OUTPUT_COL), out),)
