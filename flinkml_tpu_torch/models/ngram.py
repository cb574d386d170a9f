"""NGram — token lists → space-joined n-grams (the upstream operator);
the port's copy of ``flinkml_tpu.models.ngram``, in host Python.

Rows with fewer than ``n`` tokens produce an empty list (upstream
convention).
"""

from __future__ import annotations

from typing import Tuple

from flinkml_tpu_torch.api import Transformer
from flinkml_tpu_torch.common_params import HasInputCol, HasOutputCol
from flinkml_tpu_torch.models.text import _object_column, _token_column
from flinkml_tpu_torch.params import IntParam, ParamValidators
from flinkml_tpu_torch.table import Table


class NGram(HasInputCol, HasOutputCol, Transformer):
    N = IntParam("n", "Number of tokens per n-gram.", 2, ParamValidators.gt(0))

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        tokens_col = _token_column(table, self.get(self.INPUT_COL))
        n = self.get(self.N)
        out = [
            [" ".join(map(str, toks[i: i + n]))
             for i in range(len(toks) - n + 1)]
            for toks in tokens_col
        ]
        return (
            table.with_column(self.get(self.OUTPUT_COL), _object_column(out)),
        )
