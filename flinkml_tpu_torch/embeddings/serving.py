"""Serving a sharded embedding table through the replica pool.

The port's counterpart of ``flinkml_tpu.embeddings.serving``.
:class:`EmbeddingLookupModel` is a transformer stage (the serving engine's
contract: ``transform(Table) -> (Table,)``) that maps a column of
fixed-width id rows to pooled embedding vectors:

- **Mesh-bindable** — the model carries HOST rows only; ``for_mesh``
  returns a bound clone whose :class:`~flinkml_tpu_torch.embeddings.table.
  EmbeddingTable` is placed on THAT mesh. The serving engine calls it at
  install time when ``ServingConfig.mesh`` is set, so each replica places
  its own table on its own mesh.
- **Bitwise-stable lookups** — a sharded table answers through
  :func:`~flinkml_tpu_torch.embeddings.exchange.psum_lookup` (exactly one
  shard contributes per id), so every replica and every world size
  gathers identical rows.

``precision`` (default the ``mixed_inference`` preset) gates the pooling:
gathered rows cast to ``policy.compute``, the sum accumulates at
``policy.accum`` (both bfloat16 under ``mixed_inference``) one id at a
time in id order, each add rounded at that width (the JAX package's
reduction, bit for bit), and the mean is emitted at the accum width.

Input convention: ``input_col`` holds ``[n, L]`` int id rows padded with
``-1`` (ignored by the pooling mask; an all-padding row maps to the zero
vector) or ``[n]`` single ids; ``output_col`` receives the ``[n, dim]``
pooled vectors, on the table's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.table import Table


class EmbeddingLookupModel:
    """See module docstring. Build UNBOUND from host rows; the engine (or
    a caller) binds a mesh via :meth:`for_mesh`. Unbound transforms run
    the same math on the default device (the parity reference). The rows
    of a JAX package model carry across through
    :func:`~flinkml_tpu_torch.io.read_write.stage_from_arrays` (``{"rows":
    rows}``; the JAX class has no params and no ``save``)."""

    def __init__(
        self,
        rows: Optional[np.ndarray] = None,
        *,
        input_col: str = "ids",
        output_col: str = "vector",
        precision="mixed_inference",
        plan=None,
        hbm_budget_bytes: Optional[int] = None,
        name: str = "serving",
    ):
        from flinkml_tpu_torch.precision import resolve_policy

        self._rows = None
        if rows is not None:
            self._set_arrays({"rows": rows})
        self.input_col = input_col
        self.output_col = output_col
        self.name = name
        self.plan = plan
        self.hbm_budget_bytes = hbm_budget_bytes
        self.policy = resolve_policy(precision)
        self._table = None  # set by for_mesh
        self._unbound = None  # the default device's rows, made on first use

    # -- engine protocol ---------------------------------------------------
    def for_mesh(self, mesh) -> "EmbeddingLookupModel":
        """A clone bound to ``mesh``: shares the host rows, owns a table
        placed (plan-validated, budget-checked) on that mesh — what the
        serving engine calls per replica at install."""
        from flinkml_tpu_torch.embeddings.table import EmbeddingTable

        bound = EmbeddingLookupModel(
            self._rows, input_col=self.input_col,
            output_col=self.output_col, precision=self.policy,
            plan=self.plan, hbm_budget_bytes=self.hbm_budget_bytes,
            name=self.name,
        )
        bound._table = EmbeddingTable(
            self.name, self._rows.shape[0], self._rows.shape[1],
            mesh=mesh, plan=self.plan,
            hbm_budget_bytes=self.hbm_budget_bytes, rows=self._rows,
        )
        return bound

    def _set_arrays(self, arrays) -> None:
        rows = np.asarray(arrays["rows"], np.float32)
        if rows.ndim != 2:
            raise ValueError(f"rows must be [vocab, dim], got {rows.shape}")
        self._rows = rows
        self._unbound = None

    def get_param_map_json(self) -> dict:
        return {}

    def load_param_map_json(self, json_map: dict) -> "EmbeddingLookupModel":
        return self

    def get_model_data(self):
        """The host rows as one Table (the serving sentinel's finite
        check reads it)."""
        return [Table({"rows": self._rows})]

    # -- dtype plumbing ----------------------------------------------------
    def _dtypes(self) -> Tuple[torch.dtype, torch.dtype]:
        if self.policy is not None and self.policy.mixed:
            return self.policy.compute_dtype, self.policy.accum_dtype
        return torch.float32, torch.float32

    def _ids(self, table: Table) -> np.ndarray:
        ids = np.asarray(table.column(self.input_col))
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.ndim != 2:
            raise ValueError(
                f"column {self.input_col!r} must hold [n] or [n, L] int "
                f"ids, got shape {ids.shape}"
            )
        return ids.astype(np.int64)

    def _gather(self, safe: torch.Tensor) -> torch.Tensor:
        if self._table is not None:
            return self._table.lookup(safe)
        if self._unbound is None:
            from flinkml_tpu_torch.device import default_device

            self._unbound = torch.from_numpy(self._rows).to(default_device())
        return self._unbound[safe.to(self._unbound.device)]

    # -- transform ---------------------------------------------------------
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        ids = self._ids(table)
        cdt, adt = self._dtypes()
        mask_h = ids >= 0
        rows = self._gather(torch.from_numpy(np.where(mask_h, ids, 0)))
        mask = torch.from_numpy(mask_h).to(rows.device)
        rows_c = torch.where(mask[..., None], rows.to(cdt),
                             rows.new_zeros((), dtype=cdt))
        total = rows_c[:, 0].to(adt)
        for col in range(1, rows_c.shape[1]):   # accum at policy.accum
            total = total + rows_c[:, col].to(adt)
        count = torch.clamp_min(mask.sum(dim=1), 1).to(adt)
        return (table.with_column(self.output_col, total / count[:, None]),)
