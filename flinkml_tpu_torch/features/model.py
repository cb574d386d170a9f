"""HashedFMModel — the serving consumer of the hashed feature space.

The port's counterpart of ``flinkml_tpu.features.model`` (same margin, same
persistence layout). A second-order factorization machine whose feature space IS the hash
space: ``input_col`` holds ``[n, L]`` hashed row ids (``-1`` padded, the
embedding subsystem's convention), and the margin is the sparse FM
identity over the looked-up rows::

    margin = w0 + Σ_l w[id_l] + ½ (‖Σ_l v[id_l]‖² − Σ_l ‖v[id_l]‖²)

Storage is embedding-row shaped on purpose — ``w`` is ``[B, 1]`` and
``v`` is ``[B, k]`` with ``B = num_buckets`` — so the model is
**row-delta patchable**: an incremental publish touches exactly the rows
the trainer touched (:meth:`apply_delta`), and a mesh-bound clone serves
them through :class:`~flinkml_tpu_torch.embeddings.table.
EmbeddingTable`
(``for_mesh``, the serving engine's SPMD binding contract).

Versioned-patch semantics: :meth:`apply_delta` returns a **new model**
sharing every un-touched buffer — the engine flips its active-model
reference to the clone atomically, so an in-flight batch that
snapshotted the old model keeps computing on the old rows (no host array
or table tensor is ever written in place) and every response still
carries exactly one version: the hot-swap contract, extended to row
patches.

The FML505 gate runs at construction: ``num_buckets`` must equal the
row count of ``w``/``v`` (:func:`~flinkml_tpu_torch.features.
hashing.check_hash_vocab`), so a mis-sized hash front end is refused before any
program compiles.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Model
from flinkml_tpu_torch.features.hashing import check_hash_vocab
from flinkml_tpu_torch.params import IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table


class HashedFMModel(Model):
    """See module docstring. Build with :meth:`from_arrays` (or the
    streaming trainer's ``make_model``); the no-arg constructor exists
    for the reflective loader."""

    INPUT_COL = StringParam("inputCol", "Hashed-id rows column.", "ids")
    PREDICTION_COL = StringParam(
        "predictionCol", "Output probability column.", "prediction"
    )
    RAW_PREDICTION_COL = StringParam(
        "rawPredictionCol", "Output margin column.", "rawPrediction"
    )
    NUM_BUCKETS = IntParam(
        "numBuckets", "Hash-space size (= row count of w/v).", 1,
        ParamValidators.gt(0),
    )
    HASH_SEED = IntParam(
        "hashSeed", "Seed of the hash front end this model was trained "
        "behind (recorded so serving can rebuild the same front end).", 0,
    )
    FACTOR_SIZE = IntParam(
        "factorSize", "Dimensionality of the interaction factors.", 8,
        ParamValidators.gt(0),
    )

    def __init__(self):
        super().__init__()
        self.w0: Optional[np.ndarray] = None    # [1]
        self.w: Optional[np.ndarray] = None     # [B, 1]
        self.v: Optional[np.ndarray] = None     # [B, k]
        self.plan = None
        self._w_table = None                    # set by for_mesh
        self._v_table = None

    @classmethod
    def from_arrays(cls, w0, w, v, *, num_buckets: int, hash_seed: int = 0,
                    input_col: str = "ids", plan=None) -> "HashedFMModel":
        model = cls()
        model.w0 = np.asarray(w0, np.float32).reshape(1)
        model.w = np.asarray(w, np.float32)
        model.v = np.asarray(v, np.float32)
        if model.w.ndim != 2 or model.w.shape[1] != 1:
            raise ValueError(f"w must be [B, 1], got {model.w.shape}")
        if model.v.ndim != 2:
            raise ValueError(f"v must be [B, k], got {model.v.shape}")
        if model.w.shape[0] != model.v.shape[0]:
            raise ValueError(
                f"w rows {model.w.shape[0]} != v rows {model.v.shape[0]}"
            )
        check_hash_vocab(num_buckets, model.v.shape[0],
                         where="HashedFMModel.from_arrays")
        model.set(cls.NUM_BUCKETS, int(num_buckets))
        model.set(cls.HASH_SEED, int(hash_seed))
        model.set(cls.FACTOR_SIZE, int(model.v.shape[1]))
        model.set(cls.INPUT_COL, input_col)
        model.plan = plan
        return model

    # -- mesh binding (the engine's SPMD install contract) ----------------
    def for_mesh(self, mesh) -> "HashedFMModel":
        """A clone whose w/v live as row-sharded
        :class:`~flinkml_tpu_torch.embeddings.table.
EmbeddingTable`s placed on
        ``mesh`` — what the serving engine calls per replica slice when
        ``ServingConfig.mesh`` is set. The host arrays stay authoritative
        (deltas patch host AND table)."""
        from flinkml_tpu_torch.embeddings.table import EmbeddingTable

        bound = self._clone()
        b, k = self.v.shape
        bound._w_table = EmbeddingTable(
            "hashed_fm/w", b, 1, mesh=mesh, plan=self.plan, rows=self.w
        )
        bound._v_table = EmbeddingTable(
            "hashed_fm/v", b, k, mesh=mesh, plan=self.plan, rows=self.v
        )
        return bound

    def _clone(self) -> "HashedFMModel":
        clone = HashedFMModel()
        clone.load_param_map_json(self.get_param_map_json())
        clone.w0, clone.w, clone.v = self.w0, self.w, self.v
        clone.plan = self.plan
        clone._w_table, clone._v_table = self._w_table, self._v_table
        return clone

    # -- the delta protocol (registry chain walk + engine fast swap) ------
    def delta_state(self) -> Dict[str, np.ndarray]:
        """The full state as named host arrays — what delta fingerprints
        chain over (``content_fingerprint(delta_state())``)."""
        return {"w0": np.asarray(self.w0), "w": np.asarray(self.w),
                "v": np.asarray(self.v)}

    def apply_delta(self, delta) -> "HashedFMModel":
        """A NEW model with ``delta``'s row patches (set semantics) and
        dense leaves applied; every untouched buffer is shared with
        self. Mesh-bound clones patch their tables through
        :meth:`EmbeddingTable.clone_with_row_delta`, so the old model's
        tables — and any in-flight batch holding them — are untouched."""
        clone = self._clone()
        for name, (ids, values) in delta.row_deltas().items():
            if name == "w":
                clone.w = _set_rows(clone.w, ids, values)
                if clone._w_table is not None:
                    clone._w_table = clone._w_table.clone_with_row_delta(
                        ids, values)
            elif name == "v":
                clone.v = _set_rows(clone.v, ids, values)
                if clone._v_table is not None:
                    clone._v_table = clone._v_table.clone_with_row_delta(
                        ids, values)
            else:
                raise KeyError(
                    f"delta patches unknown row table {name!r} "
                    "(HashedFMModel has 'w' and 'v')"
                )
        for name, value in delta.dense_deltas().items():
            if name != "w0":
                raise KeyError(
                    f"delta patches unknown dense leaf {name!r} "
                    "(HashedFMModel has 'w0')"
                )
            clone.w0 = np.asarray(value, np.float32).reshape(1)
        return clone

    # -- transform ---------------------------------------------------------
    def _margin(self, ids: np.ndarray) -> np.ndarray:
        mask = ids >= 0
        safe = np.where(mask, ids, 0)
        if self._v_table is not None:
            v_rows = self._v_table.lookup(safe).cpu().numpy()
            w_rows = self._w_table.lookup(safe).cpu().numpy()[..., 0]
        else:
            v_rows = self.v[safe]                       # [n, L, k]
            w_rows = self.w[safe, 0]                    # [n, L]
        fmask = mask.astype(np.float32)
        v_rows = v_rows * fmask[..., None]
        w_rows = w_rows * fmask
        sv = v_rows.sum(axis=1)                         # [n, k]
        sv2 = (v_rows * v_rows).sum(axis=1)             # [n, k]
        pair = 0.5 * (sv * sv - sv2).sum(axis=1)
        return (self.w0[0] + w_rows.sum(axis=1) + pair).astype(np.float32)

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        ids = np.asarray(table.column(self.get(self.INPUT_COL)))
        if ids.ndim == 1:
            ids = ids[:, None]
        if ids.ndim != 2:
            raise ValueError(
                f"column {self.get(self.INPUT_COL)!r} must hold [n] or "
                f"[n, L] hashed ids, got shape {ids.shape}"
            )
        margin = self._margin(ids.astype(np.int64))
        prob = (1.0 / (1.0 + np.exp(-margin))).astype(np.float32)
        out = table.with_column(self.get(self.RAW_PREDICTION_COL), margin)
        return (out.with_column(self.get(self.PREDICTION_COL), prob),)

    # -- persistence -------------------------------------------------------
    def _arrays(self) -> Dict[str, np.ndarray]:
        return self.delta_state()

    def _set_arrays(self, arrays) -> None:
        self.w0 = np.asarray(arrays["w0"], np.float32).reshape(1)
        self.w = np.asarray(arrays["w"], np.float32)
        self.v = np.asarray(arrays["v"], np.float32)

    def get_model_data(self):
        """Row-space state as one Table (w0 is broadcast metadata in the
        finite-check's eyes; it rides a [1]-row table of its own)."""
        return [Table({"w": self.w, "v": self.v}), Table({"w0": self.w0})]


def _set_rows(base: np.ndarray, ids: np.ndarray,
              values: np.ndarray) -> np.ndarray:
    """Copy-on-write row patch: a fresh array sharing nothing with
    ``base`` at the patched rows' dtype/shape contract."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    values = np.asarray(values, base.dtype)
    if values.shape != (ids.shape[0],) + base.shape[1:]:
        raise ValueError(
            f"row values shape {values.shape} != ({ids.shape[0]}, "
            f"*{base.shape[1:]})"
        )
    out = base.copy()
    out[ids] = values
    return out
