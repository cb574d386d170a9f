"""StringIndexer / IndexToString — categorical values ↔ dense indices.

Beyond the reference snapshot (whose only categorical stage is
OneHotEncoder, SURVEY.md §2.3) but the canonical upstream companion: index
string/numeric categories so they can feed OneHotEncoder and the linear
models. Semantics follow the wider Flink ML operator family:

  - ``fit`` collects per-column distinct values ordered by
    ``stringOrderType`` ∈ {arbitrary, frequencyDesc, frequencyAsc,
    alphabetAsc, alphabetDesc}; ties in the frequency orders break by
    value ascending so indexing is deterministic.
  - ``transform`` maps each value to its double-valued index;
    ``handleInvalid`` = "error" (raise on unseen), "skip" (drop the whole
    row from every column), or "keep" (unseen values map to the
    catch-all index ``len(vocabulary)``).
  - ``IndexToStringModel`` is the inverse transform, driven by the same
    model data.

The port's counterpart of ``flinkml_tpu.models.string_indexer``, the same
host numpy: category vocabularies are host metadata — strings never ship
to the device (a tensor has no string type); the indexing itself is a
vectorized ``searchsorted`` over the vocabulary, after which downstream
stages (OneHotEncoder → sparse LR) carry the data onto the device. Numeric
input columns keep their numeric dtype in the vocabulary (and
"alphabet" order means value order for them); string columns index by
exact string match.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasHandleInvalid,
    HasInputCols,
    HasOutputCols,
)
from flinkml_tpu_torch.params import IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table

ARBITRARY = "arbitrary"
FREQUENCY_DESC = "frequencyDesc"
FREQUENCY_ASC = "frequencyAsc"
ALPHABET_ASC = "alphabetAsc"
ALPHABET_DESC = "alphabetDesc"


class _StringIndexerParams(HasInputCols, HasOutputCols, HasHandleInvalid):
    MAX_INDEX_NUM = IntParam(
        "maxIndexNum",
        "Cap each column's vocabulary at the first N values in order; "
        "beyond-cap values are handled as unseen by handleInvalid. "
        "Deliberate divergence from upstream Flink ML: the cap applies "
        "under EVERY stringOrderType here (upstream honors it only for "
        "frequencyDesc) — capping an alphabetical order keeps the N "
        "alphabetically-first values.",
        2**31 - 1, ParamValidators.gt(1),
    )
    STRING_ORDER_TYPE = StringParam(
        "stringOrderType",
        "How to order distinct values before assigning indices.",
        ARBITRARY,
        ParamValidators.in_array(
            [ARBITRARY, FREQUENCY_DESC, FREQUENCY_ASC, ALPHABET_ASC, ALPHABET_DESC]
        ),
    )


def _column_values(table: Table, col: str) -> np.ndarray:
    """A column as a flat array suitable for vocab work: object/str columns
    become unicode arrays; numeric columns pass through."""
    values = table.column(col)
    if values.ndim != 1:
        raise ValueError(f"Column {col!r} must be scalar, has shape {values.shape}")
    if values.dtype == object or values.dtype.kind in "US":
        return values.astype(str)
    return values


def _ordered_vocab(values: np.ndarray, order_type: str) -> np.ndarray:
    if values.dtype.kind == "f":
        # NaN can never be matched by the equality lookup, so it must not
        # enter the vocabulary — NaN rows are handled by handleInvalid at
        # transform time instead.
        values = values[~np.isnan(values)]
        if values.size == 0:
            raise ValueError("column has no non-NaN values to index")
    uniq, counts = np.unique(values, return_counts=True)
    if order_type in (ARBITRARY, ALPHABET_ASC):
        return uniq  # np.unique is ascending — deterministic "arbitrary"
    if order_type == ALPHABET_DESC:
        return uniq[::-1].copy()
    # Frequency orders; ties break by value ascending (uniq is pre-sorted
    # and np.argsort is stable).
    if order_type == FREQUENCY_DESC:
        return uniq[np.argsort(-counts, kind="stable")]
    return uniq[np.argsort(counts, kind="stable")]


def _sorted_lookup_table(vocab: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Precompute (sorted_vocab, order) once per fitted column."""
    order = np.argsort(vocab, kind="stable")
    return vocab[order], order


def _lookup(
    values: np.ndarray, sorted_vocab: np.ndarray, order: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized vocab lookup: returns (indices, found_mask); indices are
    valid only where found. NaN values never match (vocabularies are
    NaN-free by construction)."""
    if len(sorted_vocab) == 0:
        z = np.zeros(len(values), dtype=np.int64)
        return z, np.zeros(len(values), dtype=bool)
    if sorted_vocab.dtype.kind in "US":
        values = np.asarray(values, dtype=str)
    elif values.dtype.kind in "US":
        raise TypeError(
            "string queries against a numeric-sorted vocabulary: pass the "
            "stringified lookup table (see _VocabModelBase._str_lookup)"
        )
    pos = np.searchsorted(sorted_vocab, values)
    pos_clipped = np.minimum(pos, len(sorted_vocab) - 1)
    found = sorted_vocab[pos_clipped] == values
    return order[pos_clipped], found


class StringIndexer(_StringIndexerParams, Estimator):
    """Fit per-column category vocabularies (multi-column, like the wider
    Flink ML StringIndexer)."""

    def fit(self, *inputs: Table) -> "StringIndexerModel":
        (table,) = inputs
        input_cols = self.get(self.INPUT_COLS)
        if not input_cols:
            raise ValueError("inputCols must be set")
        order_type = self.get(self.STRING_ORDER_TYPE)
        cap = self.get(self.MAX_INDEX_NUM)
        vocabs = [
            _ordered_vocab(_column_values(table, col), order_type)[:cap]
            for col in input_cols
        ]
        model = StringIndexerModel()
        model.copy_params_from(self)
        model._set_vocabs(vocabs)
        return model


class _VocabModelBase(_StringIndexerParams, Model):
    """Shared vocab-backed model scaffold: model-data tables, persistence
    (one npz key per ragged column vocabulary), and the fitted-state
    guard. StringIndexerModel and IndexToStringModel differ only in the
    direction of the mapping."""

    def __init__(self):
        super().__init__()
        self._vocabs: Optional[List[np.ndarray]] = None
        self._lookup_tables: List[Tuple[np.ndarray, np.ndarray]] = []
        self._str_lookup_tables: List[
            Optional[Tuple[np.ndarray, np.ndarray]]
        ] = []

    def _set_vocabs(self, vocabs: List[np.ndarray]) -> None:
        self._vocabs = [np.asarray(v) for v in vocabs]
        # (sorted_vocab, order) per column, fixed at fit time so transform
        # never re-sorts a (possibly high-cardinality) vocabulary.
        self._lookup_tables = [_sorted_lookup_table(v) for v in self._vocabs]
        self._str_lookup_tables: List[
            Optional[Tuple[np.ndarray, np.ndarray]]
        ] = [None] * len(self._vocabs)

    def _str_lookup(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stringified lookup table for column ``i``, built once on first
        use: a numeric-sorted vocab is not lexicographically sorted after
        str coercion (e.g. [2, 10] -> ['2', '10']), so it must be
        re-sorted — but once per model, not per transform."""
        if self._str_lookup_tables[i] is None:
            sorted_vocab, order = self._lookup_tables[i]
            as_str = np.asarray(sorted_vocab, dtype=str)
            resort = np.argsort(as_str, kind="stable")
            self._str_lookup_tables[i] = (as_str[resort], order[resort])
        return self._str_lookup_tables[i]

    def set_model_data(self, *inputs: Table):
        (table,) = inputs
        order = np.argsort(np.asarray(table.column("columnIndex")))
        terms = table.column("terms")
        self._set_vocabs([terms[i] for i in order])
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        terms = np.empty(len(self._vocabs), dtype=object)
        for i, v in enumerate(self._vocabs):
            terms[i] = v
        return [
            Table({"columnIndex": np.arange(len(self._vocabs)), "terms": terms})
        ]

    def _require_model(self) -> None:
        if self._vocabs is None:
            raise ValueError("Model data is not set; call set_model_data or fit first")

    def _arrays(self):
        self._require_model()
        # One npz key per column (vocabularies are ragged); string vocabs
        # persist as native unicode arrays — no pickling.
        arrays = {f"terms_{i}": v for i, v in enumerate(self._vocabs)}
        arrays["numColumns"] = np.asarray(len(self._vocabs))
        return arrays

    def _set_arrays(self, arrays) -> None:
        n = int(arrays["numColumns"])
        self._set_vocabs([arrays[f"terms_{i}"] for i in range(n)])

    def _check_columns(self, input_cols, output_cols) -> None:
        if len(input_cols) != len(output_cols):
            raise ValueError(
                f"{len(input_cols)} input columns vs {len(output_cols)} output columns"
            )
        if len(input_cols) != len(self._vocabs):
            raise ValueError(
                f"model was fit on {len(self._vocabs)} columns, got {len(input_cols)}"
            )


class StringIndexerModel(_VocabModelBase):
    # -- transform ---------------------------------------------------------
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        input_cols = self.get(self.INPUT_COLS)
        output_cols = self.get(self.OUTPUT_COLS)
        handle_invalid = self.get(self.HANDLE_INVALID)
        self._check_columns(input_cols, output_cols)
        out = table
        keep_mask = np.ones(table.num_rows, dtype=bool)
        for i, (col, out_col, vocab) in enumerate(
            zip(input_cols, output_cols, self._vocabs)
        ):
            values = _column_values(table, col)
            sorted_vocab, order = self._lookup_tables[i]
            if (
                values.dtype.kind in "US"
                and len(sorted_vocab)
                and sorted_vocab.dtype.kind not in "US"
            ):
                sorted_vocab, order = self._str_lookup(i)
            idx, found = _lookup(values, sorted_vocab, order)
            if handle_invalid == HasHandleInvalid.ERROR_INVALID:
                if not found.all():
                    bad = np.asarray(values)[~found][:5]
                    raise ValueError(
                        f"Column {col!r} contains values not seen during "
                        f"fitting: {list(bad)}"
                    )
            elif handle_invalid == HasHandleInvalid.SKIP_INVALID:
                keep_mask &= found
            else:  # keep: unseen → catch-all index len(vocab)
                idx = np.where(found, idx, len(vocab))
            out = out.with_column(out_col, idx.astype(np.float64))
        if not keep_mask.all():
            out = out.take(np.nonzero(keep_mask)[0])
        return (out,)


class IndexToStringModel(_VocabModelBase):
    """Inverse of StringIndexerModel: double indices → original values,
    driven by the same model data (the upstream family's
    ``IndexToStringModel``).

    The catch-all index ``len(vocab)`` — what StringIndexerModel emits for
    unseen values under ``handleInvalid='keep'`` — round-trips to a
    sentinel instead of raising: ``'__unknown__'`` for string
    vocabularies, ``NaN`` for numeric ones. Indices outside
    ``[0, len(vocab)]`` still raise."""

    UNKNOWN_SENTINEL = "__unknown__"

    @staticmethod
    def from_indexer(indexer: StringIndexerModel) -> "IndexToStringModel":
        """Build the inverse transformer from a fitted StringIndexerModel."""
        model = IndexToStringModel()
        model.copy_params_from(indexer)
        model.set_model_data(*indexer.get_model_data())
        return model

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        input_cols = self.get(self.INPUT_COLS)
        output_cols = self.get(self.OUTPUT_COLS)
        self._check_columns(input_cols, output_cols)
        out = table
        for col, out_col, vocab in zip(input_cols, output_cols, self._vocabs):
            values = np.asarray(table.column(col), dtype=np.float64)
            idx = values.astype(np.int64)
            if not np.all(values == idx):
                raise ValueError(
                    f"Column {col!r} contains non-integral indices"
                )
            invalid = (idx < 0) | (idx > len(vocab))
            if invalid.any():
                raise ValueError(
                    f"Column {col!r} contains indices outside "
                    f"[0, {len(vocab)}]: {idx[invalid][:5]}"
                )
            catch_all = idx == len(vocab)
            if len(vocab) == 0:  # every index is the catch-all
                res = np.zeros(len(idx), dtype=np.float64)
                catch_all = np.ones(len(idx), dtype=bool)
            else:
                res = vocab[np.where(catch_all, 0, idx)]
            # keep-mode round-trip: the catch-all index becomes a
            # sentinel rather than an error. The output dtype is fixed
            # per vocab kind (object for strings, float64 for numerics)
            # REGARDLESS of whether this batch contains a catch-all, so
            # downstream schema checks never flip dtype between batches.
            if vocab.dtype.kind in "USO":
                res = res.astype(object)
                res[catch_all] = self.UNKNOWN_SENTINEL
            else:
                res = res.astype(np.float64)
                res[catch_all] = np.nan
            out = out.with_column(out_col, res)
        return (out,)
