"""Text feature family: Tokenizer, RegexTokenizer, HashingTF,
CountVectorizer, IDF.

The port's counterpart of ``flinkml_tpu.models.text``, a copy in host
numpy: strings and hashing are host work in both packages, and the outputs
are the JAX package's bit for bit. HashingTF / CountVectorizerModel emit
``SparseVector`` columns that ``sparse_features`` hands straight to the
sparse trainers (documents → bag-of-words → sparse LR, where the port's
``spmv`` and ``segment_sum`` kernels run, without densifying). Hashing uses
crc32 (deterministic across runs and processes — Python's builtin ``hash``
is salted), memoized per token.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model, Transformer
from flinkml_tpu_torch.common_params import HasInputCol, HasOutputCol
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.params import (
    BoolParam,
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from flinkml_tpu_torch.table import Table


class _HasInOutCol(HasInputCol, HasOutputCol):
    pass


def _string_column(table: Table, col: str) -> np.ndarray:
    values = table.column(col)
    if values.ndim != 1:
        raise ValueError(f"Column {col!r} must be 1-D strings, got {values.shape}")
    return values


def _token_column(table: Table, col: str) -> np.ndarray:
    """A column of token sequences (object array of lists/arrays of str)."""
    values = table.column(col)
    if values.dtype != object:
        raise ValueError(
            f"Column {col!r} must be a token-list column (object dtype), "
            f"got {values.dtype} — run a Tokenizer first"
        )
    return values


def _object_column(values: List) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


class Tokenizer(_HasInOutCol, Transformer):
    """Lowercase + whitespace split (the simple tokenizer)."""

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        values = _string_column(table, self.get(self.INPUT_COL))
        tokens = _object_column([str(v).lower().split() for v in values])
        return (table.with_column(self.get(self.OUTPUT_COL), tokens),)


class RegexTokenizer(_HasInOutCol, Transformer):
    """Regex tokenization: ``gaps=True`` splits on the pattern,
    ``gaps=False`` extracts pattern matches as tokens; tokens shorter
    than ``minTokenLength`` are dropped."""

    PATTERN = StringParam("pattern", "The regex pattern.", r"\s+")
    GAPS = BoolParam(
        "gaps", "Whether the pattern matches gaps (split) or tokens (findall).",
        True,
    )
    MIN_TOKEN_LENGTH = IntParam(
        "minTokenLength", "Minimum token length to keep.", 1,
        ParamValidators.gt_eq(0),
    )
    TO_LOWERCASE = BoolParam(
        "toLowercase", "Lowercase before tokenizing.", True
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        values = _string_column(table, self.get(self.INPUT_COL))
        pattern = re.compile(self.get(self.PATTERN))
        gaps = self.get(self.GAPS)
        min_len = self.get(self.MIN_TOKEN_LENGTH)
        lower = self.get(self.TO_LOWERCASE)
        out = []
        for v in values:
            s = str(v).lower() if lower else str(v)
            toks = pattern.split(s) if gaps else pattern.findall(s)
            out.append([t for t in toks if len(t) >= min_len])
        return (
            table.with_column(self.get(self.OUTPUT_COL), _object_column(out)),
        )


class HashingTF(_HasInOutCol, Transformer):
    """Hashing-trick term frequencies: token list → SparseVector of
    ``numFeatures`` (crc32 bucket per distinct token, memoized)."""

    NUM_FEATURES = IntParam(
        "numFeatures", "Hash-space dimensionality.", 1 << 18,
        ParamValidators.gt(0),
    )
    BINARY = BoolParam(
        "binary", "Presence (1.0) instead of counts.", False
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        tokens_col = _token_column(table, self.get(self.INPUT_COL))
        n = self.get(self.NUM_FEATURES)
        binary = self.get(self.BINARY)
        # Memoized per call, NOT per instance: buckets depend on the
        # current numFeatures, and a param change between calls must not
        # reuse stale moduli.
        cache: Dict[str, int] = {}
        rows = []
        for tokens in tokens_col:
            counts: Dict[int, float] = {}
            for tok in tokens:
                tok = str(tok)
                b = cache.get(tok)
                if b is None:
                    b = zlib.crc32(tok.encode("utf-8")) % n
                    cache[tok] = b
                counts[b] = 1.0 if binary else counts.get(b, 0.0) + 1.0
            idx = np.fromiter(counts.keys(), dtype=np.int64, count=len(counts))
            val = np.fromiter(counts.values(), dtype=np.float64, count=len(counts))
            order = np.argsort(idx)
            rows.append(
                SparseVector._from_sorted(n, idx[order], val[order])
            )
        return (
            table.with_column(self.get(self.OUTPUT_COL), _object_column(rows)),
        )


class _CountVectorizerParams(_HasInOutCol):
    VOCABULARY_SIZE = IntParam(
        "vocabularySize", "Max vocabulary size (top terms by corpus count).",
        1 << 18, ParamValidators.gt(0),
    )
    MIN_DF = FloatParam(
        "minDF",
        "Minimum number (>=1) or fraction (<1) of documents a term must "
        "appear in.",
        1.0, ParamValidators.gt_eq(0.0),
    )
    MAX_DF = FloatParam(
        "maxDF",
        "Maximum number (>=1) or fraction (<1) of documents a term may "
        "appear in.",
        float(2**63), ParamValidators.gt_eq(0.0),
    )
    MIN_TF = FloatParam(
        "minTF",
        "Per-document filter at transform time: minimum count (>=1) or "
        "fraction of the document's tokens (<1).",
        1.0, ParamValidators.gt_eq(0.0),
    )
    BINARY = BoolParam("binary", "Presence (1.0) instead of counts.", False)


class CountVectorizer(_CountVectorizerParams, Estimator):
    """Fit a vocabulary from token lists, ordered by corpus term count
    descending (ties by term ascending — deterministic)."""

    def fit(self, *inputs: Table) -> "CountVectorizerModel":
        (table,) = inputs
        tokens_col = _token_column(table, self.get(self.INPUT_COL))
        n_docs = len(tokens_col)
        term_count: Dict[str, int] = {}
        doc_freq: Dict[str, int] = {}
        for tokens in tokens_col:
            seen = set()
            for tok in tokens:
                tok = str(tok)
                term_count[tok] = term_count.get(tok, 0) + 1
                if tok not in seen:
                    seen.add(tok)
                    doc_freq[tok] = doc_freq.get(tok, 0) + 1
        min_df = self.get(self.MIN_DF)
        max_df = self.get(self.MAX_DF)
        min_docs = min_df * n_docs if min_df < 1.0 else min_df
        max_docs = max_df * n_docs if max_df < 1.0 else max_df
        kept = [
            t for t, df in doc_freq.items() if min_docs <= df <= max_docs
        ]
        kept.sort(key=lambda t: (-term_count[t], t))
        vocab = kept[: self.get(self.VOCABULARY_SIZE)]
        model = CountVectorizerModel()
        model.copy_params_from(self)
        model._set_vocab(np.asarray(vocab, dtype=str))
        return model


class CountVectorizerModel(_CountVectorizerParams, Model):
    def __init__(self):
        super().__init__()
        self._vocab: Optional[np.ndarray] = None
        self._index: Dict[str, int] = {}

    def _set_vocab(self, vocab: np.ndarray) -> None:
        self._vocab = vocab
        self._index = {str(t): i for i, t in enumerate(vocab)}

    @property
    def vocabulary(self) -> np.ndarray:
        self._require()
        return self._vocab

    def set_model_data(self, *inputs: Table) -> "CountVectorizerModel":
        (table,) = inputs
        self._set_vocab(np.asarray(table.column("term"), dtype=str))
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({"term": self._vocab})]

    def _require(self) -> None:
        if self._vocab is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        tokens_col = _token_column(table, self.get(self.INPUT_COL))
        size = len(self._vocab)
        binary = self.get(self.BINARY)
        min_tf = self.get(self.MIN_TF)
        rows = []
        for tokens in tokens_col:
            counts: Dict[int, float] = {}
            for tok in tokens:
                i = self._index.get(str(tok))
                if i is not None:
                    counts[i] = counts.get(i, 0.0) + 1.0
            threshold = min_tf * len(tokens) if min_tf < 1.0 else min_tf
            items = [(i, c) for i, c in counts.items() if c >= threshold]
            items.sort()
            idx = np.asarray([i for i, _ in items], dtype=np.int64)
            val = (
                np.ones(len(items), dtype=np.float64)
                if binary
                else np.asarray([c for _, c in items], dtype=np.float64)
            )
            rows.append(SparseVector._from_sorted(size, idx, val))
        return (
            table.with_column(self.get(self.OUTPUT_COL), _object_column(rows)),
        )

    def _arrays(self):
        self._require()
        return {"term": self._vocab}

    def _set_arrays(self, arrays) -> None:
        self._set_vocab(np.asarray(arrays["term"]).reshape(-1).astype(str))


class IDF(_HasInOutCol, Estimator):
    """Inverse document frequency: fit document-frequency counts over TF
    vectors (sparse or dense), ``idf = log((n_docs + 1) / (df + 1))``;
    terms with ``df < minDocFreq`` get idf 0."""

    MIN_DOC_FREQ = IntParam(
        "minDocFreq", "Terms in fewer documents get idf 0.", 0,
        ParamValidators.gt_eq(0),
    )

    def fit(self, *inputs: Table) -> "IDFModel":
        (table,) = inputs
        col = table.column(self.get(self.INPUT_COL))
        if col.dtype == object:
            sizes = {v.size() for v in col}
            if len(sizes) != 1:
                raise ValueError(
                    f"TF vectors disagree on dimensionality: {sorted(sizes)}"
                )
            (dim,) = sizes
            df = np.zeros(dim, dtype=np.float64)
            for v in col:
                if isinstance(v, SparseVector):
                    df[v.indices[v.values != 0]] += 1.0
                else:
                    df += v.to_array() != 0
            n_docs = len(col)
        else:
            x = np.asarray(col, dtype=np.float64)
            if x.ndim != 2:
                raise ValueError(
                    f"TF column must be [n, d] or SparseVectors, got {x.shape}"
                )
            df = (x != 0).sum(axis=0).astype(np.float64)
            n_docs = x.shape[0]
        idf = np.log((n_docs + 1.0) / (df + 1.0))
        idf[df < self.get(self.MIN_DOC_FREQ)] = 0.0
        model = IDFModel()
        model.copy_params_from(self)
        model.set_model_data(Table({"idf": idf[None, :], "docFreq": df[None, :]}))
        return model


class IDFModel(_HasInOutCol, Model):
    MIN_DOC_FREQ = IDF.MIN_DOC_FREQ

    def __init__(self):
        super().__init__()
        self._idf: Optional[np.ndarray] = None
        self._doc_freq: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table) -> "IDFModel":
        (table,) = inputs
        self._idf = np.asarray(table.column("idf"), np.float64)[0]
        self._doc_freq = np.asarray(table.column("docFreq"), np.float64)[0]
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({
            "idf": self._idf[None, :], "docFreq": self._doc_freq[None, :],
        })]

    @property
    def idf(self) -> np.ndarray:
        self._require()
        return self._idf

    def _require(self) -> None:
        if self._idf is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        col = table.column(self.get(self.INPUT_COL))
        if col.dtype == object:
            rows = []
            for v in col:
                if v.size() != self._idf.shape[0]:
                    raise ValueError(
                        f"TF vector has size {v.size()}, model has "
                        f"{self._idf.shape[0]}"
                    )
                if isinstance(v, SparseVector):
                    rows.append(SparseVector._from_sorted(
                        v.size(), v.indices, v.values * self._idf[v.indices]
                    ))
                else:
                    rows.append(type(v)(v.to_array() * self._idf))
            out_col = _object_column(rows)
        else:
            x = np.asarray(col, dtype=np.float64)
            if x.ndim != 2 or x.shape[1] != self._idf.shape[0]:
                raise ValueError(
                    f"TF column shape {x.shape} does not match idf dim "
                    f"{self._idf.shape[0]}"
                )
            out_col = x * self._idf
        return (table.with_column(self.get(self.OUTPUT_COL), out_col),)

    def _arrays(self):
        self._require()
        return {"idf": self._idf, "docFreq": self._doc_freq}

    def _set_arrays(self, arrays) -> None:
        self._idf = np.asarray(arrays["idf"]).reshape(-1)
        self._doc_freq = np.asarray(arrays["docFreq"]).reshape(-1)
