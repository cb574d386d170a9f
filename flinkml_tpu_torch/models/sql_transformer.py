"""SQLTransformer — SQL-statement row transform over a Table.

Member of the wider Flink ML operator family (upstream
``org.apache.flink.ml.feature.sqltransformer.SQLTransformer`` runs a
Flink SQL statement with ``__THIS__`` standing for the input table; the
reference snapshot has none). The port's counterpart of
``flinkml_tpu.models.sql_transformer``, the same host numpy: there is no
SQL engine in the stack and none is needed for the operator's actual use —
feature arithmetic and row filtering inside a Pipeline — so the
statement is parsed by a small recursive-descent parser (NO ``eval``,
no arbitrary code) and evaluated as vectorized numpy expressions:

    SELECT *, (a + b) / 2 AS mean_ab FROM __THIS__ WHERE a > 0

Supported surface:
  - projection items: ``*`` (every input column) and arithmetic /
    comparison / boolean expressions with optional ``AS alias``;
  - operators: ``+ - * / %``, comparisons ``= == != <> < <= > >=``,
    ``AND OR NOT``, unary minus, parentheses;
  - functions (elementwise): ABS, LOG, EXP, SQRT, POW, SIN, COS, TAN,
    FLOOR, CEIL, SIGN, MINIMUM, MAXIMUM;
  - ``WHERE expr`` filters rows of every selected column (vector and
    string columns pass through the filter untouched).

Identifiers resolve to input columns; expressions require 1-D numeric
columns (vector columns can only be selected whole, via ``*`` or a bare
column reference). An unsupported construct raises at ``transform``
time with the offending token — a deliberate, loud subset, not a quiet
approximation of SQL.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from flinkml_tpu_torch.api import Transformer
from flinkml_tpu_torch.params import StringParam
from flinkml_tpu_torch.table import Table

_FUNCS = {
    "ABS": np.abs,
    "LOG": np.log,
    "EXP": np.exp,
    "SQRT": np.sqrt,
    "SIN": np.sin,
    "COS": np.cos,
    "TAN": np.tan,
    "FLOOR": np.floor,
    "CEIL": np.ceil,
    "SIGN": np.sign,
}
_FUNCS2 = {
    "POW": np.power,
    "MINIMUM": np.minimum,
    "MAXIMUM": np.maximum,
}

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.\d*|\.\d+|\d+)"
    r"|(?P<ident>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|==|!=|<>|[-+*/%(),=<>]))"
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == pos:
            rest = text[pos:].strip()
            if not rest:
                break
            raise ValueError(f"SQLTransformer: cannot tokenize at {rest!r}")
        pos = m.end()
        for kind in ("num", "ident", "op"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v))
                break
    out.append(("end", ""))
    return out


class _Parser:
    """Recursive-descent expression parser producing a closure
    ``fn(columns: Dict[str, np.ndarray]) -> np.ndarray``."""

    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_op(self, op: str) -> None:
        kind, v = self.next()
        if kind != "op" or v != op:
            raise ValueError(f"SQLTransformer: expected {op!r}, got {v!r}")

    # expr := or
    def expr(self):
        return self._or()

    def _kw(self, word: str) -> bool:
        kind, v = self.peek()
        if kind == "ident" and v.upper() == word:
            self.next()
            return True
        return False

    def _or(self):
        left = self._and()
        while self._kw("OR"):
            right = self._and()
            left = (lambda a, b: lambda c: np.logical_or(a(c), b(c)))(
                left, right
            )
        return left

    def _and(self):
        left = self._not()
        while self._kw("AND"):
            right = self._not()
            left = (lambda a, b: lambda c: np.logical_and(a(c), b(c)))(
                left, right
            )
        return left

    def _not(self):
        if self._kw("NOT"):
            inner = self._not()
            return lambda c: np.logical_not(inner(c))
        return self._cmp()

    _CMP = {
        "=": np.equal, "==": np.equal, "!=": np.not_equal,
        "<>": np.not_equal, "<": np.less, "<=": np.less_equal,
        ">": np.greater, ">=": np.greater_equal,
    }

    def _cmp(self):
        left = self._add()
        kind, v = self.peek()
        if kind == "op" and v in self._CMP:
            self.next()
            op = self._CMP[v]
            right = self._add()
            return (lambda a, b, o: lambda c: o(a(c), b(c)))(left, right, op)
        return left

    def _add(self):
        left = self._mul()
        while True:
            kind, v = self.peek()
            if kind == "op" and v in ("+", "-"):
                self.next()
                right = self._mul()
                op = np.add if v == "+" else np.subtract
                left = (lambda a, b, o: lambda c: o(a(c), b(c)))(
                    left, right, op
                )
            else:
                return left

    def _mul(self):
        left = self._unary()
        while True:
            kind, v = self.peek()
            if kind == "op" and v in ("*", "/", "%"):
                self.next()
                op = {"*": np.multiply, "/": np.divide, "%": np.mod}[v]
                right = self._unary()
                left = (lambda a, b, o: lambda c: o(a(c), b(c)))(
                    left, right, op
                )
            else:
                return left

    def _unary(self):
        kind, v = self.peek()
        if kind == "op" and v == "-":
            self.next()
            inner = self._unary()
            return lambda c: np.negative(inner(c))
        return self._atom()

    def _atom(self):
        kind, v = self.next()
        if kind == "num":
            val = float(v)
            return lambda c: val
        if kind == "op" and v == "(":
            inner = self.expr()
            self.expect_op(")")
            return inner
        if kind == "ident":
            up = v.upper()
            nk, nv = self.peek()
            if nk == "op" and nv == "(":
                self.next()
                if up in _FUNCS:
                    arg = self.expr()
                    self.expect_op(")")
                    return (lambda f, a: lambda c: f(a(c)))(_FUNCS[up], arg)
                if up in _FUNCS2:
                    a1 = self.expr()
                    self.expect_op(",")
                    a2 = self.expr()
                    self.expect_op(")")
                    return (lambda f, x, y: lambda c: f(x(c), y(c)))(
                        _FUNCS2[up], a1, a2
                    )
                raise ValueError(f"SQLTransformer: unknown function {v!r}")
            name = v

            def col(c, name=name):
                if name not in c:
                    raise ValueError(
                        f"SQLTransformer: unknown column {name!r}"
                    )
                arr = np.asarray(c[name])
                if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.number):
                    raise ValueError(
                        f"SQLTransformer: column {name!r} is not a 1-D "
                        "numeric column; vector/string columns can only "
                        "be selected whole"
                    )
                return arr

            return col
        raise ValueError(f"SQLTransformer: unexpected token {v!r}")


def _split_top_level_commas(tokens: List[Tuple[str, str]]):
    """Split a token list on commas not inside parentheses."""
    parts, cur, depth = [], [], 0
    for t in tokens[:-1]:  # drop the trailing ("end", "")
        if t == ("op", "("):
            depth += 1
        elif t == ("op", ")"):
            depth -= 1
        if t == ("op", ",") and depth == 0:
            parts.append(cur)
            cur = []
        else:
            cur.append(t)
    parts.append(cur)
    return parts


class SQLTransformer(Transformer):
    """See the module docstring for the supported statement surface."""

    STATEMENT = StringParam(
        "statement",
        "SELECT statement over __THIS__ (the input table).",
        "SELECT * FROM __THIS__",
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        stmt = self.get(self.STATEMENT)
        m = re.match(
            r"\s*SELECT\s+(?P<items>.+?)\s+FROM\s+__THIS__"
            r"(?:\s+WHERE\s+(?P<where>.+?))?\s*;?\s*$",
            stmt, re.IGNORECASE | re.DOTALL,
        )
        if m is None:
            raise ValueError(
                "SQLTransformer supports 'SELECT <items> FROM __THIS__ "
                f"[WHERE <expr>]'; got {stmt!r}"
            )
        columns = {n: table.column(n) for n in table.column_names}
        n_rows = table.num_rows

        # SQL semantics: WHERE filters FIRST, so projection expressions
        # never evaluate on excluded rows (e.g. a / b WHERE b <> 0 must
        # not divide by the excluded zeros).
        if m.group("where") is not None:
            parser = _Parser(_tokenize(m.group("where")))
            pred = parser.expr()
            if parser.peek()[0] != "end":
                raise ValueError("SQLTransformer: trailing tokens in WHERE")
            mask = np.asarray(pred(columns))
            if mask.ndim == 0:  # constant predicate, e.g. WHERE 1 = 1
                mask = np.broadcast_to(mask, (n_rows,))
            if mask.dtype != np.bool_ or mask.ndim != 1:
                raise ValueError(
                    "SQLTransformer: WHERE must be a boolean row predicate"
                )
            columns = {k: np.asarray(v)[mask] for k, v in columns.items()}
            n_rows = int(mask.sum())

        out: Dict[str, np.ndarray] = {}

        def assign(name: str, val) -> None:
            # Upstream Flink SQL rejects duplicate output columns; a
            # silent last-wins overwrite (SELECT a, a, two expressions
            # aliased to one name, or '*' colliding with an explicit
            # item in either order) would drop a projected column.
            if name in out:
                raise ValueError(
                    f"SQLTransformer: duplicate output column {name!r}"
                )
            out[name] = val

        for part in _split_top_level_commas(_tokenize(m.group("items"))):
            if not part:
                raise ValueError("SQLTransformer: empty projection item")
            if len(part) == 1 and part[0] == ("op", "*"):
                for name, val in columns.items():
                    assign(name, val)
                continue
            # Optional trailing "AS alias".
            alias = None
            expr_toks = part
            if (
                len(part) >= 3
                and part[-2][0] == "ident" and part[-2][1].upper() == "AS"
                and part[-1][0] == "ident"
            ):
                alias = part[-1][1]
                expr_toks = part[:-2]
            # A bare column reference passes through untouched (so
            # vector/string columns can be projected by name).
            if len(expr_toks) == 1 and expr_toks[0][0] == "ident" and (
                expr_toks[0][1] in columns
            ):
                assign(alias or expr_toks[0][1], columns[expr_toks[0][1]])
                continue
            parser = _Parser(expr_toks + [("end", "")])
            fn = parser.expr()
            if parser.peek()[0] != "end":
                raise ValueError(
                    "SQLTransformer: trailing tokens in projection item "
                    f"{' '.join(v for _, v in expr_toks)!r}"
                )
            name = alias or " ".join(v for _, v in expr_toks)
            val = np.asarray(fn(columns))
            if val.ndim == 0:  # constant column, e.g. SELECT 1 AS one
                val = np.full(n_rows, float(val))
            assign(name, val)

        if not out:
            raise ValueError("SQLTransformer: empty projection")
        return (Table(out),)
