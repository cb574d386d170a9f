"""FPGrowth — frequent-itemset mining + association rules (the
Spark/Flink family member).

Classic FP-tree mining on the host: itemset mining is pointer-chasing
over a prefix tree — no dense numeric structure for an accelerator to
exploit (the genuinely combinatorial corner of the library, like
Swing's set intersections). ``minSupport`` is a fraction of baskets;
rules are single-consequent (the Spark convention) with confidence and
lift; ``transform`` predicts, per basket, the union of consequents of
applicable rules minus items already present.

The port's counterpart of ``flinkml_tpu.models.fpgrowth``, the same host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.models.text import _object_column, _token_column
from flinkml_tpu_torch.params import FloatParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table


class _FPNode:
    __slots__ = ("item", "count", "parent", "children")

    def __init__(self, item, parent):
        self.item = item
        self.count = 0
        self.parent = parent
        self.children: Dict[str, "_FPNode"] = {}


def _build_tree(transactions, counts, min_count):
    """Build an FP-tree over support-ordered, filtered transactions.
    Returns (root, header: item -> list of nodes)."""
    order = {
        it: (-c, it) for it, c in counts.items() if c >= min_count
    }
    root = _FPNode(None, None)
    header: Dict[str, List[_FPNode]] = {}
    for basket, mult in transactions:
        items = sorted(
            (it for it in basket if it in order), key=lambda it: order[it]
        )
        node = root
        for it in items:
            child = node.children.get(it)
            if child is None:
                child = _FPNode(it, node)
                node.children[it] = child
                header.setdefault(it, []).append(child)
            child.count += mult
            node = child
    return root, header


def _mine(transactions, counts, min_count, suffix, out):
    root, header = _build_tree(transactions, counts, min_count)
    # Items ascending by support: standard FP-growth order.
    items = sorted(
        header, key=lambda it: (counts[it], it)
    )
    for it in items:
        support = sum(n.count for n in header[it])
        itemset = tuple(sorted(suffix + (it,)))
        out[itemset] = support
        # Conditional pattern base: prefix paths above each node.
        cond_trans = []
        cond_counts: Dict[str, int] = {}
        for node in header[it]:
            path = []
            p = node.parent
            while p is not None and p.item is not None:
                path.append(p.item)
                p = p.parent
            if path:
                cond_trans.append((path, node.count))
                for pi in path:
                    cond_counts[pi] = cond_counts.get(pi, 0) + node.count
        if cond_trans:
            _mine(cond_trans, cond_counts, min_count, suffix + (it,), out)


def fpgrowth(baskets: List[List[str]], min_support: float):
    """Frequent itemsets: dict {tuple(sorted items): count}."""
    n = len(baskets)
    min_count = max(1, int(np.ceil(min_support * n)))
    counts: Dict[str, int] = {}
    dedup = []
    for b in baskets:
        items = set(map(str, b))
        dedup.append((items, 1))
        for it in items:
            counts[it] = counts.get(it, 0) + 1
    out: Dict[Tuple[str, ...], int] = {}
    _mine(dedup, counts, min_count, (), out)
    return out


class FPGrowth(Estimator):
    ITEMS_COL = StringParam("itemsCol", "Basket (token-list) column.", "items")
    MIN_SUPPORT = FloatParam(
        "minSupport", "Minimum fraction of baskets an itemset appears in.",
        0.3, ParamValidators.in_range(0.0, 1.0, lower_inclusive=False),
    )
    MIN_CONFIDENCE = FloatParam(
        "minConfidence", "Minimum confidence for association rules.", 0.8,
        ParamValidators.in_range(0.0, 1.0),
    )
    PREDICTION_COL = StringParam(
        "predictionCol", "Output column of predicted items.", "prediction"
    )

    def fit(self, *inputs: Table) -> "FPGrowthModel":
        (table,) = inputs
        baskets = _token_column(table, self.get(self.ITEMS_COL))
        itemsets = fpgrowth(
            [list(b) for b in baskets], self.get(self.MIN_SUPPORT)
        )
        model = FPGrowthModel()
        model.copy_params_from(self)
        model._set(itemsets, len(baskets))
        return model


class FPGrowthModel(Model):
    ITEMS_COL = FPGrowth.ITEMS_COL
    MIN_SUPPORT = FPGrowth.MIN_SUPPORT
    MIN_CONFIDENCE = FPGrowth.MIN_CONFIDENCE
    PREDICTION_COL = FPGrowth.PREDICTION_COL

    def __init__(self):
        super().__init__()
        self._itemsets: Optional[Dict[Tuple[str, ...], int]] = None
        self._n_baskets: int = 0
        self._rule_cache = None

    def _set(self, itemsets, n_baskets: int) -> None:
        self._itemsets = dict(itemsets)
        self._n_baskets = int(n_baskets)
        self._rule_cache = None   # (minConfidence, rules); lazy

    def _require(self) -> None:
        if self._itemsets is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    # -- outputs -------------------------------------------------------------
    def freq_itemsets(self) -> Table:
        """One row per frequent itemset: (items, freq), support-desc."""
        self._require()
        ordered = sorted(
            self._itemsets.items(), key=lambda kv: (-kv[1], kv[0])
        )
        items = _object_column([list(k) for k, _ in ordered])
        return Table({
            "items": items,
            "freq": np.asarray([v for _, v in ordered], np.int64),
        })

    def association_rules(self) -> Table:
        """Single-consequent rules with confidence ≥ minConfidence:
        (antecedent, consequent, confidence, lift, support)."""
        self._require()
        min_conf = self.get(self.MIN_CONFIDENCE)
        n = max(self._n_baskets, 1)
        ante, cons, confs, lifts, supps = [], [], [], [], []
        for itemset, count in self._itemsets.items():
            if len(itemset) < 2:
                continue
            for i, c in enumerate(itemset):
                a = itemset[:i] + itemset[i + 1:]
                a_count = self._itemsets.get(a)
                if not a_count:
                    continue
                conf = count / a_count
                if conf < min_conf:
                    continue
                c_count = self._itemsets.get((c,), 0)
                ante.append(list(a))
                cons.append(c)
                confs.append(conf)
                lifts.append(conf / (c_count / n) if c_count else np.nan)
                supps.append(count / n)
        return Table({
            "antecedent": _object_column(ante),
            "consequent": np.asarray(cons, dtype=str),
            "confidence": np.asarray(confs),
            "lift": np.asarray(lifts),
            "support": np.asarray(supps),
        })

    def _rules_for_transform(self):
        conf = self.get(self.MIN_CONFIDENCE)
        if self._rule_cache is None or self._rule_cache[0] != conf:
            rules = self.association_rules()
            self._rule_cache = (conf, [
                (frozenset(a), c)
                for a, c in zip(rules["antecedent"], rules["consequent"])
                if len(a)
            ])
        return self._rule_cache[1]

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        """Per basket: consequents of rules whose antecedent ⊆ basket,
        minus items already present (the Spark transform)."""
        (table,) = inputs
        self._require()
        rule_list = self._rules_for_transform()
        baskets = _token_column(table, self.get(self.ITEMS_COL))
        preds = []
        for b in baskets:
            bs = set(map(str, b))
            hit = {c for a, c in rule_list if a <= bs and c not in bs}
            preds.append(sorted(hit))
        return (
            table.with_column(
                self.get(self.PREDICTION_COL), _object_column(preds)
            ),
        )

    # -- persistence ---------------------------------------------------------
    def set_model_data(self, *inputs: Table) -> "FPGrowthModel":
        (table,) = inputs
        items = table.column("items")
        freqs = np.asarray(table.column("freq"), np.int64)
        # numBaskets rides per row, with a freq=-1 sentinel row so an
        # EMPTY model (nothing frequent) still carries it.
        n = int(np.asarray(table.column("numBaskets"))[0])
        real = freqs >= 0
        self._set(
            {
                tuple(sorted(map(str, it))): int(f)
                for it, f, keep in zip(items, freqs, real) if keep
            },
            n,
        )
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        t = self.freq_itemsets()
        items = np.empty(t.num_rows + 1, dtype=object)
        items[0] = []          # sentinel row: freq -1, carries numBaskets
        for i in range(t.num_rows):
            items[i + 1] = t.column("items")[i]
        freqs = np.concatenate([[-1], np.asarray(t.column("freq"), np.int64)])
        return [Table({
            "items": items,
            "freq": freqs,
            "numBaskets": np.full(t.num_rows + 1, self._n_baskets),
        })]

    def save(self, path: str) -> None:
        self._require()
        # Itemsets serialize as NUL-joined strings; a NUL inside an item
        # would silently change itemset arity on load, so reject it.
        if any("\x00" in it for k in self._itemsets for it in k):
            raise ValueError(
                "item strings must not contain NUL characters to be saved"
            )
        keys = ["\x00".join(k) for k in self._itemsets]
        self._save_with_arrays(
            path,
            {
                "itemsets": np.asarray(keys, dtype=str),
                "freq": np.asarray(list(self._itemsets.values()), np.int64),
            },
            extra={"numBaskets": self._n_baskets},
        )

    @classmethod
    def load(cls, path: str) -> "FPGrowthModel":
        model, arrays, meta = cls._load_with_arrays(path)
        model._set_arrays({**arrays, "numBaskets": meta["numBaskets"]})
        return model

    def _set_arrays(self, arrays) -> None:
        """The saved arrays, with the metadata's ``numBaskets`` among
        them."""
        itemsets = {
            tuple(k.split("\x00")): int(f)
            for k, f in zip(np.asarray(arrays["itemsets"]).astype(str),
                            np.asarray(arrays["freq"]))
        }
        self._set(itemsets,
                  int(np.asarray(arrays["numBaskets"]).reshape(-1)[0]))
