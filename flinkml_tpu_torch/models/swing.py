"""Swing — item-similarity recommendation from user-item interactions
(the upstream Flink ML recommendation operator).

For every item pair (i, j), similarity sums over user pairs (u, v) that
both interacted with both items:

    sim(i, j) = Σ_{u,v ∈ U_i ∩ U_j, u<v}  w_u · w_v / (α₁ + |I_u ∩ I_v|)
    w_u = 1 / (α₂ + |I_u|)^β

The "swing" intuition: two users sharing MANY items are weak evidence
for any one pair (the 1/(α₁+overlap) damping); a user pair whose ONLY
overlap is {i, j} is strong evidence.

An AlgoOperator: output is one row per item with its top-k similar
items and scores. Combinatorial set intersection is host work
(``maxUserNumPerItem`` bounds the per-item user-pair blowup exactly as
the upstream operator does); numpy sorted-array intersections do the
counting.

The port's counterpart of ``flinkml_tpu.models.swing``, the same host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from flinkml_tpu_torch.api import AlgoOperator
from flinkml_tpu_torch.params import FloatParam, IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.table import Table


class Swing(AlgoOperator):
    USER_COL = StringParam("userCol", "User id column.", "user")
    ITEM_COL = StringParam("itemCol", "Item id column.", "item")
    K = IntParam(
        "k", "How many similar items to keep per item.", 100,
        ParamValidators.gt(0),
    )
    MIN_USER_BEHAVIOR = IntParam(
        "minUserBehavior",
        "Users with fewer interactions are ignored.", 10,
        ParamValidators.gt(0),
    )
    MAX_USER_BEHAVIOR = IntParam(
        "maxUserBehavior",
        "Users with more interactions are ignored (bot guard).", 1000,
        ParamValidators.gt(0),
    )
    MAX_USER_NUM_PER_ITEM = IntParam(
        "maxUserNumPerItem",
        "Cap on each item's user list (bounds the user-pair blowup).",
        1000, ParamValidators.gt(0),
    )
    ALPHA1 = FloatParam(
        "alpha1", "Overlap damping in 1/(alpha1 + |I_u ∩ I_v|).", 15.0,
        ParamValidators.gt_eq(0.0),
    )
    ALPHA2 = FloatParam(
        "alpha2", "Smoothing in the user weight denominator.", 0.0,
        ParamValidators.gt_eq(0.0),
    )
    BETA = FloatParam(
        "beta", "User-activity damping exponent.", 0.3,
        ParamValidators.gt_eq(0.0),
    )

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        users = np.asarray(table.column(self.get(self.USER_COL)))
        items = np.asarray(table.column(self.get(self.ITEM_COL)))
        if users.shape[0] != items.shape[0]:
            raise ValueError("user and item columns must have equal length")
        min_b = self.get(self.MIN_USER_BEHAVIOR)
        max_b = self.get(self.MAX_USER_BEHAVIOR)
        if min_b > max_b:
            raise ValueError(
                f"minUserBehavior {min_b} > maxUserBehavior {max_b}"
            )
        user_ids, u_idx = np.unique(users, return_inverse=True)
        item_ids, i_idx = np.unique(items, return_inverse=True)

        # Deduplicated per-user sorted item arrays; pair_codes is sorted,
        # so one searchsorted split groups all users in O(N + U log N).
        pair_codes = np.unique(u_idx.astype(np.int64) * len(item_ids) + i_idx)
        pu = pair_codes // len(item_ids)
        pi = pair_codes % len(item_ids)
        user_items: List[np.ndarray] = np.split(
            pi, np.searchsorted(pu, np.arange(1, len(user_ids)))
        )
        counts = np.asarray([len(v) for v in user_items])
        eligible = (counts >= min_b) & (counts <= max_b)

        alpha1 = self.get(self.ALPHA1)
        alpha2 = self.get(self.ALPHA2)
        beta = self.get(self.BETA)
        weights = 1.0 / np.power(
            alpha2 + np.maximum(counts, 1), beta
        )

        # Per-item eligible user lists, capped (first maxUserNumPerItem in
        # user order, the upstream behavior). The cap GATES contributions:
        # a user evicted from an item's list must not contribute to any
        # similarity involving that item.
        cap = self.get(self.MAX_USER_NUM_PER_ITEM)
        item_users: List[List[int]] = [[] for _ in item_ids]
        item_user_sets: List[set] = [set() for _ in item_ids]
        for u in range(len(user_ids)):
            if not eligible[u]:
                continue
            for it in user_items[u]:
                if len(item_users[it]) < cap:
                    item_users[it].append(u)
                    item_user_sets[it].add(u)

        # Unique user pairs that co-occur on some item's capped list.
        seen_pairs = set()
        for ulist in item_users:
            for a in range(len(ulist)):
                for b in range(a + 1, len(ulist)):
                    seen_pairs.add((ulist[a], ulist[b]))

        sims: Dict[Tuple[int, int], float] = {}
        for u, v in seen_pairs:
            common = np.intersect1d(
                user_items[u], user_items[v], assume_unique=True
            )
            # Damping uses the users' full behavioral overlap; the pair
            # only scores items where BOTH survived the per-item cap.
            m = len(common)
            if m < 2:
                continue
            capped = [
                it for it in common
                if u in item_user_sets[it] and v in item_user_sets[it]
            ]
            if len(capped) < 2:
                continue
            contrib = weights[u] * weights[v] / (alpha1 + m)
            for a in range(len(capped)):
                ia = capped[a]
                for b in range(a + 1, len(capped)):
                    key = (ia, capped[b])
                    sims[key] = sims.get(key, 0.0) + contrib

        # Top-k per item.
        per_item: Dict[int, List[Tuple[float, int]]] = {}
        for (ia, ib), s in sims.items():
            per_item.setdefault(ia, []).append((s, ib))
            per_item.setdefault(ib, []).append((s, ia))
        k = self.get(self.K)
        main_items, similar, scores = [], [], []
        for it in range(len(item_ids)):
            ranked = sorted(
                per_item.get(it, []), key=lambda t: (-t[0], t[1])
            )[:k]
            main_items.append(item_ids[it])
            similar.append(np.asarray([item_ids[j] for _, j in ranked]))
            scores.append(np.asarray([s for s, _ in ranked]))
        sim_col = np.empty(len(main_items), dtype=object)
        score_col = np.empty(len(main_items), dtype=object)
        for i, (sv, sc) in enumerate(zip(similar, scores)):
            sim_col[i] = sv
            score_col[i] = sc
        return (
            Table({
                self.get(self.ITEM_COL): np.asarray(main_items),
                "similarItems": sim_col,
                "scores": score_col,
            }),
        )
