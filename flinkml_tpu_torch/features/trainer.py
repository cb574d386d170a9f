"""StreamingHashedFMTrainer — unbounded hashed-id stream → FM state.

The port's counterpart of ``flinkml_tpu.features.trainer``: the same host
arithmetic between the table lookups and scatters (the tables live on the
compute device). The training half of the freshness loop: consumes ``[n, L]`` hashed-id
batches (``-1`` padded — exactly what :class:`~flinkml_tpu_torch.features.
hashing.HashedFeature` / ``Dataset.hash_column`` emit) and keeps the FM
state in :class:`~flinkml_tpu_torch.embeddings.table.EmbeddingTable`\\ s, so
the same object trains unsharded on a laptop and row-sharded on a mesh
with no code change — updates flow through ``scatter_add`` (the
strategy-gated exchange), never a dense gradient.

What makes it a *delta source* rather than just a trainer:

- it tracks the exact row ids touched since the last publish
  (:meth:`drain_touched`), which is precisely the payload of an
  incremental publish — the publisher ships those rows' CURRENT
  contents, nothing else;
- it counts batches into a **watermark** (:attr:`watermark`), the
  freshness currency: every publish is stamped with it, and the pool's
  ``serving.<pool>.freshness`` gauge is trainer-watermark minus
  served-watermark, with no wall clock anywhere;
- :meth:`delta_state` / :meth:`state_fingerprint` expose the full state
  under the same names/fingerprint the served
  :class:`~flinkml_tpu_torch.features.model.HashedFMModel` reports, so the
  registry can verify a delta chain end-to-end against trainer truth.

Optimizer: plain SGD on the mean logistic loss of the sparse FM margin
(the JAX package's ``models.fm`` identity). Deliberately stateless
beyond the parameters — optimizer slots would just ride along as more
row tables in a delta.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from flinkml_tpu_torch.features.model import HashedFMModel
from flinkml_tpu_torch.io.read_write import content_fingerprint
from flinkml_tpu_torch.utils.metrics import metrics


class StreamingHashedFMTrainer:
    """See module docstring."""

    def __init__(
        self,
        *,
        num_buckets: int,
        factor_size: int = 8,
        hash_seed: int = 0,
        learning_rate: float = 0.05,
        init_scale: float = 0.01,
        seed: int = 0,
        mesh=None,
        plan=None,
        input_col: str = "hashed_ids",
        name: str = "hashed_fm",
    ):
        from flinkml_tpu_torch.embeddings.table import EmbeddingTable

        if num_buckets < 1:
            raise ValueError(f"need num_buckets >= 1, got {num_buckets}")
        if factor_size < 1:
            raise ValueError(f"need factor_size >= 1, got {factor_size}")
        self.num_buckets = int(num_buckets)
        self.factor_size = int(factor_size)
        self.hash_seed = int(hash_seed)
        self.learning_rate = float(learning_rate)
        self.input_col = input_col
        self.plan = plan
        self.w0 = np.zeros(1, np.float32)
        self._w_table = EmbeddingTable(
            f"{name}/w", self.num_buckets, 1, mesh=mesh, plan=plan
        )
        self._v_table = EmbeddingTable(
            f"{name}/v", self.num_buckets, self.factor_size, mesh=mesh,
            plan=plan, seed=seed, scale=init_scale,
        )
        #: Batches consumed so far — the freshness watermark every
        #: publish is stamped with.
        self.watermark = 0
        self._touched_since_publish: set = set()
        self._metrics = metrics.group("features.trainer",
                                      labels={"trainer": name})

    # -- training ----------------------------------------------------------
    def fit_batch(self, ids: np.ndarray, labels: np.ndarray) -> float:
        """One SGD step on an ``[n, L]`` hashed-id batch (``-1`` padded)
        with ``[n]`` binary labels. Returns the batch's mean logloss."""
        ids = np.asarray(ids, np.int64)
        if ids.ndim == 1:
            ids = ids[:, None]
        labels = np.asarray(labels, np.float32).reshape(-1)
        n, L = ids.shape
        if labels.shape[0] != n:
            raise ValueError(f"{n} id rows != {labels.shape[0]} labels")
        mask = ids >= 0
        if ids.max(initial=-1) >= self.num_buckets:
            raise ValueError(
                f"hashed id {int(ids.max())} out of range "
                f"[0, {self.num_buckets}) — front-end num_buckets and "
                "trainer num_buckets disagree (the FML505 condition)"
            )
        safe = np.where(mask, ids, 0)
        fmask = mask.astype(np.float32)

        v_rows = self._v_table.lookup(safe).cpu().numpy() * fmask[..., None]
        w_rows = self._w_table.lookup(safe).cpu().numpy()[..., 0] * fmask
        sv = v_rows.sum(axis=1)                              # [n, k]
        pair = 0.5 * ((sv * sv) - (v_rows * v_rows).sum(axis=1)).sum(axis=1)
        margin = self.w0[0] + w_rows.sum(axis=1) + pair      # [n]
        prob = 1.0 / (1.0 + np.exp(-margin))
        g = (prob - labels).astype(np.float32) / float(n)    # dL/dmargin

        # Masked slots scatter id 0 with a zero row — an exact no-op add.
        flat_ids = safe.reshape(-1).astype(np.int32)
        gw = (g[:, None] * fmask).reshape(-1, 1)
        gv = (g[:, None, None] * (sv[:, None, :] - v_rows)
              * fmask[..., None]).reshape(-1, self.factor_size)
        lr = self.learning_rate
        self._w_table.scatter_add(flat_ids, (-lr * gw).astype(np.float32))
        self._v_table.scatter_add(flat_ids, (-lr * gv).astype(np.float32))
        self.w0 = (self.w0 - lr * g.sum()).astype(np.float32)

        self._touched_since_publish.update(int(i) for i in ids[mask])
        self.watermark += 1
        self._metrics.counter("batches")
        self._metrics.counter("rows", n)
        self._metrics.gauge("watermark", self.watermark)
        self._metrics.gauge("touched_rows", len(self._touched_since_publish))
        eps = 1e-7
        p = np.clip(prob, eps, 1.0 - eps)
        return float(-(labels * np.log(p)
                       + (1.0 - labels) * np.log(1.0 - p)).mean())

    # -- delta source ------------------------------------------------------
    def drain_touched(self) -> np.ndarray:
        """Sorted row ids touched since the last drain — the id set an
        incremental publish ships — and reset the tracker."""
        out = np.array(sorted(self._touched_since_publish), np.int32)
        self._touched_since_publish.clear()
        return out

    def rows_for(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        """The CURRENT contents of ``ids`` rows per table — a delta's
        values arrays."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        return {
            "w": self._w_table.to_host()[ids],
            "v": self._v_table.to_host()[ids],
        }

    def delta_state(self) -> Dict[str, np.ndarray]:
        return {"w0": np.asarray(self.w0),
                "w": self._w_table.to_host(),
                "v": self._v_table.to_host()}

    def state_fingerprint(self) -> str:
        """``content_fingerprint`` over :meth:`delta_state` — the chain
        currency; matches the served model's fingerprint bit-for-bit."""
        return content_fingerprint(self.delta_state())

    def make_model(self, plan=None) -> HashedFMModel:
        """A host-side :class:`HashedFMModel` of the current state (a
        full-snapshot publish; the engine mesh-binds it on install)."""
        state = self.delta_state()
        return HashedFMModel.from_arrays(
            state["w0"], state["w"], state["v"],
            num_buckets=self.num_buckets, hash_seed=self.hash_seed,
            input_col=self.input_col, plan=plan if plan else self.plan,
        )
