"""Streaming row sampling for one-pass estimators.

The port's copy of ``flinkml_tpu.utils.sampling`` (numpy only).
:class:`RowReservoir` is uniform reservoir sampling (Algorithm R) over row
blocks: a streamed fit draws a bounded, seed-deterministic row sample during
its epoch-0 caching pass (KMeans' initial centroids) without a second full
pass. Its draws are the JAX package's, call for call, so for the same seed
and the same blocks both packages hold the same sample bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RowReservoir:
    """Uniform sample of up to ``capacity`` rows from a stream of blocks.

    Block-vectorized Algorithm R: the fill phase copies rows directly;
    afterwards row number ``s`` (1-based, global) replaces a uniform slot
    with probability ``capacity / s``. Accepted replacements are applied
    in stream order, so the result is the sequential algorithm's.
    Deterministic for a fixed seed and stream.
    """

    def __init__(self, capacity: int, seed: int = 0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self._buf: Optional[np.ndarray] = None
        self.rows_seen = 0

    def add(self, block: np.ndarray) -> None:
        block = np.asarray(block)
        if block.ndim < 1 or block.shape[0] == 0:
            return
        if self._buf is None:
            self._buf = np.empty(
                (self.capacity,) + block.shape[1:], dtype=block.dtype
            )
        m = block.shape[0]
        i = 0
        if self.rows_seen < self.capacity:  # fill phase
            take = min(self.capacity - self.rows_seen, m)
            self._buf[self.rows_seen:self.rows_seen + take] = block[:take]
            self.rows_seen += take
            i = take
        if i < m:
            # Global 1-based index of each remaining row.
            s = self.rows_seen + np.arange(1, m - i + 1)
            accept = self._rng.random(m - i) < self.capacity / s
            idx = np.nonzero(accept)[0]
            slots = self._rng.integers(0, self.capacity, size=len(idx))
            for j, slot in zip(idx, slots):  # few accepts once s >> capacity
                self._buf[slot] = block[i + j]
            self.rows_seen += m - i

    def sample(self) -> np.ndarray:
        """The sampled rows (a copy), ``min(rows_seen, capacity)`` of them."""
        if self._buf is None:
            return np.empty((0,))
        return self._buf[: min(self.rows_seen, self.capacity)].copy()
