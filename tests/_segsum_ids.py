"""Sorted id patterns for the ``segment_sum`` tests, on the CPU (against the
JAX kernel) and on the card: seeded, no JAX, no card."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from flinkml_tpu_torch.kernels.segsum import SORTED_TILE


def sorted_id_patterns(seed: int = 0) -> Dict[str, Tuple[np.ndarray, int]]:
    """``{name: (ascending int32 ids, num_segments)}``; every cell count is
    odd, so none is a multiple of 4."""
    rng = np.random.default_rng(seed)
    tile = SORTED_TILE
    runs = rng.integers(1, 41, size=1201)
    random_runs = np.repeat(np.arange(runs.size) * 2, runs)
    gaps = np.concatenate([np.full(7, 3), np.arange(4, 904),
                           np.full(13, 1500), np.arange(1501, 1700)])
    long_runs = np.repeat([0, 1, 2, 5, 6],
                          [1, tile + 5, 2, 3 * tile + 1, 4])
    return {
        # One id for every cell: a run past several tiles.
        "one_id": (np.full(2 * tile + 2 * 7 + 1, 5), 9),
        # Every cell its own segment.
        "distinct": (np.arange(3 * tile + 1), 3 * tile + 1),
        # Empty segments at the start (0-2), in the middle (904-1499) and
        # at the end (1700-1999).
        "gaps": (gaps[:gaps.size - 1 + gaps.size % 2], 2000),
        # Runs longer than a tile, one crossing three tile boundaries.
        "long_runs": (long_runs, 8),
        # Runs of 1-40 cells with a gap after each; num_segments well past
        # the largest id + 1.
        "random_runs": (random_runs[:random_runs.size - 1
                                    + random_runs.size % 2],
                        2 * runs.size + 500),
        # Few cells over many segments: long gaps everywhere.
        "sparse": (np.sort(rng.choice(200_000, 301, replace=False)),
                   250_000),
    }
