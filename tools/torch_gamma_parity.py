"""The port's float64 threefry draws against ``jax.random``, on the CPU.

Usage: ``JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_gamma_parity.py``

Counts, for ``normal`` in float64 (300,000 draws a seed) and ``gamma`` at
``a`` in {1, 1.5, 2.5, 10, 100} (100,000 draws a seed and ``a``), over
seeds 0, 7 and 123456789: the draws whose bits differ from JAX's (under
``jax_enable_x64``), the largest gap in ulps, and for ``gamma`` the draws
whose accept/reject decisions flipped (a flip changes a draw wholly, so
it is counted as a relative gap above 1e-9). Prints one JSON object.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

from flinkml_tpu_torch.ops import threefry  # noqa: E402

SEEDS = (0, 7, 123456789)
GAMMA_SHAPES = (1.0, 1.5, 2.5, 10.0, 100.0)


def gaps(want, got):
    ulps = np.abs(np.asarray(want).view(np.int64)
                  - np.asarray(got).view(np.int64))
    flips = np.abs(np.asarray(got) - np.asarray(want)) > 1e-9 * np.abs(want)
    return int((ulps > 0).sum()), int(ulps.max()), int(flips.sum())


def main() -> None:
    out = {"normal": {"draws": 0, "differ": 0, "max_ulps": 0},
           "gamma": {"draws": 0, "differ": 0, "max_ulps": 0, "flips": 0}}
    for seed in SEEDS:
        jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed, "cpu")
        n = 300_000
        differ, ulps, _ = gaps(
            jax.random.normal(jk, (n,), dtype=jax.numpy.float64),
            threefry.normal(tk, (n,), torch.float64).numpy())
        rec = out["normal"]
        rec["draws"] += n
        rec["differ"] += differ
        rec["max_ulps"] = max(rec["max_ulps"], ulps)
        for a in GAMMA_SHAPES:
            n = 100_000
            differ, ulps, flips = gaps(
                jax.random.gamma(jk, a, (n,)),
                threefry.gamma(tk, a, (n,)).numpy())
            rec = out["gamma"]
            rec["draws"] += n
            rec["differ"] += differ
            rec["flips"] += flips
            rec["max_ulps"] = max(rec["max_ulps"], ulps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
