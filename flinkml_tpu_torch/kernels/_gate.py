"""Kernel sites, the typed refusal, and the launch counters.

The port's counterpart of ``flinkml_tpu.kernels._gate``. The JAX package
chooses between XLA and Pallas per site (env var > autotune table > XLA,
with a warn-once fallback). The port has no such choice: a kernel
wrapper takes its plain PyTorch version for a tensor on the CPU, and for a
CUDA tensor it launches the hand-written kernel or raises
:class:`KernelUnsupportedError`. Nothing falls back silently.

Each wrapper owns one :class:`LaunchCounter`, bumped exactly where the
kernel is launched, so a run can show that its main path went through the
kernel (``chip_smoke.py`` resets the counts, drives the path, and reads
them back).

While :func:`flinkml_tpu_torch.analysis._capture.capture` traces a
program, this thread's :data:`CAPTURE` flag is set and each wrapper (and
each collective of :mod:`flinkml_tpu_torch.parallel.collectives`) calls
its registered ``torch.ops.flinkml`` op instead (:func:`op`), so the
captured graph holds one node per kernel site with its arguments. Outside
a capture a wrapper reads the flag once and runs as before.
"""

from __future__ import annotations

import threading
from typing import Dict

#: The four kernel sites of the JAX package (one per hot inner loop), all
#: ported: ``spmv``, ``fused_chain``, ``segment_sum`` and ``topk``.
SITES = ("fused_chain", "segment_sum", "spmv", "topk")


class KernelUnsupportedError(ValueError):
    """A CUDA kernel cannot run this dtype/shape/chain.

    Raised INSTEAD of silently computing elsewhere: the caller handed the
    wrapper CUDA tensors, so degrading quietly would misreport what ran.
    The message names the site, the offending dtype/shape, and the
    supported set.
    """


def refuse(site: str, reason: str) -> KernelUnsupportedError:
    """The refusal for ``site``, worded like the JAX package's."""
    return KernelUnsupportedError(
        f"kernels[{site}]: the CUDA kernel cannot run here: {reason}. Move "
        "the inputs to the CPU (flinkml_tpu_torch.use_device('cpu')) to use "
        "the plain PyTorch version."
    )


class LaunchCounter:
    """Number of kernel launches made by one wrapper."""

    def __init__(self, site: str):
        if site not in SITES:
            raise ValueError(f"unknown kernel site {site!r}; known: {SITES}")
        self.site = site
        self._count = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self._count += 1

    def reset(self) -> None:
        with self._lock:
            self._count = 0

    @property
    def count(self) -> int:
        return self._count


class _Capture(threading.local):
    on = False


#: This thread's capture flag (set only by ``analysis._capture``).
CAPTURE = _Capture()


def op(name: str):
    """The registered ``torch.ops.flinkml`` op of a kernel or collective
    site (the capture registers them before it sets :data:`CAPTURE`)."""
    import torch

    return getattr(torch.ops.flinkml, name)


class not_capturing:
    """Clear this thread's capture flag for a block: the ops' real
    implementations call the wrappers under it."""

    def __enter__(self):
        self._prev = CAPTURE.on
        CAPTURE.on = False
        return self

    def __exit__(self, *exc):
        CAPTURE.on = self._prev
        return False


_COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counter(site: str) -> LaunchCounter:
    """The one counter of ``site``'s wrapper (created on first use)."""
    if site not in _COUNTERS:
        _COUNTERS[site] = LaunchCounter(site)
    return _COUNTERS[site]


def launch_counts() -> Dict[str, int]:
    """``{site: launches}`` for every wrapper that has a counter."""
    return {site: c.count for site, c in sorted(_COUNTERS.items())}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()
