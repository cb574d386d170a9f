"""Termination criteria and epoch listeners of the iteration runtime.

The port's counterpart of the parts of ``flinkml_tpu.iteration.runtime``
that the device-loop trainers and their callers use: the
``TerminateOnMaxIterOrTol`` criterion (reference:
``TerminateOnMaxIterOrTol.java:34-72``) and the ``IterationListener``
callbacks (``IterationListener.java:49-60``). The host-driven ``iterate``
loop comes with a later slice (ROADMAP.md Queue 1 item 15).
"""

from __future__ import annotations

from typing import Any, Optional


class TerminationCriterion:
    """Decides, at the END of epoch ``epoch`` (0-based), whether to stop.

    ``criteria_value`` is whatever the step returned as its criterion (e.g.
    the epoch loss); criteria may ignore it.
    """

    def should_terminate(self, epoch: int, criteria_value: Optional[float]) -> bool:
        raise NotImplementedError


class TerminateOnMaxIterOrTol(TerminationCriterion):
    """Stop after ``max_iter`` epochs or when the criterion drops below tol.

    Parity: ``TerminateOnMaxIterOrTol.java:34-72``.
    """

    def __init__(self, max_iter: int, tol: float):
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        self.max_iter = max_iter
        self.tol = float(tol)

    def should_terminate(self, epoch: int, criteria_value: Optional[float]) -> bool:
        if epoch + 1 >= self.max_iter:
            return True
        if criteria_value is None:
            return False
        return float(criteria_value) <= self.tol


class IterationListener:
    """Epoch-boundary callbacks, called on the host. The device-loop
    trainers call them once, when the loop ends: with the last epoch run
    and the final state, then ``on_iteration_terminated``."""

    def on_epoch_watermark_incremented(self, epoch: int, state: Any) -> None:
        ...

    def on_iteration_terminated(self, state: Any) -> None:
        ...
