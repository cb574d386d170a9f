"""The iteration runtime's termination criteria and listeners
(:mod:`flinkml_tpu_torch.iteration.runtime`)."""

from flinkml_tpu_torch.iteration.runtime import (  # noqa: F401
    IterationListener,
    TerminateOnMaxIterOrTol,
    TerminationCriterion,
)

__all__ = ["IterationListener", "TerminateOnMaxIterOrTol", "TerminationCriterion"]
