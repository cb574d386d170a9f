"""Self-healing training: numerics sentinel, rollback-and-quarantine
recovery, randomized chaos soak.

The port's counterpart of ``flinkml_tpu.recovery``, composed by
:func:`flinkml_tpu_torch.iteration.iterate` (and by the online trainers'
``fit_stream``, which thread the same knobs):

- :class:`NumericsSentinel`: a finiteness and magnitude verdict on the
  device over loss and carry at every checked epoch boundary, raising a
  typed :class:`NumericsError` classified data-poison or systemic;
- :class:`RecoveryPolicy` and :class:`QuarantineLedger`: rollback to the
  newest valid snapshot, quarantine of the offending source batch
  (ledgered in the snapshot's ``extra``, so a resume honours it), retry
  with jittered backoff;
- :mod:`flinkml_tpu_torch.recovery.fuzz`: the randomized chaos soak over
  :class:`~flinkml_tpu_torch.faults.FuzzPlan` schedules, with its
  invariants and shrink-to-minimal-repro
  (``python -m flinkml_tpu_torch.recovery.fuzz --seed 7 --budget 25``).
"""

from flinkml_tpu_torch.recovery.policy import (
    ACTION_ABORT,
    ACTION_ROLLBACK_QUARANTINE,
    ACTION_STOP_AT_LAST_VALID,
    QuarantineLedger,
    RecoveryPolicy,
)
from flinkml_tpu_torch.recovery.sentinel import (
    DATA_POISON,
    SYSTEMIC,
    NonFiniteModelError,
    NumericsError,
    NumericsSentinel,
    check_stage_finite,
)

__all__ = [
    "ACTION_ABORT",
    "ACTION_ROLLBACK_QUARANTINE",
    "ACTION_STOP_AT_LAST_VALID",
    "DATA_POISON",
    "SYSTEMIC",
    "NonFiniteModelError",
    "NumericsError",
    "NumericsSentinel",
    "QuarantineLedger",
    "RecoveryPolicy",
    "check_stage_finite",
]
