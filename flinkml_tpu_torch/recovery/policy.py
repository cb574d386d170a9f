"""Recovery policy and quarantine ledger: what to DO about a bad verdict.

The port's counterpart of ``flinkml_tpu.recovery.policy``. The sentinel
(:mod:`flinkml_tpu_torch.recovery.sentinel`) turns silent numerics damage
into a typed :class:`~flinkml_tpu_torch.recovery.sentinel.NumericsError`;
this module is the decision the iteration runtime executes when one fires:

- **data-poison**: roll back to the newest VALID snapshot (the
  ``restore_latest`` walk-back, so a torn or corrupt rollback target
  falls one more snapshot back), **quarantine** the offending source
  batch by advancing the feed's watermark past it, and retry. The ledger
  rides every snapshot's ``extra`` manifest (``{"quarantine": {"ranges":
  [[start, end), ...]}}``, the JAX package's JSON), so a kill mid-recovery
  resumes with the quarantine intact, in either package;
- **systemic**: no single batch to skip: the configured action (abort by
  default, or stop-at-last-valid), also taken when the poison or retry
  budget is exhausted.

Retries back off exponentially with jitter (``retry_backoff_s``, the
shape of the rendezvous retry), and every action is counted in the
``recovery`` metrics group.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Tuple

from flinkml_tpu_torch.recovery.sentinel import DATA_POISON, SYSTEMIC

#: per-class actions a policy may configure
ACTION_ROLLBACK_QUARANTINE = "rollback_quarantine"
ACTION_ABORT = "abort"
ACTION_STOP_AT_LAST_VALID = "stop_at_last_valid"

_ACTIONS = (ACTION_ROLLBACK_QUARANTINE, ACTION_ABORT,
            ACTION_STOP_AT_LAST_VALID)


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs of the self-healing loop (see module docstring).

    Args:
        max_retries: recoveries allowed WITHOUT forward progress (a
            retry that delivers at least one new epoch past the previous
            best resets the count) before escalating to the systemic
            action — a failure that rollback-and-quarantine cannot move
            past is systemic by definition.
        backoff_s: base of the exponential retry backoff
            (``backoff_s * 2**(attempt-1)``); 0 disables sleeping
            (tests, CI soaks).
        backoff_jitter: uniform jitter fraction added to each backoff
            (``delay * U[0, jitter]``) so retrying ranks/jobs
            decorrelate instead of re-colliding in lockstep.
        max_backoff_s: cap on a single backoff sleep.
        quarantine_budget: most source batches the engine may quarantine
            in one run; exceeding it escalates to the systemic action
            (data cannot be THAT bad — something else is wrong).
        actions: per-class override of the default actions
            (``{"data_poison": ..., "systemic": ...}``).
    """

    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_jitter: float = 0.5
    max_backoff_s: float = 5.0
    quarantine_budget: int = 8
    actions: Optional[Dict[str, str]] = None

    def __post_init__(self):
        if self.max_retries < 1:
            raise ValueError(
                f"max_retries must be >= 1, got {self.max_retries}"
            )
        if self.quarantine_budget < 0:
            raise ValueError(
                "quarantine_budget must be >= 0, got "
                f"{self.quarantine_budget}"
            )
        for cls, action in (self.actions or {}).items():
            if cls not in (DATA_POISON, SYSTEMIC):
                raise ValueError(f"unknown failure class {cls!r}")
            if action not in _ACTIONS:
                raise ValueError(
                    f"unknown action {action!r} (one of {_ACTIONS})"
                )
            if cls == SYSTEMIC and action == ACTION_ROLLBACK_QUARANTINE:
                raise ValueError(
                    "systemic failures have no single batch to "
                    "quarantine; use 'abort' or 'stop_at_last_valid'"
                )

    def action_for(self, classification: str) -> str:
        defaults = {
            DATA_POISON: ACTION_ROLLBACK_QUARANTINE,
            SYSTEMIC: ACTION_ABORT,
        }
        return (self.actions or {}).get(
            classification, defaults[classification]
        )

    def backoff(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """The jittered sleep before retry ``attempt`` (1-based):
        :func:`~flinkml_tpu_torch.parallel.distributed.retry_backoff_s` (one
        shared jittered-exponential shape with the rendezvous retry),
        capped at ``max_backoff_s``."""
        if self.backoff_s <= 0:
            return 0.0
        from flinkml_tpu_torch.parallel.distributed import retry_backoff_s

        return min(
            retry_backoff_s(attempt, self.backoff_s,
                            jitter=self.backoff_jitter, rng=rng),
            self.max_backoff_s,
        )


class QuarantineLedger:
    """The set of quarantined SOURCE batch indices, as merged ranges.

    Indices count batches in the raw (pre-quarantine) feed order — the
    same numbering the ``train.step`` seam's ``source_index`` carries.
    The ledger rides snapshot manifests as ``extra["quarantine"]``
    (``{"ranges": [[start, end), ...]}``), so resume reconstructs the
    exact skip set, and :meth:`source_position` converts a
    delivered-batch watermark into the source watermark a reopened feed
    must fast-forward to (delivered batches + the quarantined batches
    interleaved below them).
    """

    def __init__(self, indices: Optional[Any] = None):
        self._indices: set = set(int(i) for i in (indices or ()))

    # -- membership ----------------------------------------------------------
    def __contains__(self, index: int) -> bool:
        return int(index) in self._indices

    def __len__(self) -> int:
        return len(self._indices)

    def __bool__(self) -> bool:
        return bool(self._indices)

    def indices(self) -> List[int]:
        return sorted(self._indices)

    def add(self, index: int) -> bool:
        """Quarantine one source batch; True when newly added."""
        index = int(index)
        if index < 0:
            raise ValueError(f"source index must be >= 0, got {index}")
        if index in self._indices:
            return False
        self._indices.add(index)
        return True

    # -- watermark arithmetic ------------------------------------------------
    def source_position(self, delivered: int) -> int:
        """The SOURCE watermark after ``delivered`` non-quarantined
        batches: delivered + every quarantined index below it (the
        batches that were read and discarded). This is what "advancing
        the cursor watermark past the quarantined range" resolves to on
        resume."""
        delivered = int(delivered)
        s = delivered
        while True:
            s2 = delivered + sum(1 for q in self._indices if q < s)
            if s2 == s:
                return s
            s = s2

    # -- ranges / JSON (the ``extra`` manifest transport) --------------------
    def ranges(self) -> List[Tuple[int, int]]:
        """Merged half-open ``[start, end)`` ranges, sorted."""
        out: List[Tuple[int, int]] = []
        for i in self.indices():
            if out and out[-1][1] == i:
                out[-1] = (out[-1][0], i + 1)
            else:
                out.append((i, i + 1))
        return out

    def to_json_dict(self) -> Dict[str, Any]:
        return {"ranges": [[s, e] for s, e in self.ranges()]}

    @staticmethod
    def from_json_dict(d: Optional[Dict[str, Any]]) -> "QuarantineLedger":
        ledger = QuarantineLedger()
        for start, end in (d or {}).get("ranges", ()):
            for i in range(int(start), int(end)):
                ledger._indices.add(i)
        return ledger

    def __repr__(self) -> str:
        return f"QuarantineLedger(ranges={self.ranges()})"
