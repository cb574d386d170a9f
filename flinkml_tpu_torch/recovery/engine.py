"""The recovery session: executes a :class:`RecoveryPolicy` inside
:func:`flinkml_tpu_torch.iteration.iterate`.

The port's counterpart of ``flinkml_tpu.recovery.engine``. One session
lives for one ``iterate`` call. When the sentinel raises, the runtime
hands the :class:`~flinkml_tpu_torch.recovery.NumericsError` to
:meth:`RecoverySession.handle`, which either

- returns ``("retry", state, start_epoch, restored)``: the loop rolled
  back (the newest valid AND finite snapshot this run may restore, else
  the pristine initial carry), the offending batch is in the quarantine
  ledger, the jittered backoff has been slept; re-enter the epoch loop;
- returns ``("stop", state, start_epoch, restored)``: the policy's
  ``stop_at_last_valid`` action;
- raises: the abort action, a systemic failure, or an exhausted budget,
  with the escalation reason in the message.

The initial carry is copied once when the session opens: tensors are
cloned on their own device, numpy arrays copied, so a step that updates
its carry in place (``add_``, ``index_add_``) cannot reach the copy, and
every rollback hands out a fresh clone of it. A restored snapshot's
leaves are placed like the initial carry's (a tensor leaf comes back as a
tensor on that leaf's device and in its dtype).

Every action is recorded in the ``recovery`` metrics group
(``rollbacks_total``, ``quarantined_batches``, per-class
``retries_total``, ``time_to_recover_p50_ms``/``p99_ms``).
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.recovery.policy import (
    ACTION_ABORT,
    ACTION_ROLLBACK_QUARANTINE,
    QuarantineLedger,
    RecoveryPolicy,
)
from flinkml_tpu_torch.recovery.sentinel import (
    DATA_POISON,
    SYSTEMIC,
    NumericsError,
    NumericsSentinel,
    _float_leaves,
)
from flinkml_tpu_torch.utils.logging import get_logger

_log = get_logger("recovery")


def _copy_state(state: Any) -> Any:
    """A copy of a state tree whose array leaves are owned: tensors cloned
    on their device, numpy arrays copied, other leaves as they are."""
    from flinkml_tpu_torch.faults import _map_tree

    def one(leaf):
        if torch.is_tensor(leaf):
            return leaf.detach().clone()
        if isinstance(leaf, np.ndarray) or hasattr(leaf, "dtype"):
            return np.array(leaf)
        return leaf

    return _map_tree(state, one)


def _placed_like(state: Any, like: Any) -> Any:
    """A restored (host) state with every leaf whose counterpart in
    ``like`` is a tensor moved onto that tensor's device and dtype."""
    from flinkml_tpu_torch.iteration.checkpoint import (
        tree_flatten,
        tree_unflatten,
    )

    leaves = tree_flatten(state)[0]
    templates = tree_flatten(like)[0]
    placed = []
    for leaf, tmpl in zip(leaves, templates):
        if torch.is_tensor(tmpl) and not torch.is_tensor(leaf):
            arr = np.asarray(leaf)
            if not arr.flags.writeable:
                arr = np.array(arr)
            leaf = torch.as_tensor(arr).to(device=tmpl.device,
                                           dtype=tmpl.dtype)
        placed.append(leaf)
    return tree_unflatten(state, placed)


class RecoverySession:
    """See module docstring. Created by ``iterate`` when
    ``IterationConfig.recovery`` is set; not a user-facing entry point
    (configure a :class:`RecoveryPolicy` instead)."""

    def __init__(self, policy: RecoveryPolicy, manager: Any,
                 sentinel: NumericsSentinel, ledger: QuarantineLedger,
                 init_state: Any, replayable: bool,
                 initially_restored: bool = False):
        self.policy = policy
        self.manager = manager
        self.sentinel = sentinel
        self.ledger = ledger
        self.replayable = bool(replayable)
        # Deep copy (containers AND leaves): step functions may mutate
        # the carry — or its arrays — in place, so a rollback-to-fresh
        # must hand back pristine values, not the caller's (already
        # poisoned) buffers.
        self._init_copy = _copy_state(init_state)
        # Rollback may only restore snapshots that belong to THIS run's
        # lineage: everything on disk when the run RESUMED, but nothing
        # pre-existing when it started fresh (resume=False over a dirty
        # directory must never silently resurrect a previous run's
        # model). Epochs this run commits are eligible as they land
        # (note_saved).
        self._alien_epochs = (
            set() if initially_restored or manager is None
            else set(manager.all_epochs())
        )
        self._rng = random.Random()
        self._furthest = -1
        self._no_progress = 0
        self._pinpointing = False  # last handle() started a pinpoint run
        self.rollbacks = 0
        self.retries: Dict[str, int] = {}
        self._recover_ms: List[float] = []
        self.stopped_early = False

    def note_saved(self, epoch: int) -> None:
        """The runtime committed a snapshot at ``epoch`` during this
        run — it (and any pre-existing directory it overwrote) is now a
        legitimate rollback target."""
        self._alien_epochs.discard(int(epoch))

    # -- bookkeeping ---------------------------------------------------------
    def _metrics_group(self, labels: Optional[Dict[str, str]] = None):
        from flinkml_tpu_torch.utils.metrics import metrics

        return metrics.group("recovery", labels=labels)

    def _record_recovery(self, classification: str, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1000.0
        self._recover_ms.append(ms)
        self.retries[classification] = (
            self.retries.get(classification, 0) + 1
        )
        g = self._metrics_group()
        g.counter("rollbacks_total")
        g.record("time_to_recover_ms", ms)
        g.gauge("time_to_recover_p50_ms",
                float(np.percentile(self._recover_ms, 50)))
        g.gauge("time_to_recover_p99_ms",
                float(np.percentile(self._recover_ms, 99)))
        self._metrics_group({"class": classification}).counter(
            "retries_total"
        )

    def summary(self) -> Dict[str, Any]:
        """The per-run recovery record attached to
        :class:`~flinkml_tpu_torch.iteration.IterationResult.recovery`."""
        return {
            "rollbacks": self.rollbacks,
            "retries": dict(self.retries),
            "quarantined": self.ledger.indices(),
            "quarantine_ranges": self.ledger.ranges(),
            "stopped_early": self.stopped_early,
        }

    # -- the decision --------------------------------------------------------
    def _escalation_reason(self, err: NumericsError) -> Optional[str]:
        """Why a data-poison verdict must be handled as systemic (None
        when the poison path applies)."""
        if self._no_progress > self.policy.max_retries:
            return (f"no forward progress after {self._no_progress - 1} "
                    "consecutive recoveries")
        if not self.replayable:
            # Checked BEFORE the pinpoint branch: a pinpoint retry
            # re-opens the feed exactly like a quarantine retry does —
            # re-iterating a live one-shot stream would silently train
            # on a truncated tail.
            return ("the offending batch cannot be quarantined (feed is "
                    "not replayable)")
        if not err.exact:
            return None  # pinpoint retry — allowed
        if err.source_index is None:
            return ("the offending batch cannot be quarantined (the "
                    "failing step consumed no stream batch)")
        if (len(self.ledger) >= self.policy.quarantine_budget
                and err.source_index not in self.ledger):
            return (f"quarantine budget "
                    f"({self.policy.quarantine_budget}) exhausted")
        return None

    def handle(self, err: NumericsError
               ) -> Tuple[str, Any, int, bool]:
        t0 = time.perf_counter()
        prog = err.source_index if err.source_index is not None else err.epoch
        # Forward progress = any of: a failure PAST the furthest point
        # seen; a pinpoint re-run's exact re-detection (necessarily at
        # or below the inexact verdict's watermark, but localizing the
        # bad batch IS progress — the quarantine follows); an exact
        # verdict on a batch not yet in the ledger (a SECOND poison
        # inside the same interval window lands below the watermark
        # too, yet each new quarantine moves the run forward — the
        # quarantine_budget bounds this axis, not the retry count).
        pinpoint_followup = self._pinpointing and err.exact
        self._pinpointing = False
        new_quarantine = (
            err.exact and err.source_index is not None
            and err.source_index not in self.ledger
        )
        if prog > self._furthest or pinpoint_followup or new_quarantine:
            self._furthest = max(self._furthest, prog)
            self._no_progress = 1
        else:
            self._no_progress += 1

        classification = err.classification
        action = self.policy.action_for(classification)
        reason = None
        if classification == DATA_POISON \
                and action == ACTION_ROLLBACK_QUARANTINE:
            # The healing path still escalates when it cannot make
            # progress; a data_poison action the user configured as
            # abort/stop runs directly below (no quarantine).
            reason = self._escalation_reason(err)
            if reason is not None:
                classification = SYSTEMIC
                action = self.policy.action_for(SYSTEMIC)
        if action != ACTION_ROLLBACK_QUARANTINE:
            detail = f" ({reason})" if reason else ""
            if action == ACTION_ABORT:
                _log.error("recovery aborting at epoch %d: %s%s",
                           err.epoch, err, detail)
                self._metrics_group({"class": classification}).counter(
                    "aborts_total"
                )
                raise NumericsError(
                    f"unrecoverable: {err}{detail}",
                    classification=classification, epoch=err.epoch,
                    source_index=err.source_index, verdict=err.verdict,
                ) from err
            # stop_at_last_valid
            state, epoch, restored = self._rollback()
            self.stopped_early = True
            self._record_recovery(classification, t0)
            _log.warning(
                "recovery stopping at last valid snapshot (epoch %d) "
                "after %s%s", epoch, err, detail,
            )
            return ("stop", state, epoch, restored)

        # -- data-poison heal: rollback (+ quarantine when the batch is
        # known exactly; pinpoint re-run otherwise) -------------------------
        if not err.exact:
            self.sentinel.begin_pinpoint(err.epoch)
            self._pinpointing = True
            _log.warning(
                "inexact poison verdict at epoch %d (interval-checked): "
                "rolling back to pinpoint the offending batch",
                err.epoch,
            )
        else:
            if self.ledger.add(err.source_index):
                self._metrics_group().counter("quarantined_batches")
                _log.warning(
                    "quarantined source batch %d (epoch %d): %s — "
                    "ledger now %s", err.source_index, err.epoch, err,
                    self.ledger.ranges(),
                )
        state, epoch, restored = self._rollback()
        self.sentinel.reset_streak()
        delay = self.policy.backoff(self._no_progress, self._rng)
        if delay > 0:
            time.sleep(delay)
        self._record_recovery(DATA_POISON, t0)
        _log.warning(
            "recovery retry: rolled back to epoch %d (backoff %.3fs, "
            "%d rollback(s) so far)", epoch, delay, self.rollbacks,
        )
        return ("retry", state, epoch, restored)

    def _rollback(self) -> Tuple[Any, int, bool]:
        """Newest valid AND FINITE snapshot, walking back past torn and
        corrupt ones (the ``restore_latest`` ladder) and ALSO past
        snapshots holding a non-finite carry — an interval-checked
        sentinel can let a poisoned state reach a commit between checks,
        and restoring it would quarantine innocent batches forever.
        Falls back to a pristine fresh start when no snapshot survives;
        either way the rollback is LOGGED and counted — never a silent
        fresh start."""
        self.rollbacks += 1
        if self.manager is not None:
            restored = self._restore_newest_finite()
            if restored is not None:
                return restored[0], int(restored[1]), True
        _log.warning(
            "rollback found no committed finite snapshot: restarting "
            "from the initial state (epoch 0) with the quarantine "
            "ledger applied"
        )
        # Fresh deep copy per rollback: a retry's in-place mutations
        # must not reach the template either.
        return _copy_state(self._init_copy), 0, False

    def _restore_newest_finite(self) -> Optional[Tuple[Any, int]]:
        from flinkml_tpu_torch.iteration.checkpoint import (
            CheckpointIntegrityError,
        )

        for epoch in reversed(self.manager.all_epochs()):
            if epoch in self._alien_epochs:
                # A pre-existing snapshot of a previous run over the
                # same directory (this run started resume=False):
                # restoring it would silently resurrect the OLD model.
                _log.warning(
                    "rollback: skipping pre-existing snapshot epoch %s "
                    "(not part of this run — it started fresh)", epoch,
                )
                continue
            try:
                state, ep = self.manager.restore(epoch,
                                                 like=self._init_copy)
            except CheckpointIntegrityError as e:
                _log.warning(
                    "rollback: snapshot epoch %s failed verification "
                    "(%s); walking back", epoch, e,
                )
                continue
            if all(np.isfinite(leaf).all()
                   for leaf in _float_leaves(state)):
                return _placed_like(state, self._init_copy), ep
            _log.warning(
                "rollback: snapshot epoch %s restored a NON-FINITE "
                "carry (committed inside a sentinel interval window); "
                "discarding it and walking back", epoch,
            )
            # Left on disk it is a time bomb: a kill before the retry
            # overwrites this epoch would hand the poisoned carry to
            # the resumed run's finiteness-UNAWARE restore_latest,
            # which then quarantines whatever batch happens to be
            # current. This run committed it, so this run removes it.
            self.manager.discard(epoch)
        return None
