"""Epoch-synchronized iteration runtime.

The port's counterpart of ``flinkml_tpu.iteration.runtime``: the
termination criteria (``TerminateOnMaxIter.java:34-56``,
``TerminateOnMaxIterOrTol.java:34-72``), the ``IterationListener``
callbacks (``IterationListener.java:49-60``), and :func:`iterate`, the
host loop around one step per epoch (``Iterations.java:118-170``):

- the loop carry ``state`` is the reference's variable stream (any tree of
  tensors, arrays and Python scalars);
- the per-epoch ``data`` provider is its replayed or unbounded data
  stream: a static value (bounded replay: every epoch sees it), a callable
  ``epoch -> batch`` (returns None to end), or an iterable of batches
  (one per epoch, the loop ends when it is exhausted);
- the step returns a criterion value that feeds the termination criterion;
- a :class:`~flinkml_tpu_torch.iteration.checkpoint.CheckpointManager`
  snapshots the carry every N epochs and always at the end, and
  ``resume=True`` continues from the newest valid snapshot;
- a :class:`~flinkml_tpu_torch.data.Dataset` or :class:`~flinkml_tpu_torch.
  data.ElasticFeed` feed is opened as a tracked iteration: its cursor
  rides every snapshot (``extra["data_cursor"]``), and a resumed run
  reopens the feed from it — at the world that wrote it or, for an
  ElasticFeed over reshardable sources, at another.

- a preemption ``watchdog`` (:class:`~flinkml_tpu_torch.utils.preemption.
  PreemptionWatchdog`, explicit or the ambient one) is polled at every
  epoch boundary: a preempted run stops there, commits one terminal
  snapshot and drains the watchdog's engines;
- a numerics ``sentinel`` checks every (due) post-step state and loss
  before the state can be checkpointed or handed to listeners, and a
  ``recovery`` policy heals its raise in the loop: rollback, quarantine
  of the offending source batch (the ledger rides every snapshot's
  ``extra["quarantine"]``, so a resumed run keeps the skips), retry;
- the fault seams ``iteration.epoch``, ``rank.lost`` and ``train.step``
  (pre and post) fire when a :mod:`flinkml_tpu_torch.faults` plan is
  armed; disarmed, each is one attribute read.

Single process, one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Termination criteria
# ---------------------------------------------------------------------------


class TerminationCriterion:
    """Decides, at the END of epoch ``epoch`` (0-based), whether to stop.

    ``criteria_value`` is whatever the step returned as its criterion (e.g.
    the epoch loss); criteria may ignore it.
    """

    def should_terminate(self, epoch: int, criteria_value: Optional[float]) -> bool:
        raise NotImplementedError


class TerminateOnMaxIter(TerminationCriterion):
    """Stop after ``max_iter`` epochs.

    Parity: ``TerminateOnMaxIter.java:34-56``.
    """

    def __init__(self, max_iter: int):
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        self.max_iter = max_iter

    def should_terminate(self, epoch: int, criteria_value: Optional[float]) -> bool:
        return epoch + 1 >= self.max_iter


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


# ---------------------------------------------------------------------------
# Listeners / config
# ---------------------------------------------------------------------------


class IterationListener:
    """Epoch-boundary callbacks, called on the host between epochs.

    :func:`iterate` and the streamed trainers call
    ``on_epoch_watermark_incremented`` after every epoch; the device-loop
    trainers (:mod:`flinkml_tpu_torch.models._linear_sgd`) at the end of
    every dispatch (every ``checkpoint_interval`` epochs with a checkpoint
    manager, else once). ``on_iteration_terminated`` follows the last.

    A listener that must see a fully computed state (one that persists or
    publishes it) sets ``needs_materialized_state = True``: the runtime
    then waits for the device before the callbacks, on the epochs where
    ``wants_epoch_state(epoch)`` is true.
    """

    needs_materialized_state = False

    def wants_epoch_state(self, epoch: int) -> bool:
        return True

    def on_epoch_watermark_incremented(self, epoch: int, state: Any) -> None:
        ...

    def on_iteration_terminated(self, state: Any) -> None:
        ...


def notify_epoch_listeners(
    listeners: Sequence[IterationListener], epoch: int, state: Any
) -> Any:
    """Fire ``on_epoch_watermark_incremented`` on every listener, first
    waiting for the device once if any listener declares
    ``needs_materialized_state`` and acts at this epoch. Returns ``state``
    (shared by :func:`iterate` and the streamed trainers' epoch loops)."""
    if listeners and any(
        getattr(lst, "needs_materialized_state", False)
        and getattr(lst, "wants_epoch_state", lambda e: True)(epoch)
        for lst in listeners
    ) and torch.cuda.is_available():
        torch.cuda.synchronize()
    for listener in listeners:
        listener.on_epoch_watermark_incremented(epoch, state)
    return state


class ForwardInputsOfLastRound(IterationListener):
    """Capture only the final round's value; ``value`` is valid once
    ``on_iteration_terminated`` has fired (``terminated`` is True).

    Parity: ``ForwardInputsOfLastRound.java:34-60``. ``extract`` maps the
    loop state to the value to forward (default: identity).
    """

    def __init__(self, extract: Optional[Callable[[Any], Any]] = None):
        self._extract = extract if extract is not None else (lambda s: s)
        self.value: Any = None
        self.terminated = False

    def on_iteration_terminated(self, state: Any) -> None:
        self.value = self._extract(state)
        self.terminated = True


@dataclasses.dataclass
class IterationConfig:
    """Runtime knobs. Parity: ``IterationConfig.java:22-66`` and the
    checkpoint options.

    ``stream_resume`` says how a resumed run re-aligns an iterable data
    stream: ``"replay"`` (the iterable restarts from the beginning: the
    batches the earlier run consumed are skipped, so epoch k always sees
    batch k) or ``"continue"`` (a live one-shot stream already at "now":
    consumed from the front, since skipping would drop real data).
    ``watchdog``: a preemption watchdog polled at every epoch boundary
    (None: the ambient one, ``utils.preemption.active()``). ``sentinel``:
    a :class:`~flinkml_tpu_torch.recovery.NumericsSentinel` run on every
    post-step state and loss before the state is checkpointed or handed to
    listeners. ``recovery``: a :class:`~flinkml_tpu_torch.recovery.
    RecoveryPolicy` that heals the sentinel's raise in the loop (it
    implies a default sentinel when ``sentinel`` is unset).
    """

    termination: TerminationCriterion = dataclasses.field(
        default_factory=lambda: TerminateOnMaxIter(20)
    )
    checkpoint_interval: int = 0
    checkpoint_manager: Optional[Any] = None
    stream_resume: str = "replay"
    watchdog: Optional[Any] = None
    sentinel: Optional[Any] = None
    recovery: Optional[Any] = None

    def __post_init__(self):
        if self.stream_resume not in ("replay", "continue"):
            raise ValueError(
                "stream_resume must be 'replay' or 'continue', "
                f"got {self.stream_resume!r}"
            )


@dataclasses.dataclass
class IterationResult:
    state: Any
    epochs: int
    criteria_history: List[Optional[float]]
    outputs: List[Any]
    #: True when a preemption watchdog stopped the loop early; the final
    #: state was checkpointed (manager permitting) and resumes cleanly.
    preempted: bool = False
    #: The recovery session's summary when ``IterationConfig.recovery`` is
    #: set (``rollbacks``, ``retries``, ``quarantined``,
    #: ``quarantine_ranges``, ``stopped_early``); None otherwise.
    recovery: Optional[dict] = None


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

StepFn = Callable[..., Tuple]
DataProvider = Union[None, Any, Callable[[int], Any], Iterable]


def _epoch_data(data: DataProvider, index: int,
                it: Optional[Iterator]) -> Tuple[Any, bool]:
    """The data of one epoch: ``(batch, exhausted)``. ``index`` is the
    SOURCE batch index for a callable provider (the epoch until a
    quarantine skips a batch)."""
    if data is None:
        return None, False
    if callable(data):
        batch = data(index)
        return batch, batch is None
    if it is not None:
        try:
            return next(it), False
        except StopIteration:
            return None, True
    return data, False  # static value: bounded replay


def _is_stream(data: Any) -> bool:
    """True for per-epoch batch streams (lists, iterators, generators and
    other iterables); dicts, tuples, strings, arrays and tensors are
    static values replayed every epoch."""
    if isinstance(data, (list, Iterator)):
        return True
    return hasattr(data, "__iter__") and not isinstance(
        data, (dict, tuple, str, bytes, np.ndarray, torch.Tensor)
    ) and not hasattr(data, "shape")


def _source_position(delivered: int, ledger=None) -> int:
    """Delivered-batch watermark -> source watermark: the quarantined
    batches below it were read and discarded, so the feed fast-forwards
    past them too."""
    if ledger is None:
        return delivered
    return ledger.source_position(delivered)


def _feed_replayable(data: DataProvider, config: IterationConfig) -> bool:
    """Whether a rollback can re-position this feed: Datasets and
    ElasticFeeds replay from their cursor, lists and callables by index; a
    live one-shot iterator (or ``stream_resume="continue"``) cannot be
    rewound."""
    from flinkml_tpu_torch.data import Dataset, ElasticFeed

    if data is None or callable(data) or not _is_stream(data):
        return True
    if isinstance(data, (Dataset, ElasticFeed)):
        return True
    return isinstance(data, list) and config.stream_resume == "replay"


def _open_dataset(data: Any, start_epoch: int, config: IterationConfig,
                  ledger=None):
    """A tracked iteration of ``data`` positioned at ``start_epoch`` when
    ``data`` is a :class:`~flinkml_tpu_torch.data.Dataset` or an
    :class:`~flinkml_tpu_torch.data.ElasticFeed` (None for any other feed,
    which the caller iterates plainly).

    A Dataset is restartable and deterministic, so its resume is always
    the ``"replay"`` contract whatever ``stream_resume`` says: the chain
    fast-forwards to the watermark and the consumer sees the exact
    uninterrupted sequence, shuffle order included. The restored
    snapshot's cursor (``extra["data_cursor"]``) seeds the reopen — an
    ElasticFeed's cursor records the world that wrote it, so a run resumed
    at another world re-splits the feed; the restored epoch stays
    authoritative where the two disagree. ``ledger`` turns the delivered
    epoch into the SOURCE watermark (delivered batches plus the
    quarantined ones below them, which the cursor counts too)."""
    from flinkml_tpu_torch.data import Cursor, Dataset, ElasticFeed

    if not isinstance(data, (Dataset, ElasticFeed)):
        return None
    expected_source = _source_position(start_epoch, ledger)
    cursor = None
    if start_epoch > 0:
        extra = getattr(
            config.checkpoint_manager, "last_restored_extra", None
        ) or {}
        recorded = extra.get("data_cursor")
        if recorded is not None:
            cursor = Cursor.from_json_dict(recorded)
            if cursor.emitted != expected_source:
                # Shift the recorded global watermark by the same number of
                # lockstep rounds (one batch per shard per round; a
                # global-order cursor advances one batch per round).
                watermark = cursor.global_watermark
                if watermark is not None:
                    per_round = (cursor.num_shards
                                 if cursor.shard_index is not None
                                 and cursor.num_shards is not None else 1)
                    watermark += (expected_source - cursor.emitted) * per_round
                cursor = dataclasses.replace(
                    cursor, emitted=expected_source,
                    global_watermark=watermark,
                )
        else:
            cursor = Cursor(emitted=expected_source)
    return data.iterate(cursor)


def _snapshot_extra(dataset_iter, ledger=None) -> Optional[dict]:
    """The checkpoint ``extra`` payload: the input pipeline's cursor (for
    Dataset and ElasticFeed feeds) and the quarantine ledger (when a batch
    is quarantined), the two records a resumed run needs."""
    extra: dict = {}
    if dataset_iter is not None:
        extra["data_cursor"] = dataset_iter.cursor().to_json_dict()
    if ledger:
        extra["quarantine"] = ledger.to_json_dict()
    return extra or None


def iterate(
    step_fn: StepFn,
    init_state: Any,
    data: DataProvider = None,
    config: Optional[IterationConfig] = None,
    listeners: Sequence[IterationListener] = (),
    resume: bool = False,
) -> IterationResult:
    """Run an epoch-synchronized iteration to termination.

    Parity: ``Iterations.iterateBoundedStreamsUntilTermination`` /
    ``iterateUnboundedStreams`` (``Iterations.java:118-170``).

    ``step_fn(state, epoch_data, epoch) -> (new_state, criteria)`` or ``->
    (new_state, criteria, output)`` (``epoch_data`` is left out when
    ``data`` is None; a bare state means no criterion). ``criteria`` (a
    scalar, a 0-d tensor or None) feeds ``config.termination``; ``output``
    is collected per epoch. With ``config.checkpoint_manager`` the carry
    is saved every ``config.checkpoint_interval`` epochs and always at the
    end (a finished or preempted run resumes as a no-op); ``resume=True``
    restores ``(state, epoch)`` from the newest valid snapshot
    (``restore_latest``), with its quarantine ledger, and continues. With
    ``config.recovery`` a sentinel raise is healed in the loop; on a retry
    the returned ``criteria_history``/``outputs``/``epochs`` cover the
    final attempt only and ``IterationResult.recovery`` holds the session
    summary.
    """
    config = config or IterationConfig()
    state = init_state
    start_epoch = 0
    restored = False
    manager = config.checkpoint_manager
    if resume:
        if manager is None:
            raise ValueError("resume=True requires config.checkpoint_manager")
        r = manager.restore_latest(like=init_state)
        if r is not None:
            state, start_epoch = r
            restored = True

    # The quarantine ledger: honoured whenever the restored snapshot
    # recorded one (a resumed self-healed run keeps its skips without a
    # policy); owned and extended by the recovery session.
    from flinkml_tpu_torch.recovery.policy import QuarantineLedger

    ledger = None
    if restored:
        recorded_q = (
            getattr(manager, "last_restored_extra", None) or {}
        ).get("quarantine")
        if recorded_q:
            ledger = QuarantineLedger.from_json_dict(recorded_q)

    sentinel = config.sentinel
    session = None
    if config.recovery is not None:
        from flinkml_tpu_torch.recovery.engine import RecoverySession
        from flinkml_tpu_torch.recovery.sentinel import NumericsSentinel

        if sentinel is None:
            sentinel = NumericsSentinel()
        if ledger is None:
            ledger = QuarantineLedger()
        session = RecoverySession(
            config.recovery, manager, sentinel, ledger, init_state,
            replayable=_feed_replayable(data, config),
            initially_restored=restored,
        )

    initial_epoch = start_epoch
    while True:
        try:
            result = _run_attempt(
                step_fn, state, data, config, listeners, start_epoch,
                restored, sentinel, ledger, session,
            )
            if session is not None:
                result.recovery = session.summary()
            return result
        except RuntimeError as err:
            from flinkml_tpu_torch.recovery.sentinel import NumericsError

            if session is None or not isinstance(err, NumericsError):
                raise
            verb, state, start_epoch, restored = session.handle(err)
            if verb == "stop":
                # stop_at_last_valid: the newest valid model is already on
                # disk, so there is no terminal rewrite.
                for listener in listeners:
                    listener.on_iteration_terminated(state)
                return IterationResult(
                    state=state,
                    epochs=max(0, start_epoch - initial_epoch),
                    criteria_history=[],
                    outputs=[],
                    preempted=False,
                    recovery=session.summary(),
                )


def _run_attempt(step_fn: StepFn, state: Any, data: DataProvider,
                 config: IterationConfig,
                 listeners: Sequence[IterationListener], start_epoch: int,
                 restored: bool, sentinel, ledger,
                 session=None) -> IterationResult:
    """One pass of the epoch loop from ``start_epoch`` (the whole run when
    no recovery retry intervenes). ``ledger`` batches are read past and
    never stepped; a ``sentinel`` verdict raises before the state can be
    checkpointed or handed to listeners."""
    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
    from flinkml_tpu_torch.utils import preemption

    manager = config.checkpoint_manager
    source_skip = _source_position(start_epoch, ledger)
    data_iter: Optional[Iterator] = None
    dataset_iter = None  # a tracked data/ iteration (the cursor's owner)
    # The SOURCE index of the next batch to pull (None: no positional
    # stream — a static value, None, or a live "continue" stream — where
    # quarantine does not apply).
    src_index: Optional[int] = None
    if data is not None and not callable(data) and _is_stream(data):
        dataset_iter = _open_dataset(data, start_epoch, config, ledger)
        if dataset_iter is not None:
            data_iter = dataset_iter
            src_index = source_skip
        else:
            data_iter = iter(data)
            if config.stream_resume == "replay":
                # The iterable restarts from the beginning: skip the
                # batches the earlier run consumed, quarantined ones
                # included (a live one-shot stream must set
                # stream_resume="continue", or real data would be dropped).
                for _ in range(source_skip):
                    try:
                        next(data_iter)
                    except StopIteration:
                        break
                src_index = source_skip
    elif callable(data):
        src_index = source_skip

    criteria_history: List[Optional[float]] = []
    outputs: List[Any] = []
    epoch = start_epoch
    terminated = False
    preempted = False
    # The last epoch on disk (a restored epoch is): the terminal save
    # skips a rewrite of it.
    last_saved = start_epoch if (restored and start_epoch > 0) else None
    watchdog = (config.watchdog if config.watchdog is not None
                else preemption.active())
    # A criterion-less step never reads the device; the guard bounds the
    # work in flight in a group of several ranks (a no-op in one process).
    guard = DispatchGuard()
    try:
        while not terminated:
            if faults.ACTIVE is not None:
                faults.fire("iteration.epoch", epoch=epoch)
                # A scripted RankLost: with the watchdog in the context it
                # becomes a clean preemption stop, without one a crash.
                faults.fire("rank.lost", epoch=epoch, watchdog=watchdog)
            if watchdog is not None and watchdog.requested:
                preempted = True
                break
            if src_index is None:
                batch, exhausted = _epoch_data(data, epoch, data_iter)
                idx = None
            else:
                while True:
                    batch, exhausted = _epoch_data(data, src_index, data_iter)
                    if exhausted:
                        idx = None
                        break
                    idx, src_index = src_index, src_index + 1
                    if ledger is None or idx not in ledger:
                        break
                    # A quarantined source batch: read past (the cursor
                    # counts it), never stepped, never an epoch.
            if exhausted:
                break

            if faults.ACTIVE is not None and data is not None:
                fctx = {"phase": "pre", "epoch": epoch,
                        "source_index": idx, "batch": batch}
                faults.fire_into("train.step", fctx)
                batch = fctx["batch"]
            result = step_fn(state, epoch) if data is None \
                else step_fn(state, batch, epoch)
            if not isinstance(result, tuple):
                state, criteria = result, None
            elif len(result) == 2:
                state, criteria = result
            else:
                state, criteria, output = result
                outputs.append(output)
            if faults.ACTIVE is not None:
                fctx = {"phase": "post", "epoch": epoch,
                        "source_index": idx, "state": state,
                        "criteria": criteria}
                faults.fire_into("train.step", fctx)
                state, criteria = fctx["state"], fctx["criteria"]

            if sentinel is not None:
                # The verdict, before the state can be checkpointed or
                # published; a tensor loss is read with the verdict.
                criteria_value = sentinel.check(state, criteria, epoch=epoch,
                                                source_index=idx)
            else:
                criteria_value = None if criteria is None else float(criteria)
            if criteria_value is None:
                guard.after_dispatch(state)
            criteria_history.append(criteria_value)
            state = notify_epoch_listeners(listeners, epoch, state)
            terminated = config.termination.should_terminate(epoch,
                                                             criteria_value)
            epoch += 1
            if (config.checkpoint_interval > 0 and manager is not None
                    and epoch % config.checkpoint_interval == 0):
                manager.save(state, epoch,
                             extra=_snapshot_extra(dataset_iter, ledger))
                last_saved = epoch
                if session is not None:
                    # This run's commit: a legitimate rollback target.
                    session.note_saved(epoch)
    finally:
        # A prefetching Dataset runs a worker thread: a raising step must
        # not strand it. close() is idempotent and keeps the cursor
        # readable for the terminal save.
        if dataset_iter is not None:
            dataset_iter.close()

    guard.flush(state)
    if manager is not None and last_saved != epoch:
        # The terminal snapshot: at termination, stream exhaustion or
        # preemption, whatever the interval.
        manager.save(state, epoch, extra=_snapshot_extra(dataset_iter, ledger))
    if manager is not None and hasattr(manager, "wait"):
        # A failed final async write surfaces here.
        manager.wait()
    for listener in listeners:
        listener.on_iteration_terminated(state)
    if preempted and watchdog is not None:
        # Only once the final snapshot is durable: drain the engines.
        watchdog.finalize()
    return IterationResult(
        state=state,
        epochs=epoch - start_epoch,
        criteria_history=criteria_history,
        outputs=outputs,
        preempted=preempted,
    )


class Iterations:
    """Namespace matching the reference's entry points
    (``Iterations.java:118-170``)."""

    @staticmethod
    def iterate_bounded_streams_until_termination(
        step_fn: StepFn,
        init_state: Any,
        replayed_data: Any = None,
        config: Optional[IterationConfig] = None,
        listeners: Sequence[IterationListener] = (),
    ) -> IterationResult:
        """Bounded mode: ``replayed_data`` is re-presented every epoch."""
        return iterate(step_fn, init_state, replayed_data, config, listeners)

    @staticmethod
    def iterate_unbounded_streams(
        step_fn: StepFn,
        init_state: Any,
        stream: Iterable,
        config: Optional[IterationConfig] = None,
        listeners: Sequence[IterationListener] = (),
    ) -> IterationResult:
        """Unbounded/online mode: one batch per epoch until exhausted."""
        return iterate(step_fn, init_state, iter(stream), config, listeners)
