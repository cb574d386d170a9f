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

Single process, one device. Not ported yet, each refused with
``NotImplementedError`` naming its ROADMAP.md Queue 1 item: the
preemption ``watchdog``, the numerics ``sentinel`` and the self-healing
``recovery`` with its quarantine ledger (item 12).
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


def _refuse(knob: str, item: str) -> None:
    raise NotImplementedError(
        f"{knob} is not ported to flinkml_tpu_torch yet: it comes with "
        f"ROADMAP.md Queue 1 {item}"
    )


@dataclasses.dataclass
class IterationConfig:
    """Runtime knobs. Parity: ``IterationConfig.java:22-66`` and the
    checkpoint options.

    ``stream_resume`` says how a resumed run re-aligns an iterable data
    stream: ``"replay"`` (the iterable restarts from the beginning: the
    batches the earlier run consumed are skipped, so epoch k always sees
    batch k) or ``"continue"`` (a live one-shot stream already at "now":
    consumed from the front, since skipping would drop real data).
    ``watchdog``, ``sentinel`` and ``recovery`` are refused (ROADMAP.md
    Queue 1 item 12).
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
        for knob in ("watchdog", "sentinel", "recovery"):
            if getattr(self, knob) is not None:
                _refuse(knob, "item 12 (preemption and self-healing)")


@dataclasses.dataclass
class IterationResult:
    state: Any
    epochs: int
    criteria_history: List[Optional[float]]
    outputs: List[Any]
    #: Always False here: the preemption watchdog is ROADMAP.md item 12.
    preempted: bool = False
    #: Always None here: self-healing recovery is ROADMAP.md item 12.
    recovery: Optional[dict] = None


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

StepFn = Callable[..., Tuple]
DataProvider = Union[None, Any, Callable[[int], Any], Iterable]


def _epoch_data(data: DataProvider, index: int,
                it: Optional[Iterator]) -> Tuple[Any, bool]:
    """The data of one epoch: ``(batch, exhausted)``."""
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


def _source_position(delivered: int) -> int:
    """Delivered-batch watermark -> source watermark. They are equal here:
    the JAX package's quarantine ledger, which makes them differ by the
    batches read past and never stepped, comes with ROADMAP.md Queue 1
    item 12."""
    return delivered


def _open_dataset(data: Any, start_epoch: int, config: IterationConfig):
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
    authoritative where the two disagree."""
    from flinkml_tpu_torch.data import Cursor, Dataset, ElasticFeed

    if not isinstance(data, (Dataset, ElasticFeed)):
        return None
    expected_source = _source_position(start_epoch)
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


def _snapshot_extra(dataset_iter) -> Optional[dict]:
    """The checkpoint ``extra`` payload: the input pipeline's cursor, for
    Dataset and ElasticFeed feeds."""
    if dataset_iter is None:
        return None
    return {"data_cursor": dataset_iter.cursor().to_json_dict()}


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
    scalar or None) feeds ``config.termination``; ``output`` is collected
    per epoch. With ``config.checkpoint_manager`` the carry is saved every
    ``config.checkpoint_interval`` epochs and always at the end (a finished
    run resumes as a no-op); ``resume=True`` restores ``(state, epoch)``
    from the newest valid snapshot (``restore_latest``) and continues.
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

    data_iter: Optional[Iterator] = None
    dataset_iter = None  # a tracked data/ iteration (the cursor's owner)
    if data is not None and not callable(data) and _is_stream(data):
        dataset_iter = _open_dataset(data, start_epoch, config)
        if dataset_iter is not None:
            data_iter = dataset_iter
        else:
            data_iter = iter(data)
            if config.stream_resume == "replay":
                # The iterable restarts from the beginning: skip the
                # batches the earlier run consumed (a live one-shot stream
                # must set stream_resume="continue", or real data would be
                # dropped).
                for _ in range(_source_position(start_epoch)):
                    try:
                        next(data_iter)
                    except StopIteration:
                        break

    criteria_history: List[Optional[float]] = []
    outputs: List[Any] = []
    epoch = start_epoch
    terminated = False
    # The last epoch on disk (a restored epoch is): the terminal save
    # skips a rewrite of it.
    last_saved = start_epoch if (restored and start_epoch > 0) else None
    try:
        while not terminated:
            batch, exhausted = _epoch_data(data, epoch, data_iter)
            if exhausted:
                break
            result = step_fn(state, epoch) if data is None \
                else step_fn(state, batch, epoch)
            if not isinstance(result, tuple):
                state, criteria = result, None
            elif len(result) == 2:
                state, criteria = result
            else:
                state, criteria, output = result
                outputs.append(output)
            criteria_value = None if criteria is None else float(criteria)
            criteria_history.append(criteria_value)
            state = notify_epoch_listeners(listeners, epoch, state)
            terminated = config.termination.should_terminate(epoch,
                                                             criteria_value)
            epoch += 1
            if (config.checkpoint_interval > 0 and manager is not None
                    and epoch % config.checkpoint_interval == 0):
                manager.save(state, epoch,
                             extra=_snapshot_extra(dataset_iter))
                last_saved = epoch
    finally:
        # A prefetching Dataset runs a worker thread: a raising step must
        # not strand it. close() is idempotent and keeps the cursor
        # readable for the terminal save.
        if dataset_iter is not None:
            dataset_iter.close()

    if manager is not None and last_saved != epoch:
        manager.save(state, epoch, extra=_snapshot_extra(dataset_iter))
    if manager is not None and hasattr(manager, "wait"):
        # A failed final async write surfaces here.
        manager.wait()
    for listener in listeners:
        listener.on_iteration_terminated(state)
    return IterationResult(
        state=state,
        epochs=epoch - start_epoch,
        criteria_history=criteria_history,
        outputs=outputs,
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
