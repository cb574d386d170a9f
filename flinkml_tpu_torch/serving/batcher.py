"""Micro-batching: coalesce concurrent requests into shape buckets.

The fused pipeline executor (:mod:`flinkml_tpu_torch.pipeline_fusion`) compiles
one program per power-of-two row bucket and serves any row count within a
bucket with no new program — so the *only* cost of batching requests
together is padding waste inside the bucket, and the only cost of not
batching is per-dispatch overhead. Two policies share that structure:

:class:`AdaptiveMicroBatcher` (the FIFO policy, in the adaptive-batching
tradition of Clipper, Crankshaw et al., NSDI'17) packs whole requests
FIFO:

  - a request that arrives alone waits at most ``max_wait_s`` for company
    (the latency the operator is willing to trade for occupancy);
  - the window closes EARLY the moment the queued rows exactly fill their
    power-of-two bucket (occupancy 1.0 — waiting longer buys nothing the
    compile cache doesn't already give a later batch) or reach
    ``max_batch_rows``;
  - requests are never split, so a request too large for the batch's
    remaining capacity blocks everything behind it (head-of-line).

:class:`ContinuousBatcher` (the Orca-style policy, Yu et al., OSDI'22,
specialized to bucketed row batching) splits requests at bucket
boundaries instead:

  - a late arrival joins the **currently forming bucket**: when queued
    rows reach the bucket the window opened on, the window closes and
    exactly that bucket dispatches (occupancy 1.0), the straddling
    request contributing only its head rows;
  - the tail rows stay at the FRONT of the queue and ride the next
    dispatch — no request ever waits behind a batch it could have
    partially joined, which is what deletes the FIFO policy's
    head-of-line latency under load;
  - per-request row reassembly lives in :class:`ServingRequest`
    (:meth:`ServingRequest.add_segment`): responses are stitched back in
    row order, and a request whose segments were served by different
    model versions is re-dispatched whole so the version-tagging
    contract (one response == one version, bitwise-equal to that
    version's transform) survives splitting.

Both policies share bounded admission: past ``max_queue_rows`` queued
rows, :meth:`offer` refuses and the engine sheds or rejects — queueing
theory does the rest of the argument (an unbounded queue under
saturation has unbounded latency). Deadlines are swept **promptly**: the
consumer wakes at the earliest queued deadline and fails overdue
requests the moment it passes, instead of letting them ride out the
max-wait window (a never-filling queue used to hold an expired request
for the whole window). A consumer that wakes later than the 5 ms margin
still dispatches the one request whose deadline closed the window,
after that deadline (the JAX package's batcher expires it).

Thread-safe; one consumer (the engine's dispatcher thread, blocking in
:meth:`next_batch`, or the CPU host polling :meth:`poll`: one window rule
for both) and any number of producers.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.pipeline_fusion import row_bucket
from flinkml_tpu_torch.serving.errors import EngineStoppedError


@dataclasses.dataclass(eq=False)  # identity equality: queues remove by
class ServingRequest:             # object, and columns hold numpy arrays
    """One in-flight ``predict`` call: host input columns plus a
    completion event the calling thread waits on. Under continuous
    batching a request may be served in several row SEGMENTS; the
    dispatcher feeds them to :meth:`add_segment` and the request
    reassembles its response in row order."""

    columns: Dict[str, np.ndarray]
    rows: int
    enqueued_at: float
    deadline: Optional[float] = None  # absolute, time.monotonic() clock
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[Dict[str, np.ndarray]] = None
    error: Optional[BaseException] = None
    version: Optional[int] = None
    shed: bool = False
    #: Rows the batcher has handed out in segments (queue-side cursor;
    #: only the consumer thread advances it, under the batcher's lock).
    dispatched_rows: int = 0
    #: Completed ``(start, columns, version, rows)`` segments awaiting
    #: reassembly. Only the dispatcher thread touches this.
    segments: List[Tuple[int, Dict[str, np.ndarray], Optional[int], int]] = (
        dataclasses.field(default_factory=list)
    )
    #: Set by whichever side (client wait-expiry or dispatcher in-queue
    #: expiry) counts the timeout first, so one request never increments
    #: the 'timeouts' counter twice. Guarded by ``_count_lock`` — use
    #: :meth:`claim_timeout_count`.
    timeout_counted: bool = False
    #: True once the submitter stopped waiting on this request
    #: (per-attempt deadline or a hedge race loss): any later batch
    #: result is DISCARDED — the gray-failure abandonment contract. Set
    #: only via :meth:`abandon`, under ``_count_lock``.
    abandoned: bool = False
    #: Optional shared event a router racing several attempts of one
    #: logical request waits on; set on EVERY terminal transition
    #: (complete/fail/abandon) so the racer wakes on the first edge.
    race: Optional[threading.Event] = None
    _count_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock
    )

    def claim_timeout_count(self) -> bool:
        """Atomic test-and-set: True for exactly one caller (the client's
        wait-expiry and the dispatcher's in-queue expiry can race)."""
        with self._count_lock:
            if self.timeout_counted:
                return False
            self.timeout_counted = True
            return True

    def _terminal(self) -> None:
        """Caller holds ``_count_lock`` and just decided the outcome."""
        self.done.set()
        if self.race is not None:
            self.race.set()

    def complete(self, result: Dict[str, np.ndarray],
                 version: Optional[int], shed: bool = False) -> bool:
        """First terminal transition wins (CAS): False when the request
        already completed, failed, or was ABANDONED — the caller discards
        the straggler result instead of publishing a duplicate or
        mis-versioned response."""
        with self._count_lock:
            if self.done.is_set():
                return False
            self.result = result
            self.version = version
            self.shed = shed
            self._terminal()
            return True

    def fail(self, error: BaseException) -> bool:
        with self._count_lock:
            if self.done.is_set():
                return False
            self.error = error
            self._terminal()
            return True

    def abandon(self) -> bool:
        """Stop waiting on this request (per-attempt deadline expiry or a
        lost hedge race). CAS: True for exactly one abandoner, False when
        a result/error already landed. After abandonment the request's
        queued tail rows are released at the batcher's next sweep and any
        in-flight straggler result is discarded by :meth:`complete`'s
        CAS — a late straggler can never produce a duplicate response."""
        with self._count_lock:
            if self.done.is_set():
                return False
            self.abandoned = True
            self._terminal()
            return True

    # -- segment reassembly (dispatcher thread only) -----------------------
    def add_segment(self, start: int, columns: Dict[str, np.ndarray],
                    version: Optional[int], rows: int):
        """Record one served segment. Returns ``None`` while more rows
        are outstanding, the assembled ``(columns, version)`` response
        when all rows landed on one version (the caller completes the
        request), the string ``"mixed"`` when segments span model
        versions — the caller must :meth:`reset_segments` and
        re-dispatch the whole request so the response stays
        single-version — or the string ``"discarded"`` when the request
        reached a terminal state (abandoned, expired, failed) while the
        segment was in flight: the straggler rows are dropped here and
        the caller counts the discard."""
        if self.done.is_set():  # abandoned/expired/failed mid-flight
            return "discarded"
        self.segments.append((start, columns, version, rows))
        served = sum(r for _, _, _, r in self.segments)
        if served < self.rows:
            return None
        versions = {v for _, _, v, _ in self.segments}
        if len(versions) > 1:
            return "mixed"
        self.segments.sort(key=lambda s: s[0])
        if len(self.segments) == 1:
            assembled = self.segments[0][1]
        else:
            names = self.segments[0][1].keys()
            assembled = {
                c: np.concatenate([cols[c] for _, cols, _, _ in self.segments])
                for c in names
            }
        return assembled, versions.pop()

    def reset_segments(self) -> None:
        """Discard partial results ahead of a whole-request re-dispatch
        (version skew across a hot swap)."""
        self.segments.clear()


@dataclasses.dataclass(frozen=True)
class BatchSegment:
    """One contiguous row range of a request inside a dispatched batch.
    Whole-request policies emit one full-range segment per request."""

    request: ServingRequest
    start: int
    rows: int

    @property
    def columns(self) -> Dict[str, np.ndarray]:
        if self.start == 0 and self.rows == self.request.rows:
            return self.request.columns
        return {
            name: a[self.start:self.start + self.rows]
            for name, a in self.request.columns.items()
        }


class AdaptiveMicroBatcher:
    """Bounded thread-safe request queue + FIFO whole-request packing."""

    def __init__(
        self,
        max_batch_rows: int = 1024,
        max_wait_s: float = 0.002,
        max_queue_rows: int = 8192,
    ):
        if max_batch_rows < 1:
            raise ValueError(f"max_batch_rows must be >= 1, got {max_batch_rows}")
        if max_queue_rows < max_batch_rows:
            raise ValueError(
                f"max_queue_rows ({max_queue_rows}) must be >= "
                f"max_batch_rows ({max_batch_rows})"
            )
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_s = float(max_wait_s)
        self.max_queue_rows = int(max_queue_rows)
        self._cond = threading.Condition()
        self._queue: Deque[ServingRequest] = collections.deque()
        self._queued_rows = 0
        self._stopped = False
        #: Called (outside the lock) after an offer or a stop, when a
        #: dispatcher that serves several batchers (:meth:`poll`) waits on
        #: a condition of its own.
        self.waker: Optional[Callable[[], None]] = None
        #: The open batching window: ``(window end, the bucket it opened
        #: on, its close time, the request whose deadline set that time or
        #: None)``.
        self._window: Optional[tuple] = None

    # -- producer side -----------------------------------------------------
    def offer(self, request: ServingRequest) -> bool:
        """Admit ``request``; False when the bounded queue is full (the
        engine decides between shedding and a typed rejection). Raises
        :class:`EngineStoppedError` after :meth:`stop`."""
        with self._cond:
            if self._stopped:
                raise EngineStoppedError("serving engine is stopped")
            if self._queued_rows + request.rows > self.max_queue_rows:
                return False
            self._queue.append(request)
            self._queued_rows += request.rows
            self._cond.notify_all()
        if self.waker is not None:
            self.waker()
        return True

    def requeue(self, request: ServingRequest) -> bool:
        """Put a request back at the FRONT of the queue for a whole
        re-dispatch (mixed-version reassembly across a hot swap). False
        after :meth:`stop` — the caller fails the request instead."""
        with self._cond:
            if self._stopped:
                return False
            request.dispatched_rows = 0
            request.reset_segments()
            self._queue.appendleft(request)
            self._queued_rows += request.rows
            self._cond.notify_all()
            return True

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def queued_rows(self) -> int:
        with self._cond:
            return self._queued_rows

    def oldest(self) -> float:
        """When the oldest queued request arrived (``inf`` when none is)."""
        with self._cond:
            return self._queue[0].enqueued_at if self._queue else float("inf")

    # -- consumer side (the dispatcher thread) -----------------------------
    def next_batch(
        self, poll_s: float = 0.05
    ) -> Tuple[List[BatchSegment], List[ServingRequest]]:
        """Block up to ``poll_s`` for work, then wait out the batching
        window (:meth:`poll`'s rule); returns ``(batch, expired)`` —
        either may be empty. ``expired`` are requests whose deadline
        passed while queued (the caller fails them with the timeout
        error); they never occupy batch rows, and an expiry observed
        mid-window returns IMMEDIATELY so the typed timeout is prompt
        rather than delayed to the window's close."""
        with self._cond:
            if not self._queue and not self._stopped:
                self._cond.wait(poll_s)
            expired: List[ServingRequest] = []
            while True:
                batch, newly, wake_at = self._poll()
                expired.extend(newly)
                if self._window is None:
                    # The window is over: popped, emptied, or cut short by
                    # an expiry.
                    return batch, expired
                self._cond.wait(wake_at - time.monotonic())

    def poll(self) -> Tuple[List[BatchSegment], List[ServingRequest],
                            Optional[float]]:
        """:meth:`next_batch` without blocking, for a dispatcher that
        serves several batchers in turn (``engine._CPU_HOST``): returns
        ``(batch, expired, wake_at)`` — the batch once its window has
        closed, the requests that expired while queued, and the
        ``time.monotonic()`` at which to poll again (None: a batch was
        popped or nothing is queued)."""
        with self._cond:
            return self._poll()

    def _poll(self) -> Tuple[List[BatchSegment], List[ServingRequest],
                             Optional[float]]:
        # Batching window, anchored to the OLDEST queued request when it
        # opens, on the bucket it opened on — but never waiting past any
        # queued request's deadline: a request whose deadline falls inside
        # the window closes it early (less a small margin) so it
        # dispatches in time instead of being expired by the very wait
        # that was supposed to batch it. Caller holds the lock.
        now = time.monotonic()
        window = self._window
        closed = window is not None and now >= window[2]
        # A dispatcher woken later than the margin (a loaded host) still
        # dispatches the request whose deadline closed the window, rather
        # than expire it by the late wake-up; every other overdue request
        # expires.
        expired = self._drop_expired(window[3] if closed else None)
        if not self._queue:
            self._window = None
            return [], expired, None
        if window is None:
            window = (self._queue[0].enqueued_at + self.max_wait_s,
                      min(self.max_batch_rows, row_bucket(self._queued_rows)))
        elif expired and not closed:
            # Prompt sweep: fail overdue requests NOW (the caller raises
            # the typed timeout) instead of holding them — or the window —
            # until the max-wait elapses; the next poll opens a new window.
            self._window = None
            return [], expired, now
        rows = self._queued_rows
        close_at, closer = window[0], None
        for r in self._queue:
            if r.deadline is not None and r.deadline - 0.005 < close_at:
                close_at, closer = r.deadline - 0.005, r
        if (self._stopped or rows >= self.max_batch_rows
                or self._close_early(rows, window[1]) or close_at <= now):
            self._window = None
            return self._pop_batch(window[1]), expired, None
        self._window = (window[0], window[1], close_at, closer)
        return [], expired, close_at

    def _close_early(self, rows: int, forming_bucket: int) -> bool:
        # Bucket exactly full: occupancy 1.0, waiting buys nothing.
        return rows == row_bucket(rows)

    def _discard_if_dead(self, req: ServingRequest) -> bool:
        """Drop a queued request that already completed or failed (a
        split request's earlier batch erred, or shutdown failed it) —
        its remaining rows must neither occupy batch rows nor inflate
        the admission bound. Caller holds the lock and ``req`` is the
        queue head."""
        if not req.done.is_set():
            return False
        self._queue.popleft()
        self._queued_rows -= req.rows - req.dispatched_rows
        return True

    def _pop_batch(self, forming_bucket: int) -> List[BatchSegment]:
        """FIFO whole-request packing (never splits)."""
        batch: List[BatchSegment] = []
        rows = 0
        while self._queue:
            req = self._queue[0]
            if self._discard_if_dead(req):
                continue
            if batch and rows + req.rows > self.max_batch_rows:
                break
            self._queue.popleft()
            self._queued_rows -= req.rows
            batch.append(BatchSegment(req, 0, req.rows))
            rows += req.rows
            if rows >= self.max_batch_rows:
                break
        return batch

    def _drop_expired(
        self, spare: Optional[ServingRequest] = None
    ) -> List[ServingRequest]:
        now = time.monotonic()
        expired, dead = [], []
        for r in self._queue:
            if r.done.is_set():
                # Abandoned (or failed elsewhere) while queued: cancel at
                # the queue — its remaining rows stop occupying admission
                # capacity NOW, not when it reaches the head. This is the
                # hedge-loser cancellation path.
                dead.append(r)
            elif (r.deadline is not None and r.deadline <= now
                  and r is not spare):
                expired.append(r)
        for r in dead:
            self._queue.remove(r)
            self._queued_rows -= r.rows - r.dispatched_rows
        for r in expired:
            self._queue.remove(r)
            self._queued_rows -= r.rows - r.dispatched_rows
        return expired

    # -- shutdown ----------------------------------------------------------
    def stop(self) -> None:
        """Refuse new offers; the consumer may keep draining."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self.waker is not None:
            self.waker()

    def drain_pending(self) -> List[ServingRequest]:
        """Pop every queued request (shutdown without drain: the engine
        fails them with :class:`EngineStoppedError`)."""
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            return pending


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (int(n).bit_length() - 1)


class ContinuousBatcher(AdaptiveMicroBatcher):
    """Continuous batching: requests split at bucket boundaries (see the
    module docstring). Shares admission, deadlines, and shutdown with the
    FIFO policy; only the window-close condition and the pop differ."""

    def _close_early(self, rows: int, forming_bucket: int) -> bool:
        # Late arrivals filled the bucket the window opened on: dispatch
        # exactly that full bucket now (the straddler splits), instead of
        # waiting out the window only to pad a larger bucket.
        return rows >= forming_bucket or rows == row_bucket(rows)

    def _pop_batch(self, forming_bucket: int) -> List[BatchSegment]:
        q = self._queued_rows
        if q >= self.max_batch_rows:
            # Saturated: every dispatch is an exactly-full cap bucket.
            target = self.max_batch_rows
        elif q >= forming_bucket:
            # The forming bucket filled (early close): take the largest
            # exactly-full bucket available — zero padding; the remainder
            # opens the next window at the queue front.
            target = min(self.max_batch_rows, _pow2_floor(q))
        else:
            # Window expired under-full: latency beats occupancy, flush
            # everything (padded to its bucket by the executor).
            target = q
        batch: List[BatchSegment] = []
        taken = 0
        while self._queue and taken < target:
            req = self._queue[0]
            if self._discard_if_dead(req):
                # A failed head batch killed this request; its tail rows
                # must not be dispatched as dead device work.
                continue
            remaining = req.rows - req.dispatched_rows
            take = min(remaining, target - taken)
            batch.append(BatchSegment(req, req.dispatched_rows, take))
            req.dispatched_rows += take
            self._queued_rows -= take
            taken += take
            if req.dispatched_rows >= req.rows:
                self._queue.popleft()
        return batch
