"""Preemption watchdog: SIGTERM or a soft deadline -> final checkpoint,
drain.

The port's counterpart of ``flinkml_tpu.utils.preemption``. A preempting
scheduler sends SIGTERM, grants a short grace window, then kills the
machine. The contract is host-side and explicit:

  1. :class:`PreemptionWatchdog` installs signal handlers (and/or a
     soft-deadline timer) that only set a **flag**, so they are
     async-signal-safe and never interrupt a collective mid-flight.
     ``signal.signal`` works on the main thread only; off it the handlers
     are skipped with a warning and :meth:`~PreemptionWatchdog.request`
     still works.
  2. Every :func:`flinkml_tpu_torch.iteration.iterate` loop (and
     ``sharding.apply.train_linear_plan``) polls the flag at its epoch
     boundary. On preemption the loop stops cleanly, commits one final
     checkpoint through its manager and marks its result
     ``preempted=True``; a later ``resume=True`` run continues from it.
  3. The loop then calls :meth:`~PreemptionWatchdog.finalize`, which
     drains every registered engine (``stop(drain=True)``).

Use it scoped::

    with PreemptionWatchdog(soft_deadline_s=3500) as wd:
        model = online_lr.fit_stream(stream, checkpoint_manager=mgr,
                                     checkpoint_interval=50)

Any ``iterate`` loop inside the ``with`` sees the watchdog through
:func:`active` (an explicit ``IterationConfig.watchdog`` overrides it).

**Shrink on rank loss (elastic resume).** A lost peer
(:meth:`~PreemptionWatchdog.notify_rank_lost`, fed by an orchestrator or
by the scripted :class:`~flinkml_tpu_torch.faults.RankLost` at the
``rank.lost`` seam) requests the same clean stop; the survivors then
agree the newest commonly valid snapshot
(:meth:`~PreemptionWatchdog.plan_elastic_resume`, through
:func:`flinkml_tpu_torch.parallel.distributed.agree_resume_epoch`) and
resume at the smaller world::

    with PreemptionWatchdog() as wd:
        result = trainer.fit_stream(feed, checkpoint_manager=mgr, ...)
    if wd.shrink_requested:
        plan = wd.plan_elastic_resume(mgr, world=old_world)
"""

from __future__ import annotations

import dataclasses
import signal
import threading
from typing import Any, List, Optional, Sequence

from flinkml_tpu_torch.utils.logging import get_logger

_log = get_logger("preemption")


@dataclasses.dataclass(frozen=True)
class ElasticResumePlan:
    """The survivors' agreed shrink/grow decision: resume from snapshot
    ``epoch`` (the newest commonly-valid one; None when no snapshot
    exists anywhere — a fresh start at the new world), moving from
    ``old_world`` ranks to ``new_world``."""

    epoch: Optional[int]
    old_world: int
    new_world: int

_ACTIVE: Optional["PreemptionWatchdog"] = None


def active() -> Optional["PreemptionWatchdog"]:
    """The installed watchdog (what ``iterate`` polls), or None."""
    return _ACTIVE


class PreemptionWatchdog:
    """See module docstring.

    Args:
        signals: signals to trap while installed (default: SIGTERM).
            Installation is skipped with a warning off the main thread
            (CPython restriction); :meth:`request` still works there.
        soft_deadline_s: optionally also request preemption after this
            many seconds — the belt-and-suspenders for schedulers that
            kill without signaling.
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,),
                 soft_deadline_s: Optional[float] = None):
        self.signals = tuple(signals)
        self.soft_deadline_s = soft_deadline_s
        self._event = threading.Event()
        self._engines: List[Any] = []
        self._prev_handlers: dict = {}
        self._timer: Optional[threading.Timer] = None
        self._finalized = False
        self.reason: Optional[str] = None
        #: Peer ranks reported dead (see :meth:`notify_rank_lost`) —
        #: what the elastic shrink path sizes the survivor world from.
        self.lost_ranks: List[int] = []

    # -- lifecycle ---------------------------------------------------------
    def install(self) -> "PreemptionWatchdog":
        global _ACTIVE
        for sig in self.signals:
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # not the main thread
                _log.warning(
                    "cannot trap signal %s off the main thread; relying on "
                    "request()/soft deadline only", sig,
                )
        if self.soft_deadline_s is not None:
            self._timer = threading.Timer(
                self.soft_deadline_s,
                lambda: self.request(
                    f"soft deadline ({self.soft_deadline_s}s) reached"
                ),
            )
            self._timer.daemon = True
            self._timer.start()
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev_handlers.clear()
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if _ACTIVE is self:
            _ACTIVE = None

    __enter__ = install

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- preemption request ------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        # Async-signal-safe: set the flag, nothing else. The training
        # loop observes it at its next epoch boundary.
        self.reason = f"signal {signum}"
        self._event.set()

    def request(self, reason: str = "manual request") -> None:
        """Programmatic preemption (tests, external health checks)."""
        if not self._event.is_set():
            self.reason = reason
            _log.warning("preemption requested: %s", reason)
        self._event.set()

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    # -- elastic world changes ----------------------------------------------
    def notify_rank_lost(self, rank: int, reason: Optional[str] = None) -> None:
        """A peer host is gone (preempted VM, dead health check, the
        scripted :class:`~flinkml_tpu_torch.faults.RankLost` fault). Recorded
        in :attr:`lost_ranks` and treated exactly like SIGTERM on this
        host: the training loop stops cleanly at its next epoch
        boundary with a final checkpoint — the survivors then agree an
        elastic resume at the shrunken world
        (:meth:`plan_elastic_resume`)."""
        rank = int(rank)
        if rank not in self.lost_ranks:
            self.lost_ranks.append(rank)
        self.request(reason or f"rank {rank} lost (shrink requested)")

    @property
    def shrink_requested(self) -> bool:
        """True when at least one peer rank was reported lost — the
        signal to resume at a smaller world rather than just restart."""
        return bool(self.lost_ranks)

    def survivor_world(self, old_world: int) -> int:
        """The world size after dropping the lost ranks (floored at 1 —
        this host is, by construction, still alive)."""
        return max(1, int(old_world) - len(set(self.lost_ranks)))

    def plan_elastic_resume(self, manager: Any, world: int,
                            new_world: Optional[int] = None,
                            mesh=None) -> ElasticResumePlan:
        """The survivors' shrink (or grow) decision: agree the newest
        commonly-valid snapshot of ``manager`` across the remaining
        ranks (:func:`flinkml_tpu_torch.parallel.distributed
        .agree_resume_epoch`, which fires the ``rendezvous.rescale`` seam)
        and return the :class:`ElasticResumePlan` to resume from.
        ``new_world`` defaults to :meth:`survivor_world` of ``world``."""
        from flinkml_tpu_torch.parallel.distributed import agree_resume_epoch

        target = (int(new_world) if new_world is not None
                  else self.survivor_world(world))
        epoch = agree_resume_epoch(manager, mesh=mesh,
                                   old_world=int(world), new_world=target)
        plan = ElasticResumePlan(epoch=epoch, old_world=int(world),
                                 new_world=target)
        _log.warning(
            "elastic resume planned: world %d -> %d from snapshot epoch "
            "%s (lost ranks: %s)", plan.old_world, plan.new_world,
            plan.epoch, sorted(set(self.lost_ranks)),
        )
        return plan

    # -- shutdown actions ----------------------------------------------------
    def register_engine(self, engine: Any) -> None:
        """Serving engines to drain cleanly on preemption: a
        :class:`~flinkml_tpu_torch.serving.ServingEngine` (or a pool, or
        anything with ``stop(drain=True)``). :meth:`finalize` stops each
        with ``drain=True``, so every request already queued is
        answered."""
        self._engines.append(engine)

    @property
    def finalized(self) -> bool:
        return self._finalized

    def finalize(self) -> None:
        """Drain registered engines; idempotent. Called by the training
        loop AFTER its final checkpoint committed, so the snapshot is
        durable before serving winds down."""
        if self._finalized:
            return
        self._finalized = True
        for engine in self._engines:
            try:
                engine.stop(drain=True)
                _log.info("drained serving engine %r on preemption", engine)
            except Exception as e:  # noqa: BLE001 — drain best-effort
                _log.error("engine drain failed on preemption: %r", e)
