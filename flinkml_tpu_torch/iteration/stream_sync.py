"""Agreement, ingest validation and restore helpers of the trainers.

The port's counterpart of ``flinkml_tpu.iteration.stream_sync``: a
failure on one rank is held until every rank agrees to abort
(:func:`agree_all_ok`), because a rank that raises alone strands its
peers in their next collective. :func:`agree_max` and :func:`agree_min`
reduce one int over the ranks (one ``all_reduce``). With one process the
agreement is the process itself: a held failure raises at the
rendezvous. The multi-process streams' plans (``SyncedReplayPlan``,
``synced_stream``, ``pooled_sample``, ``gather_vectors``) come with
ROADMAP.md Queue 1 item 7c.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from flinkml_tpu_torch.iteration.datacache import Segment
from flinkml_tpu_torch.utils import logging as flog

_log = flog.get_logger("stream_sync")


def _agree(value: int, mesh, op: str) -> int:
    """``value`` reduced by ``op`` (``max`` or ``min``) over the
    ranks of ``mesh``'s first axis (of the default group when ``mesh`` is
    None): one int64 ``all_reduce``. One process: ``value``."""
    import torch
    import torch.distributed as dist

    from flinkml_tpu_torch.parallel.distributed import process_count

    if process_count() == 1:
        return int(value)
    if mesh is not None:
        group, device = mesh.group(mesh.axis_names[0]), mesh.device
    else:
        group = dist.group.WORLD
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.full((1,), int(value), dtype=torch.int64, device=device)
    red = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    if group is not None:
        dist.all_reduce(t, op=red, group=group)
    return int(t.cpu()[0])


def agree_max(value: int, mesh=None) -> int:
    """Max of a per-rank int over the ranks."""
    return _agree(value, mesh, "max")


def agree_min(value: int, mesh=None) -> int:
    """Min of a per-rank int over the ranks: how elastic survivors pick
    the newest snapshot every one of them can restore."""
    return _agree(value, mesh, "min")


def agree_all_ok(ok: bool, mesh, what: str) -> None:
    """Raise on EVERY rank when any rank failed a local check: all ranks
    call it at the same point, and all ranks raise together. One process:
    raises at once when not ``ok``."""
    from flinkml_tpu_torch.parallel.distributed import process_count

    world = process_count()
    failed = (not ok) if world == 1 else _agree(0 if ok else 1, mesh,
                                                "max") != 0
    if failed:
        suffix = "" if ok else " (failed on this process)"
        _log.error("agreed abort: %s failed on at least one process%s",
                   what, suffix)
        raise ValueError(
            f"{what} failed on at least one process{suffix}; "
            "all ranks abort together to avoid a distributed hang"
        )
    if world > 1:
        _log.info("rendezvous ok: %s agreed on all %d processes", what, world)


class DeferredValidation:
    """Hold the first ingest-time failure; :meth:`rendezvous` re-raises it.

    :meth:`call` runs one ingest step and returns its value, or None once a
    failure is held (the caller then skips its accumulation)."""

    def __init__(self):
        self.err: Optional[Exception] = None

    def call(self, fn, *args):
        if self.err is not None:
            return None
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 — held, re-raised later
            self.err = e
            return None

    def rendezvous(self, mesh=None, what: str = "") -> None:
        """Agree on every rank (:func:`agree_all_ok`); this rank's held
        failure re-raises as it was, a peer's as ``ValueError``."""
        try:
            agree_all_ok(self.err is None, mesh, what)
        except ValueError:
            if self.err is not None:
                raise self.err
            raise


def agreed_restore(manager, epoch, like, mesh=None, what: Optional[str] = None):
    """``manager.restore(epoch, like)``, every rank aborting together when
    one fails."""
    dv = DeferredValidation()
    got = dv.call(manager.restore, epoch, like)
    dv.rendezvous(mesh, what or f"checkpoint restore (epoch {epoch})")
    return got


def agreed_restore_latest(manager, like, mesh=None,
                          what: str = "checkpoint restore (latest)"):
    """``manager.restore_latest(like)`` under the same agreement; None
    means no checkpoint."""
    dv = DeferredValidation()
    got = dv.call(manager.restore_latest, like)
    dv.rendezvous(mesh, what)
    return got


def guarded_iter(batches, dv: DeferredValidation):
    """Iterate ``batches``, folding a raise of the source's ``next()`` into
    ``dv`` and ending the stream instead; stops once ``dv`` holds a
    failure."""
    it = iter(batches)
    while dv.err is None:
        try:
            item = next(it)
        except StopIteration:
            return
        except Exception as e:  # noqa: BLE001 — held for the rendezvous
            dv.err = e
            return
        yield item


def checked_ingest(source, dv: DeferredValidation, fn, multi: bool):
    """Run ``fn`` over ``source``, yielding its non-None results. With
    ``multi`` the source's and ``fn``'s failures are held in ``dv`` for
    the caller's rendezvous; otherwise they raise at the item."""
    if not multi:
        for item in source:
            out = fn(item)
            if out is not None:
                yield out
        return
    for item in guarded_iter(source, dv):
        out = dv.call(fn, item)
        if out is not None:
            yield out


def entry_rows(entry: Any) -> int:
    """Row count of one sealed-cache entry (a RAM dict or a Segment)."""
    if isinstance(entry, Segment):
        return entry.num_rows
    return next(iter(entry.values())).shape[0] if entry else 0


def pad_rows_to(arr: np.ndarray, height: int, dtype=None) -> np.ndarray:
    """Zero-pad ``arr`` along axis 0 to exactly ``height`` rows (padded
    rows carry zero weight, so they are exact no-ops)."""
    arr = np.asarray(arr, dtype)
    out = np.zeros((height,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out
