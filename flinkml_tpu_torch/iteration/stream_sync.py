"""Ingest validation and restore helpers of the streamed trainers.

The port's counterpart of the one-process part of
``flinkml_tpu.iteration.stream_sync``. In the JAX package these helpers
hold a failure on one rank until every rank agrees to abort; with one
process the agreement is the process itself, so a held failure is raised
at the rendezvous and a restore is a plain restore. The collectives
(``agree_max``, ``agree_all_ok``, ``SyncedReplayPlan``, ``synced_stream``,
``pooled_sample``, ``gather_vectors``) come with ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from flinkml_tpu_torch.iteration.datacache import Segment


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
        """Raise the held failure (one process: nothing to agree)."""
        if mesh is not None:
            raise NotImplementedError(
                "a mesh is not ported to flinkml_tpu_torch yet: it comes "
                "with ROADMAP.md Queue 1 item 7 (multi-device)"
            )
        if self.err is not None:
            raise self.err


def agreed_restore(manager, epoch, like, mesh=None, what: Optional[str] = None):
    """``manager.restore(epoch, like)``; a failure raises at once."""
    dv = DeferredValidation()
    got = dv.call(manager.restore, epoch, like)
    dv.rendezvous(mesh, what or f"checkpoint restore (epoch {epoch})")
    return got


def agreed_restore_latest(manager, like, mesh=None,
                          what: str = "checkpoint restore (latest)"):
    """``manager.restore_latest(like)``; None means no checkpoint."""
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
