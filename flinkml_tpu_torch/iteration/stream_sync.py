"""Multi-process streamed training: the agreement layer.

The port's counterpart of ``flinkml_tpu.iteration.stream_sync``. On a
mesh of several ranks (one process and one device each) every rank feeds
its own partition of the stream, and two invariants keep the ranks'
collectives in step:

1. **One shape a step**: every rank contributes one agreed padded local
   height (padded rows weigh 0, exact no-ops);
2. **One step count**: a rank whose partition is shorter feeds
   zero-weight dummy steps until the longest has drained (a rank with no
   data at all is legal).

:class:`SyncedReplayPlan` agrees both for a sealed cache;
:func:`synced_stream` and :func:`synced_padded_stream` agree them step by
step for a one-shot stream (one ``all_reduce`` of one int a step). A
failure on one rank is held until every rank agrees to abort
(:func:`agree_all_ok`), because a rank that raises alone strands its
peers in their next collective. :func:`agree_max` and :func:`agree_min`
reduce one int64 over the ranks (one ``all_reduce``);
:func:`gather_vectors` all-gathers one float64 vector a rank, and
:func:`pooled_sample` pools the ranks' reservoir samples into one seeded
global draw. With one process the agreement is the process itself: a
held failure raises at the rendezvous and nothing is communicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

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


def agree_feature_dim(cache, column: str, mesh, local_dim: int = 0) -> int:
    """The feature dim of a cached stream, agreed over the ranks.
    ``local_dim`` skips discovery when the trainer knows it; else the
    first cached batch's ``column`` gives it. An empty local cache adds 0
    and adopts the agreed dim; a mismatch raises on every rank."""
    if not local_dim and cache.num_batches:
        reader = cache.reader()
        local_dim = int(np.asarray(next(iter(reader))[column]).shape[1])
        if hasattr(reader, "close"):
            reader.close()
    dim = agree_max(local_dim, mesh)
    agree_all_ok(
        not (local_dim and local_dim != dim), mesh,
        f"feature-dim agreement (local {local_dim}, global {dim})",
    )
    return dim


def entry_rows(entry: Any) -> int:
    """Row count of one sealed-cache entry (a RAM dict or a Segment)."""
    if isinstance(entry, Segment):
        return entry.num_rows
    return next(iter(entry.values())).shape[0] if entry else 0


def round_up(n: int, multiple: int) -> int:
    return -(-int(n) // int(multiple)) * int(multiple)


def agree_first_item_dim(source, check, dim_of, mesh):
    """The first item of an uncached lockstep stream and its agreed
    feature dim: ``(first, rest, dim)``. The first pull's raise, the
    ``check`` and a dim mismatch are held for one agreement; an exhausted
    rank returns ``first=None`` and adopts the agreed dim (it feeds only
    dummies); a stream empty on every rank raises on every rank."""
    it = iter(source)
    first = None
    held = None
    try:
        first = next(it, None)
    except Exception as e:  # noqa: BLE001 — agreed below
        held = e
    local_d = 0
    if first is not None and held is None:
        try:
            check(first)
            local_d = int(dim_of(first))
        except Exception as e:  # noqa: BLE001 — agreed below
            held = e
    dim = agree_max(local_d, mesh)
    try:
        agree_all_ok(
            held is None and not (local_d and local_d != dim), mesh,
            f"feature-dim agreement (local {local_d}, global {dim})",
        )
    except ValueError:
        if held is not None:
            raise held
        raise
    if dim == 0:
        raise ValueError("training stream is empty on every process")
    return first, it, dim


@dataclasses.dataclass
class SyncedReplayPlan:
    """The agreed per-epoch replay schedule of one sealed local cache:
    ``global_steps`` dispatches an epoch on every rank, each with
    ``local_height`` padded rows from every rank."""

    global_steps: int
    local_height: int
    mesh: Any

    @staticmethod
    def create(cache, mesh, row_tile: int) -> "SyncedReplayPlan":
        """Agree the schedule of ``cache`` (this rank's partition): the
        most batches of any rank, and the tallest batch of any rank
        rounded up to ``row_tile``. An empty local cache is legal; a
        stream empty on every rank raises."""
        local_max = max((entry_rows(e) for e in cache.entries), default=0)
        steps = agree_max(cache.num_batches, mesh)
        height = agree_max(round_up(max(local_max, 1), row_tile), mesh)
        if steps == 0:
            raise ValueError("training stream is empty on every process")
        return SyncedReplayPlan(global_steps=steps, local_height=height,
                                mesh=mesh)

    def epoch_batches(self, reader: Iterator[Dict[str, np.ndarray]],
                      dummy: Callable[[], Any]) -> Iterator[Any]:
        """Exactly ``global_steps`` items: the local reader's batches
        (the caller's placement pads each to ``local_height``), then
        ``dummy()`` fillers (zero weight, the same shape) once the local
        cache has drained."""
        steps = 0
        for batch in reader:
            if steps >= self.global_steps:
                raise RuntimeError(
                    "local cache yielded more batches than the agreed "
                    "schedule — caches must be sealed before planning"
                )
            yield batch
            steps += 1
        while steps < self.global_steps:
            yield dummy()
            steps += 1


def pad_rows_to(arr: np.ndarray, height: int, dtype=None) -> np.ndarray:
    """Zero-pad ``arr`` along axis 0 to exactly ``height`` rows (padded
    rows carry zero weight, so they are exact no-ops)."""
    arr = np.asarray(arr, dtype)
    out = np.zeros((height,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _gather_rows(block: np.ndarray, mesh) -> np.ndarray:
    """Every rank's ``block`` (one shape on every rank) stacked in the
    mesh's data order: one ``all_gather`` on the mesh's device."""
    import torch

    from flinkml_tpu_torch.parallel.collectives import gather_blocks

    t = torch.from_numpy(np.ascontiguousarray(block)[None])
    return gather_blocks(mesh, t).cpu().numpy()


def _default_mesh(mesh):
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh

    return mesh if mesh is not None else DeviceMesh()


def gather_vectors(local_vec: np.ndarray, mesh) -> np.ndarray:
    """One flat float64 vector from every rank, ``[P, len]`` in the
    mesh's data order on every rank: one ``all_gather`` of the float64
    values themselves (no rank adds another's, so every rank holds the
    same bits). One process: ``local_vec[None, :]``."""
    from flinkml_tpu_torch.parallel.distributed import process_count

    local_vec = np.asarray(local_vec, np.float64).ravel()
    if process_count() == 1:
        return local_vec[None, :]
    return _gather_rows(local_vec, _default_mesh(mesh))


_EXHAUSTED, _HAVE, _ERROR = 0, 1, 2
_PAYLOAD_BASE = 1 << 22  # (code, payload) packed into one agreement


def synced_stream(batches, mesh, check: Optional[Callable[[Any], None]] = None,
                  payload: Optional[Callable[[Any], int]] = None):
    """Iterate a one-shot local stream in lockstep with the other ranks,
    without caching: every step the ranks agree a state code (exhausted /
    have data / local error) in one ``all_reduce`` of one int:

    - a rank erred: every rank raises (the rank's own error, its peers'
      the agreement's);
    - a rank has data: every rank yields (an exhausted rank yields None:
      the caller dispatches a zero-weight dummy step);
    - every rank exhausted: the iteration ends everywhere.

    ``check`` validates each local item inside the agreement. ``payload``
    maps an item to an int in ``[0, 2**22)`` that rides the same
    agreement (the max over the ranks with data); the stream then yields
    ``(item, agreed_payload)``. One process: plain iteration, no
    collective."""
    from flinkml_tpu_torch.parallel.distributed import process_count

    if process_count() == 1:
        for item in batches:
            if check is not None:
                check(item)
            yield item if payload is None else (item, payload(item))
        return
    it = iter(batches)
    held_err: Optional[Exception] = None
    while True:
        # The source's own raise (a shard read failing) is as rank-local
        # as a failed check and rides the same agreement.
        try:
            item = next(it, None)
        except Exception as e:  # noqa: BLE001 — agreed below
            held_err = e
            item = None
        pay = 0
        if held_err is not None:
            code = _ERROR
        elif item is None:
            code = _EXHAUSTED
        else:
            code = _HAVE
            if check is not None:
                try:
                    check(item)
                except Exception as e:  # noqa: BLE001 — agreed below
                    held_err = e
                    code = _ERROR
            if code == _HAVE and payload is not None:
                pay = int(payload(item))
                if not 0 <= pay < _PAYLOAD_BASE:
                    held_err = ValueError(
                        f"synced_stream payload {pay} out of range "
                        f"[0, {_PAYLOAD_BASE})"
                    )
                    code = _ERROR
        agreed = agree_max(code * _PAYLOAD_BASE + pay, mesh)
        agreed_code, agreed_pay = divmod(agreed, _PAYLOAD_BASE)
        if agreed_code == _ERROR:
            if held_err is not None:
                raise held_err
            raise ValueError(
                "stream validation failed on another process; all ranks "
                "abort together to avoid a distributed hang"
            )
        if agreed_code == _EXHAUSTED:
            return
        yield item if payload is None else (item, agreed_pay)


def synced_padded_stream(arrays_stream, mesh, check, row_tile, dummy_cols):
    """The uncached lockstep loop of the online trainers: yields
    ``(padded_arrays, valid_w, h)`` per agreed step. Each item is a tuple
    of arrays of one leading height n, zero-padded to the agreed
    ``row_tile``-rounded height h (the :func:`synced_stream` payload);
    ``valid_w`` is 1 on real rows and 0 on padding; a drained rank gets
    all-zero dummies shaped by ``dummy_cols`` (the trailing shape of each
    array)."""
    def height_of(item):
        return round_up(max(item[0].shape[0], 1), row_tile)

    for item, h in synced_stream(arrays_stream, mesh, check=check,
                                 payload=height_of):
        if item is None:  # this rank drained: a zero-weight dummy step
            item = tuple(np.zeros((0,) + tuple(shp), np.float32)
                         for shp in dummy_cols)
        n = item[0].shape[0]
        padded = tuple(pad_rows_to(a, h) for a in item)
        valid_w = np.zeros(h, np.float32)
        valid_w[:n] = 1.0
        yield padded, valid_w, h


def pooled_sample(local_sample: np.ndarray, local_rows: int, cap: int,
                  seed: int, mesh) -> np.ndarray:
    """One global row sample from the ranks' uniform local samples: each
    rank's padded sample and its ``(sample_rows, local_rows)`` are
    all-gathered over the mesh's data axis, then ``min(cap, pooled rows)``
    rows are drawn on every rank alike (same seed, same rows) by
    Efraimidis–Spirakis sampling without replacement, each pooled row
    weighted ``local_rows / sample_rows`` of its rank, so the draw is
    uniform over the global data in expectation. An empty partition is
    legal; a pool empty on every rank raises. One process: the local
    sample as it is."""
    from flinkml_tpu_torch.parallel.distributed import process_count

    local_sample = np.asarray(local_sample, np.float32)
    if process_count() == 1:
        return local_sample
    mesh = _default_mesh(mesh)
    if local_sample.size == 0:
        # An empty reservoir's shape is 1-D; the dim comes from the
        # agreement below.
        local_sample = local_sample.reshape(0, 0)
    if local_sample.ndim != 2:
        raise ValueError(f"sample must be [n, d], got {local_sample.shape}")
    d = agree_max(local_sample.shape[1], mesh)
    if local_sample.shape[0] and local_sample.shape[1] != d:
        raise ValueError(
            f"sample feature dim {local_sample.shape[1]} != global dim {d}"
        )
    s_p = local_sample.shape[0]
    # Gather buffers sized by the agreed largest sample, not the cap.
    cap_eff = max(1, agree_max(s_p, mesh))
    padded = np.zeros((cap_eff, d), np.float32)
    if s_p:
        padded[:s_p] = local_sample
    gathered = _gather_rows(padded, mesh)
    metas = _gather_rows(np.asarray([s_p, local_rows], np.float64), mesh)
    rows, weights = [], []
    for i in range(gathered.shape[0]):
        s_rows, n_rows = int(metas[i, 0]), float(metas[i, 1])
        if s_rows == 0:
            continue
        rows.append(gathered[i, :s_rows])
        weights.append(np.full(s_rows, n_rows / s_rows, np.float64))
    if not rows:
        raise ValueError("pooled sample is empty on every process")
    pool = np.concatenate(rows, axis=0)
    w = np.concatenate(weights)
    take = min(cap, pool.shape[0])
    rng = np.random.default_rng(seed)
    # Top-k of u^(1/w) is a weighted sample without replacement; the same
    # seed on every rank gives the same selection.
    keys = rng.random(pool.shape[0]) ** (1.0 / np.maximum(w, 1e-12))
    order = np.argsort(keys)[::-1][:take]
    return pool[order]
