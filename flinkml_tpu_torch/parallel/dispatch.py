"""Bounded in-flight dispatch, collective-dispatch locks, slice leases.

The port's counterpart of ``flinkml_tpu.parallel.dispatch``. CUDA launches
and NCCL collectives are asynchronous: a host loop enqueues work and runs
ahead. :class:`DispatchGuard` and :func:`synced_loop` bound the number of
collective steps in flight by waiting for the carry every ``interval``
dispatches (Flink's credit-based flow control in the reference,
``AllReduceImpl.java:52-299``): unbounded with one process, 8 in a group
of several (``FLINKML_SYNC_INTERVAL`` overrides).

:func:`local_execution_lock` serializes host threads that dispatch
collective programs over the same device set (the ranks of a mesh),
:class:`SliceLease` records which devices a training job holds, and
:func:`record_collective_dispatch` reports each collective dispatch to
the installed observers. The port keeps its own lock and lease
registries. :class:`DispatchGuard` fires the ``dispatch.transfer`` fault
seam (:mod:`flinkml_tpu_torch.faults`) on every ``after_dispatch`` and
``flush`` while a plan is armed.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Optional

import torch

from flinkml_tpu_torch import faults

_ENV_INTERVAL = "FLINKML_SYNC_INTERVAL"
_DEFAULT_MULTIPROCESS_INTERVAL = 8

# -- collective-dispatch locking -------------------------------------------
#
# Mutexes for whole training loops launched from concurrent host THREADS
# of one rank. Two threads that issue collectives over the same process
# group interleave them in different orders on different ranks, and the
# ranks then wait on each other's mismatched collectives. Concurrent fits
# time-share a mesh by serializing here. Reentrant, so nested training
# loops (a fit inside a tuning fold) compose.
#
# One lock per device set: fits over disjoint meshes proceed concurrently,
# and every acquisition is tracked, so a dispatch event carries the lock
# tokens its thread holds (the JAX package's analyzer reads them, rule
# FML302; the analyzer is ROADMAP.md Queue 1 item 13).

_HELD_LOCKS = threading.local()  # per-thread list of held lock tokens


def _held_list():
    lst = getattr(_HELD_LOCKS, "tokens", None)
    if lst is None:
        lst = _HELD_LOCKS.tokens = []
    return lst


class TrackedRLock:
    """An RLock that records, per thread, that it is held — so dispatch
    trace events can carry the lock tokens the dispatching thread holds."""

    def __init__(self, token: str):
        self.token = token
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _held_list().append(self.token)
        return ok

    def release(self) -> None:
        self._lock.release()
        held = _held_list()
        # Remove ONE entry (reentrant acquisitions push one token each).
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.token:
                del held[i]
                break

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()


def held_lock_tokens() -> tuple:
    """Tokens of every tracked lock the calling thread currently holds."""
    return tuple(dict.fromkeys(_held_list()))


class _CompositeLock:
    """Acquires several :class:`TrackedRLock`s in canonical (token-sorted)
    order — the mutex for a device set that overlaps other registered
    sets. Global ordering makes nested/concurrent composites
    deadlock-free, and sharing at least one component lock with every
    overlapping fit gives mutual exclusion: a later-registered overlapping
    set's composite always includes the earlier set's lock."""

    def __init__(self, locks):
        self._locks = sorted(locks, key=lambda l: l.token)

    def acquire(self) -> bool:
        for lock in self._locks:
            lock.acquire()
        return True

    def release(self) -> None:
        for lock in reversed(self._locks):
            lock.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()


class _GlobalLock:
    """The ``mesh=None`` mutex: the process lock plus EVERY registered
    mesh lock. The mesh-lock snapshot is taken *after* the process lock is
    held — new device sets register under the process lock, so no mesh
    lock can appear between the snapshot and the acquisition: nothing
    slips past a global holder."""

    def acquire(self) -> bool:
        _PROCESS_LOCK.acquire()
        with _MESH_LOCKS_GUARD:
            held = sorted(_MESH_LOCKS.values(), key=lambda l: l.token)
        for lock in held:
            lock.acquire()
        # Stack of per-acquire snapshots: reentrant acquires may see more
        # registered locks than the outer one.
        self._held_stack = getattr(self, "_held_stack", [])
        self._held_stack.append(held)
        return True

    def release(self) -> None:
        for lock in reversed(self._held_stack.pop()):
            lock.release()
        _PROCESS_LOCK.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()


_PROCESS_LOCK = TrackedRLock("lock:process")
_MESH_LOCKS: dict = {}  # frozenset(device ids) -> TrackedRLock
_MESH_LOCKS_GUARD = threading.Lock()


def _device_id(d) -> int:
    """An integer device id: an int (a rank) or a ``torch.device``'s
    index; a ``torch.device`` without one (``cpu``, a bare ``cuda``) is
    the process's one device of its type, id 0."""
    if isinstance(d, int):
        return d
    if isinstance(d, torch.device):
        return 0 if d.index is None else int(d.index)
    index = getattr(d, "index", None)
    if index is None:
        raise TypeError(f"cannot take a device id from {d!r}")
    return int(index)


def _device_id_set(mesh) -> frozenset:
    """Normalize a lock subject to its device-id set: a
    :class:`~flinkml_tpu_torch.parallel.DeviceMesh` (its ranks, one device
    each) or a plain sequence of integer ids or ``torch.device``s (how a
    serving replica pool names a slice without building a mesh)."""
    if isinstance(mesh, (list, tuple, set, frozenset)):
        return frozenset(_device_id(d) for d in mesh)
    return frozenset(mesh.device_ids)


def local_execution_lock(mesh=None):
    """The collective-dispatch mutex for ``mesh``'s device set (see
    above). Hold it (``with local_execution_lock(mesh):``) around any
    host-driven loop that dispatches multi-device collective programs and
    may legally be called from concurrent threads.

    ``mesh=None`` is globally exclusive: it acquires the process lock plus every registered mesh
    lock, so it serializes against every mesh-keyed fit — and new mesh
    locks cannot register while it is held (registration synchronizes on
    the process lock), so no fit can slip past it. With a mesh (or a
    plain device sequence — a replica pool's per-slice placement),
    identical device sets share one tracked lock, disjoint sets get
    independent locks (concurrent fits over disjoint meshes — and pool
    replicas over disjoint slices — proceed in parallel), and a set that
    overlaps other registered sets gets a composite acquiring every
    intersecting lock in canonical order — overlapping fits always share
    at least one component lock, so the rendezvous-interleaving hazard
    cannot occur (and the shared token is visible to the analyzer's
    FML302/FML303 checks).
    """
    if mesh is None:
        return _GlobalLock()
    key = _device_id_set(mesh)
    with _MESH_LOCKS_GUARD:
        lock = _MESH_LOCKS.get(key)
    if lock is None:
        # First sighting of this device set: registering under the
        # process lock means a process-wide (mesh=None) holder — whose
        # composite predates this lock and so cannot contain it —
        # finishes before any fit over the new set can start. Lock order
        # is PROCESS then GUARD everywhere, never the reverse.
        with _PROCESS_LOCK:
            with _MESH_LOCKS_GUARD:
                lock = _MESH_LOCKS.get(key)
                if lock is None:
                    lock = _MESH_LOCKS[key] = TrackedRLock(
                        "lock:mesh:" + ",".join(str(i) for i in sorted(key))
                    )
    with _MESH_LOCKS_GUARD:
        overlapping = [
            l for k, l in _MESH_LOCKS.items() if k != key and (k & key)
        ]
    if overlapping:
        return _CompositeLock([lock] + overlapping)
    return lock


# -- slice leases ----------------------------------------------------------
#
# Training/serving colocation: a training job LEASES the
# mesh slice it runs on, so the serving autoscaler can see which devices
# are spoken for — and reclaim them under load. A lease is a cooperative
# contract, not a lock: the holder keeps dispatching (under its own
# local_execution_lock) until it observes `revoke_requested()` at a safe
# boundary (an epoch edge), releases the slice, and the reclaimer places
# serving work on the freed devices. Dispatch-trace events record any
# ACTIVE lease whose devices a *foreign* thread dispatches over, which is
# what the analyzer's FML304 check audits: serving-pool work landing on a
# still-leased slice means the reclaim handshake was skipped.

_LEASES: dict = {}  # token -> SliceLease
_LEASES_GUARD = threading.Lock()


class SliceLease:
    """One training job's claim on a device slice (see above). Create
    via :func:`lease_devices`; use as a context manager (releases on
    exit) or call :meth:`release` explicitly at the safe boundary."""

    def __init__(self, holder: str, device_ids):
        self.holder = str(holder)
        self.devices = frozenset(int(i) for i in device_ids)
        self.token = (
            f"lease:{self.holder}:"
            + ",".join(str(i) for i in sorted(self.devices))
        )
        self._revoke = threading.Event()
        self._released = threading.Event()
        self.revoke_reason: Optional[str] = None
        self._holder_thread = threading.get_ident()

    # -- holder side -------------------------------------------------------
    @property
    def active(self) -> bool:
        return not self._released.is_set()

    def revoke_requested(self) -> bool:
        """Poll at safe boundaries (epoch edges): True once a reclaimer
        asked for the slice back — finish the boundary, checkpoint, and
        :meth:`release`."""
        return self._revoke.is_set()

    def release(self) -> None:
        """Give the slice back (idempotent). Unregisters the lease, so
        later dispatches over these devices stop carrying its token."""
        with _LEASES_GUARD:
            _LEASES.pop(self.token, None)
        self._released.set()

    def __enter__(self) -> "SliceLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- reclaimer side ----------------------------------------------------
    def request_revoke(self, reason: str = "") -> None:
        """Ask the holder to vacate (sets the flag the holder polls);
        the reclaimer then :meth:`wait_released` with a bound."""
        if reason and self.revoke_reason is None:
            self.revoke_reason = reason
        self._revoke.set()

    def wait_released(self, timeout: Optional[float] = None) -> bool:
        return self._released.wait(timeout)

    def snapshot(self) -> dict:
        return {
            "token": self.token,
            "holder": self.holder,
            "devices": sorted(self.devices),
            "active": self.active,
            "revoke_requested": self.revoke_requested(),
            "revoke_reason": self.revoke_reason,
        }


def lease_devices(mesh, holder: str) -> SliceLease:
    """Register a :class:`SliceLease` for ``mesh``'s device set (a
    ``DeviceMesh``, raw mesh, or plain device/id sequence — the same
    subjects :func:`local_execution_lock` accepts)."""
    lease = SliceLease(holder, _device_id_set(mesh))
    with _LEASES_GUARD:
        if lease.token in _LEASES:
            raise ValueError(
                f"lease {lease.token!r} is already registered; release "
                "the existing lease before re-leasing the slice"
            )
        _LEASES[lease.token] = lease
    return lease


def active_leases() -> tuple:
    """Every currently registered (unreleased) lease."""
    with _LEASES_GUARD:
        return tuple(_LEASES.values())


def leased_device_ids() -> frozenset:
    """Union of every active lease's device ids — the autoscaler's
    'spoken for' set when choosing a placement."""
    with _LEASES_GUARD:
        out: set = set()
        for lease in _LEASES.values():
            out |= lease.devices
        return frozenset(out)


def _foreign_lease_tokens(ids) -> tuple:
    """Tokens of active leases overlapping ``ids`` held by OTHER
    threads — the holder's own dispatches are its business; anyone
    else's on a leased slice is the FML304 shape."""
    me = threading.get_ident()
    dev = set(ids)
    with _LEASES_GUARD:
        return tuple(
            l.token for l in _LEASES.values()
            if l._holder_thread != me and (l.devices & dev)
        )


# -- dispatch trace observers ----------------------------------------------
#
# Training loops report their collective dispatches here (cheap: a list
# check when no observer is installed). Observers receive plain event
# dicts in the JAX package's `analysis.collectives.DispatchEvent` schema,
# so tests can assert on the program shape.

_DISPATCH_OBSERVERS: list = []


def add_dispatch_observer(callback) -> None:
    """Register ``callback(event_dict)`` for collective dispatch events."""
    _DISPATCH_OBSERVERS.append(callback)


def remove_dispatch_observer(callback) -> None:
    _DISPATCH_OBSERVERS.remove(callback)


def has_dispatch_observers() -> bool:
    return bool(_DISPATCH_OBSERVERS)


def record_collective_dispatch(program: str, devices, collectives=()) -> None:
    """Report one host-driven dispatch of a collective program. ``devices``
    is an iterable of integer device ids (ranks) or ``torch.device``s; the
    event carries the calling thread and the tracked locks it holds."""
    if not _DISPATCH_OBSERVERS:
        return
    ids = tuple(_device_id(d) for d in devices)
    t = threading.current_thread()
    event = {
        "thread": f"{t.name}({t.ident})",
        "program": program,
        "devices": ids,
        "collectives": list(collectives),
        "locks": held_lock_tokens(),
        # Active leases OTHER threads hold over these devices: a
        # serving-pool program carrying one here is the FML304 shape
        # (dispatching on a slice training still owns).
        "leases": _foreign_lease_tokens(ids),
    }
    for cb in list(_DISPATCH_OBSERVERS):
        cb(event)


def default_sync_interval() -> int:
    """The framework's in-flight dispatch bound for this process.

    ``0`` means unbounded (one process: the local runtime queue is bound
    enough). A process group of several ranks defaults to ``8``, the JAX
    package's bound. Override with ``FLINKML_SYNC_INTERVAL`` (any positive
    integer, or ``0`` to disable).
    """
    from flinkml_tpu_torch.parallel.distributed import process_count

    env = os.environ.get(_ENV_INTERVAL)
    if env is not None:
        return max(0, int(env))
    if process_count() > 1:
        return _DEFAULT_MULTIPROCESS_INTERVAL
    return 0


def block_until_ready(carry: Any) -> Any:
    """Wait until every CUDA tensor of ``carry`` (nested dicts, lists and
    tuples) is computed: one stream synchronize per device. Returns
    ``carry``."""
    import torch

    devices = set()

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif torch.is_tensor(node) and node.device.type == "cuda":
            devices.add(node.device)

    walk(carry)
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    return carry


class DispatchGuard:
    """Counts dispatches and blocks on the carry every ``interval`` steps.

    Usage::

        guard = DispatchGuard()           # policy from default_sync_interval()
        for i in range(n_steps):
            carry = stepper(carry, batch)
            carry = guard.after_dispatch(carry)

    ``after_dispatch`` returns its argument unchanged so it can be chained
    into the loop carry assignment. Pass ``interval=0`` to make it a no-op
    (single-process default), or an explicit positive bound.
    """

    def __init__(self, interval: Optional[int] = None):
        self.interval = (
            default_sync_interval() if interval is None else max(0, int(interval))
        )
        self._since_sync = 0

    def after_dispatch(self, carry: Any) -> Any:
        if faults.ACTIVE is not None:  # the host-device transfer seam
            faults.fire("dispatch.transfer", count=self._since_sync + 1)
        self._since_sync += 1
        if self.interval and self._since_sync >= self.interval:
            block_until_ready(carry)
            self._since_sync = 0
        return carry

    def flush(self, carry: Any) -> Any:
        """Force a synchronization point (end of a training phase)."""
        if faults.ACTIVE is not None:
            faults.fire("dispatch.transfer", count=self._since_sync)
        if self._since_sync:
            block_until_ready(carry)
            self._since_sync = 0
        return carry


def synced_loop(
    n_steps: int,
    step_fn: Callable[[Any, int], Any],
    init: Any,
    interval: Optional[int] = None,
) -> Any:
    """Run ``carry = step_fn(carry, i)`` ``n_steps`` times with bounded
    in-flight dispatch.

    For bodies that stay host-driven (per-step data feeding, listeners) in
    a multi-process group: every ``interval`` dispatches the
    carry is materialized, so cross-process collectives can never pile up
    past the backend's safe queue depth. With ``interval=None`` the
    framework default applies (unbounded single-process, 8 multi-process).
    """
    guard = DispatchGuard(interval)
    carry = init
    for i in range(int(n_steps)):
        carry = guard.after_dispatch(step_fn(carry, i))
    return guard.flush(carry)
