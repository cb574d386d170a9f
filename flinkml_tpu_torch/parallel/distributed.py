"""Multi-process runtime: the process group, a control-plane barrier, data
slicing.

The port's counterpart of ``flinkml_tpu.parallel.distributed``, on
``torch.distributed``. The JAX package joins one ``jax.distributed``
coordination service per host and drives every local device from one
controller; here each rank is one process with one device (PyTorch's
idiom), and :func:`init_distributed` forms the default process group:

- the rendezvous address, world size and rank come from the arguments,
  else the framework's own environment family (``FLINKML_TPU_COORD_ADDR``
  / ``FLINKML_TPU_WORLD_SIZE`` / ``FLINKML_TPU_RANK``), else torch's
  (``MASTER_ADDR`` + ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``) in place
  of ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID``. The address is ``host:port`` (or ``tcp://...``) or
  a ``file://`` path of a store on a shared file system (no port needed);
- the backend follows the compute device: ``nccl`` for ``cuda``, ``gloo``
  for ``cpu``; an explicit ``backend=`` wins (``gloo`` over CUDA tensors
  runs several ranks on one card). ``nccl`` needs one card per rank on the
  host and raises ``ValueError`` before the group forms otherwise;
- with an address the group forms at any world size, one included (the
  JAX package skips world 1), so a world-1 run issues its collectives.

The JAX package's ``_enable_cpu_collectives`` has no counterpart: gloo is
the CPU backend of ``torch.distributed``. With no address configured
everything degrades to the one-process no-ops.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Tuple

from flinkml_tpu_torch.utils import logging as flog

_log = flog.get_logger("distributed")

# Substrings that mark a rendezvous failure as TRANSIENT (worth retrying:
# the store is still coming up, DNS lag, a dropped TCP handshake).
# Anything else (bad address, rank mismatch) fails fast.
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline",
    "timed out",
    "timeout",
    "connection refused",
    "connection reset",
    "failed to connect",
    "connect failed",
    "temporarily",
    "barrier",
)


def _is_transient_rendezvous_error(err: BaseException) -> bool:
    msg = str(err).lower()
    return any(marker in msg for marker in _TRANSIENT_MARKERS)


def retry_backoff_s(attempt: int, backoff_s: float,
                    jitter: float = 0.25,
                    rng: Optional["random.Random"] = None) -> float:
    """The jittered exponential delay before retry ``attempt`` (1-based):
    ``backoff_s * 2**(attempt-1) * (1 + U[0, jitter])``. The per-process
    draw keeps N ranks that hit the same transient failure from retrying
    in lockstep."""
    import random

    if backoff_s <= 0:
        return 0.0
    base = backoff_s * (2 ** (max(int(attempt), 1) - 1))
    r = (rng or random).random()
    return base * (1.0 + max(0.0, float(jitter)) * r)


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    """True when this process belongs to a default process group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _rank_world() -> Tuple[int, int]:
    if not is_initialized():
        return 0, 1
    dist = _dist()
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return _rank_world()[0]


def process_count() -> int:
    """The default group's world size (1 without one)."""
    return _rank_world()[1]


def _env(*names: str) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def _init_method(address: str) -> str:
    if address.startswith(("file://", "tcp://", "env://")):
        return address
    return f"tcp://{address}"


def default_backend() -> str:
    """``nccl`` when the port's compute device is ``cuda``, else
    ``gloo``."""
    from flinkml_tpu_torch.device import default_device

    return "nccl" if default_device().type == "cuda" else "gloo"


def _check_nccl_devices(world_size: int, rank: int) -> int:
    """The card of ``rank`` under nccl; ``ValueError`` when this host has
    fewer cards than ranks. The ranks on this host are
    ``LOCAL_WORLD_SIZE`` when a launcher sets it, else the whole world."""
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE") or world_size)
    if local_world > cards:
        raise ValueError(
            f"backend='nccl' runs one rank per CUDA device, but {local_world} "
            f"ranks share this host's {cards} device(s): two nccl ranks "
            "cannot share one card. Pass backend='gloo' to run several ranks "
            "on one device, or start one rank per card."
        )
    return int(os.environ.get("LOCAL_RANK") or rank % cards)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    max_attempts: int = 3,
    backoff_s: float = 1.0,
    backoff_jitter: float = 0.25,
    deadline_s: Optional[float] = None,
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> Tuple[int, int]:
    """Join the default ``torch.distributed`` process group.

    Call once per process, on every rank, before any collective. The
    arguments default from the environment (module docstring); with no
    address this is a one-process no-op. ``backend`` defaults from the
    compute device (``nccl`` for ``cuda``, ``gloo`` for ``cpu``); under
    ``nccl`` the rank's card is selected (``torch.cuda.set_device``) before
    the group forms. ``timeout_s`` bounds every collective of the group.

    Transient rendezvous failures are retried up to ``max_attempts`` times
    with exponential backoff plus per-process jitter
    (:func:`retry_backoff_s`); ``deadline_s`` caps the total time spent
    (attempts and sleeps): when the next backoff would overrun it, the last
    failure is raised. Non-transient errors fail on the first occurrence.

    Returns ``(rank, world_size)``.
    """
    dist = _dist()
    coordinator_address = coordinator_address or _env("FLINKML_TPU_COORD_ADDR")
    if coordinator_address is None and _env("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = int(num_processes if num_processes is not None else
                        _env("FLINKML_TPU_WORLD_SIZE", "WORLD_SIZE") or 1)
    process_id = int(process_id if process_id is not None else
                     _env("FLINKML_TPU_RANK", "RANK") or 0)
    if coordinator_address and not is_initialized():
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"invalid rank {process_id} of world size {num_processes}")
        backend = backend or default_backend()
        if backend == "nccl":
            import torch

            torch.cuda.set_device(_check_nccl_devices(num_processes,
                                                      process_id))
        kwargs = {}
        if timeout_s is not None:
            kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
        t0 = time.monotonic()
        for attempt in range(1, max_attempts + 1):
            try:
                dist.init_process_group(
                    backend, init_method=_init_method(coordinator_address),
                    world_size=num_processes, rank=process_id, **kwargs,
                )
                _log.info(
                    "rendezvous with %s succeeded (attempt %d/%d, rank %d of "
                    "%d, %s)", coordinator_address, attempt, max_attempts,
                    process_id, num_processes, backend,
                )
                break
            except Exception as e:  # noqa: BLE001 — classified below
                delay = retry_backoff_s(attempt, backoff_s, backoff_jitter)
                elapsed = time.monotonic() - t0
                overrun = deadline_s is not None and elapsed + delay > deadline_s
                if (attempt == max_attempts or overrun
                        or not _is_transient_rendezvous_error(e)):
                    _log.error(
                        "rendezvous with %s failed %s (attempt %d/%d, %.1fs "
                        "elapsed): %r", coordinator_address,
                        "permanently" if attempt == max_attempts
                        else (f"at the total deadline ({deadline_s}s)"
                              if overrun else "fast (non-transient)"),
                        attempt, max_attempts, elapsed, e,
                    )
                    raise
                _log.warning(
                    "transient rendezvous failure with %s (attempt %d/%d), "
                    "retrying in %.2fs (jittered): %r", coordinator_address,
                    attempt, max_attempts, delay, e,
                )
                time.sleep(delay)
    index, count = _rank_world()
    flog.set_rank(index, count)  # pin the log tag to the real rank
    return index, count


def shutdown_distributed() -> None:
    """Leave the default process group (a no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()
    flog.set_rank(0, 1)


def host_barrier(mesh=None, tag: int = 0) -> int:
    """Barrier over the mesh's first axis; returns ``tag`` summed over its
    ranks (``tag`` times the axis size).

    The data plane synchronizes itself; this is for the rare host-side
    rendezvous (every rank finished writing its checkpoint shard before a
    manifest commits). It is one small ``all_reduce`` on the mesh's device,
    so it rides the same fabric as the data plane. ``mesh`` defaults to a
    fresh all-ranks :class:`~flinkml_tpu_torch.parallel.DeviceMesh`.
    """
    import torch

    from flinkml_tpu_torch.parallel.collectives import psum
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh

    dm = mesh if mesh is not None else DeviceMesh()
    t = torch.full((1,), int(tag), dtype=torch.int32, device=dm.device)
    return int(psum(dm, t, axis=dm.axis_names[0]).cpu()[0])


def agree_resume_epoch(manager, mesh=None, old_world: Optional[int] = None,
                       new_world: Optional[int] = None) -> Optional[int]:
    """The survivors' rendezvous: the newest snapshot of ``manager`` that
    EVERY rank can restore.

    Each rank nominates its newest verified epoch
    (``manager.newest_valid_epoch()``); then every rank aborts together if
    any holds no valid snapshot (:func:`~flinkml_tpu_torch.iteration.
    stream_sync.agree_all_ok`), the minimum nomination is agreed
    (``agree_min``), and every rank checks it can verify that epoch. One
    process: the local newest valid epoch (None for a fresh start). Fires
    the ``rendezvous.rescale`` fault seam (both worlds in the context), so
    a test can script a shrink rendezvous that fails.
    """
    from flinkml_tpu_torch import faults

    local = manager.newest_valid_epoch()
    if faults.ACTIVE is not None:  # a scripted shrink-rendezvous failure
        faults.fire("rendezvous.rescale",
                    local_epoch=-1 if local is None else int(local),
                    old_world=old_world, new_world=new_world)
    if process_count() == 1:
        _log.info(
            "elastic resume rendezvous (single process): newest valid "
            "epoch %s under %s", local, manager.directory,
        )
        return local
    from flinkml_tpu_torch.iteration.stream_sync import agree_all_ok, agree_min

    agree_all_ok(
        local is not None, mesh,
        f"elastic resume: a valid snapshot under {manager.directory}",
    )
    agreed = agree_min(int(local), mesh)
    agree_all_ok(
        agreed == local or manager.verify(agreed), mesh,
        f"elastic resume: agreed snapshot epoch {agreed} restorable on "
        "every survivor",
    )
    _log.info(
        "elastic resume rendezvous: local newest valid epoch %s, agreed "
        "epoch %s (world %s -> %s)", local, agreed, old_world, new_world,
    )
    return agreed


def compact_rank(old_rank: int, lost_ranks) -> Optional[int]:
    """A survivor's rank in the shrunken world: its position among the
    surviving old ranks (dense, order-preserving: old rank 3 with rank 1
    lost becomes rank 2). None when ``old_rank`` is itself lost."""
    lost = set(int(r) for r in lost_ranks)
    old_rank = int(old_rank)
    if old_rank in lost:
        return None
    return old_rank - sum(1 for r in lost if r < old_rank)


def rescale_world(new_world: int, new_rank: int,
                  coordinator_address: Optional[str] = None,
                  **init_kwargs) -> Tuple[int, int]:
    """Re-join at a NEW world size: leave the old group (if any) and
    rendezvous again as rank ``new_rank`` of ``new_world`` (survivor ranks
    compacted by :func:`compact_rank`). World 1 with no address configured
    is a no-op returning ``(0, 1)``. The state's re-layout is the
    checkpoint's (``rescale="reshard"``,
    :func:`~flinkml_tpu_torch.iteration.checkpoint.reshard_rank_state`)."""
    new_world, new_rank = int(new_world), int(new_rank)
    if new_world < 1 or not (0 <= new_rank < new_world):
        raise ValueError(
            f"invalid rescaled assignment rank {new_rank} of {new_world}"
        )
    if is_initialized():
        _log.warning("leaving old world for rescale (rank %d of new %d)",
                     new_rank, new_world)
        shutdown_distributed()
    if new_world == 1 and not (
        coordinator_address or _env("FLINKML_TPU_COORD_ADDR", "MASTER_ADDR")
    ):
        flog.set_rank(0, 1)
        return 0, 1
    return init_distributed(
        coordinator_address=coordinator_address,
        num_processes=new_world,
        process_id=new_rank,
        **init_kwargs,
    )


def require_single_controller(what: str) -> None:
    """Raise ``RuntimeError`` when ``what`` runs in a process group of
    more than one rank: a path that places whole global batches from one
    process."""
    if process_count() > 1:
        _log.error("%s rejected in a multi-process group (single-process "
                   "only)", what)
        raise RuntimeError(
            f"{what} runs in one process: it places whole global batches "
            "from one controller. Run it with one rank, or use an in-RAM "
            "fit with mesh= (each rank trains on its block of the rows)."
        )


def process_slice(n: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> slice:
    """This rank's contiguous row range of a global dataset of ``n`` rows
    (the reference's per-subtask stream partitions). Remainder rows go to
    the low ranks, one each."""
    rank, world = _rank_world()
    p = rank if process_index is None else process_index
    c = world if process_count is None else process_count
    base, rem = divmod(n, c)
    start = p * base + min(p, rem)
    return slice(start, start + base + (1 if p < rem else 0))
