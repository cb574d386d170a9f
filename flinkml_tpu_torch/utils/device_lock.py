"""Single-tenant device-client mutex.

The port's counterpart of ``flinkml_tpu.utils.device_lock``: an exclusive
``flock`` on a well-known file that every process which may open the
card takes first, so two clients never contend for one device. A parent
that holds the lock marks the environment, so its child processes (which
inherit ``os.environ``) do not deadlock re-acquiring it.

The CPU-only skip reads the port's device choice: a process whose compute
device is the CPU (:func:`flinkml_tpu_torch.use_device` /
:func:`~flinkml_tpu_torch.set_default_device`) skips the lock, where the
JAX package reads ``JAX_PLATFORMS``. The lock file lives in the
temporary directory (``TMPDIR``) unless ``FLINKML_TPU_DEVICE_LOCK`` names
another.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import tempfile
import time

LOCK_PATH_ENV = "FLINKML_TPU_DEVICE_LOCK"
DEFAULT_LOCK_NAME = "flinkml_tpu_torch.device.lock"
_HELD_ENV = "_FLINKML_TPU_DEVICE_LOCK_HELD"


def _targets_cpu_only() -> bool:
    from flinkml_tpu_torch.device import requested_device

    return requested_device().type == "cpu"


def lock_path() -> str:
    return os.environ.get(LOCK_PATH_ENV) or os.path.join(
        tempfile.gettempdir(), DEFAULT_LOCK_NAME)


@contextlib.contextmanager
def device_client_lock(timeout_s: float = 900.0, poll_s: float = 0.5,
                       force: bool = False):
    """Hold the exclusive device-client lock for the duration of the block.

    Yields True when this process acquired the lock, False when it was
    skipped (a CPU process, or an ancestor already holds it). Raises
    ``TimeoutError`` if another client holds the lock past ``timeout_s``:
    the caller should NOT proceed to the device. ``force=True`` bypasses
    the CPU skip (for tests of the lock itself).
    """
    if not force:
        if _targets_cpu_only():
            yield False
            return
        if os.environ.get(_HELD_ENV):
            yield False
            return
    path = lock_path()
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o666)
    try:
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"device-client lock {path} held by another process "
                        f"for > {timeout_s:.0f}s; refusing to open a second "
                        "client against the single-tenant device"
                    )
                time.sleep(poll_s)
        try:
            os.ftruncate(fd, 0)
            os.write(fd, f"pid={os.getpid()}\n".encode())
        except OSError:
            pass  # lock content is diagnostic only
        os.environ[_HELD_ENV] = "1"
        try:
            yield True
        finally:
            os.environ.pop(_HELD_ENV, None)
            fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)
