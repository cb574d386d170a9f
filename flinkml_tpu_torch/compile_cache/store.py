"""The on-disk store of built kernel libraries behind
:mod:`flinkml_tpu_torch.compile_cache`.

The port's counterpart of ``flinkml_tpu.compile_cache.store``. The JAX
package stores serialized XLA executables; the port's compiled artifact is
a **built kernel library**: the ``.so`` that ``nvcc`` makes from
``kernels/csrc/*.cu`` (or ``kernels/probes/*.cu``), loaded with ``ctypes``.
The port's fused chains and plan steps are eager PyTorch over those
kernels, so they have no compiled artifact of their own and stay cached
in memory only.

Key schema
----------

A library is addressed by TWO fingerprints:

1. The **program key**: ``("kernel_library", name, sha256 of the source,
   flags)`` with the ``nvcc`` flags and any extra ones
   (:func:`flinkml_tpu_torch.kernels._build.program_key`), rendered
   canonically by :func:`stable_key_repr` and hashed.
2. The **environment fingerprint** (:func:`env_fingerprint`): the torch
   version, ``torch.version.cuda``, the ``nvcc`` release, the device name,
   its compute capability and the CUDA driver version. A library built by
   another toolkit, torch, driver or card MUST miss, never load. On a host
   without a card the device fields read ``cpu``.

On disk: ``<dir>/<env_hash>/<key_hash>.so`` and its entry
``<key_hash>.json``, which records the env dict, the key, the card it was
built on and the library's sha256, plus ``ENV.json`` describing the
environment for operators. A copied-in or bit-rotted library is refused at
read time even if it lands in the right directory.

Invalidation rules
------------------

- env mismatch (another ``env_hash``, or an embedded env dict that
  disagrees at read time) -> **miss** (counted ``env_mismatches``);
- torn or corrupt entry (unreadable entry, sha mismatch, a library that
  will not load) -> **miss**, logged loudly, the entry is deleted and
  rebuilt by the caller's build (counted ``corrupt_entries``). The sha is
  checked BEFORE ``ctypes.CDLL``: glibc caches a path once it has opened
  it, so a library must be right before it is ever loaded;
- no persistence on this platform (:func:`serialization_supported`) ->
  every library is built into a private directory and loaded from there,
  logged loudly ONCE (counted ``fallbacks``).

A build that fails, or whose library does not load, raises: there is
never a fallback to a kernel's plain version.

Concurrency: a library is built to a temp file in the cache directory,
loaded once to prove it, and published with ``os.replace`` before its
entry is (the ``CheckpointManager`` idiom), so a reader never sees a torn
entry. In one process a per-key lock makes racing builders share ONE
build; across processes a per-key ``flock`` does the same, so N processes
starting together pay one ``nvcc`` run per library.

Retargeting: a library serves every card of its kind. A disk hit built on
another card (``device_identity``) is counted ``retarget_loads``.

Metrics (``metrics.group("compile_cache")``): ``hits`` / ``misses`` /
``stores`` / ``corrupt_entries`` / ``env_mismatches`` / ``fallbacks`` /
``retarget_loads`` counters and ``load_ms`` / ``compile_ms`` gauges (last
observed; full series under the same-named histories).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import metrics

_log = get_logger("compile_cache")

#: Setting this env var to a directory path activates a process-wide
#: disk-backed store lazily (no code changes at the build sites).
ENV_DIR_VAR = "FLINKML_TPU_COMPILE_CACHE"

_FORMAT = 1

_SUPPORT = [None]  # tri-state probe cache: None unknown, True/False known
_WARNED_UNSUPPORTED = [False]
_NVCC_RELEASE: Dict[str, str] = {}


def serialization_supported() -> bool:
    """Whether a built library can be kept as a file and loaded by later
    processes: a POSIX dynamic loader, under which a loaded library's file
    can be replaced (``os.replace``) without disturbing the processes that
    mapped it. Probed once; a False answer downgrades every store to
    build-only with one loud log line."""
    if _SUPPORT[0] is None:
        _SUPPORT[0] = os.name == "posix"
        if not _SUPPORT[0] and not _WARNED_UNSUPPORTED[0]:
            _WARNED_UNSUPPORTED[0] = True
            _log.warning(
                "built kernel libraries cannot be kept on this platform; "
                "the compile cache degrades to build-only (every process "
                "runs its own nvcc)"
            )
    return bool(_SUPPORT[0])


def _nvcc_release() -> str:
    """``nvcc --version``'s release line, or ``none`` without a toolkit."""
    from flinkml_tpu_torch.kernels._build import nvcc_path

    try:
        nvcc = nvcc_path()
    except RuntimeError:
        return "none"
    if nvcc not in _NVCC_RELEASE:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=False).stdout
        lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
        _NVCC_RELEASE[nvcc] = lines[-1] if lines else "unknown"
    return _NVCC_RELEASE[nvcc]


def _driver_version() -> str:
    """The CUDA driver API version (``cuDriverGetVersion``), e.g. ``12.8``."""
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return "unknown"
    version = ctypes.c_int()
    if libcuda.cuDriverGetVersion(ctypes.byref(version)) != 0:
        return "unknown"
    return f"{version.value // 1000}.{version.value % 1000 // 10}"


def env_fingerprint() -> Dict[str, str]:
    """The environment half of the library key (see module docstring):
    everything that changes what machine code ``nvcc`` produces or whether
    the produced library can load and run."""
    import torch

    env = {
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda),
        "nvcc": _nvcc_release(),
        "device_name": "cpu",
        "capability": "cpu",
        "driver": "cpu",
    }
    if torch.cuda.is_available():
        index = torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(index)
        env.update(device_name=torch.cuda.get_device_name(index),
                   capability=f"sm_{major}{minor}",
                   driver=_driver_version())
    return env


def device_identity() -> str:
    """The card a library is built or loaded on: its UUID, or ``cpu``."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return str(getattr(props, "uuid", props.name))


def _env_hash(env: Dict[str, str]) -> str:
    blob = "\x00".join(f"{k}={env[k]}" for k in sorted(env))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def stable_key_repr(key: Any) -> str:
    """A canonical, process-independent rendering of a cache key: frozen
    dataclasses as sorted ``(field, value)`` pairs, dicts sorted by key, so
    two processes building the same identity always hash to the same
    library. The same string as the JAX package's for the same key."""
    out: list = []

    def walk(v: Any) -> str:
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            fields = sorted(
                (f.name, getattr(v, f.name)) for f in dataclasses.fields(v)
            )
            inner = ",".join(f"{n}={walk(x)}" for n, x in fields)
            return f"{type(v).__name__}({inner})"
        if isinstance(v, dict):
            inner = ",".join(
                f"{walk(k)}:{walk(v[k])}" for k in sorted(v, key=repr)
            )
            return f"{{{inner}}}"
        if isinstance(v, (tuple, list)):
            return "(" + ",".join(walk(x) for x in v) + ")"
        if isinstance(v, (str, bytes, int, float, bool)) or v is None:
            return repr(v)
        return f"{type(v).__name__}:{v!r}"

    out.append(walk(key))
    return "".join(out)


def _key_hash(key: Any) -> str:
    return hashlib.sha256(stable_key_repr(key).encode()).hexdigest()[:24]


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _unlink(*paths: str) -> None:
    for p in paths:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(p)


class CompileCacheStore:
    """Disk-backed (or memory-only) store of built kernel libraries.

    ``directory=None`` is a process-local store: a library is built into a
    private temporary directory, loaded, and its file removed, so nothing
    persists, but every consumer of the process shares the one build. With
    a directory, libraries persist under ``<directory>/<env_hash>/`` and a
    FRESH process loads them instead of running ``nvcc``.
    """

    def __init__(self, directory: Optional[str] = None):
        self.directory = os.path.abspath(directory) if directory else None
        self._metrics = metrics.group("compile_cache")
        self._lock = threading.Lock()
        self._key_locks: Dict[str, threading.Lock] = {}
        # key hash -> loaded library: what the process's consumers share.
        self._memory: Dict[str, ctypes.CDLL] = {}
        self._env: Optional[Dict[str, str]] = None

    # -- plumbing ----------------------------------------------------------
    def _environment(self) -> Dict[str, str]:
        if self._env is None:
            self._env = env_fingerprint()
        return self._env

    def _key_lock(self, khash: str) -> threading.Lock:
        with self._lock:
            lock = self._key_locks.get(khash)
            if lock is None:
                lock = self._key_locks[khash] = threading.Lock()
            return lock

    def drop_memory(self) -> None:
        """Drop the in-process layer (tests counting builds want a clean
        slate); on-disk libraries survive."""
        with self._lock:
            self._memory.clear()

    def entry_path(self, key: Any) -> Optional[str]:
        """The on-disk path of ``key``'s library (None for a memory-only
        store). Exists only after a successful store."""
        if self.directory is None:
            return None
        env_dir = os.path.join(self.directory,
                               _env_hash(self._environment()))
        return os.path.join(env_dir, f"{_key_hash(key)}.so")

    @contextlib.contextmanager
    def _process_lock(self, key: Any):
        """The per-key lock between processes (a no-op without a
        directory): the first process builds, the others wait and load."""
        path = self.entry_path(key)
        if path is None:
            yield
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path[:-3] + ".lock", "a") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh, fcntl.LOCK_UN)

    # -- disk --------------------------------------------------------------
    def _read_disk(self, key: Any) -> Optional[Tuple[str, Dict[str, Any]]]:
        """``(library path, entry)`` of a whole, same-environment entry;
        None on a miss. A corrupt entry is deleted here."""
        path = self.entry_path(key)
        if path is None:
            return None
        meta = path[:-3] + ".json"
        if not os.path.exists(meta):
            return None
        try:
            with open(meta) as fh:
                entry = json.load(fh)
            if not isinstance(entry, dict) or entry.get("format") != _FORMAT:
                raise ValueError(f"bad entry format {type(entry).__name__}")
            if _sha256_file(path) != entry["sha256"]:
                raise ValueError("library sha256 mismatch (torn or bit rot?)")
        except (OSError, ValueError, KeyError, TypeError) as e:
            self._corrupt(path, e)
            return None
        if entry.get("env") != self._environment():
            # A copied-in library from another environment: the path hash
            # should already have missed; the embedded env is the second
            # line of defense.
            self._metrics.counter("env_mismatches")
            _log.warning(
                "compile-cache entry %s was built for a different "
                "environment (%s); ignoring it", path, entry.get("env"),
            )
            return None
        return path, entry

    def _corrupt(self, path: str, err: BaseException) -> None:
        self._metrics.counter("corrupt_entries")
        _log.warning(
            "corrupt compile-cache entry %s (%s: %s); deleting it and "
            "building it fresh", path, type(err).__name__, err,
        )
        _unlink(path[:-3] + ".json", path)

    def _load(self, key: Any) -> Optional[Tuple[ctypes.CDLL, str]]:
        """The disk layer: a whole entry's library, loaded, or None."""
        t0 = time.perf_counter()
        found = self._read_disk(key)
        if found is None:
            return None
        path, entry = found
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            self._corrupt(path, e)
            return None
        if entry.get("built_on") != device_identity():
            self._metrics.counter("retarget_loads")
        self._hit(t0)
        return lib, "disk"

    def _hit(self, t0: float) -> None:
        load_ms = (time.perf_counter() - t0) * 1000.0
        self._metrics.counter("hits")
        self._metrics.gauge("load_ms", load_ms)
        self._metrics.record("load_ms", load_ms)

    def _build(self, key: Any, build: Callable[[str], None],
               where: str) -> Tuple[ctypes.CDLL, str]:
        """Run ``build`` into a temp file under ``where`` and load it (a
        library that does not load is never published). Returns
        ``(library, temp path)``."""
        self._metrics.counter("misses")
        fd, tmp = tempfile.mkstemp(dir=where, prefix=".tmp-lib-",
                                   suffix=".so")
        os.close(fd)
        t0 = time.perf_counter()
        try:
            build(tmp)
            compile_ms = (time.perf_counter() - t0) * 1000.0
            self._metrics.gauge("compile_ms", compile_ms)
            self._metrics.record("compile_ms", compile_ms)
            try:
                lib = ctypes.CDLL(tmp)
            except OSError as e:
                raise RuntimeError(
                    f"the library built for {stable_key_repr(key)[:160]} "
                    f"does not load ({e}); nothing was stored"
                ) from e
        except BaseException:
            _unlink(tmp)
            raise
        return lib, tmp

    def _publish(self, key: Any, tmp: str) -> None:
        path = self.entry_path(key)
        env_dir = os.path.dirname(path)
        env_json = os.path.join(env_dir, "ENV.json")
        if not os.path.exists(env_json):
            fd, tmp_env = tempfile.mkstemp(dir=env_dir, prefix=".tmp-env-")
            with os.fdopen(fd, "w") as fh:
                json.dump(self._environment(), fh, indent=2, sort_keys=True)
            os.replace(tmp_env, env_json)
        entry = {
            "format": _FORMAT,
            "env": dict(self._environment()),
            "key": stable_key_repr(key),
            "built_on": device_identity(),
            "sha256": _sha256_file(tmp),
        }
        # The library first, then its entry: a reader that sees the entry
        # sees the whole library it names.
        os.replace(tmp, path)
        fd, tmp_meta = tempfile.mkstemp(dir=env_dir, prefix=".tmp-entry-")
        with os.fdopen(fd, "w") as fh:
            json.dump(entry, fh, indent=2, sort_keys=True)
        os.replace(tmp_meta, path[:-3] + ".json")
        self._metrics.counter("stores")

    def _build_private(self, key: Any, build: Callable[[str], None]
                       ) -> ctypes.CDLL:
        """Build into a private directory, load, and remove the file: the
        loaded mapping outlives it."""
        where = tempfile.mkdtemp(prefix="flinkml-kernels-")
        try:
            lib, _ = self._build(key, build, where)
        finally:
            shutil.rmtree(where, ignore_errors=True)
        return lib

    # -- the public entry point --------------------------------------------
    def get_or_compile(
        self,
        key: Any,
        build: Callable[[str], None],
    ) -> Tuple[ctypes.CDLL, str]:
        """Load ``key``'s library (memory, then disk) or ``build`` it.

        ``build(path)`` writes a shared library at ``path`` (``nvcc ...
        -o path``) and raises when it cannot. Returns ``(library,
        outcome)`` with outcome one of ``"memory"``, ``"disk"``,
        ``"compiled"`` or ``"uncached"`` (persistence unavailable: built
        privately, not stored)."""
        if not serialization_supported():
            self._metrics.counter("fallbacks")
            return self._build_private(key, build), "uncached"
        khash = _key_hash(key)
        with self._key_lock(khash):
            t0 = time.perf_counter()
            with self._lock:
                lib = self._memory.get(khash)
            if lib is not None:
                self._hit(t0)
                return lib, "memory"
            if self.directory is None:
                lib, outcome = self._build_private(key, build), "compiled"
            else:
                with self._process_lock(key):
                    # Another process may have built it while we waited.
                    loaded = self._load(key)
                    if loaded is None:
                        path = self.entry_path(key)
                        lib, tmp = self._build(key, build,
                                               os.path.dirname(path))
                        self._publish(key, tmp)
                        loaded = (lib, "compiled")
                lib, outcome = loaded
            with self._lock:
                self._memory[khash] = lib
            return lib, outcome


# -- the process-wide active store -------------------------------------------

_ACTIVE: list = [None]
_CONFIGURED = [False]  # explicit configure() beats the env var


def configure(store: "CompileCacheStore | str | None") -> Optional[
        CompileCacheStore]:
    """Install the process-wide store: a :class:`CompileCacheStore`, a
    directory path, or None (the kernels build into their default store,
    ``kernels/build/``). Returns the installed store."""
    if isinstance(store, str):
        store = CompileCacheStore(store)
    _ACTIVE[0] = store
    _CONFIGURED[0] = True
    return store


def active_store() -> Optional[CompileCacheStore]:
    """The process-wide store the build sites consult: whatever
    :func:`configure` installed, else a disk store at
    ``$FLINKML_TPU_COMPILE_CACHE`` (created lazily), else None."""
    if _CONFIGURED[0]:
        return _ACTIVE[0]
    directory = os.environ.get(ENV_DIR_VAR)
    if directory:
        _ACTIVE[0] = CompileCacheStore(directory)
        _CONFIGURED[0] = True
        return _ACTIVE[0]
    return _ACTIVE[0]


def ensure_store() -> CompileCacheStore:
    """The active store, installing the kernels' default one
    (``kernels/build/``, :func:`flinkml_tpu_torch.kernels._build.
    default_store`) when nothing is configured: what
    :class:`~flinkml_tpu_torch.serving.pool.ReplicaPool` calls at start so
    every replica of the process shares one build of each kernel. The JAX
    package installs a memory-only store here; a built library is a file
    either way, so the port keeps it where the next process finds it."""
    store = active_store()
    if store is None:
        from flinkml_tpu_torch.kernels._build import default_store

        store = configure(default_store())
    return store


def reset() -> None:
    """Forget the process-wide store AND re-arm the env-var lookup
    (tests)."""
    _ACTIVE[0] = None
    _CONFIGURED[0] = False
