"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes). Every library is
built into and loaded from a compile-cache store
(:mod:`flinkml_tpu_torch.compile_cache`): the active store when one is
configured (``FLINKML_TPU_COMPILE_CACHE`` or
:func:`~flinkml_tpu_torch.compile_cache.configure`), else
:func:`default_store`, rooted at ``kernels/build/`` (git-ignored). The
store keys a library by :func:`program_key` (the source's hash and the
flags, so an edited source never loads a stale library) and by its
environment (torch, CUDA, ``nvcc``, card, driver), checks it before it is
loaded and rebuilds a torn one. The build happens at first use, or up
front for every source at once with :func:`build_all` (one ``nvcc``
process per source, all started together). The measurement probes in
``probes/*.cu`` (not kernels of the port: each times one floor of the
card, such as its random-gather rate) build the same way.

Every C entry point takes ``c_void_p`` for each pointer and for the CUDA
stream, ``c_int``/``c_int64`` for sizes, launches on the given stream, and
returns ``cudaGetLastError()``; :func:`check` raises when that is not 0.

``-fmad=false`` keeps ``nvcc`` from contracting ``a*b+c`` into one fused
multiply-add: the kernels round each operation as the JAX package's
elementwise ops and the plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

from flinkml_tpu_torch import compile_cache

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
PROBE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probes")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}
#: ``nvcc``'s output (with ``ptxas -v``'s registers/spills) per library
#: built in this process.
BUILD_LOGS: Dict[str, str] = {}
_NVCC_RUNS = [0]
_DEFAULT: List[Optional[compile_cache.CompileCacheStore]] = [None]


def nvcc_runs() -> int:
    """``nvcc`` processes this process has started: 0 in a process that
    only loaded libraries from a store (a cluster worker whose pool built
    them first)."""
    return _NVCC_RUNS[0]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``, or
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels build from source at first "
        "use and need the CUDA toolkit"
    )


def _cu_names(directory: str) -> List[str]:
    return sorted(f[:-3] for f in os.listdir(directory) if f.endswith(".cu"))


def sources() -> List[str]:
    """Kernel library names: one per ``csrc/*.cu``."""
    return _cu_names(CSRC_DIR)


def probes() -> List[str]:
    """Measurement probe library names: one per ``probes/*.cu``."""
    return _cu_names(PROBE_DIR)


def _source_path(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    return path if os.path.exists(path) else os.path.join(PROBE_DIR,
                                                          f"{name}.cu")


def program_key(name: str, extra_flags: Sequence[str] = ()) -> tuple:
    """The store key of library ``name``: its source's sha256 and the
    ``nvcc`` flags (plus ``extra_flags``, as a ``--variants`` entry of
    ``chip_smoke.py`` adds)."""
    with open(_source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return ("kernel_library", name, digest,
            tuple(NVCC_FLAGS) + tuple(extra_flags))


def default_store() -> compile_cache.CompileCacheStore:
    """The store rooted at :data:`BUILD_DIR`, used when none is
    configured."""
    with _LOCK:
        store = _DEFAULT[0]
        if store is None or store.directory != os.path.abspath(BUILD_DIR):
            store = _DEFAULT[0] = compile_cache.CompileCacheStore(BUILD_DIR)
        return store


def store() -> compile_cache.CompileCacheStore:
    """The store the kernels build into: the active one, else
    :func:`default_store`."""
    return compile_cache.active_store() or default_store()


def _library_path(name: str) -> str:
    """Where library ``name`` lives in :func:`default_store`."""
    return default_store().entry_path(program_key(name))


def _compile(name: str, extra_flags: Sequence[str] = ()):
    """The store's build callable for ``name``: one ``nvcc`` run."""

    def build(out: str) -> None:
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", out,
               _source_path(name)]
        with _LOCK:
            _NVCC_RUNS[0] += 1
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              check=False)
        BUILD_LOGS[name] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build kernels/"
                f"{os.path.relpath(_source_path(name), os.path.dirname(CSRC_DIR))} "
                f"(exit {proc.returncode}):\n{proc.stdout}"
            )

    return build


def _load(name: str, target: compile_cache.CompileCacheStore) -> str:
    """Load ``name`` through ``target`` into this process; the outcome."""
    lib, outcome = target.get_or_compile(program_key(name), _compile(name))
    with _LOCK:
        _LIBS.setdefault(name, lib)
    return outcome


def build_all(target: Optional[compile_cache.CompileCacheStore] = None
              ) -> Dict[str, float]:
    """Build every kernel and probe library ``target`` (default:
    :func:`store`) does not hold yet, one ``nvcc`` per source, all in
    parallel, and load each into this process. Returns ``{name: seconds}``
    (seconds from the start to that library's build; 0.0 for a library the
    store already held)."""
    target = target or store()
    target.entry_path(("probe",))  # the environment, once, on this thread
    names = sources() + probes()
    t0 = time.perf_counter()

    def one(name: str) -> float:
        outcome = _load(name, target)
        return time.perf_counter() - t0 if outcome == "compiled" else 0.0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {n: pool.submit(one, n) for n in names}
        times, errors = {}, []
        for n, f in futures.items():
            # Wait for every nvcc before reporting a failure.
            try:
                times[n] = f.result()
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
    return times


def load_all() -> Dict[str, str]:
    """Load every kernel library (not the probes) through :func:`store`;
    ``{name: outcome}`` (``"memory"``, ``"disk"`` or ``"compiled"``; a
    library this process had loaded already reads ``"loaded"``)."""
    out = {}
    for name in sources():
        with _LOCK:
            loaded = name in _LIBS
        out[name] = "loaded" if loaded else _load(name, store())
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is None:
        _load(name, store())
        with _LOCK:
            lib = _LIBS[name]
    return lib


def function(name: str, symbol: str, argtypes: Sequence,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name`` with its
    ``argtypes`` declared and a ``restype`` result (by default an ``int``:
    a CUDA error code)."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FUNCS[key] = fn
    return fn


def check(site: str, name: str, code: int) -> None:
    """Raise when a launch of library ``name`` returned a CUDA error (a
    refused launch never runs, and a later synchronize would not report
    it)."""
    if code != 0:
        err = library(name).fml_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        text = err(code).decode(errors="replace")
        raise RuntimeError(
            f"kernels[{site}]: kernel launch failed with CUDA error {code}: "
            f"{text}"
        )
