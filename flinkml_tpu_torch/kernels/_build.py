"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes). Libraries land
in ``kernels/build/`` (git-ignored) under a name that carries a hash of the
source and the flags, so an edited source never loads a stale library.
The build happens at first use, or up front for every source at once with
:func:`build_all` (one ``nvcc`` process per source, all started together).
The measurement probes in ``probes/*.cu`` (not kernels of the port: each
times one floor of the card, such as its random-gather rate) build the
same way, by the same name scheme.

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
from typing import Dict, List, Sequence

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


def _library_path(name: str) -> str:
    h = hashlib.sha256()
    with open(_source_path(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, nvcc: str):
    """Start ``nvcc`` for ``name``; returns ``(process, tmp, final)`` or
    None when the library is already built."""
    final = _library_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish(name: str, started) -> None:
    proc, tmp, final = started
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed to build kernels/"
            f"{os.path.relpath(_source_path(name), os.path.dirname(CSRC_DIR))} "
            f"(exit {proc.returncode}):\n{out}"
        )
    # Atomic publish: a concurrent process never loads a partial file.
    os.replace(tmp, final)


def build_all() -> Dict[str, float]:
    """Build every kernel and probe library not built yet, one ``nvcc`` per
    source, all in parallel. Returns ``{name: seconds}`` (0.0 for a library
    that was already built)."""
    names = sources() + probes()
    with _LOCK:
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        started = {n: _start(n, nvcc) for n in names}
        times, errors = {}, []
        for n in names:
            if started[n] is None:
                times[n] = 0.0
                continue
            # Reap every nvcc before reporting a failure.
            try:
                _finish(n, started[n])
            except RuntimeError as e:
                errors.append(e)
                continue
            times[n] = time.perf_counter() - t0
        if errors:
            raise errors[0]
        return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        started = _start(name, nvcc_path())
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(_library_path(name))
        _LIBS[name] = lib
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
