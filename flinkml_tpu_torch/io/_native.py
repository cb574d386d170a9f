"""Compile-on-demand loader for the native (C++) ingest parsers.

The port's counterpart of ``flinkml_tpu.io._native``. Each parser is a
C++ source with a C ABI in ``flinkml_tpu_torch/native/<name>.cpp`` (the
port's own copies of the JAX package's parsers); the first use compiles it
with the system ``g++`` into ``flinkml_tpu_torch/native/build/`` (an
atomic rename, so concurrent processes never load a half-written file) and
caches the handle. Without a compiler, or where that directory cannot be
written, callers take their pure-Python parse: the native path is a
throughput optimization, never a requirement. These parsers are host
ingest, not device kernels.

:data:`PARSES` counts the parses by ``(format, route)`` — ``route`` is
``"native"`` or ``"python"`` — so a run can show which parser it used.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import threading
from typing import Callable, Dict, Optional

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
)
BUILD_DIR = os.path.join(_NATIVE_DIR, "build")

#: Parses by ``(format, route)``: ``("libsvm", "native")`` and so on.
PARSES: "collections.Counter" = collections.Counter()

_lock = threading.Lock()
_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def compile_and_load(
    name: str, declare: Callable[[ctypes.CDLL], None]
) -> Optional[ctypes.CDLL]:
    """Compile ``native/<name>.cpp`` (if the build is missing or older than
    the source) and load it; ``declare`` sets restype/argtypes on the
    handle. None when compiling or loading fails (the caller parses in
    Python); the failure is cached, so it is not retried per call."""
    with _lock:
        if name in _cache:
            return _cache[name]
        src = os.path.join(_NATIVE_DIR, f"{name}.cpp")
        so = os.path.join(BUILD_DIR, f"{name}.so")
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp_so = f"{so}.tmp.{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp_so, src, "-lpthread"],
                    check=True, capture_output=True,
                )
                os.replace(tmp_so, so)
            lib = ctypes.CDLL(so)
            declare(lib)
            _cache[name] = lib
        except (OSError, subprocess.CalledProcessError):
            _cache[name] = None
        return _cache[name]
