"""The g++ stand-in kernel and the fresh-process scenarios behind
``tests/test_torch_compile_cache.py``. Imports no JAX.

The host that runs the CPU tests has no ``nvcc``, so the store is driven
through :mod:`flinkml_tpu_torch.kernels._build` pointed at a tiny C++
library (``tiny.cu``) that ``g++ -shared`` builds: the same store calls,
the same ``ctypes`` loads, the same entries on disk.

    python tests/_torch_compile_cache_child.py warm <src dir> <build dir>
    python tests/_torch_compile_cache_child.py race <src dir> <build dir>

``warm`` runs in a fresh process on a store (``FLINKML_TPU_COMPILE_CACHE``)
that its parent filled: it loads the library, then serves it from a
``ReplicaPool`` scaled from 1 to 3 replicas, and prints one JSON report.
``race`` loads the library through the store and prints its outcome;
several started together on an empty store must pay one build between
them.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys

import numpy as np

SOURCE = r"""
#include <cstdint>
extern "C" double fml_scale(double x) { return x * 1.2345678 + 2.0; }
extern "C" void fml_scale_array(const double* x, double* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = x[i] * 1.2345678 + 2.0;
}
"""

#: g++ flags for the stand-in: C++, no contraction into fused
#: multiply-adds (the library's doubles equal numpy's bit for bit).
FLAGS = ("-x", "c++", "-O2", "-ffp-contract=off", "-shared", "-fPIC")


def expected(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float64) * 1.2345678 + 2.0


def write_source(src_dir: str) -> None:
    os.makedirs(os.path.join(src_dir, "probes"), exist_ok=True)
    with open(os.path.join(src_dir, "tiny.cu"), "w") as f:
        f.write(SOURCE)


def use_gxx(setattr_, build_mod, src_dir: str, build_dir: str) -> None:
    """Point ``_build`` at the stand-in (``setattr_`` is ``setattr`` or a
    pytest ``monkeypatch.setattr``): sources, build dir, compiler, flags,
    and fresh per-process caches."""
    gxx = shutil.which("g++")
    setattr_(build_mod, "CSRC_DIR", src_dir)
    setattr_(build_mod, "PROBE_DIR", os.path.join(src_dir, "probes"))
    setattr_(build_mod, "BUILD_DIR", build_dir)
    setattr_(build_mod, "NVCC_FLAGS", FLAGS)
    setattr_(build_mod, "nvcc_path", lambda: gxx)
    setattr_(build_mod, "_LIBS", {})
    setattr_(build_mod, "_FUNCS", {})
    setattr_(build_mod, "_NVCC_RUNS", [0])


def scale(build_mod, x: np.ndarray) -> np.ndarray:
    fn = build_mod.function("tiny", "fml_scale_array",
                            [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int64], restype=None)
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty_like(x)
    fn(x.ctypes.data, out.ctypes.data, x.size)
    return out


class LibScale:
    """A stage whose transform runs the stand-in library (loaded through
    the store at its first call)."""

    def __init__(self, build_mod):
        self.build_mod = build_mod

    def transform(self, table):
        return (table.with_column(
            "scaled", scale(self.build_mod, table.column("features"))),)


def counters() -> dict:
    from flinkml_tpu_torch.utils.metrics import metrics

    return dict(metrics.group("compile_cache").snapshot()["counters"])


def warm(src_dir: str, build_dir: str) -> dict:
    import flinkml_tpu_torch as fml
    from flinkml_tpu_torch.kernels import _build
    from flinkml_tpu_torch.serving import ReplicaPool, ServingConfig
    from flinkml_tpu_torch.table import Table

    use_gxx(setattr, _build, src_dir, build_dir)
    fml.set_default_device("cpu")
    outcomes = _build.load_all()
    after_load = counters()
    x = np.random.default_rng(3).normal(size=(64, 3))
    loaded_bitwise = scale(_build, x).tobytes() == expected(x).tobytes()
    pool = ReplicaPool(
        LibScale(_build), Table({"features": x[:4]}),
        config=ServingConfig(max_batch_rows=32, max_queue_rows=256,
                             max_wait_ms=1.0),
        n_replicas=1, output_cols=("scaled",), name="cc-scale",
    ).start()
    try:
        before_scale = _build.nvcc_runs()
        pool.add_replica()
        pool.add_replica()
        outs = [r.engine.predict({"features": x[:17]}).columns["scaled"]
                for r in pool.replicas]
    finally:
        pool.stop(drain=False)
    return {
        "outcomes": outcomes,
        "nvcc_runs": _build.nvcc_runs(),
        "new_builds_on_scale_up": _build.nvcc_runs() - before_scale,
        "hits": after_load.get("hits", 0),
        "misses": after_load.get("misses", 0),
        "replicas": len(outs),
        "loaded_bitwise": loaded_bitwise,
        "scaled_replica_parity_bitwise": all(
            o.tobytes() == outs[0].tobytes() for o in outs),
        "served_bitwise": outs[0].tobytes() == expected(x[:17]).tobytes(),
    }


def race(src_dir: str, build_dir: str) -> dict:
    from flinkml_tpu_torch.kernels import _build

    use_gxx(setattr, _build, src_dir, build_dir)
    outcome = _build._load("tiny", _build.store())
    x = np.arange(9, dtype=np.float64)
    return {"outcome": outcome, "nvcc_runs": _build.nvcc_runs(),
            "bitwise": scale(_build, x).tobytes() == expected(x).tobytes()}


if __name__ == "__main__":
    mode, src, build = sys.argv[1:4]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tests._torch_threads import cap_torch_threads

    cap_torch_threads()
    print(json.dumps({"warm": warm, "race": race}[mode](src, build)))
