"""Card tests of the compile-cache store, the tuning table's card key and
the profiling utilities on the four real kernel libraries.

Every test needs an NVIDIA GPU and skips (from a fixture, at run time)
without one. The file imports neither JAX nor the JAX package (the card's
machine has no JAX): run it there with
``python -m pytest tests/test_torch_compile_cache_cuda.py -m cuda
--noconftest -q``. The fresh-process cases run ``chip_smoke.py``'s path X
children (``--x1-child``, ``--x2-child``) on a store of their own.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture
def filled_store(cuda_device, tmp_path):
    """A store directory holding every kernel library: this process's
    store's entries (built here once if need be) copied into a fresh
    directory."""
    from flinkml_tpu_torch.kernels import _build

    _build.build_all()
    src = os.path.dirname(_build.store().entry_path(
        _build.program_key("spmv")))
    dst = tmp_path / "store" / os.path.basename(src)
    shutil.copytree(src, dst)
    for lock in glob.glob(str(dst / "*.lock")):
        os.unlink(lock)
    return str(tmp_path / "store")


def _child(mode, store, **env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, FML_X_SPAWNED=repr(time.time()),
               FLINKML_TPU_COMPILE_CACHE=store, **env_extra)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                           f"--{mode}"], capture_output=True, text=True,
                          timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fresh_process_loads_every_kernel_from_the_store(filled_store,
                                                         tmp_path):
    """A fresh process on a filled store loads the four libraries with no
    ``nvcc`` run, launches each against its plain version, and scales a
    pool from 1 to 3 replicas with no build, bit for bit."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from flinkml_tpu_torch.autotune.search import _serving_model

    model, x = _serving_model()
    path = str(tmp_path / "model")
    model.save(path)
    np.save(path + ".npy", x[:chip_smoke.X_SERVE_ROWS])
    rep = _child("x1-child", filled_store, FML_X_MODEL=path)
    assert rep["nvcc_runs"] == 0
    assert rep["hits"] >= 4 and rep["misses"] == 0
    assert set(rep["outcomes"].values()) == {"disk"}
    assert rep["replicas"] == 3 and rep["new_builds_on_scale_up"] == 0
    assert rep["scaled_bitwise"]
    assert all(rep["launches"][k] > 0 for k in
               ("spmv", "segment_sum", "topk", "fused_chain"))


def test_truncated_library_is_rebuilt_on_card(filled_store):
    """A truncated ``spmv`` library is rebuilt by one ``nvcc`` run in a
    fresh process, counted as one corrupt entry, and the rebuilt kernel
    holds against the plain version."""
    (so,) = [p for p in glob.glob(os.path.join(filled_store, "*", "*.so"))
             if json.load(open(p[:-3] + ".json"))["key"].startswith(
                 "('kernel_library','spmv'")]
    with open(so, "r+b") as fh:
        fh.truncate(os.path.getsize(so) // 2)
    rep = _child("x2-child", filled_store)
    assert rep["outcome"] == "compiled"
    assert rep["nvcc_runs"] == 1 and rep["corrupt_entries"] == 1
    assert rep["max_abs_err"] <= 1e-3


def test_env_fingerprint_names_the_card(cuda_device):
    from flinkml_tpu_torch import compile_cache

    env = compile_cache.env_fingerprint()
    assert env["device_name"] == torch.cuda.get_device_name(0)
    major, minor = torch.cuda.get_device_capability(0)
    assert env["capability"] == f"sm_{major}{minor}"
    assert env["nvcc"] != "none" and env["driver"] != "unknown"


def test_mesh_key_names_the_card(cuda_device):
    from flinkml_tpu_torch.autotune import mesh_key

    import re

    name = re.sub(r"[^A-Za-z0-9_.-]", "_", torch.cuda.get_device_name(0))
    assert mesh_key() == f"cuda/{name}/1"


def test_step_timer_waits_for_the_stream(cuda_device):
    """``StepTimer`` waits for the stream its observed tensor was made on:
    steps of one ``segment_sum`` on a side stream read what CUDA events
    around the same steps read (each launched on an idle card and waited
    for), within 20% or 20 µs."""
    from flinkml_tpu_torch.kernels import segsum as ksegsum
    from flinkml_tpu_torch.utils import StepTimer

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, segs = 1 << 26, 1 << 20
    ids = torch.randint(0, segs, (n,), device="cuda", dtype=torch.int32,
                        generator=gen)
    vals = torch.randn(n, device="cuda", generator=gen)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    timer, event_ms = StepTimer(), []
    with torch.cuda.stream(side):
        ksegsum.segment_sum(vals, ids, segs)
        for _ in range(10):
            with timer:
                timer.observe(ksegsum.segment_sum(vals, ids, segs))
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ksegsum.segment_sum(vals, ids, segs)
            end.record()
            end.synchronize()
            event_ms.append(start.elapsed_time(end))
    mean_ms = float(np.mean(event_ms))
    assert abs(timer.mean * 1e3 - mean_ms) <= max(0.2 * mean_ms, 0.020)


def test_trace_names_the_kernels(cuda_device, tmp_path):
    from flinkml_tpu_torch.kernels import spmv as kspmv
    from flinkml_tpu_torch.utils import annotate, trace

    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 1000, (512, 8)).astype(
        np.int32)).cuda()
    val = torch.randn(512, 8, device="cuda")
    w = torch.randn(1000, device="cuda")
    kspmv.spmv(idx, val, w)
    with trace(str(tmp_path), ignore_errors=False):
        with annotate("spmv_step"):
            kspmv.spmv(idx, val, w)
        torch.cuda.synchronize()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
    assert "spmv_step" in names
    assert any("spmv" in n and n != "spmv_step" for n in names)
