"""The port's compile-cache store (``flinkml_tpu_torch.compile_cache``)
against the JAX package's specification: round trips, invalidation,
corruption, concurrency, pool spin-up and the key schema.

Each case carries the name of its ``tests/test_compile_cache.py``
counterpart. The port's artifact is a built kernel library; this host has
no ``nvcc``, so the store builds a tiny C++ stand-in with ``g++ -shared``
(``tests/_torch_compile_cache_child.py``): the same store calls, ``ctypes``
loads and entries on disk as the four CUDA kernels on the card (their
cases are in ``tests/test_torch_compile_cache_cuda.py``). The fresh-process
cases run children of this module (one warm child, three racing ones).
``stable_key_repr`` and the key hash are held against the JAX functions:
the strings must be equal. Every comparison of a library's output is bit
for bit (the stand-in computes in float64 without fused multiply-adds,
as numpy does).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from flinkml_tpu import compile_cache as jax_cc
from flinkml_tpu.compile_cache.store import _key_hash as jax_key_hash
from flinkml_tpu_torch import compile_cache
from flinkml_tpu_torch.compile_cache import store as store_mod
from flinkml_tpu_torch.compile_cache.store import (
    CompileCacheStore,
    _key_hash,
)
from flinkml_tpu_torch.kernels import _build
from tests import _torch_compile_cache_child as child
from tests._torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_compile_cache_child.py")



def _need_gxx() -> None:
    """The stand-in library needs ``g++`` (decided at run time)."""
    if shutil.which("g++") is None:
        pytest.skip("the stand-in library needs g++")


@pytest.fixture(autouse=True)
def _clean_store_state():
    """No active store before or after a case (other modules build)."""
    compile_cache.reset()
    compile_cache.configure(None)
    yield
    compile_cache.reset()
    compile_cache.configure(None)


@pytest.fixture
def gxx(tmp_path, monkeypatch):
    """``_build`` pointed at the stand-in; returns its store directory."""
    _need_gxx()
    src, build = str(tmp_path / "src"), str(tmp_path / "build")
    child.write_source(src)
    child.use_gxx(monkeypatch.setattr, _build, src, build)
    return build


_count = child.counters


def _delta(after: dict, before: dict, name: str) -> float:
    return after.get(name, 0) - before.get(name, 0)


def _files(root, suffix):
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(root)
                  for f in fs if f.endswith(suffix))


def _gxx_build(builds: list):
    """A store build callable for the stand-in that records each run."""

    def build(out: str) -> None:
        builds.append(out)
        subprocess.run([shutil.which("g++"), *child.FLAGS, "-o", out,
                        _build._source_path("tiny")], check=True)

    return build


def _tear(path: str) -> None:
    """Put a torn copy (the first half) of the library at ``path``. A new
    file, not a truncation in place: this process has the library mapped,
    and cutting a mapped file under it faults the process (SIGBUS)."""
    with open(path, "rb") as fh:
        head = fh.read(os.path.getsize(path) // 2)
    with open(path + ".torn", "wb") as fh:
        fh.write(head)
    os.replace(path + ".torn", path)


def _scale1(lib, v: float) -> float:
    """The stand-in's ``fml_scale`` of one value, from ``lib`` itself."""
    fn = lib.fml_scale
    fn.restype, fn.argtypes = ctypes.c_double, [ctypes.c_double]
    return fn(v)


def _run_child(mode, src, build, env_dir=None):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(store_mod.ENV_DIR_VAR, None)
    if env_dir is not None:
        env[store_mod.ENV_DIR_VAR] = env_dir
    return subprocess.Popen([sys.executable, CHILD, mode, src, build],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


def _report(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def child_report(tmp_path_factory):
    """The parent builds the stand-in into a store; one fresh child loads
    it and scales a pool on it; three fresh children race on an empty
    store."""
    _need_gxx()
    root = tmp_path_factory.mktemp("cc")
    src, filled, empty = (str(root / n) for n in ("src", "filled", "empty"))
    child.write_source(src)
    mp = pytest.MonkeyPatch()
    try:
        child.use_gxx(mp.setattr, _build, src, filled)
        compile_cache.reset()
        compile_cache.configure(filled)
        before = _count()
        cold = _build.load_all()
        after = _count()
        x = np.random.default_rng(3).normal(size=(64, 3))
        cold_bitwise = child.scale(_build, x).tobytes() == \
            child.expected(x).tobytes()
        compile_cache.reset()
        compile_cache.configure(None)
    finally:
        mp.undo()
    warm = _run_child("warm", src, os.path.join(str(root), "unused"),
                      env_dir=filled)
    racers = [_run_child("race", src, os.path.join(str(root), "unused"),
                         env_dir=empty) for _ in range(3)]
    return {
        "cold": {"outcomes": cold, "stores": _delta(after, before, "stores"),
                 "misses": _delta(after, before, "misses"),
                 "so_files": len(_files(filled, ".so")),
                 "bitwise": cold_bitwise},
        "warm": _report(warm),
        "race": [_report(p) for p in racers],
    }


# -- fresh-process cases -------------------------------------------------------


def test_disk_roundtrip_bitwise_parity(child_report):
    """A cold store builds and stores; a FRESH process over the same
    directory loads from disk with no build; outputs bit for bit."""
    cold, warm = child_report["cold"], child_report["warm"]
    assert cold["outcomes"] == {"tiny": "compiled"}
    assert cold["stores"] == cold["misses"] == cold["so_files"] == 1
    assert warm["outcomes"] == {"tiny": "disk"}
    assert warm["hits"] == cold["stores"] and warm["misses"] == 0
    assert warm["nvcc_runs"] == 0
    assert cold["bitwise"] and warm["loaded_bitwise"]


def test_scale_up_zero_new_builds_clean_process(child_report):
    """The clean-child scale-up (the counterpart of
    ``tests/test_autoscaler.py``'s): a fresh process on a filled store
    scales a pool from 1 to 3 replicas with zero builds, and the scaled
    replicas answer bit for bit as the first."""
    warm = child_report["warm"]
    assert warm["replicas"] == 3
    assert warm["nvcc_runs"] == 0 and warm["new_builds_on_scale_up"] == 0
    assert warm["hits"] >= 1
    assert warm["scaled_replica_parity_bitwise"] and warm["served_bitwise"]


def test_concurrent_processes_share_one_build(child_report):
    """Three processes started together on an empty store pay one build
    between them (the per-key ``flock``); the others load it."""
    race = child_report["race"]
    assert sum(r["nvcc_runs"] for r in race) == 1
    assert sorted(r["outcome"] for r in race) == ["compiled", "disk", "disk"]
    assert all(r["bitwise"] for r in race)


# -- in-process cases ----------------------------------------------------------


def test_corrupt_entry_falls_back_loudly(gxx, caplog):
    """A torn library is detected by its sha BEFORE it is loaded, logged,
    deleted and rebuilt; the rebuilt entry serves and loads again."""
    key = _build.program_key("tiny")
    builds: list = []
    CompileCacheStore(gxx).get_or_compile(key, _gxx_build(builds))
    (so,) = _files(gxx, ".so")
    _tear(so)
    before = _count()
    with caplog.at_level(logging.WARNING, logger="flinkml_tpu_torch"):
        lib, outcome = CompileCacheStore(gxx).get_or_compile(
            key, _gxx_build(builds))
    after = _count()
    assert _delta(after, before, "corrupt_entries") == 1
    assert outcome == "compiled" and len(builds) == 2
    assert any("corrupt compile-cache entry" in r.getMessage()
               for r in caplog.records)
    assert _scale1(lib, -2.75) == child.expected(-2.75)
    _, again = CompileCacheStore(gxx).get_or_compile(key, _gxx_build(builds))
    assert again == "disk" and len(builds) == 2


@pytest.mark.parametrize("damage", ["entry_json", "missing_library"])
def test_corrupt_entry_kinds_are_rebuilt(gxx, damage):
    """A torn entry file or a library gone from under its entry are
    corrupt entries too: deleted and rebuilt, never loaded."""
    key = _build.program_key("tiny")
    builds: list = []
    CompileCacheStore(gxx).get_or_compile(key, _gxx_build(builds))
    (so,) = _files(gxx, ".so")
    if damage == "entry_json":
        with open(so[:-3] + ".json", "w") as fh:
            fh.write("{torn")
    else:
        os.unlink(so)
    before = _count()
    _, outcome = CompileCacheStore(gxx).get_or_compile(key,
                                                       _gxx_build(builds))
    assert _delta(_count(), before, "corrupt_entries") == 1
    assert outcome == "compiled" and len(builds) == 2


def test_env_fingerprint_mismatch_invalidates(gxx):
    """A torch bump changes the env-hash namespace, and a byte-identical
    library copied across namespaces is refused by its embedded env."""
    key = _build.program_key("tiny")
    store = CompileCacheStore(gxx)
    store.get_or_compile(key, _gxx_build([]))
    bumped = CompileCacheStore(gxx)
    bumped._env = dict(store._environment(), torch="999.0.0")
    assert os.path.dirname(bumped.entry_path(key)) != \
        os.path.dirname(store.entry_path(key))
    os.makedirs(os.path.dirname(bumped.entry_path(key)), exist_ok=True)
    for suffix in (".so", ".json"):
        shutil.copy(store.entry_path(key)[:-3] + suffix,
                    bumped.entry_path(key)[:-3] + suffix)
    before = _count()
    assert bumped._read_disk(key) is None
    assert _delta(_count(), before, "env_mismatches") == 1


def test_env_fingerprint_fields():
    """The environment half of the key: torch, CUDA, nvcc, and the card
    (``cpu`` on a host without one)."""
    env = compile_cache.env_fingerprint()
    assert set(env) == {"torch", "cuda", "nvcc", "device_name",
                        "capability", "driver"}
    import torch

    assert env["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert env["device_name"] == env["capability"] == env["driver"] \
            == "cpu"


def test_concurrent_writers_share_one_build(gxx):
    """Racing get_or_compile calls on one key pay ONE build (per-key
    lock); two store objects racing on one path publish one whole entry,
    and a fresh store reloads it from disk."""
    import threading

    key = _build.program_key("tiny")
    builds: list = []
    store = CompileCacheStore(gxx)
    results: list = []
    threads = [threading.Thread(target=lambda: results.append(
        store.get_or_compile(key, _gxx_build(builds)))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 4 and len(builds) == 1
    assert [o for _, o in results].count("compiled") == 1
    other = str(gxx) + "-2"
    s1, s2 = CompileCacheStore(other), CompileCacheStore(other)
    builds2: list = []
    t1 = threading.Thread(target=s1.get_or_compile,
                          args=(key, _gxx_build(builds2)))
    t2 = threading.Thread(target=s2.get_or_compile,
                          args=(key, _gxx_build(builds2)))
    t1.start(), t2.start()
    t1.join(timeout=60), t2.join(timeout=60)
    assert len(builds2) == 1
    lib, outcome = CompileCacheStore(other).get_or_compile(
        key, _gxx_build(builds2))
    assert outcome == "disk" and len(builds2) == 1
    assert _scale1(lib, 1.5) == child.expected(1.5)


def test_pool_spinup_pays_one_compile_per_program(gxx, tmp_path):
    """A 4-replica pool warms the library ONCE: the first replica builds
    it through the store and every other replica of the process loads it
    (``_build``'s loaded libraries); steady state builds nothing, and the
    served outputs equal the direct ones bit for bit."""
    from flinkml_tpu_torch import use_device
    from flinkml_tpu_torch.serving import ReplicaPool, ServingConfig
    from flinkml_tpu_torch.table import Table

    x = np.random.default_rng(5).normal(size=(40, 3))
    before = _count()
    with use_device("cpu"):
        pool = ReplicaPool(
            child.LibScale(_build), Table({"features": x[:4]}),
            config=ServingConfig(max_batch_rows=16, max_wait_ms=1.0),
            n_replicas=4, output_cols=("scaled",), name="cc-pool",
        ).start()
    try:
        assert compile_cache.active_store() is not None  # share_compiles
        after = _count()
        programs = _build.nvcc_runs()
        outs = [r.engine.predict({"features": x[:5]}).columns["scaled"]
                for r in pool.replicas]
        steady = _build.nvcc_runs() - programs
    finally:
        pool.stop(drain=False)
    assert programs == 1
    assert _delta(after, before, "misses") == programs
    assert steady == 0
    assert all(o.tobytes() == child.expected(x[:5]).tobytes() for o in outs)


def test_retargeted_load_cross_device_parity(gxx, monkeypatch):
    """A library built on one card serves another of its kind: the load
    counts ``retarget_loads`` and computes the same bits."""
    key = _build.program_key("tiny")
    monkeypatch.setattr(store_mod, "device_identity", lambda: "card-A")
    CompileCacheStore(gxx).get_or_compile(key, _gxx_build([]))
    monkeypatch.setattr(store_mod, "device_identity", lambda: "card-B")
    before = _count()
    lib, outcome = CompileCacheStore(gxx).get_or_compile(key,
                                                         _gxx_build([]))
    assert outcome == "disk"
    assert _delta(_count(), before, "retarget_loads") == 1
    assert _scale1(lib, 0.3125) == child.expected(0.3125)


def test_plan_step_disk_roundtrip(tmp_path):
    """Declared difference: the port's plan step is eager PyTorch with no
    compiled artifact. With a store configured a plan fit writes nothing
    to it and its coefficients equal the fit without one, cold and
    warm."""
    from flinkml_tpu_torch import use_device
    from flinkml_tpu_torch.parallel import DeviceMesh
    from flinkml_tpu_torch.sharding.apply import train_linear_plan
    from flinkml_tpu_torch.sharding.plan import FSDP

    rng = np.random.default_rng(0)
    px = rng.normal(size=(272, 48)).astype(np.float32)
    py = (px @ rng.normal(size=48).astype(np.float32) > 0).astype(np.float32)
    with use_device("cpu"):
        mesh = DeviceMesh.for_plan(FSDP)
        coef0 = train_linear_plan(px, py, None, FSDP, mesh, max_iter=4)
        compile_cache.configure(str(tmp_path / "plan"))
        cold = train_linear_plan(px, py, None, FSDP, mesh, max_iter=4)
        warm = train_linear_plan(px, py, None, FSDP, mesh, max_iter=4)
    assert not os.path.exists(tmp_path / "plan")
    assert np.array_equal(coef0, cold) and np.array_equal(coef0, warm)


def test_poisoned_serialize_degrades_in_this_process(gxx):
    """A build whose output does not load is never published: the store
    raises (there is no fallback to a plain version), leaves no entry or
    temp file behind, and a later good build of the key stores and
    loads."""
    key = _build.program_key("tiny")

    def poisoned(out: str) -> None:
        with open(out, "wb") as fh:
            fh.write(b"not a shared library")

    before = _count()
    with pytest.raises(RuntimeError, match="does not load"):
        CompileCacheStore(gxx).get_or_compile(key, poisoned)
    assert not _files(gxx, ".so") and not _files(gxx, ".json")
    assert _delta(_count(), before, "corrupt_entries") == 0
    _, outcome = CompileCacheStore(gxx).get_or_compile(key, _gxx_build([]))
    assert outcome == "compiled" and len(_files(gxx, ".so")) == 1


def test_memory_store_shares_within_process(gxx):
    """A directory-less store builds once per process (what the replicas
    of a pool share) and persists nothing."""
    key = _build.program_key("tiny")
    builds: list = []
    store = CompileCacheStore(None)
    before = _count()
    _, first = store.get_or_compile(key, _gxx_build(builds))
    _, second = store.get_or_compile(key, _gxx_build(builds))
    assert (first, second) == ("compiled", "memory") and len(builds) == 1
    assert not os.path.exists(builds[0])  # the private file is gone
    misses1 = _delta(_count(), before, "misses")
    store.drop_memory()
    store.get_or_compile(key, _gxx_build(builds))
    assert _delta(_count(), before, "misses") == misses1 + 1
    assert store.entry_path(("k",)) is None


def test_serialization_unsupported_degrades(gxx, monkeypatch):
    """Where libraries cannot be kept the store degrades to build-only:
    the same results, nothing persisted, a loud counter."""
    monkeypatch.setattr(store_mod, "_SUPPORT", [False])
    monkeypatch.setattr(store_mod, "_WARNED_UNSUPPORTED", [False])
    key = _build.program_key("tiny")
    before = _count()
    lib, outcome = CompileCacheStore(gxx).get_or_compile(key,
                                                         _gxx_build([]))
    assert outcome == "uncached"
    assert _scale1(lib, -0.5) == child.expected(-0.5)
    assert not _files(gxx, ".so")
    assert _delta(_count(), before, "fallbacks") > 0


@dataclasses.dataclass(frozen=True)
class Key:
    name: str
    width: int
    scales: tuple


def _jax_key_class():
    @dataclasses.dataclass(frozen=True)
    class Key:  # noqa: F811 — the same name and fields, another class
        name: str
        width: int
        scales: tuple

    return Key


KEYS = [
    ("pipeline_fusion", 8, 1.5, None, True, b"x"),
    {"b": 1, "a": [2, (3, "c")], 7: {"z": None, "y": 2.0}},
    ("kernel_library", "spmv", "ab12", ("-O3", "--fmad=false")),
    "frozen-dataclass",
]


@pytest.mark.parametrize("key", KEYS, ids=["tuple", "nested_dict",
                                           "library", "dataclass"])
def test_stable_key_repr_equals_jax(key):
    """``stable_key_repr`` and the key hash give the JAX package's strings
    for primitives, nested dicts and a frozen dataclass of the same name
    and fields."""
    if key == "frozen-dataclass":
        port_key = ("k", Key("a", 3, (1.0, 2.0)), {"p": Key("b", 1, ())})
        jk = _jax_key_class()
        jax_key = ("k", jk("a", 3, (1.0, 2.0)), {"p": jk("b", 1, ())})
    else:
        port_key = jax_key = key
    assert compile_cache.stable_key_repr(port_key) == \
        jax_cc.stable_key_repr(jax_key)
    assert _key_hash(port_key) == jax_key_hash(jax_key)


def test_stable_key_repr_and_hash():
    from flinkml_tpu_torch.precision import resolve_policy
    from flinkml_tpu_torch.sharding.plan import FSDP, FSDP_TP

    policy = resolve_policy("mixed")
    k1 = ("pipeline_fusion", ("fp", 8, policy), FSDP)
    k2 = ("pipeline_fusion", ("fp", 8, resolve_policy("mixed")), FSDP)
    assert compile_cache.stable_key_repr(k1) == \
        compile_cache.stable_key_repr(k2)
    assert _key_hash(k1) == _key_hash(k2)
    assert _key_hash(k1) != _key_hash(
        ("pipeline_fusion", ("fp", 8, policy), FSDP_TP)
    )
    # dicts render order-independently
    assert compile_cache.stable_key_repr({"b": 1, "a": 2}) == \
        compile_cache.stable_key_repr(dict([("a", 2), ("b", 1)]))
    # an edited source or other flags is another library
    assert _build.program_key("spmv") != _build.program_key(
        "spmv", ("-DVARIANT",))


def test_env_var_activates_store(tmp_path, monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_DIR_VAR, str(tmp_path))
    compile_cache.reset()
    store = compile_cache.active_store()
    assert store is not None and store.directory == str(tmp_path)
    assert _build.store() is store
    compile_cache.reset()
    monkeypatch.delenv(compile_cache.ENV_DIR_VAR)
    assert compile_cache.active_store() is None
    assert _build.store() is _build.default_store()
    assert _build.default_store().directory == os.path.abspath(
        _build.BUILD_DIR)


def test_ensure_store_installs_the_default(monkeypatch, tmp_path):
    """With nothing configured ``ensure_store`` installs the kernels'
    default store (kernels/build/), where the next process finds what
    this one builds."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kb"))
    compile_cache.reset()
    store = compile_cache.ensure_store()
    assert store.directory == str(tmp_path / "kb")
    assert compile_cache.active_store() is store


def test_library_key_and_path_follow_the_source(gxx):
    """``_build`` keys a library by its source: an edited source is a new
    entry, never the stale library."""
    key0 = _build.program_key("tiny")
    path0 = _build._library_path("tiny")
    assert path0.startswith(gxx) and path0.endswith(".so")
    with open(_build._source_path("tiny"), "a") as f:
        f.write("\n// edited\n")
    assert _build.program_key("tiny") != key0
    assert _build._library_path("tiny") != path0
