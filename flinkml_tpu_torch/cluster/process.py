"""Spawning and supervising worker child processes.

:class:`WorkerSpec` is everything a child needs to stand up its engine,
pickled to a file the child's ``main`` reads (models ride as their own
pickle blob so a registry-backed worker can instead open the registry
directory itself). :class:`WorkerProcess` spawns
``python -m flinkml_tpu_torch.cluster.worker`` (a fresh interpreter,
never a ``fork`` of a process that may hold a CUDA context), and waits for
the single JSON ready line on the child's stdout. Each worker owns its own
interpreter lock, which is the entire point of the subsystem.

The device: the spec carries the device the parent asked for
(:func:`~flinkml_tpu_torch.device.requested_device`: ``cuda`` unless it
asked for the CPU), and the child makes it its default before it builds
the engine. A ``cuda`` worker on a host without a usable card fails its
start, and the spawn raises :class:`~flinkml_tpu_torch.cluster.errors.
WorkerSpawnError` with the child's stderr tail: it never carries on on the
CPU. Which card a ``cuda`` worker sees is set through
``CUDA_VISIBLE_DEVICES``: with ``devices_per_worker=n`` worker ``i`` sees
the parent's visible cards ``i*n .. i*n+n-1`` (modulo their count), so
on a one-card host every worker shares card 0; ``None`` leaves the
parent's visibility alone.

``compile_cache_dir`` goes into the spec: the worker configures that
compile-cache store (:mod:`flinkml_tpu_torch.compile_cache`) and loads
the kernel libraries its pool built there before the spawn
(:func:`flinkml_tpu_torch.kernels._build.build_all`). Without one the
worker uses ``$FLINKML_TPU_COMPILE_CACHE``, else the kernels' default
store.

``spawn_ms`` is recorded for the ``cluster.*`` metrics group; a child
that exits or stays silent past the deadline is a typed
:class:`~flinkml_tpu_torch.cluster.errors.WorkerSpawnError` with the tail
of the child's stderr attached.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import select
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Mapping, Optional, Sequence

from flinkml_tpu_torch.cluster.errors import WorkerSpawnError
from flinkml_tpu_torch.utils.logging import get_logger

_log = get_logger("cluster.process")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))


def _requested_device_type() -> str:
    from flinkml_tpu_torch.device import requested_device

    return requested_device().type


@dataclasses.dataclass
class WorkerSpec:
    """The child's construction record (see module docstring)."""

    example: Dict[str, Any]                 # column name -> host array
    source: Dict[str, Any]                  # {"kind": "model"|"registry", ...}
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    output_cols: Optional[Sequence[str]] = None
    name: str = "worker"
    compile_cache_dir: Optional[str] = None
    max_payload: Optional[int] = None
    #: "cuda" or "cpu": the device the parent requested when it built the
    #: spec; the child computes on it or fails its start.
    device: str = dataclasses.field(default_factory=_requested_device_type)

    @classmethod
    def for_model(cls, model: Any, example_columns: Dict[str, Any],
                  **kw) -> "WorkerSpec":
        return cls(
            example=dict(example_columns),
            source={"kind": "model", "blob": pickle.dumps(model, protocol=5)},
            **kw,
        )

    @classmethod
    def for_registry(cls, root: str, example_columns: Dict[str, Any],
                     **kw) -> "WorkerSpec":
        return cls(
            example=dict(example_columns),
            source={"kind": "registry", "root": os.path.abspath(root)},
            **kw,
        )

    def write(self, path: str) -> str:
        with open(path, "wb") as f:
            pickle.dump(dataclasses.asdict(self), f, protocol=5)
        return path


def visible_cards(index: int, devices_per_worker: int,
                  env: Mapping[str, str]) -> Optional[str]:
    """The ``CUDA_VISIBLE_DEVICES`` of worker ``index``: its
    ``devices_per_worker`` cards among the parent's visible ones (``env``'s
    ``CUDA_VISIBLE_DEVICES``, else every card), round-robin. None when
    the parent sees no card (the child then fails its start on its own)."""
    listed = env.get("CUDA_VISIBLE_DEVICES")
    if listed is not None:
        cards = [c for c in listed.split(",") if c.strip()]
    else:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cards = [str(i) for i in range(count)]
    if not cards:
        return None
    n = int(devices_per_worker)
    return ",".join(
        cards[(index * n + j) % len(cards)] for j in range(n)
    )


class WorkerProcess:
    """One supervised worker child; ``index`` picks its cards."""

    def __init__(self, spec: WorkerSpec, *,
                 name: Optional[str] = None,
                 index: int = 0,
                 devices_per_worker: Optional[int] = 1,
                 env: Optional[Mapping[str, str]] = None,
                 spawn_timeout_s: float = 180.0,
                 python: str = sys.executable,
                 workdir: Optional[str] = None):
        self.spec = spec
        self.name = name or spec.name
        self.index = int(index)
        self.devices_per_worker = devices_per_worker
        self._extra_env = dict(env or {})
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.python = python
        safe = self.name.replace("/", "-").replace(os.sep, "-")
        self._workdir = workdir or tempfile.mkdtemp(
            prefix=f"flinkml-worker-{safe}-"
        )
        self._proc: Optional[subprocess.Popen] = None
        self.host = "127.0.0.1"
        self.port: Optional[int] = None
        self.pid: Optional[int] = None
        self.spawn_ms: Optional[float] = None
        #: The child's own share of ``spawn_ms``: from its ``main`` (after
        #: the interpreter started and imported the port) to its ready line.
        self.spawn_stage_ms: Optional[float] = None
        self.stderr_path = os.path.join(self._workdir, "stderr.log")

    @property
    def workdir(self) -> str:
        """The child's scratch directory (spec file, stderr log)."""
        return self._workdir

    # -- lifecycle ---------------------------------------------------------
    def spawn(self) -> "WorkerProcess":
        """Start the child and block until its ready line (or raise
        :class:`WorkerSpawnError` with the stderr tail)."""
        t0 = time.monotonic()
        spec_path = self.spec.write(
            os.path.join(self._workdir, "spec.pkl")
        )
        env = dict(os.environ)
        if self.spec.device == "cuda" and self.devices_per_worker is not None:
            cards = visible_cards(self.index, self.devices_per_worker, env)
            if cards is not None:
                env["CUDA_VISIBLE_DEVICES"] = cards
        env["PYTHONPATH"] = os.pathsep.join(
            x for x in (_REPO_ROOT, env.get("PYTHONPATH")) if x
        )
        env.update(self._extra_env)
        stderr = open(self.stderr_path, "ab")
        try:
            self._proc = subprocess.Popen(
                [self.python, "-m", "flinkml_tpu_torch.cluster.worker",
                 spec_path],
                stdout=subprocess.PIPE, stderr=stderr, env=env,
            )
        finally:
            stderr.close()
        ready = self._await_ready(t0)
        self.port = int(ready["port"])
        self.pid = int(ready["pid"])
        self.spawn_ms = (time.monotonic() - t0) * 1000.0
        self.spawn_stage_ms = ready.get("spawn_stage_ms")
        _log.info("worker %s up: pid %d port %d on %s in %.0f ms "
                  "(engine stage %.0f ms)", self.name, self.pid,
                  self.port, ready.get("device"), self.spawn_ms,
                  ready.get("spawn_stage_ms", -1.0))
        return self

    def _await_ready(self, t0: float) -> Dict[str, Any]:
        if self._proc is None or self._proc.stdout is None:
            raise WorkerSpawnError(f"worker {self.name} was never started")
        deadline = t0 + self.spawn_timeout_s
        out = self._proc.stdout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.kill()
                self.join(5.0)
                raise WorkerSpawnError(
                    f"worker {self.name} produced no ready line within "
                    f"{self.spawn_timeout_s}s; stderr tail:\n"
                    f"{self._stderr_tail()}"
                )
            if self._proc.poll() is not None:
                raise WorkerSpawnError(
                    f"worker {self.name} exited rc={self._proc.returncode} "
                    f"during startup; stderr tail:\n{self._stderr_tail()}"
                )
            rl, _, _ = select.select([out], [], [], min(0.25, remaining))
            if not rl:
                continue
            line = out.readline()
            if not line:
                continue
            try:
                ready = json.loads(line)
            except ValueError:
                continue  # stray stdout noise; keep waiting for ours
            if ready.get("ready"):
                return ready

    def _stderr_tail(self, n: int = 2000) -> str:
        try:
            with open(self.stderr_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - n))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return "<no stderr captured>"

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    @property
    def returncode(self) -> Optional[int]:
        return None if self._proc is None else self._proc.poll()

    def terminate(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()

    def kill(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()

    def join(self, timeout_s: Optional[float] = 10.0) -> Optional[int]:
        if self._proc is None:
            return None
        try:
            rc = self._proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            return None
        if self._proc.stdout is not None:
            self._proc.stdout.close()
        return rc
