"""RemoteEngine: a worker process behind the ServingEngine surface.

The serving :class:`~flinkml_tpu_torch.serving.router.Router` and
:class:`~flinkml_tpu_torch.serving.pool.ReplicaPool` touch an engine
through a narrow contract — ``submit`` returning a pending whose
``.request`` makes CAS terminal transitions (complete/fail/abandon, waking
the router's race event), ``config.max_queue_rows``,
``_batcher.queued_rows`` as the balance signal, ``queued_rows`` and
``observed_p99_ms`` for the autoscaler, start/stop/running/swap_to/
``_metrics``. :class:`RemoteEngine` implements exactly that contract over
the worker transport, so every pool behavior — least-outstanding-rows
balance, typed failover, gray-fail abandonment and hedging, health
quarantine, hot swap — works unchanged whether the replica is a thread or
a process.

The pieces are REUSED, not imitated: requests are real
:class:`~flinkml_tpu_torch.serving.batcher.ServingRequest` objects (same
CAS semantics, same race-event wiring) and handles are real
:class:`~flinkml_tpu_torch.serving.engine.PendingPrediction` objects; the
transport client completes them from its reader thread. Schema validation
runs CLIENT-side (``ServingEngine._normalize``, borrowed) so a malformed
request costs no round trip and raises the identical typed error.
Admission is also client-side: ``max_queue_rows`` bounds the rows in
flight to one worker, and exceeding it raises the same
:class:`~flinkml_tpu_torch.serving.errors.ServingOverloadError` the
in-process engine raises — which is what trips the router's failover →
DRAINING ladder.

The engine knobs resolve as the in-process engine's do
(``serving/engine.py`` ``resolve_config``: the tuning table for the
worker's device, else ``MAX_BATCH_ROWS``/``MAX_WAIT_MS`` when left None),
and the worker gets the same concrete values, so both sides of the wire
agree on ``max_batch_rows``. The worker computes on the device this
engine's constructing thread requested (``config.device`` wins).

Failure mapping: a worker's typed serving error re-raises as itself
(the error-frame registry); a dead worker fails every in-flight request
with :class:`~flinkml_tpu_torch.cluster.errors.WorkerDiedError`, which
the router's catch-all turns into record-failure → retire — the same
path an in-process replica death takes.
"""

from __future__ import annotations

import pickle
import tempfile
import threading
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from flinkml_tpu_torch.cluster import protocol
from flinkml_tpu_torch.cluster.client import WorkerClient
from flinkml_tpu_torch.cluster.errors import TransportError, WorkerDiedError
from flinkml_tpu_torch.cluster.process import WorkerProcess, WorkerSpec
from flinkml_tpu_torch.device import requested_device
from flinkml_tpu_torch.serving import engine as _engine
from flinkml_tpu_torch.serving.batcher import ServingRequest
from flinkml_tpu_torch.serving.engine import (
    PendingPrediction,
    ServingConfig,
    ServingEngine,
    ServingResponse,
)
from flinkml_tpu_torch.serving.errors import (
    EngineStoppedError,
    ServingOverloadError,
    ServingTimeoutError,
)
from flinkml_tpu_torch.serving.registry import ModelRegistry
from flinkml_tpu_torch.table import Table
from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import LatencyWindow, metrics

_log = get_logger("cluster.remote")

#: Grace added to a request's serving deadline to form its TRANSPORT
#: deadline: the worker enforces the serving timeout itself; the client
#: sweep only catches a worker that went silent.
TRANSPORT_GRACE_S = 2.0

#: The engine knobs that cross the wire; the process-local ones (device
#: and mesh pins, metric labels, dispatch tags) stay home.
_WIRE_FIELDS = (
    "max_batch_rows", "max_wait_ms", "max_queue_rows",
    "default_timeout_ms", "warmup_row_counts", "latency_window",
    "batching", "refuse_nonfinite", "precision", "hbm_budget_bytes",
)


class _RemoteBacklog:
    """The ``engine._batcher`` shim: queued-rows here means rows in
    flight to the worker — the same backlog signal the router balances
    and sheds on for in-process replicas."""

    def __init__(self, owner: "RemoteEngine"):
        self._owner = owner

    @property
    def queued_rows(self) -> int:
        return self._owner._outstanding_rows

    @property
    def queue_depth(self) -> int:
        return self._owner._outstanding_requests

    @property
    def max_queue_rows(self) -> int:
        return self._owner.config.max_queue_rows


class RemoteEngine:
    """See module docstring. Owns one :class:`WorkerProcess` and one
    :class:`WorkerClient`; ``start()`` spawns and connects. ``index``
    picks the worker's cards (:func:`~flinkml_tpu_torch.cluster.process.
    visible_cards`)."""

    def __init__(
        self,
        source: Any,
        example: Table,
        config: Optional[ServingConfig] = None,
        output_cols: Optional[Sequence[str]] = None,
        name: str = "remote",
        *,
        index: int = 0,
        compile_cache_dir: Optional[str] = None,
        devices_per_worker: Optional[int] = 1,
        spawn_timeout_s: float = 180.0,
        worker_env: Optional[Mapping[str, str]] = None,
        transport_window: Optional[LatencyWindow] = None,
        cluster_metrics: Optional[Any] = None,
    ):
        cfg = config or ServingConfig()
        self.name = name
        self.device = torch.device(
            cfg.device if cfg.device is not None else requested_device()
        )
        self.config = _engine.resolve_config(cfg, self.device)
        self._schema = {
            n: (np.asarray(example.column(n)).dtype,
                np.asarray(example.column(n)).shape[1:])
            for n in example.column_names
        }
        self._metrics = metrics.group(
            f"serving.{self.config.metrics_name or name}",
            labels=self.config.metrics_labels,
        )
        self._latency_window = LatencyWindow(
            self._metrics, self.config.latency_window
        )
        self._transport_window = transport_window
        self._cluster_metrics = cluster_metrics
        self._batcher = _RemoteBacklog(self)
        self._outstanding_rows = 0
        self._outstanding_requests = 0
        self._outstanding_lock = threading.Lock()
        self._active_version: Optional[int] = None
        self._started = False

        worker_cfg = {
            f: getattr(self.config, f) for f in _WIRE_FIELDS
            if getattr(self.config, f) is not None
            or f in ("default_timeout_ms", "warmup_row_counts",
                     "precision", "hbm_budget_bytes")
        }
        # A worker IS the failover unit: it never sheds to its own
        # host path (mirrors ReplicaPool forcing shed_on_overload off).
        worker_cfg["shed_on_overload"] = False
        example_cols = {
            n: np.asarray(example.column(n)) for n in example.column_names
        }
        if isinstance(source, ModelRegistry):
            source_spec = {"kind": "registry", "root": source.root}
        else:
            try:
                source_spec = {
                    "kind": "model",
                    "blob": pickle.dumps(source, protocol=5),
                }
            except (pickle.PicklingError, TypeError, AttributeError):
                # Fitted stages do not pickle (param validators hold
                # lambdas) — ship them through the registry's own
                # save/load machinery instead: publish once to a private
                # single-version registry root and let the worker load it
                # back as a FIXED model (version=None responses, same as
                # in-process).
                root = tempfile.mkdtemp(
                    prefix=f"flinkml-remote-{name.replace('/', '-')}-"
                )
                ModelRegistry(root).publish(source)
                source_spec = {"kind": "fixed_via_registry", "root": root}
        spec = WorkerSpec(
            example=example_cols,
            source=source_spec,
            config=worker_cfg,
            output_cols=tuple(output_cols) if output_cols else None,
            name=name, compile_cache_dir=compile_cache_dir,
            device=self.device.type,
        )
        self.process = WorkerProcess(
            spec, name=name, index=index,
            devices_per_worker=devices_per_worker,
            spawn_timeout_s=spawn_timeout_s, env=worker_env,
        )
        self.client: Optional[WorkerClient] = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        return (
            self._started
            and self.process.alive
            and self.client is not None
            and self.client.connected
        )

    @property
    def active_version(self) -> Optional[int]:
        return self._active_version

    @property
    def queued_rows(self) -> int:
        return self._outstanding_rows

    @property
    def observed_p99_ms(self) -> Optional[float]:
        """The latest client-side p99 (request round trips), as the
        in-process engine's property."""
        p99 = self._metrics.snapshot()["gauges"].get("p99_ms")
        return float(p99) if isinstance(p99, (int, float)) else None

    def start(self) -> "RemoteEngine":
        if self.running:
            return self
        if not self.process.alive:
            self.process.spawn()
            if self._cluster_metrics is not None:
                self._cluster_metrics.record(
                    "spawn_ms", float(self.process.spawn_ms or 0.0)
                )
        self.client = WorkerClient(
            self.process.host, self.process.port,
            max_payload=(self.process.spec.max_payload
                         or protocol.DEFAULT_MAX_PAYLOAD),
            metrics_group=self._cluster_metrics,
        ).connect()
        pong = self.client.call("ping", timeout_s=30.0)
        if not pong.get("ok"):
            raise WorkerDiedError(f"worker {self.name} failed its ping")
        self._started = True
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        self._started = False
        if self.client is not None and self.client.connected:
            try:
                self.client.call(
                    "shutdown", {"drain": drain},
                    timeout_s=min(timeout or 10.0, 10.0),
                )
            except (TransportError, OSError):
                pass  # already dying — the kill below settles it
        if self.client is not None:
            self.client.close()
        self.process.terminate()
        if self.process.join(timeout if timeout is not None else 10.0) \
                is None:
            self.process.kill()
            self.process.join(5.0)

    # -- request path ------------------------------------------------------
    # Borrowed verbatim: same schema table, same typed errors, zero
    # round trips for a malformed request.
    _normalize = ServingEngine._normalize

    def submit(
        self,
        features: Union[Table, Mapping[str, Any]],
        timeout_ms: Optional[float] = None,
    ) -> PendingPrediction:
        self._check_running()
        columns, rows = self._normalize(features)
        t0 = time.monotonic()
        timeout = (
            timeout_ms if timeout_ms is not None
            else self.config.default_timeout_ms
        )
        deadline = t0 + timeout / 1000.0 if timeout is not None else None
        with self._outstanding_lock:
            if (self._outstanding_rows + rows
                    > self.config.max_queue_rows):
                self._metrics.counter("rejected")
                raise ServingOverloadError(
                    f"worker {self.name} has "
                    f"{self._outstanding_rows} rows in flight "
                    f"(cap {self.config.max_queue_rows}); retry with "
                    "backoff"
                )
            self._outstanding_rows += rows
            self._outstanding_requests += 1
        self._metrics.counter("requests")
        self._metrics.counter("rows", float(rows))
        req = ServingRequest(
            columns=columns, rows=rows, enqueued_at=t0, deadline=deadline
        )

        def _on_done(result, error):
            with self._outstanding_lock:
                self._outstanding_rows -= rows
                self._outstanding_requests -= 1
            rtt_ms = (time.monotonic() - t0) * 1000.0
            if self._transport_window is not None:
                self._transport_window.record(rtt_ms)
            if error is not None:
                if isinstance(error, TimeoutError):
                    if req.claim_timeout_count():
                        self._metrics.counter("timeouts")
                    # Preserve the serving-typed shape for the router.
                    if not isinstance(error, ServingTimeoutError):
                        error = ServingTimeoutError(str(error))
                if req.fail(error):
                    self._metrics.counter("errors")
                return
            version = result.get("version")
            if version is not None:
                self._active_version = version
            if req.complete(result["columns"], version,
                            bool(result.get("shed"))):
                self._latency_window.record(rtt_ms)

        transport_deadline = (
            deadline + TRANSPORT_GRACE_S if deadline is not None else None
        )
        try:
            self.client.submit(
                "predict",
                {"columns": columns, "timeout_ms": timeout},
                deadline=transport_deadline, on_done=_on_done,
            )
        except TransportError:
            with self._outstanding_lock:
                self._outstanding_rows -= rows
                self._outstanding_requests -= 1
            raise
        return PendingPrediction(self, req, t0)

    def predict(
        self,
        features: Union[Table, Mapping[str, Any]],
        timeout_ms: Optional[float] = None,
    ) -> ServingResponse:
        pending = self.submit(features, timeout_ms=timeout_ms)
        req = pending.request
        remaining = (
            None if req.deadline is None
            else max(0.0, req.deadline - time.monotonic())
        )
        if not req.done.wait(
                None if remaining is None
                else remaining + TRANSPORT_GRACE_S + 0.25):
            if req.claim_timeout_count():
                self._metrics.counter("timeouts")
            raise ServingTimeoutError(
                f"request did not complete within {timeout_ms}ms"
            )
        return pending.response()

    # -- registry / control ------------------------------------------------
    def swap_to(self, version: Optional[int] = None) -> int:
        self._check_running()
        out = self.client.call(
            "swap_to", {"version": version}, timeout_s=120.0
        )
        self._active_version = out["version"]
        return out["version"]

    def worker_stats(self) -> Dict[str, Any]:
        """The worker's own stats snapshot: engine stats, the fused
        executor's program count, ``nvcc`` runs and kernel launches in
        that process (the warm-scale-up audit)."""
        self._check_running()
        return self.client.call("stats", timeout_s=30.0)

    def stats(self) -> Dict[str, Any]:
        snap = self._metrics.snapshot()
        return {
            "name": self.name,
            "running": self.running,
            "active_version": self.active_version,
            "queue_depth": self._batcher.queue_depth,
            "queued_rows": self._batcher.queued_rows,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
        }

    def _check_running(self) -> None:
        if not self._started:
            raise EngineStoppedError(
                f"remote engine {self.name} is not started"
            )
        if not self.process.alive or self.client is None \
                or not self.client.connected:
            raise WorkerDiedError(
                f"worker {self.name} is down "
                f"(rc={self.process.returncode})"
            )
