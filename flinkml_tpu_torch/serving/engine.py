"""Online inference engine: micro-batched, hot-swappable, admission-controlled.

The request path, end to end:

  1. ``predict()`` validates the request against the input schema fixed
     at load time (names, trailing shapes; values are cast to the schema
     dtypes, so every packed batch hits the SAME fused-cache keys) and
     offers it to the :class:`~flinkml_tpu_torch.serving.batcher
     .AdaptiveMicroBatcher`'s bounded queue.
  2. The dispatcher thread coalesces queued requests into one
     :class:`~flinkml_tpu_torch.table.Table` and runs the ACTIVE model's
     ``transform`` — the fused executor builds one program per
     power-of-two row bucket (on the card: one ``fused_chain`` launch a
     batch), and the engine built every bucket up to ``max_batch_rows``
     at load, so steady state builds **no new program**
     (:func:`~flinkml_tpu_torch.pipeline_fusion.compiled_program_count`
     stays flat).
  3. Output columns are read to host once per batch and sliced back per
     request (copies); each response carries the model **version** that
     served it.

Device and stream: the engine captures its device once, at
construction (``config.device``, else the constructing thread's
:func:`~flinkml_tpu_torch.device.requested_device`: ``cuda`` unless it
asked for the CPU), and every dispatch, warmup and shed call runs under
``use_device(device)`` and the engine's precision scope, whichever thread
makes it (the dispatcher, a registry publisher, a pool's roll). On the
card each engine dispatches on a CUDA stream of its own — the upload,
the chain and the read back — and waits on that stream only, so
replicas sharing one card overlap. A batch holds the model it
snapshotted until its stream has finished, so a hot swap never frees
memory a batch in flight still reads.

Hot swap: :meth:`swap_to` loads + warms the new version OFF the serving
path, then atomically replaces the active-model reference. In-flight
batches finish on the model they snapshotted; every later batch routes
to the new version — zero downtime, zero dropped or mis-versioned
responses. Same-shape model data reuses the built programs outright
(constants are packed per set of model arrays, and a program keeps
several packed tables side by side), so a swap builds nothing.

Graceful degradation: a full queue either rejects with the typed
:class:`~flinkml_tpu_torch.serving.errors.ServingOverloadError` or, with
``shed_on_overload`` (default), serves the request in the CALLER's
thread through the per-stage host path — slower, but it keeps absorbing
load without growing the device queue. Requests carry deadlines;
expiry while queued or in flight raises
:class:`~flinkml_tpu_torch.serving.errors.ServingTimeoutError`.

Coexistence with training: serving programs are single-device (the fused
executor is not SPMD today), which cannot interleave a multi-device
collective rendezvous, so by default the engine dispatches without any
cross-thread device lock and lives happily beside an in-progress
``train_*_stream`` on overlapping devices. A model whose transform IS a
multi-device collective program must be given ``config.mesh``; the
engine then wraps every batch in
``parallel.dispatch.local_execution_lock(mesh)`` and time-shares with
training the same way concurrent fits do (analyzer-verified, FML302).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

import flinkml_tpu_torch.faults as faults
from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.serving.batcher import (
    AdaptiveMicroBatcher,
    BatchSegment,
    ContinuousBatcher,
    ServingRequest,
)
from flinkml_tpu_torch.serving.errors import (
    EngineStoppedError,
    RegistryError,
    ServingMemoryError,
    ServingOverloadError,
    ServingSchemaError,
    ServingTimeoutError,
)
from flinkml_tpu_torch.serving.registry import ModelRegistry
from flinkml_tpu_torch.device import requested_device, use_device
from flinkml_tpu_torch.table import Table
from flinkml_tpu_torch.utils.metrics import LatencyWindow, metrics


#: ``ServingConfig.max_batch_rows`` and ``max_wait_ms`` when left None.
#: Module constants (tests may patch them); the JAX package reads measured
#: values from its autotune table, which comes with ROADMAP.md Queue 1
#: item 11.
MAX_BATCH_ROWS = 1024
MAX_WAIT_MS = 2.0

class _CpuHost:
    """The one dispatcher of every CPU engine of the process. Each engine
    keeps its own batcher (window, bucket, deadlines:
    :meth:`AdaptiveMicroBatcher.poll`), but one thread forms and runs
    every CPU batch, in turn. A dispatcher thread per engine would wake,
    take the GIL and hand it back around every batch, and on one host
    those handoffs bounded N in-process replicas below one engine; two CPU
    batches at once would hand the GIL back and forth at each tensor op
    (every one releases it), on cores the replicas share anyway. The
    engine whose oldest request is oldest goes first, as one queue would.
    The engine's own thread only waits until the engine stopped and its
    queue drained (``running`` and ``stop`` are unchanged). With a fault
    plan armed, a batch's ``serving.replica`` seam fires on a thread of
    its own, so that a stalled replica holds only itself; the batch then
    comes back to this thread to run. CUDA engines keep a dispatcher
    thread each: they overlap on their own streams."""

    #: Longest sleep between polls with nothing queued.
    IDLE_S = 0.02

    def __init__(self):
        self._cond = threading.Condition()
        #: ``(engine, event set once it stopped and drained)``
        self._engines: List[Tuple["ServingEngine", threading.Event]] = []
        #: Engines with a batch at its seam or back from it, not yet run.
        self._busy: set = set()
        #: ``(engine, batch)`` back from the seam, to run next.
        self._ready: collections.deque = collections.deque()
        self._kicked = False
        self._thread: Optional[threading.Thread] = None

    def kick(self) -> None:
        with self._cond:
            self._kicked = True
            self._cond.notify_all()

    def serve(self, engine: "ServingEngine") -> None:
        """Serve ``engine`` until it stopped and its queue drained (called
        from the engine's dispatcher thread, which waits here)."""
        done = threading.Event()
        engine._batcher.waker = self.kick
        with self._cond:
            self._engines.append((engine, done))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="serving-cpu-host", daemon=True)
                self._thread.start()
            self._kicked = True
            self._cond.notify_all()
        done.wait()

    def _run(self) -> None:
        while True:
            with self._cond:
                self._kicked = False
                for entry in [e for e in self._engines
                              if e[0]._stop_event.is_set()
                              and e[0]._batcher.queue_depth == 0
                              and e[0] not in self._busy]:
                    self._engines.remove(entry)
                    entry[0]._batcher.waker = None
                    entry[1].set()
                if not self._engines:
                    self._thread = None
                    return
                ready = list(self._ready)
                self._ready.clear()
            for engine, batch in ready:
                engine._run_batch(batch)
                engine._metrics.gauge("queue_depth",
                                      engine._batcher.queue_depth)
                with self._cond:
                    self._busy.discard(engine)
            with self._cond:
                engines = [e for e, _ in self._engines if e not in self._busy]
            # Oldest request first across the engines, as one queue would.
            engines.sort(key=lambda e: e._batcher.oldest())
            wake = time.monotonic() + self.IDLE_S
            served = bool(ready)
            for engine in engines:
                batch, expired, at = engine._batcher.poll()
                engine._expire(expired)
                if batch:
                    self._dispatch(engine, batch)
                    served = True
                elif at is not None:
                    wake = min(wake, at)
            if served:
                continue
            with self._cond:
                if not self._kicked:
                    self._cond.wait(max(0.0, wake - time.monotonic()))

    def _dispatch(self, engine: "ServingEngine",
                  batch: List[BatchSegment]) -> None:
        if faults.ACTIVE is None:
            engine._run_batch(batch)
            engine._metrics.gauge("queue_depth", engine._batcher.queue_depth)
            return
        with self._cond:
            self._busy.add(engine)

        def seam():
            passed = engine._replica_seam(batch)
            with self._cond:
                if passed:
                    self._ready.append((engine, batch))
                else:
                    self._busy.discard(engine)
                self._kicked = True
                self._cond.notify_all()

        threading.Thread(target=seam, name=f"serving-{engine.name}-seam",
                         daemon=True).start()


_CPU_HOST = _CpuHost()


@dataclasses.dataclass
class ServingConfig:
    """Engine knobs (see module docstring for the policies they drive).

    ``warmup_row_counts=None`` precompiles every bucket from the minimum
    up to ``row_bucket(max_batch_rows)`` — no build after warmup.
    Pass an explicit tuple to warm fewer (new buckets still build
    lazily on first use).

    ``batching`` selects the queue policy: ``"continuous"`` (default —
    requests split at bucket boundaries, Orca-style; see
    :class:`~flinkml_tpu_torch.serving.batcher.ContinuousBatcher`) or
    ``"fifo"`` (whole-request packing, kept for A/B comparison —
    ``chip_smoke.py``'s path N3 measures both).

    ``device`` pins every dispatch (warmup and shedding included) to one
    ``torch.device`` (default: the constructing thread's requested
    device) — how a :class:`~flinkml_tpu_torch.serving.pool.ReplicaPool`
    places its replicas. ``metrics_name``/``metrics_labels`` let several engines
    share one metric GROUP distinguished by labels (per-replica gauges
    aggregate instead of colliding); ``dispatch_tag`` overrides the
    program name recorded for dispatch-trace observers (the pool tags
    replicas ``serving.pool/<pool>/<replica>`` so the analyzer's FML303
    check can see pool slices).

    ``max_batch_rows`` (the power-of-two dispatch bucket cap) and
    ``max_wait_ms`` (the batching window) default to None =
    :data:`MAX_BATCH_ROWS` (1024 rows) / :data:`MAX_WAIT_MS` (2 ms). An
    explicit value always wins.
    """

    max_batch_rows: Optional[int] = None
    max_wait_ms: Optional[float] = None
    max_queue_rows: int = 8192
    default_timeout_ms: Optional[float] = None
    shed_on_overload: bool = True
    warmup_row_counts: Optional[Sequence[int]] = None
    mesh: Optional[Any] = None  # one-device DeviceMesh to lock per batch
    latency_window: int = 2048  # ring size backing the p50/p99 gauges
    batching: str = "continuous"  # or "fifo"
    device: Optional[Any] = None  # torch.device to pin all dispatches to
    metrics_name: Optional[str] = None  # metric group name (default: name)
    metrics_labels: Optional[Dict[str, str]] = None
    dispatch_tag: Optional[str] = None  # trace program prefix override
    # Refuse to install a model whose learned arrays hold non-finite
    # values (NonFiniteModelError at load/swap time — the serving half
    # of the self-healing contract; a follower's refused swap keeps the
    # old model serving).
    refuse_nonfinite: bool = True
    # Mixed-precision contract for every fused inference program this
    # engine compiles: a PrecisionPolicy, preset name ("mixed_inference"
    # is the serving preset), or policy JSON dict. Each program is
    # FML6xx-validated against the policy BEFORE compile — at warmup, so
    # a policy-violating model is refused at LOAD time
    # (PrecisionValidationError) and a follower's refused swap keeps the
    # previous model serving, exactly like refuse_nonfinite. The
    # shed degradation path runs per-stage at full width (it exists to
    # avoid the fused executor entirely), on the engine's device.
    precision: Optional[Any] = None
    # Per-device memory budget for the load-time memory gate: a model whose
    # estimated footprint (learned arrays at this engine's precision
    # tier + batch buffers at the largest dispatch bucket; see
    # analysis.memory.estimate_serving_bytes) exceeds the budget is
    # refused with ServingMemoryError BEFORE the active-model flip —
    # the refuse_nonfinite idiom applied to capacity. None disables.
    hbm_budget_bytes: Optional[int] = None


@dataclasses.dataclass
class ServingResponse:
    """One ``predict`` result: output columns (row-sliced to the request),
    the model version that produced them, and the request's latency."""

    columns: Dict[str, np.ndarray]
    version: Optional[int]
    latency_ms: float
    shed: bool = False

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]


@dataclasses.dataclass
class _ActiveModel:
    version: Optional[int]
    model: Any


class ServingEngine:
    """See module docstring.

    ``source`` is a :class:`~flinkml_tpu_torch.serving.registry.ModelRegistry`
    (versioned serving with hot swap) or a fixed transformer stage
    (registry-less; responses carry ``version=None``). ``example`` fixes
    the request schema: a small host Table holding exactly the columns
    clients will send (its rows are tiled for warmup, so make them
    representative). ``output_cols`` defaults to every column
    ``transform`` adds to the example.
    """

    def __init__(
        self,
        source: Union[ModelRegistry, Any],
        example: Table,
        config: Optional[ServingConfig] = None,
        output_cols: Optional[Sequence[str]] = None,
        name: str = "default",
    ):
        cfg = config or ServingConfig()
        # Resolve the defaults ONCE, at construction: everything
        # downstream (batcher bounds, warmup bucket coverage, request
        # validation) reads concrete values; an explicit bad value fails
        # loudly in the batcher's own validation.
        self.config = dataclasses.replace(
            cfg,
            max_batch_rows=(
                int(cfg.max_batch_rows)
                if cfg.max_batch_rows is not None
                else MAX_BATCH_ROWS
            ),
            max_wait_ms=(
                float(cfg.max_wait_ms)
                if cfg.max_wait_ms is not None
                else MAX_WAIT_MS
            ),
        )
        # The device every dispatch of this engine runs on, captured once:
        # use_device is thread-local, and the dispatcher, a registry
        # publisher or a pool's roll are other threads than the caller's.
        self.device = _resolve_device(cfg)
        self._stream = None  # this engine's CUDA stream (made on first use)
        self.name = name
        self._registry = source if isinstance(source, ModelRegistry) else None
        self._fixed_model = None if self._registry is not None else source
        self._schema = {
            n: (np.asarray(example.column(n)).dtype,
                np.asarray(example.column(n)).shape[1:])
            for n in example.column_names
        }
        self._example = Table({
            n: np.asarray(example.column(n)) for n in example.column_names
        })
        self._output_cols: Optional[Tuple[str, ...]] = (
            tuple(output_cols) if output_cols is not None else None
        )
        from flinkml_tpu_torch.precision import resolve_policy

        # Resolved once (a bad preset name fails construction, not the
        # first swap); every fused dispatch below runs under this scope.
        self._policy = resolve_policy(self.config.precision)
        self._metrics = metrics.group(
            f"serving.{self.config.metrics_name or name}",
            labels=self.config.metrics_labels,
        )
        if self.config.batching not in ("continuous", "fifo"):
            raise ValueError(
                f"batching must be 'continuous' or 'fifo', got "
                f"{self.config.batching!r}"
            )
        self._batcher = self._make_batcher()
        self._active: Optional[_ActiveModel] = None
        self._swap_lock = threading.Lock()
        # Serializes pointer-FOLLOWING swaps (listener delivery + the
        # follow_registry catch-up): each re-reads CURRENT under this
        # lock, so racing swap threads converge on the newest pointer
        # instead of flipping the active model out of order.
        self._follow_swap_lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        # Fed by the dispatcher AND by shedding caller threads — the
        # shared window serializes them and publishes p50/p99 gauges.
        self._latency_window = LatencyWindow(
            self._metrics, self.config.latency_window
        )
        self._following = False       # listener currently registered
        self._follow_requested = False  # survives stop(): restart re-follows

    def _make_batcher(self) -> AdaptiveMicroBatcher:
        cls = (
            ContinuousBatcher if self.config.batching == "continuous"
            else AdaptiveMicroBatcher
        )
        return cls(
            max_batch_rows=self.config.max_batch_rows,
            max_wait_s=self.config.max_wait_ms / 1000.0,
            max_queue_rows=self.config.max_queue_rows,
        )

    # -- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def active_version(self) -> Optional[int]:
        active = self._active
        return active.version if active else None

    @property
    def queued_rows(self) -> int:
        """Rows currently queued in the batcher — the public backlog
        signal (the pool autoscaler and the multi-model scale target
        both consume it; don't reach for ``_batcher``)."""
        return self._batcher.queued_rows

    @property
    def observed_p99_ms(self) -> Optional[float]:
        """The latest p99 latency gauge (None before any completion) —
        the public latency signal for autoscaling."""
        p99 = self._metrics.snapshot()["gauges"].get("p99_ms")
        return float(p99) if isinstance(p99, (int, float)) else None

    def start(self) -> "ServingEngine":
        """Load the model (registry: current version), precompile every
        warmup bucket, and start the dispatcher thread. Returns self."""
        if self.running:
            return self
        if self._batcher._stopped:  # restart after stop(): fresh queue
            self._batcher = self._make_batcher()
        if self._registry is not None:
            version, model = self._registry.get()
        else:
            version, model = None, self._fixed_model
        self._install(version, model)
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._dispatch_loop,
            name=f"serving-{self.name}",
            daemon=True,
        )
        self._thread.start()
        if self._follow_requested:  # re-follow across a stop()/start() cycle
            self.follow_registry()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop accepting requests; with ``drain`` (default) the
        dispatcher finishes everything already queued, otherwise queued
        requests fail with :class:`EngineStoppedError`."""
        self._batcher.stop()
        if not drain:
            for req in self._batcher.drain_pending():
                req.fail(EngineStoppedError("serving engine stopped"))
        self._stop_event.set()
        if self.device.type == "cpu":
            _CPU_HOST.kick()
        # Unfollow BEFORE the join (safe regardless of its outcome): a
        # stopped engine must not keep paying load+warmup in publishing
        # threads on every registry event.
        if self._following and self._registry is not None:
            self._registry.remove_listener(self._on_registry_change)
            self._following = False
        # Local capture: stop() may run concurrently (the pool's retire
        # thread and pool.stop() both stop a dead replica) and the loser
        # must not trip over the winner clearing self._thread.
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                # join timed out mid-batch: keep the reference so running
                # stays True and start() cannot spawn a second dispatcher
                # over the same batcher while the orphan drains.
                return
            self._thread = None

    # -- hot swap ----------------------------------------------------------
    def swap_to(self, version: Optional[int] = None) -> int:
        """Load ``version`` (default: the registry's current) and swap it
        in with zero downtime: the load + per-bucket warmup run in the
        calling thread while the dispatcher keeps serving the old model;
        only the final reference flip is atomic. Returns the version."""
        if self._registry is None:
            raise RegistryError(
                "swap_to requires a ModelRegistry-backed engine"
            )
        target = (int(version) if version is not None
                  else self._registry.current_version())
        if target is not None and self._try_delta_swap(target):
            return target
        v, model = self._registry.get(version)
        self._install(v, model)
        return v

    def follow_registry(self) -> "ServingEngine":
        """Auto-swap on every registry publish/rollback (the swap —
        including warmup — runs in the publishing thread)."""
        if self._registry is None:
            raise RegistryError(
                "follow_registry requires a ModelRegistry-backed engine"
            )
        self._follow_requested = True
        if not self._following:
            self._registry.add_listener(self._on_registry_change)
            self._following = True
        # Catch-up swap: a publish that landed between our load and the
        # listener registration would otherwise never be delivered.
        self._swap_to_current()
        return self

    def _on_registry_change(self, version: int) -> None:
        self._swap_to_current()

    def _swap_to_current(self) -> None:
        """Install whatever CURRENT points at right now (no-op when it is
        already active). Re-reading the pointer under the serialization
        lock makes concurrent deliveries converge on the newest version —
        a slow catch-up swap cannot overwrite a newer listener swap."""
        with self._follow_swap_lock:
            current = self._registry.current_version()
            if current is None:
                return
            active = self._active
            if active is not None and active.version == current:
                return
            if self._try_delta_swap(current):
                return
            v, model = self._registry.get(current)
            self._install(v, model)

    def _try_delta_swap(self, target: int) -> bool:
        """The incremental-publish fast path: when the registry holds an
        unbroken delta chain from the ACTIVE version to ``target`` and
        the active model is delta-capable, patch a clone in place —
        no full model load, no warmup (row patches keep every shape, so
        the built dispatch programs are reused as-is) — and flip it
        atomically. The old model object is untouched, so an in-flight
        batch that snapshotted it still serves exactly one version. Returns False (caller falls back to a verified
        full load) on any miss: registry-less engine, no active model,
        no chain, fingerprint mismatch, or a lost race with a concurrent
        full install."""
        active = self._active
        if (self._registry is None or active is None
                or active.version is None
                or not hasattr(active.model, "apply_delta")
                or not hasattr(active.model, "delta_state")):
            return False
        chain = self._registry.delta_chain(active.version, target)
        if not chain:
            return False
        from flinkml_tpu_torch.io.read_write import content_fingerprint

        try:
            # One cheap link check anchors the chain to the live model:
            # chain-internal links were verified at publish/get time, so
            # version linkage plus this base fingerprint makes the
            # patched state bitwise what a full load would produce.
            if chain[0].base_fingerprint != content_fingerprint(
                    active.model.delta_state()):
                return False
            model = active.model
            for d in chain:
                model = model.apply_delta(d)
            if self.config.refuse_nonfinite:
                from flinkml_tpu_torch.recovery.sentinel import check_stage_finite

                check_stage_finite(
                    model,
                    where=(f"serve (engine {self.name!r}, delta swap to "
                           f"version {target})"),
                )
        except Exception:
            # Any resolution/patch failure falls back to the fully
            # verified load path, which raises the typed error.
            return False
        with self._swap_lock:
            if self._active is not active:
                return False  # a concurrent install won; let it stand
            self._active = _ActiveModel(target, model)
        self._metrics.counter("swaps")
        self._metrics.counter("delta_swaps")
        self._metrics.gauge("active_version", target)
        return True

    def _install(self, version: Optional[int], model: Any) -> None:
        if self.config.mesh is not None and hasattr(model, "for_mesh"):
            # Mesh-bindable models (flinkml_tpu_torch.embeddings.serving,
            # features.model): the shared source model carries host state
            # only; each engine binds a clone PLACED on its own mesh here,
            # so a pool loads one table per replica instead of racing
            # placements on a shared object.
            model = model.for_mesh(self.config.mesh)
        if self.config.refuse_nonfinite:
            # Refuse BEFORE warmup/flip: a follower's failed swap keeps
            # the previous (finite) model serving — the registry's own
            # publish check makes this a second line of defense, not the
            # first.
            from flinkml_tpu_torch.recovery.sentinel import check_stage_finite

            check_stage_finite(
                model,
                where=f"serve (engine {self.name!r}, version {version})",
            )
        if self.config.hbm_budget_bytes is not None:
            # Budget gate, also BEFORE warmup/flip: estimate the model's
            # per-device footprint at this engine's precision tier and
            # refuse a model that cannot fit — a follower's refused swap
            # keeps the old (fitting) model serving instead of running
            # the replica out of memory mid-swap.
            from flinkml_tpu_torch.analysis.memory import estimate_serving_bytes
            from flinkml_tpu_torch.sharding.plan import human_bytes

            budget = int(self.config.hbm_budget_bytes)
            est = estimate_serving_bytes(
                model, self._schema, self.config.max_batch_rows,
                policy=self._policy,
            )
            if est > budget:
                raise ServingMemoryError(
                    f"engine {self.name!r} refuses model version "
                    f"{version}: estimated per-device footprint "
                    f"{human_bytes(est)} exceeds hbm_budget_bytes="
                    f"{human_bytes(budget)} (learned arrays at the "
                    f"{self._policy.name if self._policy else 'full'} "
                    f"tier + 3 batch buffers at max_batch_rows="
                    f"{self.config.max_batch_rows}); the previous model "
                    "keeps serving"
                )
        # Warmup dispatches real transforms on the engine's device and
        # stream (in the installing thread: the caller of start/swap_to,
        # or a registry publisher); a mesh engine holds the mesh lock
        # here too. Warmup runs under the engine's precision scope, so
        # the FML6xx pre-build gate fires HERE: a policy-violating model
        # fails the install (the old model keeps serving) instead of
        # failing live traffic.
        with self._dispatch_guard(), \
                pipeline_fusion.precision_scope(self._policy):
            buckets = self._warmup(model)
        with self._swap_lock:
            first = self._active is None
            self._active = _ActiveModel(version, model)
        # Full (load+warmup) installs are counted so the freshness loop
        # can assert the hot path never re-ships the whole model.
        self._metrics.counter("full_loads")
        if not first:
            self._metrics.counter("swaps")
        if version is not None:
            self._metrics.gauge("active_version", version)
        self._metrics.gauge("warmed_buckets", float(len(buckets)))

    def _warmup(self, model: Any) -> List[int]:
        cfg = self.config
        row_counts = (
            cfg.warmup_row_counts
            if cfg.warmup_row_counts is not None
            else _all_buckets_up_to(cfg.max_batch_rows)
        )
        buckets, read = pipeline_fusion.warmup_transform(
            model, self._example, row_counts,
            output_cols=self._output_cols or (),
        )
        if self._output_cols is None:
            if not read:  # warmup disabled (empty row_counts): discover
                (out,) = model.transform(self._example)
                read = tuple(
                    c for c in out.column_names
                    if c not in self._example.column_names
                )
            if not read:
                # A model that only overwrites its input columns in place
                # defeats added-column discovery — silent empty responses
                # would be far worse than failing the load.
                raise ServingSchemaError(
                    "could not infer output columns: transform adds no new "
                    "columns to the example (in-place overwrite?); pass "
                    "output_cols= explicitly"
                )
            self._output_cols = read  # discovered during warmup, for free
        return buckets

    # -- request path ------------------------------------------------------
    def predict(
        self,
        features: Union[Table, Mapping[str, Any]],
        timeout_ms: Optional[float] = None,
    ) -> ServingResponse:
        """Synchronous prediction: enqueue, micro-batch, return the
        request's slice of the batch output. Thread-safe; call it from as
        many client threads as you like."""
        self._check_running()
        columns, rows = self._normalize(features)
        t0 = time.monotonic()
        timeout = (
            timeout_ms if timeout_ms is not None
            else self.config.default_timeout_ms
        )
        deadline = t0 + timeout / 1000.0 if timeout is not None else None
        req = ServingRequest(
            columns=columns, rows=rows, enqueued_at=t0, deadline=deadline
        )
        self._metrics.counter("requests")
        self._metrics.counter("rows", float(rows))
        if not self._batcher.offer(req):
            return self._overloaded(req, t0)
        self._metrics.gauge("queue_depth", self._batcher.queue_depth)
        remaining = None if deadline is None else max(
            0.0, deadline - time.monotonic()
        )
        # Grace on top of the deadline: the dispatcher expires queued
        # requests itself; in-flight batches get a moment to finish.
        if not req.done.wait(None if remaining is None else remaining + 0.25):
            if req.claim_timeout_count():
                self._metrics.counter("timeouts")
            raise ServingTimeoutError(
                f"request did not complete within {timeout}ms"
            )
        if req.error is not None:
            raise req.error
        latency_ms = (time.monotonic() - t0) * 1000.0
        return ServingResponse(
            columns=req.result, version=req.version,
            latency_ms=latency_ms, shed=req.shed,
        )

    def submit(
        self,
        features: Union[Table, Mapping[str, Any]],
        timeout_ms: Optional[float] = None,
    ) -> "PendingPrediction":
        """Asynchronous prediction: enqueue and return a
        :class:`PendingPrediction` handle instead of blocking. The
        router's gray-failure path is built on this — it lets a caller
        stop WAITING on a dispatch (``handle.abandon()``) without being
        able to stop the device work, which is exactly the per-attempt
        deadline/hedging contract. Unlike :meth:`predict`, a full queue
        always raises the typed :class:`ServingOverloadError` (never
        sheds to the host path — shedding is a synchronous caller-thread
        degradation; an async caller wants the queue or a refusal)."""
        self._check_running()
        columns, rows = self._normalize(features)
        t0 = time.monotonic()
        timeout = (
            timeout_ms if timeout_ms is not None
            else self.config.default_timeout_ms
        )
        deadline = t0 + timeout / 1000.0 if timeout is not None else None
        req = ServingRequest(
            columns=columns, rows=rows, enqueued_at=t0, deadline=deadline
        )
        self._metrics.counter("requests")
        self._metrics.counter("rows", float(rows))
        if not self._batcher.offer(req):
            self._metrics.counter("rejected")
            raise ServingOverloadError(
                f"serving queue full ({self._batcher.max_queue_rows} rows); "
                "retry with backoff"
            )
        self._metrics.gauge("queue_depth", self._batcher.queue_depth)
        return PendingPrediction(self, req, t0)

    def _overloaded(self, req: ServingRequest, t0: float) -> ServingResponse:
        """Queue-full policy: shed to the per-stage path (each stage's own
        ``transform``, on the engine's device) in the caller's thread, or reject with the typed overload error. The
        deadline contract survives shedding: an already-expired request
        times out instead of blocking the caller on the slower path."""
        if not self.config.shed_on_overload:
            self._metrics.counter("rejected")
            raise ServingOverloadError(
                f"serving queue full ({self._batcher.max_queue_rows} rows); "
                "retry with backoff"
            )
        if req.deadline is not None and req.deadline <= time.monotonic():
            if req.claim_timeout_count():
                self._metrics.counter("timeouts")
            raise ServingTimeoutError(
                "request deadline expired at admission (queue saturated)"
            )
        self._metrics.counter("shed_requests")
        active = self._active
        # Same locking discipline as _serve_batch/_install: an SPMD
        # engine's per-stage transform still dispatches multi-device
        # programs, so shedding must not bypass the mesh lock (and the
        # dispatch stays visible to the FML302 trace audit).
        with self._dispatch_guard():
            from flinkml_tpu_torch.parallel import dispatch as _dispatch

            if _dispatch.has_dispatch_observers():
                _dispatch.record_collective_dispatch(
                    "serving.shed", self._device_ids()
                )
            table = _transform_per_stage(active.model, Table(req.columns))
            result = {
                c: np.asarray(table.column(c)) for c in self._output_cols
            }
        latency_ms = (time.monotonic() - t0) * 1000.0
        self._record_latency(latency_ms)
        return ServingResponse(
            columns=result, version=active.version,
            latency_ms=latency_ms, shed=True,
        )

    def _normalize(
        self, features: Union[Table, Mapping[str, Any]]
    ) -> Tuple[Dict[str, np.ndarray], int]:
        if isinstance(features, Table):
            features = {n: features.column(n) for n in features.column_names}
        if set(features.keys()) != set(self._schema.keys()):
            raise ServingSchemaError(
                f"request columns {sorted(features.keys())} != schema "
                f"columns {sorted(self._schema.keys())}"
            )
        out: Dict[str, np.ndarray] = {}
        rows: Optional[int] = None
        for name, (dtype, trailing) in self._schema.items():
            a = np.asarray(features[name], dtype=dtype)
            if a.ndim == len(trailing):  # single row, leading axis omitted
                a = a[None]
            if a.shape[1:] != trailing:
                raise ServingSchemaError(
                    f"column {name!r} has trailing shape {a.shape[1:]}, "
                    f"schema expects {trailing}"
                )
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise ServingSchemaError(
                    f"column {name!r} has {a.shape[0]} rows, others have "
                    f"{rows}"
                )
            out[name] = a
        if not rows:
            raise ServingSchemaError("empty request (zero rows)")
        if rows > self.config.max_batch_rows:
            raise ServingSchemaError(
                f"request has {rows} rows > max_batch_rows "
                f"{self.config.max_batch_rows}; split it client-side"
            )
        return out, rows

    # -- dispatcher --------------------------------------------------------
    def _dispatch_loop(self) -> None:
        if self.device.type == "cpu":
            _CPU_HOST.serve(self)
            return
        while True:
            batch, expired = self._batcher.next_batch(poll_s=0.02)
            self._expire(expired)
            if batch:
                self._serve_batch(batch)
            elif self._stop_event.is_set() and self._batcher.queue_depth == 0:
                return
            self._metrics.gauge("queue_depth", self._batcher.queue_depth)

    def _expire(self, expired: List[ServingRequest]) -> None:
        for req in expired:
            if req.claim_timeout_count():
                self._metrics.counter("timeouts")
            req.fail(ServingTimeoutError(
                "request expired while queued (deadline passed before "
                "dispatch)"
            ))

    def _serve_batch(self, batch: List[BatchSegment]) -> None:
        if faults.ACTIVE is None or self._replica_seam(batch):
            self._run_batch(batch)

    def _replica_seam(self, batch: List[BatchSegment]) -> bool:
        """Fire the replica-kill seam (pool chaos) for ``batch``; False
        when it raised and failed the batch."""
        try:
            faults.fire("serving.replica", engine=self.name,
                        rows=sum(s.rows for s in batch))
        except BaseException as e:  # noqa: BLE001 — fail the batch
            self._fail_batch(batch, e)
            return False
        return True

    def _fail_batch(self, batch: List[BatchSegment],
                    error: BaseException) -> None:
        self._metrics.counter("errors")
        for seg in batch:
            seg.request.fail(error)

    def _run_batch(self, batch: List[BatchSegment]) -> None:
        active = self._active  # snapshot: in-flight work stays on it
        rows = sum(s.rows for s in batch)
        try:
            cols = [s.columns for s in batch]
            packed = {
                name: (
                    np.concatenate([c[name] for c in cols])
                    if len(batch) > 1 else cols[0][name]
                )
                for name in self._schema
            }
            table = Table(packed)
            with self._dispatch_guard(), \
                    pipeline_fusion.precision_scope(self._policy):
                from flinkml_tpu_torch.parallel import dispatch as _dispatch

                if _dispatch.has_dispatch_observers():
                    # The event carries the lock tokens this thread holds,
                    # so analysis.collectives.check_dispatch_trace can
                    # audit serving+training runs (FML302/FML303).
                    _dispatch.record_collective_dispatch(
                        f"{self.config.dispatch_tag or 'serving'}.batch",
                        self._device_ids(),
                    )
                (out,) = active.model.transform(table)
                host = {
                    c: np.asarray(out.column(c)) for c in self._output_cols
                }
        except BaseException as e:  # noqa: BLE001 — fail the batch, not the loop
            self._fail_batch(batch, e)
            return
        bucket = pipeline_fusion.row_bucket(rows)
        self._metrics.counter("batches")
        self._metrics.counter("batch_rows", float(rows))
        self._metrics.counter("batch_padded_rows", float(bucket))
        self._metrics.gauge("last_batch_occupancy", rows / bucket)
        now = time.monotonic()
        offset = 0
        completions = []
        for seg in batch:
            # Copies, not views: responses to different clients must not
            # alias one batch buffer (a client post-processing its arrays
            # in place would corrupt its batchmates' results).
            sliced = {
                c: host[c][offset:offset + seg.rows].copy() for c in host
            }
            offset += seg.rows
            outcome = seg.request.add_segment(
                seg.start, sliced, active.version, seg.rows
            )
            if outcome is None:
                continue  # more segments to come
            if outcome == "discarded":
                # The submitter abandoned this request (per-attempt
                # deadline or lost hedge race) — or it expired/failed —
                # while the batch was in flight: the straggler rows are
                # DISCARDED, never surfaced as a duplicate or (after a
                # hot swap) mis-versioned response.
                self._metrics.counter("discarded_results")
                continue
            if outcome == "mixed":
                # A hot swap landed between this request's segments: one
                # response must carry ONE version, so discard the partials
                # and re-dispatch the whole request on the new model.
                seg.request.reset_segments()
                self._metrics.counter("redispatched_for_version")
                if not self._batcher.requeue(seg.request):
                    seg.request.fail(EngineStoppedError(
                        "engine stopped while re-dispatching a request "
                        "split across a model swap"
                    ))
                continue
            completions.append((seg.request, *outcome))
        if completions:
            # Gauges first, completions second: a client reading stats
            # right after its predict() returns sees its own request
            # reflected. One lock acquisition + one sort for the batch.
            self._latency_window.record(*(
                (now - req.enqueued_at) * 1000.0
                for req, _, _ in completions
            ))
        for req, result, version in completions:
            if not req.complete(result, version):
                # The submitter abandoned this request (per-attempt
                # deadline or lost hedge race) while the batch was in
                # flight: the straggler result is DISCARDED here — it
                # must never surface as a duplicate or (after a hot
                # swap) mis-versioned response.
                self._metrics.counter("discarded_results")

    @contextlib.contextmanager
    def _dispatch_guard(self):
        """Every dispatch of this engine, in whichever thread: on the
        engine's device (``use_device``), on its own CUDA stream there,
        and — with ``config.mesh`` — under the mesh's
        ``local_execution_lock`` (see module docstring). On leaving, the
        thread waits for the engine's stream (never for the whole
        device), so nothing the block enqueued is still running."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(use_device(self.device))
            stream = self._cuda_stream()
            if stream is not None:
                stack.enter_context(torch.cuda.stream(stream))
                stack.callback(stream.synchronize)
            if self.config.mesh is not None:
                from flinkml_tpu_torch.parallel.dispatch import local_execution_lock

                stack.enter_context(local_execution_lock(self.config.mesh))
            yield

    def _cuda_stream(self):
        if self.device.type != "cuda":
            return None
        if self._stream is None:
            with self._swap_lock:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _device_ids(self) -> Tuple[int, ...]:
        from flinkml_tpu_torch.parallel.dispatch import _device_id

        if self.config.mesh is not None:
            return tuple(self.config.mesh.device_ids)
        return (_device_id(self.device),)

    def _record_latency(self, latency_ms: float) -> None:
        self._latency_window.record(latency_ms)

    def _check_running(self) -> None:
        if not self.running:
            raise EngineStoppedError(
                "serving engine is not running; call start()"
            )

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Point-in-time operational snapshot (the stats-endpoint dump)."""
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

    def stats_text(self) -> str:
        """Prometheus-style exposition of the whole process registry
        (:meth:`flinkml_tpu_torch.utils.metrics.MetricsRegistry.render_text`)."""
        from flinkml_tpu_torch.utils.metrics import default_registry

        return default_registry().render_text()


class PendingPrediction:
    """Handle to one request submitted via :meth:`ServingEngine.submit`.

    The handle owns the CLIENT side of the request only: the caller can
    wait on it, read the response once done, or ``abandon()`` it — which
    stops the waiting, releases the request's queued rows at the
    batcher's next sweep, and guarantees (via :meth:`ServingRequest
    .complete`'s CAS) that a straggler batch result is discarded rather
    than published. The device work itself is not interruptible; that is
    the point — gray-failure defense is about not *waiting* on a stalled
    replica, not about pretending its work can be cancelled."""

    def __init__(self, engine: ServingEngine, request: ServingRequest,
                 t0: float):
        self.engine = engine
        self.request = request
        self.t0 = t0

    @property
    def done(self) -> bool:
        return self.request.done.is_set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self.request.done.wait(timeout_s)

    def abandon(self) -> bool:
        """Stop waiting (CAS — see :meth:`ServingRequest.abandon`).
        True for exactly one abandoner; False when a result or error
        already landed."""
        if self.request.abandon():
            self.engine._metrics.counter("abandoned")
            return True
        return False

    def response(self) -> ServingResponse:
        """The completed response (call after :meth:`wait` returned
        True); raises the request's typed error if it failed, and
        :class:`ServingTimeoutError` if it was abandoned."""
        req = self.request
        if not req.done.is_set():
            raise RuntimeError("pending prediction has not completed")
        if req.abandoned:
            raise ServingTimeoutError(
                "request was abandoned by its submitter"
            )
        if req.error is not None:
            raise req.error
        return ServingResponse(
            columns=req.result, version=req.version,
            latency_ms=(time.monotonic() - self.t0) * 1000.0,
            shed=req.shed,
        )


def _resolve_device(cfg: ServingConfig) -> torch.device:
    """The engine's device: ``cfg.device``, else a mesh's device, else the
    constructing thread's requested device (a bare ``cuda`` pinned to the
    current card)."""
    if cfg.device is not None:
        device = torch.device(cfg.device)
    elif cfg.mesh is not None:
        device = torch.device(cfg.mesh.device)
    else:
        device = requested_device()
    if (device.type == "cuda" and device.index is None
            and torch.cuda.is_available()):
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _all_buckets_up_to(max_rows: int) -> List[int]:
    buckets = []
    b = pipeline_fusion.MIN_ROW_BUCKET
    top = pipeline_fusion.row_bucket(max_rows)
    while b <= top:
        buckets.append(b)
        b *= 2
    return buckets


def _transform_per_stage(model: Any, table: Table) -> Table:
    """The unfused path: chain each stage's own ``transform`` (on the
    caller's device scope — the engine's). A kernel error propagates; it
    is never retried another way.
    Identical semantics to ``PipelineModel.transform`` with fusion
    disabled, without touching the process-wide fusion switch (other
    threads may be mid-fused-dispatch)."""
    stages = getattr(model, "stages", None)
    if stages is None:
        (out,) = model.transform(table)
        return out
    for stage in stages:
        (table,) = stage.transform(table)
    return table
