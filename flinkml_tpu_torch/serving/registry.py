"""Versioned model registry with an atomic "current" pointer.

Layout (on top of the stage persistence format of
:mod:`flinkml_tpu_torch.io.read_write` — any save/load-able Stage publishes,
including whole :class:`~flinkml_tpu_torch.pipeline.PipelineModel` chains)::

    <root>/
      versions/
        000001/           # a saved stage directory (metadata + data/)
        000002/
      CURRENT             # JSON {"version": 2, "timestamp": ...}

Publication is crash-safe in two steps: the stage saves into a hidden
temp directory that is ``os.rename``d to its final numbered home (a
half-written save can never be listed as a version), then ``CURRENT`` is
replaced atomically (``os.replace`` of a temp file — the symlink-swap
idiom without symlinks, portable to filesystems that lack them). Readers
therefore always observe either the old or the new pointer, never a torn
state — the property the serving engine's zero-downtime hot swap rests
on.

Integrity: every model saved through ``Model._save_with_arrays`` records
a sha256 content fingerprint in its metadata, and :meth:`ModelRegistry.get`
loads through the standard stage loader, which verifies it — a corrupt or
tampered snapshot raises
:class:`~flinkml_tpu_torch.io.read_write.ModelIntegrityError` instead of being
swapped into a live engine.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Callable, List, Optional, Tuple

import flinkml_tpu_torch.faults as faults
from flinkml_tpu_torch.io import read_write
from flinkml_tpu_torch.serving.errors import (
    DeltaChainError,
    ModelVersionNotFoundError,
    RegistryError,
)
from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import metrics

_log = get_logger("serving.registry")

CURRENT_FILE = "CURRENT"
VERSIONS_DIR = "versions"
PUBLISH_TAG_FILE = "PUBLISH_TAG"
WATERMARK_FILE = "WATERMARK"
_TMP_PREFIX = ".tmp-"


class ModelRegistry:
    """Thread-safe versioned store of published models.

    ``publish`` assigns monotonically increasing integer versions (or
    honors an explicit one), ``get`` loads the current (or a pinned)
    version, ``rollback`` repoints ``CURRENT`` at an existing older
    version without touching its files. Listeners registered via
    :meth:`add_listener` are invoked with the new current version after
    every successful publish/rollback — the serving engine's auto-swap
    hook.
    """

    def __init__(self, root: str):
        self.root = root
        self._versions_root = os.path.join(root, VERSIONS_DIR)
        os.makedirs(self._versions_root, exist_ok=True)
        self._lock = threading.RLock()
        self._notify_lock = threading.Lock()
        self._listeners: List[Callable[[int], None]] = []
        self._metrics = metrics.group("serving.registry")
        # dedupe-key index: version -> key for scanned versions (lazily
        # extended; a fresh instance after a restart rescans from disk, so
        # idempotence survives the process that published dying).
        self._dedupe_keys: dict = {}
        self._dedupe_scanned: set = set()
        # version -> source-batch watermark (immutable once published, so
        # plain memoization; None is cached for unstamped versions).
        self._watermarks: dict = {}

    # -- introspection -----------------------------------------------------
    def versions(self) -> List[int]:
        """Sorted list of published version numbers (complete saves only:
        a version exists once its directory has stage metadata)."""
        out = []
        for name in os.listdir(self._versions_root):
            if name.startswith(_TMP_PREFIX) or not name.isdigit():
                continue
            if os.path.exists(os.path.join(
                    self._versions_root, name, read_write.METADATA_FILE)):
                out.append(int(name))
        return sorted(out)

    def current_version(self) -> Optional[int]:
        """The version ``CURRENT`` points at, or None before any publish."""
        try:
            with open(os.path.join(self.root, CURRENT_FILE)) as f:
                return int(json.load(f)["version"])
        except FileNotFoundError:
            return None

    def path_of(self, version: int) -> str:
        return os.path.join(self._versions_root, f"{int(version):06d}")

    def find_dedupe(self, dedupe_key: str) -> Optional[int]:
        """The version already published under ``dedupe_key``, or None.

        Keys are recorded atomically with the version's files (the tag
        file rides the same rename), so a restarted publisher — even a
        fresh process — sees exactly the publishes that committed."""
        with self._lock:
            for v in self.versions():
                if v in self._dedupe_scanned:
                    continue
                self._dedupe_scanned.add(v)
                tag = os.path.join(self.path_of(v), PUBLISH_TAG_FILE)
                try:
                    with open(tag) as f:
                        self._dedupe_keys[v] = json.load(f)["dedupeKey"]
                except (OSError, ValueError, KeyError):
                    continue  # untagged (or pre-dedupe) version
            for v, key in self._dedupe_keys.items():
                if key == dedupe_key:
                    return v
        return None

    # -- writes ------------------------------------------------------------
    def publish(self, stage: Any, version: Optional[int] = None,
                dedupe_key: Optional[str] = None,
                check_finite: bool = True,
                watermark: Optional[int] = None) -> int:
        """Save ``stage`` as a new version and repoint ``CURRENT`` at it.

        ``check_finite`` (default on) refuses a model whose learned
        arrays hold non-finite values with a typed
        :class:`~flinkml_tpu_torch.recovery.NonFiniteModelError` BEFORE any
        file is written — a NaN'd model must never become a registry
        version a follower could hot-swap into a live engine (the
        publish half of the self-healing contract).

        Returns the assigned version. The version number is claimed by an
        atomic ``mkdir`` of the final directory — safe against concurrent
        publishers in other THREADS and other PROCESSES sharing the
        registry root (e.g. per-rank SnapshotPublishers): a taken number
        bumps to the next free one. The save lands in a temp directory
        renamed over the (empty) claimed directory, so readers never see
        a partial version; the pointer flip is atomic (concurrent
        cross-process publishes leave CURRENT at whichever publish
        flipped it last). Raises :class:`RegistryError` when an explicit
        ``version`` already exists.

        ``dedupe_key`` makes publication idempotent: when a committed
        version already carries the key (same epoch + content
        fingerprint — see :class:`~flinkml_tpu_torch.serving.publisher.
        SnapshotPublisher`), that version is returned and NOTHING is
        written — the resume-then-republish path cannot grow duplicate
        versions.

        ``watermark`` stamps the version with its source-batch watermark
        (a ``WATERMARK`` file that rides the same atomic rename as the
        save) — the freshness currency :meth:`watermark_of` and the
        pool's ``serving.<pool>.freshness`` gauge read. Stages that are
        incremental deltas (``is_model_delta``) are counted separately
        (``delta_publishes``) and resolved against their base chain at
        :meth:`get` time."""
        if check_finite:
            # Outside the lock (pure read of the stage), before the seam:
            # a refused publish never counts as a fault-plan event.
            from flinkml_tpu_torch.recovery.sentinel import check_stage_finite

            check_stage_finite(stage, where="publish")
        with self._lock:
            if faults.ACTIVE is not None:  # dropped-publish seam
                faults.fire("registry.publish", root=self.root,
                            version=-1 if version is None else int(version))
            if dedupe_key is not None:
                existing = self.find_dedupe(dedupe_key)
                if existing is not None:
                    self._metrics.counter("publishes_deduped")
                    _log.info(
                        "publish deduplicated: key %r already committed as "
                        "version %d", dedupe_key, existing,
                    )
                    return existing
            v = None if version is None else int(version)
            candidate = v
            if candidate is None:
                existing = self.versions()
                candidate = existing[-1] + 1 if existing else 1
            while True:
                final = self.path_of(candidate)
                try:
                    os.mkdir(final)  # atomic cross-process claim
                    break
                except FileExistsError:
                    if v is not None:
                        raise RegistryError(
                            f"version {v} already exists in registry "
                            f"{self.root}"
                        )
                    candidate += 1
            v = candidate
            tmp = os.path.join(self._versions_root, f"{_TMP_PREFIX}{v:06d}")
            if os.path.exists(tmp):  # leftover of a crashed publish
                shutil.rmtree(tmp)
            try:
                stage.save(tmp)
                if dedupe_key is not None:
                    # Written INSIDE the temp dir: the tag commits in the
                    # same atomic rename as the version itself.
                    with open(os.path.join(tmp, PUBLISH_TAG_FILE), "w") as f:
                        json.dump({"dedupeKey": dedupe_key}, f)
                if watermark is not None:
                    with open(os.path.join(tmp, WATERMARK_FILE), "w") as f:
                        json.dump({"watermark": int(watermark)}, f)
                # POSIX rename onto an existing EMPTY directory: the
                # claimed placeholder becomes the complete save in one
                # atomic step.
                os.rename(tmp, final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                try:
                    os.rmdir(final)  # release the claim
                except OSError:
                    pass  # surface the original failure, not the cleanup's
                raise
            if dedupe_key is not None:
                self._dedupe_keys[v] = dedupe_key
                self._dedupe_scanned.add(v)
            if watermark is not None:
                self._watermarks[v] = int(watermark)
            self._set_current(v)
            self._metrics.counter("publishes")
            if getattr(stage, "is_model_delta", False):
                self._metrics.counter("delta_publishes")
            else:
                self._metrics.counter("full_publishes")
            self._metrics.gauge("current_version", v)
            _log.info("published version %d to %s%s", v, self.root,
                      f" (key {dedupe_key!r})" if dedupe_key else "")
        self._notify()
        return v

    def rollback(self, version: int) -> int:
        """Repoint ``CURRENT`` at an existing ``version`` (no files are
        deleted — rolling forward again is another rollback)."""
        with self._lock:
            v = int(version)
            if v not in self.versions():
                raise ModelVersionNotFoundError(
                    f"version {v} not in registry {self.root} "
                    f"(has {self.versions()})"
                )
            self._set_current(v)
            self._metrics.counter("rollbacks")
            self._metrics.gauge("current_version", v)
        self._notify()
        return v

    # -- reads -------------------------------------------------------------
    def get(self, version: Optional[int] = None) -> Tuple[int, Any]:
        """Load ``(version, stage)`` — the current version by default.

        Loading goes through the standard reflective stage loader, so
        every model with a recorded content fingerprint is verified
        (:class:`~flinkml_tpu_torch.io.read_write.ModelIntegrityError` on
        mismatch).

        When the version is an incremental delta, the chain is resolved
        here: walk ``base_version`` links down to a full snapshot, then
        apply upward verifying every fingerprint against the state it
        chains over — so the returned stage is always a complete,
        servable model, bitwise equal to a full-snapshot publish of the
        same trainer state. A pruned base or any fingerprint mismatch is
        a :class:`~flinkml_tpu_torch.serving.errors.DeltaChainError` naming
        the broken link — never a silently wrong model."""
        v, stage = self._load_raw(version)
        if getattr(stage, "is_model_delta", False):
            stage = self._resolve_delta(v, stage)
            self._metrics.counter("delta_loads")
        self._metrics.counter("loads")
        return v, stage

    def _load_raw(self, version: Optional[int] = None) -> Tuple[int, Any]:
        """One version's stage exactly as persisted (deltas stay
        deltas)."""
        with self._lock:
            v = int(version) if version is not None else self.current_version()
            if v is None:
                raise ModelVersionNotFoundError(
                    f"registry {self.root} has no published versions"
                )
            path = self.path_of(v)
            if not os.path.exists(os.path.join(path,
                                               read_write.METADATA_FILE)):
                raise ModelVersionNotFoundError(
                    f"version {v} not in registry {self.root} "
                    f"(has {self.versions()})"
                )
        return v, read_write.load_stage(path)

    def _resolve_delta(self, version: int, delta: Any) -> Any:
        """Walk ``version``'s chain down to its full-snapshot base and
        apply every delta back up, fingerprint-verified at each link."""
        chain = [(version, delta)]  # target-first
        v, stage = version, delta
        while getattr(stage, "is_model_delta", False):
            base_v = stage.base_version
            try:
                base_v, base_stage = self._load_raw(base_v)
            except ModelVersionNotFoundError:
                raise DeltaChainError(
                    f"delta version {v} chains to base version {base_v}, "
                    f"which is not in registry {self.root} (pruned?); "
                    f"the chain for version {version} cannot be resolved"
                ) from None
            v, stage = base_v, base_stage
            if getattr(stage, "is_model_delta", False):
                chain.append((v, stage))
        base_version, model = v, stage
        if not (hasattr(model, "apply_delta")
                and hasattr(model, "delta_state")):
            raise DeltaChainError(
                f"delta chain for version {version} bottoms out at "
                f"version {base_version} ({type(model).__name__}), which "
                "is not delta-capable (no delta_state/apply_delta)"
            )
        fp = read_write.content_fingerprint(model.delta_state())
        prev_v = base_version
        for dv, d in reversed(chain):
            if d.base_fingerprint != fp:
                raise DeltaChainError(
                    f"delta version {dv} -> base {prev_v}: base "
                    f"fingerprint mismatch (delta expects "
                    f"{d.base_fingerprint[:12]}…, base state is "
                    f"{fp[:12]}…) — the chain for version {version} is "
                    "broken at this link"
                )
            model = model.apply_delta(d)
            fp = read_write.content_fingerprint(model.delta_state())
            if d.result_fingerprint != fp:
                raise DeltaChainError(
                    f"delta version {dv} applied on base {prev_v} does "
                    f"not reproduce its recorded result fingerprint "
                    f"({d.result_fingerprint[:12]}… != {fp[:12]}…) — the "
                    f"chain for version {version} is broken at this link"
                )
            prev_v = dv
        self._metrics.gauge("delta_chain_depth", len(chain))
        return model

    def delta_chain(self, base_version: int,
                    target_version: int) -> Optional[List[Any]]:
        """The ordered deltas that carry ``base_version`` to
        ``target_version``, or None when the target does not chain back
        to exactly that base (it IS the base, is a full snapshot, or
        chains past/around it). The serving engine's fast-swap probe:
        a non-None result means the active model can be patched in place
        with no full load."""
        try:
            v, stage = self._load_raw(target_version)
        except ModelVersionNotFoundError:
            return None
        chain: List[Any] = []
        while getattr(stage, "is_model_delta", False):
            chain.append(stage)
            base_v = stage.base_version
            if base_v == int(base_version):
                chain.reverse()
                return chain
            try:
                v, stage = self._load_raw(base_v)
            except ModelVersionNotFoundError:
                return None
        return None

    # -- freshness ---------------------------------------------------------
    def watermark_of(self, version: int) -> Optional[int]:
        """The source-batch watermark ``version`` was published with, or
        None for unstamped versions."""
        v = int(version)
        if v not in self._watermarks:
            try:
                with open(os.path.join(self.path_of(v),
                                       WATERMARK_FILE)) as f:
                    self._watermarks[v] = int(json.load(f)["watermark"])
            except (OSError, ValueError, KeyError):
                self._watermarks[v] = None
        return self._watermarks[v]

    def latest_watermark(self) -> Optional[int]:
        """The newest stamped watermark across all versions — the
        trainer-side edge the pool's freshness lag is measured
        against."""
        marks = [self.watermark_of(v) for v in self.versions()]
        marks = [m for m in marks if m is not None]
        return max(marks) if marks else None

    # -- change notification -----------------------------------------------
    def add_listener(self, callback: Callable[[int], None]) -> None:
        """Register ``callback(current_version)`` for publish/rollback
        events. Delivery is serialized and reads the CURRENT pointer at
        delivery time (concurrent publishes may coalesce into repeated
        notifications of the latest version, but a stale version can
        never be delivered after a newer one). Callbacks run in the
        publishing thread; an exception in one callback is reported as a
        warning (and a ``listener_errors`` counter) rather than unwinding
        into the publisher — the registry state is already committed."""
        self._listeners.append(callback)

    def remove_listener(self, callback: Callable[[int], None]) -> None:
        self._listeners.remove(callback)

    def _notify(self) -> None:
        with self._notify_lock:
            # Read the pointer INSIDE the delivery lock: every delivery
            # happens-after its read, so the last delivery in lock order
            # carries the newest pointer — out-of-order publish threads
            # cannot leave a follower on a stale version.
            version = self.current_version()
            for cb in list(self._listeners):
                try:
                    cb(version)
                except Exception as e:  # noqa: BLE001 — isolate listeners
                    self._metrics.counter("listener_errors")
                    warnings.warn(
                        f"registry listener {cb!r} failed for version "
                        f"{version}: {e!r} (registry state is committed; "
                        "the publishing thread continues)",
                        RuntimeWarning,
                        stacklevel=2,
                    )

    def _set_current(self, version: int) -> None:
        tmp = os.path.join(self.root, CURRENT_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(
                {"version": int(version),
                 "timestamp": int(time.time() * 1000)},
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, CURRENT_FILE))
