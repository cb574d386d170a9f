"""Loop-carry checkpointing: snapshot and restore of ``(state, epoch)``.

The port's counterpart of ``flinkml_tpu.iteration.checkpoint``, one
process. A checkpoint pulls the carry to the host and writes it with the
JAX package's on-disk format, so a snapshot written by either package
restores in the other:

- ``<dir>/ckpt-<epoch>/arrays.npz`` (``leaf_<i>``, one per leaf) and
  ``meta.json`` (``epoch``, ``num_leaves``, ``treedef``, ``world_size``,
  ``layouts``, ``extra`` and the sha256 ``fingerprint`` of the leaves, the
  scheme of :func:`flinkml_tpu_torch.io.read_write.content_fingerprint`),
  published by an atomic rename, so a kill mid-write never damages the
  newest committed snapshot (the ``checkpoint.write`` fault seam fires
  just before the rename, ``checkpoint.committed`` just after it);
- the leaves in the JAX package's tree order (:func:`tree_flatten`: a
  dict by sorted key, as ``jax.tree_util`` flattens it, not in insertion
  order), and ``treedef`` written as ``str(PyTreeDef)`` is.

:meth:`CheckpointManager.restore_latest` verifies manifest, arrays and
fingerprint and walks back past torn or corrupt snapshots;
:class:`CheckpointIntegrityError` only when none survives. A snapshot's
recorded world size is held against the restoring one (one card here,
unless ``world_size`` says otherwise) under a :class:`RescalePolicy`:
``"reshard"`` re-lays out assembled leaves by their layout tags (a
``sharded:<axis>`` leaf must divide across the new world), which
``save(..., plan=plan)`` derives from a sharding plan.

On a mesh of several ranks the ranks share one checkpoint directory:
:func:`save_agreed` commits a replicated state from the mesh's first rank
(or every rank's own state under ``per_rank``, into :func:`rank_scoped`
directories ``rank-<r>``), and the agreement after the write is the
commit barrier, so no rank trains past an uncommitted snapshot and a
failed write aborts every rank. :func:`reshard_rank_state` reassembles a
rank-scoped family written at one world for a rank of another by the
leaves' layout tags; a ``per_rank`` leaf is rank-entangled and refuses
under every policy.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch import faults
from flinkml_tpu_torch.io.read_write import content_fingerprint

_log = logging.getLogger(__name__)


class CheckpointIntegrityError(ValueError):
    """A committed checkpoint failed restore-time verification: its
    manifest is unreadable, its arrays are missing or unloadable, or the
    content fingerprint does not match."""


class LayoutConflictError(ValueError):
    """``CheckpointManager.save`` was given both ``plan=`` and an explicit
    ``layouts=`` that disagree. The plan is the single source of layout
    truth; the message names the first leaf where the two differ."""


class RescaleError(ValueError):
    """Restoring a snapshot under a different world size was refused by
    the manager's :class:`RescalePolicy`. The message names the snapshot
    directory, the epoch, both world sizes and the policy outcome."""


# -- trees in the JAX package's order -------------------------------------------


def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """``(leaves, treedef string)`` of ``tree`` as ``jax.tree_util`` gives
    them: dicts by sorted key, lists and tuples in order, None with no
    leaf, anything else one leaf."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            items = ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node))
            return "{" + items + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(v) for v in node)
            if isinstance(node, list):
                return f"[{inner}]"
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure filled with ``leaves`` in :func:`tree_flatten`'s
    order (a dict keeps ``like``'s key order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            filled = {k: build(node[k]) for k in sorted(node)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _host(leaf: Any, copy: bool) -> np.ndarray:
    """A leaf as a host numpy array (a tensor leaves the device here)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy().copy() if copy \
            else leaf.detach().cpu().numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


# -- per-leaf layout tags -------------------------------------------------------

LAYOUT_REPLICATED = "replicated"
LAYOUT_PER_RANK = "per_rank"


def sharded(axis: int = 0) -> str:
    """The ``sharded:<axis>`` layout tag."""
    return f"sharded:{int(axis)}"


def _parse_layout(tag: str) -> Tuple[str, Optional[int]]:
    if tag == LAYOUT_REPLICATED:
        return "replicated", None
    if tag == LAYOUT_PER_RANK:
        return "per_rank", None
    if isinstance(tag, str) and tag.startswith("sharded:"):
        try:
            return "sharded", int(tag.split(":", 1)[1])
        except ValueError:
            pass
    raise ValueError(
        f"unknown checkpoint leaf layout tag {tag!r}; expected "
        f"'{LAYOUT_REPLICATED}', '{LAYOUT_PER_RANK}', or 'sharded:<axis>'"
    )


@dataclasses.dataclass(frozen=True)
class RescalePolicy:
    """What :meth:`CheckpointManager.restore` does when the snapshot's
    world size differs from the restoring one: ``"reject"`` (default)
    raises :class:`RescaleError`; ``"reshard"`` re-lays out the carry by
    its leaf layout tags (``replicated`` leaves pass, a ``sharded:<axis>``
    leaf keeps its assembled global value and must divide across the new
    world, a ``per_rank`` leaf is refused); ``"allow"`` restores as it
    is, with no validation."""

    on_mismatch: str = "reject"

    def __post_init__(self):
        if self.on_mismatch not in ("reject", "allow", "reshard"):
            raise ValueError(
                "RescalePolicy.on_mismatch must be 'reject', 'allow' or "
                f"'reshard', got {self.on_mismatch!r}"
            )

    @staticmethod
    def reject() -> "RescalePolicy":
        return RescalePolicy("reject")

    @staticmethod
    def allow() -> "RescalePolicy":
        return RescalePolicy("allow")

    @staticmethod
    def reshard() -> "RescalePolicy":
        return RescalePolicy("reshard")

    @staticmethod
    def coerce(value) -> "RescalePolicy":
        """A :class:`RescalePolicy`, one of its mode strings, a legacy bool
        (``allow_rescale``), or None (reject)."""
        if value is None:
            return RescalePolicy.reject()
        if isinstance(value, RescalePolicy):
            return value
        if isinstance(value, bool):
            return RescalePolicy.allow() if value else RescalePolicy.reject()
        if isinstance(value, str):
            return RescalePolicy(value)
        raise TypeError(f"cannot interpret {value!r} as a RescalePolicy")


def _leaves_fingerprint(host_leaves) -> str:
    return content_fingerprint(
        {f"leaf_{i}": leaf for i, leaf in enumerate(host_leaves)}
    )


def begin_resume(manager: Optional["CheckpointManager"], resume: bool,
                 world_size: int) -> Optional[int]:
    """Step 1 of the streamed trainers' checkpoint protocol: check the
    resume/manager pairing and pin the rescale guard to the trainer's
    world. Returns the epoch to restore from, or None for a fresh start."""
    if resume and manager is None:
        raise ValueError("resume=True requires a checkpoint_manager")
    if manager is None:
        return None
    manager.world_size = world_size
    return manager.latest_epoch() if resume else None


def should_snapshot(manager: Optional["CheckpointManager"], interval: int,
                    step: int, total: int, terminal: bool = False) -> bool:
    """Step 2 of the protocol, the save cadence: every ``interval``
    completed steps, and always at the run's end (``step == total`` or
    ``terminal``) whenever a manager is configured."""
    if manager is None:
        return False
    if terminal or step == total:
        return True
    return interval > 0 and step % interval == 0


def _writes_replicated(mesh) -> bool:
    """True on the rank that writes a replicated snapshot: the mesh's
    first rank (the default group's rank 0 without a mesh)."""
    from flinkml_tpu_torch.parallel.distributed import process_index

    if mesh is None or mesh.mesh is None:
        return process_index() == 0
    return mesh.rank == mesh.device_ids[0]


def save_agreed(manager: "CheckpointManager", state: Any, epoch: int,
                mesh=None, per_rank: bool = False,
                extra: Optional[dict] = None, layouts=None,
                plan=None) -> None:
    """A checkpoint save with an agreed commit on a group of several
    processes.

    A replicated state (``per_rank=False``: coefficients, centroids,
    the same bits on every rank) is written by one rank into the shared
    directory (several writers would race on the atomic rename); a
    rank-local state (``per_rank=True``) is written by every rank, into
    its own :func:`rank_scoped` manager. The write is waited for, then
    every rank agrees on its outcome (:func:`~flinkml_tpu_torch.
    iteration.stream_sync.agree_all_ok`): that agreement is the commit
    barrier, and a failed write raises on every rank (its own error on
    the writer). One process: ``manager.save`` (an async write stays
    async)."""
    from flinkml_tpu_torch.parallel.distributed import process_count

    kw = {} if layouts is None else {"layouts": layouts}
    if plan is not None:
        kw["plan"] = plan
    if process_count() == 1:
        manager.save(state, epoch, extra=extra, **kw)
        return
    from flinkml_tpu_torch.iteration.stream_sync import agree_all_ok

    err = None
    if per_rank or _writes_replicated(mesh):
        try:
            manager.save(state, epoch, extra=extra, **kw)
            manager.wait()  # durable before any rank trains past it
        except Exception as e:  # noqa: BLE001 — agreed below
            err = e
    try:
        agree_all_ok(err is None, mesh, "checkpoint commit")
    except ValueError:
        if err is not None:
            raise err
        raise


def save_replicated(manager: "CheckpointManager", state: Any, epoch: int,
                    mesh=None, extra: Optional[dict] = None) -> None:
    """The one-writer commit of a replicated state (:func:`save_agreed`);
    the default layout tag records every leaf as replicated."""
    save_agreed(manager, state, epoch, mesh, per_rank=False, extra=extra)


class AgreedCommits:
    """``manager`` as a loop on a mesh of several ranks must use it: a
    save is :func:`save_agreed` (the mesh's first rank writes a
    replicated state, every rank agrees on the commit) and a restore is
    agreed, a failure on one rank aborting every rank. Anything else is
    the manager's. Hand it to a loop that saves from every rank, such as
    :func:`~flinkml_tpu_torch.iteration.iterate`."""

    def __init__(self, manager: "CheckpointManager", mesh):
        self.manager = manager
        self.mesh = mesh

    def save(self, state: Any, epoch: int, extra: Optional[dict] = None,
             layouts=None, plan=None) -> None:
        save_agreed(self.manager, state, epoch, self.mesh, extra=extra,
                    layouts=layouts, plan=plan)

    def restore(self, epoch: int, like: Any):
        from flinkml_tpu_torch.iteration.stream_sync import agreed_restore

        return agreed_restore(self.manager, epoch, like, self.mesh)

    def restore_latest(self, like: Any):
        from flinkml_tpu_torch.iteration.stream_sync import (
            agreed_restore_latest,
        )

        return agreed_restore_latest(self.manager, like, self.mesh)

    def __getattr__(self, name):
        return getattr(self.manager, name)


def rank_scoped(manager: "CheckpointManager") -> "CheckpointManager":
    """This rank's view of a shared checkpoint directory,
    ``<dir>/rank-<r>`` (``r`` the default group's rank), for a snapshot
    that holds rank-local state: every rank saves and restores its own.
    ``max_to_keep`` is at least 2, so a crash between one rank's save
    (which prunes its previous snapshot) and the agreed commit leaves a
    common epoch. One process: ``manager`` itself."""
    from flinkml_tpu_torch.parallel.distributed import (
        process_count,
        process_index,
    )

    if process_count() == 1:
        return manager
    return CheckpointManager(
        os.path.join(manager.directory, f"rank-{process_index()}"),
        max_to_keep=max(manager.max_to_keep, 2),
        rescale=manager.rescale_policy,
        world_size=manager.world_size,
        async_write=manager.async_write,
    )


class CheckpointManager:
    """Numbered checkpoints of a tree under one directory.

    Each records the world size that wrote it (``world_size``, default 1:
    one card) and a layout tag per leaf; on restore a different recorded
    world size is rejected with :class:`RescaleError` unless ``rescale``
    (or the legacy ``allow_rescale=True``) is ``"allow"``. Snapshots
    written by the JAX package record ``jax.device_count()`` unless its
    manager was given ``world_size`` (1 to restore here by default).

    With ``async_write=True`` the carry comes to the host in :meth:`save`
    (so the snapshot is consistent) and serialisation and the atomic
    publish run on a background thread; at most one write is in flight,
    and a new save, :meth:`wait` or :meth:`close` re-raises a failed one.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 allow_rescale: bool = False,
                 world_size: Optional[int] = None,
                 async_write: bool = False,
                 rescale=None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.rescale_policy = RescalePolicy.coerce(
            rescale if rescale is not None else allow_rescale
        )
        self.world_size = world_size
        self.async_write = async_write
        self._executor: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        #: The ``extra`` manifest of the snapshot the last successful
        #: :meth:`restore` returned (``{}`` before any restore).
        self.last_restored_extra: dict = {}
        os.makedirs(directory, exist_ok=True)

    def _world_size(self) -> int:
        return self.world_size if self.world_size is not None else 1

    @property
    def allow_rescale(self) -> bool:
        return self.rescale_policy.on_mismatch != "reject"

    @staticmethod
    def _layout_list(layouts, like: Any, num_leaves: int) -> List[str]:
        if layouts is None:
            return [LAYOUT_REPLICATED] * num_leaves
        if isinstance(layouts, str):
            _parse_layout(layouts)
            return [layouts] * num_leaves
        tags, tag_def = tree_flatten(layouts)
        if tag_def != tree_flatten(like)[1]:
            raise ValueError(
                "layouts tree structure does not match the state: "
                f"{tag_def} vs {tree_flatten(like)[1]}"
            )
        for tag in tags:
            _parse_layout(tag)
        return list(tags)

    # -- save --------------------------------------------------------------
    def _plan_layouts(self, plan, state, layouts, num_leaves: int):
        """The layout tags ``plan`` derives for ``state``; an explicit
        ``layouts=`` must agree (:class:`LayoutConflictError`)."""
        from flinkml_tpu_torch.sharding.plan import layouts_for, state_names

        derived_tree = layouts_for(plan, state)
        derived = self._layout_list(derived_tree, state, num_leaves)
        if layouts is not None:
            explicit = self._layout_list(layouts, state, num_leaves)
            names = [n for n, _ in state_names(state)]
            for i, (d, e) in enumerate(zip(derived, explicit)):
                if d != e:
                    raise LayoutConflictError(
                        f"explicit layouts= disagree with plan "
                        f"{plan.name!r} at leaf {i} "
                        f"({names[i] if i < len(names) else '?'}): "
                        f"plan derives {d!r}, caller passed {e!r}. "
                        "The plan is authoritative — drop the "
                        "layouts= override or fix the plan."
                    )
        return derived_tree

    def save(self, state: Any, epoch: int, extra: Optional[dict] = None,
             layouts=None, plan=None) -> str:
        """Snapshot ``state`` at ``epoch``; returns the snapshot's
        directory. ``layouts`` tags each leaf (None: replicated).
        ``plan`` (a :class:`~flinkml_tpu_torch.sharding.plan.
        ShardingPlan`) derives the tags instead (``sharded:<dim>`` per
        sharded family); an explicit ``layouts=`` beside it must agree,
        else :class:`LayoutConflictError` and nothing is written."""
        leaves, treedef = tree_flatten(state)
        if plan is not None:
            layouts = self._plan_layouts(plan, state, layouts, len(leaves))
        # An async snapshot owns its memory: the caller may update its
        # arrays in place while the write runs.
        host_leaves = [_host(leaf, self.async_write) for leaf in leaves]
        meta = {
            "epoch": int(epoch),
            "num_leaves": len(host_leaves),
            "treedef": treedef,
            "world_size": self._world_size(),
            "layouts": self._layout_list(layouts, state, len(host_leaves)),
            "extra": extra or {},
        }
        final_dir = os.path.join(self.directory, f"ckpt-{epoch}")
        if not self.async_write:
            self._write(host_leaves, meta, final_dir)
            return final_dir
        self.wait()
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-write"
            )
        self._pending = self._executor.submit(
            self._write, host_leaves, meta, final_dir
        )
        return final_dir

    def wait(self) -> None:
        """Block until the in-flight async write (if any) has committed;
        re-raises its exception."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        """Drain the in-flight write and release the writer thread
        (idempotent; a later save starts a new one)."""
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def _write(self, host_leaves, meta, final_dir) -> None:
        meta = dict(meta, fingerprint=_leaves_fingerprint(host_leaves))
        tmp_dir = tempfile.mkdtemp(dir=self.directory, prefix=".tmp-ckpt-")
        try:
            np.savez(
                os.path.join(tmp_dir, "arrays.npz"),
                **{f"leaf_{i}": leaf for i, leaf in enumerate(host_leaves)},
            )
            with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
                json.dump(meta, f)
            if faults.ACTIVE is not None:  # the torn-write seam: pre-commit
                faults.fire("checkpoint.write", epoch=meta["epoch"],
                            directory=self.directory, path=tmp_dir)
            if os.path.exists(final_dir):
                shutil.rmtree(final_dir)
            os.rename(tmp_dir, final_dir)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        _log.info("checkpoint committed: epoch %s -> %s (%d leaves)",
                  meta["epoch"], final_dir, meta["num_leaves"])
        if faults.ACTIVE is not None:  # the kill/corrupt-after-commit seam
            faults.fire("checkpoint.committed", epoch=meta["epoch"],
                        directory=self.directory, path=final_dir)
        self._prune()

    # -- restore -----------------------------------------------------------
    def all_epochs(self) -> List[int]:
        self.wait()
        return self._list_epochs()

    def _list_epochs(self) -> List[int]:
        """The directory listing without draining the writer (the writer
        thread itself calls it, from :meth:`_prune`)."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt-"):
                try:
                    out.append(int(name[len("ckpt-"):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def _read_meta(self, ckpt_dir: str) -> dict:
        try:
            with open(os.path.join(ckpt_dir, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointIntegrityError(
                f"checkpoint manifest at {ckpt_dir} is unreadable: {e!r}"
            ) from e
        if not isinstance(meta, dict) or "num_leaves" not in meta:
            raise CheckpointIntegrityError(
                f"checkpoint manifest at {ckpt_dir} is not a valid snapshot "
                "manifest"
            )
        return meta

    def _read_leaves(self, ckpt_dir: str, meta: dict) -> List[np.ndarray]:
        try:
            with np.load(os.path.join(ckpt_dir, "arrays.npz")) as z:
                host_leaves = [z[f"leaf_{i}"]
                               for i in range(meta["num_leaves"])]
        except Exception as e:  # noqa: BLE001 — any load failure is damage
            raise CheckpointIntegrityError(
                f"checkpoint arrays at {ckpt_dir} are unloadable "
                f"(torn write or disk corruption): {e!r}"
            ) from e
        recorded = meta.get("fingerprint")
        if recorded is not None:
            actual = _leaves_fingerprint(host_leaves)
            if actual != recorded:
                raise CheckpointIntegrityError(
                    f"checkpoint at {ckpt_dir} fails integrity verification "
                    f"(recorded fingerprint {recorded[:12]}..., actual "
                    f"{actual[:12]}...): the persisted arrays were modified "
                    "after commit"
                )
        return host_leaves

    def restore(self, epoch: int, like: Any) -> Tuple[Any, int]:
        """Restore the checkpoint at ``epoch`` into ``like``'s structure
        (leaves come back as host numpy arrays). Raises
        :class:`CheckpointIntegrityError` on damage and
        :class:`RescaleError` on a world-size mismatch under ``reject``."""
        self.wait()
        ckpt_dir = os.path.join(self.directory, f"ckpt-{epoch}")
        meta = self._read_meta(ckpt_dir)
        saved_world = meta.get("world_size")
        rescaling = (saved_world is not None
                     and saved_world != self._world_size())
        if rescaling and self.rescale_policy.on_mismatch == "reject":
            raise self._rescale_error(
                ckpt_dir, meta, "rejected (rescaling an in-flight "
                "iteration is refused by policy)")
        host_leaves = self._read_leaves(ckpt_dir, meta)
        if rescaling and self.rescale_policy.on_mismatch == "reshard":
            self._reshard_leaves(host_leaves, meta, ckpt_dir)
        n_like = len(tree_flatten(like)[0])
        if n_like != len(host_leaves):
            raise ValueError(
                f"checkpoint has {len(host_leaves)} leaves but the provided "
                f"structure has {n_like}"
            )
        state = tree_unflatten(like, host_leaves)
        self.last_restored_extra = meta.get("extra") or {}
        return state, int(meta["epoch"])

    def _rescale_error(self, ckpt_dir: str, meta: dict, outcome: str
                       ) -> RescaleError:
        """The rescale refusal: snapshot dir, epoch, both worlds and the
        policy's outcome (logged)."""
        msg = (
            f"cannot restore checkpoint {ckpt_dir} (epoch "
            f"{meta.get('epoch')}): snapshot was written at world_size="
            f"{meta.get('world_size')} but the restoring run has world_size="
            f"{self._world_size()}; RescalePolicy("
            f"{self.rescale_policy.on_mismatch!r}) outcome: {outcome}. "
            "Pass rescale='reshard' for layout-tagged elastic resume, or "
            "rescale='allow' only if every carry leaf is world-independent "
            "(reference parity: HeadOperator.java:130-146)."
        )
        _log.error("%s", msg)
        return RescaleError(msg)

    def _reshard_leaves(self, host_leaves: List[np.ndarray], meta: dict,
                        ckpt_dir: str) -> None:
        """The ``reshard`` policy on assembled leaves: a replicated leaf
        passes; a ``sharded:<axis>`` leaf keeps its global value and must
        divide across the new world; a ``per_rank`` leaf (rank-entangled
        state; a rank-scoped family reassembles through
        :func:`reshard_rank_state`) is refused."""
        new_world = self._world_size()
        layouts = meta.get("layouts") or [LAYOUT_REPLICATED] * len(host_leaves)
        counts = {"replicated": 0, "sharded": 0}
        for i, (leaf, tag) in enumerate(zip(host_leaves, layouts)):
            kind, axis = _parse_layout(tag)
            if kind == "per_rank":
                raise self._rescale_error(
                    ckpt_dir, meta,
                    f"leaf {i} is per_rank (rank-entangled state cannot "
                    "be re-laid-out; reassemble the rank-scoped family "
                    "with reshard_rank_state, or resume at the original "
                    "world)",
                )
            if kind == "sharded":
                arr = np.asarray(leaf)
                extent = arr.shape[axis] if axis < arr.ndim else -1
                if extent < 0 or extent % new_world != 0:
                    raise self._rescale_error(
                        ckpt_dir, meta,
                        f"leaf {i} is sharded:{axis} with extent {extent}, "
                        f"which does not divide across {new_world} ranks",
                    )
            counts[kind] += 1
        _log.info(
            "resharded restore: %s (epoch %s) world %s -> %s (%d replicated, "
            "%d sharded leaves)", ckpt_dir, meta.get("epoch"),
            meta.get("world_size"), new_world, counts["replicated"],
            counts["sharded"],
        )

    def verify(self, epoch: int) -> bool:
        """True when the snapshot at ``epoch`` has a readable manifest,
        loadable arrays and a matching fingerprint (no restore)."""
        self._drain_quietly()
        ckpt_dir = os.path.join(self.directory, f"ckpt-{epoch}")
        try:
            meta = self._read_meta(ckpt_dir)
            self._read_leaves(ckpt_dir, meta)
        except CheckpointIntegrityError:
            return False
        return True

    def newest_valid_epoch(self) -> Optional[int]:
        """The newest epoch that passes :meth:`verify` (None if none)."""
        self._drain_quietly()
        for epoch in reversed(self.all_epochs()):
            if self.verify(epoch):
                return epoch
        return None

    def read_extra(self, epoch: int) -> dict:
        """The ``extra`` manifest of the snapshot at ``epoch``, without
        its arrays."""
        self._drain_quietly()
        ckpt_dir = os.path.join(self.directory, f"ckpt-{int(epoch)}")
        return self._read_meta(ckpt_dir).get("extra") or {}

    def discard(self, epoch: int) -> None:
        """Remove the committed snapshot at ``epoch`` (idempotent)."""
        self.wait()
        path = os.path.join(self.directory, f"ckpt-{int(epoch)}")
        shutil.rmtree(path, ignore_errors=True)
        _log.warning("checkpoint discarded: epoch %s (%s)", epoch, path)

    def _drain_quietly(self) -> None:
        """Drain a pending write without re-raising its failure: the
        verification queries report what is on disk (a failed write
        belongs to ``save``)."""
        try:
            self.wait()
        except Exception as e:  # noqa: BLE001 — the write's failure, logged
            _log.warning("pending checkpoint write failed (%r); verifying "
                         "the committed snapshots anyway", e)

    def restore_latest(self, like: Any) -> Optional[Tuple[Any, int]]:
        """Restore the newest snapshot that passes verification, walking
        back past torn or corrupt ones. None when the directory holds no
        checkpoint; :class:`CheckpointIntegrityError` when some exist but
        none survives."""
        failures = []
        for epoch in reversed(self.all_epochs()):
            try:
                return self.restore(epoch, like)
            except CheckpointIntegrityError as e:
                failures.append((epoch, e))
                _log.warning("checkpoint epoch %s failed verification (%s); "
                             "falling back to the previous snapshot", epoch, e)
        if failures:
            raise CheckpointIntegrityError(
                f"no valid checkpoint under {self.directory}: all of epochs "
                f"{[e for e, _ in failures]} failed verification "
                f"(newest failure: {failures[0][1]})"
            )
        return None

    def _prune(self) -> None:
        for epoch in self._list_epochs()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"ckpt-{epoch}"),
                          ignore_errors=True)


def _rank_dirs(directory: str) -> List[Tuple[int, str]]:
    """The ``rank-<i>`` subdirectories of a rank-scoped family, by rank."""
    out = []
    for name in os.listdir(directory):
        if name.startswith("rank-"):
            try:
                out.append((int(name[len("rank-"):]),
                            os.path.join(directory, name)))
            except ValueError:
                continue
    return sorted(out)


def reshard_rank_state(directory: str, epoch: int, like: Any,
                       new_shard: Tuple[int, int], layouts=None) -> Any:
    """Reassemble a :func:`rank_scoped` snapshot family and split it for
    ``new_shard = (new_rank, new_world)``.

    Every ``rank-<i>`` subdirectory's snapshot at ``epoch`` is read (the
    old world is the number of rank directories, which must be
    contiguous), and each leaf is re-laid-out by its recorded layout tag
    (or by ``layouts``, the :meth:`CheckpointManager.save` convention):

    - ``replicated``: every rank must hold the same bits, which are the
      result;
    - ``sharded:<axis>``: the rank chunks concatenate in rank order and
      split into ``new_world`` equal chunks along ``axis``, of which
      ``new_rank``'s is returned (:class:`RescaleError` unless the
      extent divides);
    - ``per_rank``: rank-entangled, :class:`RescaleError`.

    Returns ``like``'s structure filled with the new rank's leaves."""
    new_rank, new_world = int(new_shard[0]), int(new_shard[1])
    if new_world < 1 or not (0 <= new_rank < new_world):
        raise ValueError(f"invalid new shard assignment {new_shard!r}")
    ranks = _rank_dirs(directory)
    if not ranks:
        raise ValueError(
            f"no rank-scoped snapshot family under {directory} "
            "(expected rank-<i> subdirectories)"
        )
    if [r for r, _ in ranks] != list(range(len(ranks))):
        raise RescaleError(
            f"rank-scoped family under {directory} is not contiguous "
            f"(found ranks {[r for r, _ in ranks]}); a missing rank's "
            "shard cannot be reassembled"
        )
    old_world = len(ranks)
    num_leaves = len(tree_flatten(like)[0])
    per_rank_leaves: List[List[np.ndarray]] = []
    metas = []
    for _, rank_dir in ranks:
        mgr = CheckpointManager(rank_dir, rescale="allow")
        ckpt_dir = os.path.join(rank_dir, f"ckpt-{epoch}")
        meta = mgr._read_meta(ckpt_dir)
        leaves = mgr._read_leaves(ckpt_dir, meta)
        if len(leaves) != num_leaves:
            raise ValueError(
                f"rank snapshot {ckpt_dir} has {len(leaves)} leaves but "
                f"the provided structure has {num_leaves}"
            )
        per_rank_leaves.append(leaves)
        metas.append(meta)
    if layouts is not None:
        tags = CheckpointManager._layout_list(layouts, like, num_leaves)
    else:
        tags = metas[0].get("layouts") or [LAYOUT_REPLICATED] * num_leaves
    out_leaves: List[np.ndarray] = []
    for i, tag in enumerate(tags):
        kind, axis = _parse_layout(tag)
        chunks = [np.asarray(leaves[i]) for leaves in per_rank_leaves]
        if kind == "per_rank":
            raise RescaleError(
                f"leaf {i} of the family under {directory} (epoch "
                f"{epoch}) is per_rank: rank-entangled state has no "
                f"global assembly — world {old_world} -> {new_world} "
                "resume must rebuild it from data"
            )
        if kind == "replicated":
            for r, chunk in enumerate(chunks[1:], start=1):
                if not np.array_equal(chunk, chunks[0]):
                    raise RescaleError(
                        f"replicated leaf {i} diverges between rank 0 "
                        f"and rank {r} under {directory} (epoch {epoch}):"
                        " the family is not a consistent snapshot"
                    )
            out_leaves.append(chunks[0])
            continue
        global_arr = np.concatenate(chunks, axis=axis)
        extent = global_arr.shape[axis]
        if extent % new_world != 0:
            raise RescaleError(
                f"sharded leaf {i} under {directory} (epoch {epoch}) has "
                f"global extent {extent} along axis {axis}, which does "
                f"not divide across {new_world} ranks"
            )
        out_leaves.append(np.split(global_arr, new_world, axis=axis)[new_rank])
    _log.info(
        "reshard_rank_state: %s epoch %s world %d -> %d (rank %d), "
        "%d leaves re-laid-out", directory, epoch, old_world, new_world,
        new_rank, len(out_leaves),
    )
    return tree_unflatten(like, out_leaves)
