"""The constructor knobs of every streamed-capable estimator: the cache
and checkpoint settings, in one place.

The port's counterpart of ``flinkml_tpu.models._streaming``. Estimators
inherit the mixin first (``class LinearSVC(StreamingEstimatorMixin,
_LinearSVCParams, Estimator)``). ``mesh`` (a
:class:`~flinkml_tpu_torch.parallel.DeviceMesh`) runs the in-RAM fits
data parallel on its ranks, and a streamed fit as the multi-process
stream (each rank passes its own partition). ``sharding_plan`` and ``precision`` are
taken by the plan- and policy-aware estimators (the linear family's dense
paths) and refused at construction by every other, with the JAX
package's ``ValueError``.
"""

from __future__ import annotations

import itertools
from typing import Any, Optional, Tuple


def peek_stream(batches) -> Tuple[Optional[Any], Any]:
    """The first batch of a training stream and the stream to hand to
    ``iterate``. A :class:`~flinkml_tpu_torch.data.Dataset` or
    :class:`~flinkml_tpu_torch.data.ElasticFeed` is peeked by a throwaway
    prefetch-free iteration and handed over whole, so the runtime owns its
    cursor (checkpointed in every snapshot, reopened on resume); a list is
    peeked in place and handed over whole (so a resumed ``"replay"`` run
    re-reads it from the start); any other iterable is peeked and
    re-chained. ``(None, empty iterator)`` for an empty stream."""
    from flinkml_tpu_torch.data import Dataset, ElasticFeed

    if isinstance(batches, (Dataset, ElasticFeed)):
        return batches.peek(), batches
    if isinstance(batches, list):
        if not batches:
            return None, iter(())
        return batches[0], batches
    it = iter(batches)
    try:
        first = next(it)
    except StopIteration:
        return None, iter(())
    return first, itertools.chain([first], it)


def feed_world_size(batches) -> int:
    """The world size a checkpoint records for a training feed: a
    Dataset's shard count or an ElasticFeed's ``world`` (both expose
    ``num_shards``), else 1. A snapshot written at one world restores at
    another under the manager's ``rescale="allow"``."""
    world = getattr(batches, "num_shards", None)
    try:
        return max(1, int(world)) if world is not None else 1
    except (TypeError, ValueError):
        return 1


class StreamingEstimatorMixin:
    """The mesh, cache and checkpoint knobs shared by every
    streamed-capable estimator: ``mesh`` (the fits' data-parallel mesh;
    a streamed fit's ranks each feed their own partition), ``cache_dir`` and ``cache_memory_budget_bytes`` (where a
    streamed fit spills its epoch-0 cache), ``checkpoint_manager``,
    ``checkpoint_interval``, ``resume``, ``sharding_plan`` and
    ``precision``."""

    #: Subclasses whose trainers thread a ShardingPlan set this True;
    #: every other refuses the knob at construction.
    _SHARDING_PLAN_AWARE = False

    #: Subclasses whose trainers thread a PrecisionPolicy set this True;
    #: every other refuses the knob at construction.
    _PRECISION_AWARE = False

    def __init__(
        self,
        mesh=None,
        cache_dir: Optional[str] = None,
        cache_memory_budget_bytes: Optional[int] = None,
        checkpoint_manager=None,
        checkpoint_interval: int = 0,
        resume: bool = False,
        sharding_plan=None,
        precision=None,
    ):
        from flinkml_tpu_torch.parallel.mesh import check_mesh
        from flinkml_tpu_torch.precision import resolve_policy

        check_mesh(mesh)
        super().__init__()
        self.mesh = mesh
        self.cache_dir = cache_dir
        self.cache_memory_budget_bytes = cache_memory_budget_bytes
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_interval = checkpoint_interval
        self.resume = resume
        if sharding_plan is not None and not type(self)._SHARDING_PLAN_AWARE:
            # A plan ignored in silence would train replicated: the memory
            # the plan was set to save.
            raise ValueError(
                f"{type(self).__name__} does not support sharding_plan "
                "yet (plan-aware estimators: the linear family's dense "
                "paths — LogisticRegression, LinearSVC, LinearRegression)"
            )
        if precision is not None and not type(self)._PRECISION_AWARE:
            raise ValueError(
                f"{type(self).__name__} does not support precision yet "
                "(policy-aware estimators: the linear family's dense "
                "paths — LogisticRegression, LinearSVC, LinearRegression)"
            )
        #: The resolved :class:`~flinkml_tpu_torch.precision.
        #: PrecisionPolicy` (a bad preset name fails here), or None.
        self.precision = resolve_policy(precision)
        #: The :class:`~flinkml_tpu_torch.sharding.plan.ShardingPlan`, or
        #: None.
        self.sharding_plan = sharding_plan

    def _checkpoint_kwargs(self) -> dict:
        return dict(
            checkpoint_manager=self.checkpoint_manager,
            checkpoint_interval=self.checkpoint_interval,
            resume=self.resume,
        )

    def _reject_in_ram_checkpointing(self, detail: str = "") -> None:
        """An in-RAM fit that cannot checkpoint raises instead of dropping
        the knobs (``ValueError``, the JAX package's message)."""
        if self.checkpoint_manager is not None or self.resume:
            raise ValueError(
                "checkpointing is supported for streamed fits only "
                "(pass an iterable of batch Tables or a DataCache)"
                + (f"; {detail}" if detail else "")
            )
