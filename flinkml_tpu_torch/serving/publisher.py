"""Mid-stream model publication: training loops emit serving snapshots.

The reference's unbounded ``Iterations`` feeds per-round models to
downstream consumers; :class:`SnapshotPublisher` does it from the listener
side: attach it to any epoch loop that fires
:class:`~flinkml_tpu_torch.iteration.IterationListener` callbacks —
:func:`flinkml_tpu_torch.iteration.iterate` (bounded or unbounded) or the
hand-rolled stream trainers (``train_kmeans_stream(listeners=[...])``) —
and every N epochs the loop's state becomes a **versioned, fingerprinted
model in a registry**, without stopping the stream.

Consistency: the publisher declares ``needs_materialized_state``, so the
runtime blocks on the loop carry before the callback
(``iteration.runtime.notify_epoch_listeners``) — the snapshot is a fully
computed value, never an in-flight async future.

Zero-downtime path to production: point a
:class:`~flinkml_tpu_torch.serving.engine.ServingEngine` at the same registry
with ``follow_registry()`` (or pass ``engine=`` here) and every publish
hot-swaps the live engine; in-flight batches finish on the old version,
new requests route to the new one.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from flinkml_tpu_torch.iteration.runtime import IterationListener
from flinkml_tpu_torch.serving.registry import ModelRegistry
from flinkml_tpu_torch.utils.metrics import metrics


class SnapshotPublisher(IterationListener):
    """Publish ``make_model(state)`` into ``registry`` every N epochs.

    Args:
        registry: destination :class:`ModelRegistry`.
        make_model: maps the (materialized) loop state to a save-able
            stage — e.g. centroids → a fitted ``KMeansModel``, or a whole
            ``PipelineModel`` with the fresh model spliced in. Runs on
            the training thread; keep it cheap.
        every_n_epochs: publication cadence (epoch E publishes when
            ``(E + 1) % every_n_epochs == 0``).
        publish_on_terminate: also publish the final state at stream end
            unless the last epoch already published it.
        engine: optional :class:`~flinkml_tpu_torch.serving.engine.ServingEngine`
            to hot-swap after each publish. Redundant (and wasteful —
            double load + warmup) if that engine already
            ``follow_registry()``s this registry; use one or the other.

    ``published`` records ``(epoch, version)`` pairs, newest last.

    Publication is **idempotent across restarts**: each publish carries a
    dedupe key of ``epoch`` + the content fingerprint of the
    (materialized) loop state, recorded atomically with the version. A
    trainer that crashes after publishing epoch E and resumes from the
    epoch-E checkpoint will re-reach the same publish point with the
    same state — the registry returns the already-committed version
    instead of growing a duplicate (see ``ModelRegistry.publish``'s
    ``dedupe_key``).
    """

    needs_materialized_state = True

    def __init__(
        self,
        registry: ModelRegistry,
        make_model: Callable[[Any], Any],
        every_n_epochs: int = 1,
        publish_on_terminate: bool = True,
        engine: Optional[Any] = None,
    ):
        if every_n_epochs < 1:
            raise ValueError(
                f"every_n_epochs must be >= 1, got {every_n_epochs}"
            )
        self.registry = registry
        self.make_model = make_model
        self.every_n_epochs = int(every_n_epochs)
        self.publish_on_terminate = bool(publish_on_terminate)
        self.engine = engine
        self.published: List[Tuple[int, int]] = []
        self._last_published_epoch: Optional[int] = None
        self._epochs_seen = 0
        self._metrics = metrics.group("serving.publisher")

    def wants_epoch_state(self, epoch: int) -> bool:
        """Only publishing epochs need a materialized state — the runtime
        skips the device sync on the others."""
        return (epoch + 1) % self.every_n_epochs == 0

    def on_epoch_watermark_incremented(self, epoch: int, state: Any) -> None:
        self._epochs_seen = max(self._epochs_seen, epoch + 1)
        if (epoch + 1) % self.every_n_epochs:
            return
        self._publish(epoch, state)

    def on_iteration_terminated(self, state: Any) -> None:
        last_epoch = self._epochs_seen - 1
        if not self.publish_on_terminate:
            return
        if last_epoch >= 0 and self._last_published_epoch == last_epoch:
            return  # the final epoch's snapshot is already out
        self._publish(max(last_epoch, 0), state)

    def _publish(self, epoch: int, state: Any) -> None:
        key = self._dedupe_key(epoch, state)
        if key is not None:
            existing = self.registry.find_dedupe(key)
            if existing is not None:
                # Resume re-reached an already-published epoch: record it,
                # skip make_model + save — but an attached engine must
                # still land on this version (it may be serving whatever
                # predated the restart).
                self.published.append((epoch, existing))
                self._last_published_epoch = epoch
                self._metrics.counter("snapshots_deduped")
                if self.engine is not None:
                    self.engine.swap_to(existing)
                return
        model = self.make_model(state)
        version = self.registry.publish(model, dedupe_key=key)
        self.published.append((epoch, version))
        self._last_published_epoch = epoch
        self._metrics.counter("snapshots_published")
        self._metrics.gauge("last_published_version", version)
        if self.engine is not None:
            self.engine.swap_to(version)

    @staticmethod
    def _dedupe_key(epoch: int, state: Any) -> Optional[str]:
        """``epoch`` + content fingerprint of the loop state — identical
        on a resumed run that re-reaches the same publish point. None
        (publish unconditionally) for states that cannot be fingerprinted
        (non-array leaves)."""
        from flinkml_tpu_torch.io.read_write import content_fingerprint
        from flinkml_tpu_torch.iteration.checkpoint import tree_flatten
        from flinkml_tpu_torch.table import to_numpy

        try:
            leaves = [to_numpy(leaf) if torch.is_tensor(leaf) else leaf
                      for leaf in tree_flatten(state)[0]]
            fp = content_fingerprint(
                {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
            )
        except Exception:  # noqa: BLE001 — dedupe is best-effort
            return None
        return f"epoch={epoch}:fp={fp}"
