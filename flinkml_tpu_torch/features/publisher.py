"""DeltaPublisher — trainer state → registry, incrementally.

The port's counterpart of ``flinkml_tpu.features.publisher``. Publishes
the :class:`~flinkml_tpu_torch.features.trainer.
StreamingHashedFMTrainer`'s state on a batch cadence. The first publish
is a full snapshot (the chain's base). Every one after ships only what
moved: the rows the trainer touched since the last publish plus the
dense leaves, as a :class:`~flinkml_tpu_torch.features.delta.ModelDelta`
fingerprint-chained to the previous version. When the chain reaches
``max_depth`` the next publish **compacts**: a fresh full snapshot
resets the depth to zero, bounding both the registry ``get`` walk and
the blast radius of a pruned base.

Every publish — delta or full — is stamped with the trainer's
source-batch watermark (the registry's ``watermark=`` hook), which is
what the pool's ``serving.<pool>.freshness`` gauge subtracts from the
trainer's live watermark. No wall clocks.

Byte accounting rides the ``features.publisher`` metrics group
(``delta_bytes`` / ``full_bytes`` / ``delta_ratio``) so the bench's
delta-vs-snapshot ratio and a production dashboard read the same
numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from flinkml_tpu_torch.features.delta import ModelDelta
from flinkml_tpu_torch.features.model import HashedFMModel
from flinkml_tpu_torch.io.read_write import saved_class_name
from flinkml_tpu_torch.utils.logging import get_logger
from flinkml_tpu_torch.utils.metrics import metrics

_log = get_logger("features.publisher")


class DeltaPublisher:
    """See module docstring."""

    def __init__(
        self,
        registry,
        trainer,
        *,
        every_n_batches: int = 1,
        max_depth: int = 8,
        check_finite: bool = True,
        name: str = "features",
    ):
        if every_n_batches < 1:
            raise ValueError(
                f"need every_n_batches >= 1, got {every_n_batches}")
        if max_depth < 1:
            raise ValueError(f"need max_depth >= 1, got {max_depth}")
        self.registry = registry
        self.trainer = trainer
        self.every_n_batches = int(every_n_batches)
        self.max_depth = int(max_depth)
        self.check_finite = bool(check_finite)
        self._last_version: Optional[int] = None
        self._last_fingerprint: Optional[str] = None
        self._last_watermark = -1
        self._depth = 0
        self._metrics = metrics.group("features.publisher",
                                      labels={"publisher": name})

    @property
    def last_version(self) -> Optional[int]:
        return self._last_version

    @property
    def chain_depth(self) -> int:
        """Deltas since the newest full snapshot in this chain."""
        return self._depth

    def maybe_publish(self) -> Optional[int]:
        """Publish if ``every_n_batches`` trainer batches accumulated
        since the last publish; returns the new version or None."""
        if (self.trainer.watermark - self._last_watermark
                < self.every_n_batches):
            return None
        return self.publish_now()

    def publish_now(self) -> int:
        """Publish unconditionally: a full snapshot when there is no base
        yet or the chain hit ``max_depth`` (compaction), a row delta
        otherwise. Returns the registry version."""
        if self._last_version is None:
            return self._publish_full(reason="base")
        if self._depth >= self.max_depth:
            self._metrics.counter("compactions")
            _log.info("chain depth %d hit max_depth=%d: compacting to a "
                      "full snapshot", self._depth, self.max_depth)
            return self._publish_full(reason="compaction")
        return self._publish_delta()

    # -- internals ---------------------------------------------------------
    def _state_bytes(self) -> int:
        return int(sum(np.asarray(a).nbytes
                       for a in self.trainer.delta_state().values()))

    def _publish_full(self, reason: str) -> int:
        model = self.trainer.make_model()
        watermark = self.trainer.watermark
        v = self.registry.publish(model, watermark=watermark,
                                  check_finite=self.check_finite)
        self.trainer.drain_touched()  # the snapshot carries everything
        self._last_version = v
        self._last_fingerprint = self.trainer.state_fingerprint()
        self._last_watermark = watermark
        self._depth = 0
        full_bytes = self._state_bytes()
        self._metrics.counter("full_publishes")
        self._metrics.gauge("full_bytes", full_bytes)
        self._metrics.gauge("chain_depth", 0)
        _log.info("full publish (%s): version %d, watermark %d, %d bytes",
                  reason, v, watermark, full_bytes)
        return v

    def _publish_delta(self) -> int:
        ids = self.trainer.drain_touched()
        rows = self.trainer.rows_for(ids)
        watermark = self.trainer.watermark
        result_fp = self.trainer.state_fingerprint()
        delta = ModelDelta.build(
            base_version=self._last_version,
            base_fingerprint=self._last_fingerprint,
            result_fingerprint=result_fp,
            watermark=watermark,
            depth=self._depth + 1,
            row_deltas={name: (ids, values)
                        for name, values in rows.items()},
            dense_deltas={"w0": np.asarray(self.trainer.w0)},
            model_class=saved_class_name(HashedFMModel),
        )
        v = self.registry.publish(delta, watermark=watermark,
                                  check_finite=self.check_finite)
        self._last_version = v
        self._last_fingerprint = result_fp
        self._last_watermark = watermark
        self._depth += 1
        delta_bytes = delta.payload_bytes()
        full_bytes = self._state_bytes()
        self._metrics.counter("delta_publishes")
        self._metrics.gauge("delta_bytes", delta_bytes)
        self._metrics.gauge("full_bytes", full_bytes)
        self._metrics.gauge("delta_ratio",
                            delta_bytes / full_bytes if full_bytes else 0.0)
        self._metrics.gauge("chain_depth", self._depth)
        _log.info(
            "delta publish: version %d on base %d (depth %d), watermark "
            "%d, %d rows, %d bytes (%.1f%% of full)",
            v, delta.base_version, self._depth, watermark, ids.shape[0],
            delta_bytes, 100.0 * delta_bytes / max(full_bytes, 1),
        )
        return v
