"""Checkpointable input-pipeline cursors.

The port's counterpart of ``flinkml_tpu.data.state``, with the same JSON
layout, so a cursor written by either package restores in the other. The
position of a whole :class:`~flinkml_tpu_torch.data.Dataset` chain —
source shard/offset, shuffle RNG state, and the consumer's delivered-batch
watermark — folds into one :class:`Cursor` that rides a checkpoint two
ways:

- **inside ``iterate``** (the online trainers' path): the runtime stores
  the cursor in the snapshot's ``extra`` manifest field on every
  checkpoint and reopens the Dataset from it on resume, so a killed and
  resumed pipeline replays the exact uninterrupted batch sequence —
  shuffle order included (every stage of the chain is deterministic in
  its seed, so position + replay give identical batches);
- **standalone** (hand-rolled loops): :meth:`Cursor.to_state` returns a
  one-leaf tree (the JSON encoding as a uint8 array) that can ride any
  :class:`~flinkml_tpu_torch.iteration.CheckpointManager` snapshot next
  to the model state; :meth:`Cursor.from_state` decodes it back.

``emitted`` is the authoritative field — the number of output batches
the CONSUMER has received. ``source``/``shuffle``/``in_flight`` record
where the producer side stood at snapshot time (the prefetcher may have
read ahead; ``in_flight`` is that watermark) — they make a cursor
auditable and let a skip-transparent chain fast-forward at the source,
but restore correctness never depends on them: a resumed Dataset
re-derives everything from ``emitted`` plus its own seeds.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np


class CursorShardMismatchError(ValueError):
    """A cursor written by one shard assignment was restored into a feed
    with an INCOMPATIBLE one. A cursor from a 4-way-sharded source would
    otherwise silently fast-forward a 2-way source to the wrong rows —
    the shard count the cursor records is authoritative, so any mismatch
    that is not a legal, reshardable world change is loud. Legal
    reshards (round-robin-dealt sources with skip-transparent chains, or
    an :class:`~flinkml_tpu_torch.data.ElasticFeed`'s global-order cursor)
    re-derive the new shard positions instead of raising."""


@dataclasses.dataclass(frozen=True)
class Cursor:
    """Position of a :class:`~flinkml_tpu_torch.data.Dataset` iteration.

    Fields:
      emitted: output batches already delivered to the consumer — the
        replay watermark (a restored iteration produces batch
        ``emitted`` next). For a per-shard Dataset cursor this counts
        THIS shard's batches; for an
        :class:`~flinkml_tpu_torch.data.ElasticFeed` cursor it counts GLOBAL
        batches (``shard_index`` is None there).
      num_shards: the shard count of the feed that wrote the cursor —
        **authoritative**: restoring into a feed with a different count
        is either a validated reshard (the new positions are re-derived
        from the global watermark) or a
        :class:`CursorShardMismatchError`, never a silent misread.
      shard_index: the writing iterator's shard (None for a global-order
        ElasticFeed cursor — the discriminator between the two scopes).
      source: the source's own position record (shard index, row/batch
        offset, reads) at snapshot time; diagnostic + fast-skip aid.
      shuffle: the shuffle buffer's RNG bit-generator state at snapshot
        time (diagnostic — replay regenerates it from the seed).
      in_flight: source batches read past the delivered watermark
        (sitting in transform/prefetch stages when the snapshot cut).
    """

    emitted: int = 0
    source: Optional[Dict[str, Any]] = None
    shuffle: Optional[Dict[str, Any]] = None
    in_flight: int = 0
    num_shards: Optional[int] = None
    shard_index: Optional[int] = None
    #: The EXACT global watermark, recorded by iterators that know it
    #: (always, since the elastic reshard landed). The lockstep product
    #: below is only the fallback for cursors predating this field —
    #: after a reshard whose watermark does not divide the new world,
    #: per-shard skips are uneven and ``emitted * num_shards`` would
    #: overestimate the global position (skipping real batches on the
    #: NEXT reshard); the recorded value stays exact across any chain
    #: of reshards.
    global_watermark: Optional[int] = None

    @property
    def global_emitted(self) -> int:
        """The delivered watermark in GLOBAL batches: the recorded
        :attr:`global_watermark` when present; otherwise a global-order
        cursor (``shard_index`` None) already counts globally, and a
        per-shard cursor converts under the SPMD lockstep contract
        (every shard delivers one batch per step, so per-shard progress
        times the shard count approximates the global progress — exact
        only when the feed never resharded)."""
        if self.global_watermark is not None:
            return int(self.global_watermark)
        if self.shard_index is None or self.num_shards is None:
            return int(self.emitted)
        return int(self.emitted) * int(self.num_shards)

    # -- JSON (checkpoint ``extra`` transport) ------------------------------
    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "emitted": int(self.emitted),
            "source": self.source,
            "shuffle": self.shuffle,
            "in_flight": int(self.in_flight),
            "num_shards": (None if self.num_shards is None
                           else int(self.num_shards)),
            "shard_index": (None if self.shard_index is None
                            else int(self.shard_index)),
            "global_watermark": (None if self.global_watermark is None
                                 else int(self.global_watermark)),
        }

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "Cursor":
        num_shards = d.get("num_shards")
        shard_index = d.get("shard_index")
        watermark = d.get("global_watermark")
        return Cursor(
            emitted=int(d.get("emitted", 0)),
            source=d.get("source"),
            shuffle=d.get("shuffle"),
            in_flight=int(d.get("in_flight", 0)),
            num_shards=None if num_shards is None else int(num_shards),
            shard_index=None if shard_index is None else int(shard_index),
            global_watermark=None if watermark is None else int(watermark),
        )

    # -- tree leaf (standalone CheckpointManager transport) -----------------
    def to_state(self) -> Dict[str, np.ndarray]:
        """A one-leaf tree encoding for riding a CheckpointManager
        snapshot next to model state (``{"cursor": <uint8 array>}``)."""
        payload = json.dumps(self.to_json_dict(), sort_keys=True).encode()
        return {"cursor": np.frombuffer(payload, dtype=np.uint8).copy()}

    @staticmethod
    def from_state(state: Dict[str, np.ndarray]) -> "Cursor":
        payload = np.asarray(state["cursor"], dtype=np.uint8).tobytes()
        return Cursor.from_json_dict(json.loads(payload.decode()))


def rng_state_dict(rng: np.random.Generator) -> Dict[str, Any]:
    """A JSON-safe copy of a numpy Generator's bit-generator state."""

    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            return [int(v) for v in x.tolist()]
        if isinstance(x, (np.integer,)):
            return int(x)
        return x

    return clean(rng.bit_generator.state)
