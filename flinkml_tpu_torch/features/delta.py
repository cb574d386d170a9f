"""ModelDelta — the registry's incremental publish format.

The port's counterpart of ``flinkml_tpu.features.delta``, with the same
on-disk layout (a delta saved by either package loads in the other). A
delta is itself a save/load-able stage (metadata + fingerprinted
arrays, the standard persistence layout), so it publishes through the
same atomic claim-rename-flip path as a full model and lists as a normal
registry version. What makes it a *delta* is its payload and its chain
metadata:

- **payload** — changed embedding rows per row table (``ids [m]`` +
  ``values [m, dim]``, SET semantics: the rows' new contents, not
  increments — applying a delta twice is idempotent, and applying it to
  the right base is bitwise-equal to the full snapshot it stands for)
  plus changed dense leaves (small arrays shipped whole).
- **chain metadata** — ``base_version`` (the registry version this delta
  applies on top of), ``base_fingerprint`` /``result_fingerprint``
  (``content_fingerprint`` of the base's / result's ``delta_state()``
  arrays — the chain is *fingerprint-linked*, so a pruned, corrupted, or
  swapped base is a typed :class:`~flinkml_tpu_torch.serving.
  errors.DeltaChainError` naming the broken link, never a silently wrong
  model), ``watermark`` (the source-batch watermark of the trainer state
  this delta publishes — the pool's freshness gauge counts in these),
  and ``depth`` (chain length from the nearest full snapshot; the
  publisher compacts to a full snapshot when it hits the cap).

Resolution lives in :meth:`ModelRegistry.get`: load target, walk
``base_version`` links down to a full snapshot, apply upward verifying
every fingerprint. The serving engine's fast path
(:meth:`ServingEngine._try_delta_swap`) skips the walk when the chain
suffix starts at its ACTIVE version: clone-and-patch in place, no full
load, no warmup.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from flinkml_tpu_torch.api import Model
from flinkml_tpu_torch.params import IntParam, StringParam
from flinkml_tpu_torch.table import Table

_ROW_IDS = "rows.{}.ids"
_ROW_VALUES = "rows.{}.values"
_DENSE = "dense.{}"


class ModelDelta(Model):
    """See module docstring. Build with :meth:`build`; the no-arg
    constructor exists for the reflective loader."""

    #: Registry/engine dispatch marker (duck-typed so the registry never
    #: imports this module unless deltas are actually in play).
    is_model_delta = True

    BASE_VERSION = IntParam(
        "baseVersion", "Registry version this delta applies on top of.", 0
    )
    BASE_FINGERPRINT = StringParam(
        "baseFingerprint", "content_fingerprint of the base delta_state().",
        ""
    )
    RESULT_FINGERPRINT = StringParam(
        "resultFingerprint",
        "content_fingerprint of delta_state() after applying this delta.", ""
    )
    WATERMARK = IntParam(
        "watermark", "Source-batch watermark of the published state.", 0
    )
    DEPTH = IntParam(
        "depth", "Chain length from the nearest full snapshot (1 = "
        "directly on a snapshot).", 1
    )
    MODEL_CLASS = StringParam(
        "modelClass", "Dotted class name of the model this delta patches "
        "(operator forensics; resolution is structural).", ""
    )

    def __init__(self):
        super().__init__()
        self._payload: Dict[str, np.ndarray] = {}

    @classmethod
    def build(
        cls,
        *,
        base_version: int,
        base_fingerprint: str,
        result_fingerprint: str,
        watermark: int,
        depth: int,
        row_deltas: Mapping[str, Tuple[np.ndarray, np.ndarray]],
        dense_deltas: Mapping[str, np.ndarray] = (),
        model_class: str = "",
    ) -> "ModelDelta":
        delta = cls()
        delta.set(cls.BASE_VERSION, int(base_version))
        delta.set(cls.BASE_FINGERPRINT, str(base_fingerprint))
        delta.set(cls.RESULT_FINGERPRINT, str(result_fingerprint))
        delta.set(cls.WATERMARK, int(watermark))
        delta.set(cls.DEPTH, int(depth))
        delta.set(cls.MODEL_CLASS, model_class)
        for name, (ids, values) in dict(row_deltas).items():
            ids = np.asarray(ids, np.int32).reshape(-1)
            values = np.asarray(values)
            if values.shape[0] != ids.shape[0]:
                raise ValueError(
                    f"row table {name!r}: {ids.shape[0]} ids != "
                    f"{values.shape[0]} value rows"
                )
            if ids.shape[0] != np.unique(ids).shape[0]:
                raise ValueError(
                    f"row table {name!r}: delta ids must be unique (set "
                    "semantics — duplicate ids would make the patch "
                    "order-dependent)"
                )
            delta._payload[_ROW_IDS.format(name)] = ids
            delta._payload[_ROW_VALUES.format(name)] = values
        for name, value in dict(dense_deltas).items():
            delta._payload[_DENSE.format(name)] = np.asarray(value)
        return delta

    # -- typed accessors ---------------------------------------------------
    @property
    def base_version(self) -> int:
        return int(self.get(self.BASE_VERSION))

    @property
    def base_fingerprint(self) -> str:
        return self.get(self.BASE_FINGERPRINT)

    @property
    def result_fingerprint(self) -> str:
        return self.get(self.RESULT_FINGERPRINT)

    @property
    def watermark(self) -> int:
        return int(self.get(self.WATERMARK))

    @property
    def depth(self) -> int:
        return int(self.get(self.DEPTH))

    def row_deltas(self) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for key in self._payload:
            if key.startswith("rows.") and key.endswith(".ids"):
                name = key[len("rows."):-len(".ids")]
                out[name] = (self._payload[key],
                             self._payload[_ROW_VALUES.format(name)])
        return out

    def dense_deltas(self) -> Dict[str, np.ndarray]:
        return {
            key[len("dense."):]: value
            for key, value in self._payload.items()
            if key.startswith("dense.")
        }

    def payload_bytes(self) -> int:
        """Published payload size (the number the bench's delta-vs-full
        byte ratio is computed from)."""
        return int(sum(a.nbytes for a in self._payload.values()))

    def get_model_data(self):
        """Payload as Tables so the registry's finite publish gate scans
        delta values exactly like full-model arrays (a NaN'd row patch
        must never become a version a follower could swap in)."""
        tables = []
        for name in sorted(self.row_deltas()):
            ids, values = self.row_deltas()[name]
            tables.append(Table({"ids": ids, "values": values}))
        for name in sorted(self.dense_deltas()):
            tables.append(Table(
                {name: np.asarray(self.dense_deltas()[name]).reshape(-1)}))
        return tables

    # -- stage protocol ----------------------------------------------------
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        raise TypeError(
            "a ModelDelta is not servable on its own — resolve it through "
            "ModelRegistry.get(), which applies the chain onto its base "
            "snapshot"
        )

    def _arrays(self) -> Dict[str, np.ndarray]:
        return dict(self._payload)

    def _set_arrays(self, arrays) -> None:
        self._payload = {k: np.asarray(v) for k, v in arrays.items()}
