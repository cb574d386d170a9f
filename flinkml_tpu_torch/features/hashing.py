"""Feature hashing: seeded, process-stable raw-key → embedding-row ids.

The port's own copy of ``flinkml_tpu.features.hashing`` (numpy only, so
it is copied whole; the bucket ids equal the JAX package's and the
committed golden vectors bit for bit). The front half of the streaming
feature platform: raw high-cardinality string/int keys map straight to
embedding-table rows through a murmur3-x86-32 hash — **no vocabulary build, no host-side id
assignment**, so an unbounded stream feeds
:class:`~flinkml_tpu_torch.embeddings.table.EmbeddingTable` training directly.

Three contracts carry the subsystem:

- **process stability** — the hash is murmur3 over explicit bytes with
  explicit ``uint32`` wrapping arithmetic. It never touches Python
  ``hash()`` (randomized per process via ``PYTHONHASHSEED``), native
  endianness, or platform word width, so the SAME (key, seed) maps to
  the SAME row in every process, on every platform, forever. A hashed
  model's rows stay addressable across trainer restarts, serving
  replicas, and checkpoint round-trips — the property the cross-process
  child test (``tests/_hash_child.py``) and the committed golden
  vectors pin.
- **measured collisions** — :class:`CollisionTracker` counts *observed*
  distinct-key collisions per bucket (capped memory) next to the
  analytic birthday-bound expectation, published as the
  ``features.hash`` metrics group, so the bucket-count/cardinality
  trade is a number on a dashboard, not a guess.
- **priced bucket/vocab coupling** — :func:`check_hash_vocab` is the
  live half of FML505: a hash front end whose ``num_buckets`` differs
  from the embedding table's vocab rows is refused pre-compile (silent
  modulo aliasing on the small side, permanently dead rows on the
  large side). The declarative half checks ``*.features.json`` fixtures
  through ``python -m flinkml_tpu.analysis`` (the JAX package's analysis
  CLI; the port has no fixture gate yet).

Key encoding (what the golden vectors fix): ``str`` hashes its UTF-8
bytes; ``bytes`` hashes as-is; ints hash their 8-byte little-endian
two's-complement encoding (so ``np.int32(7)`` and ``np.int64(7)`` and
Python ``7`` agree). Bucket id = ``murmur3_32(key, seed) % num_buckets``
computed in ``uint32`` — non-negative by construction.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.utils.metrics import metrics

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF


class HashVocabMismatchError(ValueError):
    """The live FML505 gate: a hash front end's ``num_buckets`` does not
    equal the embedding table's vocab rows. Refused BEFORE any program
    compiles — ``num_buckets < vocab`` leaves rows the stream can never
    train (dead HBM), ``num_buckets > vocab`` silently aliases distinct
    buckets onto shared rows at lookup time."""


def check_hash_vocab(num_buckets: int, vocab: int, *, where: str = "") -> None:
    """Raise :class:`HashVocabMismatchError` unless the hash space and
    the table's row space are the same size (rule FML505)."""
    if int(num_buckets) != int(vocab):
        raise HashVocabMismatchError(
            f"FML505: hash num_buckets={int(num_buckets)} != embedding "
            f"table vocab={int(vocab)}"
            + (f" ({where})" if where else "")
            + "; the hashed id space must BE the row space — size the "
            "table to num_buckets (or re-hash to the table's vocab)"
        )


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Reference murmur3-x86-32 over ``data`` — the scalar definition the
    vectorized int path and the golden vectors are pinned against. Pure
    Python with explicit ``uint32`` masking: bit-identical everywhere."""
    h = seed & _M32
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * _C1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * _C2) & _M32
        h ^= k
        h = ((h << 13) | (h >> 19)) & _M32
        h = (h * 5 + 0xE6546B64) & _M32
    tail = data[nblocks * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _M32
        k = ((k << 15) | (k >> 17)) & _M32
        k = (k * _C2) & _M32
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def _key_bytes(key: Any) -> bytes:
    """The canonical byte encoding of one raw key (see module docstring)."""
    if isinstance(key, bytes):
        return key
    if isinstance(key, str):
        return key.encode("utf-8")
    if isinstance(key, (int, np.integer)):
        return (int(key) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
    raise TypeError(
        f"hashable keys are str/bytes/int, got {type(key).__name__}"
    )


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _hash_ints_vectorized(keys: np.ndarray, seed: int) -> np.ndarray:
    """murmur3_32 of each key's 8-byte little-endian encoding, vectorized
    — bit-identical to the scalar reference (two 4-byte blocks, empty
    tail, length 8), at numpy throughput for the streaming hot path."""
    k64 = keys.astype(np.int64).view(np.uint64) if keys.dtype.kind == "i" \
        else keys.astype(np.uint64)
    with np.errstate(over="ignore"):
        h = np.full(k64.shape, np.uint32(seed & _M32), np.uint32)
        lo = (k64 & np.uint64(_M32)).astype(np.uint32)
        hi = (k64 >> np.uint64(32)).astype(np.uint32)
        for block in (lo, hi):
            k = block * np.uint32(_C1)
            k = _rotl32(k, 15)
            k = k * np.uint32(_C2)
            h = h ^ k
            h = _rotl32(h, 13)
            h = h * np.uint32(5) + np.uint32(0xE6546B64)
        h = h ^ np.uint32(8)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h


def hash_buckets(
    keys: Any,
    *,
    seed: int,
    num_buckets: int,
    pad_key: Optional[int] = None,
) -> np.ndarray:
    """Bucket ids in ``[0, num_buckets)`` for an array of raw keys.

    ``keys`` is any-shape array-like of int (vectorized path) or
    str/bytes (scalar murmur3 per element — identical definition).
    ``pad_key`` marks padding slots: keys equal to it (an int for int
    keys, e.g. ``""`` for string keys) pass through as ``-1``, the id
    the embedding lookup/pooling layers already treat as "ignore" — so
    ``[n, L]`` ragged-padded id rows hash without resurrecting their
    padding. Returns int32 of ``keys``' shape.
    """
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    arr = np.asarray(keys)
    n = np.uint32(num_buckets)
    if arr.dtype.kind in "iu":
        h = _hash_ints_vectorized(arr, seed)
        out = (h % n).astype(np.int32)
        if pad_key is not None:
            out = np.where(arr == pad_key, np.int32(-1), out)
        return out
    # str / bytes / object: scalar reference per element.
    flat = arr.reshape(-1)
    out = np.empty(flat.shape[0], np.int32)
    for i, key in enumerate(flat):
        if isinstance(key, np.str_):
            key = str(key)
        elif isinstance(key, np.bytes_):
            key = bytes(key)
        if pad_key is not None and key == pad_key:
            out[i] = np.int32(-1)
            continue
        out[i] = np.int32(np.uint32(murmur3_32(_key_bytes(key), seed)) % n)
    return out.reshape(arr.shape)


def expected_collision_fraction(num_keys: int, num_buckets: int) -> float:
    """The analytic birthday bound: the expected fraction of ``num_keys``
    distinct keys that land in an already-occupied bucket of
    ``num_buckets`` under a uniform hash —
    ``1 - n·(1 - (1 - 1/n)^k) / k``. The number the measured
    ``collision_rate`` gauge is judged against (a measured rate far
    above it means the key distribution is adversarial for this seed;
    far below means the tracker has seen too few keys to say)."""
    k, b = int(num_keys), int(num_buckets)
    if k <= 1:
        return 0.0
    expected_occupied = b * -np.expm1(k * np.log1p(-1.0 / b))
    return float(max(0.0, 1.0 - expected_occupied / k))


class CollisionTracker:
    """Measured collision accounting with capped memory.

    Tracks, per bucket, a fingerprint set of the distinct raw keys seen
    (a 64-bit secondary hash — two murmur3 runs under different seeds —
    so the tracker never stores raw keys). Once ``max_keys`` distinct
    keys are held the tracker stops admitting NEW keys (already-seen
    keys keep counting) and sets the ``saturated`` gauge — bounded
    memory under an unbounded stream, by design.

    Gauges in the ``features.hash`` group (``labels={"feature": name}``):
    ``keys_seen`` (distinct), ``buckets_used``, ``collisions`` (distinct
    keys beyond the first in their bucket), ``collision_rate``,
    ``expected_collision_rate`` (birthday bound at the same key count),
    ``saturated`` (0/1).
    """

    def __init__(self, name: str, num_buckets: int, seed: int,
                 max_keys: int = 100_000):
        self.num_buckets = int(num_buckets)
        self.seed = int(seed)
        self.max_keys = int(max_keys)
        self._buckets: Dict[int, set] = {}
        self._keys_seen = 0
        self._collisions = 0
        self._saturated = False
        self._metrics = metrics.group(
            "features.hash", labels={"feature": name}
        )

    def observe(self, raw_keys: np.ndarray, bucket_ids: np.ndarray) -> None:
        """Record one hashed batch (same shapes; ``-1`` padding slots in
        ``bucket_ids`` are skipped)."""
        flat_keys = np.asarray(raw_keys).reshape(-1)
        flat_ids = np.asarray(bucket_ids).reshape(-1)
        for key, bucket in zip(flat_keys, flat_ids):
            b = int(bucket)
            if b < 0:
                continue
            if isinstance(key, np.str_):
                key = str(key)
            elif isinstance(key, np.bytes_):
                key = bytes(key)
            data = _key_bytes(key)
            fp = (murmur3_32(data, 0x9747B28C) << 32) | murmur3_32(
                data, self.seed ^ 0x5BD1E995
            )
            seen = self._buckets.setdefault(b, set())
            if fp in seen:
                continue
            if self._keys_seen >= self.max_keys:
                self._saturated = True
                continue
            if seen:
                self._collisions += 1
            seen.add(fp)
            self._keys_seen += 1
        self.publish()

    @property
    def keys_seen(self) -> int:
        return self._keys_seen

    @property
    def collisions(self) -> int:
        return self._collisions

    @property
    def collision_rate(self) -> float:
        return self._collisions / self._keys_seen if self._keys_seen else 0.0

    def publish(self) -> None:
        g = self._metrics
        g.gauge("keys_seen", float(self._keys_seen))
        g.gauge("buckets_used", float(len(self._buckets)))
        g.gauge("collisions", float(self._collisions))
        g.gauge("collision_rate", self.collision_rate)
        g.gauge("expected_collision_rate", expected_collision_fraction(
            self._keys_seen, self.num_buckets))
        g.gauge("saturated", 1.0 if self._saturated else 0.0)


class HashedFeature:
    """The hash transform as a pipeline stage: ``transform(Table) ->
    (Table,)``, mapping ``input_col``'s raw keys (``[n]`` or ``[n, L]``
    str/int) to ``output_col`` int32 row ids — droppable in front of any
    id-consuming stage (:class:`~flinkml_tpu_torch.embeddings.serving.
    EmbeddingLookupModel`, the hashed-FM model) and wrappable as a
    Dataset op (``Dataset.hash_column``). Stateless and deterministic
    (a pure function of (key, seed)), so the data plane's replay/resume
    contract holds through it; the optional collision tracker is
    observability only and never influences output."""

    def __init__(
        self,
        seed: int,
        num_buckets: int,
        *,
        input_col: str = "keys",
        output_col: str = "hashed_ids",
        pad_key: Optional[int] = None,
        track_collisions: bool = False,
        name: str = "hashed",
        max_tracked_keys: int = 100_000,
    ):
        if num_buckets < 1:
            raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
        self.seed = int(seed)
        self.num_buckets = int(num_buckets)
        self.input_col = input_col
        self.output_col = output_col
        self.pad_key = pad_key
        self.name = name
        self.tracker: Optional[CollisionTracker] = (
            CollisionTracker(name, num_buckets, self.seed,
                             max_keys=max_tracked_keys)
            if track_collisions else None
        )

    def __call__(self, table) -> Any:
        """Map-function form (``Dataset.map`` / ``HashOp`` compatible)."""
        raw = np.asarray(table.column(self.input_col))
        ids = hash_buckets(
            raw, seed=self.seed, num_buckets=self.num_buckets,
            pad_key=self.pad_key,
        )
        if self.tracker is not None:
            self.tracker.observe(raw, ids)
        return table.with_column(self.output_col, ids)

    def transform(self, *inputs) -> Tuple[Any, ...]:
        (table,) = inputs
        return (self(table),)

    def describe(self) -> str:
        return (f"hash({self.input_col!r} -> {self.output_col!r}, "
                f"seed={self.seed}, buckets={self.num_buckets})")
