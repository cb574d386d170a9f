"""Composable input-pipeline transforms.

The port's counterpart of ``flinkml_tpu.data.ops``. Each op rewrites an
iterator of :class:`~flinkml_tpu_torch.table.Table` batches into another —
the tf.data-shaped middle of a :class:`~flinkml_tpu_torch.data.Dataset`
chain. Two properties carry the subsystem's contracts:

- **determinism**: an op's output sequence is a pure function of its
  input sequence (and, for shuffle, its seed: a numpy ``Generator``,
  PCG64, so the shuffled order is the JAX package's for the same seed).
  Replaying the chain replays the batches bit for bit, which is what
  makes the skip-``emitted`` resume of :mod:`flinkml_tpu_torch.data.state`
  exact.
- **skip transparency** (``skip_transparent``): ops that map input
  batches 1:1 to output batches (``map``) let a resume push its skip
  all the way down to the source (O(1) for array/synthetic sources);
  cardinality-changing ops (``filter``/``rebatch``/``window``/
  ``shuffle``) force the resume to replay the chain and drop the
  consumed prefix — still exact, just not free.

Ops are instantiated once per Dataset but applied per ITERATION: all
mutable state (rebatch remainders, window buffers, shuffle buffer +
RNG) lives inside the generator ``apply`` returns, so two concurrent
iterations of one Dataset never share state. ``HashOp`` (the seeded
feature hash) is refused: it needs ``features/hashing.py``, which comes
with ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import numpy as np

from flinkml_tpu_torch.table import Table


def _concat(tables: List[Table]) -> Table:
    out = tables[0]
    for t in tables[1:]:
        out = out.concat(t)
    return out


class Op:
    """One chain stage. ``apply`` receives the upstream iterator and the
    owning DatasetIterator (``ctx``) — ops with replay-relevant state
    (shuffle) register a state probe on it for cursor snapshots."""

    #: True when this op maps input batches 1:1 to output batches, so a
    #: resume's skip can be pushed below it to the source.
    skip_transparent = False

    def apply(self, it: Iterator[Table], ctx) -> Iterator[Table]:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class MapOp(Op):
    """``fn(Table) -> Table`` per batch (1:1, so skip-transparent).
    ``fn`` must be deterministic — it re-runs on replay."""

    skip_transparent = True

    def __init__(self, fn: Callable[[Table], Table]):
        self.fn = fn

    def apply(self, it, ctx):
        fn = self.fn
        for batch in it:
            yield fn(batch)

    def describe(self):
        return f"map({getattr(self.fn, '__name__', 'fn')})"


class FilterOp(Op):
    """Row-level filter: ``pred(Table) -> bool row mask``; rows where
    the mask is False are dropped, batches left empty vanish. Not
    skip-transparent (output batch count depends on the data)."""

    def __init__(self, pred: Callable[[Table], np.ndarray]):
        self.pred = pred

    def apply(self, it, ctx):
        for batch in it:
            mask = np.asarray(self.pred(batch), dtype=bool).reshape(-1)
            if mask.shape[0] != batch.num_rows:
                raise ValueError(
                    f"filter predicate returned {mask.shape[0]} mask rows "
                    f"for a {batch.num_rows}-row batch"
                )
            if mask.all():
                yield batch
                continue
            idx = np.flatnonzero(mask)
            if idx.size:
                yield batch.take(idx)

    def describe(self):
        return f"filter({getattr(self.pred, '__name__', 'pred')})"


class RebatchOp(Op):
    """Re-slice the row stream into exactly-``batch_size``-row batches
    (the final remainder is emitted unless ``drop_remainder``). The op
    every fixed-global-batch trainer wants between an arbitrary source
    and the device."""

    def __init__(self, batch_size: int, drop_remainder: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = int(batch_size)
        self.drop_remainder = bool(drop_remainder)

    def apply(self, it, ctx):
        pending: List[Table] = []
        rows = 0
        for batch in it:
            pending.append(batch)
            rows += batch.num_rows
            while rows >= self.batch_size:
                block = _concat(pending)
                yield block.slice(0, self.batch_size)
                rest = block.slice(self.batch_size, block.num_rows)
                rows -= self.batch_size
                pending = [rest] if rest.num_rows else []
        if rows and not self.drop_remainder:
            yield _concat(pending)

    def describe(self):
        return f"rebatch({self.batch_size})"


class WindowOp(Op):
    """Sliding count-window over rows: emit ``size``-row batches
    advancing by ``stride`` rows (``stride == size`` is a tumbling
    window — rebatch with a dropped remainder; ``stride < size``
    overlaps). Trailing rows that never fill a window are dropped."""

    def __init__(self, size: int, stride: Optional[int] = None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.size = int(size)
        self.stride = int(stride) if stride is not None else int(size)
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")

    def apply(self, it, ctx):
        buf: Optional[Table] = None
        for batch in it:
            buf = batch if buf is None else buf.concat(batch)
            while buf.num_rows >= self.size:
                yield buf.slice(0, self.size)
                buf = buf.slice(min(self.stride, buf.num_rows), buf.num_rows)
                if buf.num_rows == 0:
                    buf = None
                    break

    def describe(self):
        return f"window({self.size}, stride={self.stride})"


class ShuffleOp(Op):
    """Deterministic seeded shuffle buffer over BATCHES (the unit of
    streaming in this data plane): fill a buffer of ``buffer_batches``,
    then for every arriving batch emit a uniformly drawn resident one
    and take its slot; drain the buffer in random order at stream end.
    Identical (sequence, seed) ⇒ identical shuffled order — the
    determinism contract the kill-and-resume parity tests pin
    (``docs/operators/data.md``, "Shuffle determinism")."""

    def __init__(self, buffer_batches: int, seed: int = 0):
        if buffer_batches < 1:
            raise ValueError(
                f"buffer_batches must be >= 1, got {buffer_batches}"
            )
        self.buffer_batches = int(buffer_batches)
        self.seed = int(seed)

    def apply(self, it, ctx):
        rng = np.random.default_rng(self.seed)
        if ctx is not None:
            ctx.register_shuffle_probe(rng)
        buf: List[Table] = []
        for batch in it:
            if len(buf) < self.buffer_batches:
                buf.append(batch)
                continue
            j = int(rng.integers(0, len(buf)))
            out, buf[j] = buf[j], batch
            yield out
        while buf:
            j = int(rng.integers(0, len(buf)))
            yield buf.pop(j)

    def describe(self):
        return f"shuffle({self.buffer_batches}, seed={self.seed})"


class HashOp(Op):
    """The seeded feature hash per batch (refused): the JAX package's
    ``HashOp`` wraps a ``features.hashing.HashedFeature``, which comes
    with ROADMAP.md Queue 1 item 9 (embeddings and the recsys family)."""

    def __init__(self, hashed_feature=None):
        raise NotImplementedError(
            "HashOp (a seeded feature hash in the input pipeline) is not "
            "ported to flinkml_tpu_torch yet: it needs features/hashing.py, "
            "which comes with ROADMAP.md Queue 1 item 9"
        )
