"""flinkml_tpu_torch.embeddings — sharded embedding tables.

The port's counterpart of ``flinkml_tpu.embeddings``: a ``[vocab, dim]``
table whose rows shard over the plan's row axes, on ``torch.distributed``
(one process per rank):

- :class:`~flinkml_tpu_torch.embeddings.table.EmbeddingTable` — rows
  sharded over the plan's ``(fsdp, tp)`` axes via the ``EMBEDDING``
  :class:`~flinkml_tpu_torch.sharding.plan.ShardingPlan` family; optimizer
  slots shard identically; checkpoints ride plan-derived ``sharded:0``
  layout tags so a snapshot of one world size resumes at another.
- :mod:`~flinkml_tpu_torch.embeddings.exchange` — the sparse lookup
  (masked gather on the owning shard, one ``all_reduce``) and gradient
  exchange (batch-sized row payloads over a ``batch_isend_irecv`` ring,
  or ``all_gather``\\ s and the ``segment_sum`` kernel) — never a
  vocab-sized dense all-reduce, never a host gather. The strategy comes
  from ``FLINKML_TPU_EMBEDDING_EXCHANGE``, else the static ``ring``.
- :mod:`~flinkml_tpu_torch.embeddings.serving` — a mesh-bindable lookup
  model the serving engine binds at install, with bfloat16 pooling under
  ``PrecisionPolicy("mixed_inference")``.

ALS exports its factors as tables (``ALSModel.factor_tables``); the
streaming hashed-FM trainer (:mod:`flinkml_tpu_torch.features`) keeps its
state in them.
"""

from flinkml_tpu_torch.embeddings.exchange import (  # noqa: F401
    ENV_DENSE_VOCAB_VAR,
    ENV_VAR,
    STRATEGIES,
    dense_vocab_threshold,
    exchange_strategy,
    resolve_exchange,
    shard_rows_for,
)
from flinkml_tpu_torch.embeddings.table import EmbeddingTable  # noqa: F401

__all__ = [
    "ENV_DENSE_VOCAB_VAR",
    "ENV_VAR",
    "STRATEGIES",
    "EmbeddingTable",
    "dense_vocab_threshold",
    "exchange_strategy",
    "resolve_exchange",
    "shard_rows_for",
]
