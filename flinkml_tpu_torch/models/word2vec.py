"""Word2Vec — skip-gram with negative sampling (the Spark/Flink family
member).

The port's counterpart of ``flinkml_tpu.models.word2vec``.

Host prep, as in the JAX package (strings never reach the device):
frequency vocabulary with ``minCount`` pruning, (center, context) pairs
over ``windowSize`` with word2vec's window jitter, and a unigram^0.75
negative pool of :data:`_NEG_POOL` ids, all from
``np.random.default_rng(seed)``, so the vocabulary, pairs, pool and initial
vectors are JAX's bit for bit.

Device training, one SGNS minibatch step at a time:

  - the draws are JAX's: ``fold_in(key, step)``, ``split``, then
    ``randint`` for the pair rows and for the pool slots of the negatives
    (:mod:`flinkml_tpu_torch.ops.threefry`), a block of
    :data:`DRAW_BLOCK` steps per vectorised call;
  - gather the rows, compute the SGNS gradients (:func:`_sgns_pair_grads`,
    shared with the sharded trainer), and accumulate them into
    ``[vocab, dim]`` by ``accum`` (by default the tuning table's
    ``w2v_accum``, else ``"scatter"``): ``"scatter"`` is three
    row-payload ``segment_sum`` kernel launches — centers ``[bs, dim]``
    into ``v``, contexts ``[bs, dim]`` and negatives ``[bs·n_neg, dim]``
    into ``u``, the two ``u`` sums added afterwards (the JAX kernel
    branch's order); ``"onehot"`` is ``one_hot(ids)ᵀ @ rows``, a matrix
    product over a ``[cells, vocab]`` operand, for CPU tables only (the
    CUDA trainer refuses it: at a real vocabulary the operand takes
    gigabytes).
    The JAX package reads ``FLINKML_TPU_W2V_ACCUM``, then its tuning
    table; the port takes the keyword ``Word2Vec(accum=...)``, then the
    table, as ALS takes ``layout=``. On the card the kernel's atomics add in an order that
    changes from run to run, and under
    ``torch.use_deterministic_algorithms(True)`` it refuses (no quiet
    switch to ``index_add_``);
  - on a mesh of several ranks one ``all_reduce`` a step sums ``[dv | du |
    weight]``, and the step is ``lr`` over the GLOBAL selected weight.

Above the dense threshold (:func:`~flinkml_tpu_torch.embeddings.
dense_vocab_threshold`) on a mesh of several ranks, the in-RAM fit and the
one-process streamed fit switch to :func:`_sgns_trainer_sharded`: both
tables row-sharded over the data axis, each step one exchange gather and
one exchange scatter of batch-sized rows (:mod:`flinkml_tpu_torch.
embeddings.exchange`, ``ring`` or ``all_to_all``; the latter's scatter is
``segment_sum``).

The fitted model maps token-list documents to the mean of their word
vectors (host float64, as in the JAX package) and offers
:meth:`Word2VecModel.find_synonyms` by cosine similarity: one matrix
product and the port's ``topk`` kernel (``lax.top_k``'s tie order).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasInputCol,
    HasLearningRate,
    HasMaxIter,
    HasOutputCol,
    HasSeed,
)
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.models.text import _token_column
from flinkml_tpu_torch.ops import threefry
from flinkml_tpu_torch.params import IntParam, ParamValidators
from flinkml_tpu_torch.table import Table

_NEG_POOL = 1 << 18   # negative-sampling pool entries

#: The embedding-gradient accumulations (the ``accum`` keyword).
ACCUMS = ("scatter", "onehot")

#: Steps whose draws come from one vectorised call.
DRAW_BLOCK = 32


class _Word2VecParams(HasInputCol, HasOutputCol, HasMaxIter,
                      HasLearningRate, HasSeed):
    VECTOR_SIZE = IntParam(
        "vectorSize", "Embedding dimensionality.", 100, ParamValidators.gt(0)
    )
    WINDOW_SIZE = IntParam(
        "windowSize", "Max distance between center and context.", 5,
        ParamValidators.gt(0),
    )
    MIN_COUNT = IntParam(
        "minCount", "Tokens rarer than this are dropped.", 5,
        ParamValidators.gt(0),
    )
    NUM_NEGATIVES = IntParam(
        "numNegatives", "Negative samples per (center, context) pair.", 5,
        ParamValidators.gt(0),
    )
    BATCH_SIZE = IntParam(
        "batchSize", "Global pairs per SGNS step.", 1024,
        ParamValidators.gt(0),
    )


def check_accum(accum: str) -> None:
    if accum not in ACCUMS:
        raise ValueError(f"accum={accum!r}: expected one of {ACCUMS}")


def resolve_accum(accum: Optional[str] = None) -> str:
    """The dense trainer's accumulation: ``accum`` when given, else the
    tuning table's ``w2v_accum`` for this thread's device
    (:mod:`flinkml_tpu_torch.autotune`), else ``scatter``: the JAX
    package's precedence, the keyword standing for its
    ``FLINKML_TPU_W2V_ACCUM``."""
    if accum is None:
        from flinkml_tpu_torch.autotune import tuned_default

        accum = tuned_default("w2v_accum", "scatter", allowed=ACCUMS)
    check_accum(accum)
    return accum


def _build_pairs(docs, vocab_index: Dict[str, int], window: int,
                 rng: np.random.Generator):
    centers, contexts = [], []
    for toks in docs:
        ids = [vocab_index[t] for t in map(str, toks) if t in vocab_index]
        for i, c in enumerate(ids):
            w = int(rng.integers(1, window + 1))   # word2vec's window jitter
            for j in range(max(0, i - w), min(len(ids), i + w + 1)):
                if j != i:
                    centers.append(c)
                    contexts.append(ids[j])
    return (np.asarray(centers, np.int32), np.asarray(contexts, np.int32))


def _agree_token_counts(tokens, counts, mesh) -> Dict[str, int]:
    """Union the per-rank (token, count) maps: each token rides as UTF-8
    bytes (values 0-255, exact in float64) with its count through
    :func:`~flinkml_tpu_torch.iteration.stream_sync.gather_vectors`,
    padded to the agreed (max tokens, max byte length); every rank decodes
    the gathered rows in rank order and sums counts per token, so the
    merged map is identical everywhere. An empty local vocabulary is
    legal."""
    from flinkml_tpu_torch.iteration.stream_sync import (
        agree_max,
        gather_vectors,
    )

    enc = [str(t).encode("utf-8") for t in tokens]
    t_max = agree_max(len(enc), mesh)
    if t_max == 0:
        return {}
    l_max = agree_max(max((len(b) for b in enc), default=0), mesh)
    stride = 2 + l_max
    vec = np.zeros(1 + t_max * stride)
    vec[0] = len(enc)
    for j, b in enumerate(enc):
        off = 1 + j * stride
        vec[off] = len(b)
        vec[off + 1] = counts[j]
        vec[off + 2: off + 2 + len(b)] = np.frombuffer(b, np.uint8)
    rows = gather_vectors(vec, mesh)
    merged: Dict[str, int] = {}
    for row in rows:  # rank order: identical merge on every rank
        for j in range(int(round(row[0]))):
            off = 1 + j * stride
            blen = int(round(row[off]))
            tok = (np.asarray(row[off + 2: off + 2 + blen])
                   .astype(np.uint8).tobytes().decode("utf-8"))
            merged[tok] = merged.get(tok, 0) + int(round(row[off + 1]))
    return merged


def _sgns_pair_grads(vc, uc, un, wb):
    """SGNS pair gradients from the gathered embedding rows — the one
    definition of the loss math, shared by the dense and vocab-sharded
    trainers. Returns ``(grad_vc, grad_uc, grad_un)``."""
    pos_score = torch.sum(vc * uc, dim=1)
    neg_score = torch.einsum("bd,bnd->bn", vc, un)
    g_pos = (torch.sigmoid(pos_score) - 1.0) * wb        # [bs]
    g_neg = torch.sigmoid(neg_score) * wb[:, None]       # [bs, neg]
    grad_vc = g_pos[:, None] * uc + torch.einsum("bn,bnd->bd", g_neg, un)
    grad_uc = g_pos[:, None] * vc
    grad_un = g_neg[..., None] * vc[:, None, :]
    return grad_vc, grad_uc, grad_un


class PairDraws:
    """One key's per-step draws ``(pair rows [bs], pool slots [bs,
    n_neg])``: ``k = fold_in(key, step)``, ``k1, k2 = split(k)``, then
    ``randint(k1, (bs,), 0, n_local)`` and ``randint(k2, (bs, n_neg), 0,
    pool)``, drawn :data:`DRAW_BLOCK` steps at a time."""

    def __init__(self, key: torch.Tensor, local_bs: int, n_neg: int,
                 n_local: int, pool_size: int):
        self.key, self.local_bs, self.n_neg = key, local_bs, n_neg
        self.n_local, self.pool_size = n_local, pool_size
        self._start, self._rows, self._slots = 0, None, None

    def __call__(self, step: int):
        if self._rows is None or not (
                self._start <= step < self._start + self._rows.shape[0]):
            steps = torch.arange(step, step + DRAW_BLOCK, dtype=torch.int64,
                                 device=self.key.device)
            halves = threefry.split(threefry.fold_in(self.key, steps))
            self._start = step
            self._rows = threefry.randint(halves[:, 0], (self.local_bs,), 0,
                                          self.n_local)
            self._slots = threefry.randint(halves[:, 1],
                                           (self.local_bs, self.n_neg), 0,
                                           self.pool_size)
        i = step - self._start
        return self._rows[i], self._slots[i]


def scatter_rows(ids: torch.Tensor, rows: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``zeros[vocab, dim].at[ids].add(rows)``: the row-payload
    ``segment_sum`` kernel (its plain version for CPU tensors)."""
    from flinkml_tpu_torch.kernels.segsum import segment_sum

    return segment_sum(rows.reshape(-1, rows.shape[-1]),
                       ids.reshape(-1).to(torch.int32), vocab)


def onehot_rows(ids: torch.Tensor, rows: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """``one_hot(ids)ᵀ @ rows``, the scatter-free accumulation."""
    flat_rows = rows.reshape(-1, rows.shape[-1])
    oh = torch.nn.functional.one_hot(ids.reshape(-1).long(), vocab) \
        .to(flat_rows.dtype)
    return torch.einsum("bv,bd->vd", oh, flat_rows)


def _sgns_trainer(mesh, local_bs: int, n_neg: int,
                  accum: Optional[str] = None):
    """The replicated-table SGNS trainer: ``trainer(centers, contexts, wl,
    pool, v0, u0, lr, n_steps, key) -> (v, u)`` over this rank's pair rows
    (``wl`` 0 on dummy rows), ``pool`` and the tables replicated."""
    accum = resolve_accum(accum)
    grouped = mesh is not None and mesh.group(mesh.DATA_AXIS) is not None
    add = scatter_rows if accum == "scatter" else onehot_rows

    def trainer(centers, contexts, wl, pool, v, u, lr, n_steps: int, key):
        if accum == "onehot" and v.device.type != "cpu":
            raise ValueError(
                f"accum='onehot' runs on CPU tables only (these are on "
                f"{v.device}): its [bs*n_neg, vocab] one-hot operand "
                f"grows with the vocabulary; use accum='scatter'")
        vocab, dim = v.shape
        draws = PairDraws(key, local_bs, n_neg, centers.shape[0],
                          pool.shape[0])
        lr = torch.tensor(lr, dtype=torch.float32, device=v.device)
        for step in range(n_steps):
            idx, slots = draws(step)
            c, ctx, wb = centers[idx], contexts[idx], wl[idx]
            neg = pool[slots]                              # [bs, n_neg]
            grad_vc, grad_uc, grad_un = _sgns_pair_grads(
                v[c.long()], u[ctx.long()], u[neg.long()], wb)
            dv = add(c, grad_vc, vocab)
            du = add(ctx, grad_uc, vocab) + add(neg, grad_un, vocab)
            tw = torch.sum(wb)
            if grouped:
                from flinkml_tpu_torch.parallel.collectives import all_reduce_

                buf = torch.cat([dv.reshape(-1), du.reshape(-1),
                                 tw.reshape(1)])
                all_reduce_(mesh, buf)
                n = vocab * dim
                dv = buf[:n].reshape(vocab, dim)
                du = buf[n:2 * n].reshape(vocab, dim)
                tw = buf[-1]
            scale = lr / torch.clamp_min(tw, 1e-12)
            v = v - scale * dv
            u = u - scale * du
        return v, u

    return trainer


def _sgns_trainer_sharded(mesh, local_bs: int, n_neg: int, shard_rows: int,
                          strategy: str = "ring"):
    """The vocab-sharded SGNS trainer, for vocabularies above the dense
    threshold: ``trainer(centers, contexts, wl, pool, v_shard, u_shard,
    lr, n_steps, key) -> (v_shard, u_shard)``, each rank holding
    ``shard_rows`` rows of both tables. Per step: ONE exchange gather of
    the batch's rows for both tables, the shared pair math, ONE exchange
    scatter of the scaled gradient rows (``ring`` hops, or ``all_to_all``
    whose scatter is ``segment_sum``) — ``2·(2 + n_neg)·global_bs·dim``
    floats per rank, independent of vocab."""
    from flinkml_tpu_torch.embeddings import exchange
    from flinkml_tpu_torch.parallel.collectives import group_all_reduce

    axes = exchange.ShardAxes.of(mesh, (mesh.DATA_AXIS,))
    p = mesh.axis_size()

    def trainer(centers, contexts, wl, pool, v, u, lr, n_steps: int, key):
        draws = PairDraws(key, local_bs, n_neg, centers.shape[0],
                          pool.shape[0])
        lr = torch.tensor(lr, dtype=torch.float32, device=v.device)
        for step in range(n_steps):
            idx, slots = draws(step)
            c, ctx, wb = centers[idx], contexts[idx], wl[idx]
            neg = pool[slots]
            vc, uc, un = exchange.gather(
                ((v, c), (u, ctx), (u, neg)), axes=axes, n_shards=p,
                shard_rows=shard_rows, strategy=strategy)
            grad_vc, grad_uc, grad_un = _sgns_pair_grads(vc, uc, un, wb)
            tw = group_all_reduce(axes.group, axes.ranks,
                                  torch.sum(wb).reshape(1))[0]
            scale = lr / torch.clamp_min(tw, 1e-12)
            v, u = exchange.scatter_add(
                (v, u),
                ((0, c, -scale * grad_vc), (1, ctx, -scale * grad_uc),
                 (1, neg, -scale * grad_un)),
                axes=axes, n_shards=p, shard_rows=shard_rows,
                strategy=strategy)
        return v, u

    return trainer


def _shard_vocab_threshold() -> int:
    """Vocab size above which a fit on several ranks switches to the
    vocab-sharded trainer: the embedding subsystem's dense threshold
    (``FLINKML_W2V_SHARD_VOCAB`` is its alias; 0 forces sharding)."""
    from flinkml_tpu_torch.embeddings import dense_vocab_threshold

    return dense_vocab_threshold()


def _exchange_strategy() -> str:
    from flinkml_tpu_torch.embeddings import exchange_strategy

    return exchange_strategy()


def _to(device, a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class Word2Vec(StreamingEstimatorMixin, _Word2VecParams, Estimator):
    """``fit`` accepts, besides a single in-RAM :class:`Table`, an
    **iterable of batch Tables** — the out-of-core path: pass A encodes
    the token stream to an int-coded doc cache (strings never spill),
    pass B replays it into a (center, context) pair cache, and each
    epoch replays the pair cache chunk by chunk, the SGNS minibatches
    sampling within the resident chunk.
    ``checkpoint_manager`` + ``checkpoint_interval`` snapshot both
    embedding matrices every N epochs; ``resume=True`` continues exactly
    PROVIDED the caller re-feeds the identical stream (Word2Vec takes no
    sealed DataCache: it carries no string vocabulary).

    ``accum`` picks the dense trainer's gradient accumulation
    (:data:`ACCUMS`, the module docstring; ``"onehot"`` on CPU tables
    only); None, the default, takes the tuning table's ``w2v_accum`` for
    the fit's device, else ``"scatter"`` (:func:`resolve_accum`)."""

    # Pair-chunk row tile of the streamed fit: bounds the padded shapes.
    _PAIR_TILE = 2048

    def __init__(self, accum: Optional[str] = None, **kwargs):
        if accum is not None:
            check_accum(accum)
        super().__init__(**kwargs)
        self.accum = accum

    def _mesh(self):
        from flinkml_tpu_torch.parallel.mesh import DeviceMesh

        return self.mesh if self.mesh is not None else DeviceMesh()

    def fit(self, *inputs) -> "Word2VecModel":
        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
        self._reject_in_ram_checkpointing()
        docs = _token_column(table, self.get(self.INPUT_COL))
        min_count = self.get(self.MIN_COUNT)
        counts: Dict[str, int] = {}
        for toks in docs:
            for t in toks:
                t = str(t)
                counts[t] = counts.get(t, 0) + 1
        vocab = [t for t, c in counts.items() if c >= min_count]
        vocab.sort(key=lambda t: (-counts[t], t))
        if not vocab:
            raise ValueError(
                f"no token reaches minCount={min_count}; vocabulary is empty"
            )
        vocab_index = {t: i for i, t in enumerate(vocab)}
        rng = np.random.default_rng(self.get_seed())
        centers, contexts = _build_pairs(
            docs, vocab_index, self.get(self.WINDOW_SIZE), rng
        )
        if centers.size == 0:
            raise ValueError("no (center, context) pairs; documents too short")
        freq = np.asarray([counts[t] for t in vocab], np.float64) ** 0.75
        pool = rng.choice(
            len(vocab), size=_NEG_POOL, p=freq / freq.sum()
        ).astype(np.int32)

        dim = self.get(self.VECTOR_SIZE)
        mesh = self._mesh()
        p = mesh.axis_size()
        device = mesh.device
        # Shuffle, then pad by REPEATING real pairs: a zero pad would be a
        # genuine (0, 0) positive pair.
        perm = rng.permutation(len(centers))
        centers, contexts = centers[perm], contexts[perm]
        pad = (-len(centers)) % p
        centers_p = np.concatenate([centers, centers[:pad]])
        contexts_p = np.concatenate([contexts, contexts[:pad]])

        local_bs = max(1, self.get(self.BATCH_SIZE) // p)
        steps_per_epoch = max(1, len(centers) // self.get(self.BATCH_SIZE))
        n_steps = steps_per_epoch * self.get(self.MAX_ITER)

        v0 = (rng.random((len(vocab), dim)) - 0.5).astype(np.float32) / dim
        u0 = np.zeros((len(vocab), dim), np.float32)
        key = threefry.PRNGKey(self.get_seed(), device)
        args = (mesh.shard_batch(centers_p), mesh.shard_batch(contexts_p),
                mesh.shard_batch(np.ones(len(centers_p), np.float32)),
                _to(device, pool))
        lr = self.get(self.LEARNING_RATE)
        if p > 1 and len(vocab) > _shard_vocab_threshold():
            shard_rows = -(-len(vocab) // p)
            row_pad = shard_rows * p - len(vocab)
            zeros = np.zeros((row_pad, dim), np.float32)
            trainer = _sgns_trainer_sharded(
                mesh, local_bs, self.get(self.NUM_NEGATIVES), shard_rows,
                _exchange_strategy())
            v, _u = trainer(
                *args, mesh.shard_batch(np.concatenate([v0, zeros])),
                mesh.shard_batch(np.concatenate([u0, zeros])), lr, n_steps,
                key)
            v = mesh.to_host(v)[: len(vocab)]
        else:
            trainer = _sgns_trainer(
                mesh, local_bs, self.get(self.NUM_NEGATIVES), self.accum)
            v, _u = trainer(*args, _to(device, v0), _to(device, u0), lr,
                            n_steps, key)
            v = v.cpu().numpy()
        model = Word2VecModel()
        model.copy_params_from(self)
        model._set(np.asarray(vocab, dtype=str), np.asarray(v, np.float64))
        return model

    def _fit_stream(self, source) -> "Word2VecModel":
        """Out-of-core SGNS (the class docstring).

        On a mesh of several ranks each rank feeds its own document
        partition: the string vocabulary unions exactly
        (:func:`_agree_token_counts`), pair building stays rank-local (a
        per-rank window RNG), and each dispatch is one agreed-step SGNS
        run over every rank's resident chunk with summed gradients
        (drained ranks feed weight-0 dummy chunks). The negative pool and
        initial vectors come from a seed-only RNG, identical on every
        rank, and so are the fitted vectors."""
        import os
        import shutil
        import tempfile

        from flinkml_tpu_torch.iteration.checkpoint import (
            begin_resume,
            save_replicated,
            should_snapshot,
        )
        from flinkml_tpu_torch.iteration.datacache import (
            DataCache,
            DataCacheWriter,
        )
        from flinkml_tpu_torch.iteration.stream_sync import (
            DeferredValidation,
            agree_max,
            agreed_restore,
            checked_ingest,
            gather_vectors,
            synced_stream,
        )
        from flinkml_tpu_torch.models._linear_sgd import multi_rank
        from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
        from flinkml_tpu_torch.parallel.distributed import process_index

        if isinstance(source, DataCache):
            raise ValueError(
                "Word2Vec streamed fit takes an iterable of batch Tables "
                "(token documents are encoded internally; a raw DataCache "
                "carries no string vocabulary)"
            )
        mesh = self._mesh()
        multi = multi_rank(mesh)
        input_col = self.get(self.INPUT_COL)
        min_count = self.get(self.MIN_COUNT)
        window = self.get(self.WINDOW_SIZE)
        p = mesh.axis_size()
        device = mesh.device
        resume_epoch = begin_resume(self.checkpoint_manager, self.resume,
                                    mesh.num_devices)

        # -- pass A: count tokens + cache int-coded docs -------------------
        if self.cache_dir is not None:
            os.makedirs(self.cache_dir, exist_ok=True)
        doc_dir = tempfile.mkdtemp(prefix="flinkml-w2v-docs-",
                                   dir=self.cache_dir)
        pid: Dict[str, int] = {}
        counts_list: List[int] = []
        try:
            doc_writer = DataCacheWriter(doc_dir,
                                         self.cache_memory_budget_bytes)

            def ingest_docs(t):
                docs = _token_column(t, input_col)
                codes: List[int] = []
                lengths: List[int] = []
                for toks in docs:
                    start = len(codes)
                    for tok in map(str, toks):
                        i = pid.get(tok)
                        if i is None:
                            i = pid[tok] = len(counts_list)
                            counts_list.append(0)
                        counts_list[i] += 1
                        codes.append(i)
                    lengths.append(len(codes) - start)
                if lengths:
                    # One flat record: [n_docs, *lengths, *codes].
                    doc_writer.append({
                        "rec": np.concatenate(
                            [[len(lengths)], lengths, codes]
                        ).astype(np.int32),
                    })

            dv = DeferredValidation()
            for _ in checked_ingest(source, dv, ingest_docs, multi):
                pass
            doc_cache = doc_writer.finish()

            tokens = np.empty(len(pid), dtype=object)
            for tok, i in pid.items():
                tokens[i] = tok
            if multi:
                dv.rendezvous(mesh, "stream ingest validation")
                merged = _agree_token_counts(list(tokens), counts_list, mesh)
                if not merged:
                    raise ValueError(
                        "training stream is empty on every process")
                vocab = [t for t, c in merged.items() if c >= min_count]
                vocab.sort(key=lambda t: (-merged[t], t))
                if not vocab:  # merged is identical: symmetric raise
                    raise ValueError(
                        f"no token reaches minCount={min_count}; "
                        "vocabulary is empty"
                    )
                final_of_token = {t: f for f, t in enumerate(vocab)}
                final_of_pid = np.full(len(counts_list), -1, np.int32)
                for i in range(len(counts_list)):
                    final_of_pid[i] = final_of_token.get(str(tokens[i]), -1)
                vocab_counts = np.asarray([merged[t] for t in vocab],
                                          np.int64)
            else:
                counts_arr = np.asarray(counts_list, np.int64)
                kept = [i for i in range(len(counts_list))
                        if counts_arr[i] >= min_count]
                kept.sort(key=lambda i: (-counts_arr[i], tokens[i]))
                if not kept:
                    raise ValueError(
                        f"no token reaches minCount={min_count}; vocabulary "
                        "is empty"
                    )
                vocab = [tokens[i] for i in kept]
                final_of_pid = np.full(len(counts_list), -1, np.int32)
                for f, i in enumerate(kept):
                    final_of_pid[i] = f
                vocab_counts = counts_arr[kept]

            # The scale guard, before pass B: the multi-rank stream's
            # per-rank pair partitions do not ride the sharded trainer.
            if multi and len(vocab) > _shard_vocab_threshold():
                raise ValueError(
                    f"multi-process streamed Word2Vec fit: vocabulary "
                    f"({len(vocab)} tokens) exceeds the dense-gradient "
                    f"scale ceiling ({_shard_vocab_threshold()}): every "
                    "SGNS step would psum a full [vocab, dim] gradient "
                    "across processes. Use the in-RAM fit or a "
                    "single-process mesh (both switch to the "
                    "vocab-sharded ring trainer above this threshold), "
                    "raise minCount to prune the vocabulary, or override "
                    "via FLINKML_W2V_SHARD_VOCAB."
                )

            # -- pass B: replay the doc cache into the pair cache ----------
            if multi:
                rng = np.random.default_rng(
                    [self.get_seed(), 1 + process_index()])
            else:
                rng = np.random.default_rng(self.get_seed())
            pair_writer = DataCacheWriter(self.cache_dir,
                                          self.cache_memory_budget_bytes)
            n_pairs = 0
            for batch in doc_cache.reader():
                rec = batch["rec"]
                n_docs = int(rec[0])
                lengths_b = rec[1:1 + n_docs]
                fids = final_of_pid[rec[1 + n_docs:]]
                centers: List[int] = []
                contexts: List[int] = []
                off = 0
                for length in lengths_b:
                    ids = [int(c) for c in fids[off:off + length] if c >= 0]
                    off += int(length)
                    for i, c in enumerate(ids):
                        w = int(rng.integers(1, window + 1))
                        for j in range(max(0, i - w),
                                       min(len(ids), i + w + 1)):
                            if j != i:
                                centers.append(c)
                                contexts.append(ids[j])
                if centers:
                    pair_writer.append({
                        "c": np.asarray(centers, np.int32),
                        "x": np.asarray(contexts, np.int32),
                    })
                    n_pairs += len(centers)
            pair_cache = pair_writer.finish()
        finally:
            shutil.rmtree(doc_dir, ignore_errors=True)
        if multi:
            total_pairs = int(round(gather_vectors(
                np.asarray([float(n_pairs)]), mesh).sum()))
            if total_pairs == 0:
                raise ValueError(
                    "no (center, context) pairs on any process; documents "
                    "too short"
                )
        elif n_pairs == 0:
            raise ValueError("no (center, context) pairs; documents too short")

        # unigram^0.75 pool over the FINAL vocab (seed-only RNG on several
        # ranks: the same pool and initial vectors everywhere).
        rng_global = np.random.default_rng(self.get_seed()) if multi else rng
        freq = vocab_counts.astype(np.float64) ** 0.75
        pool = rng_global.choice(
            len(vocab), size=_NEG_POOL, p=freq / freq.sum()
        ).astype(np.int32)
        pool_dev = _to(device, pool)

        dim = self.get(self.VECTOR_SIZE)
        batch_size = self.get(self.BATCH_SIZE)
        local_bs = max(1, batch_size // p)
        use_sharded = p > 1 and len(vocab) > _shard_vocab_threshold()
        if use_sharded:
            shard_rows = -(-len(vocab) // p)
            vocab_pad = shard_rows * p
            trainer = _sgns_trainer_sharded(
                mesh, local_bs, self.get(self.NUM_NEGATIVES), shard_rows,
                _exchange_strategy())
        else:
            trainer = _sgns_trainer(
                mesh, local_bs, self.get(self.NUM_NEGATIVES), self.accum)
        lr = self.get(self.LEARNING_RATE)
        base_key = threefry.PRNGKey(self.get_seed(), device)

        def place_vu(v_h, u_h):
            """Replicated for the dense trainer, row-sharded (padded) for
            the sharded one."""
            if not use_sharded:
                return _to(device, v_h), _to(device, u_h)
            z = np.zeros((vocab_pad - len(vocab), dim), np.float32)
            return (mesh.shard_batch(np.concatenate([v_h, z])),
                    mesh.shard_batch(np.concatenate([u_h, z])))

        def host_vu(v, u):
            """Both tables on the host, unpadded (a collective when
            sharded: every rank calls it)."""
            if use_sharded:
                return (mesh.to_host(v)[: len(vocab)],
                        mesh.to_host(u)[: len(vocab)])
            return v.cpu().numpy(), u.cpu().numpy()

        u_h0 = np.zeros((len(vocab), dim), np.float32)
        start_epoch = 0
        if resume_epoch is None:
            v_h0 = ((rng_global.random((len(vocab), dim)) - 0.5)
                    .astype(np.float32) / dim)
        else:
            like = (np.zeros((len(vocab), dim), np.float32),) * 2
            (v_h0, u_h0), start_epoch = agreed_restore(
                self.checkpoint_manager, resume_epoch, like,
                mesh if multi else None)
        v, u = place_vu(np.asarray(v_h0, np.float32),
                        np.asarray(u_h0, np.float32))

        guard = DispatchGuard()  # multi-rank backpressure (no-op on one)
        local_tile = self._PAIR_TILE
        tile = p * self._PAIR_TILE
        max_iter = self.get(self.MAX_ITER)
        for epoch in range(start_epoch, max_iter):
            epoch_key = threefry.fold_in(base_key, epoch)
            if multi:
                # Distribute the per-epoch step budget (global pairs /
                # batch_size) over the agreed dispatch count, so dummy
                # padding never adds SGD steps.
                n_dispatch = max(1, agree_max(pair_cache.num_batches, mesh))
                steps = max(1, total_pairs // (batch_size * n_dispatch))

                def height_of(b):
                    return -(-max(len(b["c"]), 1) // local_tile)

                for ci, (b, tiles) in enumerate(synced_stream(
                        pair_cache.reader(), mesh, payload=height_of)):
                    h = tiles * local_tile
                    if b is None:
                        c_p = np.zeros(h, np.int32)
                        x_p = np.zeros(h, np.int32)
                        w_p = np.zeros(h, np.float32)
                    else:
                        # Pad by CYCLING real pairs.
                        c_p, x_p = np.resize(b["c"], h), np.resize(b["x"], h)
                        w_p = np.ones(h, np.float32)
                    v, u = trainer(
                        _to(device, c_p), _to(device, x_p), _to(device, w_p),
                        pool_dev, v, u, lr, steps,
                        threefry.fold_in(epoch_key, ci))
                    guard.after_dispatch(v)
            else:
                for ci, batch in enumerate(pair_cache.reader()):
                    c, x = batch["c"], batch["x"]
                    rows = max(tile, -(-len(c) // tile) * tile)
                    c_p, x_p = np.resize(c, rows), np.resize(x, rows)
                    steps = max(1, len(c) // batch_size)
                    v, u = trainer(
                        mesh.shard_batch(c_p), mesh.shard_batch(x_p),
                        mesh.shard_batch(np.ones(rows, np.float32)),
                        pool_dev, v, u, lr, steps,
                        threefry.fold_in(epoch_key, ci))
            if should_snapshot(self.checkpoint_manager,
                               self.checkpoint_interval, epoch + 1,
                               max_iter):
                state = host_vu(v, u)
                if multi:
                    save_replicated(self.checkpoint_manager, state,
                                    epoch + 1, mesh)
                else:
                    self.checkpoint_manager.save(state, epoch + 1)
        guard.flush(v)

        model = Word2VecModel()
        model.copy_params_from(self)
        model._set(np.asarray(vocab, dtype=str),
                   np.asarray(host_vu(v, u)[0], np.float64))
        return model


class Word2VecModel(_Word2VecParams, Model):
    def __init__(self):
        super().__init__()
        self._vocab: Optional[np.ndarray] = None
        self._vectors: Optional[np.ndarray] = None
        self._index: Dict[str, int] = {}

    def _set(self, vocab: np.ndarray, vectors: np.ndarray) -> None:
        self._vocab = vocab
        self._vectors = vectors
        self._index = {str(t): i for i, t in enumerate(vocab)}

    @property
    def vocabulary(self) -> np.ndarray:
        self._require()
        return self._vocab

    @property
    def vectors(self) -> np.ndarray:
        self._require()
        return self._vectors

    def set_model_data(self, *inputs: Table) -> "Word2VecModel":
        (table,) = inputs
        self._set(
            np.asarray(table.column("word"), dtype=str),
            np.asarray(table.column("vector"), np.float64),
        )
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({"word": self._vocab, "vector": self._vectors})]

    def _require(self) -> None:
        if self._vocab is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def _arrays(self):
        self._require()
        return {"word": self._vocab, "vector": self._vectors}

    def _set_arrays(self, arrays) -> None:
        self._set(np.asarray(arrays["word"]).astype(str),
                  np.asarray(arrays["vector"], np.float64))

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        """Document vector = mean of its in-vocabulary word vectors (zero
        vector when none are in vocabulary) — the upstream layout."""
        (table,) = inputs
        self._require()
        docs = _token_column(table, self.get(self.INPUT_COL))
        dim = self._vectors.shape[1]
        out = np.zeros((len(docs), dim))
        for i, toks in enumerate(docs):
            ids = [self._index[t] for t in map(str, toks) if t in self._index]
            if ids:
                out[i] = self._vectors[ids].mean(axis=0)
        return (table.with_column(self.get(self.OUTPUT_COL), out),)

    def find_synonyms(self, word: str, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k cosine-similar vocabulary words: one matrix product on the
        compute device, then the port's ``topk`` kernel."""
        from flinkml_tpu_torch.device import default_device
        from flinkml_tpu_torch.kernels.topk import top_k

        self._require()
        i = self._index.get(str(word))
        if i is None:
            raise ValueError(f"word {word!r} is not in the vocabulary")
        vecs = _to(default_device(), self._vectors.astype(np.float32))
        sims = cosine_scores(vecs, i)
        vals, idx = top_k(sims, min(k, len(self._vocab) - 1))
        return self._vocab[idx.cpu().numpy()], vals.cpu().numpy()


def cosine_scores(vecs: torch.Tensor, i: int) -> torch.Tensor:
    """Cosine similarity of every row of ``vecs`` with row ``i``, row
    ``i`` itself set to ``-inf``."""
    norms = torch.linalg.norm(vecs, dim=1) + 1e-12
    sims = (vecs @ vecs[i]) / (norms * norms[i])
    sims[i] = float("-inf")
    return sims
