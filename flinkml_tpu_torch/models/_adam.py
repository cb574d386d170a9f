"""Shared Adam trainer: minibatch steps over a data-sharded mesh.

The port's counterpart of ``flinkml_tpu.models._adam``, the scaffold behind
the MLPs and the factorization machines — any model whose parameters are a
flat tuple of tensors and whose loss is a per-row weighted sum:

  - Each step draws its minibatch as JAX does: ``fold_in(key, step)``,
    then ``randint(·, (local_bs,), 0, n_local)`` over this rank's rows
    (:mod:`flinkml_tpu_torch.ops.threefry`, so the port samples JAX's rows).
    The draws of a block of :data:`DRAW_BLOCK` steps come from one
    vectorised call, a few dozen elementwise launches instead of that many
    per step.
  - The loss and its gradients come from ``torch.autograd``; the
    differentiated function holds no collective. On a mesh of several
    ranks one ``all_reduce`` a step sums the flat buffer ``[grads |
    loss_sum | wsum]`` (the JAX step's ``psum``s), and the step divides by
    the global batch weight.
  - Adam's update is elementwise in float32 with JAX's ``b1``, ``b2``,
    ``eps`` and bias correction (``t = step + 1``).
  - :func:`make_adam_trainer` stops when ``|loss_{t-1} - loss_t| <= tol``
    (float32, checked after every step: the stop step is JAX's) or at
    ``max_iter`` steps; :func:`make_adam_chunk_trainer` runs a fixed
    number of steps on one resident chunk, its keys folding the GLOBAL
    step, for :func:`run_streamed_adam`, the out-of-core fit.

The JAX trainers draw their indices with ``jax.random.randint``'s default
integer type, int64 under ``jax_enable_x64`` (the configuration the port is
held against) and int32 without it, which samples other rows; the port
draws as the former.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.ops import threefry

#: Steps whose minibatch indices are drawn by one vectorised call.
DRAW_BLOCK = 32

B1, B2, EPS = 0.9, 0.999, 1e-8


def draw_indices(key: torch.Tensor, step0: int, n_steps: int, local_bs: int,
                 n_local: int) -> torch.Tensor:
    """The minibatch indices of steps ``step0 .. step0 + n_steps - 1``,
    ``[n_steps, local_bs]``: row ``i`` is ``randint(fold_in(key, step0 +
    i), (local_bs,), 0, n_local)``."""
    steps = torch.arange(step0, step0 + n_steps, dtype=torch.int64,
                         device=key.device)
    return threefry.randint(threefry.fold_in(key, steps), (local_bs,), 0,
                            n_local)


class IndexDraws:
    """The per-step minibatch indices of one key, drawn a block of
    :data:`DRAW_BLOCK` steps at a time as the steps reach them."""

    def __init__(self, key: torch.Tensor, local_bs: int, n_local: int):
        self.key, self.local_bs, self.n_local = key, local_bs, n_local
        self._start, self._block = 0, None

    def __call__(self, step: int) -> torch.Tensor:
        if self._block is None or not (
                self._start <= step < self._start + self._block.shape[0]):
            self._start = step
            self._block = draw_indices(self.key, step, DRAW_BLOCK,
                                       self.local_bs, self.n_local)
        return self._block[step - self._start]


def _has_group(mesh) -> bool:
    return mesh is not None and mesh.group(mesh.DATA_AXIS) is not None


def _psum_terms(mesh, grads, loss_sum, wsum):
    """``(grads, loss_sum, wsum)`` summed over the mesh's data axis: one
    ``all_reduce`` of the flat buffer ``[grads | loss_sum | wsum]``."""
    if not _has_group(mesh):
        return grads, loss_sum, wsum
    from flinkml_tpu_torch.parallel.collectives import all_reduce_

    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss_sum.reshape(1), wsum.reshape(1)])
    all_reduce_(mesh, flat)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].reshape(g.shape))
        off += g.numel()
    return tuple(out), flat[off], flat[off + 1]


def adam_update(params, m, v, grads, step: int, lr):
    """One Adam update of every parameter (float32, JAX's expression
    order): returns ``(params, m, v)``."""
    t = torch.tensor(float(step + 1), dtype=torch.float32,
                     device=params[0].device)
    c1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32,
                                    device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32,
                                    device=t.device), t)
    m = tuple(B1 * a + (1 - B1) * g for a, g in zip(m, grads))
    v = tuple(B2 * a + (1 - B2) * g * g for a, g in zip(v, grads))
    params = tuple(p - lr * (mm / c1) / (torch.sqrt(vv / c2) + EPS)
                   for p, mm, vv in zip(params, m, v))
    return params, m, v


def _make_minibatch_step(local_loss: Callable, mesh, n_params: int,
                         frozen_tail: int):
    """ONE Adam minibatch step — the optimizer math shared by the
    whole-run and chunked trainers. Returns ``step_fn(x, y, w, params, m,
    v, step, lr, idx) -> (params, m, v, loss)``, ``idx`` the step's drawn
    rows and ``step`` the GLOBAL 0-based step (the bias correction)."""
    n_train = n_params - frozen_tail

    def step_fn(x, y, w, params, m, v, step: int, lr, idx):
        xb, yb, wb = x[idx], y[idx], w[idx]
        leaves = tuple(p.detach().requires_grad_(i < n_train)
                       for i, p in enumerate(params))
        with torch.enable_grad():
            loss_sum = local_loss(leaves, xb, yb, wb)
            grads = torch.autograd.grad(loss_sum, leaves[:n_train])
        grads = grads + tuple(torch.zeros_like(p) for p in params[n_train:])
        grads, loss_sum, wsum = _psum_terms(mesh, grads, loss_sum.detach(),
                                            torch.sum(wb))
        total_w = torch.clamp_min(wsum, 1e-12)
        loss = loss_sum / total_w
        grads = tuple(g / total_w for g in grads)
        params, m, v = adam_update(tuple(p.detach() for p in params), m, v,
                                   grads, step, lr)
        return params, m, v, loss

    return step_fn


def _zeros_like(params) -> tuple:
    return tuple(torch.zeros_like(p) for p in params)


def make_adam_trainer(mesh, local_bs: int, loss_builder, n_params: int,
                      frozen_tail: int = 0):
    """``loss_builder`` is a module-level factory returning ``loss(params,
    xb, yb, wb) -> local weighted sum``. Returns ``trainer(x, y, w,
    params0, lr, max_iter, tol, key) -> (params, steps, loss)`` over this
    rank's rows ``x, y, w`` (tensors on the mesh's device), ``key`` a
    threefry key tensor.

    The last ``frozen_tail`` entries of the params tuple are constants the
    loss reads (e.g. a regularization strength); their gradients are zero
    so Adam never moves them."""
    mb_step = _make_minibatch_step(loss_builder(), mesh, n_params,
                                   frozen_tail)

    def trainer(x, y, w, params, lr, max_iter: int, tol: float, key):
        params = tuple(params)
        m, v = _zeros_like(params), _zeros_like(params)
        lr = torch.tensor(lr, dtype=torch.float32, device=x.device)
        draws = IndexDraws(key, local_bs, x.shape[0])
        tol32 = np.float32(tol)
        prev, cur = np.float32(np.inf), np.float32(-np.inf)
        step = 0
        loss = torch.tensor(-np.inf, dtype=torch.float32)
        while step < max_iter and np.abs(prev - cur) > tol32:
            params, m, v, loss = mb_step(x, y, w, params, m, v, step, lr,
                                         draws(step))
            prev, cur = cur, np.float32(loss.item())
            step += 1
        return params, step, loss

    return trainer


def make_adam_chunk_trainer(mesh, local_bs: int, loss_builder,
                            n_params: int, frozen_tail: int = 0):
    """Fixed-step sibling of :func:`make_adam_trainer` for streamed
    out-of-core fits: ``trainer(x, y, w, params, m, v, step0, lr,
    n_steps, key) -> (params, m, v, step, loss)`` runs ``n_steps`` Adam
    steps on ONE resident chunk, carrying the full optimizer state in and
    out. Keys fold the GLOBAL step, so a resumed run draws the key
    sequence of the uninterrupted one (the rows a key selects live in the
    resident chunk)."""
    mb_step = _make_minibatch_step(loss_builder(), mesh, n_params,
                                   frozen_tail)

    def trainer(x, y, w, params, m, v, step0: int, lr, n_steps: int, key):
        lr = torch.tensor(lr, dtype=torch.float32, device=x.device)
        loss = torch.tensor(-np.inf, dtype=torch.float32, device=x.device)
        draws = IndexDraws(key, local_bs, x.shape[0])
        params = tuple(params)
        for step in range(step0, step0 + n_steps):
            params, m, v, loss = mb_step(x, y, w, params, m, v, step, lr,
                                         draws(step))
        return params, m, v, step0 + n_steps, loss

    return trainer


def run_streamed_adam(
    source,
    *,
    what: str,
    mesh,
    cache_dir,
    cache_memory_budget_bytes,
    ingest,
    place_y,
    loss_builder,
    n_params: int,
    params0_fn,
    lr: float,
    global_bs: int,
    max_iter: int,
    tol: float,
    seed: int,
    frozen_tail: int = 0,
    checkpoint_manager=None,
    checkpoint_interval: int = 0,
    resume: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The shared out-of-core Adam fit loop (MLP, FM): cache the stream
    once, then each epoch replays the cache chunk by chunk through
    :func:`make_adam_chunk_trainer`, the optimizer state carried across
    chunks as one continuous run and snapshotted at epoch boundaries
    (``begin_resume``/``should_snapshot``; resume needs a durable
    DataCache input).

    - ``ingest(table) -> {"x", "y", "w"}``: per-batch extraction and
      validation for the caching pass;
    - ``place_y(y_raw) -> y``: label preparation applied at replay time to
      a caller's sealed cache;
    - ``params0_fn(d) -> flat params tuple``: initial parameters for the
      feature dim found in the cache.

    Each resident chunk contributes ``ceil(rows / global_bs)`` steps an
    epoch, and chunks pad with weight-0 rows to the ``8p`` row tile (the
    JAX package's padding, so the draws over ``[0, n_local)`` select the
    same rows). ``max_iter`` counts epochs; the fit stops early when an
    epoch's last loss moves by at most ``tol``.

    On a mesh of several ranks each rank caches its own partition; the
    ranks agree the chunk schedule (the most chunks of any rank, the
    tallest chunk), the feature dim, the label dtype and each chunk
    index's step count (from the GLOBAL row count of that index), drained
    ranks feed weight-0 dummy chunks, and snapshots go through
    ``save_replicated``. Returns the final flat params tuple (tensors)."""
    from flinkml_tpu_torch.iteration.checkpoint import (
        begin_resume,
        save_replicated,
        should_snapshot,
    )
    from flinkml_tpu_torch.iteration.datacache import (
        DataCache,
        DataCacheWriter,
        PrefetchingDeviceFeed,
        device_put,
    )
    from flinkml_tpu_torch.iteration.stream_sync import (
        DeferredValidation,
        SyncedReplayPlan,
        agree_all_ok,
        agree_feature_dim,
        agree_max,
        agreed_restore,
        checked_ingest,
        entry_rows,
        gather_vectors,
        pad_rows_to,
    )
    from flinkml_tpu_torch.models._linear_sgd import multi_rank
    from flinkml_tpu_torch.parallel.dispatch import DispatchGuard
    from flinkml_tpu_torch.parallel.mesh import pad_to_multiple

    multi = multi_rank(mesh)
    if resume and not isinstance(source, DataCache):
        raise ValueError(
            "resume=True requires a durable DataCache input: a one-shot "
            "stream cannot be replayed from the start after a failure"
        )
    p = mesh.axis_size()
    device = mesh.device
    resume_epoch = begin_resume(checkpoint_manager, resume, mesh.num_devices)

    # -- pass 0: cache --------------------------------------------------
    dv = DeferredValidation()
    first_dim = [None]

    def validate_ingest(t):
        """Ingest-time validation of everything placement would catch: on
        several ranks a raise at placement would abort one rank in the
        middle of a collective."""
        b = ingest(t)
        x = b["x"]
        if x.shape[0] == 0:
            raise ValueError("stream batch has zero rows; drop empty batches")
        if first_dim[0] is None:
            first_dim[0] = x.shape[1]
        elif x.shape[1] != first_dim[0]:
            raise ValueError(
                f"batch feature dim {x.shape[1]} != first batch's "
                f"{first_dim[0]}"
            )
        if "w" in b and float(np.sum(b["w"])) == 0.0:
            raise ValueError(
                "stream batch has zero total weight (all weights 0); "
                "drop such batches before training"
            )
        return b

    if isinstance(source, DataCache):
        cache = source
    else:
        writer = DataCacheWriter(cache_dir, cache_memory_budget_bytes)

        def ingest_and_append(t):
            writer.append(validate_ingest(t))

        for _ in checked_ingest(source, dv, ingest_and_append, multi):
            pass
        cache = writer.finish()
    if not multi and cache.num_rows == 0:
        raise ValueError("training stream is empty")
    d = 0
    if cache.num_batches:
        reader = cache.reader()
        d = np.asarray(next(iter(reader))["x"]).shape[1]

    plan = None
    nsteps_sched = None
    y_dtype = None
    if multi:
        dv.rendezvous(mesh, "stream ingest validation")
        plan = SyncedReplayPlan.create(cache, mesh, p * 8)
        d = agree_feature_dim(cache, "x", mesh, local_dim=d)
        local_rows = np.zeros(plan.global_steps)
        for t, entry in enumerate(cache.entries):
            local_rows[t] = entry_rows(entry)
        rows_global = gather_vectors(local_rows, mesh).sum(axis=0)
        nsteps_sched = np.maximum(
            1, -(-rows_global.astype(np.int64) // global_bs))
        # Dummy chunks must carry the real label dtype.
        codes = {np.dtype(np.float32): 1, np.dtype(np.int32): 2,
                 np.dtype(np.int64): 3, np.dtype(np.float64): 4}
        local_code = 0
        if cache.num_batches:
            y0 = np.asarray(next(iter(cache.reader()))["y"])
            if isinstance(source, DataCache):
                y0 = place_y(y0)
            local_code = codes[np.dtype(np.asarray(y0).dtype)]
        code = agree_max(local_code, mesh)
        agree_all_ok(not (local_code and local_code != code), mesh,
                     "label-dtype agreement")
        y_dtype = {v: k for k, v in codes.items()}[code]

    # A cache this runner built holds prepared labels; a caller's sealed
    # cache is prepared at every replay.
    labels_prepared = not isinstance(source, DataCache)
    first_pass_done = [False]

    def rows_of(batch):
        x = np.asarray(batch["x"], np.float32)
        y = np.asarray(batch["y"])
        if not labels_prepared:
            y = place_y(y)
        w = (np.asarray(batch["w"], np.float32) if "w" in batch
             else np.ones(x.shape[0], np.float32))
        if not first_pass_done[0]:
            if x.shape[0] == 0:
                raise ValueError(
                    "stream batch has zero rows; drop empty batches")
            if x.shape[1] != d:
                raise ValueError(
                    f"batch feature dim {x.shape[1]} != first batch's {d}")
            if float(w.sum()) == 0.0:
                raise ValueError(
                    "stream batch has zero total weight (empty batch or all "
                    "weights 0); drop such batches before training")
        return x, y, w

    def place(batch):
        x, y, w = rows_of(batch)
        x_pad, n_valid = pad_to_multiple(x, p * 8)
        y_pad, _ = pad_to_multiple(y, p * 8)
        w_pad = np.zeros(x_pad.shape[0], np.float32)
        w_pad[:n_valid] = w[:n_valid]
        return (mesh.shard_batch(x_pad), mesh.shard_batch(y_pad),
                mesh.shard_batch(w_pad), x.shape[0])

    def place_multi(batch):
        """Fixed-height placement (dummy chunks: weight-0 no-ops)."""
        height = plan.local_height
        if "_dummy" in batch:
            x_pad = np.zeros((height, d), np.float32)
            y_pad = np.zeros(height, y_dtype)
            w_pad = np.zeros(height, np.float32)
        else:
            x, y, w = rows_of(batch)
            x_pad = pad_rows_to(x, height, np.float32)
            y_pad = pad_rows_to(np.asarray(y, y_dtype), height)
            w_pad = pad_rows_to(w, height, np.float32)
        return device_put((x_pad, y_pad, w_pad), device) + (0,)

    local_bs = max(1, global_bs // p)
    trainer = make_adam_chunk_trainer(mesh if multi else None, local_bs,
                                      loss_builder, n_params, frozen_tail)
    flat = tuple(t.to(device) for t in params0_fn(d))
    m, v = _zeros_like(flat), _zeros_like(flat)
    step = 0
    sample_key = threefry.fold_in(threefry.PRNGKey(seed, device), 123)

    prev_loss = np.inf
    start_epoch = 0
    terminated = False
    mgr = checkpoint_manager
    if resume_epoch is not None:
        like = (
            tuple(np.zeros(tuple(t.shape), np.float32) for t in flat),
            tuple(np.zeros(tuple(t.shape), np.float32) for t in flat),
            tuple(np.zeros(tuple(t.shape), np.float32) for t in flat),
            np.int32(0), np.float64(0.0), np.asarray(False),
        )
        (flat_h, m_h, v_h, step_h, prev_h, term), start_epoch = (
            agreed_restore(mgr, resume_epoch, like, mesh if multi else None))
        flat = tuple(torch.from_numpy(np.asarray(t)).to(device)
                     for t in flat_h)
        m = tuple(torch.from_numpy(np.asarray(t)).to(device) for t in m_h)
        v = tuple(torch.from_numpy(np.asarray(t)).to(device) for t in v_h)
        step = int(step_h)
        prev_loss = float(prev_h)
        terminated = bool(term)

    guard = DispatchGuard()  # multi-rank backpressure (no-op on one)
    for epoch in range(start_epoch, max_iter):
        if terminated:
            break
        last_loss = None
        if multi:
            src = plan.epoch_batches(cache.reader(), lambda: {"_dummy": True})
            feed = PrefetchingDeviceFeed(src, place=place_multi, depth=2)
        else:
            feed = PrefetchingDeviceFeed(cache.reader(), place=place,
                                         depth=2)
        try:
            for t, (xb, yb, wb, rows) in enumerate(feed):
                n_steps = (int(nsteps_sched[t]) if multi
                           else max(1, -(-rows // global_bs)))
                flat, m, v, step, loss = trainer(
                    xb, yb, wb, flat, m, v, step, lr, n_steps, sample_key)
                last_loss = loss
                guard.after_dispatch(loss)
        finally:
            feed.close()
        guard.flush(last_loss)
        first_pass_done[0] = True
        cur = float(np.float32(last_loss.item()))
        terminated = abs(prev_loss - cur) <= tol
        prev_loss = cur
        if should_snapshot(mgr, checkpoint_interval, epoch + 1, max_iter,
                           terminal=terminated):
            state = (
                tuple(t.cpu().numpy() for t in flat),
                tuple(t.cpu().numpy() for t in m),
                tuple(t.cpu().numpy() for t in v),
                np.int32(step), np.float64(prev_loss),
                np.asarray(terminated),
            )
            if multi:
                save_replicated(mgr, state, epoch + 1, mesh)
            else:
                mgr.save(state, epoch + 1)
        if terminated:
            break
    return flat


def flat_params(layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """``[(w0, b0), (w1, b1), ...]`` as the flat tuple the trainers take."""
    return tuple(t for wb in layers for t in wb)
