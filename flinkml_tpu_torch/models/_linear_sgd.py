"""SGD for linear models (dense and sparse) on one device.

The port's counterpart of ``flinkml_tpu.models._linear_sgd``. One trainer
serves every margin loss (``logistic``, ``hinge``, ``squared``;
:func:`flinkml_tpu_torch.ops.losses.margin_terms`); window slicing,
products, proximal update and termination are shared. L2 enters the
gradient; L1 (elastic net) is a proximal soft-threshold after the step.

- **Dense:** each step takes a contiguous rotating window of the
  host-shuffled rows, ``x @ coef`` → margin terms → ``x.T @ mult`` → prox
  update. Both products are ``torch.matmul``, as the JAX package leaves
  them to XLA.
- **Sparse:** nnz-bucketed padded ELL (``ops.sparse.pack_ell_buckets``);
  the forward margin is the ``spmv`` kernel per bucket and the gradient
  one ``segment_sum`` kernel over every bucket's cells (layout
  ``unsorted``), or one sorted ``segment_sum`` per bucket over pack-time
  per-window sort tables (layout ``sorted``).

**The device loop.** The JAX trainers run the whole epoch loop as one
``lax.while_loop`` on the device. Here the carry ``(coef, epoch, loss)``
stays on the device too: every step computes its candidate update, a
device-side flag ``active = (epoch < epoch_end) & (loss > tol)`` selects
it with ``torch.where`` and advances the epoch only while active, and the
host reads that flag once every :data:`SYNC_EVERY` steps. The result is
the ``while_loop``'s — the same epoch count and the same coefficients, at
any ``tol`` — with no host round trip per step.

Single device only: the data-parallel mesh (``torch.distributed``) comes
with ROADMAP.md Queue 1 item 7. Not ported yet, each refused with
``NotImplementedError`` naming its ROADMAP.md Queue 1 item: the
``cumsum`` sparse layout (item 14), ``mode="host"`` and the ``iterate``
runtime (item 15), checkpoint/resume (item 16), precision policies
(item 3), and meshes and sharding plans (item 7).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.kernels.segsum import segment_sum
from flinkml_tpu_torch.kernels.spmv import spmv
from flinkml_tpu_torch.ops.losses import margin_terms as _margin_grad
from flinkml_tpu_torch.parallel import pad_to_multiple

_LOSS_KEYS = ("logistic", "hinge", "squared")

#: Sparse gradient layouts ported so far (``cumsum`` is ROADMAP.md Queue 1
#: item 14).
SPARSE_LAYOUTS = ("unsorted", "sorted")
_SPARSE_ARGS_PER_BUCKET = {"unsorted": 4, "sorted": 6}

#: Steps the device loop runs between two host reads of its active flag.
SYNC_EVERY = 8

#: Devices the rows are split over: one until the mesh is ported.
_P_SIZE = 1

_UNPORTED = {
    "mesh": "item 7 (multi-device)",
    "sharding_plan": "item 7 (multi-device, sharding plans)",
    "precision": "item 3 (precision policies)",
    "checkpoint_manager": "item 16 (checkpoint/resume)",
    "resume": "item 16 (checkpoint/resume)",
    "cache_dir": "item 5 (streamed and out-of-core fits)",
    "cache_memory_budget_bytes": "item 5 (streamed and out-of-core fits)",
}


def refuse_unported(**knobs) -> None:
    """Raise ``NotImplementedError`` for the first knob that is set
    (not None/False) whose path the port does not have yet."""
    for name, value in knobs.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to flinkml_tpu_torch yet: "
                f"it comes with ROADMAP.md Queue 1 {_UNPORTED[name]}"
            )


def check_layout(layout: str) -> None:
    if layout == "cumsum":
        raise NotImplementedError(
            "the cumsum sparse layout is not ported to flinkml_tpu_torch "
            "yet: it comes with ROADMAP.md Queue 1 item 14 (cumsum sparse "
            f"layout); use one of {SPARSE_LAYOUTS}"
        )
    if layout not in SPARSE_LAYOUTS:
        raise ValueError(
            f"layout={layout!r}: expected one of {SPARSE_LAYOUTS}"
        )


def _soft_threshold(x, t):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def _acc_dt(dt: torch.dtype) -> torch.dtype:
    """Reduction dtype: sub-f32 data accumulates in f32."""
    return torch.float32 if dt.itemsize < 4 else dt


def align_local_bs(global_batch_size: int, p_size: int, n_local: int) -> int:
    """Per-device batch: ceil(global/p), clamped to the shard — the
    requested batch is honored exactly, no silent inflation."""
    return min(max(1, math.ceil(global_batch_size / p_size)), n_local)


def _window(arr: torch.Tensor, epoch: int, local_bs: int) -> torch.Tensor:
    """Contiguous rotating window with ceil coverage: the tail window is
    clamped to end at the last row, as ``dynamic_slice`` clamps it."""
    n = arr.shape[0]
    n_windows = max(-(-n // local_bs), 1)
    start = max(min((epoch % n_windows) * local_bs, n - local_bs), 0)
    return arr.narrow(0, start, local_bs)


def _prox_update(coef, grad, loss_sum, wsum, learning_rate, reg_l2, reg_l1):
    """L2 gradient term, step, L1 soft-threshold; returns ``(new_coef,
    mean loss)`` in the JAX package's operation order."""
    acc = _acc_dt(coef.dtype)
    grad = grad + 2.0 * reg_l2 * coef
    loss_sum = loss_sum + reg_l2 * torch.sum(torch.square(coef.to(acc)))
    step_size = learning_rate.to(acc) / wsum
    new_coef = _soft_threshold(
        coef - step_size.to(coef.dtype) * grad,
        step_size.to(coef.dtype) * reg_l1,
    )
    return new_coef, (loss_sum / wsum).to(coef.dtype)


def make_dense_step(loss: str, local_bs: int):
    """One epoch: window → ``x @ coef`` → margin terms → ``x.T @ mult`` →
    prox update. ``epoch`` is a host int (the window index)."""

    def step(coef, epoch, xl, yl, wl, learning_rate, reg_l2, reg_l1):
        xb = _window(xl, epoch, local_bs)
        yb = _window(yl, epoch, local_bs)
        wb = _window(wl, epoch, local_bs)
        acc = _acc_dt(xb.dtype)
        dot = torch.matmul(xb, coef)
        mult, per_ex = _margin_grad(loss, dot, yb, wb)
        grad = torch.matmul(xb.T, mult)
        loss_sum = torch.sum(per_ex.to(acc))
        wsum = torch.sum(wb.to(acc))
        return _prox_update(coef, grad, loss_sum, wsum, learning_rate,
                            reg_l2, reg_l1)

    return step


def make_sparse_step_bucketed(loss: str, local_bss: Tuple[int, ...],
                              dim: int, layout: str = "unsorted"):
    """nnz-bucketed sparse step: one window per bucket (sized in
    proportion to the bucket's rows, so every step sees a representative
    nnz mix), the ``spmv`` kernel for each bucket's margins, and the
    gradient by ``segment_sum``:

    - ``unsorted``: one atomic ``segment_sum`` over every bucket's cells;
    - ``sorted``: per bucket, the window's contributions permuted by the
      pack-time sort table (a plain ``index_select``, as the JAX package's
      ``jnp.take``) and one deterministic sorted ``segment_sum``.
    """
    check_layout(layout)
    per_bucket = _SPARSE_ARGS_PER_BUCKET[layout]

    def window_of(table2d, epoch):
        return table2d[epoch % table2d.shape[0]]

    def step(coef, epoch, blocks, learning_rate, reg_l2, reg_l1):
        acc = _acc_dt(coef.dtype)
        contribs, flat_idx = [], []
        grad = None
        loss_l = torch.zeros((), dtype=acc, device=coef.device)
        wsum_l = torch.zeros((), dtype=acc, device=coef.device)
        for b, local_bs in enumerate(local_bss):
            block = blocks[per_bucket * b: per_bucket * (b + 1)]
            ib, vb, yb, wb = (_window(a, epoch, local_bs) for a in block[:4])
            dot = spmv(ib, vb, coef)
            mult, per_ex = _margin_grad(loss, dot, yb, wb)
            contrib = (vb * mult[:, None]).reshape(-1)
            if layout == "sorted":
                part = segment_sum(
                    torch.index_select(contrib, 0, window_of(block[4], epoch)),
                    window_of(block[5], epoch), dim, indices_are_sorted=True,
                )
                grad = part if grad is None else grad + part
            else:
                contribs.append(contrib)
                flat_idx.append(ib.reshape(-1))
            loss_l = loss_l + torch.sum(per_ex.to(acc))
            wsum_l = wsum_l + torch.sum(wb.to(acc))
        if layout == "unsorted":
            grad = segment_sum(torch.cat(contribs), torch.cat(flat_idx), dim)
        return _prox_update(coef, grad, loss_l, wsum_l, learning_rate,
                            reg_l2, reg_l1)

    return step


def _device_loop(step: Callable, coef: torch.Tensor, epoch: int,
                 cur_loss: torch.Tensor, tol: torch.Tensor, epoch_end: int):
    """``lax.while_loop(ep < epoch_end and loss > tol)`` over
    ``step(coef, ep) -> (coef, loss)`` with the carry on the device.

    Every step is computed and kept only while the device flag ``active``
    holds; the host reads the flag every :data:`SYNC_EVERY` steps and stops
    when it is false. Once inactive the carry is frozen, so the flag stays
    false: the result is the ``while_loop``'s. The window index is the
    host's step count, which equals the device epoch while active.
    """
    ep = torch.tensor(epoch, dtype=torch.int32, device=coef.device)
    end = torch.tensor(epoch_end, dtype=torch.int32, device=coef.device)
    host_ep = epoch
    while host_ep < epoch_end:
        for _ in range(min(SYNC_EVERY, epoch_end - host_ep)):
            active = (ep < end) & (cur_loss > tol)
            new_coef, new_loss = step(coef, host_ep)
            coef = torch.where(active, new_coef, coef)
            cur_loss = torch.where(active, new_loss, cur_loss)
            ep = ep + active.to(torch.int32)
            host_ep += 1
        if not bool((ep < end) & (cur_loss > tol)):
            break
    return coef, ep, cur_loss


def _dense_trainer(loss: str, local_bs: int):
    """Whole-loop trainer ``(coef, epoch, loss, x, y, w, lr, l2, l1, tol,
    epoch_end) -> (coef, epoch, loss)``, the carry on the device."""
    local_step = make_dense_step(loss, local_bs)

    def trainer(coef, epoch, cur_loss, xl, yl, wl,
                learning_rate, reg_l2, reg_l1, tol, epoch_end):
        return _device_loop(
            lambda c, ep: local_step(c, ep, xl, yl, wl, learning_rate,
                                     reg_l2, reg_l1),
            coef, epoch, cur_loss, tol, epoch_end,
        )

    return trainer


def _sparse_trainer_bucketed(loss: str, local_bss: Tuple[int, ...],
                             dim: int, layout: str = "unsorted"):
    """Bucketed counterpart of :func:`_dense_trainer`: the data args are
    ``k·len(local_bss)`` tensors, ``k = 4`` (indices, values, y, w) for
    ``unsorted`` and 6 (plus the window sort tables) for ``sorted``."""
    local_step = make_sparse_step_bucketed(loss, local_bss, dim, layout)
    n_args = _SPARSE_ARGS_PER_BUCKET[layout] * len(local_bss)

    def trainer(coef, epoch, cur_loss, *rest):
        blocks = rest[:n_args]
        learning_rate, reg_l2, reg_l1, tol, epoch_end = rest[n_args:]
        return _device_loop(
            lambda c, ep: local_step(c, ep, blocks, learning_rate, reg_l2,
                                     reg_l1),
            coef, epoch, cur_loss, tol, epoch_end,
        )

    return trainer


def _run_chunked(trainer, data_args: Tuple, dim: int, dt: torch.dtype,
                 learning_rate: float, reg_l2: float, reg_l1: float,
                 tol: float, max_iter: int,
                 listeners: Sequence = ()) -> np.ndarray:
    """Drive a whole-loop trainer from epoch 0 to ``max_iter`` (or ``tol``)
    in one dispatch; returns the coefficient on the host. ``listeners``
    fire once, at the end (the K-epoch checkpointed chunks are ROADMAP.md
    Queue 1 item 16)."""
    device = data_args[0].device
    coef = torch.zeros(dim, dtype=dt, device=device)
    epoch, cur_loss = 0, float("inf")
    hy = tuple(torch.tensor(v, dtype=dt, device=device)
               for v in (learning_rate, reg_l2, reg_l1, tol))
    if epoch < max_iter and cur_loss > tol:
        coef, ep_dev, _ = trainer(
            coef, epoch, torch.tensor(cur_loss, dtype=dt, device=device),
            *data_args, *hy, max_iter,
        )
        epoch = int(ep_dev)
        coef_host = coef.cpu().numpy()
        for listener in listeners:
            listener.on_epoch_watermark_incremented(epoch - 1, coef_host)
    result = coef.cpu().numpy()
    for listener in listeners:
        listener.on_iteration_terminated(result)
    return result


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def train_linear_model(
    x: np.ndarray,
    y: np.ndarray,
    w: np.ndarray,
    loss: str,
    max_iter: int,
    learning_rate: float,
    global_batch_size: int,
    reg: float,
    elastic_net: float,
    tol: float,
    seed: int,
    dtype=None,
    listeners=(),
    checkpoint_manager=None,
    resume: bool = False,
    sharding_plan=None,
    precision=None,
) -> np.ndarray:
    """Dense training on the compute device; returns the coefficient on
    the host.

    ``reg``/``elastic_net`` follow the sklearn/Spark convention:
    l1 = reg * elastic_net, l2 = reg * (1 - elastic_net). Rows are
    shuffled on the host by ``np.random.default_rng(seed).permutation``,
    as in the JAX package. The compute dtype is ``dtype``, else ``x``'s
    floating dtype (float64 otherwise); ``y`` and ``w`` are cast to it.
    """
    refuse_unported(checkpoint_manager=checkpoint_manager, resume=resume,
                    sharding_plan=sharding_plan, precision=precision)
    if loss not in _LOSS_KEYS:
        raise ValueError(f"loss must be one of {_LOSS_KEYS}, got {loss!r}")
    n = x.shape[0]
    if n == 0:
        raise ValueError("training table is empty")
    if dtype is None:
        dtype = x.dtype if x.dtype.kind == "f" else np.float64
    x, y, w = (np.asarray(a, dtype=dtype) for a in (x, y, w))
    perm = np.random.default_rng(seed).permutation(n)
    x, y, w = x[perm], y[perm], w[perm]
    device = default_device()
    xd, yd, wd = (_upload(pad_to_multiple(a, _P_SIZE)[0], device)
                  for a in (x, y, w))
    local_bs = align_local_bs(global_batch_size, _P_SIZE,
                              xd.shape[0] // _P_SIZE)
    trainer = _dense_trainer(loss, local_bs)
    return _run_chunked(
        trainer, (xd, yd, wd), x.shape[1], xd.dtype,
        learning_rate, reg * (1.0 - elastic_net), reg * elastic_net,
        tol, max_iter, listeners=listeners,
    )


def _window_sort_tables(
    idx_pad: np.ndarray, p_size: int, local_bs: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-device, per-window scatter sort tables for the sorted layout:
    ``(perm, sorted_ids)``, each ``[p * n_windows, local_bs * width]``.

    Window w on a device covers local rows ``min(w·bs, n_local−bs) ..
    +bs`` — exactly :func:`_window`'s clamped rotating tile — and its
    flattened cells are argsorted by column id once here, so the step's
    ``segment_sum`` can take ``indices_are_sorted``.
    """
    n_total, width = idx_pad.shape
    n_local = n_total // p_size
    n_windows = max(-(-n_local // local_bs), 1)
    cells = local_bs * width
    perm = np.empty((p_size * n_windows, cells), np.int32)
    sids = np.empty((p_size * n_windows, cells), np.int32)
    for d in range(p_size):
        shard = idx_pad[d * n_local:(d + 1) * n_local]
        for wnum in range(n_windows):
            start = min(wnum * local_bs, max(n_local - local_bs, 0))
            flat = shard[start:start + local_bs].reshape(-1)
            order = np.argsort(flat, kind="stable").astype(np.int32)
            row = d * n_windows + wnum
            perm[row] = order
            sids[row] = flat[order]
    return perm, sids


def prepare_sparse_buckets(
    indptr, indices, values, dim: int, y, w, global_batch_size: int,
    max_buckets: int = 4, dtype=np.float32, seed: Optional[int] = None,
    layout: str = "unsorted",
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[int, ...]]:
    """Pack, shuffle, pad and upload CSR data for the bucketed trainer.

    Returns ``(data_args, local_bss)``: the flat per-bucket tensors on the
    compute device (indices, values, y, w[, window-sort perm, sorted ids]
    per bucket) and each bucket's window size (its proportional share of
    ``global_batch_size``, ≥ 1). ``seed`` shuffles rows within each bucket,
    with the JAX package's generator and order, so both packages train on
    the same windows. ``pack_ell_buckets`` refuses indices outside
    ``[0, dim)``, which the kernels trust.
    """
    from flinkml_tpu_torch.ops.sparse import pack_ell_buckets

    check_layout(layout)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.size - 1
    y = np.asarray(y, dtype=dtype)
    w = np.asarray(w, dtype=dtype)
    buckets, row_ids = pack_ell_buckets(
        indptr, indices, values, dim, max_buckets=max_buckets, dtype=dtype,
    )
    device = default_device()
    rng = np.random.default_rng(seed) if seed is not None else None
    data_args: list = []
    local_bss: list = []
    for bucket, rows in zip(buckets, row_ids):
        bi, bv = bucket["indices"], bucket["values"]
        if rng is not None:
            order = rng.permutation(rows.size)
            bi, bv, rows = bi[order], bv[order], rows[order]
        idx_pad, _ = pad_to_multiple(bi, _P_SIZE)
        padded = [idx_pad] + [pad_to_multiple(a, _P_SIZE)[0]
                              for a in (bv, y[rows], w[rows])]
        n_local = idx_pad.shape[0] // _P_SIZE
        share = max(1, math.ceil(global_batch_size * rows.size / (n * _P_SIZE)))
        local_bs = min(share, n_local)
        local_bss.append(local_bs)
        if layout == "sorted":
            padded += _window_sort_tables(idx_pad, _P_SIZE, local_bs)
        data_args += [_upload(a, device) for a in padded]
    return tuple(data_args), tuple(local_bss)


def train_linear_model_sparse_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    dim: int,
    y: np.ndarray,
    w: np.ndarray,
    loss: str,
    max_iter: int,
    learning_rate: float,
    global_batch_size: int,
    reg: float,
    elastic_net: float,
    tol: float,
    seed: int,
    max_buckets: int = 4,
    dtype=np.float32,
    listeners=(),
    layout: str = "unsorted",
    checkpoint_manager=None,
    resume: bool = False,
) -> np.ndarray:
    """Skew-proof sparse training from host CSR arrays: nnz-bucketed ELL
    blocks (padded cells ≈ total nnz), a stratified window from every
    bucket per step, and the gradient ``layout`` named by the caller
    (``"unsorted"``, the JAX package's default, or ``"sorted"``; the JAX
    package reads it from an env var or its tuning table)."""
    refuse_unported(checkpoint_manager=checkpoint_manager, resume=resume)
    if loss not in _LOSS_KEYS:
        raise ValueError(f"loss must be one of {_LOSS_KEYS}, got {loss!r}")
    n = np.asarray(indptr).size - 1
    if n == 0:
        raise ValueError("training table is empty")
    data_args, local_bss = prepare_sparse_buckets(
        indptr, indices, values, dim, y, w, global_batch_size,
        max_buckets=max_buckets, dtype=dtype, seed=seed, layout=layout,
    )
    trainer = _sparse_trainer_bucketed(loss, local_bss, int(dim), layout)
    return _run_chunked(
        trainer, data_args, int(dim), data_args[1].dtype,
        learning_rate, reg * (1.0 - elastic_net), reg * elastic_net,
        tol, max_iter, listeners=listeners,
    )
