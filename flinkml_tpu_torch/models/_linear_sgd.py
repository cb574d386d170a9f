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
  ``unsorted``), one sorted ``segment_sum`` per bucket over pack-time
  per-window sort tables (layout ``sorted``), or, per bucket, the
  column-sorted cells' contributions reduced by a chunked running sum
  differenced at pack-time run boundaries and one ``index_add_`` at the
  window's ascending columns (layout ``cumsum``: plain torch, as the JAX
  package computes it outside any Pallas kernel).
- **Softmax** (multinomial LR, dense only): the dense step's windows with
  a ``[k, d]`` model, ``x @ coef.T`` → ``log_softmax`` → weighted
  cross-entropy and ``(p - onehot)ᵀ @ x``, the same update and
  soft-threshold. Plain ``torch.matmul`` and ``torch.log_softmax``: the
  JAX package leaves this step to XLA.

**The device loop.** The JAX trainers run the whole epoch loop as one
``lax.while_loop`` on the device. Here the carry ``(coef, epoch, loss)``
stays on the device too: every step computes its candidate update, a
device-side flag ``active = (epoch < epoch_end) & (loss > tol)`` selects
it with ``torch.where`` and advances the epoch only while active, and the
host reads that flag once every :data:`SYNC_EVERY` steps. The result is
the ``while_loop``'s — the same epoch count and the same coefficients, at
any ``tol`` — with no host round trip per step.

**Checkpoints.** With a checkpoint manager and an interval K the device
loop runs in K-epoch dispatches; after each the carry ``(coef, loss)`` is
saved at its epoch and the listeners fire (:func:`_run_chunked`), and
``resume=True`` restores the newest valid carry and re-enters the same
loop, so the resumed trajectory is the uninterrupted one.

**Streamed fits** (:func:`train_linear_model_stream`, the
``ReplayOperator`` path): epoch 0 trains batch by batch while caching each
batch (spilling beyond a memory budget); later epochs replay the cache
through a :class:`~flinkml_tpu_torch.iteration.datacache.
PrefetchingDeviceFeed`. One SGD step per batch, the epoch's loss summed on
the device and read once per epoch. A sparse stream caches CSR and packs
each batch into uniform ELL of a power-of-two width; its step is the
``spmv`` kernel forward and one unsorted ``segment_sum`` kernel gradient.

The **sorted-column stream** (:func:`train_linear_model_sorted_stream`)
takes the prefetched tables of the input pipeline (``data/``): each
batch's ``SortedSparseColumn`` carries pack-time sort tables, so the step
is the ``spmv`` kernel forward and one sorted ``segment_sum`` kernel
gradient, in the JAX kernel's addition order. Epoch 0 keeps the device
tensors; later epochs replay them.

**Data parallel on a mesh.** ``mesh=`` (a :class:`~flinkml_tpu_torch.
parallel.DeviceMesh`) runs the in-RAM fits on every rank of the mesh:
each rank passes the same host data, pads it to the data axis P and keeps
its contiguous block of rows (per bucket for the sparse fit, with the
per-device window tables the JAX package builds for P devices), and each
step adds its local gradient, loss sum and weight sum into one flat
``[grad | loss_sum | wsum]`` buffer summed by one ``all_reduce`` (the JAX
step's three ``psum``s). Every rank then applies the same update and reads
the same loss, so every rank stops at the same epoch with the same bits.
A fit given no mesh issues no collective. A checkpointed fit on a mesh
records world P and resumes only at world P (the mesh's first rank
writes the snapshots).

**Streamed fits on a mesh** of several ranks (the JAX package's
multi-process streams): each rank feeds its own partition of the stream.
Pass 0 caches it without training and validates every batch, a failure
on one rank aborting every rank; the ranks then agree one padded local
height and one step count an epoch
(:class:`~flinkml_tpu_torch.iteration.stream_sync.SyncedReplayPlan`; a
sparse stream also one ELL width), and a short or empty rank feeds
zero-weight dummy steps. Each step sums its ``[grad | loss_sum | wsum]``
over the ranks in one ``all_reduce``, so every rank ends with the same
bits, which equal a one-process streamed fit whose step-t batch joins
every rank's batch t up to the order of float sums. The mesh's first
rank commits the snapshots into the shared directory, and every rank
agrees on the commit.

**Sharding plans and precision policies.** ``sharding_plan=`` (a
:class:`~flinkml_tpu_torch.sharding.plan.ShardingPlan`) and
``precision=`` (a :class:`~flinkml_tpu_torch.precision.PrecisionPolicy`
or preset name) route the dense in-RAM fit through the plan trainer
(:func:`flinkml_tpu_torch.sharding.apply.train_linear_plan`, momentum
SGD over the same seeded row order), as in the JAX package; a policy
without a plan runs under ``REPLICATED``. The sparse fits refuse both
with the JAX package's ``ValueError``.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.kernels.segsum import segment_sum
from flinkml_tpu_torch.kernels.spmv import spmv
from flinkml_tpu_torch.ops.losses import margin_terms as _margin_grad
from flinkml_tpu_torch.parallel.mesh import check_mesh, pad_to_multiple

_LOSS_KEYS = ("logistic", "hinge", "squared")

#: The sparse gradient layouts (the JAX package's three).
SPARSE_LAYOUTS = ("unsorted", "sorted", "cumsum")
_SPARSE_ARGS_PER_BUCKET = {"unsorted": 4, "sorted": 6, "cumsum": 8}

#: Steps the device loop runs between two host reads of its active flag.
SYNC_EVERY = 8

#: The one-process streamed fits' world (a mesh of several ranks takes
#: the multi-process streams).
_P_SIZE = 1


def p_size(mesh) -> int:
    """The ranks the rows are split over: the mesh's data axis, else 1."""
    return 1 if mesh is None else mesh.axis_size()


def multi_rank(mesh) -> bool:
    """True when ``mesh`` spans more than one rank of a process group."""
    return (mesh is not None and mesh.group(mesh.axis_names[0]) is not None
            and mesh.num_devices > 1)


def _reduce_terms(mesh, grad, loss_sum, wsum):
    """The step's ``(grad, loss_sum, wsum)`` summed over the mesh's data
    axis: one ``all_reduce`` of the flat buffer ``[grad | loss_sum |
    wsum]`` at the accumulation dtype (the JAX step's three ``psum``s).
    Without a mesh, or on a mesh without a process group, the terms come
    back untouched."""
    if mesh is None or mesh.group(mesh.DATA_AXIS) is None:
        return grad, loss_sum, wsum
    from flinkml_tpu_torch.parallel.collectives import all_reduce_

    acc = loss_sum.dtype
    n = grad.numel()
    buf = torch.cat([grad.reshape(-1).to(acc), loss_sum.reshape(1),
                     wsum.reshape(1)])
    all_reduce_(mesh, buf)
    return buf[:n].reshape(grad.shape).to(grad.dtype), buf[n], buf[n + 1]


def check_layout(layout: str) -> None:
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


def _prox_step(coef, grad, loss_sum, wsum, learning_rate, reg_l2, reg_l1):
    """L2 gradient term, step, L1 soft-threshold; returns ``(new_coef,
    loss_sum + L2 term, wsum)`` in the JAX package's operation order."""
    acc = _acc_dt(coef.dtype)
    grad = grad + 2.0 * reg_l2 * coef
    loss_sum = loss_sum + reg_l2 * torch.sum(torch.square(coef.to(acc)))
    step_size = learning_rate.to(acc) / wsum
    new_coef = _soft_threshold(
        coef - step_size.to(coef.dtype) * grad,
        step_size.to(coef.dtype) * reg_l1,
    )
    return new_coef, loss_sum, wsum


def _prox_update(coef, grad, loss_sum, wsum, learning_rate, reg_l2, reg_l1):
    """:func:`_prox_step` with the mean loss: ``(new_coef, mean loss)``."""
    new_coef, loss_sum, wsum = _prox_step(coef, grad, loss_sum, wsum,
                                          learning_rate, reg_l2, reg_l1)
    return new_coef, (loss_sum / wsum).to(coef.dtype)


def make_dense_step(loss: str, local_bs: int, mesh=None):
    """One epoch: window → ``x @ coef`` → margin terms → ``x.T @ mult`` →
    (over a mesh, :func:`_reduce_terms`) → prox update. ``epoch`` is a
    host int (the window index)."""

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
        return _prox_update(coef, *_reduce_terms(mesh, grad, loss_sum, wsum),
                            learning_rate, reg_l2, reg_l1)

    return step


def make_sparse_step_bucketed(loss: str, local_bss: Tuple[int, ...],
                              dim: int, layout: str = "unsorted", mesh=None):
    """nnz-bucketed sparse step: one window per bucket (sized in
    proportion to the bucket's rows, so every step sees a representative
    nnz mix), the ``spmv`` kernel for each bucket's margins, and the
    gradient by ``segment_sum``:

    - ``unsorted``: one atomic ``segment_sum`` over every bucket's cells;
    - ``sorted``: per bucket, the window's contributions permuted by the
      pack-time sort table (a plain ``index_select``, as the JAX package's
      ``jnp.take``) and one deterministic sorted ``segment_sum``;
    - ``cumsum``: per bucket, the window's cells come column-sorted with
      their values and rows (:func:`_window_cumsum_tables`), so the
      contributions are ``svals * mult[srows]``, the per-column totals
      :func:`~flinkml_tpu_torch.ops.sparse.chunked_run_totals` at the
      accumulation dtype, and the only scatter one ``index_add_`` at the
      ascending columns. Padding runs add exactly 0 onto the last real
      column, so no two adds race: the gradient is the same on every run,
      on the card too.

    Over a mesh the local terms are summed by :func:`_reduce_terms`
    before the update.
    """
    from flinkml_tpu_torch.ops.sparse import chunked_run_totals

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
            if layout == "sorted":
                contrib = (vb * mult[:, None]).reshape(-1)
                part = segment_sum(
                    torch.index_select(contrib, 0, window_of(block[4], epoch)),
                    window_of(block[5], epoch), dim, indices_are_sorted=True,
                )
                grad = part if grad is None else grad + part
            elif layout == "cumsum":
                srows, svals, ends, cols = (window_of(t, epoch)
                                            for t in block[4:])
                contrib = svals * torch.index_select(mult, 0, srows)
                seg = chunked_run_totals(contrib.to(acc), ends)
                if grad is None:
                    grad = torch.zeros(dim, dtype=coef.dtype,
                                       device=coef.device)
                grad.index_add_(0, cols, seg.to(coef.dtype))
            else:
                contribs.append((vb * mult[:, None]).reshape(-1))
                flat_idx.append(ib.reshape(-1))
            loss_l = loss_l + torch.sum(per_ex.to(acc))
            wsum_l = wsum_l + torch.sum(wb.to(acc))
        if layout == "unsorted":
            grad = segment_sum(torch.cat(contribs), torch.cat(flat_idx), dim)
        return _prox_update(coef, *_reduce_terms(mesh, grad, loss_l, wsum_l),
                            learning_rate, reg_l2, reg_l1)

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


def _dense_trainer(loss: str, local_bs: int, mesh=None):
    """Whole-loop trainer ``(coef, epoch, loss, x, y, w, lr, l2, l1, tol,
    epoch_end) -> (coef, epoch, loss)``, the carry on the device."""
    local_step = make_dense_step(loss, local_bs, mesh)

    def trainer(coef, epoch, cur_loss, xl, yl, wl,
                learning_rate, reg_l2, reg_l1, tol, epoch_end):
        return _device_loop(
            lambda c, ep: local_step(c, ep, xl, yl, wl, learning_rate,
                                     reg_l2, reg_l1),
            coef, epoch, cur_loss, tol, epoch_end,
        )

    return trainer


def _sparse_trainer_bucketed(loss: str, local_bss: Tuple[int, ...],
                             dim: int, layout: str = "unsorted", mesh=None):
    """Bucketed counterpart of :func:`_dense_trainer`: the data args are
    ``k·len(local_bss)`` tensors, ``k = 4`` (indices, values, y, w) for
    ``unsorted``, 6 (plus the window sort tables) for ``sorted`` and 8
    (plus the window's sorted rows, values, run ends and columns) for
    ``cumsum``."""
    local_step = make_sparse_step_bucketed(loss, local_bss, dim, layout, mesh)
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


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _restore_carry(checkpoint_manager, dim, dtype, mesh=None):
    """The newest valid ``(coef, loss)`` carry: ``(coef_host, epoch,
    loss)``, or None when there is no checkpoint. One definition for the
    chunked and the streamed paths, so their snapshot layout cannot
    diverge (the JAX package's: a ``(coef, float64 loss)`` tuple). Over a
    mesh of several ranks every rank restores, a failure on one aborts
    every rank, and the ranks must agree on the epoch."""
    from flinkml_tpu_torch.iteration.stream_sync import agreed_restore_latest

    like = (np.zeros(dim, dtype=np.dtype(dtype)), np.float64(0.0))
    mesh = mesh if multi_rank(mesh) else None
    restored = agreed_restore_latest(
        checkpoint_manager, like, mesh, "checkpoint restore (latest carry)"
    )
    if mesh is not None:
        _agree_same(-1 if restored is None else int(restored[1]), mesh,
                    "the restored checkpoint epoch")
    if restored is None:
        return None
    (coef_h, loss_h), epoch = restored
    return coef_h, int(epoch), float(loss_h)


def _agree_same(value: int, mesh, what: str) -> None:
    """Raise on every rank of ``mesh`` unless all ranks hold ``value``."""
    from flinkml_tpu_torch.iteration.stream_sync import (
        agree_all_ok,
        agree_max,
        agree_min,
    )

    agree_all_ok(agree_min(value, mesh) == agree_max(value, mesh), mesh,
                 f"{what} equal on every rank")


def _run_chunked(trainer, data_args: Tuple, dim, dt: torch.dtype,
                 learning_rate: float, reg_l2: float, reg_l1: float,
                 tol: float, max_iter: int, checkpoint_manager=None,
                 checkpoint_interval: int = 0, resume: bool = False,
                 listeners: Sequence = (), mesh=None) -> np.ndarray:
    """Drive a whole-loop trainer from epoch 0 (or the restored epoch) to
    ``max_iter`` (or ``tol``); returns the coefficient (shape ``dim``:
    ``d`` or ``(k, d)``) on the host.

    - No checkpoint manager (or interval 0): one dispatch runs the loop.
    - A manager and an interval K: each dispatch runs K epochs, then the
      carry ``(coef, loss)`` is saved at its epoch; ``resume=True``
      restores the newest valid carry and re-enters the same loop, so the
      resumed trajectory is the uninterrupted one. With a manager the
      terminal carry is always saved.
    - ``listeners`` fire after every dispatch (``epoch - 1`` and the
      coefficient on the host), then ``on_iteration_terminated``.
    - Over a ``mesh`` (the trainer's): the snapshots record world P (the
      mesh's size) and only the mesh's first rank writes them; a resume
      needs world P. With several ranks the loop holds the mesh's
      :func:`~flinkml_tpu_torch.parallel.dispatch.local_execution_lock`.
    """
    import contextlib

    from flinkml_tpu_torch.iteration.checkpoint import begin_resume
    from flinkml_tpu_torch.parallel.dispatch import local_execution_lock

    device = data_args[0].device
    world = 1 if mesh is None else mesh.num_devices
    writer = mesh is None or mesh.rank == mesh.device_ids[0]
    resume_epoch = begin_resume(checkpoint_manager, resume, world)
    if multi_rank(mesh) and checkpoint_manager is not None:
        _agree_same(-1 if resume_epoch is None else resume_epoch, mesh,
                    "the resume epoch")
    coef = torch.zeros(dim, dtype=dt, device=device)
    epoch, cur_loss = 0, float("inf")
    if resume_epoch is not None:
        restored = _restore_carry(checkpoint_manager, dim, _np_dtype(dt),
                                  mesh)
        if restored is not None:
            coef_h, epoch, cur_loss = restored
            coef = torch.from_numpy(np.ascontiguousarray(coef_h)).to(
                device=device, dtype=dt)
    chunk = (checkpoint_interval
             if checkpoint_manager is not None and checkpoint_interval > 0
             else max_iter)
    hy = tuple(torch.tensor(v, dtype=dt, device=device)
               for v in (learning_rate, reg_l2, reg_l1, tol))
    lock = (local_execution_lock(mesh) if multi_rank(mesh)
            else contextlib.nullcontext())
    with lock:
        while epoch < max_iter and cur_loss > tol:
            epoch_end = min(epoch + chunk, max_iter)
            coef, ep_dev, loss_dev = trainer(
                coef, epoch, torch.tensor(cur_loss, dtype=dt, device=device),
                *data_args, *hy, epoch_end,
            )
            epoch = int(ep_dev)
            cur_loss = float(loss_dev)
            coef_host = coef.cpu().numpy()
            if checkpoint_manager is not None and writer:
                checkpoint_manager.save((coef_host, np.float64(cur_loss)),
                                        epoch)
            for listener in listeners:
                listener.on_epoch_watermark_incremented(epoch - 1, coef_host)
    result = coef.cpu().numpy()
    if checkpoint_manager is not None:
        checkpoint_manager.wait()  # surface a failed final async write
        if multi_rank(mesh):
            # Every rank returns after the first rank's last commit.
            _agree_same(epoch, mesh, "the final checkpoint epoch")
    for listener in listeners:
        listener.on_iteration_terminated(result)
    return result


def shard_rows(mesh, arrays, device) -> Tuple[torch.Tensor, ...]:
    """Each host array padded to the mesh's data axis P with zero rows
    and this rank's block on the device (without a mesh: the whole array
    uploaded). Padded rows carry weight 0."""
    if mesh is None:
        return tuple(_upload(a, device) for a in arrays)
    p = mesh.axis_size()
    return tuple(mesh.shard_batch(pad_to_multiple(a, p)[0]) for a in arrays)


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
    checkpoint_interval: int = 0,
    resume: bool = False,
    sharding_plan=None,
    precision=None,
    mesh=None,
) -> np.ndarray:
    """Dense training on the compute device (over ``mesh``, data parallel
    on its ranks: module docstring); returns the coefficient on the host.

    ``reg``/``elastic_net`` follow the sklearn/Spark convention:
    l1 = reg * elastic_net, l2 = reg * (1 - elastic_net). Rows are
    shuffled on the host by ``np.random.default_rng(seed).permutation``,
    as in the JAX package. The compute dtype is ``dtype``, else ``x``'s
    floating dtype (float64 otherwise); ``y`` and ``w`` are cast to it.
    ``checkpoint_manager``/``checkpoint_interval``/``resume``: see
    :func:`_run_chunked`.

    ``sharding_plan`` and ``precision`` route the fit through
    :func:`~flinkml_tpu_torch.sharding.apply.train_linear_plan` (module
    docstring): a policy without a plan runs under ``REPLICATED``, a mesh
    without the plan's axes is rebuilt over the same ranks with
    :meth:`DeviceMesh.for_plan`, and listeners are refused.
    """
    check_mesh(mesh)
    if loss not in _LOSS_KEYS:
        raise ValueError(f"loss must be one of {_LOSS_KEYS}, got {loss!r}")
    n = x.shape[0]
    if n == 0:
        raise ValueError("training table is empty")
    if precision is not None and sharding_plan is None:
        from flinkml_tpu_torch.sharding.plan import REPLICATED

        sharding_plan = REPLICATED
    if sharding_plan is not None:
        return _train_plan_routed(
            x, y, w, loss, sharding_plan, mesh, seed, listeners,
            max_iter=max_iter, learning_rate=learning_rate,
            global_batch_size=global_batch_size, reg=reg,
            elastic_net=elastic_net, tol=tol, dtype=dtype,
            precision=precision, checkpoint_manager=checkpoint_manager,
            checkpoint_interval=checkpoint_interval, resume=resume)
    if dtype is None:
        dtype = x.dtype if x.dtype.kind == "f" else np.float64
    x, y, w = (np.asarray(a, dtype=dtype) for a in (x, y, w))
    perm = np.random.default_rng(seed).permutation(n)
    x, y, w = x[perm], y[perm], w[perm]
    device = default_device() if mesh is None else mesh.device
    xd, yd, wd = shard_rows(mesh, (x, y, w), device)
    local_bs = align_local_bs(global_batch_size, p_size(mesh), xd.shape[0])
    trainer = _dense_trainer(loss, local_bs, mesh)
    return _run_chunked(
        trainer, (xd, yd, wd), x.shape[1], xd.dtype,
        learning_rate, reg * (1.0 - elastic_net), reg * elastic_net,
        tol, max_iter, checkpoint_manager=checkpoint_manager,
        checkpoint_interval=checkpoint_interval, resume=resume,
        listeners=listeners, mesh=mesh,
    )


def _train_plan_routed(x, y, w, loss, plan, mesh, seed, listeners, **kw):
    """The JAX package's route from the dense fit into the plan trainer
    (``flinkml_tpu/models/_linear_sgd.py:596-621``)."""
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh
    from flinkml_tpu_torch.sharding.apply import train_linear_plan

    if listeners:
        raise ValueError(
            "listeners are not supported on the plan-sharded path"
        )
    if mesh is None:
        mesh = DeviceMesh.for_plan(plan)
    elif any(a not in mesh.shape for a in plan.required_axes()):
        mesh = DeviceMesh.for_plan(plan, devices=list(mesh.device_ids))
    perm = np.random.default_rng(seed).permutation(x.shape[0])
    return train_linear_plan(x[perm], np.asarray(y)[perm],
                             np.asarray(w)[perm], plan, mesh, loss=loss,
                             **kw)


def make_softmax_step(num_classes: int, local_bs: int, mesh=None):
    """Multinomial (softmax) step: logits ``x @ coef.T``, weighted
    cross-entropy, gradient ``(p - onehot)ᵀ @ x``; the model is a ``[k,
    d]`` matrix, with the binomial trainer's update (``coef -=
    lr/weightSum · grad``) and soft-threshold."""

    def step(coef, epoch, xl, yl, wl, learning_rate, reg_l2, reg_l1):
        xb = _window(xl, epoch, local_bs)
        yb = _window(yl, epoch, local_bs)
        wb = _window(wl, epoch, local_bs)
        acc = _acc_dt(xb.dtype)
        logits = torch.matmul(xb, coef.T)                     # [bs, k]
        logp = torch.log_softmax(logits, dim=-1)
        onehot = F.one_hot(yb.to(torch.int64), num_classes).to(xb.dtype)
        per_ex = -torch.sum(onehot * logp, dim=-1) * wb
        mult = (torch.exp(logp) - onehot) * wb[:, None]       # [bs, k]
        grad = torch.matmul(mult.T, xb)                       # [k, d]
        loss_sum = torch.sum(per_ex.to(acc))
        wsum = torch.sum(wb.to(acc))
        return _prox_update(coef, *_reduce_terms(mesh, grad, loss_sum, wsum),
                            learning_rate, reg_l2, reg_l1)

    return step


def _softmax_trainer(num_classes: int, local_bs: int, mesh=None):
    """Whole-loop softmax trainer, the contract of :func:`_dense_trainer`."""
    local_step = make_softmax_step(num_classes, local_bs, mesh)

    def trainer(coef, epoch, cur_loss, xl, yl, wl,
                learning_rate, reg_l2, reg_l1, tol, epoch_end):
        return _device_loop(
            lambda c, ep: local_step(c, ep, xl, yl, wl, learning_rate,
                                     reg_l2, reg_l1),
            coef, epoch, cur_loss, tol, epoch_end,
        )

    return trainer


def train_softmax_model(
    x: np.ndarray,
    y: np.ndarray,
    w: np.ndarray,
    num_classes: int,
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
    checkpoint_interval: int = 0,
    resume: bool = False,
    mesh=None,
) -> np.ndarray:
    """Multinomial logistic regression on the compute device (over
    ``mesh``, data parallel on its ranks): returns the coefficient ``[k,
    d]`` on the host. The machinery of
    :func:`train_linear_model` (the host shuffle, windowed batches, the
    device loop, proximal elastic net); the loss is weighted softmax
    cross-entropy over integer labels ``0..k-1``. The compute dtype is
    ``dtype``, else ``x``'s floating dtype (float64 otherwise)."""
    check_mesh(mesh)
    n = x.shape[0]
    if n == 0:
        raise ValueError("training table is empty")
    if dtype is None:
        dtype = x.dtype if x.dtype.kind == "f" else np.float64
    x, y, w = (np.asarray(a, dtype=dtype) for a in (x, y, w))
    perm = np.random.default_rng(seed).permutation(n)
    x, y, w = x[perm], y[perm], w[perm]
    device = default_device() if mesh is None else mesh.device
    xd, yd, wd = shard_rows(mesh, (x, y, w), device)
    local_bs = align_local_bs(global_batch_size, p_size(mesh), xd.shape[0])
    trainer = _softmax_trainer(int(num_classes), local_bs, mesh)
    return _run_chunked(
        trainer, (xd, yd, wd), (int(num_classes), x.shape[1]), xd.dtype,
        learning_rate, reg * (1.0 - elastic_net), reg * elastic_net,
        tol, max_iter, checkpoint_manager=checkpoint_manager,
        checkpoint_interval=checkpoint_interval, resume=resume,
        listeners=listeners, mesh=mesh,
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


def _window_cumsum_tables(
    idx_pad: np.ndarray, val_pad: np.ndarray, p_size: int, local_bs: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-device, per-window tables of the ``cumsum`` layout: ``(srows,
    svals, ends, cols)``, the JAX package's arrays bit for bit (the same
    loop and stable argsort).

    Window w covers rows ``min(w·bs, n_local−bs) .. +bs`` (exactly
    :func:`_window`'s clamped rotating tile). Its flattened cells are
    sorted by column id once here:

    - ``srows [p·n_windows, cells] int32``: the row within the window of
      each sorted cell (the step gathers ``mult`` by it);
    - ``svals [p·n_windows, cells]``: the cell values, sorted;
    - ``ends [p·n_windows, max_d] int32``: the inclusive cell index of
      each column run's last cell, padded by repeating the last real end
      (a running-sum difference of exactly 0);
    - ``cols [p·n_windows, max_d] int32``: each run's column id,
      ascending; padding repeats the last real column, so its exact zero
      lands there.

    ``max_d`` is the largest distinct-column count over every window.
    """
    n_total, width = idx_pad.shape
    n_local = n_total // p_size
    n_windows = max(-(-n_local // local_bs), 1)
    cells = local_bs * width
    srows = np.empty((p_size * n_windows, cells), np.int32)
    svals = np.empty((p_size * n_windows, cells), val_pad.dtype)
    per_window = []
    for d in range(p_size):
        ishard = idx_pad[d * n_local:(d + 1) * n_local]
        vshard = val_pad[d * n_local:(d + 1) * n_local]
        for wnum in range(n_windows):
            start = min(wnum * local_bs, max(n_local - local_bs, 0))
            flat_i = ishard[start:start + local_bs].reshape(-1)
            flat_v = vshard[start:start + local_bs].reshape(-1)
            order = np.argsort(flat_i, kind="stable")
            sids = flat_i[order]
            row = d * n_windows + wnum
            srows[row] = (order // width).astype(np.int32)
            svals[row] = flat_v[order]
            # Inclusive run ends: positions where the sorted id changes.
            is_end = np.empty(cells, np.bool_)
            is_end[:-1] = sids[:-1] != sids[1:]
            is_end[-1] = True
            e = np.nonzero(is_end)[0].astype(np.int32)
            per_window.append((row, e, sids[e]))
    max_d = max(e.size for _, e, _ in per_window)
    ends = np.full((p_size * n_windows, max_d), cells - 1, np.int32)
    cols = np.empty((p_size * n_windows, max_d), np.int32)
    for row, e, c in per_window:
        ends[row, : e.size] = e
        cols[row, : e.size] = c
        cols[row, e.size:] = c[-1] if c.size else 0
    return srows, svals, ends, cols


def prepare_sparse_buckets(
    indptr, indices, values, dim: int, y, w, global_batch_size: int,
    max_buckets: int = 4, dtype=np.float32, seed: Optional[int] = None,
    layout: str = "unsorted", mesh=None,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[int, ...]]:
    """Pack, shuffle, pad and upload CSR data for the bucketed trainer.

    Returns ``(data_args, local_bss)``: the flat per-bucket tensors on the
    compute device (indices, values, y, w, then the layout's tables: for
    ``sorted`` the window-sort perm and sorted ids, for ``cumsum`` the
    sorted rows, values, run ends and columns) and each bucket's window
    size (its proportional share of
    ``global_batch_size``, ≥ 1). ``seed`` shuffles rows within each bucket,
    with the JAX package's generator and order, so both packages train on
    the same windows. ``pack_ell_buckets`` refuses indices outside
    ``[0, dim)``, which the kernels trust.

    Over a ``mesh`` every bucket pads to the data axis P, the window
    tables are built for P devices (the JAX package's arrays), and each
    rank keeps its block of every array: its rows and its ``n_windows``
    table rows.
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
    device = default_device() if mesh is None else mesh.device
    p = p_size(mesh)
    rng = np.random.default_rng(seed) if seed is not None else None
    data_args: list = []
    local_bss: list = []
    for bucket, rows in zip(buckets, row_ids):
        bi, bv = bucket["indices"], bucket["values"]
        if rng is not None:
            order = rng.permutation(rows.size)
            bi, bv, rows = bi[order], bv[order], rows[order]
        padded = [pad_to_multiple(a, p)[0]
                  for a in (bi, bv, y[rows], w[rows])]
        n_local = padded[0].shape[0] // p
        share = max(1, math.ceil(global_batch_size * rows.size / (n * p)))
        local_bs = min(share, n_local)
        local_bss.append(local_bs)
        if layout == "sorted":
            padded += _window_sort_tables(padded[0], p, local_bs)
        elif layout == "cumsum":
            padded += _window_cumsum_tables(padded[0], padded[1], p,
                                            local_bs)
        # Each table has p·n_windows rows: the block is this rank's.
        data_args += [_upload(a, device) if mesh is None
                      else mesh.shard_batch(a) for a in padded]
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
    checkpoint_interval: int = 0,
    resume: bool = False,
    mesh=None,
) -> np.ndarray:
    """Skew-proof sparse training from host CSR arrays: nnz-bucketed ELL
    blocks (padded cells ≈ total nnz), a stratified window from every
    bucket per step, and the gradient ``layout`` named by the caller
    (``"unsorted"``, the JAX package's default, ``"sorted"`` or
    ``"cumsum"``; the JAX package reads it from an env var or its tuning
    table). Over ``mesh``, data parallel on its ranks (module
    docstring)."""
    check_mesh(mesh)
    if loss not in _LOSS_KEYS:
        raise ValueError(f"loss must be one of {_LOSS_KEYS}, got {loss!r}")
    n = np.asarray(indptr).size - 1
    if n == 0:
        raise ValueError("training table is empty")
    data_args, local_bss = prepare_sparse_buckets(
        indptr, indices, values, dim, y, w, global_batch_size,
        max_buckets=max_buckets, dtype=dtype, seed=seed, layout=layout,
        mesh=mesh,
    )
    trainer = _sparse_trainer_bucketed(loss, local_bss, int(dim), layout,
                                       mesh)
    return _run_chunked(
        trainer, data_args, int(dim), data_args[1].dtype,
        learning_rate, reg * (1.0 - elastic_net), reg * elastic_net,
        tol, max_iter, checkpoint_manager=checkpoint_manager,
        checkpoint_interval=checkpoint_interval, resume=resume,
        listeners=listeners, mesh=mesh,
    )


def train_linear_model_from_table(
    table,
    features_col: str,
    label_col: str,
    weight_col: Optional[str],
    label_check=None,
    sharding_plan=None,
    precision=None,
    **hyper,
) -> np.ndarray:
    """One in-RAM fit for every linear estimator: SparseVector columns take
    the nnz-bucketed CSR trainer, anything else the dense trainer (in the
    column's floating dtype, float64 otherwise). ``label_check(y)``
    validates labels on either branch; ``hyper`` passes to the trainers
    (loss, max_iter, ..., the checkpoint knobs). ``sharding_plan`` and
    ``precision`` route the dense branch through the plan trainer; the
    sparse branch refuses them (the JAX package's ``ValueError``)."""
    from flinkml_tpu_torch.models._data import (
        labeled_data,
        labeled_sparse_data,
        sparse_features,
    )

    if sparse_features(table, features_col) is not None:
        if sharding_plan is not None:
            raise ValueError(
                "sharding_plan supports the dense path only; the sparse "
                "trainer keeps its replicated [dim] model (shard a large "
                "sparse model's rows with flinkml_tpu_torch.embeddings."
                "EmbeddingTable instead)"
            )
        if precision is not None:
            raise ValueError(
                "precision supports the dense path only; the sparse "
                "trainer's gather/segment-sum kernels are not yet "
                "policy-gated"
            )
        indptr, indices, values, dim, y, w = labeled_sparse_data(
            table, features_col, label_col, weight_col
        )
        if label_check is not None:
            label_check(y)
        return train_linear_model_sparse_csr(
            indptr, indices, values, dim, y, w, **hyper
        )
    x, y, w = labeled_data(table, features_col, label_col, weight_col,
                           dtype=None)
    if x.shape[0] == 0:
        raise ValueError("training table is empty")
    if label_check is not None:
        label_check(y)
    return train_linear_model(x, y, w, sharding_plan=sharding_plan,
                              precision=precision, **hyper)


# ---------------------------------------------------------------------------
# Streamed / out-of-core training (the ReplayOperator path)
# ---------------------------------------------------------------------------


_ROUTE_EMPTY, _ROUTE_DENSE, _ROUTE_CSR, _ROUTE_SORTED = 0, 1, 2, 3


def _agree_route(kind: int, dim: int, held, mesh) -> Tuple[int, int]:
    """``(route, CSR dim)`` of a stream from its first batch: this rank's
    alone, or on a mesh of several ranks the one every rank with data
    found (a rank with none adopts it). A route or dim that differs
    between ranks, or a first batch that failed on one (``held``), raises
    on every rank; a stream empty everywhere raises."""
    if not multi_rank(mesh):
        if kind == _ROUTE_EMPTY:
            raise ValueError("training stream is empty")
        return kind, dim
    from flinkml_tpu_torch.iteration.stream_sync import (
        agree_all_ok,
        agree_max,
    )

    agreed, agreed_dim = agree_max(kind, mesh), agree_max(dim, mesh)
    ok = (held is None and kind in (_ROUTE_EMPTY, agreed)
          and dim in (0, agreed_dim))
    try:
        agree_all_ok(ok, mesh, "stream route agreement (dense, CSR or "
                     f"sorted; local {kind}/{dim}, global "
                     f"{agreed}/{agreed_dim})")
    except ValueError:
        if held is not None:
            raise held
        raise
    if agreed == _ROUTE_EMPTY:
        raise ValueError("training stream is empty on every process")
    return agreed, agreed_dim


def streamed_linear_fit(
    source,
    *,
    features_col: str,
    label_col: str,
    weight_col: Optional[str],
    label_check=None,
    **kwargs,
) -> np.ndarray:
    """The streamed fit of every linear estimator (binomial LR, LinearSVC,
    LinearRegression), over an iterable of batch Tables or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache` holding the
    given columns (or flat CSR batches), ``label_check`` applied on either
    branch; ``kwargs`` pass to :func:`train_linear_model_stream`.

    SparseVector feature columns take the sparse stream: batches are
    cached as CSR (O(nnz), at any ``dim``) and trained by the ``spmv`` and
    ``segment_sum`` kernels; a cache whose batches carry ``indptr``/
    ``indices``/``values``/``dim`` replays through the same stream (the
    resume route). A prefetched :class:`~flinkml_tpu_torch.data.Dataset`
    (or ElasticFeed) of SparseVector rows delivers
    :class:`~flinkml_tpu_torch.table.SortedSparseColumn` features, which
    take :func:`train_linear_model_sorted_stream` (the sorted
    ``segment_sum``).

    With a ``mesh`` of several ranks in ``kwargs`` the ranks agree the
    route from their first batches (dense, CSR or sorted; for CSR the
    dim), so that a rank whose partition is empty takes the same route
    and feeds only dummies; routes that disagree, or a first batch that
    fails on one rank, abort every rank. The sorted route has no
    multi-process form: agreed on several ranks, it raises on every rank
    (:func:`train_linear_model_sorted_stream`)."""
    from flinkml_tpu_torch.iteration.datacache import DataCache
    from flinkml_tpu_torch.models._data import (
        labeled_data,
        labeled_sparse_data,
        sparse_features,
    )
    from flinkml_tpu_torch.table import SortedSparseColumn, Table

    multi = multi_rank(kwargs.get("mesh"))
    if isinstance(source, DataCache):
        validate = None
        mem = source.mem_batches
        first = mem[0] if mem else next(iter(source.reader()), None)
        kind = (_ROUTE_EMPTY if first is None
                else _ROUTE_CSR if "indptr" in first else _ROUTE_DENSE)
        kind, dim0 = _agree_route(
            kind, int(np.asarray(first["dim"])[0, 0])
            if kind == _ROUTE_CSR else 0, None, kwargs.get("mesh"))
        if kind == _ROUTE_CSR:
            if label_check is not None:
                def validate(batch):
                    label_check(np.asarray(batch["y"])[0])

            return train_linear_model_stream(
                source, columns=("x", "y", "w"), validate=validate,
                sparse_dim=dim0, **kwargs,
            )
        if label_check is not None:
            def validate(batch):
                label_check(np.asarray(batch[label_col]))

        return train_linear_model_stream(
            source, columns=(features_col, label_col, weight_col),
            validate=validate, **kwargs,
        )

    it = iter(source)
    first_t, held, kind, dim0 = None, None, _ROUTE_EMPTY, 0
    try:
        first_t = next(it, None)
        if first_t is None:
            pass
        elif (isinstance(first_t, Table)
              and features_col in first_t.column_names
              and isinstance(first_t._raw_column(features_col),
                             SortedSparseColumn)):
            kind = _ROUTE_SORTED
        elif sparse_features(first_t, features_col) is not None:
            kind = _ROUTE_CSR
            dim0 = labeled_sparse_data(first_t, features_col, label_col,
                                       weight_col)[3]
        else:
            kind = _ROUTE_DENSE
    except Exception as e:  # noqa: BLE001 — agreed below on a mesh
        if not multi:
            raise
        held = e
    kind, dim0 = _agree_route(kind, dim0, held, kwargs.get("mesh"))
    tables = itertools.chain([] if first_t is None else [first_t], it)

    if kind == _ROUTE_SORTED:
        # A prefetched Dataset's sparse stream: train on the pack-time
        # sorted device tables — no host round trip, no sort at step time.
        return train_linear_model_sorted_stream(
            tables, features_col, label_col, weight_col,
            label_check=label_check, **kwargs,
        )

    if kind == _ROUTE_CSR:
        def sparse_batches():
            for t in tables:
                indptr, indices, values, d, y, w = labeled_sparse_data(
                    t, features_col, label_col, weight_col
                )
                if d != dim0:
                    raise ValueError(
                        f"stream batch feature dimension {d} != first "
                        f"batch's {dim0}"
                    )
                if label_check is not None:
                    label_check(y)
                # Each component one 2-D row: the cache wants equal row
                # counts per batch, and CSR components differ in length.
                yield {
                    "indptr": np.asarray(indptr)[None, :],
                    "indices": np.asarray(indices)[None, :],
                    "values": np.asarray(values)[None, :],
                    "y": np.asarray(y)[None, :],
                    "w": np.asarray(w)[None, :],
                    "dim": np.asarray([[d]], np.int64),
                }

        return train_linear_model_stream(
            sparse_batches(), sparse_dim=int(dim0), **kwargs
        )

    def batches():
        for t in tables:
            x, y, w = labeled_data(t, features_col, label_col, weight_col)
            if label_check is not None:
                label_check(y)
            yield {"x": x, "y": y, "w": w}

    return train_linear_model_stream(batches(), **kwargs)


def _stream_stepper(loss: str, mesh=None):
    """One SGD step over one streamed batch: ``(coef, x, y, w, lr, l2,
    l1) -> (coef, loss_sum, wsum)``, unnormalised, so the epoch's mean loss
    over batches of any size is summed on the device. Over a mesh of
    several ranks ``x, y, w`` are this rank's block of the step and the
    terms are summed over the ranks (:func:`_reduce_terms`) before the
    update."""

    def step(coef, xb, yb, wb, learning_rate, reg_l2, reg_l1):
        acc = _acc_dt(xb.dtype)
        dot = torch.matmul(xb, coef)
        mult, per_ex = _margin_grad(loss, dot, yb, wb)
        return _prox_step(coef, *_reduce_terms(
            mesh, torch.matmul(xb.T, mult), torch.sum(per_ex.to(acc)),
            torch.sum(wb.to(acc))), learning_rate, reg_l2, reg_l1)

    return step


def _sparse_stream_stepper(loss: str, dim: int, mesh=None):
    """Sparse sibling of :func:`_stream_stepper` over one padded-ELL batch
    ``(indices, values)``: the ``spmv`` kernel forward and one unsorted
    ``segment_sum`` kernel gradient into the dense ``[dim]`` coefficient
    (each batch's cells are seen once per epoch, in stream order, so no
    pack-time sort applies), summed over the ranks of a mesh as
    :func:`_stream_stepper` does. The streamed fits have this one layout,
    as in the JAX package: neither ``sorted`` nor ``cumsum`` windows exist
    there."""

    def step(coef, ib, vb, yb, wb, learning_rate, reg_l2, reg_l1):
        acc = _acc_dt(vb.dtype)
        dot = spmv(ib, vb, coef)
        mult, per_ex = _margin_grad(loss, dot, yb, wb)
        contrib = (vb * mult[:, None]).reshape(-1)
        grad = segment_sum(contrib, ib.reshape(-1), dim)
        return _prox_step(coef, *_reduce_terms(
            mesh, grad, torch.sum(per_ex.to(acc)), torch.sum(wb.to(acc))),
            learning_rate, reg_l2, reg_l1)

    return step


def _sorted_column_stepper(loss: str, dim: int):
    """One SGD step over a prefetched :class:`~flinkml_tpu_torch.table.
    SortedSparseColumn` batch (``flinkml_tpu.models._linear_sgd.
    _sorted_column_stepper``): the ``spmv`` kernel forward over the padded
    ELL block, then the gradient scatter replays the pack-time sort —
    ``segment_sum(contrib.index_select(0, perm), segment_ids, dim,
    indices_are_sorted=True)``, the sorted ``segment_sum`` kernel — so the
    step sorts nothing. ``wb`` comes masked to the batch's logical rows
    (weight 0 on the row bucket's padding: an exact zero in the gradient,
    the loss and the weight sum). Its layout is the column's own; the
    ``cumsum`` layout has no streamed form, in the JAX package either."""

    def step(coef, ib, vb, perm, seg, yb, wb, learning_rate, reg_l2,
             reg_l1):
        acc = _acc_dt(vb.dtype)
        dot = spmv(ib, vb, coef)
        mult, per_ex = _margin_grad(loss, dot, yb, wb)
        contrib = (vb * mult[:, None]).reshape(-1)
        grad = segment_sum(contrib.index_select(0, perm), seg, dim,
                           indices_are_sorted=True)
        return _prox_step(coef, grad, torch.sum(per_ex.to(acc)),
                          torch.sum(wb.to(acc)), learning_rate, reg_l2,
                          reg_l1)

    return step


def _padded_tensor(raw) -> torch.Tensor:
    """A column's bucket-height buffer (a prefetched padded column) or the
    column itself as a tensor."""
    if hasattr(raw, "buf"):
        return raw.buf
    if torch.is_tensor(raw):
        return raw
    return torch.from_numpy(np.ascontiguousarray(raw))


def train_linear_model_sorted_stream(
    tables,
    features_col: str,
    label_col: str,
    weight_col: Optional[str] = None,
    *,
    loss: str,
    max_iter: int,
    learning_rate: float,
    reg: float,
    elastic_net: float,
    tol: float,
    label_check=None,
    listeners=(),
    dtype=np.float32,
    cache_dir=None,
    memory_budget_bytes=None,
    checkpoint_manager=None,
    checkpoint_interval: int = 0,
    resume: bool = False,
    prefetch_depth: int = 2,
    validate=None,
    mesh=None,
) -> np.ndarray:
    """Train a linear model from a stream of device-resident Tables whose
    feature column is a :class:`~flinkml_tpu_torch.table.
    SortedSparseColumn` (what a :class:`~flinkml_tpu_torch.data.prefetch.
    DevicePrefetcher` emits for ``SparseVector`` rows): the fit never
    densifies and never sorts at step time (:func:`_sorted_column_stepper`).

    Epoch 0 trains batch by batch while keeping each batch's device
    tensors; later epochs replay them — the batches are already on the
    card (O(nnz) each), so ``cache_dir``, ``memory_budget_bytes`` and
    ``prefetch_depth`` are accepted for call compatibility and unused, as
    in the JAX package. A ``mesh`` of one rank is accepted and unused; a
    mesh of several ranks raises ``ValueError`` on every rank (the JAX
    package ignores it there, and each rank would train its own
    partition alone): the column's sort tables index the whole batch's
    cells and do not split by rows, so such a fit streams CSR batches
    (``sparse_dim=``) instead. The first pass reads each batch's labels (for
    ``label_check``) and weight sum back to the host, as the JAX package
    does; later epochs read only the epoch's loss. Checkpoint/resume is
    refused with ``ValueError``, as in the JAX package: stream CSR batches
    through :func:`train_linear_model_stream` (``sparse_dim=...``) for a
    durable fit."""
    del cache_dir, memory_budget_bytes, prefetch_depth
    from flinkml_tpu_torch.iteration.runtime import TerminateOnMaxIterOrTol
    from flinkml_tpu_torch.table import SortedSparseColumn

    if loss not in _LOSS_KEYS:
        raise ValueError(f"loss must be one of {_LOSS_KEYS}, got {loss!r}")
    if multi_rank(mesh):
        raise ValueError(
            "the sorted-column stream (a prefetched Dataset or "
            "ElasticFeed of SparseVector rows) trains on one rank: on a "
            "mesh of several ranks, stream CSR batches instead (SparseVector "
            "Tables without the DevicePrefetcher, or flat CSR batches with "
            "sparse_dim=)"
        )
    if checkpoint_manager is not None or resume or checkpoint_interval:
        raise ValueError(
            "checkpoint/resume is not supported on the sorted-column "
            "stream path; use the CSR stream (sparse_dim=...) for "
            "durable fits"
        )
    dt = torch.from_numpy(np.zeros(0, dtype)).dtype
    criterion = TerminateOnMaxIterOrTol(max_iter, tol)
    step = None
    coef = None
    hy = None
    dim = None
    cache = []  # each batch's step arguments, on the device

    def prepare(t):
        """The first pass over one Table: its checks and step arguments."""
        nonlocal step, coef, hy, dim
        col = t._raw_column(features_col)
        if not isinstance(col, SortedSparseColumn):
            raise ValueError(
                f"sorted-column stream: feature column {features_col!r} "
                "is not a SortedSparseColumn (feed the stream through "
                "data.prefetch.DevicePrefetcher)"
            )
        device = col.buf.device
        if dim is None:
            dim = col.dim
            step = _sorted_column_stepper(loss, dim)
            coef = torch.zeros(dim, dtype=dt, device=device)
            hy = _stream_hypers(learning_rate, reg, elastic_net, dt, device)
        elif col.dim != dim:
            raise ValueError(
                f"stream batch feature dimension {col.dim} != first "
                f"batch's {dim}"
            )
        bucket, n = col.buf.shape[0], col.rows
        yb = _padded_tensor(t._raw_column(label_col)).to(device)
        if label_check is not None:
            label_check(yb[:n].cpu().numpy())
        if weight_col is not None and weight_col in t.column_names:
            wb = _padded_tensor(t._raw_column(weight_col)).to(device)
        else:
            wb = torch.ones(bucket, dtype=dt, device=device)
        if validate is not None:
            validate(t)
        if n == 0 or float(wb[:n].sum()) == 0:
            raise _zero_weight_error()
        # The row bucket's padding gets weight 0 (the JAX step masks by
        # its traced n_valid): once here, not in every epoch's step.
        wb = wb.to(dt).clone()
        wb[n:] = 0
        return (col.indices, col.buf.to(dt), col.perm, col.segment_ids,
                yb.to(dt), wb)

    def run_epoch(batches, first_pass: bool) -> float:
        """One pass; returns the epoch's mean loss (the loss sums stay on
        the device until the epoch's one conversion)."""
        nonlocal coef
        loss_acc = wsum_acc = None
        n_batches = 0
        for item in batches:
            if first_pass:
                item = prepare(item)
                cache.append(item)
            coef, ls, ws = step(coef, *item, *hy)
            loss_acc = ls if loss_acc is None else loss_acc + ls
            wsum_acc = ws if wsum_acc is None else wsum_acc + ws
            n_batches += 1
        if n_batches == 0:
            raise ValueError("training stream is empty")
        return float(loss_acc) / float(wsum_acc)

    def after_epoch(epoch):
        if listeners:
            coef_host = coef.cpu().numpy()
            for listener in listeners:
                listener.on_epoch_watermark_incremented(epoch - 1, coef_host)

    cur_loss = run_epoch(tables, True)
    epoch = 1
    after_epoch(epoch)
    while not criterion.should_terminate(epoch - 1, cur_loss):
        cur_loss = run_epoch(cache, False)
        epoch += 1
        after_epoch(epoch)

    result = coef.cpu().numpy()
    for listener in listeners:
        listener.on_iteration_terminated(result)
    return result


def _ell_width_for(max_nnz: int) -> int:
    """A batch's max nnz rounded up to a power of two, so the stream's
    nnz variation maps to a log-bounded set of widths."""
    return 1 << max(int(max_nnz) - 1, 0).bit_length()


def _check_csr_structure(indptr, indices, sparse_dim: int):
    """Structural CSR validation of a streamed batch; returns ``nnz =
    diff(indptr)``. A non-monotone indptr would fail inside the ELL fill,
    and an out-of-range column index would reach the ``spmv`` gather,
    which does not clamp: both are refused here, on the first pass."""
    nnz = np.diff(indptr)
    if indptr.size == 0 or indptr[0] != 0 or np.any(nnz < 0):
        raise ValueError(
            "invalid CSR batch: indptr must start at 0 and be "
            "non-decreasing"
        )
    if indices.size and (
        int(indices.min()) < 0 or int(indices.max()) >= sparse_dim
    ):
        raise ValueError(
            "invalid CSR batch: column indices must lie in "
            f"[0, {sparse_dim}); got range "
            f"[{int(indices.min())}, {int(indices.max())}]"
        )
    return nnz


def _pack_uniform_ell(indptr, indices, values, dtype, width=None):
    """One CSR batch as uniform ELL of width :func:`_ell_width_for` (or
    ``width``); padding cells carry index 0 / value 0 (exact no-ops)."""
    from flinkml_tpu_torch.ops.sparse import fill_ell

    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.size - 1
    nnz = np.diff(indptr)
    if width is None:
        width = _ell_width_for(np.max(nnz, initial=1))
    bi = np.zeros((n, width), dtype=np.int32)
    bv = np.zeros((n, width), dtype=dtype)
    fill_ell(bi, bv, indptr[:-1], nnz, indices, values)
    return bi, bv


_DUMMY_BATCH = {"_dummy": True}


def _zero_weight_error() -> ValueError:
    # The step divides by the batch's weight sum: an inf step size would
    # silently NaN the model.
    return ValueError(
        "stream batch has zero total weight (empty batch or all weights "
        "0); drop such batches before training"
    )


def _run_multiprocess_stream_epochs(cache, plan, place, step, dim, hy, dt,
                                    device, criterion, checkpoint_manager,
                                    checkpoint_interval, listeners,
                                    prefetch_depth, mesh, coef, epoch,
                                    cur_loss, after_first_epoch=None):
    """The epochs of the multi-process streams, dense and sparse: each
    replays the local cache on the agreed schedule (``plan``, dummies
    after the local batches) through a :class:`~flinkml_tpu_torch.
    iteration.datacache.PrefetchingDeviceFeed`, one step a batch with the
    in-flight work bounded by a :class:`~flinkml_tpu_torch.parallel.
    dispatch.DispatchGuard`; then the listeners, the agreed commit
    (:func:`~flinkml_tpu_torch.iteration.checkpoint.save_replicated`) and,
    at the end, the wait for the last write and
    ``on_iteration_terminated``. Returns the coefficient on the host."""
    from flinkml_tpu_torch.iteration.checkpoint import save_replicated
    from flinkml_tpu_torch.iteration.datacache import PrefetchingDeviceFeed
    from flinkml_tpu_torch.parallel.dispatch import DispatchGuard

    guard = DispatchGuard()

    def run_epoch(coef):
        loss_acc = torch.zeros((), dtype=dt, device=device)
        wsum_acc = torch.zeros((), dtype=dt, device=device)
        feed = PrefetchingDeviceFeed(
            plan.epoch_batches(cache.reader(), lambda: _DUMMY_BATCH),
            place=place, depth=prefetch_depth)
        try:
            for tensors in feed:
                if coef is None:
                    coef = torch.zeros(dim, dtype=dt, device=device)
                coef, ls, ws = step(coef, *tensors, *hy)
                loss_acc = loss_acc + ls
                wsum_acc = wsum_acc + ws
                coef = guard.after_dispatch(coef)
        finally:
            feed.close()
        coef = guard.flush(coef)
        return coef, float(loss_acc) / float(wsum_acc)

    while not (epoch > 0 and criterion.should_terminate(epoch - 1, cur_loss)):
        coef, cur_loss = run_epoch(coef)
        epoch += 1
        if after_first_epoch is not None:
            after_first_epoch()
        coef_host = coef.cpu().numpy()
        for listener in listeners:
            listener.on_epoch_watermark_incremented(epoch - 1, coef_host)
        terminated = criterion.should_terminate(epoch - 1, cur_loss)
        if checkpoint_manager is not None and (
                terminated or (checkpoint_interval > 0
                               and epoch % checkpoint_interval == 0)):
            save_replicated(checkpoint_manager,
                            (coef_host, np.float64(cur_loss)), epoch, mesh)
    result = coef.cpu().numpy()
    if checkpoint_manager is not None:
        checkpoint_manager.wait()  # surface a failed final async write
    for listener in listeners:
        listener.on_iteration_terminated(result)
    return result


def _ingest(batches, is_cache: bool, check, cache_dir, memory_budget_bytes,
            mesh, what: str):
    """Pass 0 of a multi-process stream: ``check`` every batch, caching a
    one-shot stream (a sealed cache is read once). The source's and the
    check's failures, the cache writer's too, are held and agreed on every
    rank before any planning collective (the rank's own error re-raises
    there). Returns the sealed cache."""
    from flinkml_tpu_torch.iteration.datacache import DataCacheWriter
    from flinkml_tpu_torch.iteration.stream_sync import (
        DeferredValidation,
        checked_ingest,
    )

    dv = DeferredValidation()
    if is_cache:
        cache = batches
        for _ in checked_ingest(cache.reader(), dv, check, multi=True):
            pass
    else:
        writer = DataCacheWriter(cache_dir, memory_budget_bytes)

        def checked_append(b):
            check(b)
            writer.append({k: np.array(v) for k, v in b.items()})

        for _ in checked_ingest(batches, dv, checked_append, multi=True):
            pass
        cache = writer.finish()
    dv.rendezvous(mesh, what)
    return cache


def _restored_stream_carry(checkpoint_manager, resume_epoch, dim, dtype,
                          dt, device, mesh=None):
    """``(coef or None, epoch, loss)`` to start a stream from: the newest
    snapshot when resuming (on a mesh of several ranks, the agreed
    restore), else a fresh start."""
    if resume_epoch is not None:
        restored = _restore_carry(checkpoint_manager, dim, dtype, mesh)
        if restored is not None:
            coef_h, epoch, cur_loss = restored
            return (torch.from_numpy(np.ascontiguousarray(coef_h)).to(
                device=device, dtype=dt), epoch, cur_loss)
    return None, 0, math.inf


def _batch_weights(batch, key, n: int, dtype) -> np.ndarray:
    """A dense batch's weight column, or unit weights."""
    if key is not None and key in batch:
        return np.asarray(batch[key], dtype=dtype)
    return np.ones(n, dtype=dtype)


def _stream_batch_check(dtype, columns, validate, sparse_dim):
    """``check(batch) -> (rows, width)``: the checks of one streamed
    batch, on its first pass (a cached batch cannot change), for the
    one-process and the multi-process streams alike. A dense batch: the
    ``[n, d]`` shape, one ``d`` for the stream (``width`` is ``d``) and its
    label column; a flat CSR batch (``sparse_dim``): its dim, components
    of one length, the CSR structure (:func:`_check_csr_structure`) and
    label/weight rows (``width`` is its ELL width, :func:`_ell_width_for`).
    Then ``validate`` and a non-zero weight sum."""
    x_key, y_key, w_key = columns
    first_dim = [None]

    def check_dense(b):
        x = np.asarray(b[x_key])  # no copy: the placement converts it
        np.asarray(b[y_key])  # a missing label column raises
        if x.ndim != 2:
            raise ValueError(f"stream batches must be [n, d], got {x.shape}")
        if first_dim[0] is None:
            first_dim[0] = x.shape[1]
        elif x.shape[1] != first_dim[0]:
            raise ValueError(
                f"batch feature dim {x.shape[1]} != first batch's "
                f"{first_dim[0]}"
            )
        if validate is not None:
            validate(b)
        n = x.shape[0]
        if n == 0 or float(_batch_weights(b, w_key, n, dtype).sum()) == 0.0:
            raise _zero_weight_error()
        return n, x.shape[1]

    def check_sparse(b):
        indptr = np.asarray(b["indptr"])[0]
        n = indptr.size - 1
        d = int(np.asarray(b["dim"]).reshape(-1)[0])
        if d != sparse_dim:
            raise ValueError(
                f"CSR stream batch has dim {d}, expected {sparse_dim}"
            )
        indices = np.asarray(b["indices"])[0]
        values = np.asarray(b["values"])[0]
        if indices.shape != values.shape or indices.size != int(indptr[-1]):
            raise ValueError(
                "ragged CSR batch: indices/values/indptr disagree"
            )
        nnz = _check_csr_structure(indptr, indices, sparse_dim)
        y = np.asarray(b["y"])[0]
        w = np.asarray(b["w"])[0] if "w" in b else np.ones(n, dtype=dtype)
        if y.shape[0] != n or w.shape[0] != n:
            raise ValueError("ragged CSR batch: y/w rows != indptr rows")
        if validate is not None:
            validate(b)
        if n == 0 or float(w.sum()) == 0.0:
            raise _zero_weight_error()
        return n, _ell_width_for(np.max(nnz, initial=1))

    return check_dense if sparse_dim is None else check_sparse


def _stream_placer(dtype, device, columns, sparse_dim, height=None,
                   width=None, dim=None):
    """``place(batch)``: one streamed batch's step tensors on ``device``
    (dense ``x, y, w``; sparse ELL ``indices, values, y, w``). Alone a
    batch keeps its rows and, sparse, its own ELL width. On several ranks
    (``height``) every step is one ``[height, width]`` block: the batch
    padded with weight-0 rows at the agreed ELL ``width`` (dense: the
    agreed feature ``dim``), and the schedule's dummy batch all padding
    (index 0, value 0, weight 0)."""
    from flinkml_tpu_torch.iteration.datacache import device_put
    from flinkml_tpu_torch.iteration.stream_sync import pad_rows_to

    x_key, y_key, w_key = columns

    def padded(arrays):
        if height is None:
            return arrays
        return tuple(pad_rows_to(a, height) for a in arrays)

    def place_dense(batch):
        if "_dummy" in batch:
            arrays = (np.zeros((0, dim), dtype), np.zeros(0, dtype),
                      np.zeros(0, dtype))
        else:
            x = np.asarray(batch[x_key], dtype=dtype)
            arrays = (x, np.asarray(batch[y_key], dtype=dtype),
                      _batch_weights(batch, w_key, x.shape[0], dtype))
        return device_put(padded(arrays), device)

    def place_sparse(batch):
        if "_dummy" in batch:
            arrays = (np.zeros((0, width), np.int32),
                      np.zeros((0, width), dtype), np.zeros(0, dtype),
                      np.zeros(0, dtype))
        else:
            indptr = np.asarray(batch["indptr"])[0]
            n = indptr.size - 1
            bi, bv = _pack_uniform_ell(
                indptr, np.asarray(batch["indices"])[0],
                np.asarray(batch["values"])[0], dtype, width=width)
            arrays = (bi, bv, np.asarray(batch["y"])[0].astype(dtype),
                      np.asarray(batch["w"])[0].astype(dtype)
                      if "w" in batch else np.ones(n, dtype=dtype))
        return device_put(padded(arrays), device)

    return place_dense if sparse_dim is None else place_sparse


def _stream_hypers(learning_rate, reg, elastic_net, dt, device):
    """``(learning_rate, l2, l1)`` as device scalars of the step's dtype."""
    return tuple(torch.tensor(v, dtype=dt, device=device) for v in (
        learning_rate, reg * (1.0 - elastic_net), reg * elastic_net))


def _train_linear_stream_multiprocess(
    batches, loss, mesh, max_iter, learning_rate, reg, elastic_net, tol,
    cache_dir, memory_budget_bytes, checkpoint_manager, checkpoint_interval,
    resume, listeners, prefetch_depth, dtype, columns, validate, sparse_dim,
) -> np.ndarray:
    """The stream on a mesh of several ranks (the module docstring's
    "Streamed fits on a mesh"), dense or flat CSR (``sparse_dim``): pass 0
    caches this rank's partition and checks every batch
    (:func:`_stream_batch_check`); the ranks agree the schedule (the most
    batches of any rank, the tallest batch rounded up to 8 rows), the
    feature dim and, sparse, one ELL width (the widest power-of-two width
    of any rank's batches), so that every rank's step is one ``[height,
    width]`` block (:func:`_stream_placer`): sparse, the ``spmv`` kernel,
    the unsorted ``segment_sum`` kernel, then one ``all_reduce``."""
    from flinkml_tpu_torch.iteration.checkpoint import begin_resume
    from flinkml_tpu_torch.iteration.datacache import DataCache
    from flinkml_tpu_torch.iteration.runtime import TerminateOnMaxIterOrTol
    from flinkml_tpu_torch.iteration.stream_sync import (
        SyncedReplayPlan,
        agree_all_ok,
        agree_feature_dim,
        agree_max,
        round_up,
    )

    resume_epoch = begin_resume(checkpoint_manager, resume, mesh.num_devices)
    check_batch = _stream_batch_check(dtype, columns, validate, sparse_dim)
    local = [0, 0]  # this rank's tallest batch, its widest (dense: its dim)

    def check(b):
        n, width = check_batch(b)
        local[0], local[1] = max(local[0], n), max(local[1], width)

    cache = _ingest(batches, isinstance(batches, DataCache), check,
                    cache_dir, memory_budget_bytes, mesh,
                    "stream ingest validation")
    steps = agree_max(cache.num_batches, mesh)
    if steps == 0:
        raise ValueError("training stream is empty on every process")
    plan = SyncedReplayPlan(
        global_steps=steps,
        local_height=agree_max(round_up(max(local[0], 1), 8), mesh),
        mesh=mesh)
    if sparse_dim is None:
        dim = agree_feature_dim(cache, columns[0], mesh, local_dim=local[1])
        width = None
        step = _stream_stepper(loss, mesh)
    else:
        # Ranks fed partitions of different feature spaces would train
        # coefficients of different shapes and hang in the collectives.
        dim = int(sparse_dim)
        agree_all_ok(agree_max(dim, mesh) == dim, mesh,
                     "sparse stream feature-dimension agreement")
        width = agree_max(max(local[1], 1), mesh)
        step = _sparse_stream_stepper(loss, dim, mesh)
    device = mesh.device
    place = _stream_placer(dtype, device, columns, sparse_dim,
                           plan.local_height, width, dim)
    dt = torch.from_numpy(np.zeros(0, dtype)).dtype
    coef, epoch, cur_loss = _restored_stream_carry(
        checkpoint_manager, resume_epoch, dim, dtype, dt, device, mesh)
    return _run_multiprocess_stream_epochs(
        cache, plan, place, step, dim,
        _stream_hypers(learning_rate, reg, elastic_net, dt, device), dt,
        device, TerminateOnMaxIterOrTol(max_iter, tol), checkpoint_manager,
        checkpoint_interval, listeners, prefetch_depth, mesh, coef, epoch,
        cur_loss)


def train_linear_model_stream(
    batches,
    loss: str,
    max_iter: int,
    learning_rate: float,
    reg: float,
    elastic_net: float,
    tol: float,
    cache_dir: Optional[str] = None,
    memory_budget_bytes: Optional[int] = None,
    checkpoint_manager=None,
    checkpoint_interval: int = 0,
    resume: bool = False,
    listeners=(),
    prefetch_depth: int = 2,
    dtype=np.float32,
    columns: Tuple[str, str, Optional[str]] = ("x", "y", "w"),
    validate=None,
    sparse_dim: Optional[int] = None,
    mesh=None,
) -> np.ndarray:
    """Train from a one-shot stream of batches, datasets larger than RAM
    included (reference: ``ReplayOperator.java:62-250``).

    - ``batches``: an iterable of ``{x: [n, d], y: [n], w: [n]}`` numpy
      dicts (keys named by ``columns``; no weight key means unit weights),
      one global mini-batch each, or a sealed
      :class:`~flinkml_tpu_torch.iteration.datacache.DataCache` of them
      (no caching pass; ``resume=True`` needs one: a one-shot stream
      cannot be replayed after a failure);
    - ``sparse_dim``: each batch is a flat CSR dict (``indptr``,
      ``indices``, ``values``, ``y``, optional ``w``, ``dim``, each one 2-D
      row), cached as CSR, packed per batch into uniform ELL
      (:func:`_pack_uniform_ell`) and trained by the ``spmv`` and
      ``segment_sum`` kernels;
    - epoch 0 trains while appending each batch to a cache that spills
      beyond ``memory_budget_bytes`` to ``cache_dir``; later epochs replay
      it through a :class:`~flinkml_tpu_torch.iteration.datacache.
      PrefetchingDeviceFeed`. Spilled and in-RAM replay give the same
      bits;
    - each batch trains at its own row count (the JAX package pads it
      with weight-0 rows to its mesh's row tile, which adds exact zeros:
      eager PyTorch compiles nothing per shape); the batch checks
      (:func:`_stream_batch_check`: shapes, the CSR structure,
      ``validate(batch)``, the zero-weight check) run on the first pass
      only (a cached batch cannot change), which is also the first pass
      over a caller's cache;
    - termination: ``TerminateOnMaxIterOrTol(max_iter, tol)`` on the
      weighted epoch-mean loss, summed on the device and read once per
      epoch; a manager saves ``(coef, loss)`` every ``checkpoint_interval``
      epochs and always at the end;
    - ``mesh`` of several ranks: each rank passes its own partition, and
      the multi-process stream runs (the module docstring's "Streamed fits
      on a mesh"; pass 0 caches without training, the ranks share the
      checkpoint directory). Without one, the stream trains here alone.
    """
    from flinkml_tpu_torch.iteration.checkpoint import begin_resume
    from flinkml_tpu_torch.iteration.datacache import (
        DataCache,
        DataCacheWriter,
        PrefetchingDeviceFeed,
    )
    from flinkml_tpu_torch.iteration.runtime import TerminateOnMaxIterOrTol

    if loss not in _LOSS_KEYS:
        raise ValueError(f"loss must be one of {_LOSS_KEYS}, got {loss!r}")
    is_cache = isinstance(batches, DataCache)
    if resume and not is_cache:
        raise ValueError(
            "resume=True requires a durable DataCache input: a one-shot "
            "stream cannot be replayed from the start after a failure"
        )
    check_mesh(mesh)
    if multi_rank(mesh):
        return _train_linear_stream_multiprocess(
            batches, loss, mesh, max_iter, learning_rate, reg, elastic_net,
            tol, cache_dir, memory_budget_bytes, checkpoint_manager,
            checkpoint_interval, resume, listeners, prefetch_depth, dtype,
            columns, validate, sparse_dim)
    resume_epoch = begin_resume(checkpoint_manager, resume, _P_SIZE)
    device = default_device() if mesh is None else mesh.device
    dt = torch.from_numpy(np.zeros(0, dtype)).dtype
    step = (_sparse_stream_stepper(loss, int(sparse_dim))
            if sparse_dim is not None else _stream_stepper(loss))
    check = _stream_batch_check(dtype, columns, validate, sparse_dim)
    place_batch = _stream_placer(dtype, device, columns, sparse_dim)
    # Batches are immutable once cached: the input checks need the first
    # pass only, not max_iter re-scans on the feed's thread.
    first_pass_done = False

    def place(batch):
        if not first_pass_done:
            check(batch)
        return place_batch(batch)

    hy = _stream_hypers(learning_rate, reg, elastic_net, dt, device)
    criterion = TerminateOnMaxIterOrTol(max_iter, tol)
    coef = None
    epoch = 0  # epochs completed
    cur_loss = math.inf

    def run_epoch(device_batches, coef):
        """One pass; returns ``(coef, epoch mean loss)``. The loss sums
        stay on the device until the epoch's one conversion."""
        loss_acc = torch.zeros((), dtype=dt, device=device)
        wsum_acc = torch.zeros((), dtype=dt, device=device)
        n_batches = 0
        for tensors in device_batches:
            if coef is None:
                d0 = (sparse_dim if sparse_dim is not None
                      else tensors[0].shape[1])
                coef = torch.zeros(int(d0), dtype=dt, device=device)
            coef, ls, ws = step(coef, *tensors, *hy)
            loss_acc = loss_acc + ls
            wsum_acc = wsum_acc + ws
            n_batches += 1
        if n_batches == 0:
            raise ValueError("training stream is empty")
        return coef, float(loss_acc) / float(wsum_acc)

    def after_epoch(terminated: bool):
        """Listeners and the checkpoint, after ``epoch`` has advanced; with
        a manager the terminal carry is always saved."""
        nonlocal first_pass_done
        first_pass_done = True
        save = checkpoint_manager is not None and (
            terminated
            or (checkpoint_interval > 0 and epoch % checkpoint_interval == 0))
        if not (listeners or save):
            return
        coef_host = coef.cpu().numpy()
        for listener in listeners:
            listener.on_epoch_watermark_incremented(epoch - 1, coef_host)
        if save:
            checkpoint_manager.save((coef_host, np.float64(cur_loss)), epoch)

    def feed(source):
        return PrefetchingDeviceFeed(source, place=place,
                                     depth=prefetch_depth)

    if is_cache:
        cache = batches
        if resume_epoch is not None:
            dim = (int(sparse_dim) if sparse_dim is not None
                   else np.asarray(next(iter(cache.reader()))[columns[0]])
                   .shape[1])
            coef, epoch, cur_loss = _restored_stream_carry(
                checkpoint_manager, resume_epoch, dim, dtype, dt, device)
    else:
        writer = DataCacheWriter(cache_dir, memory_budget_bytes)

        def caching_iter():
            for b in batches:
                # A copy: the writer freezes RAM batches, which must not
                # leak onto the caller's buffers.
                writer.append({k: np.array(v) for k, v in b.items()})
                yield b

        feed0 = feed(caching_iter())
        try:
            coef, cur_loss = run_epoch(feed0, coef)
        finally:
            feed0.close()
        cache = writer.finish()
        epoch = 1
        after_epoch(criterion.should_terminate(0, cur_loss))

    while not (epoch > 0 and criterion.should_terminate(epoch - 1, cur_loss)):
        replay_feed = feed(cache.reader())
        try:
            coef, cur_loss = run_epoch(replay_feed, coef)
        finally:
            replay_feed.close()
        epoch += 1
        after_epoch(criterion.should_terminate(epoch - 1, cur_loss))

    result = coef.cpu().numpy()
    if checkpoint_manager is not None:
        checkpoint_manager.wait()  # surface a failed final async write
    for listener in listeners:
        listener.on_iteration_terminated(result)
    return result
