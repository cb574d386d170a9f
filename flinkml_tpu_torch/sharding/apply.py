"""Threading a :class:`ShardingPlan` through the linear trainer.

The port's counterpart of ``flinkml_tpu.sharding.apply``. The JAX
package jits one step whose in/out shardings come from the plan and lets
GSPMD insert the collectives; here every rank runs the step on its own
blocks and issues the collectives itself:

- **State.** ``coef`` and the optimizer state (SGD momentum; Adam ``m``
  and ``v``; Adam's scalar ``step`` is replicated) shard as the plan
  says: under ``FSDP`` (and ``FSDP_TP``, whose spec truncates to
  ``("fsdp",)`` for a vector) rank ``i`` along ``fsdp`` keeps block ``i``
  of ``dim / fsdp`` elements, the block ``NamedSharding`` gives device
  ``i``. :func:`shard_state` returns DTensors placed per the plan on the
  mesh's torch ``DeviceMesh`` (plain tensors without a process group);
  the step works on their local blocks.
- **The step.** All-gather ``coef`` over the plan's shard axes; the
  margin and the gradient on this rank's rows of the window; ONE
  ``all_reduce`` of the flat buffer ``[grad | loss_sum | wsum]`` at the
  accumulation dtype over the group of the plan's batch axes (their
  product: under ``FSDP_TP`` the ``tp`` ranks hold the same rows and sit
  in different groups, so no row counts twice); then each rank updates
  its own blocks. The JAX program's pair is an all-gather and a
  reduce-scatter; an all-reduce followed by a slice gives the same
  numbers and is the collective checked with gloo on CUDA tensors.
- **Windows.** A clamped window of ``global_batch_size`` rows that
  rotates with the epoch and depends on nothing else, padded to the
  plan's batch world with zero-weight rows; rank ``b`` (row-major over
  the batch axes) keeps block ``b``, the block ``NamedSharding`` over the
  batch axes gives it. Each rank's blocks of each window are uploaded
  once and stay on the device.
- **Mixed precision.** Under a policy that narrows compute (``mixed``),
  the batch and ``coef`` are rounded to ``policy.compute`` at the step
  boundary and multiplied at ``policy.accum``: the rounded values are
  cast back up (exactly) and the products run at float32, where the
  JAX step asks ``matmul`` for a float32 accumulator
  (``preferred_element_type``), which ``torch.matmul`` of two bfloat16
  tensors does not give. The sums equal JAX's up to summation order. The
  state and its updates stay at the storage dtype, and the all-reduce
  runs at ``policy.accum``.
- **Checks before any step.** The FML5xx pass
  (:func:`validate_plan`) and, under a policy, the FML6xx trainer rules
  from the step's declared widths (:func:`validate_linear_precision`).
- **Checkpoints.** Snapshots hold the assembled global state with
  plan-derived layout tags (``save(..., plan=plan)``); the mesh's first
  rank writes them, and a snapshot taken at one world resumes at another
  under ``rescale="reshard"``.

- **Faults, preemption and the sentinel.** Each epoch of
  :func:`train_linear_plan` fires the ``rank.lost`` fault seam and polls
  the ambient :class:`~flinkml_tpu_torch.utils.preemption.
  PreemptionWatchdog` (a stop there commits a terminal snapshot), fires
  ``train.step`` before and after its step, and runs ``sentinel`` (a
  :class:`~flinkml_tpu_torch.recovery.NumericsSentinel`) over each rank's
  blocks of the state and the loss; the verdict is one int32 all-reduced
  (MAX) over the mesh before its one read, so every rank raises together.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.ops.losses import margin_terms
from flinkml_tpu_torch.precision import TORCH_DTYPES, float_name
from flinkml_tpu_torch.sharding.plan import (
    ShardingPlan,
    entry_axes,
    layouts_for,
    state_names,
)
from flinkml_tpu_torch.utils.logging import get_logger

_log = get_logger("sharding")

_NUMPY_FLOATS = ("float16", "float32", "float64")


class PlanValidationError(ValueError):
    """A :class:`ShardingPlan` failed FML5xx validation against its mesh,
    raised before any step, carrying the rendered findings."""


def validate_plan(plan: ShardingPlan, mesh,
                  param_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                  hbm_budget_bytes: Optional[int] = None,
                  dtype_bytes: int = 4,
                  optimizer_slots: int = 1) -> None:
    """Run the FML5xx pass; raise :class:`PlanValidationError` on any
    error."""
    from flinkml_tpu_torch.analysis.sharding_check import check_plan

    findings = check_plan(
        plan, mesh, param_shapes=param_shapes,
        hbm_budget_bytes=hbm_budget_bytes, dtype_bytes=dtype_bytes,
        optimizer_slots=optimizer_slots,
    )
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        raise PlanValidationError(
            f"sharding plan {plan.name!r} failed validation against the "
            "mesh:\n" + "\n".join(f.render() for f in errors)
        )


# -- placement ---------------------------------------------------------------


def _ndim(leaf) -> int:
    shape = getattr(leaf, "shape", None)
    return len(shape) if shape is not None else int(np.ndim(leaf))


def state_shardings(plan: ShardingPlan, mesh, state):
    """The placements of every leaf of ``state`` (one ``Shard(d)`` or
    ``Replicate()`` per mesh dimension), as a tree shaped like
    ``state``; leaf names follow :func:`~flinkml_tpu_torch.sharding.plan.
    state_names`."""
    from flinkml_tpu_torch.sharding.plan import _map_named

    return _map_named(
        lambda name, leaf: plan.partition_spec(name, mesh, ndim=_ndim(leaf)),
        state)


def batch_sharding(plan: ShardingPlan, mesh):
    """The placements of a batch: leading dim over the plan's batch
    axes."""
    return plan.batch_partition_spec(mesh)


def batch_world(plan: ShardingPlan, mesh) -> int:
    """The product of the plan's batch-axis sizes: what a batch's row
    count must divide (padded with zero-weight rows otherwise)."""
    n = 1
    for axis in plan.batch_axes:
        n *= int(mesh.shape[axis])
    return n


def _local_block(plan: ShardingPlan, mesh, name: str, value: torch.Tensor):
    """This rank's block of a global value under the plan: each sharded
    dim split evenly over its axes' product, this rank's row-major index
    over them picking the block."""
    out = value
    for d, entry in enumerate(plan.spec_for(name, ndim=value.dim())):
        axes = entry_axes(entry)
        if not axes:
            continue
        parts = int(np.prod([mesh.axis_size(a) for a in axes]))
        size = out.shape[d] // parts
        out = out.narrow(d, mesh.coordinate_of(axes) * size, size)
    return out


def shard_state(plan: ShardingPlan, mesh, state):
    """Every leaf of ``state`` placed per the plan on ``mesh``'s device:
    with a process group a DTensor on the mesh's torch ``DeviceMesh``
    whose local tensor is this rank's block; without one the whole value
    as a plain tensor. Every rank passes the same global ``state``."""
    from flinkml_tpu_torch.sharding.plan import _map_named

    grouped = mesh is not None and mesh.mesh is not None
    device = mesh.device if mesh is not None else None

    def place(name, leaf):
        t = torch.as_tensor(leaf).to(device) if device is not None \
            else torch.as_tensor(leaf)
        if not grouped:
            return t
        from torch.distributed.tensor import DTensor

        local = _local_block(plan, mesh, name, t).contiguous()
        return DTensor.from_local(
            local, mesh.mesh, plan.partition_spec(name, mesh, ndim=t.dim()),
            run_check=False, shape=t.shape, stride=t.stride())

    return _map_named(place, state)


# -- the linear family ---------------------------------------------------------


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return TORCH_DTYPES[float_name(dtype)]


def init_linear_state(dim: int, optimizer: str, dtype) -> Dict[str, Any]:
    """The parameter + optimizer-state tree of the linear family: SGD
    carries a same-shaped ``momentum``, Adam ``m``/``v`` and the scalar
    ``step``. Host numpy arrays (CPU tensors for bfloat16, which numpy
    lacks)."""
    name = float_name(dtype)
    if name in _NUMPY_FLOATS:
        zeros = np.zeros(int(dim), dtype=np.dtype(name))
        scalar = np.zeros((), dtype=np.dtype(name))
        copy = np.copy
    else:
        zeros = torch.zeros(int(dim), dtype=TORCH_DTYPES[name])
        scalar = torch.zeros((), dtype=TORCH_DTYPES[name])
        copy = torch.clone
    if optimizer == "sgd":
        return {"coef": zeros, "momentum": copy(zeros)}
    if optimizer == "adam":
        return {"coef": zeros, "m": copy(zeros), "v": copy(zeros),
                "step": scalar}
    raise ValueError(f"optimizer must be 'sgd' or 'adam', got {optimizer!r}")


def _soft_threshold(x, t):
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - t, 0.0)


def _round_to(t: torch.Tensor, dt: torch.dtype, up: torch.dtype):
    """``t`` rounded to ``dt`` and cast back up to ``up`` (exact)."""
    return t.to(dt).to(up)


class _PlanSync:
    """The collectives of one rank's plan step: gather ``coef`` over its
    shard axes, sum the step's terms over the batch axes, and cut this
    rank's block of a full-length vector."""

    def __init__(self, plan: ShardingPlan, mesh, dim: int):
        self.mesh = mesh
        self.coef_axes = plan.param_axes("coef", ndim=1)
        self.parts = int(np.prod([mesh.axis_size(a) for a in self.coef_axes]))
        self.block = dim // self.parts
        self.start = mesh.coordinate_of(self.coef_axes) * self.block
        self.gather_group, gather_ranks = mesh.group_over(self.coef_axes)
        self.reduce_group, reduce_ranks = mesh.group_over(plan.batch_axes)
        self.gather_ranks = gather_ranks
        self.reduce_ranks = reduce_ranks
        self.counts = {"all_gather": 0, "all_reduce": 0}

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full vector from every rank's block along the shard axes,
        placed by block index."""
        if self.gather_group is None:
            return local
        import torch.distributed as dist

        from flinkml_tpu_torch.parallel.dispatch import (
            record_collective_dispatch,
        )

        record_collective_dispatch("all_gather", self.gather_ranks,
                                   ("all_gather",))
        parts = [torch.empty_like(local) for _ in self.gather_ranks]
        dist.all_gather(parts, local.contiguous(), group=self.gather_group)
        self.counts["all_gather"] += 1
        by_rank = dict(zip(dist.get_process_group_ranks(self.gather_group),
                           parts))
        return torch.cat([by_rank[r] for r in self.gather_ranks])

    def reduce(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` summed in place over the batch axes' group."""
        if self.reduce_group is None:
            return buf
        import torch.distributed as dist

        from flinkml_tpu_torch.parallel.dispatch import (
            record_collective_dispatch,
        )

        record_collective_dispatch("all_reduce", self.reduce_ranks,
                                   ("all_reduce",))
        dist.all_reduce(buf, group=self.reduce_group)
        self.counts["all_reduce"] += 1
        return buf

    def local(self, full: torch.Tensor) -> torch.Tensor:
        if self.parts == 1:
            return full
        return full.narrow(0, self.start, self.block)


class LinearStep:
    """The ``(state, xb, yb, wb) -> (new_state, loss)`` step of the linear
    family, the one definition behind the plan trainer and its FML6xx
    check. ``state`` holds this rank's blocks and ``xb``/``yb``/``wb``
    its rows of the window when ``sync`` (a :class:`_PlanSync`) is given,
    the whole values otherwise.

    ``dtype_name`` is the storage dtype of the state and the batch.
    ``policy`` (a :class:`~flinkml_tpu_torch.precision.PrecisionPolicy`,
    preset name, or None) turns on the mixed-precision step when it
    narrows compute below params (module docstring). The step does not
    second-guess a mis-declared combination: :attr:`widths` declares
    where the step rounds, which :func:`validate_linear_precision`
    checks."""

    def __init__(self, loss: str, optimizer: str, dtype_name: str,
                 learning_rate: float, momentum: float, reg_l2: float,
                 reg_l1: float, policy=None):
        from flinkml_tpu_torch.precision import resolve_policy

        if loss not in ("logistic", "hinge", "squared"):
            raise ValueError(f"unsupported loss {loss!r}")
        if optimizer not in ("sgd", "adam"):
            raise ValueError(
                f"optimizer must be 'sgd' or 'adam', got {optimizer!r}")
        self.loss, self.optimizer = loss, optimizer
        self.dt = _torch_dtype(dtype_name)
        self.hyper = (float(learning_rate), float(momentum), float(reg_l2),
                      float(reg_l1))
        self.policy = resolve_policy(policy)
        self.mixed = self.policy is not None and self.policy.mixed
        self._consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    @property
    def accum_dtype(self) -> torch.dtype:
        """The dtype of the cross-rank sum: ``policy.accum`` under a
        policy, else the storage dtype (float32 below it)."""
        if self.policy is not None:
            return self.policy.accum_dtype
        return torch.float32 if self.dt.itemsize < 4 else self.dt

    @property
    def widths(self) -> Dict[str, Dict[str, torch.dtype]]:
        """Where the step rounds: the stored ``state`` leaves, every
        ``accumulations`` site and the collective's dtype (the
        declared widths :func:`validate_linear_precision` checks)."""
        leaves = (("coef", "momentum") if self.optimizer == "sgd"
                  else ("coef", "m", "step", "v"))
        dot = self.policy.accum_dtype if self.mixed else self.dt
        return {
            "state": {name: self.dt for name in leaves},
            "accumulations": {"dot_general": dot, "reduce_sum": self.dt,
                              "update": self.dt},
            "collective": self.accum_dtype,
        }

    def prepare_batch(self, xb: torch.Tensor) -> torch.Tensor:
        """The batch as the step multiplies it: under a mixed policy
        rounded to ``policy.compute`` and cast back up to the accumulation
        dtype (done once for a cached window; the same numbers as the
        JAX step's cast at every step)."""
        if self.mixed:
            return _round_to(xb, self.policy.compute_dtype,
                             self.policy.accum_dtype)
        return xb

    def _constants(self, device):
        consts = self._consts.get(device)
        if consts is None:
            consts = tuple(torch.tensor(v, dtype=self.dt, device=device)
                           for v in self.hyper)
            self._consts[device] = consts
        return consts

    def __call__(self, state, xb, yb, wb, sync: Optional[_PlanSync] = None,
                 prepared: bool = False):
        dt = self.dt
        lr, mom, l2, l1 = self._constants(xb.device)
        coef = state["coef"] if sync is None else sync.gather(state["coef"])
        if self.mixed:
            adt = self.policy.accum_dtype
            cdt = self.policy.compute_dtype
            xc = xb if prepared else self.prepare_batch(xb)
            dot = torch.matmul(xc, _round_to(coef, cdt, adt))
        else:
            dot = torch.matmul(xb, coef)
        mult, per_ex = margin_terms(self.loss, dot, yb, wb)
        if self.mixed:
            raw = torch.matmul(xc.T, _round_to(mult, cdt, adt))
        else:
            raw = torch.matmul(xb.T, mult)
        n = raw.numel()
        buf = torch.cat([raw.to(self.accum_dtype),
                         torch.sum(per_ex).to(self.accum_dtype).reshape(1),
                         torch.sum(wb).to(self.accum_dtype).reshape(1)])
        if sync is not None:
            sync.reduce(buf)
        raw = buf[:n].to(dot.dtype)
        loss_sum = buf[n].to(per_ex.dtype)
        wsum = torch.clamp_min(buf[n + 1].to(dt), 1e-12)
        grad = raw / wsum + 2.0 * l2 * coef
        grad = grad.to(dt)
        local_grad = grad if sync is None else sync.local(grad)
        own = state["coef"]
        if self.optimizer == "sgd":
            new_buf = mom * state["momentum"] + local_grad
            new_coef = _soft_threshold(own - lr * new_buf, lr * l1)
            new_state = {"coef": new_coef, "momentum": new_buf}
        else:
            t = state["step"] + 1.0
            b1, b2, eps = 0.9, 0.999, 1e-8
            m = b1 * state["m"] + (1.0 - b1) * local_grad
            v = b2 * state["v"] + (1.0 - b2) * local_grad * local_grad
            update = (m / (1.0 - b1 ** t)) / (
                torch.sqrt(v / (1.0 - b2 ** t)) + eps
            )
            new_coef = _soft_threshold(own - lr * update, lr * l1)
            new_state = {"coef": new_coef, "m": m, "v": v, "step": t}
        loss_val = (loss_sum + l2 * torch.sum(torch.square(coef))) / wsum
        return new_state, loss_val


def linear_step_fn(loss: str, optimizer: str, dtype_name: str,
                   learning_rate: float, momentum: float,
                   reg_l2: float, reg_l1: float, policy=None) -> LinearStep:
    """The step of the linear family (:class:`LinearStep`)."""
    return LinearStep(loss, optimizer, dtype_name, learning_rate, momentum,
                      reg_l2, reg_l1, policy=policy)


def validate_linear_precision(policy, step: LinearStep, dim: int, rows: int,
                              dt, optimizer: str, plan=None,
                              program: str = "linear_step") -> None:
    """The FML6xx gate of a linear step, before any step: the step's
    declared widths against ``policy`` (FML601/603/604), plus FML605 when
    ``plan`` is given and its budget width (the storage ``dt``) is not
    ``policy.params``'s. Raises
    :class:`~flinkml_tpu_torch.precision.PrecisionValidationError`
    carrying the findings. ``dim`` and ``rows`` are the shapes the JAX
    package traces; the widths do not depend on them."""
    from flinkml_tpu_torch.precision import (
        check_policy_plan,
        check_trainer_widths,
        raise_findings,
        resolve_policy,
    )

    policy = resolve_policy(policy)
    width = _torch_dtype(dt)
    extra = check_policy_plan(
        policy, dtype_bytes=width.itemsize,
        plan_name=getattr(plan, "name", None),
    ) if plan is not None else []
    widths = step.widths
    state = {name: width for name in widths["state"]}
    findings = list(extra) + check_trainer_widths(
        policy, state, widths["accumulations"],
        collectives=(("all_reduce", widths["collective"], None),),
        program=program)
    raise_findings(findings, program, policy)


def _host_value(t) -> np.ndarray:
    """A tensor's value on the host, bfloat16 as float32 (numpy has no
    bfloat16)."""
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def train_linear_plan(
    x: np.ndarray,
    y: np.ndarray,
    w: Optional[np.ndarray],
    plan: ShardingPlan,
    mesh=None,
    *,
    loss: str = "logistic",
    optimizer: str = "sgd",
    max_iter: int = 100,
    learning_rate: float = 0.1,
    momentum: float = 0.9,
    global_batch_size: Optional[int] = None,
    reg: float = 0.0,
    elastic_net: float = 0.0,
    tol: float = 0.0,
    dtype=None,
    precision=None,
    hbm_budget_bytes: Optional[int] = None,
    checkpoint_manager=None,
    checkpoint_interval: int = 0,
    resume: bool = False,
    sentinel=None,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Plan-sharded linear-model training on ``mesh`` (a port
    :class:`~flinkml_tpu_torch.parallel.DeviceMesh` with the plan's axes;
    None: one device); returns the global coefficient on the host, the
    same bits on every rank. Every rank passes the same global ``x``,
    ``y``, ``w``.

    One step per epoch over a clamped rotating window of
    ``global_batch_size`` rows (the whole table when None); stops at
    ``max_iter``, or when ``tol > 0`` and the epoch's loss is at most
    ``tol``. ``hbm_budget_bytes`` feeds the FML5xx check (FML503).
    ``precision`` (a policy, preset name or JSON dict) declares the
    mixed-precision contract; the storage dtype is ``dtype``, else
    ``policy.params``, else ``x``'s (float64 for non-float ``x``).
    ``checkpoint_manager`` snapshots the assembled state with
    plan-derived layouts every ``checkpoint_interval`` epochs and at the
    end; ``resume=True`` continues from the newest valid snapshot, at
    any world under ``rescale="reshard"``. ``sentinel`` raises a typed
    ``NumericsError`` at the epoch whose state or loss is not finite,
    before a snapshot can hold it. A ``RankLost`` at the ``rank.lost``
    seam under a watchdog, or the watchdog's own request, stops the loop
    at the epoch boundary with a terminal snapshot. ``stats``, when given, is
    filled with the loop's seconds, its steps, the collectives the loop
    issued (the steps', the snapshots' and the verdicts'), whether a
    preemption stopped it and its last epoch.
    """
    import time

    from flinkml_tpu_torch.iteration.checkpoint import (
        begin_resume,
        should_snapshot,
    )
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh, pad_to_multiple
    from flinkml_tpu_torch.precision import resolve_policy

    from flinkml_tpu_torch import faults
    from flinkml_tpu_torch.utils import preemption

    if loss not in ("logistic", "hinge", "squared"):
        raise ValueError(f"unsupported loss {loss!r}")
    policy = resolve_policy(precision)
    x = np.asarray(x)
    n, dim = x.shape
    if n == 0:
        raise ValueError("training table is empty")
    if dtype is not None:
        dt = _torch_dtype(dtype)
    elif policy is not None:
        dt = policy.params_dtype
    else:
        dt = _torch_dtype(x.dtype.name if x.dtype.kind == "f" else "float64")
    if mesh is None:
        mesh = DeviceMesh.for_plan(plan)
    slots = 1 if optimizer == "sgd" else 2
    validate_plan(
        plan, mesh, param_shapes={"coef": (dim,)},
        hbm_budget_bytes=hbm_budget_bytes, dtype_bytes=dt.itemsize,
        optimizer_slots=slots,
    )
    l2 = reg * (1.0 - elastic_net)
    l1 = reg * elastic_net
    step = linear_step_fn(loss, optimizer, float_name(dt),
                          float(learning_rate), float(momentum), float(l2),
                          float(l1), policy=policy)
    if policy is not None:
        validate_linear_precision(
            policy, step, dim, batch_world(plan, mesh), dt, optimizer,
            plan=plan, program=f"train_linear_plan[{optimizer}/{loss}]",
        )

    grouped = mesh.mesh is not None
    world = mesh.num_devices
    if not grouped and world > 1:
        raise ValueError(
            f"a mesh of {world} ranks needs a process group on every rank "
            "(init_distributed); without one the fit runs on one device"
        )
    writer = mesh.rank == mesh.device_ids[0]
    device = mesh.device
    host_dt = float_name(dt)
    resume_epoch = begin_resume(checkpoint_manager, resume, world)
    state_h = init_linear_state(dim, optimizer, dt)
    epoch = 0
    if resume_epoch is not None:
        from flinkml_tpu_torch.iteration.stream_sync import (
            agreed_restore_latest,
        )

        restored = agreed_restore_latest(
            checkpoint_manager, state_h, mesh if grouped else None,
            "plan-sharded checkpoint restore")
        if restored is not None:
            state_h, epoch = restored
            _log.info("plan-sharded resume: plan=%s epoch=%d world=%d",
                      plan.name, epoch, world)
    sync = _PlanSync(plan, mesh, dim) if grouped else None
    reduce_verdict = None
    if sentinel is not None and grouped and world > 1:
        import torch.distributed as dist

        verdict_group = mesh.group_over(tuple(mesh.axis_names))[0]

        def reduce_verdict(v):
            # Each rank checked its own blocks: one MAX makes the verdict
            # the mesh's, so every rank raises at the same epoch.
            dist.all_reduce(v, op=dist.ReduceOp.MAX, group=verdict_group)
            sync.counts["all_reduce"] += 1
            return v
    state = {}
    for name, leaf in state_h.items():
        t = torch.as_tensor(np.asarray(leaf) if not torch.is_tensor(leaf)
                            else leaf).to(device=device, dtype=dt)
        state[name] = (t if sync is None or t.dim() == 0
                       else _local_block(plan, mesh, name, t).contiguous())

    def assembled() -> Dict[str, np.ndarray]:
        """The global state on the host (a collective with a group)."""
        out = {}
        for name, t in state.items():
            full = t if sync is None or t.dim() == 0 else sync.gather(t)
            out[name] = _host_value(full)
        return out

    xs = x if host_dt not in _NUMPY_FLOATS else x.astype(host_dt, copy=False)
    ys = np.asarray(y)
    ws = np.ones(n) if w is None else np.asarray(w)
    bw = batch_world(plan, mesh)
    block = mesh.coordinate_of(plan.batch_axes)
    bs = n if global_batch_size is None else min(int(global_batch_size), n)
    n_windows = max(-(-n // bs), 1)
    windows: Dict[int, Tuple[torch.Tensor, ...]] = {}

    def upload(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dt)

    def window(ep: int):
        # A function of the epoch alone, the same at every world; this
        # rank's block of it uploads once and stays on the device.
        widx = ep % n_windows
        cached = windows.get(widx)
        if cached is None:
            start = min(widx * bs, max(n - bs, 0))
            padded = [pad_to_multiple(a[start:start + bs], bw)[0]
                      for a in (xs, ys, ws)]
            m = padded[0].shape[0] // bw
            xb, yb, wb = (upload(a[block * m:(block + 1) * m])
                          for a in padded)
            cached = (step.prepare_batch(xb), yb, wb)
            windows[widx] = cached
        return cached

    lock = contextlib.nullcontext()
    if grouped and world > 1:
        from flinkml_tpu_torch.parallel.dispatch import local_execution_lock

        lock = local_execution_lock(mesh)
    t_loop = time.perf_counter()
    steps = 0
    watchdog = preemption.active()
    preempted = False
    with lock:
        while epoch < max_iter:
            if faults.ACTIVE is not None:
                # A scripted RankLost: under the watchdog a clean stop at
                # this boundary, without one a hard crash (as iterate).
                faults.fire("rank.lost", epoch=epoch, watchdog=watchdog)
            if watchdog is not None and watchdog.requested:
                preempted = True
                break
            batch = window(epoch)
            if faults.ACTIVE is not None:
                # A PoisonBatch swaps in a NaN twin of the cached window
                # for this step only; the cache keeps the clean one.
                fctx = {"phase": "pre", "epoch": epoch,
                        "source_index": epoch, "batch": batch}
                faults.fire_into("train.step", fctx)
                batch = fctx["batch"]
            state, loss_dev = step(state, *batch, sync=sync, prepared=True)
            if faults.ACTIVE is not None:
                fctx = {"phase": "post", "epoch": epoch,
                        "source_index": epoch, "state": state,
                        "criteria": loss_dev}
                faults.fire_into("train.step", fctx)
                state, loss_dev = fctx["state"], fctx["criteria"]
            epoch += 1
            steps += 1
            if sentinel is not None:
                # Before the snapshot below can persist a bad state; the
                # loss is read with the verdict.
                loss_dev = sentinel.check(state, loss_dev, epoch=epoch - 1,
                                          source_index=epoch - 1,
                                          reduce=reduce_verdict)
            terminal = tol > 0.0 and float(loss_dev) <= tol
            if should_snapshot(checkpoint_manager, checkpoint_interval, epoch,
                               max_iter, terminal=terminal):
                snapshot = assembled()
                if writer:
                    checkpoint_manager.save(snapshot, epoch, plan=plan)
            if terminal:
                break
        if preempted and checkpoint_manager is not None:
            # The preemption's terminal snapshot: the survivors resume
            # from exactly this epoch.
            snapshot = assembled()
            if writer:
                checkpoint_manager.save(snapshot, epoch, plan=plan)
        loop_counts = dict(sync.counts) if sync is not None else {
            "all_gather": 0, "all_reduce": 0}
        coef = state["coef"] if sync is None else sync.gather(state["coef"])
        result = _host_value(coef)
    loop_s = time.perf_counter() - t_loop
    if checkpoint_manager is not None:
        checkpoint_manager.wait()
        if grouped and world > 1:
            from flinkml_tpu_torch.models._linear_sgd import _agree_same

            _agree_same(epoch, mesh, "the final checkpoint epoch")
    if stats is not None:
        stats.update(loop_s=loop_s, steps=steps, world=world,
                     batch_world=bw, windows=len(windows),
                     collectives=loop_counts, preempted=preempted,
                     epoch=epoch)
    return result


def plan_layouts(plan: ShardingPlan, state):
    """The layout-tag tree ``save(plan=...)`` derives
    (:func:`~flinkml_tpu_torch.sharding.plan.layouts_for`)."""
    return layouts_for(plan, state)


__all__ = [
    "PlanValidationError",
    "LinearStep",
    "batch_sharding",
    "batch_world",
    "init_linear_state",
    "linear_step_fn",
    "plan_layouts",
    "shard_state",
    "state_names",
    "state_shardings",
    "train_linear_plan",
    "validate_linear_precision",
    "validate_plan",
]
