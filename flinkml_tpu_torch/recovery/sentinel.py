"""Numerics sentinel: a finiteness and magnitude verdict on the device.

The port's counterpart of ``flinkml_tpu.recovery.sentinel``. A NaN'd
model trains silently to garbage: every later update of a non-finite
carry stays non-finite. The sentinel checks at the epoch boundary, before
the state can be checkpointed, published or handed to listeners:

- **one pass on the device** over every float leaf of the carry gives
  the largest ``|x|`` (one ``vector_norm`` of order infinity a leaf,
  which propagates a NaN, and one maximum over those; the carry is not
  copied), and the JAX package's bit rules follow from it and the loss:
  the state is finite when that maximum is, the magnitude bit is set
  when its float32 value is not ``<= max_abs`` (so a NaN leaf sets both
  bits, as in the JAX package);
- **one read**: the maximum comes to the host in one ``.tolist()``, and
  when the step's loss is still a tensor it travels in the same read,
  so a trainer that reads its loss every step pays no second
  synchronization. Host leaves (numpy arrays) are checked on the host.
  On ranks that each hold a block of the state the bits are formed on
  the device and all-reduced before the read;
- a bad verdict raises a typed :class:`NumericsError`, classified
  *data-poison* (a non-finite loss or state right after a step: one bad
  batch) or *systemic* (a finite magnitude above ``max_abs`` for
  ``systemic_streak`` consecutive checks).

Thread it through :func:`flinkml_tpu_torch.iteration.iterate` with
``IterationConfig(sentinel=NumericsSentinel())`` (the online trainers take
the same knob on ``fit_stream``) or through
``sharding.apply.train_linear_plan(..., sentinel=...)``. With a
:class:`~flinkml_tpu_torch.recovery.RecoveryPolicy` the raise becomes a
rollback-and-quarantine instead of a crash.

:func:`check_stage_finite` refuses a non-finite model at a publish or
serve boundary: :meth:`~flinkml_tpu_torch.serving.ModelRegistry.publish`
calls it before any file is written, and the serving engine before it
installs a model (``ServingConfig(refuse_nonfinite=True)``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

# verdict bitmask (host-decoded from the device scalar)
VERDICT_LOSS_NONFINITE = 1
VERDICT_STATE_NONFINITE = 2
VERDICT_MAGNITUDE = 4

#: classification values carried by :class:`NumericsError`
DATA_POISON = "data_poison"
SYSTEMIC = "systemic"


class NumericsError(RuntimeError):
    """The sentinel's typed verdict: training numerics went bad.

    Attributes:
        classification: :data:`DATA_POISON` (non-finite loss/state right
            after a step — one bad batch; rollback + quarantine heals
            it) or :data:`SYSTEMIC` (persistent divergence — a bad
            hyperparameter, a broken kernel, or a poison budget
            exhausted; no single batch to quarantine).
        epoch: the delivered-batch epoch the verdict fired at.
        source_index: the SOURCE index of the batch consumed at that
            epoch (what a quarantine excludes) — None when unknown.
        verdict: the raw bitmask (VERDICT_* flags).
        exact: False when the sentinel checks on an interval > 1 and the
            offending batch is only known to lie in ``(last_clean,
            epoch]`` — the recovery engine then rolls back and re-runs
            with per-epoch checks to pinpoint it before quarantining.
    """

    def __init__(self, message: str, classification: str, epoch: int,
                 source_index: Optional[int] = None, verdict: int = 0,
                 exact: bool = True):
        super().__init__(message)
        self.classification = classification
        self.epoch = int(epoch)
        self.source_index = (None if source_index is None
                             else int(source_index))
        self.verdict = int(verdict)
        self.exact = bool(exact)


class NonFiniteModelError(NumericsError):
    """A model with non-finite parameters reached a publish/serve
    boundary — refused before it can be swapped into a live engine or
    recorded as a registry version."""

    def __init__(self, message: str):
        super().__init__(message, classification=DATA_POISON, epoch=-1)


def _float_leaves(state: Any) -> Tuple[Any, ...]:
    """The floating leaves of a state tree (tensors and numpy arrays) in
    ``jax.tree_util``'s order (dicts by sorted key); Python scalars have
    no dtype and are not leaves here, as in the JAX package."""
    from flinkml_tpu_torch.iteration.checkpoint import tree_flatten

    out = []
    for leaf in tree_flatten(state)[0]:
        if torch.is_tensor(leaf):
            if leaf.is_floating_point():
                out.append(leaf)
        elif hasattr(leaf, "dtype") and np.issubdtype(np.dtype(leaf.dtype),
                                                      np.floating):
            out.append(leaf)
    return tuple(out)


def _host_bits(m: float, limit: np.float32) -> int:
    """The state bits of ``m``, the largest ``|x|`` over the leaves (NaN
    when any element is NaN): a NaN or an infinity is non-finite, and the
    magnitude is held against the bound in float32."""
    bits = 0 if np.isfinite(m) else VERDICT_STATE_NONFINITE
    with np.errstate(over="ignore", invalid="ignore"):
        return bits | (0 if np.float32(m) <= limit else VERDICT_MAGNITUDE)


def _largest_abs(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The largest ``|x|`` over tensors on one device, as a 0-d float64
    tensor (a leaf's maximum is exact in float64): one ``vector_norm``
    of order infinity a leaf (``|x|`` and the maximum in one pass, a NaN
    propagated), then one maximum over the leaves' maxima, as the JAX
    package's per-leaf ``max(abs(leaf))``. The carry is not copied. No
    read."""
    norms = [torch.linalg.vector_norm(t.detach(), float("inf"))
             for t in tensors]
    if len({n.dtype for n in norms}) > 1:
        norms = [n.to(torch.float64) for n in norms]
    m = norms[0] if len(norms) == 1 else torch.stack(norms).amax()
    return m.to(torch.float64)


def verdict_bits(leaves, loss: Any, max_abs: Optional[float],
                 reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None) -> Tuple[int, Optional[float]]:
    """The verdict over ``leaves`` and ``loss``: ``(bits, loss as a host
    float or None)``, from one pass and one read per device the leaves
    live on.

    ``loss`` is None, a Python number or a 0-d tensor (read together with
    the verdict). ``reduce``, given, maps the int32 verdict bits on the
    device before the read (an all-reduce MAX over ranks that each hold a
    block of the state)."""
    limit = np.float32(np.inf if max_abs is None else max_abs)
    by_device: dict = {}
    host: List[float] = []
    for leaf in leaves:
        if np.prod(tuple(leaf.shape)) == 0:
            continue
        if torch.is_tensor(leaf):
            by_device.setdefault(leaf.device, []).append(leaf)
        else:
            host.append(np.max(np.abs(np.asarray(leaf, np.float64))))
    loss_t = loss if torch.is_tensor(loss) else None
    if loss_t is not None and loss_t.device not in by_device:
        by_device[loss_t.device] = []
    bits = 0
    loss_value = None if loss is None or loss_t is not None else float(loss)
    for device, tensors in by_device.items():
        carried = loss_t is not None and loss_t.device == device
        if tensors and reduce is not None:
            m = _largest_abs(tensors)
            v = torch.where(torch.isfinite(m), 0, VERDICT_STATE_NONFINITE)
            v = v | torch.where(m.to(torch.float32) <= torch.tensor(
                limit, device=device), 0, VERDICT_MAGNITUDE)
            v = reduce(v.to(torch.int32)).to(torch.float64)
        elif tensors:
            v = _largest_abs(tensors)
        else:
            v = torch.zeros((), dtype=torch.float64, device=device)
        if carried:
            v = torch.stack([v, loss_t.detach().to(torch.float64)])
        got = v.tolist()                   # the one read on this device
        value = got[0] if carried else got
        if carried:
            loss_value = got[1]
        if tensors:
            bits |= int(value) if reduce is not None \
                else _host_bits(value, limit)
    if host:
        bits |= _host_bits(np.max(np.asarray(host)), limit)
    if loss_value is not None and not np.isfinite(loss_value):
        bits |= VERDICT_LOSS_NONFINITE
    return bits, loss_value


class NumericsSentinel:
    """See module docstring.

    Args:
        max_abs: magnitude bound over the state's float leaves; a finite
            state above it for ``systemic_streak`` consecutive checks is
            :data:`SYSTEMIC` divergence. ``None`` disables the magnitude
            check (a NaN still sets the magnitude bit, as in the JAX
            package).
        systemic_streak: consecutive over-magnitude checks before the
            systemic raise (1 = immediately).
        interval: check every N epochs (1 = every epoch); the off-epochs
            pay nothing. With N > 1 a detection is *inexact* (the bad
            batch lies somewhere in the unchecked window) and the raise
            carries ``exact=False``, so the recovery engine re-runs the
            window with per-epoch checks (:meth:`begin_pinpoint`).
    """

    def __init__(self, max_abs: Optional[float] = 1e8,
                 systemic_streak: int = 3, interval: int = 1):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        if systemic_streak < 1:
            raise ValueError(
                f"systemic_streak must be >= 1, got {systemic_streak}"
            )
        self.max_abs = None if max_abs is None else float(max_abs)
        self.systemic_streak = int(systemic_streak)
        self.interval = int(interval)
        self._mag_streak = 0
        self._last_clean_epoch: Optional[int] = None
        self._pinpoint_until: Optional[int] = None
        #: epochs checked / raises, for tests and the recovery metrics
        self.checks = 0
        self.raises = 0

    # -- recovery-engine hooks ----------------------------------------------
    def begin_pinpoint(self, until_epoch: int) -> None:
        """Force per-epoch checks through ``until_epoch`` (inclusive): the
        re-run after an inexact interval > 1 detection."""
        self._pinpoint_until = int(until_epoch)

    def reset_streak(self) -> None:
        """Forget the magnitude streak (after a rollback: the restored
        carry predates it)."""
        self._mag_streak = 0
        self._last_clean_epoch = None

    def _due(self, epoch: int) -> bool:
        if self._pinpoint_until is not None:
            if epoch <= self._pinpoint_until:
                return True
            self._pinpoint_until = None
        return self.interval == 1 or (epoch + 1) % self.interval == 0

    # -- the check -----------------------------------------------------------
    def check(self, state: Any, criteria: Any, epoch: int,
              source_index: Optional[int] = None,
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]]
              = None) -> Optional[float]:
        """Verdict over the post-step ``state`` and the step's loss
        ``criteria`` (None, a number or a 0-d tensor); raises
        :class:`NumericsError` on a bad one and returns the loss as a host
        float (None without one), read with the verdict when it is a
        tensor. Call at the epoch boundary, BEFORE the state is
        checkpointed or handed to listeners. ``reduce``: see
        :func:`verdict_bits`."""
        if not self._due(epoch):
            return None if criteria is None else float(criteria)
        leaves = _float_leaves(state)
        loss = 0.0 if criteria is None else criteria
        if leaves:
            bits, loss_value = verdict_bits(leaves, loss, self.max_abs,
                                            reduce)
        else:  # a carry with no float arrays: the loss check only
            loss_value = float(loss)
            bits = 0 if np.isfinite(loss_value) else VERDICT_LOSS_NONFINITE
        if criteria is None:
            loss_value = None
        self.checks += 1
        exact = (
            self.interval == 1
            or self._pinpoint_until is not None
            or self._last_clean_epoch == epoch - 1
        )
        if bits & (VERDICT_LOSS_NONFINITE | VERDICT_STATE_NONFINITE):
            self.raises += 1
            what = []
            if bits & VERDICT_LOSS_NONFINITE:
                what.append("loss")
            if bits & VERDICT_STATE_NONFINITE:
                what.append("state")
            raise NumericsError(
                f"non-finite {'/'.join(what)} at epoch {epoch} "
                f"(source batch "
                f"{'?' if source_index is None else source_index}"
                f"{'' if exact else ', inexact: interval-checked'})",
                classification=DATA_POISON, epoch=epoch,
                source_index=source_index, verdict=bits, exact=exact,
            )
        if bits & VERDICT_MAGNITUDE:
            self._mag_streak += 1
            if self._mag_streak >= self.systemic_streak:
                self.raises += 1
                raise NumericsError(
                    f"state magnitude exceeded {self.max_abs:g} for "
                    f"{self._mag_streak} consecutive checks (epoch "
                    f"{epoch}): systemic divergence, not a single bad "
                    "batch",
                    classification=SYSTEMIC, epoch=epoch,
                    source_index=source_index,
                    verdict=bits, exact=exact,
                )
        else:
            self._mag_streak = 0
            self._last_clean_epoch = epoch
        return loss_value


# -- publish/serve boundary --------------------------------------------------


def _iter_stage_arrays(stage: Any):
    """Yield ``(name, array)`` for every float array a stage's model
    data exposes. Pipelines recurse into their stages; stages without a
    ``get_model_data`` surface (pure transforms — no learned arrays)
    yield nothing."""
    stages = getattr(stage, "stages", None)
    if stages is not None and not callable(stages):
        for i, sub in enumerate(stages):
            for name, arr in _iter_stage_arrays(sub):
                yield f"stage[{i}].{name}", arr
        return
    get_model_data = getattr(stage, "get_model_data", None)
    if get_model_data is None:
        return
    try:
        tables = get_model_data()
    except ValueError:
        return  # no model data set — nothing to verify
    for t, table in enumerate(tables):
        for col in getattr(table, "column_names", ()):
            arr = np.asarray(table.column(col))
            if np.issubdtype(arr.dtype, np.floating):
                yield f"model_data[{t}].{col}", arr


def check_stage_finite(stage: Any, where: str = "publish") -> None:
    """Refuse a non-finite model at a publish/serve boundary: raises
    :class:`NonFiniteModelError` naming the first bad array. Stages
    without learned arrays pass trivially."""
    for name, arr in _iter_stage_arrays(stage):
        if not np.isfinite(arr).all():
            bad = int(np.size(arr) - np.isfinite(arr).sum())
            raise NonFiniteModelError(
                f"refusing to {where} {type(stage).__name__}: model "
                f"array {name!r} holds {bad} non-finite value(s) — a "
                "NaN'd model must never reach serving (roll back to the "
                "newest valid snapshot / registry version; see "
                "docs/development/fault_tolerance.md, 'Self-healing')"
            )
