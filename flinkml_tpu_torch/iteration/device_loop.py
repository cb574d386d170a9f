"""Iteration with the loop carry on the device.

The port's counterpart of ``flinkml_tpu.iteration.device_loop``: the JAX
package compiles the whole loop into one ``lax.while_loop``; here it is
the linear trainers' device loop
(:func:`flinkml_tpu_torch.models._linear_sgd._device_loop`): the carry and
the termination flag stay on the device, and the host reads the flag every
``SYNC_EVERY`` steps.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch


def device_iterate(
    step_fn: Callable[[torch.Tensor, int], Tuple[torch.Tensor, Any]],
    init_state: torch.Tensor,
    max_iter: int,
    tol: Optional[float] = None,
):
    """Run ``step_fn(state, epoch) -> (state, criteria)`` with the carry on
    the device; ``state`` is one tensor.

    Terminates after ``max_iter`` epochs or when ``criteria <= tol`` (when
    ``tol`` is given): the on-device ``TerminateOnMaxIterOrTol``. The
    criterion is taken as float32, as the JAX package takes it. A NaN
    criterion stops the loop (it is not above ``tol``), as the trainers'
    loop does.

    Returns ``(final_state, epochs_run, last_criteria)``, the last two as
    0-d tensors.
    """
    from flinkml_tpu_torch.models._linear_sgd import _device_loop

    device = init_state.device
    crit0 = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    tol_t = torch.tensor(float("-inf") if tol is None else tol,
                         dtype=torch.float32, device=device)

    def step(state, epoch):
        new, criteria = step_fn(state, epoch)
        return new, torch.as_tensor(criteria).to(device=device,
                                                 dtype=torch.float32)

    return _device_loop(step, init_state, 0, crit0, tol_t, int(max_iter))
