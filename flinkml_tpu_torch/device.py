"""The compute device of the port's entry points.

Every entry point that touches tensors (scaler ``fit``, per-stage and fused
``transform``, sparse scoring) places its work on :func:`default_device`,
which is ``cuda`` unless the caller asks for the CPU explicitly:

.. code-block:: python

    import flinkml_tpu_torch as fml

    with fml.use_device("cpu"):          # this thread, this block
        (out,) = model.transform(table)

    fml.set_default_device("cpu")        # the whole process

There is no silent fallback: asking for ``cuda`` on a host without a usable
card raises :class:`RuntimeError` naming the remedy, so a run can never
report CPU numbers as the card's.
"""

from __future__ import annotations

import threading
from typing import Union

import torch

DeviceLike = Union[str, torch.device]

_PROCESS_DEFAULT = [torch.device("cuda")]
_LOCAL = threading.local()


def _check(device: torch.device) -> torch.device:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flinkml_tpu_torch runs on the CUDA device by default, but "
            "torch.cuda.is_available() is False on this host. Run on a "
            "machine with an NVIDIA GPU and a CUDA build of PyTorch, or ask "
            "for the CPU explicitly with flinkml_tpu_torch.use_device('cpu') "
            "or flinkml_tpu_torch.set_default_device('cpu')."
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; expected cuda or cpu")
    return device


def requested_device() -> torch.device:
    """The device :func:`default_device` would return, without checking
    that it is usable."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else _PROCESS_DEFAULT[0]


def default_device() -> torch.device:
    """The device entry points compute on: the innermost
    :class:`use_device` of this thread, else the process default
    (``cuda`` unless :func:`set_default_device` changed it). Raises
    :class:`RuntimeError` when that is ``cuda`` and no card is usable."""
    return _check(requested_device())


def set_default_device(device: DeviceLike) -> None:
    """Set the process-wide default compute device (``"cuda"`` or
    ``"cpu"``)."""
    _PROCESS_DEFAULT[0] = _check(torch.device(device))


class use_device:
    """Context manager: run this thread's entry points on ``device``."""

    def __init__(self, device: DeviceLike):
        self._device = _check(torch.device(device))

    def __enter__(self) -> torch.device:
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self._device)
        return self._device

    def __exit__(self, *exc) -> bool:
        _LOCAL.stack.pop()
        return False
