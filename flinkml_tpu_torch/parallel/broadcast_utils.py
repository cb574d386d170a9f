"""Broadcast variables: the ``BroadcastUtils`` analog.

The port's counterpart of ``flinkml_tpu.parallel.broadcast_utils``
(reference: ``BroadcastUtils.withBroadcastStream``,
``BroadcastUtils.java:67-155``; ``BroadcastContext.java:40-84``). A
broadcast variable is a value placed on this rank's device before the
user function runs (:meth:`~flinkml_tpu_torch.parallel.DeviceMesh.
replicate` over a mesh, else the compute device): the reference's
receive, cache and block machinery does not exist, because the value is
in place before the consumer starts. What remains is the API shape: a
named registry scoped to one :func:`with_broadcast` call, read from
inside the function by :func:`get_broadcast_variable`.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Mapping, Optional, Sequence

from flinkml_tpu_torch.parallel.mesh import DeviceMesh

_local = threading.local()


class BroadcastContext:
    """Per-thread registry of live broadcast variables: one frame per
    :func:`with_broadcast` call on the calling thread (nested calls shadow
    outer names)."""

    @staticmethod
    def _stack() -> list:
        if not hasattr(_local, "stack"):
            _local.stack = []
        return _local.stack

    @staticmethod
    def lookup(name: str) -> Any:
        stack = BroadcastContext._stack()
        for frame in reversed(stack):
            if name in frame:
                return frame[name]
        raise KeyError(
            f"no broadcast variable {name!r} in scope; available: "
            f"{sorted(set().union(*stack) if stack else set())}"
        )


def get_broadcast_variable(name: str) -> Any:
    """Read a broadcast variable from inside a ``with_broadcast`` function
    (``BroadcastStreamingRuntimeContext.getBroadcastVariable``)."""
    return BroadcastContext.lookup(name)


def with_broadcast(
    fn: Callable,
    inputs: Sequence[Any] = (),
    broadcast_variables: Optional[Mapping[str, Any]] = None,
    mesh: Optional[DeviceMesh] = None,
):
    """Run ``fn(*inputs)`` with named variables placed on the device:
    over ``mesh`` (this rank's device) if given, else the compute device;
    each becomes a tensor before ``fn`` runs."""
    broadcast_variables = dict(broadcast_variables or {})
    placed = {
        name: (mesh.replicate(v) if mesh is not None else _default_put(v))
        for name, v in broadcast_variables.items()
    }
    stack = BroadcastContext._stack()
    stack.append(placed)
    try:
        return fn(*inputs)
    finally:
        stack.pop()


def _default_put(value: Any):
    import numpy as np
    import torch

    from flinkml_tpu_torch.device import default_device

    if torch.is_tensor(value):
        return value.to(default_device())
    return torch.as_tensor(np.asarray(value)).to(default_device())
