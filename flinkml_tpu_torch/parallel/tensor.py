"""Tensor, pipeline and expert parallelism over named mesh axes.

The port's counterpart of ``flinkml_tpu.parallel.tensor``. The JAX
package writes each primitive as a ``shard_map`` body with ``psum``,
``ppermute`` and ``all_to_all`` over one named axis; here every rank is
one process, runs the same body on its own block, and the named-axis
collectives are those of :mod:`~flinkml_tpu_torch.parallel.collectives`
over the axis's process group:

  - **Column-parallel linear** (Megatron fan-out): ``w1 [d_in, d_ff]``
    split on ``d_ff``, activations replicated in, no communication.
  - **Row-parallel linear** (fan-in): ``w2`` split on ``d_ff``, one
    ``all_reduce`` gives the replicated output. Column then row is the
    two-matmul MLP block with one collective.
  - **Pipeline stages**: stage ``s`` of the stacked parameters lives on
    rank ``s`` of the axis; a GPipe microbatch loop hands activations to
    the next stage each step (one send to rank ``s + 1`` and one receive
    from rank ``s - 1``, a ring ``batch_isend_irecv``).
  - **Experts**: expert ``e`` on rank ``e``: a dense gate-masked sum (one
    ``all_reduce``) or top-1 routing with a capacity (two
    ``all_to_all``\\ s), dropping exactly the JAX package's tokens.

Inputs follow the port's SPMD convention: every rank passes the same
global arrays (host arrays or tensors) and keeps its block; the result is
the global array on every rank (a token-sharded output is all-gathered in
mesh order). Without a process group the mesh has one rank and no
collective is issued. JAX's varying-axes typing (``pcast`` to
``varying``) marks loop carries for its type checker and has no
counterpart here: a torch tensor carries no such type, and nothing
replaces it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from flinkml_tpu_torch.parallel import collectives
from flinkml_tpu_torch.parallel.mesh import DeviceMesh


def activation_fn(name: str) -> Callable:
    """The torch function of a ``jax.nn`` activation name (``gelu`` is
    JAX's default tanh approximation)."""
    import torch.nn.functional as F

    table = {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": torch.relu,
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "silu": F.silu,
        "swish": F.silu,
        "softplus": F.softplus,
        "elu": F.elu,
    }
    if name not in table:
        raise ValueError(
            f"unknown activation {name!r}; expected one of {sorted(table)}"
        )
    return table[name]


def _default_mesh(mesh: Optional[DeviceMesh], axis: str) -> DeviceMesh:
    return mesh if mesh is not None else DeviceMesh({axis: _world()})


def _world() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _axis_check(dm: DeviceMesh, axis: str) -> int:
    if axis not in dm.axis_names:
        raise ValueError(
            f"mesh has axes {dm.axis_names}, no axis named {axis!r}"
        )
    return dm.axis_size(axis)


def _on(dm: DeviceMesh, a, dtype=None) -> torch.Tensor:
    """``a`` (host array or tensor) as a tensor on the mesh's device."""
    t = a if torch.is_tensor(a) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)))
    t = t.to(dm.device)
    return t if dtype is None else t.to(dtype)


def _axis(dm: DeviceMesh, axis: str):
    """``(group, ranks, index)`` of this rank's line along ``axis``."""
    group, ranks = dm.group_over((axis,))
    index = dm.axis_index(axis) if dm.mesh is not None else 0
    return group, ranks, index


def tensor_parallel_mlp(x, w1, b1, w2, b2, mesh: Optional[DeviceMesh] = None,
                        axis: str = "model", activation: str = "gelu"):
    """The canonical TP block: column-parallel ``w1`` + activation +
    row-parallel ``w2`` with a single ``all_reduce``.

    Shapes: ``x [.., d_in]``, ``w1 [d_in, d_ff]``, ``b1 [d_ff]``,
    ``w2 [d_ff, d_out]``, ``b2 [d_out]``; ``d_ff`` must divide by the
    size of ``axis``. Output replicated over ``axis``.
    """
    dm = _default_mesh(mesh, "model")
    p_size = _axis_check(dm, axis)
    d_ff = w1.shape[1]
    if d_ff % p_size != 0:
        raise ValueError(f"d_ff {d_ff} must divide by axis size {p_size}")
    if w2.shape[0] != d_ff or b1.shape[0] != d_ff:
        raise ValueError("w1/b1/w2 d_ff dimensions disagree")
    act = activation_fn(activation)
    group, ranks, idx = _axis(dm, axis)
    cols = slice(idx * (d_ff // p_size), (idx + 1) * (d_ff // p_size))
    x, b2 = _on(dm, x), _on(dm, b2)
    # Column-parallel: this rank's [d_in, d_ff/P] slice, no communication.
    h = act(x @ _on(dm, w1[:, cols]) + _on(dm, b1[cols]))
    # Row-parallel: the local partial product, then one all_reduce.
    y = collectives.group_all_reduce(group, ranks, h @ _on(dm, w2[cols]))
    return y + b2


# Pipeline stages are named functions (acts, params) -> acts.
_STAGE_REGISTRY: dict = {}


def register_pipeline_stage(name: str, fn: Callable) -> None:
    """Register a stage function ``(acts, params) -> acts`` (torch
    tensors) for :func:`pipeline_parallel_apply`."""
    _STAGE_REGISTRY[name] = fn


register_pipeline_stage("linear_tanh", lambda a, p: torch.tanh(a @ p))


def pipeline_parallel_apply(x_microbatches, stage_params, stage: str,
                            mesh: Optional[DeviceMesh] = None,
                            axis: str = "pipe"):
    """GPipe-style pipeline over ``axis``: rank s applies stage s.

    Args:
        x_microbatches: ``[n_microbatches, ...]`` inputs (replicated).
        stage_params: ``[n_stages, ...]`` per-stage params; rank s of
            ``axis`` keeps stage s (n_stages must equal the axis size).
        stage: name registered via :func:`register_pipeline_stage`.
    Returns:
        ``[n_microbatches, ...]`` outputs after all stages, replicated.

    At step t rank s works on microbatch ``t - s``; after each step the
    activations move one hop forward and stage 0 loads the next input.
    The last stage banks each finished microbatch, and one ``all_reduce``
    of its bank (zeros on every other rank) replicates the outputs.
    """
    dm = _default_mesh(mesh, "pipe")
    p_size = _axis_check(dm, axis)
    if stage_params.shape[0] != p_size:
        raise ValueError(
            f"stage_params has {stage_params.shape[0]} stages but axis "
            f"{axis!r} has {p_size} devices"
        )
    if stage not in _STAGE_REGISTRY:
        raise ValueError(f"unknown pipeline stage {stage!r}")
    fn = _STAGE_REGISTRY[stage]
    group, ranks, idx = _axis(dm, axis)
    x_mb = _on(dm, x_microbatches)
    params = _on(dm, stage_params[idx])
    n_mb = int(x_mb.shape[0])
    last = p_size - 1
    acts = x_mb[0]
    outputs = torch.zeros_like(x_mb)
    for t in range(n_mb + p_size - 1):
        mb = t - idx
        active = 0 <= mb < n_mb
        # An idle stage keeps its activations (JAX's where(active, ...)).
        acts_new = fn(acts, params) if active else acts
        if active and idx == last:
            outputs[mb] = acts_new
        (rotated,) = collectives.ppermute(group, ranks, [acts_new])
        acts = x_mb[t + 1] if idx == 0 and t + 1 < n_mb else rotated
    if idx != last:
        outputs.zero_()
    return collectives.group_all_reduce(group, ranks, outputs)


def expert_parallel_ffn(x, gates, w1, w2, mesh: Optional[DeviceMesh] = None,
                        axis: str = "expert", activation: str = "gelu"):
    """Expert-parallel mixture-of-experts FFN: expert e's weights live on
    rank e of ``axis``; outputs are the gate-weighted sum of expert
    outputs (one ``all_reduce``).

    Shapes: ``x [n, d_in]``, ``gates [n, E]`` (rows of mixture weights,
    e.g. a softmax or a one-hot top-1), ``w1 [E, d_in, d_ff]``,
    ``w2 [E, d_ff, d_out]``; ``E`` must equal the size of ``axis``.
    """
    dm = _default_mesh(mesh, "expert")
    p_size = _axis_check(dm, axis)
    e = w1.shape[0]
    if e != p_size or w2.shape[0] != e or gates.shape[1] != e:
        raise ValueError(
            f"expert count mismatch: w1 {w1.shape[0]}, w2 {w2.shape[0]}, "
            f"gates {gates.shape[1]}, axis size {p_size}"
        )
    act = activation_fn(activation)
    group, ranks, idx = _axis(dm, axis)
    x = _on(dm, x)
    y = act(x @ _on(dm, w1[idx])) @ _on(dm, w2[idx])
    g = _on(dm, gates[:, idx])
    return collectives.group_all_reduce(group, ranks, g[:, None] * y)


def route_top1(logits: torch.Tensor, capacity: int):
    """Switch top-1 routing of one rank's tokens: ``(expert, gate, pos,
    keep)``. ``expert`` is the first index of the largest softmax
    probability, ``gate`` that probability, ``pos`` the token's 0-based
    slot in its expert's send buffer (the count of earlier tokens routed
    to that expert, in int64 whatever the data type) and ``keep`` whether
    the slot is below ``capacity``: tokens past it are dropped."""
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    e_count = logits.shape[1]
    onehot = torch.nn.functional.one_hot(expert, e_count)
    pos = ((torch.cumsum(onehot, dim=0) * onehot).sum(dim=1) - 1)
    return expert, gate, pos, pos < capacity


def routed_expert_ffn(x, router_logits, w1, w2,
                      mesh: Optional[DeviceMesh] = None,
                      axis: str = "expert", capacity_factor: float = 1.25,
                      activation: str = "gelu"):
    """Top-1 routed expert-parallel MoE (Switch-style): tokens are
    dispatched to their expert's rank over one ``all_to_all``, processed
    there, and returned by a second ``all_to_all``.

    Shapes: ``x [n, d_in]`` (token-sharded over ``axis``: rank r routes
    rows ``[r·n/P, (r+1)·n/P)``), ``router_logits [n, E]``, ``w1 [E,
    d_in, d_ff]``, ``w2 [E, d_ff, d_out]``; ``E`` must equal the axis
    size and ``n`` divide by it. Per-rank-per-expert capacity =
    ``ceil(n_local / E * capacity_factor)``; over-capacity tokens are
    dropped (zero output). Returns the global ``[n, d_out]``.
    """
    dm = _default_mesh(mesh, "expert")
    p_size = _axis_check(dm, axis)
    n, e_count = router_logits.shape[0], router_logits.shape[1]
    if e_count != p_size or w1.shape[0] != e_count or w2.shape[0] != e_count:
        raise ValueError(
            f"expert count mismatch: logits {e_count}, w1 {w1.shape[0]}, "
            f"w2 {w2.shape[0]}, axis size {p_size}"
        )
    if n % p_size != 0 or x.shape[0] != n:
        raise ValueError(
            f"token count {n} must match x rows {x.shape[0]} and divide by "
            f"the mesh size {p_size}"
        )
    n_local = n // p_size
    capacity = max(1, math.ceil(n_local * capacity_factor / p_size))
    act = activation_fn(activation)
    group, ranks, idx = _axis(dm, axis)
    rows = slice(idx * n_local, (idx + 1) * n_local)
    xl = _on(dm, x[rows])
    expert, gate, pos, keep = route_top1(_on(dm, router_logits[rows]),
                                         capacity)
    d = xl.shape[1]
    # Each kept token in its (expert, slot); every other slot zero.
    dispatch = xl.new_zeros((e_count, capacity, d))
    dispatch[expert[keep], pos[keep]] = xl[keep]
    recv = collectives.group_all_to_all(group, ranks, dispatch)  # [P, C, d]
    h = act(recv.reshape(-1, d) @ _on(dm, w1[idx]))
    y = (h @ _on(dm, w2[idx])).reshape(recv.shape[0], capacity, -1)
    back = collectives.group_all_to_all(group, ranks, y)  # [E, C, d_out]
    combined = back.new_zeros((n_local, back.shape[2]))
    combined[keep] = back[expert[keep], pos[keep]]
    out = combined * gate.to(combined.dtype)[:, None]
    return collectives.group_all_gather(group, ranks, out)
