"""Sequence/context parallelism: ring attention and Ulysses all-to-all.

The port's counterpart of ``flinkml_tpu.parallel.ring``, on
``torch.distributed`` (one process per rank, the sequence split over the
mesh's first axis):

  - **Ring attention** (blockwise attention + flash-style online
    softmax): Q stays on its rank, the K/V blocks hop around the ring
    (one ``batch_isend_irecv`` a step, :func:`~flinkml_tpu_torch.
    parallel.collectives.ppermute`), and each block updates the running
    max, normaliser and unnormalised output. Peak memory per rank is
    O(L_local²) instead of O(L²).
  - **Ulysses** (all-to-all sequence parallelism): sequence-sharded
    activations become head-sharded through one ``all_to_all``, each rank
    runs plain full attention on its heads, and a second ``all_to_all``
    reshards back. Needs heads % ranks == 0.

Both compute exact attention in the JAX package's block formulation,
with ``torch.matmul``, ``exp`` and ``max``: JAX's ``ring.py`` has no
Pallas kernel, so this module has no kernel either. Inputs follow the
port's SPMD convention (every rank passes the same global ``[B, H, L,
D]`` arrays and keeps its sequence block); the result is the global
output on every rank, the blocks all-gathered in mesh order. JAX's
varying-axes typing (``pcast``) has no counterpart and needs none.
"""

from __future__ import annotations

from typing import Optional

import torch

from flinkml_tpu_torch.parallel import collectives
from flinkml_tpu_torch.parallel.mesh import DeviceMesh
from flinkml_tpu_torch.parallel.tensor import _on

_NEG = -1e30  # finite "-inf": keeps exp()/max() NaN-free on fully masked rows


def _block_update(q, k, v, m, l, o, scale, q_off, k_off, causal):
    """One blockwise attention step with online-softmax accumulators.

    q [B,H,Lq,D] against one K/V block [B,H,Lk,D]; (m, l, o) are the
    running max, normalizer, and unnormalized output.
    """
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[2], device=q.device)
        k_pos = k_off + torch.arange(k.shape[2], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask, scores, scores.new_tensor(_NEG))
    m_new = torch.maximum(m, torch.amax(scores, dim=-1, keepdim=True))
    p = torch.exp(scores - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + torch.sum(p, dim=-1, keepdim=True)
    o_new = o * alpha + torch.matmul(p, v)
    return m_new, l_new, o_new


def _finalize(m, l, o):
    # Rows with no unmasked key (l == 0) return 0 rather than NaN.
    return torch.where(l > 0, o / torch.clamp_min(l, 1e-30),
                       o.new_zeros(()))


def _ring_attention_local(q, k, v, group, ranks, idx: int, causal: bool):
    """This rank's ring pass. All inputs [B, H, L_local, D], seq-sharded."""
    p_size = len(ranks)
    l_loc = q.shape[2]
    scale = 1.0 / (q.shape[3] ** 0.5)
    m = torch.full(q.shape[:3] + (1,), _NEG, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:3] + (1,), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    kb, vb = k, v
    for s in range(p_size):
        # After s forward hops this rank holds the block that rank
        # (idx - s) mod P owns; its global key offset follows.
        src = (idx - s + p_size) % p_size
        m, l, o = _block_update(q, kb, vb, m, l, o, scale, idx * l_loc,
                                src * l_loc, causal)
        if s < p_size - 1:  # the JAX loop's last hop only brings them home
            kb, vb = collectives.ppermute(group, ranks, [kb, vb])
    return _finalize(m, l, o)


def _full_attention(q, k, v, causal: bool, q_off=0):
    """Plain full-softmax attention (the Ulysses local step and the
    one-rank path)."""
    scale = 1.0 / (q.shape[3] ** 0.5)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[2], device=q.device)
        k_pos = torch.arange(k.shape[2], device=q.device)
        scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores,
                             scores.new_tensor(_NEG))
    w = torch.softmax(scores, dim=-1)
    return torch.matmul(w, v)


def _ulysses_local(q, k, v, group, ranks, idx: int, causal: bool):
    """All-to-all reshard: seq-sharded [B,H,L/P,D] -> head-sharded
    [B,H/P,L,D], full attention, reshard back."""
    p = len(ranks)

    def seq_to_heads(x):
        b, h, lq, d = x.shape
        blocks = x.reshape(b, p, h // p, lq, d).transpose(0, 1)
        got = collectives.group_all_to_all(group, ranks, blocks.contiguous())
        # got[j]: rank j's sequence block of this rank's heads.
        return got.permute(1, 2, 0, 3, 4).reshape(b, h // p, p * lq, d)

    def heads_to_seq(x):
        b, hp, lfull, d = x.shape
        blocks = x.reshape(b, hp, p, lfull // p, d).permute(2, 0, 1, 3, 4)
        got = collectives.group_all_to_all(group, ranks, blocks.contiguous())
        # got[j]: rank j's heads of this rank's sequence block.
        return got.transpose(0, 1).reshape(b, p * hp, lfull // p, d)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    return heads_to_seq(_full_attention(qh, kh, vh, causal))


def ring_attention(q, k, v, mesh: Optional[DeviceMesh] = None,
                   causal: bool = False):
    """Exact attention over sequence-sharded Q/K/V ``[B, H, L, D]``.

    ``L`` must divide by the mesh size. K/V blocks rotate over the mesh's
    first axis with flash-style online-softmax accumulation; no rank
    materializes ``[L, L]`` scores.
    """
    dm = mesh if mesh is not None else DeviceMesh()
    return _dispatch(q, k, v, dm, "ring", causal)


def ulysses_attention(q, k, v, mesh: Optional[DeviceMesh] = None,
                      causal: bool = False):
    """Exact attention via all-to-all sequence→head resharding.

    Requires ``H % mesh_size == 0`` and ``L % mesh_size == 0``.
    """
    dm = mesh if mesh is not None else DeviceMesh()
    return _dispatch(q, k, v, dm, "ulysses", causal)


def _dispatch(q, k, v, dm: DeviceMesh, kind: str, causal: bool):
    if tuple(q.shape) != tuple(k.shape) or tuple(q.shape) != tuple(v.shape):
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if len(q.shape) != 4:
        raise ValueError(f"expected [batch, heads, seq, dim], got {q.shape}")
    axis = dm.axis_names[0]
    p_size = dm.axis_size(axis)
    if q.shape[2] % p_size != 0:
        raise ValueError(
            f"sequence length {q.shape[2]} must divide by mesh size {p_size}"
        )
    if kind == "ulysses" and q.shape[1] % p_size != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[1]}) divisible by the mesh "
            f"size ({p_size})"
        )
    if p_size == 1:
        return _full_attention(_on(dm, q), _on(dm, k), _on(dm, v), causal)
    group, ranks = dm.group_over((axis,))
    idx = dm.axis_index(axis)
    l_loc = q.shape[2] // p_size
    seq = slice(idx * l_loc, (idx + 1) * l_loc)
    local = _ring_attention_local if kind == "ring" else _ulysses_local
    out = local(_on(dm, q[:, :, seq]), _on(dm, k[:, :, seq]),
                _on(dm, v[:, :, seq]), group, ranks, idx, causal)
    # The sequence blocks, gathered in mesh order along L.
    gathered = collectives.group_all_gather(
        group, ranks, out.transpose(0, 2).contiguous())
    return gathered.transpose(0, 2)
