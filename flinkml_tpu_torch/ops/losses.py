"""Margin-loss math shared by every linear trainer.

The port's counterpart of ``flinkml_tpu.ops.losses`` (reference:
``LogisticGradient.java:50-96`` for logistic; hinge and squared extend the
family): ``d loss/d margin`` and the per-example loss, in the operation
order of the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def margin_terms(loss: str, dot: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor):
    """(d loss/d margin, per-example loss), weighted.

    Labels ``y`` are {0, 1}; margin losses map them to ``ys = 2y - 1``.
    ``softplus`` is PyTorch's, which returns its input above 20 where
    ``jax.nn.softplus`` adds ``log1p(exp(-x))`` (< 2.1e-9): the
    per-example loss differs by that much there, the gradient not at all.
    """
    if loss == "logistic":
        ys = 2.0 * y - 1.0
        margin = dot * ys
        mult = w * (-ys * torch.sigmoid(-margin))
        per_ex = w * F.softplus(-margin)
    elif loss == "hinge":
        ys = 2.0 * y - 1.0
        margin = dot * ys
        active = (margin < 1.0).to(dot.dtype)
        mult = w * (-ys * active)
        per_ex = w * torch.clamp_min(1.0 - margin, 0.0)
    elif loss == "squared":
        resid = dot - y
        mult = w * resid
        per_ex = 0.5 * w * resid * resid
    else:  # pragma: no cover - guarded by callers
        raise ValueError(f"unknown loss {loss!r}")
    return mult, per_ex
