"""BLAS facade — the numeric kernel layer.

The port's counterpart of ``flinkml_tpu.ops.blas`` (parity:
``flink-ml-core/.../ml/linalg/BLAS.java:26-91``): the reference's
``asum/axpy/dot/norm2/scal/gemv`` plus the batched additions ``gemm``,
``batch_dot`` and ``squared_distances``, in the same operation order.

Functions take torch tensors (anything else becomes one with
``torch.as_tensor``) and compute in the input dtype. Matrix products are
``torch.matmul`` in full precision: the port never enables TF32.
"""

from __future__ import annotations

import torch


def asum(x) -> torch.Tensor:
    """Sum of absolute values. Parity: BLAS.java asum."""
    return torch.sum(torch.abs(torch.as_tensor(x)))


def axpy(a, x, y) -> torch.Tensor:
    """a*x + y (functional: returns the result instead of mutating y)."""
    return a * torch.as_tensor(x) + torch.as_tensor(y)


def dot(x, y) -> torch.Tensor:
    """Vector dot product. Parity: BLAS.java dot."""
    return torch.dot(torch.as_tensor(x), torch.as_tensor(y))


def norm2(x) -> torch.Tensor:
    """Euclidean norm. Parity: BLAS.java norm2."""
    x = torch.as_tensor(x)
    return torch.sqrt(torch.sum(x * x))


def scal(a, x) -> torch.Tensor:
    """a*x (functional). Parity: BLAS.java scal."""
    return a * torch.as_tensor(x)


def gemv(alpha, matrix, x, beta=0.0, y=None, trans: bool = False) -> torch.Tensor:
    """alpha * op(A) @ x + beta * y. Parity: BLAS.java gemv."""
    matrix = torch.as_tensor(matrix)
    a = matrix.T if trans else matrix
    out = alpha * (a @ torch.as_tensor(x))
    if y is not None:
        out = out + beta * torch.as_tensor(y)
    return out


def gemm(a, b) -> torch.Tensor:
    """Plain matmul; inputs [m,k] @ [k,n]."""
    return torch.as_tensor(a) @ torch.as_tensor(b)


def batch_dot(xs, y) -> torch.Tensor:
    """Row-wise dot of a batch [n, d] against a vector [d] -> [n]."""
    return torch.as_tensor(xs) @ torch.as_tensor(y)


def squared_distances(xs, ys) -> torch.Tensor:
    """Pairwise squared L2 distances: [n, d] x [m, d] -> [n, m].

    ``max(x2 - 2·(xs @ ys.T) + y2, 0)`` with the reference's operation
    order: one [n,d]@[d,m] product instead of an [n, m, d] broadcast. The
    elementwise steps update the product's own buffer in place (``-t + x2``
    equals ``x2 - t`` exactly), so the [n, m] block is allocated once.
    """
    xs = torch.as_tensor(xs)
    ys = torch.as_tensor(ys)
    x2 = torch.sum(xs * xs, dim=-1, keepdim=True)
    y2 = torch.sum(ys * ys, dim=-1, keepdim=True).T
    d2 = torch.matmul(xs, ys.T)
    d2.mul_(2.0).neg_().add_(x2).add_(y2)
    return d2.clamp_min_(0.0)
