"""The port's kernel modules (``flinkml_tpu_torch.kernels``): each plain
PyTorch version against the JAX function it replaces, run through XLA and
through the Pallas kernel in interpret mode; the host side of the CUDA
``fused_chain`` (chain plans, refusals, the packed constant table — held
against the plain chain by a numpy model of the kernel's arithmetic); the
CUDA ``segment_sum``'s sorted run-flush, held bit for bit against the
Pallas kernel by a Python model of its chunking; ``top_k_plain`` bit for
bit against ``jax.lax.top_k`` and, away from signed zeros, the Pallas
``pallas_top_k`` in interpret mode; the build module. The CUDA kernels
themselves are held against their plain versions on the card by
``tests/test_torch_cuda.py``."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu import kernels as jax_kernels
from flinkml_tpu.kernels.topk import pallas_top_k
from flinkml_tpu_torch.api import ColumnKernel
from flinkml_tpu_torch.kernels import _build, _gate
from flinkml_tpu_torch.kernels import chain as kchain
from flinkml_tpu_torch.kernels import segsum as ksegsum
from flinkml_tpu_torch.kernels import spmv as kspmv
from flinkml_tpu_torch.kernels import topk as ktopk
from tests._torch_port_common import (  # noqa: F401
    F32_ATOL,
    F32_RTOL,
    F64_RAW_RTOL,
    F64_SCALER_RTOL,
    JAX_BACKENDS,
    SPARSE_TOL,
    dense_data,
    five_stage_pair,
    jax_backend,
    jax_chain,
    on_cpu,
)


def _ell(rows, width, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(rows, width)).astype(np.int32)
    val = rng.normal(size=(rows, width)).astype(dtype)
    # ELL padding cells: index 0, value 0.
    pad = rng.random(size=(rows, width)) < 0.2
    idx[pad], val[pad] = 0, 0
    w = rng.normal(size=dim).astype(dtype)
    return idx, val, w


# -- spmv ------------------------------------------------------------------------

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(37, 9, 4096), (256, 39, 1000), (5, 1, 7)])
def test_spmv_plain_matches_jax(backend, dtype, shape, monkeypatch):
    """spmv_plain vs the JAX ``kernels.spmv`` (XLA gather-sum, or
    ``pallas_spmv`` interpreted) at rtol/atol 1e-5."""
    rows, width, dim = shape
    idx, val, w = _ell(rows, width, dim, dtype, seed=rows)
    jax_backend(monkeypatch, backend, "spmv")
    want = np.asarray(jax_kernels.spmv(idx, val, w))
    got = kspmv.spmv(torch.from_numpy(idx), torch.from_numpy(val),
                     torch.from_numpy(w))
    assert got.dtype == torch.from_numpy(val).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=SPARSE_TOL,
                               atol=SPARSE_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("width", [1, 7, 40, 1000])
def test_spmv_plain_matches_jitted_jax_twin(dtype, width):
    """spmv_plain at the widths the packer's DP picks, against the jitted
    JAX twin ``sum(values * take(w, indices), axis=1)`` at rtol/atol 1e-5,
    on a bucket view that starts at an odd row."""
    idx, val, w = _ell(23, width, 5000, dtype, seed=width)
    want = jax.jit(lambda i, v, ww: jnp.sum(v * jnp.take(ww, i, axis=0),
                                            axis=1))(idx[3:], val[3:], w)
    ti, tv = torch.from_numpy(idx)[3:], torch.from_numpy(val)[3:]
    got = kspmv.spmv(ti, tv, torch.from_numpy(w))
    assert got.shape == (20,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SPARSE_TOL, atol=SPARSE_TOL)


def test_spmv_vector_phase():
    """The cell phase at which indices and values both start a 16-byte
    group, read from the base pointers of a bucket view."""
    idx = torch.zeros((8, 39), dtype=torch.int32)
    for dtype in (torch.float32, torch.float64):
        val = torch.zeros((8, 39), dtype=dtype)
        assert kspmv.vector_phase(idx, val) == 0
        for start in range(1, 5):
            # Row `start` begins at cell 39 * start: the next aligned cell
            # of both arrays is (-39 * start) mod 4 cells later.
            assert kspmv.vector_phase(idx[start:], val[start:]) == (
                -39 * start) % 4
    # Indices and values whose alignments disagree: no vector phase.
    flat = torch.zeros(64, dtype=torch.float32)
    assert kspmv.vector_phase(idx.reshape(-1)[1:], flat[2:]) == -1


def test_spmv_unsupported_reasons():
    idx, val, w = (torch.from_numpy(a) for a in _ell(4, 3, 10, np.float32, 0))
    assert kspmv.unsupported_reason(idx, val, w) is None
    assert "int32" in kspmv.unsupported_reason(idx.long(), val, w)
    assert "bfloat16" in kspmv.unsupported_reason(
        idx, val.bfloat16(), w.bfloat16())
    assert "!=" in kspmv.unsupported_reason(idx, val, w.double())
    assert "rank" in kspmv.unsupported_reason(idx, val, w[None])
    assert "shape" in kspmv.unsupported_reason(idx[:2], val, w)


# -- fused_chain -------------------------------------------------------------------

def _port_kernels(port_model):
    return [s.transform_kernel() for s in port_model.stages]


def _padded(x, bucket):
    xp = np.zeros((bucket,) + x.shape[1:], x.dtype)
    xp[: x.shape[0]] = x
    return torch.from_numpy(xp)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("rows", [6, 50, 300])
def test_chain_plain_matches_jax_f64(backend, rows, on_cpu):
    """The plain chain vs the JAX chain function (XLA, and the Pallas
    kernel interpreted) over the five-stage chain, float64."""
    x, coef = dense_data(rows=300)
    jax_model, port = five_stage_pair(x, coef)
    x = x[:rows]
    want = jax_chain(jax_model, x, backend)
    kernels = _port_kernels(port)
    outs = ["s1", "s2", "s3", "s4", "prediction", "rawPrediction"]
    got = kchain.fused_chain(kernels, ["features"], outs,
                             [_padded(x, max(8, 1 << (rows - 1).bit_length()))],
                             rows)
    got = {c: v[:rows].numpy() for c, v in got.items()}
    for c in ("s1", "s2", "s3", "s4"):
        assert got[c].dtype == want[c].dtype
        np.testing.assert_allclose(got[c], want[c], rtol=F64_SCALER_RTOL,
                                   atol=F64_SCALER_RTOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL)
    dot = want["s4"] @ coef
    decisive = np.abs(dot) > 1e-9
    np.testing.assert_array_equal(got["prediction"][decisive],
                                  want["prediction"][decisive])


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_chain_plain_matches_jax_f32(backend, on_cpu):
    """Float32 input: the scalers stay float32 in both packages; the port's
    LR head computes in float32 where the JAX package's (under x64)
    computes in float64 — hence the float32 tolerance."""
    x, coef = dense_data(rows=200, seed=4)
    jax_model, port = five_stage_pair(x, coef)
    x32 = x.astype(np.float32)
    want = jax_chain(jax_model, x32, backend)
    got = kchain.fused_chain(_port_kernels(port), ["features"],
                             ["s4", "prediction", "rawPrediction"],
                             [_padded(x32, 256)], 200)
    got = {c: v[:200].numpy() for c, v in got.items()}
    assert got["s4"].dtype == want["s4"].dtype == np.float32
    np.testing.assert_allclose(got["s4"], want["s4"], rtol=F32_RTOL,
                               atol=F32_ATOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=F32_RTOL, atol=F32_ATOL)


def _kernel_model(plan, table, ops, x):
    """numpy model of csrc/chain.cu's arithmetic over the packed table."""
    d = x.shape[1]
    stride = 2 * d + 2
    v = x.copy()
    for s in range(plan.n_run):
        op = (ops >> (3 * s)) & 7
        st = table[s * stride:(s + 1) * stride]
        a, b, scale, offset = st[:d], st[d:2 * d], st[2 * d], st[2 * d + 1]
        if op & 1:
            v = np.where(b > 0, (v - a) / np.where(b > 0, b, 1), v.dtype.type(0.5))
            v = v * scale + offset
        else:
            if op & 2:
                v = v - a
            if op & 4:
                v = v / b
    out = {}
    if plan.out_col is not None:
        out[plan.out_col] = v
    if plan.head:
        dot = v @ table[plan.n_run * stride:]
        p = 1 / (1 + np.exp(-dot))
        out[plan.pred_col] = (dot >= 0).astype(v.dtype)
        out[plan.raw_col] = np.stack([1 - p, p], axis=-1)
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("outs", [("s4", "prediction", "rawPrediction"),
                                  ("s1",), ("s2",), ("s3",)])
def test_packed_table_reproduces_plain_chain(dtype, outs, on_cpu):
    """The table the host packs for the CUDA kernel (constants cast to the
    compute dtype before the zero guards, MinMax spans, op bits) gives the
    plain chain's scaler outputs exactly, eager and truncated."""
    x, coef = dense_data(rows=64, seed=5)
    _, port = five_stage_pair(x, coef)
    kernels = _port_kernels(port)
    x = x.astype(dtype)
    plan = kchain.plan_chain(kernels, ["features"], outs)
    table, ops = kchain.pack_table(plan, kernels,
                                   [k.constants for k in kernels],
                                   np.dtype(dtype), x.shape[1])
    assert table.dtype == dtype
    got = _kernel_model(plan, table, ops, x)
    want = kchain.chain_plain(kernels, ["features"], outs,
                              [torch.from_numpy(x)],
                              [k.constants for k in kernels], 64)
    for c in outs:
        w = want[c].numpy()
        if c == "rawPrediction":
            np.testing.assert_allclose(got[c], w, rtol=F32_RTOL, atol=F32_ATOL)
        elif c != "prediction":
            np.testing.assert_array_equal(got[c], w)


def test_chain_plans():
    x, coef = dense_data(rows=20)
    _, port = five_stage_pair(x, coef)
    k = _port_kernels(port)
    eager = kchain.plan_chain(k, ["features"], ["s4", "prediction",
                                                "rawPrediction"])
    assert (eager.n_run, eager.out_col, eager.head) == (4, "s4", True)
    lazy = kchain.plan_chain(k, ["features"], ["s2"])
    assert (lazy.n_run, lazy.out_col, lazy.head) == (2, "s2", False)
    scalers_only = kchain.plan_chain(k[:3], ["features"], ["s3"])
    assert (scalers_only.n_run, scalers_only.head) == (3, False)


def test_chain_refusals():
    x, coef = dense_data(rows=20)
    _, port = five_stage_pair(x, coef)
    k = _port_kernels(port)
    refuse = pytest.raises(fml.KernelUnsupportedError, match="fused_chain")
    with refuse:
        kchain.plan_chain([], [], ["s1"])
    with refuse:   # LR alone: no scaler stage
        kchain.plan_chain(k[4:], ["s4"], ["prediction", "rawPrediction"])
    with refuse:   # a stage the kernel has no op for
        other = ColumnKernel(("s4",), ("o",), fn=None,
                             fingerprint=("OneHotEncoderModel", "s4", "o"))
        kchain.plan_chain(k[:4] + [other], ["features"], ["o"])
    with refuse:   # not a linear chain
        kchain.plan_chain([k[0], k[2]], ["features"], ["s3"])
    with refuse:   # two intermediate outputs in one launch
        kchain.plan_chain(k, ["features"], ["s1", "s2"])
    with refuse:   # more stages than the op word holds
        many = [dataclasses.replace(k[0], input_cols=(f"c{i}",),
                                    output_cols=(f"c{i + 1}",))
                for i in range(kchain.MAX_STAGES + 1)]
        kchain.plan_chain(many, ["c0"], [f"c{kchain.MAX_STAGES + 1}"])
    multinomial = dataclasses.replace(
        k[4], fingerprint=k[4].fingerprint[:4] + (True,))
    with refuse:
        kchain.plan_chain(k[:4] + [multinomial], ["features"],
                          ["s4", "prediction", "rawPrediction"])
    program = kchain.ChainProgram(k, ["features"], ["s1"])
    with refuse:   # CPU tensors never reach the CUDA program
        program([torch.zeros(8, x.shape[1])], [kk.constants for kk in k], 4)


def test_pack_table_refuses_dim_mismatch():
    x, coef = dense_data(rows=20)
    _, port = five_stage_pair(x, coef)
    k = _port_kernels(port)
    plan = kchain.plan_chain(k, ["features"], ["s4", "prediction",
                                               "rawPrediction"])
    with pytest.raises(ValueError, match="dim"):
        kchain.pack_table(plan, k, [kk.constants for kk in k],
                          np.dtype(np.float64), x.shape[1] + 1)


# -- segment_sum -------------------------------------------------------------------

#: Cells per thread of the CUDA sorted run-flush (``csrc/segsum.cu`` kChunk).
SEGSUM_CHUNK = 16


def _segsum_inputs(cells, k, num_segments, dtype, sorted_ids, seed):
    """Seeded values and int32 ids; sorted ids come in runs of 1..40 cells,
    so runs start, end inside and span the kernel's 16-cell chunks."""
    rng = np.random.default_rng(seed)
    shape = (cells,) if k is None else (cells, k)
    values = rng.normal(size=shape).astype(dtype)
    if sorted_ids:
        runs = rng.integers(1, 41, size=cells)
        starts = np.sort(rng.choice(num_segments, size=min(cells, num_segments),
                                    replace=False))
        ids = np.repeat(starts, runs[:starts.size])[:cells]
        ids = np.concatenate([ids, np.full(cells - ids.size, starts[-1])])
    else:
        ids = rng.integers(0, num_segments, size=cells)
    return values, ids.astype(np.int32)


def _run_flush_model(values, ids, num_segments, chunk=SEGSUM_CHUNK):
    """The CUDA sorted kernel's arithmetic, thread by thread: each
    (chunk, column) skips the run entering from the left, sums every run
    that starts in its chunk left to right from 0 (reading past the chunk
    end) and stores it once."""
    v2 = values[:, None] if values.ndim == 1 else values
    cells, k = v2.shape
    out = np.zeros((num_segments, k), values.dtype)
    for lo in range(0, cells, chunk):
        hi = min(lo + chunk, cells)
        for c in range(k):
            j = lo
            while 0 < j < hi and ids[j] == ids[lo - 1]:
                j += 1
            while j < hi:
                seg, acc = ids[j], values.dtype.type(0)
                while True:
                    acc = values.dtype.type(acc + v2[j, c])
                    j += 1
                    if j >= cells or ids[j] != seg:
                        break
                out[seg, c] = acc
    return out[:, 0] if values.ndim == 1 else out


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("sorted_ids", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(500, None, 97), (300, 4, 40), (7, None, 3)])
def test_segment_sum_plain_matches_jax(backend, sorted_ids, dtype, shape,
                                       monkeypatch):
    """segment_sum_plain vs the JAX ``kernels.segment_sum`` (XLA, or
    ``pallas_segment_sum`` interpreted), flat and row payload, at rtol/atol
    1e-6 (f32; 1e-12 f64): both sum in element order on the CPU."""
    cells, k, nseg = shape
    values, ids = _segsum_inputs(cells, k, nseg, dtype, sorted_ids, seed=cells)
    jax_backend(monkeypatch, backend, "segment_sum")
    want = np.asarray(jax_kernels.segment_sum(
        values, ids, nseg, indices_are_sorted=sorted_ids))
    got = ksegsum.segment_sum(torch.from_numpy(values), torch.from_numpy(ids),
                              nseg, indices_are_sorted=sorted_ids)
    assert got.dtype == torch.from_numpy(values).dtype
    tol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [None, 3])
def test_segment_sum_run_flush_model_is_bitwise_pallas(dtype, k):
    """The CUDA run-flush's chunked order (modelled in numpy) equals the
    Pallas sorted kernel bit for bit — runs shorter than, equal to and
    longer than a chunk, crossing chunk boundaries."""
    from flinkml_tpu.kernels.segsum import pallas_segment_sum

    values, ids = _segsum_inputs(400, k, 60, dtype, True, seed=7)
    assert np.max(np.bincount(ids)) > 2 * SEGSUM_CHUNK
    want = np.asarray(pallas_segment_sum(values, ids, 60,
                                         indices_are_sorted=True,
                                         interpret=True))
    np.testing.assert_array_equal(_run_flush_model(values, ids, 60), want)


def test_segment_sum_empty_inputs():
    """Zero cells or zero segments: zeros of the output shape."""
    v = torch.zeros(0, 3, dtype=torch.float32)
    out = ksegsum.segment_sum(v, torch.zeros(0, dtype=torch.int32), 5)
    assert out.shape == (5, 3) and not out.any()
    out = ksegsum.segment_sum(torch.zeros(0), torch.zeros(0, dtype=torch.int32), 0)
    assert out.shape == (0,)


def test_segment_sum_unsupported_reasons():
    v = torch.ones(6, dtype=torch.float32)
    ids = torch.zeros(6, dtype=torch.int32)
    assert ksegsum.unsupported_reason(v, ids, 4) is None
    assert "int32" in ksegsum.unsupported_reason(v, ids.long(), 4)
    assert "bfloat16" in ksegsum.unsupported_reason(v.bfloat16(), ids, 4)
    assert "rows" in ksegsum.unsupported_reason(v[:5], ids, 4)
    assert "rank" in ksegsum.unsupported_reason(v[None, None], ids, 4)
    assert "rank" in ksegsum.unsupported_reason(v, ids[None], 4)
    assert "32-bit" in ksegsum.unsupported_reason(v, ids, 2**31)
    with pytest.raises(fml.KernelUnsupportedError, match="not CUDA"):
        ksegsum.segment_sum(v.to("meta"), ids.to("meta"), 4)


def test_segment_sum_unsorted_refused_in_deterministic_mode():
    """The atomic path adds in a run-dependent order: under PyTorch's
    deterministic mode it is refused, naming the sorted layout."""
    v = torch.ones(6, dtype=torch.float32)
    ids = torch.zeros(6, dtype=torch.int32)
    torch.use_deterministic_algorithms(True)
    try:
        reason = ksegsum.unsupported_reason(v, ids, 4)
        assert ksegsum.unsupported_reason(v, ids, 4,
                                          indices_are_sorted=True) is None
    finally:
        torch.use_deterministic_algorithms(False)
    assert 'layout="sorted"' in reason and "deterministic" in reason


# -- topk --------------------------------------------------------------------------

NEG_NAN = np.frombuffer(np.array([0xFFF8000000000000], np.uint64).tobytes(),
                        np.float64)[0]


def _topk_rows(dtype, n=150, seed=0, signed=True):
    """Rows that pin the order: integer values (many duplicates), an
    all--inf row, a row with -inf in most places, NaN, a constant row,
    ascending and descending rows, and (``signed``) +0/-0 and -NaN."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 6, size=(8, n)).astype(dtype)
    if signed:
        x[0, ::3], x[0, 1::3] = 0.0, -0.0
    x[1] = -np.inf
    x[2, :-7] = -np.inf
    x[3, ::4] = np.nan
    if signed:
        x[3, 2::9] = NEG_NAN
    x[4] = 2.5
    x[5] = np.arange(1, n + 1)
    x[6] = -np.arange(1, n + 1)
    return x


def _same_bits(got, want) -> bool:
    return np.asarray(got).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("k", [1, 7, 128, 150, 129, 1000, "n"])
def test_top_k_plain_matches_lax_top_k(dtype, rank, k):
    """top_k_plain vs ``jax.lax.top_k`` (the JAX package's default
    backend): values and indices bit for bit, ±0 and NaN included, past
    the 128 kept pairs of the Pallas kernel and up to k = n."""
    if k == "n":
        n, k = 1000, 1000
    else:
        n = 150 if k <= 150 else k + 500
    x = _topk_rows(dtype, n=n, seed=k)
    for row in ([x] if rank == 2 else list(x)):
        want_v, want_i = jax.lax.top_k(jnp.asarray(row), k)
        got_v, got_i = ktopk.top_k(torch.from_numpy(row), k)
        assert got_i.dtype == torch.int32
        assert got_v.dtype == torch.from_numpy(row).dtype
        assert _same_bits(got_v.numpy(), want_v)
        assert _same_bits(got_i.numpy(), want_i)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 6, 128])
def test_top_k_plain_matches_pallas_away_from_signed_zeros(dtype, k):
    """top_k_plain vs ``pallas_top_k`` in interpret mode, bit for bit on
    rows without zeros or -NaN (the Pallas kernel's max ranks +0 and -0
    as equal, and -NaN as NaN)."""
    x = _topk_rows(dtype, seed=k + 1, signed=False)
    x = np.concatenate([x, np.random.default_rng(k).normal(size=(5, 150))
                        .astype(dtype)])
    want_v, want_i = pallas_top_k(jnp.asarray(x), k, interpret=True)
    got_v, got_i = ktopk.top_k(torch.from_numpy(x), k)
    assert _same_bits(got_v.numpy(), want_v)
    assert _same_bits(got_i.numpy(), want_i)


def test_top_k_signed_zero_follows_lax_top_k():
    """+0 ranks above -0 as in ``lax.top_k``; the Pallas kernel ties them
    (a fault of the reference: its docstring promises lax.top_k's order)."""
    row = np.array([0.0, -0.0, 1.0, np.nan, 1.0, -np.inf, 0.0, -0.0],
                   np.float32)
    got_v, got_i = ktopk.top_k(torch.from_numpy(row), 6)
    want_v, want_i = jax.lax.top_k(jnp.asarray(row), 6)
    assert got_i.tolist() == [3, 2, 4, 0, 6, 1] == np.asarray(want_i).tolist()
    assert _same_bits(got_v.numpy(), want_v)
    assert np.signbit(got_v.numpy()).tolist() == [False] * 5 + [True]
    _, pallas_i = pallas_top_k(jnp.asarray(row), 6, interpret=True)
    assert np.asarray(pallas_i).tolist() == [3, 2, 4, 0, 1, 6]


def test_top_k_order_keys_are_total_order():
    vals = np.array([NEG_NAN, -np.inf, -1.0, -0.0, 0.0, 1e-300, 1.0, np.inf,
                     np.nan])
    keys = ktopk.order_keys(torch.from_numpy(vals))
    assert bool(torch.all(keys[1:] > keys[:-1]))
    keys32 = ktopk.order_keys(torch.from_numpy(vals.astype(np.float32)))
    assert keys32.dtype == torch.int32
    assert bool(torch.all(keys32[1:] >= keys32[:-1]))


def test_top_k_unsupported_reasons():
    x = torch.zeros(4, 200)
    assert ktopk.unsupported_reason(x, 5) is None
    assert ktopk.unsupported_reason(x.double(), 128) is None
    assert "not supported" in ktopk.unsupported_reason(x.int(), 5)
    assert "not supported" in ktopk.unsupported_reason(x.bfloat16(), 5)
    assert "outside" in ktopk.unsupported_reason(x, 0)
    assert "outside" in ktopk.unsupported_reason(x[:, :3], 4)
    assert ktopk.unsupported_reason(x, 129) is None
    assert ktopk.unsupported_reason(x, 200) is None   # k = n
    assert "rank" in ktopk.unsupported_reason(x[None], 5)
    big = torch.empty(2**31, device="meta")
    assert "32-bit" in ktopk.unsupported_reason(big, 5)
    with pytest.raises(fml.KernelUnsupportedError, match="not CUDA"):
        ktopk.top_k(torch.zeros(10, device="meta"), 3)


def test_top_k_plain_domain():
    """The plain version keeps lax.top_k's domain: any 0 <= k <= n, and
    only floating operands (the CUDA kernel takes 1 <= k <= n)."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 300)))
    v, i = ktopk.top_k(x, 300)
    assert v.shape == (3, 300) and bool(torch.all(v[:, 1:] <= v[:, :-1]))
    assert ktopk.top_k(x, 0)[0].shape == (3, 0)
    with pytest.raises(ValueError, match="outside"):
        ktopk.top_k(x, 301)
    with pytest.raises(TypeError, match="floating"):
        ktopk.top_k(torch.arange(10), 3)


@pytest.mark.parametrize("rows,n,k,dtype,want", [
    (4096, 60_000, 5, torch.float32, "scan"),      # the KNN chunk
    (4096, 60_000, 12, torch.float32, "scan"),
    (4096, 60_000, 16, torch.float32, "radix"),    # past the crossover
    (4096, 60_000, 200, torch.float32, "radix"),
    (1024, 8192, 16, torch.float32, "fused"),
    (1024, 8192, 1024, torch.float32, "fused"),
    (256, 2048, 128, torch.float32, "fused"),
    (1, 1312, 100, torch.float64, "fused"),        # an LSH query
    (1, 1_000_000, 100, torch.float64, "radix"),
    (1, 1_000_000, 20_000, torch.float64, "radix"),
    (100, 60_000, 5, torch.float32, "radix"),      # too few rows to scan
    (1, 16_384, 16_384, torch.float64, "radix"),   # the sort buffer spills
])
def test_top_k_route_rule(rows, n, k, dtype, want):
    """The fixed rule that picks the kernel's route, at the main paths'
    shapes; a long row with few rows splits into segments."""
    item = torch.empty(0, dtype=dtype).element_size()
    assert ktopk.route(rows, n, k, item) == want
    if want == "fused":
        assert ktopk.fused_smem_bytes(n, k, item) <= ktopk.FUSED_SMEM_BYTES
    assert ktopk.segments(rows, n) == (1 if rows >= ktopk.TARGET_BLOCKS
                                       else min(-(-264 // rows),
                                                n // 2048, 1024) or 1)


def test_top_k_fused_smem_bytes():
    # [256, 2048] f32, k=128: 8 KB of keys and 128 pairs of 8 bytes.
    assert ktopk.fused_smem_bytes(2048, 128, 4) == 2048 * 4 + 128 * 8
    # Keys pad to 16 bytes; the sort buffer to a power of two.
    assert ktopk.fused_smem_bytes(67, 10, 8) == 68 * 8 + 16 * 12
    assert ktopk.fused_smem_bytes(5, 1, 4) == 8 * 4 + 1 * 8
    assert set(ktopk.ROUTES) == {"fused", "scan", "radix"}


# -- build and launch bookkeeping -----------------------------------------------------

def test_build_sources_and_library_names():
    assert _build.sources() == ["chain", "segsum", "spmv", "topk"]
    path = _build._library_path("spmv")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_launch_counters_only_count_kernel_launches(on_cpu):
    assert set(fml.launch_counts()) == set(_gate.SITES) == {
        "fused_chain", "segment_sum", "spmv", "topk"}
    fml.reset_launch_counts()
    idx, val, w = (torch.from_numpy(a) for a in _ell(4, 3, 10, np.float32, 0))
    kspmv.spmv(idx, val, w)   # plain versions: not launches
    ksegsum.segment_sum(val.reshape(-1), idx.reshape(-1), 10)
    ktopk.top_k(val, 2)
    assert fml.launch_counts() == {"fused_chain": 0, "segment_sum": 0,
                                   "spmv": 0, "topk": 0}
    with pytest.raises(ValueError):
        _gate.LaunchCounter("not_a_site")
