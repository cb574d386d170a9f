"""float16 operands of the port's four kernels, against the JAX package on
the CPU.

Each kernel's plain float16 path (the CPU form of its wrapper) is held
against the JAX function it replaces, through XLA and through the Pallas
kernel in interpret mode, on inputs made from numpy seeds. Stated
tolerances, in float16 ulps:

- ``spmv``: the port widens each cell to float32, sums the row in float32
  and rounds the sum once; the JAX kernel rounds each product to float16
  before its float32 sum (``jnp.sum`` upcasts float16). So a row agrees
  within one ulp of the result plus half an ulp (2^-11) of the sum of the
  row's |products|; a row whose sum passes 65,504 is inf in both.
- ``segment_sum``: bit for bit, flat and with a row payload, sorted and
  unsorted (both add in cell order, rounding each add to float16); the
  CUDA run-flush's own write plan at float16 too.
- ``top_k``: values (bits) and indices bit for bit with ``lax.top_k``
  (+-0 and NaN of both signs included, a NaN by its sign), and with
  ``pallas_top_k`` on rows without zeros or -NaN (the Pallas kernel ranks
  +0/-0 and NaN/-NaN as equal).

The chain under float16 policies is ``tests/test_torch_half_chain.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flinkml_tpu import kernels as jax_kernels
from flinkml_tpu.kernels.segsum import pallas_segment_sum
from flinkml_tpu.kernels.spmv import pallas_spmv
from flinkml_tpu.kernels.topk import pallas_top_k
from flinkml_tpu_torch.kernels import segsum as ksegsum
from flinkml_tpu_torch.kernels import spmv as kspmv
from flinkml_tpu_torch.kernels import topk as ktopk
from tests._torch_port_common import JAX_BACKENDS, jax_backend

NEG_NAN = np.float16(-np.nan)


def _ulp16(x: np.ndarray) -> np.ndarray:
    """One float16 ulp at |x| (the subnormal spacing below 2^-14)."""
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -14)
    return 2.0 ** (np.floor(np.log2(a)) - 10)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _same_f16(got, want) -> None:
    """Equal bits, but a NaN only by its sign (``lax.top_k`` may return a
    NaN's payload canonicalized, where the kernels return the element)."""
    g, w = _bits(got), _bits(want)
    gn = ((g & 0x7C00) == 0x7C00) & ((g & 0x3FF) != 0)
    wn = ((w & 0x7C00) == 0x7C00) & ((w & 0x3FF) != 0)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(np.where(gn, g < 0, g),
                                  np.where(wn, w < 0, w))


def _ell16(rows, width, dim, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(rows, width)).astype(np.int32)
    val = (rng.normal(size=(rows, width)) * scale).astype(np.float16)
    pad = rng.random(size=(rows, width)) < 0.2
    idx[pad], val[pad] = 0, 0
    w = rng.normal(size=dim).astype(np.float16)
    return idx, val, w


# -- spmv --------------------------------------------------------------------


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("shape", [(37, 9, 4096), (256, 39, 1000), (5, 1, 7)])
def test_spmv_f16_plain_matches_jax(backend, shape, monkeypatch):
    """float16 values and w: ``spmv`` on CPU tensors (its plain version)
    against the JAX ``kernels.spmv`` within one float16 ulp of the result
    plus 2^-11 of the row's sum of |products|."""
    rows, width, dim = shape
    idx, val, w = _ell16(rows, width, dim, seed=rows)
    jax_backend(monkeypatch, backend, "spmv")
    want = np.asarray(jax_kernels.spmv(idx, jnp.asarray(val), jnp.asarray(w)))
    assert want.dtype == np.float16
    got = kspmv.spmv(torch.from_numpy(idx), torch.from_numpy(val),
                     torch.from_numpy(w))
    assert got.dtype == torch.float16
    terms = np.abs(val.astype(np.float64) * w.astype(np.float64)[idx]).sum(1)
    diff = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert np.all(diff <= _ulp16(want) + 2.0 ** -11 * terms)


def test_spmv_f16_overflow_row_is_inf_as_in_jax():
    """A row whose sum passes 65,504: inf in the port and in the
    interpreted Pallas kernel; the other rows finite."""
    idx, val, w = _ell16(16, 8, 64, seed=3)
    idx[3], val[3], w[:] = np.arange(8), 250.0, 0.5
    w[:8] = 60.0   # row 3: 8 x 250 x 60 = 120,000
    want = np.asarray(pallas_spmv(idx, jnp.asarray(val), jnp.asarray(w),
                                  interpret=True))
    got = kspmv.spmv(torch.from_numpy(idx), torch.from_numpy(val),
                     torch.from_numpy(w)).numpy()
    assert np.isposinf(want[3]) and np.isposinf(got[3])
    ok = np.arange(16) != 3
    assert np.isfinite(got[ok]).all() and np.isfinite(want[ok]).all()


# -- segment_sum -----------------------------------------------------------------


def _segsum16(cells, k, num_segments, sorted_ids, seed, scale=7.0):
    rng = np.random.default_rng(seed)
    shape = (cells,) if k is None else (cells, k)
    values = (rng.normal(size=shape) * scale).astype(np.float16)
    if sorted_ids:
        runs = rng.integers(1, 41, size=cells)
        starts = np.sort(rng.choice(num_segments,
                                    size=min(cells, num_segments),
                                    replace=False))
        ids = np.repeat(starts, runs[:starts.size])[:cells]
        ids = np.concatenate([ids, np.full(cells - ids.size, starts[-1])])
    else:
        ids = rng.integers(0, num_segments, size=cells)
    return values, ids.astype(np.int32)


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("sorted_ids", [False, True])
@pytest.mark.parametrize("shape", [(500, None, 97), (300, 4, 40), (7, None, 3)])
def test_segment_sum_f16_plain_is_bitwise_jax(backend, sorted_ids, shape,
                                              monkeypatch):
    """float16 values: ``segment_sum`` on CPU tensors (``index_add_`` in
    cell order, each add rounded; the row payload through the flat form)
    equals the JAX ``kernels.segment_sum`` bit for bit."""
    cells, k, nseg = shape
    values, ids = _segsum16(cells, k, nseg, sorted_ids, seed=cells)
    jax_backend(monkeypatch, backend, "segment_sum")
    want = jax_kernels.segment_sum(jnp.asarray(values), ids, nseg,
                                   indices_are_sorted=sorted_ids)
    got = ksegsum.segment_sum(torch.from_numpy(values), torch.from_numpy(ids),
                              nseg, indices_are_sorted=sorted_ids)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("phase", [0, 1, 5, 7, -1])
def test_segment_sum_f16_run_flush_is_bitwise_pallas(k, phase):
    """The CUDA run-flush at float16 (its write plan with the 16-bit
    tiles' 8-cell phase, each run summed left to right from 0 and rounded
    at each add) equals the interpreted Pallas sorted kernel bit for bit."""
    values, ids = _segsum16(400, k, 60, True, seed=7, scale=3.0)
    want = pallas_segment_sum(jnp.asarray(values), ids, 60,
                              indices_are_sorted=True, interpret=True)
    tv = torch.from_numpy(values)
    v2 = tv[:, None] if tv.dim() == 1 else tv
    kk = v2.shape[1]
    group = ksegsum.phase_cells(tv)
    assert group == 8
    out = torch.full((60, kk), float("nan"), dtype=torch.float16)
    plan = ksegsum.sorted_plan(ids, 60, kk, phase if kk == 1 else -1, group)
    for seg, _, first, end in plan:
        acc = torch.zeros(kk, dtype=torch.float16)
        for j in range(first, end):
            acc = acc + v2[j]
        out[seg] = acc
    got = out[:, 0] if tv.dim() == 1 else out
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_segment_sum_f16_overflow_is_inf_as_in_jax():
    """A segment whose in-order float16 sum passes 65,504 is inf in both,
    sorted and unsorted; a later negative cell does not bring it back."""
    values = np.array([40000, 30000, -20000, 5, 7, 60000, 10000], np.float16)
    ids = np.array([0, 0, 0, 1, 2, 3, 3], np.int32)
    for sorted_ids in (False, True):
        want = pallas_segment_sum(jnp.asarray(values), ids, 5,
                                  indices_are_sorted=sorted_ids,
                                  interpret=True)
        got = ksegsum.segment_sum(torch.from_numpy(values),
                                  torch.from_numpy(ids), 5,
                                  indices_are_sorted=sorted_ids)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert np.isposinf(got.numpy()[[0, 3]]).all()


def test_segment_sum_f16_phase_and_vector_rules():
    """float16 takes the 16-bit rules: 8 cells of values a 16-byte copy on
    the sorted flat path, 2 columns a vector reduction on the unsorted
    ``[cells, k]`` path."""
    ids = torch.zeros(64, dtype=torch.int32)
    vals = torch.zeros(64, dtype=torch.float16)
    assert ksegsum.phase_cells(vals) == 8
    for start in range(8):
        ph = kspmv.vector_phase(ids[start:], vals[start:], 8)
        assert ph == (-start) % 8
    assert ksegsum.payload_vector(torch.zeros(10, 6, dtype=torch.float16)) == 2
    assert ksegsum.payload_vector(
        torch.zeros(10, 5, dtype=torch.float16)) == 1


# -- top_k ----------------------------------------------------------------------


def _topk_rows16(n=150, seed=0, signed=True):
    """Rows that pin the order (as ``test_torch_kernels._topk_rows``) at
    float16; ``signed``: +0/-0, -NaN and a signalling NaN among the NaNs
    (NaNs of two payloads, which the Pallas kernel ranks as equal)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 6, size=(8, n)).astype(np.float16)
    if signed:
        x[0, ::3], x[0, 1::3] = 0.0, -0.0
    x[1] = -np.inf
    x[2, :-7] = -np.inf
    x[3, ::4] = np.nan
    if signed:
        x.view(np.uint16)[3, 1::8] = 0x7C01    # a signalling NaN
        x[3, 2::9] = NEG_NAN
    x[4] = 2.5
    x[5] = np.arange(1, n + 1)
    x[6] = -np.arange(1, n + 1)
    return x


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("k", [1, 7, 128, 150])
def test_top_k_f16_plain_matches_lax_top_k(rank, k):
    """float16 rows: ``top_k`` on CPU tensors vs ``jax.lax.top_k`` at
    float16, values and indices bit for bit (a NaN by its sign)."""
    x = _topk_rows16(seed=k)
    rows = [x] if rank == 2 else list(x)
    for row in rows:
        want_v, want_i = jax.lax.top_k(jnp.asarray(row), k)
        got_v, got_i = ktopk.top_k(torch.from_numpy(row), k)
        assert got_v.dtype == torch.float16 and got_i.dtype == torch.int32
        _same_f16(got_v, want_v)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("k", [1, 6, 128])
def test_top_k_f16_plain_matches_pallas_away_from_signed_zeros(k):
    """float16 rows without zeros, -NaN or a second NaN payload: ``top_k``
    on CPU tensors vs
    ``pallas_top_k`` in interpret mode, bit for bit."""
    rows = np.concatenate([
        _topk_rows16(seed=k + 1, signed=False),
        np.random.default_rng(k).normal(size=(5, 150)).astype(np.float16)])
    want_v, want_i = pallas_top_k(jnp.asarray(rows), k, interpret=True)
    got_v, got_i = ktopk.top_k(torch.from_numpy(rows), k)
    _same_f16(got_v, want_v)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_top_k_f16_keeps_a_signalling_nan_and_ranks_by_32_bit_keys():
    """The values come back as the input's bits (PyTorch's 2-D float16
    gather on the CPU quiets a signalling NaN, so the plain version
    gathers bits), and the card ranks float16 by 32-bit keys."""
    x = np.zeros((2, 4), np.float16)
    x.view(np.uint16)[:] = [0x7C01, 0x3C00, 0xFC11, 0x0000]
    v, i = ktopk.top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(i.numpy()[0], [0, 1, 3, 2])
    np.testing.assert_array_equal(_bits(v)[0].view(np.uint16),
                                  [0x7C01, 0x3C00, 0x0000, 0xFC11])
    assert ktopk.key_bytes(torch.float16) == 4
    assert ktopk.route(4096, 60000, 5, ktopk.key_bytes(torch.float16)) \
        == ktopk.route(4096, 60000, 5, 4)


def test_f16_is_accepted_and_the_card_is_still_required():
    """The wrappers take float16 (no refusal reason); a tensor on a device
    that is neither the CPU nor CUDA still raises, float16 or not."""
    x16 = torch.zeros(4, 8, dtype=torch.float16)
    idx = torch.zeros(4, 8, dtype=torch.int32)
    assert kspmv.unsupported_reason(idx, x16, x16[0]) is None
    assert ksegsum.unsupported_reason(x16, idx[:, 0], 3) is None
    assert ksegsum.unsupported_reason(x16[:, 0], idx[:, 0], 3, True) is None
    assert ktopk.unsupported_reason(x16, 3) is None
    with pytest.raises(ValueError, match="not CUDA"):
        ktopk.top_k(x16.to("meta"), 3)
