"""The float16 entries of the four CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs an NVIDIA GPU and skips (from a fixture, at run time)
without one. The file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_half_cuda.py -m cuda --noconftest -q

Stated tolerances: ``spmv`` float32 sums in another order, each rounded
once to float16 (one float16 ulp, 2^-10 relative, plus 1e-3 absolute for
rows that cancel); the sorted ``segment_sum`` bit for bit with the plain
version's in-order float16 adds on the CPU, the unsorted one within the
recursive-summation bound at float16's unit roundoff (2^-11) per segment
plus half an ulp of the result; ``topk`` bit for bit; the chain's float16
rows within one float16 ulp, its float16 ``rawPrediction`` within 2^-9
absolute, decisions equal away from their boundary.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.kernels import chain as kchain
from flinkml_tpu_torch.kernels import segsum as ksegsum
from flinkml_tpu_torch.kernels import spmv as kspmv
from flinkml_tpu_torch.kernels import topk as ktopk
from tests.test_torch_cuda import (
    _ell,
    _kmeans_near,
    _poison,
    _tier_both,
    _tier_chain,
    _topk_rows,
)

pytestmark = pytest.mark.cuda

HALF_INFERENCE = fml.precision.PrecisionPolicy(
    "half_inference", "float16", "float16", "float32")
HALF = fml.precision.PrecisionPolicy("half", "float16", "float32", "float32")


@pytest.fixture
def cuda_device():
    """The card, or a skip (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def test_spmv_f16_matches_plain(cuda_device):
    idx, val, w = _ell(4000, 39, 100_000, seed=5)
    idx = torch.from_numpy(idx).to(cuda_device)
    val = torch.from_numpy(val).to(cuda_device, torch.float16)
    w = torch.from_numpy(w).to(cuda_device, torch.float16)
    for start in (0, 1, 3):
        before = kspmv.LAUNCHES.count
        got = kspmv.spmv(idx[start:], val[start:], w)
        torch.cuda.synchronize()
        assert kspmv.LAUNCHES.count == before + 1
        assert got.dtype == torch.float16
        want = kspmv.spmv_plain(idx[start:], val[start:], w)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -10,
                                   atol=1e-3)


def test_spmv_f16_overflow_row_is_inf(cuda_device):
    idx = torch.arange(8, dtype=torch.int32, device=cuda_device).repeat(4, 1)
    val = torch.full((4, 8), 250.0, dtype=torch.float16, device=cuda_device)
    val[1:] = 1.0
    w = torch.full((8,), 60.0, dtype=torch.float16, device=cuda_device)
    got = kspmv.spmv(idx, val, w).cpu()
    assert torch.isposinf(got[0]) and torch.isfinite(got[1:]).all()


@pytest.mark.parametrize("k", [None, 2, 6])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 5)])
def test_segment_sum_f16_matches_plain(cuda_device, k, offsets):
    """float16 values: the sorted run-flush bit for bit with the plain
    version's in-order adds (on the CPU), every element written; the
    unsorted reductions within float16 rounding of the exact sum."""
    rng = np.random.default_rng(8)
    cells, nseg = 20_000, 1500
    ids = np.sort(rng.integers(0, nseg, size=cells)).astype(np.int32)
    shape = (cells,) if k is None else (cells, k)
    vals = torch.from_numpy(rng.normal(size=shape)).to(torch.float16)
    oi, ov = offsets
    ti = torch.zeros(cells + oi, dtype=torch.int32, device=cuda_device)[oi:]
    tv = torch.zeros((cells + ov,) + shape[1:], dtype=torch.float16,
                     device=cuda_device)[ov:]
    ti.copy_(torch.from_numpy(ids))
    tv.copy_(vals)
    want = ksegsum.segment_sum_plain(vals, torch.from_numpy(ids), nseg)
    _poison((nseg,) + shape[1:], torch.float16, cuda_device)
    before = ksegsum.LAUNCHES.count
    got = ksegsum.segment_sum(tv, ti, nseg, indices_are_sorted=True)
    torch.cuda.synchronize()
    assert ksegsum.LAUNCHES.count == before + 1
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    loose = ksegsum.segment_sum(tv, ti, nseg)
    torch.cuda.synchronize()
    assert loose.dtype == torch.float16
    ids_t = torch.from_numpy(ids).long()
    exact = torch.zeros((nseg,) + shape[1:], dtype=torch.float64) \
        .index_add_(0, ids_t, vals.double())
    mag = torch.zeros((nseg,) + shape[1:], dtype=torch.float64) \
        .index_add_(0, ids_t, vals.double().abs())
    count = torch.bincount(ids_t, minlength=nseg).double().reshape(
        (nseg,) + (1,) * (len(shape) - 1))
    bound = torch.clamp(count * 2.0 ** -11, max=1.0) * mag \
        + loose.cpu().double().abs() * 2.0 ** -11
    assert bool(((loose.cpu().double() - exact).abs() <= bound).all())


def test_segment_sum_f16_repair_on_ids_that_do_not_ascend(cuda_device):
    """Ids that do not ascend under ``indices_are_sorted=True``: the repair
    pass (float16 reductions) returns the sum into zeros."""
    ids = torch.tensor([0, 0, 7, 1, 1], dtype=torch.int32)
    vals = torch.tensor([1.5, 2.0, 3.0, 0.25, 0.5], dtype=torch.float16)
    want = ksegsum.segment_sum_plain(vals, ids, 9)
    got = ksegsum.segment_sum(vals.to(cuda_device), ids.to(cuda_device), 9,
                              indices_are_sorted=True)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k", [1, 5, 128, 1000, 20_000])
@pytest.mark.parametrize("shape", [(9, 300), (3, 70_000), (300, 60_000)])
def test_topk_f16_matches_plain_bitwise(cuda_device, k, shape):
    """float16 rows on every route: values (bits) and indices equal the
    plain version's."""
    n = shape[-1]
    k = min(k, n)
    host = torch.from_numpy(_topk_rows(shape, seed=k)).to(torch.float16)
    x = host.to(cuda_device)
    before = ktopk.LAUNCHES.count
    got_v, got_i = ktopk.top_k(x, k)
    torch.cuda.synchronize()
    assert ktopk.LAUNCHES.count == before + 1
    want_v, want_i = ktopk.top_k_plain(host, k)
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_v.cpu().view(torch.int16), want_v.view(torch.int16))


def _half_close(got, want, rows, kernels, policy):
    """Each output's dtype equal; float16 rows within one ulp, float16
    ``rawPrediction`` within 2^-9, float32 within 1e-5, float64 1e-10; LR
    decisions equal away from a 2^-5 margin (at most 5% of the rows
    within it), KMeans assignments away from near ties."""
    for c, g in got.items():
        g, w = g[:rows], want[c][:rows]
        assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
        if c == "prediction":
            continue
        if g.dtype == torch.float16:
            tol = dict(rtol=2 ** -9, atol=2 ** -9) if c == "rawPrediction" \
                else dict(rtol=2 ** -10, atol=0.0)
        elif g.dtype == torch.float32:
            tol = dict(rtol=1e-5, atol=1e-5)
        else:
            tol = dict(rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(g.double(), w.double(), **tol)
    if "prediction" not in got:
        return
    g, w = got["prediction"][:rows], want["prediction"][:rows]
    if "rawPrediction" in want:
        top2 = torch.topk(want["rawPrediction"][:rows].double(), 2,
                          dim=1).values
        margin = (top2[:, 0] - top2[:, 1]) > 2 ** -5
        assert int((~margin).sum()) <= 0.05 * rows
    else:
        cen = pipeline_fusion._tier_consts(kernels, policy)[-1]["centroids"]
        margin = ~_kmeans_near(want[kernels[-1].input_cols[0]][:rows],
                               kchain.boundary_const(policy, cen, g.device))
        assert (g == w).double().mean() >= 0.95
    assert torch.equal(g[margin], w[margin])


@pytest.mark.parametrize("policy", [HALF_INFERENCE, HALF],
                         ids=["half_inference", "half"])
@pytest.mark.parametrize("case", ["five", "prologue", "multinomial",
                                  "kmeans"])
@pytest.mark.parametrize("aligned", [True, False])
def test_chain_half_tiers_match_plain(cuda_device, case, policy, aligned):
    """Every tier chain on both routes under the float16 policies: the
    ``f16`` entry (or, on the census prologue's float64 row, the tier
    entry rounding to float16) against the plain chain at the same policy
    on the card; ``half`` refuses the KMeans head before anything is
    built."""
    stages, cols = _tier_chain(case, 3000, seed=41)
    kernels = [s.transform_kernel() for s in stages]
    if case == "kmeans" and policy is HALF:
        with pytest.raises(fml.PrecisionValidationError):
            pipeline_fusion.check_precision(
                kernels, [k.constants for k in kernels], HALF)
        return
    got, want = _tier_both(kernels, cols, cuda_device, 3000, policy,
                           aligned)
    _half_close(got, want, 3000, kernels, policy)


def test_half_pipeline_on_card(cuda_device):
    """Through the executor: the five-stage pipeline under
    ``half_inference`` on the card, one launch, against the same pipeline
    on the CPU."""
    stages, cols = _tier_chain("five", 2000, seed=42)
    model = fml.PipelineModel(stages)
    table = fml.Table(cols)
    pipeline_fusion.reset_cache()
    with pipeline_fusion.precision_scope(HALF_INFERENCE):
        with fml.use_device(cuda_device):
            fml.reset_launch_counts()
            (gpu,) = model.transform(table)
            raw = gpu.column("rawPrediction")
            assert fml.launch_counts()["fused_chain"] == 1
        with fml.use_device("cpu"):
            (cpu,) = model.transform(table)
    np.testing.assert_allclose(raw, cpu.column("rawPrediction"),
                               rtol=2 ** -9, atol=2 ** -9)
