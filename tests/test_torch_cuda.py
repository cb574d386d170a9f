"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips (from a fixture, at run time)
without one. The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
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
from flinkml_tpu_torch.models import _linear_sgd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip (decided here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _ell(rows, width, dim, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(rows, width)).astype(np.int32)
    val = rng.normal(size=(rows, width))
    pad = rng.random(size=(rows, width)) < 0.2
    idx[pad], val[pad] = 0, 0.0
    return idx, val, rng.normal(size=dim)


def _five_stage(rows, d=6, seed=0):
    """The five-stage chain with statistics from float64 numpy, and its
    input (one constant feature exercises the zero guards)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)) * 2.0 + 1.0
    x[:, -1] = 2.5
    t = fml.Table({"features": x})
    stages, prev = [], "features"
    for i, cls in enumerate((fml.StandardScaler, fml.MinMaxScaler,
                             fml.MaxAbsScaler, fml.RobustScaler), start=1):
        with fml.use_device("cpu"):
            m = cls().set(cls.INPUT_COL, prev).set(cls.OUTPUT_COL, f"s{i}")
            m = m.fit(t)
            (t,) = m.transform(t)
        stages.append(m)
        prev = f"s{i}"
    lr = fml.LogisticRegressionModel().set(
        fml.LogisticRegressionModel.FEATURES_COL, prev)
    lr.set_model_data(fml.Table({"coefficient": rng.normal(size=(1, d))}))
    return fml.PipelineModel(stages + [lr]), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_kernel_matches_plain(cuda_device, dtype):
    idx, val, w = _ell(1000, 39, 100_000, seed=1)
    idx = torch.from_numpy(idx).to(cuda_device)
    val = torch.from_numpy(val).to(cuda_device, dtype)
    w = torch.from_numpy(w).to(cuda_device, dtype)
    before = kspmv.LAUNCHES.count
    got = kspmv.spmv(idx, val, w)
    torch.cuda.synchronize()
    assert kspmv.LAUNCHES.count == before + 1
    torch.testing.assert_close(got, kspmv.spmv_plain(idx, val, w),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(fml.KernelUnsupportedError):
        kspmv.spmv(idx, val.bfloat16(), w.bfloat16())
    with pytest.raises(fml.KernelUnsupportedError):
        kspmv.spmv(idx.long(), val, w)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_chain_kernel_matches_plain(cuda_device, dtype, tol):
    model, x = _five_stage(1000, seed=2)
    kernels = [s.transform_kernel() for s in model.stages]
    xp = torch.zeros((1024, x.shape[1]), dtype=dtype, device=cuda_device)
    xp[:1000] = torch.from_numpy(x).to(cuda_device, dtype)
    consts = [k.constants for k in kernels]
    for outs in (["s4", "prediction", "rawPrediction"], ["s1"], ["s3"]):
        got = kchain.ChainProgram(kernels, ["features"], outs)(
            [xp], consts, 1000)
        want = kchain.chain_plain(kernels, ["features"], outs, [xp], consts,
                                  1000)
        torch.cuda.synchronize()
        for c in outs:
            if c != "prediction":
                torch.testing.assert_close(got[c][:1000], want[c][:1000],
                                           rtol=tol, atol=tol)


def test_pipeline_fused_matches_per_stage(cuda_device):
    model, x = _five_stage(3000, seed=3)
    table = fml.Table({"features": x})
    pipeline_fusion.reset_cache()
    with fml.use_device(cuda_device):
        fml.reset_launch_counts()
        (fused,) = model.transform(table)
        got = {c: fused.column(c) for c in ("s2", "s4", "rawPrediction")}
        assert fml.launch_counts()["fused_chain"] == 2   # eager + lazy s2
        pipeline_fusion.set_enabled(False)
        try:
            (per_stage,) = model.transform(table)
        finally:
            pipeline_fusion.set_enabled(True)
    for c, tol in (("s2", 1e-12), ("s4", 1e-12), ("rawPrediction", 1e-10)):
        np.testing.assert_allclose(got[c], per_stage.column(c), rtol=tol,
                                   atol=tol)


def test_sparse_lr_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    rows = np.empty(500, dtype=object)
    for r in range(500):
        k = int(rng.integers(1, 40))
        rows[r] = fml.SparseVector(5000, rng.choice(5000, k, replace=False),
                                   rng.normal(size=k))
    model = fml.LogisticRegressionModel()
    model.set_model_data(fml.Table({"coefficient": rng.normal(size=(1, 5000))}))
    table = fml.Table({"features": rows})
    fml.reset_launch_counts()
    with fml.use_device(cuda_device):
        (gpu,) = model.transform(table)
    assert fml.launch_counts()["spmv"] >= 1
    with fml.use_device("cpu"):
        (cpu,) = model.transform(table)
    np.testing.assert_allclose(gpu.column("rawPrediction"),
                               cpu.column("rawPrediction"), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("sorted_ids", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("k", [None, 16])
def test_segment_sum_kernel_matches_plain(cuda_device, sorted_ids, dtype, tol,
                                          k):
    """Both paths against ``index_add_`` (atomics reorder the adds: within
    ``tol``); the sorted path also bit for bit against the in-order sum."""
    rng = np.random.default_rng(5)
    cells, nseg = 50_000, 3_000
    ids = rng.integers(0, nseg, size=cells).astype(np.int32)
    if sorted_ids:
        ids = np.sort(ids)
    values = rng.normal(size=(cells,) if k is None else (cells, k))
    tv = torch.from_numpy(values).to(cuda_device, dtype)
    ti = torch.from_numpy(ids).to(cuda_device)
    before = ksegsum.LAUNCHES.count
    got = ksegsum.segment_sum(tv, ti, nseg, indices_are_sorted=sorted_ids)
    torch.cuda.synchronize()
    assert ksegsum.LAUNCHES.count == before + 1
    torch.testing.assert_close(got, ksegsum.segment_sum_plain(tv, ti, nseg),
                               rtol=tol, atol=tol)
    if sorted_ids:
        want = np.zeros((nseg,) + values.shape[1:], tv.cpu().numpy().dtype)
        np.add.at(want, ids, tv.cpu().numpy())
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    with pytest.raises(fml.KernelUnsupportedError):
        ksegsum.segment_sum(tv.bfloat16(), ti, nseg)
    with pytest.raises(fml.KernelUnsupportedError):
        ksegsum.segment_sum(tv, ti.long(), nseg)
    empty = ksegsum.segment_sum(tv[:0], ti[:0], nseg)
    assert ksegsum.LAUNCHES.count == before + 1 and not empty.any()


def test_segment_sum_atomic_path_refused_when_deterministic(cuda_device):
    tv = torch.ones(10, device=cuda_device)
    ti = torch.zeros(10, dtype=torch.int32, device=cuda_device)
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(fml.KernelUnsupportedError, match="sorted"):
            ksegsum.segment_sum(tv, ti, 3)
        out = ksegsum.segment_sum(tv, ti, 3, indices_are_sorted=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert out.tolist() == [10.0, 0.0, 0.0]


def test_dense_fit_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3000, 12)).astype(np.float32)
    y = (x @ rng.normal(size=12) > 0).astype(np.float32)
    table = fml.Table({"features": x, "label": y})
    est = (fml.LogisticRegression().set_seed(1).set_global_batch_size(512)
           .set_tol(0.0).set_learning_rate(0.5))
    with fml.use_device(cuda_device):
        gpu = est.fit(table).coefficient
    with fml.use_device("cpu"):
        cpu = est.fit(table).coefficient
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["unsorted", "sorted"])
def test_sparse_fit_on_card_matches_cpu(cuda_device, layout):
    rng = np.random.default_rng(7)
    n, dim = 2000, 5000
    nnz = rng.integers(1, 40, size=n)
    indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int64)
    indices = rng.integers(0, dim, size=indptr[-1]).astype(np.int32)
    values = rng.normal(size=indptr[-1]).astype(np.float32)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    args = (indptr, indices, values, dim, y, w, "logistic", 10, 0.5, 700,
            0.001, 0.0, 0.0, 3)
    fml.reset_launch_counts()
    with fml.use_device(cuda_device):
        gpu = _linear_sgd.train_linear_model_sparse_csr(*args, layout=layout)
    counts = fml.launch_counts()
    assert counts["segment_sum"] >= 10 and counts["spmv"] >= 10
    with fml.use_device("cpu"):
        cpu = _linear_sgd.train_linear_model_sparse_csr(*args, layout=layout)
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5, atol=1e-6)
