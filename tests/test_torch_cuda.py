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
from flinkml_tpu_torch.kernels import spmv as kspmv

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
