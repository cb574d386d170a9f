"""The port's kernel modules (``flinkml_tpu_torch.kernels``): each plain
PyTorch version against the JAX function it replaces, run through XLA and
through the Pallas kernel in interpret mode; the host side of the CUDA
``fused_chain`` (chain plans, refusals, the packed constant table — held
against the plain chain by a numpy model of the kernel's arithmetic); the
build module. The CUDA kernels themselves are held against their plain
versions on the card by ``tests/test_torch_cuda.py``."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu import kernels as jax_kernels
from flinkml_tpu_torch.api import ColumnKernel
from flinkml_tpu_torch.kernels import _build, _gate
from flinkml_tpu_torch.kernels import chain as kchain
from flinkml_tpu_torch.kernels import spmv as kspmv
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


# -- build and launch bookkeeping -----------------------------------------------------

def test_build_sources_and_library_names():
    assert _build.sources() == ["chain", "spmv"]
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
    assert set(fml.launch_counts()) == {"fused_chain", "spmv"}
    assert set(fml.launch_counts()) <= set(_gate.SITES)
    fml.reset_launch_counts()
    idx, val, w = (torch.from_numpy(a) for a in _ell(4, 3, 10, np.float32, 0))
    kspmv.spmv(idx, val, w)   # plain version: not a launch
    assert fml.launch_counts() == {"fused_chain": 0, "spmv": 0}
    with pytest.raises(ValueError):
        _gate.LaunchCounter("not_a_site")
