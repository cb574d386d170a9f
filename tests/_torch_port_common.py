"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``):
seeded inputs made with numpy, the same five-stage scaler -> LR chain built
in both packages from the same model data, and the port's CPU device
scope."""

from __future__ import annotations

import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu import pipeline_fusion as jax_fusion
from flinkml_tpu.kernels import ENV_VAR as JAX_KERNELS_ENV
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models import scalers as jax_scalers
from flinkml_tpu.pipeline import PipelineModel as JaxPipelineModel
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch import pipeline_fusion as torch_fusion
from tests._torch_threads import cap_torch_threads

cap_torch_threads()

# Declared tolerances (float64 runs are the JAX package under x64).
F64_SCALER_RTOL = 1e-12
F64_RAW_RTOL = 1e-10
F64_DECISIVE = 1e-9
F32_RTOL, F32_ATOL = 1e-5, 1e-6
SPARSE_TOL = 1e-5

SCALER_NAMES = ("StandardScaler", "MinMaxScaler", "MaxAbsScaler",
                "RobustScaler")

#: The JAX function under comparison: XLA, or the Pallas kernel run in
#: interpret mode through the JAX package's own gate.
JAX_BACKENDS = ("xla", "pallas")


@pytest.fixture
def on_cpu():
    """Run the port on the CPU (its plain kernel versions) with a clean
    fused-program cache."""
    torch_fusion.reset_cache()
    with fml.use_device("cpu"):
        yield
    torch_fusion.reset_cache()


def jax_backend(monkeypatch, backend: str, site: str) -> None:
    """Select the JAX package's lowering for ``site`` (a fresh fused
    program cache, so no program of the other backend is reused)."""
    if backend == "pallas":
        monkeypatch.setenv(JAX_KERNELS_ENV, f"{site}=pallas")
    else:
        monkeypatch.delenv(JAX_KERNELS_ENV, raising=False)
    jax_fusion.reset_cache()


def dense_data(rows: int = 300, d: int = 6, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)) * rng.uniform(0.5, 3.0, size=d) \
        + rng.normal(size=d)
    # A constant feature exercises the zero guards and MinMax's 0.5.
    x[:, -1] = 2.5
    coef = rng.normal(size=d)
    return x, coef


def fit_jax_scalers(x: np.ndarray):
    """The four JAX scaler models fitted in chain order on ``x``."""
    stages, cur, prev = [], JaxTable({"features": x}), "features"
    for i, name in enumerate(SCALER_NAMES, start=1):
        cls = getattr(jax_scalers, name)
        m = cls().set(cls.INPUT_COL, prev).set(cls.OUTPUT_COL, f"s{i}")
        m = m.fit(cur)
        (cur,) = m.transform(cur)
        prev = f"s{i}"
        stages.append(m)
    return stages


def port_stage_like(jax_stage):
    """The port's model with the JAX model's params and model data."""
    return fml.stage_from_arrays(
        f"{type(jax_stage).__module__}.{type(jax_stage).__qualname__}",
        jax_stage.get_param_map_json(),
        {c: jax_stage.get_model_data()[0].column(c)
         for c in jax_stage.get_model_data()[0].column_names},
    )


def five_stage_pair(x: np.ndarray, coef: np.ndarray):
    """``(jax PipelineModel, port PipelineModel)`` — the bench's canonical
    chain, the port's built from the JAX model data."""
    jax_stages = fit_jax_scalers(x)
    lr = jax_lr.LogisticRegressionModel().set(
        jax_lr.LogisticRegressionModel.FEATURES_COL, "s4")
    lr.set_model_data(JaxTable({"coefficient": coef[None, :]}))
    jax_stages.append(lr)
    port = fml.PipelineModel([port_stage_like(s) for s in jax_stages])
    return JaxPipelineModel(jax_stages), port


def jax_chain(jax_model, x: np.ndarray, backend: str):
    """The JAX package's fused chain function for ``jax_model``'s stages
    over ``x``: ``pipeline_fusion._chain_fn`` under ``jax.jit`` (XLA), or
    ``kernels.chain.pallas_chain_fn`` (the Pallas kernel, interpret mode on
    the CPU). Called directly with the executor's padding and constant
    order, because the executor itself needs
    ``jax.experimental.enable_x64``, which this jax no longer has."""
    import jax
    import jax.numpy as jnp
    from flinkml_tpu.kernels.chain import pallas_chain_fn
    from flinkml_tpu.pipeline_fusion import (
        _chain_fn, _output_cols, external_inputs, row_bucket,
    )

    kernels = [s.transform_kernel() for s in jax_model.stages]
    n = x.shape[0]
    bucket = row_bucket(n)
    xp = np.zeros((bucket,) + x.shape[1:], x.dtype)
    xp[:n] = x
    consts = tuple(
        tuple(jnp.asarray(k.constants[c]) for c in sorted(k.constants))
        for k in kernels
    )
    build = pallas_chain_fn if backend == "pallas" else _chain_fn
    run = jax.jit(build(kernels, external_inputs(kernels),
                        _output_cols(kernels), bucket))
    res = run((jnp.asarray(xp),), consts, np.int32(n))
    return {c: np.asarray(v)[:n] for c, v in res.items()}


def jax_chain_cols(kernels, cols, backend: str, out_names=None):
    """:func:`jax_chain` for any JAX ``ColumnKernel`` chain over the named
    numpy ``cols`` (every column the chain reads from outside): the rows
    padded to the executor's bucket, all outputs (or ``out_names``)."""
    import jax
    import jax.numpy as jnp
    from flinkml_tpu.kernels.chain import pallas_chain_fn
    from flinkml_tpu.pipeline_fusion import (
        _chain_fn, _output_cols, external_inputs, row_bucket,
    )

    ext = external_inputs(kernels)
    n = len(cols[ext[0]])
    bucket = row_bucket(n)
    padded = []
    for c in ext:
        v = np.asarray(cols[c])
        p = np.zeros((bucket,) + v.shape[1:], v.dtype)
        p[:n] = v
        padded.append(jnp.asarray(p))
    consts = tuple(
        tuple(jnp.asarray(k.constants[c]) for c in sorted(k.constants))
        for k in kernels
    )
    outs = tuple(out_names or _output_cols(kernels))
    build = pallas_chain_fn if backend == "pallas" else _chain_fn
    run = jax.jit(build(kernels, ext, outs, bucket))
    res = run(tuple(padded), consts, np.int32(n))
    return {c: np.asarray(v)[:n] for c, v in res.items()}


def port_chain_cols(kernels, cols, out_names=None):
    """The port's plain chain (its CPU path) over the same columns, padded
    the same way: ``{column: numpy array}``."""
    import torch

    from flinkml_tpu_torch.kernels import chain as kchain
    from flinkml_tpu_torch.pipeline_fusion import (
        _output_cols, external_inputs, row_bucket,
    )

    ext = external_inputs(kernels)
    n = len(cols[ext[0]])
    bucket = row_bucket(n)
    padded = []
    for c in ext:
        v = np.asarray(cols[c])
        p = np.zeros((bucket,) + v.shape[1:], v.dtype)
        p[:n] = v
        padded.append(torch.from_numpy(p))
    outs = tuple(out_names or _output_cols(kernels))
    res = kchain.chain_plain(kernels, ext, outs, padded,
                             [k.constants for k in kernels], n)
    return {c: v[:n].numpy() for c, v in res.items()}


def jax_per_stage(jax_model, x: np.ndarray):
    """The JAX package's per-stage ``PipelineModel.transform``."""
    jax_fusion.set_enabled(False)
    try:
        (out,) = jax_model.transform(JaxTable({"features": x}))
    finally:
        jax_fusion.set_enabled(True)
    return outputs(out)


def outputs(table, cols=("s1", "s2", "s3", "s4", "prediction",
                         "rawPrediction")):
    return {c: np.asarray(table.column(c)) for c in cols}


def assert_lr_outputs_close(got, want, dot, f64: bool = True):
    """rawPrediction within the declared tolerance; predictions equal
    wherever the margin is decisive."""
    if f64:
        np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                                   rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL)
        decisive = np.abs(dot) > F64_DECISIVE
    else:
        np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                                   rtol=F32_RTOL, atol=F32_ATOL)
        decisive = np.abs(dot) > 1e-4
    assert decisive.sum() > 0.9 * dot.size
    np.testing.assert_array_equal(got["prediction"][decisive],
                                  want["prediction"][decisive])
