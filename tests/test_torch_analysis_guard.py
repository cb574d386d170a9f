"""The transfer/retrace guard of the port (FML401–FML403) on the CPU.

The eleven cases of ``tests/test_analysis_guard.py``, on the port's fused
executor under ``use_device("cpu")``. The JAX package's guard cannot run
on this host (its executor needs ``jax.experimental.enable_x64``, gone in
jax 0.9.0), so each case holds the port to the rule's meaning:

- a warm hot loop builds nothing and passes a zero budget; a cold chain
  is FML402 (budgeted, it passes); a new bucket of a known chain is
  allowed, unless the policy forbids new buckets;
- a new table's upload and a device→host read are FML401 against a zero
  budget; the guard reports instead of raising when asked;
- the pytest marker ``no_retrace`` is the JAX package's wrapper of a test
  in the guard: here the same guard, entered by hand with the marker's
  budget;
- three fingerprints over one shape are FML403, an A/B pair is not;
- a constant's Python type never aliases a program of another dtype: the
  port casts every constant to its column's dtype, so a Python float and a
  strong numpy float64 give one program and the same float32 column (the
  JAX package keys on weak types because its constants promote);
- lazy intermediates: JAX frees a donated buffer and must fail loudly; a
  torch buffer lives while a tensor refers to it, so the port's lazy
  column keeps its inputs alive — it reads right after the source table
  drops its device copies, reads the same twice, and its host copy
  outlives the device buffers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.analysis import (
    GuardViolation,
    TransferRetraceGuard,
    transfer_retrace_guard,
)
from flinkml_tpu_torch.api import ColumnKernel
from flinkml_tpu_torch.models.scalers import MaxAbsScaler, StandardScaler
from flinkml_tpu_torch.pipeline import PipelineModel
from flinkml_tpu_torch.table import LazyDeviceColumn, Table

from tests._torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(autouse=True)
def _fusion_state():
    pipeline_fusion.set_enabled(True)
    pipeline_fusion.reset_cache()
    saved = list(pipeline_fusion.on_compile)
    with fml.use_device("cpu"):
        yield
    pipeline_fusion.on_compile[:] = saved
    pipeline_fusion.set_enabled(True)
    pipeline_fusion.reset_cache()


def _data(n=60, d=4, seed=0):
    rng = np.random.default_rng(seed)
    return Table({"features": rng.normal(size=(n, d))})


def _two_stage_chain(t):
    a = StandardScaler().set(StandardScaler.INPUT_COL, "features").set(
        StandardScaler.OUTPUT_COL, "a"
    ).fit(t)
    b = MaxAbsScaler().set(MaxAbsScaler.INPUT_COL, "a").set(
        MaxAbsScaler.OUTPUT_COL, "b"
    ).fit(a.transform(t)[0])
    return PipelineModel([a, b])


def test_warm_hot_loop_passes_with_zero_budget():
    t = _data()
    pm = _two_stage_chain(t)
    pm.transform(t)  # warmup build outside the guard
    with TransferRetraceGuard(allow_compiles=0) as guard:
        for rows in (60, 33, 47, 64):  # one 64-row bucket
            pm.transform(t.slice(0, rows))
    assert guard.findings == [] and guard.nvcc_runs == 0


def test_new_chain_compile_inside_guard_violates():
    t = _data()
    pm = _two_stage_chain(t)
    with pytest.raises(GuardViolation) as err:
        with TransferRetraceGuard(allow_compiles=0):
            pm.transform(t)  # cold chain: builds in-region
    assert any(f.rule == "FML402" for f in err.value.findings)
    pipeline_fusion.reset_cache()
    with TransferRetraceGuard(allow_compiles=1):
        pm.transform(t)


def test_new_bucket_compile_is_policy_allowed():
    t = _data(n=200)
    pm = _two_stage_chain(t)
    pm.transform(t.slice(0, 60))  # warm the 64 bucket
    with TransferRetraceGuard(allow_compiles=0, allow_new_buckets=True):
        pm.transform(t.slice(0, 129))  # 256 bucket: allowed
    pipeline_fusion.reset_cache()
    pm.transform(t.slice(0, 60))
    with pytest.raises(GuardViolation):
        with TransferRetraceGuard(allow_compiles=0,
                                  allow_new_buckets=False):
            pm.transform(t.slice(0, 129))


def test_transfer_budgets_fml401():
    t = _data()
    pm = _two_stage_chain(t)
    pm.transform(t)
    guard = TransferRetraceGuard(
        allow_compiles=0, allow_host_to_device=0,
        raise_on_violation=False,
    )
    with guard:
        fresh = _data(seed=1)  # a NEW table: its upload is a transfer
        pm.transform(fresh)
    assert [f.rule for f in guard.findings] == ["FML401"]
    # The same table again: its device copy is cached, no transfer.
    guard_warm = TransferRetraceGuard(
        allow_compiles=0, allow_host_to_device=0, raise_on_violation=False)
    with guard_warm:
        pm.transform(fresh)
    assert guard_warm.findings == []

    (out,) = pm.transform(t)
    guard2 = TransferRetraceGuard(
        allow_compiles=0, allow_device_to_host=0, raise_on_violation=False,
    )
    with guard2:
        out.column("b")
    assert [f.rule for f in guard2.findings] == ["FML401"]


def test_guard_reports_not_raises_when_asked():
    t = _data()
    pm = _two_stage_chain(t)
    guard = TransferRetraceGuard(allow_compiles=0, raise_on_violation=False)
    with guard:
        pm.transform(t)
    assert guard.findings and guard.findings[0].rule == "FML402"


def test_no_retrace_marker_budgets_warmup():
    """The marker's guard (``allow_compiles=1``): one build for the cold
    chain is budgeted, the varied-size calls after it hit the cache."""
    t = _data()
    pm = _two_stage_chain(t)
    with transfer_retrace_guard(allow_compiles=1) as guard:
        for rows in (60, 33, 47):
            pm.transform(t.slice(0, rows))
    assert guard.findings == []
    assert pipeline_fusion.compiled_program_count() == 1


def _fp_chain(fp_suffix):
    """A chain identical in everything but its fingerprint — the shape an
    unstable fingerprint produces on every call."""
    def f1(cols, c, valid):
        return {"y": cols["x"] * 2.0}

    def f2(cols, c, valid):
        return {"z": cols["y"] + 0}

    return [
        ColumnKernel(("x",), ("y",), f1, fingerprint=("mul", fp_suffix)),
        ColumnKernel(("y",), ("z",), f2, fingerprint=("id",)),
    ]


def test_fingerprint_churn_flagged_fml403_but_pair_is_not():
    t = Table({"x": np.ones(10)})
    guard = TransferRetraceGuard(allow_compiles=2, raise_on_violation=False)
    with guard:
        pipeline_fusion.execute_kernel_chain(t, _fp_chain(0))
        pipeline_fusion.execute_kernel_chain(t, _fp_chain(1))
    assert not guard.findings, [f.rule for f in guard.findings]
    pipeline_fusion.reset_cache()
    guard = TransferRetraceGuard(allow_compiles=3, raise_on_violation=False)
    with guard:
        for i in range(3):
            pipeline_fusion.execute_kernel_chain(t, _fp_chain(i))
    assert "FML403" in [f.rule for f in guard.findings]


def _mul_chain(const):
    def mul(cols, c, valid):
        x = cols["x"]
        return {"y": x * torch.as_tensor(c["k"], dtype=x.dtype)}

    def ident(cols, c, valid):
        return {"z": cols["y"] + 0}

    return [
        ColumnKernel(("x",), ("y",), mul, {"k": const}, ("mul",)),
        ColumnKernel(("y",), ("z",), ident, fingerprint=("ident",)),
    ]


def test_constant_weak_type_does_not_alias_cached_program():
    t = Table({"x": np.ones(10, dtype=np.float32)})
    weak = pipeline_fusion.execute_kernel_chain(t, _mul_chain(2.0))
    strong = pipeline_fusion.execute_kernel_chain(
        t, _mul_chain(np.float64(2.0)))
    assert weak.column("z").dtype == np.float32
    assert strong.column("z").dtype == np.float32
    assert pipeline_fusion.compiled_program_count() == 1
    np.testing.assert_array_equal(weak.column("z"), 2.0 * np.ones(10))
    np.testing.assert_array_equal(strong.column("z"), 2.0 * np.ones(10))


def test_lazy_column_reads_after_source_device_copies_dropped():
    t = _data(n=20)
    pm = _two_stage_chain(t)
    pipeline_fusion.set_enabled(False)
    (expected,) = pm.transform(t)
    pipeline_fusion.set_enabled(True)
    (out,) = pm.transform(t)
    assert isinstance(out._columns["a"], LazyDeviceColumn)
    t._device_cache.clear()
    np.testing.assert_array_equal(out.column("a"), expected.column("a"))


def test_lazy_column_reads_the_same_twice():
    t = _data(n=20)
    pm = _two_stage_chain(t)
    (out,) = pm.transform(t)
    col = out._columns["a"]
    first = col.buf.clone()
    assert torch.equal(col.buf, first)
    np.testing.assert_array_equal(out.column("a"),
                                  first[:col.rows].numpy())


def test_lazy_column_host_copy_outlives_device_buffers():
    t = _data(n=20)
    pm = _two_stage_chain(t)
    pipeline_fusion.set_enabled(False)
    (expected,) = pm.transform(t)
    pipeline_fusion.set_enabled(True)
    (out,) = pm.transform(t)
    np.testing.assert_array_equal(out.column("a"), expected.column("a"))
    t._device_cache.clear()
    out._device_cache.clear()
    np.testing.assert_array_equal(out.column("a"), expected.column("a"))
