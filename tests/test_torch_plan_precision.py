"""The trainer half of the port's precision policies against the JAX
package's ``tests/test_precision.py`` trainer tests, on the CPU.

- FML601/603/605: the port checks the step's declared widths (it walks no
  program); its verdict (the set of rules) equals what JAX's jaxpr pass
  raises for every policy preset, storage dtype (bfloat16, float16,
  float32, float64), optimizer, step built with or without the policy,
  and with or without a plan (FML605).
- FML604: a collective narrower than ``policy.accum`` without an explicit
  pre-cast, as JAX's psum cases.
- ``train_linear_plan`` refuses ``dtype=bfloat16`` and float64 under
  ``mixed`` with JAX's rules, before any step.
- The mixed fit equals JAX's mixed fit within 1e-5 absolute (observed
  ≈ 7e-7: the products are bf16-rounded operands multiplied at float32,
  JAX's ``preferred_element_type=float32`` accumulator, and differ in
  summation order only), for SGD, Adam and FSDP; it differs from the
  float32 fit and stays within 2e-2 of it (``test_precision.py:320``).
"""

from __future__ import annotations

import jax
import ml_dtypes
import numpy as np
import pytest

import flinkml_tpu_torch as fml
from flinkml_tpu.analysis.precision import (
    check_policy_plan as jax_check_policy_plan,
    check_precision_fn as jax_check_precision_fn,
)
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.parallel import DeviceMesh as JaxMesh
from flinkml_tpu.precision import PrecisionValidationError as JaxPVE
from flinkml_tpu.precision import resolve_policy as jax_resolve
from flinkml_tpu.sharding import apply as jax_apply
from flinkml_tpu.sharding import plan as jax_plan
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch import precision as t_precision
from flinkml_tpu_torch.precision import (
    MIXED,
    PrecisionValidationError,
    check_policy_plan,
    check_trainer_widths,
)
from flinkml_tpu_torch.sharding import apply as t_apply
from flinkml_tpu_torch.sharding import plan as t_plan
from tests._torch_port_common import on_cpu  # noqa: F401

BF16 = np.dtype(ml_dtypes.bfloat16)
MIXED_TOL = 1e-5
DTYPES = ("bfloat16", "float16", "float32", "float64")


def _np(dtype_name):
    return BF16 if dtype_name == "bfloat16" else np.dtype(dtype_name)


def _jax_rules(policy, dtype_name, with_policy, optimizer, plan):
    step = jax_apply.linear_step_fn(
        "logistic", optimizer, _np(dtype_name).name, 0.1, 0.9, 0.01, 0.001,
        policy=jax_resolve(policy) if with_policy else None)
    try:
        jax_apply.validate_linear_precision(
            jax_resolve(policy), step, 8, 8, _np(dtype_name), optimizer,
            plan=jax_plan.REPLICATED if plan else None)
    except JaxPVE as e:
        return {f.rule for f in e.findings}
    return set()


def _port_rules(policy, dtype_name, with_policy, optimizer, plan):
    step = t_apply.linear_step_fn(
        "logistic", optimizer, dtype_name, 0.1, 0.9, 0.01, 0.001,
        policy=policy if with_policy else None)
    try:
        t_apply.validate_linear_precision(
            policy, step, 8, 8, dtype_name, optimizer,
            plan=t_plan.REPLICATED if plan else None)
    except PrecisionValidationError as e:
        assert all(f.severity == "error" for f in e.findings)
        return {f.rule for f in e.findings}
    return set()


@pytest.mark.parametrize("plan", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("with_policy", [False, True],
                         ids=["plain_step", "policy_step"])
@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("policy", ["mixed", "full", "mixed_inference"])
def test_trainer_verdicts_equal_jax(policy, dtype_name, with_policy, plan):
    for optimizer in ("sgd", "adam"):
        assert _port_rules(policy, dtype_name, with_policy, optimizer,
                           plan) == \
            _jax_rules(policy, dtype_name, with_policy, optimizer, plan)


def test_fml601_603_real_trainer_step_refused():
    """bf16 storage under ``mixed`` is refused with both rules, typed,
    carrying the findings (``test_precision.py:124``)."""
    with pytest.raises(PrecisionValidationError) as ei:
        t_apply.validate_linear_precision(
            MIXED, t_apply.linear_step_fn("logistic", "sgd", "bfloat16", 0.1,
                                          0.9, 0.0, 0.0),
            dim=8, rows=8, dt="bfloat16", optimizer="sgd")
    rules = {f.rule for f in ei.value.findings}
    assert "FML601" in rules and "FML603" in rules
    assert all(f.severity == "error" for f in ei.value.findings)
    assert "FML601 [error]" in str(ei.value)


def test_policy_correct_step_validates_clean():
    for optimizer in ("sgd", "adam"):
        t_apply.validate_linear_precision(
            MIXED, t_apply.linear_step_fn("logistic", optimizer, "float32",
                                          0.1, 0.9, 0.0, 0.0, policy=MIXED),
            dim=8, rows=8, dt=np.float32, optimizer=optimizer)


def test_fml605_plan_width_conflict_equals_jax():
    for width, name in ((2, "fsdp"), (4, None), (8, "replicated"),
                        (None, None)):
        got = check_policy_plan(MIXED, dtype_bytes=width, plan_name=name)
        want = jax_check_policy_plan(jax_resolve("mixed"), dtype_bytes=width,
                                     plan_name=name)
        assert [(f.rule, f.message, f.stage) for f in got] == \
            [(f.rule, f.message, f.stage) for f in want]
    assert check_policy_plan(MIXED, dtype_bytes=2, plan_name="fsdp")[0] \
        .rule == "FML605"


def test_fml604_narrow_collective_and_sanctioned_precast():
    def bad(g):
        return jax.lax.psum(g, "data")

    def deliberate(g):
        return jax.lax.psum(g.astype(BF16), "data")

    want_bad = {f.rule for f in jax_check_precision_fn(
        bad, jax.ShapeDtypeStruct((8,), BF16), policy=jax_resolve("mixed"),
        axis_env=[("data", 8)])}
    want_ok = {f.rule for f in jax_check_precision_fn(
        deliberate, jax.ShapeDtypeStruct((8,), np.float32),
        policy=jax_resolve("mixed"), axis_env=[("data", 8)])}
    import torch

    got_bad = {f.rule for f in check_trainer_widths(
        MIXED, {}, {}, collectives=(("psum", torch.bfloat16, None),))}
    got_ok = {f.rule for f in check_trainer_widths(
        MIXED, {}, {}, collectives=(("psum", torch.bfloat16,
                                     torch.float32),))}
    assert got_bad == want_bad == {"FML604"}
    assert got_ok == want_ok == set()
    # The plan step's all-reduce runs at policy.accum: never FML604.
    step = t_apply.linear_step_fn("logistic", "sgd", "float32", 0.1, 0.9,
                                  0.0, 0.0, policy=MIXED)
    assert step.widths["collective"] == torch.float32


def _train_data(n=192, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (x @ rng.normal(size=dim) > 0).astype(np.float32) * 2 - 1
    return x, y


@pytest.mark.parametrize("dtype", ["bfloat16", np.float64])
def test_train_linear_plan_refusals_equal_jax(dtype, monkeypatch, on_cpu):
    """``dtype=bfloat16`` under ``mixed`` is refused with FML601 (and
    FML603, FML605); float64 with FML605 — JAX's sets, before any step
    (``test_precision.py:299-310``)."""
    x, y = _train_data()
    calls = []
    monkeypatch.setattr(t_apply.LinearStep, "__call__",
                        lambda *a, **k: calls.append(1))
    with pytest.raises(PrecisionValidationError) as ei:
        t_apply.train_linear_plan(x, y, None, t_plan.REPLICATED, None,
                                  max_iter=1, dtype=dtype, precision="mixed")
    got = {f.rule for f in ei.value.findings}
    with pytest.raises(JaxPVE) as ej:
        jax_apply.train_linear_plan(
            x, y, None, jax_plan.REPLICATED,
            JaxMesh.for_plan(jax_plan.REPLICATED), max_iter=1,
            dtype=dtype if dtype != "bfloat16" else BF16, precision="mixed")
    assert got == {f.rule for f in ej.value.findings}
    assert ("FML601" if dtype == "bfloat16" else "FML605") in got
    assert calls == []


def _jax_plan_fit(x, y, plan, **kw):
    return jax_apply.train_linear_plan(x, y, None, jax_plan.PRESETS[plan],
                                       JaxMesh.for_plan(jax_plan.PRESETS[plan]),
                                       **kw)


@pytest.mark.parametrize("plan,optimizer,epochs", [
    ("replicated", "sgd", 20), ("replicated", "adam", 20), ("fsdp", "sgd", 15),
])
def test_mixed_fit_matches_jax_and_stays_near_float32(plan, optimizer,
                                                      epochs, on_cpu):
    x, y = _train_data()
    kw = dict(loss="logistic", optimizer=optimizer, max_iter=epochs,
              learning_rate=0.3)
    mixed = t_apply.train_linear_plan(x, y, None, t_plan.PRESETS[plan], None,
                                      precision="mixed", **kw)
    golden = t_apply.train_linear_plan(x, y, None, t_plan.REPLICATED, None,
                                       **kw)
    assert mixed.dtype == np.float32 and np.isfinite(mixed).all()
    np.testing.assert_allclose(mixed, golden, atol=2e-2)
    assert np.max(np.abs(mixed - golden)) > 0  # bf16 really ran
    want = _jax_plan_fit(x, y, plan, precision="mixed", **kw)
    np.testing.assert_allclose(mixed, want, rtol=0, atol=MIXED_TOL)


def test_mixed_step_rounds_its_operands_to_bfloat16(on_cpu):
    """One mixed step by hand: the products of bf16-rounded operands at
    float32 (what ``preferred_element_type=float32`` computes)."""
    import torch

    x, y = _train_data(n=16, dim=4)
    step = t_apply.linear_step_fn("squared", "sgd", "float32", 0.5, 0.0,
                                  0.0, 0.0, policy="mixed")
    state = {"coef": torch.full((4,), 0.1), "momentum": torch.zeros(4)}
    xb = torch.from_numpy(x)
    new, _ = step(state, xb, torch.from_numpy(y), torch.ones(16))
    xr = xb.to(torch.bfloat16).to(torch.float32)
    cr = state["coef"].to(torch.bfloat16).to(torch.float32)
    mult = (xr @ cr - torch.from_numpy(y)).to(torch.bfloat16).to(
        torch.float32)
    want = state["coef"] - 0.5 * (xr.T @ mult / 16.0)
    torch.testing.assert_close(new["coef"], want, rtol=0, atol=1e-6)


def test_estimator_precision_knob(on_cpu):
    x, y = _train_data()
    x64, y01 = x.astype(np.float64), (y > 0).astype(np.float64)

    def fit(**kw):
        est = (fml.LogisticRegression(**kw).set_max_iter(10)
               .set_global_batch_size(len(x)).set_seed(7))
        return est.fit(fml.Table({"features": x64, "label": y01})).coefficient

    base = fit(precision="full")
    mixed = fit(precision="mixed")
    assert np.isfinite(mixed).all()
    np.testing.assert_allclose(mixed, base, atol=2e-2)
    want = (jax_lr.LogisticRegression(
        mesh=JaxMesh(devices=jax.devices()[:1]), precision="mixed")
        .set_max_iter(10).set_global_batch_size(len(x)).set_seed(7)
        .fit(JaxTable({"features": x64, "label": y01})).coefficient)
    np.testing.assert_allclose(mixed, want, rtol=0, atol=MIXED_TOL)


def test_precision_unaware_estimator_refuses_at_construction():
    from flinkml_tpu.models.kmeans import KMeans as JaxKMeans

    for cls in (fml.KMeans, JaxKMeans):
        with pytest.raises(ValueError, match="does not support precision"):
            cls(precision="mixed")
    with pytest.raises(ValueError, match="unknown precision preset"):
        fml.LogisticRegression(precision="nope")


def test_precision_refused_on_sparse_and_host_paths(on_cpu):
    from flinkml_tpu_torch.models._linear_sgd import (
        train_linear_model_from_table,
    )
    from flinkml_tpu_torch.models.logistic_regression import (
        train_logistic_regression,
    )

    rows = [fml.SparseVector(4, [0], [1.0]) for _ in range(4)]
    t = fml.Table({"features": np.array(rows, dtype=object),
                   "label": np.array([0.0, 1.0, 0.0, 1.0])})
    with pytest.raises(ValueError, match="dense path only"):
        train_linear_model_from_table(
            t, "features", "label", None, precision="mixed",
            loss="logistic", max_iter=1, learning_rate=0.1,
            global_batch_size=4, reg=0.0, elastic_net=0.0, tol=0.0, seed=0)
    x, y = _train_data(n=16, dim=4)
    with pytest.raises(ValueError, match="device"):
        train_logistic_regression(
            x, (y > 0).astype(np.float32), np.ones(16, np.float32), 1, 0.1,
            16, 0.0, 0.0, 0, mode="host", precision="mixed")
    assert t_precision.MIXED.params_dtype.itemsize == 4
