"""The float16 precision policies on the port, against the JAX package on
the CPU: the fused chain, the plan trainer and float16 feature columns.

The policies are built by the caller, as the JAX package allows (neither
package has a float16 preset): ``half_inference`` (compute and
accumulation float16, parameters float32) and ``half`` (compute float16,
accumulation and parameters float32).

- The chain under each: the port's fused executor on the CPU (the plain
  chain, which is what the CUDA ``fused_chain`` kernel's ``f16`` entry is
  held against on the card) against JAX's ``pipeline_fusion._chain_fn``
  under ``jax.jit`` and ``kernels.chain.pallas_chain_fn`` in interpret
  mode, both fed the executor's padding. Output dtypes equal; float16
  scaler outputs within one float16 ulp (both round every op); float16
  ``rawPrediction`` within 2^-10 absolute (two ulps below 1: the sigmoid
  and the softmax round at other places), float32 ``rawPrediction``
  within 1e-5; float64 columns rtol 1e-5; decisions equal away from a
  2^-5 margin of their boundary.
- ``half`` refuses the KMeans chain with FML601 in both, before any
  program is built.
- A row whose scaled value passes 65,504 gives the same inf (and the same
  NaN downstream) in both.
- The plan-sharded fit under ``half`` equals JAX's within 1e-5 absolute
  (float16-rounded operands multiplied at float32: JAX's
  ``preferred_element_type``, the sums in another order), differs from
  the float32 fit and stays within 2e-2 of it.
- The CUDA chain's host side at float16 (rounding bits, load flags, the
  constant table).
- float16 feature columns with no policy (the port computes in the
  column's dtype; JAX at its x64 dtype): KMeans and KNN against float64
  numpy on the float16 values; a float16 sparse batch against JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu import pipeline_fusion as jax_pf
from flinkml_tpu import precision as jax_precision
from flinkml_tpu.kernels.chain import pallas_chain_fn
from flinkml_tpu.parallel import DeviceMesh as JaxMesh
from flinkml_tpu.sharding import apply as jax_apply
from flinkml_tpu.sharding import plan as jax_plan
from flinkml_tpu_torch import pipeline_fusion as pf
from flinkml_tpu_torch import precision
from flinkml_tpu_torch.kernels import chain as kchain
from flinkml_tpu_torch.linalg import SparseVector
from flinkml_tpu_torch.ops import sparse as osp
from flinkml_tpu_torch.precision import PrecisionValidationError
from flinkml_tpu_torch.sharding import apply as t_apply
from flinkml_tpu_torch.sharding import plan as t_plan
from tests._torch_port_common import on_cpu  # noqa: F401
from tests.test_torch_precision import CASES, _port_tier, _tier_cases

HALF_INFERENCE = {"name": "half_inference", "compute": "float16",
                  "accum": "float16", "params": "float32"}
HALF = {"name": "half", "compute": "float16", "accum": "float32",
        "params": "float32"}
POLICIES = {"half_inference": HALF_INFERENCE, "half": HALF}
F16_ULP = 2.0 ** -10
RAW_TOL = {"half_inference": dict(rtol=0.0, atol=2.0 ** -10),
           "half": dict(rtol=0.0, atol=1e-5)}
MARGIN = 2.0 ** -5
PLAN_TOL = 1e-5


def _jax_half(kernels, cols, policy, backend="xla"):
    """``(rule ids or None, {column: (dtype name, values)})`` of the JAX
    chain at ``policy``: the executor's verdict, then ``_chain_fn`` under
    ``jax.jit`` (``backend="pallas"``: ``pallas_chain_fn`` interpreted)."""
    ext = jax_pf.external_inputs(kernels)
    outs = jax_pf._output_cols(kernels)
    n = len(cols[ext[0]])
    bucket = jax_pf.row_bucket(n)
    padded = []
    for c in ext:
        v = np.asarray(cols[c])
        p = np.zeros((bucket,) + v.shape[1:], v.dtype)
        p[:n] = v
        padded.append(jnp.asarray(p))
    pol = jax_precision.resolve_policy(policy)
    consts = tuple(tuple(jnp.asarray(k.constants[c])
                         for c in sorted(k.constants)) for k in kernels)
    try:
        jax_pf._validate_chain(
            jax_pf._chain_fn(kernels, ext, outs, bucket, pol), padded,
            consts, kernels, pol)
    except jax_precision.PrecisionValidationError as e:
        return sorted({f.rule for f in e.findings}), None
    build = pallas_chain_fn if backend == "pallas" else jax_pf._chain_fn
    res = jax.jit(build(kernels, ext, outs, bucket, pol))(
        tuple(padded), consts, np.int32(n))
    return None, {c: (jnp.dtype(v.dtype).name, np.asarray(v)[:n])
                  for c, v in res.items()}


def _decisive(jax_stages, cols, want):
    """Rows whose decision is farther than :data:`MARGIN` (relative) from
    its boundary, in float64 over the head's float16-rounded input."""
    from flinkml_tpu.models import kmeans as jax_kmeans

    head = jax_stages[-1]
    src = head.transform_kernel().input_cols[0]
    xin = want[src][1] if src in want else np.asarray(cols[src])
    xin = np.asarray(xin, np.float16).astype(np.float64)
    if isinstance(head, jax_kmeans.KMeansModel):
        c = np.asarray(head.get_model_data()[0].column("centroids"))[0]
        d2 = ((xin[:, None, :] - c[None]) ** 2).sum(-1)
        part = np.sort(d2, axis=1)
        return (part[:, 1] - part[:, 0]) > MARGIN * (part[:, 1] + 1e-12)
    coef = np.asarray(head.get_model_data()[0].column("coefficient"))[0]
    if coef.ndim == 1:
        return np.abs(xin @ coef) > MARGIN * np.abs(xin * coef).sum(1)
    logits = np.sort(xin @ coef.T, axis=1)
    scale = np.abs(xin) @ np.abs(coef).T
    return (logits[:, -1] - logits[:, -2]) > MARGIN * scale.max(1)


def _close(name, jax_stages, cols, want, got, policy):
    assert {c: v[0] for c, v in got.items()} == \
        {c: v[0] for c, v in want.items()}
    for c, (dt, w) in want.items():
        g = got[c][1]
        w = np.asarray(w, np.float64) if dt != "int64" else w
        if c == "rawPrediction":
            np.testing.assert_allclose(g, w, err_msg=c, **RAW_TOL[policy])
        elif c == "prediction":
            keep = _decisive(jax_stages, cols, want)
            assert keep.mean() > 0.7, keep.mean()
            np.testing.assert_array_equal(g[keep], np.asarray(w)[keep],
                                          err_msg=c)
        elif dt == "float16":
            np.testing.assert_allclose(g, w, rtol=F16_ULP, atol=0,
                                       err_msg=c)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-12,
                                       err_msg=c)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("policy", ["half_inference", "half"])
@pytest.mark.parametrize("name", CASES)
def test_half_tier_matches_jax(name, policy, backend, on_cpu):
    """Each ported stage alone and each chain of the tier tests under the
    two float16 policies: the same verdict as the JAX executor's FML6xx
    gate, and otherwise JAX's output dtypes and, within the module's
    tolerances, its values (``_chain_fn`` and the Pallas kernel)."""
    jax_stages, port_stages, cols = _tier_cases()[name]
    jk = [s.transform_kernel() for s in jax_stages]
    tk = [s.transform_kernel() for s in port_stages]
    verdict, want = _jax_half(jk, cols, POLICIES[policy], backend)
    got_verdict, got = _port_tier(tk, cols, POLICIES[policy])
    assert got_verdict == verdict
    if verdict is None:
        _close(name, jax_stages, cols, want, got, policy)


def test_half_refuses_the_kmeans_chain_with_fml601(on_cpu):
    """Under ``half`` (float32 accumulation) the KMeans head, whose
    distance sums run at compute, is refused with FML601 before any
    program or spec is built; ``half_inference`` runs it."""
    _, port_stages, cols = _tier_cases()["scaler_kmeans"]
    model = fml.PipelineModel(port_stages)
    pf.reset_cache()
    with pf.precision_scope(HALF):
        with pytest.raises(PrecisionValidationError) as ei:
            model.transform(fml.Table(dict(cols)))
    assert {f.rule for f in ei.value.findings} == {"FML601"}
    assert "KMeansModel" in str(ei.value)
    assert pf.compiled_program_count() == 0 and not pf._SPECS
    jk = [s.transform_kernel() for s in _tier_cases()["scaler_kmeans"][0]]
    assert _jax_half(jk, cols, HALF)[0] == ["FML601"]
    with pf.precision_scope(HALF_INFERENCE):
        (out,) = model.transform(fml.Table(dict(cols)))
    assert out.column("prediction").dtype == np.int64


def _overflow_case():
    """StandardScaler -> LR over 40 rows of d = 4 with a spread of 0.01
    (the scaler fitted on them), served with one row at 700 in column 0:
    its scaled value is ~ 70,000, past float16's 65,504."""
    from flinkml_tpu.models import logistic_regression as jax_lr
    from flinkml_tpu.table import Table as JaxTable
    from tests._torch_port_common import fit_jax_scalers, port_stage_like

    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 4)) * 0.01
    sc = fit_jax_scalers(x)[0]
    x[7, 0] = 700.0
    lr = jax_lr.LogisticRegressionModel().set_features_col("s1")
    lr.set_model_data(JaxTable({"coefficient": np.array([[1.0, -1, 0.5,
                                                          0.25]])}))
    jax_stages = [sc, lr]
    return jax_stages, [port_stage_like(s) for s in jax_stages], {
        "features": x.astype(np.float32)}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_half_overflow_row_matches_jax(backend, on_cpu):
    """A scaled value past 65,504 under ``half_inference``: inf in the
    scaler output of the port and of JAX, and the same inf/NaN in the
    head's outputs."""
    jax_stages, port_stages, cols = _overflow_case()
    jk = [s.transform_kernel() for s in jax_stages]
    tk = [s.transform_kernel() for s in port_stages]
    _, want = _jax_half(jk, cols, HALF_INFERENCE, backend)
    _, got = _port_tier(tk, cols, HALF_INFERENCE)
    s1_got, s1_want = got["s1"][1], np.asarray(want["s1"][1], np.float64)
    assert np.isposinf(s1_got[7, 0]) and np.isposinf(s1_want[7, 0])
    for c in ("s1", "rawPrediction", "prediction"):
        g = np.asarray(got[c][1], np.float64)
        w = np.asarray(want[c][1], np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=c)
        np.testing.assert_array_equal(np.isinf(g) * np.sign(g),
                                      np.isinf(w) * np.sign(w), err_msg=c)
    assert np.isfinite(got["s1"][1][np.arange(40) != 7]).all()


# -- the plan trainer under ``half`` --------------------------------------------


def _train_data(n=192, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    y = (x @ rng.normal(size=dim) > 0).astype(np.float32) * 2 - 1
    return x, y


@pytest.mark.parametrize("plan,optimizer,epochs", [
    ("replicated", "sgd", 20), ("replicated", "adam", 20), ("fsdp", "sgd", 15),
])
def test_half_plan_fit_matches_jax_and_stays_near_float32(plan, optimizer,
                                                          epochs, on_cpu):
    x, y = _train_data()
    kw = dict(loss="logistic", optimizer=optimizer, max_iter=epochs,
              learning_rate=0.3)
    half = t_apply.train_linear_plan(x, y, None, t_plan.PRESETS[plan], None,
                                     precision=HALF, **kw)
    golden = t_apply.train_linear_plan(x, y, None, t_plan.REPLICATED, None,
                                       **kw)
    assert half.dtype == np.float32 and np.isfinite(half).all()
    np.testing.assert_allclose(half, golden, atol=2e-2)
    assert np.max(np.abs(half - golden)) > 0  # float16 really ran
    want = jax_apply.train_linear_plan(
        x, y, None, jax_plan.PRESETS[plan],
        JaxMesh.for_plan(jax_plan.PRESETS[plan]), precision=HALF, **kw)
    np.testing.assert_allclose(half, want, rtol=0, atol=PLAN_TOL)


def test_half_step_rounds_its_operands_to_float16(on_cpu):
    """One ``half`` step by hand: the products of float16-rounded operands
    at float32, the state at float32; the declared widths pass the
    trainer's precision rules as JAX's ``validate_linear_precision`` does."""
    x, y = _train_data(n=16, dim=4)
    step = t_apply.linear_step_fn("squared", "sgd", "float32", 0.5, 0.0,
                                  0.0, 0.0, policy=HALF)
    state = {"coef": torch.full((4,), 0.1), "momentum": torch.zeros(4)}
    xb = torch.from_numpy(x)
    new, _ = step(state, xb, torch.from_numpy(y), torch.ones(16))
    xr = xb.half().float()
    cr = state["coef"].half().float()
    mult = (xr @ cr - torch.from_numpy(y)).half().float()
    want = state["coef"] - 0.5 * (xr.T @ mult / 16.0)
    torch.testing.assert_close(new["coef"], want, rtol=0, atol=1e-6)
    t_apply.validate_linear_precision(HALF, step, 4, 16, "float32", "sgd")
    jstep = jax_apply.linear_step_fn("squared", "sgd", "float32", 0.5, 0.0,
                                     0.0, 0.0,
                                     policy=jax_precision.resolve_policy(HALF))
    jax_apply.validate_linear_precision(
        jax_precision.resolve_policy(HALF), jstep, 4, 16, np.float32, "sgd")


# -- the CUDA chain's host side at float16 --------------------------------------


@pytest.mark.parametrize("policy,row,want", [
    (None, torch.float16, (32, torch.float16, torch.float16)),
    (HALF_INFERENCE, torch.float16, (32, torch.float16, torch.float16)),
    (HALF, torch.float16, (0, torch.float16, torch.float32)),
    (HALF_INFERENCE, torch.float64, (16 | 32, torch.float16, torch.float16)),
    (HALF, torch.float64, (16 | 8, torch.float16, torch.float32)),
])
def test_head_rounding_per_half_tier(policy, row, want):
    """The head's rounding bits and output dtypes for the float16 tiers
    (``csrc/chain.cu`` kInF16 = 16, kOutF16 = 32, kOutF32 = 8): the
    widths of the JAX chain's outputs (prediction at compute,
    rawPrediction at accum)."""
    _, port_stages, _ = _tier_cases()["binomial"]
    kernels = [s.transform_kernel() for s in port_stages]
    program = kchain.ChainProgram(kernels, ["features"],
                                  ["prediction", "rawPrediction"],
                                  precision.resolve_policy(policy))
    assert program._head_args(row) == want


@pytest.mark.parametrize("policy,dtype,flags,row,gather", [
    # A float64 or float32 input under a float16 tier: rounded to float16
    # at the load (a float32 input read on the dense vector route).
    (HALF_INFERENCE, np.float64, (256,), torch.float16, True),
    (HALF, np.float32, (256,), torch.float16, False),
    # A float16 column with no policy: a float16 row, gathered.
    (None, np.float16, (0,), torch.float16, True),
])
def test_half_layout_casts_at_the_boundary(policy, dtype, flags, row, gather):
    _, port_stages, cols = _tier_cases()["scaler_lr"]
    kernels = [s.transform_kernel() for s in port_stages]
    vals = [torch.from_numpy(np.asarray(cols["features"], dtype))]
    program = kchain.ChainProgram(kernels, ["features"], ["s4"],
                                  precision.resolve_policy(policy))
    lay = program.layout(vals)
    assert (lay.flags, lay.dtype, lay.gather) == (flags, row, gather)


@pytest.mark.parametrize("name", ["scaler_lr", "mnist", "scaler_kmeans",
                                  "census"])
def test_half_table_reproduces_plain_chain(name, on_cpu):
    """The constants the host hands the CUDA kernel under
    ``half_inference`` equal the values the plain chain's stages use: the
    scaler outputs recomputed from the table by the kernel's op sequence
    (each op rounded on a float16 row) equal the plain chain's bit for
    bit."""
    _, port_stages, cols = _tier_cases()[name]
    kernels = [s.transform_kernel() for s in port_stages]
    pol = precision.resolve_policy(HALF_INFERENCE)
    ext = pf.external_inputs(kernels)
    scaler_out = [k.output_cols[0] for k in kernels
                  if k.fingerprint[0] in kchain.SCALER_STAGES][-1:]
    consts = pf._tier_consts(kernels, pol)
    vals = [torch.from_numpy(np.asarray(cols[c])) for c in ext]
    program = kchain.ChainProgram(kernels, ext, scaler_out, pol)
    lay = program.layout(vals)
    plan = program.plan
    table, ops = kchain.pack_table(plan, kernels, consts, lay.dtype, lay.d,
                                   pol)
    want = kchain.chain_plain(kernels, ext, scaler_out, vals, consts,
                              len(vals[0]), pol)[scaler_out[0]]
    src = kernels[plan.stages[0]].input_cols[0]
    if src in ext:
        row = kchain.boundary(pol, vals, consts)[0][ext.index(src)]
    else:
        row = kchain.chain_plain(kernels, ext, [src], vals, consts,
                                 len(vals[0]), pol)[src]
    v = row.to(table.dtype)

    def rnd(t):
        return t.half().to(t.dtype) if lay.dtype == torch.float16 else t

    d, stride = lay.d, 2 * lay.d + 2
    for s in range(plan.n_run):
        op = (ops >> (3 * s)) & 7
        st = table[s * stride:(s + 1) * stride]
        a, b, scale, offset = st[:d], st[d:2 * d], st[2 * d], st[2 * d + 1]
        if op & 1:
            v = torch.where(b > 0, rnd(rnd(v - a) / torch.where(
                b > 0, b, torch.ones((), dtype=b.dtype))),
                torch.full((), 0.5, dtype=v.dtype))
            v = rnd(rnd(v * scale) + offset)
        else:
            if op & 2:
                v = rnd(v - a)
            if op & 4:
                v = rnd(v / b)
    torch.testing.assert_close(v.to(want.dtype), want, rtol=0, atol=0)


# -- float16 feature columns, no policy -------------------------------------------


def _blobs16(n=400, d=8, k=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 6.0
    lab = rng.integers(0, k, size=n)
    x = (centers[lab] + rng.normal(size=(n, d)) * 0.3).astype(np.float16)
    return x, centers, lab


@pytest.mark.parametrize("fused", [False, True])
def test_kmeans_transform_of_a_float16_column(fused, on_cpu):
    """KMeans on a float16 column computes on the float16 row, alone (the
    stage's transform) and behind a MaxAbsScaler (a run of two stages:
    the fused executor's plain chain); on well-separated blobs its
    assignments equal float64 numpy's on the same float16 values."""
    x, centers, _ = _blobs16()
    km = fml.KMeansModel().set_features_col("s" if fused else "f")
    stages = [km.set_model_data(fml.Table({"centroids": centers[None]}))]
    if fused:
        scaler = fml.MaxAbsScalerModel().set_input_col("f") \
            .set_output_col("s")
        scaler.set_model_data(fml.Table({"maxAbs": np.ones((1, 8))}))
        stages.insert(0, scaler)
    (out,) = fml.PipelineModel(stages).transform(fml.Table({"f": x}))
    xd = x.astype(np.float64)
    want = np.argmin(((xd[:, None] - centers[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(out.column("prediction"), want)


def test_knn_of_a_float16_column(on_cpu):
    """KNN votes on float16 distances (``top_k`` at float16); on
    well-separated blobs its predictions equal float64 numpy's."""
    x, _, lab = _blobs16(seed=1)
    q, _, qlab = _blobs16(n=60, seed=1)
    model = fml.Knn().set_k(5).fit(fml.Table({"features": x,
                                              "label": lab.astype(float)}))
    (out,) = model.transform(fml.Table({"features": q}))
    np.testing.assert_array_equal(out.column("prediction"), qlab)


def test_batched_csr_at_float16_matches_jax(on_cpu):
    """A float16 sparse batch (``BatchedCSR`` at float16): the margins
    (``matvec``, the ``spmv`` kernel) within one float16 ulp of JAX's plus
    2^-11 of the row's sum of |products|, the gradient scatter
    (``rmatvec``, an unsorted ``segment_sum``) bit for bit."""
    from flinkml_tpu.linalg import SparseVector as JaxSparseVector
    from flinkml_tpu.ops.sparse import BatchedCSR as JaxBatchedCSR

    rng = np.random.default_rng(4)
    dim, rows = 5000, 300
    picks = [(np.sort(rng.choice(dim, 39, replace=False)),
              rng.normal(size=39)) for _ in range(rows)]
    coef = rng.normal(size=dim).astype(np.float16)
    resid = rng.normal(size=rows).astype(np.float16)
    port = osp.BatchedCSR.from_sparse_vectors(
        [SparseVector(dim, i, v) for i, v in picks], dtype=np.float16)
    ref = JaxBatchedCSR.from_sparse_vectors(
        [JaxSparseVector(dim, i, v) for i, v in picks], dtype=np.float16)
    got = port.matvec(torch.from_numpy(coef))
    want = np.asarray(ref.matvec(jnp.asarray(coef)), np.float64)
    assert got.dtype == torch.float16
    terms = np.array([np.abs(v.astype(np.float16).astype(np.float64)
                             * coef.astype(np.float64)[i]).sum()
                      for i, v in picks])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2 ** -14))) - 10)
    assert np.all(np.abs(got.numpy() - want) <= ulp + 2.0 ** -11 * terms)
    g = port.rmatvec(torch.from_numpy(resid))
    w = ref.rmatvec(jnp.asarray(resid))
    assert g.dtype == torch.float16 and w.dtype == jnp.float16
    np.testing.assert_array_equal(g.numpy().view(np.int16),
                                  np.asarray(w).view(np.int16))
