"""The port's precision tiers (``flinkml_tpu_torch.precision`` and the
policy machinery of ``flinkml_tpu_torch.pipeline_fusion``) against the JAX
package.

The JAX package's fused executor needs ``jax.experimental.enable_x64``,
which this jax no longer has, so its side is the two functions the
executor calls: ``pipeline_fusion._validate_chain`` (the FML6xx verdict)
and ``pipeline_fusion._chain_fn`` under ``jax.jit`` (the chain at the
policy), fed the executor's padding and constants (int8 pairs under
``int8_inference``). The port's side is its fused executor on the CPU
(the plain chain). Inputs come from numpy seeds.

Declared tolerances (from the JAX package's own, ``tests/test_precision.py``):

- bfloat16 values of the scalers: within one bfloat16 ulp (both round
  every op; XLA may fuse one);
- ``rawPrediction``: atol 2e-2 under ``mixed_inference`` (bfloat16
  outputs: the sigmoid and the softmax round at other places), 3e-3 under
  ``mixed`` (float32 accumulation of exact bfloat16 products in another
  order), rtol 1e-5 / atol 1e-6 under ``int8_inference`` (both dequantize
  in float32);
- float32 and float64 columns of the int8 tier and float64 columns of the
  bfloat16 tiers: rtol 1e-5 (float32 rounding of the same ops);
- decisions (LR ``prediction``, KMeans assignment) equal wherever the
  float64 margin of the decision (the dot, the logit gap, the distance gap
  over the boundary's rounded inputs) exceeds 2^-5 of its scale.
"""

from __future__ import annotations

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu import pipeline_fusion as jax_pf
from flinkml_tpu import precision as jax_precision
from flinkml_tpu.models import kmeans as jax_kmeans
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models import vector_assembler as jax_va
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch import pipeline_fusion as pf
from flinkml_tpu_torch import precision
from flinkml_tpu_torch.kernels import chain as kchain
from flinkml_tpu_torch.precision import PrecisionValidationError
from tests._torch_port_common import (  # noqa: F401
    dense_data,
    fit_jax_scalers,
    five_stage_pair,
    on_cpu,
    port_stage_like,
)

TIERS = ("mixed", "mixed_inference", "int8_inference")
BF16_ULP = 2.0 ** -8
RAW_TOL = {"mixed_inference": dict(rtol=0.0, atol=2e-2),
           "mixed": dict(rtol=0.0, atol=3e-3),
           "int8_inference": dict(rtol=1e-5, atol=1e-6)}
MARGIN = 2.0 ** -5

# -- the policy value --------------------------------------------------------


@pytest.mark.parametrize("name", ["full", "mixed", "mixed_inference",
                                  "int8_inference"])
def test_presets_match_jax(name):
    mine = precision.resolve_policy(name)
    theirs = jax_precision.resolve_policy(name)
    assert mine.to_json_dict() == theirs.to_json_dict()
    assert (mine.mixed, mine.quant) == (theirs.mixed, theirs.quant)
    rt = precision.PrecisionPolicy.from_json_dict(
        json.loads(json.dumps(mine.to_json_dict())))
    assert rt == mine and hash(rt) == hash(mine)
    assert precision.resolve_policy(mine.to_json_dict()) == mine
    assert precision.resolve_policy(mine) is mine


def test_policy_rules_match_jax():
    assert precision.resolve_policy(None) is None
    assert hash(precision.INT8_INFERENCE) != hash(precision.FULL)
    assert "quant" not in precision.FULL.to_json_dict()
    for bad, match in ((dict(quant="int4"), "unknown quantization"),
                       (dict(compute="float32", accum="bfloat16"),
                        "narrower than compute"),
                       (dict(compute="int8"), "not a float dtype")):
        with pytest.raises(ValueError, match=match):
            precision.PrecisionPolicy(**bad)
        with pytest.raises(ValueError, match=match):
            jax_precision.PrecisionPolicy(**bad)
    with pytest.raises(ValueError, match="unknown precision preset"):
        precision.resolve_policy("bf16")
    with pytest.raises(TypeError):
        precision.resolve_policy(3)
    for a, b in (("bfloat16", "float32"), ("float16", "bfloat16"),
                 ("float64", "float32"), ("int8", "float32")):
        assert precision.is_narrower(a, b) == jax_precision.is_narrower(a, b)
        assert (precision.significand_bits(a)
                == jax_precision.significand_bits(a))
    assert precision.float_name(torch.bfloat16) == "bfloat16"
    assert precision.MIXED_INFERENCE.compute_dtype == torch.bfloat16
    assert precision.INT8_MIN_CONST_ELEMS == jax_precision.INT8_MIN_CONST_ELEMS


@pytest.mark.parametrize("shape,dtype,scale", [
    ((24, 6), np.float64, (1, 10, 0.1, 5, 1, 1)),
    ((40,), np.float64, 3.0),
    ((8, 3), np.float64, 0.0),
    ((5, 7, 4), np.float32, 2.0),
    ((17,), np.float32, 1e-30),
])
def test_quantize_absmax_is_bitwise_jax(shape, dtype, scale):
    rng = np.random.default_rng(3)
    w = (rng.normal(size=shape) * np.asarray(scale)).astype(dtype)
    q, s = precision.quantize_absmax(w)
    jq, js = jax_precision.quantize_absmax(w)
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(
        precision.dequantize_absmax(q, s),
        jax_precision.dequantize_absmax(jq, js))
    assert (precision.quantizable(w)
            == jax_precision.quantizable(w))


def test_cast_floats_over_containers():
    tree = {"a": torch.ones(2, dtype=torch.float64),
            "b": [torch.zeros(1), torch.arange(3)],
            "c": (torch.ones(1, dtype=torch.float32), "x")}
    out = precision.cast_floats(tree, "bfloat16")
    assert out["a"].dtype == out["b"][0].dtype == torch.bfloat16
    assert out["c"][0].dtype == torch.bfloat16
    assert out["b"][1].dtype == torch.int64 and out["c"][1] == "x"


# -- the scope ---------------------------------------------------------------


def test_precision_scope_nests_and_restores():
    assert pf.active_policy() is None
    with pf.precision_scope("mixed"):
        assert pf.active_policy() is precision.MIXED
        with pf.precision_scope(None):
            assert pf.active_policy() is None
        assert pf.active_policy() is precision.MIXED
    assert pf.active_policy() is None
    pf.set_policy("int8_inference")
    try:
        assert pf.active_policy() is precision.INT8_INFERENCE
    finally:
        pf.set_policy(None)


def test_precision_scope_is_thread_local():
    seen = {}
    barrier = threading.Barrier(2, timeout=30)

    def other_thread():
        seen["initial"] = pf.active_policy()
        with pf.precision_scope("mixed_inference"):
            seen["scoped"] = pf.active_policy()
            barrier.wait()
            barrier.wait()
        seen["after"] = pf.active_policy()

    with pf.precision_scope("mixed"):
        worker = threading.Thread(target=other_thread)
        worker.start()
        barrier.wait()
        main_during = pf.active_policy()
        barrier.wait()
        worker.join(timeout=30)
    assert not worker.is_alive()
    assert seen["initial"] is None
    assert seen["scoped"] is precision.MIXED_INFERENCE
    assert seen["after"] is None
    assert main_during is precision.MIXED


# -- the JAX function and the port's executor at one policy ------------------


def _jax_tier(kernels, cols, policy):
    """``(rule ids or None, {column: (dtype name, float64 values)})`` of the
    JAX chain at ``policy``: the executor's verdict, then ``_chain_fn``."""
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

    def const(raw):
        host = np.asarray(raw)
        if pol.quant == "int8" and jax_precision.quantizable(host):
            q, s = jax_precision.quantize_absmax(host)
            return jax_pf.QuantizedConst(jnp.asarray(q), jnp.asarray(s))
        return jnp.asarray(raw)

    consts = tuple(tuple(const(k.constants[c]) for c in sorted(k.constants))
                   for k in kernels)
    try:
        jax_pf._validate_chain(
            jax_pf._chain_fn(kernels, ext, outs, bucket, pol), padded,
            consts, kernels, pol)
    except jax_precision.PrecisionValidationError as e:
        return sorted({f.rule for f in e.findings}), None
    res = jax.jit(jax_pf._chain_fn(kernels, ext, outs, bucket, pol))(
        tuple(padded), consts, np.int32(n))
    return None, {c: (jnp.dtype(v.dtype).name,
                      np.asarray(v.astype(jnp.float64)
                                 if v.dtype == jnp.bfloat16 else v)[:n])
                  for c, v in res.items()}


def _port_tier(kernels, cols, policy):
    """The port's fused executor (CPU) at ``policy``: rule ids or the
    outputs, as :func:`_jax_tier`."""
    with pf.precision_scope(policy):
        try:
            out = pf.execute_kernel_chain(fml.Table(dict(cols)), kernels)
        except PrecisionValidationError as e:
            return sorted({f.rule for f in e.findings}), None
    got = {}
    for c in pf._output_cols(kernels):
        dt = out.device_column(c).dtype
        v = out.column(c)
        got[c] = (precision.float_name(dt) if dt.is_floating_point
                  else str(dt).replace("torch.", ""),
                  v.astype(np.float64) if dt.is_floating_point else v)
    return None, got


def _features(n=160, d=20, seed=3):
    x, coef = dense_data(rows=n, d=d, seed=seed)
    return x, coef


def _census():
    from tests.test_torch_features import census_pair

    return census_pair(n=160)


def _tier_cases():
    """``{name: (jax stages, port stages, columns)}``: each ported stage
    alone at a width whose constants the int8 tier quantizes (20), and the
    chains of the slice's serving paths at small widths."""
    from flinkml_tpu_torch.io.read_write import instantiate_with_params

    x, coef = _features()
    scalers = fit_jax_scalers(x)
    cases = {}
    for s in scalers:
        k = s.transform_kernel()
        cases[type(s).__name__] = ([s], {k.input_cols[0]: x})
    rng = np.random.default_rng(9)
    lr = jax_lr.LogisticRegressionModel().set_features_col("features")
    lr.set_model_data(JaxTable({"coefficient": coef[None, :]}))
    cases["binomial"] = ([lr], {"features": x})
    w = rng.normal(size=(10, 20))
    mlr = jax_lr.LogisticRegressionModel().set_features_col("features")
    mlr.set_model_data(JaxTable({"coefficient": w[None]}))
    cases["multinomial"] = ([mlr], {"features": x})
    km = jax_kmeans.KMeansModel().set_features_col("features") \
        .set_model_data(JaxTable({"centroids": x[:6][None]}))
    cases["kmeans"] = ([km], {"features": x})
    js, _, serve = _census()
    cases["onehot"] = ([js[0]], {c: serve[c] for c in ("c0", "c1", "c2")})
    va = jax_va.VectorAssembler().set_input_cols(["x0", "x1", "c0"]) \
        .set_handle_invalid("keep").set_output_col("features")
    cases["assembler"] = ([va], {c: serve[c] for c in ("x0", "x1", "c0")})
    # The slice's chains.
    lr4 = jax_lr.LogisticRegressionModel().set_features_col("s4")
    lr4.set_model_data(JaxTable({"coefficient": coef[None, :]}))
    cases["scaler_lr"] = (scalers + [lr4], {"features": x.astype(np.float32)})
    cases["census"] = (js, serve)
    mlr1 = jax_lr.LogisticRegressionModel().set_features_col("s1")
    mlr1.set_model_data(JaxTable({"coefficient": w[None]}))
    cases["mnist"] = ([scalers[0], mlr1], {"features": x.astype(np.float32)})
    km1 = jax_kmeans.KMeansModel().set_features_col("s1") \
        .set_model_data(JaxTable({"centroids": x[:6][None]}))
    cases["scaler_kmeans"] = ([scalers[0], km1],
                              {"features": x.astype(np.float32)})
    ported = {}
    for name, (stages, cols) in cases.items():
        port = [instantiate_with_params(fml.VectorAssembler,
                                        s.get_param_map_json())
                if isinstance(s, jax_va.VectorAssembler)
                else port_stage_like(s) for s in stages]
        ported[name] = (stages, port, cols)
    return ported


CASES = ("StandardScalerModel", "MinMaxScalerModel", "MaxAbsScalerModel",
         "RobustScalerModel", "binomial", "multinomial", "kmeans", "onehot",
         "assembler", "scaler_lr", "census", "mnist", "scaler_kmeans")


def _decisive(name, jax_stages, cols, want, policy):
    """Rows whose decision is farther than :data:`MARGIN` (relative) from
    its boundary, in float64 over the boundary's rounded head input."""
    head = jax_stages[-1]
    src = head.transform_kernel().input_cols[0]
    xin = want[src][1] if src in want else np.asarray(cols[src], np.float64)
    if policy != "int8_inference":
        xin = torch.tensor(xin).to(torch.bfloat16).double().numpy()
    if isinstance(head, jax_kmeans.KMeansModel):
        c = np.asarray(head.get_model_data()[0].column("centroids"))[0]
        d2 = ((xin[:, None, :] - c[None]) ** 2).sum(-1)
        part = np.sort(d2, axis=1)
        return (part[:, 1] - part[:, 0]) > MARGIN * (part[:, 1] + 1e-12)
    coef = np.asarray(head.get_model_data()[0].column("coefficient"))[0]
    if coef.ndim == 1:
        terms = np.abs(xin * coef).sum(1)
        return np.abs(xin @ coef) > MARGIN * terms
    logits = np.sort(xin @ coef.T, axis=1)
    scale = np.abs(xin) @ np.abs(coef).T
    return (logits[:, -1] - logits[:, -2]) > MARGIN * scale.max(1)


@pytest.mark.parametrize("policy", TIERS)
@pytest.mark.parametrize("name", CASES)
def test_tier_matches_jax(name, policy, on_cpu):
    """Each ported stage alone and each chain of the slice, under each
    tier: the port's executor refuses exactly where the JAX executor's
    FML6xx gate does (same rule ids) and otherwise gives the JAX chain's
    output dtypes and, within the module's tolerances, its values."""
    jax_stages, port_stages, cols = _tier_cases()[name]
    jk = [s.transform_kernel() for s in jax_stages]
    tk = [s.transform_kernel() for s in port_stages]
    verdict, want = _jax_tier(jk, cols, policy)
    got_verdict, got = _port_tier(tk, cols, policy)
    assert got_verdict == verdict
    if verdict is not None:
        return
    assert {c: v[0] for c, v in got.items()} == \
        {c: v[0] for c, v in want.items()}
    for c, (dt, w) in want.items():
        g = got[c][1]
        if c == "rawPrediction":
            np.testing.assert_allclose(g, w, err_msg=c, **RAW_TOL[policy])
        elif c == "prediction":
            keep = _decisive(name, jax_stages, cols, want, policy)
            assert keep.mean() > 0.7, keep.mean()
            np.testing.assert_array_equal(g[keep], w[keep], err_msg=c)
        elif dt == "bfloat16":
            np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=0, err_msg=c)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-12,
                                       err_msg=c)


def test_int8_tier_quantizes_and_stays_close(on_cpu):
    """The JAX package's pinned int8 quality contract on its own pipeline
    (``tests/test_precision.py::_wide_scaler_lr_pipeline``: d = 32, a
    StandardScaler and a 3-iteration LR fit, both fitted by the JAX
    package): the tier is active (rawPrediction differs from float32),
    within 5e-3 of it, and 99% of the predictions agree."""
    from flinkml_tpu.models.logistic_regression import LogisticRegression
    from flinkml_tpu.models.scalers import StandardScaler

    rng = np.random.default_rng(11)
    x = rng.normal(size=(400, 32))
    y = (x @ rng.normal(size=32) > 0).astype(np.float64)
    t = JaxTable({"features": x, "label": y})
    sc = StandardScaler().set(StandardScaler.INPUT_COL, "features") \
        .set(StandardScaler.OUTPUT_COL, "scaled").fit(t)
    (st,) = sc.transform(t)
    lr = LogisticRegression().set(LogisticRegression.FEATURES_COL, "scaled") \
        .set(LogisticRegression.LABEL_COL, "label").set_max_iter(3) \
        .set(LogisticRegression.SEED, 7).fit(st)
    kernels = [port_stage_like(s).transform_kernel() for s in (sc, lr)]
    _, full = _port_tier(kernels, {"features": x}, None)
    _, q = _port_tier(kernels, {"features": x}, "int8_inference")
    dev = np.max(np.abs(q["rawPrediction"][1] - full["rawPrediction"][1]))
    assert 0.0 < dev < 5e-3
    assert np.mean(q["prediction"][1] == full["prediction"][1]) >= 0.99
    assert q["rawPrediction"][0] == "float32"


def test_refused_chain_caches_nothing(on_cpu):
    """Under strict ``mixed`` the KMeans head (bfloat16 distance sums) is
    refused with FML601 before any program or spec is built."""
    _, port_stages, cols = _tier_cases()["scaler_kmeans"]
    model = fml.PipelineModel(port_stages)
    pf.reset_cache()
    with pf.precision_scope("mixed"):
        with pytest.raises(PrecisionValidationError) as ei:
            model.transform(fml.Table(dict(cols)))
    assert {f.rule for f in ei.value.findings} == {"FML601"}
    assert "KMeansModel" in str(ei.value)
    assert pf.compiled_program_count() == 0 and not pf._SPECS
    with pf.precision_scope("mixed_inference"):
        (out,) = model.transform(fml.Table(dict(cols)))
    assert out.column("prediction").dtype == np.int64


def test_check_precision_stored_widths():
    """FML603 (a constant stored narrower than params) and FML607 (int8
    constants under a policy with no quantization scheme), read from the
    stored dtypes."""
    x, coef = _features()
    m = fml.LogisticRegressionModel()
    m.set_model_data(fml.Table({"coefficient": coef[None, :].astype(
        np.float16)}))
    k = m.transform_kernel()
    with pytest.raises(PrecisionValidationError) as ei:
        pf.check_precision([k], [{"coefficient": coef.astype(np.float16)}],
                           precision.MIXED)
    assert [f.rule for f in ei.value.findings] == ["FML603"]
    with pytest.raises(PrecisionValidationError) as ei:
        pf.check_precision([k], [{"coefficient": coef.astype(np.int8)}],
                           precision.FULL)
    assert [f.rule for f in ei.value.findings] == ["FML607"]
    pf.check_precision([k], [{"coefficient": coef.astype(np.int8)}],
                       precision.INT8_INFERENCE)


def test_programs_are_keyed_by_policy(on_cpu):
    """The same chain, specs and bucket under no policy, a bfloat16 tier
    and the int8 tier: three programs, and the float32 bits unchanged after
    the tiers ran."""
    _, port_stages, cols = _tier_cases()["scaler_lr"]
    model = fml.PipelineModel(port_stages)
    pf.reset_cache()
    (a,) = model.transform(fml.Table(dict(cols)))
    raw_a = a.column("rawPrediction")
    n0 = pf.compiled_program_count()
    assert n0 >= 1
    with pf.precision_scope("mixed_inference"):
        (b,) = model.transform(fml.Table(dict(cols)))
        assert b.device_column("rawPrediction").dtype == torch.bfloat16
    n1 = pf.compiled_program_count()
    assert n1 > n0
    with pf.precision_scope("int8_inference"):
        (c,) = model.transform(fml.Table(dict(cols)))
        c.column("rawPrediction")
    assert pf.compiled_program_count() > n1
    (d,) = model.transform(fml.Table(dict(cols)))
    assert d.device_column("rawPrediction").dtype == torch.float32
    np.testing.assert_array_equal(d.column("rawPrediction"), raw_a)


def test_lazy_column_runs_under_captured_policy(on_cpu):
    """A lazy intermediate runs under the policy captured at transform
    time, whichever policy its reader holds."""
    _, port_stages, cols = _tier_cases()["scaler_lr"]
    model = fml.PipelineModel(port_stages)
    with pf.precision_scope("mixed_inference"):
        (o_mix,) = model.transform(fml.Table(dict(cols)))
    assert isinstance(o_mix._raw_column("s2"), fml.table.LazyDeviceColumn)
    assert o_mix.device_column("s2").dtype == torch.bfloat16
    pf.reset_cache()
    (o_plain,) = model.transform(fml.Table(dict(cols)))
    with pf.precision_scope("mixed_inference"):
        s2 = o_plain.device_column("s2")
    assert s2.dtype == torch.float32
    (o_again,) = model.transform(fml.Table(dict(cols)))
    np.testing.assert_array_equal(o_again.column("s2"), s2.numpy())


def test_bf16_column_reads_back_as_float32(on_cpu):
    _, port_stages, cols = _tier_cases()["scaler_lr"]
    with pf.precision_scope("mixed"):
        (out,) = fml.PipelineModel(port_stages).transform(
            fml.Table(dict(cols)))
    host = out.column("s4")
    dev = out.device_column("s4")
    assert dev.dtype == torch.bfloat16 and host.dtype == np.float32
    np.testing.assert_array_equal(host, dev.float().numpy())
    assert out.column("rawPrediction").dtype == np.float32


def test_warmup_transform_builds_each_bucket(on_cpu):
    _, port_stages, cols = _tier_cases()["scaler_lr"]
    model = fml.PipelineModel(port_stages)
    example = fml.Table({"features": cols["features"][:5]})
    pf.reset_cache()
    with pf.precision_scope("mixed_inference"):
        buckets, read = pf.warmup_transform(model, example, [3, 20, 100])
        assert buckets == [8, 32, 128]
        assert "prediction" in read and "s1" in read
        n = pf.compiled_program_count()
        (out,) = model.transform(fml.Table({"features": cols["features"][:90]}))
        out.column("prediction")
        assert pf.compiled_program_count() == n


# -- the CUDA chain's host side under a tier ---------------------------------


def _bf(v):
    return v.to(torch.bfloat16).to(v.dtype)


def _decode_int8(blob, lay, dt):
    """The working table the kernel stages from an int8 blob
    (``csrc/chain.cu`` seg_value), in torch."""
    segs = blob[:lay["n_seg"] * kchain.SEGMENT_INTS * 4].view(np.int32) \
        .reshape(-1, kchain.SEGMENT_INTS)
    vals = blob[lay["vals_at"]:lay["codes_at"]].view(np.float64)
    codes = blob[lay["codes_at"]:].view(np.int8)
    out = torch.zeros(lay["n_table"], dtype=dt)

    def raw(g):
        off, n, kind, src, sc, per = g[:6]
        if kind == 0:
            return torch.from_numpy(vals[src:src + n].copy()).to(dt)
        q = torch.from_numpy(codes[src:src + n].astype(np.float32))
        s = torch.from_numpy(vals[sc:sc + -(-n // per)].astype(np.float32))
        return (q * s.repeat_interleave(per)[:n]).to(dt)

    for g in segs:
        v = raw(g)
        if g[6] == 1:
            v = torch.where(v > 0, v, torch.ones((), dtype=dt))
        elif g[6] == 2:
            v = v - raw(segs[g[7]])
        out[g[0]:g[0] + g[1]] = v
    return out


@pytest.mark.parametrize("name,policy", [
    (name, policy) for name in ("scaler_lr", "mnist", "scaler_kmeans",
                                "census") for policy in TIERS
    # Refused under strict mixed (FML601): nothing is packed.
    if (name, policy) != ("scaler_kmeans", "mixed")])
def test_tier_table_reproduces_plain_chain(name, policy, on_cpu):
    """The constants the host hands the CUDA kernel under a tier (the
    boundary's values in the working table, or the int8 blob decoded as
    the kernel stages it) equal the values the plain chain's stages use:
    the scaler outputs recomputed from the table by the kernel's op
    sequence (each op rounded on a bfloat16 row) equal the plain chain's."""
    _, port_stages, cols = _tier_cases()[name]
    kernels = [s.transform_kernel() for s in port_stages]
    pol = precision.resolve_policy(policy)
    ext = pf.external_inputs(kernels)
    scaler_out = [k.output_cols[0] for k in kernels
                  if k.fingerprint[0] in kchain.SCALER_STAGES][-1:]
    consts = pf._tier_consts(kernels, pol)
    vals = [torch.from_numpy(np.asarray(cols[c])) for c in ext]
    program = kchain.ChainProgram(kernels, ext, scaler_out, pol)
    lay = program.layout(vals)
    plan = program.plan
    if pol.quant:
        blob, ops, info = kchain.pack_int8(plan, kernels, consts, lay.d, pol)
        dt = torch.float64 if lay.dtype == torch.float64 else torch.float32
        table = _decode_int8(blob, info, dt)
    else:
        table, ops = kchain.pack_table(plan, kernels, consts, lay.dtype,
                                       lay.d, pol)
    want = kchain.chain_plain(kernels, ext, scaler_out, vals, consts,
                              len(vals[0]), pol)[scaler_out[0]]
    # The row entering the body, as the plain chain makes it.
    src = kernels[plan.stages[0]].input_cols[0]
    if src in ext:
        row = kchain.boundary(pol, vals, consts)[0][ext.index(src)]
    else:
        row = kchain.chain_plain(kernels, ext, [src], vals, consts,
                                 len(vals[0]), pol)[src]
    v = row.to(table.dtype)
    bf = lay.dtype == torch.bfloat16
    rnd = _bf if bf else (lambda t: t)
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


@pytest.mark.parametrize("name", ["scaler_lr", "mnist", "scaler_kmeans",
                                  "census"])
def test_int8_blob_decodes_to_the_working_table(name, on_cpu):
    """The int8 blob's segments follow the one table layout: decoded as the
    kernel stages it, they give :func:`pack_table`'s values under the same
    policy, element for element (heads and |C|^2 included)."""
    _, port_stages, cols = _tier_cases()[name]
    kernels = [s.transform_kernel() for s in port_stages]
    pol = precision.resolve_policy("int8_inference")
    ext = pf.external_inputs(kernels)
    consts = pf._tier_consts(kernels, pol)
    program = kchain.ChainProgram(kernels, ext,
                                  list(kernels[-1].output_cols), pol)
    lay = program.layout([torch.from_numpy(np.asarray(cols[c]))
                          for c in ext])
    blob, ops, info = kchain.pack_int8(program.plan, kernels, consts, lay.d,
                                       pol)
    table, ops2 = kchain.pack_table(program.plan, kernels, consts, lay.dtype,
                                    lay.d, pol)
    assert ops == ops2 and info["n_table"] == table.numel()
    assert any(isinstance(v, precision.QuantizedConst)
               for kc in consts for v in kc.values())
    torch.testing.assert_close(_decode_int8(blob, info, table.dtype), table,
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_table,per_warp,warps,item,want", [
    # An int8 table stays whole in shared memory: fewer warps when the rows
    # do not fit beside it.
    (1570 + 784 * 64 + 64, 784, 8, 4, (51810, 8, 232328)),
    (1570 + 784 * 64 + 64, 784 + 64, 8, 4, (51810, 7, 230984)),
    # A float64 table too large for shared memory: the stages' constants
    # stay there and the head is read from device memory (the caller then
    # launches on the dequantized float table).
    (1570 + 784 * 64 + 64, 784, 8, 8, (1570, 8, 62736)),
    # No head: the table alone.
    (4 * 130 + 64, 0, 4, 4, (584, 4, 2336)),
])
def test_int8_table_placement_is_whole(n_table, per_warp, warps, item, want):
    """Under ``int8_inference`` the kernel dequantizes the table into
    shared memory whenever the whole table fits beside one warp's rows;
    a larger one gets the float table's placement, not a refusal."""
    assert kchain.shared_memory(n_table, 1570, per_warp, warps, item,
                                whole=True) == want


@pytest.mark.parametrize("policy,row,want", [
    (None, torch.float32, (0, torch.float32, torch.float32)),
    (None, torch.float64, (0, torch.float64, torch.float64)),
    (None, torch.bfloat16, (2, torch.bfloat16, torch.bfloat16)),
    ("mixed", torch.bfloat16, (0, torch.bfloat16, torch.float32)),
    ("mixed_inference", torch.bfloat16, (2, torch.bfloat16, torch.bfloat16)),
    ("int8_inference", torch.float32, (0, torch.float32, torch.float32)),
    ("mixed", torch.float64, (1 | 8, torch.bfloat16, torch.float32)),
    ("mixed_inference", torch.float64, (1 | 2, torch.bfloat16,
                                        torch.bfloat16)),
    ("int8_inference", torch.float64, (4 | 8, torch.float32, torch.float32)),
    ("full", torch.float32, (0, torch.float32, torch.float32)),
])
def test_head_rounding_per_tier(policy, row, want):
    """The head's rounding bits and output dtypes the wrapper hands the
    kernel for each tier and row width (``csrc/chain.cu`` kInBf16 = 1,
    kOutBf16 = 2, kInF32 = 4, kOutF32 = 8): the widths of the JAX chain's
    outputs (prediction at compute, rawPrediction at accum)."""
    _, port_stages, _ = _tier_cases()["binomial"]
    kernels = [s.transform_kernel() for s in port_stages]
    program = kchain.ChainProgram(kernels, ["features"],
                                  ["prediction", "rawPrediction"],
                                  precision.resolve_policy(policy))
    assert program._head_args(row) == want


def test_head_wider_than_a_float_row_is_refused():
    """A custom policy whose head would run in float64 over a float32 or
    bfloat16 row has no kernel: refused, not run at another width."""
    _, port_stages, _ = _tier_cases()["binomial"]
    kernels = [s.transform_kernel() for s in port_stages]
    pol = precision.PrecisionPolicy("wide", "float32", "float64", "float64")
    program = kchain.ChainProgram(kernels, ["features"],
                                  ["prediction", "rawPrediction"], pol)
    with pytest.raises(fml.KernelUnsupportedError, match="float64"):
        program._head_args(torch.float32)
    # Over a float64 row the head's inputs round to float32 (kInF32).
    assert program._head_args(torch.float64) == (4, torch.float32,
                                                 torch.float64)


@pytest.mark.parametrize("policy,dtypes,flags,row", [
    # A float64 input under a bf16 tier: rounded to bf16 at the load.
    ("mixed_inference", {"features": np.float64}, (64,), torch.bfloat16),
    # float32 input under int8 (no rounding: the row is float32).
    ("int8_inference", {"features": np.float32}, (0,), torch.float32),
    # float64 input under int8: rounded to float32 at the load.
    ("int8_inference", {"features": np.float64}, (128,), torch.float32),
])
def test_layout_casts_at_the_boundary(policy, dtypes, flags, row):
    """The CUDA layout under a tier: each float part counts at
    ``policy.compute`` and carries its load-time rounding flag."""
    _, port_stages, cols = _tier_cases()["scaler_lr"]
    kernels = [s.transform_kernel() for s in port_stages]
    vals = [torch.from_numpy(np.asarray(cols["features"], dtypes["features"]))]
    program = kchain.ChainProgram(kernels, ["features"], ["s4"],
                                  precision.resolve_policy(policy))
    lay = program.layout(vals)
    assert lay.flags == flags and lay.dtype == row
    # A float32 input of a bf16 row is read on the dense vector route.
    assert lay.gather == (vals[0].dtype != torch.float32)
