"""The port's OneHotEncoder and VectorAssembler against the JAX package, on
the CPU: fit, the per-stage ``transform`` in every ``outputFormat``,
``dropLast`` and ``handleInvalid`` setting, the ``transform_kernel``
functions against the JAX chain function (XLA, and the Pallas chain kernel
interpreted), the census pipeline (OneHotEncoder → VectorAssembler →
StandardScaler → LogisticRegression) as one chain, and save/load across
the two packages.

Tolerances: one-hot and assembled columns are exact (equal bits, equal
dtypes). The census chain's scaler output within rtol/atol 1e-12 and its
rawPrediction within 1e-10 (float64; the LR dot sums in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.api import ColumnKernel as JaxColumnKernel  # noqa: F401
from flinkml_tpu.io import read_write as jax_rw
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models import one_hot_encoder as jax_ohe
from flinkml_tpu.models import scalers as jax_scalers
from flinkml_tpu.models import vector_assembler as jax_va
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch import pipeline_fusion
from flinkml_tpu_torch.models import one_hot_encoder as torch_ohe
from tests._torch_port_common import (  # noqa: F401
    F64_RAW_RTOL,
    F64_SCALER_RTOL,
    JAX_BACKENDS,
    jax_backend,
    jax_chain_cols,
    on_cpu,
    port_chain_cols,
    port_stage_like,
)

#: Category counts of the census pipeline's columns in this test (small
#: cousins of UCI Adult's).
CARDS = (4, 7, 2)


def _codes(n, seed=0, cards=CARDS):
    rng = np.random.default_rng(seed)
    return {f"c{i}": rng.integers(0, k, size=n) for i, k in enumerate(cards)}


def _encoders(cols, drop_last=True, handle="keep", fmt="dense",
              train=None):
    """``(jax model, port model)`` fitted on ``train`` (default ``cols``)
    over every column of ``cols``."""
    names = sorted(cols)
    outs = [f"o{c}" for c in names]
    train = train or cols

    def setup(est):
        return (est.set_input_cols(names).set_output_cols(outs)
                .set_drop_last(drop_last).set_handle_invalid(handle)
                .set_output_format(fmt))

    jm = setup(jax_ohe.OneHotEncoder()).fit(JaxTable(dict(train)))
    with fml.use_device("cpu"):
        tm = setup(fml.OneHotEncoder()).fit(fml.Table(dict(train)))
    return jm, tm


def _columns(table, names):
    return {c: np.asarray(table.column(c)) for c in names}


def _assert_same_columns(got, want):
    for c, w in want.items():
        g = got[c]
        if w.dtype == object:
            assert g.dtype == object
            for gv, wv in zip(g, w):
                assert gv.size() == wv.size()
                np.testing.assert_array_equal(gv.indices, wv.indices)
                np.testing.assert_array_equal(gv.values, wv.values)
        else:
            assert g.dtype == w.dtype, c
            np.testing.assert_array_equal(g, w, err_msg=c)


# -- OneHotEncoder -----------------------------------------------------------------

def test_onehot_fit_matches_jax(on_cpu):
    cols = _codes(60, seed=1)
    cols["c1"] = cols["c1"].astype(np.float64)
    jm, tm = _encoders(cols)
    np.testing.assert_array_equal(tm._max_indices, jm._max_indices)
    assert tm.get_model_data()[0].column_names == \
        jm.get_model_data()[0].column_names
    for bad, match in (({"c0": np.array([0, -1, 2])}, "negative"),
                       ({"c0": np.array([0.0, 1.5])}, "indexed integer")):
        with pytest.raises(ValueError, match=match):
            jax_ohe.OneHotEncoder().set_input_cols(["c0"]).set_output_cols(
                ["o"]).fit(JaxTable(bad))
        with pytest.raises(ValueError, match=match):
            fml.OneHotEncoder().set_input_cols(["c0"]).set_output_cols(
                ["o"]).fit(fml.Table(bad))


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("handle", ["error", "keep", "skip"])
def test_onehot_transform_matches_jax(fmt, drop_last, handle, on_cpu):
    """Dense and sparse output, dropLast on and off, every handleInvalid
    mode: equal columns on valid codes; with out-of-range codes equal
    columns under ``keep`` (the catch-all slot) and the same refusal under
    ``error``; ``skip`` refused by both."""
    train = _codes(80, seed=2)
    jm, tm = _encoders(train, drop_last, handle, fmt)
    serve = _codes(40, seed=3)
    bad = {c: v.copy() for c, v in serve.items()}
    bad["c0"][:3] = [-1, 4, 9]
    bad["c2"][5] = 2
    outs = [f"o{c}" for c in sorted(train)]
    for cols in (serve, bad):
        if handle == "skip" or (handle == "error" and cols is bad):
            with pytest.raises(ValueError):
                jm.transform(JaxTable(dict(cols)))
            with pytest.raises(ValueError):
                tm.transform(fml.Table(dict(cols)))
            continue
        (jo,) = jm.transform(JaxTable(dict(cols)))
        (to,) = tm.transform(fml.Table(dict(cols)))
        _assert_same_columns(_columns(to, outs), _columns(jo, outs))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
@pytest.mark.parametrize("drop_last", [True, False])
def test_onehot_kernel_fn_matches_jax(dtype, drop_last, on_cpu):
    """The keep-mode kernel function against the JAX one on every index
    type, with out-of-range codes and (float) non-integral ones, which both
    truncate toward zero."""
    import jax.numpy as jnp

    cols = {"c0": np.array([0, 1, 2, 3, -1, 4, 7, 3], dtype=dtype)}
    if np.dtype(dtype).kind == "f":
        cols["c0"][6:] = [2.7, -0.5]
    train = {"c0": np.arange(4)}
    jm, tm = _encoders(train, drop_last)
    jk, tk = jm.transform_kernel(), tm.transform_kernel()
    assert tk.fingerprint == jk.fingerprint
    want = jk.fn({"c0": jnp.asarray(cols["c0"])}, {}, None)["oc0"]
    got = tk.fn({"c0": torch.from_numpy(cols["c0"])}, {}, None)["oc0"]
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_onehot_kernel_non_finite_index_takes_catch_all(on_cpu):
    """NaN and ±inf under ``keep``: the port's kernel function sends each
    to the catch-all slot. The host path agrees on ±inf (an invalid cast
    index) and raises on NaN (a non-integral value); the JAX function's
    ``astype(int32)`` sends NaN to slot 0 (ROADMAP.md Queue 3)."""
    train = {"c0": np.arange(4)}
    jm, tm = _encoders(train, drop_last=False)
    vals = np.array([1.0, np.inf, -np.inf, np.nan])
    got = torch_ohe.encode_keep(torch.from_numpy(vals), 3, False).numpy()
    np.testing.assert_array_equal(got[1:], np.eye(5)[[4, 4, 4]])
    np.testing.assert_array_equal(got[0], np.eye(5)[1])
    (host,) = tm.transform(fml.Table({"c0": vals[:3]}))
    np.testing.assert_array_equal(host.column("oc0"), got[:3])
    with pytest.raises(ValueError, match="indexed integer"):
        tm.transform(fml.Table({"c0": vals}))
    with pytest.raises(ValueError, match="indexed integer"):
        jm.transform(JaxTable({"c0": vals}))


def test_onehot_kernel_gates(on_cpu):
    jm, tm = _encoders(_codes(20))
    assert tm.transform_kernel() is not None
    for param, value in ((tm.HANDLE_INVALID, "error"),
                         (tm.OUTPUT_FORMAT, "sparse")):
        _, m = _encoders(_codes(20))
        assert m.set(param, value).transform_kernel() is None
    assert fml.OneHotEncoderModel().transform_kernel() is None


# -- VectorAssembler ---------------------------------------------------------------

def _assembler_cols(n=30, seed=4, bad_rows=()):
    rng = np.random.default_rng(seed)
    cols = {
        "v32": rng.normal(size=(n, 3)).astype(np.float32),
        "s64": rng.normal(size=n),
        "i": rng.integers(-5, 5, size=n),
        "b": rng.random(n) > 0.5,
    }
    for r in bad_rows:
        cols["s64"][r] = np.inf if r % 2 else np.nan
    return cols


@pytest.mark.parametrize("handle", ["error", "skip", "keep"])
@pytest.mark.parametrize("inputs", [("v32", "s64", "i", "b"), ("v32",),
                                    ("i", "v32")])
def test_vector_assembler_matches_jax(handle, inputs, on_cpu):
    """Every handleInvalid mode over mixed dtypes (float32 matrix, float64
    scalar, int, bool) with non-finite rows: the same columns (values and
    dtype), rows kept or dropped, or the same refusal."""
    cols = _assembler_cols(bad_rows=(2, 7))
    j = jax_va.VectorAssembler().set_input_cols(list(inputs)) \
        .set_handle_invalid(handle).set_output_col("f")
    t = fml.VectorAssembler().set_input_cols(list(inputs)) \
        .set_handle_invalid(handle).set_output_col("f")
    finite = "s64" not in inputs
    if handle == "error" and not finite:
        with pytest.raises(ValueError, match="non-finite"):
            j.transform(JaxTable(dict(cols)))
        with pytest.raises(ValueError, match="non-finite"):
            t.transform(fml.Table(dict(cols)))
        return
    (jo,) = j.transform(JaxTable(dict(cols)))
    (to,) = t.transform(fml.Table(dict(cols)))
    assert to.num_rows == jo.num_rows
    _assert_same_columns(_columns(to, list(cols) + ["f"]),
                         _columns(jo, list(cols) + ["f"]))


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("inputs,dtype", [
    (("v32",), np.float32), (("v32", "s64", "i", "b"), np.float64),
    (("i",), np.float64),
])
def test_vector_assembler_kernel_matches_jax(backend, inputs, dtype,
                                             monkeypatch, on_cpu):
    """The keep-mode kernel function against the JAX chain function: the
    same bits and the result_type dtype rule (float32 stays float32)."""
    cols = _assembler_cols(bad_rows=(3,))
    jax_backend(monkeypatch, backend, "fused_chain")
    j = jax_va.VectorAssembler().set_input_cols(list(inputs)) \
        .set_handle_invalid("keep").set_output_col("f")
    t = fml.VectorAssembler().set_input_cols(list(inputs)) \
        .set_handle_invalid("keep").set_output_col("f")
    want = jax_chain_cols([j.transform_kernel()], cols, backend)["f"]
    got = port_chain_cols([t.transform_kernel()], cols)["f"]
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


# -- the census chain ----------------------------------------------------------------

def census_pair(n=120, seed=5):
    """OneHotEncoder(dropLast, keep) → VectorAssembler(keep) →
    StandardScaler → LogisticRegressionModel, built in both packages from
    the JAX fits; ``(jax stages, port stages, serving columns)``. The
    serving columns hold out-of-range codes (the catch-all slot)."""
    rng = np.random.default_rng(seed)
    train = _codes(n, seed=seed)
    train["x0"] = rng.normal(size=n) * 10 + 40
    train["x1"] = rng.normal(size=(n, 2)).astype(np.float32)
    jm, _ = _encoders({c: v for c, v in train.items() if c.startswith("c")})
    va = jax_va.VectorAssembler().set_input_cols(
        ["oc0", "x0", "oc1", "x1", "oc2"]).set_handle_invalid("keep") \
        .set_output_col("features")
    (t,) = jm.transform(JaxTable(dict(train)))
    (t,) = va.transform(t)
    sc = jax_scalers.StandardScaler().set_input_col("features") \
        .set_output_col("scaled").fit(t)
    lr = jax_lr.LogisticRegressionModel().set_features_col("scaled")
    d = t.column("features").shape[1]
    lr.set_model_data(JaxTable({"coefficient": rng.normal(size=(1, d))}))
    jax_stages = [jm, va, sc, lr]
    port_stages = [port_stage_like(jm), _port_assembler(va),
                   port_stage_like(sc), port_stage_like(lr)]
    serve = _codes(n, seed=seed + 1)
    serve["c0"][:2] = [-1, 99]
    serve["c1"][3] = 7
    serve["x0"] = rng.normal(size=n) * 10 + 40
    serve["x1"] = rng.normal(size=(n, 2)).astype(np.float32)
    return jax_stages, port_stages, serve


def _port_assembler(jax_stage):
    """The port's VectorAssembler with the JAX one's params."""
    from flinkml_tpu_torch.io.read_write import instantiate_with_params

    return instantiate_with_params(fml.VectorAssembler,
                                   jax_stage.get_param_map_json())


@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_census_chain_matches_jax(backend, monkeypatch, on_cpu):
    """The census chain as one fused program: the port's plain chain
    against the JAX chain function, every column of the chain."""
    jax_stages, port_stages, serve = census_pair()
    jax_backend(monkeypatch, backend, "fused_chain")
    want = jax_chain_cols([s.transform_kernel() for s in jax_stages], serve,
                          backend)
    got = port_chain_cols([s.transform_kernel() for s in port_stages], serve)
    assert set(got) == set(want)
    for c in ("oc0", "oc1", "oc2", "features"):
        assert got[c].dtype == want[c].dtype == np.float64
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    np.testing.assert_allclose(got["scaled"], want["scaled"],
                               rtol=F64_SCALER_RTOL, atol=F64_SCALER_RTOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL)
    dot = want["scaled"] @ jax_stages[-1].coefficient
    decisive = np.abs(dot) > 1e-9
    np.testing.assert_array_equal(got["prediction"][decisive],
                                  want["prediction"][decisive])


def test_census_pipeline_fused_matches_jax_per_stage(on_cpu):
    """``PipelineModel.transform`` of the census chain, fused (one
    program, lazy intermediates) and per-stage in the port, against the
    JAX package's per-stage transform."""
    from flinkml_tpu import pipeline_fusion as jax_fusion
    from flinkml_tpu.pipeline import PipelineModel as JaxPipelineModel

    jax_stages, port_stages, serve = census_pair()
    cols = ("oc0", "oc1", "oc2", "features", "scaled", "prediction",
            "rawPrediction")
    jax_fusion.set_enabled(False)
    try:
        (jo,) = JaxPipelineModel(jax_stages).transform(JaxTable(dict(serve)))
    finally:
        jax_fusion.set_enabled(True)
    model = fml.PipelineModel(port_stages)
    (fused,) = model.transform(fml.Table(dict(serve)))
    assert pipeline_fusion.compiled_program_count() == 1
    assert fused.is_device_resident("features")
    pipeline_fusion.set_enabled(False)
    try:
        (per_stage,) = model.transform(fml.Table(dict(serve)))
    finally:
        pipeline_fusion.set_enabled(True)
    for out in (fused, per_stage):
        got = _columns(out, cols)
        want = _columns(jo, cols)
        for c in ("oc0", "oc1", "oc2", "features"):
            assert got[c].dtype == want[c].dtype
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
        np.testing.assert_allclose(got["scaled"], want["scaled"],
                                   rtol=F64_SCALER_RTOL, atol=F64_SCALER_RTOL)
        np.testing.assert_allclose(got["rawPrediction"],
                                   want["rawPrediction"], rtol=F64_RAW_RTOL,
                                   atol=F64_RAW_RTOL)
    # Reading the lazy intermediates ran truncated programs.
    assert pipeline_fusion.compiled_program_count() > 1


def test_census_pipeline_fit(on_cpu):
    """``Pipeline.fit`` of the census stages in the port: the encoder's and
    scaler's model data equal the JAX package's fits on the same table."""
    from flinkml_tpu.pipeline import Pipeline as JaxPipeline

    train = _codes(150, seed=8)
    train["x0"] = np.random.default_rng(8).normal(size=150)
    train["label"] = (train["c0"] > 1).astype(np.float64)

    def stages(pkg_ohe, pkg_va, pkg_sc):
        return [
            pkg_ohe.OneHotEncoder().set_input_cols(["c0", "c1"])
            .set_output_cols(["o0", "o1"]).set_handle_invalid("keep"),
            pkg_va.VectorAssembler().set_input_cols(["o0", "x0", "o1"])
            .set_handle_invalid("keep").set_output_col("features"),
            pkg_sc.StandardScaler().set_input_col("features")
            .set_output_col("scaled"),
        ]

    from flinkml_tpu_torch.models import scalers as torch_scalers
    from flinkml_tpu_torch.models import vector_assembler as torch_va

    jfit = JaxPipeline(stages(jax_ohe, jax_va, jax_scalers)).fit(
        JaxTable(dict(train)))
    tfit = fml.Pipeline(stages(torch_ohe, torch_va, torch_scalers)).fit(
        fml.Table(dict(train)))
    np.testing.assert_array_equal(tfit.stages[0]._max_indices,
                                  jfit.stages[0]._max_indices)
    for c in ("mean", "std"):
        np.testing.assert_allclose(
            tfit.stages[2].get_model_data()[0].column(c),
            jfit.stages[2].get_model_data()[0].column(c),
            rtol=1e-5, atol=1e-6)


# -- save / load across the packages --------------------------------------------------

def test_features_save_load_across_packages(tmp_path, on_cpu):
    """OneHotEncoderModel and VectorAssembler saved by one package load in
    the other with the same params and model data, and transform alike."""
    jm, tm = _encoders(_codes(40, seed=9), drop_last=False)
    va_j = jax_va.VectorAssembler().set_input_cols(["oc0", "oc1"]) \
        .set_handle_invalid("keep").set_output_col("f")
    va_t = _port_assembler(va_j)
    for i, (jax_stage, port_stage) in enumerate(((jm, tm), (va_j, va_t))):
        jp, tp = str(tmp_path / f"j{i}"), str(tmp_path / f"t{i}")
        jax_stage.save(jp)
        port_stage.save(tp)
        from_jax = fml.load_stage(jp)
        from_port = jax_rw.load_stage(tp)
        assert type(from_jax).__name__ == type(jax_stage).__name__
        assert type(from_port).__name__ == type(port_stage).__name__
        assert from_jax.get_param_map_json() == jax_stage.get_param_map_json()
        assert from_port.get_param_map_json() == \
            port_stage.get_param_map_json()
    serve = _codes(10, seed=10)
    (a,) = fml.load_stage(str(tmp_path / "j0")).transform(fml.Table(serve))
    (b,) = jax_rw.load_stage(str(tmp_path / "t0")).transform(JaxTable(serve))
    _assert_same_columns(_columns(a, ["oc0", "oc1", "oc2"]),
                         _columns(b, ["oc0", "oc1", "oc2"]))
