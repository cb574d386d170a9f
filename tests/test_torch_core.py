"""The PyTorch port's core (``flinkml_tpu_torch``): package boundary,
device policy, params/JSON and Table parity with the JAX package, and
save/load across the two packages in both directions."""

from __future__ import annotations

import ast
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.io import read_write as jax_rw
from flinkml_tpu.models import logistic_regression as jax_lr
from flinkml_tpu.models import scalers as jax_scalers
from flinkml_tpu.pipeline import PipelineModel as JaxPipelineModel
from flinkml_tpu_torch.io import read_write as torch_rw
from flinkml_tpu_torch.models import logistic_regression as torch_lr
from flinkml_tpu_torch.models import scalers as torch_scalers
from tests._torch_port_common import (  # noqa: F401
    F64_RAW_RTOL,
    F64_SCALER_RTOL,
    SCALER_NAMES,
    dense_data,
    five_stage_pair,
    jax_per_stage,
    on_cpu,
    outputs,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "flinkml_tpu_torch"


def _forbidden(module: str) -> bool:
    return (module in ("jax", "jaxlib", "flinkml_tpu")
            or module.startswith(("jax.", "jaxlib.", "flinkml_tpu.")))


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_device"):
        fml.default_device()
    model = fml.StandardScalerModel().set_model_data(
        fml.Table({"mean": np.zeros((1, 2)), "std": np.ones((1, 2))}))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        model.transform(fml.Table({"input": np.ones((3, 2))}))
    with pytest.raises(RuntimeError):
        fml.use_device("cuda")
    with fml.use_device("cpu"):
        assert fml.default_device() == torch.device("cpu")


def test_use_device_nests_and_restores():
    with fml.use_device("cpu"):
        with fml.use_device("cpu") as dev:
            assert dev == torch.device("cpu")
        assert fml.default_device().type == "cpu"
    with pytest.raises(ValueError):
        fml.use_device("mps")


@pytest.mark.parametrize("name", SCALER_NAMES + tuple(
    f"{n}Model" for n in SCALER_NAMES))
def test_scaler_param_maps_match_jax(name):
    """Default and set param maps are byte-identical JSON in both packages
    (the content fingerprint hashes them)."""
    j, t = getattr(jax_scalers, name)(), getattr(torch_scalers, name)()
    assert json.dumps(j.get_param_map_json(), sort_keys=True) == \
        json.dumps(t.get_param_map_json(), sort_keys=True)
    j.set(j.INPUT_COL, "a").set(j.OUTPUT_COL, "b")
    t.set(t.INPUT_COL, "a").set(t.OUTPUT_COL, "b")
    assert json.dumps(j.get_param_map_json(), sort_keys=True) == \
        json.dumps(t.get_param_map_json(), sort_keys=True)


def test_lr_param_map_matches_jax():
    j = jax_lr.LogisticRegressionModel().set_prediction_col("p").set_seed(7)
    t = torch_lr.LogisticRegressionModel().set_prediction_col("p").set_seed(7)
    assert json.dumps(j.get_param_map_json(), sort_keys=True) == \
        json.dumps(t.get_param_map_json(), sort_keys=True)
    t2 = torch_lr.LogisticRegressionModel().load_param_map_json(
        j.get_param_map_json())
    assert t2.get_param_map_json() == j.get_param_map_json()


def test_linalg_matches_jax_package():
    from flinkml_tpu import linalg as jl

    sv = fml.Vectors.sparse(6, [4, 1], [2.0, 3.0])
    jsv = jl.Vectors.sparse(6, [4, 1], [2.0, 3.0])
    np.testing.assert_array_equal(sv.indices, jsv.indices)
    np.testing.assert_array_equal(sv.to_array(), jsv.to_array())
    with pytest.raises(ValueError, match="duplicate"):
        fml.SparseVector(4, [1, 1], [1.0, 2.0])
    dv = fml.Vectors.dense(1.0, 2.0, 3.0)
    assert dv.dot(fml.Vectors.dense([1.0, 1.0, 1.0])) == 6.0
    from flinkml_tpu_torch.linalg import next_pow2

    assert [next_pow2(n) for n in (0, 1, 5, 8, 9)] == [1, 1, 8, 8, 16]


def test_table_host_and_device_columns(on_cpu):
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    t = fml.Table({"x": x, "y": np.arange(4)})
    dev = t.device_column("x")
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    padded = t.device_column_padded("x", 8)
    assert padded.shape == (8, 3)
    assert torch.equal(padded[:4], dev) and not padded[4:].any()
    t2 = t.with_column("z", dev * 2)
    assert t2.is_device_resident("z") and not t2.is_device_resident("x")
    np.testing.assert_array_equal(t2.column("z"), x * 2)
    assert t2.select("z", "y").column_names == ["z", "y"]
    assert t2.rename({"z": "w"}).column_names == ["x", "y", "w"]
    np.testing.assert_array_equal(t2.slice(1, 3).column("z"), x[1:3] * 2)
    with pytest.raises(ValueError, match="rows"):
        fml.Table({"a": np.zeros(3), "b": np.zeros(4)})
    obj = fml.Table({"v": np.array([fml.Vectors.dense(1.0)], dtype=object)})
    with pytest.raises(TypeError, match="object"):
        obj.device_column("v")


def test_lazy_and_padded_columns(on_cpu):
    from flinkml_tpu_torch.table import LazyDeviceColumn, PaddedDeviceColumn

    calls = []

    def thunk():
        calls.append(1)
        return torch.arange(16.0).reshape(8, 2)

    lazy = LazyDeviceColumn(thunk, 5, (8, 2), torch.float32)
    t = fml.Table({"a": lazy, "b": PaddedDeviceColumn(torch.ones(8), 5)})
    assert t.num_rows == 5 and not calls
    np.testing.assert_array_equal(t.column("a"),
                                  np.arange(10.0).reshape(5, 2))
    t.column("a")
    assert calls == [1]
    assert t.column("b").shape == (5,)


def _save_jax_chain(path, x, coef):
    jax_model, _ = five_stage_pair(x, coef)
    jax_model.save(path)
    return jax_model


def test_jax_saves_port_loads(tmp_path, on_cpu):
    """A PipelineModel saved by the JAX package loads in the port (class
    names mapped, fingerprints verified) and transforms to the same
    outputs."""
    x, coef = dense_data()
    path = str(tmp_path / "m")
    jax_model = _save_jax_chain(path, x, coef)
    port = fml.PipelineModel.load(path)
    assert [type(s).__module__.split(".")[0] for s in port.stages] == \
        ["flinkml_tpu_torch"] * 5
    stage0 = torch_rw.load_stage(os.path.join(path, "stages", "0"))
    assert isinstance(stage0, torch_scalers.StandardScalerModel)
    want = jax_per_stage(jax_model, x)
    (got,) = port.transform(fml.Table({"features": x}))
    got = outputs(got)
    for c in ("s1", "s2", "s3", "s4"):
        np.testing.assert_allclose(got[c], want[c], rtol=F64_SCALER_RTOL,
                                   atol=F64_SCALER_RTOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL)


def test_port_saves_jax_loads(tmp_path, on_cpu):
    """A PipelineModel saved by the port carries the JAX package's class
    names and fingerprints: the JAX package loads and verifies it, and
    transforms to the same outputs."""
    x, coef = dense_data(seed=1)
    _, port = five_stage_pair(x, coef)
    path = str(tmp_path / "m")
    port.save(path)
    jax_model = JaxPipelineModel.load(path)
    assert type(jax_model.stages[4]).__module__ == \
        "flinkml_tpu.models.logistic_regression"
    for i in range(5):
        sp = os.path.join(path, "stages", str(i))
        assert jax_rw.verify_fingerprint(sp) is not None
    want = jax_per_stage(jax_model, x)
    (got,) = port.transform(fml.Table({"features": x}))
    got = outputs(got)
    np.testing.assert_allclose(got["s4"], want["s4"], rtol=F64_SCALER_RTOL,
                               atol=F64_SCALER_RTOL)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=F64_RAW_RTOL, atol=F64_RAW_RTOL)


def test_same_metadata_and_fingerprint_as_jax(tmp_path):
    """Both packages write the same class name, param map and content
    fingerprint for the same model."""
    x, coef = dense_data(seed=2)
    jax_model, port = five_stage_pair(x, coef)
    for i, (js, ts) in enumerate(zip(jax_model.stages, port.stages)):
        js.save(str(tmp_path / f"j{i}"))
        ts.save(str(tmp_path / f"t{i}"))
        jm = json.loads((tmp_path / f"j{i}" / "metadata").read_text())
        tm = json.loads((tmp_path / f"t{i}" / "metadata").read_text())
        jm.pop("timestamp")
        tm.pop("timestamp")
        assert jm == tm
        ja = jax_rw.load_model_arrays(str(tmp_path / f"j{i}"))
        ta = torch_rw.load_model_arrays(str(tmp_path / f"t{i}"))
        assert ja.keys() == ta.keys()
        for k in ja:
            assert ja[k].dtype == ta[k].dtype
            np.testing.assert_array_equal(ja[k], ta[k])


def test_tampered_model_refuses_to_load(tmp_path, on_cpu):
    x, coef = dense_data(seed=3)
    _, port = five_stage_pair(x, coef)
    path = str(tmp_path / "lr")
    port.stages[4].save(path)
    arrays = torch_rw.load_model_arrays(path)
    arrays["coefficient"] = arrays["coefficient"] + 1e-9
    torch_rw.save_model_arrays(path, arrays)
    with pytest.raises(fml.ModelIntegrityError, match="fingerprint"):
        torch_lr.LogisticRegressionModel.load(path)
    with pytest.raises(ValueError, match="className"):
        torch_scalers.StandardScalerModel.load(path)


def test_stage_from_arrays_and_multinomial_refusal():
    m = fml.stage_from_arrays(
        "flinkml_tpu.models.logistic_regression.LogisticRegressionModel",
        {"featuresCol": "f"}, {"coefficient": np.arange(3.0)})
    assert isinstance(m, torch_lr.LogisticRegressionModel)
    assert m.get_features_col() == "f"
    np.testing.assert_array_equal(m.coefficient, np.arange(3.0))
    with pytest.raises(NotImplementedError, match="multinomial"):
        fml.stage_from_arrays(
            "flinkml_tpu_torch.models.logistic_regression."
            "LogisticRegressionModel", {}, {"coefficient": np.ones((3, 4))})
    with pytest.raises(ImportError):
        fml.stage_from_arrays("os.path", {}, {})
