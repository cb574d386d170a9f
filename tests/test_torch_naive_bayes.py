"""The port's NaiveBayes against the JAX package's, on the CPU.

A mirror of ``tests/test_naive_bayes.py`` on the port, plus parity: the
counts (through ``keyed_aggregate``, the ``segment_sum`` kernel's plain
version here), ``theta``, ``pi``, the log posteriors and the predictions
equal JAX's bit for bit in float64 (integer counts are exact, and the
per-feature terms add in the same order); models saved by either package
load in the other; a fit on a mesh of P = 2 gloo ranks equals the
one-rank fit bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu.models import NaiveBayes as JaxNaiveBayes
from flinkml_tpu.models import NaiveBayesModel as JaxNaiveBayesModel
from flinkml_tpu.table import Table as JaxTable
from flinkml_tpu_torch.models import naive_bayes as t_nb
from flinkml_tpu_torch.parallel import DeviceMesh
from tests import _torch_mesh_worker as worker
from tests._torch_port_common import on_cpu  # noqa: F401
from tests.test_torch_parallel import launch


@pytest.fixture
def train_table():
    x = np.array(
        [[0, 0], [0, 1], [1, 0], [1, 1], [2, 1], [2, 0], [2, 1]],
        dtype=np.float64,
    )
    y = np.array([0, 0, 0, 1, 1, 1, 1], dtype=np.float64)
    return fml.Table({"features": x, "label": y})


def _census_like(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    cards = (9, 16, 7, 15, 6, 5, 2, 42, 73, 16, 99)
    x = np.stack([rng.integers(0, c, size=n) for c in cards], 1).astype(float)
    y = ((x[:, 0] + x[:, 3] + rng.integers(0, 2, size=n)) % 2).astype(float)
    return x, y


def test_param_defaults():
    nb = fml.NaiveBayes()
    assert nb.get_smoothing() == 1.0
    assert nb.get_features_col() == "features"
    assert nb.get_param_map_json() == JaxNaiveBayes().get_param_map_json()


def test_fit_predict(train_table, on_cpu):
    model = fml.NaiveBayes().fit(train_table)
    (out,) = model.transform(train_table)
    acc = np.mean(out.column("prediction") == train_table.column("label"))
    assert acc >= 6 / 7


def test_exact_smoothing_formula(train_table, on_cpu):
    model = fml.NaiveBayes().set_smoothing(1.0).fit(train_table)
    i0 = int(np.where(model._labels == 0)[0][0])
    np.testing.assert_allclose(
        model._theta[i0, 0, :3],
        [np.log(3 / 6), np.log(2 / 6), np.log(1 / 6)], rtol=1e-12)
    i1 = 1 - i0
    np.testing.assert_allclose(model._pi[i0],
                               np.log(3 * 2 + 1) - np.log(14 + 2))
    np.testing.assert_allclose(model._pi[i1],
                               np.log(4 * 2 + 1) - np.log(14 + 2))


@pytest.mark.parametrize("smoothing", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_fit_and_predictions_equal_jax_bit_for_bit(smoothing, seed, on_cpu):
    x, y = _census_like(seed=seed)
    got = fml.NaiveBayes().set_smoothing(smoothing).fit(
        fml.Table({"features": x, "label": y}))
    want = JaxNaiveBayes().set_smoothing(smoothing).fit(
        JaxTable({"features": x, "label": y}))
    np.testing.assert_array_equal(got._theta, want._theta)
    np.testing.assert_array_equal(got._pi, want._pi)
    np.testing.assert_array_equal(got._labels, want._labels)
    for a, b in zip(got._cat_values, want._cat_values):
        np.testing.assert_array_equal(a, b)
    # The log posteriors, as the JAX transform computes them.
    idx = got.category_ids(torch.from_numpy(x))
    theta = jnp.asarray(want._theta)
    gathered = jnp.take_along_axis(
        theta[None], jnp.asarray(idx.numpy())[:, None, :, None], axis=3)[..., 0]
    probs = np.asarray(jnp.asarray(want._pi)[None, :]
                       + jnp.sum(gathered, axis=2))
    np.testing.assert_array_equal(got.scores(idx).numpy(), probs)
    (a,) = got.transform(fml.Table({"features": x}))
    (b,) = want.transform(JaxTable({"features": x}))
    np.testing.assert_array_equal(a.column("prediction"), b["prediction"])


def test_counts_are_exact(on_cpu):
    x, y = _census_like(n=777, seed=3)
    rng = np.random.default_rng(1)
    flat = rng.integers(0, 50, size=5000)
    want = np.zeros(50)
    np.add.at(want, flat, 1.0)
    np.testing.assert_array_equal(
        t_nb.count_triples(DeviceMesh(), flat, 50), want)


def test_against_sklearn(on_cpu):
    from sklearn.naive_bayes import CategoricalNB

    rng = np.random.default_rng(0)
    n = 300
    x = rng.integers(0, 4, size=(n, 3)).astype(np.float64)
    y = ((x[:, 0] >= 2) ^ (rng.random(n) < 0.15)).astype(np.float64)
    model = fml.NaiveBayes().set_smoothing(1.0).fit(
        fml.Table({"features": x, "label": y}))
    (out,) = model.transform(fml.Table({"features": x}))
    sk = CategoricalNB(alpha=1.0).fit(x.astype(int), y)
    assert np.mean(out.column("prediction") == sk.predict(x.astype(int))) \
        >= 0.97


def test_unseen_value_raises(train_table, on_cpu):
    model = fml.NaiveBayes().fit(train_table)
    with pytest.raises(ValueError, match="never seen"):
        model.transform(fml.Table({"features": np.array([[0.0, 99.0]])}))


def test_non_integer_label_raises(on_cpu):
    t = fml.Table({"features": np.zeros((2, 2)),
                   "label": np.array([0.5, 1.0])})
    with pytest.raises(ValueError, match="indexed"):
        fml.NaiveBayes().fit(t)


def test_feature_count_mismatch(train_table, on_cpu):
    model = fml.NaiveBayes().fit(train_table)
    with pytest.raises(ValueError, match="features"):
        model.transform(fml.Table({"features": np.zeros((1, 5))}))
    with pytest.raises(ValueError, match="Model data is not set"):
        fml.NaiveBayesModel().transform(train_table)
    with pytest.raises(TypeError, match="DeviceMesh"):
        fml.NaiveBayes(mesh=object())


def test_save_load_across_packages(tmp_path, train_table, on_cpu):
    x = train_table.column("features")
    y = train_table.column("label")
    port = fml.NaiveBayes().set_smoothing(2.0).fit(train_table)
    port.save(str(tmp_path / "port"))
    loaded = JaxNaiveBayesModel.load(str(tmp_path / "port"))
    assert loaded.get_smoothing() == 2.0
    np.testing.assert_array_equal(
        loaded.transform(JaxTable({"features": x}))[0]["prediction"],
        port.transform(fml.Table({"features": x}))[0].column("prediction"))
    jax_model = JaxNaiveBayes().set_smoothing(2.0).fit(
        JaxTable({"features": x, "label": y}))
    jax_model.save(str(tmp_path / "jax"))
    back = fml.load_stage(str(tmp_path / "jax"))
    assert isinstance(back, fml.NaiveBayesModel)
    np.testing.assert_array_equal(back._theta, jax_model._theta)
    np.testing.assert_array_equal(
        back.transform(fml.Table({"features": x}))[0].column("prediction"),
        jax_model.transform(JaxTable({"features": x}))[0]["prediction"])
    own = fml.NaiveBayesModel.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(own._theta, port._theta)


def test_model_data_round_trip(train_table, on_cpu):
    model = fml.NaiveBayes().fit(train_table)
    other = fml.NaiveBayesModel().set_model_data(*model.get_model_data())
    (a,) = model.transform(train_table)
    (b,) = other.transform(train_table)
    np.testing.assert_array_equal(a.column("prediction"),
                                  b.column("prediction"))
    jax_model = JaxNaiveBayesModel().set_model_data(
        *[JaxTable({k: t.column(k) for k in t.column_names})
          for t in model.get_model_data()])
    np.testing.assert_array_equal(jax_model._theta, model._theta)


def test_mesh_fit_at_two_ranks(tmp_path, on_cpu):
    """NaiveBayes(mesh=...) on two gloo ranks: the ranks' counts are each
    rank's block of cells, summed by one all-reduce; theta, pi and the
    predictions equal the one-rank fit (and JAX's) bit for bit."""
    outs = launch("naive_bayes", 2, str(tmp_path))
    x, y = worker.naive_bayes_data()
    want = JaxNaiveBayes().fit(JaxTable({"features": x, "label": y}))
    for out in outs:
        np.testing.assert_array_equal(out["nb_theta"], want._theta)
        np.testing.assert_array_equal(out["nb_pi"], want._pi)
        np.testing.assert_array_equal(
            out["nb_pred"],
            want.transform(JaxTable({"features": x}))[0]["prediction"])
