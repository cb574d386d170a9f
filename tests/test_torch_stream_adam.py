"""The port's streamed Adam fits (``flinkml_tpu_torch.models._adam.
run_streamed_adam``, MLPClassifier and FMClassifier) against the JAX
package's, on the CPU at world 1.

The MLP and FM cases of ``tests/test_stream_fit_mlp_pca.py`` on the port,
with the JAX tests' assertions (spilled equals in-RAM and a resume equals
the uninterrupted run bit for bit; the fits learn; the refusals), plus
parity: a whole streamed fit equals JAX's on a one-device mesh within
1e-5 (the same padded chunks, the same draws, float32 summation order),
and a JAX snapshot of the full Adam state resumes in the port.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import flinkml_tpu.models as jm
from flinkml_tpu.iteration import CheckpointManager as JCheckpointManager
from flinkml_tpu.iteration.datacache import cache_stream as jcache_stream
from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.iteration import CheckpointManager
from flinkml_tpu_torch.iteration.datacache import cache_stream
from flinkml_tpu_torch.models import FMClassifier, MLPClassifier
from flinkml_tpu_torch.table import Table
from tests import _torch_recsys_cases as cases

TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = {
    "mlp": (MLPClassifier, jm.MLPClassifier, cases.mlp_estimator, np.int32),
    "fm": (FMClassifier, jm.FMClassifier, cases.fm_estimator, np.float32),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _crash_manager_cls(base, crash_at_epoch):
    class Crash(base):
        fired = False

        def save(self, state, epoch, extra=None, **kw):
            p = super().save(state, epoch, extra, **kw)
            if not Crash.fired and epoch >= crash_at_epoch:
                Crash.fired = True
                raise RuntimeError("injected crash")
            return p

    return Crash


def _cache(batches, ylab, make=cache_stream):
    return make({"x": b["features"], "y": b["label"].astype(ylab),
                 "w": np.ones(len(b["label"]), np.float32)} for b in batches)


def _weights(model):
    return cases._flat_model(model)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stream_spilled_matches_ram_exactly_and_jax(tmp_path, name):
    cls, jcls, make, _ = FAMILIES[name]
    batches = cases.adam_batches()
    ram = make(cls).fit(iter(Table(b) for b in batches))
    spilled = make(cls, cache_dir=str(tmp_path / name),
                   cache_memory_budget_bytes=1).fit(
        iter(Table(b) for b in batches))
    for a, b in zip(_weights(ram), _weights(spilled)):
        np.testing.assert_array_equal(a, b)
    assert any((tmp_path / name).glob("segment-*.bin"))
    from flinkml_tpu.table import Table as JTable

    ref = make(jcls, mesh=JMesh(devices=jax.devices()[:1])).fit(
        iter(JTable(b) for b in batches))
    for a, b in zip(_weights(ram), _weights(ref)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stream_learns(name):
    cls, _, make, _ = FAMILIES[name]
    batches = cases.adam_batches(n_batches=6)
    model = make(cls).set_max_iter(25).fit(iter(Table(b) for b in batches))
    big_x = np.concatenate([b["features"] for b in batches])
    big_y = np.concatenate([b["label"] for b in batches])
    (out,) = model.transform(Table({"features": big_x}))
    acc = float((out.column("prediction") == big_y).mean())
    assert acc > (0.9 if name == "mlp" else 0.85), acc


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stream_resume_exact(tmp_path, name):
    cls, _, make, ylab = FAMILIES[name]
    cache = _cache(cases.adam_batches(), ylab)
    golden = make(cls).fit(cache)
    mgr = _crash_manager_cls(CheckpointManager, 2)(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="injected"):
        make(cls, checkpoint_manager=mgr, checkpoint_interval=2).fit(cache)
    assert mgr.latest_epoch() == 2
    rec = make(cls, checkpoint_manager=mgr, checkpoint_interval=2,
               resume=True).fit(cache)
    for a, b in zip(_weights(golden), _weights(rec)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stream_resumes_a_jax_snapshot(tmp_path, name):
    cls, jcls, make, ylab = FAMILIES[name]
    batches = cases.adam_batches()
    jmesh = JMesh(devices=jax.devices()[:1])
    jgolden = make(jcls, mesh=jmesh).fit(
        _cache(batches, ylab, jcache_stream))
    jmgr = JCheckpointManager(str(tmp_path / "ckpt"), world_size=1)
    make(jcls, mesh=jmesh, checkpoint_manager=jmgr,
         checkpoint_interval=2).set_max_iter(2).fit(
        _cache(batches, ylab, jcache_stream))
    jmgr.wait()
    rec = make(cls, checkpoint_manager=CheckpointManager(str(tmp_path / "ckpt")),
               checkpoint_interval=2, resume=True).fit(_cache(batches, ylab))
    for a, b in zip(_weights(rec), _weights(jgolden)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stream_resume_requires_durable_cache(tmp_path, name):
    cls, _, make, _ = FAMILIES[name]
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(ValueError, match="durable DataCache"):
        make(cls, checkpoint_manager=mgr, resume=True).fit(
            iter(Table(b) for b in cases.adam_batches()))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_in_ram_rejects_checkpoint_knobs(tmp_path, name):
    cls, _, make, _ = FAMILIES[name]
    b = cases.adam_batches(n_batches=1)[0]
    with pytest.raises(ValueError, match="streamed fits only"):
        make(cls, checkpoint_manager=CheckpointManager(
            str(tmp_path / "x"))).fit(Table(b))


def test_stream_refuses_ragged_and_empty_batches():
    b = cases.adam_batches(n_batches=2)
    ragged = [Table(b[0]), Table({"features": b[1]["features"][:, :4],
                                  "label": b[1]["label"]})]
    with pytest.raises(ValueError, match="feature dim"):
        cases.fm_estimator(FMClassifier).fit(iter(ragged))
    with pytest.raises(ValueError, match="empty"):
        cases.fm_estimator(FMClassifier).fit(iter([]))
