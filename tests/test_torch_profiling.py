"""The port's profiling utilities (``flinkml_tpu_torch.utils.profiling``
and ``utils.metrics.EpochMetricsListener``) against the JAX package's.

``EpochMetricsListener`` and ``StepTimer`` read only ``time.perf_counter``:
under one scripted clock, patched for both packages, they must record the
same series, counters and gauges with the same values, exactly. ``trace``
writes a ``torch.profiler`` Chrome trace that names ``annotate``'s regions
(the JAX package writes an XProf trace, so the files are not compared).
The card's half (a ``StepTimer`` that waits for the stream, a trace that
names a kernel) is in ``tests/test_torch_compile_cache_cuda.py`` and
``chip_smoke.py``'s path X4.
"""

from __future__ import annotations

import glob
import json
import time

import numpy as np
import pytest
import torch

import flinkml_tpu.utils as jax_utils
from flinkml_tpu.utils.metrics import MetricGroup as JaxGroup
from flinkml_tpu_torch import utils
from flinkml_tpu_torch.iteration import iterate
from flinkml_tpu_torch.utils import profiling
from flinkml_tpu_torch.utils.metrics import MetricGroup
from tests._torch_threads import cap_torch_threads

cap_torch_threads()


class _Clock:
    """A scripted ``perf_counter``: each read advances by the next step."""

    def __init__(self, steps):
        self.t, self.steps, self.i = 100.0, list(steps), 0

    def __call__(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


def _same_snapshot(a: dict, b: dict) -> None:
    assert a["counters"] == b["counters"]
    assert a["gauges"] == b["gauges"]
    assert a["histories"] == b["histories"]
    assert a["meters"] == b["meters"]


@pytest.mark.parametrize("samples", [None, 640])
def test_epoch_metrics_listener_equals_jax(monkeypatch, samples):
    steps = [0.25, 0.125, 1.5, 0.0625, 2.0]
    records = []
    for listener_cls, group_cls in (
            (utils.EpochMetricsListener, MetricGroup),
            (jax_utils.EpochMetricsListener, JaxGroup)):
        monkeypatch.setattr(time, "perf_counter", _Clock(steps))
        group = group_cls("iteration")
        listener = listener_cls(group, samples_per_epoch=samples)
        for epoch in range(4):
            listener.on_epoch_watermark_incremented(epoch, None)
        listener.on_iteration_terminated(None)
        records.append(group.snapshot())
    _same_snapshot(*records)
    assert records[0]["counters"]["epochs"] == 4
    assert len(records[0]["histories"]["epoch_seconds"]) == 4


def test_epoch_metrics_listener_under_iterate():
    from flinkml_tpu_torch.iteration import (
        IterationConfig,
        IterationListener,
        TerminateOnMaxIter,
    )

    group = MetricGroup("iteration")
    listener = utils.EpochMetricsListener(group, samples_per_epoch=10)
    out = iterate(lambda state, epoch: (state + 1, None), 0,
                  config=IterationConfig(termination=TerminateOnMaxIter(3)),
                  listeners=[listener])
    snap = group.snapshot()
    assert isinstance(listener, IterationListener)
    assert out.state == 3 and out.epochs == 3
    assert snap["counters"]["epochs"] == 3
    assert len(snap["histories"]["epoch_seconds"]) == 3
    assert snap["gauges"]["total_seconds"] >= 0.0


@pytest.mark.parametrize("observe", [True, False])
def test_step_timer_equals_jax(monkeypatch, observe):
    import jax.numpy as jnp

    steps = [0.5, 0.25, 0.75]
    records = []
    for timer_mod, group_cls, value in (
            (profiling, MetricGroup, torch.ones(3)),
            (jax_utils, JaxGroup, jnp.ones(3))):
        monkeypatch.setattr(time, "perf_counter", _Clock(steps))
        group = group_cls("train")
        timer = timer_mod.StepTimer(group=group, series="step_seconds")
        for _ in range(3):
            with timer:
                if observe:
                    timer.observe((value, {"v": value}))
        records.append((group.snapshot(), list(timer.times), timer.mean))
    (a, ta, ma), (b, tb, mb) = records
    _same_snapshot(a, b)
    assert ta == tb and ma == mb and len(ta) == 3


def test_step_timer_records_a_failed_step_without_waiting():
    timer = profiling.StepTimer()
    with pytest.raises(ValueError):
        with timer:
            timer.observe(torch.ones(2))
            raise ValueError("step failed")
    assert len(timer.times) == 1 and timer.mean == timer.times[0]
    assert profiling.StepTimer().mean == 0.0


def _trace_events(log_dir):
    (path,) = glob.glob(str(log_dir / "*.pt.trace.json"))
    with open(path) as fh:
        return [e.get("name", "") for e in json.load(fh)["traceEvents"]]


def test_trace_names_annotated_regions(tmp_path):
    @profiling.annotate("fml_decorated_step")
    def step(x):
        return torch.mm(x, x)

    x = torch.ones(16, 16)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("fml_block"):
            step(x)
        step(x)
    names = _trace_events(tmp_path)
    assert "fml_block" in names
    assert names.count("fml_decorated_step") == 2
    assert any("mm" in n for n in names)


def test_trace_that_cannot_start_is_a_no_op(tmp_path, monkeypatch):
    def refuse(self):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler.profile, "__enter__", refuse)
    ran = []
    with profiling.trace(str(tmp_path / "t")):
        ran.append(np.ones(2).sum())
    assert ran == [2.0]
    with pytest.raises(RuntimeError, match="profiler busy"):
        with profiling.trace(str(tmp_path / "t"), ignore_errors=False):
            pass


def test_profiling_names_are_exported():
    assert {"EpochMetricsListener", "StepTimer", "annotate",
            "trace"} <= set(utils.__all__)
    assert set(jax_utils.__all__) == set(utils.__all__)
