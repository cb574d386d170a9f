"""Tracing and profiling: ``torch.profiler`` traces and device-accurate
step timers.

The port's counterpart of ``flinkml_tpu.utils.profiling``. Where the JAX
package writes ``jax.profiler`` traces for XProf/TensorBoard, the port
writes ``torch.profiler`` Chrome traces (host ops and, on a card, every
CUDA kernel by name) that TensorBoard's profiler plugin and
``chrome://tracing`` read. These helpers degrade gracefully: if the
profiler cannot start, ``trace`` becomes a no-op rather than failing the
job.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Iterator, List, Optional

from flinkml_tpu_torch.utils.metrics import MetricGroup


@contextlib.contextmanager
def trace(log_dir: str, ignore_errors: bool = True) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block (CPU and,
    where a card is present, CUDA activity) into ``log_dir`` as
    ``<host>_<pid>.<ms>.pt.trace.json``.

    Usage::

        with trace("/tmp/torch-trace"):
            model = estimator.fit(train_table)
    """
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    try:
        prof.__enter__()
        started = True
    except Exception:  # noqa: BLE001 — a profiler that cannot start
        if not ignore_errors:
            raise
        started = False
    try:
        yield
    finally:
        if started:
            try:
                prof.__exit__(None, None, None)
            except Exception:  # noqa: BLE001 — nor write its trace
                if not ignore_errors:
                    raise


class annotate:
    """Named region visible in profiler timelines (host, and the kernels
    launched inside it on the card), usable as a context manager or a
    decorator: ``torch.profiler.record_function`` with a fresh record for
    every entry, so a decorated function may run on several threads."""

    def __init__(self, name: str):
        self.name = name
        self._records: List[Any] = []

    def __enter__(self) -> "annotate":
        from torch.profiler import record_function

        record = record_function(self.name)
        record.__enter__()
        self._records.append(record)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._records.pop().__exit__(exc_type, exc, tb)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(self.name):
                return fn(*args, **kwargs)

        return wrapped


def _streams_of(value) -> list:
    """The current CUDA stream of each CUDA tensor's device in ``value``
    (a tensor or a tuple/list/dict tree of them)."""
    import torch

    streams, seen = [], set()

    def walk(v):
        if torch.is_tensor(v):
            if v.is_cuda and v.device not in seen:
                seen.add(v.device)
                streams.append(torch.cuda.current_stream(v.device))
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(value)
    return streams


class StepTimer:
    """Device-accurate step timing under asynchronous launches.

    A CUDA launch returns before the card finishes; a host clock read
    right after it measures the enqueue, not the work. ``StepTimer``
    waits for the stream that produced the step's outputs (the current
    stream of each observed CUDA tensor's device, as it was when
    :meth:`observe` was called) before it reads the clock, and optionally
    records into a metric group::

        timer = StepTimer(group=metrics.group("train"))
        for batch in data:
            with timer:
                state = step(state, batch)
                timer.observe(state)   # wait target
    """

    def __init__(self, group: Optional[MetricGroup] = None,
                 series: str = "step_seconds"):
        self.group = group
        self.series = series
        self.times = []
        self._pending = None
        self._streams: list = []
        self._t0 = 0.0

    def observe(self, value) -> None:
        """Register the step output to wait for at exit."""
        self._pending = value
        self._streams = _streams_of(value)

    def __enter__(self) -> "StepTimer":
        self._pending = None
        self._streams = []
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None and self._pending is not None:
            for stream in self._streams:
                stream.synchronize()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if self.group is not None:
            self.group.record(self.series, dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
