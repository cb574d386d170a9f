"""Metrics registry: counters, gauges, meters, histories.

The port's counterpart of ``flinkml_tpu.utils.metrics`` (the reference's
Flink metric groups, ``AbstractWrapperOperator.java:103``): a process-wide
:class:`MetricsRegistry` of named, optionally labelled
:class:`MetricGroup` s where host code reports counters, gauges, meters
and histories: the input pipeline's
:class:`~flinkml_tpu_torch.data.prefetch.DevicePrefetcher` (group
``data.prefetch``), the self-healing recovery session (group
``recovery``: ``rollbacks_total``, ``quarantined_batches``,
``time_to_recover_p50_ms``/``p99_ms``, ``retries_total{class=...}``),
the serving engines (group ``serving.<name>``, whose :class:`LatencyWindow`
publishes ``p50_ms``/``p99_ms``).
:meth:`MetricsRegistry.render_text` gives the JAX package's text
exposition (``flinkml_rollbacks_total{group="recovery"} 1``). Plain
host-side Python; a device time recorded here must be taken after
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from typing import Any, Dict, List, Optional

from flinkml_tpu_torch.iteration.runtime import IterationListener


class Meter:
    """Windowed rate meter (events/sec), like Flink's MeterView."""

    def __init__(self, window: int = 64):
        self._events: collections.deque = collections.deque(maxlen=window)

    def mark(self, n: float = 1.0, now: Optional[float] = None) -> None:
        self._events.append((time.perf_counter() if now is None else now, n))

    @property
    def rate(self) -> float:
        """Events/sec over the retained window (0.0 with <2 samples)."""
        if len(self._events) < 2:
            return 0.0
        t0, _ = self._events[0]
        t1, _ = self._events[-1]
        if t1 <= t0:
            return 0.0
        total = sum(n for _, n in list(self._events)[1:])
        return total / (t1 - t0)


class MetricGroup:
    """Named scope of counters/gauges/meters/histories (thread-safe).

    ``labels`` are extra Prometheus label pairs attached to every sample
    the group emits in :meth:`MetricsRegistry.render_text` — e.g. the
    serving pool registers one group per replica under the SAME group
    name with ``labels={"replica": "r3"}``, so per-replica gauges
    aggregate as one labeled family instead of colliding in a flat
    namespace (``flinkml_p50_ms{group="serving.pool",replica="r3"}``).
    """

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels: Dict[str, str] = dict(labels or {})
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._gauges: Dict[str, Any] = {}
        self._meters: Dict[str, Meter] = {}
        self._histories: Dict[str, List[float]] = collections.defaultdict(list)

    def counter(self, name: str, inc: float = 1.0) -> float:
        with self._lock:
            self._counters[name] += inc
            return self._counters[name]

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def meter(self, name: str) -> Meter:
        with self._lock:
            if name not in self._meters:
                self._meters[name] = Meter()
            return self._meters[name]

    def record(self, name: str, value: float) -> None:
        """Append to a history series (epoch times, losses, ...)."""
        with self._lock:
            self._histories[name].append(float(value))

    def history(self, name: str) -> List[float]:
        with self._lock:
            return list(self._histories[name])

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "meters": {k: m.rate for k, m in self._meters.items()},
                "histories": {k: list(v) for k, v in self._histories.items()},
            }


class LatencyWindow:
    """Sliding per-request latency ring publishing ``p50_ms``/``p99_ms``
    gauges into a group: the one implementation of the percentile gauges
    shared by the serving engine's per-engine window and the multi-model
    pool's per-SLO-class windows. Thread-safe; ``record`` takes any number
    of samples, so a batch's completions pay one lock acquisition and one
    sort."""

    def __init__(self, group: MetricGroup, window: int = 2048):
        import numpy as np

        self._group = group
        self._lock = threading.Lock()
        self._ring = np.empty(int(window), dtype=np.float64)
        self._size = 0
        self._next = 0

    def record(self, *latencies_ms: float) -> None:
        import numpy as np

        with self._lock:
            for v in latencies_ms:
                self._ring[self._next] = v
                self._next = (self._next + 1) % len(self._ring)
                self._size = min(self._size + 1, len(self._ring))
            if not self._size:
                return
            arr = self._ring[:self._size].copy()
        # np.percentile(arr, [50, 99])'s values (linear interpolation),
        # from one partial sort instead of a full one.
        q = (0.5, 0.99)
        at = [(self._size - 1) * p for p in q]
        lo = [int(np.floor(v)) for v in at]
        hi = [min(i + 1, self._size - 1) for i in lo]
        arr.partition(sorted(set(lo + hi)))
        p50, p99 = (_lerp(arr[a], arr[b], v - a)
                    for a, b, v in zip(lo, hi, at))
        self._group.gauge("p50_ms", float(p50))
        self._group.gauge("p99_ms", float(p99))


def _lerp(a: float, b: float, t: float) -> float:
    """numpy's percentile interpolation, operation for operation."""
    diff = b - a
    return b - diff * (1 - t) if t >= 0.5 else a + diff * t


class MetricsRegistry:
    """Process-wide registry of metric groups.

    The analog of Flink's per-TM metric registry; ``group("model.kmeans")``
    plays the role of the re-registered operator metric group.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # key: (name, sorted label items) — label-less groups keep the
        # plain name as their snapshot key, so existing consumers see
        # exactly the old namespace.
        self._groups: Dict[Any, MetricGroup] = {}

    def group(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> MetricGroup:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            if key not in self._groups:
                self._groups[key] = MetricGroup(name, labels)
            return self._groups[key]

    @staticmethod
    def _qualified(g: MetricGroup) -> str:
        if not g.labels:
            return g.name
        inner = ",".join(
            f'{k}="{_escape_label(str(v))}"'
            for k, v in sorted(g.labels.items())
        )
        return f"{g.name}{{{inner}}}"

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            groups = list(self._groups.values())
        return {self._qualified(g): g.snapshot() for g in groups}

    def render_text(self) -> str:
        """Prometheus-style text exposition of every group's counters,
        numeric gauges, and meter rates — one sample line per metric with
        the group as a label, e.g.::

            # TYPE flinkml_requests counter
            flinkml_requests{group="serving.default"} 128

        Counters render as ``counter``, gauges and meter rates as
        ``gauge`` (rates under ``<name>_rate``). Non-numeric gauges and
        histories are skipped (histories are unbounded series — scrape
        :meth:`snapshot` for those). Output is sorted, so diffs are
        stable, and byte for byte the JAX package's for the same
        operations; wire it to an HTTP endpoint for a real scrape target.

        A group's extra ``labels`` (see :class:`MetricGroup`) render as
        additional label pairs after ``group=``, e.g.::

            flinkml_queue_depth{group="serving.pool",replica="r3"} 2
        """
        with self._lock:
            groups = list(self._groups.values())
        # metric name -> (prom type, [(rendered label set, value)])
        samples: Dict[str, Any] = {}

        def add(name: str, kind: str, group: str, value: float) -> None:
            # A Prometheus metric family has ONE type: the same name used
            # as a counter in one group and a gauge in another would emit
            # a mistyped series — the later kind moves to a kind-suffixed
            # family instead (deterministic: groups are visited sorted).
            entry = samples.get(name)
            if entry is not None and entry[0] != kind:
                name = f"{name}_{kind}"
                entry = samples.get(name)
            if entry is None:
                entry = samples.setdefault(name, (kind, []))
            entry[1].append((group, value))

        for g in sorted(groups, key=self._qualified):
            pairs = [("group", g.name)] + sorted(g.labels.items())
            labelset = ",".join(
                f'{k}="{_escape_label(str(v))}"' for k, v in pairs
            )
            snap = g.snapshot()
            for k, v in snap["counters"].items():
                add(f"flinkml_{_sanitize(k)}", "counter", labelset, v)
            for k, v in snap["gauges"].items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                add(f"flinkml_{_sanitize(k)}", "gauge", labelset, v)
            for k, rate in snap["meters"].items():
                add(f"flinkml_{_sanitize(k)}_rate", "gauge", labelset, rate)
        lines: List[str] = []
        for name in sorted(samples):
            kind, values = samples[name]
            lines.append(f"# TYPE {name} {kind}")
            for labelset, value in sorted(values):
                # Full precision: '%g' would truncate counters past 6
                # significant digits (1_234_567 -> 1.23457e+06).
                rendered = (
                    str(int(value)) if float(value).is_integer()
                    else repr(float(value))
                )
                lines.append(f"{name}{{{labelset}}} {rendered}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._groups.clear()


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    """Prometheus label-VALUE escaping: backslash, double quote, newline."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


#: Default process-wide registry (import-and-use, like Flink's).
metrics = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide :data:`metrics` registry — the scrape root for
    exposition (``default_registry().render_text()``)."""
    return metrics


class EpochMetricsListener(IterationListener):
    """Records per-epoch wall time, criteria, and throughput into a group.

    Attach to :func:`flinkml_tpu_torch.iteration.iterate` via
    ``listeners=[...]``. ``samples_per_epoch`` (if given) feeds a
    ``samples`` meter and a final ``samples_per_sec`` gauge — the bench's
    headline metric. The JAX package's listener, series for series.
    """

    def __init__(
        self,
        group: Optional[MetricGroup] = None,
        samples_per_epoch: Optional[int] = None,
    ):
        self.group = group if group is not None else metrics.group("iteration")
        self.samples_per_epoch = samples_per_epoch
        self._last = time.perf_counter()
        self._t0 = self._last
        self._epochs = 0

    def on_epoch_watermark_incremented(self, epoch: int, state: Any) -> None:
        now = time.perf_counter()
        self.group.record("epoch_seconds", now - self._last)
        self.group.counter("epochs")
        if self.samples_per_epoch:
            self.group.meter("samples").mark(self.samples_per_epoch, now=now)
        self._last = now
        self._epochs += 1

    def on_iteration_terminated(self, state: Any) -> None:
        total = time.perf_counter() - self._t0
        self.group.gauge("total_seconds", total)
        if self.samples_per_epoch and total > 0:
            self.group.gauge(
                "samples_per_sec", self.samples_per_epoch * self._epochs / total
            )
