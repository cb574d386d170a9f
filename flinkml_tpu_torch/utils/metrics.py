"""Metrics registry: named groups of counters and gauges.

The port's counterpart of the registry half of
``flinkml_tpu.utils.metrics`` (the reference's Flink metric groups): a
process-wide :class:`MetricsRegistry` of :class:`MetricGroup` s, where
host code such as the input pipeline's
:class:`~flinkml_tpu_torch.data.prefetch.DevicePrefetcher` reports its
counters and gauges. Plain host-side Python; a device time recorded here
must be taken after ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict


class MetricGroup:
    """A named scope of counters and gauges (thread-safe)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = collections.defaultdict(float)
        self._gauges: Dict[str, Any] = {}

    def counter(self, name: str, inc: float = 1.0) -> float:
        with self._lock:
            self._counters[name] += inc
            return self._counters[name]

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}


class MetricsRegistry:
    """Process-wide registry of metric groups, keyed by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, MetricGroup] = {}

    def group(self, name: str) -> MetricGroup:
        with self._lock:
            if name not in self._groups:
                self._groups[name] = MetricGroup(name)
            return self._groups[name]

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            groups = list(self._groups.values())
        return {g.name: g.snapshot() for g in groups}

    def reset(self) -> None:
        with self._lock:
            self._groups.clear()


#: The process-wide registry.
metrics = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide :data:`metrics` registry."""
    return metrics
