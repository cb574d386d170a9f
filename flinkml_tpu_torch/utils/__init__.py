"""Host-side utilities of the port: the metrics registry and the epoch
metrics listener, ``torch.profiler`` tracing and device-accurate step
timers (``utils.profiling``), rank-tagged logging, the preemption
watchdog and the row reservoir of the streamed fits (``utils.sampling``)."""

from flinkml_tpu_torch.utils.logging import enable_console, get_logger, rank_tag
from flinkml_tpu_torch.utils.metrics import (
    EpochMetricsListener,
    Meter,
    MetricGroup,
    MetricsRegistry,
    default_registry,
    metrics,
)
from flinkml_tpu_torch.utils.preemption import (
    ElasticResumePlan,
    PreemptionWatchdog,
)
from flinkml_tpu_torch.utils.profiling import StepTimer, annotate, trace

__all__ = [
    "EpochMetricsListener",
    "Meter",
    "MetricGroup",
    "MetricsRegistry",
    "default_registry",
    "metrics",
    "StepTimer",
    "annotate",
    "trace",
    "enable_console",
    "get_logger",
    "rank_tag",
    "PreemptionWatchdog",
    "ElasticResumePlan",
]
