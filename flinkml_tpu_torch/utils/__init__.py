"""Host-side utilities of the port: the metrics registry, rank-tagged
logging, the preemption watchdog and the row reservoir of the streamed
fits (``utils.sampling``). The JAX package's ``utils.profiling`` has no
counterpart here."""

from flinkml_tpu_torch.utils.logging import enable_console, get_logger, rank_tag
from flinkml_tpu_torch.utils.metrics import (
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

__all__ = [
    "Meter",
    "MetricGroup",
    "MetricsRegistry",
    "default_registry",
    "metrics",
    "enable_console",
    "get_logger",
    "rank_tag",
    "PreemptionWatchdog",
    "ElasticResumePlan",
]
