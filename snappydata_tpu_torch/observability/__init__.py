"""Process-wide counters, request tracing and the table stats service
(port of snappydata_tpu/observability)."""

from snappydata_tpu_torch.observability.metrics import (  # noqa: F401
    MetricsRegistry, global_registry,
)
from snappydata_tpu_torch.observability.stats_service import (  # noqa: F401
    TableStatsService,
)
