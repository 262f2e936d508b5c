"""Process-wide counters, request tracing and the table stats service
(port of snappydata_tpu/observability).  `TableStatsService` is imported
on first use: it reads the executor's strategy table, and the modules
that only count or trace (the client's among them) load no torch."""

from snappydata_tpu_torch.observability.metrics import (  # noqa: F401
    MetricsRegistry, global_registry,
)


def __getattr__(name):
    if name == "TableStatsService":
        from snappydata_tpu_torch.observability.stats_service import \
            TableStatsService

        globals()[name] = TableStatsService
        return TableStatsService
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
