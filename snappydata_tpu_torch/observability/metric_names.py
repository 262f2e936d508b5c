"""Declared metric names of the port: the registry the metrics-hygiene
lint (tools/locklint/metrics_lint.py, `run([...], <this file>)`) checks
every `.inc / .time / .record_time / .gauge` call of snappydata_tpu_torch
against.

Port of snappydata_tpu/observability/metric_names.py for the port's own
namespace: the reference's names the port uses, and the port's own (the
aggregate lanes of its CUDA kernels, `agg_strategy_kahan` /
`agg_strategy_grouped`, the device-cache budget's and the tiled lane's
counters).

Rules enforced by the lint:
- every literal metric name used anywhere in the package must appear
  below (any kind);
- dynamic names (f-strings / concatenation) must start with a prefix
  from DYNAMIC_PREFIXES;
- no two distinct declared-or-used names may collide after Prometheus
  sanitization.

This file must stay PURE LITERALS: the lint parses it without importing
the package.
"""

COUNTERS = {
    "agg_code_domain",
    "agg_dict_space",
    "agg_reduce_passes",
    "agg_rle_runs",
    "agg_strategy_dict_space",
    "agg_strategy_grouped",
    "agg_strategy_kahan",
    "agg_strategy_matmul",
    "agg_strategy_rle_runs",
    "agg_strategy_scatter",
    "agg_strategy_unroll",
    "batch_corrupt_records",
    "batches_skipped_dict",
    "breaker_open",
    "client_deadline_exceeded",
    "code_domain_predicates",
    "column_batches_seen",
    "column_batches_skipped",
    "compaction_batches_rewritten",
    "compaction_bytes_reclaimed",
    "compaction_passes",
    "compaction_sweeps",
    "compressed_fallbacks",
    "device_cache_evictions",
    "device_cache_window_skips",
    "device_upload_bytes",
    "failover_retries",
    "fault_injected",
    "gidx_cache_hits",
    "gidx_cache_misses",
    "governor_admitted",
    "governor_cancelled",
    "governor_degrade_epoch_trims",
    "governor_degrade_kills",
    "governor_degrade_plan_evictions",
    "governor_degrade_spills",
    "governor_degrade_tier_demotions",
    "governor_degrade_view_evictions",
    "governor_queued",
    "governor_rejected",
    "governor_timeouts",
    "host_batches_spilled",
    "host_fallbacks",
    "join_build_cache_hits",
    "join_build_cache_misses",
    "join_build_sorts",
    "join_device_joins",
    "join_expand_out_rows",
    "join_expand_probe_rows",
    "join_host_fallbacks",
    "join_trans_cache_hits",
    "member_heartbeat_failures",
    "member_heartbeats_stopped",
    "mutation_dedup_hits",
    "mutation_retries",
    "mvcc_cut_expand_errors",
    "mvcc_ddl_conflicts",
    "mvcc_epoch_trims",
    "mvcc_pin_releases",
    "mvcc_pins",
    "mvcc_repins",
    "plan_cache_evictions",
    "plan_cache_hits",
    "plan_cache_misses",
    "plan_key_builds",
    "point_lookups",
    "prefetch_errors",
    "prefetch_overlap_ms",
    "prefetch_window_waits",
    "prefetch_windows_warmed",
    "prefetch_worker_deaths",
    "prefetch_worker_restarts",
    "queries",
    "rle_run_predicates",
    "rows_returned",
    "scan_tile_device_merges",
    "scan_tile_host_merges",
    "scan_tile_prefetch_overlap",
    "scan_tiles",
    "serving_batch_fallbacks",
    "serving_batch_requests",
    "serving_batched_dispatches",
    "serving_bulk_transfers",
    "serving_handle_evictions",
    "serving_passthrough",
    "serving_prepared_hits",
    "serving_prepared_misses",
    "serving_reprepares",
    "serving_straight_through",
    "serving_vmap_compiles",
    "slow_queries",
    "stats_poll_errors",
    "stream_apply_errors",
    "stream_scan_chunks",
    "stream_scan_early_stops",
    "stream_scan_rows",
    "stream_source_errors",
    "take_batches_decoded",
    "take_early_stops",
    "tier_crc_verifies",
    "tier_demotions_hbm",
    "tier_demotions_host",
    "tier_pinned_skips",
    "tier_pressure_demotions",
    "tier_pressure_wakeups",
    "tier_promotions",
    "tier_quarantined_files",
    "tier_read_retries",
    "tier_rebuild_failures",
    "tier_rebuilds",
    "view_delta_folds",
    "view_fold_errors",
    "view_full_refreshes",
    "view_pending_folds",
    "view_pending_replays",
    "view_reads",
    "view_replay_folds",
    "view_rows_folded",
    "view_stale_marks",
    "view_state_evictions",
    "view_state_regrows",
    "view_subtract_folds",
    "view_syncs",
    "view_unmanaged_writes",
    "wal_bytes_written",
    "wal_flusher_errors",
    "wal_fsync_count",
    "wal_group_commit_batches",
    "wal_records_written",
}

TIMERS = {
    "plan_compile",
    "query",
    "wal_group_flush",
}

GAUGES = {
    "governor_active_queries",
    "governor_device_bytes",
    "governor_host_bytes",
    "governor_inflight_bytes",
    "governor_queued_queries",
    "heartbeats_stopped",
    "rows_total",
    "tables_total",
    "tier_file_bytes",
}

# literal prefixes that dynamic (f-string / concatenated) metric names
# are allowed to extend: each is a bounded family, not a free-form
# namespace
DYNAMIC_PREFIXES = {
    "agg_strategy_",
    "compaction_skip_",
    "compressed_fallback_",
    "fault_injected_",
    "join_fallback_",
}
