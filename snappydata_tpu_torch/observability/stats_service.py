"""Periodic table stats service and the status snapshots.

Port of snappydata_tpu/observability/stats_service.py.  Reference:
SnappyTableStatsProviderService gathers per-table/member row counts and
sizes on a 5s cadence via store function execution
(io/snappydata/SnappyTableStatsProviderService.scala:59-185, interval
Constant.DEFAULT_CALC_TABLE_SIZE_SERVICE_INTERVAL) and feeds the
dashboard/metrics. Here: a daemon thread snapshotting the catalog, and
the durability, scan, encoding, join, MVCC, storage and HA snapshots the
REST status pages read.

`mesh_snapshot` reports the slot mesh: the active context and its
bucket->slot placement, the per-slot lane's counters, the exchanged
layouts' bytes and the resident plate bytes per device, per slot for a
mesh-bound table.
The port keeps one failpoint registry, whose fires count as
`fault_injected`.
"""

from __future__ import annotations

import logging
import threading
from snappydata_tpu_torch.utils import locks
import time
from typing import Dict, Optional

from snappydata_tpu_torch import config
from snappydata_tpu_torch.engine.executor import AGG_STRATEGIES
from snappydata_tpu_torch.observability.metrics import global_registry
# tracing_snapshot lives with the trace ring; re-exported here so every
# status surface reads off one module like the other *_snapshot helpers
from snappydata_tpu_torch.observability.tracing import tracing_snapshot  # noqa: F401,E501
from snappydata_tpu_torch.storage.device_decode import table_fallbacks
from snappydata_tpu_torch.storage.table_store import RowTableData


def durability_snapshot() -> dict:
    """WAL group-commit stats: live policy knobs + the write-path
    counters (wal_fsync_count, wal_group_commit_batches,
    wal_bytes_written, wal_group_flush timings) for REST
    `/status/api/v1/wal` and the dashboard's Durability section.
    records_per_fsync is the amortization the group commit buys — 1.0
    means always-mode behavior, higher means grouped."""
    from snappydata_tpu_torch import config

    snap = global_registry().snapshot()
    c = snap["counters"]
    t = snap["timers"].get("wal_group_flush", {})
    props = config.global_properties()
    fsyncs = c.get("wal_fsync_count", 0)
    records = c.get("wal_records_written", 0)
    return {
        "wal_fsync_mode": props.get("wal_fsync_mode"),
        "wal_buffer_bytes": props.get("wal_buffer_bytes"),
        "wal_group_ms": props.get("wal_group_ms"),
        "wal_fsync_count": fsyncs,
        "wal_group_commit_batches": c.get("wal_group_commit_batches", 0),
        "wal_records_written": records,
        "wal_bytes_written": c.get("wal_bytes_written", 0),
        "wal_records_per_fsync":
            round(records / fsyncs, 2) if fsyncs else None,
        "wal_group_flush_ms": {
            "count": t.get("count", 0),
            "mean_ms": round(t.get("mean_s", 0.0) * 1e3, 3),
            "max_ms": round(t.get("max_s", 0.0) * 1e3, 3),
        },
        "wal_corrupt_records": c.get("wal_corrupt_records", 0),
    }


def scan_snapshot(catalog=None) -> dict:
    """Aggregation-engine / tiled-scan / compressed-domain stats: live
    knobs + the read-path counters for REST `/status/api/v1/scan` and
    the dashboard's Scan sections.  agg_reduce_passes counts fused
    reduction dispatches (O(1) in slot count by construction — the CI
    perf guard asserts it), agg_strategy_* which strategy the
    backend-aware table picked, gidx_cache_* whether repeated queries
    skipped group-index recomputation, scan_tile_* whether tile partials
    merged on device, and the compressed-domain block reports how much
    of the scan path ran over ENCODED batches: code_domain_predicates /
    rle_run_predicates (predicates served on codes/runs),
    batches_code_bound (columns resident encoded — the capacity lever),
    batches_skipped_dict (equality literals that missed a sorted
    dictionary), and every decode-first reroute itemized by reason
    (compressed_fallback_*).  The aggregate-lane block reports how much
    of the AGGREGATE path ran compressed (agg_code_domain /
    agg_dict_space / agg_rle_runs) and the background compaction
    progress that keeps those lanes hot (passes, batches rewritten,
    bytes reclaimed, itemized compaction_skip_* declines).  With
    `catalog`, per-table encoding mix and at-rest vs decoded bytes ride
    along (including each table's own compressed_fallbacks tally — the
    compaction trigger)."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.storage import device_decode

    snap = global_registry().snapshot()
    c = snap["counters"]
    props = config.global_properties()
    hits = c.get("gidx_cache_hits", 0)
    misses = c.get("gidx_cache_misses", 0)
    dd = device_decode.counters()
    out = {
        "agg_reduce_strategy": props.get("agg_reduce_strategy"),
        "gidx_cache_bytes": props.get("gidx_cache_bytes"),
        "scan_tile_bytes": props.get("scan_tile_bytes"),
        "agg_reduce_passes": c.get("agg_reduce_passes", 0),
        "agg_strategies": {
            s: c.get(f"agg_strategy_{s}", 0)
            for s in AGG_STRATEGIES if c.get(f"agg_strategy_{s}", 0)},
        "gidx_cache_hits": hits,
        "gidx_cache_misses": misses,
        "gidx_cache_hit_rate":
            round(hits / (hits + misses), 3) if hits + misses else None,
        "scan_tiles": c.get("scan_tiles", 0),
        "scan_tile_device_merges": c.get("scan_tile_device_merges", 0),
        "scan_tile_host_merges": c.get("scan_tile_host_merges", 0),
        "scan_tile_prefetch_overlap":
            c.get("scan_tile_prefetch_overlap", 0),
        # --- compressed-domain execution -------------------------------
        "scan_compressed_domain": props.get("scan_compressed_domain"),
        "code_domain_predicates": c.get("code_domain_predicates", 0),
        "rle_run_predicates": c.get("rle_run_predicates", 0),
        "batches_skipped_dict": c.get("batches_skipped_dict", 0),
        "batches_code_bound": dd.get("batches_code_bound", 0),
        "batches_device_decoded": dd.get("batches_device_decoded", 0),
        "bytes_encoded": dd.get("bytes_encoded", 0),
        "bytes_decoded_equiv": dd.get("bytes_decoded_equiv", 0),
        "compressed_fallbacks": c.get("compressed_fallbacks", 0),
        "compressed_fallback_reasons": {
            k[len("compressed_fallback_"):]: v for k, v in sorted(c.items())
            if k.startswith("compressed_fallback_")},
        # --- aggregate-on-codes lanes ----------------------------------
        "agg_on_codes": props.get("agg_on_codes"),
        "agg_code_domain": c.get("agg_code_domain", 0),
        "agg_dict_space": c.get("agg_dict_space", 0),
        "agg_rle_runs": c.get("agg_rle_runs", 0),
        # --- background compaction (keeps the fast paths hot) ----------
        "compaction_enabled": props.get("compaction_enabled"),
        "compaction_passes": c.get("compaction_passes", 0),
        "compaction_batches_rewritten":
            c.get("compaction_batches_rewritten", 0),
        "compaction_bytes_reclaimed":
            c.get("compaction_bytes_reclaimed", 0),
        "compaction_skips": {
            k[len("compaction_skip_"):]: v for k, v in sorted(c.items())
            if k.startswith("compaction_skip_")},
    }
    if catalog is not None:
        try:
            out["tables"] = encoding_mix(catalog)
        except Exception:   # a racing DROP must not kill the dashboard
            out["tables"] = {}
    return out


def encoding_mix(catalog) -> Dict[str, dict]:
    """Per-table encoding mix and at-rest vs fully-decoded bytes — the
    capacity story behind compressed-domain execution.  decoded_bytes is
    what the live rows would occupy as dense device-dtype plates;
    at_rest_bytes is what the encoded batches actually hold; the
    device-resident bytes (cached plates, compressed or not) come from
    the device cache ledger."""
    from snappydata_tpu_torch.storage.device import device_cache_bytes_by_table

    out: Dict[str, dict] = {}
    tables = [(info.name, info.data) for info in catalog.list_tables()
              if not isinstance(info.data, RowTableData)]
    resident = device_cache_bytes_by_table(tables)
    for info in catalog.list_tables():
        if isinstance(info.data, RowTableData):
            continue
        try:
            m = info.data.snapshot()
        except Exception:
            continue
        mix: Dict[str, int] = {}
        at_rest = 0
        decoded = 0
        for v in m.views:
            for f, col in zip(info.schema.fields, v.batch.columns):
                mix[col.encoding.name] = mix.get(col.encoding.name, 0) + 1
                at_rest += col.nbytes
                try:
                    width = 4 if f.dtype.name == "string" \
                        else max(1, col.data.dtype.itemsize) \
                        if col.encoding.name == "PLAIN" \
                        else f.dtype.device_dtype().itemsize
                except Exception:
                    width = 8
                decoded += col.num_rows * width
        rows = m.total_rows()
        out[info.name] = {
            "rows": rows,
            "batches": len(m.views),
            "encoding_mix": mix,
            "at_rest_bytes": at_rest,
            "decoded_bytes": decoded,
            "at_rest_ratio": round(at_rest / decoded, 4) if decoded
            else None,
            "device_resident_bytes": resident.get(info.name, 0),
            "resident_bytes_per_row":
                round(resident.get(info.name, 0) / rows, 2) if rows
                else None,
            # per-TABLE decode-first reroutes since the last compaction
            # pass over this table — the triage view: which table keeps
            # leaving the compressed domain, and WHY
            "compressed_fallbacks": table_fallbacks(info.data),
        }
    return out


def join_snapshot() -> dict:
    """Join-engine stats: live knobs + the device/host path counters for
    REST `/status/api/v1/join` and the dashboard's Join section.
    join_device_joins counts binds that stayed on device,
    join_host_fallbacks the reroutes to the pandas host join — itemized
    BY REASON STRING so a perf cliff is diagnosable from the dashboard;
    join_build_sorts vs join_build_cache_hits shows whether repeated
    joins skip the build argsort; join_expand_factor is expanded output
    rows per probe row on the one-to-many path."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.ops.join import join_build_cache_nbytes

    snap = global_registry().snapshot()
    c = snap["counters"]
    props = config.global_properties()
    hits = c.get("join_build_cache_hits", 0)
    misses = c.get("join_build_cache_misses", 0)
    out_rows = c.get("join_expand_out_rows", 0)
    in_rows = c.get("join_expand_probe_rows", 0)
    return {
        "device_join": props.get("device_join"),
        "join_expand_max_bytes": props.get("join_expand_max_bytes"),
        "join_build_cache_bytes": props.get("join_build_cache_bytes"),
        "join_device_joins": c.get("join_device_joins", 0),
        "join_host_fallbacks": c.get("join_host_fallbacks", 0),
        "join_fallback_reasons": {
            k[len("join_fallback_"):]: v for k, v in sorted(c.items())
            if k.startswith("join_fallback_")},
        "join_build_sorts": c.get("join_build_sorts", 0),
        "join_build_cache_hits": hits,
        "join_build_cache_misses": misses,
        "join_build_cache_hit_rate":
            round(hits / (hits + misses), 3) if hits + misses else None,
        "join_build_cache_nbytes": join_build_cache_nbytes(),
        "join_trans_cache_hits": c.get("join_trans_cache_hits", 0),
        "join_expand_out_rows": out_rows,
        "join_expand_probe_rows": in_rows,
        "join_expand_factor":
            round(out_rows / in_rows, 3) if in_rows else None,
    }


def mesh_snapshot(catalog=None, session=None) -> dict:
    """Mesh-execution stats for `/status/api/v1/mesh` and the dashboard's
    Mesh section, under the reference's keys: the active mesh (the
    ambient MeshContext, else the session's cached one) with its
    bucket->slot placement, PER-SLOT resident plate bytes, the per-slot
    lane's and the exchanges' counters, and the join distribution
    strategy counters."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.engine.mesh_exec import \
        mesh_layout_cache_nbytes
    from snappydata_tpu_torch.parallel.mesh import MeshContext

    snap = global_registry().snapshot()
    c = snap["counters"]
    props = config.global_properties()
    ctx = MeshContext.current()
    if ctx is None and session is not None \
            and getattr(session, "_mesh_ctx", None) is not None:
        ctx = session._mesh_ctx
    out = {
        "mesh_shard_exec": props.get("mesh_shard_exec"),
        "mesh_join_strategy": props.get("mesh_join_strategy"),
        "mesh_broadcast_build_bytes":
            props.get("mesh_broadcast_build_bytes"),
        "active": ctx is not None,
        "mesh_shard_execs": c.get("mesh_shard_execs", 0),
        "mesh_psum_merges": c.get("mesh_psum_merges", 0),
        "mesh_join_broadcast": c.get("mesh_join_broadcast", 0),
        "mesh_join_shuffle": c.get("mesh_join_shuffle", 0),
        "mesh_shuffle_fallback_reasons": {
            k[len("mesh_join_shuffle_fallback_"):]: v
            for k, v in sorted(c.items())
            if k.startswith("mesh_join_shuffle_fallback_")},
        "mesh_fallback_reasons": {
            k[len("mesh_fallback_"):]: v for k, v in sorted(c.items())
            if k.startswith("mesh_fallback_")},
        "mesh_exchange_bytes": c.get("mesh_exchange_bytes", 0),
        "mesh_exchange_rows": c.get("mesh_exchange_rows", 0),
        "mesh_exchange_cache_hits": c.get("mesh_exchange_cache_hits", 0),
        "mesh_broadcast_bytes": c.get("mesh_broadcast_bytes", 0),
        "mesh_broadcast_cache_hits":
            c.get("mesh_broadcast_cache_hits", 0),
        "mesh_layout_cache_nbytes": mesh_layout_cache_nbytes(),
        "rebalances": c.get("mesh_rebalances", 0),
        "buckets_moved": c.get("mesh_buckets_moved", 0),
        "cache_entries_moved": c.get("mesh_cache_moves", 0),
        "bytes_moved": c.get("mesh_moved_bytes", 0),
    }
    if ctx is not None:
        out["num_devices"] = ctx.num_devices
        out["token"] = ctx.token
        out["placement"] = {
            "generation": ctx.placement.generation,
            "num_buckets": ctx.placement.num_buckets,
            "bucket_map": {str(k): v for k, v in
                           ctx.placement.bucket_map().items()},
        }
    if catalog is not None:
        from snappydata_tpu_torch.storage.device import \
            device_cache_bytes_by_device

        try:
            per_dev = device_cache_bytes_by_device(
                (i.name, i.data) for i in catalog.list_tables())
        except Exception:
            per_dev = {}
        out["resident_bytes_by_device"] = {
            k: per_dev[k] for k in sorted(per_dev)}
    return out


def mvcc_snapshot(catalog=None) -> dict:
    """Snapshot-isolation stats for `/status/api/v1/mvcc` and the
    dashboard's MVCC section: the epoch clock, active pins, per-table
    version vector (current version/epoch/commit-seq + the retained-
    epoch list with pin counts and bytes), and the pin/conflict/trim
    counters every isolation claim is observable through."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.storage import mvcc

    snap = global_registry().snapshot()
    c = snap["counters"]
    out = {
        "enabled": bool(config.global_properties().get(
            "snapshot_isolation", True)),
        "retained_epochs_max": config.global_properties().get(
            "mvcc_retained_epochs"),
        "current_epoch": mvcc.current_epoch(),
        "active_pins": mvcc.active_pin_count(),
        "pins": c.get("mvcc_pins", 0),
        "pin_releases": c.get("mvcc_pin_releases", 0),
        "repins": c.get("mvcc_repins", 0),
        "ddl_conflicts": c.get("mvcc_ddl_conflicts", 0),
        "epoch_trims": c.get("mvcc_epoch_trims", 0),
        "view_pending_folds": c.get("view_pending_folds", 0),
        "view_pending_replays": c.get("view_pending_replays", 0),
        "retained_epoch_bytes": 0,
        "tables": {},
    }
    if catalog is not None:
        for info in catalog.list_tables():
            data = info.data
            if not hasattr(data, "_manifest"):
                continue
            try:
                m = data.snapshot()
                epochs = mvcc.retained_epochs_of(data)
            except Exception:
                continue
            retained_bytes = sum(e["bytes"] for e in epochs)
            out["retained_epoch_bytes"] += retained_bytes
            out["tables"][info.name] = {
                "version": int(m.version),
                "epoch": int(getattr(m, "epoch", 0)),
                "wal_seq": int(getattr(m, "wal_seq", 0)),
                "retained_epochs": epochs,
                "retained_bytes": retained_bytes,
            }
    return out


def storage_snapshot() -> dict:
    """Tiered-storage health for `/status/api/v1/storage` and the
    dashboard's Storage section: bytes resident at each tier rung, the
    self-healing ledger (quarantined tier files, rebuilds, bounded EIO
    re-reads, pressure demotions), prefetch-worker liveness (restarts
    vs silent degrade), and the failpoint registry's armed/fired state
    — the observable surface of the fault-injection story."""
    from snappydata_tpu_torch.reliability import failpoints
    from snappydata_tpu_torch.storage import prefetch, tier

    snap = global_registry().snapshot()
    c = snap["counters"]
    out = {"tier": tier.tier_snapshot(),
           "prefetch": prefetch.worker_snapshot(),
           "demotions_hbm": c.get("tier_demotions_hbm", 0),
           "demotions_host": c.get("tier_demotions_host", 0),
           "promotions": c.get("tier_promotions", 0),
           "crc_verifies": c.get("tier_crc_verifies", 0),
           "pressure_wakeups": c.get("tier_pressure_wakeups", 0),
           "failpoints": {"armed": failpoints.snapshot(),
                          "fires": c.get("fault_injected", 0)}}
    return out


def ha_snapshot(catalog=None, distributed=None) -> dict:
    """End-to-end request-reliability stats for `/status/api/v1/ha` and
    the dashboard's High-availability section: failovers, hedged reads,
    mutation-retry dedup, member rejoins, deadline expiries and the
    heartbeat health an operator alarms on — every reliability claim as
    an observable number. `distributed` (the lead's cluster view, when
    one exists) adds live membership and bucket-redundancy state."""
    from snappydata_tpu_torch import config

    snap = global_registry().snapshot()
    c = snap["counters"]
    g = snap["gauges"]
    props = config.global_properties()
    out = {
        # knobs (what the policy IS, next to what it did)
        "client_timeout_s": props.get("client_timeout_s"),
        "query_timeout_s": props.get("query_timeout_s"),
        "hedge_reads": props.get("hedge_reads"),
        "hedge_after_ms": props.get("hedge_after_ms"),
        "mutation_dedup_entries_max": props.get("mutation_dedup_entries"),
        # failover plane
        "failover_member_failed": c.get("failover_member_failed", 0),
        "failover_retries": c.get("failover_retries", 0),
        "failover_redundancy_degraded":
            c.get("failover_redundancy_degraded", 0),
        "failover_redundancy_restored":
            c.get("failover_redundancy_restored", 0),
        "breaker_open": c.get("breaker_open", 0),
        # idempotent mutation retry (the lost-ack evidence pair)
        "mutation_retries": c.get("mutation_retries", 0),
        "mutation_dedup_hits": c.get("mutation_dedup_hits", 0),
        # hedged replica reads
        "hedged_reads_fired": c.get("hedged_reads_fired", 0),
        "hedged_reads_won": c.get("hedged_reads_won", 0),
        # member rejoin with resync
        "member_rejoins": c.get("member_rejoins", 0),
        "rejoin_clean_buckets": c.get("rejoin_clean_buckets", 0),
        "rejoin_copied_buckets": c.get("rejoin_copied_buckets", 0),
        "rejoin_partial_errors": c.get("rejoin_partial_errors", 0),
        # deadlines (client-side cutoffs + server-side cooperative stops)
        "deadline_exceeded": c.get("client_deadline_exceeded", 0),
        "governor_timeouts": c.get("governor_timeouts", 0),
        # membership health
        "member_heartbeat_failures": c.get("member_heartbeat_failures", 0),
        "heartbeats_stopped": g.get("heartbeats_stopped", 0.0) or 0.0,
    }
    if catalog is not None:
        dedup = getattr(catalog, "_mutation_dedup", None)
        out["mutation_dedup_entries"] = len(dedup) if dedup else 0
    if distributed is not None:
        try:
            out["members_total"] = len(distributed.alive)
            out["alive_members"] = sum(distributed.alive)
            out["degraded_buckets"] = len(distributed.degraded_buckets())
        except Exception:
            pass
    return out


class TableStatsService:
    def __init__(self, catalog, interval_s: Optional[float] = None,
                 registry=None):
        self.catalog = catalog
        self.interval_s = interval_s or \
            config.global_properties().stats_interval_s
        self.registry = registry or global_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats: Dict[str, dict] = {}
        self._lock = locks.named_lock("observability.stats")

    def collect_once(self) -> Dict[str, dict]:
        stats: Dict[str, dict] = {}
        for info in self.catalog.list_tables():
            if isinstance(info.data, RowTableData):
                rows = info.data.count()
                batches = 0
                in_memory_bytes = 0
                version = info.data.version
            else:
                m = info.data.snapshot()
                rows = m.total_rows()
                batches = len(m.views)
                in_memory_bytes = sum(v.batch.nbytes for v in m.views)
                version = m.version
            stats[info.name] = {
                "provider": info.provider,
                "row_count": rows,
                "batches": batches,
                "in_memory_bytes": in_memory_bytes,
                "buckets": info.buckets,
                "redundancy": info.redundancy,
                # mutation version: exchange caches key on this, NOT on row
                # count (updates that keep the count constant must still
                # invalidate — review finding). data_id distinguishes table
                # INCARNATIONS: a DROP/CREATE resets the version counter on
                # a fresh object, and (data_id, version) must not collide
                # with the old incarnation's token.
                "version": version,
                "data_id": id(info.data),
            }
        with self._lock:
            self._stats = stats
        self.registry.gauge("tables_total",
                            lambda c=len(stats): float(c))
        total_rows = sum(s["row_count"] for s in stats.values())
        self.registry.gauge("rows_total",
                            lambda r=total_rows: float(r))
        return stats

    def current(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._stats)

    def start(self) -> "TableStatsService":
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.collect_once()
                except Exception as e:
                    # keep polling, but a permanently-failing collector
                    # must not look like a healthy idle thread
                    logging.getLogger(__name__).warning(
                        "stats poll failed: %s", e)
                    self.registry.inc("stats_poll_errors")

        self.collect_once()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
