"""Unified property system.

Mirrors the reference's three-ring config (`Property` enumeration,
core/src/main/scala/io/snappydata/Literals.scala:32-205): boot properties,
cluster conf, and session-level SQL conf, with the same key knobs
(ColumnBatchSize:129, ColumnMaxDeltaRows:138, HashJoinSize:153,
PlanCaching:188, Tokenize:205, PlanCacheSize:126).

Port of snappydata_tpu/config.py: every property keeps its name and
default, so a test can set the same knob on both packages.  Batch size is
expressed in ROWS (a fixed row capacity per batch keeps plate shapes
stable), and the dtype policy keys on the session's torch device.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Any, Dict, Optional


def _env(name: str, default, cast=str):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclasses.dataclass
class Properties:
    """Session/cluster tunables. Names keep the reference's intent."""

    # Storage (ref: Literals.scala:129 ColumnBatchSize ~24MB, :138 ColumnMaxDeltaRows 10000)
    column_batch_rows: int = 1 << 17          # rows per column batch (static XLA shape)
    column_max_delta_rows: int = 10000        # row-buffer rollover threshold
    # at-rest codec for checkpoints/WAL — ON by default like the
    # reference's LZ4 (Constant.DEFAULT_CODEC, jdbc/.../Constant.scala:150);
    # zstd level 1 is the env's LZ4-class codec
    compression_codec: str = "zstd"           # "zstd" | "zlib" | "none"

    # WAL group commit (storage/persistence.py; ref: the oplog store
    # groups disk writes instead of syncing per record). Modes:
    #   always        fsync every append (one fsync per record)
    #   group         appends buffer; the ACK waits for the covering
    #                 group fsync (default — per-statement durability at
    #                 per-group fsync cost)
    #   interval:<ms> acks return before the fsync; the flusher syncs
    #                 every <ms> (relaxed: a crash may lose the last
    #                 <ms> of locally-acked writes)
    wal_fsync_mode: str = "group"
    # commit-buffer bound: a group drains (backpressure) once its framed
    # records exceed this many bytes
    wal_buffer_bytes: int = 8 << 20
    # how long the background flusher lets a group accumulate before it
    # drains un-acked tails (also the default interval for interval mode
    # when no :<ms> suffix is given)
    wal_group_ms: float = 3.0

    # Host memory budget for resident column batches; above it the
    # coldest batches spill to disk as memmaps (transparently reloaded
    # through the OS page cache). 0 = unlimited. Ref:
    # SnappyUnifiedMemoryManager eviction-heap-percentage. Per-table
    # override: CREATE TABLE ... OPTIONS (eviction_bytes 'N').
    host_store_bytes: int = 0
    # Fail-fast ceiling (ref: critical-heap-percentage rejects new work
    # instead of dying, SnappyUnifiedMemoryManager.scala:379-401 /
    # docs/best_practices/memory_management.md:86-103): when process RSS
    # exceeds this, INSERTs raise CriticalMemoryError — reads and
    # deletes still run. 0 = disabled.
    critical_host_bytes: int = 0

    # Planner (ref: Literals.scala:153 HashJoinSize 100MB, :161 HashAggregateSize)
    hash_join_size: int = 100 * 1024 * 1024   # max build-side bytes for broadcast join
    plan_caching: bool = True                 # ref: Literals.scala:188
    plan_cache_size: int = 3000               # ref: Literals.scala:126
    tokenize: bool = True                     # ref: Literals.scala:205 spark.sql.tokenize

    # Execution
    decimal_as_float64: Optional[bool] = None  # None → auto (f64 iff CPU device)
    # Exact DECIMAL(p<=18): scaled-int64 device plates + int aggregation
    # (types.DecimalType docstring; ref ColumnEncoding.scala:137-140
    # readDecimal — real fixed-point semantics). OFF reverts decimals to
    # the float path everywhere.
    decimal_exact: bool = True
    # Cold binds of RLE / boolean-bitset batches ship the ENCODED form
    # over the host→device link and decode in-trace (jnp.repeat-style
    # searchsorted expansion / bit unpack) instead of uploading decoded
    # capacity-row plates (ref: decode-at-scan generated code,
    # ColumnTableScan.scala:684 genCodeColumnBuffer)
    device_decode: bool = True
    # Compressed-domain execution (storage/device.py code-domain binds +
    # engine/exprs.py code-compare lanes): predicates and aggregate
    # inputs evaluate directly over the ENCODED representation —
    # VALUE_DICT columns stay resident as uint8/uint16 code plates plus
    # tiny per-batch dictionaries (predicate literals translate to code
    # thresholds through the sorted dictionary; value uses gather
    # in-trace, fused into the consuming kernel), RLE columns stay as
    # (run values, run ends) with per-run predicate evaluation, bitset
    # columns stay packed. Decoded capacity-row plates are never
    # materialized in HBM for such columns — the capacity lever.
    #   auto  engage per column when its batches encode uniformly;
    #         fall back silently on plain columns, counted
    #         (compressed_fallback_*) when a compressible column can't
    #   on    same engagement, but count EVERY ineligible column
    #   off   always bind decoded plates (the pre-r06 behavior)
    # The knob rides the compiled plan's STATIC key like
    # agg_reduce_strategy: flipping it re-specializes, no cache flush.
    scan_compressed_domain: str = "auto"
    # Aggregate-on-codes (engine/executor._emit_aggregate +
    # ops/code_agg.py): SUM/AVG over a VALUE_DICT column reduces in
    # DICTIONARY SPACE — one bincount over the small integer codes per
    # (group, batch) then an O(D) dot with the per-batch dictionaries —
    # instead of gathering N decoded values (the "GPU Acceleration of
    # SQL Analytics on Compressed Data" formulation). Group keys that
    # are dict/RLE-encoded already group by pure code arithmetic
    # regardless of this knob (counted agg_code_domain); this knob only
    # gates the value-side bincount-dot, whose win is bandwidth-bound
    # (TPU) but scatter-bound on CPU XLA.
    #   auto  engage on TPU backends, stay on the gather path on CPU
    #   on    engage everywhere eligibility holds (bench uses this)
    #   off   always gather decoded values
    # Rides the compiled plan's static key: flipping re-specializes,
    # no cache flush. Counted agg_dict_space per engaged execution.
    agg_on_codes: str = "auto"
    # Background compaction (storage/compact.py): a broker-scheduled
    # single-flight pass that rewrites column batches UNDER live
    # readers — folds update deltas + delete masks into fresh batches
    # and re-encodes columns whose batches drifted to mixed encodings —
    # then republishes via the normal MVCC manifest swap (pinned epochs
    # keep old readers value-correct). Keeps the compressed fast path
    # hot: compressed_fallback_{deltas,mixed_encoding} drain to zero
    # under sustained mutation instead of permanently disqualifying hot
    # columns.
    compaction_enabled: bool = True
    # Seconds between background compaction scans (per engine). The
    # broker's admission path also kicks an early pass when per-table
    # fallback counts cross compaction_min_fallbacks.
    compaction_interval_s: float = 30.0
    # Minimum per-table compressed-fallback count (deltas +
    # mixed_encoding + not_encoded) before a table is considered worth
    # compacting — avoids rewriting cold tables nobody scans.
    compaction_min_fallbacks: int = 1
    # Pallas compensated-f32 kernel for global float SUM/AVG instead of
    # the emulated-f64 segment reduction on TPU (ops/pallas_reduce.py).
    # Default OFF until measured on hardware; bench.py reports the
    # side-by-side timing when a TPU is reachable.
    pallas_reduce: bool = False
    # Fused Pallas grouped-aggregate kernel for the dictionary fast path
    # (the TPC-H Q1 shape): one VMEM pass per slot batch with per-group
    # per-lane Kahan partials, f64 combine outside (ops/pallas_group.py).
    # Same default-OFF-until-measured policy as pallas_reduce.
    pallas_group_reduce: bool = False
    # Grouped-aggregate reduction strategy (ops/reduction.py): every
    # compatible slot of a query packs into one [N, S] matrix per
    # accumulator family and reduces in a single fused dispatch.
    #   auto     backend-keyed: CPU float sums+counts via one-hot matmul
    #            (BLAS gemm, one-hot reused by the group-index cache)
    #            when the one-hot fits, else segment_sum; TPU keeps the
    #            measured unrolled masked reductions for G <= 64, else
    #            scatter; exact int64 sums and min/max never matmul
    #   unroll   G masked reductions over the packed block (old default)
    #   scatter  jax.ops.segment_* along axis 0, one pass
    #   matmul   one-hot [S,N]@[N,G] in the accumulator dtype
    # The knob participates in the compiled plan's static key, so
    # flipping it re-specializes without clearing plan caches.
    agg_reduce_strategy: str = "auto"
    # Group-index cache: aggregates whose plan shape allows it split into
    # a cached prefix (validity mask + combined group index + matmul
    # one-hot) keyed on (plan, table versions, params) and a main phase,
    # so repeated dashboard queries skip gidx recomputation. Byte budget
    # for cached entries; 0 disables the cache.
    gidx_cache_bytes: int = 3 << 30
    max_groups: int = 1 << 16                 # static upper bound for generic group-by output
    batches_pow2_bucketing: bool = True       # pad #batches to pow2 → fewer recompiles

    # Device join engine (engine/executor._emit_join + ops/join.py).
    # device_join is the master switch — OFF reroutes every join to the
    # exact host hash join (the bench times the r05-era host path with
    # it; checked per BIND, so flipping needs no plan-cache flush).
    device_join: bool = True
    # Byte cap on ONE join's expanded output (non-unique builds expand
    # probe rows into match pairs on a {2^k, 1.5*2^k}-bucketed axis);
    # beyond it the query falls back to the host join with a loud
    # stderr warning + join_fallback_expand_bytes counter. 0 = no cap.
    join_expand_max_bytes: int = 2 << 30
    # Build-artifact cache (sorted keys + order permutation + uniqueness
    # verdict per build-side snapshot): LRU byte budget, ledgered by the
    # resource broker next to the gidx cache. 0 disables caching (every
    # bind re-sorts; the device join itself stays on).
    join_build_cache_bytes: int = 1 << 30

    # Memory (ref: SnappyUnifiedMemoryManager eviction-heap-percentage —
    # here the budget caps cached DEVICE arrays; eviction drops them back
    # to host, from which they rebuild on next access)
    device_cache_bytes: int = 0               # 0 = unlimited

    # Out-of-core tier ladder (storage/tier.py): steady-state caps the
    # tiled lane enforces after a pass — device plates demote to the
    # host pool past tier_device_bytes, resident encoded batches demote
    # to CRC-framed disk-tier files past tier_host_bytes (both 0 = off;
    # the broker's degradation ladder walks the same rungs on pressure
    # regardless). tier_prefetch_depth is the tile look-ahead of the
    # background host->HBM prefetcher: how many windows ahead of the
    # consumer the upload thread warms (0 disables the prefetcher).
    tier_device_bytes: int = 0
    tier_host_bytes: int = 0
    tier_prefetch_depth: int = 1
    # Pressure-driven demotion (ROADMAP 4(c)): when admission measures
    # residency above tier_pressure_watermark * memory_limit_bytes, a
    # background pass walks the tier.demote ladder down toward the low
    # watermark — relief starts BEFORE an allocation fails
    # mid-statement, not only at statement boundaries.  0 disables the
    # watcher (the synchronous high-watermark degrade still runs).
    tier_pressure_watermark: float = 0.75
    # Prefetch-worker supervision: how many times a crashed worker
    # restarts (capped backoff) before the pass degrades to inline
    # binds.  0 restores the old die-once behavior.
    tier_prefetch_max_restarts: int = 3

    # Resource governor (resource/broker.py; ref: critical-heap-percentage
    # admission + LowMemoryException fail-fast). memory_limit_bytes is the
    # unified host+device budget admission meters query estimates against;
    # 0 disables admission accounting (queries still register for CANCEL/
    # timeout). Crossing high_watermark × limit of MEASURED usage triggers
    # graceful degradation (plan-cache evict → batch spill → cancel the
    # hungriest query) down to low_watermark × limit.
    memory_limit_bytes: int = 0
    memory_high_watermark: float = 0.85
    memory_low_watermark: float = 0.70
    # Bounded admission FIFO: queries that don't fit wait here up to
    # admission_wait_s before being rejected with LowMemoryException.
    admission_queue_depth: int = 16
    admission_wait_s: float = 30.0
    # Per-principal fair slots: one user may hold at most this many
    # concurrently admitted queries (0 = unlimited).
    admission_slots_per_user: int = 0
    # Statement timeout (spark.sql.broadcastTimeout analogue for whole
    # queries): a query running past this is cancelled cooperatively at
    # the next batch/tile boundary with SQLSTATE XCL52. 0 = none.
    query_timeout_s: float = 0.0

    # Tiled scans ("table ≫ HBM"): when one column table's decoded bind
    # exceeds this budget, aggregate queries stream the batch axis through
    # the same compiled program tile by tile and merge partials (ref:
    # batch-at-a-time ColumnFormatIterator disk read-ahead — the
    # reference never materializes a table to scan it). 0 = auto: half
    # the accelerator's reported memory when known, else unlimited.
    scan_tile_bytes: int = 0

    # Cluster
    num_buckets: int = 128                    # default buckets per partitioned table (ref DDL BUCKETS)
    redundancy: int = 0
    # Gather-to-lead fallback budget: a distributed query with no scatter
    # or partial-merge strategy pulls the referenced shards to the lead
    # and runs single-node, but only up to this many bytes (ref: the
    # lead plans over real executors, SparkSQLExecuteImpl.scala:75 — here
    # the lead IS an engine, so small-table full-surface queries run on
    # it; big ones must be expressible as scatter/merge or error).
    dist_gather_bytes: int = 512 * 1024 * 1024
    # Ship-first distributed execution: serialize plan fragments to the
    # servers by default (SparkSQLExecuteImpl.scala:75-109); False
    # re-renders single-block SQL first (compat with down-rev servers).
    dist_ship_plans: bool = True
    member_timeout_s: float = 5.0             # ref: ClusterManagerTestBase.scala:72
    stats_interval_s: float = 5.0             # ref: Constant.DEFAULT_CALC_TABLE_SIZE_SERVICE_INTERVAL

    # Failover / retry (cluster/retry.py; exercised by fault/failpoints).
    # A fan-out retries up to failover_retries times after member-death
    # failovers, sleeping an exponential backoff with seeded jitter in
    # between; per-peer circuit breakers stop probing a member that
    # failed breaker_failures consecutive probes until breaker_reset_s
    # elapses (then one half-open probe decides).
    failover_retries: int = 2
    retry_backoff_base_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    retry_jitter: float = 0.5
    breaker_failures: int = 3
    breaker_reset_s: float = 5.0

    # End-to-end request reliability (reliability.py + cluster/).
    # client_timeout_s: default per-request deadline on SnappyClient /
    # DistributedSession calls (0 = none). The deadline rides the Flight
    # call options (client-enforced: a hung-but-connected member cannot
    # hold the caller past it — expiry surfaces as SQLSTATE XCL52) AND
    # the request body (the remote QueryContext stops work cooperatively
    # when the caller has given up), and it SHRINKS as a scatter's
    # fan-out progresses — one slow member spends the remainder, not a
    # fresh budget.
    client_timeout_s: float = 0.0
    # Hedged replica reads (OFF by default): when a scatter shard's
    # primary is slower than hedge_after_ms, the same fragment is issued
    # to the shard's replica holder (over the __replica shadows) and the
    # FIRST answer wins; at most hedge_max_concurrent hedges run at
    # once. Counted: hedged_reads_fired / hedged_reads_won.
    hedge_reads: bool = False
    hedge_after_ms: float = 50.0
    hedge_max_concurrent: int = 4
    # Server-side at-most-once window for client-stamped mutation ids:
    # lost-ack mutation retries return the remembered result instead of
    # double-applying. Ids persist in WAL record headers, so the window
    # survives crash recovery. Entries are bounded FIFO.
    mutation_dedup_entries: int = 8192
    # Seed for the fault-injection registry's probabilistic arming
    # (reliability/failpoints.py) — chaos schedules replay
    # deterministically (env twin: SNAPPY_TPU_FAULT_SEED).
    fault_seed: int = 0
    # Boot-time failpoint arming, the compact grammar of the
    # SNAPPY_TPU_FAULTS env twin:
    # "wal.append=torn_write:7@1;flight.rpc=latency:0.01@p0.25".
    # Read once when the registry module is imported; runtime changes go
    # through failpoints.arm().
    faults: str = ""

    # Prepared-statement serving path (serving/ — compile-once
    # parameterized plans + adaptive micro-batched dispatch; ref: the
    # reference ships prepared statements through its thrift/DRDA layer
    # because per-query parse+plan dominates short queries).
    # serving_batch_max caps how many concurrent executions of one
    # prepared plan fuse into a single vmapped device dispatch (<=1
    # disables batching — every execute goes straight through);
    # serving_batch_wait_us is how long a LONE request waits for
    # batchmates before dispatching solo (requests arriving while a
    # dispatch is in flight pile up and batch with no added wait).
    serving_batch_max: int = 16
    serving_batch_wait_us: float = 200.0
    # Registry LRU cap: prepared plans beyond this evict coldest-first
    # (serving_handle_evictions); an evicted statement transparently
    # re-prepares on next use.
    serving_max_handles: int = 512

    # Observability: end-to-end request tracing (observability/
    # tracing.py). Every request minted at a front door (REST POST /sql,
    # Flight tickets, SnappyClient, DistributedSession, session.sql)
    # gets a trace id that propagates like the request deadline — a
    # contextvar locally, a trace_id body/ticket field across the wire —
    # and a span tree over the real execution phases (parse/analyze/
    # optimize, plan-cache verdict, jit compile, bind incl. batch-skip
    # evidence, device execute, transfer, WAL sync, per-member fan-out
    # legs, retries/hedges). Completed traces land in a bounded ring
    # served by GET /status/api/v1/traces. tracing_enabled=False makes
    # every tracing call a no-op contextvar read (the bench guards the
    # enabled cost at <3% on the stock workload).
    tracing_enabled: bool = True
    # bounded in-process ring of completed traces
    trace_ring_entries: int = 256
    # slow-query log: any trace slower than this lands in a SEPARATE
    # ring (full span tree preserved) + the slow_queries counter.
    # 0 = disabled.
    slow_query_ms: float = 0.0

    # MVCC snapshot isolation (storage/mvcc.py; ref: the reference's
    # snapshot-isolation transactions around store writes,
    # JDBCSourceAsColumnarStore beginTx/commitTx).  Every statement pins
    # ONE consistent cross-table storage epoch at start — long scans and
    # sustained ingest proceed concurrently, neither blocking the other,
    # and a query's reads (binds, host fallbacks, tile passes, matview
    # syncs, subqueries) all traverse that epoch.  snapshot_isolation=
    # False restores live-manifest reads (each bind sees the newest
    # committed state; statements no longer pin).
    snapshot_isolation: bool = True
    # Unpinned manifest history retained per table beyond active pins
    # (observability + pins racing a publish); pinned epochs are always
    # retained until released.  The degradation ladder trims unpinned
    # retained epochs first; retained bytes ride the broker ledger as
    # `retained_epoch_bytes`.
    mvcc_retained_epochs: int = 2

    # Mesh-sharded query execution (engine/mesh_exec.py + parallel/).
    # With a device mesh active (session.default_mesh / MeshContext),
    # tilable aggregate shapes run their compile-once PARTIAL program
    # per-shard under shard_map — every device scans only its batch
    # slice of the (still-encoded) plates and the per-family [G]
    # partials merge in-trace with psum/pmin/pmax (the reference's
    # partial aggregation + CollectAggregateExec merge, done by
    # collectives).  "off" keeps plain GSPMD jit for everything (the
    # pre-r13 behavior); ineligible shapes always fall back to GSPMD,
    # counted mesh_fallback_<reason>.
    mesh_shard_exec: str = "auto"
    # Join distribution strategy under the mesh lane:
    #   auto       broadcast-build while the build side's decoded bytes
    #              stay under mesh_broadcast_build_bytes, else
    #              shuffle-on-key when the shape allows it
    #   broadcast  always replicate the build side (probe stays sharded)
    #   shuffle    always exchange BOTH sides bucket-wise on the join
    #              key (parallel/hashing murmur3 over the encoded int64
    #              key domain) so each device joins only its buckets
    # Selection is per bind, counted mesh_join_broadcast /
    # mesh_join_shuffle (+ mesh_join_shuffle_fallback_<reason> when an
    # ineligible shape declines to broadcast).
    mesh_join_strategy: str = "auto"
    mesh_broadcast_build_bytes: int = 64 << 20
    # Bucket granularity of the mesh shard placement (parallel/
    # placement.py): the batch axis divides into this many logical
    # buckets for rebalance accounting and the bucket→device map.
    mesh_num_buckets: int = 32
    # Bounded cache of shuffle-exchanged bind layouts (per compiled
    # plan): entries re-use the bucketed exchange across executions of
    # an unchanged table version. Entry COUNT cap, small by design.
    mesh_shuffle_cache_entries: int = 4
    # Shard slots of this process (parallel/mesh.py): 0 = one per visible
    # device (one on the CPU); more slots than devices put slot i on
    # device i % k, as the reference's tests force 8 XLA host devices.
    # A setting of the port only (the reference's mesh is jax.devices()).
    mesh_slots: int = dataclasses.field(
        default_factory=lambda: _env("SNAPPY_MESH_SLOTS", 0, int))

    # Streaming (ref: SnappySinkCallback.scala:49-360)
    sink_state_table: str = "snappysys_internal____sink_state_table"
    sink_max_retries: int = 3

    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def set(self, key: str, value: Any) -> None:
        key_norm = key.replace("spark.snappydata.", "").replace(
            "snappydata.", "").replace("-", "_").replace(".", "_")
        if hasattr(self, key_norm) and key_norm != "extra":
            cur = getattr(self, key_norm)
            if isinstance(cur, bool) and isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
            elif isinstance(cur, float) and not isinstance(value, bool):
                value = float(value)
            elif isinstance(cur, int) and not isinstance(value, bool):
                value = int(value)
            setattr(self, key_norm, value)
        else:
            # store under the NORMALIZED key so `SET auth-provider` and
            # `conf.get("auth_provider")` see the same entry
            self.extra[key_norm] = value

    def get(self, key: str, default: Any = None) -> Any:
        key_norm = key.replace("spark.snappydata.", "").replace(
            "snappydata.", "").replace("-", "_").replace(".", "_")
        if hasattr(self, key_norm) and key_norm != "extra":
            return getattr(self, key_norm)
        return self.extra.get(key_norm, default)


_global = Properties(
    column_batch_rows=_env("SNAPPY_TPU_BATCH_ROWS", 1 << 17, int),
    plan_caching=_env("SNAPPY_TPU_PLAN_CACHING", True, bool),
)


def global_properties() -> Properties:
    return _global


# the torch device of the session currently running a statement: set by
# SnappySession around every statement and bulk insert, read by the dtype
# policy below (storage encodes DOUBLE at the device width at rest)
_device: contextvars.ContextVar = contextvars.ContextVar(
    "snappy_torch_device", default=None)


def current_device():
    """The torch device of the statement running in this context (None
    outside any session scope): background threads a statement starts
    re-enter it through `device_scope`."""
    return _device.get()


@contextlib.contextmanager
def device_scope(device):
    """Run the enclosed work for `device` (a torch.device)."""
    tok = _device.set(device)
    try:
        yield
    finally:
        _device.reset(tok)


# float64 plates whatever the device and policy: the tiled scan's scratch
# merge tables hold accumulator-width partials (float64 sums of up to a
# whole table), which float32 plates would round before the final merge
_float64_plates: contextvars.ContextVar = contextvars.ContextVar(
    "snappy_torch_float64_plates", default=False)


@contextlib.contextmanager
def float64_plates():
    """Store and compute DOUBLE at float64 inside the enclosed work."""
    tok = _float64_plates.set(True)
    try:
        yield
    finally:
        _float64_plates.reset(tok)


def use_float64() -> bool:
    """Decimal/compute dtype policy, keyed on the session's torch device:
    float64 on the CPU (the exact oracle the parity tests compare against
    the reference's CPU answers), float32 on CUDA (the accelerator
    contract: f32 plates, wider accumulators).  Integer width is not
    policy — LONG/TIMESTAMP are always int64.  Outside any session scope
    the CPU policy holds; inside `float64_plates` float64 holds."""
    if _float64_plates.get():
        return True
    if _global.decimal_as_float64 is not None:
        return _global.decimal_as_float64
    dev = _device.get()
    return dev is None or dev.type == "cpu"
