"""Process-wide resource broker: unified ledger and admission control.

Port of snappydata_tpu/resource/broker.py.  SnappyUnifiedMemoryManager
meters every storage and execution allocation against eviction and
critical heap percentages and fails new work with LowMemoryException
instead of dying (SnappyUnifiedMemoryManager.scala:379-401, docs/
best_practices/memory_management.md:86-103; SnappyStorageEvictor).  Here:

- **accounting**: one ledger over host bytes (resident encoded batches,
  row-buffer arrays, live row-table rows, retained MVCC epochs) and
  device bytes (the plate cache, the join build cache) per table, with
  high and low watermarks;
- **admission control**: `admit()` admits, queues (bounded FIFO with
  per-principal fair slots) or rejects with `LowMemoryException`
  (SQLSTATE XCL54).  Crossing the high watermark walks the degradation
  ladder, cheapest first: plan caches, unpinned retained epochs, the
  tier ladder (HBM plates -> host, host batches -> CRC-framed disk
  files), host spill, then cancel the hungriest admitted query;
- **cancellation**: `cancel(query_id)` flags the query's context; the
  cooperative checks threaded through the engine stop it at the next
  plan, batch or tile boundary.

Device bytes are TENSOR bytes: each cache entry's tensors counted once
per storage (`storage/device._entry_bytes`), as the reference counts live
arrays.  They are not `torch.cuda.memory_allocated()`: a dropped entry
leaves the allocator's count only once nothing else (a compiled plan, a
prefetch window, a pending `record_stream`) holds its tensors, and the
caching allocator's reserved bytes do not fall without `empty_cache()`.

The ledger keeps the reference's keys.  `gidx_cache_bytes` is the
group-index cache (engine/executor.py) and `serving_registry_bytes` the
prepared-plan registries (serving/prepared.py); the ladder's first rung
drops both with the plan caches.  `matview_state_bytes` is the
materialized views' [G] state (views/matview.py), and the second rung
evicts it (the views go stale and re-aggregate at their next read).  The
mesh layout line reads 0 until multi-device execution is ported.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.resource.context import (CancelException,
                                                   LowMemoryException,
                                                   QueryContext)
from snappydata_tpu_torch.utils import locks


def _host_table_bytes(data) -> int:
    """Resident host bytes of one table: encoded batch arrays actually in
    RAM (memmapped spill and tier pages count 0: the OS page cache owns
    them) plus the row buffer; row tables charge their live rows at
    decoded width (an estimate: they hold Python lists)."""
    total = 0
    manifest = getattr(data, "_manifest", None)
    if manifest is not None and hasattr(manifest, "views"):
        from snappydata_tpu_torch.storage.hoststore import \
            batch_resident_bytes

        for v in manifest.views:
            try:
                total += batch_resident_bytes(v.batch)
            except Exception:
                pass
        for a in manifest.row_arrays or ():
            if a is not None and getattr(a, "dtype", None) is not None \
                    and a.dtype != object:
                total += int(a.nbytes)
        return total
    live = getattr(data, "_live", None)
    if live is not None and getattr(data, "schema", None) is not None:
        from snappydata_tpu_torch.resource.estimate import \
            _decoded_row_width

        try:
            # count(True): an updated row's tombstoned slot is not charged
            return live.count(True) * _decoded_row_width(data.schema)
        except Exception:
            return 0
    return total


def _cache_bytes() -> Tuple[int, int, int]:
    """(gidx cache, serving registry, mesh layouts): the group-index
    cache's device bytes and the prepared-plan registries' host bytes,
    beside the line of a module not ported yet."""
    from snappydata_tpu_torch.engine.executor import gidx_cache_nbytes
    from snappydata_tpu_torch.serving import serving_registry_nbytes

    return (gidx_cache_nbytes(), serving_registry_nbytes(),
            _unported_cache_bytes())


def _unported_cache_bytes() -> int:
    """The mesh layout cache's line: multi-device execution is not
    ported, so it holds nothing."""
    return 0


def _matview_bytes() -> int:
    from snappydata_tpu_torch.views.matview import matview_state_nbytes

    return matview_state_nbytes()


_pressure_warned = [False]


def _pressure_log_once() -> None:
    if not _pressure_warned[0]:
        _pressure_warned[0] = True
        import logging

        logging.getLogger("snappydata_tpu_torch.broker").warning(
            "background pressure-demotion pass failed; synchronous "
            "high-watermark degradation remains in force",
            exc_info=True)


class ResourceBroker:
    """One broker per process (see `global_broker()`), like the
    reference's per-JVM memory manager."""

    def __init__(self, props=None):
        self.props = props or config.global_properties()
        self._cond = locks.named_condition("resource.broker_cond")
        self._active: Dict[str, QueryContext] = {}
        self._queue: List[QueryContext] = []
        self._inflight_bytes = 0
        # the table registry has its OWN lock: gauges walk it, and
        # admission bumps counters while _cond is held
        self._tables_lock = locks.named_lock("resource.broker_tables")
        # keyed (owner, name): one process holds many catalogs (per-test
        # sessions, scratch merges)
        self._tables: Dict[Tuple[int, str], "weakref.ref"] = {}
        self._executors: "weakref.WeakSet" = weakref.WeakSet()
        # submitted-but-not-yet-admitted contexts: visible and
        # cancellable from the moment of submission
        self._watched: Dict[str, QueryContext] = {}
        self._measured_cache: Tuple[float, int, int] = (0.0, 0, 0)
        # pressure-demotion watcher: one background thread at a time; the
        # leaf lock guards only the running flag
        self._pressure_lock = locks.named_lock("resource.pressure")
        self._pressure_running = False
        reg = global_registry()
        reg.gauge("governor_inflight_bytes",
                  lambda: float(self._inflight_bytes))
        reg.gauge("governor_active_queries", lambda: float(len(self._active)))
        reg.gauge("governor_queued_queries", lambda: float(len(self._queue)))
        reg.gauge("governor_host_bytes",
                  lambda: float(self.measured_bytes(max_age_s=1.0)[0]))
        reg.gauge("governor_device_bytes",
                  lambda: float(self.measured_bytes(max_age_s=1.0)[1]))

    # -- knobs (read live, so SET takes effect without a restart) -------

    def _limit(self) -> int:
        return int(self.props.memory_limit_bytes or 0)

    def accounting_enabled(self) -> bool:
        return self._limit() > 0

    def _high_bytes(self, limit: int) -> float:
        return limit * float(self.props.memory_high_watermark)

    def _low_bytes(self, limit: int) -> float:
        return limit * float(self.props.memory_low_watermark)

    def _pressure_bytes(self, limit: int) -> float:
        wm = float(getattr(self.props, "tier_pressure_watermark", 0.0)
                   or 0.0)
        # 0 disables the watcher
        return limit * wm if wm > 0 else float("inf")

    # -- pressure-driven background demotion ----------------------------

    def _kick_pressure_demote(self, limit: int) -> None:
        """Start ONE background ladder pass toward the low watermark if
        none is running: admission pays a flag check, never the demotion.
        The thread re-enters the admitting statement's device scope."""
        with self._pressure_lock:
            if self._pressure_running:
                return
            self._pressure_running = True
        global_registry().inc("tier_pressure_wakeups")
        # relief target UNDER the pressure watermark (the low watermark
        # may sit above residency when the pressure knob is aggressive)
        target = min(self._low_bytes(limit), self._pressure_bytes(limit))
        threading.Thread(target=self._pressure_demote_body,
                         args=(int(target), config.current_device()),
                         name="snappy-pressure-demote",
                         daemon=True).start()

    def _pressure_demote_body(self, target_bytes: int, device) -> None:
        from snappydata_tpu_torch.storage import tier

        try:
            with config.device_scope(device):
                tier.pressure_demote(self, target_bytes)
        # the watcher is advisory relief: a failed background pass leaves
        # the synchronous high-watermark degrade fully in force
        except Exception:
            _pressure_log_once()
        finally:
            with self._pressure_lock:
                self._pressure_running = False

    # -- ledger ---------------------------------------------------------

    def register_table(self, name: str, data, owner: int = 0) -> None:
        with self._tables_lock:
            self._tables[(owner, name.lower())] = weakref.ref(data)

    def unregister_table(self, name: str, owner: int = 0) -> None:
        """DROP TABLE drops the ledger line too: a plan cache can keep the
        data object alive, and a dropped table must not count toward
        memory pressure."""
        with self._tables_lock:
            self._tables.pop((owner, name.lower()), None)

    def register_executor(self, executor) -> None:
        self._executors.add(executor)

    def _iter_tables(self) -> List[Tuple[str, object]]:
        out = []
        with self._tables_lock:
            dead = []
            for (owner, nm), ref in self._tables.items():
                data = ref()
                if data is None:
                    dead.append((owner, nm))
                else:
                    out.append((nm, data))
            for k in dead:
                self._tables.pop(k, None)
        return out

    def _walk(self, tables):
        """(host per table, device per table, retained per table,
        join build bytes) of one ledger walk."""
        from snappydata_tpu_torch.ops.join import join_build_cache_nbytes
        from snappydata_tpu_torch.storage.device import \
            device_cache_bytes_by_table
        from snappydata_tpu_torch.storage.mvcc import \
            retained_epoch_bytes_by_table

        host: Dict[str, int] = {}
        for nm, data in tables:   # same-named tables of two catalogs SUM
            host[nm] = host.get(nm, 0) + _host_table_bytes(data)
        return (host, device_cache_bytes_by_table(tables),
                retained_epoch_bytes_by_table(tables),
                join_build_cache_nbytes())

    def ledger(self) -> dict:
        """Point-in-time unified ledger: per-table host / device bytes,
        spill and tier file bytes, and per-query admitted estimates."""
        from snappydata_tpu_torch.storage import hoststore, tier

        host, device, retained, join_bytes = self._walk(self._iter_tables())
        gidx_bytes, serving_bytes, mesh_bytes = _cache_bytes()
        view_bytes = _matview_bytes()
        retained_total = sum(retained.values())
        with self._cond:
            queries = {qid: int(ctx.estimate_bytes)
                       for qid, ctx in self._active.items()}
        host_total = sum(host.values()) + serving_bytes + retained_total
        device_total = sum(device.values()) + gidx_bytes + join_bytes \
            + view_bytes + mesh_bytes
        # this walk IS the measurement: refresh the gauge cache
        self._measured_cache = (time.monotonic(), host_total, device_total)
        return {
            "host": host,
            "device": device,
            "spill_file_bytes": hoststore.spill_file_bytes(),
            # CRC-framed disk-tier files: like spill files, their pages
            # belong to the OS cache, so they never count into host_total
            "tier_file_bytes": tier.tier_file_bytes(),
            "host_total": host_total,
            "serving_registry_bytes": serving_bytes,
            "gidx_cache_bytes": gidx_bytes,
            "join_build_cache_bytes": join_bytes,
            "matview_state_bytes": view_bytes,
            "mesh_layout_cache_bytes": mesh_bytes,
            # host bytes old manifests hold beyond the current one while
            # pinned readers (or the short unpinned history) keep them
            "retained_epoch_bytes": retained_total,
            "device_total": device_total,
            "queries": queries,
            "inflight_bytes": int(self._inflight_bytes),
        }

    def measured_bytes(self, max_age_s: float = 0.0) -> Tuple[int, int]:
        """(host_bytes, device_bytes) in use.  `max_age_s` lets cheap
        consumers (gauges, admission) reuse a recent walk."""
        if max_age_s > 0:
            ts, h, d = self._measured_cache
            if time.monotonic() - ts <= max_age_s:
                return h, d
        host, device, retained, join_bytes = self._walk(self._iter_tables())
        gidx_bytes, serving_bytes, mesh_bytes = _cache_bytes()
        view_bytes = _matview_bytes()
        h = sum(host.values()) + serving_bytes + sum(retained.values())
        d = sum(device.values()) + gidx_bytes + join_bytes + view_bytes \
            + mesh_bytes
        self._measured_cache = (time.monotonic(), h, d)
        return h, d

    # -- admission ------------------------------------------------------

    def _has_room(self, ctx: QueryContext, limit: int) -> bool:
        return self._inflight_bytes + ctx.estimate_bytes <= limit

    def _fair_slot_free(self, ctx: QueryContext) -> bool:
        slots = int(self.props.admission_slots_per_user or 0)
        if slots <= 0:
            return True
        held = sum(1 for c in self._active.values() if c.user == ctx.user)
        return held < slots

    def admit(self, ctx: QueryContext, estimate_bytes: int = 0,
              timeout_s: float = 0.0) -> QueryContext:
        """Admit, queue, or reject `ctx`.  On admit the context is
        registered (visible to `queries()` / `cancel()`) and its statement
        deadline runs.  Callers MUST pair it with `release(ctx)`."""
        reg = global_registry()
        ctx.estimate_bytes = int(estimate_bytes or 0)
        if ctx.cancelled:
            # cancelled in the submit -> admit window: never start
            raise CancelException(
                f"query {ctx.query_id} "
                f"{ctx.cancel_reason or 'cancelled'} before admission")
        from snappydata_tpu_torch.reliability import failpoints as rfail

        # admission entry seam, ahead of the limit check: it fires whether
        # or not accounting is on
        rfail.hit("broker.admit")
        # background-compaction kick: a flag check under a leaf lock; the
        # rewrite never runs on the admission path
        from snappydata_tpu_torch.storage import compact

        compact.maybe_kick(self)
        limit = self._limit()
        if limit <= 0:
            # accounting off: admit, but register, so cancel / timeouts /
            # visibility work
            with self._cond:
                self._active[ctx.query_id] = ctx
                self._inflight_bytes += ctx.estimate_bytes
            ctx.start(timeout_s)
            reg.inc("governor_admitted")
            return ctx
        if ctx.estimate_bytes > limit:
            reg.inc("governor_rejected")
            raise LowMemoryException(
                f"query estimate {ctx.estimate_bytes} bytes exceeds "
                f"memory_limit_bytes={limit}; rejected before execution "
                f"(raise the limit or narrow the scan)")
        # measured pressure: degrade first (a 0.25 s walk cache bounds the
        # per-admission cost under concurrent short queries)
        host, device = self.measured_bytes(max_age_s=0.25)
        if host + device > self._high_bytes(limit):
            self._degrade(int(self._low_bytes(limit)), requester=ctx)
        elif host + device > self._pressure_bytes(limit):
            # between the pressure and high watermarks: background relief
            # now, while this statement still fits
            self._kick_pressure_demote(limit)
        # a statement timeout covers queue time too: the deadline is
        # pinned NOW so ctx.start() cannot re-arm it
        stmt_deadline = None
        wait_s = float(self.props.admission_wait_s)
        if timeout_s and timeout_s > 0:
            stmt_deadline = time.monotonic() + float(timeout_s)
            ctx.deadline = stmt_deadline
            wait_s = min(wait_s, float(timeout_s))
        deadline = time.monotonic() + wait_s
        queued = False
        with self._cond:
            while True:
                if ctx.cancelled:
                    if queued:
                        self._queue.remove(ctx)
                    raise CancelException(
                        f"query {ctx.query_id} "
                        f"{ctx.cancel_reason or 'cancelled'} while queued")
                # FIFO over memory, but a head blocked only by its
                # principal's fair slot must not starve other users
                ahead = self._queue[:self._queue.index(ctx)] if queued \
                    else list(self._queue)
                if self._has_room(ctx, limit) \
                        and self._fair_slot_free(ctx) \
                        and all(not self._fair_slot_free(e)
                                for e in ahead):
                    if queued:
                        self._queue.remove(ctx)
                    self._active[ctx.query_id] = ctx
                    self._inflight_bytes += ctx.estimate_bytes
                    ctx.start(timeout_s)
                    reg.inc("governor_admitted")
                    self._cond.notify_all()
                    return ctx
                if not queued:
                    depth = int(self.props.admission_queue_depth)
                    if len(self._queue) >= max(0, depth):
                        reg.inc("governor_rejected")
                        raise LowMemoryException(
                            f"admission queue full ({len(self._queue)} "
                            f"waiting, depth {depth}); query rejected")
                    self._queue.append(ctx)
                    ctx.state = "queued"
                    queued = True
                    reg.inc("governor_queued")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._queue.remove(ctx)
                    if stmt_deadline is not None \
                            and time.monotonic() >= stmt_deadline:
                        # the STATEMENT timeout expired while queued: a
                        # cancellation (XCL52), not a memory rejection
                        ctx.cancel("timed out (query_timeout_s) "
                                   "while queued for admission")
                        reg.inc("governor_timeouts")
                        raise CancelException(
                            f"query {ctx.query_id} exceeded its "
                            f"statement timeout while queued")
                    reg.inc("governor_rejected")
                    raise LowMemoryException(
                        f"query {ctx.query_id} waited {wait_s:.1f}s "
                        f"for admission ({self._inflight_bytes} of "
                        f"{limit} bytes in flight); rejected")
                self._cond.wait(min(remaining, 0.25))

    def watch(self, ctx: QueryContext) -> QueryContext:
        """Register a context BEFORE admission: it shows in `queries()`
        and `cancel()` finds it from submission on; a cancel in the
        submit -> admit window makes `admit()` raise.  Cleared by
        `release()` (call it even when admission fails)."""
        with self._cond:
            self._watched[ctx.query_id] = ctx
        return ctx

    def release(self, ctx: QueryContext) -> None:
        with self._cond:
            self._watched.pop(ctx.query_id, None)
            if self._active.pop(ctx.query_id, None) is not None:
                self._inflight_bytes -= ctx.estimate_bytes
                if self._inflight_bytes < 0:
                    self._inflight_bytes = 0
            ctx.state = "finished"
            self._cond.notify_all()

    # -- degradation ----------------------------------------------------

    def _degrade(self, target_bytes: int,
                 requester: Optional[QueryContext] = None) -> None:
        """Graceful pressure relief, cheapest first (ref: the evict ->
        spill -> cancel order of SnappyStorageEvictor + CancelException):
        plan caches (with the group-index cache and the prepared-plan
        registries), materialized-view states, unpinned retained epochs,
        the tier ladder, host spill, then cancel the hungriest admitted
        query (never the requester)."""
        reg = global_registry()
        host, device = self.measured_bytes()
        if host + device <= target_bytes:
            return
        for ex in list(self._executors):
            try:
                ex.clear_cache()   # plans, the group-index cache, joins
            except Exception:
                pass
        # prepared-plan registries are caches too: an evicted statement
        # re-prepares transparently on its next execute
        from snappydata_tpu_torch.serving.prepared import _REGISTRIES

        for r in list(_REGISTRIES):
            try:
                r.clear()
            except Exception:
                pass
        reg.inc("governor_degrade_plan_evictions")
        host, device = self.measured_bytes()
        if host + device <= target_bytes:
            return
        # materialized-view [G] states are caches too: evictable to STALE
        # (rebuilt by one re-aggregation at the next read), cheaper than
        # demoting hot batches every scan re-reads
        from snappydata_tpu_torch.views.matview import evict_all_states

        if evict_all_states():
            reg.inc("governor_degrade_view_evictions")
        host, device = self.measured_bytes()
        if host + device <= target_bytes:
            return
        # retained epochs nobody pins (and their stale plates): cheaper
        # than demoting hot batches; pinned epochs are untouchable
        from snappydata_tpu_torch.storage import mvcc

        if mvcc.trim_unpinned(self._iter_tables()):
            reg.inc("governor_degrade_epoch_trims")
        host, device = self.measured_bytes()
        if host + device <= target_bytes:
            return
        # the tier ladder: cold UNPINNED plates back to the host pool,
        # then the oldest host batches into CRC-checked disk-tier files;
        # both rebuild transparently on the next bind or scan
        from snappydata_tpu_torch.storage import tier

        if tier.demote(self._iter_tables(), host + device - target_bytes):
            reg.inc("governor_degrade_tier_demotions")
        host, device = self.measured_bytes()
        if host + device <= target_bytes:
            return
        from snappydata_tpu_torch.storage import hoststore

        for _nm, data in self._iter_tables():
            host, device = self.measured_bytes()
            excess = host + device - target_bytes
            if excess <= 0:
                return
            if hasattr(data, "_manifest"):
                # spill only down to the deficit: a marginal crossing must
                # not flush a whole hot table to disk
                keep = max(0, _host_table_bytes(data) - excess)
                try:
                    if hoststore.spill_to_budget(data, keep):
                        reg.inc("governor_degrade_spills")
                except Exception:
                    pass
        host, device = self.measured_bytes()
        if host + device <= target_bytes:
            return
        with self._cond:
            victims = [c for c in self._active.values() if c is not requester]
        if victims:
            hungriest = max(victims, key=lambda c: c.estimate_bytes)
            hungriest.cancel("cancelled by resource broker (low memory)")
            reg.inc("governor_degrade_kills")
            reg.inc("governor_cancelled")
            with self._cond:
                self._cond.notify_all()

    # -- cancellation / visibility --------------------------------------

    def cancel(self, query_id: str, reason: str = "cancelled by request",
               user: Optional[str] = None) -> bool:
        """Flag a running or queued query.  `user` (when given and not
        admin) may only cancel their own queries."""
        with self._cond:
            ctx = self._lookup_locked(query_id)
            if ctx is None:
                return False
            if user is not None and user != "admin" and ctx.user != user:
                raise PermissionError(
                    f"user {user!r} may not cancel query {query_id} "
                    f"owned by {ctx.user!r}")
            ctx.cancel(reason)
            self._cond.notify_all()
        global_registry().inc("governor_cancelled")
        return True

    def queries(self) -> List[dict]:
        with self._cond:
            seen = {c.query_id: c for c in self._watched.values()}
            seen.update({c.query_id: c for c in self._queue})
            seen.update({c.query_id: c for c in self._active.values()})
            out = [c.describe() for c in seen.values()]
        out.sort(key=lambda d: d["submitted_ts"])
        return out

    def _lookup_locked(self, query_id: str) -> Optional[QueryContext]:
        return self._active.get(query_id) \
            or next((c for c in self._queue if c.query_id == query_id),
                    None) \
            or self._watched.get(query_id)


_global_broker: Optional[ResourceBroker] = None
_global_lock = locks.named_lock("resource.broker_global")


def global_broker() -> ResourceBroker:
    global _global_broker
    if _global_broker is None:
        with _global_lock:
            if _global_broker is None:
                _global_broker = ResourceBroker()
    return _global_broker
