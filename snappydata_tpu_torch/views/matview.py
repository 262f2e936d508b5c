"""Materialized aggregate views maintained by delta-folding partial programs.

Port of snappydata_tpu/views/matview.py.  The [G] accumulator state lives
on the session's torch device; the scatter-merge is `index_add_` (sums,
counts) and `scatter_reduce_` with amin / amax (min / max slots), with
the partial rows widened to the accumulator dtype (float64 for float
domains, int64 otherwise) before they merge, on every device.

CREATE MATERIALIZED VIEW <name> AS <single-relation group-by aggregate>
stores the aggregate in the partial representation: a group-key
dictionary (host) plus per-slot accumulator arrays (device, one aligned
[G] space) sized on the {2^k, 1.5*2^k} bucket ladder so growth implies
only logarithmically many reallocations.  Every ingest delta runs through
the view's compiled partial program over a scratch delta table — the same
decomposition (`engine/partial_agg.decompose_aggregate`) the tiled scan
and the distributed scatter path use — and the resulting per-group slots
scatter-merge into the stored state on device (`.at[idx].add/min/max`,
the elementwise form of `executor.merge_tile_outs`).  Dashboards that
re-read the view pay O(G), not O(N).

Maintenance semantics:
- inserts (session insert/insert_arrays, SQL INSERT, bulk lanes, the
  streaming sink's keyless lane) fold the delta batch: O(delta);
- deletes SUBTRACT exactly when every slot is invertible (sum / count /
  sumsq families over int64 or f64); a min/max slot cannot un-see a
  value, so deletes mark the view STALE instead;
- updates and keyed upserts (PUT on key'd tables) mark STALE — the old
  image is not cheaply available on those paths;
- STALE views re-aggregate the base table in full on the next read (or
  explicit REFRESH MATERIALIZED VIEW) and resume delta folding.

NULL bookkeeping: each non-count slot carries a "seen" count (non-null
contributions per group, an extra count(arg) item in the partial
program) — exact under subtraction; the read path emits SQL NULL for
groups whose seen count is zero.  A hidden count(*) slot (`__rc`) tracks
live rows per group so a fully-deleted group drops out of the view
exactly as a re-aggregation would drop it.

Durability: view state checkpoints through the DiskStore with a recorded
WAL high-watermark seq (the checkpoint fence); crash recovery reloads the
state and folds ONLY the WAL tail past the watermark — the chaos
invariant (no acked row lost, no double-fold) extends to view state.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.utils import locks


class MatViewError(ValueError):
    """Definition not maintainable as a materialized aggregate."""


def _norm(name: str) -> str:
    return name.lower().removeprefix("app.")


def matviews(catalog) -> Dict[str, "MaterializedView"]:
    return getattr(catalog, "_matviews", {})


def matviews_on(catalog, table: str) -> List["MaterializedView"]:
    t = _norm(table)
    return [mv for mv in matviews(catalog).values() if mv.base_table == t]


def _rewrite_relation(plan: ast.Plan, new_name: str) -> ast.Plan:
    """Replace the single UnresolvedRelation leaf with `new_name`."""
    if isinstance(plan, ast.UnresolvedRelation):
        return ast.UnresolvedRelation(new_name)
    if isinstance(plan, ast.Filter):
        return ast.Filter(_rewrite_relation(plan.child, new_name),
                          plan.condition)
    if isinstance(plan, ast.SubqueryAlias):
        return _rewrite_relation(plan.child, new_name)
    raise MatViewError(
        f"materialized views support a single base relation "
        f"(got {type(plan).__name__})")


def _acc_np_dtype(dt: Optional[T.DataType]) -> np.dtype:
    """Accumulator dtype for one slot: float domains widen to f64 (the
    same policy as the executor's [G] partials), everything integral
    accumulates exactly in int64."""
    if dt is not None and dt.name in ("float", "double", "decimal"):
        return np.dtype(np.float64)
    return np.dtype(np.int64)


def _extreme_fill(np_dtype: np.dtype, positive: bool):
    if np.issubdtype(np_dtype, np.floating):
        return np_dtype.type(np.inf if positive else -np.inf)
    info = np.iinfo(np_dtype)
    return np_dtype.type(info.max if positive else info.min)


def _torch_dtype(np_dtype) -> torch.dtype:
    return T.torch_dtype(np_dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _data_version(data) -> int:
    if hasattr(data, "snapshot"):
        return int(data.snapshot().version)
    return int(getattr(data, "version", 0))


def _concat_pending(entries):
    """Coalesce a pending-fold journal into maximal same-sign runs:
    [(arrays, nulls, sign)].  Sum/count slots commute within a sign, so
    concatenating preserves the fold result exactly while bounding the
    replay at O(sign flips) partial-program runs instead of O(commits)."""
    out = []
    run: List[tuple] = []
    run_sign = 0

    def flush():
        if not run:
            return
        if len(run) == 1:
            out.append((run[0][1], run[0][2], run_sign))
            return
        ncols = len(run[0][1])
        arrays, nulls = [], []
        for ci in range(ncols):
            parts = [np.asarray(e[1][ci]) for e in run]
            if any(p.dtype == object for p in parts):
                parts = [np.asarray(p, dtype=object) for p in parts]
            arrays.append(np.concatenate(parts))
            mparts, any_mask = [], False
            for e in run:
                m = e[2][ci] if e[2] is not None else None
                if m is not None:
                    any_mask = True
                    mparts.append(np.asarray(m, dtype=bool))
                else:
                    mparts.append(np.zeros(len(np.asarray(e[1][ci])),
                                           dtype=bool))
            nulls.append(np.concatenate(mparts) if any_mask else None)
        out.append((arrays, nulls, run_sign))

    for _ver, arrays, nulls, sign in entries:
        if run and sign != run_sign:
            flush()
            run = []
        run_sign = sign
        run.append((None, arrays, nulls))
    flush()
    return out


class MaterializedView:
    """One maintained view: definition + partial programs + [G] state."""

    def __init__(self, name: str, base_table: str, sql_text: str,
                 device=None):
        self.name = _norm(name)
        # the session's torch device: the [G] state and the scratch
        # session live there
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.base_table = _norm(base_table)
        self.sql_text = sql_text          # full CREATE DDL (persisted)
        self.select_sql = ""              # the AS <select> body
        self._lock = locks.named_rlock("views.matview")
        # definition (filled by define())
        self.group_exprs: Tuple[ast.Expr, ...] = ()
        self.slot_kinds: List[str] = []   # decomposed slot kind per __p
        self.seen_slots: List[Optional[int]] = []  # __n output ordinal
        self.rc_slot = -1                 # hidden count(*) output ordinal
        self.delta_partial_sql = ""       # partial program over __mv_delta
        self.base_partial_sql = ""        # partial program over the base
        self.merge_sql = ""               # re-aggregation over __mv_partials
        self.partial_schema: T.Schema = None   # __g*/__p*/__n*/__rc fields
        self.output_schema: T.Schema = None    # the view's visible schema
        self.subtractable = True          # no min/max slot
        # state ----------------------------------------------------------
        self._keys: List[np.ndarray] = []          # host, [cap] each
        self._key_nulls: List[np.ndarray] = []     # host bool [cap]
        self._vals: List = []                      # device tensor [cap]
        self._seen: List = []                      # device int64 [cap]
        self._rowcount = None                      # device int64 [cap]
        self._index: Dict[tuple, int] = {}
        self._g = 0
        self._cap = 0
        self.stale = True                 # until the first refresh
        self._dirty = True                # backing table out of date
        self.wal_seq = 0                  # checkpoint fence (high watermark)
        self._refresh_version = -1        # base data version at refresh
        # refresh-without-mutation_lock machinery (storage/mvcc): while a
        # full refresh rescans the base OUTSIDE any lock, concurrent
        # commits keep flowing — their deltas land in the pending-fold
        # journal (with the base version they committed at) and replay
        # on top of the rebuilt state for versions past the rescan's
        # pinned epoch.  _refresh_lock serializes whole refreshes.
        self._refresh_lock = locks.named_lock("views.matview_refresh")
        self._refreshing = False
        self._pending: List[tuple] = []   # (base_version, arrays, nulls, sign)
        self._pending_dirtied = False     # raced mark_stale/minmax delete
        self._PENDING_CAP = 256           # journal bound: beyond it, stay stale
        # evidence counters (also bumped in the global registry)
        self.folds = 0
        self.rows_folded = 0
        self.full_refreshes = 0
        self.stale_marks = 0
        self._scratch = None              # lazy scratch session
        self._base_fields_cache = None
        self._delta_tok = None

    # -- definition --------------------------------------------------------

    @classmethod
    def define(cls, session, name: str, plan: ast.Plan,
               sql_text: str) -> "MaterializedView":
        """Validate + compile the maintenance programs for `plan` (the
        parsed AS-select).  Raises MatViewError on shapes that cannot be
        maintained incrementally."""
        from snappydata_tpu_torch.engine.partial_agg import (NotDecomposableError,
                                                       decompose_aggregate)
        from snappydata_tpu_torch.sql.optimizer import optimize
        from snappydata_tpu_torch.sql.render import RenderError, render_expr, \
            render_plan

        node = plan
        having = None
        if isinstance(node, (ast.Sort, ast.Limit, ast.Distinct)):
            raise MatViewError(
                "ORDER BY / LIMIT / DISTINCT are not allowed in a "
                "materialized view definition — apply them when querying "
                "the view")
        if isinstance(node, ast.Filter) and isinstance(node.child,
                                                       ast.Aggregate):
            having = node.condition
            node = node.child
        if not isinstance(node, ast.Aggregate):
            raise MatViewError(
                "a materialized view must be a GROUP BY aggregate "
                "(SELECT <keys/aggregates> FROM t [WHERE ...] "
                "GROUP BY ...)")
        if node.grouping_sets:
            raise MatViewError(
                "ROLLUP/CUBE/GROUPING SETS views are not supported")
        for e in list(node.group_exprs) + list(node.agg_exprs) + \
                ([having] if having is not None else []):
            for sub in ast.walk(e):
                if isinstance(sub, (ast.ScalarSubquery, ast.InSubquery,
                                    ast.ExistsSubquery, ast.WindowFunc)):
                    raise MatViewError(
                        "subqueries/window functions are not supported "
                        "in materialized view definitions")

        # single-relation child ([Filter] over the base table)
        probe = node.child
        while isinstance(probe, (ast.Filter, ast.SubqueryAlias)):
            probe = probe.children()[0]
        if not isinstance(probe, ast.UnresolvedRelation):
            raise MatViewError(
                "materialized views support a single-relation aggregate "
                "(no joins/unions yet)")
        base = _norm(probe.name)
        base_info = session.catalog.lookup_table(base)
        if base_info is None:
            raise MatViewError(f"base table not found: {probe.name}")
        if base_info.provider == "sample":
            raise MatViewError(
                "materialized views over sample tables are not supported")
        if base_info.options.get("materialized_view"):
            raise MatViewError(
                "materialized views over materialized views are not "
                "supported")

        mv = cls(name, base, sql_text, device=session.device)
        try:
            from snappydata_tpu_torch.sql.render import render_plan as _rp

            mv.select_sql = _rp(plan if having is None
                                else ast.Filter(node, having))
        except Exception:
            mv.select_sql = sql_text
        try:
            partial_plan, merged_select, _n_slots, merged_having = \
                decompose_aggregate(node, having)
        except NotDecomposableError as e:
            raise MatViewError(f"not incrementally maintainable: {e}")
        groups = list(node.group_exprs)
        # recover the slot table decompose built (kind per __p ordinal)
        slot_items = list(partial_plan.agg_exprs)[len(groups):]
        kinds: List[str] = []
        for it in slot_items:
            fn = it.child
            if isinstance(fn, ast.Func) and fn.name == "count" \
                    and not fn.args:
                kinds.append("count_star")
            elif isinstance(fn, ast.Func) and fn.name == "count_distinct":
                raise MatViewError(
                    "count(DISTINCT ...) cannot be folded incrementally")
            elif isinstance(fn, ast.Func):
                # sum/min/max/count — sumsq arrives as sum(arg*arg)
                kinds.append(fn.name)
            else:  # pragma: no cover - decompose only emits Funcs
                raise MatViewError(f"unexpected partial item {it!r}")
        mv.slot_kinds = kinds
        mv.subtractable = not any(k in ("min", "max") for k in kinds)
        # null bookkeeping: one count(arg) per non-count slot, plus the
        # hidden live-rows count(*) every view carries
        aug_items = list(partial_plan.agg_exprs)
        seen_slots: List[Optional[int]] = []
        for i, (it, kind) in enumerate(zip(slot_items, kinds)):
            if kind in ("count", "count_star"):
                seen_slots.append(None)
                continue
            arg = it.child.args[0]
            seen_slots.append(len(aug_items))
            aug_items.append(ast.Alias(ast.Func("count", (arg,)),
                                       f"__n{i}"))
        mv.seen_slots = seen_slots
        mv.rc_slot = len(aug_items)
        aug_items.append(ast.Alias(ast.Func("count", ()), "__rc"))
        mv.group_exprs = tuple(groups)

        aug_partial = ast.Aggregate(partial_plan.child, tuple(groups),
                                    tuple(aug_items))
        try:
            mv.base_partial_sql = render_plan(aug_partial)
            delta_plan = ast.Aggregate(
                _rewrite_relation(partial_plan.child, "__mv_delta"),
                tuple(groups), tuple(aug_items))
            mv.delta_partial_sql = render_plan(delta_plan)
            merge_items = ", ".join(render_expr(e) for e in merged_select)
            msql = f"SELECT {merge_items} FROM __mv_partials"
            if groups:
                msql += " GROUP BY " + ", ".join(
                    f"__g{i}" for i in range(len(groups)))
            if merged_having is not None:
                msql += f" HAVING {render_expr(merged_having)}"
            mv.merge_sql = msql
        except RenderError as e:
            raise MatViewError(f"definition is not renderable: {e}")

        # validate + capture schemas by analyzing against the live catalog
        from snappydata_tpu_torch.session import _output_schema

        resolved_p, _ = session.analyzer.analyze_plan(
            optimize(aug_partial, session.catalog))
        mv.partial_schema = _output_schema(resolved_p)
        resolved_v, _ = session.analyzer.analyze_plan(
            optimize(plan, session.catalog))
        out = _output_schema(resolved_v)
        # backing storage lives in the HOST value domain: decimals ride f64
        mv.output_schema = T.Schema([
            T.Field(f.name, T.DOUBLE if f.dtype.name == "decimal"
                    else f.dtype, True) for f in out.fields])
        for i, k in enumerate(kinds):
            f = mv.partial_schema.fields[len(groups) + i]
            if k in ("min", "max") and f.dtype.name == "string":
                raise MatViewError(
                    "min/max over string columns is not supported in "
                    "materialized views")
        for f in mv.partial_schema.fields[:len(groups)]:
            if f.dtype.name in ("array", "map", "struct"):
                raise MatViewError(
                    "complex-typed group keys are not supported")
        mv.bind_base(base_info)
        return mv

    # -- state plumbing ----------------------------------------------------

    def _n_groups_cols(self) -> int:
        return len(self.group_exprs)

    def _slot_field(self, i: int) -> T.Field:
        return self.partial_schema.fields[self._n_groups_cols() + i]

    def _reset_state(self) -> None:
        ng, ns = self._n_groups_cols(), len(self.slot_kinds)
        dev = self.device
        self._cap = 0
        self._g = 0
        self._index = {}
        self._keys = [np.empty(0, dtype=self._key_np_dtype(i))
                      for i in range(ng)]
        self._key_nulls = [np.empty(0, dtype=np.bool_) for _ in range(ng)]
        self._vals = [torch.empty(0, dtype=_torch_dtype(self._acc_dtype(i)),
                                  device=dev) for i in range(ns)]
        self._seen = [torch.empty(0, dtype=torch.int64, device=dev)
                      if self.seen_slots[i] is not None else None
                      for i in range(ns)]
        self._rowcount = torch.empty(0, dtype=torch.int64, device=dev)

    def _key_np_dtype(self, i: int):
        dt = self.partial_schema.fields[i].dtype
        return object if dt.name == "string" else dt.np_dtype

    def _acc_dtype(self, i: int) -> np.dtype:
        return _acc_np_dtype(self._slot_field(i).dtype)

    def _fill_value(self, i: int):
        kind = self.slot_kinds[i]
        dt = self._acc_dtype(i)
        if kind == "min":
            return _extreme_fill(dt, True)
        if kind == "max":
            return _extreme_fill(dt, False)
        return dt.type(0)

    def _grow(self, need: int) -> None:
        """Bucket-ladder reallocation: capacity only ever takes values in
        {2^k, 1.5*2^k}, so a growing view reallocates O(log G) times."""
        from snappydata_tpu_torch.storage.device import batch_bucket

        new_cap = batch_bucket(max(1, need))
        if new_cap <= self._cap:
            return
        pad = new_cap - self._cap
        for i in range(len(self._keys)):
            filler = np.zeros(pad, dtype=object) \
                if self._keys[i].dtype == object \
                else np.zeros(pad, dtype=self._keys[i].dtype)
            self._keys[i] = np.concatenate([self._keys[i], filler])
            self._key_nulls[i] = np.concatenate(
                [self._key_nulls[i], np.zeros(pad, dtype=np.bool_)])
        dev = self.device
        for i in range(len(self._vals)):
            fill = torch.full((pad,), self._fill_value(i).item(),
                              dtype=_torch_dtype(self._acc_dtype(i)),
                              device=dev)
            self._vals[i] = torch.cat([self._vals[i], fill])
            if self._seen[i] is not None:
                self._seen[i] = torch.cat(
                    [self._seen[i],
                     torch.zeros(pad, dtype=torch.int64, device=dev)])
        self._rowcount = torch.cat(
            [self._rowcount, torch.zeros(pad, dtype=torch.int64,
                                         device=dev)])
        self._cap = new_cap
        global_registry().inc("view_state_regrows")

    def state_nbytes(self) -> int:
        total = 0
        for a in self._keys:
            total += int(a.nbytes) if a.dtype != object else 8 * a.size
        for a in self._key_nulls:
            total += int(a.nbytes)
        for a in list(self._vals) + list(self._seen) + [self._rowcount]:
            if a is not None:
                # the storage's size is metadata: never copy a device
                # tensor here (the ledger scrapes this on the admission
                # hot path).  Every state tensor owns its storage (each
                # growth reallocates with torch.cat), so each counts once
                total += int(a.untyped_storage().nbytes())
        return total

    # -- scratch sessions --------------------------------------------------

    def _scratch_session(self):
        """One throwaway in-memory session per view holding the delta
        table (base schema, decimals as DOUBLE) and the partial-rows
        table the read path re-aggregates — never journaled."""
        if self._scratch is not None:
            return self._scratch
        from snappydata_tpu_torch.catalog import Catalog
        from snappydata_tpu_torch.engine.partial_agg import ddl_type
        from snappydata_tpu_torch.session import SnappySession

        # on the parent session's device (a default session would ask
        # for CUDA)
        s = SnappySession(catalog=Catalog(), device=self.device)
        s._in_tile = True   # partial/merge SQL must never re-tile
        fields_sql = ", ".join(
            f"{f.name} {ddl_type(f.dtype)}" for f in self._base_fields())
        s.sql(f"CREATE TABLE __mv_delta ({fields_sql}) USING column")
        ng = self._n_groups_cols()
        pf = []
        for i, f in enumerate(
                self.partial_schema.fields[:ng + len(self.slot_kinds)]):
            if i < ng:
                pf.append(f"{f.name} {ddl_type(f.dtype)}")
            else:
                acc = self._acc_dtype(i - ng)
                pf.append(f"{f.name} "
                          f"{'DOUBLE' if acc == np.float64 else 'BIGINT'}")
        s.sql(f"CREATE TABLE __mv_partials ({', '.join(pf)}) USING column")
        self._scratch = s
        return s

    def _base_fields(self):
        if self._base_fields_cache is None:
            raise MatViewError(f"view {self.name} not bound to its base")
        return self._base_fields_cache

    def bind_base(self, base_info) -> None:
        """Capture the base schema the maintenance programs run against
        (ALTER TABLE on the base marks the view stale and rebinds)."""
        self._base_fields_cache = [
            T.Field(f.name, T.DOUBLE if f.dtype.name == "decimal"
                    else f.dtype, f.nullable)
            for f in base_info.schema.fields]

    def invalidate_scratch(self) -> None:
        with self._lock:
            if self._scratch is not None:
                try:
                    self._scratch.stop()
                except Exception:
                    pass
                self._scratch = None
            self._delta_tok = None

    # -- folding -----------------------------------------------------------

    def _normalize_delta(self, arrays, nulls):
        """Ingest arrays arrive in several host flavors (typed arrays +
        null masks, or object arrays with embedded None from row-table
        lanes).  Normalize to what the scratch column table ingests."""
        fields = self._base_fields()
        if len(arrays) != len(fields):
            raise MatViewError("delta arity does not match the base table")
        out_arrays, out_nulls = [], []
        nulls = list(nulls) if nulls is not None else [None] * len(arrays)
        for a, m, f in zip(arrays, nulls, fields):
            a = np.asarray(a)
            if f.dtype.name in ("string", "array", "map", "struct"):
                out_arrays.append(np.asarray(a, dtype=object))
                out_nulls.append(np.asarray(m, dtype=bool)
                                 if m is not None else None)
                continue
            if a.dtype == object:
                none_mask = np.fromiter((v is None for v in a),
                                        dtype=np.bool_, count=len(a))
                filled = np.array([0 if v is None else v for v in a],
                                  dtype=f.dtype.np_dtype)
                m = none_mask if m is None \
                    else (np.asarray(m, dtype=bool) | none_mask)
                out_arrays.append(filled)
                out_nulls.append(m if m.any() else None)
                continue
            out_arrays.append(a.astype(f.dtype.np_dtype, copy=False))
            out_nulls.append(np.asarray(m, dtype=bool)
                             if m is not None else None)
        return out_arrays, out_nulls

    def fold_delta(self, arrays, nulls, sign: int = 1,
                   version: Optional[int] = None) -> None:
        """Fold one ingest delta into the stored state: run the compiled
        partial program over the delta rows, then scatter-merge the
        per-group slots into the aligned [G] space on device.  sign=-1
        subtracts (delete path; only valid when `subtractable`)."""
        reg = global_registry()
        with self._lock:
            if self._refreshing:
                # a full refresh is rescanning the base WITHOUT holding
                # mutation_lock (the old design stalled every committer
                # behind the scan): divert this commit's delta to the
                # pending journal — the refresh replays entries past its
                # pinned epoch on top of the rebuilt state
                if sign < 0 and not self.subtractable:
                    self._pending_dirtied = True
                    return
                if len(self._pending) >= self._PENDING_CAP:
                    # journal bound: give up on this refresh converging
                    # (stays stale, next read re-aggregates)
                    self._pending_dirtied = True
                    return
                n = int(np.asarray(arrays[0]).shape[0]) if arrays else 0
                if n:
                    self._pending.append((version, list(arrays),
                                          list(nulls) if nulls is not None
                                          else None, sign))
                    reg.inc("view_pending_folds")
                return
            if self.stale:
                return   # stale views re-aggregate at next read anyway
            if sign < 0 and not self.subtractable:
                self.mark_stale("delete on a min/max view")
                return
            if version is not None and version <= self._refresh_version:
                return   # delta already covered by the refresh scan
            n = int(np.asarray(arrays[0]).shape[0]) if arrays else 0
            if n == 0:
                return
            try:
                # locklint: lock-order-undeclared,blocking-under-lock the
                # fold's scratch session is STORE-LESS (_scratch_session):
                # its statements never take the durable store's
                # mutation_lock or reach wal_sync/fsync — the static
                # chain through SnappySession.sql is unreachable here;
                # device waits are the O(delta) fold itself
                res = self._run_partial_over_delta(arrays, nulls)
                self._merge_partial(res, sign)
            except Exception as e:  # noqa: BLE001 — never break ingest
                reg.inc("view_fold_errors")
                self.mark_stale(f"fold error: {e}")
                return
            self._dirty = True
            self.folds += 1
            self.rows_folded += n
            reg.inc("view_delta_folds")
            reg.inc("view_rows_folded", n)
            if sign < 0:
                reg.inc("view_subtract_folds")

    def _run_partial_over_delta(self, arrays, nulls):
        from snappydata_tpu_torch.storage import mvcc

        # the scratch table is rewritten per fold: an outer statement's
        # pin must NOT capture it (the second fold under one pin would
        # re-read the first fold's manifest) — scratch reads are live
        with mvcc.unpinned_scope():
            return self._run_partial_over_delta_unpinned(arrays, nulls)

    def _run_partial_over_delta_unpinned(self, arrays, nulls):
        s = self._scratch_session()
        info = s.catalog.describe("__mv_delta")
        info.data.truncate()
        na, nn = self._normalize_delta(arrays, nulls)
        info.data.insert_arrays(
            na, nulls=nn if any(m is not None for m in nn) else None)
        # compile-once: the scratch catalog never changes after setup, so
        # the tokenized partial plan stays plan-cache-hot across folds
        if self._delta_tok is None:
            from snappydata_tpu_torch.sql.analyzer import tokenize_plan
            from snappydata_tpu_torch.sql.optimizer import optimize
            from snappydata_tpu_torch.sql.parser import parse

            pplan = optimize(parse(self.delta_partial_sql).plan, s.catalog)
            resolved, _ = s.analyzer.analyze_plan(pplan)
            self._delta_tok = tokenize_plan(resolved)
        tokenized, params = self._delta_tok
        from snappydata_tpu_torch.engine.result import to_host_domain

        return to_host_domain(s.executor.execute(tokenized, tuple(params)))

    def _key_tuple(self, cols, nulls, r: int) -> tuple:
        out = []
        for c, m in zip(cols, nulls):
            if m is not None and m[r]:
                out.append(None)
            else:
                v = c[r]
                out.append(v.item() if hasattr(v, "item") else v)
        return tuple(out)

    def _merge_partial(self, res, sign: int) -> None:
        n = res.num_rows
        if n == 0:
            return
        ng = self._n_groups_cols()
        gcols = [res.columns[i] for i in range(ng)]
        gnulls = [res.nulls[i] for i in range(ng)]
        idx = np.empty(n, dtype=np.int64)
        fresh: List[int] = []
        for r in range(n):
            key = self._key_tuple(gcols, gnulls, r)
            at = self._index.get(key)
            if at is None:
                if sign < 0:
                    # subtracting a group that never existed: the state
                    # diverged — degrade to a full re-aggregation rather
                    # than go negative
                    raise MatViewError(f"unknown group in subtract: {key}")
                at = self._g + len(fresh)
                self._index[key] = at
                fresh.append(r)
            idx[r] = at
        if fresh:
            need = self._g + len(fresh)
            if need > self._cap:
                self._grow(need)
            for ci in range(ng):
                for r in fresh:
                    at = idx[r]
                    if gnulls[ci] is not None and gnulls[ci][r]:
                        self._key_nulls[ci][at] = True
                    else:
                        self._keys[ci][at] = gcols[ci][r]
            self._g = need
        # the partial program emits one row per group, so idx is unique
        # within one merge: the atomic index_add_ on the card then adds
        # each slot once, in no launch-order-dependent way
        if np.unique(idx).size != n:
            raise MatViewError("partial rows repeat a group")
        dev = self.device
        tidx = torch.as_tensor(idx, device=dev)

        def widened(a: np.ndarray, acc) -> torch.Tensor:
            # the partial rows widen to the accumulator dtype BEFORE the
            # merge (f32 plates on the card accumulate in float64)
            return torch.as_tensor(np.ascontiguousarray(a.astype(acc)),
                                   device=dev)

        for i, kind in enumerate(self.slot_kinds):
            col = np.asarray(res.columns[ng + i])
            nmask = res.nulls[ng + i]
            acc = self._acc_dtype(i)
            if kind in ("min", "max"):
                fill = self._fill_value(i)
                v = widened(np.where(nmask, fill, col)
                            if nmask is not None else col, acc)
                self._vals[i].scatter_reduce_(
                    0, tidx, v, "amin" if kind == "min" else "amax",
                    include_self=True)
            else:
                v = widened(np.where(nmask, 0, col)
                            if nmask is not None else col, acc)
                self._vals[i].index_add_(0, tidx, v, alpha=sign)
            so = self.seen_slots[i]
            if so is not None:
                cnt = widened(np.asarray(res.columns[so]), np.int64)
                self._seen[i].index_add_(0, tidx, cnt, alpha=sign)
        rc = widened(np.asarray(res.columns[self.rc_slot]), np.int64)
        self._rowcount.index_add_(0, tidx, rc, alpha=sign)

    # -- staleness / refresh ----------------------------------------------

    def mark_stale(self, reason: str = "") -> None:
        with self._lock:
            if self._refreshing:
                # raced a lock-free refresh: its rebuilt state must not
                # publish as fresh (the mark arrived mid-rescan)
                self._pending_dirtied = True
            if not self.stale:
                self.stale = True
                self.stale_marks += 1
                self._dirty = True
                global_registry().inc("view_stale_marks")

    def reset_empty(self, wal_seq: int = 0) -> None:
        """TRUNCATE of the base table: the aggregate of nothing."""
        with self._lock:
            if self._refreshing:
                # a TRUNCATE racing a lock-free refresh: the in-flight
                # rescan's result is pre-truncate — poison it
                self._pending_dirtied = True
            self._reset_state()
            self.stale = False
            self._dirty = True
            self.wal_seq = wal_seq

    def refresh_full(self, session) -> None:
        """Re-aggregate the base table through the session's full engine
        (tiled scans and all) and rebuild the state — the stale-exit and
        REFRESH MATERIALIZED VIEW path.

        The rescan runs WITHOUT mutation_lock: it pins one storage epoch
        (the outer statement's, when ambient — the "stale-refresh reads
        under the outer query's epoch" contract) and aggregates that
        immutable manifest while committers keep publishing.  Deltas
        committed during the scan divert to the pending-fold journal
        (see fold_delta) and replay on top of the rebuilt state for
        versions PAST the pinned epoch — versions at or below it are
        already inside the scan.  The old design held mutation_lock
        across the whole rescan, stalling every writer behind one long
        analytic read."""
        from snappydata_tpu_torch.engine.result import to_host_domain
        from snappydata_tpu_torch.storage import mvcc

        ds = session.disk_store
        with self._refresh_lock:
            base = session.catalog.lookup_table(self.base_table)
            if base is None:
                raise MatViewError(
                    f"base table dropped: {self.base_table}")
            with self._lock:
                self.bind_base(base)
                self.invalidate_scratch()
                # open the journal BEFORE pinning: every commit published
                # after the pin lands in it (never silently lost)
                self._refreshing = True
                self._pending = []
                self._pending_dirtied = False
            try:
                pin = mvcc.current_pin()
                own_scope = contextlib.nullcontext()
                if pin is None and hasattr(base.data, "_manifest"):
                    # REFRESH statement / recovery path: no ambient pin —
                    # take one so the rescan reads one epoch end to end
                    own_scope = mvcc.pinned_scope(session.catalog,
                                                  [self.base_table])
                with own_scope:
                    pin = mvcc.current_pin()
                    col_pin = pin is not None \
                        and hasattr(base.data, "_manifest")
                    # a column-manifest pin makes the rescan race-free
                    # WITHOUT any lock; otherwise (snapshot_isolation
                    # off, or a row-table base) fall back to the old
                    # discipline — mutation_lock across the rescan — or
                    # a commit racing the scan could be both partially
                    # seen by it AND journal-replayed on top (double
                    # count)
                    lock_cm = contextlib.nullcontext() \
                        if col_pin or ds is None else ds.mutation_lock
                    with lock_cm:
                        if col_pin:
                            manifest = pin.repin(base.data)
                            v0 = int(manifest.version)
                            fence = int(manifest.wal_seq)
                        else:
                            if pin is not None:
                                # the pin's earlier row capture may
                                # predate the fence: re-capture NOW,
                                # under the lock
                                pin.repin_row(base.data)
                            v0 = _data_version(base.data)
                            fence = ds.current_wal_seq() if ds is not None \
                                else 0
                        res = to_host_domain(
                            session.sql(self.base_partial_sql))
                with self._lock:
                    self._reset_state()
                    self.stale = False
                    self._merge_partial(res, 1)
                    self._refresh_version = v0
                    # replay commits that raced the rescan (version past
                    # the pinned epoch; None = provenance unknown,
                    # replay).  Same-sign runs concatenate into ONE
                    # partial-program pass — a committer hammering
                    # single-row inserts during a long rescan must not
                    # cost one scratch query per diverted commit
                    pend = [p for p in self._pending
                            if p[0] is None or p[0] > v0]
                    self._pending = []
                    if self._pending_dirtied:
                        # a min/max delete (or journal overflow / raced
                        # TRUNCATE / ALTER) hit mid-refresh: the rebuilt
                        # state cannot be trusted — stay stale (next
                        # read re-aggregates) and SKIP the replay: its
                        # entries may not even match the schema any
                        # more, and the result is discarded regardless
                        self.stale = True
                    else:
                        for parrays, pnulls, psign in _concat_pending(pend):
                            # locklint: lock-order-undeclared,blocking-under-lock
                            # same store-less scratch-session invariant as
                            # fold_delta's call
                            pres = self._run_partial_over_delta(
                                parrays, pnulls)
                            self._merge_partial(pres, psign)
                            self.folds += 1
                            global_registry().inc("view_pending_replays")
                    self._dirty = True
                    self.full_refreshes += 1
                    self.wal_seq = fence
                    # close the journal INSIDE the same lock hold as the
                    # replay: a fold landing between replay and a later
                    # flag flip would be appended and then discarded
                    self._refreshing = False
                    global_registry().inc("view_full_refreshes")
            finally:
                with self._lock:
                    if self._refreshing:
                        # error path (scan raised / admission rejected):
                        # diverted folds are lost with the journal — the
                        # state must not pass for fresh
                        self._refreshing = False
                        self._pending = []
                        self.stale = True

    # -- read path ---------------------------------------------------------

    def _live_rows(self) -> np.ndarray:
        """Indices of groups with live rows (a fully-deleted group drops
        out of the view exactly as a re-aggregation would drop it)."""
        rc = _host(self._rowcount[:self._g])
        return np.flatnonzero(rc > 0)

    def partial_rows(self):
        """(names, arrays, nulls) of the stored [G] partial state — the
        host image the merge re-aggregates and the checkpoint writes."""
        ng, ns = self._n_groups_cols(), len(self.slot_kinds)
        names = [f"__g{i}" for i in range(ng)] + \
                [f"__p{i}" for i in range(ns)]
        live = self._live_rows()
        arrays, nulls = [], []
        for i in range(ng):
            kvals = self._keys[i][:self._g][live].copy()
            kn = self._key_nulls[i][:self._g][live]
            if kn.any() and kvals.dtype == object:
                kvals[kn] = None   # placeholder 0s are not strings
            arrays.append(kvals)
            nulls.append(kn.copy() if kn.any() else None)
        for i in range(ns):
            vals = _host(self._vals[i][:self._g])[live].copy()
            so = self.seen_slots[i]
            if so is not None:
                seen = _host(self._seen[i][:self._g])[live]
                mask = seen <= 0
                nulls.append(mask if mask.any() else None)
            else:
                nulls.append(None)
            arrays.append(vals)
        return names, arrays, nulls

    def finalize(self):
        """Merged (final) Result of the maintained state: O(G) work."""
        from snappydata_tpu_torch.storage import mvcc

        # __mv_partials is truncated + re-filled per merge: like the
        # delta scratch, it must never be captured into an outer pin
        with self._lock, mvcc.unpinned_scope():
            # locklint: blocking-under-lock store-less scratch session —
            # truncate/re-fill never journals or fsyncs
            s = self._scratch_session()
            info = s.catalog.describe("__mv_partials")
            info.data.truncate()
            names, arrays, nulls = self.partial_rows()
            n_live = int(arrays[0].shape[0]) if arrays else 0
            if n_live:
                info.data.insert_arrays(
                    arrays,
                    nulls=nulls if any(m is not None for m in nulls)
                    else None)
            elif not self.group_exprs:
                # global aggregate over an empty table: one identity
                # partial row (counts 0, value slots NULL) so the merge
                # emits count(*) = 0 / sum = NULL, matching SQL
                idr, idn = [], []
                for i, kind in enumerate(self.slot_kinds):
                    idr.append(np.zeros(1, dtype=self._acc_dtype(i)))
                    idn.append(None if kind in ("count", "count_star")
                               else np.ones(1, dtype=np.bool_))
                info.data.insert_arrays(idr, nulls=idn)
            res = s.sql(self.merge_sql)
            res.names = [f.name for f in self.output_schema.fields]
            return res

    def sync(self, session) -> None:
        """Bring the queryable backing table up to date: full refresh if
        stale, then re-merge into the backing rows only when folds
        dirtied the state since the last sync.

        Under an ambient snapshot pin (the outer query's), the base
        table is RE-pinned right before the merge, briefly under
        mutation_lock so no committer can sit between journal-apply and
        fold: at that instant state == aggregate(base@pin), and the
        query then reads base rows and view rows that agree exactly —
        the base-vs-view skew window is closed.  Lock
        order stays mutation_lock → view lock, the same order every
        ingest fold uses (_journal_then holds mutation_lock when
        fold_delta takes the view lock)."""
        from snappydata_tpu_torch.storage import mvcc

        for _attempt in range(2):
            if not self.stale:
                break
            self.refresh_full(session)
        pin = mvcc.current_pin()
        base = session.catalog.lookup_table(self.base_table) \
            if pin is not None else None
        ds = session.disk_store
        lock_cm = ds.mutation_lock if (pin is not None and ds is not None) \
            else contextlib.nullcontext()
        with lock_cm:
            # locklint: blocking-under-lock the O(G) device merge runs
            # under mutation_lock BY DESIGN (base and view must agree to
            # the row within one statement); scratch reads are
            # store-less, so no fsync hides in here
            self._sync_merge(session, pin, base)

    def _sync_merge(self, session, pin, base) -> None:
        # locklint: blocking-under-lock the O(G) device merge runs under
        # mutation_lock BY DESIGN (base rows and view rows must agree to
        # the row within one statement); scratch reads are
        # store-less, so no fsync hides in here
        with self._lock:
            if self.stale:
                return   # a racing dirtier won: next read re-aggregates
            if pin is not None and base is not None \
                    and hasattr(base.data, "_manifest"):
                # caller holds mutation_lock (durable sessions): no
                # commit is mid journal→apply→fold, so the re-pinned
                # epoch is exactly what the folded state aggregates
                pin.repin(base.data)
            if not self._dirty:
                return
            # locklint: blocking-under-lock finalize reads the partial
            # state through the STORE-LESS scratch session (no journal,
            # no fsync); the device wait is the merge itself
            merged = self.finalize()
            backing = session.catalog.lookup_table(self.name)
            if backing is None:
                return
            cols, masks = [], []
            for c, m, f in zip(merged.columns, merged.nulls,
                               self.output_schema.fields):
                arr = np.asarray(c)
                if f.dtype.name == "string":
                    cols.append(np.asarray(arr, dtype=object))
                elif arr.dtype == object:
                    nm = np.fromiter((v is None for v in arr),
                                     dtype=np.bool_, count=len(arr))
                    cols.append(np.array(
                        [0 if v is None else v for v in arr],
                        dtype=f.dtype.np_dtype))
                    m = nm if m is None else (np.asarray(m) | nm)
                else:
                    cols.append(arr.astype(f.dtype.np_dtype, copy=False))
                masks.append(np.asarray(m, dtype=bool)
                             if m is not None else None)
            backing.data.truncate()
            if merged.num_rows:
                backing.data.insert_arrays(
                    cols, nulls=masks if any(m is not None for m in masks)
                    else None)
            if pin is not None and hasattr(backing.data, "_manifest"):
                # the base was repinned forward above — move the backing
                # with it, or a pin that already read the view (fold →
                # re-read inside one pinned scope) would keep the
                # pre-merge manifest and skew base-vs-view WITHIN the pin
                pin.repin(backing.data)
            self._dirty = False
            global_registry().inc("view_syncs")

    def evict_state(self) -> None:
        """Resource-broker degradation: drop the device/host state and
        fall back to stale (one full re-aggregation at next read)."""
        with self._lock:
            self._reset_state()
            self.stale = True
            self._dirty = True
            self.invalidate_scratch()
            global_registry().inc("view_state_evictions")

    def dispose(self) -> None:
        """DROP MATERIALIZED VIEW: release state + scratch sessions so
        the broker ledger line goes to zero immediately."""
        with self._lock:
            self._reset_state()
            self.stale = True
            self.invalidate_scratch()

    # -- checkpoint / recovery --------------------------------------------

    def state_record(self, base_rows: Optional[int] = None
                     ) -> Tuple[dict, List[Optional[np.ndarray]]]:
        """(header, arrays) for the CRC-framed state checkpoint.  The
        record is written compacted (live groups only).  `base_rows`
        (the base table's live row count at checkpoint time) lets
        recovery detect a base that lost unjournaled rows — the state
        would claim rows the WAL can never replay, so a mismatch
        degrades to STALE instead of wrong answers."""
        with self._lock:
            names, arrays, nulls = self.partial_rows()
            live = self._live_rows()
            seen = [_host(s[:self._g])[live].copy()
                    if s is not None else None for s in self._seen]
            rc = _host(self._rowcount[:self._g])[live].copy()
            header = {
                "kind": "matview_state",
                "name": self.name,
                "base_table": self.base_table,
                "wal_seq": int(self.wal_seq),
                "groups": int(live.size),
                # a checkpoint racing a lock-free refresh persists STALE:
                # folds are diverted to the pending journal right now, so
                # this state image misses them — recovery re-aggregates
                "stale": bool(self.stale or self._refreshing),
                "n_arrays": len(arrays),
            }
            if base_rows is not None:
                header["base_rows"] = int(base_rows)
            # layout: partial arrays, their null masks, seen counts, rc
            return header, list(arrays) + list(nulls) + seen + [rc]

    def load_state(self, header: dict, parts: List[Optional[np.ndarray]]
                   ) -> None:
        """Rebuild the [G] state from a checkpoint record."""
        dev = self.device

        def on_device(a, dtype) -> torch.Tensor:
            return torch.as_tensor(
                np.ascontiguousarray(np.asarray(a).astype(dtype)),
                device=dev)

        with self._lock:
            ng, ns = self._n_groups_cols(), len(self.slot_kinds)
            n_arr = int(header["n_arrays"])
            arrays = parts[:n_arr]
            nulls = parts[n_arr:2 * n_arr]
            seen = parts[2 * n_arr:2 * n_arr + ns]
            rc = parts[2 * n_arr + ns]
            g = int(header["groups"])
            self._reset_state()
            if g:
                self._grow(g)
            self._g = g
            for i in range(ng):
                a = np.asarray(arrays[i])
                if self._keys[i].dtype == object:
                    a = np.asarray(a, dtype=object)
                self._keys[i][:g] = a
                if nulls[i] is not None:
                    self._key_nulls[i][:g] = np.asarray(nulls[i],
                                                        dtype=bool)
            for i in range(ns):
                if g:
                    self._vals[i][:g] = on_device(arrays[ng + i],
                                                  self._acc_dtype(i))
                if self._seen[i] is not None and seen[i] is not None and g:
                    self._seen[i][:g] = on_device(seen[i], np.int64)
            if g and rc is not None:
                self._rowcount[:g] = on_device(rc, np.int64)
            gcols = [self._keys[i][:g] for i in range(ng)]
            gnulls = [self._key_nulls[i][:g]
                      if self._key_nulls[i][:g].any() else None
                      for i in range(ng)]
            self._index = {self._key_tuple(gcols, gnulls, r): r
                           for r in range(g)}
            self.wal_seq = int(header.get("wal_seq", 0))
            self.stale = bool(header.get("stale", False))
            self._dirty = True

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "base_table": self.base_table,
                "sql": self.select_sql,
                "groups": int(self._g),
                "capacity": int(self._cap),
                "slots": list(self.slot_kinds),
                "subtractable": self.subtractable,
                "stale": bool(self.stale),
                "dirty": bool(self._dirty),
                "state_bytes": self.state_nbytes(),
                "wal_seq": int(self.wal_seq),
                "delta_folds": self.folds,
                "rows_folded": self.rows_folded,
                "full_refreshes": self.full_refreshes,
                "stale_marks": self.stale_marks,
            }


# -- session-facing maintenance hooks ------------------------------------


_MANAGED = threading.local()


class managed_base_write:
    """Scope marking a base-table mutation as session-managed (journaled
    + folded by the session / WAL replay).  Data-layer writes OUTSIDE
    this scope bypass both the WAL and the fold hook, so the unmanaged-
    write guard marks dependent views stale instead of letting them
    silently diverge."""

    def __enter__(self):
        _MANAGED.depth = getattr(_MANAGED, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _MANAGED.depth = getattr(_MANAGED, "depth", 1) - 1
        return False


def in_managed_write() -> bool:
    return getattr(_MANAGED, "depth", 0) > 0


def register_unmanaged_write_guard(catalog, info) -> None:
    """Hook the base table's data-layer insert callback so a raw
    `ColumnTableData.insert_arrays` (bench loaders, tests, embedders
    poking the storage layer directly) marks dependent views STALE —
    one re-aggregation at next read — rather than serving rows the
    view never folded.  One guard per data object; it looks views up
    dynamically so DROP needs no deregistration."""
    data = info.data
    if any(getattr(cb, "_mv_guard", False) for cb in data.on_insert):
        return
    ref = weakref.ref(catalog)

    def guard(arrays, nulls=None, _table=info.name):
        if in_managed_write():
            return
        cat = ref()
        if cat is None:
            return
        mvs = matviews_on(cat, _table)
        if mvs:
            global_registry().inc("view_unmanaged_writes")
            for mv in mvs:
                mv.mark_stale("unmanaged direct write to base")

    guard._mv_guard = True
    data.on_insert.append(guard)


def fold_ingest(catalog, table: str, arrays, nulls, sign: int = 1) -> None:
    """Fold one applied ingest delta into every view over `table`."""
    mvs = matviews_on(catalog, table)
    if not mvs:
        return
    info = catalog.lookup_table(_norm(table))
    version = _data_version(info.data) if info is not None else None
    for mv in mvs:
        mv.fold_delta(arrays, nulls, sign=sign, version=version)


def mark_stale(catalog, table: str, reason: str) -> None:
    for mv in matviews_on(catalog, table):
        mv.mark_stale(reason)


def on_truncate(catalog, table: str, wal_seq: int = 0) -> None:
    for mv in matviews_on(catalog, table):
        mv.reset_empty(wal_seq)


def wrap_delete_predicate(catalog, table: str, pred):
    """Wrap a delete predicate to capture the doomed rows' column values
    (+ null masks where the storage exposes them), so subtractable views
    can fold the deleted rows with sign=-1.  Returns (wrapped_pred,
    captured) — captured is None when the table has no views."""
    mvs = matviews_on(catalog, table)
    if not mvs:
        return pred, None
    info = catalog.lookup_table(_norm(table))
    if info is None:
        return pred, None
    names = [f.name for f in info.schema.fields]
    captured: List[Tuple[Dict[str, np.ndarray],
                         Dict[str, Optional[np.ndarray]]]] = []

    def wrapped(cols):
        hit = np.asarray(pred(cols))
        # capture only rows the delete will actually REMOVE: the storage
        # intersects the predicate with its live mask after this returns,
        # so a re-matching predicate (or capacity padding) must not be
        # subtracted from the views a second time
        live_of = getattr(cols, "live_mask", None)
        live = live_of() if live_of is not None else None
        eff = (hit & np.asarray(live)) if live is not None else hit
        if eff.any():
            vals = {c: np.asarray(cols[c])[eff] for c in names}
            mask_of = getattr(cols, "null_mask", None)
            masks = {}
            for c in names:
                m = mask_of(c) if mask_of is not None else None
                masks[c] = np.asarray(m)[eff] if m is not None else None
            captured.append((vals, masks))
        return hit

    return wrapped, captured


def _captured_to_arrays(info, captured):
    """Concatenate per-batch captured {name: values}/{name: mask} pairs
    into full-width delta arrays + null masks."""
    names = [f.name for f in info.schema.fields]
    arrays, nulls = [], []
    for nm in names:
        parts = [c[0][nm] for c in captured]
        arrays.append(np.concatenate(
            [np.asarray(p, dtype=object) if np.asarray(p).dtype == object
             else np.asarray(p) for p in parts]))
        mparts, any_mask = [], False
        for c in captured:
            m = c[1].get(nm)
            n = len(np.asarray(c[0][nm]))
            if m is not None:
                any_mask = True
                mparts.append(np.asarray(m, dtype=bool))
            else:
                mparts.append(np.zeros(n, dtype=bool))
        nulls.append(np.concatenate(mparts) if any_mask else None)
    return arrays, nulls


def fold_deleted(catalog, table: str, captured) -> None:
    """Subtract captured deleted rows from every view over `table` (or
    mark stale when a view has min/max slots)."""
    mvs = matviews_on(catalog, table)
    if not mvs or not captured:
        return
    info = catalog.lookup_table(_norm(table))
    arrays, nulls = _captured_to_arrays(info, captured)
    # the post-apply base version rides along like fold_ingest's: a
    # refresh racing this delete needs it to decide whether its rescan
    # already observed the deletion (replaying it twice would
    # double-subtract)
    version = _data_version(info.data) if info is not None else None
    for mv in mvs:
        if mv.subtractable:
            mv.fold_delta(arrays, nulls, sign=-1, version=version)
        else:
            mv.mark_stale("delete on a min/max view")


def replay_fold(catalog, table: str, arrays, nulls, seq: int) -> None:
    """WAL-replay fold: only records PAST a view's checkpointed
    high-watermark fold (the tail) — records at or below it were folded
    before the state checkpoint was written (no double-fold)."""
    mvs = matviews_on(catalog, table)
    if not mvs:
        return
    reg = global_registry()
    for mv in mvs:
        if mv.stale or seq <= mv.wal_seq:
            continue
        mv.fold_delta(arrays, nulls, sign=1)
        reg.inc("view_replay_folds")


def replay_fold_deleted(catalog, table: str, captured, seq: int) -> None:
    mvs = [mv for mv in matviews_on(catalog, table)
           if not mv.stale and seq > mv.wal_seq]
    if not mvs or not captured:
        return
    info = catalog.lookup_table(_norm(table))
    arrays, nulls = _captured_to_arrays(info, captured)
    reg = global_registry()
    for mv in mvs:
        if mv.subtractable:
            mv.fold_delta(arrays, nulls, sign=-1)
            reg.inc("view_replay_folds")
        else:
            mv.mark_stale("replayed delete on a min/max view")


def view_snapshot(catalog) -> dict:
    """The views' observability payload (the reference's REST
    `/status/api/v1/views` and dashboard section)."""
    c = global_registry().counters_snapshot()
    views = [mv.snapshot() for mv in matviews(catalog).values()]
    return {
        "views": sorted(views, key=lambda v: v["name"]),
        "view_state_bytes": sum(v["state_bytes"] for v in views),
        "view_delta_folds": c.get("view_delta_folds", 0),
        "view_rows_folded": c.get("view_rows_folded", 0),
        "view_subtract_folds": c.get("view_subtract_folds", 0),
        "view_full_refreshes": c.get("view_full_refreshes", 0),
        "view_stale_marks": c.get("view_stale_marks", 0),
        "view_syncs": c.get("view_syncs", 0),
        "view_reads": c.get("view_reads", 0),
        "view_state_regrows": c.get("view_state_regrows", 0),
        "view_fold_errors": c.get("view_fold_errors", 0),
        "view_state_evictions": c.get("view_state_evictions", 0),
        "view_replay_folds": c.get("view_replay_folds", 0),
        "view_unmanaged_writes": c.get("view_unmanaged_writes", 0),
    }


# -- resource-broker ledger hooks ----------------------------------------

_ledgered_catalogs: "weakref.WeakSet" = weakref.WeakSet()


def ledger_catalog(catalog) -> None:
    """Track a catalog whose views count toward the broker ledger."""
    _ledgered_catalogs.add(catalog)


def matview_state_nbytes() -> int:
    """Total live view-state bytes — the broker's ledger line."""
    total = 0
    for cat in list(_ledgered_catalogs):
        for mv in matviews(cat).values():
            try:
                total += mv.state_nbytes()
            except Exception:
                pass
    return total


def evict_all_states() -> int:
    """Degradation ladder hook: drop every view state (stale + refresh
    at next read), like the gidx/join caches.  Returns bytes freed."""
    freed = 0
    for cat in list(_ledgered_catalogs):
        for mv in matviews(cat).values():
            try:
                freed += mv.state_nbytes()
                mv.evict_state()
            except Exception:
                pass
    return freed
