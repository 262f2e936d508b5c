"""Prepared-statement registry: compile-once parameterized plans.

Port of snappydata_tpu/serving/prepared.py.  The reference ships
prepared statements through its thrift/DRDA network layer because
per-query parse+plan dominates short queries (cluster/README-thrift.md;
SnappySession's plan cache keyed on the tokenized plan is the other
half).  A `PreparedPlan` runs the front half of the pipeline ONCE —
parse -> optimize -> analyze -> tokenize -> host-op peel -> (lazily) the
device region's compile — and every execute binds the `?` values as
runtime literals of the already-compiled plan: no re-parse, no
re-tokenization, no plan-cache walk across bind values.

Registry entries are shared across principals and sessions of a catalog
(analysis is user-independent: row-level-security predicates bake in at
resolution, and CREATE / DROP POLICY bumps `catalog.generation`, which
forces a re-prepare).  Entries are LRU-bounded by `serving_max_handles`
and their host bytes ride the resource broker's unified ledger.  Every
execute runs inside its session's device scope.  Grant checks on
prepare and execute, the query log and request tracing come with the
security and observability modules, which the port does not have yet.
"""

from __future__ import annotations

import threading
from snappydata_tpu_torch.utils import locks
import time
import weakref
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.sql import ast


class ServingError(Exception):
    """Statement can't be held by the serving registry (not a query),
    or a prepared execute was malformed (bind arity mismatch, unknown
    EXECUTE name)."""


def _plan_nodes(plan: ast.Plan) -> int:
    """Rough node count (plans + their expressions) for the registry's
    ledger estimate."""
    n = 1
    for e in ast.plan_exprs(plan):
        n += sum(1 for _ in ast.walk(e))
    for k in plan.children():
        n += _plan_nodes(k)
    return n


def _has_window(plan: ast.Plan) -> bool:
    if isinstance(plan, ast.WindowedRelation):
        return True
    for e in ast.plan_exprs(plan):
        for x in ast.walk(e):
            if isinstance(x, (ast.ScalarSubquery, ast.InSubquery,
                              ast.ExistsSubquery)) and _has_window(x.plan):
                return True
    return any(_has_window(k) for k in plan.children())


def _has_subquery(plan: ast.Plan) -> bool:
    for e in ast.plan_exprs(plan):
        for x in ast.walk(e):
            if isinstance(x, (ast.ScalarSubquery, ast.InSubquery,
                              ast.ExistsSubquery)):
                return True
    return any(_has_subquery(k) for k in plan.children())


class PreparedPlan:
    """One registry entry: the prepared (analyzed + tokenized) form of a
    query, shared by every session/principal executing that SQL shape.
    Revalidates itself against `catalog.generation` (DDL, policy and UDF
    changes all bump it)."""

    def __init__(self, session, sql_text: str):
        self.sql = sql_text
        self.catalog = session.catalog
        self._lock = locks.named_lock("serving.plan")
        # per-compiled-plan micro-batch queue lives on the entry so it
        # dies with it (see batcher.BatchQueue)
        self.batch_queue = None
        self._used = False          # first execute is the 'miss' execute
        self.executes = 0
        self._build(session)

    # -- prepare pipeline (runs once; again only on generation change) --

    def _build(self, session) -> None:
        """Run the prepare pipeline and publish the result ATOMICALLY:
        every derived field lands in one `__dict__.update` at the end,
        so (a) a failed build publishes nothing — the stale generation
        makes the next execute retry and re-raise the real error instead
        of running a half-built plan, and (b) an execute racing a
        DDL-triggered rebuild reads either the complete old state or the
        complete new state, never a torn mix (e.g. old tokenized under a
        new core_key, which would poison the plan cache)."""
        from snappydata_tpu_torch.sql.parser import parse

        stmt = parse(self.sql)
        if not isinstance(stmt, ast.Query):
            raise ServingError(
                "only queries can be prepared (PREPARE name AS SELECT ...)")
        st = {
            "stmt": stmt,
            "tokenized": None,
            "lit_params": (),
            "param_count": _count_params(stmt.plan),
            "host_ops": [],
            "core": None,
            "core_key": None,
            "schema": None,
            "_compiled": None,
            "_compiled_gen": -1,
            "_estimate": None,
            "_is_point": False,
            "_batchable": False,
            "_batchable_gen": -1,
            "point_exec": None,
            "generation": self.catalog.generation,
        }
        # shapes the prepared fast path can't serve run the full session
        # pipeline per execute (still a handle: arity checks, governor
        # admission and the registry's observability all apply)
        st["passthrough"] = self._passthrough_reason(session, stmt)
        if st["passthrough"] is not None:
            st["nbytes"] = len(self.sql) * 2 + 512
            self.__dict__.update(st)
            return
        from snappydata_tpu_torch.engine.executor import (_plan_key,
                                                          peel_host_ops)
        from snappydata_tpu_torch.session import _output_schema
        from snappydata_tpu_torch.sql.analyzer import (
            assign_param_positions, tokenize_plan)
        from snappydata_tpu_torch.sql.optimizer import optimize

        plan = optimize(stmt.plan, self.catalog)
        resolved, _ = session.analyzer.analyze_plan(plan)
        if session.conf.tokenize and session.conf.plan_caching:
            st["tokenized"], st["lit_params"] = tokenize_plan(resolved)
        else:
            st["tokenized"], st["lit_params"] = \
                assign_param_positions(resolved, 0), ()
        st["param_count"] = _count_params(st["tokenized"])
        st["schema"] = _output_schema(resolved)
        st["host_ops"], st["core"] = peel_host_ops(st["tokenized"])
        st["core_key"] = _plan_key(st["core"])
        st["nbytes"] = len(self.sql) * 2 \
            + 96 * _plan_nodes(st["tokenized"])
        st["_is_point"] = _is_row_point_shape(st["core"], self.catalog)
        # PK/index point shapes pre-extract the probe ONCE: the engine's
        # per-execute _try_point_lookup walks the AST and rebuilds the
        # projection metadata on every call — measurable on the serving
        # profile at thousands of lookups per second
        if st["_is_point"] and not st["host_ops"]:
            st["point_exec"] = _build_point_exec(st["core"], self.catalog)
        self.__dict__.update(st)

    def _passthrough_reason(self, session, stmt) -> Optional[str]:
        if stmt.with_error is not None:
            return "error_clause"       # AQP estimation surface
        if _has_window(stmt.plan):
            return "stream_window"      # cutoff literal computed per read
        if _has_subquery(stmt.plan):
            return "subquery"           # rewritten per execution
        if _count_params(stmt.plan) == 0:
            # a 0-param prepared BIG aggregate must keep the tiled-scan
            # path (it only engages without user params)
            try:
                if session._tile_budget() > 0 and \
                        session._tilable_agg_shape(stmt.plan) is not None:
                    return "tiled_scan"
            except Exception:
                return "tiled_scan"
        return None

    # -- execute-time helpers -------------------------------------------

    def revalidate(self, session) -> None:
        """Re-prepare when DDL/policies/UDFs changed the catalog since
        this entry was built (generation bump)."""
        if self.generation == self.catalog.generation:
            return
        with self._lock:
            if self.generation != self.catalog.generation:
                self._build(session)
                global_registry().inc("serving_reprepares")

    def compiled_for(self, session):
        """The core node's CompiledPlan (None when it has no device
        lowering) — resolved through the executor's plan cache once per
        generation, then pinned here so fused dispatches skip even the
        cache lookup."""
        gen = self.catalog.generation
        if self._compiled_gen != gen:
            with self._lock:
                if self._compiled_gen != gen:
                    self._compiled = session.executor.compiled_core(
                        self.core, self.core_key)
                    self._compiled_gen = gen
        return self._compiled

    def estimate_bytes(self, session) -> int:
        if self._estimate is None:
            from snappydata_tpu_torch import resource

            try:
                self._estimate = resource.estimate_statement_bytes(
                    self.catalog, self.stmt)
            except Exception:
                self._estimate = 0
        return self._estimate

    def batchable(self, session) -> bool:
        """Fusable into a multi-request fused dispatch: has runtime
        params, compiles to a device region, and isn't a row-table
        point-lookup shape (index probes are O(1) on host already).
        Cached per generation — this sits on the per-execute path."""
        if self._batchable_gen == self.catalog.generation:
            return self._batchable
        if self.passthrough is not None or self.param_count == 0 \
                or self._is_point:
            self._batchable = False
        else:
            self._batchable = self.compiled_for(session) is not None
        self._batchable_gen = self.catalog.generation
        return self._batchable

    def assemble_batched(self, session, outs, tables, index: int,
                         params: Tuple):
        """Slice request `index` out of a fused dispatch's host outputs
        and run it through assemble + this plan's host post-ops.  Returns
        None when that request overflowed its bounds (the caller reroutes
        it through the engine's normal path, which takes the documented
        loud fallback)."""
        mask, pairs, overflow = outs
        if bool(overflow[index]):
            return None
        compiled = self._compiled
        result = compiled._assemble(
            mask[index], [(v[index], nl[index] if nl is not None else None)
                          for v, nl in pairs])
        for op in reversed(self.host_ops):
            result = session.executor._apply_host_op(op, result, params)
        return result


def _count_params(plan: ast.Plan) -> int:
    n = 0
    for e in ast.plan_exprs(plan):
        for x in ast.walk(e):
            if isinstance(x, ast.Param):
                n += 1
            elif isinstance(x, (ast.ScalarSubquery, ast.InSubquery,
                                ast.ExistsSubquery)) \
                    and x.plan is not None:
                # '?' inside subqueries count toward bind arity too —
                # expr walks don't descend into nested plans
                n += _count_params(x.plan)
    for k in plan.children():
        n += _count_params(k)
    return n


def _build_point_exec(core, catalog):
    """Pre-extract a row-table point probe from a Project?/Filter/
    Relation core whose conjuncts are all `col = Lit|ParamLiteral|Param`:
    returns probe(params) -> Result | None (None = shape needs the
    engine after all — e.g. no usable index, contradictory binds get the
    engine's own semantics).  Everything _try_point_lookup derives per
    call (conjunct walk, projection ordinals, dtypes) is resolved HERE,
    once, at prepare time."""
    import numpy as np

    from snappydata_tpu_torch.engine.result import Result
    from snappydata_tpu_torch.sql.analyzer import _expr_name

    node = core
    proj = None
    if isinstance(node, ast.Project):
        proj, node = node, node.child
    while isinstance(node, ast.SubqueryAlias):
        node = node.child
    if not isinstance(node, ast.Filter):
        return None
    rel = node.child
    while isinstance(rel, ast.SubqueryAlias):
        rel = rel.child
    if not isinstance(rel, ast.Relation):
        return None
    info = catalog.lookup_table(rel.name)
    if info is None:
        return None

    getters: dict = {}      # col name -> [value getter per conjunct]

    def flatten(e) -> bool:
        if isinstance(e, ast.BinOp) and e.op == "and":
            return flatten(e.left) and flatten(e.right)
        if isinstance(e, ast.BinOp) and e.op == "=" \
                and isinstance(e.left, ast.Col) \
                and isinstance(e.right, (ast.Lit, ast.ParamLiteral,
                                         ast.Param)):
            g = (lambda p, v=e.right.value: v) \
                if isinstance(e.right, ast.Lit) \
                else (lambda p, i=e.right.pos: p[i])
            getters.setdefault(e.left.name.lower(), []).append(g)
            return True
        return False

    if not flatten(node.condition):
        return None
    if proj is not None and not all(
            isinstance(e.child if isinstance(e, ast.Alias) else e, ast.Col)
            for e in proj.exprs):
        return None
    schema = info.schema
    if proj is not None:
        names = [_expr_name(e) for e in proj.exprs]
        idxs = [(e.child if isinstance(e, ast.Alias) else e).index
                for e in proj.exprs]
        dtypes = [schema.fields[i].dtype for i in idxs]
    else:
        names = schema.names()
        idxs = list(range(len(schema.fields)))
        dtypes = [f.dtype for f in schema.fields]
    key_set = frozenset(getters)
    pk = bool(info.key_columns) and key_set == frozenset(info.key_columns)
    sorted_cols = sorted(key_set)

    def probe(params):
        from snappydata_tpu_torch.observability.metrics import global_registry

        vals = {}
        for name, gs in getters.items():
            v = gs[0](params)
            for g in gs[1:]:
                if g(params) != v:
                    return None     # contradictory k=1 AND k=2: engine
            vals[name] = v
        data = info.data
        if pk:
            got = data.get(tuple(vals[k] for k in info.key_columns))
            rows = [got] if got is not None else []
        else:
            # index existence re-checked per probe: CREATE INDEX does
            # not bump the catalog generation
            idx = data.index_for_columns(sorted_cols)
            if idx is None:
                return None
            rows = data.index_lookup(
                idx, tuple(vals[c] for c in data._indexes[idx]))
        global_registry().inc("point_lookups")
        cols, nulls = [], []
        for j, dt in zip(idxs, dtypes):
            cell = [r[j] for r in rows]
            nmask = np.array([v is None for v in cell]) if cell else None
            if dt.name == "string":
                cols.append(np.array(cell, dtype=object))
            else:
                cols.append(np.array(
                    [0 if v is None else v for v in cell],
                    dtype=dt.np_dtype))
            nulls.append(nmask if nmask is not None and nmask.any()
                         else None)
        return Result(names, cols, nulls, dtypes)

    return probe


def _is_row_point_shape(core, catalog) -> bool:
    """Project?/Filter/Relation over a ROW table — the shape
    executor._try_point_lookup answers from the PK/secondary index
    without entering the device engine."""
    from snappydata_tpu_torch.storage.table_store import RowTableData

    node = core
    if isinstance(node, ast.Project):
        node = node.child
    while isinstance(node, ast.SubqueryAlias):
        node = node.child
    if isinstance(node, ast.Filter):
        node = node.child
    while isinstance(node, ast.SubqueryAlias):
        node = node.child
    if not isinstance(node, ast.Relation):
        return False
    info = catalog.lookup_table(node.name)
    return info is not None and isinstance(info.data, RowTableData)


class PreparedStatement:
    """Per-session façade over a shared PreparedPlan: `execute(binds)`
    runs with THIS session's principal (governor context) and device
    while the compiled plan is shared."""

    def __init__(self, session, entry: PreparedPlan):
        self._session = session
        self._entry = entry

    @property
    def sql(self) -> str:
        return self._entry.sql

    @property
    def param_count(self) -> int:
        return self._entry.param_count

    @property
    def schema(self):
        if self._entry.schema is None:       # passthrough shapes
            return self._session.query_schema(self._entry.sql)
        return self._entry.schema

    def warm_batches(self, params: Sequence,
                     sizes: Optional[Sequence[int]] = None) -> int:
        """Prime the fused-dispatch variants an N-client serving load
        will hit (inference-server warmup): one per padded batch-size
        bucket up to serving_batch_max.  The reference compiles one
        vmapped program per bucket; a fused dispatch here compiles
        nothing, so each bucket's variant is primed by one request run
        under that bucket's key.  Returns how many variants were
        primed."""
        from snappydata_tpu_torch.serving.batcher import bucket_ladder

        entry, sess = self._entry, self._session
        with config.device_scope(sess.device):
            entry.revalidate(sess)
            if not entry.batchable(sess):
                return 0
            full = entry.lit_params + tuple(params)
            compiled = entry.compiled_for(sess)
            done = 0
            for b in (sizes or bucket_ladder(
                    int(sess.conf.serving_batch_max or 1))):
                tables, outs = compiled.execute_batched(
                    [full], sess.device, bucket=b)
                entry.assemble_batched(sess, outs, tables, 0, full)
                done += 1
            return done

    def execute(self, params: Sequence = (), query_ctx=None):
        """Run with the given bind values.  Admission (fair-share per
        principal), statement timeouts and CANCEL all apply per request,
        exactly as for session.sql — including inside a fused batch."""
        with config.device_scope(self._session.device):
            return self._execute_governed(params, query_ctx)

    def _execute_governed(self, params: Sequence = (), query_ctx=None):
        from snappydata_tpu_torch import resource

        entry, sess = self._entry, self._session
        if len(params) != entry.param_count:
            raise ServingError(
                f"prepared statement expects {entry.param_count} "
                f"parameter(s), got {len(params)}")
        if resource.current_query() is not None:
            return self._execute_inner(tuple(params),
                                       resource.current_query())
        broker = resource.global_broker()
        ctx = query_ctx or resource.new_query(entry.sql, sess.user)
        if not ctx.sql:
            ctx.sql = entry.sql
        estimate = entry.estimate_bytes(sess) \
            if broker.accounting_enabled() else 0
        try:
            broker.admit(ctx, estimate,
                         float(sess.conf.query_timeout_s or 0.0))
            with resource.query_scope(ctx):
                return self._execute_inner(tuple(params), ctx)
        finally:
            broker.release(ctx)

    def _execute_inner(self, params: Tuple, ctx):
        from snappydata_tpu_torch.engine.result import finalize_decimals

        entry, sess = self._entry, self._session
        reg = global_registry()
        entry.revalidate(sess)
        if entry._used:
            reg.inc("serving_prepared_hits")
        else:
            entry._used = True
        entry.executes += 1
        if entry.passthrough is not None:
            # the full session pipeline (subqueries, windows, AQP,
            # tiling); already inside the governor scope, so this does not
            # re-admit
            reg.inc("serving_passthrough")
            return finalize_decimals(
                sess.execute_statement(entry.stmt, params))
        if getattr(sess.catalog, "_sample_maintainers", None):
            # AQP samples registered AFTER prepare: the error-surface
            # check lives in execute_statement
            reg.inc("serving_passthrough")
            return finalize_decimals(
                sess.execute_statement(entry.stmt, params))
        if getattr(sess.catalog, "_matviews", None):
            sess._sync_referenced_matviews(entry.tokenized)
        full = entry.lit_params + params
        if getattr(sess.catalog, "_functions", None):
            from snappydata_tpu_torch.sql import udf as _udf

            with _udf.using(sess.catalog):
                result = self._dispatch(full, ctx)
        else:
            result = self._dispatch(full, ctx)
        return finalize_decimals(result)

    def _dispatch(self, full: Tuple, ctx):
        entry, sess = self._entry, self._session
        if entry.point_exec is not None:
            # prepare-time-extracted PK / index probe: no AST walk, no
            # device work, no transfer — the O(1) serving fast lane
            result = entry.point_exec(full)
            if result is not None:
                # keep the engine's counters honest: this lane bypasses
                # executor.execute entirely
                reg = global_registry()
                reg.inc("queries")
                reg.inc("rows_returned", result.num_rows)
                return result
        props = sess.conf
        if int(props.serving_batch_max or 1) > 1 and entry.batchable(sess):
            from snappydata_tpu_torch.serving.batcher import global_batcher

            return global_batcher().submit(entry, sess, full, ctx)
        # straight path: the executor keeps its point-lookup / index fast
        # lane and all engine counters; the prepared core key skips the
        # per-execute plan-repr walk
        return sess.executor.execute(entry.tokenized, full,
                                     plan_key=entry.core_key)


class ServingRegistry:
    """Per-catalog LRU of PreparedPlans, shared by every session of that
    catalog (network front doors prepare under per-request principals
    and still hit one entry)."""

    def __init__(self, catalog):
        self.catalog = catalog
        self._lock = locks.named_lock("serving.registry")
        self._entries: "OrderedDict[str, PreparedPlan]" = OrderedDict()
        _REGISTRIES.add(self)

    @staticmethod
    def _key(sql_text: str) -> str:
        return " ".join(sql_text.split())

    def prepare(self, session, sql_text: str) -> PreparedStatement:
        key = self._key(sql_text)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is None:
            entry = PreparedPlan(session, sql_text)   # may raise
            reg = global_registry()
            reg.inc("serving_prepared_misses")
            with self._lock:
                cur = self._entries.get(key)
                if cur is not None:         # lost a build race: keep theirs
                    entry = cur
                    self._entries.move_to_end(key)
                else:
                    cap = max(1, int(config.global_properties()
                                     .serving_max_handles or 1))
                    while len(self._entries) >= cap:
                        self._entries.popitem(last=False)
                        reg.inc("serving_handle_evictions")
                    self._entries[key] = entry
        return PreparedStatement(session, entry)

    def peek(self, session, sql_text: str) -> Optional[PreparedStatement]:
        """Existing entry or None — NEVER builds/registers.  Metadata
        surfaces (FlightSQL GetFlightInfo) use this so ad-hoc one-shot
        SQL texts don't churn real prepared handles out of the LRU."""
        with self._lock:
            entry = self._entries.get(self._key(sql_text))
        return PreparedStatement(session, entry) \
            if entry is not None else None

    def deallocate(self, sql_text: str) -> bool:
        with self._lock:
            return self._entries.pop(self._key(sql_text), None) is not None

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def nbytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def describe(self) -> list:
        with self._lock:
            entries = list(self._entries.values())
        return [{
            "sql": e.sql[:120],
            "params": e.param_count,
            "executes": e.executes,
            "passthrough": e.passthrough,
            "nbytes": e.nbytes,
        } for e in entries]


# every live registry, for the broker's unified ledger
_REGISTRIES: "weakref.WeakSet" = weakref.WeakSet()
_REG_LOCK = locks.named_lock("serving.registry_global")


def registry_for(catalog) -> ServingRegistry:
    reg = getattr(catalog, "_serving_registry", None)
    if reg is None:
        with _REG_LOCK:
            reg = getattr(catalog, "_serving_registry", None)
            if reg is None:
                reg = catalog._serving_registry = ServingRegistry(catalog)
    return reg


def serving_registry_nbytes() -> int:
    """Host bytes pinned by prepared-plan registries — one line of the
    resource broker's unified ledger."""
    return sum(r.nbytes() for r in list(_REGISTRIES))
