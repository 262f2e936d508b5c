"""SnappySession — the user entry point of the PyTorch port.

Port of snappydata_tpu/session.py, cut to the analytic store: `sql()`
for CREATE TABLE ... USING column | row, INSERT / PUT INTO ... VALUES /
SELECT, UPDATE, DELETE, ALTER TABLE ADD / DROP COLUMN, DROP, TRUNCATE,
SHOW / DESCRIBE, SET and queries; `insert` / `insert_arrays` for bulk
ingest and `put` / `update` / `delete` / `get` for point operations.
Every statement whose reads are scan-shaped pins ONE snapshot epoch for
its whole run (`execute_statement`, storage/mvcc.py): the device bind,
the host fallback, join key encodes, subquery rewrites, CTAS sources and
the tiled pass with its prefetch worker all read the pinned manifest.  A query runs parse -> optimize -> analyze -> tokenize
literals -> executor (ref: SnappySession.sqlPlan:2571).  Subqueries
rewrite first, as in the reference: correlated [NOT] EXISTS / IN become
semi / anti joins and a correlated scalar aggregate a join on its grouped
result (`_decorrelate`); an uncorrelated subquery runs as a query of its
own and substitutes literals (`_rewrite_subqueries`).  An aggregate over
a column table whose used columns exceed `scan_tile_bytes` streams
through the device in tiles (`_maybe_tiled_aggregate`, ref
snappydata_tpu/session.py:1329): one compiled partial program per tile,
the [G] partials merged on the device where the group space is
tile-aligned, a double-buffered prefetcher warming the next tile's
plates.  ARRAY / MAP / STRUCT columns insert through `array()` /
`map()` / `named_struct()` literals and object cells.

With `data_dir` a session is durable (storage/persistence.py): DDL and DML
statements are journaled to the store's WAL before they apply and acked
after the covering fsync (`_sql_statement`), the bulk paths journal their
arrays (`_journal_then`), `checkpoint()` folds the WAL into batch files,
and a session opened on an existing directory recovers into itself, on
its device.  Mesh execution, views, samples and streams are not ported
and raise NotImplementedError; UPDATE / DELETE / PUT leave out the
reference's materialized-view maintenance hooks with the views.

A session runs on one torch device: `cuda` unless the caller asks for
another (`SnappySession(device="cpu")`).  Without a GPU, a session that
did not ask for the CPU raises instead of moving there silently.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.engine import hosteval
from snappydata_tpu_torch.engine.executor import (Executor,
                                                  merge_tile_outs)
from snappydata_tpu_torch.engine.exprs import CompileError
from snappydata_tpu_torch.engine.partial_agg import (NotDecomposableError,
                                                     decompose_aggregate,
                                                     ddl_type)
from snappydata_tpu_torch.engine.result import (Result, empty_result,
                                                finalize_decimals,
                                                to_host_domain)
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.sql.analyzer import (Analyzer, AnalysisError,
                                               Scope, ScopeEntry,
                                               _expr_name,
                                               assign_param_positions,
                                               fold_constants,
                                               tokenize_plan)
from snappydata_tpu_torch.sql.optimizer import optimize
from snappydata_tpu_torch.sql.parser import parse
from snappydata_tpu_torch.sql.render import (RenderError, render_expr,
                                             render_plan)
from snappydata_tpu_torch.storage import mvcc
from snappydata_tpu_torch.storage.device import (scan_unit_count,
                                                 scan_window)
from snappydata_tpu_torch.storage.prefetch import TilePrefetcher
from snappydata_tpu_torch.storage.table_store import (ColumnTableData,
                                                      RowTableData)
from snappydata_tpu_torch.utils import locks


def resolve_device(device=None) -> torch.device:
    """The session's torch device: `cuda` by default; raises when CUDA is
    absent and the caller did not ask for the CPU."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "session on the CPU")
    return dev


class SnappySession:
    """One user session.  Sessions share a process-local default catalog
    unless one is passed, mirroring embedded mode."""

    _default_catalog: Optional[Catalog] = None
    _default_lock = locks.named_lock("session.default_registry")

    def __init__(self, catalog: Optional[Catalog] = None, conf=None,
                 device=None, data_dir: Optional[str] = None,
                 recover: bool = True):
        """`data_dir` attaches a DiskStore (ref: sys-disk-dir): DML becomes
        WAL-durable, `checkpoint()` persists batches and manifests, and
        with `recover` (and no `catalog`) the catalog and data are rebuilt
        from the directory into this session."""
        self.device = resolve_device(device)
        self.disk_store = None
        needs_recovery = False
        if data_dir is not None:
            from snappydata_tpu_torch.storage.persistence import DiskStore

            self.disk_store = DiskStore(data_dir)
            if catalog is None and recover:
                # recovery replays against THIS session; the placeholder
                # catalog is swapped for the recovered one
                needs_recovery = True
                catalog = Catalog()
        if catalog is None:
            with SnappySession._default_lock:
                if SnappySession._default_catalog is None:
                    SnappySession._default_catalog = Catalog()
                catalog = SnappySession._default_catalog
        self.catalog = catalog
        self.conf = conf or config.global_properties()
        self.analyzer = Analyzer(catalog)
        self.executor = Executor(catalog, self.conf, self.device)
        # tiled scans: pooled scratch merge sessions keyed by the partial
        # schema, and the guard that keeps a tile pass from re-entering
        # itself (scratch merges, per-tile SQL)
        self._tile_merge_pool: Dict[str, list] = {}
        self._in_tile = False
        self._device_bytes: Optional[int] = None
        if needs_recovery:
            self.disk_store.recover_catalog(self)

    def checkpoint(self) -> None:
        """Persist every table and the catalog to the attached disk store
        and fold the WAL (ref: disk-store flush / backup base image)."""
        if self.disk_store is None:
            raise ValueError("no data_dir configured on this session")
        with config.device_scope(self.device):
            self.disk_store.checkpoint(self.catalog)

    def sql(self, sql_text: str, params: Sequence[Any] = ()) -> Result:
        # storage encodes DOUBLE at the device width and the expression
        # lowering picks float widths from the device: every statement
        # runs inside the session's device scope
        with config.device_scope(self.device):
            return self._sql_statement(parse(sql_text), sql_text,
                                       tuple(params))

    def _sql_statement(self, stmt: ast.Statement, sql_text: str,
                       params) -> Result:
        """Durable sessions journal DML and ALTER / TRUNCATE text BEFORE
        applying (under the store's mutation lock, shared with
        checkpoints: the on-disk log always covers memory) and ack after
        the covering group fsync; CREATE / DROP TABLE persist the catalog
        after they apply (ref snappydata_tpu/session.py `_sql_statement`)."""
        ds = self.disk_store
        if ds is not None and isinstance(
                stmt, (ast.InsertInto, ast.UpdateStmt, ast.DeleteStmt,
                       ast.TruncateTable, ast.AlterTable)):
            import contextlib

            from snappydata_tpu_torch.catalog.catalog import _norm
            from snappydata_tpu_torch.reliability import current_stmt_id

            ddl_gate = contextlib.nullcontext()
            if isinstance(stmt, ast.AlterTable) and not stmt.add:
                # DROP COLUMN against a pinned snapshot raises 40001: the
                # gate is entered BEFORE journaling (the WAL must never
                # hold a statement that did not apply) and held across
                # journal and apply
                info = self.catalog.lookup_table(stmt.table)
                if info is not None:
                    ddl_gate = mvcc.ddl_scope(info.data,
                                              "ALTER TABLE DROP COLUMN")
            table = getattr(stmt, "table", None) or stmt.name
            # a client-stamped statement id rides the record header, so
            # replay re-seeds the mutation dedup window
            sid = current_stmt_id()
            with ddl_gate, ds.mutation_lock:
                seq = ds.wal_append(_norm(table), "sql", sql=sql_text,
                                    params=tuple(params),
                                    extra={"stmt_id": sid} if sid else None)
                # the WAL seq IS the commit timestamp: manifests this
                # statement publishes carry it
                with mvcc.commit_scope(seq):
                    result = self.execute_statement(stmt, tuple(params))
            # the ack waits for the covering fsync OUTSIDE the mutation
            # lock, so concurrent committers coalesce into one group
            ds.wal_sync(seq)
            return result
        result = self.execute_statement(stmt, tuple(params))
        if ds is not None:
            from snappydata_tpu_torch.catalog.catalog import _norm

            if isinstance(stmt, ast.CreateTable):
                ds.save_catalog(self.catalog)
                if stmt.as_select is not None:
                    # CTAS rows exist only in memory (they were never
                    # journaled): checkpoint the new table now
                    info = self.catalog.lookup_table(stmt.name)
                    if info is not None:
                        with ds.mutation_lock:
                            ds.checkpoint_table(info, ds.current_wal_seq())
            elif isinstance(stmt, ast.DropTable):
                ds.drop_table_dir(_norm(stmt.name))
                ds.save_catalog(self.catalog)
        return result

    def _snapshot_tables_for(self, stmt: ast.Statement):
        """Tables a statement's READS pin at one consistent epoch: the
        query plan's relations, a CTAS or INSERT ... SELECT source, and
        UPDATE / DELETE WHERE-subquery relations.  None = the statement
        has no snapshot-shaped reads."""
        if isinstance(stmt, ast.Query):
            return _referenced_tables(stmt.plan)
        if isinstance(stmt, ast.CreateTable) and stmt.as_select is not None:
            return _referenced_tables(stmt.as_select)
        if isinstance(stmt, ast.InsertInto) \
                and not isinstance(stmt.source, ast.Values):
            return _referenced_tables(stmt.source) or None
        if isinstance(stmt, ast.UpdateStmt):
            names = []
            for e in [stmt.where] + [x for _, x in stmt.assignments]:
                if e is not None:
                    names.extend(_expr_subquery_tables(e))
            return names or None
        if isinstance(stmt, ast.DeleteStmt) and stmt.where is not None:
            return _expr_subquery_tables(stmt.where) or None
        return None

    def execute_statement(self, stmt: ast.Statement, user_params=()
                          ) -> Result:
        """Statement entry: reads pin ONE snapshot epoch for the whole
        statement (subquery rewrites, tile passes and host fallbacks all
        traverse it), so a long scan and concurrent ingest never block
        each other and never mix table versions.  Nested executions find
        the ambient pin and extend it."""
        names = self._snapshot_tables_for(stmt)
        if names is not None and mvcc.current_pin() is None:
            with mvcc.pinned_scope(self.catalog, names):
                return self._execute_statement(stmt, user_params)
        return self._execute_statement(stmt, user_params)

    def _execute_statement(self, stmt: ast.Statement, params) -> Result:
        if isinstance(stmt, ast.Query):
            if stmt.with_error is not None:
                raise NotImplementedError(
                    "WITH ERROR (approximate queries) is not ported")
            return finalize_decimals(self._run_query(stmt.plan, params))
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, ast.DropTable):
            self.catalog.drop_table(stmt.name, stmt.if_exists)
            return _status()
        if isinstance(stmt, ast.TruncateTable):
            self.catalog.describe(stmt.name).data.truncate()
            return _status()
        if isinstance(stmt, ast.InsertInto):
            return _count_result(self._insert(stmt, params))
        if isinstance(stmt, ast.UpdateStmt):
            return _count_result(self._update(stmt, params))
        if isinstance(stmt, ast.DeleteStmt):
            return _count_result(self._delete(stmt, params))
        if isinstance(stmt, ast.AlterTable):
            return self._alter_table(stmt)
        if isinstance(stmt, ast.ShowTables):
            infos = self.catalog.list_tables()
            return Result(
                ["tableName", "provider", "rowCount"],
                [np.array([i.name for i in infos], dtype=object),
                 np.array([i.provider for i in infos], dtype=object),
                 np.array([_row_count(i) for i in infos],
                          dtype=np.int64)],
                [None, None, None], [T.STRING, T.STRING, T.LONG])
        if isinstance(stmt, ast.DescribeTable):
            fields = self.catalog.describe(stmt.name).schema.fields
            return Result(
                ["col_name", "data_type", "nullable"],
                [np.array([f.name for f in fields], dtype=object),
                 np.array([str(f.dtype) for f in fields], dtype=object),
                 np.array([f.nullable for f in fields])],
                [None, None, None], [T.STRING, T.STRING, T.BOOLEAN])
        if isinstance(stmt, ast.SetConf):
            self.conf.set(stmt.key, stmt.value)
            return _status()
        raise NotImplementedError(
            f"{type(stmt).__name__} is not ported to snappydata_tpu_torch")

    def _run_query(self, plan: ast.Plan, user_params=()) -> Result:
        """Query entry (ref SnappySession._run_query_inner, without the
        mesh, UDF, sample and stream hooks): the tiled lane first (a plan
        that holds a subquery never tiles), then the correlated
        subqueries become joins, the uncorrelated ones run as queries of
        their own and substitute literals, then optimize, analyze and
        tokenize."""
        tiled = self._maybe_tiled_aggregate(plan, user_params)
        if tiled is not None:
            return tiled
        plan = self._decorrelate(plan)
        plan = self._rewrite_subqueries(plan, user_params)
        plan = optimize(plan, self.catalog)
        resolved, _ = self.analyzer.analyze_plan(plan)
        if self.conf.tokenize and self.conf.plan_caching:
            tokenized, lit_params = tokenize_plan(resolved)
        else:
            tokenized, lit_params = assign_param_positions(resolved, 0), ()
        return self.executor.execute(tokenized,
                                     tuple(lit_params) + tuple(user_params))

    def _decorrelate(self, plan: ast.Plan) -> ast.Plan:
        """Rewrite correlated [NOT] EXISTS filters into semi/anti joins —
        the classic decorrelation for the TPC-H Q4/Q21/Q22 pattern
        (ref: Catalyst RewritePredicateSubquery does the same):

          Filter(child, EXISTS(SELECT ... FROM inner WHERE inner.a =
          outer.b AND <inner-only preds>))
            → Join(child, Filter(inner, preds), 'semi', a = b)

        Only the single-block shape with conjunctive predicates is
        handled; anything else keeps its (clear) unsupported error."""

        def split_correlation(subplan, outer_names, want_select=False):
            """If subplan is SELECT ... FROM <rel chain> WHERE <conj>,
            split conjuncts into correlation equalities (inner_col =
            outer_col) and inner-only predicates. With `want_select`, also
            return the projected select expressions (for IN rewrites)."""
            node = subplan
            select_exprs = None
            # strip projection-only tops (SELECT 1 / SELECT cols)
            while isinstance(node, (ast.Project, ast.SubqueryAlias,
                                    ast.Distinct)):
                if isinstance(node, ast.Project) and select_exprs is None:
                    select_exprs = node.exprs
                node = node.children()[0]
            if not isinstance(node, ast.Filter):
                return None
            inner_rel = node.child
            conjuncts: List[ast.Expr] = []

            def flat(e):
                if isinstance(e, ast.BinOp) and e.op == "and":
                    flat(e.left)
                    flat(e.right)
                else:
                    conjuncts.append(e)

            flat(node.condition)

            inner_cols = _relation_columns(inner_rel, self.catalog)

            def col_side(c):
                """'outer' if the Col can only resolve in the outer scope,
                'inner' if in the subquery's own relations."""
                if c.qualifier:
                    # a qualifier names its scope unambiguously (covers
                    # self-join correlation t2.a = t.a on the same table)
                    return "inner" if c.qualifier.lower() in inner_cols[1] \
                        else "outer"
                return "inner" if c.name.lower() in inner_cols[0] \
                    else "outer"

            corr = []
            inner_only = []
            corr_residual = []
            for c in conjuncts:
                if isinstance(c, ast.BinOp) and c.op == "=" \
                        and isinstance(c.left, ast.Col) \
                        and isinstance(c.right, ast.Col):
                    sides = (col_side(c.left), col_side(c.right))
                    if sides == ("inner", "outer"):
                        corr.append((c.right, c.left))
                        continue
                    if sides == ("outer", "inner"):
                        corr.append((c.left, c.right))
                        continue
                has_outer = any(
                    isinstance(x, ast.Col) and col_side(x) == "outer"
                    for x in ast.walk(c))
                if has_outer:
                    # non-equi correlation (Q21's l2.suppkey <> l1.suppkey)
                    # rides as a residual on the decorrelated join
                    corr_residual.append(c)
                    continue
                inner_only.append(c)
            if not corr and not corr_residual:
                return None   # uncorrelated: not this rewrite's job
            if want_select:
                return inner_rel, corr, inner_only, select_exprs, \
                    corr_residual
            return inner_rel, corr, inner_only, corr_residual

        def split_scalar_agg(subplan):
            """Correlated scalar aggregate subquery → pieces for the
            aggregate-then-join rewrite (TPC-H Q2/Q17/Q20 shape):

              (SELECT <expr over AGG(inner cols)> FROM inner
               WHERE inner.k = outer.k AND <inner preds>)

            Returns (inner_rel, corr, inner_only, select_expr) or None."""
            node = subplan
            while isinstance(node, ast.SubqueryAlias):
                node = node.child
            if not isinstance(node, ast.Aggregate) or node.group_exprs \
                    or len(node.agg_exprs) != 1:
                return None
            sel = node.agg_exprs[0]
            if isinstance(sel, ast.Alias):
                sel = sel.child
            aggs = [x for x in ast.walk(sel)
                    if isinstance(x, ast.Func) and x.name in ast.AGG_FUNCS]
            # empty-group semantics: sum/avg/min/max yield NULL (the inner
            # join's dropped row ≡ comparison-with-NULL = false); count
            # yields 0, which needs a LEFT join + coalesce(__sv, 0) so
            # outer rows with no inner match still compare against 0
            if not aggs or any(a.name not in ("sum", "avg", "min", "max",
                                              "count") for a in aggs):
                return None
            needs_left = any(a.name == "count" for a in aggs)
            inner = node.child
            if not isinstance(inner, ast.Filter):
                return None
            got = split_correlation(inner, None)
            if got is None or got[3] or not got[1]:
                return None  # non-equi correlation: can't group-then-join
            inner_rel, corr, inner_only, _res = got
            # every column in the select must belong to the inner scope
            inner_cols = _relation_columns(inner_rel, self.catalog)
            for x in ast.walk(sel):
                if isinstance(x, ast.Col):
                    in_inner = (x.qualifier.lower() in inner_cols[1]
                                if x.qualifier
                                else x.name.lower() in inner_cols[0])
                    if not in_inner:
                        return None
            return inner_rel, corr, inner_only, sel, needs_left

        sq_counter = itertools.count()

        def _and_all(exprs):
            cond = exprs[0]
            for x in exprs[1:]:
                cond = ast.BinOp("and", cond, x)
            return cond

        def rewrite_filter(p: ast.Plan) -> ast.Plan:
            if not isinstance(p, ast.Filter):
                return p
            conjuncts: List[ast.Expr] = []

            def flat(e):
                if isinstance(e, ast.BinOp) and e.op == "and":
                    flat(e.left)
                    flat(e.right)
                else:
                    conjuncts.append(e)

            flat(p.condition)
            child = p.child
            rest: List[ast.Expr] = []    # untouched conjuncts (stay BELOW)
            post: List[ast.Expr] = []    # rewritten comparisons (go ABOVE)
            join_specs: List[tuple] = []  # (inner_rel, how, cond)
            changed = False
            for c in conjuncts:
                negated = False
                e = c
                if isinstance(e, ast.UnaryOp) and e.op == "not" \
                        and isinstance(e.child, ast.ExistsSubquery):
                    negated, e = True, e.child
                if isinstance(e, ast.ExistsSubquery):
                    got = split_correlation(e.plan, None)
                    if got is not None:
                        inner_rel, corr, inner_only, corr_res = got
                        if inner_only:
                            inner_rel = ast.Filter(inner_rel,
                                                   _and_all(inner_only))
                        join_cond = _and_all(
                            [ast.BinOp("=", oc, ic) for oc, ic in corr]
                            + corr_res)
                        join_specs.append(
                            (inner_rel, "anti" if negated else "semi",
                             join_cond))
                        changed = True
                        continue
                # correlated scalar aggregate in a comparison →
                # aggregate-then-join (ref: Catalyst's scalar-subquery
                # decorrelation; unlocks TPC-H Q2/Q17/Q20)
                if isinstance(e, ast.BinOp) and e.op in (
                        "<", "<=", ">", ">=", "=", "<>", "!="):
                    done = False
                    for side in ("left", "right"):
                        side_expr = getattr(e, side)
                        # the subquery may sit INSIDE arithmetic on the
                        # comparison side (TPC-DS q6's `price > 1.2 *
                        # (SELECT avg ...)`) — find exactly one and
                        # splice the decorrelated value back in place
                        subs = [x for x in ast.walk(side_expr)
                                if isinstance(x, ast.ScalarSubquery)]
                        if len(subs) != 1:
                            continue
                        sub = subs[0]
                        got = split_scalar_agg(sub.plan)
                        if got is None:
                            continue
                        inner_rel, corr, inner_only, sel, needs_left = got
                        if inner_only:
                            inner_rel = ast.Filter(inner_rel,
                                                   _and_all(inner_only))
                        alias = f"__sq{next(sq_counter)}"
                        group = tuple(ic for _oc, ic in corr)
                        # count's empty group is 0, not NULL: LEFT join
                        # keeps unmatched outer rows, and each COUNT term
                        # is coalesced to 0 INDIVIDUALLY — a whole-expr
                        # coalesce would turn count(*)+sum(x) (NULL for an
                        # empty group: 0 + NULL) or count(*)+1 (1) into a
                        # bare 0. sum/avg/min/max
                        # terms stay NULL so mixed expressions keep
                        # single-node semantics; all-non-count selects
                        # keep the inner join (their NULL compares false,
                        # dropping the row).
                        slot_funcs: List[ast.Func] = []

                        def _slot(f: ast.Func) -> int:
                            for k, g in enumerate(slot_funcs):
                                if g == f:
                                    return k
                            slot_funcs.append(f)
                            return len(slot_funcs) - 1

                        def _externalize(x: ast.Expr) -> ast.Expr:
                            if isinstance(x, ast.Func) and \
                                    x.name in ast.AGG_FUNCS:
                                ref: ast.Expr = ast.Col(
                                    f"__sv{_slot(x)}", alias)
                                if needs_left and x.name == "count":
                                    ref = ast.Func(
                                        "coalesce",
                                        (ref, ast.Lit(0, T.LONG)))
                                return ref
                            return x.map_children(_externalize)

                        sv = _externalize(sel)

                        def _splice(x: ast.Expr) -> ast.Expr:
                            if x == sub:
                                return sv
                            return x.map_children(_splice)

                        sv = _splice(side_expr)
                        aggs = tuple(
                            ast.Alias(ic, f"__ck{j}")
                            for j, (_oc, ic) in enumerate(corr)
                        ) + tuple(ast.Alias(f, f"__sv{k}")
                                  for k, f in enumerate(slot_funcs))
                        sq = ast.SubqueryAlias(
                            ast.Aggregate(inner_rel, group, aggs), alias)
                        join_cond = _and_all([
                            ast.BinOp("=", oc,
                                      ast.Col(f"__ck{j}", alias))
                            for j, (oc, _ic) in enumerate(corr)])
                        join_specs.append(
                            (sq, "left" if needs_left else "inner",
                             join_cond))
                        post.append(dataclasses.replace(e, **{side: sv}))
                        changed = done = True
                        break
                    if done:
                        continue
                # correlated IN → semi join on (value, correlation keys)
                if isinstance(e, ast.InSubquery) and not e.negated:
                    got = split_correlation(e.plan, None, want_select=True)
                    if got is not None and got[3] and len(got[3]) == 1:
                        inner_rel, corr, inner_only, sel_exprs, corr_res \
                            = got
                        sel = sel_exprs[0]
                        if isinstance(sel, ast.Alias):
                            sel = sel.child
                        if inner_only:
                            inner_rel = ast.Filter(inner_rel,
                                                   _and_all(inner_only))
                        join_cond = _and_all(
                            [ast.BinOp("=", e.child, sel)] +
                            [ast.BinOp("=", oc, ic) for oc, ic in corr]
                            + corr_res)
                        join_specs.append((inner_rel, "semi", join_cond))
                        changed = True
                        continue
                rest.append(c)
            if not changed:
                return p
            # decorrelation joins stack ABOVE the remaining filter so the
            # optimizer still sees the original Filter-over-FROM-chain and
            # can order it by size (a comma-joined FROM buried under a
            # semi join would stay an unordered cross product)
            base = ast.Filter(child, _and_all(rest)) if rest else child
            for inner_rel, how2, cond2 in join_specs:
                base = ast.Join(base, inner_rel, how2, cond2)
            if post:
                base = ast.Filter(base, _and_all(post))
            return base

        def walk_plans(p: ast.Plan) -> ast.Plan:
            if isinstance(p, ast.Filter):
                p = rewrite_filter(p)
            kids = p.children()
            if not kids:
                return p
            if isinstance(p, (ast.Join, ast.Union, ast.SetOp)):
                return dataclasses.replace(p, left=walk_plans(p.left),
                                           right=walk_plans(p.right))
            return dataclasses.replace(p, child=walk_plans(kids[0]))

        return walk_plans(plan)

    def _rewrite_subqueries(self, plan: ast.Plan, user_params) -> ast.Plan:
        """Pre-evaluate UNCORRELATED subqueries and substitute literals
        (scalar → Lit, IN → InList, EXISTS → bool). Correlated subqueries
        were already decorrelated into joins by _decorrelate; any shape
        it cannot handle surfaces a clear unsupported error here."""
        return ast.transform_plan_exprs(plan, self._subquery_fn(user_params))

    def _subquery_fn(self, user_params):
        def fn(e: ast.Expr) -> ast.Expr:
            if isinstance(e, ast.ScalarSubquery):
                res = self._run_subquery(e.plan, user_params)
                if res.num_rows == 0:
                    return ast.Lit(None, res.dtypes[0])
                if res.num_rows > 1:
                    raise AnalysisError(
                        "scalar subquery returned more than one row")
                v = res.columns[0][0]
                if res.nulls[0] is not None and res.nulls[0][0]:
                    return ast.Lit(None, res.dtypes[0])
                return ast.Lit(v.item() if hasattr(v, "item") else v,
                               res.dtypes[0])
            if isinstance(e, ast.InSubquery):
                res = self._run_subquery(e.plan, user_params)
                dtype = res.dtypes[0]
                has_null = res.nulls[0] is not None and bool(
                    res.nulls[0].any())
                if e.negated and has_null:
                    # SQL: x NOT IN (set containing NULL) is never TRUE
                    return ast.Lit(False, T.BOOLEAN)
                vals = tuple(
                    ast.Lit(v.item() if hasattr(v, "item") else v, dtype)
                    for i, v in enumerate(res.columns[0])
                    if not (res.nulls[0] is not None and res.nulls[0][i]))
                if not vals:
                    return ast.Lit(e.negated, T.BOOLEAN)
                return ast.InList(e.child, vals, negated=e.negated)
            if isinstance(e, ast.ExistsSubquery):
                res = self._run_subquery(ast.Limit(e.plan, 1), user_params)
                return ast.Lit(res.num_rows > 0, T.BOOLEAN)
            return e

        return fn

    def _run_subquery(self, subplan: ast.Plan, user_params) -> Result:
        try:
            # decode exact decimals BEFORE literal substitution: a raw
            # scaled-int column value (2405 for 24.05) substituted as a
            # Lit would be re-scaled by the literal emitter
            return finalize_decimals(self._run_query(subplan, user_params))
        except AnalysisError as e:
            if "cannot resolve column" in str(e):
                raise AnalysisError(
                    f"correlated subqueries are not supported yet ({e})")
            raise

    # ------------------------------------------------------------------
    # Tiled scans: table >> device memory (ref session.py:1190-1895)
    # ------------------------------------------------------------------

    def _tile_budget(self) -> int:
        """Effective byte budget for one scan tile.  conf.scan_tile_bytes:
        > 0 explicit, 0 auto (half the card's memory on CUDA, off on the
        CPU), < 0 disabled."""
        b = int(self.conf.scan_tile_bytes)
        if b != 0:
            return max(0, b)
        if self.device.type != "cuda":
            return 0
        if self._device_bytes is None:
            self._device_bytes = int(torch.cuda.mem_get_info(self.device)[1])
        return self._device_bytes // 2

    def _tilable_agg_shape(self, plan: ast.Plan):
        """Shape probe of the tile pass: ([Sort|Limit]* [Filter(having)]
        Aggregate(column table [joined to build tables])), no subqueries
        or windows.  Joins tile on the PROBE side only: the leftmost leaf
        relation streams in windows while every build side binds fully
        each tile (its cached join artifact stays resident); right/full
        outer joins would re-emit their NULL-extended build rows per
        tile, so they never tile.  Returns (outer, having, node, info,
        exprs, build_infos) or None."""
        outer: List[ast.Plan] = []
        node = plan
        while isinstance(node, (ast.Sort, ast.Limit)):
            outer.append(node)
            node = node.children()[0]
        having = None
        if isinstance(node, ast.Filter) and isinstance(node.child,
                                                       ast.Aggregate):
            having = node.condition
            node = node.child
        if not isinstance(node, ast.Aggregate):
            return None
        if node.grouping_sets:
            return None  # expands to a union at analysis; never tile raw

        rels: List[str] = []
        exprs: List[ast.Expr] = []
        join_hows: List[str] = []

        def rec(p):
            if isinstance(p, (ast.WindowedRelation, ast.WindowProject,
                              ast.Values, ast.Union,
                              ast.SetOp, ast.Distinct)):
                rels.append("__unsupported__")
                return
            if isinstance(p, ast.Join):
                join_hows.append(p.how)
            if isinstance(p, ast.UnresolvedRelation):
                rels.append(p.name)
            for fld in dataclasses.fields(p):
                v = getattr(p, fld.name)
                items = v if isinstance(v, tuple) else (v,)
                for x in items:
                    if isinstance(x, ast.Expr):
                        exprs.append(x)
            for k in p.children():
                rec(k)

        rec(node)
        if having is not None:
            exprs.append(having)
        if not rels or "__unsupported__" in rels:
            return None
        if any(h in ("right", "full") for h in join_hows):
            return None
        for e in exprs:
            for sub in ast.walk(e):
                if isinstance(sub, (ast.ScalarSubquery, ast.InSubquery,
                                    ast.ExistsSubquery, ast.WindowFunc)):
                    return None
        # probe = leftmost leaf (children() order is (left, right), so DFS
        # leaf order puts the probe chain's base table first)
        probe_name = rels[0]
        if sum(1 for r in rels if r.lower() == probe_name.lower()) > 1:
            return None  # self-join: a window would constrain BOTH sides
        info = self.catalog.lookup_table(probe_name)
        if info is None or not isinstance(info.data, ColumnTableData):
            return None
        build_infos = []
        for rn in rels[1:]:
            bi = self.catalog.lookup_table(rn)
            if bi is None or bi.data is info.data:
                return None
            build_infos.append(bi)
        return outer, having, node, info, exprs, build_infos

    @staticmethod
    def _decoded_col_width(f) -> Optional[int]:
        """Decoded device bytes per row for one column (value plate + null
        byte), or None for complex plates, which do not tile.  One source
        for the unit math and the build-side charge."""
        if isinstance(f.dtype, (T.ArrayType, T.MapType, T.StructType)):
            return None
        per = 4 if f.dtype.name == "string" \
            else np.dtype(f.dtype.device_dtype()).itemsize
        return per + 1

    def _join_build_side_bytes(self, exprs, build_infos) -> Optional[int]:
        """Decoded bytes a tilable join + aggregate's build sides pin on
        the device across EVERY tile (0 for single-relation shapes), or
        None when a complex build plate makes the shape untilable."""
        if not build_infos:
            return 0
        used = {c.name.lower() for e in exprs for c in ast.walk(e)
                if isinstance(c, ast.Col)}
        total = 0
        for bi in build_infos:
            rows = bi.data.count() if isinstance(bi.data, RowTableData) \
                else mvcc.snapshot_of(bi.data).total_rows()
            w = 1
            for f in bi.schema.fields:
                cw = self._decoded_col_width(f)
                if cw is None:
                    return None
                if f.name.lower() not in used:
                    continue
                w += cw
            total += rows * w
        return total

    def _maybe_tiled_aggregate(self, plan: ast.Plan,
                               user_params) -> Optional[Result]:
        """Execute an aggregate over ONE oversized column table as a
        streamed tile pass: bind `scan_tile_bytes`-sized windows of the
        scan units through the SAME compiled partial program, then merge
        the partials (avg = sum / count etc.).  The device never holds
        the whole table.  Returns None -> run untiled."""
        if self._in_tile or user_params:
            return None
        budget = self._tile_budget()
        if budget <= 0:
            return None
        shaped = self._tilable_agg_shape(plan)
        if shaped is None:
            return None
        outer, having, node, info, exprs, build_infos = shaped
        data = info.data
        # the pass pins ONE manifest across every window — the statement's
        # pinned one, so a tiled aggregate and an untiled one see the
        # same epoch, and the prefetch worker binds it, never the live one
        manifest = mvcc.snapshot_of(data)
        units = scan_unit_count(data, manifest)
        if units <= 1:
            return None
        used = {c.name.lower() for e in exprs for c in ast.walk(e)
                if isinstance(c, ast.Col)}
        # join build sides stay device-resident across every tile; they
        # must fit the budget beside one probe tile
        build_bytes = self._join_build_side_bytes(exprs, build_infos)
        if build_bytes is None or build_bytes >= budget:
            return None
        cap = data.capacity
        unit_bytes = cap  # shared validity mask
        for f in info.schema.fields:
            if f.name.lower() not in used:
                continue
            cw = self._decoded_col_width(f)
            if cw is None:
                return None  # complex plates don't tile
            unit_bytes += cap * cw
        if unit_bytes * units <= budget - build_bytes:
            return None
        tile_units = max(1, int((budget - build_bytes) // unit_bytes))
        if self.conf.batches_pow2_bucketing and tile_units > 1:
            tile_units = 1 << (tile_units.bit_length() - 1)

        try:
            partial_plan, merged_select, _, merge_having = \
                decompose_aggregate(node, having)
            partial_sql = render_plan(partial_plan)
        except (NotDecomposableError, RenderError):
            return None
        # outer ORDER BY must reference output columns by name/position
        out_names = [_expr_name(e).lower() for e in node.agg_exprs]
        for op in outer:
            if isinstance(op, ast.Sort):
                for o in op.orders:
                    tgt = o[0].child if isinstance(o[0], ast.Alias) else o[0]
                    if isinstance(tgt, ast.Col) and \
                            tgt.name.lower() in out_names:
                        continue
                    if isinstance(tgt, ast.Lit) and \
                            isinstance(tgt.value, int):
                        continue
                    return None

        # compile the partial program ONCE: every tile shares it, and when
        # its group-index space is provably tile-aligned (direct
        # dict/bool/vdict keys: data-independent cards) the per-tile [G]
        # partials merge ON THE DEVICE
        tokenized = compiled = None
        params: Tuple = ()
        try:
            pplan = optimize(parse(partial_sql).plan, self.catalog)
            resolved_p, _ = self.analyzer.analyze_plan(pplan)
            if self.conf.tokenize and self.conf.plan_caching:
                tokenized, lit_params = tokenize_plan(resolved_p)
            else:
                tokenized, lit_params = \
                    assign_param_positions(resolved_p, 0), ()
            params = tuple(lit_params)
            compiled = self.executor.compiled_partial(tokenized)
        except Exception:  # noqa: BLE001 — any analysis hiccup: SQL path
            tokenized = None

        reg = global_registry()
        merged: Optional[Result] = None
        pieces: List[Result] = []
        self._in_tile = True
        try:
            if compiled is not None and compiled.tile_merge is not None \
                    and compiled.tile_merge_ok():
                merged = self._tiled_device_pass(
                    compiled, params, data, manifest, units, tile_units)
            if merged is None:
                pf = TilePrefetcher.maybe(data, manifest, units,
                                          tile_units, self.device)
                try:
                    for lo in range(0, units, tile_units):
                        if pf is not None:
                            pf.await_window(lo)
                        with scan_window(data, lo,
                                         min(lo + tile_units, units),
                                         manifest, tile_units=tile_units):
                            if tokenized is not None:
                                pieces.append(self.executor.execute(
                                    tokenized, params))
                            else:  # analysis failed: per-tile SQL path
                                pieces.append(self.sql(partial_sql))
                        if pf is not None:
                            pf.advance(lo)
                        reg.inc("scan_tiles")
                finally:
                    if pf is not None:
                        pf.close()
                reg.inc("scan_tile_host_merges")
        finally:
            self._in_tile = False
        if merged is not None:
            pieces = [merged]
        return self._merge_partial_pieces(pieces, node, merged_select,
                                          merge_having, outer)

    def _merge_partial_pieces(self, pieces, node, merged_select,
                              merge_having, outer) -> Result:
        """Partial [G] results -> final aggregate (avg = sum / count,
        HAVING over merged slots, outer sort/limit re-applied), in a
        pooled scratch session on the caller's device, keyed by the
        partial schema and truncated between uses, so the merge plan
        compiles once.  The scratch table keeps float64 plates on every
        device: its DOUBLE columns hold float64 accumulator partials
        (and unscaled exact-decimal sums), which the float32 plates of
        the CUDA policy would round before the final merge."""
        first = pieces[0]
        fields_sql = ", ".join(
            f"{nm} {ddl_type(dt)}"
            for nm, dt in zip(first.names, first.dtypes))
        pool = self._tile_merge_pool.setdefault(fields_sql, [])
        with config.float64_plates():
            try:
                scratch_sess = pool.pop()   # GIL-atomic claim
            except IndexError:
                scratch_sess = SnappySession(catalog=Catalog(),
                                             conf=self.conf,
                                             device=self.device)
                # the merge select must never re-enter the tile pass:
                # the partials of a generic-key aggregate can exceed a
                # tiny tile budget, and a tiled merge would recurse
                scratch_sess._in_tile = True
                scratch_sess.sql(f"CREATE TABLE __tile_partials "
                                 f"({fields_sql}) USING column")
            sdata = scratch_sess.catalog.describe("__tile_partials").data
            for piece in pieces:
                if piece.num_rows:
                    # executor results carry exact decimals as scaled
                    # int64: unscale into the host float domain the
                    # scratch DOUBLE columns expect (self.sql pieces
                    # arrive finalized)
                    piece = to_host_domain(piece)
                    nmask = piece.nulls \
                        if any(m is not None for m in piece.nulls) else None
                    sdata.insert_arrays(piece.columns, nulls=nmask)
            merge_items = ", ".join(render_expr(e) for e in merged_select)
            msql = f"SELECT {merge_items} FROM __tile_partials"
            if node.group_exprs:
                msql += " GROUP BY " + ", ".join(
                    f"__g{gi}" for gi in range(len(node.group_exprs)))
            if merge_having is not None:
                msql += f" HAVING {render_expr(merge_having)}"
            result = scratch_sess.sql(msql)
        result.names = [_expr_name(e) for e in node.agg_exprs]
        # result columns are host arrays: recycle the scratch table
        # underneath them (bounded pool)
        sdata.truncate()
        if len(pool) < 4:
            pool.append(scratch_sess)
        return _apply_outer(result, outer)

    def _tiled_device_pass(self, compiled, params, data, manifest, units,
                           tile_units) -> Optional[Result]:
        """Stream scan tiles through ONE compiled partial program and
        tree-merge the per-tile [G] partial slots ON THE DEVICE.
        `execute_raw` never copies to the host, so CUDA's asynchronous
        launch lets the host enqueue tile t+1 while the card reduces tile
        t; a depth-2 throttle (wait on tile t-1's event after launching
        t) keeps at most two tiles' work in flight.  Returns the merged
        partial Result, or None to fall back to the host-merge path (a
        bind refused the device, or the int64 decimal bound tripped —
        the exact host merge decides)."""
        reg = global_registry()
        tags = compiled.tile_merge["tags"]
        cuda = self.device.type == "cuda"
        outs: List[tuple] = []
        events: List = []
        pf = TilePrefetcher.maybe(data, manifest, units, tile_units,
                                  self.device)
        try:
            try:
                for lo in range(0, units, tile_units):
                    if pf is not None:
                        pf.await_window(lo)
                    with scan_window(data, lo, min(lo + tile_units, units),
                                     manifest, tile_units=tile_units):
                        outs.append(compiled.execute_raw(params,
                                                         self.device))
                    if pf is not None:
                        pf.advance(lo)
                    # counts WORK, not queries: when this pass aborts the
                    # host rerun counts its tiles again
                    reg.inc("scan_tiles")
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record()
                        events.append(ev)
                        if len(events) >= 2 and not events[-2].query():
                            # this tile's launches overlapped the previous
                            # tile's device work: the pipelining evidence
                            reg.inc("scan_tile_prefetch_overlap")
                            events[-2].synchronize()
            except CompileError:
                return None
        finally:
            if pf is not None:
                pf.close()
        if len(outs) > 1:
            reg.inc("scan_tile_device_merges", len(outs) - 1)
        while len(outs) > 1:  # pairwise tree merge, all on the device
            nxt = [merge_tile_outs(outs[j], outs[j + 1], tags)
                   for j in range(0, len(outs) - 1, 2)]
            if len(outs) % 2:
                nxt.append(outs[-1])
            outs = nxt
        mask, pairs, overflow = outs[0]
        if overflow is not None and bool(overflow):
            return None  # overflow flagged: the exact host path decides
        return compiled.assemble_device(mask, pairs)

    # ------------------------------------------------------------------
    # Programmatic API (ref SnappySession.createTable/insert)
    # ------------------------------------------------------------------

    def create_table(self, name: str, schema, provider: str = "column",
                     options: Optional[Dict[str, str]] = None,
                     if_not_exists: bool = False):
        if not isinstance(schema, T.Schema):
            schema = T.Schema([T.Field(n, dt) for n, dt in schema])
        return self.catalog.create_table(name, schema, provider,
                                         options or {}, if_not_exists)

    def _journal_then(self, info, kind: str, arrays, nulls, apply_fn,
                      extra: Optional[dict] = None):
        """WAL-then-apply under the mutation lock, then ack after the
        covering group fsync (no journal without a store).  The append
        only buffers the framed record: while `apply_fn` encodes and cuts
        batches, the background flusher can already be fsyncing the
        group, and `wal_sync` releases the ack once the fsync covers this
        record's seq."""
        with config.device_scope(self.device):
            ds = self.disk_store
            if ds is None:
                return apply_fn()
            from snappydata_tpu_torch.reliability import current_stmt_id

            extra = dict(extra or {})
            if current_stmt_id():
                extra["stmt_id"] = current_stmt_id()
            with ds.mutation_lock:
                seq = ds.wal_append(info.name, kind, arrays=arrays,
                                    nulls=nulls, extra=extra or None)
                with mvcc.commit_scope(seq):
                    out = apply_fn()
            ds.wal_sync(seq)
            return out

    def insert(self, table: str, *rows) -> int:
        info = self.catalog.describe(table)
        arrays, nulls = _rows_to_arrays(info.schema, rows)
        if isinstance(info.data, RowTableData):
            raw = _restore_none_arrays(arrays, nulls)
            return self._journal_then(
                info, "insert", raw, None,
                lambda: info.data.insert_arrays(raw))
        return self._journal_then(
            info, "insert", arrays, nulls,
            lambda: info.data.insert_arrays(arrays, nulls=nulls))

    def insert_arrays(self, table: str, arrays: Sequence[np.ndarray]) -> int:
        info = self.catalog.describe(table)
        arrays = [np.asarray(a) for a in arrays]
        return self._journal_then(info, "insert", arrays, None,
                                  lambda: info.data.insert_arrays(arrays))

    def put(self, table: str, *rows) -> int:
        """PUT INTO by rows: an upsert on the table's key columns."""
        info = self.catalog.describe(table)
        arrays, nulls = _rows_to_arrays(info.schema, rows)
        if isinstance(info.data, RowTableData):
            arrays = _restore_none_arrays(arrays, nulls)
        return self.put_arrays(table, arrays)

    def put_arrays(self, table: str, arrays: Sequence[np.ndarray]) -> int:
        info = self.catalog.describe(table)
        arrays = [np.asarray(a) for a in arrays]

        def apply():
            if isinstance(info.data, RowTableData):
                return info.data.put_arrays(arrays)
            return self._column_put(info, arrays)

        return self._journal_then(info, "put", arrays, None, apply)

    def delete_keys(self, table: str, key_columns: Sequence[str],
                    key_arrays: Sequence[np.ndarray]) -> int:
        """Delete the rows whose key tuple appears in `key_arrays` (the
        CDC delete path; WAL kind `delete_keys`)."""
        from snappydata_tpu_torch.storage.persistence import _key_predicate

        info = self.catalog.describe(table)
        key_arrays = [np.asarray(a) for a in key_arrays]
        keys = {tuple(c[i] for c in key_arrays)
                for i in range(len(key_arrays[0]))}
        pred = _key_predicate(list(key_columns), keys)
        return self._journal_then(
            info, "delete_keys", key_arrays, None,
            lambda: info.data.delete(pred),
            extra={"key_columns": list(key_columns)})

    def update(self, table: str, where_sql: str, new_values: Dict[str, Any]
               ) -> int:
        """Programmatic UPDATE, routed through sql()."""
        sets = ", ".join(f"{k} = {_sql_literal(v)}"
                         for k, v in new_values.items())
        text = f"UPDATE {table} SET {sets}" + \
            (f" WHERE {where_sql}" if where_sql else "")
        return int(self.sql(text).rows()[0][0])

    def delete(self, table: str, where_sql: str) -> int:
        text = f"DELETE FROM {table}" + \
            (f" WHERE {where_sql}" if where_sql else "")
        return int(self.sql(text).rows()[0][0])

    def get(self, table: str, key: tuple):
        """Point lookup on a row table's primary key: never enters the
        query engine (ref: ExecutionEngineArbiter fast path)."""
        info = self.catalog.describe(table)
        if not isinstance(info.data, RowTableData):
            raise ValueError("get() requires a row table with a primary key")
        return info.data.get(key)

    def stop(self) -> None:
        """Drop the compiled-plan cache and, on a durable session, save
        the catalog (the WAL stays open: a later session on the same
        directory recovers in the crash shape)."""
        self.executor.clear_cache()
        if self.disk_store is not None:
            self.disk_store.save_catalog(self.catalog)

    def clear_plan_cache(self) -> None:
        self.executor.clear_cache()

    def _create_table(self, stmt: ast.CreateTable) -> Result:
        if stmt.stream or stmt.provider not in ("column", "row"):
            raise NotImplementedError(
                "only CREATE TABLE ... USING column | row is ported")
        if stmt.as_select is not None:
            if stmt.if_not_exists and \
                    self.catalog.lookup_table(stmt.name) is not None:
                return _status()
            result = to_host_domain(self._run_query(stmt.as_select))
            schema = T.Schema([T.Field(n, dt) for n, dt in
                               zip(result.names, result.dtypes)])
            info = self.catalog.create_table(stmt.name, schema,
                                             stmt.provider, stmt.options,
                                             stmt.if_not_exists)
            if result.num_rows:
                arrays, nulls = _result_to_arrays(result, schema)
                if isinstance(info.data, RowTableData):
                    info.data.insert_arrays(
                        _restore_none_arrays(arrays, nulls))
                else:
                    info.data.insert_arrays(arrays, nulls=nulls)
            return _status()
        schema = T.Schema([T.Field(c.name, c.dtype, c.nullable)
                           for c in stmt.columns])
        keys = tuple(c.name for c in stmt.columns if c.primary_key)
        self.catalog.create_table(stmt.name, schema, stmt.provider,
                                  stmt.options, stmt.if_not_exists,
                                  key_columns=keys)
        return _status()

    def _insert(self, stmt: ast.InsertInto, user_params) -> int:
        info = self.catalog.describe(stmt.table)
        schema = info.schema
        if isinstance(stmt.source, ast.Values):
            resolved, _ = self.analyzer.analyze_plan(stmt.source)
            src = hosteval.eval_values(resolved, user_params)
        else:
            src = to_host_domain(self._run_query(stmt.source, user_params))
        if stmt.columns:
            if len(stmt.columns) != len(src.columns):
                raise ValueError("INSERT column count mismatch")
            name_to_src = {c.lower(): i for i, c in enumerate(stmt.columns)}
        else:
            if len(src.columns) != len(schema):
                raise ValueError(
                    f"INSERT arity mismatch: {len(src.columns)} vs "
                    f"{len(schema)}")
            name_to_src = {f.name.lower(): i
                           for i, f in enumerate(schema.fields)}
        arrays, null_masks = [], []
        n = src.num_rows
        for f in schema.fields:
            i = name_to_src.get(f.name.lower())
            if i is None:  # unmentioned column -> all NULL
                arrays.append(np.zeros(n, dtype=f.dtype.np_dtype)
                              if f.dtype.name != "string"
                              else np.full(n, None, dtype=object))
                null_masks.append(np.ones(n, dtype=np.bool_))
                continue
            arr, nmask = _coerce(src.columns[i], src.nulls[i], f.dtype)
            arrays.append(arr)
            null_masks.append(nmask)
        if stmt.overwrite:
            info.data.truncate()
        if isinstance(info.data, RowTableData):
            raw = _restore_none_arrays(arrays, null_masks)
            return info.data.put_arrays(raw) if stmt.put \
                else info.data.insert_arrays(raw)
        if stmt.put:
            return self._column_put(info, arrays, null_masks)
        return info.data.insert_arrays(arrays, nulls=null_masks)

    # ------------------------------------------------------------------
    # Mutations (ref session.py:3201-3408)
    # ------------------------------------------------------------------

    def _column_put(self, info, arrays, nulls=None) -> int:
        """PUT INTO a column table: delete the rows whose key_columns
        match an incoming row, then insert everything (ref:
        ColumnPutIntoExec = update-matched + insert-rest; the same visible
        effect under the statement's snapshot).  Without key columns it
        is a plain insert."""
        keys = info.key_columns
        if not keys:
            return info.data.insert_arrays(arrays, nulls=nulls)
        key_idx = [info.schema.index(k) for k in keys]
        incoming = {tuple(np.asarray(arrays[i])[r] for i in key_idx)
                    for r in range(len(np.asarray(arrays[0])))}

        def pred(cols):
            stacked = [np.asarray(cols[info.schema.fields[i].name])
                       for i in key_idx]
            return np.fromiter((k in incoming for k in zip(*stacked)),
                               dtype=np.bool_, count=len(stacked[0]))

        info.data.delete(pred)
        return info.data.insert_arrays(arrays, nulls=nulls)

    def _resolve_where(self, table_info, where, user_params):
        # UPDATE / DELETE expressions may carry subqueries: pre-evaluate
        # them as queries do
        where = ast.transform(where, self._subquery_fn(user_params))
        alias = table_info.name.split(".")[-1]
        scope = Scope([ScopeEntry(alias, f.name, f.dtype, f.nullable)
                       for f in table_info.schema.fields])
        return fold_constants(self.analyzer.resolve_expr(where, scope))

    @staticmethod
    def _assign_expr_params(e: ast.Expr, counter: list) -> ast.Expr:
        """Positional '?' assignment for mutation statements, whose
        expressions are resolved standalone: without it every '?' kept
        pos=-1 and bound the LAST parameter."""
        def rec(node: ast.Expr) -> ast.Expr:
            if isinstance(node, ast.Param) and node.pos < 0:
                p = ast.Param(counter[0], node.dtype)
                counter[0] += 1
                return p
            return node.map_children(rec)

        return rec(e)

    def _update(self, stmt: ast.UpdateStmt, user_params) -> int:
        info = self.catalog.describe(stmt.table)
        # '?' positions follow SQL text order: SET expressions, then WHERE
        counter = [0]
        assignments = [(name, self._assign_expr_params(e, counter))
                       for name, e in stmt.assignments]
        raw_where = self._assign_expr_params(stmt.where, counter) \
            if stmt.where is not None else None
        where = self._resolve_where(info, raw_where, user_params) \
            if raw_where is not None else ast.Lit(True, T.BOOLEAN)
        assigns = {}
        for name, e in assignments:
            resolved = self._resolve_where(info, e, user_params)
            assigns[name] = self._host_value_fn(info, resolved, user_params)
        pred = self._host_pred_fn(info, where, user_params)
        return info.data.update(pred, assigns)

    def _delete(self, stmt: ast.DeleteStmt, user_params) -> int:
        info = self.catalog.describe(stmt.table)
        raw_where = self._assign_expr_params(stmt.where, [0]) \
            if stmt.where is not None else None
        where = self._resolve_where(info, raw_where, user_params) \
            if raw_where is not None else ast.Lit(True, T.BOOLEAN)
        return info.data.delete(
            self._host_pred_fn(info, where, user_params))

    def _host_pred_fn(self, info, resolved_where, user_params):
        names = info.schema.names()

        def pred(cols: Dict[str, np.ndarray]) -> np.ndarray:
            arrays = _ColsByIndex(cols, names)  # decode only touched cols
            n = arrays.num_rows(resolved_where)
            v, nl = hosteval.eval_expr(resolved_where, arrays,
                                       _NoneSeq(), tuple(user_params), n)
            out = np.broadcast_to(v, (n,)).astype(bool)
            if nl is not None:
                out = out & ~np.broadcast_to(nl, (n,))
            return out

        return pred

    def _host_value_fn(self, info, resolved_expr, user_params):
        names = info.schema.names()

        def value(cols: Dict[str, np.ndarray]):
            if isinstance(resolved_expr, ast.Lit):
                return resolved_expr.value  # incl. None = SQL NULL
            arrays = _ColsByIndex(cols, names)
            n = arrays.num_rows(resolved_expr)
            v, _ = hosteval.eval_expr(resolved_expr, arrays,
                                      _NoneSeq(), tuple(user_params), n)
            return v if np.shape(v) == () else np.broadcast_to(v, (n,))

        return value

    def _alter_table(self, stmt: ast.AlterTable) -> Result:
        """ALTER TABLE ADD / DROP COLUMN (ref SnappySession.alterTable:1628)
        on row and column tables; existing rows read an added column as
        NULL.  DROP COLUMN shifts ordinals in place, so it refuses with
        SQLSTATE 40001 while a snapshot pin holds the table."""
        info = self.catalog.describe(stmt.table)
        if stmt.add:
            cd = stmt.column
            if any(f.name.lower() == cd.name.lower()
                   for f in info.schema.fields):
                raise ValueError(f"column already exists: {cd.name}")
            info.data.add_column(T.Field(cd.name, cd.dtype, cd.nullable))
        else:
            cname = stmt.name
            info.schema.index(cname)  # validates existence
            low = cname.lower()
            if low in info.partition_by:
                raise ValueError(
                    f"cannot drop partitioning column {cname}")
            if low in info.key_columns:
                raise ValueError(f"cannot drop primary key column {cname}")
            mvcc.check_ddl(info.data, "ALTER TABLE DROP COLUMN")
            info.data.drop_column(cname)
        info.schema = info.data.schema
        self.catalog.generation += 1
        return _status()


class _ColsByIndex:
    """Ordinal-indexed view over a {name: values} mapping that fetches
    (and so decodes, when backed by LazyBatchColumns) only the columns an
    expression touches."""

    def __init__(self, cols, names):
        self._cols = cols
        self._names = names

    def __getitem__(self, i: int) -> np.ndarray:
        return np.asarray(self._cols[self._names[i]])

    def num_rows(self, expr: ast.Expr) -> int:
        for node in ast.walk(expr):
            if isinstance(node, ast.Col):
                return int(self[node.index].shape[0])
        # no column refs (WHERE 1=1): any column's length works
        return int(self[0].shape[0]) if self._names else 0


class _NoneSeq:
    def __getitem__(self, i):
        return None


def _row_count(info) -> int:
    if isinstance(info.data, RowTableData):
        return info.data.count()
    return info.data.snapshot().total_rows()


def _expr_subquery_tables(e: ast.Expr):
    out = []
    for node in ast.walk(e):
        if isinstance(node, (ast.ScalarSubquery, ast.InSubquery,
                             ast.ExistsSubquery)):
            out.extend(_referenced_tables(node.plan))
    return out


def _referenced_tables(plan: ast.Plan):
    """Names of the tables a parsed plan reads, subqueries included."""
    out = []

    def rec(p):
        if isinstance(p, ast.UnresolvedRelation):
            out.append(p.name)
        for e in _plan_exprs(p):
            for node in ast.walk(e):
                if isinstance(node, (ast.ScalarSubquery, ast.InSubquery,
                                     ast.ExistsSubquery)):
                    rec(node.plan)
        for k in p.children():
            rec(k)

    def _plan_exprs(p):
        if isinstance(p, ast.Filter):
            return [p.condition]
        if isinstance(p, (ast.Project, ast.WindowProject)):
            return list(p.exprs)
        if isinstance(p, ast.Aggregate):
            return list(p.group_exprs) + list(p.agg_exprs)
        if isinstance(p, ast.Join) and p.condition is not None:
            return [p.condition]
        if isinstance(p, ast.Values):
            return [e for row in p.rows for e in row]
        if isinstance(p, ast.Sort):
            return [e for e, *_ in p.orders]
        return []

    rec(plan)
    return out


def _restore_none_arrays(arrays, nulls):
    """Row tables store python values: object arrays with None where the
    null mask is set."""
    out = []
    for a, m in zip(arrays, nulls or [None] * len(arrays)):
        if m is not None and np.asarray(m).any():
            obj = np.asarray(a, dtype=object).copy()
            obj[np.asarray(m)] = None
            out.append(obj)
        else:
            out.append(a)
    return out


def _sql_literal(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return repr(v)
    if hasattr(v, "item"):
        return repr(v.item())
    escaped = str(v).replace("'", "''")
    return f"'{escaped}'"


def _status() -> Result:
    return empty_result(["status"], [T.STRING])


def _count_result(n: int) -> Result:
    return Result(["count"], [np.array([n], dtype=np.int64)], [None],
                  [T.LONG])


def _rows_to_arrays(schema: T.Schema, rows):
    if len(rows) == 1 and isinstance(rows[0], (list, tuple)) and rows[0] \
            and isinstance(rows[0][0], (list, tuple)):
        rows = rows[0]
    arrays, nulls = [], []
    for i, f in enumerate(schema.fields):
        vals = [r[i] for r in rows]
        nmask = np.array([v is None for v in vals])
        if f.dtype.name in ("string", "array", "map"):
            arr = np.empty(len(vals), dtype=object)
            for j, v in enumerate(vals):
                arr[j] = v
            arrays.append(arr)
        else:
            arrays.append(np.array(
                [0 if v is None else v for v in vals], dtype=f.dtype.np_dtype))
        nulls.append(nmask if nmask.any() else None)
    return arrays, nulls


def _result_to_arrays(result: Result, schema: T.Schema):
    arrays, nulls = [], []
    for i, f in enumerate(schema.fields):
        arr, nmask = _coerce(result.columns[i], result.nulls[i], f.dtype)
        arrays.append(arr)
        nulls.append(nmask)
    return arrays, nulls


def _coerce(col: np.ndarray, nmask, dtype: T.DataType):
    """-> (storage array, null mask | None): NULLs become fillers + mask
    instead of being silently written as 0."""
    if dtype.name in ("array", "map"):
        out = np.empty(len(col), dtype=object)
        for i, v in enumerate(col):
            if isinstance(v, (list, tuple, np.ndarray)):
                out[i] = list(v)
            else:
                out[i] = v  # dicts / None pass through
        if nmask is not None:
            out[np.asarray(nmask)] = None
        return out, (np.asarray(nmask) if nmask is not None else None)
    if dtype.name == "string":
        out = np.array([None if v is None else str(v) for v in col],
                       dtype=object)
        if nmask is not None:
            out[nmask] = None
        return out, (np.asarray(nmask) if nmask is not None else None)
    arr = np.asarray(col)
    obj_nulls = None
    if arr.dtype == object:
        obj_nulls = np.array([v is None for v in arr])
        arr = np.array([0 if v is None else v for v in arr])
    combined = nmask
    if obj_nulls is not None and obj_nulls.any():
        combined = obj_nulls if combined is None else (combined | obj_nulls)
    return arr.astype(dtype.np_dtype), \
        (np.asarray(combined) if combined is not None else None)


def _apply_outer(result: Result, outer: List) -> Result:
    """Re-apply the outer ORDER BY / LIMIT / DISTINCT of a decomposed
    aggregate over its merged result, resolving order refs by output
    name or position (copy of the reference's
    snappydata_tpu/cluster/distributed.py `_apply_outer`)."""
    for op in reversed(outer):
        if isinstance(op, ast.Limit):
            result = hosteval.limit(result, op.n)
        elif isinstance(op, ast.Distinct):
            result = hosteval.distinct(result)
        elif isinstance(op, ast.Sort):
            orders = []
            lower = [n.lower() for n in result.names]
            for e, asc, *rest in op.orders:
                nf = rest[0] if rest else None
                target = e.child if isinstance(e, ast.Alias) else e
                if isinstance(target, ast.Col) and \
                        target.name.lower() in lower:
                    idx = lower.index(target.name.lower())
                    orders.append((ast.Col(target.name, None, idx,
                                           result.dtypes[idx]), asc, nf))
                elif isinstance(target, ast.Lit) and \
                        isinstance(target.value, int):
                    idx = target.value - 1
                    orders.append((ast.Col(result.names[idx], None, idx,
                                           result.dtypes[idx]), asc, nf))
                else:
                    raise ValueError(
                        "a tiled ORDER BY must reference output columns "
                        "by name or position")
            result = hosteval.sort(result, orders, ())
    return result


def _relation_columns(plan: ast.Plan, catalog):
    """(set of column names, set of aliases) reachable in a FROM subtree."""
    cols: set = set()
    aliases: set = set()

    def rec(p):
        if isinstance(p, ast.UnresolvedRelation):
            info = catalog.lookup_table(p.name)
            if info is not None:
                cols.update(n.lower() for n in info.schema.names())
            aliases.add((p.alias or p.name.split(".")[-1]).lower())
            return
        if isinstance(p, ast.SubqueryAlias):
            aliases.add(p.alias.lower())
        for k in p.children():
            rec(k)

    rec(plan)
    return cols, aliases
