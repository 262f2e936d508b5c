"""Analyzer: resolve names, expand stars, infer types, fold constants,
tokenize literals.

Plays the role of the reference's SnappyAnalyzer batches
(core/.../hive/SnappySessionState.scala:59 — incl. TokenizedLiteralFolding
:171) plus the literal-tokenization trick from SnappySession.sqlPlan:2571:
after folding, every remaining literal in expression position is replaced
by a positional ParamLiteral so textually-different queries share one
compiled XLA executable; the values ride along as runtime scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.sql.lexer import SQLSyntaxError


class AnalysisError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class ScopeEntry:
    qualifier: Optional[str]
    name: str
    dtype: T.DataType
    nullable: bool = True
    hidden: bool = False   # internal base-table column (e.g. __arrival_ts)


def _widen_branch_scope(ls: "Scope", rs: "Scope") -> "Scope":
    """UNION/INTERSECT/EXCEPT output scope: left-anchored names, but
    DECIMAL columns widen to cover BOTH branches' scales (Spark
    semantics) — anchoring dtype to the left would quantize away a
    finer right-branch scale at the decode boundary (review finding)."""
    out = []
    for le, re_ in zip(ls.entries, rs.entries):
        dt = le.dtype
        if "decimal" in ((le.dtype.name if le.dtype else ""),
                         (re_.dtype.name if re_.dtype else "")) \
                and le.dtype != re_.dtype:
            try:
                dt = T.common_type(le.dtype, re_.dtype)
            except TypeError:
                dt = le.dtype
        if dt is le.dtype:
            out.append(le)
        else:
            out.append(dataclasses.replace(le, dtype=dt))
    return Scope(out)


class Scope:
    def __init__(self, entries: Sequence[ScopeEntry]):
        self.entries = list(entries)

    def resolve(self, name: str, qualifier: Optional[str]) -> Tuple[int, ScopeEntry]:
        name_l = name.lower()
        qual_l = qualifier.lower() if qualifier else None
        hits = [(i, e) for i, e in enumerate(self.entries)
                if e.name.lower() == name_l
                and (qual_l is None or (e.qualifier or "").lower() == qual_l)]
        if not hits:
            raise AnalysisError(
                f"cannot resolve column {qualifier + '.' if qualifier else ''}{name}")
        if len(hits) > 1:
            raise AnalysisError(f"ambiguous column reference: {name}")
        return hits[0]

    def schema(self) -> T.Schema:
        return T.Schema([T.Field(e.name, e.dtype, e.nullable)
                         for e in self.entries])


def _expr_name(e: ast.Expr) -> str:
    if isinstance(e, ast.Alias):
        return e.name
    if isinstance(e, ast.Col):
        return e.name
    if isinstance(e, ast.Func):
        return f"{e.name}({', '.join(_expr_name(a) for a in e.args)})" \
            if e.args else f"{e.name}()"
    if isinstance(e, ast.WindowFunc):
        return f"{e.name}() OVER"
    if isinstance(e, ast.Cast):
        return _expr_name(e.child)
    if isinstance(e, (ast.Lit, ast.ParamLiteral)):
        return "literal"
    return "expr"


def expr_type(e: ast.Expr) -> T.DataType:
    """Type of a RESOLVED expression."""
    if isinstance(e, ast.Col):
        return e.dtype
    if isinstance(e, (ast.Lit, ast.ParamLiteral, ast.Param)):
        if e.dtype is not None:
            return e.dtype
        v = e.value if isinstance(e, ast.Lit) else None
        if isinstance(v, bool):
            return T.BOOLEAN
        if isinstance(v, int):
            return T.LONG
        if isinstance(v, float):
            return T.DOUBLE
        if isinstance(v, str):
            return T.STRING
        return T.STRING
    if isinstance(e, ast.Alias):
        return expr_type(e.child)
    if isinstance(e, ast.Cast):
        return e.to
    if isinstance(e, ast.UnaryOp):
        return T.BOOLEAN if e.op == "not" else expr_type(e.child)
    if isinstance(e, (ast.IsNull, ast.InList, ast.Between, ast.Like)):
        return T.BOOLEAN
    if isinstance(e, ast.Case):
        for _, v in e.whens:
            return expr_type(v)
        return expr_type(e.otherwise)
    if isinstance(e, ast.BinOp):
        if e.op in ("and", "or", "=", "!=", "<", "<=", ">", ">="):
            return T.BOOLEAN
        lt, rt = expr_type(e.left), expr_type(e.right)
        dec = T.decimal_binop_type(e.op, lt, rt)
        if dec is not None:
            # shared with the runtime lowering (exprs._dec_binop) so the
            # declared scale always matches the scaled-int representation
            return dec
        if e.op == "/":
            return T.DOUBLE
        return T.common_type(lt, rt)
    if isinstance(e, ast.WindowFunc):
        if e.name in ("row_number", "rank", "dense_rank", "ntile", "count"):
            return T.LONG
        if e.name == "avg":
            return T.DOUBLE
        if e.args:
            return expr_type(e.args[0])
        return T.DOUBLE
    if isinstance(e, ast.Func):
        low = e.name
        if low in ("count_distinct", "approx_count_distinct") \
                and len(e.args) > 1:
            raise AnalysisError(
                "multi-column COUNT(DISTINCT a, b) is not supported yet")
        if low in ("count", "count_distinct", "approx_count_distinct"):
            return T.LONG
        if low in ("avg", "stddev", "variance"):
            # avg(decimal) = exact int64 sum / exact count, computed and
            # declared as DOUBLE (divergence from the reference's
            # scale+4 decimal quotient, types.DecimalType docstring)
            return T.DOUBLE
        if low == "sum":
            at = expr_type(e.args[0])
            if at.name == "decimal":
                return T.decimal_sum_type(at)
            return at
        if low in ("min", "max", "first", "last", "abs", "coalesce"):
            return expr_type(e.args[0])
        if low in ("year", "month", "day", "length", "instr", "size",
                   "dayofmonth", "dayofweek", "dayofyear", "weekofyear",
                   "quarter", "hour", "minute", "second", "datediff",
                   "ascii"):
            return T.INT
        if low in ("date_add", "date_sub", "add_months", "last_day",
                   "trunc", "to_date"):
            return T.DATE
        if low == "unix_timestamp":
            return T.LONG
        if low == "months_between":
            return T.DOUBLE
        if low in ("lpad", "rpad", "initcap", "repeat", "reverse",
                   "translate", "split_part"):
            return T.STRING
        if low == "array":
            elem = expr_type(e.args[0]) if e.args else T.DOUBLE
            return T.ArrayType("array", elem)
        if low == "map":
            k = expr_type(e.args[0]) if e.args else T.STRING
            v = expr_type(e.args[1]) if len(e.args) > 1 else T.DOUBLE
            return T.MapType("map", k, v)
        if low in ("map_keys", "map_values"):
            at = expr_type(e.args[0])
            if isinstance(at, T.MapType):
                return T.ArrayType(
                    "array", at.key if low == "map_keys" else at.value)
            return T.ArrayType("array", T.STRING)
        if low == "array_contains":
            return T.BOOLEAN
        if low == "named_struct":
            fields = []
            for i in range(0, len(e.args) - 1, 2):
                nm = e.args[i]
                fields.append((
                    str(nm.value) if isinstance(nm, ast.Lit) else f"c{i//2}",
                    expr_type(e.args[i + 1])))
            return T.StructType("struct", tuple(fields))
        if low == "element_at":
            at = expr_type(e.args[0])
            if isinstance(at, T.ArrayType):
                return at.element
            if isinstance(at, T.MapType):
                return at.value
            if isinstance(at, T.StructType) and \
                    isinstance(e.args[1], ast.Lit):
                ft = at.field_type(str(e.args[1].value))
                if ft is not None:
                    return ft
            return T.STRING
        if low in ("substr", "substring", "upper", "lower", "trim", "concat",
                   "ltrim", "rtrim", "replace"):
            return T.STRING
        if low in ("sqrt", "exp", "ln", "log", "pow", "power", "round",
                   "sign"):
            return T.DOUBLE
        if low == "nullif":
            return expr_type(e.args[0])
        if low in ("floor", "ceil", "ceiling"):
            return T.LONG
        if low in ("mod", "pmod", "greatest", "least"):
            t = expr_type(e.args[0])
            for a in e.args[1:]:
                t = T.common_type(t, expr_type(a))
            return t
        if e.dtype is not None:
            return e.dtype
        raise AnalysisError(f"unknown function: {e.name}")
    raise AnalysisError(f"cannot type expression {e!r}")


def fold_constants(e: ast.Expr) -> ast.Expr:
    """Evaluate literal-only subtrees (ref TokenizedLiteralFolding)."""

    def fold(node: ast.Expr) -> ast.Expr:
        if isinstance(node, ast.BinOp) and isinstance(node.left, ast.Lit) \
                and isinstance(node.right, ast.Lit) \
                and node.left.value is not None and node.right.value is not None:
            a, b = node.left.value, node.right.value
            try:
                v = {
                    "+": lambda: a + b, "-": lambda: a - b,
                    "*": lambda: a * b, "%": lambda: a % b,
                    "/": lambda: a / b if not (
                        isinstance(a, int) and isinstance(b, int)) else a / b,
                }[node.op]()
            except (KeyError, ZeroDivisionError):
                return node
            dt = node.left.dtype or node.right.dtype
            if node.left.dtype and node.right.dtype \
                    and node.left.dtype != node.right.dtype:
                try:
                    dt = T.common_type(node.left.dtype, node.right.dtype)
                except TypeError:
                    dt = None
            if isinstance(v, float) and dt is not None and T.is_integral(dt):
                dt = T.DOUBLE
            return ast.Lit(v, dt)
        if isinstance(node, ast.UnaryOp) and node.op == "neg" \
                and isinstance(node.child, ast.Lit) \
                and node.child.value is not None:
            return ast.Lit(-node.child.value, node.child.dtype)
        if isinstance(node, ast.Cast) and isinstance(node.child, ast.Lit):
            return ast.Lit(T.python_value(node.to, node.child.value), node.to)
        return node

    return ast.transform(e, fold)


class Analyzer:
    """Single-pass resolver. `catalog` must provide lookup_table(name) ->
    object with .schema/.name and lookup_view(name) -> Optional[Plan]."""

    def __init__(self, catalog):
        self.catalog = catalog

    # --- plans -----------------------------------------------------------

    def analyze_plan(self, plan: ast.Plan) -> Tuple[ast.Plan, Scope]:
        # ROLLUP/CUBE/GROUPING SETS expand HERE, not in the session, so
        # the rewrite also reaches view bodies and subquery plans (review
        # finding: a view over a ROLLUP silently lost its total rows)
        if isinstance(plan, ast.Filter) and \
                isinstance(plan.child, ast.Aggregate) and \
                plan.child.grouping_sets:
            return self.analyze_plan(
                self._expand_grouping(plan.child, plan.condition))
        if isinstance(plan, ast.Aggregate) and plan.grouping_sets:
            return self.analyze_plan(self._expand_grouping(plan, None))
        if isinstance(plan, ast.UnresolvedRelation):
            view = self.catalog.lookup_view(plan.name)
            if view is not None:
                child, scope = self.analyze_plan(view)
                alias = plan.alias or plan.name.split(".")[-1]
                scope = Scope([dataclasses.replace(e, qualifier=alias)
                               for e in scope.entries])
                return ast.SubqueryAlias(child, alias), scope
            info = self.catalog.lookup_table(plan.name)
            if info is None:
                raise AnalysisError(f"table or view not found: {plan.name}")
            alias = plan.alias or plan.name.split(".")[-1]
            scope = Scope([ScopeEntry(alias, f.name, f.dtype, f.nullable,
                                      hidden=f.name.startswith("__"))
                           for f in info.schema.fields])
            resolved: ast.Plan = ast.Relation(info.name, info.schema, alias)
            # row-level security: inject policy predicates AT RESOLUTION so
            # every path to the table — including through views, which are
            # re-analyzed per query — is filtered (ref: RowLevelSecurity
            # rule, SnappySessionState.scala:422)
            for pol_table, pred in getattr(self.catalog, "_policies",
                                           {}).values():
                if pol_table == info.name:
                    cond = fold_constants(self.resolve_expr(pred, scope))
                    resolved = ast.Filter(resolved, cond)
            return resolved, scope

        if isinstance(plan, ast.Relation):
            # already-resolved scan (stored view bodies re-enter analysis);
            # resolution is idempotent
            alias = plan.alias or plan.name.split(".")[-1]
            scope = Scope([ScopeEntry(alias, f.name, f.dtype, f.nullable,
                                      hidden=f.name.startswith("__"))
                           for f in plan.schema.fields])
            return plan, scope

        if isinstance(plan, ast.SubqueryAlias):
            child, scope = self.analyze_plan(plan.child)
            scope = Scope([dataclasses.replace(e, qualifier=plan.alias)
                           for e in scope.entries])
            return ast.SubqueryAlias(child, plan.alias), scope

        if isinstance(plan, ast.Values):
            rows = tuple(tuple(fold_constants(self.resolve_expr(e, Scope([])))
                               for e in row) for row in plan.rows)
            first = rows[0]
            entries = [ScopeEntry(None, f"col{i + 1}", expr_type(e))
                       for i, e in enumerate(first)]
            return ast.Values(rows), Scope(entries)

        if isinstance(plan, ast.Filter):
            child, scope = self.analyze_plan(plan.child)
            if isinstance(child, ast.Aggregate) and ast.is_aggregate(
                    plan.condition):
                return self._resolve_having(plan.condition, child, scope)
            cond = fold_constants(self.resolve_expr(plan.condition, scope))
            if expr_type(cond).name != "boolean":
                raise AnalysisError("WHERE/HAVING must be boolean")
            return ast.Filter(child, cond), scope

        if isinstance(plan, ast.Project):
            child, scope = self.analyze_plan(plan.child)
            exprs = self._resolve_select_list(plan.exprs, scope)
            out_scope = Scope([ScopeEntry(None, _expr_name(e), expr_type(e))
                               for e in exprs])
            if any(any(isinstance(x, ast.WindowFunc) for x in ast.walk(e))
                   for e in exprs):
                return ast.WindowProject(child, tuple(exprs)), out_scope
            return ast.Project(child, tuple(exprs)), out_scope

        if isinstance(plan, ast.Aggregate):
            child, scope = self.analyze_plan(plan.child)
            groups = tuple(fold_constants(self.resolve_expr(g, scope))
                           for g in plan.group_exprs)
            # allow GROUP BY <ordinal> and GROUP BY <select alias>
            select = self._resolve_select_list(plan.agg_exprs, scope,
                                               allow_missing=True)
            groups = tuple(self._bind_group_expr(g, select) for g in groups)
            self._check_agg(select, groups)
            out_scope = Scope([ScopeEntry(None, _expr_name(e), expr_type(e))
                               for e in select])
            return ast.Aggregate(child, groups, tuple(select)), out_scope

        if isinstance(plan, ast.Join):
            left, ls = self.analyze_plan(plan.left)
            right, rs = self.analyze_plan(plan.right)
            joint = Scope(ls.entries + rs.entries)
            cond = None
            if plan.condition is not None:
                cond = fold_constants(self.resolve_expr(plan.condition, joint))
                if expr_type(cond).name != "boolean":
                    raise AnalysisError("JOIN condition must be boolean")
            how = plan.how
            if how == "cross" and cond is not None:
                how = "inner"
            out = joint if how not in ("semi", "anti") else ls
            return ast.Join(left, right, how, cond), out

        if isinstance(plan, ast.Sort):
            child, scope = self.analyze_plan(plan.child)
            orders = []
            hidden: List[ast.Expr] = []
            for e, asc, *rest in plan.orders:
                nf = rest[0] if rest else None
                try:
                    orders.append(
                        (self._resolve_order_expr(e, scope, child), asc,
                         nf))
                except AnalysisError:
                    # ORDER BY an input column absent from the select list:
                    # append a hidden projection, sort, then trim
                    if not isinstance(child, (ast.Project,
                                              ast.WindowProject)):
                        raise
                    in_scope = Scope(self._scope_of(child.child))
                    resolved = fold_constants(self.resolve_expr(e, in_scope))
                    hidden.append(resolved)
                    orders.append((ast.Col(
                        f"__sort{len(hidden) - 1}", None,
                        len(child.exprs) + len(hidden) - 1,
                        expr_type(resolved)), asc, nf))
            if hidden:
                widened_cls = type(child)
                widened = widened_cls(
                    child.child, child.exprs + tuple(
                        ast.Alias(h, f"__sort{j}")
                        for j, h in enumerate(hidden)))
                visible = tuple(
                    ast.Col(s.name, None, i, s.dtype)
                    for i, s in enumerate(scope.entries))
                return ast.Project(ast.Sort(widened, tuple(orders)),
                                   visible), scope
            return ast.Sort(child, tuple(orders)), scope

        if isinstance(plan, ast.Limit):
            child, scope = self.analyze_plan(plan.child)
            return ast.Limit(child, plan.n), scope

        if isinstance(plan, ast.Distinct):
            child, scope = self.analyze_plan(plan.child)
            return ast.Distinct(child), scope

        if isinstance(plan, ast.Union):
            left, ls = self.analyze_plan(plan.left)
            right, rs = self.analyze_plan(plan.right)
            if len(ls.entries) != len(rs.entries):
                raise AnalysisError("UNION children must have equal arity")
            return ast.Union(left, right, plan.all), \
                _widen_branch_scope(ls, rs)

        if isinstance(plan, ast.SetOp):
            left, ls = self.analyze_plan(plan.left)
            right, rs = self.analyze_plan(plan.right)
            if len(ls.entries) != len(rs.entries):
                raise AnalysisError(
                    f"{plan.op.upper()} children must have equal arity")
            return ast.SetOp(left, right, plan.op), \
                _widen_branch_scope(ls, rs)

        raise AnalysisError(f"cannot analyze plan node {type(plan).__name__}")

    def _resolve_having(self, cond: ast.Expr, agg: ast.Aggregate,
                        out_scope: Scope):
        """HAVING with aggregate calls: resolve against the aggregate's
        INPUT, then rewrite each aggregate/group subexpression to a
        reference into the select list — appending hidden columns for
        aggregates the select list doesn't already compute (projected away
        afterwards)."""
        in_scope = Scope(self._scope_of(agg.child))
        resolved = fold_constants(self.resolve_expr(cond, in_scope))
        bases = [e.child if isinstance(e, ast.Alias) else e
                 for e in agg.agg_exprs]
        hidden: List[ast.Expr] = []

        def repl(e: ast.Expr) -> ast.Expr:
            if (isinstance(e, ast.Func) and e.name in ast.AGG_FUNCS) \
                    or any(e == g for g in agg.group_exprs):
                for i, b in enumerate(bases):
                    if e == b:
                        return ast.Col(_expr_name(agg.agg_exprs[i]), None, i,
                                       expr_type(b))
                for j, h in enumerate(hidden):
                    if e == h:
                        return ast.Col(f"__having{j}", None,
                                       len(bases) + j, expr_type(h))
                hidden.append(e)
                return ast.Col(f"__having{len(hidden) - 1}", None,
                               len(bases) + len(hidden) - 1, expr_type(e))
            return e.map_children(repl)

        rewritten = repl(resolved)
        if expr_type(rewritten).name != "boolean":
            raise AnalysisError("HAVING must be boolean")
        if hidden:
            new_agg = ast.Aggregate(
                agg.child, agg.group_exprs,
                agg.agg_exprs + tuple(
                    ast.Alias(h, f"__having{j}")
                    for j, h in enumerate(hidden)))
            filtered = ast.Filter(new_agg, rewritten)
            visible = tuple(
                ast.Col(e.name, None, i, e.dtype)
                for i, e in enumerate(out_scope.entries))
            return ast.Project(filtered, visible), out_scope
        return ast.Filter(agg, rewritten), out_scope

    # --- expressions -----------------------------------------------------

    def _expand_grouping(self, agg: ast.Aggregate, having) -> ast.Plan:
        """ROLLUP/CUBE/GROUPING SETS → UNION ALL of plain aggregates with
        NULL-filled absent keys (ref: Spark's Expand-node lowering, which
        SnappyData inherits). The full grouping set comes first so the
        union's output names/types anchor there; a HAVING directly above
        applies per variant. Absent keys become NULLs in a PROJECT above
        each aggregate — constant select items inside a grouped aggregate
        are a shape hazard — and real exprs are renamed __gsN inside so
        the project references them unambiguously."""
        base_agg = dataclasses.replace(agg, grouping_sets=None)
        resolved, _ = self.analyze_plan(base_agg)
        gtypes = [expr_type(g) for g in resolved.group_exprs]
        variants = []
        for sset in agg.grouping_sets:
            keep = set(sset)

            def gone_idx(e):
                """index of the absent group expr this item IS."""
                b = e.child if isinstance(e, ast.Alias) else e
                for gi, g in enumerate(agg.group_exprs):
                    if b == g and gi not in keep:
                        return gi
                return None

            def repl(e):
                for gi, g in enumerate(agg.group_exprs):
                    if e == g and gi not in keep:
                        return ast.Cast(ast.Lit(None), gtypes[gi])
                return e.map_children(repl)

            inner, outer_items = [], []
            for i, e in enumerate(agg.agg_exprs):
                name = _expr_name(e)
                gi = gone_idx(e)
                if gi is not None:
                    outer_items.append(
                        ast.Alias(ast.Cast(ast.Lit(None), gtypes[gi]),
                                  name))
                    continue
                b = e.child if isinstance(e, ast.Alias) else e
                inner.append(ast.Alias(repl(b), f"__gs{i}"))
                outer_items.append(ast.Alias(ast.Col(f"__gs{i}"), name))
            v: ast.Plan = ast.Aggregate(
                agg.child,
                tuple(agg.group_exprs[i] for i in sset),
                tuple(inner))
            if having is not None:
                v = ast.Filter(v, repl(having))
            variants.append(ast.Project(v, tuple(outer_items)))
        merged = variants[0]
        for v in variants[1:]:
            merged = ast.Union(merged, v, all=True)
        return merged

    def resolve_expr(self, e: ast.Expr, scope: Scope) -> ast.Expr:
        def rec(node: ast.Expr) -> ast.Expr:
            if isinstance(node, ast.Col):
                try:
                    idx, entry = scope.resolve(node.name, node.qualifier)
                except AnalysisError:
                    # bare SQL-standard CURRENT_DATE / CURRENT_TIMESTAMP
                    # (no parens) parse as columns; a REAL column of that
                    # name wins, otherwise fold like the call form
                    if node.qualifier is None and node.name.lower() in (
                            "current_date", "current_timestamp"):
                        return rec(ast.Func(node.name.lower(), ()))
                    raise
                return ast.Col(entry.name, entry.qualifier, idx, entry.dtype)
            if isinstance(node, ast.Star):
                raise AnalysisError("* is only allowed in a select list")
            if isinstance(node, ast.Func) and not node.args and \
                    node.name in ("current_date", "current_timestamp",
                                  "now"):
                # folded PER EXECUTION (analysis runs on every sql() call,
                # cache hit or not) into a plain literal, which tokenizes
                # into a rebound parameter — a cached plan never bakes a
                # stale clock (same mechanism as the stream-window cutoff)
                import time as _time

                now = _time.time()
                if node.name == "current_date":
                    return ast.Lit(int(now // 86400), T.DATE)
                return ast.Lit(int(now * 1_000_000), T.TIMESTAMP)
            out = node.map_children(rec)
            if isinstance(out, ast.Func) and out.dtype is None:
                from snappydata_tpu_torch.sql import udf as _udf

                u = _udf.lookup(out.name)
                if u is not None:
                    # SQL-registered function: stamp its return type so
                    # expr_type resolves without a registry lookup
                    out = dataclasses.replace(
                        out, dtype=u.returns or T.DOUBLE)
            return out

        return rec(e)

    def _resolve_select_list(self, exprs, scope: Scope,
                             allow_missing: bool = False) -> List[ast.Expr]:
        out: List[ast.Expr] = []
        for e in exprs:
            if isinstance(e, ast.Star):
                qual = e.qualifier.lower() if e.qualifier else None
                for i, entry in enumerate(scope.entries):
                    if entry.hidden:
                        continue  # internal BASE-TABLE columns only —
                        # user '__' select aliases still expand
                    if qual is None or (entry.qualifier or "").lower() == qual:
                        out.append(ast.Col(entry.name, entry.qualifier, i,
                                           entry.dtype))
                continue
            out.append(fold_constants(self.resolve_expr(e, scope)))
        return out

    def _bind_group_expr(self, g: ast.Expr, select: List[ast.Expr]) -> ast.Expr:
        # GROUP BY ordinal (1-based) refers to the select list
        if isinstance(g, ast.Lit) and isinstance(g.value, int) \
                and not isinstance(g.value, bool):
            k = g.value
            if 1 <= k <= len(select):
                e = select[k - 1]
                return e.child if isinstance(e, ast.Alias) else e
        return g

    def _check_agg(self, select: List[ast.Expr], groups) -> None:
        group_set = {g for g in groups}

        def ok(e: ast.Expr) -> bool:
            base = e.child if isinstance(e, ast.Alias) else e
            if base in group_set or isinstance(base, (ast.Lit, ast.ParamLiteral)):
                return True
            if isinstance(base, ast.Func) and base.name in ast.AGG_FUNCS:
                return True
            if isinstance(base, ast.Col):
                return base in group_set
            return all(ok(c) for c in base.children()) and bool(base.children())

        for e in select:
            if not ok(e):
                raise AnalysisError(
                    f"expression {_expr_name(e)} is neither grouped nor aggregated")

    def _resolve_order_expr(self, e: ast.Expr, scope: Scope,
                            child: ast.Plan) -> ast.Expr:
        # ORDER BY ordinal
        if isinstance(e, ast.Lit) and isinstance(e.value, int) \
                and not isinstance(e.value, bool):
            k = e.value
            if 1 <= k <= len(scope.entries):
                entry = scope.entries[k - 1]
                return ast.Col(entry.name, entry.qualifier, k - 1, entry.dtype)
        try:
            return self.resolve_expr(e, scope)
        except AnalysisError:
            # output-NAME match: ORDER BY year(d) over a union/rollup whose
            # output column is literally named "year(d)" — the inputs are
            # gone, only the output name survives. Never for plain Cols
            # (they have real resolution + hidden-projection handling),
            # and only on a UNIQUE match.
            if not isinstance(e, ast.Col):
                nm = _expr_name(e).lower()
                hits = [(i, entry) for i, entry in enumerate(scope.entries)
                        if entry.name.lower() == nm]
                if len(hits) == 1:
                    i, entry = hits[0]
                    return ast.Col(entry.name, entry.qualifier, i,
                                   entry.dtype)
            # structural match against aggregate/project output, e.g.
            # ORDER BY sum(x) when select list has Alias(sum(x), 'revenue')
            if isinstance(child, (ast.Aggregate, ast.Project)):
                outs = child.agg_exprs if isinstance(child, ast.Aggregate) \
                    else child.exprs
                target = fold_constants(self.resolve_expr(
                    e, self._child_scope(child)))
                for i, oe in enumerate(outs):
                    base = oe.child if isinstance(oe, ast.Alias) else oe
                    if base == target:
                        entry = scope.entries[i]
                        return ast.Col(entry.name, entry.qualifier, i,
                                       entry.dtype)
            raise

    def _child_scope(self, plan: ast.Plan) -> Scope:
        """Scope of a resolved plan's input (for late order-by binding)."""
        child = plan.children()[0]
        return Scope(self._scope_of(child))

    def _scope_of(self, plan: ast.Plan) -> List[ScopeEntry]:
        if isinstance(plan, ast.Relation):
            alias = plan.alias or plan.name
            return [ScopeEntry(alias, f.name, f.dtype, f.nullable,
                               hidden=f.name.startswith("__"))
                    for f in plan.schema.fields]
        if isinstance(plan, ast.SubqueryAlias):
            return [dataclasses.replace(e, qualifier=plan.alias)
                    for e in self._scope_of(plan.child)]
        if isinstance(plan, (ast.Project, ast.WindowProject)):
            return [ScopeEntry(None, _expr_name(e), expr_type(e))
                    for e in plan.exprs]
        if isinstance(plan, ast.Aggregate):
            return [ScopeEntry(None, _expr_name(e), expr_type(e))
                    for e in plan.agg_exprs]
        if isinstance(plan, (ast.Filter, ast.Sort, ast.Limit, ast.Distinct)):
            return self._scope_of(plan.children()[0])
        if isinstance(plan, ast.Join):
            if plan.how in ("semi", "anti"):
                return self._scope_of(plan.left)
            return self._scope_of(plan.left) + self._scope_of(plan.right)
        if isinstance(plan, (ast.Union, ast.SetOp)):
            return self._scope_of(plan.left)
        if isinstance(plan, ast.Values):
            return [ScopeEntry(None, f"col{i + 1}", expr_type(e))
                    for i, e in enumerate(plan.rows[0])]
        raise AnalysisError(f"no scope for {type(plan).__name__}")


# --------------------------------------------------------------------------
# Literal tokenization (plan-cache key normalization)
# --------------------------------------------------------------------------

# literal args of these functions stay literal under tokenization: they
# derive string dictionaries at compile time (see exprs._emit_string_func)
_STRUCTURAL_LIT_FUNCS = frozenset(
    {"substr", "substring", "replace", "instr", "concat", "trunc",
     "lpad", "rpad", "repeat", "translate", "split_part"})


def tokenize_plan(plan: ast.Plan) -> Tuple[ast.Plan, Tuple[Any, ...]]:
    """Replace every Lit in expression position with ParamLiteral(pos),
    collecting values — the tokenized plan is the plan-cache key and the
    values are runtime inputs (ref: ParamLiteral/replaceParamLiterals,
    SnappySession.scala:2631). Values rows and LIMIT counts stay literal
    (they determine shapes/table contents, not expression scalars)."""
    params: List[Any] = []

    def tok_expr(e: ast.Expr) -> ast.Expr:
        def rec(node: ast.Expr) -> ast.Expr:
            if isinstance(node, ast.Func) and node.name == "element_at" \
                    and len(node.args) == 2:
                # a STRUCT field name is STRUCTURAL (it selects a device
                # plate at compile time) — map keys / array indexes stay
                # tokenized so they rebind without recompiles
                try:
                    structural = isinstance(expr_type(node.args[0]),
                                            T.StructType)
                except Exception:
                    structural = False
                if structural:
                    return dataclasses.replace(node, args=(
                        rec(node.args[0]), node.args[1]))
            if isinstance(node, ast.Func) and \
                    node.name in _STRUCTURAL_LIT_FUNCS:
                # these functions' literal args are STRUCTURAL (they shape
                # derived string dictionaries, like a LIKE pattern) — a
                # tokenized substr(s, 2) rebound to substr(s, 3) would
                # silently reuse the start=2 derived dictionary
                return dataclasses.replace(node, args=tuple(
                    a if isinstance(a, ast.Lit) else rec(a)
                    for a in node.args))
            if isinstance(node, ast.Lit) and node.value is not None:
                params.append(T.python_value(node.dtype, node.value)
                              if node.dtype else node.value)
                return ast.ParamLiteral(len(params) - 1, node.dtype)
            return node.map_children(rec)

        return rec(e)

    def tok(p: ast.Plan) -> ast.Plan:
        if isinstance(p, ast.Filter):
            return ast.Filter(tok(p.child), tok_expr(p.condition))
        if isinstance(p, ast.WindowProject):
            return ast.WindowProject(tok(p.child),
                                     tuple(tok_expr(e) for e in p.exprs))
        if isinstance(p, ast.Project):
            return ast.Project(tok(p.child), tuple(tok_expr(e) for e in p.exprs))
        if isinstance(p, ast.Aggregate):
            # tokenize group exprs FIRST, then substitute each occurrence
            # of a group expr inside the select list with its tokenized
            # twin — otherwise GROUP BY age/10 and select-list age/10 get
            # different param slots and no longer match structurally
            # (breaking the key-reference rewrite at compile time)
            groups_src = p.group_exprs
            groups_tok = tuple(tok_expr(g) for g in groups_src)

            def sub_groups(e: ast.Expr) -> ast.Expr:
                for gs, gt in zip(groups_src, groups_tok):
                    if e == gs:
                        return gt
                return e.map_children(sub_groups)

            return ast.Aggregate(
                tok(p.child), groups_tok,
                tuple(tok_expr(sub_groups(e)) for e in p.agg_exprs))
        if isinstance(p, ast.Join):
            cond = tok_expr(p.condition) if p.condition is not None else None
            return ast.Join(tok(p.left), tok(p.right), p.how, cond)
        if isinstance(p, ast.Sort):
            return ast.Sort(tok(p.child),
                            tuple((tok_expr(o[0]),) + tuple(o[1:])
                                  for o in p.orders))
        if isinstance(p, ast.Limit):
            return ast.Limit(tok(p.child), p.n)
        if isinstance(p, ast.Distinct):
            return ast.Distinct(tok(p.child))
        if isinstance(p, ast.Union):
            return ast.Union(tok(p.left), tok(p.right), p.all)
        if isinstance(p, ast.SetOp):
            return ast.SetOp(tok(p.left), tok(p.right), p.op)
        if isinstance(p, ast.SubqueryAlias):
            return ast.SubqueryAlias(tok(p.child), p.alias)
        return p

    return assign_param_positions(tok(plan), len(params)), tuple(params)


def assign_param_positions(plan: ast.Plan, offset: int) -> ast.Plan:
    """Number prepared-statement '?' params in deterministic DFS order,
    offset past the tokenized literals (execution-time params tuple is
    lit_values + user_values)."""
    counter = [offset]

    def fix_expr(e: ast.Expr) -> ast.Expr:
        def rec(node: ast.Expr) -> ast.Expr:
            if isinstance(node, ast.Param) and node.pos < 0:
                p = ast.Param(counter[0], node.dtype)
                counter[0] += 1
                return p
            return node.map_children(rec)

        return rec(e)

    def fix(p: ast.Plan) -> ast.Plan:
        if isinstance(p, ast.Filter):
            return ast.Filter(fix(p.child), fix_expr(p.condition))
        if isinstance(p, ast.WindowProject):
            return ast.WindowProject(fix(p.child),
                                     tuple(fix_expr(e) for e in p.exprs))
        if isinstance(p, ast.Project):
            return ast.Project(fix(p.child),
                               tuple(fix_expr(e) for e in p.exprs))
        if isinstance(p, ast.Aggregate):
            return ast.Aggregate(fix(p.child),
                                 tuple(fix_expr(g) for g in p.group_exprs),
                                 tuple(fix_expr(e) for e in p.agg_exprs))
        if isinstance(p, ast.Join):
            cond = fix_expr(p.condition) if p.condition is not None else None
            return ast.Join(fix(p.left), fix(p.right), p.how, cond)
        if isinstance(p, ast.Sort):
            return ast.Sort(fix(p.child),
                            tuple((fix_expr(o[0]),) + tuple(o[1:])
                                  for o in p.orders))
        if isinstance(p, ast.Limit):
            return ast.Limit(fix(p.child), p.n)
        if isinstance(p, ast.Distinct):
            return ast.Distinct(fix(p.child))
        if isinstance(p, ast.Union):
            return ast.Union(fix(p.left), fix(p.right), p.all)
        if isinstance(p, ast.SetOp):
            return ast.SetOp(fix(p.left), fix(p.right), p.op)
        if isinstance(p, ast.SubqueryAlias):
            return ast.SubqueryAlias(fix(p.child), p.alias)
        if isinstance(p, ast.Values):
            return ast.Values(tuple(tuple(fix_expr(e) for e in row)
                                    for row in p.rows))
        return p

    return fix(plan)
