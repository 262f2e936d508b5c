"""Render (unresolved) expression/plan ASTs back to SQL text.

Port of snappydata_tpu/sql/render.py (pure AST code, copied with its
imports rewritten).  The tiled scan renders its partial plan and its
merge select and re-parses them with the port's own parser; exact-decimal
literals render as plain numerals, so they round-trip.  Covers the
single-block SELECT shape (FROM/JOIN/WHERE/GROUP BY) plus the full
expression grammar.
"""

from __future__ import annotations

import datetime
from typing import List, Optional

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.sql import ast

_EPOCH = datetime.date(1970, 1, 1)


class RenderError(Exception):
    pass


def render_expr(e: ast.Expr) -> str:
    if isinstance(e, ast.Alias):
        return f"{render_expr(e.child)} AS {e.name}"
    if isinstance(e, ast.Col):
        return f"{e.qualifier}.{e.name}" if e.qualifier else e.name
    if isinstance(e, ast.Star):
        return f"{e.qualifier}.*" if e.qualifier else "*"
    if isinstance(e, ast.Lit):
        return _render_lit(e)
    if isinstance(e, ast.ParamLiteral):
        raise RenderError("tokenized literal in render (render pre-token)")
    if isinstance(e, ast.Param):
        return "?"
    if isinstance(e, ast.BinOp):
        op = {"and": "AND", "or": "OR"}.get(e.op, e.op)
        return f"({render_expr(e.left)} {op} {render_expr(e.right)})"
    if isinstance(e, ast.UnaryOp):
        if e.op == "not":
            return f"(NOT {render_expr(e.child)})"
        return f"(-{render_expr(e.child)})"
    if isinstance(e, ast.IsNull):
        return f"({render_expr(e.child)} IS " \
               f"{'NOT ' if e.negated else ''}NULL)"
    if isinstance(e, ast.InList):
        vals = ", ".join(render_expr(v) for v in e.values)
        neg = "NOT " if e.negated else ""
        return f"({render_expr(e.child)} {neg}IN ({vals}))"
    if isinstance(e, ast.Between):
        neg = "NOT " if e.negated else ""
        return (f"({render_expr(e.child)} {neg}BETWEEN "
                f"{render_expr(e.lo)} AND {render_expr(e.hi)})")
    if isinstance(e, ast.Like):
        neg = "NOT " if e.negated else ""
        pat = e.pattern.replace("'", "''")
        return f"({render_expr(e.child)} {neg}LIKE '{pat}')"
    if isinstance(e, ast.Case):
        parts = ["CASE"]
        for c, v in e.whens:
            parts.append(f"WHEN {render_expr(c)} THEN {render_expr(v)}")
        if e.otherwise is not None:
            parts.append(f"ELSE {render_expr(e.otherwise)}")
        parts.append("END")
        return " ".join(parts)
    if isinstance(e, ast.Cast):
        return f"CAST({render_expr(e.child)} AS {e.to.name})"
    if isinstance(e, ast.Func):
        if e.name == "count" and not e.args:
            return "count(*)"
        if e.name == "count_distinct":
            return f"count(DISTINCT {render_expr(e.args[0])})"
        args = ", ".join(render_expr(a) for a in e.args)
        return f"{e.name}({args})"
    if isinstance(e, ast.WindowFunc):
        if e.name == "count" and not e.args:
            call = "count(*)"
        else:
            call = f"{e.name}(" + \
                ", ".join(render_expr(a) for a in e.args) + ")"
        over = []
        if e.partition_by:
            over.append("PARTITION BY " + ", ".join(
                render_expr(p) for p in e.partition_by))
        if e.order_by:
            def _ord(o):
                sql = render_expr(o[0]) + ("" if o[1] else " DESC")
                nf = o[2] if len(o) > 2 else None
                if nf is not None:
                    sql += " NULLS FIRST" if nf else " NULLS LAST"
                return sql

            over.append("ORDER BY " + ", ".join(_ord(o)
                                                for o in e.order_by))
        return f"{call} OVER ({' '.join(over)})"
    if isinstance(e, ast.ScalarSubquery):
        return f"({render_plan(e.plan)})"
    if isinstance(e, ast.InSubquery):
        neg = "NOT " if e.negated else ""
        return f"({render_expr(e.child)} {neg}IN ({render_plan(e.plan)}))"
    if isinstance(e, ast.ExistsSubquery):
        neg = "NOT " if e.negated else ""
        return f"({neg}EXISTS ({render_plan(e.plan)}))"
    raise RenderError(f"cannot render {type(e).__name__}")


def _render_lit(e: ast.Lit) -> str:
    v = e.value
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if e.dtype is not None and e.dtype.name == "date":
        return f"DATE '{(_EPOCH + datetime.timedelta(days=int(v))).isoformat()}'"
    if isinstance(v, (int, float)):
        return repr(v)
    import decimal as _d

    if isinstance(v, _d.Decimal):
        # numeric literal, NOT a quoted string (subquery substitution
        # yields Decimal objects since the exact-decimal decode)
        return format(v, "f")
    escaped = str(v).replace("'", "''")
    return f"'{escaped}'"


def _desugar_semi_joins(p: ast.Plan) -> ast.Plan:
    """Semi/anti joins (from decorrelation) render as correlated
    [NOT] EXISTS filters — the textual inverse of the rewrite that made
    them, so the receiving server's own decorrelator restores them."""
    import dataclasses as _dc

    if isinstance(p, ast.Join) and p.how in ("semi", "anti"):
        left = _desugar_semi_joins(p.left)
        right = _desugar_semi_joins(p.right)
        inner = ast.Filter(right, p.condition) \
            if p.condition is not None else right
        return ast.Filter(
            left, ast.ExistsSubquery(inner, negated=(p.how == "anti")))
    kids = p.children()
    if not kids:
        return p
    if isinstance(p, (ast.Join, ast.Union, ast.SetOp)):
        return _dc.replace(p, left=_desugar_semi_joins(p.left),
                           right=_desugar_semi_joins(p.right))
    return _dc.replace(p, child=_desugar_semi_joins(kids[0]))


def render_plan(p: ast.Plan) -> str:
    """Render a single-block SELECT tree (Project|Aggregate over
    FROM-chain with optional Filter)."""
    select_list: Optional[List[ast.Expr]] = None
    group_by: List[ast.Expr] = []
    where: Optional[ast.Expr] = None
    having: Optional[ast.Expr] = None
    orders = []
    limit = None
    distinct = False

    node = _desugar_semi_joins(p)
    while True:
        if isinstance(node, ast.Limit):
            limit = node.n
            node = node.child
        elif isinstance(node, ast.Sort):
            orders = list(node.orders)
            node = node.child
        elif isinstance(node, ast.Distinct):
            distinct = True
            node = node.child
        else:
            break
    if isinstance(node, ast.Filter) and isinstance(node.child, ast.Aggregate):
        having = node.condition
        node = node.child
    if isinstance(node, ast.Aggregate):
        if node.grouping_sets:
            raise RenderError("cannot render GROUPING SETS")
        select_list = list(node.agg_exprs)
        group_by = list(node.group_exprs)
        node = node.child
    elif isinstance(node, (ast.Project, ast.WindowProject)):
        select_list = list(node.exprs)
        node = node.child
    while isinstance(node, ast.Filter):
        # stacked filters (decorrelated EXISTS above the base WHERE)
        # collapse into one conjunctive WHERE clause
        where = node.condition if where is None \
            else ast.BinOp("and", where, node.condition)
        node = node.child
    # hoist filters off the join spine into WHERE (decorrelation wraps
    # the original filtered FROM-chain in new joins); commutes for
    # inner/cross both sides and for the PRESERVED side of a left join
    hoisted: List[ast.Expr] = []

    def _hoist(n):
        import dataclasses as _dc

        if not isinstance(n, ast.Join):
            return n
        left, right = _hoist(n.left), _hoist(n.right)
        if n.how in ("inner", "cross", "left"):
            while isinstance(left, ast.Filter):
                hoisted.append(left.condition)
                left = _hoist(left.child)
        if n.how in ("inner", "cross"):
            while isinstance(right, ast.Filter):
                hoisted.append(right.condition)
                right = _hoist(right.child)
        return _dc.replace(n, left=left, right=right)

    node = _hoist(node)
    for c in hoisted:
        where = c if where is None else ast.BinOp("and", where, c)
    from_sql = _render_from(node)
    if select_list is None:
        select_list = [ast.Star()]
    parts = ["SELECT " + ("DISTINCT " if distinct else "") +
             ", ".join(render_expr(e) for e in select_list),
             "FROM " + from_sql]
    if where is not None:
        parts.append("WHERE " + render_expr(where))
    if group_by:
        parts.append("GROUP BY " + ", ".join(render_expr(g)
                                             for g in group_by))
    if having is not None:
        parts.append("HAVING " + render_expr(having))
    if orders:
        def _ord(o):
            sql = render_expr(o[0]) + ("" if o[1] else " DESC")
            nf = o[2] if len(o) > 2 else None
            if nf is not None:
                sql += " NULLS FIRST" if nf else " NULLS LAST"
            return sql

        parts.append("ORDER BY " + ", ".join(_ord(o) for o in orders))
    if limit is not None:
        parts.append(f"LIMIT {limit}")
    return " ".join(parts)


def _render_from(node: ast.Plan) -> str:
    if isinstance(node, ast.UnresolvedRelation):
        return f"{node.name} {node.alias}" if node.alias else node.name
    if isinstance(node, ast.SubqueryAlias):
        return f"({render_plan(node.child)}) {node.alias}"
    if isinstance(node, ast.Filter):
        # filtered factor (from pushdown): render as subquery
        base = node.child
        if isinstance(base, ast.UnresolvedRelation):
            alias = base.alias or base.name.split(".")[-1]
            return (f"(SELECT * FROM {base.name} WHERE "
                    f"{render_expr(node.condition)}) {alias}")
        # non-relation factor: full derived table (bare column names
        # survive; outer QUALIFIED references into it would not — those
        # shapes are hoisted into WHERE by render_plan instead)
        return (f"(SELECT * FROM {_render_from(base)} WHERE "
                f"{render_expr(node.condition)}) __f")
    if isinstance(node, ast.Join):
        left = _render_from(node.left)
        right = _render_from(node.right)
        if node.how == "cross" and node.condition is None:
            return f"{left}, {right}"
        how = {"inner": "JOIN", "left": "LEFT JOIN",
               "right": "RIGHT JOIN", "full": "FULL JOIN",
               "semi": "SEMI JOIN", "anti": "ANTI JOIN"}.get(node.how)
        if how is None or node.how in ("semi", "anti"):
            raise RenderError(f"cannot render join {node.how}")
        cond = f" ON {render_expr(node.condition)}" \
            if node.condition is not None else ""
        return f"{left} {how} {right}{cond}"
    raise RenderError(f"cannot render FROM {type(node).__name__}")
