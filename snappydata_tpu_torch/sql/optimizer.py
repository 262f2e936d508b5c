"""Pre-analysis logical optimizer.

Plays the role of the reference's planning rules (OrderJoinConditions,
SnappySessionState.scala:326, splicing ReorderJoin :151; predicate
pushdown comes from Catalyst in the reference): operates on the UNRESOLVED
tree, using catalog row counts, so that name resolution needn't be redone:

1. Flatten comma/cross-join chains + WHERE conjuncts.
2. Push single-table conjuncts down to their relation (Filter-over-scan).
3. Left-deep join tree ordered by estimated size descending — the biggest
   table becomes the probe side, small (dimension) tables become build
   sides, matching the reference's replicated/broadcast hash join choice
   (HashJoinExec, HashJoinStrategies size threshold 100MB).
4. Attach each equi conjunct at the lowest join covering its tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from snappydata_tpu_torch.sql import ast


def optimize(plan: ast.Plan, catalog) -> ast.Plan:
    if isinstance(plan, ast.Sort):
        return dataclasses.replace(plan, child=optimize(plan.child, catalog),
                                   orders=plan.orders)
    if isinstance(plan, ast.Limit):
        return ast.Limit(optimize(plan.child, catalog), plan.n)
    if isinstance(plan, ast.Distinct):
        return ast.Distinct(optimize(plan.child, catalog))
    if isinstance(plan, ast.SetOp):
        return ast.SetOp(optimize(plan.left, catalog),
                         optimize(plan.right, catalog), plan.op)
    if isinstance(plan, ast.Union):
        return ast.Union(optimize(plan.left, catalog),
                         optimize(plan.right, catalog), plan.all)
    if isinstance(plan, ast.Aggregate):
        return ast.Aggregate(optimize(plan.child, catalog),
                             plan.group_exprs, plan.agg_exprs,
                             grouping_sets=plan.grouping_sets)
    if isinstance(plan, ast.Project):
        return ast.Project(optimize(plan.child, catalog), plan.exprs)
    if isinstance(plan, ast.WindowProject):
        return ast.WindowProject(optimize(plan.child, catalog), plan.exprs)
    if isinstance(plan, ast.Filter):
        return _optimize_filter(plan, catalog)
    if isinstance(plan, ast.Join):
        return dataclasses.replace(
            plan, left=optimize(plan.left, catalog),
            right=optimize(plan.right, catalog))
    if isinstance(plan, ast.SubqueryAlias):
        return ast.SubqueryAlias(optimize(plan.child, catalog), plan.alias)
    return plan


def _optimize_filter(plan: ast.Filter, catalog) -> ast.Plan:
    got = _join_factors(plan.child)
    if got is None:
        return ast.Filter(optimize(plan.child, catalog), plan.condition)
    factors, join_conds = got

    conjuncts: List[ast.Expr] = list(join_conds)
    _flatten_and(plan.condition, conjuncts)

    # name map: alias → set of column names (lowered)
    col_map: Dict[str, Set[str]] = {}
    sizes: Dict[str, int] = {}
    for f in factors:
        alias, cols, size = _factor_info(f, catalog)
        if alias is None or alias in col_map:
            # unknown factor or duplicate alias (self-join without distinct
            # aliases) — leave the tree alone rather than collapse factors
            return ast.Filter(optimize(plan.child, catalog), plan.condition)
        col_map[alias] = cols
        sizes[alias] = size

    def tables_of(e: ast.Expr) -> Optional[Set[str]]:
        out: Set[str] = set()
        for node in ast.walk(e):
            if isinstance(node, ast.Col):
                if node.qualifier:
                    q = node.qualifier.lower()
                    if q not in col_map:
                        return None
                    out.add(q)
                    continue
                hits = [a for a, cols in col_map.items()
                        if node.name.lower() in cols]
                if len(hits) != 1:
                    return None
                out.add(hits[0])
        return out

    single: Dict[str, List[ast.Expr]] = {}
    multi: List[Tuple[Set[str], ast.Expr]] = []
    residual: List[ast.Expr] = []
    for c in conjuncts:
        tabs = tables_of(c)
        if tabs is None:
            residual.append(c)
        elif len(tabs) == 1:
            single.setdefault(next(iter(tabs)), []).append(c)
        else:
            multi.append((tabs, c))

    # build filtered factors, order by size descending (probe side first)
    by_alias = {}
    for f in factors:
        alias, _, _ = _factor_info(f, catalog)
        # derived-table factors carry their own filter/join trees:
        # optimize them in their own scope before placement
        node: ast.Plan = f if isinstance(f, ast.UnresolvedRelation) \
            else optimize(f, catalog)
        if alias in single:
            cond = _and_all(single[alias])
            node = ast.Filter(node, cond)
        by_alias[alias] = node
    order = sorted(by_alias, key=lambda a: -sizes[a])

    tree = by_alias[order[0]]
    placed: Set[str] = {order[0]}
    pending = list(multi)
    for alias in order[1:]:
        placed.add(alias)
        cond_here: List[ast.Expr] = []
        rest = []
        for tabs, c in pending:
            if tabs <= placed:
                cond_here.append(c)
            else:
                rest.append((tabs, c))
        pending = rest
        if cond_here:
            tree = ast.Join(tree, by_alias[alias], "inner",
                            _and_all(cond_here))
        else:
            tree = ast.Join(tree, by_alias[alias], "cross", None)
    leftover = [c for _, c in pending] + residual
    if leftover:
        tree = ast.Filter(tree, _and_all(leftover))
    return tree


def _join_factors(plan: ast.Plan):
    """Flatten a cross/INNER join chain into (factors, lifted ON
    conditions); None when the subtree isn't such a chain (outer/semi
    trees are kept intact). Inner-join ON conditions are safe to lift
    into the conjunct pool — inner join ≡ cross + filter — which lets
    `FROM a, b, c JOIN (subquery) s ON …` shapes reorder too (round-4
    finding: Q2's re-rendered distributed plan kept a 5-way cross join
    under the WHERE, exploding the host fallback)."""
    if isinstance(plan, ast.Join) and plan.how in ("cross", "inner"):
        left = _join_factors(plan.left)
        right = _join_factors(plan.right)
        if left is not None and right is not None:
            conds = left[1] + right[1]
            if plan.condition is not None:
                _flatten_and(plan.condition, conds)
            return left[0] + right[0], conds
        return None
    if isinstance(plan, (ast.UnresolvedRelation, ast.SubqueryAlias)):
        return [plan], []
    return None


def _factor_info(f: ast.Plan, catalog):
    if isinstance(f, ast.UnresolvedRelation):
        info = catalog.lookup_table(f.name)
        if info is None:
            return None, set(), 0
        alias = (f.alias or f.name.split(".")[-1]).lower()
        from snappydata_tpu_torch.storage.table_store import RowTableData

        size = info.data.count() if isinstance(info.data, RowTableData) \
            else info.data.snapshot().total_rows()
        return alias, {n.lower() for n in info.schema.names()}, size
    if isinstance(f, ast.SubqueryAlias):
        # derived table: alias + output columns are known; size is not —
        # rank it smallest so it lands on the build side
        cols = _subquery_out_cols(f.child)
        if cols is not None:
            return f.alias.lower(), cols, 0
        return None, set(), 0
    return None, set(), 0


def _subquery_out_cols(node: ast.Plan) -> Optional[Set[str]]:
    """Output column names of a derived table's top project/aggregate."""
    while isinstance(node, (ast.Sort, ast.Limit, ast.Distinct,
                            ast.SubqueryAlias)):
        node = node.children()[0]
    exprs = None
    if isinstance(node, ast.Project) or isinstance(node, ast.WindowProject):
        exprs = node.exprs
    elif isinstance(node, ast.Aggregate):
        exprs = node.agg_exprs
    if exprs is None:
        return None
    out: Set[str] = set()
    for e in exprs:
        if isinstance(e, ast.Alias):
            out.add(e.name.lower())
        elif isinstance(e, ast.Col):
            out.add(e.name.lower())
        else:
            return None  # unnamed computed column: bail on reordering
    return out


def _flatten_and(e: ast.Expr, out: List[ast.Expr]) -> None:
    if isinstance(e, ast.BinOp) and e.op == "and":
        _flatten_and(e.left, out)
        _flatten_and(e.right, out)
    else:
        out.append(e)


def _and_all(conds: List[ast.Expr]) -> ast.Expr:
    acc = conds[0]
    for c in conds[1:]:
        acc = ast.BinOp("and", acc, c)
    return acc
