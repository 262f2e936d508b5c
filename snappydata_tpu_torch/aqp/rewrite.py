"""Approximate-query rewrite: base table → stratified sample with unbiased
scale-up.

The reference's AQP engine rewrites aggregates over a base table to run on
a registered sample with error bounds (docs/aqp.md:43: SUM/AVG/COUNT
scope). Same scope here, on the UNRESOLVED plan (so normal analysis
applies afterwards):

  FROM base            → FROM sample
  sum(x)               → sum(x * snappy_sampler_weight)
  count(*) / count(x)  → round(sum-of-weights)  (HT estimator)
  avg(x)               → sum(x*w) / sum(w)      (self-normalized)

min/max pass through (sample min/max are the best available estimates).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from snappydata_tpu_torch.aqp.sampling import RESERVOIR_WEIGHT_COLUMN
from snappydata_tpu_torch.sql import ast


def approx_rewrite(plan: ast.Plan, catalog) -> Optional[ast.Plan]:
    """Rewrite `plan` to run on sample tables. Returns None when no
    relation in the plan has a registered sample."""
    samples = {}
    for info in catalog.list_tables():
        if info.provider == "sample" and info.base_table:
            samples.setdefault(info.base_table, info.name)
    if not samples:
        return None

    hit = [False]

    def rewrite_rel(p: ast.Plan) -> ast.Plan:
        if isinstance(p, ast.UnresolvedRelation):
            target = samples.get(p.name.lower())
            if target:
                hit[0] = True
                return ast.UnresolvedRelation(
                    target, alias=p.alias or p.name.split(".")[-1])
            return p
        if isinstance(p, ast.Aggregate):
            child = rewrite_rel(p.child)
            return ast.Aggregate(child, p.group_exprs,
                                 tuple(_scale(e) for e in p.agg_exprs),
                                 grouping_sets=p.grouping_sets)
        if isinstance(p, ast.Filter):
            return ast.Filter(rewrite_rel(p.child), p.condition)
        if isinstance(p, ast.Project):
            return ast.Project(rewrite_rel(p.child), p.exprs)
        if isinstance(p, ast.Join):
            return ast.Join(rewrite_rel(p.left), rewrite_rel(p.right),
                            p.how, p.condition)
        if isinstance(p, ast.Sort):
            return ast.Sort(rewrite_rel(p.child), p.orders)
        if isinstance(p, ast.Limit):
            return ast.Limit(rewrite_rel(p.child), p.n)
        if isinstance(p, ast.Distinct):
            return ast.Distinct(rewrite_rel(p.child))
        if isinstance(p, ast.SubqueryAlias):
            return ast.SubqueryAlias(rewrite_rel(p.child), p.alias)
        if isinstance(p, ast.Union):
            return ast.Union(rewrite_rel(p.left), rewrite_rel(p.right),
                             p.all)
        return p

    weight = ast.Col(RESERVOIR_WEIGHT_COLUMN)

    def _scale(e: ast.Expr) -> ast.Expr:
        if isinstance(e, ast.Alias):
            return ast.Alias(_scale(e.child), e.name)
        if isinstance(e, ast.Func) and e.name == "sum":
            return ast.Func("sum", (ast.BinOp("*", e.args[0], weight),))
        if isinstance(e, ast.Func) and e.name in ("count",):
            # HT estimator: total ≈ Σ weights (count(x) ignores the arg's
            # nulls imperfectly here; documented approximation)
            return ast.Func("round", (ast.Func("sum", (weight,)),))
        if isinstance(e, ast.Func) and e.name == "avg":
            num = ast.Func("sum", (ast.BinOp("*", e.args[0], weight),))
            den = ast.Func("sum", (weight,))
            return ast.BinOp("/", num, den)
        return e.map_children(_scale)

    out = rewrite_rel(plan)
    return out if hit[0] else None
