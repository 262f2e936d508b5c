"""Partial-aggregate decomposition for the session's tiled scans.

Port of snappydata_tpu/engine/partial_agg.py (pure AST code, copied with
its imports rewritten).  One aggregate plan splits into (a) a PARTIAL
plan — per-tile group-by emitting decomposable slots
(sum/count/min/max/sumsq) — and (b) a MERGE select re-combining the
slots (avg = sum/count, stddev from the moments): the reference's
partial/final aggregation planning (SnappyAggregationStrategy,
SnappyStrategies.scala:464).

Contract the tiled scan's ON-DEVICE merge additionally relies on: every
partial item is either a bare `__g<i>` group alias or a single
decomposable aggregate `__p<i>` — never a composite expression — so a
partial-raw compile (executor.Compiler(partial_raw=True)) can tag each
output with its merge op (sum/min/max) and fold per-tile [G] partials
elementwise on device.  The merge select stays valid over ALREADY-MERGED
partials too: re-running sum/min/max over one row per group is the
identity, which is how the device-merged path reuses the same merge SQL.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from snappydata_tpu_torch.sql import ast


class NotDecomposableError(Exception):
    """Aggregate cannot be split into partial + merge phases."""


def merge_ref(slot: int, merge_fn: str) -> ast.Expr:
    return ast.Func(merge_fn, (ast.Col(f"__p{slot}"),))


def decompose_aggregate(agg: ast.Aggregate, having=None,
                        distinct_ok_cols=frozenset()):
    """→ (partial_plan, merged_select, n_slots, merged_having).

    `partial_plan` evaluates per shard/tile, emitting group exprs as
    __g0..__gN and slots as __p0..__pM; `merged_select` re-aggregates the
    gathered partials (referencing __g/__p columns) into the original
    output expressions. A HAVING predicate decomposes through the same
    slot table, so aggregates appearing only in HAVING get partial slots
    too.

    `distinct_ok_cols`: which count(DISTINCT col) arguments decompose —
    either a callable `Col -> bool` (preferred: the distributed layer
    resolves the column to its source table and answers True only when it
    is THAT table's hash partition key, so a replicated table's column
    merely sharing a name with a partition key is rejected), or a legacy
    set of lowercase bare column names. Decomposition is valid because
    equal partition-key values share a shard, so per-shard distinct sets
    are disjoint and their counts sum. Tiled scans must NOT pass this
    (a value can recur across tiles).
    """
    if callable(distinct_ok_cols):
        distinct_col_ok = distinct_ok_cols
    else:
        _names = {c.lower() for c in distinct_ok_cols}
        distinct_col_ok = lambda col: col.name.lower() in _names  # noqa: E731
    groups = list(agg.group_exprs)
    partial_items: List[ast.Expr] = []
    for gi, g in enumerate(groups):
        partial_items.append(ast.Alias(g, f"__g{gi}"))
    slots: List[Tuple[str, Optional[ast.Expr]]] = []

    def slot_of(kind, arg) -> int:
        for i, (k, a) in enumerate(slots):
            if k == kind and a == arg:
                return i
        slots.append((kind, arg))
        return len(slots) - 1

    def decompose(e: ast.Expr) -> ast.Expr:
        if isinstance(e, ast.Func) and e.name in ast.AGG_FUNCS:
            arg = e.args[0] if e.args else None
            if e.name == "count" and arg is None:
                return merge_ref(slot_of("count_star", None), "sum")
            if e.name == "count":
                return merge_ref(slot_of("count", arg), "sum")
            if e.name == "sum":
                return merge_ref(slot_of("sum", arg), "sum")
            if e.name == "min":
                return merge_ref(slot_of("min", arg), "min")
            if e.name == "max":
                return merge_ref(slot_of("max", arg), "max")
            if e.name == "avg":
                s = merge_ref(slot_of("sum", arg), "sum")
                c = merge_ref(slot_of("count", arg), "sum")
                return ast.BinOp("/", s, c)
            if e.name == "count_distinct":
                if isinstance(arg, ast.Col) and distinct_col_ok(arg):
                    return merge_ref(slot_of("count_distinct", arg),
                                     "sum")
                raise NotDecomposableError(
                    "count(DISTINCT x) only decomposes when the data is "
                    "hash-partitioned on x")
            if e.name in ("stddev", "variance"):
                s = merge_ref(slot_of("sum", arg), "sum")
                s2 = merge_ref(slot_of("sumsq", arg), "sum")
                c = merge_ref(slot_of("count", arg), "sum")
                mean = ast.BinOp("/", s, c)
                var = ast.BinOp("-", ast.BinOp("/", s2, c),
                                ast.BinOp("*", mean, mean))
                return var if e.name == "variance" else \
                    ast.Func("sqrt", (var,))
            raise NotDecomposableError(
                f"aggregate {e.name} not decomposable")
        for gi, g in enumerate(groups):
            if e == g:
                return ast.Col(f"__g{gi}")
        return e.map_children(decompose)

    merged_select: List[ast.Expr] = []
    for e in agg.agg_exprs:
        name = e.name if isinstance(e, ast.Alias) else None
        base = e.child if isinstance(e, ast.Alias) else e
        rewritten = decompose(base)
        merged_select.append(ast.Alias(rewritten, name)
                             if name else rewritten)

    merged_having = decompose(having) if having is not None else None

    for si, (kind, arg) in enumerate(slots):
        if kind == "count_star":
            partial_items.append(ast.Alias(ast.Func("count", ()),
                                           f"__p{si}"))
        elif kind == "sumsq":
            partial_items.append(ast.Alias(
                ast.Func("sum", (ast.BinOp("*", arg, arg),)),
                f"__p{si}"))
        elif kind == "count_distinct":
            partial_items.append(ast.Alias(
                ast.Func("count_distinct", (arg,)), f"__p{si}"))
        else:
            partial_items.append(ast.Alias(ast.Func(kind, (arg,)),
                                           f"__p{si}"))

    partial_plan = ast.Aggregate(agg.child, tuple(groups),
                                 tuple(partial_items))
    return partial_plan, merged_select, len(slots), merged_having



def ddl_type(dt) -> str:
    """T dtype → DDL string for scratch partial tables."""
    return {"string": "STRING", "int": "INT", "long": "BIGINT",
            "double": "DOUBLE", "float": "REAL", "boolean": "BOOLEAN",
            "date": "DATE", "timestamp": "TIMESTAMP", "short": "SMALLINT",
            "byte": "TINYINT", "decimal": "DOUBLE"}.get(dt.name, "DOUBLE")
