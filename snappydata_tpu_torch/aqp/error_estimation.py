"""Closed-form stratified error estimation — the "A" in AQP.

Implements the reference's High-level Accuracy Contract surface
(docs/sde/hac_contracts.md:38-82; hook surface
core/src/main/scala/org/apache/spark/sql/SnappyContextFunctions.scala:42-85):

* projection error functions `absolute_error(alias)`,
  `relative_error(alias)`, `lower_bound(alias)`, `upper_bound(alias)`
  for SUM / AVG / COUNT aggregates;
* the `WITH ERROR <frac> [CONFIDENCE <p>] [BEHAVIOR <b>]` clause with
  behaviors do_nothing / local_omit / strict / run_on_full_table /
  partial_run_on_base_table;
* `sample_`-aliased aggregates returning TRUE sample-table answers.

Estimator: classic stratified-SRS closed forms. The sample keeps, per
stratum h (one QCS combination), n_h rows of the N_h observed, each with
weight w_h = N_h / n_h. For an aggregate over x with a WHERE/GROUP
qualification, let y = x·1(row qualifies) and (m, Σx, Σx²) be the
qualifying-row moments within the stratum. Then

    T̂(sum)  = Σ_h w_h·Σx                         (Horvitz-Thompson)
    Var(T̂)  = Σ_h n_h·w_h·(w_h−1)·s²_h,  s²_h = (Σx² − (Σx)²/n_h)/(n_h−1)

(the n_h·w_h·(w_h−1) factor is N_h²·(1−n_h/N_h)/n_h rewritten — the
finite-population-corrected SRS variance). COUNT is the same with the
0/1 qualification indicator; AVG = S/C uses the delta-method ratio
variance (Var S − 2R·Cov(S,C) + R²·Var C)/C² with the per-stratum
covariance Cov_h = n_h·w_h·(w_h−1)·(Σx − Σx·m/n_h)/(n_h−1).

Layout: the per-(group, stratum) moment reduction is a regular engine
aggregate — ONE device program over the sample's plates (its GROUP BY
reaches the grouped kernel, a global SUM the Kahan kernel); only the
tiny strata-merge (#groups × #strata rows) runs host-side in numpy.
Port of snappydata_tpu/aqp/error_estimation.py.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.engine.result import Result
from snappydata_tpu_torch.sql import ast

ERROR_FUNCS = ("absolute_error", "relative_error", "lower_bound",
               "upper_bound")
_ESTIMABLE = ("sum", "avg", "count")


@dataclasses.dataclass
class _ExecCtx:
    """How the estimation phases execute. Single-node: one session, one
    piece per phase. Distributed: each phase fans to every data server
    and returns one piece per shard — per-server reservoirs are valid
    strata of the GLOBAL population, so the combine simply namespaces
    stratum ids by shard index (the HT/variance algebra is unchanged).
    """
    catalog: object
    run_phases: object    # [plans] -> List[List[Result]] per shard —
                          # ALL phases per shard execute in one call so
                          # shard indices stay aligned across failover
    run_exact: object     # plan -> Result (exact, full data)
    refresh: object       # () -> None


class AQPUnsupported(ValueError):
    """Query shape outside the AQP error-estimation scope (the reference
    limits error functions to SUM/AVG/COUNT over a sampled FROM — the
    same scope applies here)."""


class HACViolation(RuntimeError):
    """BEHAVIOR strict: an output row missed the accuracy contract."""


def query_has_error_surface(stmt: ast.Query) -> bool:
    """True when the statement needs the AQP error path: a WITH ERROR
    clause or any error function in the select list."""
    if stmt.with_error is not None:
        return True
    for node in _walk_plan(stmt.plan):
        for e in ast.plan_exprs(node):
            for x in ast.walk(e):
                if isinstance(x, ast.Func) and x.name in ERROR_FUNCS:
                    return True
    return False


def _walk_plan(p):
    yield p
    for k in p.children():
        yield from _walk_plan(k)


@dataclasses.dataclass
class _Item:
    """One select-list output column."""
    kind: str                    # group | agg | errfunc
    name: str                    # output column name
    expr: ast.Expr = None
    agg_name: str = ""           # sum/avg/count/min/max (kind=agg)
    arg: Optional[ast.Expr] = None
    sample_true: bool = False    # `sample_` alias: unscaled sample answer
    err_kind: str = ""           # absolute_error/... (kind=errfunc)
    target: int = -1             # index of the agg item it refers to
    group_idx: int = -1          # (kind=group)


def _unwrap_aggregate(stmt: ast.Query):
    """Peel Sort/Limit/HAVING and validate the supported shape →
    (aggregate, outer_orders, limit_n, having). HAVING applies
    POST-HOC on the ESTIMATES (docs/sde: predicates over aggregate
    estimates filter the estimated groups)."""
    outer_orders = None
    limit_n = None
    having = None
    node = stmt.plan
    while isinstance(node, (ast.Sort, ast.Limit)):
        if isinstance(node, ast.Sort):
            outer_orders = node.orders
        else:
            limit_n = node.n
        node = node.children()[0]
    if isinstance(node, ast.Filter) and isinstance(node.child,
                                                   ast.Aggregate):
        having = node.condition
        node = node.child
    if not isinstance(node, ast.Aggregate):
        raise AQPUnsupported(
            "error estimation applies to plain aggregate queries "
            "(SUM/AVG/COUNT [GROUP BY ...]) over a sampled table")
    return node, outer_orders, limit_n, having


def execute_error_query(session, stmt: ast.Query, user_params=()):
    """Entry: run `stmt` with error estimation / HAC enforcement."""
    agg, outer_orders, limit_n, having = _unwrap_aggregate(stmt)
    user_params = tuple(user_params)

    ctx = _ExecCtx(
        catalog=session.catalog,
        run_phases=lambda ps: [[session._run_query(p, user_params)
                                for p in ps]],
        run_exact=lambda p: session._run_query(p, user_params),
        refresh=session._refresh_samples)
    return _execute_with_ctx(ctx, stmt, agg, outer_orders, limit_n,
                             having)


def execute_error_query_distributed(ds, stmt: ast.Query):
    """Cluster entry: the phase aggregates fan to every data server —
    one piece per shard, BOTH phases in a single per-server call so a
    mid-estimation failover can't pair one shard's moments with another
    shard's stratum totals (review finding); exact re-runs go through
    the normal distributed query path."""
    from snappydata_tpu_torch.cluster.distributed import _arrow_to_result

    agg, outer_orders, limit_n, having = _unwrap_aggregate(stmt)

    def run_phases(ps):
        fns = [ds._partial_exec(p) for p in ps]

        def both(srv):
            return [fn(srv) for fn in fns]

        return [[_arrow_to_result(t, ds.planner) for t in piece]
                for piece in ds._fan(both)]

    ctx = _ExecCtx(catalog=ds.planner.catalog,
                   run_phases=run_phases,
                   run_exact=lambda p: ds._query(p),
                   refresh=lambda: None)   # servers refresh in-query
    return _execute_with_ctx(ctx, stmt, agg, outer_orders, limit_n,
                             having)


def _execute_with_ctx(ctx: _ExecCtx, stmt: ast.Query,
                      agg: ast.Aggregate, outer_orders, limit_n,
                      having=None):
    if agg.grouping_sets:
        return _execute_grouping_sets(ctx, stmt, agg, outer_orders,
                                      limit_n, having)
    clause = stmt.with_error
    samples: Dict[str, List[str]] = {}
    for info in ctx.catalog.list_tables():
        if info.provider == "sample" and info.base_table:
            samples.setdefault(info.base_table.lower(),
                               []).append(info.name)

    items, agg_items = _classify_select(agg)

    sampled_name = _find_sampled_relation(agg.child, samples)
    if sampled_name is None:
        # contract: on the base table the error functions answer 0 and
        # the bounds NULL (docs/sde/hac_contracts.md:62-64)
        exact = _run_exact(ctx, agg)
        rows = _exact_to_rows(exact, items, agg_items)
        if having is not None:
            rows = _filter_having(rows, having, items, agg_items)
        return _finalize(rows, items, exact, outer_orders, limit_n,
                         z=0.0)

    ctx.refresh()
    sample_rel = _select_sample(ctx, agg, having,
                                samples[sampled_name])

    conf = clause.confidence if clause is not None else 0.95
    z = NormalDist().inv_cdf(0.5 + conf / 2.0)

    est = _estimate(ctx, agg, items, agg_items, sampled_name,
                    sample_rel, z)

    if having is not None:
        # POST-HOC on the estimates, BEFORE behavior enforcement:
        # strict/rerun behaviors must judge only the OUTPUT groups —
        # a group HAVING excludes cannot violate the error contract
        # (review finding)
        est.rows = _filter_having(est.rows, having, items, agg_items)

    if clause is not None and clause.error < 1.0:
        est = _apply_behavior(ctx, est, clause, agg, items, agg_items)

    rows = est.rows
    if having is not None:
        # re-filter ONLY rows rebuilt from the exact answer
        # (run_on_full_table repopulates unfiltered, and exact values
        # may move a group across the HAVING boundary); estimate rows
        # already passed the pre-behavior filter — local_omit may have
        # NULLed their aggregates since, and an omitted row must stay
        # in the output with NULLs, not vanish (review finding)
        exact_rows = [r for r in rows if r.get("from_base")]
        kept_exact = _filter_having(exact_rows, having, items, agg_items)
        dropped = {id(r) for r in exact_rows} - {id(r)
                                                 for r in kept_exact}
        rows = [r for r in rows if id(r) not in dropped]
    return _finalize(rows, items, est.proto, outer_orders, limit_n,
                     z=est.z)


def _execute_grouping_sets(ctx: _ExecCtx, stmt: ast.Query,
                           agg: ast.Aggregate, outer_orders, limit_n,
                           having):
    """WITH ERROR over ROLLUP / CUBE / GROUPING SETS: one estimation
    per grouping set — the same per-set expansion the exact engine's
    analyzer performs (_expand_grouping_sets) — with absent keys
    NULL-padded, then the union sorted/limited once. Error bounds are
    per-variant, exactly as if each set ran as its own query."""
    from snappydata_tpu_torch.sql.analyzer import _expr_name

    pieces: List[Tuple[Result, List[int]]] = []
    dtypes_of: Dict[int, T.DataType] = {}
    for sset in agg.grouping_sets:
        keep = set(sset)

        def absent_idx(e):
            b = e.child if isinstance(e, ast.Alias) else e
            for gi, g in enumerate(agg.group_exprs):
                if b == g and gi not in keep:
                    return gi
            return None

        kept_pos = [i for i, e in enumerate(agg.agg_exprs)
                    if absent_idx(e) is None]

        def repl(e):
            """Absent group refs read NULL — including INSIDE kept
            aggregates: count(carrier) in the () variant must count
            NULLs (i.e. zero), exactly like the exact analyzer's
            expansion (review finding). This runs PRE-analysis on raw
            exprs (the exact path's _expand_grouping runs on resolved
            plans with typed Cast(NULL) — here the engine's untyped
            NULL literal lowers fine and _filter_having evaluates it),
            which is why the two expansions can't share code."""
            for gi, g in enumerate(agg.group_exprs):
                if e == g and gi not in keep:
                    return ast.Lit(None)
            return e.map_children(repl)

        v_agg = dataclasses.replace(
            agg, grouping_sets=None,
            group_exprs=tuple(agg.group_exprs[i] for i in sset),
            agg_exprs=tuple(repl(agg.agg_exprs[i]) for i in kept_pos))
        v_having = repl(having) if having is not None else None
        res = _execute_with_ctx(ctx, stmt, v_agg, None, None, v_having)
        pieces.append((res, kept_pos))
        for ci, p in enumerate(kept_pos):
            dtypes_of.setdefault(p, res.dtypes[ci])

    arity = len(agg.agg_exprs)
    names = [_expr_name(e) for e in agg.agg_exprs]
    dtypes = [dtypes_of.get(i, T.STRING) for i in range(arity)]
    cols: List[List[np.ndarray]] = [[] for _ in range(arity)]
    nulls: List[List[np.ndarray]] = [[] for _ in range(arity)]
    for res, kept_pos in pieces:
        nrows = res.num_rows
        kept = dict(zip(kept_pos, range(len(kept_pos))))
        for i in range(arity):
            ci = kept.get(i)
            if ci is None:  # absent key: all-NULL pad
                dt = dtypes[i]
                fill = np.array([""] * nrows, dtype=object) \
                    if dt.name == "string" \
                    else np.zeros(nrows, dtype=dt.np_dtype)
                cols[i].append(fill)
                nulls[i].append(np.ones(nrows, dtype=bool))
            else:
                cols[i].append(np.asarray(res.columns[ci]))
                nulls[i].append(np.asarray(res.nulls[ci])
                                if res.nulls[ci] is not None
                                else np.zeros(nrows, dtype=bool))
    out_cols, out_nulls = [], []
    for i in range(arity):
        parts = cols[i]
        if len({p.dtype for p in parts}) > 1:
            parts = [p.astype(object) for p in parts]
        out_cols.append(np.concatenate(parts) if parts
                        else np.zeros(0, dtype=dtypes[i].np_dtype))
        nm = np.concatenate(nulls[i]) if nulls[i] \
            else np.zeros(0, dtype=bool)
        out_nulls.append(nm if nm.any() else None)
    res = Result(names, out_cols, out_nulls, dtypes)
    if outer_orders:
        res = _host_sort(res, outer_orders)
    if limit_n is not None:
        res = Result(res.names, [c[:limit_n] for c in res.columns],
                     [m[:limit_n] if m is not None else None
                      for m in res.nulls], res.dtypes)
    return res


def _filter_having(rows: List[dict], having: ast.Expr, items,
                   agg_items) -> List[dict]:
    """HAVING over the per-group records: aggregate references resolve
    to their ESTIMATED values (post-hoc filtering on estimates), group
    references to the group key. Shapes beyond literals / select-list
    references / and-or-not / comparisons / + - * / raise
    AQPUnsupported with a clear message."""

    def norm(e):
        """Case-normalized copy: identifier resolution is
        case-insensitive engine-wide, so HAVING sum(DELAY) must match
        select-list sum(delay) (review finding)."""
        if isinstance(e, ast.Col) and e.name:
            return dataclasses.replace(e, name=e.name.lower())
        return e.map_children(norm)

    agg_norm = [norm(a.expr) for a in agg_items]
    grp_norm = [(it, norm(it.expr)) for it in items
                if it.kind == "group"]

    def value(e, rec):
        if isinstance(e, ast.Alias):
            return value(e.child, rec)
        en = norm(e)
        for j, an in enumerate(agg_norm):
            if en == an:
                return rec["est"][j]
        for it, gn in grp_norm:
            if en == gn:
                return rec["groups"][it.group_idx]
        if isinstance(e, ast.Col):
            want = (e.name or "").lower()
            for j, a in enumerate(agg_items):
                if a.name.lower() == want:
                    return rec["est"][j]
            for it in items:
                if it.kind == "group" and it.name.lower() == want:
                    return rec["groups"][it.group_idx]
        if isinstance(e, ast.Lit):
            return e.value
        if isinstance(e, ast.UnaryOp):
            v = value(e.child, rec)
            if v is None:
                return None
            return (not v) if e.op == "not" else -v
        if isinstance(e, ast.BinOp):
            lv = value(e.left, rec)
            rv = value(e.right, rec)
            if e.op == "and":
                return bool(lv) and bool(rv)
            if e.op == "or":
                return bool(lv) or bool(rv)
            if lv is None or rv is None:
                return None
            ops = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
                   "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
                   ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
                   "+": lambda a, b: a + b, "-": lambda a, b: a - b,
                   "*": lambda a, b: a * b,
                   "/": lambda a, b: a / b if b else None}
            if e.op in ops:
                return ops[e.op](lv, rv)
        raise AQPUnsupported(
            f"HAVING with error estimation supports comparisons over "
            f"the select-list aggregates/groups and literals; got {e}")

    return [rec for rec in rows if bool(value(having, rec))]


def _select_sample(ctx: _ExecCtx, agg: ast.Aggregate, having,
                   candidates: List[str]) -> str:
    """Best-QCS-match sample selection (docs/sde/sample_selection.md):
    query QCS = columns in WHERE / GROUP BY / HAVING; exact QCS match >
    sample-QCS-superset > most-matching-columns subset, ties broken by
    the largest sample."""
    if len(candidates) == 1:
        return candidates[0]

    qcols = set()

    def collect(e):
        if isinstance(e, ast.Func) and e.name in ast.AGG_FUNCS:
            # aggregate MEASURE columns are not grouping columns: a
            # HAVING sum(v) > 10 must not pull v into the query QCS
            # and mis-rank a measure-stratified sample (review finding)
            return
        if isinstance(e, ast.Col) and e.name:
            qcols.add(e.name.lower())
        for c in e.children():
            collect(c)

    for g in agg.group_exprs:
        collect(g)
    if having is not None:
        collect(having)
    for node in _walk_plan(agg.child):
        if isinstance(node, ast.Filter):
            collect(node.condition)

    scored = []
    for pos, name in enumerate(candidates):
        info = ctx.catalog.lookup_table(name)
        opts = dict(getattr(info, "options", {}) or {})
        opts.update(getattr(info, "sample_options", {}) or {})
        qcs = {c.strip().lower()
               for c in (opts.get("qcs", "") or "").split(",")
               if c.strip()}
        try:
            size = info.data.snapshot().total_rows()
        except Exception:
            size = 0
        if qcs and qcs == qcols:
            rank = 3
        elif qcs and qcs >= qcols and qcols:
            rank = 2
        elif qcs and qcs <= qcols:
            rank = 1
        else:
            rank = 0
        overlap = len(qcs & qcols)
        # -pos: stable preference for the earliest candidate on full ties
        scored.append(((rank, overlap, size, -pos), name))
    return max(scored)[1]


# ---------------------------------------------------------------------
# select-list classification
# ---------------------------------------------------------------------

def _classify_select(agg: ast.Aggregate):
    groups = list(agg.group_exprs)
    items: List[_Item] = []
    agg_items: List[_Item] = []
    out_names: List[str] = []
    for e in agg.agg_exprs:
        alias = None
        inner = e
        if isinstance(inner, ast.Alias):
            alias, inner = inner.name, inner.child
        gi = next((i for i, g in enumerate(groups) if g == inner), -1)
        if gi >= 0:
            nm = alias or (inner.name if isinstance(inner, ast.Col)
                           else f"_c{len(items)}")
            items.append(_Item("group", nm, expr=inner, group_idx=gi))
            out_names.append(nm.lower())
            continue
        if isinstance(inner, ast.Func) and inner.name in ERROR_FUNCS:
            if len(inner.args) != 1 or not isinstance(inner.args[0],
                                                      ast.Col):
                raise AQPUnsupported(
                    f"{inner.name} expects the alias of an aggregate "
                    f"in this select list")
            nm = alias or f"{inner.name}({inner.args[0].name})"
            items.append(_Item("errfunc", nm, err_kind=inner.name,
                               expr=inner.args[0]))
            out_names.append(nm.lower())
            continue
        fn = inner
        if isinstance(fn, ast.Func) and fn.name == "count_distinct":
            raise AQPUnsupported(
                "count(DISTINCT) has no closed-form sample estimator; "
                "run the exact query")
        if not (isinstance(fn, ast.Func)
                and fn.name in ("sum", "avg", "count", "min", "max")):
            raise AQPUnsupported(
                "error estimation supports bare SUM/AVG/COUNT/MIN/MAX "
                f"aggregates in the select list, got {e}")
        arg = fn.args[0] if fn.args else None
        nm = alias or f"{fn.name}"
        it = _Item("agg", nm, expr=inner, agg_name=fn.name, arg=arg,
                   sample_true=bool(alias)
                   and alias.lower().startswith("sample_"))
        items.append(it)
        agg_items.append(it)
        out_names.append(nm.lower())

    # resolve error-function targets against the aggregate aliases
    for it in items:
        if it.kind != "errfunc":
            continue
        want = it.expr.name.lower()
        tgt = next((j for j, a in enumerate(agg_items)
                    if a.name.lower() == want), None)
        if tgt is None:
            raise AQPUnsupported(
                f"{it.err_kind}({want}): no aggregate aliased {want!r} "
                f"in this select list")
        if agg_items[tgt].agg_name not in _ESTIMABLE:
            raise AQPUnsupported(
                f"{it.err_kind} applies to SUM/AVG/COUNT aggregates, "
                f"not {agg_items[tgt].agg_name}")
        it.target = tgt
    return items, agg_items


def _find_sampled_relation(p: ast.Plan, samples) -> Optional[str]:
    for node in _walk_plan(p):
        if isinstance(node, ast.UnresolvedRelation) and \
                node.name.lower() in samples:
            return node.name.lower()
    return None


def _swap_to_sample(p: ast.Plan, base: str, sample: str) -> ast.Plan:
    def rec(n):
        if isinstance(n, ast.UnresolvedRelation) and \
                n.name.lower() == base:
            return ast.UnresolvedRelation(
                sample, alias=n.alias or n.name.split(".")[-1])
        kids = n.children()
        if not kids:
            return n
        if isinstance(n, (ast.Join, ast.Union, ast.SetOp)):
            return dataclasses.replace(n, left=rec(n.left),
                                       right=rec(n.right))
        return dataclasses.replace(n, child=rec(kids[0]))

    return rec(p)


# ---------------------------------------------------------------------
# estimation
# ---------------------------------------------------------------------

@dataclasses.dataclass
class _Estimate:
    """Per-group estimation state: rows maps group-key tuple → dict with
    'groups' (values), per-agg 'est', 'var', and the z scale."""
    rows: List[dict]
    z: float
    proto: Result           # phase-A result (dtype source for groups)


def _estimate(ctx: _ExecCtx, agg, items, agg_items, base_name,
              sample_rel, z) -> _Estimate:
    from snappydata_tpu_torch.aqp.sampling import (RESERVOIR_WEIGHT_COLUMN,
                                             STRATUM_ID_COLUMN)

    groups = list(agg.group_exprs)
    child = _swap_to_sample(agg.child, base_name, sample_rel)

    # ---- phase A: per-(group, stratum) moments — one engine program
    a_exprs: List[ast.Expr] = [ast.Alias(g, f"__g{i}")
                               for i, g in enumerate(groups)]
    a_exprs.append(ast.Alias(ast.Col(STRATUM_ID_COLUMN), "__h"))
    slots: List[Tuple[str, Optional[ast.Expr]]] = []

    def slot(kind, arg) -> int:
        for i, (k, a) in enumerate(slots):
            if k == kind and a == arg:
                return i
        slots.append((kind, arg))
        return len(slots) - 1

    for it in agg_items:
        if it.agg_name == "count" and it.arg is None:
            it._slot = slot("cstar", None)
        elif it.agg_name in ("sum", "avg", "count"):
            it._slot = slot("moments", it.arg)
        else:                      # min / max
            it._slot = slot(it.agg_name, it.arg)

    for si, (kind, arg) in enumerate(slots):
        if kind == "cstar":
            a_exprs.append(ast.Alias(ast.Func("count", ()), f"__s{si}_m"))
        elif kind == "moments":
            a_exprs.append(ast.Alias(ast.Func("count", (arg,)),
                                     f"__s{si}_m"))
            a_exprs.append(ast.Alias(ast.Func("sum", (arg,)),
                                     f"__s{si}_sx"))
            a_exprs.append(ast.Alias(
                ast.Func("sum", (ast.BinOp("*", arg, arg),)),
                f"__s{si}_sxx"))
        else:
            a_exprs.append(ast.Alias(ast.Func(kind, (arg,)),
                                     f"__s{si}_{kind}"))

    phase_a = ast.Aggregate(
        child, tuple(groups) + (ast.Col(STRATUM_ID_COLUMN),),
        tuple(a_exprs))

    # ---- phase B: UNFILTERED per-stratum totals (n_h, w_h) — the
    # stratum size is a property of the sample, not of the query
    phase_b = ast.Aggregate(
        ast.UnresolvedRelation(sample_rel),
        (ast.Col(STRATUM_ID_COLUMN),),
        (ast.Alias(ast.Col(STRATUM_ID_COLUMN), "__h"),
         ast.Alias(ast.Func("count", ()), "__n"),
         ast.Alias(ast.Func("max", (ast.Col(RESERVOIR_WEIGHT_COLUMN),)),
                   "__w")))
    shards = ctx.run_phases([phase_a, phase_b])
    pieces_a = [pa for pa, _pb in shards]
    pieces_b = [pb for _pa, pb in shards]
    # stratum identity is (shard index, local stratum id): per-shard
    # reservoirs assign ids independently, and the same QCS value on two
    # shards IS two strata of the global population
    n_of: Dict[tuple, float] = {}
    w_of: Dict[tuple, float] = {}
    for pi, res_b in enumerate(pieces_b):
        for h, n, w in res_b.rows():
            n_of[(pi, int(h))] = float(n)
            w_of[(pi, int(h))] = float(w)

    # ---- host combine: strata → per-group estimate + variance
    ng = len(groups)
    out_rows = _combine_strata(pieces_a, agg_items, n_of, w_of, ng)

    # a grouped query with an empty sample yields no rows; a GLOBAL
    # aggregate still answers one row (count 0 / sum NULL)
    if not out_rows and ng == 0:
        rec = {"groups": (), "est": [], "var": [], "violate": [],
               "from_base": False}
        for it in agg_items:
            rec["est"].append(0.0 if it.agg_name == "count" else None)
            rec["var"].append(0.0 if it.agg_name == "count" else None)
        out_rows.append(rec)

    est = _Estimate(out_rows, z, pieces_a[0])
    return est


def _combine_strata(pieces_a, agg_items, n_of, w_of, ng: int
                    ) -> List[dict]:
    """VECTORIZED strata -> per-group combine: one numpy group-by over
    the concatenated phase-A pieces. The previous per-group Python
    loop re-walked every (group, stratum) row per aggregate item —
    fine at 4 groups, pathological at 100k (round-4 verdict task 7).
    The math is identical: stratified Horvitz-Thompson totals with
    per-stratum sample variances, avg as a self-normalized ratio."""
    nrows = sum(r.num_rows for r in pieces_a)
    if nrows == 0:
        out_rows: List[dict] = []
    else:
        col_idx = {nm.lower(): i
                   for i, nm in enumerate(pieces_a[0].names)}
        pi_arr = np.concatenate([np.full(r.num_rows, pi, dtype=np.int64)
                                 for pi, r in enumerate(pieces_a)])

        def num_col(i, fill=0.0):
            parts = []
            for r in pieces_a:
                c = np.asarray(r.columns[i], dtype=np.float64)
                if r.nulls[i] is not None:
                    c = np.where(np.asarray(r.nulls[i]), fill, c)
                parts.append(c)
            return np.concatenate(parts)

        # group identity: per-key factorize (nulls get their own code),
        # then a row-wise unique over the stacked codes
        key_vals: List[np.ndarray] = []   # python-object values for output
        codes = []
        for ki in range(ng):
            vparts, nparts = [], []
            for r in pieces_a:
                c = np.asarray(r.columns[ki])
                nm = np.asarray(r.nulls[ki]) if r.nulls[ki] is not None \
                    else np.zeros(r.num_rows, dtype=bool)
                if c.dtype == object:
                    nm = nm | np.array([v is None for v in c])
                vparts.append(c)
                nparts.append(nm)
            vals = np.concatenate(vparts)
            nulls = np.concatenate(nparts)
            if vals.dtype == object:
                safe = vals.copy()
                safe[nulls] = ""
            else:
                safe = np.where(nulls, 0, vals)
            uq, inv = np.unique(safe, return_inverse=True)
            inv = inv.astype(np.int64) + 1
            inv[nulls] = 0
            codes.append(inv)
            out_vals = vals.astype(object)
            out_vals[nulls] = None
            key_vals.append(out_vals)
        if ng:
            stacked = np.stack(codes, axis=1)
            _uq, first_idx, ginv = np.unique(
                stacked, axis=0, return_index=True, return_inverse=True)
            ginv = ginv.reshape(-1)
            G = len(first_idx)
        else:
            ginv = np.zeros(nrows, dtype=np.int64)
            first_idx = np.array([0])
            G = 1

        # per-row stratum parameters via the (piece, h) lookup
        h_arr = num_col(col_idx["__h"]).astype(np.int64)
        upair, pinv = np.unique(np.stack([pi_arr, h_arr], axis=1),
                                axis=0, return_inverse=True)
        n_u = np.array([n_of[(int(p), int(h))] for p, h in upair])
        w_u = np.array([w_of[(int(p), int(h))] for p, h in upair])
        n_h = n_u[pinv.reshape(-1)]
        w_h = w_u[pinv.reshape(-1)]
        fpc = n_h * w_h * (w_h - 1.0)
        multi = n_h > 1
        inv_n1 = np.where(multi, 1.0 / np.maximum(n_h - 1.0, 1.0), 0.0)

        def by_group(weights):
            return np.bincount(ginv, weights=weights, minlength=G)

        est_cols: List[np.ndarray] = []
        var_cols: List[np.ndarray] = []
        for it in agg_items:
            si = it._slot
            if it.agg_name in ("min", "max"):
                ci = col_idx[f"__s{si}_{it.agg_name}"]
                if any(np.asarray(r.columns[ci]).dtype == object
                       for r in pieces_a):
                    # non-numeric (string) min/max: python per-row pass
                    # for this item only
                    acc: Dict[int, object] = {}
                    pos = 0
                    for r in pieces_a:
                        cvals = r.columns[ci]
                        cnull = r.nulls[ci]
                        for j in range(r.num_rows):
                            if (cnull is not None and cnull[j]) \
                                    or cvals[j] is None:
                                pos += 1
                                continue
                            g = int(ginv[pos])
                            cur = acc.get(g)
                            v = cvals[j]
                            if cur is None or (
                                    v < cur if it.agg_name == "min"
                                    else v > cur):
                                acc[g] = v
                            pos += 1
                    est_cols.append(np.array(
                        [acc.get(g) for g in range(G)], dtype=object))
                    var_cols.append(np.full(G, np.nan))
                    continue
                filler = np.inf if it.agg_name == "min" else -np.inf
                vals = num_col(ci, fill=filler)
                out = np.full(G, filler)
                if it.agg_name == "min":
                    np.minimum.at(out, ginv, vals)
                else:
                    np.maximum.at(out, ginv, vals)
                # emptiness is tracked via the null masks, NOT by
                # checking for the +/-inf sentinel — a column really
                # containing inf must answer inf, not NULL (review
                # finding)
                nn_parts = []
                for r in pieces_a:
                    nm = r.nulls[ci]
                    nn_parts.append(
                        ~np.asarray(nm) if nm is not None
                        else np.ones(r.num_rows, dtype=bool))
                seen = by_group(
                    np.concatenate(nn_parts).astype(np.float64)) > 0
                est_cols.append(np.where(seen, out, np.nan))
                var_cols.append(np.full(G, np.nan))
                continue
            m = num_col(col_idx[f"__s{si}_m"])
            if it.agg_name == "count" and it.arg is None:
                sx = sxx = m
            else:
                sx = num_col(col_idx[f"__s{si}_sx"])
                sxx = num_col(col_idx[f"__s{si}_sxx"])
            true_cnt = by_group(m)
            true_sum = by_group(sx)
            S = by_group(w_h * sx)
            C = by_group(w_h * m)
            s2x = np.maximum(0.0, (sxx - sx * sx / n_h) * inv_n1)
            s2c = np.maximum(0.0, (m - m * m / n_h) * inv_n1)
            sxy = (sx - sx * m / n_h) * inv_n1
            var_s = by_group(np.where(multi, fpc * s2x, 0.0))
            var_c = by_group(np.where(multi, fpc * s2c, 0.0))
            cov_sc = by_group(np.where(multi, fpc * sxy, 0.0))
            if it.agg_name == "sum":
                est, var = (true_sum, np.zeros(G)) if it.sample_true \
                    else (S, var_s)
            elif it.agg_name == "count":
                est, var = (true_cnt, np.zeros(G)) if it.sample_true \
                    else (C, var_c)
            else:  # avg — self-normalized ratio
                with np.errstate(divide="ignore", invalid="ignore"):
                    if it.sample_true:
                        est = np.where(true_cnt > 0,
                                       true_sum / np.maximum(true_cnt, 1),
                                       np.nan)
                        var = np.where(true_cnt > 0, 0.0, np.nan)
                    else:
                        R = np.where(C > 0, S / np.maximum(C, 1e-300),
                                     np.nan)
                        var = np.maximum(
                            0.0, var_s - 2.0 * R * cov_sc
                            + R * R * var_c) / np.maximum(C, 1e-300) ** 2
                        var = np.where(C > 0, var, np.nan)
                        est = R
            est_cols.append(est)
            var_cols.append(var)

        out_rows = []
        for g in range(G):
            rec = {"groups": tuple(key_vals[k][first_idx[g]]
                                   for k in range(ng)),
                   "est": [], "var": [], "violate": [],
                   "from_base": False}
            for it, e_arr, v_arr in zip(agg_items, est_cols, var_cols):
                ev = e_arr[g]
                vv = v_arr[g]
                if e_arr.dtype == object:   # string min/max
                    rec["est"].append(ev)
                else:
                    rec["est"].append(None if np.isnan(ev) else float(ev))
                rec["var"].append(None if np.isnan(vv) else float(vv))
            out_rows.append(rec)
    return out_rows


# ---------------------------------------------------------------------
# behavior enforcement
# ---------------------------------------------------------------------

def _rel_error(est_v, var_v, z) -> Optional[float]:
    if est_v is None or var_v is None:
        return None
    abs_err = z * math.sqrt(var_v)
    if est_v == 0:
        return math.inf if abs_err > 0 else 0.0
    return abs_err / abs(est_v)


def _apply_behavior(ctx: _ExecCtx, est: _Estimate, clause, agg, items,
                    agg_items) -> _Estimate:
    violating: List[int] = []
    for ri, rec in enumerate(est.rows):
        bad = []
        for ai, it in enumerate(agg_items):
            if it.agg_name not in _ESTIMABLE or it.sample_true:
                bad.append(False)
                continue
            rel = _rel_error(rec["est"][ai], rec["var"][ai], est.z)
            bad.append(rel is not None and rel > clause.error)
        rec["violate"] = bad
        if any(bad):
            violating.append(ri)

    if not violating or clause.behavior == "do_nothing":
        return est
    if clause.behavior == "strict":
        raise HACViolation(
            f"{len(violating)} output row(s) exceed relative error "
            f"{clause.error} at confidence {clause.confidence}")
    if clause.behavior == "local_omit":
        for ri in violating:
            rec = est.rows[ri]
            for ai, bad in enumerate(rec["violate"]):
                if bad:
                    rec["est"][ai] = None
                    rec["var"][ai] = None
        return est

    # run_on_full_table / partial_run_on_base_table
    groups = list(agg.group_exprs)
    partial = clause.behavior == "partial_run_on_base_table" and groups \
        and all(isinstance(g, ast.Col) for g in groups)
    exact_agg = agg
    if partial:
        keys = [est.rows[ri]["groups"] for ri in violating]
        disj = []
        for kt in keys:
            conj = []
            for g, v in zip(groups, kt):
                if v is None:
                    conj.append(ast.IsNull(g))
                else:
                    conj.append(ast.BinOp("=", g, ast.Lit(v)))
            c = conj[0]
            for x in conj[1:]:
                c = ast.BinOp("and", c, x)
            disj.append(c)
        cond = disj[0]
        for x in disj[1:]:
            cond = ast.BinOp("or", cond, x)
        exact_agg = dataclasses.replace(
            agg, child=ast.Filter(agg.child, cond))
    exact = _run_exact(ctx, exact_agg)
    exact_rows = _exact_to_rows(exact, items, agg_items)

    ng = len(groups)
    if not partial:
        for r in exact_rows:
            r["from_base"] = True
        return _Estimate(exact_rows, est.z, est.proto)
    by_key = {tuple(r["groups"][:ng]): r for r in exact_rows}
    for ri in violating:
        key = tuple(est.rows[ri]["groups"])
        hit = by_key.get(key)
        if hit is not None:
            hit["from_base"] = True
            est.rows[ri] = hit
    return est


def _run_exact(ctx: _ExecCtx, agg: ast.Aggregate) -> Result:
    """The original aggregate with error functions stripped, on base."""
    keep = tuple(e for e in agg.agg_exprs
                 if not (isinstance(
                     e.child if isinstance(e, ast.Alias) else e, ast.Func)
                     and (e.child if isinstance(e, ast.Alias) else e).name
                     in ERROR_FUNCS))
    return ctx.run_exact(dataclasses.replace(agg, agg_exprs=keep))


def _exact_to_rows(exact: Result, items, agg_items) -> List[dict]:
    """Map an exact engine result into estimation rows: errors 0,
    bounds NULL (docs/sde/hac_contracts.md:62-64). `groups` is indexed
    by GROUP BY position (matching _estimate's phase-A tuples), NOT by
    select-list order — SELECT b, a ... GROUP BY a, b would otherwise
    swap columns in _finalize and break the partial-run key match."""
    rows = exact.rows()
    out: List[dict] = []
    nongroup = [it for it in items if it.kind != "errfunc"]
    ng = max((it.group_idx + 1 for it in items if it.kind == "group"),
             default=0)
    for row in rows:
        gvals: List = [None] * ng
        evals = []
        for it, v in zip(nongroup, row):
            if it.kind == "group":
                gvals[it.group_idx] = v
            else:
                evals.append(v)
        out.append({"groups": tuple(gvals), "est": evals,
                    "var": [0.0 if it.agg_name in _ESTIMABLE else None
                            for it in agg_items],
                    "violate": [], "from_base": True})
    return out


# ---------------------------------------------------------------------
# result assembly
# ---------------------------------------------------------------------

def _finalize(rows: List[dict], items, proto: Result, orders,
              limit_n, z: float) -> Result:
    names: List[str] = [it.name for it in items]
    cols: List[list] = [[] for _ in range(len(items))]

    for rec in rows:
        for ci, it in enumerate(items):
            if it.kind == "group":
                cols[ci].append(rec["groups"][it.group_idx]
                                if it.group_idx < len(rec["groups"])
                                else None)
            elif it.kind == "agg":
                v = rec["est"][_agg_index(items, it)]
                if it.agg_name == "count" and v is not None:
                    v = int(round(v))
                cols[ci].append(v)
            else:  # errfunc
                t = it.target
                cols[ci].append(_error_value(
                    it.err_kind, rec["est"][t], rec["var"][t], rec, z))

    # dtypes: groups from the phase-A/exact proto result, aggregates by
    # kind (count → LONG, others → DOUBLE), error funcs DOUBLE
    dtypes: List[T.DataType] = []
    proto_types = {nm.lower(): dt
                   for nm, dt in zip(proto.names, proto.dtypes)}
    for i, it in enumerate(items):
        if it.kind == "group":
            dtypes.append(proto_types.get(f"__g{it.group_idx}")
                          or proto_types.get(it.name.lower()) or T.STRING)
        elif it.kind == "agg":
            dtypes.append(T.LONG if it.agg_name == "count" else T.DOUBLE)
        else:
            dtypes.append(T.DOUBLE)

    np_cols: List[np.ndarray] = []
    nulls: List[Optional[np.ndarray]] = []
    for ci, dt in enumerate(dtypes):
        vals = cols[ci]
        mask = np.array([v is None for v in vals], dtype=bool)
        if dt.name == "string":
            np_cols.append(np.array(
                ["" if v is None else v for v in vals], dtype=object))
        else:
            npdt = dt.np_dtype
            np_cols.append(np.array(
                [0 if v is None else v for v in vals], dtype=npdt))
        nulls.append(mask if mask.any() else None)

    res = Result(names, np_cols, nulls, dtypes)
    if orders:
        res = _host_sort(res, orders)
    if limit_n is not None:
        res = Result(res.names,
                     [c[:limit_n] for c in res.columns],
                     [m[:limit_n] if m is not None else None
                      for m in res.nulls], res.dtypes)
    return res


def _agg_index(items, it) -> int:
    k = 0
    for other in items:
        if other.kind == "agg":
            if other is it:
                return k
            k += 1
    raise AssertionError


def _error_value(kind: str, est_v, var_v, rec, z: float):
    """absolute/relative error and bounds for one cell. Base-table rows
    answer 0 / 0 / NULL / NULL per the contract."""
    if rec.get("from_base"):
        return 0.0 if kind in ("absolute_error", "relative_error") \
            else None
    if est_v is None or var_v is None:
        return None
    abs_err = z * math.sqrt(var_v)
    if kind == "absolute_error":
        return abs_err
    if kind == "relative_error":
        return abs_err / abs(est_v) if est_v != 0 else (
            0.0 if abs_err == 0 else None)
    if kind == "lower_bound":
        return est_v - abs_err
    return est_v + abs_err


def _host_sort(res: Result, orders) -> Result:
    """ORDER BY over output columns (names or group aliases) — the
    result is #groups rows, so a host lexsort is exact and cheap."""
    keys = []
    lower = [n.lower() for n in res.names]
    for expr, asc, nulls_first in reversed(list(orders)):
        if not isinstance(expr, ast.Col):
            raise AQPUnsupported(
                "ORDER BY with error estimation supports plain output "
                "columns")
        try:
            ci = lower.index(expr.name.lower())
        except ValueError:
            raise AQPUnsupported(
                f"ORDER BY column {expr.name!r} is not in the output")
        col = res.columns[ci]
        mask = res.nulls[ci]
        if col.dtype == object:
            ranks = np.argsort(
                np.argsort([("" if v is None else str(v)) for v in col]))
            key = ranks.astype(np.float64)
        else:
            key = col.astype(np.float64)
        if mask is not None:
            nf = nulls_first if nulls_first is not None else asc
            key = key.copy()
            key[mask] = -np.inf if nf else np.inf
        keys.append(key if asc else -key)
    order = np.lexsort(keys) if keys else np.arange(res.num_rows)
    return Result(res.names,
                  [c[order] for c in res.columns],
                  [m[order] if m is not None else None
                   for m in res.nulls],
                  res.dtypes)
