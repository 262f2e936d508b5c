"""Host (numpy/pandas) expression & plan evaluation.

Three jobs:
1. Post-ops over small materialized results (HAVING / ORDER BY / LIMIT /
   DISTINCT / outer projects) — the reference does the same driver-side
   (CollectAggregateExec, ExistingPlans.scala:106; executeTake,
   CachedDataFrame.scala:766).
2. Full-plan fallback when device lowering hits an unsupported construct
   (ref: CodegenSparkFallback.scala:33-88 retries with the vanilla path).
3. Mutation predicates/assignments over decoded host columns (UPDATE/
   DELETE run host-side; they are OLTP-sized by design, §3.3).
"""

from __future__ import annotations

import dataclasses
import datetime
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.resource.context import check_current
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.sql.analyzer import expr_type, _expr_name


class HostEvalError(Exception):
    pass


# --------------------------------------------------------------------------
# Expression evaluation: (values, nullmask) over host arrays
# --------------------------------------------------------------------------

def eval_expr(e: ast.Expr, cols: Sequence[np.ndarray],
              nulls: Sequence[Optional[np.ndarray]], params: Tuple,
              n: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    if isinstance(e, ast.Alias):
        return eval_expr(e.child, cols, nulls, params, n)
    if isinstance(e, ast.Col):
        return cols[e.index], nulls[e.index]
    if isinstance(e, ast.Lit):
        if e.value is None:
            return np.zeros(n), np.ones(n, dtype=bool)
        return np.broadcast_to(np.asarray(e.value), (n,)), None
    if isinstance(e, (ast.ParamLiteral, ast.Param)):
        v = params[e.pos]
        if v is None:
            return np.zeros(n), np.ones(n, dtype=bool)
        return np.broadcast_to(np.asarray(v), (n,)), None
    if isinstance(e, ast.Cast):
        v, nl = eval_expr(e.child, cols, nulls, params, n)
        if e.to.name == "string":
            return np.asarray([_to_str(x) for x in v], dtype=object), nl
        return np.asarray(v).astype(e.to.np_dtype), nl
    if isinstance(e, ast.UnaryOp):
        v, nl = eval_expr(e.child, cols, nulls, params, n)
        if e.op == "not":
            return ~v.astype(bool), nl
        return -v, nl
    if isinstance(e, ast.IsNull):
        v, nl = eval_expr(e.child, cols, nulls, params, n)
        isn = nl if nl is not None else np.zeros(n, dtype=bool)
        if v.dtype == object:
            isn = isn | np.array([x is None for x in v])
        return (~isn if e.negated else isn), None
    if isinstance(e, ast.Between):
        return eval_expr(_between_to_and(e), cols, nulls, params, n)
    if isinstance(e, ast.InList):
        v, nl = eval_expr(e.child, cols, nulls, params, n)
        acc = np.zeros(n, dtype=bool)
        for val in e.values:
            vv, vn = eval_expr(val, cols, nulls, params, n)
            acc |= _safe_cmp(v, vv, "=")
        if e.negated:
            acc = ~acc
        return acc, nl
    if isinstance(e, ast.Like):
        v, nl = eval_expr(e.child, cols, nulls, params, n)
        regex = re.compile(
            "^" + re.escape(e.pattern).replace("%", ".*").replace("_", ".")
            + "$", re.DOTALL)
        hit = np.array([x is not None and regex.match(str(x)) is not None
                        for x in v])
        if e.negated:
            hit = ~hit
        return hit, nl
    if isinstance(e, ast.Case):
        out_v = None
        out_n = np.ones(n, dtype=bool)
        if e.otherwise is not None:
            out_v, out_n = eval_expr(e.otherwise, cols, nulls, params, n)
            out_v = np.array(out_v, copy=True)
            out_n = np.array(out_n, copy=True) if out_n is not None \
                else np.zeros(n, dtype=bool)
        done = np.zeros(n, dtype=bool)
        branches = []
        for c, val in e.whens:
            cv, cn = eval_expr(c, cols, nulls, params, n)
            take = cv.astype(bool) & ~done
            if cn is not None:
                take &= ~cn
            vv, vn = eval_expr(val, cols, nulls, params, n)
            branches.append((take, vv, vn))
            done |= take
        if out_v is None:
            proto = branches[0][1] if branches else np.zeros(n)
            out_v = np.zeros(n, dtype=proto.dtype if proto.dtype != object
                             else object)
            out_n = np.ones(n, dtype=bool)
        for take, vv, vn in branches:
            out_v[take] = np.broadcast_to(vv, (n,))[take]
            out_n[take] = (np.broadcast_to(vn, (n,))[take]
                           if vn is not None else False)
        return out_v, out_n
    if isinstance(e, ast.BinOp):
        return _eval_binop(e, cols, nulls, params, n)
    if isinstance(e, ast.Func):
        return _eval_func(e, cols, nulls, params, n)
    raise HostEvalError(f"cannot evaluate {type(e).__name__} on host")


def _between_to_and(e: ast.Between) -> ast.Expr:
    both = ast.BinOp("and", ast.BinOp(">=", e.child, e.lo),
                     ast.BinOp("<=", e.child, e.hi))
    return ast.UnaryOp("not", both) if e.negated else both


def _safe_cmp(a, b, op):
    if a.dtype == object or (hasattr(b, "dtype") and b.dtype == object):
        a_l = [x if x is not None else "" for x in np.broadcast_to(a, a.shape)]
        b_arr = np.broadcast_to(b, a.shape)
        b_l = [x if x is not None else "" for x in b_arr]
        pairs = zip(a_l, b_l)
        fn = {"=": lambda x, y: x == y, "!=": lambda x, y: x != y,
              "<": lambda x, y: x < y, "<=": lambda x, y: x <= y,
              ">": lambda x, y: x > y, ">=": lambda x, y: x >= y}[op]
        return np.array([fn(str(x), str(y)) for x, y in pairs])
    fn = {"=": np.equal, "!=": np.not_equal, "<": np.less,
          "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}[op]
    return fn(a, b)


def _eval_binop(e: ast.BinOp, cols, nulls, params, n):
    a, an = eval_expr(e.left, cols, nulls, params, n)
    b, bn = eval_expr(e.right, cols, nulls, params, n)
    nl = _or_null(an, bn)
    op = e.op
    if op == "and":
        av, bv = a.astype(bool), b.astype(bool)
        v = av & bv
        if nl is not None:
            anx = an if an is not None else np.zeros(n, bool)
            bnx = bn if bn is not None else np.zeros(n, bool)
            nl = (anx & bnx) | (anx & bv) | (bnx & av)
            v = v & ~nl
        return v, nl
    if op == "or":
        av, bv = a.astype(bool), b.astype(bool)
        v = av | bv
        if nl is not None:
            anx = an if an is not None else np.zeros(n, bool)
            bnx = bn if bn is not None else np.zeros(n, bool)
            nl = (anx & bnx) | (anx & ~bv) | (bnx & ~av)
        return v, nl
    if op in ("=", "!=", "<", "<=", ">", ">="):
        return _safe_cmp(np.broadcast_to(a, (n,)),
                         np.broadcast_to(b, (n,)), op), nl
    if op == "/":
        af = a.astype(np.float64)
        bf = b.astype(np.float64)
        zero = bf == 0
        nl = _or_null(nl, zero if zero.any() else None)
        return af / np.where(zero, 1, bf), nl
    fn = {"+": np.add, "-": np.subtract, "*": np.multiply,
          "%": np.mod}[op]
    return fn(a, b), nl



def _np_to_days(v, dt_in):
    v = np.asarray(v)
    if dt_in is not None and dt_in.name == "timestamp":
        return (v.astype(np.int64) // 86_400_000_000).astype(np.int64)
    return v.astype(np.int64)


def _np_civil_from_days(days):
    """Vectorized Hinnant civil_from_days (numpy twin of exprs.py)."""
    z = np.asarray(days, dtype=np.int64) + 719468
    era = np.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    y = np.where(m <= 2, y + 1, y)
    return y.astype(np.int64), m.astype(np.int64), d.astype(np.int64)


def _np_days_from_civil(y, m, d):
    y = np.asarray(y, dtype=np.int64) - (np.asarray(m) <= 2)
    era = np.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = np.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).astype(np.int64)


def _np_days_in_month(y, m):
    dim = np.asarray([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                     dtype=np.int64)[np.asarray(m, dtype=np.int64) - 1]
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return np.where((np.asarray(m) == 2) & leap, 29, dim)


def _eval_func(e: ast.Func, cols, nulls, params, n):
    name = e.name
    args = [eval_expr(a, cols, nulls, params, n) for a in e.args]
    if name == "coalesce":
        out_v = np.array(np.broadcast_to(args[-1][0], (n,)), copy=True)
        out_n = args[-1][1]
        out_n = np.array(np.broadcast_to(out_n, (n,)), copy=True) \
            if out_n is not None else np.zeros(n, dtype=bool)
        for v, nl in reversed(args[:-1]):
            use = ~nl if nl is not None else np.ones(n, dtype=bool)
            out_v[use] = np.broadcast_to(v, (n,))[use]
            out_n[use] = False
        return out_v, (out_n if out_n.any() else None)
    if name == "abs":
        return np.abs(args[0][0]), args[0][1]
    if name in ("sqrt", "exp", "ln", "log"):
        fn = {"sqrt": np.sqrt, "exp": np.exp, "ln": np.log,
              "log": np.log}[name]
        return fn(args[0][0].astype(np.float64)), args[0][1]
    if name == "round":
        digits = int(e.args[1].value) if len(e.args) > 1 and \
            isinstance(e.args[1], ast.Lit) else 0
        return np.round(args[0][0].astype(np.float64), digits), args[0][1]
    if name in ("pow", "power"):
        return np.power(args[0][0].astype(np.float64), args[1][0]), \
            _or_null(args[0][1], args[1][1])
    if name in ("year", "month", "day", "dayofmonth", "quarter",
                "dayofyear", "dayofweek", "weekofyear"):
        v, nl = args[0]
        days = _np_to_days(v, expr_type(e.args[0]))
        y, m, d = _np_civil_from_days(days)
        if name in ("year",):
            part = y
        elif name == "month":
            part = m
        elif name in ("day", "dayofmonth"):
            part = d
        elif name == "quarter":
            part = (m + 2) // 3
        elif name == "dayofyear":
            part = days - _np_days_from_civil(y, np.ones_like(m),
                                              np.ones_like(d)) + 1
        elif name == "dayofweek":
            part = (days + 4) % 7 + 1
        else:  # weekofyear (ISO)
            wd = (days + 3) % 7 + 1
            thu = days + (4 - wd)
            ty, _, _ = _np_civil_from_days(thu)
            jan1 = _np_days_from_civil(ty, np.ones_like(ty),
                                       np.ones_like(ty))
            part = (thu - jan1) // 7 + 1
        return part.astype(np.int32), nl
    if name in ("hour", "minute", "second"):
        v, nl = args[0]
        divisor, modulo = {"hour": (3_600_000_000, 24),
                           "minute": (60_000_000, 60),
                           "second": (1_000_000, 60)}[name]
        if expr_type(e.args[0]).name == "timestamp":
            out = (np.asarray(v, dtype=np.int64) // divisor) % modulo
        else:
            out = np.zeros_like(np.asarray(v, dtype=np.int64))
        return out.astype(np.int32), nl
    if name in ("date_add", "date_sub"):
        sign = 1 if name == "date_add" else -1
        a, an = args[0]
        b, bn = args[1]
        days = _np_to_days(a, expr_type(e.args[0]))
        out = days + sign * np.asarray(b, dtype=np.int64)
        return out.astype(np.int32), _or_null(an, bn)
    if name == "datediff":
        a, an = args[0]
        b, bn = args[1]
        out = _np_to_days(a, expr_type(e.args[0])) - \
            _np_to_days(b, expr_type(e.args[1]))
        return out.astype(np.int32), _or_null(an, bn)
    if name == "add_months":
        a, an = args[0]
        b, bn = args[1]
        y, m, d = _np_civil_from_days(_np_to_days(a, expr_type(e.args[0])))
        m0 = y * 12 + (m - 1) + np.asarray(b, dtype=np.int64)
        y2, m2 = m0 // 12, m0 % 12 + 1
        d2 = np.minimum(d, _np_days_in_month(y2, m2))
        return _np_days_from_civil(y2, m2, d2).astype(np.int32), \
            _or_null(an, bn)
    if name == "last_day":
        v, nl = args[0]
        y, m, _d = _np_civil_from_days(_np_to_days(v, expr_type(e.args[0])))
        return _np_days_from_civil(y, m, _np_days_in_month(y, m)) \
            .astype(np.int32), nl
    if name == "trunc":
        v, nl = args[0]
        if len(e.args) < 2 or not isinstance(e.args[1], ast.Lit):
            raise HostEvalError("trunc needs a literal format")
        fmt = str(e.args[1].value).upper()
        days = _np_to_days(v, expr_type(e.args[0]))
        y, m, d = _np_civil_from_days(days)
        one = np.ones_like(m)
        if fmt in ("YEAR", "YYYY", "YY"):
            out = _np_days_from_civil(y, one, one)
        elif fmt in ("MONTH", "MM", "MON"):
            out = _np_days_from_civil(y, m, one)
        elif fmt in ("QUARTER", "Q"):
            out = _np_days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
        elif fmt == "WEEK":
            out = days - (days + 3) % 7
        else:
            raise ValueError(f"trunc format {fmt!r}")
        return out.astype(np.int32), nl
    if name == "months_between":
        a, an = args[0]
        b, bn = args[1]
        y1, m1, d1 = _np_civil_from_days(_np_to_days(a, expr_type(e.args[0])))
        y2, m2, d2 = _np_civil_from_days(_np_to_days(b, expr_type(e.args[1])))
        whole = ((y1 - y2) * 12 + (m1 - m2)).astype(np.float64)
        same = (d1 == d2) | ((d1 == _np_days_in_month(y1, m1))
                             & (d2 == _np_days_in_month(y2, m2)))
        frac = np.where(same, 0.0, (d1 - d2).astype(np.float64) / 31.0)
        return whole + frac, _or_null(an, bn)
    if name == "unix_timestamp":
        v, nl = args[0]
        if expr_type(e.args[0]).name == "timestamp":
            out = np.asarray(v, dtype=np.int64) // 1_000_000
        else:
            out = np.asarray(v, dtype=np.int64) * 86_400
        return out, nl
    if name == "to_date":
        v, nl = args[0]
        dt_in = expr_type(e.args[0])
        if dt_in.name in ("date", "timestamp"):
            return _np_to_days(v, dt_in).astype(np.int32), nl
        epoch = datetime.date(1970, 1, 1).toordinal()
        out = np.zeros(len(v), dtype=np.int32)
        bad = np.zeros(len(v), dtype=bool)
        for i, x in enumerate(v):
            if x is None:
                bad[i] = True
                continue
            try:
                out[i] = datetime.date.fromisoformat(
                    str(x)[:10]).toordinal() - epoch
            except ValueError:
                bad[i] = True
        return out, _or_null(nl, bad if bad.any() else None)
    if name == "ascii":
        v, nl = args[0]
        return np.array([ord(str(x)[0]) if x is not None and str(x)
                         else 0 for x in v], dtype=np.int32), nl
    if name in ("upper", "lower", "trim", "ltrim", "rtrim", "initcap",
                "reverse"):
        fn = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
              "ltrim": str.lstrip, "rtrim": str.rstrip,
              "initcap": lambda s: " ".join(
                  p[:1].upper() + p[1:].lower() for p in s.split(" ")),
              "reverse": lambda s: s[::-1]}[name]
        v, nl = args[0]
        return np.array([fn(str(x)) if x is not None else None for x in v],
                        dtype=object), nl
    if name in ("lpad", "rpad"):
        v, nl = args[0]
        n2 = int(np.asarray(args[1][0]).flat[0])
        pad = str(np.asarray(args[2][0]).flat[0]) if len(args) > 2 else " "

        def padfn(x):
            if x is None:
                return None
            if n2 <= 0:
                return ""
            sx = str(x)
            if len(sx) >= n2:
                return sx[:n2]
            fill = (pad * n2)[:n2 - len(sx)] if pad else ""
            return fill + sx if name == "lpad" else sx + fill

        return np.array([padfn(x) for x in v], dtype=object), nl
    if name == "repeat":
        v, nl = args[0]
        times = int(np.asarray(args[1][0]).flat[0])
        return np.array([str(x) * max(0, times) if x is not None else None
                         for x in v], dtype=object), nl
    if name == "translate":
        v, nl = args[0]
        frm = str(np.asarray(args[1][0]).flat[0])
        to = str(np.asarray(args[2][0]).flat[0]) if len(args) > 2 else ""
        table = {ord(f): (to[i] if i < len(to) else None)
                 for i, f in enumerate(frm)}
        return np.array([str(x).translate(table) if x is not None else None
                         for x in v], dtype=object), nl
    if name == "split_part":
        v, nl = args[0]
        delim = str(np.asarray(args[1][0]).flat[0])
        idx = int(np.asarray(args[2][0]).flat[0])
        if idx == 0:
            raise HostEvalError("split_part index must not be 0")

        def part(x):
            if x is None:
                return None
            parts = str(x).split(delim) if delim else [str(x)]
            pos = idx - 1 if idx > 0 else len(parts) + idx
            return parts[pos] if 0 <= pos < len(parts) else ""

        return np.array([part(x) for x in v], dtype=object), nl
    if name in ("substr", "substring"):
        v, nl = args[0]
        start = int(np.asarray(args[1][0]).flat[0]) - 1 if len(args) > 1 else 0
        ln = int(np.asarray(args[2][0]).flat[0]) if len(args) > 2 else None
        def sub(x):
            if x is None:
                return None
            s = str(x)
            return s[start:start + ln] if ln is not None else s[start:]
        return np.array([sub(x) for x in v], dtype=object), nl
    if name == "length":
        v, nl = args[0]
        return np.array([len(str(x)) if x is not None else 0 for x in v],
                        dtype=np.int32), nl
    if name == "nullif":
        a_v, a_n = args[0]
        b_v, b_n = args[1]
        av = np.broadcast_to(a_v, (n,))
        eq = _safe_cmp(av, np.broadcast_to(b_v, (n,)), "=")
        if b_n is not None:
            eq = eq & ~np.broadcast_to(b_n, (n,))
        out_n = np.array(eq, copy=True)
        if a_n is not None:
            out_n |= np.broadcast_to(a_n, (n,))
        return np.array(av, copy=True), (out_n if out_n.any() else None)
    if name in ("floor", "ceil", "ceiling"):
        fn = np.floor if name == "floor" else np.ceil
        return fn(np.asarray(args[0][0]).astype(np.float64)) \
            .astype(np.int64), args[0][1]
    if name in ("mod", "pmod"):
        a_v = np.broadcast_to(args[0][0], (n,))
        b_v = np.broadcast_to(args[1][0], (n,))
        nl = _or_null(args[0][1], args[1][1])
        zero = b_v == 0
        if zero.any():
            nl = _or_null(nl, zero)
        b_safe = np.where(zero, 1, b_v)
        # mod keeps the dividend's sign (Spark %); pmod is non-negative
        out = np.fmod(a_v, b_safe) if name == "mod" \
            else np.mod(np.mod(a_v, b_safe) + b_safe, b_safe)
        return out, nl
    if name in ("greatest", "least"):
        vs = np.stack([np.asarray(np.broadcast_to(a[0], (n,)))
                       for a in args])
        nls = np.stack([np.broadcast_to(a[1], (n,)) if a[1] is not None
                        else np.zeros(n, dtype=bool) for a in args])
        masked = np.ma.masked_array(vs, mask=nls)
        picked = masked.max(axis=0) if name == "greatest" \
            else masked.min(axis=0)
        out_n = nls.all(axis=0)   # NULL only when every argument is NULL
        return np.asarray(picked.filled(0)), (out_n if out_n.any()
                                              else None)
    if name == "replace":
        v, nl = args[0]
        if args[1][1] is not None or \
                (len(args) > 2 and args[2][1] is not None):
            # Spark: NULL search/replacement → NULL result
            return np.full(n, None, dtype=object), np.ones(n, dtype=bool)
        search = str(np.asarray(args[1][0]).flat[0])
        repl = str(np.asarray(args[2][0]).flat[0]) if len(args) > 2 else ""
        return np.array([str(x).replace(search, repl)
                         if x is not None else None for x in v],
                        dtype=object), nl
    if name == "sign":
        return np.sign(np.asarray(args[0][0]).astype(np.float64)), \
            args[0][1]
    if name == "instr":
        v, nl = args[0]
        sub = str(np.asarray(args[1][0]).flat[0])
        return np.array([str(x).find(sub) + 1 if x is not None else 0
                         for x in v], dtype=np.int32), nl
    if name == "array":
        vs = [np.broadcast_to(a[0], (n,)) for a in args]
        nls = [a[1] for a in args]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = [None if (nls[j] is not None
                               and np.broadcast_to(nls[j], (n,))[i])
                      else _plain(vs[j][i]) for j in range(len(vs))]
        return out, None
    if name == "map":
        vs = [np.broadcast_to(a[0], (n,)) for a in args]
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = {_plain(vs[j][i]): _plain(vs[j + 1][i])
                      for j in range(0, len(vs), 2)}
        return out, None
    if name == "named_struct":
        out = np.empty(n, dtype=object)
        keys = [np.broadcast_to(args[i][0], (n,))
                for i in range(0, len(args) - 1, 2)]
        vals = [np.broadcast_to(args[i][0], (n,))
                for i in range(1, len(args), 2)]
        vnulls = [np.broadcast_to(args[i][1], (n,))
                  if args[i][1] is not None else None
                  for i in range(1, len(args), 2)]
        for r in range(n):
            out[r] = {str(k[r]): (None if vn is not None and vn[r]
                                  else _plain(v[r]))
                      for k, v, vn in zip(keys, vals, vnulls)}
        return out, None
    if name in ("map_keys", "map_values"):
        v, nl = args[0]
        out = np.empty(n, dtype=object)
        for i, x in enumerate(np.broadcast_to(v, (n,))):
            if isinstance(x, dict):
                out[i] = list(x.keys()) if name == "map_keys" \
                    else list(x.values())
            else:
                out[i] = None
        return out, nl
    if name == "size":
        v, nl = args[0]
        out = np.array(
            [len(x) if isinstance(x, (list, tuple, dict)) else -1
             for x in np.broadcast_to(v, (n,))], dtype=np.int32)
        return out, nl
    if name == "array_contains":
        v, nl = args[0]
        needle = np.broadcast_to(args[1][0], (n,))
        needle_null = args[1][1]
        out = np.array(
            [isinstance(x, (list, tuple)) and _plain(needle[i]) in x
             for i, x in enumerate(np.broadcast_to(v, (n,)))])
        combined = nl
        if needle_null is not None:
            nn = np.broadcast_to(needle_null, (n,))
            combined = nn if combined is None else (combined | nn)
        return out, combined
    if name == "element_at":
        v, nl = args[0]
        idx = np.broadcast_to(args[1][0], (n,))
        vals = []
        nulls_out = np.zeros(n, dtype=bool)
        for i, x in enumerate(np.broadcast_to(v, (n,))):
            if isinstance(x, dict):  # map/struct lookup by key
                k = _plain(idx[i])
                got = x.get(k)
                if got is None and isinstance(k, str):
                    # struct field names resolve case-insensitively, like
                    # the analyzer's StructType.field_type
                    for kk, vv in x.items():
                        if isinstance(kk, str) and kk.lower() == k.lower():
                            got = vv
                            break
                vals.append(got)
                nulls_out[i] = got is None
                continue
            if not isinstance(x, (list, tuple)):  # NULL map/array row
                vals.append(None)
                nulls_out[i] = True
                continue
            k = int(idx[i]) - 1  # element_at on arrays is 1-based
            if 0 <= k < len(x):
                vals.append(x[k])
                nulls_out[i] = x[k] is None
            else:
                vals.append(None)
                nulls_out[i] = True
        out = np.array(vals, dtype=object)
        if nl is not None:
            nulls_out |= np.broadcast_to(nl, (n,))
        return out, (nulls_out if nulls_out.any() else None)
    if name == "concat":
        vs = [np.broadcast_to(a[0], (n,)) for a in args]
        nl = None
        for a in args:
            nl = _or_null(nl, a[1])
        return np.array(["".join(str(x) for x in row)
                         for row in zip(*vs)], dtype=object), nl

    from snappydata_tpu_torch.sql import udf as _udf

    u = _udf.lookup(name)
    if u is not None:
        vals = [np.broadcast_to(v, (n,)) for v, _ in args]
        try:
            out = np.asarray(u.fn(*vals))
        except Exception as ex:
            raise HostEvalError(f"UDF {name} failed: {ex}")
        if out.shape != (n,):
            out = np.broadcast_to(out, (n,))
        nl = None
        for _, a_nl in args:
            nl = _or_null(nl, a_nl)
        return out, nl

    raise HostEvalError(f"unsupported host function {name}")


def _to_str(x):
    return None if x is None else str(x)


def _plain(x):
    return x.item() if hasattr(x, "item") else x


def _or_null(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


# --------------------------------------------------------------------------
# Result-level ops
# --------------------------------------------------------------------------

from snappydata_tpu_torch.engine.result import Result  # noqa: E402
from snappydata_tpu_torch.engine.result import \
    unscale_decimal_col as _unscale_decimal_col  # noqa: E402


def limit(result: Result, k: int) -> Result:
    return Result(result.names,
                  [c[:k] for c in result.columns],
                  [nm[:k] if nm is not None else None for nm in result.nulls],
                  result.dtypes)


def _hashable(row):
    return tuple(tuple(v) if isinstance(v, list) else v for v in row)


def distinct(result: Result) -> Result:
    seen = set()
    keep = []
    for i, row in enumerate(result.rows()):
        key = _hashable(row)
        if key not in seen:
            seen.add(key)
            keep.append(i)
    idx = np.array(keep, dtype=np.int64)
    return _take(result, idx)


def _take(result: Result, idx: np.ndarray) -> Result:
    return Result(result.names,
                  [c[idx] for c in result.columns],
                  [nm[idx] if nm is not None else None for nm in result.nulls],
                  result.dtypes)


def _float_domain_columns(result: Result) -> List[np.ndarray]:
    """Result columns with exact-decimal scaled-int64 columns (the
    compiled engine's representation) unscaled to plain float64 — what
    result-level EXPRESSIONS (sort keys, HAVING predicates, projected
    arithmetic) must consume. `_take`-style passthroughs keep the
    original scaled columns, so exactness survives sort/limit/filter."""
    return [_unscale_decimal_col(c, dt)
            for c, dt in zip(result.columns, result.dtypes)]


def sort(result: Result, orders, params) -> Result:
    n = result.num_rows
    if n == 0:
        return result
    fcols = _float_domain_columns(result)
    keys = []
    for item in reversed(list(orders)):
        e, asc = item[0], item[1]
        nulls_first = item[2] if len(item) > 2 and item[2] is not None \
            else asc   # Spark default: ASC → NULLS FIRST, DESC → LAST
        v, nl = eval_expr(e, fcols, result.nulls, params, n)
        v = np.broadcast_to(v, (n,))
        isnull = np.broadcast_to(nl, (n,)).copy() if nl is not None \
            else np.zeros(n, dtype=bool)
        if v.dtype == object:
            isnull = isnull | np.array([x is None for x in v])
            v = np.array([("" if x is None else str(x)) for x in v])
        if not asc:
            if v.dtype.kind in "OUS":
                # lexsort is ascending-only: invert via rank
                order_idx = np.argsort(v, kind="stable")
                rank = np.empty(n, dtype=np.int64)
                rank[order_idx] = np.arange(n)
                v = -rank
            else:
                v = -v
        keys.append(v)
        # null indicator sorts ascending: False before True
        keys.append(~isnull if nulls_first else isnull)
    idx = np.lexsort(keys) if keys else np.arange(n)
    return _take(result, idx)


def filter_result(result: Result, cond: ast.Expr, params) -> Result:
    n = result.num_rows
    v, nl = eval_expr(cond, _float_domain_columns(result), result.nulls,
                      params, n)
    keep = np.broadcast_to(v, (n,)).astype(bool)
    if nl is not None:
        keep = keep & ~nl
    return _take(result, np.nonzero(keep)[0])


def project_result(result: Result, exprs, params) -> Result:
    n = result.num_rows
    fcols = _float_domain_columns(result)
    names, cols, nulls, dtypes = [], [], [], []
    for e in exprs:
        base = e.child if isinstance(e, ast.Alias) else e
        if isinstance(base, ast.Col) and base.index is not None:
            # bare column pass-through keeps the ORIGINAL representation
            # (exact-decimal scaled ints survive a result-level SELECT)
            v = result.columns[base.index]
            nl = result.nulls[base.index]
        else:
            v, nl = eval_expr(e, fcols, result.nulls, params, n)
        names.append(_expr_name(e))
        cols.append(np.broadcast_to(v, (n,)))
        nulls.append(np.broadcast_to(nl, (n,)) if nl is not None else None)
        dtypes.append(expr_type(e))
    return Result(names, cols, nulls, dtypes)


# _unscale_decimal_col binds at module bottom (the established
# cycle-avoiding import spot) to engine.result.unscale_decimal_col


def union(a: Result, b: Result) -> Result:
    cols = []
    nulls = []
    dtypes = list(a.dtypes)
    for i in range(len(a.columns)):
        ca, cb = a.columns[i], b.columns[i]
        if (a.dtypes[i] is not None and a.dtypes[i].name == "decimal") \
                or (b.dtypes[i] is not None
                    and b.dtypes[i].name == "decimal"):
            # branches may sit in different domains (scaled int vs
            # float) or at different scales: normalize both through
            # each branch's OWN dtype before concatenating, and WIDEN
            # the declared type over both branches so a finer right-
            # branch scale survives the decode quantization (Spark
            # widens union types the same way; review finding)
            ca = _unscale_decimal_col(ca, a.dtypes[i])
            cb = _unscale_decimal_col(cb, b.dtypes[i])
            if a.dtypes[i] != b.dtypes[i] and b.dtypes[i] is not None \
                    and a.dtypes[i] is not None:
                try:
                    dtypes[i] = T.common_type(a.dtypes[i], b.dtypes[i])
                except TypeError:
                    pass
        if ca.dtype != cb.dtype:
            ca = ca.astype(object)
            cb = cb.astype(object)
        cols.append(np.concatenate([ca, cb]))
        na = a.nulls[i] if a.nulls[i] is not None else np.zeros(
            a.num_rows, dtype=bool)
        nb = b.nulls[i] if b.nulls[i] is not None else np.zeros(
            b.num_rows, dtype=bool)
        merged = np.concatenate([na, nb])
        nulls.append(merged if merged.any() else None)
    return Result(a.names, cols, nulls, dtypes)


def set_op(a: Result, b: Result, op: str) -> Result:
    """INTERSECT / EXCEPT with SQL set semantics: DISTINCT output, and
    NULLs compare EQUAL (unlike joins) — row-tuples with None make that
    free in Python. Exact-decimal columns compare through each branch's
    own unscaled domain (the same alignment union() applies), so a
    scaled-int branch can intersect a float branch."""
    def row_tuples(r: Result):
        rcols = [_unscale_decimal_col(c, dt)
                 for c, dt in zip(r.columns, r.dtypes)]
        out = []
        for i in range(r.num_rows):
            row = []
            for c, nm in zip(rcols, r.nulls):
                if (nm is not None and nm[i]) or \
                        (c.dtype == object and c[i] is None):
                    row.append(None)
                else:
                    v = c[i]
                    row.append(v.item() if hasattr(v, "item") else v)
            out.append(tuple(row))
        return out

    right = set(row_tuples(b))
    seen = set()
    keep_idx = []
    for i, row in enumerate(row_tuples(a)):
        if row in seen:
            continue
        seen.add(row)
        if (op == "intersect") == (row in right):
            keep_idx.append(i)
    idx = np.asarray(keep_idx, dtype=np.int64)
    # output decimal columns leave in the UNSCALED domain with the
    # dtype widened over both branches — the analyzer's SetOp scope is
    # widened the same way, so a left-branch scaled column must not be
    # decoded at the (possibly finer) widened scale (review finding)
    cols = []
    dtypes = list(a.dtypes)
    for i, c in enumerate(a.columns):
        if (a.dtypes[i] is not None and a.dtypes[i].name == "decimal") \
                or (b.dtypes[i] is not None
                    and b.dtypes[i].name == "decimal"):
            c = _unscale_decimal_col(c, a.dtypes[i])
            if a.dtypes[i] != b.dtypes[i] and a.dtypes[i] is not None \
                    and b.dtypes[i] is not None:
                try:
                    dtypes[i] = T.common_type(a.dtypes[i], b.dtypes[i])
                except TypeError:
                    pass
        cols.append(c[idx])
    nulls = [nm[idx] if nm is not None else None for nm in a.nulls]
    return Result(a.names, cols, nulls, dtypes)


def eval_values(node: ast.Values, params) -> Result:
    nrows = len(node.rows)
    ncols = len(node.rows[0])
    names = [f"col{i + 1}" for i in range(ncols)]
    cols, nulls, dtypes = [], [], []
    for c in range(ncols):
        vals = []
        nmask = np.zeros(nrows, dtype=bool)
        dt = expr_type(node.rows[0][c])
        for r in range(nrows):
            e = node.rows[r][c]
            if isinstance(e, (ast.ParamLiteral, ast.Param)):
                v = params[e.pos]
            elif isinstance(e, ast.Lit):
                v = e.value
            else:
                v, nl = eval_expr(e, [], [], params, 1)
                v = v[0]
            if v is None:
                nmask[r] = True
                vals.append(None)
            else:
                vals.append(v)
        if dt.name in ("string", "array", "map") or dt.np_dtype == object:
            # element-wise: np.array() would turn equal-length lists
            # into a 2-D array and strip their list-ness
            arr = np.empty(len(vals), dtype=object)
            for j, v in enumerate(vals):
                arr[j] = v
        else:
            arr = np.array([0 if v is None else v for v in vals],
                           dtype=dt.np_dtype)
        cols.append(arr)
        nulls.append(nmask if nmask.any() else None)
        dtypes.append(dt)
    return Result(names, cols, nulls, dtypes)


# --------------------------------------------------------------------------
# Window functions (host fallback for shapes the device window path in
# engine/executor.py does not cover — e.g. exotic frames / ntile)
# --------------------------------------------------------------------------

def eval_window(plan, params, executor) -> Result:
    """WindowProject: materialize the child, then evaluate each select
    expression; WindowFunc nodes compute per-partition with pandas.
    Default frames: whole partition without ORDER BY; running frame
    (unbounded preceding → current row) with it."""
    import pandas as pd

    cols, nulls, names, dtypes, n = _eval_rel(plan.child, params, executor)

    def eval_any(e, depth=0):
        """Returns (values, nullmask); recurses through WindowFunc."""
        if isinstance(e, ast.Alias):
            return eval_any(e.child)
        if isinstance(e, ast.WindowFunc):
            return _window_values(e, cols, nulls, params, n)
        # ordinary expression, but it may CONTAIN window funcs: substitute
        # their computed values as pseudo-columns
        subs = {}

        def find(node):
            if isinstance(node, ast.WindowFunc):
                subs[id(node)] = node
            for c in node.children():
                find(c)

        find(e)
        if not subs:
            return eval_expr(e, cols, nulls, params, n)
        ext_cols = list(cols)
        ext_nulls = list(nulls)

        def replace(node):
            if isinstance(node, ast.WindowFunc):
                v, nl = _window_values(node, cols, nulls, params, n)
                idx = len(ext_cols)
                ext_cols.append(v)
                ext_nulls.append(nl)
                return ast.Col(f"__w{idx}", None, idx,
                               expr_type(node))
            return node.map_children(replace)

        return eval_expr(replace(e), ext_cols, ext_nulls, params, n)

    out_c, out_n, out_names, out_t = [], [], [], []
    for e in plan.exprs:
        v, nl = eval_any(e)
        v = np.broadcast_to(v, (n,))
        dt = expr_type(e)
        # pandas paths float-promote ints (NaN machinery): restore the
        # declared integer dtype so values and Result.dtypes agree
        if T.is_integral(dt) and v.dtype.kind == "f":
            filler = np.where(np.isnan(v), 0, v) if v.dtype.kind == "f" \
                else v
            v = filler.astype(dt.np_dtype)
        out_c.append(v)
        out_n.append(np.broadcast_to(nl, (n,)) if nl is not None else None)
        out_names.append(_expr_name(e))
        out_t.append(dt)
    return Result(out_names, list(out_c), list(out_n), out_t)


def _window_values(w, cols, nulls, params, n):
    import pandas as pd

    # partition keys: each key's null mask is a key of its own and the
    # value under it is blanked, so all NULLs of a key form one partition
    # (as the reference's device lane has them)
    if w.partition_by:
        keys = {}
        for i, p in enumerate(w.partition_by):
            v, nl = eval_expr(p, cols, nulls, params, n)
            v = np.broadcast_to(v, (n,))
            if nl is not None:
                isnull = np.broadcast_to(nl, (n,))
                blank = None if v.dtype == object \
                    else np.zeros((), dtype=v.dtype)
                v = np.where(isnull, blank, v)
                keys[f"n{i}"] = isnull
            keys[f"k{i}"] = v
        part_df = pd.DataFrame(keys)
        group_ids = part_df.groupby(list(part_df.columns), sort=False,
                                    dropna=False).ngroup().to_numpy()
    else:
        group_ids = np.zeros(n, dtype=np.int64)
    # intra-partition order
    if w.order_by:
        order_keys = []
        for item in reversed(list(w.order_by)):
            e, asc = item[0], item[1]
            nulls_first = item[2] if len(item) > 2 and item[2] is not None \
                else asc   # Spark: ASC → NULLS FIRST, DESC → NULLS LAST
            v, nl = eval_expr(e, cols, nulls, params, n)
            v = np.broadcast_to(v, (n,))
            isnull = np.broadcast_to(nl, (n,)).copy() if nl is not None \
                else np.zeros(n, dtype=bool)
            if v.dtype == object:
                isnull = isnull | np.array([x is None for x in v])
                v = np.array([str(x) if x is not None else "" for x in v])
            order_keys.append(v if asc else _desc_key(v))
            order_keys.append(~isnull if nulls_first else isnull)
        order_keys.append(group_ids)
        sorted_idx = np.lexsort(order_keys)
    else:
        sorted_idx = np.argsort(group_ids, kind="stable")

    g_sorted = group_ids[sorted_idx]
    s = pd.Series(np.arange(n)[sorted_idx])
    grp = s.groupby(g_sorted)

    name = w.name
    if name == "row_number":
        out_sorted = grp.cumcount().to_numpy() + 1
        return _unsort(out_sorted, sorted_idx, np.int64), None
    if name in ("rank", "dense_rank"):
        # tie groups: consecutive sorted rows equal on ALL order keys
        ok_sorted = []
        for e, *_ in w.order_by:
            v, _ = eval_expr(e, cols, nulls, params, n)
            v = np.broadcast_to(v, (n,))
            if v.dtype == object:
                v = np.array([str(x) if x is not None else "" for x in v])
            ok_sorted.append(v[sorted_idx])
        same = np.ones(n, dtype=bool)
        if n:
            same[0] = False
        same[1:] &= g_sorted[1:] == g_sorted[:-1]
        for k in ok_sorted:
            same[1:] &= k[1:] == k[:-1]
        pos_in_part = grp.cumcount().to_numpy()
        start = pd.Series(np.where(same, np.nan, pos_in_part)).ffill()
        if name == "rank":
            out_sorted = start.to_numpy().astype(np.int64) + 1
        else:
            out_sorted = pd.Series(
                (~same).astype(np.int64)).groupby(g_sorted).cumsum() \
                .to_numpy()
        return _unsort(out_sorted, sorted_idx, np.int64), None
    if name == "ntile":
        k = int(params[w.args[0].pos]
                if isinstance(w.args[0], ast.ParamLiteral)
                else w.args[0].value)
        pos = grp.cumcount().to_numpy()
        size = s.groupby(g_sorted).transform("size").to_numpy()
        out_sorted = (pos * k // size) + 1
        return _unsort(out_sorted, sorted_idx, np.int64), None
    if name in ("lag", "lead"):
        v, nl = eval_expr(w.args[0], cols, nulls, params, n)
        v = np.broadcast_to(v, (n,))
        offset = 1
        if len(w.args) > 1 and isinstance(w.args[1],
                                          (ast.Lit, ast.ParamLiteral)):
            offset = int(params[w.args[1].pos]
                         if isinstance(w.args[1], ast.ParamLiteral)
                         else w.args[1].value)
        shift = offset if name == "lag" else -offset
        ser = pd.Series(v[sorted_idx])
        # a NULL input must shift in as NULL, not as its filler value
        if nl is not None:
            in_null = np.broadcast_to(nl, (n,))[sorted_idx]
            ser = ser.where(~pd.Series(in_null), np.nan)
        shifted = ser.groupby(g_sorted).shift(shift)
        out_nulls_sorted = shifted.isna().to_numpy()
        filled = shifted.fillna(0 if v.dtype != object else "").to_numpy()
        out = _unsort(filled, sorted_idx, None)
        out_nl = _unsort(out_nulls_sorted, sorted_idx, np.bool_)
        return out, (out_nl if out_nl.any() else None)
    if name in ("sum", "avg", "min", "max", "count", "first_value",
                "last_value"):
        if w.args:
            v, nl = eval_expr(w.args[0], cols, nulls, params, n)
            v = np.broadcast_to(v, (n,))
            isnull = np.broadcast_to(nl, (n,)).copy() if nl is not None \
                else np.zeros(n, dtype=bool)
            if v.dtype == object:
                isnull = isnull | np.array([x is None for x in v])
            # NULLs → NaN so pandas skips them (SQL aggregate semantics)
            vf = v.astype(np.float64) if v.dtype != object else v
            if isnull.any() and v.dtype != object:
                vf = vf.copy()
                vf[isnull] = np.nan
        else:
            vf = np.ones(n)
            isnull = np.zeros(n, dtype=bool)
        ser = pd.Series(vf[sorted_idx])
        if isnull.any() and vf.dtype == object:
            ser = ser.where(~pd.Series(isnull[sorted_idx]), np.nan)
        g = ser.groupby(g_sorted)
        if w.order_by:
            # SQL default frame with ORDER BY is RANGE → peers (tied
            # order keys) share the frame: compute running values, then
            # take the LAST value of each tie group
            ok_sorted = []
            for e, *_ in w.order_by:
                vv, _ = eval_expr(e, cols, nulls, params, n)
                vv = np.broadcast_to(vv, (n,))
                if vv.dtype == object:
                    vv = np.array([str(x) if x is not None else ""
                                   for x in vv])
                ok_sorted.append(vv[sorted_idx])
            same = np.ones(n, dtype=bool)
            if n:
                same[0] = False
            same[1:] &= g_sorted[1:] == g_sorted[:-1]
            for k in ok_sorted:
                same[1:] &= k[1:] == k[:-1]
            tie_gid = np.cumsum(~same)
            if name == "avg":
                run = (g.cumsum() /
                       ser.notna().groupby(g_sorted).cumsum()).to_numpy()
            elif name == "count":
                run = ser.notna().groupby(g_sorted).cumsum().to_numpy()
            elif name == "first_value":
                run = g.transform("first").to_numpy()
            elif name == "last_value":
                run = ser.to_numpy()
            else:
                run = getattr(g, {"sum": "cumsum", "min": "cummin",
                                  "max": "cummax"}[name])().to_numpy()
            out_sorted = pd.Series(run).groupby(tie_gid).transform(
                "last").to_numpy()
        else:  # whole partition
            agg = {"sum": "sum", "avg": "mean", "min": "min", "max": "max",
                   "count": "count", "first_value": "first",
                   "last_value": "last"}[name]
            out_sorted = g.transform(agg).to_numpy()
        out = _unsort(out_sorted, sorted_idx, None)
        if name == "count":
            return out.astype(np.int64), None
        out_null = pd.isna(out)
        if out_null.any():
            return np.where(out_null, 0, out), np.asarray(out_null)
        return out, None
    raise HostEvalError(f"window function {name}")


def _desc_key(v: np.ndarray):
    if v.dtype.kind in "OUS":
        order_idx = np.argsort(v, kind="stable")
        rank = np.empty(len(v), dtype=np.int64)
        rank[order_idx] = np.arange(len(v))
        return -rank
    return -v


def _unsort(sorted_vals, sorted_idx, dtype):
    out = np.empty(len(sorted_vals),
                   dtype=sorted_vals.dtype if dtype is None else dtype)
    out[sorted_idx] = sorted_vals
    return out


# --------------------------------------------------------------------------
# Full-plan host fallback (pandas-based relational interpreter)
# --------------------------------------------------------------------------

def eval_plan(plan: ast.Plan, params, executor) -> Result:
    check_current()  # host fallback entry = cancellation point
    cols, nulls, names, dtypes, n = _eval_rel(plan, params, executor)
    return Result(names, cols, nulls, dtypes)


def _eval_rel(plan: ast.Plan, params, executor):
    """Returns (cols, nulls, names, dtypes, n) with host arrays."""
    if isinstance(plan, ast.Relation):
        info = executor.catalog.lookup_table(plan.name)
        from snappydata_tpu_torch.storage import mvcc
        from snappydata_tpu_torch.storage.device import host_scan_units
        from snappydata_tpu_torch.storage.table_store import RowTableData

        if isinstance(info.data, RowTableData):
            # pinned statements read their captured host snapshot (row
            # tables mutate in place; repeatable reads within the query)
            arrays, col_nulls, n, _ver = mvcc.row_snapshot_of(info.data)
            return ([np.asarray(a) for a in arrays], list(col_nulls),
                    info.schema.names(),
                    [f.dtype for f in info.schema.fields], n)
        # honor the active scan window (the same pinned snapshot and unit
        # slice as build_device_table): a tile of a scan_tile_bytes pass
        # that falls back to the host (the exact-decimal overflow guard
        # fired) must read ITS tile only, or the merge double-counts
        # every other tile
        m, views, row_chunks = host_scan_units(info.data)
        chunks: List[List[np.ndarray]] = [[] for _ in info.schema.fields]
        nchunks: List[List[np.ndarray]] = [[] for _ in info.schema.fields]
        for view in views:
            check_current()  # batch boundary = cancellation point
            live = view.live_mask()
            lazy = info.data._decode_all(view)
            for i, f in enumerate(info.schema.fields):
                chunks[i].append(lazy[f.name][live])
                nm = view.null_mask(i)
                nchunks[i].append(
                    nm[live] if nm is not None
                    else np.zeros(int(live.sum()), dtype=np.bool_))
        for pos, take in row_chunks:
            sl = slice(pos, pos + take)
            for i, f in enumerate(info.schema.fields):
                chunks[i].append(np.asarray(m.row_arrays[i])[sl])
                rn = m.row_nulls[i][sl] if m.row_nulls and \
                    m.row_nulls[i] is not None else \
                    np.zeros(take, dtype=np.bool_)
                nchunks[i].append(rn)
        cols = [np.concatenate(ch) if ch else
                np.empty(0, dtype=f.dtype.np_dtype)
                for ch, f in zip(chunks, info.schema.fields)]
        col_nulls = []
        for nc in nchunks:
            merged = np.concatenate(nc) if nc else \
                np.empty(0, dtype=np.bool_)
            col_nulls.append(merged if merged.any() else None)
        n = int(cols[0].shape[0]) if cols else 0
        names = info.schema.names()
        dtypes = [f.dtype for f in info.schema.fields]
        return cols, col_nulls, names, dtypes, n

    if isinstance(plan, ast.SubqueryAlias):
        return _eval_rel(plan.child, params, executor)

    if isinstance(plan, ast.Filter) and isinstance(plan.child, ast.Join) \
            and plan.child.how in ("inner", "cross"):
        # a WHERE over an inner / cross join is its ON condition (same
        # column ordinals): its equi conjuncts hash-join instead of
        # filtering the whole cross product, and the pairs keep the cross
        # product's order
        j = plan.child
        cond = plan.condition if j.condition is None \
            else ast.BinOp("and", j.condition, plan.condition)
        return _eval_join(dataclasses.replace(j, how="inner",
                                              condition=cond),
                          params, executor, cross_order=True)

    if isinstance(plan, ast.Filter):
        cols, nulls, names, dtypes, n = _eval_rel(plan.child, params, executor)
        v, nl = eval_expr(plan.condition, cols, nulls, params, n)
        keep = np.broadcast_to(v, (n,)).astype(bool)
        if nl is not None:
            keep &= ~nl
        idx = np.nonzero(keep)[0]
        return ([c[idx] for c in cols],
                [nm[idx] if nm is not None else None for nm in nulls],
                names, dtypes, len(idx))

    if isinstance(plan, ast.Project):
        cols, nulls, names, dtypes, n = _eval_rel(plan.child, params, executor)
        out_c, out_n, out_names, out_t = [], [], [], []
        for e in plan.exprs:
            v, nl = eval_expr(e, cols, nulls, params, n)
            out_c.append(np.broadcast_to(v, (n,)))
            out_n.append(np.broadcast_to(nl, (n,)) if nl is not None else None)
            out_names.append(_expr_name(e))
            out_t.append(expr_type(e))
        return out_c, out_n, out_names, out_t, n

    if isinstance(plan, ast.Join):
        return _eval_join(plan, params, executor)

    if isinstance(plan, ast.Aggregate):
        got = _device_aggregate(plan, params, executor)
        if got is not None:
            return got
        return _eval_aggregate(plan, params, executor)

    if isinstance(plan, (ast.Sort, ast.Limit, ast.Distinct, ast.Union,
                         ast.SetOp, ast.Values, ast.WindowProject)):
        r = executor.execute(plan, params)
        # the compiled engine's exact-decimal columns are scaled int64;
        # the host interpreter's expressions/joins above this node work
        # in the plain float domain
        return (_float_domain_columns(r), r.nulls, r.names, r.dtypes,
                r.num_rows)

    raise HostEvalError(f"host fallback: {type(plan).__name__}")


# aggregates whose device answer is the host lane's (its first / last,
# stddev / variance and distinct counts do not all agree, and neither
# does arithmetic over an all-NULL group's min / max)
_DEVICE_AGGS = ("sum", "count", "avg", "min", "max")


def _device_aggregate(plan: ast.Aggregate, params, executor):
    """(cols, nulls, names, dtypes, n) of a GROUP BY over one column table
    (through Filter / Project / alias only) whose select list holds only
    its keys and bare sum / count / avg / min / max, computed by the
    device program when it lowers, in the host lane's row order (keys
    ascending); None otherwise, and the host lane evaluates it.  The
    host lane's own aggregate decodes every column and loops per group
    in Python, which cannot finish at the card's scale.  A join below
    stays on the host (its routing counts), as does a row table.

    Where the device program's answer is not the host lane's, the host
    lane's stands: a sum / min / max over a group with no non-NULL input
    is NULL (the program adds a count of each such argument to find
    those groups; alone it gives 0 / +inf / -inf), and a result with a
    NULL or NaN key goes back to the host lane (the program keeps NULL
    keys apart by the values under their masks, and NaN apart from
    NULL, where the host lane merges them)."""
    from snappydata_tpu_torch.storage.table_store import RowTableData

    if not plan.group_exprs:
        return None
    node = plan.child
    while isinstance(node, (ast.Filter, ast.Project, ast.SubqueryAlias)):
        node = node.children()[0]
    if not isinstance(node, ast.Relation):
        return None
    info = executor.catalog.lookup_table(node.name)
    if info is None or isinstance(info.data, RowTableData):
        return None
    outs = [e.child if isinstance(e, ast.Alias) else e
            for e in plan.agg_exprs]
    if not all(e in plan.group_exprs
               or (isinstance(e, ast.Func) and e.name in _DEVICE_AGGS
                   and not e.distinct)
               for e in outs):
        return None
    key_pos = []
    for g in plan.group_exprs:
        if g not in outs:
            return None
        key_pos.append(outs.index(g))
    counted = []   # the arguments of sum / min / max, each counted once
    for e in outs:
        if e not in plan.group_exprs and e.name != "count" \
                and e.name != "avg" and e.args not in counted:
            counted.append(e.args)
    width = len(outs)
    r = executor.try_device(dataclasses.replace(
        plan, agg_exprs=tuple(plan.agg_exprs)
        + tuple(ast.Func("count", a) for a in counted)), params)
    if r is None:
        return None
    cols = _float_domain_columns(r)[:width]
    nulls = list(r.nulls[:width])
    keys = []
    for p in reversed(key_pos):
        if nulls[p] is not None and np.asarray(nulls[p]).any():
            return None
        v = np.asarray(cols[p])
        if v.dtype.kind == "f" and np.isnan(v).any():
            return None
        keys.append(v)
    for i, e in enumerate(outs):
        if e in plan.group_exprs or e.name in ("count", "avg"):
            continue
        empty = np.asarray(r.columns[width + counted.index(e.args)]) == 0
        if empty.any():
            nulls[i] = empty if nulls[i] is None \
                else np.asarray(nulls[i], dtype=bool) | empty
    order = np.lexsort(keys) if r.num_rows > 1 \
        else np.arange(r.num_rows)
    return ([np.asarray(c)[order] for c in cols],
            [np.asarray(m)[order] if m is not None else None
             for m in nulls],
            list(r.names[:width]), list(r.dtypes[:width]), r.num_rows)


def _eval_join(plan: ast.Join, params, executor, cross_order=False):
    """`cross_order`: inner-join pairs in the order of the cross product
    (left row, then right row), as a WHERE filter over it would give."""
    import pandas as pd

    lc, ln, lnames, lt, nl_ = _eval_rel(plan.left, params, executor)
    rc, rn, rnames, rt, nr_ = _eval_rel(plan.right, params, executor)
    ldf = pd.DataFrame({f"l{i}": c for i, c in enumerate(lc)})
    rdf = pd.DataFrame({f"r{i}": c for i, c in enumerate(rc)})
    nleft = len(lc)

    def _null_mask_of(df, name, arr, mask):
        isnull = np.zeros(len(df), dtype=bool)
        if mask is not None:
            isnull |= np.asarray(mask)
        isnull |= df[name].isna().to_numpy()
        if hasattr(arr, "dtype") and arr.dtype == object:
            isnull |= np.array([v is None for v in arr])
        return isnull

    def _null_proof_pair(li, rj):
        """SQL: NULL join keys never match — but pandas merge matches
        NaN==NaN. Replace null-key entries with side-unique sentinels
        (and move both sides to object dtype so the merge still works).
        Output values are taken from the ORIGINAL arrays by row index,
        so sentinels never leak into results."""
        lname, rname = f"l{li}", f"r{rj}"
        lmask = _null_mask_of(ldf, lname, lc[li], ln[li])
        rmask = _null_mask_of(rdf, rname, rc[rj], rn[rj])
        if not lmask.any() and not rmask.any():
            return
        lobj = ldf[lname].astype(object).copy()
        lobj[lmask] = [f"__Lnull{i}" for i in np.flatnonzero(lmask)]
        ldf[lname] = lobj
        robj = rdf[rname].astype(object).copy()
        robj[rmask] = [f"__Rnull{i}" for i in np.flatnonzero(rmask)]
        rdf[rname] = robj

    equi = []
    residual = None

    def flatten(e):
        nonlocal residual
        if e is None:
            return
        if isinstance(e, ast.BinOp) and e.op == "and":
            flatten(e.left)
            flatten(e.right)
            return
        if isinstance(e, ast.BinOp) and e.op == "=" \
                and isinstance(e.left, ast.Col) and isinstance(e.right, ast.Col):
            li, ri = e.left.index, e.right.index
            if li < nleft <= ri:
                equi.append((li, ri - nleft))
                return
            if ri < nleft <= li:
                equi.append((ri, li - nleft))
                return
        residual = e if residual is None else ast.BinOp("and", residual, e)

    flatten(plan.condition)
    for li, rj in equi:
        _null_proof_pair(li, rj)
    nl_rows, nr_rows = len(ldf), len(rdf)

    # 1) candidate (left,right) ROW-INDEX pairs: equi keys via pandas
    #    inner merge, otherwise the cross product. Values are then taken
    #    from the ORIGINAL arrays by index, so merge dtype mangling and
    #    sentinel restoration never touch the output.
    if equi:
        ldf["__lrow"] = np.arange(nl_rows)
        rdf["__rrow"] = np.arange(nr_rows)
        rmerge = rdf
        if residual is None and plan.how in ("semi", "anti"):
            # only existence matters: dedup the build side so a hot key
            # doesn't materialize the full many-to-many pair table
            rmerge = rdf.drop_duplicates(subset=[f"r{j}" for _, j in equi])
        pairs = ldf.merge(rmerge, left_on=[f"l{i}" for i, _ in equi],
                          right_on=[f"r{j}" for _, j in equi], how="inner")
        lpair = pairs["__lrow"].to_numpy()
        rpair = pairs["__rrow"].to_numpy()
        if cross_order:
            order = np.lexsort((rpair, lpair))
            lpair, rpair = lpair[order], rpair[order]
    else:
        lpair = np.repeat(np.arange(nl_rows), nr_rows)
        rpair = np.tile(np.arange(nr_rows), nl_rows)

    # 2) residual ON-condition applied PER PAIR — an outer join's
    #    failing pairs must NULL-extend, not drop (ON-clause semantics)
    if residual is not None and len(lpair):
        mn = len(lpair)
        mcols = [c[lpair] for c in lc] + [c[rpair] for c in rc]
        mnulls = [nm[lpair] if nm is not None else None for nm in ln] + \
                 [nm[rpair] if nm is not None else None for nm in rn]
        v, nl2 = eval_expr(residual, mcols, mnulls, params, mn)
        ok = np.broadcast_to(v, (mn,)).astype(bool)
        if nl2 is not None:
            ok = ok & ~np.broadcast_to(nl2, (mn,))
        lpair, rpair = lpair[ok], rpair[ok]

    # 3) dispatch on join kind
    if plan.how in ("semi", "anti"):
        hit = np.zeros(nl_rows, dtype=bool)
        hit[lpair] = True
        keep = hit if plan.how == "semi" else ~hit
        idx = np.nonzero(keep)[0]
        return ([c[idx] for c in lc],
                [nm[idx] if nm is not None else None for nm in ln],
                lnames, lt, len(idx))
    l_idx, r_idx = lpair, rpair
    if plan.how in ("left", "full"):
        miss = np.setdiff1d(np.arange(nl_rows), lpair)
        l_idx = np.concatenate([l_idx, miss])
        r_idx = np.concatenate([r_idx, np.full(len(miss), -1)])
    if plan.how in ("right", "full"):
        miss = np.setdiff1d(np.arange(nr_rows), rpair)
        l_idx = np.concatenate([l_idx, np.full(len(miss), -1)])
        r_idx = np.concatenate([r_idx, miss])

    def take(arr, nm, idx, dt):
        """arr[idx] with idx == -1 meaning the NULL-extended side."""
        ext = idx < 0
        if len(arr) == 0:
            vals = np.zeros(len(idx), dtype=dt.np_dtype)
        else:
            vals = np.asarray(arr)[np.where(ext, 0, idx)]
        null = ext.copy()
        if nm is not None:
            null |= np.where(ext, True, np.asarray(nm)[np.where(ext, 0,
                                                               idx)])
        if vals.dtype == object:
            vals = vals.copy()
            vals[null] = None
        elif ext.any():
            vals = np.where(ext, np.zeros(1, dtype=vals.dtype), vals)
        return vals, (null if null.any() else None)

    cols, nulls = [], []
    for i, dt in enumerate(lt):
        v, nm2 = take(lc[i], ln[i], l_idx, dt)
        cols.append(v)
        nulls.append(nm2)
    for j, dt in enumerate(rt):
        v, nm2 = take(rc[j], rn[j], r_idx, dt)
        cols.append(v)
        nulls.append(nm2)
    return cols, nulls, lnames + rnames, lt + rt, len(l_idx)


def _eval_aggregate(plan: ast.Aggregate, params, executor):
    import pandas as pd

    cols, nulls, names, dtypes, n = _eval_rel(plan.child, params, executor)

    groups = list(plan.group_exprs)
    gvals = []
    for g in groups:
        v, nl = eval_expr(g, cols, nulls, params, n)
        v = np.broadcast_to(v, (n,))
        out = np.empty(n, dtype=object)
        for i in range(n):
            if nl is not None and np.broadcast_to(nl, (n,))[i]:
                out[i] = None
            else:
                x = v[i]
                # lists are unhashable: group by their tuple form (output
                # converts back)
                out[i] = tuple(x) if isinstance(x, list) else x
        gvals.append(out)

    if groups:
        df = pd.DataFrame({f"g{i}": g for i, g in enumerate(gvals)})
        grouped = df.groupby([f"g{i}" for i in range(len(groups))],
                             sort=True, dropna=False)
        group_indices = [idx.to_numpy() if hasattr(idx, "to_numpy")
                         else np.asarray(idx)
                         for _, idx in grouped.indices.items()]
        group_keys = list(grouped.indices.keys())
        if len(groups) == 1:
            group_keys = [(k,) for k in group_keys]
    else:
        group_indices = [np.arange(n)]
        group_keys = [()]

    out_names, out_cols, out_nulls, out_types = [], [], [], []
    memo: dict = {}   # each aggregate argument evaluated once, not per group
    for e in plan.agg_exprs:
        out_names.append(_expr_name(e))
        out_types.append(expr_type(e))
        vals, nmask = [], []
        for key, idx in zip(group_keys, group_indices):
            v = _agg_one(e, key, groups, idx, cols, nulls, params, n, memo)
            if isinstance(v, tuple):  # array group key: back to list form
                v = list(v)
            nmask.append(v is None)
            vals.append(v)
        dt = out_types[-1]
        if dt.name in ("string", "array", "map"):
            arr = np.empty(len(vals), dtype=object)
            for j, v in enumerate(vals):
                arr[j] = v
        else:
            arr = np.array([0 if v is None else v for v in vals],
                           dtype=dt.np_dtype if dt.name != "decimal"
                           else np.float64)
        out_cols.append(arr)
        nm = np.array(nmask)
        out_nulls.append(nm if nm.any() else None)
    return out_cols, out_nulls, out_names, out_types, len(group_indices)


def _agg_one(e: ast.Expr, key, groups, idx, cols, nulls, params, n,
             memo=None):
    """Evaluate one select-list expression for one group (host, exact).
    `memo` keeps each aggregate argument's values over all rows across
    the groups of one aggregate."""
    import pandas as pd

    memo = {} if memo is None else memo
    if isinstance(e, ast.Alias):
        return _agg_one(e.child, key, groups, idx, cols, nulls, params, n,
                        memo)
    for gi, g in enumerate(groups):
        if e == g:
            v = key[gi]
            # pandas groupby(dropna=False) hands a NULL group key back
            # as NaN/NaT — restore SQL NULL or the key loses its null
            # mask downstream (a NULL-extended string key would render
            # as nan and sort as the string "nan", breaking NULLS FIRST)
            if v is not None and not isinstance(v, (tuple, list)) \
                    and pd.isna(v):
                return None
            return v
    if isinstance(e, ast.Func) and e.name in ast.AGG_FUNCS:
        if e.name == "count" and not e.args:
            return len(idx)
        got = memo.get(id(e.args[0]))
        if got is None:
            got = memo[id(e.args[0])] = (
                e.args[0], eval_expr(e.args[0], cols, nulls, params, n))
        v, nl = got[1]
        v = np.broadcast_to(v, (n,))[idx]
        if nl is not None:
            keep = ~np.broadcast_to(nl, (n,))[idx]
            v = v[keep]
        if v.dtype == object:
            v = np.array([x for x in v if x is not None], dtype=object)
        if len(v) == 0:
            return 0 if e.name.startswith("count") else None
        if e.name == "count":
            return len(v)
        if e.name == "count_distinct":
            return len(set(v.tolist()))
        if e.name == "approx_count_distinct":
            return len(set(v.tolist()))
        if e.name == "sum":
            return v.sum()
        if e.name == "avg":
            return v.astype(np.float64).mean() if v.dtype != object else None
        if e.name == "min" or e.name == "first":
            return v.min() if v.dtype != object else min(v.tolist())
        if e.name == "max" or e.name == "last":
            return v.max() if v.dtype != object else max(v.tolist())
        if e.name == "stddev":
            return float(np.std(v.astype(np.float64)))
        if e.name == "variance":
            return float(np.var(v.astype(np.float64)))
        raise HostEvalError(e.name)
    if isinstance(e, ast.Lit):
        return e.value
    if isinstance(e, (ast.ParamLiteral, ast.Param)):
        return params[e.pos]
    if isinstance(e, ast.BinOp):
        a = _agg_one(e.left, key, groups, idx, cols, nulls, params, n, memo)
        b = _agg_one(e.right, key, groups, idx, cols, nulls, params, n,
                     memo)
        if a is None or b is None:
            return None
        return {"+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
                "/": lambda: a / b if b else None,
                "%": lambda: a % b}[e.op]()
    if isinstance(e, ast.Func):
        a = [_agg_one(x, key, groups, idx, cols, nulls, params, n, memo)
             for x in e.args]
        if e.name == "sqrt":
            return float(np.sqrt(a[0])) if a[0] is not None else None
        if e.name == "round":
            return round(a[0], int(a[1]) if len(a) > 1 else 0) \
                if a[0] is not None else None
    if isinstance(e, ast.Cast):
        v = _agg_one(e.child, key, groups, idx, cols, nulls, params, n,
                     memo)
        return T.python_value(e.to, v)
    raise HostEvalError(f"post-agg expression {type(e).__name__}")
