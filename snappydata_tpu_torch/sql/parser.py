"""Recursive-descent SQL parser producing ast.Statement / ast.Plan.

Dialect surface mirrors the reference's grammar (core/.../SnappyParser.scala
DML; SnappyDDLParser.scala:301 createTable, :716 createStream, :1051 ddl
dispatch): SELECT with joins/group/having/order/limit, CREATE TABLE ...
USING COLUMN|ROW OPTIONS(...), INSERT/PUT INTO, UPDATE, DELETE, DROP/
TRUNCATE, SHOW/DESCRIBE, SET. Date/interval literals and CASE/CAST/IN/
BETWEEN/LIKE are first-class since TPC-H needs them.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Tuple

from snappydata_tpu_torch import types as T
from snappydata_tpu_torch.sql import ast
from snappydata_tpu_torch.sql.lexer import SQLSyntaxError, Token, tokenize

_EPOCH = datetime.date(1970, 1, 1)


def _date_to_days(s: str) -> int:
    return (datetime.date.fromisoformat(s.strip()) - _EPOCH).days


def _ts_to_micros(s: str) -> int:
    dt = datetime.datetime.fromisoformat(s.strip())
    return int(dt.replace(tzinfo=datetime.timezone.utc).timestamp() * 1_000_000)


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens = tokenize(sql)
        self.i = 0

    # --- token helpers ----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "KW" and t.value.lower() in words

    def accept_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            t = self.peek()
            raise SQLSyntaxError(
                f"expected {word.upper()} but found {t.value!r} at {t.pos}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value in ops

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            t = self.peek()
            raise SQLSyntaxError(
                f"expected {op!r} but found {t.value!r} at {t.pos}")

    def ident(self) -> str:
        t = self.peek()
        # allow non-reserved keywords as identifiers in name position
        if t.kind in ("IDENT", "KW"):
            self.next()
            return t.value
        raise SQLSyntaxError(f"expected identifier at {t.pos}, found {t.value!r}")

    def qualified_name(self) -> str:
        name = self.ident()
        while self.accept_op("."):
            name += "." + self.ident()
        return name

    # --- entry ------------------------------------------------------------

    def parse_statement(self) -> ast.Statement:
        t = self.peek()
        low = t.value.lower() if t.kind == "KW" else ""
        if low == "select" or self.at_op("("):
            plan = self.query_expr()
            err = self._with_error_clause()
            self._finish()
            return ast.Query(plan, with_error=err)
        if low == "with":
            plan = self.with_query()
            err = self._with_error_clause()
            self._finish()
            return ast.Query(plan, with_error=err)
        if low == "create":
            return self._finishing(self.create_stmt())
        if low == "drop":
            return self._finishing(self.drop_stmt())
        if low == "truncate":
            self.next()
            self.expect_kw("table")
            return self._finishing(ast.TruncateTable(self.qualified_name()))
        if low == "alter":
            return self._finishing(self.alter_stmt())
        if low in ("insert", "put"):
            return self._finishing(self.insert_stmt())
        if low == "update":
            return self._finishing(self.update_stmt())
        if low == "delete":
            return self._finishing(self.delete_stmt())
        if low == "show":
            self.next()
            self.expect_kw("tables")
            return self._finishing(ast.ShowTables())
        if low == "describe":
            self.next()
            return self._finishing(ast.DescribeTable(self.qualified_name()))
        if low == "set":
            return self._finishing(self.set_stmt())
        if low in ("grant", "revoke"):
            return self._finishing(self.grant_revoke_stmt(low))
        if low == "explain":
            self.next()
            analyze = False
            nxt = self.peek()
            # ANALYZE is statement-position only, never reserved — a
            # query can still select from a table named analyze
            if nxt.kind in ("IDENT", "KW") and \
                    nxt.value.lower() == "analyze":
                self.next()
                analyze = True
            plan = self.query_expr()
            return self._finishing(ast.ExplainStmt(plan, analyze=analyze))
        if low == "exec":
            self.next()
            lang = self.peek()
            # EXEC PYTHON, plus EXEC SCALA for dialect parity (both run
            # python); anything else is rejected by name
            if lang.kind in ("IDENT", "KW") and \
                    lang.value.lower() in ("python", "scala"):
                self.next()
            else:
                raise SQLSyntaxError(
                    f"EXEC expects PYTHON or SCALA, found {lang.value!r}")
            t = self.next()
            if t.kind != "STR":
                raise SQLSyntaxError("EXEC expects a quoted code string")
            return self._finishing(ast.ExecCode(t.value))
        if low == "values":
            plan = self.values_clause()
            return self._finishing(ast.Query(plan))
        if low == "refresh":
            self.next()
            self.expect_kw("materialized")
            self.expect_kw("view")
            return self._finishing(
                ast.RefreshMaterializedView(self.qualified_name()))
        if low == "deploy":
            return self._finishing(self.deploy_stmt())
        if low == "undeploy":
            self.next()
            return self._finishing(ast.UndeployStmt(self.qualified_name()))
        if low == "list" or (t.kind == "IDENT" and
                             t.value.lower() == "list"):
            self.next()
            what = self.next()
            if what.value.lower() not in ("packages", "jars"):
                raise SQLSyntaxError(
                    f"LIST expects PACKAGES or JARS, found {what.value!r}")
            return self._finishing(ast.ListDeployed(what.value.lower()))
        # PREPARE / EXECUTE / DEALLOCATE are statement-leading words, not
        # reserved keywords (they stay usable as column/table names)
        word = t.value.lower() if t.kind == "IDENT" else ""
        if word == "prepare":
            self.next()
            name = self.ident()
            self.expect_kw("as")
            start = self.peek().pos
            # validate the query at PREPARE time (clear syntax errors now,
            # not at first EXECUTE)
            if self.at_kw("with"):
                self.with_query()
            else:
                self.query_expr()
            self._finish()
            return ast.PrepareStmt(
                name, self.sql[start:].strip().rstrip(";").strip())
        if word == "execute":
            self.next()
            name = self.ident()
            args = []
            if self.accept_op("("):
                if not self.at_op(")"):
                    while True:
                        args.append(self._exec_literal())
                        if not self.accept_op(","):
                            break
                self.expect_op(")")
            return self._finishing(ast.ExecuteStmt(name, tuple(args)))
        if word == "deallocate":
            self.next()
            nt = self.peek()
            if nt.kind == "IDENT" and nt.value.lower() == "prepare":
                self.next()             # optional noise word
            return self._finishing(ast.DeallocateStmt(self.qualified_name()))
        raise SQLSyntaxError(f"cannot parse statement starting at {t.value!r}")

    def _exec_literal(self):
        """One EXECUTE bind value: NULL/TRUE/FALSE, [signed] number,
        'string', DATE 'yyyy-mm-dd', TIMESTAMP '...'."""
        neg = False
        signed = False
        while self.at_op("-") or self.at_op("+"):
            signed = True
            neg ^= self.next().value == "-"
        t = self.next()
        if t.kind == "NUM":
            v = float(t.value) if any(c in t.value for c in ".eE") \
                else int(t.value)
            return -v if neg else v
        if signed:   # a sign on a non-number is malformed, not ignorable
            raise SQLSyntaxError(
                f"EXECUTE: +/- applies only to numeric binds "
                f"(at {t.pos})")
        if t.kind == "STR":
            return t.value
        kw = t.value.lower()
        if t.kind == "KW":
            if kw == "null":
                return None
            if kw == "true":
                return True
            if kw == "false":
                return False
            if kw in ("date", "timestamp"):
                s = self.next()
                if s.kind != "STR":
                    raise SQLSyntaxError(
                        f"{kw.upper()} expects a quoted string at {s.pos}")
                return _date_to_days(s.value) if kw == "date" \
                    else _ts_to_micros(s.value)
        raise SQLSyntaxError(
            f"EXECUTE expects literal bind values, found {t.value!r} "
            f"at {t.pos}")

    def deploy_stmt(self) -> ast.Statement:
        """DEPLOY PACKAGE name 'coords' [REPOS 'r'] [PATH 'p'] |
        DEPLOY JAR name 'paths' (ref grammar:
        SnappyDDLParser.deployPackages:858)."""
        self.next()  # DEPLOY
        kind_t = self.peek()
        kind = kind_t.value.lower()
        if kind not in ("package", "jar"):
            raise SQLSyntaxError(
                f"DEPLOY expects PACKAGE or JAR, found {kind_t.value!r}")
        self.next()
        name = self.qualified_name()
        coords_t = self.next()
        if coords_t.kind != "STR":
            raise SQLSyntaxError("DEPLOY expects a quoted path list")
        repos = cache_path = ""
        if kind == "package":
            nxt = self.peek()
            if nxt.kind in ("KW", "IDENT") and nxt.value.lower() == "repos":
                self.next()
                rt = self.next()
                if rt.kind != "STR":
                    raise SQLSyntaxError("REPOS expects a quoted string")
                repos = rt.value
            nxt = self.peek()
            if nxt.kind in ("KW", "IDENT") and nxt.value.lower() == "path":
                self.next()
                pt = self.next()
                if pt.kind != "STR":
                    raise SQLSyntaxError("PATH expects a quoted string")
                cache_path = pt.value
        return ast.DeployStmt(name, kind, coords_t.value, repos, cache_path)

    def _finishing(self, stmt: ast.Statement) -> ast.Statement:
        self._finish()
        return stmt

    def _finish(self) -> None:
        self.accept_op(";")
        t = self.peek()
        if t.kind != "EOF":
            raise SQLSyntaxError(f"unexpected trailing input at {t.pos}: {t.value!r}")

    # --- queries ----------------------------------------------------------

    def query_expr(self) -> ast.Plan:
        left = self.intersect_term()
        while self.at_kw("union", "except", "minus"):
            op = self.next().value.lower()
            if op == "union":
                all_ = self.accept_kw("all")
                if not all_:
                    self.accept_kw("distinct")
                right = self.intersect_term()
                left = ast.Union(left, right, all=all_)
                if not all_:
                    left = ast.Distinct(left)
            else:  # EXCEPT / MINUS (DISTINCT semantics, like Spark)
                self.accept_kw("distinct")
                right = self.intersect_term()
                left = ast.SetOp(left, right, "except")
        # trailing ORDER BY / LIMIT apply to the union result
        left = self._order_limit(left)
        return left

    def with_query(self) -> ast.Plan:
        """WITH name AS (query) [, ...] query — non-recursive CTEs,
        spliced by substitution like views (each CTE sees the ones
        defined before it)."""
        self.expect_kw("with")
        ctes = []
        while True:
            name = self.ident()
            self.expect_kw("as")
            self.expect_op("(")
            sub = self.query_expr()
            self.expect_op(")")
            ctes.append((name, sub))
            if not self.accept_op(","):
                break
        main = self.query_expr()
        resolved = []
        for name, sub in ctes:
            for pn, pp in resolved:
                sub = _substitute_cte(sub, pn, pp)
            resolved.append((name, sub))
        for pn, pp in resolved:
            main = _substitute_cte(main, pn, pp)
        return main

    def intersect_term(self) -> ast.Plan:
        left = self.query_term()
        while self.at_kw("intersect"):
            self.next()
            self.accept_kw("distinct")
            left = ast.SetOp(left, self.query_term(), "intersect")
        return left

    def query_term(self) -> ast.Plan:
        if self.at_op("("):
            self.next()
            q = self.query_expr()
            self.expect_op(")")
            return q
        if self.at_kw("values"):
            return self.values_clause()
        return self.select_stmt()

    def values_clause(self) -> ast.Plan:
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.expr()]
            while self.accept_op(","):
                row.append(self.expr())
            self.expect_op(")")
            rows.append(tuple(row))
            if not self.accept_op(","):
                break
        return ast.Values(tuple(rows))

    def select_stmt(self) -> ast.Plan:
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        select_list = [self.select_item()]
        while self.accept_op(","):
            select_list.append(self.select_item())

        plan: ast.Plan
        if self.accept_kw("from"):
            plan = self.from_clause()
        else:
            plan = ast.Values(((ast.Lit(1),),))  # SELECT without FROM

        if self.accept_kw("where"):
            plan = ast.Filter(plan, self.expr())

        group_exprs: List[ast.Expr] = []
        grouping_sets = None
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            t2 = self.peek()
            word = t2.value.lower() if t2.kind in ("IDENT", "KW") else ""
            if word in ("rollup", "cube"):
                self.next()
                self.expect_op("(")
                group_exprs.append(self.expr())
                while self.accept_op(","):
                    group_exprs.append(self.expr())
                self.expect_op(")")
                n = len(group_exprs)
                if word == "rollup":
                    grouping_sets = tuple(
                        tuple(range(n - i)) for i in range(n + 1))
                else:  # cube: all subsets, full set first
                    grouping_sets = tuple(sorted(
                        (tuple(j for j in range(n) if (mask >> j) & 1)
                         for mask in range(1 << n)),
                        key=lambda sset: -len(sset)))
            elif word == "grouping":
                self.next()
                nxt = self.next()
                if nxt.value.lower() != "sets":
                    raise SQLSyntaxError("expected SETS after GROUPING")
                self.expect_op("(")
                raw_sets = []
                while True:
                    self.expect_op("(")
                    one = []
                    if not self.at_op(")"):
                        one.append(self.expr())
                        while self.accept_op(","):
                            one.append(self.expr())
                    self.expect_op(")")
                    raw_sets.append(one)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                # group_exprs = first-appearance order over all sets
                sets_idx = []
                for one in raw_sets:
                    idxs = []
                    for e in one:
                        if e not in group_exprs:
                            group_exprs.append(e)
                        idxs.append(group_exprs.index(e))
                    sets_idx.append(tuple(idxs))
                grouping_sets = tuple(sets_idx)
            else:
                group_exprs.append(self.expr())
                while self.accept_op(","):
                    group_exprs.append(self.expr())

        having = None
        if self.accept_kw("having"):
            having = self.expr()

        has_agg = any(ast.is_aggregate(e) for e in select_list)
        if group_exprs or has_agg or having is not None:
            plan = ast.Aggregate(plan, tuple(group_exprs),
                                 tuple(select_list),
                                 grouping_sets=grouping_sets)
            if having is not None:
                plan = ast.Filter(plan, having)
        else:
            plan = ast.Project(plan, tuple(select_list))

        if distinct:
            plan = ast.Distinct(plan)
        # ORDER BY / LIMIT are applied by query_expr AFTER any set-op
        # chain: `a UNION b ORDER BY k` sorts the union, not b
        return plan

    def _with_error_clause(self):
        """Trailing HAC clause: WITH ERROR <frac> [CONFIDENCE <frac>]
        [BEHAVIOR <behavior>] (ref grammar: the reference parser's
        `withErrorClause`; semantics docs/sde/hac_contracts.md:38-74).
        The behavior may be a quoted string or a bare identifier."""
        if not self.at_kw("with"):
            return None
        nxt = self.peek(1)
        if not (nxt.kind in ("IDENT", "KW")
                and nxt.value.lower() == "error"):
            return None
        self.next()  # WITH
        self.next()  # ERROR
        t = self.next()
        if t.kind != "NUM":
            raise SQLSyntaxError(
                f"WITH ERROR expects a fraction at {t.pos}")
        error = float(t.value)
        confidence, behavior = 0.95, "do_nothing"
        while True:
            t = self.peek()
            word = t.value.lower() if t.kind in ("IDENT", "KW") else ""
            if word == "confidence":
                self.next()
                ct = self.next()
                if ct.kind != "NUM":
                    raise SQLSyntaxError(
                        f"CONFIDENCE expects a fraction at {ct.pos}")
                confidence = float(ct.value)
            elif word == "behavior":
                self.next()
                bt = self.next()
                if bt.kind not in ("STR", "IDENT", "KW"):
                    raise SQLSyntaxError(
                        f"BEHAVIOR expects a name at {bt.pos}")
                behavior = bt.value.lower().strip("<>")
            else:
                break
        valid = {"do_nothing", "local_omit", "strict",
                 "run_on_full_table", "partial_run_on_base_table"}
        if behavior not in valid:
            raise SQLSyntaxError(
                f"unknown BEHAVIOR {behavior!r}; expected one of "
                f"{sorted(valid)}")
        if not (0.0 < error < 1.0):
            raise SQLSyntaxError("WITH ERROR fraction must be in (0, 1)")
        if not (0.0 < confidence < 1.0):
            raise SQLSyntaxError("CONFIDENCE must be in (0, 1)")
        return ast.ErrorClause(error, confidence, behavior)

    def _order_limit(self, plan: ast.Plan) -> ast.Plan:
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            orders = [self.sort_item()]
            while self.accept_op(","):
                orders.append(self.sort_item())
            plan = ast.Sort(plan, tuple(orders))
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind != "NUM":
                raise SQLSyntaxError(f"LIMIT expects a number at {t.pos}")
            plan = ast.Limit(plan, int(t.value))
        return plan

    def sort_item(self) -> Tuple[ast.Expr, bool, Optional[bool]]:
        """(expr, ascending, nulls_first) — nulls_first None means the
        Spark default (ASC → NULLS FIRST, DESC → NULLS LAST)."""
        e = self.expr()
        asc = True
        if self.accept_kw("desc"):
            asc = False
        else:
            self.accept_kw("asc")
        nulls_first = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            elif self.accept_kw("last"):
                nulls_first = False
            else:
                raise SQLSyntaxError("expected FIRST or LAST after NULLS")
        return (e, asc, nulls_first)

    def select_item(self) -> ast.Expr:
        if self.at_op("*"):
            self.next()
            return ast.Star()
        # qualified star: t.*
        if self.peek().kind in ("IDENT",) and self.peek(1).kind == "OP" \
                and self.peek(1).value == "." and self.peek(2).kind == "OP" \
                and self.peek(2).value == "*":
            q = self.ident()
            self.next()
            self.next()
            return ast.Star(qualifier=q)
        e = self.expr()
        if self.accept_kw("as"):
            return ast.Alias(e, self.ident())
        t = self.peek()
        if t.kind == "IDENT":
            self.next()
            return ast.Alias(e, t.value)
        return e

    def from_clause(self) -> ast.Plan:
        plan = self.table_factor()
        while True:
            if self.accept_op(","):
                plan = ast.Join(plan, self.table_factor(), "cross", None)
                continue
            how = self._join_type()
            if how is None:
                break
            right = self.table_factor()
            cond = None
            if self.accept_kw("on"):
                cond = self.expr()
            elif how != "cross":
                if self.at_kw("using"):
                    raise SQLSyntaxError("JOIN ... USING not supported yet")
            plan = ast.Join(plan, right, how, cond)
        return plan

    def _join_type(self) -> Optional[str]:
        if self.accept_kw("cross"):
            self.expect_kw("join")
            return "cross"
        if self.accept_kw("inner"):
            self.expect_kw("join")
            return "inner"
        for how in ("left", "right", "full"):
            if self.at_kw(how):
                self.next()
                self.accept_kw("outer") or self.accept_kw("semi") or \
                    self.accept_kw("anti")
                self.expect_kw("join")
                return how
        if self.accept_kw("join"):
            return "inner"
        return None

    def table_factor(self) -> ast.Plan:
        if self.at_op("("):
            self.next()
            sub = self.query_expr()
            self.expect_op(")")
            alias = self._table_alias()
            if alias is None:
                raise SQLSyntaxError("subquery in FROM requires an alias")
            return ast.SubqueryAlias(sub, alias)
        name = self.qualified_name()
        alias = None if self._at_window_clause() else self._table_alias()
        rel: ast.Plan = ast.UnresolvedRelation(name, alias)
        if self._at_window_clause():
            self.next()           # WINDOW
            self.expect_op("(")
            self._expect_ident("duration")
            dur = self._window_span()
            slide = None
            if self.accept_op(","):
                self._expect_ident("slide")
                slide = self._window_span()
            self.expect_op(")")
            rel = ast.WindowedRelation(rel, dur, slide)
        return rel

    def _at_window_clause(self) -> bool:
        t = self.peek()
        if not (t.kind == "IDENT" and t.value.lower() == "window"):
            return False
        nxt = self.peek(1)
        return nxt.kind == "OP" and nxt.value == "("

    def _expect_ident(self, word: str) -> None:
        t = self.next()
        if not (t.kind in ("IDENT", "KW") and t.value.lower() == word):
            raise SQLSyntaxError(f"expected {word.upper()}, got {t.value!r}")

    def _window_span(self) -> float:
        t = self.next()
        if t.kind == "NUM":
            val = float(t.value)
        elif t.kind == "STR":
            val = float(t.value)
        else:
            raise SQLSyntaxError(f"expected a number, got {t.value!r}")
        unit = self.next()
        u = unit.value.lower().rstrip("s") if unit.kind in ("IDENT", "KW")             else ""
        scale = {"second": 1.0, "minute": 60.0, "hour": 3600.0,
                 "millisecond": 0.001}.get(u)
        if scale is None:
            raise SQLSyntaxError(
                f"expected SECONDS/MINUTES/HOURS, got {unit.value!r}")
        return val * scale

    def _table_alias(self) -> Optional[str]:
        if self.accept_kw("as"):
            return self.ident()
        t = self.peek()
        if t.kind == "IDENT":
            self.next()
            return t.value
        return None

    # --- expressions (Pratt) ---------------------------------------------

    def expr(self) -> ast.Expr:
        return self.or_expr()

    def or_expr(self) -> ast.Expr:
        left = self.and_expr()
        while self.accept_kw("or"):
            left = ast.BinOp("or", left, self.and_expr())
        return left

    def and_expr(self) -> ast.Expr:
        left = self.not_expr()
        while self.accept_kw("and"):
            left = ast.BinOp("and", left, self.not_expr())
        return left

    def not_expr(self) -> ast.Expr:
        if self.accept_kw("not"):
            return ast.UnaryOp("not", self.not_expr())
        return self.predicate()

    def predicate(self) -> ast.Expr:
        left = self.add_expr()
        if self.at_op("=", "!=", "<>", "<", "<=", ">", ">="):
            op = self.next().value
            if op == "<>":
                op = "!="
            return ast.BinOp(op, left, self.add_expr())
        negated = False
        if self.at_kw("not"):
            # NOT IN / NOT BETWEEN / NOT LIKE
            nxt = self.peek(1)
            if nxt.kind == "KW" and nxt.value.lower() in ("in", "between", "like"):
                self.next()
                negated = True
        if self.accept_kw("is"):
            neg = self.accept_kw("not")
            self.expect_kw("null")
            return ast.IsNull(left, negated=neg)
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.at_kw("select"):
                sub = self.query_expr()
                self.expect_op(")")
                return ast.InSubquery(left, sub, negated=negated)
            vals = [self.expr()]
            while self.accept_op(","):
                vals.append(self.expr())
            self.expect_op(")")
            return ast.InList(left, tuple(vals), negated=negated)
        if self.accept_kw("between"):
            lo = self.add_expr()
            self.expect_kw("and")
            hi = self.add_expr()
            return ast.Between(left, lo, hi, negated=negated)
        if self.accept_kw("like"):
            t = self.next()
            if t.kind != "STR":
                raise SQLSyntaxError("LIKE expects a string literal")
            return ast.Like(left, t.value, negated=negated)
        return left

    def add_expr(self) -> ast.Expr:
        left = self.mul_expr()
        while True:
            if self.at_op("+", "-"):
                op = self.next().value
                left = ast.BinOp(op, left, self.mul_expr())
            elif self.at_op("||"):
                self.next()
                left = ast.Func("concat", (left, self.mul_expr()))
            else:
                return left

    def mul_expr(self) -> ast.Expr:
        left = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = ast.BinOp(op, left, self.unary())
        return left

    def unary(self) -> ast.Expr:
        if self.accept_op("-"):
            return ast.UnaryOp("neg", self.unary())
        if self.accept_op("+"):
            return self.unary()
        return self.primary()

    def primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "NUM":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                return ast.Lit(float(t.value), T.DOUBLE)
            v = int(t.value)
            return ast.Lit(v, T.LONG if abs(v) > 2**31 - 1 else T.INT)
        if t.kind == "STR":
            self.next()
            return ast.Lit(t.value, T.STRING)
        if t.kind == "OP" and t.value == "?":
            self.next()
            return ast.Param(pos=-1)  # positions assigned by analyzer
        if t.kind == "OP" and t.value == "(":
            self.next()
            if self.at_kw("select"):
                sub = self.query_expr()
                self.expect_op(")")
                return ast.ScalarSubquery(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "KW":
            low = t.value.lower()
            if low == "null":
                self.next()
                return ast.Lit(None)
            if low in ("true", "false"):
                self.next()
                return ast.Lit(low == "true", T.BOOLEAN)
            if low == "date" and self.peek(1).kind == "STR":
                self.next()
                return ast.Lit(_date_to_days(self.next().value), T.DATE)
            if low == "timestamp" and self.peek(1).kind == "STR":
                self.next()
                return ast.Lit(_ts_to_micros(self.next().value), T.TIMESTAMP)
            if low == "interval":
                return self.interval_literal()
            if low == "case":
                return self.case_expr()
            if low == "cast":
                self.next()
                self.expect_op("(")
                e = self.expr()
                self.expect_kw("as")
                dt = self.type_name()
                self.expect_op(")")
                return ast.Cast(e, dt)
            if low == "exists":
                self.next()
                self.expect_op("(")
                sub = self.query_expr()
                self.expect_op(")")
                return ast.ExistsSubquery(sub)
            if low in ("left", "right"):  # string funcs shadowed by keywords
                if self.peek(1).kind == "OP" and self.peek(1).value == "(":
                    name = self.next().value
                    return self.func_call(name)
        # identifier: column ref or function call
        if t.kind in ("IDENT", "KW"):
            name = self.ident()
            if self.at_op("("):
                return self._maybe_subscript(self.func_call(name))
            if self.accept_op("."):
                col = self.ident()
                return self._maybe_subscript(ast.Col(col, qualifier=name))
            return self._maybe_subscript(ast.Col(name))
        raise SQLSyntaxError(f"unexpected token {t.value!r} at {t.pos}")

    def _maybe_subscript(self, base: ast.Expr) -> ast.Expr:
        """a[i] → element_at(a, i+1) (SQL element_at is 1-based)."""
        while self.accept_op("["):
            idx = self.expr()
            self.expect_op("]")
            # [] uses 0-based indexing like Spark's a[i]; element_at is
            # 1-based — normalize to element_at(a, idx + 1)
            idx1 = ast.BinOp("+", idx, ast.Lit(1, T.INT))
            base = ast.Func("element_at", (base, idx1))
        return base

    _EXTRACT_PARTS = {
        "year": "year", "yyyy": "year", "yy": "year",
        "month": "month", "mon": "month", "mm": "month",
        "day": "day", "dd": "day", "week": "weekofyear",
        "quarter": "quarter", "hour": "hour", "minute": "minute",
        "second": "second", "dow": "dayofweek", "doy": "dayofyear",
    }

    def func_call(self, name: str) -> ast.Expr:
        low0 = name.lower()
        if low0 == "extract":
            # EXTRACT(part FROM expr) → part(expr)
            self.expect_op("(")
            part_t = self.next()
            part = self._EXTRACT_PARTS.get(part_t.value.lower())
            if part is None:
                raise SQLSyntaxError(
                    f"EXTRACT field {part_t.value!r} not supported")
            self.expect_kw("from")
            e = self.expr()
            self.expect_op(")")
            return ast.Func(part, (e,))
        if low0 == "position":
            # position(needle IN haystack) → instr(haystack, needle)
            self.expect_op("(")
            needle = self.add_expr()   # stop below the IN operator
            self.expect_kw("in")
            hay = self.expr()
            self.expect_op(")")
            return ast.Func("instr", (hay, needle))
        self.expect_op("(")
        if self.at_op("*"):
            self.next()
            self.expect_op(")")
            if self.at_kw("over"):
                return self._window_clause("count", ())
            return ast.Func("count", ())  # count(*)
        distinct = self.accept_kw("distinct")
        args: List[ast.Expr] = []
        if not self.at_op(")"):
            args.append(self.expr())
            while self.accept_op(","):
                args.append(self.expr())
        self.expect_op(")")
        low = name.lower()
        if self.at_kw("over"):
            if distinct:
                raise SQLSyntaxError(
                    "DISTINCT is not supported in window functions")
            return self._window_clause(low, tuple(args))
        if distinct and low == "count":
            return ast.Func("count_distinct", tuple(args))
        return ast.Func(low, tuple(args), distinct=distinct)

    def _window_clause(self, fname: str, args) -> ast.Expr:
        self.expect_kw("over")
        self.expect_op("(")
        partition: List[ast.Expr] = []
        orders: List = []
        t = self.peek()
        if t.kind in ("IDENT", "KW") and t.value.lower() == "partition":
            self.next()
            self.expect_kw("by")
            partition.append(self.expr())
            while self.accept_op(","):
                partition.append(self.expr())
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            orders.append(self.sort_item())
            while self.accept_op(","):
                orders.append(self.sort_item())
        self.expect_op(")")
        if fname not in ast.WINDOW_FUNCS:
            raise SQLSyntaxError(f"unsupported window function {fname}")
        return ast.WindowFunc(fname, args, tuple(partition), tuple(orders))

    def interval_literal(self) -> ast.Expr:
        """INTERVAL '90' DAY → Lit(days) tagged DATE-delta (int)."""
        self.expect_kw("interval")
        t = self.next()
        if t.kind not in ("STR", "NUM"):
            raise SQLSyntaxError("INTERVAL expects a quantity")
        qty = int(float(t.value))
        unit_t = self.next()
        unit = unit_t.value.lower().rstrip("s")
        if unit == "day":
            return ast.Lit(qty, T.DATE)  # day-granularity delta
        if unit == "month":
            return ast.Lit(qty * 30, T.DATE)  # calendar-naive, documented
        if unit == "year":
            return ast.Lit(qty * 365, T.DATE)
        if unit in ("hour", "minute", "second"):
            mult = {"hour": 3600, "minute": 60, "second": 1}[unit]
            return ast.Lit(qty * mult * 1_000_000, T.TIMESTAMP)
        raise SQLSyntaxError(f"unsupported interval unit {unit_t.value!r}")

    def case_expr(self) -> ast.Expr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.expr()
            if operand is not None:
                cond = ast.BinOp("=", operand, cond)
            self.expect_kw("then")
            whens.append((cond, self.expr()))
        otherwise = None
        if self.accept_kw("else"):
            otherwise = self.expr()
        self.expect_kw("end")
        return ast.Case(tuple(whens), otherwise)

    def type_name(self) -> T.DataType:
        name = self.ident()
        if name.lower() == "array" and self.accept_op("<"):
            elem = self.type_name()
            self.expect_op(">")
            return T.parse_type("array", element=elem)
        if name.lower() == "map" and self.accept_op("<"):
            key = self.type_name()
            self.expect_op(",")
            val = self.type_name()
            self.expect_op(">")
            return T.parse_type("map", element=val, key=key)
        if name.lower() == "struct" and self.accept_op("<"):
            fields = []
            while not self.at_op(">"):
                fname = self.ident()
                self.accept_op(":")
                fields.append((fname, self.type_name()))
                self.accept_op(",")
            self.expect_op(">")
            return T.parse_type("struct", fields=fields)
        args = []
        if self.accept_op("("):
            while not self.at_op(")"):
                args.append(self.next().value)
                self.accept_op(",")
            self.expect_op(")")
        return T.parse_type(name, args)

    # --- DDL / DML --------------------------------------------------------

    def create_stmt(self) -> ast.Statement:
        self.expect_kw("create")
        or_replace = False
        if self.accept_kw("or"):
            self.expect_kw("replace")
            or_replace = True
        temporary = self.accept_kw("temporary")
        if self.accept_kw("materialized"):
            self.expect_kw("view")
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            name = self.qualified_name()
            self.expect_kw("as")
            return ast.CreateMaterializedView(name, self.query_expr(),
                                              if_not_exists=if_not_exists)
        if self.accept_kw("view"):
            name = self.qualified_name()
            self.expect_kw("as")
            return ast.CreateView(name, self.query_expr(), or_replace=or_replace)
        if self.accept_kw("function"):
            name = self.qualified_name()
            self.expect_kw("as")
            t = self.next()
            if t.kind != "STR":
                raise SQLSyntaxError(
                    "CREATE FUNCTION expects a quoted Python lambda "
                    "after AS")
            body = t.value
            ret = None
            if self.accept_kw("returns"):
                ret = self.type_name()
            return ast.CreateFunction(name, body, ret,
                                      or_replace=or_replace)
        if self.accept_kw("policy"):
            name = self.qualified_name()
            self.expect_kw("on")
            table = self.qualified_name()
            # optional FOR SELECT TO current_user (ref dialect); ignored
            if self.accept_kw("for"):
                self.ident()
                if self.accept_kw("to"):
                    self.ident()
            self.expect_kw("using")
            had_paren = self.accept_op("(")
            pred = self.expr()
            if had_paren:
                self.expect_op(")")
            return ast.CreatePolicy(name, table, pred)
        if self.accept_kw("index"):
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            name = self.qualified_name()
            self.expect_kw("on")
            table = self.qualified_name()
            self.expect_op("(")
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            return ast.CreateIndex(name, table, tuple(cols), if_not_exists)
        self.accept_kw("external")
        sample = self.accept_kw("sample")
        stream = self.accept_kw("stream")
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.qualified_name()
        base_table = None
        if sample and self.accept_kw("on"):
            base_table = self.qualified_name()
        columns: List[ast.ColumnDef] = []
        if self.at_op("("):
            columns = self.column_defs()
        provider = "sample" if sample else "column"
        if self.accept_kw("using"):
            provider = self.ident().lower()
            if sample:
                provider = "sample"
        options = {}
        if self.accept_kw("options"):
            options = self.options_clause()
        if base_table is not None:
            options.setdefault("basetable", base_table)
        as_select = None
        if self.accept_kw("as"):
            as_select = self.query_expr()
        return ast.CreateTable(name, tuple(columns), provider, options,
                               as_select, if_not_exists, temporary,
                               stream=stream)

    def alter_stmt(self) -> ast.Statement:
        """ALTER TABLE t ADD [COLUMN] c type [NOT NULL] | DROP [COLUMN] c
        (ref SnappyDDLParser.scala:697-713)."""
        self.expect_kw("alter")
        self.expect_kw("table")
        table = self.qualified_name()
        if self.accept_kw("add"):
            self.accept_kw("column")
            cname = self.ident()
            dt = self.type_name()
            nullable = True
            if self.accept_kw("not"):
                self.expect_kw("null")
                nullable = False
            return ast.AlterTable(table, True,
                                  column=ast.ColumnDef(cname, dt, nullable))
        self.expect_kw("drop")
        self.accept_kw("column")
        return ast.AlterTable(table, False, name=self.ident())

    def column_defs(self) -> List[ast.ColumnDef]:
        self.expect_op("(")
        out: List[ast.ColumnDef] = []
        pk_cols: List[str] = []
        while True:
            if self.accept_kw("primary"):
                self.expect_kw("key")
                self.expect_op("(")
                while not self.at_op(")"):
                    pk_cols.append(self.ident())
                    self.accept_op(",")
                self.expect_op(")")
            else:
                cname = self.ident()
                dt = self.type_name()
                nullable = True
                primary = False
                while True:
                    if self.accept_kw("not"):
                        self.expect_kw("null")
                        nullable = False
                    elif self.accept_kw("primary"):
                        self.expect_kw("key")
                        primary = True
                        nullable = False
                    else:
                        break
                out.append(ast.ColumnDef(cname, dt, nullable, primary))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        if pk_cols:
            pk_set = {c.lower() for c in pk_cols}
            out = [ast.ColumnDef(c.name, c.dtype,
                                 c.nullable and c.name.lower() not in pk_set,
                                 c.primary_key or c.name.lower() in pk_set)
                   for c in out]
        return out

    def options_clause(self) -> dict:
        self.expect_op("(")
        opts = {}
        while not self.at_op(")"):
            key = self.ident()
            while self.accept_op("."):
                key += "." + self.ident()
            t = self.next()
            if t.kind not in ("STR", "NUM", "IDENT", "KW"):
                raise SQLSyntaxError(f"bad option value at {t.pos}")
            opts[key.lower()] = t.value
            self.accept_op(",")
        self.expect_op(")")
        return opts

    def drop_stmt(self) -> ast.Statement:
        self.expect_kw("drop")
        if self.accept_kw("materialized"):
            self.expect_kw("view")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.DropMaterializedView(self.qualified_name(),
                                            if_exists)
        kind = "table"
        for k in ("view", "policy", "index", "function"):
            if self.accept_kw(k):
                kind = k
                break
        else:
            self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        name = self.qualified_name()
        if kind == "view":
            return ast.DropView(name, if_exists)
        if kind == "policy":
            return ast.DropPolicy(name, if_exists)
        if kind == "index":
            return ast.DropIndex(name, if_exists)
        if kind == "function":
            return ast.DropFunction(name, if_exists)
        return ast.DropTable(name, if_exists)

    def insert_stmt(self) -> ast.Statement:
        put = self.accept_kw("put")
        if not put:
            self.expect_kw("insert")
        overwrite = False
        if self.accept_kw("overwrite"):
            overwrite = True
            self.accept_kw("into") or self.accept_kw("table")
        else:
            self.expect_kw("into")
            self.accept_kw("table")
        table = self.qualified_name()
        columns: Tuple[str, ...] = ()
        if self.at_op("(") and self._looks_like_column_list():
            self.next()
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            columns = tuple(cols)
        if self.at_kw("values"):
            source = self.values_clause()
        else:
            source = self.query_expr()
        return ast.InsertInto(table, columns, source, put=put,
                              overwrite=overwrite)

    def _looks_like_column_list(self) -> bool:
        """Disambiguate INSERT INTO t (a, b) VALUES… from INSERT INTO t
        (SELECT…): scan ahead for a SELECT right after '('."""
        return not (self.peek(1).kind == "KW"
                    and self.peek(1).value.lower() in ("select", "values"))

    def update_stmt(self) -> ast.Statement:
        self.expect_kw("update")
        table = self.qualified_name()
        self.expect_kw("set")
        assigns = []
        while True:
            col = self.ident()
            if self.accept_op("."):
                col = self.ident()
            self.expect_op("=")
            assigns.append((col, self.expr()))
            if not self.accept_op(","):
                break
        where = None
        if self.accept_kw("where"):
            where = self.expr()
        return ast.UpdateStmt(table, tuple(assigns), where)

    def delete_stmt(self) -> ast.Statement:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.qualified_name()
        where = None
        if self.accept_kw("where"):
            where = self.expr()
        return ast.DeleteStmt(table, where)

    def grant_revoke_stmt(self, kind: str) -> ast.Statement:
        self.next()
        privs = [self.ident().lower()]
        while self.accept_op(","):
            privs.append(self.ident().lower())
        valid = {"select", "insert", "update", "delete", "all"}
        for p in privs:
            if p not in valid:
                raise SQLSyntaxError(f"unknown privilege {p!r}")
        self.expect_kw("on")
        self.accept_kw("table")
        table = self.qualified_name()
        if kind == "grant":
            self.expect_kw("to")
        else:
            if not (self.accept_kw("from") or self.accept_kw("to")):
                raise SQLSyntaxError("REVOKE expects FROM <user>")
        grantee = self.ident()
        if kind == "grant":
            return ast.GrantStmt(tuple(privs), table, grantee)
        return ast.RevokeStmt(tuple(privs), table, grantee)

    def set_stmt(self) -> ast.Statement:
        self.expect_kw("set")
        key = self.ident()
        while self.accept_op(".") or self.accept_op("-"):
            key += "." + self.ident()
        self.expect_op("=")
        parts = []
        while self.peek().kind != "EOF" and not self.at_op(";"):
            parts.append(self.next().value)
        return ast.SetConf(key, " ".join(parts))


def parse(sql: str) -> ast.Statement:
    return Parser(sql).parse_statement()


def _substitute_cte(p, name: str, sub):
    """Replace UnresolvedRelation(name) with SubqueryAlias(sub) anywhere in
    the plan/expression tree (incl. subquery expressions)."""
    import dataclasses as _dc

    if isinstance(p, ast.UnresolvedRelation) and \
            p.name.lower() == name.lower():
        return ast.SubqueryAlias(sub, p.alias or name)
    if not _dc.is_dataclass(p) or not isinstance(p, (ast.Plan, ast.Expr)):
        return p

    def fix(v):
        if isinstance(v, (ast.Plan, ast.Expr)):
            return _substitute_cte(v, name, sub)
        if isinstance(v, tuple):
            return tuple(fix(x) for x in v)
        return v

    changes = {}
    for f in _dc.fields(p):
        v = getattr(p, f.name)
        nv = fix(v)
        if nv is not v and nv != v:
            changes[f.name] = nv
    return _dc.replace(p, **changes) if changes else p
