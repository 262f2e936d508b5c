"""Expression and logical-plan AST.

The logical layer the reference gets from Catalyst; kept deliberately
small and immutable (dataclasses) — the analyzer annotates by rebuilding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from snappydata_tpu_torch import types as T


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Expr:
    def children(self) -> Tuple["Expr", ...]:
        return ()

    def map_children(self, fn) -> "Expr":
        return self


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str
    qualifier: Optional[str] = None
    # filled by analyzer:
    index: Optional[int] = None       # ordinal in child output
    dtype: Optional[T.DataType] = None

    def __str__(self):
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    value: Any
    dtype: Optional[T.DataType] = None


@dataclasses.dataclass(frozen=True)
class ParamLiteral(Expr):
    """Tokenized literal: positional slot bound at execution time so
    textually-different queries share one compiled plan (ref:
    ParamLiteral.scala, TokenLiteral.PARAMLITERAL_START)."""

    pos: int
    dtype: Optional[T.DataType] = None


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    """Prepared-statement '?' parameter."""

    pos: int
    dtype: Optional[T.DataType] = None


@dataclasses.dataclass(frozen=True)
class Star(Expr):
    qualifier: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(Expr):
    """(SELECT single value). Uncorrelated: evaluated before planning and
    substituted as a literal (correlated subqueries are a later round)."""

    plan: object = None  # ast.Plan
    dtype: Optional["T.DataType"] = None


@dataclasses.dataclass(frozen=True)
class InSubquery(Expr):
    child: Expr = None
    plan: object = None
    negated: bool = False

    def children(self):
        return (self.child,)

    def map_children(self, fn):
        return dataclasses.replace(self, child=fn(self.child))


@dataclasses.dataclass(frozen=True)
class ExistsSubquery(Expr):
    plan: object = None
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Alias(Expr):
    child: Expr
    name: str

    def children(self):
        return (self.child,)

    def map_children(self, fn):
        return dataclasses.replace(self, child=fn(self.child))


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / % and or = != < <= > >=
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    def map_children(self, fn):
        return dataclasses.replace(self, left=fn(self.left), right=fn(self.right))


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expr):
    op: str  # not, neg
    child: Expr

    def children(self):
        return (self.child,)

    def map_children(self, fn):
        return dataclasses.replace(self, child=fn(self.child))


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    child: Expr
    negated: bool = False

    def children(self):
        return (self.child,)

    def map_children(self, fn):
        return dataclasses.replace(self, child=fn(self.child))


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    child: Expr
    values: Tuple[Expr, ...]
    negated: bool = False

    def children(self):
        return (self.child,) + tuple(self.values)

    def map_children(self, fn):
        return dataclasses.replace(self, child=fn(self.child),
                                   values=tuple(fn(v) for v in self.values))


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    child: Expr
    lo: Expr
    hi: Expr
    negated: bool = False

    def children(self):
        return (self.child, self.lo, self.hi)

    def map_children(self, fn):
        return dataclasses.replace(self, child=fn(self.child), lo=fn(self.lo),
                                   hi=fn(self.hi))


@dataclasses.dataclass(frozen=True)
class Like(Expr):
    child: Expr
    pattern: str
    negated: bool = False

    def children(self):
        return (self.child,)

    def map_children(self, fn):
        return dataclasses.replace(self, child=fn(self.child))


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    whens: Tuple[Tuple[Expr, Expr], ...]
    otherwise: Optional[Expr] = None

    def children(self):
        out = []
        for c, v in self.whens:
            out += [c, v]
        if self.otherwise is not None:
            out.append(self.otherwise)
        return tuple(out)

    def map_children(self, fn):
        return dataclasses.replace(
            self, whens=tuple((fn(c), fn(v)) for c, v in self.whens),
            otherwise=fn(self.otherwise) if self.otherwise is not None else None)


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    child: Expr
    to: T.DataType

    def children(self):
        return (self.child,)

    def map_children(self, fn):
        return dataclasses.replace(self, child=fn(self.child))


@dataclasses.dataclass(frozen=True)
class Func(Expr):
    """Scalar or aggregate function call; analyzer decides which."""

    name: str
    args: Tuple[Expr, ...]
    distinct: bool = False
    dtype: Optional[T.DataType] = None

    def children(self):
        return tuple(self.args)

    def map_children(self, fn):
        return dataclasses.replace(self, args=tuple(fn(a) for a in self.args))


@dataclasses.dataclass(frozen=True)
class WindowFunc(Expr):
    """fn(...) OVER (PARTITION BY ... ORDER BY ...). Default frame: whole
    partition without ORDER BY, running frame with it (SQL default)."""

    name: str = ""
    args: Tuple[Expr, ...] = ()
    partition_by: Tuple[Expr, ...] = ()
    # (expr, ascending, nulls_first) — nulls_first None = Spark default
    order_by: Tuple[Tuple[Expr, bool, Optional[bool]], ...] = ()
    dtype: Optional["T.DataType"] = None

    def children(self):
        return tuple(self.args) + tuple(self.partition_by) + tuple(
            e for e, *_ in self.order_by)

    def map_children(self, fn):
        return dataclasses.replace(
            self, args=tuple(fn(a) for a in self.args),
            partition_by=tuple(fn(p) for p in self.partition_by),
            order_by=tuple((fn(o[0]),) + tuple(o[1:])
                           for o in self.order_by))


WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "lag", "lead",
                "ntile", "sum", "avg", "count", "min", "max",
                "first_value", "last_value"}

AGG_FUNCS = {"sum", "avg", "count", "min", "max", "first", "last",
             "stddev", "variance", "count_distinct", "approx_count_distinct"}


def is_aggregate(e: Expr) -> bool:
    if isinstance(e, Func) and e.name.lower() in AGG_FUNCS:
        return True
    return any(is_aggregate(c) for c in e.children())


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def transform(e: Expr, fn):
    """Bottom-up expression rewrite."""
    rebuilt = e.map_children(lambda c: transform(c, fn))
    return fn(rebuilt)


# --------------------------------------------------------------------------
# Logical plans
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    def children(self) -> Tuple["Plan", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class UnresolvedRelation(Plan):
    name: str
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Relation(Plan):
    """Resolved scan over a catalog table (filled by analyzer)."""

    name: str
    schema: T.Schema = None
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SubqueryAlias(Plan):
    child: Plan
    alias: str

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Project(Plan):
    child: Plan
    exprs: Tuple[Expr, ...]

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Filter(Plan):
    child: Plan
    condition: Expr

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Aggregate(Plan):
    child: Plan
    group_exprs: Tuple[Expr, ...]
    agg_exprs: Tuple[Expr, ...]  # full select list incl. group cols
    # ROLLUP/CUBE/GROUPING SETS: tuples of indices into group_exprs; the
    # session expands them into a UNION ALL of plain aggregates with
    # NULL-filled absent keys before planning (ref: Spark's Expand node)
    grouping_sets: Optional[Tuple[Tuple[int, ...], ...]] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class WindowedRelation(Plan):
    """FROM stream_table WINDOW (DURATION n SECONDS [, SLIDE m SECONDS])
    — the DStream-style sliding window over a stream table (ref:
    WindowLogicalPlan, core/.../sql/streaming). Rewritten per execution
    into an arrival-time filter."""

    child: Plan
    duration_s: float = 0.0
    slide_s: Optional[float] = None

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Join(Plan):
    left: Plan
    right: Plan
    how: str  # inner, left, right, full, cross, semi, anti
    condition: Optional[Expr] = None

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class Sort(Plan):
    child: Plan
    # (expr, ascending, nulls_first) — nulls_first None = Spark default
    # (ASC → NULLS FIRST, DESC → NULLS LAST)
    orders: Tuple[Tuple[Expr, bool, Optional[bool]], ...]

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Limit(Plan):
    child: Plan
    n: int

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Distinct(Plan):
    child: Plan

    def children(self):
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Union(Plan):
    left: Plan
    right: Plan
    all: bool = True

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class SetOp(Plan):
    """INTERSECT / EXCEPT (both DISTINCT semantics, SQL default). Executed
    host-side over materialized children (ref: Spark ReplaceIntersectWith
    SemiJoin / ReplaceExceptWithAntiJoin rewrites feed its exec; set ops
    are driver-small here)."""

    left: Plan = None
    right: Plan = None
    op: str = "intersect"   # 'intersect' | 'except'

    def children(self):
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class Values(Plan):
    rows: Tuple[Tuple[Expr, ...], ...]


@dataclasses.dataclass(frozen=True)
class WindowProject(Plan):
    """Projection containing window functions — lowered to the device
    (`Compiler._emit_window`), or evaluated on the host over the
    materialized child for the shapes the device lane lacks."""

    child: Plan
    exprs: Tuple[Expr, ...] = ()

    def children(self):
        return (self.child,)


# --------------------------------------------------------------------------
# Statements (DDL/DML — executed by the session, not the query engine)
# --------------------------------------------------------------------------

def plan_exprs(p: Plan):
    """Iterate the expressions directly embedded in one plan node."""
    if isinstance(p, Filter):
        yield p.condition
    elif isinstance(p, (Project, WindowProject)):
        yield from p.exprs
    elif isinstance(p, Aggregate):
        yield from p.group_exprs
        yield from p.agg_exprs
    elif isinstance(p, Join):
        if p.condition is not None:
            yield p.condition
    elif isinstance(p, Sort):
        for e, *_ in p.orders:
            yield e


def transform_plan_exprs(p: Plan, fn) -> Plan:
    """Rebuild a plan applying `fn` to every embedded expression
    (bottom-up within each expression)."""
    t = lambda e: transform(e, fn)  # noqa: E731
    if isinstance(p, Filter):
        return Filter(transform_plan_exprs(p.child, fn), t(p.condition))
    if isinstance(p, Project):
        return Project(transform_plan_exprs(p.child, fn),
                       tuple(t(e) for e in p.exprs))
    if isinstance(p, Aggregate):
        return Aggregate(transform_plan_exprs(p.child, fn),
                         tuple(t(g) for g in p.group_exprs),
                         tuple(t(e) for e in p.agg_exprs),
                         grouping_sets=p.grouping_sets)
    if isinstance(p, Join):
        return Join(transform_plan_exprs(p.left, fn),
                    transform_plan_exprs(p.right, fn), p.how,
                    t(p.condition) if p.condition is not None else None)
    if isinstance(p, Sort):
        return Sort(transform_plan_exprs(p.child, fn),
                    tuple((t(o[0]),) + tuple(o[1:]) for o in p.orders))
    if isinstance(p, Limit):
        return Limit(transform_plan_exprs(p.child, fn), p.n)
    if isinstance(p, Distinct):
        return Distinct(transform_plan_exprs(p.child, fn))
    if isinstance(p, Union):
        return Union(transform_plan_exprs(p.left, fn),
                     transform_plan_exprs(p.right, fn), p.all)
    if isinstance(p, SetOp):
        return SetOp(transform_plan_exprs(p.left, fn),
                     transform_plan_exprs(p.right, fn), p.op)
    if isinstance(p, SubqueryAlias):
        return SubqueryAlias(transform_plan_exprs(p.child, fn), p.alias)
    if isinstance(p, WindowProject):
        return WindowProject(transform_plan_exprs(p.child, fn),
                             tuple(t(e) for e in p.exprs))
    if isinstance(p, Values):
        return Values(tuple(tuple(t(e) for e in row) for row in p.rows))
    return p


@dataclasses.dataclass(frozen=True)
class Statement:
    pass


@dataclasses.dataclass(frozen=True)
class ErrorClause:
    """WITH ERROR <frac> [CONFIDENCE <frac>] [BEHAVIOR <b>] — the HAC
    accuracy contract (ref docs/sde/hac_contracts.md:38-74): `error` is
    the maximum tolerated relative error, `confidence` the interval
    probability, `behavior` what to do when a group misses the contract
    (do_nothing | local_omit | strict | run_on_full_table |
    partial_run_on_base_table)."""
    error: float
    confidence: float = 0.95
    behavior: str = "do_nothing"


@dataclasses.dataclass(frozen=True)
class Query(Statement):
    plan: Plan
    params: Tuple[Any, ...] = ()  # tokenized literal values, by position
    with_error: Optional["ErrorClause"] = None


@dataclasses.dataclass(frozen=True)
class ColumnDef:
    name: str
    dtype: T.DataType
    nullable: bool = True
    primary_key: bool = False


@dataclasses.dataclass(frozen=True)
class CreateTable(Statement):
    name: str
    columns: Tuple[ColumnDef, ...]
    provider: str = "column"          # column | row | sample
    options: dict = dataclasses.field(default_factory=dict)
    as_select: Optional[Plan] = None
    if_not_exists: bool = False
    temporary: bool = False
    stream: bool = False  # CREATE STREAM TABLE (ref SnappyDDLParser:716)


@dataclasses.dataclass(frozen=True)
class DropTable(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateFunction(Statement):
    """CREATE [OR REPLACE] FUNCTION name AS '<python lambda>'
    [RETURNS type] (ref: SnappyDDLParser.scala:765 createFunction — a
    jar'd JVM class there, a traceable Python expression here)."""

    name: str
    body: str
    returns: Optional[T.DataType] = None
    or_replace: bool = False


@dataclasses.dataclass(frozen=True)
class DropFunction(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class AlterTable(Statement):
    """ALTER TABLE t ADD [COLUMN] c type | DROP [COLUMN] c
    (ref SnappyDDLParser.scala:697-713, AlterTableAddColumnCommand)."""

    table: str
    add: bool
    column: Optional["ColumnDef"] = None   # ADD
    name: Optional[str] = None             # DROP


@dataclasses.dataclass(frozen=True)
class TruncateTable(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class InsertInto(Statement):
    table: str
    columns: Tuple[str, ...]
    source: Plan                      # Values or query plan
    put: bool = False                 # PUT INTO upsert (ref SnappySession.put)
    overwrite: bool = False


@dataclasses.dataclass(frozen=True)
class UpdateStmt(Statement):
    table: str
    assignments: Tuple[Tuple[str, Expr], ...]
    where: Optional[Expr] = None


@dataclasses.dataclass(frozen=True)
class DeleteStmt(Statement):
    table: str
    where: Optional[Expr] = None


@dataclasses.dataclass(frozen=True)
class ShowTables(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class DescribeTable(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class SetConf(Statement):
    key: str
    value: Any


@dataclasses.dataclass(frozen=True)
class CreateView(Statement):
    name: str
    query: Plan
    or_replace: bool = False


@dataclasses.dataclass(frozen=True)
class DropView(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateMaterializedView(Statement):
    """CREATE MATERIALIZED VIEW name AS <single-relation group-by
    aggregate> — stored aggregate state maintained by delta-folding the
    view's partial program over every ingest batch (views/matview.py)."""

    name: str
    query: Plan = None
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class DropMaterializedView(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class RefreshMaterializedView(Statement):
    """REFRESH MATERIALIZED VIEW name — force a full re-aggregation of
    the base table (clears staleness; also the recovery fallback)."""

    name: str


@dataclasses.dataclass(frozen=True)
class PrepareStmt(Statement):
    """PREPARE name AS <query> — register the query's SQL under a
    per-(user, name) handle in the serving registry (serving/).  The
    query's `?` placeholders become EXECUTE-time bind parameters of ONE
    compiled plan."""

    name: str
    query_sql: str


@dataclasses.dataclass(frozen=True)
class ExecuteStmt(Statement):
    """EXECUTE name [(v1, v2, ...)] — run a PREPAREd statement with
    literal bind values."""

    name: str
    args: tuple = ()


@dataclasses.dataclass(frozen=True)
class DeallocateStmt(Statement):
    """DEALLOCATE [PREPARE] name — drop a named prepared statement."""

    name: str


@dataclasses.dataclass(frozen=True)
class CreatePolicy(Statement):
    """CREATE POLICY name ON table USING (pred) — row-level security
    filter injected into every scan of the table (ref: RowLevelSecurity
    analyzer rule, SnappySessionState.scala:422; core/.../policy)."""

    name: str
    table: str
    using: Expr = None


@dataclasses.dataclass(frozen=True)
class DropPolicy(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateIndex(Statement):
    """CREATE INDEX name ON table (cols) — secondary index (ref:
    CreateIndexTest; row-store indexes)."""

    name: str
    table: str
    columns: tuple = ()
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class DropIndex(Statement):
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class ExplainStmt(Statement):
    """EXPLAIN [ANALYZE] <query> — resolved/optimized plan tree (ref:
    plan info the SnappySQLListener surfaces to the UI).  `analyze`
    EXECUTES the query and annotates the tree with per-operator runtime
    stats (batches scanned/skipped by stats vs dictionary, strategy
    chosen, rows out, per-phase seconds from the request trace)."""

    query: object = None  # ast.Plan
    analyze: bool = False


@dataclasses.dataclass(frozen=True)
class GrantStmt(Statement):
    """GRANT priv[, ...] ON table TO user (ref: grantRevokeExternal,
    SnappyDDLParser.scala:837; LDAP-backed in the reference, session-user
    based here)."""

    privileges: tuple = ()
    table: str = ""
    grantee: str = ""


@dataclasses.dataclass(frozen=True)
class RevokeStmt(Statement):
    privileges: tuple = ()
    table: str = ""
    grantee: str = ""


@dataclasses.dataclass(frozen=True)
class ExecCode(Statement):
    """EXEC PYTHON '<code>' — per-session remote interpreter (ref: EXEC
    SCALA, cluster/.../remote/interpreter/SnappyInterpreterExecute)."""

    code: str


@dataclasses.dataclass(frozen=True)
class DeployStmt(Statement):
    """DEPLOY PACKAGE|JAR name 'paths' — register Python artifacts
    (wheel/zip/dir/.py) on the cluster, importable from EXEC PYTHON and
    persisted in the catalog so they re-install on restart (ref:
    DeployCommand, core/.../execution/ddl.scala; grammar
    SnappyDDLParser.deployPackages:858). REPOS/PATH clauses are parsed
    for dialect parity; this build has no network egress, so coordinates
    must resolve to local files."""

    name: str
    kind: str = "jar"        # 'jar' | 'package'
    coordinates: str = ""    # comma-separated local artifact paths
    repos: str = ""
    cache_path: str = ""


@dataclasses.dataclass(frozen=True)
class UndeployStmt(Statement):
    """UNDEPLOY name (ref: UnDeployCommand, core/.../execution/ddl.scala)."""

    name: str


@dataclasses.dataclass(frozen=True)
class ListDeployed(Statement):
    """LIST PACKAGES | LIST JARS (ref: ListPackageJarsCommand)."""

    kind: str = "packages"
