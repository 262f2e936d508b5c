"""Subqueries through `SnappySession.sql`, port vs reference.

The port rewrites subqueries as the reference does: correlated [NOT]
EXISTS and IN become semi and anti joins, a correlated scalar aggregate
becomes a join on its grouped result (`_decorrelate`), and an
uncorrelated subquery runs as a query of its own whose result
substitutes literals (`_rewrite_subqueries`).  Every case runs the same
SQL over the same rows through both packages (the port on the CPU):

- the nine TPC-H subquery queries of `utils/tpch.py` at sf 0.01, seed 5
  (the scale where the reference's Q20 and Q21 return rows), under both
  `decimal_as_float64` settings, with equal `host_fallbacks`,
  `join_device_joins` and `join_host_fallbacks` deltas, and at sf 0.002
  with the reference's routing spelled out; Q15 fails in both until
  views are ported;
- companions for Q11 and Q22, which come back empty on this generator:
  hand-made tables where the reference returns rows;
- the cases of tests/test_subqueries.py that need no DML or views, the
  large-literal IN list lowering (fault C2: decimal and DATE children
  too), a correlated shape `_decorrelate` does not handle, and
  tests/test_decimal_exact.py::test_subquery_literal_substitution.

Floats compare within rel 1e-9 (float64 plates) or 1e-6 (float32
plates); counts, keys, MIN and MAX exactly.
"""

import contextlib
import decimal

import numpy as np
import pytest

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu.sql.analyzer import AnalysisError as RefAnalysisError
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.sql.analyzer import AnalysisError
from snappydata_tpu_torch.utils import tpch

SUBQUERY_QUERIES = (2, 4, 11, 16, 17, 18, 20, 21, 22)
ROUTED = ("host_fallbacks", "join_device_joins", "join_host_fallbacks")
_REL = {"f64": 1e-9, "f32": 1e-6}


@contextlib.contextmanager
def policy(name):
    """Both packages' plate policy: float64 plates or float32 plates."""
    props = (ref_config.global_properties(), config.global_properties())
    saved = [p.decimal_as_float64 for p in props]
    for p in props:
        p.decimal_as_float64 = name == "f64"
    try:
        yield
    finally:
        for p, old in zip(props, saved):
            p.decimal_as_float64 = old


def _counters(reg):
    snap = reg.snapshot()
    return dict(snap["counters"]) if "counters" in snap else dict(snap)


def assert_rows_equal(got, want, rel):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, (float, np.floating)):
                assert a == pytest.approx(b, rel=rel, abs=1e-9), (g, w)
            else:
                assert a == b, (g, w)


class Pair:
    """One reference session and one port session on the CPU, loaded
    with the same rows under one plate policy."""

    def __init__(self, name="f64"):
        self.policy = name
        self.ref = RefSession(catalog=RefCatalog())
        self.port = SnappySession(catalog=Catalog(), device="cpu")

    def sql(self, q):
        with policy(self.policy):
            self.ref.sql(q)
            self.port.sql(q)

    def insert_arrays(self, table, arrays, nulls=None):
        with policy(self.policy):
            for s in (self.ref, self.port):
                if nulls is None:   # row tables take no null masks
                    s.insert_arrays(table, [np.asarray(a) for a in arrays])
                    continue
                s.catalog.describe(table).data.insert_arrays(
                    [np.asarray(a) for a in arrays], nulls=nulls)

    def run(self, q):
        """(port rows, port counter deltas) after asserting the rows and
        the routing counters equal the reference's."""
        out = []
        with policy(self.policy):
            for s, reg in ((self.port, global_registry()),
                           (self.ref, ref_registry())):
                before = _counters(reg)
                rows = [tuple(r) for r in s.sql(q).rows()]
                after = _counters(reg)
                out.append((rows, {k: after.get(k, 0) - before.get(k, 0)
                                   for k in ROUTED}))
        (prows, pmoved), (rrows, rmoved) = out
        assert_rows_equal(prows, rrows, _REL[self.policy])
        assert pmoved == rmoved, (q, pmoved, rmoved)
        return prows, pmoved

    def device(self, q, expect=None):
        rows, moved = self.run(q)
        assert moved["host_fallbacks"] == 0, f"{q} left the device"
        if expect is not None:
            assert rows == expect
        return rows


def _load_tpch(pair, sf, seed=5):
    """TPC-H in both packages from the same arrays, with the real DDL:
    nation and region are row tables."""
    n_l = int(tpch.LINEITEM_ROWS_PER_SF * sf)
    n_o = int(tpch.ORDERS_ROWS_PER_SF * sf)
    n_c = int(tpch.CUSTOMER_ROWS_PER_SF * sf)
    n_s, n_p = max(10, int(10_000 * sf)), max(50, int(200_000 * sf))
    li = tpch.gen_lineitem(n_l, seed)
    li["l_orderkey"] = np.minimum(li["l_orderkey"], n_o)
    li["l_suppkey"] = (li["l_suppkey"] % n_s) + 1
    li["l_partkey"] = (li["l_partkey"] % n_p) + 1
    tables = [
        (tpch.LINEITEM_DDL, "lineitem", li),
        (tpch.ORDERS_DDL, "orders", tpch.gen_orders(n_o, n_c, seed + 1)),
        (tpch.CUSTOMER_DDL, "customer", tpch.gen_customer(n_c, seed + 2)),
        (tpch.SUPPLIER_DDL, "supplier", tpch.gen_supplier(n_s, seed + 3)),
        (tpch.PART_DDL, "part", tpch.gen_part(n_p, seed + 4)),
        (tpch.PARTSUPP_DDL, "partsupp",
         tpch.gen_partsupp(n_p, n_s, seed + 6)),
        (tpch.NATION_DDL, "nation", tpch.gen_nation()),
        (tpch.REGION_DDL, "region", tpch.gen_region()),
    ]
    for ddl, name, cols in tables:
        pair.sql(ddl)
        pair.insert_arrays(name, list(cols.values()))
    return pair


@pytest.fixture(scope="module", params=["f64", "f32"])
def tpch_sf001(request):
    return _load_tpch(Pair(request.param), 0.01)


@pytest.fixture(scope="module")
def tpch_sf0002():
    return _load_tpch(Pair("f64"), 0.002)


@pytest.mark.parametrize("qnum", SUBQUERY_QUERIES)
def test_tpch_subquery_matches_reference(tpch_sf001, qnum):
    """The reference's rows, with the reference's device and host
    routing."""
    rows, _moved = tpch_sf001.run(tpch.ALL_QUERIES[qnum])
    if qnum in (2, 4, 16, 17, 18, 20, 21):
        assert rows, f"Q{qnum} returned no rows: the check checks nothing"


# the reference's routing at sf 0.002: Q2, Q11 and Q21 reroute on a
# non-equi / cross join, Q17 and Q20 on an aggregate under a join
EXPECTED_HOST_FALLBACKS = {2: 1, 4: 0, 11: 2, 16: 0, 17: 1, 18: 0, 20: 1,
                           21: 1, 22: 0}


@pytest.mark.parametrize("qnum", SUBQUERY_QUERIES)
def test_tpch_subquery_routing_at_sf_0002(tpch_sf0002, qnum):
    _rows, moved = tpch_sf0002.run(tpch.ALL_QUERIES[qnum])
    assert moved["host_fallbacks"] == EXPECTED_HOST_FALLBACKS[qnum]
    if qnum in (4, 16, 18, 22):
        assert moved["join_device_joins"] >= 1
    if qnum in (2, 11, 21):
        assert moved["join_host_fallbacks"] == moved["host_fallbacks"]


def test_tpch_q15_needs_its_view_in_both(tpch_sf0002):
    with pytest.raises(AnalysisError, match="revenue_v"):
        tpch_sf0002.port.sql(tpch.Q15)
    with pytest.raises(RefAnalysisError, match="revenue_v"):
        tpch_sf0002.ref.sql(tpch.Q15)


# --- Q11 and Q22 where they return rows ------------------------------------

@pytest.mark.parametrize("name", ["f64", "f32"])
def test_q11_having_against_an_uncorrelated_scalar(name):
    """Q11's HAVING compares each part's value with 5% of the total, an
    uncorrelated scalar subquery substituted as a literal."""
    pair = Pair(name)
    pair.sql(tpch.PARTSUPP_DDL)
    pair.sql(tpch.SUPPLIER_DDL)
    pair.sql(tpch.NATION_DDL)
    pair.insert_arrays("nation", list(tpch.gen_nation().values()))
    pair.insert_arrays("supplier", [
        np.arange(1, 5, dtype=np.int64),
        np.array([f"Supplier#{i}" for i in range(1, 5)], dtype=object),
        np.array([7, 7, 3, 7], dtype=np.int32),    # 7 is GERMANY
        np.array([1.0, 2.0, 3.0, 4.0])])
    rng = np.random.default_rng(2)
    pk = np.repeat(np.arange(1, 41, dtype=np.int64), 4)
    sk = np.tile(np.arange(1, 5, dtype=np.int64), 40)
    qty = rng.integers(1, 100, 160).astype(np.int32)
    qty[:8] = 5000   # parts 1 and 2 dominate the total
    cost = np.round(rng.uniform(1, 10, 160), 2)
    pair.insert_arrays("partsupp", [pk, sk, qty, cost])
    # both packages take the host path for the comma join at this size
    rows, _moved = pair.run(tpch.Q11)
    val = np.where(np.isin(sk, [1, 2, 4]), cost * qty, 0.0)
    per_part = np.bincount(pk, weights=val)
    want = [p for p in np.argsort(-per_part, kind="stable")
            if per_part[p] > 0.05 * val.sum()]
    assert [r[0] for r in rows] == want and len(want) == 2
    assert [r[1] for r in rows] == pytest.approx(per_part[want],
                                                 rel=_REL[name])


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_q22_not_exists_with_customers_without_orders(name):
    """Q22 over customers of whom some have no orders: the scalar avg
    substitutes a literal, NOT EXISTS becomes an anti join."""
    pair = Pair(name)
    pair.sql(tpch.CUSTOMER_DDL)
    pair.sql(tpch.ORDERS_DDL)
    cust = tpch.gen_customer(400, 3)
    pair.insert_arrays("customer", list(cust.values()))
    orders = tpch.gen_orders(600, 400, 4)
    # customers 1..150 have no orders
    orders["o_custkey"] = 151 + orders["o_custkey"] % 250
    pair.insert_arrays("orders", list(orders.values()))
    rows = pair.device(tpch.Q22)
    assert rows
    m = np.isin(cust["c_nationkey"], [1, 3, 5, 7])
    bal = cust["c_acctbal"]
    avg = bal[m & (bal > 0)].mean()
    keep = m & (bal > avg) & ~np.isin(cust["c_custkey"],
                                      orders["o_custkey"])
    want = sorted((int(k), int((cust["c_nationkey"][keep] == k).sum()))
                  for k in np.unique(cust["c_nationkey"][keep]))
    assert [(r[0], r[1]) for r in rows] == want


# --- tests/test_subqueries.py ----------------------------------------------

@pytest.fixture(params=["f64", "f32"])
def pair(request):
    return Pair(request.param)


def test_scalar_subquery(pair):
    pair.sql("CREATE TABLE t (a INT) USING column")
    pair.sql("INSERT INTO t VALUES (1), (5), (9)")
    pair.device("SELECT a FROM t WHERE a = (SELECT max(a) FROM t)", [(9,)])
    pair.device("SELECT a FROM t WHERE a > (SELECT avg(a) FROM t)", [(9,)])
    # zero rows substitute NULL: the comparison is never true
    pair.device("SELECT a FROM t WHERE a = (SELECT max(a) FROM t "
                "WHERE a > 100)", [])


def test_scalar_subquery_with_two_rows_raises_in_both(pair):
    pair.sql("CREATE TABLE t (a INT) USING column")
    pair.sql("INSERT INTO t VALUES (1), (5)")
    q = "SELECT a FROM t WHERE a = (SELECT a FROM t)"
    with pytest.raises(AnalysisError, match="more than one row"):
        pair.port.sql(q)
    with pytest.raises(RefAnalysisError, match="more than one row"):
        pair.ref.sql(q)


def test_in_and_exists_subqueries(pair):
    pair.sql("CREATE TABLE a (x INT) USING column")
    pair.sql("CREATE TABLE b (y INT) USING column")
    pair.sql("INSERT INTO a VALUES (1), (2), (3)")
    pair.sql("INSERT INTO b VALUES (2), (3), (4)")
    assert sorted(r[0] for r in pair.device(
        "SELECT x FROM a WHERE x IN (SELECT y FROM b)")) == [2, 3]
    pair.device("SELECT x FROM a WHERE x NOT IN (SELECT y FROM b)", [(1,)])
    pair.device("SELECT count(*) FROM a WHERE EXISTS (SELECT 1 FROM b)",
                [(3,)])
    # the reference empties b with DELETE, which the port lacks
    pair.sql("TRUNCATE TABLE b")
    pair.device("SELECT count(*) FROM a WHERE EXISTS (SELECT 1 FROM b)",
                [(0,)])
    pair.device("SELECT count(*) FROM a WHERE x NOT IN (SELECT y FROM b)",
                [(3,)])


def test_correlated_exists_and_in_become_semi_and_anti_joins(pair):
    pair.sql("CREATE TABLE a (x INT, g STRING) USING column")
    pair.sql("CREATE TABLE b (y INT, h STRING, w DOUBLE) USING column")
    pair.sql("INSERT INTO a VALUES (1, 'p'), (2, 'q'), (3, 'p'), (4, 'r')")
    pair.sql("INSERT INTO b VALUES (2, 'q', 1.5), (3, 'q', 2.5), "
             "(3, 'p', 0.5), (5, 'p', 9.0)")
    before = global_registry().counter("join_device_joins")
    pair.device("SELECT x FROM a WHERE EXISTS (SELECT 1 FROM b "
                "WHERE b.y = a.x AND b.w > 1.0) ORDER BY x", [(2,), (3,)])
    pair.device("SELECT x FROM a WHERE NOT EXISTS (SELECT 1 FROM b "
                "WHERE b.y = a.x) ORDER BY x", [(1,), (4,)])
    pair.device("SELECT x FROM a WHERE x IN (SELECT y FROM b "
                "WHERE b.h = a.g) ORDER BY x", [(2,), (3,)])
    assert global_registry().counter("join_device_joins") == before + 3
    # an inner FROM of two tables: the semi / anti join's build side is a
    # join itself, a derived relation sorted per execution
    pair.sql("CREATE TABLE c (z INT, tag STRING) USING column")
    pair.sql("INSERT INTO c VALUES (2, 'k'), (3, 'k'), (5, 'm')")
    pair.device("SELECT x FROM a WHERE EXISTS (SELECT 1 FROM b, c "
                "WHERE b.y = c.z AND c.tag = 'k' AND b.y = a.x) ORDER BY x",
                [(2,), (3,)])
    pair.device("SELECT x FROM a WHERE NOT EXISTS (SELECT 1 FROM b, c "
                "WHERE b.y = c.z AND b.y = a.x) ORDER BY x", [(1,), (4,)])
    # a correlated scalar aggregate becomes a join on its grouped result
    pair.run("SELECT x FROM a WHERE x < (SELECT sum(w) FROM b "
             "WHERE b.h = a.g) ORDER BY x")


def test_not_in_with_null_is_never_true(pair):
    pair.sql("CREATE TABLE a (x INT) USING column")
    pair.sql("CREATE TABLE b (y INT) USING column")
    pair.sql("INSERT INTO a VALUES (1), (2)")
    pair.sql("INSERT INTO b VALUES (1), (NULL)")
    pair.device("SELECT x FROM a WHERE x NOT IN (SELECT y FROM b)", [])
    pair.device("SELECT x FROM a WHERE x IN (SELECT y FROM b)", [(1,)])


def test_in_subquery_over_strings(pair):
    pair.sql("CREATE TABLE a (k STRING, v INT) USING column")
    pair.sql("CREATE TABLE b (s STRING) USING column")
    pair.sql("INSERT INTO a VALUES ('x', 1), ('y', 2), ('z', 3), "
             "(NULL, 4)")
    pair.sql("INSERT INTO b VALUES ('y'), ('z'), ('w')")
    pair.device("SELECT v FROM a WHERE k IN (SELECT s FROM b) ORDER BY v",
                [(2,), (3,)])
    pair.device("SELECT v FROM a WHERE k NOT IN (SELECT s FROM b) "
                "ORDER BY v", [(1,)])


def test_float_column_in_large_int_list(pair):
    pair.sql("CREATE TABLE t (id INT, d DOUBLE) USING column")
    pair.sql("INSERT INTO t VALUES (1, 1.5), (2, 2.0), (3, 9.5)")
    # 1.5 / 9.5 must NOT truncate-match
    pair.device("SELECT id FROM t WHERE d IN (1,2,3,4,5,6,7,8,9)", [(2,)])


# --- fault C2: large literal IN lists stay on the device -------------------

def test_large_in_list_sorted_lowering(pair):
    """A literal list longer than 8 lowers to a sorted aux tensor and a
    searchsorted probe on the device, as in the reference.  Before the
    repair the port took a counted host fallback for each (C2)."""
    n = 2000
    k = np.arange(n, dtype=np.int64)
    pair.sql("CREATE TABLE t (k BIGINT, d DOUBLE, m DECIMAL(10,2), "
             "dt DATE) USING column")
    pair.insert_arrays("t", [k, k * 0.5, k * 0.25, 18000 + k.astype(
        np.int32)])
    vals = ",".join(str(v) for v in range(0, n, 7))
    pair.device(f"SELECT count(*) FROM t WHERE k IN ({vals})",
                [(len(range(0, n, 7)),)])
    pair.device(f"SELECT count(*) FROM t WHERE k NOT IN ({vals})",
                [(n - len(range(0, n, 7)),)])
    # a DOUBLE child against an int list compares in float64
    pair.device(f"SELECT count(*) FROM t WHERE d NOT IN ({vals})",
                [(n - len(range(0, n // 2, 7)),)])
    # an exact-decimal child, with decimal literals
    dvals = ",".join(f"{v * 0.25:.2f}" for v in range(0, n, 7))
    pair.device(f"SELECT count(*), sum(m) FROM t WHERE m IN ({dvals})")
    # a DATE child against DATE literals
    import datetime
    epoch = datetime.date(1970, 1, 1)
    dates = ",".join(
        f"DATE '{(epoch + datetime.timedelta(days=18000 + v)).isoformat()}'"
        for v in range(0, n, 11))
    pair.device(f"SELECT count(*) FROM t WHERE dt IN ({dates})",
                [(len(range(0, n, 11)),)])
    # the IN subquery shape: its result substitutes a literal list
    pair.sql("CREATE TABLE s (v BIGINT) USING column")
    pair.insert_arrays("s", [np.arange(0, n, 13, dtype=np.int64)])
    pair.device("SELECT count(*) FROM t WHERE k IN (SELECT v FROM s)",
                [(len(range(0, n, 13)),)])
    pair.device("SELECT count(*) FROM t WHERE k NOT IN (SELECT v FROM s)",
                [(n - len(range(0, n, 13)),)])


def test_large_in_list_with_null_child_rows(pair):
    pair.sql("CREATE TABLE t (k BIGINT) USING column")
    rng = np.random.default_rng(8)
    k = rng.integers(0, 100, 500).astype(np.int64)
    pair.insert_arrays("t", [k], nulls=[rng.random(500) < 0.2])
    vals = ",".join(str(v) for v in range(0, 100, 3))
    pair.device(f"SELECT count(*) FROM t WHERE k IN ({vals})")
    pair.device(f"SELECT count(*) FROM t WHERE k NOT IN ({vals})")


# --- shapes the rewrite does not handle ------------------------------------

def test_unhandled_correlated_shape_raises_in_both(pair):
    """A non-equi correlation inside a scalar aggregate is not rewritten:
    the subquery then runs alone, cannot resolve the outer column, and
    both packages raise the reference's AnalysisError."""
    pair.sql("CREATE TABLE a (x INT) USING column")
    pair.sql("CREATE TABLE b (y INT) USING column")
    pair.sql("INSERT INTO a VALUES (1), (2)")
    pair.sql("INSERT INTO b VALUES (1), (3)")
    q = ("SELECT x FROM a WHERE x > (SELECT max(y) FROM b "
         "WHERE b.y < a.x)")
    with pytest.raises(AnalysisError,
                       match="correlated subqueries are not supported"):
        pair.port.sql(q)
    with pytest.raises(RefAnalysisError,
                       match="correlated subqueries are not supported"):
        pair.ref.sql(q)


# --- tests/test_decimal_exact.py -------------------------------------------

def test_subquery_literal_substitution(pair):
    """Scalar-subquery results substitute as Decimal literals: they must
    scale into the exact domain, not truncate to int."""
    pair.sql("CREATE TABLE sq (k BIGINT, v DECIMAL(10,2)) USING column")
    pair.sql("INSERT INTO sq VALUES (1, 24.05), (2, 10.00), (3, 24.05)")
    rows = pair.device("SELECT k FROM sq WHERE v = (SELECT max(v) FROM sq) "
                       "ORDER BY k")
    assert [r[0] for r in rows] == [1, 3]
    rows = pair.device("SELECT sum(v) FROM sq WHERE v > "
                       "(SELECT min(v) FROM sq)")
    assert rows[0][0] == decimal.Decimal("48.10")
