"""Plain views of the port (CREATE [OR REPLACE] / DROP VIEW) against the
reference's, and TPC-H Q15 through its view.

A view is stored unresolved and re-analyzed by every query that reads
it; both packages run the same statements under both plate policies, and
the rows and the routing counters must agree.  The definition checks
(no subqueries, validated at CREATE) raise the reference's errors.
"""

import numpy as np
import pytest

from torch_parity import POLICIES, Pair

from snappydata_tpu.sql.analyzer import AnalysisError as RefAnalysisError
from snappydata_tpu_torch import SnappySession
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.sql.analyzer import AnalysisError
from snappydata_tpu_torch.utils import tpch


def _pair(name):
    p = Pair(name)
    p.sql("CREATE TABLE t (k INT, g STRING, x DOUBLE, n BIGINT) "
          "USING column")
    rng = np.random.default_rng(11)
    n = 3000
    p.insert_arrays("t", [
        rng.integers(0, 50, n).astype(np.int32),
        rng.choice(np.array(["a", "b", "c"], dtype=object), n),
        np.round(rng.random(n) * 100, 2), rng.integers(0, 1000, n)])
    p.sql("CREATE TABLE d (k INT, label STRING) USING column")
    p.insert_arrays("d", [np.arange(50, dtype=np.int32),
                          np.array([f"L{i % 7}" for i in range(50)],
                                   dtype=object)])
    return p


@pytest.fixture(scope="module", params=POLICIES)
def pair(request):
    p = _pair(request.param)
    p.sql("CREATE VIEW hi AS SELECT k, g, x FROM t WHERE x > 50")
    p.sql("CREATE VIEW agg AS SELECT g, sum(x) AS sx, count(*) AS c "
          "FROM t GROUP BY g")
    p.sql("CREATE VIEW joined AS SELECT t.k, d.label, t.x FROM t "
          "JOIN d ON t.k = d.k")
    p.sql("CREATE VIEW onview AS SELECT g, max(x) AS mx FROM hi GROUP BY g")
    return p


VIEW_QUERIES = [
    "SELECT count(*), sum(x) FROM hi",
    "SELECT g, count(*), sum(x) FROM hi GROUP BY g ORDER BY g",
    "SELECT * FROM agg ORDER BY g",
    "SELECT g, sx / c FROM agg WHERE c > 10 ORDER BY g",
    "SELECT label, sum(x) FROM joined GROUP BY label ORDER BY label",
    "SELECT * FROM onview ORDER BY g",
    "SELECT h.g, a.sx FROM hi h JOIN agg a ON h.g = a.g "
    "WHERE h.k = 3 ORDER BY h.x",
    "SELECT k FROM hi WHERE x > (SELECT avg(x) FROM hi) ORDER BY k LIMIT 5",
]


@pytest.mark.parametrize("q", VIEW_QUERIES)
def test_view_query_matches_reference(pair, q):
    rows, _ = pair.run(q)
    assert rows


def test_replace_and_drop(pair):
    pair.sql("CREATE VIEW tmp AS SELECT k FROM t WHERE k < 3")
    for s in (pair.port, pair.ref):
        with pytest.raises(ValueError, match="exists"):
            s.sql("CREATE VIEW tmp AS SELECT k FROM t")
    pair.sql("CREATE OR REPLACE VIEW tmp AS SELECT k, x FROM t "
             "WHERE k >= 48")
    rows, _ = pair.run("SELECT count(*), min(k) FROM tmp")
    assert rows[0][1] == 48
    pair.sql("DROP VIEW tmp")
    with pytest.raises(AnalysisError, match="tmp"):
        pair.port.sql("SELECT * FROM tmp")
    with pytest.raises(RefAnalysisError, match="tmp"):
        pair.ref.sql("SELECT * FROM tmp")
    pair.sql("DROP VIEW IF EXISTS tmp")


def test_view_reads_new_rows(pair):
    """A view is re-analyzed per query: rows inserted later show."""
    before, _ = pair.run("SELECT count(*) FROM hi")
    pair.sql("INSERT INTO t VALUES (1, 'z', 99.5, 1)")
    after, _ = pair.run("SELECT count(*) FROM hi")
    assert after[0][0] == before[0][0] + 1
    pair.run("SELECT * FROM agg ORDER BY g")


def test_definitions_checked_at_create():
    s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE t (k INT) USING column")
    with pytest.raises(AnalysisError, match="subqueries"):
        s.sql("CREATE VIEW v AS SELECT k FROM t WHERE k IN "
              "(SELECT k FROM t)")
    with pytest.raises(AnalysisError):
        s.sql("CREATE VIEW v AS SELECT nope FROM t")
    assert s.catalog.lookup_view("v") is None


# -- TPC-H Q15 through CREATE VIEW revenue_v --------------------------------

def _load_q15(pair, sf=0.002, seed=5):
    n_l = int(tpch.LINEITEM_ROWS_PER_SF * sf)
    n_s = max(10, int(10_000 * sf))
    li = tpch.gen_lineitem(n_l, seed)
    li["l_suppkey"] = (li["l_suppkey"] % n_s) + 1
    pair.sql(tpch.LINEITEM_DDL)
    pair.insert_arrays("lineitem", list(li.values()))
    pair.sql(tpch.SUPPLIER_DDL)
    pair.insert_arrays("supplier",
                       list(tpch.gen_supplier(n_s, seed + 3).values()))
    return li


@pytest.mark.parametrize("policy_name", POLICIES)
def test_tpch_q15_through_its_view(policy_name):
    """Q15 at sf 0.002: `Q15_VIEW` then `Q15` in both packages give the
    reference's rows and routing, and the numpy oracle's supplier."""
    p = Pair(policy_name)
    li = _load_q15(p)
    p.sql(tpch.Q15_VIEW)
    rows, moved = p.run(tpch.Q15)
    assert len(rows) >= 1
    rev = li["l_extendedprice"] * (1 - li["l_discount"])
    per = np.bincount(li["l_suppkey"], weights=rev)
    best = np.flatnonzero(np.isclose(per, per.max(), rtol=1e-9))
    assert [r[0] for r in rows] == [int(b) for b in best]
    assert rows[0][2] == pytest.approx(per.max(), rel=1e-6)
    # the reference's routing, which the card run holds too: the join of
    # supplier with the aggregated view and the subquery's max over the
    # view take the host lane (an aggregate under a join)
    assert moved == {"host_fallbacks": 2, "join_device_joins": 0,
                     "join_host_fallbacks": 0}, moved
    # replacing the view re-analyzes Q15 against the new definition
    p.sql(tpch.Q15_VIEW.replace("FROM lineitem",
                                "FROM lineitem WHERE l_quantity < 25"))
    p.run(tpch.Q15)


# -- the host lane's GROUP BY through the device program --------------------

@pytest.fixture
def device_aggs(monkeypatch):
    """Counts the host-lane aggregates the port's device program
    answered (`hosteval._device_aggregate` returned rows)."""
    from snappydata_tpu_torch.engine import hosteval

    real = hosteval._device_aggregate
    hits = []

    def spy(plan, params, executor):
        got = real(plan, params, executor)
        if got is not None:
            hits.append(got[4])
        return got

    monkeypatch.setattr(hosteval, "_device_aggregate", spy)
    return hits


@pytest.mark.parametrize("policy_name", POLICIES)
def test_tpch_q15_view_aggregates_on_the_device(policy_name, device_aggs):
    """Q15's `revenue_v` GROUP BY sits under a join, so the query takes
    the host lane in both packages; the port answers that aggregate with
    the device program, and the rows, their order and the routing stay
    the reference's."""
    p = Pair(policy_name)
    _load_q15(p)
    p.sql(tpch.Q15_VIEW)
    rows, moved = p.run(tpch.Q15)
    assert rows
    assert moved == {"host_fallbacks": 2, "join_device_joins": 0,
                     "join_host_fallbacks": 0}, moved
    # the view is read twice: under the join and under the subquery's max
    assert len(device_aggs) == 2 and min(device_aggs) > 1, device_aggs
    # the whole view in the host lane's order (keys ascending)
    rows, _ = p.run("SELECT v.supplier_no, v.total_rev, s.s_name "
                    "FROM revenue_v v LEFT JOIN supplier s "
                    "ON v.supplier_no = s.s_suppkey")
    assert [r[0] for r in rows] == sorted(r[0] for r in rows)


def _keyed_pair(name):
    """`w`: NULL-bearing STRING, DECIMAL and INT keys over 4,000 rows in
    four batches, plus a group whose `x` is all NULL; `lab`: a small
    table to join the groups with."""
    p = Pair(name)
    p.sql("CREATE TABLE w (ks STRING, kd DECIMAL(10,2), ki INT, "
          "x DOUBLE, m DECIMAL(12,2)) USING column")
    rng = np.random.default_rng(23)
    n = 4000
    ks = rng.choice(np.array(["pear", "apple", "fig", "kiwi", "Zed", ""],
                             dtype=object), n)
    kd = rng.choice(np.array([-1.25, 0.0, 0.5, 2.75, 10.1]), n)
    ki = rng.integers(-3, 5, n).astype(np.int32)
    x = np.round(rng.random(n) * 1000 - 300, 3)
    m = np.round(rng.random(n) * 50, 2)
    nulls = [rng.random(n) < 0.07, rng.random(n) < 0.05,
             rng.random(n) < 0.06, rng.random(n) < 0.03, None]
    for lo in range(0, n, 1000):
        p.insert_arrays("w", [a[lo:lo + 1000] for a in (ks, kd, ki, x, m)],
                        nulls=[None if nm is None else nm[lo:lo + 1000]
                               for nm in nulls])
    p.insert_arrays("w", [np.array(["void"] * 3, dtype=object),
                          np.full(3, 7.75), np.full(3, 9, dtype=np.int32),
                          np.zeros(3), np.full(3, 1.5)],
                    nulls=[None, None, None, np.ones(3, dtype=bool), None])
    p.sql("CREATE TABLE lab (ks STRING, kd DECIMAL(10,2), ki INT, "
          "tag STRING) USING column")
    p.insert_arrays("lab", [
        np.array(["pear", "apple", "fig", "kiwi", "Zed", "", "void", "fig"],
                 dtype=object),
        np.array([-1.25, 0.0, 0.5, 2.75, 10.1, 7.75, 3.0, 0.5]),
        np.arange(-3, 5, dtype=np.int32),
        np.array([f"T{i}" for i in range(8)], dtype=object)])
    return p


NOT_NULL = "ks IS NOT NULL AND kd IS NOT NULL AND ki IS NOT NULL"
# view -> (definition, whether the port's host lane answers it with the
# device program): NULL keys and arithmetic over aggregates stay on the
# host lane's own aggregate
KEYED_AGGS = {
    "s": ("SELECT ks, sum(x) AS sx, count(*) AS c, avg(m) AS am FROM w "
          "GROUP BY ks", False),
    "s_nn": ("SELECT ks, sum(x) AS sx, count(*) AS c, avg(m) AS am FROM w "
             "WHERE ks IS NOT NULL GROUP BY ks", True),
    "d": ("SELECT kd, sum(m) AS sm, min(x) AS mn, max(m) AS mx, "
          "count(ks) AS cs FROM w GROUP BY kd", False),
    "d_nn": ("SELECT kd, sum(m) AS sm, min(x) AS mn, max(x) AS mx, "
             "avg(x) AS ax, sum(x) AS sx, count(x) AS cx FROM w "
             "WHERE kd IS NOT NULL GROUP BY kd", True),
    "sdi_nn": ("SELECT ks, kd, ki, sum(x) AS sx, count(*) AS c, "
               "min(x) AS mn, max(x) AS mx FROM w "
               f"WHERE (x > -200 OR x IS NULL) AND {NOT_NULL} "
               "GROUP BY ks, kd, ki", True),
    "ids": ("SELECT ki, kd, ks, sum(m * 2) AS sm, max(x) - min(x) AS rng "
            "FROM w GROUP BY ki, kd, ks", False),
    "ids_nn": ("SELECT ki, kd, ks, sum(m * 2) AS sm, "
               f"max(x) - min(x) AS rng FROM w WHERE {NOT_NULL} "
               "GROUP BY ki, kd, ks", False),
}


@pytest.mark.parametrize("policy_name", POLICIES)
@pytest.mark.parametrize("view", sorted(KEYED_AGGS))
def test_host_lane_group_by_null_string_decimal_keys(policy_name, view,
                                                     device_aggs):
    """A GROUP BY over NULL-bearing STRING / DECIMAL / INT keys, read
    under a join (the host lane in both packages): the rows, their order
    and the routing are the reference's, whether the port's device
    program answered the aggregate (keys ascending) or the host lane's
    own aggregate did."""
    sql, on_device = KEYED_AGGS[view]
    p = _keyed_pair(policy_name)
    p.sql(f"CREATE VIEW g AS {sql}")
    key = sql.split()[1].rstrip(",")
    for q in (f"SELECT g.*, lab.tag FROM g LEFT JOIN lab "
              f"ON g.{key} = lab.{key}",
              f"SELECT g.*, lab.tag FROM g, lab WHERE g.{key} = lab.{key}"):
        device_aggs.clear()
        rows, moved = p.run(q)
        assert rows and moved["host_fallbacks"] >= 1, (q, moved)
        assert len(device_aggs) == int(on_device), (q, device_aggs)
    if on_device:
        n_groups = len(p.run(f"{sql} ORDER BY 1")[0])
        assert device_aggs == [n_groups]
