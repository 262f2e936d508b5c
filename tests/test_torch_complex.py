"""ARRAY / MAP / STRUCT columns through both packages.

Ports of the cases of tests/test_arrays.py and the complex-type cases of
tests/test_alter_and_maps.py: every statement runs in the reference and
in the port (on the CPU) under both plate policies, and the rows and the
`host_fallbacks` / join routing deltas must equal the reference's
(`tests/torch_parity.Pair`; tolerances: ROADMAP "Port rules").  Numeric
and STRING-element arrays, MAP<STRING, V> and flat STRUCTs bind as device
plates, with their string parts as codes of append-only dictionaries;
`size` / `element_at` / `array_contains` lower into the compiled program.
Whole-value SELECTs, nested complex types and non-literal keys take the
host path in both packages.
"""

import decimal

import numpy as np
import pytest

from torch_parity import POLICIES, Pair

from snappydata_tpu import config as ref_config
from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.utils import tpch


@pytest.fixture(autouse=True)
def no_background_compaction():
    """Both packages' background compactors rewrite batches on their own
    clock; a rewrite between two statements would change the plates."""
    props = (ref_config.global_properties(), config.global_properties())
    saved = [p.compaction_enabled for p in props]
    for p in props:
        p.compaction_enabled = False
    yield
    for p, c in zip(props, saved):
        p.compaction_enabled = c


@pytest.fixture(params=POLICIES)
def pair(request):
    return Pair(request.param)


def _device(pair, *queries):
    return [pair.device(q) for q in queries]


def test_array_create_insert_select(pair):
    pair.sql("CREATE TABLE t (id INT, tags ARRAY<STRING>) USING column")
    pair.sql("INSERT INTO t VALUES (1, array('a', 'b')), (2, array('c')), "
             "(3, NULL)")
    # a whole-value SELECT is a host read in both packages
    rows, moved = pair.run("SELECT id, tags FROM t ORDER BY id")
    assert rows == [(1, ["a", "b"]), (2, ["c"]), (3, None)]
    assert moved["host_fallbacks"] == 1


def test_array_functions_and_null_semantics(pair):
    pair.sql("CREATE TABLE t (id INT, v ARRAY<INT>, nn INT) USING column")
    pair.sql("INSERT INTO t VALUES (1, array(10, 20, 30), 20), "
             "(2, array(5), NULL), (3, NULL, 1), (4, array(), 5)")
    got = _device(
        pair,
        "SELECT id, size(v) FROM t ORDER BY id",
        "SELECT id FROM t WHERE array_contains(v, 20) ORDER BY id",
        "SELECT element_at(v, 2), element_at(v, 9), element_at(v, 0) "
        "FROM t ORDER BY id",
        # a NULL needle gives NULL (filtered out), never a match
        "SELECT id FROM t WHERE array_contains(v, nn) ORDER BY id",
        "SELECT id, array_contains(v, nn) FROM t ORDER BY id")
    assert got[0] == [(1, 3), (2, 1), (3, None), (4, 0)]
    assert got[1] == [(1,)]
    assert got[2][0] == (20, None, None)
    assert all(r == (None, None, None) for r in got[2][1:])
    assert got[3] == [(1,)]
    assert got[4] == [(1, True), (2, None), (3, None), (4, False)]
    # the 0-based subscript is a host read in both packages
    pair.run("SELECT v[0] FROM t WHERE id = 1")


def test_array_element_nulls_through_insert_arrays(pair):
    pair.sql("CREATE TABLE avn (id INT, xs ARRAY<DOUBLE>) USING column")
    xs = np.empty(4, dtype=object)
    xs[0] = [1.0, None, 3.0]
    xs[1] = [4.0]
    xs[2] = None
    xs[3] = []
    pair.insert_arrays("avn", [np.arange(4, dtype=np.int32), xs],
                       nulls=[None, np.array([False, False, True, False])])
    rows = pair.device("SELECT id, size(xs), element_at(xs, 2), "
                       "array_contains(xs, 3.0) FROM avn ORDER BY id")
    assert rows[0] == (0, 3, None, True)
    assert rows[1] == (1, 1, None, False)
    assert rows[2][1:] == (None, None, None)
    assert rows[3] == (3, 0, None, False)


def test_arrays_across_batches_and_row_buffer(pair):
    """Bulk insert_arrays with object cells: several batches plus a
    row-buffer tail, then trickle inserts; plain-column queries stay on
    the device beside the array column."""
    pair.sql("CREATE TABLE av (id BIGINT, xs ARRAY<INT>) USING column "
             "OPTIONS (column_batch_rows '256', column_max_delta_rows '64')")
    n = 1000
    xs = np.empty(n, dtype=object)
    for i in range(n):
        xs[i] = [int(i % 7), int(i % 3), int(i % 5)][: (i % 3) + 1]
    pair.insert_arrays("av", [np.arange(n, dtype=np.int64), xs])
    for i in range(3):
        pair.sql(f"INSERT INTO av VALUES ({n + i}, array({i}, {i + 1}))")
    got = _device(
        pair,
        "SELECT count(*) FROM av WHERE size(xs) = 2",
        "SELECT sum(element_at(xs, 1)), max(element_at(xs, 3)) FROM av",
        "SELECT count(*) FROM av WHERE array_contains(xs, 4)",
        "SELECT sum(id) FROM av")
    assert got[0][0][0] == sum(1 for v in xs if len(v) == 2) + 3
    assert got[1][0][0] == sum(v[0] for v in xs) + 3
    assert got[2][0][0] == sum(1 for v in xs if 4 in v)


def test_group_by_and_distinct_on_arrays_stay_host(pair):
    pair.sql("CREATE TABLE t (id INT, v ARRAY<INT>) USING column")
    pair.sql("INSERT INTO t VALUES (1, array(1, 2)), (2, array(1, 2)), "
             "(3, array(9))")
    rows, moved = pair.run(
        "SELECT v, count(*) FROM t GROUP BY v ORDER BY 2 DESC")
    assert rows == [([1, 2], 2), ([9], 1)] and moved["host_fallbacks"]
    pair.run("SELECT DISTINCT v FROM t ORDER BY 1")


def test_string_array_codes_are_append_only(pair):
    pair.sql("CREATE TABLE st (id INT, tags ARRAY<STRING>) USING column")
    pair.sql("INSERT INTO st VALUES (1, array('red', 'green')), "
             "(2, array('blue')), (3, array('green', 'green', 'red')), "
             "(4, NULL), (5, array('a', NULL, 'c'))")
    q = ("SELECT id, size(tags), array_contains(tags, 'green'), "
         "element_at(tags, 1), element_at(tags, 2) FROM st ORDER BY id")
    rows = pair.device(q)
    assert rows[0] == (1, 2, True, "red", "green")
    assert rows[3][1] is None and rows[3][3] is None
    assert rows[4][4] is None            # a NULL element
    # absent needle matches nothing; NULL needle gives NULL
    assert pair.device("SELECT count(*) FROM st WHERE "
                       "array_contains(tags, 'nope')") == [(0,)]
    assert pair.device("SELECT array_contains(tags, NULL) FROM st "
                       "WHERE id = 1") == [(None,)]
    # lexically earlier values arriving later keep every code stable
    pair.sql("INSERT INTO st VALUES (6, array('aardvark', 'red'))")
    pair.device(q)
    assert pair.device("SELECT count(*) FROM st WHERE "
                       "array_contains(tags, 'red')") == [(3,)]
    # a string comparison over an element is a host read in both
    pair.run("SELECT id FROM st WHERE element_at(tags, 1) = 'red' "
             "ORDER BY id")


def test_map_device_element_at(pair):
    pair.sql("CREATE TABLE md (id INT, m MAP<STRING, INT>, "
             "sm MAP<STRING, STRING>) USING column")
    pair.sql("INSERT INTO md VALUES "
             "(1, map('a', 10, 'b', 20), map('x', 'hello')), "
             "(2, map('b', 5), map('x', 'world', 'y', 'z')), "
             "(3, NULL, NULL)")
    got = _device(
        pair,
        "SELECT id, element_at(m, 'b'), size(m), element_at(sm, 'x') "
        "FROM md ORDER BY id",
        "SELECT count(*) FROM md WHERE element_at(m, 'a') = 10",
        # a missing key and a NULL key give NULL
        "SELECT element_at(m, 'nope'), element_at(m, NULL) FROM md "
        "WHERE id = 1")
    assert got[0] == [(1, 20, 2, "hello"), (2, 5, 1, "world"),
                      (3, None, None, None)]
    assert got[1] == [(1,)]
    assert got[2] == [(None, None)]
    pair.sql("INSERT INTO md VALUES (4, map('aa', 7), map('q', 'r'))")
    assert pair.device("SELECT element_at(m, 'b'), element_at(m, 'aa') "
                       "FROM md ORDER BY id")[::3] == [(20, None),
                                                       (None, 7)]
    # whole-map SELECT and the map functions are host reads in both
    pair.run("SELECT m FROM md WHERE id = 1")
    pair.run("SELECT map_keys(m), map_values(m) FROM md WHERE id = 2")


def test_struct_device_field_access(pair):
    pair.sql("CREATE TABLE sd (id INT, "
             "loc STRUCT<city: STRING, pop: INT>) USING column")
    pair.sql("INSERT INTO sd VALUES "
             "(1, named_struct('city', 'oslo', 'pop', 700000)), "
             "(2, named_struct('city', 'bergen', 'pop', 290000)), "
             "(3, NULL)")
    got = _device(
        pair,
        "SELECT id, element_at(loc, 'city'), element_at(loc, 'pop') "
        "FROM sd ORDER BY id",
        "SELECT sum(element_at(loc, 'POP')) FROM sd",
        "SELECT count(*) FROM sd WHERE element_at(loc, 'pop') > 500000")
    assert got[0] == [(1, "oslo", 700000), (2, "bergen", 290000),
                      (3, None, None)]
    assert got[1] == [(990000,)] and got[2] == [(1,)]
    pair.sql("INSERT INTO sd VALUES "
             "(4, named_struct('city', 'alta', 'pop', 21000))")
    assert pair.device("SELECT element_at(loc, 'city') FROM sd "
                       "WHERE id IN (1, 4) ORDER BY id") == [("oslo",),
                                                             ("alta",)]
    rows, moved = pair.run("SELECT loc FROM sd WHERE id = 1")
    assert rows == [({"city": "oslo", "pop": 700000},)]
    assert moved["host_fallbacks"] == 1
    # a GROUP BY over a struct's string field has no device dictionary:
    # host path in both packages
    rows, moved = pair.run("SELECT element_at(loc, 'city') AS c, count(*) "
                           "FROM sd GROUP BY element_at(loc, 'city') "
                           "ORDER BY c")
    assert moved["host_fallbacks"] == 1


def test_alter_add_drop_complex_columns_keep_device_dicts(pair):
    pair.sql("CREATE TABLE ac (id INT) USING column")
    pair.sql("INSERT INTO ac VALUES (1)")
    pair.sql("ALTER TABLE ac ADD COLUMN tags ARRAY<STRING>")
    pair.sql("ALTER TABLE ac ADD COLUMN m MAP<STRING, INT>")
    pair.sql("INSERT INTO ac VALUES (2, array('p', 'q'), map('k', 9))")
    assert pair.device("SELECT id, size(tags), element_at(m, 'k') FROM ac "
                       "ORDER BY id") == [(1, None, None), (2, 2, 9)]
    pair.sql("CREATE TABLE dc (x INT, tags ARRAY<STRING>, "
             "m MAP<STRING, STRING>) USING column")
    pair.sql("INSERT INTO dc VALUES (1, array('a'), map('u', 'v'))")
    assert pair.device("SELECT element_at(m, 'u') FROM dc") == [("v",)]
    pair.sql("ALTER TABLE dc DROP COLUMN x")
    pair.sql("INSERT INTO dc VALUES (array('b'), map('u', 'w'))")
    assert sorted(pair.device("SELECT element_at(m, 'u') FROM dc")) == \
        [("v",), ("w",)]
    assert pair.device("SELECT count(*) FROM dc "
                       "WHERE array_contains(tags, 'b')") == [(1,)]


def test_decimal_values_in_complex_types_stay_exact(pair):
    pair.sql("CREATE TABLE dcx (id INT, "
             "st STRUCT<price: DECIMAL(10,2), name: STRING>, "
             "ar ARRAY<DECIMAL(10,2)>, "
             "mp MAP<STRING, DECIMAL(10,2)>) USING column")
    pair.sql("INSERT INTO dcx VALUES "
             "(1, named_struct('price', 1.50, 'name', 'a'), "
             "array(1.25, 2.50), map('k', 10.01)), "
             "(2, named_struct('price', 2.25, 'name', 'b'), "
             "array(3.75), map('k', 0.99))")
    got = _device(
        pair,
        "SELECT element_at(st, 'price'), element_at(ar, 1), "
        "element_at(mp, 'k') FROM dcx ORDER BY id",
        "SELECT sum(element_at(st, 'price')), sum(element_at(mp, 'k')) "
        "FROM dcx",
        "SELECT count(*) FROM dcx WHERE array_contains(ar, 2.50)",
        "SELECT count(*) FROM dcx WHERE array_contains(ar, 2.51)")
    D = decimal.Decimal
    if pair.policy == "f64":
        assert got[0] == [(D("1.50"), D("1.25"), D("10.01")),
                          (D("2.25"), D("3.75"), D("0.99"))]
        assert got[1] == [(D("3.75"), D("11.00"))]
    assert got[2] == [(1,)] and got[3] == [(0,)]


def test_nested_types_stay_host(pair):
    pair.sql("CREATE TABLE nt (id INT, aa ARRAY<ARRAY<INT>>, "
             "ms MAP<STRING, ARRAY<INT>>, "
             "s STRUCT<a: INT, b: ARRAY<INT>>) USING column")
    pair.sql("INSERT INTO nt VALUES (1, array(array(1, 2), array(3)), "
             "map('k', array(4, 5)), named_struct('a', 1, "
             "'b', array(6))), (2, NULL, NULL, NULL)")
    for q in ("SELECT id, size(aa) FROM nt ORDER BY id",
              "SELECT id, element_at(ms, 'k') FROM nt ORDER BY id",
              "SELECT id, element_at(s, 'a') FROM nt ORDER BY id",
              "SELECT sum(id) FROM nt WHERE size(aa) = 2"):
        _rows, moved = pair.run(q)
        assert moved["host_fallbacks"] == 1, q


def test_ctas_over_complex_columns(pair):
    pair.sql("CREATE TABLE src (id INT, tags ARRAY<STRING>, "
             "m MAP<STRING, DOUBLE>, p STRUCT<x: DOUBLE, l: STRING>) "
             "USING column")
    pair.sql("INSERT INTO src VALUES (1, array('a', 'b'), map('k', 1.5), "
             "named_struct('x', 2.0, 'l', 'q')), (2, NULL, NULL, NULL)")
    pair.sql("CREATE TABLE cp USING column AS SELECT * FROM src")
    pair.device("SELECT id, size(tags), element_at(m, 'k'), "
                "element_at(p, 'l') FROM cp ORDER BY id")
    pair.run("SELECT * FROM cp ORDER BY id")


def _nested_pair(name, orders=300, lines=1200):
    pair = Pair(name)
    pair.sql(tpch.ORDERS_NESTED_DDL)
    nested = tpch.gen_orders_nested(tpch.gen_orders(orders, 100),
                                    tpch.gen_lineitem(lines, 7))
    cols = ["o_orderkey", "o_orderdate", "info", "modes", "prices",
            "qty_by_mode"]
    pair.insert_arrays("orders_nested", [nested[c] for c in cols])
    return pair, nested


def _nested_oracle(nested):
    """Python oracle of N1 and N2 over the generated cells.  A group
    without an AIR line sums to 0.0, as both packages answer (a SUM over
    only NULLs gives 0.0 on the reference's device lane; ROADMAP C)."""
    n1 = {}
    n2 = 0.0
    for info, modes, prices, qm in zip(nested["info"], nested["modes"],
                                       nested["prices"],
                                       nested["qty_by_mode"]):
        if "MAIL" in modes:
            g = n1.setdefault(("AIR" in modes, len(modes) >= 4),
                              [0, 0.0, 0, 0.0, None])
            g[0] += 1
            g[1] += qm.get("AIR", 0.0)
            g[2] += len(modes)
            g[3] += info["totalprice"]
            g[4] = prices[0] if g[4] is None else max(g[4], prices[0])
        if len(prices) >= 3 and info["totalprice"] > 100000:
            n2 += prices[0]
    return ([k + tuple(v) for k, v in sorted(n1.items())], n2)


@pytest.mark.parametrize("name", POLICIES)
def test_nested_orders_queries(name):
    """N1 and N2 of the nested-orders phase at small size: both on the
    device, equal to the reference and to a Python oracle; the original
    GROUP BY over the struct's priority field is a host read in both."""
    pair, nested = _nested_pair(name)
    props = (ref_config.global_properties(), config.global_properties())
    saved = [(p.pallas_reduce, p.pallas_group_reduce) for p in props]
    try:
        for p in props:
            p.pallas_reduce = p.pallas_group_reduce = True
        reg = global_registry()
        lanes0 = reg.counters(("agg_strategy_grouped", "agg_strategy_kahan"))
        n1 = pair.device(tpch.NESTED_N1)
        n2 = pair.device(tpch.NESTED_N2)
        lanes = {k: v - lanes0[k] for k, v in reg.counters(lanes0).items()}
    finally:
        for p, (a, b) in zip(props, saved):
            p.pallas_reduce, p.pallas_group_reduce = a, b
    want1, want2 = _nested_oracle(nested)
    rel = 1e-9 if name == "f64" else 1e-6
    assert [r[:3] for r in n1] == [w[:3] for w in want1]
    for got, want in zip(n1, want1):
        for a, b in zip(got[3:], want[3:]):
            assert a == pytest.approx(b, rel=rel)
    assert n2[0][0] == pytest.approx(want2, rel=rel)
    if name == "f32":
        # float32 plates take the two kernels' lanes (their plain
        # versions on the CPU): N1 the grouped reduce, N2 the Kahan sum
        assert lanes == {"agg_strategy_grouped": 1, "agg_strategy_kahan": 1}
    _rows, moved = pair.run(tpch.NESTED_N1_BY_PRIORITY)
    assert moved["host_fallbacks"] == 1
