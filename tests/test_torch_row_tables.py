"""Row tables (`USING row`) through both packages.

A row table keeps host rows with a primary-key hash index: inserts
refuse a duplicate key, PUT INTO upserts on it, `get` and a key-equality
query answer from the index without the device engine, and a scan binds
the rows as one [1, N] device plate (cached per mutation version).  Each
case runs the same statements through the reference and the port (on
the CPU), under both plate policies, and asserts the reference's rows
and routing (`host_fallbacks`, join counters); the joins of a row table
with a column table stay on the device in both.
"""

import numpy as np
import pytest

from torch_parity import POLICIES, Pair, policy

from snappydata_tpu_torch.observability.metrics import global_registry

DDL = ("CREATE TABLE dim (id INT PRIMARY KEY, name STRING, w DOUBLE, "
       "grp INT) USING row")


@pytest.fixture(params=POLICIES)
def pair(request):
    p = Pair(request.param)
    p.sql(DDL)
    rows = ", ".join(
        f"({i}, 'n{i % 5}', {'NULL' if i % 7 == 0 else i * 0.25}, {i % 3})"
        for i in range(1, 31))
    p.sql(f"INSERT INTO dim VALUES {rows}")
    p.sql("CREATE TABLE fact (fid INT, dim_id INT, amount DOUBLE) "
          "USING column")
    rng = np.random.default_rng(8)
    n = 2000
    p.insert_arrays("fact", [np.arange(n, dtype=np.int32),
                             rng.integers(0, 35, n).astype(np.int32),
                             rng.integers(1, 400, n) / 4.0])
    return p


def test_scan_and_aggregate(pair):
    pair.device("SELECT * FROM dim ORDER BY id")
    pair.device("SELECT grp, count(*), count(grp), sum(w), min(w), max(id) "
                "FROM dim GROUP BY grp ORDER BY grp")
    pair.device("SELECT name, sum(w) FROM dim WHERE w > 2 GROUP BY name "
                "ORDER BY name")


def test_duplicate_key_insert_raises_in_both(pair):
    for s in (pair.port, pair.ref):
        with policy(pair.policy), pytest.raises(ValueError,
                                                match="primary key"):
            s.sql("INSERT INTO dim VALUES (3, 'dup', 1.0, 1)")
    pair.device("SELECT count(*) FROM dim")


def test_put_upserts_on_the_key_and_get_reads_it(pair):
    port, ref = pair.sql("PUT INTO dim VALUES (3, 'three', 9.5, 2), "
                         "(99, 'new', 1.5, NULL)")
    assert port == ref
    assert pair.port.get("dim", (3,)) == pair.ref.get("dim", (3,))
    assert tuple(pair.port.get("dim", (3,)))[1:] == ("three", 9.5, 2)
    assert pair.port.get("dim", (99,))[3] is None
    assert pair.port.get("dim", (1000,)) is None
    pair.device("SELECT count(*), sum(w) FROM dim")
    pair.port.put("dim", (4, "four", 4.0, 1))
    pair.ref.put("dim", (4, "four", 4.0, 1))
    pair.device("SELECT * FROM dim ORDER BY id")


def test_key_equality_query_is_a_point_lookup(pair):
    reg = global_registry()
    before = reg.counter("point_lookups")
    rows, moved = pair.run("SELECT name, w FROM dim WHERE id = 12")
    assert rows == [("n2", 3.0)]
    assert reg.counter("point_lookups") == before + 1
    assert moved["host_fallbacks"] == 0
    pair.run("SELECT * FROM dim WHERE id = 555")


def test_update_and_delete(pair):
    for stmt in ("UPDATE dim SET w = w * 2, name = 'upd' WHERE grp = 1",
                 "UPDATE dim SET grp = NULL WHERE id < 4",
                 "DELETE FROM dim WHERE w > 12",
                 "DELETE FROM dim WHERE grp IS NULL"):
        port, ref = pair.sql(stmt)
        assert port == ref, stmt
        pair.device("SELECT * FROM dim ORDER BY id")
    for k in (2, 5, 29):
        assert pair.port.get("dim", (k,)) == pair.ref.get("dim", (k,))


@pytest.mark.parametrize("name", POLICIES)
def test_update_over_an_integer_null(name):
    """UPDATE of a row table whose INT column holds a NULL: the port
    types the predicate columns as its DELETE does and answers; the
    reference raises TypeError (ROADMAP C, faults of the reference), so
    the port is held against Python."""
    p = Pair(name)
    p.sql("CREATE TABLE d (id INT PRIMARY KEY, g INT, w DOUBLE) USING row")
    p.sql("INSERT INTO d VALUES (1, NULL, 1.0), (2, 3, 2.0), (3, 4, NULL)")
    with policy(name):
        with pytest.raises(TypeError):
            p.ref.sql("UPDATE d SET w = 5.0 WHERE id = 2")
        assert p.port.sql("UPDATE d SET w = 5.0 WHERE g > 2").rows() \
            == [(2,)]
        assert p.port.sql("UPDATE d SET g = NULL WHERE w > 4").rows() \
            == [(2,)]
        rows = p.port.sql("SELECT id, g, w FROM d ORDER BY id").rows()
    assert [tuple(r) for r in rows] == [(1, None, 1.0), (2, None, 5.0),
                                        (3, None, 5.0)]


def test_update_of_the_key_rebuilds_the_index(pair):
    port, ref = pair.sql("UPDATE dim SET id = id + 100 WHERE id > 25")
    assert port == ref
    assert pair.port.get("dim", (126,)) == pair.ref.get("dim", (126,))
    assert pair.port.get("dim", (26,)) is None
    for s in (pair.port, pair.ref):
        with policy(pair.policy), pytest.raises(ValueError,
                                                match="primary key"):
            s.sql("UPDATE dim SET id = 1 WHERE id = 2")


@pytest.mark.parametrize("how", ["inner", "left", "semi"])
def test_joins_with_a_column_table(pair, how):
    if how == "semi":
        q = ("SELECT count(*), sum(amount) FROM fact WHERE dim_id IN "
             "(SELECT id FROM dim WHERE grp = 2)")
    else:
        join = "JOIN" if how == "inner" else "LEFT JOIN"
        q = (f"SELECT name, count(*), sum(amount), count(w) FROM fact "
             f"{join} dim ON dim_id = id GROUP BY name ORDER BY name")
    pair.device(q)
    pair.sql("DELETE FROM dim WHERE id % 4 = 0")
    pair.sql("PUT INTO dim VALUES (31, 'n9', 0.5, 2), (32, 'n9', 0.5, 2)")
    pair.device(q)


def test_ctas_and_insert_select_into_a_row_table(pair):
    # NULL-free source rows: the reference's CTAS into a row table stores
    # a NULL as 0 (ROADMAP C, faults of the reference)
    pair.sql("CREATE TABLE dim2 USING row AS SELECT id, name, w FROM dim "
             "WHERE grp = 2 AND w IS NOT NULL")
    pair.device("SELECT * FROM dim2 ORDER BY id")
    pair.sql("INSERT INTO dim2 SELECT id + 100, name, w FROM dim "
             "WHERE grp = 1")
    pair.device("SELECT count(*), sum(w) FROM dim2")


def test_alter_add_and_drop_column(pair):
    pair.sql("ALTER TABLE dim ADD COLUMN extra DOUBLE")
    pair.sql("UPDATE dim SET extra = w + 1 WHERE grp = 0")
    pair.device("SELECT count(extra), sum(extra) FROM dim")
    pair.sql("ALTER TABLE dim DROP COLUMN name")
    pair.device("SELECT * FROM dim ORDER BY id")
    for s in (pair.port, pair.ref):
        with policy(pair.policy), pytest.raises(ValueError,
                                                match="primary key"):
            s.sql("ALTER TABLE dim DROP COLUMN id")


def test_truncate_and_show_tables(pair):
    pair.sql("TRUNCATE TABLE dim")
    pair.device("SELECT count(*) FROM dim")
    port, ref = pair.sql("SHOW TABLES")
    assert port == ref


@pytest.mark.parametrize("name", POLICIES)
def test_row_table_decimal(name):
    """tests/test_decimal_exact.py::test_row_table_decimal through both
    packages: a row table's DECIMAL sums exactly, and the key lookup
    returns the Decimal."""
    from decimal import Decimal

    p = Pair(name)
    p.sql("CREATE TABLE rt (k INT PRIMARY KEY, v DECIMAL(10,2)) USING row")
    p.sql("INSERT INTO rt VALUES (1, 10.01), (2, 20.02)")
    assert p.device("SELECT sum(v) FROM rt") == [(Decimal("30.03"),)]
    rows, _ = p.run("SELECT v FROM rt WHERE k = 2")
    assert rows == [(Decimal("20.02"),)]
