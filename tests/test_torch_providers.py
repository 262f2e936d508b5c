"""Fault C9: a `USING` provider other than column, row, sample or a
stream raised NotImplementedError in the port, where the reference makes
a column table under that provider's name
(snappydata_tpu/catalog/catalog.py:80-88), CTAS included.  Each case runs
the same statements through both packages under both plate policies."""

import numpy as np
import pytest

from torch_parity import POLICIES, Pair, assert_rows_equal, REL


def _provider(p, table):
    names = [s.catalog.describe(table).provider for s in (p.port, p.ref)]
    assert names[0] == names[1], names
    return names[0]


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("provider", ["parquet", "PARQUET", "orc", "csv"])
def test_unknown_provider_makes_a_column_table(name, provider):
    p = Pair(name)
    p.sql(f"CREATE TABLE a (x INT, s STRING, v DOUBLE) USING {provider}")
    p.sql("INSERT INTO a VALUES (1, 'p', 0.5), (2, 'q', 1.5), "
          "(3, 'p', NULL)")
    p.insert_arrays("a", [np.arange(4, 1004, dtype=np.int32),
                          np.array(["p", "q", "r", "s"], dtype=object)[
                              np.arange(1000) % 4],
                          np.linspace(0.0, 10.0, 1000)])
    assert _provider(p, "a") == provider.lower()
    assert type(p.port.catalog.describe("a").data).__name__ \
        == "ColumnTableData"
    rows = p.device("SELECT sum(x), count(v), sum(v) FROM a")
    assert rows[0][0] == 6 + sum(range(4, 1004))
    p.device("SELECT s, count(*), sum(v) FROM a GROUP BY s ORDER BY s")
    p.run("SELECT x, s, v FROM a WHERE x <= 5 ORDER BY x")


@pytest.mark.parametrize("name", POLICIES)
def test_ctas_under_an_unknown_provider(name):
    p = Pair(name)
    p.sql("CREATE TABLE b USING jdbc AS SELECT 1 AS x")
    assert _provider(p, "b") == "jdbc"
    assert p.run("SELECT * FROM b")[0] == [(1,)]
    p.sql("CREATE TABLE src (k BIGINT, v DOUBLE) USING column")
    p.insert_arrays("src", [np.arange(500, dtype=np.int64),
                            np.arange(500, dtype=np.float64) / 4])
    p.sql("CREATE TABLE c USING parquet AS SELECT k % 7 AS g, sum(v) AS t "
          "FROM src GROUP BY k % 7")
    assert _provider(p, "c") == "parquet"
    rows = p.run("SELECT g, t FROM c ORDER BY g")[0]
    assert len(rows) == 7
    # the CTAS table takes inserts like any column table
    p.sql("INSERT INTO c VALUES (9, 1.25)")
    got, want = p.sql("SELECT count(*), sum(t) FROM c")
    assert_rows_equal(got, want, REL[name])


@pytest.mark.parametrize("name", POLICIES)
def test_row_provider_stays_a_row_table(name):
    p = Pair(name)
    p.sql("CREATE TABLE r (k INT, v DOUBLE) USING row")
    p.sql("INSERT INTO r VALUES (1, 2.0), (2, 3.0)")
    assert _provider(p, "r") == "row"
    assert p.port.catalog.describe("r").is_row
    p.run("SELECT sum(v) FROM r")
