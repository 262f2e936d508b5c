"""Row-level policies and secondary indexes of the port against the
reference's (ports the nine cases of tests/test_policies_indexes.py).

Every statement runs through the JAX package's session and the port's
(on the CPU): the rows, the routing (`host_fallbacks`) and the point
lane's `point_lookups` must agree, and so must the errors.  The durable
cases reopen each package's own directory, and the port also recovers
the directory the reference wrote (the catalog's `aux_ddl` keys
`policy:` / `index:` are the reference's).
"""

import pytest

from torch_parity import Pair

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu_torch import SnappySession
from snappydata_tpu_torch.catalog import Catalog

ROUTED = ("host_fallbacks", "point_lookups")


@pytest.fixture()
def p():
    pair = Pair("f64", routed=ROUTED)
    yield pair
    pair.port.stop()
    pair.ref.stop()


def _errors(pair, q):
    """The exception class names of `q` in (port, reference)."""
    out = []
    for s in (pair.port, pair.ref):
        try:
            s.sql(q)
            out.append(None)
        except Exception as e:   # noqa: BLE001 - the class is compared
            out.append(type(e).__name__)
    return out


def test_policy_filters_scans(p):
    p.sql("CREATE TABLE accounts (id INT, region STRING, bal DOUBLE) "
          "USING column")
    p.sql("INSERT INTO accounts VALUES (1, 'us', 10.0), (2, 'eu', 20.0), "
          "(3, 'us', 30.0)")
    assert p.run("SELECT count(*) FROM accounts")[0] == [(3,)]
    p.sql("CREATE POLICY us_only ON accounts USING region = 'us'")
    assert p.run("SELECT count(*) FROM accounts")[0] == [(2,)]
    assert p.run("SELECT sum(bal) FROM accounts")[0] == [(40.0,)]
    # through joins and aliases too
    p.sql("CREATE TABLE regions (r STRING) USING column")
    p.sql("INSERT INTO regions VALUES ('us'), ('eu')")
    assert p.run("SELECT count(*) FROM accounts a JOIN regions g "
                 "ON a.region = g.r")[0] == [(2,)]
    p.sql("DROP POLICY us_only")
    assert p.run("SELECT count(*) FROM accounts")[0] == [(3,)]


def test_policy_composition(p):
    p.sql("CREATE TABLE t (a INT) USING column")
    p.sql("INSERT INTO t VALUES (1), (5), (9)")
    p.sql("CREATE POLICY p1 ON t USING a > 2")
    p.sql("CREATE POLICY p2 ON t USING a < 8")
    assert p.run("SELECT a FROM t")[0] == [(5,)]


def test_secondary_index_point_path(p):
    p.sql("CREATE TABLE users (id INT PRIMARY KEY, email STRING, "
          "org INT) USING row")
    p.sql("INSERT INTO users VALUES (1, 'a@x.com', 10), "
          "(2, 'b@x.com', 10), (3, 'c@y.com', 20)")
    p.sql("CREATE INDEX by_org ON users (org)")
    rows, moved = p.run("SELECT id, email FROM users WHERE org = 10")
    assert sorted(r[0] for r in rows) == [1, 2]
    assert moved["point_lookups"] == 1
    # PK equality also routes through the fast path
    rows, moved = p.run("SELECT email FROM users WHERE id = 3")
    assert rows == [("c@y.com",)] and moved["point_lookups"] == 1
    # the index stays correct across mutations
    p.sql("PUT INTO users VALUES (4, 'd@y.com', 20)")
    p.sql("DELETE FROM users WHERE id = 3")
    assert [r[0] for r in p.run(
        "SELECT id FROM users WHERE org = 20")[0]] == [4]
    p.sql("DROP INDEX by_org")
    rows, moved = p.run("SELECT id FROM users WHERE org = 10")
    assert sorted(r[0] for r in rows) == [1, 2]   # the engine path now
    assert moved["point_lookups"] == 0


def test_index_on_column_table_rejected(p):
    p.sql("CREATE TABLE c (a INT) USING column")
    assert _errors(p, "CREATE INDEX i ON c (a)") == ["ValueError"] * 2
    with pytest.raises(ValueError, match="row tables"):
        p.port.sql("CREATE INDEX i ON c (a)")


def test_policy_applies_through_views(p):
    p.sql("CREATE TABLE t (k INT, region STRING) USING row")
    p.sql("INSERT INTO t VALUES (1, 'east'), (2, 'west')")
    p.sql("CREATE VIEW v AS SELECT * FROM t")
    p.sql("CREATE POLICY p ON t USING region = 'east'")
    assert p.run("SELECT k FROM t")[0] == [(1,)]
    assert p.run("SELECT k FROM v")[0] == [(1,)]   # no view bypass
    p.sql("DROP POLICY p")
    assert len(p.run("SELECT k FROM v")[0]) == 2   # applies at query time


def test_point_path_contradictory_equalities(p):
    p.sql("CREATE TABLE pt (k INT PRIMARY KEY, v STRING) USING row")
    p.sql("INSERT INTO pt VALUES (1, 'a'), (2, 'b')")
    assert p.run("SELECT * FROM pt WHERE k = 1 AND k = 2")[0] == []
    assert p.run("SELECT * FROM pt WHERE k = 1 AND k = 1")[0] == \
        [(1, "a")]


def test_drop_table_cascades_policies_and_indexes(p):
    p.sql("CREATE TABLE dt (a INT, b INT) USING row")
    p.sql("CREATE POLICY dp ON dt USING a < 5")
    p.sql("CREATE INDEX di ON dt (b)")
    p.sql("DROP TABLE dt")
    p.sql("CREATE TABLE dt (c INT) USING column")
    p.sql("INSERT INTO dt VALUES (9)")
    assert p.run("SELECT * FROM dt")[0] == [(9,)]   # no ghost policy
    for s in (p.port, p.ref):
        assert "di" not in getattr(s.catalog, "_indexes", {})
        assert "dp" not in getattr(s.catalog, "_policies", {})


def _write(cls, catalog_cls, d, stmts, **kw):
    s = cls(catalog=catalog_cls(), data_dir=d, recover=False, **kw)
    for q in stmts:
        s.sql(q)
    s.disk_store.close()


COLLISION = ["CREATE TABLE t (a INT, region STRING) USING row",
             "INSERT INTO t VALUES (1, 'east'), (2, 'west')",
             "CREATE POLICY shared ON t USING region = 'east'",
             "CREATE INDEX shared ON t (a)"]
RESTART = ["CREATE TABLE t (a INT, region STRING) USING row",
           "INSERT INTO t VALUES (1, 'us'), (2, 'eu')",
           "CREATE POLICY p ON t USING region = 'us'",
           "CREATE INDEX i ON t (a)"]


@pytest.mark.parametrize("stmts,index", [(COLLISION, "shared"),
                                         (RESTART, "i")],
                         ids=["name_collision", "restart"])
def test_policy_and_index_survive_restart(tmp_path, stmts, index):
    """A policy and an index (the same name for both, or not) persist and
    come back after a restart: the policy still filters and the index
    still answers lookups, in each package's own directory and in the
    port reopening the reference's."""
    dirs = {}
    for name, cls, cat, kw in (
            ("port", SnappySession, Catalog, {"device": "cpu"}),
            ("ref", RefSession, RefCatalog, {})):
        dirs[name] = str(tmp_path / name)
        _write(cls, cat, dirs[name], stmts, **kw)
    got = {}
    for name, d, cls, kw in (
            ("port", dirs["port"], SnappySession, {"device": "cpu"}),
            ("ref", dirs["ref"], RefSession, {}),
            ("port_of_ref", dirs["ref"], SnappySession, {"device": "cpu"})):
        s2 = cls(data_dir=d, **kw)
        assert index in s2.catalog._indexes
        got[name] = (s2.sql("SELECT count(*) FROM t").rows(),
                     s2.sql("SELECT a FROM t WHERE a = 1").rows(),
                     s2.catalog.describe("t").data.index_lookup(
                         index, (2,)))
        s2.disk_store.close()
    assert got["port"] == got["ref"] == got["port_of_ref"]
    assert got["port"][:2] == ([(1,)], [(1,)])
