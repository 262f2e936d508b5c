"""Checkpoints, WAL replay and recovery of the port's durable session.

After tests/test_persistence.py, tests/test_durability_regressions.py,
the persistence cases of tests/test_arrays.py and
tests/test_alter_and_maps.py, and tests/test_decimal_exact.py: a durable
port session (`SnappySession(data_dir=..., device="cpu")`) runs a
statement script, then a second session opens the same directory
without closing the first (the crash shape the reference's tests use)
and must answer with every acked row.  Each script also runs through the
reference, and the recovered rows must equal the reference's recovered
rows.

Storage-format parity: a directory written by the reference is recovered
by the port with the reference's rows, and the other way round.
"""

import decimal
import os

import numpy as np
import pytest

from torch_parity import assert_rows_equal

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry

ALL_TYPES_DDL = (
    "CREATE TABLE t (id INT, b BIGINT, x DOUBLE, s STRING, d DATE, "
    "f BOOLEAN, dec DECIMAL(12,2), tags ARRAY<STRING>, v ARRAY<INT>, "
    "m MAP<STRING, DOUBLE>, p STRUCT<name: STRING, w: DOUBLE>) "
    "USING column OPTIONS (column_max_delta_rows '3')")


def _row(i):
    if i % 5 == 4:
        return (f"({i}, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, "
                f"NULL, NULL)")
    return (f"({i}, {i * 1000}, {i}.5, 's{i % 3}', "
            f"{18262 + i % 27}, {str(i % 2 == 0)}, "
            f"{i}.25, array('t{i % 2}', 'u'), array({i}, {i + 1}), "
            f"map('k', {i}.5, 'z{i % 2}', 1.0), "
            f"named_struct('name', 'n{i % 4}', 'w', {i}.75))")


ALL_TYPES_Q = "SELECT * FROM t ORDER BY id"
DEVICE_QS = (
    "SELECT count(*), sum(x), sum(dec), sum(element_at(m, 'k')), "
    "sum(size(v)), sum(element_at(p, 'w')) FROM t",
    "SELECT id, element_at(tags, 1), element_at(p, 'name') FROM t "
    "WHERE array_contains(tags, 't1') ORDER BY id",
    "SELECT s, count(*), sum(b) FROM t GROUP BY s ORDER BY s")


@pytest.fixture(autouse=True)
def no_background_compaction():
    props = (ref_config.global_properties(), config.global_properties())
    saved = [p.compaction_enabled for p in props]
    for p in props:
        p.compaction_enabled = False
    yield
    for p, c in zip(props, saved):
        p.compaction_enabled = c


def _new(pkg, d):
    if pkg == "port":
        return SnappySession(catalog=Catalog(), data_dir=d, recover=False,
                             device="cpu")
    return RefSession(catalog=RefCatalog(), data_dir=d, recover=False)


def _open(pkg, d):
    if pkg == "port":
        return SnappySession(data_dir=d, device="cpu")
    return RefSession(data_dir=d)


def _rows(s, q):
    return [tuple(r) for r in s.sql(q).rows()]


def _all_types_script(s, checkpoint_at):
    s.sql(ALL_TYPES_DDL)
    for i in range(12):
        s.sql("INSERT INTO t VALUES " + _row(i))
        if i == checkpoint_at:
            s.checkpoint()
    s.sql("UPDATE t SET x = x * 2, s = 'upd' WHERE id % 3 = 0")
    s.sql("DELETE FROM t WHERE id = 7")


@pytest.mark.parametrize("checkpoint_at", [-1, 5, 11])
def test_every_column_type_round_trips(tmp_path, checkpoint_at):
    """Checkpoint then WAL tail (or the WAL alone) of every column type,
    with UPDATE and DELETE in the tail; the recovered rows equal the
    writer's and the reference's recovered rows, and the device queries
    over the recovered table stay on the device."""
    out = {}
    for pkg in ("port", "ref"):
        d = str(tmp_path / pkg)
        s = _new(pkg, d)
        _all_types_script(s, checkpoint_at)
        before = _rows(s, ALL_TYPES_Q)
        s2 = _open(pkg, d)                 # crash shape: s stays open
        after = _rows(s2, ALL_TYPES_Q)
        assert after == before
        reg = global_registry() if pkg == "port" else ref_registry()
        fb = reg.counter("host_fallbacks")
        out[pkg] = (after, [_rows(s2, q) for q in DEVICE_QS])
        assert reg.counter("host_fallbacks") == fb, pkg
        s.disk_store.close()
        s2.disk_store.close()
    assert out["port"][0] == out["ref"][0]
    for got, want in zip(out["port"][1], out["ref"][1]):
        assert_rows_equal(got, want, 1e-9)


def test_row_tables_and_programmatic_dml(tmp_path):
    d = str(tmp_path)
    s = _new("port", d)
    s.sql("CREATE TABLE kv (k INT PRIMARY KEY, v STRING, w DOUBLE) "
          "USING row")
    s.insert("kv", (1, "a", 1.0), (2, "b", None))
    s.checkpoint()
    s.put("kv", (2, "B", 2.0), (3, "c", None))
    s.update("kv", "k = 1", {"v": "A"})
    s.delete("kv", "k = 3")
    s.sql("ALTER TABLE kv ADD COLUMN z INT")
    s.sql("INSERT INTO kv VALUES (4, 'd', 4.0, 7)")
    want = _rows(s, "SELECT * FROM kv ORDER BY k")
    s2 = _open("port", d)
    assert _rows(s2, "SELECT * FROM kv ORDER BY k") == want == [
        (1, "A", 1.0, None), (2, "B", 2.0, None), (4, "d", 4.0, 7)]
    assert s2.get("kv", (2,)) == (2, "B", 2.0, None)


def test_bulk_paths_are_journaled(tmp_path):
    d = str(tmp_path)
    s = _new("port", d)
    s.sql("CREATE TABLE c (k BIGINT, v DOUBLE, tags ARRAY<STRING>) "
          "USING column OPTIONS (column_batch_rows '64', "
          "column_max_delta_rows '16', key_columns 'k')")
    n = 200
    tags = np.empty(n, dtype=object)
    for i in range(n):
        tags[i] = [f"g{i % 4}"] * (i % 3)
    s.insert_arrays("c", [np.arange(n, dtype=np.int64),
                          np.arange(n) * 0.5, tags])
    s.insert("c", (1000, 1.5, ["x"]), (1001, None, None))
    s.put_arrays("c", [np.array([5, 2000], dtype=np.int64),
                       np.array([99.0, 7.0]), np.array([["p"], []],
                                                      dtype=object)])
    s.delete_keys("c", ["k"], [np.array([6, 7], dtype=np.int64)])
    q = ("SELECT count(*), sum(v), sum(size(tags)), "
         "sum(CASE WHEN array_contains(tags, 'g1') THEN 1 ELSE 0 END) "
         "FROM c")
    want = _rows(s, q)
    s2 = _open("port", d)
    assert _rows(s2, q) == want
    assert _rows(s2, "SELECT v FROM c WHERE k = 5") == [(99.0,)]
    assert _rows(s2, "SELECT count(*) FROM c WHERE k IN (6, 7)") == [(0,)]


def test_alter_across_checkpoint_and_tail(tmp_path):
    d = str(tmp_path)
    s = _new("port", d)
    s.sql("CREATE TABLE t (id INT, x DOUBLE) USING column "
          "OPTIONS (column_max_delta_rows '2')")
    for i in range(5):
        s.sql(f"INSERT INTO t VALUES ({i}, {i * 1.0})")
    s.sql("ALTER TABLE t ADD COLUMN tag STRING")
    s.sql("INSERT INTO t VALUES (5, 5.0, 'z')")
    s.checkpoint()
    s.sql("ALTER TABLE t DROP COLUMN x")
    s.sql("ALTER TABLE t ADD COLUMN m MAP<STRING, INT>")
    s.sql("INSERT INTO t VALUES (6, 'w', map('k', 3))")
    s.disk_store.close()
    s2 = _open("port", d)
    assert s2.sql("DESCRIBE t").rows() == [
        ("id", "int", True), ("tag", "string", True),
        ("m", "map<string,int>", True)]
    rows = _rows(s2, "SELECT id, tag, element_at(m, 'k') FROM t "
                     "ORDER BY id")
    assert rows[5:] == [(5, "z", None), (6, "w", 3)]
    assert all(r[1] is None for r in rows[:5])


def test_drop_recreate_ctas_and_cross_table_order(tmp_path):
    d = str(tmp_path)
    s = _new("port", d)
    s.sql("CREATE TABLE t (a INT) USING column")
    s.sql("INSERT INTO t VALUES (1), (2)")
    s.checkpoint()
    s.sql("DROP TABLE t")
    s.sql("CREATE TABLE t (a INT, b STRING) USING column")
    s.sql("INSERT INTO t VALUES (9, 'new')")
    s.sql("CREATE TABLE b (x INT) USING column")
    s.sql("INSERT INTO b VALUES (1), (2)")
    s.sql("CREATE TABLE a USING column AS SELECT x FROM b")
    s.sql("INSERT INTO b VALUES (3)")
    s.sql("INSERT INTO a SELECT x FROM b WHERE x = 3")
    s.disk_store.close()
    s2 = _open("port", d)
    assert _rows(s2, "SELECT a, b FROM t") == [(9, "new")]
    assert _rows(s2, "SELECT x FROM a ORDER BY x") == [(1,), (2,), (3,)]


def test_checkpoint_crash_before_rotation_no_double_apply(tmp_path,
                                                          monkeypatch):
    import snappydata_tpu_torch.storage.persistence as P

    d = str(tmp_path)
    s = _new("port", d)
    s.sql("CREATE TABLE t (k INT) USING column")
    s.sql("INSERT INTO t VALUES (1), (2)")
    monkeypatch.setattr(P.DiskStore, "_rotate_wal",
                        lambda self, folded: None)
    s.checkpoint()
    monkeypatch.undo()
    assert os.path.getsize(os.path.join(d, "wal.log")) > 0
    s.disk_store.close()
    assert _rows(_open("port", d), "SELECT count(*) FROM t") == [(2,)]


def test_commit_seq_stamps_manifests(tmp_path):
    """The WAL seq of the committing statement is the manifest's commit
    timestamp, and recovery resumes the epoch clock past the fence."""
    from snappydata_tpu_torch.storage import mvcc

    d = str(tmp_path)
    s = _new("port", d)
    s.sql("CREATE TABLE t (k INT) USING column")
    s.sql("INSERT INTO t VALUES (1)")
    data = s.catalog.describe("t").data
    assert data.snapshot().wal_seq == s.disk_store.current_wal_seq() == 1
    s.sql("INSERT INTO t VALUES (2)")
    assert data.snapshot().wal_seq == 2
    s.checkpoint()
    s2 = _open("port", d)
    m = s2.catalog.describe("t").data.snapshot()
    assert m.wal_seq == 2
    assert mvcc.current_epoch() >= 2


@pytest.mark.parametrize("kind", ["array", "numpy_cells", "string_array",
                                  "map", "struct"])
def test_complex_columns_survive_recovery(tmp_path, kind):
    """The persistence cases of tests/test_arrays.py and
    tests/test_alter_and_maps.py: after recovery the complex plates bind
    again and size / element_at / array_contains stay on the device."""
    d = str(tmp_path)
    s = _new("port", d)
    if kind == "array":
        s.sql("CREATE TABLE t (id INT, v ARRAY<INT>) USING column")
        s.sql("INSERT INTO t VALUES (1, array(1, 2)), (2, NULL)")
        s.checkpoint()
        s.sql("INSERT INTO t VALUES (3, array(9))")
        q, want = "SELECT id, v FROM t ORDER BY id", \
            [(1, [1, 2]), (2, None), (3, [9])]
        dq, dwant = "SELECT sum(element_at(v, 1)), sum(size(v)) FROM t", \
            [(10, 3)]
    elif kind == "numpy_cells":
        s.sql("CREATE TABLE t (id INT, v ARRAY<INT>) USING column")
        s.insert("t", (1, np.array([1, 2])), (2, np.array([3, 4])))
        q, want = "SELECT id, v FROM t ORDER BY id", \
            [(1, [1, 2]), (2, [3, 4])]
        dq, dwant = "SELECT count(*) FROM t WHERE array_contains(v, 4)", \
            [(1,)]
    elif kind == "string_array":
        s.sql("CREATE TABLE t (id INT, tags ARRAY<STRING>) USING column")
        s.sql("INSERT INTO t VALUES (1, array('x', 'y')), (2, array('y'))")
        s.checkpoint()
        s.stop()
        q, want = ("SELECT id, size(tags), element_at(tags, 1) FROM t "
                   "ORDER BY id"), [(1, 2, "x"), (2, 1, "y")]
        dq, dwant = ("SELECT count(*) FROM t WHERE "
                     "array_contains(tags, 'y')"), [(2,)]
    elif kind == "map":
        s.sql("CREATE TABLE t (id INT, m MAP<STRING, INT>) USING column "
              "OPTIONS (column_max_delta_rows '2')")
        for i in range(5):
            s.sql(f"INSERT INTO t VALUES ({i}, map('k', {i * 10}))")
        s.checkpoint()
        s.sql("INSERT INTO t VALUES (5, NULL)")
        q, want = "SELECT id, element_at(m, 'k') FROM t ORDER BY id", \
            [(0, 0), (1, 10), (2, 20), (3, 30), (4, 40), (5, None)]
        dq, dwant = "SELECT sum(element_at(m, 'k')) FROM t", [(100,)]
    else:
        s.sql("CREATE TABLE t (id INT, p STRUCT<name: STRING, x: DOUBLE, "
              "price: DECIMAL(10,2)>) USING column")
        s.sql("INSERT INTO t VALUES "
              "(1, named_struct('name', 'a', 'x', 1.5, 'price', 1.50)), "
              "(2, named_struct('name', 'b', 'x', 2.5, 'price', 2.25))")
        s.checkpoint()
        s.stop()
        q, want = "SELECT element_at(p, 'name') FROM t ORDER BY id", \
            [("a",), ("b",)]
        dq = "SELECT sum(element_at(p, 'x')), sum(element_at(p, 'price')) " \
             "FROM t"
        dwant = [(4.0, decimal.Decimal("3.75"))]
    s.disk_store.close()
    s2 = _open("port", d)
    assert _rows(s2, q) == want
    fb = global_registry().counter("host_fallbacks")
    assert _rows(s2, dq) == dwant
    assert global_registry().counter("host_fallbacks") == fb


def _parity_script(s):
    s.sql("CREATE TABLE c (id BIGINT, x DOUBLE, s STRING, "
          "dec DECIMAL(10,2), tags ARRAY<STRING>, m MAP<STRING, INT>, "
          "p STRUCT<a: INT, l: STRING>) USING column "
          "OPTIONS (column_batch_rows '8', column_max_delta_rows '4')")
    s.sql("CREATE TABLE r (k INT PRIMARY KEY, v STRING) USING row")
    for i in range(20):
        s.sql(f"INSERT INTO c VALUES ({i}, {i}.5, 's{i % 3}', {i}.10, "
              f"array('a{i % 2}', 'b'), map('k', {i}), "
              f"named_struct('a', {i}, 'l', 'L{i % 2}'))")
    s.sql("INSERT INTO r VALUES (1, 'one'), (2, NULL)")
    s.checkpoint()
    s.sql("UPDATE c SET x = -1.0 WHERE id < 3")
    s.sql("DELETE FROM c WHERE id = 10")
    s.insert_arrays("c", [np.array([100, 101], dtype=np.int64),
                          np.array([1.0, 2.0]),
                          np.array(["q", "r"], dtype=object),
                          np.array([3.3, 4.4]),
                          np.array([["z"], []], dtype=object),
                          np.array([{"k": 5}, {}], dtype=object),
                          np.array([{"a": 7, "l": "L9"}, None],
                                   dtype=object)])
    s.put("r", (2, "two"), (3, "three"))


PARITY_QS = ("SELECT * FROM c ORDER BY id", "SELECT * FROM r ORDER BY k",
             "SELECT count(*), sum(x), sum(dec), sum(element_at(m, 'k')), "
             "sum(element_at(p, 'a')) FROM c "
             "WHERE array_contains(tags, 'b') OR size(tags) = 1")


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_storage_format_parity(tmp_path, writer):
    """A data directory written by one package recovers in the other with
    the writer's rows: checkpointed batch files, manifests with deltas
    and delete masks, row-table snapshots and the WAL tail."""
    reader = "port" if writer == "ref" else "ref"
    d = str(tmp_path)
    w = _new(writer, d)
    _parity_script(w)
    want = [_rows(w, q) for q in PARITY_QS]
    w.disk_store.close()
    r = _open(reader, d)
    got = [_rows(r, q) for q in PARITY_QS]
    for g, x in zip(got, want):
        assert_rows_equal(g, x, 1e-9)
    # the reader appends and checkpoints; the writer's package reads on
    r.sql("INSERT INTO c VALUES (200, 0.5, 'new', 0.01, array('b'), "
          "map('k', 1), named_struct('a', 1, 'l', 'x'))")
    r.checkpoint()
    want2 = [_rows(r, q) for q in PARITY_QS]
    r.disk_store.close()
    back = _open(writer, d)
    for g, x in zip([_rows(back, q) for q in PARITY_QS], want2):
        assert_rows_equal(g, x, 1e-9)
    back.disk_store.close()


def test_unported_catalog_state_raises(tmp_path):
    """A directory recording auxiliary catalog state of a kind the port
    does not know cannot be recovered, and says so instead of skipping
    it.  Stream tables re-register (tests/test_torch_streaming.py);
    views, materialized views and functions recover
    (tests/test_torch_matviews.py), policies and indexes
    (tests/test_torch_policies_indexes.py), grants
    (tests/test_torch_security.py) and deployed code
    (tests/test_torch_deploy.py)."""
    import json

    d = str(tmp_path)
    s = RefSession(catalog=RefCatalog(), data_dir=d, recover=False)
    s.sql("CREATE TABLE t (a INT) USING column")
    s.sql("CREATE VIEW v AS SELECT a FROM t")
    s.sql("CREATE POLICY p1 ON t USING a > 2")
    s.sql("GRANT SELECT ON t TO u1")
    s.disk_store.close()
    # an auxiliary key of a kind neither package writes
    path = os.path.join(d, "catalog.json")
    with open(path) as fh:
        meta = json.load(fh)
    meta["aux_ddl"]["unknown:k"] = "CREATE TABLE k (id BIGINT) USING column"
    with open(path, "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(NotImplementedError, match="unknown:k"):
        SnappySession(data_dir=d, device="cpu")
