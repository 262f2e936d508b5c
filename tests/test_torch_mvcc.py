"""MVCC snapshot isolation through both packages.

The cases of tests/test_mvcc.py that need no persistence, materialized
view, resource broker or REST server, each run against the reference
and against the port (on the CPU) with the same statements and the same
expected answers: statement pins, the atomic cross-table cut, row-table
repeatable reads, DDL under a pin (TRUNCATE, ADD COLUMN and DROP TABLE
bump the epoch cleanly; DROP COLUMN raises SQLSTATE 40001), released
pins, the DDL fence on pin admission, and the row-table snapshot and
device caches.  One case is new: a tiled Q6 (the reference's tiny
`scan_tile_bytes`) with an insert published between two tiles must see
one epoch, in the device-merge lane and in the host-merge lane with its
prefetch worker.
"""

import threading

import pytest

import snappydata_tpu
import snappydata_tpu_torch
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.observability.metrics import \
    global_registry as ref_registry
from snappydata_tpu.storage import mvcc as ref_mvcc
from snappydata_tpu_torch import config
from snappydata_tpu_torch import session as port_session
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.storage import mvcc
from snappydata_tpu_torch.utils import tpch


class _Pkg:
    """One package's session factory, mvcc module and metrics."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            self.mvcc, self.reg = ref_mvcc, ref_registry
            self._cls, self._cat = snappydata_tpu.SnappySession, RefCatalog
            self._kw = {}
        else:
            self.mvcc, self.reg = mvcc, global_registry
            self._cls, self._cat = snappydata_tpu_torch.SnappySession, Catalog
            self._kw = {"device": "cpu"}

    def session(self, catalog=None):
        return self._cls(catalog=catalog if catalog is not None
                         else self._cat(), **self._kw)

    def counter(self, name: str) -> int:
        return self.reg().counter(name)


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return _Pkg(request.param)


def _mk(pkg):
    s = pkg.session()
    s.sql("CREATE TABLE t (k INT, v DOUBLE) USING column")
    s.insert("t", (1, 1.0), (2, 2.0), (3, 3.0))
    return s


def _rows(s, sql):
    return [tuple(r) for r in s.sql(sql).rows()]


def test_pinned_reads_isolated_from_concurrent_ingest(pkg):
    s = _mk(pkg)
    with pkg.mvcc.pinned_scope(s.catalog, ["t"]) as pin:
        assert pin is not None and pin.epoch >= 1
        assert _rows(s, "SELECT count(*), sum(v) FROM t") == [(3, 6.0)]
        done = []

        def ingest():
            pkg.session(s.catalog).insert("t", (4, 4.0))
            done.append(True)

        th = threading.Thread(target=ingest)
        th.start()
        th.join(timeout=30)
        assert done, "ingest blocked behind a pinned reader"
        assert _rows(s, "SELECT count(*), sum(v) FROM t") == [(3, 6.0)]
        assert _rows(s, "SELECT sum(v) FROM t WHERE k >= 1") == [(6.0,)]
    assert _rows(s, "SELECT count(*), sum(v) FROM t") == [(4, 10.0)]
    s.stop()


def test_delete_and_update_invisible_to_pinned_reader(pkg):
    s = _mk(pkg)
    with pkg.mvcc.pinned_scope(s.catalog, ["t"]):
        assert _rows(s, "SELECT sum(v) FROM t") == [(6.0,)]
        w = pkg.session(s.catalog)
        w.sql("DELETE FROM t WHERE k = 1")
        w.sql("UPDATE t SET v = 100.0 WHERE k = 2")
        assert _rows(s, "SELECT sum(v) FROM t") == [(6.0,)]
        assert _rows(s, "SELECT v FROM t WHERE k = 2") == [(2.0,)]
    assert _rows(s, "SELECT sum(v) FROM t") == [(103.0,)]
    s.stop()


def test_cross_table_cut_is_atomic(pkg):
    s = _mk(pkg)
    s.sql("CREATE TABLE u (k INT, w DOUBLE) USING column")
    s.insert("u", (1, 10.0), (2, 20.0))
    with pkg.mvcc.pinned_scope(s.catalog, ["t", "u"]):
        w = pkg.session(s.catalog)
        w.insert("t", (9, 9.0))
        w.insert("u", (9, 90.0))
        assert _rows(s, "SELECT count(*) FROM t JOIN u ON t.k = u.k") \
            == [(2,)]
        assert _rows(s, "SELECT count(*) FROM t") == [(3,)]
        assert _rows(s, "SELECT count(*) FROM u") == [(2,)]
    assert _rows(s, "SELECT count(*) FROM t JOIN u ON t.k = u.k") == [(3,)]
    s.stop()


def test_row_table_repeatable_reads_under_pin(pkg):
    s = pkg.session()
    s.sql("CREATE TABLE r (k INT PRIMARY KEY, v DOUBLE) USING row")
    s.insert("r", (1, 1.0), (2, 2.0))
    with pkg.mvcc.pinned_scope(s.catalog, ["r"]):
        assert _rows(s, "SELECT sum(v) FROM r") == [(3.0,)]
        w = pkg.session(s.catalog)
        w.sql("UPDATE r SET v = 50.0 WHERE k = 1")
        w.insert("r", (3, 3.0))
        # the first pinned read captured the host snapshot: repeatable
        assert _rows(s, "SELECT sum(v) FROM r") == [(3.0,)]
    assert _rows(s, "SELECT sum(v) FROM r") == [(55.0,)]
    s.stop()


def test_every_statement_pins_by_default(pkg):
    s = _mk(pkg)
    p0 = pkg.counter("mvcc_pins")
    _rows(s, "SELECT count(*) FROM t")
    assert pkg.counter("mvcc_pins") == p0 + 1
    assert pkg.counter("mvcc_pin_releases") >= 1
    s.conf.set("snapshot_isolation", "false")
    try:
        p1 = pkg.counter("mvcc_pins")
        _rows(s, "SELECT count(*) FROM t")
        assert pkg.counter("mvcc_pins") == p1
    finally:
        s.conf.set("snapshot_isolation", "true")
    s.stop()


def test_truncate_bumps_epoch_cleanly_under_pin(pkg):
    s = _mk(pkg)
    with pkg.mvcc.pinned_scope(s.catalog, ["t"]):
        assert _rows(s, "SELECT count(*) FROM t") == [(3,)]
        pkg.session(s.catalog).sql("TRUNCATE TABLE t")
        assert _rows(s, "SELECT count(*) FROM t") == [(3,)]
    assert _rows(s, "SELECT count(*) FROM t") == [(0,)]
    s.stop()


def test_add_column_and_drop_table_safe_under_pin(pkg):
    s = _mk(pkg)
    info = s.catalog.describe("t")
    with pkg.mvcc.pinned_scope(s.catalog, ["t"]):
        assert _rows(s, "SELECT sum(v) FROM t") == [(6.0,)]
        pkg.session(s.catalog).sql("ALTER TABLE t ADD COLUMN extra DOUBLE")
        assert _rows(s, "SELECT sum(v) FROM t") == [(6.0,)]
        # DROP TABLE: the catalog entry goes, the pinned manifest stays
        pkg.session(s.catalog).sql("DROP TABLE t")
        m = pkg.mvcc.current_pin().manifest_for(info.data)
        assert m.total_rows() == 3
    s.stop()


def test_drop_column_conflict_is_typed_sqlstate_40001(pkg):
    s = _mk(pkg)
    c0 = pkg.counter("mvcc_ddl_conflicts")
    with pkg.mvcc.pinned_scope(s.catalog, ["t"]):
        _rows(s, "SELECT count(*) FROM t")
        with pytest.raises(pkg.mvcc.SnapshotConflictError) as ei:
            s.sql("ALTER TABLE t DROP COLUMN v")
        assert "40001" in str(ei.value)
        assert ei.value.sqlstate == "40001"
    assert pkg.counter("mvcc_ddl_conflicts") == c0 + 1
    # readers drained: the retried DDL succeeds
    s.sql("ALTER TABLE t DROP COLUMN v")
    assert [f.name for f in s.catalog.describe("t").schema.fields] == ["k"]
    s.stop()


def test_released_pin_extension_holds_nothing(pkg):
    s = _mk(pkg)
    data = s.catalog.describe("t").data
    pin = pkg.mvcc.SnapshotPin()
    pin.pin_many([data])
    assert pkg.mvcc.has_pins(data)
    pin.release()
    assert not pkg.mvcc.has_pins(data)
    m = pin.manifest_for(data)
    assert m is data.snapshot()
    assert not pkg.mvcc.has_pins(data)
    pin.release()   # idempotent
    s.sql("ALTER TABLE t DROP COLUMN v")   # no lingering 40001
    s.stop()


def test_ddl_scope_blocks_new_pins_during_remap(pkg):
    s = _mk(pkg)
    data = s.catalog.describe("t").data
    with pkg.mvcc.ddl_scope(data, "ALTER TABLE DROP COLUMN"):
        with pytest.raises(pkg.mvcc.SnapshotConflictError) as ei:
            with pkg.mvcc.pinned_scope(s.catalog, ["t"]):
                pass   # pragma: no cover
        assert ei.value.sqlstate == "40001"
        assert not pkg.mvcc.has_pins(data), "aborted capture leaked refs"
    with pkg.mvcc.pinned_scope(s.catalog, ["t"]):
        assert _rows(s, "SELECT count(*) FROM t") == [(3,)]
    s.stop()


def test_row_snapshot_cache_makes_warm_pinned_binds_cheap(pkg):
    s = pkg.session()
    s.sql("CREATE TABLE rc (k INT PRIMARY KEY, v DOUBLE) USING row")
    s.insert("rc", (1, 1.0), (2, 2.0))
    data = s.catalog.describe("rc").data
    assert _rows(s, "SELECT sum(v) FROM rc") == [(3.0,)]   # warm the cache
    calls = [0]
    orig = data.to_arrays_with_nulls

    def counting():
        calls[0] += 1
        return orig()

    data.to_arrays_with_nulls = counting
    try:
        assert _rows(s, "SELECT sum(v) FROM rc") == [(3.0,)]
        assert _rows(s, "SELECT sum(v) FROM rc") == [(3.0,)]
        assert calls[0] == 0, \
            f"warm pinned binds re-materialized the row table {calls[0]}x"
        s.sql("UPDATE rc SET v = 10.0 WHERE k = 1")
        assert _rows(s, "SELECT sum(v) FROM rc") == [(12.0,)]
        assert calls[0] >= 1
    finally:
        data.to_arrays_with_nulls = orig
    s.stop()


def test_pinned_row_bind_spares_live_device_cache_entry(pkg):
    s = pkg.session()
    s.sql("CREATE TABLE lv (k INT PRIMARY KEY, v DOUBLE) USING row")
    s.insert("lv", (1, 1.0), (2, 2.0))
    data = s.catalog.describe("lv").data

    def unpinned(sql, out):
        # pins are contextvar-scoped: a fresh thread reads live
        out.append(_rows(pkg.session(s.catalog), sql))

    with pkg.mvcc.pinned_scope(s.catalog, ["lv"]):
        assert _rows(s, "SELECT sum(v) FROM lv") == [(3.0,)]
        pkg.session(s.catalog).insert("lv", (3, 4.0))
        got = []
        th = threading.Thread(target=unpinned,
                              args=("SELECT sum(v) FROM lv", got))
        th.start()
        th.join(timeout=60)
        assert got == [[(7.0,)]], got
        live_ver = data.version
        assert any(k[0] == live_ver for k in data._device_cache)
        assert _rows(s, "SELECT sum(v) FROM lv") == [(3.0,)]
        assert any(k[0] == live_ver for k in data._device_cache), \
            "pinned bind evicted the live version's device-cache entry"
    s.stop()


# --- the tiled pass under one epoch ------------------------------------------

@pytest.fixture
def tiny_tiles():
    props = config.global_properties()
    saved = (props.column_batch_rows, props.scan_tile_bytes,
             props.tier_prefetch_depth)
    props.column_batch_rows = 256
    props.scan_tile_bytes = 16384
    yield props
    (props.column_batch_rows, props.scan_tile_bytes,
     props.tier_prefetch_depth) = saved


@pytest.mark.parametrize("lane", ["device_merge", "host_merge"])
def test_tiled_q6_sees_one_epoch_across_an_insert_between_tiles(
        tiny_tiles, monkeypatch, lane):
    """Q6 streams lineitem in tiles; after the first tile another session
    inserts rows that match Q6's filter.  The pass (and, on the host
    lane, its prefetch worker) reads the statement's pinned manifest, so
    the answer equals the pre-insert oracle; the next Q6 sees the
    insert."""
    tiny_tiles.tier_prefetch_depth = 1 if lane == "host_merge" else 0
    s = snappydata_tpu_torch.SnappySession(catalog=Catalog(), device="cpu")
    s.sql(tpch.LINEITEM_DDL)
    li = tpch.gen_lineitem(3000, 5)
    s.insert_arrays("lineitem", list(li.values()))
    extra = tpch.gen_lineitem(600, 9)
    if lane == "host_merge":
        # a merge the device lane cannot align: a derived (generic) key
        q = ("SELECT l_discount * 100 AS d, "
             "sum(l_extendedprice * l_discount) AS r FROM lineitem "
             "WHERE l_quantity < 24 GROUP BY l_discount * 100 ORDER BY d")
    else:
        q = tpch.Q6

    def answer():
        return [tuple(r) for r in s.sql(q).rows()]

    tiny_tiles.scan_tile_bytes = -1
    want = answer()
    tiny_tiles.scan_tile_bytes = 16384
    writer = snappydata_tpu_torch.SnappySession(catalog=s.catalog,
                                                device="cpu")
    calls = [0]
    real = port_session.scan_window

    def window_then_insert(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:   # between the first and the second tile
            writer.insert_arrays("lineitem", list(extra.values()))
        return real(*a, **kw)

    monkeypatch.setattr(port_session, "scan_window", window_then_insert)
    reg = global_registry()
    t0 = reg.counter("scan_tiles")
    m0 = reg.counter("scan_tile_host_merges")
    got = answer()
    assert reg.counter("scan_tiles") - t0 >= 3, "the query did not tile"
    assert reg.counter("scan_tile_host_merges") - m0 == \
        (1 if lane == "host_merge" else 0)
    assert calls[0] >= 3
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-9)
    monkeypatch.setattr(port_session, "scan_window", real)
    tiny_tiles.scan_tile_bytes = -1
    after = answer()
    assert after != want, "the insert was lost"
    s.stop()
