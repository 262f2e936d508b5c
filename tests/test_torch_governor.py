"""The port's resource governor (snappydata_tpu_torch/resource/): the
unified ledger, admission (admit / queue / reject with LowMemoryException,
SQLSTATE XCL54), graceful degradation, and cooperative cancellation
(cancel / statement timeout, SQLSTATE XCL52) stopping a tiled scan at a
tile boundary.  Case by case the reference's tests/test_resource_governor.py
on `SnappySession(device="cpu")`; the REST case waits for the front door
and is covered through `broker.queries()` / `cancel()` directly.  Parity:
`estimate_statement_bytes` and the ledger's host bytes per table equal
the reference's on the same seeded inputs (exact integers).
"""

import contextlib
import threading
import time

import numpy as np
import pytest

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu import config as ref_config
from snappydata_tpu import resource as ref_resource
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.sql.parser import parse as ref_parse

from snappydata_tpu_torch import SnappySession, config, resource
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.sql.parser import parse


@pytest.fixture()
def props():
    """Governor knobs live on the GLOBAL properties (the broker is
    process-wide): restore everything this file touches."""
    p = config.global_properties()
    saved = (p.memory_limit_bytes, p.admission_queue_depth,
             p.admission_wait_s, p.admission_slots_per_user,
             p.query_timeout_s, p.scan_tile_bytes, p.compaction_enabled)
    # the broker-kicked compactor would rewrite batches between queries
    p.compaction_enabled = False
    yield p
    (p.memory_limit_bytes, p.admission_queue_depth, p.admission_wait_s,
     p.admission_slots_per_user, p.query_timeout_s,
     p.scan_tile_bytes, p.compaction_enabled) = saved


@pytest.fixture()
def session(props):
    s = SnappySession(catalog=Catalog(), device="cpu")
    yield s
    s.stop()


def _tiled_table(session, name="rg_t", batches=8, cap=64):
    """A column table cut into `batches` batches plus a tiny tile budget,
    so aggregates stream tile by tile (each tile = one cancel point)."""
    session.sql(f"CREATE TABLE {name} (v DOUBLE) USING column OPTIONS "
                f"(column_batch_rows '{cap}', "
                f"column_max_delta_rows '{cap}')")
    n = batches * cap
    session.insert_arrays(name, [np.arange(n, dtype=np.float64)])
    # one unit per tile: unit_bytes = cap (mask) + cap*(8+1) (v column)
    session.conf.scan_tile_bytes = cap * 10 + 1
    return float(np.arange(n, dtype=np.float64).sum())


@contextlib.contextmanager
def _slow_tiles(monkeypatch, delay_s=0.05):
    """Make every scan tile take >= delay_s so signals land mid-scan."""
    import snappydata_tpu_torch.session as session_mod

    orig = session_mod.scan_window

    @contextlib.contextmanager
    def slow_window(data, lo, hi, manifest=None, **kw):
        time.sleep(delay_s)
        with orig(data, lo, hi, manifest, **kw):
            yield

    monkeypatch.setattr(session_mod, "scan_window", slow_window)
    yield


# ---------------------------------------------------------------------
# admission: admit / reject / queue / fair slots
# ---------------------------------------------------------------------

def test_estimate_scales_with_rows(session):
    session.sql("CREATE TABLE est_t (a BIGINT, s STRING) USING column")
    stmt = parse("SELECT count(*) FROM est_t")
    assert resource.estimate_statement_bytes(session.catalog, stmt) == 0
    session.insert_arrays("est_t", [
        np.arange(100, dtype=np.int64),
        np.array(["x"] * 100, dtype=object)])
    e100 = resource.estimate_statement_bytes(session.catalog, stmt)
    # 100 rows x (8 int64 + 4 code + 2 validity) = 1400
    assert e100 == 100 * 14
    session.insert_arrays("est_t", [
        np.arange(100, dtype=np.int64),
        np.array(["x"] * 100, dtype=object)])
    assert resource.estimate_statement_bytes(session.catalog, stmt) \
        == 2 * e100


def test_oversize_query_rejected_with_sqlstate(session, props):
    session.sql("CREATE TABLE rej_t (v DOUBLE) USING column")
    session.insert_arrays("rej_t", [np.ones(1000)])
    props.memory_limit_bytes = 64          # deliberately tiny
    before = global_registry().counter("governor_rejected")
    with pytest.raises(resource.LowMemoryException) as ei:
        session.sql("SELECT sum(v) FROM rej_t")
    assert "XCL54" in str(ei.value)
    assert global_registry().counter("governor_rejected") == before + 1
    # reads that fit still run: the governor rejects work, not the node
    props.memory_limit_bytes = 10 ** 9
    assert session.sql("SELECT sum(v) FROM rej_t").rows()[0][0] == 1000.0


def test_queue_full_rejects(props):
    props.memory_limit_bytes = 1000
    props.admission_queue_depth = 0
    broker = resource.global_broker()
    blocker = resource.new_query("blocker", "admin")
    broker.admit(blocker, estimate_bytes=900)
    try:
        with pytest.raises(resource.LowMemoryException) as ei:
            broker.admit(resource.new_query("q2", "admin"),
                         estimate_bytes=500)
        assert "queue full" in str(ei.value)
    finally:
        broker.release(blocker)


def test_queued_query_runs_after_blocker_finishes(props):
    props.memory_limit_bytes = 1000
    props.admission_queue_depth = 4
    props.admission_wait_s = 10.0
    broker = resource.global_broker()
    blocker = resource.new_query("blocker", "admin")
    broker.admit(blocker, estimate_bytes=800)
    queued_before = global_registry().counter("governor_queued")
    done = []

    def second():
        ctx = resource.new_query("q2", "admin")
        broker.admit(ctx, estimate_bytes=500)
        done.append(ctx)
        broker.release(ctx)

    t = threading.Thread(target=second, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while global_registry().counter("governor_queued") == queued_before \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert global_registry().counter("governor_queued") == queued_before + 1
    assert not done                      # still blocked
    assert any(q["state"] == "queued" for q in broker.queries())
    broker.release(blocker)              # blocker finishes ...
    t.join(5)
    assert done and done[0].state == "finished"   # ... queued query ran


def test_admission_wait_timeout_rejects(props):
    props.memory_limit_bytes = 1000
    props.admission_queue_depth = 4
    props.admission_wait_s = 0.2
    broker = resource.global_broker()
    blocker = resource.new_query("blocker", "admin")
    broker.admit(blocker, estimate_bytes=1000)
    try:
        with pytest.raises(resource.LowMemoryException) as ei:
            broker.admit(resource.new_query("q2", "admin"),
                         estimate_bytes=500)
        assert "XCL54" in str(ei.value)
    finally:
        broker.release(blocker)


def test_statement_timeout_covers_queue_time(props):
    """query_timeout_s starts at SUBMISSION: a query that times out while
    queued is a CancelException XCL52, not a memory rejection, and the
    deadline is not re-armed at admission."""
    props.memory_limit_bytes = 1000
    props.admission_queue_depth = 4
    props.admission_wait_s = 30.0
    broker = resource.global_broker()
    blocker = resource.new_query("blocker", "admin")
    broker.admit(blocker, estimate_bytes=1000)
    timeouts_before = global_registry().counter("governor_timeouts")
    try:
        with pytest.raises(resource.CancelException) as ei:
            broker.admit(resource.new_query("q2", "admin"),
                         estimate_bytes=500, timeout_s=0.15)
        assert "XCL52" in str(ei.value)
        assert global_registry().counter("governor_timeouts") \
            == timeouts_before + 1
        q3 = resource.new_query("q3", "admin")
        broker.release(blocker)
        t0 = time.monotonic()
        broker.admit(q3, estimate_bytes=100, timeout_s=5.0)
        try:
            assert q3.deadline is not None
            assert q3.deadline - t0 <= 5.0 + 1.0
        finally:
            broker.release(q3)
    finally:
        broker.release(blocker)


def test_fair_slot_head_does_not_starve_other_users(props):
    """A queue head blocked only by its principal's fair slot must not
    block another user's admissible query (head of line)."""
    props.memory_limit_bytes = 10 ** 9
    props.admission_slots_per_user = 1
    props.admission_wait_s = 10.0
    broker = resource.global_broker()
    a1 = resource.new_query("a1", "alice")
    broker.admit(a1, estimate_bytes=10)
    blocked = []

    def alices_second():
        a2 = resource.new_query("a2", "alice")
        broker.admit(a2, estimate_bytes=10)    # slot-blocked: queues
        blocked.append(a2)
        broker.release(a2)

    t = threading.Thread(target=alices_second, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while not any(q["state"] == "queued" for q in broker.queries()) \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    b1 = resource.new_query("b1", "bob")
    broker.admit(b1, estimate_bytes=10, timeout_s=2.0)
    assert b1.state == "running"
    broker.release(b1)
    assert not blocked                          # alice's a2 still waits
    broker.release(a1)
    t.join(5)
    assert blocked


def test_watched_job_cancellable_before_admission(props):
    """A context watched at submission is visible and cancellable before
    admission; a cancel landing before admit() makes admit raise."""
    broker = resource.global_broker()
    ctx = broker.watch(resource.new_query("pending job", "admin"))
    try:
        assert any(q["id"] == ctx.query_id for q in broker.queries())
        assert broker.cancel(ctx.query_id, "cancelled pre-admission")
        with pytest.raises(resource.CancelException):
            broker.admit(ctx, estimate_bytes=0)
    finally:
        broker.release(ctx)
    assert all(q["id"] != ctx.query_id for q in broker.queries())


def test_row_tables_visible_to_ledger_and_estimate(session):
    session.sql("CREATE TABLE rg_row (k BIGINT PRIMARY KEY, v DOUBLE) "
                "USING row")
    session.insert_arrays("rg_row", [np.arange(500, dtype=np.int64),
                                     np.ones(500)])
    stmt = parse("SELECT sum(v) FROM rg_row")
    # 500 rows x (8+1 + 8+1) decoded width
    assert resource.estimate_statement_bytes(session.catalog, stmt) \
        == 500 * 18
    led = resource.global_broker().ledger()
    assert led["host"].get("rg_row", 0) == 500 * 18


def test_per_principal_fair_slots(props):
    props.memory_limit_bytes = 10 ** 9
    props.admission_slots_per_user = 1
    props.admission_wait_s = 10.0
    broker = resource.global_broker()
    q1 = resource.new_query("q1", "alice")
    broker.admit(q1, estimate_bytes=10)
    got = []

    def second():
        q2 = resource.new_query("q2", "alice")
        broker.admit(q2, estimate_bytes=10)
        got.append(q2)
        broker.release(q2)

    t = threading.Thread(target=second, daemon=True)
    t.start()
    time.sleep(0.15)
    assert not got                       # alice's second query waits
    q3 = resource.new_query("q3", "bob")
    broker.release(q1)
    t.join(5)
    assert got
    broker.admit(q3, estimate_bytes=10)
    broker.release(q3)


# ---------------------------------------------------------------------
# cooperative cancellation: cancel / timeout, mid-scan
# ---------------------------------------------------------------------

def test_cancel_stops_scan_at_tile_boundary(session, props, monkeypatch):
    total_tiles = 8
    _tiled_table(session, "rg_c", batches=total_tiles)
    broker = resource.global_broker()
    errs = []
    t0 = global_registry().counter("scan_tiles")

    def run():
        try:
            session.sql("SELECT sum(v) FROM rg_c")
            errs.append(None)
        except Exception as e:          # noqa: BLE001
            errs.append(e)

    with _slow_tiles(monkeypatch, 0.05):
        th = threading.Thread(target=run, daemon=True)
        th.start()
        qid = None
        deadline = time.monotonic() + 5
        while qid is None and time.monotonic() < deadline:
            live = [q for q in broker.queries() if "rg_c" in q["sql"]]
            if live:
                qid = live[0]["id"]
            else:
                time.sleep(0.005)
        assert qid is not None
        cancelled_before = global_registry().counter("governor_cancelled")
        assert broker.cancel(qid, "cancelled by test")
        th.join(10)
    assert isinstance(errs[0], resource.CancelException)
    assert "XCL52" in str(errs[0])
    # stopped at a tile boundary, not after scanning everything
    assert global_registry().counter("scan_tiles") - t0 < total_tiles
    assert global_registry().counter("governor_cancelled") \
        == cancelled_before + 1
    assert all(q["id"] != qid for q in broker.queries())  # deregistered
    # the pass left nothing behind: no tile flag, no statement pin, no
    # live prefetch window, and the next query answers
    data = session.catalog.describe("rg_c").data
    from snappydata_tpu_torch.storage import mvcc, prefetch

    assert not session._in_tile
    assert not mvcc.has_pins(data)
    assert not prefetch.keep_windows(data)
    assert session.sql("SELECT count(*) FROM rg_c").rows()[0][0] \
        == total_tiles * 64


def test_statement_timeout_cancels_mid_scan(session, props, monkeypatch):
    total_tiles = 8
    _tiled_table(session, "rg_to", batches=total_tiles)
    session.conf.query_timeout_s = 0.12   # ~2 tiles at 0.05s/tile
    t0 = global_registry().counter("scan_tiles")
    timeouts_before = global_registry().counter("governor_timeouts")
    with _slow_tiles(monkeypatch, 0.05):
        with pytest.raises(resource.CancelException) as ei:
            session.sql("SELECT sum(v) FROM rg_to")
    assert "XCL52" in str(ei.value)
    assert global_registry().counter("scan_tiles") - t0 < total_tiles
    assert global_registry().counter("governor_timeouts") \
        == timeouts_before + 1
    # and with the timeout off the same query completes
    session.conf.query_timeout_s = 0.0
    assert session.sql("SELECT count(*) FROM rg_to").rows()[0][0] == 8 * 64


def test_set_knobs_via_sql(session, props):
    session.sql("SET snappydata.query_timeout_s = 2.5")
    assert session.conf.query_timeout_s == 2.5
    session.sql("SET snappydata.memory_limit_bytes = 1048576")
    assert props.memory_limit_bytes == 1048576
    props.memory_limit_bytes = 0
    session.conf.query_timeout_s = 0.0


# ---------------------------------------------------------------------
# ledger + degradation
# ---------------------------------------------------------------------

def test_ledger_unifies_host_and_device_bytes(session):
    session.sql("CREATE TABLE rg_l (a BIGINT, v DOUBLE) USING column "
                "OPTIONS (column_batch_rows '128', "
                "column_max_delta_rows '128')")
    session.insert_arrays("rg_l", [np.arange(512, dtype=np.int64),
                                   np.ones(512)])
    session.sql("SELECT sum(v) FROM rg_l")   # populates device cache
    led = resource.global_broker().ledger()
    assert led["host"].get("rg_l", 0) > 0          # encoded batches
    assert led["device"].get("rg_l", 0) > 0        # cached plates
    assert led["host_total"] >= led["host"]["rg_l"]
    assert led["device_total"] >= led["device"]["rg_l"]
    assert global_registry().gauges()["governor_host_bytes"] \
        >= led["host"]["rg_l"]


def test_tiled_aggregate_admitted_under_small_limit(session, props):
    """A table whose decoded size exceeds memory_limit_bytes is still
    queryable when scan_tile_bytes streams it: the estimate is one tile,
    not the whole table."""
    exact = _tiled_table(session, "rg_ooc", batches=8, cap=64)
    # full decoded estimate: 512 rows x 9B = 4608 > limit; tile: 641
    props.memory_limit_bytes = 2000
    got = session.sql("SELECT sum(v) FROM rg_ooc").rows()[0][0]
    assert got == exact
    # a NON-tilable query over the same table still rejects
    with pytest.raises(resource.LowMemoryException):
        session.sql("SELECT v FROM rg_ooc ORDER BY v")


def test_dropped_table_leaves_ledger(session):
    session.sql("CREATE TABLE rg_drop (v DOUBLE) USING column")
    session.insert_arrays("rg_drop", [np.ones(100)])
    broker = resource.global_broker()
    assert broker.ledger()["host"].get("rg_drop", 0) > 0
    # a plan-cache entry holds the data object alive past the DROP
    session.sql("SELECT sum(v) FROM rg_drop")
    session.sql("DROP TABLE rg_drop")
    assert "rg_drop" not in broker.ledger()["host"]


def test_row_table_updates_do_not_double_ledger_charge(session):
    session.sql("CREATE TABLE rg_upd (k BIGINT PRIMARY KEY, v DOUBLE) "
                "USING row")
    session.insert_arrays("rg_upd", [np.arange(100, dtype=np.int64),
                                     np.ones(100)])
    before = resource.global_broker().ledger()["host"]["rg_upd"]
    session.sql("UPDATE rg_upd SET v = 2.0")   # tombstones 100 old slots
    after = resource.global_broker().ledger()["host"]["rg_upd"]
    assert after == before                      # live rows, not slots


def test_degradation_order_evict_spill_cancel(session):
    broker = resource.global_broker()
    session.sql("CREATE TABLE rg_d (v DOUBLE) USING column OPTIONS "
                "(column_batch_rows '64', column_max_delta_rows '64')")
    session.insert_arrays("rg_d", [np.ones(256)])
    session.sql("SELECT sum(v) FROM rg_d")       # warm the plan cache
    assert session.executor._plan_cache
    victim = resource.new_query("hungry", "admin")
    broker.admit(victim, estimate_bytes=10 ** 6)
    spilled_before = (global_registry().counter("host_batches_spilled")
                      + global_registry().counter("tier_demotions_host"))
    try:
        # impossible target: the ladder can demote every resident byte
        broker._degrade(-1)
        # 1) plan caches dropped
        assert not session.executor._plan_cache
        # 2) cold batches to disk (the tier's host -> disk rung runs
        # before the spill and usually leaves it nothing to take)
        assert (global_registry().counter("host_batches_spilled")
                + global_registry().counter("tier_demotions_host")) \
            > spilled_before
        # 3) hungriest admitted query cancelled
        assert victim.cancelled
        assert "low memory" in victim.cancel_reason
    finally:
        broker.release(victim)
    # the spilled table still answers queries (memmap reload)
    assert session.sql("SELECT count(*) FROM rg_d").rows()[0][0] == 256


# ---------------------------------------------------------------------
# visibility (the REST front door's /queries waits for its port)
# ---------------------------------------------------------------------

def test_broker_queries_and_cancel(session, props, monkeypatch):
    """What the reference's REST case drives, through the broker: a
    running governed query shows in queries(), cancel() stops it with
    XCL52, an unknown id is refused, and the ledger is served."""
    _tiled_table(session, "rg_r", batches=8)
    broker = resource.global_broker()
    errs = []

    def run():
        try:
            session.sql("SELECT sum(v) FROM rg_r")
            errs.append(None)
        except Exception as e:          # noqa: BLE001
            errs.append(e)

    with _slow_tiles(monkeypatch, 0.05):
        th = threading.Thread(target=run, daemon=True)
        th.start()
        qid = None
        deadline = time.monotonic() + 5
        while qid is None and time.monotonic() < deadline:
            live = [q for q in broker.queries()
                    if "rg_r" in q["sql"] and q["state"] == "running"]
            qid = live[0]["id"] if live else None
            if qid is None:
                time.sleep(0.01)
        assert qid is not None
        assert broker.cancel(qid)
        th.join(10)
    assert isinstance(errs[0], resource.CancelException)
    assert "XCL52" in str(errs[0])
    assert not broker.cancel("nosuchquery")
    led = broker.ledger()
    assert "host" in led and "device" in led


def test_non_query_statements_governed_with_explicit_ctx(session):
    """DML run under a pre-created context is governed too: it finishes
    under it, and a cancel landing before it starts stops it."""
    broker = resource.global_broker()
    session.sql("CREATE TABLE rg_nq (v DOUBLE) USING column")
    session.insert_arrays("rg_nq", [np.ones(10)])
    ctx = broker.watch(resource.new_query("ins", "admin"))
    session.sql("INSERT INTO rg_nq SELECT v FROM rg_nq", query_ctx=ctx)
    assert ctx.state == "finished"
    ctx2 = broker.watch(resource.new_query("ins2", "admin"))
    ctx2.cancel("cancelled pre-admission")
    with pytest.raises(resource.CancelException):
        session.sql("INSERT INTO rg_nq SELECT v FROM rg_nq",
                    query_ctx=ctx2)
    broker.release(ctx2)
    assert session.sql("SELECT count(*) FROM rg_nq").rows()[0][0] == 20


def test_metrics_registry_has_governor_counters(session):
    """The counters and gauges (the prometheus exposition comes with the
    front doors)."""
    session.sql("CREATE TABLE rg_m (v DOUBLE) USING column")
    session.insert_arrays("rg_m", [np.ones(10)])
    before = global_registry().counter("governor_admitted")
    session.sql("SELECT sum(v) FROM rg_m")
    assert global_registry().counter("governor_admitted") == before + 1
    gauges = global_registry().gauges()
    for g in ("governor_inflight_bytes", "governor_active_queries",
              "governor_queued_queries"):
        assert g in gauges


@pytest.mark.slow
def test_endurance_admission_churn(session, props):
    """Sustained admit / queue / release churn from many threads leaks
    no in-flight bytes and deadlocks nobody."""
    props.memory_limit_bytes = 10_000
    props.admission_queue_depth = 64
    props.admission_wait_s = 30.0
    broker = resource.global_broker()
    errors = []

    def worker(i):
        try:
            for _ in range(50):
                ctx = resource.new_query(f"w{i}", f"user{i % 3}")
                broker.admit(ctx, estimate_bytes=3000)
                broker.release(ctx)
        except Exception as e:          # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors
    with broker._cond:
        assert broker._inflight_bytes == 0
        assert not broker._queue


# ---------------------------------------------------------------------
# parity with the reference on the same seeded inputs
# ---------------------------------------------------------------------

_PARITY_QUERIES = (
    "SELECT count(*) FROM pa",
    "SELECT s, sum(v) FROM pa GROUP BY s",
    "SELECT sum(pa.v) FROM pa JOIN pb ON pa.k = pb.k",
    "SELECT v FROM pa WHERE k IN (SELECT k FROM pb)",
)


def _parity_load(sess, rng_seed):
    rng = np.random.default_rng(rng_seed)
    n = 3000
    sess.sql("CREATE TABLE pa (k BIGINT, v DOUBLE, s STRING, d DATE) "
             "USING column OPTIONS (column_batch_rows '512', "
             "column_max_delta_rows '256')")
    sess.sql("CREATE TABLE pb (k BIGINT PRIMARY KEY, w INT) USING row")
    sess.insert_arrays("pa", [
        rng.integers(0, 50, n, dtype=np.int64), rng.normal(0, 1, n),
        rng.choice(np.array(["x", "y", "z"], dtype=object), n),
        rng.integers(9000, 9400, n).astype("datetime64[D]")])
    sess.insert_arrays("pb", [np.arange(40, dtype=np.int64),
                              rng.integers(0, 9, 40).astype(np.int32)])


def test_estimates_and_ledger_host_bytes_equal_the_reference(props):
    """Same seeded inserts through both packages: the admission estimate
    of every query and the ledger's host bytes per table are the same
    integers (the encodings are the reference's, byte for byte)."""
    rp = ref_config.global_properties()
    saved = rp.compaction_enabled
    rp.compaction_enabled = False
    try:
        ref = RefSession(catalog=RefCatalog())
        port = SnappySession(catalog=Catalog(), device="cpu")
        _parity_load(ref, 11)
        _parity_load(port, 11)
        for q in _PARITY_QUERIES:
            assert resource.estimate_statement_bytes(
                port.catalog, parse(q)) == \
                ref_resource.estimate_statement_bytes(
                    ref.catalog, ref_parse(q)), q
        from snappydata_tpu.resource.broker import \
            _host_table_bytes as ref_host_bytes
        from snappydata_tpu_torch.resource.broker import _host_table_bytes

        for name in ("pa", "pb"):
            got = _host_table_bytes(port.catalog.describe(name).data)
            want = ref_host_bytes(ref.catalog.describe(name).data)
            assert got == want > 0, (name, got, want)
        port_led = resource.global_broker().ledger()
        assert set(ref_resource.global_broker().ledger()) \
            == set(port_led), "the ledger keeps the reference's keys"
    finally:
        rp.compaction_enabled = saved


def test_device_ledger_per_device_and_retained_epoch_rows(session):
    """The per-device view of the plate cache sums to the per-table
    ledger, and a pinned reader's epoch shows in the retained-epoch rows
    with its pin, its bytes ledgered until the pin goes."""
    from snappydata_tpu_torch.storage import mvcc
    from snappydata_tpu_torch.storage.device import (
        device_cache_bytes_by_device, device_cache_bytes_by_table)

    session.sql("CREATE TABLE rg_e (v DOUBLE) USING column OPTIONS "
                "(column_batch_rows '64', column_max_delta_rows '64')")
    session.insert_arrays("rg_e", [np.ones(300)])
    session.sql("SELECT sum(v) FROM rg_e")
    data = session.catalog.describe("rg_e").data
    tables = [("rg_e", data)]
    assert device_cache_bytes_by_device(tables) == {
        "cpu": device_cache_bytes_by_table(tables)["rg_e"]}
    with mvcc.pinned_scope(session.catalog, ["rg_e"]) as pin:
        ver = pin.manifest_for(data).version
        session.insert_arrays("rg_e", [np.ones(10)])   # row-buffer tail
        rows = {r["version"]: r for r in mvcc.retained_epochs_of(data)}
        assert rows[ver]["pins"] == 1 and not rows[ver]["current"]
        assert mvcc.retained_epoch_bytes_by_table(tables)["rg_e"] \
            == sum(r["bytes"] for r in rows.values()) > 0
    assert mvcc.trim_unpinned(tables) >= 1
    assert not mvcc.retained_epoch_bytes_by_table(tables)
