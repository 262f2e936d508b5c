"""The port's out-of-core tiered storage (snappydata_tpu_torch/storage/
tier.py, hoststore.py, prefetch.py) and its self-healing, case by case the
reference's tests/test_tier.py, tests/test_self_healing.py and
tests/test_outofcore_chaos.py on `SnappySession(device="cpu")`:

* CRC-framed host -> disk demotion round-trips values; a corrupted tier
  record is quarantined and rebuilt from a retained epoch or the durable
  store, else raises the typed TierQuarantinedError;
* the ladder walks HBM -> host -> disk with answers exact; pinned epochs
  are never demoted, by the ladder or the budget's LRU;
* the tile prefetcher warms windows, survives worker deaths, honors its
  knobs; the tier knobs are enforced after a tiled pass;
* memmap EIO gets one bounded re-read, a short write aborts the spill,
  admission pressure kicks the background ladder;
* the HTAP chaos schedule under constricted budgets reads exact values.

Parity with the reference on the same seeded inputs: TPC-H Q1 / Q6 over
demoted, spilled and healed lineitem give the reference's rows (counts,
MIN / MAX and keys exact; sums within ROADMAP's parity bar, rel 1e-9
under float64 plates and 1e-6 under float32), and a tier record framed by
either package passes the other's `_read_tier_record` CRC check with the
same arrays.
"""

import os
import random
import threading
import time

import numpy as np
import pytest

from torch_parity import POLICIES, Pair

from snappydata_tpu.reliability import failpoints as ref_rfail
from snappydata_tpu.storage import hoststore as ref_hoststore
from snappydata_tpu.storage import tier as ref_tier

from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.reliability import failpoints as rfail
from snappydata_tpu_torch.storage import hoststore, mvcc, tier
from snappydata_tpu_torch.utils import tpch

pytestmark = [pytest.mark.outofcore, pytest.mark.faults]

@pytest.fixture
def small_batches():
    props = config.global_properties()
    old = (props.column_batch_rows, props.column_max_delta_rows,
           props.scan_tile_bytes,
           props.tier_device_bytes, props.tier_host_bytes,
           props.tier_prefetch_depth, props.compaction_enabled)
    props.column_batch_rows = 256
    props.column_max_delta_rows = 256  # fold deltas into column batches
    # the broker-kicked compactor would republish manifests mid-test
    props.compaction_enabled = False
    yield props
    (props.column_batch_rows, props.column_max_delta_rows,
     props.scan_tile_bytes,
     props.tier_device_bytes, props.tier_host_bytes,
     props.tier_prefetch_depth, props.compaction_enabled) = old


def _load(sess, n=4000, seed=7):
    rng = np.random.default_rng(seed)
    sess.sql("CREATE TABLE big (k STRING, v DOUBLE, w BIGINT) USING column")
    k = rng.choice(np.array(["a", "b", "c", "d"], dtype=object), n)
    v = rng.normal(100.0, 10.0, n)
    w = rng.integers(0, 1000, n, dtype=np.int64)
    sess.catalog.describe("big").data.insert_arrays([k, v, w])
    return k, v, w


def _c(name):
    return global_registry().counter(name)


# -- disk tier: framed demotion / promotion --------------------------------

def test_framed_demote_promote_roundtrip(small_batches):
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _, v, w = _load(sess, n=1500)
    data = sess.catalog.describe("big").data
    m = data._manifest
    batch = m.views[0].batch
    before = {ci: np.asarray(col.data).copy()
              for ci, col in enumerate(batch.columns)
              if col.data is not None and col.data.dtype != object}
    f0, files0 = _c("tier_demotions_host"), tier.tier_file_bytes()
    freed, nb = tier.demote_batch(batch, "big")
    assert freed > 0
    assert tier.tier_file_bytes() > files0
    assert _c("tier_demotions_host") == f0 + 1
    # the demoted batch reads IDENTICAL values through memmap views
    demoted = 0
    for ci, col in enumerate(nb.columns):
        if ci in before:
            assert isinstance(col.data, np.memmap)
            np.testing.assert_array_equal(np.asarray(col.data), before[ci])
            demoted += 1
    assert demoted > 0
    c0, p0 = _c("tier_crc_verifies"), _c("tier_promotions")
    loaded, rb = tier.promote_batch(nb)
    assert loaded > 0
    assert _c("tier_crc_verifies") > c0 and _c("tier_promotions") == p0 + 1
    for ci, col in enumerate(rb.columns):
        if ci in before:
            assert not isinstance(col.data, np.memmap)
            np.testing.assert_array_equal(np.asarray(col.data), before[ci])


def test_corrupt_tier_record_quarantined_and_healed(small_batches):
    """A corrupted tier record no longer fails the query: promotion's
    CRC catches it, the file is quarantined aside, and the batch is
    REBUILT from the retained pre-demotion epoch — values exact (the
    no-surviving-source case raises the typed TierQuarantinedError;
    see test_self_healing.py)."""
    import os

    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=1200)
    data = sess.catalog.describe("big").data
    q = "SELECT count(*), sum(v) FROM big"
    expected = sess.sql(q).rows()
    n0 = tier.demote_host([("big", data)], 1 << 40)
    assert n0 > 0
    col = data._manifest.views[0].batch.columns[1]  # v DOUBLE
    assert isinstance(col.data, np.memmap)
    path = str(col.data.filename)
    with open(path, "r+b") as fh:  # flip one part byte under the CRC
        fh.seek(col.data.offset)
        b = fh.read(1)
        fh.seek(col.data.offset)
        fh.write(bytes([b[0] ^ 0xFF]))
    q0, r0 = _c("tier_quarantined_files"), _c("tier_rebuilds")
    assert tier.promote_table(data) > 0
    assert _c("tier_quarantined_files") == q0 + 1
    assert _c("tier_rebuilds") == r0 + 1
    assert os.path.exists(path + ".quarantined")
    got = sess.sql(q).rows()
    assert int(got[0][0]) == int(expected[0][0])
    assert float(got[0][1]) == pytest.approx(float(expected[0][1]),
                                             rel=1e-9)


# -- the ladder ------------------------------------------------------------

def test_demote_ladder_values_survive(small_batches):
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _, v, w = _load(sess)
    q = "SELECT k, count(*), sum(v), min(w) FROM big GROUP BY k ORDER BY k"
    expected = sess.sql(q).rows()
    data = sess.catalog.describe("big").data
    assert data._device_cache, "warm plates expected before demotion"
    d0, h0 = _c("tier_demotions_hbm"), _c("tier_demotions_host")
    n = tier.demote([("big", data)], 1 << 40)
    assert n > 0
    assert _c("tier_demotions_hbm") > d0, "device rung should demote"
    assert _c("tier_demotions_host") > h0, "host rung should demote"
    assert tier.tier_file_bytes() > 0
    # every batch's numeric arrays now live in the disk tier
    assert all(isinstance(vw.batch.columns[1].data, np.memmap)
               for vw in data._manifest.views)
    got = sess.sql(q).rows()  # faults pages back + rebuilds plates
    assert got == expected
    # promote pulls them resident again, CRC-verified
    c0 = _c("tier_crc_verifies")
    assert tier.promote_table(data) > 0
    assert _c("tier_crc_verifies") > c0
    assert sess.sql(q).rows() == expected
    snap = tier.tier_snapshot()
    assert set(snap) == {"device_bytes", "host_pool_bytes",
                         "tier_file_bytes", "quarantined_files",
                         "rebuilds", "rebuild_failures", "read_retries",
                         "pressure_demotions"}


def test_demotion_respects_mvcc_pins(small_batches):
    """A pinned epoch's plates are NEVER demoted out from under a live
    scan — the ladder skips them (counter-asserted) and the pinned read
    stays value-exact after an aggressive demotion."""
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _, v, _ = _load(sess, n=2000)
    data = sess.catalog.describe("big").data
    with mvcc.pinned_scope(sess.catalog, ["big"]) as pin:
        expected = sess.sql("SELECT count(*), sum(v) FROM big").rows()[0]
        ver = pin.manifest_for(data).version
        assert any(k[0] == ver for k in data._device_cache), \
            "pinned scan should have warmed plates at its epoch"
        s0 = _c("tier_pinned_skips")
        tier.demote([("big", data)], 1 << 40)
        assert _c("tier_pinned_skips") > s0, \
            "the ladder must COUNT its refusals to demote pinned plates"
        assert any(k[0] == ver for k in data._device_cache), \
            "pinned epoch's plates were demoted out from under the scan"
        got = sess.sql("SELECT count(*), sum(v) FROM big").rows()[0]
        assert int(got[0]) == int(expected[0])
        assert float(got[1]) == pytest.approx(float(expected[1]),
                                              rel=1e-9)


def test_budget_eviction_respects_pins(small_batches):
    """The device-cache byte budget's LRU must ALSO skip pinned epochs
    (it evicts through the same tier contract)."""
    props = small_batches
    old_budget = props.device_cache_bytes
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=2000)
    data = sess.catalog.describe("big").data
    try:
        with mvcc.pinned_scope(sess.catalog, ["big"]) as pin:
            sess.sql("SELECT sum(v) FROM big")
            ver = pin.manifest_for(data).version
            assert any(k[0] == ver for k in data._device_cache)
            # a 1-byte budget wants to evict EVERYTHING on next touch
            props.device_cache_bytes = 1
            sess.sql("SELECT sum(w) FROM big")
            assert any(k[0] == ver for k in data._device_cache), \
                "budget LRU evicted a pinned epoch's plates"
    finally:
        props.device_cache_bytes = old_budget


# -- prefetcher ------------------------------------------------------------

def test_prefetch_values_and_invariant(small_batches):
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess)
    q = ("SELECT k, count(*), sum(v), avg(v), min(w), max(w) "
         "FROM big GROUP BY k ORDER BY k")
    expected = sess.sql(q).rows()
    small_batches.scan_tile_bytes = 2 * 256 * 32
    w0, t0 = _c("prefetch_windows_warmed"), _c("scan_tiles")
    got = sess.sql(q).rows()
    assert _c("scan_tiles") > t0, "expected the tiled path"
    assert _c("prefetch_windows_warmed") > w0, \
        "the background worker should have warmed look-ahead windows"
    assert len(got) == len(expected) == 4
    for e, g in zip(expected, got):
        assert e[0] == g[0] and e[1] == g[1] and e[4] == g[4] \
            and e[5] == g[5]
        assert g[2] == pytest.approx(e[2], rel=1e-9)
        assert g[3] == pytest.approx(e[3], rel=1e-9)
    # the pass must not leave its look-ahead tiles resident
    data = sess.catalog.describe("big").data
    windowed = [k for k in data._device_cache if k[2] is not None]
    assert len(windowed) <= 1, windowed
    from snappydata_tpu_torch.storage.prefetch import keep_windows

    assert not keep_windows(data), "keep-registry must drain at close"


def test_prefetch_disabled_by_knob(small_batches):
    small_batches.tier_prefetch_depth = 0
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=3000)
    q = "SELECT count(*), sum(v) FROM big"
    expected = sess.sql(q).rows()
    small_batches.scan_tile_bytes = 2 * 256 * 32
    w0 = _c("prefetch_windows_warmed")
    assert sess.sql(q).rows() == expected
    assert _c("prefetch_windows_warmed") == w0


def test_prefetch_worker_death_falls_back_inline(small_batches,
                                                 monkeypatch):
    """A worker that dies on its first build must not wedge or corrupt
    the pass — the consumer binds inline and values stay exact."""
    from snappydata_tpu_torch.storage.prefetch import TilePrefetcher

    def boom(self):
        raise RuntimeError("injected prefetch-worker death")

    monkeypatch.setattr(TilePrefetcher, "_loop", boom)
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=3000)
    q = "SELECT k, count(*), sum(v) FROM big GROUP BY k ORDER BY k"
    expected = sess.sql(q).rows()
    small_batches.scan_tile_bytes = 2 * 256 * 32
    e0 = _c("prefetch_errors")
    got = sess.sql(q).rows()
    assert len(got) == len(expected)
    for e, g in zip(expected, got):
        assert g[0] == e[0] and g[1] == e[1]
        assert g[2] == pytest.approx(e[2], rel=1e-9)
    assert _c("prefetch_errors") > e0


# -- steady-state knobs ----------------------------------------------------

def test_tier_device_knob_enforced_after_pass(small_batches):
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess)
    sess.sql("SELECT sum(v) FROM big")   # warm unwindowed plates
    data = sess.catalog.describe("big").data
    assert data._device_cache
    small_batches.tier_device_bytes = 1  # everything is over-cap
    small_batches.scan_tile_bytes = 2 * 256 * 32
    d0 = _c("tier_demotions_hbm")
    sess.sql("SELECT count(*), sum(v) FROM big")
    assert _c("tier_demotions_hbm") > d0, \
        "maybe_demote should walk the HBM rung after the tiled pass"


# -- self-healing (ref: tests/test_self_healing.py) ------------------------

@pytest.fixture(autouse=True)
def _clean_failpoints():
    rfail.clear()
    rfail.reseed(4242)
    yield
    rfail.clear()


def _corrupt_first_batch(data):
    col = data._manifest.views[0].batch.columns[1]  # v DOUBLE
    assert isinstance(col.data, np.memmap)
    path = str(col.data.filename)
    with open(path, "r+b") as fh:   # flip one part byte under the CRC
        fh.seek(col.data.offset)
        b = fh.read(1)
        fh.seek(col.data.offset)
        fh.write(bytes([b[0] ^ 0xFF]))
    return path


# -- quarantine + rebuild --------------------------------------------------

def test_injected_corruption_heals_from_retained_epoch(small_batches):
    """corrupt_bytes via the failpoint on the DEMOTE write; promotion's
    CRC catches it, the file is quarantined, and the batch grafts back
    from the retained pre-demotion epoch — values exact, query-visible
    error: none."""
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=1200)
    data = sess.catalog.describe("big").data
    q = ("SELECT k, count(*), sum(v), min(w) FROM big "
         "GROUP BY k ORDER BY k")
    expected = sess.sql(q).rows()
    rfail.arm("tier.write", "corrupt_bytes", param=4, count=1)
    assert tier.demote_host([("big", data)], 1 << 40) > 0
    rfail.clear()
    q0, r0 = _c("tier_quarantined_files"), _c("tier_rebuilds")
    assert tier.promote_table(data) > 0           # heals, no raise
    assert _c("tier_quarantined_files") == q0 + 1
    assert _c("tier_rebuilds") == r0 + 1
    assert not any(isinstance(vw.batch.columns[1].data, np.memmap)
                   for vw in data._manifest.views)
    got = sess.sql(q).rows()
    assert len(got) == len(expected)
    for e, g in zip(expected, got):
        assert g[0] == e[0] and g[1] == e[1] and g[3] == e[3]
        assert g[2] == pytest.approx(e[2], rel=1e-9)


def test_corruption_heals_from_durable_store(tmp_path, small_batches):
    """With the retained epochs trimmed away, the rebuild falls through
    to the checkpointed batch file in the session's DiskStore."""
    sess = SnappySession(catalog=Catalog(), data_dir=str(tmp_path),
                         recover=False, device="cpu")
    _load(sess, n=1200)
    sess.checkpoint()                 # batch-<id>.col on disk
    data = sess.catalog.describe("big").data
    q = "SELECT count(*), sum(v) FROM big"
    expected = sess.sql(q).rows()
    assert tier.demote_host([("big", data)], 1 << 40) > 0
    mvcc.trim_unpinned([("big", data)])   # drop the resident twin
    assert not getattr(data, "_retained_epochs", None)
    _corrupt_first_batch(data)
    r0 = _c("tier_rebuilds")
    assert tier.promote_table(data) > 0
    assert _c("tier_rebuilds") == r0 + 1
    got = sess.sql(q).rows()
    assert int(got[0][0]) == int(expected[0][0])
    assert float(got[0][1]) == pytest.approx(float(expected[0][1]),
                                             rel=1e-9)
    sess.disk_store.close()


def test_rebuild_reads_only_the_tables_own_store(tmp_path, small_batches,
                                                  monkeypatch):
    """Fault C5: two durable sessions each hold a table `big` with the
    same batch ids.  With the OTHER session's store first in the walk, the
    quarantine rebuild of A's batch must still read A's own checkpointed
    file: A's sum(v) stays A's oracle, never B's rows."""
    sa = SnappySession(catalog=Catalog(), data_dir=str(tmp_path / "a"),
                       recover=False, device="cpu")
    sb = SnappySession(catalog=Catalog(), data_dir=str(tmp_path / "b"),
                       recover=False, device="cpu")
    _k, va, _w = _load(sa, n=1200, seed=7)
    _load(sb, n=1200, seed=99)
    sa.checkpoint()
    sb.checkpoint()
    # the hazard made certain: B's store is consulted first
    monkeypatch.setattr(tier, "_STORES", [sb.disk_store, sa.disk_store])
    data = sa.catalog.describe("big").data
    assert tier.demote_host([("big", data)], 1 << 40) > 0
    mvcc.trim_unpinned([("big", data)])
    _corrupt_first_batch(data)
    r0 = _c("tier_rebuilds")
    assert tier.promote_table(data) > 0
    assert _c("tier_rebuilds") == r0 + 1
    got = sa.sql("SELECT count(*), sum(v) FROM big").rows()[0]
    assert int(got[0]) == 1200
    assert float(got[1]) == pytest.approx(float(va.sum()), rel=1e-12), \
        (float(got[1]), float(va.sum()))
    assert round(float(va.sum()), 2) == 119925.97
    sa.disk_store.close()
    sb.disk_store.close()


def test_corruption_without_source_raises_typed(small_batches):
    """No retained epoch, no durable store: the quarantine still
    happens, but the failure surfaces as the TYPED TierQuarantinedError
    (operator-actionable), not a bare CorruptRecordError."""
    sess = SnappySession(catalog=Catalog(), device="cpu")
    # a table name no earlier-checkpointed DiskStore in this process
    # knows, so the durable-store fallback cannot accidentally serve
    sess.sql("CREATE TABLE lone (k STRING, v DOUBLE, w BIGINT) "
             "USING column")
    rng = np.random.default_rng(7)
    sess.catalog.describe("lone").data.insert_arrays(
        [rng.choice(np.array(["a", "b"], dtype=object), 1200),
         rng.normal(100.0, 10.0, 1200),
         rng.integers(0, 1000, 1200, dtype=np.int64)])
    data = sess.catalog.describe("lone").data
    assert tier.demote_host([("lone", data)], 1 << 40) > 0
    mvcc.trim_unpinned([("lone", data)])
    path = _corrupt_first_batch(data)
    f0, q0 = _c("tier_rebuild_failures"), _c("tier_quarantined_files")
    with pytest.raises(tier.TierQuarantinedError):
        tier.promote_table(data)
    assert _c("tier_rebuild_failures") == f0 + 1
    assert _c("tier_quarantined_files") == q0 + 1
    assert os.path.exists(path + ".quarantined")
    assert not os.path.exists(path)


# -- bounded retry / graceful abort ----------------------------------------

def test_memmap_eio_retried_once(small_batches):
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=1200)
    data = sess.catalog.describe("big").data
    q = "SELECT count(*), sum(v) FROM big"
    expected = sess.sql(q).rows()
    assert tier.demote_host([("big", data)], 1 << 40) > 0
    rfail.arm("tier.memmap_read", "return_errno", count=1)
    t0 = _c("tier_read_retries")
    assert tier.promote_table(data) > 0    # one bounded re-read heals
    assert _c("tier_read_retries") == t0 + 1
    assert sess.sql(q).rows() == expected


def test_short_write_aborts_spill_batch_stays_resident(small_batches):
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=1200)
    data = sess.catalog.describe("big").data
    q = "SELECT count(*), sum(v) FROM big"
    expected = sess.sql(q).rows()
    rfail.arm("tier.write", "short_write", param=64)
    b0 = tier.tier_file_bytes()
    tier.demote_host([("big", data)], 1 << 40)
    rfail.clear()
    # every spill aborted: nothing on disk, nothing memmapped, values up
    assert tier.tier_file_bytes() == b0
    assert not any(isinstance(vw.batch.columns[1].data, np.memmap)
                   for vw in data._manifest.views)
    assert sess.sql(q).rows() == expected


# -- prefetch worker self-restart ------------------------------------------

def test_prefetch_worker_restarts_after_injected_kill(small_batches):
    from snappydata_tpu_torch.storage import prefetch

    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=3000)
    q = "SELECT k, count(*), sum(v) FROM big GROUP BY k ORDER BY k"
    expected = sess.sql(q).rows()
    small_batches.scan_tile_bytes = 2 * 256 * 32
    rfail.arm("prefetch.worker", "kill_worker", count=1)
    r0, d0 = _c("prefetch_worker_restarts"), _c("prefetch_worker_deaths")
    w0 = _c("prefetch_windows_warmed")
    got = sess.sql(q).rows()
    assert _c("prefetch_worker_deaths") == d0 + 1
    assert _c("prefetch_worker_restarts") == r0 + 1, \
        "the supervised worker must restart, not degrade to inline"
    assert _c("prefetch_windows_warmed") > w0, \
        "the restarted worker should still warm look-ahead windows"
    assert len(got) == len(expected)
    for e, g in zip(expected, got):
        assert g[0] == e[0] and g[1] == e[1]
        assert g[2] == pytest.approx(e[2], rel=1e-9)
    snap = prefetch.worker_snapshot()
    assert snap["worker_restarts"] >= 1


def test_prefetch_restart_cap(small_batches, monkeypatch):
    """A worker that dies EVERY time exhausts tier_prefetch_max_restarts
    and degrades to inline binds — bounded, never an infinite respawn
    loop — with values still exact."""
    from snappydata_tpu_torch.storage.prefetch import TilePrefetcher

    def boom(self):
        raise RuntimeError("injected perma-death")

    monkeypatch.setattr(TilePrefetcher, "_loop", boom)
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=3000)
    q = "SELECT count(*), sum(v) FROM big"
    expected = sess.sql(q).rows()
    small_batches.scan_tile_bytes = 2 * 256 * 32
    r0 = _c("prefetch_worker_restarts")
    cap = int(config.global_properties().tier_prefetch_max_restarts)
    assert sess.sql(q).rows() == expected
    assert _c("prefetch_worker_restarts") - r0 <= cap


# -- pressure-driven background demotion -----------------------------------

def test_pressure_demote_direct(small_batches):
    from snappydata_tpu_torch.resource.broker import global_broker

    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=1200)
    sess.sql("SELECT sum(v) FROM big")     # warm device plates
    d0 = _c("tier_pressure_demotions")
    n = tier.pressure_demote(global_broker(), target_bytes=0)
    assert n > 0
    assert _c("tier_pressure_demotions") == d0 + 1


def test_admission_pressure_kicks_background_demotion(small_batches):
    from snappydata_tpu_torch.resource.broker import global_broker

    props = config.global_properties()
    saved = (props.memory_limit_bytes, props.tier_pressure_watermark)
    sess = SnappySession(catalog=Catalog(), device="cpu")
    _load(sess, n=1200)
    sess.sql("SELECT sum(v) FROM big")
    broker = global_broker()
    try:
        host, device = broker.measured_bytes(max_age_s=0.0)
        measured = host + device
        assert measured > 0
        # land measured residency BETWEEN the pressure watermark and the
        # high watermark: background relief, not synchronous degrade
        props.memory_limit_bytes = int(measured * 4)
        props.tier_pressure_watermark = 0.1
        w0 = _c("tier_pressure_wakeups")
        p0 = _c("tier_pressure_demotions")
        sess.sql("SELECT count(*) FROM big")   # admission sees pressure
        assert _c("tier_pressure_wakeups") == w0 + 1
        deadline = time.time() + 10.0
        while time.time() < deadline \
                and _c("tier_pressure_demotions") == p0:
            time.sleep(0.02)
        assert _c("tier_pressure_demotions") > p0, \
            "the background ladder pass never ran"
        # single-flight: a second admission while nothing is running
        # may wake again, but the flag must have been released
        with broker._pressure_lock:
            running = broker._pressure_running
        assert not running
    finally:
        (props.memory_limit_bytes, props.tier_pressure_watermark) = saved


# -- out-of-core HTAP chaos (ref: tests/test_outofcore_chaos.py) ----------

@pytest.fixture
def constricted():
    """Budgets far below the working set: tiny batches so tables span
    many batches, tiny tiles so scans go down the tiled lane, a tier
    device cap that evicts everything unpinned, and a host cap that
    pushes batches to the CRC-framed disk tier."""
    props = config.global_properties()
    old = (props.column_batch_rows, props.column_max_delta_rows,
           props.scan_tile_bytes,
           props.device_cache_bytes, props.tier_device_bytes,
           props.tier_host_bytes, props.tier_prefetch_depth)
    props.column_batch_rows = 128
    props.column_max_delta_rows = 128  # fold deltas into column batches
    props.scan_tile_bytes = 2 * 128 * 32
    props.device_cache_bytes = 64 * 1024
    props.tier_device_bytes = 32 * 1024
    # the reference's case caps the host pool at 48 KiB; its ledger walk
    # there holds two live 'h' lines (two owners), so its ~27 KiB table
    # counts twice and crosses the cap.  The port ledgers the table once:
    # 16 KiB keeps the same table above the cap, as the case intends
    props.tier_host_bytes = 16 * 1024
    props.tier_prefetch_depth = 2
    yield props
    (props.column_batch_rows, props.column_max_delta_rows,
     props.scan_tile_bytes,
     props.device_cache_bytes, props.tier_device_bytes,
     props.tier_host_bytes, props.tier_prefetch_depth) = old


@pytest.mark.chaos
def test_outofcore_htap_chaos_parity(tmp_path, constricted):
    rng = random.Random(1616)
    dirn = str(tmp_path / "store")
    s = SnappySession(data_dir=dirn, device="cpu")
    s.sql("CREATE TABLE h (k INT, v DOUBLE) USING column")
    data = s.catalog.describe("h").data

    # seed enough rows that every scan spans multiple batches AND tiles
    seed_vals = [float(i % 10) for i in range(1500)]
    s.insert("h", *[(i, v) for i, v in enumerate(seed_vals)])

    expected = {data.snapshot().version: (1500, sum(seed_vals))}
    acked_rows = [1500]
    acked_sum = [sum(seed_vals)]
    log_lock = threading.Lock()
    stop = threading.Event()
    errs = []

    def committer(sess):
        try:
            # bounded: with the device tier evicted to cap after every
            # statement, reads slow to streaming speed — an unbounded
            # committer would grow the table (and the scan time) without
            # limit while the readers crawl
            for _ in range(40):
                if stop.is_set():
                    break
                n = rng.randint(20, 160)
                vals = [float(rng.randint(0, 9)) for _ in range(n)]
                sess.insert("h", *[(i, v) for i, v in enumerate(vals)])
                with log_lock:
                    acked_rows[0] += n
                    acked_sum[0] += sum(vals)
                    expected[data.snapshot().version] = (
                        acked_rows[0], acked_sum[0])
        except Exception as e:
            errs.append(e)

    def reader(sess, n_reads):
        import time as _time

        try:
            for _ in range(n_reads):
                with mvcc.pinned_scope(sess.catalog, ["h"]) as pin:
                    ver = pin.manifest_for(data).version
                    got = sess.sql(
                        "SELECT count(*), sum(v) FROM h").rows()[0]
                want = None
                for _spin in range(200):
                    with log_lock:
                        want = expected.get(ver)
                    if want is not None:
                        break
                    _time.sleep(0.01)
                assert want is not None, \
                    f"pinned version {ver} missing from the commit log"
                cnt = int(got[0])
                sm = float(got[1]) if got[1] is not None else 0.0
                assert (cnt, round(sm, 6)) == (want[0], round(want[1], 6)), \
                    f"out-of-core snapshot@v{ver} read {got}, " \
                    f"serialized replay says {want}"
        except Exception as e:
            errs.append(e)

    d0 = _c("tier_demotions_hbm") + _c("tier_demotions_host")
    p0 = _c("prefetch_windows_warmed")
    w = threading.Thread(target=committer, args=(s,), daemon=True)
    readers = [threading.Thread(target=reader, args=(s, 6), daemon=True)
               for _ in range(2)]
    w.start()
    for r in readers:
        r.start()
    for r in readers:
        r.join(timeout=180)
    stop.set()
    w.join(timeout=30)
    assert not errs, errs
    assert not w.is_alive() and not any(r.is_alive() for r in readers)

    # one more full tiled scan guarantees a maybe_demote pass against
    # the now-large table, then prove the schedule really ran out of
    # core: the ladder demoted and the prefetcher streamed windows
    final = s.sql("SELECT count(*), sum(v) FROM h").rows()[0]
    assert int(final[0]) == acked_rows[0]
    assert round(float(final[1]), 6) == round(acked_sum[0], 6)
    assert _c("tier_demotions_hbm") + _c("tier_demotions_host") > d0, \
        "constricted budgets never triggered the demotion ladder"
    assert _c("prefetch_windows_warmed") > p0, \
        "tiled chaos scans never exercised the prefetcher"

    # ---- kill → rejoin while batches sit memmapped in the disk tier:
    # recovery replays from WAL; answers must not depend on tier files
    final_acked, final_sum = acked_rows[0], acked_sum[0]
    s2 = SnappySession(data_dir=dirn, device="cpu")
    got = s2.sql("SELECT count(*), sum(v) FROM h").rows()[0]
    assert int(got[0]) == final_acked, \
        f"acked rows lost across the crash: {got[0]} != {final_acked}"
    assert round(float(got[1]), 6) == round(final_sum, 6)

    # ---- in-HBM parity: lift the caps, promote everything resident,
    # and the answer is bit-identical to the constricted run's
    props = constricted
    props.tier_device_bytes = 0
    props.tier_host_bytes = 0
    props.device_cache_bytes = 0
    data2 = s2.catalog.describe("h").data
    tier.promote_table(data2)
    assert not any(isinstance(vw.batch.columns[1].data, np.memmap)
                   for vw in data2._manifest.views)
    hbm = s2.sql("SELECT count(*), sum(v) FROM h").rows()[0]
    assert int(hbm[0]) == final_acked
    assert float(hbm[1]) == float(got[1]), \
        "out-of-core answer diverged from the in-HBM answer"
    s2.disk_store.close()


# -- parity with the reference ---------------------------------------------

def _tpch_pair(policy_name, n=6000, seed=5):
    """lineitem in both packages, small batches, no background compactor
    in either (a rewrite between two queries would change the plates)."""
    pair = Pair(policy_name)
    li = tpch.gen_lineitem(n, seed)
    pair.sql(tpch.LINEITEM_DDL)
    pair.insert_arrays("lineitem", list(li.values()))
    return pair


@pytest.fixture
def both_small():
    from snappydata_tpu import config as ref_config

    props = (ref_config.global_properties(), config.global_properties())
    saved = [(p.column_batch_rows, p.column_max_delta_rows,
              p.compaction_enabled) for p in props]
    for p in props:
        p.column_batch_rows = 1024
        p.column_max_delta_rows = 256
        p.compaction_enabled = False
    rfail.clear()
    ref_rfail.clear()
    yield
    rfail.clear()
    ref_rfail.clear()
    for p, (rows, delta, comp) in zip(props, saved):
        p.column_batch_rows, p.column_max_delta_rows, \
            p.compaction_enabled = rows, delta, comp


def _both_data(pair):
    return (pair.port.catalog.describe("lineitem").data,
            pair.ref.catalog.describe("lineitem").data)


@pytest.mark.parametrize("policy_name", POLICIES)
def test_q1_q6_over_demoted_spilled_and_healed_lineitem(both_small,
                                                        policy_name):
    pair = _tpch_pair(policy_name)
    want = [pair.device(tpch.Q1), pair.device(tpch.Q6)]
    port_d, ref_d = _both_data(pair)
    # host -> disk: every batch memmapped in both packages
    assert tier.demote([("lineitem", port_d)], 1 << 40) > 0
    assert ref_tier.demote([("lineitem", ref_d)], 1 << 40) > 0
    assert all(isinstance(v.batch.columns[4].data, np.memmap)
               for v in port_d._manifest.views)
    assert [pair.device(tpch.Q1), pair.device(tpch.Q6)] == want
    # heal: corrupt one record through the tier.write failpoint in both,
    # demote, promote (CRC -> quarantine -> rebuild from the retained
    # epoch), and the answers hold
    assert tier.promote_table(port_d) > 0
    assert ref_tier.promote_table(ref_d) > 0
    q0 = global_registry().counter("tier_quarantined_files")
    r0 = global_registry().counter("tier_rebuilds")
    rfail.arm("tier.write", "corrupt_bytes", param=4, count=1)
    ref_rfail.arm("tier.write", "corrupt_bytes", param=4, count=1)
    assert tier.demote_host([("lineitem", port_d)], 1 << 40) > 0
    assert ref_tier.demote_host([("lineitem", ref_d)], 1 << 40) > 0
    rfail.clear()
    ref_rfail.clear()
    assert tier.promote_table(port_d) > 0
    assert ref_tier.promote_table(ref_d) > 0
    assert global_registry().counter("tier_quarantined_files") == q0 + 1
    assert global_registry().counter("tier_rebuilds") == r0 + 1
    assert [pair.device(tpch.Q1), pair.device(tpch.Q6)] == want
    # host spill to memmaps (hoststore), a budget of a quarter
    budget = hoststore.batch_resident_bytes(
        port_d._manifest.views[0].batch) * len(port_d._manifest.views) // 4
    assert hoststore.spill_to_budget(port_d, budget) > 0
    assert ref_hoststore.spill_to_budget(ref_d, budget) > 0
    assert [pair.device(tpch.Q1), pair.device(tpch.Q6)] == want


def _spill_arrays(batch):
    out = []
    for col in batch.columns:
        for name in ("data", "runs", "validity"):
            a = getattr(col, name)
            out.append(None if a is None or isinstance(a, np.memmap)
                       or a.dtype == object else np.asarray(a))
    return out


def test_tier_records_read_across_packages(both_small, tmp_path):
    """A record framed by either package passes the other's CRC-checked
    `_read_tier_record` and yields the same arrays."""
    pair = _tpch_pair("f64", n=3000)
    port_d, ref_d = _both_data(pair)
    for frame, read, batch, tag in (
            (tier.frame_batch, ref_tier._read_tier_record,
             port_d._manifest.views[0].batch, "port_to_ref"),
            (ref_tier.frame_batch, tier._read_tier_record,
             ref_d._manifest.views[0].batch, "ref_to_port")):
        path = str(tmp_path / f"{tag}.snt")
        with open(path, "wb") as fh:
            fh.write(frame(batch, {"table": "lineitem"}))
        header, arrays = read(path)
        assert header["kind"] == "tier_batch"
        assert header["batch_id"] == batch.batch_id
        want = _spill_arrays(batch)
        assert len(arrays) == len(want)
        for a, w in zip(arrays, want):
            if w is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, w)
    # the two packages frame the same batch byte for byte
    assert tier.frame_batch(port_d._manifest.views[0].batch) \
        == ref_tier.frame_batch(ref_d._manifest.views[0].batch)
