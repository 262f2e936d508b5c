"""The port's WAL: framing, group commit, ack semantics and salvage.

After tests/test_group_commit.py, tests/test_wal_fuzz.py and
tests/test_durability_regressions.py, against the port's DiskStore
(`snappydata_tpu_torch/storage/persistence.py`) and durable
`SnappySession` on the CPU:

- a framed record is byte-identical to the reference's for the same
  header and arrays (one on-disk format for both packages);
- a burst of appends plus one sync costs O(groups) fsyncs in `group`
  mode, one per record in `always` mode, and `interval` acks early with
  the flusher (or `close`) covering the tail;
- a torn or raised `wal.group_commit` raises the acks of the torn tail
  only, and a failed drain fences `checkpoint()` until the store is
  reopened;
- a corrupt tail is salvaged to `wal.log.corrupt` and counted, and
  recovery keeps every intact record.
"""

import os
import threading
import time

import numpy as np
import pytest

from snappydata_tpu.storage import persistence as ref_persistence
from snappydata_tpu_torch import SnappySession, config, fault
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.storage.persistence import (DiskStore,
                                                      frame_record,
                                                      read_records)


@pytest.fixture(autouse=True)
def wal_knobs():
    """Restore the WAL policy knobs and the failpoint registry."""
    props = config.global_properties()
    saved = {k: props.get(k) for k in
             ("wal_fsync_mode", "wal_buffer_bytes", "wal_group_ms",
              "compression_codec")}
    fault.clear()
    yield props
    for k, v in saved.items():
        props.set(k, v)
    fault.clear()


def _seqs(d):
    with open(os.path.join(d, "wal.log"), "rb") as fh:
        return [h["seq"] for h, _ in read_records(fh)]


def _session(d, recover=False):
    if recover:
        return SnappySession(data_dir=d, device="cpu")
    return SnappySession(catalog=Catalog(), data_dir=d, recover=False,
                         device="cpu")


def _keys(s):
    return [r[0] for r in s.sql("SELECT k FROM t ORDER BY k").rows()]


@pytest.mark.parametrize("codec", ["zlib", "none"])
def test_framed_record_is_the_reference_format(codec, wal_knobs):
    from snappydata_tpu import config as ref_config

    header = {"kind": "insert", "table": "t", "seq": 7, "ncols": 4}
    cells = np.empty(3, dtype=object)
    cells[:] = [[1, 2], None, {"k": 1.5}]
    arrays = [np.arange(1000, dtype=np.int64),
              np.array(["a", None, "b"] * 333 + ["a"], dtype=object),
              cells, np.array(["né", None, "", "ü" * 300], dtype=object)]
    ref_props = ref_config.global_properties()
    saved = ref_props.compression_codec
    try:
        wal_knobs.set("compression_codec", codec)
        ref_props.compression_codec = codec
        mine = frame_record(header, arrays)
        theirs = ref_persistence.frame_record(header, arrays)
    finally:
        ref_props.compression_codec = saved
    assert mine == theirs
    import io

    (h, got), = list(read_records(io.BytesIO(mine)))
    assert h == header
    np.testing.assert_array_equal(got[0], arrays[0])
    assert list(got[1]) == list(arrays[1])
    assert list(got[2]) == [[1, 2], None, {"k": 1.5}]
    assert list(got[3]) == list(arrays[3])


def test_group_mode_burst_costs_o_groups_fsyncs(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "group")
    wal_knobs.set("wal_group_ms", 500.0)     # the flusher stays away
    d = str(tmp_path)
    ds = DiskStore(d)
    before = global_registry().counter("wal_fsync_count")
    n = 300
    for i in range(n):
        ds.wal_append("t", "sql", sql=f"INSERT INTO t VALUES ({i})")
    ds.wal_sync()
    fsyncs = global_registry().counter("wal_fsync_count") - before
    assert fsyncs <= 8, f"{fsyncs} fsyncs for {n} records"
    assert _seqs(d) == list(range(1, n + 1))
    ds.close()


def test_always_mode_pays_one_fsync_per_record(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "always")
    ds = DiskStore(str(tmp_path))
    before = global_registry().counter("wal_fsync_count")
    for i in range(20):
        ds.wal_append("t", "sql", sql=f"stmt {i}")
    assert global_registry().counter("wal_fsync_count") - before == 20
    ds.close()


def test_group_ack_means_bytes_on_disk(tmp_path, wal_knobs):
    """After a statement returns, its record parses from wal.log."""
    wal_knobs.set("wal_fsync_mode", "group")
    wal_knobs.set("wal_group_ms", 10_000.0)
    d = str(tmp_path)
    s = _session(d)
    s.sql("CREATE TABLE t (k BIGINT) USING column")
    s.sql("INSERT INTO t VALUES (1)")
    with open(os.path.join(d, "wal.log"), "rb") as fh:
        recs = [h for h, _ in read_records(fh)]
    assert recs[-1]["sql"] == "INSERT INTO t VALUES (1)"
    s.disk_store.close()


def test_interval_mode_acks_early_and_the_flusher_covers(tmp_path,
                                                         wal_knobs):
    wal_knobs.set("wal_fsync_mode", "interval:50")
    d = str(tmp_path)
    ds = DiskStore(d)
    seq = ds.wal_append("t", "sql", sql="x")
    t0 = time.monotonic()
    ds.wal_sync(seq)                 # relaxed: returns at once
    assert time.monotonic() - t0 < 0.05
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not (
            os.path.exists(os.path.join(d, "wal.log"))
            and _seqs(d) == [seq]):
        time.sleep(0.02)
    assert _seqs(d) == [seq], "the flusher never covered the tail"
    # close drains an interval-mode tail
    seq2 = ds.wal_append("t", "sql", sql="y")
    ds.close()
    assert _seqs(d) == [seq, seq2]


def test_interval_mode_session_recovers_after_close(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "interval:10000")
    d = str(tmp_path)
    s = _session(d)
    s.sql("CREATE TABLE t (k BIGINT) USING column")
    for k in range(5):
        s.sql(f"INSERT INTO t VALUES ({k})")
    s.disk_store.close()
    s2 = _session(d, recover=True)
    assert _keys(s2) == list(range(5))
    s2.disk_store.close()


def test_mid_group_torn_tail_truncates_cleanly(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "group")
    wal_knobs.set("wal_group_ms", 10_000.0)
    d = str(tmp_path)
    ds = DiskStore(d)
    for i in range(3):
        ds.wal_append("t", "sql", sql=f"stmt {i}")
    fault.arm("wal.group_commit", "torn_write", param=5, count=1)
    corrupt_before = global_registry().counter("wal_corrupt_records")
    with pytest.raises(IOError):
        ds.wal_sync()
    ds.wal_sync(seq=2)                       # inside the fsynced prefix
    with pytest.raises(IOError):
        ds.wal_sync(seq=3)                   # the torn record's ack
    ds.close()
    ds2 = DiskStore(d)
    assert _seqs(d) == [1, 2]
    assert global_registry().counter("wal_corrupt_records") == \
        corrupt_before, "a crash tear was counted as corruption"
    ds2.wal_append("t", "sql", sql="post-crash")
    ds2.wal_sync()
    assert _seqs(d)[-1] > 2
    ds2.close()


def test_failed_group_drain_raises_every_waiter(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "group")
    wal_knobs.set("wal_group_ms", 10_000.0)
    d = str(tmp_path)
    ds = DiskStore(d)
    seqs = [ds.wal_append("t", "sql", sql="a"),
            ds.wal_append("t", "sql", sql="b")]
    fault.arm("wal.group_commit", "raise", count=1)
    errors = []

    def sync(seq):
        try:
            ds.wal_sync(seq)
        except Exception as e:   # each waiter's ack must raise
            errors.append(e)

    threads = [threading.Thread(target=sync, args=(q,)) for q in seqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "a waiter hung"
    assert len(errors) == 2
    seq = ds.wal_append("t", "sql", sql="after")
    ds.wal_sync(seq)
    assert seq in _seqs(d)
    ds.close()


def test_failed_drain_fences_checkpoint_until_reopen(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "group")
    d = str(tmp_path)
    s = _session(d)
    s.sql("CREATE TABLE t (k BIGINT) USING column")
    s.sql("INSERT INTO t VALUES (1)")
    fault.arm("wal.group_commit", "raise", count=1)
    with pytest.raises(IOError):
        s.sql("INSERT INTO t VALUES (2)")    # applied, never journaled
    with pytest.raises(IOError, match="reopen"):
        s.checkpoint()
    s.disk_store.close()
    s2 = _session(d, recover=True)
    assert _keys(s2) == [1]
    s2.checkpoint()
    s2.disk_store.close()


def test_torn_append_loses_only_its_statement(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "group")
    d = str(tmp_path)
    s = _session(d)
    s.sql("CREATE TABLE t (k BIGINT) USING column")
    s.sql("INSERT INTO t VALUES (1)")
    fault.arm("wal.append", "torn_write", param=9, count=1)
    with pytest.raises(IOError):
        s.sql("INSERT INTO t VALUES (2)")     # torn: never applied
    ds = s.disk_store
    torn = ds.current_wal_seq()
    ds.wal_sync(force=True)                   # a barrier does not wedge
    with pytest.raises(IOError):
        ds.wal_sync(seq=torn)
    s.checkpoint()
    s.sql("INSERT INTO t VALUES (3)")
    s.disk_store.close()
    s2 = _session(d, recover=True)
    assert _keys(s2) == [1, 3]
    s2.disk_store.close()


def test_corrupt_tail_is_salvaged_and_counted(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "always")
    d = str(tmp_path)
    s = _session(d)
    s.sql("CREATE TABLE t (k BIGINT) USING column")
    for k in range(4):
        s.sql(f"INSERT INTO t VALUES ({k})")
    s.disk_store.close()
    path = os.path.join(d, "wal.log")
    with open(path, "rb") as fh:
        offsets = []
        gen = read_records(fh)
        for _ in gen:
            offsets.append(fh.tell())
    # flip a byte inside the last record's body: a CRC mismatch
    with open(path, "rb+") as fh:
        fh.seek(offsets[-2] + 12)
        b = fh.read(1)
        fh.seek(offsets[-2] + 12)
        fh.write(bytes([b[0] ^ 0xFF]))
    before = global_registry().counter("wal_corrupt_records")
    s2 = _session(d, recover=True)
    assert global_registry().counter("wal_corrupt_records") == before + 1
    assert os.path.getsize(path + ".corrupt") > 0
    assert _keys(s2) == [0, 1, 2]
    s2.sql("INSERT INTO t VALUES (9)")
    s2.disk_store.close()
    s3 = _session(d, recover=True)
    assert _keys(s3) == [0, 1, 2, 9]
    s3.disk_store.close()


def test_truncation_at_every_offset_of_the_last_record(tmp_path,
                                                       wal_knobs):
    """A log cut anywhere inside its last record replays every record
    before it and never raises."""
    wal_knobs.set("wal_fsync_mode", "always")
    src = str(tmp_path / "src")
    ds = DiskStore(src)
    for i in range(3):
        ds.wal_append("t", "insert", arrays=[np.arange(i + 1)])
    ds.close()
    with open(os.path.join(src, "wal.log"), "rb") as fh:
        raw = fh.read()
    with open(os.path.join(src, "wal.log"), "rb") as fh:
        ends = []
        for _ in read_records(fh):
            ends.append(fh.tell())
    for cut in range(ends[-2], ends[-1], 7):
        d = tmp_path / f"cut{cut}"
        d.mkdir()
        (d / "tables").mkdir()
        with open(d / "wal.log", "wb") as fh:
            fh.write(raw[:cut])
        DiskStore(str(d)).close()            # boot-time salvage
        assert _seqs(str(d)) == [1, 2]


def test_concurrent_committers_coalesce_and_recover(tmp_path, wal_knobs):
    wal_knobs.set("wal_fsync_mode", "group")
    wal_knobs.set("wal_group_ms", 2.0)
    d = str(tmp_path)
    s = _session(d)
    s.sql("CREATE TABLE t (k BIGINT) USING column")
    before_f = global_registry().counter("wal_fsync_count")
    before_g = global_registry().counter("wal_group_commit_batches")

    def worker(w):
        for i in range(25):
            s.sql(f"INSERT INTO t VALUES ({w * 100 + i})")

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    fsyncs = global_registry().counter("wal_fsync_count") - before_f
    assert global_registry().counter("wal_group_commit_batches") - \
        before_g == fsyncs
    assert 1 <= fsyncs <= 100
    # crash shape: a second session on the open directory
    s2 = _session(d, recover=True)
    assert _keys(s2) == sorted(w * 100 + i for w in range(4)
                               for i in range(25))
    s2.disk_store.close()
    s.disk_store.close()


def test_torn_checkpoint_write_keeps_the_previous_state(tmp_path, wal_knobs):
    """A crash mid-write of a checkpoint artifact (one registry: `fault`
    re-exports `reliability.failpoints`) leaves the un-rotated WAL and
    the previous artifact authoritative."""
    d = str(tmp_path)
    s = _session(d)
    s.sql("CREATE TABLE t (k BIGINT) USING column")
    s.sql("INSERT INTO t VALUES (1), (2)")
    s.checkpoint()
    s.sql("INSERT INTO t VALUES (3)")
    before = global_registry().counter("fault_injected_checkpoint_write")
    fault.arm("checkpoint.write", "torn_write", param=7, count=1)
    with pytest.raises(fault.InjectedFault, match="torn write"):
        s.checkpoint()
    assert global_registry().counter(
        "fault_injected_checkpoint_write") == before + 1
    assert fault.failpoints.fired_counts() == {"checkpoint.write": 1}
    s.sql("INSERT INTO t VALUES (4)")
    s.disk_store.close()
    s2 = _session(d, recover=True)
    assert _keys(s2) == [1, 2, 3, 4]
    s2.disk_store.close()


def test_seeded_schedule_replays(wal_knobs):
    def schedule(seed):
        fault.clear()
        fault.reseed(seed)
        fault.arm("wal.append", "sleep", param=0.0, prob=0.3)
        out = []
        for _ in range(64):
            before = sum(fault.failpoints.fired_counts().values())
            fault.hit("wal.append")
            out.append(sum(fault.failpoints.fired_counts().values())
                       - before)
        return out

    a, b, c = schedule(11), schedule(11), schedule(12)
    assert a == b and a != c
    assert 5 < sum(a) < 40


def test_unknown_action_or_family_is_refused():
    with pytest.raises(ValueError, match="unknown failpoint action"):
        fault.arm("wal.append", "drop")
    with pytest.raises(ValueError, match="unknown exc family"):
        fault.arm("wal.append", "raise", exc="conn")
    assert fault.hit("wal.append") is None


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_group_size_is_capped_by_the_committers(tmp_path, pkg, wal_knobs):
    """Both packages append AND apply under the store's mutation lock and
    sync outside it, so a committer holds at most one unsynced record: an
    fsync covers at most one record per committing thread."""
    if pkg == "port":
        s = _session(str(tmp_path))
        reg = global_registry()
    else:
        from snappydata_tpu import SnappySession as RefSession
        from snappydata_tpu import config as ref_config
        from snappydata_tpu.catalog import Catalog as RefCatalog
        from snappydata_tpu.observability.metrics import \
            global_registry as ref_registry

        ref_props = ref_config.global_properties()
        saved = ref_props.wal_fsync_mode
        ref_props.wal_fsync_mode = "group"
        s = RefSession(catalog=RefCatalog(), data_dir=str(tmp_path),
                       recover=False)
        reg = ref_registry()
    wal_knobs.set("wal_fsync_mode", "group")
    try:
        s.sql("CREATE TABLE t (k BIGINT) USING column")
        threads, per = 4, 25
        f0 = reg.counter("wal_fsync_count")

        def worker(w):
            for i in range(per):
                s.sql(f"INSERT INTO t VALUES ({w * 100 + i})")

        ts = [threading.Thread(target=worker, args=(w,))
              for w in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        fsyncs = reg.counter("wal_fsync_count") - f0
        # each group holds at most `threads` records
        assert per <= fsyncs <= threads * per
        assert s.sql("SELECT count(*) FROM t").rows()[0][0] == threads * per
    finally:
        s.disk_store.close()
        if pkg != "port":
            ref_props.wal_fsync_mode = saved
