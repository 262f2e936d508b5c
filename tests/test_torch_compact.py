"""The compaction pass through both packages (after tests/test_compact.py).

The same table with update deltas, a delete mask and an undersized stub
batch is built in the reference and in the port (on the CPU); one forced
`run_compaction_pass` in each must fold the same batches into the same
number of clean batches, leave the same rows, and clear the table's
foldable compressed-domain fallbacks, so a re-run of the queries counts
no `compressed_fallback_deltas`.  On the port alone: a raced pass aborts
counted, a reader pinned across the rewrite keeps its snapshot, and the
`storage.compaction` failpoint before the publish leaves the old manifest
live.
"""

import dataclasses

import numpy as np
import pytest

from torch_parity import Pair, assert_rows_equal, counters

from snappydata_tpu import config as ref_config
from snappydata_tpu.storage import compact as ref_compact
from snappydata_tpu_torch import config
from snappydata_tpu_torch.observability.metrics import global_registry
from snappydata_tpu_torch.reliability import failpoints as rfail
from snappydata_tpu_torch.storage import compact, mvcc

QUERIES = ("SELECT count(*), sum(q), sum(v), sum(k) FROM ct",
           "SELECT q, count(*), sum(v) FROM ct GROUP BY q ORDER BY q")


@pytest.fixture(autouse=True)
def clean():
    """No background compaction in the reference (the pass under test
    runs by hand in both), small batches, and a clear failpoint
    registry."""
    props = (ref_config.global_properties(), config.global_properties())
    saved = [(p.compaction_enabled, p.column_batch_rows,
              p.column_max_delta_rows) for p in props]
    for p in props:
        p.compaction_enabled = False
        p.column_batch_rows = 1024
        p.column_max_delta_rows = 256
    rfail.clear()
    yield
    rfail.clear()
    for p, (c, rows, delta) in zip(props, saved):
        p.compaction_enabled, p.column_batch_rows, \
            p.column_max_delta_rows = c, rows, delta


def _pair(n=6000, seed=11):
    """Low-cardinality q, so every batch encodes compressibly; k is the
    self-verifying key (v == k * 0.5)."""
    pair = Pair("f64", routed=("host_fallbacks", "compressed_fallback_deltas",
                               "compressed_fallback_row_buffer",
                               "compressed_fallback_mixed_encoding"))
    pair.sql("CREATE TABLE ct (k BIGINT, q DOUBLE, v DOUBLE) USING column")
    rng = np.random.default_rng(seed)
    k = np.arange(n, dtype=np.int64)
    q = rng.choice(np.array([0.5, 1.25, 2.0, 3.75]), n)
    pair.insert_arrays("ct", [k, q, k * 0.5])
    for s in (pair.port, pair.ref):
        s.catalog.describe("ct").data.force_rollover()
    return pair


def _debris(pair):
    pair.sql("UPDATE ct SET q = 2.0 WHERE k < 40")
    pair.sql("DELETE FROM ct WHERE k >= 5900")
    pair.sql("INSERT INTO ct VALUES (100000, 1.25, 50000.0)")
    for s in (pair.port, pair.ref):
        s.catalog.describe("ct").data.force_rollover()


def _datas(pair):
    return (pair.port.catalog.describe("ct").data,
            pair.ref.catalog.describe("ct").data)


def test_pass_folds_debris_like_the_reference():
    pair = _pair()
    _debris(pair)
    before = [pair.run(q)[0] for q in QUERIES]
    port_data, ref_data = _datas(pair)
    assert compact.foldable_fallbacks(port_data) > 0
    c0 = counters(global_registry())
    out = compact.run_compaction_pass(port_data, force=True)
    ref_out = ref_compact.run_compaction_pass(ref_data, force=True)
    for key in ("rewritten", "produced", "skipped"):
        assert out[key] == ref_out[key], key
    assert out["rewritten"] > 0
    man = port_data.snapshot()
    assert all(not v.deltas and v.delete_mask is None for v in man.views)
    assert [v.batch.num_rows for v in man.views] == \
        [v.batch.num_rows for v in ref_data.snapshot().views]
    assert compact.foldable_fallbacks(port_data) == 0
    c1 = counters(global_registry())
    assert c1["compaction_passes"] == c0.get("compaction_passes", 0) + 1
    assert c1["compaction_batches_rewritten"] == \
        c0.get("compaction_batches_rewritten", 0) + out["rewritten"]
    # the same rows, and no delta fallback left on either side
    for q, want in zip(QUERIES, before):
        rows, moved = pair.run(q)
        assert_rows_equal(rows, want, 1e-9)
        assert moved["compressed_fallback_deltas"] == 0
    # a second pass declines, itemized, in both
    out2 = compact.run_compaction_pass(port_data, force=True)
    ref_out2 = ref_compact.run_compaction_pass(ref_data, force=True)
    assert out2["rewritten"] == 0 and out2["skipped"] == ref_out2["skipped"]


@pytest.mark.parametrize("action", ["raise", "kill_worker",
                                    "return_errno"])
def test_failpoint_before_publish_leaves_the_old_manifest(action):
    pair = _pair()
    _debris(pair)
    before = [pair.run(q)[0] for q in QUERIES]
    data, _ = _datas(pair)
    man0 = data.snapshot()
    ids0 = [id(v) for v in man0.views]
    rfail.arm("storage.compaction", action, count=1)
    with pytest.raises((OSError, rfail.WorkerKilled)):
        compact.run_compaction_pass(data, force=True)
    assert rfail.fired_counts().get("storage.compaction") == 1
    man1 = data.snapshot()
    assert man1.version == man0.version
    assert [id(v) for v in man1.views] == ids0
    assert [pair.run(q)[0] for q in QUERIES] == before
    rfail.clear()
    assert compact.run_compaction_pass(data, force=True)["rewritten"] > 0
    assert [pair.run(q)[0] for q in QUERIES] == before


def test_raced_pass_aborts_counted():
    """A concurrent mutation that replaces a selected view between the
    selection and the publish (simulated at the failpoint seam, under the
    table lock) makes the pass abort: publishing would resurrect the
    pre-mutation rows."""
    pair = _pair()
    _debris(pair)
    before = [pair.run(q)[0] for q in QUERIES]
    data, _ = _datas(pair)
    man0 = data.snapshot()

    def swap(name):
        if name != "storage.compaction":
            return
        cur = data._manifest
        views = (dataclasses.replace(cur.views[0]),) + cur.views[1:]
        data._manifest = dataclasses.replace(cur, views=views)

    orig = rfail.hit
    rfail.hit = swap
    try:
        raced0 = global_registry().counter("compaction_skip_raced")
        out = compact.run_compaction_pass(data, force=True)
    finally:
        rfail.hit = orig
    assert out["rewritten"] == 0 and out["skipped"]["raced"] > 0
    assert global_registry().counter("compaction_skip_raced") > raced0
    assert data.snapshot().version == man0.version
    assert [pair.run(q)[0] for q in QUERIES] == before


def test_pinned_reader_keeps_its_snapshot_across_a_pass():
    pair = _pair(n=8000)
    for r in range(3):
        pair.sql(f"UPDATE ct SET q = 3.75 WHERE k >= {r * 1000} "
                 f"AND k < {r * 1000 + 30}")
        pair.sql(f"DELETE FROM ct WHERE k = {7200 + r}")
    data, ref_data = _datas(pair)
    with mvcc.pinned_scope(pair.port.catalog, ["ct"]):
        pinned = pair.port.sql(QUERIES[0]).rows()
        pin_ver = mvcc.current_pin().manifest_for(data).version
        compact.run_compaction_pass(data, force=True)
        # inside the pin the statement still reads the old manifest
        assert pair.port.sql(QUERIES[0]).rows() == pinned
        assert mvcc.current_pin().manifest_for(data).version == pin_ver
    assert data.snapshot().version > pin_ver
    ref_compact.run_compaction_pass(ref_data, force=True)
    rows, _moved = pair.run(QUERIES[0])
    assert_rows_equal(rows, pinned, 1e-9)


def test_row_tables_and_clean_tables_are_skipped_itemized():
    pair = Pair("f64")
    pair.sql("CREATE TABLE r (k INT PRIMARY KEY, v DOUBLE) USING row")
    pair.sql("CREATE TABLE e (k INT) USING column")
    for name, reason in (("r", "row_table"), ("e", "empty_table")):
        c0 = global_registry().counter("compaction_skip_" + reason)
        out = compact.run_compaction_pass(
            pair.port.catalog.describe(name).data, force=True)
        ref_out = ref_compact.run_compaction_pass(
            pair.ref.catalog.describe(name).data, force=True)
        assert out == ref_out and out["skipped"] == {reason: 1}
        assert global_registry().counter("compaction_skip_" + reason) \
            == c0 + 1
    # disabled compaction declines unless forced
    config.global_properties().compaction_enabled = False
    out = compact.run_compaction_pass(pair.port.catalog.describe("e").data)
    assert out["skipped"] == {"disabled": 1}
