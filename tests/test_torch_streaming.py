"""Streaming through the port (snappydata_tpu_torch/streaming/ and the
session's stream tables): every case of the reference's
tests/test_streaming.py, tests/test_stream_ddl.py,
tests/test_kafka_stream.py and tests/test_kafka_confluent.py (the
Confluent library faked as the reference fakes it; the live-broker case
is the reference's endurance test) and
`test_matviews.py::test_streaming_sink_folds_deltas`, run against the
port with the reference's assertions (`torch_parity.port_cases`); then
one stream fed the same micro-batches in both packages (rows, Q1 / Q6
shapes and a window equal), a stream a reference session recorded
re-registered by a port session, and the warm windowed query's plan
cache hit."""

import json
import re
import time

import numpy as np
import pytest

from torch_parity import (TESTS_DIR, _ledger_per_test,  # noqa: F401
                          front_door_env, port_cases)


@pytest.fixture()
def s():
    """The port's session of the reference's two `s` fixtures in one:
    tests/test_streaming.py's (a keyed row table `target`) and
    tests/test_stream_ddl.py's (stream queries stopped at teardown)."""
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    sess = SnappySession(catalog=Catalog(), device="cpu")
    sess.sql("CREATE TABLE target (k INT PRIMARY KEY, v STRING) USING row")
    yield sess
    for q in getattr(sess.catalog, "_streams", {}).values():
        q.stop()
    sess.stop()


@pytest.fixture()
def session():
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    sess = SnappySession(catalog=Catalog(), device="cpu")
    yield sess
    sess.stop()


globals().update(port_cases("test_streaming.py", [
    "test_sink_basic_and_duplicate_batch", "test_sink_cdc_event_types",
    "test_sink_conflation_last_event_wins",
    "test_state_table_shared_across_queries",
    "test_streaming_query_resume_after_restart",
    "test_streaming_into_column_table_with_keys", "test_file_source",
    "test_background_thread_drains"]))

globals().update(port_cases("test_stream_ddl.py", [
    "test_memory_stream_table", "test_file_stream_table",
    "test_failed_stream_create_leaves_no_orphan",
    "test_if_not_exists_keeps_running_query",
    "test_poison_file_does_not_wedge", "test_stream_survives_restart",
    "test_drop_table_clears_topk_for_recovery",
    "test_drop_stream_table_stops_query", "test_windowed_sql_over_stream",
    "test_streaming_progress_and_rest_endpoint"]))

# the consumer process runs the port on the CPU, from this checkout
globals().update(port_cases("test_kafka_stream.py", [
    "test_basic_consumption_and_offsets",
    "test_replay_same_ranges_after_crash_before_apply",
    "test_duplicate_batch_not_double_applied",
    "test_offset_log_pruned_after_apply", "test_kafka_stream_ddl",
    "test_throughput_floor", "test_kill9_exactly_once_across_process_death",
], edits=[
    ('import jax; jax.config.update("jax_platforms", "cpu")\n', ""),
    ("s = SnappySession(data_dir={d!r})",
     's = SnappySession(data_dir={d!r}, device="cpu")'),
    (re.compile(r'"PYTHONPATH": "[^"]*"'),
     '"PYTHONPATH": __import__("os").path.dirname(_TESTS_DIR)'),
    ("import numpy as np\n", f"import numpy as np\n_TESTS_DIR = {TESTS_DIR!r}\n"),
]))

globals().update(port_cases("test_kafka_confluent.py", [
    "fake_confluent", "test_adapter_config_contract",
    "test_partitions_and_end_offset", "test_fetch_range_eof_and_stragglers",
    "test_fetch_decodes_non_json_and_scalar_payloads",
    "test_fetch_surfaces_broker_errors",
    "test_partitions_fails_loudly_on_missing_topic",
    "test_fetch_offset_bounded_with_gaps",
    "test_fetch_timeout_is_retryable_not_data_loss",
    "test_fetch_deadline_is_progress_based",
    "test_fetch_detects_retention_expiry",
    "test_resolve_broker_routes_bootstrap_servers",
    "test_resolve_broker_without_library",
    "test_source_exactly_once_over_adapter", "test_live_broker_roundtrip"]))

globals().update(port_cases("test_matviews.py", [
    "test_streaming_sink_folds_deltas"]))


# -- both packages, one stream ------------------------------------------------

def _session(pkg, **kw):
    if pkg == "ref":
        from snappydata_tpu import SnappySession
        from snappydata_tpu.catalog import Catalog
        return SnappySession(catalog=Catalog(), **kw)
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    return SnappySession(catalog=Catalog(), device="cpu", **kw)


def _batches(n_batches=6, rows=500):
    rng = np.random.default_rng(9)
    out = []
    for b in range(n_batches):
        base = b * rows
        out.append({
            "l_orderkey": np.arange(base, base + rows, dtype=np.int64),
            "l_quantity": rng.integers(1, 51, rows).astype(np.float64),
            "l_extendedprice": np.round(rng.random(rows) * 1e4, 2),
            "l_discount": np.round(rng.integers(0, 11, rows) / 100.0, 2),
            "l_returnflag": np.array(["ANR"[i % 3] for i in range(rows)],
                                     dtype=object),
            "l_linestatus": np.array(["OF"[i % 2] for i in range(rows)],
                                     dtype=object)})
    return out


STREAM_DDL = ("CREATE STREAM TABLE ls (l_orderkey BIGINT, l_quantity DOUBLE, "
              "l_extendedprice DOUBLE, l_discount DOUBLE, l_returnflag "
              "STRING, l_linestatus STRING) USING memory_stream OPTIONS "
              "(key_columns 'l_orderkey', interval '0.01')")
STREAM_QUERIES = (
    "SELECT sum(l_extendedprice * l_discount) AS revenue FROM ls "
    "WHERE l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24",
    "SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sq, "
    "avg(l_extendedprice) AS ap, count(*) AS c FROM ls "
    "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, "
    "l_linestatus",
    "SELECT count(*), sum(l_extendedprice * l_discount) FROM ls "
    "WINDOW (DURATION 1 MINUTES) WHERE l_quantity < 24",
    "SELECT * FROM ls WHERE l_orderkey < 5 ORDER BY l_orderkey",
)


def _wait(sess, table, n, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if sess.sql(f"SELECT count(*) FROM {table}").rows()[0][0] >= n:
            return
        time.sleep(0.02)
    raise AssertionError(f"{table}: fewer than {n} rows after {timeout} s")


def test_stream_table_matches_reference():
    """The same micro-batches through a memory stream in both packages:
    Q6 / Q1 shapes, a window and SELECT * give the reference's rows (the
    hidden arrival column stays hidden), and the progress fields agree."""
    from torch_parity import assert_rows_equal

    batches = _batches()
    total = sum(len(b["l_orderkey"]) for b in batches)
    results, progress = {}, {}
    for pkg in ("ref", "port"):
        sess = _session(pkg)
        sess.sql(STREAM_DDL)
        src = sess.stream_source("ls")
        for b in batches:
            src.add_batch(b)
        _wait(sess, "ls", total)
        results[pkg] = [sess.sql(q).rows() for q in STREAM_QUERIES]
        progress[pkg] = sess.streaming_queries()[0]
        sess.sql("DROP TABLE ls")
        sess.stop()
    for got, want in zip(results["port"], results["ref"]):
        assert_rows_equal(got, want, 1e-9)
    q = np.concatenate([b["l_quantity"] for b in batches])
    assert results["port"][2][0][0] == int((q < 24).sum())
    assert sum(r[4] for r in results["port"][1]) == total
    for key in ("name", "table", "rows_processed", "last_batch_id",
                "last_error"):
        assert progress["port"][key] == progress["ref"][key], key


def test_warm_window_query_hits_the_plan_cache():
    """The window's cutoff is a rebindable literal: a warm windowed query
    reuses the compiled plan (no plan-cache miss), as the reference's."""
    from snappydata_tpu_torch.observability.metrics import global_registry

    sess = _session("port")
    try:
        sess.sql(STREAM_DDL)
        src = sess.stream_source("ls")
        for b in _batches(2):
            src.add_batch(b)
        _wait(sess, "ls", 1000)
        # the stream holds still for the two windowed runs
        sess.catalog._streams["ls"].stop()
        q = STREAM_QUERIES[2]
        first = sess.sql(q).rows()
        misses = global_registry().counter("plan_cache_misses")
        time.sleep(0.01)
        assert sess.sql(q).rows() == first
        assert global_registry().counter("plan_cache_misses") == misses
    finally:
        sess.stop()


def test_reference_stream_reregistered_by_port(tmp_path):
    """A durable directory a reference session wrote with a keyed kafka
    stream over a file broker: a port session recovers the rows and
    re-registers the feed, which goes on from the recorded offsets —
    every published row once."""
    from snappydata_tpu.streaming.kafka import FileBroker

    d, bdir = str(tmp_path / "data"), str(tmp_path / "broker")
    producer = FileBroker(bdir, num_partitions=2)
    producer.produce("ev", [{"id": i, "v": 1.0} for i in range(300)])
    ddl = ("CREATE STREAM TABLE ks (id BIGINT, v DOUBLE) USING kafka_stream "
           f"OPTIONS (topic 'ev', brokers 'file://{bdir}', "
           "key_columns 'id', interval '0.01')")
    ref = _session("ref", data_dir=d, recover=False)
    ref.sql(ddl)
    _wait(ref, "ks", 300)
    for q in ref.catalog._streams.values():
        q.stop()
    ref.disk_store.close()
    producer.produce("ev", [{"id": i, "v": 1.0} for i in range(300, 500)])
    from snappydata_tpu_torch import SnappySession

    port = SnappySession(data_dir=d, device="cpu")
    try:
        assert "ks" in port.catalog._streams
        _wait(port, "ks", 500)
        cnt, dcnt, sv = port.sql(
            "SELECT count(*), count(DISTINCT id), sum(v) FROM ks").rows()[0]
        assert (cnt, dcnt, sv) == (500, 500, 500.0)
    finally:
        for q in port.catalog._streams.values():
            q.stop()
        port.stop()
        port.disk_store.close()


def test_stream_ddl_recorded_like_reference(tmp_path):
    """The catalog entry a durable CREATE STREAM TABLE leaves is the
    reference's key and text, and DROP TABLE takes it out."""
    stmts = ("CREATE STREAM TABLE ms (a INT) USING memory_stream",)
    metas = {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        sess = _session(pkg, data_dir=str(d), recover=False)
        for q in stmts:
            sess.sql(q)
        with open(d / "catalog.json") as fh:
            metas[pkg] = json.load(fh)["aux_ddl"]
        sess.sql("DROP TABLE ms")
        with open(d / "catalog.json") as fh:
            assert "stream:ms" not in json.load(fh)["aux_ddl"]
        sess.disk_store.close()
    assert metas["port"] == metas["ref"] == {"stream:ms": stmts[0]}
