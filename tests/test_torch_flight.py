"""The Flight front door through the port (snappydata_tpu_torch/cluster/
flight_server.py, client.py, retry.py; `reliability.is_retryable`): the
cases of the reference's tests/test_client_catalog.py,
tests/test_streamed_query.py and tests/test_network_security.py, its
`test_concurrency.py::test_concurrent_flight_clients` on one server, the
Flight cases of tests/test_auth_providers.py (the in-process LDAP server
among them), `test_matviews.py::test_flight_do_put_into_backing_table_refused`
and the backoff / breaker units of tests/test_failpoints.py, each run
against the port with the reference's assertions
(`torch_parity.port_cases`); then `is_retryable` against the
reference's over one list of errors, and the reference's `SnappyClient`
against the port's server and the port's against the reference's: the
same Arrow tables, schemas included, mutations deduplicated, deadlines
typed; then the seven bucket actions of each package's server, which
answer alike."""

import errno
import json
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight
import pytest

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          port_cases, stop_flight)

globals().update(port_cases("test_client_catalog.py", [
    "test_client_catalog_discovery_and_cache",
    "test_client_catalog_respects_auth"]))

globals().update(port_cases("test_streamed_query.py", [
    "served", "test_select_star_streams_per_scan_unit",
    "test_filter_and_projection_stream", "test_limit_early_exit",
    "test_question_mark_params_bind_positionally",
    "test_aggregates_and_sorts_keep_materialized_path",
    "test_stream_respects_row_level_policy"]))

globals().update(port_cases("test_network_security.py", [
    "test_do_put_nulls_survive_recovery",
    "test_do_put_then_checkpoint_no_duplicates",
    "test_exec_python_refused_over_network_without_auth",
    "test_flight_token_auth_and_principals",
    "test_rest_jobs_require_token_when_configured",
    "test_recovery_replays_statement_reading_a_view"]))

# one server on 127.0.0.1 in place of the reference's locator + server
# node (the case as the reference wrote it runs in test_torch_cluster.py)
globals().update(port_cases("test_concurrency.py", [
    "test_concurrent_flight_clients"], edits=[
    ("""    from snappydata_tpu.cluster.node import LocatorNode, ServerNode

    locator = LocatorNode().start()
    server = ServerNode(locator.address,
                        SnappySession(catalog=Catalog())).start()
""", """    from snappydata_tpu.cluster.flight_server import SnappyFlightServer

    server = SnappyFlightServer(SnappySession(catalog=Catalog()))
    threading.Thread(target=server.serve, daemon=True).start()
    server.wait_ready()
    server.flight_address = f"127.0.0.1:{server.port}"
"""),
    ("""        server.stop()
        locator.stop()""", """        server.shutdown()""")]))

globals().update(port_cases("test_auth_providers.py", [
    "ldap_server", "test_flight_login_with_builtin_provider",
    "test_flight_login_with_ldap_provider",
    "test_expired_login_token_triggers_transparent_relogin",
    "test_internal_cluster_token_accepted_as_node_principal"]))

globals().update(port_cases("test_matviews.py", [
    "test_flight_do_put_into_backing_table_refused"]))

globals().update(port_cases("test_failpoints.py", [
    "test_backoff_growth_and_cap", "test_backoff_jitter_bounded_and_seeded",
    "test_circuit_breaker_stale_half_open_probe_recovers",
    "test_circuit_breaker_lifecycle"], edits=[
    ("""from snappydata_tpu.fault.failpoints import (FailpointRegistry,
                                             FaultConnectionDropped,
                                             FaultError)
""", "")]))


# -- the typed retry contract ------------------------------------------------

def _errors(pkg):
    if pkg == "ref":
        from snappydata_tpu.cluster.distributed import (
            DistributedError, DistributedUnsupported)
        from snappydata_tpu.resource.context import CancelException
    else:
        from snappydata_tpu_torch.cluster.distributed import (
            DistributedError, DistributedUnsupported)
        from snappydata_tpu_torch.resource.context import CancelException
    return [
        CancelException("deadline"),
        flight.FlightTimedOutError("t"),
        flight.FlightUnavailableError("u"),
        flight.FlightCancelledError("c"),
        flight.FlightUnauthenticatedError("a"),
        flight.FlightServerError("s"),
        ConnectionError("reset"),
        TimeoutError("slow"),
        OSError(errno.EIO, "eio"),
        OSError(errno.ENOENT, "missing"),
        ValueError("bad sql"),
        PermissionError("denied"),
        DistributedError("member lost", ["h:1"], 2),
        DistributedUnsupported("over the gather budget"),
    ]


def test_is_retryable_matches_reference():
    from snappydata_tpu import reliability as ref_rel
    from snappydata_tpu_torch import reliability

    got = [reliability.is_retryable(e) for e in _errors("port")]
    want = [ref_rel.is_retryable(e) for e in _errors("ref")]
    assert got == want
    assert got == [False, False, True, True, False, False, True, True,
                   True, False, False, False, True, True]


def test_retry_metrics_and_breaker_skip_dead_member():
    """A client whose breaker is open for a dead address skips it, and
    the backoff and breaker metrics are the reference's names."""
    from snappydata_tpu_torch.cluster.client import SnappyClient
    from snappydata_tpu_torch.cluster.retry import CircuitBreaker
    from snappydata_tpu_torch.observability.metrics import global_registry

    reg = global_registry()
    before = reg.counter("breaker_open")
    cb = CircuitBreaker(failure_threshold=1, reset_timeout_s=60.0)
    cb.record_failure()
    assert cb.state == CircuitBreaker.OPEN
    assert reg.counter("breaker_open") == before + 1
    c = SnappyClient(address="127.0.0.1:1")
    with pytest.raises(ConnectionError):
        c.sql("SELECT 1")


# -- the bucket actions -------------------------------------------------------

BUCKET_ACTIONS = ("repartition", "promote", "replicate", "purge_replica",
                  "purge_buckets", "demote", "move_buckets")


def test_membership_surfaces_raise():
    """A client told of a locator that does not answer raises as the
    reference's does; the seven bucket actions answer as the reference's
    on a server of each package given the same rows and body (here with
    no replica shadow and a peer of the same package).  (The name is
    kept from the slice before the distributed session, when the bucket
    actions raised.)"""
    from snappydata_tpu_torch.cluster.client import SnappyClient

    with pytest.raises(ConnectionError):
        SnappyClient(locator="127.0.0.1:1")
    got = {}
    for pkg in ("ref", "port"):
        pair = [_serve(pkg) for _ in range(2)]
        for s, _srv in pair:
            s.sql("CREATE TABLE mb (k BIGINT, v DOUBLE) USING column")
            s.sql("CREATE TABLE mb_dest (k BIGINT, v DOUBLE) USING column")
            s.sql("CREATE TABLE mb__replica (k BIGINT, v DOUBLE) "
                  "USING column")
            s.insert_arrays("mb", [np.arange(64, dtype=np.int64),
                                   np.arange(64) * 0.5])
        addrs = [f"127.0.0.1:{srv.port}" for _s, srv in pair]
        c = _client(pkg, pair[0][1].port)
        try:
            out = []
            for name in BUCKET_ACTIONS:
                body = {"table": "mb", "key": "k", "buckets": [0, 1],
                        "num_buckets": 4, "target": addrs[1]}
                if name == "repartition":
                    body.update(dest="mb_dest", servers=addrs)
                out.append((name, json.loads(json.dumps(
                    c._action(name, body, retry=False)))))
            out.append([s.sql("SELECT count(*), sum(v) FROM mb").rows()
                        for s, _srv in pair])
            got[pkg] = out
        finally:
            c.close()
            for s, srv in pair:
                stop_flight(srv)
                s.stop()
    assert got["port"] == got["ref"]
    assert dict(got["port"][:-1])["repartition"]["rows"] == 64


def test_default_session_needs_a_card():
    """A server built over the port's default session runs on the card:
    without one the session raises instead of serving from the CPU."""
    import torch

    from snappydata_tpu_torch import SnappySession

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default session is on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        SnappySession(device="cuda")


# -- cross-package client / server pairs --------------------------------------

def _serve(pkg, **kw):
    if pkg == "ref":
        from snappydata_tpu import SnappySession
        from snappydata_tpu.catalog import Catalog
        from snappydata_tpu.cluster.flight_server import SnappyFlightServer
        s = SnappySession(catalog=Catalog())
    else:
        from snappydata_tpu_torch import SnappySession
        from snappydata_tpu_torch.catalog import Catalog
        from snappydata_tpu_torch.cluster.flight_server import \
            SnappyFlightServer
        s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE li (l_orderkey BIGINT, l_quantity DOUBLE, "
          "l_extendedprice DOUBLE, l_discount DOUBLE, l_returnflag STRING, "
          "l_linestatus STRING, l_tax DECIMAL(12,2)) USING column")
    rng = np.random.default_rng(11)
    n = 4096
    s.insert_arrays("li", [
        np.arange(n, dtype=np.int64),
        rng.integers(1, 51, n).astype(np.float64),
        np.round(rng.random(n) * 1e4, 2),
        np.round(rng.integers(0, 11, n) / 100.0, 2),
        np.array(["ANR"[i % 3] for i in range(n)], dtype=object),
        np.array(["OF"[i % 2] for i in range(n)], dtype=object),
        np.round(rng.random(n) * 100, 2)])
    srv = SnappyFlightServer(s, **kw)
    threading.Thread(target=srv.serve, daemon=True).start()
    srv.wait_ready()
    return s, srv


def _client(pkg, port, **kw):
    if pkg == "ref":
        from snappydata_tpu.cluster.client import SnappyClient
    else:
        from snappydata_tpu_torch.cluster.client import SnappyClient
    return SnappyClient(address=f"127.0.0.1:{port}", **kw)


PAIR_QUERIES = (
    # Q6's shape
    "SELECT sum(l_extendedprice * l_discount) AS revenue FROM li "
    "WHERE l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24",
    # Q1's shape
    "SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty, "
    "avg(l_extendedprice) AS avg_price, sum(l_tax) AS sum_tax, "
    "count(*) AS count_order FROM li GROUP BY l_returnflag, l_linestatus "
    "ORDER BY l_returnflag, l_linestatus",
    # a streamed scan with its early stop
    "SELECT l_orderkey, l_extendedprice FROM li WHERE l_quantity < 5 "
    "LIMIT 50",
    "SELECT l_orderkey, l_tax FROM li WHERE l_orderkey < ? ORDER BY "
    "l_orderkey",
)


@pytest.fixture(scope="module")
def pair_servers():
    out = {pkg: _serve(pkg) for pkg in ("ref", "port")}
    yield out
    for s, srv in out.values():
        stop_flight(srv)
        s.stop()


def _sql(c, q):
    return c.sql(q, params=[20] if "?" in q else [])


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("ref", "port"), ("port", "ref")])
def test_client_server_cross_package(pair_servers, client_pkg, server_pkg):
    """Each package's client against the other's server gives the Arrow
    table, schema included, the server's own client gives; the catalog
    protocol and the action surface agree too."""
    port = pair_servers[server_pkg][1].port
    cross, same = _client(client_pkg, port), _client(server_pkg, port)
    try:
        for q in PAIR_QUERIES:
            a, b = _sql(cross, q), _sql(same, q)
            assert a.schema == b.schema, q
            assert a.equals(b), q
            a, b = cross.sql(q, params=[20] if "?" in q else [],
                             prepared=True), _sql(same, q)
            assert a.equals(b), q
        assert cross.describe("li") == same.describe("li")
        assert cross.execute("SELECT count(*) FROM li") == \
            same.execute("SELECT count(*) FROM li")
        cross.ping()
        reader = cross.scan_table("li")
        assert reader.read_all().num_rows == \
            pair_servers[server_pkg][0].sql(
                "SELECT count(*) FROM li").rows()[0][0]
    finally:
        cross.close()
        same.close()


def test_port_server_answers_as_the_reference_server(pair_servers):
    """Through one client, the port's server gives the reference's Arrow
    tables: exact columns equal, float sums within the parity bar."""
    ref = _client("ref", pair_servers["ref"][1].port)
    port = _client("ref", pair_servers["port"][1].port)
    try:
        for q in PAIR_QUERIES:
            a, b = _sql(port, q), _sql(ref, q)
            assert a.schema == b.schema, q
            for name in a.column_names:
                got = a.column(name).to_pylist()
                want = b.column(name).to_pylist()
                if pa.types.is_floating(a.schema.field(name).type):
                    assert got == pytest.approx(want, rel=1e-9), q
                else:
                    assert got == want, q
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("ref", "port"), ("port", "ref")])
def test_cross_package_insert_dedup_and_deadline(client_pkg, server_pkg):
    """do_put across packages lands every row once, a re-sent statement
    id is deduplicated by the server, and a deadline that expires during
    a stalled request comes back typed (XCL52), not as a raw Flight
    error."""
    s, srv = _serve(server_pkg)
    c = _client(client_pkg, srv.port)
    try:
        c.execute("CREATE TABLE dd (k BIGINT, v DOUBLE) USING column")
        t = pa.table({"k": pa.array(np.arange(1000), type=pa.int64()),
                      "v": pa.array(np.ones(1000))})
        c.insert("dd", t, stmt_id="fixed-id")
        c.insert("dd", t, stmt_id="fixed-id")   # a lost-ack re-send
        got = c.sql("SELECT count(*) AS n, sum(v) AS sv FROM dd")
        assert got.column(0)[0].as_py() == 1000
        assert got.column(1)[0].as_py() == pytest.approx(1000.0)
        c.execute("INSERT INTO dd VALUES (5000, 2.0)", stmt_id="ins-1")
        c.execute("INSERT INTO dd VALUES (5000, 2.0)", stmt_id="ins-1")
        assert c.sql("SELECT count(*) FROM dd").column(0)[0].as_py() == 1001
        if server_pkg == "ref":
            from snappydata_tpu import fault
        else:
            from snappydata_tpu_torch import fault
        if client_pkg == "ref":
            from snappydata_tpu.resource.context import CancelException
        else:
            from snappydata_tpu_torch.resource.context import \
                CancelException
        fault.arm("flight.serve", "latency", param=1.5, count=1)
        try:
            t0 = time.time()
            with pytest.raises(CancelException, match="XCL52"):
                c.sql("SELECT count(*) FROM dd", timeout_s=0.3)
            assert time.time() - t0 < 1.4
        finally:
            fault.clear()
        assert c.sql("SELECT count(*) FROM dd").column(0)[0].as_py() == 1001
    finally:
        c.close()
        stop_flight(srv)
        s.stop()


def test_handlers_enter_the_server_session_device(pair_servers):
    """Flight handlers run on gRPC threads that pyarrow started: the
    port's server enters its session's device scope there (the scope is
    None on a fresh thread), so a served query or a put is planned and
    encoded for the session's device, not a thread default."""
    from snappydata_tpu_torch import config

    s, srv = pair_servers["port"]
    seen = []
    orig_for_user, orig_journal = s.for_user, s._journal_then

    def for_user(*a, **kw):
        seen.append(("get", config.current_device()))
        return orig_for_user(*a, **kw)

    def journal(*a, **kw):
        seen.append(("put", config.current_device()))
        return orig_journal(*a, **kw)

    s.for_user, s._journal_then = for_user, journal
    c = _client("port", srv.port)
    try:
        c.sql(PAIR_QUERIES[0])
        c.execute("CREATE TABLE IF NOT EXISTS dv (k BIGINT) USING column")
        c.insert("dv", {"k": np.arange(3, dtype=np.int64)})
    finally:
        del s.for_user, s._journal_then
        c.close()
    assert {k for k, _ in seen} == {"get", "put"}
    assert all(d == s.device for _, d in seen), seen


def test_arrow_to_arrays_matches_reference():
    """The put path's Arrow-to-numpy step gives the reference's arrays,
    dtypes and null masks (strings and masks are built in Arrow)."""
    from snappydata_tpu.cluster.flight_server import \
        arrow_to_arrays as ref_arrow_to_arrays
    from snappydata_tpu_torch.cluster.flight_server import arrow_to_arrays

    t = pa.table({
        "s": pa.array(["a", None, "c", ""]),
        "i": pa.array([1, None, 3, 4], pa.int64()),
        "f": pa.array([1.5, 2.5, None, 0.0]),
        "n": pa.array([7, 8, 9, 10], pa.int32()),
        "d": pa.array([None, 1, 2, 3], pa.decimal128(12, 2))})
    got, want = arrow_to_arrays(t), ref_arrow_to_arrays(t)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype
        assert [None if x is None else x for x in g.tolist()] == w.tolist()
    for g, w in zip(got[1], want[1]):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.tolist() == w.tolist()
