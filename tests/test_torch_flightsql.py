"""Flight SQL through the port (snappydata_tpu_torch/cluster/flightsql.py
and the server's Flight SQL dispatch): every case of the reference's
tests/test_flightsql.py and tests/test_flightsql_golden.py, and the two
Flight SQL cases of tests/test_serving.py, run against the port's server
and codec with the reference's assertions (`torch_parity.port_cases`),
then the reference's Flight SQL client against the port's server and the
port's client against the reference's server, each giving the Arrow
table, schema included, that the same package pair of one side gives."""

import threading

import numpy as np
import pytest

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          port_cases, stop_flight)

globals().update(port_cases("test_flightsql.py", [
    "test_wire_codec_roundtrip", "server", "client",
    "test_statement_query", "test_grouped_query_with_strings",
    "test_get_catalogs_and_schemas", "test_get_tables",
    "test_execute_update", "test_execute_update_ddl_reports_unknown_count",
    "test_get_tables_type_filter",
    "test_decimal_overflow_fallback_exports_over_flight",
    "test_prepared_statement", "test_auth_enforced"]))

globals().update(port_cases("test_flightsql_golden.py", [
    "test_codec_decodes_official_bytes", "test_codec_encodes_byte_identical",
    "test_any_pack_unpack_matches_official",
    "test_fixture_provenance_official_runtime"]))

globals().update(port_cases("test_serving.py", [
    "serving_session", "test_flightinfo_peek_does_not_churn_registry",
    "test_flightsql_prepared_second_execute_is_serving_hit"]))


# -- cross-package pairs -------------------------------------------------

QUERIES = (
    "SELECT count(*) AS c, sum(v) AS sv FROM x_t",
    "SELECT name, count(*) AS c, min(v) AS lo FROM x_t GROUP BY name "
    "ORDER BY name",
    "SELECT k, name, v FROM x_t WHERE k < 40 ORDER BY k",
    "SELECT sum(d) AS sd FROM x_t WHERE k < 1000",
)


def _serve(pkg):
    """A loaded session of package `pkg` ("ref" or "port") behind its own
    Flight server on 127.0.0.1, port 0."""
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
    s.sql("CREATE TABLE x_t (k BIGINT, name STRING, v DOUBLE, "
          "d DECIMAL(12,2)) USING column")
    rng = np.random.default_rng(3)
    n = 3000
    s.insert_arrays("x_t", [
        np.arange(n, dtype=np.int64),
        np.array(["n%d" % (i % 5) for i in range(n)], dtype=object),
        np.round(rng.random(n) * 100, 2),
        np.round(rng.random(n) * 1000, 2)])
    srv = SnappyFlightServer(s)
    threading.Thread(target=srv.serve, daemon=True).start()
    srv.wait_ready()
    return s, srv


@pytest.fixture(scope="module")
def servers():
    out = {pkg: _serve(pkg) for pkg in ("ref", "port")}
    yield out
    for s, srv in out.values():
        stop_flight(srv)
        s.stop()


def _fsql_client(pkg, port):
    if pkg == "ref":
        from snappydata_tpu.cluster.flightsql import FlightSqlClient
    else:
        from snappydata_tpu_torch.cluster.flightsql import FlightSqlClient
    return FlightSqlClient(f"127.0.0.1:{port}")


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("ref", "port"), ("port", "ref")])
def test_flightsql_cross_package(servers, client_pkg, server_pkg):
    """A client of one package against the other's server gives the
    Arrow table (schema included) that the server's own package's client
    gives against it: statements, GetTables and a prepared statement."""
    port = servers[server_pkg][1].actual_port
    cross = _fsql_client(client_pkg, port)
    same = _fsql_client(server_pkg, port)
    try:
        for q in QUERIES:
            a, b = cross.execute(q), same.execute(q)
            assert a.schema == b.schema, q
            assert a.equals(b), q
        a, b = cross.get_tables(pattern="x_%", include_schema=True), \
            same.get_tables(pattern="x_%", include_schema=True)
        assert a.equals(b)
        pa_, pb_ = cross.prepare("SELECT count(*) AS c FROM x_t WHERE k < ?"), \
            same.prepare("SELECT count(*) AS c FROM x_t WHERE k < ?")
        for bound in (10, 2000):
            ta, tb = pa_.execute([bound]), pb_.execute([bound])
            assert ta.equals(tb) and ta.column("c")[0].as_py() == bound
        pa_.close()
        pb_.close()
    finally:
        cross.close()
        same.close()


def test_flightsql_same_answers_from_both_servers(servers):
    """The port's server answers every query with the Arrow table the
    reference's server gives, through one client package."""
    ref = _fsql_client("ref", servers["ref"][1].actual_port)
    port = _fsql_client("ref", servers["port"][1].actual_port)
    try:
        for q in QUERIES:
            a, b = port.execute(q), ref.execute(q)
            assert a.schema == b.schema, q
            for name in a.column_names:
                got = a.column(name).to_pylist()
                want = b.column(name).to_pylist()
                if a.schema.field(name).type == "double":
                    assert got == pytest.approx(want, rel=1e-9), q
                else:
                    assert got == want, q
    finally:
        ref.close()
        port.close()
