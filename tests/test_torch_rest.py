"""The REST surface through the port (snappydata_tpu_torch/cluster/rest.py):
the REST cases of the reference's tests/test_auth_providers.py,
test_observability.py (the traces endpoint, the dashboard, the error
body's trace id), test_matviews.py (the view snapshot), test_serving.py
(`POST /sql` through the serving registry), test_resource_governor.py
(`/queries`, cancel), test_group_commit.py (`/status/api/v1/wal`,
`/wal/flush`), test_failpoints.py (`/faults`), test_mvcc.py,
test_agg_strategy.py (`/status/api/v1/scan`), test_join_engine.py,
test_compressed_domain.py and test_ha.py (`timeout_s` on `POST /sql`),
each run against the port with the reference's assertions
(`torch_parity.port_cases`); then the JSON bodies of the same requests
to a reference and a port service, the membership a lead's service
lists, and the operator routes, which answer from the lead's cluster
view (the distributed session) as the reference's do."""

import copy
import dataclasses
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          port_cases)


@pytest.fixture()
def props():
    """Every global property of the port restored after the case (the
    reference files' `props` fixtures each restore the knobs they touch)."""
    from snappydata_tpu_torch import config

    p = config.global_properties()
    saved = copy.deepcopy(p)
    yield p
    for f in dataclasses.fields(p):
        setattr(p, f.name, getattr(saved, f.name))


@pytest.fixture()
def session(props):
    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog

    s = SnappySession(catalog=Catalog(), device="cpu")
    yield s
    s.stop()


globals().update(port_cases("test_auth_providers.py", [
    "test_rest_malformed_basic_header_is_401",
    "test_rest_basic_auth_with_provider"]))

globals().update(port_cases("test_observability.py", [
    "test_rest_traces_endpoint_and_dashboard",
    "test_rest_error_body_carries_trace_id"]))

globals().update(port_cases("test_matviews.py", [
    "test_view_snapshot_and_rest_endpoint"]))

globals().update(port_cases("test_serving.py", [
    "serving_session", "test_rest_sql_and_serving_endpoint"]))

globals().update(port_cases("test_resource_governor.py", [
    "rest", "test_rest_queries_and_cancel"]))

globals().update(port_cases("test_group_commit.py", [
    "_wal_knobs", "test_rest_wal_status_and_flush"]))

globals().update(port_cases("test_failpoints.py", [
    "test_rest_faults_roundtrip"], edits=[
    ("""from snappydata_tpu.fault.failpoints import (FailpointRegistry,
                                             FaultConnectionDropped,
                                             FaultError)
""", "")]))

globals().update(port_cases("test_mvcc.py", [
    "test_mvcc_snapshot_rest_and_dashboard"]))

globals().update(port_cases("test_agg_strategy.py", [
    "test_rest_scan_endpoint"]))

globals().update(port_cases("test_join_engine.py", [
    "s", "test_rest_join_endpoint_and_dashboard"]))

globals().update(port_cases("test_compressed_domain.py", [
    "test_scan_snapshot_and_rest_surface"]))

# the timeout case of the HA suite
globals().update(port_cases("test_ha.py", ["test_rest_sql_timeout_s"]))


# -- both packages' services, request for request ---------------------------

def _service(pkg):
    if pkg == "ref":
        from snappydata_tpu import SnappySession
        from snappydata_tpu.catalog import Catalog
        from snappydata_tpu.cluster.rest import RestService
        from snappydata_tpu.observability import TableStatsService
        s = SnappySession(catalog=Catalog())
    else:
        from snappydata_tpu_torch import SnappySession
        from snappydata_tpu_torch.catalog import Catalog
        from snappydata_tpu_torch.cluster.rest import RestService
        from snappydata_tpu_torch.observability import TableStatsService
        s = SnappySession(catalog=Catalog(), device="cpu")
    s.sql("CREATE TABLE li (k BIGINT, q DOUBLE, p DOUBLE, d DOUBLE, "
          "f STRING) USING column")
    rng = np.random.default_rng(5)
    n = 2048
    s.insert_arrays("li", [
        np.arange(n, dtype=np.int64),
        rng.integers(1, 51, n).astype(np.float64),
        np.round(rng.random(n) * 1e4, 2),
        np.round(rng.integers(0, 11, n) / 100.0, 2),
        np.array(["ANR"[i % 3] for i in range(n)], dtype=object)])
    stats = TableStatsService(s.catalog)
    stats.collect_once()
    return s, RestService(s, stats).start()


def _http(svc, path, body=None):
    url = f"http://{svc.host}:{svc.port}{path}"
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def services():
    out = {pkg: _service(pkg) for pkg in ("ref", "port")}
    yield out
    for s, svc in out.values():
        svc.stop()
        s.stop()


Q6 = ("SELECT sum(p * d) AS revenue FROM li WHERE d BETWEEN 0.05 AND 0.07 "
      "AND q < 24")
Q1 = ("SELECT f, sum(q) AS sq, avg(p) AS ap, count(*) AS c FROM li "
      "GROUP BY f ORDER BY f")


def _rows_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                assert a == pytest.approx(b, rel=1e-9)
            else:
                assert a == b


def test_rest_sql_and_jobs_match_reference(services):
    """`POST /sql` and a polled `/jobs` give the reference's JSON: names
    and rows (floats within the parity bar), each with a trace id."""
    for q in (Q6, Q1, "SELECT k, f FROM li WHERE k < ? ORDER BY k"):
        params = [7] if "?" in q else []
        bodies = {}
        for pkg, (_s, svc) in services.items():
            code, body = _http(svc, "/sql", {"sql": q, "params": params})
            assert code == 200, body
            assert body.get("trace_id")
            bodies[pkg] = body
        assert bodies["port"]["names"] == bodies["ref"]["names"]
        assert bodies["port"]["total_rows"] == bodies["ref"]["total_rows"]
        _rows_close(bodies["port"]["rows"], bodies["ref"]["rows"])
    jobs = {}
    for pkg, (_s, svc) in services.items():
        code, sub = _http(svc, "/jobs", {"sql": Q1})
        assert code == 200 and sub["status"] == "STARTED"
        for _ in range(200):
            code, st = _http(svc, f"/jobs/{sub['jobId']}")
            if st.get("status") in ("FINISHED", "ERROR"):
                break
            time.sleep(0.02)
        assert st["status"] == "FINISHED", st
        jobs[pkg] = st
    assert jobs["port"]["names"] == jobs["ref"]["names"]
    _rows_close(jobs["port"]["rows"], jobs["ref"]["rows"])


def test_rest_status_routes_answer_like_reference(services):
    """Every status route the reference's lead serves without membership
    answers on the port with the reference's keys; the storage route's
    bytes agree with the port's stats service."""
    from snappydata_tpu_torch.observability.stats_service import \
        storage_snapshot

    routes = ("/status/api/v1/cluster", "/status/api/v1/tables",
              "/status/api/v1/wal", "/status/api/v1/scan",
              "/status/api/v1/join", "/status/api/v1/serving",
              "/status/api/v1/views", "/status/api/v1/storage",
              "/status/api/v1/mvcc", "/status/api/v1/mesh",
              "/status/api/v1/streaming", "/status/api/v1/traces",
              "/status/api/v1/queries", "/queries", "/queries/ledger",
              "/faults", "/metrics/json", "/jobs")
    for path in routes:
        got = {pkg: _http(svc, path) for pkg, (_s, svc)
               in services.items()}
        assert got["port"][0] == got["ref"][0] == 200, (path, got)
        if isinstance(got["ref"][1], dict) and path != "/jobs":
            assert set(got["ref"][1]) <= set(got["port"][1]), path
    code, stg = _http(services["port"][1], "/status/api/v1/storage")
    assert stg == json.loads(json.dumps(storage_snapshot()))
    s, svc = services["port"]
    code, tables = _http(svc, "/status/api/v1/tables")
    assert tables["li"]["row_count"] == 2048
    html = urllib.request.urlopen(
        f"http://{svc.host}:{svc.port}/dashboard").read().decode()
    for section in ("Tables", "Streaming queries", "Durability",
                    "Serving path", "Materialized views", "Tracing"):
        assert section in html, section
    prom = urllib.request.urlopen(
        f"http://{svc.host}:{svc.port}/metrics/prometheus").read().decode()
    assert "# TYPE snappy_tpu_query_seconds histogram" in prom


def test_membership_routes_answer_501(services):
    """`/status/api/v1/ha` answers with the reference's keys; a service
    given the locator's membership lists its members on the cluster
    route and the dashboard; the operator routes answer the reference's
    409 on a service with no cluster view, and with a lead's view over
    two servers of its package `/rebalance`, `/redundancy/restore`,
    `/wal/flush` and the HA route's member lines answer as the
    reference's.  (The name is kept from the slice before the
    distributed session, when the operator routes answered 501.)"""
    from snappydata_tpu_torch.cluster import LocatorNode
    from snappydata_tpu_torch.cluster.locator import LocatorClient
    from snappydata_tpu_torch.cluster.rest import RestService
    from snappydata_tpu_torch.observability import TableStatsService
    from torch_parity import clusters

    routes = ("/rebalance", "/redundancy/restore")
    got = {pkg: _http(svc, "/status/api/v1/ha") for pkg, (_s, svc)
           in services.items()}
    assert got["port"][0] == got["ref"][0] == 200
    assert set(got["port"][1]) == set(got["ref"][1])
    for path in routes:
        got = {pkg: _http(svc, path, {}) for pkg, (_s, svc)
               in services.items()}
        assert got["port"] == got["ref"] == (
            409, {"error": "no cluster session on this lead"}), path
    with clusters(n=2) as made:
        got = {}
        for pkg, c in zip(("ref", "port"), made):
            svc = services[pkg][1]
            c.ds.sql("CREATE TABLE rr (k BIGINT, v DOUBLE) USING column "
                     "OPTIONS (partition_by 'k', redundancy '1')")
            c.ds.insert_arrays("rr", [np.arange(500, dtype=np.int64),
                                      np.ones(500)])
            c.ds.mark_server_failed(1)
            svc.distributed = c.ds
            try:
                ha = _http(svc, "/status/api/v1/ha")[1]
                got[pkg] = [_http(svc, p, {}) for p in
                            routes + ("/wal/flush",)] + [
                    {k: ha[k] for k in ("members_total", "alive_members",
                                        "degraded_buckets")}]
            finally:
                svc.distributed = None
    assert got["port"] == got["ref"]
    assert got["port"][-1]["alive_members"] == 1
    s, svc = services["port"]
    loc = LocatorNode().start()
    lc = LocatorClient(loc.address, "lead-rest", "lead", port=7)
    lc.register()
    other = RestService(s, TableStatsService(s.catalog),
                        membership=lc).start()
    try:
        code, body = _http(other, "/status/api/v1/cluster")
        assert code == 200
        assert [(m["member_id"], m["role"], m["port"])
                for m in body["members"]] == [("lead-rest", "lead", 7)]
        html = urllib.request.urlopen(
            f"http://{other.host}:{other.port}/dashboard").read().decode()
        assert "<td>lead</td><td>lead-rest</td><td>127.0.0.1:7</td>" in html
    finally:
        other.stop()
        lc.close()
        loc.stop()


def test_rest_handler_and_job_threads_enter_the_session_device(services):
    """REST handlers run on ThreadingHTTPServer's threads and jobs on
    threads of their own: both enter the session's device scope (None on
    a fresh thread) before any statement runs."""
    from snappydata_tpu_torch import config

    s, svc = services["port"]
    seen = []
    orig = s.for_user

    def for_user(*a, **kw):
        seen.append(("handler", config.current_device()))
        sess = orig(*a, **kw)
        sql = sess.sql

        def traced_sql(*qa, **qkw):
            seen.append(("statement", config.current_device()))
            return sql(*qa, **qkw)

        sess.sql = traced_sql
        return sess

    s.for_user = for_user
    try:
        code, sub = _http(svc, "/jobs", {"sql": Q6})
        for _ in range(200):
            code, st = _http(svc, f"/jobs/{sub['jobId']}")
            if st.get("status") in ("FINISHED", "ERROR"):
                break
            time.sleep(0.02)
    finally:
        del s.for_user
    assert st["status"] == "FINISHED", st
    assert {k for k, _ in seen} == {"handler", "statement"}
    assert all(d == s.device for _, d in seen), seen
