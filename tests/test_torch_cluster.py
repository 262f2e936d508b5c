"""Cluster membership through the port (snappydata_tpu_torch/cluster/
locator.py, node.py, the client's locator discovery, the lead's REST
membership): every case of the reference's tests/test_cluster.py, the
single-server cases of tests/test_ha.py (lost-ack retry, the mutation
retry's pin, dedup across crash recovery, both heartbeat cases, the
`/status/api/v1/ha` route), the heartbeat and locator cases of
tests/test_failpoints.py and `test_concurrency.py::
test_concurrent_flight_clients` behind a locator, each run against the
port with the reference's assertions (`torch_parity.port_cases`); then
the wire between the packages: a member of either package registers,
heartbeats, locks and is refused by a locator of the other, and both
locators answer one request sequence alike.

The reference marks tests/test_cluster.py and tests/test_concurrency.py
slow at module level, and the heartbeat give-up case on its own: the
port's copies take seconds on the CPU, so none of them is marked slow
here."""

import json
import socket
import time

import pytest

from torch_parity import (_ledger_per_test, front_door_env,  # noqa: F401
                          port_cases)

globals().update(port_cases("test_cluster.py", [
    "cluster", "test_membership_and_failure_detection",
    "test_lead_election_and_failover", "test_flight_sql_roundtrip",
    "test_flight_bulk_ingest", "test_client_failover_between_members",
    "test_rest_status_metrics_jobs",
    "test_flight_schema_without_execution_and_paging",
    "test_query_log_and_plan_ui"]))

# the single-server cases (the distributed ones run in
# tests/test_torch_distributed_ha.py)
globals().update(port_cases("test_ha.py", [
    "_clean_faults", "test_mutation_lost_ack_retries_transparently",
    "test_mutation_retry_pins_to_applied_server",
    "test_mutation_dedup_survives_crash_recovery",
    "test_heartbeat_survives_transient_runtime_errors",
    "test_heartbeat_gives_up_visibly_on_persistent_mismatch",
    "test_rest_ha_endpoint_and_dashboard"]))
# under a second on the CPU (its loop gives up after two beats)
test_heartbeat_gives_up_visibly_on_persistent_mismatch.pytestmark = [
    m for m in test_heartbeat_gives_up_visibly_on_persistent_mismatch
    .pytestmark if m.name != "slow"]

globals().update(port_cases("test_failpoints.py", [
    "test_heartbeat_failures_counted_and_survived",
    "test_locator_garbled_response_is_connection_error",
    "test_locator_request_timeout_unwedges_heartbeat"], edits=[
    ("""from snappydata_tpu.fault.failpoints import (FailpointRegistry,
                                             FaultConnectionDropped,
                                             FaultError)
""", "")]))

globals().update(port_cases("test_concurrency.py", [
    "test_concurrent_flight_clients"]))


# -- the wire between the packages ------------------------------------------

def _locator_mod(pkg):
    if pkg == "ref":
        from snappydata_tpu.cluster import locator
    else:
        from snappydata_tpu_torch.cluster import locator
    return locator


@pytest.mark.parametrize("loc_pkg,member_pkg", [("port", "ref"),
                                                ("ref", "port")])
def test_members_of_one_package_join_a_locator_of_the_other(loc_pkg,
                                                            member_pkg):
    """Register, heartbeat, members(), the primary-lead lock and the
    protocol refusal across packages: the wire format and the protocol
    generation are one."""
    server_side, client_side = _locator_mod(loc_pkg), _locator_mod(
        member_pkg)
    assert server_side.PROTOCOL_VERSION == client_side.PROTOCOL_VERSION
    assert server_side.PRIMARY_LEAD_LOCK == client_side.PRIMARY_LEAD_LOCK
    loc = server_side.Locator(member_timeout_s=0.5).start()
    a = client_side.LocatorClient(loc.address, "x-a", "server", port=11)
    b = client_side.LocatorClient(loc.address, "x-b", "lead", port=12)
    try:
        assert a.register()["ok"] and b.register()["ok"]
        a.start_heartbeats(interval_s=0.05)
        members = {m.member_id: m for m in a.members()}
        assert set(members) == {"x-a", "x-b"}
        assert isinstance(members["x-a"], client_side.MemberInfo)
        assert (members["x-b"].role, members["x-b"].host,
                members["x-b"].port) == ("lead", "127.0.0.1", 12)
        lock = client_side.PRIMARY_LEAD_LOCK
        assert a.try_lock(lock, lease_s=5.0)
        assert not b.try_lock(lock, lease_s=5.0)
        # b stops beating: swept past member_timeout_s, a keeps its place
        deadline = time.time() + 5
        while time.time() < deadline and \
                {m.member_id for m in a.members()} != {"x-a"}:
            time.sleep(0.05)
        assert {m.member_id for m in a.members()} == {"x-a"}
        a.unlock(lock)
        bad = b._request({"op": "register", "member_id": "x-c",
                          "role": "server", "host": "127.0.0.1", "port": 9,
                          "protocol": client_side.PROTOCOL_VERSION + 1})
        assert bad["ok"] is False
        assert "protocol version mismatch" in bad["error"]
        assert "x-c" not in {m.member_id for m in a.members()}
    finally:
        a.close()
        b.close()
        loc.stop()


def _exchange(address, requests):
    """Each JSON request on one connection, its parsed answer back."""
    with socket.create_connection(address.rsplit(":", 1), timeout=5) as s:
        fh = s.makefile("rwb")
        out = []
        for req in requests:
            fh.write((json.dumps(req) + "\n").encode())
            fh.flush()
            out.append(json.loads(fh.readline()))
        return out


def test_both_locators_answer_a_request_sequence_alike():
    """One request sequence to a reference and a port locator: equal
    answers, view numbers included, apart from the heartbeat stamps."""
    reqs = [
        {"op": "register", "member_id": "s1", "role": "server",
         "host": "127.0.0.1", "port": 5, "protocol": 2},
        {"op": "register", "member_id": "l1", "role": "lead",
         "host": "127.0.0.1", "port": 6, "protocol": 2},
        {"op": "register", "member_id": "old", "role": "server",
         "host": "127.0.0.1", "port": 7, "protocol": 1},
        {"op": "heartbeat", "member_id": "s1"},
        {"op": "heartbeat", "member_id": "gone"},
        {"op": "lock", "name": "__PRIMARY_LEADER_LS", "member_id": "l1",
         "lease_s": 30},
        {"op": "lock", "name": "__PRIMARY_LEADER_LS", "member_id": "s1"},
        {"op": "unlock", "name": "__PRIMARY_LEADER_LS", "member_id": "s1"},
        {"op": "unlock", "name": "__PRIMARY_LEADER_LS", "member_id": "l1"},
        {"op": "lock", "name": "__PRIMARY_LEADER_LS", "member_id": "s1"},
        {"op": "deregister", "member_id": "s1"},
        {"op": "members"},
        {"op": "nope"},
    ]
    answers = {}
    for pkg in ("ref", "port"):
        loc = _locator_mod(pkg).Locator().start()
        try:
            answers[pkg] = _exchange(loc.address, reqs)
        finally:
            loc.stop()
    for out in answers.values():
        for m in out[-2].get("members", []):
            m["last_heartbeat"] = None
    assert answers["port"] == answers["ref"]
    assert answers["port"][2]["ok"] is False
    assert [m["member_id"] for m in answers["port"][-2]["members"]] == \
        ["l1"]


def test_known_failpoints_are_the_seams_the_port_hits():
    """The registry's KNOWN_POINTS list every name the port's sources
    pass to `failpoints.hit` / `mangle`, `locator.heartbeat` among them,
    and no other."""
    import os
    import re

    from snappydata_tpu_torch.reliability import failpoints

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "snappydata_tpu_torch")
    seen = set()
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    seen |= set(re.findall(
                        r"(?:hit|mangle)\(\s*\"([a-z_]+\.[a-z_]+)\"",
                        fh.read()))
    assert "locator.heartbeat" in seen
    assert seen == set(failpoints.KNOWN_POINTS)
