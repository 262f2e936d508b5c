"""Redundancy, failover and the bucket actions across the packages: a
failover, a second one, the redundancy restore and a rebalance leave the
reference's placement maps, answers and returned bodies; each of the
seven Flight bucket actions, sent with the same body to one server of
each package, answers as the reference's and leaves equal tables, and
equal counts, sums and GROUP BYs through the server's own plates (each
server's plates and group-index cache are bound before every action).
Then the routed insert's Arrow strings against the reference's loop,
and the lead's device: without `device=` it asks for `cuda`.

Port sessions here name their device, so the module does not default
them to the CPU (`torch_parity.front_door_env`): the last case sees the
lead's own default."""

import numpy as np
import pytest

from torch_parity import (REL, _ledger_per_test, assert_rows_equal,  # noqa
                          clusters, ledger_guard, policy, stop_flight)


@pytest.fixture(scope="module", autouse=True)
def _ledgers():
    with ledger_guard():
        yield


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_failover_and_restore_equal_the_references(name):
    """mark_server_failed promotes the dead member's buckets from the
    replica shadows and re-replicates them; restore_redundancy after a
    second failure: placement maps, answers and returned bodies equal."""
    rng = np.random.default_rng(9)
    k = rng.integers(0, 20_000, 12_000).astype(np.int64)
    v = np.round(rng.random(12_000) * 10, 3)
    q = "SELECT count(*), sum(v), min(v), max(v) FROM rt"
    with policy(name), clusters(n=4) as (ref, port):
        want = None
        for c in (ref, port):
            c.ds.sql("CREATE TABLE rt (k BIGINT, v DOUBLE) USING column "
                     "OPTIONS (partition_by 'k', redundancy '1')")
            c.ds.insert_arrays("rt", [k.copy(), v.copy()])
        rows = [c.ds.sql(q).rows() for c in (ref, port)]
        assert_rows_equal(rows[1], rows[0], REL[name])
        assert rows[1][0][0] == len(k)
        want = rows[0]
        for step in ("fail 0", "fail 2", "restore", "rebalance"):
            out = []
            for c in (ref, port):
                if step.startswith("fail"):
                    c.ds.mark_server_failed(int(step.split()[1]))
                    out.append(None)
                elif step == "restore":
                    out.append(c.ds.restore_redundancy())
                else:
                    out.append(c.ds.rebalance())
            assert out[1] == out[0], step
            assert port.ds.bucket_map == ref.ds.bucket_map, step
            assert port.ds.replica_map == ref.ds.replica_map, step
            assert port.ds.alive == ref.ds.alive, step
            assert port.ds.degraded_buckets() == ref.ds.degraded_buckets()
            rows = [c.ds.sql(q).rows() for c in (ref, port)]
            assert_rows_equal(rows[1], rows[0], REL[name])
            assert_rows_equal(rows[1], want, REL[name])
            assert port.counts("rt") == ref.counts("rt"), step
            assert port.counts("rt__replica") == ref.counts("rt__replica")


# -- the bucket actions, server by server -----------------------------------

BUCKETS = 8


def _action_servers(pkg):
    """Two Flight servers of one package over sessions of their own, each
    with t (k, g, v) and its replica shadow loaded from the same rows."""
    import threading

    if pkg == "ref":
        from snappydata_tpu import SnappySession
        from snappydata_tpu.catalog import Catalog
        from snappydata_tpu.cluster.client import SnappyClient
        from snappydata_tpu.cluster.flight_server import SnappyFlightServer
        kw = {}
    else:
        from snappydata_tpu_torch import SnappySession
        from snappydata_tpu_torch.catalog import Catalog
        from snappydata_tpu_torch.cluster.client import SnappyClient
        from snappydata_tpu_torch.cluster.flight_server import \
            SnappyFlightServer
        kw = {"device": "cpu"}
    out = []
    for i in range(2):
        s = SnappySession(catalog=Catalog(), **kw)
        for t in ("t", "t__replica", "t_dest"):
            s.sql(f"CREATE TABLE {t} (k BIGINT, g STRING, v DOUBLE) "
                  "USING column")
        rng = np.random.default_rng(40 + i)
        n = 3000
        k = rng.integers(0, 400, n).astype(np.int64)
        g = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]
        v = np.round(rng.random(n) * 50, 2)
        s.insert_arrays("t", [k, g, v])
        s.insert_arrays("t__replica", [k[::2] + 1, g[::2], v[::2] * 2])
        srv = SnappyFlightServer(s)
        threading.Thread(target=srv.serve, daemon=True).start()
        srv.wait_ready()
        out.append((s, srv, SnappyClient(address=f"127.0.0.1:{srv.port}")))
    return out


def _contents(s):
    """Each table's sorted rows, then a count / sum / GROUP BY through the
    session's plates (a stale plate or gidx entry would show here)."""
    out = {}
    for t in ("t", "t__replica", "t_dest"):
        rows = sorted(tuple(r) for r in s.sql(f"SELECT k, g, v FROM {t}")
                      .rows())
        agg = s.sql(f"SELECT count(*), sum(v) FROM {t}").rows()
        grp = s.sql(f"SELECT g, count(*), sum(v) FROM {t} GROUP BY g "
                    "ORDER BY g").rows()
        out[t] = (rows, [tuple(r) for r in agg], [tuple(r) for r in grp])
    return out


# each action takes buckets that the ones before it left rows in
ACTION_BUCKETS = {"promote": [0, 3], "replicate": [1, 4],
                  "purge_replica": [2, 6], "purge_buckets": [1, 7],
                  "demote": [2, 5], "move_buckets": [4, 6]}


def _body(name, addrs):
    body = {"table": "t", "key": "k", "buckets": ACTION_BUCKETS.get(name),
            "num_buckets": BUCKETS}
    if name in ("replicate", "move_buckets"):
        body["target"] = addrs[1]
    if name == "repartition":
        body.update(dest="t_dest", servers=addrs,
                    bucket_owners=[b % 2 for b in range(BUCKETS)])
        del body["buckets"]
    return body


ACTIONS = ("promote", "replicate", "purge_replica", "purge_buckets",
           "demote", "move_buckets", "repartition")


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_bucket_actions_equal_the_references(name):
    """The seven bucket actions in turn, each sent with the same body to
    server A of each package (its peer B is the target where one is
    named): the answers, and both servers' tables, equal the reference's
    after every action; the servers' plates are bound before each one."""
    with policy(name):
        made = {pkg: _action_servers(pkg) for pkg in ("ref", "port")}
        try:
            for action in ACTIONS:
                seen = {}
                for pkg, pair in made.items():
                    for s, _srv, _c in pair:
                        _contents(s)      # bind the plates, fill the cache
                    addrs = [f"127.0.0.1:{srv.port}" for _s, srv, _c in pair]
                    client = pair[0][2]
                    got = getattr(client, action)(_body(action, addrs))
                    seen[pkg] = (got, [_contents(s) for s, _srv, _c in pair])
                assert seen["port"][0] == seen["ref"][0], action
                assert seen["port"][0]["rows"] > 0, action
                for got, want in zip(seen["port"][1], seen["ref"][1]):
                    for t in want:
                        for a, b in zip(got[t], want[t]):
                            assert_rows_equal(a, b, REL[name])
        finally:
            for pair in made.values():
                for s, srv, c in pair:
                    c.close()
                    stop_flight(srv)
                    s.stop()


# -- the routed insert, the lead's device, the float64 merge ----------------

def test_routed_strings_equal_the_references_loop():
    """insert_arrays builds a str / None column in Arrow in one call; any
    other cell takes the reference's loop: the Arrow tables the servers
    receive equal the reference's, NULL masks and non-str cells
    included."""
    import pyarrow as pa

    from snappydata_tpu_torch.cluster.distributed import _string_array

    def ref_loop(vals, mask):
        return pa.array([None if (mask is not None and mask[j])
                         or v is None else str(v)
                         for j, v in enumerate(vals)], type=pa.string())

    cells = [["a", None, "c", "dd"], [b"ab", "x", None, "y"],
             [1, "x", None, 2.5], [float("nan"), "y", "z", None],
             [None, None, None, None], [np.str_("q"), "r", None, "s"],
             [True, "a", "b", "c"], [b"x", b"y", None, b"z"]]
    for c in cells:
        vals = np.array(c, dtype=object)
        for mask in (None, np.array([False, True, False, True])):
            got, want = _string_array(vals, mask), ref_loop(vals, mask)
            assert got.type == pa.string() and got.equals(want), (c, mask)


def test_lead_needs_its_device():
    """Without device= the lead asks for cuda: with no GPU it raises
    before any member is contacted; device='cpu' plans on the CPU."""
    import torch

    from snappydata_tpu_torch.cluster.distributed import DistributedSession

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedSession(server_addresses=["127.0.0.1:1"])
    ds = DistributedSession(server_addresses=["127.0.0.1:1"], device="cpu")
    try:
        assert ds.device.type == "cpu" and ds.planner.device.type == "cpu"
    finally:
        ds.close()
