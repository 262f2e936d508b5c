"""The port's CLI (snappydata_tpu_torch/cli.py, __main__.py) against the
reference's (snappydata_tpu/cli.py): `status`, `backup`, `restore` and
`sql -e` (a SELECT and DML) of both packages print the same lines, apart
from member ids, ports and paths, against an in-process CPU locator and
server of their own package; `python -m snappydata_tpu_torch` starts a
locator and a CPU server in subprocesses with the reference's startup
lines; `rebalance` prints the primary lead's answer as the reference's
does; a server's session runs on `--device` (cuda by default, which
raises without a GPU); the multi-host flags reach `initialize_multihost`
and a server runs every query over its slot submesh (`--mesh-devices`,
or its rank's local slots once multi-host)."""

import os
import re
import subprocess
import sys

import pytest
import torch

from torch_parity import _ledger_per_test, front_door_env  # noqa: F401
from torch_parity import mesh_slots, stop_member

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name):
    if name == "ref":
        from snappydata_tpu import SnappySession, cli
        from snappydata_tpu.catalog import Catalog
        from snappydata_tpu.cluster import LocatorNode, ServerNode
        return SnappySession, Catalog, LocatorNode, ServerNode, cli, {}
    from snappydata_tpu_torch import SnappySession, cli
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.cluster import LocatorNode, ServerNode
    return SnappySession, Catalog, LocatorNode, ServerNode, cli, \
        {"device": "cpu"}


@pytest.fixture(scope="module")
def clusters():
    """One locator and one CPU server node per package."""
    out = {}
    for name in ("ref", "port"):
        Session, Catalog, LocatorNode, ServerNode, cli, kw = _pkg(name)
        loc = LocatorNode().start()
        srv = ServerNode(loc.address, Session(catalog=Catalog(), **kw),
                         member_id="server-cli").start()
        out[name] = (cli, loc, srv)
    yield out
    for _cli, loc, srv in out.values():
        stop_member(srv)
        loc.stop()


def _norm(text, words):
    for w in words:
        text = text.replace(w, "<X>")
    return re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:<port>", text)


def _both(clusters, capsys, argv_of, words_of=lambda name: ()):
    """stdout, stderr and exit code of `cli.main(argv_of(name, loc,
    srv))` per package, ids, ports and `words_of(name)` masked."""
    got = {}
    for name, (cli, loc, srv) in clusters.items():
        rc = cli.main(argv_of(name, loc, srv))
        out, err = capsys.readouterr()
        words = tuple(words_of(name))
        got[name] = (_norm(out, words), _norm(err, words), rc)
    assert got["port"] == got["ref"], got
    return got["port"]


def test_sql_e_select_and_dml_print_the_references_lines(clusters,
                                                         capsys):
    conn = lambda sql: lambda name, loc, srv: [  # noqa: E731
        "sql", "--connect", srv.flight_address, "-e", sql]
    via_locator = lambda sql: lambda name, loc, srv: [  # noqa: E731
        "sql", "--locator", loc.address, "-e", sql]
    _both(clusters, capsys, conn(
        "CREATE TABLE cli_t (a INT, b STRING, c DOUBLE) USING column"))
    out, _err, rc = _both(clusters, capsys, conn(
        "INSERT INTO cli_t VALUES (1, 'x', 0.5), (2, 'y', 1.25), "
        "(3, NULL, 2.0)"))
    assert rc == 0 and out == '{"names": ["count"], "rows": [[3]]}\n', out
    out, _err, rc = _both(clusters, capsys, via_locator(
        "SELECT a, b, c FROM cli_t ORDER BY a"))
    assert out.splitlines() == ["a | b | c", "--+---+--", "1 | x | 0.5",
                                "2 | y | 1.25", "3 | None | 2.0",
                                "(3 rows)"]
    out, _err, _rc = _both(clusters, capsys, via_locator(
        "SELECT b, count(*) AS n, sum(c) AS s FROM cli_t WHERE a > 1 "
        "GROUP BY b ORDER BY b"))
    assert out.splitlines()[-1] == "(2 rows)"
    _both(clusters, capsys, conn("UPDATE cli_t SET c = c * 2 WHERE a = 1"))
    _both(clusters, capsys, conn("DELETE FROM cli_t WHERE a = 3"))
    out, _err, _rc = _both(clusters, capsys, conn(
        "SELECT count(*), sum(c) FROM cli_t"))
    assert out.splitlines()[2] == "2 | 2.25"


def test_status_lists_the_members(clusters, capsys):
    out, _err, rc = _both(clusters, capsys, lambda name, loc, srv: [
        "status", "--locator", loc.address])
    assert rc == 0
    assert out.splitlines() == [
        "server   server-cli               127.0.0.1:<port>",
        "(1 members)"]


def test_backup_and_restore_print_the_references_lines(clusters, capsys,
                                                       tmp_path):
    dirs = {}
    for name in ("ref", "port"):
        Session, Catalog, _L, _S, _cli, kw = _pkg(name)
        d = str(tmp_path / name / "store")
        s = Session(catalog=Catalog(), data_dir=d, recover=False, **kw)
        s.sql("CREATE TABLE bk (k BIGINT) USING column")
        s.sql("INSERT INTO bk VALUES (1), (2), (3)")
        s.checkpoint()
        s.disk_store.close()
        dirs[name] = d
    root = lambda name: str(tmp_path / name)  # noqa: E731
    for argv in (
            lambda name, loc, srv: ["backup", "--data-dir", dirs[name],
                                    "--dest", root(name) + "/bk"],
            lambda name, loc, srv: ["backup", "--data-dir", dirs[name],
                                    "--dest", root(name) + "/bk"],
            lambda name, loc, srv: ["backup", "--data-dir",
                                    root(name) + "/none",
                                    "--dest", root(name) + "/bk2"],
            lambda name, loc, srv: ["restore", "--backup",
                                    root(name) + "/bk", "--data-dir",
                                    root(name) + "/back"],
            lambda name, loc, srv: ["restore", "--backup",
                                    root(name) + "/bk", "--data-dir",
                                    root(name) + "/back"]):
        _both(clusters, capsys, argv, lambda name: [root(name)])
    from snappydata_tpu_torch import SnappySession

    back = SnappySession(data_dir=str(tmp_path / "port" / "back"),
                         device="cpu")
    assert back.sql("SELECT count(*), sum(k) FROM bk").rows() == [(3, 6)]
    back.disk_store.close()


def test_rebalance_reports_the_leads_answer(capsys):
    """`rebalance --lead` prints the primary lead's answer and exits 0, as
    the reference's does.  Each package's lead builds its cluster view
    over two servers; a redundant table fails over from server 1, which
    rejoins empty, so the rebalance moves half the buckets back: both
    packages print the same JSON and leave the same rows on each
    server."""
    import numpy as np

    rng = np.random.default_rng(4)
    k = rng.integers(0, 10_000, 4000).astype(np.int64)
    v = np.round(rng.random(4000), 3)
    printed, per_server = {}, {}
    for pkg in ("ref", "port"):
        Session, Catalog, LocatorNode, ServerNode, cli, kw = _pkg(pkg)
        if pkg == "ref":
            from snappydata_tpu.cluster import LeadNode
        else:
            from snappydata_tpu_torch.cluster import LeadNode
        loc = LocatorNode().start()
        servers = [ServerNode(loc.address, Session(catalog=Catalog(), **kw))
                   .start() for _ in range(2)]
        lead = LeadNode(loc.address, Session(catalog=Catalog(), **kw),
                        lease_s=0.5).start(wait_for_primary=True)
        try:
            assert lead.is_primary
            ds = lead.rest.distributed
            assert ds is not None and len(ds.servers) == 2
            if pkg == "port":
                assert ds.device == lead.session.device
            order = [s.flight_address for s in servers]
            idx = {a: ds.server_addresses.index(a) for a in order}
            ds.sql("CREATE TABLE rb (k BIGINT, v DOUBLE) USING column "
                   "OPTIONS (partition_by 'k', redundancy '1')")
            ds.insert_arrays("rb", [k.copy(), v.copy()])
            ds.mark_server_failed(idx[order[1]])
            ds.replace_server(idx[order[1]], order[1])
            rc = cli.main(["rebalance", "--lead", lead.rest_address])
            out = capsys.readouterr().out
            assert rc == 0, out
            printed[pkg] = out
            per_server[pkg] = [s.session.sql(
                "SELECT count(*), sum(k) FROM rb").rows()[0]
                for s in servers]
            assert ds.sql("SELECT count(*) FROM rb").rows()[0][0] == len(k)
        finally:
            stop_member(lead)
            for s in servers:
                stop_member(s)
            loc.stop()
    assert printed["port"] == printed["ref"]
    assert '"moved_buckets": 64' in printed["port"], printed["port"]
    assert [tuple(r) for r in per_server["port"]] == \
        [tuple(r) for r in per_server["ref"]]


def test_server_device_defaults_to_cuda():
    """Without --device a server's session asks for cuda: without a GPU
    that raises, as `resolve_device` does, before anything starts."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from snappydata_tpu_torch import cli

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["server", "--locator", "127.0.0.1:1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["lead", "--locator", "127.0.0.1:1"])


@pytest.mark.parametrize("flags", [["--mesh-devices", "0"],
                                   ["--coordinator", "127.0.0.1:1"],
                                   ["--num-processes", "2"],
                                   ["--process-id", "0"]])
def test_multihost_flags_raise(flags, monkeypatch, capsys):
    """(Named for the stub it replaces: the flags no longer raise.)  Each
    multi-host flag of `server` reaches `initialize_multihost` before the
    session starts; a joined world hands the server its rank's local
    slots as its submesh, and `--mesh-devices` names the submesh itself.
    The world's backend and the local slots follow `--device`.  The
    locator, the world and the member are stand-ins that record what the
    CLI gives them."""
    from snappydata_tpu_torch import cli, cluster
    from snappydata_tpu_torch.parallel import multihost

    seen = {}

    def fake_init(coordinator=None, num_processes=None, process_id=None,
                  device=None):
        seen["init"] = (coordinator, num_processes, process_id, device)
        return coordinator is not None

    def fake_local(device=None):
        seen["local"] = device
        return [4, 5]

    class FakeNode:
        member_id = "server-fake"
        flight_address = "127.0.0.1:1"

        def __init__(self, locator, session, host, flight_port,
                     mesh_devices=None):
            seen["node"] = (locator, session.device, mesh_devices)

        def start(self):
            return self

    monkeypatch.setattr(multihost, "initialize_multihost", fake_init)
    monkeypatch.setattr(multihost, "local_device_indices", fake_local)
    monkeypatch.setattr(cluster, "ServerNode", FakeNode)
    monkeypatch.setattr(cli, "_wait_forever", lambda: None)
    assert cli.main(["server", "--locator", "127.0.0.1:9", "--device",
                     "cpu"] + flags) == 0
    out = capsys.readouterr().out
    flag, value = flags
    want_init = (value if flag == "--coordinator" else None,
                 int(value) if flag == "--num-processes" else None,
                 int(value) if flag == "--process-id" else None, "cpu")
    assert seen["init"] == want_init
    assert seen.get("local") == ("cpu" if flag == "--coordinator" else None)
    mesh = {"--mesh-devices": [0], "--coordinator": [4, 5]}.get(flag)
    assert seen["node"] == ("127.0.0.1:9", torch.device("cpu"), mesh)
    extra = f", submesh {mesh}" if mesh else ""
    assert out == f"server server-fake flight at 127.0.0.1:1{extra}\n"


def test_server_node_mesh_devices_raise():
    """(Named for the stub it replaces: a submesh no longer raises.)
    `ServerNode(mesh_devices=...)` makes the server's session run every
    query over those slots: its aggregates take the per-slot lane and
    answer what a single-device session answers."""
    import numpy as np

    from snappydata_tpu_torch import SnappySession
    from snappydata_tpu_torch.catalog import Catalog
    from snappydata_tpu_torch.cluster import LocatorNode, ServerNode
    from snappydata_tpu_torch.observability.metrics import global_registry

    with mesh_slots(4):
        loc = LocatorNode().start()
        session = SnappySession(catalog=Catalog(), device="cpu")
        node = ServerNode(loc.address, session, mesh_devices=[2, 3]).start()
        try:
            assert node.session is session
            assert [s.index for s in session.default_mesh.slots] == [2, 3]
            session.sql("CREATE TABLE sm (g BIGINT, v DOUBLE) USING column")
            session.insert_arrays("sm", [np.arange(1000) % 3,
                                         np.arange(1000, dtype=np.float64)])
            session.catalog.describe("sm").data.force_rollover()
            execs = global_registry().counter("mesh_shard_execs")
            rows = session.sql("SELECT count(*), sum(v) FROM sm").rows()
            assert rows == [(1000, 499500.0)]
            assert global_registry().counter("mesh_shard_execs") == \
                execs + 1
        finally:
            stop_member(node)
            loc.stop()


def _spawn(*argv):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-m", "snappydata_tpu_torch",
                             *argv], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _first_line(proc, timeout=120.0):
    """The process's first stdout line; fails if it exits first."""
    line = proc.stdout.readline()
    if not line:
        proc.wait(timeout=timeout)
        pytest.fail(f"exited {proc.returncode}: {proc.stderr.read()}")
    return line.strip()


def test_python_m_starts_a_locator_and_a_cpu_server():
    """`python -m snappydata_tpu_torch locator --port 0` and `server
    --device cpu` print the reference's startup lines; `status` lists the
    server, a `sql` client process answers without loading torch, and
    `--help` needs no GPU."""
    helped = subprocess.run(
        [sys.executable, "-m", "snappydata_tpu_torch", "--help"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert helped.returncode == 0, helped.stderr
    assert "{locator,server,lead,sql,backup,restore,status,rebalance}" in \
        helped.stdout
    procs = [_spawn("locator", "--port", "0")]
    try:
        line = _first_line(procs[0])
        m = re.fullmatch(r"locator running at (127\.0\.0\.1:\d+)", line)
        assert m, line
        address = m.group(1)
        procs.append(_spawn("server", "--locator", address, "--device",
                            "cpu"))
        line = _first_line(procs[1])
        m = re.fullmatch(r"server (server-[0-9a-f]{8}) flight at "
                         r"(127\.0\.0\.1:\d+)", line)
        assert m, line
        status = subprocess.run(
            [sys.executable, "-m", "snappydata_tpu_torch", "status",
             "--locator", address], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=120)
        assert status.returncode == 0, status.stderr
        assert status.stdout.splitlines() == [
            f"server   {m.group(1):24s} {m.group(2)}", "(1 members)"]
        # the client commands load no torch: a `sql` process starts in
        # well under a second
        sql = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             "from snappydata_tpu_torch import cli\n"
             f"cli.main(['sql', '--locator', '{address}', '-e', "
             "'SELECT 1 AS one'])\n"
             "print('torch' in sys.modules)"], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=120)
        assert sql.returncode == 0, sql.stderr
        assert sql.stdout.splitlines() == ["one", "---", "1", "(1 rows)",
                                           "False"]
    finally:
        for p in reversed(procs):
            p.terminate()
            p.wait(timeout=30)
            p.stdout.close()
            p.stderr.close()
    assert all(p.poll() is not None for p in procs)
