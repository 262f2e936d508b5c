"""The PyTorch port stands alone: importing and running it loads neither
JAX nor any module of the JAX package, and a session that did not ask for
the CPU refuses to start without a GPU instead of moving there silently.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_QUICK_START = r"""
import sys
from snappydata_tpu_torch import SnappySession

s = SnappySession(device="cpu")
s.sql("CREATE TABLE sales (sym STRING, qty INT, price DOUBLE) USING column")
s.sql("INSERT INTO sales VALUES ('AAPL', 10, 171.5), ('GOOG', 5, 2831.0)")
rows = s.sql("SELECT sym, sum(qty * price) FROM sales GROUP BY sym "
             "ORDER BY sym").rows()
assert rows == [("AAPL", 1715.0), ("GOOG", 14155.0)], rows
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_quick_start_imports_no_jax():
    out = _run(_QUICK_START)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_no_source_imports_the_reference():
    pkg = os.path.join(REPO, "snappydata_tpu_torch")
    bad = []
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    words = line.split()
                    if len(words) >= 2 and words[0] in ("import", "from") \
                            and words[1].split(".")[0] in (
                                "jax", "snappydata_tpu"):
                        bad.append(f"{path}:{i}: {line.strip()}")
    assert not bad, bad


def test_session_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from snappydata_tpu_torch import SnappySession

    with pytest.raises(RuntimeError, match="device='cpu'"):
        SnappySession()
    with pytest.raises(RuntimeError):
        SnappySession(device="cuda")


_DURABLE = r"""
import sys, tempfile
import snappydata_tpu_torch.fault as fault
import snappydata_tpu_torch.reliability as reliability
from snappydata_tpu_torch.reliability import failpoints
from snappydata_tpu_torch.storage import compact, persistence
from snappydata_tpu_torch import SnappySession
from snappydata_tpu_torch.catalog import Catalog

d = tempfile.mkdtemp()
s = SnappySession(catalog=Catalog(), data_dir=d, recover=False, device="cpu")
s.sql("CREATE TABLE t (k INT, tags ARRAY<STRING>) USING column")
with reliability.stmt_scope("sid-1"):
    s.sql("INSERT INTO t VALUES (1, array('a')), (2, NULL)")
s2 = SnappySession(data_dir=d, device="cpu")
assert s2.sql("SELECT k, size(tags) FROM t ORDER BY k").rows() == \
    [(1, 1), (2, None)]
assert reliability.dedup_for(s2.catalog).begin("sid-1")["replayed"]
compact.run_compaction_pass(s2.catalog.describe("t").data, force=True)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_durability_fault_and_reliability_import_no_jax():
    """The port's fault/ and reliability/ packages, the WAL, recovery and
    the compactor run without JAX or the JAX package."""
    out = _run(_DURABLE)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_GOVERNED = r"""
import sys, tempfile
import numpy as np
from snappydata_tpu_torch import SnappySession, config, resource
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.reliability import faultstorm
from snappydata_tpu_torch.storage import hoststore, tier

props = config.global_properties()
props.column_batch_rows = 256
props.column_max_delta_rows = 256
d = tempfile.mkdtemp()
s = SnappySession(catalog=Catalog(), data_dir=d, recover=False, device="cpu")
s.sql("CREATE TABLE t (k BIGINT, v DOUBLE) USING column")
s.insert_arrays("t", [np.arange(2000, dtype=np.int64), np.ones(2000)])
s.checkpoint()
data = s.catalog.describe("t").data
assert tier.demote([("t", data)], 1 << 40) > 0
assert tier.promote_table(data) > 0
assert hoststore.spill_to_budget(data, 0) > 0
assert s.sql("SELECT count(*), sum(v) FROM t").rows() == [(2000, 2000.0)]
assert "t" in resource.global_broker().ledger()["device"]
res = faultstorm.run_storm(tempfile.mkdtemp(), seed=5, rounds=3,
                           device="cpu")
assert res["recovery_ratio"] == 1.0, res
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_governor_tier_and_storm_import_no_jax():
    """The resource governor, host spill, the tier ladder with its
    self-healing, and the fault storm run without JAX or the JAX
    package."""
    out = _run(_GOVERNED)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_SERVING_AQP = r"""
import sys, tempfile, threading
import numpy as np
from snappydata_tpu_torch import SnappySession, aqp, parallel, serving
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.engine import executor

d = tempfile.mkdtemp()
s = SnappySession(catalog=Catalog(), data_dir=d, recover=False, device="cpu")
s.sql("CREATE TABLE t (k STRING, v DOUBLE, n BIGINT) USING column")
rng = np.random.default_rng(1)
s.insert_arrays("t", [np.array(["a", "b", "c"], dtype=object)[
    rng.integers(0, 3, 3000)], rng.random(3000), np.arange(3000)])
h = s.prepare("SELECT k, sum(v), count(*) FROM t WHERE n < ? GROUP BY k "
              "ORDER BY k")
out = [None] * 4
def run(i):
    out[i] = h.execute((1000 * (i + 1),)).rows()
ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
for t in ts:
    t.start()
for t in ts:
    t.join(60)
assert all(o is not None for o in out), out
assert h.execute((1000,)).rows() == out[0]
assert executor.gidx_cache_nbytes() > 0
s.sql("CREATE TABLE r (id BIGINT PRIMARY KEY, name STRING) USING row")
s.sql("INSERT INTO r VALUES (1, 'x'), (2, 'y')")
s.sql("CREATE INDEX r_name ON r (name)")
s.sql("CREATE POLICY r_one ON r USING id < 2")
assert s.sql("SELECT id FROM r WHERE name = 'x'").rows() == [(1,)]
s.sql("CREATE SAMPLE TABLE t_s ON t OPTIONS (qcs 'k', reservoir_size '100')")
rows = s.sql("SELECT k, sum(v) AS sv, absolute_error(sv) FROM t GROUP BY k "
             "ORDER BY k WITH ERROR 0.5").rows()
assert len(rows) == 3, rows
s.create_topk("top_k", "t", "k", k=2)
assert len(s.query_topk("top_k").rows()) == 2
s.checkpoint()
s.disk_store.close()
s2 = SnappySession(data_dir=d, device="cpu")
assert s2.sql("SELECT count(*) FROM r").rows() == [(1,)]
assert "r_name" in s2.catalog._indexes
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_serving_indexes_policies_and_aqp_import_no_jax():
    """Prepared statements with the micro-batcher, the group-index cache,
    indexes, policies, sample tables, WITH ERROR, TopK and their recovery
    run without JAX or the JAX package."""
    out = _run(_SERVING_AQP)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_OBSERVABILITY_SECURITY = r"""
import os, sys, tempfile
import numpy as np
from snappydata_tpu_torch import SnappySession, security
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.observability import (metric_names, metrics,
                                               stats_service, tracing)
from snappydata_tpu_torch.reliability import failpoints
from snappydata_tpu_torch.security import auth

d = tempfile.mkdtemp()
s = SnappySession(catalog=Catalog(), data_dir=d, recover=False, device="cpu")
s.sql("CREATE TABLE t (g BIGINT, v DOUBLE) USING column")
s.insert_arrays("t", [np.arange(100) % 4, np.arange(100, dtype=float)])
rows = s.sql("EXPLAIN ANALYZE SELECT g, sum(v) FROM t GROUP BY g").rows()
assert any("trace_id=" in r[0] for r in rows), rows
s.sql("GRANT SELECT ON t TO alice")
assert s.for_user("alice").sql("SELECT count(*) FROM t").rows() == [(100,)]
mod = os.path.join(d, "obsmod.py")
with open(mod, "w") as fh:
    fh.write("X = 5\n")
s.sql(f"DEPLOY JAR obs '{mod}'")
assert s.sql("EXEC PYTHON 'import obsmod; result = [obsmod.X]'").rows() \
    == [(5,)]
assert stats_service.TableStatsService(s.catalog).collect_once()["t"][
    "row_count"] == 100
assert metrics.global_registry().to_prometheus()
assert tracing.ring().traces(5)
failpoints.arm_from_spec("x.y=raise@1")
failpoints.clear()
assert security.make_provider(s.conf) is None
s.checkpoint()
s.disk_store.close()
s2 = SnappySession(data_dir=d, device="cpu")
assert s2.catalog._grants == {("alice", "t"): {"select"}}
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_observability_security_and_code_surfaces_import_no_jax():
    """The metrics, tracing, stats-service and metric-name modules,
    EXPLAIN ANALYZE, grants and their recovery, the auth providers,
    DEPLOY / EXEC PYTHON and the failpoint spec grammar run without JAX
    or the JAX package."""
    out = _run(_OBSERVABILITY_SECURITY)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_FRONT_DOORS_STREAMS = r"""
import json, os, sys, tempfile, threading, time, urllib.request
import numpy as np
from snappydata_tpu_torch import SnappySession, reliability
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.cluster import SnappyClient
from snappydata_tpu_torch.cluster import flight_server, flightsql, rest, retry
from snappydata_tpu_torch.observability import TableStatsService
from snappydata_tpu_torch.sql import plan_json
from snappydata_tpu_torch.sql.parser import parse
from snappydata_tpu_torch.streaming import kafka, query, sink

s = SnappySession(catalog=Catalog(), device="cpu")
s.sql("CREATE TABLE t (g BIGINT, v DOUBLE) USING column")
s.insert_arrays("t", [np.arange(100) % 4, np.arange(100, dtype=float)])
srv = flight_server.SnappyFlightServer(s)
threading.Thread(target=srv.serve, daemon=True).start()
srv.wait_ready()
c = SnappyClient(address=f"127.0.0.1:{srv.port}")
assert c.sql("SELECT sum(v) FROM t").column(0)[0].as_py() == 4950.0
plan = plan_json.to_json(parse("SELECT g, count(*) FROM t GROUP BY g "
                               "ORDER BY g").plan)
assert c.plan(plan).num_rows == 4
fs = flightsql.FlightSqlClient(f"127.0.0.1:{srv.port}")
assert fs.execute("SELECT count(*) AS n FROM t").column(0)[0].as_py() == 100
fs.close()
c.close()
srv.shutdown()
svc = rest.RestService(s, TableStatsService(s.catalog)).start()
req = urllib.request.Request(
    f"http://{svc.host}:{svc.port}/sql",
    data=json.dumps({"sql": "SELECT count(*) FROM t"}).encode(),
    headers={"Content-Type": "application/json"})
assert json.loads(urllib.request.urlopen(req).read())["rows"] == [[100]]
svc.stop()
assert reliability.is_retryable(ConnectionError())
assert retry.ExponentialBackoff(0.1, 1.0, jitter=0.0).delay(1) == 0.2
d = tempfile.mkdtemp()
b = kafka.FileBroker(os.path.join(d, "b"), num_partitions=2)
b.produce("ev", [{"id": i, "v": 1.0} for i in range(50)])
s2 = SnappySession(catalog=Catalog(), data_dir=os.path.join(d, "s"),
                   recover=False, device="cpu")
s2.sql("CREATE STREAM TABLE ks (id BIGINT, v DOUBLE) USING kafka_stream "
       f"OPTIONS (topic 'ev', brokers 'file://{d}/b', key_columns 'id', "
       "interval '0.01')")
deadline = time.time() + 20
while time.time() < deadline and \
        s2.sql("SELECT count(*) FROM ks").rows()[0][0] < 50:
    time.sleep(0.05)
assert s2.sql("SELECT count(*) FROM ks WINDOW (DURATION 1 MINUTES)"
              ).rows() == [(50,)]
s2.sql("DROP TABLE ks")
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_front_doors_plan_json_and_streams_import_no_jax():
    """`cluster/` (Flight, Flight SQL, REST, the client and its retry
    layer), `sql/plan_json.py` and `streaming/` run without JAX or the
    JAX package."""
    out = _run(_FRONT_DOORS_STREAMS)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_MEMBERSHIP_CLI = r"""
import contextlib, io, runpy, sys, tempfile
from snappydata_tpu_torch import SnappySession, cli
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.cluster import (LeadNode, LocatorNode, ServerNode,
                                          SnappyClient)

loc = LocatorNode().start()
server = ServerNode(loc.address, SnappySession(catalog=Catalog(),
                                               device="cpu")).start()
lead = LeadNode(loc.address, SnappySession(catalog=Catalog(), device="cpu"),
                lease_s=0.5).start(wait_for_primary=True)
assert lead.is_primary and lead.rest_address
c = SnappyClient(locator=loc.address)
c.execute("CREATE TABLE t (k BIGINT) USING column")
c.execute("INSERT INTO t VALUES (1), (2)")
assert c.sql("SELECT sum(k) FROM t").column(0)[0].as_py() == 3
c.close()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert cli.main(["sql", "--locator", loc.address, "-e",
                     "SELECT count(*) FROM t"]) == 0
    sys.argv = ["snappydata_tpu_torch", "status", "--locator", loc.address]
    try:
        runpy.run_module("snappydata_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
assert "(2 members)" in out.getvalue(), out.getvalue()
lead.stop()
server.stop()
loc.stop()
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_membership_and_cli_import_no_jax():
    """The locator, the server and lead nodes, the client's locator
    discovery, `cli.py` and `python -m snappydata_tpu_torch` run without
    JAX or the JAX package."""
    out = _run(_MEMBERSHIP_CLI)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_DISTRIBUTED = r"""
import sys
import numpy as np
from snappydata_tpu_torch import SnappySession, reliability
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.cluster import LeadNode, LocatorNode, ServerNode
from snappydata_tpu_torch.cluster.distributed import (DistributedError,
                                                      DistributedSession)
from snappydata_tpu_torch.utils import tpch

loc = LocatorNode().start()
servers = [ServerNode(loc.address, SnappySession(catalog=Catalog(),
                                                 device="cpu")).start()
           for _ in range(2)]
ds = DistributedSession(locator=loc.address, device="cpu")
ds.sql(tpch.LINEITEM_DDL)
li = tpch.gen_lineitem(4000, 3)
ds.insert_arrays("lineitem", list(li.values()))
assert ds.sql("SELECT count(*) FROM lineitem").rows()[0][0] == 4000
assert len(ds.sql(tpch.Q1).rows()) == 4 and ds.sql(tpch.Q6).rows()
ds.sql("CREATE SAMPLE TABLE ls ON lineitem OPTIONS (qcs 'l_returnflag', "
       "reservoir_size '50')")
assert ds.sql("SELECT count(*) AS c, absolute_error(c) FROM lineitem "
              "WITH ERROR 0.5").rows()[0][0] == 4000
assert reliability.is_retryable(DistributedError("x"))
lead = LeadNode(loc.address, SnappySession(catalog=Catalog(), device="cpu"),
                lease_s=0.5).start(wait_for_primary=True)
assert lead.rest.distributed is not None
assert lead.rest.distributed.rebalance()["moved_buckets"] == 0
lead.stop()
ds.close()
for s in servers:
    s.stop()
loc.stop()
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_distributed_session_imports_no_jax():
    """`cluster/distributed.py` (scatter-gather, the exchanges, the
    bucket actions it drives), the lead's cluster view, the distributed
    estimator and `is_retryable` run without JAX or the JAX package."""
    out = _run(_DISTRIBUTED)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_MESH = r"""
import socket, sys
import numpy as np
from snappydata_tpu_torch import SnappySession, config
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.engine import mesh_exec
from snappydata_tpu_torch.parallel import (BucketMap, MeshContext,
                                           buckets, data_mesh, mesh,
                                           multihost, placement)
from snappydata_tpu_torch.storage.device import device_cache_bytes_by_device

config.global_properties().mesh_slots = 4
s = SnappySession(catalog=Catalog(), device="cpu")
s.sql("CREATE TABLE t (g STRING, k BIGINT, v DOUBLE) USING column")
s.insert_arrays("t", [np.array(["a", "b"], dtype=object)[np.arange(4000) % 2],
                      np.arange(4000) % 50, np.ones(4000)])
s.sql("CREATE TABLE d (k BIGINT, w DOUBLE) USING column")
s.insert_arrays("d", [np.arange(50), np.arange(50, dtype=float)])
s.default_mesh = data_mesh(4)
assert s.sql("SELECT g, count(*), sum(v) FROM t GROUP BY g ORDER BY g"
             ).rows() == [("a", 2000, 2000.0), ("b", 2000, 2000.0)]
config.global_properties().mesh_join_strategy = "shuffle"
assert s.sql("SELECT g, sum(w) FROM t JOIN d ON t.k = d.k GROUP BY g "
             "ORDER BY g").rows() == [("a", 48000.0), ("b", 50000.0)]
assert s.resize_mesh(2)["num_devices"] == 2
assert len([k for k in device_cache_bytes_by_device(
    [("t", s.catalog.describe("t").data)]) if k.startswith("slot")]) == 2
port = socket.socket(); port.bind(("127.0.0.1", 0))
addr = "127.0.0.1:%d" % port.getsockname()[1]; port.close()
assert multihost.initialize_multihost(addr, 1, 0)
assert multihost.local_device_indices() == [0, 1, 2, 3]
multihost.shutdown()
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_mesh_lane_and_multihost_import_no_jax():
    """The slot mesh, its placement and bucket map, the per-slot partial
    lane with a shuffle join, a live resize and a one-rank torch.distributed
    world run without JAX or the JAX package."""
    out = _run(_MESH)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


_TAIL = r"""
import sys
import numpy as np
from snappydata_tpu_torch import SnappySession, native
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.utils import tpcds

codes, nulls = native.fast_encode_strings(
    np.array(["x", None, "y", "x"], dtype=object), {}, [])
assert codes.tolist() == [0, 0, 1, 0] and nulls.tolist() == [
    False, True, False, False]
s = SnappySession(catalog=Catalog(), device="cpu")
tpcds.load_tpcds(s, sf=0.001, seed=3)
assert s.sql(tpcds.QUERIES["q36"]).rows()
s.sql("CREATE TABLE p (x INT) USING parquet")
assert s.catalog.describe("p").provider == "parquet"
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "snappydata_tpu" or m.startswith("snappydata_tpu."))
print("LEAKED", leaked)
"""


def test_native_encoder_tpcds_and_providers_import_no_jax():
    """The native string encoder, the TPC-DS kit and a table of another
    provider run without JAX or the JAX package."""
    out = _run(_TAIL)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
