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
