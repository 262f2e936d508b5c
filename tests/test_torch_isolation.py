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
