"""The lock-lint gate over the port: `python -m tools.locklint
snappydata_tpu_torch --manifest snappydata_tpu_torch/lock_order.toml`
reports no undeclared lock-order edge and no unwaived blocking-call,
callback, metric or exception finding.  The port's manifest is its own
copy of tools/locklint/lock_order.toml with the port's additions, and it
must stay a valid hierarchy that keeps every ordering of the reference's."""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.lockdep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(ROOT, "snappydata_tpu_torch", "lock_order.toml")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def test_locklint_clean_on_the_port():
    res = subprocess.run(
        [sys.executable, "-m", "tools.locklint", "snappydata_tpu_torch",
         "--manifest", MANIFEST],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "clean" in res.stdout


def test_port_manifest_keeps_the_references_hierarchy():
    from tools.locklint import load_manifest

    ref, port = load_manifest(), load_manifest(MANIFEST)
    names = {"storage.mutation_lock", "views.matview", "mvcc.clock",
             "mvcc.pin", "storage.column_table", "parallel.mesh_dispatch",
             "executor.pre_cache", "storage.tier", "native.loader",
             "observability.metrics_registry"}
    for a in names:
        for b in names - {a}:
            if ref.allows(a, b):
                assert port.allows(a, b), (a, b)
    # the port's two additions: the fenced run's group-index cache, and
    # the kernel loader as a leaf
    assert port.allows("parallel.mesh_dispatch", "executor.pre_cache")
    assert not port.allows("executor.pre_cache", "parallel.mesh_dispatch")
    assert port.allows("storage.column_table", "ops.cuda_build")
    assert not port.allows("ops.cuda_build", "storage.column_table")
