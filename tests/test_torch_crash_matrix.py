"""The port's crash-recovery matrix, case by case the reference's
tests/test_crash_matrix.py on the CPU: kill the process (abandon the
session and reopen the data directory) at every armed durability
failpoint of the WAL and checkpoint paths of snappydata_tpu_torch, and
prove recovery never loses an acked row and never applies a mutation
twice.  Each cell is seeded and deterministic: same seed, same faults,
same surviving state.  Parity: the same cell run through the reference
recovers the same key set."""

import pytest

from snappydata_tpu_torch import SnappySession
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.reliability import failpoints as rfail

pytestmark = pytest.mark.faults

# every durability seam the matrix kills at, with the action that
# models the real failure there
MATRIX = [
    ("wal.append", "raise", 0),
    ("wal.append", "return_errno", 0),
    ("wal.fsync", "return_errno", 0),      # fsync EIO: group poisoned
    ("wal.fsync", "raise", 0),
    ("checkpoint.write", "raise", 0),
    ("checkpoint.publish", "raise", 0),    # torn manifest swap
    ("wal.salvage", "sleep", 2),           # fault DURING recovery
]


@pytest.fixture(autouse=True)
def _clean():
    rfail.clear()
    rfail.reseed(99)
    yield
    rfail.clear()


def _verify(dirn, acked: dict, attempted: dict) -> dict:
    """Reopen and check the three invariants: no acked row lost, no key
    duplicated, no value that was never written.  Returns the surviving
    key->value map (acked plus any unacked WAL survivors)."""
    s = SnappySession(data_dir=dirn, recover=True, device="cpu")
    try:
        rows = s.sql("SELECT k, v FROM t").rows()
        got = {}
        for k, v in rows:
            k = int(k)
            assert k not in got, f"key {k} applied twice"
            got[k] = float(v)
        lost = set(acked) - set(got)
        assert not lost, f"acked rows lost: {sorted(lost)[:5]}"
        for k, v in got.items():
            assert k in attempted, f"phantom key {k}"
            assert v == pytest.approx(attempted[k]), (k, v)
        return got
    finally:
        s.disk_store.close()


@pytest.mark.parametrize("point,action,param",
                         MATRIX, ids=[f"{p}-{a}" for p, a, _ in MATRIX])
def test_crash_at_failpoint_loses_nothing(tmp_path, point, action, param):
    dirn = str(tmp_path)
    s = SnappySession(catalog=Catalog(), data_dir=dirn, recover=False,
                      device="cpu")
    s.sql("CREATE TABLE t (k BIGINT, v DOUBLE) USING column")
    acked, attempted = {}, {}

    def insert(s, k0, n=16):
        rows = [(k0 + i, (k0 + i) * 0.5) for i in range(n)]
        attempted.update(rows)
        s.insert("t", *rows)
        acked.update(rows)

    insert(s, 0)
    s.checkpoint()
    insert(s, 100)
    if point == "wal.salvage":
        # the fault fires during the RECOVERY below, not before it
        s.disk_store.close()
        rfail.arm(point, action, param=param, count=1)
        got = _verify(dirn, acked, attempted)
        assert rfail.fired_counts().get(point) == 1, \
            "salvage failpoint never exercised"
        assert set(acked) <= set(got)
        return
    rfail.arm(point, action, param=param, count=1)
    faulted = False
    try:
        insert(s, 200)
        s.checkpoint()
        insert(s, 300)
    except Exception:
        faulted = True          # crash HERE: abandon the session
    if action != "sleep":
        assert faulted or point.startswith("checkpoint"), \
            f"{point}={action} never surfaced"
    rfail.clear()
    try:
        s.disk_store.close()
    except Exception:
        pass
    got = _verify(dirn, acked, attempted)

    # recovery must be idempotent: boot a second time, identical state
    got2 = _verify(dirn, dict.fromkeys(got, 0) and
                   {k: attempted[k] for k in got}, attempted)
    assert got2 == got, "second recovery diverged from the first"


def test_matrix_is_deterministic(tmp_path):
    """Same seed + same schedule => byte-identical surviving key sets."""
    def run(sub):
        dirn = str(tmp_path / sub)
        rfail.clear()
        rfail.reseed(7)
        s = SnappySession(catalog=Catalog(), data_dir=dirn, recover=False,
                      device="cpu")
        s.sql("CREATE TABLE t (k BIGINT, v DOUBLE) USING column")
        acked = set()
        rfail.arm("wal.fsync", "return_errno", prob=0.3)
        for i in range(12):
            try:
                s.insert("t", (i, i * 0.5))
                acked.add(i)
            except Exception:
                break
        rfail.clear()
        try:
            s.disk_store.close()
        except Exception:
            pass
        s2 = SnappySession(data_dir=dirn, recover=True, device="cpu")
        got = {int(r[0]) for r in s2.sql("SELECT k FROM t").rows()}
        s2.disk_store.close()
        assert acked <= got
        return got

    assert run("a") == run("b")


@pytest.mark.parametrize("point,action,param", MATRIX[:4],
                         ids=[f"{p}-{a}" for p, a, _ in MATRIX[:4]])
def test_crash_cell_survivors_equal_the_reference(tmp_path, point, action,
                                                  param):
    """One matrix cell through both packages, same seed: the recovered
    key sets are equal."""
    from snappydata_tpu import SnappySession as RefSession
    from snappydata_tpu.catalog import Catalog as RefCatalog
    from snappydata_tpu.reliability import failpoints as ref_rfail

    def run(make, reg, dirn, reopen):
        reg.clear()
        reg.reseed(99)
        s = make(dirn)
        s.sql("CREATE TABLE t (k BIGINT, v DOUBLE) USING column")
        s.insert("t", *[(k, k * 0.5) for k in range(16)])
        s.checkpoint()
        reg.arm(point, action, param=param, count=1)
        try:
            s.insert("t", *[(k, k * 0.5) for k in range(100, 116)])
            s.checkpoint()
        except Exception:
            pass
        reg.clear()
        try:
            s.disk_store.close()
        except Exception:
            pass
        s2 = reopen(dirn)
        got = sorted(int(r[0]) for r in s2.sql("SELECT k FROM t").rows())
        s2.disk_store.close()
        return got

    port = run(lambda d: SnappySession(catalog=Catalog(), data_dir=d,
                                       recover=False, device="cpu"),
               rfail, str(tmp_path / "port"),
               lambda d: SnappySession(data_dir=d, recover=True,
                                       device="cpu"))
    ref = run(lambda d: RefSession(catalog=RefCatalog(), data_dir=d,
                                   recover=False),
              ref_rfail, str(tmp_path / "ref"),
              lambda d: RefSession(data_dir=d, recover=True))
    assert port == ref
