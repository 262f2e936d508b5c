"""DEPLOY JAR / PACKAGE, UNDEPLOY, LIST JARS / PACKAGES and EXEC PYTHON
through the port: the cases of tests/test_deploy.py, each run through
both packages with the same artifacts (the same rows and errors), plus
recovery of a deployed artifact across packages."""

import os
import sys
import zipfile

import pytest

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu_torch import SnappySession
from snappydata_tpu_torch.catalog import Catalog


def _port(**kw):
    return SnappySession(device="cpu", **kw)


MAKERS = {"port": _port, "ref": RefSession}
CATALOGS = {"port": Catalog, "ref": RefCatalog}


def _write_module(tmp_path, name="depmod", value=41):
    p = tmp_path / f"{name}.py"
    p.write_text(f"MAGIC = {value}\n\ndef answer():\n    return MAGIC + 1\n")
    return str(p)


def _drop_modules(*names):
    for n in names:
        sys.modules.pop(n, None)


@pytest.fixture(autouse=True)
def _clean_modules():
    before = list(sys.path)
    yield
    sys.path[:] = before  # deploys are process-wide; isolate tests
    _drop_modules("depmod", "zipmod", "othermod", "util")


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return request.param


def _session(pkg, **kw):
    return MAKERS[pkg](catalog=CATALOGS[pkg](), **kw)


def test_deploy_module_and_exec(tmp_path, pkg):
    s = _session(pkg)
    path = _write_module(tmp_path)
    s.sql(f"DEPLOY JAR depjar '{path}'")
    r = s.sql("EXEC PYTHON 'import depmod; result = [depmod.answer()]'")
    assert r.rows()[0][0] == 42
    rows = s.sql("LIST JARS").rows()
    assert [r[0] for r in rows] == ["depjar"]
    assert rows[0][2] is False or rows[0][2] == False  # noqa: E712
    assert s.sql("LIST PACKAGES").num_rows == 0


def test_deploy_zip_package(tmp_path, pkg):
    s = _session(pkg)
    zpath = str(tmp_path / "zippkg.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        z.writestr("zipmod.py", "VALUE = 'from-zip'\n")
    s.sql(f"DEPLOY PACKAGE zpkg '{zpath}'")
    r = s.sql("EXEC PYTHON 'import zipmod; result = [zipmod.VALUE]'")
    assert r.rows()[0][0] == "from-zip"
    rows = s.sql("LIST PACKAGES").rows()
    assert [x[0] for x in rows] == ["zpkg"]
    assert bool(rows[0][2]) is True


def test_undeploy_removes_path(tmp_path, pkg):
    s = _session(pkg)
    path = _write_module(tmp_path)
    s.sql(f"DEPLOY JAR depjar '{path}'")
    root = os.path.dirname(path)
    assert root in sys.path
    s.sql("UNDEPLOY depjar")
    assert root not in sys.path
    assert s.sql("LIST JARS").num_rows == 0
    with pytest.raises(ValueError, match="nothing deployed"):
        s.sql("UNDEPLOY depjar")


def test_deploy_missing_artifact_is_loud(pkg):
    s = _session(pkg)
    with pytest.raises(ValueError, match="not found"):
        s.sql("DEPLOY JAR nope '/no/such/file.whl'")
    with pytest.raises(ValueError, match="egress"):
        s.sql("DEPLOY PACKAGE gavfmt 'com.example:artifact:1.0'")


def test_deploy_requires_admin(tmp_path, pkg):
    s = _session(pkg)
    path = _write_module(tmp_path)
    s.sql("CREATE TABLE t (x INT) USING column")
    user = s.for_user("alice")
    with pytest.raises(PermissionError):
        user.sql(f"DEPLOY JAR depjar '{path}'")
    # an unauthenticated network admin is refused as well
    remote_admin = s.for_user("admin", remote=True, authenticated=False)
    with pytest.raises(PermissionError, match="network surfaces"):
        remote_admin.sql(f"DEPLOY JAR depjar '{path}'")
    with pytest.raises(PermissionError, match="network surfaces"):
        remote_admin.sql("EXEC PYTHON 'result = [1]'")
    ok = s.for_user("admin", remote=True, authenticated=True)
    assert ok.sql("EXEC PYTHON 'result = [7]'").rows()[0][0] == 7


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "ref"),
                                           ("ref", "port"), ("ref", "ref")])
def test_deploy_persists_across_recovery(tmp_path, writer, reader):
    data = str(tmp_path / "store")
    src = _write_module(tmp_path, value=7)
    s = MAKERS[writer](data_dir=data)
    s.sql(f"DEPLOY JAR persisted '{src}'")
    # the artifact is copied INTO the store: the original may vanish
    os.remove(src)
    s.checkpoint()
    s.disk_store.close()

    _drop_modules("depmod")
    root = os.path.dirname(src)
    while root in sys.path:
        sys.path.remove(root)

    s2 = MAKERS[reader](data_dir=data)
    r = s2.sql("EXEC PYTHON 'import depmod; result = [depmod.answer()]'")
    assert r.rows()[0][0] == 8
    assert [x[0] for x in s2.sql("LIST JARS").rows()] == ["persisted"]

    s2.sql("UNDEPLOY persisted")
    s2.disk_store.close()
    s3 = MAKERS[reader](data_dir=data)
    assert s3.sql("LIST JARS").num_rows == 0
    s3.disk_store.close()


def test_redeploy_replaces(tmp_path, pkg):
    s = _session(pkg)
    p1 = _write_module(tmp_path, value=1)
    s.sql(f"DEPLOY JAR depjar '{p1}'")
    sub = tmp_path / "v2"
    sub.mkdir()
    p2 = _write_module(sub, value=100)
    s.sql(f"DEPLOY JAR depjar '{p2}'")
    _drop_modules("depmod")
    r = s.sql("EXEC PYTHON 'import depmod; result = [depmod.answer()]'")
    assert r.rows()[0][0] == 101
    assert s.sql("LIST JARS").num_rows == 1


def test_deploy_same_basename_no_overwrite(tmp_path, pkg):
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir(), b.mkdir()
    (a / "util.py").write_text("WHO = 'a'\n")
    (b / "util.py").write_text("WHO = 'b'\n")
    data = str(tmp_path / "store")
    s = _session(pkg, data_dir=data)
    s.sql(f"DEPLOY JAR both '{a / 'util.py'}, {b / 'util.py'}'")
    stored = s._deployed()["both"]["files"]
    assert len(stored) == len(set(stored)) == 2
    assert all(os.path.exists(f) for f in stored)
    assert [os.path.basename(f) for f in stored] == \
        ["0_util.py", "1_util.py"]
    s.disk_store.close()


def test_exec_python_namespace_and_output(pkg):
    """The namespace binds the session and persists across statements;
    stdout comes back when no `result` is set; ragged rows raise."""
    s = _session(pkg)
    s.sql("CREATE TABLE t (x INT) USING column")
    s.sql("INSERT INTO t VALUES (1), (2), (3)")
    s.sql("EXEC PYTHON 'n = session.sql(\"SELECT count(*) FROM t\")"
          ".rows()[0][0]'")
    assert s.sql("EXEC PYTHON 'result = [(n, n * 2)]'").rows() == [(3, 6)]
    assert s.sql("EXEC PYTHON 'print(n + 1)'").rows() == [("4\n",)]
    with pytest.raises(ValueError, match="uneven arity"):
        s.sql("EXEC PYTHON 'result = [(1, 2), (3,)]'")
