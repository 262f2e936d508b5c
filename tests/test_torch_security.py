"""GRANT / REVOKE, the session principal and the authentication providers
of the port, held against the reference.

The cases of tests/test_security.py run through both packages with the
same statements and must raise the same errors (type and message); the
grants survive a restart, and each package recovers the other's data
directory with grants in it.  The provider cases of
tests/test_auth_providers.py that need no Flight or REST run against the
port's `security/auth.py` and the same in-process LDAP server.  The
intruder case of tests/test_serving.py runs on the port's registry."""

import numpy as np
import pytest

from snappydata_tpu import SnappySession as RefSession
from snappydata_tpu.catalog import Catalog as RefCatalog
from snappydata_tpu.security import auth as ref_auth
from snappydata_tpu_torch import SnappySession
from snappydata_tpu_torch.catalog import Catalog
from snappydata_tpu_torch.config import Properties
from snappydata_tpu_torch.security import (BuiltinAuthProvider,
                                           LdapAuthProvider, make_provider)
from snappydata_tpu_torch.security.auth import (ber, ber_children, ber_int,
                                                ber_read, escape_dn_value)
from test_auth_providers import DIRECTORY, UIDS, MiniLdapServer

# the in-process directory's passwords (tests/test_auth_providers.py)
ALICE_PW = DIRECTORY[UIDS["alice"]]
BOB_PW = DIRECTORY[UIDS["bob"]]


def _port(**kw):
    return SnappySession(device="cpu", **kw)


MAKERS = {"port": _port, "ref": RefSession}
CATALOGS = {"port": Catalog, "ref": RefCatalog}


@pytest.fixture(params=["port", "ref"])
def env(request):
    make, cat = MAKERS[request.param], CATALOGS[request.param]
    catalog = cat()
    admin = make(catalog=catalog)  # default user: admin
    admin.sql("CREATE TABLE t (a INT) USING column")
    admin.sql("INSERT INTO t VALUES (1), (2)")
    alice = make(catalog=catalog, user="alice")
    yield admin, alice


def _errors(fn):
    """(type name, message) of what `fn` raises in each package."""
    out = []
    for pkg in ("port", "ref"):
        try:
            fn(pkg)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - compared below
            out.append((type(e).__name__, str(e)))
    return out


def _pair_env():
    out = {}
    for pkg in ("port", "ref"):
        catalog = CATALOGS[pkg]()
        admin = MAKERS[pkg](catalog=catalog)
        admin.sql("CREATE TABLE t (a INT) USING column")
        admin.sql("INSERT INTO t VALUES (1), (2)")
        out[pkg] = (admin, MAKERS[pkg](catalog=catalog, user="alice"))
    return out


def test_unprivileged_user_denied(env):
    admin, alice = env
    with pytest.raises(PermissionError, match="SELECT"):
        alice.sql("SELECT * FROM t")
    with pytest.raises(PermissionError, match="INSERT"):
        alice.sql("INSERT INTO t VALUES (3)")
    with pytest.raises(PermissionError, match="admin-only"):
        alice.sql("DROP TABLE t")


def test_denials_give_the_references_messages():
    envs = _pair_env()
    for stmt in ("SELECT * FROM t", "INSERT INTO t VALUES (3)",
                 "DROP TABLE t", "UPDATE t SET a = 0", "DELETE FROM t",
                 "GRANT SELECT ON t TO bob", "REVOKE SELECT ON t FROM bob",
                 "EXPLAIN SELECT * FROM t", "SET x = 1",
                 "CREATE VIEW v AS SELECT a FROM t",
                 "DEPLOY JAR j '/no/such.whl'",
                 "EXEC PYTHON 'result = [1]'"):
        port, ref = _errors(lambda pkg: envs[pkg][1].sql(stmt))
        assert port == ref and port is not None, (stmt, port, ref)
    port, ref = _errors(lambda pkg: envs[pkg][1].insert("t", (5,)))
    assert port == ref and port[0] == "PermissionError"


def test_grant_then_revoke(env):
    admin, alice = env
    admin.sql("GRANT SELECT, INSERT ON t TO alice")
    assert alice.sql("SELECT count(*) FROM t").rows()[0][0] == 2
    alice.sql("INSERT INTO t VALUES (3)")
    with pytest.raises(PermissionError, match="UPDATE"):
        alice.sql("UPDATE t SET a = 0 WHERE a = 1")
    admin.sql("REVOKE INSERT ON t FROM alice")
    with pytest.raises(PermissionError, match="INSERT"):
        alice.sql("INSERT INTO t VALUES (4)")
    assert alice.sql("SELECT count(*) FROM t").rows()[0][0] == 3


def test_grant_all_and_subquery_tables_checked(env):
    admin, alice = env
    admin.sql("CREATE TABLE u (b INT) USING column")
    admin.sql("INSERT INTO u VALUES (1)")
    admin.sql("GRANT ALL ON t TO alice")
    alice.sql("UPDATE t SET a = 9 WHERE a = 1")
    with pytest.raises(PermissionError, match="lacks SELECT on u"):
        alice.sql("SELECT * FROM t WHERE a IN (SELECT b FROM u)")


def test_only_admin_grants(env):
    admin, alice = env
    with pytest.raises(PermissionError, match="only admin"):
        alice.sql("GRANT SELECT ON t TO bob")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_denied_dml_never_reaches_wal(tmp_path, pkg):
    make, cat = MAKERS[pkg], CATALOGS[pkg]
    catalog = cat()
    admin = make(catalog=catalog, data_dir=str(tmp_path), recover=False)
    alice = make(catalog=catalog, user="alice")
    alice.disk_store = admin.disk_store
    admin.sql("CREATE TABLE secret (k INT) USING column")
    admin.sql("INSERT INTO secret VALUES (42)")
    with pytest.raises(PermissionError):
        alice.sql("DELETE FROM secret WHERE k = 42")
    admin.disk_store.close()
    s2 = make(data_dir=str(tmp_path))
    assert s2.sql("SELECT count(*) FROM secret").rows()[0][0] == 1


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "ref"),
                                           ("ref", "port")])
def test_grants_survive_restart(tmp_path, writer, reader):
    """Grants persist in catalog.json; either package recovers the
    other's directory with them."""
    admin = MAKERS[writer](catalog=CATALOGS[writer](),
                           data_dir=str(tmp_path), recover=False)
    admin.sql("CREATE TABLE t (a INT) USING column")
    admin.sql("INSERT INTO t VALUES (1)")
    admin.sql("GRANT SELECT, INSERT ON t TO alice")
    admin.sql("GRANT SELECT ON t TO bob")
    admin.sql("REVOKE SELECT ON t FROM bob")
    admin.disk_store.close()
    s2 = MAKERS[reader](data_dir=str(tmp_path))
    assert s2.catalog._grants == {("alice", "t"): {"select", "insert"}}
    alice = MAKERS[reader](catalog=s2.catalog, user="alice")
    assert alice.sql("SELECT count(*) FROM t").rows()[0][0] == 1
    bob = MAKERS[reader](catalog=s2.catalog, user="bob")
    with pytest.raises(PermissionError, match="SELECT"):
        bob.sql("SELECT count(*) FROM t")
    s2.disk_store.close()


def test_subquery_exfiltration_denied(env):
    admin, alice = env
    admin.sql("CREATE TABLE secret (k INT) USING column")
    admin.sql("INSERT INTO secret VALUES (42)")
    admin.sql("GRANT ALL ON t TO alice")
    with pytest.raises(PermissionError, match="secret"):
        alice.sql("UPDATE t SET a = (SELECT max(k) FROM secret)")
    with pytest.raises(PermissionError, match="secret"):
        alice.sql("DELETE FROM t WHERE a IN (SELECT k FROM secret)")
    with pytest.raises(PermissionError, match="secret"):
        alice.sql("INSERT INTO t VALUES ((SELECT max(k) FROM secret))")


def test_put_requires_update_priv(env):
    admin, alice = env
    admin.sql("CREATE TABLE kv (k INT PRIMARY KEY, v INT) USING row")
    admin.sql("GRANT INSERT ON kv TO alice")
    with pytest.raises(PermissionError, match="UPDATE"):
        alice.sql("PUT INTO kv VALUES (1, 2)")
    admin.sql("GRANT UPDATE ON kv TO alice")
    alice.sql("PUT INTO kv VALUES (1, 2)")


def test_grant_on_view(env):
    admin, alice = env
    admin.sql("CREATE VIEW tv AS SELECT a FROM t")
    admin.sql("GRANT SELECT ON tv TO alice")
    assert alice.sql("SELECT count(*) FROM tv").rows()[0][0] == 2


def test_policy_composes_with_grants(env):
    admin, alice = env
    admin.sql("GRANT SELECT ON t TO alice")
    admin.sql("CREATE POLICY p ON t USING a > 1")
    assert alice.sql("SELECT count(*) FROM t").rows()[0][0] == 1


def test_for_user_keeps_the_parent_device_and_caches():
    s = _port(catalog=Catalog())
    u = s.for_user("alice", remote=True, authenticated=False)
    assert u.device == s.device and u.user == "alice"
    assert u.executor is s.executor and u.analyzer is s.analyzer
    assert u.remote is True and u.authenticated is False
    with pytest.raises(PermissionError, match="network surfaces"):
        u._gate_code_surface("EXEC PYTHON")


def test_denied_query_launches_nothing_and_is_never_admitted():
    """A denied principal's query raises before admission: the broker
    admits nothing and no aggregate lane runs."""
    from snappydata_tpu_torch.observability.metrics import global_registry

    s = _port(catalog=Catalog())
    s.sql("CREATE TABLE t (a DOUBLE) USING column")
    s.insert_arrays("t", [np.arange(100, dtype=np.float64)])
    reg = global_registry()
    c0 = reg.counters_snapshot()
    with pytest.raises(PermissionError):
        s.for_user("analyst").sql("SELECT sum(a) FROM t")
    c1 = reg.counters_snapshot()
    for k in ("governor_admitted", "queries", "agg_reduce_passes"):
        assert c1.get(k, 0) == c0.get(k, 0), k


def test_topk_and_approx_sql_check_grants():
    s = _port(catalog=Catalog())
    s.sql("CREATE TABLE t (k INT, v DOUBLE) USING column")
    s.insert_arrays("t", [np.arange(50, dtype=np.int32) % 5,
                          np.arange(50, dtype=np.float64)])
    s.create_topk("tk", "t", "k", k=3)
    u = s.for_user("alice")
    with pytest.raises(PermissionError, match="SELECT on t"):
        u.query_topk("tk")
    with pytest.raises(PermissionError, match="SELECT on t"):
        u.create_topk("tk2", "t", "k")
    with pytest.raises(PermissionError, match="SELECT on t"):
        u.approx_sql("SELECT avg(v) FROM t")
    with pytest.raises(PermissionError, match="SELECT on t"):
        u.get("t", (1,))
    s.sql("GRANT SELECT ON t TO alice")
    assert u.query_topk("tk").num_rows == 3


# ----------------------------------------------------------------------
# the serving registry: grants at PREPARE and at every EXECUTE
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_intruder_refused_at_prepare_and_execute(pkg):
    """tests/test_serving.py's intruder case: refused at PREPARE of a
    fresh statement and at EXECUTE of a shared, already-compiled entry;
    a REVOKE under a held handle refuses its next execute."""
    make = (lambda: _port(catalog=Catalog())) if pkg == "port" \
        else (lambda: RefSession(catalog=RefCatalog()))
    s = make()
    s.sql("CREATE TABLE accounts (id BIGINT PRIMARY KEY, b DOUBLE) "
          "USING row")
    s.sql("INSERT INTO accounts VALUES (1, 2.0)")
    s.sql("CREATE TABLE txns (acct BIGINT, amt DOUBLE) USING column")
    s.insert_arrays("txns", [np.arange(100, dtype=np.int64) % 10,
                             np.arange(100, dtype=np.float64)])
    agg = "SELECT count(*), sum(amt) FROM txns WHERE acct < ?"
    s.sql("GRANT SELECT ON txns TO u1")
    h1 = s.for_user("u1").prepare(agg)
    assert h1.execute((5,)).rows()[0][0] == 50
    s3 = s.for_user("intruder")
    with pytest.raises(PermissionError):
        s3.prepare("SELECT count(*) FROM accounts WHERE id = ?")
    with pytest.raises(PermissionError):
        s3.prepare(agg).execute((1,))   # registry hit: fails at run
    s.sql("REVOKE SELECT ON txns FROM u1")
    with pytest.raises(PermissionError, match="SELECT"):
        h1.execute((5,))


# ----------------------------------------------------------------------
# authentication providers (no Flight / REST)
# ----------------------------------------------------------------------

def test_ber_roundtrip():
    for v in (0, 1, 127, 128, 255, 256, 65535, 2**31 - 1, -1, -129):
        enc = ber_int(v)
        assert enc == ref_auth.ber_int(v)
        tag, content, end = ber_read(enc)
        assert tag == 0x02 and end == len(enc)
        assert int.from_bytes(content, "big", signed=True) == v
    big = ber(0x04, b"x" * 300)
    assert big == ref_auth.ber(0x04, b"x" * 300)
    assert ber_read(big)[1] == b"x" * 300
    seq = ber(0x30, ber_int(5) + ber(0x04, b"ab"))
    assert [t for t, _ in ber_children(ber_read(seq)[1])] == [0x02, 0x04]


def test_escape_dn_value():
    for raw in ("alice", "a,b", "x+y=z", "#lead", " pad ", "q\"<>;\\",
                "nul\x00"):
        assert escape_dn_value(raw) == ref_auth.escape_dn_value(raw)
    assert escape_dn_value("a,b") == "a\\,b"


def test_builtin_plain_and_hashed():
    p = BuiltinAuthProvider({
        "alice": "pw1",
        "bob": BuiltinAuthProvider.hash_password("pw2")})
    assert p.authenticate("alice", "pw1")
    assert not p.authenticate("alice", "nope")
    assert p.authenticate("bob", "pw2")
    assert not p.authenticate("bob", "pw1")
    assert not p.authenticate("carol", "x")
    assert BuiltinAuthProvider.hash_password("pw2") == \
        ref_auth.BuiltinAuthProvider.hash_password("pw2")


def test_make_provider_from_conf():
    conf = Properties()
    assert make_provider(conf) is None
    conf.set("auth-provider", "BUILTIN")
    conf.set("auth_builtin_users", "alice:pw1,bob:pw2")
    p = make_provider(conf)
    assert p.authenticate("alice", "pw1") and p.authenticate("bob", "pw2")
    assert not p.authenticate("alice", "pw2")
    conf.set("auth-provider", "nosuch")
    with pytest.raises(ValueError, match="unknown auth_provider"):
        make_provider(conf)


@pytest.fixture()
def ldap_server():
    server = MiniLdapServer(DIRECTORY, UIDS)
    yield server
    server.close()


def test_ldap_template_bind(ldap_server):
    p = LdapAuthProvider(
        f"ldap://127.0.0.1:{ldap_server.port}",
        user_dn_template="uid={user},ou=people,dc=example,dc=com")
    assert p.authenticate("alice", ALICE_PW)
    assert p.authenticate("bob", BOB_PW)
    assert not p.authenticate("alice", BOB_PW)
    assert not p.authenticate("mallory", "x")
    n_binds = len(ldap_server.binds)
    assert not p.authenticate("alice", "")
    assert len(ldap_server.binds) == n_binds


def test_ldap_template_escapes_dn_metacharacters(ldap_server):
    p = LdapAuthProvider(
        f"ldap://127.0.0.1:{ldap_server.port}",
        user_dn_template="uid={user},ou=people,dc=example,dc=com")
    assert not p.authenticate("alice,ou=people", "x")
    assert "\\," in ldap_server.binds[-1][0]


def test_ldap_search_then_bind_anonymous(ldap_server):
    p = LdapAuthProvider(
        f"ldap://127.0.0.1:{ldap_server.port}",
        search_base="dc=example,dc=com")
    assert p.authenticate("alice", ALICE_PW)
    assert not p.authenticate("alice", "nope")
    assert not p.authenticate("eve", "x")


def test_ldap_search_then_bind_with_admin(ldap_server):
    p = LdapAuthProvider(
        f"ldap://127.0.0.1:{ldap_server.port}",
        search_base="dc=example,dc=com",
        bind_dn="cn=admin,dc=example,dc=com",
        bind_password="adminpw")
    assert p.authenticate("bob", BOB_PW)
    wrong = LdapAuthProvider(
        f"ldap://127.0.0.1:{ldap_server.port}",
        search_base="dc=example,dc=com",
        bind_dn="cn=admin,dc=example,dc=com",
        bind_password="wrongpw")
    assert not wrong.authenticate("bob", BOB_PW)


def test_ldap_server_down_is_refusal_not_crash():
    p = LdapAuthProvider("ldap://127.0.0.1:1",
                         user_dn_template="uid={user},dc=x")
    assert not p.authenticate("alice", "pw")
