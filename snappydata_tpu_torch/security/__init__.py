"""Pluggable authentication providers (ref: the gemfirexd auth-provider
surface — `auth-provider=BUILTIN|LDAP` with `auth-ldap-server` /
`auth-ldap-search-base`, exercised by
cluster/src/dunit/scala/io/snappydata/cluster/ClusterManagerLDAPTestBase.scala:97-102,
and SecurityUtils.scala in core)."""

from snappydata_tpu_torch.security.auth import (
    AuthProvider,
    BuiltinAuthProvider,
    LdapAuthProvider,
    make_provider,
)

__all__ = [
    "AuthProvider",
    "BuiltinAuthProvider",
    "LdapAuthProvider",
    "make_provider",
]
