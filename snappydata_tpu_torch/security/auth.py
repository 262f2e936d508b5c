"""Pluggable authentication: BUILTIN (user/password table) and LDAP
(simple bind, with optional search-then-bind DN resolution).

Reference surface: the gemfirexd `auth-provider` property accepts
BUILTIN or LDAP, with `auth-ldap-server` and `auth-ldap-search-base`
(cluster/src/dunit/scala/io/snappydata/cluster/ClusterManagerLDAPTestBase.scala:97-102;
core/src/main/scala/org/apache/spark/sql/execution/SecurityUtils.scala).
Network servers authenticate a principal once per connection and every
statement then runs under that principal's session so GRANT/REVOKE and
row-level policies apply.

The LDAP client here is a self-contained LDAPv3 implementation of the
two operations authentication needs — BindRequest and a single-entry
SearchRequest — speaking BER directly over a TCP socket (no external
LDAP library in the image). Because search filters are transmitted
*structurally* in BER (the assertion value is a raw OCTET STRING, never
spliced into a filter string), LDAP-injection via the username is not
possible by construction.
"""

from __future__ import annotations

import hashlib
import hmac
import socket
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Minimal BER codec (the subset LDAPv3 messages use)
# ---------------------------------------------------------------------------


def ber(tag: int, content: bytes) -> bytes:
    """One tag-length-value element (definite length, short or long form)."""
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    lb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(lb)]) + lb + content


def ber_int(value: int, tag: int = 0x02) -> bytes:
    """INTEGER (0x02) / ENUMERATED (0x0A): minimal two's complement."""
    if value == 0:
        body = b"\x00"
    else:
        body = value.to_bytes((value.bit_length() + 8) // 8, "big",
                              signed=True)
    return ber(tag, body)


def ber_read(buf: bytes, off: int = 0) -> Tuple[int, bytes, int]:
    """-> (tag, content, next_offset). Raises on truncated input."""
    if off + 2 > len(buf):
        raise ValueError("truncated BER element")
    tag, ln = buf[off], buf[off + 1]
    off += 2
    if ln & 0x80:
        n = ln & 0x7F
        if n == 0 or off + n > len(buf):
            raise ValueError("bad BER length")
        ln = int.from_bytes(buf[off:off + n], "big")
        off += n
    if off + ln > len(buf):
        raise ValueError("truncated BER content")
    return tag, buf[off:off + ln], off + ln


def ber_children(content: bytes):
    """All TLV children of a constructed element's content."""
    out, off = [], 0
    while off < len(content):
        tag, body, off = ber_read(content, off)
        out.append((tag, body))
    return out


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n > 0:
        part = sock.recv(n)
        if not part:
            raise ConnectionError("LDAP server closed the connection")
        chunks.append(part)
        n -= len(part)
    return b"".join(chunks)


def read_ber_message(sock: socket.socket) -> Tuple[int, bytes]:
    """Read exactly one top-level BER element from a socket."""
    header = _recv_exact(sock, 2)
    tag, ln = header[0], header[1]
    if ln & 0x80:
        ln = int.from_bytes(_recv_exact(sock, ln & 0x7F), "big")
    return tag, _recv_exact(sock, ln)


# LDAP protocol tags
LDAP_BIND_REQUEST = 0x60
LDAP_BIND_RESPONSE = 0x61
LDAP_UNBIND_REQUEST = 0x42
LDAP_SEARCH_REQUEST = 0x63
LDAP_SEARCH_ENTRY = 0x64
LDAP_SEARCH_DONE = 0x65
LDAP_AUTH_SIMPLE = 0x80

RESULT_SUCCESS = 0
RESULT_INVALID_CREDENTIALS = 49


def escape_dn_value(value: str) -> str:
    """RFC 4514 escaping for a value substituted into a DN template."""
    out = []
    for i, ch in enumerate(value):
        if ch in ',+"\\<>;=':
            out.append("\\" + ch)
        elif ch in (" ", "#") and (i == 0 or i == len(value) - 1):
            out.append("\\" + ch)
        elif ord(ch) < 0x20:
            out.append("\\%02x" % ord(ch))
        else:
            out.append(ch)
    return "".join(out)


# ---------------------------------------------------------------------------
# Providers
# ---------------------------------------------------------------------------


class AuthProvider:
    """authenticate(user, password) -> True iff the credential is valid."""

    name = "none"

    def authenticate(self, user: str, password: str) -> bool:
        raise NotImplementedError


class BuiltinAuthProvider(AuthProvider):
    """BUILTIN: a user/password table from configuration (ref: the
    gemfirexd BUILTIN provider's `gemfirexd.user.<name>=<password>`
    boot properties). Passwords may be stored plaintext or as
    "sha256:<hex>"."""

    name = "builtin"

    def __init__(self, users: Dict[str, str]):
        self.users = {str(u).lower(): str(p) for u, p in users.items()}

    @staticmethod
    def hash_password(password: str) -> str:
        return "sha256:" + hashlib.sha256(password.encode("utf-8")).hexdigest()

    def authenticate(self, user: str, password: str) -> bool:
        stored = self.users.get(str(user).lower())
        if stored is None or password is None:
            return False
        if stored.startswith("sha256:"):
            candidate = hashlib.sha256(password.encode("utf-8")).hexdigest()
            return hmac.compare_digest(stored[len("sha256:"):], candidate)
        # compare as bytes: compare_digest(str, str) raises on non-ASCII
        return hmac.compare_digest(stored.encode("utf-8"),
                                   password.encode("utf-8"))


class LdapAuthProvider(AuthProvider):
    """LDAP simple bind. Two DN-resolution modes, mirroring the
    reference's knobs:

    - template: `user_dn_template` e.g. "uid={user},ou=people,dc=ex,dc=com"
      (the common `auth-ldap-search-dn` shortcut) — bind directly.
    - search: bind as `bind_dn` (or anonymously), search `search_base`
      for `search_filter` (default "(uid={user})"), then bind as the
      found entry's DN (ref: auth-ldap-search-base behavior).
    """

    name = "ldap"

    def __init__(self, server: str,
                 user_dn_template: Optional[str] = None,
                 search_base: Optional[str] = None,
                 search_filter: str = "(uid={user})",
                 bind_dn: Optional[str] = None,
                 bind_password: str = "",
                 timeout: float = 5.0):
        if server.startswith("ldaps://"):
            raise ValueError("ldaps:// is not supported; use ldap:// "
                             "(optionally over a local stunnel)")
        hostport = server[len("ldap://"):] if server.startswith("ldap://") \
            else server
        host, _, port = hostport.partition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port) if port else 389
        if not user_dn_template and not search_base:
            raise ValueError("LDAP auth needs auth_ldap_user_template or "
                             "auth_ldap_search_base")
        self.user_dn_template = user_dn_template
        self.search_base = search_base
        self.search_filter = search_filter
        self.bind_dn = bind_dn
        self.bind_password = bind_password
        self.timeout = timeout

    # -- wire operations --------------------------------------------------

    def _connect(self) -> socket.socket:
        return socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)

    @staticmethod
    def _bind(sock: socket.socket, msg_id: int, dn: str,
              password: str) -> int:
        """Send a simple BindRequest, return the resultCode."""
        req = ber(LDAP_BIND_REQUEST,
                  ber_int(3) +
                  ber(0x04, dn.encode("utf-8")) +
                  ber(LDAP_AUTH_SIMPLE, password.encode("utf-8")))
        sock.sendall(ber(0x30, ber_int(msg_id) + req))
        _, content = read_ber_message(sock)
        children = ber_children(content)
        if len(children) < 2 or children[1][0] != LDAP_BIND_RESPONSE:
            raise ValueError("unexpected LDAP response to bind")
        result = ber_children(children[1][1])
        return int.from_bytes(result[0][1], "big", signed=True)

    def _search_dn(self, sock: socket.socket, msg_id: int,
                   user: str) -> Optional[str]:
        """SearchRequest for the user's entry; returns its DN or None.
        The filter must be a single equality like "(uid={user})" — the
        assertion value travels as a raw OCTET STRING (no injection)."""
        flt = self.search_filter.strip()
        if not (flt.startswith("(") and flt.endswith(")") and "=" in flt):
            raise ValueError(f"unsupported LDAP filter {flt!r} "
                             "(single equality only)")
        attr, _, val_tpl = flt[1:-1].partition("=")
        value = val_tpl.replace("{user}", user).replace("%u", user)
        req = ber(LDAP_SEARCH_REQUEST,
                  ber(0x04, self.search_base.encode("utf-8")) +
                  ber_int(2, 0x0A) +          # scope: wholeSubtree
                  ber_int(0, 0x0A) +          # derefAliases: never
                  ber_int(1) +                 # sizeLimit: 1 entry
                  ber_int(max(1, int(self.timeout))) +
                  b"\x01\x01\x00" +            # typesOnly: FALSE
                  ber(0xA3,                    # equalityMatch filter
                      ber(0x04, attr.strip().encode("utf-8")) +
                      ber(0x04, value.encode("utf-8"))) +
                  ber(0x30, ber(0x04, b"1.1")))  # attributes: none
        sock.sendall(ber(0x30, ber_int(msg_id) + req))
        dn = None
        while True:
            _, content = read_ber_message(sock)
            children = ber_children(content)
            op_tag, op_body = children[1]
            if op_tag == LDAP_SEARCH_ENTRY:
                if dn is None:
                    dn = ber_children(op_body)[0][1].decode("utf-8")
            elif op_tag == LDAP_SEARCH_DONE:
                code = int.from_bytes(ber_children(op_body)[0][1], "big",
                                      signed=True)
                # sizeLimitExceeded(4) with an entry in hand is fine
                if code not in (RESULT_SUCCESS, 4):
                    return None
                return dn
            else:
                raise ValueError("unexpected LDAP search response")

    # -- AuthProvider -----------------------------------------------------

    def authenticate(self, user: str, password: str) -> bool:
        if not password:
            # RFC 4513 §5.1.2: an empty password is an UNauthenticated
            # bind that servers report as "success" — must be refused
            return False
        try:
            sock = self._connect()
        except OSError:
            return False
        try:
            msg_id = 1
            if self.user_dn_template:
                dn = self.user_dn_template \
                    .replace("{user}", escape_dn_value(user)) \
                    .replace("%u", escape_dn_value(user))
            else:
                # bind before searching: as the service account when
                # configured, anonymously otherwise (RFC 4513 §5.1.1)
                if self._bind(sock, msg_id, self.bind_dn or "",
                              self.bind_password if self.bind_dn
                              else "") != RESULT_SUCCESS:
                    return False
                msg_id += 1
                dn = self._search_dn(sock, msg_id, user)
                msg_id += 1
                if dn is None:
                    return False
            code = self._bind(sock, msg_id, dn, password)
            try:
                sock.sendall(ber(0x30, ber_int(msg_id + 1) +
                                 ber(LDAP_UNBIND_REQUEST, b"")))
            except OSError:
                pass
            return code == RESULT_SUCCESS
        except (OSError, ValueError, ConnectionError, IndexError):
            return False
        finally:
            sock.close()


# ---------------------------------------------------------------------------
# Configuration entry point
# ---------------------------------------------------------------------------


def make_provider(conf) -> Optional[AuthProvider]:
    """Build the configured provider from session properties (None when
    authentication is not enabled). Keys mirror the reference's:

      auth_provider            BUILTIN | LDAP   (auth-provider)
      auth_builtin_users       {user: pw|"sha256:<hex>"} or "u:pw,u2:pw2"
      auth_ldap_server         ldap://host:port (auth-ldap-server)
      auth_ldap_user_template  "uid={user},ou=people,..."
      auth_ldap_search_base    subtree base DN  (auth-ldap-search-base)
      auth_ldap_search_filter  default "(uid={user})"
      auth_ldap_bind_dn / auth_ldap_bind_password
    """
    kind = str(conf.get("auth_provider") or "").strip().lower()
    if kind in ("", "none"):
        return None
    if kind == "builtin":
        users = conf.get("auth_builtin_users") or {}
        if isinstance(users, str):
            users = dict(pair.split(":", 1)
                         for pair in users.split(",") if ":" in pair)
        return BuiltinAuthProvider(users)
    if kind == "ldap":
        server = conf.get("auth_ldap_server")
        if not server:
            raise ValueError("auth_provider=LDAP requires auth_ldap_server")
        return LdapAuthProvider(
            server,
            user_dn_template=conf.get("auth_ldap_user_template"),
            search_base=conf.get("auth_ldap_search_base"),
            search_filter=conf.get("auth_ldap_search_filter")
            or "(uid={user})",
            bind_dn=conf.get("auth_ldap_bind_dn"),
            bind_password=conf.get("auth_ldap_bind_password") or "",
            timeout=float(conf.get("auth_ldap_timeout") or 5.0))
    raise ValueError(f"unknown auth_provider {kind!r} "
                     "(supported: BUILTIN, LDAP)")
