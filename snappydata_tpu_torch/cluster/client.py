"""Client: a failover-aware Flight connection with deadlines, login,
circuit breakers and at-most-once mutation retry (port of
snappydata_tpu/cluster/client.py; the snappydata JDBC-driver analogue —
jdbc:snappydata://host:port with locator-based failover,
jdbc/.../Constant.scala:29-33).  It connects to a direct `address` or
discovers the members through a locator, and asks the locator again
when every known member has failed."""

from __future__ import annotations

import json
import random
import time
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight

from snappydata_tpu_torch import config, reliability
from snappydata_tpu_torch.cluster.retry import CircuitBreaker, ExponentialBackoff
from snappydata_tpu_torch.fault import failpoints
from snappydata_tpu_torch.observability import tracing
from snappydata_tpu_torch.resource.context import CancelException


class SnappyClient:
    def __init__(self, address: Optional[str] = None,
                 locator: Optional[str] = None,
                 token: Optional[str] = None,
                 user: Optional[str] = None,
                 password: Optional[str] = None,
                 timeout_s: Optional[float] = None):
        """Connect directly (`address`='host:port') or discover query
        servers through a locator ('host:port' of the locator service).
        `token` authenticates every request when the server has
        auth_tokens configured; `user`+`password` instead log in against
        the server's auth provider (BUILTIN/LDAP) for an ephemeral token —
        re-acquired automatically after a failover, since tokens are
        per-server (ref: JDBC user/password connection properties).
        `timeout_s`: default per-request deadline — enforced client-side
        via Flight call options (a hung-but-connected member cannot
        block the caller forever; expiry raises CancelException XCL52)
        and shipped in the request body so the server stops work
        cooperatively. None falls back to `client_timeout_s`; an
        ambient `reliability.deadline_scope` (the lead's scatter budget)
        overrides both with its shrinking remainder."""
        self._token = token
        self._timeout_s = timeout_s
        self._conn_addr: Optional[str] = None   # address of _conn
        self._pin_addr: Optional[str] = None    # mutation-retry pin
        self._user = user
        self._password = password
        self._catalog_cache: Optional[dict] = None
        self._catalog_fetched_at = 0.0
        self._addresses: List[str] = []
        if address:
            self._addresses.append(address)
        self._conn: Optional[flight.FlightClient] = None
        self._locator = locator
        props = config.global_properties()
        # per-address circuit breakers: a member that failed establishment
        # breaker_failures times in a row is SKIPPED during failover while
        # its breaker is open (no connect-timeout tax per request), probed
        # again half-open after breaker_reset_s — and always retried as a
        # last resort when no other member connects
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._backoff = ExponentialBackoff(
            props.retry_backoff_base_s, props.retry_backoff_max_s,
            jitter=props.retry_jitter,
            rng=random.Random(props.fault_seed))
        if locator and not address:
            self._refresh_from_locator()

    def _refresh_from_locator(self) -> None:
        from snappydata_tpu_torch.cluster.locator import LocatorClient

        lc = LocatorClient(self._locator, member_id="client", role="client")
        try:
            members = lc.members()
        finally:
            lc.close()
        self._addresses = [f"{m.host}:{m.port}" for m in members
                           if m.port and m.role in ("server", "lead")]

    def _login(self, conn: flight.FlightClient) -> None:
        """Exchange user/password for a per-server ephemeral token."""
        if self._user is None or self._password is None:
            return
        body = json.dumps({"user": self._user,
                           "password": self._password}).encode("utf-8")
        results = list(conn.do_action(flight.Action("login", body)))
        self._token = json.loads(
            results[0].body.to_pybytes().decode("utf-8"))["token"]

    def _establish(self, addr: str) -> flight.FlightClient:
        conn = flight.connect(f"grpc://{addr}")
        list(conn.do_action(flight.Action("ping", b"")))
        self._login(conn)
        return conn

    def _breaker(self, addr: str) -> CircuitBreaker:
        br = self._breakers.get(addr)
        if br is None:
            props = config.global_properties()
            br = self._breakers[addr] = CircuitBreaker(
                props.breaker_failures, props.breaker_reset_s)
        return br

    def _try_establish(self, addr: str) -> Optional[flight.FlightClient]:
        """Attempt one address, recording the outcome in its breaker.
        Returns None on (non-auth) failure; re-raises auth errors."""
        br = self._breaker(addr)
        try:
            conn = self._establish(addr)
        except flight.FlightUnauthenticatedError:
            raise   # bad credentials — failover can't fix that
        except Exception as e:  # failover to the next member
            br.record_failure()
            self._last_establish_err = e
            return None
        br.record_success()
        return conn

    def _client(self) -> flight.FlightClient:
        if self._conn is not None:
            return self._conn
        self._last_establish_err: Optional[Exception] = None
        pin = getattr(self, "_pin_addr", None)
        if pin is not None:
            # mutation-retry pin: a stmt_id re-send is at-most-once only
            # on the server that may have applied it (dedup windows are
            # per-server) — never fail over to a different member here
            conn = self._try_establish(pin)
            if conn is None:
                raise ConnectionError(
                    f"pinned member {pin} unreachable for mutation "
                    f"retry: {self._last_establish_err}")
            self._conn, self._conn_addr = conn, pin
            return conn
        skipped: List[str] = []
        for addr in list(self._addresses):
            if not self._breaker(addr).allow():
                skipped.append(addr)   # breaker open: known-dead, skip
                continue
            conn = self._try_establish(addr)
            if conn is not None:
                self._conn, self._conn_addr = conn, addr
                return conn
        if self._locator:
            self._refresh_from_locator()
            for addr in self._addresses:
                if addr in skipped:
                    continue
                conn = self._try_establish(addr)
                if conn is not None:
                    self._conn, self._conn_addr = conn, addr
                    return conn
        # last resort: open breakers never REDUCE availability — when no
        # healthy member connected, try the skipped ones anyway
        for addr in skipped:
            conn = self._try_establish(addr)
            if conn is not None:
                self._conn, self._conn_addr = conn, addr
                return conn
        raise ConnectionError(
            f"no reachable member: {self._last_establish_err}")

    def _invalidate(self) -> None:
        self._conn = None
        # a mutation retry pins to the member that MAY have applied the
        # first send — that is only meaningful for the connection the
        # request actually went out on; a stale address from an earlier
        # request must not pin a retry whose first send reached nobody
        self._conn_addr = None

    def _effective_timeout(self, timeout_s: Optional[float]
                           ) -> Optional[float]:
        """Per-request deadline resolution: explicit argument (0 = NO
        deadline, even under an ambient scope — the repair plane passes
        it so a caller's expiring budget can't cut a replica promotion
        mid-copy) > ambient deadline remainder (the lead's shrinking
        scatter budget) > this client's default > `client_timeout_s`."""
        if timeout_s is not None:
            t = float(timeout_s)
            return t if t > 0 else None
        rem = reliability.remaining()
        if rem is not None:
            # expired budgets surface as an immediate Flight timeout →
            # CancelException, not a hang on a dead deadline
            return max(0.001, rem)
        t = self._timeout_s
        if t is None:
            t = config.global_properties().client_timeout_s
        t = float(t or 0.0)
        return t if t > 0 else None

    @staticmethod
    def _call_opts(eff: Optional[float]):
        return flight.FlightCallOptions(timeout=eff) \
            if eff is not None else None

    def _deadline_expired(self, e) -> CancelException:
        """Typed XCL52 conversion for a Flight timeout: drop the (maybe
        wedged) connection, count it, and hand back the NON-retryable
        error — every guarded() call site must route timeouts through
        this so a retry-path timeout can't leak as a raw Flight error
        (which the lead's fan-out would mistake for member death)."""
        from snappydata_tpu_torch.observability.metrics import global_registry

        self._invalidate()
        global_registry().inc("client_deadline_exceeded")
        return CancelException(f"request exceeded its deadline: {e}")

    def _request(self, once, retry: bool,
                 retry_metric: str = "failover_retries",
                 pin_retry: bool = False):
        """Run `once` (which must connect via _client() before building
        its payload — the token may only exist after login, and a
        failover re-login mints a fresh per-server token). Retries once
        on connection loss when `retry` (idempotent requests, plus
        mutations carrying a dedup stmt_id — the server-side window
        makes their re-send at-most-once), and once on an expired login
        token (re-login via reconnect). A Flight TIMEOUT is different:
        the caller's deadline expired, so retrying would only extend the
        wait — it surfaces as CancelException (SQLSTATE XCL52).
        `pin_retry` (mutations): the re-send must reconnect to the SAME
        member that may have applied the first send — dedup windows are
        per-server, and a locator failover to a different member would
        re-apply there (double-apply across members); if that member is
        unreachable the original error surfaces instead."""
        def guarded():
            # flight.rpc failpoint: `before` simulates a request that
            # never reached the server; `after` simulates a response
            # lost AFTER the server applied (the lost-ack case the
            # stmt_id dedup window exists for).  The reliability
            # registry's flight.send/flight.recv pair covers the same
            # two seams for seeded storm schedules.
            from snappydata_tpu_torch.reliability import failpoints as rfail

            failpoints.hit("flight.rpc")
            rfail.hit("flight.send")
            out = once()
            rfail.hit("flight.recv")
            failpoints.hit("flight.rpc", phase="after")
            return out

        def retried():
            try:
                return guarded()
            except flight.FlightTimedOutError as e2:
                raise self._deadline_expired(e2) from e2

        from snappydata_tpu_torch.observability.metrics import global_registry

        try:
            return guarded()
        except flight.FlightTimedOutError as e:
            raise self._deadline_expired(e) from e
        except flight.FlightUnauthenticatedError:
            if self._user is None or self._token is None:
                raise
            self._invalidate()   # reconnect → fresh login
            return retried()
        except (flight.FlightUnavailableError, ConnectionError):
            # ALWAYS drop the dead connection so the next call fails over;
            # only re-issuing this request is gated on retry-safety
            applied_addr = self._conn_addr
            self._invalidate()
            if not retry:
                raise
            # locklint: metric-dynamic retry_metric is one of the two
            # declared names "failover_retries"/"mutation_retries"
            # (keyword default + explicit call sites in this file)
            global_registry().inc(retry_metric)
            d = self._backoff.delay(0)
            rem = reliability.remaining()
            if rem is not None:
                # never sleep past the caller's deadline — and if it
                # already expired, the retry cannot possibly help
                if rem <= 0:
                    global_registry().inc("client_deadline_exceeded")
                    raise CancelException(
                        "request deadline expired during "
                        "connection-loss retry")
                d = min(d, max(rem - 0.001, 0.0))
            time.sleep(d)
            if pin_retry and applied_addr is not None:
                self._pin_addr = applied_addr
                try:
                    return retried()
                finally:
                    self._pin_addr = None
            return retried()

    def _action(self, name: str, body: dict, retry: bool = True,
                timeout_s: Optional[float] = None,
                retry_metric: str = "failover_retries",
                pin_retry: bool = False) -> dict:
        def once():
            conn = self._client()
            eff = self._effective_timeout(timeout_s)
            payload = self._with_token(dict(body))
            if eff is not None:
                # the server reads this on statement actions and arms
                # the QueryContext deadline — cooperative server-side
                # enforcement next to the hard client-side cutoff
                payload.setdefault("timeout_s", eff)
            tid = tracing.wire_id()
            if tid is not None:
                # trace propagation: the server opens its own trace
                # under the SAME id, so client and server rings join
                payload.setdefault("trace_id", tid)
            raw = json.dumps(payload).encode("utf-8")
            with tracing.span("flight_action", action=name,
                              addr=self._conn_addr):
                results = list(conn.do_action(flight.Action(name, raw),
                                              self._call_opts(eff)))
            return json.loads(results[0].body.to_pybytes().decode("utf-8"))

        return self._request(once, retry, retry_metric=retry_metric,
                             pin_retry=pin_retry)

    def sql(self, sql: str, params: Sequence = (),
            prepared: bool = False,
            timeout_s: Optional[float] = None) -> pa.Table:
        """Query → Arrow table (record-batch paged by Flight).
        `prepared` routes through the server's serving executor —
        repeated statements skip parse/plan on the server and concurrent
        requests of one shape fuse into a single device dispatch.
        `timeout_s` bounds THIS request (see _effective_timeout)."""
        def once():
            conn = self._client()
            eff = self._effective_timeout(timeout_s)
            body = {"sql": sql, "params": list(params)}
            if prepared:
                body["prepared"] = True
            if eff is not None:
                body["timeout_s"] = eff
            tid = tracing.wire_id()
            if tid is not None:
                body["trace_id"] = tid
            ticket = flight.Ticket(json.dumps(
                self._with_token(body)).encode("utf-8"))
            with tracing.span("flight_sql", addr=self._conn_addr):
                return conn.do_get(ticket, self._call_opts(eff)).read_all()

        # the client IS a front door: with no ambient trace (a direct
        # SnappyClient user) this mints the request's trace id; under
        # the lead's scatter it joins the ambient trace instead
        with tracing.request_scope(sql, user=self._user or "",
                                   kind="client"):
            return self._request(once, retry=True)

    # leading keywords whose statements MUTATE state: they are stamped
    # with a statement id so the server's dedup window makes a lost-ack
    # re-send at-most-once (before that window existed, these were
    # raise-to-caller: a blind retry would have double-applied)
    _NON_IDEMPOTENT = ("insert", "put", "update", "delete", "exec")

    def execute(self, sql: str, params: Sequence = (),
                stmt_id: Optional[str] = None,
                timeout_s: Optional[float] = None) -> dict:
        """DDL/DML via action (no result paging needed). Queries and DDL
        retry across failover; mutations are stamped with `stmt_id` (one
        is minted when not given) and retry too — the server remembers
        (stmt_id → result) in a WAL-persisted window, so a retry whose
        first send actually applied returns the recorded result instead
        of double-applying (`mutation_retries`/`mutation_dedup_hits`)."""
        head = sql.lstrip().split(None, 1)[0].lower() if sql.strip() else ""
        mutating = head in self._NON_IDEMPOTENT
        if mutating and stmt_id is None:
            stmt_id = uuid.uuid4().hex
        body = {"sql": sql, "params": list(params)}
        if stmt_id is not None:
            body["stmt_id"] = stmt_id
        with tracing.request_scope(sql, user=self._user or "",
                                   kind="client"):
            return self._action(
                "sql", body, retry=True, timeout_s=timeout_s,
                retry_metric="mutation_retries" if mutating
                else "failover_retries",
                pin_retry=mutating)

    def insert(self, table: str, columns: dict,
               stmt_id: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
        """Bulk columnar ingest via do_put. `columns` is a name → array
        dict or a ready pyarrow Table. Stamped with a statement id like
        execute(): a connection lost after the server applied is retried
        and deduped server-side instead of duplicating rows."""
        arrow = columns if isinstance(columns, pa.Table) else \
            pa.table(columns)
        if stmt_id is None:
            stmt_id = uuid.uuid4().hex

        def once():
            conn = self._client()   # may log in and mint self._token
            eff = self._effective_timeout(timeout_s)
            cmd = {"table": table, "stmt_id": stmt_id}
            tid = tracing.wire_id()
            if tid is not None:
                cmd["trace_id"] = tid
            if self._token is not None:
                cmd["token"] = self._token
            descriptor = flight.FlightDescriptor.for_command(
                json.dumps(cmd).encode("utf-8"))
            with tracing.span("flight_put", table=table,
                              addr=self._conn_addr):
                writer, _ = conn.do_put(descriptor, arrow.schema,
                                        self._call_opts(eff))
                writer.write_table(arrow)
                writer.close()

        with tracing.request_scope(f"<insert {table}>",
                                   user=self._user or "", kind="client"):
            self._request(once, retry=True,
                          retry_metric="mutation_retries",
                          pin_retry=True)

    def repartition(self, body: dict) -> dict:
        """Ask this server to hash-repartition its shard of body['table']
        by body['key'] into body['dest'] across body['servers'] (the
        shuffle-exchange fan-out). Repair/exchange-plane calls pass
        timeout_s=0: a caller's expiring query deadline must not cut a
        data movement mid-copy (the query fails with XCL52 on its own
        calls; the exchange either completes or fails whole)."""
        return self._action("repartition", body, retry=False, timeout_s=0)

    def plan(self, plan_payload, params: Sequence = (),
             timeout_s: Optional[float] = None):
        """Execute a serialized logical plan fragment on this server and
        return the Arrow result (the plan-shipping twin of sql() —
        idempotent read, so failover/re-login retry applies the same)."""
        def once():
            conn = self._client()
            eff = self._effective_timeout(timeout_s)
            body = self._with_token({"plan": plan_payload,
                                     "params": list(params)})
            if eff is not None:
                body["timeout_s"] = eff
            tid = tracing.wire_id()
            if tid is not None:
                body["trace_id"] = tid
            with tracing.span("flight_plan", addr=self._conn_addr):
                return conn.do_get(flight.Ticket(
                    json.dumps(body).encode("utf-8")),
                    self._call_opts(eff)).read_all()

        with tracing.request_scope("<shipped plan>",
                                   user=self._user or "", kind="client"):
            return self._request(once, retry=True)

    def move_buckets(self, body: dict) -> dict:
        """Rebalance: this server copies its primary rows of
        body['buckets'] (table body['table']) to body['target'] and
        deletes them locally."""
        return self._action("move_buckets", body, retry=False, timeout_s=0)

    def export(self, body: dict) -> dict:
        """Ask this server to STREAM its local shard of body['table']
        into body['dest'] on every body['targets'] address, one scan
        unit at a time (the broadcast exchange data plane)."""
        return self._action("export", body, retry=False, timeout_s=0)

    def scan_table(self, name: str):
        """Stream a table's full content as record batches (server-side
        memory bounded by one column batch)."""
        conn = self._client()
        body = self._with_token({"scan_table": name})
        import json as _json

        return conn.do_get(flight.Ticket(
            _json.dumps(body).encode("utf-8"))).to_reader()

    def ping(self, timeout_s: Optional[float] = None) -> None:
        """Liveness probe (raises if the member is unreachable). Always
        deadline-bounded: a probe against a wedged member must answer
        within a bounded interval, not a full connect/read timeout —
        under an ambient request deadline it uses the remainder (capped),
        so 'deadline + one probe interval' bounds the caller's wait."""
        eff = timeout_s
        if eff is None:
            rem = reliability.remaining()
            eff = 5.0 if rem is None else max(0.1, min(rem, 5.0))
        list(self._client().do_action(flight.Action("ping", b""),
                                      self._call_opts(eff)))

    def promote(self, body: dict) -> dict:
        """Failover re-hosting: move this server's replica-shadow rows of
        body['buckets'] into its primary table (body['table'])."""
        return self._action("promote", body, retry=False, timeout_s=0)

    def replicate(self, body: dict) -> dict:
        """Redundancy restoration: this server copies its CURRENT rows of
        body['buckets'] (table body['table']) into body['target']'s
        replica shadow."""
        return self._action("replicate", body, retry=False, timeout_s=0)

    def purge_replica(self, body: dict) -> dict:
        """Drop body['buckets'] rows from this server's replica shadow of
        body['table'] (pre-copy cleanup for idempotent re-replication)."""
        return self._action("purge_replica", body, timeout_s=0)

    def purge_buckets(self, body: dict) -> dict:
        """Drop body['buckets'] rows from this server's PRIMARY copy of
        body['table'] (rejoin resync: a restarted member's stale rows
        of re-homed buckets are removed before re-admission; journaled
        server-side, so recovery never resurrects them)."""
        return self._action("purge_buckets", body, retry=False,
                            timeout_s=0)

    def demote(self, body: dict) -> dict:
        """Inverse of promote(): move this server's PRIMARY rows of
        body['buckets'] into its local replica shadow. The rejoin path
        uses it when a restarted member's recovered copy of a bucket is
        provably current (WAL-seq watermark) — the survivor's promoted
        copy turns back into its redundant shadow with zero network
        copy."""
        return self._action("demote", body, retry=False, timeout_s=0)

    def _with_token(self, body: dict) -> dict:
        if self._token is not None:
            body["token"] = self._token
        return body

    def stats(self) -> dict:
        return self._action("stats", {})

    # -- thin-client catalog (ref: ConnectorExternalCatalog's cached
    # catalog tables keyed on catalog version, invalidated wholesale on
    # any DDL — SmartConnectorExternalCatalog.invalidate) ---------------

    # catalog snapshots are trusted this long before refetching — remote
    # DDL (a bumped server generation) is observed within the TTL, like
    # SmartConnectorExternalCatalog's version check per access
    CATALOG_TTL_S = 5.0

    def catalog(self, refresh: bool = False) -> dict:
        """Full catalog metadata in ONE round trip: {generation, tables:
        {name: {columns, provider, partition_by, buckets, ...}}, views}.
        Served from cache within CATALOG_TTL_S; `refresh=True` or
        `invalidate_catalog()` forces a refetch."""
        import time

        now = time.monotonic()
        if self._catalog_cache is None or refresh or \
                now - self._catalog_fetched_at > self.CATALOG_TTL_S:
            self._catalog_cache = self._action("catalog", {})
            self._catalog_fetched_at = now
        return self._catalog_cache

    def invalidate_catalog(self) -> None:
        self._catalog_cache = None

    def tables(self, refresh: bool = False) -> dict:
        """table name → metadata (schema columns, provider, placement)."""
        return self.catalog(refresh=refresh)["tables"]

    def describe(self, table: str, refresh: bool = False) -> dict:
        """One table's metadata; a miss refetches once before raising —
        the cached snapshot may simply predate the table's DDL."""
        name = table.lower().removeprefix("app.")
        tables = self.tables(refresh=refresh)
        if name not in tables and not refresh:
            tables = self.tables(refresh=True)
        if name not in tables:
            raise KeyError(f"no such table: {table}")
        return tables[name]

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
