"""Arrow Flight front door: SQL + bulk ingest per node (port of
snappydata_tpu/cluster/flight_server.py; the wire format is the
reference's, so either package's clients talk to either server).

The reference's network server is a thrift/DRDA listener on every data
server with failover-aware drivers (cluster/README-thrift.md:20-35), with
an ExecutionEngineArbiter that answers simple/point queries locally and
routes analytics to the lead (docs/architecture/cluster_architecture.md:
31-33). Here: Arrow Flight — columnar result paging for free,
off-the-shelf clients:

- do_get(Ticket{sql, params})   → query as one Arrow table (record-batch
                                  paged by Flight itself)
- do_put(descriptor=table name) → bulk columnar ingest straight into the
                                  column store (no per-row protocol
                                  overhead)
- do_action(sql|login|checkpoint|wal_sync|catalog|stats|export|ping) →
                                  DDL/DML + ops

Handlers run on gRPC threads that pyarrow starts, so each one (and each
result generator) enters the session's `config.device_scope` itself: a
served query runs on the server session's device or raises.  Results
come off the card once per request, inside the executor's `transfer`
span; `result_to_arrow` builds Arrow from those host arrays.  The
bucket-moving actions (`repartition`, `promote`, `replicate`,
`purge_replica`, `purge_buckets`, `demote`, `move_buckets`) serve the
lead's exchanges, failover, rejoin and rebalance
(`cluster/distributed.py`); they run in the scope like every action, and
the rows they insert or delete go through the table's own write path, so
the server's next query binds the new rows.
"""

from __future__ import annotations

import json
import threading
import time
from snappydata_tpu_torch.utils import locks
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight

from snappydata_tpu_torch import config
from snappydata_tpu_torch import types as T

# seconds `SnappyFlightServer.shutdown` waits after gRPC's own shutdown
SHUTDOWN_GRACE_S = 0.05


def _scoped(device, it):
    """Drive iterator `it` inside `device`'s scope: Flight pulls a
    GeneratorStream on its own threads after the handler returned, so
    the scope is entered and left around each step."""
    while True:
        with config.device_scope(device):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def result_to_arrow(result, sel: Optional[np.ndarray] = None) -> pa.Table:
    """Result → Arrow table; `sel` optionally selects a row subset (used by
    the repartition exchange to ship one peer's shard)."""
    arrays = []
    names = []
    for name, col, nmask, dtype in zip(result.names, result.columns,
                                       result.nulls, result.dtypes):
        names.append(name)
        if sel is not None:
            col = np.asarray(col)[sel]
            nmask = np.asarray(nmask)[sel] if nmask is not None else None
        if dtype.name == "decimal":
            # real decimal128(p, s) on the wire — the BI/JDBC contract
            # (ref readDecimal, ColumnEncoding.scala:137-140); values may
            # be Decimal objects (finalized), scaled int64 (engine
            # domain) or plain floats (host fallback)
            import decimal as _d

            pt = pa.decimal128(max(1, dtype.precision), dtype.scale)
            fconv = T.decimal_float_converter(dtype)

            def cell(i, v):
                if (nmask is not None and nmask[i]) or v is None:
                    return None
                if isinstance(v, _d.Decimal):
                    return v
                if isinstance(v, (int, np.integer)) \
                        and getattr(dtype, "is_exact", False):
                    return T.unscaled_to_python(dtype, v)
                return fconv(v)

            cells = [cell(i, v) for i, v in enumerate(col)]
            try:
                arrays.append(pa.array(cells, type=pt))
            except (pa.ArrowInvalid, pa.ArrowTypeError):
                # the engine's int64-overflow fallback returns an
                # APPROXIMATE float total that can be wider than the
                # declared precision (decimal_sum_type caps at p=18) —
                # widen the wire type rather than failing the export
                # the local session happily answers (advisor round 5)
                try:
                    arrays.append(pa.array(
                        cells, type=pa.decimal128(38, dtype.scale)))
                except (pa.ArrowInvalid, pa.ArrowTypeError):
                    arrays.append(pa.array(
                        [None if c is None else float(c) for c in cells],
                        type=pa.float64()))
        elif dtype.name == "string" or col.dtype == object:
            arrays.append(pa.array(
                [None if (nmask is not None and nmask[i]) or v is None
                 else str(v) for i, v in enumerate(col)], type=pa.string()))
        else:
            arrays.append(pa.array(col, mask=np.asarray(nmask)
                          if nmask is not None else None))
    return pa.table(dict(zip(names, arrays)))


def try_stream_scan(sess, sql_text: str, params=(),
                    page_rows: int = 65536):
    """Scan-shaped queries ([LIMIT] [Project] [Filter] Relation over a
    column table — no aggregate/sort/join/window) stream per scan unit
    through the `sql` ticket instead of materializing the whole result
    first: a `SELECT *` over a table far larger than host memory
    completes with peak host rows bounded by one column batch
    (ref: CachedDataFrame.executeTake:766 incremental decode +
    SparkSQLExecuteImpl.packRows:109 paging; round-4 verdict Weak #7).

    Row-level security stays intact — policy predicates inject during
    `analyze_plan` (sql/analyzer.py relation resolution), which runs
    here exactly as in the materialized path. Returns (pa.schema,
    generator-of-record-batches) or None when the shape doesn't
    qualify (the caller falls back to the materialized path)."""
    from snappydata_tpu_torch.engine import hosteval
    from snappydata_tpu_torch.engine.result import Result
    from snappydata_tpu_torch.sql import ast as _ast
    from snappydata_tpu_torch.sql.analyzer import _expr_name, expr_type
    from snappydata_tpu_torch.sql.parser import parse as _parse
    from snappydata_tpu_torch.storage.table_store import RowTableData

    try:
        stmt = _parse(sql_text)
    except Exception:
        return None
    if not isinstance(stmt, _ast.Query):
        return None
    if getattr(stmt, "with_error", None) is not None:
        # AQP WITH ERROR routes through the error-estimation path —
        # streaming plain rows would silently drop the clause
        return None

    def plain(e) -> bool:
        if isinstance(e, (_ast.WindowFunc, _ast.ScalarSubquery,
                          _ast.InSubquery, _ast.ExistsSubquery)):
            return False
        if isinstance(e, _ast.Func) and e.name in _ast.AGG_FUNCS:
            return False
        return all(plain(c) for c in e.children())

    def peel(plan):
        """([limit], [proj], [filt], relation-ish) or None — shared by
        the RAW pre-analysis gate (so non-scan queries skip the second
        analyze; review finding) and the resolved-plan match."""
        node = plan
        lim = None
        if isinstance(node, _ast.Limit):
            lim = int(node.n)
            node = node.child
        pr = None
        if isinstance(node, _ast.Project):
            pr = node
            node = node.child
        fl = None
        if isinstance(node, _ast.Filter):
            fl = node
            node = node.child
        while isinstance(node, _ast.SubqueryAlias):
            node = node.child
        if not isinstance(node, (_ast.Relation,
                                 _ast.UnresolvedRelation)):
            return None
        for e in (list(pr.exprs) if pr is not None else []) \
                + ([fl.condition] if fl is not None else []):
            if not plain(e):
                return None
        return lim, pr, fl, node

    if peel(stmt.plan) is None:   # cheap raw-shape gate: no analyze
        return None
    try:
        resolved, _scope = sess.analyzer.analyze_plan(stmt.plan)
        # user '?' placeholders: positions are normally assigned inside
        # _run_query_inner — this path bypasses it, and an unassigned
        # Param(pos=-1) would read params[-1] (review finding; the
        # round-4 UPDATE/DELETE bug class)
        from snappydata_tpu_torch.sql.analyzer import assign_param_positions

        resolved = assign_param_positions(resolved, 0)
    except Exception:
        return None
    shaped = peel(resolved)
    if shaped is None:
        return None
    limit, proj, filt, node = shaped
    if not isinstance(node, _ast.Relation):
        return None
    info = sess.catalog.lookup_table(node.name)
    if info is None or isinstance(info.data, RowTableData):
        return None  # row tables are small: materialized path is fine

    exprs = list(proj.exprs) if proj is not None else None

    sess._require(node.name, "select")
    if exprs is not None:
        out_names = [_expr_name(e) for e in exprs]
        out_types = [expr_type(e) for e in exprs]
    else:
        fields = [f for f in info.schema.fields]
        out_names = [f.name for f in fields]
        out_types = [f.dtype for f in fields]
    schema = pa.schema([pa.field(n, _arrow_type(t))
                        for n, t in zip(out_names, out_types)])

    def gen():
        from snappydata_tpu_torch.observability.metrics import global_registry

        reg = global_registry()
        have = 0
        for chunk in iter_table_chunks(sess, node.name):
            cols = list(chunk.columns)
            nulls = list(chunk.nulls)
            n = chunk.num_rows
            if filt is not None:
                v, nl = hosteval.eval_expr(filt.condition, cols, nulls,
                                           params, n)
                keep = np.broadcast_to(v, (n,)).astype(bool)
                if nl is not None:
                    keep = keep & ~np.broadcast_to(nl, (n,))
                idx = np.flatnonzero(keep)
                if idx.size == 0:
                    continue
                cols = [c[idx] for c in cols]
                nulls = [nm[idx] if nm is not None else None
                         for nm in nulls]
                n = idx.size
            if exprs is not None:
                out_c, out_n = [], []
                for e in exprs:
                    v, nl = hosteval.eval_expr(e, cols, nulls, params, n)
                    out_c.append(np.broadcast_to(v, (n,)))
                    out_n.append(np.broadcast_to(nl, (n,))
                                 if nl is not None else None)
            else:
                out_c, out_n = cols, nulls
            if limit is not None and have + n > limit:
                take = limit - have
                out_c = [c[:take] for c in out_c]
                out_n = [nm[:take] if nm is not None else None
                         for nm in out_n]
                n = take
            res = Result(out_names, out_c, out_n, out_types)
            tbl = result_to_arrow(res)
            if tbl.schema != schema:
                tbl = tbl.cast(schema)
            reg.inc("stream_scan_chunks")
            reg.inc("stream_scan_rows", n)
            yield from tbl.to_batches(max_chunksize=max(1, page_rows))
            have += n
            if limit is not None and have >= limit:
                reg.inc("stream_scan_early_stops")
                return  # LIMIT early-exit: remaining units never decode

    return schema, gen


def iter_table_chunks(sess, table: str):
    """Stream a table's content as per-scan-unit Results — one column
    batch (or row-buffer chunk) decoded at a time, so exporting a table
    never materializes more than `column_batch_rows` rows on the host
    (ref: batch-at-a-time ColumnFormatIterator; the round-2/3 exchanges
    built the whole table first — this is the streamed replacement).
    Yields `snappydata_tpu_torch.engine.result.Result` objects."""
    from snappydata_tpu_torch.engine.result import Result
    from snappydata_tpu_torch.storage.table_store import RowTableData

    info = sess.catalog.describe(table)
    schema = info.schema
    names = [f.name for f in schema.fields]
    dtypes = [f.dtype for f in schema.fields]
    if isinstance(info.data, RowTableData):
        # row tables are bounded by design (PK'd operational rows)
        res = sess.sql(f"SELECT * FROM {table}")
        if res.num_rows:
            yield res
        return
    data = info.data
    from snappydata_tpu_torch.storage import mvcc

    # one manifest for the whole stream (per-unit consistency) — the
    # ambient pinned epoch when a snapshot-pinned statement streams
    manifest = mvcc.snapshot_of(data)
    for view in manifest.views:
        live = view.live_mask()
        n = int(live.sum())
        if n == 0:
            continue
        cols, nulls = [], []
        for ci, f in enumerate(schema.fields):
            if f.dtype.name == "string":
                codes = view.decoded_column(ci)[live]
                lut = data.dictionary(ci)
                vals = lut[codes] if lut is not None and len(lut) \
                    else np.array([None] * n, dtype=object)
            else:
                vals = view.decoded_column(ci)[live]
            nm = view.null_mask(ci)
            nulls.append(nm[live] if nm is not None else None)
            cols.append(vals)
        yield Result(list(names), cols, nulls, list(dtypes))
    # row-buffer snapshot rows
    if manifest.row_count:
        cols, nulls = [], []
        for ci, f in enumerate(schema.fields):
            src = manifest.row_arrays[ci][:manifest.row_count]
            nm = manifest.row_nulls[ci][:manifest.row_count] \
                if manifest.row_nulls and manifest.row_nulls[ci] is not None \
                else None
            cols.append(np.asarray(src))
            nulls.append(nm)
        yield Result(list(names), cols, nulls, list(dtypes))


def arrow_to_arrays(table: pa.Table):
    """Arrow table → (arrays, null_masks) in storage domain."""
    arrays = []
    nulls = []
    for col in table.columns:
        combined = col.combine_chunks()
        if pa.types.is_decimal(combined.type):
            # storage host domain for decimals is plain float64 (the
            # scaled-int64 form is device-bind-time only); f64 holds
            # partial aggregates exactly through 15 significant digits
            vals = combined.to_pylist()
            arrays.append(np.array(
                [0.0 if v is None else float(v) for v in vals],
                dtype=np.float64))
            nulls.append(np.array([v is None for v in vals])
                         if combined.null_count else None)
        elif pa.types.is_string(combined.type) or \
                pa.types.is_large_string(combined.type):
            # an object array of str with None at the nulls, as
            # to_pylist() gives, built in Arrow rather than per cell
            arrays.append(np.asarray(combined.to_numpy(zero_copy_only=False),
                                     dtype=object))
            nulls.append(combined.is_null().to_numpy(zero_copy_only=False)
                         if combined.null_count else None)
        else:
            np_arr = combined.to_numpy(zero_copy_only=False)
            if combined.null_count:
                mask = combined.is_null().to_numpy(zero_copy_only=False)
                np_arr = np.where(mask, 0, np_arr)
                nulls.append(mask)
            else:
                nulls.append(None)
            arrays.append(np_arr)
    return arrays, nulls


class _HeaderAuthMiddleware(flight.ServerMiddleware):
    def __init__(self, header: Optional[str]):
        self.header = header


class _HeaderAuthMiddlewareFactory(flight.ServerMiddlewareFactory):
    """Captures the `authorization` header so FlightSQL requests (which
    authenticate per the spec via Basic/Bearer headers, not a body
    token) can resolve their principal."""

    def start_call(self, info, headers):
        vals = headers.get("authorization") or \
            headers.get(b"authorization") or []
        v = vals[0] if vals else None
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        return _HeaderAuthMiddleware(v)


class SnappyFlightServer(flight.FlightServerBase):
    # login-issued tokens expire after this long; the client re-logs-in
    # transparently (SnappyClient retries once on Unauthenticated)
    TOKEN_TTL_S = 8 * 3600.0

    def __init__(self, session, host: str = "127.0.0.1", port: int = 0,
                 auth_tokens: Optional[dict] = None, auth_provider=None,
                 internal_token: Optional[str] = None):
        """`auth_tokens`: pre-shared token → user map. `auth_provider`: a
        `security.AuthProvider` (BUILTIN/LDAP) validating user+password —
        clients `login` once for an ephemeral token (ref: SecurityUtils
        credential check per connection). When either is configured, EVERY
        request must carry a valid credential and runs as that principal
        (so GRANT/REVOKE applies); when neither is, requests run as an
        UNAUTHENTICATED remote session — EXEC PYTHON is refused either way
        unless the principal is an authenticated admin (advisor finding:
        the network surface used to run as the admin superuser).
        `internal_token`: cluster-shared secret (conf `auth_cluster_token`)
        for server↔server traffic — login tokens are per-server, so peer
        calls (repartition/replicate do_put) authenticate with this
        instead of forwarding a caller's token."""
        location = f"grpc://{host}:{port}"
        super().__init__(
            location,
            middleware={"snappy-auth": _HeaderAuthMiddlewareFactory()})
        self.session = session
        from snappydata_tpu_torch.cluster.flightsql import FlightSqlHandler

        self.flightsql = FlightSqlHandler(self)
        self.auth_tokens = auth_tokens or {}
        self.auth_provider = auth_provider
        self.internal_token = internal_token
        self._issued_tokens: dict = {}   # token -> (user, expiry)
        self._token_lock = locks.named_lock("flight.tokens")
        self.host = host
        self._location = location

    @property
    def actual_port(self) -> int:
        return self.port

    def _origin(self) -> str:
        """This member's REAL bound address for trace origins — the
        init-time `_location` may say port 0 (bind-assigned)."""
        try:
            return f"grpc://{self.host}:{self.port}"
        except Exception:
            return self._location

    def shutdown(self) -> None:
        """Stop serving, then wait SHUTDOWN_GRACE_S.  The gRPC that
        pyarrow bundles still tears the old listening socket down for a
        moment after its shutdown returns; a Flight server created in
        this process within that moment can be handed the same
        descriptor number and lose its listener to that teardown (every
        connection then refused)."""
        super().shutdown()
        time.sleep(SHUTDOWN_GRACE_S)

    def wait_ready(self, timeout: float = 10.0) -> None:
        """Block until the gRPC loop actually accepts connections. The port
        is bound at __init__, so a nonzero port does NOT mean serve() is
        running yet — probing with a real connection is the only reliable
        readiness signal."""
        client = flight.connect(f"grpc://{self.host}:{self.port}")
        try:
            client.wait_for_available(timeout=int(max(1, timeout)))
        finally:
            client.close()

    def _auth_enabled(self) -> bool:
        return bool(self.auth_tokens) or self.auth_provider is not None

    def _session_for(self, body: Optional[dict]):
        """Per-request principal session (ref: SnappySessionPerConnection,
        SparkSQLExecuteImpl.scala:99)."""
        if not self._auth_enabled():
            return self.session.for_user(self.session.user,
                                         authenticated=False)
        body = body or {}
        token = body.get("token")
        if token is not None and not isinstance(token, str):
            raise flight.FlightUnauthenticatedError("malformed token")
        user = None
        if token:
            import hmac as _hmac

            if self.internal_token is not None and _hmac.compare_digest(
                    token.encode("utf-8"),
                    self.internal_token.encode("utf-8")):
                # peer server: runs as this node's own (admin) principal
                user = self.session.user
            else:
                user = self.auth_tokens.get(token)
            if user is None:
                import time as _t

                with self._token_lock:
                    entry = self._issued_tokens.get(token)
                    if entry is not None:
                        if entry[1] > _t.time():
                            user = entry[0]
                        else:
                            self._issued_tokens.pop(token, None)
        if user is None and self.auth_provider is not None:
            # inline credentials (clients normally `login` once instead —
            # this path hits the provider, e.g. an LDAP bind, per request)
            u, p = body.get("user"), body.get("password")
            if u and p and self.auth_provider.authenticate(u, p):
                user = u
        if user is None:
            raise flight.FlightUnauthenticatedError(
                "missing or invalid token/credentials")
        return self.session.for_user(user, authenticated=True)

    def _session_from_context(self, context):
        """FlightSQL principal resolution: the `authorization` header
        (Basic user:password or Bearer <token>) captured by middleware
        feeds the same credential paths as the JSON body protocol."""
        body: dict = {}
        try:
            mw = context.get_middleware("snappy-auth")
        except Exception:
            mw = None
        header = getattr(mw, "header", None)
        if header:
            if header.lower().startswith("basic "):
                import base64

                try:
                    raw = base64.b64decode(header[6:]).decode("utf-8")
                    u, _, p = raw.partition(":")
                    body = {"user": u, "password": p}
                except Exception:
                    pass
            elif header.lower().startswith("bearer "):
                body = {"token": header[7:]}
        return self._session_for(body)

    # -- queries ----------------------------------------------------------

    @staticmethod
    def _deadline_ctx(body: Optional[dict], sess, sql_text: str):
        """Deadline propagation (reliability layer): a request body
        carrying `timeout_s` — the CALLER's remaining budget — becomes a
        QueryContext deadline, so the engine's cooperative checks stop
        server-side work within one tile of the caller giving up instead
        of computing a result nobody will read. Returns None when the
        request carries no budget."""
        budget = (body or {}).get("timeout_s")
        try:
            budget = float(budget) if budget is not None else 0.0
        except (TypeError, ValueError):
            budget = 0.0
        if budget <= 0:
            return None
        from snappydata_tpu_torch import resource

        ctx = resource.new_query(sql_text, user=sess.user)
        ctx.set_deadline_in(budget)
        return ctx

    def do_get(self, context, ticket: flight.Ticket):
        with config.device_scope(self.session.device):
            return self._do_get(context, ticket)

    def _do_get(self, context, ticket: flight.Ticket):
        from snappydata_tpu_torch.cluster.flightsql import unpack_any
        from snappydata_tpu_torch.fault import failpoints

        # server-side failpoint: an injected raise here reaches clients
        # as a Flight error from a member that is otherwise ALIVE — the
        # probe-then-raise (no-failover) path in DistributedSession
        failpoints.hit("flight.serve")
        fsql = unpack_any(ticket.ticket)
        if fsql is not None:
            return self.flightsql.do_get(context, fsql[0], fsql[1])
        req = json.loads(ticket.ticket.decode("utf-8"))
        if "plan" in req:
            # plan-fragment shipping: execute a serialized UNRESOLVED
            # logical plan through the normal session pipeline — shapes
            # the single-block SQL renderer can't express run distributed
            # this way (ref: SparkSQLExecuteImpl.scala:75-109)
            from snappydata_tpu_torch import resource
            from snappydata_tpu_torch.sql import ast as _ast
            from snappydata_tpu_torch.sql.plan_json import from_json

            sess = self._session_for(req)
            plan = from_json(req["plan"])
            ctx = self._deadline_ctx(req, sess, "<shipped plan>")
            from snappydata_tpu_torch.observability import tracing

            # trace propagation: a traced caller's trace_id rides the
            # ticket like its deadline — this fragment's spans record
            # under the SAME id, joinable across the member rings
            with tracing.request_scope("<shipped plan>", user=sess.user,
                                       kind="server",
                                       trace_id=req.get("trace_id"),
                                       origin=self._origin()):
                if ctx is not None:
                    # propagated deadline: the caller's remaining budget
                    # — cooperative checks stop this fragment when the
                    # caller has already given up (its client-side
                    # cutoff fired)
                    ctx.start()
                    with resource.query_scope(ctx):
                        result = sess.execute_statement(
                            _ast.Query(plan),
                            tuple(req.get("params", ())))
                else:
                    result = sess.execute_statement(
                        _ast.Query(plan), tuple(req.get("params", ())))
            table = result_to_arrow(result)
            chunk = int(req.get("page_rows", 65536))
            batches = table.to_batches(max_chunksize=max(1, chunk))
            return flight.GeneratorStream(table.schema, iter(batches))
        if "scan_table" in req:
            # full-table export ticket: stream scan units without ever
            # materializing the table (peak memory = one column batch)
            sess = self._session_for(req)
            name = req["scan_table"]
            sess._require(name, "select")
            info = self.session.catalog.describe(name)
            fields = [pa.field(f.name, _arrow_type(f.dtype), f.nullable)
                      for f in info.schema.fields]
            schema = pa.schema(fields)

            def gen():
                for result in iter_table_chunks(sess, name):
                    tbl = result_to_arrow(result)
                    if tbl.schema != schema:
                        tbl = tbl.cast(schema)
                    yield from tbl.to_batches(max_chunksize=65536)

            return flight.GeneratorStream(
                schema, _scoped(self.session.device, gen()))
        sess = self._session_for(req)
        # scan-shaped queries (project/filter, no aggregate/sort)
        # stream per scan unit — peak host rows bounded by one column
        # batch even for a SELECT * over an oversized table.  This wins
        # over the `prepared` flag too: a full-table export must NEVER
        # materialize server-side just because the client asked for
        # serving-path routing (the serving registry targets small/point
        # results, not bulk scans)
        streamed = try_stream_scan(sess, req["sql"],
                                   tuple(req.get("params", ())),
                                   page_rows=int(req.get("page_rows",
                                                         65536)))
        if streamed is not None:
            schema, gen = streamed
            return flight.GeneratorStream(
                schema, _scoped(self.session.device, gen()))
        ctx = self._deadline_ctx(req, sess, req.get("sql", ""))
        from snappydata_tpu_torch.observability import tracing

        # the server opens its own trace under the caller's trace_id
        # (or mints one for an untraced caller) BEFORE entering the
        # session, so session.sql's scope joins it instead of minting
        with tracing.request_scope(req.get("sql", ""), user=sess.user,
                                   kind="server",
                                   trace_id=req.get("trace_id"),
                                   origin=self._origin()):
            if req.get("prepared"):
                # serving front door: {"sql", "params", "prepared":
                # true} routes through the prepared-plan registry —
                # repeated tickets skip parse/plan, concurrent ones fuse
                # into one batched dispatch, the governor admits per
                # principal
                result = sess.serving_sql(req["sql"],
                                          tuple(req.get("params", ())),
                                          query_ctx=ctx)
            else:
                result = sess.sql(req["sql"],
                                  params=tuple(req.get("params", ())),
                                  query_ctx=ctx)
        table = result_to_arrow(result)
        # page as record batches (ref: CachedDataFrame paged collect /
        # GfxdHeapDataOutputStream result pages) — clients start consuming
        # before the last page is serialized
        chunk = int(req.get("page_rows", 65536))
        batches = table.to_batches(max_chunksize=max(1, chunk))
        return flight.GeneratorStream(table.schema, iter(batches))

    def get_flight_info(self, context, descriptor):
        with config.device_scope(self.session.device):
            return self._get_flight_info(context, descriptor)

    def _get_flight_info(self, context, descriptor):
        from snappydata_tpu_torch.cluster.flightsql import unpack_any

        fsql = unpack_any(descriptor.command) \
            if descriptor.command else None
        if fsql is not None:
            return self.flightsql.flight_info(context, descriptor,
                                              fsql[0], fsql[1])
        req = json.loads(descriptor.command.decode("utf-8"))
        # schema WITHOUT executing (ref: prepared-statement metadata phase,
        # SparkSQLPrepareImpl) — clients can plan on dtypes cheaply
        sess = self._session_for(req)
        schema = sess.query_schema(req["sql"])
        fields = [pa.field(f.name, _arrow_type(f.dtype), f.nullable)
                  for f in schema.fields]
        endpoint = flight.FlightEndpoint(
            descriptor.command, [flight.Location(self._location)])
        return flight.FlightInfo(pa.schema(fields), descriptor, [endpoint],
                                 -1, -1)

    # -- bulk ingest ------------------------------------------------------

    def do_put(self, context, descriptor, reader, writer):
        with config.device_scope(self.session.device):
            self._do_put(context, descriptor, reader, writer)

    def _do_put(self, context, descriptor, reader, writer):
        if descriptor.path:
            target, body = descriptor.path[0].decode("utf-8"), None
        else:
            from snappydata_tpu_torch.cluster.flightsql import unpack_any

            fsql = unpack_any(descriptor.command)
            if fsql is not None:
                self.flightsql.do_put(context, fsql[0], fsql[1],
                                      reader, writer)
                return
            body = json.loads(descriptor.command.decode("utf-8"))
            target = body["table"]
        sess = self._session_for(body)   # raises if auth on and no token
        sess._require(target, "insert")
        from snappydata_tpu_torch import reliability
        from snappydata_tpu_torch.observability.metrics import global_registry

        stmt_id = (body or {}).get("stmt_id")
        dedup = reliability.dedup_for(self.session.catalog) \
            if stmt_id else None
        if dedup is not None and dedup.begin(stmt_id) is not None:
            # lost-ack retry: the first send applied (and fsynced — acks
            # gate on the covering WAL sync) but its response was lost.
            # Drain the stream and ack WITHOUT re-applying.
            reader.read_all()
            global_registry().inc("mutation_dedup_hits")
            return
        try:
            table = reader.read_all()
            arrays, nulls = arrow_to_arrays(table)
            info = self.session.catalog.describe(target)
            # same gate as every session write lane: acked rows put into
            # a view's backing table would vanish at the view's next sync
            self.session._reject_matview_write(info)
            from snappydata_tpu_torch.storage.table_store import RowTableData

            # WAL-then-apply under the store's mutation lock (same
            # invariant as session mutations: journal first so a
            # concurrent checkpoint can't fold un-journaled rows, and
            # carry null masks so recovery doesn't turn bulk-ingested
            # NULLs into zeros). stmt_scope threads the client's
            # statement id into the WAL header — recovery replay re-seeds
            # the dedup window from it, so a retry racing a server
            # RESTART still dedups.
            # sync_force: the put RESPONSE is a durability ack the lead's
            # fan-out (and its replica bookkeeping) relies on — the
            # covering WAL fsync is forced even when this server runs
            # wal_fsync_mode=interval. Relaxed acks are a local-session
            # policy, never a network one. Scoped to THIS put's record so
            # one client's ack never waits on other sessions' records.
            from snappydata_tpu_torch.observability import tracing

            with tracing.request_scope(
                    f"<put {target}>", user=sess.user, kind="server",
                    trace_id=(body or {}).get("trace_id"),
                    origin=self._origin()), \
                    reliability.stmt_scope(stmt_id):
                if isinstance(info.data, RowTableData):
                    from snappydata_tpu_torch.session import _restore_none_arrays

                    raw = _restore_none_arrays(arrays, nulls)
                    n = self.session._journal_then(
                        info, "insert", raw, None,
                        lambda: self.session._fold_views(
                            info, raw, None, info.data.insert_arrays(raw)),
                        sync_force=True)
                else:
                    nmask = nulls if any(m is not None for m in nulls) \
                        else None
                    n = self.session._journal_then(
                        info, "insert", arrays, nmask,
                        lambda: self.session._fold_views(
                            info, arrays, nmask,
                            info.data.insert_arrays(arrays, nulls=nmask)),
                        sync_force=True)
        except BaseException:
            if dedup is not None:
                dedup.abort(stmt_id)   # nothing applied: a retry may run
            raise
        if dedup is not None:
            dedup.commit(stmt_id, {"rows": [[int(n or 0)]]})

    # -- ops --------------------------------------------------------------

    def do_action(self, context, action: flight.Action):
        # actions answer a few small results: run the whole action inside
        # the scope and hand Flight the finished list
        with config.device_scope(self.session.device):
            return iter(list(self._do_action(context, action)))

    def _do_action(self, context, action: flight.Action):
        name = action.type
        if name != "ping":
            # ping stays exempt: liveness probes must answer truthfully
            # or an injected app-level fault would masquerade as member
            # death and trigger a spurious failover
            from snappydata_tpu_torch.fault import failpoints

            failpoints.hit("flight.serve")
        if name in ("CreatePreparedStatement", "ClosePreparedStatement"):
            from snappydata_tpu_torch.cluster.flightsql import unpack_any

            fsql = unpack_any(action.body.to_pybytes()) \
                if action.body else None
            if fsql is not None:
                for out in self.flightsql.do_action(context, fsql[0],
                                                    fsql[1]):
                    yield flight.Result(out)
                return
        body = json.loads(action.body.to_pybytes().decode("utf-8")) \
            if action.body else {}
        if name == "sql":
            from snappydata_tpu_torch import reliability
            from snappydata_tpu_torch.observability.metrics import \
                global_registry

            sess = self._session_for(body)
            stmt_id = body.get("stmt_id")
            dedup = reliability.dedup_for(self.session.catalog) \
                if stmt_id else None
            if dedup is not None:
                prior = dedup.begin(stmt_id)
                if prior is not None:
                    # lost-ack retry of an applied mutation: return the
                    # recorded result, apply nothing
                    global_registry().inc("mutation_dedup_hits")
                    yield flight.Result(json.dumps(
                        dict(prior, deduped=True)).encode("utf-8"))
                    return
            try:
                ctx = self._deadline_ctx(body, sess, body["sql"])
                from snappydata_tpu_torch.observability import tracing

                with tracing.request_scope(
                        body["sql"], user=sess.user, kind="server",
                        trace_id=body.get("trace_id"),
                        origin=self._origin()), \
                        reliability.stmt_scope(stmt_id):
                    result = sess.sql(
                        body["sql"], params=tuple(body.get("params", ())),
                        query_ctx=ctx)
                payload = {"names": result.names,
                           "rows": [[_json_val(v) for v in r]
                                    for r in result.rows()[:1000]]}
            except BaseException:
                if dedup is not None:
                    dedup.abort(stmt_id)
                raise
            if dedup is not None:
                dedup.commit(stmt_id, payload)
            yield flight.Result(json.dumps(payload).encode("utf-8"))
        elif name == "login":
            # credential → ephemeral session token (ref: per-connection
            # authentication in SecurityUtils; the token plays the role of
            # the authenticated connection)
            if self.auth_provider is None:
                raise flight.FlightUnauthenticatedError(
                    "no auth provider configured (login unavailable)")
            u, p = body.get("user"), body.get("password")
            if not u or not p or not self.auth_provider.authenticate(u, p):
                raise flight.FlightUnauthenticatedError(
                    "invalid credentials")
            import secrets
            import time as _t

            now = _t.time()
            tok = secrets.token_hex(16)
            with self._token_lock:
                # prune expired tokens so the table can't grow unbounded
                for stale in [t for t, (_, exp)
                              in self._issued_tokens.items() if exp <= now]:
                    self._issued_tokens.pop(stale, None)
                self._issued_tokens[tok] = (u, now + self.TOKEN_TTL_S)
            yield flight.Result(json.dumps(
                {"token": tok, "user": u}).encode("utf-8"))
        elif name == "checkpoint":
            sess = self._session_for(body)
            if self._auth_enabled() and sess.user != "admin":
                raise flight.FlightServerError("checkpoint requires admin")
            self.session.checkpoint()
            yield flight.Result(b"{}")
        elif name == "wal_sync":
            # cluster-wide durability barrier (DistributedSession
            # .flush_wals / REST POST /wal/flush): drain+fsync this
            # member's commit buffer past any relaxed interval-mode ack
            self._session_for(body)   # credential gate when auth on
            ds = self.session.disk_store
            if ds is not None:
                ds.wal_sync(force=True)
            yield flight.Result(json.dumps(
                {"durable": ds is not None}).encode("utf-8"))
        elif name == "catalog":
            # thin-client catalog protocol (ref: StoreHiveCatalog serving
            # getCatalogMetadata to connectors; SmartConnectorExternalCatalog
            # caches per catalog version and invalidates all entries on any
            # DDL): one round trip returns the FULL table/view inventory
            # plus the catalog generation the client caches against.
            self._session_for(body)   # catalog metadata: credential gate
            yield flight.Result(json.dumps(
                self._catalog_payload()).encode("utf-8"))
        elif name == "stats":
            self._session_for(body)  # catalog metadata: token when auth on
            from snappydata_tpu_torch.observability import TableStatsService

            stats = TableStatsService(self.session.catalog).collect_once()
            yield flight.Result(json.dumps(stats).encode("utf-8"))
        elif name == "repartition":
            # Peer-to-peer hash-repartition (shuffle) exchange: THIS server
            # re-buckets its local shard of `table` by `key` and streams
            # each peer's sub-shard straight to that peer's `dest` table
            # over do_put — no lead-side materialization (ref: Spark
            # exchange fallback, SnappyStrategies.scala:80-128, re-shaped
            # as server-to-server Arrow Flight streams).
            sess = self._session_for(body)
            sess._require(body["table"], "select")
            n = self._repartition_shard(
                sess, body["table"], body["key"], body["dest"],
                body["servers"], int(body["num_buckets"]),
                self.internal_token or body.get("token"),
                body.get("bucket_owners"))
            yield flight.Result(json.dumps({"rows": n}).encode("utf-8"))
        elif name == "promote":
            # failover re-hosting: replica-shadow rows of the given
            # buckets become primary rows on THIS server (ref: bucket
            # redundancy re-hosting on member departure)
            sess = self._session_for(body)
            moved = self._promote_replica(
                sess, body["table"], body["key"],
                frozenset(body["buckets"]), int(body["num_buckets"]))
            yield flight.Result(json.dumps({"rows": moved}).encode("utf-8"))
        elif name == "replicate":
            # redundancy restoration: push THIS server's rows of the
            # given buckets into a peer's replica shadow (ref: bucket
            # redundancy recovery after re-hosting)
            sess = self._session_for(body)
            sess._require(body["table"], "select")
            n = self._replicate_buckets(
                sess, body["table"], body["key"],
                frozenset(body["buckets"]), int(body["num_buckets"]),
                body["target"], self.internal_token or body.get("token"))
            yield flight.Result(json.dumps({"rows": n}).encode("utf-8"))
        elif name == "purge_replica":
            # drop the given buckets' rows from the local shadow (makes
            # re-replication idempotent after a failed/rolled-back copy)
            sess = self._session_for(body)
            n = self._purge_replica(
                sess, body["table"], body["key"],
                frozenset(body["buckets"]), int(body["num_buckets"]))
            yield flight.Result(json.dumps({"rows": n}).encode("utf-8"))
        elif name == "purge_buckets":
            # rejoin resync: journaled delete of the given buckets' rows
            # from the local PRIMARY copy (a restarted member's stale
            # rows of re-homed buckets must go before re-admission —
            # they would double-count under scatter otherwise)
            sess = self._session_for(body)
            n = self._purge_primary(
                sess, body["table"], body["key"],
                frozenset(body["buckets"]), int(body["num_buckets"]))
            yield flight.Result(json.dumps({"rows": n}).encode("utf-8"))
        elif name == "demote":
            # rejoin zero-copy redundancy restore: the inverse of
            # promote — this server's PRIMARY rows of the given buckets
            # move into its local replica shadow, because the restarted
            # member's recovered copy (provably current by WAL-seq
            # watermark) is taking the primary role back
            sess = self._session_for(body)
            n = self._demote_to_replica(
                sess, body["table"], body["key"],
                frozenset(body["buckets"]), int(body["num_buckets"]))
            yield flight.Result(json.dumps({"rows": n}).encode("utf-8"))
        elif name == "move_buckets":
            # rebalance data plane: copy this server's PRIMARY rows of
            # the given buckets to `target` and delete them locally (ref:
            # SYS.REBALANCE_ALL_BUCKETS, docs/reference/
            # inbuilt_system_procedures/rebalance-all-buckets.md)
            sess = self._session_for(body)
            sess._require(body["table"], "select")
            n = self._move_buckets(
                sess, body["table"], body["key"],
                frozenset(body["buckets"]), int(body["num_buckets"]),
                body["target"], self.internal_token or body.get("token"))
            yield flight.Result(json.dumps({"rows": n}).encode("utf-8"))
        elif name == "export":
            # streamed table export for broadcast exchanges: THIS server
            # pushes its local shard of `table` into `dest` on every
            # target, one scan unit at a time — the lead coordinates but
            # never holds data (replaces the round-3 gather-to-lead
            # broadcast; ref CachedDataFrame.scala:766 paged results)
            sess = self._session_for(body)
            sess._require(body["table"], "select")
            from snappydata_tpu_torch.cluster.client import SnappyClient

            tok = self.internal_token or body.get("token")
            clients = [SnappyClient(address=a, token=tok)
                       for a in body["targets"]]
            n = 0
            try:
                for result in iter_table_chunks(sess, body["table"]):
                    piece = result_to_arrow(result)
                    for c in clients:
                        c.insert(body["dest"], piece)
                    n += result.num_rows
            finally:
                for c in clients:
                    c.close()
            yield flight.Result(json.dumps({"rows": n}).encode("utf-8"))
        elif name == "ping":
            yield flight.Result(b'{"ok": true}')
        else:
            raise flight.FlightServerError(f"unknown action {name}")

    def _catalog_payload(self) -> dict:
        """Serialize the catalog: table schemas + placement metadata +
        the generation DDL bumps (the connector's invalidation key)."""
        catalog = self.session.catalog
        tables = {}
        for info in catalog.list_tables():
            snap_rows = None
            try:
                snap_rows = int(info.data.snapshot().total_rows())
            except Exception:
                pass
            tables[info.name] = {
                "provider": info.provider,
                "columns": [{"name": f.name, "type": str(f.dtype),
                             "nullable": bool(f.nullable)}
                            for f in info.schema.fields],
                "key_columns": list(info.key_columns),
                "partition_by": list(info.partition_by),
                "buckets": info.buckets,
                "colocate_with": info.colocate_with,
                "redundancy": info.redundancy,
                "base_table": info.base_table,
                "row_count": snap_rows,
            }
        return {"generation": catalog.generation,
                "tables": tables,
                "views": sorted(catalog._views.keys())}

    def _repartition_shard(self, sess, table: str, key: str, dest: str,
                           servers, num_buckets: int,
                           token: Optional[str],
                           bucket_owners=None) -> int:
        """Stream the local shard one scan unit at a time, bucket each
        chunk by murmur3(key) (the SAME placement the lead's insert
        routing uses — an explicit bucket→server map when given, so
        re-bucketed rows land exactly where a direct insert would even
        after failovers), and push each peer its sub-shard per chunk —
        peak host memory is ONE column batch, not the whole shard (ref:
        SparkSQLExecuteImpl.packRows:109 paged streaming; round-3 verdict
        Weak #5)."""
        from snappydata_tpu_torch.cluster.client import SnappyClient
        from snappydata_tpu_torch.parallel.hashing import bucket_of_np

        clients: dict = {}
        sent = 0
        try:
            for result in iter_table_chunks(sess, table):
                ki = [c.lower() for c in result.names].index(key.lower())
                buckets = bucket_of_np(np.asarray(result.columns[ki]),
                                       num_buckets)
                if bucket_owners is not None:
                    owner = np.asarray(bucket_owners,
                                       dtype=np.int64)[buckets]
                else:
                    owner = buckets % len(servers)
                for si, addr in enumerate(servers):
                    mask = owner == si
                    if not mask.any():
                        continue
                    piece = result_to_arrow(result, sel=mask)
                    if si not in clients:
                        clients[si] = SnappyClient(address=addr,
                                                   token=token)
                    clients[si].insert(dest, piece)
                    sent += int(mask.sum())
        finally:
            for c in clients.values():
                c.close()
        return sent

    @staticmethod
    def _bucket_rows(sess, table: str, key: str, buckets: frozenset,
                     num_buckets: int):
        """Scan `table` and select the rows belonging to `buckets`.
        Returns (result, bool row mask) — mask is None when empty."""
        from snappydata_tpu_torch.parallel.hashing import bucket_of_np

        result = sess.sql(f"SELECT * FROM {table}")
        n = int(result.columns[0].shape[0]) if result.columns else 0
        if n == 0:
            return result, None
        ki = [c.lower() for c in result.names].index(key.lower())
        rb = bucket_of_np(np.asarray(result.columns[ki]), num_buckets)
        mask = np.isin(rb, np.fromiter(buckets, dtype=np.int64))
        return result, (mask if mask.any() else None)

    def _promote_replica(self, sess, table: str, key: str,
                         buckets: frozenset, num_buckets: int) -> int:
        """Move rows of `buckets` from <table>__replica into <table> and
        drop them from the shadow (their old primary died)."""
        replica = f"{table}__replica"
        result, mask = self._bucket_rows(sess, replica, key, buckets,
                                         num_buckets)
        if mask is None:
            return 0
        moved = int(mask.sum())
        from snappydata_tpu_torch.storage.table_store import RowTableData

        info = self.session.catalog.describe(table)
        self.session._reject_matview_write(info)  # views have no replicas
        arrays = [np.asarray(c)[mask] for c in result.columns]
        nulls = [np.asarray(nm)[mask] if nm is not None else None
                 for nm in result.nulls]
        nmask = nulls if any(m is not None for m in nulls) else None
        # sync_force: the promotion is a network-level ack to the lead's
        # failover bookkeeping AND the shadow rows are deleted right
        # below — the covering fsync must land BEFORE the only other
        # copy goes away, even under wal_fsync_mode=interval
        if isinstance(info.data, RowTableData):
            from snappydata_tpu_torch.session import _restore_none_arrays

            raw = _restore_none_arrays(arrays, nulls)
            self.session._journal_then(
                info, "insert", raw, None,
                lambda: self.session._fold_views(
                    info, raw, None, info.data.insert_arrays(raw)),
                sync_force=True)
        else:
            self.session._journal_then(
                info, "insert", arrays, nmask,
                lambda: self.session._fold_views(
                    info, arrays, nmask,
                    info.data.insert_arrays(arrays, nulls=nmask)),
                sync_force=True)
        # remove promoted rows from the shadow so a LATER promotion of
        # other buckets can't double-promote these
        from snappydata_tpu_torch.parallel.hashing import bucket_of_np

        rinfo = self.session.catalog.describe(replica)

        def pred(cols, _k=key.lower(), _bk=buckets, _nb=num_buckets):
            vals = np.asarray(cols[_k])
            return np.isin(bucket_of_np(vals, _nb),
                           np.fromiter(_bk, dtype=np.int64))

        rinfo.data.delete(pred)
        return moved

    def _replicate_buckets(self, sess, table: str, key: str,
                           buckets: frozenset, num_buckets: int,
                           target: str, token: Optional[str]) -> int:
        """Copy this server's current rows of `buckets` into `target`'s
        <table>__replica shadow. The target PURGES those buckets from its
        shadow first, so a retried/rolled-back restoration never leaves
        duplicate shadow rows."""
        from snappydata_tpu_torch.cluster.client import SnappyClient

        result, mask = self._bucket_rows(sess, table, key, buckets,
                                         num_buckets)
        if mask is None:
            return 0
        piece = result_to_arrow(result, sel=mask)
        client = SnappyClient(address=target, token=token)
        try:
            client.purge_replica({"table": table, "key": key,
                                  "buckets": sorted(buckets),
                                  "num_buckets": num_buckets})
            client.insert(f"{table}__replica", piece)
        finally:
            client.close()
        return int(mask.sum())


    def _move_buckets(self, sess, table: str, key: str,
                      buckets: frozenset, num_buckets: int,
                      target: str, token: Optional[str]) -> int:
        """Copy the local PRIMARY rows of `buckets` to `target`'s primary
        and delete them here (journaled). Copy-then-delete: a crash
        between the two leaves the bucket duplicated, which a re-run of
        the rebalance repairs (the reference's rebalance is likewise
        restartable) — delete-then-copy would instead LOSE rows."""
        from snappydata_tpu_torch.cluster.client import SnappyClient

        result, mask = self._bucket_rows(sess, table, key, buckets,
                                         num_buckets)
        if mask is None:
            return 0
        piece = result_to_arrow(result, sel=mask)
        client = SnappyClient(address=target, token=token)
        try:
            client.insert(table, piece)
        finally:
            client.close()
        # journaled local delete: rows with the moved partition-key
        # values ARE exactly the moved buckets' rows (equal values share
        # a bucket), and delete_keys WALs the operation for recovery
        ki = [c.lower() for c in result.names].index(key.lower())
        moved_vals = np.asarray(result.columns[ki])[mask]
        self.session.delete_keys(table, [key.lower()],
                                 [np.unique(moved_vals)])
        return int(mask.sum())

    def _purge_primary(self, sess, table: str, key: str,
                       buckets: frozenset, num_buckets: int) -> int:
        """Journaled delete of `buckets` rows from the local primary copy
        (delete_keys WALs the operation — recovery must never resurrect
        rows the rejoin resync removed)."""
        result, mask = self._bucket_rows(sess, table, key, buckets,
                                         num_buckets)
        if mask is None:
            return 0
        ki = [c.lower() for c in result.names].index(key.lower())
        vals = np.asarray(result.columns[ki])[mask]
        self.session.delete_keys(table, [key.lower()], [np.unique(vals)])
        return int(mask.sum())

    def _demote_to_replica(self, sess, table: str, key: str,
                           buckets: frozenset, num_buckets: int) -> int:
        """Move local PRIMARY rows of `buckets` into the local replica
        shadow: purge the shadow's slice of those buckets first (a
        crashed earlier demote may have left its copy — re-running must
        not duplicate it), then copy-into-shadow (journaled,
        fsync-forced — the shadow row must be durable before the
        primary copy goes away), then a journaled delete of the primary
        rows. A crash mid-sequence leaves the bucket in BOTH places
        (the shadow is invisible to queries and the next run's purge
        repairs it) — never in neither."""
        result, mask = self._bucket_rows(sess, table, key, buckets,
                                         num_buckets)
        if mask is None:
            return 0
        self._purge_replica(sess, table, key, buckets, num_buckets)
        replica = f"{table}__replica"
        rinfo = self.session.catalog.describe(replica)
        arrays = [np.asarray(c)[mask] for c in result.columns]
        nulls = [np.asarray(nm)[mask] if nm is not None else None
                 for nm in result.nulls]
        nmask = nulls if any(m is not None for m in nulls) else None
        self.session._journal_then(
            rinfo, "insert", arrays, nmask,
            lambda: rinfo.data.insert_arrays(arrays, nulls=nmask),
            sync_force=True)
        ki = [c.lower() for c in result.names].index(key.lower())
        vals = np.asarray(result.columns[ki])[mask]
        self.session.delete_keys(table, [key.lower()], [np.unique(vals)])
        return int(mask.sum())

    def _purge_replica(self, sess, table: str, key: str,
                       buckets: frozenset, num_buckets: int) -> int:
        from snappydata_tpu_torch.parallel.hashing import bucket_of_np

        rinfo = self.session.catalog.lookup_table(f"{table}__replica")
        if rinfo is None:
            return 0

        def pred(cols, _k=key.lower(), _bk=buckets, _nb=num_buckets):
            vals = np.asarray(cols[_k])
            return np.isin(bucket_of_np(vals, _nb),
                           np.fromiter(_bk, dtype=np.int64))

        return rinfo.data.delete(pred)

    def list_actions(self, context):
        return [("sql", "execute a statement"),
                ("checkpoint", "persist all tables"),
                ("stats", "table stats"), ("ping", "liveness")]


def _json_val(v):
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    return str(v)


def _arrow_type(dt) -> pa.DataType:
    if dt.name == "string":
        return pa.string()
    if dt.name == "decimal":
        # the BI/JDBC contract: real decimal128 on the wire, matching
        # result_to_arrow's arrays (a float64 mapping here made
        # schema-casts silently downcast streamed decimal columns)
        return pa.decimal128(max(1, dt.precision), dt.scale)
    if dt.name in ("array", "map", "struct"):
        return pa.string()  # complex values ride JSON-encoded
    try:
        return pa.from_numpy_dtype(np.dtype(dt.np_dtype))
    except (pa.ArrowNotImplementedError, TypeError):
        return pa.string()
